"""Phase 9b's rank body (``chip_smoke.compiled_gang_rank``) on the CPU,
at the dry run's tiny width in fp32: the one-card cases in a gang of one
and the gloo case in a gang of two, over gloo, through the same code the
card runs (the bodies run eagerly on the CPU, so every compiled call is
its eager twin). Holds what the card's phase holds: compiled against
eager bit for bit, a restore whose next step repeats the step after the
save, AdamW not capturable where nothing is captured, one miss a key,
every rank's stats alike."""

import chip_smoke as CS

CASES = (CS.ONE_CARD_CASES, 1), (CS.GLOO_CASES, 2)


def test_phase_9b_rank_body_runs_on_a_host_gang(tmp_path):
    for cases, world in CASES:
        records = CS.compiled_gang(cases, world, "gloo", width="tiny",
                                   device="cpu",
                                   save=str(tmp_path / f"saved{world}.pt"),
                                   env={"OMP_NUM_THREADS": "1"})
        assert [r["rank"] for r in records] == list(range(world))
        for case in cases:
            recs = [r["cases"][case["name"]] for r in records]
            for rec in recs:
                assert rec["bit_identical"] and not rec["captured_here"]
                assert rec["backend"] == "gloo"
                assert all(st["misses"] >= 1 and st["replays"] == 0
                           for st in rec["stats"].values())
            if case["kind"] == "train":
                assert not any(r["capturable"] for r in recs)
                assert len(recs[0]["losses"]) == case["steps"]
            if case.get("restore"):
                assert recs[0]["restore"]["loss_repeated"]
                assert recs[0]["restore"]["misses_after"] == 1
            if case["kind"] == "generate":
                assert recs[0]["shape"] == [2, 12]
        assert (tmp_path / f"saved{world}.pt").exists()
