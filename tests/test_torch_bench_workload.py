"""``bench_workload_torch.py``, the port's twin of ``bench_workload.py``, on
the CPU: its ``--allow-cpu`` smoke against ``BENCH_WORKLOAD_r09.json`` (the
committed output of the reference's ``--allow-cpu`` smoke), its density
arithmetic and FLOP count against the JAX package's, the state its timed
serving calls reuse, and its refusal to run without a card."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import bench_workload
import bench_workload_torch as BW
from tpushare.workload import model as JM
from tpushare.workload import paging as JP
from tpushare.workload import serving as JS
from tpushare_torch.workload import model as M
from tpushare_torch.workload import paging as P
from tpushare_torch.workload import serving as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "bench_workload_torch.py")
REFERENCE = os.path.join(REPO, "BENCH_WORKLOAD_r09.json")
SECTIONS = ("attention_fwd_bwd", "train_step", "train_step_large",
            "serving_decode", "serving_continuous", "paged_decode")


def _run(*args, timeout=300):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, SCRIPT, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout,
                          env=env)


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """(the smoke run's process, its document, the path it was saved at)."""
    proc = _run("--allow-cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    path = tmp_path_factory.mktemp("bench") / "smoke.json"
    path.write_text(proc.stdout)
    return proc, doc, path


@pytest.fixture(scope="module")
def reference():
    with open(REFERENCE, encoding="utf-8") as f:
        return json.loads(f.read().strip().splitlines()[-1])


def test_smoke_has_the_reference_keys(smoke, reference):
    _, doc, _ = smoke
    assert set(doc) == set(reference) | {"power_limit"}
    assert set(doc["gates"]) == set(reference["gates"])
    assert len(doc["gates"]) == 7
    assert doc["device"] == "cpu" and doc["power_limit"] is None


@pytest.mark.parametrize("section", SECTIONS)
def test_smoke_section_has_the_reference_keys(smoke, reference, section):
    """Each section's keys, and the keys one level down (an attention
    shape's entry, a train side, the density), are the reference's."""
    _, doc, _ = smoke
    got, want = doc[section], reference[section]
    assert set(got) == set(want)
    for key, val in want.items():
        if isinstance(val, dict) and key not in ("admissions", "prefix"):
            assert set(got[key]) == set(val), (section, key)


def test_smoke_admissions_count_admits_only(smoke, reference):
    """A bucket's entry has the reference's keys: admissions, the
    compiled steps' misses and hits (graph captures and replays on the
    card, the same keys on the host), and its first and steady wall
    times; the counts are the reference's."""
    _, doc, _ = smoke
    got = doc["serving_continuous"]["admissions"]
    want = reference["serving_continuous"]["admissions"]
    assert set(got) == set(want)
    for bucket, entry in got.items():
        assert set(entry) == set(want[bucket])
        for key in ("admits", "jitMisses", "jitHits"):
            assert entry[key] == want[bucket][key], (bucket, key)
    assert set(doc["paged_decode"]["prefix"]) == set(
        reference["paged_decode"]["prefix"])


def test_smoke_gates_are_the_references(smoke, reference):
    """Gates shaped {value, limit, pass, gated} with the reference's
    limits; on the host only the paged density is gated."""
    _, doc, _ = smoke
    for name, gate in doc["gates"].items():
        want = reference["gates"][name]
        assert set(gate) == {"value", "limit", "pass", "gated"}
        assert gate["limit"] == want["limit"]
        assert gate["gated"] == (name == "paged_density")
    assert doc["gates"]["paged_density"]["pass"]


def test_bench_diff_reads_both_documents(smoke, reference):
    _, doc, path = smoke
    proc = subprocess.run([sys.executable, "tools/bench_diff.py", REFERENCE,
                           str(path)], cwd=REPO, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert doc["gates"]["paged_density"]["value"] == 3.29
    assert reference["gates"]["paged_density"]["value"] == 3.29


def test_smoke_paged_streams_are_bit_identical(smoke):
    _, doc, _ = smoke
    assert doc["paged_decode"]["bit_identical"] is True


def test_smoke_numbers_are_finite(smoke):
    """Every section has its numbers; the host has no MFU."""
    _, doc, _ = smoke
    assert doc["attention_fwd_bwd"]["512"]["flash_ms"] > 0
    assert doc["attention_fwd_bwd"]["512"]["xla_ms"] > 0
    for section in ("train_step", "train_step_large"):
        for side, r in doc[section].items():
            if side != "config":
                assert r["step_ms"] > 0 and np.isfinite(r["loss"])
                assert r["mfu"] is None
    assert doc["serving_decode"]["request_ms"] > 0
    assert doc["serving_continuous"]["chunk_ms"] > 0
    assert doc["paged_decode"]["paged_chunk_ms"] > 0


def test_density_is_the_jax_packages():
    """The twin's page arithmetic against the JAX package's
    ``max_batch_for_grant`` / ``pages_for_grant`` and the reference
    bench's loop, on the flagship under an 8 GiB grant."""
    cfg = dataclasses.replace(JM.ModelConfig(), remat=False)
    rows = JS.max_batch_for_grant(cfg, 8.0, 2048)
    pages = JS.pages_for_grant(cfg, 8.0)
    admitted = used = 0
    trace = [32, 64, 128, 128, 256, 512, 768, 1024]
    while True:
        need = JP.pages_for(min(trace[admitted % len(trace)] + 256, 2048),
                            JP.PAGE_TOKENS)
        if used + need > pages:
            break
        used, admitted = used + need, admitted + 1
    got = BW.paged_density()
    assert (rows, pages, admitted) == (406, 12992, 1334)
    assert (got["whole_row_streams"], got["pages_total"],
            got["paged_streams"]) == (rows, pages, admitted)
    assert got["streams_per_row_stream"] == round(admitted / rows, 2) == 3.29
    assert got["trace"] == trace and got["page_tokens"] == P.PAGE_TOKENS


@pytest.mark.parametrize("width,batch,params,flops", [
    ("flagship", 16, 30_020_096, 6.727e12),
    ("large", 8, 476_612_608, 5.015e13),
])
def test_train_flops_match_the_reference(width, batch, params, flops):
    """The twin's MFU numerator equals the reference's formula on the JAX
    package's parameter count (shapes by ``jax.eval_shape``)."""
    jcfg = dataclasses.replace(JM.ModelConfig(), remat=False)
    tcfg = dataclasses.replace(M.ModelConfig(), remat=False)
    if width == "large":
        jcfg, tcfg = jcfg.large(), tcfg.large()
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    want = bench_workload._train_flops_per_step(jcfg, batch, 2048, shapes)
    meta = M.Transformer(tcfg, "meta")
    assert M.param_count(meta) == JM.param_count(shapes) == params
    got = BW._train_flops_per_step(tcfg, batch, 2048, meta)
    assert got == want
    assert got == pytest.approx(flops, rel=1e-3)


def test_exits_2_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(timeout=120)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "needs a CUDA device" in proc.stderr


def test_time_scalar_fn_takes_the_least_rep():
    """``warmup`` untimed calls, then ``reps`` runs of ``iters`` calls;
    the result is the least run's seconds a call."""
    calls = []

    def fn(x):
        calls.append(x)
        return torch.tensor(1.0)

    t = BW._time_scalar_fn(fn, 3, iters=4, warmup=2, reps=3)
    assert calls == [3] * (2 + 4 * 3)
    assert 0 <= t < 1


@pytest.fixture(scope="module")
def tiny_servers():
    """A tiny contiguous server and its paged twin, two prompts admitted,
    pages mapped for a 4-step chunk (the twin's smoke shapes)."""
    cfg = M.ModelConfig().tiny()
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=torch.Generator().manual_seed(n))
               for n in (4, 12)]
    state = S.init_server_state(cfg, 2, 32, device="cpu")
    for i, p in enumerate(prompts):
        S.admit_chunked(params, state, p, i, chunk=8)
    pool = P.PagePool(12, page_tokens=8)
    pstate = S.init_paged_state(cfg, 4, 32, 12, 8, device="cpu")
    for i in range(4):
        S.admit_paged(params, pstate, pool, prompts[i % 2], i)
    S.ensure_chunk_pages(pstate, pool, 4)
    return params, state, pstate


def _clone(state):
    return {k: ([{kv: t.clone() for kv, t in layer.items()} for layer in v]
                if isinstance(v, list) else v.clone())
            for k, v in state.items()}


@pytest.mark.parametrize("server", ["rows", "paged"])
def test_timed_chunks_start_from_one_state(tiny_servers, server):
    """A chunk on a shallow copy of the state, as the twin times it, again
    and again: each emits what the first chunk from a deep copy emits, and
    the state's positions stay where they were."""
    params, state, pstate = tiny_servers
    st, serve = ((state, S.serve_chunk) if server == "rows"
                 else (pstate, BW._serve_chunk_paged))
    pos = st["pos"].clone()
    _, want = serve(params, _clone(st), 4)
    for _ in range(3):
        assert float(BW._chunk_scalar(serve, params, st, 4)) == float(
            want[-1].sum())
        _, em = serve(params, dict(st), 4)
        assert torch.equal(em, want)
    assert torch.equal(st["pos"], pos)
