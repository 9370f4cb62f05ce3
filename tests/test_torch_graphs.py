"""The port's compiled steps (``tpushare_torch.workload.graphs``) on the
CPU: the fixed-shape flushes against the masked flush they replace, bit
for bit; the device-scalar admission against the JAX package's; the
bucketed admissions' jit accounting against the JAX package's; the key
registry, ``disabled()``, the clone-out and the launch-count bookkeeping
through a stand-in for capture; and the train step with a capturable
AdamW against the JAX step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.optim import adam

from tpushare.workload import model as JM
from tpushare.workload import serving as JS
from tpushare.workload import train as JT
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import paging
from tpushare_torch.workload import serving as S
from tpushare_torch.workload import train as T


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(JM.ModelConfig().tiny(), dtype=jnp.float32,
                               remat=False)
    tcfg = dataclasses.replace(M.ModelConfig().tiny(), dtype=torch.float32,
                               remat=False)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, params


def _prompt(seed, n, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.asarray(x)).long()


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# --------------------------------------------------------------------------
# The fixed-shape flushes against the masked flush
# --------------------------------------------------------------------------

def _masked_flush_rows(cache, ring, start_pos, emitted):
    """The contiguous server's flush as it was: boolean-mask indexing."""
    slots, n_steps = start_pos.shape[0], emitted.shape[0]
    valid = (emitted >= 0).T
    rows = start_pos[:, None] + torch.arange(n_steps)[None, :]
    b_idx = torch.arange(slots)[:, None].expand(slots, n_steps)
    bi, ri = b_idx[valid], rows[valid]
    for slots_, rg in zip(cache, ring):
        slots_["k"][bi, ri] = rg["k"][valid]
        slots_["v"][bi, ri] = rg["v"][valid]


def _masked_flush_pages(state, ring, start_pos, emitted):
    """The paged server's flush as it was."""
    P, page = state["pages"][0]["k"].shape[:2]
    H, D = state["pages"][0]["k"].shape[2:]
    MP = state["table"].shape[1]
    phys = state["table"].clamp(0, P - 1)
    valid = (emitted >= 0).T
    rows = start_pos[:, None] + torch.arange(emitted.shape[0])
    logical = (rows // page).clamp(0, MP - 1)
    flat = (phys.gather(1, logical) * page + rows % page)[valid]
    for pg, rg in zip(state["pages"], ring):
        pg["k"].view(P * page, H, D)[flat] = rg["k"][valid]
        pg["v"].view(P * page, H, D)[flat] = rg["v"][valid]


def _junk(state_tensors, seed):
    """Fill every cache row with seeded noise, so a stray write shows."""
    g = torch.Generator().manual_seed(seed)
    with torch.inference_mode():
        for t in state_tensors:
            t.copy_(torch.randn(t.shape, generator=g))


def _served_state(tcfg, params, max_len):
    """4 slots: two decoding, one near max_len (it self-retires inside a
    6-step chunk), one released (inactive); every cache row noise past
    what admission wrote."""
    st = S.init_server_state(tcfg, 4, max_len, device="cpu")
    _junk(S._cache_tensors(st["cache"]), 5)
    for slot, n in ((0, 5), (1, 9), (2, max_len - 3), (3, 4)):
        S.admit(params, st, _t(_prompt(40 + slot, n)), slot)
    S.release(st, 3)
    return st


def _clone_rows(st):
    return {"cache": [{kv: t.clone() for kv, t in layer.items()}
                      for layer in st["cache"]],
            **{k: st[k].clone() for k in ("pos", "active", "token")}}


def test_contiguous_flush_is_the_masked_flush_bit_for_bit(setup):
    _, tcfg, _, params = setup
    st = _served_state(tcfg, params, 24)
    ref = _clone_rows(st)
    start = ref["pos"].clone()
    with graphs.disabled():
        _, em = S.serve_chunk(params, st, 6)
        with torch.inference_mode():
            pos, active, token, want, ring = S._decode_chunk(
                params, ref["cache"], ref, 6, None, None)
            _masked_flush_rows(ref["cache"], ring, start, want)
    assert torch.equal(em, want)
    # The released slot emits nothing; the long one retires mid-chunk.
    assert (em[:, 3] == -1).all()
    assert (em[:3, 2] >= 0).all() and (em[3:, 2] == -1).all()
    assert not bool(st["active"][2]) and bool(st["active"][0])
    for a, b in zip(S._cache_tensors(st["cache"]),
                    S._cache_tensors(ref["cache"])):
        assert _bits_equal(a, b)
    assert torch.equal(st["pos"], pos) and torch.equal(st["token"], token)


def _paged_state(tcfg, params, max_len, page):
    """Paged twin of :func:`_served_state`: slot 3 released, so its
    unmapped table row clamps onto page 0, which slot 0 holds."""
    total = 24
    pool = paging.PagePool(total, page_tokens=page)
    st = S.init_paged_state(tcfg, 4, max_len, total, page, device="cpu")
    _junk(S._cache_tensors(st["pages"]), 6)
    for slot, n in ((0, 5), (1, 9), (2, max_len - 3), (3, 4)):
        S.admit_paged(params, st, pool, _t(_prompt(40 + slot, n)), slot)
    S.release_paged(st, pool, 3)
    S.ensure_chunk_pages(st, pool, 6)
    assert int(st["table"][0, 0]) == 0 and (st["table"][3] == -1).all()
    return st


def test_paged_flush_is_the_masked_flush_bit_for_bit(setup):
    _, tcfg, _, params = setup
    st = _paged_state(tcfg, params, 24, 4)
    ref = {"pages": [{kv: t.clone() for kv, t in layer.items()}
                     for layer in st["pages"]],
           **{k: st[k].clone() for k in ("table", "pos", "active", "token")}}
    start = ref["pos"].clone()
    with graphs.disabled():
        _, em = S._serve_chunk_paged(params, st, 6, None, None)
    P, page, _, max_len = S._paged_dims(ref)
    with torch.inference_mode():
        phys = ref["table"].clamp(0, P - 1)
        cache = [{kv: pg[kv][phys].view(4, max_len, *pg[kv].shape[2:])
                  for kv in ("k", "v")} for pg in ref["pages"]]
        _, _, _, want, ring = S._decode_chunk(params, cache, ref, 6, None,
                                              None)
        _masked_flush_pages(ref, ring, start, want)
    assert torch.equal(em, want)
    assert (em[:, 3] == -1).all() and (em[3:, 2] == -1).all()
    for a, b in zip(S._cache_tensors(st["pages"]),
                    S._cache_tensors(ref["pages"])):
        assert _bits_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_flush_ring_writes_valid_entries_and_nothing_else(seed):
    """``_flush_ring`` on random ring data against a masked write: every
    slot's valid steps a prefix (a slot is active, then retires), rows
    past the destination clamped onto it, invalid entries sent anywhere
    in range, one case with no valid entry at all."""
    rng = np.random.default_rng(seed)
    B, C, N, H, D = 5, 7, 40, 2, 3
    first_invalid = rng.integers(0, C + 1, B)
    if seed == 0:
        first_invalid[:] = 0
    valid = torch.from_numpy(np.arange(C)[None, :] < first_invalid[:, None])
    flat = torch.from_numpy(rng.choice(N, size=(B, C), replace=False))
    # Invalid entries may collide with anything, valid ones included.
    junk = torch.from_numpy(rng.integers(0, N, (B, C)))
    flat = torch.where(valid, flat, junk)
    dst = torch.from_numpy(rng.standard_normal((N, H, D)).astype(np.float32))
    ring = torch.from_numpy(rng.standard_normal((B, C, H, D))
                            .astype(np.float32))
    want = dst.clone()
    want[flat[valid]] = ring[valid]
    S._flush_ring([dst], [ring], flat, valid)
    assert _bits_equal(dst, want)


# --------------------------------------------------------------------------
# Device-scalar admission against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slot,lp,true_len", [(0, 8, None), (2, 8, 5),
                                              (1, 16, 11), (3, 16, 1)])
def test_admit_matches_jax(setup, slot, lp, true_len):
    jcfg, tcfg, jparams, params = setup
    prompt = _prompt(60 + slot, lp)
    jst = JS.admit(jparams, JS.init_server_state(jcfg, 4, 32),
                   jnp.asarray(prompt), jnp.int32(slot),
                   true_len=None if true_len is None else jnp.int32(true_len))
    st = S.admit(params, S.init_server_state(tcfg, 4, 32, device="cpu"),
                 _t(prompt), slot, true_len=true_len)
    for key in ("pos", "active", "token"):
        assert np.array_equal(st[key].numpy(), np.asarray(jst[key])), key
    for layer, jlayer in zip(st["cache"], jst["cache"]):
        for kv in ("k", "v"):
            # fp32 K/V of O(1): ulps of another summation order.
            np.testing.assert_allclose(layer[kv].numpy(),
                                       np.asarray(jlayer[kv]), atol=1e-5)


def test_admission_stats_match_jax(setup):
    """The same sequence of buckets through both packages' admit_bucketed:
    the same buckets, admits, misses and hits. The tiny config at this
    cache length and these buckets is compiled by no other test."""
    jcfg, tcfg, jparams, params = setup
    buckets, max_len = (8, 24), 40
    lengths = (3, 7, 20, 8, 13, 5)
    JS.reset_admission_stats()
    S.reset_admission_stats()
    jst = JS.init_server_state(jcfg, len(lengths), max_len)
    st = S.init_server_state(tcfg, len(lengths), max_len, device="cpu")
    for slot, n in enumerate(lengths):
        p = _prompt(80 + slot, n)
        jst = JS.admit_bucketed(jparams, jst, jnp.asarray(p),
                                jnp.int32(slot), buckets=buckets)
        S.admit_bucketed(params, st, _t(p), slot, buckets=buckets)
    want, got = JS.admission_stats(), S.admission_stats()
    JS.reset_admission_stats()
    S.reset_admission_stats()
    assert got == want
    assert got == {8: {"admits": 4, "jitMisses": 1, "jitHits": 3},
                   24: {"admits": 2, "jitMisses": 1, "jitHits": 1}}


# --------------------------------------------------------------------------
# The registry and the bookkeeping, through a stand-in for capture
# --------------------------------------------------------------------------

class StandIn:
    """Stands in for CUDA graph capture on the CPU. A capture runs the
    body on the static buffers, so its host work happens (the counters
    grow), then puts every bound tensor and the generator's state back,
    so it changes nothing; a replay runs the body again on the static
    buffers, drawing from the generator the capture drew from, writes its
    results into the capture's outputs, as a graph writes its static
    outputs, and leaves the counters as a replay would (it runs no
    wrapper). The gradients a replay of the train step writes are those
    of the body run after its ``prepare``."""

    def __init__(self):
        self.captures = self.replays = 0

    @staticmethod
    def warm_up(body, inputs, dev):
        return body(*inputs)

    def capture(self, body, static_in, bound, group, dev, prepare,
                generator):
        saved = [t.clone() for t in bound]
        drawn = None if generator is None else generator.get_state()
        out = graphs._eager(body, static_in, prepare)
        with torch.inference_mode():
            for t, s in zip(bound, saved):
                t.copy_(s)
        if generator is not None:
            generator.set_state(drawn)
        self.captures += 1
        return (body, static_in, graphs._as_tuple(out), prepare), out

    def replay(self, graph):
        # A graph's replay writes the tensors its capture allocated, as
        # the body run after ``prepare`` does (the train step's gradients
        # are written, not accumulated).
        body, static_in, static_out, prepare = graph
        counts = graphs._counts()
        new = graphs._as_tuple(graphs._eager(body, static_in, prepare))
        graphs._set_counts(counts)
        with torch.inference_mode():
            for o, n in zip(static_out, new):
                o.copy_(n)
        self.replays += 1


@pytest.fixture
def stand_in(monkeypatch):
    fake = StandIn()
    monkeypatch.setattr(graphs, "STAND_IN", fake)
    monkeypatch.setattr(FA, "FLASH_FWD_LAUNCHES", 0)
    yield fake
    graphs.clear()


def _counted_step(w):
    """A step that launches 'two kernels' and updates its bound weight, as
    a train step would."""
    def body(x):
        FA.FLASH_FWD_LAUNCHES += 2
        w.add_(1.0)
        return x * w.sum(), x.sum()
    return body


def test_one_execution_per_call_and_counts(stand_in):
    w = torch.zeros(3)
    outs = [graphs.run("t", _counted_step(w), (torch.full((3,), float(i)),),
                       bound=lambda: (w,))
            for i in range(1, 5)]
    # Four calls: one eager (then a capture that changed nothing), three
    # replays; the weight moved once a call.
    assert torch.equal(w, torch.full((3,), 4.0))
    assert (stand_in.captures, stand_in.replays) == (1, 3)
    assert [o[0].tolist() for o in outs] == [[3 * i * i] * 3
                                             for i in range(1, 5)]
    assert FA.FLASH_FWD_LAUNCHES == 8
    assert graphs.stats()["t"] == {
        "keys": 1, "misses": 1, "replays": 3,
        "launches": {"FLASH_FWD_LAUNCHES": 6, "FLASH_BWD_DQ_LAUNCHES": 0,
                     "FLASH_BWD_DKV_LAUNCHES": 0}}
    assert [c["growth"] for c in graphs.CAPTURES] == [(2, 0, 0)]


def test_outputs_are_cloned_out(stand_in):
    w = torch.ones(2)
    body = _counted_step(w)
    graphs.run("t", body, (torch.ones(2),), bound=lambda: (w,))
    kept, _ = graphs.run("t", body, (torch.ones(2),), bound=lambda: (w,))
    graphs.run("t", body, (torch.full((2,), 7.0),), bound=lambda: (w,))
    # A replay wrote the static outputs again; the kept result is a copy.
    assert kept.tolist() == [6.0, 6.0]


def test_keys_and_disabled(stand_in):
    w = torch.zeros(2)
    body = _counted_step(w)
    graphs.run("t", body, (torch.ones(2),), bound=lambda: (w,))
    graphs.run("t", body, (torch.ones(3),), bound=lambda: (w,))
    graphs.run("t", body, (torch.ones(2, dtype=torch.float64),),
               bound=lambda: (w,))
    assert graphs.cache_size("t") == 3
    with graphs.disabled():
        out, _ = graphs.run("t", body, (torch.ones(5),), bound=lambda: (w,))
    assert out.shape == (5,) and graphs.cache_size("t") == 3
    assert graphs.stats()["t"]["misses"] == 3
    graphs.clear()
    assert graphs.cache_size("t") == 0


def test_a_freed_bound_tensor_drops_its_key():
    """On the CPU, where nothing is captured, the registry still holds a
    key a set of bound tensors, and drops it when one of them is freed."""
    kept, freed = torch.zeros(2), torch.zeros(2)
    try:
        for w in (kept, freed):
            graphs.run("t", _counted_step(w), (torch.ones(2),),
                       bound=lambda w=w: (w,))
        assert graphs.cache_size("t") == 2
        del w, freed
        assert graphs.cache_size("t") == 1
    finally:
        graphs.clear()


def test_a_key_outlives_a_library_binding(stand_in, monkeypatch):
    """A key compiled before a kernel library is bound is found after it:
    the wrappers bind their libraries lazily (the backward's at the first
    backward), and a key is not lost when one comes in."""
    monkeypatch.setattr(FA, "_fns", {})
    w = torch.zeros(2)
    graphs.run("t", _counted_step(w), (torch.ones(2),), bound=lambda: (w,))
    FA._fns["flash_bwd_dq_bf16"] = object()
    graphs.run("t", _counted_step(w), (torch.ones(2),), bound=lambda: (w,))
    assert (stand_in.captures, stand_in.replays) == (1, 1)
    assert graphs.stats()["t"]["misses"] == 1


def _drawing_step(w, gen):
    """A step that updates its bound weight and draws from ``gen``."""
    def body(x):
        w.add_(1.0)
        return x + torch.rand(x.shape, generator=gen)
    return body


def test_sampled_replays_draw_the_callers_stream(stand_in):
    """A sampled key compiled with one generator replays for any: each
    call draws from its own generator's state and advances it as the
    eager draw does, and a new generator is no new key."""
    w = torch.zeros(2)
    a, b = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    ea, eb = torch.Generator().manual_seed(1), torch.Generator().manual_seed(2)
    for gen, eager_gen in ((a, ea), (b, eb), (a, ea), (b, eb), (b, eb)):
        got = graphs.run("t", _drawing_step(w, gen), (torch.ones(2),),
                         bound=lambda: (w,), generator=gen)
        want = torch.ones(2) + torch.rand(2, generator=eager_gen)
        assert torch.equal(got, want)
        assert torch.equal(gen.get_state(), eager_gen.get_state())
    assert (stand_in.captures, stand_in.replays) == (1, 4)
    assert graphs.cache_size("t") == 1
    assert torch.equal(w, torch.full((2,), 5.0))


def test_a_failed_capture_raises(stand_in, monkeypatch):
    def refuse(*args):
        raise RuntimeError("capture refused")
    monkeypatch.setattr(stand_in, "capture", refuse)
    w = torch.zeros(2)
    with pytest.raises(RuntimeError, match="capture refused"):
        graphs.run("t", _counted_step(w), (torch.ones(2),),
                   bound=lambda: (w,))


def test_serving_replays_are_the_eager_steps(setup, stand_in):
    """generate, admit and both chunks through the stand-in: the same
    tokens, states and caches as their eager bodies, call after call."""
    _, tcfg, _, params = setup
    tokens = _t(np.stack([_prompt(90, 6), _prompt(91, 6)]))
    for _ in range(3):
        got = S.generate(params, tokens, tcfg, n_new=4, max_len=16)
        with graphs.disabled():
            want = S.generate(params, tokens, tcfg, n_new=4, max_len=16)
        assert torch.equal(got, want)
    st = _served_state(tcfg, params, 24)
    ref = _clone_rows(st)
    for step in range(3):
        S.release(st, 1)
        S.release(ref, 1)
        p = _t(_prompt(95 + step, 7))
        S.admit(params, st, p, 1)
        with graphs.disabled():
            S.admit(params, ref, p, 1)
        _, em = S.serve_chunk(params, st, 3)
        with graphs.disabled():
            _, want = S.serve_chunk(params, ref, 3)
        assert torch.equal(em, want)
        for key in ("pos", "active", "token"):
            assert torch.equal(st[key], ref[key])
        for a, b in zip(S._cache_tensors(st["cache"]),
                        S._cache_tensors(ref["cache"])):
            assert _bits_equal(a, b)
    pst = _paged_state(tcfg, params, 24, 4)
    pref = {"pages": [{kv: t.clone() for kv, t in layer.items()}
                      for layer in pst["pages"]],
            **{k: pst[k].clone() for k in ("table", "pos", "active",
                                           "token")}}
    for _ in range(2):
        _, em = S._serve_chunk_paged(params, pst, 2, None, None)
        with graphs.disabled():
            _, want = S._serve_chunk_paged(params, pref, 2, None, None)
        assert torch.equal(em, want)
        for a, b in zip(S._cache_tensors(pst["pages"]),
                        S._cache_tensors(pref["pages"])):
            assert _bits_equal(a, b)
    # generate, admit and serve_chunk replayed twice each, the paged chunk
    # once.
    assert stand_in.replays == 7


def test_sampled_serving_replays_are_the_eager_steps(setup, stand_in):
    """generate, admit and both chunks sampled through the stand-in: from
    generators seeded alike, the same tokens, states and caches as their
    eager bodies, and the generators left alike, call after call, with a
    second generator replaying the first one's graphs."""
    _, tcfg, _, params = setup
    tokens = _t(np.stack([_prompt(80, 6), _prompt(81, 6)]))
    gens = [torch.Generator().manual_seed(s) for s in (11, 12)]
    refs = [torch.Generator().manual_seed(s) for s in (11, 12)]
    for gen, ref_gen in zip(gens * 2, refs * 2):
        got = S.generate(params, tokens, tcfg, n_new=4, max_len=16,
                         temperature=0.8, generator=gen)
        with graphs.disabled():
            want = S.generate(params, tokens, tcfg, n_new=4, max_len=16,
                              temperature=0.8, generator=ref_gen)
        assert torch.equal(got, want)
    st = _served_state(tcfg, params, 24)
    ref = _clone_rows(st)
    temps = torch.tensor([0.7, 0.0, 1.3, 0.9])
    for step, (gen, ref_gen) in enumerate(zip(gens * 2, refs * 2)):
        S.release(st, 1)
        S.release(ref, 1)
        p = _t(_prompt(85 + step, 7))
        S.admit(params, st, p, 1, temperature=0.6, generator=gen)
        _, em = S.serve_chunk(params, st, 3, temps, gen)
        with graphs.disabled():
            S.admit(params, ref, p, 1, temperature=0.6, generator=ref_gen)
            _, want = S.serve_chunk(params, ref, 3, temps, ref_gen)
        assert torch.equal(em, want)
        for key in ("pos", "active", "token"):
            assert torch.equal(st[key], ref[key])
        for a, b in zip(S._cache_tensors(st["cache"]),
                        S._cache_tensors(ref["cache"])):
            assert _bits_equal(a, b)
    pst = _paged_state(tcfg, params, 24, 4)
    pref = {"pages": [{kv: t.clone() for kv, t in layer.items()}
                      for layer in pst["pages"]],
            **{k: pst[k].clone() for k in ("table", "pos", "active",
                                           "token")}}
    ptemps = torch.full((pst["pos"].shape[0],), 1.1)
    for gen, ref_gen in zip(gens, refs):
        _, em = S._serve_chunk_paged(params, pst, 2, ptemps, gen)
        with graphs.disabled():
            _, want = S._serve_chunk_paged(params, pref, 2, ptemps, ref_gen)
        assert torch.equal(em, want)
        for a, b in zip(S._cache_tensors(pst["pages"]),
                        S._cache_tensors(pref["pages"])):
            assert _bits_equal(a, b)
    for gen, ref_gen in zip(gens, refs):
        assert torch.equal(gen.get_state(), ref_gen.get_state())
    # One sampled key each, replayed by both generators (admit's other
    # four keys are the greedy admissions of _served_state's prompts).
    assert {name: graphs.cache_size(name) for name in
            ("generate", "admit", "serve_chunk", "serve_chunk_paged")} == \
        {"generate": 1, "admit": 5, "serve_chunk": 1, "serve_chunk_paged": 1}
    assert stand_in.replays == 10


def test_train_step_replays_are_the_eager_steps(stand_in):
    cfg = dataclasses.replace(M.ModelConfig().tiny(), dtype=torch.float32)
    init_fn, step, _ = T.make_train_step(cfg, device="cpu")
    tokens = _t(np.random.default_rng(3).integers(0, 256, (2, 16)))
    targets = torch.roll(tokens, -1, dims=1)
    pa, oa = init_fn(torch.Generator().manual_seed(0), tokens)
    pb, ob = init_fn(torch.Generator().manual_seed(0), tokens)
    for _ in range(3):
        _, _, la = step(pa, oa, tokens, targets)
        with graphs.disabled():
            _, _, lb = step(pb, ob, tokens, targets)
        assert la.item() == lb.item()
        for a, b in zip(pa.parameters(), pb.parameters()):
            assert torch.equal(a, b) and torch.equal(a.grad, b.grad)
    assert (stand_in.captures, stand_in.replays) == (1, 2)


# --------------------------------------------------------------------------
# The capturable AdamW against the JAX step
# --------------------------------------------------------------------------

def test_capturable_train_step_matches_jax(monkeypatch):
    """The single-card step with the optimizer ``init_fn`` builds on the
    card (``capturable=True``: the step count a device tensor) against
    the JAX package's step, three steps in fp32. PyTorch refuses a
    capturable optimizer on the CPU, so the test lets it: the arithmetic
    is the one the card runs."""
    monkeypatch.setattr(adam, "_get_capturable_supported_devices",
                        lambda supports_xla=True: ["cpu"])
    jcfg = dataclasses.replace(JM.ModelConfig().tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(M.ModelConfig().tiny(), dtype=torch.float32)
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, (2, 16)).astype(np.int32)
    targets = np.roll(tokens, -1, axis=1)
    jinit, jstep, _ = JT.make_train_step(jcfg, mesh=None)
    jparams, jopt = jinit(jax.random.PRNGKey(0), jnp.asarray(tokens))
    params = convert.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    _, step, _ = T.make_train_step(tcfg, device="cpu")
    opt = T.make_optimizer()(params.parameters(), capturable=True)
    for _ in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, jnp.asarray(tokens),
                                     jnp.asarray(targets))
        params, opt, loss = step(params, opt, _t(tokens), _t(targets))
        # The train tests' fp32 loss bound.
        assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert all(isinstance(s["step"], torch.Tensor)
               for s in opt.state.values())
    want = jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(np.asarray, jparams))
    got = jax.tree_util.tree_leaves(convert.params_to_numpy(params))
    for (path, w), g in zip(want, got, strict=True):
        # The train tests' fp32 gradient bound, on the weights three
        # AdamW updates later.
        err = np.max(np.abs(g - w)) / np.max(np.abs(w))
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)
