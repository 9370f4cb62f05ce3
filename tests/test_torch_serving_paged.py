"""Chunked and interleaved admission and the paged server of the port
against the JAX package's, on ``tiny()`` in fp32 with the same weights:
greedy streams must be token-exact, each greedy step decided by a top-2
logit gap above ``MIN_GAP``, and equal to JAX ``generate``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workload import model as JM
from tpushare.workload import paging as JP
from tpushare.workload import serving as JS
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import paging as P
from tpushare_torch.workload import serving as S

#: As in test_torch_serving: the two frameworks differ by ~1e-6 in fp32
#: logits, so a step whose top-2 gap is above this is decided.
MIN_GAP = 1e-3
PAGE, MAX_LEN = 4, 32


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


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _solo(jcfg, jparams, prompt, n_new):
    """JAX ``generate``'s greedy continuation of ``prompt``, each step
    checked to be decided by the forward's top-2 gap."""
    out = np.asarray(JS.generate(jparams, jnp.asarray(prompt)[None, :], jcfg,
                                 n_new=n_new, max_len=MAX_LEN))[0]
    # Causal: position L - 1 of the whole sequence's forward is the
    # logits the step after the first L tokens picked from.
    logits = np.asarray(JM.forward(jparams, jnp.asarray(out[None, :-1]),
                                   jcfg))[0]
    for L in range(len(prompt), len(prompt) + n_new):
        top2 = np.sort(logits[L - 1])[-2:]
        assert top2[1] - top2[0] > MIN_GAP, L
    return out[len(prompt):].tolist()


def _same_slots(st, jst):
    for key in ("token", "pos", "active"):
        assert np.array_equal(_np(st[key]), np.asarray(jst[key])), key


# --------------------------------------------------------------------------
# Chunked and interleaved admission
# --------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [5, 4, 12])
def test_admit_chunked_matches_jax(setup, chunk):
    """A chunk that does not divide the 12-token prompt (the last piece
    pads), one that does, and the whole prompt as one piece: the state
    and the stream after a serve_chunk equal JAX's admit_chunked, and the
    stream equals JAX generate."""
    jcfg, tcfg, jparams, params = setup
    prompt = _prompt(60, 12)
    jst = JS.admit_chunked(jparams, JS.init_server_state(jcfg, 2, MAX_LEN),
                           jnp.asarray(prompt), jnp.int32(1), chunk=chunk)
    st = S.admit_chunked(params, S.init_server_state(tcfg, 2, MAX_LEN,
                                                     device="cpu"),
                         _t(prompt), 1, chunk=chunk)
    _same_slots(st, jst)
    first = int(st["token"][1])
    jst, jem = JS.serve_chunk(jparams, jst, 6)
    st, em = S.serve_chunk(params, st, 6)
    _same_slots(st, jst)
    assert np.array_equal(_np(em), np.asarray(jem))
    for got, want in zip(st["cache"], jst["cache"]):
        for kv in ("k", "v"):
            np.testing.assert_allclose(_np(got[kv]), np.asarray(want[kv]),
                                       atol=1e-5)
    assert [first] + em[:, 1].tolist() == _solo(jcfg, jparams, prompt, 7)


def test_admit_chunked_true_len_matches_jax(setup):
    """A prompt padded to its bucket with its real length given."""
    jcfg, tcfg, jparams, params = setup
    prompt = np.concatenate([_prompt(61, 9), np.zeros(7, np.int32)])
    jst = JS.admit_chunked(jparams, JS.init_server_state(jcfg, 1, MAX_LEN),
                           jnp.asarray(prompt), jnp.int32(0), chunk=4,
                           true_len=jnp.int32(9))
    st = S.admit_chunked(params, S.init_server_state(tcfg, 1, MAX_LEN,
                                                     device="cpu"),
                         _t(prompt), 0, chunk=4, true_len=9)
    _same_slots(st, jst)
    _, jem = JS.serve_chunk(jparams, jst, 4)
    _, em = S.serve_chunk(params, st, 4)
    assert np.array_equal(_np(em), np.asarray(jem))


def test_admit_interleaved_matches_jax(setup):
    """The emitted array equals JAX's; the co-tenant's stream equals an
    undisturbed serve_chunk run; the admitted slot's column is all -1
    until its finalize, and its stream then equals JAX generate."""
    jcfg, tcfg, jparams, params = setup
    pa, pb = _prompt(67, 5), _prompt(68, 8)
    chunk, steps = 4, 3
    n_pieces = -(-len(pb) // chunk)

    st_u = S.admit(params, S.init_server_state(tcfg, 2, MAX_LEN,
                                               device="cpu"), _t(pa), 0)
    _, em_u = S.serve_chunk(params, st_u, n_pieces * steps)

    jst = JS.admit(jparams, JS.init_server_state(jcfg, 2, MAX_LEN),
                   jnp.asarray(pa), jnp.int32(0))
    jst, jem = JS.admit_interleaved(jparams, jst, jnp.asarray(pb),
                                    jnp.int32(1), chunk=chunk,
                                    decode_steps=steps)
    st = S.admit(params, S.init_server_state(tcfg, 2, MAX_LEN,
                                             device="cpu"), _t(pa), 0)
    st, em = S.admit_interleaved(params, st, _t(pb), 1, chunk=chunk,
                                 decode_steps=steps)
    assert em.shape == (n_pieces * steps, 2)
    assert np.array_equal(_np(em), np.asarray(jem))
    _same_slots(st, jst)
    assert torch.equal(em[:, 0], em_u[:, 0])
    assert (em[:, 1] == -1).all()
    first = int(st["token"][1])
    _, em2 = S.serve_chunk(params, st, 4)
    assert [first] + em2[:, 1].tolist() == _solo(jcfg, jparams, pb, 5)

    # decode_steps=0: no interleaved output, the same admission.
    st0, em0 = S.admit_interleaved(
        params, S.init_server_state(tcfg, 2, MAX_LEN, device="cpu"),
        _t(pb), 1, chunk=chunk, decode_steps=0)
    assert em0.shape == (0, 2) and int(st0["token"][1]) == first


# (prompt length, slot, chunk, true_len, temperature, with randomness)
CHUNK_ERRORS = [
    (6, 0, 0, None, 0.0, False),       # chunk 0
    (6, 0, -3, None, 0.0, False),      # negative chunk
    (6, 0, 2.0, None, 0.0, False),     # chunk not an int
    (6, 1, 4, None, 0.0, False),       # slot past the table
    (6, -1, 4, None, 0.0, False),      # negative slot
    (17, 0, 4, None, 0.0, False),      # prompt longer than the cache
    (16, 0, 4, None, 0.0, False),      # prompt fills the cache
    (6, 0, 4, 0, 0.0, False),          # true_len below 1
    (6, 0, 4, 7, 0.0, False),          # true_len past the prompt
    (16, 0, 4, 16, 0.0, False),        # true_len leaves no decode room
    (6, 0, 4, None, -1.0, True),       # negative temperature
    (6, 0, 4, None, 0.7, False),       # sampling without randomness
    (13, 0, 6, None, 0.0, False),      # padded past the cache
]


@pytest.mark.parametrize("lp,slot,chunk,true_len,temp,keyed", CHUNK_ERRORS)
def test_chunk_plan_refusals_match_jax(setup, lp, slot, chunk, true_len,
                                       temp, keyed):
    jcfg, tcfg, jparams, params = setup
    prompt = _prompt(20, lp)
    with pytest.raises(ValueError) as jerr:
        JS.admit_chunked(jparams, JS.init_server_state(jcfg, 1, 16),
                         jnp.asarray(prompt), jnp.int32(slot), chunk=chunk,
                         true_len=true_len, temperature=temp,
                         key=jax.random.PRNGKey(0) if keyed else None)
    st = S.init_server_state(tcfg, 1, 16, device="cpu")
    with pytest.raises(ValueError) as terr:
        S.admit_chunked(params, st, _t(prompt), slot, chunk=chunk,
                        true_len=true_len, temperature=temp,
                        generator=torch.Generator() if keyed else None)
    assert str(terr.value).split()[:3] == str(jerr.value).split()[:3]
    assert not st["active"].any() and not st["cache"][0]["k"].any()


# --------------------------------------------------------------------------
# The paged server, case by case against JAX's (tests/test_serving.py
# TestPagedKV) and JAX generate, the first token read before the chunk
# --------------------------------------------------------------------------

def _paged(tcfg, slots, total_pages=16):
    return (S.init_paged_state(tcfg, slots, MAX_LEN, total_pages, PAGE,
                               device="cpu"),
            P.PagePool(total_pages, page_tokens=PAGE))


def _jpaged(jcfg, slots, total_pages=16):
    return (JS.init_paged_state(jcfg, slots, MAX_LEN, total_pages, PAGE),
            JP.PagePool(total_pages, page_tokens=PAGE))


def test_paged_streams_across_pages_match_jax(setup):
    """Mixed lengths decoding across page boundaries: every admission
    and chunk equals JAX's paged server, the pool leases equal, and each
    stream equals JAX generate."""
    jcfg, tcfg, jparams, params = setup
    prompts = [_prompt(80 + i, n) for i, n in enumerate((3, 6, 11))]
    jst, jpool = _jpaged(jcfg, 3, 24)
    st, pool = _paged(tcfg, 3, 24)
    for i, p in enumerate(prompts):
        jst = JS.admit_paged(jparams, jst, jpool, jnp.asarray(p), i)
        st = S.admit_paged(params, st, pool, _t(p), i)
        _same_slots(st, jst)
    streams = [[int(t)] for t in st["token"]]
    for _ in range(3):  # 15 steps: every stream crosses pages
        jst, jem = JS.serve_chunk_paged(jparams, jst, jpool, 5)
        st, em = S.serve_chunk_paged(params, st, pool, 5)
        assert np.array_equal(_np(em), np.asarray(jem))
        assert np.array_equal(_np(st["table"]), np.asarray(jst["table"]))
        _same_slots(st, jst)
        for i in range(3):
            streams[i] += em[:, i].tolist()
    assert pool.stats() == jpool.stats()
    for i, p in enumerate(prompts):
        assert pool.held(f"slot{i}") == jpool.held(f"slot{i}")
        assert streams[i] == _solo(jcfg, jparams, p, 16)


def test_prefix_shared_stream_matches_jax_and_generate(setup):
    """A second same-tenant stream reuses the shareable prefix pages
    (not prefilled again) and emits the same stream as the first, JAX's
    paged server and JAX generate."""
    jcfg, tcfg, jparams, params = setup
    prompt = _prompt(81, 9)
    jst, jpool = _jpaged(jcfg, 2)
    st, pool = _paged(tcfg, 2)
    for slot in (0, 1):
        jst = JS.admit_paged(jparams, jst, jpool, jnp.asarray(prompt), slot,
                             tenant="t")
        st = S.admit_paged(params, st, pool, _t(prompt), slot, tenant="t")
    assert pool.stats() == jpool.stats()
    assert pool.stats()["prefixHits"] == P.shareable_pages(9, PAGE) == 2
    assert pool.held("slot0")[:2] == pool.held("slot1")[:2]
    first = st["token"].tolist()
    assert first[0] == first[1]
    jst, jem = JS.serve_chunk_paged(jparams, jst, jpool, 6)
    st, em = S.serve_chunk_paged(params, st, pool, 6)
    assert np.array_equal(_np(em), np.asarray(jem))
    assert torch.equal(em[:, 0], em[:, 1])
    assert [first[0]] + em[:, 0].tolist() == _solo(jcfg, jparams, prompt, 7)


def test_cross_tenant_isolation_matches_jax(setup):
    jcfg, tcfg, jparams, params = setup
    prompt = _prompt(82, 9)
    jst, jpool = _jpaged(jcfg, 2)
    st, pool = _paged(tcfg, 2)
    for slot, tenant in ((0, "a"), (1, "b")):
        jst = JS.admit_paged(jparams, jst, jpool, jnp.asarray(prompt), slot,
                             tenant=tenant)
        st = S.admit_paged(params, st, pool, _t(prompt), slot,
                           tenant=tenant)
    assert not set(pool.held("slot0")) & set(pool.held("slot1"))
    assert pool.stats() == jpool.stats()
    assert pool.stats()["prefixHits"] == pool.stats()["sharedPages"] == 0
    _same_slots(st, jst)


def test_page_lifecycle_no_leak(setup):
    """Three cycles of admit, decode growth across a page boundary and
    release: each ends with every page free and the row unmapped, and
    each stream equals JAX generate."""
    jcfg, tcfg, jparams, params = setup
    prompt = _prompt(83, 6)
    want = _solo(jcfg, jparams, prompt, 6)
    st, pool = _paged(tcfg, 1)
    jst, jpool = _jpaged(jcfg, 1)
    for cycle in range(3):
        st = S.admit_paged(params, st, pool, _t(prompt), 0)
        jst = JS.admit_paged(jparams, jst, jpool, jnp.asarray(prompt), 0)
        assert len(pool.held("slot0")) == P.pages_for(6, PAGE) == 2
        first = int(st["token"][0])
        st, em = S.serve_chunk_paged(params, st, pool, 5)
        jst, jem = JS.serve_chunk_paged(jparams, jst, jpool, 5)
        assert np.array_equal(_np(em), np.asarray(jem))
        assert [first] + em[:, 0].tolist() == want, cycle
        # pos 11 needs 3 pages: decode growth took one
        assert pool.held("slot0") == jpool.held("slot0")
        assert len(pool.held("slot0")) == 3
        assert int((st["table"][0] >= 0).sum()) == 3
        st = S.release_paged(st, pool, 0)
        jst = JS.release_paged(jst, jpool, 0)
        assert pool.pages_free() == pool.total_pages, cycle
        assert int((st["table"][0] >= 0).sum()) == 0
        assert not bool(st["active"][0])
        _same_slots(st, jst)


def test_admit_paged_failure_releases_lease(setup):
    """A refused admission leaves every page free and the state as it
    was; an exhausted pool raises PoolExhausted, allocating nothing."""
    jcfg, tcfg, jparams, params = setup
    st, pool = _paged(tcfg, 1)
    jst, jpool = _jpaged(jcfg, 1)
    long = np.arange(MAX_LEN, dtype=np.int32)
    with pytest.raises(ValueError) as jerr:
        JS.admit_paged(jparams, jst, jpool, jnp.asarray(long), 0)
    with pytest.raises(ValueError) as terr:
        S.admit_paged(params, st, pool, _t(long), 0)
    assert str(terr.value).split()[:3] == str(jerr.value).split()[:3]
    assert pool.pages_free() == pool.total_pages

    tiny_pool = P.PagePool(1, page_tokens=PAGE)
    st2 = S.init_paged_state(tcfg, 1, MAX_LEN, 1, PAGE, device="cpu")
    with pytest.raises(P.PoolExhausted):
        S.admit_paged(params, st2, tiny_pool, _t(np.arange(9)), 0)
    assert tiny_pool.pages_free() == 1
    assert (st2["table"] == -1).all() and not st2["active"].any()


def test_admit_paged_rolls_back_a_failed_prefill(setup, monkeypatch):
    """A piece that raises after the lease exists: the lease goes back
    to the pool and the slot's table row is restored."""
    _, tcfg, _, params = setup
    st, pool = _paged(tcfg, 1)

    def boom(*args, **kwargs):
        raise RuntimeError("piece failed")

    monkeypatch.setattr(S, "_prefill_paged_piece", boom)
    with pytest.raises(RuntimeError, match="piece failed"):
        S.admit_paged(params, st, pool, _t(_prompt(84, 6)), 0)
    assert pool.pages_free() == pool.total_pages
    assert pool.held("slot0") == ()
    assert (st["table"] == -1).all() and not st["active"].any()


def test_pool_state_mismatch_rejected(setup):
    _, tcfg, _, params = setup
    st, _ = _paged(tcfg, 1)
    other = P.PagePool(16, page_tokens=PAGE * 2)
    with pytest.raises(ValueError, match="page_tokens"):
        S.admit_paged(params, st, other, _t(np.arange(5)), 0)
    with pytest.raises(ValueError, match="multiple"):
        S.init_paged_state(tcfg, 1, 30, 8, PAGE, device="cpu")
    with pytest.raises(ValueError, match="total_pages"):
        S.init_paged_state(tcfg, 1, 32, 0, PAGE, device="cpu")


def test_chunk_growth_partial_failure_rolls_back(setup):
    """A later slot's grow raising PoolExhausted: ensure_chunk_pages
    shrinks back exactly what the call grew and leaves the state
    untouched, so a retry grows cleanly, as in the JAX package."""
    jcfg, tcfg, jparams, params = setup
    prompt = _prompt(84, 6)
    st, pool = _paged(tcfg, 2, 5)
    jst, jpool = _jpaged(jcfg, 2, 5)
    for slot, tenant in ((0, "a"), (1, "b")):
        st = S.admit_paged(params, st, pool, _t(prompt), slot,
                           tenant=tenant)
        jst = JS.admit_paged(jparams, jst, jpool, jnp.asarray(prompt), slot,
                             tenant=tenant)
    assert pool.pages_free() == 1
    held = {s: pool.held(f"slot{s}") for s in (0, 1)}
    table = st["table"].clone()
    with pytest.raises(JP.PoolExhausted):
        JS.ensure_chunk_pages(jst, jpool, 5)
    with pytest.raises(P.PoolExhausted):
        S.ensure_chunk_pages(st, pool, 5)
    assert pool.stats() == jpool.stats()
    assert pool.pages_free() == 1
    assert pool.held("slot0") == held[0] and pool.held("slot1") == held[1]
    assert torch.equal(st["table"], table)
    st = S.release_paged(st, pool, 1)
    jst = JS.release_paged(jst, jpool, 1)
    st = S.ensure_chunk_pages(st, pool, 5)
    jst = JS.ensure_chunk_pages(jst, jpool, 5)
    assert len(pool.held("slot0")) == 3
    assert np.array_equal(_np(st["table"]), np.asarray(jst["table"]))


def test_paged_sampling_contract(setup):
    """Temperature checks as serve_chunk's; greedy slots beside a
    sampled one keep their greedy stream."""
    _, tcfg, _, params = setup
    prompt = _t(_prompt(85, 7))
    st, pool = _paged(tcfg, 2)
    st = S.admit_paged(params, st, pool, prompt, 0)
    st = S.admit_paged(params, st, pool, prompt, 1, tenant="b",
                       temperature=1.0,
                       generator=torch.Generator().manual_seed(1))
    first = int(st["token"][0])
    st, em = S.serve_chunk_paged(params, st, pool, 5, temperature=[0.0, 1.0],
                                 generator=torch.Generator().manual_seed(2))
    greedy = S.generate(params, prompt[None, :], tcfg, n_new=6,
                        max_len=MAX_LEN)
    assert [first] + em[:, 0].tolist() == greedy[0, 7:].tolist()
    assert ((em[:, 1] >= 0) & (em[:, 1] < tcfg.vocab_size)).all()
    with pytest.raises(ValueError, match="per-slot"):
        S.serve_chunk_paged(params, st, pool, 2, temperature=0.5,
                            generator=torch.Generator())
    with pytest.raises(ValueError, match="torch.Generator"):
        S.serve_chunk_paged(params, st, pool, 2, temperature=[0.5, 0.5])


# --------------------------------------------------------------------------
# Grant sizing
# --------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["default", "tiny"])
@pytest.mark.parametrize("page", [64, 16, 4])
@pytest.mark.parametrize("grant", [16, 8, 1, 0.01, 0.001, 0.0])
def test_pages_for_grant_matches_jax(which, page, grant):
    jcfg, tcfg = JM.ModelConfig(), M.ModelConfig()
    if which == "tiny":
        jcfg, tcfg = jcfg.tiny(), tcfg.tiny()
    assert (S.pages_for_grant(tcfg, grant, page)
            == JS.pages_for_grant(jcfg, grant, page))
    assert (S.pages_for_grant(tcfg, grant, page, headroom=0.5)
            == JS.pages_for_grant(jcfg, grant, page, headroom=0.5))


def test_pages_for_grant_refuses_a_bad_page():
    with pytest.raises(ValueError, match="page_tokens"):
        S.pages_for_grant(M.ModelConfig(), 1.0, 0)


# --------------------------------------------------------------------------
# What each piece asks of the kernel
# --------------------------------------------------------------------------

def _spy(monkeypatch):
    calls = []
    real = FA.flash_block_with_lse

    def spy(q, k, v, q_offset=0, kv_offset=0):
        calls.append({"lq": q.shape[1], "lk": k.shape[1],
                      "q_offset": q_offset, "kv_offset": kv_offset,
                      "k": k, "v": v, "q": q})
        return real(q, k, v, q_offset, kv_offset)

    monkeypatch.setattr(FA, "flash_block_with_lse", spy)
    return calls


def test_chunked_pieces_call_the_kernel_at_their_offset(setup, monkeypatch):
    """Each piece of admit_chunked is one flash_block_with_lse call a
    layer with q_offset = offset and Lk = offset + C, on the slot's
    cache rows in place (the call that is the kernel on the card)."""
    _, tcfg, _, params = setup
    calls = _spy(monkeypatch)
    st = S.init_server_state(tcfg, 3, MAX_LEN, device="cpu")
    S.admit_chunked(params, st, _t(_prompt(90, 11)), 2, chunk=4)
    n = tcfg.n_layers
    assert [(c["lq"], c["lk"], c["q_offset"], c["kv_offset"])
            for c in calls] == [(4, off + 4, off, 0)
                                for off in (0, 4, 8) for _ in range(n)]
    for i, c in enumerate(calls):
        layer = st["cache"][i % n]
        assert c["k"].data_ptr() == layer["k"][2].data_ptr()
        assert c["v"].data_ptr() == layer["v"][2].data_ptr()


def test_paged_pieces_call_the_kernel_at_their_offset(setup, monkeypatch):
    """admit_paged runs only the unshared pieces, each at q_offset =
    piece * page against the gathered pages [0, piece]."""
    _, tcfg, _, params = setup
    calls = _spy(monkeypatch)
    st, pool = _paged(tcfg, 2)
    prompt = _t(_prompt(91, 10))
    S.admit_paged(params, st, pool, prompt, 0, tenant="t")
    S.admit_paged(params, st, pool, prompt, 1, tenant="t")
    n = tcfg.n_layers
    shapes = [(c["lq"], c["lk"], c["q_offset"]) for c in calls]
    first = [(PAGE, (i + 1) * PAGE, i * PAGE) for i in range(3)]
    second = first[P.shareable_pages(10, PAGE):]  # shared pieces skipped
    assert shapes == [s for s in first + second for _ in range(n)]


def test_pieces_feed_tma_at_flagship_head_shape(monkeypatch):
    """The bf16 kernel reads its tiles by TMA: the slot's B = 1 slice of
    the contiguous cache and the gathered paged view pass its check at
    the flagship's 8 heads of 64 (the dispatch itself is exercised on
    the card by chip_smoke.py)."""
    cfg = dataclasses.replace(M.ModelConfig(), vocab_size=64, n_layers=1,
                              d_ff=64)
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    calls = _spy(monkeypatch)
    prompt = _t(_prompt(92, 130, 64))
    S.admit_chunked(params, S.init_server_state(cfg, 3, 256, device="cpu"),
                    prompt, 1, chunk=64)
    st = S.init_paged_state(cfg, 2, 256, 8, 64, device="cpu")
    S.admit_paged(params, st, P.PagePool(8, page_tokens=64), prompt, 1)
    assert len(calls) == 6
    for c in calls:
        assert c["k"].stride()[1] * c["k"].element_size() == 1024
        FA._check_tma(q=c["q"], k=c["k"], v=c["v"])
