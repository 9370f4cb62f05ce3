"""The chunked and paged prefill pieces and their finalize as compiled
steps (``tpushare_torch.workload.graphs``) on the CPU: replays through the
stand-in for capture are the eager bodies bit for bit, greedy and sampled;
one piece key serves every piece of every prompt in every slot; a piece
with device scalars against the JAX package's jitted piece; the plain
attention with offsets as device tensors against int offsets; and the
C entries as ``ctypes`` binds them."""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tests.test_torch_graphs import StandIn
from tpushare.workload import model as JM
from tpushare.workload import serving as JS
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import paging as P
from tpushare_torch.workload import serving as S

MAX_LEN, CHUNK, SLOTS = 32, 4, 4
#: (slot, prompt length): three lengths into three slots, the last piece
#: of the first and third padded.
ADMISSIONS = ((2, 11), (0, 5), (3, 16))


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


@pytest.fixture
def stand_in(monkeypatch):
    fake = StandIn()
    monkeypatch.setattr(graphs, "STAND_IN", fake)
    monkeypatch.setattr(FA, "FLASH_FWD_LAUNCHES", 0)
    graphs.clear()
    yield fake
    graphs.clear()


def _prompt(seed, n, vocab=256):
    return torch.from_numpy(
        np.random.default_rng(seed).integers(0, vocab, n)).long()


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype.is_floating_point else t


def _same(a: dict, b: dict, keys) -> None:
    for key in keys:
        if isinstance(a[key], list):
            for x, y in zip(S._cache_tensors(a[key]),
                            S._cache_tensors(b[key]), strict=True):
                assert torch.equal(_bits(x), _bits(y)), key
        else:
            assert torch.equal(a[key], b[key]), key


def _gens(sampled: bool, seed: int):
    """(kwargs, generator) of one admission path: greedy, or sampled at
    0.7 from a generator seeded ``seed``."""
    if not sampled:
        return {}, None
    gen = torch.Generator().manual_seed(seed)
    return {"temperature": 0.7, "generator": gen}, gen


def _serving_state(tcfg, params):
    """Two slots decoding (1 and 0 of ``ADMISSIONS``' slots are
    recycled by them), the others free."""
    state = S.init_server_state(tcfg, SLOTS, MAX_LEN, device="cpu")
    for slot, n in ((1, 6), (0, 3)):
        S.admit(params, state, _prompt(70 + slot, n), slot)
    return state


def _clone(state: dict) -> dict:
    out = {k: v.clone() for k, v in state.items() if k != "cache"
           and k != "pages"}
    for key in ("cache", "pages"):
        if key in state:
            out[key] = [{kv: t.clone() for kv, t in layer.items()}
                        for layer in state[key]]
    return out


# --------------------------------------------------------------------------
# Replays against the eager bodies
# --------------------------------------------------------------------------

def _chunked(params, state, slot, prompt, **kw):
    S.release(state, slot)
    S.admit_chunked(params, state, prompt, slot, chunk=CHUNK, **kw)
    return None


def _interleaved(params, state, slot, prompt, **kw):
    S.release(state, slot)
    return S.admit_interleaved(params, state, prompt, slot, chunk=CHUNK,
                               decode_steps=2, **kw)[1]


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("path", [_chunked, _interleaved])
def test_contiguous_piece_replays_are_the_eager_bodies(setup, stand_in,
                                                       path, sampled):
    """Three prompts of three lengths into three slots beside two decoding
    slots (interleaved: 2 decode steps after each piece), compiled and
    eager from one state: the same emitted tokens, positions, activity,
    tokens and caches bit for bit, and the generators left alike. One
    piece key and one finalize key serve all of them."""
    _, tcfg, _, params = setup
    st_g = _serving_state(tcfg, params)
    st_e = _clone(st_g)
    kw_g, gen_g = _gens(sampled, 5)
    kw_e, gen_e = _gens(sampled, 5)
    for slot, n in ADMISSIONS:
        prompt = _prompt(90 + slot, n)
        got = path(params, st_g, slot, prompt, **kw_g)
        with graphs.disabled():
            want = path(params, st_e, slot, prompt, **kw_e)
        if got is not None:
            assert torch.equal(got, want)
        _same(st_g, st_e, ("cache", "pos", "active", "token"))
    if sampled:
        assert torch.equal(gen_g.get_state(), gen_e.get_state())
    pieces = sum(-(-n // CHUNK) for _, n in ADMISSIONS)
    assert graphs.cache_size("prefill_chunk") == 1
    assert graphs.cache_size("finalize_admit") == 1
    stats = graphs.stats()
    assert stats["prefill_chunk"]["misses"] == 1
    assert stats["prefill_chunk"]["replays"] == pieces - 1
    assert stats["finalize_admit"]["replays"] == len(ADMISSIONS) - 1


@pytest.mark.parametrize("sampled", [False, True])
def test_paged_piece_replays_are_the_eager_bodies(setup, stand_in, sampled):
    """admit_paged of a prompt into slot 0, the same prompt of the same
    tenant into slot 2 (its prefix pages shared, those pieces skipped)
    and another prompt into slot 1, compiled and eager from one state:
    the same pages, table, slots and pool, bit for bit."""
    _, tcfg, _, params = setup
    total = 24
    st_g = S.init_paged_state(tcfg, 3, MAX_LEN, total, CHUNK, device="cpu")
    st_e = _clone(st_g)
    pool_g = P.PagePool(total, page_tokens=CHUNK)
    pool_e = P.PagePool(total, page_tokens=CHUNK)
    kw_g, gen_g = _gens(sampled, 6)
    kw_e, gen_e = _gens(sampled, 6)
    shared = _prompt(95, 14)
    for slot, prompt in ((0, shared), (2, shared), (1, _prompt(96, 7))):
        S.admit_paged(params, st_g, pool_g, prompt, slot, tenant="t", **kw_g)
        with graphs.disabled():
            S.admit_paged(params, st_e, pool_e, prompt, slot, tenant="t",
                          **kw_e)
        _same(st_g, st_e, ("pages", "table", "pos", "active", "token"))
        assert pool_g.stats() == pool_e.stats()
    if sampled:
        assert torch.equal(gen_g.get_state(), gen_e.get_state())
    assert pool_g.stats()["prefixHits"] == P.shareable_pages(14, CHUNK)
    # The shared stream's first token is its leader's, greedy.
    if not sampled:
        assert int(st_g["token"][2]) == int(st_g["token"][0])
    pieces = (2 * P.pages_for(14, CHUNK) - P.shareable_pages(14, CHUNK)
              + P.pages_for(7, CHUNK))
    assert graphs.cache_size("prefill_paged_piece") == 1
    assert graphs.stats()["prefill_paged_piece"]["replays"] == pieces - 1
    assert graphs.cache_size("finalize_admit") == 1


def test_one_piece_key_serves_every_prompt_and_slot(setup):
    """On the CPU the registry keeps a key a compiled step, as on the
    card: three prompts of three lengths in three slots, chunked and
    paged, miss once a path and never again."""
    _, tcfg, _, params = setup
    graphs.clear()
    try:
        state = S.init_server_state(tcfg, SLOTS, MAX_LEN, device="cpu")
        pst = S.init_paged_state(tcfg, SLOTS, MAX_LEN, 24, CHUNK,
                                 device="cpu")
        pool = P.PagePool(24, page_tokens=CHUNK)
        for slot, n in ADMISSIONS:
            S.admit_chunked(params, state, _prompt(slot, n), slot,
                            chunk=CHUNK)
            S.admit_paged(params, pst, pool, _prompt(slot, n), slot)
            for name in ("prefill_chunk", "prefill_paged_piece",
                         "finalize_admit"):
                assert graphs.cache_size(name) == 1, name
                assert graphs.stats()[name]["misses"] == 1, name
        # A sampled finalize is a key of its own; the pieces are not.
        S.admit_chunked(params, state, _prompt(9, 6), 1, chunk=CHUNK,
                        temperature=0.5,
                        generator=torch.Generator().manual_seed(0))
        assert graphs.cache_size("prefill_chunk") == 1
        assert graphs.cache_size("finalize_admit") == 2
    finally:
        graphs.clear()


# --------------------------------------------------------------------------
# One piece against the JAX package's jitted piece
# --------------------------------------------------------------------------

@pytest.mark.parametrize("slot,offset,true_len", [(0, 0, 3), (2, 4, 7),
                                                  (1, 8, 5), (3, 12, 16)])
def test_piece_matches_jax(setup, slot, offset, true_len):
    """One contiguous piece with slot, offset and true length as device
    scalars against JAX's ``_prefill_chunk`` on the same state (earlier
    rows noise, so the piece must attend them): the slot's cache and the
    carried hidden state, which the piece replaces only where it holds
    position true_len - 1."""
    jcfg, tcfg, jparams, params = setup
    rng = np.random.default_rng(slot + offset)
    shape = (SLOTS, MAX_LEN, tcfg.n_heads, tcfg.head_dim)
    cache = [{kv: rng.standard_normal(shape).astype(np.float32)
              for kv in ("k", "v")} for _ in range(tcfg.n_layers)]
    tokens = rng.integers(0, 256, CHUNK).astype(np.int32)
    carry = rng.standard_normal(tcfg.d_model).astype(np.float32)
    jstate = dict(JS.init_server_state(jcfg, SLOTS, MAX_LEN),
                  cache=[{kv: jnp.asarray(a) for kv, a in layer.items()}
                         for layer in cache])
    jstate, jcarry = JS._prefill_chunk(
        jparams, jstate, jnp.asarray(tokens), jnp.int32(slot),
        jnp.int32(offset), jnp.int32(true_len), jnp.asarray(carry))
    state = S.init_server_state(tcfg, SLOTS, MAX_LEN, device="cpu")
    with torch.inference_mode():
        for layer, arrays in zip(state["cache"], cache):
            for kv in ("k", "v"):
                layer[kv].copy_(torch.from_numpy(arrays[kv]))
        got = S._prefill_chunk(
            params, state, torch.from_numpy(tokens).long(),
            S._scalar(slot, "cpu"), S._scalar(offset, "cpu"),
            S._scalar(true_len, "cpu"), torch.from_numpy(carry)[None])
    # fp32 of O(1): ulps of another summation order.
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jcarry),
                               atol=1e-5)
    if not offset <= true_len - 1 < offset + CHUNK:
        assert torch.equal(got[0], torch.from_numpy(carry))
    for layer, jlayer in zip(state["cache"], jstate["cache"]):
        for kv in ("k", "v"):
            np.testing.assert_allclose(layer[kv].numpy(),
                                       np.asarray(jlayer[kv]), atol=1e-5)


# --------------------------------------------------------------------------
# Offsets as device tensors
# --------------------------------------------------------------------------

def _offset(value: int) -> torch.Tensor:
    return torch.tensor([value], dtype=torch.int32)


@settings(max_examples=40, deadline=None)
@given(lq=st.integers(1, 9), lk=st.integers(1, 12),
       q_offset=st.integers(0, 40), kv_offset=st.integers(0, 40),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]),
       seed=st.integers(0, 2 ** 16))
def test_tensor_offsets_are_the_int_offsets(lq, lk, q_offset, kv_offset,
                                            dtype, seed):
    """The plain attention (what a piece runs on the CPU) with offsets as
    1-element int32 tensors gives the bits int offsets give, rows that see
    no key included, through the dispatching entry too."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((1, n, 2, 16), generator=g).to(dtype)
               for n in (lq, lk, lk))
    want = FA.flash_block_with_lse_plain(q, k, v, q_offset, kv_offset)
    pair = torch.tensor([q_offset, kv_offset], dtype=torch.int32)
    for got in (FA.flash_block_with_lse_plain(q, k, v, _offset(q_offset),
                                              _offset(kv_offset)),
                FA.flash_block_with_lse(q, k, v, pair[0:1], pair[1:2]),
                FA.flash_block_with_lse(q, k, v, _offset(q_offset),
                                        kv_offset)):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_offset_pair_is_one_device_buffer():
    """The kernel reads one int32 pair: adjacent elements of one buffer go
    as they are, anything else is put together on q's device."""
    q = torch.zeros((1, 2, 1, 16))
    pair = torch.tensor([7, 3], dtype=torch.int32)
    same = FA._offset_pair(q, pair[0:1], pair[1:2])
    assert same.data_ptr() == pair.data_ptr() and same.tolist() == [7, 3]
    assert FA._offset_pair(q, _offset(5), 0).tolist() == [5, 0]
    assert FA._offset_pair(q, 2, _offset(9)).tolist() == [2, 9]
    assert FA._offset_pair(q, pair[1:2], pair[0:1]).tolist() == [3, 7]
    assert FA._offset_pair(q, 4, 1) is None


@pytest.mark.parametrize("form", ["tensor_int", "int_tensor", "two_tensors",
                                  "adjacent"])
def test_offset_args_hand_back_the_pair_they_point_at(form):
    """The C entry's pointer is the pair's, and the pair comes back with
    it for the wrapper to hold through the launch: a pair put together
    from offsets that are not adjacent is otherwise freed before the
    kernel reads it."""
    q = torch.zeros((1, 2, 1, 16))
    both = torch.tensor([7, 3], dtype=torch.int32)
    q_off, kv_off = {"tensor_int": (_offset(7), 3),
                     "int_tensor": (7, _offset(3)),
                     "two_tensors": (_offset(7), _offset(3)),
                     "adjacent": (both[0:1], both[1:2])}[form]
    args, pair = FA._offset_args(q, q_off, kv_off)
    assert args == (0, 0, pair.data_ptr()) and pair.tolist() == [7, 3]
    assert FA._offset_args(q, 7, 3) == ((7, 3, None), None)


def _c_params(entry: str) -> list[str]:
    """The parameter list of an ``extern "C"`` entry in ``csrc/``."""
    for src in FA._CSRC.glob("*.cu"):
        m = re.search(rf'extern "C" int {entry}\((.*?)\)\s*{{',
                      src.read_text(), re.S)
        if m:
            return [p.strip() for p in m.group(1).split(",")]
    raise AssertionError(f"no C entry {entry}")


@pytest.mark.parametrize("lib,entry", [
    (lib, entry) for lib, entries in FA._ENTRIES.items()
    for entry in entries])
def test_ctypes_binding_matches_the_c_entry(lib, entry):
    """``bind_library``'s argument types match each C entry's parameters
    one for one: a pointer where the source has one, an int, a 64-bit
    stride. Every entry takes the offsets pair's pointer before the
    stream: the forward 24 arguments, dq 29 and dk/dv 30."""
    params = _c_params(entry)
    types = FA.entry_argtypes(lib, entry)
    assert len(types) == len(params)
    for c, t in zip(params, types):
        if "*" in c:
            assert t is ctypes.c_void_p, c
        elif c.startswith("long long"):
            assert t is ctypes.c_longlong, c
        else:
            assert c.startswith("int ") and t is ctypes.c_int, c
    assert len(types) == {"tpushare_flash_fwd": 24,
                          "tpushare_flash_bwd_dq": 29,
                          "tpushare_flash_bwd_dkv": 30}[entry]
    assert params[-2] == "const int* offsets"
