"""The port's flash attention, forward and backward, against the JAX
package's.

On the CPU the port's wrappers take their plain versions, so these tests
hold those plain versions, and the autograd wiring around them, to the
Pallas kernels (run in interpret mode) and to the forward kernel's XLA
twin, on the same numpy inputs. Rows that see no key are left out of
every comparison of outputs and of dq: the two JAX paths themselves
disagree there, and neither serving nor training produces such rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workload import flash_attention as JFA
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M

#: fp32 on both sides, same algorithm, different summation order.
OUT_TOL = 1e-5   # max |diff| / max |ref|
LSE_TOL = 1e-5   # absolute


def _qkv(seed, b, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, lq, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((b, lk, h, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((b, lk, h, d)) * 0.5).astype(np.float32)
    return q, k, v


def _visible(lq, q_offset, kv_offset):
    """Rows that see at least one key (kv position kv_offset)."""
    return q_offset + np.arange(lq) >= kv_offset


def _norm_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _port(q, k, v, q_offset, kv_offset):
    out, lse = FA.flash_block_with_lse(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), q_offset,
                                       kv_offset)
    return out.numpy(), lse.numpy()


# (Lq, Lk, q_offset, kv_offset): self-attention, and a later Q block
# against the whole KV (a chunked prefill's shape).
PALLAS_CASES = [(256, 256, 0, 0), (128, 256, 128, 0)]


@pytest.mark.parametrize("lq,lk,q_off,kv_off", PALLAS_CASES)
def test_plain_matches_pallas_interpret(lq, lk, q_off, kv_off):
    b, h, d = 1, 2, 64                      # BH = 2
    q, k, v = _qkv(0, b, lq, lk, h, d)

    def to_bh(x):
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, -1, d))

    out_bh, lse8 = JFA._flash_call(to_bh(q), to_bh(k), to_bh(v),
                                   q_offset=q_off, kv_offset=kv_off,
                                   interpret=True)
    ref_out = np.asarray(out_bh).reshape(b, h, lq, d).transpose(0, 2, 1, 3)
    ref_lse = np.asarray(lse8)[:, 0, :].reshape(b, h, lq).transpose(0, 2, 1)
    out, lse = _port(q, k, v, q_off, kv_off)
    vis = _visible(lq, q_off, kv_off)
    assert _norm_err(out[:, vis], ref_out[:, vis]) <= OUT_TOL
    assert np.max(np.abs(lse[:, vis] - ref_lse[:, vis])) <= LSE_TOL


# XLA-twin cases add a ragged length and rows that see no key.
TWIN_CASES = PALLAS_CASES + [(200, 200, 0, 0), (384, 384, 0, 64)]


@pytest.mark.parametrize("lq,lk,q_off,kv_off", TWIN_CASES)
def test_plain_matches_xla_twin(lq, lk, q_off, kv_off):
    q, k, v = _qkv(1, 2, lq, lk, 2, 64)
    ref_out, ref_lse = JFA._xla_block_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_off, kv_off)
    ref_out, ref_lse = np.asarray(ref_out), np.asarray(ref_lse)
    out, lse = _port(q, k, v, q_off, kv_off)
    vis = _visible(lq, q_off, kv_off)
    assert _norm_err(out[:, vis], ref_out[:, vis]) <= OUT_TOL
    assert np.max(np.abs(lse[:, vis] - ref_lse[:, vis])) <= LSE_TOL
    # Rows with no key report the NEG_INF sentinel, so merges weigh them 0.
    assert (lse[:, ~vis] == FA.NEG_INF).all()
    assert (ref_lse[:, ~vis] == FA.NEG_INF).all()


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(2)
    o1, o2 = (rng.standard_normal((2, 32, 2, 16)).astype(np.float32)
              for _ in range(2))
    lse1, lse2 = (rng.standard_normal((2, 32, 2)).astype(np.float32) * 3
                  for _ in range(2))
    lse2[0, :4] = FA.NEG_INF                 # a partial that saw nothing
    ref_out, ref_lse = JFA.merge_partials(*map(jnp.asarray,
                                               (o1, lse1, o2, lse2)))
    out, lse = FA.merge_partials(*map(torch.from_numpy,
                                      (o1, lse1, o2, lse2)))
    # fp32 elementwise exp/log: a few ulps apart.
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               rtol=1e-6, atol=1e-6)


def test_merging_two_kv_halves_equals_whole():
    """The merge is exact: attention over [K1; K2] equals merging the
    partials over K1 and K2 at their global offsets."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 1, 96, 96, 2, 64))
    whole, whole_lse = FA.flash_block_with_lse(q, k, v)
    o1, l1 = FA.flash_block_with_lse(q, k[:, :48], v[:, :48], 0, 0)
    o2, l2 = FA.flash_block_with_lse(q, k[:, 48:], v[:, 48:], 0, 48)
    out, lse = FA.merge_partials(o1, l1, o2, l2)
    # fp32, two summation orders: within a few ulps of O(1) values.
    torch.testing.assert_close(out, whole, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lse, whole_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("lq,lk,q_off,kv_off", [(256, 256, 0, 128),
                                                (64, 96, 0, 32),
                                                (128, 64, 0, 100)])
def test_rows_that_see_no_key_give_what_the_kernel_gives(lq, lk, q_off,
                                                         kv_off):
    """The port's contract on rows that see no key, as the CUDA kernels
    write them: out 0 and lse NEG_INF forward; dq 0 backward, and such
    rows add nothing to dk or dv (the same gradients as without them),
    whatever their cotangents."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(13, 1, lq, lk, 2, 64))
    rng = np.random.default_rng(14)
    do = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    dlse = torch.from_numpy(
        rng.standard_normal(q.shape[:3]).astype(np.float32))
    seen = torch.from_numpy(_visible(lq, q_off, kv_off))
    out, lse = FA.flash_block_with_lse_plain(q, k, v, q_off, kv_off)
    assert (out[:, ~seen] == 0).all()
    assert (lse[:, ~seen] == FA.NEG_INF).all()
    dq, dk, dv = FA.flash_bwd_plain(q, k, v, out, lse, do, dlse, q_off,
                                    kv_off)
    assert (dq[:, ~seen] == 0).all()
    if seen.any():
        first = int(seen.nonzero()[0])
        _, dk_seen, dv_seen = FA.flash_bwd_plain(
            q[:, first:], k, v, out[:, first:], lse[:, first:],
            do[:, first:], dlse[:, first:], q_off + first, kv_off)
        torch.testing.assert_close(dk, dk_seen, rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(dv, dv_seen, rtol=1e-6, atol=1e-6)
    else:
        assert (dk == 0).all() and (dv == 0).all()
    # The autograd Function gives the same.
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    t_out, t_lse = FA.flash_block_with_lse(tq, tk, tv, q_off, kv_off)
    assert torch.equal(t_out, out) and torch.equal(t_lse, lse)
    ((t_out * do).sum() + (t_lse * dlse).sum()).backward()
    assert (tq.grad[:, ~seen] == 0).all()
    torch.testing.assert_close(tk.grad, dk, rtol=1e-6, atol=1e-6)


def test_merging_a_partial_that_saw_nothing_changes_nothing():
    """A ring step over a KV block past every query row gives out 0 and
    lse NEG_INF; merged with a partial that saw keys it leaves that
    partial as it was."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(15, 1, 64, 128, 2, 64))
    seen_out, seen_lse = FA.flash_block_with_lse(q, k[:, :64], v[:, :64],
                                                 64, 0)
    none_out, none_lse = FA.flash_block_with_lse(q, k[:, 64:], v[:, 64:],
                                                 0, 64)
    assert (none_out == 0).all() and (none_lse == FA.NEG_INF).all()
    for args in ((seen_out, seen_lse, none_out, none_lse),
                 (none_out, none_lse, seen_out, seen_lse)):
        out, lse = FA.merge_partials(*args)
        assert torch.equal(out, seen_out) and torch.equal(lse, seen_lse)


def test_flash_attention_on_cpu_takes_the_plain_version():
    q, k, v = (torch.from_numpy(x) for x in _qkv(4, 2, 64, 64, 2, 64))
    before = FA.FLASH_FWD_LAUNCHES
    out = FA.flash_attention(q, k, v)
    assert FA.FLASH_FWD_LAUNCHES == before
    assert torch.equal(out, FA.flash_block_with_lse_plain(q, k, v)[0])
    # ... which is causal attention: fp32, same math in another order.
    torch.testing.assert_close(out, M.causal_attention(q, k, v),
                               rtol=1e-5, atol=1e-5)


def _refused(**kw):
    shape = kw.pop("shape", (1, 64, 2, 64))
    dtype = kw.pop("dtype", torch.float32)
    q = torch.zeros(shape, dtype=dtype)
    if kw.pop("strided", False):
        q = torch.zeros(shape[:-1] + (2 * shape[-1],), dtype=dtype)[..., ::2]
    if kw.pop("grad", False):
        q.requires_grad_(True)
    return q


REFUSALS = [
    ({"shape": (1, 64, 2, 32)}, "head_dim"),
    ({"dtype": torch.float16}, "float32 or bfloat16"),
    ({"strided": True}, "unit-stride"),
    ({"grad": True}, "inference_mode"),
    ({}, "CUDA device"),
]


@pytest.mark.parametrize("case,match", REFUSALS)
def test_kernel_refuses_what_it_cannot_take(case, match):
    """The CUDA entry raises, before building anything, on inputs it
    cannot take; a CPU tensor is one of them."""
    q = _refused(**case)
    k = torch.zeros(q.shape, dtype=q.dtype)
    before = FA.FLASH_FWD_LAUNCHES
    with pytest.raises(ValueError, match=match):
        FA.flash_fwd_kernel(q, k, k)
    assert FA.FLASH_FWD_LAUNCHES == before
    assert not FA.supported(q, k, k)


def test_best_attn_fn_by_device():
    assert FA.best_attn_fn("cpu") is M.causal_attention
    if torch.cuda.is_available():
        assert FA.best_attn_fn("cuda") is FA.flash_attention
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FA.best_attn_fn()


# --------------------------------------------------------------------------
# Backward
# --------------------------------------------------------------------------

#: fp32 gradients on both sides, same formulas, different summation order.
GRAD_TOL = 1e-5  # max |diff| / max |ref|


def _to_bh(x):
    b, l, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, l, d))


def _from_bh(x, b, h):
    bh, l, d = x.shape
    return np.asarray(x).reshape(b, h, l, d).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("lq,lk,q_off,kv_off", PALLAS_CASES)
def test_bwd_plain_matches_pallas_interpret(lq, lk, q_off, kv_off):
    """flash_bwd_plain against the Pallas dq and dk/dv kernels, from the
    same saved (out, lse) and a nonzero lse cotangent."""
    b, h, d = 1, 2, 64
    q, k, v = _qkv(5, b, lq, lk, h, d)
    rng = np.random.default_rng(6)
    do = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    dlse = rng.standard_normal((b, lq, h)).astype(np.float32)
    out_bh, lse8 = JFA._flash_call(_to_bh(q), _to_bh(k), _to_bh(v),
                                   q_offset=q_off, kv_offset=kv_off,
                                   interpret=True)
    lse_bh = lse8[:, 0, :]
    dlse_bh = jnp.asarray(dlse.transpose(0, 2, 1).reshape(b * h, lq))
    ref = JFA._flash_bwd_call(_to_bh(q), _to_bh(k), _to_bh(v), out_bh, lse_bh,
                              _to_bh(do), dlse=dlse_bh, q_offset=q_off,
                              kv_offset=kv_off, interpret=True)
    out = torch.from_numpy(_from_bh(out_bh, b, h).copy())
    lse = torch.from_numpy(
        np.asarray(lse_bh).reshape(b, h, lq).transpose(0, 2, 1).copy())
    got = FA.flash_bwd_plain(*map(torch.from_numpy, (q, k, v)), out, lse,
                             torch.from_numpy(do), torch.from_numpy(dlse),
                             q_off, kv_off)
    vis = _visible(lq, q_off, kv_off)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        r = _from_bh(r, b, h)
        if name == "dq":
            g, r = g[:, vis], r[:, vis]
        assert _norm_err(g.numpy(), r) <= GRAD_TOL, name


# (Lq, Lk, q_offset, kv_offset): self-attention, a later Q block, and a KV
# block that starts past the first query rows (rows 0-127 see no key).
GRAD_CASES = PALLAS_CASES + [(256, 256, 0, 128)]


@pytest.mark.parametrize("lq,lk,q_off,kv_off", GRAD_CASES)
def test_block_grads_match_jax_custom_vjp(lq, lk, q_off, kv_off):
    """The autograd Function behind flash_block_with_lse against JAX's
    custom_vjp (the Pallas backward in interpret mode), for a loss on both
    outputs; dq is compared on rows that see a key."""
    b, h, d = 1, 2, 64
    q, k, v = _qkv(7, b, lq, lk, h, d)
    rng = np.random.default_rng(8)
    w_out = rng.standard_normal((b, lq, h, d)).astype(np.float32)
    w_lse = rng.standard_normal((b, lq, h)).astype(np.float32)
    vis = _visible(lq, q_off, kv_off)
    w_lse[:, ~vis] = 0.0          # lse there is the NEG_INF sentinel

    def jloss(q, k, v):
        out, lse = JFA.flash_block_with_lse(q, k, v, q_off, kv_off, True)
        return (jnp.sum(out * w_out)
                + jnp.sum(jnp.where(w_lse != 0, lse, 0.0) * w_lse))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = FA.flash_block_with_lse(tq, tk, tv, q_off, kv_off)
    tw_lse = torch.from_numpy(w_lse)
    loss = ((out * torch.from_numpy(w_out)).sum()
            + (torch.where(tw_lse != 0, lse, 0.0) * tw_lse).sum())
    loss.backward()
    for name, g, r in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad),
                          ref):
        g, r = g.numpy(), np.asarray(r)
        if name == "dq":
            g, r = g[:, vis], r[:, vis]
        assert _norm_err(g, r) <= GRAD_TOL, name


def test_flash_attention_grads_match_jax():
    """flash_attention (lse unused: its cotangent arrives as None) against
    JAX's flash_attention custom_vjp through the Pallas backward."""
    q, k, v = _qkv(9, 2, 128, 128, 2, 64)
    w = np.random.default_rng(10).standard_normal(q.shape).astype(np.float32)
    ref = jax.grad(lambda q, k, v: jnp.sum(
        JFA.flash_attention(q, k, v, True) * w), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (FA.flash_attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for g, r in zip((tq.grad, tk.grad, tv.grad), ref):
        assert _norm_err(g.numpy(), np.asarray(r)) <= GRAD_TOL


def test_block_autograd_wiring():
    """With grad, the Function records a node and saves its residuals;
    under inference mode, or with no input requiring grad, nothing is
    recorded and the outputs equal the plain forward's."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(11, 1, 64, 64, 2, 64))
    with torch.inference_mode():
        out, lse = FA.flash_block_with_lse(q, k, v)
    assert out.grad_fn is None and lse.grad_fn is None
    plain = FA.flash_block_with_lse_plain(q, k, v)
    assert torch.equal(out, plain[0]) and torch.equal(lse, plain[1])
    assert FA.flash_block_with_lse(q, k, v)[0].grad_fn is None
    out, lse = FA.flash_block_with_lse(q.requires_grad_(), k, v)
    assert type(out.grad_fn).__name__ == "_FlashBlockBackward"
    assert torch.equal(out, plain[0]) and torch.equal(lse, plain[1])
    # Only lse used: do arrives as None and is taken as zeros.
    (dq,) = torch.autograd.grad(lse.sum(), (q,))
    ref = FA.flash_bwd_plain(q.detach(), k, v, out.detach(), lse.detach(),
                             torch.zeros_like(out), torch.ones_like(lse))[0]
    assert torch.equal(dq, ref)


def test_bwd_on_cpu_takes_the_plain_version():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(12, 1, 64, 64, 2, 64))
    before = (FA.FLASH_FWD_LAUNCHES, FA.FLASH_BWD_DQ_LAUNCHES,
              FA.FLASH_BWD_DKV_LAUNCHES)
    FA.flash_attention(q, k, v).square().sum().backward()
    assert (FA.FLASH_FWD_LAUNCHES, FA.FLASH_BWD_DQ_LAUNCHES,
            FA.FLASH_BWD_DKV_LAUNCHES) == before
    assert all(t.grad is not None for t in (q, k, v))


def _bwd_inputs(q, **kw):
    b, l, h, _ = q.shape
    k = torch.zeros(q.shape, dtype=q.dtype)
    do = kw.get("do", torch.zeros(q.shape, dtype=q.dtype))
    lse = kw.get("lse", torch.zeros((b, l, h)))
    return q, k, k, do, lse, torch.zeros((b, l, h))


BWD_REFUSALS = REFUSALS + [
    ({"do": torch.zeros((1, 32, 2, 64))}, "do must be like q"),
    ({"lse": torch.zeros((1, 64, 2), dtype=torch.float64)}, "lse must be"),
    ({"lse": torch.zeros((1, 2, 64)).transpose(1, 2)}, "lse must be"),
]


@pytest.mark.parametrize("entry", ["flash_bwd_dq_kernel",
                                   "flash_bwd_dkv_kernel"])
@pytest.mark.parametrize("case,match", BWD_REFUSALS)
def test_bwd_kernels_refuse_what_they_cannot_take(entry, case, match):
    """The backward entries raise, before building anything, on inputs
    they cannot take: odd shapes, dtypes, strides, tensors that require
    grad, and CPU tensors."""
    case = dict(case)
    extra = {key: case.pop(key) for key in ("do", "lse") if key in case}
    args = _bwd_inputs(_refused(**case), **extra)
    counters = ("FLASH_BWD_DQ_LAUNCHES", "FLASH_BWD_DKV_LAUNCHES")
    before = [getattr(FA, c) for c in counters]
    with pytest.raises(ValueError, match=match):
        getattr(FA, entry)(*args)
    assert [getattr(FA, c) for c in counters] == before


# --------------------------------------------------------------------------
# Build and TMA preconditions (pure host logic: runs without a card)
# --------------------------------------------------------------------------

def test_lib_path_follows_every_header(tmp_path, monkeypatch):
    """A library is named by its source and every csrc/*.cuh, so editing a
    shared header builds anew instead of loading a stale library."""
    (tmp_path / "flash_fwd.cu").write_text('#include "sm90.cuh"\n')
    (tmp_path / "sm90.cuh").write_text("// v1\n")
    monkeypatch.setattr(FA, "_CSRC", tmp_path)
    first = FA._lib_path("flash_fwd")
    assert FA._lib_path("flash_fwd") == first
    (tmp_path / "sm90.cuh").write_text("// v2\n")
    second = FA._lib_path("flash_fwd")
    assert second != first
    (tmp_path / "other.cuh").write_text("// a new header\n")
    third = FA._lib_path("flash_fwd")
    assert third not in (first, second)
    (tmp_path / "flash_fwd.cu").write_text('#include "sm90.cuh"\n// edit\n')
    assert FA._lib_path("flash_fwd") not in (first, second, third)


def _fused_qkv(b=2, l=64, h=4, d=64):
    """q, k, v as the model makes them: views of one fused projection,
    [B, L, 3, H, D], so each has a length stride of 3 H D."""
    qkv = torch.zeros((b, l, 3 * h * d), dtype=torch.bfloat16)
    qkv = qkv.unflatten(-1, (3, h, d))
    return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def _tma(t):
    return FA.tma_problem(t.shape, t.stride(), t.data_ptr(), t.element_size())


@pytest.mark.parametrize("d", [64, 128])
def test_tma_accepts_the_models_tensors(d):
    for t in _fused_qkv(d=d):
        assert t.stride(1) == 3 * 4 * d
        assert _tma(t) is None
    assert _tma(torch.zeros((2, 64, 4, d), dtype=torch.bfloat16)) is None
    # An axis of size 1 is never stepped: its stride does not matter.
    lone = torch.zeros((1, 1, 1, d + 8), dtype=torch.bfloat16)[..., :d]
    assert _tma(lone) is None


def _misaligned(dtype=torch.bfloat16):
    flat = torch.zeros(2 * 64 * 4 * 64 + 1, dtype=dtype)
    return flat[1:].view(2, 64, 4, 64)


def _odd_length_stride(dtype=torch.bfloat16):
    rows = torch.zeros((2, 64, 4 * 64 + 4), dtype=dtype)
    return rows[..., :4 * 64].unflatten(-1, (4, 64))     # 520-byte rows


def _odd_head_stride(dtype=torch.bfloat16):
    heads = torch.zeros((2, 64, 4, 64 + 4), dtype=dtype)
    return heads[..., :64]                                  # 136-byte heads


def _expanded_batch(dtype=torch.bfloat16):
    return torch.zeros((1, 64, 4, 64), dtype=dtype).expand(2, 64, 4, 64)


TMA_REFUSALS = [
    (_misaligned, "16-byte aligned"),
    (_odd_length_stride, "length stride of 520 bytes"),
    (_odd_head_stride, "head stride of 136 bytes"),
    (_expanded_batch, "batch stride of 0 bytes"),
]


@pytest.mark.parametrize("make,match", TMA_REFUSALS)
def test_tma_problem_names_what_tma_cannot_read(make, match):
    problem = _tma(make())
    assert problem is not None and match in problem


def _counters():
    return (FA.FLASH_FWD_LAUNCHES, FA.FLASH_BWD_DQ_LAUNCHES,
            FA.FLASH_BWD_DKV_LAUNCHES)


class _Launched(Exception):
    """Raised by the stand-in for ``_launch``: the wrapper got that far."""


def _wrapper_call(entry, t):
    """Call the wrapper ``entry`` with ``t`` as every [B, L, H, D] input
    (and contiguous fp32 lse and delta for the backward)."""
    if entry == "flash_fwd_kernel":
        return FA.flash_fwd_kernel(t, t, t)
    stats = torch.zeros(t.shape[:3])
    return getattr(FA, entry)(t, t, t, t, stats, stats)


@pytest.fixture
def wrappers_on_any_device(monkeypatch):
    """The wrappers with only the device check lifted (a CPU tensor gets
    past it) and a ``_launch`` that raises ``_Launched`` instead of
    launching; yields the launch counters' values before the call."""
    real = FA._check_kernel_inputs

    def on_any_device(q, k, v):
        try:
            real(q, k, v)
        except ValueError as exc:
            if "CUDA device" not in str(exc):
                raise

    def launch(*_):
        raise _Launched

    monkeypatch.setattr(FA, "_check_kernel_inputs", on_any_device)
    monkeypatch.setattr(FA, "_launch", launch)
    return _counters()


WRAPPERS = ["flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"]


@pytest.mark.parametrize("entry", WRAPPERS)
@pytest.mark.parametrize("make,match", TMA_REFUSALS)
def test_bf16_wrappers_refuse_what_tma_cannot_read(wrappers_on_any_device,
                                                   entry, make, match):
    """Every bf16 kernel is fed by TMA: its wrapper raises before any
    launch on a tensor TMA cannot read, and no counter moves."""
    with pytest.raises(ValueError,
                       match="cannot feed the TMA-fed bf16 kernel") as exc:
        _wrapper_call(entry, make())
    assert match in str(exc.value)
    assert _counters() == wrappers_on_any_device


@pytest.mark.parametrize("entry", WRAPPERS)
def test_fp32_wrappers_take_what_tma_cannot_read(wrappers_on_any_device,
                                                 entry):
    """The fp32 kernels load with plain loads: the same misaligned view in
    fp32 passes the TMA check and reaches the launch."""
    with pytest.raises(_Launched):
        _wrapper_call(entry, _misaligned(torch.float32))
    assert _counters() == wrappers_on_any_device
