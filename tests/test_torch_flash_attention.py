"""The port's flash-attention forward against the JAX package's.

On the CPU the port's wrapper takes its plain version, so these tests
hold that plain version to the Pallas kernel (run in interpret mode)
and to the kernel's XLA twin, on the same numpy inputs. Rows that see
no key are left out of every comparison: the two JAX paths themselves
disagree there, and serving never produces such rows.
"""

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


@pytest.mark.parametrize("case,match", [
    ({"shape": (1, 64, 2, 32)}, "head_dim"),
    ({"dtype": torch.float16}, "float32 or bfloat16"),
    ({"strided": True}, "unit-stride"),
    ({"grad": True}, "inference_mode"),
    ({}, "CUDA device"),
])
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
