"""Why the fp32 backward kernels split every product in three.

The fp32 dq and dk/dv kernels (``tpushare_torch/csrc/flash_bwd.cu``) run
their five products on the tensor cores in TF32, which keeps 10 of fp32's
23 mantissa bits. Each operand splits as x = hi + lo: hi = x rounded to
TF32 (to nearest, ties away, as ``cvt.rna.tf32.f32``), lo = x - hi, which
the tensor core truncates to TF32 (``csrc/sm90.cuh``, CUTLASS's 3xTF32
split); a product is lo_a hi_b + hi_a lo_b + hi_a hi_b summed in fp32. This
numpy model of the kernels' arithmetic (the same formulas as
``flash_bwd_plain``, the products rounded as the tensor cores take them)
is held to the JAX package's ``custom_vjp`` through the Pallas backward in
interpret mode: the split product within the CPU tests' fp32 tolerance,
one TF32 pass outside the 1e-4 the kernels are held to on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpushare.workload import flash_attention as JFA

#: The CPU tests' fp32 bound (max |diff| / max |ref|), and the card's.
SPLIT_TOL = 1e-5
CARD_TOL = 1e-4


def tf32(x: np.ndarray) -> np.ndarray:
    """fp32 rounded to TF32, to nearest with ties away from zero."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_cut(x: np.ndarray) -> np.ndarray:
    """fp32 as the tensor core reads it as TF32: the low 13 bits dropped."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def mm_3xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b as the kernels take it: split-three TF32, fp32 sums (each
    TF32 x TF32 product is exact in fp32)."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32_cut(a - a_hi), tf32_cut(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def mm_1xtf32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a @ b in one TF32 pass, fp32 sums."""
    return tf32(a) @ tf32(b)


def bwd_model(mm, q, k, v, do, lse, delta, q_offset, kv_offset):
    """dq, dk, dv of one (batch, head) [L, D] block with every product
    taken by ``mm``: the kernels' formulas (p = exp(min(s - lse, 30)) where
    the global causal mask keeps the pair, ds = p (dp - delta))."""
    scale = np.float32(1.0 / np.sqrt(q.shape[-1]))
    lq, lk = q.shape[0], k.shape[0]
    keep = (q_offset + np.arange(lq))[:, None] >= (kv_offset
                                                   + np.arange(lk))[None]
    s = mm(q, k.T) * scale
    p = np.where(keep, np.exp(np.minimum(s - lse[:, None], 30.0)),
                 0.0).astype(np.float32)
    ds = p * (mm(do, v.T) - delta[:, None])
    return mm(ds, k) * scale, mm(ds.T, q) * scale, mm(p.T, do)


def _norm_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


#: (Lq, Lk, q_offset, kv_offset): causal self-attention at L = 512, and a
#: later block of 256 queries against all 512 keys (a chunk's shape).
CASES = [(512, 512, 0, 0), (256, 512, 256, 0)]


@pytest.fixture(scope="module", params=CASES, ids=["causal", "offset"])
def reference(request):
    """Inputs of std 0.5 at D = 64, 2 heads, and the JAX package's
    gradients of sum(out * do) through the Pallas kernels (interpret
    mode), with the forward's lse and delta = rowsum(do * out)."""
    lq, lk, q_off, kv_off = request.param
    h, d = 2, 64
    rng = np.random.default_rng(20)
    q = (rng.standard_normal((1, lq, h, d)) * 0.5).astype(np.float32)
    k = (rng.standard_normal((1, lk, h, d)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((1, lk, h, d)) * 0.5).astype(np.float32)
    do = (rng.standard_normal((1, lq, h, d)) * 0.5).astype(np.float32)

    def loss(q, k, v):
        out, _ = JFA.flash_block_with_lse(q, k, v, q_off, kv_off, True)
        return jnp.sum(out * do)

    grads = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    out, lse = JFA.flash_block_with_lse(*map(jnp.asarray, (q, k, v)), q_off,
                                        kv_off, True)
    out, lse = np.asarray(out, np.float32), np.asarray(lse, np.float32)
    delta = np.sum(do * out, axis=-1)
    return {"args": (q, k, v, do, lse, delta, q_off, kv_off),
            "grads": [np.asarray(g, np.float32) for g in grads]}


def _model_errs(mm, reference):
    q, k, v, do, lse, delta, q_off, kv_off = reference["args"]
    errs = {}
    for name, i in (("dq", 0), ("dk", 1), ("dv", 2)):
        got = np.stack([bwd_model(mm, q[0, :, hh], k[0, :, hh], v[0, :, hh],
                                  do[0, :, hh], lse[0, :, hh],
                                  delta[0, :, hh], q_off, kv_off)[i]
                        for hh in range(q.shape[2])], axis=1)
        errs[name] = _norm_err(got, reference["grads"][i][0])
    return errs


def test_split_three_tf32_keeps_fp32_precision(reference):
    """The kernels' split product: every gradient within the CPU tests'
    fp32 tolerance of the JAX package's."""
    errs = _model_errs(mm_3xtf32, reference)
    assert max(errs.values()) <= SPLIT_TOL, errs


def test_one_tf32_pass_does_not(reference):
    """One TF32 pass at the same inputs: outside the 1e-4 the kernels are
    held to on the card, which is why the kernels split."""
    errs = _model_errs(mm_1xtf32, reference)
    assert max(errs.values()) > CARD_TOL, errs


def test_tf32_split_rounds_hi_to_nearest_ties_away():
    """hi rounds as cvt.rna does: 10 mantissa bits kept, a tie rounded away
    from zero; hi + lo, lo cut to TF32, is x to about 22 bits."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    assert tf32(np.float32(one + ulp / 2)) == one + ulp       # tie: away
    assert tf32(np.float32(-(one + ulp / 2))) == -(one + ulp)
    assert tf32(np.float32(one + ulp / 4)) == one             # below: down
    x = np.random.default_rng(21).standard_normal(1000).astype(np.float32)
    hi = tf32(x)
    lo = tf32_cut(x - hi)
    assert np.all(np.abs(hi - x) <= np.abs(x) * 2.0 ** -11)
    assert np.all(np.abs(hi + lo - x) <= np.abs(x) * 2.0 ** -21)
