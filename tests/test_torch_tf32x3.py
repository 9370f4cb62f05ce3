"""Why the fp32 flash kernels split every product in three.

The fp32 forward (``tpushare_torch/csrc/flash_fwd.cu``) and the fp32 dq
and dk/dv kernels (``csrc/flash_bwd.cu``) run their products on the
tensor cores in TF32, which keeps 10 of fp32's 23 mantissa bits. Each
operand splits as x = hi + lo: hi = x rounded to TF32 (to nearest, ties
away, as ``cvt.rna.tf32.f32``), lo = x - hi, which the tensor core
truncates to TF32 (``csrc/sm90.cuh``, CUTLASS's 3xTF32 split); a product
is lo_a hi_b + hi_a lo_b + hi_a hi_b summed in fp32. These numpy models of
the kernels' arithmetic (the forward's online softmax over 64-key tiles,
each tile's P V summed from zero; the backward's formulas, those of
``flash_bwd_plain``; the products rounded as the tensor cores take them)
are held to the JAX package's Pallas kernels in interpret mode (the
forward, and the backward through its ``custom_vjp``): the split product
within the CPU tests' fp32 tolerance, one TF32 pass outside the 1e-4 the
kernels are held to on the card.
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


#: The forward's constants: its KV tile, the JAX package's NEG_INF (lse of
#: a row that sees no key) and the log2-domain scale's log2 e.
BK = 64
NEG_INF = np.float32(-2.0 ** 30)
LOG2E = np.float32(1.4426950408889634)
LN2 = np.float32(0.6931471805599453)


def fwd_model(mm, q, k, v, q_offset, kv_offset):
    """out and lse of one (batch, head) [L, D] block as the forward kernel
    computes them, every product taken by ``mm``: S = q k^T scaled into the
    log2 domain, an online softmax over 64-key tiles (masked scores -inf),
    and O = alpha O + P V with each tile's P V summed from zero, in fp32."""
    f32 = np.float32
    lq, d = q.shape
    scale_log2 = f32(1.0 / np.sqrt(d)) * LOG2E
    m = np.full(lq, NEG_INF, f32)
    l = np.zeros(lq, f32)
    o = np.zeros((lq, d), f32)
    qpos = q_offset + np.arange(lq)
    for k0 in range(0, k.shape[0], BK):
        kt, vt = k[k0:k0 + BK], v[k0:k0 + BK]
        keep = qpos[:, None] >= kv_offset + k0 + np.arange(len(kt))[None]
        s = np.where(keep, mm(q, kt.T) * scale_log2, f32(-np.inf))
        m_new = np.maximum(m, s.max(axis=1))
        alpha = np.exp2(m - m_new)
        p = np.exp2(s - m_new[:, None]).astype(f32)
        l = l * alpha + p.sum(axis=1, dtype=f32)
        o = o * alpha[:, None] + mm(p, vt)
        m = m_new
    out = o / np.maximum(l, f32(1e-30))[:, None]
    lse = np.where(l > 0, (m + np.log2(np.maximum(l, f32(1e-30)))) * LN2,
                   NEG_INF)
    return out.astype(f32), lse.astype(f32)


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


#: (D, Lq, Lk, q_offset, kv_offset) of the forward's cases: causal
#: self-attention at L = 512 at every head dim the kernel takes, and at
#: the dry run's D = 16 a later block of 256 queries against 512 keys.
FWD_CASES = [(16, 512, 512, 0, 0), (16, 256, 512, 256, 0),
             (64, 512, 512, 0, 0), (128, 512, 512, 0, 0)]


@pytest.fixture(scope="module", params=FWD_CASES,
                ids=["d16", "d16_offset", "d64", "d128"])
def fwd_reference(request):
    """Inputs of std 1 at 2 heads and the JAX package's Pallas forward
    (interpret mode): out and lse."""
    d, lq, lk, q_off, kv_off = request.param
    rng = np.random.default_rng(22)
    q, k, v = (rng.standard_normal((1, n, 2, d)).astype(np.float32)
               for n in (lq, lk, lk))
    out, lse = JFA.flash_block_with_lse(*map(jnp.asarray, (q, k, v)), q_off,
                                        kv_off, True)
    return {"args": (q, k, v, q_off, kv_off),
            "out": np.asarray(out, np.float32),
            "lse": np.asarray(lse, np.float32)}


def _fwd_errs(mm, reference):
    q, k, v, q_off, kv_off = reference["args"]
    got = [fwd_model(mm, q[0, :, hh], k[0, :, hh], v[0, :, hh], q_off,
                     kv_off) for hh in range(q.shape[2])]
    out = np.stack([o for o, _ in got], axis=1)
    lse = np.stack([x for _, x in got], axis=1)
    return {"out": _norm_err(out, reference["out"][0]),
            "lse": _norm_err(lse, reference["lse"][0])}


def test_forward_split_three_tf32_keeps_fp32_precision(fwd_reference):
    """The forward kernel's split products and per-tile sums: out and lse
    within the CPU tests' fp32 tolerance of the JAX package's Pallas
    forward, at head dims 16, 64 and 128."""
    errs = _fwd_errs(mm_3xtf32, fwd_reference)
    assert max(errs.values()) <= SPLIT_TOL, errs


def test_forward_one_tf32_pass_does_not(fwd_reference):
    """One TF32 pass in the same forward: out outside the 1e-4 the kernel
    is held to on the card."""
    errs = _fwd_errs(mm_1xtf32, fwd_reference)
    assert errs["out"] > CARD_TOL, errs
