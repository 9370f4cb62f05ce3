"""Gradients through ``flash_block_with_lse`` with its offsets as device
tensors, as the reference differentiates through traced offsets.

The reference's ``flash_block_with_lse`` is a ``custom_vjp`` whose offsets
are traced arguments, passed on to both Pallas backward kernels; its ring
calls it under ``jax.grad`` with offsets from ``axis_index``. The port's
twin takes 1-element int32 tensors there, which the backward kernels read
on the card as the forward does. On the CPU (these tests) the backward is
the kernels' plain version, with the offset tensors added into its mask.

Held here, on seeded numpy inputs in fp32, at head dims 16 and 64 and
with Lq != Lk: the gradients with tensor offsets equal those with the same
offsets as ints bit for bit, and are within 1e-5 (normalized) of
``jax.grad`` through the reference under ``jax.jit`` with the offsets
traced (the Pallas kernels in interpret mode, as the JAX package's tests
run them), with the lse cotangent zero and, through ``merge_partials``,
nonzero. dq is compared on rows that see a key, as in
``tests/test_torch_flash_attention.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workload import flash_attention as JFA
from tpushare_torch.workload import flash_attention as FA

#: fp32 on both sides, the same algorithm summed in another order.
GRAD_TOL = 1e-5   # max |diff| / max |ref|
HEAD_DIMS = (16, 64)
#: (Lq, Lk, q_offset, kv_offset), Lq != Lk: a chunk after the first block
#: against the whole KV, a chunk at a half-block offset, and a KV block
#: that starts past the first 64 query rows (they see no key).
CASES = [(128, 256, 128, 0), (128, 256, 64, 0), (128, 256, 0, 64)]


def _qkv(seed, lq, lk, h, d):
    rng = np.random.default_rng(seed)
    return tuple((rng.standard_normal((1, n, h, d)) * 0.5).astype(np.float32)
                 for n in (lq, lk, lk))


def _weights(seed, lq, h, d, vis):
    """Cotangent weights of a loss on both outputs; the lse weight is 0 on
    rows that see no key (their lse is the NEG_INF sentinel)."""
    rng = np.random.default_rng(seed)
    w_out = rng.standard_normal((1, lq, h, d)).astype(np.float32)
    w_lse = rng.standard_normal((1, lq, h)).astype(np.float32)
    w_lse[:, ~vis] = 0.0
    return w_out, w_lse


def _visible(lq, q_off, kv_off):
    return q_off + np.arange(lq) >= kv_off


def _norm_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _offset(x):
    return torch.tensor([x], dtype=torch.int32)


def _port_grads(q, k, v, q_off, kv_off, w_out, w_lse):
    """(dq, dk, dv) of sum(out * w_out) + sum(lse * w_lse) through the
    port's autograd Function, with the offsets as given (ints or
    tensors)."""
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = FA.flash_block_with_lse(tq, tk, tv, q_off, kv_off)
    tw_lse = torch.from_numpy(w_lse)
    loss = ((out * torch.from_numpy(w_out)).sum()
            + (torch.where(tw_lse != 0, lse, 0.0) * tw_lse).sum())
    return torch.autograd.grad(loss, (tq, tk, tv))


@jax.jit
def _jax_grads(q, k, v, q_off, kv_off, w_out, w_lse):
    """The same gradients through the reference, its offsets traced."""
    def loss(q, k, v):
        out, lse = JFA.flash_block_with_lse(q, k, v, q_off, kv_off, True)
        return (jnp.sum(out * w_out)
                + jnp.sum(jnp.where(w_lse != 0, lse, 0.0) * w_lse))

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _case(lq, lk, q_off, kv_off, d, seed=0):
    q, k, v = _qkv(seed, lq, lk, 2, d)
    vis = _visible(lq, q_off, kv_off)
    return q, k, v, vis, _weights(seed + 1, lq, 2, d, vis)


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk,q_off,kv_off", CASES)
def test_tensor_offsets_give_the_int_offsets_gradients(lq, lk, q_off, kv_off,
                                                       d):
    """Tensor offsets, apart or as adjacent elements of one pair, against
    ints: dq, dk and dv bit for bit."""
    q, k, v, _, (w_out, w_lse) = _case(lq, lk, q_off, kv_off, d)
    want = _port_grads(q, k, v, q_off, kv_off, w_out, w_lse)
    pair = torch.tensor([q_off, kv_off], dtype=torch.int32)
    for offsets in ((_offset(q_off), _offset(kv_off)), (pair[0:1], pair[1:2]),
                    (_offset(q_off), kv_off)):
        got = _port_grads(q, k, v, *offsets, w_out, w_lse)
        for name, g, r in zip(("dq", "dk", "dv"), got, want):
            assert torch.equal(g, r), name


@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("lq,lk,q_off,kv_off", CASES)
def test_tensor_offset_grads_match_jax_traced_offsets(lq, lk, q_off, kv_off,
                                                      d):
    """The port with tensor offsets against ``jax.grad`` through the
    reference with traced offsets, within GRAD_TOL."""
    q, k, v, vis, (w_out, w_lse) = _case(lq, lk, q_off, kv_off, d)
    ref = _jax_grads(*map(jnp.asarray, (q, k, v)), jnp.int32(q_off),
                     jnp.int32(kv_off), jnp.asarray(w_out),
                     jnp.asarray(w_lse))
    got = _port_grads(q, k, v, _offset(q_off), _offset(kv_off), w_out, w_lse)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        g, r = g.numpy(), np.asarray(r)
        if name == "dq":
            g, r = g[:, vis], r[:, vis]
        assert _norm_err(g, r) <= GRAD_TOL, name


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_merged_blocks_with_tensor_offsets_match_jax(d):
    """A ring rank's two steps: a Q block at offset 128 against the KV
    halves at 0 and 128, merged by ``merge_partials``, so each block's
    backward gets a nonzero lse cotangent. Tensor offsets give the ints'
    gradients bit for bit, and ``jax.grad`` through the reference's traced
    offsets within GRAD_TOL."""
    lq, half = 128, 128
    q, k, v = _qkv(3, lq, 2 * half, 2, d)
    w = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)

    def port(offset):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        parts = [FA.flash_block_with_lse(tq, tk[:, i * half:(i + 1) * half],
                                         tv[:, i * half:(i + 1) * half],
                                         offset(half), offset(i * half))
                 for i in range(2)]
        out, _ = FA.merge_partials(*parts[0], *parts[1])
        return torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                   (tq, tk, tv))

    @jax.jit
    def ref(q, k, v, q_off, kv_offs):
        def loss(q, k, v):
            parts = [JFA.flash_block_with_lse(
                q, k[:, i * half:(i + 1) * half],
                v[:, i * half:(i + 1) * half], q_off, kv_offs[i], True)
                for i in range(2)]
            out, _ = JFA.merge_partials(*parts[0], *parts[1])
            return jnp.sum(out * w)

        return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)

    got = port(_offset)
    want = port(int)
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        assert torch.equal(g, r), name
    jgrads = ref(*map(jnp.asarray, (q, k, v)), jnp.int32(half),
                 jnp.asarray([0, half], dtype=jnp.int32))
    for name, g, r in zip(("dq", "dk", "dv"), got, jgrads):
        assert _norm_err(g.numpy(), np.asarray(r)) <= GRAD_TOL, name


def test_offset_tensors_get_no_gradient_and_are_saved():
    """The Function saves the offset tensors for its backward and returns
    no gradient for them; an int offset beside a tensor one is kept."""
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(5, 64, 128, 2, 16))
    q_off = _offset(64)
    out, lse = FA.flash_block_with_lse(q, k, v, q_off, 0)
    assert type(out.grad_fn).__name__ == "_FlashBlockBackward"
    assert any(t is q_off or t.data_ptr() == q_off.data_ptr()
               for t in out.grad_fn.saved_tensors)
    out.sum().backward()
    assert q_off.grad is None and q.grad is not None


def test_an_offset_tensor_of_another_dtype_or_size_is_refused():
    """An offset tensor must be one int32 element on q's device, with or
    without grad."""
    q, k, v = (torch.randn((1, 4, 2, 16), requires_grad=True)
               for _ in range(3))
    for bad in (torch.tensor([2]), torch.tensor([2, 0], dtype=torch.int32)):
        with pytest.raises(ValueError, match="int32"):
            FA.flash_block_with_lse(q, k, v, bad)
        with torch.no_grad(), pytest.raises(ValueError, match="int32"):
            FA.flash_block_with_lse(q, k, v, 0, bad)
