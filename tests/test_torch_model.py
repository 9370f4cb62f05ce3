"""The port's flagship model against the JAX package's, on the same
weights (the JAX init tree carried across as numpy arrays)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workload import model as JM
from tpushare_torch import entry as E
from tpushare_torch.workload import convert
from tpushare_torch.workload import model as M

#: Normalized logit tolerance (max |diff| / max |ref|) per dtype: fp32 is
#: the algorithm at float precision; bf16 rounds at the same points in
#: both frameworks but the products accumulate in another order.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(name):
    jdt, tdt = DTYPES[name]
    jcfg = dataclasses.replace(JM.ModelConfig().tiny(), dtype=jdt)
    tcfg = dataclasses.replace(M.ModelConfig().tiny(), dtype=tdt)
    return jcfg, tcfg


def _tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _tokens(cfg, shape, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(dtype):
    jcfg, tcfg = _configs(dtype)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = convert.params_from_jax(_tree(jparams), tcfg, device="cpu")
    tokens = _tokens(jcfg, (2, 24))
    ref = np.asarray(JM.forward(jparams, jnp.asarray(tokens), jcfg))
    with torch.inference_mode():
        got = M.forward(params, torch.from_numpy(tokens).long(), tcfg)
    assert got.dtype == torch.float32
    err = np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref))
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("q_off,kv_off", [(0, 0), (8, 0), (0, 4)])
def test_layers_match_jax(q_off, kv_off):
    """rms_norm, rotary and offset-aware causal_attention in fp32."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 16, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 19), (2, 16)).astype(np.int32)
    tx, tk = torch.from_numpy(x), torch.from_numpy(k)
    # fp32 elementwise math and small contractions: ulps apart.
    np.testing.assert_allclose(
        M.rms_norm(tx, torch.from_numpy(scale)).numpy(),
        np.asarray(JM.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        M.rotary(tx, torch.from_numpy(pos)).numpy(),
        np.asarray(JM.rotary(jnp.asarray(x), jnp.asarray(pos))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        M.causal_attention(tx, tk, tk, q_off, kv_off).numpy(),
        np.asarray(JM.causal_attention(jnp.asarray(x), jnp.asarray(k),
                                       jnp.asarray(k), q_off, kv_off)),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convert_round_trip_is_exact(dtype):
    jcfg, tcfg = _configs(dtype)
    tree = _tree(JM.init_params(jax.random.PRNGKey(3), jcfg))
    params = convert.params_from_jax(tree, tcfg, device="cpu")
    assert all(p.dtype == tcfg.dtype for p in params.parameters())
    back = convert.params_to_numpy(params)
    flat_a, _ = jax.tree_util.tree_flatten(tree)
    flat_b, _ = jax.tree_util.tree_flatten(back)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        assert np.array_equal(np.asarray(a, np.float32), b)


def test_convert_rejects_a_mismatched_tree():
    jcfg, tcfg = _configs("float32")
    tree = _tree(JM.init_params(jax.random.PRNGKey(0), jcfg))
    wider = dataclasses.replace(tcfg, d_ff=2 * tcfg.d_ff)
    with pytest.raises(ValueError, match="w_gate"):
        convert.params_from_jax(tree, wider, device="cpu")
    deeper = dataclasses.replace(tcfg, n_layers=3)
    with pytest.raises(ValueError, match="blocks"):
        convert.params_from_jax(tree, deeper, device="cpu")


def test_param_names_and_shapes_follow_the_jax_tree():
    """Same leaves, same shapes, same count as JAX's init tree."""
    jcfg, tcfg = _configs("bfloat16")
    shapes = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                   jcfg))
    params = M.init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    got = {n: tuple(p.shape) for n, p in params.named_parameters()}
    want = {"embed": shapes["embed"].shape,
            "final_norm": shapes["final_norm"].shape}
    for i, blk in enumerate(shapes["blocks"]):
        want.update({f"blocks.{i}.{k}": v.shape for k, v in blk.items()})
    assert got == want
    assert sum(p.numel() for p in params.parameters()) == sum(
        x.size for x in jax.tree_util.tree_leaves(shapes))


def test_init_params_is_seeded_by_its_generator():
    cfg = M.ModelConfig().tiny()
    a = M.init_params(torch.Generator().manual_seed(7), cfg, "cpu")
    b = M.init_params(torch.Generator().manual_seed(7), cfg, "cpu")
    c = M.init_params(torch.Generator().manual_seed(8), cfg, "cpu")
    assert torch.equal(a.embed, b.embed)
    assert not torch.equal(a.embed, c.embed)
    assert torch.equal(a.blocks[0].attn_norm, torch.ones(cfg.d_model,
                                                         dtype=cfg.dtype))


def test_entry_on_cpu():
    fwd, (params, tokens) = E.entry(device="cpu")
    logits = fwd(params, tokens)
    assert logits.shape == (2, 256, 8192)
    assert logits.dtype == torch.float32
    assert torch.isfinite(logits).all()


def test_entry_points_raise_without_a_card():
    """With no card and no device='cpu', entry points raise rather than
    run on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = M.ModelConfig().tiny()
    for call in (E.entry,
                 lambda: M.init_params(torch.Generator(), cfg),
                 lambda: convert.params_from_jax({"blocks": []}, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
