"""The port's training slice against the JAX package's: loss and every
parameter gradient through flash attention (the Pallas backward in
interpret mode on the JAX side, the plain backward behind the port's
autograd Function here), one AdamW update against optax's, and the
single-device train step."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpushare.workload import flash_attention as JFA
from tpushare.workload import model as JM
from tpushare.workload import train as JT
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import train as T

#: Loss (relative) and per-leaf gradient (max |diff| / max |ref|)
#: tolerances. fp32: the same algorithm in another summation order. bf16:
#: both frameworks round activations at the same points, but products
#: accumulate in another order and a bf16 rounding that lands the other
#: way propagates through the backward. The bound is measured: at this
#: seed the JAX package's own bf16 gradients differ from its fp32 ones by
#: up to 3.3e-2 normalized (5.5e-2 at another seed), and the port's from
#: JAX's bf16 ones by up to 2.8e-2, so 4e-2 holds the port to the
#: reference's own bf16 noise rather than to the chip's 2e-2 on a single
#: attention call.
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 4e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _configs(dtype, remat):
    jdt, tdt = DTYPES[dtype]
    jcfg = dataclasses.replace(JM.ModelConfig().tiny(), dtype=jdt,
                               remat=remat)
    tcfg = dataclasses.replace(M.ModelConfig().tiny(), dtype=tdt,
                               remat=remat)
    return jcfg, tcfg


def _batch(cfg, b, l, seed=1):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, l)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _norm_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("dtype,remat", [("float32", True),
                                         ("float32", False),
                                         ("bfloat16", True)])
def test_loss_and_grads_match_jax_through_flash(dtype, remat):
    jcfg, tcfg = _configs(dtype, remat)
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tokens, targets = _batch(jcfg, 2, 128)
    jloss, jgrads = jax.value_and_grad(JT.loss_fn)(
        jparams, jnp.asarray(tokens), jnp.asarray(targets), jcfg,
        attn_fn=partial(JFA.flash_attention, interpret=True))

    params = convert.params_from_jax(tree, tcfg, device="cpu")
    loss = T.loss_fn(params, torch.from_numpy(tokens).long(),
                     torch.from_numpy(targets).long(), tcfg,
                     attn_fn=FA.flash_attention)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= LOSS_TOL[dtype] * abs(
        float(jloss))
    got = jax.tree_util.tree_leaves(convert.grads_to_numpy(params))
    ref = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32), jgrads))
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert _norm_err(g, r) <= GRAD_TOL[dtype]


def test_remat_changes_nothing_but_the_recompute(monkeypatch):
    """With remat the block forward runs twice per layer (once more in the
    backward), the backward once, and the gradients are those without."""
    calls = {"fwd": 0, "bwd": 0}

    def counted(fn, key):
        def wrapper(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        return wrapper

    monkeypatch.setattr(FA, "flash_block_with_lse_plain",
                        counted(FA.flash_block_with_lse_plain, "fwd"))
    monkeypatch.setattr(FA, "flash_bwd_plain",
                        counted(FA.flash_bwd_plain, "bwd"))
    grads = {}
    for remat in (True, False):
        _, cfg = _configs("float32", remat)
        params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        tokens, targets = (torch.from_numpy(x).long()
                           for x in _batch(cfg, 2, 64))
        calls.update(fwd=0, bwd=0)
        T.loss_fn(params, tokens, targets, cfg,
                  attn_fn=FA.flash_attention).backward()
        assert calls == {"fwd": (1 + remat) * cfg.n_layers,
                         "bwd": cfg.n_layers}
        grads[remat] = convert.grads_to_numpy(params)
    for a, b in zip(jax.tree_util.tree_leaves(grads[True]),
                    jax.tree_util.tree_leaves(grads[False])):
        assert np.array_equal(a, b)
    # Under inference mode remat does nothing: one forward per layer.
    calls.update(fwd=0, bwd=0)
    with torch.inference_mode():
        M.forward(params, tokens, _configs("float32", True)[1],
                  attn_fn=FA.flash_attention)
    assert calls == {"fwd": cfg.n_layers, "bwd": 0}


def test_adamw_steps_match_optax():
    """Three AdamW updates from the same params and grads, fp32."""
    rng = np.random.default_rng(3)
    params = {"w": rng.standard_normal((16, 8)).astype(np.float32),
              "b": rng.standard_normal(8).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    opt = JT.make_optimizer()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    topt = T.make_optimizer()(tp.values())
    for g in grads:
        updates, state = opt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                    state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
    for k, p in tp.items():
        # fp32 elementwise updates: a few ulps of O(1) weights apart.
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("attn", ["default", "flash"])
def test_train_step_decreases_loss(attn):
    """Twin of the JAX package's single-device train-step test."""
    cfg = M.ModelConfig().tiny()
    init_fn, step, place = T.make_train_step(
        cfg, attn_fn=FA.flash_attention if attn == "flash" else None,
        device="cpu")
    tokens, targets = (torch.from_numpy(x).long() for x in _batch(cfg, 4, 32))
    tokens, targets = place(tokens, targets)
    params, opt = init_fn(torch.Generator().manual_seed(0), tokens)
    losses = []
    for _ in range(5):
        params, opt, loss = step(params, opt, tokens, targets)
        assert loss.grad_fn is None and loss.dim() == 0
        losses.append(loss.item())
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_make_forward_fn_is_the_model_forward():
    cfg = M.ModelConfig().tiny()
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.from_numpy(_batch(cfg, 2, 16)[0]).long()
    logits = T.make_forward_fn(cfg, device="cpu")(params, tokens)
    assert logits.dtype == torch.float32 and not logits.requires_grad
    with torch.inference_mode():
        assert torch.equal(logits, M.forward(params, tokens, cfg))


def test_make_train_step_refusals():
    cfg = M.ModelConfig().tiny()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.make_train_step(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        T.make_train_step(cfg, device="cpu", mesh=object())
    # The reference's positional form reaches the mesh check.
    with pytest.raises(NotImplementedError, match="not ported"):
        T.make_train_step(cfg, object(), device="cpu")
    with pytest.raises(NotImplementedError, match="not ported"):
        T.make_train_step(cfg, object(), device="cpu", attention="ring")
    # Without a mesh, as in the reference, a strategy picks nothing.
    for attention in ("ring", "ulysses"):
        T.make_train_step(cfg, device="cpu", attention=attention)


@pytest.mark.parametrize("kw,match", [
    ({"attention": "striped"}, "unknown attention strategy"),
    ({"attention": "ring", "use_ring_attention": False},
     "use_ring_attention=False"),
])
def test_make_train_step_validates_attention_as_jax(kw, match):
    cfg = M.ModelConfig().tiny()
    with pytest.raises(ValueError, match=match):
        JT.make_train_step(JM.ModelConfig().tiny(), **kw)
    with pytest.raises(ValueError, match=match):
        T.make_train_step(cfg, device="cpu", **kw)


def test_make_train_step_has_the_reference_signature():
    import inspect
    ref = list(inspect.signature(JT.make_train_step).parameters)
    ours = inspect.signature(T.make_train_step).parameters
    assert list(ours)[:5] == ref[:5] == [
        "cfg", "mesh", "optimizer", "use_ring_attention", "attention"]
    for name in ref:
        assert ours[name].default == inspect.signature(
            JT.make_train_step).parameters[name].default
    assert ours["device"].kind is inspect.Parameter.KEYWORD_ONLY


def test_make_train_step_positional_none_mesh_trains():
    """``make_train_step(cfg, None)``, as the JAX package's tenants call
    it, with ``use_ring_attention=True`` (its default) spelled out."""
    cfg = M.ModelConfig().tiny()
    init_fn, step, place = T.make_train_step(cfg, None, None, True,
                                             device="cpu")
    tokens, targets = place(*(torch.from_numpy(x).long()
                              for x in _batch(cfg, 2, 32)))
    params, opt = init_fn(torch.Generator().manual_seed(0), tokens)
    losses = [step(params, opt, tokens, targets)[2].item()
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def test_grads_to_numpy_needs_a_backward():
    cfg = M.ModelConfig().tiny()
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="embed has no gradient"):
        convert.grads_to_numpy(params)
