"""AdamW's state where a compiled step reads it: ``opt_state_from_jax``,
``pipeline_opt_state_from_jax`` and a Checkpointer restore put ``step``
in fp32 where its parameter is (as a capturable AdamW keeps it) and, into
an optimizer that already holds state, copy into the tensors it holds:
``graphs`` keys a compiled step on those tensors' addresses, so a restore
that replaced them would make the next step miss and capture again. On
the CPU, against the JAX package's optax state."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.workload import model as JM
from tpushare.workload import train as JT
from tpushare_torch.workload import checkpoint as CK
from tpushare_torch.workload import convert
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as P
from tpushare_torch.workload import train as T


@pytest.fixture(scope="module")
def tiny():
    jcfg = dataclasses.replace(JM.ModelConfig().tiny(), dtype=jnp.float32)
    tcfg = dataclasses.replace(M.ModelConfig().tiny(), dtype=torch.float32)
    jparams = jax.tree_util.tree_map(
        np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg))
    return jcfg, tcfg, jparams


def _optax_state(params, count, seed):
    """optax adamw's state over ``params`` at ``count`` with moments drawn
    from ``seed`` (numpy leaves)."""
    state = JT.make_optimizer().init(params)
    rng = np.random.default_rng(seed)
    adam = state[0]
    mu, nu = (jax.tree_util.tree_map(
        lambda x: rng.standard_normal(np.shape(x)).astype(np.float32) ** p,
        tree) for tree, p in ((adam.mu, 1), (adam.nu, 2)))
    return jax.tree_util.tree_map(np.asarray, (adam._replace(
        count=jnp.asarray(count, jnp.int32), mu=mu, nu=nu), *state[1:]))


def _held(opt):
    """(param, key) -> the tensor the optimizer holds."""
    return {(id(p), k): t for p, st in opt.state.items()
            for k, t in st.items()}


def _check_placed(opt, count):
    for p, st in opt.state.items():
        assert st["step"].device == p.device
        assert st["step"].dtype == torch.float32
        assert float(st["step"]) == count
        assert st["exp_avg"].device == p.device


@pytest.mark.parametrize("capturable", [True, False])
def test_opt_state_from_jax_copies_into_held_state(tiny, capturable):
    jcfg, tcfg, jparams = tiny
    params = convert.params_from_jax(jparams, tcfg, "cpu")
    opt = T.make_optimizer()(params.parameters(), capturable=capturable)
    convert.opt_state_from_jax(_optax_state(jparams, 3, 0), params, opt)
    _check_placed(opt, 3)
    held = _held(opt)
    state = _optax_state(jparams, 7, 1)
    convert.opt_state_from_jax(state, params, opt)
    _check_placed(opt, 7)
    again = _held(opt)
    assert all(again[k] is t for k, t in held.items())
    mu = state[0].mu
    assert np.array_equal(
        opt.state[params.embed]["exp_avg"].numpy(), mu["embed"])


@pytest.mark.parametrize("capturable", [True, False])
def test_pipeline_opt_state_from_jax_copies_into_held_state(tiny,
                                                            capturable):
    _, tcfg, jparams = tiny
    blocks = [{k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
              for b in jparams["blocks"]]
    mesh = par.Mesh(1, 1, 1, 0, {})
    stage = P.flagship_stage(blocks)
    edge = P.flagship_edge(torch.from_numpy(jparams["embed"]),
                           torch.from_numpy(jparams["final_norm"]))
    stacked = {k: np.stack([np.asarray(b[k]) for b in jparams["blocks"]])[
        None] for k in jparams["blocks"][0]}
    tree = (stacked, {"embed": jparams["embed"],
                      "final_norm": jparams["final_norm"]})
    opt = T.make_optimizer()([*stage.parameters(), *edge.parameters()],
                             capturable=capturable)
    convert.pipeline_opt_state_from_jax(_optax_state(tree, 2, 0), stage,
                                        edge, opt, mesh, "pp")
    _check_placed(opt, 2)
    held = _held(opt)
    state = _optax_state(tree, 5, 1)
    convert.pipeline_opt_state_from_jax(state, stage, edge, opt, mesh, "pp")
    _check_placed(opt, 5)
    assert all(_held(opt)[k] is t for k, t in held.items())
    assert np.array_equal(opt.state[edge["embed"]]["exp_avg_sq"].numpy(),
                          state[0].nu[1]["embed"])


def test_checkpointer_restore_copies_into_held_state(tiny, tmp_path):
    """A step, a save, another step, a restore: the optimizer holds the
    same tensors throughout, with the saved values and count, and the
    weights are the saved ones."""
    _, tcfg, jparams = tiny
    init_fn, step, _ = T.make_train_step(tcfg, device="cpu")
    tokens = torch.randint(0, tcfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(0))
    targets = torch.roll(tokens, -1, dims=1)
    params, opt = init_fn(torch.Generator().manual_seed(0), tokens)
    step(params, opt, tokens, targets)
    ckpt = CK.Checkpointer(CK.CheckpointConfig(str(tmp_path)))
    ckpt.save(1, params, opt, force=True)
    ckpt.wait()
    saved = {k: t.clone() for k, t in _held(opt).items()}
    weights = [p.detach().clone() for p in params.parameters()]
    held = _held(opt)
    step(params, opt, tokens, targets)
    assert ckpt.restore(params, opt)[2] == 1
    ckpt.close()
    _check_placed(opt, 1)
    after = _held(opt)
    assert all(after[k] is t and torch.equal(t, saved[k])
               for k, t in held.items())
    assert all(torch.equal(p, w) for p, w in zip(params.parameters(),
                                                 weights))
