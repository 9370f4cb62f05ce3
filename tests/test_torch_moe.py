"""The port's ring-MoE against the JAX package's: each case of
``tests/test_moe.py`` (the ring at E = 8 and 16 over sp = 8, its
gradients, the experts actually sharded) on the same numpy inputs and
weights, at that test's fp32 tolerances.

The port's side runs in one gang of 8 gloo ranks on the CPU
(``tests/torch_pipeline_rank.py moe``, started once for the module); the
JAX side runs meanwhile on the conftest's 8-device CPU mesh, as
``tests/test_moe.py`` runs it, in a subprocess of this module at the
lowest priority."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests import torch_pipeline_rank as R
from tpushare.workload import moe as jmoe
from tpushare.workload.parallel import make_mesh as jmake_mesh
from tpushare_torch.workload import convert
from tpushare_torch.workload import moe
from tpushare_torch.workload import parallel as par

#: tests/test_moe.py's fp32 tolerances: output, and gradients.
OUT_TOL, GRAD_TOL = 2e-5, 5e-5


def _params(n_experts):
    """The JAX package's init tree at seed 0, as numpy."""
    tree = jmoe.init_moe_params(jax.random.PRNGKey(0), R.MOE_D, R.MOE_F,
                                n_experts)
    return {k: np.asarray(v, np.float32) for k, v in tree.items()}


def _x():
    return np.random.default_rng(1).standard_normal(
        (2, 16, R.MOE_D)).astype(np.float32)


def save_references(path):
    """JAX's ring outputs and gradients on the gang's inputs, pickled to
    ``path``: run by :func:`runs` in a subprocess at the lowest
    priority."""
    x = jnp.asarray(_x())
    mesh = jmake_mesh(dp=1, tp=1, sp=8)
    fn = jmoe.make_ring_moe_fn(mesh, axis_name="sp")
    refs = {}
    with mesh:
        for e in R.MOE_EXPERTS:
            placed = jmoe.place_moe_params(
                {k: jnp.asarray(v) for k, v in _params(e).items()}, mesh)
            refs[f"e{e}/y"] = np.asarray(jax.jit(fn)(placed, x))
            if e == 8:
                grads = jax.jit(jax.grad(
                    lambda p: jnp.sum(fn(p, x) ** 2)))(placed)
                for k, g in grads.items():
                    refs[f"e8/grad/{k}"] = np.asarray(g)
    with open(path, "wb") as f:
        pickle.dump(refs, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gang's (rank records, rank 0's arrays) and the JAX package's
    references, made side by side at the lowest priority."""
    inputs = {"x": _x()}
    for e in R.MOE_EXPERTS:
        for k, v in _params(e).items():
            inputs[f"e{e}/{k}"] = v
    return R.run_module("moe", "test_torch_moe",
                        tmp_path_factory.mktemp("moe"), inputs)


@pytest.mark.parametrize("n_experts", R.MOE_EXPERTS)
def test_ring_matches_jax(runs, n_experts):
    _, got, refs = runs
    key = f"e{n_experts}/y"
    np.testing.assert_allclose(got[key], refs[key], rtol=OUT_TOL,
                               atol=OUT_TOL)


@pytest.mark.parametrize("name", ["router", "w1", "w2"])
def test_ring_gradients_match_jax(runs, name):
    """Gradients of sum(y²): the router's all-reduced over the ring, each
    expert's carried home by the shift's backward."""
    _, got, refs = runs
    key = f"e8/grad/{name}"
    np.testing.assert_allclose(got[key], refs[key], rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def test_expert_weights_actually_sharded(runs):
    """The EP memory win: each rank holds E/n experts, not E."""
    for rec in runs[0]:
        assert rec["shards"]["8"] == {"router": [R.MOE_D, 8],
                                      "w1": [1, R.MOE_D, R.MOE_F],
                                      "w2": [1, R.MOE_F, R.MOE_D]}
        assert rec["shards"]["16"]["w1"] == [2, R.MOE_D, R.MOE_F]


def test_place_keeps_this_ranks_experts():
    params = convert.moe_params_from_jax(_params(16), device="cpu")
    for rank in range(8):
        mesh = par.Mesh(1, 1, 8, rank, groups={})
        shard = moe.place_moe_params(params, mesh, "sp")
        assert torch.equal(shard["w1"], params["w1"][2 * rank:2 * rank + 2])
        assert torch.equal(shard["w2"], params["w2"][2 * rank:2 * rank + 2])
        assert torch.equal(shard["router"], params["router"])
    with pytest.raises(ValueError, match="do not split"):
        moe.place_moe_params(params, par.Mesh(1, 1, 3, 0, groups={}), "sp")


def test_reference_matches_jax():
    params = _params(8)
    x = _x()
    want = jmoe.moe_ffn_reference({k: jnp.asarray(v) for k, v in
                                   params.items()}, jnp.asarray(x))
    got = moe.moe_ffn_reference(convert.moe_params_from_jax(params, "cpu"),
                                torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=OUT_TOL,
                               atol=OUT_TOL)


def test_gelu_with_erf_fails_the_parity_bound(runs, monkeypatch):
    """jax.nn.gelu is the tanh form: the port's ring with torch's default
    (erf) gelu, on the gang's inputs, departs from JAX's ring by more
    than the parity cases allow, so they would catch it."""
    _, _, refs = runs
    erf = F.gelu
    monkeypatch.setattr(moe.F, "gelu", lambda h, approximate="none": erf(h))
    params = convert.moe_params_from_jax(_params(8), "cpu")
    got = moe.moe_ffn_reference(params, torch.from_numpy(_x())).numpy()
    assert not np.allclose(got, refs["e8/y"], rtol=OUT_TOL, atol=OUT_TOL)
