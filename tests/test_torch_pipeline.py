"""The port's pipeline against the JAX package's: the GPipe forward, the
flagship 1F1B pipe (over sp, dp x pp, dp x tp x pp, the kernels' code path
in the stages, the sp ring and the sp flash ring in the stages, 4D), each
case of ``tests/test_pipeline.py`` on the same numpy inputs and the JAX
package's weights, held to the JAX function at that test's fp32
tolerances.

The port's side runs in one gang of 8 gloo ranks on the CPU
(``tests/torch_pipeline_rank.py``, started once for the module by
``tpushare_torch.runtime.launch``); the JAX side runs meanwhile on the
conftest's 8-device CPU mesh, as ``tests/test_pipeline.py`` runs it (the
flash kernel in interpret mode), in a subprocess of this module at the
lowest priority, as the gang's ranks run."""

import os
import pickle
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import Mesh as JMesh

from tests import torch_pipeline_rank as R
from tpushare.workload import flash_attention as JFA
from tpushare.workload import model as JM
from tpushare.workload import pipeline as jpp
from tpushare.workload.parallel import make_mesh as jmake_mesh
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as P

HERE = os.path.dirname(os.path.abspath(__file__))
#: The JAX tests' own fp32 tolerances: forwards, loss (relative) and
#: gradients; the tp and kernel/sp cases' looser ones.
FWD_TOL = 2e-5
LOSS_RTOL = {"default": 1e-5, "kernel_sp": 1e-4}
GRAD_TOL = {"default": (2e-4, 2e-5), "tp": (3e-4, 3e-5),
            "kernel_sp": (3e-4, 3e-5)}
#: Which of them each fp32 flagship case takes (tests/test_pipeline.py).
CASE_TOL = {"1f1b_2x4": "default", "1f1b_4x8": "default",
            "1f1b_2x8": "default", "dp2_pp4": "default",
            "dp2_tp2_pp2": "tp", "flash_in_stages": "kernel_sp",
            "sp_ring": "kernel_sp", "sp_flash_ring": "kernel_sp",
            "4d": "kernel_sp"}
#: bf16 pipes against JAX's bf16 pipe: the loss at ROADMAP's bf16 rule
#: (2e-2 relative), every gradient normalized (max |diff| / max |ref|) at
#: the bound the card holds a bf16 step's gradients to (chip_smoke.py's
#: TRAIN_GRAD_TOL). JAX sums each microbatch's bf16 gradient in bf16, the
#: port in fp32, and the two round at other places; the largest departure
#: on these inputs is about 3.1e-2, the embedding's at (2, 4).
BF16_LOSS_RTOL, BF16_GRAD_TOL = 2e-2, 4e-2
#: Tokens of each flagship case: numpy's generator of this seed.
TOKEN_SEED = 3


def _jax_cfg(case):
    return JM.ModelConfig(**{**R.CFG, **case.get("cfg", {})},
                          dtype=jnp.bfloat16 if case.get("bf16")
                          else jnp.float32, remat=False)


def _jax_mesh(name, case):
    """The mesh tests/test_pipeline.py gives the case: a (1, 1, n) mesh
    for a pipe over sp."""
    devices = np.array(jax.devices())
    if case["axis"] == "sp":
        return jmake_mesh(dp=1, tp=1, sp=case["mesh"][2])
    shapes = {"dp2_pp4": ((2, 4), ("dp", "pp")),
              "dp2_tp2_pp2": ((2, 2, 2), ("dp", "tp", "pp")),
              "flash_in_stages": ((2,), ("pp",)),
              "sp_ring": ((4, 2), ("sp", "pp")),
              "sp_flash_ring": ((2, 2), ("sp", "pp")),
              "4d": ((1, 2, 2, 2), ("dp", "tp", "sp", "pp")),
              "bf16_4d": ((1, 2, 2, 2), ("dp", "tp", "sp", "pp"))}
    shape, names = shapes[name]
    return JMesh(devices[:int(np.prod(shape))].reshape(shape), names)


def _jax_pipe(name, case):
    kw = dict(case.get("kw", {}))
    if case.get("flash"):
        kw["attn_fn"] = partial(JFA.flash_attention, interpret=True)
    if kw.get("sp_flash"):
        kw["interpret"] = True
    mesh = _jax_mesh(name, case)
    init_fn, train_fn = jpp.make_flagship_pipeline(
        _jax_cfg(case), mesh, axis_name=case["axis"],
        n_microbatches=case["m"], **kw)
    return mesh, init_fn, train_fn


def _tokens(case):
    cfg = _jax_cfg(case)
    rng = np.random.default_rng(TOKEN_SEED)
    return rng.integers(0, cfg.vocab_size,
                        (case["batch"], cfg.max_seq_len)).astype(np.int32)


def _gpipe_data(n):
    rng = np.random.default_rng(n)
    return {"w": (rng.standard_normal((n, R.D, R.D)) / R.D ** 0.5
                  ).astype(np.float32),
            "b": (rng.standard_normal((n, R.D)) * 0.01).astype(np.float32)}


def _gpipe_x():
    return np.random.default_rng(0).standard_normal((8, R.D)).astype(
        np.float32)


def _jax_stage(params, x):
    return jax.nn.gelu(x @ params["w"] + params["b"])


def _jax_weights(name, case):
    mesh, init_fn, _ = _jax_pipe(name, case)
    with mesh:
        return init_fn(jax.random.PRNGKey(0))


def _inputs():
    """The gang's inputs: the toy stages and stream, and each flagship
    case's JAX weights and tokens."""
    inputs = {"gpipe/x": _gpipe_x()}
    for n in {n for n, _ in R.GPIPE_CASES}:
        for k, v in _gpipe_data(n).items():
            inputs[f"gpipe/{n}/{k}"] = v
    for name, case in R.FLAGSHIP_CASES.items():
        stacked, edge = _jax_weights(name, case)
        for k, v in stacked.items():
            inputs[f"{name}/stacked/{k}"] = np.asarray(v, np.float32)
        for k, v in edge.items():
            inputs[f"{name}/edge/{k}"] = np.asarray(v, np.float32)
        inputs[f"{name}/tokens"] = _tokens(case)
    return inputs


def save_references(path):
    """JAX's GPipe outputs and flagship pipes' losses and gradients on the
    gang's inputs, pickled to ``path``: run by :func:`runs` in a
    subprocess at the lowest priority."""
    refs = {}
    x = jnp.asarray(_gpipe_x())
    for n, m in R.GPIPE_CASES:
        stacked = {k: jnp.asarray(v) for k, v in _gpipe_data(n).items()}
        mesh = jmake_mesh(dp=1, tp=1, sp=n)
        fn = jpp.make_pipeline_fn(_jax_stage, mesh, axis_name="sp",
                                  n_microbatches=m)
        with mesh:
            placed = jpp.place_pipeline_params(stacked, mesh, axis_name="sp")
            refs[f"gpipe/{n}x{m}"] = np.asarray(jax.jit(fn)(placed, x))
    for name, case in R.FLAGSHIP_CASES.items():
        mesh, _, train_fn = _jax_pipe(name, case)
        weights = _jax_weights(name, case)
        tokens = jnp.asarray(_tokens(case))
        targets = jnp.roll(tokens, -1, axis=1)
        with mesh:
            loss, g_stacked, g_edge = jax.jit(train_fn)(*weights, tokens,
                                                        targets)
        refs[f"{name}/loss"] = float(loss)
        for k, g in {**g_stacked, **g_edge}.items():
            refs[f"{name}/grad/{k}"] = np.asarray(g, np.float32)
    with open(path, "wb") as f:
        pickle.dump(refs, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gang's (rank records, rank 0's arrays) and the JAX package's
    references, made side by side at the lowest priority."""
    return R.run_module("pipeline", "test_torch_pipeline",
                        tmp_path_factory.mktemp("pipe"), _inputs())


@pytest.mark.parametrize("n_stages,n_micro", R.GPIPE_CASES)
def test_pipeline_matches_jax(runs, n_stages, n_micro):
    """The GPipe forward's staged result [n, M, mb, D]: the last stage's
    slice against JAX's, and zeros on every other stage, as JAX's."""
    _, got, refs = runs
    key = f"gpipe/{n_stages}x{n_micro}"
    np.testing.assert_allclose(got[key], refs[key], rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(
        P.last_stage_output(torch.from_numpy(got[key][-1])).numpy(),
        np.asarray(jpp.last_stage_output(jnp.asarray(refs[key]))),
        rtol=FWD_TOL, atol=FWD_TOL)


def test_pipeline_output_stays_on_last_stage(runs):
    _, got, _ = runs
    staged = got["gpipe/4x4"]
    assert staged.shape[0] == 4
    for s in range(3):
        assert np.abs(staged[s]).max() == 0.0
    assert np.abs(staged[3]).max() > 0.0


def test_pipeline_input_not_replicated():
    """Each rank's share of the stream holds M/n microbatches: microbatch
    i at [i % n, i // n], zero-padded, as JAX's ``_stream_shard``."""
    for m in (8, 6):
        x = np.arange(float(m)).reshape(m, 1)
        got = P._stream_shard(torch.from_numpy(x), 4).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jpp._stream_shard(jnp.asarray(x), 4)))
        assert got.shape == (4, 2, 1)
    assert got[2, 1, 0] == 0.0          # the padded slot


def _fake_mesh(dp, tp, sp, pp=1, rank=0):
    """A mesh for code that reads only the shape and coordinates."""
    return par.Mesh(dp, tp, sp, rank, groups={}, pp=pp)


def test_stage_count_must_match_axis_size():
    """4 stages on a 2-rank axis would silently drop stages 1 and 3."""
    stacked = {k: torch.from_numpy(v) for k, v in _gpipe_data(4).items()}
    with pytest.raises(ValueError, match="exactly 2 stages"):
        P.place_pipeline_params(stacked, _fake_mesh(4, 1, 2), "sp")


def test_stage_params_actually_sharded():
    """Rank s holds stage s's parameters and no other."""
    stacked = {k: torch.from_numpy(v) for k, v in _gpipe_data(4).items()}
    for rank in range(4):
        stage = P.place_pipeline_params(stacked, _fake_mesh(1, 1, 4,
                                                            rank=rank), "sp")
        for k, p in stage.items():
            assert torch.equal(p, stacked[k][rank])


def _check_flagship(runs, name):
    _, got, refs = runs
    kind = CASE_TOL[name]
    np.testing.assert_allclose(
        got[f"{name}/loss"], refs[f"{name}/loss"],
        rtol=LOSS_RTOL["kernel_sp" if kind == "kernel_sp" else "default"])
    rtol, atol = GRAD_TOL[kind]
    keys = [k for k in refs if k.startswith(f"{name}/grad/")]
    assert len(keys) == 9
    for key in keys:
        np.testing.assert_allclose(got[key], refs[key], rtol=rtol,
                                   atol=atol, err_msg=key)


@pytest.mark.parametrize("name", ["1f1b_2x4", "1f1b_4x8", "1f1b_2x8"])
def test_flagship_1f1b_grads_match_jax(runs, name):
    """The 1F1B pipe over sp, (n_stages, M) of the JAX test: mean loss
    and every stacked and edge gradient against JAX's pipe."""
    _check_flagship(runs, name)


def test_1f1b_trains_the_flagship(runs):
    losses = runs[1]["train/losses"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0] * 0.9, losses


def test_activation_stash_bounded_by_stages(runs):
    """Each rank holds at most n stage inputs at once, whatever M: n - r
    on pipe rank r (its microbatches in flight)."""
    records, _, _ = runs
    for rec in records:
        peaks = set(rec["stash_peak"].values())
        assert len(peaks) == 1 and peaks <= {1, 2}, rec["stash_peak"]
    assert {r["stash_peak"]["16"] for r in records} == {1, 2}


def test_dp2_pp4_grads_match_jax(runs):
    _check_flagship(runs, "dp2_pp4")


def test_microbatch_not_divisible_by_dp_refused(runs):
    for rec in runs[0]:
        assert "not divisible by dp" in rec["refused"]["dp_indivisible"]


def test_dp2_tp2_pp2_grads_match_jax(runs):
    """tp really shards the weights (half the heads a rank) and the
    gathered gradients match JAX's."""
    for rec in runs[0]:
        assert rec["wqkv_shard"] == [32, 3, 2, 8]
    _check_flagship(runs, "dp2_tp2_pp2")


def test_tp_indivisible_refused():
    cfg = M.ModelConfig(**{**R.CFG, "n_heads": 3}, dtype=torch.float32)
    with pytest.raises(ValueError, match="divisible"):
        P.make_flagship_pipeline(cfg, _fake_mesh(2, 2, 1, 2), "pp",
                                 tp_axis="tp", device="cpu")


@pytest.mark.parametrize("name", ["flash_in_stages", "sp_ring",
                                  "sp_flash_ring", "4d"])
def test_kernel_and_sp_in_pipe_match_jax(runs, name):
    """The kernels' code path as every stage's attention (JAX: the Pallas
    kernel in interpret mode), the plain sp ring and the sp flash ring in
    the stages, and dp x tp x sp x pp."""
    _check_flagship(runs, name)


@pytest.mark.parametrize("name", ["bf16_2x4", "bf16_4d"])
def test_bf16_pipe_matches_jax(runs, name):
    """The flagship's own dtype through the pipe over sp and the 4D pipe:
    gradients summed over microbatches and rounded to bf16 once."""
    _, got, refs = runs
    want = refs[f"{name}/loss"]
    assert abs(got[f"{name}/loss"] - want) <= BF16_LOSS_RTOL * abs(want)
    keys = [k for k in refs if k.startswith(f"{name}/grad/")]
    assert len(keys) == 9
    for key in keys:
        err = np.abs(got[key] - refs[key]).max() / np.abs(refs[key]).max()
        assert err <= BF16_GRAD_TOL, (key, err)


def test_sp_with_attn_fn_refused():
    cfg = R.case_config({"cfg": {"n_layers": 2}})
    with pytest.raises(ValueError, match="ring"):
        P.make_flagship_pipeline(cfg, _fake_mesh(2, 1, 2, 2), "pp",
                                 sp_axis="sp", attn_fn=lambda q, k, v: q,
                                 device="cpu")


def test_sp_indivisible_sequence_refused(runs):
    for rec in runs[0]:
        assert "not divisible by" in rec["refused"]["sp_indivisible"]


def test_flagship_reference_matches_jax():
    """The port's sequential reference (one process, fp32) against JAX's
    ``flagship_pipeline_reference`` on the same weights and tokens."""
    case = R.FLAGSHIP_CASES["1f1b_2x4"]
    params = JM.init_params(jax.random.PRNGKey(0), _jax_cfg(case))
    stacked = jpp.stack_stage_params(params["blocks"])
    stacked = jax.tree.map(lambda a: a.reshape((1,) + a.shape), stacked)
    edge = {"embed": params["embed"], "final_norm": params["final_norm"]}
    tokens = _tokens(case)
    targets = np.roll(tokens, -1, axis=1)
    want = jpp.flagship_pipeline_reference(_jax_cfg(case), stacked, edge,
                                           jnp.asarray(tokens),
                                           jnp.asarray(targets))
    blocks = [P._block({k: torch.tensor(np.asarray(v[0, i]))
                        for k, v in stacked.items()})
              for i in range(R.CFG["n_layers"])]
    pedge = P.flagship_edge(torch.tensor(np.asarray(edge["embed"])),
                            torch.tensor(np.asarray(edge["final_norm"])))
    got = P.flagship_pipeline_reference(
        R.case_config(case), blocks, pedge,
        torch.from_numpy(tokens).long(), torch.from_numpy(targets).long())
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL[
        "default"])


def test_toy_stage_is_the_reference_stage():
    """The gang's toy stage is the JAX test's (gelu's tanh form)."""
    x = _gpipe_x()
    params = _gpipe_data(2)
    want = jpp.pipeline_reference(_jax_stage, {k: jnp.asarray(v) for k, v
                                               in params.items()},
                                  jnp.asarray(x))
    got = P.pipeline_reference(R._toy_stage, {k: torch.from_numpy(v) for
                                              k, v in params.items()},
                               torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert not np.allclose(
        F.gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), rtol=FWD_TOL, atol=FWD_TOL)


def test_case_configs_are_the_reference_tests():
    """Every case's config, shape and mesh size follow
    tests/test_pipeline.py's, with dp filling the gang's 8 ranks."""
    for name, case in R.FLAGSHIP_CASES.items():
        assert int(np.prod(case["mesh"])) == 8
        mesh = _jax_mesh(name, case)
        axis = case["axis"]
        port_pipe = case["mesh"][par.AXES.index(axis)]
        assert port_pipe == mesh.shape[axis], name
        assert _jax_cfg(case).n_layers == R.case_config(case).n_layers


def test_rank_script_imports_neither_jax_nor_the_conftest():
    """The rank processes stay free of JAX: importing the rank script's
    modules in a fresh interpreter loads no ``jax``."""
    code = ("import runpy, sys\n"
            "runpy.run_path({!r}, run_name='not_main')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpushare', 'conftest', 'tests')]\n"
            "assert not bad, bad\n").format(
                os.path.join(HERE, "torch_pipeline_rank.py"))
    env = {**os.environ, "PYTHONPATH": os.path.dirname(HERE)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
