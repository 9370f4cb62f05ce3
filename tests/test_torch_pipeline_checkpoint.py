"""Checkpoints of a pipeline gang (``tpushare_torch/workload/checkpoint.py``
with ``pipe_axis``) against the JAX package's orbax-backed ``Checkpointer``
on the reference's pipe tree.

A 1F1B flagship pipe's state (its stages, the edge, AdamW over both) is
saved in the reference's stacked layout and restored onto another dp / tp
placement with the same stage count, or whole into one process, as orbax
restores the shape it saved. The gang of 4 gloo ranks on the CPU
(``tests/torch_pipeline_checkpoint_rank.py``, started once for the module
by ``tpushare_torch.runtime.launch``) trains from the JAX package's
initial weights; this process holds its checkpoints to the JAX pipe's
reference step under optax, to the tree orbax writes for the same state,
and restores them itself.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed.checkpoint as dcp
from torch import nn

from tpushare.workload import model as JM
from tpushare.workload import pipeline as JP
from tpushare.workload.checkpoint import CheckpointConfig as JConfig
from tpushare.workload.checkpoint import Checkpointer as JCheckpointer
from tpushare_torch.runtime import launch
from tpushare_torch.workload import checkpoint as CK
from tpushare_torch.workload import convert
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import pipeline as P
from tpushare_torch.workload import train as T

HERE = os.path.dirname(os.path.abspath(__file__))
#: The gang of 4 tiny ranks is done in well under a minute alone; the
#: deadline only turns a hang into a failure.
GANG_DEADLINE_S = 600
#: A step after a restore against the uninterrupted run's, and the port's
#: pipe against the JAX pipe's reference step, fp32: the loss relative,
#: weights and AdamW moments normalized (max |diff| / max |ref|). The same
#: arithmetic summed in another order (microbatches, dp, tp).
NEXT_STEP_TOL = 1e-5
N_STAGES, N_LAYERS, BATCH = 2, 4, (8, 32)
KINDS = ("weight", "exp_avg", "exp_avg_sq")


def _jcfg():
    return dataclasses.replace(JM.ModelConfig().tiny(), dtype=jnp.float32,
                               n_layers=N_LAYERS, remat=False)


def _cfg():
    return dataclasses.replace(M.ModelConfig().tiny(), dtype=torch.float32,
                               n_layers=N_LAYERS, remat=False)


def _batch():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, BATCH).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_pipe_tree(seed=0):
    """The reference's flagship pipe init: (stacked, edge), numpy."""
    params = JM.init_params(jax.random.PRNGKey(seed), _jcfg())
    blocks = JP.stack_stage_params(params["blocks"])
    stacked = {k: np.asarray(a).reshape((N_STAGES, -1) + a.shape[1:])
               for k, a in blocks.items()}
    edge = {k: np.asarray(params[k]) for k in ("embed", "final_norm")}
    return stacked, edge


def _norm_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """(rank records, rank 0's gathered arrays, checkpoint directory)."""
    tmp = tmp_path_factory.mktemp("pipe_ckpt_gang")
    tokens, targets = _batch()
    stacked, edge = _jax_pipe_tree()
    np.savez(tmp / "inputs.npz", tokens=tokens, targets=targets,
             **{f"stacked/{k}": a for k, a in stacked.items()},
             **{f"edge/{k}": a for k, a in edge.items()})
    records = launch.launch(
        [os.path.join(HERE, "torch_pipeline_checkpoint_rank.py"),
         str(tmp / "inputs.npz"), str(tmp), f"file://{tmp / 'rendezvous'}"],
        4, deadline_s=GANG_DEADLINE_S, env={"OMP_NUM_THREADS": "1"})
    return records, dict(np.load(tmp / "out.npz")), tmp


def _keys(got, prefix):
    return {k[len(prefix):] for k in got if k.startswith(prefix)}


def _one_process_target(seed=9, n_layers=N_LAYERS):
    """Every block of the pipe in one process, from weights of another
    seed, and a fresh AdamW over it."""
    params = M.init_params(torch.Generator().manual_seed(seed),
                           dataclasses.replace(_cfg(), n_layers=n_layers),
                           "cpu")
    blocks = [{k: p.detach() for k, p in blk.named_parameters()}
              for blk in params.blocks]
    stage = P.flagship_stage(blocks)
    edge = P.flagship_edge(params.embed.detach(), params.final_norm.detach())
    return stage, edge, T.make_optimizer()([*stage.parameters(),
                                            *edge.parameters()])


def _whole_state(stage, edge, opt) -> dict:
    """A one-process pipe's weights and moments, as the rank script
    gathers them: ``<kind>/<w>`` stacked, ``<kind>/<edge name>``."""
    return {k: t.numpy() for k, t in convert.pipeline_state(
        opt, stage, edge, n_stages=N_STAGES).items() if k != "step"}


def _restore_whole(directory):
    stage, edge, opt = _one_process_target()
    ckpt = CK.Checkpointer(CK.CheckpointConfig(str(directory)),
                           pipe_axis="pp")
    _, _, step = ckpt.restore((stage, edge), opt)
    ckpt.close()
    return stage, edge, opt, step


# --------------------------------------------------------------------------
# Across placements, in one process, against JAX
# --------------------------------------------------------------------------

def test_restore_onto_another_tp_is_bitwise(gang):
    """Saved by a (2, 1, 1, 2) dp x pp gang, restored by a (1, 2, 1, 2)
    tp x pp gang into weights of another seed: every stacked weight, the
    edge, both moments and the step, gathered, bit for bit."""
    records, got, _ = gang
    keys = _keys(got, "a/saved/")
    assert keys == _keys(got, "b/restored/")
    assert {f"{kind}/{w}" for kind in KINDS for w in par.TP_AXIS} <= keys
    for k in keys:
        np.testing.assert_array_equal(got[f"b/restored/{k}"],
                                      got[f"a/saved/{k}"], err_msg=k)
    assert got["a/saved/step"] == 2
    assert all(r["b_restored_step"] == 2 and r["a_latest"] == 2
               for r in records)


def test_next_step_after_a_tp_change_matches_the_uninterrupted_run(gang):
    """Step 3 on (1, 2, 1, 2) after the restore against step 3 of the
    (2, 1, 1, 2) gang that saved: loss, weights and moments within
    NEXT_STEP_TOL."""
    _, got, _ = gang
    want = float(got["a/loss3"])
    assert abs(float(got["b/loss3"]) - want) <= NEXT_STEP_TOL * abs(want)
    for k in _keys(got, "a/after/"):
        if k == "step":
            assert got["b/after/step"] == got["a/after/step"] == 3
            continue
        assert _norm_err(got[f"b/after/{k}"], got[f"a/after/{k}"]) <= (
            NEXT_STEP_TOL), k


def test_the_sp_axis_pipe_round_trips_with_both_stages_written(gang):
    """A pipe over the sp axis of a mesh with no pipe axis (pp = 1), the
    entry's ``pipe`` part: restored bit for bit, and its checkpoint holds
    both stages of every stacked leaf, each once, not one stage taken for
    a replica of the other."""
    records, got, tmp = gang
    keys = _keys(got, "c/saved/")
    assert keys == _keys(got, "c/restored/")
    for k in keys:
        np.testing.assert_array_equal(got[f"c/restored/{k}"],
                                      got[f"c/saved/{k}"], err_msg=k)
    assert all(r["c_restored_step"] == 1 for r in records)
    meta = dcp.FileSystemReader(str(tmp / "c" / "1")).read_metadata()
    for w in par.TP_AXIS:
        md = meta.state_dict_metadata[f"params.0.{w}"]
        assert md.size[0] == N_STAGES
        assert sorted(c.offsets[0] for c in md.chunks) == [0, 1], w
        assert sum(math.prod(c.sizes) for c in md.chunks) == math.prod(
            md.size), w


def test_restore_in_one_process_gives_the_whole_stacked_tree(gang):
    """Saved by the (2, 1, 1, 2) gang, restored by one process with no
    process group into every block of the pipe: the whole stacked tree,
    the edge and both moments bit for bit, and the step."""
    _, got, tmp = gang
    stage, edge, opt, step = _restore_whole(tmp / "a")
    assert step == 2
    whole = _whole_state(stage, edge, opt)
    assert set(whole) == _keys(got, "a/saved/") - {"step"}
    for k, a in whole.items():
        np.testing.assert_array_equal(a, got[f"a/saved/{k}"], err_msg=k)
    assert {float(st["step"]) for st in opt.state.values()} == {2.0}


def _jax_two_steps():
    """Two steps of the reference's flagship pipe function under
    ``optax.adamw(3e-4, weight_decay=0.01)`` on (stacked, edge) from the
    gang's initial weights: (params, optax state, losses)."""
    cfg = _jcfg()
    tokens, targets = (jnp.asarray(x) for x in _batch())
    params = jax.tree_util.tree_map(jnp.asarray, _jax_pipe_tree())
    opt = optax.adamw(3e-4, weight_decay=0.01)
    state = opt.init(params)

    @jax.jit
    def step(params, state):
        loss, grads = jax.value_and_grad(
            lambda p: JP.flagship_pipeline_reference(cfg, *p, tokens,
                                                     targets))(params)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    losses = []
    for _ in range(2):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return params, state, losses


def test_restored_state_matches_jax_after_two_steps(gang):
    """The gang's two steps from the JAX package's initial weights, saved
    and restored whole in one process, against two steps of the
    reference's ``flagship_pipeline_reference`` under optax's AdamW: the
    losses, every weight and both moments within NEXT_STEP_TOL, the count
    equal."""
    _, got, tmp = gang
    jparams, jstate, jlosses = _jax_two_steps()
    np.testing.assert_allclose(got["a/losses"], jlosses, rtol=NEXT_STEP_TOL)
    stage, edge, opt, _ = _restore_whole(tmp / "a")
    whole = _whole_state(stage, edge, opt)
    adam = jstate[0]
    assert int(adam.count) == 2
    for kind, (stacked, ends) in (("weight", jparams), ("exp_avg", adam.mu),
                                  ("exp_avg_sq", adam.nu)):
        for k, ref in {**stacked, **ends}.items():
            assert _norm_err(whole[f"{kind}/{k}"], np.asarray(ref)) <= (
                NEXT_STEP_TOL), (kind, k)


def _orbax_layout(tmp_path) -> dict:
    """{leaf path: global shape} of what the reference's orbax
    ``Checkpointer`` writes for a pipe's (stacked, edge) and its optax
    AdamW state, paths joined by '.' under ``params`` and ``opt_state``
    as the items it writes."""
    params = jax.tree_util.tree_map(jnp.asarray, _jax_pipe_tree())
    state = optax.adamw(3e-4, weight_decay=0.01).init(params)
    ckpt = JCheckpointer(JConfig(str(tmp_path / "orbax")))
    ckpt.save(1, params, state, force=True, wait=True)
    meta = ckpt._mgr.item_metadata(1)
    ckpt.close()

    def part(entry):
        return str(getattr(entry, "key", getattr(entry, "idx",
                                                 getattr(entry, "name", ""))))

    return {".".join([item, *map(part, path)]): tuple(leaf.shape)
            for item in ("params", "opt_state")
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                meta[item])[0]}


def test_layout_matches_the_reference_orbax_checkpointer(gang, tmp_path):
    """The gang's checkpoint holds the leaves orbax writes for the same
    pipe state, at the same paths and global shapes: ``params.0.<w>``
    [n_stages, per_stage, ...], ``params.1.<edge name>``,
    ``opt_state.0.count``, ``opt_state.0.{mu,nu}.{0,1}.<name>``."""
    _, _, tmp = gang
    want = _orbax_layout(tmp_path)
    meta = dcp.FileSystemReader(str(tmp / "a" / "2")).read_metadata()
    got = {k: tuple(md.size) for k, md in meta.state_dict_metadata.items()}
    assert got == want
    assert want["params.0.wqkv"][:2] == (N_STAGES, N_LAYERS // N_STAGES)


def test_a_gang_writes_each_stage_once(gang):
    """The (2, 1, 1, 2) checkpoint holds each stacked leaf as one chunk a
    stage (the dp replicas written once) and each edge tensor as one."""
    records, _, tmp = gang
    meta = dcp.FileSystemReader(str(tmp / "a" / "2")).read_metadata()
    for key, md in meta.state_dict_metadata.items():
        if not hasattr(md, "chunks") or not md.size:
            continue
        stacked = ".0." in key[len("opt_state.0."):] or key.startswith(
            "params.0.")
        assert len(md.chunks) == (N_STAGES if stacked else 1), key
        assert sum(math.prod(c.sizes) for c in md.chunks) == math.prod(
            md.size), key
    stats = records[0]["a_stats"]
    assert stats["step"] == 2 and stats["bytes"] > 0
    assert stats["durable_s"] >= stats["blocked_s"] > 0


def test_the_gang_built_the_4d_host_mesh(gang):
    """``host_device_mesh`` of a pipe's mesh: (dp, tp, sp, pp), row-major
    as ``make_mesh`` fills it; of a mesh without a pipe axis: (dp, tp,
    sp)."""
    records, _, _ = gang
    for r in records:
        assert r["host_meshes"]["a"] == [["dp", "tp", "sp", "pp"],
                                         [2, 1, 1, 2]]
        assert r["host_meshes"]["c"] == [["dp", "tp", "sp"], [2, 1, 2]]


# --------------------------------------------------------------------------
# Refusals
# --------------------------------------------------------------------------

def _no_load(monkeypatch):
    def load(*_, **__):
        raise AssertionError("dcp.load was called")

    monkeypatch.setattr(CK.dcp, "load", load)


def test_a_target_of_another_stage_count_is_refused_before_load(gang):
    """A (1, 1, 1, 4) gang of four stages restoring the (2, 1, 1, 2)
    gang's checkpoint raises ``ValueError`` naming both counts on every
    rank, and ``dcp.load`` is never called."""
    records, _, _ = gang
    for r in records:
        assert "a pipe of 2 stages, the target has 4" in r["d_refused"]
        assert r["d_loads"] == 0


@pytest.mark.parametrize("n_layers,match", [
    (3, "3 blocks do not split into 2 stages"),
    (6, r"params\.0\.\w+: saved \(2, 2, .*target \(2, 3, ")])
def test_a_one_process_target_of_other_blocks_is_refused_before_load(
        gang, monkeypatch, n_layers, match):
    """One process takes the checkpoint's stage count; a stage of blocks
    that do not split into it, or split into stages of another depth,
    raises ``ValueError`` before ``dcp.load``."""
    _, _, tmp = gang
    _no_load(monkeypatch)
    stage, edge, opt = _one_process_target(n_layers=n_layers)
    ckpt = CK.Checkpointer(CK.CheckpointConfig(str(tmp / "a")),
                           pipe_axis="pp")
    with pytest.raises(ValueError, match=match):
        ckpt.restore((stage, edge), opt)


def test_one_process_does_not_save_a_pipe(tmp_path):
    """A pipe is saved by its gang: one process holds no stage count, and
    its save raises ``ValueError`` with nothing written."""
    stage, edge, opt = _one_process_target()
    ckpt = CK.Checkpointer(CK.CheckpointConfig(str(tmp_path / "p")),
                           pipe_axis="pp")
    with pytest.raises(ValueError, match="saved by its gang"):
        ckpt.save(1, (stage, edge), opt)
    assert os.listdir(tmp_path / "p") == []


def test_the_transformer_path_refuses_a_stage(gang, tmp_path, monkeypatch):
    """A stage given where a Checkpointer without a pipe takes a
    ``Transformer`` raises ``TypeError``, on save and on restore, before
    anything is written; a pipe's Checkpointer refuses what is not its
    (stage, edge) pair before ``dcp.load``."""
    _, _, tmp = gang
    stage, edge, opt = _one_process_target()
    ckpt = CK.Checkpointer(CK.CheckpointConfig(str(tmp_path / "t")))
    with pytest.raises(TypeError, match="Transformer"):
        ckpt.save(1, stage, opt)
    with pytest.raises(TypeError, match="Transformer"):
        ckpt.save(1, (stage, edge), opt)
    assert os.listdir(tmp_path / "t") == []
    _no_load(monkeypatch)
    ckpt = CK.Checkpointer(CK.CheckpointConfig(str(tmp / "a")),
                           pipe_axis="pp")
    with pytest.raises(TypeError, match="pair"):
        ckpt.restore(stage, opt)


def test_tp_axis_takes_a_pipe_axis():
    """``tp_axis`` is the axis a pipe's stages are split over: without
    ``pipe_axis`` it would be dropped unused, so it is refused."""
    with pytest.raises(ValueError, match="takes pipe_axis"):
        CK.Checkpointer(CK.CheckpointConfig("unused"), tp_axis="tp")


# --------------------------------------------------------------------------
# The entry's pipe parts
# --------------------------------------------------------------------------

def test_entry_pipe_part_resumes_bit_identically(gang):
    """``python -m tpushare_torch.entry --parts dp_pp --ckpt-dir D
    --ckpt-every 2`` trains 3 calls with AdamW and an async save after
    call 2; a fresh gang with ``--resume`` restores step 2 and takes step
    3: the same loss, bit for bit, on every rank."""
    records, _, _ = gang
    for rec in records:
        saved, resumed = rec["entry_save"], rec["entry_resume"]
        assert saved["steps"] == [1, 2, 3] and resumed["steps"] == [3]
        assert saved["checkpoint"]["saved_steps"] == [2]
        assert resumed["checkpoint"]["restored_step"] == 2
        assert resumed["losses"] == saved["losses"][2:]
        assert len(set(saved["losses"])) == 3      # the weights moved
        assert saved["checkpoint"]["save_blocked_ms"][0] > 0


# --------------------------------------------------------------------------
# The stacked layout and the optimizer state carried over
# --------------------------------------------------------------------------

def test_stack_stage_params_matches_the_reference():
    """Per-stage trees stacked on a leading axis, nested dicts alike."""
    rng = np.random.default_rng(2)
    per = [{"a": rng.standard_normal((3, 2)).astype(np.float32),
            "b": {"c": rng.standard_normal(4).astype(np.float32)}}
           for _ in range(3)]
    want = JP.stack_stage_params([jax.tree_util.tree_map(jnp.asarray, t)
                                  for t in per])
    got = P.stack_stage_params([{"a": torch.from_numpy(t["a"]),
                                 "b": {"c": torch.from_numpy(t["b"]["c"])}}
                                for t in per])
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["b"]["c"].numpy(),
                                  np.asarray(want["b"]["c"]))


def test_stage_tree_and_stage_blocks_invert_each_other():
    """Stage parameter ``"{i}.{w}"`` of a stage of every block sits at
    ``[i // per_stage, i % per_stage]``; ``stage_blocks`` gives back the
    blocks in order, and a rank's stage is its row."""
    stacked, _ = _jax_pipe_tree()
    tree = {k: torch.tensor(a) for k, a in stacked.items()}
    stage = P.flagship_stage(P.stage_blocks(tree))
    assert len(stage) == N_LAYERS
    back = P.stage_tree(stage, N_STAGES)
    for k, a in tree.items():
        assert torch.equal(back[k], a)
    np.testing.assert_array_equal(stage[3].wo.detach().numpy(),
                                  stacked["wo"][1, 1])
    row = P.stage_tree(stage[2:], 1)
    assert torch.equal(row["wqkv"][0], tree["wqkv"][1])
    with pytest.raises(ValueError, match="do not split"):
        P.stage_tree(stage, 3)


@pytest.mark.parametrize("tp", [1, 2])
def test_pipeline_opt_state_from_jax_matches_optax(tp):
    """optax's AdamW state over (stacked, edge) after a step, carried into
    each rank of a (1, tp, 1, 2) pipe: every parameter's step is the
    count and its moments are its stage's, tp shard's mu and nu, bit for
    bit; a pipe of another stage count is refused."""
    params = jax.tree_util.tree_map(jnp.asarray, _jax_pipe_tree())
    opt = optax.adamw(3e-4, weight_decay=0.01)
    state = opt.init(params)
    grads = jax.tree_util.tree_map(lambda a: jnp.sin(a) + 0.5, params)
    _, state = opt.update(grads, state, params)
    np_state = jax.tree_util.tree_map(np.asarray, state)
    stacked, edge = jax.tree_util.tree_map(np.asarray, params)
    tp_axis = "tp" if tp > 1 else None
    for rank in range(2 * tp):
        mesh = par.Mesh(1, tp, 1, rank, {}, pp=2)
        stage, p_edge = convert.pipeline_params_from_jax(
            stacked, edge, mesh, "pp", tp_axis, device="cpu")
        optimizer = T.make_optimizer()([*stage.parameters(),
                                        *p_edge.parameters()])
        assert convert.pipeline_opt_state_from_jax(
            np_state, stage, p_edge, optimizer, mesh, "pp",
            tp_axis) is optimizer
        module = nn.ModuleDict({"stage": stage, "edge": p_edge})
        for key, moments in (("exp_avg", np_state[0].mu),
                             ("exp_avg_sq", np_state[0].nu)):
            m_stacked, m_edge = moments
            for fqn, p in module.named_parameters():
                st = optimizer.state[p]
                assert float(st["step"]) == 1.0
                part, _, name = fqn.partition(".")
                if part == "edge":
                    want = m_edge[name]
                else:
                    j, _, w = name.partition(".")
                    want = m_stacked[w][mesh.pp_rank, int(j)]
                    axis = par.TP_AXIS.get(w)
                    if tp_axis and axis is not None:
                        want = np.split(want, tp, axis=axis)[mesh.tp_rank]
                np.testing.assert_array_equal(st[key].numpy(), want,
                                              err_msg=fqn)
    with pytest.raises(ValueError, match="stages"):
        convert.pipeline_opt_state_from_jax(
            np_state, stage, p_edge, optimizer,
            par.Mesh(1, 1, 1, 0, {}, pp=4), "pp")
