"""The port's checkpoint (``tpushare_torch/workload/checkpoint.py``)
against the JAX package's orbax-backed one: round trips, retention, the
save rule, the async snapshot, an interrupted save, resume, optax state
carried into the port, and saves and restores across meshes by a gang of
gloo ranks on the CPU (``tests/torch_checkpoint_rank.py``, started once
for the module by ``tpushare_torch.runtime.launch``)."""

import dataclasses
import glob
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed.checkpoint as dcp

from tpushare.workload import model as JM
from tpushare.workload import train as JT
from tpushare.workload.checkpoint import CheckpointConfig as JConfig
from tpushare.workload.checkpoint import Checkpointer as JCheckpointer
from tpushare_torch.runtime import launch
from tpushare_torch.workload import checkpoint as CK
from tpushare_torch.workload import convert
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par
from tpushare_torch.workload import serving as S
from tpushare_torch.workload import train as T
from tpushare_torch.workload.checkpoint import CheckpointConfig, Checkpointer

HERE = os.path.dirname(os.path.abspath(__file__))
#: The gang of 4 tiny ranks is done in about 10 s alone; the deadline only
#: turns a hang into a failure.
GANG_DEADLINE_S = 600
#: A step after a restore against the uninterrupted run's, fp32: the loss
#: relative and the weights and AdamW moments normalized (max |diff| /
#: max |ref|). Across meshes it is the same arithmetic summed in another
#: order; against the JAX package, the same algorithm in another
#: framework (tests/test_torch_train.py holds its fp32 loss at 1e-5).
NEXT_STEP_TOL = 1e-5
#: Bytes of ``torch.save`` framing around each item a DCP data file holds
#: (about 1.6 KB on the CPU build).
FRAMING_BYTES = 2048
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(dtype=torch.float32):
    return dataclasses.replace(M.ModelConfig().tiny(), dtype=dtype)


def _batch(rows=4, length=32):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (rows, length)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _torch_batch():
    return tuple(torch.from_numpy(x).long() for x in _batch())


def _trained(steps, dtype=torch.float32, seed=0):
    """(params, opt, step fn, batch) after ``steps`` single-process steps."""
    init_fn, step, _ = T.make_train_step(_cfg(dtype), device="cpu")
    batch = _torch_batch()
    params, opt = init_fn(torch.Generator().manual_seed(seed), batch[0])
    for _ in range(steps):
        step(params, opt, *batch)
    return params, opt, step, batch


def _fresh(dtype=torch.float32, seed=7):
    init_fn, _, _ = T.make_train_step(_cfg(dtype), device="cpu")
    return init_fn(torch.Generator().manual_seed(seed), None)


def _snapshot(params, opt) -> dict:
    """Every weight and AdamW state tensor, cloned, by (name, key)."""
    out = {}
    for name, p in params.named_parameters():
        out[name, "weight"] = p.detach().clone()
        for key, v in opt.state[p].items():
            out[name, key] = v.detach().clone()
    return out


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _steps_on_disk(directory):
    return sorted(os.listdir(directory))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_save_restore_roundtrip_is_bitwise(tmp_path, dtype):
    """Weights, exp_avg, exp_avg_sq and step come back bit for bit into
    a fresh state of other weights, whose optimizer has taken no step."""
    params, opt, _, _ = _trained(2, DTYPES[dtype])
    want = _snapshot(params, opt)
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path / "ckpt")))
    assert ckpt.save(2, params, opt, wait=True)
    assert ckpt.latest_step() == 2
    params2, opt2 = _fresh(DTYPES[dtype])
    assert not opt2.state
    r_params, r_opt, r_step = ckpt.restore(params2, opt2)
    assert r_step == 2 and r_params is params2 and r_opt is opt2
    _assert_same(_snapshot(params2, opt2), want)
    assert float(opt2.state[params2.embed]["step"]) == 2
    ckpt.close()


def test_restore_none_when_empty(tmp_path):
    params, opt = _fresh()
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path / "empty")))
    assert ckpt.restore(params, opt) is None
    assert ckpt.latest_step() is None
    ckpt.close()


def test_retention(tmp_path):
    """max_to_keep=2 keeps the two latest steps, as the JAX package's
    test_retention asks (there, at most 2 with 4 among them)."""
    params, opt, _, _ = _trained(1)
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path / "keep"),
                                         max_to_keep=2))
    for s in (1, 2, 3, 4):
        assert ckpt.save(s, params, opt, wait=True)
    assert ckpt.latest_step() == 4
    assert _steps_on_disk(tmp_path / "keep") == ["3", "4"]
    ckpt.close()


#: (save_interval_steps, steps saved with force=True) of the parity runs.
SAVE_RULES = [(1, ()), (2, ()), (3, (4,)), (4, (1, 6)), (2, (3,))]


@pytest.mark.parametrize("interval,forced", SAVE_RULES)
def test_save_rule_matches_the_jax_checkpointer(tmp_path, interval, forced):
    """Both classes are asked to save at steps 1-6 (``force`` at
    ``forced``): they answer the same and leave the same steps on disk."""
    tree = {"w": jnp.ones((2, 3))}
    jax_ckpt = JCheckpointer(JConfig(str(tmp_path / "jax"), max_to_keep=10,
                                     save_interval_steps=interval))
    jax_saved = [jax_ckpt.save(s, tree, tree, force=s in forced, wait=True)
                 for s in range(1, 7)]
    jax_ckpt.close()
    params, opt, _, _ = _trained(1)
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path / "torch"),
                                         max_to_keep=10,
                                         save_interval_steps=interval))
    saved = [ckpt.save(s, params, opt, force=s in forced, wait=True)
             for s in range(1, 7)]
    ckpt.close()
    assert saved == jax_saved
    assert _steps_on_disk(tmp_path / "torch") == sorted(
        os.listdir(tmp_path / "jax"))


def test_async_save_snapshots_before_returning(tmp_path, monkeypatch):
    """``save(wait=False)`` returns while the write is held back; the step
    taken then updates the weights and the optimizer in place; the
    checkpoint still holds the state of the save, bit for bit."""
    import threading

    release, real_save = threading.Event(), CK.dcp.save

    def held_save(*args, **kwargs):
        assert release.wait(timeout=60)
        return real_save(*args, **kwargs)

    monkeypatch.setattr(CK.dcp, "save", held_save)
    params, opt, step, batch = _trained(2)
    want = _snapshot(params, opt)
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path / "ckpt")))
    assert ckpt.save(2, params, opt)
    assert ckpt._writer.is_alive() and ckpt.latest_step() is None
    step(params, opt, *batch)
    assert not torch.equal(params.embed, want["embed", "weight"])
    release.set()
    ckpt.wait()
    assert ckpt.latest_step() == 2
    params2, opt2 = _fresh()
    ckpt.restore(params2, opt2)
    _assert_same(_snapshot(params2, opt2), want)
    ckpt.close()


def test_interrupted_save_is_ignored(tmp_path, monkeypatch):
    """A save that fails after its ranks wrote their parts leaves
    ``<step>.partial``, never ``<step>``: ``latest_step`` and ``restore``
    stay at the step before, and the step can be saved again."""
    params, opt, step, batch = _trained(1)
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path / "ckpt")))
    assert ckpt.save(1, params, opt, wait=True)
    want = _snapshot(params, opt)
    real_save = CK.dcp.save

    def killed(*args, **kwargs):
        real_save(*args, **kwargs)
        raise OSError("killed mid-save")

    step(params, opt, *batch)
    monkeypatch.setattr(CK.dcp, "save", killed)
    assert ckpt.save(2, params, opt)
    with pytest.raises(OSError, match="killed mid-save"):
        ckpt.wait()
    assert _steps_on_disk(tmp_path / "ckpt") == ["1", "2.partial"]
    fresh = Checkpointer(CheckpointConfig(str(tmp_path / "ckpt")))
    assert fresh.latest_step() == 1
    params2, opt2 = _fresh()
    assert fresh.restore(params2, opt2)[2] == 1
    _assert_same(_snapshot(params2, opt2), want)
    monkeypatch.setattr(CK.dcp, "save", real_save)
    assert fresh.save(2, params, opt, wait=True)
    assert _steps_on_disk(tmp_path / "ckpt") == ["1", "2"]
    fresh.close()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_resume_continues_bit_identically(tmp_path, dtype):
    """Four steps straight through equal two steps, a save, a restore into
    fresh state and two more, bit for bit: losses, weights and AdamW state
    (a bias correction that restarted would show)."""
    params, opt, step, batch = _trained(0, DTYPES[dtype])
    straight = [step(params, opt, *batch)[2].item() for _ in range(4)]
    want = _snapshot(params, opt)

    params, opt, step, batch = _trained(0, DTYPES[dtype])
    resumed = [step(params, opt, *batch)[2].item() for _ in range(2)]
    ckpt = Checkpointer(CheckpointConfig(str(tmp_path / "ckpt")))
    ckpt.save(2, params, opt, wait=True)
    params, opt = _fresh(DTYPES[dtype])
    ckpt.restore(params, opt)
    resumed += [step(params, opt, *batch)[2].item() for _ in range(2)]
    assert resumed == straight
    _assert_same(_snapshot(params, opt), want)
    ckpt.close()


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _norm_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def test_step_after_optax_state_matches_jax():
    """JAX trains two steps; its weights and optax adamw state are carried
    into the port (``params_from_jax``, ``opt_state_from_jax``), and the
    port's third step is held to JAX's third step: loss, weights and both
    moments within NEXT_STEP_TOL, the count equal."""
    jcfg = dataclasses.replace(JM.ModelConfig().tiny(), dtype=jnp.float32)
    tokens, targets = (jnp.asarray(x) for x in _batch())
    init_fn, jstep, _ = JT.make_train_step(jcfg)
    jparams, jopt = init_fn(jax.random.PRNGKey(0), tokens)
    for _ in range(2):
        jparams, jopt, _ = jstep(jparams, jopt, tokens, targets)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jopt_np = jax.tree_util.tree_map(np.asarray, jopt)

    cfg = _cfg()
    params = convert.params_from_jax(tree, cfg, device="cpu")
    opt = T.make_optimizer()(params.parameters())
    convert.opt_state_from_jax(jopt_np, params, opt)
    carried = convert.opt_state_to_numpy(opt, params)
    assert carried["count"] == 2
    for key in ("mu", "nu"):
        for name, ref in _flat(getattr(jopt_np[0], key)).items():
            np.testing.assert_array_equal(_flat(carried[key])[name], ref)

    jparams, jopt, jloss = jstep(jparams, jopt, tokens, targets)
    _, step, _ = T.make_train_step(cfg, device="cpu")
    _, _, loss = step(params, opt, *_torch_batch())
    assert abs(loss.item() - float(jloss)) <= NEXT_STEP_TOL * abs(
        float(jloss))
    got = convert.params_to_numpy(params)
    for name, ref in _flat(jparams).items():
        assert _norm_err(_flat(got)[name], ref) <= NEXT_STEP_TOL, name
    after = convert.opt_state_to_numpy(opt, params)
    assert after["count"] == int(jopt[0].count) == 3
    for key in ("mu", "nu"):
        ref = _flat(getattr(jopt[0], key))
        for name, r in ref.items():
            assert _norm_err(_flat(after[key])[name], r) <= NEXT_STEP_TOL, (
                key, name)


def test_opt_state_to_numpy_of_a_fresh_optimizer_is_optax_init():
    params, opt = _fresh()
    got = convert.opt_state_to_numpy(opt, params)
    assert got["count"] == 0
    assert all(not a.any() for a in _flat(got["mu"]).values())


@pytest.mark.parametrize("shape,axes", [
    ((2, 1, 2, 1), ("dp", "tp", "sp")),
    ((1, 2, 1, 2), ("dp", "tp", "sp", "pp")),
    ((2, 1, 1, 2), ("dp", "tp", "sp", "pp"))])
def test_host_device_mesh_of_a_pipe_is_4d(monkeypatch, shape, axes):
    """``host_device_mesh`` builds the CPU mesh of a pipeline's mesh with
    its pipe axis, (dp, tp, sp, pp) in ``make_mesh``'s row-major order,
    and keeps a mesh without one 3-D (dp, tp, sp), as checkpoints written
    before pipes were saved."""
    calls = []
    monkeypatch.setattr(par, "init_device_mesh",
                        lambda *args, **kw: calls.append((args, kw)))
    dp, tp, sp, pp = shape
    par.host_device_mesh(par.Mesh(dp, tp, sp, 0, {}, pp=pp))
    (args, kw), = calls
    assert args == ("cpu", shape[:len(axes)])
    assert kw == {"mesh_dim_names": axes}


# --------------------------------------------------------------------------
# Gangs: saves and restores across meshes (tests/torch_checkpoint_rank.py)
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """(rank records, rank 0's gathered arrays, checkpoint directory)."""
    tmp = tmp_path_factory.mktemp("ckpt_gang")
    tokens, targets = _batch()
    np.savez(tmp / "inputs.npz", tokens=tokens, targets=targets)
    records = launch.launch(
        [os.path.join(HERE, "torch_checkpoint_rank.py"),
         str(tmp / "inputs.npz"), str(tmp), f"file://{tmp / 'rendezvous'}"],
        4, deadline_s=GANG_DEADLINE_S, env={"OMP_NUM_THREADS": "1"})
    return records, dict(np.load(tmp / "out.npz")), tmp


def _state_keys(got, prefix):
    return {k[len(prefix):] for k in got if k.startswith(prefix)}


def test_restore_onto_a_different_mesh_is_bitwise(gang):
    """Saved on (2, 1, 2), restored on (1, 1, 4) into weights of another
    seed: every weight, both moments and the step, bit for bit; every
    rank restored the step rank 0 saw."""
    records, got, _ = gang
    keys = _state_keys(got, "a/saved/")
    assert keys == _state_keys(got, "b/restored/") and len(keys) > 20
    for k in keys:
        np.testing.assert_array_equal(got[f"b/restored/{k}"],
                                      got[f"a/saved/{k}"], err_msg=k)
    assert all(r["b_restored_step"] == 2 and r["a_latest"] == 2
               for r in records)


def test_next_step_after_a_mesh_change_matches_the_uninterrupted_run(gang):
    """Step 3 on (1, 1, 4) after the restore against step 3 of the (2, 1,
    2) gang that saved: loss, weights and moments within NEXT_STEP_TOL."""
    _, got, _ = gang
    want = float(got["a/loss3"])
    assert abs(float(got["b/loss3"]) - want) <= NEXT_STEP_TOL * abs(want)
    for k in _state_keys(got, "a/after/"):
        if k == "step":
            assert got["b/after/step"] == got["a/after/step"] == 3
            continue
        assert _norm_err(got[f"b/after/{k}"], got[f"a/after/{k}"]) <= (
            NEXT_STEP_TOL), k


def _restore_unsharded(directory):
    params, opt = _fresh(seed=9)
    ckpt = Checkpointer(CheckpointConfig(str(directory)))
    _, _, step = ckpt.restore(params, opt)
    ckpt.close()
    return params, opt, step


def test_restore_in_one_process_is_bitwise(gang):
    """Saved by a (2, 2, 1) gang, restored by one process with no process
    group: the full weights and moments its ranks gathered, bit for bit."""
    records, got, tmp = gang
    params, opt, step = _restore_unsharded(tmp / "c")
    assert step == 3 and all(r["c_latest"] == 3 for r in records)
    restored = {f"weight/{n}": p.detach() for n, p in
                params.named_parameters()}
    for key in ("exp_avg", "exp_avg_sq"):
        restored.update({f"{key}/{n}": opt.state[p][key] for n, p in
                         params.named_parameters()})
    keys = _state_keys(got, "c/saved/") - {"step"}
    assert keys == set(restored)
    for k in keys:
        np.testing.assert_array_equal(restored[k].numpy(),
                                      got[f"c/saved/{k}"], err_msg=k)
    assert float(opt.state[params.embed]["step"]) == got["c/saved/step"]


def test_a_gang_writes_each_shard_once(gang):
    """The (2, 2, 1) checkpoint holds each global tensor once: a tp-sharded
    weight and its two moments as tp chunks that tile it, a replicated one
    as one chunk (tp shards are not taken for replicas, which would lose
    one, and dp replicas are not written twice). The data files hold those
    bytes plus each stored item's serialization framing."""
    records, _, tmp = gang
    reader = dcp.FileSystemReader(str(tmp / "c" / "3"))
    meta = reader.read_metadata()
    params, _ = _fresh()
    for name, p in params.named_parameters():
        for key in (f"params.{name}", f"opt_state.{name}.exp_avg",
                    f"opt_state.{name}.exp_avg_sq"):
            md = meta.state_dict_metadata[key]
            assert tuple(md.size) == tuple(p.shape), key
            assert len(md.chunks) == (2 if par._tp_axis(name) is not None
                                      else 1), key
            assert sum(math.prod(c.sizes) for c in md.chunks) == p.numel()
    tensors = 3 * sum(p.numel() for p in params.parameters()) * 4
    data = sum(os.path.getsize(f) for f in
               glob.glob(str(tmp / "c" / "3" / "*.distcp")))
    items = len(meta.storage_data)
    assert tensors <= data <= tensors + FRAMING_BYTES * items
    stats = records[0]["c_stats"]
    assert stats["step"] == 3 and stats["bytes"] >= data
    assert stats["durable_s"] >= stats["blocked_s"] > 0


def test_train_checkpoint_serve_lifecycle(gang):
    """The port's twin of the JAX package's lifecycle test: trained on a
    dp x tp gang, checkpointed, restored unsharded and served; the decode
    is the restored model's forward (fp32: prefill logits within 1e-5 of
    the last position of ``forward``)."""
    _, _, tmp = gang
    cfg = _cfg()
    params, _, _ = _restore_unsharded(tmp / "c")
    prompt = _torch_batch()[0][:2, :8]
    out = S.generate(params, prompt, cfg, n_new=4, max_len=16)
    assert tuple(out.shape) == (2, 12)
    assert torch.equal(out[:, :8], prompt)
    logits, _ = S.prefill(params, prompt,
                          S.init_cache(cfg, 2, 16, device="cpu"))
    with torch.inference_mode():
        full = M.forward(params, prompt, cfg)
    torch.testing.assert_close(logits, full[:, -1], atol=1e-5, rtol=0)


def test_entry_point_resumes_bit_identically(gang):
    """``python -m tpushare_torch.entry --ckpt-dir D --ckpt-every 2``
    trains 3 steps with an async save after step 2; a fresh gang with
    ``--resume`` restores step 2 and takes step 3: the same loss, bit for
    bit, on every rank."""
    records, _, _ = gang
    for rec in records:
        saved, resumed = rec["entry_save"], rec["entry_resume"]
        assert saved["steps"] == [1, 2, 3] and resumed["steps"] == [3]
        assert saved["checkpoint"]["saved_steps"] == [2]
        assert resumed["checkpoint"]["restored_step"] == 2
        assert resumed["losses"] == saved["losses"][2:]
        assert saved["checkpoint"]["save_blocked_ms"][0] > 0
