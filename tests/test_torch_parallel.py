"""The port's sharded slice against the JAX package's: ring and Ulysses
attention, the dp x tp x sp train step and the entry point's dry run,
run by one gang of gloo ranks on the CPU (``tests/torch_parallel_rank.py``,
started once for the module by ``tpushare_torch.runtime.launch``), held to
the JAX package's single-device functions on the same numpy inputs and
weights."""

import dataclasses
import itertools
import math
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpushare.workload import model as JM
from tpushare.workload import parallel as jpar
from tpushare.workload import train as JT
from tpushare_torch import entry as E
from tpushare_torch.runtime import launch
from tpushare_torch.workload import convert
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par

HERE = os.path.dirname(os.path.abspath(__file__))
#: Attention in fp32 against the JAX package's, as tests/test_workload.py
#: holds its ring (atol and rtol 1e-5); gradients normalized (max |diff| /
#: max |ref|), the single-device slice's fp32 bound.
ATTN_TOL, ATTN_GRAD_TOL = 1e-5, 1e-4
#: The sharded step against JAX's single-device one: relative loss,
#: normalized gradients and weights after one step. fp32 is the same
#: arithmetic summed in another order, held at 1e-5 where the arithmetic
#: allows it: the loss, and the AdamW step on the gathered gradients
#: (ADAMW_TOL). Two bounds are set by the JAX package's own sharding
#: noise, its (2, 2, 2) ring step against its single-device step at these
#: weights and batch (test_step_tolerances_hold_the_reference_itself
#: holds it to them): bf16 gradients depart by up to 4.6e-2
#: (blocks.0.attn_norm: each shard's gradient is rounded to bf16 before
#: the dp x sp sum), and fp32 weights after one step by about 5e-5
#: (blocks.1.w_down: AdamW's first step moves a weight by lr * g / (|g| +
#: 1e-8), so where |g| is near 1e-8 a rounding of g moves the weight by a
#: fraction of lr = 3e-4). That is near what a step that updates nothing
#: would read on the norms (lr / |w| ~ 3e-4), so WEIGHT_TOL does not catch
#: a missing update: ADAMW_TOL does, holding the fp32 weights to the
#: AdamW step of the port's own gathered gradients. bf16 loss and
#: weights: the reference's own 2e-2 for a sharded loss
#: (tests/test_workload.py).
LOSS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
WEIGHT_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
ADAMW_TOL = 1e-5
JDTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: The module's one gang of 8 tiny ranks on the CPU is done in about 15 s
#: alone, at the lowest priority (nice 19) beside the rest of the suite in
#: a few minutes; the deadline only turns a hang into a failure.
GANG_DEADLINE_S = 600
B, L, H, D = 2, 32, 4, 8


def _attn_inputs():
    rng = np.random.default_rng(0)
    return {x: rng.standard_normal((B, L, H, D)).astype(np.float32)
            for x in ("q", "k", "v", "dout")}


def _jax_cfg(dtype):
    return dataclasses.replace(JM.ModelConfig().tiny(),
                               dtype=JDTYPES[dtype])


def _jax_params(dtype):
    return JM.init_params(jax.random.PRNGKey(0), _jax_cfg(dtype))


def _batch():
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, (4, 32)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _torch_name(path):
    """``blocks.0.wqkv`` from a JAX tree path."""
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _flat(tree):
    return {_torch_name(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


#: Attention of the (2, 2, 2) step: as ``make_train_step`` picks it on the
#: CPU, and through the kernels' code path (``use_flash=True``).
STRATEGIES = ("ring", "ulysses", "ring_flash", "ulysses_flash")
#: (dtype, attention) of the (2, 2, 2) step; "none" is
#: ``use_ring_attention=False``.
STEP_CASES = [(d, a) for d in JDTYPES for a in STRATEGIES] + [
    ("float32", "none")]
#: The cases whose gradients are held to JAX's. In bf16 the kernels' code
#: path rounds where the kernels round (P to bf16 before its products),
#: not where JAX's plain attention rounds, and the gradient of a norm
#: scale, summed over dp x sp from partials each rounded to bf16, reads
#: that as whole bf16 steps of its largest element (5.1e-2 against the
#: reference's own 4.6e-2 for Ulysses): those cases are held to the
#: port's plain path instead (test_flash_path_grads_match_the_plain_path),
#: and in fp32 to JAX's.
GRAD_CASES = [c for c in STEP_CASES if c[0] == "float32"
              or not c[1].endswith("_flash")]
#: The kernels' code path against the plain path of the same strategy, at
#: the same sharding: the same arithmetic in fp32 (ATTN_GRAD_TOL); in bf16
#: the bound that holds a train step through the kernels to one through
#: plain attention on the card (chip_smoke.py's TRAIN_GRAD_TOL).
FLASH_VS_PLAIN_TOL = {"float32": ATTN_GRAD_TOL, "bfloat16": 4e-2}


def _norm_err(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _jax_attention():
    """JAX single-device causal attention and its q/k/v gradients of
    sum(out * dout), fp32."""
    x = {k: jnp.asarray(v) for k, v in _attn_inputs().items()}
    out, vjp = jax.vjp(JM.causal_attention, x["q"], x["k"], x["v"])
    grads = vjp(x["dout"])
    return {"out": np.asarray(out),
            **{g: np.asarray(t) for g, t in zip(("dq", "dk", "dv"), grads)}}


def _jax_steps():
    """Per dtype: JAX's single-device loss, gradients and weights after
    one step of ``make_train_step(cfg, mesh=None)`` (as flat dicts)."""
    tokens, targets = (jnp.asarray(x) for x in _batch())
    result = {}
    for dtype in JDTYPES:
        cfg, params = _jax_cfg(dtype), _jax_params(dtype)
        loss, grads = jax.value_and_grad(JT.loss_fn)(params, tokens,
                                                     targets, cfg)
        init_fn, step, _ = JT.make_train_step(cfg, mesh=None)
        _, opt = init_fn(jax.random.PRNGKey(0), tokens)
        after, _, _ = step(params, opt, tokens, targets)
        result[dtype] = {"loss": float(loss), "grads": _flat(grads),
                         "weights": _flat(after)}
    return result


def _jax_sharded_steps():
    """Per dtype: the JAX package's own (2, 2, 2) ring step on the virtual
    CPU mesh, from the same weights and batch: its loss and gradients,
    and the weights after one step, which its ``make_train_step`` makes
    with the optimizer's update of those gradients (flat dicts). The
    update runs unsharded: it is elementwise, and compiling the sharded
    step as well would double the compile time."""
    tokens, targets = (jnp.asarray(x) for x in _batch())
    mesh = jpar.make_mesh(dp=2, tp=2, sp=2)
    result = {}
    for dtype in JDTYPES:
        cfg = _jax_cfg(dtype)

        def placed():
            params = _jax_params(dtype)
            return jax.device_put(params, jpar.param_shardings(mesh, params))

        with mesh:
            ring = jpar.make_ring_attn_fn(mesh)
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: JT.loss_fn(p, tokens, targets, cfg,
                                     attn_fn=ring)))(placed())
        params = _jax_params(dtype)
        grads = jax.tree_util.tree_map(jnp.asarray, jax.device_get(grads))
        opt = JT.make_optimizer()
        updates, _ = opt.update(grads, opt.init(params), params)
        result[dtype] = {"loss": float(loss), "grads": _flat(grads),
                         "weights": _flat(optax.apply_updates(params,
                                                              updates))}
    return result


#: The reference dry run's training at its tiny width on 8 devices
#: (``__graft_entry__.dryrun_multichip``: auto_mesh_shape(8) = (2, 2, 2),
#: max(4, tp) heads, 16 sp tokens a sequence, batch 2 dp, the default
#: dtype bf16), and the same config in fp32.
DRYRUN_MESH = (2, 2, 2)
#: The dry run's train part against the JAX package's training at its
#: dtype: relative losses and normalized first-step gradients. fp32 is
#: the same arithmetic in another order; bf16 takes the bounds a bf16
#: train step through the kernels is held to against one through plain
#: attention (chip_smoke.py's TRAIN_LOSS_TOL and TRAIN_GRAD_TOL).
DRYRUN_TOL = {"float32": (LOSS_TOL["float32"], GRAD_TOL["float32"]),
              "bfloat16": (2e-2, 4e-2)}


def _jax_dryrun_config(dtype="bfloat16"):
    dp, tp, sp = DRYRUN_MESH
    return JM.ModelConfig(vocab_size=256, d_model=64, n_heads=max(4, tp),
                          n_layers=2, d_ff=128, max_seq_len=16 * sp,
                          dtype=JDTYPES[dtype]), (2 * dp, 16 * sp)


def _jax_dryrun_train(dtype):
    """The JAX package's single-device training at the reference dry
    run's tiny config in ``dtype``, from the port's dry-run weights and
    batch (``entry.dryrun_generator`` seeds 0 and 1; the weights are drawn
    in fp32 and rounded to the dtype, as the port draws them): the losses
    of two ``make_train_step`` steps, and the first step's gradients
    (flat)."""
    cfg, shape = _jax_dryrun_config(dtype)
    port_cfg = dataclasses.replace(
        E.dryrun_config("tiny", _mesh(*DRYRUN_MESH, 0))[0],
        dtype=getattr(torch, dtype))
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, cfg.dtype), convert.params_to_numpy(
            M.init_params(E.dryrun_generator(0), port_cfg, "cpu")))
    tokens = jnp.asarray(torch.randint(0, cfg.vocab_size, shape,
                                       generator=E.dryrun_generator(1))
                         .numpy().astype(np.int32))
    targets = jnp.roll(tokens, -1, axis=1)
    _, grads = jax.value_and_grad(JT.loss_fn)(params, tokens, targets, cfg)
    init_fn, step, _ = JT.make_train_step(cfg, mesh=None)
    _, opt = init_fn(jax.random.PRNGKey(0), tokens)
    losses = []
    for _ in range(2):
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
    return {"losses": losses, "grads": _flat(grads)}


def save_references(path):
    """The JAX package's references, pickled to ``path``: run by
    :func:`runs` in a subprocess at the lowest priority."""
    refs = {"attention": _jax_attention(), "steps": _jax_steps(),
            "sharded_steps": _jax_sharded_steps(),
            "dryrun_train": {dtype: _jax_dryrun_train(dtype)
                             for dtype in JDTYPES}}
    with open(path, "wb") as f:
        pickle.dump(refs, f)


#: Runs ``save_references(argv[1])`` of this module at nice 19, so that
#: JAX's compile and its thread pool run at the lowest priority too.
NICE_REFERENCES = (
    "import os, sys; os.nice(19); sys.path.insert(0, {here!r}); "
    "import test_torch_parallel as t; t.save_references(sys.argv[1])")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything the module compares, made once and side by side by
    processes at the lowest priority (nice 19), so the rest of the suite
    keeps its CPU: the JAX package's references (a subprocess of this
    module's :func:`save_references`) and the gang, on the same numpy
    inputs and weights."""
    tmp = tmp_path_factory.mktemp("gang")
    inputs = dict(_attn_inputs())
    inputs["tokens"], inputs["targets"] = _batch()
    for dtype in JDTYPES:
        for name, leaf in _flat(_jax_params(dtype)).items():
            inputs[f"{dtype}/{name.replace('.', '/')}"] = leaf
    np.savez(tmp / "inputs.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.path.dirname(HERE), os.environ.get("PYTHONPATH"))
        if p)}
    refs = subprocess.Popen(
        [sys.executable, "-c", NICE_REFERENCES.format(here=HERE),
         str(tmp / "refs.pkl")], env=env)
    try:
        records = launch.launch(
            [os.path.join(HERE, "torch_parallel_rank.py"),
             str(tmp / "inputs.npz"), str(tmp / "out.npz"),
             f"file://{tmp / 'rendezvous'}"], 8,
            deadline_s=GANG_DEADLINE_S, env={"OMP_NUM_THREADS": "1"})
        assert refs.wait(timeout=GANG_DEADLINE_S) == 0
    finally:
        if refs.poll() is None:
            refs.kill()
            refs.wait()
    with open(tmp / "refs.pkl", "rb") as f:
        references = pickle.load(f)
    return {"gang": (records, dict(np.load(tmp / "out.npz"))),
            "dryrun_saved": {dtype: torch.load(tmp / f"out_dryrun_{dtype}.pt")
                             for dtype in JDTYPES},
            **references}


@pytest.fixture(scope="module")
def gang(runs):
    """The gang's (rank records, rank 0's gathered arrays)."""
    return runs["gang"]


@pytest.fixture(scope="module")
def jax_attention(runs):
    return runs["attention"]


@pytest.fixture(scope="module")
def jax_steps(runs):
    return runs["steps"]


@pytest.fixture(scope="module")
def jax_sharded_steps(runs):
    return runs["sharded_steps"]


@pytest.mark.parametrize("dtype", list(JDTYPES))
def test_step_tolerances_hold_the_reference_itself(jax_steps,
                                                   jax_sharded_steps, dtype):
    """The bounds the sharded step is held to are ones the JAX package's
    own (2, 2, 2) step meets against its single-device step: sharding
    the step costs the reference this much too."""
    one, sharded = jax_steps[dtype], jax_sharded_steps[dtype]
    assert abs(sharded["loss"] - one["loss"]) <= (
        LOSS_TOL[dtype] * abs(one["loss"]))
    for kind, tol in (("grads", GRAD_TOL), ("weights", WEIGHT_TOL)):
        errs = {name: _norm_err(sharded[kind][name], r)
                for name, r in one[kind].items()}
        assert max(errs.values()) <= tol[dtype], (kind, errs)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("fn", ["ring", "ring_flash"])
def test_ring_matches_jax_attention(gang, jax_attention, sp, fn):
    _, got = gang
    np.testing.assert_allclose(got[f"sp{sp}/{fn}/out"], jax_attention["out"],
                               atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("fn", ["ring", "ring_flash"])
@pytest.mark.parametrize("grad", ["dq", "dk", "dv"])
def test_ring_grads_match_jax(gang, jax_attention, sp, fn, grad):
    """The backward through the shift's transpose: each rank's dk/dv
    partials travel back to the rank that owns the block."""
    _, got = gang
    assert _norm_err(got[f"sp{sp}/{fn}/{grad}"],
                     jax_attention[grad]) <= ATTN_GRAD_TOL


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("local", ["plain", "flash"])
def test_ulysses_matches_ring(gang, sp, local):
    """Ulysses' output and gradients against the ring's (the reference's
    test_ulysses_gradients_match_ring, over every input)."""
    _, got = gang
    name = "ulysses" if local == "plain" else "ulysses_flash"
    for key in ("out", "dq", "dk", "dv"):
        assert _norm_err(got[f"sp{sp}/{name}/{key}"],
                         got[f"sp{sp}/ring/{key}"]) <= ATTN_GRAD_TOL, key


def test_ulysses_rejects_indivisible_heads(gang):
    records, _ = gang
    for rec in records:
        assert set(rec["refused"]) == {"sp2", "sp4"}
        assert all("heads % sp" in msg for msg in rec["refused"].values())


@pytest.mark.parametrize("dtype,attention", STEP_CASES)
def test_sharded_loss_matches_jax(gang, jax_steps, dtype, attention):
    """The (2, 2, 2) step's global loss against JAX's single-device
    ``loss_fn`` on the same weights and batch."""
    _, got = gang
    want = jax_steps[dtype]["loss"]
    assert abs(float(got[f"{dtype}/{attention}/loss"]) - want) <= (
        LOSS_TOL[dtype] * abs(want))


@pytest.mark.parametrize("dtype,attention", GRAD_CASES)
def test_sharded_grads_match_jax(gang, jax_steps, dtype, attention):
    """Gradients reduced over dp x sp and gathered over tp against JAX's
    single-device ``jax.grad``: a reduction over tp as well would show as
    x2 here, a missed one as x1/4."""
    _, got = gang
    ref = jax_steps[dtype]["grads"]
    for name, r in ref.items():
        err = _norm_err(got[f"{dtype}/{attention}/grad/{name}"], r)
        assert err <= GRAD_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype", list(JDTYPES))
@pytest.mark.parametrize("attention", ["ring", "ulysses"])
def test_flash_path_grads_match_the_plain_path(gang, dtype, attention):
    """The (2, 2, 2) step through the kernels' code path (ring: every
    block's ``_FlashBlock`` backward with the lse cotangent the merge
    returns, under remat; Ulysses: ``flash_attention``) against the same
    step through the plain path: gradients reduced and gathered alike."""
    _, got = gang
    names = [k.rpartition("/grad/")[2] for k in got
             if k.startswith(f"{dtype}/{attention}/grad/")]
    assert names
    for name in names:
        err = _norm_err(got[f"{dtype}/{attention}_flash/grad/{name}"],
                        got[f"{dtype}/{attention}/grad/{name}"])
        assert err <= FLASH_VS_PLAIN_TOL[dtype], (name, err)


@pytest.mark.parametrize("dtype,attention", STEP_CASES)
def test_sharded_step_matches_jax(gang, jax_steps, dtype, attention):
    """The gathered weights after one (2, 2, 2) step against one step of
    JAX's ``make_train_step(cfg, mesh=None)``."""
    _, got = gang
    ref = jax_steps[dtype]["weights"]
    for name, r in ref.items():
        err = _norm_err(got[f"{dtype}/{attention}/weight/{name}"], r)
        assert err <= WEIGHT_TOL[dtype], (name, err)


@pytest.mark.parametrize("attention", [*STRATEGIES, "none"])
def test_sharded_adamw_step_is_the_full_step(gang, attention):
    """fp32: the weights after the sharded step are optax's AdamW step
    (the JAX package's optimizer, on the full tree) from the same weights
    on the port's own gathered gradients: each rank's AdamW over its
    shard is the single-device update, and every replica agrees."""
    _, got = gang
    params = _jax_params("float32")
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    grads = treedef.unflatten([
        jnp.asarray(got[f"float32/{attention}/grad/{_torch_name(p)}"])
        for p, _ in leaves])
    opt = JT.make_optimizer()
    updates, _ = opt.update(grads, opt.init(params), params)
    want = _flat(jax.tree_util.tree_map(lambda p, u: p + u, params,
                                        updates))
    for name, r in want.items():
        err = _norm_err(got[f"float32/{attention}/weight/{name}"], r)
        assert err <= ADAMW_TOL, (name, err)


def test_shard_then_gather_is_exact(gang):
    records, _ = gang
    for rec in records:
        assert rec["round_trip_exact"] == {"float32": True, "bfloat16": True}


@pytest.mark.parametrize("n", range(1, 17))
def test_auto_mesh_shape_matches_reference(n):
    assert par.auto_mesh_shape(n) == jpar.auto_mesh_shape(n)


def _mesh(dp, tp, sp, rank):
    """A mesh for code that reads only the shape and coordinates."""
    return par.Mesh(dp, tp, sp, rank, groups={})


def test_tp_axes_follow_the_reference_spec():
    params = _jax_params("float32")
    for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]:
        name = _torch_name(path)
        spec = jpar.param_spec(name.replace(".", "/"))
        want = spec.index("tp") if "tp" in spec else None
        assert par._tp_axis(name) == want, name


@pytest.mark.parametrize("tp_rank", [0, 1])
def test_shard_params_keeps_this_ranks_heads(tp_rank):
    cfg = M.ModelConfig().tiny()
    full = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    shard = par.shard_params(full, _mesh(1, 2, 1, tp_rank))
    half, ff = cfg.n_heads // 2, cfg.d_ff // 2
    heads = slice(tp_rank * half, (tp_rank + 1) * half)
    hidden = slice(tp_rank * ff, (tp_rank + 1) * ff)
    for got, want in zip(shard.blocks, full.blocks):
        assert torch.equal(got.wqkv, want.wqkv[:, :, heads])
        assert torch.equal(got.wo, want.wo[heads])
        assert torch.equal(got.w_gate, want.w_gate[:, hidden])
        assert torch.equal(got.w_up, want.w_up[:, hidden])
        assert torch.equal(got.w_down, want.w_down[hidden])
        assert torch.equal(got.attn_norm, want.attn_norm)
    assert torch.equal(shard.embed, full.embed)
    assert M.param_count(shard) < M.param_count(full)


def test_shard_params_refuses_an_uneven_split():
    cfg = M.ModelConfig().tiny()
    full = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="does not split over tp=3"):
        par.shard_params(full, _mesh(1, 3, 1, 0))


def test_place_batch_and_positions_follow_batch_spec():
    """Batch over dp, sequence over sp (the reference's ``P("dp", "sp")``);
    positions are the shard's global ones."""
    x = torch.arange(4 * 32).reshape(4, 32)
    for rank in range(8):
        mesh = _mesh(2, 2, 2, rank)
        d, _, s = mesh.coords
        shard = par.place_batch(mesh, x)
        assert torch.equal(shard, x[2 * d:2 * d + 2, 16 * s:16 * s + 16])
        assert torch.equal(par.place_batch(mesh, x, sequence=False),
                           x[2 * d:2 * d + 2])
        pos = par.global_positions(mesh, 4, 32, "cpu")
        assert torch.equal(pos, shard % 32)


def test_mesh_coords_are_row_major():
    seen = [_mesh(2, 2, 2, r).coords for r in range(8)]
    assert seen == [(d, t, s) for d in range(2) for t in range(2)
                    for s in range(2)]


@pytest.mark.parametrize("shape", [(1, 2, 2, 2), (2, 1, 1, 4),
                                   (2, 2, 1, 2), (1, 1, 2, 2)])
def test_mesh_coords_with_pp_are_row_major(shape):
    """Ranks fill (dp, tp, sp, pp) row-major, as the reference reshapes its
    devices for ("dp", "tp", "sp", "pp"); ``index`` reads one axis."""
    dp, tp, sp, pp = shape
    want = [(d, t, s, p) for d in range(dp) for t in range(tp)
            for s in range(sp) for p in range(pp)]
    for rank, coords in enumerate(want):
        mesh = par.Mesh(dp, tp, sp, rank, groups={}, pp=pp)
        assert mesh.coords == coords
        assert mesh.shape == dict(zip(par.AXES, shape))
        assert [mesh.index(a) for a in par.AXES] == list(coords)
        assert mesh.pp_rank == coords[3]


def test_mesh_without_pp_keeps_its_three_axes():
    mesh = _mesh(2, 2, 2, 5)
    assert mesh.shape == {"dp": 2, "tp": 2, "sp": 2}
    assert mesh.coords == (1, 0, 1) and mesh.pp_rank == 0
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.size("ep")


def _fake_groups(monkeypatch, shape, rank):
    """``make_mesh`` on ``rank`` of a gang whose groups are their member
    lists; returns the mesh and the lists in the order they were made."""
    made = []
    monkeypatch.setattr(par.dist, "get_world_size", lambda: math.prod(shape))
    monkeypatch.setattr(par.dist, "get_rank", lambda: rank)
    monkeypatch.setattr(par.dist, "new_group",
                        lambda ranks: made.append(ranks) or tuple(ranks))
    return par.make_mesh(*shape), made


@pytest.mark.parametrize("shape", [(2, 2, 2, 1), (1, 2, 2, 2),
                                   (2, 1, 1, 4), (2, 2, 1, 2)])
def test_mesh_groups_differ_only_along_their_axes(monkeypatch, shape):
    """``group(*axes)`` holds the ranks whose coordinates equal this
    rank's off ``axes`` (axes of size 1 add nothing), in rank order; every
    rank makes the same groups in the same order."""
    world = math.prod(shape)
    orders = []
    for rank in range(world):
        mesh, made = _fake_groups(monkeypatch, shape, rank)
        orders.append(made)
        coords = [par.Mesh(*shape[:3], r, {}, shape[3])._coords()
                  for r in range(world)]
        for n in range(len(par.AXES) + 1):
            for axes in itertools.combinations(par.AXES, n):
                off = [i for i, a in enumerate(par.AXES) if a not in axes]
                want = tuple(r for r in range(world)
                             if all(coords[r][i] == coords[rank][i]
                                    for i in off))
                assert mesh.group(*axes) == want, (rank, axes)
    assert all(o == orders[0] for o in orders)


def test_mesh_without_pp_keeps_its_groups(monkeypatch):
    """With pp = 1 the tp, sp and dp x sp groups are the lines the
    (dp, tp, sp) mesh has always had."""
    grid = np.arange(8).reshape(2, 2, 2)
    for rank in range(8):
        mesh, _ = _fake_groups(monkeypatch, (2, 2, 2, 1), rank)
        d, t, s = mesh.coords
        assert mesh.tp_group == tuple(grid[d, :, s])
        assert mesh.sp_group == tuple(grid[d, t, :])
        assert mesh.grad_group == tuple(grid[:, t, :].flatten())


@pytest.mark.parametrize("make", [par.make_ring_attn_fn,
                                  par.make_ulysses_attn_fn])
def test_forced_flash_refuses_what_the_kernel_cannot_take(make):
    """``use_flash=True`` with inputs the kernels cannot take (here not on
    a card, nor on the CPU where the plain versions stand in) raises
    before any collective, as the reference's factories do."""
    q = torch.empty((1, 128, 2, 64), device="meta")
    with pytest.raises(ValueError, match="use_flash=True"):
        make(_mesh(1, 1, 1, 0), use_flash=True)(q, q, q)


def test_dryrun_multichip_trains_on_a_cpu_gang(gang):
    """The entry point's rank body, tiny width, as the JAX package's
    multi-chip dry run: auto_mesh_shape(8) = (2, 2, 2), both attention
    strategies, finite losses that fall, the same loss on every rank;
    and every other part of the dry run ran (checked part by part in
    test_dryrun_multichip_runs_moe_and_pipes_on_a_cpu_gang)."""
    records = [r["dryrun"] for r in gang[0]]
    assert [r["rank"] for r in records] == list(range(8))
    for rec in records:
        assert rec["mesh_shape"] == {"dp": 2, "tp": 2, "sp": 2}
        assert rec["backend"] == "gloo"
        assert set(rec["parts"]) == {"moe", *DRYRUN_PIPES, "serve"}
        for path in rec["paths"].values():
            assert all(np.isfinite(path["losses"]))
            assert path["losses"][-1] < path["losses"][0]
    for attention in ("ring", "ulysses"):
        assert len({tuple(r["paths"][attention]["losses"])
                    for r in records}) == 1


@pytest.mark.parametrize("attention", ["ring", "ulysses"])
@pytest.mark.parametrize("dtype", list(JDTYPES))
def test_dryrun_train_part_matches_jax_at_its_dtype(runs, dtype, attention):
    """The dry run's train part (8 ranks, (2, 2, 2), tiny width) against
    the JAX package's training at the reference dry run's config in the
    same dtype, from the same weights and batch, each of its two losses
    and the first step's gathered gradients within ``DRYRUN_TOL``. bf16 is
    the entry's own dry run, whose config is the reference's field for
    field; fp32 the same rank body at that config in fp32."""
    cfg, _ = _jax_dryrun_config()
    port_cfg = E.dryrun_config("tiny", _mesh(*DRYRUN_MESH, 0))[0]
    assert port_cfg.dtype == torch.bfloat16
    for field in ("vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
                  "max_seq_len", "remat"):
        assert getattr(port_cfg, field) == getattr(cfg, field), field
    want = runs["dryrun_train"][dtype]
    key = "dryrun" if dtype == "bfloat16" else f"dryrun_{dtype}"
    records = [r[key] for r in runs["gang"][0]]
    assert records[0]["batch"] == [2 * DRYRUN_MESH[0], cfg.max_seq_len]
    loss_tol, grad_tol = DRYRUN_TOL[dtype]
    losses = records[0]["paths"][attention]["losses"]
    for got, ref in zip(losses, want["losses"], strict=True):
        assert abs(got - ref) <= loss_tol * abs(ref), (got, ref)
    saved = runs["dryrun_saved"][dtype][attention]
    assert saved["loss"] == losses[0]
    assert set(saved["grads"]) == set(want["grads"])
    for name, ref in want["grads"].items():
        err = _norm_err(saved["grads"][name].float().numpy(), ref)
        assert err <= grad_tol, (name, err)


#: The dry run's pipe parts at tiny width on 8 ranks: (mesh shape, layers
#: a stage, microbatches), as the reference's dry run builds them.
DRYRUN_PIPES = {
    "pipe": ({"dp": 2, "tp": 2, "sp": 2}, 1, 4),
    "dp_pp": ({"dp": 4, "tp": 1, "sp": 1, "pp": 2}, 1, 4),
    "dp_tp_pp": ({"dp": 2, "tp": 2, "sp": 1, "pp": 2}, 1, 4),
    "4d": ({"dp": 1, "tp": 2, "sp": 2, "pp": 2}, 1, 2),
}


@pytest.mark.parametrize("part", ["moe", *DRYRUN_PIPES])
def test_dryrun_multichip_runs_moe_and_pipes_on_a_cpu_gang(gang, part):
    """The dry run's other parts (the default ``--parts``): the ring-MoE
    over sp (E = 2 sp), the flagship pipe over the sp axis, dp x pp,
    dp x tp x pp and dp x tp x sp x pp, each with finite losses, the same
    on every call (the weights do not move) and on every rank, and a
    stash of at most n stage inputs."""
    parts = [r["dryrun"]["parts"][part] for r in gang[0]]
    losses = parts[0]["losses"]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert losses[0] == losses[1]
    assert all(p["losses"] == losses for p in parts)
    if part == "moe":
        assert parts[0]["experts"] == 4
        assert parts[0]["experts_per_rank"] == 2
        return
    shape, per_stage, m = DRYRUN_PIPES[part]
    for p in parts:
        assert p["mesh_shape"] == shape
        assert (p["layers_per_stage"], p["microbatches"]) == (per_stage, m)
        assert 1 <= p["stash_peak"] <= 2
    if part == "dp_pp":
        assert all("gpipe" in p for p in parts)


def test_tiny_dry_run_takes_the_kernels_on_a_card(monkeypatch):
    """The rank body at its default tiny width, as a card would run it
    (checked with no card and no launch): every attention part's config
    is at head_dim 16, the train part's in the reference's bf16 and the
    others' in fp32, as the reference's; the model's q, k, v views at a
    rank's heads pass every kernel check but the device's (dtype,
    head_dim, strides, 16-byte alignment for TMA and cp.async), and a CUDA
    device dispatches to the kernels: ``best_attn_fn`` for the decode's
    prefill and the pipes' stages, the flash ring and Ulysses for
    training."""
    mesh = _mesh(2, 2, 2, 0)
    cfgs = {"train": E.dryrun_config("tiny", mesh)[0],
            "serve": E.serve_setup("tiny", mesh)[0],
            **{part: E.pipe_setup(part, "tiny", mesh, 8)[2]
               for part in DRYRUN_PIPES}}
    for part, cfg in cfgs.items():
        dtype = torch.bfloat16 if part == "train" else torch.float32
        assert (cfg.dtype, cfg.head_dim) == (dtype, 16), part
        heads = cfg.n_heads // mesh.tp
        qkv = torch.zeros((2, 16, 3, heads, cfg.head_dim), dtype=cfg.dtype)
        q, k, v = qkv.unbind(2)
        with pytest.raises(ValueError, match="CUDA device"):
            FA._check_kernel_inputs(q, k, v)
        FA._check_tma(q=q, k=k, v=v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert FA.best_attn_fn("cuda") is FA.flash_attention
    on_card = type("OnCard", (), {"device": torch.device("cuda", 0)})()
    assert par._use_flash(None, on_card, on_card, on_card, "ring attention")


def test_dryrun_multichip_serves_tensor_parallel_on_a_cpu_gang(gang):
    """The dry run's serve part, as the reference's: ``generate`` on the
    training mesh's dp x tp (sp ranks are replicas), the tiny config at 2
    layers in fp32, prompts [2·dp, 8] and 4 new tokens; every rank holds
    the same global stream, its prompt kept, in vocab, each rank's cache
    at H / tp heads."""
    parts = [r["dryrun"]["parts"]["serve"] for r in gang[0]]
    for p in parts:
        assert p["tokens_shape"] == [4, 12] and p["batch"] == [4, 8]
        assert p["prompt_kept"] and p["in_vocab"]
        assert p["heads_per_rank"] == 2 and p["dtype"] == "torch.float32"


def test_launch_kills_a_gang_past_its_deadline():
    with pytest.raises(launch.GangError, match="not done after"):
        launch.launch(["-c", "import time; time.sleep(60)"], 2,
                      deadline_s=1.0)


def test_launch_fails_the_gang_when_a_rank_fails():
    """Rank 1 exits 3 at once; rank 0 would wait a minute for it."""
    code = ("import os, sys, time\n"
            "if os.environ['JOB_COMPLETION_INDEX'] == '1': sys.exit(3)\n"
            "time.sleep(60)\n")
    with pytest.raises(launch.GangError, match="rank 1 exited with 3"):
        launch.launch(["-c", code], 2, deadline_s=30)


def test_launch_gives_each_rank_its_gang_env():
    code = ("import json, os\n"
            "print(json.dumps({k: os.environ.get(k) for k in ("
            "'TPUSHARE_POD_GROUP', 'TPUSHARE_POD_GROUP_SIZE', "
            "'JOB_COMPLETION_INDEX', 'TPUSHARE_COORDINATOR', "
            "'TPUSHARE_HBM_POD_GIB', 'TPUSHARE_HBM_CHIP_GIB')}))\n")
    records = launch.launch(["-c", code], 3, deadline_s=30,
                            coordinator="host:1", grant_gib=26, card_gib=79)
    assert records == [{"TPUSHARE_POD_GROUP": "gang",
                        "TPUSHARE_POD_GROUP_SIZE": "3",
                        "JOB_COMPLETION_INDEX": str(i),
                        "TPUSHARE_COORDINATOR": "host:1",
                        "TPUSHARE_HBM_POD_GIB": "26",
                        "TPUSHARE_HBM_CHIP_GIB": "79"} for i in range(3)]


@pytest.mark.parametrize("tool", ["gloo_cuda_probe", "nccl_gang"])
def test_card_tools_need_their_cards(monkeypatch, capsys, tool):
    """``tools/gloo_cuda_probe.py`` and ``tools/nccl_gang.py`` exit 2 and
    print no result without the cards they need."""
    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "tools"))
    try:
        module = __import__(tool)
    finally:
        sys.path.pop(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [f"{tool}.py"])
    assert module.main() == 2
    assert capsys.readouterr().out == ""


def test_rank_script_imports_neither_jax_nor_the_conftest():
    """The rank processes stay free of JAX: importing the rank script's
    modules in a fresh interpreter loads no ``jax``."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['x']\n"
            f"runpy.run_path({os.path.join(HERE, 'torch_parallel_rank.py')!r},"
            " run_name='not_main')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'tpushare', 'conftest', 'tests')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": os.path.dirname(HERE)}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)
