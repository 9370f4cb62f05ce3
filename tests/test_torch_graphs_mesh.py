"""The port's compiled sharded steps (``graphs.run`` under a mesh) on the
CPU: gangs of 2 and 4 gloo ranks (``tests/torch_graphs_mesh_rank.py``,
started by ``tpushare_torch.runtime.launch``) drive the sharded train
step ((1,1,2) ring and Ulysses, (1,2,1), (2,1,1), and (1,2,2) ring on
four), ``generate(mesh=)`` ((1,2,1) and (2,2,1), greedy and sampled), the
flagship 1F1B pipe and the GPipe forward on (1,1,1,2) and the ring-MoE's
value and gradient over sp = 2, each through a stand-in for capture
(``graphs.STAND_IN``), 3 compiled calls against 3 eager ones from the same
init, bit for bit. Each case's first step is held to the JAX package's
sharded step on host devices at the tolerances
``tests/test_torch_parallel.py``, ``tests/test_torch_pipeline.py`` and
``tests/test_torch_moe.py`` use, and the registry's accounting (one miss
a key, the replays, each rank's stats alike, launches as designed) is
checked. The backend rule's truth table is a unit test."""

import dataclasses
import os
import pickle
import subprocess
import sys
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tests import torch_graphs_mesh_rank as R
from tests.test_torch_moe import GRAD_TOL as MOE_GRAD_TOL
from tests.test_torch_moe import OUT_TOL as MOE_OUT_TOL
from tests.test_torch_parallel import GRAD_TOL as GRAD_TOL_STEP
from tests.test_torch_parallel import LOSS_TOL
from tests.test_torch_pipeline import FWD_TOL, GRAD_TOL, LOSS_RTOL
from tpushare.workload import model as JM
from tpushare.workload import moe as jmoe
from tpushare.workload import parallel as jpar
from tpushare.workload import pipeline as jpp
from tpushare.workload import serving as JS
from tpushare.workload import train as JT
from tpushare_torch import entry as E
from tpushare_torch.runtime import launch
from tpushare_torch.workload import convert
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import moe
from tpushare_torch.workload import parallel as par

HERE = os.path.dirname(os.path.abspath(__file__))
GANG_DEADLINE_S = 600
#: The pipe's kernels' code path (flash attention's plain version in the
#: stages) against JAX's plain attention: tests/test_torch_pipeline.py's
#: tolerance for the kernels' code path in the stages.
PIPE_TOL = "kernel_sp"
NICE_REFERENCES = (
    "import os, sys; os.nice(19); sys.path.insert(0, {root!r}); "
    "from tests import test_torch_graphs_mesh as t; "
    "t.save_references(sys.argv[1])")


def _mesh(shape):
    return par.Mesh(*shape[:3], 0, {}, *shape[3:])


def _jax_cfg(shape, **changes):
    cfg = dataclasses.replace(R.config(_mesh(shape)), **changes)
    return JM.ModelConfig(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                          n_heads=cfg.n_heads, n_layers=cfg.n_layers,
                          d_ff=cfg.d_ff, max_seq_len=cfg.max_seq_len,
                          dtype=jnp.float32, remat=cfg.remat), cfg


def _port_tree(cfg, seed):
    """The weights a rank draws (``entry.dryrun_generator(seed)``) in the
    JAX package's layout."""
    return jax.tree_util.tree_map(jnp.asarray, convert.params_to_numpy(
        M.init_params(E.dryrun_generator(seed), cfg, "cpu")))


def _flat(tree):
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(x, np.float32)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_train(shape, attention):
    """The JAX package's sharded loss and gradients on the case's mesh
    from the rank's weights and batch, as tests/test_torch_parallel.py
    takes them from its (2, 2, 2) step: ``value_and_grad`` of its
    ``loss_fn`` with the strategy's attention, jitted under the mesh."""
    jcfg, cfg = _jax_cfg(shape)
    tokens, targets = (jnp.asarray(t.numpy().astype(np.int32))
                       for t in R.batch(_mesh(shape), cfg))
    mesh = jpar.make_mesh(*shape)
    params = _port_tree(cfg, 0)
    with mesh:
        attn = (jpar.make_ulysses_attn_fn if attention == "ulysses"
                else jpar.make_ring_attn_fn)(mesh)
        placed = jax.device_put(params, jpar.param_shardings(mesh, params))
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: JT.loss_fn(p, tokens, targets, jcfg,
                                 attn_fn=attn)))(placed)
    return {"loss": float(loss), "grads": _flat(jax.device_get(grads))}


def _jax_generate(shape):
    """JAX's greedy ``generate`` with the weights sharded over the case's
    dp x tp mesh."""
    jcfg, cfg = _jax_cfg(shape, n_layers=2, remat=False)
    params = _port_tree(cfg, 4)
    prompts = jnp.asarray(torch.randint(
        0, cfg.vocab_size, (2 * shape[0], R.PROMPT),
        generator=E.dryrun_generator(5)).numpy().astype(np.int32))
    mesh = jpar.make_mesh(*shape)
    with mesh:
        placed = jax.device_put(params, jpar.param_shardings(mesh, params))
        stream = JS.generate(placed, prompts, jcfg, n_new=R.N_NEW,
                             max_len=R.MAX_LEN)
    return np.asarray(stream)


def _jax_pipe(shape):
    """JAX's flagship 1F1B pipe over two pp devices from the rank's
    weights (its loss and gradients), and its GPipe forward of the same
    stages (the last stage's hidden states)."""
    jcfg, cfg = _jax_cfg(shape, n_layers=R.PIPE_LAYERS, remat=False)
    tree = _port_tree(cfg, 0)
    per = R.PIPE_LAYERS // shape[3]
    stacked = {k: jnp.stack([b[k] for b in tree["blocks"]]).reshape(
        (shape[3], per) + tree["blocks"][0][k].shape)
        for k in tree["blocks"][0]}
    edge = {"embed": tree["embed"], "final_norm": tree["final_norm"]}
    rows = torch.randint(0, cfg.vocab_size, (R.CALLS, R.PIPE_ROWS,
                                             cfg.max_seq_len),
                         generator=E.dryrun_generator(1))
    tokens = jnp.asarray(rows[0].numpy().astype(np.int32))
    mesh = JMesh(np.array(jax.devices()[:shape[3]]), ("pp",))
    _, train_fn = jpp.make_flagship_pipeline(jcfg, mesh, axis_name="pp",
                                             n_microbatches=R.PIPE_M)
    fwd = jpp.make_pipeline_fn(
        lambda st, x: jpp._flagship_blocks_apply(st, x), mesh,
        axis_name="pp", n_microbatches=R.PIPE_M)
    with mesh:
        placed = jpp.place_pipeline_params(stacked, mesh, "pp")
        loss, g_stacked, g_edge = jax.jit(train_fn)(
            placed, edge, tokens, jnp.roll(tokens, -1, axis=1))
        staged = jax.jit(fwd)(placed, edge["embed"][tokens])
    return {"loss": float(loss),
            "grads": {k: np.asarray(g, np.float32)
                      for k, g in {**g_stacked, **g_edge}.items()},
            "gpipe": np.asarray(jpp.last_stage_output(staged))}


def _jax_moe(shape):
    """JAX's ring-MoE over sp: the mean of y² and its gradients, jitted
    as the reference dry run takes them, on the rank's weights and first
    batch."""
    _, cfg = _jax_cfg(shape)
    _, (rows, seq) = E.dryrun_config("tiny", _mesh(shape))
    params = {k: jnp.asarray(v.numpy()) for k, v in moe.init_moe_params(
        E.dryrun_generator(2), cfg.d_model, cfg.d_ff, 2 * shape[2],
        "cpu").items()}
    x = jnp.asarray(torch.randn((R.CALLS, rows, seq, cfg.d_model),
                                generator=E.dryrun_generator(3))[0].numpy())
    mesh = jpar.make_mesh(*shape)
    fn = jmoe.make_ring_moe_fn(mesh, axis_name="sp")
    with mesh:
        placed = jmoe.place_moe_params(params, mesh)
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jnp.mean(fn(p, x) ** 2)))(placed)
        y = jax.jit(fn)(placed, x)
    return {"loss": float(loss), "y": np.asarray(y),
            "grads": {k: np.asarray(g) for k, g in grads.items()}}


def save_references(path):
    """Every case's JAX reference, pickled to ``path``: run by
    :func:`runs` in a subprocess at the lowest priority."""
    refs = {}
    for world, cases in R.CASES.items():
        for name, shape in cases.items():
            key = f"{world}/{name}"
            if name.startswith("train"):
                refs[key] = _jax_train(shape, "ulysses" if "ulysses" in name
                                       else "ring")
            elif name == "generate":
                refs[key] = _jax_generate(shape)
            elif name == "pipe":
                refs[key] = _jax_pipe(shape)
            else:
                refs[key] = _jax_moe(shape)
    with open(path, "wb") as f:
        pickle.dump(refs, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both gangs' (rank records, rank 0's arrays), by gang size, and the
    JAX references, made side by side at the lowest priority."""
    tmp = tmp_path_factory.mktemp("graphs_mesh")
    root = os.path.dirname(HERE)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p)}
    refs = subprocess.Popen(
        [sys.executable, "-c", NICE_REFERENCES.format(root=root),
         str(tmp / "refs.pkl")], env=env)
    gangs, errors = {}, []

    def gang(world):
        try:
            out = tmp / f"out{world}.npz"
            gangs[world] = launch.launch(
                [os.path.join(HERE, "torch_graphs_mesh_rank.py"), str(out),
                 f"file://{tmp / f'rendezvous{world}'}"], world,
                deadline_s=GANG_DEADLINE_S, env={"OMP_NUM_THREADS": "1"})
        except Exception as exc:             # noqa: BLE001 (re-raised)
            errors.append(exc)

    threads = [threading.Thread(target=gang, args=(w,)) for w in R.CASES]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        assert refs.wait(timeout=GANG_DEADLINE_S) == 0
    finally:
        if refs.poll() is None:
            refs.kill()
            refs.wait()
    with open(tmp / "refs.pkl", "rb") as f:
        references = pickle.load(f)
    return {world: (gangs[world], dict(np.load(tmp / f"out{world}.npz")))
            for world in R.CASES}, references


CASES = [(world, name) for world, cases in R.CASES.items() for name in cases]
#: The graphs each case compiles, with its misses and replays: one miss a
#: key (the sampled ``generate`` is a key of its own), a replay for each
#: call after a key's first.
GRAPHS = {"train": {"train_step": (1, 2)},
          "generate": {"generate": (2, 4)},
          "pipe": {"pipe_1f1b": (1, 2), "pipe_gpipe": (1, 2)},
          "moe": {"moe_value_and_grad": (1, 2)}}


def _records(runs, world, name):
    gangs, _ = runs
    return [r["cases"][name] for r in gangs[world][0]]


@pytest.mark.parametrize("world,name", CASES)
def test_compiled_calls_are_the_eager_calls_bit_for_bit(runs, world, name):
    """On every rank the 3 compiled calls (the key's eager first call,
    then replays of the stand-in's capture) give the eager calls' results
    from the same init, bit for bit: losses, weights and AdamW moments,
    streams and draws, gradients, hidden states, MoE outputs."""
    for rank, rec in enumerate(_records(runs, world, name)):
        assert rec["bit_identical"], (rank, rec)
        assert rec["backend"] == "gloo" and not rec["captures_here"]


@pytest.mark.parametrize("world,name", CASES)
def test_one_miss_a_key_and_every_rank_alike(runs, world, name):
    """Each compiled step missed once a key and replayed every later
    call, and every rank's registry holds the same stats and captured
    the same growth: the ranks miss, capture and replay together."""
    recs = _records(runs, world, name)
    want = GRAPHS[name.split("_")[0]]
    stats = recs[0]["stats"]
    assert {k: (s["misses"], s["replays"]) for k, s in stats.items()} \
        == want
    assert all(r["stats"] == stats and r["captured"] == recs[0]["captured"]
               for r in recs)


def _design(name, world, cfg_layers):
    """Launches a call, by the design phase 5d and 5e hold on the card:
    ring 2·L·sp / L·sp / L·sp (remat), Ulysses 2·L / L / L, a prefill L
    forwards, 1F1B 2·k·M / k·M / k·M, GPipe k·M, the MoE none."""
    shape = R.CASES[world][name]
    sp = shape[2]
    if name == "train_ulysses":
        return [2 * cfg_layers, cfg_layers, cfg_layers]
    if name.startswith("train"):
        return [2 * cfg_layers * sp, cfg_layers * sp, cfg_layers * sp]
    if name == "pipe":
        k = R.PIPE_LAYERS // shape[3]
        return [2 * k * R.PIPE_M, k * R.PIPE_M, k * R.PIPE_M]
    return [0, 0, 0]


@pytest.mark.parametrize("world,name", [c for c in CASES
                                        if c[1] != "generate"])
def test_launches_as_designed(runs, world, name):
    """Every call launched each kernel (the plain versions, counted as
    the kernels' wrappers count) as the design says, the key's first
    call and the replays alike, and the replays' launches in the stats
    are the captures' recorded growth times the replays."""
    layers = R.config(_mesh(R.CASES[world][name])).n_layers
    want = _design(name, world, layers)
    for rec in _records(runs, world, name):
        per_call = rec.get("launches_per_step") or rec.get(
            "launches_per_call") or [want] * R.CALLS
        assert per_call == [want] * R.CALLS
        for graph, (_, replays) in GRAPHS[name.split("_")[0]].items():
            growth = [g for n, g in rec["captured"] if n == graph]
            booked = rec["stats"][graph]["launches"]
            assert [booked[c] for c in graphs.COUNTERS] == [
                replays * x for x in growth[0]]
        if name == "pipe":
            k = R.PIPE_LAYERS // R.CASES[world][name][3]
            assert rec["gpipe_launches"] == [[k * R.PIPE_M, 0, 0]] * R.CALLS
            assert 0 < rec["stash_peak"] <= R.CASES[world][name][3]


@pytest.mark.parametrize("world", [w for w in R.CASES
                                   if "generate" in R.CASES[w]])
def test_generate_launches_a_prefill_and_samples_alike(runs, world):
    """A compiled ``generate`` launches the forward once a layer a
    request (its prefill), a sampled graph replays other draws for
    another generator, and every rank holds the same sampled streams."""
    layers = 2
    for rec in _records(runs, world, "generate"):
        growth = [g for n, g in rec["captured"] if n == "generate"]
        assert growth == [[layers, 0, 0]] * 2
        assert rec["sampled_differs"] and rec["ranks_agree"]


@pytest.mark.parametrize("world,name", [c for c in CASES
                                        if c[1].startswith("train")])
def test_first_step_matches_the_jax_sharded_step(runs, world, name):
    """The first compiled step's loss and gathered gradients against the
    JAX package's sharded ones on the same mesh of host devices, at
    tests/test_torch_parallel.py's fp32 bounds (loss relative,
    gradients normalized)."""
    gangs, refs = runs
    got, ref = gangs[world][1], refs[f"{world}/{name}"]
    loss = float(got[f"{name}/loss"])
    assert abs(loss - ref["loss"]) <= LOSS_TOL["float32"] * abs(ref["loss"])
    assert set(ref["grads"]) == {k[len(name) + 6:] for k in got
                                 if k.startswith(f"{name}/grad/")}
    for n, g in ref["grads"].items():
        err = np.max(np.abs(got[f"{name}/grad/{n}"] - g)) / np.max(
            np.abs(g))
        assert err <= GRAD_TOL_STEP["float32"], (n, err)


@pytest.mark.parametrize("world", [w for w in R.CASES
                                   if "generate" in R.CASES[w]])
def test_generate_matches_jax_token_for_token(runs, world):
    """The greedy tp stream, compiled, is JAX's on the same dp x tp
    mesh token for token (fp32)."""
    gangs, refs = runs
    np.testing.assert_array_equal(gangs[world][1]["generate/stream"],
                                  refs[f"{world}/generate"])


def test_pipe_matches_the_jax_pipe(runs):
    """The compiled 1F1B call's loss and gradients, and the compiled
    GPipe forward's last-stage hidden states, against JAX's pipe on two
    pp devices, at tests/test_torch_pipeline.py's tolerances for the
    kernels' code path in the stages."""
    gangs, refs = runs
    got, ref = gangs[2][1], refs["2/pipe"]
    assert abs(float(got["pipe/loss"]) - ref["loss"]) <= \
        LOSS_RTOL[PIPE_TOL] * abs(ref["loss"])
    rtol, atol = GRAD_TOL[PIPE_TOL]
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(got[f"pipe/grad/{k}"], g, rtol=rtol,
                                   atol=atol, err_msg=k)
    np.testing.assert_allclose(got["pipe/gpipe"], ref["gpipe"], rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_moe_matches_the_jax_value_and_grad(runs):
    """The compiled ring-MoE's loss, output and gradients against JAX's
    jitted value and gradient over sp, at tests/test_torch_moe.py's
    tolerances."""
    gangs, refs = runs
    got, ref = gangs[2][1], refs["2/moe"]
    assert abs(float(got["moe/loss"]) - ref["loss"]) <= \
        MOE_OUT_TOL * abs(ref["loss"])
    np.testing.assert_allclose(got["moe/y"], ref["y"], rtol=MOE_OUT_TOL,
                               atol=MOE_OUT_TOL)
    for k, g in ref["grads"].items():
        np.testing.assert_allclose(got[f"moe/grad/{k}"], g,
                                   rtol=MOE_GRAD_TOL, atol=MOE_GRAD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("world", list(R.CASES))
def test_a_capture_must_issue_its_warm_ups_collectives(runs, world):
    """A body whose capture issues a collective its warm-up did not is
    refused on every rank: the warm-up made the communicators."""
    for rec in runs[0][world][0]:
        assert "other collectives than its warm-up" in rec["uneven"]
        assert rec["gloo_collective_trace"][0][0] == "all_reduce"


# --------------------------------------------------------------------------
# The backend rule, without a gang
# --------------------------------------------------------------------------

@pytest.mark.parametrize("device,backend,want", [
    ("cuda", "nccl", "capture"), ("cuda", None, "capture"),
    ("cuda", "gloo", "eager"), ("cpu", "gloo", "stand_in"),
    ("cpu", None, "stand_in")])
def test_backend_rule(monkeypatch, device, backend, want):
    """NCCL on the card: captured, with the capture mode that holds
    collectives; one card without a mesh: captured; gloo on the card:
    eager; the CPU: the stand-in (eager where none is set). The rule
    reads the groups' backend, nothing else."""
    stand_in = object()
    monkeypatch.setattr(graphs, "STAND_IN", stand_in)
    mesh = None if backend is None else types.SimpleNamespace(
        backend=backend)
    dev = torch.device(device)
    got = graphs._backend(dev, mesh)
    assert graphs.captures(dev, mesh) == (want == "capture")
    if want == "capture":
        assert isinstance(got, graphs._CudaGraphs)
        assert got.mode == ("global" if mesh is None else "thread_local")
    else:
        assert got is (stand_in if want == "stand_in" else None)


class _OnCard:
    """An input that says it lies on the card: what ``graphs.run`` reads
    of its inputs (device, shape, dtype)."""
    device = torch.device("cuda")
    shape = (2,)
    dtype = torch.float32


def test_a_gloo_mesh_on_the_card_keeps_no_graph(monkeypatch):
    """Under a gloo mesh on the card the registry counts the key's miss
    and every call runs the body eagerly; nothing is captured."""
    mesh = types.SimpleNamespace(backend="gloo", shape={"dp": 1, "tp": 1,
                                                         "sp": 2},
                                 coords=(0, 0, 1))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    calls = []
    try:
        for _ in range(3):
            graphs.run("gloo_mesh", lambda t: calls.append(t) or t,
                       (_OnCard(),), mesh=mesh)
        assert len(calls) == 3
        assert graphs.stats()["gloo_mesh"]["misses"] == 1
        assert graphs.stats()["gloo_mesh"]["replays"] == 0
        assert graphs.cache_size("gloo_mesh") == 1
        assert not graphs.CAPTURES
    finally:
        graphs.clear()


def test_the_mesh_reads_its_groups_backend(monkeypatch):
    """``Mesh.backend`` is the groups' one backend, read once; a hand-made
    mesh without groups has none; groups of two backends raise."""
    seen = []
    monkeypatch.setattr(par.dist, "get_backend",
                        lambda g: seen.append(g) or g[0])
    mesh = par.Mesh(1, 1, 2, 0, {frozenset(): ("nccl",),
                                 frozenset({"sp"}): ("nccl",)})
    assert mesh.backend == "nccl" and mesh.backend == "nccl"
    assert len(seen) == 2
    assert _mesh((1, 1, 1)).backend is None
    mixed = par.Mesh(1, 1, 2, 0, {frozenset(): ("nccl",),
                                  frozenset({"sp"}): ("gloo",)})
    with pytest.raises(ValueError, match="one backend"):
        mixed.backend
