"""Pipeline parallelism: the GPipe forward and the 1F1B training step over
a mesh axis, and the flagship LM through them.

Port of ``tpushare/workload/pipeline.py``. Layers split into n contiguous
stages; stage s lives only on rank s of the pipe axis (any axis of a
:class:`parallel.Mesh`: the reference pipelines over ``sp`` on a
(1, 1, n) mesh), and activations flow rank to rank by
:func:`collectives.shift` (``ppermute`` by +1), gradients back by
:func:`collectives.shift_back` (by -1).

* :func:`make_pipeline_fn`: the forward-only GPipe stream, M + n - 1
  ticks; outputs stay on the last stage (:func:`last_stage_output`).
* :func:`make_pipeline_train_fn`: the 1F1B step. F_r(i) runs at tick
  r + 2i and B_r(i) at tick 2n - 2 - r + 2i, over 2M + 2n - 3 ticks. At
  an F tick the stage runs under ``torch.no_grad()`` and its input goes
  to a stash of n slots; at a B tick the stage is recomputed from the
  stash on a detached input that requires grad, and
  ``torch.autograd.backward(y, g)`` accumulates the parameter gradients
  in ``.grad`` and leaves in the input's ``.grad`` the gradient to send
  back. The recompute is the pipeline's remat: nothing inside a stage is
  checkpointed again. The loss head runs on the last rank only, the
  embedding's backward on rank 0 only.

Where JAX runs the stage on every tick of its scan and masks the result,
a rank here computes only on its F and B ticks; the numbers are the
same. **Every rank issues every tick's pipe messages, in the same order,
bubble tick or not** (zeros where it has nothing), as ``ppermute`` does:
a rank that skipped one would leave its neighbour waiting forever. The
collectives inside a stage (the sp ring, the tp all-reduce pair) run
only on the ticks where the stage computes, which is safe because the
ranks of an sp or tp group share their pipe coordinate and so their
schedule. After the last tick, whose messages nothing would read, none
are sent.

Both calls are compiled steps (:mod:`graphs`), the twin of
``jax.jit(pipe_train)``: a rank's tick loop is host control flow, so its
capture unrolls it, every tick's messages and the in-stage collectives
included, in the eager call's order. On the card under an NCCL mesh each
rank replays one CUDA graph a call from its second call; under gloo, and
on the CPU, each call runs eagerly (``graphs.captures``). The 1F1B
graph's outputs are the loss and every parameter's gradient, cloned out
and set as ``.grad``.

Microbatch streams keep the reference's contract: no rank holds the
replicated stream. Rank h stores microbatches i = h (mod n) and the store
rotates one rank toward rank 0, the injector, after every F tick of rank
0 (every tick in the GPipe stream), so microbatch i reaches rank 0 at
its injection tick.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from tpushare_torch.utils.device import resolve_device
from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import graphs
from tpushare_torch.workload import model as M
from tpushare_torch.workload import parallel as par


def _check_stage_count(n_stages: int, mesh: par.Mesh, axis_name: str) -> None:
    if n_stages != mesh.size(axis_name):
        # Each rank keeps one stage: more stages than ranks would drop
        # some without an error.
        raise ValueError(
            f"pipeline over axis {axis_name!r} needs exactly "
            f"{mesh.size(axis_name)} stages (one per rank), got {n_stages}")


def stack_stage_params(per_stage: list):
    """Stack a list of identically-shaped per-stage trees (tensors, or
    dicts of them, nested alike) into one tree with a leading
    [n_stages] axis, the axis the pipe shards: the reference's
    ``stack_stage_params`` on dicts of tensors."""
    first = per_stage[0]
    if isinstance(first, dict):
        return {k: stack_stage_params([tree[k] for tree in per_stage])
                for k in first}
    return torch.stack(list(per_stage))


def stage_tree(stage: nn.ModuleList, n_stages: int = 1, leaf=None) -> dict:
    """The slice of the reference's stacked tree that ``stage`` holds, by
    block weight name: ``[n_stages, per_stage, *shape]`` tensors of
    ``leaf(name, parameter)`` (the parameter itself by default), where
    ``stage`` holds ``n_stages`` whole stages of blocks in order. Stage
    parameter ``"{i}.{w}"`` sits at ``[i // per_stage, i % per_stage]``
    of ``w``: a pipe rank's stage (``n_stages=1``) is its index's row,
    one process holding every block (``n_stages`` of the pipe) the whole
    tree. :func:`stage_blocks` is the inverse."""
    if not len(stage) or len(stage) % n_stages:
        raise ValueError(f"{len(stage)} blocks do not split into "
                         f"{n_stages} stages")
    leaf = leaf or (lambda name, p: p)
    per_stage = len(stage) // n_stages
    layers = stack_stage_params([
        {w: leaf(f"{i}.{w}", p) for w, p in blk.named_parameters()}
        for i, blk in enumerate(stage)])
    return {w: t.reshape((n_stages, per_stage) + t.shape[1:])
            for w, t in layers.items()}


def stage_blocks(stacked: dict) -> list[dict]:
    """The blocks of a stacked tree (leaves ``[n_stages, per_stage, ...]``
    by weight name), one dict a block, in layer order: block
    ``s * per_stage + j`` is ``stacked[w][s, j]``. With
    :func:`flagship_stage` one process builds the blocks that
    :func:`flagship_pipeline_reference` runs."""
    n_stages, per_stage = next(iter(stacked.values())).shape[:2]
    return [{w: t[s, j] for w, t in stacked.items()}
            for s in range(n_stages) for j in range(per_stage)]


def place_pipeline_params(stacked: dict, mesh: par.Mesh,
                          axis_name: str = "pp") -> nn.ParameterDict:
    """This rank's stage of ``stacked`` (a dict of [n_stages, ...]
    tensors): stage s on rank s of the pipe axis, and no other."""
    _check_stage_count(next(iter(stacked.values())).shape[0], mesh,
                       axis_name)
    idx = mesh.index(axis_name)
    return nn.ParameterDict({k: nn.Parameter(v[idx].clone())
                             for k, v in stacked.items()})


def pipeline_reference(stage_fn, stacked: dict,
                       x: torch.Tensor) -> torch.Tensor:
    """Single-device sequential application of every stage of ``stacked``:
    the numerics the pipeline must match."""
    for s in range(next(iter(stacked.values())).shape[0]):
        x = stage_fn({k: v[s] for k, v in stacked.items()}, x)
    return x


# --------------------------------------------------------------------------
# Round-robin microbatch streams
# --------------------------------------------------------------------------

def _stream_shard(x_mb: torch.Tensor, n: int) -> torch.Tensor:
    """[M, ...] -> [n, K, ...] with microbatch i at [i % n, i // n]
    (zero-padded when M % n != 0; padded slots are never injected)."""
    m = x_mb.shape[0]
    k = -(-m // n)
    if n * k > m:
        x_mb = torch.cat([x_mb, x_mb.new_zeros((n * k - m,)
                                               + x_mb.shape[1:])])
    return x_mb.reshape((k, n) + x_mb.shape[1:]).transpose(0, 1)


def _store(x_mb: torch.Tensor, n: int, idx: int) -> torch.Tensor:
    """Rank ``idx``'s share of the stream of ``x_mb``: [K, ...]."""
    return _stream_shard(x_mb, n)[idx].contiguous()


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors a stage (a module, or a dict of tensors or of such
    dicts) holds: what a compiled pipe call reads in place."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def _compiled_grads(name: str, call, modules, inputs: tuple, static: tuple,
                    mesh: par.Mesh):
    """``call(*inputs)``, which leaves every parameter's gradient in its
    ``.grad``, as one compiled step (:mod:`graphs`): the graph's outputs
    are the call's result and the gradients, which are set as ``.grad``
    again after a replay. Returns the result."""
    params = [p for mod in modules for p in _tensors(mod)]

    def body(*xs):
        return (call(*xs), *(p.grad for p in params))

    out, *grads = graphs.run(name, body, inputs, static=static,
                             bound=lambda: params, group="train", mesh=mesh)
    for p, g in zip(params, grads):
        p.grad = g
    return out


def _microbatches(x: torch.Tensor, m: int) -> torch.Tensor:
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} not divisible by "
                         f"{m} microbatches")
    return x.reshape((m, x.shape[0] // m) + x.shape[1:])


# --------------------------------------------------------------------------
# Forward-only pipeline
# --------------------------------------------------------------------------

def make_pipeline_fn(stage_fn, mesh: par.Mesh, axis_name: str = "pp",
                     n_microbatches: int = 4):
    """Build ``fn(stage, x) -> y`` running ``stage_fn(stage, x)`` as an
    n-stage forward pipeline over ``mesh.group(axis_name)``, under
    ``torch.no_grad()``.

    ``stage`` is this rank's stage (:func:`place_pipeline_params`); ``x``
    is the pipe's [batch, ...] input, batch divisible by
    ``n_microbatches``, of which this rank keeps only its share of the
    stream. F_r(i) runs at tick r + i. The result is [M, mb, ...], real
    on the last stage and zeros elsewhere: unwrap it there with
    :func:`last_stage_output`."""
    group = mesh.group(axis_name)
    n, idx = mesh.size(axis_name), mesh.index(axis_name)

    @torch.no_grad()
    def fn(stage, x: torch.Tensor) -> torch.Tensor:
        m = n_microbatches

        def body(x):
            x_mb = _microbatches(x, m)
            store = _store(x_mb, n, idx)
            outs = torch.zeros_like(x_mb)
            held = idle = torch.zeros_like(x_mb[0])
            for t in range(m + n - 1):
                y = idle
                if 0 <= t - idx < m:
                    y = stage_fn(stage, store[t // n] if idx == 0 else held)
                    if idx == n - 1:
                        outs[t - idx] = y
                if t == m + n - 2:
                    break
                held = C.shift(y, group)
                store = C.shift_back(store, group)
            return outs

        return graphs.run("pipe_gpipe", body, (x,), static=(fn,),
                          bound=lambda: _tensors(stage), group="train",
                          mesh=mesh)

    return fn


def last_stage_output(y_staged: torch.Tensor) -> torch.Tensor:
    """Collapse :func:`make_pipeline_fn`'s [M, mb, ...] result back to
    [batch, ...]; real on the last stage's rank only."""
    return y_staged.reshape((-1,) + y_staged.shape[2:])


# --------------------------------------------------------------------------
# 1F1B training pipeline
# --------------------------------------------------------------------------

class _Grads:
    """fp32 sums of the gradients of ``params`` over a call's ticks: each
    backward leaves its part in ``.grad``, which :meth:`drain` adds here
    and clears, so a bf16 weight's gradient is rounded once, at the end,
    not at every microbatch."""

    def __init__(self, params: list[torch.Tensor]):
        self.params = params
        self.sums = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in params]

    def drain(self) -> None:
        for p, acc in zip(self.params, self.sums):
            if p.grad is not None:
                acc += p.grad
                p.grad = None

    def reduce(self, group, extra=()) -> list[torch.Tensor]:
        """Sum the gradients and the fp32 tensors ``extra`` over ``group``
        in one all-reduce, and set each parameter's ``.grad`` (in its
        dtype). Returns the reduced ``extra``."""
        self.drain()
        parts = self.sums + list(extra)
        if dist.get_world_size(group) > 1:
            flat = C.all_reduce(torch.cat([t.flatten() for t in parts]),
                                group)
            parts = [g.view_as(t) for g, t in
                     zip(flat.split([t.numel() for t in parts]), parts)]
        for p, g in zip(self.params, parts):
            p.grad = g.to(p.dtype)
        return parts[len(self.params):]


def make_pipeline_train_fn(stage_fn, embed_fn, loss_fn, mesh: par.Mesh,
                           axis_name: str = "pp", n_microbatches: int = 8,
                           dp_axis: str | None = None,
                           sp_axis: str | None = None):
    """Build the 1F1B training step ``fn(stage, edge, tokens, targets) ->
    loss_sum``; each call sets ``.grad`` of every parameter of ``stage``
    (this rank's stage, an ``nn.Module``) and ``edge`` (an ``nn.Module``
    replicated on every rank) anew, summed over the microbatches in fp32
    and rounded to the parameter's dtype once.

    * ``stage_fn(stage, x) -> x``: one stage.
    * ``embed_fn(edge, tok_mb) -> x``: rank 0 only.
    * ``loss_fn(edge, y, tgt_mb) -> scalar loss sum``: the last rank only.
    * ``tokens``/``targets``: the global [batch, L] ints, alike on every
      rank, batch divisible by ``n_microbatches``.

    With ``dp_axis`` each dp row pipelines its share of every microbatch
    (the microbatch dim splits over dp); with ``sp_axis`` the sequence
    splits over sp and ``stage_fn`` attends across the shards itself
    (ring attention over ``sp_axis``). Stage gradients are all-reduced
    over dp × sp, the loss and the edge's gradients over pipe × dp × sp;
    neither over tp, whose ranks hold equal gradients of replicated
    weights and distinct shards of the rest. The loss comes back
    reduced.

    ``fn.stash_peak`` is the most stage inputs the rank held at once in
    its last eager call (a replay leaves it): at most n, whatever M.
    ``fn.eager`` is the call's body, which a compiled caller that adds
    to the step (:func:`make_flagship_pipeline`'s ``train_fn``) wraps."""
    group = mesh.group(axis_name)
    n, idx = mesh.size(axis_name), mesh.index(axis_name)
    data_axes = tuple(a for a in (dp_axis, sp_axis) if a is not None)
    stage_group = mesh.group(*data_axes)
    edge_group = mesh.group(axis_name, *data_axes)
    dp = mesh.size(dp_axis) if dp_axis else 1
    sp = mesh.size(sp_axis) if sp_axis else 1
    first, last = idx == 0, idx == n - 1

    def shard(x: torch.Tensor) -> torch.Tensor:
        """[M, mb, L] -> this rank's [M, mb/dp, L/sp]."""
        if dp_axis:
            x = x.chunk(dp, dim=1)[mesh.index(dp_axis)]
        if sp_axis:
            x = x.chunk(sp, dim=2)[mesh.index(sp_axis)]
        return x

    def eager(stage: nn.Module, edge: nn.Module, tokens: torch.Tensor,
              targets: torch.Tensor) -> torch.Tensor:
        m = n_microbatches
        mb = tokens.shape[0] // m
        if mb % dp:
            raise ValueError(f"microbatch size {mb} not divisible by dp "
                             f"axis {dp_axis!r} ({dp})")
        if tokens.shape[1] % sp:
            raise ValueError(f"sequence length {tokens.shape[1]} not "
                             f"divisible by sp axis {sp_axis!r} ({sp})")
        tok_st = _store(shard(_microbatches(tokens, m)), n, idx)
        tgt_st = _store(shard(_microbatches(targets, m)), n, idx)
        grads, edge_grads = (_Grads(list(mod.parameters()))
                             for mod in (stage, edge))
        for p in grads.params + edge_grads.params:
            p.grad = None
        with torch.no_grad():
            act0 = torch.zeros_like(embed_fn(edge, tok_st[0]))
        tgt0 = torch.zeros_like(tgt_st[0])
        held_act, held_tgt, held_grad = act0, tgt0, act0
        stash: list = [None] * n          # (stage input, tokens) by slot
        fn.stash_peak = 0
        loss_g = None
        loss_acc = torch.zeros((), dtype=torch.float32, device=act0.device)
        ticks = 2 * m + 2 * n - 3
        for t in range(ticks):
            y, tgt_in, dx = act0, tgt0, act0
            f, b = t - idx, t - (2 * n - 2 - idx)
            if f % 2 == 0 and 0 <= f // 2 < m:            # F_idx(f // 2)
                i = f // 2
                tok_in = None
                with torch.no_grad():
                    if first:
                        tok_in, tgt_in = tok_st[i // n], tgt_st[i // n]
                        x_in = embed_fn(edge, tok_in)
                    else:
                        x_in, tgt_in = held_act, held_tgt
                    y = stage_fn(stage, x_in)
                stash[i % n] = (x_in, tok_in)
                fn.stash_peak = max(fn.stash_peak,
                                    sum(s is not None for s in stash))
                if last:
                    y_l = y.detach().requires_grad_()
                    lval = loss_fn(edge, y_l, tgt_in)
                    torch.autograd.backward(lval)
                    edge_grads.drain()
                    loss_acc += lval.detach().float()
                    loss_g = y_l.grad
            if b % 2 == 0 and 0 <= b // 2 < m:            # B_idx(b // 2)
                i = b // 2
                x_b, tok_b = stash[i % n]
                stash[i % n] = None
                x_b = x_b.detach().requires_grad_()
                torch.autograd.backward(stage_fn(stage, x_b),
                                        loss_g if last else held_grad)
                grads.drain()
                dx = x_b.grad
                if first:
                    torch.autograd.backward(embed_fn(edge, tok_b), dx)
                    edge_grads.drain()
            if t == ticks - 1:
                break
            with torch.no_grad():
                held_act = C.shift(y, group)
                held_tgt = C.shift(tgt_in, group)
                held_grad = C.shift_back(dx, group)
                if t % 2 == 1:
                    tok_st = C.shift_back(tok_st, group)
                    tgt_st = C.shift_back(tgt_st, group)
        with torch.no_grad():
            grads.reduce(stage_group)
            (loss,) = edge_grads.reduce(edge_group, [loss_acc])
        return loss

    def fn(stage: nn.Module, edge: nn.Module, tokens: torch.Tensor,
           targets: torch.Tensor) -> torch.Tensor:
        return _compiled_grads(
            "pipe_1f1b", lambda tokens, targets: eager(stage, edge, tokens,
                                                       targets),
            (stage, edge), (tokens, targets), (fn,), mesh)

    fn.stash_peak = 0
    fn.eager = eager
    return fn


# --------------------------------------------------------------------------
# Flagship model through the pipe
# --------------------------------------------------------------------------

def _stage_positions(x: torch.Tensor, offset: int) -> torch.Tensor:
    """Rotary positions of a stage's [mb, L, d] activation shard whose
    first token sits at global position ``offset`` (the sp shard's)."""
    pos = offset + torch.arange(x.shape[1], device=x.device)
    return pos.expand(x.shape[:2])


def _flagship_blocks_apply(blocks, x: torch.Tensor, attn_fn=None,
                           offset: int = 0, tp=None) -> torch.Tensor:
    """Run flagship transformer blocks in order (rotary positions are
    static per microbatch: nothing rides the pipe but the activation).
    One definition for the pipe's stage and the sequential reference.
    With ``tp`` (the tensor-parallel group of tp-sharded blocks) each
    sublayer's partial output is all-reduced, ``model``'s pair."""
    attn_fn = attn_fn or M.causal_attention
    positions = _stage_positions(x, offset)
    for blk in blocks:
        x = M.ffn_block(blk, M.attention_block(blk, x, positions, attn_fn,
                                               tp), tp)
    return x


def _flagship_loss_sum(edge, y: torch.Tensor,
                       tgt: torch.Tensor) -> torch.Tensor:
    """Final norm + tied-lm-head fp32 logits + summed token cross-entropy
    (the pipe's loss head and the reference's)."""
    x = M.rms_norm(y, edge["final_norm"])
    logits = (x @ edge["embed"].T).float()
    return F.cross_entropy(logits.flatten(0, 1), tgt.flatten(),
                           reduction="sum")


def _embed(edge, tok: torch.Tensor) -> torch.Tensor:
    return edge["embed"][tok]


def _block(tensors: dict) -> M.Block:
    """A block holding ``tensors`` (by weight name) as its parameters."""
    skeleton = M.ModelConfig(vocab_size=1, d_model=8, n_heads=1, d_ff=1,
                             n_layers=1)
    blk = M.Block(skeleton, torch.device("meta"))
    for key, t in tensors.items():
        setattr(blk, key, nn.Parameter(t))
    return blk


def flagship_stage(blocks: list[dict], mesh: par.Mesh | None = None,
                   tp_axis: str | None = None) -> nn.ModuleList:
    """A stage of flagship blocks from their full weights (a dict by
    weight name, one a layer): with ``tp_axis``, this rank's share of the
    heads and of the ffn's hidden axis (``parallel.TP_AXIS``) under
    ``mesh``."""
    tp = mesh.size(tp_axis) if tp_axis else 1
    tp_idx = mesh.index(tp_axis) if tp_axis else 0

    def part(key, t):
        axis = par.TP_AXIS.get(key)
        if axis is not None and tp > 1:
            t = t.chunk(tp, dim=axis)[tp_idx]
        return t.clone()

    return nn.ModuleList(_block({k: part(k, t) for k, t in blk.items()})
                         for blk in blocks)


def flagship_edge(embed: torch.Tensor,
                  final_norm: torch.Tensor) -> nn.ParameterDict:
    """The edge: tied embedding + final norm, whole on every rank."""
    return nn.ParameterDict({"embed": nn.Parameter(embed.clone()),
                             "final_norm": nn.Parameter(final_norm.clone())})


def make_flagship_pipeline(cfg: M.ModelConfig, mesh: par.Mesh,
                           axis_name: str = "pp", n_microbatches: int = 8,
                           dp_axis: str | None = None,
                           tp_axis: str | None = None, attn_fn=None,
                           sp_axis: str | None = None,
                           sp_flash: bool | None = None, *,
                           device: str | torch.device = "cuda"):
    """Wire the flagship transformer LM through the 1F1B pipe. Returns
    ``(init_fn, train_fn)``:

    * ``init_fn(generator) -> (stage, edge)``: the full weights drawn from
      ``generator`` as ``model.init_params`` draws them, of which this
      rank keeps its stage's ``cfg.n_layers / n_stages`` blocks (their tp
      shard under ``tp_axis``) and the edge;
    * ``train_fn(stage, edge, tokens, targets) -> mean loss``, with the
      gradients of the mean in every parameter's ``.grad``.

    Attention inside the stages: ``attn_fn`` (default
    ``flash_attention.best_attn_fn(device)``, the kernel-backed flash
    attention on the card); or, with ``sp_axis``, ring attention over
    that axis, its per-step op the flash kernels with ``sp_flash`` (the
    default on the card; the plain ring on the CPU).
    ``sp_axis`` and ``attn_fn`` exclude each other: the ring owns the
    cross-shard mask. Stages never checkpoint (``cfg.remat`` picks
    nothing): the pipe's B-tick recompute is the remat."""
    dev = resolve_device(device)
    n_stages = mesh.size(axis_name)
    if cfg.n_layers % n_stages:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by "
                         f"{n_stages} pipeline stages")
    per_stage = cfg.n_layers // n_stages
    tp = None
    if tp_axis is not None:
        t = mesh.size(tp_axis)
        if cfg.n_heads % t or cfg.d_ff % t:
            raise ValueError(
                f"tensor parallelism over {tp_axis!r} ({t}) needs n_heads "
                f"({cfg.n_heads}) and d_ff ({cfg.d_ff}) divisible by it")
        tp = mesh.group(tp_axis) if t > 1 else None
    offset_of = None
    if sp_axis is not None:
        if attn_fn is not None:
            raise ValueError("sp_axis composes ring attention into the "
                             "stages; attn_fn= would bypass the cross-shard "
                             "mask: pass one or the other")
        ring_group = mesh.group(sp_axis)
        use_flash = dev.type == "cuda" if sp_flash is None else sp_flash
        ring = par.ring_flash_attention if use_flash else par.ring_attention

        def attn_fn(q, k, v):
            return ring(q, k, v, ring_group)

        def offset_of(x):
            return mesh.index(sp_axis) * x.shape[1]
    elif attn_fn is None:
        attn_fn = FA.best_attn_fn(dev)

    def stage_fn(stage, x):
        return _flagship_blocks_apply(stage, x, attn_fn,
                                      offset_of(x) if offset_of else 0, tp)

    pipe = make_pipeline_train_fn(stage_fn, _embed, _flagship_loss_sum, mesh,
                                  axis_name=axis_name,
                                  n_microbatches=n_microbatches,
                                  dp_axis=dp_axis, sp_axis=sp_axis)
    idx = mesh.index(axis_name)

    def init_fn(generator: torch.Generator):
        params = M.init_params(generator, cfg, dev)
        blocks = [{k: p.detach() for k, p in blk.named_parameters()}
                  for blk in params.blocks[idx * per_stage:
                                           (idx + 1) * per_stage]]
        return (flagship_stage(blocks, mesh, tp_axis),
                flagship_edge(params.embed.detach(),
                              params.final_norm.detach()))

    def train_fn(stage, edge, tokens, targets):
        def call(tokens, targets):
            loss = pipe.eager(stage, edge, tokens, targets)
            scale = 1.0 / tokens.numel()
            with torch.no_grad():
                for p in [*stage.parameters(), *edge.parameters()]:
                    p.grad.mul_(scale)
            return loss * scale

        return _compiled_grads("pipe_1f1b", call, (stage, edge),
                               (tokens, targets), (train_fn,), mesh)

    # The stage and its pipe, for a GPipe stream over the same stages.
    train_fn.stage_fn, train_fn.pipe = stage_fn, pipe
    return init_fn, train_fn


def flagship_pipeline_reference(cfg: M.ModelConfig, blocks, edge,
                                tokens: torch.Tensor,
                                targets: torch.Tensor) -> torch.Tensor:
    """Single-device flagship forward + mean token cross-entropy with the
    pipe's own helpers, every block in order: what
    :func:`make_flagship_pipeline`'s train_fn must match. ``blocks`` is
    every block in order, e.g. ``flagship_stage(stage_blocks(stacked))``
    of a stacked tree."""
    x = _flagship_blocks_apply(blocks, _embed(edge, tokens))
    return _flagship_loss_sum(edge, x, targets) / tokens.numel()
