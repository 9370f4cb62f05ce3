"""Parallelism layer: a (dp, tp, sp, pp) mesh of ranks, the tp sharding of
the weights (and the global view of a rank's shards that a checkpoint
writes), and ring and Ulysses attention over sp.

Port of ``tpushare/workload/parallel.py``. Each rank is one process of a
gang (``torchenv.init_distributed``) and holds its own shard:

* ``dp``: data parallel (batch axis; the train step all-reduces
  gradients);
* ``tp``: tensor parallel (the head axis of the attention weights and the
  hidden axis of the ffn's; :func:`shard_params`);
* ``sp``: sequence parallel (the sequence axis of the activations;
  attention runs as a ring over ``sp``, :func:`ring_flash_attention`, or
  re-shards heads with two all-to-alls, :func:`ulysses_attention`);
* ``pp``: pipeline parallel (contiguous layers a stage;
  :mod:`pipeline`).

Where the JAX package writes one program for the mesh and lets
``shard_map`` and GSPMD place the collectives, each rank here runs its
shard's program and calls the collectives itself
(:mod:`collectives`): the ring's shift, the all-to-all, and the pair of
all-reduces around each tensor-parallel product (:mod:`model`).

The ring-latency model (the JAX package's ``hop_time_us`` and the three
functions that compose it) prices a placement's collectives in
milliseconds; here its hops are NVLink through NVSwitch inside a node and
the NIC across nodes.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from tpushare_torch.workload import collectives as C
from tpushare_torch.workload import flash_attention as FA
from tpushare_torch.workload import model as M


# --------------------------------------------------------------------------
# Mesh construction
# --------------------------------------------------------------------------

#: The mesh's axes, in the order ranks fill it (row-major, as the
#: reference reshapes its devices for ``("dp", "tp", "sp", "pp")``).
AXES = ("dp", "tp", "sp", "pp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (dp, tp, sp, pp) mesh and the process groups
    it belongs to.

    ``group(*axes)`` is the group of the ranks that differ from this one
    only along ``axes``: ``group("tp")``, ``group("sp")``, the dp × sp
    group over which the train step reduces gradients, the pipe axis of a
    pipeline (``pipeline.py``), which may be any axis, as the reference
    pipelines over ``sp`` on a (1, 1, n) mesh. A mesh without a pipe axis
    (``pp == 1``) has the axes ("dp", "tp", "sp") alone, in ``shape``
    and ``coords``.

    :attr:`backend` is what every group rides on. It decides whether a
    compiled step under this mesh is captured (``graphs.captures``):
    NCCL's collectives are stream work a CUDA graph can hold, gloo's go
    through the host.

    A small class rather than ``torch.distributed.device_mesh.DeviceMesh``:
    the gradient reductions need groups over two or three axes, which a
    DeviceMesh offers only by flattening its dimensions (a private method
    in the torch versions the port runs on), and nothing else of the port
    needs more than the groups and the coordinates."""

    dp: int
    tp: int
    sp: int
    rank: int
    groups: dict
    pp: int = 1

    @functools.cached_property
    def backend(self) -> str | None:
        """The groups' one backend (``dist.get_backend`` of each, read
        once); None for a mesh without groups (built by hand). Groups of
        several backends raise."""
        backends = {dist.get_backend(g) for g in self.groups.values()}
        if len(backends) > 1:
            raise ValueError(f"the mesh's groups ride on {sorted(backends)}; "
                             f"a mesh has one backend")
        return backends.pop() if backends else None

    @property
    def axes(self) -> tuple[str, ...]:
        return AXES if self.pp > 1 else AXES[:3]

    @property
    def shape(self) -> dict[str, int]:
        return {axis: self.size(axis) for axis in self.axes}

    def size(self, axis: str) -> int:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}; the axes are "
                             f"{AXES}")
        return getattr(self, axis)

    def _coords(self) -> tuple[int, int, int, int]:
        rest, out = self.rank, []
        for axis in reversed(AXES):
            rest, i = divmod(rest, self.size(axis))
            out.append(i)
        return tuple(reversed(out))

    @property
    def coords(self) -> tuple[int, ...]:
        """Coordinates along ``axes``; ranks fill the mesh in row-major
        order, as the reference reshapes its device list."""
        return self._coords()[:len(self.axes)]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``, its rank in
        ``group(axis)``."""
        return self._coords()[AXES.index(axis)]

    def group(self, *axes: str):
        """The process group of the ranks that differ from this one only
        along ``axes`` (axes of size 1 add nothing; with none left, this
        rank alone)."""
        return self.groups[frozenset(a for a in axes if self.size(a) > 1)]

    dp_rank = property(lambda self: self.index("dp"))
    tp_rank = property(lambda self: self.index("tp"))
    sp_rank = property(lambda self: self.index("sp"))
    pp_rank = property(lambda self: self.index("pp"))
    dp_group = property(lambda self: self.group("dp"))
    tp_group = property(lambda self: self.group("tp"))
    sp_group = property(lambda self: self.group("sp"))
    grad_group = property(lambda self: self.group("dp", "sp"))


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, pp: int = 1) -> Mesh:
    """Build a (dp, tp, sp, pp) mesh over the gang (``torch.distributed``
    initialized, with exactly ``dp * tp * sp * pp`` ranks), with a group
    for every set of its axes of size > 1 (:meth:`Mesh.group`). Every
    rank creates every group, in the same order, as ``new_group``
    requires."""
    sizes = (dp, tp, sp, pp)
    need = math.prod(sizes)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"mesh {'x'.join(map(str, sizes))} needs {need} "
                         f"ranks, the gang has {world}")
    rank = dist.get_rank()
    grid = torch.arange(need).reshape(sizes)
    live = [i for i, n in enumerate(sizes) if n > 1]
    groups = {}
    for r in range(len(live) + 1):
        for subset in itertools.combinations(live, r):
            others = [i for i in range(len(sizes)) if i not in subset]
            width = math.prod(sizes[i] for i in subset)
            key = frozenset(AXES[i] for i in subset)
            for line in grid.permute(*others, *subset).reshape(
                    -1, width).tolist():
                group = dist.new_group(line)
                if rank in line:
                    groups[key] = group
    return Mesh(dp, tp, sp, rank, groups, pp)


def auto_mesh_shape(n: int) -> tuple[int, int, int]:
    """Factor ``n`` ranks into a balanced (dp, tp, sp) shape."""
    best = (n, 1, 1)
    best_score = None
    for tp in range(1, n + 1):
        if n % tp:
            continue
        rest = n // tp
        for sp in range(1, rest + 1):
            if rest % sp:
                continue
            dp = rest // sp
            score = abs(math.log(max(dp, 1)) - math.log(max(tp, 1))) + \
                abs(math.log(max(tp, 1)) - math.log(max(sp, 1)))
            if best_score is None or score < best_score:
                best, best_score = (dp, tp, sp), score
    return best


# --------------------------------------------------------------------------
# Sharding rules (params + activations)
# --------------------------------------------------------------------------

#: The axis tp splits, by block weight (the reference's ``param_spec``):
#: heads of ``wqkv [d, 3, H, hd]`` and ``wo [H, hd, d]``, the hidden axis
#: of ``w_gate``/``w_up [d, ff]`` and ``w_down [ff, d]``. ``embed`` and the
#: norms are replicated.
TP_AXIS = {"wqkv": 2, "wo": 0, "w_gate": 1, "w_up": 1, "w_down": 0}


def _tp_axis(name: str) -> int | None:
    return TP_AXIS.get(name.rpartition(".")[2])


def _module_of(params: M.Transformer, tensors: dict) -> M.Transformer:
    """A Transformer holding ``tensors`` (by parameter name, in
    ``params``' structure) as its parameters: a skeleton on the meta
    device whose every parameter is replaced."""
    skeleton = M.ModelConfig(vocab_size=1, d_model=8, n_heads=1, d_ff=1,
                             n_layers=len(params.blocks))
    out = M.Transformer(skeleton, "meta")
    for name, t in tensors.items():
        owner, _, leaf = name.rpartition(".")
        setattr(out.get_submodule(owner), leaf, nn.Parameter(t))
    return out


def shard_params(params: M.Transformer, mesh: Mesh) -> M.Transformer:
    """This rank's tp shard of the full weights ``params``: its
    ``1/tp`` of the heads and of the ffn's hidden axis (:data:`TP_AXIS`),
    everything else copied whole."""
    tensors = {}
    for name, p in params.named_parameters():
        axis, t = _tp_axis(name), p.detach()
        if axis is not None:
            if t.shape[axis] % mesh.tp:
                raise ValueError(f"{name}: axis {axis} of size "
                                 f"{t.shape[axis]} does not split over "
                                 f"tp={mesh.tp}")
            t = t.chunk(mesh.tp, dim=axis)[mesh.tp_rank]
        tensors[name] = t.clone()
    return _module_of(params, tensors)


def host_device_mesh(mesh: Mesh) -> DeviceMesh:
    """A CPU ``DeviceMesh`` over the gang, laid out as ``mesh`` (row-major,
    as :func:`make_mesh` fills it, its dimensions named as
    :attr:`Mesh.axes`): (dp, tp, sp), or (dp, tp, sp, pp) for a mesh
    with a pipe axis. It is what a global view of a rank's host copies
    needs (:func:`global_view`, :func:`stacked_global_view`). Creating
    it is a collective over the gang (it makes a group for each of its
    axes)."""
    return init_device_mesh("cpu", tuple(mesh.size(a) for a in mesh.axes),
                            mesh_dim_names=mesh.axes)


def _placements(device_mesh: DeviceMesh, shards: dict) -> list:
    """A placement for each dimension of ``device_mesh``: ``Shard(dim)``
    where ``shards`` maps the dimension's name to a tensor dim, else
    ``Replicate()``."""
    names = device_mesh.mesh_dim_names
    unknown = set(shards) - set(names)
    if unknown:
        raise ValueError(f"mesh axes {sorted(unknown)} are not among the "
                         f"host mesh's {names}")
    return [Shard(shards[n]) if n in shards else Replicate() for n in names]


def global_view(name: str, local: torch.Tensor,
                device_mesh: DeviceMesh) -> DTensor:
    """``local``, a rank's copy of parameter ``name`` (or of a tensor laid
    out as it, such as an AdamW moment) on the host, as the global tensor
    it is a part of: sharded over tp along :data:`TP_AXIS` and replicated
    over the other axes. Nothing is communicated; the global shape is the
    shard's times tp, as :func:`shard_params` splits evenly."""
    axis = _tp_axis(name)
    return DTensor.from_local(
        local, device_mesh,
        _placements(device_mesh, {} if axis is None else {"tp": axis}),
        run_check=False)


def stacked_global_view(weight: str, local: torch.Tensor,
                        device_mesh: DeviceMesh, pipe_axis: str,
                        tp_axis: str | None = None) -> DTensor:
    """``local``, a pipe rank's ``[1, per_stage, *shape]`` slice of block
    weight ``weight`` in the reference's stacked layout
    (``pipeline.stage_tree``), as the global ``[n_stages, per_stage,
    *shape]`` tensor: sharded over the pipe axis (named: ``pp``, or the
    ``sp`` a pipe runs over on a mesh without one) on dim 0 and, under
    ``tp_axis``, over it on dim ``TP_AXIS[weight] + 2``; replicated over
    the other axes. Nothing is communicated."""
    shards = {pipe_axis: 0}
    if tp_axis is not None and TP_AXIS.get(weight) is not None:
        if tp_axis == pipe_axis:
            raise ValueError(f"the pipe and tp axes are both {tp_axis!r}")
        shards[tp_axis] = TP_AXIS[weight] + 2
    return DTensor.from_local(local, device_mesh,
                              _placements(device_mesh, shards),
                              run_check=False)


def replicated_view(local: torch.Tensor,
                    device_mesh: DeviceMesh) -> DTensor:
    """``local`` as a global tensor every rank holds whole (a pipe's
    edge and its moments)."""
    return DTensor.from_local(local, device_mesh,
                              _placements(device_mesh, {}), run_check=False)


def gather_shards(tensors: dict, mesh: Mesh) -> dict:
    """Full tensors from each rank's tp shards (by parameter name), on
    every rank of the tp group: a collective over it."""
    return {name: (C.all_gather(t, mesh.tp_group, axis)
                   if (axis := _tp_axis(name)) is not None and mesh.tp > 1
                   else t.clone())
            for name, t in tensors.items()}


def gather_params(params: M.Transformer, mesh: Mesh) -> M.Transformer:
    """The full weights from tp shards: the inverse of
    :func:`shard_params`."""
    full = gather_shards({name: p.detach()
                          for name, p in params.named_parameters()}, mesh)
    return _module_of(params, full)


def place_batch(mesh: Mesh, x: torch.Tensor,
                sequence: bool = True) -> torch.Tensor:
    """This rank's shard of a global [B, L] batch (``batch_spec``): batch
    over dp and, with ``sequence``, the sequence over sp."""
    parts = ((0, mesh.dp, mesh.dp_rank),) + (
        ((1, mesh.sp, mesh.sp_rank),) if sequence else ())
    for dim, n, i in parts:
        if x.shape[dim] % n:
            raise ValueError(f"batch axis {dim} of size {x.shape[dim]} does "
                             f"not split over {n} ranks")
        x = x.chunk(n, dim=dim)[i]
    return x.contiguous()


def global_positions(mesh: Mesh, batch: int, seq: int,
                     device: str | torch.device = "cuda") -> torch.Tensor:
    """[batch / dp, seq / sp] absolute positions of this rank's shard of a
    [batch, seq] batch, so each sp shard applies rotary at its global
    offset."""
    ls = seq // mesh.sp
    pos = mesh.sp_rank * ls + torch.arange(ls, device=device)
    return pos.expand(batch // mesh.dp, ls)


# --------------------------------------------------------------------------
# Ring attention (sequence parallelism over the 'sp' group)
# --------------------------------------------------------------------------

def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group) -> torch.Tensor:
    """Causal attention with the sequence sharded over ``group``, in plain
    PyTorch (differentiable by autograd).

    Each rank holds one block of Q/K/V ([B, L/sp, H, D]). KV blocks rotate
    around the ring (:func:`collectives.shift`) while each rank
    accumulates its Q block's output in online-softmax form (running max
    ``m``, normalizer ``l``, accumulator ``acc``, all fp32), as the
    reference's scan does; the last rotation, which feeds nothing, is not
    made."""
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    b, lq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q32 = q.float()
    q_pos = idx * lq + torch.arange(lq, device=q.device)
    acc = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for step in range(n):
        if step:
            kv = C.shift(kv, group)
        src = (idx - step) % n
        k_blk, v_blk = kv[0], kv[1]
        scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_blk.float()) * scale
        kv_pos = src * lq + torch.arange(k_blk.shape[1], device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = scores.masked_fill(~mask, -1e30)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bkhd->bhqd", p, v_blk.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]            # [B, H, Lq, D]
    return out.transpose(1, 2).to(v.dtype)                # [B, Lq, H, D]


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group) -> torch.Tensor:
    """Ring attention with the flash kernels as the per-step op.

    Step 0 is the shard's own (causal) block; then ``sp - 1`` shifts, each
    followed by :func:`flash_attention.flash_block_with_lse` at the ring
    step's global offsets and the exact log-sum-exp merge
    (:func:`flash_attention.merge_partials`). The fp32 carry is cast to
    the activation dtype once, at the end. The backward is autograd
    through the block's ``_FlashBlock`` (its dq and dk/dv kernels, with
    the lse cotangent the merge hands back), the merges and the shifts'
    transposes, which carry each dk/dv partial back to the rank that owns
    the block. A block wholly in the future is computed like any other:
    its rows see no key, its lse is ``NEG_INF`` and the merge weighs it 0.
    """
    n, idx = dist.get_world_size(group), dist.get_rank(group)
    lq = q.shape[1]
    out, lse = FA.flash_block_with_lse(q, k, v, idx * lq, idx * lq)
    out = out.float()
    if n > 1:
        kv = torch.stack([k, v])
    for step in range(1, n):
        kv = C.shift(kv, group)
        src = (idx - step) % n
        o_s, lse_s = FA.flash_block_with_lse(q, kv[0], kv[1], idx * lq,
                                             src * lq)
        out, lse = FA.merge_partials(out, lse, o_s, lse_s)
    return out.to(v.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, use_flash: bool = False) -> torch.Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism.

    One all-to-all re-shards each of q, k, v from sequence-sharded
    [B, L/sp, H, D] to head-sharded [B, L, H/sp, D]; each rank runs causal
    attention over the full sequence for its heads (the flash kernel with
    ``use_flash``, else :func:`model.causal_attention`), and a second
    all-to-all restores sequence sharding. Requires ``H % sp == 0``."""
    sp = dist.get_world_size(group)
    h = q.shape[2]
    if h % sp != 0:
        raise ValueError(
            f"ulysses attention needs heads % sp == 0; got {h} heads "
            f"over sp={sp} (use ring attention instead)")

    def seq_to_heads(x):          # [B, L/sp, H, D] -> [B, L, H/sp, D]
        b, ls, _, d = x.shape
        x = x.reshape(b, ls, sp, h // sp, d).permute(2, 0, 1, 3, 4)
        y = C.all_to_all(x, group)        # [sp: sequence block, B, ...]
        return y.permute(1, 0, 2, 3, 4).reshape(b, sp * ls, h // sp, d)

    def heads_to_seq(x):          # [B, L, H/sp, D] -> [B, L/sp, H, D]
        b, l, hs, d = x.shape
        x = x.reshape(b, sp, l // sp, hs, d).permute(1, 0, 2, 3, 4)
        y = C.all_to_all(x, group)        # [sp: head group, B, ...]
        return y.permute(1, 2, 0, 3, 4).reshape(b, l // sp, sp * hs, d)

    q, k, v = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    attn = FA.flash_attention if use_flash else M.causal_attention
    return heads_to_seq(attn(q, k, v))


def _use_flash(use_flash: bool | None, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor, what: str) -> bool:
    """The kernels on the card and the plain path on the CPU by default,
    as ``best_attn_fn`` picks. Forcing the kernels with inputs they cannot
    take is an error, not a silent fallback; on the CPU the flash path is
    the kernels' plain versions, which take any input."""
    if use_flash is None:
        return q.device.type == "cuda"
    if use_flash and q.device.type != "cpu" and not FA.supported(
            q.detach(), k.detach(), v.detach()):
        raise ValueError(
            f"{what} with use_flash=True needs inputs the flash kernels "
            f"take (on one card, float32 at head_dim 16, 64 or 128 or "
            f"bfloat16 at 64 or 128, 16-byte aligned strides); got q "
            f"{tuple(q.shape)} {q.dtype} "
            f"on {q.device} (pass use_flash=False)")
    return use_flash


def make_ring_attn_fn(mesh: Mesh, use_flash: bool | None = None):
    """Ring attention over the mesh's sp group as the model's ``attn_fn``
    (each rank's q/k/v hold its batch, sequence and head shard).
    ``use_flash`` picks :func:`ring_flash_attention` or the plain
    :func:`ring_attention`."""
    def attn(q, k, v):
        if _use_flash(use_flash, q, k, v, "ring attention"):
            return ring_flash_attention(q, k, v, mesh.sp_group)
        return ring_attention(q, k, v, mesh.sp_group)
    return attn


def make_ulysses_attn_fn(mesh: Mesh, use_flash: bool | None = None):
    """:func:`ulysses_attention` over the mesh's sp group as the model's
    ``attn_fn``, with the local attention picked as
    :func:`make_ring_attn_fn` picks it."""
    def attn(q, k, v):
        flash = _use_flash(use_flash, q, k, v, "ulysses attention")
        return ulysses_attention(q, k, v, mesh.sp_group, use_flash=flash)
    return attn


# --------------------------------------------------------------------------
# Ring-latency model: placement -> predicted step time
# --------------------------------------------------------------------------
#
# The reference's composition, unchanged: a ring collective advances at
# the pace of its slowest hop (every rank must receive its block before
# the next rotation), a full pass is ``n - 1`` rotations, and a step adds
# its sequence-parallel rings' and pipeline boundaries' time to a
# placement-invariant compute time.
#
# The per-hop physics are the card's. Inside a node every GPU reaches
# every other through NVSwitch, which does not block: a hop between any
# two ranks of the node, at any distance, is one switch hop at the full
# per-direction NVLink rate (no link is shared d ways, as a torus's ICI
# links are). A hop that leaves the node (``None``) rides the NIC.
#
# The NVLink pair is fitted on the cards, and holds from 16 to 128 MiB.
# ``tools/ring_model_fit.py`` timed NCCL rotations of a four-card ring (one
# ``batch_isend_irecv`` a rotation, as ``collectives.shift`` posts them)
# on four NVIDIA H100 80GB HBM3 at 700.00 W. At 16, 64 and 128 MiB they
# lie on one line; least squares over those three gave 43.6 and 28.3 µs,
# 171.0 and 167.2 GB/s in two runs, and the constants are their means.
# Outside that window the line is off. Below 16 MiB a rotation sits on a
# floor of 0.07-0.12 ms (about the host's time to post it), which the line
# under-prices up to 3x (1 MiB: 42 µs against 72-124). At 256 MiB NCCL
# moves the payload faster (0.90 ms, against 0.83 at 128 MiB), and the
# line over-prices it 1.8x (1.62 ms). The published H100 SXM5 figures
# the fit replaces: NVLink 4 at 900 GB/s per GPU both ways together, 450
# GB/s a direction. The NIC rate is NVIDIA's published figure for one
# ConnectX-7 per GPU, 400 Gb/s (50 GB/s). The NIC's latency is not
# measured: one node cannot. It is the NVLink latency plus a guessed 10 µs
# for the fabric crossing.

#: NVLink bytes/s a direction, as a ring rotation of 16-128 MiB achieves
#: it (fitted).
NVLINK_BYTES_PER_S = 169.1e9
#: One in-node ring hop's fixed cost, µs (fitted, 16-128 MiB).
NVLINK_LATENCY_US = 35.9
#: One ConnectX-7 NIC per GPU, bytes/s (published: 400 Gb/s).
NIC_BYTES_PER_S = 50e9
#: A hop through the NIC, µs: not measured. The NVLink latency plus a
#: fabric crossing of 10 µs, a guess.
NIC_LATENCY_US = NVLINK_LATENCY_US + 10.0


def hop_time_us(hops: int | None, payload_bytes: float) -> float:
    """Time for one logical ring hop carrying ``payload_bytes``.
    ``hops`` is the distance between the ring neighbours, which inside a
    node costs one NVSwitch hop whatever it is; ``None`` means the hop
    leaves the node (the NIC)."""
    if hops is None:
        return NIC_LATENCY_US + payload_bytes / NIC_BYTES_PER_S * 1e6
    return NVLINK_LATENCY_US + payload_bytes / NVLINK_BYTES_PER_S * 1e6


def ring_rotation_time_us(hop_list: list[int | None],
                          payload_bytes: float) -> float:
    """One rotation of a ring collective over neighbours ``hop_list``
    apart: all transfers run concurrently, the slowest gates the
    rotation."""
    if not hop_list:
        return 0.0
    return max(hop_time_us(h, payload_bytes) for h in hop_list)


def ring_collective_time_us(hop_list: list[int | None],
                            payload_bytes: float,
                            rotations: int | None = None) -> float:
    """A full ring pass (default n - 1 rotations, the shift count of ring
    attention and of a ring all-reduce's reduce-scatter phase)."""
    n = len(hop_list)
    if n == 0:
        return 0.0
    if rotations is None:
        rotations = n - 1
    return rotations * ring_rotation_time_us(hop_list, payload_bytes)


def predicted_step_time_ms(sp_rings: list[list[int | None]],
                           pp_links: list[int | None],
                           *,
                           layers: int = 32,
                           microbatches: int = 8,
                           kv_block_bytes: float = 64 * 1024 * 1024,
                           act_bytes: float = 32 * 1024 * 1024,
                           compute_ms: float = 20.0) -> float:
    """Predicted training-step time of a pp x sp mesh at a placement.

    ``sp_rings``: per pipeline stage, the hop list of its sequence-
    parallel ring (ring attention rotates KV blocks ``sp - 1`` times a
    layer; stages run concurrently, so the slowest stage's ring gates the
    step). ``pp_links``: each stage-to-stage boundary's hop; 1F1B crosses
    each twice a microbatch (activation forward, gradient back).
    ``compute_ms`` is the placement-invariant compute time."""
    sp_us = 0.0
    if sp_rings:
        sp_us = layers * max(
            ring_collective_time_us(ring, kv_block_bytes)
            for ring in sp_rings)
    pp_us = 0.0
    if pp_links:
        pp_us = 2 * microbatches * max(
            hop_time_us(h, act_bytes) for h in pp_links)
    return compute_ms + (sp_us + pp_us) / 1000.0
