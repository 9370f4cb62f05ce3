"""Collectives of the sharded workload, and their gradients.

The JAX package gets these from XLA inside ``shard_map`` and GSPMD
(``tpushare/workload/parallel.py``): ``ppermute`` and its transpose,
``all_to_all``, ``psum``, and the all-reduces GSPMD puts around a
tensor-parallel product. Here each is a ``torch.distributed`` call over a
process group, and each one that carries a gradient is a
``torch.autograd.Function`` whose backward is its transpose:

* :func:`shift`: send to the next rank of the group and receive from the
  previous one (``ppermute`` by +1); the backward shifts the other way.
  :func:`shift_back` is ``ppermute`` by -1 (the pipeline's gradient
  messages and its microbatch stream).
* :func:`all_to_all`: dim 0 split evenly over the group, chunk ``j`` to
  rank ``j``; an even all-to-all is its own transpose.
* :func:`copy_to` and :func:`reduce_from`: the pair around a
  tensor-parallel product (identity forward with an all-reduce backward,
  and the other way round).
* :func:`all_reduce` and :func:`all_gather` carry no gradient (the train
  step's gradient reduction; gathering shards).

Every send is posted together with its receive (``batch_isend_irecv``),
so no rank blocks on a lone ``send``, and every rank of a group issues
the group's collectives in the same order because it runs the same
program.

**Transport.** gloo's ``send`` hands the tensor's raw pointer to its TCP
pair, which reads host memory: a CUDA tensor fails there (``writev ...
Bad address`` on an H100, torch 2.11), while its all-reduce and
all-to-all take CUDA tensors by copying them to host inside. So on a gloo
group every tensor travels through a fresh host buffer, made in
:func:`_wire_buffer` and nowhere else, one rule for every collective; on
any other backend (NCCL) the buffer stays on the tensor's device. The
choice follows the group's backend, never a failure.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.autograd.function import once_differentiable


def _wire_buffer(x: torch.Tensor, group) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` that the group's transport can
    read and overwrite: in host memory on a gloo group, on ``x``'s device
    otherwise."""
    device = (torch.device("cpu") if dist.get_backend(group) == "gloo"
              else x.device)
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)


def _exchange(x: torch.Tensor, group, to: int, frm: int) -> torch.Tensor:
    """Send ``x`` to group rank ``to`` and receive a tensor like it from
    group rank ``frm``, both posted together. On a group of one, ``x``
    itself comes back (a copy)."""
    if to == frm == dist.get_rank(group):
        return x.clone()
    send = _wire_buffer(x, group)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, to),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm),
                      group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(x.device)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group, as a new tensor (no gradient)."""
    buf = _wire_buffer(x, group)
    dist.all_reduce(buf, group=group)
    return buf.to(x.device)


def all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in group-rank order
    (no gradient)."""
    buf = _wire_buffer(x, group)
    parts = [torch.empty_like(buf)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    send = _wire_buffer(x, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.to(x.device)


class _Shift(torch.autograd.Function):
    """``ppermute`` by ``step`` (+1 or -1) around the group, and its
    transpose, the shift by ``-step``."""

    @staticmethod
    def forward(ctx, x, group, step):
        ctx.group, ctx.step = group, step
        n, r = dist.get_world_size(group), dist.get_rank(group)
        return _exchange(x, group, (r + step) % n, (r - step) % n)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        n, r = dist.get_world_size(ctx.group), dist.get_rank(ctx.group)
        return (_exchange(g, ctx.group, (r - ctx.step) % n,
                          (r + ctx.step) % n), None, None)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


class _CopyTo(torch.autograd.Function):
    """Identity forward, all-reduce backward: the input of a product
    whose weight is split over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums out of a
    product whose weight is split over the group."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def shift(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the previous rank of ``group`` (this rank's goes to the
    next); differentiable."""
    return _Shift.apply(x, group, 1)


def shift_back(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of the next rank of ``group`` (this rank's goes to the
    previous); differentiable."""
    return _Shift.apply(x, group, -1)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Even all-to-all over dim 0 (its size a multiple of the group's);
    differentiable."""
    return _AllToAll.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)
