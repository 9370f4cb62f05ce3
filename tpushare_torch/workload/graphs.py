"""Compiled steps: the port's twin of ``jax.jit`` on the card.

The JAX package compiles every step a tenant repeats (``generate``,
``_admit``, ``_serve_chunk``, ``_serve_chunk_paged``, the train step, the
forward). Here the same steps run through :func:`run`, which keeps a
cache of captured CUDA graphs: on a CUDA device a key's first call runs
the body eagerly (on a side stream) and returns its result, then captures
the body as a ``torch.cuda.CUDAGraph``; every later call of the key copies
its inputs into the graph's static buffers and replays it. On the CPU the
body runs eagerly every time: nothing is captured there.

A key is

* the call's static arguments, what JAX's ``static_argnames`` are (the
  config, ``n_new``, ``max_len``, ``attn_fn``, ``n_steps`` ...);
* the shapes and dtypes of the **copied inputs** (tokens, prompt,
  targets, a slot's position / activity / token, the slot, the true
  length), which each replay copies into the graph's static buffers;
* the device and the addresses of the **bound tensors**, which the graph
  reads and writes in place (the weights, a server's cache or page pool
  and table, the optimizer's state);
* whether the step samples. A sampled step's graph registers the
  ``torch.Generator`` its capture drew from
  (``CUDAGraph.register_generator_state``), and a replay draws at that
  generator's offset then and advances it as the eager draws would. A
  replay for another generator lends the registered one the caller's
  state and hands the advanced state back, so the key holds no
  generator, as JAX traces its key: one seed gives one stream, compiled
  or not, whichever generator the graph was captured with.

A graph holds the kernels that were bound when it was captured; code
that binds another build's kernels (an A/B tool) calls :func:`clear`.

The contract:

1. One real execution per call. A key's first call is the eager warm-up
   and its result is returned; the capture that follows executes
   nothing. (That first call is the cost JAX pays to compile.)
2. Outputs are cloned out of the static buffers before they are
   returned, so a result a caller keeps is never overwritten by the next
   replay.
3. Launch counts stay true: the kernels' wrappers count on the host, and
   a replay runs no wrapper, so a capture records how much each of
   :mod:`flash_attention`'s counters grew, puts them back (capture
   launches nothing), and every replay adds that growth again.
4. :func:`cache_size` is the twin of ``_admit._cache_size()``: a miss is
   the first call of a key. The key registry is kept on the CPU too, so
   the accounting is the same on both devices.
5. :func:`disabled` is the twin of ``jax.disable_jit()``: inside it the
   body runs eagerly and the registry is not touched. So does a call made
   while the current stream is already capturing (a caller's own graph):
   its body becomes part of that capture.
6. No fallback: a capture that fails on the card raises.
7. Memory: the serving graphs share one pool a device and the train step
   has its own. A graph's intermediates are freed into its pool when the
   capture ends, so a later capture into the same pool may reuse them;
   by PyTorch's rule for shared pools that is safe only because every
   output is cloned out at once and no graph keeps state in its pool
   from one replay to the next. An entry whose bound tensors are freed is
   dropped (a weakref on each), and with it its graph; :func:`clear`
   drops them all.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import time
import weakref

import torch

from tpushare_torch.workload import flash_attention as FA

#: The launch counters of :mod:`flash_attention` a replay adds to.
COUNTERS = ("FLASH_FWD_LAUNCHES", "FLASH_BWD_DQ_LAUNCHES",
            "FLASH_BWD_DKV_LAUNCHES")

#: name -> key -> entry (its graph None where nothing is captured).
_REGISTRY: dict[str, dict[tuple, "_Entry"]] = {}
#: name -> {"misses", "replays", and each counter's launches in replays}.
_STATS: dict[str, dict[str, int]] = {}
#: One record a capture: name, seconds and the counters' growth.
CAPTURES: list[dict] = []
#: (device index, pool group) -> the graph pool handle its live graphs
#: share, and how many of them live.
_POOLS: dict[tuple[int, str], tuple] = {}
_LIVE: collections.Counter = collections.Counter()
#: Device index -> the side stream warm-ups and captures run on.
_SIDE: dict[int, torch.cuda.Stream] = {}
_DISABLED = 0
#: What stands in for capture on the CPU: None (the body runs eagerly),
#: or an object with :class:`_CudaGraphs`'s methods (the CPU tests).
STAND_IN = None


class _Entry:
    __slots__ = ("graph", "static_in", "static_out", "growth", "generator",
                 "refs")

    def __init__(self, graph=None, static_in=(), static_out=(),
                 growth=(), generator=None):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.growth = growth
        self.generator = generator
        self.refs = ()


class _CudaGraphs:
    """Warm-up, capture and replay on a CUDA device."""

    @staticmethod
    def warm_up(body, inputs: tuple, dev: torch.device):
        # The eager first call runs on the side stream the captures use,
        # as PyTorch's capture recipe does, so that lazily made handles
        # are not made during a capture. The kernels are built and bound
        # here.
        main, side = torch.cuda.current_stream(dev), _side(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = body(*inputs)
        main.wait_stream(side)
        return out

    @staticmethod
    def capture(body, static_in: tuple, bound: list, group: str,
                dev: torch.device, prepare, generator):
        if prepare is not None:
            prepare()
        # A graph that only garbage holds is freed before a pool is
        # chosen: a pool is shared only while a live graph holds it.
        gc.collect()
        graph = _Graph(dev, group)
        if generator is not None:
            # The capture then draws at offsets relative to the
            # generator's, read at each replay, and advances it by none.
            with torch.cuda.device(dev):
                graph.graph.register_generator_state(generator)
        # cuBLAS keeps a workspace a stream for the life of the process,
        # and one left inside a segment pins all of it. Cleared before the
        # capture, the graph's workspace comes from its own pool (not from
        # memory freed later); cleared after, the pool holds no block once
        # the graph is freed, and the cache is emptied so that the next
        # workspace takes a segment of its own. (PyTorch's compiler clears
        # them around its captures too.)
        torch._C._cuda_clearCublasWorkspaces()
        try:
            with torch.cuda.graph(graph.graph, pool=graph.pool,
                                  stream=_side(dev)):
                out = body(*static_in)
        finally:
            torch._C._cuda_clearCublasWorkspaces()
            torch.cuda.empty_cache()
        return graph, out

    @staticmethod
    def replay(graph) -> None:
        graph.graph.replay()


class _Graph:
    """A CUDA graph and the pool it shares with the live graphs of its
    group. PyTorch lets a capture share only a pool some live graph
    holds, so once a group's last graph is freed its next capture takes
    a new pool, and the old one goes back to the card when its memory is
    freed."""

    __slots__ = ("graph", "pool", "__weakref__")

    def __init__(self, dev: torch.device, group: str):
        key = (_index(dev), group)
        if not _LIVE[key]:
            _POOLS[key] = torch.cuda.graph_pool_handle()
        self.pool = _POOLS[key]
        self.graph = torch.cuda.CUDAGraph()
        _LIVE[key] += 1
        weakref.finalize(self, _release, key)


def _release(key: tuple[int, str]) -> None:
    _LIVE[key] -= 1


def _side(dev: torch.device) -> torch.cuda.Stream:
    """The device's one side stream for warm-ups and captures (each
    stream that runs a product gets a cuBLAS workspace of its own)."""
    index = _index(dev)
    if index not in _SIDE:
        _SIDE[index] = torch.cuda.Stream(index)
    return _SIDE[index]


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _backend(dev: torch.device):
    return _CudaGraphs if dev.type == "cuda" else STAND_IN


def _counts() -> tuple[int, ...]:
    return tuple(getattr(FA, name) for name in COUNTERS)


def _set_counts(values) -> None:
    for name, value in zip(COUNTERS, values):
        setattr(FA, name, value)


def _stats(name: str) -> dict[str, int]:
    return _STATS.setdefault(name, {"misses": 0, "replays": 0,
                                    **dict.fromkeys(COUNTERS, 0)})


def _key(static: tuple, inputs: tuple, bound: list, generator) -> tuple:
    return (static, inputs[0].device,
            tuple((t.shape, t.dtype) for t in inputs),
            tuple(t.data_ptr() for t in bound),
            generator is not None)


def _as_tuple(out) -> tuple:
    return out if isinstance(out, tuple) else (out,)


def run(name: str, body, inputs: tuple, *, static: tuple = (),
        bound=lambda: (), group: str = "serve", prepare=None,
        generator: torch.Generator | None = None):
    """``body(*inputs)``, compiled by key (see the module docstring).

    ``body`` returns a tensor or a tuple of tensors; it may read and
    write the tensors ``bound()`` returns in place (the key takes their
    addresses after the call, so state the first call creates, such as
    AdamW's moments, is bound from then on), and draw from
    ``generator``. ``prepare()``, when given, runs before the body's
    eager calls and before a capture, never before a replay: the part of
    the step a graph must not hold (the train step's
    ``zero_grad(set_to_none=True)``). ``group`` names the graph pool."""
    dev = inputs[0].device
    if _DISABLED or (dev.type == "cuda"
                     and torch.cuda.is_current_stream_capturing()):
        return _eager(body, inputs, prepare)
    entry = _REGISTRY.get(name, {}).get(
        _key(static, inputs, list(bound()), generator))
    if entry is not None:
        if entry.graph is None:
            return _eager(body, inputs, prepare)
        return _replay(name, entry, inputs, generator)
    _stats(name)["misses"] += 1
    backend = _backend(dev)
    if backend is None:
        out = _eager(body, inputs, prepare)
        entry = _Entry()
    else:
        if prepare is not None:
            prepare()
        out = backend.warm_up(body, inputs, dev)
        entry = _capture(name, backend, body, inputs, list(bound()), group,
                         prepare, dev, generator)
    _register(name, static, inputs, list(bound()), generator, entry)
    return out


def _eager(body, inputs: tuple, prepare):
    if prepare is not None:
        prepare()
    return body(*inputs)


def _capture(name: str, backend, body, inputs: tuple, bound: list,
             group: str, prepare, dev: torch.device, generator) -> _Entry:
    """Capture ``body`` over static copies of ``inputs``; the counters'
    growth is recorded and taken back out."""
    static_in = tuple(t.clone() for t in inputs)
    before = _counts()
    t0 = time.perf_counter()
    graph, out = backend.capture(body, static_in, bound, group, dev,
                                 prepare, generator)
    seconds = time.perf_counter() - t0
    growth = tuple(a - b for a, b in zip(_counts(), before))
    _set_counts(before)
    CAPTURES.append({"name": name, "seconds": seconds, "growth": growth})
    return _Entry(graph, static_in, _as_tuple(out), growth, generator)


def _register(name: str, static: tuple, inputs: tuple, bound: list,
              generator, entry: _Entry) -> None:
    """File ``entry`` under the key of these bound tensors; it leaves the
    registry, and its graph is freed, when any of them is freed. (The
    callback looks the table up by name: holding the table would make a
    cycle that keeps a cleared table's graphs and pools alive until the
    next garbage collection.)"""
    key = _key(static, inputs, bound, generator)

    def drop(_ref, name=name, key=key):
        _REGISTRY.get(name, {}).pop(key, None)

    entry.refs = tuple(weakref.ref(t, drop) for t in bound)
    _REGISTRY.setdefault(name, {})[key] = entry


def _replay(name: str, entry: _Entry, inputs: tuple, generator):
    for static, x in zip(entry.static_in, inputs):
        static.copy_(x)
    lent = entry.generator
    if generator is None or generator is lent:
        _backend(inputs[0].device).replay(entry.graph)
    else:
        # The registered generator draws from the caller's state for this
        # replay, and the caller's generator takes the advanced state.
        own = lent.get_state()
        lent.set_state(generator.get_state())
        _backend(inputs[0].device).replay(entry.graph)
        generator.set_state(lent.get_state())
        lent.set_state(own)
    _set_counts(a + g for a, g in zip(_counts(), entry.growth))
    stats = _stats(name)
    stats["replays"] += 1
    for counter, g in zip(COUNTERS, entry.growth):
        stats[counter] += g
    out = tuple(t.clone() for t in entry.static_out)
    return out if len(out) > 1 else out[0]


def cache_size(name: str) -> int:
    """Keys of ``name`` compiled so far (and not yet dropped): the twin of
    a jitted function's ``_cache_size()``."""
    return len(_REGISTRY.get(name, ()))


def stats() -> dict[str, dict]:
    """Per compiled step: keys, misses, replays, and the launches each
    kernel made inside replays."""
    return {name: {"keys": cache_size(name), "misses": s["misses"],
                   "replays": s["replays"],
                   "launches": {c: s[c] for c in COUNTERS}}
            for name, s in sorted(_STATS.items())}


def reset_stats() -> None:
    """Zero the misses, replays and replay launches (keys stay)."""
    _STATS.clear()
    CAPTURES.clear()


def clear() -> None:
    """Drop every key and its graph."""
    _REGISTRY.clear()
    reset_stats()


def pool_bytes() -> dict[str, int]:
    """Bytes the card's allocator holds in each graph pool group."""
    groups = {handle: key[1] for key, handle in _POOLS.items()
              if _LIVE[key]}
    out = dict.fromkeys(sorted(set(groups.values())), 0)
    if not groups:
        return out
    for seg in torch.cuda.memory_snapshot():
        group = groups.get(tuple(seg.get("segment_pool_id", ())))
        if group is not None:
            out[group] += seg["total_size"]
    return out


@contextlib.contextmanager
def disabled():
    """Run every compiled step eagerly inside the block: the twin of
    ``jax.disable_jit()``. Keys are neither looked up nor registered."""
    global _DISABLED
    _DISABLED += 1
    try:
        yield
    finally:
        _DISABLED -= 1
