"""Profiling endpoints: the pprof suite, Python-native.

The port's copy of ``tpushare/routes/pprof.py`` (gpushare's
``pkg/routes/pprof.go:10-22``, which mounted Go's pprof set on the
serving router). The analogues here:

* ``profile``   — time-boxed statistical CPU sampler over
  ``sys._current_frames`` emitting **collapsed-stack** lines (the
  flamegraph.pl / speedscope input format), our ``/debug/pprof/profile``.
* ``heap``      — tracemalloc snapshot of top allocation sites
  (``/debug/pprof/heap``); tracing starts lazily on first call, so an
  un-profiled server pays nothing.
* ``goroutine`` — all-threads stack dump (``/debug/pprof/goroutine``,
  same payload as ``/debug/threads``).
* ``block``     — lock-contention sampler (``/debug/pprof/block``, the
  block/mutex-profile analogue the reference's Go suite mounted): the
  CPU sampler restricted to threads parked in a lock/condition wait.
  The extender is thread-per-request over shared ledgers, so lock
  contention IS its plausible production pathology — this shows which
  call paths sit blocked and on what.

All return plain text, curl-friendly, like Go's pprof endpoints.
"""

from __future__ import annotations

import collections
import sys
import threading
import time
import traceback

from tpushare_torch.utils import locks


def thread_dump() -> str:
    """All-threads stack dump (goroutine-profile analogue)."""
    lines = []
    for tid, frame in sys._current_frames().items():
        thread = next((t for t in threading.enumerate()
                       if t.ident == tid), None)
        name = thread.name if thread else f"thread-{tid}"
        lines.append(f"--- {name} ({tid}) ---")
        lines.extend(traceback.format_stack(frame))
    return "\n".join(lines)


#: Only one CPU profile may run at a time (Go's pprof likewise rejects a
#: concurrent CPU profile) — N stacked samplers would each walk every
#: thread's frames under the GIL and tax the webhook hot path.
_profile_lock = locks.TracingRLock("pprof/profile")


class ProfileBusyError(Exception):
    pass


def sample_profile(seconds: float = 5.0, hz: int = 100,
                   clock=time.monotonic, sleep=time.sleep) -> str:
    """Statistical profile of every live thread for ``seconds``.

    Samples ``sys._current_frames()`` at ``hz`` and aggregates identical
    stacks into collapsed form: ``func;func;func count`` per line —
    pipeable straight into flamegraph tooling. Sampling skips the
    profiler's own thread. Raises :class:`ProfileBusyError` when a
    profile is already in progress.
    """
    if not _profile_lock.acquire(blocking=False):
        raise ProfileBusyError("a CPU profile is already in progress")
    try:
        return _sample_profile_locked(seconds, hz, clock, sleep)
    finally:
        _profile_lock.release()


#: Leaf frames that mean "this thread is parked waiting on a lock /
#: condition / queue", by (function name, file basename). threading's
#: pure-Python layer always has one of these on top of a blocked stack;
#: a raw ``lock.acquire`` C call shows the caller's frame instead, which
#: the ``acquire``/``wait`` name check still catches in threading.py and
#: queue.py call sites.
_BLOCKED_LEAVES = {
    ("wait", "threading.py"),
    ("acquire", "threading.py"),
    ("wait_for", "threading.py"),
    # Thread.join delegates to _wait_for_tstate_lock, whose C-level
    # lock.acquire leaves THIS as the visible leaf (join itself is
    # never the top frame on 3.12).
    ("_wait_for_tstate_lock", "threading.py"),
    ("join", "threading.py"),
    ("get", "queue.py"),
    ("put", "queue.py"),
    # concurrent.futures workers park in _queue.SimpleQueue.get — a C
    # call with no Python frame, leaving the executor loop itself as
    # the visible leaf. A _worker LEAF is always that park: while it
    # runs a task, the task's frames sit on top.
    ("_worker", "thread.py"),
    # I/O parks: a serving thread waiting for its next request bytes
    # and the accept loop waiting in select are idle capacity, not
    # work — without these, every keep-alive handler thread shows up
    # as busy in the continuous profiler's 'other' bucket.
    ("readinto", "socket.py"),
    ("select", "selectors.py"),
}


def _stack_of(frame) -> list[str]:
    stack = []
    f = frame
    while f is not None:
        code = f.f_code
        stack.append(f"{code.co_name} "
                     f"({code.co_filename.rsplit('/', 1)[-1]}:{f.f_lineno})")
        f = f.f_back
    stack.reverse()
    return stack


def _is_blocked(frame) -> bool:
    code = frame.f_code
    return (code.co_name,
            code.co_filename.rsplit("/", 1)[-1]) in _BLOCKED_LEAVES


def _sample_profile_locked(seconds, hz, clock, sleep,
                           blocked_only: bool = False) -> str:
    counts: collections.Counter[str] = collections.Counter()
    me = threading.get_ident()
    interval = 1.0 / max(hz, 1)
    deadline = clock() + seconds
    samples = 0
    while clock() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            if blocked_only and not _is_blocked(frame):
                continue
            counts[";".join(_stack_of(frame))] += 1
        samples += 1
        sleep(interval)
    kind = "lock-wait" if blocked_only else "collapsed-stack"
    header = (f"# {kind} profile: {samples} samples at {hz}Hz "
              f"over {seconds:.1f}s\n")
    body = "\n".join(f"{stack} {n}" for stack, n in counts.most_common())
    return header + body


def sample_block_profile(seconds: float = 5.0, hz: int = 100,
                         clock=time.monotonic, sleep=time.sleep) -> str:
    """The block/mutex-profile analogue: collapsed stacks of threads
    observed PARKED in a lock/condition/queue wait. Each line's count is
    proportional to time spent blocked on that call path — the top entry
    is the extender's hottest contention point. Shares the one-profiler
    gate with :func:`sample_profile`."""
    if not _profile_lock.acquire(blocking=False):
        raise ProfileBusyError("a profile is already in progress")
    try:
        return _sample_profile_locked(seconds, hz, clock, sleep,
                                      blocked_only=True)
    finally:
        _profile_lock.release()


#: Serializes start/stop/snapshot on tracemalloc: concurrent ?stop=1 and
#: snapshot requests on the threading server must not race (stop between
#: is_tracing() and take_snapshot() would 500 the snapshot).
_heap_lock = locks.TracingRLock("pprof/heap")


def heap_snapshot(top: int = 30, stop: bool = False) -> str:
    """Top allocation sites by live bytes (heap-profile analogue).

    First call enables ``tracemalloc`` and reports a warm-up notice;
    subsequent calls report the snapshot. Tracing taxes every allocation,
    so ``stop=True`` (``?stop=1`` on the endpoint) turns it back off once
    debugging is done — heap profiling is opt-in per incident, not an
    always-on cost on the webhook hot path.
    """
    import tracemalloc

    with _heap_lock:
        return _heap_snapshot_locked(tracemalloc, top, stop)


def _heap_snapshot_locked(tracemalloc, top: int, stop: bool) -> str:
    if stop:
        if tracemalloc.is_tracing():
            tracemalloc.stop()
        return "# tracemalloc stopped; heap tracing is off.\n"
    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return ("# tracemalloc just enabled; allocations made from now on "
                "will appear. Re-request this endpoint after some load; "
                "finish with ?stop=1 to disable tracing overhead.\n")
    snapshot = tracemalloc.take_snapshot()
    stats = snapshot.statistics("lineno")
    total = sum(s.size for s in stats)
    lines = [f"# heap profile: {len(stats)} allocation sites, "
             f"{total / 1024:.0f} KiB traced"]
    for stat in stats[:top]:
        frame = stat.traceback[0]
        lines.append(f"{stat.size / 1024:10.1f} KiB {stat.count:8d} objs  "
                     f"{frame.filename.rsplit('/', 1)[-1]}:{frame.lineno}")
    return "\n".join(lines)


def sample_trace(seconds: float = 2.0, hz: int = 200,
                 clock=time.monotonic, sleep=time.sleep) -> str:
    """Execution-trace analogue (Go's ``/debug/pprof/trace``): a
    time-boxed sampled timeline of every thread, emitted as CHROME
    TRACE EVENT JSON — load it in Perfetto / chrome://tracing and see
    which thread ran what, when, and for how long. Consecutive samples
    whose top frame matches collapse into one span, so the artifact
    reads as spans of work, not sample confetti. Shares the
    one-profiler gate with the CPU/block samplers."""
    if not _profile_lock.acquire(blocking=False):
        raise ProfileBusyError("a profile is already in progress")
    try:
        return _sample_trace_locked(seconds, hz, clock, sleep)
    finally:
        _profile_lock.release()


def _sample_trace_locked(seconds, hz, clock, sleep) -> str:
    import json as _json

    me = threading.get_ident()
    interval = 1.0 / max(hz, 1)
    t0 = clock()
    deadline = t0 + seconds
    # Display lanes are keyed by (ident, thread name), NOT bare ident:
    # CPython recycles idents, and under request churn a new handler
    # thread can reuse a dead one's ident between samples — bare-tid
    # keying would render its work as the dead thread's continuation.
    lanes: dict[tuple[int, str], int] = {}
    #: lane -> (current leaf label, span start us); emitted on change
    open_spans: dict[int, tuple[str, float]] = {}
    events: list[dict] = []

    def lane_of(tid: int, name: str) -> int:
        key = (tid, name)
        lane = lanes.get(key)
        if lane is None:
            lane = lanes[key] = len(lanes) + 1
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": lane, "args": {"name": name}})
        return lane

    def close(lane, now_us):
        label, start = open_spans.pop(lane)
        events.append({"name": label, "ph": "X", "pid": 1, "tid": lane,
                       "ts": round(start, 1),
                       "dur": round(max(now_us - start, 1.0), 1)})

    while clock() < deadline:
        now_us = (clock() - t0) * 1e6
        live = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        seen: set[int] = set()
        for tid, frame in frames.items():
            if tid == me:
                continue
            lane = lane_of(tid, live.get(tid, f"thread-{tid}"))
            seen.add(lane)
            code = frame.f_code
            label = (f"{code.co_name} "
                     f"({code.co_filename.rsplit('/', 1)[-1]})"
                     + (" [blocked]" if _is_blocked(frame) else ""))
            if lane in open_spans and open_spans[lane][0] != label:
                close(lane, now_us)
            if lane not in open_spans:
                open_spans[lane] = (label, now_us)
        for lane in [ln for ln in open_spans if ln not in seen]:
            close(lane, now_us)  # thread exited (or its ident recycled)
        sleep(interval)
    end_us = (clock() - t0) * 1e6
    for lane in list(open_spans):
        close(lane, end_us)
    return _json.dumps({"traceEvents": events,
                        "displayTimeUnit": "ms"})


def index(prefix: str = "/debug/pprof") -> str:
    return (
        "tpushare pprof endpoints (reference pkg/routes/pprof.go analogue)\n"
        f"  {prefix}/profile?seconds=5&hz=100  CPU profile, collapsed stacks\n"
        f"  {prefix}/block?seconds=5&hz=100    lock-contention profile "
        "(threads parked in lock/cond waits)\n"
        f"  {prefix}/mutex                     contended-lock registry "
        "(per-site wait counts/time; exact, not sampled)\n"
        f"  {prefix}/trace?seconds=2&hz=200    sampled all-threads "
        "timeline as Chrome trace JSON (open in Perfetto)\n"
        f"  {prefix}/heap[?stop=1]             live-allocation snapshot "
        "(stop=1 disables tracing)\n"
        f"  {prefix}/goroutine                 all-threads stack dump\n"
        "  /debug/profile/continuous[?window=S]  the ALWAYS-ON "
        "profiler's rolling window, verb-rooted collapsed stacks "
        "(docs/perf.md)\n"
        "  /debug/hotspots[?top=N&window=S]   top self-time frames per "
        "verb + the exact wall/cpu/lock/apiserver verb cost ledger\n"
        "  /debug/flight[?n=K]                decision flight recorder "
        "(last K placement decisions)\n"
        "  /debug/trace/<ns>/<pod>            one pod's latest decision "
        "trace\n")
