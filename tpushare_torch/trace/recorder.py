"""Decision tracing: spans, decisions and the flight recorder.

The port's copy of ``tpushare/trace/recorder.py``. Histograms
(:mod:`tpushare_torch.routes.metrics`) say the p99 got worse; they cannot
say why one pod landed where it did. Each placement attempt is recorded
as a **decision**: a trace id and the **spans** of its phases (filter,
prioritize, preempt, bind, gang, allocate, quota), each with its wall
time, thread CPU time, apiserver round trips (fed by
:class:`tpushare_torch.k8s.client.ApiClient`) and lock wait (fed by the
``TracingRLock`` contention hook in :mod:`tpushare_torch.utils.locks`).

Completed decisions land in a bounded ring, the flight recorder: always
on, fixed memory, the last N decisions already captured when something
goes wrong. ``GET /debug/flight`` dumps the ring,
``GET /debug/trace/<ns>/<pod>`` returns one pod's latest decision and
``GET /debug/trace?id=`` its causal chain.

* The module imports the standard library alone, so every layer can
  record without dragging anything along.
* Spans open only through context managers, and closing a span closes
  whatever a failing path left open under it.
* Recording never throws into the scheduling path: trouble increments
  :class:`DropCounter` and the decision goes on without it.

A decision spans several HTTP requests (filter, prioritize and bind are
separate POSTs), so open decisions are keyed by pod (namespace, name)
until an outcome finalizes them: ``bound``, ``failed``, ``gang-pending``,
``unschedulable``, or ``superseded`` / ``abandoned`` when a new pod
instance or table pressure retires them. The current decision is a
thread-local of the thread that runs the verb.
"""

from __future__ import annotations

import datetime
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterator

from tpushare_torch.utils import locks


#: Decisions kept in the flight-recorder ring.
DEFAULT_CAPACITY = 256
#: Open (not yet finalized) decisions tracked at once; beyond this the
#: oldest is retired as "abandoned" so pods that never bind cannot grow
#: the table without bound.
DEFAULT_MAX_OPEN = 512


class DropCounter:
    """Count of recording failures (telemetry must drop, not throw).
    A plain int bumped under the GIL: a lost increment under a race is
    an acceptable price for staying off every hot path."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


def new_trace_id() -> str:
    """96 bits of hex — short enough for an Event message, unique
    enough for a fleet."""
    return uuid.uuid4().hex[:12]


#: Restored (pre-restart) decision docs kept for causal-chain lookups.
DEFAULT_MAX_RESTORED = 512

_HEX = set("0123456789abcdef")


def parse_traceparent(header: str) -> str:
    """Extract our trace id from a W3C ``traceparent`` header
    (``00-<32 hex trace-id>-<16 hex span-id>-<flags>``), or ``""``.

    Our native ids are 12 hex chars; :func:`format_traceparent` pads
    them right with zeros, so a 32-hex id ending in 20 zeros
    canonicalizes back to its 12-hex form. A foreign id (entropy in the
    tail) is kept whole — we join their trace rather than truncate it.
    """
    parts = header.strip().lower().split("-")
    if len(parts) != 4:
        return ""
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or len(trace_id) != 32 or len(span_id) != 16:
        return ""
    if not (set(version) <= _HEX and set(trace_id) <= _HEX
            and set(span_id) <= _HEX):
        return ""
    if version == "ff":  # forbidden by the W3C spec
        return ""
    if trace_id == "0" * 32:
        return ""
    if trace_id.endswith("0" * 20):
        return trace_id[:12]
    return trace_id


def format_traceparent(trace_id: str) -> str:
    """Render one of our trace ids as a W3C ``traceparent`` header
    value (native 12-hex ids are zero-padded to the 32-hex field; the
    span-id field carries the same id — we model causality at decision
    granularity, not span granularity)."""
    tid = (trace_id + "0" * 32)[:32]
    sid = (trace_id + "0" * 16)[:16]
    return f"00-{tid}-{sid}-01"


#: Phase-exit sinks beyond the ring: ``hook(verb, span)`` runs as each
#: verb phase closes (a per-verb cost ledger registers one). Appended at
#: import, then read only, so iteration needs no lock; failures are
#: drop-counted, never raised into the scheduling path.
_phase_hooks: list[Any] = []


def add_phase_hook(hook: Any) -> None:
    """Register ``hook(verb: str, span: Span)``, invoked when a verb
    phase closes (span timings final)."""
    if hook not in _phase_hooks:
        _phase_hooks.append(hook)


def remove_phase_hook(hook: Any) -> None:
    if hook in _phase_hooks:
        _phase_hooks.remove(hook)


#: Decision-completion sinks beyond the ring: ``hook(decision)`` runs
#: as each decision finalizes (a journal that tees completed decisions
#: to disk registers one). Same contract as :data:`_phase_hooks`:
#: append-at-import, read-only iteration (no lock), failures
#: drop-counted; invoked AFTER the recorder's lock is released so a
#: slow sink can never extend the completion critical section.
_complete_hooks: list[Any] = []


def add_complete_hook(hook: Any) -> None:
    """Register ``hook(dec: Decision)``, invoked when a decision
    finalizes (outcome and timings final, decision already on the
    ring)."""
    if hook not in _complete_hooks:
        _complete_hooks.append(hook)


def remove_complete_hook(hook: Any) -> None:
    if hook in _complete_hooks:
        _complete_hooks.remove(hook)


#: Optional phase probe: ``probe(verb) -> context manager | None``,
#: consulted as each verb phase opens (a decision profiler registers
#: here to wrap the decisions it elects in cProfile); None, the common
#: case, costs one call. Single slot: two deterministic profilers on one thread
#: would fight over sys.setprofile.
_phase_probe: Any = None


def set_phase_probe(probe: Any) -> None:
    global _phase_probe
    _phase_probe = probe


class Span:
    """One timed phase of a decision. ``lock_wait_s`` and ``api_s`` are
    attributed by :meth:`FlightRecorder.note_lock_wait` / the k8s client
    while this span is the innermost open span on its thread; ``cpu_s``
    is the opening thread's CPU time across the span
    (``time.thread_time_ns``), so ``seconds - cpu_s`` is the span's
    involuntary share: GIL waits, lock parks, apiserver round trips."""

    __slots__ = ("phase", "depth", "start_offset_s", "seconds",
                 "lock_wait_s", "api_s", "api_calls", "attrs", "_t0",
                 "cpu_s", "_cpu0", "queue_s")

    def __init__(self, phase: str, depth: int, start_offset_s: float) -> None:
        self.phase = phase
        self.depth = depth
        self.start_offset_s = start_offset_s
        self._t0 = time.perf_counter()
        # Spans open and close on one thread (context-manager API), so
        # the thread-CPU delta is well-defined.
        self._cpu0 = time.thread_time_ns()
        self.seconds = 0.0
        self.cpu_s = 0.0
        self.lock_wait_s = 0.0
        self.api_s = 0.0
        #: Wait in the HTTP layer's micro-batch gate BEFORE this span
        #: opened (routes/batch.py) — reported separately because it is
        #: queueing the batcher ADDED, not time inside the verb (the
        #: span wall clock never contains it).
        self.queue_s = 0.0
        self.api_calls = 0
        self.attrs: dict[str, Any] = {}

    def close(self) -> None:
        self.seconds = max(time.perf_counter() - self._t0, 0.0)
        self.cpu_s = max(time.thread_time_ns() - self._cpu0, 0) / 1e9

    def to_json(self) -> dict:
        doc: dict[str, Any] = {
            "phase": self.phase,
            "depth": self.depth,
            "startOffsetSeconds": round(self.start_offset_s, 6),
            "seconds": round(self.seconds, 6),
            "cpuSeconds": round(self.cpu_s, 6),
            "lockWaitSeconds": round(self.lock_wait_s, 6),
            "apiSeconds": round(self.api_s, 6),
            "queueSeconds": round(self.queue_s, 6),
            "apiCalls": self.api_calls,
        }
        if self.attrs:
            doc["attrs"] = dict(self.attrs)
        return doc


class Decision:
    """One placement attempt for one pod: a trace-id and its spans."""

    def __init__(self, trace_id: str, namespace: str, name: str,
                 uid: str) -> None:
        self.trace_id = trace_id
        self.namespace = namespace
        self.name = name
        self.uid = uid
        #: Causal parent: the trace id of the decision this one
        #: descends from — a defrag move's parent is the bind that
        #: placed the pod, a wire verb's parent arrives in the caller's
        #: ``traceparent`` header. Empty for causal roots.
        self.parent_id = ""
        self.started_at = time.time()
        self._t0 = time.perf_counter()
        self.outcome = "open"
        self.node = ""
        self.error = ""
        self.wall_s = 0.0
        self.done = False
        self.spans: list[Span] = []
        #: Open-span stack (the innermost receives lock/api attribution).
        self._stack: list[Span] = []

    # -- span lifecycle -------------------------------------------------- #

    def open_span(self, phase: str, **attrs: Any) -> Span:
        sp = Span(phase, len(self._stack),
                  time.perf_counter() - self._t0)
        if attrs:
            sp.attrs.update(attrs)
        self.spans.append(sp)
        self._stack.append(sp)
        return sp

    def close_span(self, sp: Span) -> None:
        """Close ``sp`` AND anything still open under it — a code path
        that raised past an inner span must not leak it onto the stack
        (the context-manager API makes this the only close path)."""
        while self._stack:
            top = self._stack.pop()
            top.close()
            if top is sp:
                return
        # sp was already off the stack (double close): idempotent.

    def innermost(self) -> Span | None:
        return self._stack[-1] if self._stack else None

    # -- completion ------------------------------------------------------ #

    def finish(self, outcome: str, node: str = "", error: str = "") -> None:
        if self.done:
            return
        self.done = True
        self.outcome = outcome
        self.node = node
        self.error = error
        self.wall_s = max(time.perf_counter() - self._t0, 0.0)

    def to_json(self) -> dict:
        started = datetime.datetime.fromtimestamp(
            self.started_at, datetime.timezone.utc)
        wall = (self.wall_s if self.done
                else max(time.perf_counter() - self._t0, 0.0))
        doc: dict[str, Any] = {
            "traceId": self.trace_id,
            "namespace": self.namespace,
            "name": self.name,
            "uid": self.uid,
            "startedAt": started.strftime("%Y-%m-%dT%H:%M:%S.%f")[:-3] + "Z",
            "wallSeconds": round(wall, 6),
            "outcome": self.outcome,
            "node": self.node,
            "error": self.error,
            # list() snapshots against a concurrent append from the
            # handler thread; Span objects are append-only after open.
            "spans": [sp.to_json() for sp in list(self.spans)],
        }
        if self.parent_id:
            doc["parentId"] = self.parent_id
        return doc


class FlightRecorder:
    """Bounded ring of completed decisions + the open-decision table.

    Thread model: each decision is mutated only by the handler thread
    that holds it as its thread-local current; the recorder's lock
    guards the table and ring. Readers (``/debug/flight``) snapshot
    under the lock and serialize outside it.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 max_open: int = DEFAULT_MAX_OPEN) -> None:
        self._lock = locks.TracingRLock("trace/recorder")
        self._capacity = capacity
        self._max_open = max_open
        self._ring: deque[Decision] = deque(maxlen=capacity)
        self._open: dict[tuple[str, str], Decision] = {}
        self._tls = threading.local()
        #: tid -> verb currently open on that thread. The continuous
        #: profiler's attribution source: the sampler joins each
        #: sampled stack against this map to charge the sample to the
        #: verb running on that thread. Each thread writes ONLY its own
        #: key (single GIL-atomic dict ops), so no lock — the sampler
        #: reads racily by design: a sample landing exactly on a phase
        #: boundary may attribute to either side, which a statistical
        #: profile absorbs.
        self._active_verbs: dict[int, str] = {}
        #: Decisions replayed from a previous process's black-box
        #: journal (raw docs tagged ``restored: true``): served by the
        #: causal-chain resolver so an eviction after a restart still
        #: finds the bind that placed the pod. Bounded like the ring.
        self._restored: deque[dict[str, Any]] = deque(
            maxlen=DEFAULT_MAX_RESTORED)
        self.drops = DropCounter()

    # -- current-decision plumbing --------------------------------------- #

    def current(self) -> Decision | None:
        return getattr(self._tls, "decision", None)

    def current_trace_id(self) -> str:
        dec = self.current()
        return dec.trace_id if dec is not None else ""

    def current_parent_id(self) -> str:
        dec = self.current()
        return dec.parent_id if dec is not None else ""

    def set_parent(self, parent_id: str) -> None:
        """Stamp the causal parent on this thread's current decision.
        No-op without a decision or with an empty/self parent — call
        sites pass whatever annotation/header they have."""
        dec = self.current()
        if (dec is None or not parent_id
                or parent_id == dec.trace_id):
            return
        if not dec.parent_id:
            dec.parent_id = parent_id

    def active_verb_map(self) -> dict[int, str]:
        """The live tid → open-verb map (see ``_active_verbs``). The
        RETURNED OBJECT IS THE LIVE DICT — treat it as read-only; the
        sampler reads it per pass without copying (a copy per sample at
        profiling rates would be the profiler taxing itself)."""
        return self._active_verbs

    # -- phases ----------------------------------------------------------- #

    @contextmanager
    def phase(self, verb: str, namespace: str, name: str, uid: str = "",
              enabled: bool = True) -> Iterator[Decision | None]:
        """Enter verb ``verb`` for pod ``namespace/name``: bind the
        pod's open decision (creating one if needed) to this thread and
        open a span named after the verb. ``enabled=False`` is a no-op
        pass-through so call sites keep one code path for non-TPU pods.
        """
        if not enabled:
            yield None
            return
        dec = self._lookup_or_begin(namespace, name, uid)
        prev = getattr(self._tls, "decision", None)
        self._tls.decision = dec
        tid = threading.get_ident()
        prev_verb = self._active_verbs.get(tid)
        self._active_verbs[tid] = verb
        sp = dec.open_span(verb)
        probe_ctx = None
        if _phase_probe is not None:
            try:
                probe_ctx = _phase_probe(verb)
                if probe_ctx is not None:
                    probe_ctx.__enter__()
            except Exception:  # noqa: BLE001 - probes are telemetry
                probe_ctx = None
                self.drops.inc()
        try:
            yield dec
        finally:
            dec.close_span(sp)
            self._tls.decision = prev
            if prev_verb is None:
                self._active_verbs.pop(tid, None)
            else:
                self._active_verbs[tid] = prev_verb
            # Probe exit AFTER the span closes: the fold-in cost of a
            # profiled decision must not pollute the verb's own ledger
            # timings.
            if probe_ctx is not None:
                try:
                    probe_ctx.__exit__(None, None, None)
                except Exception:  # noqa: BLE001 - probes are telemetry
                    self.drops.inc()
            for hook in _phase_hooks:
                try:
                    hook(verb, sp)
                except Exception:  # noqa: BLE001 - hooks are telemetry
                    self.drops.inc()

    def _lookup_or_begin(self, namespace: str, name: str,
                         uid: str) -> Decision:
        key = (namespace, name)
        with self._lock:
            dec = self._open.get(key)
            if (dec is not None and uid and dec.uid and dec.uid != uid):
                # Same pod name, new UID: a recreated pod. The old
                # attempt can never complete — retire it.
                del self._open[key]
                dec.finish("superseded")
                self._ring.append(dec)
                dec = None
            if dec is None:
                abandoned = 0
                while len(self._open) >= self._max_open:
                    oldest = min(self._open,
                                 key=lambda k: self._open[k].started_at)
                    evicted = self._open.pop(oldest)
                    evicted.finish("abandoned")
                    self._ring.append(evicted)
                    abandoned += 1
                if abandoned:
                    # Table-pressure evictions were SILENT before the
                    # SLO PR: stories losing their endings with no
                    # metric. Lazy import keeps this module free of
                    # prometheus at import time (its design contract).
                    try:
                        from tpushare_torch.routes import metrics
                        metrics.safe_inc(metrics.TRACE_ABANDONED,
                                         abandoned)
                    except Exception:  # noqa: BLE001 - must not throw
                        self.drops.inc()
                dec = Decision(new_trace_id(), namespace, name, uid)
                self._open[key] = dec
            elif uid and not dec.uid:
                dec.uid = uid
            return dec

    def complete(self, dec: Decision | None, outcome: str, node: str = "",
                 error: str = "") -> None:
        """Finalize ``dec`` with an outcome and move it to the ring.
        ``None`` (a disabled phase) and double completion are no-ops."""
        if dec is None or dec.done:
            return
        with self._lock:
            if self._open.get((dec.namespace, dec.name)) is dec:
                del self._open[(dec.namespace, dec.name)]
            dec.finish(outcome, node, error)
            self._ring.append(dec)
        # Completion sinks run OUTSIDE the lock: the black-box journal
        # (or any other tee) must never extend the critical section a
        # verb's completion sits in.
        for hook in _complete_hooks:
            try:
                hook(dec)
            except Exception:  # noqa: BLE001 - hooks are telemetry
                self.drops.inc()

    # -- sub-spans and attribution ---------------------------------------- #

    @contextmanager
    def span(self, phase: str, **attrs: Any) -> Iterator[Span | None]:
        """A nested span on the current decision; no-op (yields None)
        when this thread holds no decision — library code can
        instrument unconditionally."""
        dec = self.current()
        if dec is None:
            yield None
            return
        sp = dec.open_span(phase, **attrs)
        try:
            yield sp
        finally:
            dec.close_span(sp)

    def note(self, key: str, value: Any) -> None:
        """Attach an attribute to the innermost open span, if any."""
        dec = self.current()
        if dec is None:
            return
        sp = dec.innermost()
        if sp is not None:
            sp.attrs[key] = value

    def note_lock_wait(self, site: str, waited_s: float) -> None:
        """Contention-hook sink: fold a contended acquire's wait into
        the innermost span (and remember the worst site)."""
        dec = self.current()
        if dec is None:
            return
        sp = dec.innermost()
        if sp is None:
            return
        sp.lock_wait_s += max(waited_s, 0.0)
        worst = sp.attrs.get("worstLockSite")
        if worst is None or waited_s > worst[1]:
            sp.attrs["worstLockSite"] = (site, waited_s)

    def note_queue_wait(self, seconds: float) -> None:
        """HTTP batch-gate sink: record the wait this request spent in
        the micro-batch window before its verb span opened (the
        ``queue;dur=`` Server-Timing component and the cost ledger's
        queue split)."""
        dec = self.current()
        if dec is None:
            return
        sp = dec.innermost()
        if sp is not None:
            sp.queue_s += max(seconds, 0.0)

    def note_api_call(self, seconds: float, method: str = "",
                      path: str = "") -> None:
        """k8s-client sink: fold one apiserver round-trip into the
        innermost span."""
        dec = self.current()
        if dec is None:
            return
        sp = dec.innermost()
        if sp is None:
            return
        sp.api_s += max(seconds, 0.0)
        sp.api_calls += 1

    # -- restored decisions and causal chains ------------------------------ #

    def restore(self, doc: dict[str, Any]) -> None:
        """Admit one decision doc replayed from a previous process's
        black-box journal. Kept as the raw dict (tagged
        ``restored: true``) — pre-crash decisions are history, not
        live state, so they never re-enter the open table or ring."""
        try:
            if not isinstance(doc, dict) or not doc.get("traceId"):
                self.drops.inc()
                return
            marked = dict(doc)
            marked["restored"] = True
            with self._lock:
                self._restored.append(marked)
        except Exception:  # noqa: BLE001 - replay is telemetry
            self.drops.inc()

    def _all_docs(self) -> list[dict[str, Any]]:
        """Every decision doc the causal resolver can see: restored
        history first (oldest), then the ring, then still-open
        attempts — later docs win on trace-id collision."""
        with self._lock:
            docs = list(self._restored)
            docs.extend(d.to_json() for d in self._ring)
            docs.extend(d.to_json() for d in self._open.values())
        return docs

    def causal_chain(self, trace_id: str) -> dict[str, Any] | None:
        """Resolve ``trace_id`` into its causal chain: the target
        decision, its ancestors (walking ``parentId`` up to the root),
        and its descendants (every decision whose parent chain reaches
        it). This is the ``/debug/trace?id=`` surface — it spans
        components AND restarts because restored journal docs
        participate."""
        docs = self._all_docs()
        by_id: dict[str, dict[str, Any]] = {}
        children: dict[str, list[dict[str, Any]]] = {}
        for doc in docs:
            tid = doc.get("traceId", "")
            if tid:
                by_id[tid] = doc
        for doc in by_id.values():
            parent = doc.get("parentId", "")
            if parent:
                children.setdefault(parent, []).append(doc)
        target = by_id.get(trace_id)
        if target is None:
            return None
        ancestors: list[dict[str, Any]] = []
        seen = {trace_id}
        parent = target.get("parentId", "")
        # Depth cap: a corrupt/cyclic parent chain must terminate.
        while parent and parent not in seen and len(ancestors) < 16:
            seen.add(parent)
            node = by_id.get(parent)
            if node is None:
                # Parent aged out of every buffer: report the dangling
                # id so the operator knows the chain continues.
                ancestors.append({"traceId": parent, "missing": True})
                break
            ancestors.append(node)
            parent = node.get("parentId", "")
        descendants: list[dict[str, Any]] = []
        frontier = [trace_id]
        visited = {trace_id}
        while frontier and len(descendants) < 64:
            nxt: list[str] = []
            for tid in frontier:
                for child in children.get(tid, []):
                    ctid = child.get("traceId", "")
                    if ctid and ctid not in visited:
                        visited.add(ctid)
                        descendants.append(child)
                        nxt.append(ctid)
            frontier = nxt
        return {"target": target, "ancestors": ancestors,
                "descendants": descendants}

    # -- readers ----------------------------------------------------------- #

    def flight(self, limit: int | None = None) -> list[dict]:
        """The last ``limit`` completed decisions, newest first."""
        with self._lock:
            decisions = list(self._ring)
        if limit is not None and limit > 0:
            decisions = decisions[-limit:]
        return [d.to_json() for d in reversed(decisions)]

    def get_trace(self, namespace: str, name: str,
                  trace_id: str = "") -> dict | None:
        """The most recent decision for ``namespace/name``: completed
        attempts win (newest first), else the still-open attempt. With
        ``trace_id``, return exactly that attempt — the pod-journey
        surface lists every attempt's id, and each must resolve here
        for as long as the ring holds it."""
        with self._lock:
            if trace_id:
                dec = self._open.get((namespace, name))
                if dec is not None and dec.trace_id == trace_id:
                    return dec.to_json()
                for dec in reversed(self._ring):
                    if (dec.namespace == namespace and dec.name == name
                            and dec.trace_id == trace_id):
                        return dec.to_json()
                # Restored journal docs resolve too: the explain
                # surface must answer for decisions a previous process
                # made.
                for doc in reversed(self._restored):
                    if (doc.get("namespace") == namespace
                            and doc.get("name") == name
                            and doc.get("traceId") == trace_id):
                        return dict(doc)
                return None
            for dec in reversed(self._ring):
                if dec.namespace == namespace and dec.name == name:
                    return dec.to_json()
            dec = self._open.get((namespace, name))
            return dec.to_json() if dec is not None else None

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._open.clear()
            self._active_verbs.clear()
            self._restored.clear()
            self.drops = DropCounter()
