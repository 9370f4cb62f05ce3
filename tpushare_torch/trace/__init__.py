"""tpushare_torch.trace: the decision flight recorder, module-level face.

The port's copy of ``tpushare/trace/__init__.py``. One process-wide
:class:`~tpushare_torch.trace.recorder.FlightRecorder`, a module
singleton like :mod:`tpushare_torch.k8s.events`' queue, so every layer
(routes, scheduler verbs, gang planner, ledger, k8s client) reaches the
same ring without constructor plumbing. Importing it registers the
lock-contention hook of :mod:`tpushare_torch.utils.locks`: a contended
``TracingRLock`` acquire charges its wait to the innermost open span of
the waiting thread (``lockWaitSeconds``, and ``worstLockSite`` among the
span's attrs).

* routes wrap each verb: ``with trace.phase("filter", ns, name, uid):``
* library code nests: ``with trace.span("allocate"): ...``
* verbs attach facts: ``trace.note("rejections", failed)``
* the k8s client reports: ``trace.note_api_call(rtt_s, method, path)``
* routes finalize: ``trace.complete(dec, "bound", node=node)``
"""

from __future__ import annotations

from typing import Any

from tpushare_torch.trace.recorder import (DEFAULT_CAPACITY, Decision,
                                           DropCounter, FlightRecorder,
                                           Span, add_complete_hook,
                                           add_phase_hook,
                                           format_traceparent,
                                           new_trace_id, parse_traceparent,
                                           remove_complete_hook,
                                           remove_phase_hook,
                                           set_phase_probe)
from tpushare_torch.utils import locks

__all__ = [
    "DEFAULT_CAPACITY", "Decision", "DropCounter", "FlightRecorder",
    "Span", "add_complete_hook", "add_phase_hook", "causal_chain",
    "complete", "current", "current_parent_id", "current_trace_id",
    "flight", "format_traceparent", "get_trace", "new_trace_id", "note",
    "note_api_call", "note_queue_wait", "parse_traceparent", "phase",
    "recorder", "remove_complete_hook", "remove_phase_hook", "reset",
    "restore", "set_parent", "set_phase_probe", "span",
]

_recorder = FlightRecorder()


def recorder() -> FlightRecorder:
    return _recorder


def reset() -> None:
    """Drop every recorded/open decision (tests)."""
    _recorder.reset()


def phase(verb: str, namespace: str, name: str, uid: str = "",
          enabled: bool = True) -> Any:
    return _recorder.phase(verb, namespace, name, uid, enabled=enabled)


def span(phase_name: str, **attrs: Any) -> Any:
    return _recorder.span(phase_name, **attrs)


def note(key: str, value: Any) -> None:
    _recorder.note(key, value)


def note_api_call(seconds: float, method: str = "", path: str = "") -> None:
    _recorder.note_api_call(seconds, method=method, path=path)


def note_queue_wait(seconds: float) -> None:
    _recorder.note_queue_wait(seconds)


def current() -> Decision | None:
    return _recorder.current()


def current_trace_id() -> str:
    return _recorder.current_trace_id()


def current_parent_id() -> str:
    return _recorder.current_parent_id()


def set_parent(parent_id: str) -> None:
    """Stamp a causal parent on this thread's current decision (no-op
    without one): the wire verbs pass the caller's ``traceparent``."""
    _recorder.set_parent(parent_id)


def restore(doc: dict) -> None:
    """Admit a decision doc replayed from a previous process's journal
    (causal-chain history, not live state)."""
    _recorder.restore(doc)


def causal_chain(trace_id: str) -> dict | None:
    """Resolve a trace id into target + ancestors + descendants across
    components and restarts (the ``/debug/trace?id=`` surface)."""
    return _recorder.causal_chain(trace_id)


def complete(dec: Decision | None, outcome: str, node: str = "",
             error: str = "") -> None:
    _recorder.complete(dec, outcome, node=node, error=error)


def flight(limit: int | None = None) -> list[dict]:
    return _recorder.flight(limit)


def get_trace(namespace: str, name: str,
              trace_id: str = "") -> dict | None:
    return _recorder.get_trace(namespace, name, trace_id=trace_id)


def _on_contention(site: str, waited_s: float) -> None:
    """Lock-wait attribution sink. The recorder's own lock is excluded:
    attributing the recorder to itself would count bookkeeping as
    scheduler contention (and the reentrant acquire under the hook
    could recurse)."""
    if site.startswith("trace/"):
        return
    try:
        _recorder.note_lock_wait(site, waited_s)
    except Exception:  # noqa: BLE001 - attribution must not break acquires
        _recorder.drops.inc()


locks.add_contention_hook(_on_contention)
