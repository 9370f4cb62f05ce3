"""Contention-traced locks: the mutex profile, and the lock-order race
detector.

The port's copy of ``tpushare/utils/locks.py``, standard library only.
A raw ``threading.Lock.acquire`` is a C call that leaves no Python frame,
so the ledger's locks (every filter and bind walks them) are invisible
to stack sampling. :class:`TracingRLock` instruments the acquisition
instead: the fast path is one non-blocking try-acquire; only when that
fails, under real contention, does it time the blocking acquire and fold
(count, total wait) into a per-site registry. An uncontended server pays
next to nothing; a contended one gets exact per-site numbers.
``/debug/pprof/mutex`` renders the registry, and the decision tracer
attributes each wait to the open span through a contention hook
(:mod:`tpushare_torch.trace`).

The race detector, armed by a test:

* every armed acquisition records lock-order edges against the sites
  this thread already holds; :func:`lock_order_cycles` reports cycles,
  each one a thread interleaving away from deadlock;
* mappings and sets made with :func:`guarded_dict` / :func:`guarded_set`
  record a violation when a thread that does not hold their lock
  mutates them.

Disarmed (the default) the detector costs one module-global bool check
per guarded mutation and nothing per acquisition. Every lock of the
port goes through this module, with the reference's site string, but
four of the port's own (``tests/test_torch_runtime.py`` names them), so
the mutex profile and the lock-order graph are whole.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Iterable, Mapping

#: Declared lock identities for a static lock-order analysis: every
#: TracingRLock carries its site string in its constructor call, but the
#: two raw locks below are this module's own internals (a TracingRLock
#: cannot profile itself without recursing). Keys are the module-level
#: names, values the site strings they stand for.
FLOW_DECLARED_SITES: dict[str, str] = {
    "_registry_lock": "locks/contention-registry",
    "_race_lock": "locks/race-detector",
}

_registry_lock = threading.Lock()
#: site -> [contention events, total seconds spent waiting]
_registry: dict[str, list] = {}

#: Extra per-contention sinks beyond the profile registry (the decision
#: tracer attributes lock-wait to the current span through one).
#: Appended-at-import, then read-only — iteration needs no lock.
_contention_hooks: list[Callable[[str, float], None]] = []


def add_contention_hook(hook: Callable[[str, float], None]) -> None:
    """Register ``hook(site, waited_s)``, invoked on every contended
    acquire AFTER the profile registry is updated and OUTSIDE the
    registry lock (a hook may take its own locks)."""
    if hook not in _contention_hooks:
        _contention_hooks.append(hook)


def remove_contention_hook(hook: Callable[[str, float], None]) -> None:
    if hook in _contention_hooks:
        _contention_hooks.remove(hook)


def record_contention(site: str, waited_s: float) -> None:
    with _registry_lock:
        entry = _registry.get(site)
        if entry is None:
            _registry[site] = [1, waited_s]
        else:
            entry[0] += 1
            entry[1] += waited_s
    for hook in _contention_hooks:
        try:
            hook(site, waited_s)
        except Exception:  # noqa: BLE001 - hooks are telemetry; an
            pass           # acquire must never fail because of one


def contention_snapshot() -> dict[str, tuple[int, float]]:
    with _registry_lock:
        return {site: (c, w) for site, (c, w) in _registry.items()}


def reset_contention() -> None:
    with _registry_lock:
        _registry.clear()


def render_mutex_profile() -> str:
    """Plain-text mutex profile, most-waited-on site first."""
    snap = sorted(contention_snapshot().items(),
                  key=lambda kv: -kv[1][1])
    lines = [f"# mutex profile: {len(snap)} contended sites "
             "(count, total wait; uncontended acquires cost ~0 and are "
             "not recorded)"]
    for site, (count, waited) in snap:
        lines.append(f"{waited * 1e3:12.2f} ms {count:10d} waits  {site}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------
# Race detector state
# --------------------------------------------------------------------------

#: Armed flag, read unsynchronized on hot paths (a stale read merely
#: delays arming by one acquisition — tests arm before spawning load).
_armed: bool = False

_race_lock = threading.Lock()
#: (held_site, acquired_site) -> "file:line" where the edge was first
#: observed, i.e. where acquired_site was taken while held_site was held.
_edges: dict[tuple[str, str], str] = {}
#: Guarded-mutation violations, formatted for humans.
_violations: list[str] = []

_tls = threading.local()


def _held_stack() -> list[str]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def held_sites() -> tuple[str, ...]:
    """Lock sites the CURRENT thread holds right now (outermost
    first). Maintained whether or not the detector is armed — tests
    use this to prove an I/O seam runs with no ledger lock held (the
    static twin is a blocking-under-lock lint)."""
    return tuple(_held_stack())


def _caller_site() -> str:
    # Walk back to the first frame outside this module (the deepest
    # path through acquire is 5 locks.py frames; 10 leaves headroom).
    frames = traceback.extract_stack(limit=10)
    for fr in reversed(frames):
        if not fr.filename.endswith("locks.py"):
            return f"{fr.filename}:{fr.lineno}"
    return "<unknown>"


def arm_race_detector() -> None:
    """Start recording lock-order edges and guarded-mutation checks."""
    global _armed
    reset_race_detector()
    _armed = True


def disarm_race_detector() -> None:
    global _armed
    _armed = False


def race_detector_armed() -> bool:
    return _armed


def reset_race_detector() -> None:
    with _race_lock:
        _edges.clear()
        _violations.clear()


def _record_acquisition(site: str) -> None:
    """Called with the lock HELD, first (non-reentrant) acquisition.
    The held stack is maintained whether or not the detector is armed
    (so arming mid-run never sees a corrupt stack); the edge recording
    is the armed-only part."""
    held = _held_stack()
    if held and _armed:
        with _race_lock:
            for prev in held:
                if prev != site and (prev, site) not in _edges:
                    _edges[(prev, site)] = _caller_site()
    held.append(site)


def _record_release(site: str) -> None:
    held = _held_stack()
    # Remove the most recent occurrence — releases may be out of LIFO
    # order for hand-over-hand patterns.
    for i in range(len(held) - 1, -1, -1):
        if held[i] == site:
            del held[i]
            break


def record_guard_violation(message: str) -> None:
    with _race_lock:
        if len(_violations) < 1000:  # bound a hot broken loop
            _violations.append(message)


def guard_violations() -> list[str]:
    with _race_lock:
        return list(_violations)


def lock_order_edges() -> dict[tuple[str, str], str]:
    with _race_lock:
        return dict(_edges)


def lock_order_cycles() -> list[list[str]]:
    """Cycles in the observed lock-order graph. Any cycle means there is
    a thread interleaving in which each participant holds one lock of
    the cycle and blocks on the next — a potential deadlock, reported
    even though the test run itself got lucky."""
    with _race_lock:
        adj: dict[str, set[str]] = {}
        for a, b in _edges:
            adj.setdefault(a, set()).add(b)
    cycles: list[list[str]] = []
    seen_cycles: set[tuple[str, ...]] = set()
    WHITE, GRAY, BLACK = 0, 1, 2
    color: dict[str, int] = {}
    path: list[str] = []

    def dfs(node: str) -> None:
        color[node] = GRAY
        path.append(node)
        for nxt in sorted(adj.get(node, ())):
            c = color.get(nxt, WHITE)
            if c == GRAY:
                cycle = path[path.index(nxt):] + [nxt]
                # Canonical form so A->B->A and B->A->B dedupe.
                ring = cycle[:-1]
                start = ring.index(min(ring))
                key = tuple(ring[start:] + ring[:start])
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cycles.append(cycle)
            elif c == WHITE:
                dfs(nxt)
        path.pop()
        color[node] = BLACK

    for node in sorted(adj):
        if color.get(node, WHITE) == WHITE:
            dfs(node)
    return cycles


def race_report() -> str:
    """Human-readable report of everything the armed detector saw."""
    cycles = lock_order_cycles()
    violations = guard_violations()
    lines = []
    if cycles:
        edges = lock_order_edges()
        lines.append(f"{len(cycles)} lock-order cycle(s):")
        for cyc in cycles:
            lines.append("  " + " -> ".join(cyc))
            for a, b in zip(cyc, cyc[1:]):
                lines.append(f"    {a} -> {b} first seen at "
                             f"{edges.get((a, b), '?')}")
    if violations:
        lines.append(f"{len(violations)} unguarded mutation(s):")
        lines.extend(f"  {v}" for v in violations)
    return "\n".join(lines)


def assert_race_free() -> None:
    """Raise AssertionError when the armed run saw a lock-order cycle or
    an unguarded mutation: the hook a race-detecting test fails on."""
    report = race_report()
    if report:
        raise AssertionError("race detector:\n" + report)


# --------------------------------------------------------------------------
# TracingRLock
# --------------------------------------------------------------------------


class TracingRLock:
    """Drop-in ``threading.RLock`` recording contended acquires by site.

    Reentrancy note: a reentrant re-acquire by the holder always
    succeeds on the fast path, so recursion never records phantom
    contention. The owner/depth bookkeeping below is only ever written
    while the lock is held, so it needs no extra synchronization; the
    cross-thread read in :meth:`held_by_current_thread` can only return
    a false *negative* for a non-owner, never a false positive."""

    __slots__ = ("_lock", "_site", "_owner", "_depth")

    def __init__(self, site: str) -> None:
        self._lock = threading.RLock()
        self._site = site
        self._owner: int | None = None
        self._depth = 0

    @property
    def site(self) -> str:
        return self._site

    def held_by_current_thread(self) -> bool:
        return self._owner == threading.get_ident()

    def _acquired(self) -> None:
        self._depth += 1
        if self._depth == 1:
            self._owner = threading.get_ident()
            _record_acquisition(self._site)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(blocking=False):
            self._acquired()
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._lock.acquire(timeout=timeout)
        record_contention(self._site, time.perf_counter() - t0)
        if ok:
            self._acquired()
        return ok

    def release(self) -> None:
        if self._depth == 1:
            self._owner = None
            self._depth = 0
            _record_release(self._site)
        else:
            self._depth -= 1
        self._lock.release()

    def __enter__(self) -> "TracingRLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()


# --------------------------------------------------------------------------
# Guarded containers: mutation requires holding the registered lock
# --------------------------------------------------------------------------


def _check_guard(lock: TracingRLock, name: str) -> None:
    if _armed and not lock.held_by_current_thread():
        record_guard_violation(
            f"{name} mutated without holding {lock.site} "
            f"at {_caller_site()}")


class GuardedDict(dict):
    """A ``dict`` that, while the race detector is armed, records a
    violation whenever it is mutated by a thread not holding its lock.
    Reads are unchecked (snapshot-read-then-copy under lock is the
    codebase's documented pattern; it is writes that corrupt)."""

    __slots__ = ("_vet_lock", "_vet_name")

    def __init__(self, lock: TracingRLock, name: str,
                 *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        self._vet_lock = lock
        self._vet_name = name

    def __setitem__(self, key: Any, value: Any) -> None:
        _check_guard(self._vet_lock, self._vet_name)
        super().__setitem__(key, value)

    def __delitem__(self, key: Any) -> None:
        _check_guard(self._vet_lock, self._vet_name)
        super().__delitem__(key)

    def pop(self, *args: Any) -> Any:
        _check_guard(self._vet_lock, self._vet_name)
        return super().pop(*args)

    def popitem(self) -> tuple[Any, Any]:
        _check_guard(self._vet_lock, self._vet_name)
        return super().popitem()

    def clear(self) -> None:
        _check_guard(self._vet_lock, self._vet_name)
        super().clear()

    def update(self, *args: Any, **kwargs: Any) -> None:
        _check_guard(self._vet_lock, self._vet_name)
        super().update(*args, **kwargs)

    def setdefault(self, key: Any, default: Any = None) -> Any:
        _check_guard(self._vet_lock, self._vet_name)
        return super().setdefault(key, default)

    def __ior__(self, other: Any) -> "GuardedDict":
        # `d |= mapping` mutates at the C level without dispatching to
        # update(); intercept it here or it escapes the detector.
        _check_guard(self._vet_lock, self._vet_name)
        super().update(other)
        return self


class GuardedSet(set):
    """Set counterpart of :class:`GuardedDict`."""

    __slots__ = ("_vet_lock", "_vet_name")

    def __init__(self, lock: TracingRLock, name: str,
                 iterable: Iterable[Any] = ()) -> None:
        super().__init__(iterable)
        self._vet_lock = lock
        self._vet_name = name

    def _checked(self) -> None:
        _check_guard(self._vet_lock, self._vet_name)

    def add(self, item: Any) -> None:
        self._checked(); super().add(item)

    def discard(self, item: Any) -> None:
        self._checked(); super().discard(item)

    def remove(self, item: Any) -> None:
        self._checked(); super().remove(item)

    def pop(self) -> Any:
        self._checked(); return super().pop()

    def clear(self) -> None:
        self._checked(); super().clear()

    def update(self, *others: Iterable[Any]) -> None:
        self._checked(); super().update(*others)

    def difference_update(self, *others: Iterable[Any]) -> None:
        self._checked(); super().difference_update(*others)

    def intersection_update(self, *others: Iterable[Any]) -> None:
        self._checked(); super().intersection_update(*others)

    def symmetric_difference_update(self, other: Iterable[Any]) -> None:
        self._checked(); super().symmetric_difference_update(other)

    # The augmented operators (`s |= x` etc.) mutate at the C level
    # without dispatching to the update methods above; route them
    # through the guard explicitly or they escape the detector.
    def __ior__(self, other: Any) -> "GuardedSet":
        self._checked(); super().update(other); return self

    def __iand__(self, other: Any) -> "GuardedSet":
        self._checked(); super().intersection_update(other); return self

    def __isub__(self, other: Any) -> "GuardedSet":
        self._checked(); super().difference_update(other); return self

    def __ixor__(self, other: Any) -> "GuardedSet":
        self._checked(); super().symmetric_difference_update(other)
        return self


def guarded_dict(lock: TracingRLock, name: str,
                 initial: Mapping[Any, Any] | Iterable[Any] = (),
                 ) -> GuardedDict:
    """Register a mapping with the race detector: mutations outside
    ``with lock:`` are recorded as violations. Construction itself is
    exempt (the object is not shared until its owner's __init__
    returns)."""
    return GuardedDict(lock, name, initial)


def guarded_set(lock: TracingRLock, name: str,
                iterable: Iterable[Any] = ()) -> GuardedSet:
    """Set counterpart of :func:`guarded_dict`."""
    return GuardedSet(lock, name, iterable)
