"""Always-on continuous profiler with per-verb attribution.

The port's copy of ``tpushare/profiling/sampler.py``.

The on-demand samplers in :mod:`tpushare_torch.routes.pprof` answer "what is
the process doing for the next N seconds" — useful once an incident is
already live, useless for the question a regression asks: *which
verb's hot path grew, and in which frames?* This sampler runs from process start at a low rate (default
25 Hz), keeps a rolling 60s window of collapsed stacks, and attributes
every sample to the scheduling verb active on the sampled thread by
consulting the flight recorder's span context
(:meth:`tpushare_torch.trace.recorder.FlightRecorder.active_verb_map`) — the
piece Go's pprof never had: its profiles knew goroutines, not
decisions.

Two drivers, picked at :meth:`ContinuousProfiler.start`:

* **signal driver** (POSIX, armed from the main thread — the
  production path): ``setitimer(ITIMER_PROF)`` delivers ``SIGPROF``
  every 1/hz seconds of PROCESS CPU time and the handler samples right
  there, on a thread that already holds the GIL. This is the
  statprof/py-spy-style design: a polling *thread* at the same rate
  starves in the GIL convoy under exactly the load worth profiling
  (measured: 50 Hz nominal degraded to ~1 pass/s during the 1k-node
  bench churn), and when it finally runs it taxes in-flight verbs.
  CPU-proportional firing also makes the exported series honestly
  "self CPU": an idle fleet generates no samples and no overhead.
* **thread driver** (fallback): the polling loop, wall-clock paced —
  keeps the profiler available where signals are not (non-POSIX, or
  armed off the main thread), with the convoy caveat above.

Attribution buckets:

* a verb name (``filter``, ``prioritize``, ``bind``, ``preempt``,
  ``defrag:plan``, ...) while the sampled thread holds an open decision
  phase — including samples where that thread is PARKED (lock wait,
  apiserver RTT): the wait is verb cost, and the exact split comes from
  the companion :class:`~tpushare_torch.profiling.ledger.VerbCostLedger`;
* ``idle`` for non-verb threads parked in a lock/condition/queue wait
  (serving threads between requests — these are counted via their park
  leaf only, not deep-walked: the fat idle pool is exactly what a
  per-fire sampler cannot afford to walk);
* ``other`` for non-verb on-CPU work (controller sync, informer,
  housekeeping).

The sampler accounts its own busy time (``overhead_ratio``);
``tools/extender_phases.py --overhead`` measures its end-to-end latency
impact against the reference's ≤5% p99 limit.
"""

from __future__ import annotations

import signal
import sys
import threading
import time
from collections import Counter, deque
from types import FrameType
from typing import Any, Callable

from tpushare_torch.routes.pprof import _is_blocked
from tpushare_torch.utils import locks

#: Default sampling rate (fires per CPU-second under the signal
#: driver). Every fire's pass cost is latency some in-flight request
#: pays (the pass runs inside a GIL slice), so the rate is set for the
#: sampler's actual job — background subsystems and long operations;
#: the duty-cycled decision probe owns sub-millisecond verb
#: attribution. 25 Hz over the 60s window is 1500 passes.
DEFAULT_HZ = 25
DEFAULT_WINDOW_S = 60.0
DEFAULT_BUCKET_S = 5.0
#: Stack frames kept per sample (deepest first trimmed) — bounds label
#: memory against pathological recursion.
MAX_STACK = 48
#: Frame-label cache bound (id(code) -> label).
MAX_LABELS = 8192

#: Leaf-cache miss sentinel (a stored None means "known non-blocked").
_MISS: object = object()


class _Bucket:
    """One rotation interval's worth of samples."""

    __slots__ = ("start", "counts", "idle", "samples")

    def __init__(self, start: float) -> None:
        self.start = start
        #: (verb, root-first stack tuple) -> sample count
        self.counts: Counter[tuple[str, tuple[str, ...]]] = Counter()
        #: Parked non-verb threads, keyed by id(leaf code) — int keys
        #: keep the per-thread pass cost to two dict hits; readers
        #: translate through the label caches.
        self.idle: Counter[int] = Counter()
        self.samples = 0


class ContinuousProfiler:
    """Rolling-window statistical profiler with verb attribution."""

    def __init__(self, hz: int = DEFAULT_HZ,
                 window_s: float = DEFAULT_WINDOW_S,
                 bucket_s: float = DEFAULT_BUCKET_S,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.hz = max(int(hz), 1)
        self.window_s = float(window_s)
        self.bucket_s = float(bucket_s)
        self._clock = clock
        self._lock = locks.TracingRLock("profiling/sampler")
        self._buckets: deque[_Bucket] = deque()
        #: Cumulative (verb, leaf frame) sample counts since process
        #: start — the monotonic source of the
        #: tpushare_verb_self_cpu_seconds_total export.
        self._cum: Counter[tuple[str, str]] = Counter()
        self._cum_verb: Counter[str] = Counter()
        #: Cumulative idle samples, int-keyed like bucket.idle.
        self._cum_idle: Counter[int] = Counter()
        self._labels: dict[int, str] = {}
        #: id(code) -> leaf label for BLOCKED leaves, None for known
        #: non-blocked codes (Any-typed for the _MISS sentinel dance).
        #: Parked threads are the bulk of every pass; together with the
        #: int-keyed bucket.idle counters this turns their cost into
        #: two dict hits per thread (the pass cost is latency
        #: somebody's in-flight request pays — see the bench's
        #: overhead gate). Also the id->label translation readers use.
        self._leaf_cache: dict[int, Any] = {}
        self._samples_total = 0
        self._busy_s = 0.0
        self._running_s = 0.0
        self._cpu_at_start = 0.0
        self._driver = ""           # "", "signal", "thread"
        self._in_pass = False
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        self._prev_handler: object = None
        self.drops = 0

    # -- lifecycle -------------------------------------------------------- #

    def _signal_capable(self) -> bool:
        return (hasattr(signal, "SIGPROF")
                and hasattr(signal, "setitimer")
                and threading.current_thread()
                is threading.main_thread())

    def start(self) -> bool:
        """Arm the sampler; False when already running (idempotent — a
        double start must not stack drivers or clobber the itimer)."""
        with self._lock:
            if self._driver:
                return False
            self._cpu_at_start = time.process_time()
            if self._signal_capable():
                self._driver = "signal"
            else:
                self._driver = "thread"
                self._stop_evt = threading.Event()
                self._thread = threading.Thread(
                    target=self._run, name="tpushare-profiler",
                    daemon=True)
        # Signal plumbing outside the profiler lock: handler
        # installation never races a sampling pass of our own driver
        # (none is armed yet).
        if self._driver == "signal":
            self._prev_handler = signal.signal(signal.SIGPROF,
                                               self._on_sigprof)
            interval = 1.0 / self.hz
            signal.setitimer(signal.ITIMER_PROF, interval, interval)
        else:
            assert self._thread is not None
            self._thread.start()
        return True

    def stop(self) -> None:
        """Disarm; idempotent, returns after the driver is quiesced."""
        with self._lock:
            driver, self._driver = self._driver, ""
            thread = self._thread
            self._thread = None
            # Fold the armed interval's CPU time into the overhead
            # denominator before the clock base goes stale.
            self._running_s += max(
                time.process_time() - self._cpu_at_start, 0.0)
        if driver == "signal":
            signal.setitimer(signal.ITIMER_PROF, 0.0, 0.0)
            prev = self._prev_handler
            self._prev_handler = None
            try:
                signal.signal(signal.SIGPROF,
                              prev if callable(prev) or prev in (
                                  signal.SIG_IGN, signal.SIG_DFL)
                              else signal.SIG_DFL)
            except ValueError:
                # stop() off the main thread cannot swap handlers; the
                # timer is already disarmed and a stray late fire is a
                # no-op (the pass checks _driver) — but record it.
                self.drops += 1
        elif driver == "thread":
            self._stop_evt.set()
            if thread is not None and thread.is_alive():
                thread.join(timeout=5.0)

    def running(self) -> bool:
        return bool(self._driver)

    def driver(self) -> str:
        return self._driver

    def reset(self) -> None:
        """Drop every window and cumulative counter (tests)."""
        with self._lock:
            self._buckets.clear()
            self._cum.clear()
            self._cum_verb.clear()
            self._cum_idle.clear()
            self._leaf_cache.clear()
            self._samples_total = 0
            self._busy_s = 0.0
            self._running_s = 0.0
            self._cpu_at_start = time.process_time()

    # -- drivers ---------------------------------------------------------- #

    def _on_sigprof(self, signum: int, frame: FrameType | None) -> None:
        """SIGPROF: sample everything, HERE, on whichever thread the
        interpreter handed the signal to (it holds the GIL). ``frame``
        is this thread's pre-interrupt frame — used in place of its
        ``sys._current_frames()`` entry so the handler never profiles
        itself."""
        if self._in_pass:  # re-entrant fire while a pass runs: drop
            self.drops += 1
            return
        if self._lock.held_by_current_thread():
            # The signal interrupted THIS thread inside a profiler
            # read/bookkeeping section; re-entering would mutate the
            # window under the suspended iteration. One lost sample.
            self.drops += 1
            return
        self._in_pass = True
        t0 = time.perf_counter()
        try:
            self._sample_pass(own_frame=frame)
        except Exception:  # noqa: BLE001 - profiling must not die
            self.drops += 1
        finally:
            self._busy_s += time.perf_counter() - t0
            self._in_pass = False

    def _run(self) -> None:
        """Thread driver: wall-clock polling (see module docstring for
        why the signal driver is preferred under load)."""
        interval = 1.0 / self.hz
        stop_wait = self._stop_evt.wait
        while not self._stop_evt.is_set():
            t0 = time.perf_counter()
            try:
                self._sample_pass(skip_tid=threading.get_ident())
            except Exception:  # noqa: BLE001 - profiling must not die
                self.drops += 1
            busy = time.perf_counter() - t0
            self._busy_s += busy
            stop_wait(max(interval - busy, 0.0))

    # -- the sampling pass ------------------------------------------------ #

    def _label(self, frame: FrameType) -> str:
        code = frame.f_code
        label = self._labels.get(id(code))
        if label is None:
            label = (f"{code.co_name} "
                     f"({code.co_filename.rsplit('/', 1)[-1]})")
            if len(self._labels) >= MAX_LABELS:
                self._labels.clear()
            self._labels[id(code)] = label
        return label

    def _walk(self, frame: FrameType) -> tuple[str, ...]:
        stack: list[str] = []
        f: FrameType | None = frame
        depth = 0
        label = self._label
        while f is not None and depth < MAX_STACK:
            stack.append(label(f))
            f = f.f_back
            depth += 1
        stack.reverse()
        return tuple(stack)

    def _sample_pass(self, own_frame: FrameType | None = None,
                     skip_tid: int | None = None) -> None:
        from tpushare_torch import trace

        now = self._clock()
        frames = sys._current_frames()
        verbs = trace.recorder().active_verb_map()
        with self._lock:
            if not self._driver:
                return  # a late fire after stop(): window is closed
            bucket = self._buckets[-1] if self._buckets else None
            if bucket is None or now - bucket.start >= self.bucket_s:
                if bucket is not None:
                    # Fold the rotating-out bucket's idle counts into
                    # the cumulative view ONCE per rotation — per-pass
                    # cum updates were a third of the pass cost.
                    self._cum_idle.update(bucket.idle)
                bucket = _Bucket(now)
                self._buckets.append(bucket)
                horizon = now - self.window_s
                while self._buckets and (
                        self._buckets[0].start + self.bucket_s < horizon):
                    self._buckets.popleft()
            counts = bucket.counts
            me = threading.get_ident()
            if verbs:
                # A verb is in flight — which means THIS pass's cost is
                # almost certainly inside that verb's latency. Walk
                # ONLY the verb threads: long-running verbs (defrag
                # planning, a degenerate filter) still get sampled,
                # while the 30-thread idle sweep — the bulk of a full
                # pass — waits for a fire that lands on background
                # time. (Background categories are therefore sampled
                # only by non-verb fires; their within-category shares
                # are unbiased, cross-category ratios are not — see
                # the module docstring.)
                for tid, verb in list(verbs.items()):
                    frame = (own_frame if tid == me
                             and own_frame is not None
                             else frames.get(tid))
                    if frame is None or tid == skip_tid:
                        continue
                    stack = self._walk(frame)
                    counts[(verb, stack)] += 1
                    self._cum[(verb, stack[-1])] += 1
                    self._cum_verb[verb] += 1
                bucket.samples += 1
                self._samples_total += 1
                return
            idle = bucket.idle
            leaf_cache = self._leaf_cache
            for tid, frame in frames.items():
                if tid == skip_tid:
                    continue
                if tid == me and own_frame is not None:
                    frame = own_frame
                # Parked thread? Cached per code object: two dict
                # hits, an int-keyed counter bump, out.
                cid = id(frame.f_code)
                ent = leaf_cache.get(cid, _MISS)
                if ent is _MISS:
                    if len(leaf_cache) >= MAX_LABELS:
                        leaf_cache.clear()
                    ent = (self._label(frame) if _is_blocked(frame)
                           else None)
                    leaf_cache[cid] = ent
                if ent is not None:
                    idle[cid] += 1
                    continue
                stack = self._walk(frame)
                counts[("other", stack)] += 1
                self._cum[("other", stack[-1])] += 1
                self._cum_verb["other"] += 1
            bucket.samples += 1
            self._samples_total += 1

    # -- readers ---------------------------------------------------------- #

    def _merged(self, window_s: float | None) -> tuple[
            Counter[tuple[str, tuple[str, ...]]], int]:
        horizon = (self._clock() - (window_s or self.window_s))
        merged: Counter[tuple[str, tuple[str, ...]]] = Counter()
        passes = 0
        with self._lock:
            for bucket in self._buckets:
                if bucket.start + self.bucket_s < horizon:
                    continue
                merged.update(bucket.counts)
                for cid, n in bucket.idle.items():
                    label = self._leaf_cache.get(cid) or "<leaf gone>"
                    merged[("idle", (label,))] += n
                passes += bucket.samples
        return merged, passes

    def overhead_ratio(self) -> float:
        """The sampler's busy time as a fraction of the PROCESS CPU
        time that elapsed while it was armed — its self-reported cost
        (the bench's gate measures the end-to-end latency impact on
        top of this)."""
        with self._lock:
            denom = self._running_s
            if self._driver:
                denom += max(time.process_time() - self._cpu_at_start,
                             0.0)
            if denom <= 0:
                return 0.0
            return min(self._busy_s / denom, 1.0)

    def collapsed(self, window_s: float | None = None) -> str:
        """The rolling window as collapsed stacks, verb-rooted: each
        line is ``verb;frame;frame;... count`` — pipeable straight into
        flamegraph.pl / speedscope, with the verb as the root frame so
        one flamegraph shows every verb's cost side by side."""
        merged, passes = self._merged(window_s)
        header = (f"# continuous-profile: {passes} sampling passes at "
                  f"{self.hz}Hz ({self._driver or 'stopped'} driver) "
                  f"over the last {window_s or self.window_s:.0f}s "
                  f"window; sampler overhead "
                  f"{self.overhead_ratio() * 100:.2f}% of process CPU\n")
        lines = [f"{';'.join((verb,) + stack)} {n}"
                 for (verb, stack), n in merged.most_common()]
        return header + "\n".join(lines)

    def hotspots(self, top: int = 5,
                 window_s: float | None = None) -> dict[str, object]:
        """Top self-time frames per verb over the window.

        Self time = samples where the frame is the LEAF of its stack
        (what the thread was actually executing). Each verb reports its
        top ``top`` frames with share-of-verb-time, plus ``coverage`` —
        the listed frames' combined share (the bench's ≥90% attribution
        check reads this, with the per-verb sample totals)."""
        merged, passes = self._merged(window_s)
        per_verb: dict[str, Counter[str]] = {}
        verb_samples: Counter[str] = Counter()
        for (verb, stack), n in merged.items():
            per_verb.setdefault(verb, Counter())[stack[-1]] += n
            verb_samples[verb] += n
        verbs_doc = {}
        for verb, leaves in sorted(per_verb.items()):
            total = verb_samples[verb]
            frames = [{
                "frame": frame,
                "samples": n,
                "share": round(n / total, 4),
            } for frame, n in leaves.most_common(top)]
            verbs_doc[verb] = {
                "samples": total,
                "estSeconds": round(total / self.hz, 3),
                "frames": frames,
                "coverage": round(
                    sum(float(f["samples"]) for f in frames) / total, 4),
            }
        return {
            "hz": self.hz,
            "driver": self._driver,
            "windowSeconds": window_s or self.window_s,
            "samplingPasses": passes,
            "overheadRatio": round(self.overhead_ratio(), 5),
            "verbs": verbs_doc,
        }

    def cumulative_frames(self, top: int = 10) -> dict[str, object]:
        """Monotonic (verb, frame) self-time since start, top ``top``
        frames per verb plus an ``other`` residue bucket — the bounded
        label set behind ``tpushare_verb_self_cpu_seconds_total``."""
        with self._lock:
            cum = dict(self._cum)
            verb_totals = dict(self._cum_verb)
            idle_total = 0
            idle_frames: Counter[str] = Counter()
            merged_idle = Counter(self._cum_idle)
            if self._buckets:
                # the CURRENT bucket folds into _cum_idle only at
                # rotation; include it here
                merged_idle.update(self._buckets[-1].idle)
            for cid, n in merged_idle.items():
                idle_frames[self._leaf_cache.get(cid)
                            or "<leaf gone>"] += n
                idle_total += n
        per_verb: dict[str, Counter[str]] = {}
        for (verb, frame), n in cum.items():
            per_verb.setdefault(verb, Counter())[frame] += n
        if idle_total:
            per_verb["idle"] = idle_frames
            verb_totals["idle"] = idle_total
        out: dict[str, object] = {}
        for verb, leaves in per_verb.items():
            rows = {frame: n / self.hz
                    for frame, n in leaves.most_common(top)}
            listed = sum(leaves[frame] for frame in rows)
            residue = verb_totals.get(verb, 0) - listed
            if residue > 0:
                rows["other"] = residue / self.hz
            out[verb] = rows
        return out

    def status(self) -> dict[str, object]:
        with self._lock:
            samples = self._samples_total
            buckets = len(self._buckets)
        return {
            "running": self.running(),
            "driver": self._driver,
            "hz": self.hz,
            "windowSeconds": self.window_s,
            "bucketSeconds": self.bucket_s,
            "buckets": buckets,
            "samplingPasses": samples,
            "overheadRatio": round(self.overhead_ratio(), 5),
            "drops": self.drops,
        }
