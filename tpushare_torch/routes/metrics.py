"""Prometheus metrics for the extender.

The port's copy of ``tpushare/routes/metrics.py``: the same family names,
HELP texts, types, labels and buckets, rendered by the port's own
standard-library exposition (:mod:`tpushare_torch.routes.exposition`,
line for line what ``prometheus_client`` writes). Only the families whose
sources the port has are declared, so none renders a zero that means
nothing: the autoscaler's and the serving router's come with the modules
that feed them. The pod-journey SLOs' (``tpushare_pod_e2e_*``,
``tpushare_pod_scheduling_attempts``, ``tpushare_slo_*``) read
:mod:`tpushare_torch.slo`; fragmentation's and defrag's
(``tpushare_cluster_stranded_hbm_gib``, ``tpushare_node_frag_score``,
``tpushare_defrag_*``) read the defrag executor. The per-verb
cost ledger's and the continuous profiler's (``tpushare_verb_*``,
``tpushare_profiler_*``) read :mod:`tpushare_torch.profiling`. The
retrospective layer's families (build, uptime, anomaly firings, the
timeline's drops and series, the fleet-day witness's verdicts) read
:mod:`tpushare_torch.obs`.

:func:`scrape` refreshes every gauge from its source under
``_SCRAPE_LOCK`` and renders; a scrape that raises counts
``tpushare_scrape_errors_total`` and raises on into the handler's 500.
"""

from __future__ import annotations

import os
import threading
import time as _time_mod

from tpushare_torch.routes.exposition import (Counter, Gauge, Histogram,
                                              Registry)
from tpushare_torch.utils import locks

REGISTRY = Registry()

# Scrapes run on HTTP pool-worker threads; the clear() and repopulate of
# observe_cache must not interleave with another scrape's render, or that
# scrape would see missing node series. Taken before any ledger lock (the
# verbs never take it), so a scrape cannot deadlock a verb.
_SCRAPE_LOCK = locks.TracingRLock("metrics/scrape")

_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
    0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
)

#: Public alias: the exemplar store (tpushare_torch.obs.exemplars) files
#: its trace ids under these bounds, so its ``# {trace_id=...}``
#: annotations land on the ``le`` lines the exposition renders.
LATENCY_BUCKETS = _BUCKETS

FILTER_LATENCY = Histogram(
    "tpushare_filter_latency_seconds",
    "Latency of extender filter requests",
    registry=REGISTRY, buckets=_BUCKETS,
)
PRIORITIZE_LATENCY = Histogram(
    "tpushare_prioritize_latency_seconds",
    "Latency of extender prioritize requests",
    registry=REGISTRY, buckets=_BUCKETS,
)
PREEMPT_LATENCY = Histogram(
    "tpushare_preempt_latency_seconds",
    "Latency of extender preempt requests",
    registry=REGISTRY, buckets=_BUCKETS,
)
BIND_LATENCY = Histogram(
    "tpushare_bind_latency_seconds",
    "Latency of extender bind requests",
    registry=REGISTRY, buckets=_BUCKETS,
)
BIND_ERRORS = Counter(
    "tpushare_bind_errors_total",
    "Bind requests that returned an error",
    registry=REGISTRY,
)
ADMISSION_REJECTED = Counter(
    "tpushare_admission_rejected_total",
    "Pod CREATEs rejected by the validating admission webhook",
    registry=REGISTRY,
)
FILTER_REQUESTS = Counter(
    "tpushare_filter_requests_total",
    "Filter requests served",
    registry=REGISTRY,
)
HBM_TOTAL = Gauge(
    "tpushare_node_hbm_total_gib", "Total shareable HBM per node",
    ["node"], registry=REGISTRY,
)
HBM_USED = Gauge(
    "tpushare_node_hbm_used_gib", "Committed HBM per node",
    ["node"], registry=REGISTRY,
)
PREEMPT_VICTIMS = Counter(
    "tpushare_preempt_victims_total",
    "Worst-case victim count per preemption plan (the max over the "
    "plan's candidate nodes — the scheduler evicts ONE node's set, so "
    "summing across candidates would over-count by the fleet factor). "
    "A rising rate means priority traffic is displacing work.",
    registry=REGISTRY,
)


def safe_inc(counter, n: float = 1) -> None:
    """An increment that can never break the calling code path: metrics
    are observability, not control flow."""
    try:
        counter.inc(n)
    except Exception:  # noqa: BLE001 - this is the drop guard itself
        pass


def safe_observe(histogram, value: float) -> None:
    """The histogram twin of :func:`safe_inc`."""
    try:
        histogram.observe(value)
    except Exception:  # noqa: BLE001 - this is the drop guard itself
        pass


GANGS_REAPED = Counter(
    "tpushare_gangs_reaped_total",
    "Gangs whose below-quorum survivors were reclaimed by the "
    "controller reaper (each one is a job restart; a steady rate means "
    "something keeps evicting gang members)",
    registry=REGISTRY,
)
GANG_RING_CONTIGUITY = Gauge(
    "tpushare_gang_ring_contiguity",
    "Ring contiguity of the gang's COMMITTED placement (members in "
    "worker order over their slice's host grid): 1.0 = every ring hop "
    "is one ICI link; lower means multi-hop ICI or DCN crossings on "
    "the job's collective path. Set at gang commit; a low value on a "
    "slice-shape gang means the placer fell back — see "
    "tpushare_topology_fallbacks_total and docs/topology.md",
    ["gang"], registry=REGISTRY,
)
TOPOLOGY_FALLBACKS = Counter(
    "tpushare_topology_fallbacks_total",
    "Slice-shape gang placements that fell back to topology-blind "
    "placement: no contiguous host block existed at election, or the "
    "elected block could no longer host a member at reserve time. "
    "Each fallback is a gang that will run its collectives over "
    "multi-hop ICI or DCN — sustained growth means the fleet is too "
    "fragmented for its gang shapes (defrag repairs rings; "
    "docs/topology.md runbook)",
    registry=REGISTRY,
)
GANGS_PENDING = Gauge(
    "tpushare_gangs_pending",
    "Gangs holding reservations below quorum (stuck gangs -> alert)",
    registry=REGISTRY,
)
UNSCHED_PODS = Gauge(
    "tpushare_unschedulable_pods",
    "TPU pods currently failing the filter on every offered node — "
    "demand the fleet cannot place. Sustained nonzero: add TPU nodes "
    "(the stock cluster-autoscaler cannot see extender resources).",
    registry=REGISTRY,
)
UNSCHED_HBM = Gauge(
    "tpushare_unschedulable_demand_hbm_gib",
    "Aggregate HBM (GiB) requested by currently-unplaceable TPU pods",
    registry=REGISTRY,
)
UNSCHED_CHIPS = Gauge(
    "tpushare_unschedulable_demand_chips",
    "Aggregate whole chips requested by currently-unplaceable TPU pods",
    registry=REGISTRY,
)
IS_LEADER = Gauge(
    "tpushare_leader",
    "1 when this replica binds (lease holder, or election off); 0 when "
    "a standby follower. Flapping -> alert",
    registry=REGISTRY,
)
HBM_REPORTED = Gauge(
    "tpushare_node_hbm_reported_gib",
    "HBM tenants REPORT using per node (sum of the watchdog-written "
    "tpushare.io/hbm-used annotations; only pods opted into the usage "
    "heartbeat contribute). Compare against tpushare_node_hbm_used_gib "
    "(the ledger's committed grants): reported > committed means an "
    "overrun somewhere on the node.",
    ["node"], registry=REGISTRY,
)
OVERRUN_PODS = Gauge(
    "tpushare_overrun_pods",
    "Pods currently flagged over their grant per node (fleet-level "
    "aggregate of the device plugins' per-pod tpushare_grant_overrun)",
    ["node"], registry=REGISTRY,
)
EVENTS_DROPPED = Counter(
    "tpushare_events_dropped_total",
    "k8s Events dropped: emission queue full, or the POST to the "
    "apiserver failed. Nonzero means kubectl-describe is missing part "
    "of the placement story (check events RBAC / apiserver load)",
    registry=REGISTRY,
)
EVENTS_QUEUE_DEPTH = Gauge(
    "tpushare_events_queue_depth",
    "k8s Events accepted but not yet POSTed (the async emitter's "
    "backlog; sustained growth precedes drops)",
    registry=REGISTRY,
)
WORKQUEUE_DEPTH = Gauge(
    "tpushare_workqueue_depth",
    "Sync-controller workqueue backlog: keys ready or in backoff delay "
    "(in-flight keys excluded). Sustained growth means the ledger is "
    "falling behind the apiserver",
    registry=REGISTRY,
)
WORKQUEUE_RETRIES = Gauge(
    "tpushare_workqueue_retries_total",
    "Cumulative rate-limited requeues of sync keys (failed sync_pod "
    "attempts re-entering with backoff). Set from the queue's "
    "monotonic counter at scrape time",
    registry=REGISTRY,
)
INFORMER_RELISTS = Counter(
    "tpushare_informer_relists_total",
    "Watch-stream reconnect resyncs (one per kind per reconnect): the "
    "informer diffed a fresh LIST against its store to recover events "
    "lost in the gap. A steady rate means the watch keeps dropping",
    registry=REGISTRY,
)
QUOTA_DENIED = Counter(
    "tpushare_quota_denied_total",
    "Pods denied at filter because their tenant would exceed its hard "
    "quota limit. NOT unplaceable demand: capacity exists, the tenant "
    "is over policy — the autoscaler must not scale for these",
    ["tenant"], registry=REGISTRY,
)
QUOTA_GUARANTEE_HBM = Gauge(
    "tpushare_quota_guarantee_hbm_gib",
    "Guaranteed HBM share per tenant (from the tpushare-quotas "
    "ConfigMap); usage beyond it is borrowing, reclaimed first",
    ["tenant"], registry=REGISTRY,
)
QUOTA_LIMIT_HBM = Gauge(
    "tpushare_quota_limit_hbm_gib",
    "Hard HBM ceiling per tenant; filter denies pods past it",
    ["tenant"], registry=REGISTRY,
)
QUOTA_USED_HBM = Gauge(
    "tpushare_quota_used_hbm_gib",
    "HBM currently charged to the tenant's ledger (granted slices of "
    "assumed, non-terminated pods)",
    ["tenant"], registry=REGISTRY,
)
QUOTA_BORROWED_HBM = Gauge(
    "tpushare_quota_borrowed_hbm_gib",
    "HBM the tenant holds beyond its guarantee — idle capacity on "
    "loan, evicted first when an under-guarantee tenant cannot fit",
    ["tenant"], registry=REGISTRY,
)
QUOTA_GUARANTEE_CHIPS = Gauge(
    "tpushare_quota_guarantee_chips",
    "Guaranteed whole-chip share per tenant",
    ["tenant"], registry=REGISTRY,
)
QUOTA_LIMIT_CHIPS = Gauge(
    "tpushare_quota_limit_chips",
    "Hard whole-chip ceiling per tenant",
    ["tenant"], registry=REGISTRY,
)
QUOTA_USED_CHIPS = Gauge(
    "tpushare_quota_used_chips",
    "Whole chips currently charged to the tenant's ledger",
    ["tenant"], registry=REGISTRY,
)
QUOTA_BORROWED_CHIPS = Gauge(
    "tpushare_quota_borrowed_chips",
    "Whole chips the tenant holds beyond its guarantee",
    ["tenant"], registry=REGISTRY,
)
UNSCHED_PODS_TENANT = Gauge(
    "tpushare_unschedulable_pods_by_tenant",
    "Per-tenant breakdown of tpushare_unschedulable_pods: WHOSE demand "
    "is unplaceable (quota-denied pods excluded — they are policy, "
    "not missing capacity)",
    ["tenant"], registry=REGISTRY,
)
UNSCHED_HBM_TENANT = Gauge(
    "tpushare_unschedulable_demand_hbm_gib_by_tenant",
    "Per-tenant breakdown of the unplaceable HBM demand",
    ["tenant"], registry=REGISTRY,
)
UNSCHED_CHIPS_TENANT = Gauge(
    "tpushare_unschedulable_demand_chips_by_tenant",
    "Per-tenant breakdown of the unplaceable whole-chip demand",
    ["tenant"], registry=REGISTRY,
)

# -- Fragmentation and defrag (tpushare_torch/defrag/) ---------------------- #

CLUSTER_STRANDED_HBM = Gauge(
    "tpushare_cluster_stranded_hbm_gib",
    "Free HBM no currently-pending demand shape can use: splinters "
    "smaller than every pending slice request, free chips on nodes too "
    "fragmented for the pending whole-chip requests. Sustained nonzero "
    "while pods sit unschedulable means the fleet needs DEFRAG, not "
    "more nodes (compare tpushare_unschedulable_demand_hbm_gib)",
    registry=REGISTRY,
)
NODE_FRAG_SCORE = Gauge(
    "tpushare_node_frag_score",
    "Per-node fragmentation score: the fraction of the node's free HBM "
    "that is stranded against the pending demand shapes (0 = every "
    "free byte is usable, 1 = all of it is splinters nobody can take)",
    ["node"], registry=REGISTRY,
)
DEFRAG_MOVES = Counter(
    "tpushare_defrag_moves_total",
    "Defrag rebalance moves by outcome: evicted (active mode), dry-run "
    "(proposed only), deferred (PDB block / node cooldown), aborted "
    "(SLO burn or budget exhaustion cancelled the rest of the plan), "
    "failed, gone",
    ["outcome"], registry=REGISTRY,
)
DEFRAG_PLANS_ABORTED = Counter(
    "tpushare_defrag_plans_aborted_total",
    "Defrag plans aborted mid-flight, by reason: slo-burn (the SLO "
    "engine reported a burning objective — defrag must never worsen "
    "the journeys it serves) or budget (the hourly eviction budget ran "
    "out). See the docs/defrag.md runbook",
    ["reason"], registry=REGISTRY,
)

TELEMETRY_ERRORS = Counter(
    "tpushare_telemetry_errors_total",
    "Errors swallowed on telemetry paths (metrics scrape parse, trace "
    "recording) — the code path survived, the observation was lost",
    registry=REGISTRY,
)

# -- Pod-journey SLOs (tpushare_torch/slo/) --------------------------------- #

#: Journey latencies run from sub-second (an idle fleet binds in one
#: attempt) to many minutes (quota pressure, missing capacity) — the
#: buckets must resolve both the 30s default objective's boundary and
#: the long tail that burns its budget.
_E2E_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                120.0, 300.0, 600.0, 1800.0)

POD_E2E = Histogram(
    "tpushare_pod_e2e_scheduling_seconds",
    "End-to-end scheduling latency per pod JOURNEY: pod creation to "
    "bound (outcome=bound), or to deletion/abandonment while still "
    "unbound. THE user-facing latency — per-verb histograms stay flat "
    "while a pod is denied 40 times; this one degrades. Rebuilt from "
    "the tpushare.io/assume-time annotation after a restart",
    ["tenant", "outcome"], registry=REGISTRY, buckets=_E2E_BUCKETS,
)
POD_ATTEMPTS = Histogram(
    "tpushare_pod_scheduling_attempts",
    "Placement attempts (flight-recorder decisions) per closed pod "
    "journey. A rising tail means pods are retrying their way to a "
    "bind instead of landing first try",
    ["tenant", "outcome"], registry=REGISTRY,
    buckets=(1, 2, 3, 5, 8, 13, 21, 40, 80),
)
SLO_BUDGET_REMAINING = Gauge(
    "tpushare_slo_error_budget_remaining",
    "Fraction of the SLO's error budget left over the 1h window (1.0 = "
    "untouched, 0.0 = exhausted). Objectives come from the "
    "tpushare-slos ConfigMap (built-in defaults when absent)",
    ["slo"], registry=REGISTRY,
)
SLO_BURN_RATE = Gauge(
    "tpushare_slo_burn_rate",
    "Error-budget burn-rate multiple per rolling window (1.0 = burning "
    "exactly at the objective's allowance). Both windows >= the SLO's "
    "fastBurn threshold fires a rate-limited TPUShareSLOBurn Event — "
    "see the docs/slo.md runbook",
    ["slo", "window"], registry=REGISTRY,
)

# -- Telemetry self-observability ------------------------------------------ #

SCRAPE_DURATION = Histogram(
    "tpushare_scrape_duration_seconds",
    "Wall time of a full /metrics scrape (gauge refresh + render). "
    "Growth means the scrape lock is taxing the verbs that share it",
    registry=REGISTRY, buckets=_BUCKETS,
)
SCRAPE_ERRORS = Counter(
    "tpushare_scrape_errors_total",
    "Scrapes that raised instead of rendering — Prometheus saw a gap "
    "where a sample should be",
    registry=REGISTRY,
)
TRACE_ABANDONED = Counter(
    "tpushare_trace_abandoned_total",
    "Open flight-recorder decisions evicted by table pressure before "
    "any outcome (retired as 'abandoned'). Sustained growth means pods "
    "start attempts that never finish — the recorder is losing the "
    "ends of stories",
    registry=REGISTRY,
)

# -- Per-verb cost ledger and continuous profiler ----------------------------- #
# Monotonic sources live in tpushare_torch/profiling (the ledger's counters,
# the sampler's cumulative frame counts); these gauges are set from them at
# scrape time, so a bounded label set, rebuilt each scrape, replaces
# unbounded counter children.

VERB_DECISIONS = Gauge(
    "tpushare_verb_decisions_total",
    "Verb phases closed since process start, per verb (filter, "
    "prioritize, preempt, bind, defrag:*). Monotonic; set at scrape "
    "time from the profiling cost ledger",
    ["verb"], registry=REGISTRY,
)
VERB_WALL = Gauge(
    "tpushare_verb_wall_seconds_total",
    "Cumulative wall time inside each verb's decision spans. The "
    "denominator of the per-verb cost story: compare the cpu/lock/api "
    "splits below against it",
    ["verb"], registry=REGISTRY,
)
VERB_CPU = Gauge(
    "tpushare_verb_cpu_seconds_total",
    "Cumulative thread-CPU time per verb (time.thread_time_ns deltas "
    "on the decision spans): the verb's own compute. wall - cpu - "
    "lock - api is the GIL/scheduler residue",
    ["verb"], registry=REGISTRY,
)
VERB_LOCK_WAIT = Gauge(
    "tpushare_verb_lock_wait_seconds_total",
    "Cumulative time each verb spent parked on contended "
    "TracingRLocks (the mutex-profile hook, folded per decision span)",
    ["verb"], registry=REGISTRY,
)
VERB_API = Gauge(
    "tpushare_verb_apiserver_seconds_total",
    "Cumulative apiserver round-trip time charged to each verb's "
    "decision spans (instrumented in tpushare/k8s/client.py)",
    ["verb"], registry=REGISTRY,
)
VERB_QUEUE_WAIT = Gauge(
    "tpushare_verb_queue_wait_seconds_total",
    "Cumulative wait in the HTTP layer's micro-batch gate BEFORE each "
    "verb span opened (routes/batch.py; also per-request as the "
    "queue;dur= Server-Timing component). Kept separate from the wall "
    "split — the verb's own clock never contains it. A rising share "
    "means batching is trading latency for throughput; check "
    "tpushare_http_batch_size and the window knobs (docs/perf.md)",
    ["verb"], registry=REGISTRY,
)
VERB_SELF_CPU = Gauge(
    "tpushare_verb_self_cpu_seconds_total",
    "Per-frame self-CPU attribution per (verb, frame_bucket): the "
    "duty-cycled decision probe's exact frame-share distribution "
    "scaled by the cost ledger's exact per-verb CPU totals (an "
    "in-process sampler cannot see sub-GIL-slice verbs, so verbs get "
    "the deterministic engine); background categories (idle/other) "
    "come from the continuous sampler's counters scaled by its "
    "interval. Bounded label set: top frames per verb plus an 'other' "
    "residue, rebuilt each scrape from monotonic sources. Flamegraph-"
    "grade detail: GET /debug/hotspots and /debug/profile/continuous "
    "(docs/perf.md)",
    ["verb", "frame_bucket"], registry=REGISTRY,
)
PROFILER_PASSES = Gauge(
    "tpushare_profiler_sampling_passes_total",
    "Continuous-profiler sampling passes since process start "
    "(monotonic; set at scrape time). Flat while TPUSHARE_PROFILE=off",
    registry=REGISTRY,
)
PROFILER_OVERHEAD = Gauge(
    "tpushare_profiler_overhead_ratio",
    "Fraction of the continuous profiler's scheduled time spent "
    "walking stacks — its self-reported cost. The bench --scale "
    "overhead gate additionally holds the profiler's p99 latency "
    "impact to <= 5% (docs/perf.md)",
    registry=REGISTRY,
)

# -- HTTP wire path --------------------------------------------------------- #
# The webhook server's own plumbing: the bounded worker pool, the accept
# queue, keep-alive reuse and the micro-batch gate. The monotonic sources
# are GIL-bumped ints on the server object; the gauges are set at scrape
# time.

HTTP_POOL_WORKERS = Gauge(
    "tpushare_http_pool_workers",
    "Size of the HTTP worker pool (TPUSHARE_HTTP_WORKERS). Each "
    "worker owns one connection at a time for its keep-alive "
    "lifetime, so this is also the concurrent-connection bound",
    registry=REGISTRY,
)
HTTP_ACCEPT_QUEUE_DEPTH = Gauge(
    "tpushare_http_accept_queue_depth",
    "Accepted connections waiting for a pool worker at scrape time. "
    "Persistently nonzero means the pool is saturated — the accept "
    "loop is back-pressuring; raise TPUSHARE_HTTP_WORKERS or find the "
    "slow verb (docs/perf.md runbook)",
    registry=REGISTRY,
)
HTTP_CONNECTIONS = Gauge(
    "tpushare_http_connections_total",
    "TCP connections accepted since process start (monotonic; set at "
    "scrape time from the server's counter)",
    registry=REGISTRY,
)
HTTP_REQUESTS = Gauge(
    "tpushare_http_requests_total",
    "HTTP requests served since process start (monotonic; set at "
    "scrape time). requests/connections is the keep-alive reuse "
    "factor a healthy scheduler transport keeps high",
    registry=REGISTRY,
)
HTTP_KEEPALIVE_REUSES = Gauge(
    "tpushare_http_keepalive_reuses_total",
    "Requests served on an already-used keep-alive connection "
    "(monotonic; set at scrape time). Near zero under steady load "
    "means the caller reconnects per webhook call — it is paying a "
    "TCP (and TLS) handshake per placement",
    registry=REGISTRY,
)
HTTP_BATCH_SIZE = Histogram(
    "tpushare_http_batch_size",
    "Requests per micro-batch drain of the read verbs, INCLUDING the "
    "depth-1 direct path (routes/batch.py). Mass above 1 is the "
    "snapshot/probe sharing actually happening under concurrent "
    "clients; all-1s just means the callers never overlap",
    registry=REGISTRY, buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32),
)


# -- Process self-metrics --------------------------------------------------- #

PROCESS_RSS = Gauge(
    "tpushare_process_rss_bytes",
    "Resident set size of the extender process (/proc/self/statm; "
    "peak-RSS via resource.getrusage where /proc is absent). Sustained "
    "growth across scrapes is a leak — check the flight ring, journey "
    "tables, and /debug/pprof/heap",
    registry=REGISTRY,
)
PROCESS_FDS = Gauge(
    "tpushare_process_open_fds",
    "Open file descriptors (/proc/self/fd). Growth means leaked "
    "sockets — watch streams or webhook keep-alives not being closed",
    registry=REGISTRY,
)
PROCESS_THREADS = Gauge(
    "tpushare_process_threads",
    "Live Python threads (threading.active_count): HTTP handlers, "
    "sync workers, informer watches, housekeeping, the profiler. "
    "Unbounded growth means a thread leak in one of them",
    registry=REGISTRY,
)
GC_TRACKED = Gauge(
    "tpushare_gc_tracked_objects",
    "Objects currently tracked per GC generation (gc.get_count). "
    "Gen-2 growth is the heap the stop-the-world collections walk — "
    "the pause source docs/perf.md budgets",
    ["generation"], registry=REGISTRY,
)
GC_COLLECTIONS = Gauge(
    "tpushare_gc_collections_total",
    "Cumulative GC collections per generation (gc.get_stats; "
    "monotonic, set at scrape time). A rising gen-2 rate on the "
    "webhook path shows up as latency p99 spikes",
    ["generation"], registry=REGISTRY,
)
BUILD_INFO = Gauge(
    "tpushare_build_info",
    "Always 1; the labels carry the extender version and Python "
    "runtime so dashboards and the timeline can bracket restarts and "
    "correlate behavior changes with rollouts",
    ["version", "python"], registry=REGISTRY,
)
UPTIME = Gauge(
    "tpushare_uptime_seconds",
    "Seconds since this process imported the metrics layer. A reset "
    "to ~0 on an otherwise-continuous scrape series IS the restart "
    "marker retrospective queries bracket on",
    registry=REGISTRY,
)
ANOMALIES_FIRED = Gauge(
    "tpushare_anomaly_fired_total",
    "Anomaly-rule firings (threshold / rate-of-change / z-score "
    "watchers over the timeline rings; monotonic, set at scrape from "
    "the engine's counters). Each firing stamped a timeline marker "
    "and, rate-limited, a TPUShareAnomaly Event carrying the cursor",
    ["rule"], registry=REGISTRY,
)
TIMELINE_DROPPED = Gauge(
    "tpushare_timeline_dropped_total",
    "Timeline points/markers lost to the memory caps plus exceptions "
    "swallowed on the fire-and-forget record path (monotonic, set at "
    "scrape). Nonzero eviction is normal once rings wrap; a RISING "
    "swallowed count means the retrospective layer itself is broken",
    registry=REGISTRY,
)
TIMELINE_SERIES = Gauge(
    "tpushare_timeline_series",
    "Series currently held in the timeline rings (capped; at the cap "
    "the coldest series is evicted per new one)",
    registry=REGISTRY,
)
WITNESS_MATCHED = Gauge(
    "tpushare_witness_events_matched_total",
    "Fleet-day witness verdicts: injected events whose declared "
    "marker/Event/metric legs all surfaced inside the conformance "
    "window (monotonic, set at scrape from the witness counters)",
    registry=REGISTRY,
)
WITNESS_LATE = Gauge(
    "tpushare_witness_events_late_total",
    "Fleet-day witness verdicts: injected events whose legs all "
    "surfaced but whose marker landed past the conformance window "
    "(monotonic, set at scrape)",
    registry=REGISTRY,
)
WITNESS_MISSING = Gauge(
    "tpushare_witness_events_missing_total",
    "Fleet-day witness verdicts: injected events with at least one "
    "declared leg that never surfaced — the page that would not have "
    "fired (monotonic, set at scrape)",
    registry=REGISTRY,
)
WITNESS_SPURIOUS = Gauge(
    "tpushare_witness_events_spurious_total",
    "Fleet-day witness verdicts: observed markers of witnessed kinds "
    "no expectation's window explains — the page that fired for "
    "nothing (monotonic, set at scrape)",
    registry=REGISTRY,
)


#: Process birth for tpushare_uptime_seconds: this module is imported
#: within milliseconds of every entry point's start.
_PROCESS_START = _time_mod.time()


def reset() -> None:
    """Every family back to its state at birth (tests)."""
    REGISTRY.reset()


def render() -> bytes:
    with _SCRAPE_LOCK:
        text = REGISTRY.render()
    # The exemplars go on outside the scrape lock (they read only the obs
    # layer's own lock-free cells); annotate_metrics returns the text
    # unchanged on any failure.
    from tpushare_torch import obs
    return obs.annotate_metrics(text)


def observe_timeline() -> None:
    """Refresh the retrospective layer's own series: build and uptime
    (restart bracketing), anomaly firings, the timeline's drops and
    series, and the fleet-day witness's verdict totals."""
    import platform

    from tpushare_torch import __version__, obs

    with _SCRAPE_LOCK:
        BUILD_INFO.labels(version=__version__,
                          python=platform.python_version()).set(1)
        UPTIME.set(_time_mod.time() - _PROCESS_START)
        timeline = obs.timeline()
        TIMELINE_SERIES.set(timeline.series_count())
        TIMELINE_DROPPED.set(timeline.drops.value
                             + timeline.mark_drops.value
                             + obs.exemplars().drops.value)
        ANOMALIES_FIRED.clear()
        for rule, count in obs.anomalies().fired_counts().items():
            ANOMALIES_FIRED.labels(rule=rule).set(count)
        counts = obs.witness().counts()
        WITNESS_MATCHED.set(counts["matched"])
        WITNESS_LATE.set(counts["late"])
        WITNESS_MISSING.set(counts["missing"])
        WITNESS_SPURIOUS.set(counts["spurious"])


def observe_cache(cache) -> None:
    """Refresh the per-node gauges from the ledger, rebuilt from scratch
    each scrape so a deleted node's series disappears instead of
    freezing at its last value."""
    from tpushare_torch.utils import const

    with _SCRAPE_LOCK:
        HBM_TOTAL.clear()
        HBM_USED.clear()
        HBM_REPORTED.clear()
        OVERRUN_PODS.clear()
        for info in cache.get_node_infos():
            HBM_TOTAL.labels(node=info.name).set(info.total_hbm)
            used = sum(c.get_used_hbm() for c in info.chips.values())
            HBM_USED.labels(node=info.name).set(used)
            # The watchdog's reports through the apiserver: a pod on
            # several cards appears on each, so count it once.
            reported = 0.0
            overrunning = 0
            saw_report = False  # wired up and using zero still emits
            seen: set[str] = set()
            for chip in info.chips.values():
                for p in chip.snapshot_pods():
                    if p.uid in seen:
                        continue
                    seen.add(p.uid)
                    raw = p.annotations.get(const.ANN_HBM_USED)
                    if raw is not None:
                        try:
                            reported += float(raw)
                            saw_report = True
                        except ValueError:
                            # A corrupt report: skipped, and counted.
                            safe_inc(TELEMETRY_ERRORS)
                    if p.annotations.get(const.ANN_OVERRUN) == \
                            const.ASSIGNED_TRUE:
                        overrunning += 1
            if saw_report or overrunning:
                HBM_REPORTED.labels(node=info.name).set(
                    round(reported, 2))
                OVERRUN_PODS.labels(node=info.name).set(overrunning)


def observe_topology(cache) -> None:
    """Rebuild the per-gang ring-contiguity gauge from the live ledger
    (slice-shape gangs with assigned, running members, in worker order),
    so a finished gang's series disappears; the gang planner's set at
    commit gives the value at once."""
    from tpushare_torch.topology import fleet
    from tpushare_torch.utils import const
    from tpushare_torch.utils import pod as podutils

    with _SCRAPE_LOCK:
        GANG_RING_CONTIGUITY.clear()
        gangs: dict = {}
        for info in cache.get_node_infos():
            seen: set = set()
            for chip in info.chips.values():
                for p in chip.snapshot_pods():
                    if p.uid in seen or podutils.is_complete_pod(p):
                        continue
                    seen.add(p.uid)
                    group = p.annotations.get(const.ANN_POD_GROUP)
                    if not group or podutils.get_slice_shape(p) is None:
                        continue
                    key = f"{p.namespace}/{group}"
                    gangs.setdefault(key, {})[p.name] = info.node
        for key, members in gangs.items():
            ordered = sorted(members, key=fleet.worker_sort_key)
            stats = fleet.gang_ring_stats(
                [members[name] for name in ordered])
            if stats is not None:
                GANG_RING_CONTIGUITY.labels(gang=key).set(
                    stats["contiguity"])


def observe_quota(quota) -> None:
    """Refresh the per-tenant quota gauges from the tenant ledger, rebuilt
    each scrape so a tenant whose last pod exited, or whose ConfigMap
    entry went, drops its series."""
    with _SCRAPE_LOCK:
        for gauge in (QUOTA_GUARANTEE_HBM, QUOTA_LIMIT_HBM,
                      QUOTA_USED_HBM, QUOTA_BORROWED_HBM,
                      QUOTA_GUARANTEE_CHIPS, QUOTA_LIMIT_CHIPS,
                      QUOTA_USED_CHIPS, QUOTA_BORROWED_CHIPS):
            gauge.clear()
        for entry in quota.snapshot():
            tenant = entry["tenant"]
            QUOTA_USED_HBM.labels(tenant=tenant).set(entry["usedHBM"])
            QUOTA_USED_CHIPS.labels(tenant=tenant).set(entry["usedChips"])
            QUOTA_BORROWED_HBM.labels(tenant=tenant).set(
                entry["borrowedHBM"])
            QUOTA_BORROWED_CHIPS.labels(tenant=tenant).set(
                entry["borrowedChips"])
            for key, gauge in (("guaranteeHBM", QUOTA_GUARANTEE_HBM),
                               ("limitHBM", QUOTA_LIMIT_HBM),
                               ("guaranteeChips", QUOTA_GUARANTEE_CHIPS),
                               ("limitChips", QUOTA_LIMIT_CHIPS)):
                if key in entry:
                    gauge.labels(tenant=tenant).set(entry[key])


def observe_slo() -> None:
    """Refresh the SLO budget and burn gauges from the engine's rolling
    windows (this evaluation is also what fires the rate-limited
    TPUShareSLOBurn alert). Rebuilt each scrape, so a renamed or removed
    objective drops its series instead of freezing."""
    # Imported here: the slo package imports this module lazily on its
    # journey-close path.
    from tpushare_torch import slo as slo_mod

    with _SCRAPE_LOCK:
        SLO_BUDGET_REMAINING.clear()
        SLO_BURN_RATE.clear()
        for row in slo_mod.engine().evaluate():
            SLO_BUDGET_REMAINING.labels(slo=row["slo"]).set(
                row["errorBudgetRemaining"])
            for window, view in row["windows"].items():
                SLO_BURN_RATE.labels(slo=row["slo"], window=window).set(
                    view["burnRate"])


def observe_frag(defrag) -> None:
    """Refresh the fragmentation gauges from the defrag executor's index
    (frag.py over the live ledger and the pending demand shapes). Rebuilt
    each scrape, so a deleted node's score drops its series. A broken
    read is counted and keeps both gauges' last values together."""
    with _SCRAPE_LOCK:
        try:
            report = defrag.frag_snapshot()
        except Exception:
            safe_inc(TELEMETRY_ERRORS)
            return
        NODE_FRAG_SCORE.clear()
        CLUSTER_STRANDED_HBM.set(report["strandedHBM"])
        for node in report["nodes"]:
            NODE_FRAG_SCORE.labels(node=node["node"]).set(node["score"])


def observe_profiling() -> None:
    """Refresh the per-verb cost gauges and the profiler's self-series
    from tpushare_torch.profiling's monotonic sources. Rebuilt each scrape so
    the frame_bucket label set stays the CURRENT top frames (a frame
    that left the top-N folds into 'other' instead of freezing)."""
    # Lazy import: profiling imports trace, which the server imports
    # alongside this module.
    from tpushare_torch import profiling

    with _SCRAPE_LOCK:
        for gauge in (VERB_DECISIONS, VERB_WALL, VERB_CPU,
                      VERB_LOCK_WAIT, VERB_API, VERB_QUEUE_WAIT,
                      VERB_SELF_CPU):
            gauge.clear()
        ledger_rows = profiling.ledger().snapshot()
        for verb, row in ledger_rows.items():
            VERB_DECISIONS.labels(verb=verb).set(row["decisions"])
            VERB_WALL.labels(verb=verb).set(row["wallSeconds"])
            VERB_CPU.labels(verb=verb).set(row["cpuSeconds"])
            VERB_LOCK_WAIT.labels(verb=verb).set(row["lockWaitSeconds"])
            VERB_API.labels(verb=verb).set(row["apiSeconds"])
            VERB_QUEUE_WAIT.labels(verb=verb).set(
                row.get("queueWaitSeconds", 0.0))
        # Verb frame buckets: the decision probe's exact frame-share
        # distribution scaled by the ledger's exact CPU totals (the
        # sampler cannot see sub-GIL-slice verbs — see
        # tpushare_torch/profiling/decisions.py).
        for verb, shares in profiling.verb_frame_distribution().items():
            cpu_total = ledger_rows.get(verb, {}).get("cpuSeconds", 0.0)
            for frame, share in shares.items():
                VERB_SELF_CPU.labels(verb=verb, frame_bucket=frame).set(
                    round(cpu_total * share, 4))
        # Background categories (idle/other and any long-running verb
        # the sampler did catch) come from the sampler's cumulative
        # counters, scaled by its sampling interval.
        prof = profiling.profiler()
        for verb, frames in prof.cumulative_frames().items():
            if verb in ledger_rows:
                continue  # verb buckets above are authoritative
            for frame, seconds in frames.items():
                VERB_SELF_CPU.labels(verb=verb, frame_bucket=frame).set(
                    round(seconds, 3))
        status = prof.status()
        PROFILER_PASSES.set(status["samplingPasses"])
        PROFILER_OVERHEAD.set(status["overheadRatio"])


def _rss_bytes() -> int | None:
    """The resident set from /proc; the peak through ``resource`` where
    /proc is absent; None when neither exists."""
    import sys as _sys
    try:
        with open("/proc/self/statm", encoding="ascii") as f:
            pages = int(f.read().split()[1])
        return pages * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError):
        try:
            import resource
            peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss is in bytes on macOS, in KiB on Linux.
            return peak if _sys.platform == "darwin" else peak * 1024
        except Exception:  # noqa: BLE001 - a lost sample, counted
            safe_inc(TELEMETRY_ERRORS)
            return None


#: Whether /proc/self/fd exists: None until probed, then remembered, so
#: a platform without it is counted once, not every scrape.
_PROC_FDS_AVAILABLE: bool | None = None


def observe_process() -> None:
    """Refresh the process's own gauges (/proc, resource, gc,
    threading)."""
    import gc as _gc
    global _PROC_FDS_AVAILABLE

    with _SCRAPE_LOCK:
        rss = _rss_bytes()
        if rss is not None:
            PROCESS_RSS.set(rss)
        if _PROC_FDS_AVAILABLE is not False:
            try:
                PROCESS_FDS.set(len(os.listdir("/proc/self/fd")))
                _PROC_FDS_AVAILABLE = True
            except OSError:
                if _PROC_FDS_AVAILABLE is None:
                    safe_inc(TELEMETRY_ERRORS)
                _PROC_FDS_AVAILABLE = False
        PROCESS_THREADS.set(threading.active_count())
        for gen, tracked in enumerate(_gc.get_count()):
            GC_TRACKED.labels(generation=str(gen)).set(tracked)
        for gen, stats in enumerate(_gc.get_stats()):
            GC_COLLECTIONS.labels(generation=str(gen)).set(
                stats.get("collections", 0))


def observe_http(http_server) -> None:
    """Refresh the tpushare_http_* gauges from the server's counters and
    its live accept-queue depth."""
    with _SCRAPE_LOCK:
        stats = http_server.http_stats()
        HTTP_POOL_WORKERS.set(stats["workers"])
        HTTP_ACCEPT_QUEUE_DEPTH.set(stats["acceptQueueDepth"])
        HTTP_CONNECTIONS.set(stats["connectionsTotal"])
        HTTP_REQUESTS.set(stats["requestsTotal"])
        HTTP_KEEPALIVE_REUSES.set(stats["keepaliveReusesTotal"])


def scrape(cache, gang_planner=None, leader=None, demand=None,
           workqueue=None, quota=None, defrag=None,
           http_server=None) -> bytes:
    """The /metrics handler's atomic refresh and render, timed, and
    counted when it raises (a scrape that raises is a sample Prometheus
    never saw)."""
    from tpushare_torch.k8s import events as k8s_events

    t0 = _time_mod.perf_counter()
    try:
        with _SCRAPE_LOCK:
            observe_cache(cache)
            observe_topology(cache)
            observe_slo()
            observe_profiling()
            observe_process()
            observe_timeline()
            if http_server is not None:
                observe_http(http_server)
            if quota is not None:
                observe_quota(quota)
            if demand is not None:
                pods, hbm, chips = demand.snapshot()
                UNSCHED_PODS.set(pods)
                UNSCHED_HBM.set(hbm)
                UNSCHED_CHIPS.set(chips)
                for gauge in (UNSCHED_PODS_TENANT, UNSCHED_HBM_TENANT,
                              UNSCHED_CHIPS_TENANT):
                    gauge.clear()
                for tenant, (t_pods, t_hbm, t_chips) in \
                        demand.by_tenant().items():
                    UNSCHED_PODS_TENANT.labels(tenant=tenant).set(t_pods)
                    UNSCHED_HBM_TENANT.labels(tenant=tenant).set(t_hbm)
                    UNSCHED_CHIPS_TENANT.labels(tenant=tenant).set(t_chips)
            if defrag is not None:
                # After the demand block: the frag index reads the
                # tracker's shapes, which snapshot() just pruned.
                observe_frag(defrag)
            if gang_planner is not None:
                # stats() is the cheap view: no member lists, no TTLs.
                GANGS_PENDING.set(sum(
                    1 for g in gang_planner.stats().values()
                    if not g["committed"]))
            EVENTS_QUEUE_DEPTH.set(k8s_events.queue_depth())
            if workqueue is not None:
                st = workqueue.stats()
                WORKQUEUE_DEPTH.set(st["depth"] + st["delayed"])
                WORKQUEUE_RETRIES.set(st["retries"])
            # No election (one replica): this replica binds.
            IS_LEADER.set(1 if (leader is None or leader.is_leader())
                          else 0)
            return render()
    except Exception:
        # Raised on into the handler's HTTP 500; counted here.
        safe_inc(SCRAPE_ERRORS)
        raise
    finally:
        safe_observe(SCRAPE_DURATION, _time_mod.perf_counter() - t0)
