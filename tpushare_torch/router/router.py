"""Tenant-aware router over a fleet of shared-chip decode servers.

The port's copy of ``tpushare/router/router.py``.

The decode fleet is the co-tenancy payoff: many low-HBM slot servers
(:mod:`tpushare_torch.workload.serving`) packed onto shared chips, each sized
by its scheduler grant (``max_batch_for_grant``). This module is the
front door that makes those servers a SERVICE:

* **Routing** — a request lands on the replica with the most free KV
  PAGES that can hold its whole reservation (paged replicas track a
  real page pool — ``serving.pages_for_grant`` over the grant — and a
  live shared prefix discounts the charge; rows-mode replicas derive
  pages from free slots, so mixed fleets rank in one unit), free
  slots then name breaking ties. A full fleet queues the request on
  the fleet-wide FIFO.
* **Shedding** — when the fleet is saturated, tenants holding more than
  their quota-derived share of the fleet's slots are shed (HTTP-429
  semantics), everyone else queues. Standing comes from the SAME
  ``tpushare-quotas`` guarantees the scheduler enforces
  (:class:`tpushare_torch.quota.QuotaManager`), so "over quota" means one
  thing platform-wide.
* **Scale-out** — sustained queue depth raises a signal (a counter, a
  snapshot field, and an optional callback) carrying the replica shape
  to provision; the scheduler places the pod, the operator registers
  the new replica, the queues drain. The e2e test drives exactly that
  loop over the real filter/bind verbs.
* **Telemetry** — rolling TTFT windows (p50/p99 via
  :mod:`tpushare_torch.utils.stats`), per-tenant served/shed/queued counts,
  fleet tokens/s; surfaced at ``GET /debug/router``, in
  ``tpushare_router_*`` metrics (set at scrape time from this ledger's
  monotonic counters), and by ``kubectl-inspect serving``.

:class:`DecodeReplica` carries an analytic service model (slots,
aggregate decode tokens/s, serial FIFO prefill, and an
``admission_overhead`` — the fraction of decode throughput an in-flight
prefill costs co-tenants: ~0.22 for whole-prompt admission, <= 0.10 for
the chunked-prefill server, the numbers ``bench_workload.py`` measures
on a TPU). The traffic-replay bench (``bench_router_torch.py``), chip
smoke's phase 2j and the e2e tests all drive this model; a production
deployment backs the same Router policy with RPC stubs reporting real
slot-server state.

Control-plane discipline: no torch import at module level (the router
runs in the scheduler/operator process), every shared-state mutation
under the ledger lock, clock injectable for deterministic replay.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import TYPE_CHECKING, Callable, Deque, Iterable

from tpushare_torch import obs
from tpushare_torch.utils import locks, stats
from tpushare_torch.workload.paging import PROMPT_BUCKETS, pages_for

if TYPE_CHECKING:  # pragma: no cover - typing only
    from tpushare_torch.quota.manager import QuotaManager
    from tpushare_torch.runtime.torchenv import ShareGrant

# PROMPT_BUCKETS is imported from tpushare_torch.workload.paging — the
# torch-free single source the slot server re-exports — so the router
# pads prompt lengths to the exact admission buckets the server
# compiles for without importing the torch-heavy workload module into
# the control plane (the cross-check test stays as the tripwire).

#: Rolling-window sizes.
TTFT_WINDOW = 512          #: TTFT samples kept per tenant and fleet-wide
TOKENS_WINDOW_S = 10.0     #: horizon for the fleet tokens/s figure

#: vet engine-5 state machine (docs/vet.md): a replica's
#: ``_charge_pages`` debits ``_pages_used`` (the capacity signal
#: ``can_admit`` gates on); the charge is owned by the inflight list
#: from admission until ``_retire_pages`` credits it back. A charge
#: leaked on a raising path inflates ``_pages_used`` forever and the
#: replica slowly stops admitting.
PROTOCOLS = [
    {
        "protocol": "page-charge",
        "acquire": [
            {"call": "_charge_pages", "recv": ["self"]},
        ],
        "release": [
            {"call": "_retire_pages", "recv": ["self"]},
        ],
        "doc": "Router replica page accounting: every charge retires "
               "with its request.",
    },
]


def _bucket(n: int, buckets: tuple[int, ...], max_len: int) -> int:
    """Padded admission length for an ``n``-token prompt (the compiled
    shape the slot server will reuse), capped at the cache."""
    for b in sorted(buckets):
        if b >= n:
            return min(b, max_len)
    return max_len


@dataclasses.dataclass
class Request:
    """One generation request riding through the router."""

    rid: str
    tenant: str
    prompt_len: int
    max_new: int
    arrival: float
    #: Prompt length padded to the admission bucket — what the prefill
    #: actually costs the replica.
    bucket: int = 0
    replica: str = ""
    admitted_at: float | None = None
    first_token_at: float | None = None
    done_at: float | None = None
    #: Prefill tokens still owed before the first token emits.
    prefill_remaining: float = 0.0
    #: Decode progress in tokens (float: rate-integrated).
    progress: float = 0.0
    #: KV pages charged to THIS request on its replica (private tail;
    #: shared prefix pages are charged to the prefix entry once).
    pages: int = 0
    #: Opaque caller-declared prompt-prefix identity (e.g. the chain
    #: hash of the system prompt). Empty = no sharing.
    prefix_key: str = ""
    #: Token length of the declared shared prefix.
    prefix_len: int = 0
    #: Whether this request holds a refcount on its replica's live
    #: prefix entry (set at admit, consumed at retire).
    holds_prefix: bool = False

    @property
    def ttft(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival


@dataclasses.dataclass(frozen=True)
class ReplicaEvent:
    """Something a replica's service model produced during advance()."""

    kind: str       #: ``first-token`` | ``complete``
    rid: str
    at: float


class DecodeReplica:
    """One decode pod behind the router: slot capacity + an analytic
    service model (exact piecewise-linear integration — events land at
    their true timestamps, not tick boundaries).

    ``slots`` is the KV-cache headroom story: build via
    :meth:`from_grant` and the count is ``max_batch_for_grant`` over
    the pod's torchenv HBM grant — the same arithmetic the tenant uses to
    size itself (COTENANCY runs). ``decode_tok_s`` is the replica's
    aggregate continuous-decode throughput (HBM-bound: the step reads
    the whole cache regardless of occupancy, so per-slot rate is
    aggregate/slots). ``admission_overhead`` is the decode throughput
    fraction an in-flight prefill steals from co-resident slots: 1.0
    models whole-prompt admission stalling the batch; the chunked
    server holds it <= 0.10 (the bench_workload gate)."""

    # decode_tok_s and prefill_tok_s default to the reference's figures,
    # measured on a TPU, not on the card: the twins' replays agree.
    def __init__(self, name: str, *, slots: int, node: str = "",
                 hbm_gib: float = 0.0, max_len: int = 2048,
                 decode_tok_s: float = 8400.0,
                 prefill_tok_s: float = 200_000.0,
                 admission_overhead: float = 0.10,
                 page_tokens: int = 64,
                 pages_total: int | None = None) -> None:
        if slots <= 0:
            raise ValueError(f"replica {name}: slots must be > 0")
        if page_tokens <= 0:
            raise ValueError(
                f"replica {name}: page_tokens must be > 0")
        if pages_total is not None and pages_total <= 0:
            raise ValueError(
                f"replica {name}: pages_total must be > 0 when paged")
        self.name = name
        self.node = node
        self.slots = slots
        self.hbm_gib = hbm_gib
        self.max_len = max_len
        self.decode_tok_s = decode_tok_s
        self.prefill_tok_s = prefill_tok_s
        self.admission_overhead = min(max(admission_overhead, 0.0), 1.0)
        #: Paged-KV capacity: ``pages_total`` not None means the pod
        #: runs the paged server (``serving.init_paged_state``) and
        #: HBM buys PAGES (``serving.pages_for_grant``); ``slots`` is
        #: then only the compiled batch ceiling. None = rows mode:
        #: every stream costs a whole [max_len] row and page figures
        #: are derived so mixed fleets compare in one unit.
        self.page_tokens = page_tokens
        self.pages_total = pages_total
        #: Owned by the Router (mutated only under its lock).
        self.inflight: list[Request] = []
        self._now: float | None = None
        self._pages_used = 0
        #: (tenant, prefix_key) -> [holders, shared pages] for live
        #: shared prefixes (charged once, refcounted by holders).
        self._prefix_live: dict[tuple[str, str], list[int]] = {}

    @classmethod
    def from_grant(cls, name: str, grant: "ShareGrant", *,
                   node: str = "", max_len: int = 2048,
                   cfg: object | None = None, paged: bool = False,
                   page_tokens: int = 64,
                   **kw: float) -> "DecodeReplica":
        """Size a replica from its scheduler HBM grant: slots =
        ``serving.max_batch_for_grant`` (weights once, then one KV-cache
        row per concurrent sequence). ``paged=True`` sizes the same
        grant in PAGES instead (``serving.pages_for_grant``) and doubles
        the slot ceiling — pages are then the binding capacity, and the
        extra slots are what lets a mixed-length trace actually use
        them (bench_workload's ``paged_decode`` density gate). Imports
        the torch-backed workload module lazily — control-plane callers
        that already know their capacity use the constructor
        directly."""
        from tpushare_torch.workload import model as M
        from tpushare_torch.workload import serving as S

        model_cfg = cfg if cfg is not None else M.ModelConfig()
        slots = S.max_batch_for_grant(model_cfg, grant.hbm_pod_gib,
                                      max_len=max_len)
        if slots <= 0:
            raise ValueError(
                f"replica {name}: grant {grant.hbm_pod_gib} GiB cannot "
                "hold the model weights — ask the scheduler for a "
                "bigger slice")
        if paged:
            pages = S.pages_for_grant(model_cfg, grant.hbm_pod_gib,
                                      page_tokens=page_tokens)
            return cls(name, slots=2 * slots, node=node,
                       hbm_gib=float(grant.hbm_pod_gib),
                       max_len=max_len, page_tokens=page_tokens,
                       pages_total=pages,
                       **kw)  # type: ignore[arg-type]
        return cls(name, slots=slots, node=node,
                   hbm_gib=float(grant.hbm_pod_gib), max_len=max_len,
                   **kw)  # type: ignore[arg-type]

    # -- service model -----------------------------------------------------

    def free_slots(self) -> int:
        return self.slots - len(self.inflight)

    def _row_pages(self) -> int:
        """Pages one whole [max_len] row is worth (the rows-mode
        exchange rate, so mixed fleets compare in one unit)."""
        return pages_for(self.max_len, self.page_tokens)

    def pages_total_effective(self) -> int:
        if self.pages_total is not None:
            return self.pages_total
        return self.slots * self._row_pages()

    def pages_free(self) -> int:
        """The routing signal: KV pages this replica can still grant.
        Rows mode derives it from free slots (a free slot IS a free
        row of pages), so pages-first routing ranks a mixed fleet
        consistently."""
        if self.pages_total is None:
            return self.free_slots() * self._row_pages()
        return self.pages_total - self._pages_used

    def _page_need(self, req: Request) -> int:
        """Pages admitting ``req`` would charge: the full reservation
        ``prompt + max_new`` (capped at the cache) minus any live
        same-tenant shared prefix — no preemption mid-stream, so the
        reservation is up-front."""
        if self.pages_total is None:
            return self._row_pages()
        need = pages_for(min(req.prompt_len + req.max_new,
                             self.max_len), self.page_tokens)
        need = max(need, 1)
        if req.prefix_key:
            live = self._prefix_live.get((req.tenant, req.prefix_key))
            if live is not None:
                need = max(need - live[1], 1)
        return need

    def can_admit(self, req: Request) -> bool:
        """A slot below the compiled ceiling AND pages for the full
        reservation (rows mode: the page check is trivially the slot
        check)."""
        if self.free_slots() <= 0:
            return False
        if self.pages_total is None:
            return True
        return self._page_need(req) <= self.pages_free()

    def admit(self, req: Request, now: float) -> bool:
        """Place ``req`` into a free slot; its prefill starts queueing
        behind earlier admissions (serial FIFO, like the slot server).
        Returns True when the admission reused a live shared prefix
        (the router's prefix-hit counter)."""
        req.replica = self.name
        req.admitted_at = now
        req.prefill_remaining = float(req.bucket)
        req.progress = 0.0
        hit = self._charge_pages(req)
        self.inflight.append(req)
        if self._now is None:
            self._now = now
        return hit

    def _charge_pages(self, req: Request) -> bool:
        """Page accounting at admit: shared prefix pages are charged
        ONCE to the live prefix entry (holders refcounted, the
        PagePool's model); the private tail is charged to the
        request."""
        if self.pages_total is None:
            req.pages = 0
            return False
        need_total = max(pages_for(min(req.prompt_len + req.max_new,
                                       self.max_len),
                                   self.page_tokens), 1)
        hit = False
        if req.prefix_key:
            # Shareable = FULL pages strictly below the last prompt
            # token (paging.shareable_pages semantics).
            shared = min(req.prefix_len,
                         max(req.prompt_len - 1, 0)) // self.page_tokens
            shared = min(shared, need_total - 1)
            key = (req.tenant, req.prefix_key)
            live = self._prefix_live.get(key)
            if shared > 0 and live is not None:
                live[0] += 1
                req.pages = need_total - min(shared, live[1])
                req.holds_prefix = True
                hit = True
            elif shared > 0:
                self._prefix_live[key] = [1, shared]
                self._pages_used += shared
                req.pages = need_total - shared
                req.holds_prefix = True
            else:
                req.pages = need_total
        else:
            req.pages = need_total
        self._pages_used += req.pages
        return hit

    def _retire_pages(self, req: Request) -> None:
        """Return a retiring request's page charge; the last holder of
        a shared prefix returns the prefix pages too."""
        if self.pages_total is None:
            return
        self._pages_used -= req.pages
        req.pages = 0
        if req.holds_prefix:
            req.holds_prefix = False
            key = (req.tenant, req.prefix_key)
            live = self._prefix_live.get(key)
            if live is not None:
                live[0] -= 1
                if live[0] <= 0:
                    self._pages_used -= live[1]
                    del self._prefix_live[key]

    def advance(self, now: float) -> tuple[list[ReplicaEvent], float]:
        """Integrate the service model up to ``now``. Returns (events,
        tokens generated) — events carry exact timestamps so TTFT
        percentiles are not quantized to the caller's tick."""
        events: list[ReplicaEvent] = []
        tokens = 0.0
        if self._now is None:
            self._now = now
        per_slot = self.decode_tok_s / self.slots
        guard = 0
        while self._now < now - 1e-12:
            guard += 1
            if guard > 10_000:  # defensive: float stall must not hang
                self._now = now
                break
            prefilling = [r for r in self.inflight
                          if r.prefill_remaining > 0]
            prefilling.sort(key=lambda r: (r.admitted_at or 0.0, r.rid))
            head = prefilling[0] if prefilling else None
            # A prefill cannot progress before its own admission: the
            # head's clock starts at max(model time, admitted_at), or
            # TTFT would go negative for requests admitted mid-tick.
            head_start = self._now
            if head is not None:
                head_start = max(self._now, head.admitted_at
                                 or self._now)
            head_active = head is not None and head_start <= self._now
            rate = per_slot * (1.0 - (self.admission_overhead
                                      if head_active else 0.0))
            decoding = [r for r in self.inflight
                        if r.prefill_remaining <= 0]
            # Completion is decided by EVENT TIME, not by residual
            # counters: at high rates an event's dt can underflow
            # against the clock (0.35 + 1e-17 == 0.35 in float64), and
            # a residual-only test then spins the loop at dt == 0
            # until the guard trips — every advance() call. When a
            # request's own completion time IS the chosen next event,
            # it completes, whatever float residue the subtraction
            # leaves.
            t_next = now
            t_pf = None
            if head is not None and self.prefill_tok_s > 0:
                t_pf = (max(head_start, self._now)
                        + head.prefill_remaining / self.prefill_tok_s)
                t_next = min(t_next, t_pf)
            t_dec: dict[str, float] = {}
            if rate > 0:
                for r in decoding:
                    t_dec[r.rid] = (self._now
                                    + (r.max_new - r.progress) / rate)
                    t_next = min(t_next, t_dec[r.rid])
            dt = max(t_next - self._now, 0.0)
            if head is not None:
                pf_dt = max(t_next - max(head_start, self._now), 0.0)
                head.prefill_remaining = max(
                    head.prefill_remaining
                    - pf_dt * self.prefill_tok_s, 0.0)
                if t_pf is not None and t_next >= t_pf:
                    head.prefill_remaining = 0.0
                if head.prefill_remaining <= 1e-9:
                    head.prefill_remaining = 0.0
                    # The admit's own first token emits with the
                    # finalize step — TTFT stops here.
                    head.first_token_at = t_next
                    head.progress = 1.0
                    tokens += 1.0
                    events.append(ReplicaEvent("first-token", head.rid,
                                               t_next))
            if rate > 0:
                for r in decoding:
                    before = r.progress
                    r.progress = min(r.progress + dt * rate,
                                     float(r.max_new))
                    if t_next >= t_dec[r.rid]:
                        r.progress = float(r.max_new)
                    tokens += r.progress - before
                    if r.progress >= r.max_new - 1e-9:
                        r.done_at = t_next
                        events.append(ReplicaEvent("complete", r.rid,
                                                   t_next))
            for r in self.inflight:
                if r.done_at is not None:
                    self._retire_pages(r)
            self.inflight = [r for r in self.inflight
                             if r.done_at is None]
            self._now = t_next
        return events, tokens


class _TenantStats:
    """Per-tenant ledger row (owned by the Router, under its lock)."""

    __slots__ = ("requests", "shed", "served_tokens", "completed",
                 "ttft")

    def __init__(self) -> None:
        self.requests = 0
        self.shed = 0
        self.served_tokens = 0.0
        self.completed = 0
        self.ttft: Deque[float] = deque(maxlen=TTFT_WINDOW)


class Router:
    """The decode fleet's front door. See the module docstring for the
    policy; every public method is thread-safe (one ledger lock)."""

    def __init__(self, quota: "QuotaManager | None" = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 buckets: tuple[int, ...] = PROMPT_BUCKETS,
                 queue_limit: int = 1024,
                 shed_slack: float = 2.0,
                 scaleout_queue_factor: float = 0.5,
                 scaleout_cooldown_s: float = 5.0,
                 on_scaleout: Callable[[dict], None] | None = None
                 ) -> None:
        #: Quota spec source for shedding standing; None = equal shares.
        self.quota = quota
        self.clock = clock
        self.buckets = buckets
        #: Fleet-wide cap on QUEUED requests — past it even
        #: under-standing tenants shed (memory is finite).
        self.queue_limit = queue_limit
        #: Outstanding-demand multiple of entitlement past which a
        #: saturated fleet sheds the tenant (see _should_shed).
        self.shed_slack = shed_slack
        #: Queues deeper than factor * fleet slots raise the signal.
        self.scaleout_queue_factor = scaleout_queue_factor
        self.scaleout_cooldown_s = scaleout_cooldown_s
        self.on_scaleout = on_scaleout
        self._lock = locks.TracingRLock("router/state")
        self._replicas: dict[str, DecodeReplica] = {}
        #: ONE fleet-wide FIFO: a request waits for the NEXT free slot
        #: anywhere, so a queued request can never strand behind one
        #: replica while another frees up.
        self._queue: Deque[Request] = deque()
        self._requests: dict[str, Request] = {}
        self._tenants: dict[str, _TenantStats] = {}
        self._ttft: Deque[float] = deque(maxlen=TTFT_WINDOW)
        self._token_events: Deque[tuple[float, float]] = deque(
            maxlen=4096)
        self._seq = 0
        self._scaleout_signals = 0
        self._scaleout_last = 0.0
        self._scaleout_wanted = False
        #: Prefix-reuse outcome counters (paged replicas, requests
        #: declaring a prefix_key): hit = admitted onto a replica
        #: already holding the prefix's pages.
        self._prefix_hits = 0
        self._prefix_misses = 0

    # -- fleet membership --------------------------------------------------

    def add_replica(self, replica: DecodeReplica) -> None:
        with self._lock:
            self._replicas[replica.name] = replica

    def remove_replica(self, name: str) -> None:
        """Drop a replica. Queued requests are unaffected (the queue
        is fleet-wide); its in-flight ones are the pod's to finish or
        lose."""
        with self._lock:
            gone = self._replicas.pop(name, None)
            if gone is not None:
                for req in gone.inflight:
                    self._requests.pop(req.rid, None)

    def replicas(self) -> list[DecodeReplica]:
        with self._lock:
            return list(self._replicas.values())

    # -- request path ------------------------------------------------------

    def submit(self, tenant: str, prompt_len: int, max_new: int,
               now: float | None = None, *, prefix_key: str = "",
               prefix_len: int = 0) -> dict:
        """Route one request. Returns the decision document:
        ``{"outcome": "assigned"|"queued"|"shed", "rid", ...}``.

        ``prefix_key``/``prefix_len`` declare a shareable prompt
        prefix (e.g. the tenant's system prompt): a paged replica
        already holding those pages charges only the private tail, so
        routing prefers it via ``pages_free`` and the fleet records a
        prefix hit. Sharing is per-tenant by construction — the key is
        scoped (tenant, prefix_key) end to end."""
        if now is None:
            now = self.clock()
        with self._lock:
            self._seq += 1
            rid = f"r{self._seq}"
            ts = self._tenants.setdefault(tenant, _TenantStats())
            ts.requests += 1
            max_len = (max(r.max_len for r in self._replicas.values())
                       if self._replicas else 2048)
            req = Request(rid=rid, tenant=tenant,
                          prompt_len=prompt_len, max_new=max_new,
                          arrival=now,
                          bucket=_bucket(prompt_len, self.buckets,
                                         max_len),
                          prefix_key=prefix_key,
                          prefix_len=max(int(prefix_len), 0))
            if not self._replicas:
                ts.shed += 1
                return {"outcome": "shed", "rid": rid,
                        "reason": "no-replicas"}
            # No replica's cache can hold the prompt: capping it to the
            # bucket table would admit a request the slot server must
            # reject (serving.bucket_len raises for the same length)
            # while billing its prefill short — refuse it up front.
            if prompt_len > max_len:
                ts.shed += 1
                return {"outcome": "shed", "rid": rid,
                        "reason": "prompt-too-long"}
            # Earlier arrivals first: drain the queues into any freed
            # slots BEFORE considering this one — a new arrival must
            # not jump a nonempty queue (a surge tenant's arrival rate
            # would let it monopolize every slot the instant one
            # frees), and queues must only persist under true
            # saturation (a queue lingering beside a free slot would
            # fire the scale-out signal on an idle fleet).
            self._drain_locked(now)
            # Most KV headroom first — in PAGES (free slots times the
            # row's pages for rows-mode replicas, the pool balance for
            # paged ones), free slots then name breaking ties. Only
            # replicas that can actually hold the reservation compete:
            # a paged replica with a free slot but an exhausted pool
            # must not win the max and strand the request.
            fits = [r for r in self._replicas.values()
                    if r.can_admit(req)]
            if fits and not self._queue:
                best = max(fits, key=lambda r: (r.pages_free(),
                                                r.free_slots(), r.name))
                self._requests[rid] = req
                self._note_prefix(req, best.admit(req, now))
                return {"outcome": "assigned", "rid": rid,
                        "replica": best.name}
            # Saturated: shed over-standing tenants, queue the rest.
            if len(self._queue) >= self.queue_limit:
                ts.shed += 1
                return {"outcome": "shed", "rid": rid,
                        "reason": "queue-full"}
            if self._should_shed(tenant):
                ts.shed += 1
                return {"outcome": "shed", "rid": rid,
                        "reason": "over-quota"}
            self._requests[rid] = req
            self._queue.append(req)
            return {"outcome": "queued", "rid": rid,
                    "depth": len(self._queue)}

    def _note_prefix(self, req: Request, hit: bool) -> None:
        """Fold one admission's prefix outcome into the fleet counters
        (paged replicas only — rows mode has no pages to share).
        Callers hold the lock."""
        if not req.prefix_key or not req.holds_prefix:
            return
        if hit:
            self._prefix_hits += 1
        else:
            self._prefix_misses += 1

    def _active_tenants(self) -> set[str]:
        """Tenants currently holding slots or waiting in the queue.
        Entitlement divides the fleet over THESE, not every tenant the
        ledger has ever seen — a stats row outlives its traffic, and
        splitting over historical tenants would permanently dilute the
        active ones into false sheds. Callers hold the lock."""
        active = {r.tenant for rep in self._replicas.values()
                  for r in rep.inflight}
        active.update(r.tenant for r in self._queue)
        return active

    def _entitled(self, tenant: str) -> float:
        """The tenant's slot entitlement: its share of the fleet. Share
        comes from the quota guarantees when configured
        (``guaranteeHBM`` weights — the platform's one definition of
        entitlement), equal split over active tenants otherwise.
        Callers hold the lock."""
        fleet = sum(r.slots for r in self._replicas.values())
        active = self._active_tenants()
        active.add(tenant)
        share = None
        if self.quota is not None:
            mine = self.quota.config_for(tenant)
            if self.quota.configured(tenant):
                weights = {
                    t: (self.quota.config_for(t).guarantee_hbm or 0)
                    for t in active}
                total = sum(weights.values())
                if total > 0:
                    share = (mine.guarantee_hbm or 0) / total
        if share is None:
            share = 1.0 / max(len(active), 1)
        return share * fleet

    def _should_shed(self, tenant: str) -> bool:
        """Shed decision for a new arrival on a saturated fleet: the
        tenant's QUEUED backlog is past ``shed_slack`` times its
        entitlement. Queued only, deliberately not held+queued: the
        dequeue skip already caps a tenant's HELD slots at its
        entitlement under contention, so held adds no signal — but it
        does add noise exactly when shedding must be precise (at surge
        onset a flooder grabs the whole idle pool work-conservingly,
        the in-quota tenants' queues spike while those borrowed slots
        retire, and counting their capped holds on top of the spike
        sheds the surge's VICTIMS). A flooder is the tenant whose queue
        cannot drain — offered load past entitlement — and that is the
        backlog this bounds. The slack keeps a tenant hovering AT its
        share queueing (quota policy must not punish in-quota spikes;
        the fleet-wide queue_limit backstops memory). Callers hold the
        lock."""
        queued = sum(1 for r in self._queue if r.tenant == tenant)
        return queued > self.shed_slack * self._entitled(tenant)

    def tick(self, now: float | None = None) -> list[ReplicaEvent]:
        """Advance every replica's service model, record TTFT and
        throughput, refill freed slots from the queues, and evaluate
        the scale-out signal. Drive this from the serving loop (or the
        bench/simulator clock)."""
        if now is None:
            now = self.clock()
        fired: Callable[[dict], None] | None = None
        spec: dict = {}
        out: list[ReplicaEvent] = []
        with self._lock:
            for rep in self._replicas.values():
                events, tokens = rep.advance(now)
                if tokens > 0:
                    self._token_events.append((now, tokens))
                for ev in events:
                    out.append(ev)
                    req = self._requests.get(ev.rid)
                    if req is None:
                        continue
                    ts = self._tenants.setdefault(req.tenant,
                                                  _TenantStats())
                    if ev.kind == "first-token" and req.ttft is not None:
                        ts.ttft.append(req.ttft)
                        self._ttft.append(req.ttft)
                    elif ev.kind == "complete":
                        ts.completed += 1
                        ts.served_tokens += req.max_new
                        self._requests.pop(ev.rid, None)
            self._drain_locked(now)
            queued_total = len(self._queue)
            fleet = sum(r.slots for r in self._replicas.values())
            self._scaleout_wanted = (
                queued_total > self.scaleout_queue_factor * max(fleet, 1))
            if (self._scaleout_wanted
                    and now - self._scaleout_last
                    >= self.scaleout_cooldown_s):
                self._scaleout_signals += 1
                self._scaleout_last = now
                fired = self.on_scaleout
                spec = self.scaleout_spec()
        if fired is not None:
            obs.mark("router-scaleout",
                     f"queue depth {queued_total} over "
                     f"{self.scaleout_queue_factor}x fleet slots "
                     f"({fleet})",
                     queued=queued_total, fleet_slots=fleet)
            # Outside the ledger lock: the callback schedules pods
            # (apiserver round-trips must never run under it).
            fired(spec)
        return out

    def _drain_locked(self, now: float) -> None:
        """Pull queued requests into free slots: fleet-wide FIFO,
        preferring tenants inside their standing — a shed-at-submit
        policy alone would still let an over-quota backlog drain into
        every freed slot ahead of in-quota tenants. WORK-CONSERVING:
        when only over-standing tenants wait, the FIFO head takes the
        slot anyway (idle capacity is exactly what quota borrowing is
        for; it returns at the request's completion). Callers hold the
        lock (re-entrant — re-taken here so the mutation is lexically
        guarded). A candidate drains while its HELD slots are at or
        under its entitlement (strictly over skips it — a tenant
        sitting exactly at its share still drains, so a sole tenant
        may fill the whole fleet; queued requests deliberately don't
        count against it, see _should_shed). Held counts and
        entitlements are computed ONCE per drain and maintained
        incrementally: the active-tenant set is stable across the loop
        (admission moves a request queue → inflight, membership
        unchanged), and re-deriving both per queued candidate per
        admission would make a deep-queue drain O(queue × tenants ×
        inflight) under the ledger lock, on the submit hot path."""
        with self._lock:
            if not self._queue:
                return
            held: dict[str, int] = {}
            for rep in self._replicas.values():
                for r in rep.inflight:
                    held[r.tenant] = held.get(r.tenant, 0) + 1
            entitled: dict[str, float] = {}
            while self._queue:
                free = [r for r in self._replicas.values()
                        if r.free_slots() > 0]
                if not free:
                    return
                # Candidate must FIT somewhere (pages for its whole
                # reservation, not just a slot): a paged fleet can
                # have free slots a long request's pages don't fit —
                # a shorter queued request behind it still drains
                # (rows mode: fit == free slot, identical to the old
                # policy).
                picked = None
                for idx, cand in enumerate(self._queue):
                    ent = entitled.get(cand.tenant)
                    if ent is None:
                        ent = entitled[cand.tenant] = self._entitled(
                            cand.tenant)
                    if held.get(cand.tenant, 0) <= ent and any(
                            r.can_admit(cand) for r in free):
                        picked = idx
                        break
                if picked is None:
                    # Work-conserving fallback: first FIFO entry that
                    # fits anywhere (idle capacity is what borrowing
                    # is for).
                    for idx, cand in enumerate(self._queue):
                        if any(r.can_admit(cand) for r in free):
                            picked = idx
                            break
                if picked is None:
                    return
                nxt = self._queue[picked]
                del self._queue[picked]
                fitting = [r for r in free if r.can_admit(nxt)]
                best = max(fitting, key=lambda r: (r.pages_free(),
                                                   r.free_slots(),
                                                   r.name))
                self._note_prefix(nxt, best.admit(nxt, now))
                held[nxt.tenant] = held.get(nxt.tenant, 0) + 1

    def scaleout_spec(self) -> dict:
        """The replica shape to provision: the fleet's modal grant (or
        a 1-chip 8-GiB decode slice when the fleet is empty)."""
        reps = list(self._replicas.values())
        if not reps:
            return {"hbmGiB": 8, "maxLen": 2048, "reason": "cold-start"}
        best = max(reps, key=lambda r: r.slots)
        spec = {"hbmGiB": best.hbm_gib or 8, "maxLen": best.max_len,
                "reason": "queue-depth"}
        if best.pages_total is not None:
            # Provision the paged shape: the new pod's capacity is a
            # page pool, not a row count.
            spec["pageTokens"] = best.page_tokens
            spec["pagesTotal"] = best.pages_total
        return spec

    # -- views -------------------------------------------------------------

    def _fleet_tokens_per_s(self, now: float) -> float:
        """Tokens/s over the trailing window (callers hold the lock)."""
        horizon = now - TOKENS_WINDOW_S
        total = sum(n for (t, n) in self._token_events if t > horizon)
        return total / TOKENS_WINDOW_S

    @staticmethod
    def _percentiles(window: Iterable[float]) -> dict:
        vals = sorted(window)
        if not vals:
            return {"p50": None, "p99": None, "samples": 0}
        return {"p50": round(stats.quantile_sorted(vals, 0.50), 6),
                "p99": round(stats.quantile_sorted(vals, 0.99), 6),
                "samples": len(vals)}

    def snapshot(self) -> dict:
        """The ``GET /debug/router`` document (also what the metrics
        scrape and kubectl-inspect render)."""
        now = self.clock()
        with self._lock:
            fleet_slots = sum(r.slots for r in self._replicas.values())
            in_use = sum(len(r.inflight)
                         for r in self._replicas.values())
            tenants = {}
            for name, ts in sorted(self._tenants.items()):
                tenants[name] = {
                    "requests": ts.requests,
                    "shed": ts.shed,
                    "completed": ts.completed,
                    "servedTokens": round(ts.served_tokens, 1),
                    "inflight": sum(
                        1 for rep in self._replicas.values()
                        for r in rep.inflight if r.tenant == name),
                    "queued": sum(1 for r in self._queue
                                  if r.tenant == name),
                    "ttft": self._percentiles(ts.ttft),
                }
            replicas = [{
                "name": r.name, "node": r.node, "slots": r.slots,
                "inUse": len(r.inflight),
                "hbmGiB": r.hbm_gib, "maxLen": r.max_len,
                "decodeTokS": r.decode_tok_s,
                "admissionOverhead": r.admission_overhead,
                "paged": r.pages_total is not None,
                "pageTokens": r.page_tokens,
                "pagesTotal": r.pages_total_effective(),
                "pagesFree": r.pages_free(),
            } for r in sorted(self._replicas.values(),
                              key=lambda r: r.name)]
            looked = self._prefix_hits + self._prefix_misses
            return {
                "fleetSlots": fleet_slots,
                "slotsInUse": in_use,
                "fleetPages": sum(r.pages_total_effective()
                                  for r in self._replicas.values()),
                "fleetPagesFree": sum(r.pages_free()
                                      for r in self._replicas.values()),
                "queuedTotal": len(self._queue),
                "fleetTokensPerS": round(
                    self._fleet_tokens_per_s(now), 1),
                "ttft": self._percentiles(self._ttft),
                "prefix": {
                    "hits": self._prefix_hits,
                    "misses": self._prefix_misses,
                    "hitRate": (round(self._prefix_hits / looked, 4)
                                if looked else None),
                },
                "tenants": tenants,
                "replicas": replicas,
                "scaleOut": {
                    "signals": self._scaleout_signals,
                    "wanted": self._scaleout_wanted,
                    "spec": self.scaleout_spec(),
                },
            }
