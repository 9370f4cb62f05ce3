"""Sample sources for the timeline sampler.

The port's copy of ``tpushare/obs/sources.py``. ``build_stack`` wires
``stranded_source`` to the defrag executor, and ``serve_stack`` wires
``router_source`` to the serving router it holds.

Each source is a zero-argument callable returning ``{series: value}``,
run on the sampler thread every tick. Two kinds:

* **direct** sources read a subsystem's own cheap snapshot (the same
  calls the ``/metrics`` scrape makes) so the series stay fresh even
  when nothing scrapes — ``tpushare_unschedulable_pods`` refreshed
  only at scrape time would give the timeline a flat line exactly when
  nobody was watching;
* :func:`registry_source` walks the live metrics registry for a
  whitelist of unlabeled gauges/counters — whatever the last scrape
  left there. Useful for series whose producer has no cheap snapshot.

Sources must never block on apiserver I/O: they read published
in-process state only (the hotpath budget's "sampler reads snapshots,
never rescans the fleet" rule).
"""

from __future__ import annotations

from typing import Any, Callable

#: Unlabeled registry samples worth a history by default.
REGISTRY_WHITELIST: tuple[str, ...] = (
    "tpushare_workqueue_depth",
    "tpushare_gangs_pending",
    "tpushare_events_queue_depth",
    "tpushare_http_accept_queue_depth",
    "tpushare_process_resident_memory_bytes",
)


def registry_source(
        names: tuple[str, ...] = REGISTRY_WHITELIST,
) -> Callable[[], dict[str, float]]:
    """Read the unlabeled gauges and counters of ``names`` from the
    metrics registry, by family, without rendering it (the labeled node
    gauges hold two series a node) and without ``_SCRAPE_LOCK``: each
    value is what the last scrape, or the family's own writer, left
    there. Series are named without the ``tpushare_`` prefix."""
    def sample() -> dict[str, float]:
        # Function-level import: metrics calls back into obs on its
        # render path.
        from tpushare_torch.routes import metrics
        wanted = set(names)
        out: dict[str, float] = {}
        for family in metrics.REGISTRY.families():
            if (family.name not in wanted or family.labelnames
                    or family.kind not in ("gauge", "counter")):
                continue
            key = family.name
            if key.startswith("tpushare_"):
                key = key[len("tpushare_"):]
            out[key] = float(family.get())
        return out
    return sample


def demand_source(demand: Any) -> Callable[[], dict[str, float]]:
    """Unplaceable demand from the tracker's own ledger."""
    def sample() -> dict[str, float]:
        pods, hbm, chips = demand.snapshot()
        return {"demand_unschedulable_pods": float(pods),
                "demand_hbm_gib": float(hbm),
                "demand_chips": float(chips)}
    return sample


def stranded_source(defrag: Any) -> Callable[[], dict[str, float]]:
    """Fleet stranded-HBM from the defrag executor's frag index."""
    def sample() -> dict[str, float]:
        report = defrag.frag_snapshot()
        return {"cluster_stranded_hbm_gib":
                float(report["strandedHBM"])}
    return sample


def workqueue_source(workqueue: Any) -> Callable[[], dict[str, float]]:
    def sample() -> dict[str, float]:
        st = workqueue.stats()
        return {"workqueue_depth": float(st["depth"] + st["delayed"])}
    return sample


def fleet_source(node_lister: Any) -> Callable[[], dict[str, float]]:
    """Fleet size and readiness from the node informer's lister — the
    autoscale and NotReady metric legs of the fleet-day witness."""
    def sample() -> dict[str, float]:
        nodes = node_lister()
        ready = sum(1 for n in nodes
                    if n.ready and not n.unschedulable)
        return {"fleet_nodes": float(len(nodes)),
                "fleet_nodes_ready": float(ready)}
    return sample


def router_source(router: Any) -> Callable[[], dict[str, float]]:
    """Serving queue pressure — the scale-out signal's raw input."""
    def sample() -> dict[str, float]:
        snap = router.snapshot()
        queued = sum(row["queued"]
                     for row in snap["tenants"].values())
        return {"router_queue_depth": float(queued),
                "router_fleet_slots": float(snap["fleetSlots"])}
    return sample
