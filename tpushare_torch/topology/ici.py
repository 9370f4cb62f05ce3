"""The reference's ring-latency model of a TPU slice's ICI and DCN.

A copy of the ring model in ``tpushare/workload/parallel.py`` (its
constants, ``hop_time_us``, ``ring_rotation_time_us``,
``ring_collective_time_us`` and ``predicted_step_time_ms``), kept so that
the port's tools price a ring over TPU hosts as the reference's tools do:
``tools/simulate_torch.py``'s gang report and the twin of ``bench.py
--topology``. Its figures are the reference's TPU model (v5p-class ICI
links and a host NIC), not a figure of any NVIDIA card; a ring over
NVIDIA nodes is priced by the port's own NVLink/NIC model in
:mod:`tpushare_torch.workload.parallel`.

The model, as the reference states it:

* A logical hop between ring neighbors ``d`` grid hops apart rides ``d``
  physical ICI links, and in a ring where every neighbor pair is about
  ``d`` hops apart each physical link carries about ``d`` logical
  streams, so the effective per-stream bandwidth is link/d and the
  latency term is d per-hop latencies. Contiguity (d == 1 everywhere) is
  the optimum.
* A hop whose endpoints share no slice (or whose position is unknown)
  leaves the ICI domain entirely: DCN latency + NIC bandwidth.
"""

from __future__ import annotations

#: Per-direction ICI link bandwidth, GiB/s (the reference's v5p-class
#: figure; the model's ratios, ICI vs DCN and 1-hop vs d-hop, are what
#: its bench gates on).
ICI_LINK_GIBPS = 90.0
#: Single ICI hop latency, µs (the reference's).
ICI_HOP_LATENCY_US = 1.0
#: Host NIC / datacenter-network bandwidth, GiB/s (the reference's).
DCN_GIBPS = 12.5
#: DCN crossing latency, µs (the reference's).
DCN_LATENCY_US = 50.0


def hop_time_us(hops: int | None, payload_bytes: float) -> float:
    """Time for one logical ring hop carrying ``payload_bytes``.
    ``hops`` is the grid distance between the ring neighbors; ``None``
    means the hop leaves the slice (DCN). Zero hops (two workers on one
    host) ride the host's own ICI as one hop."""
    gib = payload_bytes / (1024.0 ** 3)
    if hops is None:
        return DCN_LATENCY_US + gib / DCN_GIBPS * 1e6
    d = max(int(hops), 1)
    return d * ICI_HOP_LATENCY_US + gib / (ICI_LINK_GIBPS / d) * 1e6


def ring_rotation_time_us(hop_list: list[int | None],
                          payload_bytes: float) -> float:
    """One rotation of a ring collective over neighbors ``hop_list``
    grid-hops apart: all transfers run concurrently, the slowest gates
    the rotation."""
    if not hop_list:
        return 0.0
    return max(hop_time_us(h, payload_bytes) for h in hop_list)


def ring_collective_time_us(hop_list: list[int | None],
                            payload_bytes: float,
                            rotations: int | None = None) -> float:
    """A full ring pass (default n-1 rotations, the ppermute count of
    ring attention / a ring all-reduce's reduce-scatter phase)."""
    n = len(hop_list)
    if n == 0:
        return 0.0
    if rotations is None:
        rotations = n - 1
    return rotations * ring_rotation_time_us(hop_list, payload_bytes)


def predicted_step_time_ms(sp_rings: list[list[int | None]],
                           pp_links: list[int | None],
                           *,
                           layers: int = 32,
                           microbatches: int = 8,
                           kv_block_bytes: float = 64 * 1024 * 1024,
                           act_bytes: float = 32 * 1024 * 1024,
                           compute_ms: float = 20.0) -> float:
    """Predicted training-step time of a pp x sp mesh placed at given
    grid distances.

    ``sp_rings``: per pipeline stage, the hop list of its sequence-
    parallel ring (ring attention rotates KV blocks ``sp - 1`` times per
    layer; stages run concurrently, so the slowest stage's ring gates the
    step). ``pp_links``: hop distance of each stage->stage boundary; 1F1B
    crosses each boundary twice per microbatch (forward activation +
    backward gradient). ``compute_ms`` is the placement-invariant compute
    time: a scattered placement cannot look infinitely worse than it is,
    because compute does not move."""
    sp_us = 0.0
    if sp_rings:
        sp_us = layers * max(
            ring_collective_time_us(ring, kv_block_bytes)
            for ring in sp_rings)
    pp_us = 0.0
    if pp_links:
        pp_us = 2 * microbatches * max(
            hop_time_us(h, act_bytes) for h in pp_links)
    return compute_ms + (sp_us + pp_us) / 1000.0
