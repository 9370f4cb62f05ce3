"""The port's retrospective layer, flight recorder, profiler and pod-journey
SLOs are process singletons, as the JAX package's are; ``tests/conftest.py``
resets the JAX package's timeline and SLOs after every test, and this
module's autouse fixture resets the port's. A test file that builds a port stack (whose
``build_stack`` arms the timeline's sampler thread), drives a port
controller, elector or gang planner (which stamp markers), or arms the
port's continuous profiler (``profiling.start``, or ``main``, which arms
it by default) imports it::

    from tests.torch_obs_reset import fresh_port_obs  # noqa: F401

so no sampler thread, marker, decision, journey, SLO window, ``SIGPROF``
timer or lock contention leaks into the next test of the same worker, which may be a
JAX test.
"""

from __future__ import annotations

import pytest

from tpushare_torch import obs, profiling, slo, trace
from tpushare_torch.utils import locks


def reset_port_profiling() -> None:
    """Disarm the port's continuous profiler (its ``ITIMER_PROF`` and
    ``SIGPROF`` handler, or its thread) and drop every profiling counter,
    the contention registry and the race detector's state."""
    profiling.reset()
    locks.reset_contention()
    locks.disarm_race_detector()
    locks.reset_race_detector()


@pytest.fixture(autouse=True)
def fresh_port_obs():
    yield
    reset_port_profiling()
    obs.reset()
    slo.reset()
    trace.reset()
