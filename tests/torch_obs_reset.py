"""The port's retrospective layer and flight recorder are process
singletons, as the JAX package's are; ``tests/conftest.py`` resets the
JAX package's after every test, and this module's autouse fixture resets
the port's. A test file that builds a port stack (whose ``build_stack``
arms the timeline's sampler thread) or drives a port controller, elector
or gang planner (which stamp markers) imports it::

    from tests.torch_obs_reset import fresh_port_obs  # noqa: F401

so no sampler thread, marker or decision leaks into the next test of
the same worker.
"""

from __future__ import annotations

import pytest

from tpushare_torch import obs, trace


@pytest.fixture(autouse=True)
def fresh_port_obs():
    yield
    obs.reset()
    trace.reset()
