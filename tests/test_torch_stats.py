"""The port's nearest-rank quantiles (``tpushare_torch/utils/stats.py``)
against the JAX package's ``tpushare/utils/stats.py``, on seeded samples:
the same value for every quantile, always an observed sample, the same
refusals of an empty sequence and of a ``q`` outside (0, 1]."""

from __future__ import annotations

import math

import numpy as np
import pytest

from tpushare.utils import stats as jstats
from tpushare_torch.utils import stats as tstats

QS = (1e-9, 0.01, 0.1, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


@pytest.mark.parametrize("seed", range(8))
def test_quantiles_are_the_reference_s(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    vals = [float(v) for v in rng.exponential(3.0, n)]
    if seed % 2:
        vals += vals[: n // 3]          # ties
    for q in QS:
        got = tstats.quantile(vals, q)
        assert got == jstats.quantile(vals, q)
        assert got in vals
        ranked = sorted(vals)
        assert tstats.quantile_sorted(ranked, q) == got
        # nearest rank: at least ceil(q n) samples lie at or under it
        assert sum(v <= got for v in vals) >= math.ceil(q * len(vals))


def test_the_off_by_one_the_module_exists_for():
    vals = list(range(1, 151))
    assert tstats.quantile(vals, 0.99) == 149 == jstats.quantile(vals, 0.99)
    assert tstats.quantile([7.0], 0.5) == 7.0


@pytest.mark.parametrize("vals,q", [([], 0.5), ([1.0], 0.0), ([1.0], 1.5),
                                    ([1.0], -0.1)])
def test_refusals_are_the_reference_s(vals, q):
    with pytest.raises(ValueError) as want:
        jstats.quantile(vals, q)
    with pytest.raises(ValueError) as got:
        tstats.quantile(vals, q)
    assert str(got.value) == str(want.value)
