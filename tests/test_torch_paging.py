"""The port's page pool against ``tpushare.workload.paging``: the same
seeded sequences of admit/grow/shrink/release must give the same pages,
shares, refcounts, stats and refusals."""

import numpy as np
import pytest

from tpushare.workload import paging as JP
from tpushare_torch.workload import paging as P

TOTAL, PAGE = 12, 4
OWNERS = [f"slot{i}" for i in range(5)]
TENANTS = ("a", "b")


def _call(fn, *args):
    """(result, None) or (None, (exception class name, first words))."""
    try:
        return fn(*args), None
    except (ValueError, RuntimeError) as exc:
        return None, (type(exc).__name__, str(exc).split()[:3])


def _same_state(jpool, pool):
    assert pool.stats() == jpool.stats()
    assert pool.pages_free() == jpool.pages_free()
    for owner in OWNERS:
        assert pool.held(owner) == jpool.held(owner)
    for page in range(TOTAL):
        assert pool.refcount(page) == jpool.refcount(page)


def _drive(seed, jpool, pool):
    """60 seeded operations on both pools, held equal after each one.
    Returns (refusals for lack of pages, most pages shared at once)."""
    rng = np.random.default_rng(seed)
    # A few base prompts, so same-tenant prefixes repeat and share pages.
    bases = [rng.integers(0, 50, 16).tolist() for _ in range(3)]
    refused = shared = 0
    for _ in range(60):
        op = rng.choice(["admit", "admit", "grow", "shrink", "release"])
        owner = OWNERS[rng.integers(len(OWNERS))]
        err = None
        if op == "admit":
            tenant = TENANTS[rng.integers(2)]
            tokens = bases[rng.integers(3)]
            args = (owner, tenant, tokens, int(rng.integers(0, 17)))
            want, jerr = _call(jpool.admit, *args)
            got, err = _call(pool.admit, *args)
            assert err == jerr
            if want is not None:
                assert (got.owner, got.pages, got.shared) == (
                    want.owner, want.pages, want.shared)
        elif op == "grow":
            n = int(rng.integers(0, 5))
            want, jerr = _call(jpool.grow, owner, n)
            got, err = _call(pool.grow, owner, n)
            assert (got, err) == (want, jerr)
        elif op == "shrink":
            give = [p for p in jpool.held(owner) if rng.random() < 0.5]
            give.append(int(rng.integers(TOTAL)))  # maybe not held
            assert pool.shrink(owner, give) == jpool.shrink(owner, give)
        else:
            assert pool.release(owner) == jpool.release(owner)
        _same_state(jpool, pool)
        refused += bool(err and err[0] == "PoolExhausted")
        shared = max(shared, pool.stats()["sharedPages"])
    return refused, shared


@pytest.mark.parametrize("seed", range(8))
def test_random_lease_sequences_match_jax(seed):
    _drive(seed, JP.PagePool(TOTAL, page_tokens=PAGE),
           P.PagePool(TOTAL, page_tokens=PAGE))


def test_sequences_reach_exhaustion_and_sharing():
    """The seeded runs above cover the interesting paths: some request is
    refused for lack of pages, and some page is shared."""
    runs = [_drive(seed, JP.PagePool(TOTAL, page_tokens=PAGE),
                   P.PagePool(TOTAL, page_tokens=PAGE)) for seed in range(8)]
    assert sum(r for r, _ in runs) > 0
    assert max(s for _, s in runs) > 0


@pytest.mark.parametrize("total,page", [(0, 4), (-1, 4), (4, 0), (4, -2)])
def test_pool_refusals_match_jax(total, page):
    with pytest.raises(ValueError) as jerr:
        JP.PagePool(total, page_tokens=page)
    with pytest.raises(ValueError) as err:
        P.PagePool(total, page_tokens=page)
    assert str(err.value).split()[:3] == str(jerr.value).split()[:3]


@pytest.mark.parametrize("true_len", [0, 1, 4, 5, 8, 9, 63, 64, 65, 200])
@pytest.mark.parametrize("page", [1, 4, 64])
def test_page_arithmetic_matches_jax(true_len, page):
    tokens = np.random.default_rng(true_len).integers(0, 32000,
                                                      max(true_len, 1))
    tokens = tokens.tolist()
    assert P.pages_for(true_len, page) == JP.pages_for(true_len, page)
    assert (P.shareable_pages(true_len, page)
            == JP.shareable_pages(true_len, page))
    for tenant in ("a", "tenant-b"):
        assert (P.prefix_hashes(tenant, tokens, true_len, page)
                == JP.prefix_hashes(tenant, tokens, true_len, page))


def test_constants_match_jax():
    assert P.PAGE_TOKENS == JP.PAGE_TOKENS
    assert P.PROMPT_BUCKETS == JP.PROMPT_BUCKETS
    with pytest.raises(ValueError, match="page_tokens"):
        P.pages_for(3, 0)
