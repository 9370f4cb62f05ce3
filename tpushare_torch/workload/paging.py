"""Paged KV-cache bookkeeping: the host-side page allocator behind the
paged server in :mod:`tpushare_torch.workload.serving`, ported from
``tpushare/workload/paging.py``, and the admission-bucket constants.

The cache is a pool of fixed-size pages (``TPUSHARE_KV_PAGE`` tokens
each, default 64) and a stream holds exactly the pages its true length
needs, not a whole ``max_len`` row. This module owns what is not tensor
work: the free list, refcounts and the per-tenant prefix index. Page
contents live in the serving state's tensors.

Prefix reuse: a page is shareable only when it is full of committed
prompt K/V and lies strictly below the page holding the prompt's last
real token (that page is re-run so admission recomputes the first
token's hidden state). Page identity is a per-tenant chain hash over
token ids: position ``p``'s K/V depend on every token at positions
``<= p``, so page ``j``'s hash folds in page ``j - 1``'s, and equal
chain hashes mean equal (tenant, token prefix), hence bit-equal page
contents under fixed weights. Shared pages are never written: decode
writes land at positions ``>= true_len``, in the stream's private tail
pages. Hashes are seeded by tenant and the index is keyed by tenant, so
two tenants sending the same prompt share nothing.

Every mutation of a :class:`PagePool` happens under its lock: admissions
arrive from the serving loop while a metrics scrape reads the stats.
"""

from __future__ import annotations

import hashlib
import os
import threading
from dataclasses import dataclass
from typing import Sequence

#: Tokens per KV-cache page (``TPUSHARE_KV_PAGE``, default 64): one
#: chunked-prefill piece of 64 tokens fills exactly one page.
PAGE_TOKENS: int = int(os.environ.get("TPUSHARE_KV_PAGE", "64"))

#: Admission buckets: prompts are padded up to one of these lengths.
PROMPT_BUCKETS: tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048)


def pages_for(tokens: int, page_tokens: int = PAGE_TOKENS) -> int:
    """Pages needed to hold ``tokens`` KV rows (ceil division)."""
    if page_tokens <= 0:
        raise ValueError(f"page_tokens must be > 0, got {page_tokens}")
    if tokens <= 0:
        return 0
    return -(-tokens // page_tokens)


def shareable_pages(true_len: int, page_tokens: int = PAGE_TOKENS) -> int:
    """How many leading pages of a ``true_len``-token prompt are
    prefix-shareable: full pages strictly below the page holding the
    last real token."""
    if true_len <= 0:
        return 0
    return (true_len - 1) // page_tokens


def prefix_hashes(tenant: str, tokens: Sequence[int], true_len: int,
                  page_tokens: int = PAGE_TOKENS) -> tuple[str, ...]:
    """Chain hashes for the shareable pages of ``tokens[:true_len]``:
    ``hashes[j]`` identifies (tenant, tokens[: (j + 1) * page_tokens])."""
    n = shareable_pages(true_len, page_tokens)
    chain = hashlib.sha256(
        b"tpushare-kv-prefix\x00" + tenant.encode()).hexdigest()
    out: list[str] = []
    for j in range(n):
        h = hashlib.sha256()
        h.update(chain.encode())
        page = tokens[j * page_tokens:(j + 1) * page_tokens]
        h.update(",".join(str(int(t)) for t in page).encode())
        chain = h.hexdigest()
        out.append(chain)
    return tuple(out)


class PoolExhausted(RuntimeError):
    """The free list cannot cover an allocation: admission control
    should have gated on ``pages_free``."""


@dataclass(frozen=True)
class PageLease:
    """One stream's pages: physical ids in logical order. The ``shared``
    leading pages came from the prefix index (refcounted, not
    prefilled again); the rest are private and writable."""

    owner: str
    pages: tuple[int, ...]
    shared: int


class PagePool:
    """Refcounted free-page pool with a per-tenant prefix index. Physical
    ids are row indices into the serving state's page tensors."""

    def __init__(self, total_pages: int, *,
                 page_tokens: int = PAGE_TOKENS) -> None:
        if total_pages <= 0:
            raise ValueError(
                f"total_pages must be > 0, got {total_pages}")
        if page_tokens <= 0:
            raise ValueError(
                f"page_tokens must be > 0, got {page_tokens}")
        self.total_pages = total_pages
        self.page_tokens = page_tokens
        self._lock = threading.RLock()
        #: LIFO free list: a just-released page is the warmest.
        self._free: list[int] = list(range(total_pages - 1, -1, -1))
        self._refs: dict[int, int] = {}
        #: (tenant, chain hash) -> resident physical page.
        self._index: dict[tuple[str, str], int] = {}
        #: Reverse map for index eviction at refcount zero.
        self._page_key: dict[int, tuple[str, str]] = {}
        self._leases: dict[str, list[int]] = {}
        self._hits = 0
        self._misses = 0

    # -- capacity ----------------------------------------------------------

    def pages_free(self) -> int:
        with self._lock:
            return len(self._free)

    def held(self, owner: str) -> tuple[int, ...]:
        with self._lock:
            return tuple(self._leases.get(owner, ()))

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._refs.get(page, 0)

    # -- lease lifecycle ---------------------------------------------------

    def admit(self, owner: str, tenant: str, tokens: Sequence[int],
              true_len: int) -> PageLease:
        """Allocate pages for a ``true_len``-token prompt, reusing
        resident same-tenant prefix pages where the chain hashes match.
        Raises :class:`PoolExhausted`, allocating nothing, when the
        private tail cannot be covered."""
        if true_len <= 0:
            raise ValueError(f"true_len must be > 0, got {true_len}")
        if len(tokens) < true_len:
            raise ValueError(
                f"tokens ({len(tokens)}) shorter than true_len "
                f"{true_len}")
        n_pages = pages_for(true_len, self.page_tokens)
        hashes = prefix_hashes(tenant, tokens, true_len,
                               self.page_tokens)
        with self._lock:
            if owner in self._leases:
                raise ValueError(
                    f"owner {owner!r} already holds a lease — release "
                    "it first (a silent re-admit would leak its pages)")
            shared: list[int] = []
            for h in hashes:
                pid = self._index.get((tenant, h))
                if pid is None:
                    break  # chain broken: nothing further can match
                shared.append(pid)
            n_new = n_pages - len(shared)
            if n_new > len(self._free):
                raise PoolExhausted(
                    f"need {n_new} pages, {len(self._free)} free "
                    f"(of {self.total_pages}) — admission control "
                    "should gate on pages_free")
            for pid in shared:
                self._refs[pid] += 1
            fresh = [self._free.pop() for _ in range(n_new)]
            for pid in fresh:
                self._refs[pid] = 1
            pages = shared + fresh
            # Publish this stream's own full prefix pages so followers
            # with the same (tenant, token prefix) share them.
            for j in range(len(shared), len(hashes)):
                key = (tenant, hashes[j])
                if key not in self._index:
                    self._index[key] = pages[j]
                    self._page_key[pages[j]] = key
            self._hits += len(shared)
            self._misses += len(hashes) - len(shared)
            self._leases[owner] = list(pages)
            return PageLease(owner, tuple(pages), len(shared))

    def grow(self, owner: str, n_more: int) -> tuple[int, ...]:
        """Extend a lease with ``n_more`` private pages (decode growth
        across a page boundary). Raises :class:`PoolExhausted` without
        allocating when the pool cannot cover it."""
        if n_more <= 0:
            return ()
        with self._lock:
            lease = self._leases.get(owner)
            if lease is None:
                raise ValueError(f"owner {owner!r} holds no lease")
            if n_more > len(self._free):
                raise PoolExhausted(
                    f"need {n_more} pages, {len(self._free)} free "
                    f"(of {self.total_pages})")
            fresh = [self._free.pop() for _ in range(n_more)]
            for pid in fresh:
                self._refs[pid] = 1
            lease.extend(fresh)
            return tuple(fresh)

    def release(self, owner: str) -> int:
        """Drop a lease: decref every page and return fully released ones
        to the free list (evicting their index entries). Returns the
        number of pages freed; an unknown owner is a no-op."""
        freed = 0
        with self._lock:
            for pid in self._leases.pop(owner, []):
                freed += self._drop_ref(pid)
        return freed

    def shrink(self, owner: str, pages: Sequence[int]) -> int:
        """Give back specific pages of a live lease: the rollback of
        :meth:`grow` when the caller could not install the grown pages.
        Pages the lease does not hold are ignored. Returns the number of
        pages freed."""
        freed = 0
        with self._lock:
            lease = self._leases.get(owner)
            if lease is None:
                return 0
            for pid in pages:
                try:
                    lease.remove(pid)
                except ValueError:
                    continue  # not (or no longer) part of the lease
                freed += self._drop_ref(pid)
        return freed

    def _drop_ref(self, pid: int) -> int:
        """Decref one page; free it (and evict its index entry) at zero.
        Called with the lock held. Returns 1 when freed."""
        self._refs[pid] -= 1
        if self._refs[pid] > 0:
            return 0  # still shared by another stream
        del self._refs[pid]
        key = self._page_key.pop(pid, None)
        if key is not None:
            self._index.pop(key, None)
        self._free.append(pid)
        return 1

    # -- telemetry ---------------------------------------------------------

    def stats(self) -> dict:
        """Pool state for debug surfaces and the benches."""
        with self._lock:
            hits, misses = self._hits, self._misses
            looked = hits + misses
            return {
                "pagesTotal": self.total_pages,
                "pagesFree": len(self._free),
                "pageTokens": self.page_tokens,
                "leases": len(self._leases),
                "indexedPages": len(self._index),
                "sharedPages": sum(
                    1 for c in self._refs.values() if c > 1),
                "prefixHits": hits,
                "prefixMisses": misses,
                "prefixHitRate": (round(hits / looked, 4)
                                  if looked else None),
            }
