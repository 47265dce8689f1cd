"""Paged KV-cache allocation: fixed-size token blocks + per-slot page tables.

The port's copy of ``repro/core/kv_pages.py``.  The KV cache is a pool of
fixed-size pages handed out by a free-list allocator:

  * a slot's logical position ``p`` lives in logical page ``p // page_size``
    at row ``p % page_size``;
  * a per-slot page table maps logical pages to physical pool pages
    (-1 = not allocated);
  * prefill allocates ``pages_for(prompt_len)`` pages, decode grows a slot
    by at most one page per step, and EOS/eviction frees the slot's pages
    in the same engine step.

The device pool (``models.attention.init_paged_gqa_cache``) reserves one
extra *scratch* page at index ``num_pages``: writes of inactive slots land
there and are never read back.
"""
from __future__ import annotations

import heapq
from typing import List, Sequence

import torch


def pages_for(n_tokens: int, page_size: int) -> int:
    """Number of pages needed to hold ``n_tokens`` token rows."""
    if n_tokens <= 0:
        return 0
    return -(-n_tokens // page_size)


class KVPagesExhausted(RuntimeError):
    """The pool has no free page left for a required allocation."""


class PageAllocator:
    """Free-list allocator over a fixed pool of ``num_pages`` pages.

    Lowest-id-first allocation (a heap) keeps the in-use set compacted, so
    ``peak_pages`` is the pool size the workload actually needed.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError("num_pages and page_size must be positive")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages))
        heapq.heapify(self._free)
        self._in_use: set = set()
        self.peak_pages = 0

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_in_use(self) -> int:
        return len(self._in_use)

    def alloc(self, n: int = 1) -> List[int]:
        """Take ``n`` pages off the free list; raises ``KVPagesExhausted``
        (allocating nothing) when fewer than ``n`` pages are free."""
        if n < 0:
            raise ValueError("cannot allocate a negative page count")
        if n > len(self._free):
            raise KVPagesExhausted(
                f"need {n} pages, only {len(self._free)} of "
                f"{self.num_pages} free")
        out = [heapq.heappop(self._free) for _ in range(n)]
        self._in_use.update(out)
        self.peak_pages = max(self.peak_pages, len(self._in_use))
        return out

    def free(self, pages: Sequence[int]) -> None:
        """Return pages to the free list; double-free / foreign ids raise."""
        for p in pages:
            if p not in self._in_use:
                raise ValueError(f"page {p} is not allocated (double free?)")
        for p in pages:
            self._in_use.discard(p)
            heapq.heappush(self._free, p)

    def check_balanced(self) -> None:
        """Assert every page is back on the free list (tests: no leaks)."""
        if self._in_use or len(self._free) != self.num_pages:
            raise AssertionError(
                f"free-list unbalanced: {len(self._in_use)} pages still "
                f"in use, {len(self._free)}/{self.num_pages} free")


# ---------------------------------------------------------------------------
# Device-side helpers: the plain (gathered) view of a paged pool
# ---------------------------------------------------------------------------


def gather_pages(pool, pages):
    """Materialize each slot's logical KV span from the pool.

    pool:  (P(+scratch), page_size, ...); pages: (B, max_pages) int32,
    -1 = unallocated.  Returns (B, max_pages * page_size, ...); rows of
    unallocated pages hold page 0's contents and MUST be masked via
    ``pages_kpos``.
    """
    safe = pages.clamp(min=0).long()
    g = pool[safe]                                  # (B, maxp, ps, ...)
    b, maxp, ps = g.shape[:3]
    return g.reshape((b, maxp * ps) + tuple(g.shape[3:]))


def pages_kpos(pages, page_size: int):
    """Per-slot kpos track of the gathered view: the logical position where
    the page is allocated, -1 elsewhere.  (B, maxp) -> (B, maxp * ps)."""
    b, maxp = pages.shape
    pos = torch.arange(maxp * page_size, dtype=torch.int32,
                       device=pages.device)
    alloc = (pages >= 0).repeat_interleave(page_size, dim=1)
    return torch.where(alloc, pos[None, :], torch.full_like(pos, -1)[None, :])


def scatter_rows(pool, pages, positions, rows):
    """Write token rows into the pool at their logical positions, in place.

    pool: (P(+scratch), page_size, ...); pages: (B, max_pages) int32;
    positions: (B, C) int32 logical positions, -1 = pad row; rows:
    (B, C, ...).  Rows at position -1 or in an unallocated page land in the
    scratch page (index P), which is never read back.  The reference
    returns a new pool (``.at[].set``); here the pool is updated with
    ``index_put_`` and returned.
    """
    ps = pool.shape[1]
    scratch = pool.shape[0] - 1
    safe = positions.clamp(min=0).long()
    page = torch.gather(pages.long(), 1, safe // ps)
    page = torch.where((positions < 0) | (page < 0),
                       torch.full_like(page, scratch), page)
    pool.index_put_((page, safe % ps), rows.to(pool.dtype))
    return pool


def pages_to_strips(pools, pages, page_size: int):
    """Paged pool(s) -> dense per-slot strips + kpos (the strip view)."""
    strips = tuple(gather_pages(p, pages) for p in pools)
    return strips + (pages_kpos(pages, page_size),)
