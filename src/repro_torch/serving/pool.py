"""Shared-pool paged KV cache: the page allocator (the port's trimmed copy of
the reference's ``serving/pool.py`` ``BlockAllocator``).

A fixed per-slot cache reserves worst-case memory in every slot, so one
long request's capacity is multiplied by ``max_batch``.  The paged pool
keeps K/V in one shared plane of fixed-size pages (``core/kvcache.py``) and
gives each request a block table; this allocator owns which physical page
belongs to which request, so the scheduler can admit against the global
free-page count instead of the per-slot capacity.

Page 0 is the reserved *sink*: idle engine rows keep all-zero block tables,
so the decode step's unconditional per-row append lands there and never in
a live request's page.  Pages ``1 .. n_blocks-1`` are handed out in FIFO
free-list order (deterministic, so runs replay exactly).  Each page has at
most one owner: prefix sharing (refcounts, copy-on-write, generations) is
not ported.
"""
from __future__ import annotations

from collections import deque


def pages_for(length: int, page: int) -> int:
    """Pages needed to hold ``length`` committed cache positions."""
    return -(-max(length, 0) // page)


class BlockAllocator:
    """FIFO free-list allocator for the shared KV page pool.

    ``n_blocks`` counts every pool page including the sink page 0;
    ``capacity`` (= ``n_blocks - 1``) pages are allocatable.  ``pages(rid)``
    lists a request's physical pages in logical-page order."""

    SINK = 0                              # reserved idle-row append target

    def __init__(self, n_blocks: int, block_s: int):
        if n_blocks < 2 or block_s < 1:
            raise ValueError(f"a pool needs the sink page plus >= 1 page of "
                             f">= 1 position (got {n_blocks} x {block_s})")
        self.n_blocks = n_blocks
        self.block_s = block_s
        self._free: deque[int] = deque(range(1, n_blocks))
        self._pages: dict[int, list[int]] = {}
        self.peak_in_use = 0

    @property
    def capacity(self) -> int:
        """Allocatable page count (the pool minus the sink page)."""
        return self.n_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.capacity - len(self._free)

    def pages(self, rid: int) -> list[int]:
        """Physical pages owned by ``rid`` in logical-page order."""
        return self._pages.get(rid, [])

    def pages_for(self, length: int) -> int:
        """Pages needed for ``length`` positions at this pool's page size."""
        return pages_for(length, self.block_s)

    def _take(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        got = [self._free.popleft() for _ in range(n)]
        self.peak_in_use = max(self.peak_in_use, self.used_count)
        return got

    def alloc(self, rid: int, n: int) -> list[int] | None:
        """Grant ``n`` fresh pages to new request ``rid``; None (nothing
        changed) when fewer than ``n`` are free."""
        if rid in self._pages:
            raise ValueError(f"rid {rid} already holds pages")
        got = self._take(n)
        if got is not None:
            self._pages[rid] = got
        return None if got is None else list(got)

    def extend(self, rid: int, n: int) -> list[int] | None:
        """Grant ``n`` more pages to ``rid`` (decode growth); returns only
        the new pages, or None (nothing changed) when too few are free."""
        if rid not in self._pages:
            raise ValueError(f"rid {rid} holds no pages")
        got = self._take(n)
        if got is not None:
            self._pages[rid].extend(got)
        return got

    def free(self, rid: int) -> int:
        """Return all of ``rid``'s pages to the free list (retirement);
        returns how many."""
        got = self._pages.pop(rid, [])
        self._free.extend(got)
        return len(got)

    def check_invariants(self) -> None:
        """Raise unless every allocatable page is either free or owned by
        exactly one request, and the sink page never left the pool."""
        owned = [p for pages in self._pages.values() for p in pages]
        free = list(self._free)
        if (len(owned) + len(free) != self.capacity
                or sorted(owned + free) != list(range(1, self.n_blocks))):
            raise AssertionError(f"page conservation violated: owned "
                                 f"{sorted(owned)} free {sorted(free)}")
