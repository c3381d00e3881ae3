"""Shared-pool paged KV cache: the refcounted page allocator (the port's copy
of the reference's ``serving/pool.py`` ``BlockAllocator``).

A fixed per-slot cache reserves worst-case memory in every slot, so one
long request's capacity is multiplied by ``max_batch``.  The paged pool
keeps K/V in one shared plane of fixed-size pages (``core/kvcache.py``) and
gives each request a block table; this allocator owns which physical page
belongs to which request, so the scheduler can admit against the global
free-page count instead of the per-slot capacity.

Page 0 is the reserved *sink*: idle engine rows keep all-zero block tables,
so the decode step's unconditional per-row append lands there and never in
a live request's page.  Pages ``1 .. n_blocks-1`` are handed out in FIFO
free-list order (deterministic, so runs replay exactly).

Prefix sharing: pages are refcounted.  ``share`` maps another request's
live pages into a new request's table, ``release`` decrefs and a page goes
back to the free list at refcount zero, and ``cow`` gives a holder a fresh
exclusive page for one logical index before it writes there (a page with
refcount > 1 is never written; the caller copies the rows).  Capacity is
counted in unique pages, so a shared prefix is charged once.  Each page
carries a generation stamp, bumped when it leaves the free list, by which
the prefix index tells a live entry from a recycled one.
"""
from __future__ import annotations

from collections import deque


def pages_for(length: int, page: int) -> int:
    """Pages needed to hold ``length`` committed cache positions."""
    return -(-max(length, 0) // page)


class BlockAllocator:
    """Refcounted FIFO free-list allocator for the shared KV page pool.

    ``n_blocks`` counts every pool page including the sink page 0;
    ``capacity`` (= ``n_blocks - 1``) pages are allocatable.  ``pages(rid)``
    lists a request's physical pages in logical-page order; a page shared
    by several requests appears in each list and its refcount is its
    multiplicity."""

    SINK = 0                              # reserved idle-row append target

    def __init__(self, n_blocks: int, block_s: int):
        if n_blocks < 2 or block_s < 1:
            raise ValueError(f"a pool needs the sink page plus >= 1 page of "
                             f">= 1 position (got {n_blocks} x {block_s})")
        self.n_blocks = n_blocks
        self.block_s = block_s
        self._free: deque[int] = deque(range(1, n_blocks))
        self._pages: dict[int, list[int]] = {}
        self._refs = [0] * n_blocks
        self._gen = [0] * n_blocks
        self.peak_in_use = 0
        self.pages_shared_peak = 0

    @property
    def capacity(self) -> int:
        """Allocatable page count (the pool minus the sink page)."""
        return self.n_blocks - 1

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        """Unique pages owned by requests (a shared page counts once)."""
        return self.capacity - len(self._free)

    def pages(self, rid: int) -> list[int]:
        """Physical pages owned by ``rid`` in logical-page order."""
        return self._pages.get(rid, [])

    def pages_for(self, length: int) -> int:
        """Pages needed for ``length`` positions at this pool's page size."""
        return pages_for(length, self.block_s)

    def refcount(self, page: int) -> int:
        """How many request tables map ``page`` (0 = free)."""
        return self._refs[page]

    def generation(self, page: int) -> int:
        """Allocation stamp of ``page``, bumped each time it leaves the free
        list: (page, generation) names one tenancy."""
        return self._gen[page]

    def shared_count(self) -> int:
        """Pages mapped by more than one request table now."""
        return sum(1 for r in self._refs if r > 1)

    def _take(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        got = [self._free.popleft() for _ in range(n)]
        for p in got:
            self._refs[p] = 1
            self._gen[p] += 1
        self._note_peaks()
        return got

    def _note_peaks(self) -> None:
        self.peak_in_use = max(self.peak_in_use, self.used_count)
        self.pages_shared_peak = max(self.pages_shared_peak,
                                     self.shared_count())

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

    def share(self, rid: int, phys_pages: list[int]) -> list[int]:
        """Map live pages into new request ``rid``'s table as its leading
        logical pages, one more reference each; no free page is taken.
        Sharing the sink page or a free page raises."""
        if rid in self._pages:
            raise ValueError(f"rid {rid} already holds pages")
        for p in phys_pages:
            if p == self.SINK or self._refs[p] <= 0:
                raise ValueError(f"page {p} is the sink or free: not "
                                 "shareable")
        for p in phys_pages:
            self._refs[p] += 1
        self._pages[rid] = list(phys_pages)
        self._note_peaks()
        return list(phys_pages)

    def cow(self, rid: int, logical: int) -> tuple[int, int] | None:
        """Make ``rid``'s logical page ``logical`` exclusive before a write:
        ``(old, new)`` with ``old == new`` when it already is; otherwise a
        fresh page replaces it in ``rid``'s table (the caller copies the
        rows) and the old page loses one reference.  None (nothing changed)
        when the page is shared and no page is free."""
        old = self._pages[rid][logical]
        if self._refs[old] == 1:
            return old, old
        got = self._take(1)
        if got is None:
            return None
        self._pages[rid][logical] = got[0]
        self._refs[old] -= 1
        return old, got[0]

    def release(self, rid: int) -> int:
        """Drop all of ``rid``'s references (retirement); pages reaching
        refcount zero return to the free list.  Returns how many did."""
        freed = 0
        for p in self._pages.pop(rid, []):
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed += 1
        return freed

    def free(self, rid: int) -> int:
        """Alias of ``release`` (the name before refcounts)."""
        return self.release(rid)

    def check_invariants(self) -> None:
        """Raise unless every allocatable page is either free or owned,
        never both, each refcount equals the page's multiplicity across
        the tables, and the sink page never left the pool."""
        mult: dict[int, int] = {}
        for pages in self._pages.values():
            for p in pages:
                mult[p] = mult.get(p, 0) + 1
        free = list(self._free)
        ok = (len(free) == len(set(free)) and not set(free) & set(mult)
              and sorted(set(mult) | set(free)) == list(range(1,
                                                             self.n_blocks))
              and all(self._refs[p] == mult.get(p, 0)
                      for p in range(self.n_blocks))
              and self.SINK not in mult)
        if not ok:
            raise AssertionError(f"page conservation violated: owned "
                                 f"{sorted(mult)} free {sorted(free)} refs "
                                 f"{self._refs}")
