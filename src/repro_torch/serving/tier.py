"""Host-side KV page store: the spill and restore tier under the device pool
(the port's copy of the reference's ``serving/tier.py``).

The pool (``serving/pool.py``) rations device memory; this store lets a
request's K/V leave the card and come back without recomputing it:

  * a preemption **spills** the request's live pool pages (int8 payloads
    and f32 scale planes included, as exact bytes) before the pool takes
    them back, and the resume is a block-table rebuild plus one
    host->device scatter, with no prefill chunk;
  * a retired request's pages can stay keyed by its session id, so the
    next turn of a conversation restores its history instead of
    re-prefilling it (the engine's session KV);
  * when the engine has a store, the prefix index's host K/V blobs live
    under the same LRU, so their host memory is bounded.

Nothing is trusted: every stored page carries a CRC32 and a generation
stamp, both checked before a byte is handed back; a corrupt or stale entry
is dropped and reported, and the engine re-prefills.  ``serving/faults.py``
injects the failure modes from a seed.

The store itself is numpy only.  An entry is a dict of numpy planes with
the page axis at position 1 (pool spills are ``[L, P, Kh, page, hsz]``,
scale planes without hsz).  numpy has no bfloat16, so bf16 planes cross
over as int16 views of the same bytes (``host_planes``) and are viewed
back on restore (``device_planes``); the CRCs are over those bytes.
Capacity is counted in pages across entries; eviction is LRU over whole
entries.
"""
from __future__ import annotations

import dataclasses
import zlib
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.serving.faults import FaultPlan

__all__ = ["HostPageStore", "HostEntry", "host_planes", "device_planes"]

# dtypes numpy lacks, carried as integer views of the same width
_VIEWS = {torch.bfloat16: torch.int16, torch.float16: torch.int16}


def host_planes(planes: dict) -> dict[str, np.ndarray]:
    """Host tensors -> numpy arrays of the same bytes (bf16 as int16)."""
    return {k: v.view(_VIEWS.get(v.dtype, v.dtype)).numpy()
            for k, v in planes.items()}


def device_planes(planes: dict, dtypes: dict, device=None) -> dict:
    """Inverse of ``host_planes``: numpy arrays -> tensors of ``dtypes``
    (by plane name) on ``device``, the bytes unchanged."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).view(dtypes[k])
            .to(device or "cpu") for k, v in planes.items()}


@dataclasses.dataclass
class HostEntry:
    """One stored KV snapshot: ``planes`` (name -> host array, page axis 1),
    ``tokens`` (the token prefix the pages hold, the restore's
    applicability check), the generation stamp ``gen`` that every
    ``page_gens[p]`` must equal (else the page was recycled under it) and
    ``sums[p]``, the CRC32 of page p's bytes across all planes."""

    key: str
    tokens: tuple
    planes: dict[str, np.ndarray]
    n_pages: int
    gen: int
    page_gens: list[int]
    sums: list[int]


def _page_crc(planes: dict[str, np.ndarray], p: int) -> int:
    # one CRC chained over every plane's page-p slice, planes sorted by name
    acc = 0
    for name in sorted(planes):
        acc = zlib.crc32(np.ascontiguousarray(planes[name][:, p]), acc)
    return acc


class HostPageStore:
    """Capacity-bounded host KV store with checksums, generations and LRU.

    ``capacity_pages`` bounds the pages of all live entries; ``put`` evicts
    least-recently-used entries, whole, to make room.  ``faults`` (a
    ``FaultPlan``) injects the tier's failure modes; without one the store
    is exact and loses nothing.

    Counters (monotonic): ``saves``, ``restores``, ``restores_failed``,
    ``checksum_mismatches``, ``stale_generations``, ``evictions`` /
    ``evicted_pages`` and ``store_full`` (refused saves, real or
    injected)."""

    def __init__(self, capacity_pages: int,
                 faults: FaultPlan | None = None):
        if capacity_pages <= 0:
            raise ValueError("host store needs >= 1 page")
        self.capacity = capacity_pages
        self._faults = (faults or FaultPlan()).injector()
        self._entries: "OrderedDict[str, HostEntry]" = OrderedDict()
        self._gen = 0
        self.pages_used = 0
        self.saves = 0
        self.restores = 0
        self.restores_failed = 0
        self.checksum_mismatches = 0
        self.stale_generations = 0
        self.evictions = 0
        self.evicted_pages = 0
        self.store_full = 0

    def __len__(self) -> int:
        return len(self._entries)

    def has(self, key: str) -> bool:
        """Whether ``key`` has a live entry (no LRU touch, no draw, no
        verification)."""
        return key in self._entries

    def tokens(self, key: str) -> tuple | None:
        """The token prefix stored under ``key`` (None when absent); no LRU
        touch, no draw."""
        e = self._entries.get(key)
        return None if e is None else e.tokens

    # ----------------------------------------------------------- mutation
    def put(self, key: str, planes: dict, tokens=()) -> bool:
        """Save one snapshot under ``key``, replacing any previous one.

        ``planes`` are non-empty arrays sharing their page axis (axis 1);
        they are copied, stamped with a fresh generation and checksummed
        per page.  Returns False when the save is refused (an injected
        ``store_full``, or an entry larger than the whole store), else
        evicts LRU entries until it fits.  As in the reference, the key's
        old entry is dropped before an oversize entry is refused."""
        if not planes:
            raise ValueError("empty snapshot")
        n_pages = {int(v.shape[1]) for v in planes.values()}
        if len(n_pages) != 1:
            raise ValueError(f"ragged page axes: {n_pages}")
        n = n_pages.pop()
        if n <= 0:
            raise ValueError("zero-page snapshot")
        if self._faults.draw("store_full"):
            self.store_full += 1
            return False
        self.drop(key)
        if n > self.capacity:
            self.store_full += 1
            return False
        while self.pages_used + n > self.capacity:
            old_key, old = next(iter(self._entries.items()))
            self._entries.pop(old_key)
            self.pages_used -= old.n_pages
            self.evictions += 1
            self.evicted_pages += old.n_pages
        host = {name: np.array(v, copy=True) for name, v in planes.items()}
        gen = self._gen
        self._gen += 1
        entry = HostEntry(key=key, tokens=tuple(int(t) for t in tokens),
                          planes=host, n_pages=n, gen=gen,
                          page_gens=[gen] * n,
                          sums=[_page_crc(host, p) for p in range(n)])
        if self._faults.draw("corrupt"):
            self._corrupt(entry)
        self._entries[key] = entry
        self.pages_used += n
        self.saves += 1
        return True

    def _corrupt(self, entry: HostEntry) -> None:
        # damage after the checksums, so verification catches it: a flipped
        # byte in one page, or a bumped page generation
        p = self._faults.pick(entry.n_pages)
        if self._faults.pick(2) == 0:
            arr = entry.planes[sorted(entry.planes)[0]]
            # the page slice is strided: flip a byte of a contiguous copy
            # and write the copy back
            page = np.ascontiguousarray(arr[:, p])
            flat = page.view(np.uint8).reshape(-1)
            flat[self._faults.pick(flat.size)] ^= 0xFF
            arr[:, p] = page
        else:
            entry.page_gens[p] += 1

    def drop(self, key: str) -> bool:
        """Remove ``key``'s entry (nothing when absent); True when
        dropped."""
        e = self._entries.pop(key, None)
        if e is None:
            return False
        self.pages_used -= e.n_pages
        return True

    # ------------------------------------------------------------ restore
    def _verify(self, entry: HostEntry) -> str | None:
        for p in range(entry.n_pages):
            if entry.page_gens[p] != entry.gen:
                self.stale_generations += 1
                return "generation"
            if _page_crc(entry.planes, p) != entry.sums[p]:
                self.checksum_mismatches += 1
                return "checksum"
        return None

    def restore(self, key: str) -> tuple[dict | None, int, str | None]:
        """``key``'s planes for a host->device restore, with fault draws:
        ``(planes, delay_steps, why)``.  On success ``why`` is None and
        ``delay_steps`` how many engine steps an injected ``delay``
        withholds the planes (0 normally).  On failure ``planes`` is None
        and ``why`` is ``"missing"``, ``"injected"`` (restore_fail) or
        ``"checksum"``/``"generation"`` (verification; the entry is
        dropped, so bad bytes are never served later)."""
        entry = self._entries.get(key)
        if entry is None:
            return None, 0, "missing"
        if self._faults.draw("restore_fail"):
            self.restores_failed += 1
            return None, 0, "injected"
        why = self._verify(entry)
        if why is not None:
            self.restores_failed += 1
            self.drop(key)
            return None, 0, why
        delay = self._faults.plan.delay_steps \
            if self._faults.draw("delay") else 0
        self._entries.move_to_end(key)
        self.restores += 1
        return entry.planes, delay, None

    def fetch(self, key: str) -> dict | None:
        """Verified planes without injected faults: the prefix-sharing
        admission asks up to three times per decision and every answer
        must agree, so only verification failures apply (the entry is
        dropped and later calls miss).  Touches the LRU; not a restore."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        if self._verify(entry) is not None:
            self.drop(key)
            return None
        self._entries.move_to_end(key)
        return entry.planes

    # -------------------------------------------------------------- stats
    def stats(self) -> dict:
        """The counters and the occupancy, for the metrics summary."""
        return {
            "host_pages_capacity": self.capacity,
            "host_pages_used": self.pages_used,
            "host_entries": len(self._entries),
            "host_saves": self.saves,
            "host_restores": self.restores,
            "restores_failed": self.restores_failed,
            "checksum_mismatches": self.checksum_mismatches,
            "stale_generations": self.stale_generations,
            "store_evictions": self.evictions,
            "store_full": self.store_full,
        }

    def check_invariants(self) -> None:
        """Raise unless the pages used equal the sum over entries, stay
        within capacity, and each entry's page count is its planes'."""
        total = sum(e.n_pages for e in self._entries.values())
        if total != self.pages_used or total > self.capacity:
            raise AssertionError(f"host pages {total} used {self.pages_used} "
                                 f"capacity {self.capacity}")
        for e in self._entries.values():
            if e.n_pages != next(iter(e.planes.values())).shape[1]:
                raise AssertionError(f"entry {e.key}: {e.n_pages} pages")
