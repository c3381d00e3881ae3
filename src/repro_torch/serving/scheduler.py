"""Admission scheduling for the continuous-batching engine (the port's copy
of the reference's ``serving/scheduler.py``, trimmed to the engine's main
path: FCFS/SJF admission into a fixed slot table, gated by the per-slot
cache capacity or, with a paged pool, by the pool's free pages, and the
prefix index of prefix sharing).  Tenancy and preemption are not ported
yet.

Request lifecycle: QUEUED --admit--> PREFILL --last chunk--> DECODE
--retire--> DONE.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

QUEUED = "queued"
PREFILL = "prefill"
DECODE = "decode"
DONE = "done"

POLICIES = ("fcfs", "sjf")


@dataclasses.dataclass
class Request:
    """One generation request; the engine appends generated tokens to
    ``out_tokens`` and sets ``done``/``finish_reason`` (``"eos"`` |
    ``"max_tokens"`` | ``"capacity"`` | ``"rejected"``) on retirement."""
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None
    sampling: Any = None      # SamplingParams; None: the engine's default
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    state: str = QUEUED
    finish_reason: str | None = None
    admit_seq: int = -1                       # admission order stamp
    # --- chunked-prefill bookkeeping (engine-internal) ---
    prefill_tokens: list[int] | None = None   # the tokens to prefill
    prefill_pos: int = 0                      # next chunk offset
    buffers: Any = None                       # K/V carry buffers (device)
    # --- prefix-sharing bookkeeping (engine-internal, set at admission) ---
    shared_len: int = 0                       # matched prefix tokens
    shared_pages: int = 0                     # leading logical pages shared
    shared_kv: Any = None                     # host fp K/V of [0, shared_len)

    def resume_tokens(self) -> list[int]:
        """Tokens to prefill: the prompt plus anything already generated."""
        return list(self.prompt) + list(self.out_tokens)


def _kv_to_pages(arr, block_s: int):
    """Carry-layout K/V ``[L, t, Kh, hsz]`` -> page stack ``[L, P, block_s,
    Kh, hsz]`` (zero-padded tail): the page-granular form in which the
    prefix index keeps its host blobs, as the reference's host store
    does."""
    l, t = arr.shape[:2]
    p = -(-t // block_s)
    if p * block_s != t:
        pad = torch.zeros((l, p * block_s - t, *arr.shape[2:]),
                          dtype=arr.dtype, device=arr.device)
        arr = torch.cat([arr, pad], dim=1)
    return arr.reshape(l, p, block_s, *arr.shape[2:])


def _pages_to_kv(pages, t: int):
    """Inverse of ``_kv_to_pages``: drop the padding back to ``t`` rows."""
    l, p, bs = pages.shape[:3]
    return pages.reshape(l, p * bs, *pages.shape[3:])[:, :t]


class PrefixIndex:
    """Hash trie over token ids, at page granularity, mapping prompts onto
    already-committed KV prefixes (the reference's ``PrefixIndex`` without
    its host store).

    Registration happens when a request finishes its chunked prefill: the
    engine hands over the token sequence, the request's physical page list
    (snapshotted with the pool's generation stamps) and a host fp copy of
    its carry-buffer K/V.  An arriving prompt walks the trie, one node per
    full page of ``block_s`` token ids, to its longest registered prefix:

      * the matched length ``m`` gates compute: the engine restores the host
        K/V of ``[0, m)`` into the new request's buffers and chunk-prefills
        only the suffix;
      * the entry's still-live leading pages (``valid_leading_pages``:
        refcount and generation per page) gate memory: the scheduler
        ``share()``s them instead of charging fresh ones.

    Entries never go wrong, only stale: the host K/V is a function of the
    token prefix alone.  ``max_entries`` bounds the entries, evicted FIFO.
    """

    def __init__(self, block_s: int, pool, max_entries: int = 64):
        if block_s < 1:
            raise ValueError(f"block_s must be >= 1 (got {block_s})")
        self.block_s = block_s
        self.pool = pool
        self.max_entries = max_entries
        self._root: dict = {"children": {}, "entries": []}
        self._order: list[dict] = []          # FIFO eviction order
        self._seq = 0
        self.lookups = 0
        self.hits = 0

    def __len__(self) -> int:
        return len(self._order)

    def register(self, tokens, pages, kv=None) -> None:
        """Insert one committed prefix: ``tokens`` (the whole prefilled
        sequence), its physical ``pages`` and ``kv``, host fp ``(k, v)`` of
        shape ``[L, len(tokens), Kh, hsz]``, kept as page stacks."""
        toks = tuple(int(t) for t in tokens)
        if kv is not None:
            kv = tuple(_kv_to_pages(x, self.block_s) for x in kv)
        entry = {"tokens": toks, "pages": list(pages),
                 "gens": [self.pool.generation(p) for p in pages],
                 "kv": kv, "seq": self._seq, "nodes": []}
        self._seq += 1
        node = self._root
        node["entries"].append(entry)
        entry["nodes"].append(node)
        bs = self.block_s
        for d in range(len(toks) // bs):
            key = toks[d * bs:(d + 1) * bs]
            node = node["children"].setdefault(
                key, {"children": {}, "entries": []})
            node["entries"].append(entry)
            entry["nodes"].append(node)
        self._order.append(entry)
        while len(self._order) > self.max_entries:
            old = self._order.pop(0)
            for n in old["nodes"]:
                n["entries"].remove(old)

    def match(self, tokens, limit: int) -> tuple[int, dict | None]:
        """Longest registered prefix of ``tokens``: ``(m, entry)`` with
        ``m <= limit`` matched ids ((0, None) on a miss).  Walks the page
        trie to the deepest node, then extends id by id into the partial
        page against that node's entries; equal lengths prefer the entry
        with the most live leading pages, then the earliest registered."""
        self.lookups += 1
        toks = tuple(int(t) for t in tokens)
        bs = self.block_s
        path = [self._root]
        node = self._root
        for d in range(len(toks) // bs):
            node = node["children"].get(toks[d * bs:(d + 1) * bs])
            if node is None:
                break
            path.append(node)
        best_m, best, best_key = 0, None, None
        for depth in range(len(path) - 1, -1, -1):
            for e in sorted(path[depth]["entries"], key=lambda e: e["seq"]):
                m = depth * bs
                et = e["tokens"]
                hi = min(len(toks), len(et), limit)
                while m < hi and toks[m] == et[m]:
                    m += 1
                m = min(m, limit)
                key = (m, self.valid_leading_pages(e), -e["seq"])
                if best_key is None or key > best_key:
                    best_m, best, best_key = m, e, key
            if best_m > 0:
                break       # shallower nodes can only match shorter prefixes
        if best_m <= 0:
            return 0, None
        self.hits += 1
        return best_m, best

    def resolve_kv(self, entry: dict):
        """The entry's host fp ``(k, v)`` ``[L, len(tokens), Kh, hsz]``, or
        None when it was registered without."""
        if entry["kv"] is None:
            return None
        t = len(entry["tokens"])
        return tuple(_pages_to_kv(x, t) for x in entry["kv"])

    def valid_leading_pages(self, entry: dict) -> int:
        """How many of ``entry``'s leading pages are still the tenancy they
        were at registration (refcount > 0, same generation): the span that
        can be shared."""
        n = 0
        for p, g in zip(entry["pages"], entry["gens"]):
            if self.pool.refcount(p) <= 0 or self.pool.generation(p) != g:
                break
            n += 1
        return n

    def hit_rate(self) -> float:
        """Fraction of lookups that matched a non-empty prefix."""
        return self.hits / max(self.lookups, 1)


class Scheduler:
    """FCFS/SJF admission queue + slot table with cache-pressure gating.

    Fixed layout: ``cap`` is the per-slot KV capacity; a slot's committed
    length never reaches it (the engine retires the request one token
    earlier).  Paged (``pool``, a ``serving/pool.BlockAllocator``): the
    capacity oracle is the pool — ``fits`` (could the request ever fit:
    ``max_pages`` and the pool's capacity), ``can_admit_now`` (its pages are
    free now; otherwise it waits in the queue) and ``grow_for_next_token``
    (the next token's page, reserved atomically).  ``pool_waits`` counts
    the requests the pool made wait at least once.  With a
    ``prefix_index`` the paged gates charge only the pages a request does
    not share (``_prefix_plan``), and admission maps the shared ones
    (``_reserve``)."""

    def __init__(self, max_batch: int, cap: int, policy: str = "fcfs",
                 pool=None, max_pages: int = 0, prefix_index=None):
        if policy not in POLICIES:
            raise ValueError(f"unknown sched policy {policy!r}; "
                             f"choose from {POLICIES}")
        self.policy = policy
        self.cap = cap
        self.max_batch = max_batch
        self.pool = pool
        self.max_pages = max_pages or (pool.capacity if pool else 0)
        self.prefix_index = prefix_index
        self._admit_seq = 0
        self.queue: list[Request] = []
        self.slot_rids: list[int | None] = [None] * max_batch
        self.slot_len: list[int] = [0] * max_batch
        self.rejected: list[Request] = []
        self._waited: set[int] = set()

    @property
    def pool_waits(self) -> int:
        return len(self._waited)

    def submit(self, req: Request) -> None:
        req.state = QUEUED
        self.queue.append(req)

    def _pick(self) -> Request:
        if self.policy == "sjf":
            # min() is stable: earliest-queued wins among equal lengths
            return min(self.queue, key=lambda r: len(r.resume_tokens()))
        return self.queue[0]

    def free_slot(self) -> int | None:
        """Lowest free slot index, or None when the batch is full."""
        try:
            return self.slot_rids.index(None)
        except ValueError:
            return None

    def _prefix_plan(self, req: Request) -> tuple[int, dict | None, int, int]:
        """One prefix-share decision for every gate: ``(m, entry,
        shared_full, total)``: ``m`` matched tokens, ``shared_full`` the
        full pages the pool can ``share()`` (live leading pages of the
        entry), ``total`` the table width the request needs (prompt plus
        one token).  No pool: ``(0, None, 0, 0)``; no index or no match:
        ``(0, None, 0, total)``."""
        need = len(req.resume_tokens())
        if self.pool is None:
            return 0, None, 0, 0
        total = self.pool.pages_for(need + 1)
        if self.prefix_index is None or need < 2:
            return 0, None, 0, total
        m, entry = self.prefix_index.match(req.resume_tokens(),
                                           limit=need - 1)
        if entry is None:
            return 0, None, 0, total
        valid = self.prefix_index.valid_leading_pages(entry)
        return m, entry, min(m // self.pool.block_s, valid), total

    def fits(self, req: Request) -> bool:
        """Could ``req``'s prefill plus one generated token *ever* fit: the
        per-slot ``cap`` (fixed), or ``max_pages`` and the pool (paged),
        charging the pool only the pages not shared?  False means
        reject."""
        if self.pool is None:
            return len(req.resume_tokens()) + 1 <= self.cap
        _, _, shared_full, total = self._prefix_plan(req)
        return (total <= self.max_pages
                and total - shared_full <= self.pool.capacity)

    def can_admit_now(self, req: Request) -> bool:
        """Fixed: always (the free slot is the reservation).  Paged: the
        pages the request does not share must be free now."""
        if self.pool is None:
            return True
        _, _, shared_full, total = self._prefix_plan(req)
        return total - shared_full <= self.pool.free_count

    def _reserve(self, req: Request) -> None:
        """The paged reservation ``can_admit_now`` approved: ``share()`` the
        matched live leading pages, ``cow()`` a shared partial page (the
        first appended token diverges right after the prefix), then fresh
        pages for the rest.  Records the match on ``req`` (``shared_len``,
        ``shared_pages``, ``shared_kv``)."""
        req.shared_len, req.shared_pages, req.shared_kv = 0, 0, None
        m, entry, shared_full, total = self._prefix_plan(req)
        if entry is None:
            if self.pool.alloc(req.rid, total) is None:
                raise AssertionError("can_admit_now granted what the pool "
                                     "could not give")
            return
        bs = self.pool.block_s
        valid = self.prefix_index.valid_leading_pages(entry)
        partial = (shared_full == m // bs and m % bs != 0
                   and valid > shared_full
                   and len(entry["pages"]) > shared_full)
        take = shared_full + 1 if partial else shared_full
        self.pool.share(req.rid, entry["pages"][:take])
        if ((partial and self.pool.cow(req.rid, shared_full) is None)
                or (total > take
                    and self.pool.extend(req.rid, total - take) is None)):
            raise AssertionError("can_admit_now granted what the pool could "
                                 "not give")
        req.shared_len = m
        req.shared_pages = shared_full
        req.shared_kv = self.prefix_index.resolve_kv(entry)

    def admit(self) -> list[tuple[Request, int]]:
        """Admit queued requests into free slots per policy; requests that
        can never fit go to ``rejected`` (state DONE) unplaced.  Under pool
        pressure the pick stays queued and admission stops (no skip-ahead,
        so a long request is not starved by short ones).  Paged: the
        prompt's and the first token's pages are reserved here, shared
        ones mapped (``_reserve``)."""
        placed: list[tuple[Request, int]] = []
        while self.queue:
            slot = self.free_slot()
            if slot is None:
                break
            req = self._pick()
            if not self.fits(req):
                self.queue.remove(req)
                req.state, req.done, req.finish_reason = DONE, True, "rejected"
                self.rejected.append(req)
                continue
            if not self.can_admit_now(req):
                self._waited.add(req.rid)
                break
            self.queue.remove(req)
            if self.pool is not None:
                self._reserve(req)
            req.state = PREFILL
            if req.admit_seq < 0:
                req.admit_seq = self._admit_seq
                self._admit_seq += 1
            self.slot_rids[slot] = req.rid
            self.slot_len[slot] = len(req.resume_tokens())
            placed.append((req, slot))
        return placed

    def on_token(self, slot: int) -> None:
        """Record one generated token committed to ``slot``'s cache."""
        self.slot_len[slot] += 1

    def grow_for_next_token(self, slot: int) -> list[int] | None:
        """Reserve what the next decode token needs: the pages newly granted
        ([] when the reservation already covers it), or None when the
        request cannot grow — per-slot ``cap`` (fixed), ``max_pages`` or an
        empty free list (paged); the engine then retires with
        "capacity"."""
        if self.pool is None:
            return None if self.slot_len[slot] + 1 >= self.cap else []
        rid = self.slot_rids[slot]
        need = self.pool.pages_for(self.slot_len[slot] + 1)
        have = len(self.pool.pages(rid))
        if need <= have:
            return []
        if need > self.max_pages:
            return None
        return self.pool.extend(rid, need - have)

    def grow_for_window(self, slot: int, want: int) -> int:
        """Reserve up to ``want`` more decode tokens of ``slot`` at once, the
        windowed twin of ``grow_for_next_token``: returns the granted step
        budget ``g <= want`` (0: the slot cannot take one step, and the
        engine retires it with "capacity").  Fixed layout: bounded by
        ``cap`` as ``grow_for_next_token`` is.  Paged: bounded by
        ``max_pages`` and the free list, every needed page taken in ONE
        extend before the window launches, so nothing allocates mid-window.
        A grant below ``want`` that the window's EOS / max-tokens replay
        does not use up is where the single-step engine retires with
        "capacity"."""
        if want <= 0:
            return 0
        if self.pool is None:
            return max(0, min(want, self.cap - 1 - self.slot_len[slot]))
        rid = self.slot_rids[slot]
        have = len(self.pool.pages(rid))
        grantable = min(self.max_pages, have + self.pool.free_count)
        g = min(want, grantable * self.pool.block_s - self.slot_len[slot])
        if g <= 0:
            return 0
        need = self.pool.pages_for(self.slot_len[slot] + g)
        if need > have and self.pool.extend(rid, need - have) is None:
            raise AssertionError("the free list held fewer pages than "
                                 "free_count")
        return g

    def release(self, slot: int) -> None:
        """Free ``slot``; paged: its request's page references are dropped
        (pages no other request maps go back to the pool)."""
        rid = self.slot_rids[slot]
        if self.pool is not None and rid is not None:
            self.pool.release(rid)
        self.slot_rids[slot] = None
        self.slot_len[slot] = 0
