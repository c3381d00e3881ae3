"""Admission scheduling for the continuous-batching engine (the port's copy
of the reference's ``serving/scheduler.py``, trimmed to the engine's main
path: FCFS/SJF admission into a fixed slot table, gated by the per-slot
cache capacity or, with a paged pool, by the pool's free pages).  Tenancy,
the prefix index and preemption are not ported yet.

Request lifecycle: QUEUED --admit--> PREFILL --first token--> DECODE
--retire--> DONE.
"""
from __future__ import annotations

import dataclasses

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
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    state: str = QUEUED
    finish_reason: str | None = None

    def resume_tokens(self) -> list[int]:
        """Tokens to prefill: the prompt plus anything already generated."""
        return list(self.prompt) + list(self.out_tokens)


class Scheduler:
    """FCFS/SJF admission queue + slot table with cache-pressure gating.

    Fixed layout: ``cap`` is the per-slot KV capacity; a slot's committed
    length never reaches it (the engine retires the request one token
    earlier).  Paged (``pool``, a ``serving/pool.BlockAllocator``): the
    capacity oracle is the pool — ``fits`` (could the request ever fit:
    ``max_pages`` and the pool's capacity), ``can_admit_now`` (its pages are
    free now; otherwise it waits in the queue) and ``grow_for_next_token``
    (the next token's page, reserved atomically).  ``pool_waits`` counts
    the requests the pool made wait at least once."""

    def __init__(self, max_batch: int, cap: int, policy: str = "fcfs",
                 pool=None, max_pages: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"unknown sched policy {policy!r}; "
                             f"choose from {POLICIES}")
        self.policy = policy
        self.cap = cap
        self.max_batch = max_batch
        self.pool = pool
        self.max_pages = max_pages or (pool.capacity if pool else 0)
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

    def fits(self, req: Request) -> bool:
        """Could ``req``'s prefill plus one generated token *ever* fit: the
        per-slot ``cap`` (fixed), or ``max_pages`` and the pool (paged)?
        False means reject."""
        need = len(req.resume_tokens()) + 1
        if self.pool is None:
            return need <= self.cap
        total = self.pool.pages_for(need)
        return total <= self.max_pages and total <= self.pool.capacity

    def can_admit_now(self, req: Request) -> bool:
        """Fixed: always (the free slot is the reservation).  Paged: the
        pages of the prompt plus one token must be free now."""
        if self.pool is None:
            return True
        need = len(req.resume_tokens()) + 1
        return self.pool.pages_for(need) <= self.pool.free_count

    def admit(self) -> list[tuple[Request, int]]:
        """Admit queued requests into free slots per policy; requests that
        can never fit go to ``rejected`` (state DONE) unplaced.  Under pool
        pressure the pick stays queued and admission stops (no skip-ahead,
        so a long request is not starved by short ones)."""
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
            need = len(req.resume_tokens())
            if self.pool is not None:
                got = self.pool.alloc(req.rid, self.pool.pages_for(need + 1))
                if got is None:
                    raise AssertionError("can_admit_now granted what the "
                                         "pool could not give")
            req.state = PREFILL
            self.slot_rids[slot] = req.rid
            self.slot_len[slot] = need
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

    def release(self, slot: int) -> None:
        """Free ``slot``; paged: its request's pages go back to the pool."""
        rid = self.slot_rids[slot]
        if self.pool is not None and rid is not None:
            self.pool.free(rid)
        self.slot_rids[slot] = None
        self.slot_len[slot] = 0
