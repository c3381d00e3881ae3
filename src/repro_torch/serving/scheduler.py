"""Admission scheduling for the continuous-batching engine (the port's copy
of the reference's ``serving/scheduler.py``): FCFS/SJF admission into a
fixed slot table, gated by the per-slot cache capacity or, with a paged
pool, by the pool's free pages; the prefix index of prefix sharing; the
preemption of running requests; and the tenancy layer.

Request lifecycle:

    QUEUED --admit--> PREFILL --last chunk--> DECODE --retire--> DONE
       ^                  |                      |
       +----preempt-------+----------preempt-----+

A resumed request whose pages wait in the host tier passes through
RESTORING (its slot held, nothing prefilled or decoded) on its way back to
DECODE.  Preempted requests re-enter at the front of the queue and are
picked first under every policy.

Tenancy (``tenants=`` / ``slo_aware=``): every request carries a
``tenant`` and an SLO class (``interactive``, TTL-bound; ``batch``,
throughput-bound).  With tenancy on, ``_pick`` is a deficit-weighted fair
queue over the base policy: a tenant at its slot quota, or a batch request
while ``batch_cap`` batch slots run, is skipped (never blocking an
eligible request behind it); eligible interactive requests go before batch
ones; among the eligible class the tenant of least served tokens per
weight goes first; and a tenant back from idle has its service raised to
the least-served active tenant's, so idle time banks no burst.
``batch_cap`` is the ceiling the TTL governor (``serving/governor.py``)
moves.  Without tenancy every knob is inert and admission is the plain
FCFS/SJF one.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.serving.tier import device_planes, host_planes

QUEUED = "queued"
PREFILL = "prefill"
# awaiting a host-tier restore: the slot is held while the other slots
# decode; the request neither prefills nor decodes until its pages land
RESTORING = "restoring"
DECODE = "decode"
DONE = "done"

POLICIES = ("fcfs", "sjf")

# SLO classes: interactive work is TTL-bound, batch work throughput-bound
# and the first to be shed under TTL pressure
SLO_INTERACTIVE = "interactive"
SLO_BATCH = "batch"
SLO_CLASSES = (SLO_INTERACTIVE, SLO_BATCH)


@dataclasses.dataclass(frozen=True)
class TenantConfig:
    """One tenant's admission knobs: ``weight``, its share of served
    tokens while backlogged (the least served tokens per weight admits
    first), and ``max_slots`` > 0, a cap on its concurrent slots (0: no
    quota)."""
    name: str
    weight: float = 1.0
    max_slots: int = 0


@dataclasses.dataclass
class Request:
    """One generation request; the engine appends generated tokens to
    ``out_tokens`` and sets ``done``/``finish_reason`` (``"eos"`` |
    ``"max_tokens"`` | ``"capacity"`` | ``"rejected"``) on retirement.
    ``session_id`` keys its pages in the host tier across turns (session
    KV); ``tenant`` and ``slo_class`` place it in the tenancy layer."""
    rid: int
    prompt: list[int]
    max_new_tokens: int = 32
    eos_id: int | None = None
    sampling: Any = None      # SamplingParams; None: the engine's default
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    state: str = QUEUED
    finish_reason: str | None = None
    preempted: bool = False                   # awaiting resume (queue front)
    admit_seq: int = -1                       # admission order stamp
    session_id: str | None = None             # session KV key
    tenant: str = "default"                   # fair-queue accounting bucket
    slo_class: str = SLO_INTERACTIVE          # interactive | batch
    # --- chunked-prefill bookkeeping (engine-internal) ---
    prefill_tokens: list[int] | None = None   # the tokens to prefill
    prefill_pos: int = 0                      # next chunk offset
    buffers: Any = None                       # K/V carry buffers (device)
    # --- prefix-sharing bookkeeping (engine-internal, set at admission) ---
    shared_len: int = 0                       # matched prefix tokens
    shared_pages: int = 0                     # leading logical pages shared
    shared_kv: Any = None                     # host fp K/V of [0, shared_len)
    # --- host-tier spill/restore bookkeeping (engine-internal) ---
    spill_key: str | None = None              # store key of spilled pages
    spill_len: int = 0                        # committed tokens when spilled
    forced_tokens: list[int] | None = None    # known tokens to catch up on
    resume_fallback: bool = False             # restore failed: re-prefill

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
    already-committed KV prefixes (the reference's ``PrefixIndex``).

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
    With ``store`` (a ``serving/tier.HostPageStore``) the K/V blobs live in
    the store under ``prefix:<seq>`` keys, within its page capacity and
    LRU, and the entry keeps the key: an evicted or corrupt blob leaves
    the entry its pages only (the request then prefills in full).
    """

    def __init__(self, block_s: int, pool, max_entries: int = 64,
                 store=None):
        if block_s < 1:
            raise ValueError(f"block_s must be >= 1 (got {block_s})")
        self.block_s = block_s
        self.pool = pool
        self.store = store
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
        shape ``[L, len(tokens), Kh, hsz]``, kept as page stacks (in the
        store when there is one; a refused save registers the pages
        only)."""
        toks = tuple(int(t) for t in tokens)
        if kv is not None:
            kv = tuple(_kv_to_pages(x, self.block_s) for x in kv)
            if self.store is not None:
                key = f"prefix:{self._seq}"
                dtype = kv[0].dtype
                ok = self.store.put(key, host_planes({"k": kv[0],
                                                      "v": kv[1]}),
                                    tokens=toks)
                kv = (key, dtype) if ok else None
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
            if self.store is not None and old["kv"] is not None:
                self.store.drop(old["kv"][0])

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
        None when it has none.  A blob in the store is read through
        ``fetch`` (verified, no injected faults: this runs inside the
        admission decision, which must agree with itself); a blob the store
        lost clears the entry's reference."""
        kv = entry["kv"]
        if kv is None:
            return None
        if self.store is not None:
            key, dtype = kv
            planes = self.store.fetch(key)
            if planes is None:
                entry["kv"] = None
                return None
            planes = device_planes(planes, {"k": dtype, "v": dtype})
            kv = (planes["k"], planes["v"])
        t = len(entry["tokens"])
        return tuple(_pages_to_kv(x, t) for x in kv)

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
    (``_reserve``).  ``tenants`` (``TenantConfig``s, by name or as an
    iterable) and ``slo_aware`` turn on the fair queue (module doc);
    ``slo_aware`` defaults to whether tenants are given."""

    def __init__(self, max_batch: int, cap: int, policy: str = "fcfs",
                 pool=None, max_pages: int = 0, prefix_index=None,
                 tenants=None, slo_aware: bool | None = None):
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
        # --- tenancy (inert unless slo_aware) ---
        if tenants is not None and not isinstance(tenants, dict):
            tenants = {t.name: t for t in tenants}
        self.tenants: dict[str, TenantConfig] | None = tenants
        self.slo_aware = bool(tenants) if slo_aware is None else slo_aware
        self.batch_cap = max_batch              # the governor's ceiling
        self.slot_tenant: list[str | None] = [None] * max_batch
        self.slot_slo: list[str | None] = [None] * max_batch
        self.served_tokens: dict[str, int] = {}
        self._service: dict[str, float] = {}    # served / weight, by tenant

    @property
    def pool_waits(self) -> int:
        return len(self._waited)

    # ----------------------------------------------------------- tenancy
    def _weight(self, tenant: str) -> float:
        cfg = (self.tenants or {}).get(tenant)
        return max(cfg.weight, 1e-9) if cfg is not None else 1.0

    def _running(self, tenant: str | None = None,
                 slo_class: str | None = None) -> int:
        return sum(1 for s, r in enumerate(self.slot_rids)
                   if r is not None
                   and (tenant is None or self.slot_tenant[s] == tenant)
                   and (slo_class is None or self.slot_slo[s] == slo_class))

    def _eligible(self, req: Request) -> bool:
        """The fair queue's filter: the tenant's slot quota and the batch
        cap.  An ineligible request stays queued and is skipped, so it
        never blocks eligible work behind it."""
        if not self.slo_aware:
            return True
        cfg = (self.tenants or {}).get(req.tenant)
        if (cfg is not None and cfg.max_slots > 0
                and self._running(tenant=req.tenant) >= cfg.max_slots):
            return False
        return not (req.slo_class == SLO_BATCH
                    and self._running(slo_class=SLO_BATCH) >= self.batch_cap)

    def record_served(self, slot: int, n: int = 1) -> None:
        """Charge ``n`` generated tokens to ``slot``'s tenant."""
        t = self.slot_tenant[slot]
        if t is None:
            return
        self.served_tokens[t] = self.served_tokens.get(t, 0) + n
        self._service[t] = self._service.get(t, 0.0) + n / self._weight(t)

    # ------------------------------------------------------------- queue
    def submit(self, req: Request, front: bool = False) -> None:
        """Enqueue ``req`` (``front``: a preempted request's resume).  With
        tenancy on, a tenant with nothing queued or running has its service
        raised to the least-served active tenant's."""
        if self.slo_aware and not req.preempted:
            active = ({r.tenant for r in self.queue}
                      | {t for t in self.slot_tenant if t is not None})
            if req.tenant not in active:
                floor = min((self._service.get(t, 0.0) for t in active),
                            default=0.0)
                self._service[req.tenant] = max(
                    self._service.get(req.tenant, 0.0), floor)
        req.state = QUEUED
        if front:
            self.queue.insert(0, req)
        else:
            self.queue.append(req)

    def _pick(self) -> Request | None:
        # preempted requests resume first under every policy
        if not self.slo_aware:
            for r in self.queue:
                if r.preempted:
                    return r
            if self.policy == "sjf":
                # min() is stable: earliest-queued wins among equal lengths
                return min(self.queue, key=lambda r: len(r.resume_tokens()))
            return self.queue[0]
        # the fair queue: the same skeleton over the eligible requests,
        # interactive before batch, the least-served tenant first; None
        # when nothing is eligible
        elig = [r for r in self.queue if self._eligible(r)]
        if not elig:
            return None
        for r in elig:
            if r.preempted:
                return r
        inter = [r for r in elig if r.slo_class != SLO_BATCH]
        pool = inter or elig
        tenant = min({r.tenant for r in pool},
                     key=lambda t: (self._service.get(t, 0.0), t))
        cand = [r for r in pool if r.tenant == tenant]
        if self.policy == "sjf":
            return min(cand, key=lambda r: len(r.resume_tokens()))
        return cand[0]

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

    def reject(self, req: Request) -> None:
        """Retire ``req`` unplaced with ``finish_reason="rejected"``."""
        req.state, req.done, req.finish_reason = DONE, True, "rejected"
        self.rejected.append(req)

    def _place(self, req: Request, slot: int) -> None:
        """Reserve ``req``'s pages (paged), stamp its first admission and
        put it in ``slot`` in PREFILL.  A resumed request keeps its stamp,
        so it keeps its seniority among prefills."""
        if self.pool is not None:
            self._reserve(req)
        req.state = PREFILL
        if req.admit_seq < 0:
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
        req.preempted = False
        self.slot_rids[slot] = req.rid
        self.slot_len[slot] = len(req.resume_tokens())
        self.slot_tenant[slot] = req.tenant
        self.slot_slo[slot] = req.slo_class

    def admit(self) -> list[tuple[Request, int]]:
        """Admit queued requests into free slots per policy; requests that
        can never fit go to ``rejected`` (state DONE) unplaced.  Under pool
        pressure the pick stays queued and admission stops (no skip-ahead,
        so a long request is not starved by short ones); so does a fair
        queue with nothing eligible.  Paged: the prompt's and the first
        token's pages are reserved here, shared ones mapped
        (``_reserve``)."""
        placed: list[tuple[Request, int]] = []
        while self.queue:
            slot = self.free_slot()
            if slot is None:
                break
            req = self._pick()
            if req is None:
                break
            if not self.fits(req):
                self.queue.remove(req)
                self.reject(req)
                continue
            if not self.can_admit_now(req):
                self._waited.add(req.rid)
                break
            self.queue.remove(req)
            self._place(req, slot)
            placed.append((req, slot))
        return placed

    def assign_direct(self, req: Request) -> int | None:
        """Place ``req`` in a free slot now, past the queue (the engine's
        ``add_request``): the slot, or None when the batch is full, the
        pool cannot give its pages now, or the gate rejects it (then
        ``req.finish_reason == "rejected"``).  The same capacity oracle as
        ``admit``."""
        slot = self.free_slot()
        if slot is None:
            return None
        if not self.fits(req):
            self.reject(req)
            return None
        if not self.can_admit_now(req):
            return None
        self._place(req, slot)
        return slot

    # ----------------------------------------------------------- running
    def on_token(self, slot: int) -> None:
        """Record one generated token committed to ``slot``'s cache."""
        self.slot_len[slot] += 1

    def at_capacity(self, slot: int) -> bool:
        """Whether ``slot`` cannot take another token: the read-only twin
        of ``grow_for_next_token``."""
        if self.pool is None:
            return self.slot_len[slot] + 1 >= self.cap
        rid = self.slot_rids[slot]
        need = self.pool.pages_for(self.slot_len[slot] + 1)
        have = len(self.pool.pages(rid)) if rid is not None else 0
        return need > have and (need > self.max_pages
                                or need - have > self.pool.free_count)

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
        self.slot_tenant[slot] = None
        self.slot_slo[slot] = None

    def preempt(self, slot: int, req: Request) -> None:
        """Release ``slot`` and requeue ``req`` at the front, to be picked
        first under every policy."""
        if self.slot_rids[slot] != req.rid:
            raise AssertionError(f"slot {slot} holds {self.slot_rids[slot]},"
                                 f" not {req.rid}")
        self.release(slot)
        req.preempted = True
        self.submit(req, front=True)

    # -------------------------------------------------------- invariants
    def check_invariants(self) -> None:
        """Raise unless: no rid is in two slots, queue and slots are
        disjoint, committed lengths are within capacity (paged: within the
        slot's pages, pages are conserved and held only by placed
        requests), tenant tags follow the slots and service is
        non-negative."""
        live = [r for r in self.slot_rids if r is not None]
        qrids = [r.rid for r in self.queue]
        bad = []
        if len(live) != len(set(live)):
            bad.append(f"slot double-assignment {live}")
        if any((rid is None) != (t is None) or (rid is None) != (c is None)
               for rid, t, c in zip(self.slot_rids, self.slot_tenant,
                                    self.slot_slo)):
            bad.append("slot tenant/SLO tags out of sync with the rids")
        if (any(v < 0 for v in self.served_tokens.values())
                or any(v < 0.0 for v in self._service.values())):
            bad.append(f"negative service {self._service}")
        if not 0 <= self.batch_cap <= self.max_batch:
            bad.append(f"batch_cap {self.batch_cap}")
        if len(qrids) != len(set(qrids)) or set(qrids) & set(live):
            bad.append(f"queue {qrids} vs slots {live}")
        for s, (rid, ln) in enumerate(zip(self.slot_rids, self.slot_len)):
            if rid is None:
                continue
            if self.pool is None:
                if not 0 < ln < self.cap:
                    bad.append(f"slot {s} length {ln} vs cap {self.cap}")
                continue
            have = len(self.pool.pages(rid))
            if not 0 < ln <= have * self.pool.block_s \
                    or have > self.max_pages:
                bad.append(f"slot {s} length {ln} over its {have} pages")
        if bad:
            raise AssertionError("; ".join(bad))
        if self.pool is not None:
            self.pool.check_invariants()
            holders = {r for r in self.pool._pages if self.pool.pages(r)}
            if not holders <= set(live):
                raise AssertionError(f"pages held by unplaced requests: "
                                     f"{holders - set(live)}")
