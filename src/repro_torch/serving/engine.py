"""Scheduler-driven continuous-batching engine over the Helix serve step
(port of the reference's ``serving/engine.py`` ``DecodeEngine``, main path):
decode state with one request per slot and per-request lengths, FCFS/SJF
admission, one-shot prefill, greedy decoding, and the int8 KV cache
(``hx.kv_cache_bits == 8``: each admitted request's fp prefill cache is
quantized at the handoff) and int8 lm_head (``hx.lm_head_w8``: the head is
quantized once, here).

KV layouts: fixed (one ``cap``-slot row per batch slot) or, with
``hx.paged_kv``, a shared pool of ``pool_blocks`` pages of ``kvp * rr``
positions (``serving/pool.py``): admission waits for free pages, decode
growth takes a page when the next token needs one, and each slot's page
list is mirrored into its ``block_tables`` row (idle rows stay on the sink
page 0).

One engine ``step()``: admit queued requests into free slots (each one-shot
prefilled, all first tokens fetched in ONE device->host transfer), then one
decode step for every decoding slot (ONE device->host transfer of the [B]
next tokens), retiring requests at EOS, ``max_new_tokens`` or capacity.

Not ported yet: chunked prefill, the host KV tier, prefix sharing,
tenancy and the TTL governor, sampling and decode windows.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.kvcache import (cache_capacity, cache_to_pages,
                                      init_decode_state, page_positions,
                                      quantize_decode_state)
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels import registry
from repro_torch.models.decode_model import prepare_decode_params
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.pool import BlockAllocator
from repro_torch.serving.scheduler import DECODE, DONE, Request, Scheduler

__all__ = ["DecodeEngine", "Request"]


class DecodeEngine:
    """Continuous-batching decode engine (see module doc).

    ``serve_step`` / ``prefill_step`` come from ``build_serve_step`` /
    ``make_prefill_step`` for the same ``hx``; ``model`` holds the weights
    on ``device``.  On a CUDA device every kernel backend ``hx`` selects
    must be available, or the constructor raises.  With ``hx.paged_kv``,
    ``pool_blocks`` sizes the pool (default: the fixed layout's memory plus
    the sink page) and ``max_pages`` caps one request's table (default: the
    whole pool)."""

    def __init__(self, cfg: ArchConfig, model, serve_step: Callable,
                 prefill_step: Callable, *, max_batch: int, max_seq: int,
                 hx: HelixConfig, dtype=torch.bfloat16, device="cuda",
                 sched_policy: str = "fcfs", clock=time.monotonic,
                 pool_blocks: int = 0, max_pages: int = 0):
        device = torch.device(device)
        if device.type == "cuda":
            families = [("attn_backend", "flash_decode"),
                        ("prefill_backend", "flash_prefill")]
            if hx.lm_head_w8:
                families.append(("matmul_backend", "w8a16_matmul"))
            for field, family in families:
                ok, why = registry.available(family, getattr(hx, field))
                if not ok:
                    raise RuntimeError(
                        f"{field}={getattr(hx, field)!r} unavailable: {why}")
        self.cfg, self.hx, self.device = cfg, hx, device
        # the int8 head is made once here, never per decode step
        self.model = prepare_decode_params(model, hx)
        self.serve_step = serve_step
        self.prefill_step = prefill_step
        self.max_batch = max_batch
        self.kvp, self.rr = hx.kvp, hx.rr_block
        self.cap = cache_capacity(max_seq, self.kvp, self.rr)
        self.kv8 = hx.kv_cache_bits == 8
        self.paged = hx.paged_kv
        self.block_s = page_positions(self.kvp, self.rr)
        self.pool = None
        self.pool_blocks = self.max_pages = 0
        if self.paged:
            self.pool_blocks = (pool_blocks
                                or max_batch * (self.cap // self.block_s) + 1)
            self.pool = BlockAllocator(self.pool_blocks, self.block_s)
            self.max_pages = min(max_pages or self.pool.capacity,
                                 self.pool.capacity)
        self._frag_samples: list[float] = []
        self.state = init_decode_state(cfg, max_batch, self.cap, self.kvp,
                                       self.rr, dtype=dtype, device=device,
                                       kv_bits=hx.kv_cache_bits,
                                       pool_blocks=self.pool_blocks,
                                       max_pages=self.max_pages)
        # per-request lengths: [B]; empty slots keep 0
        self.state["total_len"] = torch.zeros(max_batch, dtype=torch.int32,
                                              device=device)
        self.slots: list[Request | None] = [None] * max_batch
        self.cur_tokens = torch.zeros(max_batch, dtype=torch.int32,
                                      device=device)
        self.sched = Scheduler(max_batch=max_batch, cap=self.cap,
                               policy=sched_policy, pool=self.pool,
                               max_pages=self.max_pages)
        self.metrics = EngineMetrics(clock=clock)
        self.decode_syncs = 0           # decode steps (one transfer each)

    # ------------------------------------------------------------- requests
    def submit(self, req: Request) -> None:
        """Queue ``req``; ``step()`` admits it when a slot frees up."""
        self.metrics.on_submit(req.rid)
        self.sched.submit(req)

    def pending(self) -> bool:
        """True while any request is queued or holds a slot."""
        return bool(self.sched.queue) or any(self.slots)

    def step(self) -> list[Request]:
        """Admission, then one decode step; returns the requests retired."""
        finished = self._admit()
        finished += self._decode_step()
        return finished

    # -------------------------------------------------------------- phases
    def _admit(self) -> list[Request]:
        retired = []
        deferred: list[tuple[Request, int, Any]] = []
        for req, slot in self.sched.admit():
            self.metrics.on_admit(req.rid)
            self.slots[slot] = req
            deferred.append((req, slot, self._oneshot_prefill(req, slot)))
        if deferred:
            # every admission's first token in ONE device->host transfer
            vals = torch.stack([d for _, _, d in deferred]).tolist()
            for (req, slot, _), v in zip(deferred, vals):
                retired += self._commit_first_token(req, slot, int(v))
        while self.sched.rejected:
            req = self.sched.rejected.pop()
            self.metrics.on_finish(req.rid, "rejected")
            retired.append(req)
        return retired

    def _oneshot_prefill(self, req: Request, slot: int):
        """Prefill ``req`` into ``slot``; returns its first token (device)."""
        toks_list = req.resume_tokens()
        toks = torch.tensor([toks_list], dtype=torch.int64, device=self.device)
        last_logits, pstate = self.prefill_step(self.model, {"tokens": toks})
        self._scatter_state(pstate, slot, len(toks_list), req)
        return torch.argmax(last_logits[0, :self.cfg.vocab]).to(torch.int32)

    def _scatter_state(self, pstate: dict, slot: int, t: int,
                       req: Request) -> None:
        """Copy a single-request prefill state into ``slot``: the common
        round-robin prefix of every rank's local slots (the two capacities
        may differ; layouts match).  int8 engines copy the fp cache into a
        zero f32 slot row first and quantize that whole row
        (``quantize_decode_state``), as the reference does.  Paged engines
        write the cache's pages into the pages granted at admission
        (``_scatter_paged``)."""
        if self.paged:
            self._scatter_paged(pstate, slot, req)
        elif self.kv8:
            row = {}
            for key in ("kcache", "vcache"):
                dst = self.state[key][:, slot]
                row[key] = torch.zeros(dst.shape, dtype=torch.float32,
                                       device=dst.device)
                _copy_rr(pstate[key][:, 0], row[key], self.kvp)
            q = quantize_decode_state(row)
            for key in ("kcache", "vcache", "kscale", "vscale"):
                self.state[key][:, slot] = q[key]
        else:
            for key in ("kcache", "vcache"):
                _copy_rr(pstate[key][:, 0], self.state[key][:, slot],
                         self.kvp)
        self.state["total_len"][slot] = t

    def _scatter_paged(self, pstate: dict, slot: int, req: Request) -> None:
        """Paged half of ``_scatter_state``: the prefill cache split into
        pages (``cache_to_pages``), written at the physical pages the
        allocator granted; int8 engines quantize those pages with the decode
        append's formula.  Granted pages beyond the prefill extent keep
        stale rows at positions >= t, which every backend masks."""
        phys = self.pool.pages(req.rid)
        pages = {key: cache_to_pages(pstate[key][:, 0], self.kvp,
                                     self.block_s)
                 for key in ("kcache", "vcache")}
        n = min(pages["kcache"].shape[1], len(phys))
        idx = torch.tensor(phys[:n], dtype=torch.int64, device=self.device)
        if self.kv8:
            pages = quantize_decode_state({k: v[:, :n].float()
                                           for k, v in pages.items()})
            for key in ("kcache", "vcache", "kscale", "vscale"):
                self.state[key][:, idx] = pages[key]
        else:
            for key in ("kcache", "vcache"):
                self.state[key][:, idx] = pages[key][:, :n].to(
                    self.state[key].dtype)
        self._mirror_table(slot)

    def _mirror_table(self, slot: int) -> None:
        """Write ``slot``'s page list into its ``block_tables`` row (unused
        tail entries point at the sink page 0)."""
        phys = self.pool.pages(self.slots[slot].rid)
        row = torch.zeros(self.max_pages, dtype=torch.int32)
        row[:len(phys)] = torch.tensor(phys, dtype=torch.int32)
        self.state["block_tables"][slot] = row.to(self.device)

    def _commit_first_token(self, req: Request, slot: int,
                            token: int) -> list[Request]:
        req.out_tokens.append(token)
        self.cur_tokens[slot] = token
        req.state = DECODE
        self.metrics.on_token(req.rid)
        if req.eos_id is not None and token == req.eos_id:
            return [self._retire(req, slot, "eos")]
        if len(req.out_tokens) >= req.max_new_tokens:
            return [self._retire(req, slot, "max_tokens")]
        r = self._grow_or_retire(req, slot)
        return [r] if r is not None else []

    def _grow_or_retire(self, req: Request, slot: int) -> Request | None:
        grown = self.sched.grow_for_next_token(slot)
        if grown is None:
            return self._retire(req, slot, "capacity")
        if grown:
            self._mirror_table(slot)
        return None

    def _decode_step(self) -> list[Request]:
        """One decode step for every DECODE slot; returns retirements."""
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and r.state == DECODE]
        if not active:
            return []
        next_tokens, self.state = self.serve_step(
            self.model, self.state, self.cur_tokens)
        self.cur_tokens = next_tokens
        # serve_step advances total_len for every row; idle slots go back to
        # 0 so their rows stay O(1) work
        idle = [i for i in range(self.max_batch) if i not in active]
        if idle:
            self.state["total_len"][idle] = 0
        toks = next_tokens.tolist()          # one device->host transfer
        self.decode_syncs += 1
        finished = []
        for i in active:
            req = self.slots[i]
            tok = int(toks[i])
            req.out_tokens.append(tok)
            self.sched.on_token(i)
            self.metrics.on_token(req.rid)
            if req.eos_id is not None and tok == req.eos_id:
                finished.append(self._retire(req, i, "eos"))
            elif len(req.out_tokens) >= req.max_new_tokens:
                finished.append(self._retire(req, i, "max_tokens"))
            else:
                r = self._grow_or_retire(req, i)
                if r is not None:
                    finished.append(r)
        if self.paged:
            self._sample_pool()
        return finished

    def _retire(self, req: Request, slot: int, reason: str) -> Request:
        req.done = True
        req.state = DONE
        req.finish_reason = reason
        self.slots[slot] = None
        self.sched.release(slot)
        self.state["total_len"][slot] = 0
        if self.paged:
            # park the row on the sink page: its next idle append lands
            # there, not in a page the pool may hand to another request
            self.state["block_tables"][slot] = 0
        self.metrics.on_finish(req.rid, reason)
        return req

    def _sample_pool(self) -> None:
        """One internal-fragmentation sample of the allocated pages (1 -
        committed positions / allocated positions) for ``pool_stats``."""
        used = self.pool.used_count
        if used:
            self._frag_samples.append(
                1.0 - sum(self.sched.slot_len) / (used * self.block_s))

    def pool_stats(self) -> dict:
        """Paged-pool health: peak occupancy (peak pages in use /
        allocatable pages), mean internal fragmentation of allocated pages,
        the retirements with ``finish_reason="capacity"``, and (port only)
        ``pool_waits``, the requests the pool made wait at least once.
        Fixed-layout engines report zeros for the pool fields."""
        cap_retired = sum(1 for m in self.metrics.requests.values()
                          if m.finish_reason == "capacity")
        if not self.paged:
            return {"paged_kv": False, "pool_occupancy_peak": 0.0,
                    "pool_frag_mean": 0.0, "capacity_retired": cap_retired,
                    "pool_waits": 0}
        frag = (sum(self._frag_samples) / len(self._frag_samples)
                if self._frag_samples else 0.0)
        return {"paged_kv": True,
                "pool_occupancy_peak":
                    self.pool.peak_in_use / max(self.pool.capacity, 1),
                "pool_frag_mean": frag, "capacity_retired": cap_retired,
                "pool_waits": self.sched.pool_waits}


def _copy_rr(src, dst, kvp: int) -> None:
    """Copy a round-robin cache [L, Kh, S_src, hsz] into ``dst`` [L, Kh,
    S_dst, hsz] in place: rank r's local slots [0, min(S_src, S_dst)/kvp)
    land at the same local slots of ``dst``."""
    ls, ld = src.shape[-2] // kvp, dst.shape[-2] // kvp
    n = min(ls, ld)
    srcr = src.reshape(*src.shape[:-2], kvp, ls, src.shape[-1])
    dstr = dst.view(*dst.shape[:-2], kvp, ld, dst.shape[-1])
    dstr[..., :n, :] = srcr[..., :n, :]
