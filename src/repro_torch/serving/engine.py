"""Scheduler-driven continuous-batching engine over the Helix serve step
(port of the reference's ``serving/engine.py`` ``DecodeEngine``, main path):
decode state with one request per slot and per-request lengths, FCFS/SJF
admission, one-shot or chunked prefill, greedy decoding, and the int8 KV
cache (``hx.kv_cache_bits == 8``: each admitted request's fp prefill cache
is quantized at the handoff) and int8 lm_head (``hx.lm_head_w8``: the head
is quantized once, here).

KV layouts: fixed (one ``cap``-slot row per batch slot) or, with
``hx.paged_kv``, a shared pool of ``pool_blocks`` pages of ``kvp * rr``
positions (``serving/pool.py``): admission waits for free pages, decode
growth takes a page when the next token needs one, and each slot's page
list is mirrored into its ``block_tables`` row (idle rows stay on the sink
page 0).

Chunked prefill (``chunk_tokens``): prompts prefill ``chunk_tokens`` at a
time into per-request carry buffers, one packed chunk per engine step
interleaved with decode; the handoff is the one-shot path's, so the
decode state is the same bit for bit where the projections are.

Prefix sharing (``prefix_share``, paged and chunked only): a
``PrefixIndex`` matches new prompts against the prefixes of finished
prefills; matched live pages are mapped refcounted into the new request's
table (copy-on-write before any write to a shared page), the matched K/V
is restored into its buffers from a host copy and only the suffix
prefills.  Grouped decode (``hx.grouped_decode``, paged): requests whose
tables share leading pages decode them once per group
(``_set_groups``; the ``prefix_pass`` kernel).

One engine ``step()``: admit queued requests into free slots (one-shot
prefills' first tokens fetched in ONE device->host transfer), advance one
packed group of chunked prefills by a chunk, then one decode step for every
decoding slot (ONE device->host transfer of the [B] next tokens), retiring
requests at EOS, ``max_new_tokens`` or capacity.

Pure-SSM archs (mamba2): the decode state holds ``ssm_conv``/``ssm_state``
leaves instead of K/V caches, prefills are one-shot (``chunk_tokens`` is
ignored, as in the reference) and the int8 KV cache changes nothing.
The paged pool and prefix sharing are refused: in the reference the
first needs a ``block_tables`` leaf no SSM state has (it fails at the first
retirement) and the second needs chunked prefill.

Hybrid archs (hymba): the decode state holds the KV leaves (fixed or
paged, fp or int8) and the SSM leaves together; both are scattered at
admission.  Prefills are one-shot (``chunk_tokens`` is ignored), so prefix
sharing, which rides chunked prefill, is refused, as in the reference;
the paged pool is allowed.

On-device sampling (``sampling``, a ``SamplingParams``; per request
``Request.sampling``): the decode state carries the sampler's per-row
leaves, installed at each request's first token with ``sample_idx`` at
``len(out_tokens)``; first tokens of prefills are sampled on the device
too (``_first_token_dev``).  Decode windows (``decode_window`` N > 1 with
``serve_multistep`` from ``build_serve_multistep``): each engine step
decodes up to N tokens for every decoding slot in one call, replayed as
one CUDA graph on the card (``serving/graph.py``), with ONE device->host
transfer of the [B, N] token block; the host replays the window token by
token (j-major), so retirements and metrics follow the single-step
engine's order and the streams are equal to N = 1 bit for bit.
``sync_stats()`` reports the transfers per decoded token.

Host KV tier (``host_pages``, ``session_kv``, ``fault_plan``; paged only):
``preempt`` spills a decoding request's pool pages to a
``serving/tier.HostPageStore`` (one gather per plane and ONE device->host
synchronisation), and its resume restores them (one host->device copy per
plane, scattered in place into the pages granted at re-admission) with no
prefill chunk; the tokens known past the restored span are teacher-forced
through decode steps (``forced_tokens``; in a window, through its forced
block).  ``session_kv`` keeps a retired request's pages under its session
id, so the next turn of the conversation restores its history.  Every
fault the plan injects (a lost restore, a corrupt page, a full store, a
late restore) degrades to re-prefilling, counted in
``resume_reprefill_chunks``.  The pool planes are written in place, so a
window's CUDA graph replays across a restore.  Archs with SSM state are
refused, as in the reference: a restore could not rebuild it.  With a
store, the prefix index keeps its K/V blobs there too.  An engine with
``prefix_share`` and no host tier builds no store and keeps them inline,
paying no host copy or CRC per registration; the reference builds its
store for ``prefix_share`` alone too.

Tenancy (``tenants``): a fair queue of weighted tenants and SLO classes in
the scheduler.  ``slo_ttl_s`` arms the TTL governor, which after each
step may lower the batch cap and shed the youngest decoding batch request
through the spill.  With a
``VirtualClock`` as ``clock`` every latency is the cost model's, so runs
replay exactly.

Across ranks (``group``, a ``core/dist.HelixGroup``): every rank runs the
same engine on the same requests (SPMD), with its ``shard_model`` share as
``model``, its local caches in the state and ``serve_step`` /
``prefill_step`` built with the same group; the logits are all-gathered,
so every rank takes the same tokens and the same decisions.  The
constructor refuses, with ``ValueError``, what this path leaves out: the
paged pool, chunked prefill, prefix sharing, grouped decode, the int8 KV
cache and head, sampling, decode windows > 1, the host tier, and every
decision a rank would read off its own clock (tenancy's fair queue, the
TTL governor), where ranks could part and hang each other; archs other
than the dense and MoE families are refused too.

Enc-dec (whisper) and vlm (phi-3-vision) archs are refused at
construction (``check_servable``): their prefill needs per-request
``enc_frames`` or ``patch_embeds``, which a ``Request`` does not carry.
They are served through ``make_prefill_step`` and ``build_serve_step`` /
``build_serve_multistep``.  The reference's engine builds for them and
fails with a ``KeyError`` at its first prefill.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.kvcache import (cache_capacity, cache_to_pages,
                                      gather_pool_pages, init_decode_state,
                                      page_positions, quantize_decode_state,
                                      scatter_pool_pages)
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels import registry
from repro_torch.models.decode_model import (check_rank_step,
                                             prepare_decode_params)
from repro_torch.models.model_zoo import (chunked_prefill_supported,
                                          finalize_chunked_prefill,
                                          init_prefill_buffers)
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.governor import GovernorConfig, TTLGovernor
from repro_torch.serving.graph import WindowRunner
from repro_torch.serving.metrics import EngineMetrics, VirtualClock
from repro_torch.serving.pool import BlockAllocator
from repro_torch.serving.sampling import request_seed, sample_tokens
from repro_torch.serving.scheduler import (DECODE, DONE, PREFILL, RESTORING,
                                           SLO_BATCH, PrefixIndex, Request,
                                           Scheduler)
from repro_torch.serving.tier import (HostPageStore, device_planes,
                                      host_planes)

__all__ = ["DecodeEngine", "Request"]


def check_servable(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for the archs the engine does not serve: enc-dec
    and vlm, whose prefill takes inputs besides the prompt's tokens."""
    if cfg.is_encdec or cfg.vision_patches:
        need = "enc_frames" if cfg.is_encdec else "patch_embeds"
        raise ValueError(
            f"the engine does not serve the {cfg.family} family ({cfg.name}):"
            f" its prefill needs {need} beside the tokens, which a Request "
            "does not carry; serve it through model_zoo.make_prefill_step "
            "and build_serve_step / build_serve_multistep")


def check_rank_engine(cfg: ArchConfig, hx: HelixConfig, *, chunk_tokens=0,
                      prefix_share=False, sampling=None, decode_window=1,
                      host_pages=0, session_kv=False, fault_plan=None,
                      tenants=None, slo_ttl_s=None) -> None:
    """Raise ``ValueError`` for an engine option the multi-rank path does
    not take (module doc), and for what its decode step refuses."""
    check_rank_step(cfg, hx)
    refused = {"chunk_tokens (chunked prefill)": chunk_tokens,
               "prefix_share": prefix_share,
               "hx.grouped_decode": hx.grouped_decode,
               "sampling": sampling is not None,
               "decode_window > 1": decode_window > 1,
               "the host tier (host_pages, session_kv, fault_plan)":
                   host_pages or session_kv or fault_plan is not None,
               "tenants (a fair queue read off each rank's clock)": tenants,
               "slo_ttl_s (the TTL governor reads each rank's clock)":
                   slo_ttl_s is not None}
    named = [name for name, on in refused.items() if on]
    if named:
        raise ValueError("across ranks the engine does not take "
                         + ", ".join(named))


class DecodeEngine:
    """Continuous-batching decode engine (see module doc).

    ``serve_step`` / ``prefill_step`` come from ``build_serve_step`` /
    ``make_prefill_step`` for the same ``hx``; ``model`` holds the weights
    on ``device``.  On a CUDA device every kernel backend ``hx`` selects
    must be available, or the constructor raises.  With ``hx.paged_kv``,
    ``pool_blocks`` sizes the pool (default: the fixed layout's memory plus
    the sink page) and ``max_pages`` caps one request's table (default: the
    whole pool).  ``chunk_tokens`` > 0 with ``chunk_prefill_step`` (from
    ``make_chunk_prefill_step``) turns on chunked prefill; ``prefix_share``
    the prefix index (needs the paged pool and chunked prefill, as in the
    reference).  ``sampling`` (a ``SamplingParams``) arms the on-device
    sampler; a sampling engine's chunk step must be built with
    ``return_last_logits=True``.  ``decode_window`` > 1 decodes that many
    tokens per engine step through ``serve_multistep``.

    Host tier (module doc): ``host_pages`` sizes the store that spills
    preempted requests (0: no spill), ``session_kv`` keeps retired
    requests' pages by session, ``fault_plan`` (a ``FaultPlan`` or its
    spec) injects faults; the store also holds the prefix index's blobs
    when there is one.  ``tenants`` (``TenantConfig``s) arms the fair
    queue, ``slo_ttl_s`` (seconds) the TTL governor; ``clock`` is the
    metrics clock (a ``VirtualClock`` is advanced by the engine's
    work).  ``group`` (a ``core/dist.HelixGroup``): this engine is one
    rank of the multi-rank path (module doc); ``model`` is the rank's
    share and the steps are built with the same group."""

    def __init__(self, cfg: ArchConfig, model, serve_step: Callable,
                 prefill_step: Callable, *, max_batch: int, max_seq: int,
                 hx: HelixConfig, dtype=torch.bfloat16, device="cuda",
                 sched_policy: str = "fcfs", clock=time.monotonic,
                 pool_blocks: int = 0, max_pages: int = 0,
                 chunk_tokens: int = 0,
                 chunk_prefill_step: Callable | None = None,
                 prefix_share: bool = False, sampling=None,
                 decode_window: int = 1,
                 serve_multistep: Callable | None = None,
                 host_pages: int = 0, session_kv: bool = False,
                 fault_plan=None, tenants=None,
                 slo_ttl_s: float | None = None, group=None):
        device = torch.device(device)
        check_servable(cfg)
        if group is not None:
            check_rank_engine(cfg, hx, chunk_tokens=chunk_tokens,
                              prefix_share=prefix_share, sampling=sampling,
                              decode_window=decode_window,
                              host_pages=host_pages, session_kv=session_kv,
                              fault_plan=fault_plan, tenants=tenants,
                              slo_ttl_s=slo_ttl_s)
        if (host_pages or session_kv) and not hx.paged_kv:
            raise ValueError("the host KV tier (host_pages / session_kv) "
                             "needs hx.paged_kv: spill and restore go by "
                             "pages")
        if (host_pages or session_kv) and cfg.has_ssm:
            raise ValueError("the host KV tier only spills pool planes; "
                             f"{cfg.name} keeps SSM state leaves a restore "
                             "could not rebuild")
        if sampling is not None:
            sampling.validate()
        if decode_window < 1:
            raise ValueError(f"decode_window must be >= 1 ({decode_window})")
        if decode_window > 1 and serve_multistep is None:
            raise ValueError("decode_window > 1 needs serve_multistep "
                             "(build one with build_serve_multistep)")
        if decode_window > 1 and hx.paged_kv and hx.grouped_decode:
            raise ValueError("decode_window > 1 is incompatible with "
                             "hx.grouped_decode: group_id/group_np are "
                             "host-recomputed every token and would go "
                             "stale mid-window")
        if hx.paged_kv and not cfg.has_attention:
            raise ValueError(f"hx.paged_kv: {cfg.name} keeps no KV cache to "
                             "page (its decode state has no block_tables)")
        if device.type == "cuda":
            families = []
            if cfg.has_attention:
                families += [("attn_backend", "flash_decode"),
                             ("prefill_backend", "flash_prefill")]
            if cfg.has_ssm:
                families.append(("ssd_backend", "ssd_prefill"))
            if hx.lm_head_w8:
                families.append(("matmul_backend", "w8a16_matmul"))
            if hx.paged_kv and hx.grouped_decode:
                families.append(("attn_backend", "prefix_pass"))
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
        self.sampling = sampling
        self.decode_window = decode_window
        self.window_runner = (WindowRunner(serve_multistep)
                              if serve_multistep is not None else None)
        self.dtype = dtype
        self.max_batch = max_batch
        self.kvp, self.rr = hx.kvp, hx.rr_block
        self.group = group
        # KVP shards a state row holds: all of them, or the rank's own
        self.shards = self.kvp if group is None else 1
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
        # grouped decode: _set_groups refreshes group_id/group_np each step
        self.grouped = self.paged and hx.grouped_decode
        self.state = init_decode_state(cfg, max_batch, self.cap, self.kvp,
                                       self.rr, dtype=dtype, device=device,
                                       kv_bits=hx.kv_cache_bits,
                                       pool_blocks=self.pool_blocks,
                                       max_pages=self.max_pages,
                                       grouped=self.grouped,
                                       sampling=sampling is not None,
                                       tpa=hx.tpa, local=group is not None)
        # per-request lengths: [B]; empty slots keep 0
        self.state["total_len"] = torch.zeros(max_batch, dtype=torch.int32,
                                              device=device)
        self.slots: list[Request | None] = [None] * max_batch
        self.cur_tokens = torch.zeros(max_batch, dtype=torch.int32,
                                      device=device)
        # archs whose prefill cannot run in chunks take one-shot prefills
        chunk_tokens = chunk_tokens if chunked_prefill_supported(cfg) else 0
        if chunk_tokens and chunk_prefill_step is None:
            raise ValueError("chunk_tokens set but no chunk_prefill_step "
                             "(build one with make_chunk_prefill_step)")
        self.chunk_tokens = chunk_tokens
        self.chunk_step = chunk_prefill_step
        # host KV tier: the store spills preempted requests (host_pages)
        # and keeps sessions (session_kv); the prefix index's blobs go
        # there too when it exists, and stay inline without a tier
        self.session_kv = session_kv
        self.spill_enabled = host_pages > 0
        if isinstance(fault_plan, str):
            fault_plan = FaultPlan.parse(fault_plan)
        self.store = None
        if self.paged and (host_pages or session_kv):
            self.store = HostPageStore(
                host_pages or max(4 * self.pool.capacity, 256),
                faults=fault_plan)
        self._restores: dict[int, dict] = {}    # slot -> restore in flight
        self.tier_log: list[dict] = []          # each spill's and restore's
        #                                         bytes and times
        # prefix sharing: suffix-only prefill is a resumed chunked prefill,
        # and the pages to share live in the pool
        self.prefix_index = None
        if prefix_share:
            if not (self.paged and self.chunk_tokens):
                raise ValueError("prefix_share needs hx.paged_kv and "
                                 "chunk_tokens (suffix-only prefill rides "
                                 "the chunked-prefill q_offset contract)")
            self.prefix_index = PrefixIndex(self.block_s, self.pool,
                                            store=self.store)
        self._prefix_admits = 0
        self._prefix_hits = 0
        self.grouped_steps = 0          # decode steps with a group formed
        governor = (GovernorConfig(ttl_target_s=slo_ttl_s)
                    if slo_ttl_s is not None else None)
        self.governor = (TTLGovernor(governor, max_batch)
                         if governor is not None else None)
        self.sched = Scheduler(max_batch=max_batch, cap=self.cap,
                               policy=sched_policy, pool=self.pool,
                               max_pages=self.max_pages,
                               prefix_index=self.prefix_index,
                               tenants=tenants,
                               slo_aware=(True if (tenants or governor)
                                          else None))
        self.metrics = EngineMetrics(
            clock=clock,
            ttl_target_s=governor.ttl_target_s if governor else None)
        self._admission_retired: list[Request] = []
        self.decode_syncs = 0           # decode steps or windows (one
        #                                 transfer each)
        self.decoded_tokens = 0         # tokens the decode loop emitted
        self.prefill_calls = 0          # one-shot prefills and chunk calls
        self.decode_wall_s = 0.0        # host wall of the decode phases
        self.graph_setup_s = 0.0        # warm-up windows and captures
        self._device_ms = [0.0, 0]      # summed stream ms of the steps or
        #                                 windows (CUDA events), and count

    # ------------------------------------------------------------- requests
    def submit(self, req: Request) -> None:
        """Queue ``req``; ``step()`` admits it when a slot frees up."""
        self._check_sampling(req)
        self.metrics.on_submit(req.rid, tenant=req.tenant,
                               slo_class=req.slo_class)
        self.sched.submit(req)

    def _check_sampling(self, req: Request) -> None:
        if req.sampling is not None and self.sampling is None:
            raise ValueError("request carries SamplingParams but the "
                             "engine was built without sampling= (the "
                             "decode state has no sampling leaves)")

    def pending(self) -> bool:
        """True while any request is queued, holds a slot, or retired at
        admission and not yet returned by ``step()``."""
        return (bool(self.sched.queue) or any(self.slots)
                or bool(self._admission_retired))

    def add_request(self, req: Request) -> bool:
        """Immediate admission past the queue: a one-shot prefill of
        ``req`` into a free slot now; False when none is free (nothing is
        queued).  A request that can never fit is taken (True) and retired
        "rejected"; like a first token that retires it, the next
        ``step()`` returns it."""
        self._check_sampling(req)
        if req.rid not in self.metrics.requests:
            self.metrics.on_submit(req.rid, tenant=req.tenant,
                                   slo_class=req.slo_class)
        slot = self.sched.assign_direct(req)
        if slot is None:
            if self.sched.rejected and self.sched.rejected[-1] is req:
                self.sched.rejected.pop()
                self.metrics.on_finish(req.rid, "rejected")
                self._admission_retired.append(req)
                return True
            return False
        self.metrics.on_admit(req.rid)
        self.slots[slot] = req
        first = int(self._oneshot_prefill(req, slot))
        self._admission_retired += self._commit_first_token(req, slot, first)
        return True

    def preempt(self, rid: int) -> bool:
        """Take ``rid``'s slot mid-flight and requeue it at the queue front.
        With a host tier (``host_pages``) a decoding request's pool pages
        are spilled first, so its resume restores them with no prefill
        chunk; without one, or when the store refuses them, the pages are
        dropped and the resume re-prefills the prompt and the tokens so
        far.  A restore still in flight is cancelled (its store entry
        stays, so the resume tries again).  False when ``rid`` holds no
        slot."""
        for slot, req in enumerate(self.slots):
            if req is None or req.rid != rid:
                continue
            spilled = False
            if slot in self._restores:
                self._restores.pop(slot)
            elif (req.state == DECODE and self.spill_enabled
                    and self.store is not None):
                spilled = self._spill(req, slot)
            req.buffers = None
            req.prefill_pos = 0
            req.prefill_tokens = None
            req.forced_tokens = None
            self.slots[slot] = None
            self.state["total_len"][slot] = 0
            if self.paged:
                # the pages go back to the pool; park the row on the sink
                self.state["block_tables"][slot] = 0
            self.sched.preempt(slot, req)
            self.metrics.on_preempt(rid, spilled=spilled)
            return True
        return False

    def _save_pages(self, req: Request, slot: int, key: str,
                    kind: str) -> bool | None:
        """Put ``req``'s committed pool pages into the store under ``key``,
        as exact bytes (int8 payloads and scale planes included): one
        gather per plane, one device->host copy each and ONE
        synchronisation before the host copy is read.  Logs the bytes and
        times in ``tier_log``.  None when nothing is committed, else
        whether the store took them."""
        committed = self.sched.slot_len[slot]
        phys = self.pool.pages(req.rid)[:self.pool.pages_for(committed)]
        if committed <= 0 or not phys:
            return None
        t0 = time.perf_counter()
        ev = self._event()
        planes = gather_pool_pages(self.state, phys)
        mid = self._event()
        if self.device.type == "cuda":
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in planes.items()}
            for k, v in planes.items():
                host[k].copy_(v, non_blocking=True)
        else:
            host = planes
        end = self._event()
        if end is not None:
            end.synchronize()               # the one sync of the spill
        t1 = time.perf_counter()
        ok = self.store.put(key, host_planes(host),
                            tokens=req.resume_tokens()[:committed])
        t2 = time.perf_counter()
        self.tier_log.append({
            "kind": kind, "rid": req.rid, "ok": ok, "pages": len(phys),
            "tokens": committed,
            "bytes": sum(v.numel() * v.element_size()
                         for v in planes.values()),
            "gather_ms": ev.elapsed_time(mid) if ev else None,
            "d2h_ms": mid.elapsed_time(end) if ev else None,
            "host_wait_ms": (t1 - t0) * 1e3, "put_ms": (t2 - t1) * 1e3})
        return ok

    def _spill(self, req: Request, slot: int) -> bool:
        """Spill ``req``'s pages before the pool takes them back
        (``_save_pages`` under ``spill:<rid>``); True when the store took
        them."""
        ok = bool(self._save_pages(req, slot, f"spill:{req.rid}", "spill"))
        req.spill_key = f"spill:{req.rid}" if ok else None
        req.spill_len = self.sched.slot_len[slot] if ok else 0
        if ok:
            self.metrics.bump("spills")
        self._sync_store_counters()
        return ok

    def step(self) -> list[Request]:
        """Restores due this step, admission, at most one prefill chunk,
        one decode step (or one window of ``decode_window`` steps), then
        the TTL governor's decision; returns the requests retired."""
        self._tick(steps=1)
        self._advance_restores()
        finished = self._admission_retired + self._admit()
        self._admission_retired = []
        finished += self._prefill_chunk()
        if self.decode_window > 1:
            finished += self._decode_window()
        else:
            finished += self._decode_step()
        self._govern()
        return finished

    def run_to_completion(self, max_steps: int = 10_000) -> None:
        """Step until the queue and the slots drain (or ``max_steps``)."""
        for _ in range(max_steps):
            if not self.pending():
                return
            self.step()

    def _tick(self, **work) -> None:
        """Advance a ``VirtualClock`` by one tranche of modelled work (the
        step's base cost, then each phase's slots or prompt tokens as it
        runs); nothing on a wall clock."""
        if isinstance(self.metrics.clock, VirtualClock):
            self.metrics.clock.advance(**work)

    def _govern(self) -> None:
        """One TTL-governor decision: the decoding batch requests, youngest
        first; a shed goes through ``preempt``, the spill."""
        if self.governor is None:
            return
        batch = sorted(((r.admit_seq, r.rid) for r in self.slots
                        if r is not None and r.state == DECODE
                        and r.slo_class == SLO_BATCH), reverse=True)
        rid = self.governor.step(self.metrics, self.sched,
                                 [b[1] for b in batch])
        if rid is not None:
            self.preempt(rid)
        self.metrics.set_counter("governor_sheds", self.governor.sheds)
        self.metrics.set_counter("governor_cap_raises",
                                 self.governor.cap_raises)

    # -------------------------------------------------------------- phases
    def _admit(self) -> list[Request]:
        retired = []
        deferred: list[tuple[Request, int, Any]] = []
        for req, slot in self.sched.admit():
            self.metrics.on_admit(req.rid)
            self.slots[slot] = req
            if self._try_restore(req, slot):
                continue
            if not self.chunk_tokens:
                deferred.append((req, slot, self._oneshot_prefill(req, slot)))
                continue
            req.prefill_tokens = req.resume_tokens()
            req.prefill_pos = 0
            req.buffers = init_prefill_buffers(
                self.cfg, 1, len(req.prefill_tokens), dtype=self.dtype,
                device=self.device)
            if self.prefix_index is not None:
                self._prefix_admits += 1
                if req.shared_len and req.shared_kv is not None:
                    self._prefix_hits += 1
                    self._restore_prefix(req)
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

    def _restore_candidate(self, req: Request) -> tuple[str | None, int]:
        """The store entry that can resume ``req`` without a prefill, and
        the committed tokens it covers: its own spill first, else (session
        KV) its session's entry when the stored tokens begin its prompt.
        The restored span leaves at least one token to decode (the engine
        decodes ``resume[m]`` next and teacher-forces the rest), and a
        longer prefix-share match wins over a session."""
        resume = req.resume_tokens()
        if req.spill_key is not None:
            toks = self.store.tokens(req.spill_key)
            m = 0 if toks is None else len(toks)
            if 0 < m < len(resume) and tuple(resume[:m]) == toks:
                return req.spill_key, m
        if self.session_kv and req.session_id is not None:
            key = f"session:{req.session_id}"
            toks = self.store.tokens(key)
            if toks:
                m = min(len(toks), len(resume) - 1)
                if (m > 0 and tuple(resume[:m]) == toks[:m]
                        and m > req.shared_len):
                    return key, m
        return None, 0

    def _try_restore(self, req: Request, slot: int) -> bool:
        """The resume without prefill, at admission: on a store hit ``req``
        enters RESTORING and a restore job is queued, committed this step
        or, under an injected delay, that many steps later while the other
        slots go on.  Any failure (no entry, an injected loss, a checksum
        or generation mismatch) returns False, and the caller re-prefills:
        counted, never divergent."""
        if self.store is None:
            return False
        key, committed = self._restore_candidate(req)
        if key is None:
            return False
        t0 = time.perf_counter()
        planes, delay, why = self.store.restore(key)
        verify_ms = (time.perf_counter() - t0) * 1e3
        self._sync_store_counters()
        if planes is None:
            if why != "missing":
                self.metrics.bump("restores_failed")
            req.resume_fallback = True       # this admission re-prefills
            if req.spill_key == key:
                req.spill_key = None         # do not retry a dead entry
                req.spill_len = 0
            return False
        req.state = RESTORING
        req.prefill_tokens = None
        req.buffers = None
        self._restores[slot] = {"req": req, "planes": planes,
                                "remaining": delay, "committed": committed,
                                "t0": self.metrics.clock(), "key": key,
                                "verify_ms": verify_ms}
        if delay == 0:
            self._commit_restore(slot)
        return True

    def _advance_restores(self) -> None:
        """Tick the delayed restores by one step, committing those due.
        Runs before admission, so a delay of d holds its slot for exactly
        d steps while every other slot prefills and decodes."""
        for slot in list(self._restores):
            job = self._restores[slot]
            job["remaining"] -= 1
            if job["remaining"] <= 0:
                self._commit_restore(slot)

    def _commit_restore(self, slot: int) -> None:
        """Land a restore: one host->device copy per plane, scattered in
        place into the pages granted at re-admission (past any leading
        pages shared with a prefix, which hold the same bytes), the
        block-table row, the committed length, and DECODE with the known
        tokens past the span to teacher-force; no prefill chunk."""
        job = self._restores.pop(slot)
        req: Request = job["req"]
        committed: int = job["committed"]
        n = self.pool.pages_for(committed)
        phys = self.pool.pages(req.rid)[:n]
        s0 = min(req.shared_pages, n)
        t0 = time.perf_counter()
        ev = mid = end = None
        if s0 < n:
            planes = device_planes(
                {k: v[:, s0:n] for k, v in job["planes"].items()},
                {k: self.state[k].dtype for k in job["planes"]})
            ev = self._event()
            if self.device.type == "cuda":
                planes = {k: v.pin_memory().to(self.device, non_blocking=True)
                          for k, v in planes.items()}
            mid = self._event()
            scatter_pool_pages(self.state, phys[s0:n], planes)
            end = self._event()
        self._mirror_table(slot)
        self.state["total_len"][slot] = committed
        self.sched.slot_len[slot] = committed
        resume = req.resume_tokens()
        self.cur_tokens[slot] = int(resume[committed])
        req.forced_tokens = list(resume[committed + 1:])
        req.shared_kv = None
        req.state = DECODE
        self._install_sampling(req, slot)
        if req.spill_key is not None:
            # one use: the entry is stale once decoding goes on
            self.store.drop(req.spill_key)
            req.spill_key = None
            req.spill_len = 0
        if end is not None:
            end.synchronize()
        self.tier_log.append({
            "kind": "restore", "rid": req.rid, "key": job["key"],
            "pages": n - s0, "tokens": committed,
            "bytes": sum(v[:, s0:n].nbytes for v in job["planes"].values()),
            "verify_ms": job["verify_ms"],
            "h2d_ms": ev.elapsed_time(mid) if ev else None,
            "scatter_ms": mid.elapsed_time(end) if ev else None,
            "host_ms": (time.perf_counter() - t0) * 1e3})
        self.metrics.bump("restores")
        self.metrics.on_restore(req.rid, self.metrics.clock() - job["t0"])
        self._sync_store_counters()

    def _sync_store_counters(self) -> None:
        """Mirror the store's monotonic fault counters into the metrics."""
        self.metrics.set_counter("checksum_mismatches",
                                 self.store.checksum_mismatches
                                 + self.store.stale_generations)
        self.metrics.set_counter("store_evictions", self.store.evictions)

    def _is_resume(self, req: Request) -> bool:
        """Whether this request's prefill recomputes context the host tier
        could have restored: it was preempted before, or a restore failed
        at this admission."""
        m = self.metrics.requests.get(req.rid)
        return bool((m is not None and m.n_preempts > 0)
                    or req.resume_fallback)

    def _restore_prefix(self, req: Request) -> None:
        """Install the prefix index's host fp K/V of the matched prefix into
        ``req``'s fresh carry buffers and fast-forward its prefill to the
        suffix: the rows are the registrant's own prefill output for the
        same tokens, what re-prefilling them would write."""
        m = req.shared_len
        for key, host in zip(("kcache", "vcache"), req.shared_kv):
            buf = req.buffers[key]
            buf[:, 0, :m] = host[:, :m].to(device=buf.device, dtype=buf.dtype)
        req.shared_kv = None
        req.prefill_pos = m

    def _register_prefix(self, req: Request, t: int) -> None:
        """Publish a finished prefill to the prefix index: its tokens, its
        page list and a host copy of its carry-buffer K/V, taken before any
        int8 quantization (so a later hit restores fp rows and stays exact
        on int8 engines too)."""
        kv = tuple(req.buffers[key][:, 0, :t].cpu()
                   for key in ("kcache", "vcache"))
        self.prefix_index.register(list(req.prefill_tokens),
                                   list(self.pool.pages(req.rid)), kv)

    def _prefill_chunk(self) -> list[Request]:
        """Advance ONE packed group of chunked prefills by one chunk.

        Ragged packing: prefills at different offsets pack into one chunk
        call (per-row ``q_offset``; each writes its chunk at its own buffer
        offset; buffers zero-padded to the group's longest prompt, whose pad
        rows every causal query masks).  The shared dimension is the chunk
        width ``c``, so the group is every prefill whose next chunk is as
        wide as the oldest prefill's (by ``admit_seq``).  One batched
        transfer fetches the first tokens of the prefills this chunk
        finishes."""
        pre = [(slot, r) for slot, r in enumerate(self.slots)
               if r is not None and r.state == PREFILL
               and r.prefill_tokens is not None]
        if not pre:
            return []

        def width(r: Request) -> int:
            return min(self.chunk_tokens, len(r.prefill_tokens) - r.prefill_pos)

        c = width(min(pre, key=lambda sr: sr[1].admit_seq)[1])
        group = [(s, r) for s, r in pre if width(r) == c]
        self._tick(prefill_tokens=c * len(group))
        for _, r in group:
            if self._is_resume(r):
                # a chunk that reruns known context: none on the host
                # tier's good path, counted on every fallback
                self.metrics.bump("resume_reprefill_chunks")
        tokens = torch.tensor([r.prefill_tokens[r.prefill_pos:r.prefill_pos + c]
                               for _, r in group], dtype=torch.int64,
                              device=self.device)
        tmax = max(len(r.prefill_tokens) for _, r in group)
        if len(group) == 1:
            bufs = group[0][1].buffers
        else:
            bufs = {key: torch.cat([torch.nn.functional.pad(
                r.buffers[key], (0, 0, 0, 0, 0, tmax - r.buffers[key].shape[2]))
                for _, r in group], dim=1) for key in ("kcache", "vcache")}
        offs = torch.tensor([r.prefill_pos for _, r in group],
                            dtype=torch.int32, device=self.device)
        if self.sampling is not None:
            next_toks, last_logits, bufs = self.chunk_step(self.model, tokens,
                                                           bufs, offs)
        else:
            next_toks, bufs = self.chunk_step(self.model, tokens, bufs, offs)
        self.prefill_calls += 1
        done = [i for i, (_, r) in enumerate(group)
                if r.prefill_pos + c >= len(r.prefill_tokens)]
        first = {}
        if done:
            di = torch.tensor(done, device=self.device)
            if self.sampling is not None:
                vals = self._first_token_dev(last_logits[di],
                                             [group[i][1] for i in done])
            else:
                vals = next_toks[di, c - 1]
            # one transfer for every prefill this chunk finishes
            first = dict(zip(done, vals.tolist()))
        finished = []
        for i, (slot, req) in enumerate(group):
            t_i = len(req.prefill_tokens)
            req.buffers = {key: b[:, i:i + 1, :t_i].contiguous()
                           for key, b in bufs.items()}
            req.prefill_pos += c
            if i in first:
                finished += self._finish_prefill(req, slot, int(first[i]))
        return finished

    def _finish_prefill(self, req: Request, slot: int,
                        first_token: int) -> list[Request]:
        """Chunked prefill complete: the carry buffers go to the decode slot
        through the one-shot path's handoff, then the first token."""
        t = len(req.prefill_tokens)
        pstate = finalize_chunked_prefill(self.cfg, self.hx, req.buffers, t)
        if self.prefix_index is not None:
            self._register_prefix(req, t)
        req.buffers = None
        req.prefill_tokens = None
        self._scatter_state(pstate, slot, t, req)
        return self._commit_first_token(req, slot, first_token)

    def _oneshot_prefill(self, req: Request, slot: int):
        """Prefill ``req`` into ``slot``; returns its first token (device)."""
        toks_list = req.resume_tokens()
        if self._is_resume(req):
            # the whole one-shot prefill is one chunk of redone work
            self.metrics.bump("resume_reprefill_chunks")
        toks = torch.tensor([toks_list], dtype=torch.int64, device=self.device)
        last_logits, pstate = self.prefill_step(self.model, {"tokens": toks})
        self.prefill_calls += 1
        self._scatter_state(pstate, slot, len(toks_list), req)
        return self._first_token_dev(last_logits, [req])[0]

    def _first_token_dev(self, last_logits, reqs: list[Request]):
        """First tokens of freshly prefilled rows, on the device:
        ``last_logits`` [G, Vp] (vocab-masked), one row per request.
        Greedy engines take the argmax; sampling engines the sampler at
        ``sample_idx = 0``, the first point of each request's stream, so a
        token sampled here equals a decode step's sample of the same
        position."""
        if self.sampling is None:
            return torch.argmax(last_logits[:, :self.cfg.vocab],
                                dim=-1).to(torch.int32)
        pols = [r.sampling or self.sampling for r in reqs]
        rows = [p.row() for p in pols]
        dev = self.device
        return sample_tokens(
            last_logits,
            torch.tensor([v[0] for v in rows], dtype=torch.float32,
                         device=dev),
            torch.tensor([v[1] for v in rows], dtype=torch.int32, device=dev),
            torch.tensor([v[2] for v in rows], dtype=torch.float32,
                         device=dev),
            torch.tensor([request_seed(p.seed, r.rid)
                          for p, r in zip(pols, reqs)], dtype=torch.int64,
                         device=dev),
            torch.zeros(len(reqs), dtype=torch.int32, device=dev))

    def _install_sampling(self, req: Request, slot: int) -> None:
        """Install ``req``'s policy into ``slot``'s sampler leaves.
        ``sample_idx`` resumes at ``len(out_tokens)``, the tokens already
        sampled, so the request continues its stream where it left it."""
        if self.sampling is None:
            return
        sp = req.sampling or self.sampling
        t, k, p = sp.row()
        st = self.state
        st["sample_temp"][slot] = t
        st["sample_topk"][slot] = k
        st["sample_topp"][slot] = p
        st["sample_seed"][slot] = request_seed(sp.seed, req.rid)
        st["sample_idx"][slot] = len(req.out_tokens)

    def _scatter_state(self, pstate: dict, slot: int, t: int,
                       req: Request) -> None:
        """Copy a single-request prefill state into ``slot``: the common
        round-robin prefix of every rank's local slots (the two capacities
        may differ; layouts match).  int8 engines copy the fp cache into a
        zero f32 slot row first and quantize that whole row
        (``quantize_decode_state``), as the reference does.  Paged engines
        write the cache's pages into the pages granted at admission
        (``_scatter_paged``).  SSM leaves are copied into the slot's row."""
        if self.paged:
            self._scatter_paged(pstate, slot, req)
        elif self.kv8 and "kcache" in pstate:
            row = {}
            for key in ("kcache", "vcache"):
                dst = self.state[key][:, slot]
                row[key] = torch.zeros(dst.shape, dtype=torch.float32,
                                       device=dst.device)
                _copy_rr(pstate[key][:, 0], row[key], self.shards)
            q = quantize_decode_state(row)
            for key in ("kcache", "vcache", "kscale", "vscale"):
                self.state[key][:, slot] = q[key]
        elif "kcache" in pstate:
            for key in ("kcache", "vcache"):
                _copy_rr(pstate[key][:, 0], self.state[key][:, slot],
                         self.shards)
        for key in ("ssm_conv", "ssm_state"):
            if key in pstate:
                self.state[key][:, slot] = pstate[key][:, 0]
        self.state["total_len"][slot] = t

    def _scatter_paged(self, pstate: dict, slot: int, req: Request) -> None:
        """Paged half of ``_scatter_state``: the prefill cache split into
        pages (``cache_to_pages``), written at the physical pages the
        allocator granted; int8 engines quantize those pages with the decode
        append's formula.  Granted pages beyond the prefill extent keep
        stale rows at positions >= t, which every backend masks.  Shared
        leading pages are skipped: they already hold the registrant's rows,
        the same bytes for the same tokens, and other requests may map
        them."""
        phys = self.pool.pages(req.rid)
        pages = {key: cache_to_pages(pstate[key][:, 0], self.kvp,
                                     self.block_s)
                 for key in ("kcache", "vcache")}
        n = min(pages["kcache"].shape[1], len(phys))
        s0 = min(req.shared_pages, n)
        idx = torch.tensor(phys[s0:n], dtype=torch.int64, device=self.device)
        if self.kv8:
            pages = quantize_decode_state({k: v[:, s0:n].float()
                                           for k, v in pages.items()})
            for key in ("kcache", "vcache", "kscale", "vscale"):
                self.state[key][:, idx] = pages[key]
        else:
            for key in ("kcache", "vcache"):
                self.state[key][:, idx] = pages[key][:, s0:n].to(
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
        self._install_sampling(req, slot)
        self.metrics.on_token(req.rid)
        self.sched.record_served(slot)
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

    def _cow_guard(self, active: list[int]) -> None:
        """Make every slot's append-target page exclusive before the decode
        step writes it (copy-on-write).  Admission already made a shared
        partial page exclusive, so a shared target here means a request
        whose committed length ends exactly on the shared-prefix boundary:
        its next page is copied here, before the kernel's append."""
        keys = ("kcache", "vcache") + (("kscale", "vscale") if self.kv8
                                       else ())
        for i in active:
            req = self.slots[i]
            li = self.sched.slot_len[i] // self.block_s
            phys = self.pool.pages(req.rid)
            if li >= len(phys) or self.pool.refcount(phys[li]) == 1:
                continue
            res = self.pool.cow(req.rid, li)
            if res is None:
                raise AssertionError("copy-on-write with an empty free list: "
                                     "admission must pre-charge the "
                                     "divergent page")
            old, new = res
            for key in keys:
                self.state[key][:, new] = self.state[key][:, old]
            self._mirror_table(i)

    def _set_groups(self, active: list[int]) -> None:
        """Refresh the grouped decode's ``group_id``/``group_np`` leaves.

        Slots whose tables start on the same physical page form a group;
        ``group_np`` is the longest run of identical leading pages common
        to every member, capped at each member's full committed pages so
        the fused append (page ``slot_len // block_s``) always lands above
        it.  Every member gets the same ``group_np`` and the lowest member
        row as ``group_id``; singletons and idle rows keep their own row
        with ``group_np = 0``, which decodes as ungrouped."""
        gid = list(range(self.max_batch))
        gnp = [0] * self.max_batch
        buckets: dict[int, list[int]] = {}
        for i in active:
            pages = self.pool.pages(self.slots[i].rid)
            if pages and pages[0] != 0:
                buckets.setdefault(pages[0], []).append(i)
        for members in buckets.values():
            if len(members) < 2:
                continue
            lists = [self.pool.pages(self.slots[i].rid) for i in members]
            depth = min(min(len(pl) for pl in lists),
                        min(self.sched.slot_len[i] // self.block_s
                            for i in members))
            lcp = 0
            while lcp < depth and all(pl[lcp] == lists[0][lcp]
                                      for pl in lists):
                lcp += 1
            if lcp == 0:
                continue
            for i in members:
                gid[i] = min(members)
                gnp[i] = lcp
        self.grouped_steps += any(gnp)
        self.state["group_id"] = torch.tensor(gid, dtype=torch.int32,
                                              device=self.device)
        self.state["group_np"] = torch.tensor(gnp, dtype=torch.int32,
                                              device=self.device)

    def _decode_step(self) -> list[Request]:
        """One decode step for every DECODE slot; returns retirements."""
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and r.state == DECODE]
        if not active:
            return []
        self._tick(decode_slots=len(active))
        t0 = time.perf_counter()
        if self.prefix_index is not None:
            self._cow_guard(active)
        if self.grouped:
            self._set_groups(active)
        ev = self._event()
        next_tokens, self.state = self.serve_step(
            self.model, self.state, self.cur_tokens)
        ev = self._close_event(ev)
        self.cur_tokens = next_tokens
        # serve_step advances total_len for every row; idle and prefilling
        # slots go back to 0 so their rows stay O(1) work (a prefill's K/V
        # is still in its carry buffers; its finalize installs the length)
        idle = [i for i in range(self.max_batch) if i not in active]
        if idle:
            self.state["total_len"][idle] = 0
        toks = next_tokens.tolist()          # one device->host transfer
        self.decode_syncs += 1
        self._add_device_time(ev)
        finished = []
        forced: list[tuple[int, int]] = []
        for i in active:
            req = self.slots[i]
            if req.forced_tokens:
                # catch-up after a restore: this step appended the K/V of
                # the current known token, and the next known one replaces
                # the sample.  Nothing is emitted; the length advances.
                forced.append((i, req.forced_tokens.pop(0)))
                self.sched.on_token(i)
                r = self._grow_or_retire(req, i)
                if r is not None:
                    finished.append(r)
                continue
            tok = int(toks[i])
            req.out_tokens.append(tok)
            self.sched.on_token(i)
            self.sched.record_served(i)
            self.metrics.on_token(req.rid)
            self.decoded_tokens += 1
            if req.eos_id is not None and tok == req.eos_id:
                finished.append(self._retire(req, i, "eos"))
            elif len(req.out_tokens) >= req.max_new_tokens:
                finished.append(self._retire(req, i, "max_tokens"))
            else:
                r = self._grow_or_retire(req, i)
                if r is not None:
                    finished.append(r)
        if forced:
            idx = torch.tensor([i for i, _ in forced], device=self.device)
            self.cur_tokens[idx] = torch.tensor(
                [t for _, t in forced], dtype=self.cur_tokens.dtype,
                device=self.device)
            if self.sampling is not None:
                # a forced step sampled nothing: rewind the counter the
                # step advanced, so the stream rejoins where it left off
                self.state["sample_idx"][idx] -= 1
        if self.paged:
            self._sample_pool()
        self.decode_wall_s += time.perf_counter() - t0
        return finished

    def _decode_window(self) -> list[Request]:
        """Up to ``decode_window`` decode steps for every DECODE slot in
        one call (the reference's ``_decode_window``).

        Each slot's budget for the window is reserved first
        (``Scheduler.grow_for_window``: one extend, nothing allocates
        mid-window); the window runs with per-row budget and EOS masks (one
        CUDA graph replay on the card), and the host reads the [B, N] token
        block in ONE transfer.  It then replays the block j-major, in the
        single-step engine's order of scheduler, metrics and retirement
        events, each token stamped with a time interpolated over the
        measured window; rows that froze mid-window retire at the boundary,
        and a grant below what the row wanted that EOS / max-tokens did not
        use up retires it with "capacity", where the single-step engine
        would."""
        n = self.decode_window
        active = [i for i, r in enumerate(self.slots)
                  if r is not None and r.state == DECODE]
        if not active:
            return []
        t_host = time.perf_counter()
        finished = []
        b = self.max_batch
        # one host array, one host->device copy: budgets, EOS ids, forced
        # counts, then the [B, N] forced tokens (a restore's catch-up)
        ctl = np.zeros((b, 3 + n), np.int32)
        ctl[:, 1] = -1
        wants = [0] * b
        stepping = []
        for i in active:
            req = self.slots[i]
            nf = min(len(req.forced_tokens or ()), n)
            want = min(n, nf + max(req.max_new_tokens - len(req.out_tokens),
                                   0))
            grant = self.sched.grow_for_window(i, want)
            if self.paged and grant:
                self._mirror_table(i)
            if grant == 0:
                # not one step: where grow_for_next_token would retire it
                finished.append(self._retire(req, i, "capacity"))
                continue
            ctl[i, 0], wants[i] = grant, want
            if req.eos_id is not None:
                ctl[i, 1] = req.eos_id
            if nf:
                ctl[i, 2] = nf
                ctl[i, 3:3 + nf] = req.forced_tokens[:nf]
            stepping.append(i)
        if not stepping:
            self.decode_wall_s += time.perf_counter() - t_host
            return finished
        if self.prefix_index is not None:
            self._cow_guard(stepping)
        ctl_dev = torch.from_numpy(ctl).to(self.device)
        args = (self.cur_tokens, ctl_dev[:, 0], ctl_dev[:, 1],
                ctl_dev[:, 3:], ctl_dev[:, 2])
        t_prep = time.perf_counter()
        self.window_runner.prepare(self.model, self.state, *args)
        self.graph_setup_s += time.perf_counter() - t_prep
        t_host += time.perf_counter() - t_prep
        t0 = self.metrics.clock()
        ev = self._event()
        out_block, cur, self.state = self.window_runner(self.model,
                                                        self.state, *args)
        ev = self._close_event(ev)
        self.cur_tokens = cur
        if self.paged:
            self._sample_pool()
        toks = out_block.tolist()            # one device->host transfer
        self.decode_syncs += 1
        self._add_device_time(ev)
        t1 = self.metrics.clock()
        budgets = ctl[:, 0]
        nsteps = int(max(budgets[i] for i in stepping))
        virtual = isinstance(self.metrics.clock, VirtualClock)
        retired: set[int] = set()
        for j in range(nsteps):
            rows = [i for i in stepping if i not in retired and budgets[i] > j]
            if not rows:
                break
            at = None
            if virtual:
                # the cost model ticks once per replayed step
                self._tick(decode_slots=len(rows))
            else:
                at = t0 + (t1 - t0) * (j + 1) / nsteps
            for i in rows:
                req = self.slots[i]
                if req.forced_tokens:
                    # the window fed the known token instead of a sample
                    # (and emitted the pad): only the length advances
                    req.forced_tokens.pop(0)
                    self.sched.on_token(i)
                    continue
                tok = toks[i][j]
                req.out_tokens.append(tok)
                self.sched.on_token(i)
                self.sched.record_served(i)
                self.metrics.on_token(req.rid, at=at)
                self.decoded_tokens += 1
                if req.eos_id is not None and tok == req.eos_id:
                    finished.append(self._retire(req, i, "eos"))
                    retired.add(i)
                elif len(req.out_tokens) >= req.max_new_tokens:
                    finished.append(self._retire(req, i, "max_tokens"))
                    retired.add(i)
        for i in stepping:
            if i not in retired and budgets[i] < wants[i]:
                finished.append(self._retire(self.slots[i], i, "capacity"))
        self.decode_wall_s += time.perf_counter() - t_host
        return finished

    def _event(self):
        """A CUDA event recorded before a step's or window's device work
        (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _close_event(self, ev):
        """The pair of ``ev`` and an event recorded after the work."""
        if ev is None:
            return None
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        return ev, end

    def _add_device_time(self, pair) -> None:
        """Add a closed pair's time, once the host has synced past it."""
        if pair is not None:
            self._device_ms[0] += pair[0].elapsed_time(pair[1])
            self._device_ms[1] += 1

    def sync_stats(self) -> dict[str, Any]:
        """Host syncs of the decode loop: blocking device->host transfers
        per decoded token (one per step or window, over the tokens of all
        its rows); the host wall of the decode phases per decoded token;
        on the card the mean stream time of a step or window between CUDA
        events (``decode_device_ms``); the windows captured as CUDA graphs,
        each after one warm-up window (``graph_setup_s``, not in the decode
        wall)."""
        total, n = self._device_ms
        runner = self.window_runner
        return {"decode_window": self.decode_window,
                "decode_syncs": self.decode_syncs,
                "decoded_tokens": self.decoded_tokens,
                "syncs_per_token":
                    self.decode_syncs / max(self.decoded_tokens, 1),
                "decode_host_ms_per_token":
                    self.decode_wall_s * 1e3 / max(self.decoded_tokens, 1),
                "decode_device_ms": total / n if n else None,
                "graph_captures": runner.captures if runner else 0,
                "graph_setup_s": self.graph_setup_s,
                "graph_replays": runner.replays if runner else 0}

    def tier_stats(self) -> dict:
        """The host store's occupancy and save/restore/fault counters
        (``HostPageStore.stats``); zeros without a store."""
        if self.store is None:
            return {k: 0 for k in (
                "host_pages_capacity", "host_pages_used", "host_entries",
                "host_saves", "host_restores", "restores_failed",
                "checksum_mismatches", "stale_generations",
                "store_evictions", "store_full")}
        return self.store.stats()

    def _retire(self, req: Request, slot: int, reason: str) -> Request:
        req.done = True
        req.state = DONE
        req.finish_reason = reason
        # session KV: keep the committed pages under the session id before
        # the pool takes them back, for the next turn to restore
        if (self.session_kv and req.session_id is not None
                and self.store is not None
                and reason in ("eos", "max_tokens")):
            self._save_session(req, slot)
        if req.spill_key is not None:
            # a retired request never resumes
            self.store.drop(req.spill_key)
            req.spill_key = None
            req.spill_len = 0
        self.slots[slot] = None
        self.sched.release(slot)
        self.state["total_len"][slot] = 0
        if self.paged:
            # park the row on the sink page: its next idle append lands
            # there, not in a page the pool may hand to another request
            self.state["block_tables"][slot] = 0
        self.metrics.on_finish(req.rid, reason)
        return req

    def _save_session(self, req: Request, slot: int) -> None:
        """Keep a retiring request's committed pages under
        ``session:<id>`` (``_save_pages``).  The stored tokens, prompt and
        all outputs but the last, are a proper prefix of the next turn's
        prompt, so the restore's check is a prefix match."""
        if self._save_pages(req, slot, f"session:{req.session_id}",
                            "session"):
            self.metrics.bump("spills")
        self._sync_store_counters()

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
        the retirements with ``finish_reason="capacity"``, the prefix
        sharing pair ``prefix_hit_rate`` (share of chunked admissions that
        restored a matched prefix) and ``pages_shared_peak`` (peak pages
        mapped by more than one request), and (port only) ``pool_waits``,
        the requests the pool made wait at least once, and
        ``grouped_steps``, the decode steps in which a group shared pages.
        Fixed-layout engines report zeros for the pool fields."""
        cap_retired = sum(1 for m in self.metrics.requests.values()
                          if m.finish_reason == "capacity")
        if not self.paged:
            return {"paged_kv": False, "pool_occupancy_peak": 0.0,
                    "pool_frag_mean": 0.0, "capacity_retired": cap_retired,
                    "prefix_hit_rate": 0.0, "pages_shared_peak": 0,
                    "store_evictions": 0, "pool_waits": 0,
                    "grouped_steps": 0}
        frag = (sum(self._frag_samples) / len(self._frag_samples)
                if self._frag_samples else 0.0)
        return {"paged_kv": True,
                "pool_occupancy_peak":
                    self.pool.peak_in_use / max(self.pool.capacity, 1),
                "pool_frag_mean": frag, "capacity_retired": cap_retired,
                "prefix_hit_rate":
                    self._prefix_hits / max(self._prefix_admits, 1),
                "pages_shared_peak": self.pool.pages_shared_peak,
                "store_evictions":
                    self.store.evictions if self.store is not None else 0,
                "pool_waits": self.sched.pool_waits,
                "grouped_steps": self.grouped_steps}


def _copy_rr(src, dst, kvp: int) -> None:
    """Copy a round-robin cache [L, Kh, S_src, hsz] into ``dst`` [L, Kh,
    S_dst, hsz] in place: rank r's local slots [0, min(S_src, S_dst)/kvp)
    land at the same local slots of ``dst``."""
    ls, ld = src.shape[-2] // kvp, dst.shape[-2] // kvp
    n = min(ls, ld)
    srcr = src.reshape(*src.shape[:-2], kvp, ls, src.shape[-1])
    dstr = dst.view(*dst.shape[:-2], kvp, ld, dst.shape[-1])
    dstr[..., :n, :] = srcr[..., :n, :]
