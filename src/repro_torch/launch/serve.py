"""Serving driver of the port: continuous-batching decode with the Helix
engine on one card (counterpart of the reference's ``launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
      --requests 8 --prompt-len 512 --max-new 32 --max-batch 4 \
      --dtype bfloat16 --metrics

Runs on ``cuda`` unless ``--device cpu`` is given (the kernels' plain
PyTorch versions then run).  The flags: one-shot or chunked prefill
(``--chunk-tokens N``), FCFS/SJF admission, the fixed or the paged KV
layout (``--paged-kv [--pool-blocks N]``), prefix sharing and grouped
shared-prefix decode over prompts with a common head (``--prefix-share
--grouped-decode --shared-prefix-len N``, paged and chunked), the int8
lm_head
(``--lm-head-w8 [--matmul-backend]``), on-device sampling (``--sampling
greedy|temperature|top_k|top_p`` with ``--temperature``, ``--top-k``,
``--top-p``; ``--seed`` keys the per-request streams) and decode windows
(``--decode-window N``: N decode steps per engine step, one CUDA graph
replay and one host sync per window on the card, streams equal to N = 1
bit for bit; the summary carries ``syncs_per_token``).  Without
``--sampling`` tokens are greedy.  The int8 KV cache is
reached through ``serve_demo(hx=HelixConfig(kv_cache_bits=8, ...))``, as in
the reference, which has no flag for it.

``--arch mamba2-780m`` serves the attention-free Mamba2 model: one-shot
prefill through the SSD scan (``--ssd-backend cuda|ref``) and O(1)-state
decode steps.  As in the reference its prompts must be at most 64 tokens or
a multiple of 64, and ``--chunk-tokens`` falls back to one-shot prefill.

``--arch hymba-1.5b`` serves the hybrid: attention and Mamba2 heads side by
side in every layer (flash_prefill at 5 query heads per kv head and the SSD
scan in each prefill, flash_decode and the O(1)-state step in each decode
step), an untied head.  The SSD scan's prompt contract holds (at most 64
tokens or a multiple of 64), ``--chunk-tokens`` falls back to one-shot
prefill and ``--prefix-share`` raises, as in the reference; ``--paged-kv``
and ``--lm-head-w8`` work.

``--arch gemma3-12b`` serves the windowed dense model: 5 local layers of a
1024-token sliding window, then 1 global, head size 256, a gated GELU and
the final-logit softcap 30.  Every layer's window reaches the prefill (one
shot or ``--chunk-tokens``) and every decode step, grouped decode's prefix
pass included, so every flag of the dense path works: ``--paged-kv``,
``--prefix-share --grouped-decode``, ``--lm-head-w8``, ``--sampling`` and
``--decode-window``.

Host KV tier and tenancy (paged): ``--host-pages N`` sizes the host store
that spills a preempted request's pool pages, so its resume restores them
with no prefill chunk; ``--session-kv`` keeps a retired request's pages by
session, so ``--turns T`` conversations restore their history;
``--fault-plan 'seed=9,restore_fail=0.5,...'`` injects the tier's faults,
each of which degrades to a counted re-prefill.  Every run replays a trace:
``--trace FILE``, or one generated from ``--traffic batch|poisson|bursty``
(``--arrival-rate``, ``--burst``) and ``--tenants
'name[:weight[:slo[:share]]],...'``, which also arms weighted-fair
admission; ``--slo-ttl-ms`` arms the TTL governor (batch slots shed through
the spill while the interactive TTL p95 is past the target) and
``--virtual-clock`` makes the latencies the cost model's, so a replay gives
the same summary.  The summary gains ``tier_stats()``, ``trace_id`` and
``turn2_ttft_s``.  SSM and hybrid archs refuse the host tier, as in the
reference.  ``serve_steps`` is ``serve_demo`` one engine step at a time: a
generator that hands the engine back between steps, where a caller may
``preempt`` a request.

``--arch starcoder2-15b`` (48 q / 4 kv heads of 128, G = 12, an ungated
GELU FFN), ``--arch granite-8b`` and ``--arch llama-405b`` (the paper's
dense model, 128 q / 8 kv heads, G = 16) serve the dense path with every
flag above.  ``--layers N`` keeps the first N layers of the config, a depth
cut: llama-405b's 126 layers hold ~6.4 GB each in bf16, so one 80 GB card
serves it at full width with its depth cut (8 layers and both of its
embedding tables: ~59 GB).

``--arch granite-moe-1b-a400m`` serves the mixture of experts: every FFN
routes each token to 8 of 32 experts (capacity factor 1.25 in the prefill,
4 in the decode steps, where nothing is dropped).  Capacity routing mixes
the whole prompt, so ``--chunk-tokens`` falls back to one-shot prefill and
``--prefix-share`` raises, as in the reference; ``--paged-kv``,
``--lm-head-w8``, ``--sampling`` and ``--decode-window`` work.
``--arch arctic-480b`` (128 experts, top 2, beside a dense residual FFN
of d_ff 4864 in every layer; 56 q / 8 kv heads of 128) serves the same
way; its experts hold 26.8 GB a layer in bf16, so one 80 GB card takes 2
of its 35 layers (``--layers 2``).

Helix across ranks: ``--nproc N [--tpa T] [--hopb-chunks C]
--dist-backend nccl|gloo`` serves with N processes, one rank each of a
``KVP x TPA`` grid (KVP = N / T; T falls back to 1 when the arch has
fewer than T KV heads, the reference's rule): every rank runs the same
engine on the same requests with its share of the weights
(``models/shard.py``) and its KV shard; attention is Helix's (one all-to-all per layer, HOP-B over C
batch chunks), the out-projection, the FFN and the head are TP over all N.
``nccl`` needs one card per rank; ``gloo`` runs ranks that share one card
(their collectives staged through host memory) or run on the CPU
(``--device cpu``).  The kernels are built once, here, before the ranks
start; rank 0's summary is printed, with ``world``, ``kvp``, ``tpa``,
``ep``, ``hopb_chunks`` and every rank's ``launches`` and
``collectives``.  Dense and MoE archs (an MoE's experts in EP x TPF, EP =
N / T, e.g. ``--arch arctic-480b --layers 2 --nproc 4 --tpa 2
--dist-backend gloo``; each rank draws only its share of the seeded
weights) with the fixed fp KV cache and one-shot greedy prefill only:
every other option raises ``ValueError``
(``serving/engine.check_rank_engine``).

``--arch whisper-base`` and ``--arch phi-3-vision-4.2b`` are refused with
a ``ValueError`` before any weight is made: the engine serves no enc-dec or
vlm arch (``serving/engine.check_servable``).  Serve them through
``models/model_zoo.make_prefill_step`` and ``build_serve_step`` /
``build_serve_multistep`` with ``enc_frames`` or ``patch_embeds`` in the
batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.core.sharding import HelixConfig, default_helix_config
from repro_torch.kernels import build
from repro_torch.kernels.registry import (BACKENDS, backend_table,
                                          launch_counts,
                                          reset_launch_counts)
from repro_torch.launch import ranks
from repro_torch.models.model_zoo import (build_serve_multistep,
                                          build_serve_step,
                                          chunked_prefill_supported,
                                          make_chunk_prefill_step,
                                          make_prefill_step)
from repro_torch.models.shard import init_rank_params, shard_model
from repro_torch.models.transformer import init_params
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving.engine import check_rank_engine, check_servable
from repro_torch.serving.metrics import VirtualClock
from repro_torch.serving.sampling import SAMPLING_KINDS, SamplingParams
from repro_torch.serving.scheduler import POLICIES
from repro_torch.serving.workload import (TenantSpec, generate_trace,
                                          load_trace, parse_tenants,
                                          requests_from_trace, trace_id)
# re-exported beside generate_rows for callers of this module
from repro_torch.serving.workload import prompt_tokens  # noqa: F401

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _span(x) -> tuple[int, int]:
    """An int or an inclusive ``(lo, hi)`` range, as a range."""
    return (int(x), int(x)) if np.isscalar(x) else (int(x[0]), int(x[1]))


def generate_rows(n: int, *, prompt_len, max_tokens, seed: int = 0):
    """``n`` batch-arrival rows of one tenant, lengths drawn uniformly from
    ``prompt_len`` / ``max_tokens`` (ints or inclusive ``(lo, hi)``
    ranges): ``generate_trace(arrival="batch")``, the reference's draws for
    one seed."""
    return generate_trace(n, arrival="batch", tenants=(TenantSpec(
        "default", prompt_len=_span(prompt_len),
        max_tokens=_span(max_tokens)),), seed=seed)


def serve_demo(arch: str = "granite-3-2b", *, world: int = 1, tpa: int = 1,
               hopb_chunks: int = 1, dist_backend: str | None = None,
               init_method: str | None = None, **kw):
    """Serve ``n_requests`` synthetic prompts through the engine, to the
    end.  Returns ``(finished Requests, metrics summary)``; the other
    arguments are ``serve_steps``'s.

    ``world`` > 1 (or a ``dist_backend``): ``world`` ranks of a ``KVP x
    TPA`` grid, HOP-B over ``hopb_chunks`` (module doc).  ``tpa`` is the
    attention TP width asked for; the reference's rule
    (``core/sharding.default_helix_config``) keeps it when the arch has at
    least that many KV heads, else serves pure KVP over every rank; KVP =
    ``world`` / TPA.  The ranks are started by ``launch/ranks.spawn``
    through ``init_method`` (default: a fresh ``file://`` rendezvous).  ``dist_backend`` is ``nccl`` or
    ``gloo``; it defaults to gloo on the CPU and must be given on CUDA.
    The kernels are built here before the ranks start.  A ``model`` must be
    on the CPU; each rank takes its share.  Raises when a rank fails or the
    ranks' streams differ; returns rank 0's requests and summary, with
    ``rank_launches`` and ``rank_collectives`` of every rank."""
    if world > 1 or dist_backend is not None:
        return _serve_world(arch, world, tpa, hopb_chunks, dist_backend,
                            init_method, kw)
    steps = serve_steps(arch, **kw)
    while True:
        try:
            next(steps)
        except StopIteration as done:
            return done.value


def _serve_world(arch, world, tpa, hopb_chunks, backend, init_method, kw):
    device = torch.device(kw.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve_demo runs on CUDA and found no CUDA device "
                           "(pass device='cpu' for the plain PyTorch path)")
    if backend is None:
        if device.type == "cuda":
            raise ValueError("world > 1 on CUDA: choose dist_backend 'nccl' "
                             "(one card per rank) or 'gloo' (ranks sharing "
                             "a card)")
        backend = "gloo"
    cfg = _config(arch, kw.get("reduced", False), kw.get("n_layers", 0))
    grid = default_helix_config(cfg, world, tpa)
    if kw.get("kvp") not in (None, grid.kvp):
        raise ValueError(f"kvp={kw['kvp']}: across ranks kvp is world / tpa")
    hx = _helix(kw.get("hx"), _overrides(kw), kvp=grid.kvp, tpa=grid.tpa,
                ep=grid.ep)
    check_rank_engine(cfg, hx, **{k: kw[k] for k in (
        "chunk_tokens", "prefix_share", "decode_window", "host_pages",
        "session_kv", "fault_plan", "tenants") if k in kw},
        sampling=kw.get("sampling"),
        slo_ttl_s=kw.get("slo_ttl_ms") or None)
    if kw.get("traffic", "batch") != "batch":
        raise ValueError("across ranks arrivals are batch only (the traffic "
                         "models pace arrivals by each rank's steps)")
    ranks.check_backend(world, backend, device)
    if device.type == "cuda":
        build.build_all()                   # once, before the ranks start
    log = kw.pop("log", print)
    res = ranks.spawn(world, _serve_rank, arch, hopb_chunks, kw, tpa=hx.tpa,
                      ep=hx.ep, backend=backend, device=device,
                      init_method=init_method)
    streams = [{r.rid: r.out_tokens for r in fin} for fin, _ in res]
    if any(s != streams[0] for s in streams[1:]):
        raise RuntimeError("the ranks' token streams differ")
    finished, summary = res[0]
    summary["rank_launches"] = [s.pop("launches") for _, s in res]
    summary["rank_collectives"] = [s.pop("collectives") for _, s in res]
    log(f"[serve] {world} ranks (kvp {hx.kvp} x tpa {hx.tpa}, ep {hx.ep}, "
        f"{backend}, "
        f"hopb {hopb_chunks}): {len(finished)} requests, "
        f"{summary['n_tokens']} tokens in {summary['wall_s']:.2f}s")
    return finished, summary


def _serve_rank(group, arch, hopb_chunks, kw):
    """One rank of ``serve_demo(world=...)``: ``serve_steps`` with the
    group, its launch counts and collectives in the summary."""
    kw = dict(kw, device=group.device, log=lambda *a: None)
    reset_launch_counts()
    group.reset_stats()
    steps = serve_steps(arch, group=group, hopb_chunks=hopb_chunks, **kw)
    while True:
        try:
            next(steps)
        except StopIteration as done:
            finished, summary = done.value
            break
    summary.update(world=group.world, kvp=group.kvp, tpa=group.tpa,
                   ep=group.ep,
                   hopb_chunks=hopb_chunks, launches=launch_counts(),
                   collectives={"calls": dict(group.calls),
                                "host_ms": dict(group.host_ms)})
    return finished, summary


def _config(arch, reduced, n_layers):
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    check_servable(cfg)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg


def _overrides(kw) -> dict:
    """The ``HelixConfig`` fields ``serve_steps``' arguments override."""
    return {k: kw.get(k) for k in ("kvp", "attn_backend", "prefill_backend",
                                   "matmul_backend", "ssd_backend",
                                   "lm_head_w8", "paged_kv", "grouped_decode")
            if kw.get(k) is not None}


def _helix(hx, overrides, **fields) -> HelixConfig:
    return dataclasses.replace(hx or HelixConfig(), **{**overrides, **fields})


def serve_steps(arch: str = "granite-3-2b", *, reduced: bool = False,
               n_layers: int = 0, n_requests: int = 8, prompt_len=32,
               max_new=16, max_batch: int = 8, hx: HelixConfig | None = None,
               kvp: int | None = None,
               attn_backend: str | None = None,
               prefill_backend: str | None = None,
               matmul_backend: str | None = None,
               ssd_backend: str | None = None,
               lm_head_w8: bool | None = None,
               paged_kv: bool | None = None, pool_blocks: int = 0,
               grouped_decode: bool | None = None,
               chunk_tokens: int = 0, prefix_share: bool = False,
               shared_prefix_len: int = 0, prompt_multiple: int = 1,
               sched_policy: str = "fcfs", sampling=None,
               temperature: float = 1.0, top_k: int = 0, top_p: float = 1.0,
               decode_window: int = 1, traffic: str = "batch",
               arrival_rate: float = 0.5, burst: int = 4, trace=None,
               tenants=None, slo_ttl_ms: float = 0.0, virtual_clock=False,
               host_pages: int = 0, session_kv: bool = False,
               fault_plan=None, turns: int = 1, dtype=torch.float32,
               device="cuda", model=None, seed: int = 0, log=print,
               group=None, hopb_chunks: int = 1):
    """``serve_demo`` one engine step at a time: a generator that yields
    the ``DecodeEngine`` before each engine step, after that step's
    arrivals are submitted, and returns ``(finished Requests, metrics
    summary)``.  Between two steps a caller may act on the engine as a
    server's control plane would, e.g. ``preempt`` a request.

    ``prompt_len`` / ``max_new`` are ints or inclusive ``(lo, hi)`` ranges;
    each drawn prompt length is rounded up to a multiple of
    ``prompt_multiple`` (port only: ``prompt_len=(1, 1024),
    prompt_multiple=256`` draws 256, 512, 768 or 1024 uniformly, lengths
    the SSM prefill's chunking takes).
    ``n_layers`` > 0 keeps the config's first that-many layers (a depth
    cut, port only: llama-405b at full width on one card).
    ``model`` (a ``Transformer`` on ``device``) overrides the seeded random
    weights, e.g. weights carried over with ``convert.params_from_jax``.
    ``hx`` defaults to ``HelixConfig()`` (``cuda`` kernels, fused append,
    block pruning, bf16/f32 KV cache); ``kvp``, the ``*_backend`` arguments,
    ``lm_head_w8`` and ``paged_kv`` override its fields (``None`` keeps
    them).  ``paged_kv`` serves from a shared pool of ``pool_blocks`` pages
    of ``kvp * rr_block`` positions (0: the fixed layout's memory plus the
    sink page); the summary carries the engine's ``pool_stats()``.
    ``chunk_tokens`` > 0 prefills in chunks of that many tokens.
    ``shared_prefix_len`` starts every prompt with the same that-many
    tokens (drawn from ``seed``); ``prefix_share`` turns on the prefix
    index over them (needs ``paged_kv`` and chunked prefill) and
    ``grouped_decode`` decodes the shared pages once per group.
    ``sampling`` (a ``SAMPLING_KINDS`` name) arms the on-device sampler
    with ``temperature``/``top_k``/``top_p``, its streams keyed by ``seed``
    (``SamplingParams(seed=seed)``, as in the reference); port only: a
    ``SamplingParams`` is taken as it is, its own seed keying the streams
    while ``seed`` draws the requests.  ``decode_window``
    > 1 decodes that many steps per engine step (``build_serve_multistep``),
    and the summary carries ``sync_stats()``.  Raises on a host without
    CUDA unless ``device="cpu"``.

    The run replays a trace (``serving/workload.py``): ``trace`` (a path
    or ``TraceRow``s), else one generated from ``traffic`` (``"batch"`` |
    ``"poisson"`` | ``"bursty"``, ``arrival_rate`` requests per engine step,
    ``burst``) and ``tenants`` (a ``parse_tenants`` spec or
    ``TenantSpec``s, whose ranges default to ``prompt_len``/``max_new``);
    the summary's ``trace_id`` names it.  ``tenants`` also arms the fair
    queue, ``slo_ttl_ms`` > 0 the TTL governor, and ``virtual_clock`` (True
    or a ``VirtualClock``) makes every latency the cost model's.  Host KV
    tier (paged): ``host_pages`` sizes the store that spills preempted
    requests, ``session_kv`` keeps retired requests' pages by session,
    ``fault_plan`` (a ``FaultPlan`` or its spec) injects faults; the
    summary carries ``tier_stats()``.  ``turns`` > 1: each request is a
    session whose next turn, submitted the step the last one finishes, is
    its whole conversation so far plus ``prompt_len`` fresh tokens (the
    top of a range), drawn from the same generator as the reference's;
    ``turn2_ttft_s`` is the mean TTFT of the later turns.

    ``group`` (a ``core/dist.HelixGroup``): this process is one rank of
    ``serve_demo(world=...)``; ``hx`` takes the group's ``kvp`` and
    ``tpa`` (and ``ep``), ``model`` is cut to the rank's share
    (``shard_model``) or, without one, the rank draws its share of the
    seeded weights alone (``init_rank_params``: no rank holds the whole
    model), and the engine's steps run across the ranks, HOP-B over
    ``hopb_chunks``.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("serve_demo runs on CUDA and found no CUDA device "
                           "(pass device='cpu' for the plain PyTorch path)")
    cfg = _config(arch, reduced, n_layers)
    ranked = ({} if group is None else
              dict(kvp=group.kvp, tpa=group.tpa, ep=group.ep))
    hx = _helix(hx, _overrides(dict(
        kvp=kvp, attn_backend=attn_backend, prefill_backend=prefill_backend,
        matmul_backend=matmul_backend, ssd_backend=ssd_backend,
        lm_head_w8=lm_head_w8, paged_kv=paged_kv,
        grouped_decode=grouped_decode)), **ranked)
    if group is None:
        if model is None:
            model = init_params(cfg, seed, dtype=dtype, device=device)
    elif model is None:
        model = init_rank_params(cfg, group, seed, dtype=dtype,
                                 device=device)
    else:
        model = shard_model(model.to(device), cfg, group)
    if isinstance(tenants, str):
        tenants = parse_tenants(tenants)
    if trace is not None:
        rows = load_trace(trace) if isinstance(trace, str) else list(trace)
    else:
        spans = dict(prompt_len=_span(prompt_len), max_tokens=_span(max_new))
        rows = generate_trace(
            n_requests, arrival=traffic, rate=arrival_rate, burst=burst,
            tenants=tuple(dataclasses.replace(
                t, **{k: getattr(t, k) or v for k, v in spans.items()})
                for t in (tenants or (TenantSpec("default"),))),
            seed=seed)
    rows = sorted((dataclasses.replace(r, prompt_len=-(-r.prompt_len
                                                       // prompt_multiple)
                                       * prompt_multiple) for r in rows),
                  key=lambda r: (r.arrival_step, r.rid))
    fresh = _span(prompt_len)[1]
    p_max = max(r.prompt_len for r in rows)
    m_max = max(r.max_tokens for r in rows)
    # a later turn holds the whole conversation so far
    max_seq = p_max + m_max + 1 + (turns - 1) * (fresh + m_max)
    chunked = chunk_tokens > 0 and chunked_prefill_supported(cfg)
    if chunk_tokens > 0 and not chunked:
        log(f"[serve] {cfg.name}: chunked prefill unsupported for this "
            "family; falling back to one-shot prefill")
    sp = sampling
    if isinstance(sampling, str):
        sp = SamplingParams(kind=sampling, temperature=temperature,
                            top_k=top_k, top_p=top_p, seed=seed)
    engine = DecodeEngine(
        cfg, model,
        build_serve_step(cfg, hx, group=group, hopb_chunks=hopb_chunks),
        make_prefill_step(cfg, hx, group=group),
        max_batch=max_batch, max_seq=max_seq, hx=hx, dtype=dtype,
        device=device, sched_policy=sched_policy, pool_blocks=pool_blocks,
        chunk_tokens=chunk_tokens if chunked else 0,
        chunk_prefill_step=(make_chunk_prefill_step(
            cfg, hx, return_last_logits=sp is not None) if chunked else None),
        prefix_share=prefix_share, sampling=sp, decode_window=decode_window,
        serve_multistep=(build_serve_multistep(cfg, hx, window=decode_window)
                         if decode_window > 1 else None),
        host_pages=host_pages, session_kv=session_kv, fault_plan=fault_plan,
        tenants=({t.name: t.tenant_config() for t in tenants}
                 if tenants else None),
        slo_ttl_s=slo_ttl_ms / 1e3 if slo_ttl_ms else None,
        clock=(VirtualClock() if virtual_clock is True
               else virtual_clock or time.monotonic), group=group)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab, shared_prefix_len).tolist()
    pending = requests_from_trace(rows, cfg.vocab, shared_prefix=shared)
    if turns > 1:
        for r in pending:
            if r.session_id is None:
                r.session_id = f"s{r.rid}"
    arrivals = [r.arrival_step for r in rows]
    turn_of = {r.rid: 1 for r in pending}
    next_rid = max((r.rid for r in pending), default=-1) + 1
    finished: list[Request] = []
    t0 = time.perf_counter()
    steps = 0
    while pending or engine.pending():
        while pending and arrivals[0] <= steps:
            engine.submit(pending.pop(0))
            arrivals.pop(0)
        yield engine
        for r in engine.step():
            finished.append(r)
            t = turn_of[r.rid]
            if (t < turns and r.session_id is not None
                    and r.finish_reason in ("eos", "max_tokens")):
                # the next turn: the conversation so far + fresh tokens
                nxt = Request(
                    rid=next_rid,
                    prompt=(list(r.prompt) + list(r.out_tokens)
                            + rng.integers(0, cfg.vocab, fresh).tolist()),
                    max_new_tokens=_span(max_new)[1],
                    session_id=r.session_id, tenant=r.tenant,
                    slo_class=r.slo_class)
                turn_of[next_rid] = t + 1
                next_rid += 1
                engine.submit(nxt)
        steps += 1
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in finished)
    summary = engine.metrics.summary()
    summary.update(engine.pool_stats())
    summary.update(engine.tier_stats())
    summary.update(engine.sync_stats())
    summary["trace_id"] = trace_id(rows)
    late = [engine.metrics.requests[r.rid].ttft for r in finished
            if turn_of.get(r.rid, 1) >= 2
            and engine.metrics.requests[r.rid].ttft is not None]
    summary["turn2_ttft_s"] = float(np.mean(late)) if late else 0.0
    summary.update(decode_syncs=engine.decode_syncs,
                   prefill_calls=engine.prefill_calls, engine_steps=steps,
                   wall_s=dt, tok_s=toks / max(dt, 1e-9),
                   kv_cache_dtype=(str(engine.state["kcache"].dtype)
                                   if "kcache" in engine.state else None))
    log(f"[serve] {len(finished)} requests, {toks} tokens in {dt:.2f}s "
        f"({toks / max(dt, 1e-9):.1f} tok/s, {steps} engine steps)")
    return finished, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-3-2b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (tests, CPU runs)")
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the config's first N layers, a depth cut "
                         "(0: all)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="prefill prompts in chunks of this many tokens, "
                         "one chunk per engine step (0: one-shot prefill)")
    ap.add_argument("--kvp", type=int, default=1,
                    help="KV-parallel ranks, emulated on one card")
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks (processes) of Helix across ranks: KVP = "
                         "nproc / tpa")
    ap.add_argument("--tpa", type=int, default=1,
                    help="attention TP width across ranks, kept when the "
                         "arch has that many KV heads, else pure KVP (the "
                         "reference's rule)")
    ap.add_argument("--hopb-chunks", type=int, default=1,
                    help="HOP-B: batch chunks whose all-to-all overlaps the "
                         "next chunk's attention")
    ap.add_argument("--dist-backend", default=None, choices=("nccl", "gloo"),
                    help="collectives across ranks: nccl (one card per "
                         "rank) or gloo (ranks sharing a card, or the CPU)")
    ap.add_argument("--sched-policy", default="fcfs", choices=POLICIES)
    ap.add_argument("--attn-backend", default=None, choices=BACKENDS)
    ap.add_argument("--prefill-backend", default=None, choices=BACKENDS)
    ap.add_argument("--ssd-backend", default=None, choices=BACKENDS,
                    help="ssd_prefill backend of the Mamba2 prefill scan "
                         "(SSM archs)")
    ap.add_argument("--matmul-backend", default=None, choices=BACKENDS,
                    help="w8a16_matmul backend of the int8 lm_head (only "
                         "used with --lm-head-w8)")
    ap.add_argument("--lm-head-w8", action="store_true",
                    help="int8-quantize the lm_head and run the logits "
                         "matmul through the w8a16_matmul family")
    ap.add_argument("--paged-kv", action="store_true",
                    help="serve from a shared pool of KV pages (block "
                         "tables) instead of one fixed row per slot")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="pages in the pool with --paged-kv, the sink page "
                         "included (0: the fixed layout's memory)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="prefix index + refcounted copy-on-write page "
                         "sharing: prompts matching a finished prefill's "
                         "prefix map its pages and prefill only their "
                         "suffix (needs --paged-kv and --chunk-tokens)")
    ap.add_argument("--grouped-decode", action="store_true",
                    help="grouped shared-prefix decode: requests whose "
                         "tables share leading pages read them once per "
                         "group (needs --paged-kv)")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="every synthetic prompt starts with the same "
                         "this-many tokens")
    ap.add_argument("--sampling", default=None, choices=SAMPLING_KINDS,
                    help="on-device token sampling kind (default: greedy "
                         "argmax); per-request streams keyed by --seed and "
                         "the request id")
    ap.add_argument("--temperature", type=float, default=1.0,
                    help="softmax temperature of --sampling temperature/"
                         "top_k/top_p (> 0)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="keep the k highest logits (--sampling top_k)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus mass of --sampling top_p, in (0, 1]")
    ap.add_argument("--decode-window", type=int, default=1,
                    help="decode steps per engine step: one CUDA graph "
                         "replay and ONE [batch, N] token transfer per "
                         "window (streams equal to N = 1)")
    ap.add_argument("--traffic", default="batch",
                    choices=("batch", "poisson", "bursty"),
                    help="arrivals: all at once, a Poisson process over "
                         "engine steps, or closed bursts with Poisson gaps")
    ap.add_argument("--arrival-rate", type=float, default=0.5,
                    help="poisson/bursty: mean requests per engine step")
    ap.add_argument("--burst", type=int, default=4,
                    help="bursty: arrivals per burst")
    ap.add_argument("--trace", default=None,
                    help="replay a saved JSONL trace instead of generating "
                         "one (the summary's trace_id names it)")
    ap.add_argument("--tenants", default=None,
                    help="tenant mix 'name[:weight[:slo[:share]]],...', "
                         "e.g. 'chat:2:interactive:0.5,bulk:1:batch:0.5'; "
                         "arms weighted-fair admission")
    ap.add_argument("--slo-ttl-ms", type=float, default=0.0,
                    help="interactive TTL p95 target in ms; > 0 arms the "
                         "TTL governor, which sheds batch slots through "
                         "the host tier's spill")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="the deterministic cost-model metrics clock: a "
                         "replayed trace gives the same latency summary")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host KV tier capacity in pool pages: preempted "
                         "requests spill their pages and resume with no "
                         "prefill chunk (needs --paged-kv)")
    ap.add_argument("--session-kv", action="store_true",
                    help="keep retired requests' pages by session, so the "
                         "next turn restores its history (needs "
                         "--paged-kv)")
    ap.add_argument("--fault-plan", default=None,
                    help="inject host-tier faults, 'k=v,...' over seed, "
                         "restore_fail, corrupt, store_full, delay, "
                         "delay_steps; each degrades to re-prefilling")
    ap.add_argument("--turns", type=int, default=1,
                    help="each request is a session of this many turns, "
                         "each the conversation so far plus --prompt-len "
                         "fresh tokens")
    ap.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0,
                    help="the model weights, the requests and the "
                         "sampling streams")
    ap.add_argument("--metrics", action="store_true",
                    help="print the TTFT/TTL/queue-wait summary JSON")
    ap.add_argument("--list-backends", action="store_true",
                    help="print the kernel backend table and exit")
    args = ap.parse_args(argv)
    if args.list_backends:
        print(backend_table())
        return
    ranked = {}
    if args.nproc > 1 or args.dist_backend:
        ranked = dict(world=args.nproc, tpa=args.tpa,
                      hopb_chunks=args.hopb_chunks,
                      dist_backend=args.dist_backend)
    _, summary = serve_demo(
        args.arch, **ranked, reduced=args.reduced, n_layers=args.layers,
        n_requests=args.requests, prompt_len=args.prompt_len,
        max_new=args.max_new, max_batch=args.max_batch,
        kvp=None if ranked else args.kvp,
        attn_backend=args.attn_backend, prefill_backend=args.prefill_backend,
        matmul_backend=args.matmul_backend, ssd_backend=args.ssd_backend,
        lm_head_w8=args.lm_head_w8 or None,
        paged_kv=args.paged_kv or None, pool_blocks=args.pool_blocks,
        grouped_decode=args.grouped_decode or None,
        chunk_tokens=args.chunk_tokens, prefix_share=args.prefix_share,
        shared_prefix_len=args.shared_prefix_len,
        sched_policy=args.sched_policy, sampling=args.sampling,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        decode_window=args.decode_window, traffic=args.traffic,
        arrival_rate=args.arrival_rate, burst=args.burst, trace=args.trace,
        tenants=args.tenants, slo_ttl_ms=args.slo_ttl_ms,
        virtual_clock=args.virtual_clock, host_pages=args.host_pages,
        session_kv=args.session_kv, fault_plan=args.fault_plan,
        turns=args.turns, dtype=DTYPES[args.dtype],
        device=args.device, seed=args.seed)
    if args.metrics:
        print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
