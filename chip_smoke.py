#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one sm_90 card (H100).  Phases, each fatal on failure:

1. device: CUDA, capability 9.0, card name and power limit, TF32 off;
2. build: the five CUDA kernels from ``src/repro_torch/csrc`` (ptxas
   lines), one ``nvcc`` per source, all started together; then the
   registers and spill bytes of every head-size-256 instance (gemma3-12b's
   flash_decode, prefix_pass and flash_prefill) and any C75xx advisory;
3. kernels vs their plain PyTorch versions on the card at granite-3-2b
   widths (Qh 32, Kh 8, hsz 64) in f32 and bf16, plus pruned == dense and
   fused == unfused append, bit for bit, in the fp and the int8 mode of
   flash_decode, and the same lattice in its paged mode (a shuffled block
   table with 0 tails), where paged == fixed bit for bit as well;
   w8a16_matmul at the lm_head shape for M = 1, 2, 4 and 8, a K of 2053
   (a ragged last step), a ragged N and M = 9 (two M tiles); grouped decode
   (prefix_pass, then flash_decode's grouped-suffix mode) against the
   ungrouped paged kernel bit for bit and the plain grouped decode within
   the tolerance, f32, bf16 and int8, kvp 1 and 4, windows 0 and 512, a
   split inside a tile and one group holding the whole batch; the chunk
   edges of flash_decode's split sweep (chunks of 256 local slots):
   lengths ending on a chunk boundary and one slot past it (the appended row
   in a chunk's first slot), a window starting mid-chunk, f32, bf16 and
   int8, kvp 1 and 4, with pruned == dense, fused == unfused, paged ==
   fixed and grouped (split inside a chunk and a tile) == ungrouped bit for
   bit; ssd_prefill
   (the Mamba2 SSD scan) at mamba2-780m widths (nh 48, hd 64, ds 128) at
   T = 1, 64, 65 (one token past a chunk), a ragged 37, 1024, B = 4 at T =
   1024 and T = 4096 (a fold across 64 chunks), from a nonzero state; two
   halves chained through h_final == one pass, bit for bit at a split on
   the chunk grid (512) and within the tolerance off it (500); two B/C
   groups read directly == the repeated form; f32 and bf16 inputs;
   flash_prefill (bf16 on wgmma, f32
   on CUDA cores) fixed and paged (16-position pages, a shuffled table, a
   sink page of +-1e4) against the plain versions, windows 0 and 256,
   per-request offsets and lengths; paged == fixed bit for bit at pages
   16 and 64; rows of 4 chunk calls (T 256 at q_offset 0..768) == the same
   rows of one T 1024 call bit for bit, fixed and paged; lens == 0 rows
   zero in both layouts; at hymba-1.5b's shapes: flash_prefill at 5
   query heads per kv head (B = 1, T = 1024, 25/5 heads: blocks of 12
   positions and 4 dead rows), f32 and bf16, fixed and paged vs plain,
   paged == fixed and chunk rows == one-shot rows bit for bit;
   flash_decode at G = 5 (B = 4, lengths 700-1000), fixed and paged, fp
   and int8, kvp 1 and 4, vs plain, paged == fixed bit for bit;
   ssd_prefill at nh 50, hd 64, ds 16 (B = 1 and 4, T = 1024, a split at
   512 == one pass bit for bit); w8a16_matmul at the untied head (M = 1
   and 4, K = 1600, N = 32256); at granite-moe-1b-a400m's shapes:
   flash_prefill at G = 2 (16/8 heads) and flash_decode at G = 2, the
   same checks as at G = 5, w8a16_matmul at its tied head (M = 1 and 4, K
   = 1024, N = 49664), and its MoE layer at full width (E 32, top 8, H
   1024, Fe 512, f32) on the card against the CPU at T = 4 (decode
   capacity) and T = 1024 (prefill capacity): routes, slots and token
   plans equal, y within MOE_TOL; at gemma3-12b's shapes (16 q / 8 kv
   heads of 256): flash_prefill at B = 1, T = 2048, windows 0 and 1024,
   f32 and bf16, fixed and paged vs plain, paged == fixed and rows of 8
   chunk calls (q_offset up to 1792, past the window) == one call bit for
   bit; flash_decode at B = 4, lengths 700-2100 (three past the window),
   windows 0 and 1024, fixed and paged, fp and int8, kvp 1 and 4, vs plain;
   grouped decode over 4 rows sharing 512 positions, windows 0 and 1024
   (the window leaves the prefix wholly for one row, whose prefix state is
   then empty), grouped == ungrouped bit for bit, f32, bf16 and int8; and
   w8a16_matmul at the tied head (M = 1 and 4, K = 3840, N = 262144);
   the on-device sampler (plain PyTorch) at
   B = 4, V = 49155: threefry words, uniforms, Gumbel noise and tokens on
   the card equal to its plain CPU run bit for bit;
4. serve: granite-3-2b at full width (40 layers, bf16, seeded random
   weights) through ``serve_demo`` for the same 8 requests: the fp path and
   the int8 path (``HelixConfig(kv_cache_bits=8, lm_head_w8=True)``) in
   turns fp, int8, int8, fp; then both from the paged pool
   (``paged_kv=True``), whose streams must equal the fixed runs'; then a
   paged run with half the default pool, where an admission waits for
   pages.  Then 8 requests of 768-1024 tokens whose first 512 are shared,
   budgets 16-48, chunks of 256 from the paged pool: (a) unshared, (b)
   with prefix sharing, (c) with grouped decode as well, whose streams must
   be equal; and (d) the fp run's requests chunked on the fixed layout,
   whose streams must equal the one-shot fp run's.  Decode windows: the fp
   run's requests with top-p sampling (T 0.9, p 0.85, seed 7) at window 1
   and window 4 (one CUDA graph replay per window after one warm-up window
   and the capture), window 4 from the paged pool, all three with equal
   streams; greedy window 4 on the fp and on the int8 path, whose streams
   must equal the one-step fp and int8 runs'; launch counts layers x 4 x
   (windows + the warm-up); TTL, TTFT, tok/s, host ms per decoded token
   and device ms per window (CUDA events) of each; one window replayed
   from its graph == the eager window bit for bit over a full-width
   state.  The launch counts of
   each run, set to 0 just before it, must equal layers x decode steps
   (flash_decode; int8 mode in the int8 runs, paged mode in the paged
   runs, grouped-suffix mode and prefix_pass in run c), layers x prefill
   calls (flash_prefill; one-shot prefills or chunks) and decode steps
   (w8a16_matmul, int8 runs).  Then 4-layer f32 runs of the same widths
   where the kernel path, the plain path, kvp = 4 and a chunked prefill
   agree, fp and int8.  Then mamba2-780m at full width, 24 of its 48
   layers (bf16, seeded random weights; mamba2, hymba and granite-moe are
   served at half their depth to keep the script's time)
   through ``serve_demo``: 8 requests of 256-1024 tokens (multiples of
   256, the reference's prompt-length contract), 32 new tokens each,
   ssd_prefill launched 24 x prefills, then the same
   requests with top-p sampling at window 1 and 4 (equal streams) and one
   graph window == eager over a full-width state; and 4-layer f32
   checks: prefill logits and state of the ssd backends ``cuda`` and
   ``ref``, and prefill + 2 decode steps against ``forward`` over T + 2
   tokens.  Profiles of one 1024-token one-shot prefill of each model
   (host wall, device time, the prefill kernel's share; mamba2's go into
   ssd_prefill's record as ``mamba2_prefill``).  Then hymba-1.5b at full
   width (16 of 32 layers, bf16, seeded random weights, attention and Mamba2
   heads in every layer, untied head): 8 requests of 256-1024 tokens
   (multiples of 64), 32 new tokens each, one-shot prefills: greedy at
   window 1, top-p at window 1 and 4 and paged top-p at window 4 (equal
   streams), greedy window 4 with the int8 head and the int8 KV cache;
   launch counts layers x decode steps (warm-up window included) and
   layers x prefills for flash_prefill and ssd_prefill; one graph window
   == eager over a full-width state; decode-step and prefill profiles;
   4-layer f32 checks: kernel path vs plain path and kvp 4 vs kvp 1, fp
   and int8 (the prefill profile's shares go into the records
   ``flash_prefill_hymba`` and ``ssd_prefill_hymba``).  Then
   granite-moe-1b-a400m at full width (12 of 24 layers, bf16, seeded random
   weights, 32 experts, top 8, tied head): 8 requests of 128-1024 tokens,
   32 new tokens each, one-shot prefills, the same five runs as hymba's
   with the same launch counts (no ssd_prefill); one graph window ==
   eager; the decode-step profile beside its byte bound and the MoE FFNs'
   device time and share; the prefill profile; 4-layer f32 checks, kernel
   vs plain and kvp 4 vs 1, fp and int8, with every layer's routes equal
   between the compared runs (a token routed otherwise is printed with
   its distance from a tie, and fails the run).  Then gemma3-12b at full
   width, 24 of its 48 layers (20 local of a 1024-token
   window, 4 global; head size 256, softcap 30, bf16, seeded random
   weights, tied head): peak memory
   after the build and after the int8 head is quantized; 8 requests of
   1024-2048 tokens, 32 new tokens each, one-shot prefills, hymba's five
   runs with their launch counts and each run's peak memory; the chunked
   runs (a)-(c) over 8 requests of 1024-1536 tokens sharing their first
   512 (equal streams; prefix_pass in c); one graph window == eager; the
   decode-step profile beside its byte bound and the profile of a
   2048-token prefill beside its operation bound; a 6-layer f32 check (one
   whole local:global period, a 1280-token prefill, 4 decode steps),
   kernel vs plain and kvp 4 vs 1, fp and int8.  The paged mode
   of flash_prefill, which no serving path of the JAX package calls, runs
   as one ragged chunk step over a 40-layer granite pool (40 launches,
   counted; every layer == the fixed layout bit for bit).  The host KV
   tier and the multi-tenant front end on full-width granite-3-2b
   (``serve_tier``, paged, through ``serve_steps``, which hands the
   engine back between engine steps, so the run preempts there): (t1)
   the paged fp run's requests with two decoding requests preempted,
   spilled and restored: streams and launches equal the paged
   fp run's, no re-prefill, each spill's bytes and its gather, copy and
   put (CRC) times, each restore's verify, copy and scatter times; (t2)
   the same on the int8 path; (t3) a preempt inside top-p windows of 4:
   the window-4 streams, one capture, every window a replay; (t4) (t1)
   under each injected fault (a lost restore, a corrupt page, a full
   store, a 2-step delay): each fallback and its re-prefills counted,
   streams held to the near-tie rule against (t1) (logits kept by token,
   in runs of their own that swap in steps returning logits, each first
   held equal to its plain run), the other slots decoding while a delayed
   restore is held; (t5) 2-turn sessions of 4 requests of 256 tokens,
   chunks of 256, with and without session KV, at windows 1 and 4: window
   4 == 1, session vs sessionless by the near-tie rule (window 1 again,
   logits kept), 4 restores and no re-prefill, ``turn2_ttft_s``
   both ways; (t6) a Poisson trace of 12 requests, tenants chat
   (interactive, weight 2) and bulk (batch), under a ``VirtualClock``
   without and with the TTL governor (equal streams, sheds through clean
   spills and restores, a cap raise), then at window 4 on the wall clock
   without and with it (per-class TTL, sheds, cap raises).  Then the
   dense GQA models past 8 query heads per kv head (``serve_dense``; bf16,
   seeded random weights, untied heads): starcoder2-15b at 20 of its 40
   layers (48 q / 4 kv heads of 128, G = 12, ungated GELU): peak memory
   after the build, the int8 head and each run; hymba's five runs; the
   chunked runs (a)-(c) over 768-1024 tokens sharing 512 (prefix_pass at
   G = 12 in c); one graph window == eager; the decode-step profile beside
   its byte bound and a 1024-token prefill beside its operation bound; a
   4-layer f32 check.  llama-405b at full width with its depth cut to 8 of
   126 layers (``LLAMA_LAYERS``; 6.38 GB a layer in bf16): greedy w1,
   top-p w4, paged top-p w4 (streams equal to top-p w4's), int8 greedy
   w4 and the grouped run (c), the same profiles, a 2-layer f32 check (42
   GB in f32).  granite-8b at its full 36 layers: greedy w4 and paged
   int8 greedy w4.  Their kernels were checked in phase 3 (flash_prefill
   and flash_decode at 48/4 and 128/8 heads of 128 as at G = 5, grouped
   decode at G = 16 at 1 and 8 rows a warp, the int8 heads at K = 6144, N
   = 49152 and K = 16384, N = 128512), and phase 2 prints the registers
   and spills of flash_decode's 4-rows-a-warp instances.  Then the two
   families the engine refuses, through the step functions
   (``make_prefill_step``, ``build_serve_step``, eager
   ``build_serve_multistep``; ``step_serve``), counts zeroed just before
   each run and equal to layers x calls in every kernel mode:
   whisper-base at full width and depth (6 encoder + 6 decoder layers, 8
   heads of 64, bf16, seeded random weights): 4 rows of 1500 frame
   embeddings and 64 prompt tokens, 64 greedy tokens a row, fp and int8
   head at windows 1 and 4 (window 4 == 1 token for token); the encoder
   and the cross-attention in B2's non-causal mode, the decode step's
   cross-attention in B1's contiguous layout; the decode-step profile
   beside its byte bound; an f32 check at full depth (kernel vs plain, kvp
   4 vs 1, fp and int8).  phi-3-vision-4.2b at full width and depth (32
   layers, 32 MHA heads of 96, ~7.6 GB of bf16): 4 rows of 256 patch
   embeddings + 512 tokens, 32 greedy tokens a row: fp at windows 1 and 4
   and from a paged pool at window 4 (equal streams), the int8 KV cache,
   the int8 head; the step profile; a 4-layer f32 check.  Their kernels
   were checked in phase 3: B2 non-causal at T = S = 1500 and cross at T
   = 64 over S = 1500 (with kv lengths), B1 contiguous at kvp 1 and 4
   (pruned == dense), B2 and B1 at head size 96 as at G = 5, the int8
   heads; phase 2 prints the hsz-96 instances' registers and spills;
4b. helix ranks (``helix_ranks``): B1 per rank (``n_ranks=1, rank=k``)
   == shard k of the emulated one-launch call bit for bit at B = 8, S =
   4096, KVP 2 and 4; then ``launch/ranks.spawn`` worlds of 2 and 4 gloo
   ranks sharing the card (KVP 2; KVP 2 x TPA 2; KVP 4 is left out for
   the script's time): ``helix_attention(group=)`` == the emulated call
   bit for bit at HOP-B 1 and 2 on every rank; full-width granite-3-2b through
   the engine across the ranks (4 requests of 1024 tokens, 32 new), its
   streams held to the emulated run at the same KVP by the near-tie rule
   (prefill logits recorded, so token 0 is judged too), the same streams
   and logits on every rank, HOP-B 2 == 1 bit for bit at KVP 2 x TPA 2
   (the KVP 2 run at HOP-B 1 only, for the script's time), launches
   layers x steps x chunks (B1) and layers x prefills (B2) on each rank; TTL p50,
   host ms per step, collectives per step and their host ms, labelled
   gloo-staged on one card; ``serve_demo(world=2, dist_backend="gloo")``
   (8 new tokens: the recorded run's first 8); an NCCL group of one
   rank == the emulated kvp 1 path bit for bit (its prefill's last logits
   == the single-process ``forward(last_only=True)``'s);
4c. MoE across ranks (``moe_ranks``): granite-moe-1b-a400m at full width
   and depth (24 layers) served in one process at KVP 2 as the baseline,
   its logits and each token's routes kept (``route_run``);
   arctic-480b at full width, 2 of its 35 layers (``ARCTIC_LAYERS``; 128
   experts, top 2, a dense residual FFN, 56 q / 8 kv heads of 128, G =
   7; its kernels checked in phase 3: B2 and B1 at 56/8 heads of 128,
   fixed and paged, fp and int8, kvp 1 and 4, B3 at its head) in one
   process (``serve_arctic``): greedy w1, top-p w4, paged top-p
   w4 (== top-p w4), int8 KV + int8 head greedy w4, each with its peak
   memory, the decode-step profile beside its byte bound (every expert
   read), a prefill profile and its baseline as granite-moe's; a 1-layer
   f32 check at full width (``compare_small``: kernel vs plain, kvp 4 vs
   1, fp and int8, routes equal); then both archs over 2 and 4 gloo ranks
   sharing the card (KVP 2 x EP 2; KVP 2 x TPA 2, EP 2 x TPF 2), each rank
   drawing only its share (``init_rank_params``, smaller than the whole
   model; its bytes and peak memory printed), in bf16 (the serving runs;
   their divergence from the bf16 single-process run printed: see
   ``moe_ranks``) and in f32 (granite-moe at 12 layers, arctic at 1):
   streams and logits equal on every rank; the f32 runs held to the f32
   single-process run by the near-tie rule with routes (``route_ties``:
   up to a request's first route flip, token 0's prompt positions
   included, the logits within LOGIT_TOL and the tokens equal or parting
   at a logit near-tie; that flip at a router near-tie, within
   ROUTE_TIE), each flip and parting printed; launches B1 layers
   x steps and B2 layers x prefills on each rank, 1 all-to-all, 1 LSE
   all-gather and 2 all-reduces a layer a step and 1 head all-gather
   (HOP-B 1: HOP-B 2 == 1 is held in 4b).
   ``--ranks-only`` runs phases 1, 2, 4b and 4c alone;
5. times of each kernel, its plain version and a one-call PyTorch
   yardstick where there is one, beside the card's bound: ``ms`` and
   ``library_ms`` are device time per call with every launch queued behind
   a spin kernel (``queued_ms``), ``host_ms`` back-to-back calls between
   two events (the wrapper's host time shows there), ``device_ms`` the
   profiler's kernel records; flash_decode's working CTAs at B = 8, S =
   4096 and at the serve shape (B = 4, lengths 700-1000), prefix_pass's at
   2 groups x 4 members; flash_prefill at B = 1, T = 1024 causal, fixed and
   paged (16-position pages), and at the chunk shape B = 4, T = 256 at
   q_offset 0..768; w8a16_matmul at M = 4 with its CTAs;
   ssd_prefill at B = 1, T = 1024 with its CTAs (one per chunk and head);
   and the hymba-1.5b shapes (records ``*_hymba``): flash_prefill at G =
   5, flash_decode at the serve shape (fixed, int8, paged), ssd_prefill
   at ds 16 and w8a16_matmul at K = 1600, N = 32256; and the
   granite-moe shapes (records ``*_moe``): flash_prefill at G = 2,
   flash_decode at the serve shape and w8a16_matmul at K = 1024, N =
   49664; and the gemma3-12b shapes (records ``*_gemma3``): flash_prefill
   at B = 1, T = 2048, hsz 256 (window 1024 beside it), flash_decode at B =
   4, lengths 700-2100, window 1024 (fixed, int8 and paged), prefix_pass
   over 4 members sharing 512 positions and w8a16_matmul at K = 3840, N =
   262144; and the dense models' shapes past G = 8 (records ``*_sc2``,
   ``*_llama``, ``times_dense``); and the whisper and phi-3 shapes
   (``times_encdec_vlm``): B1 contiguous at B = 4, 1500 frames; B2
   non-causal at T = S = 1500 and cross at T = 64, S = 1500; B2 at head
   size 96, B = 1, T = 768; B1 at head size 96 fp, int8 and paged at the
   serve shape and at B = 8, S = 4096; B3 at both heads; and the
   arctic-480b shapes (records ``*_arctic``, ``times_arctic``): B2 at G =
   7, B1 at 56/8 heads of 128 (fp, int8, paged at the serve shape; fp at
   B = 8, S = 4096), B3 at its head (K = 7168, N = 32256).

The last lines are the card line, one JSON object of kernel records and
``{"ok": true, "device": {...}}``.
"""
import contextlib
import copy
import dataclasses
import gc
import itertools
import json
import os
import re
import subprocess
import sys
import time

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
if not os.path.isdir(os.path.join(HERE, "src", "repro_torch")):
    sys.exit("chip_smoke.py: src/repro_torch not found beside this script "
             "(run it from a checkout of the repository)")
sys.path.insert(0, os.path.join(HERE, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.dist import HelixGroup  # noqa: E402
from repro_torch.core.helix import (append_kv, append_kv_quant,  # noqa: E402
                                    helix_attention, quantize_kv_token)
from repro_torch.core.kvcache import (cache_capacity,  # noqa: E402
                                      init_decode_state, page_positions,
                                      quantize_decode_state, state_to_paged)
from repro_torch.core.sharding import HelixConfig  # noqa: E402
from repro_torch.kernels import build, registry  # noqa: E402
from repro_torch.kernels.flash_decode.ops import (  # noqa: E402
    decode_chunks, flash_decode_shards, flash_decode_shards_plain,
    kernel_block_s, last_launch, prefix_pass, prefix_pass_plain)
from repro_torch.kernels.pruning import (CHUNK_S,  # noqa: E402
                                         decode_work_items,
                                         prefix_work_items)
from repro_torch.kernels.flash_prefill.ops import flash_prefill  # noqa: E402
from repro_torch.kernels.flash_prefill.ref import (  # noqa: E402
    flash_prefill_paged_ref, flash_prefill_ref)
from repro_torch.kernels.ssd_prefill import (  # noqa: E402
    ssd_prefill, ssd_prefill_plain, ssd_prefill_ref)
from repro_torch.kernels.ssd_prefill.ops import chunk_spans  # noqa: E402
from repro_torch.kernels.w8a16_matmul import (quantize_w8,  # noqa: E402
                                              w8a16_matmul, w8a16_matmul_ref)
from repro_torch.kernels.w8a16_matmul.ops import (  # noqa: E402
    blocks as w8a16_blocks)
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.launch.serve import (generate_rows,  # noqa: E402
                                     prompt_tokens, serve_demo,
                                     serve_steps)
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models.decode_model import prepare_decode_params  # noqa: E402
from repro_torch.models.model_zoo import (  # noqa: E402
    build_serve_multistep, build_serve_step, finalize_chunked_prefill,
    init_prefill_buffers, make_chunk_prefill_step, make_prefill_step)
from repro_torch.models.shard import (init_rank_params,  # noqa: E402
                                      shard_model)
from repro_torch.models.transformer import (Transformer,  # noqa: E402
                                            forward, init_params,
                                            layer_windows)
from repro_torch.serving import sampling  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402
from repro_torch.serving.graph import WindowRunner  # noqa: E402
from repro_torch.serving.scheduler import (DECODE, RESTORING,  # noqa: E402
                                           Request)

HBM_BPS = 3.35e12          # H100 SXM HBM3 bytes/s (data sheet)
PEAK = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense FLOP/s
# kernel vs plain: f32 differs by summation order only; bf16 outputs are
# rounded to bf16 (8 bits of mantissa), so one ulp at |x| <= 2 is 2^-6
TOL = {torch.float32: dict(out=2e-5, lse=2e-5),
       torch.bfloat16: dict(out=1.6e-2, lse=1e-4)}
# w8a16 kernel vs plain, relative to the largest |output|: f32 differs by
# summation order only; a bf16 output may round to the neighbouring bf16
# value, one ulp = 2^-7 of its magnitude at most
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
# 4-layer f32 logits: attention differences of ~1e-6 pass through 4 layers
# of width-2048/8192 matmuls and the 49k-row tied head
LOGIT_TOL = 1e-3
# full-width bf16 logits of a chunked vs a one-shot prefill: cuBLAS may take
# another kernel for a chunk's M, so cache rows differ in their last bits and
# reach the logits through 40 layers; one bf16 ulp is 0.03-0.06 at |x| 4-8
BF16_LOGIT_TOL = 0.25
# ssd_prefill kernel vs plain (and vs the sequential oracle), relative to
# max(1, |want|): f32 products summed over chunks and states in another
# order (observed <= 1.01e-6); bf16 inputs are converted to f32 exactly on
# both sides, so the same tolerance holds
SSD_TOL = 4e-6
QH, KH, HSZ, RR = 32, 8, 64, 16
SSD_NH, SSD_HD, SSD_DS = 48, 64, 128    # mamba2-780m heads, head dim, state
D_MODEL, VP = 2048, 49664           # granite-3-2b lm_head [d_model, padded vocab]
HY_QH, HY_KH = 25, 5                # hymba-1.5b q / kv heads (G = 5)
HY_NH, HY_DS = 50, 16               # hymba-1.5b SSM heads and state (hd 64)
HY_D, HY_VP = 1600, 32256           # hymba-1.5b lm_head [d_model, padded vocab]
MOE = "granite-moe-1b-a400m"
MOE_QH, MOE_KH = 16, 8              # granite-moe q / kv heads (G = 2)
MOE_D, MOE_VP = 1024, 49664         # granite-moe lm_head [d_model, padded vocab]
GEMMA = "gemma3-12b"
GE_QH, GE_KH, GE_HSZ = 16, 8, 256   # gemma3-12b q / kv heads of 256 (G = 2)
GE_D, GE_VP = 3840, 262144          # gemma3-12b tied head [d_model, vocab]
GE_WIN = 1024                       # gemma3-12b local layers' window
GE_TL = (2100, 1500, 1100, 700)     # B1 lengths (new token in): 3 past the window
GE_CAP = 2112                       # their capacity, a multiple of 4 x 16
SC2 = "starcoder2-15b"
SC2_QH, SC2_KH = 48, 4              # starcoder2-15b q / kv heads (G = 12)
SC2_D, SC2_VP = 6144, 49152         # its untied head [d_model, vocab]
LLAMA = "llama-405b"
LL_QH, LL_KH = 128, 8               # llama-405b q / kv heads (G = 16)
LL_D, LL_VP = 16384, 128512         # its untied head [d_model, padded vocab]
LLAMA_LAYERS = 8                    # of 126: 6.38 GB a layer in bf16
G8B = "granite-8b"
DENSE_HSZ = 128                     # the head size of all three
WHISPER = "whisper-base"
WH_H, WH_HSZ = 8, 64                # whisper-base MHA heads of 64
WH_D, WH_VP = 512, 52224            # its untied head [d_model, padded vocab]
WH_S_ENC = 1500                     # 30 s of audio after the conv front end
WH_T, WH_NEW = 64, 64               # decoder prompt tokens, new tokens a row
PHI3 = "phi-3-vision-4.2b"
PH_H, PH_HSZ = 32, 96               # phi-3-vision MHA heads of 96
PH_D, PH_VP = 3072, 32256           # its untied head [d_model, padded vocab]
PH_P, PH_TEXT, PH_NEW = 256, 512, 32  # patch positions, text tokens, new
ARCTIC = "arctic-480b"
AR_QH, AR_KH = 56, 8                # arctic-480b q / kv heads of 128 (G = 7)
AR_D, AR_VP = 7168, 32256           # its untied head [d_model, padded vocab]
ARCTIC_LAYERS = 2                   # of 35: 27.3 GB a layer in bf16
# earlier paths served at half their depth, to keep the script's time
# (PERF.md section 4): mamba2 24 of 48 layers, hymba 16 of 32, moe 12 of
# 24, starcoder2 20 of 40 (granite-8b and llama-405b run its kernels too),
# gemma3 24 of 48 (4 whole local:global periods; since the ranks phase)
MAMBA_LAYERS, HYMBA_LAYERS, MOE_LAYERS, SC2_LAYERS = 24, 16, 12, 20
GEMMA_LAYERS = 24
# the MoE layer at full width, f32, card vs CPU: routes, slots and token
# plans equal; gates differ by the f32 router product's summation order
# (1024 terms, ~1e-7), y by three f32 matmuls (1024 and 512 terms) summed
# over 8 choices, relative to max(1, |y|)
ROUTE_TOL = 1e-6
MOE_TOL = 2e-5
KV8_W8 = HelixConfig(kv_cache_bits=8, lm_head_w8=True)
# the mode counters only the enc-dec path moves, 0 in every other run
NO_ENCDEC = {"flash_decode_contiguous": 0, "flash_prefill_noncausal": 0,
             "flash_prefill_cross": 0}
GRANITE_LAYERS = 40                 # granite-3-2b
WINDOW = 4                          # decode window of phase 4's window runs
TOP_P = sampling.SamplingParams("top_p", temperature=0.9, top_p=0.85, seed=7)


class SmokeFailure(RuntimeError):
    pass


def need(cond, what):
    if not cond:
        raise SmokeFailure(what)


def stamp(what):
    """A line with the script's time so far, before ``what``."""
    print(f"  -- t = {time.perf_counter() - T0:.1f} s: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warmup=5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(fn, iters=20) -> float:
    """Device time (ms) per call of ``fn``: a spin kernel
    (``torch.cuda._sleep``) holds the stream while the host enqueues
    ``iters`` calls between two events, so the calls run back to back with
    no host time between launches (unlike ``time_ms``, which measures the
    wrapper when it is slower than the kernels).  The spin lasts three
    times the enqueue time of calls after a first one (whose one-time costs,
    a library's kernel choice or a lazy init, would stretch the spin to
    seconds); a window whose enqueue outlasted its spin is measured again
    with a spin twice as long."""
    fn()                # first-call costs (kernel choice, lazy init) out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    spin_ms = max(2.0, (time.perf_counter() - t0) / 3 * iters * 3e3)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(4):
        torch.cuda._sleep(int(spin_ms * 2e6))       # ~2e6 cycles per ms
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        end.record()
        host = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if host < spin_ms:
            return start.elapsed_time(end) / iters
        spin_ms *= 2
    raise SmokeFailure(f"queued_ms: enqueueing {iters} calls took {host:.2f}"
                       f" ms, longer than every spin (last {spin_ms / 2} ms)")


def timed(fn) -> dict:
    """A kernel's times: ``ms`` its device time per call (``queued_ms``),
    ``host_ms`` back-to-back calls between two events (``time_ms``), which
    the wrapper's host time bounds from below."""
    return {"ms": queued_ms(fn), "host_ms": time_ms(fn)}


DECODE_KERNELS = ("decode_kernel", "merge_kernel")   # one flash_decode call


def device_ms(fn, keys, iters=50, warmup=5):
    """Mean device time (ms) of one call of ``fn``: the kernels whose names
    hold one of ``keys`` (a string or a tuple), from torch.profiler's
    kernel records over ``iters`` calls, each key's total divided by its
    own count of records.  The kernels alone, without the host time between
    launches that CUDA events around back-to-back calls also see.  None
    when the profiler recorded no such kernel."""
    from torch.profiler import ProfilerActivity, profile
    keys = (keys,) if isinstance(keys, str) else keys
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    total = 0.0
    for key in keys:
        ev = [e for e in rows if key in e.key]
        n = sum(e.count for e in ev)
        if n == 0:
            return None
        total += sum(getattr(e, "self_device_time_total", 0) for e in ev) / n
    return total / 1e3


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def maxerr(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def bits(t):
    """Integers as they are, f32 and bf16 as their bit patterns."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def shuffled_tables(gen, tl, page: int, max_pages: int):
    """[B, max_pages] int32 block tables (CPU) with shuffled physical pages
    1.., row b holding the ceil(tl[b] / page) pages its length needs and 0
    (the sink page) after them; and the pool size, sink included."""
    need = [-(-int(x) // page) for x in tl.tolist()]
    perm = torch.randperm(sum(need), generator=gen).to(torch.int32) + 1
    tab = torch.zeros(len(need), max_pages, dtype=torch.int32)
    i = 0
    for r, n in enumerate(need):
        tab[r, :n] = perm[i:i + n]
        i += n
    return tab, 1 + sum(need)


# ------------------------------------------------------------- phase 2
def ptxas_instances(lines, tag="Li256E"):
    """The ptxas report of each kernel instance whose mangled name holds
    ``tag`` (``Li256E``: a template argument of 256, the head size):
    ``[(name, registers, spill stores, spill loads)]``, in build order, and
    every C75xx advisory (e.g. C7514: wgmmas serialized)."""
    out, cur, notes = [], None, []
    for ln in lines:
        if "(C75" in ln:
            notes.append(ln)
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
            cur = [name, None, None, None] if tag in name else None
            if cur:
                out.append(cur)
        elif cur is not None and "spill stores" in ln:
            f = ln.replace(",", " ").split()
            cur[2] = int(f[f.index("spill") - 2])
            cur[3] = int(f[f.index("loads") - 3])
        elif cur is not None and "Used" in ln and "registers" in ln:
            f = ln.replace(",", " ").split()
            cur[1] = int(f[f.index("registers") - 1])
    return [tuple(x) for x in out], notes


# ------------------------------------------------------------- phase 3
def check_decode(dev, errs):
    g = torch.Generator(device=dev).manual_seed(1)
    b, s_cap = 8, 4096
    tl = torch.tensor([0, 1, 37, 511, 1000, 2049, 4095, 4096],
                      dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
        q, k, v = rnd(b, QH, HSZ), rnd(b, KH, s_cap, HSZ), rnd(b, KH, s_cap, HSZ)
        kn, vn = rnd(b, KH, HSZ), rnd(b, KH, HSZ)
        for kvp in (1, 4):
            for window in (0, 512):
                for fused in (False, True):
                    kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                              window=window, contiguous=False, slot_offset=0)
                    app = dict(k_new=kn, v_new=vn) if fused else \
                        dict(k_new=None, v_new=None)
                    k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
                    o1, l1 = flash_decode_shards(q, k1, v1, tl, prune=True,
                                                 **kw, **app)
                    o3, l3 = flash_decode_shards(q, k.clone(), v.clone(), tl,
                                                 prune=False, **kw, **app)
                    o2, l2 = flash_decode_shards_plain(
                        q, k2, v2, tl, scale=HSZ ** -0.5,
                        block_s=kernel_block_s(512, s_cap // kvp), **kw, **app)
                    torch.cuda.synchronize()
                    eo, el = maxerr(o1, o2), maxerr(l1, l2)
                    errs.append(eo)
                    tag = f"decode {str(dt)[6:]} kvp={kvp} window={window} fused={fused}"
                    print(f"  {tag}: max err out {eo:.3g} lse {el:.3g} "
                          f"(tol {TOL[dt]['out']:g}/{TOL[dt]['lse']:g})")
                    need(eo <= TOL[dt]["out"] and el <= TOL[dt]["lse"],
                         f"{tag}: kernel disagrees with plain")
                    need(torch.equal(o1, o3) and torch.equal(l1, l3),
                         f"{tag}: pruned != dense")
                    need(torch.equal(k1, k2) and torch.equal(v1, v2),
                         f"{tag}: appended caches differ from plain")
            # fused == unfused (rows with a token to append: length >= 1)
            tl1 = torch.clamp(tl, min=1)
            kw = dict(kvp=kvp, n_ranks=kvp, rr_block=RR)
            ka, va = k.clone(), v.clone()
            oa, la = flash_decode_shards(q, ka, va, tl1, k_new=kn, v_new=vn,
                                         **kw)
            kb, vb = k.clone(), v.clone()
            append_kv(kb, vb, kn, vn, tl1, kvp=kvp, rr_block=RR)
            ob, lb = flash_decode_shards(q, kb, vb, tl1, **kw)
            torch.cuda.synchronize()
            need(torch.equal(oa, ob) and torch.equal(la, lb)
                 and torch.equal(ka, kb) and torch.equal(va, vb),
                 f"decode {dt} kvp={kvp}: fused != unfused append")
            print(f"  decode {str(dt)[6:]} kvp={kvp}: pruned == dense and "
                  "fused == unfused, bit for bit")


def check_decode_kv8(dev, errs):
    """int8 mode: kernel vs plain (payload and scale appended as integers /
    bits), pruned == dense, fused == append_kv_quant then attend."""
    g = torch.Generator(device=dev).manual_seed(5)
    b, s_cap = 8, 4096
    tl = torch.tensor([0, 1, 37, 511, 1000, 2049, 4095, 4096],
                      dtype=torch.int32, device=dev)
    k, ks = quantize_kv_token(torch.randn(b, KH, s_cap, HSZ, generator=g,
                                          device=dev))
    v, vs = quantize_kv_token(torch.randn(b, KH, s_cap, HSZ, generator=g,
                                          device=dev))
    for dt in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
        q, kn, vn = rnd(b, QH, HSZ), rnd(b, KH, HSZ), rnd(b, KH, HSZ)
        for kvp in (1, 4):
            for fused in (False, True):
                kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                          window=0, contiguous=False, slot_offset=0)
                app = dict(k_new=kn, v_new=vn) if fused else \
                    dict(k_new=None, v_new=None)
                c1, c2, c3 = ([t.clone() for t in (k, v, ks, vs)]
                              for _ in range(3))
                o1, l1 = flash_decode_shards(q, c1[0], c1[1], tl,
                                             kscale=c1[2], vscale=c1[3],
                                             prune=True, **kw, **app)
                o3, l3 = flash_decode_shards(q, c3[0], c3[1], tl,
                                             kscale=c3[2], vscale=c3[3],
                                             prune=False, **kw, **app)
                o2, l2 = flash_decode_shards_plain(
                    q, c2[0], c2[1], tl, scale=HSZ ** -0.5,
                    block_s=kernel_block_s(512, s_cap // kvp), kscale=c2[2],
                    vscale=c2[3], **kw, **app)
                torch.cuda.synchronize()
                eo, el = maxerr(o1, o2), maxerr(l1, l2)
                errs.append(eo)
                tag = f"decode kv8 {str(dt)[6:]} kvp={kvp} fused={fused}"
                print(f"  {tag}: max err out {eo:.3g} lse {el:.3g} "
                      f"(tol {TOL[dt]['out']:g}/{TOL[dt]['lse']:g})")
                need(eo <= TOL[dt]["out"] and el <= TOL[dt]["lse"],
                     f"{tag}: kernel disagrees with plain")
                need(torch.equal(o1, o3) and torch.equal(l1, l3),
                     f"{tag}: pruned != dense")
                need(all(torch.equal(bits(a), bits(p)) and
                         torch.equal(bits(a), bits(d))
                         for a, p, d in zip(c1, c2, c3)),
                     f"{tag}: appended payload/scale differ from plain")
            # fused == unfused (rows with a token to append: length >= 1)
            tl1 = torch.clamp(tl, min=1)
            kw = dict(kvp=kvp, n_ranks=kvp, rr_block=RR)
            ca = [t.clone() for t in (k, v, ks, vs)]
            oa, la = flash_decode_shards(q, ca[0], ca[1], tl1, kscale=ca[2],
                                         vscale=ca[3], k_new=kn, v_new=vn,
                                         **kw)
            cb = [t.clone() for t in (k, v, ks, vs)]
            append_kv_quant(*cb, kn, vn, tl1, kvp=kvp, rr_block=RR)
            ob, lb = flash_decode_shards(q, cb[0], cb[1], tl1, kscale=cb[2],
                                         vscale=cb[3], **kw)
            torch.cuda.synchronize()
            need(torch.equal(oa, ob) and torch.equal(la, lb)
                 and all(torch.equal(bits(x), bits(y))
                         for x, y in zip(ca, cb)),
                 f"decode kv8 {dt} kvp={kvp}: fused != unfused append")
            print(f"  decode kv8 {str(dt)[6:]} kvp={kvp}: pruned == dense and "
                  "fused == unfused (payloads as integers, scales as bits), "
                  "bit for bit")


def check_decode_paged(dev, errs, errs_kv8):
    """Paged mode over its lattice (f32, bf16 and int8; kvp 1 and 4; fused
    and unfused; a shuffled table with 0 tails): kernel vs plain within the
    tolerance, pruned == dense, and paged == fixed bit for bit -- the same
    cache laid out both ways (``state_to_paged``), outputs, LSEs and the
    appended pages (payloads as integers, scales as bits) compared, the
    sink page 0 left out; then fused == unfused in paged mode."""
    g = torch.Generator(device=dev).manual_seed(7)
    gt = torch.Generator().manual_seed(8)
    b, s_cap = 8, 4096
    tl = torch.tensor([0, 1, 37, 511, 1000, 2049, 4095, 4096],
                      dtype=torch.int32, device=dev)
    for mode in ("f32", "bf16", "int8"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
        q, kn, vn = rnd(b, QH, HSZ), rnd(b, KH, HSZ), rnd(b, KH, HSZ)
        fixed = {"kcache": rnd(1, b, KH, s_cap, HSZ),
                 "vcache": rnd(1, b, KH, s_cap, HSZ)}
        if mode == "int8":
            fixed = quantize_decode_state(fixed)
        keys = [k for k in ("kcache", "vcache", "kscale", "vscale")
                if k in fixed]
        for kvp in (1, 4):
            page = page_positions(kvp, RR)
            tab, n_pool = shuffled_tables(gt, tl, page, s_cap // page)
            paged = state_to_paged(fixed, tab, n_pool, kvp, page)
            tables = paged["block_tables"]
            kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR, window=0,
                      contiguous=False, slot_offset=0)

            def planes(st):
                c = [st[k][0].clone() for k in keys]
                return c, (dict(kscale=c[2], vscale=c[3]) if len(c) == 4
                           else {})

            def same_pages(c, d):      # pool planes without the sink page
                return all(torch.equal(bits(x[1:]), bits(y[1:]))
                           for x, y in zip(c, d))

            for fused in (False, True):
                app = dict(k_new=kn, v_new=vn) if fused else \
                    dict(k_new=None, v_new=None)
                (c1, s1), (c2, s2), (c3, s3), (cf, sf) = (
                    planes(paged), planes(paged), planes(paged), planes(fixed))
                o1, l1 = flash_decode_shards(q, c1[0], c1[1], tl, prune=True,
                                             block_tables=tables, **s1, **kw,
                                             **app)
                o3, l3 = flash_decode_shards(q, c3[0], c3[1], tl, prune=False,
                                             block_tables=tables, **s3, **kw,
                                             **app)
                o2, l2 = flash_decode_shards_plain(
                    q, c2[0], c2[1], tl, scale=HSZ ** -0.5,
                    block_s=kernel_block_s(512, s_cap // kvp),
                    block_tables=tables, **s2, **kw, **app)
                of, lf = flash_decode_shards(q, cf[0], cf[1], tl, prune=True,
                                             **sf, **kw, **app)
                torch.cuda.synchronize()
                eo, el = maxerr(o1, o2), maxerr(l1, l2)
                (errs_kv8 if mode == "int8" else errs).append(eo)
                tag = f"paged decode {mode} kvp={kvp} fused={fused}"
                print(f"  {tag}: max err out {eo:.3g} lse {el:.3g} "
                      f"(tol {TOL[dt]['out']:g}/{TOL[dt]['lse']:g})")
                need(eo <= TOL[dt]["out"] and el <= TOL[dt]["lse"],
                     f"{tag}: kernel disagrees with plain")
                need(torch.equal(bits(o1), bits(o3))
                     and torch.equal(bits(l1), bits(l3)),
                     f"{tag}: pruned != dense")
                need(same_pages(c1, c2) and same_pages(c1, c3),
                     f"{tag}: appended pages differ from plain / dense")
                back = state_to_paged({k: c[None] for k, c in zip(keys, cf)},
                                      tab, n_pool, kvp, page)
                need(torch.equal(bits(o1), bits(of))
                     and torch.equal(bits(l1), bits(lf))
                     and same_pages(c1, [back[k][0] for k in keys]),
                     f"{tag}: paged != fixed")
            # fused == unfused (rows with a token to append: length >= 1)
            tl1 = torch.clamp(tl, min=1)
            kw = dict(kvp=kvp, n_ranks=kvp, rr_block=RR, block_tables=tables)
            (ca, sa), (cb, sb) = planes(paged), planes(paged)
            oa, la = flash_decode_shards(q, ca[0], ca[1], tl1, k_new=kn,
                                         v_new=vn, **sa, **kw)
            if mode == "int8":
                append_kv_quant(*cb, kn, vn, tl1, kvp=kvp, rr_block=RR,
                                block_tables=tables)
            else:
                append_kv(cb[0], cb[1], kn, vn, tl1, kvp=kvp, rr_block=RR,
                          block_tables=tables)
            ob, lb = flash_decode_shards(q, cb[0], cb[1], tl1, **sb, **kw)
            torch.cuda.synchronize()
            need(torch.equal(bits(oa), bits(ob)) and torch.equal(bits(la),
                                                                 bits(lb))
                 and same_pages(ca, cb),
                 f"paged decode {mode} kvp={kvp}: fused != unfused append")
            print(f"  paged decode {mode} kvp={kvp} ({n_pool} pages, shuffled"
                  "): pruned == dense, paged == fixed and fused == unfused, "
                  "bit for bit")


def grouped_case(gen, gt, dev, *, mode, kvp, whole):
    """Paged operands of a grouped decode at granite widths, B = 8: rows 0-3
    share 33 pages and rows 4-6 share 20, row 7 decodes alone (``whole``:
    all 8 share 17); every row has 1-299 positions of its own after the
    shared ones (the appended row lands there).  33 and 17 pages of 16
    rows per rank put the split inside a tile."""
    dt = torch.float32 if mode == "f32" else torch.bfloat16
    page = page_positions(kvp, RR)
    gid = [0] * 8 if whole else [0, 0, 0, 0, 4, 4, 4, 7]
    npg = {0: 17} if whole else {0: 33, 4: 20, 7: 0}
    tl = [npg[gid[i]] * page + int(x) for i, x in
          enumerate(torch.randint(1, 300, (8,), generator=gt))]
    need = [-(-t // page) for t in tl]
    mp = max(need)
    perm = (torch.randperm(sum(need), generator=gt) + 1).tolist()
    common = {gr: [perm.pop() for _ in range(n)] for gr, n in npg.items()}
    tab = torch.zeros(8, mp, dtype=torch.int32)
    for i in range(8):
        row = common[gid[i]] + [perm.pop() for _ in range(need[i]
                                                         - npg[gid[i]])]
        tab[i, :need[i]] = torch.tensor(row, dtype=torch.int32)
    n_pool = 1 + sum(need)
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(dt)
    cache = {"kcache": rnd(n_pool, KH, page, HSZ),
             "vcache": rnd(n_pool, KH, page, HSZ)}
    if mode == "int8":
        cache = quantize_decode_state(cache)
    gnp = [npg[gid[i]] if gid.count(gid[i]) > 1 else 0 for i in range(8)]
    as_dev = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return dict(q=rnd(8, QH, HSZ), kn=rnd(8, KH, HSZ), vn=rnd(8, KH, HSZ),
                tl=as_dev(tl), tab=tab.to(dev), cache=cache,
                groups=(as_dev(gid), as_dev(gnp)), mp=mp)


def check_grouped(dev, errs):
    """Grouped decode: prefix_pass then flash_decode's grouped-suffix mode,
    with the fused append, against the ungrouped paged kernel (outputs,
    LSEs and appended pages bit for bit) and the plain grouped decode
    (within the tolerance): f32, bf16, int8; kvp 1 and 4; windows 0 and
    512; two groups and a loner, then one group of the whole batch."""
    gen = torch.Generator(device=dev).manual_seed(11)
    gt = torch.Generator().manual_seed(12)
    for mode in ("f32", "bf16", "int8"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        for kvp in (1, 4):
            for whole in (False, True):
                c = grouped_case(gen, gt, dev, mode=mode, kvp=kvp,
                                 whole=whole)
                keys = [k for k in ("kcache", "vcache", "kscale", "vscale")
                        if k in c["cache"]]
                for window in (0, 512):
                    kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                              window=window, block_tables=c["tab"],
                              k_new=c["kn"], v_new=c["vn"])

                    def run(fn, groups, **extra):
                        p = [c["cache"][k].clone() for k in keys]
                        sc = (dict(kscale=p[2], vscale=p[3]) if len(p) == 4
                              else {})
                        o, l = fn(c["q"], p[0], p[1], c["tl"], groups=groups,
                                  **sc, **kw, **extra)
                        return o, l, p

                    og, lg, pg = run(flash_decode_shards, c["groups"])
                    of, lf, pf = run(flash_decode_shards, None)
                    op, lp, pp = run(
                        flash_decode_shards_plain, c["groups"],
                        scale=HSZ ** -0.5, contiguous=False, slot_offset=0,
                        block_s=kernel_block_s(512, c["mp"] * RR))
                    torch.cuda.synchronize()
                    eo, el = maxerr(og, op), maxerr(lg, lp)
                    errs.append(eo)
                    tag = (f"grouped decode {mode} kvp={kvp} window={window}"
                           f" {'whole batch' if whole else '2 groups + 1'}")
                    print(f"  {tag}: max err out {eo:.3g} lse {el:.3g} "
                          f"(tol {TOL[dt]['out']:g}/{TOL[dt]['lse']:g})")
                    need(eo <= TOL[dt]["out"] and el <= TOL[dt]["lse"],
                         f"{tag}: kernel disagrees with plain")
                    need(torch.equal(bits(og), bits(of))
                         and torch.equal(bits(lg), bits(lf)),
                         f"{tag}: grouped != ungrouped")
                    need(all(torch.equal(bits(a[1:]), bits(b[1:]))
                             and torch.equal(bits(a[1:]), bits(d[1:]))
                             for a, b, d in zip(pg, pf, pp)),
                         f"{tag}: appended pages differ")
        print(f"  grouped decode {mode}: grouped == ungrouped (outputs, LSEs,"
              " appended pages) bit for bit in every case")


def check_decode_chunks(dev, errs, errs_kv8):
    """Chunk boundaries of the split sweep (chunks of CHUNK_S = 256 local
    slots): per rank, lengths ending on a chunk boundary (256, 512), one
    slot past it (the appended row lands in the next chunk's first slot),
    mid-chunk, with windows 0 and 300 (starting mid-chunk); f32, bf16 and
    int8, kvp 1 and 4: kernel vs plain within TOL, and pruned == dense,
    fused == unfused and paged == fixed bit for bit (outputs, LSEs, caches);
    then a grouped decode of 8 rows sharing 21 pages (split tile 10: inside
    a chunk and a tile) beside rows ending on and one past a chunk
    boundary, == ungrouped bit for bit."""
    g = torch.Generator(device=dev).manual_seed(16)
    gt = torch.Generator().manual_seed(17)
    b, s_loc = 6, 1024
    for mode in ("f32", "bf16", "int8"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        rnd = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(dt)
        for kvp in (1, 4):
            tl = torch.tensor([256, 257, 512, 513, 700, 1000], dtype=torch.int32,
                              device=dev) * kvp
            tl[1] = 256 * kvp + 1
            tl[3] = 512 * kvp + 1
            q, kn, vn = rnd(b, QH, HSZ), rnd(b, KH, HSZ), rnd(b, KH, HSZ)
            fixed = {"kcache": rnd(1, b, KH, kvp * s_loc, HSZ),
                     "vcache": rnd(1, b, KH, kvp * s_loc, HSZ)}
            if mode == "int8":
                fixed = quantize_decode_state(fixed)
            keys = [k for k in ("kcache", "vcache", "kscale", "vscale")
                    if k in fixed]
            page = page_positions(kvp, RR)
            tab, n_pool = shuffled_tables(gt, tl, page, s_loc // RR)
            paged = state_to_paged(fixed, tab, n_pool, kvp, page)
            tables = paged["block_tables"]

            def planes(st):
                c = [st[k][0].clone() for k in keys]
                return c, (dict(kscale=c[2], vscale=c[3]) if len(c) == 4
                           else {})

            for window in (0, 300):
                kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                          window=window, contiguous=False, slot_offset=0,
                          k_new=kn, v_new=vn)
                (c1, s1), (c2, s2), (c3, s3), (cp, sp) = (
                    planes(fixed), planes(fixed), planes(fixed), planes(paged))
                o1, l1 = flash_decode_shards(q, c1[0], c1[1], tl, **s1, **kw)
                o3, l3 = flash_decode_shards(q, c3[0], c3[1], tl, prune=False,
                                             **s3, **kw)
                op, lp = flash_decode_shards(q, cp[0], cp[1], tl,
                                             block_tables=tables, **sp, **kw)
                o2, l2 = flash_decode_shards_plain(
                    q, c2[0], c2[1], tl, scale=HSZ ** -0.5,
                    block_s=kernel_block_s(512, s_loc), **s2, **kw)
                torch.cuda.synchronize()
                eo, el = maxerr(o1, o2), maxerr(l1, l2)
                (errs_kv8 if mode == "int8" else errs).append(eo)
                tag = f"chunk edges {mode} kvp={kvp} window={window}"
                print(f"  {tag}: max err out {eo:.3g} lse {el:.3g} "
                      f"(tol {TOL[dt]['out']:g}/{TOL[dt]['lse']:g})")
                need(eo <= TOL[dt]["out"] and el <= TOL[dt]["lse"],
                     f"{tag}: kernel disagrees with plain")
                need(torch.equal(bits(o1), bits(o3))
                     and torch.equal(bits(l1), bits(l3)), f"{tag}: pruned != dense")
                need(all(torch.equal(bits(x), bits(y)) and
                         torch.equal(bits(x), bits(z))
                         for x, y, z in zip(c1, c2, c3)),
                     f"{tag}: appended caches differ from plain / dense")
                back = state_to_paged({k: c[None] for k, c in zip(keys, c1)},
                                      tab, n_pool, kvp, page)
                need(torch.equal(bits(o1), bits(op))
                     and torch.equal(bits(l1), bits(lp))
                     and all(torch.equal(bits(x[1:]), bits(back[k][0][1:]))
                             for x, k in zip(cp, keys)),
                     f"{tag}: paged != fixed")
                cu, su = planes(fixed)
                if mode == "int8":
                    append_kv_quant(*cu, kn, vn, tl, kvp=kvp, rr_block=RR)
                else:
                    append_kv(cu[0], cu[1], kn, vn, tl, kvp=kvp, rr_block=RR)
                ou, lu = flash_decode_shards(
                    q, cu[0], cu[1], tl, **su,
                    **dict(kw, k_new=None, v_new=None))
                torch.cuda.synchronize()
                need(torch.equal(bits(o1), bits(ou))
                     and torch.equal(bits(l1), bits(lu))
                     and all(torch.equal(bits(x), bits(y))
                             for x, y in zip(c1, cu)),
                     f"{tag}: fused != unfused append")
            # grouped: all 8 rows share 21 pages; split tile 10 of chunk 1
            page_n, shared = s_loc // RR, 21
            gtl = torch.tensor([512, 513, 337, 768, 1000, 600, 700, 900],
                               dtype=torch.int32) * kvp
            gtl[1] = 512 * kvp + 1
            gtl[2] = 336 * kvp + 1
            gtab = torch.zeros(8, page_n, dtype=torch.int32)
            perm = (torch.randperm(8 * page_n, generator=gt) + 1).tolist()
            common = [perm.pop() for _ in range(shared)]
            for i in range(8):
                gtab[i] = torch.tensor(common + [perm.pop() for _ in
                                                 range(page_n - shared)])
            gpool = {"kcache": rnd(1 + 8 * page_n, KH, page, HSZ),
                     "vcache": rnd(1 + 8 * page_n, KH, page, HSZ)}
            if mode == "int8":
                gpool = quantize_decode_state(gpool)
            groups = (torch.zeros(8, dtype=torch.int32, device=dev),
                      torch.full((8,), shared, dtype=torch.int32, device=dev))
            gq, gkn = rnd(8, QH, HSZ), rnd(8, KH, HSZ)
            gtl, gtab = gtl.to(dev), gtab.to(dev)
            for window in (0, 300):
                kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                          window=window, block_tables=gtab, k_new=gkn,
                          v_new=gkn)
                res = []
                for grp in (groups, None):
                    pl = [gpool[k].clone() for k in keys]
                    sc = (dict(kscale=pl[2], vscale=pl[3]) if len(pl) == 4
                          else {})
                    res.append((flash_decode_shards(gq, pl[0], pl[1], gtl,
                                                    groups=grp, **sc, **kw),
                                pl))
                torch.cuda.synchronize()
                (og, lg), pg = res[0]
                (of, lf), pf = res[1]
                need(torch.equal(bits(og), bits(of))
                     and torch.equal(bits(lg), bits(lf))
                     and all(torch.equal(bits(x[1:]), bits(y[1:]))
                             for x, y in zip(pg, pf)),
                     f"chunk edges grouped {mode} kvp={kvp} window={window}: "
                     "grouped != ungrouped")
        print(f"  chunk edges {mode}: pruned == dense, fused == unfused, "
              "paged == fixed and grouped (split inside a chunk) == "
              "ungrouped, bit for bit")


def check_w8a16(dev, errs):
    """B3 vs plain at the lm_head shape for M = 1, 2, 4 and 8 (one pass over
    the weights), a K of 2053 (a ragged last step, warps of unequal step
    counts), a ragged N (byte loads) and M = 9 (two M tiles)."""
    g = torch.Generator(device=dev).manual_seed(6)
    for m, k, n in ((1, D_MODEL, VP), (2, D_MODEL, VP), (4, D_MODEL, VP),
                    (8, D_MODEL, VP), (4, 2053, VP), (3, 200, 700),
                    (9, 130, 257)):
        qw, scale = quantize_w8(torch.randn(k, n, generator=g, device=dev))
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(m, k, generator=g, device=dev).to(dt)
            got = w8a16_matmul(x, qw, scale)
            want = w8a16_matmul_ref(x, qw, scale)
            torch.cuda.synchronize()
            e = maxerr(got, want)
            top = want.float().abs().max().item()
            errs.append(e)
            tag = f"w8a16 {str(dt)[6:]} M={m} K={k} N={n}"
            print(f"  {tag} ({w8a16_blocks(m, n)} CTAs): max err {e:.3g} (|out| <= "
                  f"{top:.3g}, tol {MM_TOL[dt]:g} x |out|)")
            need(got.dtype == dt and got.shape == (m, n)
                 and e <= MM_TOL[dt] * top, f"{tag}: kernel disagrees")


def prefill_pool(x, tab, n_pool, page, garbage):
    """Fixed-layout K or V [B, S, Kh, hsz] -> one layer's pool planes
    [n_pool, Kh, page, hsz] under ``tab``; the sink page 0 and every page
    no row maps hold ``garbage``."""
    b, s, kh, hsz = x.shape
    pages = x.reshape(b, s // page, page, kh, hsz).transpose(2, 3)
    pool = garbage.to(x.dtype).expand(n_pool, kh, page, hsz).clone()
    live = tab > 0
    pool[tab[live].long()] = pages[live]
    return pool


def sink_garbage(gen, dev, page, hsz=HSZ):
    """Finite garbage of magnitude 1e4 for the sink page, [page, hsz]."""
    return 1e4 * torch.sign(torch.randn(page, hsz, generator=gen,
                                        device=dev) + 0.1)


def check_prefill(dev, errs, errs_paged):
    """B2 at granite widths: fixed and paged (16-position pages, a shuffled
    table, a sink page of +-1e4) against the plain versions, f32 and bf16,
    windows 0 and 256, per-request offsets and lengths; paged == fixed bit
    for bit at pages 16 and 64; rows of 4 chunk calls == the same rows of
    one call, bit for bit, fixed and paged; lens == 0 rows are zero."""
    g = torch.Generator(device=dev).manual_seed(2)
    b, t = 2, 1024
    lens = torch.tensor([1024, 700], dtype=torch.int32, device=dev)
    offs = torch.tensor([0, 37], dtype=torch.int32, device=dev)
    tabs = {page: shuffled_tables(torch.Generator().manual_seed(page), lens,
                                  page, t // page) for page in (16, 64)}
    for dt in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
        q, k, v = rnd(b, t, QH, HSZ), rnd(b, t, KH, HSZ), rnd(b, t, KH, HSZ)
        pools = {}
        for page, (tab, n_pool) in tabs.items():
            junk = sink_garbage(g, dev, page)
            tab = tab.to(dev)
            pools[page] = (tab, prefill_pool(k, tab, n_pool, page, junk),
                           prefill_pool(v, tab, n_pool, page, -junk))
        for window in (0, 256):
            kw = dict(causal=True, window=window, q_offset=offs,
                      seq_lens=lens)
            o1 = flash_prefill(q, k, v, **kw)
            o2 = flash_prefill_ref(q, k, v, **kw)
            tab, pk, pv = pools[16]
            o3 = flash_prefill(q, pk, pv, block_tables=tab, **kw)
            o4 = flash_prefill_paged_ref(q, pk, pv, tab, lens, causal=True,
                                         window=window, q_offset=offs)
            o5 = flash_prefill(q, *pools[64][1:], block_tables=pools[64][0],
                               **kw)
            torch.cuda.synchronize()
            for tag, e, lst in (("", maxerr(o1, o2), errs),
                                (" paged", maxerr(o3, o4), errs_paged)):
                lst.append(e)
                tag = f"prefill{tag} {str(dt)[6:]} window={window}"
                print(f"  {tag}: max err {e:.3g} (tol {TOL[dt]['out']:g})")
                need(e <= TOL[dt]["out"],
                     f"{tag}: kernel disagrees with plain")
            same = (torch.equal(bits(o1), bits(o3))
                    and torch.equal(bits(o1), bits(o5)))
            print(f"  prefill {str(dt)[6:]} window={window}: paged (pages 16"
                  f" and 64, garbage sink page) == fixed bit for bit: {same}")
            need(same, "prefill: paged != fixed")
        z = torch.tensor([0, 5], dtype=torch.int32, device=dev)
        zf = flash_prefill(q, k, v, causal=True, seq_lens=z)
        zp = flash_prefill(q, *pools[16][1:], block_tables=pools[16][0],
                           causal=True, seq_lens=z)
        torch.cuda.synchronize()
        need(all(torch.isfinite(x).all().item() and x[0].abs().max().item()
                 == 0 for x in (zf, zp)),
             "prefill: a lens == 0 row is not zero")
    # chunks == one-shot: bf16, one request of 1024 tokens
    rnd = lambda *s: torch.randn(*s, generator=g,
                                 device=dev).to(torch.bfloat16)
    q, k, v = rnd(1, t, QH, HSZ), rnd(1, t, KH, HSZ), rnd(1, t, KH, HSZ)
    full = torch.tensor([t], dtype=torch.int32, device=dev)
    tab, n_pool = shuffled_tables(torch.Generator().manual_seed(3), full, 16,
                                  t // 16)
    tab = tab.to(dev)
    junk = sink_garbage(g, dev, 16)
    paged = dict(block_tables=tab)
    for mode, kv, extra in (("fixed", (k, v), {}),
                            ("paged", (prefill_pool(k, tab, n_pool, 16, junk),
                                       prefill_pool(v, tab, n_pool, 16, junk)),
                             paged)):
        one = flash_prefill(q, *kv, seq_lens=full, **extra)
        parts = [flash_prefill(q[:, o:o + 256].contiguous(), *kv, q_offset=o,
                               seq_lens=torch.tensor([o + 256],
                                                     dtype=torch.int32,
                                                     device=dev), **extra)
                 for o in range(0, t, 256)]
        torch.cuda.synchronize()
        same = torch.equal(bits(torch.cat(parts, 1)), bits(one))
        print(f"  prefill bf16 {mode}: rows of 4 chunk calls (T 256 at "
              f"q_offset 0/256/512/768) == one T 1024 call bit for bit: "
              f"{same}")
        need(same, f"prefill {mode}: chunk rows != one-shot rows")


def ssd_inputs(g, dev, b, t, dtype, groups=1, nh=SSD_NH, hd=SSD_HD,
               ds=SSD_DS):
    """SSD scan inputs, at mamba2-780m widths unless given: x and B/C in
    ``dtype``, dt softplus'd, a < 0, d = 1, and a nonzero initial state."""
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    args = (rnd(b, t, nh, hd).to(dtype),
            F.softplus(rnd(b, t, nh) - 1.0), -torch.exp(rnd(nh) * 0.3),
            (rnd(b, t, groups, ds) * 0.5).to(dtype),
            (rnd(b, t, groups, ds) * 0.5).to(dtype),
            torch.ones(nh, device=dev))
    return args, rnd(b, nh, hd, ds) * 0.2


def ssd_err(tag, got, want, errs):
    """Max abs error of (y, h) against (y, h), held at SSD_TOL x max(1,
    |want|) each."""
    msg = []
    for name, a, b in (("y", got[0], want[0]), ("h", got[1], want[1])):
        e, top = maxerr(a, b), b.abs().max().item()
        errs.append(e)
        need(e <= SSD_TOL * max(1.0, top),
             f"{tag}: {name} max err {e:.3g} above {SSD_TOL:g} x "
             f"max(1, {top:.3g})")
        msg.append(f"{name} {e:.3g} (|{name}| <= {top:.3g})")
    return ", ".join(msg)


def check_ssd(dev, errs):
    """ssd_prefill vs its plain version (and, for T <= 65, the sequential
    oracle) at the serve widths: T = 1 and 65 (one token past a chunk), a
    ragged 37, B = 4 at T = 1024 and a fold across 64 chunks (T = 4096);
    two halves chained through h_final == one pass, bit for bit at a split
    on the chunk grid (512) and within the tolerance off it (500); grouped
    == repeated; states wider than the 8 warps' first round of 16 x 64
    tiles (hd 128 ds 128, hd 64 ds 256: 16 tiles each)."""
    g = torch.Generator(device=dev).manual_seed(11)
    for dt in (torch.float32, torch.bfloat16):
        for b, t in ((1, 1), (1, 64), (1, 65), (2, 37), (1, 1024), (4, 1024),
                     (1, 4096)):
            args, h0 = ssd_inputs(g, dev, b, t, dt)
            got = ssd_prefill(*args, h0=h0)
            want = ssd_prefill_plain(*args, h0=h0)
            torch.cuda.synchronize()
            tag = f"ssd {str(dt)[6:]} B={b} T={t}"
            msg = ssd_err(tag, got, want, errs)
            if t <= 65:
                msg += "; vs the sequential oracle " + ssd_err(
                    tag, got, ssd_prefill_ref(*args, h0=h0), errs)
            print(f"  {tag} (nh {SSD_NH}, hd {SSD_HD}, ds {SSD_DS}, "
                  f"{len(chunk_spans(t, 64))} chunks, from a nonzero state): "
                  f"max err {msg} (tol {SSD_TOL:g} x max(1, |want|))")
            if (b, t) != (1, 1024):
                continue
            for cut in (512, 500):
                parts = [(a[:, :cut], a[:, cut:]) if a.ndim > 1 else (a, a)
                         for a in args]
                y1, h1 = ssd_prefill(*(p[0].contiguous() for p in parts),
                                     h0=h0)
                y2, h2 = ssd_prefill(*(p[1].contiguous() for p in parts),
                                     h0=h1)
                torch.cuda.synchronize()
                two = (torch.cat([y1, y2], 1), h2)
                if cut % 64 == 0:
                    same = all(torch.equal(bits(u), bits(v))
                               for u, v in zip(two, got))
                    print(f"  {tag}: two halves split at {cut} (on the chunk"
                          f" grid) chained through h_final == one pass bit "
                          f"for bit: {same}")
                    need(same, f"{tag}: split at {cut} != one pass")
                else:
                    print(f"  {tag}: two halves split at {cut} (off the "
                          "chunk grid) chained through h_final vs one pass: "
                          + ssd_err(f"{tag} split {cut}", two, got, errs))
        args, h0 = ssd_inputs(g, dev, 1, 300, dt, groups=2)
        x, dtv, a, bm, cm, d = args
        rep = lambda m: m.repeat_interleave(SSD_NH // 2, dim=2)
        grouped = ssd_prefill(*args, h0=h0)
        repeated = ssd_prefill(x, dtv, a, rep(bm), rep(cm), d, h0=h0)
        torch.cuda.synchronize()
        tag = f"ssd {str(dt)[6:]} T=300 2 groups"
        msg = ssd_err(tag, grouped, ssd_prefill_plain(*args, h0=h0), errs)
        need(torch.equal(bits(grouped[0]), bits(repeated[0]))
             and torch.equal(bits(grouped[1]), bits(repeated[1])),
             f"{tag}: groups read directly != the repeated form")
        print(f"  {tag}: vs plain {msg}; == the repeated B/C form, bit for "
              "bit")
        for hd, ds in ((128, 128), (64, 256)):
            args, h0 = ssd_inputs(g, dev, 2, 200, dt, groups=2, nh=8, hd=hd,
                                  ds=ds)
            got = ssd_prefill(*args, h0=h0)
            torch.cuda.synchronize()
            tag = f"ssd {str(dt)[6:]} B=2 T=200 nh 8 hd {hd} ds {ds}"
            print(f"  {tag}: vs plain " + ssd_err(
                tag, got, ssd_prefill_plain(*args, h0=h0), errs))


def check_moe_ffn(dev):
    """The MoE layer at granite-moe's full width (E 32, top 8, H 1024, Fe
    512, f32, weights by ``moe.init_moe``) on the card against the same
    layer on the CPU, the same inputs: T = 4 at the decode capacity factor
    (4.0) and T = 1024 at the prefill's (1.25).  ``expert_idx``,
    ``slot_of`` and ``tok_of`` equal; gates within ROUTE_TOL, the aux loss
    within ROUTE_TOL and y within MOE_TOL x max(1, |y|).  Prints the
    dropped assignments at T = 1024."""
    cfg = get_config(MOE)
    m = cfg.moe
    card = moe_lib.MoEParams(m, cfg.d_model).to(dev)
    moe_lib.init_moe(card, m, cfg.d_model, 31)
    cpu = copy.deepcopy(card).cpu()
    g = torch.Generator(device=dev).manual_seed(32)
    for t, cf in ((4, m.decode_capacity_factor), (1024, m.capacity_factor)):
        x = torch.randn(t, cfg.d_model, generator=g, device=dev)
        cap = moe_lib.capacity(t, m, cf)
        out = {}
        for where, mp, xs in (("card", card, x), ("cpu", cpu, x.cpu())):
            r = moe_lib.route(mp.router, xs, m)
            slot, tok = moe_lib.dispatch_plan(r.expert_idx, m.n_experts, cap)
            y, aux = moe_lib.moe_ffn(mp, xs, m, F.silu, capacity_factor=cf)
            out[where] = [v.cpu() for v in (r.expert_idx, r.gates, slot, tok,
                                            y, aux)]
        (ci, cg, cs, ct, cy, ca), (hi, hg, hs, ht, hy, ha) = (out["card"],
                                                              out["cpu"])
        tag = f"moe_ffn T={t} cf {cf:g} (cap {cap})"
        p = torch.softmax(x.cpu() @ cpu.router, -1).sort(-1, True).values
        flips = route_flips(f"{tag} card vs CPU", [(ci, None)],
                            [(hi, p[:, m.topk - 1] - p[:, m.topk])], 1)
        need(not flips, f"{tag}: {flips} tokens routed otherwise on the card")
        need(torch.equal(cs, hs) and torch.equal(ct, ht),
             f"{tag}: slot_of / tok_of differ between card and CPU")
        eg, ea, ey = maxerr(cg, hg), maxerr(ca, ha), maxerr(cy, hy)
        top = hy.abs().max().item()
        dropped = int((hs >= cap).sum())
        print(f"  {tag}, E {m.n_experts} top {m.topk} H {cfg.d_model} Fe "
              f"{m.d_ff} f32, card vs CPU: routes, slots and token plans "
              f"equal; gates max err {eg:.3g}, aux {ea:.3g} (tol "
              f"{ROUTE_TOL:g}), y {ey:.3g} (|y| <= {top:.3g}, tol "
              f"{MOE_TOL:g} x max(1, |y|)); {dropped} of {t * m.topk} "
              "assignments dropped")
        need(eg <= ROUTE_TOL and ea <= ROUTE_TOL
             and ey <= MOE_TOL * max(1.0, top), f"{tag}: card disagrees")
        if t == 4:
            need(dropped == 0, f"{tag}: a decode assignment was dropped")


def check_sampler(dev):
    """The on-device sampler (plain PyTorch on the card: the JAX package
    computes it outside any Pallas kernel) at the lm_head shape, B = 4,
    V = 49155: its threefry words, uniforms and Gumbel noise on the card
    equal its plain run on the CPU bit for bit, and so do its tokens over
    greedy, top-k, top-p and top-k + top-p rows."""
    gen = torch.Generator().manual_seed(21)
    b, v = 4, 49155
    seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen)
    idx = torch.randint(0, 5000, (b,), generator=gen).to(torch.int32)
    key = sampling.fold_in(sampling.prng_key(seeds), idx)
    bits = sampling.random_bits(key, v)
    dbits = sampling.random_bits(sampling.fold_in(
        sampling.prng_key(seeds.to(dev)), idx.to(dev)), v)
    need(torch.equal(dbits.cpu(), bits), "sampler: threefry words differ")
    need(torch.equal(sampling.uniform(dbits).cpu(), sampling.uniform(bits)),
         "sampler: uniforms differ")
    g_cpu = sampling.gumbel_noise(seeds, idx, v)
    need(torch.equal(sampling.gumbel_noise(seeds.to(dev), idx.to(dev),
                                           v).cpu(), g_cpu),
         "sampler: Gumbel noise differs")
    logits = torch.randn(b, v, generator=gen) * 3
    args = (logits, torch.tensor([0.0, 0.9, 0.9, 1.1]),
            torch.tensor([0, 20, 0, 50], dtype=torch.int32),
            torch.tensor([1.0, 1.0, 0.85, 0.9]), seeds, idx)
    want = sampling.sample_tokens(*args)
    got = sampling.sample_tokens(*(a.to(dev) for a in args))
    torch.cuda.synchronize()
    need(torch.equal(got.cpu(), want),
         f"sampler: tokens {got.tolist()} on the card, {want.tolist()} plain")
    print(f"  sampler B {b} V {v}: threefry words, uniforms, Gumbel noise "
          f"and tokens {got.tolist()} (greedy, top-k, top-p, both) equal to "
          "the plain CPU run, bit for bit")


def check_prefill_group(dev, errs, errs_paged, qh=HY_QH, kh=HY_KH, seed=24,
                        hsz=HSZ, t=1024, windows=(0,)):
    """B2 at ``qh / kh`` query heads per kv head (B = 1, T = ``t``, head
    size ``hsz``; hymba's 25/5 by default: blocks of 12 positions, 4 dead
    rows of 64; granite-moe's 16/8: G = 2; gemma3's 16/8 at hsz 256, T =
    2048, windows 0 and 1024), bf16 and f32, at each of ``windows``: fixed
    and paged (16-position pages, a shuffled table, a +-1e4 sink page)
    against the plain versions; paged == fixed bit for bit; rows of chunk
    calls of 256 (at q_offset 0, 256, ..., past the window) == the same
    rows of one call, bit for bit, fixed and paged."""
    grp = f"G={qh // kh}" + (f" hsz {hsz}" if hsz != HSZ else "")
    g = torch.Generator(device=dev).manual_seed(seed)
    full = torch.tensor([t], dtype=torch.int32, device=dev)
    tab, n_pool = shuffled_tables(torch.Generator().manual_seed(seed), full,
                                  16, t // 16)
    tab = tab.to(dev)
    for dt in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
        q, k, v = rnd(1, t, qh, hsz), rnd(1, t, kh, hsz), rnd(1, t, kh, hsz)
        junk = sink_garbage(g, dev, 16, hsz)
        pk = prefill_pool(k, tab, n_pool, 16, junk)
        pv = prefill_pool(v, tab, n_pool, 16, -junk)
        layouts = (("fixed", (k, v), {}),
                   ("paged", (pk, pv), dict(block_tables=tab)))
        for window in windows:
            wtag = f" window {window}" if window else ""
            one = {mode: flash_prefill(q, *kv, seq_lens=full, window=window,
                                       **extra)
                   for mode, kv, extra in layouts}
            want = flash_prefill_ref(q, k, v, window=window)
            want_p = flash_prefill_paged_ref(q, pk, pv, tab, full,
                                             window=window)
            torch.cuda.synchronize()
            for mode, got, ref, lst in (("fixed", one["fixed"], want, errs),
                                        ("paged", one["paged"], want_p,
                                         errs_paged)):
                e = maxerr(got, ref)
                lst.append(e)
                tag = f"prefill {grp} {mode} {str(dt)[6:]}{wtag}"
                print(f"  {tag} (B=1 T={t} {qh}/{kh} heads): max err "
                      f"{e:.3g} (tol {TOL[dt]['out']:g})")
                need(e <= TOL[dt]["out"], f"{tag}: kernel disagrees with "
                                          "plain")
            need(torch.equal(bits(one["fixed"]), bits(one["paged"])),
                 f"prefill {grp}{wtag}: paged != fixed")
            for mode, kv, extra in layouts:
                parts = [flash_prefill(q[:, o:o + 256].contiguous(), *kv,
                                       q_offset=o, window=window,
                                       seq_lens=full * 0 + o + 256, **extra)
                         for o in range(0, t, 256)]
                torch.cuda.synchronize()
                need(torch.equal(bits(torch.cat(parts, 1)), bits(one[mode])),
                     f"prefill {grp} {mode} {dt}{wtag}: chunk rows != "
                     "one-shot rows")
            print(f"  prefill {grp} {str(dt)[6:]}{wtag}: paged == fixed, and "
                  f"rows of {t // 256} chunk calls == one call (fixed and "
                  "paged), bit for bit")


def check_decode_group(dev, errs, qh=HY_QH, kh=HY_KH, seed=25,
                       name="flash_decode_hymba", hsz=HSZ,
                       tl=(1000, 900, 800, 700), cap=1088, windows=(0,)):
    """B1 at ``qh / kh`` heads (hymba's 25/5, G = 5, by default;
    granite-moe's 16/8, G = 2; gemma3's 16/8 at hsz 256, lengths 700-2100,
    windows 0 and 1024) at the serve shape (B = 4, lengths ``tl`` with the
    new token, capacity ``cap``), fused append, f32 and bf16, kvp 1 and 4,
    at each of ``windows``: fixed and paged (a shuffled table), fp and
    int8, against the plain version, the appended rows equal to the plain
    version's and paged == fixed, bit for bit.  ``errs`` maps ``name``,
    ``name + "_kv8"`` and ``name + "_paged"`` (paged fp and int8) to
    lists."""
    grp = f"G={qh // kh}" + (f" hsz {hsz}" if hsz != HSZ else "")
    g = torch.Generator(device=dev).manual_seed(seed)
    b = len(tl)
    tl = torch.tensor(tl, dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
        q, kn, vn = rnd(b, qh, hsz), rnd(b, kh, hsz), rnd(b, kh, hsz)
        base = {key: rnd(1, b, kh, cap, hsz) for key in ("kcache", "vcache")}
        for quant, kvp, window in itertools.product((False, True), (1, 4),
                                                    windows):
            st = quantize_decode_state(base) if quant else base
            keys = [key for key in ("kcache", "vcache", "kscale", "vscale")
                    if key in st]
            page = kvp * RR
            tab, n_pool = shuffled_tables(torch.Generator().manual_seed(kvp),
                                          tl, page, cap // page)
            tab = tab.to(dev)
            paged = state_to_paged(st, tab, n_pool, kvp, page)
            sc = lambda c: dict(kscale=c[2], vscale=c[3]) if quant else {}
            outs = {}
            for mode, src, extra in (("fixed", st, {}),
                                     ("paged", paged,
                                      dict(block_tables=tab))):
                c1, c2 = ([src[key][0].clone() for key in keys]
                          for _ in range(2))
                kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                          window=window, contiguous=False, slot_offset=0,
                          k_new=kn, v_new=vn, **extra)
                o1, l1 = flash_decode_shards(q, c1[0], c1[1], tl, **sc(c1),
                                             **kw)
                o2, l2 = flash_decode_shards_plain(
                    q, c2[0], c2[1], tl, scale=hsz ** -0.5,
                    block_s=kernel_block_s(512, cap // kvp), **sc(c2), **kw)
                torch.cuda.synchronize()
                eo, el = maxerr(o1, o2), maxerr(l1, l2)
                errs[name + ("_paged" if mode == "paged" else
                             "_kv8" if quant else "")].append(eo)
                tag = (f"decode {grp} {mode} {'int8' if quant else 'fp'} "
                       f"{str(dt)[6:]} kvp={kvp}"
                       + (f" window={window}" if window else ""))
                print(f"  {tag}: max err out {eo:.3g} lse {el:.3g} (tol "
                      f"{TOL[dt]['out']:g}/{TOL[dt]['lse']:g})")
                need(eo <= TOL[dt]["out"] and el <= TOL[dt]["lse"],
                     f"{tag}: kernel disagrees with plain")
                # the paged pool's sink page 0 takes no append here
                need(all(torch.equal(bits(x), bits(y))
                         for x, y in zip(c1, c2)),
                     f"{tag}: appended rows differ from plain")
                outs[mode] = (o1, l1)
            need(all(torch.equal(bits(x), bits(y))
                     for x, y in zip(outs["fixed"], outs["paged"])),
                 f"decode {grp} {dt} quant={quant} kvp={kvp} window="
                 f"{window}: paged != fixed")
        print(f"  decode {grp} {str(dt)[6:]}: paged == fixed bit for bit, fp "
              "and int8, kvp 1 and 4"
              + (f", windows {list(windows)}" if windows != (0,) else ""))


def check_grouped_gemma3(dev, errs):
    """B4 and B1's grouped-suffix mode at gemma3's shapes (16 q / 8 kv
    heads of 256, pages of 16, kvp 1): 4 rows of lengths 2100, 1500, 1100
    and 700 share their first 512 positions (32 pages) in one group, fused
    append, f32, bf16 and int8, windows 0 and 1024.  At 1024 the window
    leaves the shared prefix wholly (the 2100 row: its folded prefix state
    is empty, l = 0), cuts it (1500, 1100) or keeps it (700).  Grouped ==
    ungrouped bit for bit (outputs, LSEs, appended pages), and the plain
    grouped decode within the tolerance (``check_grouped_at``)."""
    check_grouped_at(dev, errs, "gemma3", GE_QH, GE_KH, GE_HSZ,
                     [2100, 1500, 1100, 700], 32, (0, GE_WIN), 41,
                     empty={0: [False] * 4, GE_WIN: [True, False, False,
                                                     False]})
    print("  grouped decode gemma3: grouped == ungrouped bit for bit, a "
          "prefix wholly outside a member's window an exact empty partial")


def check_grouped_llama(dev, errs):
    """B4 and B1's grouped-suffix mode at llama-405b's 128 q / 8 kv heads of
    128 (G = 16; ``check_grouped_at``): 4 rows sharing 512 positions at
    lengths 700-1000, windows 0 and 1024 (a launch of fewer chunk items
    than 4 per SM: 1 row a warp, 8 row blocks of the 64 stacked rows), and
    4 rows sharing 4096 positions at lengths 4400-4700 (19 chunks: 8 rows a
    warp, all 64 rows in one row block, each shared tile read once)."""
    check_grouped_at(dev, errs, "llama", LL_QH, LL_KH, DENSE_HSZ,
                     [1000, 900, 800, 700], 32, (0, 1024), 57)
    check_grouped_at(dev, errs, "llama", LL_QH, LL_KH, DENSE_HSZ,
                     [4700, 4600, 4500, 4400], 256, (0,), 58)
    print("  grouped decode llama (G = 16): grouped == ungrouped bit for bit "
          "at 1 and at 8 rows a warp")


def check_grouped_at(dev, errs, label, qh, kh, hsz, tl_l, shared, windows,
                     seed, empty=None):
    """One group of ``len(tl_l)`` rows (lengths ``tl_l`` with the new token)
    sharing their first ``shared`` pages of 16 (kvp 1), ``qh / kh`` heads of
    ``hsz``, fused append, f32, bf16 and int8, at each of ``windows``:
    prefix_pass + the grouped-suffix mode against the ungrouped paged kernel
    bit for bit (outputs, LSEs, appended pages) and the plain grouped decode
    within the tolerance; ``empty[window]``: which rows' folded prefix state
    must be empty (l = 0)."""
    b = len(tl_l)
    gen = torch.Generator(device=dev).manual_seed(seed)
    need_pg = [-(-t // RR) for t in tl_l]
    mp = max(need_pg)
    perm = (torch.randperm(sum(need_pg), generator=torch.Generator()
                           .manual_seed(seed + 1)) + 1).tolist()
    common = [perm.pop() for _ in range(shared)]
    tab = torch.zeros(b, mp, dtype=torch.int32)
    for i, n in enumerate(need_pg):
        tab[i, :n] = torch.tensor(common + [perm.pop()
                                            for _ in range(n - shared)],
                                  dtype=torch.int32)
    tab = tab.to(dev)
    n_pool = 1 + sum(need_pg)
    as_dev = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    tl, groups = as_dev(tl_l), (as_dev([0] * b), as_dev([shared] * b))
    # the prefix pass's rows a warp, as prefix_pass.cu's launcher picks them
    items = -(-mp * RR // CHUNK_S) * b * kh
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rw = (1 if items < 4 * sms else 2 if hsz >= 256
          else 4 if b * qh // kh <= 32 else 8)
    for mode in ("f32", "bf16", "int8"):
        dt = torch.float32 if mode == "f32" else torch.bfloat16
        rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(dt)
        cache = {"kcache": rnd(n_pool, kh, RR, hsz),
                 "vcache": rnd(n_pool, kh, RR, hsz)}
        if mode == "int8":
            cache = quantize_decode_state(cache)
        keys = [k for k in ("kcache", "vcache", "kscale", "vscale")
                if k in cache]
        q, kn, vn = rnd(b, qh, hsz), rnd(b, kh, hsz), rnd(b, kh, hsz)
        sc = lambda p: dict(kscale=p[2], vscale=p[3]) if len(p) == 4 else {}
        for window in windows:
            kw = dict(kvp=1, n_ranks=1, rank=0, rr_block=RR, window=window,
                      block_tables=tab, k_new=kn, v_new=vn)

            def run(fn, grp, **extra):
                p = [cache[k].clone() for k in keys]
                o, l = fn(q, p[0], p[1], tl, groups=grp, **sc(p), **kw,
                          **extra)
                return o, l, p

            og, lg, pg = run(flash_decode_shards, groups)
            of, lf, pf = run(flash_decode_shards, None)
            op, lp, pp = run(flash_decode_shards_plain, groups,
                             scale=hsz ** -0.5, contiguous=False,
                             slot_offset=0,
                             block_s=kernel_block_s(512, mp * RR))
            p = [cache[k] for k in keys]
            _, _, fl = prefix_pass(q, p[0], p[1], tl, tab, *groups, kvp=1,
                                   n_ranks=1, rank=0, rr_block=RR,
                                   window=window, **sc(p))
            torch.cuda.synchronize()
            eo, el = maxerr(og, op), maxerr(lg, lp)
            errs.append(eo)
            tag = f"grouped decode {label} {mode} window={window}"
            got_empty = [bool((fl[0, i] == 0).all()) for i in range(b)]
            print(f"  {tag} (G={qh // kh}, lengths {tl_l}, {shared * RR} "
                  f"shared; prefix_pass {items} chunk items, {rw} rows a "
                  f"warp): max err out {eo:.3g} lse {el:.3g} (tol "
                  f"{TOL[dt]['out']:g}/{TOL[dt]['lse']:g}); rows whose "
                  f"folded prefix state is empty: {got_empty}")
            need(eo <= TOL[dt]["out"] and el <= TOL[dt]["lse"],
                 f"{tag}: kernel disagrees with plain")
            need(torch.equal(bits(og), bits(of))
                 and torch.equal(bits(lg), bits(lf)),
                 f"{tag}: grouped != ungrouped")
            need(all(torch.equal(bits(a[1:]), bits(c[1:]))
                     and torch.equal(bits(a[1:]), bits(d[1:]))
                     for a, c, d in zip(pg, pf, pp)),
                 f"{tag}: appended pages differ")
            if empty is not None:
                need(got_empty == empty[window],
                     f"{tag}: the prefix pass's empty rows are {got_empty}")


def check_hymba_ssd_w8(dev, errs_ssd, errs_mm):
    """B5 at hymba's widths (nh 50, hd 64, ds 16, one B/C group: a state
    tile holds 2 of its 8 column groups, and half the 8 warps hold no S
    unit) at B = 1 and 4, T = 1024, from a nonzero state, f32 and bf16
    inputs; two halves split at 512 chained through h_final == one pass
    bit for bit.  B3 at hymba's untied head: M = 1 and 4, K = 1600, N =
    32256."""
    g = torch.Generator(device=dev).manual_seed(26)
    for dt in (torch.float32, torch.bfloat16):
        for b in (1, 4):
            args, h0 = ssd_inputs(g, dev, b, 1024, dt, nh=HY_NH, ds=HY_DS)
            got = ssd_prefill(*args, h0=h0)
            torch.cuda.synchronize()
            tag = f"ssd hymba {str(dt)[6:]} B={b} T=1024"
            msg = ssd_err(tag, got, ssd_prefill_plain(*args, h0=h0),
                          errs_ssd)
            cut = lambda sl: [a[:, sl].contiguous() if a.ndim > 1 else a
                              for a in args]
            y1, h1 = ssd_prefill(*cut(slice(0, 512)), h0=h0)
            y2, h2 = ssd_prefill(*cut(slice(512, None)), h0=h1)
            torch.cuda.synchronize()
            same = (torch.equal(bits(torch.cat([y1, y2], 1)), bits(got[0]))
                    and torch.equal(bits(h2), bits(got[1])))
            need(same, f"{tag}: split at 512 != one pass")
            print(f"  {tag} (nh {HY_NH}, hd {SSD_HD}, ds {HY_DS}, from a "
                  f"nonzero state): max err {msg} (tol {SSD_TOL:g} x max(1,"
                  " |want|)); split at 512 == one pass bit for bit")
    check_w8a16_head(dev, errs_mm, g, HY_D, HY_VP, "hymba")


def check_w8a16_head(dev, errs, g, d, vp, label):
    """B3 at a model's int8 head [d, vp], M = 1 and 4, f32 and bf16 x."""
    qw, scale = quantize_w8(torch.randn(d, vp, generator=g, device=dev))
    for m, dt in itertools.product((1, 4), (torch.float32, torch.bfloat16)):
        x = torch.randn(m, d, generator=g, device=dev).to(dt)
        got = w8a16_matmul(x, qw, scale)
        want = w8a16_matmul_ref(x, qw, scale)
        torch.cuda.synchronize()
        e, top = maxerr(got, want), want.float().abs().max().item()
        errs.append(e)
        tag = f"w8a16 {label} head {str(dt)[6:]} M={m} K={d} N={vp}"
        print(f"  {tag} ({w8a16_blocks(m, vp)} CTAs): max err {e:.3g} "
              f"(|out| <= {top:.3g}, tol {MM_TOL[dt]:g} x |out|)")
        need(got.dtype == dt and e <= MM_TOL[dt] * top,
             f"{tag}: kernel disagrees")


# ------------------------------------------------------------- phase 4
def serve_full(dev):
    """Every main path at full width, the same 8 requests each: fixed fp and
    int8 in turns fp, int8, int8, fp (host times of one call are compared in
    turns); then both from the paged pool at its default size, whose streams
    must equal the fixed runs' (the same admission schedule); then a paged
    fp run at half the default pool, where admissions wait for pages and
    every request must still finish.  The launch counts are set to 0 just
    before each run and read just after."""
    cfg = get_config("granite-3-2b")
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    reqs = dict(n_requests=8, prompt_len=(128, 1024), max_new=32)
    rows = generate_rows(reqs["n_requests"], prompt_len=reqs["prompt_len"],
                         max_tokens=reqs["max_new"], seed=0)
    cap = cache_capacity(max(r.prompt_len for r in rows)
                         + max(r.max_tokens for r in rows) + 1, 1, RR)
    half_pool = (4 * (cap // page_positions(1, RR)) + 1) // 2
    paged = dict(paged_kv=True)
    plan = (("fp", None, {}), ("int8", KV8_W8, {}), ("int8", KV8_W8, {}),
            ("fp", None, {}), ("paged fp", None, paged),
            ("paged int8", KV8_W8, paged),
            ("pressure", None, dict(paged, pool_blocks=half_pool)))
    runs = {name: [] for name, _, _ in plan}
    for name, hx, extra in plan:
        first = not runs[name]
        int8 = hx is not None
        print(f"  -- {name} path: hx {hx or HelixConfig()} {extra}")
        torch.cuda.reset_peak_memory_stats()
        registry.reset_launch_counts()
        fin, summ = serve_demo("granite-3-2b", **reqs, max_batch=4, hx=hx,
                               kvp=1, dtype=torch.bfloat16, device=dev,
                               model=model, seed=0, **extra)
        counts = registry.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        need(len(fin) == 8 and all(r.finish_reason == "max_tokens"
                                   and len(r.out_tokens) == 32 for r in fin),
             f"serve {name}: {len(fin)} finished, reasons "
             f"{[r.finish_reason for r in fin]}")
        need(all(0 <= t < cfg.vocab for r in fin for t in r.out_tokens),
             f"serve {name}: token outside the vocabulary")
        steps = summ["decode_syncs"]
        want = {"flash_decode": cfg.n_layers * steps,
                "flash_decode_kv8": cfg.n_layers * steps if int8 else 0,
                "flash_decode_paged": cfg.n_layers * steps if extra else 0,
                "flash_decode_grouped": 0, "prefix_pass": 0,
                "flash_prefill": cfg.n_layers * len(fin),
                "flash_prefill_paged": 0,
                "w8a16_matmul": steps if int8 else 0, "ssd_prefill": 0,
                **NO_ENCDEC}
        ttl = summ["ttl_s"]
        print(f"  {len(fin)} requests finished, prompts "
              f"{sorted(len(r.prompt) for r in fin)}; "
              f"{summ['n_tokens']} tokens, {summ['tok_s']:.1f} tok/s, "
              f"TTFT p50 {summ['ttft_s']['p50'] * 1e3:.1f} ms, "
              f"TTL p50 {ttl['p50'] * 1e3:.2f} ms p95 {ttl['p95'] * 1e3:.2f}"
              f" ms, {summ['engine_steps']} engine steps, {steps} decode "
              f"steps, KV cache {summ['kv_cache_dtype']}, "
              f"peak memory {peak / 2**30:.2f} GiB")
        if extra:
            print(f"  pool: {extra.get('pool_blocks') or 'default'} pages, "
                  f"occupancy peak {summ['pool_occupancy_peak']:.4f}, "
                  f"fragmentation mean {summ['pool_frag_mean']:.4f}, "
                  f"{summ['pool_waits']} admissions waited for pages, "
                  f"{summ['capacity_retired']} capacity retirements")
        print(f"  launches {counts} (expected {want})")
        need(counts == want and steps > 0,
             f"serve {name}: launch counts {counts} != expected {want}")
        need(summ["kv_cache_dtype"] == ("torch.int8" if int8
                                        else "torch.bfloat16"),
             f"serve {name}: KV cache is {summ['kv_cache_dtype']}")
        streams = {r.rid: r.out_tokens for r in fin}
        if not first:
            need(streams == runs[name][0]["streams"],
                 f"serve {name}: greedy streams differ between two runs")
        elif name.startswith("paged"):
            fixed = runs[name[len("paged "):]]
            need(streams == fixed[0]["streams"],
                 f"serve {name}: streams differ from the fixed layout's")
            print(f"  {name} streams identical to the fixed {name[6:]} run's "
                  f"(8 of 8); peak memory {peak / 2**30:.2f} GiB, fixed runs "
                  + ", ".join(f"{r['peak'] / 2**30:.2f}" for r in fixed)
                  + " GiB")
        elif name == "pressure":
            need(summ["pool_waits"] >= 1,
                 f"serve {name}: no admission waited for pages")
            print(f"  pressure run: peak memory {peak / 2**30:.2f} GiB, "
                  f"paged fp {runs['paged fp'][0]['peak'] / 2**30:.2f} GiB, "
                  f"fixed fp {runs['fp'][0]['peak'] / 2**30:.2f} GiB")
        elif int8:
            same = sum(streams[r] == runs["fp"][0]["streams"][r]
                       for r in streams)
            print(f"  int8 streams identical to the fp run's: {same} of 8 "
                  "(int8 K/V and head change the numerics; not a check)")
        if first and name in ("fp", "int8", "paged fp"):
            profile_decode(dev, cfg, model, dataclasses.replace(
                hx or HelixConfig(), paged_kv="paged_kv" in extra))
        if first and name == "fp":
            profile_prefill(dev, cfg, model, HelixConfig(), "prefill_wgmma",
                            "flash_prefill")
        runs[name].append({"counts": counts, "summ": summ, "peak": peak,
                           "streams": streams})
    for name, rs in runs.items():
        print(f"  {name} runs: TTL p50 " + ", ".join(
            f"{r['summ']['ttl_s']['p50'] * 1e3:.2f}" for r in rs)
              + " ms; tok/s " + ", ".join(f"{r['summ']['tok_s']:.1f}"
                                          for r in rs))
    # what the engine's one-time head quantization adds to the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    quantize_w8(model.embed.T)
    torch.cuda.synchronize()
    print(f"  head quantization (quantize_w8 of [{D_MODEL}, {VP}]) alone: "
          f"peak {(torch.cuda.max_memory_allocated() - base) / 2**30:.2f} GiB"
          " above what was allocated before it")
    stamp("granite decode windows")
    runs.update(serve_windows(dev, cfg, model, runs))
    stamp("granite chunked, prefix-shared and grouped runs")
    runs.update(serve_prefix(dev, cfg, model, runs["fp"][0]["streams"]))
    stamp("granite host tier and tenancy")
    runs.update(serve_tier(dev, cfg, model, runs))
    del model
    torch.cuda.empty_cache()
    return runs


class TierHook:
    """Acts on a host-tier run's engine between two of ``serve_steps``'s
    engine steps: preempts the decoding request of the lowest slot before
    each engine step in ``preempt_at`` and notes every slot's tokens while
    a restore is held (a request in RESTORING).  With ``logits`` it also
    swaps the engine's step functions for ones that keep the logits behind
    every emitted token by (rid, token index): the decode steps', the
    one-shot prefills' and the finishing chunks' (forced catch-up steps
    emit nothing and are not kept).  The swapped steps run the same
    kernels; a gate on bits runs without them, and a run with them is
    first held equal to that run's streams."""

    def __init__(self, preempt_at=(), logits=False):
        self.preempt_at = set(preempt_at)
        self.want_logits = logits
        self.engine = None
        self.logits = {}
        self.preempted = []
        self.held = []

    def __call__(self, eng, step):
        if self.engine is None:
            self.engine = eng
            if self.want_logits:
                self._wrap(eng)
        restoring = [i for i, r in enumerate(eng.slots)
                     if r is not None and r.state == RESTORING]
        if restoring:
            self.held.append((step, restoring, [
                len(r.out_tokens) if r is not None else None
                for r in eng.slots]))
        if step in self.preempt_at:
            rid = next((r.rid for r in eng.slots
                        if r is not None and r.state == DECODE), None)
            need(rid is not None, f"no decoding request at step {step}")
            need(eng.preempt(rid), f"preempt({rid}) found no slot")
            self.preempted.append((step, rid))

    def _keep(self, rid, j, row):
        self.logits[(rid, j)] = row[:self.engine.cfg.vocab].float().clone()

    def _wrap(self, eng):
        cfg, hx = eng.cfg, eng.hx
        inner = build_serve_step(cfg, hx, return_logits=True)

        def serve(model, state, tokens):
            (nxt, lg), state = inner(model, state, tokens)
            for i, r in enumerate(eng.slots):
                if r is not None and r.state == DECODE and not r.forced_tokens:
                    self._keep(r.rid, len(r.out_tokens), lg[i])
            return nxt, state

        prefill = eng.prefill_step

        def oneshot(model, batch):
            last, st = prefill(model, batch)
            toks = batch["tokens"][0].tolist()
            r = next(r for r in eng.slots
                     if r is not None and r.resume_tokens() == toks)
            self._keep(r.rid, len(r.out_tokens), last[0])
            return last, st

        eng.serve_step, eng.prefill_step = serve, oneshot
        if eng.chunk_tokens:
            cinner = make_chunk_prefill_step(cfg, hx, return_last_logits=True)

            def chunk(model, tokens, bufs, offs):
                nxt, last, bufs = cinner(model, tokens, bufs, offs)
                for i, (row, off) in enumerate(zip(tokens.tolist(),
                                                   offs.tolist())):
                    for r in eng.slots:
                        if (r is not None and r.prefill_tokens is not None
                                and r.prefill_pos == off
                                and r.prefill_tokens[off:off + len(row)] == row
                                and off + len(row) >= len(r.prefill_tokens)):
                            self._keep(r.rid, len(r.out_tokens), last[i])
                return nxt, bufs

            eng.chunk_step = chunk


def near_ties(tag, base, base_logits, streams, logits, *,
              judge_first=False):
    """Streams of two routes to the same K/V held as ``chunked_vs_oneshot``
    holds chunked against one-shot: the first tokens equal, the logits
    behind every token up to a request's first differing token within
    BF16_LOGIT_TOL, so a stream may part only at a near-tie; each parting
    is printed with the baseline's logit gap between the two tokens.  With
    ``judge_first`` (two routes whose prefills differ too, their logits
    recorded under token 0) the first tokens are held by the same near-tie
    rule as the others."""
    same, flips, worst, n_cmp = 0, [], 0.0, 0
    for rid, a in base.items():
        b = streams[rid]
        first = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]),
                     None)
        same += first is None and a == b
        need(first is None or first >= 1
             or judge_first and (rid, 0) in base_logits,
             f"{tag} rid {rid}: the first tokens differ")
        upto = len(a) if first is None else first + 1
        for j in range(upto):
            if (rid, j) in base_logits and (rid, j) in logits:
                n_cmp += 1
                worst = max(worst, maxerr(base_logits[rid, j],
                                          logits[rid, j]))
        if first is not None:
            lg = base_logits[rid, first]
            flips.append((rid, first, float(lg[a[first]] - lg[b[first]])))
    print(f"  {tag}: streams equal {same} of {len(base)}; logits compared "
          f"at {n_cmp} tokens, max err {worst:.4g} (tol {BF16_LOGIT_TOL:g}); "
          f"partings at a near-tie (rid, token, baseline logit gap): {flips}")
    need(worst <= BF16_LOGIT_TOL,
         f"{tag}: logits beyond the tolerance ({worst:.4g})")
    need(all(abs(g) <= 2 * BF16_LOGIT_TOL for _, _, g in flips),
         f"{tag}: a stream parted away from a near-tie: {flips}")


def tier_run(dev, model, name, reqs, *, int8=False, hook=None, **kw):
    """One host-tier run on full-width granite-3-2b (paged, max_batch 4,
    kvp 1) through ``serve_steps``, ``hook`` acting on the engine before
    each engine step; counts set to 0 just before it.  Every request
    must finish its budget; the launches must be the path's: flash_decode
    (paged; int8 in int8 runs) layers x decode steps (window runs: x N,
    the warm-up window included), flash_prefill layers x prefill calls
    (one-shot prefills or chunks, re-prefills included), w8a16_matmul once
    per step with the int8 head.  Returns (streams, summary, counts,
    hook)."""
    hook = hook or TierHook()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    run = serve_steps("granite-3-2b", **reqs, max_batch=4,
                      hx=KV8_W8 if int8 else None, kvp=1, paged_kv=True,
                      dtype=torch.bfloat16, device=dev, model=model, seed=0,
                      **kw)
    for step in itertools.count():
        try:
            eng = next(run)
        except StopIteration as done:
            fin, summ = done.value
            break
        hook(eng, step)
    counts = registry.launch_counts()
    wall = time.perf_counter() - t0
    n = summ["decode_window"]
    need(all(r.finish_reason == "max_tokens" for r in fin),
         f"{name}: reasons {[r.finish_reason for r in fin]}")
    steps = (summ["decode_syncs"] if n == 1
             else n * (summ["decode_syncs"] + summ["graph_captures"]))
    if n > 1:
        need(summ["graph_captures"] == 1
             and summ["graph_replays"] == summ["decode_syncs"],
             f"{name}: {summ['graph_captures']} captures, "
             f"{summ['graph_replays']} replays, {summ['decode_syncs']} "
             "windows")
    want = path_counts(GRANITE_LAYERS, summ["prefill_calls"], int8=int8,
                       paged=True)(steps)
    ttl = summ["ttl_s"]
    print(f"  {name}: {len(fin)} requests, {summ['n_tokens']} tokens, "
          f"{summ['engine_steps']} engine steps, {summ['decode_syncs']} "
          f"decode {'windows' if n > 1 else 'steps'}, "
          f"{summ['prefill_calls']} prefill calls, {wall:.2f} s; TTFT p50 "
          f"{summ['ttft_s']['p50'] * 1e3:.2f} ms, TTL p50 "
          f"{ttl['p50'] * 1e3:.3f} ms p95 {ttl['p95'] * 1e3:.3f} ms; "
          f"preempts {summ['preempts']} (spills {summ['preempt_spills']}, "
          f"drops {summ['preempt_drops']}), spills {summ['spills']}, "
          f"restores {summ['restores']}, restores_failed "
          f"{summ['restores_failed']}, checksum_mismatches "
          f"{summ['checksum_mismatches']}, store_full {summ['store_full']}, "
          f"resume_reprefill_chunks {summ['resume_reprefill_chunks']}, "
          f"restore_s p50 {summ['restore_s']['p50'] * 1e3:.2f} ms (n "
          f"{summ['restore_s']['n']})"
          + (f", graphs {summ['graph_captures']} captured "
             f"{summ['graph_replays']} replayed" if n > 1 else ""))
    print(f"    launches {counts} (expected {want})")
    need(counts == want, f"{name}: launch counts {counts} != {want}")
    for e in hook.engine.tier_log:
        if e["kind"] == "restore":
            print(f"    restore rid {e['rid']} ({e['key']}): {e['pages']} "
                  f"pages, {e['tokens']} tokens, {e['bytes'] / 2**20:.2f} "
                  f"MiB; store verify (CRC) {e['verify_ms']:.2f} ms, "
                  f"host->device {fmt_ms(e['h2d_ms'])}, scatter "
                  f"{fmt_ms(e['scatter_ms'])}, host wall {e['host_ms']:.2f} "
                  "ms")
        else:
            print(f"    {e['kind']} rid {e['rid']}: {e['pages']} pages, "
                  f"{e['tokens']} tokens, {e['bytes'] / 2**20:.2f} MiB, "
                  f"{'kept' if e['ok'] else 'refused'}; gather "
                  f"{fmt_ms(e['gather_ms'])}, device->host "
                  f"{fmt_ms(e['d2h_ms'])} (events), host wait "
                  f"{e['host_wait_ms']:.2f} ms, put (copy + CRC) "
                  f"{e['put_ms']:.2f} ms")
    return {r.rid: r.out_tokens for r in fin}, summ, counts, hook


def serve_tier(dev, cfg, model, runs):
    """The host KV tier and the multi-tenant front end at full width
    (granite-3-2b, 40 layers, bf16, paged, max_batch 4, kvp 1):

    (t1) the "paged fp" run's 8 requests with two decoding requests
    preempted at engine steps 12 and 40 (host tier of 4096 pages): streams
    equal the paged fp run's bit for bit, 2 spills, 2 restores, no
    re-prefill, the paged fp run's launches; (t2) the same on the int8 path
    against "paged int8" (int8 payloads and f32 scales as bytes); (t3)
    top-p at window 4 with one preempt: the paged top-p window-4 streams,
    one capture and every window replayed across the restore; (t4) (t1)
    under restore_fail, corrupt, store_full and a 2-step delay: each
    fallback counted, its re-prefills counted and launched, streams by the
    near-tie rule against (t1) run again keeping logits (equal to t1 bit
    for bit), and the other slots decoding while a delayed restore is
    held; (t5) 4 requests of 256 tokens, 32 new, 2 turns, chunks of 256,
    with and without session KV, at windows 1 and 4, then at window 1
    again keeping logits: window 4 == window 1, session vs sessionless by
    the near-tie rule, 4 restores and no re-prefill with sessions; (t6) a
    Poisson trace of 12 requests of 256-1024 tokens, 32 new, tenants
    chat:2:interactive:0.5 and bulk:1:batch:0.5, under a VirtualClock
    without and with the governor (equal streams, at least one shed and
    one cap raise, spills = restores = sheds, no re-prefill), then at
    window 4 on the wall clock without and with it (figures only)."""
    out = {}
    reqs = dict(n_requests=8, prompt_len=(128, 1024), max_new=32)
    big = dict(host_pages=4096)
    print("  -- t1 preempt, fp: two decoding requests at steps 12 and 40")
    streams, summ, counts, drv = tier_run(dev, model, "t1 preempt fp", reqs,
                                          hook=TierHook((12, 40)), **big)
    print(f"    preempted (step, rid): {drv.preempted}")
    need(streams == runs["paged fp"][0]["streams"],
         "t1: streams differ from the paged fp run's")
    need(summ["spills"] == summ["restores"] == 2
         and summ["resume_reprefill_chunks"] == 0
         and summ["restores_failed"] == 0,
         f"t1: spills {summ['spills']} restores {summ['restores']} "
         f"re-prefill chunks {summ['resume_reprefill_chunks']}")
    need(counts == runs["paged fp"][0]["counts"],
         "t1: launches differ from the paged fp run's")
    print("    t1 streams equal the paged fp run's bit for bit (8 of 8), "
          "launches equal too")
    out["t1"] = {"streams": streams, "summ": summ, "counts": counts}

    print("  -- t2 preempt, int8 K/V and head")
    streams, summ, counts, _ = tier_run(dev, model, "t2 preempt int8", reqs,
                                        int8=True,
                                        hook=TierHook((12, 40)), **big)
    need(streams == runs["paged int8"][0]["streams"],
         "t2: streams differ from the paged int8 run's")
    need(summ["spills"] == summ["restores"] == 2
         and summ["resume_reprefill_chunks"] == 0,
         "t2: not 2 spills and 2 restores without re-prefill")
    print("    t2 streams equal the paged int8 run's bit for bit (8 of 8)")
    out["t2"] = {"summ": summ, "counts": counts}

    print("  -- t3 preempt inside windows: top-p, window 4, paged")
    streams, summ, counts, _ = tier_run(
        dev, model, "t3 top-p w4 preempt", reqs, hook=TierHook((5,)),
        sampling=TOP_P, decode_window=WINDOW, **big)
    need(streams == runs["windows"]["paged top-p w4"]["streams"],
         "t3: streams differ from the paged top-p window-4 run's")
    need(summ["restores"] == 1 and summ["resume_reprefill_chunks"] == 0,
         "t3: no clean restore")
    print("    t3 streams equal the paged top-p w4 run's (8 of 8); the graph "
          "replayed every window across the restore")
    out["t3"] = {"summ": summ, "counts": counts}

    print("  -- t1 again, keeping logits: the baseline of the near-tie rule")
    base, _, _, drv = tier_run(dev, model, "t1 preempt fp, logits kept",
                               reqs, hook=TierHook((12, 40), logits=True),
                               **big)
    need(base == out["t1"]["streams"],
         "t1: the run keeping logits differs from the one that did not")
    print("    streams equal t1's bit for bit (8 of 8)")
    base_logits = drv.logits
    faults = (("restore_fail", "seed=5,restore_fail=1"),
              ("corrupt", "seed=5,corrupt=1"),
              ("store_full", "seed=5,store_full=1"),
              ("delay", "seed=5,delay=1,delay_steps=2"))
    for fault, plan in faults:
        print(f"  -- t4 fault {plan}")
        streams, summ, counts, drv = tier_run(
            dev, model, f"t4 {fault}", reqs,
            hook=TierHook((12, 40), logits=True), fault_plan=plan, **big)
        need(summ["prefill_calls"] == 8 + summ["resume_reprefill_chunks"],
             f"t4 {fault}: prefill calls {summ['prefill_calls']}")
        if fault == "delay":
            need(summ["restores"] == 2
                 and summ["resume_reprefill_chunks"] == 0,
                 "t4 delay: the late restores did not land cleanly")
            advanced = [h for h in drv.held]
            print(f"    held steps (step, restoring slots, tokens per slot):"
                  f" {advanced}")
            need(len(advanced) >= 4, "t4 delay: the restores were not held")
            for (s0, slots, a), (s1, _, b) in zip(advanced, advanced[1:]):
                others = [i for i in range(4) if i not in slots
                          and a[i] is not None and b[i] is not None]
                need(s1 != s0 + 1 or not others
                     or any(b[i] > a[i] for i in others),
                     f"t4 delay: other slots stalled at step {s0}")
            need(streams == base, "t4 delay: streams differ from t1's")
        else:
            # corrupt: a flipped byte (checksum) or a bumped generation
            caught = {"restore_fail": summ["restores_failed"],
                      "corrupt": summ["checksum_mismatches"]
                      + summ["stale_generations"],
                      "store_full": summ["store_full"]}[fault]
            need(caught >= 2 and summ["resume_reprefill_chunks"] >= 2
                 and summ["restores"] == 0,
                 f"t4 {fault}: {caught} caught, re-prefill chunks "
                 f"{summ['resume_reprefill_chunks']}")
            near_ties(f"t4 {fault}", base, base_logits, streams, drv.logits)
        out[f"t4 {fault}"] = {"summ": summ, "counts": counts}

    out.update(tier_sessions(dev, model))
    out.update(tier_tenants(dev, model))
    return {"tier": out}


def tier_sessions(dev, model):
    """(t5) of ``serve_tier``: the four runs with the engine's own step
    functions, then the two window-1 runs again keeping logits (equal to
    the first ones), for the near-tie rule."""
    reqs = dict(n_requests=4, prompt_len=256, max_new=32, turns=2,
                chunk_tokens=256)
    res = {}
    for sess in (False, True):
        for n in (1, WINDOW):
            name = (f"t5 {'session' if sess else 'sessionless'} "
                    f"w{n}")
            print(f"  -- {name}")
            streams, summ, counts, _ = tier_run(
                dev, model, name, reqs, session_kv=sess, decode_window=n)
            need(summ["n_finished"] == 8, f"{name}: {summ['n_finished']}")
            if sess:
                need(summ["restores"] == 4
                     and summ["resume_reprefill_chunks"] == 0,
                     f"{name}: restores {summ['restores']}, re-prefill "
                     f"chunks {summ['resume_reprefill_chunks']}")
            print(f"    turn2_ttft_s {summ['turn2_ttft_s'] * 1e3:.1f} ms")
            res[sess, n] = (streams, summ)
    for sess in (False, True):
        need(res[sess, WINDOW][0] == res[sess, 1][0],
             f"t5 {'session' if sess else 'sessionless'}: window 4 != 1")
    print("  t5 window-4 streams equal window 1's, with and without session"
          " KV")
    logits = {}
    for sess in (False, True):
        name = f"t5 {'session' if sess else 'sessionless'} w1, logits kept"
        print(f"  -- {name}")
        streams, _, _, drv = tier_run(dev, model, name, reqs,
                                      hook=TierHook(logits=True),
                                      session_kv=sess)
        need(streams == res[sess, 1][0],
             f"{name}: streams differ from the run without the logits")
        logits[sess] = drv.logits
    print("    the runs keeping logits equal the runs without, bit for bit")
    near_ties("t5 session vs sessionless", res[False, 1][0], logits[False],
              res[True, 1][0], logits[True])
    print("  t5 turn2_ttft_s: " + ", ".join(
        f"{'session' if s else 'sessionless'} w{n} "
        f"{res[s, n][1]['turn2_ttft_s'] * 1e3:.1f} ms"
        for s in (False, True) for n in (1, WINDOW)))
    return {f"t5 {'session' if s else 'sessionless'} w{n}":
            {"summ": res[s, n][1]} for s in (False, True)
            for n in (1, WINDOW)}


def tier_tenants(dev, model):
    """(t6) of ``serve_tier``.  The governed run's target, 2.8 ms of the
    VirtualClock, lies between the modelled TTL of a step of 3 decoding
    slots (2.5 ms) and of 4 (3.0 ms): below the ungoverned run's
    interactive p95, which a full batch sets."""
    reqs = dict(n_requests=12, prompt_len=(256, 1024), max_new=32,
                traffic="poisson", arrival_rate=0.25,
                tenants="chat:2:interactive:0.5,bulk:1:batch:0.5",
                host_pages=4096)
    out = {}
    print("  -- t6 tenants, VirtualClock, no governor")
    s0, u, _, _ = tier_run(dev, model, "t6 ungoverned", reqs,
                           virtual_clock=True)
    p95 = u["per_class"]["interactive"]["ttl_s"]["p95"]
    target_ms = 2.8
    print(f"    trace {u['trace_id']}; interactive TTL p95 "
          f"{p95 * 1e3:.3f} ms (modelled); target {target_ms} ms")
    need(p95 * 1e3 > target_ms, "t6: the target is not below the p95")
    print("  -- t6 tenants, VirtualClock, governor")
    s1, g, _, _ = tier_run(dev, model, "t6 governed", reqs,
                           virtual_clock=True, slo_ttl_ms=target_ms)
    print(f"    governor sheds {g['governor_sheds']}, cap raises "
          f"{g['governor_cap_raises']}; interactive TTL p95 "
          f"{g['per_class']['interactive']['ttl_s']['p95'] * 1e3:.3f} ms, "
          f"miss rate {g['ttl_target_miss_rate']:.4f}")
    need(g["governor_sheds"] >= 1 and g["governor_cap_raises"] >= 1,
         "t6: the governor did not shed and raise")
    need(g["spills"] == g["restores"] == g["governor_sheds"]
         and g["resume_reprefill_chunks"] == 0,
         "t6: sheds did not go through clean spills and restores")
    need(s1 == s0, "t6: governed streams differ from the ungoverned run's")
    print("    t6 governed streams equal the ungoverned run's (12 of 12)")
    out["t6 virtual"] = {"summ": u}
    out["t6 governed"] = {"summ": g}
    for slo in (0.0, None):
        name = "t6 wall w4 " + ("ungoverned" if slo == 0.0 else "governed")
        if slo is None:
            slo = 0.9 * out["t6 wall w4 ungoverned"]["summ"]["per_class"][
                "interactive"]["ttl_s"]["p95"] * 1e3
            print(f"  -- {name}: target {slo:.3f} ms, 0.9 x the ungoverned "
                  "wall-clock interactive p95")
        _, s, _, _ = tier_run(dev, model, name, reqs, decode_window=WINDOW,
                              slo_ttl_ms=slo)
        pc = s["per_class"]
        print("    " + "; ".join(
            f"{c} TTL p50 {pc[c]['ttl_s']['p50'] * 1e3:.3f} ms p95 "
            f"{pc[c]['ttl_s']['p95'] * 1e3:.3f} ms" for c in sorted(pc))
              + f"; sheds {s['governor_sheds']}, cap raises "
              f"{s['governor_cap_raises']}, tok/s {s['tok_s']:.1f}")
        out[name] = {"summ": s}
    return out


def window_figures(name, summ) -> str:
    """One line of a serve run's figures: TTL, TTFT, tok/s, host ms per
    decoded token, stream ms per step or window (CUDA events), syncs."""
    ttl = summ["ttl_s"]
    return (f"  {name}: TTL p50 {ttl['p50'] * 1e3:.2f} ms p95 "
            f"{ttl['p95'] * 1e3:.2f} ms, TTFT p50 "
            f"{summ['ttft_s']['p50'] * 1e3:.1f} ms, {summ['tok_s']:.1f} "
            f"tok/s, host {summ['decode_host_ms_per_token']:.3f} ms per "
            f"decoded token, device {summ['decode_device_ms']:.3f} ms per "
            f"{'window' if summ['decode_window'] > 1 else 'step'} (events), "
            f"{summ['decode_syncs']} syncs / {summ['decoded_tokens']} tokens "
            f"= {summ['syncs_per_token']:.4f}, graphs "
            f"{summ['graph_captures']} captured ({summ['graph_setup_s']:.2f} s "
            f"with the warm-up window) {summ['graph_replays']} replayed")


def window_run(dev, arch, model, name, reqs, want_counts, **kw):
    """One ``serve_demo`` run for the window checks, counts set to 0 just
    before it; every request must finish its budget, and with a window the
    graph must carry every window after the first warm-up.  Returns
    ``(streams, summary, counts)``."""
    registry.reset_launch_counts()
    fin, summ = serve_demo(arch, **reqs, max_batch=4, dtype=torch.bfloat16,
                           device=dev, model=model, **kw)
    counts = registry.launch_counts()
    need(len(fin) == reqs["n_requests"]
         and all(r.finish_reason == "max_tokens" for r in fin),
         f"{name}: reasons {[r.finish_reason for r in fin]}")
    n = summ["decode_window"]
    calls = summ["decode_syncs"] + summ["graph_captures"]
    if n > 1:
        need(summ["graph_captures"] == 1
             and summ["graph_replays"] == summ["decode_syncs"],
             f"{name}: {summ['graph_captures']} captures, "
             f"{summ['graph_replays']} replays, {summ['decode_syncs']} "
             "windows")
    want = want_counts(n * calls)
    print(window_figures(name, summ))
    print(f"    launches {counts} (expected {want}: decode steps = "
          f"{n} x ({summ['decode_syncs']} windows + "
          f"{summ['graph_captures']} warm-up))")
    need(counts == want, f"{name}: launch counts {counts} != {want}")
    need(summ["syncs_per_token"]
         == summ["decode_syncs"] / summ["decoded_tokens"],
         f"{name}: syncs_per_token {summ['syncs_per_token']}")
    return {r.rid: r.out_tokens for r in fin}, summ, counts


def graph_vs_eager(dev, cfg, model, hx, prompts):
    """One window replayed from a captured graph against the eager window
    over a full-width decode state (4 requests decoding, top-p rows, one
    row frozen after 2 steps by its budget): outputs and every state leaf
    equal bit for bit."""
    eng = DecodeEngine(cfg, model, build_serve_step(cfg, hx),
                       make_prefill_step(cfg, hx), max_batch=4,
                       max_seq=max(len(p) for p in prompts) + 64, hx=hx,
                       device=dev, sampling=TOP_P)
    for rid, p in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=64))
    eng.step()                  # admission, prefills and one decode step
    need(all(r is not None and r.state == DECODE for r in eng.slots),
         "graph vs eager: not every slot decoding")
    n = WINDOW
    ctl = (eng.cur_tokens.clone(),
           torch.tensor([n, 2, n, n], dtype=torch.int32, device=dev),
           torch.full((4,), -1, dtype=torch.int32, device=dev),
           torch.zeros(4, n, dtype=torch.int32, device=dev),
           torch.zeros(4, dtype=torch.int32, device=dev))
    multistep = build_serve_multistep(cfg, hx, window=n)
    eager = {k: v.clone() for k, v in eng.state.items()}
    graph = {k: v.clone() for k, v in eng.state.items()}
    del eng
    runner = WindowRunner(multistep)
    runner.prepare(model, graph, *ctl)
    e_out, e_cur, e_new = multistep(model, eager, *ctl)
    g_out, g_cur, g_new = runner(model, graph, *ctl)
    torch.cuda.synchronize()
    need(torch.equal(g_out, e_out) and torch.equal(g_cur, e_cur),
         f"{cfg.name} graph vs eager: token blocks differ")
    differ = [k for k in e_new if not torch.equal(g_new[k], e_new[k])]
    need(not differ, f"{cfg.name} graph vs eager: leaves {differ} differ")
    size = sum(v.numel() * v.element_size() for v in e_new.values())
    print(f"  {cfg.name} window of {n} replayed from its CUDA graph == eager "
          f"window bit for bit: tokens {g_out.tolist()}, all "
          f"{len(e_new)} state leaves ({size / 2**20:.1f} MiB)")


def path_counts(layers, prefills, *, int8=False, paged=False, ssd=False):
    """``steps -> counts``: the launches a one-shot-prefill serve run of
    ``prefills`` requests must make, flash_decode ``layers`` x decode steps
    (its int8 and paged modes too in int8 and paged runs), flash_prefill
    (and ssd_prefill for an SSM arch) ``layers`` x prefills and w8a16_matmul
    once per step with the int8 head."""
    return lambda steps: {
        "flash_decode": layers * steps,
        "flash_decode_kv8": layers * steps if int8 else 0,
        "flash_decode_paged": layers * steps if paged else 0,
        "flash_decode_grouped": 0, "prefix_pass": 0,
        "flash_prefill": layers * prefills, "flash_prefill_paged": 0,
        "w8a16_matmul": steps if int8 else 0,
        "ssd_prefill": layers * prefills if ssd else 0, **NO_ENCDEC}


def serve_windows(dev, cfg, model, runs):
    """Decode windows of 4 at full width, the fp run's 8 requests: top-p
    (T 0.9, p 0.85, seed 7) at window 1 and 4 on the fixed layout, window 4
    on the paged pool (streams equal to window 1's); greedy window 4 on the
    fixed layout and on the int8 path, whose streams must equal the one-step
    fp and int8 runs'.  Then one window from a graph vs eager."""
    reqs = dict(n_requests=8, prompt_len=(128, 1024), max_new=32)
    counts = lambda **kw: path_counts(cfg.n_layers, reqs["n_requests"], **kw)

    out = {}
    plan = (("top-p w1", {}, 1, counts()), ("top-p w4", {}, WINDOW, counts()),
            ("paged top-p w4", dict(paged_kv=True), WINDOW,
             counts(paged=True)))
    for name, extra, n, want in plan:
        streams, summ, c = window_run(
            dev, "granite-3-2b", model, name, reqs, want, sampling=TOP_P,
            decode_window=n, seed=0, **extra)
        out[name] = {"streams": streams, "summ": summ, "counts": c}
        if n > 1:
            need(streams == out["top-p w1"]["streams"],
                 f"{name}: streams differ from window 1's")
            print(f"    {name} streams equal to top-p w1's (8 of 8)")
    for name, hx, ref in (("greedy w4", None, "fp"),
                          ("int8 greedy w4", KV8_W8, "int8")):
        streams, summ, c = window_run(
            dev, "granite-3-2b", model, name, reqs,
            counts(int8=hx is not None), hx=hx, decode_window=WINDOW, seed=0)
        need(streams == runs[ref][0]["streams"],
             f"{name}: streams differ from the one-step {ref} run's")
        print(f"    {name} streams equal to the one-step {ref} run's "
              "(8 of 8)")
        out[name] = {"streams": streams, "summ": summ, "counts": c}
    prompts = [prompt_tokens(r, cfg.vocab) for r in generate_rows(
        4, prompt_len=(700, 1000), max_tokens=1, seed=3)]
    graph_vs_eager(dev, cfg, model, HelixConfig(), prompts)
    return {"windows": out}


def serve_mamba(dev):
    """mamba2-780m at full width, 24 of its 48 layers (``MAMBA_LAYERS``;
    bf16, seeded random weights) through ``serve_demo``: 8 requests of
    256-1024 tokens (multiples of 256, which meet the reference's
    prompt-length contract), 32 new tokens each, max_batch 4, one-shot
    prefills through ssd_prefill.  The counts are set to 0 just before the
    run and read just after it; then the decode-step and prefill
    profiles."""
    cfg = dataclasses.replace(get_config("mamba2-780m"),
                              n_layers=MAMBA_LAYERS)
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    registry.reset_launch_counts()
    reqs = dict(n_requests=8, prompt_len=(1, 1024), prompt_multiple=256,
                max_new=32, n_layers=MAMBA_LAYERS)
    fin, summ = serve_demo("mamba2-780m", **reqs, max_batch=4,
                           dtype=torch.bfloat16, device=dev, model=model,
                           seed=0)
    counts = registry.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    need(len(fin) == 8 and all(r.finish_reason == "max_tokens"
                               and len(r.out_tokens) == 32 for r in fin),
         f"serve mamba2: {len(fin)} finished, reasons "
         f"{[r.finish_reason for r in fin]}")
    need(all(0 <= t < cfg.vocab for r in fin for t in r.out_tokens),
         "serve mamba2: token outside the vocabulary")
    prompts = sorted(len(r.prompt) for r in fin)
    need(set(prompts) <= {256, 512, 768, 1024},
         f"serve mamba2: prompt lengths {prompts}")
    want = {name: 0 for name in counts}
    want["ssd_prefill"] = cfg.n_layers * summ["prefill_calls"]
    ttl = summ["ttl_s"]
    print(f"  {len(fin)} requests finished, prompts {prompts}; "
          f"{summ['n_tokens']} tokens, {summ['tok_s']:.1f} tok/s, TTFT p50 "
          f"{summ['ttft_s']['p50'] * 1e3:.1f} ms, TTL p50 "
          f"{ttl['p50'] * 1e3:.2f} ms p95 {ttl['p95'] * 1e3:.2f} ms, "
          f"{summ['engine_steps']} engine steps, {summ['decode_syncs']} "
          f"decode steps, {summ['prefill_calls']} prefills, peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"  launches {counts} (expected {want})")
    need(summ["prefill_calls"] == 8 and counts == want,
         f"serve mamba2: launch counts {counts} != expected {want}")
    distinct = len({t for r in fin for t in r.out_tokens})
    print(f"  streams: {distinct} distinct tokens over the 8 requests "
          "(seeded random mamba2 collapses onto few tokens; not a check)")
    profile_decode(dev, cfg, model, HelixConfig())
    prof = profile_prefill(dev, cfg, model, HelixConfig(), "ssd_",
                           "ssd_prefill")
    # the same requests with top-p sampling at window 1 and 4
    zero = {name: 0 for name in counts}
    want = lambda steps: dict(zero, ssd_prefill=cfg.n_layers * 8)  # noqa: E731
    windows = {n: window_run(dev, "mamba2-780m", model, f"mamba2 top-p w{n}",
                             reqs, want, sampling=TOP_P, decode_window=n,
                             seed=0) for n in (1, WINDOW)}
    need(windows[1][0] == windows[WINDOW][0],
         "mamba2 top-p: window 4 streams differ from window 1's")
    print(f"    mamba2 top-p w{WINDOW} streams equal to w1's (8 of 8)")
    graph_vs_eager(dev, cfg, model, HelixConfig(),
                   [prompt_tokens(r, cfg.vocab) for r in generate_rows(
                       4, prompt_len=256, max_tokens=1, seed=3)])
    del model
    torch.cuda.empty_cache()
    return {"counts": counts, "summ": summ, "prefill": prof,
            "windows": {n: w[1] for n, w in windows.items()}}


def compare_mamba(dev):
    """4-layer f32 mamba2 at full width: the prefill logits and SSM state
    leaves of the ssd backends ``cuda`` and ``ref``; then the ``cuda``
    prefill + 2 decode steps against ``forward`` over the T + 2 tokens
    (T = 62, so both lengths meet the prompt-length contract)."""
    cfg = dataclasses.replace(get_config("mamba2-780m"), n_layers=4)
    model = init_params(cfg, 1, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    t = 62
    toks = torch.randint(0, cfg.vocab, (2, t), generator=g, device=dev)
    res = {b: make_prefill_step(cfg, HelixConfig(ssd_backend=b))(
        model, {"tokens": toks}) for b in ("cuda", "ref")}
    torch.cuda.synchronize()
    (lk, sk), (lr, sr) = res["cuda"], res["ref"]
    for name, a, b in (("prefill logits", lk[:, :cfg.vocab],
                        lr[:, :cfg.vocab]),
                       ("ssm_conv", sk["ssm_conv"], sr["ssm_conv"]),
                       ("ssm_state", sk["ssm_state"], sr["ssm_state"])):
        e, scale = maxerr(a, b), b.abs().max().item()
        print(f"  4-layer f32 mamba2 {name}, ssd cuda vs ref: max err "
              f"{e:.3g} (|ref| <= {scale:.3g}, tol {LOGIT_TOL:g} x max(1, "
              "|ref|))")
        need(e <= LOGIT_TOL * max(1.0, scale), f"mamba2 {name} disagrees")
    state = dict(sk, total_len=torch.full((2,), t, dtype=torch.int32,
                                          device=dev))
    step = build_serve_step(cfg, HelixConfig(), return_logits=True)
    cur = torch.argmax(lk[:, :cfg.vocab], -1).to(torch.int32)
    fed, dec = [], [lk]
    for _ in range(2):
        fed.append(cur)
        (cur, lg), state = step(model, state, cur)
        dec.append(lg)
    full = torch.cat([toks, torch.stack(fed, 1).to(toks.dtype)], 1)
    ref, _ = forward(cfg, model, full, ssd_backend="cuda")
    torch.cuda.synchronize()
    want = ref[:, t - 1:, :cfg.vocab]
    got = torch.stack(dec, 1)[..., :cfg.vocab]
    e, scale = maxerr(got, want), want.abs().max().item()
    print(f"  4-layer f32 mamba2 prefill + 2 decode steps vs forward over "
          f"{t + 2} tokens: max logit err {e:.3g} (|logits| <= {scale:.3g}, "
          f"tol {LOGIT_TOL:g} x max(1, |logits|))")
    need(e <= LOGIT_TOL * max(1.0, scale),
         "mamba2 decode steps disagree with forward")
    del model
    torch.cuda.empty_cache()


PLAN_RUNS = ("greedy w1", "top-p w1", "top-p w4", "paged top-p w4",
             "int8 greedy w4")
SHARED_RUNS = ("a paged chunked", "b + prefix_share", "c + grouped_decode")


def serve_plan(dev, arch, model, label, reqs, counts, names=PLAN_RUNS):
    """The window runs of a model served at full width, those of ``names``
    (by default these five: greedy at window 1; top-p (T 0.9, p 0.85, seed
    7) at window 1 and 4, and at window 4 from the paged pool, all three
    with equal streams; greedy window 4 with the int8 head and the int8 KV
    cache; also ``greedy w4`` and ``paged int8 greedy w4``, whose streams
    must equal ``greedy w1``'s and ``int8 greedy w4``'s where those ran).
    ``counts(**kw)`` gives each run's expected launches (``path_counts``);
    the counts are set to 0 just before each run; each run's peak memory is
    printed.  Returns the runs by name."""
    runs = {}
    plan = (("greedy w1", {}, counts()),
            ("top-p w1", dict(sampling=TOP_P), counts()),
            ("top-p w4", dict(sampling=TOP_P, decode_window=WINDOW),
             counts()),
            ("paged top-p w4", dict(sampling=TOP_P, decode_window=WINDOW,
                                    paged_kv=True), counts(paged=True)),
            ("int8 greedy w4", dict(hx=KV8_W8, decode_window=WINDOW),
             counts(int8=True)),
            ("greedy w4", dict(decode_window=WINDOW), counts()),
            ("paged int8 greedy w4", dict(hx=KV8_W8, decode_window=WINDOW,
                                          paged_kv=True),
             counts(int8=True, paged=True)))
    same_as = {"top-p w4": "top-p w1", "paged top-p w4": "top-p w1",
               "greedy w4": "greedy w1",
               "paged int8 greedy w4": "int8 greedy w4"}
    if "top-p w1" not in names:
        same_as["paged top-p w4"] = "top-p w4"
    peak = 0
    for name, kw, want in (p for p in plan if p[0] in names):
        torch.cuda.reset_peak_memory_stats()
        streams, summ, c = window_run(dev, arch, model, f"{label} {name}",
                                      reqs, want, seed=0, **kw)
        summ["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        peak = max(peak, summ["peak_gib"])
        print(f"    {label} {name} peak memory {summ['peak_gib']:.2f} GiB")
        runs[name] = {"streams": streams, "summ": summ, "counts": c}
        base = same_as.get(name)
        if base in runs:
            need(streams == runs[base]["streams"],
                 f"{label} {name}: streams differ from {base}'s")
            print(f"    {label} {name} streams equal to {base}'s (8 of 8)")
    print(f"  {label} peak memory over the runs {peak:.2f} GiB")
    return runs


def serve_hymba(dev):
    """hymba-1.5b at full width, 16 of its 32 layers (``HYMBA_LAYERS``;
    bf16, seeded random weights) through ``serve_demo``: 8 requests of
    256-1024 tokens (multiples of 64, the SSD scan's prompt-length
    contract), 32 new tokens each, max_batch 4, one-shot prefills
    (flash_prefill at G = 5 and ssd_prefill at ds 16 in every layer), the
    runs of ``serve_plan``: layers x decode steps (warm-up window
    included), layers x prefills.  Then one graph window == eager over a
    full-width state, and the decode-step and prefill profiles."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"),
                              n_layers=HYMBA_LAYERS)
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    reqs = dict(n_requests=8, prompt_len=(256, 1024), prompt_multiple=64,
                max_new=32, n_layers=HYMBA_LAYERS)
    runs = serve_plan(dev, "hymba-1.5b", model, "hymba", reqs,
                      lambda **kw: path_counts(cfg.n_layers, 8, ssd=True,
                                               **kw))
    # the SSD scan's contract: multiples of 64
    rows = [dataclasses.replace(r, prompt_len=-(-r.prompt_len // 64) * 64)
            for r in generate_rows(4, prompt_len=(700, 1000), max_tokens=1,
                                   seed=3)]
    graph_vs_eager(dev, cfg, model, HelixConfig(),
                   [prompt_tokens(r, cfg.vocab) for r in rows])
    profile_decode(dev, cfg, model, HelixConfig())
    prof = {label: profile_prefill(dev, cfg, model, HelixConfig(), key,
                                   label)
            for key, label in (("prefill_wgmma", "flash_prefill"),
                               ("ssd_", "ssd_prefill"))}
    del model
    torch.cuda.empty_cache()
    return {"runs": runs, "prefill": prof}


def serve_moe(dev):
    """granite-moe-1b-a400m at full width, 12 of its 24 layers
    (``MOE_LAYERS``; bf16, seeded random weights, 32 experts, top 8)
    through ``serve_demo``: 8 requests of
    128-1024 tokens, 32 new tokens each, max_batch 4, one-shot prefills
    (flash_prefill at G = 2, the MoE at capacity factor 1.25), the runs of
    ``serve_plan``: layers x decode steps (warm-up window included),
    layers x prefills.  Then one graph window == eager over a full-width
    state, the decode-step profile with the MoE FFNs' device time and
    share, and the prefill profile."""
    cfg = dataclasses.replace(get_config(MOE), n_layers=MOE_LAYERS)
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    reqs = dict(n_requests=8, prompt_len=(128, 1024), max_new=32,
                n_layers=MOE_LAYERS)
    runs = serve_plan(dev, MOE, model, "moe", reqs,
                      lambda **kw: path_counts(cfg.n_layers, 8, **kw))
    prompts = [prompt_tokens(r, cfg.vocab) for r in generate_rows(
        4, prompt_len=(700, 1000), max_tokens=1, seed=3)]
    graph_vs_eager(dev, cfg, model, HelixConfig(), prompts)
    step = profile_decode(dev, cfg, model, HelixConfig())
    moe_ms = profile_moe_decode(dev, cfg, model)
    tl = (1000, 900, 800, 700)
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    kv = 2 * cfg.n_layers * cfg.kv_dim * 2 * sum(tl)
    bound = (wbytes + kv) / HBM_BPS * 1e3
    expert_bytes = sum(getattr(lp.moe, w).numel() * 2 for lp in model.layers
                       for w in ("w1", "w2", "w3"))
    share = (None if step["device_ms"] is None or moe_ms is None
             else moe_ms / step["device_ms"])
    print(f"  moe decode step (B=4, lengths 700-1000): device "
          f"{fmt_ms(step['device_ms'])} per step against its byte bound "
          f"{bound:.4f} ms ({wbytes / 1e9:.3f} GB of weights, "
          f"{expert_bytes / 1e9:.3f} GB of them experts, {kv / 1e6:.1f} MB "
          f"of K/V); MoE FFNs {fmt_ms(moe_ms)} per step "
          f"({cfg.n_layers} layers, profiler kernel records at the step's "
          f"shapes), share of the step's device time "
          f"{'not measured' if share is None else f'{share:.3f}'}")
    prof = profile_prefill(dev, cfg, model, HelixConfig(), "prefill_wgmma",
                           "flash_prefill")
    del model
    torch.cuda.empty_cache()
    return {"runs": runs, "prefill": prof,
            "decode": dict(step, moe_ms=moe_ms, share=share,
                           bound_ms=bound)}


def serve_gemma3(dev):
    """gemma3-12b at full width, 24 of its 48 layers (``GEMMA_LAYERS``: 20
    local of a 1024-token window, 4 global; bf16, seeded random weights,
    head size 256, softcap 30, tied head) through ``serve_demo``: 8 requests of 1024-2048 tokens,
    32 new tokens each, max_batch 4, one-shot prefills, so every decode
    runs past the window; the runs of ``serve_plan`` (layers x decode
    steps, warm-up window included; layers x prefills).  Then the chunked
    runs of ``serve_shared`` over 8 requests of 1024-1536 tokens sharing
    their first 512 (chunks of 256, paged; unshared, prefix-shared,
    grouped: equal streams; the shared prefix falls partly or wholly out
    of the local layers' windows), one graph window == eager over a
    full-width state, the decode-step profile beside its byte bound and
    the profile of a 2048-token prefill beside its operation bound.  Peak
    memory after the model is built, after the int8 head is quantized and
    after each run."""
    cfg = dataclasses.replace(get_config(GEMMA), n_layers=GEMMA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    mem = {"model_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.cuda.reset_peak_memory_stats()
    prepare_decode_params(model, KV8_W8)        # the int8 head, in blocks
    torch.cuda.synchronize()
    mem["int8_head_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  gemma3 model: {wbytes / 1e9:.3f} GB of bf16 weights; peak "
          f"memory {mem['model_gib']:.2f} GiB after the build, "
          f"{mem['int8_head_gib']:.2f} GiB while the int8 head "
          f"[{GE_D}, {GE_VP}] was quantized in column blocks")
    reqs = dict(n_requests=8, prompt_len=(1024, 2048), max_new=32,
                n_layers=GEMMA_LAYERS)
    runs = serve_plan(dev, GEMMA, model, "gemma3", reqs,
                      lambda **kw: path_counts(cfg.n_layers, 8, **kw))
    shared = serve_shared(dev, cfg, model, (1024, 1536), label="gemma3 ",
                          profile=dict(tl=GE_TL, cap=GE_CAP))
    prompts = [prompt_tokens(r, cfg.vocab) for r in generate_rows(
        4, prompt_len=(1100, 1500), max_tokens=1, seed=3)]
    graph_vs_eager(dev, cfg, model, HelixConfig(), prompts)
    step = profile_decode(dev, cfg, model, HelixConfig(), tl=GE_TL,
                          cap=GE_CAP)
    wins = layer_windows(cfg)
    kv = sum(2 * cfg.kv_dim * 2 * sum(min(x, w) if w else x for x in GE_TL)
             for w in wins)
    bound = (wbytes + kv) / HBM_BPS * 1e3
    print(f"  gemma3 decode step (B=4, lengths {list(GE_TL)}): device "
          f"{fmt_ms(step['device_ms'])} per step against its byte bound "
          f"{bound:.4f} ms ({wbytes / 1e9:.3f} GB of weights, {kv / 1e9:.3f} "
          f"GB of K/V in the windows: {wins.count(0)} global, "
          f"{len(wins) - wins.count(0)} local layers)")
    t = 2048
    pairs = {w: sum(min(j + 1, w) if w else j + 1 for j in range(t))
             for w in set(wins)}
    ops = (2 * t * (wbytes // 2 - cfg.d_model * (2 * cfg.n_layers + 1))
           + sum(4 * cfg.q_dim * pairs[w] for w in wins))
    torch.cuda.reset_peak_memory_stats()
    prof = profile_prefill(dev, cfg, model, HelixConfig(), "prefill_wgmma",
                           "flash_prefill", t=t)
    prof["bound_ms"] = ops / PEAK[torch.bfloat16] * 1e3
    mem["prefill_2048_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  gemma3 prefill (B=1, T={t}): device "
          f"{fmt_ms(prof['device_ms'])} against its operation bound "
          f"{prof['bound_ms']:.4f} ms ({ops / 1e12:.2f} TFLOP at "
          f"{PEAK[torch.bfloat16] / 1e12:.0f} TFLOP/s); peak memory "
          f"{mem['prefill_2048_gib']:.2f} GiB")
    del model
    torch.cuda.empty_cache()
    return {"runs": runs, "shared": shared, "prefill": prof,
            "decode": dict(step, bound_ms=bound), "memory": mem}


def serve_dense(dev, arch, label, *, n_layers=0, names=PLAN_RUNS,
                shared=SHARED_RUNS, profiles=True, graph=False):
    """A dense GQA model at full width (its first ``n_layers`` layers when
    given, a depth cut; bf16, seeded random weights, untied head) through
    ``serve_demo``: peak memory after the model is built and after the int8
    head is quantized; 8 requests of 128-1024 tokens, 32 new tokens each,
    max_batch 4, one-shot prefills, the runs ``names`` of ``serve_plan``
    (layers x decode steps, warm-up window included; layers x prefills),
    each with its peak memory; the chunked runs ``shared`` of
    ``serve_shared`` over 8 requests of 768-1024 tokens sharing their first
    512 (prefix_pass in c); with ``graph`` one graph window == eager over a
    full-width state; with ``profiles`` the decode-step profile beside its
    byte bound (every weight but the embedding table once, and the K/V of
    the 4 rows) and the profile of a 1024-token prefill beside its
    operation bound (every product of the forward, the head over all 1024
    positions as ``forward`` computes it, and the causal attention)."""
    cfg = get_config(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    depth = (f"{cfg.n_layers} of {get_config(arch).n_layers} layers"
             if n_layers else f"{cfg.n_layers} layers")
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    mem = {"model_gib": torch.cuda.max_memory_allocated() / 2**30}
    torch.cuda.reset_peak_memory_stats()
    prepare_decode_params(model, KV8_W8)        # the int8 head, in blocks
    torch.cuda.synchronize()
    mem["int8_head_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label} model ({depth}): {wbytes / 1e9:.3f} GB of bf16 "
          f"weights; peak memory {mem['model_gib']:.2f} GiB after the build,"
          f" {mem['int8_head_gib']:.2f} GiB while the int8 head "
          f"[{cfg.d_model}, {cfg.padded_vocab}] was quantized in column "
          "blocks")
    reqs = dict(n_requests=8, prompt_len=(128, 1024), max_new=32)
    if n_layers:
        reqs["n_layers"] = n_layers
    runs = serve_plan(dev, arch, model, f"{label}", reqs,
                      lambda **kw: path_counts(cfg.n_layers, 8, **kw),
                      names=names)
    out = {"runs": runs, "memory": mem}
    if shared:
        out["shared"] = serve_shared(dev, cfg, model, (768, 1024),
                                     label=f"{label} ", names=shared,
                                     profile=None if profiles else False)
    if graph:
        prompts = [prompt_tokens(r, cfg.vocab) for r in generate_rows(
            4, prompt_len=(700, 1000), max_tokens=1, seed=3)]
        graph_vs_eager(dev, cfg, model, HelixConfig(), prompts)
    if profiles:
        tl, t = (1000, 900, 800, 700), 1024
        step = profile_decode(dev, cfg, model, HelixConfig(), tl=tl)
        read = wbytes - model.embed.numel() * 2
        kv = 2 * cfg.n_layers * cfg.kv_dim * 2 * sum(tl)
        bound = (read + kv) / HBM_BPS * 1e3
        print(f"  {label} decode step (B=4, lengths 700-1000, {depth}): "
              f"device {fmt_ms(step['device_ms'])} per step against its "
              f"byte bound {bound:.4f} ms ({read / 1e9:.3f} GB of weights "
              f"read, the embedding table not; {kv / 1e6:.1f} MB of K/V)")
        mm = (read // 2 - cfg.d_model * (2 * cfg.n_layers + 1))
        ops = 2 * t * mm + cfg.n_layers * 4 * cfg.q_dim * t * (t + 1) // 2
        torch.cuda.reset_peak_memory_stats()
        prof = profile_prefill(dev, cfg, model, HelixConfig(),
                               "prefill_wgmma", "flash_prefill", t=t)
        prof["bound_ms"] = ops / PEAK[torch.bfloat16] * 1e3
        mem["prefill_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"  {label} prefill (B=1, T={t}, {depth}): device "
              f"{fmt_ms(prof['device_ms'])} against its operation bound "
              f"{prof['bound_ms']:.4f} ms ({ops / 1e12:.2f} TFLOP at "
              f"{PEAK[torch.bfloat16] / 1e12:.0f} TFLOP/s); peak memory "
              f"{mem['prefill_gib']:.2f} GiB")
        out.update(prefill=prof, decode=dict(step, bound_ms=bound))
    del model
    gc.collect()          # engines and graphs that held the model
    torch.cuda.empty_cache()
    return out


def profile_moe_decode(dev, cfg, model, n=5):
    """Device time (ms) of the MoE FFNs of one decode step: every layer's
    ``moe_ffn`` at the step's shape (4 bf16 rows, the decode capacity
    factor) over the model's own weights, from torch.profiler's kernel
    records; None when the profiler saw no device events."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=dev).manual_seed(33)
    xs = [torch.randn(4, cfg.d_model, generator=g, device=dev).to(
        torch.bfloat16) for _ in model.layers]
    cf = cfg.moe.decode_capacity_factor

    def run():
        for lp, x in zip(model.layers, xs):
            moe_lib.moe_ffn(lp.moe, x, cfg.moe, F.silu, capacity_factor=cf)

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    device = sum(getattr(e, "self_device_time_total", 0)
                 for e in prof.key_averages()
                 if not e.key.startswith("aten::")) / n / 1e3
    return device if device > 0 else None


class RouteLog:
    """While active, records every ``moe.route`` call's ``expert_idx`` and,
    per token, the gap between its k-th and (k+1)-th router probability
    (how far the route is from a tie)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        self._route = route = moe_lib.route

        def logged(router_w, x, m):
            r = route(router_w, x, m)
            p = torch.softmax(x.float() @ router_w, -1).sort(
                -1, descending=True).values
            self.calls.append((r.expert_idx, p[:, m.topk - 1] - p[:, m.topk]))
            return r

        moe_lib.route = logged
        return self

    def __exit__(self, *exc):
        moe_lib.route = self._route


class RouteTap(RouteLog):
    """A ``RouteLog`` that files the routes behind each token by ``(rid,
    token)``: every layer's experts ``[L, n, k]`` and gaps ``[L, n]`` of
    the ``n`` rows that made it (a decode step's slot, n = 1; for token 0
    every position of the prompt's one-shot prefill), on the CPU.
    ``mark()`` before a step, ``file(n0, key, rows)`` after it,
    ``drop(n0)`` when the step's rows are filed."""

    def __init__(self):
        super().__init__()
        self.by_token = {}

    def mark(self):
        return len(self.calls)

    def file(self, n0, key, rows):
        calls = self.calls[n0:]
        self.by_token[key] = (
            torch.stack([idx[rows] for idx, _ in calls]).cpu(),
            torch.stack([gap[rows] for _, gap in calls]).float().cpu())

    def drop(self, n0):
        del self.calls[n0:]

    def prefill(self, prefill, prompts):
        """``prefill`` filing each one-shot prefill's positions under
        ``(rid, 0)``."""
        rids = {tuple(p): i for i, p in enumerate(prompts)}

        def step(model_, batch):
            n0 = self.mark()
            out = prefill(model_, batch)
            self.file(n0, (rids[tuple(batch["tokens"][0].tolist())], 0),
                      slice(None))
            self.drop(n0)
            return out

        return step


def route_flips(tag, calls, base, layers):
    """The routes of two runs, call by call (prefill then steps, ``layers``
    calls each): prints each token whose experts differ, where and by how
    much its base route was from a tie.  Returns the number of such
    tokens."""
    need(len(calls) == len(base), f"{tag}: {len(calls)} routes vs "
         f"{len(base)}")
    flips = 0
    for i, ((idx, _), (bidx, gap)) in enumerate(zip(calls, base)):
        rows = (idx != bidx).any(-1).nonzero().flatten().tolist()
        flips += len(rows)
        for r in rows[:4]:
            print(f"  {tag}: {'prefill' if i < layers else f'step {i // layers}'}"
                  f" layer {i % layers} token {r}: experts "
                  f"{idx[r].tolist()} vs {bidx[r].tolist()}, gap between "
                  f"the k-th and (k+1)-th probability {gap[r].item():.3g}")
    return flips


def compare_small(dev, arch, seed, plain, label, n_layers=4, t=256,
                  s_cap=512, extra=None):
    """An ``n_layers``-layer f32 model of ``arch`` at full width: prefill
    (``t`` tokens, and the batch leaves ``extra(cfg, g)`` makes: frame or
    patch embeddings) + 4 decode steps, the kernel path against the plain
    path (``plain`` backends, ``ref``, on the card), kvp 4 against kvp 1,
    fp and with the int8 head and KV cache: logits within LOGIT_TOL x
    max(1, |logits|) and the same greedy tokens; an MoE's routes equal in
    every layer and step."""
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    model = init_params(cfg, 1, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    toks = torch.randint(0, cfg.vocab, (1, t), generator=g, device=dev)
    batch = {"tokens": toks, **(extra(cfg, g) if extra else {})}
    runs, routes = {}, {}
    for name, hx in (("kernel kvp=1", HelixConfig(kvp=1)),
                     ("plain kvp=1", HelixConfig(kvp=1, **plain)),
                     ("kernel kvp=4", HelixConfig(kvp=4)),
                     ("int8 kernel kvp=1", KV8_W8),
                     ("int8 plain kvp=1",
                      dataclasses.replace(KV8_W8, **plain)),
                     ("int8 kernel kvp=4",
                      dataclasses.replace(KV8_W8, kvp=4))):
        prepare_decode_params(model, hx)
        with RouteLog() as log:
            logits, state = make_prefill_step(cfg, hx, s_cap=s_cap)(
                model, batch)
            if hx.kv_cache_bits == 8:
                state = quantize_decode_state(state)
            state["total_len"] = torch.full((1,), t, dtype=torch.int32,
                                            device=dev)
            step = build_serve_step(cfg, hx, return_logits=True)
            cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
            out = [logits]
            for _ in range(4):
                (cur, lg), state = step(model, state, cur)
                out.append(lg)
        runs[name] = torch.stack(out)[..., :cfg.vocab]
        routes[name] = log.calls
    torch.cuda.synchronize()
    for base_name, names in (("kernel kvp=1", ("plain kvp=1",
                                               "kernel kvp=4")),
                             ("int8 kernel kvp=1", ("int8 plain kvp=1",
                                                    "int8 kernel kvp=4"))):
        base = runs[base_name]
        for name in names:
            e, scale = maxerr(runs[name], base), base.abs().max().item()
            print(f"  {n_layers}-layer f32 {label} prefill ({t}) + 4 "
                  f"decode logits, {name} vs "
                  f"{base_name}: max err {e:.3g} (|logits| <= {scale:.3g}, "
                  f"tol {LOGIT_TOL:g} x max(1, |logits|))")
            need(e <= LOGIT_TOL * max(1.0, scale),
                 f"{label} {name} disagrees")
            need(torch.equal(runs[name].argmax(-1), base.argmax(-1)),
                 f"{label} {name}: greedy tokens differ")
            if cfg.moe:
                base_routes = routes[base_name]
                flips = route_flips(f"{label} {name}", routes[name],
                                    base_routes, cfg.n_layers)
                need(not flips, f"{label} {name}: {flips} tokens routed "
                     f"otherwise than in {base_name}")
                gap = min(gp.min().item() for _, gp in base_routes)
                print(f"    routes equal to {base_name}'s in all "
                      f"{len(base_routes)} calls ({cfg.n_layers} layers x "
                      f"(prefill + 4 steps)); smallest gap to a tie "
                      f"{gap:.3g}")
    del model
    torch.cuda.empty_cache()


def compare_hymba(dev):
    """4-layer f32 hymba at full width (``compare_small``)."""
    compare_small(dev, "hymba-1.5b", 27, dict(
        attn_backend="ref", prefill_backend="ref", ssd_backend="ref",
        matmul_backend="ref"), "hymba")


def compare_gemma3(dev):
    """One whole local:global period of gemma3-12b (6 layers: 5 local, 1
    global) at full width, f32 (``compare_small``): a 1280-token prefill,
    past the window, then 4 decode steps."""
    compare_small(dev, GEMMA, 43, dict(attn_backend="ref",
                                       prefill_backend="ref",
                                       matmul_backend="ref"), "gemma3",
                  n_layers=6, t=1280, s_cap=1344)


def compare_moe(dev):
    """4-layer f32 granite-moe at full width (``compare_small``), routes
    equal in every layer between the compared runs."""
    compare_small(dev, MOE, 34, dict(attn_backend="ref",
                                     prefill_backend="ref",
                                     matmul_backend="ref"), "moe")


def profile_prefill(dev, cfg, model, hx, kernel, label, t=1024):
    """Host wall time vs device time of one-shot prefills of ``t`` tokens
    (torch.profiler), the share of the prefill kernel's launches whose
    profiler names contain ``kernel`` (``label`` in the output), and the
    three kernels that take the most device time.  Returns
    ``{"wall_ms", "device_ms", "kernel_ms", "share"}`` (device numbers None
    when the profiler saw no device events)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=dev).manual_seed(14)
    toks = torch.randint(0, cfg.vocab, (1, t), generator=g, device=dev)
    step = make_prefill_step(cfg, hx)
    step(model, {"tokens": toks})
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(model, {"tokens": toks})
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    rows = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    device = sum(dev_us(e) for e in rows
                 if not e.key.startswith("aten::")) / n / 1e3
    mine = sum(dev_us(e) for e in rows if kernel in e.key) / n / 1e3
    if device > 0:
        print(f"  {cfg.name} prefill profile (B=1, T={t}): host wall "
              f"{wall:.2f} ms, device kernels {device:.2f} ms, busy share "
              f"{device / wall:.3f}, {label} {mine:.2f} ms "
              f"({cfg.n_layers} launches, {mine / device:.3f} of the device "
              "time)")
        top = sorted((e for e in rows if not e.key.startswith("aten::")),
                     key=dev_us, reverse=True)[:3]
        print("    largest kernels: " + "; ".join(
            f"{e.key[:60]} {dev_us(e) / n / 1e3:.2f} ms ({e.count // n} a "
            "prefill)" for e in top))
        return {"wall_ms": wall, "device_ms": device, "kernel_ms": mine,
                "share": mine / device}
    print(f"  {cfg.name} prefill profile: host wall {wall:.2f} ms; "
          "device time not measured (the profiler saw no device events)")
    return {"wall_ms": wall, "device_ms": None, "kernel_ms": None,
            "share": None}


def paged_prefill_path(dev):
    """B2's paged mode at granite widths over a 40-layer pool: one ragged
    chunk step of 4 requests (totals 1024, 900, 512 and 300 tokens, the
    last 256 of each in the chunk, so q_offset is per request) whose
    earlier positions sit in 16-position pages under a shuffled table,
    one paged flash_prefill per layer on that layer's pool planes.  No
    serving path of the JAX package calls this mode, so the run drives the
    kernel's public function as a chunked prefill over a pool would.  The
    counts are set to 0 just before the 40 calls and read just after;
    then every layer's output must equal the fixed layout's bit for bit."""
    cfg = get_config("granite-3-2b")
    g = torch.Generator(device=dev).manual_seed(16)
    nl, page, t, s = cfg.n_layers, 16, 256, 1024
    lens = torch.tensor([1024, 900, 512, 300], dtype=torch.int32, device=dev)
    offs = lens - t
    tab, n_pool = shuffled_tables(torch.Generator().manual_seed(17), lens,
                                  page, s // page)
    tab = tab.to(dev)
    rnd = lambda *sh: torch.randn(*sh, generator=g,
                                  device=dev).to(torch.bfloat16)
    q, k, v = rnd(nl, 4, t, QH, HSZ), rnd(nl, 4, s, KH, HSZ), \
        rnd(nl, 4, s, KH, HSZ)
    junk = sink_garbage(g, dev, page)
    kpool = torch.stack([prefill_pool(k[i], tab, n_pool, page, junk)
                         for i in range(nl)])
    vpool = torch.stack([prefill_pool(v[i], tab, n_pool, page, junk)
                         for i in range(nl)])
    kw = dict(causal=True, q_offset=offs, seq_lens=lens)
    torch.cuda.synchronize()
    registry.reset_launch_counts()
    t0 = time.perf_counter()
    outs = [flash_prefill(q[i], kpool[i], vpool[i], block_tables=tab, **kw)
            for i in range(nl)]
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    counts = registry.launch_counts()
    want = {name: 0 for name in counts}
    want.update(flash_prefill=nl, flash_prefill_paged=nl)
    print(f"  paged prefill path: {nl} layers x 1 chunk of 4 x {t} tokens "
          f"(totals {lens.tolist()}), pool of {n_pool} pages of {page}, "
          f"host wall {wall:.2f} ms; launches {counts} (expected {want})")
    need(counts == want, f"paged prefill path: launch counts {counts} != "
                         f"expected {want}")
    same = all(torch.equal(bits(o), bits(flash_prefill(q[i], k[i], v[i],
                                                       **kw)))
               for i, o in enumerate(outs))
    fin = all(torch.isfinite(o).all().item() and o.shape == (4, t, QH, HSZ)
              for o in outs)
    print(f"  paged prefill path: every layer == the fixed layout bit for "
          f"bit: {same}; outputs finite, shape [4, {t}, {QH}, {HSZ}]: {fin}")
    need(same and fin, "paged prefill path: outputs differ from the fixed "
                       "layout's or are not finite")
    return counts


def serve_prefix(dev, cfg, model, fp_streams):
    """Chunked prefill, prefix sharing and grouped decode at full width: 8
    requests of 768-1024 tokens, the first 512 shared, budgets 16-48
    (retirements stagger, so later admissions map live shared pages),
    chunks of 256, max_batch 4, the default pool: (a) paged chunked, (b) +
    prefix_share, (c) + grouped_decode, with equal streams; then (d) the
    fp run's requests chunked on the fixed layout against the one-shot
    fp run (``chunked_vs_oneshot``).  Counts set to 0 just before each
    run."""
    out = serve_shared(dev, cfg, model, (768, 1024))
    out.update(chunked_vs_oneshot(dev, cfg, model, fp_streams))
    return out


def serve_shared(dev, cfg, model, prompt_len, label="", profile=None,
                 names=SHARED_RUNS):
    """The runs (a)-(c) of ``serve_prefix`` for ``cfg`` (those of
    ``names``): 8 requests of ``prompt_len`` tokens whose first 512 are
    shared, budgets 16-48, chunks of 256, paged, max_batch 4, kvp 1: (a)
    unshared, (b) with prefix sharing, (c) with grouped decode as well,
    equal streams where (a) ran; the launch counts layers x decode steps
    (grouped mode and prefix_pass in c) and layers x chunks, set to 0 just
    before each run.  Then the grouped decode step's profile
    (``profile_decode``'s shape arguments in ``profile``; ``False``: none).
    A config cut in depth (``cfg.n_layers`` below its arch's) is served
    so.  Returns the runs by name."""
    paged = dict(paged_kv=True, n_requests=8, prompt_len=prompt_len,
                 max_new=(16, 48), shared_prefix_len=512)
    if cfg.n_layers != get_config(cfg.name).n_layers:
        paged["n_layers"] = cfg.n_layers
    plan = (("a paged chunked", paged),
            ("b + prefix_share", dict(paged, prefix_share=True)),
            ("c + grouped_decode", dict(paged, prefix_share=True,
                                        grouped_decode=True)))
    out = {}
    for name, extra in (p for p in plan if p[0] in names):
        print(f"  -- {label}{name}: {extra}")
        registry.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        fin, summ = serve_demo(cfg.name, max_batch=4, kvp=1,
                               chunk_tokens=256, dtype=torch.bfloat16,
                               device=dev, model=model, seed=0, **extra)
        counts = registry.launch_counts()
        steps = summ["decode_syncs"]
        need(len(fin) == 8 and all(r.finish_reason == "max_tokens"
                                   for r in fin),
             f"serve {label}{name}: {[r.finish_reason for r in fin]}")
        grouped = "grouped_decode" in extra
        want = {"flash_decode": cfg.n_layers * steps, "flash_decode_kv8": 0,
                "flash_decode_paged": cfg.n_layers * steps,
                "flash_decode_grouped": cfg.n_layers * steps if grouped
                else 0,
                "prefix_pass": cfg.n_layers * steps if grouped else 0,
                "flash_prefill": cfg.n_layers * summ["prefill_calls"],
                "flash_prefill_paged": 0, "w8a16_matmul": 0,
                "ssd_prefill": 0, **NO_ENCDEC}
        live = summ["grouped_steps"] * cfg.n_layers
        print(f"  {len(fin)} requests, prompts "
              f"{sorted(len(r.prompt) for r in fin)}, {summ['n_tokens']} "
              f"tokens, TTFT p50 {summ['ttft_s']['p50'] * 1e3:.1f} ms, TTL "
              f"p50 {summ['ttl_s']['p50'] * 1e3:.2f} ms, {summ['tok_s']:.1f} "
              f"tok/s, {steps} decode steps, {summ['prefill_calls']} prefill "
              f"chunks; prefix_hit_rate {summ['prefix_hit_rate']:.4f}, "
              f"pages_shared_peak {summ['pages_shared_peak']}, "
              f"prefix_pass launches with gnp > 0: {live}, peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        print(f"  launches {counts} (expected {want})")
        need(counts == want and steps > 0,
             f"serve {label}{name}: launch counts {counts} != expected "
             f"{want}")
        streams = {r.rid: r.out_tokens for r in fin}
        if name != "a paged chunked" and "a paged chunked" in out:
            base = out["a paged chunked"]["streams"]
            same = sum(streams[r] == base[r] for r in streams)
            print(f"  streams equal the unshared run's: {same} of 8")
            need(same == 8, f"serve {label}{name}: streams differ from "
                            "unshared")
        if name != "a paged chunked":
            need(summ["pages_shared_peak"] > 0
                 and summ["prefix_hit_rate"] > 0,
                 f"serve {label}{name}: nothing was shared")
            need(not grouped or live > 0,
                 f"serve {label}{name}: no prefix_pass launch had a group")
        out[name] = {"counts": counts, "summ": summ, "streams": streams}
        if grouped and profile is not False:
            profile_decode(dev, cfg, model, HelixConfig(paged_kv=True,
                                                        grouped_decode=True),
                           **(profile or {}))
    return out


def recording_prefill(cfg, prefill, prompts, firsts):
    """``prefill`` keeping each one-shot prefill's last logits row (CPU)
    in ``firsts`` under the rid of its prompt; ``prefill`` itself when
    ``firsts`` is None."""
    if firsts is None:
        return prefill
    rids = {tuple(p): i for i, p in enumerate(prompts)}

    def step(model_, batch):
        last, state = prefill(model_, batch)
        firsts[rids[tuple(batch["tokens"][0].tolist())]] = \
            last[0, :cfg.vocab].cpu()
        return last, state

    return step


def recorded_run(dev, cfg, model, prompts, chunk, hx=None, firsts=None):
    """The fp path's engine over ``prompts`` (32 tokens each, max_batch 4,
    the fixed layout), one-shot (``chunk`` 0) or chunked, with a decode
    step that keeps each decoding request's logits row; ``hx`` defaults to
    ``HelixConfig()``; ``firsts`` (a dict, one-shot) receives each
    request's prefill logits by rid.  Returns (streams, logits by rid,
    prefill calls, decode steps)."""
    hx = hx or HelixConfig()
    logits: dict[int, list] = {}
    inner = build_serve_step(cfg, hx, return_logits=True)
    holder = {}

    def step(model_, state, tokens):
        (nxt, lg), state = inner(model_, state, tokens)
        for i, r in enumerate(holder["engine"].slots):
            if r is not None and r.state == DECODE:
                logits.setdefault(r.rid, []).append(lg[i, :cfg.vocab])
        return nxt, state

    eng = DecodeEngine(
        cfg, model, step, recording_prefill(cfg, make_prefill_step(cfg, hx),
                                            prompts, firsts), max_batch=4,
        max_seq=max(len(p) for p in prompts) + 33, hx=hx,
        dtype=torch.bfloat16, device=dev, chunk_tokens=chunk,
        chunk_prefill_step=make_chunk_prefill_step(cfg, hx) if chunk
        else None)
    holder["engine"] = eng
    reqs = [Request(rid=i, prompt=p, max_new_tokens=32)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    while eng.pending():
        eng.step()
    return ({r.rid: r.out_tokens for r in reqs}, logits, eng.prefill_calls,
            eng.decode_syncs)


def chunked_vs_oneshot(dev, cfg, model, fp_streams):
    """(d): the fp run's 8 requests chunked (256) on the fixed layout
    against the same requests prefilled one-shot, both with their decode
    logits recorded.  The one-shot streams must be the fp run's.  Greedy
    streams must be equal, and the logits of every decode step up to a
    request's first differing token within BF16_LOGIT_TOL, so a stream
    may part only at a near-tie (the two tokens' logits within twice the
    tolerance).  Then which level of chunked == one-shot holds: the decode
    caches of one 1000-token prompt both ways, and bf16 products of the
    model's projection shapes over the first M of 1024 rows against the
    same rows of the 1024-row product."""
    rows = generate_rows(8, prompt_len=(128, 1024), max_tokens=32, seed=0)
    prompts = [prompt_tokens(r, cfg.vocab) for r in rows]
    one, lone, _, _ = recorded_run(dev, cfg, model, prompts, 0)
    need(one == fp_streams, "(d) one-shot recorded run differs from the fp "
                            "run")
    print("  -- d fixed chunked: the fp run's requests, chunks of 256")
    registry.reset_launch_counts()
    ch, lch, calls, steps = recorded_run(dev, cfg, model, prompts, 256)
    counts = registry.launch_counts()
    want = {"flash_decode": cfg.n_layers * steps, "flash_decode_kv8": 0,
            "flash_decode_paged": 0, "flash_decode_grouped": 0,
            "prefix_pass": 0, "flash_prefill": cfg.n_layers * calls,
            "flash_prefill_paged": 0, "w8a16_matmul": 0, "ssd_prefill": 0,
            **NO_ENCDEC}
    print(f"  {steps} decode steps, {calls} prefill chunks; launches "
          f"{counts} (expected {want})")
    need(counts == want, f"(d) launch counts {counts} != expected {want}")
    same, flips, worst, exact = 0, [], 0.0, 0
    for rid in range(8):
        a, b = one[rid], ch[rid]
        first = next((i for i in range(len(a)) if a[i] != b[i]), None)
        same += first is None
        n = len(a) - 1 if first is None else first
        need(first is None or first >= 1,
             f"(d) rid {rid}: the first tokens differ")
        errs = [maxerr(lone[rid][j], lch[rid][j]) for j in range(n)]
        exact += all(torch.equal(lone[rid][j], lch[rid][j])
                     for j in range(n))
        worst = max([worst] + errs)
        if first is not None:
            lg = lone[rid][first - 1].float()
            flips.append((rid, first,
                          float(lg[a[first]] - lg[b[first]])))
    print(f"  chunked streams equal the one-shot streams: {same} of 8; "
          f"decode logits bit-equal for {exact} of 8 requests; max logit "
          f"err up to the first differing token {worst:.4g} (tol "
          f"{BF16_LOGIT_TOL:g}); streams parting at a near-tie (rid, token,"
          f" one-shot logit gap): {flips}")
    need(worst <= BF16_LOGIT_TOL, "(d) logits beyond the tolerance")
    # which level holds: caches of one 1000-token prompt, one-shot vs
    # chunked; and the M of each chunk product against one product of all
    hx = HelixConfig()
    toks = torch.randint(0, cfg.vocab, (1, 1000), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(5))
    _, st1 = make_prefill_step(cfg, hx)(model, {"tokens": toks})
    bufs = init_prefill_buffers(cfg, 1, 1000, dtype=torch.bfloat16,
                                device=dev)
    cstep = make_chunk_prefill_step(cfg, hx)
    for p in range(0, 1000, 256):
        _, bufs = cstep(model, toks[:, p:p + 256], bufs,
                        torch.tensor([p], dtype=torch.int32, device=dev))
    st2 = finalize_chunked_prefill(cfg, hx, bufs, 1000)
    bit = all(torch.equal(bits(st1[k]), bits(st2[k]))
              for k in ("kcache", "vcache"))
    print(f"  full width bf16, 1000 tokens, chunks of 256: decode caches "
          f"{'bit-equal' if bit else 'not bit-equal'} to the one-shot "
          f"prefill's (max err "
          f"{max(maxerr(st1[k], st2[k]) for k in ('kcache', 'vcache')):.3g})")
    g = torch.Generator(device=dev).manual_seed(6)
    for k_, n_ in ((D_MODEL, D_MODEL), (D_MODEL, 512), (D_MODEL, 8192),
                   (8192, D_MODEL)):
        x = torch.randn(1024, k_, generator=g, device=dev).to(torch.bfloat16)
        w = torch.randn(k_, n_, generator=g, device=dev).to(torch.bfloat16)
        full = x @ w
        eq = [m for m in (1, 4, 100, 142, 161, 180, 232, 255, 256, 512, 768)
              if torch.equal(x[:m] @ w, full[:m])]
        print(f"  bf16 [M, {k_}] @ [{k_}, {n_}]: rows bit-equal to the "
              f"1024-row product at M = {eq}")
    return {"d fixed chunked": {"counts": counts, "streams": ch}}


def profile_decode(dev, cfg, model, hx, tl=(1000, 900, 800, 700),
                   cap=1088):
    """Host wall time vs device kernel time of one decode step at the serve
    shape (4 rows of ``tl`` tokens, 700-1000 by default, capacity ``cap``),
    from torch.profiler; with
    ``hx.paged_kv`` the same caches in a pool under a shuffled table; with
    ``hx.grouped_decode`` the 4 rows also map the same first 32 pages (512
    positions) and form one group; an SSM arch's 4 rows carry random
    ``ssm_state`` leaves instead of caches.  Returns ``{"wall_ms",
    "device_ms"}`` per step (``device_ms`` None when the profiler saw no
    device events)."""
    from torch.profiler import ProfilerActivity, profile
    state = init_decode_state(cfg, 4, cap, 1, RR, dtype=torch.bfloat16,
                              device=dev)
    for key in ("kcache", "vcache", "ssm_state"):
        if key in state:
            state[key].normal_()
    if hx.kv_cache_bits == 8:
        state = quantize_decode_state(state)
    if hx.paged_kv:
        full = torch.full((4,), cap, dtype=torch.int32)
        tab, n_pool = shuffled_tables(torch.Generator().manual_seed(10), full,
                                      RR, cap // RR)
        if hx.grouped_decode:
            tab[:, :32] = tab[0, :32]
        state = state_to_paged(state, tab, n_pool, 1, RR)
        if hx.grouped_decode:
            state["group_id"] = torch.zeros(4, dtype=torch.int32, device=dev)
            state["group_np"] = torch.full((4,), 32, dtype=torch.int32,
                                           device=dev)
    state["total_len"] = torch.tensor(tl, dtype=torch.int32, device=dev)
    step = build_serve_step(cfg, hx)
    tok = torch.zeros(4, dtype=torch.int32, device=dev)
    for _ in range(3):
        tok, state = step(model, state, tok)
    torch.cuda.synchronize()
    n = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tok, state = step(model, state, tok)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    rows = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    # kernel and memcpy rows only: aten rows repeat their kernels' time
    device = sum(dev_us(e) for e in rows
                 if not e.key.startswith("aten::")) / n / 1e3
    ops = sum(e.count for e in rows if e.key.startswith("aten::")) / n
    per_call = {}
    for tag, keys in (("flash_decode", DECODE_KERNELS),
                      ("prefix_pass", ("prefix_kernel",)),
                      ("w8a16_matmul", ("w8a16_kernel",))):
        calls = sum(e.count for e in rows if keys[0] in e.key)
        if calls:
            per_call[tag] = sum(dev_us(e) for e in rows
                                if any(k in e.key for k in keys)) / calls / 1e3
    out = {"wall_ms": wall, "device_ms": device if device > 0 else None}
    if device > 0:
        calls = ", ".join(f"{k} {v:.4f} ms/call" for k, v in per_call.items())
        mode = ("grouped, " if hx.grouped_decode else "") + \
            ("paged, " if hx.paged_kv else "")
        print(f"  {cfg.name} decode step profile ({mode}B=4, "
              f"lengths {min(tl)}-{max(tl)}): host wall "
              f"{wall:.2f} ms/step, device kernels {device:.2f} ms/step, "
              f"busy share {device / wall:.3f}, {ops:.0f} aten ops/step, "
              f"{calls}")
    else:
        print(f"  decode step profile: host wall {wall:.2f} ms/step; device "
              "time not measured (the profiler saw no device events)")
    return out


def compare_paths(dev):
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=4)
    model = init_params(cfg, 1, dtype=torch.float32, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (1, 300), generator=g, device=dev)
    runs = {}
    plain = dict(attn_backend="ref", prefill_backend="ref",
                 matmul_backend="ref")
    for name, hx in (("kernel kvp=1", HelixConfig(kvp=1)),
                     ("plain kvp=1", HelixConfig(kvp=1, **plain)),
                     ("kernel kvp=4", HelixConfig(kvp=4)),
                     ("int8 kernel kvp=1", KV8_W8),
                     ("int8 plain kvp=1",
                      dataclasses.replace(KV8_W8, **plain)),
                     ("int8 kernel kvp=4",
                      dataclasses.replace(KV8_W8, kvp=4)),
                     ("chunked (128) kernel kvp=1", HelixConfig(kvp=1))):
        prepare_decode_params(model, hx)
        if name.startswith("chunked"):
            logits, state = chunked_prefill(cfg, hx, model, toks, 128, 512)
        else:
            logits, state = make_prefill_step(cfg, hx, s_cap=512)(
                model, {"tokens": toks})
        if hx.kv_cache_bits == 8:
            state = quantize_decode_state(state)
        state["total_len"] = torch.full((1,), 300, dtype=torch.int32,
                                        device=dev)
        step = build_serve_step(cfg, hx, return_logits=True)
        cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
        out = [logits]
        for _ in range(4):
            (cur, lg), state = step(model, state, cur)
            out.append(lg)
        runs[name] = torch.stack(out)[..., :cfg.vocab]   # real vocab rows
    torch.cuda.synchronize()
    for base_name, names in (("kernel kvp=1", ("plain kvp=1", "kernel kvp=4",
                                               "chunked (128) kernel kvp=1")),
                             ("int8 kernel kvp=1", ("int8 plain kvp=1",
                                                    "int8 kernel kvp=4"))):
        base = runs[base_name]
        for name in names:
            e = maxerr(runs[name], base)
            scale = base.abs().max().item()
            print(f"  4-layer f32 prefill+4 decode logits, {name} vs "
                  f"{base_name}: max err {e:.3g} (|logits| <= {scale:.3g}, "
                  f"tol {LOGIT_TOL:g} x max(1, |logits|))")
            need(e <= LOGIT_TOL * max(1.0, scale), f"{name} disagrees")
            need(torch.equal(runs[name].argmax(-1), base.argmax(-1)),
                 f"{name}: greedy tokens differ")
    print("  4-layer f32 chunked prefill + 4 decode logits bit-equal to the "
          "one-shot run's: "
          f"{torch.equal(bits(runs['chunked (128) kernel kvp=1']), bits(runs['kernel kvp=1']))}")


def chunked_prefill(cfg, hx, model, toks, c, s_cap):
    """Prefill ``toks`` [1, T] in chunks of ``c`` through ``forward``'s carry
    buffers; returns the last position's logits and the decode state."""
    t = toks.shape[1]
    bufs = init_prefill_buffers(cfg, 1, t, dtype=model.embed.dtype,
                                device=toks.device)
    for p in range(0, t, c):
        logits, _ = forward(cfg, model, toks[:, p:p + c], return_cache=True,
                            prefill_backend=hx.prefill_backend,
                            prefix_state=bufs, q_offset=p)
    return logits[:, -1], finalize_chunked_prefill(cfg, hx, bufs, t, s_cap)


# ------------------------------------------------------------- phase 5
def times(dev):
    g = torch.Generator(device=dev).manual_seed(4)
    dt = torch.bfloat16
    es = torch.tensor([], dtype=dt).element_size()
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
    # decode at B=8, S=4096 (every slot valid), fused append, kvp=1
    b, s = 8, 4096
    q, k, v = rnd(b, QH, HSZ), rnd(b, KH, s, HSZ), rnd(b, KH, s, HSZ)
    kn = rnd(b, KH, HSZ)
    tl = torch.full((b,), s, dtype=torch.int32, device=dev)
    kw = dict(kvp=1, n_ranks=1, rank=0, rr_block=RR, window=0,
              contiguous=False, slot_offset=0, k_new=kn, v_new=kn)
    dec = {
        **timed(lambda: flash_decode_shards(q, k, v, tl, **kw)),
        "plain_ms": time_ms(lambda: flash_decode_shards_plain(
            q, k, v, tl, scale=HSZ ** -0.5, block_s=512, **kw), iters=3,
            warmup=1),
    }
    mask = torch.ones(b, 1, 1, s, dtype=torch.bool, device=dev)
    dec["library_ms"] = queued_ms(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True))
    # every slot is valid here, so SDPA without a mask computes the same
    dec["library_unmasked_ms"] = queued_ms(
        lambda: F.scaled_dot_product_attention(q[:, :, None], k, v,
                                               enable_gqa=True))
    dbytes = (2 * b * KH * s * HSZ + 2 * b * QH * HSZ) * es + b * QH * 4
    dops = 4 * b * QH * HSZ * s
    dec.update(_bound(dbytes, dops, PEAK[dt]), library="sdpa")
    dec["device_ms"] = device_ms(lambda: flash_decode_shards(q, k, v, tl,
                                                             **kw),
                                 DECODE_KERNELS)
    cpc = last_launch["chunks_per_cta"]
    work = decode_work_items(tl.cpu(), kvp=1, n_ranks=1, rank=0, kv_heads=KH,
                             rr_block=RR, s_true=s, chunks_per_cta=cpc)
    grid = -(-decode_chunks(s, 512) // cpc) * b * KH
    print(f"  flash_decode B=8 S=4096: {work} of {grid} CTAs sweep, "
          f"{cpc} chunk(s) of {CHUNK_S} slots each (132 SMs)")
    # the same decode in int8 mode; the int8 K/V (34 MB) fits in the 50 MB
    # L2, so three copies rotate to keep every launch's reads cold, as the
    # 40 layers of a decode step find them
    copies = [quantize_kv_token(k) + quantize_kv_token(v) for _ in range(3)]
    kw8 = [dict(kscale=c[1], vscale=c[3], **kw) for c in copies]
    dec8 = {
        **timed(rotating([
            lambda c=c, w=w: flash_decode_shards(q, c[0], c[2], tl, **w)
            for c, w in zip(copies, kw8)])),
        "plain_ms": time_ms(lambda: flash_decode_shards_plain(
            q, copies[0][0], copies[0][2], tl, scale=HSZ ** -0.5,
            block_s=512, **kw8[0]), iters=3, warmup=1),
        "library_ms": None,
        "library": "no single PyTorch call attends over an int8 cache"}
    d8bytes = (2 * b * KH * s * HSZ + 2 * b * KH * s * 4
               + 2 * b * QH * HSZ * es + b * QH * 4 + 2 * b * KH * HSZ * es)
    dec8.update(_bound(d8bytes, dops, PEAK[dt]))
    dec8["device_ms"] = device_ms(rotating([
        lambda c=c, w=w: flash_decode_shards(q, c[0], c[2], tl, **w)
        for c, w in zip(copies, kw8)]), DECODE_KERNELS)
    # the paged mode at the same shape, in the same call: the same caches in
    # a pool of 1 + B*S/16 pages under a shuffled table; the int8 pools
    # rotate as the int8 caches do
    tab, n_pool = shuffled_tables(torch.Generator().manual_seed(9), tl, RR,
                                  s // RR)
    tab = tab.to(dev)

    def pool_of(x):
        return state_to_paged({"kcache": x[None]}, tab, n_pool, 1,
                              RR)["kcache"][0]

    pk, pv = pool_of(k), pool_of(v)
    decp = {
        **timed(lambda: flash_decode_shards(q, pk, pv, tl,
                                                  block_tables=tab, **kw)),
        "plain_ms": time_ms(lambda: flash_decode_shards_plain(
            q, pk, pv, tl, scale=HSZ ** -0.5, block_s=512, block_tables=tab,
            **kw), iters=3, warmup=1),
        "library_ms": None,
        "library": "no single PyTorch call attends through a block table"}
    tbytes = tab.numel() * 4
    decp.update(_bound(dbytes + tbytes, dops, PEAK[dt]))
    decp["device_ms"] = device_ms(
        lambda: flash_decode_shards(q, pk, pv, tl, block_tables=tab, **kw),
        DECODE_KERNELS)
    pcopies = [tuple(pool_of(x) for x in c) for c in copies]
    decp8 = {
        **timed(rotating([
            lambda c=c: flash_decode_shards(q, c[0], c[2], tl, kscale=c[1],
                                            vscale=c[3], block_tables=tab,
                                            **kw) for c in pcopies])),
        "plain_ms": time_ms(lambda: flash_decode_shards_plain(
            q, pcopies[0][0], pcopies[0][2], tl, scale=HSZ ** -0.5,
            block_s=512, kscale=pcopies[0][1], vscale=pcopies[0][3],
            block_tables=tab, **kw), iters=3, warmup=1),
        "library_ms": None, "library": decp["library"]}
    decp8.update(_bound(d8bytes + tbytes, dops, PEAK[dt]))
    decp8["device_ms"] = device_ms(rotating([
        lambda c=c: flash_decode_shards(q, c[0], c[2], tl, kscale=c[1],
                                        vscale=c[3], block_tables=tab, **kw)
        for c in pcopies]), DECODE_KERNELS)
    serve = times_serve_decode(dev)
    # the int8 lm_head of one decode step: M = 4 rows (max_batch), bf16
    m, kd, n = 4, D_MODEL, VP
    x = rnd(m, kd)
    qw, sc = quantize_w8(torch.randn(kd, n, generator=g, device=dev))
    lib, lib_fn = w8a16_library(x, qw, sc)
    mm = {**timed(lambda: w8a16_matmul(x, qw, sc)),
          "plain_ms": time_ms(lambda: w8a16_matmul_ref(x, qw, sc), iters=10),
          "library_ms": queued_ms(lib_fn), "library": lib,
          "ctas": w8a16_blocks(m, n),
          "device_ms": device_ms(lambda: w8a16_matmul(x, qw, sc),
                                 "w8a16_kernel")}
    mbytes = kd * n + n * 4 + m * kd * es + m * n * es
    mm.update(_bound(mbytes, 2 * m * kd * n, PEAK[dt]))
    # prefill at B=1, T=1024 causal (the longest serve prompt)
    t = 1024
    qp, kp, vp = rnd(1, t, QH, HSZ), rnd(1, t, KH, HSZ), rnd(1, t, KH, HSZ)
    pre = {
        **timed(lambda: flash_prefill(qp, kp, vp, causal=True)),
        "plain_ms": time_ms(lambda: flash_prefill_ref(qp, kp, vp, causal=True),
                            iters=10),
        "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
            qp.transpose(1, 2), kp.transpose(1, 2), vp.transpose(1, 2),
            is_causal=True, enable_gqa=True)),
    }
    pbytes = (2 * t * QH * HSZ + 2 * t * KH * HSZ) * es
    pops = 4 * QH * HSZ * (t * (t + 1) // 2)
    pre.update(_bound(pbytes, pops, PEAK[dt]), library="sdpa")
    # the paged mode at the same shape: 16-position pages, shuffled table
    full = torch.tensor([t], dtype=torch.int32)
    ptab, pn = shuffled_tables(torch.Generator().manual_seed(18), full, 16,
                               t // 16)
    ptab = ptab.to(dev)
    junk = torch.zeros(16, HSZ, device=dev)
    pkp, pvp = (prefill_pool(x, ptab, pn, 16, junk) for x in (kp, vp))
    prep = {
        **timed(lambda: flash_prefill(qp, pkp, pvp, causal=True,
                                            seq_lens=t, block_tables=ptab)),
        "plain_ms": time_ms(lambda: flash_prefill_paged_ref(
            qp, pkp, pvp, ptab, t, causal=True), iters=10),
        "library_ms": None,
        "library": "no single PyTorch call attends through a block table"}
    prep.update(_bound(pbytes + ptab.numel() * 4, pops, PEAK[dt]))
    # the chunk shape: 4 requests of 1024, chunk 256 at offsets 0..768
    cb, ct = 4, 256
    qc, kc, vc = rnd(cb, ct, QH, HSZ), rnd(cb, t, KH, HSZ), rnd(cb, t, KH, HSZ)
    coffs = torch.arange(0, t, ct, dtype=torch.int32, device=dev)
    clens = coffs + ct
    qpos = coffs[:, None, None] + torch.arange(ct, device=dev)[None, :, None]
    kpos = torch.arange(t, device=dev)[None, None, :]
    cmask = ((kpos <= qpos) & (kpos < clens[:, None, None]))[:, None]
    ckw = dict(causal=True, q_offset=coffs, seq_lens=clens)
    chunk = {
        **timed(lambda: flash_prefill(qc, kc, vc, **ckw)),
        "plain_ms": time_ms(lambda: flash_prefill_ref(qc, kc, vc, **ckw),
                            iters=10),
        "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
            qc.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
            attn_mask=cmask, enable_gqa=True)),
        "library": "sdpa with a boolean mask"}
    # rows attend to positions 0..p; K/V rows read: the first o + 256
    pairs = sum(sum(range(o + 1, o + ct + 1)) for o in range(0, t, ct))
    kv_rows = sum(o + ct for o in range(0, t, ct))
    cbytes = (2 * cb * ct * QH * HSZ + 2 * kv_rows * KH * HSZ) * es + 8 * cb
    chunk.update(_bound(cbytes, 4 * QH * HSZ * pairs, PEAK[dt]))
    out = {"flash_decode": dec, "flash_decode_kv8": dec8,
           "flash_decode_paged": decp, "flash_decode_paged_kv8": decp8,
           "flash_prefill": pre, "flash_prefill_paged": prep,
           "flash_prefill_chunks": chunk, "w8a16_matmul": mm}
    out.update(times_grouped(dev))
    for name, shape in (("flash_decode", "B=8 S=4096 bf16, fused append"),
                        ("flash_decode_kv8", "B=8 S=4096 int8 K/V, bf16 q, "
                                             "fused quantized append"),
                        ("flash_decode_paged", f"B=8 S=4096 bf16, fused "
                                               f"append, {n_pool}-page pool, "
                                               "shuffled table"),
                        ("flash_decode_paged_kv8", "the same, int8 K/V"),
                        ("flash_prefill", "B=1 T=1024 causal bf16"),
                        ("flash_prefill_paged", f"B=1 T=1024 causal bf16, "
                                                f"{pn}-page pool of 16, "
                                                "shuffled table"),
                        ("flash_prefill_chunks", "B=4 T=256 at q_offset "
                                                 "0/256/512/768, S=1024, "
                                                 "causal bf16"),
                        ("w8a16_matmul", f"M={m} K={kd} N={n} bf16 x, "
                                         f"{mm['ctas']} CTAs")):
        r = out[name]
        lib_ms = "none" if r["library_ms"] is None else \
            f"{r['library_ms']:.4f} ms"
        dev_ms = ("" if "device_ms" not in r else
                  f", kernel records {fmt_ms(r['device_ms'])}")
        print(f"  {name} {shape}: kernel {r['ms']:.4f} ms (host-bound "
              f"{r['host_ms']:.4f} ms{dev_ms}), plain "
              f"{r['plain_ms']:.4f} ms, library {lib_ms} ({r['library']}), "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    out["flash_decode_serve"] = serve
    return out


def times_serve_decode(dev):
    """flash_decode at the serve shape: B = 4 rows of 1000, 900, 800 and
    700 tokens in a 1088-slot cache, bf16, fused append, kvp 1 (one layer of
    a decode step of phase 4's profile), beside SDPA over the same rows
    with a mask of their lengths."""
    g = torch.Generator(device=dev).manual_seed(19)
    rnd = lambda *sh: torch.randn(*sh, generator=g,
                                  device=dev).to(torch.bfloat16)
    b, s = 4, 1088
    q, k, v, kn = rnd(b, QH, HSZ), rnd(b, KH, s, HSZ), rnd(b, KH, s, HSZ), \
        rnd(b, KH, HSZ)
    tl = torch.tensor([1000, 900, 800, 700], dtype=torch.int32, device=dev)
    kw = dict(kvp=1, n_ranks=1, rank=0, rr_block=RR, window=0,
              contiguous=False, slot_offset=0, k_new=kn, v_new=kn)
    fn = lambda: flash_decode_shards(q, k, v, tl, **kw)
    mask = (torch.arange(s, device=dev)[None] < tl[:, None])[:, None, None]
    r = {**timed(fn), "device_ms": device_ms(fn, DECODE_KERNELS),
         "plain_ms": time_ms(lambda: flash_decode_shards_plain(
             q, k, v, tl, scale=HSZ ** -0.5, block_s=512, **kw), iters=3,
             warmup=1),
         "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
             q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)),
         "library": "sdpa with a mask of the lengths"}
    slots = int(tl.sum())
    r.update(_bound(2 * KH * slots * HSZ * 2 + 2 * b * QH * HSZ * 2
                    + b * QH * 4, 4 * QH * HSZ * slots, PEAK[torch.bfloat16]))
    cpc = last_launch["chunks_per_cta"]
    work = decode_work_items(tl.cpu(), kvp=1, n_ranks=1, rank=0, kv_heads=KH,
                             rr_block=RR, s_true=s, chunks_per_cta=cpc)
    print(f"  flash_decode serve shape (B=4, lengths 700-1000, cap 1088): "
          f"kernel {r['ms']:.4f} ms (device {fmt_ms(r['device_ms'])}), "
          f"plain {r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.4f} ms; {work} of "
          f"{-(-decode_chunks(s, 512) // cpc) * b * KH} CTAs sweep, {cpc} "
          "chunk(s) each")
    return r


def times_grouped(dev):
    """prefix_pass and the grouped-suffix mode at 2 groups of 4 members
    sharing 4096 positions, 256 of their own each (the new token included),
    kvp 1, fused append, bf16 and int8 K/V, with the ungrouped paged launch
    on the same requests beside them.  Six copies of each pool rotate so
    that every launch reads cold, as the 40 layers of a step find them."""
    g = torch.Generator(device=dev).manual_seed(13)
    b, shared, own = 8, 4096, 256
    sp, op = shared // RR, own // RR
    tab = torch.zeros(b, sp + op, dtype=torch.int32)
    for i in range(b):
        tab[i, :sp] = torch.arange(sp) + 1 + (i // 4) * sp
        tab[i, sp:] = torch.arange(op) + 1 + 2 * sp + i * op
    tab = tab.to(dev)
    n_pool = 1 + 2 * sp + b * op
    as_dev = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    groups = (as_dev([0] * 4 + [4] * 4), as_dev([sp] * b))
    tl = torch.full((b,), shared + own, dtype=torch.int32, device=dev)
    q = torch.randn(b, QH, HSZ, generator=g, device=dev).to(torch.bfloat16)
    kn = torch.randn(b, KH, HSZ, generator=g, device=dev).to(torch.bfloat16)
    es = 2
    qbytes = b * QH * HSZ * es
    state_bytes = b * QH * (HSZ + 2) * 4
    res = {}
    for mode in ("bf16", "int8"):
        pools = []
        for _ in range(6):
            c = {k: torch.randn(n_pool, KH, RR, HSZ, generator=g,
                                device=dev).to(torch.bfloat16)
                 for k in ("kcache", "vcache")}
            if mode == "int8":
                c = quantize_decode_state(c)
            pools.append(c)
        kv_es = 1 if mode == "int8" else es
        slot_bytes = KH * HSZ * 2 * kv_es + (KH * 2 * 4 if mode == "int8"
                                              else 0)

        def sc(c):
            return ({"kscale": c["kscale"], "vscale": c["vscale"]}
                    if mode == "int8" else {})

        def pre(c, fn=prefix_pass, **kw):
            return fn(q, c["kcache"], c["vcache"], tl, tab, *groups, kvp=1,
                      n_ranks=1, rank=0, rr_block=RR, window=0, **sc(c), **kw)

        st = pre(pools[0], chunks=True)
        kw = dict(kvp=1, n_ranks=1, rank=0, rr_block=RR, window=0,
                  contiguous=False, slot_offset=0, k_new=kn, v_new=kn,
                  block_tables=tab)

        def dec(c, fn=flash_decode_shards, grouped=True, **extra):
            gk = dict(groups=groups, prefix_state=st) if grouped else {}
            return fn(q, c["kcache"], c["vcache"], tl, **sc(c), **kw, **gk,
                      **extra)

        plain = dict(scale=HSZ ** -0.5, block_s=512)
        pr = {**timed(rotating([lambda c=c: pre(c, chunks=True)
                                      for c in pools])),
              "plain_ms": time_ms(lambda: pre(pools[0], fn=prefix_pass_plain,
                                              scale=HSZ ** -0.5),
                                  iters=3, warmup=1),
              "library_ms": None,
              "library": "no single PyTorch call attends through a block "
                         "table"}
        pr.update(_bound(2 * shared * slot_bytes + qbytes + state_bytes,
                         4 * HSZ * QH * shared * b, PEAK[torch.bfloat16]))
        sx = {**timed(rotating([lambda c=c: dec(c) for c in pools])),
              "plain_ms": time_ms(lambda: dec(
                  pools[0], fn=flash_decode_shards_plain, **plain),
                  iters=3, warmup=1),
              "library_ms": None, "library": pr["library"]}
        sx.update(_bound(b * own * slot_bytes + state_bytes + 2 * qbytes
                         + b * QH * 4 + b * KH * HSZ * 2 * kv_es,
                         4 * HSZ * QH * own * b, PEAK[torch.bfloat16]))
        pr["device_ms"] = device_ms(rotating([lambda c=c: pre(c, chunks=True)
                                              for c in pools]),
                                    "prefix_kernel")

        sx["device_ms"] = device_ms(rotating([lambda c=c: dec(c)
                                              for c in pools]),
                                    DECODE_KERNELS)
        if mode == "bf16":
            gw = prefix_work_items(*groups, n_ranks=1, kv_heads=KH,
                                   page_rows=RR)
            sw = decode_work_items(
                tl.cpu(), kvp=1, n_ranks=1, rank=0, kv_heads=KH,
                rr_block=RR, s_true=(sp + op) * RR, group_np=groups[1].cpu(),
                page_rows=RR, chunks_per_cta=last_launch["chunks_per_cta"])
            print(f"  grouped decode: prefix_pass {gw} CTAs sweep a chunk, "
                  f"the grouped suffix {sw}")
        flat = queued_ms(rotating([lambda c=c: dec(c, grouped=False)
                                 for c in pools]))
        flat_dev = device_ms(rotating([lambda c=c: dec(c, grouped=False)
                                       for c in pools]), DECODE_KERNELS)
        flat_bound = _bound(b * (shared + own) * slot_bytes + 2 * qbytes
                            + b * QH * 4 + b * KH * HSZ * 2 * kv_es,
                            4 * HSZ * QH * (shared + own) * b,
                            PEAK[torch.bfloat16])["bound_ms"]
        print(f"  grouped decode {mode} (2 groups x 4 members share 4096 "
              f"positions, 256 own each): prefix_pass {pr['ms']:.4f} ms "
              f"(device {fmt_ms(pr['device_ms'])}, bound "
              f"{pr['bound_ms']:.4f}), grouped suffix {sx['ms']:.4f} ms "
              f"(device {fmt_ms(sx['device_ms'])}, bound "
              f"{sx['bound_ms']:.4f}), together {pr['ms'] + sx['ms']:.4f} "
              f"ms; ungrouped paged launch {flat:.4f} ms (device "
              f"{fmt_ms(flat_dev)}, bound {flat_bound:.4f}); plain prefix "
              f"{pr['plain_ms']:.1f} ms, plain suffix {sx['plain_ms']:.1f} ms")
        res[mode] = (pr, sx)
    return {"prefix_pass": res["bf16"][0],
            "flash_decode_grouped": res["bf16"][1]}


def times_ssd(dev):
    """ssd_prefill at the serve shape: B = 1, T = 1024, nh 48, hd 64, ds
    128, lc 64, bf16 x/B/C (a bf16 model's conv output), f32 dt and a fresh
    prompt's zero state, as ``models/ssm.ssd_chunked`` passes them; with
    its working CTAs."""
    g = torch.Generator(device=dev).manual_seed(15)
    b, t, lc = 1, 1024, 64
    args, _ = ssd_inputs(g, dev, b, t, torch.bfloat16)
    h0 = torch.zeros(b, SSD_NH, SSD_HD, SSD_DS, device=dev)
    call = lambda: ssd_prefill(*args, h0=h0)
    r = {**timed(call),
         "plain_ms": time_ms(lambda: ssd_prefill_plain(*args, h0=h0),
                             iters=10),
         "library_ms": None,
         "library": "none: no single PyTorch call computes the SSD scan",
         "device_ms": device_ms(call, "ssd_chunk_kernel"),
         "ctas": b * SSD_NH * len(chunk_spans(t, lc))}
    state = SSD_NH * SSD_HD * SSD_DS * 4
    nbytes = b * (t * SSD_NH * SSD_HD * 2           # x (bf16)
                  + t * SSD_NH * 4                  # dt
                  + 2 * t * SSD_DS * 2              # B, C (one group, bf16)
                  + 2 * SSD_NH * 4                  # a, d
                  + state                           # h0
                  + t * SSD_NH * SSD_HD * 4         # y (f32)
                  + state)                          # h_final
    # per (head, chunk): C B^T, the intra product, C h_in^T, the state update
    ops = b * SSD_NH * (t // lc) * 2 * (lc * lc * SSD_DS + lc * lc * SSD_HD
                                        + 2 * lc * SSD_DS * SSD_HD)
    r.update(_bound(nbytes, ops, PEAK[torch.bfloat16]))
    print(f"  ssd_prefill B=1 T=1024 nh 48 hd 64 ds 128 lc 64, bf16 x/B/C, "
          f"{r['ctas']} CTAs (one per chunk and head): kernel {r['ms']:.4f} "
          f"ms (host-bound {r['host_ms']:.4f} ms, kernel records "
          f"{fmt_ms(r['device_ms'])}), plain {r['plain_ms']:.4f} ms, library "
          f"none, bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return r


def time_prefill_at(g, dev, qh, kh, t=1024, hsz=HSZ, window=0):
    """flash_prefill's record at B = 1, T = ``t`` causal (``window`` > 0: a
    sliding window), bf16, ``qh / kh`` heads of ``hsz``: kernel, plain,
    SDPA (``enable_gqa``; ``is_causal``, or a boolean mask of the window)
    and the bound (the pairs the mask keeps)."""
    dt, es = torch.bfloat16, 2
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
    qp, kp, vp = rnd(1, t, qh, hsz), rnd(1, t, kh, hsz), rnd(1, t, kh, hsz)
    sd = dict(is_causal=True)
    pairs = t * (t + 1) // 2
    if window:
        i = torch.arange(t, device=dev)
        sd = dict(attn_mask=(i[None] <= i[:, None])
                  & (i[None] > i[:, None] - window))
        pairs = sum(min(j + 1, window) for j in range(t))
    pre = {**timed(lambda: flash_prefill(qp, kp, vp, causal=True,
                                         window=window)),
           "plain_ms": time_ms(lambda: flash_prefill_ref(qp, kp, vp,
                                                         causal=True,
                                                         window=window),
                               iters=10),
           "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
               qp.transpose(1, 2), kp.transpose(1, 2), vp.transpose(1, 2),
               enable_gqa=True, **sd)),
           "library": "sdpa, enable_gqa" + (", a boolean mask of the window"
                                            if window else "")}
    pre.update(_bound((2 * t * qh * hsz + 2 * t * kh * hsz) * es,
                      4 * qh * hsz * pairs, PEAK[dt]))
    return pre


def decode_serve_inputs(g, dev, qh, kh, hsz=HSZ, tl=(1000, 900, 800, 700),
                        cap=1088, window=0):
    """flash_decode's inputs at the serve shape (B = 4, lengths ``tl`` with
    the new token, 700-1000 by default, capacity ``cap``, ``qh / kh`` heads
    of ``hsz``, ``window``, fused append, kvp 1), bf16, with the work they
    need (``slots`` in the windows, ``dops``, ``io``)."""
    dt, es = torch.bfloat16, 2
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
    b = len(tl)
    slots = sum(min(x, window) if window else x for x in tl)
    tl = torch.tensor(tl, dtype=torch.int32, device=dev)
    q, kn = rnd(b, qh, hsz), rnd(b, kh, hsz)
    k, v = rnd(b, kh, cap, hsz), rnd(b, kh, cap, hsz)
    return dict(q=q, k=k, v=v, tl=tl, cap=cap, qh=qh, kh=kh, hsz=hsz,
                slots=slots, window=window,
                kw=dict(kvp=1, n_ranks=1, rank=0, rr_block=RR, window=window,
                        contiguous=False, slot_offset=0, k_new=kn, v_new=kn),
                plain=dict(scale=hsz ** -0.5,
                           block_s=kernel_block_s(512, cap)),
                dops=4 * qh * hsz * slots,
                io=(2 * b * qh * hsz * es + b * qh * 4
                    + 2 * b * kh * hsz * es))


def time_decode_at(d):
    """flash_decode's record over ``decode_serve_inputs``' fixed bf16
    cache: kernel, plain, SDPA (a mask of the lengths and the window,
    ``enable_gqa``) and the bound."""
    q, k, v, tl, kw = d["q"], d["k"], d["v"], d["tl"], d["kw"]
    pos = torch.arange(d["cap"], device=tl.device)[None]
    mask = pos < tl[:, None]
    if d["window"]:
        mask &= pos >= tl[:, None] - d["window"]
    mask = mask[:, None, None]
    fn = lambda: flash_decode_shards(q, k, v, tl, **kw)
    dec = {**timed(fn), "device_ms": device_ms(fn, DECODE_KERNELS),
           "plain_ms": time_ms(lambda: flash_decode_shards_plain(
               q, k, v, tl, **d["plain"], **kw), iters=3, warmup=1),
           "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
               q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)),
           "library": "sdpa with a mask of the lengths"
                      + (" and the window" if d["window"] else "")
                      + ", enable_gqa"}
    dec.update(_bound(2 * d["kh"] * d["slots"] * d["hsz"] * 2 + d["io"],
                      d["dops"], PEAK[torch.bfloat16]))
    return dec


def time_decode_modes(g, dev, d):
    """flash_decode's int8 and paged records over ``decode_serve_inputs``'
    cache: int8 K/V (three copies in turn), and bf16 K/V in a pool under a
    shuffled table; neither has a one-call PyTorch yardstick."""
    q, k, v, tl, kw, plain = (d[key] for key in ("q", "k", "v", "tl", "kw",
                                                 "plain"))
    slots, dops, io, cap, kh, hsz = (d[key] for key in (
        "slots", "dops", "io", "cap", "kh", "hsz"))
    dt, es = torch.bfloat16, 2
    copies = [quantize_kv_token(k) + quantize_kv_token(v) for _ in range(3)]
    fns8 = [lambda c=c: flash_decode_shards(q, c[0], c[2], tl, kscale=c[1],
                                            vscale=c[3], **kw)
            for c in copies]
    c0 = copies[0]
    dec8 = {**timed(rotating(fns8)),
            "device_ms": device_ms(rotating(fns8), DECODE_KERNELS),
            "plain_ms": time_ms(lambda: flash_decode_shards_plain(
                q, c0[0], c0[2], tl, kscale=c0[1], vscale=c0[3], **plain,
                **kw), iters=3, warmup=1),
            "library_ms": None,
            "library": "no single PyTorch call attends over an int8 cache"}
    dec8.update(_bound(2 * kh * slots * (hsz + 4) + io, dops, PEAK[dt]))
    tab, n_pool = shuffled_tables(torch.Generator().manual_seed(29), tl, RR,
                                  cap // RR)
    tab = tab.to(dev)
    pool = state_to_paged({"kcache": k[None], "vcache": v[None]}, tab, n_pool,
                          1, RR)
    pk, pv = pool["kcache"][0], pool["vcache"][0]
    fnp = lambda: flash_decode_shards(q, pk, pv, tl, block_tables=tab, **kw)
    decp = {**timed(fnp), "device_ms": device_ms(fnp, DECODE_KERNELS),
            "plain_ms": time_ms(lambda: flash_decode_shards_plain(
                q, pk, pv, tl, block_tables=tab, **plain, **kw), iters=3,
                warmup=1),
            "library_ms": None,
            "library": "no single PyTorch call attends through a block "
                       "table"}
    decp.update(_bound(2 * kh * slots * hsz * es + io + tab.numel() * 4,
                       dops, PEAK[dt]))
    return dec8, decp, n_pool


def time_w8a16_at(g, dev, d, vp, m=4):
    """w8a16_matmul's record at a model's int8 head [d, vp], M = ``m``
    bf16 rows: kernel, plain, the library call and the bound."""
    x = torch.randn(m, d, generator=g, device=dev).to(torch.bfloat16)
    qw, sc = quantize_w8(torch.randn(d, vp, generator=g, device=dev))
    lib, lib_fn = w8a16_library(x, qw, sc)
    mm = {**timed(lambda: w8a16_matmul(x, qw, sc)),
          "plain_ms": time_ms(lambda: w8a16_matmul_ref(x, qw, sc), iters=10),
          "library_ms": queued_ms(lib_fn), "library": lib,
          "ctas": w8a16_blocks(m, vp),
          "device_ms": device_ms(lambda: w8a16_matmul(x, qw, sc),
                                 "w8a16_kernel")}
    mm.update(_bound(d * vp + vp * 4 + m * d * 2 + m * vp * 2,
                     2 * m * d * vp, PEAK[torch.bfloat16]))
    return mm


def print_times(out, shapes):
    """One line per record of ``out``, each with its shape."""
    for name, shape in shapes:
        r = out[name]
        lib_ms = ("none" if r["library_ms"] is None
                  else f"{r['library_ms']:.4f} ms")
        print(f"  {name} {shape}: kernel {r['ms']:.4f} ms (host-bound "
              f"{r['host_ms']:.4f} ms, kernel records "
              f"{fmt_ms(r.get('device_ms'))}), plain {r['plain_ms']:.4f} ms,"
              f" library {lib_ms} ({r['library']}), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")


def times_hymba(dev):
    """The kernels at hymba-1.5b's shapes, bf16, timed as the table's rows
    are: flash_prefill at B = 1, T = 1024 causal, 25/5 heads (G = 5);
    flash_decode at the serve shape (B = 4, lengths 700-1000 with the new
    token, cap 1088, 25/5 heads, fused append, kvp 1), fixed fp, int8 (three
    cache copies in turn) and paged (a shuffled table); ssd_prefill at B =
    1, T = 1024, nh 50, hd 64, ds 16, a zero state; w8a16_matmul at the
    untied head, M = 4, K = 1600, N = 32256.  Each beside its bound, its
    plain version and its one-call PyTorch yardstick where there is one."""
    g = torch.Generator(device=dev).manual_seed(28)
    dt = torch.bfloat16
    es = 2
    out = {"flash_prefill_hymba": time_prefill_at(g, dev, HY_QH, HY_KH)}
    t = 1024
    d = decode_serve_inputs(g, dev, HY_QH, HY_KH)
    out["flash_decode_hymba"] = time_decode_at(d)
    dec8, decp, n_pool = time_decode_modes(g, dev, d)
    out["flash_decode_hymba_kv8"] = dec8
    out["flash_decode_hymba_paged"] = decp
    # the SSD scan
    args, _ = ssd_inputs(g, dev, 1, t, dt, nh=HY_NH, ds=HY_DS)
    h0 = torch.zeros(1, HY_NH, SSD_HD, HY_DS, device=dev)
    call = lambda: ssd_prefill(*args, h0=h0)
    ssd = {**timed(call),
           "plain_ms": time_ms(lambda: ssd_prefill_plain(*args, h0=h0),
                               iters=10),
           "library_ms": None,
           "library": "none: no single PyTorch call computes the SSD scan",
           "device_ms": device_ms(call, "ssd_chunk_kernel"),
           "ctas": HY_NH * len(chunk_spans(t, 64))}
    state = HY_NH * SSD_HD * HY_DS * 4
    sbytes = (t * HY_NH * SSD_HD * es + t * HY_NH * 4 + 2 * t * HY_DS * es
              + 2 * HY_NH * 4 + state + t * HY_NH * SSD_HD * 4 + state)
    sops = HY_NH * (t // 64) * 2 * (64 * 64 * HY_DS + 64 * 64 * SSD_HD
                                    + 2 * 64 * HY_DS * SSD_HD)
    ssd.update(_bound(sbytes, sops, PEAK[dt]))
    out["ssd_prefill_hymba"] = ssd
    out["w8a16_matmul_hymba"] = mm = time_w8a16_at(g, dev, HY_D, HY_VP)
    print_times(out, (
        ("flash_prefill_hymba", f"B=1 T=1024 causal bf16, {HY_QH}/{HY_KH}"
                                " heads"),
        ("flash_decode_hymba", "B=4 lengths 700-1000 cap 1088 bf16, "
                               f"{HY_QH}/{HY_KH} heads, fused append"),
        ("flash_decode_hymba_kv8", "the same, int8 K/V"),
        ("flash_decode_hymba_paged", f"the same, bf16 K/V in a {n_pool}-"
                                     "page pool, shuffled table"),
        ("ssd_prefill_hymba", f"B=1 T=1024 nh {HY_NH} hd {SSD_HD} ds "
                              f"{HY_DS}, {ssd['ctas']} CTAs"),
        ("w8a16_matmul_hymba", f"M=4 K={HY_D} N={HY_VP} bf16 x, "
                               f"{mm['ctas']} CTAs")))
    return out


def times_moe(dev):
    """The kernels at granite-moe-1b-a400m's serve shapes, bf16, timed as
    the table's rows are: flash_prefill at B = 1, T = 1024 causal, 16/8
    heads (G = 2); flash_decode at the serve shape (B = 4, lengths
    700-1000, cap 1088, 16/8 heads, fused append, kvp 1); w8a16_matmul at
    the tied int8 head, M = 4, K = 1024, N = 49664."""
    g = torch.Generator(device=dev).manual_seed(35)
    out = {"flash_prefill_moe": time_prefill_at(g, dev, MOE_QH, MOE_KH),
           "flash_decode_moe": time_decode_at(decode_serve_inputs(
               g, dev, MOE_QH, MOE_KH)),
           "w8a16_matmul_moe": time_w8a16_at(g, dev, MOE_D, MOE_VP)}
    print_times(out, (
        ("flash_prefill_moe", f"B=1 T=1024 causal bf16, {MOE_QH}/{MOE_KH} "
                              "heads"),
        ("flash_decode_moe", "B=4 lengths 700-1000 cap 1088 bf16, "
                             f"{MOE_QH}/{MOE_KH} heads, fused append"),
        ("w8a16_matmul_moe", f"M=4 K={MOE_D} N={MOE_VP} bf16 x, "
                             f"{out['w8a16_matmul_moe']['ctas']} CTAs")))
    return out


def time_prefix_at(g, dev, qh, kh, hsz, tl_l, shared):
    """prefix_pass's record over one group of the rows of ``tl_l`` sharing
    their first ``shared`` pages of 16, ``qh / kh`` heads of ``hsz``, bf16,
    kvp 1, window 0 (a global layer reads the whole prefix); six pool
    copies rotate so that every launch reads cold."""
    b = len(tl_l)
    need_pg = [-(-x // RR) for x in tl_l]
    tab = torch.zeros(b, max(need_pg), dtype=torch.int32)
    nxt = shared + 1
    for i, n in enumerate(need_pg):
        tab[i, :shared] = torch.arange(1, shared + 1)
        tab[i, shared:n] = torch.arange(nxt, nxt + n - shared)
        nxt += n - shared
    tab = tab.to(dev)
    tl = torch.tensor(tl_l, dtype=torch.int32, device=dev)
    groups = (torch.zeros(b, dtype=torch.int32, device=dev),
              torch.full((b,), shared, dtype=torch.int32, device=dev))
    q = torch.randn(b, qh, hsz, generator=g, device=dev).to(torch.bfloat16)
    pools = [{k: torch.randn(nxt, kh, RR, hsz, generator=g,
                             device=dev).to(torch.bfloat16)
              for k in ("kcache", "vcache")} for _ in range(6)]

    def pre(c, fn=prefix_pass, **kw):
        return fn(q, c["kcache"], c["vcache"], tl, tab, *groups, kvp=1,
                  n_ranks=1, rank=0, rr_block=RR, window=0, **kw)

    fns = [lambda c=c: pre(c, chunks=True) for c in pools]
    pr = {**timed(rotating(fns)),
          "device_ms": device_ms(rotating(fns), "prefix_kernel"),
          "plain_ms": time_ms(lambda: pre(pools[0], fn=prefix_pass_plain,
                                          scale=hsz ** -0.5),
                              iters=3, warmup=1),
          "library_ms": None,
          "library": "no single PyTorch call attends through a block table"}
    # the shared K/V once, the members' q, and the partials of the chunks
    # below the split
    pos = shared * RR
    pr.update(_bound(2 * pos * kh * hsz * 2 + b * qh * hsz * 2
                     + b * qh * (hsz + 2) * 4 * -(-pos // CHUNK_S),
                     4 * hsz * qh * pos * b, PEAK[torch.bfloat16]))
    return pr


def times_gemma3(dev):
    """The kernels at gemma3-12b's serve shapes, bf16, timed as the table's
    rows are: flash_prefill at B = 1, T = 2048 causal, 16/8 heads of 256
    (and the same with the 1024-token window, under ``window_1024``);
    flash_decode at B = 4, lengths 2100/1500/1100/700 with the new token,
    cap 2112, the local layers' window of 1024, fused append, kvp 1, fixed
    fp, int8 and paged; prefix_pass over 4 members sharing 512 positions;
    w8a16_matmul at the tied head, M = 4, K = 3840, N = 262144."""
    g = torch.Generator(device=dev).manual_seed(44)
    pre = time_prefill_at(g, dev, GE_QH, GE_KH, t=2048, hsz=GE_HSZ)
    pre["window_1024"] = time_prefill_at(g, dev, GE_QH, GE_KH, t=2048,
                                         hsz=GE_HSZ, window=GE_WIN)
    out = {"flash_prefill_gemma3": pre}
    d = decode_serve_inputs(g, dev, GE_QH, GE_KH, hsz=GE_HSZ, tl=GE_TL,
                            cap=GE_CAP, window=GE_WIN)
    out["flash_decode_gemma3"] = time_decode_at(d)
    out["flash_decode_gemma3_kv8"], out["flash_decode_gemma3_paged"], \
        n_pool = time_decode_modes(g, dev, d)
    out["prefix_pass_gemma3"] = time_prefix_at(g, dev, GE_QH, GE_KH, GE_HSZ,
                                               GE_TL, 32)
    out["w8a16_matmul_gemma3"] = mm = time_w8a16_at(g, dev, GE_D, GE_VP)
    shape = (f"B=4 lengths {list(GE_TL)} cap {GE_CAP} window {GE_WIN} bf16, "
             f"{GE_QH}/{GE_KH} heads of {GE_HSZ}, fused append")
    print_times(dict(out, flash_prefill_gemma3_w1024=pre["window_1024"]), (
        ("flash_prefill_gemma3", f"B=1 T=2048 causal bf16, {GE_QH}/{GE_KH}"
                                 f" heads of {GE_HSZ}"),
        ("flash_prefill_gemma3_w1024", f"the same, window {GE_WIN}"),
        ("flash_decode_gemma3", shape),
        ("flash_decode_gemma3_kv8", "the same, int8 K/V"),
        ("flash_decode_gemma3_paged", f"the same, bf16 K/V in a {n_pool}-"
                                      "page pool, shuffled table"),
        ("prefix_pass_gemma3", f"4 members sharing 512 positions, "
                               f"{GE_QH}/{GE_KH} heads of {GE_HSZ}, bf16"),
        ("w8a16_matmul_gemma3", f"M=4 K={GE_D} N={GE_VP} bf16 x, "
                                f"{mm['ctas']} CTAs")))
    return out


def times_dense(dev):
    """The kernels at the dense GQA models' shapes past G = 8, heads of 128,
    bf16, timed as the table's rows are: for starcoder2-15b (48/4 heads, G
    = 12; records ``*_sc2``) and llama-405b (128/8, G = 16; ``*_llama``),
    flash_prefill at B = 1, T = 1024 causal; flash_decode at the serve
    shape (B = 4, lengths 700-1000 with the new token, cap 1088, fused
    append, kvp 1), fixed fp, int8 and paged; w8a16_matmul at the untied
    head, M = 4 (K = 6144, N = 49152; K = 16384, N = 128512).  Also
    llama's flash_decode at B = 8, S = 4096 (``b8_s4096``, the shape of
    granite's B1 row at G = 4) and prefix_pass over 4 members sharing 4096
    positions at lengths 4400-4700 (8 rows a warp, one row block; the
    serve-like 512 shared at lengths 700-1000, 1 row a warp, under
    ``serve_shape``)."""
    g = torch.Generator(device=dev).manual_seed(59)
    out, shapes = {}, []
    serve = "B=4 lengths 700-1000 cap 1088 bf16"
    for tag, qh, kh, d, vp in (("sc2", SC2_QH, SC2_KH, SC2_D, SC2_VP),
                               ("llama", LL_QH, LL_KH, LL_D, LL_VP)):
        heads = f"{qh}/{kh} heads of {DENSE_HSZ}"
        out[f"flash_prefill_{tag}"] = time_prefill_at(g, dev, qh, kh,
                                                      hsz=DENSE_HSZ)
        dd = decode_serve_inputs(g, dev, qh, kh, hsz=DENSE_HSZ)
        out[f"flash_decode_{tag}"] = time_decode_at(dd)
        (out[f"flash_decode_{tag}_kv8"], out[f"flash_decode_{tag}_paged"],
         n_pool) = time_decode_modes(g, dev, dd)
        out[f"w8a16_matmul_{tag}"] = mm = time_w8a16_at(g, dev, d, vp)
        shapes += [(f"flash_prefill_{tag}",
                    f"B=1 T=1024 causal bf16, {heads}"),
                   (f"flash_decode_{tag}", f"{serve}, {heads}, fused append"),
                   (f"flash_decode_{tag}_kv8", "the same, int8 K/V"),
                   (f"flash_decode_{tag}_paged", f"the same, bf16 K/V in a "
                                                 f"{n_pool}-page pool"),
                   (f"w8a16_matmul_{tag}", f"M=4 K={d} N={vp} bf16 x, "
                                           f"{mm['ctas']} CTAs")]
        del dd
    big = time_decode_at(decode_serve_inputs(
        g, dev, LL_QH, LL_KH, hsz=DENSE_HSZ, tl=(4096,) * 8, cap=4096))
    out["flash_decode_llama"]["b8_s4096"] = big
    out["prefix_pass_llama"] = time_prefix_at(
        g, dev, LL_QH, LL_KH, DENSE_HSZ, (4700, 4600, 4500, 4400), 256)
    out["prefix_pass_llama"]["serve_shape"] = time_prefix_at(
        g, dev, LL_QH, LL_KH, DENSE_HSZ, (1000, 900, 800, 700), 32)
    shapes += [("flash_decode_llama_b8", "B=8 S=4096 bf16, 128/8 heads of "
                                         "128, fused append"),
               ("prefix_pass_llama", "4 members sharing 4096 positions, "
                                     "lengths 4400-4700, 128/8 heads"),
               ("prefix_pass_llama_serve", "4 members sharing 512 "
                                           "positions, lengths 700-1000")]
    print_times(dict(out, flash_decode_llama_b8=big,
                     prefix_pass_llama_serve=out["prefix_pass_llama"][
                         "serve_shape"]), shapes)
    return out


def times_arctic(dev):
    """The kernels at arctic-480b's shapes, 56/8 heads of 128 (G = 7),
    bf16, timed as the table's rows are (records ``*_arctic``):
    flash_prefill at B = 1, T = 1024 causal; flash_decode at the serve
    shape (B = 4, lengths 700-1000 with the new token, cap 1088, fused
    append, kvp 1), fixed fp, int8 and paged, and fp at B = 8, S = 4096
    (``b8_s4096``); w8a16_matmul at the untied head, M = 4, K = 7168, N =
    32256."""
    g = torch.Generator(device=dev).manual_seed(77)
    heads = f"{AR_QH}/{AR_KH} heads of {DENSE_HSZ}"
    out = {"flash_prefill_arctic": time_prefill_at(g, dev, AR_QH, AR_KH,
                                                   hsz=DENSE_HSZ)}
    dd = decode_serve_inputs(g, dev, AR_QH, AR_KH, hsz=DENSE_HSZ)
    out["flash_decode_arctic"] = time_decode_at(dd)
    (out["flash_decode_arctic_kv8"], out["flash_decode_arctic_paged"],
     n_pool) = time_decode_modes(g, dev, dd)
    del dd
    big = time_decode_at(decode_serve_inputs(
        g, dev, AR_QH, AR_KH, hsz=DENSE_HSZ, tl=(4096,) * 8, cap=4096))
    out["flash_decode_arctic"]["b8_s4096"] = big
    out["w8a16_matmul_arctic"] = mm = time_w8a16_at(g, dev, AR_D, AR_VP)
    print_times(dict(out, flash_decode_arctic_b8=big), (
        ("flash_prefill_arctic", f"B=1 T=1024 causal bf16, {heads}"),
        ("flash_decode_arctic", "B=4 lengths 700-1000 cap 1088 bf16, "
                                f"{heads}, fused append"),
        ("flash_decode_arctic_kv8", "the same, int8 K/V"),
        ("flash_decode_arctic_paged", f"the same, bf16 K/V in a {n_pool}-"
                                      "page pool"),
        ("flash_decode_arctic_b8", f"B=8 S=4096 bf16, {heads}, fused "
                                   "append"),
        ("w8a16_matmul_arctic", f"M=4 K={AR_D} N={AR_VP} bf16 x, "
                                f"{mm['ctas']} CTAs")))
    return out


# ------------------------------------------ whisper-base, phi-3-vision
def check_encdec_modes(dev, errs):
    """B2's non-causal and cross modes and B1's contiguous layout at
    whisper-base's shapes (8 MHA heads of 64), f32 and bf16, against the
    plain versions: the encoder's self-attention (B = 4, T = S = 1500, not a
    multiple of the 64-row blocks), the decoder's cross-attention (T = 64
    over S = 1500; and with per-row kv lengths), and the decode step's
    cross-attention over the static K/V in kvp contiguous shards (B = 4,
    1500 valid slots, kvp 1 and 4), pruned == dense bit for bit."""
    g = torch.Generator(device=dev).manual_seed(60)
    b, s, h, hsz = 4, WH_S_ENC, WH_H, WH_HSZ
    lens = torch.tensor([s, s - s // 15, s - s // 6, s - s // 4],
                        dtype=torch.int32, device=dev)
    for dt in (torch.float32, torch.bfloat16):
        rnd = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(dt)
        k, v = rnd(b, s, h, hsz), rnd(b, s, h, hsz)
        for name, t, seq_lens in (("flash_prefill_noncausal", s, None),
                                  ("flash_prefill_cross", WH_T, None),
                                  ("flash_prefill_cross", WH_T, lens)):
            q = rnd(b, t, h, hsz)
            got = flash_prefill(q, k, v, causal=False, seq_lens=seq_lens)
            want = flash_prefill_ref(q, k, v, causal=False,
                                     seq_lens=seq_lens)
            torch.cuda.synchronize()
            e = maxerr(got, want)
            errs[name].append(e)
            tag = (f"prefill non-causal {str(dt)[6:]} B={b} T={t} S={s}"
                   + (" with kv lengths" if seq_lens is not None else ""))
            print(f"  {tag}: max err {e:.3g} (tol {TOL[dt]['out']:g})")
            need(e <= TOL[dt]["out"], f"{tag}: kernel disagrees with plain")
        q = rnd(b, h, hsz)
        kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        tl = torch.tensor(s, dtype=torch.int32, device=dev)
        for kvp in (1, 4):
            kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR, window=0,
                      contiguous=True, slot_offset=0, k_new=None, v_new=None)
            o1, l1 = flash_decode_shards(q, kc, vc, tl, **kw)
            o0, l0 = flash_decode_shards(q, kc, vc, tl, prune=False, **kw)
            o2, l2 = flash_decode_shards_plain(
                q, kc, vc, tl, scale=hsz ** -0.5,
                block_s=kernel_block_s(512, s // kvp), **kw)
            torch.cuda.synchronize()
            eo, el = maxerr(o1, o2), maxerr(l1, l2)
            errs["flash_decode_contiguous"].append(eo)
            tag = f"decode contiguous {str(dt)[6:]} B={b} S={s} kvp={kvp}"
            print(f"  {tag}: max err out {eo:.3g} lse {el:.3g} (tol "
                  f"{TOL[dt]['out']:g}/{TOL[dt]['lse']:g}); pruned == dense")
            need(eo <= TOL[dt]["out"] and el <= TOL[dt]["lse"],
                 f"{tag}: kernel disagrees with plain")
            need(torch.equal(bits(o1), bits(o0)) and torch.equal(l1, l0),
                 f"{tag}: pruned != dense")


def whisper_batch(cfg, g, dev, b=4, t=WH_T):
    """Seeded decoder prompts [b, t] and frame embeddings [b, 1500, d]."""
    return {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=g,
                                    device=dev),
            "enc_frames": torch.randn(b, WH_S_ENC, cfg.d_model, generator=g,
                                      device=dev)}


def phi3_batch(cfg, g, dev, b=4, t=PH_P + PH_TEXT):
    """Seeded prompts [b, t] whose first 256 positions the patch embeddings
    [b, 256, d] replace."""
    return {"tokens": torch.randint(0, cfg.vocab, (b, t), generator=g,
                                    device=dev),
            "patch_embeds": torch.randn(b, PH_P, cfg.d_model, generator=g,
                                        device=dev)}


def cast_batch(batch, dtype):
    return {k: v if k == "tokens" else v.to(dtype) for k, v in batch.items()}


def step_counts(cfg, steps, *, int8=False, kv8=False, paged=False):
    """The launches of one prefill of a batch and ``steps`` decode steps
    through the step functions: flash_prefill once a layer (the encoder's
    and every decoder layer's cross-attention non-causal too),
    flash_decode once a layer a step (and once more for the
    cross-attention, in the contiguous layout), w8a16_matmul once a step
    with the int8 head."""
    enc, lay = cfg.enc_layers, cfg.n_layers
    cross = lay if cfg.is_encdec else 0
    return {"flash_decode": (lay + cross) * steps,
            "flash_decode_kv8": lay * steps if kv8 else 0,
            "flash_decode_paged": lay * steps if paged else 0,
            "flash_decode_grouped": 0, "prefix_pass": 0,
            "flash_decode_contiguous": cross * steps,
            "flash_prefill": enc + lay + cross, "flash_prefill_paged": 0,
            "flash_prefill_noncausal": enc + cross,
            "flash_prefill_cross": cross,
            "w8a16_matmul": steps if int8 else 0, "ssd_prefill": 0}


def step_serve(dev, cfg, model, batch, label, *, new, hx=None, window=1,
               kv8=False, paged=False):
    """One run through the step functions the reference serves these
    families with (its engine cannot): ``make_prefill_step`` over the
    batch (its K/V quantized with ``kv8``, moved into a pool under a
    shuffled table with ``paged``), then ``new - 1`` greedy decode steps,
    one ``serve_step`` each at window 1, else ``build_serve_multistep``
    windows (eager; the last window's budget the steps left).  Counts set
    to 0 just before; launches must equal ``step_counts``.  Prints TTFT
    (the prefill's host wall, synchronized), the decode's host wall per
    step, tok/s and its device time per step between CUDA events (launch
    gaps in).  Returns ``{"streams" [B, new], "counts", "figures"}``."""
    hx = hx or HelixConfig()
    b, t = batch["tokens"].shape
    cap = cache_capacity(t + new, hx.kvp, hx.rr_block)
    steps = new - 1 if window == 1 else -(-(new - 1) // window) * window
    registry.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = make_prefill_step(cfg, hx, s_cap=cap)(model, batch)
    cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t0
    if kv8:
        state = quantize_decode_state(state)
    if paged:
        page = hx.kvp * hx.rr_block
        full = torch.full((b,), cap, dtype=torch.int32)
        tab, n_pool = shuffled_tables(torch.Generator().manual_seed(61),
                                      full, page, cap // page)
        state = state_to_paged(state, tab, n_pool, hx.kvp, page)
    state["total_len"] = torch.full((b,), t, dtype=torch.int32, device=dev)
    out = [cur]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t1 = time.perf_counter()
    start.record()
    if window == 1:
        step = build_serve_step(cfg, hx)
        for _ in range(new - 1):
            cur, state = step(model, state, cur)
            out.append(cur)
    else:
        multi = build_serve_multistep(cfg, hx, window=window)
        eos = torch.full((b,), -1, dtype=torch.int32, device=dev)
        forced = torch.zeros(b, window, dtype=torch.int32, device=dev)
        n_forced = torch.zeros(b, dtype=torch.int32, device=dev)
        left = new - 1
        while left > 0:
            budgets = torch.full((b,), min(window, left), dtype=torch.int32,
                                 device=dev)
            block, cur, state = multi(model, state, cur, budgets, eos,
                                      forced, n_forced)
            out += list(block[:, :min(window, left)].unbind(1))
            left -= window
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = registry.launch_counts()
    streams = torch.stack(out, 1).cpu()
    need(streams.shape == (b, new) and int(streams.min()) >= 0
         and int(streams.max()) < cfg.vocab,
         f"{label}: streams {tuple(streams.shape)} outside [0, vocab)")
    need(int(state["total_len"].min()) == t + new - 1,
         f"{label}: total_len {state['total_len'].tolist()}")
    want = step_counts(cfg, steps, int8=hx.lm_head_w8, kv8=kv8, paged=paged)
    fig = {"ttft_ms": ttft * 1e3, "host_ms_per_step": wall / steps * 1e3,
           "tok_s": b * (new - 1) / wall,
           "events_ms_per_step": start.elapsed_time(end) / steps}
    print(f"  {label}: B={b} T={t}, {new} tokens a row ({steps} decode "
          f"steps{'' if window == 1 else f' in windows of {window}'}): "
          f"TTFT {fig['ttft_ms']:.2f} ms, decode host wall "
          f"{fig['host_ms_per_step']:.3f} ms/step, {fig['tok_s']:.1f} tok/s,"
          f" events {fig['events_ms_per_step']:.3f} ms/step")
    print(f"    launches {counts}")
    need(counts == want, f"{label}: launch counts {counts} != {want}")
    return {"streams": streams, "counts": counts, "figures": fig}


def profile_steps(dev, cfg, model, batch, hx, label, n=5):
    """Host wall and device kernel time of one decode step through
    ``build_serve_step`` after a prefill of ``batch`` and 3 warm-up steps,
    from torch.profiler over ``n`` steps (kernel and copy rows only)."""
    from torch.profiler import ProfilerActivity, profile
    b, t = batch["tokens"].shape
    logits, state = make_prefill_step(cfg, hx, s_cap=cache_capacity(
        t + n + 4, hx.kvp, hx.rr_block))(model, batch)
    state["total_len"] = torch.full((b,), t, dtype=torch.int32, device=dev)
    step = build_serve_step(cfg, hx)
    tok = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    for _ in range(3):
        tok, state = step(model, state, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tok, state = step(model, state, tok)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e3
    rows = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", 0)
    device = sum(dev_us(e) for e in rows
                 if not e.key.startswith("aten::")) / n / 1e3
    calls = sum(e.count for e in rows if DECODE_KERNELS[0] in e.key)
    b1 = (sum(dev_us(e) for e in rows if any(k in e.key
                                               for k in DECODE_KERNELS))
          / max(calls, 1) / 1e3)
    ops = sum(e.count for e in rows if e.key.startswith("aten::")) / n
    out = {"wall_ms": wall, "device_ms": device if device > 0 else None,
           "flash_decode_ms_per_call": b1 if calls else None}
    print(f"  {label} decode step profile (B={b}, T={t}): host wall "
          f"{wall:.2f} ms/step, device kernels {fmt_ms(out['device_ms'])} "
          f"per step ({ops:.0f} aten ops/step; flash_decode "
          f"{fmt_ms(out['flash_decode_ms_per_call'])} a call, "
          f"{calls / n:.0f} calls a step)")
    return out


def step_bytes(cfg, model, b, t):
    """Bytes one decode step must read: every decoder weight it multiplies
    by (not the embedding table, the encoder, or the cross-attention's wk
    and wv, which the prefill used), once; the K/V of ``b`` rows of ``t``
    positions; the cross K/V of an enc-dec arch.  bf16 throughout."""
    skip = ("embed", "enc.", "xattn.wk", "xattn.wv")
    w = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
            if not any(n.startswith(k) or k in n for k in skip))
    if cfg.tie_embeddings:
        w += model.embed.numel() * model.embed.element_size()
    kv = 2 * cfg.n_layers * b * t * cfg.kv_dim * 2
    xkv = (2 * cfg.n_layers * b * WH_S_ENC * cfg.kv_dim * 2
           if cfg.is_encdec else 0)
    return w, kv, xkv


def serve_step_runs(dev, arch, label, batch_fn, *, new, runs, same_as,
                    profile_batch=None):
    """``arch`` at full width and depth (bf16, seeded random weights):
    memory after the build and after the int8 head is quantized; the runs
    ``runs`` (label -> ``step_serve`` keywords, ``int8`` meaning the int8
    head) over the batch ``batch_fn`` makes, each run's streams equal to
    those of the run ``same_as`` names; the decode-step profile beside its
    byte bound.  Returns the runs and the profile."""
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    mem = {"model_gib": torch.cuda.max_memory_allocated() / 2**30}
    prepare_decode_params(model, KV8_W8)
    torch.cuda.synchronize()
    mem["int8_head_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label} model: {wbytes / 1e9:.3f} GB of bf16 weights; peak "
          f"memory {mem['model_gib']:.2f} GiB after the build, "
          f"{mem['int8_head_gib']:.2f} GiB with the int8 head")
    g = torch.Generator(device=dev).manual_seed(62)
    batch = cast_batch(batch_fn(cfg, g, dev), torch.bfloat16)
    out = {}
    for name, kw in runs.items():
        kw = dict(kw)
        hx = HelixConfig(lm_head_w8=kw.pop("int8", False))
        if kw.get("paged"):
            hx = dataclasses.replace(hx, paged_kv=True)
        if kw.get("kv8"):
            hx = dataclasses.replace(hx, kv_cache_bits=8)
        torch.cuda.reset_peak_memory_stats()
        out[name] = step_serve(dev, cfg, model, batch, f"{label} {name}",
                               new=new, hx=hx, **kw)
        out[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        base = same_as.get(name)
        if base in out:
            need(torch.equal(out[name]["streams"], out[base]["streams"]),
                 f"{label} {name}: streams differ from {base}'s")
            print(f"    {label} {name} streams equal to {base}'s, token for "
                  f"token ({out[name]['streams'].numel()} tokens); peak "
                  f"memory {out[name]['peak_gib']:.2f} GiB")
        else:
            print(f"    {label} {name} peak memory "
                  f"{out[name]['peak_gib']:.2f} GiB")
    b, t = batch["tokens"].shape
    prof = profile_steps(dev, cfg, model, profile_batch or batch,
                         HelixConfig(), label)
    w, kv, xkv = step_bytes(cfg, model, b, t + new)
    prof["bound_ms"] = (w + kv + xkv) / HBM_BPS * 1e3
    print(f"  {label} decode step byte bound {prof['bound_ms']:.4f} ms: "
          f"{w / 1e9:.4f} GB of weights, {kv / 1e6:.1f} MB of K/V"
          + (f", {xkv / 1e6:.1f} MB of cross K/V" if xkv else "")
          + f"; device {fmt_ms(prof['device_ms'])} is "
          + ("not measured" if prof["device_ms"] is None
             else f"{prof['device_ms'] / prof['bound_ms']:.2f}x it"))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": out, "profile": prof, "memory": mem}


WH_RUNS = {"fp w1": {}, "fp w4": dict(window=WINDOW),
           "int8 head w1": dict(int8=True),
           "int8 head w4": dict(int8=True, window=WINDOW)}
PH_RUNS = {"fp w1": {}, "fp w4": dict(window=WINDOW),
           "paged fp w4": dict(window=WINDOW, paged=True),
           "int8 KV w1": dict(kv8=True),
           "int8 head w1": dict(int8=True)}


def serve_whisper(dev):
    """whisper-base at full width and depth (6 encoder and 6 decoder
    layers, bf16, seeded random weights): 4 rows of 1500 frame embeddings
    and 64 prompt tokens, 64 greedy tokens a row, through the step
    functions: fp and int8 head at windows 1 and 4, window 4 == window 1
    token for token."""
    return serve_step_runs(dev, WHISPER, "whisper", whisper_batch, new=WH_NEW,
                           runs=WH_RUNS,
                           same_as={"fp w4": "fp w1",
                                    "int8 head w4": "int8 head w1"})


def serve_phi3(dev):
    """phi-3-vision-4.2b at full width and depth (32 layers, 32 MHA heads
    of 96, bf16, seeded random weights, ~7.6 GB): 4 rows of 256 patch
    embeddings + 512 text tokens, 32 greedy tokens a row, through the step
    functions: fp at windows 1 and 4, fp from a paged pool at window 4
    (equal streams), the int8 KV cache (``quantize_decode_state`` on the
    prefill's state) and the int8 head."""
    return serve_step_runs(dev, PHI3, "phi-3-vision", phi3_batch, new=PH_NEW,
                           runs=PH_RUNS,
                           same_as={"fp w4": "fp w1", "paged fp w4": "fp w1"})


def compare_whisper(dev):
    """whisper-base at full width and depth in f32 (``compare_small``): 1500
    frames and 64 tokens, prefill + 4 decode steps."""
    compare_small(dev, WHISPER, 63, dict(attn_backend="ref",
                                         prefill_backend="ref",
                                         matmul_backend="ref"), "whisper",
                  n_layers=6, t=WH_T, s_cap=128,
                  extra=lambda cfg, g: {
                      "enc_frames": whisper_batch(cfg, g, dev, b=1)[
                          "enc_frames"]})


def compare_phi3(dev):
    """4 layers of phi-3-vision at full width in f32 (``compare_small``):
    256 patches + 128 tokens, prefill + 4 decode steps."""
    compare_small(dev, PHI3, 64, dict(attn_backend="ref",
                                      prefill_backend="ref",
                                      matmul_backend="ref"), "phi-3-vision",
                  t=PH_P + 128, s_cap=448,
                  extra=lambda cfg, g: {
                      "patch_embeds": phi3_batch(cfg, g, dev, b=1)[
                          "patch_embeds"]})


def times_encdec_vlm(dev):
    """The new kernel modes and head size 96, bf16, timed as the table's
    rows are: B1 contiguous at whisper's cross shape (B = 4, 8 heads of 64,
    1500 frames, kvp 1; SDPA with a length mask); B2 non-causal (B = 4, T
    = S = 1500; SDPA without a mask) and cross (T = 64 over S = 1500); B2
    at head size 96 (B = 1, T = 768, 32/32 heads, causal; SDPA
    ``is_causal``); B1 at head size 96 fp, int8 and paged at the serve
    shape (B = 4, lengths 700-1000, 32/32 heads) and at B = 8, S = 4096;
    B3 at whisper's head (K = 512, N = 52224) and phi-3's (K = 3072, N =
    32256), M = 4."""
    g = torch.Generator(device=dev).manual_seed(65)
    dt, es = torch.bfloat16, 2
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
    b, s, h, hsz = 4, WH_S_ENC, WH_H, WH_HSZ
    out, shapes = {}, []
    q, k, v = rnd(b, h, hsz), rnd(b, h, s, hsz), rnd(b, h, s, hsz)
    tl = torch.tensor(s, dtype=torch.int32, device=dev)
    kw = dict(kvp=1, n_ranks=1, rank=0, rr_block=RR, window=0,
              contiguous=True, slot_offset=0, k_new=None, v_new=None)
    mask = (torch.arange(s, device=dev) < tl)[None, None, None].expand(
        b, 1, 1, s)
    fn = lambda: flash_decode_shards(q, k, v, tl, **kw)
    con = {**timed(fn), "device_ms": device_ms(fn, DECODE_KERNELS),
           "plain_ms": time_ms(lambda: flash_decode_shards_plain(
               q, k, v, tl, scale=hsz ** -0.5,
               block_s=kernel_block_s(512, s), **kw), iters=3, warmup=1),
           "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
               q[:, :, None], k, v, attn_mask=mask)),
           "library": "sdpa with a mask of the length"}
    con.update(_bound(2 * b * h * s * hsz * es + 2 * b * h * hsz * es
                      + b * h * 4, 4 * b * h * hsz * s, PEAK[dt]))
    out["flash_decode_contiguous"] = con
    shapes.append(("flash_decode_contiguous",
                   f"B={b} S_enc={s} kvp 1, {h} heads of {hsz} bf16"))
    kp, vp = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    for name, t in (("flash_prefill_noncausal", s),
                    ("flash_prefill_cross", WH_T)):
        qp = rnd(b, t, h, hsz)
        pre = {**timed(lambda: flash_prefill(qp, kp, vp, causal=False)),
               "plain_ms": time_ms(lambda: flash_prefill_ref(
                   qp, kp, vp, causal=False), iters=10),
               "library_ms": queued_ms(lambda: F.scaled_dot_product_attention(
                   qp.transpose(1, 2), kp.transpose(1, 2),
                   vp.transpose(1, 2))),
               "library": "sdpa without a mask"}
        pre.update(_bound((2 * b * t * h * hsz + 2 * b * s * h * hsz) * es,
                          4 * b * h * hsz * t * s, PEAK[dt]))
        out[name] = pre
        shapes.append((name, f"B={b} T={t} S={s} non-causal bf16, {h} heads "
                             f"of {hsz}"))
    out["flash_prefill_phi3"] = time_prefill_at(g, dev, PH_H, PH_H,
                                                t=PH_P + PH_TEXT, hsz=PH_HSZ)
    heads = f"{PH_H}/{PH_H} heads of {PH_HSZ}"
    shapes.append(("flash_prefill_phi3", f"B=1 T={PH_P + PH_TEXT} causal "
                                         f"bf16, {heads}"))
    for tag, tlens, cap in (("", (1000, 900, 800, 700), 1088),
                            ("_b8", (4096,) * 8, 4096)):
        dd = decode_serve_inputs(g, dev, PH_H, PH_H, hsz=PH_HSZ, tl=tlens,
                                 cap=cap)
        recs = (time_decode_at(dd),) + time_decode_modes(g, dev, dd)[:2]
        shape = ("B=4 lengths 700-1000 cap 1088" if not tag
                 else "B=8 S=4096") + f", {heads}, fused append"
        for mode, rec in zip(("", "_kv8", "_paged"), recs):
            name = f"flash_decode_phi3{mode}"
            if tag:
                out[name]["b8_s4096"] = rec
            else:
                out[name] = rec
            out[name + tag] = rec
            shapes.append((name + tag, shape + {"": " bf16",
                                                "_kv8": ", int8 K/V",
                                                "_paged": ", bf16 paged"}[mode]))
        del dd
    for name, d, vp_ in (("w8a16_matmul_whisper", WH_D, WH_VP),
                         ("w8a16_matmul_phi3", PH_D, PH_VP)):
        out[name] = mm = time_w8a16_at(g, dev, d, vp_)
        shapes.append((name, f"M=4 K={d} N={vp_} bf16 x, {mm['ctas']} CTAs"))
    print_times(out, shapes)
    for name in [n for n in out if n.endswith("_b8")]:
        del out[name]
    return out


# ------------------------------------------------------- phase 4b: ranks
HELIX_B, HELIX_S = 8, 4096          # B1's per-rank check (granite's heads)
# world -> (kvp, tpa); KVP 4 at world 4 left out for the script's time
# (phase 4c), KVP 2 x TPA 2 kept
HELIX_LAYOUTS = {2: ((2, 1),), 4: ((2, 2),)}
HELIX_HOPB = (1, 2)
# the serve runs' HOP-B chunk counts by layout: HOP-B 2 held against 1 at
# KVP 2 x TPA 2 (not at KVP 2, for the script's time)
HELIX_SERVE_HOPB = {(2, 1): (1,), (2, 2): (1, 2)}
HELIX_DEMO_NEW = 8                  # serve_demo(world=2): the streams' head
HELIX_PROMPT, HELIX_NEW = 1024, 32


def check_rank_decode(dev):
    """Each per-rank B1 launch (``n_ranks=1, rank=k``, fused append) ==
    shard k of the emulated one-launch call, bit for bit: outputs, LSEs
    and the appended caches, at KVP 2 and 4, bf16."""
    g = torch.Generator(device=dev).manual_seed(80)
    b, s = HELIX_B, HELIX_S
    tl = torch.randint(s // 2, s + 1, (b,), generator=g, device=dev,
                       dtype=torch.int32)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=dev).to(  # noqa
        torch.bfloat16)
    q, kn, vn = rnd(b, QH, HSZ), rnd(b, KH, HSZ), rnd(b, KH, HSZ)
    k, v = rnd(b, KH, s, HSZ), rnd(b, KH, s, HSZ)
    for kvp in (2, 4):
        s_loc = s // kvp
        ke, ve = k.clone(), v.clone()
        out, lse = flash_decode_shards(q, ke, ve, tl, kvp=kvp, n_ranks=kvp,
                                       rank=0, rr_block=RR, k_new=kn,
                                       v_new=vn)
        for r in range(kvp):
            sl = slice(r * s_loc, (r + 1) * s_loc)
            kr, vr = k[:, :, sl].clone(), v[:, :, sl].clone()
            o, l_ = flash_decode_shards(q, kr, vr, tl, kvp=kvp, n_ranks=1,
                                        rank=r, rr_block=RR, k_new=kn,
                                        v_new=vn)
            need(torch.equal(bits(o[0]), bits(out[r]))
                 and torch.equal(bits(l_[0]), bits(lse[r]))
                 and torch.equal(bits(kr), bits(ke[:, :, sl]))
                 and torch.equal(bits(vr), bits(ve[:, :, sl])),
                 f"B1 rank {r} of kvp {kvp} differs from the emulated shard")
        print(f"  B1 per rank (n_ranks=1, rank=k) == the emulated launch's "
              f"shard bit for bit: kvp {kvp}, B {b}, S {s}, lengths "
              f"{tl.tolist()}, fused append (outputs, LSEs, caches)")


def rank_attention(g):
    """On one rank: ``helix_attention(group=)`` at HOP-B 1 and 2 against
    the emulated call at the same KVP over the same (seeded) inputs, bit
    for bit, slices and appended shards.  Returns the checks' flags."""
    dev = g.device
    gen = torch.Generator(device=dev).manual_seed(81)
    b, s = HELIX_B, HELIX_S
    tl = torch.randint(s // 2, s + 1, (b,), generator=gen, device=dev,
                       dtype=torch.int32)
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=dev).to(  # noqa
        torch.bfloat16)
    q, kn, vn = rnd(b, QH, HSZ), rnd(b, KH, HSZ), rnd(b, KH, HSZ)
    k, v = rnd(b, KH, s, HSZ), rnd(b, KH, s, HSZ)
    ke, ve = k.clone(), v.clone()
    want = helix_attention(HelixConfig(kvp=g.kvp), q, ke, ve, tl, k_new=kn,
                           v_new=vn)
    qh, kh, s_loc = QH // g.tpa, KH // g.tpa, s // g.kvp
    heads, slots = slice(g.t * kh, (g.t + 1) * kh), slice(g.k * s_loc,
                                                          (g.k + 1) * s_loc)
    sl = qh * HSZ // g.kvp
    start = g.t * qh * HSZ + g.k * sl
    flags = {}
    hx = HelixConfig(kvp=g.kvp, tpa=g.tpa)
    for hopb in HELIX_HOPB:
        kl = k[:, heads, slots].contiguous()
        vl = v[:, heads, slots].contiguous()
        out = helix_attention(hx, q[:, g.t * qh:(g.t + 1) * qh].contiguous(),
                              kl, vl, tl, k_new=kn[:, heads].contiguous(),
                              v_new=vn[:, heads].contiguous(), group=g,
                              hopb_chunks=hopb)
        flags[hopb] = (torch.equal(bits(out), bits(want[:, start:start + sl]))
                       and torch.equal(bits(kl), bits(ke[:, heads, slots]))
                       and torch.equal(bits(vl), bits(ve[:, heads, slots])))
    return flags


def rank_recorded_run(g, cfg, model, prompts, hopb, dtype=torch.bfloat16):
    """``recorded_run`` on one rank: the engine across the ranks over
    ``prompts``, a decode step that keeps each decoding request's logits
    row; each decode step's collectives (calls and host ms) and host ms;
    for an MoE arch each token's routes (``RouteTap``; on rank 0 in the
    result)."""
    hx = HelixConfig(kvp=g.kvp, tpa=g.tpa, ep=g.ep)
    inner = build_serve_step(cfg, hx, return_logits=True, group=g,
                             hopb_chunks=hopb)
    logits, steps, holder = {}, [], {}
    tap = RouteTap() if cfg.moe else None

    def step(model_, state, tokens):
        c0, h0, t0 = dict(g.calls), dict(g.host_ms), time.perf_counter()
        n0 = tap.mark() if tap else 0
        (nxt, lg), state = inner(model_, state, tokens)
        steps.append((time.perf_counter() - t0,
                      {k: g.calls[k] - c0[k] for k in c0},
                      sum(g.host_ms[k] - h0[k] for k in h0)))
        for i, r in enumerate(holder["engine"].slots):
            if r is not None and r.state == DECODE:
                xs = logits.setdefault(r.rid, [])
                if tap:
                    tap.file(n0, (r.rid, len(xs) + 1), slice(i, i + 1))
                xs.append(lg[i, :cfg.vocab])
        if tap:
            tap.drop(n0)
        return nxt, state

    firsts = {}
    prefill = recording_prefill(cfg, make_prefill_step(cfg, hx, group=g),
                                prompts, firsts)
    if tap:
        prefill = tap.prefill(prefill, prompts)
    eng = DecodeEngine(cfg, model, step, prefill,
                       max_batch=4, max_seq=HELIX_PROMPT + HELIX_NEW + 1,
                       hx=hx, dtype=dtype, device=g.device, group=g)
    holder["engine"] = eng
    reqs = [Request(rid=i, prompt=p, max_new_tokens=HELIX_NEW)
            for i, p in enumerate(prompts)]
    registry.reset_launch_counts()
    with tap or contextlib.nullcontext():
        for r in reqs:
            eng.submit(r)
        while eng.pending():
            eng.step()
    torch.cuda.synchronize(g.device)
    counts = registry.launch_counts()
    lg = {rid: torch.stack(x).cpu() for rid, x in logits.items()}
    n = len(steps)
    return {"streams": {r.rid: r.out_tokens for r in reqs},
            "logits": lg if g.rank == 0 else None,
            "firsts": firsts if g.rank == 0 else None,
            "fingerprint": sum(int(bits(x).long().sum()) for x in lg.values()),
            "counts": counts, "steps": eng.decode_syncs,
            "prefills": eng.prefill_calls,
            "ttl_p50_ms": eng.metrics.summary()["ttl_s"]["p50"] * 1e3,
            "host_ms_step": sum(s[0] for s in steps) / n * 1e3,
            "calls_step": {k: sum(s[1][k] for s in steps) / n
                           for k in steps[0][1]},
            "coll_ms_step": sum(s[2] for s in steps) / n,
            "routes": tap.by_token if tap and g.rank == 0 else None}


def helix_rank_job(group, prompts):
    """One rank of a gloo world sharing the card: for each layout of the
    world (the group's, then KVP 2 x TPA 2 over the same 4 processes),
    ``rank_attention`` and full-width granite-3-2b served at each HOP-B."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-3-2b")
    out = []
    for kvp, tpa in HELIX_LAYOUTS[group.world]:
        g = group if (kvp, tpa) == (group.kvp, group.tpa) else HelixGroup(
            kvp, tpa, device=group.device)
        full = init_params(cfg, 0, dtype=torch.bfloat16, device=g.device)
        model = shard_model(full, cfg, g)
        del full
        gc.collect()
        torch.cuda.empty_cache()
        out.append({"layout": (kvp, tpa), "attn": rank_attention(g),
                    "serve": {h: rank_recorded_run(g, cfg, model, prompts, h)
                              for h in HELIX_SERVE_HOPB[kvp, tpa]}})
        del model
        gc.collect()
        torch.cuda.empty_cache()
    return out


def nccl_one_job(group, prompts):
    """NCCL at world 1: the rank prefill and one decode step over the
    rank's share (the whole model) against the emulated kvp = 1 path on
    the same weights and tokens: caches and step logits bit for bit; the
    prefill's last logits bit for bit against the single-process
    ``forward(last_only=True)`` (the head over the last position, as the
    rank prefill takes it; the emulated prefill's head runs over every
    position, and its error is printed)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-3-2b")
    dev = group.device
    full = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    toks = torch.tensor(prompts, dtype=torch.int64, device=dev)
    hx = HelixConfig()
    l0, st = make_prefill_step(cfg, hx)(full, {"tokens": toks})
    nxt = torch.argmax(l0[:, :cfg.vocab], dim=-1).to(torch.int32)
    model = shard_model(full, cfg, group)
    r0, rst = make_prefill_step(cfg, hx, group=group)(model, {"tokens": toks})
    f0 = forward(cfg, full, toks, prefill_backend=hx.prefill_backend,
                 last_only=True)[0][:, -1]
    caches = all(torch.equal(bits(st[k]), bits(rst[k]))
                 for k in ("kcache", "vcache"))
    (_, l1), st = build_serve_step(cfg, hx, return_logits=True)(full, st, nxt)
    (_, r1), rst = build_serve_step(cfg, hx, return_logits=True,
                                    group=group)(model, rst, nxt)
    torch.cuda.synchronize(dev)
    return {"backend": group.backend, "caches": caches,
            "step": torch.equal(bits(l1), bits(r1)),
            "appended": all(torch.equal(bits(st[k]), bits(rst[k]))
                            for k in ("kcache", "vcache")),
            "prefill": torch.equal(bits(f0), bits(r0)),
            "prefill_err": maxerr(l0, r0), "calls": dict(group.calls)}


def by_token(logits, firsts):
    """Logits keyed ``(rid, token)``: the prefill's under token 0, decode
    step j's under token j + 1, all on the CPU."""
    out = {(rid, 0): x for rid, x in firsts.items()}
    out.update({(rid, j + 1): x.cpu() for rid, xs in logits.items()
                for j, x in enumerate(xs)})
    return out


def helix_ranks(dev):
    """Phase 4b (module doc): Helix across ranks."""
    gc.collect()
    torch.cuda.empty_cache()
    check_rank_decode(dev)
    cfg = get_config("granite-3-2b")
    rows = generate_rows(4, prompt_len=HELIX_PROMPT, max_tokens=HELIX_NEW,
                         seed=0)
    prompts = [prompt_tokens(r, cfg.vocab) for r in rows]
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    base = {}
    for kvp in sorted({k for lays in HELIX_LAYOUTS.values()
                       for k, _ in lays}):
        firsts = {}
        s, lg, _, _ = recorded_run(dev, cfg, model, prompts, 0,
                                   hx=HelixConfig(kvp=kvp), firsts=firsts)
        base[kvp] = (s, by_token(lg, firsts))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    figures = {}
    for world in HELIX_LAYOUTS:
        stamp(f"{world} ranks over gloo on the one card")
        t0 = time.perf_counter()
        res = ranks.spawn(world, helix_rank_job, prompts,
                          tpa=HELIX_LAYOUTS[world][0][1], backend="gloo",
                          device=dev, timeout_s=600)
        print(f"  {world} ranks spawned, ran and joined in "
              f"{time.perf_counter() - t0:.1f} s")
        for li, (kvp, tpa) in enumerate(HELIX_LAYOUTS[world]):
            lay = [r[li] for r in res]
            tag = f"world {world} (kvp {kvp} x tpa {tpa})"
            for hopb in HELIX_HOPB:
                need(all(x["attn"][hopb] for x in lay),
                     f"{tag}: helix_attention at HOP-B {hopb} differs from "
                     "the emulated call")
            print(f"  {tag}: helix_attention == the emulated call bit for "
                  f"bit on every rank at HOP-B {HELIX_HOPB} (B {HELIX_B}, "
                  f"S {HELIX_S}, bf16, fused append)")
            runs = {h: [x["serve"][h] for x in lay]
                    for h in HELIX_SERVE_HOPB[kvp, tpa]}
            for hopb, per in runs.items():
                r0 = per[0]
                need(all(p["streams"] == r0["streams"]
                         and p["fingerprint"] == r0["fingerprint"]
                         for p in per),
                     f"{tag} HOP-B {hopb}: ranks hold other streams or logits")
                for r, p in enumerate(per):
                    want = {"flash_decode": cfg.n_layers * p["steps"] * hopb,
                            "flash_prefill": cfg.n_layers * p["prefills"]}
                    got = {k: p["counts"][k] for k in want}
                    need(got == want and p["counts"]["flash_decode_kv8"] == 0
                         and p["counts"]["flash_decode_paged"] == 0,
                         f"{tag} rank {r} HOP-B {hopb}: launches {got} != "
                         f"{want}")
                near_ties(f"{tag} HOP-B {hopb} vs the emulated kvp {kvp} run",
                          base[kvp][0], base[kvp][1], r0["streams"],
                          by_token(r0["logits"], r0["firsts"]),
                          judge_first=True)
                print(f"    HOP-B {hopb}: launches per rank flash_decode "
                      f"{cfg.n_layers} layers x {r0['steps']} steps x "
                      f"{hopb} chunks, flash_prefill {cfg.n_layers} x "
                      f"{r0['prefills']}; gloo-staged on one card (not "
                      f"Helix's TTL): TTL p50 {r0['ttl_p50_ms']:.2f} ms, "
                      f"host {r0['host_ms_step']:.2f} ms per decode step, "
                      f"collectives per step {r0['calls_step']} holding the "
                      f"host {r0['coll_ms_step']:.2f} ms ({card})")
                figures[f"{kvp}x{tpa} h{hopb}"] = r0
            if len(runs) == 1:
                continue
            a, b_ = runs[1][0], runs[2][0]
            need(a["streams"] == b_["streams"] and all(
                torch.equal(bits(a["logits"][rid]), bits(b_["logits"][rid]))
                for rid in a["logits"]),
                f"{tag}: HOP-B 2 differs from HOP-B 1")
            print(f"  {tag}: HOP-B 2 == HOP-B 1 bit for bit (streams and "
                  "every decode logit)")
    stamp("serve_demo(world=2, dist_backend='gloo'), the user's entry point")
    fin, summ = serve_demo("granite-3-2b", world=2, dist_backend="gloo",
                           n_requests=4, prompt_len=HELIX_PROMPT,
                           max_new=HELIX_DEMO_NEW, max_batch=4,
                           dtype=torch.bfloat16, device=dev)
    need({r.rid: r.out_tokens for r in fin}
         == {rid: s[:HELIX_DEMO_NEW]
             for rid, s in figures["2x1 h1"]["streams"].items()},
         "serve_demo(world=2) streams differ from the recorded 2-rank run")
    want = {"flash_decode": cfg.n_layers * summ["decode_syncs"],
            "flash_prefill": cfg.n_layers * summ["prefill_calls"]}
    got = [{k: c[k] for k in want} for c in summ["rank_launches"]]
    need(all(g == want for g in got),
         f"serve_demo(world=2) launches {got} != {want} per rank")
    print(f"  serve_demo(world=2), {HELIX_DEMO_NEW} new tokens a request: "
          "streams == the recorded 2-rank run's first "
          f"{HELIX_DEMO_NEW} tokens; launches per rank {got}; TTL p50 "
          f"{summ['ttl_s']['p50'] * 1e3:.2f} ms (gloo-staged on one card, "
          f"{card})")
    stamp("NCCL at world 1")
    (one,) = ranks.spawn(1, nccl_one_job, prompts, backend="nccl",
                         device=dev, timeout_s=300)
    need(one["caches"] and one["step"] and one["appended"]
         and one["prefill"],
         f"NCCL world 1 differs from the emulated kvp 1 path: {one}")
    print(f"  NCCL ({one['backend']}) world 1: prefill caches, the decode "
          f"step's logits and its appended caches == the emulated kvp 1 "
          f"path bit for bit; the prefill's last logits == the single-"
          f"process forward(last_only=True) bit for bit (within "
          f"{one['prefill_err']:.3g} of the emulated prefill's, whose head "
          f"runs over every position); collectives {one['calls']}")
    return figures


# ------------------------------------------- phase 4c: MoE across ranks
# world -> (kvp, tpa, ep): default_helix_config at model 1 and 2
MOE_RANK_LAYOUTS = {2: (2, 1, 2), 4: (2, 2, 2)}
# f32 rank runs against the single-process run: logits within LOGIT_TOL
# up to a request's first route flip, and that flip a router near-tie:
# the k-th and (k+1)-th probabilities within ROUTE_TIE (the rank path
# moves a layer's input by f32 rounding, ~1e-7 relative)
ROUTE_TIE = 1e-5
# the f32 rank runs' depth: granite-moe 12 of 24 (the script's time),
# arctic 1 layer (56.3 GB)
MOE_F32_LAYERS = {MOE: 12, ARCTIC: 1}


def route_run(dev, cfg, model, prompts, hx, dtype):
    """The single-process baseline of a rank run: the engine over
    ``prompts`` (``HELIX_NEW`` tokens each, max_batch 4, the fixed
    layout, caches in ``dtype``) with the prefill's and every decode
    step's logits and routes kept by token (``RouteTap``).  Returns
    (streams, logits by token, routes by token)."""
    logits, firsts, holder = {}, {}, {}
    inner = build_serve_step(cfg, hx, return_logits=True)
    tap = RouteTap()

    def step(model_, state, tokens):
        n0 = tap.mark()
        (nxt, lg), state = inner(model_, state, tokens)
        for i, r in enumerate(holder["engine"].slots):
            if r is not None and r.state == DECODE:
                xs = logits.setdefault(r.rid, [])
                tap.file(n0, (r.rid, len(xs) + 1), slice(i, i + 1))
                xs.append(lg[i, :cfg.vocab].cpu())
        tap.drop(n0)
        return nxt, state

    prefill = tap.prefill(recording_prefill(cfg, make_prefill_step(cfg, hx),
                                            prompts, firsts), prompts)
    eng = DecodeEngine(cfg, model, step, prefill, max_batch=4,
                       max_seq=HELIX_PROMPT + HELIX_NEW + 1, hx=hx,
                       dtype=dtype, device=dev)
    holder["engine"] = eng
    reqs = [Request(rid=i, prompt=p, max_new_tokens=HELIX_NEW)
            for i, p in enumerate(prompts)]
    with tap:
        for r in reqs:
            eng.submit(r)
        while eng.pending():
            eng.step()
    return ({r.rid: r.out_tokens for r in reqs}, by_token(logits, firsts),
            tap.by_token)


def first_flip(b_routes, routes, rid, j):
    """The first route of token j of request ``rid`` whose set of experts
    differs between two runs (an order within the top k that differs
    only reorders a sum): ``(token, layer, gap)``, the earliest layer with
    a difference and the largest baseline router gap among the rows that
    differ there (a flip at the earliest layer has no earlier flip behind
    it); None when every route is equal."""
    bi, bg = b_routes[rid, j]
    diff = (bi.sort(-1).values
            != routes[rid, j][0].sort(-1).values).any(-1)   # [L, n]
    layers = diff.any(-1).nonzero().flatten()
    if not len(layers):
        return None
    lay = int(layers[0])
    return (j, lay, float(bg[lay][diff[lay]].max()))


def route_ties(tag, base, streams, logits, routes, *, tol=None, tie=None):
    """Two MoE runs, request by request, token by token (token 0: the
    routes of every prompt position): the routes of every layer, the
    logits, the tokens.  Up to a request's first route flip the logits
    must agree within ``tol`` and the tokens be equal
    or part at a logit near-tie (within 2 x ``tol``, as ``near_ties``);
    that first flip must be a router near-tie, its baseline gap between
    the k-th and (k+1)-th probability within ``tie``.  After a flip or a
    parting nothing is judged (the inputs differ: a capacity-routed
    prefill reassigns the slots of later tokens).  ``tol=None``: printed,
    not judged (bf16: see ``moe_ranks``)."""
    b_streams, b_logits, b_routes = base
    report, worst, n_cmp = [], 0.0, 0
    for rid, a in b_streams.items():
        b = streams[rid]
        flip = part = None
        for j in range(min(len(a), len(b))):
            flip = first_flip(b_routes, routes, rid, j)
            if flip:
                break
            n_cmp += 1
            want = b_logits[rid, j]
            worst = max(worst, maxerr(want, logits[rid, j]))
            if a[j] != b[j]:
                part = (j, float(want[a[j]] - want[b[j]]))
                break
        report.append((rid, flip, part))
    judged = "" if tol is None else f" (tol {tol:g})"
    print(f"  {tag}: streams equal {sum(streams[r] == a for r, a in b_streams.items())}"
          f" of {len(b_streams)}; logits compared at {n_cmp} tokens before "
          f"any route flip or parting, max err {worst:.4g}{judged}; per "
          "request (rid, first route flip (token, "
          "layer, baseline router gap), parting before it (token, logit "
          f"gap)): {report}")
    if tol is None:
        return
    need(worst <= tol, f"{tag}: logits beyond the tolerance ({worst:.4g})")
    need(all(p is None or abs(p[1]) <= 2 * tol for _, _, p in report),
         f"{tag}: a stream parted away from a near-tie: {report}")
    need(all(f is None or f[2] <= tie for _, f, _ in report),
         f"{tag}: a route flipped away from a router near-tie: {report}")


def moe_rank_job(group, plan):
    """One rank of a gloo world sharing the card: for each ``(arch,
    layers, prompts, dtype)`` of ``plan``, the rank's share drawn by
    ``init_rank_params`` (its bytes and the peak memory after), then
    ``rank_recorded_run`` (its peak memory); the share is freed before
    the next entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    dev = group.device
    for arch, layers, prompts, dtype in plan:
        cfg = dataclasses.replace(get_config(arch), n_layers=layers)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        model = init_rank_params(cfg, group, 0, dtype=dtype, device=dev)
        torch.cuda.synchronize(dev)
        res = {"init_s": time.perf_counter() - t0,
               "share_gb": sum(p.numel() * p.element_size()
                               for p in model.parameters()) / 1e9,
               "init_peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30}
        torch.cuda.reset_peak_memory_stats(dev)
        res["serve"] = rank_recorded_run(group, cfg, model, prompts, 1, dtype)
        res["serve"]["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        out.append(res)
        del model
    return out


def serve_arctic(dev, prompts):
    """arctic-480b at full width, ``ARCTIC_LAYERS`` of its 35 layers (bf16,
    seeded random weights, 128 experts, top 2, a dense residual FFN,
    untied head) in one process: the model's bytes and peak memory; 8
    requests of 128-1024 tokens, 32 new, through ``serve_plan``'s greedy
    w1, top-p w4, paged top-p w4 (its streams equal to top-p w4's) and
    int8 greedy w4 (layers x steps and layers x prefills each, peak memory
    each); the decode-step profile beside its byte bound (every weight but
    the embedding table, the experts all read by the batched products, and
    the K/V of the 4 rows); a 1024-token prefill profile; then the
    baseline of the rank runs (``route_run`` at KVP 2 over ``prompts``)."""
    cfg = dataclasses.replace(get_config(ARCTIC), n_layers=ARCTIC_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    expert_bytes = sum(getattr(lp.moe, w).numel() * 2 for lp in model.layers
                       for w in ("w1", "w2", "w3"))
    print(f"  arctic model ({cfg.n_layers} of 35 layers): {wbytes / 1e9:.3f} "
          f"GB of weights, {expert_bytes / 1e9:.3f} GB of them experts; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          "after the build (each expert drawn alone)")
    reqs = dict(n_requests=8, prompt_len=(128, 1024), max_new=32,
                n_layers=ARCTIC_LAYERS)
    runs = serve_plan(dev, ARCTIC, model, "arctic", reqs,
                      lambda **kw: path_counts(cfg.n_layers, 8, **kw),
                      names=("greedy w1", "top-p w4", "paged top-p w4",
                             "int8 greedy w4"))
    tl = (1000, 900, 800, 700)
    step = profile_decode(dev, cfg, model, HelixConfig(), tl=tl)
    read = wbytes - model.embed.numel() * 2
    kv = 2 * cfg.n_layers * cfg.kv_dim * 2 * sum(tl)
    bound = (read + kv) / HBM_BPS * 1e3
    print(f"  arctic decode step (B=4, lengths 700-1000, {cfg.n_layers} "
          f"layers): device {fmt_ms(step['device_ms'])} per step against its "
          f"byte bound {bound:.4f} ms ({read / 1e9:.3f} GB of weights read, "
          f"the batched expert products reading all {cfg.moe.n_experts} "
          f"experts; {kv / 1e6:.1f} MB of K/V)")
    prof = profile_prefill(dev, cfg, model, HelixConfig(), "prefill_wgmma",
                           "flash_prefill")
    stamp("arctic-480b's single-process baseline of the rank runs (KVP 2)")
    base = route_run(dev, cfg, model, prompts, HelixConfig(kvp=2),
                   torch.bfloat16)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"runs": runs, "prefill": prof, "decode": dict(step, bound_ms=bound),
            "base": base}


def moe_baseline(dev, arch, layers, prompts, dtype):
    """``route_run`` at KVP 2 over a freshly drawn ``arch`` of ``layers``
    layers in ``dtype`` (seed 0, the ranks' weights), freed after."""
    cfg = dataclasses.replace(get_config(arch), n_layers=layers)
    model = init_params(cfg, 0, dtype=dtype, device=dev)
    base = route_run(dev, cfg, model, prompts, HelixConfig(kvp=2), dtype)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return base


def moe_ranks(dev):
    """Phase 4c (module doc): MoE across ranks.  The bf16 runs are the
    serving runs (timings, memory, ranks bit-equal, launches,
    collectives); their divergence from the bf16 single-process run is
    printed, not judged: bf16 rounding in the rank path's order flips
    router near-ties, and a flip in a capacity-routed prefill (factor
    1.25) reassigns the slots of every later token of its experts, so
    whole layers part (seen on the card: logits 3.0 apart at token 0).
    The f32 runs are held
    to the f32 single-process run by ``route_ties``."""
    gc.collect()
    torch.cuda.empty_cache()
    card = card_line()
    rows = generate_rows(4, prompt_len=HELIX_PROMPT, max_tokens=HELIX_NEW,
                         seed=0)
    bf16, f32 = torch.bfloat16, torch.float32
    layers = {(MOE, bf16): 24, (MOE, f32): MOE_F32_LAYERS[MOE],
              (ARCTIC, bf16): ARCTIC_LAYERS, (ARCTIC, f32):
                  MOE_F32_LAYERS[ARCTIC]}
    prompts = {a: [prompt_tokens(r, get_config(a).vocab) for r in rows]
               for a in (MOE, ARCTIC)}
    base = {}
    for dt in (bf16, f32):
        stamp(f"{MOE}'s single-process baseline of the rank runs "
              f"({layers[MOE, dt]} layers, {str(dt)[6:]}, KVP 2)")
        base[MOE, dt] = moe_baseline(dev, MOE, layers[MOE, dt], prompts[MOE],
                                     dt)
    stamp(f"{ARCTIC} in one process ({ARCTIC_LAYERS} of 35 layers, full "
          "width)")
    arctic = serve_arctic(dev, prompts[ARCTIC])
    base[ARCTIC, bf16] = arctic.pop("base")
    stamp(f"{ARCTIC} 1-layer f32 checks (full width)")
    compare_small(dev, ARCTIC, 76, dict(attn_backend="ref",
                                        prefill_backend="ref",
                                        matmul_backend="ref"), "arctic",
                  n_layers=1)
    stamp(f"{ARCTIC}'s f32 single-process baseline of the rank runs "
          f"({layers[ARCTIC, f32]} layer, KVP 2)")
    base[ARCTIC, f32] = moe_baseline(dev, ARCTIC, layers[ARCTIC, f32],
                                     prompts[ARCTIC], f32)
    whole_gb = {}
    for (a, dt), n in layers.items():
        with torch.device("meta"):
            whole_gb[a, dt] = sum(p.numel() for p in Transformer(
                dataclasses.replace(get_config(a), n_layers=n)).parameters()
            ) * dt.itemsize / 1e9
    for world, (kvp, tpa, ep) in MOE_RANK_LAYOUTS.items():
        plan = [(a, n, prompts[a], dt) for (a, dt), n in layers.items()]
        stamp(f"{world} gloo ranks on the one card: kvp {kvp} x tpa {tpa}, "
              f"ep {ep} x tpf {world // ep}")
        t0 = time.perf_counter()
        res = ranks.spawn(world, moe_rank_job, plan, tpa=tpa, ep=ep,
                          backend="gloo", device=dev, timeout_s=900)
        print(f"  {world} ranks spawned, ran and joined in "
              f"{time.perf_counter() - t0:.1f} s")
        for ai, (arch, n, _, dt) in enumerate(plan):
            tag = (f"{arch} {str(dt)[6:]} {n} layers, world {world} (kvp "
                   f"{kvp} x tpa {tpa}, ep {ep} x tpf {world // ep})")
            per = [r[ai] for r in res]
            for r, x in enumerate(per):
                need(x["share_gb"] < whole_gb[arch, dt],
                     f"{tag} rank {r}: a share of {x['share_gb']:.3f} GB")
                print(f"    {tag} rank {r}: share {x['share_gb']:.3f} GB of "
                      f"the whole {whole_gb[arch, dt]:.3f} GB (drawn in "
                      f"{x['init_s']:.1f} s, peak {x['init_peak_gib']:.2f} "
                      f"GiB); serve peak {x['serve']['peak_gib']:.2f} GiB")
            runs = [x["serve"] for x in per]
            r0 = runs[0]
            need(all(p["streams"] == r0["streams"]
                     and p["fingerprint"] == r0["fingerprint"] for p in runs),
                 f"{tag}: ranks hold other streams or logits")
            want_calls = {"all_to_all": n, "all_gather": n + 1,
                          "all_reduce": 2 * n}
            for r, p in enumerate(runs):
                want = {"flash_decode": n * p["steps"],
                        "flash_prefill": n * p["prefills"]}
                got = {k: p["counts"][k] for k in want}
                need(got == want and p["counts"]["flash_decode_kv8"] == 0
                     and p["counts"]["flash_decode_paged"] == 0,
                     f"{tag} rank {r}: launches {got} != {want}")
                need(p["calls_step"] == want_calls,
                     f"{tag} rank {r}: collectives per step "
                     f"{p['calls_step']} != {want_calls}")
            judge = dict(tol=LOGIT_TOL, tie=ROUTE_TIE) if dt == f32 else {}
            route_ties(f"{tag} vs the single-process kvp {kvp} run"
                       f"{'' if judge else ' (printed)'}", base[arch, dt],
                       r0["streams"], by_token(r0["logits"], r0["firsts"]),
                       r0["routes"], **judge)
            print(f"    launches per rank flash_decode {n} layers x "
                  f"{r0['steps']} steps, flash_prefill {n} x "
                  f"{r0['prefills']}; collectives per step {r0['calls_step']}"
                  " (1 all-to-all, 1 LSE all-gather and 2 all-reduces a "
                  "layer, 1 head all-gather); gloo-staged on one card (not "
                  f"Helix's TTL): TTL p50 {r0['ttl_p50_ms']:.2f} ms, host "
                  f"{r0['host_ms_step']:.2f} ms per decode step, the "
                  f"collectives holding it {r0['coll_ms_step']:.2f} ms "
                  f"({card})")
    return arctic


def rotating(fns):
    """One callable that calls ``fns`` in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def w8a16_library(x, qw, scale):
    """(label, fn): the one PyTorch call timed beside the w8a16 kernel.
    ``aten._weight_int8pack_mm`` (int8 [N, K] weights, scales in x's type)
    where this build runs it on the card and agrees with the plain version;
    otherwise a matmul over the head dequantized to x's type."""
    wt, sc = qw.t().contiguous(), scale.to(x.dtype)
    want = w8a16_matmul_ref(x, qw, scale).float()
    try:
        got = torch.ops.aten._weight_int8pack_mm(x, wt, sc)
        torch.cuda.synchronize()
        ok = maxerr(got, want) <= 2.0 ** -6 * want.abs().max().item()
    except (NotImplementedError, RuntimeError) as e:
        print(f"  aten._weight_int8pack_mm not usable here: "
              f"{str(e).splitlines()[0][:120]}")
        ok = False
    if ok:
        return ("aten._weight_int8pack_mm",
                lambda: torch.ops.aten._weight_int8pack_mm(x, wt, sc))
    head = (qw.float() * scale).to(x.dtype)
    return ("torch.matmul over the head dequantized to bf16",
            lambda: x @ head)


def _bound(nbytes, ops, peak):
    tb, to = nbytes / HBM_BPS * 1e3, ops / peak * 1e3
    return {"bound_ms": max(tb, to),
            "bound_by": "bytes" if tb >= to else "operations"}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    print("== 1 device")
    cap = torch.cuda.get_device_capability(0)
    card = card_line()
    print(card)
    need(cap == (9, 0), f"needs compute capability 9.0, found {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]}, torch "
          f"{torch.__version__} cuda {torch.version.cuda}; allow_tf32 "
          f"matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    print(f"== 2 build (t = {time.perf_counter() - T0:.1f} s)")
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    for bk in built.values():
        print(f"  {bk.name}: nvcc {bk.seconds:.1f} s")
        for ln in bk.ptxas:
            print(f"    {ln}")
    print("  the hsz 256 instances (gemma3-12b): registers, spill stores / "
          "loads (bytes)")
    for bk in built.values():
        inst, notes = ptxas_instances(bk.ptxas)
        for name, regs, st, ld in inst:
            short = re.sub(r"^\d+", "", name.split("_cu_")[-1][8:])
            short = short.split("EvNS_")[0]
            print(f"    {bk.name}: {short}: {regs} registers, spill {st} / "
                  f"{ld}")
        for ln in notes:
            print(f"    {bk.name}: {ln}")
    print("  flash_decode's 4-rows-a-warp instances (G 9-16: starcoder2-15b, "
          "llama-405b): registers, spill stores / loads (bytes)")
    inst, _ = ptxas_instances(built["flash_decode"].ptxas,
                              "Li4EEEvNS_10Decode")
    need(inst, "no 4-rows-a-warp flash_decode instance in the build")
    for name, regs, st, ld in inst:
        short = name.split("decode_kernel")[-1].split("EEEvNS_")[0]
        print(f"    flash_decode: decode_kernel{short}: {regs} registers, "
              f"spill {st} / {ld}")
    print("  the hsz 96 instances (phi-3-vision): registers, spill stores / "
          "loads (bytes)")
    for bk in built.values():
        inst, _ = ptxas_instances(bk.ptxas, "Li96E")
        for name, regs, st, ld in inst:
            short = re.sub(r"^\d+", "", name.split("_cu_")[-1][8:])
            print(f"    {bk.name}: {short.split('EvNS_')[0]}: {regs} "
                  f"registers, spill {st} / {ld}")
    need(any(ptxas_instances(bk.ptxas, "Li96E")[0]
             for bk in built.values()), "no hsz 96 instance in the build")
    print("  (the build holds the decode tiles' swizzle to a permutation of "
          "each row's 16-byte units at every instantiated (type, head size):"
          " a static_assert in decode_tile.cuh's Ring)")

    if sys.argv[1:] == ["--ranks-only"]:
        print(f"== 4b helix ranks (t = {time.perf_counter() - T0:.1f} s)")
        helix_ranks(dev)
        print(f"== 4c MoE ranks (t = {time.perf_counter() - T0:.1f} s)")
        moe_ranks(dev)
        print(f"  done at t = {time.perf_counter() - T0:.1f} s")
        print(card)
        return 0

    print(f"== 3 kernels vs plain on the card (t = "
          f"{time.perf_counter() - T0:.1f} s)")
    errs = {name: [] for name in ("flash_decode", "flash_decode_kv8",
                                  "flash_decode_paged",
                                  "flash_decode_paged_kv8",
                                  "flash_decode_grouped", "flash_prefill",
                                  "flash_prefill_paged", "w8a16_matmul",
                                  "ssd_prefill", "flash_prefill_hymba",
                                  "flash_decode_hymba",
                                  "flash_decode_hymba_kv8",
                                  "flash_decode_hymba_paged",
                                  "ssd_prefill_hymba", "w8a16_matmul_hymba",
                                  "flash_prefill_moe", "flash_decode_moe",
                                  "flash_decode_moe_kv8",
                                  "flash_decode_moe_paged",
                                  "w8a16_matmul_moe", "flash_prefill_gemma3",
                                  "flash_decode_gemma3",
                                  "flash_decode_gemma3_kv8",
                                  "flash_decode_gemma3_paged",
                                  "prefix_pass_gemma3",
                                  "w8a16_matmul_gemma3",
                                  "flash_prefill_sc2", "flash_decode_sc2",
                                  "flash_decode_sc2_kv8",
                                  "flash_decode_sc2_paged",
                                  "w8a16_matmul_sc2", "flash_prefill_llama",
                                  "flash_decode_llama",
                                  "flash_decode_llama_kv8",
                                  "flash_decode_llama_paged",
                                  "prefix_pass_llama",
                                  "w8a16_matmul_llama",
                                  "flash_prefill_noncausal",
                                  "flash_prefill_cross",
                                  "flash_decode_contiguous",
                                  "flash_prefill_phi3", "flash_decode_phi3",
                                  "flash_decode_phi3_kv8",
                                  "flash_decode_phi3_paged",
                                  "w8a16_matmul_whisper",
                                  "w8a16_matmul_phi3",
                                  "flash_prefill_arctic",
                                  "flash_decode_arctic",
                                  "flash_decode_arctic_kv8",
                                  "flash_decode_arctic_paged",
                                  "w8a16_matmul_arctic")}
    check_decode(dev, errs["flash_decode"])
    check_decode_kv8(dev, errs["flash_decode_kv8"])
    check_decode_paged(dev, errs["flash_decode_paged"],
                       errs["flash_decode_paged_kv8"])
    check_grouped(dev, errs["flash_decode_grouped"])
    check_decode_chunks(dev, errs["flash_decode"], errs["flash_decode_kv8"])
    check_prefill(dev, errs["flash_prefill"], errs["flash_prefill_paged"])
    check_w8a16(dev, errs["w8a16_matmul"])
    check_ssd(dev, errs["ssd_prefill"])
    check_prefill_group(dev, errs["flash_prefill_hymba"],
                        errs["flash_prefill_paged"])
    check_decode_group(dev, errs)
    check_hymba_ssd_w8(dev, errs["ssd_prefill_hymba"],
                       errs["w8a16_matmul_hymba"])
    check_prefill_group(dev, errs["flash_prefill_moe"],
                        errs["flash_prefill_paged"], MOE_QH, MOE_KH, 30)
    check_decode_group(dev, errs, MOE_QH, MOE_KH, 36, "flash_decode_moe")
    check_w8a16_head(dev, errs["w8a16_matmul_moe"],
                     torch.Generator(device=dev).manual_seed(37), MOE_D,
                     MOE_VP, "moe")
    check_moe_ffn(dev)
    check_prefill_group(dev, errs["flash_prefill_gemma3"],
                        errs["flash_prefill_paged"], GE_QH, GE_KH, 40,
                        hsz=GE_HSZ, t=2048, windows=(0, GE_WIN))
    check_decode_group(dev, errs, GE_QH, GE_KH, 45, "flash_decode_gemma3",
                       hsz=GE_HSZ, tl=GE_TL, cap=GE_CAP, windows=(0, GE_WIN))
    check_grouped_gemma3(dev, errs["prefix_pass_gemma3"])
    check_w8a16_head(dev, errs["w8a16_matmul_gemma3"],
                     torch.Generator(device=dev).manual_seed(46), GE_D,
                     GE_VP, "gemma3")
    stamp("the kernels at starcoder2-15b's and llama-405b's heads")
    for tag, qh, kh, seed in (("sc2", SC2_QH, SC2_KH, 50),
                              ("llama", LL_QH, LL_KH, 52)):
        check_prefill_group(dev, errs[f"flash_prefill_{tag}"],
                            errs["flash_prefill_paged"], qh, kh, seed,
                            hsz=DENSE_HSZ)
        check_decode_group(dev, errs, qh, kh, seed + 1,
                           f"flash_decode_{tag}", hsz=DENSE_HSZ)
    check_grouped_llama(dev, errs["prefix_pass_llama"])
    for tag, d, vp, seed in (("sc2", SC2_D, SC2_VP, 54),
                             ("llama", LL_D, LL_VP, 55)):
        check_w8a16_head(dev, errs[f"w8a16_matmul_{tag}"],
                         torch.Generator(device=dev).manual_seed(seed), d,
                         vp, tag)
    stamp("the kernels at arctic-480b's heads (56/8 of 128, G = 7)")
    check_prefill_group(dev, errs["flash_prefill_arctic"],
                        errs["flash_prefill_paged"], AR_QH, AR_KH, 73,
                        hsz=DENSE_HSZ)
    check_decode_group(dev, errs, AR_QH, AR_KH, 74, "flash_decode_arctic",
                       hsz=DENSE_HSZ)
    check_w8a16_head(dev, errs["w8a16_matmul_arctic"],
                     torch.Generator(device=dev).manual_seed(75), AR_D,
                     AR_VP, "arctic")
    stamp("the kernels at whisper-base's and phi-3-vision's shapes")
    check_encdec_modes(dev, errs)
    check_prefill_group(dev, errs["flash_prefill_phi3"],
                        errs["flash_prefill_paged"], PH_H, PH_H, 66,
                        hsz=PH_HSZ, t=PH_P + PH_TEXT)
    check_decode_group(dev, errs, PH_H, PH_H, 67, "flash_decode_phi3",
                       hsz=PH_HSZ)
    for tag, d, vp, seed in (("whisper", WH_D, WH_VP, 68),
                             ("phi3", PH_D, PH_VP, 69)):
        check_w8a16_head(dev, errs[f"w8a16_matmul_{tag}"],
                         torch.Generator(device=dev).manual_seed(seed), d,
                         vp, tag)
    check_sampler(dev)

    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve granite-3-2b "
          "(40 layers, bf16): fixed fp and int8, "
          "paged fp and int8, paged fp under pool pressure; decode "
          "windows; chunked, prefix-shared and grouped runs")
    runs = serve_full(dev)
    stamp("granite 4-layer f32 checks")
    compare_paths(dev)
    paged_pre = paged_prefill_path(dev)
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve mamba2-780m "
          f"({MAMBA_LAYERS} of 48 layers, bf16); 4-layer f32 checks")
    mamba = serve_mamba(dev)
    compare_mamba(dev)
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve hymba-1.5b "
          f"({HYMBA_LAYERS} of 32 layers, bf16): greedy, top-p at windows 1 "
          "and 4, paged, int8 head + int8 KV; 4-layer f32 checks")
    hymba = serve_hymba(dev)
    compare_hymba(dev)
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve {MOE} "
          f"({MOE_LAYERS} of 24 layers, bf16, 32 experts, top 8): greedy, "
          "top-p at windows 1 and 4, paged, int8 head + int8 KV; 4-layer f32 "
          "checks")
    moe = serve_moe(dev)
    compare_moe(dev)
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve {GEMMA} "
          f"({GEMMA_LAYERS} of 48 layers, bf16, 20 local of a 1024-token "
          "window, head size 256): "
          "greedy, top-p at windows 1 and 4, paged, int8 head + int8 KV; "
          "chunked unshared, prefix-shared and grouped; 6-layer f32 checks")
    gemma = serve_gemma3(dev)
    stamp("gemma3 6-layer f32 checks")
    compare_gemma3(dev)
    plain = dict(attn_backend="ref", prefill_backend="ref",
                 matmul_backend="ref")
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve {SC2} "
          f"({SC2_LAYERS} of 40 layers, bf16, 48 q / 4 kv heads of 128: G = "
          "12, ungated GELU): greedy, top-p at windows 1 and 4, paged, int8 "
          "head + int8 KV; chunked unshared, prefix-shared and grouped; "
          "4-layer f32 checks")
    sc2 = serve_dense(dev, SC2, "starcoder2", n_layers=SC2_LAYERS,
                      graph=True)
    compare_small(dev, SC2, 56, plain, "starcoder2")
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve {LLAMA} at "
          f"full width, its depth cut to {LLAMA_LAYERS} of 126 layers (bf16, "
          "128 q / 8 kv heads of 128: G = 16): greedy w1, top-p w4, paged "
          "top-p w4, int8 greedy w4, grouped (c); 2-layer f32 checks")
    llama = serve_dense(dev, LLAMA, "llama", n_layers=LLAMA_LAYERS,
                        names=("greedy w1", "top-p w4", "paged top-p w4",
                               "int8 greedy w4"),
                        shared=("c + grouped_decode",))
    compare_small(dev, LLAMA, 57, plain, "llama", n_layers=2)
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve {G8B} (36 "
          "layers, bf16, 32 q / 8 kv heads of 128): greedy w4, paged int8 "
          "greedy w4")
    serve_dense(dev, G8B, "granite-8b", names=("greedy w4",
                                                "paged int8 greedy w4"),
                shared=(), profiles=False)
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve {WHISPER} (6 "
          "encoder + 6 decoder layers, bf16, 8 heads of 64, 1500 frames) "
          "through the step functions: fp and int8 head at windows 1 and 4;"
          " full-depth f32 checks")
    whisper = serve_whisper(dev)
    compare_whisper(dev)
    print(f"== 4 (t = {time.perf_counter() - T0:.1f} s) serve {PHI3} (32 "
          "layers, bf16, 32 MHA heads of 96, 256 patches + 512 tokens) "
          "through the step functions: fp w1 and w4, paged w4, int8 KV, "
          "int8 head; 4-layer f32 checks")
    phi3 = serve_phi3(dev)
    compare_phi3(dev)
    print(f"== 4b helix ranks (t = {time.perf_counter() - T0:.1f} s): B1 "
          "per rank == the emulated shard; helix_attention and granite-3-2b "
          "over 2 and 4 gloo ranks on the card (KVP 2, KVP 2 x TPA 2,"
          " HOP-B 1 and 2); NCCL at world 1")
    helix_ranks(dev)
    print(f"== 4c MoE ranks (t = {time.perf_counter() - T0:.1f} s): "
          f"{MOE} (24 layers) single-process baseline; {ARCTIC} "
          f"({ARCTIC_LAYERS} of 35 layers, full width) greedy w1, top-p w4, "
          "paged top-p w4, int8 greedy w4, 1-layer f32 checks; both over 2 "
          "and 4 gloo ranks on the card (KVP 2 x EP 2; KVP 2 x TPA 2, EP 2 x "
          "TPF 2), each rank drawing its own share")
    arctic = moe_ranks(dev)

    print(f"== 5 times (t = {time.perf_counter() - T0:.1f} s)")
    timed = times(dev)
    stamp("ssd_prefill times")
    timed["ssd_prefill"] = times_ssd(dev)
    timed["ssd_prefill"]["mamba2_prefill"] = mamba["prefill"]
    stamp("hymba kernel times")
    timed.update(times_hymba(dev))
    timed["flash_prefill_hymba"]["hymba_prefill"] = \
        hymba["prefill"]["flash_prefill"]
    timed["ssd_prefill_hymba"]["hymba_prefill"] = \
        hymba["prefill"]["ssd_prefill"]
    stamp("granite-moe kernel times")
    timed.update(times_moe(dev))
    timed["flash_prefill_moe"]["moe_prefill"] = moe["prefill"]
    timed["flash_decode_moe"]["moe_decode_step"] = moe["decode"]
    stamp("gemma3 kernel times")
    timed.update(times_gemma3(dev))
    timed["flash_prefill_gemma3"]["gemma3_prefill"] = gemma["prefill"]
    timed["flash_decode_gemma3"]["gemma3_decode_step"] = gemma["decode"]
    stamp("the dense models' kernel times")
    timed.update(times_dense(dev))
    for tag, run in (("sc2", sc2), ("llama", llama)):
        timed[f"flash_prefill_{tag}"][f"{tag}_prefill"] = run["prefill"]
        timed[f"flash_decode_{tag}"][f"{tag}_decode_step"] = run["decode"]
    stamp("arctic-480b kernel times")
    timed.update(times_arctic(dev))
    timed["flash_prefill_arctic"]["arctic_prefill"] = arctic["prefill"]
    timed["flash_decode_arctic"]["arctic_decode_step"] = arctic["decode"]
    stamp("whisper and phi-3-vision kernel times")
    timed.update(times_encdec_vlm(dev))
    timed["flash_decode_contiguous"]["whisper_decode_step"] = \
        whisper["profile"]
    timed["flash_decode_phi3"]["phi3_decode_step"] = phi3["profile"]

    # launches: each kernel's count in the run of the path it serves
    fp, int8 = runs["fp"][0]["counts"], runs["int8"][0]["counts"]
    pfp, pint8 = runs["paged fp"][0]["counts"], runs["paged int8"][0]["counts"]
    grp = runs["c + grouped_decode"]["counts"]
    launches = {"flash_decode": fp["flash_decode"],
                "flash_decode_kv8": int8["flash_decode_kv8"],
                "flash_decode_paged": pfp["flash_decode_paged"],
                "flash_decode_paged_kv8": pint8["flash_decode_paged"],
                "flash_decode_grouped": grp["flash_decode_grouped"],
                "prefix_pass": grp["prefix_pass"],
                "flash_prefill": fp["flash_prefill"],
                "flash_prefill_paged": paged_pre["flash_prefill_paged"],
                "flash_prefill_chunks":
                    runs["a paged chunked"]["counts"]["flash_prefill"],
                "w8a16_matmul": int8["w8a16_matmul"],
                "ssd_prefill": mamba["counts"]["ssd_prefill"]}
    hy = {name: run["counts"] for name, run in hymba["runs"].items()}
    launches.update({
        "flash_prefill_hymba": hy["greedy w1"]["flash_prefill"],
        "flash_decode_hymba": hy["greedy w1"]["flash_decode"],
        "flash_decode_hymba_kv8": hy["int8 greedy w4"]["flash_decode_kv8"],
        "flash_decode_hymba_paged":
            hy["paged top-p w4"]["flash_decode_paged"],
        "ssd_prefill_hymba": hy["greedy w1"]["ssd_prefill"],
        "w8a16_matmul_hymba": hy["int8 greedy w4"]["w8a16_matmul"]})
    mo = {name: run["counts"] for name, run in moe["runs"].items()}
    launches.update({
        "flash_prefill_moe": mo["greedy w1"]["flash_prefill"],
        "flash_decode_moe": mo["greedy w1"]["flash_decode"],
        "w8a16_matmul_moe": mo["int8 greedy w4"]["w8a16_matmul"]})
    ge = {name: run["counts"] for name, run in gemma["runs"].items()}
    launches.update({
        "flash_prefill_gemma3": ge["greedy w1"]["flash_prefill"],
        "flash_decode_gemma3": ge["greedy w1"]["flash_decode"],
        "flash_decode_gemma3_kv8": ge["int8 greedy w4"]["flash_decode_kv8"],
        "flash_decode_gemma3_paged":
            ge["paged top-p w4"]["flash_decode_paged"],
        "prefix_pass_gemma3":
            gemma["shared"]["c + grouped_decode"]["counts"]["prefix_pass"],
        "w8a16_matmul_gemma3": ge["int8 greedy w4"]["w8a16_matmul"]})
    for tag, run in (("sc2", sc2), ("llama", llama)):
        rc = {name: r["counts"] for name, r in run["runs"].items()}
        launches.update({
            f"flash_prefill_{tag}": rc["greedy w1"]["flash_prefill"],
            f"flash_decode_{tag}": rc["greedy w1"]["flash_decode"],
            f"flash_decode_{tag}_kv8":
                rc["int8 greedy w4"]["flash_decode_kv8"],
            f"flash_decode_{tag}_paged":
                rc["paged top-p w4"]["flash_decode_paged"],
            f"w8a16_matmul_{tag}": rc["int8 greedy w4"]["w8a16_matmul"]})
    launches["prefix_pass_llama"] = \
        llama["shared"]["c + grouped_decode"]["counts"]["prefix_pass"]
    wh = {name: r["counts"] for name, r in whisper["runs"].items()}
    ph = {name: r["counts"] for name, r in phi3["runs"].items()}
    launches.update({
        "flash_prefill_noncausal": wh["fp w1"]["flash_prefill_noncausal"]
        - wh["fp w1"]["flash_prefill_cross"],
        "flash_prefill_cross": wh["fp w1"]["flash_prefill_cross"],
        "flash_decode_contiguous": wh["fp w1"]["flash_decode_contiguous"],
        "w8a16_matmul_whisper": wh["int8 head w1"]["w8a16_matmul"],
        "flash_prefill_phi3": ph["fp w1"]["flash_prefill"],
        "flash_decode_phi3": ph["fp w1"]["flash_decode"],
        "flash_decode_phi3_kv8": ph["int8 KV w1"]["flash_decode_kv8"],
        "flash_decode_phi3_paged": ph["paged fp w4"]["flash_decode_paged"],
        "w8a16_matmul_phi3": ph["int8 head w1"]["w8a16_matmul"]})
    ar = {name: r["counts"] for name, r in arctic["runs"].items()}
    launches.update({
        "flash_prefill_arctic": ar["greedy w1"]["flash_prefill"],
        "flash_decode_arctic": ar["greedy w1"]["flash_decode"],
        "flash_decode_arctic_kv8": ar["int8 greedy w4"]["flash_decode_kv8"],
        "flash_decode_arctic_paged":
            ar["paged top-p w4"]["flash_decode_paged"],
        "w8a16_matmul_arctic": ar["int8 greedy w4"]["w8a16_matmul"]})
    decode_src = ("src/repro_torch/csrc/flash_decode.cu",
                  "src/repro/kernels/flash_decode/kernel.py:417")
    prefill_src = ("src/repro_torch/csrc/flash_prefill.cu",
                   "src/repro/kernels/flash_prefill/kernel.py:205")
    ssd_src = ("src/repro_torch/csrc/ssd_prefill.cu",
               "src/repro/kernels/ssd_prefill/kernel.py:97")
    mm_src = ("src/repro_torch/csrc/w8a16_matmul.cu",
              "src/repro/kernels/w8a16_matmul/kernel.py:63")
    sources = {"flash_decode": decode_src, "flash_decode_kv8": decode_src,
               "flash_decode_paged": decode_src,
               "flash_decode_paged_kv8": decode_src,
               "flash_decode_grouped": decode_src,
               "prefix_pass": ("src/repro_torch/csrc/prefix_pass.cu",
                               "src/repro/kernels/flash_decode/kernel.py:702"),
               "flash_prefill": prefill_src, "flash_prefill_paged": prefill_src,
               "flash_prefill_chunks": prefill_src,
               "w8a16_matmul": mm_src, "ssd_prefill": ssd_src,
               "flash_prefill_hymba": prefill_src,
               "flash_decode_hymba": decode_src,
               "flash_decode_hymba_kv8": decode_src,
               "flash_decode_hymba_paged": decode_src,
               "ssd_prefill_hymba": ssd_src, "w8a16_matmul_hymba": mm_src,
               "flash_prefill_moe": prefill_src,
               "flash_decode_moe": decode_src, "w8a16_matmul_moe": mm_src,
               "flash_prefill_gemma3": prefill_src,
               "flash_decode_gemma3": decode_src,
               "flash_decode_gemma3_kv8": decode_src,
               "flash_decode_gemma3_paged": decode_src,
               "prefix_pass_gemma3": ("src/repro_torch/csrc/prefix_pass.cu",
                                      "src/repro/kernels/flash_decode/"
                                      "kernel.py:702"),
               "w8a16_matmul_gemma3": mm_src,
               "prefix_pass_llama": ("src/repro_torch/csrc/prefix_pass.cu",
                                     "src/repro/kernels/flash_decode/"
                                     "kernel.py:702")}
    sources.update({"flash_prefill_noncausal": prefill_src,
                    "flash_prefill_cross": prefill_src,
                    "flash_decode_contiguous": decode_src,
                    "w8a16_matmul_whisper": mm_src,
                    "flash_prefill_phi3": prefill_src,
                    "flash_decode_phi3": decode_src,
                    "flash_decode_phi3_kv8": decode_src,
                    "flash_decode_phi3_paged": decode_src,
                    "w8a16_matmul_phi3": mm_src})
    for tag in ("sc2", "llama", "arctic"):
        sources.update({f"flash_prefill_{tag}": prefill_src,
                        f"flash_decode_{tag}": decode_src,
                        f"flash_decode_{tag}_kv8": decode_src,
                        f"flash_decode_{tag}_paged": decode_src,
                        f"w8a16_matmul_{tag}": mm_src})
    records = []
    for name, (src, replaces) in sources.items():
        need(launches[name] > 0, f"{name}: no launch on its main path")
        err = max(errs[{"prefix_pass": "flash_decode_grouped",
                        "flash_prefill_chunks": "flash_prefill"}.get(name,
                                                                     name)])
        records.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, **timed[name]})
    print(f"  done at t = {time.perf_counter() - T0:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
