"""Helix decode step (port of the reference's ``models/decode_model.py``,
dense attention layers, pure-SSM layers, hybrid layers, MoE FFNs and the
enc-dec cross-attention).

``build_serve_step(cfg, hx)`` returns

    serve_step(model, state, tokens) -> (next_tokens, new_state)

one autoregressive step: per layer QKV + RoPE, the KV append fused into the
flash_decode kernel (or a separate ``append_kv`` on the ``ref`` backend),
Helix attention over the emulated KVP ranks with the LSE combine, the
out-projection and the gated FFN; then the lm_head (``embed.T`` when
tied), the vocab pad mask and a greedy argmax.  The layer scan of the
reference is a Python loop.  The KV caches in ``state`` are updated **in
place**; the returned state shares them.

``hx.kv_cache_bits == 8``: the caches are int8 with per-slot f32 scales
(``kscale``/``vscale`` in ``state``); the new row is quantized inside the
decode kernel (fused) or by ``append_kv_quant``.  ``hx.lm_head_w8``: the
logits go through the ``w8a16_matmul`` family over the int8 head that
``prepare_decode_params`` makes once.  ``hx.paged_kv``: the caches are pool
planes and ``state["block_tables"]`` [B, max_pages] reaches every layer's
attention and append; the step passes it through unchanged (the engine owns
page allocation).  ``hx.grouped_decode`` (paged): the state's ``group_id``/
``group_np`` [B] leaves, which the engine refreshes every step, reach every
layer's attention (grouped shared-prefix decode).

Pure-SSM archs (mamba2): each layer runs ``ssm.ssm_decode_step`` (plain
PyTorch; the reference has no kernel there) on the state's ``ssm_conv``/
``ssm_state`` leaves, updated in place; archs without RoPE add the
sinusoidal embedding of position ``total_len`` to the token's.  The SSM
recurrence has no length mask: idle rows evolve on junk until the engine's
next scatter overwrites them, as in the reference.

Hybrid archs (hymba): each layer runs the attention phase and the SSM
phase on the same normed ``h`` and adds ``0.5 * (a_out + s_out)``, as the
reference's decode step does; the state carries the KV leaves and the SSM
leaves together.

Windowed archs (gemma3): layer i's attention takes the static window
``transformer.layer_windows(cfg)[i]`` (the reference scans over
local:global periods for the same effect), and the logits pass the
config's softcap before the vocab mask, so the argmax and the sampler see
capped logits.

MoE archs: each layer's FFN phase adds the dense FFN's delta (when the
config has a ``d_ff``) and the MoE's, routed over all B rows of the step,
idle rows included, as one group at ``moe.decode_capacity_factor``.  With
distinct top-k experts per row and that factor of 4, ``cap = int(4 *
ceil(B * k / E) + 0.5) >= B`` slots per expert at every B, so no
assignment is dropped and no row's output depends on another row's.

Enc-dec archs (whisper): the state also holds the static cross K/V
``xk``/``xv`` [L, B, Kh, S_enc_pad, hsz] and ``enc_len`` from
``make_prefill_step``; after its self-attention each layer cross-attends
over them with ``helix_attention(..., contiguous=True)`` (the encoder's
frames split into kvp contiguous shards; q not rotated, no append), and
every step passes them on unchanged.  Archs without RoPE rotate nothing.

Token decision: the argmax, or, when the state holds the sampler's leaves
(``core/kvcache.sampling_leaf_shapes``), ``serving/sampling.sample_tokens``
with each row's policy; ``serve_step`` then advances ``sample_idx`` by one.

Across ranks (``build_serve_step(cfg, hx, group=, hopb_chunks=)``, dense
and MoE archs, fixed fp caches, fused append): ``model`` is the rank's
``models/shard.shard_model`` share and ``state`` its local caches ``[L, B,
Kh/tpa, S_cap/kvp, hsz]``.  Each layer projects QKV on the rank's heads,
rotates, runs ``helix_attention(group=)`` (the fused append on the owner
rank, one all-to-all and one LSE all-gather, HOP-B over ``hopb_chunks``),
multiplies its flat slice by its ``wo`` rows and all-reduces, then the TP
FFN (an MoE's: its experts' partial sum over EP x TPF, plus its dense
residual's TP partial) and a second all-reduce; the head's vocab columns
are all-gathered, so
every rank holds the same logits and takes the same greedy token.

``build_serve_multistep(cfg, hx, window=N)`` runs N steps of the same core
in one call with per-row budgets, EOS and forced tokens carried as masks
(the reference's ``lax.scan`` window, a Python loop here): on the card the
engine replays it as one CUDA graph (``serving/graph.py``), so the host
syncs once per window.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.helix import (append_kv, append_kv_quant,
                                    fuse_append_applicable, helix_attention)
from repro_torch.core.sharding import (HelixConfig, check_ranks,
                                       local_config)
from repro_torch.kernels.w8a16_matmul import (quantize_w8, w8a16_matmul,
                                              w8a16_matmul_ref)
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, rms_norm, sinusoidal_at,
                                       softcap)
from repro_torch.models.transformer import (ffn_delta, head_weight,
                                            layer_windows,
                                            mix_block_outputs, vocab_mask)


HEAD_BLOCK = 32768      # head columns quantized at a time


def quantize_lm_head(model):
    """Quantize the head [d, Vp] per column (``lm_head`` when the model has
    one, else the tied ``embed.T``) into the model's ``lm_head_q8``/
    ``lm_head_scale`` buffers (in place).  Columns go ``HEAD_BLOCK`` at a
    time, so the f32 temporaries stay ~``d * HEAD_BLOCK * 4`` bytes
    (gemma3's head is 1.0 B elements); each column's scale and payload are
    those of one ``quantize_w8`` over the whole head."""
    w = head_weight(model)
    qw = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[1], dtype=torch.float32, device=w.device)
    for c in range(0, w.shape[1], HEAD_BLOCK):
        cols = slice(c, c + HEAD_BLOCK)
        qw[:, cols], scale[cols] = quantize_w8(w[:, cols])
    model.lm_head_q8, model.lm_head_scale = qw, scale
    return model


def prepare_decode_params(model, hx: HelixConfig | None):
    """One-time decode preparation every ``serve_step`` caller runs before
    stepping: with ``hx.lm_head_w8`` it quantizes the head unless the model
    already carries it (idempotent); otherwise nothing."""
    if hx is not None and hx.lm_head_w8 and model.lm_head_q8 is None:
        quantize_lm_head(model)
    return model


def head_matmul(hx: HelixConfig, model, x):
    """Logits matmul ``x @ head`` (``lm_head``, or ``embed.T`` when tied);
    with ``hx.lm_head_w8`` through the ``w8a16_matmul`` family
    (``hx.matmul_backend``) over the prepared int8 head, or over a head
    quantized in the step when it was not prepared."""
    if not hx.lm_head_w8:
        return x @ head_weight(model)
    qw, scale = model.lm_head_q8, model.lm_head_scale
    if qw is None:
        qw, scale = quantize_w8(head_weight(model))
    fn = w8a16_matmul if hx.matmul_backend == "cuda" else w8a16_matmul_ref
    return fn(x, qw, scale)


def _next_token(logits, state):
    """The decode epilogue's token decision: the sampler over the state's
    per-row ``sample_*`` leaves when the state carries them (greedy rows
    give the argmax there too), else the plain argmax."""
    if "sample_seed" in state:
        # imported here: the serving package imports this module
        from repro_torch.serving.sampling import sample_tokens
        return sample_tokens(logits, state["sample_temp"],
                             state["sample_topk"], state["sample_topp"],
                             state["sample_seed"], state["sample_idx"])
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _build_step_logits(cfg: ArchConfig, hx: HelixConfig, group=None,
                       hopb_chunks: int = 1):
    """``step_logits(model, state, tokens, advance=None) -> logits [B, Vp]``
    (caches in ``state`` appended in place; SSM leaves updated in place, and
    with ``advance`` [B] bool only on its rows: the others keep theirs, as
    the reference's window holds a frozen row).  With ``group`` one rank's
    step (module doc): attention on ``local_config``'s heads through
    ``helix_attention(group=)``, HOP-B over ``hopb_chunks``, the
    out-projection's and the FFN's partial sums all-reduced, the head's
    vocab columns all-gathered."""
    kv8 = hx.kv_cache_bits == 8
    decode_cf = cfg.moe.decode_capacity_factor if cfg.moe else None
    fused = fuse_append_applicable(hx, quant=kv8, paged=hx.paged_kv)
    acfg, reduce = cfg, (lambda y: y)       # the attention's heads, the TP sum
    if group is not None:
        check_rank_step(cfg, hx)
        acfg, reduce = local_config(cfg, hx.tpa), group.all_reduce

    windows = layer_windows(cfg)

    def attn_phase(ap, h, kc, vc, ks, vs, tl_attn, tables, groups, window):
        b = h.shape[0]
        q = (h @ ap.wq).reshape(b, acfg.n_heads, acfg.hsz)
        kn = (h @ ap.wk).reshape(b, acfg.n_kv_heads, acfg.hsz)
        vn = (h @ ap.wv).reshape(b, acfg.n_kv_heads, acfg.hsz)
        if cfg.use_rope:
            pos = (tl_attn - 1)[:, None]                      # [B, 1]
            q = apply_rope(q[:, None], pos, cfg.rope_theta)[:, 0]
            kn = apply_rope(kn[:, None], pos, cfg.rope_theta)[:, 0]
        if fused:
            out = helix_attention(hx, q, kc, vc, tl_attn, window=window,
                                  kscale=ks, vscale=vs, k_new=kn, v_new=vn,
                                  block_tables=tables, groups=groups,
                                  group=group, hopb_chunks=hopb_chunks)
        else:
            if kv8:
                append_kv_quant(kc, vc, ks, vs, kn, vn, tl_attn, kvp=hx.kvp,
                                rr_block=hx.rr_block, block_tables=tables)
            else:
                append_kv(kc, vc, kn, vn, tl_attn, kvp=hx.kvp,
                          rr_block=hx.rr_block, block_tables=tables)
            out = helix_attention(hx, q, kc, vc, tl_attn, window=window,
                                  kscale=ks, vscale=vs, block_tables=tables,
                                  groups=groups)
        return reduce(out_proj(out, ap.wo))

    def out_proj(out, wo):
        """The post-attention projection; wo's rows padded to the padded
        all-to-all width (the pad lanes of ``out`` are zeros; a rank's
        ``wo`` rows are its slice's, padded already)."""
        if out.shape[-1] != wo.shape[0]:
            wo = torch.nn.functional.pad(
                wo, (0, 0, 0, out.shape[-1] - wo.shape[0]))
        return out @ wo

    def cross_phase(ap, h, xk, xv, enc_len):
        """Cross-attention over the static encoder K/V [B, Kh, S_enc_pad,
        hsz] in the contiguous layout, ``enc_len`` frames valid."""
        q = (h @ ap.wq).reshape(h.shape[0], cfg.n_heads, cfg.hsz)
        return out_proj(helix_attention(hx, q, xk, xv, enc_len,
                                        contiguous=True), ap.wo)

    def ssm_phase(sp, h, state, i, advance):
        conv, ssm = state["ssm_conv"][i], state["ssm_state"][i]
        y, new = ssm_lib.ssm_decode_step(sp, cfg, h,
                                         ssm_lib.SSMState(conv, ssm))
        if advance is None:
            new_conv, new_ssm = new.conv, new.ssm
        else:
            new_conv = torch.where(advance[:, None, None], new.conv, conv)
            new_ssm = torch.where(advance[:, None, None, None], new.ssm, ssm)
        state["ssm_conv"][i] = new_conv
        state["ssm_state"][i] = new_ssm
        return y

    @torch.no_grad()
    def step_logits(model, state, tokens, advance=None):
        tl = state["total_len"]
        tl_attn = (tl + 1).reshape(-1).expand(tokens.shape[0])  # incl. new token
        tables = state["block_tables"] if hx.paged_kv else None
        groups = None
        if hx.grouped_decode and hx.paged_kv and "group_id" in state:
            groups = (state["group_id"], state["group_np"])
        x = model.embed[tokens]
        if not cfg.use_rope:
            x = x + sinusoidal_at(tl.reshape(-1), cfg.d_model).to(x.dtype)
        a_out = s_out = None        # the output a layer lacks
        for i, lp in enumerate(model.layers):
            h = rms_norm(x, lp.ln1)
            if cfg.has_attention:
                ks = state["kscale"][i] if kv8 else None
                vs = state["vscale"][i] if kv8 else None
                a_out = attn_phase(lp.attn, h, state["kcache"][i],
                                   state["vcache"][i], ks, vs, tl_attn,
                                   tables, groups, windows[i])
            if cfg.has_ssm:
                s_out = ssm_phase(lp.ssm, h, state, i, advance)
            x = x + mix_block_outputs(cfg, a_out, s_out)
            if cfg.is_encdec:
                x = x + cross_phase(lp.xattn, rms_norm(x, lp.lnx),
                                    state["xk"][i], state["xv"][i],
                                    state["enc_len"])
            if cfg.d_ff or cfg.moe:
                x = x + reduce(ffn_delta(cfg, lp, rms_norm(x, lp.ln2),
                                         capacity_factor=decode_cf)[0])
        x = rms_norm(x, model.ln_f)
        logits = head_matmul(hx, model, x)
        if group is not None:
            logits = group.all_gather_cols(logits)[:, :cfg.padded_vocab]
        return (softcap(logits, cfg.softcap)
                + vocab_mask(cfg, x.dtype, x.device))

    return step_logits


def check_rank_step(cfg: ArchConfig, hx: HelixConfig) -> None:
    """Raise ``ValueError`` for a ``HelixConfig`` the multi-rank decode
    step does not take (``check_ranks``'s refusals, and all but the fixed
    fp caches with the fused append)."""
    check_ranks(cfg, hx)
    if hx.kv_cache_bits != 16 or hx.paged_kv or hx.lm_head_w8:
        raise ValueError("across ranks the decode step takes the fixed fp "
                         "KV cache and the fp head (int8 and paged are not "
                         "ported)")
    if not fuse_append_applicable(hx):
        raise ValueError("across ranks the decode step fuses the KV append "
                         "(attn_backend 'cuda', fuse_append)")


def build_serve_step(cfg: ArchConfig, hx: HelixConfig, *,
                     return_logits: bool = False, group=None,
                     hopb_chunks: int = 1):
    """Build one autoregressive Helix decode step for ``cfg`` (state from
    ``make_prefill_step`` or ``core/kvcache.init_decode_state``); with
    ``group`` one rank's step (module doc), HOP-B over ``hopb_chunks``."""
    step_logits = _build_step_logits(cfg, hx, group, hopb_chunks)

    def serve_step(model, state, tokens):
        """tokens [B] int32 -> (next_tokens [B] int32, new state)."""
        logits = step_logits(model, state, tokens)
        next_tokens = _next_token(logits, state)
        new_state = dict(state)
        new_state["total_len"] = state["total_len"] + 1
        if "sample_idx" in state:
            new_state["sample_idx"] = state["sample_idx"] + 1
        if return_logits:
            return (next_tokens, logits), new_state
        return next_tokens, new_state

    return serve_step


def build_serve_multistep(cfg: ArchConfig, hx: HelixConfig, *, window: int):
    """Build the windowed decode loop: ``window`` steps (sample, append,
    next step) in one call, the host intervening once per window.

    Returns ``serve_multistep(model, state, tokens, budgets, eos_ids,
    forced, n_forced) -> (out_block [B, window], cur [B], new_state)``, all
    per-row control carried as tensors (the reference's contract):

      * ``budgets`` [B] int32: steps the row may take (its grant from
        ``Scheduler.grow_for_window``; 0 freezes it for the whole window);
      * ``eos_ids`` [B] int32 (< 0: none): a row that emits its EOS freezes
        for the rest of the window;
      * ``forced`` [B, window] and ``n_forced`` [B] int32: tokens fed instead
        of the sampled one for the first ``n_forced`` active steps; they use
        budget, emit the pad and do not advance ``sample_idx``.

    A frozen row stops advancing: ``total_len`` and its SSM leaves hold (its
    K/V append rewrites the same slot), and its ``out_block`` entries are
    the pad ``-1``.  ``out_block[b, j]`` is the token row b emitted at step
    j (EOS included); ``total_len`` advances by the active mask and
    ``sample_idx`` by the emitting one.  ``total_len`` must be [B].  Rows
    that froze mid-window are retired by the caller at the boundary, which
    keeps the streams equal to ``window`` single steps.  Caches and SSM
    leaves are updated in place, so the returned state shares them; the
    other leaves of the result are new tensors."""
    if window < 1:
        raise ValueError(f"window must be >= 1 (got {window})")
    if hx.grouped_decode:
        raise ValueError("serve_multistep is incompatible with "
                         "grouped_decode: group_id/group_np are recomputed "
                         "by the host every token and would go stale inside "
                         "a multi-token window")
    step_logits = _build_step_logits(cfg, hx)

    @torch.no_grad()
    def serve_multistep(model, state, tokens, budgets, eos_ids, forced,
                        n_forced):
        b = tokens.shape[0]
        sampling = "sample_seed" in state
        st = dict(state)
        cur = tokens
        fpos = torch.zeros_like(n_forced)
        eos_seen = torch.zeros(b, dtype=torch.bool, device=tokens.device)
        outs = []
        for j in range(window):
            active = (budgets > j) & ~eos_seen
            logits = step_logits(model, st, cur,
                                 advance=active if cfg.has_ssm else None)
            sampled = _next_token(logits, st)
            is_forced = fpos < n_forced
            fvals = torch.gather(
                forced, 1,
                torch.clamp(fpos, max=forced.shape[1] - 1).long()[:, None])[:, 0]
            emit = active & ~is_forced
            outs.append(torch.where(emit, sampled, -1))
            st["total_len"] = st["total_len"] + active.to(torch.int32)
            if sampling:
                st["sample_idx"] = st["sample_idx"] + emit.to(torch.int32)
            eos_hit = emit & (eos_ids >= 0) & (sampled == eos_ids)
            nxt = torch.where(is_forced, fvals, sampled)
            cur = torch.where(active, nxt, cur)
            fpos = fpos + (active & is_forced).to(torch.int32)
            eos_seen = eos_seen | eos_hit
        return torch.stack(outs, dim=1), cur, st

    return serve_multistep
