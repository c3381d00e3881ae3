"""Dense GQA, pure-SSM, hybrid, mixture-of-experts, encoder-decoder and
vision-language decoders: parameters, seeded init and the prefill forward
(port of the reference's ``models/transformer.py``: its dense (global or
local:global windowed), pure-SSM, hybrid, MoE, enc-dec and vlm paths).

Parameter names and shapes follow the reference's pytree, with the stacked
``layers`` leaves split per layer: ``embed [Vp, d]``, ``ln_f [d]``,
``layers.{i}.ln1``, ``layers.{i}.attn.{wq [d, Qh*hsz], wk, wv [d, Kh*hsz],
wo [Qh*hsz, d]}``, ``layers.{i}.ln2``, ``layers.{i}.ffn.{w1, w3 [d, f],
w2 [f, d]}`` (no ``w3`` in an ungated ``gelu`` FFN); an SSM layer holds
``ln1`` and ``layers.{i}.ssm.*`` (``models/ssm.SSMParams``) and no
``ln2``/``ffn`` (``d_ff = 0``); a hybrid layer holds ``attn`` and ``ssm``
together, both fed the same normed input, and adds ``0.5 * (a_out +
s_out)``; an MoE layer holds ``ln2`` and ``layers.{i}.moe.{router [d, E],
w1, w3 [E, d, Fe], w2 [E, Fe, d]}`` (``models/moe.MoEParams``), beside
``ffn`` when the config also has a ``d_ff``.  Projections are ``x @ w``.
Tied models take their logits from ``embed.T``; untied ones hold
``lm_head [d, Vp]``; a config's ``softcap`` caps them before the vocab
mask.  Windowed archs (gemma3) attend over ``layer_windows(cfg)[i]``
positions in layer i (0: global).  The int8 lm_head of the decode step
(``decode_model.prepare_decode_params``) is held in the buffers
``lm_head_q8`` [d, Vp] int8 and ``lm_head_scale`` [Vp] f32, ``None`` until
prepared.

Encoder-decoder archs (whisper) add ``enc.layers.{i}`` (``enc_layers``
layers of ``ln1``, ``attn``, ``ln2``, ``ffn``, no cross-attention) and
``enc.ln_f``, and give every decoder layer ``lnx`` and ``xattn.{wq, wk,
wv, wo}`` (cross-attention over the encoder's output, after the
self-attention and before the FFN); they have no RoPE: the encoder adds
sinusoidal positions to its frames, the decoder to its token embeddings.
Vlm archs (phi-3-vision) take ``patch_embeds`` [B, P, d] that replace the
first P token embeddings (``models/encdec.py`` holds the encoder).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.core.helix import helix_out_dim
from repro_torch.core.sharding import local_config
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import prefill_attention
from repro_torch.models.layers import (activation, apply_rope, rms_norm,
                                       sinusoidal_at, sinusoidal_positions,
                                       softcap)


def _param(*shape):
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class Attention(nn.Module):
    def __init__(self, cfg: ArchConfig):
        super().__init__()
        d = cfg.d_model
        self.wq = _param(d, cfg.q_dim)
        self.wk = _param(d, cfg.kv_dim)
        self.wv = _param(d, cfg.kv_dim)
        self.wo = _param(cfg.q_dim, d)


class FFN(nn.Module):
    """``w1``, ``w2`` and, for the gated activations, ``w3`` (the reference's
    ``_init_ffn``: an ungated ``gelu`` FFN has no ``w3``)."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.w1 = _param(cfg.d_model, cfg.d_ff)
        self.w2 = _param(cfg.d_ff, cfg.d_model)
        if cfg.act != "gelu":
            self.w3 = _param(cfg.d_model, cfg.d_ff)


class DecoderLayer(nn.Module):
    """The reference's ``_init_layer`` structure: ``ln1``, then ``attn``
    and/or ``ssm``, then ``lnx`` and ``xattn`` with ``with_cross`` (the
    decoder layers of an enc-dec arch), then ``ln2`` when ``d_ff`` or
    ``moe``, ``ffn`` when ``d_ff`` and ``moe`` when ``moe``."""

    def __init__(self, cfg: ArchConfig, with_cross: bool = False):
        super().__init__()
        self.ln1 = _param(cfg.d_model)
        if cfg.has_attention:
            self.attn = Attention(cfg)
        if cfg.has_ssm:
            self.ssm = ssm_lib.SSMParams(cfg)
        if with_cross:
            self.lnx = _param(cfg.d_model)
            self.xattn = Attention(cfg)
        if cfg.d_ff or cfg.moe:
            self.ln2 = _param(cfg.d_model)
        if cfg.d_ff:
            self.ffn = FFN(cfg)
        if cfg.moe:
            self.moe = moe_lib.MoEParams(cfg.moe, cfg.d_model)


class Encoder(nn.Module):
    """An enc-dec arch's encoder: ``enc_layers`` layers without
    cross-attention and the final norm ``ln_f``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        self.layers = nn.ModuleList(DecoderLayer(cfg)
                                    for _ in range(cfg.enc_layers))
        self.ln_f = _param(cfg.d_model)


FAMILIES = ("dense", "ssm", "hybrid", "moe", "audio", "vlm")


class Transformer(nn.Module):
    """Parameter container of a dense, pure-SSM, hybrid, MoE, enc-dec or
    vlm decoder; the forward passes are the functions ``forward``
    (prefill) and ``decode_model.build_serve_step``."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"the port serves the {', '.join(FAMILIES)} "
                             f"families ({cfg.name} is {cfg.family})")
        self.cfg = cfg
        self.embed = _param(cfg.padded_vocab, cfg.d_model)
        self.ln_f = _param(cfg.d_model)
        self.layers = nn.ModuleList(DecoderLayer(cfg, cfg.is_encdec)
                                    for _ in range(cfg.n_layers))
        if not cfg.tie_embeddings:
            self.lm_head = _param(cfg.d_model, cfg.padded_vocab)
        if cfg.is_encdec:
            self.enc = Encoder(cfg)
        self.register_buffer("lm_head_q8", None)
        self.register_buffer("lm_head_scale", None)


def cast_params(model: Transformer, *, device, dtype=None) -> Transformer:
    """``model.to(device, dtype)``, except that the leaves the reference
    keeps in f32 in any model stay f32: the SSM's (``ssm.F32_LEAVES``:
    A_log, D, dt_bias; in bf16 every decay would change) and the MoE
    router (``moe.F32_LEAVES``; routing in bf16 would flip near-ties).
    A model built on the meta device gets uninitialized leaves of those
    types on ``device``, with no f32 copy of the whole model on the way
    (gemma3-12b's would be 47 GB)."""
    keep_f32 = ssm_lib.F32_LEAVES + moe_lib.F32_LEAVES
    if any(p.is_meta for p in model.parameters()):
        for mod in model.modules():
            for name, p in mod._parameters.items():
                dt = (p.dtype if dtype is None or name in keep_f32
                      else dtype)
                mod._parameters[name] = nn.Parameter(
                    torch.empty(p.shape, dtype=dt, device=device),
                    requires_grad=False)
        return model
    model = model.to(device=device)
    if dtype is not None:
        for name, p in model.named_parameters():
            keep = name.rsplit(".", 1)[-1] in keep_f32
            p.data = p.data.to(torch.float32 if keep else dtype)
    return model


@torch.no_grad()
def init_params(cfg: ArchConfig, seed: int = 0, *, dtype=torch.float32,
                device="cuda") -> Transformer:
    """Seeded random weights made on ``device`` with a ``torch.Generator``:
    the reference's distributions (normal, fan-in scaled, the untied
    ``lm_head`` too; out-projections scaled down by sqrt(2L), L the
    decoder's layers, in the encoder too; embeddings 0.02; norm gains 0;
    SSM leaves by ``ssm.init_ssm``, MoE leaves by ``moe.init_moe``, each
    expert from its own stream keyed by ``seed`` and the layer), not its
    values (``jax.random`` streams differ; ``convert.params_from_jax``
    carries reference weights over exactly).  ``models/shard
    .init_rank_params`` draws one rank's share of the same weights."""
    with torch.device("meta"):
        model = Transformer(cfg)
    model = cast_params(model, device=device, dtype=dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if ".ssm." not in name and ".moe." not in name:
            p.copy_(draw_leaf(cfg, name, p.shape, gen))
    for i, lp in enumerate(model.layers):
        if cfg.has_ssm:
            ssm_lib.init_ssm(lp.ssm, cfg, gen)
        if cfg.moe:
            moe_lib.init_moe(lp.moe, cfg.moe, cfg.d_model, seed, layer=i)
    return model


def draw_leaf(cfg: ArchConfig, name: str, shape, gen):
    """``init_params``' f32 draw of the leaf ``name`` (a
    ``named_parameters`` name, not an SSM or MoE leaf) from ``gen``, on
    its device: zeros for a norm gain (no draw), else a normal draw
    scaled as the module doc says.  The leaves draw in
    ``named_parameters`` order, one after the other from one stream."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf.startswith("ln"):
        return torch.zeros(shape, device=gen.device)
    if name == "embed":
        std = 0.02
    else:
        depth = 1.0 / math.sqrt(2 * cfg.n_layers)
        std = shape[0] ** -0.5 * (depth if leaf in ("wo", "w2") else 1.0)
    return torch.randn(shape, generator=gen, device=gen.device).mul_(std)


def vocab_mask(cfg: ArchConfig, dtype, device):
    """0 on real vocab rows, -1e30 on the padding rows."""
    ids = torch.arange(cfg.padded_vocab, device=device)
    return torch.where(ids < cfg.vocab, 0.0, -1e30).to(dtype)


def layer_windows(cfg: ArchConfig) -> list[int]:
    """Per-layer sliding-window sizes (0 = global attention): with
    ``local_window`` and ``local_ratio`` set, layer i is local unless
    ``(i + 1) % (local_ratio + 1) == 0`` (5 local then 1 global)."""
    if not (cfg.local_window and cfg.local_ratio):
        return [0] * cfg.n_layers
    period = cfg.local_ratio + 1
    return [0 if (i + 1) % period == 0 else cfg.local_window
            for i in range(cfg.n_layers)]


def _attn_block(cfg: ArchConfig, ap: Attention, h, *, q_offset,
                backend: str, kv_buffer=None, window: int = 0,
                causal: bool = True, kv_override=None, group=None):
    """Projections, RoPE (archs with ``use_rope``), attention and
    out-projection of one layer (``window`` > 0: sliding-window attention
    over that many positions; ``causal=False``: every query sees every
    key).  ``q_offset`` is an int or a [B] tensor: the global position of
    each row's first token.  ``kv_buffer`` (chunked prefill): a pair of
    carry buffers ``[B, S_buf, Kh, hsz]`` holding the K/V of positions
    ``[0, q_offset)``; the chunk's rows are written into them **in place**
    at ``[q_offset, q_offset + T)`` per row and attention runs over the
    whole buffer (causal masking hides its unfilled tail).
    ``kv_override`` (cross-attention): the (K, V) ``[B, S, Kh, hsz]`` to
    attend over; only q is projected, and not rotated.  ``group`` (a
    ``core/dist.HelixGroup``; ``cfg`` then holds one TPA group's heads,
    ``core/sharding.local_config``): one rank's block over its
    ``models/shard.shard_model`` share, its flat slice ``[k*sl, (k+1)*sl)``
    of the output (padded to ``helix_out_dim``) times its ``wo`` rows,
    all-reduced over the ranks.  Returns the layer output and the (K, V)
    the attention read."""
    b, t, _ = h.shape
    q = (h @ ap.wq).reshape(b, t, cfg.n_heads, cfg.hsz)
    if kv_override is not None:
        k, v = kv_override
    else:
        k = (h @ ap.wk).reshape(b, t, cfg.n_kv_heads, cfg.hsz)
        v = (h @ ap.wv).reshape(b, t, cfg.n_kv_heads, cfg.hsz)
        off = torch.as_tensor(q_offset, dtype=torch.int64, device=h.device)
        pos = torch.arange(t, device=h.device)[None, :] + off.reshape(-1, 1)
        if cfg.use_rope:
            q = apply_rope(q, pos, cfg.rope_theta)
            k = apply_rope(k, pos, cfg.rope_theta)
        if kv_buffer is not None:
            kbuf, vbuf = kv_buffer
            rows = torch.arange(b, device=h.device)[:, None]
            kbuf[rows, pos.expand(b, t)] = k.to(kbuf.dtype)
            vbuf[rows, pos.expand(b, t)] = v.to(vbuf.dtype)
            k, v = kbuf, vbuf
    out = prefill_attention(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, backend=backend)
    out = out.reshape(b, t, cfg.q_dim)
    if group is None:
        return out @ ap.wo, (k, v)
    sl = helix_out_dim(cfg.q_dim, group.kvp) // group.kvp
    out = torch.nn.functional.pad(out, (0, sl * group.kvp - cfg.q_dim))
    out = out[..., group.k * sl:(group.k + 1) * sl]
    return group.all_reduce(out @ ap.wo), (k, v)


def cross_attn_block(cfg: ArchConfig, lp: DecoderLayer, x, enc_out, *,
                     backend: str):
    """A decoder layer's cross-attention update from ``x`` [B, T, d] over
    the encoder's output ``enc_out`` [B, S_enc, d]: its K/V projected by
    ``xattn``, attention non-causal (T != S_enc in general)."""
    b, s = enc_out.shape[:2]
    kx = (enc_out @ lp.xattn.wk).reshape(b, s, cfg.n_kv_heads, cfg.hsz)
    vx = (enc_out @ lp.xattn.wv).reshape(b, s, cfg.n_kv_heads, cfg.hsz)
    out, _ = _attn_block(cfg, lp.xattn, rms_norm(x, lp.lnx), q_offset=0,
                         backend=backend, causal=False,
                         kv_override=(kx, vx))
    return out


def ffn_block(cfg: ArchConfig, fp: FFN, h):
    """The FFN: act(h @ w1) * (h @ w3) @ w2 when gated, else act(h @ w1) @
    w2 (no ``w3``)."""
    y = activation(cfg.act)(h @ fp.w1)
    if hasattr(fp, "w3"):
        y = y * (h @ fp.w3)
    return y @ fp.w2


def ffn_delta(cfg: ArchConfig, lp: DecoderLayer, h2, *, capacity_factor):
    """A layer's FFN update from its normed input ``h2`` [..., d]: the
    dense FFN's, then the MoE's over the flattened tokens (one dispatch
    group, ``capacity_factor``), added in the reference's order.  Returns
    ``(delta, aux_loss)`` (``aux_loss`` None without experts)."""
    delta, aux = 0.0, None
    if cfg.d_ff:
        delta = ffn_block(cfg, lp.ffn, h2)
    if cfg.moe:
        y, aux = moe_lib.moe_ffn(lp.moe, h2.reshape(-1, h2.shape[-1]),
                                 cfg.moe, activation("silu"),
                                 capacity_factor=capacity_factor, groups=1)
        delta = delta + y.reshape(h2.shape)
    return delta, aux


def chunked_prefill_supported(cfg: ArchConfig) -> bool:
    """Whether ``cfg`` can prefill in prefix-attending chunks bit-exactly:
    every cross-position interaction must be causal attention (the
    reference's rule: dense yes; SSM, hybrid and MoE no, since a scan or a
    capacity-routed dispatch mixes the whole sequence; enc-dec and vlm no,
    since the encoder's frames or the patches need the whole prompt up
    front; the engine falls back to one-shot prefill for them)."""
    return cfg.family == "dense"


def mix_block_outputs(cfg: ArchConfig, a_out, s_out):
    """A layer's residual update from its attention and/or SSM outputs:
    ``0.5 * (a_out + s_out)`` in a hybrid layer (the reference's order),
    else the one output the layer has."""
    if cfg.has_attention and cfg.has_ssm:
        return 0.5 * (a_out + s_out)
    return a_out if cfg.has_attention else s_out


def head_weight(model: Transformer):
    """The logits matmul's weight [d, Vp]: ``lm_head`` when the model is
    untied, else ``embed.T``; a tied rank share's (``models/shard.py``)
    vocab columns ``head_rows.T``."""
    rows = getattr(model, "head_rows", None)
    if rows is not None:
        return rows.T
    return model.embed.T if model.cfg.tie_embeddings else model.lm_head


@torch.no_grad()
def forward(cfg: ArchConfig, model: Transformer, tokens, *,
            return_cache: bool = False, prefill_backend: str = "cuda",
            ssd_backend: str = "cuda", q_offset=0, prefix_state=None,
            enc_frames=None, patch_embeds=None, group=None,
            last_only: bool = False):
    """Full-sequence forward.  tokens [B, T] int -> (logits [B, T, Vp],
    extras); with ``return_cache`` extras holds ``kcache``/``vcache``
    [L, B, T, Kh, hsz] (post-RoPE K and V of every attention layer) and
    ``ssm_conv`` [L, B, conv_dim, ssm_conv-1] / ``ssm_state`` [L, B, nh,
    hd, ds] (f32, the state after the prompt, of every SSM layer).
    ``prefill_backend`` / ``ssd_backend`` route the attention and the SSD
    scan core (kernel families flash_prefill and ssd_prefill).  Archs
    without RoPE add sinusoidal positions to the embeddings.  MoE archs
    route every layer's B*T tokens as one group at the config's
    ``capacity_factor``, and extras hold ``aux_loss``, the layers' summed
    load-balance and z-losses (f32 scalar).

    Chunked prefill: ``prefix_state`` = {"kcache"/"vcache": [L, B, S_buf,
    Kh, hsz]} carry buffers whose rows ``[0, q_offset)`` hold the
    already-prefilled prefix, and ``tokens`` the chunk at global positions
    ``[q_offset, q_offset + T)`` (``q_offset`` an int or a [B] tensor, one
    offset per row: ragged packing).  The chunk's K/V rows are written into
    the buffers in place, attention runs over each whole buffer, and
    extras' kcache/vcache are the buffers themselves, bit for bit those of
    the one-shot prefill when ``S_buf`` is its length.

    Enc-dec archs: ``enc_frames`` [B, S_enc, d] (required) go through
    ``encdec.encode``; the decoder adds ``sinusoidal_positions(T)`` to its
    embeddings and every layer cross-attends to the encoder's output,
    which extras hold as ``enc_out`` [B, S_enc, d].  ``patch_embeds`` [B,
    P, d] (vlm archs) replace the first P token embeddings; a prompt of
    fewer than P tokens is refused.

    ``last_only``: logits [B, 1, Vp] of the last position only.  ``group``
    (a ``core/dist.HelixGroup``, dense and MoE archs that pass
    ``core/sharding.check_ranks``): one rank's forward over its
    ``models/shard.shard_model`` share: attention on its TPA group's heads
    (the caches hold them, ``[L, B, T, Kh/tpa, hsz]``), the out-projection
    and the FFN in TP with an all-reduce each (an MoE layer's experts in
    EP x TPF, their partial sum added to the dense residual's before the
    one all-reduce), the head's vocab columns all-gathered, so every rank
    holds the same logits."""
    if prefix_state is not None and not (return_cache
                                         and chunked_prefill_supported(cfg)):
        raise ValueError("chunked prefill needs return_cache=True and a "
                         "chunked_prefill_supported arch")
    if cfg.is_encdec and enc_frames is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: forward needs "
                         "enc_frames [B, S_enc, d_model]")
    acfg, reduce = cfg, (lambda y: y)       # the attention's heads, the TP sum
    if group is not None:
        acfg, reduce = local_config(cfg, group.tpa), group.all_reduce
    x = model.embed[tokens]
    if patch_embeds is not None:
        p = patch_embeds.shape[1]
        if tokens.shape[1] < p:
            raise ValueError(f"{cfg.name}: a prompt of {tokens.shape[1]} "
                             f"tokens is shorter than its {p} patch "
                             "positions")
        x = torch.cat([patch_embeds.to(x.dtype), x[:, p:]], dim=1)
    if not cfg.use_rope and not cfg.is_encdec:
        off = torch.as_tensor(q_offset, dtype=torch.int64, device=x.device)
        pos = torch.arange(tokens.shape[1], device=x.device)[None, :] \
            + off.reshape(-1, 1)
        x = x + sinusoidal_at(pos, cfg.d_model).to(x.dtype)
    enc_out = None
    if cfg.is_encdec:
        # imported here: encdec imports this module's blocks
        from repro_torch.models.encdec import encode
        enc_out = encode(cfg, model.enc, enc_frames, backend=prefill_backend)
        x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                     x.device)[None].to(x.dtype)
    kcs, vcs, convs, ssms, auxs = [], [], [], [], []
    a_out = s_out = None            # the output a layer lacks
    windows = layer_windows(cfg)
    for i, lp in enumerate(model.layers):
        h = rms_norm(x, lp.ln1)
        if cfg.has_attention:
            buf = (None if prefix_state is None else
                   (prefix_state["kcache"][i], prefix_state["vcache"][i]))
            a_out, (k, v) = _attn_block(acfg, lp.attn, h, q_offset=q_offset,
                                        backend=prefill_backend,
                                        kv_buffer=buf, window=windows[i],
                                        group=group)
            if return_cache:
                kcs.append(k)
                vcs.append(v)
        if cfg.has_ssm:
            s_out, st = ssm_lib.ssd_chunked(lp.ssm, cfg, h,
                                            backend=ssd_backend)
            if return_cache:
                convs.append(st.conv)
                ssms.append(st.ssm)
        x = x + mix_block_outputs(cfg, a_out, s_out)
        if enc_out is not None:
            x = x + cross_attn_block(cfg, lp, x, enc_out,
                                     backend=prefill_backend)
        if cfg.d_ff or cfg.moe:
            delta, aux = ffn_delta(cfg, lp, rms_norm(x, lp.ln2),
                                   capacity_factor=None)
            x = x + reduce(delta)
            if aux is not None:
                auxs.append(aux)
    x = rms_norm(x[:, -1:] if last_only else x, model.ln_f)
    logits = x @ head_weight(model)
    if group is not None:
        logits = group.all_gather_cols(logits)[..., :cfg.padded_vocab]
    logits = (softcap(logits, cfg.softcap)
              + vocab_mask(cfg, x.dtype, x.device))
    extras = {"aux_loss": torch.stack(auxs).sum()} if auxs else {}
    if prefix_state is not None:
        extras.update(kcache=prefix_state["kcache"],
                      vcache=prefix_state["vcache"])
    elif kcs:
        extras.update(kcache=torch.stack(kcs), vcache=torch.stack(vcs))
    if convs:
        extras.update(ssm_conv=torch.stack(convs),
                      ssm_state=torch.stack(ssms))
    if enc_out is not None:
        extras["enc_out"] = enc_out
    return logits, extras
