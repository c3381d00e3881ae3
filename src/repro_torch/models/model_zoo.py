"""Prefill steps and their handoff into the round-robin decode layout (port
of the reference's ``models/model_zoo.py``: ``prefill_cache_to_rr``,
``make_prefill_step`` and the chunked prefill, ``init_prefill_buffers``,
``make_chunk_prefill_step`` and ``finalize_chunked_prefill``)."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.core.helix import prefill_to_rr_layout
from repro_torch.core.kvcache import cache_capacity
from repro_torch.core.sharding import HelixConfig, check_ranks, local_config
from repro_torch.models.decode_model import (  # noqa: F401
    build_serve_multistep, build_serve_step)
from repro_torch.models.encdec import cross_kv
from repro_torch.models.transformer import chunked_prefill_supported, forward
from repro_torch.utils import round_up

__all__ = ["prefill_cache_to_rr", "make_prefill_step", "build_serve_step",
           "build_serve_multistep",
           "init_prefill_buffers", "make_chunk_prefill_step",
           "finalize_chunked_prefill", "chunked_prefill_supported"]


def prefill_cache_to_rr(cfg: ArchConfig, hx: HelixConfig, kc_raw, vc_raw,
                        t: int, cap: int):
    """Prefill K/V ``[L, B, T', Kh, hsz]`` -> round-robin decode caches
    ``[L, B, Kh, cap, hsz]`` (the first ``t`` rows are live)."""
    out = []
    for c in (kc_raw, vc_raw):
        c = c[:, :, :t, :cfg.n_kv_heads].transpose(2, 3)       # [L,B,Kh,t,hsz]
        c = torch.nn.functional.pad(c, (0, 0, 0, cap - t))
        l, b = c.shape[:2]
        rr = prefill_to_rr_layout(c.reshape(l * b, *c.shape[2:]), hx.kvp,
                                  hx.rr_block)
        out.append(rr.reshape(c.shape).contiguous())
    return out[0], out[1]


def _forward_kwargs(cfg: ArchConfig, batch: dict) -> dict:
    """The batch's extra inputs ``forward`` takes: ``patch_embeds`` for a
    vlm arch, ``enc_frames`` for an enc-dec one (the reference's
    ``_forward_kwargs``; a missing leaf is a ``KeyError``)."""
    kw = {}
    if cfg.vision_patches:
        kw["patch_embeds"] = batch["patch_embeds"]
    if cfg.is_encdec:
        kw["enc_frames"] = batch["enc_frames"]
    return kw


def make_prefill_step(cfg: ArchConfig, hx: HelixConfig,
                      s_cap: int | None = None, group=None):
    """Build ``prefill_step(model, batch) -> (last_logits [B, Vp], state)``:
    the one-shot prefill (``hx.prefill_backend`` routes its attention,
    ``hx.ssd_backend`` its SSD scan) and the handoff of its caches into the
    round-robin layout; SSM and hybrid archs hand over their ``ssm_conv``/
    ``ssm_state`` leaves as they are (a hybrid's state holds both kinds).
    ``batch`` holds ``tokens`` [B, T] and, for a vlm arch, ``patch_embeds``
    [B, P, d]; for an enc-dec arch ``enc_frames`` [B, S_enc, d], and the
    state then carries the static cross K/V ``xk``/``xv`` [L, B, Kh,
    S_enc_pad, hsz] (``encdec.cross_kv`` transposed, zero-padded to a
    multiple of ``hx.kvp``: each rank holds a contiguous shard) and
    ``enc_len`` (int32, S_enc).

    With ``group`` (dense and MoE archs): one rank's prefill over its
    ``shard_model`` share (``forward(group=)``: attention on its TPA heads,
    the out-projection and the FFN in TP with an all-reduce each, the last
    position's vocab-parallel logits all-gathered); its caches go through
    ``prefill_cache_to_rr`` and the rank keeps its slots ``[k*s_loc,
    (k+1)*s_loc)`` of its heads, ``s_loc = cap / kvp``."""
    acfg = cfg                      # the shapes of the caches' heads
    if group is not None:
        check_ranks(cfg, hx)
        if (hx.kvp, hx.tpa, hx.ep) != (group.kvp, group.tpa, group.ep):
            raise ValueError(f"hx is kvp {hx.kvp} x tpa {hx.tpa} (ep "
                             f"{hx.ep}), the group {group.kvp} x {group.tpa} "
                             f"(ep {group.ep})")
        acfg = local_config(cfg, hx.tpa)

    def prefill_step(model, batch):
        tokens = batch["tokens"]
        b, t = tokens.shape
        logits, extras = forward(cfg, model, tokens, return_cache=True,
                                 prefill_backend=hx.prefill_backend,
                                 ssd_backend=hx.ssd_backend, group=group,
                                 last_only=group is not None,
                                 **_forward_kwargs(cfg, batch))
        state = {"total_len": torch.tensor(t, dtype=torch.int32,
                                           device=tokens.device)}
        if cfg.has_attention:
            cap = s_cap or cache_capacity(t, hx.kvp, hx.rr_block)
            kc, vc = prefill_cache_to_rr(acfg, hx, extras["kcache"],
                                         extras["vcache"], t, cap)
            if group is not None:           # the rank's slots
                s_loc = cap // hx.kvp
                kc, vc = (c[..., group.k * s_loc:(group.k + 1) * s_loc, :]
                          .contiguous() for c in (kc, vc))
            state["kcache"], state["vcache"] = kc, vc
        if cfg.has_ssm:
            state["ssm_conv"] = extras["ssm_conv"]
            state["ssm_state"] = extras["ssm_state"]
        if cfg.is_encdec:
            s_enc = extras["enc_out"].shape[1]
            pad = round_up(s_enc, hx.kvp) - s_enc
            for key, x in zip(("xk", "xv"),
                              cross_kv(cfg, model.layers, extras["enc_out"])):
                state[key] = torch.nn.functional.pad(
                    x.transpose(2, 3), (0, 0, 0, pad)).contiguous()
            state["enc_len"] = torch.tensor(s_enc, dtype=torch.int32,
                                            device=tokens.device)
        return logits[:, -1], state

    return prefill_step


# ------------------------------------------------------- chunked prefill
def init_prefill_buffers(cfg: ArchConfig, batch: int, t: int, *,
                         dtype=torch.float32, device="cuda") -> dict:
    """Zero K/V carry buffers ``[L, batch, t, Kh, hsz]`` for a chunked
    prefill of length ``t`` (``forward``'s prefill cache layout; ``t`` must
    be the one-shot prefill length for the chunked run to be bit-exact).
    The port's buffers take the model's dtype, where the reference's
    default is f32."""
    shape = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.hsz)
    return {"kcache": torch.zeros(shape, dtype=dtype, device=device),
            "vcache": torch.zeros(shape, dtype=dtype, device=device)}


def make_chunk_prefill_step(cfg: ArchConfig, hx: HelixConfig, *,
                            return_last_logits: bool = False):
    """Build ``chunk_step(model, tokens, buffers, q_offset) -> (next_tokens,
    buffers)``: ``tokens`` is the ``[B, C]`` chunk at global positions
    ``[q_offset, q_offset + C)`` (``q_offset`` an int or a [B] tensor:
    ragged packing, one offset per row), ``buffers`` the carry dict of
    ``init_prefill_buffers`` with ``[0, q_offset)`` filled; the chunk's K/V
    land in them in place.  ``next_tokens`` [B, C] is the greedy token
    after each chunk position: row ``t - 1 - q_offset`` of a request's last
    chunk is its first generated token.  ``return_last_logits``: the step
    returns ``(next_tokens, last_logits, buffers)``, ``last_logits`` [B,
    Vp] the vocab-masked logits at the chunk's last position, which a
    sampling engine's first-token sampler takes."""
    if not chunked_prefill_supported(cfg):
        raise ValueError(f"chunked prefill unsupported for {cfg.name}")

    def chunk_step(model, tokens, buffers, q_offset):
        logits, extras = forward(cfg, model, tokens, return_cache=True,
                                 prefill_backend=hx.prefill_backend,
                                 prefix_state=buffers, q_offset=q_offset)
        next_tokens = torch.argmax(logits[:, :, :cfg.vocab],
                                   dim=-1).to(torch.int32)
        buffers = {"kcache": extras["kcache"], "vcache": extras["vcache"]}
        if return_last_logits:
            return next_tokens, logits[:, -1], buffers
        return next_tokens, buffers

    return chunk_step


def finalize_chunked_prefill(cfg: ArchConfig, hx: HelixConfig, buffers,
                             t: int, s_cap: int | None = None) -> dict:
    """Filled carry buffers -> round-robin decode state, through the same
    ``prefill_cache_to_rr`` as ``make_prefill_step``: a chunked prefill's
    decode state is the one-shot path's, bit for bit."""
    cap = s_cap or cache_capacity(t, hx.kvp, hx.rr_block)
    kcache, vcache = prefill_cache_to_rr(cfg, hx, buffers["kcache"],
                                         buffers["vcache"], t, cap)
    return {"total_len": torch.tensor(t, dtype=torch.int32,
                                      device=kcache.device),
            "kcache": kcache, "vcache": vcache}
