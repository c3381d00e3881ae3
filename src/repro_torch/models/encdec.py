"""Whisper-style encoder (port of the reference's ``models/encdec.py``;
the conv front end is a stub, so the encoder takes frame embeddings [B,
S_enc, d_model]) and the static cross-attention K/V of the decoder."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.layers import rms_norm, sinusoidal_positions
from repro_torch.models.transformer import _attn_block, ffn_block


@torch.no_grad()
def encode(cfg: ArchConfig, enc, frames, *, backend: str = "cuda"):
    """frames [B, S_enc, d] -> enc_out [B, S_enc, d]: sinusoidal positions,
    then ``enc_layers`` pre-norm layers of bidirectional self-attention
    (flash_prefill's non-causal mode on the ``cuda`` backend) and FFN, then
    the final norm.  ``enc`` is ``Transformer.enc``."""
    x = frames + sinusoidal_positions(frames.shape[1], cfg.d_model,
                                      frames.device)[None].to(frames.dtype)
    for lp in enc.layers:
        a_out, _ = _attn_block(cfg, lp.attn, rms_norm(x, lp.ln1), q_offset=0,
                               backend=backend, causal=False)
        x = x + a_out
        x = x + ffn_block(cfg, lp.ffn, rms_norm(x, lp.ln2))
    return rms_norm(x, enc.ln_f)


@torch.no_grad()
def cross_kv(cfg: ArchConfig, layers, enc_out):
    """Every decoder layer's cross-attention K/V from the encoder's output:
    ``(kx, vx)`` [L, B, S_enc, Kh, hsz], the static "KV cache" the decode
    steps attend over in the contiguous layout (it never grows)."""
    b, s, _ = enc_out.shape
    kx = torch.stack([(enc_out @ lp.xattn.wk).reshape(b, s, cfg.n_kv_heads,
                                                      cfg.hsz)
                      for lp in layers])
    vx = torch.stack([(enc_out @ lp.xattn.wv).reshape(b, s, cfg.n_kv_heads,
                                                      cfg.hsz)
                      for lp in layers])
    return kx, vx
