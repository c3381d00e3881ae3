"""Plain PyTorch version of the flash_decode kernel (port of the reference's
``kernels/flash_decode/ref.py``).

The KV shard on KVP rank ``rank`` holds slots j = 0..S_cap-1; with the
round-robin layout (block ``rr_block``) slot j holds global position

    pos(j) = ((j // rr) * kvp + rank) * rr + (j % rr)

A slot is valid iff ``pos < total_len`` and, with a window ``w > 0``,
``pos >= total_len - w``.  Returns the normalised partial output and the
log-sum-exp (f32) that the Helix combine needs.  An int8 shard comes with
per-slot f32 scales and is dequantized as ``float(q) * scale`` first.
"""
from __future__ import annotations

import torch

from repro_torch.utils import NEG_INF, int8_scale


def quantize_kv_token(x):
    """Symmetric int8 quantization over the last (hsz) axis: [..., hsz] ->
    (int8 [..., hsz], f32 scale [...]), the formula of the reference's
    ``core/helix.quantize_kv_token`` and of the kernel's in-kernel
    ``_quantize_row``: ``scale = max(max|x| / 127, 1e-30)``,
    ``q = clip(round(x / scale), -127, 127)`` (round half to even)."""
    xf = x.float()
    scale = int8_scale(xf, -1)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def gather_pages(pool, tables):
    """Dense per-request view of a pool plane: ``pool [n_pool, Kh, page,
    ...]`` and ``tables [B, max_pages]`` -> ``[B, Kh, max_pages * page,
    ...]``, logical page i of request b taken from physical page
    ``tables[b, i]`` (one gather; the kernel reads through the table
    instead)."""
    b, mp = tables.shape
    g = pool[tables.long()]                       # [B, MP, Kh, page, ...]
    g = g.transpose(1, 2)                         # [B, Kh, MP, page, ...]
    return g.reshape(b, pool.shape[1], mp * pool.shape[2], *pool.shape[3:])


def shard_positions(s_cap: int, rank, kvp: int, rr_block: int, slot_offset=0,
                    device=None):
    """Global positions of the local KV slots on ``rank``.  [S_cap] int32."""
    j = torch.arange(s_cap, dtype=torch.int32, device=device) + slot_offset
    return ((j // rr_block) * kvp + rank) * rr_block + (j % rr_block)


def flash_decode_ref(q, k, v, total_len, rank, *, kvp: int = 1,
                     rr_block: int = 16, window: int = 0,
                     scale: float | None = None, slot_offset=0,
                     kscale=None, vscale=None):
    """Decode attention over one KV shard.

    q [B, Qh, hsz]; k, v [B, Kh, S_cap, hsz]; ``total_len`` an int or a [B]
    tensor (global length including the new token); ``kscale``/``vscale``
    [B, Kh, S_cap] f32 with int8 ``k``/``v``.  Returns
    ``(out [B, Qh, hsz] in q.dtype, lse [B, Qh] f32)``; rows with no valid
    slot give ``out = 0`` and ``lse = NEG_INF``.
    """
    if kscale is not None:
        k = k.float() * kscale[..., None]
        v = v.float() * vscale[..., None]
    b, qh, hsz = q.shape
    kh, s_cap = k.shape[1], k.shape[2]
    g = qh // kh
    if scale is None:
        scale = hsz ** -0.5
    dev = q.device
    pos = shard_positions(s_cap, rank, kvp, rr_block, slot_offset, device=dev)
    tl = torch.as_tensor(total_len, dtype=torch.int32, device=dev).reshape(-1, 1)
    valid = pos[None, :] < tl                                  # [B|1, S]
    if window > 0:
        valid = valid & (pos[None, :] >= tl - window)
    valid = valid.expand(b, s_cap)[:, None, None, :]           # [B,1,1,S]

    qf = q.float().reshape(b, kh, g, hsz) * scale
    scores = torch.einsum("bhgd,bhsd->bhgs", qf, k.float())
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1)
    m_safe = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    p = torch.where(valid, torch.exp(scores - m_safe[..., None]),
                    torch.zeros_like(scores))
    l = p.sum(dim=-1)
    out = (torch.einsum("bhgs,bhsd->bhgd", p, v.float())
           / torch.clamp(l, min=1e-37)[..., None])
    lse = torch.where(l > 0, m_safe + torch.log(torch.clamp(l, min=1e-37)),
                      torch.full_like(l, NEG_INF))
    return out.reshape(b, qh, hsz).to(q.dtype), lse.reshape(b, qh)
