"""Plain PyTorch version of the flash_decode kernel (port of the reference's
``kernels/flash_decode/ref.py``).

The KV shard on KVP rank ``rank`` holds slots j = 0..S_cap-1; with the
round-robin layout (block ``rr_block``) slot j holds global position

    pos(j) = ((j // rr) * kvp + rank) * rr + (j % rr)

A slot is valid iff ``pos < total_len`` and, with a window ``w > 0``,
``pos >= total_len - w``.  Returns the normalised partial output and the
log-sum-exp (f32) that the Helix combine needs.  An int8 shard comes with
per-slot f32 scales and is dequantized as ``float(q) * scale`` first.

``flash_decode_ref`` is the oracle: one softmax over the whole shard.
``sweep_tiles`` and ``finish_rows`` are the plain version of the kernels'
own arithmetic order (``csrc/decode_tile.cuh``): an online softmax over
tiles of ``TILE_S`` slots with a raw ``(acc, m, l)`` state, so a sweep may
be split at a tile boundary and resumed (the grouped decode) without
changing a bit.
"""
from __future__ import annotations

import torch

from repro_torch.utils import NEG_INF, int8_scale


TILE_S = 32                 # slots per tile, as in the CUDA kernels


def cold_state(n: int, rows: int, hsz: int, device=None):
    """The online softmax's start: acc 0, m = NEG_INF, l 0 for ``[n, rows]``
    query rows."""
    return (torch.zeros(n, rows, hsz, device=device),
            torch.full((n, rows), NEG_INF, device=device),
            torch.zeros(n, rows, device=device))


def _lane0_sum(p):
    """Sum over the last axis (32 lanes) in the order lane 0 of the
    kernels' xor-butterfly ``warp_sum`` adds: halves, then quarters, ..."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = p[..., :h] + p[..., h:]
    return p[..., 0]


def sweep_tiles(q, k, v, valid, state):
    """The decode kernels' tile loop in plain PyTorch.

    q [N, R, hsz] f32 scaled queries; k, v [N, S, hsz] f32; valid [N, R | 1,
    S] bool; state ``(acc [N, R, hsz], m [N, R], l [N, R])``.  Updates the
    raw state tile by tile in slot order (products summed over hsz, then
    over the tile's slots, one element at a time; slots past S are masked)
    and returns it.  Tiles with no valid slot in any row are skipped: for
    every row they are the exact identity update."""
    acc, m, l = state
    n, r, hsz = q.shape
    pad = -k.shape[1] % TILE_S
    k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad)).expand(n, r, k.shape[1])
    live = valid.reshape(-1, k.shape[1] // TILE_S, TILE_S).any(-1).any(0)
    for t in torch.nonzero(live).flatten().tolist():
        sl = slice(t * TILE_S, (t + 1) * TILE_S)
        kt, vt, ok = k[:, sl], v[:, sl], valid[:, :, sl]
        s = torch.zeros(n, r, TILE_S, device=q.device)
        for d in range(hsz):
            s = s + q[:, :, d, None] * kt[:, None, :, d]
        s = torch.where(ok, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(ok, torch.exp(s - m_new[..., None]),
                        torch.zeros_like(s))
        l = alpha * l + _lane0_sum(p)
        pv = torch.zeros_like(acc)
        for j in range(TILE_S):
            pv = pv + p[:, :, j, None] * vt[:, None, j, :]
        acc = alpha[..., None] * acc + pv
        m = m_new
    return acc, m, l


def finish_rows(state, dtype):
    """Raw state -> ``(out [N, R, hsz] in dtype, lse [N, R] f32)``; rows
    with nothing valid give 0 and NEG_INF, as in the kernels."""
    acc, m, l = state
    den = torch.clamp(l, min=1e-37)
    out = torch.where((l > 0)[..., None], acc / den[..., None],
                      torch.zeros_like(acc))
    lse = torch.where(l > 0, m + torch.log(den), torch.full_like(l, NEG_INF))
    return out.to(dtype), lse


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
