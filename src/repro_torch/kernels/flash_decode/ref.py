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
``sweep_chunks``, ``merge_chunks`` and ``finish_rows`` are the plain
version of the kernels' own structure (``csrc/decode_tile.cuh``): the shard
cut at absolute boundaries into chunks of ``CHUNK_S`` slots, each chunk
swept from the cold state by an online softmax over tiles of ``TILE_S``
slots (``sweep_tiles``) into a raw ``(acc, m, l)`` partial, and the
partials folded in chunk order.  A chunk's sweep may be split at a tile
boundary and resumed (the grouped decode), and empty partials are skipped
by the fold, so grouping and pruning change no bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pruning import CHUNK_S, TILE_S
from repro_torch.utils import NEG_INF, int8_scale


def chunk_count(n_slots: int) -> int:
    """Chunks of ``CHUNK_S`` slots covering ``n_slots`` slots."""
    return -(-n_slots // CHUNK_S)


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


def sweep_chunks(q, k, v, valid, state=None):
    """Every chunk of ``CHUNK_S`` slots swept on its own, as the kernels'
    CTAs do.

    q [N, R, hsz] f32 scaled queries; k, v [N, S, hsz] f32; valid [N | 1,
    R | 1, S] bool; ``state`` (acc [N, C, R, hsz], m, l [N, C, R]) the state each
    chunk starts from (None: cold), C = ``chunk_count(S)``.  Returns the
    chunks' raw partials in the same shapes (slots past S are masked)."""
    n, r, hsz = q.shape
    c = chunk_count(k.shape[1])
    pad = c * CHUNK_S - k.shape[1]
    k = torch.nn.functional.pad(k, (0, 0, 0, pad)).reshape(n * c, CHUNK_S, hsz)
    v = torch.nn.functional.pad(v, (0, 0, 0, pad)).reshape(n * c, CHUNK_S, hsz)
    rv = valid.shape[1]
    valid = torch.nn.functional.pad(valid, (0, pad)).expand(n, rv, c * CHUNK_S)
    valid = valid.reshape(n, rv, c, CHUNK_S).transpose(1, 2).reshape(
        n * c, rv, CHUNK_S)
    qc = q[:, None].expand(n, c, r, hsz).reshape(n * c, r, hsz)
    st = (cold_state(n * c, r, hsz, q.device) if state is None else
          (state[0].reshape(n * c, r, hsz), state[1].reshape(n * c, r),
           state[2].reshape(n * c, r)))
    acc, m, l = sweep_tiles(qc, k, v, valid, st)
    return (acc.reshape(n, c, r, hsz), m.reshape(n, c, r),
            l.reshape(n, c, r))


def merge_chunks(parts, take=None):
    """Fold chunk partials ``(acc [N, C, R, hsz], m, l [N, C, R])`` in chunk
    order into one raw state ``(acc [N, R, hsz], m, l [N, R])``, as the
    kernels' merge does: chunks not in ``take`` [N, C] (None: all) and
    empty partials (l == 0) are skipped, the first partial is taken as it
    is, later ones combine as ``m = max(m, m_c)``, ``l = e^(m - m') l +
    e^(m_c - m') l_c`` and ``acc`` likewise, each product and sum rounded
    on its own."""
    acc, m, l = parts
    n, c, r, hsz = acc.shape
    sa, sm, sl = cold_state(n, r, hsz, acc.device)
    for i in range(c):
        ac, mc, lc = acc[:, i], m[:, i], l[:, i]
        use = lc > 0
        if take is not None:
            use = use & take[:, i, None]
        mn = torch.maximum(sm, mc)
        e0, e1 = torch.exp(sm - mn), torch.exp(mc - mn)
        first = sl == 0
        nm = torch.where(first, mc, mn)
        nl = torch.where(first, lc, e0 * sl + e1 * lc)
        na = torch.where(first[..., None], ac,
                         e0[..., None] * sa + e1[..., None] * ac)
        sm = torch.where(use, nm, sm)
        sl = torch.where(use, nl, sl)
        sa = torch.where(use[..., None], na, sa)
    return sa, sm, sl


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
