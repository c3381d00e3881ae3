"""Integer range functions of the attention kernels, on tensors.

The port's copy of ``repro/kernels/pruning.py`` ``phys_block`` and of the
slot/range formulas of the two Pallas kernels (``flash_decode/kernel.py``
``_append_slot``, ``valid_slot_span``, ``prune_block_range``;
``flash_prefill/kernel.py`` ``prefill_block_range``).  The CUDA kernels
compute the same formulas on the device (``csrc/*.cu``); these versions
drive the plain PyTorch paths and pin the formulas against the reference in
the tests.  Arguments may be Python ints or integer tensors; ``//`` and
``%`` floor like the reference's ``jnp`` operators.
"""
from __future__ import annotations

import torch


TILE_S = 32          # slots per tile of the decode kernels
CHUNK_TILES = 8      # tiles per chunk: one CTA of the decode kernels each
CHUNK_S = TILE_S * CHUNK_TILES


def _t(x):
    return torch.as_tensor(x, dtype=torch.int32)


def phys_block(step, lo, nb, n_blocks: int):
    """Physical block streamed at grid step ``step``: ``lo + step`` inside
    the span ``[lo, lo + nb)``, then pinned to the span's last block, always
    within ``[0, n_blocks)``."""
    step, lo, nb = _t(step), _t(lo), _t(nb)
    last = torch.maximum(lo + nb - 1, lo)
    return torch.clamp(torch.minimum(lo + step, last), 0, n_blocks - 1)


def local_valid_len(total_len, rank, kvp: int, rr_block: int):
    """Number of valid local slots on ``rank`` given global length."""
    total_len, rank = _t(total_len), _t(rank)
    cycle = kvp * rr_block
    full = (total_len // cycle) * rr_block
    rem = total_len % cycle
    extra = torch.clamp(rem - rank * rr_block, 0, rr_block)
    return full + extra


def append_slot(total_len, kvp: int, rr_block: int, s_max: int):
    """Local rr slot of the appended token (position ``total_len - 1``),
    clamped to the padded capacity ``s_max``; the same on every rank."""
    pos = _t(total_len) - 1
    blk = pos // rr_block
    j = (blk // kvp) * rr_block + pos % rr_block
    return torch.clamp(j, 0, s_max - 1)


def append_owner(total_len, kvp: int, rr_block: int):
    """KVP rank that owns the appended token's position."""
    return ((_t(total_len) - 1) // rr_block) % kvp


def valid_slot_span(total_len, rank, slot_offset, window, *, kvp: int,
                    rr_block: int, s_true: int, contiguous: bool):
    """``[jj_lo, jj_hi)``: the physical-slot span that can hold unmasked
    slots of one request on one rank."""
    total_len = torch.clamp(_t(total_len), min=0)
    rank, slot_offset, window = _t(rank), _t(slot_offset), _t(window)
    if contiguous:
        j_hi = total_len - rank * s_true
        j_lo = total_len - window - rank * s_true
    else:
        j_hi = local_valid_len(total_len, rank, kvp, rr_block)
        j_lo = local_valid_len(torch.clamp(total_len - window, min=0), rank,
                               kvp, rr_block)
    jj_hi = torch.clamp(j_hi - slot_offset, 0, s_true)
    jj_lo = torch.where(window > 0, torch.clamp(j_lo - slot_offset, 0, s_true),
                        torch.zeros_like(j_lo))
    return jj_lo, jj_hi


def prune_block_range(total_len, rank, slot_offset, window, *, kvp: int,
                      rr_block: int, block_s: int, s_true: int,
                      contiguous: bool = False):
    """(first_block, n_valid_blocks) of the S-block span a decode request
    can touch: the blocks the decode kernel loops over."""
    jj_lo, jj_hi = valid_slot_span(total_len, rank, slot_offset, window,
                                   kvp=kvp, rr_block=rr_block, s_true=s_true,
                                   contiguous=contiguous)
    lo = jj_lo // block_s
    hi = (jj_hi + block_s - 1) // block_s
    return lo, torch.clamp(hi - lo, min=0)


def decode_chunk_range(total_len, rank, slot_offset, window, *, kvp: int,
                       rr_block: int, s_true: int, contiguous: bool = False,
                       prune: bool = True, n_tiles: int = 0):
    """``(c0, c1)``: the chunks of ``CHUNK_S`` slots the decode kernels
    sweep and merge for one request on one rank.  Pruning on: the chunks
    holding the tiles of ``TILE_S`` slots that hold its valid slots
    (``valid_slot_span``); off: every chunk of ``n_tiles`` tiles (the
    padded capacity).  Empty (``c0 == c1 == 0``) when nothing is valid."""
    if not prune:
        n = torch.full_like(_t(total_len), -(-n_tiles // CHUNK_TILES))
        return torch.zeros_like(n), n
    jj_lo, jj_hi = valid_slot_span(total_len, rank, slot_offset, window,
                                   kvp=kvp, rr_block=rr_block, s_true=s_true,
                                   contiguous=contiguous)
    t0 = jj_lo // TILE_S
    t1 = (jj_hi + TILE_S - 1) // TILE_S
    some = jj_hi > jj_lo
    zero = torch.zeros_like(t0)
    return (torch.where(some, t0 // CHUNK_TILES, zero),
            torch.where(some, (t1 + CHUNK_TILES - 1) // CHUNK_TILES, zero))


def decode_work_items(total_len, *, kvp: int, n_ranks: int, rank: int,
                      kv_heads: int, rr_block: int, s_true: int, window=0,
                      slot_offset=0, contiguous: bool = False,
                      prune: bool = True, n_tiles: int = 0,
                      group_np=None, page_rows: int = 0,
                      chunks_per_cta: int = 1) -> int:
    """CTAs of one flash_decode launch that sweep: per rank, batch row and
    kv head, the chunks it merges, less (grouped suffix, ``group_np`` [B]
    with ``page_rows`` rows per rank and page) those wholly below the split
    tile ``group_np * page_rows // TILE_S``, taken ``chunks_per_cta`` at a
    time (CTA i holds chunks ``[i * chunks_per_cta, (i + 1) *
    chunks_per_cta)``)."""
    tl = _t(total_len).reshape(-1)
    split = (torch.zeros_like(tl) if group_np is None
             else _t(group_np).reshape(-1) * page_rows // TILE_S)
    n = 0
    for z in range(n_ranks):
        c0, c1 = decode_chunk_range(tl, rank + z, slot_offset, window, kvp=kvp,
                                    rr_block=rr_block, s_true=s_true,
                                    contiguous=contiguous, prune=prune,
                                    n_tiles=n_tiles)
        lo = torch.clamp(split // CHUNK_TILES, min=c0, max=c1)
        first = lo // chunks_per_cta
        last = (c1 + chunks_per_cta - 1) // chunks_per_cta
        n += int(torch.where(c1 > lo, last - first, 0).sum())
    return n * kv_heads


def prefix_work_items(group_id, group_np, *, n_ranks: int, kv_heads: int,
                      page_rows: int) -> int:
    """CTAs of one prefix_pass launch that sweep a chunk: per group, kv head
    and rank, the chunks below the group's largest split tile (one row
    block each while members x G <= 32 rows)."""
    gid, gnp = _t(group_id).tolist(), _t(group_np).tolist()
    split = {}
    for g, p in zip(gid, gnp):
        if p > 0:
            split[g] = max(split.get(g, 0), p * page_rows // TILE_S)
    n = sum(-(-s // CHUNK_TILES) for s in split.values())
    return n * kv_heads * n_ranks


def prefill_block_range(qi, kv_len, q_offset, window, *, causal: bool,
                        blk_q: int, blk_k: int, s_true: int):
    """(first_kv_block, n_valid_kv_blocks) for query block ``qi`` of the
    prefill kernel."""
    qi, kv_len, q_offset, window = _t(qi), _t(kv_len), _t(q_offset), _t(window)
    hi_slot = torch.clamp(kv_len, max=s_true)
    if causal:
        hi_slot = torch.minimum(hi_slot, q_offset + (qi + 1) * blk_q)
    lo_slot = torch.where(
        window > 0, torch.clamp(q_offset + qi * blk_q - window + 1, 0, s_true),
        torch.zeros_like(q_offset))
    lo = lo_slot // blk_k
    hi = (hi_slot + blk_k - 1) // blk_k
    return lo, torch.clamp(hi - lo, min=0)
