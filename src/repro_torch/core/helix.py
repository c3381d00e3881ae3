"""Helix decode attention on one card (port of the reference's
``core/helix.py``), with KVP emulated: the global cache ``[B, Kh, S_cap,
hsz]`` splits into ``kvp`` contiguous shards of ``s_loc = S_cap / kvp``
slots, exactly like the reference's sharding of the slot axis.  Each rank
attends over its shard (``flash_decode`` family), then the flat (Qh*hsz)
dim is sliced as the all-to-all would slice it and ``combine_fragments``
merges the ranks.  With the ``cuda`` backend all ranks run in ONE kernel
launch (the rank is a grid dimension).

Round-robin layout (§2.3): global position p lives on rank
``(p // rr) % kvp`` at local slot ``((p // rr) // kvp) * rr + p % rr``.

int8 caches (``HelixConfig.kv_cache_bits == 8``) carry per-slot f32 scales
``kscale``/``vscale`` [B, Kh, S_cap]; a new row is quantized per (B, Kh)
over hsz (``quantize_kv_token``), by ``append_kv_quant`` or inside the
decode kernel's fused append.

Paged pool (``block_tables`` [B, max_pages]): the caches are pool planes
``[n_pool, Kh, page, hsz]`` (``core/kvcache.py`` layout; rank r's rows of a
page are ``[r*rr, (r+1)*rr)``).  The ``cuda`` backend reads them through
the table in its one launch; the ``ref`` backend gathers each rank's pages
into a dense shard first; appends go through ``paged_slot_of_position``.

Grouped shared-prefix decode (``groups``, paged only): the ``cuda``
backend runs the prefix pass and the decode kernel's grouped-suffix mode;
the ``ref`` backend ignores the grouping, which is the oracle's semantics
(grouped == ungrouped).

Across ranks (``group``, a ``core/dist.HelixGroup``): each process is one
rank ``(t, k)`` of a ``kvp x tpa`` grid and holds its local shard ``[B,
Kh/tpa, s_loc, hsz]`` of the heads of TPA group t.  It attends over it with
one kernel launch (``flash_decode_shards(n_ranks=1, rank=k)``; the fused
append writes only on the rank that owns the new position), cuts the padded
flat ``Qh/tpa * hsz`` dim into ``[kvp, B, sl]`` fragments, sends them
through one all-to-all over its KVP subgroup, all-gathers the LSEs there and
combines its ``[B, sl]`` slice: the reference's ``shard_map`` region.
HOP-B (``hopb_chunks > 1``, B divisible by it) splits the batch: chunk i's
all-to-all and all-gather are in flight while chunk i+1 attends, and the
chunks are combined in order after their waits.

Not ported: the multi-rank paged, int8 and contiguous modes, and the
reference's sliding-window cache-slice fast path (the decode kernel's block
pruning covers it).

Caches (and scales) are updated **in place** (``append_kv``,
``append_kv_quant`` and the fused append), where the reference returns new
arrays.
"""
from __future__ import annotations

import torch

from repro_torch.core.combine import combine_fragments
from repro_torch.core.kvcache import gather_pages
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels.flash_decode.ops import flash_decode_shards
from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,
                                                  quantize_kv_token)
from repro_torch.utils import round_up


def helix_out_dim(q_dim: int, kvp: int) -> int:
    """Flattened attention-output dim after the all-to-all (padded)."""
    return round_up(q_dim, kvp)


def rr_slot_of_position(pos, kvp: int, s_loc: int, rr_block: int):
    """Global round-robin cache slot for sequence position ``pos``."""
    blk = pos // rr_block
    rank = blk % kvp
    local = (blk // kvp) * rr_block + pos % rr_block
    return rank * s_loc + local


def fuse_append_applicable(hx: HelixConfig, *, quant: bool = False,
                           contiguous: bool = False,
                           paged: bool = False) -> bool:
    """Whether a decode step appends its K/V row inside the decode kernel:
    needs a kernel backend, ``hx.fuse_append`` and the round-robin layout.
    int8 caches (``quant``) fuse too: the kernel quantizes the row itself,
    and so does the paged pool (``paged``): the kernel writes through the
    table.  (The reference also excludes its window cache-slice path, which
    the port does not have.)"""
    del quant, paged
    return hx.attn_backend != "ref" and hx.fuse_append and not contiguous


def _local_attend(q, k, v, total_len, rank, *, kvp, rr_block, window,
                  contiguous: bool, kscale=None, vscale=None):
    """Per-rank partial attention + LSE over one local shard ``k``/``v``
    [B, Kh, s_loc, hsz] (int8 with ``kscale``/``vscale`` [B, Kh, s_loc])
    with the plain oracle (the ``ref`` backend; the ``cuda`` backend
    attends over all ranks in one kernel launch)."""
    if contiguous:
        return flash_decode_ref(q, k, v, total_len, 0, kvp=1,
                                rr_block=rr_block, window=window,
                                slot_offset=rank * k.shape[2], kscale=kscale,
                                vscale=vscale)
    return flash_decode_ref(q, k, v, total_len, rank, kvp=kvp,
                            rr_block=rr_block, window=window, kscale=kscale,
                            vscale=vscale)


def helix_attention(hx: HelixConfig, q, kcache, vcache, total_len, *,
                    window: int = 0, contiguous: bool = False,
                    kscale=None, vscale=None, k_new=None, v_new=None,
                    block_tables=None, groups=None, group=None,
                    hopb_chunks: int = 1):
    """Exact KVP-sharded decode attention, emulated on one card, or across
    ranks with ``group`` (``helix_attention_ranks``; ``hopb_chunks`` is
    read there only).

    q [B, Qh, hsz]; kcache/vcache [B, Kh, S_cap, hsz] (S_cap = kvp * s_loc,
    rank r's shard at slots ``[r*s_loc, (r+1)*s_loc)``); ``total_len`` an
    int or [B] tensor of global lengths including the new token.
    ``kscale``/``vscale`` [B, Kh, S_cap] f32 with int8 caches.
    ``k_new``/``v_new`` [B, Kh, hsz]: fused append (the caller checked
    ``fuse_append_applicable``); the row (int8: payload and scale) lands in
    the cache in place.  ``block_tables`` [B, max_pages] int32: the paged
    pool, ``kcache``/``vcache`` pool planes ``[n_pool, Kh, kvp * rr, hsz]``
    (scales without hsz); excludes ``contiguous``.  ``groups`` (paged):
    the grouped decode's ``(group_id, group_np)`` [B] int32 pair.
    Returns [B, helix_out_dim(Qh*hsz, kvp)] in q.dtype.
    """
    if group is not None:
        if contiguous or kscale is not None or block_tables is not None:
            raise ValueError("across ranks helix_attention takes the fixed "
                             "fp layout (contiguous, int8 and paged are not "
                             "ported)")
        return helix_attention_ranks(hx, group, q, kcache, vcache, total_len,
                                     window=window, k_new=k_new, v_new=v_new,
                                     hopb_chunks=hopb_chunks)
    if hx.tpa != 1:
        raise ValueError(f"tpa={hx.tpa} needs a rank group (the emulated "
                         "path is pure KVP)")
    b, qh, hsz = q.shape
    kvp = hx.kvp
    if block_tables is not None and contiguous:
        raise ValueError("the paged pool excludes the contiguous layout")
    if groups is not None and block_tables is None:
        raise ValueError("grouped decode needs the paged pool")
    if hx.attn_backend == "cuda":
        outs, lses = flash_decode_shards(
            q, kcache, vcache, total_len, kvp=kvp, n_ranks=kvp, rank=0,
            rr_block=hx.rr_block, window=window, block_s=hx.attn_block_s,
            contiguous=contiguous, kscale=kscale, vscale=vscale,
            k_new=k_new, v_new=v_new, prune=hx.prune_blocks,
            block_tables=block_tables, groups=groups)
    else:
        if k_new is not None:
            raise ValueError("fused append requires the cuda backend")
        s_loc = kcache.shape[2] // kvp

        def shard(x, r):
            if x is None:
                return None
            x = x[:, :, r * s_loc:(r + 1) * s_loc]
            # paged: this rank's rows of every page, gathered per request
            return x if block_tables is None else gather_pages(x,
                                                               block_tables)

        res = [_local_attend(q, shard(kcache, r), shard(vcache, r),
                             total_len, r, kvp=kvp, rr_block=hx.rr_block,
                             window=window, contiguous=contiguous,
                             kscale=shard(kscale, r), vscale=shard(vscale, r))
               for r in range(kvp)]
        outs = torch.stack([o for o, _ in res])
        lses = torch.stack([l for _, l in res])
    # the all-to-all slices the flat (Qh*hsz) dim into kvp pieces; pad lanes
    # carry clamped head indices and zero values (exact)
    d_flat = qh * hsz
    d_pad = helix_out_dim(d_flat, kvp)
    flat = outs.reshape(kvp, b, d_flat)
    if d_pad != d_flat:
        flat = torch.nn.functional.pad(flat, (0, d_pad - d_flat))
    sl = d_pad // kvp
    frags = flat.reshape(kvp, b, kvp, sl)                # [src, B, dst, sl]
    # head of each flat element, made on the device (no copy per layer)
    heads = torch.clamp(torch.arange(d_pad, device=q.device) // hsz,
                        max=qh - 1)
    out = combine_fragments(frags, lses, heads.reshape(kvp, sl))
    return out.reshape(b, d_pad)


def _attend_rank(hx: HelixConfig, k: int, q, kcache, vcache, total_len, *,
                 window, k_new, v_new):
    """KVP rank k's partial attention over its local shard: ``(out [B, Qh,
    hsz], lse [B, Qh])``; one kernel launch on the ``cuda`` backend."""
    if hx.attn_backend == "cuda":
        outs, lses = flash_decode_shards(
            q, kcache, vcache, total_len, kvp=hx.kvp, n_ranks=1, rank=k,
            rr_block=hx.rr_block, window=window, block_s=hx.attn_block_s,
            k_new=k_new, v_new=v_new, prune=hx.prune_blocks)
        return outs[0], lses[0]
    if k_new is not None:
        raise ValueError("fused append requires the cuda backend")
    return _local_attend(q, kcache, vcache, total_len, k, kvp=hx.kvp,
                         rr_block=hx.rr_block, window=window,
                         contiguous=False)


def helix_attention_ranks(hx: HelixConfig, group, q, kcache, vcache,
                          total_len, *, window: int = 0, k_new=None,
                          v_new=None, hopb_chunks: int = 1):
    """Helix decode attention of one rank (module doc).  q [B, Qh/tpa, hsz]
    (the rank's TPA heads); kcache/vcache [B, Kh/tpa, s_loc, hsz], the
    rank's shard; ``total_len`` an int or [B] tensor of global lengths
    including the new token; ``k_new``/``v_new`` [B, Kh/tpa, hsz]: the
    fused append.  Returns the rank's slice [B, sl] of the flat dim padded
    to ``helix_out_dim(Qh/tpa * hsz, kvp)``, ``sl`` = that / kvp: flat
    positions ``[k*sl, (k+1)*sl)`` of TPA group t's heads."""
    b, qh, hsz = q.shape
    kvp = group.kvp
    if (hx.kvp, hx.tpa) != (kvp, group.tpa):
        raise ValueError(f"hx is kvp {hx.kvp} x tpa {hx.tpa}, the group "
                         f"{kvp} x {group.tpa}")
    d_flat = qh * hsz
    d_pad = helix_out_dim(d_flat, kvp)
    sl = d_pad // kvp
    heads = torch.clamp(torch.arange(d_pad, device=q.device) // hsz,
                        max=qh - 1).reshape(kvp, sl)[group.k]
    chunks = hopb_chunks if hopb_chunks > 1 and b % hopb_chunks == 0 else 1
    bc = b // chunks
    tl = torch.as_tensor(total_len, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b)
    pending = []
    for i in range(chunks):
        rows = slice(i * bc, (i + 1) * bc)
        out, lse = _attend_rank(
            hx, group.k, q[rows], kcache[rows], vcache[rows], tl[rows],
            window=window, k_new=None if k_new is None else k_new[rows],
            v_new=None if v_new is None else v_new[rows])
        flat = torch.nn.functional.pad(out.reshape(bc, d_flat),
                                       (0, d_pad - d_flat))
        frags = flat.reshape(bc, kvp, sl).transpose(0, 1)   # [dst, B, sl]
        # chunk i's collectives fly while chunk i+1 attends (HOP-B)
        pending.append((group.all_to_all(frags, async_op=True),
                        group.all_gather(lse, async_op=True)))
    outs = [combine_fragments(f.wait(), l.wait(), heads) for f, l in pending]
    return outs[0] if chunks == 1 else torch.cat(outs)


def paged_slot_of_position(pos, block_tables, *, kvp: int, rr_block: int,
                           page: int):
    """(physical page [B], in-page row [B]) holding global position ``pos``
    (an int or [B] tensor): position p lives on rank ``r = (p//rr) % kvp``
    at local slot j, i.e. logical page ``j // ps`` at row ``r*ps + j % ps``
    (``ps = page / kvp``).  Negative positions (idle rows) clamp to logical
    page 0, whose table entry is the sink page."""
    pos = torch.as_tensor(pos, dtype=torch.int64, device=block_tables.device)
    ps = page // kvp
    blk = pos // rr_block
    rank = blk % kvp
    j = (blk // kvp) * rr_block + pos % rr_block
    lpage = torch.clamp(j // ps, 0, block_tables.shape[1] - 1)
    row = rank * ps + j % ps
    b = block_tables.shape[0]
    phys = block_tables[torch.arange(b, device=block_tables.device),
                        lpage.expand(b)]
    return phys.long(), row.expand(b)


def append_kv(kcache, vcache, k_new, v_new, total_len, *, kvp: int,
              rr_block: int, block_tables=None):
    """Round-robin KV append (§2.3), in place.  kcache [B, Kh, S_cap, hsz];
    k_new [B, Kh, hsz] for the token at position ``total_len - 1``
    (``total_len`` an int or a [B] tensor).  Paged (``block_tables``): the
    caches are pool planes ``[n_pool, Kh, page, hsz]`` and the row goes to
    the page and row ``paged_slot_of_position`` names (idle rows of length
    0 land on the sink page)."""
    tl = torch.as_tensor(total_len, dtype=torch.int64, device=kcache.device)
    if block_tables is not None:
        phys, row = paged_slot_of_position(tl - 1, block_tables, kvp=kvp,
                                           rr_block=rr_block,
                                           page=kcache.shape[2])
        kcache[phys, :, row] = k_new.to(kcache.dtype)
        vcache[phys, :, row] = v_new.to(vcache.dtype)
        return kcache, vcache
    s_loc = kcache.shape[2] // kvp
    slot = rr_slot_of_position(tl - 1, kvp, s_loc, rr_block)
    if slot.ndim == 0:
        kcache[:, :, slot] = k_new.to(kcache.dtype)
        vcache[:, :, slot] = v_new.to(vcache.dtype)
    else:
        rows = torch.arange(kcache.shape[0], device=kcache.device)
        kcache[rows, :, slot] = k_new.to(kcache.dtype)
        vcache[rows, :, slot] = v_new.to(vcache.dtype)
    return kcache, vcache


def append_kv_quant(kcache, vcache, kscale, vscale, k_new, v_new, total_len,
                    *, kvp: int, rr_block: int, block_tables=None):
    """int8 round-robin KV append, in place: quantize the new token per
    (B, Kh) and write payload and scale at its round-robin slot (paged:
    through ``block_tables``, like ``append_kv``).  kscale [B, Kh, S_cap]
    f32 (paged: ``[n_pool, Kh, page]``).  Returns the four updated
    tensors."""
    kq, ks = quantize_kv_token(k_new)
    vq, vs = quantize_kv_token(v_new)
    kw = dict(kvp=kvp, rr_block=rr_block, block_tables=block_tables)
    append_kv(kcache, vcache, kq, vq, total_len, **kw)
    # the scale planes as caches of width-1 rows: the same slot, in place
    append_kv(kscale[..., None], vscale[..., None], ks[..., None],
              vs[..., None], total_len, **kw)
    return kcache, vcache, kscale, vscale


def prefill_to_rr_layout(cache, kvp: int, rr_block: int):
    """[B, Kh, S, hsz] contiguous-position cache -> round-robin slot layout
    (S a multiple of kvp*rr_block): block i of rr_block positions goes to
    rank i % kvp, local block i // kvp."""
    b, kh, s, hsz = cache.shape
    nblk = s // rr_block
    if nblk % kvp or s % rr_block:
        raise ValueError(f"S={s} is not a multiple of kvp*rr={kvp * rr_block}")
    c = cache.reshape(b, kh, nblk // kvp, kvp, rr_block, hsz)
    return c.permute(0, 1, 3, 2, 4, 5).reshape(b, kh, s, hsz)
