"""Wrapper of the flash_decode CUDA kernel (``csrc/flash_decode.cu``), the
port of the reference's ``kernels/flash_decode/ops.py``: per-request
lengths, window, ``slot_offset``, round-robin or contiguous layout, block
pruning on/off, the fused KV append, int8 K/V with per-slot f32 scales
(``kscale``/``vscale``), where the fused append quantizes the new row in the
kernel, and the paged mode (``block_tables``: K/V in shared pool pages).

``flash_decode_shards`` is the kernel's full interface: it attends over
``n_ranks`` consecutive KVP shards of one cache in ONE launch (the rank is a
grid dimension), which is how ``core/helix.py`` emulates KVP on one card.
``flash_decode`` is the single-shard public API with the reference's
signature.

Tensors on the CPU take the plain version (``ref.flash_decode_ref`` per
shard plus the same append rule; paged: the append through the table, then
``gather_pages``); CUDA tensors launch the kernel or raise.
Unlike the reference (immutable arrays, aliased outputs), the fused append
writes the new K/V row (and, int8, its scales) into the cache tensors **in
place**.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import (flash_decode_ref,
                                                  gather_pages,
                                                  quantize_kv_token)
from repro_torch.kernels.pruning import append_owner, append_slot
from repro_torch.utils import round_up

counter = build.Launches()         # every launch of the kernel
counter_kv8 = build.Launches()     # the launches in int8 mode among them
counter_paged = build.Launches()   # the launches in paged mode among them
TILE_S = 32                 # slots per shared-memory tile inside the kernel
MAX_G = 8                   # query heads per KV head the kernel holds
HSZ = (32, 64, 128)         # head sizes the kernel is compiled for

_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind(lib):
    fn = lib.flash_decode_launch
    fn.argtypes = [_P] * 11 + [_I] * 19 + [ctypes.c_float, _P]
    fn.restype = _I
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return fn


def kernel_block_s(block_s: int, s_loc: int) -> int:
    """S-block size the kernel prunes with: the requested block clamped to
    the shard capacity rounded up to 128, as in the reference wrapper."""
    return min(block_s, round_up(s_loc, 128))


def flash_decode_shards(q, k, v, total_len, *, kvp: int, n_ranks: int = 1,
                        rank: int = 0, rr_block: int = 16, window: int = 0,
                        scale: float | None = None, block_s: int = 512,
                        contiguous: bool = False, slot_offset: int = 0,
                        kscale=None, vscale=None, k_new=None, v_new=None,
                        prune: bool = True, block_tables=None):
    """Decode attention over ``n_ranks`` KVP shards in one call.

    q [B, Qh, hsz]; k, v [B, Kh, n_ranks * s_loc, hsz]: shard z holds slots
    ``[z*s_loc, (z+1)*s_loc)`` and is KVP rank ``rank + z``.  ``total_len``
    is an int or a [B] int tensor (global lengths including the new token).
    ``k_new``/``v_new`` [B, Kh, hsz] engage the fused append: the owner rank
    of position ``total_len - 1`` writes the row into its shard in place and
    attends over it.  ``kscale``/``vscale`` [B, Kh, n_ranks * s_loc] f32
    with int8 ``k``/``v``: the int8 mode (the fused append then quantizes
    the row and writes its payload and scale).

    Paged mode (``block_tables`` [B, max_pages] int32): k, v are pool planes
    ``[n_pool, Kh, n_ranks * ps, hsz]`` (scales ``[n_pool, Kh, n_ranks *
    ps]``) and shard z holds rows ``[z*ps, (z+1)*ps)`` of every page:
    request b's logical slot j of shard z lives in page
    ``block_tables[b, j // ps]`` at row ``z*ps + j % ps``, and the logical
    capacity per shard is ``s_loc = max_pages * ps``.  Table entries past a
    request's pages must be 0 (the sink page).  Excludes the contiguous
    layout and a non-zero ``slot_offset``.

    Returns ``out [R, B, Qh, hsz]`` (q.dtype) and ``lse [R, B, Qh]`` (f32).
    """
    b, qh, hsz = q.shape
    kh = k.shape[1]
    if qh % kh or k.shape[2] % n_ranks:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"n_ranks {n_ranks}")
    append = k_new is not None
    if append and (v_new is None or contiguous):
        raise ValueError("fused append needs k_new and v_new and excludes "
                         "the contiguous layout")
    if (kscale is None) != (vscale is None):
        raise ValueError("the int8 mode needs both kscale and vscale")
    if scale is None:
        scale = float(hsz) ** -0.5
    s_loc = k.shape[2] // n_ranks
    if block_tables is not None:
        if contiguous or slot_offset != 0:
            raise ValueError("the paged mode excludes the contiguous layout "
                             "and a non-zero slot_offset")
        if block_tables.ndim != 2 or block_tables.shape[0] != b:
            raise ValueError(f"block_tables must be [B={b}, max_pages] (got "
                             f"{tuple(block_tables.shape)})")
        s_loc *= block_tables.shape[1]
    block_s = kernel_block_s(block_s, s_loc)
    if build.route(q, k, v, kscale, vscale, k_new, v_new,
                   block_tables) == "plain":
        return flash_decode_shards_plain(
            q, k, v, total_len, kvp=kvp, n_ranks=n_ranks, rank=rank,
            rr_block=rr_block, window=window, scale=scale, block_s=block_s,
            contiguous=contiguous, slot_offset=slot_offset, kscale=kscale,
            vscale=vscale, k_new=k_new, v_new=v_new,
            block_tables=block_tables)
    return _launch(q, k, v, total_len, kvp=kvp, n_ranks=n_ranks, rank=rank,
                   rr_block=rr_block, window=window, scale=scale,
                   block_s=block_s, contiguous=contiguous,
                   slot_offset=slot_offset, kscale=kscale, vscale=vscale,
                   k_new=k_new, v_new=v_new, prune=prune,
                   block_tables=block_tables)


def flash_decode(q, k, v, total_len, rank, *, kvp: int = 1,
                 rr_block: int = 16, window: int = 0,
                 scale: float | None = None, block_s: int = 512,
                 contiguous: bool = False, slot_offset: int = 0,
                 kscale=None, vscale=None, k_new=None, v_new=None,
                 prune: bool = True, block_tables=None):
    """Decode attention over one KV shard (the reference's
    ``flash_decode`` signature; paged: ``k``/``v`` are the rank's pool
    planes ``[n_pool, Kh, ps, hsz]``).  Returns ``(out [B, Qh, hsz], lse
    [B, Qh])`` and, with ``k_new``/``v_new``, also the caches ``(k, v)`` the
    row was appended to in place (and, int8, the scales ``(kscale,
    vscale)``)."""
    out, lse = flash_decode_shards(
        q, k, v, total_len, kvp=kvp, n_ranks=1, rank=rank, rr_block=rr_block,
        window=window, scale=scale, block_s=block_s, contiguous=contiguous,
        slot_offset=slot_offset, kscale=kscale, vscale=vscale, k_new=k_new,
        v_new=v_new, prune=prune, block_tables=block_tables)
    if k_new is None:
        return out[0], lse[0]
    if kscale is None:
        return out[0], lse[0], k, v
    return out[0], lse[0], k, v, kscale, vscale


def flash_decode_shards_plain(q, k, v, total_len, *, kvp, n_ranks, rank,
                              rr_block, window, scale, block_s, contiguous,
                              slot_offset, k_new, v_new, kscale=None,
                              vscale=None, block_tables=None):
    """Plain PyTorch version of the kernel behind ``flash_decode_shards``
    (any device): the append rule of the kernel (int8: ``quantize_kv_token``
    payload and scale), then ``flash_decode_ref`` per shard.  ``block_s`` is
    the kernel's S-block (it bounds the slot the append may clamp to).
    Paged: the append through the table, then ``gather_pages`` into the
    dense per-request shards the fixed layout would hold."""
    quant = kscale is not None
    b = q.shape[0]
    tl = torch.as_tensor(total_len, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b)
    if block_tables is not None:
        if k_new is not None:
            _append_paged(k, v, kscale, vscale, k_new, v_new, tl,
                          block_tables, kvp=kvp, n_ranks=n_ranks, rank=rank,
                          rr_block=rr_block, block_s=block_s)
        dense = [None if x is None else _dense_shards(x, block_tables, n_ranks)
                 for x in (k, v, kscale, vscale)]
        return flash_decode_shards_plain(
            q, dense[0], dense[1], tl, kvp=kvp, n_ranks=n_ranks, rank=rank,
            rr_block=rr_block, window=window, scale=scale, block_s=block_s,
            contiguous=False, slot_offset=0, k_new=None, v_new=None,
            kscale=dense[2], vscale=dense[3])
    s_loc = k.shape[2] // n_ranks
    if k_new is not None:
        j_new = append_slot(tl.cpu(), kvp, rr_block,
                            round_up(s_loc, block_s)).to(q.device)
        owner = append_owner(tl.cpu(), kvp, rr_block).to(q.device)
        if quant:
            kq, ksn = quantize_kv_token(k_new)
            vq, vsn = quantize_kv_token(v_new)
    outs, lses = [], []
    for z in range(n_ranks):
        r = rank + z
        ks = k[:, :, z * s_loc:(z + 1) * s_loc]
        vs = v[:, :, z * s_loc:(z + 1) * s_loc]
        sc = {}
        if quant:
            sc = dict(kscale=kscale[:, :, z * s_loc:(z + 1) * s_loc],
                      vscale=vscale[:, :, z * s_loc:(z + 1) * s_loc])
        if k_new is not None:
            rows = torch.nonzero((owner == r) & (j_new < s_loc)).flatten()
            if quant:
                ks[rows, :, j_new[rows]] = kq[rows]
                vs[rows, :, j_new[rows]] = vq[rows]
                sc["kscale"][rows, :, j_new[rows]] = ksn[rows]
                sc["vscale"][rows, :, j_new[rows]] = vsn[rows]
            else:
                ks[rows, :, j_new[rows]] = k_new[rows].to(k.dtype)
                vs[rows, :, j_new[rows]] = v_new[rows].to(v.dtype)
        if contiguous:
            o, l = flash_decode_ref(q, ks, vs, tl, 0, kvp=1, rr_block=rr_block,
                                    window=window, scale=scale,
                                    slot_offset=r * s_loc + slot_offset, **sc)
        else:
            o, l = flash_decode_ref(q, ks, vs, tl, r, kvp=kvp,
                                    rr_block=rr_block, window=window,
                                    scale=scale, slot_offset=slot_offset, **sc)
        outs.append(o)
        lses.append(l)
    return torch.stack(outs), torch.stack(lses)


def _dense_shards(pool, block_tables, n_ranks: int):
    """Pool plane ``[n_pool, Kh, n_ranks * ps, ...]`` -> the dense caches
    ``[B, Kh, n_ranks * max_pages * ps, ...]`` of the fixed layout (shard z
    at slots ``[z*s_loc, (z+1)*s_loc)``), gathered through the tables."""
    g = gather_pages(pool, block_tables)      # [B, Kh, MP * n_ranks * ps, ..]
    b, kh, mp = g.shape[0], g.shape[1], block_tables.shape[1]
    ps = pool.shape[2] // n_ranks
    g = g.reshape(b, kh, mp, n_ranks, ps, *pool.shape[3:])
    return g.transpose(2, 3).reshape(b, kh, n_ranks * mp * ps,
                                     *pool.shape[3:])


def _append_paged(k, v, kscale, vscale, k_new, v_new, tl, block_tables, *,
                  kvp, n_ranks, rank, rr_block, block_s):
    """The kernel's fused append in paged mode, in place: the logical slot
    and owner rank of the fixed layout (``append_slot``, ``append_owner``),
    translated through the table to (page, row) as ``core.helix.
    paged_slot_of_position`` does for every position >= 0."""
    ps = k.shape[2] // n_ranks
    s_loc = block_tables.shape[1] * ps
    dev = k.device
    j_new = append_slot(tl.cpu(), kvp, rr_block,
                        round_up(s_loc, block_s)).to(dev)
    owner = append_owner(tl.cpu(), kvp, rr_block).to(dev)
    rows = torch.nonzero((owner >= rank) & (owner < rank + n_ranks)
                         & (j_new < s_loc)).flatten()
    j = j_new[rows].long()
    page = block_tables[rows, j // ps].long()
    row = (owner[rows].long() - rank) * ps + j % ps
    if kscale is not None:
        kq, ksn = quantize_kv_token(k_new[rows])
        vq, vsn = quantize_kv_token(v_new[rows])
        k[page, :, row] = kq
        v[page, :, row] = vq
        kscale[page, :, row] = ksn
        vscale[page, :, row] = vsn
    else:
        k[page, :, row] = k_new[rows].to(k.dtype)
        v[page, :, row] = v_new[rows].to(v.dtype)


def _launch(q, k, v, total_len, *, kvp, n_ranks, rank, rr_block, window, scale,
            block_s, contiguous, slot_offset, kscale, vscale, k_new, v_new,
            prune, block_tables):
    b, qh, hsz = q.shape
    kh = k.shape[1]
    g = qh // kh
    code = build.dtype_code(q.dtype)
    quant = kscale is not None
    paged = block_tables is not None
    if paged and not (block_tables.dtype == torch.int32
                      and block_tables.is_contiguous()):
        raise ValueError("block_tables must be a contiguous int32 tensor "
                         f"(got {block_tables.dtype})")
    if quant:
        if not (k.dtype == v.dtype == torch.int8):
            raise ValueError(f"the int8 mode takes int8 k/v (got {k.dtype} "
                             f"{v.dtype})")
        if not (kscale.dtype == vscale.dtype == torch.float32
                and kscale.shape == vscale.shape == k.shape[:3]
                and kscale.is_contiguous() and vscale.is_contiguous()):
            raise ValueError("kscale/vscale must be contiguous float32 "
                             f"{tuple(k.shape[:3])}")
        if k_new is not None and not (k_new.dtype == v_new.dtype == q.dtype):
            raise ValueError(f"k_new/v_new must have q's dtype {q.dtype}")
    elif not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if hsz not in HSZ or g > MAX_G or block_s % TILE_S:
        raise ValueError(f"flash_decode kernel takes hsz in {HSZ}, "
                         f"Qh/Kh <= {MAX_G} and block_s % {TILE_S} == 0 "
                         f"(got hsz {hsz}, G {g}, block_s {block_s})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode kernel needs contiguous q/k/v")
    if k_new is not None:
        k_new = k_new.to(q.dtype).contiguous()
        v_new = v_new.to(q.dtype).contiguous()
    tl = torch.as_tensor(total_len, dtype=torch.int32, device=q.device)
    tl = tl.reshape(-1).expand(b).contiguous()
    out = torch.empty((n_ranks, b, qh, hsz), dtype=q.dtype, device=q.device)
    lse = torch.empty((n_ranks, b, qh), dtype=torch.float32, device=q.device)
    ps = k.shape[2] // n_ranks
    max_pages = block_tables.shape[1] if paged else 0
    s_loc = max_pages * ps if paged else ps
    lib = build.load("flash_decode")
    rc = _bind(lib)(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(k_new),
        build.ptr(v_new), build.ptr(tl), build.ptr(out), build.ptr(lse),
        build.ptr(kscale), build.ptr(vscale), build.ptr(block_tables), code,
        int(quant), b, kh, g, hsz, s_loc, n_ranks, rank, kvp, rr_block,
        block_s, slot_offset, window, int(contiguous), int(prune),
        int(k_new is not None), max_pages, ps, float(scale), build.stream())
    build.check(rc, lib, "flash_decode")
    counter.n += 1
    counter_kv8.n += int(quant)
    counter_paged.n += int(paged)
    return out, lse
