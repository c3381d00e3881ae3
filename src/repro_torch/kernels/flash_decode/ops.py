"""Wrapper of the flash_decode CUDA kernel (``csrc/flash_decode.cu``), the
port of the reference's ``kernels/flash_decode/ops.py``: per-request
lengths, window, ``slot_offset``, round-robin or contiguous layout, block
pruning on/off, the fused KV append, int8 K/V with per-slot f32 scales
(``kscale``/``vscale``), where the fused append quantizes the new row in the
kernel, the paged mode (``block_tables``: K/V in shared pool pages) and the
grouped shared-prefix decode (``groups``: the ``prefix_pass`` kernel of
``csrc/prefix_pass.cu``, then the decode kernel's grouped-suffix mode).

``flash_decode_shards`` is the kernel's full interface: it attends over
``n_ranks`` consecutive KVP shards of one cache in ONE launch (the rank is a
grid dimension), which is how ``core/helix.py`` emulates KVP on one card.
``flash_decode`` is the single-shard public API with the reference's
signature.

Tensors on the CPU take the plain version (``flash_decode_shards_plain``:
the same append rule, then the kernels' online softmax over 32-slot tiles,
``ref.sweep_tiles``; paged: the append through the table, then
``gather_pages``); CUDA tensors launch the kernels or raise.
Unlike the reference (immutable arrays, aliased outputs), the fused append
writes the new K/V row (and, int8, its scales) into the cache tensors **in
place**.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import (TILE_S, cold_state,
                                                  finish_rows, gather_pages,
                                                  quantize_kv_token,
                                                  shard_positions,
                                                  sweep_tiles)
from repro_torch.kernels.pruning import append_owner, append_slot
from repro_torch.utils import round_up

counter = build.Launches()         # every launch of the kernel
counter_kv8 = build.Launches()     # the launches in int8 mode among them
counter_paged = build.Launches()   # the launches in paged mode among them
counter_grouped = build.Launches()  # ... in the grouped-suffix mode among them
counter_prefix = build.Launches()   # launches of the prefix_pass kernel
MAX_G = 8                   # query heads per KV head the kernel holds
HSZ = (32, 64, 128)         # head sizes the kernel is compiled for
SMEM_MAX = 232448           # shared memory one block may take (H100)

_P, _I = ctypes.c_void_p, ctypes.c_int


def _bind(lib, name: str, n_ptr: int, n_int: int):
    fn = getattr(lib, name)
    fn.argtypes = [_P] * n_ptr + [_I] * n_int + [ctypes.c_float, _P]
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
                        prune: bool = True, block_tables=None, groups=None,
                        prefix_state=None):
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

    Grouped shared-prefix decode (``groups = (group_id [B], group_np [B])``
    int32, paged only; the reference's ``flash_decode(groups=)``): rows
    with the same ``group_id`` and ``group_np > 0`` share their leading
    ``group_np`` pages.  The prefix pass sweeps the whole 32-slot tiles
    below ``group_np * ps`` once per group for all its members' query rows;
    each row's decode resumes that raw state and sweeps only the tiles at
    or above it.  Bit for bit the result of ``groups=None``.  The shared
    pages must hold no slot the fused append writes (the engine caps
    ``group_np`` at each member's committed pages).  ``prefix_state``: the
    ``prefix_pass`` result to resume, when the caller ran it already.

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
    elif groups is not None:
        raise ValueError("grouped decode needs the paged mode "
                         "(block_tables)")
    block_s = kernel_block_s(block_s, s_loc)
    if build.route(q, k, v, kscale, vscale, k_new, v_new, block_tables,
                   *(groups or ())) == "plain":
        return flash_decode_shards_plain(
            q, k, v, total_len, kvp=kvp, n_ranks=n_ranks, rank=rank,
            rr_block=rr_block, window=window, scale=scale, block_s=block_s,
            contiguous=contiguous, slot_offset=slot_offset, kscale=kscale,
            vscale=vscale, k_new=k_new, v_new=v_new,
            block_tables=block_tables, groups=groups,
            prefix_state=prefix_state)
    return _launch(q, k, v, total_len, kvp=kvp, n_ranks=n_ranks, rank=rank,
                   rr_block=rr_block, window=window, scale=scale,
                   block_s=block_s, contiguous=contiguous,
                   slot_offset=slot_offset, kscale=kscale, vscale=vscale,
                   k_new=k_new, v_new=v_new, prune=prune,
                   block_tables=block_tables, groups=groups,
                   prefix_state=prefix_state)


def prefix_pass(q, k, v, total_len, block_tables, group_id, group_np, *,
                kvp: int, n_ranks: int = 1, rank: int = 0,
                rr_block: int = 16, window: int = 0,
                scale: float | None = None, kscale=None, vscale=None):
    """The shared-prefix pass of grouped decode on its own (the reference's
    ``prefix_pass_kernel`` with its wrapper's gather and scatter): operands
    as in ``flash_decode_shards``' paged mode, ``group_id``/``group_np``
    [B] int32.  Returns each row's raw state ``(acc [R, B, Kh, G, hsz], m,
    l [R, B, Kh, G])`` f32 over the ``R = n_ranks`` shards; it is defined
    for the rows of groups whose split ``group_np * ps // 32`` is > 0,
    the only rows the grouped decode resumes (the plain version gives the
    cold state elsewhere)."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if build.route(q, k, v, kscale, vscale, block_tables, group_id,
                   group_np) == "plain":
        return prefix_pass_plain(q, k, v, total_len, block_tables, group_id,
                                 group_np, kvp=kvp, n_ranks=n_ranks,
                                 rank=rank, rr_block=rr_block, window=window,
                                 scale=scale, kscale=kscale, vscale=vscale)
    tl = torch.as_tensor(total_len, dtype=torch.int32, device=q.device)
    tl = tl.reshape(-1).expand(q.shape[0]).contiguous()
    return _launch_prefix(q, k, v, kscale, vscale, tl, block_tables,
                          group_id, group_np, kvp=kvp, n_ranks=n_ranks,
                          rank=rank, rr_block=rr_block, window=window,
                          scale=scale)


def flash_decode(q, k, v, total_len, rank, *, kvp: int = 1,
                 rr_block: int = 16, window: int = 0,
                 scale: float | None = None, block_s: int = 512,
                 contiguous: bool = False, slot_offset: int = 0,
                 kscale=None, vscale=None, k_new=None, v_new=None,
                 prune: bool = True, block_tables=None, groups=None):
    """Decode attention over one KV shard (the reference's
    ``flash_decode`` signature; paged: ``k``/``v`` are the rank's pool
    planes ``[n_pool, Kh, ps, hsz]``; ``groups``: the grouped decode).  Returns ``(out [B, Qh, hsz], lse
    [B, Qh])`` and, with ``k_new``/``v_new``, also the caches ``(k, v)`` the
    row was appended to in place (and, int8, the scales ``(kscale,
    vscale)``)."""
    out, lse = flash_decode_shards(
        q, k, v, total_len, kvp=kvp, n_ranks=1, rank=rank, rr_block=rr_block,
        window=window, scale=scale, block_s=block_s, contiguous=contiguous,
        slot_offset=slot_offset, kscale=kscale, vscale=vscale, k_new=k_new,
        v_new=v_new, prune=prune, block_tables=block_tables, groups=groups)
    if k_new is None:
        return out[0], lse[0]
    if kscale is None:
        return out[0], lse[0], k, v
    return out[0], lse[0], k, v, kscale, vscale


def flash_decode_shards_plain(q, k, v, total_len, *, kvp, n_ranks, rank,
                              rr_block, window, scale, block_s, contiguous,
                              slot_offset, k_new, v_new, kscale=None,
                              vscale=None, block_tables=None, groups=None,
                              prefix_state=None):
    """Plain PyTorch version of the kernels behind ``flash_decode_shards``
    (any device), in their arithmetic order: the append rule of the kernel
    (int8: ``quantize_kv_token`` payload and scale), then per shard the
    online softmax over tiles of ``TILE_S`` slots (``ref.sweep_tiles``).
    ``block_s`` is the kernel's S-block (it bounds the slot the append may
    clamp to).  Paged: the append through the table, then ``gather_pages``
    into the dense per-request shards the fixed layout would hold.
    Grouped (``groups``): ``prefix_pass_plain`` over the shared tiles
    (unless ``prefix_state`` holds its result), then each row resumes its
    state above its split tile."""
    quant = kscale is not None
    b = q.shape[0]
    tl = torch.as_tensor(total_len, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b)
    state = prefix_state
    if block_tables is not None:
        if k_new is not None:
            _append_paged(k, v, kscale, vscale, k_new, v_new, tl,
                          block_tables, kvp=kvp, n_ranks=n_ranks, rank=rank,
                          rr_block=rr_block, block_s=block_s)
        if groups is not None and state is None:
            state = prefix_pass_plain(
                q, k, v, tl, block_tables, *groups, kvp=kvp, n_ranks=n_ranks,
                rank=rank, rr_block=rr_block, window=window, scale=scale,
                kscale=kscale, vscale=vscale)
        dense = [None if x is None else _dense_shards(x, block_tables, n_ranks)
                 for x in (k, v, kscale, vscale)]
        k, v, kscale, vscale = dense
        k_new = None
    elif groups is not None:
        raise ValueError("grouped decode needs the paged mode")
    s_loc = k.shape[2] // n_ranks
    if k_new is not None:
        j_new = append_slot(tl.cpu(), kvp, rr_block,
                            round_up(s_loc, block_s)).to(q.device)
        owner = append_owner(tl.cpu(), kvp, rr_block).to(q.device)
        if quant:
            kq, ksn = quantize_kv_token(k_new)
            vq, vsn = quantize_kv_token(v_new)
    split = None
    if groups is not None:
        ps = s_loc // block_tables.shape[1]
        split = groups[1].to(q.device).long() * ps // TILE_S * TILE_S
    outs, lses = [], []
    for z in range(n_ranks):
        r = rank + z
        sl = slice(z * s_loc, (z + 1) * s_loc)
        ks, vs = k[:, :, sl], v[:, :, sl]
        if k_new is not None:
            rows = torch.nonzero((owner == r) & (j_new < s_loc)).flatten()
            if quant:
                ks[rows, :, j_new[rows]] = kq[rows]
                vs[rows, :, j_new[rows]] = vq[rows]
                kscale[:, :, sl][rows, :, j_new[rows]] = ksn[rows]
                vscale[:, :, sl][rows, :, j_new[rows]] = vsn[rows]
            else:
                ks[rows, :, j_new[rows]] = k_new[rows].to(k.dtype)
                vs[rows, :, j_new[rows]] = v_new[rows].to(v.dtype)
        if quant:
            ks = ks.float() * kscale[:, :, sl, None]
            vs = vs.float() * vscale[:, :, sl, None]
        o, l = _sweep_shard(q, ks, vs, tl, r, kvp=kvp, rr_block=rr_block,
                            window=window, scale=scale, contiguous=contiguous,
                            slot_offset=slot_offset, split=split,
                            state=None if state is None
                            else [x[z] for x in state])
        outs.append(o)
        lses.append(l)
    return torch.stack(outs), torch.stack(lses)


def _shard_valid(tl, s_loc: int, rank: int, *, kvp, rr_block, window,
                 contiguous, slot_offset):
    """[B, s_loc] mask of the slots of one shard each row attends to (the
    positions of ``flash_decode_ref``)."""
    if contiguous:
        pos = shard_positions(s_loc, 0, 1, rr_block, rank * s_loc + slot_offset,
                              device=tl.device)
    else:
        pos = shard_positions(s_loc, rank, kvp, rr_block, slot_offset,
                              device=tl.device)
    tl = tl.reshape(-1, 1)
    valid = pos[None] < tl
    if window > 0:
        valid = valid & (pos[None] >= tl - window)
    return valid


def _sweep_shard(q, k, v, tl, rank, *, kvp, rr_block, window, scale,
                 contiguous, slot_offset, split=None, state=None):
    """One shard [B, Kh, s_loc, hsz] (float) of the plain decode: returns
    ``(out [B, Qh, hsz], lse [B, Qh])``.  ``split`` [B] (grouped suffix):
    row b sweeps only slots >= split[b] and starts from ``state`` (acc [B,
    Kh, G, hsz], m, l [B, Kh, G])."""
    b, qh, hsz = q.shape
    kh, s_loc = k.shape[1], k.shape[2]
    g = qh // kh
    valid = _shard_valid(tl, s_loc, rank, kvp=kvp, rr_block=rr_block,
                         window=window, contiguous=contiguous,
                         slot_offset=slot_offset)
    if split is not None:
        valid = valid & (torch.arange(s_loc, device=q.device)[None]
                         >= split[:, None])
    n = b * kh
    qf = q.float().reshape(n, g, hsz) * scale
    st = (cold_state(n, g, hsz, q.device) if state is None
          else (state[0].reshape(n, g, hsz), state[1].reshape(n, g),
                state[2].reshape(n, g)))
    st = sweep_tiles(qf, k.float().reshape(n, s_loc, hsz),
                     v.float().reshape(n, s_loc, hsz),
                     valid[:, None].expand(b, kh, -1).reshape(n, 1, -1), st)
    out, lse = finish_rows(st, q.dtype)
    return out.reshape(b, qh, hsz), lse.reshape(b, qh)


def prefix_pass_plain(q, k, v, total_len, block_tables, group_id, group_np,
                      *, kvp, n_ranks, rank, rr_block, window, scale,
                      kscale=None, vscale=None):
    """Plain version of the prefix_pass kernel (the reference's
    ``prefix_pass_kernel`` plus the gather and scatter of its wrapper).

    q [B, Qh, hsz]; k, v (and int8 scales) paged pool planes as in
    ``flash_decode_shards``; ``group_id``/``group_np`` [B] int.  For each
    group row g, the members (rows with ``group_id == g`` and ``group_np >
    0``) stack their query rows and sweep the whole tiles below their split
    ``group_np * ps // TILE_S`` through the first member's table, each
    member masked by its own length, window and split.  Returns the raw
    state per row, ``(acc [R, B, Kh, G, hsz], m [R, B, Kh, G], l)`` over
    ``R = n_ranks`` shards; rows of no group keep the cold state."""
    b, qh, hsz = q.shape
    kh = k.shape[1]
    g = qh // kh
    ps = k.shape[2] // n_ranks
    s_loc = block_tables.shape[1] * ps
    tl = torch.as_tensor(total_len, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b)
    acc, m, l = cold_state(n_ranks * b * kh, g, hsz, q.device)
    acc = acc.reshape(n_ranks, b, kh, g, hsz)
    m, l = m.reshape(n_ranks, b, kh, g), l.reshape(n_ranks, b, kh, g)
    gid, gnp = group_id.tolist(), group_np.tolist()
    qf = q.float().reshape(b, kh, g, hsz) * scale
    for g0 in sorted(set(gid)):
        mem = [i for i in range(b) if gid[i] == g0 and gnp[i] > 0]
        msplit = [gnp[i] * ps // TILE_S * TILE_S for i in mem]
        if not mem or max(msplit) == 0:
            continue
        tab = block_tables[mem[0]:mem[0] + 1]
        kd, vd = (_dense_shards(x, tab, n_ranks)[0].float() for x in (k, v))
        if kscale is not None:
            kd = kd * _dense_shards(kscale, tab, n_ranks)[0, ..., None]
            vd = vd * _dense_shards(vscale, tab, n_ranks)[0, ..., None]
        qs = qf[mem].transpose(0, 1).reshape(kh, len(mem) * g, hsz)
        for z in range(n_ranks):
            valid = _shard_valid(tl[mem], s_loc, rank + z, kvp=kvp,
                                 rr_block=rr_block, window=window,
                                 contiguous=False, slot_offset=0)
            valid = valid & (torch.arange(s_loc, device=q.device)[None]
                             < torch.tensor(msplit, device=q.device)[:, None])
            valid = valid.repeat_interleave(g, 0)[None]      # [1, n*G, S]
            sl = slice(z * s_loc, (z + 1) * s_loc)
            st = sweep_tiles(qs, kd[:, sl], vd[:, sl], valid,
                             cold_state(kh, len(mem) * g, hsz, q.device))
            acc[z, mem] = st[0].reshape(kh, len(mem), g, hsz).transpose(0, 1)
            m[z, mem] = st[1].reshape(kh, len(mem), g).transpose(0, 1)
            l[z, mem] = st[2].reshape(kh, len(mem), g).transpose(0, 1)
    return acc, m, l


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
            prune, block_tables, groups, prefix_state):
    b, qh, hsz = q.shape
    kh = k.shape[1]
    g = qh // kh
    code = build.dtype_code(q.dtype)
    quant = kscale is not None
    paged = block_tables is not None
    _check_int32(block_tables=block_tables)
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
    gnp, st = None, (None, None, None)
    if groups is not None:
        _check_int32(group_id=groups[0], group_np=groups[1])
        gnp = groups[1]
        st = prefix_state or _launch_prefix(
            q, k, v, kscale, vscale, tl, block_tables, *groups, kvp=kvp,
            n_ranks=n_ranks, rank=rank, rr_block=rr_block, window=window,
            scale=scale)
        if not all(x.dtype == torch.float32 and x.is_contiguous()
                   and x.shape[:4] == (n_ranks, b, kh, g) for x in st):
            raise ValueError("prefix_state must be contiguous float32 "
                             f"({n_ranks}, {b}, {kh}, {g}, ...) tensors")
    lib = build.load("flash_decode")
    rc = _bind(lib, "flash_decode_launch", 15, 19)(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(k_new),
        build.ptr(v_new), build.ptr(tl), build.ptr(out), build.ptr(lse),
        build.ptr(kscale), build.ptr(vscale), build.ptr(block_tables),
        build.ptr(gnp), *(build.ptr(x) for x in st), code,
        int(quant), b, kh, g, hsz, s_loc, n_ranks, rank, kvp, rr_block,
        block_s, slot_offset, window, int(contiguous), int(prune),
        int(k_new is not None), max_pages, ps, float(scale), build.stream())
    build.check(rc, lib, "flash_decode")
    counter.n += 1
    counter_kv8.n += int(quant)
    counter_paged.n += int(paged)
    counter_grouped.n += int(groups is not None)
    return out, lse


def _check_int32(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and not (t.dtype == torch.int32
                                  and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             f"(got {t.dtype})")


def _launch_prefix(q, k, v, kscale, vscale, tl, tables, gid, gnp, *, kvp,
                   n_ranks, rank, rr_block, window, scale):
    """Launch ``prefix_pass`` (one block per group row, kv head and rank;
    rows leading no group exit at once); returns the members' raw state
    (acc, m, l)."""
    b, qh, hsz = q.shape
    kh = k.shape[1]
    g = qh // kh
    _check_int32(block_tables=tables, group_id=gid, group_np=gnp)
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("prefix_pass kernel needs contiguous q/k/v")
    if hsz not in HSZ:
        raise ValueError(f"prefix_pass kernel takes hsz in {HSZ} (got {hsz})")
    lib = build.load("prefix_pass")
    lib.prefix_pass_smem_bytes.argtypes = [_I, _I, _I]
    lib.prefix_pass_smem_bytes.restype = ctypes.c_long
    need = lib.prefix_pass_smem_bytes(b, g, hsz)
    if need > SMEM_MAX:
        raise ValueError(f"prefix_pass holds B x G = {b * g} query rows in "
                         f"{need} bytes of shared memory; the card has "
                         f"{SMEM_MAX}")
    st = (torch.empty((n_ranks, b, kh, g, hsz), dtype=torch.float32,
                      device=q.device),
          torch.empty((n_ranks, b, kh, g), dtype=torch.float32,
                      device=q.device),
          torch.empty((n_ranks, b, kh, g), dtype=torch.float32,
                      device=q.device))
    ps = k.shape[2] // n_ranks
    rc = _bind(lib, "prefix_pass_launch", 12, 13)(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(kscale),
        build.ptr(vscale), build.ptr(tl), build.ptr(tables), build.ptr(gid),
        build.ptr(gnp), *(build.ptr(x) for x in st), build.dtype_code(q.dtype),
        int(kscale is not None), b, kh, g, hsz, n_ranks, rank, kvp, rr_block,
        window, tables.shape[1], ps, float(scale), build.stream())
    build.check(rc, lib, "prefix_pass")
    counter_prefix.n += 1
    return st
