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

Both kernels split each shard into chunks of ``CHUNK_S`` slots swept by
separate CTAs and fold the chunk partials in order (``csrc/decode_tile.cuh``);
the partials live in a float32 workspace cached here per device and grown
on demand, so a launch allocates nothing but its outputs.  The workspaces
serve one stream at a time.

Tensors on the CPU take the plain version (``flash_decode_shards_plain``:
the same append rule, then the kernels' chunks and tiles, ``ref.
sweep_chunks`` and ``ref.merge_chunks``; paged: the append through the
table, then ``gather_pages``); CUDA tensors launch the kernels or raise.
Unlike the reference (immutable arrays, aliased outputs), the fused append
writes the new K/V row (and, int8, its scales) into the cache tensors **in
place**.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode.ref import (TILE_S, chunk_count,
                                                  cold_state, finish_rows,
                                                  gather_pages, merge_chunks,
                                                  quantize_kv_token,
                                                  shard_positions,
                                                  sweep_chunks)
from repro_torch.kernels.pruning import (CHUNK_S, CHUNK_TILES, append_owner,
                                         append_slot)
from repro_torch.utils import round_up

counter = build.Launches()         # every launch of the kernel
counter_kv8 = build.Launches()     # the launches in int8 mode among them
counter_paged = build.Launches()   # the launches in paged mode among them
counter_grouped = build.Launches()  # ... in the grouped-suffix mode among them
counter_contiguous = build.Launches()  # ... in the contiguous layout among them
counter_prefix = build.Launches()   # launches of the prefix_pass kernel
last_launch = {"chunks_per_cta": 1}  # the decode kernel's last grid choice
MAX_G = 16                  # query heads per KV head the kernel holds
MAX_G_256 = 8               # the same at head size 256
HSZ = (32, 64, 96, 128, 256)    # head sizes the decode kernel is built for
# prefix_pass is not built at head size 96: grouped decode needs chunked
# prefill, which no head-size-96 arch runs (phi-3-vision is a vlm)
PREFIX_HSZ = (32, 64, 128, 256)

_P, _I = ctypes.c_void_p, ctypes.c_int
_WS: dict = {}              # (name, device) -> cached workspace tensor
_PLANS: dict = {}           # launch configuration -> _Plan


class _DecodeParams(ctypes.Structure):
    """ctypes mirror of ``DecodeParams`` in ``csrc/flash_decode.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "k_new", "v_new", "tl", "out", "lse", "kscale",
        "vscale", "tables", "gnp", "st_acc", "st_m", "st_l", "ws")]
        + [(n, ctypes.c_int) for n in (
            "tl0", "dtype", "quant", "B", "Kh", "G", "hsz", "s_loc",
            "n_ranks", "rank0", "kvp", "rr", "block_s", "slot_offset",
            "window", "contiguous", "prune", "append", "max_pages", "ps",
            "st_nc")]
        + [("scale", ctypes.c_float), ("cpc", ctypes.c_int)])


class _PrefixParams(ctypes.Structure):
    """ctypes mirror of ``PrefixParams`` in ``csrc/prefix_pass.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "q", "k", "v", "kscale", "vscale", "tl", "tables", "gid", "gnp",
        "st_acc", "st_m", "st_l", "f_acc", "f_m", "f_l")]
        + [(n, ctypes.c_int) for n in (
            "tl0", "dtype", "quant", "B", "Kh", "G", "hsz", "n_ranks",
            "rank0", "kvp", "rr", "window", "max_pages", "ps", "st_nc")]
        + [("scale", ctypes.c_float)])


@functools.lru_cache(maxsize=None)
def _bind(name: str):
    """The launcher of kernel ``name``, bound once: it takes a pointer to
    its params struct and the stream."""
    lib = build.load(name)
    fn = getattr(lib, name + "_launch")
    params = _DecodeParams if name == "flash_decode" else _PrefixParams
    fn.argtypes = [ctypes.POINTER(params), _P]
    fn.restype = _I
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    if name == "flash_decode":
        lib.flash_decode_chunk_slots.restype = _I
        if lib.flash_decode_chunk_slots() != CHUNK_S:
            raise build.KernelUnavailable(
                f"flash_decode.cu chunks {lib.flash_decode_chunk_slots()} "
                f"slots, the wrapper {CHUNK_S}")
    return lib, fn


def _workspace(name: str, numel: int, dev):
    """A cached flat float32 tensor of at least ``numel`` elements on
    ``dev``, grown on demand."""
    t = _WS.get((name, dev))
    if t is None or t.numel() < numel:
        t = torch.empty(max(numel, 1), dtype=torch.float32, device=dev)
        _WS[(name, dev)] = t
    return t


def _ptr(t):
    return None if t is None else t.data_ptr()


def decode_chunks(s_loc: int, block_s: int) -> int:
    """Chunks per (rank, row, kv head) of a decode launch: those of the
    padded capacity ``round_up(s_loc, block_s)``."""
    return -(-(round_up(s_loc, block_s) // TILE_S) // CHUNK_TILES)


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
    below ``group_np * ps`` once per group for all its members' query rows,
    chunk by chunk; each row's decode takes those partials, resumes the one
    of the chunk holding its split and sweeps only the tiles at or above
    it.  Bit for bit the result of ``groups=None``.  The shared pages must
    hold no slot the fused append writes (the engine caps ``group_np`` at
    each member's committed pages).  ``prefix_state``: the chunk partials of
    ``prefix_pass(..., chunks=True)`` to resume, when the caller ran it
    already.

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
            prefix_state=prefix_state, prune=prune)
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
                scale: float | None = None, kscale=None, vscale=None,
                chunks: bool = False):
    """The shared-prefix pass of grouped decode on its own (the reference's
    ``prefix_pass_kernel`` with its wrapper's gather and scatter): operands
    as in ``flash_decode_shards``' paged mode, ``group_id``/``group_np``
    [B] int32.  Returns each row's raw state ``(acc [R, B, Kh, G, hsz], m,
    l [R, B, Kh, G])`` f32 over the ``R = n_ranks`` shards, its chunk
    partials folded in order; rows of no group (split ``group_np * ps //
    32`` of 0) get the cold state.  ``chunks``: the chunk partials ``(acc
    [R, B, Kh, C, G, hsz], m, l [R, B, Kh, C, G])``, ``C = ceil(max_pages
    * ps / CHUNK_S)``, which ``flash_decode_shards(prefix_state=)``
    resumes; defined for the chunks below each row's split."""
    if scale is None:
        scale = float(q.shape[-1]) ** -0.5
    if build.route(q, k, v, kscale, vscale, block_tables, group_id,
                   group_np) == "plain":
        return prefix_pass_plain(q, k, v, total_len, block_tables, group_id,
                                 group_np, kvp=kvp, n_ranks=n_ranks,
                                 rank=rank, rr_block=rr_block, window=window,
                                 scale=scale, kscale=kscale, vscale=vscale,
                                 chunks=chunks)
    tl, tl0 = build.per_row(total_len, q.shape[0], q.device)
    return _launch_prefix(q, k, v, kscale, vscale, tl, tl0, block_tables,
                          group_id, group_np, kvp=kvp, n_ranks=n_ranks,
                          rank=rank, rr_block=rr_block, window=window,
                          scale=scale, fold=not chunks, cached=False)


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
                              prefix_state=None, prune=True):
    """Plain PyTorch version of the kernels behind ``flash_decode_shards``
    (any device), in their structure and arithmetic order: the append rule
    of the kernel (int8: ``quantize_kv_token`` payload and scale), then per
    shard every chunk of ``CHUNK_S`` slots swept from the cold state over
    tiles of ``TILE_S`` slots (``ref.sweep_chunks``) and the partials folded
    in chunk order (``ref.merge_chunks``; ``prune``: only the chunks holding
    valid slots).  ``block_s`` is the kernel's S-block (it bounds the slot
    the append may clamp to).  Paged: the append through the table, then
    ``gather_pages`` into the dense per-request shards the fixed layout
    would hold.  Grouped (``groups``): ``prefix_pass``'s chunk partials
    (``prefix_state``, or the plain pass), then each row takes those below
    its split tile, resumes the one holding it and sweeps the rest."""
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
            state = _prefix_chunks_plain(
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
                            slot_offset=slot_offset, prune=prune, split=split,
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
                 contiguous, slot_offset, prune=True, split=None, state=None):
    """One shard [B, Kh, s_loc, hsz] (float) of the plain decode: returns
    ``(out [B, Qh, hsz], lse [B, Qh])``.  Grouped suffix: ``split`` [B]
    (slots, a multiple of ``TILE_S``) and ``state``, the prefix pass's chunk
    partials (acc [B, Kh, C, G, hsz], m, l [B, Kh, C, G]): row b takes the
    chunks wholly below split[b] from ``state``, resumes the chunk holding
    it from ``state`` at split[b] and sweeps the chunks above from cold."""
    b, qh, hsz = q.shape
    kh, s_loc = k.shape[1], k.shape[2]
    g = qh // kh
    n = b * kh
    nc = chunk_count(s_loc)
    valid = _shard_valid(tl, s_loc, rank, kvp=kvp, rr_block=rr_block,
                         window=window, contiguous=contiguous,
                         slot_offset=slot_offset)
    pad = nc * CHUNK_S - s_loc
    # the chunks merged: those holding a valid slot (pruned), or all
    take = (torch.nn.functional.pad(valid, (0, pad)).reshape(b, nc, CHUNK_S)
            .any(-1) if prune else torch.ones(b, nc, dtype=torch.bool,
                                              device=q.device))
    init = below = None
    if split is not None:
        valid = valid & (torch.arange(s_loc, device=q.device)[None]
                         >= split[:, None])
        start = torch.arange(nc, device=q.device)[None] * CHUNK_S
        below = start + CHUNK_S <= split[:, None]               # [B, C]
        resume = (start < split[:, None]) & ~below
        cold = cold_state(n * nc, g, hsz, q.device)
        sel = resume[:, None].expand(b, kh, nc).reshape(n, nc)
        init = tuple(torch.where(sel.reshape(sel.shape + (1,) * (x.dim() - 3)),
                                 x.reshape(n, nc, *x.shape[3:]),
                                 c.reshape(n, nc, *x.shape[3:]))
                     for x, c in zip(state, cold))
    qf = q.float().reshape(n, g, hsz) * scale
    parts = sweep_chunks(qf, k.float().reshape(n, s_loc, hsz),
                         v.float().reshape(n, s_loc, hsz),
                         valid[:, None].expand(b, kh, -1).reshape(n, 1, -1),
                         init)
    if below is not None:
        sel = below[:, None].expand(b, kh, nc).reshape(n, nc)
        parts = tuple(torch.where(sel.reshape(sel.shape + (1,) * (x.dim() - 2)),
                                  y.reshape(n, nc, *y.shape[3:]), x)
                      for x, y in zip(parts, state))
    st = merge_chunks(parts, take[:, None].expand(b, kh, nc).reshape(n, nc))
    out, lse = finish_rows(st, q.dtype)
    return out.reshape(b, qh, hsz), lse.reshape(b, qh)


def prefix_pass_plain(q, k, v, total_len, block_tables, group_id, group_np,
                      *, kvp, n_ranks, rank, rr_block, window, scale,
                      kscale=None, vscale=None, chunks: bool = False):
    """Plain version of the prefix_pass kernel (the reference's
    ``prefix_pass_kernel`` plus the gather and scatter of its wrapper).

    q [B, Qh, hsz]; k, v (and int8 scales) paged pool planes as in
    ``flash_decode_shards``; ``group_id``/``group_np`` [B] int.  For each
    group row g, the members (rows with ``group_id == g`` and ``group_np >
    0``) stack their query rows and sweep, chunk by chunk, the whole tiles
    below their split ``group_np * ps // TILE_S`` through the first
    member's table, each member masked by its own length, window and split.
    Returns the raw state per row, ``(acc [R, B, Kh, G, hsz], m [R, B, Kh,
    G], l)`` over ``R = n_ranks`` shards, each row's chunk partials folded
    in order (rows of no group keep the cold state); ``chunks``: the
    partials themselves, ``(acc [R, B, Kh, C, G, hsz], m [R, B, Kh, C, G],
    l)`` with ``C = chunk_count(max_pages * ps)`` (cold above each row's
    split), as the grouped decode resumes them."""
    parts = _prefix_chunks_plain(q, k, v, total_len, block_tables, group_id,
                                 group_np, kvp=kvp, n_ranks=n_ranks,
                                 rank=rank, rr_block=rr_block, window=window,
                                 scale=scale, kscale=kscale, vscale=vscale)
    if chunks:
        return parts
    r, b, kh, c, g, hsz = parts[0].shape
    acc, m, l = merge_chunks(
        (parts[0].reshape(r * b * kh, c, g, hsz),
         *(x.reshape(r * b * kh, c, g) for x in parts[1:])))
    return (acc.reshape(r, b, kh, g, hsz), m.reshape(r, b, kh, g),
            l.reshape(r, b, kh, g))


def _prefix_chunks_plain(q, k, v, total_len, block_tables, group_id,
                         group_np, *, kvp, n_ranks, rank, rr_block, window,
                         scale, kscale=None, vscale=None):
    """The chunk partials of ``prefix_pass_plain(chunks=True)``."""
    b, qh, hsz = q.shape
    kh = k.shape[1]
    g = qh // kh
    ps = k.shape[2] // n_ranks
    s_loc = block_tables.shape[1] * ps
    nc = chunk_count(s_loc)
    tl = torch.as_tensor(total_len, dtype=torch.int32,
                         device=q.device).reshape(-1).expand(b)
    acc, m, l = cold_state(n_ranks * b * kh * nc, g, hsz, q.device)
    acc = acc.reshape(n_ranks, b, kh, nc, g, hsz)
    m, l = (x.reshape(n_ranks, b, kh, nc, g) for x in (m, l))
    gid, gnp = group_id.tolist(), group_np.tolist()
    qf = q.float().reshape(b, kh, g, hsz) * scale
    for g0 in sorted(set(gid)):
        mem = [i for i in range(b) if gid[i] == g0 and gnp[i] > 0]
        msplit = [gnp[i] * ps // TILE_S * TILE_S for i in mem]
        if not mem or max(msplit) == 0:
            continue
        lim = min(chunk_count(max(msplit)) * CHUNK_S, s_loc)
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
            valid = valid.repeat_interleave(g, 0)[None, :, :lim]  # [1, nG, S]
            sl = slice(z * s_loc, z * s_loc + lim)
            pa, pm, pl = sweep_chunks(qs, kd[:, sl], vd[:, sl], valid)
            for i, row in enumerate(mem):
                c = chunk_count(msplit[i])
                rows = slice(i * g, (i + 1) * g)
                acc[z, row, :, :c] = pa[:, :c, rows]
                m[z, row, :, :c] = pm[:, :c, rows]
                l[z, row, :, :c] = pl[:, :c, rows]
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


class _Plan:
    """A validated launch configuration: its params struct (the ints set
    once, the pointers per call), output shapes and workspace sizes."""

    def __init__(self, params, **kw):
        self.params = params
        self.__dict__.update(kw)


def _decode_plan(q, k, v, kscale, vscale, k_new, block_tables, groups,
                 prefix_state, *, kvp, n_ranks, rank, rr_block, window, scale,
                 block_s, contiguous, slot_offset, prune):
    b, qh, hsz = q.shape
    kh = k.shape[1]
    g = qh // kh
    quant = kscale is not None
    paged = block_tables is not None
    _check_int32(block_tables=block_tables)
    if quant:
        if not (k.dtype == v.dtype == torch.int8):
            raise ValueError(f"the int8 mode takes int8 k/v (got {k.dtype} "
                             f"{v.dtype})")
        if not (kscale.dtype == vscale.dtype == torch.float32
                and kscale.shape == vscale.shape == k.shape[:3]):
            raise ValueError("kscale/vscale must be contiguous float32 "
                             f"{tuple(k.shape[:3])}")
    elif not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    max_g = MAX_G_256 if hsz > 128 else MAX_G
    if hsz not in HSZ or g > max_g or block_s % TILE_S:
        raise ValueError(f"flash_decode kernel takes hsz in {HSZ}, "
                         f"Qh/Kh <= {MAX_G} ({MAX_G_256} at hsz 256) and "
                         f"block_s % {TILE_S} == 0 (got hsz {hsz}, G {g}, "
                         f"block_s {block_s})")
    ps = k.shape[2] // n_ranks
    max_pages = block_tables.shape[1] if paged else 0
    s_loc = max_pages * ps if paged else ps
    st_nc = 0
    if groups is not None:
        _check_int32(group_id=groups[0], group_np=groups[1])
        st_nc = chunk_count(s_loc)
        want = (n_ranks, b, kh, st_nc, g)
        if prefix_state is not None and not all(
                x.dtype == torch.float32 and x.device == q.device
                and tuple(x.shape[:5]) == want for x in prefix_state):
            raise ValueError("prefix_state must be prefix_pass(..., chunks="
                             f"True)'s contiguous float32 {want} partials")
    nc = decode_chunks(s_loc, block_s)
    p = _DecodeParams(
        dtype=build.dtype_code(q.dtype), quant=int(quant), B=b, Kh=kh, G=g,
        hsz=hsz, s_loc=s_loc, n_ranks=n_ranks, rank0=rank, kvp=kvp,
        rr=rr_block, block_s=block_s, slot_offset=slot_offset, window=window,
        contiguous=int(contiguous), prune=int(prune),
        append=int(k_new is not None), max_pages=max_pages, ps=ps,
        st_nc=st_nc, scale=scale)
    return _Plan(p, out=(n_ranks, b, qh, hsz), lse=(n_ranks, b, qh),
                 ws=n_ranks * b * kh * nc * g * (hsz + 2))


def _launch(q, k, v, total_len, *, kvp, n_ranks, rank, rr_block, window, scale,
            block_s, contiguous, slot_offset, kscale, vscale, k_new, v_new,
            prune, block_tables, groups, prefix_state):
    dev = q.device
    if k_new is not None and k_new.dtype != q.dtype:
        if kscale is not None:
            raise ValueError(f"k_new/v_new must have q's dtype {q.dtype}")
        k_new, v_new = k_new.to(q.dtype), v_new.to(q.dtype)
    if k_new is not None and v_new.dtype != k_new.dtype:
        raise ValueError(f"k_new/v_new must have q's dtype {q.dtype}")
    key = (q.shape, q.dtype, k.shape, k.dtype, v.shape, v.dtype, dev,
           None if kscale is None else (kscale.shape, kscale.dtype,
                                        vscale.shape, vscale.dtype),
           k_new is None,
           None if block_tables is None else (block_tables.shape,
                                              block_tables.dtype),
           None if groups is None else (groups[0].dtype, groups[1].dtype),
           None if prefix_state is None else tuple(
               (x.shape, x.dtype, x.device) for x in prefix_state),
           kvp, n_ranks, rank, rr_block, window, scale, block_s, contiguous,
           slot_offset, prune)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS[key] = _decode_plan(
            q, k, v, kscale, vscale, k_new, block_tables, groups, prefix_state,
            kvp=kvp, n_ranks=n_ranks, rank=rank, rr_block=rr_block,
            window=window, scale=scale, block_s=block_s,
            contiguous=contiguous, slot_offset=slot_offset, prune=prune)
    _check_kv(q, k, v, k_new, v_new)
    if not all(t is None or t.is_contiguous()
               for t in (kscale, vscale, block_tables, *(groups or ()))):
        raise ValueError("kscale/vscale, block_tables and groups must be "
                         "contiguous")
    b = q.shape[0]
    tl, tl0 = build.per_row(total_len, b, dev)
    st = (None, None, None)
    if groups is not None:
        st = prefix_state or _launch_prefix(
            q, k, v, kscale, vscale, tl, tl0, block_tables, *groups, kvp=kvp,
            n_ranks=n_ranks, rank=rank, rr_block=rr_block, window=window,
            scale=scale, fold=False, cached=True)
        if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
                   for x in st):
            raise ValueError("prefix_state must be contiguous and 16-byte "
                             "aligned")
    out = torch.empty(plan.out, dtype=q.dtype, device=dev)
    lse = torch.empty(plan.lse, dtype=torch.float32, device=dev)
    p = plan.params
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.k_new, p.v_new, p.tl = _ptr(k_new), _ptr(v_new), _ptr(tl)
    p.out, p.lse = out.data_ptr(), lse.data_ptr()
    p.kscale, p.vscale, p.tables = _ptr(kscale), _ptr(vscale), _ptr(
        block_tables)
    p.gnp = None if groups is None else groups[1].data_ptr()
    p.st_acc, p.st_m, p.st_l = (_ptr(x) for x in st)
    p.ws = _workspace("decode_partials", plan.ws, dev).data_ptr()
    p.tl0 = tl0
    lib, fn = _bind("flash_decode")
    build.check(fn(p, build.stream(dev)), lib, "flash_decode")
    last_launch["chunks_per_cta"] = p.cpc
    counter.n += 1
    counter_kv8.n += kscale is not None
    counter_paged.n += block_tables is not None
    counter_grouped.n += groups is not None
    counter_contiguous.n += bool(contiguous)
    return out, lse


def _check_int32(**tensors) -> None:
    for name, t in tensors.items():
        if t is not None and not (t.dtype == torch.int32
                                  and t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 tensor "
                             f"(got {t.dtype})")


def _check_kv(q, k, v, *rows) -> None:
    """Contiguity, and 16-byte alignment of what the kernels copy with
    16-byte ``cp.async`` (the K/V planes, the appended rows)."""
    if not all(t is None or t.is_contiguous() for t in (q, k, v, *rows)):
        raise ValueError("the decode kernels need contiguous q/k/v (and "
                         "k_new/v_new)")
    if any(x is not None and x.data_ptr() % 16 for x in (k, v, *rows)):
        raise ValueError("the decode kernels need 16-byte aligned k/v "
                         "(and k_new/v_new)")


def _launch_prefix(q, k, v, kscale, vscale, tl, tl0, tables, gid, gnp, *,
                   kvp, n_ranks, rank, rr_block, window, scale, fold,
                   cached):
    """Launch ``prefix_pass`` (one CTA per chunk, group row and kv head,
    rank and row block; CTAs of rows leading no group exit at once).
    Returns the chunk partials (in a cached workspace when ``cached``, else
    new tensors), or with ``fold`` each row's folded raw state."""
    b, qh, hsz = q.shape
    kh = k.shape[1]
    g = qh // kh
    dev = q.device
    key = ("prefix", q.shape, q.dtype, k.shape, k.dtype, dev,
           kscale is None, tables.shape, kvp, n_ranks, rank, rr_block, window,
           scale)
    plan = _PLANS.get(key)
    if plan is None:
        if hsz not in PREFIX_HSZ:
            raise ValueError(f"prefix_pass kernel takes hsz in {PREFIX_HSZ}"
                             f" (got {hsz})")
        ps = k.shape[2] // n_ranks
        st_nc = chunk_count(tables.shape[1] * ps)
        plan = _PLANS[key] = _Plan(
            _PrefixParams(
                dtype=build.dtype_code(q.dtype), quant=int(kscale is not None),
                B=b, Kh=kh, G=g, hsz=hsz, n_ranks=n_ranks, rank0=rank,
                kvp=kvp, rr=rr_block, window=window, max_pages=tables.shape[1],
                ps=ps, st_nc=st_nc, scale=scale),
            n=n_ranks * b * kh * st_nc * g, shape=(n_ranks, b, kh, st_nc, g))
    _check_int32(block_tables=tables, group_id=gid, group_np=gnp)
    _check_kv(q, k, v)
    n = plan.n
    flat = (_workspace("prefix_partials", n * (hsz + 2), dev)
            if cached or fold else
            torch.empty(n * (hsz + 2), dtype=torch.float32, device=dev))
    st = (flat[:n * hsz].view(*plan.shape, hsz),
          flat[n * hsz:n * (hsz + 1)].view(plan.shape),
          flat[n * (hsz + 1):n * (hsz + 2)].view(plan.shape))
    folded = (None, None, None)
    if fold:
        folded = (torch.empty((n_ranks, b, kh, g, hsz), dtype=torch.float32,
                              device=dev),
                  torch.empty((n_ranks, b, kh, g), dtype=torch.float32,
                              device=dev),
                  torch.empty((n_ranks, b, kh, g), dtype=torch.float32,
                              device=dev))
    p = plan.params
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.kscale, p.vscale, p.tl = _ptr(kscale), _ptr(vscale), _ptr(tl)
    p.tables, p.gid, p.gnp = tables.data_ptr(), gid.data_ptr(), gnp.data_ptr()
    p.st_acc, p.st_m, p.st_l = (x.data_ptr() for x in st)
    p.f_acc, p.f_m, p.f_l = (_ptr(x) for x in folded)
    p.tl0 = tl0
    lib, fn = _bind("prefix_pass")
    build.check(fn(p, build.stream(dev)), lib, "prefix_pass")
    counter_prefix.n += 1
    return folded if fold else st
