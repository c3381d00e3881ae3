"""Wrapper of the flash_prefill CUDA kernel (``csrc/flash_prefill.cu``), the
port of the reference's ``kernels/flash_prefill/ops.py``: causal or cross
attention, window, per-request ``q_offset`` and kv lengths, in the fixed
layout or through a block table (paged mode).

The public layout is the reference's: q [B, T, Qh, hsz], k/v [B, S, Kh,
hsz]; in paged mode k/v are one layer's pool planes [n_pool, Kh, page,
hsz] and S = max_pages * page.  Tensors on the CPU take the plain version
(``ref.flash_prefill_ref``, after ``ref.gather_pages`` in paged mode); CUDA
tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill.ref import (flash_prefill_paged_ref,
                                                   flash_prefill_ref)

counter = build.Launches()          # every launch
counter_paged = build.Launches()    # paged-mode launches among them
counter_noncausal = build.Launches()  # non-causal launches among them
counter_cross = build.Launches()    # ... of which S != T (cross-attention)
ROWS = 64                   # query rows per kernel block: 64 // G positions
#                             x the G heads of a kv head, the rest dead
BK = 64                     # keys per kernel kv tile
HSZ = (32, 64, 96, 128, 256)

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _bind(lib):
    fn = lib.flash_prefill_launch
    fn.argtypes = [_P] * 7 + [_I] * 13 + [ctypes.c_float, _P]
    fn.restype = _I
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return fn


def flash_prefill(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset=0, seq_lens=None, scale: float | None = None,
                  block_tables=None):
    """Full-sequence attention.  ``q_offset`` is an int or a [B] tensor,
    ``seq_lens`` an optional [B] tensor of valid kv lengths (None = all S).
    ``block_tables`` [B, max_pages] int32 selects the paged mode: k/v are
    pool planes [n_pool, Kh, page, hsz], kv slot s of row b lies at page
    ``block_tables[b, s // page]``, and ``seq_lens`` is required (entries
    past a request's pages point at a sink page of arbitrary data).
    Returns [B, T, Qh, hsz] in q.dtype."""
    b, t, qh, hsz = q.shape
    paged = block_tables is not None
    if paged:
        if seq_lens is None:
            raise ValueError("paged flash_prefill requires seq_lens")
        kh, page = k.shape[1], k.shape[2]
        max_pages = block_tables.shape[1]
        s = max_pages * page
    else:
        s, kh = k.shape[1], k.shape[2]
        max_pages = page = 0
    if qh % kh:
        raise ValueError(f"Qh {qh} is not a multiple of Kh {kh}")
    if scale is None:
        scale = float(hsz) ** -0.5
    if build.route(q, k, v, block_tables) == "plain":
        if paged:
            return flash_prefill_paged_ref(q, k, v, block_tables, seq_lens,
                                           causal=causal, window=window,
                                           q_offset=q_offset, scale=scale)
        return flash_prefill_ref(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, seq_lens=seq_lens,
                                 scale=scale)
    g = qh // kh
    code = build.dtype_code(q.dtype)
    if not (k.dtype == v.dtype == q.dtype):
        raise ValueError(f"q/k/v dtypes differ: {q.dtype} {k.dtype} {v.dtype}")
    if hsz not in HSZ or g > ROWS:
        raise ValueError(f"flash_prefill kernel takes hsz in {HSZ} and "
                         f"Qh/Kh <= {ROWS} (got hsz {hsz}, G {g})")
    if k.shape[-1] != hsz or v.shape != k.shape or (not paged
                                                    and k.shape[0] != b):
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_prefill kernel needs contiguous q/k/v")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_prefill kernel needs 16-byte aligned q/k/v")
    if paged and (block_tables.dtype != torch.int32
                  or block_tables.dim() != 2 or block_tables.shape[0] != b
                  or not block_tables.is_contiguous()):
        raise ValueError("block_tables must be a contiguous [B, max_pages] "
                         "int32 tensor")
    dev = q.device
    offs, off0 = build.per_row(q_offset, b, dev)
    lens, len0 = build.per_row(s if seq_lens is None else seq_lens, b, dev)
    out = torch.empty_like(q)
    lib = build.load("flash_prefill")
    rc = _bind(lib)(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lens),
        build.ptr(offs), build.ptr(block_tables), build.ptr(out), off0, len0,
        code, b, t, s, kh, g, hsz, int(causal), int(window), max_pages, page,
        float(scale), build.stream(dev))
    build.check(rc, lib, "flash_prefill")
    counter.n += 1
    if paged:
        counter_paged.n += 1
    if not causal:
        counter_noncausal.n += 1
        counter_cross.n += s != t
    return out
