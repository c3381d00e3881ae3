"""Wrapper of the w8a16 matmul CUDA kernel (``csrc/w8a16_matmul.cu``), the
port of the reference's ``kernels/w8a16_matmul/ops.py``.

Tensors on the CPU take the plain version (``ref.w8a16_matmul_ref``); CUDA
tensors launch the kernel or raise.  The kernel masks ragged M, K and N
edges itself, so nothing is padded here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.w8a16_matmul.ref import w8a16_matmul_ref

counter = build.Launches()

_P, _I = ctypes.c_void_p, ctypes.c_int
TILE_N, TILE_M = 128, 8   # a block's columns and x rows (csrc TN, TM)


@functools.lru_cache(maxsize=None)
def _bind(lib):
    fn = lib.w8a16_matmul_launch
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    fn.restype = _I
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return fn


def blocks(m: int, n: int) -> int:
    """Blocks of one launch: 128-column tiles x M tiles of 8 rows (the
    kernel's grid; each block takes all of K)."""
    return -(-n // TILE_N) * -(-m // TILE_M)


def w8a16_matmul(x, qw, scale):
    """x [M, K] bf16/f32; qw [K, N] int8; scale [N] f32 -> [M, N] in
    x.dtype (f32 accumulation, column scale applied after the sum)."""
    if x.ndim != 2 or qw.ndim != 2 or scale.ndim != 1:
        raise ValueError(f"w8a16_matmul takes x [M, K], qw [K, N], scale [N] "
                         f"(got {tuple(x.shape)}, {tuple(qw.shape)}, "
                         f"{tuple(scale.shape)})")
    m, k = x.shape
    n = qw.shape[1]
    if qw.shape[0] != k or scale.shape[0] != n:
        raise ValueError(f"shapes disagree: x {tuple(x.shape)}, qw "
                         f"{tuple(qw.shape)}, scale {tuple(scale.shape)}")
    if qw.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"qw must be int8 and scale float32 (got {qw.dtype}, "
                         f"{scale.dtype})")
    if build.route(x, qw, scale) == "plain":
        return w8a16_matmul_ref(x, qw, scale)
    code = build.dtype_code(x.dtype)
    if not (x.is_contiguous() and qw.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("w8a16_matmul kernel needs contiguous x/qw/scale")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = build.load("w8a16_matmul")
    rc = _bind(lib)(build.ptr(x), build.ptr(qw), build.ptr(scale),
                    build.ptr(out), code, m, k, n, build.stream())
    build.check(rc, lib, "w8a16_matmul")
    counter.n += 1
    return out
