"""Plain PyTorch version of the w8a16 matmul kernel (port of the reference's
``kernels/w8a16_matmul/ref.py``): int8 weights with per-output-column f32
scales, activations in bf16/f32, the product summed in f32."""
from __future__ import annotations

import torch

from repro_torch.utils import int8_scale


def quantize_w8(w):
    """[K, N] float -> (int8 [K, N], f32 scale [N]), symmetric per column:
    ``scale = max(max_k |w| / 127, 1e-30)``, ``q = clip(round(w / scale),
    -127, 127)`` with round-half-to-even, the reference's formula.  ``q``
    is contiguous whatever ``w``'s strides (a transposed head included)."""
    wf = w.float()
    scale = int8_scale(wf, 0)
    q = torch.clamp(torch.round(wf / scale[None, :]), -127, 127)
    return q.to(torch.int8).contiguous(), scale


def w8a16_matmul_ref(x, qw, scale):
    """x [M, K] bf16/f32; qw [K, N] int8; scale [N] f32 -> [M, N] in
    x.dtype: the f32 product, times the column scale after the sum."""
    y = x.float() @ qw.float()
    return (y * scale[None, :]).to(x.dtype)
