"""Small shared helpers (the port's own copy of what it needs from
``repro/utils.py``)."""
from __future__ import annotations

import torch

NEG_INF = -1e30  # finite stand-in for -inf inside kernels (avoids NaN in exp/max)


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def int8_scale(xf, dim: int):
    """Symmetric int8 scale ``max(max|x| / 127, 1e-30)`` of f32 ``xf`` over
    ``dim``, with IEEE division: the divisor is a tensor because PyTorch's
    CUDA division by a Python scalar multiplies by its reciprocal instead,
    which is one ulp off for some inputs."""
    amax = xf.abs().amax(dim=dim)
    return torch.clamp(amax / torch.full_like(amax, 127.0), min=1e-30)
