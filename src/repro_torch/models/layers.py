"""Layer primitives (port of the reference's ``models/layers.py``)."""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm in f32 with a zero-centred gain (``1 + weight``)."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def _gelu_tanh(x):
    # jax.nn.gelu's default (approximate=True); the erf form is ~5e-4 off
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    """The FFN's activation: ``silu``; ``gelu`` (ungated) and ``gelu_gated``
    both the tanh form, as ``jax.nn.gelu``'s default."""
    return {"silu": F.silu, "gelu": _gelu_tanh,
            "gelu_gated": _gelu_tanh}[name]


def softcap(x, cap: float):
    """Final-logit softcap ``cap * tanh(x / cap)``; ``x`` itself when
    ``cap`` is 0."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def rope_freqs(hsz: int, theta: float, device=None):
    """[hsz/2] inverse frequencies."""
    exps = torch.arange(0, hsz, 2, dtype=torch.float32, device=device) / hsz
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float = 10_000.0):
    """Split-half RoPE in f32.  x [..., T, n_heads, hsz]; positions [..., T]."""
    hsz = x.shape[-1]
    inv = rope_freqs(hsz, theta, device=x.device)
    ang = positions[..., None].float() * inv             # [..., T, hsz/2]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _inv_timescales(dim: int, device: torch.device):
    """[dim/2] inverse timescales, computed on the CPU once and kept on
    ``device`` (no host-to-device copy per step, which a CUDA graph could
    not capture)."""
    log_timescale = torch.log(torch.tensor(10_000.0)) / (dim // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(dim // 2,
                                                  dtype=torch.float32))
    return inv.to(device)


def sinusoidal_at(pos, dim: int):
    """Sinusoidal embedding at position(s) ``pos`` [...] -> [..., dim] f32
    (sin half, then cos half)."""
    t = pos[..., None].float() * _inv_timescales(dim, pos.device)
    return torch.cat([torch.sin(t), torch.cos(t)], dim=-1)


def sinusoidal_positions(length: int, dim: int, device=None):
    """Whisper-style sinusoidal embeddings of positions ``0 .. length - 1``
    [length, dim] f32: ``sinusoidal_at`` over an arange, so the two agree
    bit for bit at equal positions."""
    return sinusoidal_at(torch.arange(length, device=device), dim)
