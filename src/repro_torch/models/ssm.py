"""Mamba2 (SSD, state-space duality) block (port of the reference's
``models/ssm.py``): the chunked prefill scan and the O(1)-state decode
step over one parameter set.

Recurrence (per head h, state n, channel p):

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t ⊗ x_t
    y_t = C_t · h_t + D * x_t

with A < 0 a scalar per head and B, C shared by the heads of a group.
The prefill's scan core goes through the ``ssd_prefill`` kernel family
(``backend``: ``cuda`` the kernel, ``ref`` its plain block-matrix form);
the projection, the causal conv and the gated out-projection are plain
PyTorch, as in the reference.  The decode step has no kernel in the
reference and stays plain PyTorch here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.kernels import registry
from repro_torch.kernels.ssd_prefill import ssd_prefill, ssd_prefill_plain
from repro_torch.models.layers import rms_norm

# leaves the reference keeps in f32 whatever the model's type
F32_LEAVES = ("A_log", "D", "dt_bias")


def d_in_proj(cfg: ArchConfig) -> int:
    return 2 * cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state + cfg.ssm_heads


def _param(*shape):
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class SSMParams(nn.Module):
    """One layer's Mamba2 parameters, named as the reference's pytree."""

    def __init__(self, cfg: ArchConfig):
        super().__init__()
        d, nh = cfg.d_model, cfg.ssm_heads
        self.w_in = _param(d, d_in_proj(cfg))            # (z, xBC, dt)
        self.conv_w = _param(cfg.conv_dim, cfg.ssm_conv)  # depthwise
        self.conv_b = _param(cfg.conv_dim)
        self.A_log = _param(nh)
        self.D = _param(nh)
        self.dt_bias = _param(nh)
        self.norm_w = _param(cfg.d_inner)   # gated RMSNorm before w_out
        self.w_out = _param(cfg.d_inner, d)


@torch.no_grad()
def init_ssm(p: SSMParams, cfg: ArchConfig, gen: torch.Generator) -> None:
    """Fill ``p`` in place: the projections and the conv from ``gen`` with
    the reference's distributions (fan-in scaled normals; conv 0.5), the
    rest deterministic as the reference makes it (computed in f64 and
    rounded once)."""
    dev = p.w_in.device
    for w, std in ((p.w_in, cfg.d_model ** -0.5), (p.conv_w, 0.5),
                   (p.w_out, cfg.d_inner ** -0.5)):
        w.copy_(torch.randn(w.shape, generator=gen, device=dev) * std)
    nh = cfg.ssm_heads
    p.conv_b.zero_()
    p.norm_w.zero_()
    p.D.fill_(1.0)
    p.A_log.copy_(torch.from_numpy(np.log(np.linspace(1.0, 16.0, nh))))
    p.dt_bias.copy_(torch.from_numpy(
        np.log(np.expm1(np.linspace(1e-3, 0.1, nh)))))


class SSMState(NamedTuple):
    conv: torch.Tensor    # [B, conv_dim, ssm_conv - 1] shift register
    ssm: torch.Tensor     # [B, nh, hd, ds] f32


def init_ssm_state(cfg: ArchConfig, batch: int, *, device="cpu") -> SSMState:
    """Zero state, both leaves f32 (the reference's default)."""
    return SSMState(
        conv=torch.zeros(batch, cfg.conv_dim, cfg.ssm_conv - 1,
                         device=device),
        ssm=torch.zeros(batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
                        device=device))


# ------------------------------------------------------------------ shared
def _project(p: SSMParams, cfg: ArchConfig, x):
    """x [..., d] -> (z [..., d_inner], xBC [..., conv_dim], dt [..., nh])."""
    proj = x @ p.w_in
    return torch.split(proj, [cfg.d_inner, cfg.conv_dim, cfg.ssm_heads],
                       dim=-1)


def _split_xbc(cfg: ArchConfig, xbc):
    gs = cfg.ssm_ngroups * cfg.ssm_state
    return torch.split(xbc, [cfg.d_inner, gs, gs], dim=-1)


def _dt_act(dt, dt_bias):
    return F.softplus(dt.float() + dt_bias)


def _gate_out(p: SSMParams, y, z):
    """Gated RMSNorm (in f32) + out-projection.  y, z [..., d_inner]."""
    g = rms_norm(y * F.silu(z.float()), p.norm_w)
    return g.to(p.w_out.dtype) @ p.w_out


def _conv_taps(p: SSMParams, hist, t: int):
    """Causal depthwise conv as the reference's ``ssm_conv``-tap sum in f32,
    then silu: ``hist`` [B, t + ssm_conv - 1, conv_dim] -> [B, t, conv_dim]
    f32."""
    w = p.conv_w.float()
    out = p.conv_b.float()
    for k in range(w.shape[1]):
        out = out + hist[:, k:k + t, :].float() * w[:, k]
    return F.silu(out)


def _history(conv, xbc_raw):
    """The conv state [B, conv_dim, dc-1] followed by ``xbc_raw`` [B, T,
    conv_dim] along time, in their promoted type (an f32 state keeps a
    bf16 input's history f32, as JAX's concatenate does)."""
    dtype = torch.promote_types(conv.dtype, xbc_raw.dtype)
    return torch.cat([conv.transpose(1, 2).to(dtype), xbc_raw.to(dtype)],
                     dim=1)


# ------------------------------------------------------------------ prefill
def ssd_chunked(p: SSMParams, cfg: ArchConfig, x,
                state: SSMState | None = None, chunk: int = 64,
                backend: str = "cuda"):
    """Mamba2 block over a whole prompt.  x [B, T, d] -> (y [B, T, d],
    SSMState).

    The prompt runs in chunks of ``lc = min(chunk, T)`` tokens and, as in
    the reference, ``T`` must be a multiple of ``lc``: prompts of at most
    ``chunk`` tokens or a multiple of it.  ``backend`` routes the scan core
    through the ``ssd_prefill`` family: ``cuda`` (the kernel; its plain
    version on CPU tensors) or ``ref`` (the plain block-matrix form)."""
    b, t, _ = x.shape
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    g = cfg.ssm_ngroups
    lc = min(chunk, t)
    if t % lc:
        raise ValueError(f"ssd_chunked: T={t} is not a multiple of the "
                         f"chunk {lc} (prompts must be <= {chunk} tokens or "
                         f"a multiple of {chunk}, as in the reference)")
    if backend not in registry.BACKENDS:
        raise ValueError(f"ssd backend {backend!r}; choose from "
                         f"{registry.BACKENDS}")
    if state is None:
        state = init_ssm_state(cfg, b, device=x.device)
    z, xbc_raw, dt = _project(p, cfg, x)
    hist = _history(state.conv, xbc_raw)
    xbc = _conv_taps(p, hist, t).to(x.dtype)
    new_conv = hist[:, t:, :].transpose(1, 2)

    xs, bb, cc = _split_xbc(cfg, xbc)
    core = ssd_prefill if backend == "cuda" else ssd_prefill_plain
    ys, h_fin = core(xs.reshape(b, t, nh, hd), _dt_act(dt, p.dt_bias),
                     -torch.exp(p.A_log), bb.reshape(b, t, g, ds),
                     cc.reshape(b, t, g, ds), p.D.float(), h0=state.ssm,
                     lc=lc)
    y = _gate_out(p, ys.reshape(b, t, cfg.d_inner).to(x.dtype), z)
    return y, SSMState(new_conv, h_fin)


# ------------------------------------------------------------------ decode
def ssm_decode_step(p: SSMParams, cfg: ArchConfig, x, state: SSMState):
    """Single-token decode.  x [B, d] -> (y [B, d], new SSMState)."""
    b = x.shape[0]
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    hpg = nh // cfg.ssm_ngroups
    z, xbc_raw, dt = _project(p, cfg, x)
    hist = _history(state.conv, xbc_raw[:, None, :])    # [B, dc, conv_dim]
    xbc = _conv_taps(p, hist, 1)[:, 0].to(x.dtype)
    new_conv = hist[:, 1:, :].transpose(1, 2)

    xs, bb, cc = _split_xbc(cfg, xbc)
    xs = xs.reshape(b, nh, hd).float()
    bb = bb.reshape(b, -1, ds).repeat_interleave(hpg, dim=1).float()
    cc = cc.reshape(b, -1, ds).repeat_interleave(hpg, dim=1).float()
    dtv = _dt_act(dt, p.dt_bias)                         # [B, nh]
    da = torch.exp(dtv * -torch.exp(p.A_log))
    h = da[:, :, None, None] * state.ssm \
        + (dtv[:, :, None] * xs)[..., None] * bb[:, :, None, :]
    y = torch.einsum("bhpn,bhn->bhp", h, cc) + p.D[None, :, None] * xs
    out = _gate_out(p, y.reshape(b, cfg.d_inner).to(x.dtype), z)
    return out, SSMState(new_conv, h)
