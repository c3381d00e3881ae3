"""Sequential-recurrence oracle of the ssd_prefill family (port of the
reference's ``kernels/ssd_prefill/ref.py``): the exact SSD recurrence over
pre-projected inputs, one token at a time."""
from __future__ import annotations

import torch


def ssd_prefill_ref(x, dt, a, bmat, cmat, d, *, h0=None):
    """x [B, T, nh, hd]; dt [B, T, nh] (softplus'd); a [nh] (negative);
    bmat, cmat [B, T, nh, ds] (group-expanded); d [nh]; h0 optional
    [B, nh, hd, ds].  Returns (y [B, T, nh, hd] f32, h_final f32)."""
    b, t, nh, hd = x.shape
    ds = bmat.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf = bmat.float(), cmat.float()
    da = torch.exp(dtf * a.float())                           # [B, T, nh]
    h = (torch.zeros(b, nh, hd, ds, device=x.device) if h0 is None
         else h0.float())
    ys = []
    for i in range(t):
        h = da[:, i, :, None, None] * h \
            + (dtf[:, i, :, None] * xf[:, i])[..., None] * bf[:, i, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, cf[:, i]))
    y = torch.stack(ys, dim=1) + d.float()[None, None, :, None] * xf
    return y, h
