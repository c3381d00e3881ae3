"""Wrapper of the SSD-prefill CUDA kernel (``csrc/ssd_prefill.cu``), the
port of the reference's ``kernels/ssd_prefill/ops.py``, and its plain
PyTorch version.

Tensors on the CPU take the plain version (``ssd_prefill_plain``, the SSD
block-matrix form in f32); CUDA tensors launch the kernel or raise.  Both
cut the tokens into the same chunks (``chunk_spans``), each of which gets
its own state and decay before the states are folded in chunk order.  Both
take B/C either group-expanded (``[B, T, nh, ds]``, the reference's form)
or per group (``[B, T, G, ds]``, head h reading group ``h // (nh / G)``):
the products are the same, the kernel just reads the group's row.  A
ragged last chunk is masked in the kernel and zero-padded with ``dt = 0``
in the plain version, which leaves the state untouched on padded steps.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.utils import round_up

counter = build.Launches()
MAX_CHUNK = 64          # tokens per chunk the kernel's blocks hold (csrc LC)
_ctrl: dict[tuple[int, int], torch.Tensor] = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _bind(lib):
    fn = lib.ssd_prefill_launch
    fn.argtypes = ([_P, _L, _L] * 3 + [_P] * 8 + [_I] * 9 + [_P])
    fn.restype = _I
    lib.kernel_error_string.argtypes = [_I]
    lib.kernel_error_string.restype = ctypes.c_char_p
    return fn


def chunk_len(lc: int, t: int) -> int:
    """The chunk the scan runs at: ``lc``, cut to ``t`` rounded up to 8
    (the reference wrapper's rule)."""
    return min(lc, round_up(t, 8))


def chunk_spans(t: int, lc: int) -> list[tuple[int, int]]:
    """``(start, length)`` of each chunk of a ``t``-token call: chunks of
    ``chunk_len(lc, t)`` tokens at absolute multiples of it from the call's
    first token, the last one ragged.  The kernel's blocks take chunk c at
    ``c * lc`` for ``min(lc, t - c * lc)`` tokens, the same partition."""
    c = chunk_len(lc, t)
    return [(s, min(c, t - s)) for s in range(0, t, c)]


def _control(dev, stream: int, heads: int):
    """The kernel's control buffer on ``dev`` for launches on ``stream``:
    [0] the blocks' ticket, [1 + b * nh + h] the chunks of (b, h) handed
    on.  Zeroed when made; every launch leaves it zeroed."""
    key = (dev.index, stream)
    buf = _ctrl.get(key)
    if buf is None or buf.numel() < 1 + heads:
        buf = torch.zeros(1 + max(heads, 256), dtype=torch.int32, device=dev)
        _ctrl[key] = buf
    return buf


def _check(x, dt, a, bmat, cmat, d, h0):
    if x.ndim != 4 or bmat.ndim != 4 or bmat.shape != cmat.shape:
        raise ValueError(f"ssd_prefill takes x [B, T, nh, hd] and B/C [B, T, "
                         f"G, ds] (got {tuple(x.shape)}, {tuple(bmat.shape)}, "
                         f"{tuple(cmat.shape)})")
    b, t, nh, hd = x.shape
    g, ds = bmat.shape[2:]
    if (bmat.shape[:2] != (b, t) or g < 1 or nh % g
            or tuple(dt.shape) != (b, t, nh) or tuple(a.shape) != (nh,)
            or tuple(d.shape) != (nh,)
            or (h0 is not None and tuple(h0.shape) != (b, nh, hd, ds))):
        raise ValueError(
            f"ssd_prefill shapes disagree: x {tuple(x.shape)}, dt "
            f"{tuple(dt.shape)}, a {tuple(a.shape)}, B/C {tuple(bmat.shape)},"
            f" d {tuple(d.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}")


def chunk_cumsum(v):
    """Inclusive cumsum over the last axis in the kernel's order: the
    values zero-padded to ``MAX_CHUNK`` (or the next power of two above
    it, which only the plain version takes), pairs ``v[2l] + v[2l+1]``, a
    Hillis-Steele scan of the pair sums (``s[l] += s[l - o]`` for o = 1, 2,
    4, ...), then ``e[l] + v[2l]`` and ``+ v[2l+1]`` with ``e`` the scan
    shifted by one.  Returns the padded sums; the last is the chunk's
    total.  The order matters beyond the last bits: ``exp(cum_i - cum_j)``
    takes differences of sums of up to ~50 in magnitude, whose rounding is
    ~4e-6 of a decay factor."""
    n = max(MAX_CHUNK, 1 << (v.shape[-1] - 1).bit_length())
    v = F.pad(v, (0, n - v.shape[-1]))
    v0, v1 = v[..., 0::2], v[..., 1::2]
    s = v0 + v1
    o = 1
    while o < n // 2:
        s = torch.cat([s[..., :o], s[..., o:] + s[..., :-o]], dim=-1)
        o *= 2
    e = torch.cat([torch.zeros_like(s[..., :1]), s[..., :-1]], dim=-1)
    c0 = e + v0
    return torch.stack([c0, c0 + v1], dim=-1).flatten(-2)


def ssd_prefill_plain(x, dt, a, bmat, cmat, d, *, h0=None, lc: int = 64):
    """The SSD block-matrix form in f32 (the reference's ``ssd_chunked``
    ``ref`` core): per chunk of ``lc`` tokens the intra-chunk product
    ``tril(C Bᵀ ∘ exp(cum_i - cum_j)) · diag(dt) · X``, the inter-chunk
    term ``exp(cum) ∘ (C · h_in)`` and the carried state, folded in chunk
    order; ``cum`` in the kernel's order (``chunk_cumsum``).  Shapes as
    ``ssd_prefill``."""
    _check(x, dt, a, bmat, cmat, d, h0)
    b, t, nh, hd = x.shape
    g, ds = bmat.shape[2:]
    hpg = nh // g
    lc = chunk_len(lc, t)
    t_pad = round_up(t, lc)
    nc = t_pad // lc
    pad = t_pad - t
    xf = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, lc, nh, hd)
    bf = F.pad(bmat.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, lc, g, ds)
    cf = F.pad(cmat.float(), (0, 0, 0, 0, 0, pad)).reshape(b, nc, lc, g, ds)
    dtf = F.pad(dt.float(), (0, 0, 0, pad)).reshape(b, nc, lc, nh)
    cum64 = chunk_cumsum((dtf * a.float()).transpose(2, 3))  # [B,nc,nh,>=64]
    cum = cum64[..., :lc].transpose(2, 3)                   # [B,nc,lc,nh]
    cum_last = cum64[..., -1]                               # [B,nc,nh]

    # intra-chunk: w[i,j] = C_i·B_j exp(cum_i - cum_j) dt_j  (i >= j); the
    # masked exponents are zeroed before exp (they are positive there)
    cb = torch.einsum("bcign,bcjgn->bcgij", cf, bf)
    cb = cb.repeat_interleave(hpg, dim=2)                   # [B,nc,nh,lc,lc]
    li = cum.transpose(2, 3)                                # [B,nc,nh,lc]
    mask = torch.ones(lc, lc, dtype=torch.bool, device=x.device).tril()
    ldiff = li[..., :, None] - li[..., None, :]
    decay = torch.exp(torch.where(mask, ldiff, 0.0))
    w = torch.where(mask, cb * decay, 0.0) * dtf.transpose(2, 3)[..., None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", w, xf)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j
    seg = torch.exp(cum_last[:, :, None, :] - cum) * dtf    # [B,nc,lc,nh]
    bh = bf.repeat_interleave(hpg, dim=3)                   # [B,nc,lc,nh,ds]
    dbx = torch.einsum("bcjhn,bcjhp->bchpn", bh * seg[..., None], xf)
    chunk_decay = torch.exp(cum_last)                       # [B,nc,nh]
    h = (torch.zeros(b, nh, hd, ds, device=x.device) if h0 is None
         else h0.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = chunk_decay[:, c, :, None, None] * h + dbx[:, c]
    h_in = torch.stack(h_in, dim=1)                         # [B,nc,nh,hd,ds]

    # inter-chunk: y_i += exp(cum_i) * C_i · h_in
    ch = cf.repeat_interleave(hpg, dim=3)
    y_inter = torch.einsum("bcihn,bchpn->bcihp", ch, h_in) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(b, t_pad, nh, hd)[:, :t] \
        + d.float()[None, None, :, None] * x.float()
    return y, h


def _inner_contiguous(t) -> bool:
    return t.stride(3) == 1 and t.stride(2) == t.shape[3]


def ssd_prefill(x, dt, a, bmat, cmat, d, *, h0=None, lc: int = 64):
    """Mamba2 SSD prefill scan core.

    x [B, T, nh, hd]; dt [B, T, nh] softplus'd timestep; a [nh] negative
    decay rate; bmat, cmat [B, T, G, ds] (G divides nh; G = nh is the
    reference's group-expanded form); d [nh] skip; h0 optional [B, nh, hd,
    ds] initial state.  Returns ``(y [B, T, nh, hd] f32, h_final [B, nh,
    hd, ds] f32)``.

    The kernel takes x/B/C in f32 or bf16 (one type for the three), with
    any batch and token strides as long as each token's heads and channels
    are contiguous (slices of the projection, as ``models/ssm`` passes
    them), hd and ds multiples of 16 and a chunk of at most 64 tokens;
    dt, a, d and h0 are f32 and contiguous.  The wrapper allocates the
    kernel's workspace, the states its blocks hand on ([B, nh, 2, hd, ds]
    f32), and keeps one zeroed control buffer per device and stream (the
    blocks' ticket and hand-on flags, which every launch leaves zeroed)."""
    _check(x, dt, a, bmat, cmat, d, h0)
    if build.route(x, dt, a, bmat, cmat, d, h0) == "plain":
        return ssd_prefill_plain(x, dt, a, bmat, cmat, d, h0=h0, lc=lc)
    b, t, nh, hd = x.shape
    g, ds = bmat.shape[2:]
    if not (x.dtype == bmat.dtype == cmat.dtype):
        raise ValueError(f"x, B and C must share one type (got {x.dtype}, "
                         f"{bmat.dtype}, {cmat.dtype})")
    code = build.dtype_code(x.dtype)
    small = (dt, a, d) + (() if h0 is None else (h0,))
    if any(s.dtype != torch.float32 or not s.is_contiguous() for s in small):
        raise ValueError("ssd_prefill kernel needs contiguous float32 dt, a, "
                         "d and h0")
    if not all(_inner_contiguous(s) for s in (x, bmat, cmat)):
        raise ValueError("ssd_prefill kernel needs each token's heads and "
                         "channels of x/B/C contiguous")
    lc = chunk_len(lc, t)
    if hd % 16 or ds % 16 or lc > MAX_CHUNK:
        raise ValueError(f"ssd_prefill kernel needs hd and ds multiples of 16 "
                         f"and a chunk of at most {MAX_CHUNK} tokens (got hd "
                         f"{hd}, ds {ds}, chunk {lc})")
    y = torch.empty((b, t, nh, hd), dtype=torch.float32, device=x.device)
    h = torch.empty((b, nh, hd, ds), dtype=torch.float32, device=x.device)
    if t == 0 or b == 0:
        if h0 is None:
            return y, h.zero_()
        return y, h.copy_(h0)
    nc = len(chunk_spans(t, lc))
    ring = torch.empty(b * nh * 2 * hd * ds, dtype=torch.float32,
                       device=x.device)
    stream = build.stream(x.device)
    ctrl = _control(x.device, stream, b * nh)
    lib = build.load("ssd_prefill")
    rc = _bind(lib)(
        build.ptr(x), x.stride(0), x.stride(1),
        build.ptr(bmat), bmat.stride(0), bmat.stride(1),
        build.ptr(cmat), cmat.stride(0), cmat.stride(1),
        build.ptr(dt), build.ptr(a), build.ptr(d), build.ptr(h0),
        build.ptr(y), build.ptr(h), build.ptr(ring), build.ptr(ctrl), b, t,
        nh, hd, g, ds, lc, nc, code, stream)
    build.check(rc, lib, "ssd_prefill")
    counter.n += 1
    return y, h
