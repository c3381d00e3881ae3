"""Plain PyTorch version of the flash_prefill kernel (port of the
reference's ``kernels/flash_prefill/ref.py``): full-sequence GQA attention,
causal or cross, optional sliding window, per-request ``q_offset`` and kv
lengths; and the paged mode's gather of pool pages into that layout."""
from __future__ import annotations

import torch

from repro_torch.utils import NEG_INF


def gather_pages(pool, block_tables, seq_lens):
    """Pool planes [n_pool, Kh, page, hsz] read through ``block_tables``
    [B, max_pages] -> the fixed layout [B, max_pages * page, Kh, hsz].  Slots
    at or beyond ``seq_lens[b]`` are zeros, as the kernel loads them: the
    table points them at a sink page of arbitrary data."""
    tab = torch.as_tensor(block_tables, dtype=torch.long, device=pool.device)
    b, mp = tab.shape
    _, kh, page, hsz = pool.shape
    x = pool[tab].permute(0, 1, 3, 2, 4).reshape(b, mp * page, kh, hsz)
    lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=pool.device)
    live = torch.arange(mp * page, device=pool.device)[None, :] < \
        lens.reshape(-1, 1)
    return torch.where(live[..., None, None], x, torch.zeros_like(x))


def flash_prefill_ref(q, k, v, *, causal: bool = True, window: int = 0,
                      q_offset=0, seq_lens=None, scale: float | None = None):
    """q [B, T, Qh, hsz]; k, v [B, S, Kh, hsz].  ``q_offset`` is an int or
    a [B] tensor (global position of query row 0); ``seq_lens`` an optional
    [B] tensor of valid kv lengths.  Fully masked rows give zeros.  Returns
    [B, T, Qh, hsz] in q.dtype."""
    b, t, qh, hsz = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = qh // kh
    if scale is None:
        scale = hsz ** -0.5
    dev = q.device
    qf = q.float().reshape(b, t, kh, g, hsz) * scale
    scores = torch.einsum("btkgd,bskd->bkgts", qf, k.float())
    off = torch.as_tensor(q_offset, dtype=torch.int32, device=dev)
    qpos = torch.arange(t, device=dev)[None, :] + off.reshape(-1, 1)  # [B|1,T]
    kpos = torch.arange(s, device=dev)[None, None, :]
    mask = torch.ones((qpos.shape[0], t, s), dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos <= qpos[..., None]
    if window > 0:
        mask &= kpos > qpos[..., None] - window
    mask = mask.expand(b, t, s)
    if seq_lens is not None:
        lens = torch.as_tensor(seq_lens, dtype=torch.int32, device=dev)
        mask = mask & (kpos < lens.reshape(-1, 1, 1))
    maskh = mask[:, None, None]                                # [B,1,1,T,S]
    scores = torch.where(maskh, scores, torch.full_like(scores, NEG_INF))
    m = scores.amax(dim=-1, keepdim=True)
    m_safe = torch.where(m <= NEG_INF, torch.zeros_like(m), m)
    p = torch.where(maskh, torch.exp(scores - m_safe), torch.zeros_like(scores))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", p / torch.clamp(l, min=1e-37),
                       v.float())
    return out.reshape(b, t, qh, hsz).to(q.dtype)


def flash_prefill_paged_ref(q, k_pool, v_pool, block_tables, seq_lens, *,
                            causal: bool = True, window: int = 0, q_offset=0,
                            scale: float | None = None):
    """The paged mode's plain version: the table's pages gathered into the
    fixed layout (``gather_pages``), then ``flash_prefill_ref``."""
    return flash_prefill_ref(
        q, gather_pages(k_pool, block_tables, seq_lens),
        gather_pages(v_pool, block_tables, seq_lens), causal=causal,
        window=window, q_offset=q_offset, seq_lens=seq_lens, scale=scale)
