"""Decode state (port of the reference's ``core/kvcache.py``): round-robin
KV caches ``[L, B, Kh, S_cap, hsz]`` plus ``total_len`` in the fixed layout,
or shared pool planes plus per-request block tables in the paged layout;
with ``kv_bits=8`` the caches are int8 and f32 scales
``kscale``/``vscale`` (the caches' shape without hsz) ride beside them.

Paged layout (the reference's layout comment, ``core/kvcache.py:23-42``):
K/V live in pool planes ``[L, n_pool, Kh, page, hsz]``, where one page holds
``page = kvp * rr_block`` consecutive global positions of whichever request
owns it, and a ``[B, max_pages]`` int32 block table maps logical page i to
its physical page.  Rank r holds rows ``[r*rr, (r+1)*rr)`` of every page,
which are exactly its round-robin local slots ``[i*rr, (i+1)*rr)`` of
logical page i, so the pool is a page-granularity permutation of the fixed
layout.  Page 0 is the sink that idle rows append to (``serving/pool.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.flash_decode.ref import (gather_pages,  # noqa: F401
                                                  quantize_kv_token)
from repro_torch.utils import round_up

KV_BITS = (16, 8)
CACHE_KEYS = ("kcache", "vcache", "kscale", "vscale")
# the on-device sampler's per-row leaves and their types; the reference's
# ``sample_seed`` is uint32, held here as int64 with the same values
SAMPLING_TYPES = {"sample_temp": torch.float32, "sample_topk": torch.int32,
                  "sample_topp": torch.float32, "sample_seed": torch.int64,
                  "sample_idx": torch.int32}


def cache_capacity(cfg_seq_len: int, kvp: int, rr_block: int) -> int:
    """Smallest valid cache capacity >= seq_len (multiple of kvp*rr)."""
    return round_up(cfg_seq_len, kvp * rr_block)


def page_positions(kvp: int, rr_block: int) -> int:
    """Global positions per pool page: one round-robin cycle, so each KVP
    rank holds ``rr_block`` rows of every page."""
    return kvp * rr_block


def cache_to_pages(row, kvp: int, page: int):
    """One request's fixed-layout cache ``[L, Kh, S_cap, ...]`` (rank-major
    round robin, slot ``r*S_loc + j``) -> its page stack ``[L, P, Kh, page,
    ...]``, ``P = ceil(S_cap / page)``: in-page row ``r*ps + jj`` holds rank
    r's local slot ``i*ps + jj`` (``ps = page / kvp``).  K/V payloads and
    scale planes alike."""
    l, kh, s_cap = row.shape[:3]
    trail = row.shape[3:]
    ps = page // kvp
    s_pad = round_up(s_cap, page)
    if s_pad != s_cap:
        pad = torch.zeros((l, kh, s_pad - s_cap, *trail), dtype=row.dtype,
                          device=row.device)
        row = torch.cat([row, pad], dim=2)
    p = s_pad // page
    r = row.reshape(l, kh, kvp, p, ps, *trail)
    r = r.movedim(3, 1)                             # [L, P, Kh, kvp, ps, ...]
    return r.reshape(l, p, kh, page, *trail)


def pages_to_cache(pages, kvp: int):
    """Inverse of ``cache_to_pages``: ``[L, P, Kh, page, ...]`` ->
    ``[L, Kh, P*page, ...]`` fixed rank-major round-robin cache."""
    l, p, kh, page = pages.shape[:4]
    trail = pages.shape[4:]
    r = pages.reshape(l, p, kh, kvp, page // kvp, *trail)
    r = r.movedim(1, 3)                             # [L, Kh, kvp, P, ps, ...]
    return r.reshape(l, kh, p * page, *trail)


def gather_pool_pages(state: dict, phys) -> dict:
    """The pool pages ``phys`` (logical-page order) of every pool plane in
    ``state`` (K/V payloads and, in the int8 mode, the f32 scale planes) as
    ``[L, P, ...]`` stacks on the state's device: one gather per plane, for
    the host spill.  The caller makes the one device->host transfer, so
    the exact pool bytes go to the host tier."""
    some = next(state[k] for k in CACHE_KEYS if k in state)
    idx = torch.as_tensor(list(phys), dtype=torch.int64, device=some.device)
    return {key: state[key].index_select(1, idx)
            for key in CACHE_KEYS if key in state}


def scatter_pool_pages(state: dict, phys, planes: dict) -> dict:
    """Inverse of ``gather_pool_pages``, the host->device restore: each
    plane's ``[L, P, ...]`` stack is written at the physical pages ``phys``
    (granted anew at re-admission), as its bytes were spilled.  The pool
    planes are written in place (``index_copy_``): a decode window's CUDA
    graph holds their addresses.  Returns ``state``."""
    some = next(state[k] for k in CACHE_KEYS if k in state)
    idx = torch.as_tensor(list(phys), dtype=torch.int64, device=some.device)
    for key, stack in planes.items():
        plane = state[key]
        plane.index_copy_(1, idx, stack.to(device=plane.device,
                                           dtype=plane.dtype))
    return state


def state_to_paged(state: dict, tables, n_pool: int, kvp: int,
                   page: int) -> dict:
    """Fixed-layout decode state -> the equivalent paged state (test
    helper): every slot's cache rows go to the physical pages ``tables``
    [B, max_pages] names (entry 0 = sink, never written), and
    ``block_tables`` joins the state.  Slot data beyond a row's table extent
    is dropped (it must be dead).  Other leaves pass through."""
    tables = torch.as_tensor(tables, dtype=torch.int32)
    out = dict(state)
    for key in CACHE_KEYS:
        if key not in state:
            continue
        plane = state[key]                          # [L, B, Kh, S_cap, ...]
        l, b, kh = plane.shape[:3]
        pool = torch.zeros((l, n_pool, kh, page, *plane.shape[4:]),
                           dtype=plane.dtype, device=plane.device)
        for i in range(b):
            pages = cache_to_pages(plane[:, i], kvp, page)
            idx = torch.nonzero(tables[i] > 0).flatten()
            idx = idx[idx < pages.shape[1]]
            if idx.numel():
                phys = tables[i, idx].long().to(plane.device)
                pool[:, phys] = pages[:, idx.to(plane.device)]
        out[key] = pool
    out["block_tables"] = tables.to(state["kcache"].device)
    return out


def sampling_leaf_shapes(batch: int) -> dict[str, tuple[int, ...]]:
    """Shapes of the on-device sampler's leaves, one value per batch row
    (types in ``SAMPLING_TYPES``): ``sample_temp``/``sample_topp`` f32,
    ``sample_topk`` int32, ``sample_seed`` (the request's 32-bit seed, in
    int64) and ``sample_idx`` int32 (tokens sampled so far, the ``fold_in``
    counter; ``serving/sampling.py``).  A state holding ``sample_seed``
    decodes through the sampler instead of the argmax."""
    return {key: (batch,) for key in SAMPLING_TYPES}


def decode_state_shapes(cfg: ArchConfig, batch: int, seq_len: int, kvp: int,
                        rr_block: int = 16, kv_bits: int = 16,
                        pool_blocks: int = 0, max_pages: int = 0,
                        grouped: bool = False, sampling: bool = False,
                        tpa: int = 1,
                        local: bool = False) -> dict[str, tuple[int, ...]]:
    """Shape of every decode-state leaf.  Attention archs: ``kcache``/
    ``vcache``; ``pool_blocks > 0`` makes them pool planes ``[L,
    pool_blocks, Kh, page, hsz]`` beside ``block_tables [batch, max_pages]``
    (``max_pages`` defaults to ``pool_blocks``), with ``grouped`` also the
    grouped decode's ``group_id``/``group_np`` [batch] int32 leaves.  Archs
    with SSM layers: ``ssm_conv [L, batch, conv_dim, ssm_conv-1]`` and
    ``ssm_state [L, batch, nh, hd, ds]`` (both f32); a pure-SSM arch has no
    KV leaf, a hybrid has both kinds.  ``sampling`` adds
    the sampler's [batch] leaves (``sampling_leaf_shapes``)."""
    if kv_bits not in KV_BITS:
        raise ValueError(f"kv_bits={kv_bits}; choose from {KV_BITS}")
    shapes = {"total_len": ()}
    if sampling:
        shapes.update(sampling_leaf_shapes(batch))
    if cfg.has_ssm:
        shapes["ssm_conv"] = (cfg.n_layers, batch, cfg.conv_dim,
                              cfg.ssm_conv - 1)
        shapes["ssm_state"] = (cfg.n_layers, batch, cfg.ssm_heads,
                               cfg.ssm_headdim, cfg.ssm_state)
    if not cfg.has_attention:
        return shapes
    if pool_blocks > 0:
        kv = (cfg.n_layers, pool_blocks, cfg.n_kv_heads,
              page_positions(kvp, rr_block), cfg.hsz)
    elif local:
        kv = (cfg.n_layers, batch, cfg.n_kv_heads // tpa,
              cache_capacity(seq_len, kvp, rr_block) // kvp, cfg.hsz)
    else:
        kv = (cfg.n_layers, batch, cfg.n_kv_heads,
              cache_capacity(seq_len, kvp, rr_block), cfg.hsz)
    shapes.update(kcache=kv, vcache=kv)
    if pool_blocks > 0:
        shapes["block_tables"] = (batch, max_pages or pool_blocks)
        if grouped:
            shapes["group_id"] = shapes["group_np"] = (batch,)
    if kv_bits == 8:
        shapes["kscale"] = shapes["vscale"] = kv[:-1]
    return shapes


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, kvp: int,
                      rr_block: int = 16, *, dtype=torch.bfloat16,
                      device="cuda", total_len: int = 0,
                      kv_bits: int = 16, pool_blocks: int = 0,
                      max_pages: int = 0, grouped: bool = False,
                      sampling: bool = False, tpa: int = 1,
                      local: bool = False) -> dict:
    """Zero-initialised decode state on ``device`` (``kv_bits=8``: int8
    caches and f32 scale planes; ``pool_blocks > 0``: the paged layout, with
    every table row parked on the sink page 0; ``grouped``: every row its
    own group of no shared page, which decodes as ungrouped; ``sampling``:
    the sampler's leaves, zeros, which decode greedily; ``local``: one
    rank's shard of a ``kvp x tpa`` grid)."""
    shapes = decode_state_shapes(cfg, batch, seq_len, kvp, rr_block, kv_bits,
                                 pool_blocks, max_pages, grouped, sampling,
                                 tpa, local)
    types = {**SAMPLING_TYPES, "kcache": torch.int8 if kv_bits == 8 else dtype,
             "kscale": torch.float32, "block_tables": torch.int32,
             "group_id": torch.int32, "group_np": torch.int32,
             "ssm_conv": torch.float32, "ssm_state": torch.float32}
    types["vcache"], types["vscale"] = types["kcache"], types["kscale"]
    state = {k: torch.zeros(s, dtype=types[k], device=device)
             for k, s in shapes.items() if k != "total_len"}
    state["total_len"] = torch.tensor(total_len, dtype=torch.int32,
                                      device=device)
    return state


def quantize_decode_state(state: dict) -> dict:
    """fp caches -> int8 payloads + f32 scales, over the trailing hsz axis
    with the decode append's formula, so a prefilled then quantized cache
    and one grown token by token agree.  Works on fixed caches and on pool
    planes alike.  Zero slots quantize to payload 0 with scale 1e-30.
    Returns a copy of ``state`` with ``kcache``/``vcache`` replaced and
    ``kscale``/``vscale`` added."""
    out = dict(state)
    for key, skey in (("kcache", "kscale"), ("vcache", "vscale")):
        out[key], out[skey] = quantize_kv_token(state[key])
    return out
