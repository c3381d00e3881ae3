"""Fixed-layout decode state (port of the reference's ``core/kvcache.py``,
fixed layout only): round-robin KV caches ``[L, B, Kh, S_cap, hsz]`` plus
``total_len``; with ``kv_bits=8`` the caches are int8 and per-slot f32
scales ``kscale``/``vscale`` ``[L, B, Kh, S_cap]`` ride beside them."""
from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.kernels.flash_decode.ref import quantize_kv_token
from repro_torch.utils import round_up

KV_BITS = (16, 8)


def cache_capacity(cfg_seq_len: int, kvp: int, rr_block: int) -> int:
    """Smallest valid cache capacity >= seq_len (multiple of kvp*rr)."""
    return round_up(cfg_seq_len, kvp * rr_block)


def decode_state_shapes(cfg: ArchConfig, batch: int, seq_len: int, kvp: int,
                        rr_block: int = 16,
                        kv_bits: int = 16) -> dict[str, tuple[int, ...]]:
    """Shape of every decode-state leaf."""
    if kv_bits not in KV_BITS:
        raise ValueError(f"kv_bits={kv_bits}; choose from {KV_BITS}")
    cap = cache_capacity(seq_len, kvp, rr_block)
    kv = (cfg.n_layers, batch, cfg.n_kv_heads, cap, cfg.hsz)
    shapes = {"total_len": (), "kcache": kv, "vcache": kv}
    if kv_bits == 8:
        shapes["kscale"] = shapes["vscale"] = kv[:-1]
    return shapes


def init_decode_state(cfg: ArchConfig, batch: int, seq_len: int, kvp: int,
                      rr_block: int = 16, *, dtype=torch.bfloat16,
                      device="cuda", total_len: int = 0,
                      kv_bits: int = 16) -> dict:
    """Zero-initialised decode state on ``device`` (``kv_bits=8``: int8
    caches and f32 scale planes)."""
    shapes = decode_state_shapes(cfg, batch, seq_len, kvp, rr_block, kv_bits)
    types = {"kcache": torch.int8 if kv_bits == 8 else dtype,
             "kscale": torch.float32}
    types["vcache"], types["vscale"] = types["kcache"], types["kscale"]
    state = {k: torch.zeros(s, dtype=types[k], device=device)
             for k, s in shapes.items() if k != "total_len"}
    state["total_len"] = torch.tensor(total_len, dtype=torch.int32,
                                      device=device)
    return state


def quantize_decode_state(state: dict) -> dict:
    """fp round-robin caches -> int8 payloads + per-slot f32 scales, over
    the trailing hsz axis with the decode append's formula, so a prefilled
    then quantized cache and one grown token by token agree.  Zero slots
    quantize to payload 0 with scale 1e-30.  Returns a copy of ``state``
    with ``kcache``/``vcache`` replaced and ``kscale``/``vscale`` added."""
    out = dict(state)
    for key, skey in (("kcache", "kscale"), ("vcache", "vscale")):
        out[key], out[skey] = quantize_kv_token(state[key])
    return out
