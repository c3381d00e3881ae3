"""The port's Helix configuration (counterpart of the reference's
``core/sharding.py`` ``HelixConfig``).

There are no mesh axes: ``kvp`` is an integer, and KVP ranks are emulated on
one card (``core/helix.py``).  Backends are ``ref`` (plain PyTorch) or
``cuda`` (the hand-written kernels; on CPU tensors their wrappers take the
plain version).
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.registry import BACKENDS


@dataclasses.dataclass(frozen=True)
class HelixConfig:
    kvp: int = 1                 # KV-parallel width (ranks over the sequence)
    rr_block: int = 16           # round-robin block of positions (§2.3)
    attn_block_s: int = 512      # flash_decode S-block (clamped to the shard)
    attn_backend: str = "cuda"   # flash_decode family
    prefill_backend: str = "cuda"  # flash_prefill family
    fuse_append: bool = True     # the decode kernel appends the new K/V row
    prune_blocks: bool = True    # the decode kernel skips dead S blocks
    kv_cache_bits: int = 16      # 8 => int8 KV cache + per-slot f32 scales
    matmul_backend: str = "cuda"  # w8a16_matmul family (int8 lm_head)
    ssd_backend: str = "cuda"    # ssd_prefill family (Mamba2 SSD scan core)
    lm_head_w8: bool = False     # int8 lm_head through w8a16_matmul
    paged_kv: bool = False       # KV in a shared pool of pages (block tables)
    grouped_decode: bool = False  # shared-prefix pages once per group (paged)

    def __post_init__(self):
        if self.kv_cache_bits not in (16, 8):
            raise ValueError(f"kv_cache_bits={self.kv_cache_bits}; choose "
                             "16 or 8")
        for field in ("attn_backend", "prefill_backend", "matmul_backend",
                      "ssd_backend"):
            if getattr(self, field) not in BACKENDS:
                raise ValueError(f"{field}={getattr(self, field)!r}; choose "
                                 f"from {BACKENDS}")
        if self.kvp < 1 or self.rr_block < 1:
            raise ValueError(f"kvp and rr_block must be >= 1 ({self})")
