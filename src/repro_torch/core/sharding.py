"""The port's Helix configuration (counterpart of the reference's
``core/sharding.py`` ``HelixConfig`` and ``default_helix_config``).

There are no mesh axes: ``kvp`` and ``tpa`` are integers.  Without a rank
group the KVP ranks are emulated on one card (``core/helix.py``) and
``tpa`` must be 1.  With one (``core/dist.HelixGroup``) the ``kvp * tpa``
processes are the ranks, numbered ``rank = t * kvp + k`` for TPA index t
(the query/KV head group) and KVP index k (the sequence shard): the
tpa-major, kvp-minor order of the reference's ``helix_attention`` out spec,
which every sharded weight and every collective follows.  An MoE arch's
experts go over the same ranks as ``ep x tpf`` (EP x TPF, ``tpf = world /
ep``): the reference's ``ep_axis="data"`` over its ``(world / model,
model)`` mesh, each rank's expert range and expert-FFN column slice read
off its mesh coordinate (``RankLayout.e``, ``RankLayout.f``).  Backends are
``ref`` (plain PyTorch) or ``cuda`` (the hand-written kernels; on CPU
tensors their wrappers take the plain version).
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.registry import BACKENDS
from repro_torch.utils import round_up


@dataclasses.dataclass(frozen=True)
class HelixConfig:
    kvp: int = 1                 # KV-parallel width (ranks over the sequence)
    tpa: int = 1                 # attention TP width (ranks over KV heads)
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
    ep: int = 1                  # expert-parallel width (MoE; 1 for dense)

    def __post_init__(self):
        if self.kv_cache_bits not in (16, 8):
            raise ValueError(f"kv_cache_bits={self.kv_cache_bits}; choose "
                             "16 or 8")
        for field in ("attn_backend", "prefill_backend", "matmul_backend",
                      "ssd_backend"):
            if getattr(self, field) not in BACKENDS:
                raise ValueError(f"{field}={getattr(self, field)!r}; choose "
                                 f"from {BACKENDS}")
        if min(self.kvp, self.tpa, self.rr_block, self.ep) < 1:
            raise ValueError(f"kvp, tpa, rr_block and ep must be >= 1 "
                             f"({self})")

    @property
    def world(self) -> int:
        """Ranks of the attention phase, re-used as TP = world after it."""
        return self.kvp * self.tpa

    @property
    def tpf(self) -> int:
        """TP width of each expert's FFN (MoE): world / ep."""
        return self.world // self.ep


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """One rank's place in a ``kvp x tpa`` grid: ``rank = t * kvp + k``;
    for an MoE arch also in the ``ep x tpf`` grid of the experts."""
    rank: int
    kvp: int
    tpa: int = 1
    ep: int = 1

    def __post_init__(self):
        if not 0 <= self.rank < self.kvp * self.tpa:
            raise ValueError(f"rank {self.rank} outside a {self.kvp} x "
                             f"{self.tpa} grid")
        if self.ep < 1 or self.world % self.ep:
            raise ValueError(f"ep={self.ep} does not divide {self.world} "
                             "ranks")

    @property
    def world(self) -> int:
        return self.kvp * self.tpa

    @property
    def t(self) -> int:
        """TPA index: the rank's group of query and KV heads."""
        return self.rank // self.kvp

    @property
    def k(self) -> int:
        """KVP index: the rank's shard of the sequence (slot) axis."""
        return self.rank % self.kvp

    @property
    def tpf(self) -> int:
        return self.world // self.ep

    @property
    def mesh_index(self) -> int:
        """``d * model + m`` of the rank's coordinate (d, m) on the
        reference's ``(world / model, model)`` mesh: KVP runs over d (and
        over m too when TPA is 1), TPA over m, so it is ``k * tpa + t``."""
        return self.k * self.tpa + self.t

    @property
    def e(self) -> int:
        """EP index: the rank's range of experts (the mesh's d)."""
        return self.mesh_index // self.tpf

    @property
    def f(self) -> int:
        """TPF index: the rank's slice of each expert's FFN (the mesh's
        m)."""
        return self.mesh_index % self.tpf


def default_helix_config(cfg, world: int, model: int = 1) -> HelixConfig:
    """The reference's rule over a ``(world / model, model)`` mesh: TPA =
    ``model`` when the arch has at least that many KV heads (TPA <= K),
    else pure KVP over every rank; KVP = world / TPA; an MoE arch's
    experts over EP = world / model (the mesh's data axis), each expert's
    FFN over TPF = model."""
    if world < 1 or model < 1 or world % model:
        raise ValueError(f"a mesh of {world} ranks has no axis of {model}")
    tpa = model if cfg.n_kv_heads >= model else 1
    return HelixConfig(kvp=world // tpa, tpa=tpa,
                       ep=world // model if cfg.moe else 1)


def local_config(cfg, tpa: int):
    """``cfg`` with the head counts of one TPA group (head size kept): the
    shapes of a rank's attention."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tpa,
                               n_kv_heads=cfg.n_kv_heads // tpa,
                               head_dim=cfg.hsz)


def check_ranks(cfg, hx: HelixConfig) -> None:
    """Raise ``ValueError`` for what the multi-rank path does not take:
    archs other than dense attention with a dense FFN and the mixture of
    experts (SSM, hybrid, enc-dec, vlm); a TPA that does not divide the KV
    and the query heads; a flat head dim that needs padding under TPA (the
    reference allows the pad in pure-KVP mode only); a ``d_ff`` that does
    not split over every rank (the reference's '2d' FFN fallback is not
    ported); an EP that does not divide the ranks or the experts, a TPF
    that does not divide the experts' ``d_ff``, an EP above 1 for an arch
    without experts."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(f"across ranks the port serves the dense and moe "
                         f"families ({cfg.name} is {cfg.family})")
    if cfg.moe is None and hx.ep != 1:
        raise ValueError(f"ep={hx.ep}: {cfg.name} has no experts")
    if hx.world % hx.ep:
        raise ValueError(f"ep={hx.ep} does not divide {hx.world} ranks")
    if cfg.moe is not None and cfg.moe.n_experts % hx.ep:
        raise ValueError(f"ep={hx.ep} does not divide {cfg.name}'s "
                         f"{cfg.moe.n_experts} experts")
    if cfg.moe is not None and cfg.moe.d_ff % hx.tpf:
        raise ValueError(f"tpf={hx.tpf} does not divide {cfg.name}'s expert "
                         f"d_ff={cfg.moe.d_ff}")
    if cfg.n_kv_heads % hx.tpa or cfg.n_heads % hx.tpa:
        raise ValueError(f"tpa={hx.tpa} must divide {cfg.name}'s "
                         f"{cfg.n_heads} query and {cfg.n_kv_heads} KV heads")
    q_loc = cfg.n_heads // hx.tpa * cfg.hsz
    if hx.tpa > 1 and round_up(q_loc, hx.kvp) != q_loc:
        raise ValueError(f"tpa={hx.tpa}: the flat head dim {q_loc} does not "
                         f"split over kvp={hx.kvp} (padding is pure-KVP only)")
    if cfg.d_ff % hx.world:
        raise ValueError(f"d_ff={cfg.d_ff} does not split over {hx.world} "
                         "ranks; the reference's '2d' FFN fallback is not "
                         "ported")
