"""Architecture configs of the port: only the fields its serving paths read
(dense GQA with a gated or an ungated FFN, local:global windowed attention,
pure SSM, the attention + SSM hybrid, the mixture of experts, the
encoder-decoder and the vision-language stub), plus ``get_config``.
Mirrors ``repro/configs/base.py``."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from repro_torch.utils import round_up


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    topk: int
    d_ff: int                      # per-expert intermediate dim
    capacity_factor: float = 1.25  # prefill (train-time) capacity factor
    decode_capacity_factor: float = 4.0
    router_z_coef: float = 1e-3
    aux_coef: float = 1e-2


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | ssm | hybrid | moe | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    act: str = "silu"           # silu, gelu_gated (gated: w3) | gelu (ungated)
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    use_rope: bool = True       # False -> sinusoidal positions on the input
    softcap: float = 0.0        # final-logit softcap cap * tanh(x / cap); 0 off
    # local/global attention mix: local_ratio windowed layers of
    # local_window positions, then one global layer (0: all global)
    local_window: int = 0
    local_ratio: int = 0
    # Mamba2 (SSD) block
    ssm_state: int = 0          # N (dstate)
    ssm_conv: int = 4           # depthwise causal conv width
    ssm_headdim: int = 64       # P
    ssm_expand: int = 2
    ssm_ngroups: int = 1
    moe: MoEConfig | None = None  # routed experts beside or instead of d_ff
    # encoder-decoder (whisper): a bidirectional encoder of enc_layers over
    # frame embeddings, cross-attention in every decoder layer
    is_encdec: bool = False
    enc_layers: int = 0
    enc_seq_ratio: int = 1      # encoder frames per decoder token in shapes
    # vlm stub front end: patch embeddings replace the first vision_patches
    # token embeddings
    vision_patches: int = 0

    @property
    def hsz(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.hsz

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.hsz

    @property
    def padded_vocab(self) -> int:
        # the reference pads to 512 (its largest mesh); kept so logits and
        # weights have the same shapes on both sides
        return round_up(self.vocab, 512)

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.ssm_state > 0 and self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        # mamba2: the conv acts on the (x, B, C) channels
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (the reference's
        ``ArchConfig.reduced`` rule: one whole local:global period and a
        window of at most 32 for windowed archs, else 2 layers; at most 8
        experts, top at most 2, expert ``d_ff`` 64 and a capacity factor of
        8, so that reduced prefills drop no token; at most 2 encoder layers
        and 8 patches; the vlm family keeps MHA)."""
        moe = self.moe and dataclasses.replace(
            self.moe, n_experts=min(self.moe.n_experts, 8),
            topk=min(self.moe.topk, 2), d_ff=64, capacity_factor=8.0)
        n_heads = min(self.n_heads, 4)
        return dataclasses.replace(
            self, name=self.name + "-reduced",
            n_layers=(self.local_ratio + 1 if self.local_ratio
                      else min(self.n_layers, 2)), d_model=128,
            n_heads=n_heads,
            n_kv_heads=(n_heads if self.family == "vlm"
                        else min(self.n_kv_heads, 2)), head_dim=32,
            d_ff=256 if self.d_ff else 0, vocab=512,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=32 if self.has_ssm else self.ssm_headdim, moe=moe,
            local_window=min(self.local_window, 32),
            enc_layers=min(self.enc_layers, 2),
            vision_patches=min(self.vision_patches, 8))


# granite-3-2b [dense] — GQA, hf:ibm-granite/granite-3.0-2b-base.
GRANITE_3_2B = ArchConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048,
    n_heads=32, n_kv_heads=8, d_ff=8192, vocab=49_155, tie_embeddings=True)

# mamba2-780m [ssm] — SSD (state-space duality), arXiv:2405.21060:
# attention-free, no FFN (the gated MLP lives in the block's expand),
# sinusoidal input positions, tied embeddings.
MAMBA2_780M = ArchConfig(
    name="mamba2-780m", family="ssm", n_layers=48, d_model=1536, n_heads=0,
    n_kv_heads=0, head_dim=64, d_ff=0, vocab=50_280, use_rope=False,
    tie_embeddings=True, ssm_state=128, ssm_conv=4, ssm_headdim=64,
    ssm_expand=2, ssm_ngroups=1)

# hymba-1.5b [hybrid] — attention and Mamba2 heads side by side in every
# layer, arXiv:2411.13676: GQA 25 q / 5 kv heads of 64, SSD state 16,
# untied head.  At one card the 25/5 heads need no padding.
HYMBA_1_5B = ArchConfig(
    name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
    n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab=32_001,
    ssm_state=16, ssm_conv=4, ssm_headdim=64, ssm_expand=2, ssm_ngroups=1)

# granite-moe-1b-a400m [moe] — hf:ibm-granite/granite-3.0-1b-a400m-base:
# GQA 16 q / 8 kv heads of 64, every FFN a mixture of 32 experts of d_ff
# 512 with top-8 routing (no dense FFN), tied embeddings.
GRANITE_MOE_1B_A400M = ArchConfig(
    name="granite-moe-1b-a400m", family="moe", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=8, d_ff=0, vocab=49_155, tie_embeddings=True,
    moe=MoEConfig(n_experts=32, topk=8, d_ff=512))

# gemma3-12b [dense, windowed] — Gemma 3, arXiv:2503.19786: 5 local layers
# (1024-token sliding window) then 1 global, GQA 16 q / 8 kv heads of 256,
# gated GELU (tanh form), final-logit softcap 30, tied embeddings.
# As in the JAX package: no q/k norms, no sandwich norms, no sqrt(d) embedding
# scale, one RoPE base for all layers, and a vocab of 262144 (not 262208).
GEMMA3_12B = ArchConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840,
    n_heads=16, n_kv_heads=8, head_dim=256, d_ff=15_360, vocab=262_144,
    act="gelu_gated", local_window=1024, local_ratio=5, tie_embeddings=True,
    softcap=30.0)

# starcoder2-15b [dense] — arXiv:2402.19173: GQA 48 q / 4 kv heads of 128
# (G = 12), ungated GELU MLP (no w3), untied head.  As in the JAX package:
# no biases, RMSNorm and a RoPE base of 1e4 (the published model has biases,
# LayerNorm and a base of 1e5).
STARCODER2_15B = ArchConfig(
    name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
    n_heads=48, n_kv_heads=4, d_ff=24_576, vocab=49_152, act="gelu")

# granite-8b [dense] — arXiv:2405.04324 (granite-8b-code): llama layout, GQA
# 32 q / 8 kv heads of 128, gated SiLU, untied head.  As in the JAX package:
# no biases and a RoPE base of 1e4, not the published checkpoint's own.
GRANITE_8B = ArchConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14_336, vocab=49_152)

# llama-405b [dense] — the paper's dense model (Llama 3.1 405B): GQA 128 q /
# 8 kv heads of 128 (G = 16), gated SiLU, untied head.  As in the JAX
# package: a RoPE base of 1e4 and no RoPE scaling (the published model has
# a base of 5e5 and llama-3.1's scaling).
LLAMA_405B = ArchConfig(
    name="llama-405b", family="dense", n_layers=126, d_model=16_384,
    n_heads=128, n_kv_heads=8, d_ff=53_248, vocab=128_256)

# whisper-base [audio] — encoder-decoder, arXiv:2212.04356: 6 encoder and 6
# decoder layers, MHA 8 heads of 64, ungated GELU, sinusoidal positions (no
# RoPE), untied head.  As in the JAX package: the conv audio front end is a
# stub (callers pass frame embeddings [B, S_enc, d_model]) and every norm is
# an RMSNorm without biases.
WHISPER_BASE = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512, n_heads=8,
    n_kv_heads=8, d_ff=2048, vocab=51_865, act="gelu", use_rope=False,
    is_encdec=True, enc_layers=6, enc_seq_ratio=1)

# phi-3-vision-4.2b [vlm] — hf:microsoft/Phi-3-vision-128k-instruct: the
# phi-3-mini backbone, MHA 32 heads of 96, gated SiLU, untied head.  As in
# the JAX package: the CLIP tower is a stub (callers pass 256 patch
# embeddings [B, P, d_model], which replace the first P token embeddings),
# one RoPE base of 1e4 and no su-scaling.
PHI_3_VISION_4_2B = ArchConfig(
    name="phi-3-vision-4.2b", family="vlm", n_layers=32, d_model=3072,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab=32_064, vision_patches=256)

# arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base: GQA 56 q / 8 kv
# heads of 128, every layer a dense residual FFN (d_ff 4864) beside a
# mixture of 128 experts of d_ff 4864 with top-2 routing, untied head.
ARCTIC_480B = ArchConfig(
    name="arctic-480b", family="moe", n_layers=35, d_model=7168, n_heads=56,
    n_kv_heads=8, d_ff=4864, vocab=32_000,
    moe=MoEConfig(n_experts=128, topk=2, d_ff=4864))

_CONFIGS = {c.name: c for c in (GRANITE_3_2B, MAMBA2_780M, HYMBA_1_5B,
                                GRANITE_MOE_1B_A400M, ARCTIC_480B, GEMMA3_12B,
                                STARCODER2_15B, GRANITE_8B, LLAMA_405B,
                                WHISPER_BASE, PHI_3_VISION_4_2B)}


def get_config(name: str) -> ArchConfig:
    if name not in _CONFIGS:
        raise KeyError(f"unknown arch {name!r}; the port serves "
                       f"{sorted(_CONFIGS)}")
    return _CONFIGS[name]


def list_archs() -> list[str]:
    return sorted(_CONFIGS)
