"""On-device token sampling (port of the reference's ``serving/sampling.py``):
the decode epilogue over the lm_head logits.

Semantics (per batch row; every row carries its own ``(temp, top_k, top_p,
seed, idx)``, so one batch mixes greedy and sampled requests):

  * ``temp <= 0`` -- greedy: the argmax over the vocab-masked logits, the
    same token as the argmax-only epilogue;
  * ``temp > 0`` -- a Gumbel-max sample over ``logits / temp`` restricted
    by the top-k and/or top-p masks;
  * top-k (``0 < k < V``) keeps entries >= the k-th largest scaled logit
    (ties at the threshold stay in);
  * top-p (``0 < p < 1``) keeps the smallest nucleus whose *preceding*
    cumulative probability is ``< p`` (the most probable token stays in).

Randomness: row ``b`` draws its noise from the key ``fold_in(PRNGKey(
seed[b]), idx[b])``, where ``idx`` counts the tokens already sampled for the
request, so a request's stream is a function of its prompt, its policy and
its seed alone: independent of the batch, the slot and the decode window.
The noise is part of the spec, so the port computes JAX's threefry2x32
stream in integer arithmetic (``jax_threefry_partitionable``, the default
since JAX 0.5):

  * the key of a 32-bit seed is ``(0, seed)``;
  * ``fold_in(k, d) = threefry2x32(k, (0, d))``;
  * the bits of element ``i`` are ``x0 ^ x1`` of ``threefry2x32(k, (0, i))``;
  * uniform: ``((bits >> 9) | 0x3f800000)`` as f32, minus 1, then ``* (1 -
    tiny) + tiny`` and ``max(tiny, .)``;
  * Gumbel: ``-log(-log(u))``.

The 32-bit words are held in int64 tensors masked to 32 bits (torch's
``uint32`` lacks most operations).  Each ``log`` is taken in float64 and
rounded to float32 once, so the noise is the correctly rounded value of each
step on any device (the card and the CPU give the same bits); XLA's f32
``log`` may differ from it in the last ulp.

The reference computes all of this outside any Pallas kernel, so it stays
plain PyTorch here as well.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["SAMPLING_KINDS", "SamplingParams", "request_seed",
           "threefry2x32", "prng_key", "fold_in", "random_bits", "uniform",
           "gumbel_noise", "sample_tokens"]

SAMPLING_KINDS = ("greedy", "temperature", "top_k", "top_p")

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request (or engine-default) sampling policy: ``kind`` picks the
    rule (``SAMPLING_KINDS``), ``temperature`` applies to every non-greedy
    kind, ``top_k``/``top_p`` to their kinds only; ``seed`` is the base
    seed that ``request_seed`` combines with the request id."""
    kind: str = "greedy"
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        """Refuse knobs out of their domain (a bad row samples garbage)."""
        if self.kind not in SAMPLING_KINDS:
            raise ValueError(f"kind {self.kind!r} not in {SAMPLING_KINDS}")
        if self.kind != "greedy" and self.temperature <= 0.0:
            raise ValueError("non-greedy sampling needs temperature > 0 "
                             f"(got {self.temperature}); use kind='greedy' "
                             "for argmax")
        if self.kind == "top_k" and self.top_k < 1:
            raise ValueError(f"top_k kind needs top_k >= 1 ({self.top_k})")
        if self.kind == "top_p" and not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1] ({self.top_p})")

    def row(self) -> tuple[float, int, float]:
        """``(temp, top_k, top_p)`` of one request row: greedy is ``temp =
        0``; knobs foreign to ``kind`` take their no-op values."""
        if self.kind == "greedy":
            return 0.0, 0, 1.0
        if self.kind == "temperature":
            return float(self.temperature), 0, 1.0
        if self.kind == "top_k":
            return float(self.temperature), int(self.top_k), 1.0
        return float(self.temperature), 0, float(self.top_p)


def request_seed(seed: int, rid: int) -> int:
    """Per-request seed from the policy ``seed`` and the request id: requests
    sharing one policy draw different streams, and a request replays its
    own stream in any engine configuration."""
    return (int(seed) * 1_000_003 + int(rid) * 7_919) % (2**31 - 1)


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the words ``(x0, x1)`` under the key
    ``(k0, k1)``; int64 tensors (or ints) holding 32-bit values, broadcast
    together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed):
    """The threefry key ``(0, seed)`` of 32-bit seeds ([B] tensor)."""
    seed = torch.as_tensor(seed).to(torch.int64) & M32
    return torch.zeros_like(seed), seed


def fold_in(key, data):
    """``jax.random.fold_in``: the key ``threefry2x32(key, (0, data))``."""
    data = torch.as_tensor(data, device=key[0].device).to(torch.int64) & M32
    return threefry2x32(key[0], key[1], torch.zeros_like(data), data)


def random_bits(key, n: int):
    """``jax.random.bits(key, (n,), uint32)`` of a batch of keys ([B] words
    each): ``[B, n]`` int64 holding the 32-bit values."""
    k0, k1 = key
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    x0, x1 = threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(i), i)
    return x0 ^ x1


def uniform(bits):
    """JAX's f32 uniform on ``[tiny, 1)`` from 32-bit draws."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    f = f * (1.0 - TINY) + TINY
    return torch.clamp(f, min=TINY)


def _log32(x):
    """float32 log, correctly rounded (taken in float64, rounded once)."""
    return torch.log(x.double()).float()


def gumbel_noise(seed, idx, n: int):
    """Per-row Gumbel(0, 1) noise ``[B, n]`` f32: row ``b`` uses the key
    ``fold_in(PRNGKey(seed[b]), idx[b])`` (``seed`` [B] 32-bit values,
    ``idx`` [B] int)."""
    key = fold_in(prng_key(seed), idx)
    u = uniform(random_bits(key, n))
    return -_log32(-_log32(u))


def sample_tokens(logits, temp, top_k, top_p, seed, idx):
    """The sampling epilogue (module doc): ``logits`` [B, V] vocab-masked
    (pad lanes at -1e30), ``temp``/``top_p`` [B] f32, ``top_k``/``idx`` [B]
    int32, ``seed`` [B] int64 holding 32-bit seeds.  Returns [B] int32
    tokens.  The reference's operations one for one; rows with ``temp <=
    0`` return the plain argmax."""
    logits = logits.float()
    b, v = logits.shape
    greedy = temp <= 0.0
    t = torch.where(greedy, torch.ones_like(temp), temp)
    scaled = logits / t[:, None]
    # top-k: keep entries >= the k-th largest (k outside (0, V) keeps all)
    k_eff = torch.where((top_k > 0) & (top_k < v), top_k,
                        torch.full_like(top_k, v))
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, (k_eff - 1).long()[:, None])
    masked = scaled.masked_fill(~(scaled >= kth), float("-inf"))
    # top-p nucleus over the top-k-restricted softmax
    p_eff = torch.where((top_p > 0.0) & (top_p < 1.0), top_p,
                        torch.ones_like(top_p))
    e = torch.exp(masked - masked.max(dim=-1, keepdim=True).values)
    probs = e / e.sum(dim=-1, keepdim=True)
    sp = torch.sort(probs, dim=-1, descending=True).values
    before = torch.cumsum(sp, dim=-1) - sp
    nkeep = torch.clamp((before < p_eff[:, None]).sum(dim=-1), min=1)
    thresh = torch.gather(sp, 1, (nkeep - 1)[:, None])
    final = masked.masked_fill(~(probs >= thresh), float("-inf"))
    g = gumbel_noise(seed, idx, v)
    sampled = torch.argmax(final + g, dim=-1)
    out = torch.where(greedy, torch.argmax(logits, dim=-1), sampled)
    return out.to(torch.int32)
