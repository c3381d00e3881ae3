"""Mixture of experts: a top-k router and gather-based capacity dispatch
(port of the reference's ``models/moe.py``).

Each expert takes at most ``capacity`` tokens of a group, in token-major
order of the (token, choice) assignments; the rest are dropped (they add
nothing to the token's output).  Dispatch and combine are gathers through a
zero row appended to their source, so an empty slot reads zeros, and every
shape follows from the input's: no host sync and no data-dependent shape,
which lets the decode step run inside a CUDA graph.  The expert products
are batched matrix products over all ``E`` experts (the reference computes
them outside any Pallas kernel too).

Across ranks (``core/sharding``: EP x TPF) a rank's ``MoEParams`` hold
the experts ``[first, first + E/EP)`` and, of each, the FFN columns of its
TPF slice; ``router`` stays whole.  ``moe_ffn`` then routes every token
with the whole router (every rank gets the same routes and the same
plan), runs only its own experts' slots and returns the rank's partial
sum, zero where another rank's experts hold a choice: the sum over the
ranks is the layer's output.  ``init_moe`` draws each expert's leaves
from a stream of their own, so a rank draws only its share.

The router stays f32 in a bf16 model: its logits are ``x.float() @ router``
and the softmax runs in f32.  The top k is taken with a stable descending
sort, so on equal probabilities the lower expert index comes first, as with
``jax.lax.top_k``, on the CPU and on the card alike.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.configs import MoEConfig
from repro_torch.utils import cdiv


class MoEParams(nn.Module):
    """``router`` [H, E] (f32 in any model), ``w1``/``w3`` [E, H, Fe],
    ``w2`` [E, Fe, H]; a rank's share (module doc) holds ``E/EP`` experts
    from ``first`` and ``Fe/TPF`` columns from ``col0`` of each (plain
    attributes, 0 for the whole layer)."""

    def __init__(self, moe: MoEConfig, d_model: int):
        super().__init__()
        e, fe, h = moe.n_experts, moe.d_ff, d_model
        self.router = nn.Parameter(torch.empty(h, e), requires_grad=False)
        self.w1 = nn.Parameter(torch.empty(e, h, fe), requires_grad=False)
        self.w3 = nn.Parameter(torch.empty(e, h, fe), requires_grad=False)
        self.w2 = nn.Parameter(torch.empty(e, fe, h), requires_grad=False)
        self.first = self.col0 = 0


# the leaf the reference keeps in f32 whatever the model's dtype
F32_LEAVES = ("router",)
# stream keys of the leaves (``stream_seed``)
LEAF_KEYS = {"router": 0, "w1": 1, "w3": 2, "w2": 3}
_M64 = (1 << 64) - 1


def stream_seed(*keys: int) -> int:
    """A 63-bit generator seed for the stream keyed by ``keys`` (ints >=
    0): splitmix64 folded over them."""
    x = 0
    for key in keys:
        x = (x ^ key) + 0x9E3779B97F4A7C15 & _M64
        x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
        x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
        x ^= x >> 31
    return x >> 1


@torch.no_grad()
def init_moe(mp: MoEParams, moe: MoEConfig, d_model: int, seed: int,
             layer: int = 0) -> MoEParams:
    """The reference's distributions (``init_moe``), in place: router
    normal x 0.02, ``w1``/``w3`` x H^-0.5, ``w2`` x Fe^-0.5 (no depth
    factor).  The router is drawn whole from the stream ``(seed, layer,
    router)``, each expert's ``[H, Fe]`` (``w2``: ``[Fe, H]``) from the
    stream ``(seed, layer, leaf, expert)``, in f32 on the leaf's device;
    a share (``mp.first``, ``mp.col0``) keeps its experts' columns of
    those draws, cast to the leaf's dtype: the bits of the same slice of
    the whole layer's leaves."""
    dev = mp.w1.device

    def draw(name, expert, shape, std):
        gen = torch.Generator(device=dev).manual_seed(
            stream_seed(seed, layer, LEAF_KEYS[name], expert))
        return torch.randn(shape, generator=gen, device=dev).mul_(std)

    h, fe = d_model, moe.d_ff
    mp.router.copy_(draw("router", 0, (h, moe.n_experts), 0.02))
    cols = slice(mp.col0, mp.col0 + mp.w1.shape[2])
    for j in range(mp.w1.shape[0]):
        e = mp.first + j
        mp.w1[j].copy_(draw("w1", e, (h, fe), h ** -0.5)[:, cols])
        mp.w3[j].copy_(draw("w3", e, (h, fe), h ** -0.5)[:, cols])
        mp.w2[j].copy_(draw("w2", e, (fe, h), fe ** -0.5)[cols])
    return mp


class RouterOut(NamedTuple):
    expert_idx: torch.Tensor   # [T, k] int32
    gates: torch.Tensor        # [T, k] f32, renormalised over the top k
    aux_loss: torch.Tensor     # scalar f32: load balance + router z-loss


def route(router_w, x, moe: MoEConfig) -> RouterOut:
    """x [T, H] -> the top-k experts of each token, their gates and the
    auxiliary losses (Switch-style load balance and router z-loss)."""
    logits = x.float() @ router_w                          # [T, E]
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                   stable=True)
    gates, expert_idx = gates[:, :moe.topk], expert_idx[:, :moe.topk]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    e = moe.n_experts
    me = probs.mean(dim=0)                                 # mean router prob
    hits = expert_idx.reshape(-1, 1) == torch.arange(e, device=x.device)
    ce = hits.to(torch.float32).sum(0) / expert_idx.numel()   # dispatched
    aux = moe.aux_coef * e * torch.sum(me * ce)
    z = moe.router_z_coef * torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return RouterOut(expert_idx.to(torch.int32), gates, aux + z)


def _dispatch_plans(expert_idx, n_experts: int, capacity: int):
    """``dispatch_plan`` over a leading group axis: expert_idx [G, T, k]
    -> (slot_of [G, T, k], tok_of [G, E*C]), both int32."""
    g, t, k = expert_idx.shape
    dev = expert_idx.device
    flat_e = expert_idx.reshape(g, t * k).long()           # token-major
    # [G, E, T*k]: the scan runs along the last dim, which CUDA does in
    # parallel (along an outer dim each column is a sequential loop)
    onehot = (flat_e[:, None, :] == torch.arange(
        n_experts, device=dev)[:, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=2, dtype=torch.int32) - onehot
    slot = torch.gather(pos, 1, flat_e[:, None, :])[:, 0]  # rank in expert
    slot = torch.clamp(slot, max=capacity)                 # == C: dropped
    keep = slot < capacity
    # a dropped assignment writes to one extra slot, cut off afterwards
    flat_slot = torch.where(keep, flat_e * capacity + slot,
                            n_experts * capacity)
    tok_ids = (torch.arange(t * k, dtype=torch.int32, device=dev) // k)
    tok_of = torch.full((g, n_experts * capacity + 1), t, dtype=torch.int32,
                        device=dev)
    tok_of.scatter_(1, flat_slot, tok_ids.expand(g, -1).contiguous())
    return slot.reshape(g, t, k), tok_of[:, :-1]


def dispatch_plan(expert_idx, n_experts: int, capacity: int):
    """Token -> slot plan.  expert_idx [T, k] -> (slot_of [T, k], tok_of
    [E*C]).

    slot_of[t, j]  — the slot within its expert (== capacity: dropped);
    tok_of[e*C + c] — the token filling that slot (== T: empty slot)."""
    slot_of, tok_of = _dispatch_plans(expert_idx[None], n_experts, capacity)
    return slot_of[0], tok_of[0]


def capacity(tokens: int, moe: MoEConfig, capacity_factor: float) -> int:
    """Slots per expert for a group of ``tokens``: the reference's Python
    arithmetic, ``int(max(cdiv(tokens * k, E), 1) * cf + 0.5)``."""
    cap = max(cdiv(tokens * moe.topk, moe.n_experts), 1)
    return int(cap * capacity_factor + 0.5)


def _pad_row(x):
    """[G, N, H] -> [G, N + 1, H] with a zero row at index N."""
    return torch.cat([x, x.new_zeros(x.shape[0], 1, x.shape[2])], dim=1)


def expert_ffn(mp: MoEParams, xe, act):
    """Batched expert MLP.  xe [E, C, H] -> [E, C, H]."""
    h1 = torch.bmm(xe, mp.w1)
    h3 = torch.bmm(xe, mp.w3)
    return torch.bmm(act(h1) * h3, mp.w2)


def moe_ffn(mp: MoEParams, x, moe: MoEConfig, act,
            capacity_factor: float | None = None, groups: int = 1):
    """The MoE layer.  x [T, H] -> (y [T, H], aux_loss).

    ``groups`` splits T into groups that dispatch on their own (each with
    its own capacity).  Expert outputs are multiplied by their gates in
    the model's dtype and summed over the k choices.  Over a rank's share
    (``mp.first``, ``mp.w1.shape[0]`` experts; module doc) ``y`` is the
    rank's partial sum: the plan is the whole layer's, the slots of the
    other ranks' experts are not computed and their choices read zero
    rows; ``aux_loss`` is the whole layer's."""
    t, h = x.shape
    cf = capacity_factor or moe.capacity_factor
    r = route(mp.router, x, moe)
    if t % groups:
        raise ValueError(f"{t} tokens do not split into {groups} groups")
    g, tg, k, e = groups, t // groups, moe.topk, moe.n_experts
    e0, ne = mp.first, mp.w1.shape[0]          # the experts held here
    cap = capacity(tg, moe, cf)
    eig = r.expert_idx.reshape(g, tg, k)
    gag = r.gates.reshape(g, tg, k)
    slot_of, tok_of = _dispatch_plans(eig, e, cap)
    tok_of = tok_of[:, e0 * cap:(e0 + ne) * cap]
    xe = torch.take_along_dim(_pad_row(x.reshape(g, tg, h)),
                              tok_of.long()[..., None], dim=1)  # [G, ne*C, H]
    xe = xe.reshape(g, ne, cap, h).transpose(0, 1).reshape(ne, g * cap, h)
    ye = expert_ffn(mp, xe, act)
    ye = ye.reshape(ne, g, cap, h).transpose(0, 1).reshape(g, ne * cap, h)
    loc = eig.long() - e0
    src = loc * cap + torch.clamp(slot_of, max=cap - 1)
    # dropped, or another rank's expert -> the zero row
    here = (slot_of < cap) & (loc >= 0) & (loc < ne)
    src = torch.where(here, src, ne * cap)
    yk = torch.take_along_dim(_pad_row(ye), src.reshape(g, tg * k, 1), dim=1)
    yk = yk.reshape(g, tg, k, h)
    y = torch.sum(yk * gag[..., None].to(ye.dtype), dim=2)
    return y.reshape(t, h), r.aux_loss
