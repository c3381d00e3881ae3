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
    ``w2`` [E, Fe, H]."""

    def __init__(self, moe: MoEConfig, d_model: int):
        super().__init__()
        e, fe, h = moe.n_experts, moe.d_ff, d_model
        self.router = nn.Parameter(torch.empty(h, e), requires_grad=False)
        self.w1 = nn.Parameter(torch.empty(e, h, fe), requires_grad=False)
        self.w3 = nn.Parameter(torch.empty(e, h, fe), requires_grad=False)
        self.w2 = nn.Parameter(torch.empty(e, fe, h), requires_grad=False)


# the leaf the reference keeps in f32 whatever the model's dtype
F32_LEAVES = ("router",)


@torch.no_grad()
def init_moe(mp: MoEParams, moe: MoEConfig, d_model: int, gen) -> MoEParams:
    """The reference's distributions (``init_moe``), in place: router
    normal x 0.02, ``w1``/``w3`` x H^-0.5, ``w2`` x Fe^-0.5 (no depth
    factor); drawn in f32 from ``gen`` and cast to each leaf's dtype."""
    for p, std in ((mp.router, 0.02), (mp.w1, d_model ** -0.5),
                   (mp.w3, d_model ** -0.5), (mp.w2, moe.d_ff ** -0.5)):
        p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
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
    the model's dtype and summed over the k choices."""
    t, h = x.shape
    cf = capacity_factor or moe.capacity_factor
    r = route(mp.router, x, moe)
    if t % groups:
        raise ValueError(f"{t} tokens do not split into {groups} groups")
    g, tg, k, e = groups, t // groups, moe.topk, moe.n_experts
    cap = capacity(tg, moe, cf)
    eig = r.expert_idx.reshape(g, tg, k)
    gag = r.gates.reshape(g, tg, k)
    slot_of, tok_of = _dispatch_plans(eig, e, cap)
    xe = torch.take_along_dim(_pad_row(x.reshape(g, tg, h)),
                              tok_of.long()[..., None], dim=1)  # [G, E*C, H]
    xe = xe.reshape(g, e, cap, h).transpose(0, 1).reshape(e, g * cap, h)
    ye = expert_ffn(mp, xe, act)
    ye = ye.reshape(e, g, cap, h).transpose(0, 1).reshape(g, e * cap, h)
    src = eig.long() * cap + torch.clamp(slot_of, max=cap - 1)
    src = torch.where(slot_of < cap, src, e * cap)         # dropped -> zero
    yk = torch.take_along_dim(_pad_row(ye), src.reshape(g, tg * k, 1), dim=1)
    yk = yk.reshape(g, tg, k, h)
    y = torch.sum(yk * gag[..., None].to(ye.dtype), dim=2)
    return y.reshape(t, h), r.aux_loss
