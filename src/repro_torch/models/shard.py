"""One rank's share of a dense or MoE model (the port's counterpart of the
reference's ``helix_param_specs``, ``core/sharding.py``).

``shard_model(model, cfg, group)`` slices a whole ``Transformer`` (made by
``init_params`` or ``convert.params_from_jax``, the same on every rank)
into rank ``(t, k)``'s ``Transformer`` (``rank = t * kvp + k``, ``N = kvp
* tpa`` ranks); ``init_rank_params(cfg, layout, seed)`` draws the same
share directly, bit for bit ``shard_model(init_params(cfg, seed),
layout)``, holding no more than the share and one whole non-expert leaf
(arctic-480b's experts are 26.8 GB a layer in bf16):

* ``wq``/``wk``/``wv``: the columns of TPA group t's heads, the same on
  every KVP rank of the group (the paper's choice: each KVP rank projects
  its group's full QKV);
* ``wo``: the rows of the rank's flat slice, positions ``[k*sl, (k+1)*sl)``
  of group t's flat ``Qh/tpa * hsz`` dim padded to a multiple of kvp
  (``helix_out_dim``; pad rows zero), which is where ``helix_attention``
  leaves the rank's output;
* the dense FFN (an MoE arch's dense residual too): ``w1``/``w3`` columns
  and ``w2`` rows ``[r*F/N, (r+1)*F/N)``;
* the experts (``moe.*``): EP x TPF (``RankLayout.e``, ``.f``): ``w1``/
  ``w3`` ``[E, H, Fe]`` keep experts ``[e*E/EP, (e+1)*E/EP)`` and their
  columns ``[f*Fe/TPF, (f+1)*Fe/TPF)``, ``w2`` the same experts and rows;
  ``router`` whole (``moe.moe_ffn`` routes with it and returns the rank's
  partial sum);
* the head: vocab columns ``[r*Vn, (r+1)*Vn)`` of the padded vocab
  (``Vn = ceil(Vp / N)``, zero columns past it), kept in the whole head's
  memory layout: ``lm_head`` columns, or for a tied model ``head_rows``,
  the rows of ``embed`` read transposed (``transformer.head_weight``), so
  that one rank multiplies as the single-process step does; the logits are
  all-gathered over the ranks and cut back to Vp;
* the embedding and the norms: whole on every rank.

The rank model's ``layout`` is its ``RankLayout``.  The prefill and the
decode step run over it through ``transformer.forward(group=)`` and
``decode_model.build_serve_step(group=)``; the dense FFN's and the
experts' partial sums are added before the one all-reduce of a layer's
FFN phase.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.core.helix import helix_out_dim
from repro_torch.core.sharding import HelixConfig, RankLayout, check_ranks
from repro_torch.models import moe as moe_lib
from repro_torch.models.transformer import Transformer, draw_leaf
from repro_torch.utils import cdiv


def flat_slice(cfg: ArchConfig, layout) -> tuple[int, int, int]:
    """``(start, sl, q_loc)``: the rank's ``wo`` rows ``[start, start +
    sl)`` of the whole padded flat dim, and its group's flat dim."""
    q_loc = cfg.q_dim // layout.tpa
    sl = helix_out_dim(q_loc, layout.kvp) // layout.kvp
    return layout.t * q_loc + layout.k * sl, sl, q_loc


def vocab_slice(cfg: ArchConfig, world: int) -> int:
    """Head columns per rank: the padded vocab split over ``world``."""
    return cdiv(cfg.padded_vocab, world)


def expert_slice(cfg: ArchConfig, layout) -> tuple[int, int, int, int]:
    """``(first, n, col0, cols)``: the rank's experts ``[first, first +
    n)`` and the columns ``[col0, col0 + cols)`` of each expert's FFN."""
    n, cols = cfg.moe.n_experts // layout.ep, cfg.moe.d_ff // layout.tpf
    return layout.e * n, n, layout.f * cols, cols


def _cols(w, lo, n):
    """Columns ``[lo, lo + n)`` of ``w``, zero past its end."""
    out = w[..., lo:lo + n]
    return torch.nn.functional.pad(out, (0, n - out.shape[-1]))


def leaf_share(cfg: ArchConfig, lay: RankLayout, name: str, w):
    """The rank's share (module doc) of the whole leaf ``w`` named ``name``
    (a ``named_parameters`` name): a view, or a padded copy."""
    leaf = name.rsplit(".", 1)[-1]
    if ".moe." in name:
        if leaf == "router":
            return w
        first, n, col0, cols = expert_slice(cfg, lay)
        w = w[first:first + n]
        return (w[..., col0:col0 + cols] if leaf in ("w1", "w3")
                else w[:, col0:col0 + cols])
    if ".attn." in name:
        if leaf == "wo":
            start, sl, _ = flat_slice(cfg, lay)
            return _cols(w.T, start, sl).T
        width = (cfg.q_dim if leaf == "wq" else cfg.kv_dim) // lay.tpa
        return w[:, lay.t * width:(lay.t + 1) * width]
    if ".ffn." in name:
        f, r = cfg.d_ff // lay.world, lay.rank
        return w[r * f:(r + 1) * f] if leaf == "w2" else w[:, r * f:(r + 1) * f]
    if leaf == "lm_head":
        vn = vocab_slice(cfg, lay.world)
        return _cols(w, lay.rank * vn, vn)
    return w                        # embed, ln_f, ln1, ln2


def _head_rows(cfg, lay, embed):
    """A tied model's head columns, as rows of ``embed`` (module doc)."""
    vn = vocab_slice(cfg, lay.world)
    return _cols(embed.T, lay.rank * vn, vn).T


def _put(model, name, t):
    """Set the parameter ``name`` of ``model`` to a contiguous copy of
    ``t``."""
    path, _, leaf = name.rpartition(".")
    mod = model.get_submodule(path)
    mod._parameters[leaf] = nn.Parameter(t.contiguous().clone(),
                                         requires_grad=False)


def _skeleton(cfg: ArchConfig, lay: RankLayout) -> Transformer:
    """A meta ``Transformer`` whose MoE layers know their expert range."""
    check_ranks(cfg, HelixConfig(kvp=lay.kvp, tpa=lay.tpa, ep=lay.ep))
    with torch.device("meta"):
        local = Transformer(cfg)
    if cfg.moe:
        first, _, col0, _ = expert_slice(cfg, lay)
        for lp in local.layers:
            lp.moe.first, lp.moe.col0 = first, col0
    local.layout = lay
    return local


def _layout(group) -> RankLayout:
    return getattr(group, "layout", group)


@torch.no_grad()
def shard_model(model: Transformer, cfg: ArchConfig, group) -> Transformer:
    """Rank ``group.layout``'s share of ``model`` (module doc), on the
    model's device, as contiguous copies."""
    lay = _layout(group)
    local = _skeleton(cfg, lay)
    for name, p in model.named_parameters():
        _put(local, name, leaf_share(cfg, lay, name, p))
    if cfg.tie_embeddings:
        _put(local, "head_rows", _head_rows(cfg, lay, model.embed))
    return local


@torch.no_grad()
def init_rank_params(cfg: ArchConfig, layout, seed: int = 0, *,
                     dtype=torch.float32, device="cuda") -> Transformer:
    """Rank ``layout``'s share of ``init_params(cfg, seed, dtype=dtype,
    device=device)``, bit for bit, made directly: each non-expert leaf is
    drawn whole in ``init_params``' order and cut at once; each of the
    rank's experts is drawn from its own stream (``moe.init_moe``), so no
    other expert is drawn.  ``layout`` is a ``RankLayout`` or a group."""
    lay = _layout(layout)
    local = _skeleton(cfg, lay)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device("meta"):
        whole = Transformer(cfg)
    for name, p in whole.named_parameters():
        if ".moe." in name:
            continue
        full = torch.empty(p.shape, dtype=dtype, device=device)
        full.copy_(draw_leaf(cfg, name, p.shape, gen))
        _put(local, name, leaf_share(cfg, lay, name, full))
        if name == "embed" and cfg.tie_embeddings:
            _put(local, "head_rows", _head_rows(cfg, lay, full))
        del full
    if cfg.moe:
        _, n, _, cols = expert_slice(cfg, lay)
        h = cfg.d_model
        for i, lp in enumerate(local.layers):
            mp = lp.moe
            for leaf, shape, dt in (("router", (h, cfg.moe.n_experts),
                                     torch.float32),
                                    ("w1", (n, h, cols), dtype),
                                    ("w3", (n, h, cols), dtype),
                                    ("w2", (n, cols, h), dtype)):
                mp._parameters[leaf] = nn.Parameter(
                    torch.empty(shape, dtype=dt, device=device),
                    requires_grad=False)
            moe_lib.init_moe(mp, cfg.moe, h, seed, layer=i)
    return local
