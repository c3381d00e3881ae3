"""One rank's share of a dense model (the port's counterpart of the
reference's ``helix_param_specs``, ``core/sharding.py``).

``shard_model(model, cfg, group)`` slices a whole ``Transformer`` (made by
``init_params`` or ``convert.params_from_jax``, the same on every rank)
into rank ``(t, k)``'s ``Transformer`` (``rank = t * kvp + k``, ``N = kvp
* tpa`` ranks):

* ``wq``/``wk``/``wv``: the columns of TPA group t's heads, the same on
  every KVP rank of the group (the paper's choice: each KVP rank projects
  its group's full QKV);
* ``wo``: the rows of the rank's flat slice, positions ``[k*sl, (k+1)*sl)``
  of group t's flat ``Qh/tpa * hsz`` dim padded to a multiple of kvp
  (``helix_out_dim``; pad rows zero), which is where ``helix_attention``
  leaves the rank's output;
* the FFN: ``w1``/``w3`` columns and ``w2`` rows ``[r*F/N, (r+1)*F/N)``;
* the head: vocab columns ``[r*Vn, (r+1)*Vn)`` of the padded vocab
  (``Vn = ceil(Vp / N)``, zero columns past it), kept in the whole head's
  memory layout: ``lm_head`` columns, or for a tied model ``head_rows``,
  the rows of ``embed`` read transposed (``transformer.head_weight``), so
  that one rank multiplies as the single-process step does; the logits are
  all-gathered over the ranks and cut back to Vp;
* the embedding and the norms: whole on every rank.

The rank model's ``layout`` is its ``RankLayout``.  The prefill and the
decode step run over it through ``transformer.forward(group=)`` and
``decode_model.build_serve_step(group=)``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs import ArchConfig
from repro_torch.core.helix import helix_out_dim
from repro_torch.core.sharding import HelixConfig, check_ranks
from repro_torch.models.transformer import Transformer
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


def _cols(w, lo, n):
    """Columns ``[lo, lo + n)`` of ``w``, zero past its end."""
    out = w[..., lo:lo + n]
    return torch.nn.functional.pad(out, (0, n - out.shape[-1]))


@torch.no_grad()
def shard_model(model: Transformer, cfg: ArchConfig, group) -> Transformer:
    """Rank ``group.layout``'s share of ``model`` (module doc), on the
    model's device, as contiguous copies."""
    lay = getattr(group, "layout", group)
    check_ranks(cfg, HelixConfig(kvp=lay.kvp, tpa=lay.tpa))
    n, r = lay.world, lay.rank
    qh, kh = cfg.q_dim // lay.tpa, cfg.kv_dim // lay.tpa
    start, sl, _ = flat_slice(cfg, lay)
    f = cfg.d_ff // n
    with torch.device("meta"):
        local = Transformer(cfg)

    def put(mod, name, t):
        mod._parameters[name] = nn.Parameter(t.contiguous().clone(),
                                             requires_grad=False)

    put(local, "embed", model.embed)
    put(local, "ln_f", model.ln_f)
    vn = vocab_slice(cfg, n)
    if cfg.tie_embeddings:
        put(local, "head_rows", _cols(model.embed.T, r * vn, vn).T)
    else:
        put(local, "lm_head", _cols(model.lm_head, r * vn, vn))
    for src, dst in zip(model.layers, local.layers):
        put(dst, "ln1", src.ln1)
        put(dst, "ln2", src.ln2)
        a, la = src.attn, dst.attn
        put(la, "wq", a.wq[:, lay.t * qh:(lay.t + 1) * qh])
        put(la, "wk", a.wk[:, lay.t * kh:(lay.t + 1) * kh])
        put(la, "wv", a.wv[:, lay.t * kh:(lay.t + 1) * kh])
        put(la, "wo", _cols(a.wo.T, start, sl).T)
        for name in ("w1", "w3"):
            if hasattr(src.ffn, name):
                w = getattr(src.ffn, name)
                put(dst.ffn, name, w[:, r * f:(r + 1) * f])
        put(dst.ffn, "w2", src.ffn.w2[r * f:(r + 1) * f])
    local.layout = lay
    return local
