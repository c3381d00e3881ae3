"""Carry the reference's parameters over to the port.

``params_from_jax(params_np, cfg)`` takes the JAX parameter pytree as nested
dicts of numpy arrays (``layers`` leaves stacked ``[L, ...]``) and returns a
``Transformer`` with the same values.  It fails on any leaf it does not
consume and on any port parameter it does not fill.  The reference's
pre-quantized int8 head (``lm_head_q8`` [d, Vp] int8 and ``lm_head_scale``
[Vp] f32, from its ``quantize_lm_head``) is taken when both are present and
copied exactly into the model's buffers of those names.  SSM layers take
the ``layers/ssm/*`` leaves (``w_in``, ``conv_w``, ``conv_b``, ``A_log``,
``D``, ``dt_bias``, ``norm_w``, ``w_out``), a hybrid layer both its
``attn`` and ``ssm`` leaves; an MoE layer its ``layers/moe/*`` leaves
(``router``, ``w1``, ``w3``, ``w2``); an untied model takes ``lm_head``
[d, Vp]; an enc-dec model its decoder layers' ``lnx`` and ``xattn/*``
leaves and the encoder's ``enc/layers/*`` (stacked ``[enc_layers, ...]``)
and ``enc/ln_f``; a ``dtype`` leaves the four the reference keeps in f32
(``A_log``, ``D``, ``dt_bias`` and the MoE ``router``) in f32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ArchConfig
from repro_torch.models.transformer import Transformer, cast_params


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _flatten(v, name + ".")
        else:
            yield name, v


@torch.no_grad()
def params_from_jax(params_np: dict, cfg: ArchConfig, *, dtype=None,
                    device="cpu") -> Transformer:
    """Reference pytree (numpy leaves) -> ``Transformer`` on ``device``
    (``dtype`` defaults to the leaves' own)."""
    model = Transformer(cfg)
    ours = dict(model.named_parameters())
    filled: set[str] = set()
    params_np = dict(params_np)
    head = [params_np.pop(k, None) for k in ("lm_head_q8", "lm_head_scale")]
    if (head[0] is None) != (head[1] is None):
        raise KeyError("lm_head_q8 and lm_head_scale come as a pair")
    stacks = (("layers.", cfg.n_layers), ("enc.layers.", cfg.enc_layers))
    for name, leaf in _flatten(params_np):
        leaf = np.asarray(leaf)
        targets = [(name, leaf)]
        for prefix, n in stacks:
            if name.startswith(prefix):
                if leaf.shape[0] != n:
                    raise ValueError(f"{name}: leading dim {leaf.shape[0]} "
                                     f"!= {n} layers")
                rest = name[len(prefix):]
                targets = [(f"{prefix}{i}.{rest}", leaf[i]) for i in range(n)]
        for tname, arr in targets:
            if tname not in ours:
                raise KeyError(f"reference leaf {name!r} has no port "
                               f"parameter ({tname!r})")
            p = ours[tname]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{tname}: shape {arr.shape} != "
                                 f"{tuple(p.shape)}")
            p.data = torch.from_numpy(np.array(arr, copy=True))
            filled.add(tname)
    missing = sorted(set(ours) - filled)
    if missing:
        raise KeyError(f"port parameters not filled: {missing[:8]}")
    model = cast_params(model, device=device, dtype=dtype)
    if head[0] is not None:
        qw, scale = np.asarray(head[0]), np.asarray(head[1])
        want = ((cfg.d_model, cfg.padded_vocab), (cfg.padded_vocab,))
        if (qw.shape, scale.shape) != want or qw.dtype != np.int8 \
                or scale.dtype != np.float32:
            raise ValueError(f"lm_head_q8/lm_head_scale must be int8 {want[0]}"
                             f" and float32 {want[1]} (got {qw.dtype} "
                             f"{qw.shape}, {scale.dtype} {scale.shape})")
        model.lm_head_q8 = torch.from_numpy(qw.copy()).to(device)
        model.lm_head_scale = torch.from_numpy(scale.copy()).to(device)
    return model
