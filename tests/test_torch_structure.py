"""Structural rules of the port: it imports neither JAX nor the reference
package, its entry points run on CUDA unless told otherwise, and the
weight converter refuses leaves it does not know."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import serve_demo
from repro_torch.serving import DecodeEngine
from repro_torch.core.sharding import HelixConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for module in ("serving/sampling.py", "serving/graph.py",
                   "models/moe.py", "serving/tier.py", "serving/faults.py",
                   "serving/governor.py", "serving/workload.py"):
        assert ROOT / "src" / "repro_torch" / module in files, module
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_serve_demo_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_demo(reduced=True, n_requests=1, prompt_len=4, max_new=2)


def test_engine_on_cuda_checks_kernel_availability():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="unavailable"):
        DecodeEngine(cfg, None, None, None, max_batch=1, max_seq=8,
                     hx=HelixConfig(), device="cuda")


def test_params_from_jax_refuses_unknown_and_missing_leaves():
    cfg = get_config("granite-3-2b").reduced()
    rng = np.random.default_rng(0)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff
    tree = {
        "embed": rng.standard_normal((cfg.padded_vocab, d)),
        "ln_f": np.zeros(d),
        "layers": {
            "ln1": np.zeros((L, d)), "ln2": np.zeros((L, d)),
            "attn": {"wq": np.zeros((L, d, cfg.q_dim)),
                     "wk": np.zeros((L, d, cfg.kv_dim)),
                     "wv": np.zeros((L, d, cfg.kv_dim)),
                     "wo": np.zeros((L, cfg.q_dim, d))},
            "ffn": {"w1": np.zeros((L, d, f)), "w2": np.zeros((L, f, d)),
                    "w3": np.zeros((L, d, f))},
        },
    }
    model = params_from_jax(tree, cfg, dtype=torch.float32)
    np.testing.assert_array_equal(model.embed.numpy(),
                                  tree["embed"].astype(np.float32))
    with pytest.raises(KeyError):
        params_from_jax(dict(tree, lm_head=np.zeros((d, cfg.padded_vocab))),
                        cfg)
    layers = dict(tree["layers"])
    del layers["ln2"]
    with pytest.raises(KeyError):
        params_from_jax(dict(tree, layers=layers), cfg)
    # an untied model (hymba): lm_head is required; a tied one refuses it
    ucfg = get_config("hymba-1.5b").reduced()
    with pytest.raises(KeyError, match="lm_head"):
        params_from_jax(_hybrid_tree(ucfg, rng, head=False), ucfg)
    model = params_from_jax(_hybrid_tree(ucfg, rng), ucfg)
    assert model.lm_head.shape == (ucfg.d_model, ucfg.padded_vocab)
    tree = _hybrid_tree(ucfg, rng)
    tree["layers"]["ssm"]["extra"] = np.zeros((ucfg.n_layers, 3))
    with pytest.raises(KeyError):
        params_from_jax(tree, ucfg)


def _hybrid_tree(cfg, rng, head=True):
    """A reference-shaped pytree of a hybrid layer stack (attn, ssm, ffn and
    norms in every layer), with ``lm_head`` unless ``head`` is False."""
    L, d, f, di = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.d_inner
    nh, cd = cfg.ssm_heads, cfg.conv_dim
    n_in = 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + nh
    z = lambda *s: np.zeros(s, np.float32)
    tree = {
        "embed": rng.standard_normal((cfg.padded_vocab, d)),
        "ln_f": z(d),
        "layers": {
            "ln1": z(L, d), "ln2": z(L, d),
            "attn": {"wq": z(L, d, cfg.q_dim), "wk": z(L, d, cfg.kv_dim),
                     "wv": z(L, d, cfg.kv_dim), "wo": z(L, cfg.q_dim, d)},
            "ssm": {"w_in": z(L, d, n_in), "conv_w": z(L, cd, cfg.ssm_conv),
                    "conv_b": z(L, cd), "A_log": z(L, nh), "D": z(L, nh),
                    "dt_bias": z(L, nh), "norm_w": z(L, di),
                    "w_out": z(L, di, d)},
            "ffn": {"w1": z(L, d, f), "w2": z(L, f, d), "w3": z(L, d, f)},
        },
    }
    if head:
        tree["lm_head"] = rng.standard_normal((d, cfg.padded_vocab))
    return tree
