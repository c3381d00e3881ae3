"""The port's mixture of experts (granite-moe-1b-a400m: 32 experts, top 8,
capacity routing) vs the JAX reference on the CPU, on the same
numpy-seeded inputs, with the reference's weights carried over by
``params_from_jax``.

Configs: ``granite-moe-1b-a400m.reduced()`` (2 layers, d_model 128, 4 q /
2 kv heads of 32, 8 experts, top 2, expert d_ff 64, capacity factor 8)
and the same config with a dense ``d_ff`` of 256 beside the experts (the
dense-residual branch arctic-480b uses), made the same way on both sides.
Tolerances (f32): routes, slots and token plans exact; gates and aux
losses 1e-6 (one softmax and a few sums over 8-32 experts); the MoE layer
1e-5 (three matmuls of width <= 128 summed over the k choices); logits
1e-4 and K/V 2e-5 as in the other model tests; the int8 decode logits
1e-3 with the payloads held to one unit at no more than 2 slots, the
hybrid's bounds (a row on a rounding boundary of the int8 quantizer can
take the neighbouring payload on one side).  Tokens are exact.
"""
import copy
import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.kvcache import quantize_decode_state as jax_quantize_state
from repro.core.sharding import HelixConfig as JaxHelixConfig
from repro.launch import serve as jax_serve
from repro.models import moe as jax_moe
from repro.models.decode_model import quantize_lm_head as jax_quantize_head
from repro.models.model_zoo import build_serve_step as jax_build_serve_step
from repro.models.model_zoo import make_prefill_step as jax_make_prefill_step
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serving.workload import TenantSpec, generate_trace
from repro.utils import make_mesh

from repro_torch.configs import MoEConfig, get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvcache import quantize_decode_state
from repro_torch.core.sharding import HelixConfig
from repro_torch.launch import serve as serve_mod
from repro_torch.models import moe
from repro_torch.models.decode_model import prepare_decode_params
from repro_torch.models.layers import activation
from repro_torch.models.model_zoo import (build_serve_step,
                                          chunked_prefill_supported,
                                          make_prefill_step)
from repro_torch.models.transformer import Transformer, forward, init_params

ROUTE_TOL = 1e-6
MOE_TOL = 1e-5
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
KV_TOL = 2e-5
ARCH = "granite-moe-1b-a400m"
CONFIGS = ["reduced", "dense-residual"]
KV8_W8 = dict(kv_cache_bits=8, lm_head_w8=True)
QUIET = dict(log=lambda *a: None)
SILU = activation("silu")


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(which):
    """(reference config, port config): reduced granite-moe, or the same
    with a dense d_ff of 256 beside the experts."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if which == "dense-residual":
        jcfg = dataclasses.replace(jcfg, d_ff=256)
        cfg = dataclasses.replace(cfg, d_ff=256)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _moe_model(which):
    """Both sides with identical weights: (jcfg, cfg, jparams, model)."""
    jcfg, cfg = _cfgs(which)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, model


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _moe_cfg(jcfg):
    """The port's ``MoEConfig`` with the reference's field values."""
    return MoEConfig(**dataclasses.asdict(jcfg))


def _layer(rng, m, h):
    """Random MoE weights [H, E], [E, H, Fe] x 2, [E, Fe, H] (numpy f32)
    at the reference's scales, for both sides."""
    e, fe = m.n_experts, m.d_ff
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return dict(router=f(h, e) * 0.3, w1=f(e, h, fe) * h ** -0.5,
                w3=f(e, h, fe) * h ** -0.5, w2=f(e, fe, h) * fe ** -0.5)


def _port_layer(w, m, h):
    mp = moe.MoEParams(m, h)
    for name, arr in w.items():
        getattr(mp, name).data = torch.from_numpy(arr.copy())
    return mp


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_and_parameter_shapes_match_reference(which):
    """Every port field equals the reference's, the MoE config field by
    field (the reduced rule: 8 experts, top 2, d_ff 64, capacity factor
    8); the parameters have the reference pytree's shapes, per layer; at
    full width 1,335,149,568 of them (~2.7 GB in bf16)."""
    if which == "full":
        jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = _cfgs("reduced")
    for f in dataclasses.fields(cfg):
        if f.name != "moe":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    for prop in ("hsz", "q_dim", "kv_dim", "padded_vocab", "has_attention",
                 "has_ssm"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.family == "moe" and cfg.tie_embeddings and not cfg.d_ff
    assert not chunked_prefill_supported(cfg)
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = ".".join(p.key for p in path)
        if name.startswith("layers."):
            for i in range(cfg.n_layers):
                want[f"layers.{i}.{name[7:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    with torch.device("meta"):
        model = Transformer(cfg)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    if which == "full":
        assert (cfg.moe.n_experts, cfg.moe.topk, cfg.moe.d_ff) == (32, 8, 512)
        assert sum(int(np.prod(s)) for s in got.values()) == 1_335_149_568


def test_init_params_scales_and_f32_router():
    """``init_params`` draws the expert leaves at the reference's scales
    (router 0.02, w1/w3 H^-0.5, w2 Fe^-0.5, no depth factor) and keeps
    the router f32 in a bf16 model."""
    cfg = get_config(ARCH).reduced()
    m = init_params(cfg, 3, dtype=torch.bfloat16, device="cpu")
    mp = m.layers[1].moe
    assert mp.router.dtype == torch.float32 and mp.w1.dtype == torch.bfloat16
    h, fe = cfg.d_model, cfg.moe.d_ff
    for p, std in ((mp.router, 0.02), (mp.w1, h ** -0.5), (mp.w3, h ** -0.5),
                   (mp.w2, fe ** -0.5)):
        assert abs(p.float().std().item() / std - 1) < 0.05


# --------------------------------------------------------------- route
ROUTE_CASES = ["random", "zero-columns", "zero-rows"]


@pytest.mark.parametrize("case", ROUTE_CASES)
@pytest.mark.parametrize("arch", ["full", "reduced"])
def test_route_matches_reference(arch, case):
    """The top-k experts equal, gates and aux loss within 1e-6, with
    probabilities tied exactly: half the router's columns zero (ties among
    their experts) or whole rows of x zero (every expert tied): the lower
    index comes first, as in ``jax.lax.top_k``."""
    jcfg = jax_get_config(ARCH)
    jcfg = jcfg if arch == "full" else jcfg.reduced()
    m = _moe_cfg(jcfg.moe)
    rng = np.random.default_rng(ROUTE_CASES.index(case))
    h, t = 48, 24
    x = rng.standard_normal((t, h)).astype(np.float32)
    w = rng.standard_normal((h, m.n_experts)).astype(np.float32) * 0.3
    if case == "zero-columns":
        w[:, 1::2] = 0.0
    if case == "zero-rows":
        x[::3] = 0.0
    want = jax.jit(jax_moe.route, static_argnums=2)(jnp.asarray(w),
                                                    jnp.asarray(x), jcfg.moe)
    got = moe.route(torch.from_numpy(w), torch.from_numpy(x), m)
    assert got.expert_idx.dtype == torch.int32
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    _close(got.gates, want.gates, ROUTE_TOL)
    _close(got.aux_loss, want.aux_loss, ROUTE_TOL)
    if case == "zero-rows":
        assert got.expert_idx[0].tolist() == list(range(m.topk))


# ------------------------------------------------------------ dispatch
@pytest.mark.parametrize("t,e,k,cap", [(16, 8, 2, 1), (16, 8, 2, 4),
                                       (16, 8, 2, 9), (5, 4, 3, 2),
                                       (7, 32, 8, 3), (1, 8, 2, 1)])
def test_dispatch_plan_matches_reference(t, e, k, cap):
    """Slots and token plans equal to the reference's, with drops (slot
    == capacity) and empty slots (token == T)."""
    rng = np.random.default_rng(t * 100 + cap)
    ei = np.argsort(rng.random((t, e)), axis=1)[:, :k].astype(np.int32)
    want = jax.jit(jax_moe.dispatch_plan, static_argnums=(1, 2))(
        jnp.asarray(ei), e, cap)
    got = moe.dispatch_plan(torch.from_numpy(ei), e, cap)
    for g, wnt in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert got[1].shape == (e * cap,)
    if cap == 1 and t > 1:
        assert (got[0] == cap).any()       # dropped assignments
    assert (got[1] == t).any() or t * k >= e * cap


# ------------------------------------------------------------- moe_ffn
@pytest.mark.parametrize("cf", [None, 0.5], ids=["ample", "dropping"])
@pytest.mark.parametrize("groups", [1, 2])
def test_moe_ffn_matches_reference(groups, cf):
    """The MoE layer at 1 and 2 dispatch groups, with the reduced config's
    ample capacity (factor 8) and with a dropping one (0.5): y within
    1e-5 and the aux loss within 1e-6 of the reference's; a token whose
    every choice is dropped gets exactly zero."""
    jm = dataclasses.replace(jax_get_config(ARCH).moe, n_experts=4, topk=2,
                             d_ff=16, capacity_factor=8.0)
    m, h, t = _moe_cfg(jm), 32, 24
    rng = np.random.default_rng(groups)
    w = _layer(rng, m, h)
    x = rng.standard_normal((t, h)).astype(np.float32)
    wy, waux = jax.jit(lambda p, xs: jax_moe.moe_ffn(
        jax_moe.MoEParams(**p), xs, jm, jax.nn.silu, capacity_factor=cf,
        groups=groups))(w, jnp.asarray(x))
    y, aux = moe.moe_ffn(_port_layer(w, m, h), torch.from_numpy(x), m, SILU,
                         capacity_factor=cf, groups=groups)
    _close(y, wy, MOE_TOL)
    _close(aux, waux, ROUTE_TOL)
    r = moe.route(torch.from_numpy(w["router"]), torch.from_numpy(x), m)
    cap = moe.capacity(t // groups, m, cf or m.capacity_factor)
    slot, _ = moe._dispatch_plans(r.expert_idx.reshape(groups, -1, m.topk),
                                  m.n_experts, cap)
    gone = (slot >= cap).all(-1).reshape(-1)
    assert bool(gone.any()) == (cf == 0.5)
    assert torch.equal(y[gone], torch.zeros_like(y[gone]))
    assert bool((slot >= cap).any()) == (cf == 0.5)


@pytest.mark.parametrize("arch", ["full", "reduced"])
def test_decode_capacity_drops_nothing(arch):
    """At the decode capacity factor (4) every B in 1..16 keeps every
    assignment (``cap >= B``), so each row's output equals its output
    alone: window 4 == window 1 and paged == fixed can hold for the MoE."""
    cfg = get_config(ARCH)
    m = (cfg if arch == "full" else cfg.reduced()).moe
    h = 64
    rng = np.random.default_rng(5)
    mp = _port_layer(_layer(rng, m, h), m, h)
    cf = m.decode_capacity_factor
    x = torch.from_numpy(rng.standard_normal((16, h)).astype(np.float32))
    alone = torch.cat([moe.moe_ffn(mp, x[i:i + 1], m, SILU,
                                   capacity_factor=cf)[0] for i in range(16)])
    for b in range(1, 17):
        cap = moe.capacity(b, m, cf)
        assert cap >= b
        r = moe.route(mp.router, x[:b], m)
        slot, _ = moe.dispatch_plan(r.expert_idx, m.n_experts, cap)
        assert bool((slot < cap).all()), b
        y = moe.moe_ffn(mp, x[:b], m, SILU, capacity_factor=cf)[0]
        _close(y, alone[:b], ROUTE_TOL)


# ------------------------------------------------------------- forward
@functools.lru_cache(maxsize=None)
def _jax_forward(which):
    """The reference's logits and extras over two rows of 96 tokens."""
    jcfg, cfg, jparams, _ = _moe_model(which)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 96))
    jlogits, jex = jax.jit(lambda p, tk: jax_forward(
        jcfg, p, tk, return_cache=True))(jparams, jnp.asarray(toks,
                                                              jnp.int32))
    return toks, jlogits, jex


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("which", CONFIGS)
def test_forward_matches_reference(which, backend):
    """Logits, post-RoPE K/V of every layer and the summed aux loss against
    the reference's ``forward`` (two rows of 96 tokens routed as one
    group at capacity factor 8; the port's ``cuda`` backend takes the plain
    flash_prefill on the CPU)."""
    _, cfg, _, model = _moe_model(which)
    toks, jlogits, jex = _jax_forward(which)
    logits, ex = forward(cfg, model, torch.from_numpy(toks),
                         return_cache=True, prefill_backend=backend)
    _close(logits, jlogits, LOGIT_TOL)
    assert set(ex) == {"kcache", "vcache", "aux_loss"}
    for key in ("kcache", "vcache"):
        _close(ex[key], jex[key], KV_TOL)
    _close(ex["aux_loss"], jex["aux_loss"], ROUTE_TOL)
    if which == "dense-residual":      # the dense FFN is read as well
        bare = copy.deepcopy(model)
        for lp in bare.layers:
            lp.ffn.w2.data.zero_()
        assert (forward(cfg, bare, torch.from_numpy(toks))[0]
                - logits).abs().max() > 1e-3


# -------------------------------------------------------------- decode
@functools.lru_cache(maxsize=None)
def _jax_steps(which, mode):
    """The reference's prefill (T 40, ``s_cap`` 64) and 4 decode steps
    through the steps its ``serve_demo`` builds (``mesh=None``: a 1x1
    mesh, ``kvp_axes=("data",)``); ``mode="int8"``: the handoff quantized
    and the head pre-quantized, as its engine does."""
    jcfg, cfg, jparams, _ = _moe_model(which)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 40))
    mesh = make_mesh((1, 1), ("data", "model"))
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None,
                         **(KV8_W8 if mode == "int8" else {}))
    jlogits, jstate = jax.jit(jax_make_prefill_step(jcfg, mesh, jhx,
                                                    s_cap=64))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    jp = jparams
    if mode == "int8":
        jstate, jp = jax_quantize_state(jstate), jax_quantize_head(jparams)
    jstate = dict(jstate, total_len=jnp.full((2,), 40, jnp.int32))
    jstep = jax.jit(jax_build_serve_step(jcfg, mesh, jhx, return_logits=True))
    cur = jnp.argmax(jlogits[:, :cfg.vocab], -1).astype(jnp.int32)
    logs, out = [], []
    for _ in range(4):
        (cur, lg), jstate = jstep(jp, jstate, cur)
        logs.append(np.asarray(lg))
        out.append(np.asarray(cur).tolist())
    return toks, np.asarray(jlogits), logs, out, jax.tree.map(np.asarray,
                                                              jstate)


def _port_steps(which, mode, kvp=1):
    _, cfg, _, model = _moe_model(which)
    toks = _jax_steps(which, mode)[0]
    hx = HelixConfig(kvp=kvp, **(KV8_W8 if mode == "int8" else {}))
    m = prepare_decode_params(copy.deepcopy(model), hx)
    logits, state = make_prefill_step(cfg, hx, s_cap=64)(
        m, {"tokens": torch.from_numpy(toks)})
    if mode == "int8":
        state = quantize_decode_state(state)
    state["total_len"] = torch.full((2,), 40, dtype=torch.int32)
    step = build_serve_step(cfg, hx, return_logits=True)
    cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    logs, out = [], []
    for _ in range(4):
        (cur, lg), state = step(m, state, cur)
        logs.append(lg)
        out.append(cur.tolist())
    return logits, logs, out, state


@pytest.mark.parametrize("which,mode", [("reduced", "fp"),
                                        ("reduced", "int8"),
                                        ("dense-residual", "fp")])
def test_decode_steps_match_reference(which, mode):
    """Prefill plus 4 decode steps (the MoE over both rows at the decode
    capacity factor; int8: the int8 KV cache and the int8 head): logits
    within 1e-4 of the reference's at every step (int8: 1e-3, module doc),
    the same tokens, and the final caches."""
    _, jlogits, jlogs, jout, jstate = _jax_steps(which, mode)
    logits, logs, out, state = _port_steps(which, mode)
    _close(logits, jlogits, LOGIT_TOL)
    for got, want in zip(logs, jlogs):
        _close(got, want, INT8_LOGIT_TOL if mode == "int8" else LOGIT_TOL)
    assert out == jout
    if mode == "int8":
        assert state["kcache"].dtype == torch.int8
        for key in ("kcache", "vcache"):
            diff = np.abs(state[key].numpy().astype(np.int32)
                          - jstate[key].astype(np.int32))
            assert diff.max() <= 1 and np.count_nonzero(diff) <= 2, key
        for key in ("kscale", "vscale"):
            _close(state[key], jstate[key], KV_TOL)
    else:
        for key in ("kcache", "vcache"):
            _close(state[key], jstate[key], KV_TOL)


def test_kvp4_equals_kvp1_within_the_port():
    """KVP emulated at 4 ranks against 1: the same tokens, logits within
    2e-5 (four shards' partial softmaxes combined by their LSEs)."""
    _, logs1, out1, _ = _port_steps("reduced", "fp", kvp=1)
    _, logs4, out4, _ = _port_steps("reduced", "fp", kvp=4)
    assert out1 == out4
    for a, b in zip(logs1, logs4):
        _close(a, b, KV_TOL)


# --------------------------------------------------------------- serve
SERVE = dict(n_requests=5, max_new=6, max_batch=2)


def _rows():
    return generate_trace(5, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 20)),), prompt_len=12,
        max_tokens=6, seed=0)


@pytest.mark.parametrize("case", ["fixed", "paged top-p w4"])
def test_serve_demo_streams_match_reference(case):
    """``serve_demo`` against the reference's (``mesh=None``), the same
    requests and weights: greedy steps on the fixed layout with
    ``chunk_tokens`` given (both log the fallback to one-shot prefill), and
    top-p sampled windows of 4 from the paged pool."""
    model = _moe_model("reduced")[-1]
    kw = {"fixed": dict(chunk_tokens=8),
          "paged top-p w4": dict(paged_kv=True, sampling="top_p",
                                 temperature=0.9, top_p=0.85,
                                 decode_window=4)}[case]
    jlog, log = [], []
    jfin, jsum = jax_serve.serve_demo(ARCH, reduced=True, prompt_len=12,
                                      trace=_rows(), **SERVE, **kw,
                                      log=jlog.append)
    fin, summ = serve_mod.serve_demo(ARCH, reduced=True, prompt_len=(5, 20),
                                     **SERVE, **kw, device="cpu",
                                     model=model, log=log.append)
    assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin}
    assert ({r.rid: r.out_tokens for r in fin}
            == {r.rid: r.out_tokens for r in jfin})
    assert summ["n_tokens"] == 30 and summ["prefill_calls"] == 5
    fallback = [m for m in log if "falling back" in m]
    assert fallback == [m for m in jlog if "falling back" in m]
    assert bool(fallback) == (case == "fixed")
    if case == "paged top-p w4":
        assert summ["paged_kv"] and jsum["paged_kv"]
        assert summ["decode_syncs"] == jsum["decode_syncs"]


def test_prefix_share_is_refused_as_in_the_reference():
    """Prefix sharing rides chunked prefill, which capacity routing rules
    out: both packages refuse it."""
    kw = dict(reduced=True, prompt_len=8, n_requests=2, max_new=2,
              max_batch=2, paged_kv=True, chunk_tokens=4, prefix_share=True,
              shared_prefix_len=4, **QUIET)
    with pytest.raises(ValueError, match="prefix_share"):
        jax_serve.serve_demo(ARCH, **kw)
    with pytest.raises(ValueError, match="prefix_share"):
        serve_mod.serve_demo(ARCH, **kw, device="cpu",
                             model=_moe_model("reduced")[-1])


def test_params_from_jax_keeps_the_router_f32():
    """Under ``dtype=torch.bfloat16`` the carried router stays f32 and
    equal to the reference's leaf; the expert weights become bf16."""
    _, cfg, jparams, _ = _moe_model("reduced")
    tree = jax.tree.map(np.asarray, jparams)
    m = params_from_jax(tree, cfg, dtype=torch.bfloat16)
    for i, lp in enumerate(m.layers):
        assert lp.moe.router.dtype == torch.float32
        np.testing.assert_array_equal(lp.moe.router.numpy(),
                                      tree["layers"]["moe"]["router"][i])
        assert lp.moe.w1.dtype == lp.moe.w2.dtype == torch.bfloat16
    assert m.embed.dtype == torch.bfloat16


def test_serve_cli_takes_the_moe(capsys):
    """``--arch granite-moe-1b-a400m`` on the CPU: one-shot prefills after
    the chunked fallback, every request to its budget."""
    serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--dtype", "float32", "--requests", "3",
                    "--prompt-len", "24", "--max-new", "3",
                    "--chunk-tokens", "8", "--metrics"])
    out = capsys.readouterr().out
    assert "falling back to one-shot prefill" in out
    assert "[serve] 3 requests, 9 tokens" in out
    assert '"kv_cache_dtype": "torch.float32"' in out
