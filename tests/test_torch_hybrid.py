"""The port's hybrid path (hymba-1.5b: attention and Mamba2 heads side by
side in every layer, untied head) vs the JAX reference on the CPU, with the
reference's weights carried over by ``params_from_jax``.

Two configs: ``hymba-1.5b.reduced()`` (2 layers, d_model 128, 4 q / 2 kv
heads of 32: G = 2) and a G = 5 variant of it (5 q / 1 kv head), made the
same way on both sides, since the reduced rule would hide hymba's 5:1
group.  Tolerances (f32): logits 1e-4 (two layers of f32 matmuls of width
128-1024 over vocab 512); K/V caches 2e-5 (projections and RoPE, the same
products in another order); SSM leaves 2e-4 (the reference's own tolerance
for its chunked scan against the sequential oracle); the plain
flash_prefill at G = 5 2e-5 against the reference's oracle and its
interpreted Pallas kernel.  Tokens are exact.  On the int8 path the
decode logits are held at 1e-3: the fp K/V rows of the two packages differ
in their last bits, so a row that lies on a rounding boundary of the int8
quantizer can take the neighbouring payload on one side (one such payload
of the prefill's K and one of a step's appended V in the G = 5 variant,
moving its logits by up to 2.5e-4); the payloads are held to one unit at
no more than 2 slots, the scales at 2e-5.
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
from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill
from repro.kernels.flash_prefill import (
    flash_prefill_ref as jax_flash_prefill_ref)
from repro.launch import serve as jax_serve
from repro.models.attention import head_layout as jax_head_layout
from repro.models.decode_model import quantize_lm_head as jax_quantize_head
from repro.models.model_zoo import build_serve_step as jax_build_serve_step
from repro.models.model_zoo import make_prefill_step as jax_make_prefill_step
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serving.workload import TenantSpec, generate_trace
from repro.utils import make_mesh

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvcache import quantize_decode_state
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_ref
from repro_torch.launch import serve as serve_mod
from repro_torch.models import ssm
from repro_torch.models.decode_model import (prepare_decode_params,
                                             quantize_lm_head)
from repro_torch.models.model_zoo import (build_serve_step,
                                          chunked_prefill_supported,
                                          make_prefill_step)
from repro_torch.models.transformer import Transformer, forward

LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
KV_TOL = 2e-5
SSM_TOL = 2e-4
HYMBA = "hymba-1.5b"
CONFIGS = ["reduced", "g5"]
KV8_W8 = dict(kv_cache_bits=8, lm_head_w8=True)
QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(which):
    """(reference config, port config): reduced hymba, or its G = 5
    variant (5 q heads on 1 kv head)."""
    jcfg, cfg = jax_get_config(HYMBA).reduced(), get_config(HYMBA).reduced()
    if which == "g5":
        jcfg = dataclasses.replace(jcfg, n_heads=5, n_kv_heads=1)
        cfg = dataclasses.replace(cfg, n_heads=5, n_kv_heads=1)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _hymba(which):
    """Both sides with identical weights: (jcfg, cfg, jparams, model)."""
    jcfg, cfg = _cfgs(which)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, model


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["full"] + CONFIGS)
def test_config_and_parameter_shapes_match_reference(which):
    """Every port field and derived width equals the reference's; the
    port's parameters have the reference pytree's shapes (per layer), the
    untied ``lm_head`` included; at full width the published widths and
    the one-card head layout, which needs no padding (25/5 stays 25/5)."""
    if which == "full":
        jcfg, cfg = jax_get_config(HYMBA), get_config(HYMBA)
    else:
        jcfg, cfg = _cfgs(which)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for prop in ("hsz", "q_dim", "kv_dim", "padded_vocab", "has_attention",
                 "has_ssm", "d_inner", "ssm_heads", "conv_dim"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert cfg.has_attention and cfg.has_ssm and not cfg.tie_embeddings
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
        assert (cfg.d_inner, cfg.ssm_heads, cfg.conv_dim, ssm.d_in_proj(cfg),
                cfg.padded_vocab) == (3200, 50, 3232, 6482, 32256)
        assert sum(np.prod(s) for s in got.values()) == 1_641_688_320
        lay = jax_head_layout(cfg.n_heads, cfg.n_kv_heads, 1)
        assert (lay.q_pad, lay.kv_pad) == (25, 5)
        assert lay.q_src == tuple(range(25)) and lay.kv_src == tuple(range(5))


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("which", CONFIGS)
def test_forward_matches_reference(which, backend):
    """Logits through the untied head, post-RoPE K/V of every layer and
    the SSM leaves after the prompt, against the reference's ``forward``
    (the port's ``cuda`` backends take the plain versions on the CPU)."""
    jcfg, cfg, jparams, model = _hymba(which)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 128))
    jlogits, jex = jax_forward(jcfg, jparams, jnp.asarray(toks, jnp.int32),
                               return_cache=True)
    logits, ex = forward(cfg, model, torch.from_numpy(toks),
                         return_cache=True, prefill_backend=backend,
                         ssd_backend=backend)
    _close(logits, jlogits, LOGIT_TOL)
    assert set(ex) == {"kcache", "vcache", "ssm_conv", "ssm_state"}
    for key in ("kcache", "vcache"):
        assert ex[key].shape == (cfg.n_layers, 2, 128, cfg.n_kv_heads,
                                 cfg.hsz)
        _close(ex[key], jex[key], KV_TOL)
    for key in ("ssm_conv", "ssm_state"):
        assert ex[key].dtype == torch.float32
        _close(ex[key], jex[key], SSM_TOL)
    # the untied head is the one read: the tied product differs
    tied = forward(dataclasses.replace(cfg, tie_embeddings=True),
                   _tied(model), torch.from_numpy(toks))[0]
    assert (tied - logits).abs().max() > 1e-2


def _tied(model):
    """A tied copy of ``model``: the same leaves without ``lm_head``."""
    cfg = dataclasses.replace(model.cfg, tie_embeddings=True)
    tied = Transformer(cfg)
    tied.load_state_dict({k: v for k, v in model.named_parameters()
                          if k != "lm_head"})
    return tied


# -------------------------------------------------------------- decode
@functools.lru_cache(maxsize=None)
def _jax_steps(which, mode):
    """The reference's prefill (T 40, ``s_cap`` 64) and 4 decode steps
    through the steps its ``serve_demo`` builds (``mesh=None``: a 1x1
    mesh, ``kvp_axes=("data",)``); ``mode="int8"``: the handoff quantized
    by ``quantize_decode_state`` and the head pre-quantized, as its engine
    does.  Returns the prompt, the prefill logits, each step's logits and
    tokens, and the final state."""
    jcfg, cfg, jparams, _ = _hymba(which)
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


def _port_steps(which, mode, kvp=1, backend="cuda"):
    _, cfg, _, model = _hymba(which)
    toks = _jax_steps(which, mode)[0]
    hx = HelixConfig(kvp=kvp, attn_backend=backend, prefill_backend=backend,
                     ssd_backend=backend, matmul_backend=backend,
                     **(KV8_W8 if mode == "int8" else {}))
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


@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("which", CONFIGS)
def test_decode_steps_match_reference(which, mode):
    """Prefill plus 4 decode steps (attention and SSM phases on one ``h``,
    ``0.5 * (a_out + s_out)``, the untied head; int8: the int8 KV cache
    and the int8 head): logits within 1e-4 of the reference's at every
    step (int8: 1e-3, module doc), the same tokens, and the final K/V and
    SSM leaves."""
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
    for key in ("ssm_conv", "ssm_state"):
        _close(state[key], jstate[key], SSM_TOL)


@pytest.mark.parametrize("which", CONFIGS)
def test_kvp4_equals_kvp1_within_the_port(which):
    """KVP emulated at 4 ranks against 1: the same tokens, logits and SSM
    leaves within 2e-5 (four shards' partial softmaxes combined by their
    LSEs; the next layer's SSM phase reads the rounded difference)."""
    _, logs1, out1, st1 = _port_steps(which, "fp", kvp=1)
    _, logs4, out4, st4 = _port_steps(which, "fp", kvp=4)
    assert out1 == out4
    for a, b in zip(logs1, logs4):
        _close(a, b, KV_TOL)
    for key in ("ssm_conv", "ssm_state"):
        _close(st1[key], st4[key], KV_TOL)


# --------------------------------------------------------------- serve
SERVE = dict(n_requests=5, max_new=6, max_batch=2)


def _rows():
    return generate_trace(5, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 20)),), prompt_len=12,
        max_tokens=6, seed=0)


@pytest.mark.parametrize("case", ["fixed", "paged", "top-p w4"])
@pytest.mark.parametrize("which", CONFIGS)
def test_serve_demo_streams_match_reference(monkeypatch, which, case):
    """``serve_demo`` against the reference's (``mesh=None``), the same
    requests and weights: greedy on the fixed layout with ``chunk_tokens``
    given (both log the fallback to one-shot prefill), greedy from the
    paged pool, and top-p sampled windows of 4.  The G = 5 variant is fed
    to both packages' ``get_config``."""
    jcfg, cfg, _, model = _hymba(which)
    monkeypatch.setattr(jax_serve, "get_config", lambda _: jcfg)
    monkeypatch.setattr(serve_mod, "get_config", lambda _: cfg)
    kw = {"fixed": dict(chunk_tokens=8), "paged": dict(paged_kv=True),
          "top-p w4": dict(sampling="top_p", temperature=0.9, top_p=0.85,
                           decode_window=4)}[case]
    jlog, log = [], []
    jfin, jsum = jax_serve.serve_demo(HYMBA, reduced=False, prompt_len=12,
                                      trace=_rows(), **SERVE, **kw,
                                      log=jlog.append)
    fin, summ = serve_mod.serve_demo(HYMBA, reduced=False,
                                     prompt_len=(5, 20), **SERVE, **kw,
                                     device="cpu", model=model,
                                     log=log.append)
    assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin}
    assert ({r.rid: r.out_tokens for r in fin}
            == {r.rid: r.out_tokens for r in jfin})
    assert summ["n_tokens"] == 30 and summ["prefill_calls"] == 5
    fallback = [m for m in log if "falling back" in m]
    assert fallback == [m for m in jlog if "falling back" in m]
    assert bool(fallback) == (case == "fixed")
    if case == "paged":
        assert summ["paged_kv"] and jsum["paged_kv"]
    if case == "top-p w4":
        assert summ["decode_syncs"] == jsum["decode_syncs"]


def test_prefix_share_is_refused_as_in_the_reference():
    """Prefix sharing rides chunked prefill, which hybrids lack: both
    packages refuse it."""
    kw = dict(reduced=True, prompt_len=8, n_requests=2, max_new=2,
              max_batch=2, paged_kv=True, chunk_tokens=4, prefix_share=True,
              shared_prefix_len=4, **QUIET)
    with pytest.raises(ValueError, match="prefix_share"):
        jax_serve.serve_demo(HYMBA, **kw)
    with pytest.raises(ValueError, match="prefix_share"):
        serve_mod.serve_demo(HYMBA, **kw, device="cpu",
                             model=_hymba("reduced")[-1])


def test_int8_head_is_the_untied_head_bit_for_bit():
    """``quantize_lm_head`` quantizes ``lm_head`` (not ``embed.T``) exactly
    as the reference's does, and ``params_from_jax`` takes the reference's
    quantized pair as it is."""
    _, cfg, jparams, model = _hymba("reduced")
    want = jax_quantize_head(jparams)
    m = quantize_lm_head(params_from_jax(jax.tree.map(np.asarray, jparams),
                                         cfg))
    np.testing.assert_array_equal(m.lm_head_q8.numpy(),
                                  np.asarray(want["lm_head_q8"]))
    np.testing.assert_array_equal(m.lm_head_scale.numpy(),
                                  np.asarray(want["lm_head_scale"]))
    tied = quantize_lm_head(_tied(model))
    assert not torch.equal(tied.lm_head_q8, m.lm_head_q8)
    carried = params_from_jax(jax.tree.map(np.asarray, want), cfg)
    assert torch.equal(carried.lm_head_q8, m.lm_head_q8)
    assert torch.equal(carried.lm_head_scale, m.lm_head_scale)


def test_serve_cli_takes_the_hybrid(capsys):
    """``--arch hymba-1.5b`` on the CPU: one-shot prefills through the SSD
    scan beside attention, every request to its budget."""
    serve_mod.main(["--arch", HYMBA, "--reduced", "--device", "cpu",
                    "--dtype", "float32", "--requests", "3",
                    "--prompt-len", "64", "--max-new", "3", "--metrics"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out
    assert '"kv_cache_dtype": "torch.float32"' in out


# ----------------------------------------------------------- B2, G = 5
@pytest.mark.parametrize("window", [0, 24])
def test_flash_prefill_plain_at_g5_matches_reference(window):
    """The port's plain flash_prefill (the kernel wrapper's CPU route) at
    hymba's 5:1 group, per-request offsets and lengths, against the
    reference's oracle and its interpreted Pallas kernel."""
    rng = np.random.default_rng(window)
    b, t, qh, kh, hsz = 2, 40, 10, 2, 32
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    q, k, v = f(b, t, qh, hsz), f(b, t, kh, hsz), f(b, t, kh, hsz)
    offs = np.array([0, 3], np.int32)
    lens = np.array([40, 29], np.int32)
    kw = dict(causal=True, window=window)
    # the reference oracle takes one scalar q_offset: row by row
    want = np.concatenate([np.asarray(jax_flash_prefill_ref(
        *map(jnp.asarray, (q[i:i + 1], k[i:i + 1], v[i:i + 1])), **kw,
        q_offset=int(offs[i]), seq_lens=jnp.asarray(lens[i:i + 1])))
        for i in range(b)])
    kern = jax_flash_prefill(*map(jnp.asarray, (q, k, v)), **kw,
                             q_offset=jnp.asarray(offs),
                             seq_lens=jnp.asarray(lens), blk_q=16, blk_k=16,
                             interpret=True)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_prefill(tq, tk, tv, **kw, q_offset=torch.from_numpy(offs),
                        seq_lens=torch.from_numpy(lens))
    plain = flash_prefill_ref(tq, tk, tv, **kw,
                              q_offset=torch.from_numpy(offs),
                              seq_lens=torch.from_numpy(lens))
    assert torch.equal(got, plain)
    for ref in (want, kern):
        _close(got, ref, KV_TOL)
