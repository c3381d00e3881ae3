"""The port's Mamba2 path vs the JAX reference on reduced mamba2-780m (2
layers, d_model 128, 8 heads of 32 channels, state 16), on the CPU, with
the reference's weights carried over by ``params_from_jax``.

Tolerances (f32): the SSD scan core 2e-4 (the reference's own tolerance
for its kernel against the sequential oracle: chunked and sequential sums
differ in order over up to 128 steps); the SSM block outputs and states
2e-4 for the same reason; decode-step states 2e-5 (one step of the same
products); logits 1e-4 (two layers of f32 matmuls of width 128-6448 over
vocab 512).  Integer fields and greedy token streams match exactly.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.sharding import HelixConfig as JaxHelixConfig
from repro.kernels.ssd_prefill import ssd_prefill as jax_ssd_prefill
from repro.kernels.ssd_prefill import ssd_prefill_ref as jax_ssd_prefill_ref
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models import ssm as jax_ssm
from repro.models.model_zoo import build_serve_step as jax_build_serve_step
from repro.models.model_zoo import make_prefill_step as jax_make_prefill_step
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.utils import make_mesh

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels.ssd_prefill import (ssd_prefill, ssd_prefill_plain,
                                             ssd_prefill_ref)
from repro_torch.kernels.ssd_prefill.ops import chunk_cumsum
from repro_torch.launch.serve import serve_demo
from repro_torch.models import ssm
from repro_torch.models.model_zoo import build_serve_step, make_prefill_step
from repro_torch.models.transformer import forward

SCAN_TOL = 2e-4         # SSD scan core / SSM block, f32
STEP_TOL = 2e-5         # one decode step's state, f32
LOGIT_TOL = 1e-4        # logits after two layers, f32


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2-780m on both sides with identical weights."""
    jcfg = jax_get_config("mamba2-780m").reduced()
    cfg = get_config("mamba2-780m").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, model


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ["mamba2-780m", "granite-3-2b"])
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_fields_match_reference(arch, reduced):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    if reduced:
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for prop in ("hsz", "q_dim", "kv_dim", "padded_vocab", "has_attention",
                 "has_ssm", "d_inner", "ssm_heads", "conv_dim"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    if cfg.has_ssm:
        assert ssm.d_in_proj(cfg) == jax_ssm.d_in_proj(jcfg)
    if arch == "mamba2-780m" and not reduced:
        assert (cfg.d_inner, cfg.ssm_heads, cfg.conv_dim,
                ssm.d_in_proj(cfg)) == (3072, 48, 3328, 6448)


def test_init_ssm_deterministic_leaves_match_reference():
    """conv_b, D and norm_w bit for bit; A_log and dt_bias (f32 logs of a
    linspace) within 2 f32 ulps: the port rounds the f64 value once, the
    reference evaluates XLA's own f32 log/expm1 approximations.  At the
    full width's 48 heads (narrow projections: the deterministic leaves
    depend on the head count only) and reduced."""
    narrow = dict(d_model=96, ssm_headdim=4)      # d_inner 192, 48 heads
    for cfg, jcfg in ((dataclasses.replace(get_config("mamba2-780m"),
                                           **narrow),
                       dataclasses.replace(jax_get_config("mamba2-780m"),
                                           **narrow)),
                      (get_config("mamba2-780m").reduced(),
                       jax_get_config("mamba2-780m").reduced())):
        assert cfg.ssm_heads == jcfg.ssm_heads
        want = jax_ssm.init_ssm(jcfg, jax.random.PRNGKey(0), jnp.float32)
        p = ssm.SSMParams(cfg)
        ssm.init_ssm(p, cfg, torch.Generator().manual_seed(0))
        for leaf in ("conv_b", "D", "norm_w"):
            np.testing.assert_array_equal(getattr(p, leaf).numpy(),
                                          np.asarray(getattr(want, leaf)))
        for leaf in ("A_log", "dt_bias"):
            got = getattr(p, leaf).numpy()
            ref = np.asarray(getattr(want, leaf))
            assert got.dtype == ref.dtype == np.float32
            ulps = np.abs(got.view(np.int32) - ref.view(np.int32))
            assert ulps.max() <= 2, (leaf, ulps.max())


# ---------------------------------------------------------- scan core
def _scan_inputs(seed, b=2, t=96, nh=4, hd=16, ds=16, groups=None):
    """The reference tests' input recipe, from a numpy seed; ``groups``
    draws B/C per group (``[B, T, G, ds]``)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    g = groups or nh
    dt = np.array(jax.nn.softplus(jnp.asarray(f(b, t, nh)) - 1.0))
    return dict(x=f(b, t, nh, hd), dt=dt,
                a=-np.exp(f(nh) * 0.3).astype(np.float32),
                bmat=f(b, t, g, ds) * 0.5, cmat=f(b, t, g, ds) * 0.5,
                d=np.ones(nh, np.float32), h0=f(b, nh, hd, ds) * 0.2)


def _expand(v, nh):
    return np.repeat(v, nh // v.shape[2], axis=2)


SCAN_CASES = ["multiple", "ragged", "h0", "split", "groups2", "one-token",
              "past-chunk"]


@pytest.mark.parametrize("case", SCAN_CASES)
def test_ssd_prefill_plain_matches_reference(case):
    """The port's plain scan (its cumsum in the kernel's order) vs the
    reference's sequential oracle and its interpreted Pallas kernel: T a
    multiple of lc, a ragged T <= 64 (padded with dt = 0), an initial
    state, two halves chained through h_final == one pass, two groups of
    B/C read directly vs the repeated form, T = 1, and T = 65 (one token
    past a chunk of 64, from a state)."""
    t = {"ragged": 37, "one-token": 1, "past-chunk": 65}.get(case, 96)
    inp = _scan_inputs(SCAN_CASES.index(case), t=t,
                       groups=2 if case == "groups2" else None)
    h0 = inp.pop("h0")
    h0 = h0 if case in ("h0", "split", "past-chunk") else None
    lc = 64 if case in ("ragged", "one-token", "past-chunk") else 32
    nh = inp["x"].shape[2]
    jin = dict(inp, bmat=_expand(inp["bmat"], nh), cmat=_expand(inp["cmat"],
                                                               nh))
    jin = {k: jnp.asarray(v) for k, v in jin.items()}
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = jax_ssd_prefill_ref(*jin.values(), h0=jh0)
    kern = jax_ssd_prefill(*jin.values(), h0=jh0, lc=lc, interpret=True)
    tin = {k: torch.from_numpy(v) for k, v in inp.items()}
    th0 = None if h0 is None else torch.from_numpy(h0)
    if case == "split":
        t1 = 48
        first = {k: v[:, :t1] if v.ndim > 1 else v for k, v in tin.items()}
        rest = {k: v[:, t1:] if v.ndim > 1 else v for k, v in tin.items()}
        y1, h1 = ssd_prefill_plain(*first.values(), h0=th0, lc=lc)
        y2, h = ssd_prefill_plain(*rest.values(), h0=h1, lc=lc)
        y = torch.cat([y1, y2], dim=1)
        y_full, h_full = ssd_prefill_plain(*tin.values(), h0=th0, lc=lc)
        _close(y, y_full, SCAN_TOL)
        _close(h, h_full, SCAN_TOL)
    else:
        y, h = ssd_prefill_plain(*tin.values(), h0=th0, lc=lc)
    for ref in (want, kern):
        _close(y, ref[0], SCAN_TOL)
        _close(h, ref[1], SCAN_TOL)
    # the CPU route of the kernel wrapper is the plain version itself, and
    # the port's oracle is the reference's
    yw, hw = ssd_prefill(*tin.values(), h0=th0, lc=lc)
    assert torch.equal(yw, y if case != "split" else y_full)
    tfull = dict(tin, bmat=torch.from_numpy(np.array(jin["bmat"])),
                 cmat=torch.from_numpy(np.array(jin["cmat"])))
    yo, ho = ssd_prefill_ref(*tfull.values(), h0=th0)
    _close(yo, want[0], SCAN_TOL)
    _close(ho, want[1], SCAN_TOL)


@pytest.mark.parametrize("n", [1, 2, 37, 64, 100])
def test_chunk_cumsum_is_the_inclusive_sum(n):
    """The plain version's cumsum in the kernel's order (pairs, a scan of
    the pair sums, then each pair's two prefixes): in f64 equal to the
    sequential cumsum up to rounding, zero-padded to 64 (or the next power
    of two past it) with the padded tail at the total; in f32 within a few
    ulps of the sequential f32 sum."""
    rng = np.random.default_rng(n)
    v = torch.from_numpy(rng.standard_normal((3, n)) - 1.0)
    got = chunk_cumsum(v)
    assert got.shape[-1] == max(64, 1 << (n - 1).bit_length())
    torch.testing.assert_close(got[..., :n], v.cumsum(-1), rtol=0,
                               atol=1e-12)
    torch.testing.assert_close(got[..., n:], v.sum(-1, keepdim=True).expand(
        -1, got.shape[-1] - n), rtol=0, atol=1e-12)
    v32 = v.float()
    torch.testing.assert_close(chunk_cumsum(v32)[..., :n], v32.cumsum(-1),
                               rtol=0, atol=8 * 2.0 ** -23 * n)


# ------------------------------------------------------------ SSM block
def _layer0(jparams, model):
    jp = jax_ssm.SSMParams(**{k: v[0] for k, v in
                              jparams["layers"]["ssm"].items()})
    return jp, model.layers[0].ssm


def _state(cfg, b, seed):
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((b, cfg.conv_dim, cfg.ssm_conv - 1))
    st = rng.standard_normal((b, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state)) * 0.2
    return conv.astype(np.float32), st.astype(np.float32)


@pytest.mark.parametrize("jax_backend", ["ref", "pallas-interpret"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_ssd_chunked_matches_reference(mamba, backend, jax_backend):
    """``ssd_chunked`` from a carried state, y and both state leaves, the
    port's backends (``cuda`` takes the plain version on the CPU) against
    the reference's inline block form and its interpreted kernel."""
    jcfg, cfg, jparams, model = mamba
    jp, p = _layer0(jparams, model)
    x = np.random.default_rng(3).standard_normal((2, 128, cfg.d_model))
    x = x.astype(np.float32)
    conv, st = _state(cfg, 2, 4)
    jy, jst = jax_ssm.ssd_chunked(jp, jcfg, jnp.asarray(x),
                                  jax_ssm.SSMState(jnp.asarray(conv),
                                                   jnp.asarray(st)),
                                  backend=jax_backend)
    y, new = ssm.ssd_chunked(p, cfg, torch.from_numpy(x),
                             ssm.SSMState(torch.from_numpy(conv),
                                          torch.from_numpy(st)),
                             backend=backend)
    _close(y, jy, SCAN_TOL)
    _close(new.conv, jst.conv, SCAN_TOL)
    _close(new.ssm, jst.ssm, SCAN_TOL)


def test_prompt_length_contract_raises_in_both(mamba):
    """T = 100 is neither <= 64 nor a multiple of 64: both packages refuse
    it (the reference asserts ``t % lc == 0``); T = 24 and 128 pass."""
    jcfg, cfg, jparams, model = mamba
    jp, p = _layer0(jparams, model)
    for t in (24, 128):
        ssm.ssd_chunked(p, cfg, torch.zeros(1, t, cfg.d_model))
    x = np.zeros((1, 100, cfg.d_model), np.float32)
    with pytest.raises(AssertionError):
        jax_ssm.ssd_chunked(jp, jcfg, jnp.asarray(x))
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_chunked(p, cfg, torch.from_numpy(x))


def test_ssm_decode_steps_match_reference(mamba):
    """Four single-token steps from a random state: outputs and both state
    leaves after every step."""
    jcfg, cfg, jparams, model = mamba
    jp, p = _layer0(jparams, model)
    conv, st = _state(cfg, 3, 5)
    jstate = jax_ssm.SSMState(jnp.asarray(conv), jnp.asarray(st))
    state = ssm.SSMState(torch.from_numpy(conv), torch.from_numpy(st))
    rng = np.random.default_rng(6)
    for _ in range(4):
        x = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        jy, jstate = jax_ssm.ssm_decode_step(jp, jcfg, jnp.asarray(x), jstate)
        y, state = ssm.ssm_decode_step(p, cfg, torch.from_numpy(x), state)
        _close(y, jy, STEP_TOL)
        _close(state.conv, jstate.conv, STEP_TOL)
        _close(state.ssm, jstate.ssm, STEP_TOL)


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_forward_logits_and_ssm_leaves_match_reference(mamba, backend):
    jcfg, cfg, jparams, model = mamba
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 128))
    jlogits, jex = jax_forward(jcfg, jparams, jnp.asarray(toks, jnp.int32),
                               return_cache=True)
    logits, ex = forward(cfg, model, torch.from_numpy(toks),
                         return_cache=True, ssd_backend=backend)
    _close(logits, jlogits, LOGIT_TOL)
    assert set(ex) == {"ssm_conv", "ssm_state"}
    for key in ("ssm_conv", "ssm_state"):
        assert ex[key].dtype == torch.float32
        _close(ex[key], jex[key], SCAN_TOL)


def test_prefill_and_decode_match_reference_serve_path(mamba):
    """Prefill plus decode-step logits through the steps the reference's
    ``serve_demo`` builds (``mesh=None``: a 1x1 mesh, ``kvp_axes=("data",)``),
    per-row lengths as the engine keeps them."""
    jcfg, cfg, jparams, model = mamba
    mesh = make_mesh((1, 1), ("data", "model"))
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None)
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, 40))
    jlogits, jstate = jax.jit(jax_make_prefill_step(jcfg, mesh, jhx))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    jstep = jax.jit(jax_build_serve_step(jcfg, mesh, jhx, return_logits=True))
    jstate = dict(jstate, total_len=jnp.full((2,), 40, jnp.int32))
    cur = jnp.argmax(jlogits[:, :cfg.vocab], -1).astype(jnp.int32)
    jlog = []
    for _ in range(3):
        (cur, lg), jstate = jstep(jparams, jstate, cur)
        jlog.append(np.asarray(lg))

    hx = HelixConfig()
    logits, state = make_prefill_step(cfg, hx)(
        model, {"tokens": torch.from_numpy(toks)})
    _close(logits, jlogits, LOGIT_TOL)
    state["total_len"] = torch.full((2,), 40, dtype=torch.int32)
    cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    step = build_serve_step(cfg, hx, return_logits=True)
    for i in range(3):
        (cur, lg), state = step(model, state, cur)
        _close(lg, jlog[i], LOGIT_TOL)
    for key in ("ssm_conv", "ssm_state"):
        _close(state[key], jstate[key], SCAN_TOL)


# --------------------------------------------------------------- engine
@pytest.mark.parametrize("option", ["none", "kv8", "grouped", "chunked",
                                    "paged", "prefix"])
def test_serve_demo_options_mirror_reference(mamba, option):
    """``serve_demo`` with each engine option the reference takes for an
    SSM arch: no option, the int8 KV cache and grouped decode without the
    pool change nothing; chunked prefill logs the reference's line and
    falls back to one-shot; the paged pool and prefix sharing raise in
    both (the reference: KeyError 'block_tables' at the first retirement,
    ValueError for prefix sharing without chunked prefill).  Streams are
    equal to the reference's (seeded mamba2 collapses onto few tokens, so
    the logits tests above are the sharper check)."""
    _, _, _, model = mamba
    kw = dict(reduced=True, n_requests=3, prompt_len=24, max_new=4,
              max_batch=2)
    opts = {"none": {}, "kv8": {}, "grouped": dict(grouped_decode=True),
            "chunked": dict(chunk_tokens=8), "paged": dict(paged_kv=True),
            "prefix": dict(chunk_tokens=8, paged_kv=True, prefix_share=True)}
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None,
                         kv_cache_bits=8 if option == "kv8" else 16)
    hx = HelixConfig(kv_cache_bits=8 if option == "kv8" else 16)
    jlog, log = [], []
    if option in ("paged", "prefix"):
        refused = ((KeyError, "block_tables") if option == "paged"
                   else (ValueError, "prefix_share"))
        with pytest.raises(refused[0], match=refused[1]):
            jax_serve_demo("mamba2-780m", **kw, hx=jhx, **opts[option],
                           log=jlog.append)
        with pytest.raises(ValueError):
            serve_demo("mamba2-780m", **kw, hx=hx, **opts[option],
                       device="cpu", model=model, log=log.append)
        return
    jfin, _ = jax_serve_demo("mamba2-780m", **kw, hx=jhx, **opts[option],
                             log=jlog.append)
    fin, summary = serve_demo("mamba2-780m", **kw, hx=hx, **opts[option],
                              device="cpu", model=model, log=log.append)
    assert ({r.rid: r.out_tokens for r in fin}
            == {r.rid: r.out_tokens for r in jfin})
    assert summary["n_tokens"] == 12 and summary["kv_cache_dtype"] is None
    fallback = [m for m in jlog if "falling back" in m]
    assert fallback == [m for m in log if "falling back" in m]
    assert bool(fallback) == (option == "chunked")
