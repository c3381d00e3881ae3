"""Decode windows and sampled serving of the port against the JAX package
on the CPU: reduced granite-3-2b and reduced mamba2-780m, f32, weights
carried over with ``params_from_jax``.

``build_serve_multistep`` is held against the reference's, built with
``HelixConfig(kvp_axes=("data",))`` on a (1, 1) mesh (what ``serve_demo``
builds with ``mesh=None``; the reference's own window tests use
``kvp_axes=()``, which fails under JAX 0.9.0), from the same decode state:
the token block, ``cur``, ``total_len`` and ``sample_idx`` exactly, caches
and SSM leaves at 2e-5 (f32 rounding over a few steps of two layers).
Inside the port, a window equals N ``serve_step`` calls bit for bit on the
whole state, and the engine's window-4 streams equal its window-1 streams
with top-p sampling on the fixed layout, the paged pool, chunked prefill
with prefix sharing, and mamba2.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.sharding import HelixConfig as JaxHelixConfig
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models.model_zoo import (
    build_serve_multistep as jax_build_serve_multistep)
from repro.models.model_zoo import make_prefill_step as jax_make_prefill_step
from repro.models.transformer import init_params as jax_init_params
from repro.serving.workload import TenantSpec, generate_trace
from repro.utils import make_mesh

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvcache import init_decode_state
from repro_torch.core.sharding import HelixConfig
from repro_torch.launch.serve import serve_demo
from repro_torch.models.model_zoo import (build_serve_multistep,
                                          build_serve_step)
from repro_torch.serving.sampling import request_seed

ATOL = RTOL = 2e-5       # caches and SSM leaves after a window, f32
WINDOW = 4
QUIET = dict(log=lambda *a: None)
TOP_P = dict(sampling="top_p", temperature=0.9, top_p=0.85)


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


GRANITE, MAMBA = "granite-3-2b", "mamba2-780m"


@functools.lru_cache(maxsize=None)
def _arch(name):
    """Reduced ``name`` on both sides with identical weights."""
    jcfg = jax_get_config(name).reduced()
    cfg = get_config(name).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return name, jcfg, cfg, jparams, model


def _prefilled(jcfg, jparams, b=2, t=12):
    """A two-row decode state prefilled by the reference (``s_cap`` 64),
    with top-p sampler leaves; numpy leaves and the first tokens."""
    mesh = make_mesh((1, 1), ("data", "model"))
    jhx = JaxHelixConfig(kvp_axes=("data",))
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (b, t))
    kw = dict(s_cap=64) if jcfg.family == "dense" else {}
    logits, st = jax.jit(jax_make_prefill_step(jcfg, mesh, jhx, **kw))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    st = {k: np.asarray(v) for k, v in st.items()}
    st["total_len"] = np.full((b,), t, np.int32)
    st["sample_temp"] = np.full((b,), 0.9, np.float32)
    st["sample_topk"] = np.zeros((b,), np.int32)
    st["sample_topp"] = np.full((b,), 0.85, np.float32)
    st["sample_seed"] = np.asarray([request_seed(7, r) for r in range(b)],
                                   np.uint32)
    st["sample_idx"] = np.ones((b,), np.int32)
    first = np.argmax(np.asarray(logits)[:, :jcfg.vocab], -1).astype(np.int32)
    return mesh, jhx, st, first


def _torch_state(st):
    out = {k: torch.from_numpy(np.array(v)) for k, v in st.items()}
    out["sample_seed"] = out["sample_seed"].to(torch.int64)
    return out


def _controls(case, b, ref_block=None):
    budgets = np.full((b,), WINDOW, np.int32)
    eos = np.full((b,), -1, np.int32)
    forced = np.zeros((b, WINDOW), np.int32)
    nforced = np.zeros((b,), np.int32)
    if case == "budget":
        budgets[1] = 2
    elif case == "frozen":
        budgets[1] = 1
    elif case == "eos":
        eos[0] = ref_block[0, 1]         # what row 0 emits at step 1
    elif case == "forced":
        forced[0, :2] = (5, 9)
        nforced[0] = 2
    return budgets, eos, forced, nforced


def _ref_window(jcfg, jparams, mesh, jhx, st, first, ctl):
    fn = jax.jit(jax_build_serve_multistep(jcfg, mesh, jhx, window=WINDOW))
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    out, cur, new = fn(jparams, jst, jnp.asarray(first),
                       *(jnp.asarray(c) for c in ctl))
    return (np.asarray(out), np.asarray(cur),
            {k: np.asarray(v) for k, v in new.items()})


@pytest.mark.parametrize("name,case", [
    (GRANITE, "full"), (GRANITE, "budget"), (GRANITE, "eos"),
    (GRANITE, "forced"), (MAMBA, "full"), (MAMBA, "frozen")])
def test_multistep_matches_reference(name, case):
    _, jcfg, cfg, jparams, model = _arch(name)
    mesh, jhx, st, first = _prefilled(jcfg, jparams)
    ref_full = None
    if case == "eos":
        ref_full = _ref_window(jcfg, jparams, mesh, jhx, st, first,
                               _controls("full", 2))[0]
    ctl = _controls(case, 2, ref_full)
    jout, jcur, jnew = _ref_window(jcfg, jparams, mesh, jhx, st, first, ctl)
    state = _torch_state(st)
    held = {k: state[k].clone() for k in ("ssm_conv", "ssm_state")
            if k in state}
    fn = build_serve_multistep(cfg, HelixConfig(), window=WINDOW)
    out, cur, new = fn(model, state, torch.from_numpy(first),
                       *(torch.from_numpy(c) for c in ctl))
    np.testing.assert_array_equal(out.numpy(), jout)
    np.testing.assert_array_equal(cur.numpy(), jcur)
    for key in ("total_len", "sample_idx"):
        np.testing.assert_array_equal(new[key].numpy(), jnew[key])
    for key in ("kcache", "vcache", "ssm_conv", "ssm_state"):
        if key in jnew:
            np.testing.assert_allclose(new[key].numpy(), jnew[key],
                                       atol=ATOL, rtol=RTOL)
    if case == "eos":
        assert out[0, 1] == ctl[1][0] and (out[0, 2:] == -1).all()
    if case == "forced":
        assert (out[0, :2] == -1).all() and new["sample_idx"][0] == 3
    if case == "frozen":
        # row 1 took one step: its state is one serve_step's, frozen after
        one = _torch_state(st)
        build_serve_step(cfg, HelixConfig())(model, one,
                                             torch.from_numpy(first))
        for key, before in held.items():
            assert torch.equal(new[key][:, 1], one[key][:, 1])
            assert not torch.equal(new[key][:, 1], before[:, 1])


@pytest.mark.parametrize("name", [GRANITE, MAMBA])
def test_multistep_equals_single_steps_bit_for_bit(name):
    """Full budgets: a window is N ``serve_step`` calls on the whole state
    (caches or SSM leaves, lengths, sampler counters, tokens)."""
    _, jcfg, cfg, jparams, model = _arch(name)
    _, _, st, first = _prefilled(jcfg, jparams)
    hx = HelixConfig()
    a, b = _torch_state(st), _torch_state(st)
    ctl = _controls("full", 2)
    out, cur, new = build_serve_multistep(cfg, hx, window=WINDOW)(
        model, a, torch.from_numpy(first), *(torch.from_numpy(c) for c in ctl))
    step = build_serve_step(cfg, hx)
    tok, toks = torch.from_numpy(first), []
    for _ in range(WINDOW):
        tok, b = step(model, b, tok)
        toks.append(tok)
    assert torch.equal(out, torch.stack(toks, 1)) and torch.equal(cur, tok)
    assert set(new) == set(b)
    for key in new:
        assert torch.equal(new[key], b[key]), key


def test_multistep_refuses_what_the_reference_refuses():
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(ValueError, match="window must be >= 1"):
        build_serve_multistep(cfg, HelixConfig(), window=0)
    with pytest.raises(ValueError, match="grouped_decode"):
        build_serve_multistep(cfg, HelixConfig(paged_kv=True,
                                               grouped_decode=True), window=2)


def test_sampling_state_leaves():
    cfg = get_config("granite-3-2b").reduced()
    st = init_decode_state(cfg, 3, 32, 1, device="cpu", sampling=True)
    want = {"sample_temp": torch.float32, "sample_topk": torch.int32,
            "sample_topp": torch.float32, "sample_seed": torch.int64,
            "sample_idx": torch.int32}
    for key, dtype in want.items():
        assert st[key].dtype == dtype and st[key].shape == (3,)
        assert not st[key].any()
    assert "sample_seed" not in init_decode_state(cfg, 3, 32, 1,
                                                  device="cpu")


# ----------------------------------------------------------------- engine
ENGINE_CASES = {
    "fixed": dict(n_requests=5, prompt_len=(5, 12), max_new=(3, 11),
                  max_batch=3),
    "paged": dict(n_requests=5, prompt_len=(5, 40), max_new=(3, 11),
                  max_batch=3, paged_kv=True, pool_blocks=6),
    "prefix": dict(n_requests=5, prompt_len=(20, 40), max_new=(3, 11),
                   max_batch=3, paged_kv=True, chunk_tokens=8,
                   prefix_share=True, shared_prefix_len=16),
    "single": dict(n_requests=2, prompt_len=7, max_new=1 + 2 * WINDOW,
                   max_batch=1),
    "mamba2": dict(n_requests=5, prompt_len=24, max_new=(3, 11),
                   max_batch=3),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_window_streams_equal_single_steps(case):
    name = MAMBA if case == "mamba2" else GRANITE
    _, jcfg, cfg, jparams, model = _arch(name)
    kw = dict(ENGINE_CASES[case], reduced=True, device="cpu", model=model,
              seed=7, **TOP_P, **QUIET)
    runs = {n: serve_demo(name, decode_window=n, **kw)
            for n in (1, WINDOW)}
    streams = {n: {r.rid: r.out_tokens for r in fin}
               for n, (fin, _) in runs.items()}
    assert streams[1] == streams[WINDOW]
    one, win = runs[1][1], runs[WINDOW][1]
    for s in (one, win):
        assert s["syncs_per_token"] == s["decode_syncs"] / s["decoded_tokens"]
    assert win["decoded_tokens"] == one["decoded_tokens"]
    assert win["decode_syncs"] < one["decode_syncs"]
    if case == "single":
        assert one["syncs_per_token"] == 1.0
        assert win["syncs_per_token"] == 1 / WINDOW
    if case == "paged":
        assert win["pool_waits"] >= 1
    if case == "prefix":
        assert win["prefix_hit_rate"] > 0


@pytest.mark.parametrize("window", [1, WINDOW])
def test_sampled_serve_demo_matches_reference(window):
    """The port's sampled ``serve_demo`` against the reference's
    (``mesh=None``), at window 1 and 4: same requests, same weights, same
    per-request PRNG streams."""
    model = _arch(GRANITE)[-1]
    rows = generate_trace(5, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 9)),), prompt_len=7,
        max_tokens=6, seed=0)
    jfin, jsum = jax_serve_demo("granite-3-2b", reduced=True, n_requests=5,
                                prompt_len=7, max_new=6, max_batch=2,
                                trace=rows, decode_window=window, **TOP_P,
                                **QUIET)
    fin, summ = serve_demo("granite-3-2b", reduced=True, n_requests=5,
                           prompt_len=(5, 9), max_new=6, max_batch=2,
                           decode_window=window, device="cpu", model=model,
                           **TOP_P, **QUIET)
    assert ({r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin})
    assert ({r.rid: r.out_tokens for r in fin}
            == {r.rid: r.out_tokens for r in jfin})
    for key in ("decode_syncs", "decoded_tokens"):
        assert summ[key] == jsum[key]
