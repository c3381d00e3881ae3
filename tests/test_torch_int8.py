"""The port's int8 decode path vs the JAX reference on the CPU: the int8 KV
cache (``HelixConfig(kv_cache_bits=8)``) and the int8 lm_head
(``lm_head_w8=True``), on reduced granite-3-2b (2 layers, d_model 128) with
the reference's weights carried over by ``params_from_jax``.

Tolerances (f32): quantizer payloads and scales, and the appended cache rows,
are equal bit for bit (same formula, IEEE division, round half to even);
the w8a16 product 1e-5 (rtol and atol; the same f32 sum in another order);
int8 decode attention 2e-5 (as the fp attention tests); logits 1e-4 (as
``test_torch_model.py``).  Greedy token streams must be identical.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.helix import append_kv_quant as jax_append_kv_quant
from repro.core.helix import quantize_kv_token as jax_quantize_kv_token
from repro.core.kvcache import quantize_decode_state as jax_quantize_state
from repro.core.sharding import HelixConfig as JaxHelixConfig
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode import flash_decode_ref as jax_decode_ref
from repro.kernels.w8a16_matmul import quantize_w8 as jax_quantize_w8
from repro.kernels.w8a16_matmul import w8a16_matmul as jax_w8a16_matmul
from repro.kernels.w8a16_matmul import w8a16_matmul_ref as jax_w8a16_ref
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models.decode_model import quantize_lm_head as jax_quantize_head
from repro.models.model_zoo import build_serve_step as jax_build_serve_step
from repro.models.model_zoo import make_prefill_step as jax_make_prefill_step
from repro.models.transformer import init_params as jax_init_params
from repro.serving.workload import TenantSpec, generate_trace
from repro.utils import make_mesh

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.helix import (append_kv_quant, helix_attention,
                                    quantize_kv_token)
from repro_torch.core.kvcache import init_decode_state, quantize_decode_state
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels import registry
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_shards
from repro_torch.kernels.w8a16_matmul import (quantize_w8, w8a16_matmul,
                                              w8a16_matmul_ref)
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_demo
from repro_torch.models.decode_model import prepare_decode_params
from repro_torch.models.model_zoo import build_serve_step, make_prefill_step
from repro_torch.serving import DecodeEngine

MM_TOL = 1e-5           # w8a16 product, f32
ATOL = RTOL = 2e-5      # attention outputs, f32
LOGIT_TOL = 1e-4        # logits after two layers, f32
RR = 16
# a hand-built tie row: amax 127 gives scale exactly 1.0, so x / scale lands
# on .5 ties that round half to even (0.5 -> 0, 1.5 -> 2, 2.5 -> 2, ...)
TIES = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 0.0, -127.0, 126.5,
        -126.5, 4.5, 5.5, 6.5, -7.5]
KV8_W8 = dict(kv_cache_bits=8, lm_head_w8=True)


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def granite():
    """Reduced granite-3-2b on both sides with identical weights."""
    jcfg = jax_get_config("granite-3-2b").reduced()
    cfg = get_config("granite-3-2b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, model


def _rows(seed, *shape):
    """Random rows with a tie row and a zero row in the first two places."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    x = x * np.float32(3.0)
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1, :len(TIES)] = TIES[:shape[-1]]
    flat[1, len(TIES):] = 0.0
    return x


def _same_bits(a, b):
    """Equal as integers / as f32 bit patterns."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ quantizers
def test_quantize_kv_token_and_decode_state_match_reference_bit_for_bit():
    x = _rows(0, 3, 4, 32)
    tq, ts = quantize_kv_token(torch.from_numpy(x))
    jq, js = jax_quantize_kv_token(jnp.asarray(x))
    _same_bits(tq.numpy(), jq)
    _same_bits(ts.numpy(), js)
    assert ts[0, 0].item() == np.float32(1e-30) and not tq[0, 0].any()
    assert ts[0, 1].item() == 1.0
    assert tq[0, 1, :8].tolist() == [127, 0, 2, 2, 0, -2, -2, 4]
    cache = _rows(1, 2, 3, 2, 48, 32)          # [L, B, Kh, S, hsz]
    cache[:, :, :, 40:] = 0.0                   # unfilled slots
    state = {"total_len": 5, "kcache": cache, "vcache": -cache}
    got = quantize_decode_state({k: torch.as_tensor(v)
                                 for k, v in state.items()})
    want = jax_quantize_state({k: jnp.asarray(v) for k, v in state.items()})
    for key in ("kcache", "vcache", "kscale", "vscale"):
        _same_bits(got[key].numpy(), want[key])
    assert (got["kscale"][..., 40:] == np.float32(1e-30)).all()
    assert got["total_len"] == 5


def test_quantize_w8_and_lm_head_match_reference_bit_for_bit(granite):
    w = _rows(2, 200, 700).T.copy()             # [K=700, N=200]; ties in col 1
    tq, ts = quantize_w8(torch.from_numpy(w))
    jq, js = jax_quantize_w8(jnp.asarray(w))
    _same_bits(tq.numpy(), jq)
    _same_bits(ts.numpy(), js)
    _, cfg, jparams, model = granite
    jhead = jax_quantize_head(jparams)
    m = prepare_decode_params(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg), HelixConfig(lm_head_w8=True))
    _same_bits(m.lm_head_q8.numpy(), jhead["lm_head_q8"])
    _same_bits(m.lm_head_scale.numpy(), jhead["lm_head_scale"])
    assert m.lm_head_q8.is_contiguous()        # the kernel takes [K, N] rows
    assert prepare_decode_params(m, HelixConfig(lm_head_w8=True)) is m
    assert model.lm_head_q8 is None


@pytest.mark.parametrize("kvp", [1, 4])
@pytest.mark.parametrize("per_request", [False, True])
def test_append_kv_quant_matches_reference_bit_for_bit(kvp, per_request):
    rng = np.random.default_rng(kvp)
    b, kh, s_loc, hsz = 3, 2, 32, 16
    kc = rng.integers(-127, 128, (b, kh, kvp * s_loc, hsz)).astype(np.int8)
    vc = rng.integers(-127, 128, (b, kh, kvp * s_loc, hsz)).astype(np.int8)
    ks = rng.random((b, kh, kvp * s_loc)).astype(np.float32)
    vs = rng.random((b, kh, kvp * s_loc)).astype(np.float32)
    kn, vn = _rows(3, b, kh, hsz), _rows(4, b, kh, hsz)
    tl = np.array([1, 30, kvp * s_loc], np.int32) if per_request else 29
    want = jax_append_kv_quant(*(jnp.asarray(a) for a in (kc, vc, ks, vs,
                                                          kn, vn, tl)),
                               kvp=kvp, rr_block=RR)
    got = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
    out = append_kv_quant(*got, torch.from_numpy(kn), torch.from_numpy(vn),
                          torch.as_tensor(tl), kvp=kvp, rr_block=RR)
    for g, o, w in zip(got, out, want):
        assert o is g                            # in place
        _same_bits(g.numpy(), w)


# ----------------------------------------------------------- w8a16 matmul
def test_w8a16_plain_matches_reference_on_ragged_shapes():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 200)).astype(np.float32)
    w = rng.standard_normal((200, 700)).astype(np.float32)
    jq, js = jax_quantize_w8(jnp.asarray(w))
    qw, scale = torch.from_numpy(np.array(jq)), torch.from_numpy(
        np.array(js))
    for fn in (w8a16_matmul, w8a16_matmul_ref):
        got = fn(torch.from_numpy(x), qw, scale)
        assert got.dtype == torch.float32 and got.shape == (3, 700)
        for want in (jax_w8a16_ref(x, jq, js),
                     jax_w8a16_matmul(x, jq, js, interpret=True)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=MM_TOL, atol=MM_TOL)
    with pytest.raises(ValueError):            # no plain path off the CPU
        w8a16_matmul(torch.zeros(3, 200, device="meta"), qw.to("meta"),
                     scale.to("meta"))
    with pytest.raises(ValueError):
        w8a16_matmul(torch.from_numpy(x), qw.float(), scale)


# ------------------------------------------------------ int8 flash_decode
def _int8_inputs(seed, kvp, b=4, qh=4, kh=2, hsz=32, s_loc=64):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, qh, hsz)).astype(np.float32)
    kf = rng.standard_normal((b, kh, kvp * s_loc, hsz)).astype(np.float32)
    vf = rng.standard_normal((b, kh, kvp * s_loc, hsz)).astype(np.float32)
    k, ks = (np.asarray(a) for a in jax_quantize_kv_token(kf))
    v, vs = (np.asarray(a) for a in jax_quantize_kv_token(vf))
    kn, vn = _rows(seed + 1, b, kh, hsz), _rows(seed + 2, b, kh, hsz)
    tl = np.array([0, 1, 37, kvp * s_loc], np.int32)
    return q, k, v, ks, vs, kn, vn, tl, s_loc


@pytest.mark.parametrize("kvp", [1, 4])
def test_flash_decode_int8_plain_matches_reference_ref(kvp):
    q, k, v, ks, vs, _, _, tl, s_loc = _int8_inputs(kvp, kvp)
    t = torch.from_numpy
    for rank in range(kvp):
        sl = slice(rank * s_loc, (rank + 1) * s_loc)
        ref = jax_decode_ref(q, k[:, :, sl], v[:, :, sl], tl, rank, kvp=kvp,
                             rr_block=RR, kscale=ks[:, :, sl],
                             vscale=vs[:, :, sl])
        for prune in (True, False):
            out, lse = flash_decode(
                t(q), t(k[:, :, sl].copy()), t(v[:, :, sl].copy()), t(tl),
                rank, kvp=kvp, rr_block=RR, kscale=t(ks[:, :, sl].copy()),
                vscale=t(vs[:, :, sl].copy()), prune=prune)
            np.testing.assert_allclose(out.numpy(), np.asarray(ref[0]),
                                       atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(lse.numpy(), np.asarray(ref[1]),
                                       atol=ATOL, rtol=RTOL)
            assert np.all(out.numpy()[0] == 0)
            assert np.all(lse.numpy()[0] == -1e30)


@pytest.mark.parametrize("kvp", [1, 4])
def test_flash_decode_int8_fused_append_matches_reference_kernel(kvp):
    """Every rank of an int8 fused-append call vs the reference kernel in
    the Pallas interpreter: outputs and LSEs within 2e-5, the appended int8
    payloads equal.  The appended scales equal the reference's
    ``append_kv_quant`` rule bit for bit; against the interpreted kernel
    they agree to one f32 ulp, because XLA compiles the kernel's
    ``amax / 127.0`` as ``amax * (1 / 127.0)`` (ROADMAP Queue C)."""
    q, k, v, ks, vs, kn, vn, tl, s_loc = _int8_inputs(10 + kvp, kvp)
    t = torch.from_numpy
    for rank in range(kvp):
        sl = slice(rank * s_loc, (rank + 1) * s_loc)
        shard = [a[:, :, sl] for a in (k, v, ks, vs)]
        ref = jax_flash_decode(q, shard[0], shard[1], jnp.asarray(tl), rank,
                               kvp=kvp, rr_block=RR, block_s=32,
                               kscale=shard[2], vscale=shard[3], k_new=kn,
                               v_new=vn, interpret=True)
        caches = [t(a.copy()) for a in shard]
        res = flash_decode(t(q), caches[0], caches[1], t(tl), rank, kvp=kvp,
                           rr_block=RR, kscale=caches[2], vscale=caches[3],
                           k_new=t(kn), v_new=t(vn))
        for i in (0, 1):
            np.testing.assert_allclose(res[i].numpy(), np.asarray(ref[i]),
                                       atol=ATOL, rtol=RTOL)
        for i in range(2, 6):
            assert res[i] is caches[i - 2]      # in place
        _same_bits(res[2].numpy(), ref[2])
        _same_bits(res[3].numpy(), ref[3])
        for i in (4, 5):
            ulps = np.abs(res[i].numpy().view(np.int32)
                          - np.asarray(ref[i]).view(np.int32))
            assert ulps.max() <= 1
    # the whole cache in one call vs the reference's append rule, eager
    # (IEEE division), on the rows with a token to append (tl[0] == 0)
    caches = [t(a.copy()) for a in (k, v, ks, vs)]
    flash_decode_shards(t(q), caches[0], caches[1], t(tl), kvp=kvp,
                        n_ranks=kvp, rr_block=RR, kscale=caches[2],
                        vscale=caches[3], k_new=t(kn), v_new=t(vn))
    want = jax_append_kv_quant(*(jnp.asarray(a[1:]) for a in
                                 (k, v, ks, vs, kn, vn, tl)),
                               kvp=kvp, rr_block=RR)
    for c, w in zip(caches, want):
        _same_bits(c[1:].numpy(), w)


@pytest.mark.parametrize("kvp", [1, 4])
def test_flash_decode_int8_fused_equals_unfused_and_pruned_equals_dense(kvp):
    q, k, v, ks, vs, kn, vn, tl, _ = _int8_inputs(20 + kvp, kvp)
    tl = np.maximum(tl, 1)                      # every row appends a token
    t = torch.from_numpy
    kw = dict(kvp=kvp, n_ranks=kvp, rr_block=RR, window=24)

    def fresh():
        return [t(a.copy()) for a in (k, v, ks, vs)]

    fused = fresh()
    of, lf = flash_decode_shards(t(q), fused[0], fused[1], t(tl),
                                 kscale=fused[2], vscale=fused[3],
                                 k_new=t(kn), v_new=t(vn), **kw)
    sep = fresh()
    append_kv_quant(*sep, t(kn), t(vn), t(tl), kvp=kvp, rr_block=RR)
    for prune in (True, False):
        ou, lu = flash_decode_shards(t(q), sep[0], sep[1], t(tl),
                                     kscale=sep[2], vscale=sep[3],
                                     prune=prune, **kw)
        assert torch.equal(of, ou) and torch.equal(lf, lu)
    for a, b in zip(fused, sep):
        _same_bits(a.numpy(), b.numpy())
    # and through helix_attention on both backends, within tolerance
    outs = []
    for backend in ("ref", "cuda"):
        c = fresh()
        hx = HelixConfig(kvp=kvp, rr_block=RR, attn_backend=backend)
        outs.append(helix_attention(hx, t(q), c[0], c[1], t(tl),
                                    kscale=c[2], vscale=c[3]))
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=ATOL,
                               rtol=RTOL)


# ----------------------------------------------------------- decode step
@pytest.fixture(scope="module")
def jax_int8_steps(granite):
    """The reference's prefill, handoff quantized by ``quantize_decode_state``
    and 6 int8 + w8 decode steps (ref backends, fixed layout): the prompt,
    the logits of each step and the greedy tokens."""
    jcfg, cfg, jparams, _ = granite
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 19))
    mesh = make_mesh((1, 1), ("data", "model"))
    jhx = JaxHelixConfig(kvp_axes=("data",), **KV8_W8)
    jlogits, jstate = jax.jit(jax_make_prefill_step(jcfg, mesh, jhx,
                                                    s_cap=64))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    jstate = dict(jax_quantize_state(jstate),
                  total_len=jnp.full((1,), 19, jnp.int32))
    jstep = jax.jit(jax_build_serve_step(jcfg, mesh, jhx, return_logits=True))
    jp = jax_quantize_head(jparams)
    cur = jnp.argmax(jlogits[:, :cfg.vocab], -1).astype(jnp.int32)
    jtoks, jlog = [], []
    for _ in range(6):
        (cur, lg), jstate = jstep(jp, jstate, cur)
        jtoks.append(int(cur[0]))
        jlog.append(np.asarray(lg))
    return toks, jtoks, jlog


@pytest.mark.parametrize("backend,kvp", [("ref", 1), ("cuda", 1),
                                         ("cuda", 4)])
def test_int8_decode_step_matches_reference(granite, jax_int8_steps, backend,
                                            kvp):
    """Prefill, the handoff quantized by ``quantize_decode_state``, then 6
    decode steps with the int8 cache and the int8 head: logits within 1e-4
    of the reference's (ref backends, fixed layout) and the same tokens."""
    _, cfg, jparams, _ = granite
    toks, jtoks, jlog = jax_int8_steps
    hx = HelixConfig(kvp=kvp, attn_backend=backend, prefill_backend=backend,
                     matmul_backend=backend, **KV8_W8)
    m = prepare_decode_params(params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg), hx)
    logits, state = make_prefill_step(cfg, hx, s_cap=64)(
        m, {"tokens": torch.from_numpy(toks)})
    state = quantize_decode_state(state)
    assert state["kcache"].dtype == torch.int8
    state["total_len"] = torch.full((1,), 19, dtype=torch.int32)
    cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    step = build_serve_step(cfg, hx, return_logits=True)
    out = []
    for i in range(6):
        (cur, lg), state = step(m, state, cur)
        out.append(int(cur[0]))
        np.testing.assert_allclose(lg.numpy(), jlog[i], atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)
    assert out == jtoks
    assert state["kcache"].dtype == torch.int8


# ---------------------------------------------------------------- serve
def test_serve_demo_int8_streams_match_reference(granite):
    """Same requests, same weights, ``hx`` with the int8 KV cache and the
    int8 lm_head on both sides: identical greedy token streams (one-shot
    prefill, FCFS, 5 requests over 2 slots)."""
    _, cfg, jparams, _ = granite
    rows = generate_trace(5, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 9)),), prompt_len=7,
        max_tokens=6, seed=0)
    jfin, _ = jax_serve_demo(
        "granite-3-2b", reduced=True, n_requests=5, prompt_len=7, max_new=6,
        max_batch=2, trace=rows, log=lambda *a: None,
        hx=JaxHelixConfig(kvp_axes=("data",), tpa_axis=None, **KV8_W8))
    # the reference's own quantized head, carried over exactly
    model = params_from_jax(jax.tree.map(np.asarray,
                                         jax_quantize_head(jparams)), cfg)
    fin, summary = serve_demo(
        "granite-3-2b", reduced=True, n_requests=5, prompt_len=(5, 9),
        max_new=6, max_batch=2, hx=HelixConfig(**KV8_W8), device="cpu",
        model=model, log=lambda *a: None)
    assert ({r.rid: r.prompt for r in fin}
            == {r.rid: r.prompt for r in jfin})
    assert ({r.rid: r.out_tokens for r in fin}
            == {r.rid: r.out_tokens for r in jfin})
    assert summary["n_finished"] == 5 and summary["n_tokens"] == 30
    assert summary["kv_cache_dtype"] == "torch.int8"


def test_engine_holds_an_int8_cache_and_serve_cli_takes_w8_flags(capsys):
    cfg = get_config("granite-3-2b").reduced()
    state = init_decode_state(cfg, 2, 40, 2, device="cpu", kv_bits=8)
    assert state["kcache"].dtype == torch.int8
    assert state["kscale"].shape == state["kcache"].shape[:-1]
    assert state["kscale"].dtype == torch.float32
    serve_main(["--reduced", "--device", "cpu", "--dtype", "float32",
                "--requests", "2", "--prompt-len", "6", "--max-new", "3",
                "--lm-head-w8", "--matmul-backend", "ref"])
    assert "2 requests, 6 tokens" in capsys.readouterr().out
    with pytest.raises(ValueError):
        HelixConfig(kv_cache_bits=4)
    with pytest.raises(ValueError):
        HelixConfig(matmul_backend="pallas")


def test_engine_on_cuda_checks_w8a16_availability(monkeypatch):
    """With ``lm_head_w8`` a CUDA engine refuses to start when the
    w8a16_matmul kernel is unavailable, even if the attention kernels are."""
    monkeypatch.setattr(registry, "available", lambda family, backend: (
        (False, "no kernel") if family == "w8a16_matmul" else (True, "")))
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(RuntimeError, match="matmul_backend"):
        DecodeEngine(cfg, None, None, None, max_batch=1, max_seq=8,
                     hx=HelixConfig(lm_head_w8=True), device="cuda")


def test_params_from_jax_takes_the_int8_head_as_a_pair(granite):
    _, cfg, jparams, _ = granite
    tree = jax.tree.map(np.asarray, jax_quantize_head(jparams))
    m = params_from_jax(tree, cfg)
    _same_bits(m.lm_head_q8.numpy(), tree["lm_head_q8"])
    _same_bits(m.lm_head_scale.numpy(), tree["lm_head_scale"])
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in tree.items()
                         if k != "lm_head_scale"}, cfg)
    with pytest.raises(ValueError):
        params_from_jax(dict(tree, lm_head_scale=tree["lm_head_scale"][:-1]),
                        cfg)
