"""The port's windowed gemma3-12b (5 local layers of a 1024-token window, 1
global, final-logit softcap 30, gated GELU, head size 256) vs the JAX
reference on the CPU, on the same numpy-seeded inputs, with the reference's
weights carried over by ``params_from_jax``.

Config: ``gemma3-12b.reduced()`` (one whole local:global period of 6
layers, window 32, d_model 128, 4 q / 2 kv heads of 32, vocab 512).  The
kernels' plain versions are held at gemma3's head size 256 on their own,
with windows shorter than the lengths.

Tolerances (f32): the plain kernels 2e-5 (the same softmax summed in
another order; at hsz 256 a score sums 256 products); logits 1e-4 and K/V
2e-5 as in the other model tests; the int8 decode logits 1e-3 with the
payloads held to one unit at no more than 2 slots per layer (the hybrid's
bounds per layer, over 6 layers: a value on a rounding boundary of the
int8 quantizer can take the neighbouring payload on one side; 7 of the
~34k payloads part here); the GELU 2e-6 (the tanh form, as ``jax.nn.gelu``'s
default; the erf form is ~5e-4 off) and the softcap 1e-6.  Tokens, streams
and integer state are exact.  Inside the port, chunked == one-shot holds
bit for bit except for a lone request's one-token chunks (a single-row CPU
matmul reduces in another order; ``test_torch_chunked.py``), and grouped ==
ungrouped decode is bit for bit.
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
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.kernel import prefix_pass_kernel
from repro.kernels.flash_decode.ops import prefix_case_contract
from repro.kernels.flash_prefill import flash_prefill_ref as jax_prefill_ref
from repro.kernels.flash_prefill.ops import flash_prefill as jax_flash_prefill
from repro.launch import serve as jax_serve
from repro.models import layers as jax_layers
from repro.models import model_zoo as jzoo
from repro.models.decode_model import quantize_lm_head as jax_quantize_head
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.models.transformer import layer_windows as jax_layer_windows
from repro.serving.workload import TenantSpec, generate_trace
from repro.utils import make_mesh

from repro_torch.configs import get_config, list_archs
from repro_torch.convert import params_from_jax
from repro_torch.core.kvcache import quantize_decode_state
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_shards
from repro_torch.kernels.flash_decode.ops import prefix_pass
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.launch import serve as serve_mod
from repro_torch.models.decode_model import prepare_decode_params
from repro_torch.models.layers import activation, softcap
from repro_torch.models.model_zoo import (build_serve_step,
                                          chunked_prefill_supported,
                                          finalize_chunked_prefill,
                                          init_prefill_buffers,
                                          make_chunk_prefill_step,
                                          make_prefill_step)
from repro_torch.models.transformer import (Transformer, forward,
                                            layer_windows)

ATOL = RTOL = 2e-5
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
GELU_TOL = 2e-6
CAP_TOL = 1e-6
ARCH = "gemma3-12b"
HSZ = 256                   # gemma3's head size, for the kernel cases
RR = 16
T = 40                      # prompt of the decode cases: past the window 32
KV8_W8 = dict(kv_cache_bits=8, lm_head_w8=True)
QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@functools.lru_cache(maxsize=None)
def _gemma():
    """Both sides with identical weights: (jcfg, cfg, jparams, model)."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, model


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_windows_and_parameter_shapes_match_reference(which):
    """Every port field equals the reference's (reduced: 6 layers, window
    32, softcap 30, ``gelu_gated``); ``layer_windows`` equal; the
    parameters have the reference pytree's shapes, per layer; at full
    width 11,765,395,200 of them (~23.5 GB in bf16)."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if which == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert (cfg.n_layers, cfg.local_window, cfg.softcap, cfg.act) == (
            6, 32, 30.0, "gelu_gated")
    else:
        assert (cfg.n_layers, cfg.hsz, cfg.local_window,
                cfg.local_ratio) == (48, 256, 1024, 5)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for prop in ("hsz", "q_dim", "kv_dim", "padded_vocab"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert layer_windows(cfg) == [int(w) for w in jax_layer_windows(jcfg)]
    assert layer_windows(cfg).count(0) == cfg.n_layers // 6
    assert chunked_prefill_supported(cfg)
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
        assert sum(int(np.prod(s)) for s in got.values()) == 11_765_395_200


@pytest.mark.parametrize("arch", [a for a in list_archs() if a != ARCH])
def test_other_archs_reduced_keep_their_rule(arch):
    """The windowed rule touches no other arch: each reduced config equals
    the reference's field by field, at 2 layers and no window."""
    cfg, jcfg = get_config(arch).reduced(), jax_get_config(arch).reduced()
    for f in dataclasses.fields(cfg):
        if f.name != "moe":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.n_layers == 2 and cfg.local_window == 0
    assert layer_windows(cfg) == [0, 0]


def test_gelu_gated_and_softcap_match_reference():
    """``activation("gelu_gated")`` against ``jax.nn.gelu`` on [-6, 6]
    within 2e-6, and ``softcap`` against the reference's within 1e-6,
    including logits far past the cap; a cap of 0 returns its input."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    _close(activation("gelu_gated")(torch.from_numpy(x)),
           jax_layers.activation("gelu_gated")(jnp.asarray(x)), GELU_TOL)
    z = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    z = np.concatenate([z * 40, [-1e4, 1e4, 0.0]]).astype(np.float32)
    got = softcap(torch.from_numpy(z), 30.0)
    _close(got, jax_layers.softcap(jnp.asarray(z), 30.0), CAP_TOL)
    assert float(got.abs().max()) <= 30.0
    t = torch.from_numpy(z)
    assert softcap(t, 0.0) is t


# --------------------------------------------- plain kernels at hsz 256
def _prefill_inputs(seed, b=2, t=40, s=40, qh=4, kh=2):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return f(b, t, qh, HSZ), f(b, s, kh, HSZ), f(b, s, kh, HSZ)


@pytest.mark.parametrize("window", [0, 24], ids=["causal", "window"])
def test_flash_prefill_plain_hsz256_matches_reference(window):
    """B2's plain version at hsz 256, G = 2, causal and windowed (24 of 40
    positions), one-shot and at per-row offsets and lengths, against the
    reference's oracle; and its paged mode (pages of 8, a shuffled table,
    a +-1e4 sink page) against the reference's interpreted paged kernel."""
    q, k, v = _prefill_inputs(1)
    t = torch.from_numpy
    out = flash_prefill(t(q), t(k), t(v), causal=True, window=window)
    _close(out, jax_prefill_ref(q, k, v, causal=True, window=window), ATOL)
    offs, lens = np.array([0, 9], np.int32), np.array([31, 40], np.int32)
    qs = np.ascontiguousarray(q[:, :31])
    out = flash_prefill(t(qs), t(k), t(v), causal=True, window=window,
                        q_offset=t(offs), seq_lens=t(lens))
    for i in range(2):
        ref = jax_prefill_ref(qs[i:i + 1], k[i:i + 1], v[i:i + 1],
                              causal=True, window=window,
                              q_offset=int(offs[i]), seq_lens=lens[i:i + 1])
        _close(out[i:i + 1], ref, ATOL)
    # paged: rows' kv slots in pages of 8 under a shuffled table
    page, mp = 8, 5
    rng = np.random.default_rng(2)
    n_pool = 1 + 2 * mp
    tab = (1 + rng.permutation(2 * mp)).reshape(2, mp).astype(np.int32)
    pk = 1e4 * np.sign(rng.standard_normal((n_pool, 2, page, HSZ)))
    pv = 1e4 * np.sign(rng.standard_normal((n_pool, 2, page, HSZ)))
    pk, pv = pk.astype(np.float32), pv.astype(np.float32)
    for r in range(2):
        for p in range(mp):
            pk[tab[r, p]] = k[r, p * page:(p + 1) * page].transpose(1, 0, 2)
            pv[tab[r, p]] = v[r, p * page:(p + 1) * page].transpose(1, 0, 2)
    ref = jax_flash_prefill(qs, pk, pv, causal=True, window=window,
                            q_offset=jnp.asarray(offs),
                            seq_lens=jnp.asarray(lens), blk_q=8,
                            block_tables=jnp.asarray(tab), interpret=True)
    out = flash_prefill(t(qs), t(pk), t(pv), causal=True, window=window,
                        q_offset=t(offs), seq_lens=t(lens),
                        block_tables=t(tab))
    _close(out, ref, ATOL)


def _decode_case(mode, seed):
    """q [4, 4, 256], a shard of 64 slots per row (kvp 1) and the new row;
    ``paged``: the same slots in pages of 16 under a shuffled table;
    ``int8``: the cache quantized per slot."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    b, kh, s = 4, 2, 64
    c = {"q": f(b, 4, HSZ), "k": f(b, kh, s, HSZ), "v": f(b, kh, s, HSZ),
         "kn": f(b, kh, HSZ), "vn": f(b, kh, HSZ),
         "tl": np.array([20, 37, 50, 64], np.int32), "tab": None, "sc": {}}
    if mode == "paged":
        mp = s // RR
        tab = (1 + rng.permutation(b * mp)).reshape(b, mp).astype(np.int32)
        pk = np.zeros((1 + b * mp, kh, RR, HSZ), np.float32)
        pv = np.zeros_like(pk)
        for r in range(b):
            for p in range(mp):
                pk[tab[r, p]] = c["k"][r, :, p * RR:(p + 1) * RR]
                pv[tab[r, p]] = c["v"][r, :, p * RR:(p + 1) * RR]
        c.update(k=pk, v=pv, tab=tab)
    if mode == "int8":
        st = quantize_decode_state({"kcache": torch.from_numpy(c["k"]),
                                    "vcache": torch.from_numpy(c["v"])})
        c.update(k=st["kcache"].numpy(), v=st["vcache"].numpy(),
                 sc={"kscale": st["kscale"].numpy(),
                     "vscale": st["vscale"].numpy()})
    return c


@pytest.mark.parametrize("window", [0, 24], ids=["global", "window"])
@pytest.mark.parametrize("mode", ["fixed", "paged", "int8"])
def test_flash_decode_plain_hsz256_matches_reference_kernel(mode, window):
    """B1's plain version at hsz 256, G = 2, fused append, lengths 20-64
    (a window of 24 cuts all but the first), against the reference's
    interpreted kernel: outputs and LSEs within 2e-5, the appended cache
    (int8: payload and scales) exact; pruned == dense bit for bit."""
    c = _decode_case(mode, 3 + window)
    t = lambda x: None if x is None else torch.from_numpy(np.copy(x))
    kw = dict(kvp=1, rr_block=RR, window=window, block_tables=t(c["tab"]))
    ref = jax_flash_decode(c["q"], c["k"], c["v"], jnp.asarray(c["tl"]), 0,
                           k_new=c["kn"], v_new=c["vn"], interpret=True,
                           **dict(kw, block_tables=c["tab"]), **c["sc"])
    outs = []
    for prune in (True, False):
        k, v = t(c["k"]), t(c["v"])
        sc = {key: t(x) for key, x in c["sc"].items()}
        got = flash_decode(t(c["q"]), k, v, t(c["tl"]), 0, k_new=t(c["kn"]),
                           v_new=t(c["vn"]), prune=prune, **kw, **sc)
        outs.append(got)
        _close(got[0], ref[0], ATOL)
        _close(got[1], ref[1], ATOL)
        for g, w in zip(got[2:], ref[2:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert all(torch.equal(a, b) for a, b in zip(outs[0], outs[1]))


@pytest.mark.parametrize("window", [0, 40, 20])
def test_prefix_pass_plain_hsz256_matches_reference_kernel(window):
    """``prefix_case_contract``'s case at hsz 256 (two members of lengths
    65 and 97 sharing two pages of 32, one memberless group row): the raw
    (acc, m, l) of the plain prefix pass against the interpreted
    ``prefix_pass_kernel``.  A window of 40 cuts the shared prefix for
    both members; one of 20 excludes it wholly for the second member,
    whose partial is then empty (m = -1e30, l = 0) on both sides."""
    c = prefix_case_contract(g=2, gm=2, kh=2, hsz=HSZ, qp=4, rr_block=16,
                             block_s=32, n_blocks=4, window=window)
    meta, gnp, gtl, gtab = c.prefetch
    rng = np.random.default_rng(13)
    kf = rng.standard_normal((c.n_pool, 2, 32, HSZ)).astype(np.float32)
    vf = rng.standard_normal((c.n_pool, 2, 32, HSZ)).astype(np.float32)
    qs = rng.standard_normal((2, 2, 2 * 4, HSZ)).astype(np.float32)
    jacc, jm, jl = prefix_pass_kernel(
        qs, kf, vf, meta, gnp, gtl, gtab, scale=HSZ ** -0.5, kvp=1,
        rr_block=16, block_s=32, s_true=4 * 32, interpret=True)
    q = torch.from_numpy(np.stack([qs[0, :, :4], qs[0, :, 4:],
                                   qs[1, :, :4]]).reshape(3, 8, HSZ))
    tab = torch.from_numpy(np.stack([gtab[0], gtab[0], gtab[1]]))
    tl = torch.tensor([gtl[0, 0], gtl[0, 1], 0], dtype=torch.int32)
    acc, m, l = prefix_pass(
        q, torch.from_numpy(kf), torch.from_numpy(vf), tl, tab,
        torch.tensor([0, 0, 2], dtype=torch.int32),
        torch.tensor([2, 2, 0], dtype=torch.int32), kvp=1, n_ranks=1,
        rank=0, rr_block=16, window=window, scale=HSZ ** -0.5)
    jacc = np.asarray(jacc).reshape(2, 2, 2, 4, HSZ)
    jm = np.asarray(jm).reshape(2, 2, 2, 4)
    jl = np.asarray(jl).reshape(2, 2, 2, 4)
    for mi in range(2):
        _close(acc[0, mi], jacc[0, :, mi], ATOL)
        _close(m[0, mi], jm[0, :, mi], ATOL)
        _close(l[0, mi], jl[0, :, mi], ATOL)
    excluded = window == 20
    assert bool((l[0, 1] == 0).all()) == excluded
    assert bool((jl[0, :, 1] == 0).all()) == excluded
    if excluded:
        assert bool((m[0, 1] == -1e30).all()) and not acc[0, 1].any()
    assert float(l[0, 2].abs().max()) == 0.0


def test_grouped_decode_hsz256_window_cuts_the_prefix():
    """Grouped decode at hsz 256, one group holding 4 rows that share 3
    pages of 16 (48 slots), lengths 60/100/70/130: with a window of 40 the
    shared pages lie partly (rows 0, 2) or wholly (rows 1, 3) before each
    row's window.  The plain grouped decode equals the ungrouped one bit for
    bit, and the reference's interpreted grouped kernel within 2e-5, at
    windows 0 and 40, fp and int8."""
    rng = np.random.default_rng(21)
    b, qh, kh, mp = 4, 4, 2, 9
    tl = np.array([60, 100, 70, 130], np.int32)
    n_pool = 1 + 3 + b * mp
    pages = iter(1 + rng.permutation(n_pool - 1))
    common = [int(next(pages)) for _ in range(3)]
    tab = np.zeros((b, mp), np.int32)
    for i in range(b):
        need = -(-int(tl[i]) // RR)
        tab[i, :need] = common + [int(next(pages)) for _ in range(need - 3)]
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    k, v, q = f(n_pool, kh, RR, HSZ), f(n_pool, kh, RR, HSZ), f(b, qh, HSZ)
    groups = (torch.zeros(b, dtype=torch.int32),
              torch.full((b,), 3, dtype=torch.int32))
    for quant in (False, True):
        kv = {"kcache": torch.from_numpy(k), "vcache": torch.from_numpy(v)}
        if quant:
            kv = quantize_decode_state(kv)
        sc = {s: kv[s] for s in ("kscale", "vscale") if s in kv}
        for window in (0, 40):
            kw = dict(kvp=1, n_ranks=1, rank=0, rr_block=RR, window=window,
                      block_tables=torch.from_numpy(tab), **sc)
            args = (torch.from_numpy(q), kv["kcache"], kv["vcache"],
                    torch.from_numpy(tl))
            grp = flash_decode_shards(*args, groups=groups, **kw)
            flat = flash_decode_shards(*args, **kw)
            assert all(torch.equal(x, y) for x, y in zip(grp, flat))
            jo, jl = jax_flash_decode(
                q, kv["kcache"].numpy(), kv["vcache"].numpy(), tl, 0, kvp=1,
                rr_block=RR, window=window, block_tables=tab,
                groups=tuple(g.numpy() for g in groups), interpret=True,
                **{s: x.numpy() for s, x in sc.items()})
            _close(grp[0][0], jo, ATOL)
            _close(grp[1][0], jl, ATOL)


# ------------------------------------------------------------- forward
@functools.lru_cache(maxsize=None)
def _jax_forward():
    """The reference's logits and caches over two rows of 64 tokens (past
    the window of 32)."""
    jcfg, cfg, jparams, _ = _gemma()
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 64))
    jlogits, jex = jax.jit(lambda p, tk: jax_forward(
        jcfg, p, tk, return_cache=True))(jparams, jnp.asarray(toks,
                                                              jnp.int32))
    return toks, np.asarray(jlogits), jax.tree.map(np.asarray, jex)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_forward_matches_reference_and_the_window_is_live(backend):
    """Logits and post-RoPE K/V of every layer against the reference's
    ``forward`` at T = 64 (the port's ``cuda`` backend takes the plain
    flash_prefill on the CPU).  The same weights without the window
    (``local_window=0``) give logits further than 100x the tolerance from
    these; without the softcap, logits that the cap maps onto these."""
    _, cfg, _, model = _gemma()
    toks, jlogits, jex = _jax_forward()
    logits, ex = forward(cfg, model, torch.from_numpy(toks),
                         return_cache=True, prefill_backend=backend)
    _close(logits, jlogits, LOGIT_TOL)
    for key in ("kcache", "vcache"):
        _close(ex[key], jex[key], ATOL)
    v = cfg.vocab
    glob = forward(dataclasses.replace(cfg, local_window=0), model,
                   torch.from_numpy(toks), prefill_backend=backend)[0]
    assert (glob[..., :v] - logits[..., :v]).abs().max() > 100 * LOGIT_TOL
    # reduced logits are ~0.5, where the cap moves them by ~x^3 / 2700:
    # without it the logits are those the cap maps onto these
    raw = forward(dataclasses.replace(cfg, softcap=0.0), model,
                  torch.from_numpy(toks), prefill_backend=backend)[0]
    assert not torch.equal(raw[..., :v], logits[..., :v])
    _close(softcap(raw[..., :v], 30.0), logits[..., :v], CAP_TOL)


# ------------------------------------------------------------- chunked
def _chunked(cfg, hx, model, toks, c):
    b, t = toks.shape
    bufs = init_prefill_buffers(cfg, b, t, device="cpu")
    step = make_chunk_prefill_step(cfg, hx)
    for p in range(0, t, c):
        nxt, bufs = step(model, toks[:, p:p + c], bufs,
                         torch.full((b,), p, dtype=torch.int32))
    return nxt[:, -1], finalize_chunked_prefill(cfg, hx, bufs, t)


def test_chunk_step_matches_reference_and_equals_oneshot():
    """Chunks of 17 over a 64-token prompt (later chunks attend across the
    window edge) through the reference's chunk step and finalize and the
    port's: the first token and the round-robin caches within 2e-5.
    Inside the port, chunks of 17 and 64 of two rows give the one-shot
    prefill's caches and first token bit for bit, and chunks of 1 of one
    row within the tolerance (a single-row CPU matmul)."""
    jcfg, cfg, jparams, model = _gemma()
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 64))
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None)
    jstep = jax.jit(jzoo.make_chunk_prefill_step(jcfg, None, jhx))
    bufs = jzoo.init_prefill_buffers(jcfg, 1, 64)
    for p in range(0, 64, 17):
        jnext, bufs = jstep(jparams, jnp.asarray(toks[:1, p:p + 17]), bufs,
                            jnp.int32(p))
    jstate = jzoo.finalize_chunked_prefill(jcfg, jhx, bufs, 64, kvp=1)
    hx = HelixConfig()
    first, state = _chunked(cfg, hx, model, torch.from_numpy(toks[:1]), 17)
    assert int(first[0]) == int(jnext[0, -1])
    for key in ("kcache", "vcache"):
        _close(state[key], jstate[key], ATOL)
    for b, c in ((2, 17), (2, 64), (1, 1)):
        tk = torch.from_numpy(toks[:b])
        logits, one = make_prefill_step(cfg, hx)(model, {"tokens": tk})
        nxt, st = _chunked(cfg, hx, model, tk, c)
        assert torch.equal(nxt, torch.argmax(logits[:, :cfg.vocab],
                                             -1).to(torch.int32))
        for key in ("kcache", "vcache"):
            if b == 1 and c == 1:
                torch.testing.assert_close(st[key], one[key], atol=ATOL,
                                           rtol=RTOL)
            else:
                assert torch.equal(st[key], one[key]), (b, c, key)


# -------------------------------------------------------------- decode
@functools.lru_cache(maxsize=None)
def _jax_steps(mode):
    """The reference's prefill (T 40, ``s_cap`` 64) and 4 decode steps
    (lengths 41-44, past the window) through the steps its ``serve_demo``
    builds (``kvp_axes=("data",)``); ``mode="int8"``: the handoff
    quantized and the head pre-quantized, as its engine does."""
    jcfg, cfg, jparams, _ = _gemma()
    toks = np.random.default_rng(8).integers(0, cfg.vocab, (2, T))
    mesh = make_mesh((1, 1), ("data", "model"))
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None,
                         **(KV8_W8 if mode == "int8" else {}))
    jlogits, jstate = jax.jit(jzoo.make_prefill_step(jcfg, mesh, jhx,
                                                     s_cap=64))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    jp = jparams
    if mode == "int8":
        jstate, jp = jax_quantize_state(jstate), jax_quantize_head(jparams)
    jstate = dict(jstate, total_len=jnp.full((2,), T, jnp.int32))
    jstep = jax.jit(jzoo.build_serve_step(jcfg, mesh, jhx,
                                          return_logits=True))
    cur = jnp.argmax(jlogits[:, :cfg.vocab], -1).astype(jnp.int32)
    logs, out = [], []
    for _ in range(4):
        (cur, lg), jstate = jstep(jp, jstate, cur)
        logs.append(np.asarray(lg))
        out.append(np.asarray(cur).tolist())
    return toks, np.asarray(jlogits), logs, out, jax.tree.map(np.asarray,
                                                              jstate)


def _port_steps(mode, kvp=1):
    _, cfg, _, model = _gemma()
    toks = _jax_steps(mode)[0]
    hx = HelixConfig(kvp=kvp, **(KV8_W8 if mode == "int8" else {}))
    m = prepare_decode_params(copy.deepcopy(model), hx)
    logits, state = make_prefill_step(cfg, hx, s_cap=64)(
        m, {"tokens": torch.from_numpy(toks)})
    if mode == "int8":
        state = quantize_decode_state(state)
    state["total_len"] = torch.full((2,), T, dtype=torch.int32)
    step = build_serve_step(cfg, hx, return_logits=True)
    cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    logs, out = [], []
    for _ in range(4):
        (cur, lg), state = step(m, state, cur)
        logs.append(lg)
        out.append(cur.tolist())
    return logits, logs, out, state


@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_decode_steps_match_reference(mode):
    """Prefill plus 4 decode steps over lengths 41-44 (every local layer's
    window cuts the cache): logits within 1e-4 of the reference's at every
    step (int8 KV cache and int8 head: 1e-3, module doc), the same tokens,
    and the final caches."""
    cfg = _gemma()[1]
    _, jlogits, jlogs, jout, jstate = _jax_steps(mode)
    logits, logs, out, state = _port_steps(mode)
    _close(logits, jlogits, LOGIT_TOL)
    for got, want in zip(logs, jlogs):
        _close(got, want, INT8_LOGIT_TOL if mode == "int8" else LOGIT_TOL)
        assert float(got[:, :512].abs().max()) < 30.0    # softcapped
    assert out == jout
    if mode == "int8":
        assert state["kcache"].dtype == torch.int8
        for key in ("kcache", "vcache"):
            diff = np.abs(state[key].numpy().astype(np.int32)
                          - jstate[key].astype(np.int32))
            assert diff.max() <= 1, key
            assert np.count_nonzero(diff) <= 2 * cfg.n_layers, key
        for key in ("kscale", "vscale"):
            _close(state[key], jstate[key], ATOL)
    else:
        for key in ("kcache", "vcache"):
            _close(state[key], jstate[key], ATOL)


def test_kvp4_equals_kvp1_within_the_port():
    """KVP emulated at 4 ranks against 1, windows crossing the shards: the
    same tokens, logits within 2e-5."""
    _, logs1, out1, _ = _port_steps("fp", kvp=1)
    _, logs4, out4, _ = _port_steps("fp", kvp=4)
    assert out1 == out4
    for a, b in zip(logs1, logs4):
        _close(a, b, ATOL)


# --------------------------------------------------------------- serve
SERVE = dict(n_requests=4, max_new=6, max_batch=2)
CHUNKED_HX = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None)
SERVE_CASES = {
    "paged chunked": dict(paged_kv=True, chunk_tokens=16),
    "top-p w4": dict(sampling="top_p", temperature=0.9, top_p=0.85,
                     decode_window=4),
}


def _rows():
    return generate_trace(4, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(33, 48)),), prompt_len=40,
        max_tokens=6, seed=0)


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_serve_demo_streams_match_reference(case):
    """``serve_demo`` against the reference's (``mesh=None``), the same
    4 prompts of 33-48 tokens (past the window) and weights: greedy from
    the paged pool with chunks of 16, whose streams must also equal the
    port's fixed one-shot streams (so those equal the reference's too), and
    top-p sampled windows of 4."""
    model = _gemma()[-1]
    kw = SERVE_CASES[case]
    jkw = dict(kw, hx=CHUNKED_HX) if "chunk_tokens" in kw else kw
    jfin, jsum = jax_serve.serve_demo(ARCH, reduced=True, prompt_len=40,
                                      trace=_rows(), **SERVE, **jkw, **QUIET)
    fin, summ = serve_mod.serve_demo(ARCH, reduced=True, prompt_len=(33, 48),
                                     **SERVE, **kw, device="cpu",
                                     model=model, **QUIET)
    assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin}
    streams = {r.rid: r.out_tokens for r in fin}
    assert streams == {r.rid: r.out_tokens for r in jfin}
    assert summ["n_tokens"] == 24 and all(len(s) == 6
                                          for s in streams.values())
    if case == "paged chunked":
        assert summ["paged_kv"] and jsum["paged_kv"]
        assert summ["prefill_calls"] > 4
        one, _ = serve_mod.serve_demo(ARCH, reduced=True,
                                      prompt_len=(33, 48), **SERVE,
                                      device="cpu", model=model, **QUIET)
        assert {r.rid: r.out_tokens for r in one} == streams
    if case == "top-p w4":
        assert summ["decode_syncs"] == jsum["decode_syncs"]


def test_serve_demo_prefix_share_grouped_matches_reference():
    """6 prompts of 64 tokens whose first 40 are shared (past the window
    of 32, so the local layers' windows leave the shared pages during
    decode), budgets 4-20, max_batch 3, chunks of 8, paged: the same
    streams, ``prefix_hit_rate`` and ``pages_shared_peak`` as the
    reference with prefix sharing and grouped decode, and the same streams
    as the port's unshared run."""
    model = _gemma()[-1]
    rows = generate_trace(6, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(64, 64), max_tokens=(4, 20)),),
        prompt_len=64, max_tokens=(4, 20), seed=0)
    kw = dict(paged_kv=True, chunk_tokens=8, shared_prefix_len=40)
    jfin, jsum = jax_serve.serve_demo(
        ARCH, reduced=True, n_requests=6, prompt_len=64, max_new=(4, 20),
        max_batch=3, trace=rows, prefix_share=True, grouped_decode=True,
        hx=CHUNKED_HX, **kw, **QUIET)
    mine = dict(reduced=True, n_requests=6, prompt_len=64, max_new=(4, 20),
                max_batch=3, device="cpu", model=model, **kw, **QUIET)
    fin, summ = serve_mod.serve_demo(ARCH, prefix_share=True,
                                     grouped_decode=True, **mine)
    assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin}
    streams = {r.rid: r.out_tokens for r in fin}
    assert streams == {r.rid: r.out_tokens for r in jfin}
    assert summ["prefix_hit_rate"] == jsum["prefix_hit_rate"] > 0
    assert summ["pages_shared_peak"] == jsum["pages_shared_peak"] > 0
    assert summ["grouped_steps"] > 0
    plain, psum = serve_mod.serve_demo(ARCH, **mine)
    assert {r.rid: r.out_tokens for r in plain} == streams
    assert psum["prefix_hit_rate"] == 0


def test_params_from_jax_carries_gemma3():
    """The dense leaves with ``w3`` and no ``lm_head`` (tied), each equal
    to the reference's, per layer; bf16 on request."""
    _, cfg, jparams, model = _gemma()
    tree = jax.tree.map(np.asarray, jparams)
    assert "lm_head" not in tree and not hasattr(model, "lm_head")
    np.testing.assert_array_equal(model.embed.numpy(), tree["embed"])
    for i, lp in enumerate(model.layers):
        for name in ("w1", "w2", "w3"):
            np.testing.assert_array_equal(getattr(lp.ffn, name).numpy(),
                                          tree["layers"]["ffn"][name][i])
        np.testing.assert_array_equal(lp.attn.wq.numpy(),
                                      tree["layers"]["attn"]["wq"][i])
    m16 = params_from_jax(tree, cfg, dtype=torch.bfloat16)
    assert m16.layers[0].ffn.w3.dtype == torch.bfloat16


def test_serve_cli_takes_gemma3(capsys):
    """``--arch gemma3-12b`` on the CPU, chunked and paged, every request
    to its budget."""
    serve_mod.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                    "--dtype", "float32", "--requests", "3",
                    "--prompt-len", "40", "--max-new", "3",
                    "--chunk-tokens", "16", "--paged-kv", "--metrics"])
    out = capsys.readouterr().out
    assert "[serve] 3 requests, 9 tokens" in out
    assert "falling back" not in out
