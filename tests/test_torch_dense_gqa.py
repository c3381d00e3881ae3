"""The port's dense GQA family past 8 query heads per kv head vs the JAX
reference on the CPU, on the same numpy-seeded inputs, with the reference's
weights carried over by ``params_from_jax``: starcoder2-15b (48 q / 4 kv
heads of 128, G = 12, an ungated GELU FFN with no ``w3``), granite-8b (G =
4) and llama-405b (128 q / 8 kv heads, G = 16, the paper's dense model).

Configs: the three at full width and ``reduced()`` (2 layers, d_model 128,
4 q / 2 kv heads of 32, vocab 512: G = 2), and two variants made by the same
``dataclasses.replace`` on both sides: ``g12`` (starcoder2 reduced at 24 q /
2 kv heads, ungated) and ``g16`` (llama-405b reduced at 32 q / 2 kv heads,
gated).  The kernels' plain versions are held at G = 12 and 16, heads of
128, on their own.

Tolerances (f32): the plain kernels 2e-5 (the same softmax summed in
another order); the GELU 2e-6 (the tanh form, as ``jax.nn.gelu``'s default)
and the ungated FFN 1e-5 (two matmuls of 128 and 256 terms); logits 1e-4
and K/V 2e-5 as in the other model tests; the int8 decode logits 1e-3 with
the payloads held to one unit at no more than 2 slots per layer (a value on
a rounding boundary of the int8 quantizer can take the neighbouring payload
on one side; ``test_torch_gemma3.py``).  Tokens, streams and integer state
are exact.
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
from repro.models.transformer import _ffn_block as jax_ffn_block
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serving.workload import TenantSpec, generate_trace
from repro.utils import make_mesh

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvcache import quantize_decode_state
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels.flash_decode import flash_decode_shards
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.kernels.flash_decode.ops import prefix_pass
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.launch import serve as serve_mod
from repro_torch.models.decode_model import prepare_decode_params
from repro_torch.models.layers import activation
from repro_torch.models.model_zoo import build_serve_step, make_prefill_step
from repro_torch.models.transformer import (Transformer, ffn_block, forward,
                                            init_params)

ATOL = RTOL = 2e-5
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
GELU_TOL = 2e-6
FFN_TOL = 1e-5
ARCHS = ("starcoder2-15b", "granite-8b", "llama-405b")
STAR = "starcoder2-15b"
HSZ = 128                   # the head size of all three, for kernel cases
RR = 16
T = 40                      # prompt of the decode cases
KV8_W8 = dict(kv_cache_bits=8, lm_head_w8=True)
QUIET = dict(log=lambda *a: None)
# full-width parameter counts (the reference pytree's, untied heads)
N_PARAMS = {"starcoder2-15b": 15_955_630_080, "granite-8b": 8_254_689_280,
            "llama-405b": 405_861_777_408}


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _cfgs(which):
    """(reference config, port config): starcoder2 reduced (G = 2,
    ungated), its G = 12 variant, or llama-405b reduced at G = 16 (gated)."""
    arch = "llama-405b" if which == "g16" else STAR
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    heads = {"reduced": {}, "g12": dict(n_heads=24, n_kv_heads=2),
             "g16": dict(n_heads=32, n_kv_heads=2)}[which]
    return (dataclasses.replace(jcfg, **heads),
            dataclasses.replace(cfg, **heads))


@functools.lru_cache(maxsize=None)
def _model(which):
    """Both sides with identical weights: (jcfg, cfg, jparams, model)."""
    jcfg, cfg = _cfgs(which)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, model


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# ------------------------------------------------------------- configs
def _jax_shapes(jcfg):
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = ".".join(p.key for p in path)
        if name.startswith("layers."):
            for i in range(jcfg.n_layers):
                want[f"layers.{i}.{name[7:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    return want


@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_parameter_shapes_match_reference(arch, which):
    """Every port field and derived width equals the reference's; the
    parameters have the reference pytree's shapes per layer, untied
    ``lm_head`` included, and starcoder2's FFN no ``w3``; at full width the
    published head layouts (G = 12, 4, 16 at head size 128) and parameter
    counts (llama-405b: 405.86 B, 6.38 GB of bf16 a layer)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if which == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
        assert (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.hsz) == (
            2, 4, 2, 32)
    else:
        g = {"starcoder2-15b": 12, "granite-8b": 4, "llama-405b": 16}[arch]
        assert (cfg.n_heads // cfg.n_kv_heads, cfg.hsz) == (g, HSZ)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    for prop in ("hsz", "q_dim", "kv_dim", "padded_vocab"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert not cfg.tie_embeddings and cfg.rope_theta == 10_000.0
    assert cfg.act == ("gelu" if arch == STAR else "silu")
    with torch.device("meta"):
        model = Transformer(cfg)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == _jax_shapes(jcfg)
    assert ("layers.0.ffn.w3" in got) == (arch != STAR)
    assert "lm_head" in got
    if which == "full":
        assert sum(int(np.prod(s)) for s in got.values()) == N_PARAMS[arch]


def test_gelu_and_the_ungated_ffn_match_reference():
    """``activation("gelu")`` against ``jax.nn.gelu`` (the reference's
    ``activation("gelu")``) on [-6, 6] within 2e-6; starcoder2's ungated
    ``ffn_block`` (act(h @ w1) @ w2, no ``w3``) against the reference's
    ``_ffn_block`` within 1e-5; the seeded ``init_params`` builds no
    ``w3`` either."""
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    _close(activation("gelu")(torch.from_numpy(x)),
           jax_layers.activation("gelu")(jnp.asarray(x)), GELU_TOL)
    jcfg, cfg, jparams, model = _model("reduced")
    h = np.random.default_rng(1).standard_normal((3, 5, cfg.d_model))
    h = h.astype(np.float32)
    jfp = jax.tree.map(lambda a: a[0], jparams["layers"]["ffn"])
    assert "w3" not in jfp and not hasattr(model.layers[0].ffn, "w3")
    want = jax_ffn_block(jcfg, jfp, jnp.asarray(h), lambda y, *a: y)
    _close(ffn_block(cfg, model.layers[0].ffn, torch.from_numpy(h)), want,
           FFN_TOL)
    seeded = init_params(cfg, 0, device="cpu")
    assert not any(n.endswith("w3") for n, _ in seeded.named_parameters())


def test_params_from_jax_carries_ungated_starcoder2():
    """The pytree with no ``ffn.w3`` and an untied ``lm_head``: every leaf
    consumed, each equal to the reference's per layer; a stray ``w3`` leaf
    fails, as does any leaf the port does not hold."""
    _, cfg, jparams, model = _model("reduced")
    tree = jax.tree.map(np.asarray, jparams)
    np.testing.assert_array_equal(model.lm_head.numpy(), tree["lm_head"])
    for i, lp in enumerate(model.layers):
        for name in ("w1", "w2"):
            np.testing.assert_array_equal(getattr(lp.ffn, name).numpy(),
                                          tree["layers"]["ffn"][name][i])
    bad = copy.deepcopy(tree)
    bad["layers"]["ffn"]["w3"] = bad["layers"]["ffn"]["w1"]
    with pytest.raises(KeyError, match="w3"):
        params_from_jax(bad, cfg)


# ------------------------------------------- plain kernels at G 12 / 16
def _decode_case(g, kh, kvp, mode, seed):
    """q [2, g * kh, 128] and ``kvp`` shards of 64 slots per row, lengths
    40 and the full capacity, the new row; ``paged``: the same slots in
    pages of ``kvp * 16`` under a shuffled table (each rank's shard holds
    rows ``[z*16, (z+1)*16)`` of every page); ``int8``: the cache quantized
    per slot.  Returns the port's operands and each rank's for the
    reference."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    b, s = 2, 64
    shards = {"k": f(kvp, b, kh, s, HSZ), "v": f(kvp, b, kh, s, HSZ)}
    c = {"q": f(b, g * kh, HSZ), "kn": f(b, kh, HSZ), "vn": f(b, kh, HSZ),
         "tl": np.array([40, kvp * s], np.int32), "tab": None}
    if "int8" in mode:
        st = quantize_decode_state({"kcache": torch.from_numpy(shards["k"]),
                                    "vcache": torch.from_numpy(shards["v"])})
        shards = {"k": st["kcache"].numpy(), "v": st["vcache"].numpy(),
                  "kscale": st["kscale"].numpy(),
                  "vscale": st["vscale"].numpy()}
    if "paged" in mode:
        mp = s // RR
        tab = (1 + rng.permutation(b * mp)).reshape(b, mp).astype(np.int32)
        pools = {}
        for key, x in shards.items():
            pool = np.zeros((kvp, 1 + b * mp, kh, RR) + x.shape[4:], x.dtype)
            for r in range(b):
                for p in range(mp):
                    pool[:, tab[r, p]] = x[:, r, :, p * RR:(p + 1) * RR]
            pools[key] = pool
        shards, c["tab"] = pools, tab
    # the port's one tensor per plane: ranks side by side along the slots
    c["port"] = {key: np.concatenate(list(x), axis=2)
                 for key, x in shards.items()}
    c["ranks"] = shards
    return c


@pytest.mark.parametrize("kvp", [1, 4])
@pytest.mark.parametrize("mode", ["fixed", "paged", "int8", "paged-int8"])
@pytest.mark.parametrize("heads", [(24, 2), (32, 2), (14, 2)],
                         ids=["g12", "g16", "g7"])
def test_flash_decode_plain_g12_g16_matches_reference_kernel(heads, mode,
                                                             kvp):
    """B1's plain version at G = 12 and 16 (and arctic-480b's 7), heads of
    128, fused append, kvp
    1 and 4 (rank by rank on the reference's side), fixed and paged, fp and
    int8, against the reference's interpreted kernel: outputs and LSEs
    within 2e-5, the appended caches exact (int8: the payloads; the scales
    within one f32 ulp, because XLA compiles the interpreted kernel's ``amax
    / 127.0`` as ``amax * (1 / 127.0)``, ``test_torch_int8.py``); pruned ==
    dense bit for bit."""
    qh, kh = heads
    c = _decode_case(qh // kh, kh, kvp, mode, 7 + qh + kvp)
    tl = jnp.asarray(c["tl"])
    refs = []
    for r in range(kvp):
        sc = {key: c["ranks"][key][r] for key in ("kscale", "vscale")
              if key in c["ranks"]}
        refs.append(jax_flash_decode(
            c["q"], c["ranks"]["k"][r], c["ranks"]["v"][r], tl, r, kvp=kvp,
            rr_block=RR, k_new=c["kn"], v_new=c["vn"], interpret=True,
            block_tables=c["tab"], **sc))
    t = lambda x: None if x is None else torch.from_numpy(np.copy(x))
    outs = []
    for prune in (True, False):
        planes = {key: t(x) for key, x in c["port"].items()}
        sc = {key: planes[key] for key in ("kscale", "vscale")
              if key in planes}
        o, l = flash_decode_shards(
            t(c["q"]), planes["k"], planes["v"], t(c["tl"]), kvp=kvp,
            n_ranks=kvp, rank=0, rr_block=RR, k_new=t(c["kn"]),
            v_new=t(c["vn"]), block_tables=t(c["tab"]), prune=prune, **sc)
        outs.append((o, l))
        order = ["k", "v"] + (["kscale", "vscale"] if sc else [])
        for r, ref in enumerate(refs):
            _close(o[r], ref[0], ATOL)
            _close(l[r], ref[1], ATOL)
            for key, want in zip(order, ref[2:]):
                # rank r's slots (fixed) or page rows (paged): axis 2
                got = planes[key].numpy()
                size = got.shape[2] // kvp
                got = got[:, :, r * size:(r + 1) * size]
                if key in ("kscale", "vscale"):
                    ulps = np.abs(got.view(np.int32)
                                  - np.asarray(want).view(np.int32))
                    assert ulps.max() <= 1, key
                else:
                    np.testing.assert_array_equal(got, np.asarray(want), key)
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_decode_kernel_refuses_g_above_8_at_hsz256():
    """The kernel's launch plan holds at most 16 query heads per kv head,
    8 at head size 256: G = 16 there raises a ValueError that names the
    limit (checked before any launch, on any device)."""
    q = torch.zeros(1, 16, 256)
    k = torch.zeros(1, 1, 64, 256)
    kw = dict(kvp=1, n_ranks=1, rank=0, rr_block=RR, window=0, scale=1.0,
              block_s=64, contiguous=False, slot_offset=0, prune=True)
    with pytest.raises(ValueError, match=r"<= 16 \(8 at hsz 256\)"):
        decode_ops._decode_plan(q, k, k, None, None, None, None, None, None,
                                **kw)
    plan = decode_ops._decode_plan(q[..., :128].contiguous(),
                                   k[..., :128].contiguous(),
                                   k[..., :128].contiguous(), None, None,
                                   None, None, None, None, **kw)
    assert plan.params.G == 16
    with pytest.raises(ValueError, match="Qh/Kh <= 16"):
        decode_ops._decode_plan(torch.zeros(1, 17, 128), k[..., :128],
                                k[..., :128], None, None, None, None, None,
                                None, **kw)


@pytest.mark.parametrize("window", [0, 40])
def test_prefix_pass_plain_g16_matches_reference_kernel(window):
    """``prefix_case_contract``'s case at G = 16, heads of 128 (two members
    of lengths 65 and 97 sharing two pages of 32 stack 32 query rows, one
    memberless group row): the raw (acc, m, l) of the plain prefix pass
    against the interpreted ``prefix_pass_kernel``."""
    g = 16
    c = prefix_case_contract(g=2, gm=2, kh=2, hsz=HSZ, qp=g, rr_block=16,
                             block_s=32, n_blocks=4, window=window)
    meta, gnp, gtl, gtab = c.prefetch
    rng = np.random.default_rng(17)
    kf = rng.standard_normal((c.n_pool, 2, 32, HSZ)).astype(np.float32)
    vf = rng.standard_normal((c.n_pool, 2, 32, HSZ)).astype(np.float32)
    qs = rng.standard_normal((2, 2, 2 * g, HSZ)).astype(np.float32)
    jacc, jm, jl = prefix_pass_kernel(
        qs, kf, vf, meta, gnp, gtl, gtab, scale=HSZ ** -0.5, kvp=1,
        rr_block=16, block_s=32, s_true=4 * 32, interpret=True)
    q = torch.from_numpy(np.stack([qs[0, :, :g], qs[0, :, g:],
                                   qs[1, :, :g]]).reshape(3, 2 * g, HSZ))
    tab = torch.from_numpy(np.stack([gtab[0], gtab[0], gtab[1]]))
    tl = torch.tensor([gtl[0, 0], gtl[0, 1], 0], dtype=torch.int32)
    acc, m, l = prefix_pass(
        q, torch.from_numpy(kf), torch.from_numpy(vf), tl, tab,
        torch.tensor([0, 0, 2], dtype=torch.int32),
        torch.tensor([2, 2, 0], dtype=torch.int32), kvp=1, n_ranks=1,
        rank=0, rr_block=16, window=window, scale=HSZ ** -0.5)
    jacc = np.asarray(jacc).reshape(2, 2, 2, g, HSZ)
    jm = np.asarray(jm).reshape(2, 2, 2, g)
    jl = np.asarray(jl).reshape(2, 2, 2, g)
    for mi in range(2):
        _close(acc[0, mi], jacc[0, :, mi], ATOL)
        _close(m[0, mi], jm[0, :, mi], ATOL)
        _close(l[0, mi], jl[0, :, mi], ATOL)
    assert float(l[0, 2].abs().max()) == 0.0


@pytest.mark.parametrize("heads", [(48, 4), (32, 2), (28, 4)],
                         ids=["g12", "g16", "g7"])
def test_flash_prefill_plain_g12_g16_matches_reference(heads):
    """B2's plain version at G = 12 and 16 (and arctic-480b's 7), heads of
    128, causal, one-shot
    and at per-row offsets and lengths, against the reference's oracle, and
    one-shot against the reference's interpreted kernel (blocks of 8)."""
    qh, kh = heads
    rng = np.random.default_rng(qh)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    q, k, v = f(2, 40, qh, HSZ), f(2, 40, kh, HSZ), f(2, 40, kh, HSZ)
    t = torch.from_numpy
    out = flash_prefill(t(q), t(k), t(v), causal=True)
    _close(out, jax_prefill_ref(q, k, v, causal=True), ATOL)
    _close(out, jax_flash_prefill(q, k, v, causal=True, blk_q=8, blk_k=8,
                                  interpret=True), ATOL)
    offs, lens = np.array([0, 9], np.int32), np.array([31, 40], np.int32)
    qs = np.ascontiguousarray(q[:, :31])
    out = flash_prefill(t(qs), t(k), t(v), causal=True, q_offset=t(offs),
                        seq_lens=t(lens))
    for i in range(2):
        ref = jax_prefill_ref(qs[i:i + 1], k[i:i + 1], v[i:i + 1],
                              causal=True, q_offset=int(offs[i]),
                              seq_lens=lens[i:i + 1])
        _close(out[i:i + 1], ref, ATOL)


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("which", ["reduced", "g12", "g16"])
def test_forward_matches_reference(which):
    """Logits and post-RoPE K/V of every layer against the reference's
    ``forward`` over two rows of 40 tokens (the ``cuda`` backend: the plain
    flash_prefill on the CPU)."""
    jcfg, cfg, jparams, model = _model(which)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, T))
    jlogits, jex = jax.jit(lambda p, tk: jax_forward(
        jcfg, p, tk, return_cache=True))(jparams, jnp.asarray(toks,
                                                              jnp.int32))
    logits, ex = forward(cfg, model, torch.from_numpy(toks),
                         return_cache=True)
    _close(logits, jlogits, LOGIT_TOL)
    for key in ("kcache", "vcache"):
        _close(ex[key], jex[key], ATOL)


# -------------------------------------------------------------- decode
@functools.lru_cache(maxsize=None)
def _jax_steps(which, mode):
    """The reference's prefill (T 40, ``s_cap`` 64) and 4 decode steps
    through the steps its ``serve_demo`` builds (``kvp_axes=("data",)``);
    ``mode="int8"``: the handoff quantized and the head pre-quantized, as
    its engine does."""
    jcfg, cfg, jparams, _ = _model(which)
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


def _port_steps(which, mode, kvp=1):
    _, cfg, jparams, model = _model(which)
    toks = _jax_steps(which, mode)[0]
    hx = HelixConfig(kvp=kvp, **(KV8_W8 if mode == "int8" else {}))
    m = model
    if mode == "int8":
        # the reference's own quantized head, carried over exactly
        m = params_from_jax(jax.tree.map(np.asarray,
                                         jax_quantize_head(jparams)), cfg)
    m = prepare_decode_params(copy.deepcopy(m), hx)
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
@pytest.mark.parametrize("which", ["reduced", "g12", "g16"])
def test_decode_steps_match_reference(which, mode):
    """Prefill plus 4 decode steps over lengths 41-44: logits within 1e-4
    of the reference's at every step (int8 KV cache and int8 head: 1e-3,
    module doc), the same tokens, and the final caches."""
    cfg = _model(which)[1]
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
            assert diff.max() <= 1, key
            assert np.count_nonzero(diff) <= 2 * cfg.n_layers, key
        for key in ("kscale", "vscale"):
            _close(state[key], jstate[key], ATOL)
    else:
        for key in ("kcache", "vcache"):
            _close(state[key], jstate[key], ATOL)


@pytest.mark.parametrize("which", ["g12", "g16"])
def test_kvp4_equals_kvp1_within_the_port(which):
    """KVP emulated at 4 ranks against 1 at G = 12 and 16: the same tokens,
    logits within 2e-5."""
    _, logs1, out1, _ = _port_steps(which, "fp", kvp=1)
    _, logs4, out4, _ = _port_steps(which, "fp", kvp=4)
    assert out1 == out4
    for a, b in zip(logs1, logs4):
        _close(a, b, ATOL)


# --------------------------------------------------------------- serve
SERVE = dict(n_requests=4, max_new=6, max_batch=2)
CHUNKED_HX = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None)
SERVE_CASES = {
    "fixed": ("reduced", {}, {}),
    "paged": ("reduced", dict(paged_kv=True), {}),
    "int8 top-p w4": ("reduced", dict(sampling="top_p", temperature=0.9,
                                      top_p=0.85, decode_window=4),
                      KV8_W8),
    "g16 fixed": ("g16", {}, {}),
}


def _rows():
    return generate_trace(4, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 20)),), prompt_len=12,
        max_tokens=6, seed=0)


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serve_demo_streams_match_reference(monkeypatch, case):
    """``serve_demo`` against the reference's (``mesh=None``), the same 4
    prompts of 5-20 tokens and weights: starcoder2 reduced greedy on the
    fixed layout and from the paged pool, top-p sampled windows of 4 with
    the int8 head and the int8 KV cache (the reference's quantized head
    carried over), and the G = 16 variant greedy on the fixed layout (fed
    to both packages' ``get_config``)."""
    which, kw, w8 = SERVE_CASES[case]
    jcfg, cfg, jparams, model = _model(which)
    monkeypatch.setattr(jax_serve, "get_config", lambda _: jcfg)
    monkeypatch.setattr(serve_mod, "get_config", lambda _: cfg)
    jkw, mkw = dict(kw), dict(kw)
    if w8:
        jkw["hx"] = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None, **w8)
        mkw["hx"] = HelixConfig(**w8)
        model = params_from_jax(jax.tree.map(np.asarray,
                                             jax_quantize_head(jparams)),
                                cfg)
    jfin, jsum = jax_serve.serve_demo(STAR, reduced=False, prompt_len=12,
                                      trace=_rows(), **SERVE, **jkw, **QUIET)
    fin, summ = serve_mod.serve_demo(STAR, reduced=False, prompt_len=(5, 20),
                                     **SERVE, **mkw, device="cpu",
                                     model=model, **QUIET)
    assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin}
    assert ({r.rid: r.out_tokens for r in fin}
            == {r.rid: r.out_tokens for r in jfin})
    assert summ["n_tokens"] == 24
    if "paged_kv" in kw:
        assert summ["paged_kv"] and jsum["paged_kv"]
    if w8:
        assert summ["kv_cache_dtype"] == "torch.int8"
        assert summ["decode_syncs"] == jsum["decode_syncs"]


def test_serve_demo_prefix_share_grouped_matches_reference():
    """starcoder2 reduced: 6 prompts of 48 tokens whose first 32 are shared,
    budgets 4-20, max_batch 3, chunks of 8, paged: the same streams,
    ``prefix_hit_rate`` and ``pages_shared_peak`` as the reference with
    prefix sharing and grouped decode, and the same streams as the port's
    unshared run."""
    model = _model("reduced")[-1]
    rows = generate_trace(6, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(48, 48), max_tokens=(4, 20)),),
        prompt_len=48, max_tokens=(4, 20), seed=0)
    kw = dict(paged_kv=True, chunk_tokens=8, shared_prefix_len=32)
    jfin, jsum = jax_serve.serve_demo(
        STAR, reduced=True, n_requests=6, prompt_len=48, max_new=(4, 20),
        max_batch=3, trace=rows, prefix_share=True, grouped_decode=True,
        hx=CHUNKED_HX, **kw, **QUIET)
    mine = dict(reduced=True, n_requests=6, prompt_len=48, max_new=(4, 20),
                max_batch=3, device="cpu", model=model, **kw, **QUIET)
    fin, summ = serve_mod.serve_demo(STAR, prefix_share=True,
                                     grouped_decode=True, **mine)
    assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin}
    streams = {r.rid: r.out_tokens for r in fin}
    assert streams == {r.rid: r.out_tokens for r in jfin}
    assert summ["prefix_hit_rate"] == jsum["prefix_hit_rate"] > 0
    assert summ["pages_shared_peak"] == jsum["pages_shared_peak"] > 0
    assert summ["grouped_steps"] > 0
    plain, psum = serve_mod.serve_demo(STAR, **mine)
    assert {r.rid: r.out_tokens for r in plain} == streams
    assert psum["prefix_hit_rate"] == 0


def test_serve_cli_takes_the_three_archs_and_a_depth_cut(capsys):
    """``--arch starcoder2-15b`` on the CPU, chunked and paged; ``--arch
    llama-405b --layers 1`` and ``--arch granite-8b``: every request to its
    budget."""
    base = ["--reduced", "--device", "cpu", "--dtype", "float32",
            "--requests", "3", "--prompt-len", "20", "--max-new", "3"]
    serve_mod.main(["--arch", STAR, *base, "--chunk-tokens", "8",
                    "--paged-kv", "--metrics"])
    serve_mod.main(["--arch", "llama-405b", "--layers", "1", *base])
    serve_mod.main(["--arch", "granite-8b", *base])
    out = capsys.readouterr().out
    assert out.count("[serve] 3 requests, 9 tokens") == 3
    assert "falling back" not in out
