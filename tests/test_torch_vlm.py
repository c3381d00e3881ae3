"""The port's vision-language family (phi-3-vision-4.2b) and head size 96
vs the JAX reference on the CPU, on the same numpy-seeded inputs, with the
reference's weights carried over by ``params_from_jax``.

phi-3-vision ``reduced()`` (2 layers, d_model 128, 4 MHA heads of 32, 8
patch positions, vocab 512) and the variant ``hd96`` (the same with
``head_dim=96``, made by the same ``dataclasses.replace`` on both sides), so
that the model reaches head size 96, phi-3-vision's, on the CPU: ``forward``
with ``patch_embeds``, ``make_prefill_step``, decode steps fp and int8
(the int8 KV cache and head) and ``build_serve_multistep``.  The kernels'
plain versions at head size 96 (B1 round-robin, int8, paged and
contiguous at kvp 1 and 4; B2 causal and non-causal) are held against the
reference's interpreted Pallas kernels.  The reference runs with
``HelixConfig(kvp_axes=("data",))`` on a 1x1 mesh.

Tolerances (f32): attention 2e-5; logits 1e-4 (int8 KV cache and head:
1e-3, the payloads within one unit at no more than 2 slots a layer, as in
the dense tests); tokens exact.
"""
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
from repro.kernels.flash_prefill import flash_prefill_ref as jax_prefill_ref
from repro.kernels.flash_prefill.ops import flash_prefill as jax_flash_prefill
from repro.models import model_zoo as jzoo
from repro.models.decode_model import quantize_lm_head as jax_quantize_head
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serving import DecodeEngine as JaxDecodeEngine
from repro.serving.scheduler import Request as JaxRequest
from repro.utils import make_mesh, set_mesh

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvcache import quantize_decode_state
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels.flash_decode import flash_decode_shards
from repro_torch.kernels.flash_decode import ops as decode_ops
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.flash_prefill import ops as prefill_ops
from repro_torch.launch.serve import serve_demo
from repro_torch.models.decode_model import prepare_decode_params
from repro_torch.models.model_zoo import (build_serve_multistep,
                                          build_serve_step,
                                          chunked_prefill_supported,
                                          make_prefill_step)
from repro_torch.models.transformer import Transformer, forward
from repro_torch.serving import DecodeEngine

ARCH = "phi-3-vision-4.2b"
ATOL = 2e-5
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
HSZ = 96
RR = 16
T, B = 40, 2
KV8_W8 = dict(kv_cache_bits=8, lm_head_w8=True)
MESH = make_mesh((1, 1), ("data", "model"))


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


def _cfgs(which):
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    if which == "hd96":
        jcfg = dataclasses.replace(jcfg, head_dim=HSZ)
        cfg = dataclasses.replace(cfg, head_dim=HSZ)
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _model(which):
    """(jcfg, cfg, jparams, model) with identical weights."""
    jcfg, cfg = _cfgs(which)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg)


@functools.lru_cache(maxsize=None)
def _inputs(t=T):
    rng = np.random.default_rng(5)
    cfg = _cfgs("reduced")[1]
    toks = rng.integers(0, cfg.vocab, (B, t)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.vision_patches,
                                   cfg.d_model)).astype(np.float32)
    return toks, patches


def _batch(torch_side=True, t=T):
    toks, patches = _inputs(t)
    if torch_side:
        return {"tokens": torch.from_numpy(toks),
                "patch_embeds": torch.from_numpy(patches)}
    return {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)}


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_and_parameter_shapes_match_reference(which):
    """Every port field equals the reference's (the reduced rule keeps MHA
    and 8 patches); parameter shapes those of the reference pytree; at full
    width 32 MHA heads of 96 and 256 patch positions; no chunked prefill."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if which == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "act", "use_rope",
              "vision_patches", "is_encdec", "hsz", "padded_vocab"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.n_kv_heads == cfg.n_heads
    assert not chunked_prefill_supported(cfg)
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
    with torch.device("meta"):
        model = Transformer(cfg)
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == want
    if which == "full":
        assert (cfg.hsz, cfg.n_heads, cfg.vision_patches) == (96, 32, 256)


# ------------------------------------------- plain kernels at hsz 96
def _decode_case(kvp, mode, seed, kh=4, g=1):
    """q [2, g * kh, 96] and ``kvp`` shards of 64 slots per row, lengths 40
    and the full capacity, the new row (none in the contiguous layout);
    ``paged``: pages of ``kvp * 16`` under a shuffled table; ``int8``: the
    cache quantized per slot.  The port's operands and each rank's."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    b, s = 2, 64
    shards = {"k": f(kvp, b, kh, s, HSZ), "v": f(kvp, b, kh, s, HSZ)}
    c = {"q": f(b, g * kh, HSZ), "kn": f(b, kh, HSZ), "vn": f(b, kh, HSZ),
         "tl": np.array([40, kvp * s], np.int32), "tab": None}
    if mode == "contiguous":
        c["kn"] = c["vn"] = None
        c["tl"] = np.array([kvp * s - 5, kvp * s - 5], np.int32)
    if mode == "int8":
        st = quantize_decode_state({"kcache": torch.from_numpy(shards["k"]),
                                    "vcache": torch.from_numpy(shards["v"])})
        shards = {"k": st["kcache"].numpy(), "v": st["vcache"].numpy(),
                  "kscale": st["kscale"].numpy(),
                  "vscale": st["vscale"].numpy()}
    if mode == "paged":
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
    c["port"] = {key: np.concatenate(list(x), axis=2)
                 for key, x in shards.items()}
    c["ranks"] = shards
    return c


@pytest.mark.parametrize("kvp", [1, 4])
@pytest.mark.parametrize("mode", ["fixed", "int8", "paged", "contiguous"])
def test_flash_decode_plain_hsz96_matches_reference_kernel(mode, kvp):
    """B1's plain version at head size 96 (MHA, 4 heads), kvp 1 and 4, in
    the round-robin layout with the fused append (fp, int8, paged) and in
    the contiguous layout, against the reference's interpreted kernel rank
    by rank: outputs and LSEs within 2e-5, the appended payloads exact
    (int8 scales within one f32 ulp: XLA's ``* (1 / 127)``)."""
    c = _decode_case(kvp, mode, 11 + kvp)
    contiguous = mode == "contiguous"
    tl = jnp.asarray(c["tl"])
    t = lambda x: None if x is None else torch.from_numpy(np.copy(x))
    planes = {key: t(x) for key, x in c["port"].items()}
    sc = {key: planes[key] for key in ("kscale", "vscale") if key in planes}
    o, l = flash_decode_shards(
        t(c["q"]), planes["k"], planes["v"], t(c["tl"]), kvp=kvp,
        n_ranks=kvp, rank=0, rr_block=RR, k_new=t(c["kn"]), v_new=t(c["vn"]),
        block_tables=t(c["tab"]), contiguous=contiguous, **sc)
    for r in range(kvp):
        jsc = {key: c["ranks"][key][r] for key in ("kscale", "vscale")
               if key in c["ranks"]}
        ref = jax_flash_decode(
            c["q"], c["ranks"]["k"][r], c["ranks"]["v"][r], tl, r, kvp=kvp,
            rr_block=RR, k_new=c["kn"], v_new=c["vn"], interpret=True,
            block_tables=c["tab"], contiguous=contiguous, **jsc)
        _close(o[r], ref[0], ATOL)
        _close(l[r], ref[1], ATOL)
        order = ["k", "v"] + (["kscale", "vscale"] if jsc else [])
        for key, want in zip(order, ref[2:]):
            got = planes[key].numpy()
            size = got.shape[2] // kvp
            got = got[:, :, r * size:(r + 1) * size]
            if key in ("kscale", "vscale"):
                ulps = np.abs(got.view(np.int32)
                              - np.asarray(want).view(np.int32))
                assert ulps.max() <= 1, key
            else:
                np.testing.assert_array_equal(got, np.asarray(want), key)


@pytest.mark.parametrize("causal", [True, False], ids=["causal",
                                                       "noncausal"])
def test_flash_prefill_plain_hsz96_matches_reference(causal):
    """B2's plain version at head size 96 (32 heads of 96, phi-3's MHA, at
    T = S = 70; non-causal also at T = 40 over S = 150) against the
    reference's oracle and its interpreted kernel (blocks of 64)."""
    rng = np.random.default_rng(96 + causal)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    t = torch.from_numpy
    shapes = ((70, 70),) if causal else ((70, 70), (40, 150))
    for tq, s in shapes:
        q, k, v = f(1, tq, 32, HSZ), f(1, s, 32, HSZ), f(1, s, 32, HSZ)
        out = flash_prefill(t(q), t(k), t(v), causal=causal)
        _close(out, jax_prefill_ref(q, k, v, causal=causal), ATOL)
        _close(out, jax_flash_prefill(q, k, v, causal=causal, blk_q=64,
                                      blk_k=64, interpret=True), ATOL)


def test_kernels_take_hsz96_and_prefix_pass_does_not():
    """The B1 and B2 kernels are built at head size 96; B4 (prefix_pass)
    is not, and names the sizes it takes (grouped decode needs chunked
    prefill, which no head-size-96 arch runs)."""
    assert 96 in decode_ops.HSZ and 96 in prefill_ops.HSZ
    assert 96 not in decode_ops.PREFIX_HSZ
    q = torch.zeros(1, 1, 96)
    k = torch.zeros(1, 1, 64, 96)
    plan = decode_ops._decode_plan(
        q, k, k, None, None, None, None, None, None, kvp=1, n_ranks=1,
        rank=0, rr_block=RR, window=0, scale=1.0, block_s=64,
        contiguous=True, slot_offset=0, prune=True)
    assert plan.params.hsz == 96 and plan.params.contiguous == 1


# ------------------------------------------------------------- forward
@pytest.mark.parametrize("which", ["reduced", "hd96"])
def test_forward_matches_reference(which):
    """Logits and K/V of every layer against the reference's ``forward``
    with ``patch_embeds`` replacing the first 8 token embeddings."""
    jcfg, cfg, jparams, model = _model(which)
    jb = _batch(False)
    jlogits, jex = jax.jit(lambda p, tk, pe: jax_forward(
        jcfg, p, tk, patch_embeds=pe, return_cache=True))(
            jparams, jb["tokens"], jb["patch_embeds"])
    b = _batch()
    logits, ex = forward(cfg, model, b["tokens"], return_cache=True,
                         patch_embeds=b["patch_embeds"])
    _close(logits, jlogits, LOGIT_TOL)
    for key in ("kcache", "vcache"):
        _close(ex[key], jex[key], ATOL)


def test_short_prompt_refused_where_reference_returns_patch_positions():
    """A prompt shorter than its patch positions: the port raises a
    ``ValueError``; the reference's ``forward`` replaces the whole prompt
    with the 8 patches and returns logits at those 8 positions, not at the
    prompt's 5."""
    jcfg, cfg, jparams, model = _model("reduced")
    jb, b = _batch(False, t=5), _batch(t=5)
    jlogits, _ = jax_forward(jcfg, jparams, jb["tokens"],
                             patch_embeds=jb["patch_embeds"])
    assert jlogits.shape[1] == cfg.vision_patches == 8
    with pytest.raises(ValueError, match="shorter than its 8 patch"):
        forward(cfg, model, b["tokens"], patch_embeds=b["patch_embeds"])


# -------------------------------------------------------------- decode
@functools.lru_cache(maxsize=None)
def _jax_steps(which, mode):
    """The reference's prefill (``s_cap`` 64) and 2 decode steps (int8:
    the handoff quantized and the head pre-quantized, as its engine
    does)."""
    jcfg, cfg, jparams, _ = _model(which)
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None,
                         **(KV8_W8 if mode == "int8" else {}))
    jlogits, jstate = jax.jit(jzoo.make_prefill_step(jcfg, MESH, jhx,
                                                     s_cap=64))(
        jparams, _batch(False))
    jp = jparams
    if mode == "int8":
        jstate, jp = jax_quantize_state(jstate), jax_quantize_head(jparams)
    jstate = dict(jstate, total_len=jnp.full((B,), T, jnp.int32))
    jstep = jax.jit(jzoo.build_serve_step(jcfg, MESH, jhx,
                                          return_logits=True))
    cur = jnp.argmax(jlogits[:, :cfg.vocab], -1).astype(jnp.int32)
    logs, out = [], []
    for _ in range(2):
        (cur, lg), jstate = jstep(jp, jstate, cur)
        logs.append(np.asarray(lg))
        out.append(np.asarray(cur).tolist())
    return (np.asarray(jlogits), logs, out,
            jax.tree.map(np.asarray, jstate))


def _port_steps(which, mode, n=2):
    _, cfg, jparams, model = _model(which)
    hx = HelixConfig(**(KV8_W8 if mode == "int8" else {}))
    m = model
    if mode == "int8":
        m = params_from_jax(jax.tree.map(np.asarray,
                                         jax_quantize_head(jparams)), cfg)
    m = prepare_decode_params(m, hx)
    logits, state = make_prefill_step(cfg, hx, s_cap=64)(m, _batch())
    if mode == "int8":
        state = quantize_decode_state(state)
    state["total_len"] = torch.full((B,), T, dtype=torch.int32)
    step = build_serve_step(cfg, hx, return_logits=True)
    cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    logs, out = [], []
    for _ in range(n):
        (cur, lg), state = step(m, state, cur)
        logs.append(lg)
        out.append(cur.tolist())
    return logits, logs, out, state


@pytest.mark.parametrize("mode", ["fp", "int8"])
@pytest.mark.parametrize("which", ["reduced", "hd96"])
def test_decode_steps_match_reference(which, mode):
    """Prefill (last logits) plus 2 decode steps: logits within 1e-4 of the
    reference's at every step (int8: 1e-3), the same tokens, the final
    caches."""
    cfg = _model(which)[1]
    jlogits, jlogs, jout, jstate = _jax_steps(which, mode)
    logits, logs, out, state = _port_steps(which, mode)
    _close(logits, jlogits, LOGIT_TOL)
    for got, want in zip(logs, jlogs):
        _close(got, want, INT8_LOGIT_TOL if mode == "int8" else LOGIT_TOL)
    assert out == jout
    if mode == "int8":
        for key in ("kcache", "vcache"):
            diff = np.abs(state[key].numpy().astype(np.int32)
                          - jstate[key].astype(np.int32))
            assert diff.max() <= 1, key
            assert np.count_nonzero(diff) <= 2 * cfg.n_layers, key
    else:
        for key in ("kcache", "vcache"):
            _close(state[key], jstate[key], ATOL)


@pytest.mark.parametrize("which", ["reduced", "hd96"])
def test_window4_equals_four_steps(which):
    """``build_serve_multistep`` window 4 against 4 ``serve_step``s from
    the same prefill: the same tokens and caches bit for bit."""
    _, cfg, _, model = _model(which)
    _, _, out, state1 = _port_steps(which, "fp", n=4)
    hx = HelixConfig()
    logits, state = make_prefill_step(cfg, hx, s_cap=64)(model, _batch())
    state["total_len"] = torch.full((B,), T, dtype=torch.int32)
    first = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    block, _, st = build_serve_multistep(cfg, hx, window=4)(
        model, state, first, torch.full((B,), 4, dtype=torch.int32),
        torch.full((B,), -1, dtype=torch.int32),
        torch.zeros(B, 4, dtype=torch.int32), torch.zeros(B,
                                                          dtype=torch.int32))
    assert block.T.tolist() == out
    for key in ("kcache", "vcache"):
        assert torch.equal(st[key], state1[key]), key


def test_engine_and_serve_demo_refuse_vlm_as_reference_fails_late():
    """The port's engine and ``serve_demo`` refuse the vlm family with a
    ``ValueError``; the reference's engine builds and fails with a
    ``KeyError`` on ``patch_embeds`` at its first prefill."""
    jcfg, cfg, jparams, model = _model("reduced")
    hx = HelixConfig()
    with pytest.raises(ValueError, match="patch_embeds"):
        DecodeEngine(cfg, model, build_serve_step(cfg, hx),
                     make_prefill_step(cfg, hx), max_batch=2, max_seq=64,
                     hx=hx, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="vlm family"):
        serve_demo(ARCH, reduced=True, device="cpu", dtype=torch.float32)
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None)
    with set_mesh(MESH):
        engine = JaxDecodeEngine(
            jcfg, jparams, jzoo.build_serve_step(jcfg, MESH, jhx),
            jzoo.make_prefill_step(jcfg, MESH, jhx), max_batch=2,
            max_seq=64, hx=jhx, tp_width=1)
        engine.submit(JaxRequest(rid=0, prompt=list(range(12)),
                                 max_new_tokens=2))
        with pytest.raises(KeyError, match="patch_embeds"):
            engine.step()
