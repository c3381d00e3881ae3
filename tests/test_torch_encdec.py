"""The port's encoder-decoder family (whisper-base) vs the JAX reference on
the CPU, on the same numpy-seeded inputs, with the reference's weights
carried over by ``params_from_jax``.

whisper-base ``reduced()`` (2 encoder and 2 decoder layers, d_model 128, 4
q / 2 kv heads of 32, vocab 512) runs the whole serve path: ``encode``,
``cross_kv``, ``forward`` with ``enc_frames``, ``make_prefill_step``'s
state (``xk``/``xv`` transposed and zero-padded to a multiple of kvp,
``enc_len``), decode steps whose cross-attention is B1's contiguous mode,
and ``build_serve_multistep``.  The reference runs as its own tests run it:
its ``ref`` backends, or its interpreted Pallas kernels, with
``HelixConfig(kvp_axes=("data",))`` on a 1x1 mesh.  Encoder frames are 70
a row, not a multiple of the kernels' 64-row blocks.

Tolerances (f32): attention (the plain B1/B2, encoder output, K/V) 2e-5;
logits 1e-4 (the int8 KV cache and head: 1e-3, as in the dense tests);
sinusoidal positions 2e-5 up to position 127 (the reference's
``exp`` of the timescales differs from torch's in the last bit of a few,
which the positions multiply); tokens, shapes and padding exact.
"""
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
from repro.models import encdec as jax_encdec
from repro.models import model_zoo as jzoo
from repro.models.decode_model import quantize_lm_head as jax_quantize_head
from repro.models.layers import sinusoidal_positions as jax_positions
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
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.launch.serve import serve_demo
from repro_torch.models.decode_model import prepare_decode_params
from repro_torch.models.encdec import cross_kv, encode
from repro_torch.models.layers import sinusoidal_at, sinusoidal_positions
from repro_torch.models.model_zoo import (build_serve_multistep,
                                          build_serve_step, make_prefill_step)
from repro_torch.models.transformer import Transformer, forward
from repro_torch.serving import DecodeEngine

ARCH = "whisper-base"
ATOL = 2e-5
LOGIT_TOL = 1e-4
INT8_LOGIT_TOL = 1e-3
T, S_ENC, B = 40, 70, 2
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


@functools.lru_cache(maxsize=None)
def _model():
    """(jcfg, cfg, jparams, model) with identical weights."""
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg)


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng(3)
    cfg = _model()[1]
    toks = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    frames = rng.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    return toks, frames


def _batch(torch_side=True):
    toks, frames = _inputs()
    if torch_side:
        return {"tokens": torch.from_numpy(toks),
                "enc_frames": torch.from_numpy(frames)}
    return {"tokens": jnp.asarray(toks), "enc_frames": jnp.asarray(frames)}


# ------------------------------------------------------------- configs
def _jax_shapes(jcfg):
    shapes = jax.eval_shape(lambda: jax_init_params(jcfg,
                                                    jax.random.PRNGKey(0)))
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        name = ".".join(p.key for p in path)
        for prefix, n in (("layers.", jcfg.n_layers),
                          ("enc.layers.", jcfg.enc_layers)):
            if name.startswith(prefix):
                for i in range(n):
                    want[f"{prefix}{i}.{name[len(prefix):]}"] = tuple(
                        leaf.shape[1:])
                break
        else:
            want[name] = tuple(leaf.shape)
    return want


@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_and_parameter_shapes_match_reference(which):
    """Every port field equals the reference's (the reduced rule: 2
    encoder layers); the parameters have the reference pytree's shapes,
    the encoder's stack, ``lnx`` and ``xattn`` included; at full width
    6 + 6 layers of MHA heads of 64, no RoPE, an ungated FFN."""
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    if which == "reduced":
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "act", "use_rope", "is_encdec",
              "enc_layers", "enc_seq_ratio", "vision_patches", "hsz",
              "padded_vocab", "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    with torch.device("meta"):
        model = Transformer(cfg)
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    assert got == _jax_shapes(jcfg)
    if which == "full":
        assert (cfg.n_layers, cfg.enc_layers, cfg.hsz) == (6, 6, 64)
        assert not hasattr(model.layers[0].ffn, "w3")
        assert not hasattr(model.enc.layers[0], "xattn")
    else:
        assert cfg.enc_layers == 2


def test_sinusoidal_positions_match_sinusoidal_at_and_reference():
    """``sinusoidal_positions`` equals ``sinusoidal_at`` over an arange bit
    for bit at whisper's 1500 frames, and the reference's within 2e-5 up
    to position 127."""
    got = sinusoidal_positions(1500, 512)
    at = sinusoidal_at(torch.arange(1500), 512)
    assert torch.equal(got.view(torch.int32), at.view(torch.int32))
    _close(sinusoidal_positions(128, 128), jax_positions(128, 128), ATOL)


# ------------------------------------------------------ kernels' plain
@pytest.mark.parametrize("hsz", [32, 64])
def test_flash_prefill_plain_noncausal_matches_reference(hsz):
    """B2's plain version non-causal: self-attention at T = S = 70 and
    cross-attention at T = 40 over S = 150 (neither a multiple of 64), with
    per-row kv lengths, against the reference's oracle and its
    interpreted kernel (blocks of 64)."""
    rng = np.random.default_rng(hsz)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    t = torch.from_numpy
    for tq, s in ((70, 70), (40, 150)):
        q, k, v = f(2, tq, 8, hsz), f(2, s, 8, hsz), f(2, s, 8, hsz)
        out = flash_prefill(t(q), t(k), t(v), causal=False)
        _close(out, jax_prefill_ref(q, k, v, causal=False), ATOL)
        _close(out, jax_flash_prefill(q, k, v, causal=False, blk_q=64,
                                      blk_k=64, interpret=True), ATOL)
        lens = np.array([s, s - 33], np.int32)
        out = flash_prefill(t(q), t(k), t(v), causal=False,
                            seq_lens=t(lens))
        _close(out, jax_prefill_ref(q, k, v, causal=False, seq_lens=lens),
               ATOL)


@pytest.mark.parametrize("kvp", [1, 4])
def test_flash_decode_plain_contiguous_matches_reference_kernel(kvp):
    """B1's plain version in the contiguous layout (the cross-attention's
    static K/V: rank r holds slots [r * s_loc, (r + 1) * s_loc)) at 70 valid
    of 72 slots, 8 heads of 64, against the reference's interpreted kernel
    rank by rank."""
    rng = np.random.default_rng(kvp)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    q, k, v = f(2, 8, 64), f(2, 8, 72, 64), f(2, 8, 72, 64)
    tl = np.array([S_ENC, S_ENC], np.int32)
    o, l = flash_decode_shards(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.tensor(S_ENC),
                               kvp=kvp, n_ranks=kvp, rank=0, contiguous=True)
    s_loc = 72 // kvp
    for r in range(kvp):
        sl = slice(r * s_loc, (r + 1) * s_loc)
        jo, jl = jax_flash_decode(q, k[:, :, sl], v[:, :, sl],
                                  jnp.asarray(tl), r, kvp=kvp,
                                  contiguous=True, interpret=True)
        _close(o[r], jo, ATOL)
        _close(l[r], jl, ATOL)


# ----------------------------------------------------- encoder, forward
@functools.lru_cache(maxsize=None)
def _jax_encode():
    jcfg, _, jparams, _ = _model()
    frames = jnp.asarray(_inputs()[1])
    enc = jax.jit(lambda p, x: jax_encdec.encode(jcfg, p["enc"], x))(
        jparams, frames)
    kx, vx = jax.jit(lambda p, e: jax_encdec.cross_kv(jcfg, p["layers"],
                                                      e))(jparams, enc)
    return np.asarray(enc), np.asarray(kx), np.asarray(vx)


def test_encode_matches_reference():
    """The bidirectional encoder (B2 non-causal through the ``cuda``
    backend's plain path) over 70 frames."""
    _, cfg, _, model = _model()
    got = encode(cfg, model.enc, torch.from_numpy(_inputs()[1]))
    _close(got, _jax_encode()[0], ATOL)


def test_cross_kv_matches_reference():
    """Every decoder layer's cross K/V [L, B, S_enc, Kh, hsz] from the
    reference's encoder output."""
    _, cfg, _, model = _model()
    enc, jkx, jvx = _jax_encode()
    kx, vx = cross_kv(cfg, model.layers, torch.from_numpy(np.copy(enc)))
    assert tuple(kx.shape) == jkx.shape == (cfg.n_layers, B, S_ENC,
                                            cfg.n_kv_heads, cfg.hsz)
    _close(kx, jkx, ATOL)
    _close(vx, jvx, ATOL)


def test_forward_matches_reference():
    """Logits, the decoder's K/V and ``enc_out`` against the reference's
    ``forward`` with ``enc_frames``; ``enc_frames`` is required."""
    jcfg, cfg, jparams, model = _model()
    jb = _batch(False)
    jlogits, jex = jax.jit(lambda p, tk, fr: jax_forward(
        jcfg, p, tk, enc_frames=fr, return_cache=True))(
            jparams, jb["tokens"], jb["enc_frames"])
    b = _batch()
    logits, ex = forward(cfg, model, b["tokens"], return_cache=True,
                         enc_frames=b["enc_frames"])
    _close(logits, jlogits, LOGIT_TOL)
    for key in ("kcache", "vcache", "enc_out"):
        _close(ex[key], jex[key], ATOL)
    with pytest.raises(ValueError, match="enc_frames"):
        forward(cfg, model, b["tokens"])


# ------------------------------------------------------ prefill, decode
@functools.lru_cache(maxsize=None)
def _jax_steps(mode):
    """The reference's prefill (``s_cap`` 64) and 2 decode steps;
    ``mode="int8"``: the handoff quantized and the head pre-quantized, as
    its engine does."""
    jcfg, cfg, jparams, _ = _model()
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None,
                         **(KV8_W8 if mode == "int8" else {}))
    jlogits, jstate = jax.jit(jzoo.make_prefill_step(jcfg, MESH, jhx,
                                                     s_cap=64))(
        jparams, _batch(False))
    prefill_state = jax.tree.map(np.asarray, jstate)
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
    return np.asarray(jlogits), prefill_state, logs, out


def _port_prefill(mode="fp", kvp=1):
    _, cfg, jparams, model = _model()
    hx = HelixConfig(kvp=kvp, **(KV8_W8 if mode == "int8" else {}))
    m = model
    if mode == "int8":
        m = params_from_jax(jax.tree.map(np.asarray,
                                         jax_quantize_head(jparams)), cfg)
    m = prepare_decode_params(m, hx)
    logits, state = make_prefill_step(cfg, hx, s_cap=64)(m, _batch())
    return hx, m, logits, state


def _port_steps(mode="fp", kvp=1, n=2):
    cfg = _model()[1]
    hx, m, logits, state = _port_prefill(mode, kvp)
    if mode == "int8":
        state = quantize_decode_state(state)
    state["total_len"] = torch.full((B,), T, dtype=torch.int32)
    step = build_serve_step(cfg, hx, return_logits=True)
    cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
    first = cur
    logs, out = [], []
    for _ in range(n):
        (cur, lg), state = step(m, state, cur)
        logs.append(lg)
        out.append(cur.tolist())
    return logits, logs, out, state, first


@pytest.mark.parametrize("kvp", [1, 4])
def test_prefill_state_matches_reference(kvp):
    """``make_prefill_step``'s last logits and state: the decoder's
    round-robin K/V, ``xk``/``xv`` [L, B, Kh, S_enc_pad, hsz] with S_enc_pad
    = 70 rounded up to kvp (72 at kvp 4, zero rows past 70) and ``enc_len``
    70 (int32), against the reference's at kvp 1."""
    cfg = _model()[1]
    jlogits, jstate, _, _ = _jax_steps("fp")
    _, _, logits, state = _port_prefill(kvp=kvp)
    _close(logits, jlogits, LOGIT_TOL)
    pad = -S_ENC % kvp
    assert state["enc_len"].dtype == torch.int32
    assert state["enc_len"].shape == () and int(state["enc_len"]) == S_ENC
    assert int(jstate["enc_len"]) == S_ENC
    for key in ("xk", "xv"):
        got = state[key]
        assert tuple(got.shape) == (cfg.n_layers, B, cfg.n_kv_heads,
                                    S_ENC + pad, cfg.hsz)
        assert jstate[key].shape == (cfg.n_layers, B, cfg.n_kv_heads, S_ENC,
                                     cfg.hsz)
        _close(got[:, :, :, :S_ENC], jstate[key], ATOL)
        assert torch.all(got[:, :, :, S_ENC:] == 0)
    if kvp == 1:
        for key in ("kcache", "vcache"):
            _close(state[key], jstate[key], ATOL)


@pytest.mark.parametrize("mode", ["fp", "int8"])
def test_decode_steps_match_reference(mode):
    """Prefill plus 2 decode steps (self-attention appended, cross-attention
    over the static K/V in B1's contiguous mode): logits within 1e-4 of the
    reference's at every step (int8 KV cache and head: 1e-3), the same
    tokens; ``xk``/``xv``/``enc_len`` passed on unchanged."""
    _, jstate0, jlogs, jout = _jax_steps(mode)
    _, logs, out, state, _ = _port_steps(mode)
    for got, want in zip(logs, jlogs):
        _close(got, want, INT8_LOGIT_TOL if mode == "int8" else LOGIT_TOL)
    assert out == jout
    _close(state["xk"], jstate0["xk"], ATOL)
    assert int(state["enc_len"]) == S_ENC


def test_kvp4_equals_kvp1_within_the_port():
    """KVP emulated at 4 ranks (the cross K/V in 4 contiguous shards of 18
    slots, the last holding 16 valid) against 1: the same tokens, logits
    within 2e-5."""
    _, logs1, out1, _, _ = _port_steps(kvp=1)
    _, logs4, out4, _, _ = _port_steps(kvp=4)
    assert out1 == out4
    for a, b in zip(logs1, logs4):
        _close(a, b, ATOL)


def test_window4_equals_four_steps():
    """``build_serve_multistep`` window 4 against 4 ``serve_step``s: the
    same tokens, the same self-attention caches bit for bit, the cross K/V
    untouched."""
    cfg = _model()[1]
    _, _, out, state1, first = _port_steps(n=4)
    hx, m, _, state = _port_prefill()
    xk = state["xk"].clone()
    state["total_len"] = torch.full((B,), T, dtype=torch.int32)
    multi = build_serve_multistep(cfg, hx, window=4)
    block, cur, st = multi(m, state, first,
                           torch.full((B,), 4, dtype=torch.int32),
                           torch.full((B,), -1, dtype=torch.int32),
                           torch.zeros(B, 4, dtype=torch.int32),
                           torch.zeros(B, dtype=torch.int32))
    assert block.T.tolist() == out
    assert cur.tolist() == out[-1]
    for key in ("kcache", "vcache"):
        assert torch.equal(st[key], state1[key]), key
    assert torch.equal(st["xk"], xk)
    assert st["total_len"].tolist() == [T + 4] * B


# ------------------------------------------------------- weights, engine
def test_params_from_jax_strict_on_encoder_leaves():
    """A stray encoder leaf and a missing cross-attention leaf both fail,
    as a stray or missing decoder leaf does."""
    jcfg, cfg, jparams, _ = _model()
    tree = jax.tree.map(np.asarray, jparams)
    stray = dict(tree, enc=dict(tree["enc"], extra=np.zeros(3, np.float32)))
    with pytest.raises(KeyError, match="enc.extra"):
        params_from_jax(stray, cfg)
    layers = dict(tree["layers"])
    layers["xattn"] = {k: v for k, v in layers["xattn"].items() if k != "wo"}
    with pytest.raises(KeyError, match="xattn.wo"):
        params_from_jax(dict(tree, layers=layers), cfg)


def test_engine_and_serve_demo_refuse_whisper_as_reference_fails_late():
    """The port's engine and ``serve_demo`` refuse the audio family with a
    ``ValueError`` that names the step functions; the reference's engine
    builds and fails with a ``KeyError`` on ``enc_frames`` at its first
    prefill."""
    jcfg, cfg, jparams, model = _model()
    hx = HelixConfig()
    with pytest.raises(ValueError, match="make_prefill_step"):
        DecodeEngine(cfg, model, build_serve_step(cfg, hx),
                     make_prefill_step(cfg, hx), max_batch=2, max_seq=64,
                     hx=hx, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="audio family"):
        serve_demo(ARCH, reduced=True, device="cpu", dtype=torch.float32)
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None)
    with set_mesh(MESH):
        engine = JaxDecodeEngine(
            jcfg, jparams, jzoo.build_serve_step(jcfg, MESH, jhx),
            jzoo.make_prefill_step(jcfg, MESH, jhx), max_batch=2,
            max_seq=64, hx=jhx, tp_width=1)
        engine.submit(JaxRequest(rid=0, prompt=list(range(8)),
                                 max_new_tokens=2))
        with pytest.raises(KeyError, match="enc_frames"):
            engine.step()
