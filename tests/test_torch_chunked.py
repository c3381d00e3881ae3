"""The port's chunked prefill vs the JAX reference on the CPU, on reduced
granite-3-2b (2 layers, d_model 128) with the reference's weights carried
over by ``params_from_jax``: ``forward`` with carry buffers and per-row
offsets, the chunk step and its finalize, and ``serve_demo`` with
``chunk_tokens``; inside the port, chunked == one-shot.

Tolerances (f32): logits 1e-4, caches and carry buffers 2e-5 (the same
sums in another order), greedy streams identical.  Inside the port,
chunked == one-shot is bit for bit: the rr caches, the first token and the
logits of three decode steps, at chunks 17 and T for one request and at 1,
17 and T for two packed requests.  A lone request's one-token chunks are
the exception: torch's CPU matmul takes another reduction path for a
single row (M = 1) than for a block of rows, so its projections, and with
them everything after, differ from the one-shot prefill in the last bits;
that case is held at the tolerances instead, and its difference shown.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core.sharding import HelixConfig as JaxHelixConfig
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models import model_zoo as jzoo
from repro.models.transformer import forward as jax_forward
from repro.models.transformer import init_params as jax_init_params
from repro.serving.workload import TenantSpec, generate_trace

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.sharding import HelixConfig
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_demo
from repro_torch.models.model_zoo import (build_serve_step,
                                          finalize_chunked_prefill,
                                          init_prefill_buffers,
                                          make_chunk_prefill_step,
                                          make_prefill_step)
from repro_torch.models.transformer import forward

ATOL = RTOL = 2e-5
LOGIT_TOL = 1e-4
T = 40


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def granite():
    from repro.configs import get_config as jax_get_config
    jcfg = jax_get_config("granite-3-2b").reduced()
    cfg = get_config("granite-3-2b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, model


def _chunked(cfg, hx, model, toks, c):
    """Chunk-prefill ``toks`` [B, T] in chunks of ``c``; returns the last
    chunk's next tokens and the finalized decode state."""
    b, t = toks.shape
    bufs = init_prefill_buffers(cfg, b, t, device="cpu")
    step = make_chunk_prefill_step(cfg, hx)
    for p in range(0, t, c):
        nxt, bufs = step(model, toks[:, p:p + c], bufs,
                         torch.full((b,), p, dtype=torch.int32))
    return nxt[:, -1], finalize_chunked_prefill(cfg, hx, bufs, t)


def test_forward_with_carry_buffers_matches_reference_row_by_row(granite):
    """Two rows at offsets 9 and 23 in one ragged call against the
    reference's forward, one row at a time (its kernel oracle broadcasts a
    [B] offset wrongly): logits and the updated carry buffers."""
    jcfg, cfg, jparams, model = granite
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, T))
    offs, c = (9, 23), 8
    shape = (cfg.n_layers, 2, T, cfg.n_kv_heads, cfg.hsz)
    bufs = {k: np.zeros(shape, np.float32) for k in ("kcache", "vcache")}
    for i, o in enumerate(offs):          # the prefix rows, from the reference
        _, ex = jax_forward(jcfg, jparams, jnp.asarray(toks[i:i + 1, :o]),
                            return_cache=True)
        for k in bufs:
            bufs[k][:, i, :o] = np.asarray(ex[k])[:, 0]
    chunk = np.stack([toks[i, o:o + c] for i, o in enumerate(offs)])
    logits, ex = forward(cfg, model, torch.from_numpy(chunk),
                         return_cache=True,
                         prefix_state={k: torch.from_numpy(v.copy())
                                       for k, v in bufs.items()},
                         q_offset=torch.tensor(offs), prefill_backend="cuda")
    for i, o in enumerate(offs):
        jl, jex = jax_forward(
            jcfg, jparams, jnp.asarray(chunk[i:i + 1]), return_cache=True,
            prefix_state={k: jnp.asarray(v[:, i:i + 1]) for k, v in
                          bufs.items()}, q_offset=o)
        np.testing.assert_allclose(logits[i].numpy(), np.asarray(jl)[0],
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        for k in ("kcache", "vcache"):
            np.testing.assert_allclose(ex[k][:, i].numpy(),
                                       np.asarray(jex[k])[:, 0], atol=ATOL,
                                       rtol=RTOL)


@pytest.mark.parametrize("kvp", [1, 2])
def test_chunk_step_and_finalize_match_reference(granite, kvp):
    """Chunks of 17 through the reference's ``make_chunk_prefill_step`` and
    ``finalize_chunked_prefill`` and the port's: the first token and the
    round-robin caches."""
    jcfg, cfg, jparams, model = granite
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (1, T))
    jhx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None)
    jstep = jax.jit(jzoo.make_chunk_prefill_step(jcfg, None, jhx))
    bufs = jzoo.init_prefill_buffers(jcfg, 1, T)
    for p in range(0, T, 17):
        jnext, bufs = jstep(jparams, jnp.asarray(toks[:, p:p + 17]), bufs,
                            jnp.int32(p))
    jstate = jzoo.finalize_chunked_prefill(jcfg, jhx, bufs, T, kvp=kvp)
    first, state = _chunked(cfg, HelixConfig(kvp=kvp), model,
                            torch.from_numpy(toks), 17)
    assert int(first[0]) == int(jnext[0, -1])
    for k in ("kcache", "vcache"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   atol=ATOL, rtol=RTOL)


def _decode_logits(cfg, hx, model, state, first, n=3):
    state = dict(state, total_len=torch.full((first.shape[0],), T,
                                             dtype=torch.int32))
    step = build_serve_step(cfg, hx, return_logits=True)
    cur, out = first.to(torch.int32), []
    for _ in range(n):
        (cur, lg), state = step(model, state, cur)
        out.append(lg)
    return torch.stack(out)


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_chunked_equals_oneshot_inside_the_port(granite, backend):
    """rr caches, first token and three decode steps' logits of a chunked
    prefill equal the one-shot prefill's bit for bit (see the module
    docstring for the lone one-token-chunk case, held at the tolerance)."""
    _, cfg, _, model = granite
    hx = HelixConfig(kvp=2, attn_backend=backend, prefill_backend=backend)
    rng = np.random.default_rng(5)
    for b, chunks in ((1, (1, 17, T)), (2, (1, 17, T))):
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (b, T)))
        logits, one = make_prefill_step(cfg, hx)(model, {"tokens": toks})
        first = torch.argmax(logits[:, :cfg.vocab], -1)
        want = _decode_logits(cfg, hx, model, one, first)
        for c in chunks:
            nxt, state = _chunked(cfg, hx, model, toks, c)
            assert torch.equal(nxt, first.to(torch.int32))
            got = _decode_logits(cfg, hx, model, state, first)
            if b == 1 and c == 1:       # a single-row matmul: not bit-exact
                for k in ("kcache", "vcache"):
                    torch.testing.assert_close(state[k], one[k], atol=ATOL,
                                               rtol=RTOL)
                torch.testing.assert_close(got, want, atol=LOGIT_TOL,
                                           rtol=LOGIT_TOL)
                continue
            for k in ("kcache", "vcache"):
                assert torch.equal(state[k], one[k]), (b, c, k)
            assert torch.equal(got, want), (b, c)


def test_serve_demo_chunked_matches_reference(granite):
    """Chunks of 8 through both engines, fixed and paged: identical greedy
    streams, and identical to the port's one-shot streams."""
    _, cfg, _, model = granite
    rows = generate_trace(4, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 30)),), prompt_len=7,
        max_tokens=5, seed=0)
    kw = dict(reduced=True, n_requests=4, prompt_len=(5, 30), max_new=5,
              max_batch=2, device="cpu", model=model, log=lambda *a: None)
    oneshot, _ = serve_demo(**kw)
    for paged in (False, True):
        jfin, _ = jax_serve_demo(
            "granite-3-2b", reduced=True, n_requests=4, prompt_len=7,
            max_new=5, max_batch=2, trace=rows, log=lambda *a: None,
            chunk_tokens=8, paged_kv=paged,
            hx=JaxHelixConfig(kvp_axes=("data",), tpa_axis=None))
        fin, summ = serve_demo(chunk_tokens=8, paged_kv=paged, **kw)
        streams = {r.rid: r.out_tokens for r in fin}
        assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt
                                                  for r in jfin}
        assert streams == {r.rid: r.out_tokens for r in jfin}
        assert streams == {r.rid: r.out_tokens for r in oneshot}
        assert summ["paged_kv"] == paged


def test_engine_refuses_what_the_reference_refuses(granite):
    """Prefix sharing needs the paged pool and chunked prefill; chunk_tokens
    needs a chunk step (the reference's ValueErrors)."""
    _, cfg, _, model = granite
    kw = dict(reduced=True, n_requests=1, prompt_len=6, max_new=2,
              device="cpu", model=model, log=lambda *a: None)
    with pytest.raises(ValueError, match="prefix_share needs"):
        serve_demo(prefix_share=True, chunk_tokens=4, **kw)
    with pytest.raises(ValueError, match="prefix_share needs"):
        serve_demo(prefix_share=True, paged_kv=True, **kw)
    from repro_torch.serving.engine import DecodeEngine
    hx = HelixConfig()
    with pytest.raises(ValueError, match="chunk_prefill_step"):
        DecodeEngine(cfg, model, build_serve_step(cfg, hx),
                     make_prefill_step(cfg, hx), max_batch=1, max_seq=16,
                     hx=hx, device="cpu", chunk_tokens=4)


def test_serve_cli_takes_chunk_and_prefix_flags(capsys):
    serve_main(["--reduced", "--device", "cpu", "--dtype", "float32",
                "--requests", "3", "--prompt-len", "40", "--max-new", "3",
                "--max-batch", "2", "--chunk-tokens", "16", "--paged-kv",
                "--prefix-share", "--grouped-decode",
                "--shared-prefix-len", "32", "--metrics"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert '"prefix_hit_rate": 0.3333333333333333' in out
