"""The port's paged KV pool vs the JAX reference on the CPU: the layout
helpers, the appends through block tables, the page allocator, the paged
mode of flash_decode (fp and int8), the paged decode step and paged
``serve_demo``, on reduced granite-3-2b (2 layers, d_model 128) with the
reference's weights carried over by ``params_from_jax``.

Tolerances (f32): layouts, tables, page lists and appended rows (payloads
and scales) are exact; attention 2e-5 (the same softmax summed in another
order), with int8 scales appended by the interpreted Pallas kernel within
one f32 ulp (XLA multiplies by 1/127 where the port divides, as in
``test_torch_int8.py``); logits 1e-4 (as ``test_torch_model.py``).  Greedy
streams must be identical.  Inside the port, paged == fixed bit for bit.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.core import kvcache as jkv
from repro.core.helix import append_kv as jax_append_kv
from repro.core.helix import append_kv_quant as jax_append_kv_quant
from repro.core.helix import paged_slot_of_position as jax_paged_slot
from repro.core.helix import quantize_kv_token as jax_quantize_kv_token
from repro.core.sharding import HelixConfig as JaxHelixConfig
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models.model_zoo import build_serve_step as jax_build_serve_step
from repro.models.model_zoo import make_prefill_step as jax_make_prefill_step
from repro.models.transformer import init_params as jax_init_params
from repro.serving.pool import BlockAllocator as JaxBlockAllocator
from repro.serving.workload import TenantSpec, generate_trace
from repro.utils import make_mesh

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import kvcache
from repro_torch.core.helix import (append_kv, append_kv_quant,
                                    helix_attention, paged_slot_of_position)
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels import registry
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_shards
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_demo
from repro_torch.models.model_zoo import build_serve_step, make_prefill_step
from repro_torch.serving.pool import BlockAllocator
from repro_torch.serving.scheduler import Request, Scheduler

ATOL = RTOL = 2e-5      # attention outputs, f32
LOGIT_TOL = 1e-4        # logits after two layers, f32
RR = 16
B, QH, KH, HSZ, MP = 4, 4, 2, 32, 4   # MP logical pages per request


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def granite():
    """Reduced granite-3-2b on both sides with identical weights."""
    jcfg = jax_get_cfg()
    cfg = get_config("granite-3-2b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, cfg, jparams, model


def jax_get_cfg():
    from repro.configs import get_config as jax_get_config
    return jax_get_config("granite-3-2b").reduced()


def _same_bits(a, b):
    """Equal as integers / as f32 bit patterns."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    np.testing.assert_array_equal(a, b)


def _tables(rng, n_pages, b=B, mp=MP):
    """[b, mp] shuffled physical pages 1.., request i holding n_pages[i]
    leading pages; tails 0 (the sink)."""
    perm = rng.permutation(np.arange(1, 1 + sum(n_pages)))
    tab = np.zeros((b, mp), np.int32)
    i = 0
    for r, n in enumerate(n_pages):
        tab[r, :n] = perm[i:i + n]
        i += n
    return tab


# ------------------------------------------------------------ layouts
def test_layout_helpers_match_reference_under_shuffled_tables():
    rng = np.random.default_rng(0)
    kvp, page = 4, 4 * RR
    assert kvcache.page_positions(kvp, RR) == jkv.page_positions(kvp, RR)
    row = rng.standard_normal((2, KH, 200, HSZ)).astype(np.float32)
    srow = rng.random((2, KH, 200)).astype(np.float32)
    for x in (row, srow):
        got = kvcache.cache_to_pages(torch.from_numpy(x), kvp, page)
        want = jkv.cache_to_pages(jnp.asarray(x), kvp, page)
        _same_bits(got.numpy(), want)
        _same_bits(kvcache.pages_to_cache(got, kvp).numpy(),
                   jkv.pages_to_cache(want, kvp))
    tab = _tables(rng, [4, 1, 3, 0])
    pool = rng.standard_normal((12, KH, page, HSZ)).astype(np.float32)
    _same_bits(kvcache.gather_pages(torch.from_numpy(pool),
                                    torch.from_numpy(tab)).numpy(),
               jkv.gather_pages(jnp.asarray(pool), jnp.asarray(tab)))
    state = {"total_len": np.int32(5),
             "kcache": rng.standard_normal((1, B, KH, 256, HSZ)).astype(
                 np.float32),
             "kscale": rng.random((1, B, KH, 256)).astype(np.float32)}
    tab = _tables(rng, [2, 0, 2, 2])
    got = kvcache.state_to_paged({k: torch.as_tensor(v)
                                  for k, v in state.items()}, tab, 12, kvp,
                                 page)
    want = jkv.state_to_paged({k: jnp.asarray(v) for k, v in state.items()},
                              tab, 12, kvp, page)
    for key in ("kcache", "kscale", "block_tables"):
        _same_bits(got[key].numpy(), want[key])
    # the paged branch of the state: pool planes and zeroed tables
    cfg = get_config("granite-3-2b").reduced()
    st = kvcache.init_decode_state(cfg, 3, 0, kvp, RR, device="cpu",
                                   kv_bits=8, pool_blocks=9, max_pages=5)
    shapes = jkv.decode_state_shapes(jax_get_cfg(), 3, 0, kvp, RR,
                                     kv_bits=8, pool_blocks=9, max_pages=5)
    for key in ("kcache", "vcache", "kscale", "vscale", "block_tables"):
        assert tuple(st[key].shape) == shapes[key].shape, key
        assert not st[key].any()
    assert st["kcache"].dtype == torch.int8
    assert st["block_tables"].dtype == torch.int32


@pytest.mark.parametrize("kvp", [1, 4])
def test_paged_slot_and_appends_match_reference(kvp):
    """``paged_slot_of_position``, ``append_kv`` and ``append_kv_quant``
    through a shuffled table, exact against the eager reference functions
    (one row of length 0 appends to the sink page)."""
    rng = np.random.default_rng(kvp)
    page = kvp * RR
    tab = _tables(rng, [1, 2, 4, 3])
    tab[0] = 0
    n_pool = 11
    tl = np.array([0, 17, kvp * RR * MP, 2 * kvp * RR + 5], np.int32)
    pos = tl - 1
    for p in (pos, 9):
        got = paged_slot_of_position(torch.as_tensor(p), torch.from_numpy(tab),
                                     kvp=kvp, rr_block=RR, page=page)
        want = jax_paged_slot(jnp.asarray(p), jnp.asarray(tab), kvp=kvp,
                              rr_block=RR, block_s=page)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    kf = rng.standard_normal((n_pool, KH, page, HSZ)).astype(np.float32)
    kn = rng.standard_normal((B, KH, HSZ)).astype(np.float32)
    t = torch.from_numpy
    args = [jnp.asarray(a) for a in (kf, -kf, kn, -kn, tl)]
    want = jax_append_kv(*args, kvp=kvp, rr_block=RR,
                         block_tables=jnp.asarray(tab))
    got = [t(kf.copy()), t(-kf)]
    append_kv(*got, t(kn), t(-kn), t(tl), kvp=kvp, rr_block=RR,
              block_tables=t(tab))
    for g, w in zip(got, want):
        _same_bits(g.numpy(), w)
    k8, ks = (np.asarray(a) for a in jax_quantize_kv_token(kf))
    caches = (k8, -k8, ks, ks * 2)
    want = jax_append_kv_quant(*(jnp.asarray(a) for a in caches + (kn, -kn,
                                                                   tl)),
                               kvp=kvp, rr_block=RR,
                               block_tables=jnp.asarray(tab))
    got = [t(a.copy()) for a in caches]
    out = append_kv_quant(*got, t(kn), t(-kn), t(tl), kvp=kvp, rr_block=RR,
                          block_tables=t(tab))
    for g, o, w in zip(got, out, want):
        assert o is g                            # in place
        _same_bits(g.numpy(), w)


def test_block_allocator_matches_reference_on_a_seeded_sequence():
    rng = np.random.default_rng(7)
    mine, ref = BlockAllocator(13, 16), JaxBlockAllocator(13, 16)
    live: list[int] = []
    for step in range(60):
        op = rng.integers(0, 3)
        if op == 0 or not live:
            rid, n = step, int(rng.integers(0, 5))
            got, want = mine.alloc(rid, n), ref.alloc(rid, n)
            if want is not None:
                live.append(rid)
        elif op == 1:
            rid, n = live[int(rng.integers(len(live)))], int(rng.integers(1, 3))
            got, want = mine.extend(rid, n), ref.extend(rid, n)
        else:
            rid = live.pop(int(rng.integers(len(live))))
            got, want = mine.free(rid), ref.free(rid)
        assert got == want, step
        for r in live:
            assert mine.pages(r) == ref.pages(r)
        assert (mine.free_count, mine.used_count, mine.peak_in_use,
                mine.capacity) == (ref.free_count, ref.used_count,
                                   ref.peak_in_use, ref.capacity)
        assert mine.pages_for(33) == ref.pages_for(33) == 3
        mine.check_invariants()
    assert mine.peak_in_use == mine.capacity     # the pool filled up
    with pytest.raises(ValueError):
        BlockAllocator(1, 16)


# --------------------------------------------------- paged flash_decode
def _paged_inputs(seed, kvp, quant):
    """A pool of 1 + B*MP pages (rank r's rows of page p at [r*RR,
    (r+1)*RR)), shuffled tables with 0 tails, lengths 1 .. capacity."""
    rng = np.random.default_rng(seed)
    page = kvp * RR
    tl = np.array([1, 37, kvp * RR + 3, kvp * RR * MP], np.int32)
    need = [-(-int(x) // page) for x in tl]
    tab = _tables(rng, need)
    n_pool = 1 + sum(need)
    q = rng.standard_normal((B, QH, HSZ)).astype(np.float32)
    kf = rng.standard_normal((n_pool, KH, page, HSZ)).astype(np.float32)
    vf = rng.standard_normal((n_pool, KH, page, HSZ)).astype(np.float32)
    kn = rng.standard_normal((B, KH, HSZ)).astype(np.float32)
    vn = rng.standard_normal((B, KH, HSZ)).astype(np.float32)
    if not quant:
        return q, [kf, vf], kn, vn, tl, tab
    k8, ks = (np.asarray(a) for a in jax_quantize_kv_token(kf))
    v8, vs = (np.asarray(a) for a in jax_quantize_kv_token(vf))
    return q, [k8, v8, ks, vs], kn, vn, tl, tab


# (kvp, prune) of the reference calls: kvp 1 and all four ranks of kvp 4,
# prune on and off
LATTICE = {True: [(1, True), (4, False)], False: [(4, True)]}


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_paged_flash_decode_matches_reference_kernel(quant, fused):
    """Every rank's paged call vs the reference kernel in the Pallas
    interpreter on the rank's rows of every page: outputs and LSEs within
    2e-5; the appended rows exact (int8 scales within one ulp).  The port
    runs each config with prune on and off (its plain version; the kernel
    on the card holds the two equal bit for bit)."""
    t = torch.from_numpy
    for kvp, prune in LATTICE[fused]:
        q, planes, kn, vn, tl, tab = _paged_inputs(kvp + 10 * fused, kvp,
                                                   quant)
        app = dict(k_new=kn, v_new=vn) if fused else {}
        for rank in range(kvp):
            rows = slice(rank * RR, (rank + 1) * RR)
            shard = [np.ascontiguousarray(a[:, :, rows]) for a in planes]
            sc = dict(kscale=shard[2], vscale=shard[3]) if quant else {}
            ref = jax_flash_decode(q, shard[0], shard[1], jnp.asarray(tl),
                                   rank, kvp=kvp, rr_block=RR, prune=prune,
                                   block_tables=jnp.asarray(tab),
                                   interpret=True, **sc, **app)
            for pr in (True, False):
                mine = [t(a.copy()) for a in shard]
                msc = dict(kscale=mine[2], vscale=mine[3]) if quant else {}
                res = flash_decode(t(q), mine[0], mine[1], t(tl), rank,
                                   kvp=kvp, rr_block=RR, prune=pr,
                                   block_tables=t(tab),
                                   **msc, **{k: t(v) for k, v in app.items()})
                for i in (0, 1):
                    np.testing.assert_allclose(res[i].numpy(),
                                               np.asarray(ref[i]),
                                               atol=ATOL, rtol=RTOL)
                if not fused:
                    continue
                for i in range(2, len(res)):
                    assert res[i] is mine[i - 2]          # in place
                _same_bits(res[2].numpy(), ref[2])
                _same_bits(res[3].numpy(), ref[3])
                for i in (4, 5)[:2 * quant]:
                    ulps = np.abs(res[i].numpy().view(np.int32)
                                  - np.asarray(ref[i]).view(np.int32))
                    assert ulps.max() <= 1


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_paged_attention_equals_fixed_bit_for_bit(backend, kv_bits):
    """The same cache laid out fixed and paged (``state_to_paged`` under a
    shuffled table) through ``helix_attention`` at kvp 4: outputs equal bit
    for bit, and the fused (cuda) / separate (ref) append lands the same
    rows, payloads and scales."""
    rng = np.random.default_rng(kv_bits)
    kvp, page = 4, 4 * RR
    t = torch.from_numpy
    fixed = {"kcache": rng.standard_normal((1, B, KH, MP * page, HSZ)),
             "vcache": rng.standard_normal((1, B, KH, MP * page, HSZ))}
    fixed = {k: t(v.astype(np.float32)) for k, v in fixed.items()}
    if kv_bits == 8:
        fixed = kvcache.quantize_decode_state(fixed)
    tl = t(np.array([1, 37, kvp * RR + 3, MP * page], np.int32))
    tab = _tables(rng, [1, 1, 2, MP])
    paged = kvcache.state_to_paged(fixed, tab, 1 + 8, kvp, page)
    q = t(rng.standard_normal((B, QH, HSZ)).astype(np.float32))
    kn = t(rng.standard_normal((B, KH, HSZ)).astype(np.float32))
    hx = HelixConfig(kvp=kvp, rr_block=RR, attn_backend=backend)
    keys = ("kcache", "vcache", "kscale", "vscale")[:4 if kv_bits == 8 else 2]
    outs = []
    for st, tables in ((fixed, None), (paged, paged["block_tables"])):
        c = [st[k][0] for k in keys] + [None] * (4 - len(keys))
        if backend == "ref":
            if kv_bits == 8:
                append_kv_quant(*c, kn, -kn, tl, kvp=kvp, rr_block=RR,
                                block_tables=tables)
            else:
                append_kv(c[0], c[1], kn, -kn, tl, kvp=kvp, rr_block=RR,
                          block_tables=tables)
            app = {}
        else:
            app = dict(k_new=kn, v_new=-kn)
        outs.append(helix_attention(hx, q, c[0], c[1], tl, kscale=c[2],
                                    vscale=c[3], block_tables=tables, **app))
    assert torch.equal(outs[0], outs[1])
    back = kvcache.state_to_paged(fixed, tab, 1 + 8, kvp, page)
    for k in keys:
        _same_bits(back[k].numpy(), paged[k].numpy())


def test_paged_wrapper_refuses_what_the_kernel_excludes():
    t = torch.from_numpy
    q, (kf, vf), kn, vn, tl, tab = _paged_inputs(0, 1, False)
    with pytest.raises(ValueError, match="paged"):
        flash_decode(t(q), t(kf), t(vf), t(tl), 0, block_tables=t(tab),
                     contiguous=True)
    with pytest.raises(ValueError, match="paged"):
        flash_decode(t(q), t(kf), t(vf), t(tl), 0, block_tables=t(tab),
                     slot_offset=16)
    with pytest.raises(ValueError, match="block_tables"):
        flash_decode(t(q), t(kf), t(vf), t(tl), 0, block_tables=t(tab[:2]))
    with pytest.raises(ValueError):                # no plain path off the CPU
        flash_decode_shards(t(q).to("meta"), t(kf).to("meta"),
                            t(vf).to("meta"), t(tl).to("meta"), kvp=1,
                            block_tables=t(tab).to("meta"))


# ----------------------------------------------------------- decode step
def test_paged_decode_step_matches_reference(granite):
    """Prefill, the int8 handoff laid out into a shuffled pool
    (``state_to_paged``), then 4 paged decode steps at kvp 1, a third page
    granted on the way: logits within 1e-4 of the reference's paged
    ``build_serve_step`` (ref backends) and the same tokens, on the port's
    ref and cuda-on-CPU routes.  (The fp paged step is held by the streams
    below.)"""
    jcfg, cfg, jparams, model = granite
    kv_bits = 8
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (1, 19))
    page, mp = RR, 6
    tab = np.array([[5, 2, 0, 0, 0, 0]], np.int32)   # 2 pages; 0 tails
    tab_grow = np.array([[5, 2, 3, 0, 0, 0]], np.int32)
    mesh = make_mesh((1, 1), ("data", "model"))
    jhx = JaxHelixConfig(kvp_axes=("data",), paged_kv=True,
                         kv_cache_bits=kv_bits)
    jlogits, jstate = jax.jit(jax_make_prefill_step(jcfg, mesh, jhx,
                                                    s_cap=64))(
        jparams, {"tokens": jnp.asarray(toks, jnp.int32)})
    if kv_bits == 8:
        jstate = jkv.quantize_decode_state(jstate)
    jstate = jkv.state_to_paged(dict(jstate), tab, 7, 1, page)
    jstate["total_len"] = jnp.full((1,), 19, jnp.int32)
    jstep = jax.jit(jax_build_serve_step(jcfg, mesh, jhx, return_logits=True))
    cur = jnp.argmax(jlogits[:, :cfg.vocab], -1).astype(jnp.int32)
    jtoks, jlog = [], []
    for i in range(4):
        if i == 1:                  # position 32 needs a third page
            jstate["block_tables"] = jnp.asarray(tab_grow)
        (cur, lg), jstate = jstep(jparams, jstate, cur)
        jtoks.append(int(cur[0]))
        jlog.append(np.asarray(lg))
    for backend in ("ref", "cuda"):
        hx = HelixConfig(attn_backend=backend, prefill_backend=backend,
                         kv_cache_bits=kv_bits, paged_kv=True)
        logits, state = make_prefill_step(cfg, hx, s_cap=64)(
            model, {"tokens": torch.from_numpy(toks)})
        if kv_bits == 8:
            state = kvcache.quantize_decode_state(state)
        state = kvcache.state_to_paged(state, tab, 7, 1, page)
        state["total_len"] = torch.full((1,), 19, dtype=torch.int32)
        cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
        step = build_serve_step(cfg, hx, return_logits=True)
        out = []
        for i in range(4):
            if i == 1:
                state["block_tables"] = torch.from_numpy(tab_grow)
            (cur, lg), state = step(model, state, cur)
            out.append(int(cur[0]))
            np.testing.assert_allclose(lg.numpy(), jlog[i], atol=LOGIT_TOL,
                                       rtol=LOGIT_TOL)
        assert out == jtoks
        assert state["block_tables"] is not None
        assert state["kcache"].shape[1] == 7


# ---------------------------------------------------------------- serve
@pytest.mark.parametrize("pool_blocks", [0, 4], ids=["default", "pressure"])
def test_serve_demo_paged_streams_match_reference(granite, pool_blocks):
    """Same requests, same weights, ``paged_kv=True`` on both sides, at the
    default pool and at a pool of 3 pages, where the second request (3
    pages) must wait for the first to retire: identical greedy streams, the same pool occupancy peak, every
    request finishing with its token budget; and identical to the port's
    fixed-layout streams at the default pool (the same schedule)."""
    _, cfg, _, model = granite
    rows = generate_trace(3, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(33, 40)),), prompt_len=7,
        max_tokens=4, seed=0)
    jfin, jsum = jax_serve_demo(
        "granite-3-2b", reduced=True, n_requests=3, prompt_len=7, max_new=4,
        max_batch=2, trace=rows, log=lambda *a: None, paged_kv=True,
        pool_blocks=pool_blocks or None,
        hx=JaxHelixConfig(kvp_axes=("data",), tpa_axis=None))
    kw = dict(reduced=True, n_requests=3, prompt_len=(33, 40), max_new=4,
              max_batch=2, device="cpu", model=model, log=lambda *a: None)
    fin, summ = serve_demo(paged_kv=True, pool_blocks=pool_blocks, **kw)
    streams = {r.rid: r.out_tokens for r in fin}
    assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin}
    assert streams == {r.rid: r.out_tokens for r in jfin}
    assert all(r.finish_reason == "max_tokens" for r in fin + jfin)
    assert summ["paged_kv"] and jsum["paged_kv"]
    assert summ["pool_occupancy_peak"] == jsum["pool_occupancy_peak"]
    assert summ["capacity_retired"] == jsum["capacity_retired"] == 0
    if pool_blocks:
        assert summ["pool_waits"] >= 1 and summ["pool_occupancy_peak"] == 1.0
    else:
        assert summ["pool_waits"] == 0
        fixed, _ = serve_demo(**kw)
        assert {r.rid: r.out_tokens for r in fixed} == streams


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_serve_demo_paged_equals_fixed_inside_the_port(granite, backend):
    """fp and int8 caches, kvp 1 and 4: the paged streams equal the fixed
    ones token for token at the default pool, on both backends."""
    _, cfg, _, model = granite
    kw = dict(reduced=True, n_requests=3, prompt_len=(5, 30), max_new=4,
              max_batch=2, device="cpu", model=model, log=lambda *a: None,
              attn_backend=backend)
    for hx in (HelixConfig(kvp=4), HelixConfig(kv_cache_bits=8)):
        fixed, _ = serve_demo(hx=hx, **kw)
        paged, summ = serve_demo(hx=hx, paged_kv=True, **kw)
        assert ({r.rid: r.out_tokens for r in paged}
                == {r.rid: r.out_tokens for r in fixed})
        assert summ["kv_cache_dtype"] == str(
            torch.int8 if hx.kv_cache_bits == 8 else torch.float32)


def test_scheduler_pool_gate_rejects_waits_and_grows():
    """``fits`` rejects what can never fit, ``can_admit_now`` holds the pick
    in the queue (no skip-ahead), growth takes a page per 16 tokens and
    retirement gives the pages back."""
    pool = BlockAllocator(5, 16)                 # 4 allocatable pages
    sched = Scheduler(max_batch=2, cap=10**6, pool=pool)
    big = Request(rid=0, prompt=[1] * 70)        # 5 pages: never fits
    a = Request(rid=1, prompt=[1] * 40)          # 3 pages
    b = Request(rid=2, prompt=[1] * 20)          # 2 pages: waits
    c = Request(rid=3, prompt=[1] * 5)           # 1 page: behind b
    for r in (big, a, b, c):
        sched.submit(r)
    placed = sched.admit()
    assert [(r.rid, s) for r, s in placed] == [(1, 0)]
    assert big.finish_reason == "rejected" and sched.rejected == [big]
    assert [r.rid for r in sched.queue] == [2, 3] and sched.pool_waits == 1
    assert pool.pages(1) == [1, 2, 3]
    for _ in range(7):                           # 40 -> 47: still 3 pages
        sched.on_token(0)
        assert sched.grow_for_next_token(0) == []
    sched.on_token(0)
    assert sched.grow_for_next_token(0) == [4]   # position 48: a 4th page
    sched.release(0)
    assert pool.free_count == 4
    assert [r.rid for r, _ in sched.admit()] == [2, 3]
    pool.check_invariants()


def test_serve_cli_takes_paged_flags_and_needs_cuda_without_device_cpu(
        capsys):
    serve_main(["--reduced", "--device", "cpu", "--dtype", "float32",
                "--requests", "2", "--prompt-len", "6", "--max-new", "3",
                "--paged-kv", "--pool-blocks", "3", "--metrics"])
    out = capsys.readouterr().out
    assert "2 requests, 6 tokens" in out and '"paged_kv": true' in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            serve_main(["--reduced", "--paged-kv", "--requests", "1"])
    assert "flash_decode_paged" in registry.launch_counts()
