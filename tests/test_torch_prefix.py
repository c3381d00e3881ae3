"""The port's prefix sharing and grouped shared-prefix decode vs the JAX
reference on the CPU: the refcounted pool, the prefix index, the
scheduler's prefix-aware admission, the plain prefix pass and grouped
decode against the interpreted Pallas kernels, and ``serve_demo`` with
``prefix_share`` and ``grouped_decode``, on reduced granite-3-2b (2
layers, d_model 128) with the reference's weights carried over by
``params_from_jax``.

Tolerances (f32): pages, refcounts, generations, matches and every other
integer exact; attention state and outputs 2e-5 (the same softmax summed
in another order); greedy streams, ``prefix_hit_rate`` and
``pages_shared_peak`` identical.  Inside the port, grouped == ungrouped
(fp and int8, kvp 1 and 2, with a window, with a split inside a tile, one
group holding the whole batch) and shared == unshared == grouped serving
are bit for bit, in outputs and LSEs and in every decode step's logits.
"""
import numpy as np
import jax
import pytest
import torch

from repro.core.sharding import HelixConfig as JaxHelixConfig
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode.kernel import prefix_pass_kernel
from repro.kernels.flash_decode.ops import prefix_case_contract
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models.transformer import init_params as jax_init_params
from repro.serving import scheduler as jsched
from repro.serving.pool import BlockAllocator as JaxBlockAllocator
from repro.serving.workload import TenantSpec, generate_trace

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvcache import quantize_decode_state
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels.flash_decode.ops import (_dense_shards,
                                                  flash_decode_shards,
                                                  prefix_pass)
from repro_torch.kernels.flash_decode.ref import merge_chunks
from repro_torch.launch.serve import generate_rows, prompt_tokens, serve_demo
from repro_torch.models.model_zoo import (build_serve_step,
                                          make_chunk_prefill_step,
                                          make_prefill_step)
from repro_torch.serving import scheduler as sched
from repro_torch.serving.engine import DecodeEngine
from repro_torch.serving.pool import BlockAllocator
from repro_torch.serving.scheduler import DECODE, Request

ATOL = RTOL = 2e-5
RR = 16


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
    return cfg, model


# ---------------------------------------------------------------- pool
def _pool_view(p):
    return (p.free_count, p.used_count, p.peak_in_use, p.shared_count(),
            p.pages_shared_peak,
            [p.refcount(i) for i in range(p.n_blocks)],
            [p.generation(i) for i in range(p.n_blocks)])


def test_pool_sharing_matches_reference_on_a_seeded_sequence():
    """alloc / extend / share / cow / release streams on both allocators:
    the same page lists, refcounts, generations, shared counts and
    peaks."""
    rng = np.random.default_rng(11)
    mine, ref = BlockAllocator(17, 16), JaxBlockAllocator(17, 16)
    live: list[int] = []
    for step in range(120):
        op = int(rng.integers(0, 5))
        if op == 0 or not live:
            n = int(rng.integers(0, 4))
            got, want = mine.alloc(step, n), ref.alloc(step, n)
            live += [step] if want is not None else []
        elif op == 1:
            rid = live[int(rng.integers(len(live)))]
            n = int(rng.integers(1, 3))
            got, want = mine.extend(rid, n), ref.extend(rid, n)
        elif op == 2:
            src = ref.pages(live[int(rng.integers(len(live)))])
            k = int(rng.integers(0, len(src) + 1))
            got, want = mine.share(step, src[:k]), ref.share(step, src[:k])
            live.append(step)
        elif op == 3:
            rid = live[int(rng.integers(len(live)))]
            if not ref.pages(rid):
                continue
            li = int(rng.integers(len(ref.pages(rid))))
            got, want = mine.cow(rid, li), ref.cow(rid, li)
        else:
            rid = live.pop(int(rng.integers(len(live))))
            got, want = mine.release(rid), ref.release(rid)
        assert got == want, (step, op)
        assert all(mine.pages(r) == ref.pages(r) for r in live)
        assert _pool_view(mine) == _pool_view(ref), step
        mine.check_invariants()
    assert mine.pages_shared_peak > 0 and mine.peak_in_use == mine.capacity
    with pytest.raises(ValueError):
        mine.share(999, [0])


# ---------------------------------------------------------- prefix index
def test_prefix_index_and_kv_pages_match_reference():
    """register / match / valid_leading_pages / resolve_kv / eviction on
    both indexes over the same pool history, and the page-stack helpers."""
    rng = np.random.default_rng(12)
    pools = BlockAllocator(40, 4), JaxBlockAllocator(40, 4)
    idx = (sched.PrefixIndex(4, pools[0], max_entries=3),
           jsched.PrefixIndex(4, pools[1], max_entries=3))
    base = rng.integers(0, 50, 30).tolist()
    prompts = [base[:n] + rng.integers(0, 50, 5).tolist()
               for n in (13, 8, 21, 3)] + [base[:17]]
    for rid, toks in enumerate(prompts):
        npg = -(-len(toks) // 4)
        for p in pools:
            p.alloc(rid, npg)
        kv = rng.standard_normal((2, 2, len(toks), 2, 3)).astype(np.float32)
        idx[0].register(toks, pools[0].pages(rid),
                        tuple(torch.from_numpy(x) for x in kv))
        idx[1].register(toks, pools[1].pages(rid), tuple(kv))
        if rid == 2:                    # recycle an entry's pages
            for p in pools:
                p.release(0)
                p.alloc(100, 3)
    assert len(idx[0]) == len(idx[1]) == 3
    for toks in [base, base[:12], base[:9] + [99], prompts[1], [7, 7], []]:
        for limit in (len(toks), max(len(toks) - 1, 0), 6):
            (m, e), (jm, je) = (i.match(toks, limit) for i in idx)
            assert m == jm and (e is None) == (je is None)
            if e is None:
                continue
            assert e["tokens"] == je["tokens"] and e["seq"] == je["seq"]
            assert idx[0].valid_leading_pages(e) == \
                idx[1].valid_leading_pages(je)
            for a, b in zip(idx[0].resolve_kv(e), idx[1].resolve_kv(je)):
                np.testing.assert_array_equal(a.numpy(), b)
    assert idx[0].hit_rate() == idx[1].hit_rate() > 0
    x = rng.standard_normal((2, 10, 2, 3)).astype(np.float32)
    pages = sched._kv_to_pages(torch.from_numpy(x), 4)
    np.testing.assert_array_equal(pages.numpy(), jsched._kv_to_pages(x, 4))
    np.testing.assert_array_equal(sched._pages_to_kv(pages, 10).numpy(), x)


def test_scheduler_prefix_admission_matches_reference():
    """The prefix-aware gates and reservation: a registrant, then requests
    that match a full-page prefix, a partial page (shared, then copied on
    write), the whole prompt, and nothing; the same placements, page lists,
    matches and refcounts, under pool pressure."""
    sides = []
    for mod, alloc in ((sched, BlockAllocator), (jsched, JaxBlockAllocator)):
        pool = alloc(12, 4)
        index = mod.PrefixIndex(4, pool)
        sides.append((mod, pool, index, mod.Scheduler(
            max_batch=3, cap=10**6, pool=pool, prefix_index=index)))
    base = list(range(1, 20))
    prompts = [base[:14], base[:8] + [50, 51], base[:10] + [60],
               base[:14], [70, 71, 72], base[:18]]
    log = []
    for mod, pool, index, s in sides:
        reqs = [mod.Request(rid=i, prompt=p) for i, p in enumerate(prompts)]
        s.submit(reqs[0])
        first = s.admit()
        index.register(reqs[0].prompt, pool.pages(0))
        for r in reqs[1:]:
            s.submit(r)
        placed = [(r.rid, slot) for r, slot in first + s.admit()]
        s.release(placed[1][1])
        placed += [(r.rid, slot) for r, slot in s.admit()]
        log.append((placed, [r.admit_seq for r in reqs],
                    [(r.shared_len, r.shared_pages) for r in reqs],
                    {r.rid: pool.pages(r.rid) for r in reqs},
                    [pool.refcount(p) for p in range(12)],
                    [r.rid for r in s.queue], pool.pages_shared_peak))
        pool.check_invariants()
    assert log[0] == log[1]
    assert log[0][6] > 0


# ----------------------------------------------------------- prefix pass
def _groups_case(rng, *, b, qh, kh, hsz, ps, kvp, tl, shared, gid, mp, quant):
    """Paged operands for grouped decode: rows with the same ``gid`` map
    the same ``shared[g]`` leading pages, then pages of their own."""
    n_pool = 1 + sum(shared.values()) + b * mp
    tab = np.zeros((b, mp), np.int32)
    pages = iter(rng.permutation(np.arange(1, n_pool)))
    common = {g: [int(next(pages)) for _ in range(n)]
              for g, n in shared.items()}
    for i in range(b):
        need = -(-int(tl[i]) // (kvp * ps))
        row = common.get(gid[i], [])[:need]
        row += [int(next(pages)) for _ in range(need - len(row))]
        tab[i, :need] = row
    k = rng.standard_normal((n_pool, kh, kvp * ps, hsz)).astype(np.float32)
    v = rng.standard_normal((n_pool, kh, kvp * ps, hsz)).astype(np.float32)
    q = rng.standard_normal((b, qh, hsz)).astype(np.float32)
    gnp = np.array([shared.get(g, 0) if list(gid).count(g) > 1 else 0
                    for g in gid], np.int32)
    t = {"q": torch.from_numpy(q), "tl": torch.from_numpy(np.asarray(
        tl, np.int32)), "tab": torch.from_numpy(tab),
         "groups": (torch.tensor(gid, dtype=torch.int32),
                    torch.from_numpy(gnp))}
    if quant:
        kv = quantize_decode_state({"kcache": torch.from_numpy(k),
                                    "vcache": torch.from_numpy(v)})
        t["kv"] = [kv["kcache"], kv["vcache"]]
        t["scales"] = dict(kscale=kv["kscale"], vscale=kv["vscale"])
    else:
        t["kv"] = [torch.from_numpy(k), torch.from_numpy(v)]
        t["scales"] = {}
    return t


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_prefix_pass_plain_matches_reference_kernel(quant):
    """``prefix_case_contract``'s case (group 0: two members sharing two
    pages, group 1 memberless) at page = tile = 32 slots, where the port's
    split and the reference's shared span coincide: the raw (acc, m, l) of
    the plain prefix pass against the interpreted ``prefix_pass_kernel``."""
    c = prefix_case_contract(g=2, gm=2, kh=2, hsz=32, qp=4, rr_block=16,
                             block_s=32, n_blocks=4, quant=quant)
    meta, gnp, gtl, gtab = c.prefetch
    rng = np.random.default_rng(13)
    n_pool = c.n_pool
    kf = rng.standard_normal((n_pool, 2, 32, 32)).astype(np.float32)
    vf = rng.standard_normal((n_pool, 2, 32, 32)).astype(np.float32)
    qs = rng.standard_normal((2, 2, 2 * 4, 32)).astype(np.float32)
    ops = {"kcache": torch.from_numpy(kf), "vcache": torch.from_numpy(vf)}
    if quant:
        ops = quantize_decode_state(ops)
    jops = [ops[k].numpy() for k in ("kcache", "vcache")]
    jsc = ({"kscale": ops["kscale"].numpy(), "vscale": ops["vscale"].numpy()}
           if quant else {})
    jacc, jm, jl = prefix_pass_kernel(
        qs, *jops, meta, gnp, gtl, gtab, scale=32 ** -0.5, kvp=1,
        rr_block=16, block_s=32, s_true=4 * 32, interpret=True, **jsc)
    # the port's operands: batch rows 0, 1 = group 0's members (table of
    # group row 0), row 2 = the memberless group row
    q = torch.from_numpy(np.stack([qs[0, :, :4], qs[0, :, 4:],
                                   qs[1, :, :4]]).reshape(3, 8, 32))
    tab = torch.from_numpy(np.stack([gtab[0], gtab[0], gtab[1]]))
    tl = torch.tensor([gtl[0, 0], gtl[0, 1], 0], dtype=torch.int32)
    sc = ({"kscale": ops["kscale"], "vscale": ops["vscale"]} if quant
          else {})
    acc, m, l = prefix_pass(
        q, ops["kcache"], ops["vcache"], tl, tab,
        torch.tensor([0, 0, 2], dtype=torch.int32),
        torch.tensor([2, 2, 0], dtype=torch.int32), kvp=1, n_ranks=1,
        rank=0, rr_block=16, window=0, scale=32 ** -0.5, **sc)
    jacc = np.asarray(jacc).reshape(2, 2, 2, 4, 32)     # [G, Kh, Gm, Qp, d]
    for mi in range(2):
        np.testing.assert_allclose(acc[0, mi].numpy(), jacc[0, :, mi],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            m[0, mi].numpy(), np.asarray(jm).reshape(2, 2, 2, 4)[0, :, mi],
            atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(
            l[0, mi].numpy(), np.asarray(jl).reshape(2, 2, 2, 4)[0, :, mi],
            atol=ATOL, rtol=RTOL)
    # the memberless row keeps the cold state, as the reference's group 1
    assert float(l[0, 2].abs().max()) == float(np.abs(jl[1]).max()) == 0.0


GROUP_CASES = {
    # three requests share 5 pages of 16 slots: the split (64) falls
    # inside the tile of slots 64..95
    "mid-tile": dict(tl=(100, 90, 50, 120), gid=(0, 0, 2, 0),
                     shared={0: 5}),
    # one group holds the whole batch, split on a tile boundary
    "whole-batch": dict(tl=(130, 70, 99, 140), gid=(0, 0, 0, 0),
                        shared={0: 4}),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_grouped_decode_matches_reference_and_equals_ungrouped(case, quant):
    """The plain grouped decode (prefix pass, then each row resumed above
    its split) against the reference's interpreted ``flash_decode(groups=
    ...)`` per rank (2e-5), and bit for bit the port's ungrouped paged
    decode and its fixed-layout decode of the same cache: kvp 1 and 2,
    windows 0 and 40."""
    spec = GROUP_CASES[case]
    for kvp in (1, 2):
        tl = [x * kvp for x in spec["tl"]]
        t = _groups_case(np.random.default_rng(14 + kvp), b=4, qh=4, kh=2,
                         hsz=32, ps=RR, kvp=kvp, tl=tl, gid=spec["gid"],
                         shared=spec["shared"], mp=10, quant=quant)
        for window in (0, 40):
            kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                      window=window, block_tables=t["tab"], **t["scales"])
            grp = flash_decode_shards(t["q"], *t["kv"], t["tl"],
                                      groups=t["groups"], **kw)
            flat = flash_decode_shards(t["q"], *t["kv"], t["tl"], **kw)
            assert all(torch.equal(a, b) for a, b in zip(grp, flat))
            fixed = _fixed_of(t, kvp)
            kwf = dict(kw, block_tables=None, **fixed[2])
            assert all(torch.equal(a, b) for a, b in zip(
                grp, flash_decode_shards(t["q"], *fixed[:2], t["tl"],
                                         **kwf)))
            for r in range(kvp):
                sl = slice(r * RR, (r + 1) * RR)
                jsc = {k: v[:, :, sl].numpy() for k, v in t["scales"].items()}
                jo, jl = jax_flash_decode(
                    t["q"].numpy(), *(x[:, :, sl].numpy() for x in t["kv"]),
                    t["tl"].numpy(), r, kvp=kvp, rr_block=RR, window=window,
                    block_tables=t["tab"].numpy(),
                    groups=tuple(g.numpy() for g in t["groups"]),
                    interpret=True, **jsc)
                np.testing.assert_allclose(grp[0][r].numpy(), np.asarray(jo),
                                           atol=ATOL, rtol=RTOL)
                np.testing.assert_allclose(grp[1][r].numpy(), np.asarray(jl),
                                           atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shared", [17, 20], ids=["split-on-chunk",
                                                  "split-in-chunk"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_grouped_equals_ungrouped_across_chunks(shared, quant):
    """Shards of three chunks (704 slots per rank): three requests share 17
    pages (split tile 8, a chunk boundary) or 20 (split tile 10, inside the
    second chunk), with local lengths ending on a chunk boundary (512), one
    slot past it (the appended row lands in a chunk's first slot) and
    mid-chunk.  Grouped == ungrouped and pruned == dense bit for bit, in
    outputs, LSEs and appended pages, kvp 1 (no window) and 2 (a window of
    300); the
    public prefix pass is its chunk partials folded; kvp 1, window 0
    against the reference's interpreted grouped decode (2e-5)."""
    for kvp in (1, 2):
        tl = [512 * kvp, 512 * kvp + 1, 300 * kvp, 700 * kvp]
        t = _groups_case(np.random.default_rng(40 + kvp), b=4, qh=4, kh=2,
                         hsz=32, ps=RR, kvp=kvp, tl=tl, gid=(0, 0, 2, 0),
                         shared={0: shared}, mp=44, quant=quant)
        rng = np.random.default_rng(50 + kvp)
        kn = torch.from_numpy(rng.standard_normal((4, 2, 32)).astype(
            np.float32))
        for window in ((0,) if kvp == 1 else (300,)):
            kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                      window=window, block_tables=t["tab"])

            def run(**extra):
                kv = [x.clone() for x in t["kv"]]
                sc = {k: v.clone() for k, v in t["scales"].items()}
                o = flash_decode_shards(t["q"], *kv, t["tl"], k_new=kn,
                                        v_new=kn, **sc, **kw, **extra)
                return o, kv + list(sc.values())

            (og, lg), pg = run(groups=t["groups"])
            (of, lf), pf = run()
            (od, ld), pd = run(groups=t["groups"], prune=False)
            assert torch.equal(og, of) and torch.equal(lg, lf)
            assert torch.equal(og, od) and torch.equal(lg, ld)
            assert all(torch.equal(a, b) and torch.equal(a, d)
                       for a, b, d in zip(pg, pf, pd))
        sc = t["scales"]
        kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR, **sc)
        chunks = prefix_pass(t["q"], *t["kv"], t["tl"], t["tab"],
                             *t["groups"], chunks=True, **kw)
        folded = prefix_pass(t["q"], *t["kv"], t["tl"], t["tab"],
                             *t["groups"], **kw)
        r, b, kh, c, g, hsz = chunks[0].shape
        assert c == 3
        want = merge_chunks((chunks[0].reshape(r * b * kh, c, g, hsz),
                             *(x.reshape(r * b * kh, c, g)
                               for x in chunks[1:])))
        assert all(torch.equal(x.reshape(y.shape), y)
                   for x, y in zip(folded, want))
        resumed = flash_decode_shards(t["q"], *t["kv"], t["tl"],
                                      block_tables=t["tab"],
                                      groups=t["groups"],
                                      prefix_state=chunks, **kw)
        grouped = flash_decode_shards(t["q"], *t["kv"], t["tl"],
                                      block_tables=t["tab"],
                                      groups=t["groups"], **kw)
        assert all(torch.equal(x, y) for x, y in zip(resumed, grouped))
        if kvp == 1:
            jsc = {k: v.numpy() for k, v in sc.items()}
            jo, jl = jax_flash_decode(
                t["q"].numpy(), *(x.numpy() for x in t["kv"]),
                t["tl"].numpy(), 0, kvp=1, rr_block=RR,
                block_tables=t["tab"].numpy(),
                groups=tuple(x.numpy() for x in t["groups"]),
                interpret=True, **jsc)
            np.testing.assert_allclose(grouped[0][0].numpy(), np.asarray(jo),
                                       atol=ATOL, rtol=RTOL)
            np.testing.assert_allclose(grouped[1][0].numpy(), np.asarray(jl),
                                       atol=ATOL, rtol=RTOL)


def _fixed_of(t, kvp):
    """The fixed-layout caches (and scales) holding the paged case's rows:
    each request's pages gathered into one [Kh, kvp * s_loc] row, shard r
    at ``[r * s_loc, (r + 1) * s_loc)``."""
    dense = [_dense_shards(x, t["tab"], kvp) for x in t["kv"]]
    sc = {k: _dense_shards(v, t["tab"], kvp) for k, v in t["scales"].items()}
    return dense[0], dense[1], sc


# ----------------------------------------------------------------- serve
def test_serve_demo_prefix_share_grouped_matches_reference(granite):
    """6 prompts of 64 tokens, the first 40 shared, budgets 4-20 (staggered
    retirements), max_batch 3, chunks of 8: the same streams as the
    reference with prefix sharing and grouped decode, the same
    ``prefix_hit_rate`` and ``pages_shared_peak``; unshared, no hit and no
    shared page."""
    _, model = granite
    rows = generate_trace(6, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(64, 64), max_tokens=(4, 20)),),
        prompt_len=64, max_tokens=(4, 20), seed=0)
    kw = dict(paged_kv=True, chunk_tokens=8, shared_prefix_len=40)
    jfin, jsum = jax_serve_demo(
        "granite-3-2b", reduced=True, n_requests=6, prompt_len=64,
        max_new=(4, 20), max_batch=3, trace=rows, log=lambda *a: None,
        prefix_share=True, grouped_decode=True,
        hx=JaxHelixConfig(kvp_axes=("data",), tpa_axis=None), **kw)
    mine = dict(reduced=True, n_requests=6, prompt_len=64, max_new=(4, 20),
                max_batch=3, device="cpu", model=model, log=lambda *a: None,
                **kw)
    fin, summ = serve_demo(prefix_share=True, grouped_decode=True, **mine)
    assert {r.rid: r.prompt for r in fin} == {r.rid: r.prompt for r in jfin}
    streams = {r.rid: r.out_tokens for r in fin}
    assert streams == {r.rid: r.out_tokens for r in jfin}
    assert summ["prefix_hit_rate"] == jsum["prefix_hit_rate"] == 0.5
    assert summ["pages_shared_peak"] == jsum["pages_shared_peak"] == 3
    assert summ["grouped_steps"] > 0
    plain, psum = serve_demo(**mine)
    assert {r.rid: r.out_tokens for r in plain} == streams
    assert psum["prefix_hit_rate"] == 0 and psum["pages_shared_peak"] == 0


def _engine_run(cfg, model, hx, prompts, budgets, *, prefix_share):
    """Serve ``prompts`` through an engine whose decode step records each
    decoding request's logits row and each step's ``group_np``; returns
    (logits by rid, group_np per step, engine)."""
    logits: dict[int, list] = {}
    gnps: list[list[int]] = []
    inner = build_serve_step(cfg, hx, return_logits=True)
    holder = {}

    def step(model_, state, tokens):
        (nxt, lg), state = inner(model_, state, tokens)
        for i, r in enumerate(holder["engine"].slots):
            if r is not None and r.state == DECODE:
                logits.setdefault(r.rid, []).append(lg[i].clone())
        if "group_np" in state:
            gnps.append(state["group_np"].tolist())
        return nxt, state

    eng = DecodeEngine(cfg, model, step, make_prefill_step(cfg, hx),
                       max_batch=3, max_seq=100, hx=hx, dtype=torch.float32,
                       device="cpu", chunk_tokens=8,
                       chunk_prefill_step=make_chunk_prefill_step(cfg, hx),
                       prefix_share=prefix_share)
    holder["engine"] = eng
    for rid, (p, n) in enumerate(zip(prompts, budgets)):
        eng.submit(Request(rid=rid, prompt=p, max_new_tokens=n))
    while eng.pending():
        eng.step()
    eng.pool.check_invariants()
    assert eng.pool.used_count == 0
    return {r: torch.stack(v) for r, v in logits.items()}, gnps, eng


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_shared_and_grouped_serving_equal_unshared_bit_for_bit(granite,
                                                               kv_bits):
    """The probe workload plus a request whose prompt IS the first
    registered prompt (its last page is shared, then copied on write at
    admission): unshared, shared and shared + grouped runs give the same
    logits at every decode step of every request, bit for bit; groups form
    mid-run and have dissolved when the last request decodes alone.

    The repeated prompt matches all but its last token, so sharing leaves
    it a one-token suffix chunk: on the CPU that single-row matmul takes
    another reduction path (``test_torch_chunked.py``), so against the
    unshared run its logits are held at the tolerance; grouped == shared
    stays bit for bit for it too."""
    cfg, model = granite
    rows = generate_rows(6, prompt_len=64, max_tokens=(4, 20), seed=0)
    shared = np.random.default_rng(0).integers(0, cfg.vocab, 40).tolist()
    prompts = [prompt_tokens(r, cfg.vocab, shared) for r in rows]
    prompts.append(list(prompts[0]))
    budgets = [r.max_tokens for r in rows] + [20]
    runs = {}
    for name, grouped, share in (("unshared", False, False),
                                 ("shared", False, True),
                                 ("grouped", True, True)):
        hx = HelixConfig(kv_cache_bits=kv_bits, paged_kv=True,
                         grouped_decode=grouped)
        runs[name] = _engine_run(cfg, model, hx, prompts, budgets,
                                 prefix_share=share)
    base, shared_run = runs["unshared"][0], runs["shared"][0]
    assert sorted(shared_run) == sorted(base) == list(range(7))
    for rid in base:
        assert torch.equal(runs["grouped"][0][rid], shared_run[rid]), rid
        if rid == 6:
            torch.testing.assert_close(shared_run[rid], base[rid],
                                       atol=1e-4, rtol=1e-4)
        else:
            assert torch.equal(shared_run[rid], base[rid]), rid
    eng = runs["grouped"][2]
    assert eng.pool.pages_shared_peak > 0 and eng.grouped_steps > 0
    assert eng._prefix_hits >= 2
    gnps = runs["grouped"][1]
    assert not any(gnps[0]) and any(any(g) for g in gnps)
    assert not any(gnps[-1])


def test_cow_guard_copies_a_shared_append_page(granite):
    """A slot whose append page is shared gets a fresh copy of it before
    the step writes there, its table row follows, the other holder keeps
    the original page."""
    cfg, model = granite
    hx = HelixConfig(paged_kv=True)
    eng = DecodeEngine(cfg, model, build_serve_step(cfg, hx),
                       make_prefill_step(cfg, hx), max_batch=2, max_seq=64,
                       hx=hx, dtype=torch.float32, device="cpu",
                       chunk_tokens=8,
                       chunk_prefill_step=make_chunk_prefill_step(cfg, hx),
                       prefix_share=True)
    prompt = np.random.default_rng(15).integers(0, cfg.vocab, 20).tolist()
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8))
    while eng.slots[0] is None or eng.slots[0].state != DECODE:
        eng.step()
    # a second holder of slot 0's pages, decoding at the same length
    eng.pool.share(1, eng.pool.pages(0))
    eng.slots[1] = Request(rid=1, prompt=prompt, max_new_tokens=8)
    eng.slots[1].state = DECODE
    eng.sched.slot_rids[1], eng.sched.slot_len[1] = 1, eng.sched.slot_len[0]
    li = eng.sched.slot_len[0] // eng.block_s
    old = eng.pool.pages(0)[li]
    eng._cow_guard([0])
    new = eng.pool.pages(0)[li]
    assert new != old and eng.pool.pages(1)[li] == old
    assert eng.pool.refcount(old) == 1 and eng.pool.refcount(new) == 1
    assert int(eng.state["block_tables"][0, li]) == new
    assert torch.equal(eng.state["kcache"][:, new], eng.state["kcache"][:, old])
    eng.pool.check_invariants()
