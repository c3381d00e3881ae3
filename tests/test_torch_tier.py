"""The host KV tier of the port against the JAX package on the CPU: the fault
plan's parsing and draws, the host page store on seeded operation streams,
the pool-page gather and scatter, and the engine's preempt -> spill ->
restore on reduced granite-3-2b (f32, weights carried over with
``params_from_jax``), fp and int8, under every injected fault.

The reference engine is built with ``HelixConfig(kvp_axes=("data",))`` on a
(1, 1) mesh (its own tier tests use ``kvp_axes=()``, which fails under JAX
0.9.0), paged, chunks of 4, two requests of 14 and 9 tokens, 5 new, the
first preempted once it has 2 tokens.  Its jitted steps are built once per
mode and shared by every engine of the module.  Streams and counters must
be equal; spilled pages agree with the reference's at f32 rounding (int8
payloads within one step of the quantizer), and inside the port a restore
gives back the spilled bytes exactly.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import kvcache as jax_kvcache
from repro.core.sharding import HelixConfig as JaxHelixConfig
from repro.models.model_zoo import build_serve_step as jax_build_serve_step
from repro.models.model_zoo import (
    make_chunk_prefill_step as jax_make_chunk_prefill_step)
from repro.models.model_zoo import make_prefill_step as jax_make_prefill_step
from repro.models.transformer import init_params as jax_init_params
from repro.serving import DecodeEngine as JaxDecodeEngine
from repro.serving import Request as JaxRequest
from repro.serving.faults import FaultPlan as JaxFaultPlan
from repro.serving.tier import HostPageStore as JaxHostPageStore
from repro.utils import make_mesh, set_mesh

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.kvcache import gather_pool_pages, scatter_pool_pages
from repro_torch.core.sharding import HelixConfig
from repro_torch.models.model_zoo import (build_serve_step,
                                          make_chunk_prefill_step,
                                          make_prefill_step)
from repro_torch.serving import DecodeEngine, Request
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.scheduler import RESTORING
from repro_torch.serving.tier import HostPageStore

ATOL = RTOL = 2e-5       # f32 K/V of two reduced layers, port vs reference
CHUNK, LENGTHS, MAX_NEW, PREEMPT_AFTER = 4, (14, 9), 5, 2


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# ------------------------------------------------------------ fault plan
SPECS = ("", "seed=3", "seed=1,restore_fail=0.5,delay=1.0,delay_steps=4",
         "seed=9, corrupt=0.25 ,store_full=0.75")


@pytest.mark.parametrize("spec", SPECS)
def test_fault_plan_parse_matches_reference(spec):
    import dataclasses
    assert (dataclasses.asdict(FaultPlan.parse(spec))
            == dataclasses.asdict(JaxFaultPlan.parse(spec)))


@pytest.mark.parametrize("bad", ["restore_fail=1.5", "delay_steps=-1",
                                 "nope=1", "seed"])
def test_fault_plan_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        JaxFaultPlan.parse(bad)
    with pytest.raises(ValueError):
        FaultPlan.parse(bad)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_fault_draws_match_reference(seed):
    kw = dict(seed=seed, restore_fail=0.5, corrupt=0.3, store_full=0.2,
              delay=0.7)
    ours, ref = FaultPlan(**kw).injector(), JaxFaultPlan(**kw).injector()
    kinds = ("store_full", "corrupt", "restore_fail", "delay")
    rng = np.random.default_rng(seed)
    for _ in range(200):
        if rng.random() < 0.2:
            n = int(rng.integers(0, 50))
            assert ours.pick(n) == ref.pick(n)
        else:
            kind = kinds[int(rng.integers(0, 4))]
            assert ours.draw(kind) == ref.draw(kind)
    assert ours.injected == ref.injected and ours.active


# ------------------------------------------------------------ host store
def _planes(kid: int, n: int) -> dict:
    rng = np.random.default_rng(kid)
    return {"k": rng.normal(size=(2, n, 3, 4)).astype(np.float32),
            "v": rng.normal(size=(2, n, 3, 4)).astype(np.float32),
            "s": rng.integers(-128, 128, (2, n, 3), dtype=np.int8)}


def _stream(seed: int, length: int = 60):
    rng = np.random.default_rng(seed)
    kinds = ("put", "put", "restore", "fetch", "drop")
    return [(kinds[int(rng.integers(0, 5))], int(rng.integers(0, 6)),
             int(rng.integers(1, 10))) for _ in range(length)]


def _drive(store, ops):
    """Every operation's result, the store's stats after it and the bytes
    it handed back."""
    out = []
    for kind, kid, n in ops:
        key = f"r{kid}"
        if kind == "put":
            res = store.put(key, _planes(kid, n), tokens=range(n))
        elif kind == "drop":
            res = store.drop(key)
        elif kind == "restore":
            planes, delay, why = store.restore(key)
            res = (None if planes is None
                   else {k: v.tobytes() for k, v in planes.items()},
                   delay, why)
        else:
            planes = store.fetch(key)
            res = (None if planes is None
                   else {k: v.tobytes() for k, v in planes.items()})
        store.check_invariants()
        out.append((kind, key, res, store.stats(), list(store._entries),
                    store.tokens(key)))
    return out


STORE_PLANS = {"none": {}, "corrupt": dict(seed=5, corrupt=0.5),
               "mixed": dict(seed=11, restore_fail=0.3, corrupt=0.3,
                             store_full=0.2, delay=0.5, delay_steps=3)}


@pytest.mark.parametrize("capacity", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("plan", list(STORE_PLANS))
def test_host_store_streams_match_reference(capacity, plan):
    """Seeded streams of put / drop / restore / fetch over six keys (1-9
    pages, so some entries are larger than the store) give the
    reference's results, stats, LRU order and bytes, faults included."""
    for seed in range(3):
        ops = _stream(1000 * capacity + seed)
        ours = HostPageStore(capacity, faults=FaultPlan(**STORE_PLANS[plan]))
        ref = JaxHostPageStore(capacity,
                               faults=JaxFaultPlan(**STORE_PLANS[plan]))
        assert _drive(ours, ops) == _drive(ref, ops)


def test_host_store_put_drops_the_old_entry_before_refusing():
    """The reference's order in ``put``: the key's old entry goes, then the
    oversize entry is refused (capacity 2, one page, then three pages)."""
    ops = [("put", 0, 1), ("put", 0, 3), ("restore", 0, 0)]
    ours, ref = HostPageStore(2), JaxHostPageStore(2)
    got, want = _drive(ours, ops), _drive(ref, ops)
    assert got == want
    assert got[1][2] is False and got[1][3]["host_entries"] == 0
    assert got[1][3]["store_full"] == 1 and got[2][2][2] == "missing"


# ------------------------------------------------------ pool page moves
@pytest.mark.parametrize("kv8", [False, True])
def test_gather_scatter_pool_pages_match_reference(kv8):
    rng = np.random.default_rng(4)
    shape = (2, 9, 2, 16, 8)
    st = {"kcache": rng.normal(size=shape).astype(np.float32),
          "vcache": rng.normal(size=shape).astype(np.float32),
          "block_tables": np.zeros((2, 4), np.int32)}
    if kv8:
        for k in ("kcache", "vcache"):
            st[k] = rng.integers(-127, 128, shape, dtype=np.int8)
        for k in ("kscale", "vscale"):
            st[k] = rng.random(shape[:-1]).astype(np.float32)
    phys = [5, 2, 7]
    ours = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    ptrs = {k: v.data_ptr() for k, v in ours.items()}
    got = gather_pool_pages(ours, phys)
    want = jax_kvcache.gather_pool_pages(
        {k: jnp.asarray(v) for k, v in st.items()}, phys)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == ours[k].dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    new = {k: np.flip(np.asarray(v), 1).copy() for k, v in want.items()}
    out = scatter_pool_pages(ours, [3, 8, 1],
                             {k: torch.from_numpy(v) for k, v in new.items()})
    ref = jax_kvcache.scatter_pool_pages(
        {k: jnp.asarray(v) for k, v in st.items()}, [3, 8, 1], new)
    assert out is ours
    for k in ours:
        assert ours[k].data_ptr() == ptrs[k], k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(ref[k]))


# ---------------------------------------------------------------- engine
MESH = make_mesh((1, 1), ("data", "model"))


@functools.lru_cache(maxsize=None)
def _granite():
    jcfg = jax_get_config("granite-3-2b").reduced()
    cfg = get_config("granite-3-2b").reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, params_from_jax(
        jax.tree.map(np.asarray, jparams), cfg)


@functools.lru_cache(maxsize=None)
def _jax_steps(kv8):
    jcfg = _granite()[0]
    hx = JaxHelixConfig(kvp_axes=("data",), tpa_axis=None, paged_kv=True,
                        kv_cache_bits=8 if kv8 else 16)
    with set_mesh(MESH):
        return hx, (jax_build_serve_step(jcfg, MESH, hx),
                    jax_make_prefill_step(jcfg, MESH, hx),
                    jax_make_chunk_prefill_step(jcfg, MESH, hx))


def _engine(side, kv8, **kw):
    jcfg, cfg, jparams, model = _granite()
    if side == "jax":
        hx, (serve, prefill, chunk) = _jax_steps(kv8)
        return JaxDecodeEngine(jcfg, jparams, serve, prefill, max_batch=2,
                               max_seq=64, hx=hx, chunk_tokens=CHUNK,
                               chunk_prefill_step=chunk, tp_width=1, **kw)
    hx = HelixConfig(paged_kv=True, kv_cache_bits=8 if kv8 else 16)
    return DecodeEngine(cfg, model, build_serve_step(cfg, hx),
                        make_prefill_step(cfg, hx), max_batch=2, max_seq=64,
                        hx=hx, dtype=torch.float32, device="cpu",
                        chunk_tokens=CHUNK,
                        chunk_prefill_step=make_chunk_prefill_step(cfg, hx),
                        **kw)


def _run(side, kv8, *, preempt=True, max_new=MAX_NEW, **kw):
    """Two requests, the first preempted once it has ``PREEMPT_AFTER``
    tokens.  Returns (streams, summary, engine, the spilled planes, the
    prefill steps of the preempted request after the preemption, the
    other request's tokens per step while a restore was held)."""
    eng = _engine(side, kv8, **kw)
    Req = JaxRequest if side == "jax" else Request
    rng = np.random.default_rng(7)
    reqs = [Req(rid=i, prompt=rng.integers(0, 512, n).tolist(),
                max_new_tokens=max_new) for i, n in enumerate(LENGTHS)]
    spilled, post_prefills, held = None, 0, []
    with set_mesh(MESH):
        for r in reqs:
            eng.submit(r)
        for _ in range(200):
            if all(r.done for r in reqs):
                break
            eng.step()
            if eng._restores:
                held.append(len(reqs[1].out_tokens))
            if (preempt and spilled is None
                    and len(reqs[0].out_tokens) >= PREEMPT_AFTER
                    and reqs[0].state == "decode"):
                eng.preempt(0)
                entry = (eng.store._entries.get("spill:0")
                         if eng.store is not None else None)
                spilled = ({} if entry is None else
                           {k: np.array(v) for k, v in entry.planes.items()})
            elif spilled is not None:
                post_prefills += reqs[0].state == "prefill"
    assert all(r.done for r in reqs)
    assert eng.pool.free_count == eng.pool.capacity
    if eng.store is not None:
        eng.store.check_invariants()
    eng.sched.check_invariants()
    return ([list(r.out_tokens) for r in reqs], eng.metrics.summary(), eng,
            spilled, post_prefills, held)


FAULTS = {"none": None, "restore_fail": dict(seed=1, restore_fail=1.0),
          "corrupt": dict(seed=2, corrupt=1.0),
          "store_full": dict(seed=3, store_full=1.0),
          "delay": dict(seed=4, delay=1.0, delay_steps=3)}
COUNTERS = ("preempts", "preempt_spills", "preempt_drops", "spills",
            "restores", "restores_failed", "checksum_mismatches",
            "store_evictions", "resume_reprefill_chunks", "n_tokens",
            "finish_reasons")


@functools.lru_cache(maxsize=None)
def _jax_run(kv8, fault, preempt=True):
    plan = FAULTS[fault]
    return _run("jax", kv8, preempt=preempt,
                **(dict(host_pages=32, fault_plan=JaxFaultPlan(**plan)
                        if plan else None) if preempt else {}))


@pytest.mark.parametrize("kv8,fault", [(False, f) for f in FAULTS]
                         + [(True, "none"), (True, "corrupt")])
def test_preempt_spill_restore_matches_reference(kv8, fault):
    """Equal streams and counters; the never-preempted stream; no prefill
    after a good restore and a counted re-prefill after every fault; the
    spilled pages at the reference's values."""
    plan = FAULTS[fault]
    streams, summ, eng, spilled, pf, _ = _run(
        "port", kv8, host_pages=32,
        fault_plan=FaultPlan(**plan) if plan else None)
    jstreams, jsumm, jeng, jspilled, jpf, _ = _jax_run(kv8, fault)
    base = _jax_run(kv8, "none", preempt=False)[0]
    assert streams == jstreams == base
    assert {k: summ[k] for k in COUNTERS} == {k: jsumm[k] for k in COUNTERS}
    assert eng.tier_stats() == jeng.tier_stats()
    assert pf == jpf
    assert summ["preempts"] == 1
    if fault in ("none", "delay"):
        assert summ["restores"] == 1 and pf == 0
        assert summ["resume_reprefill_chunks"] == 0
    else:
        assert summ["resume_reprefill_chunks"] > 0 and pf > 0
    assert set(spilled) == set(jspilled)
    for k, v in jspilled.items():
        if k in ("kcache", "vcache") and kv8:
            assert np.abs(spilled[k].astype(int) - v.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(spilled[k], v, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kv8", [False, True])
def test_restore_gives_back_the_spilled_bytes(kv8):
    """Inside the port: the pages a restore scatters hold the spilled bytes
    exactly (int8 payloads and scale planes too), in new physical pages,
    and the planes never move."""
    eng = _engine("port", kv8, host_pages=32)
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, n).tolist(),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(LENGTHS)]
    for r in reqs:
        eng.submit(r)
    ptrs = {k: v.data_ptr() for k, v in eng.state.items()}
    while not (len(reqs[0].out_tokens) >= PREEMPT_AFTER
               and reqs[0].state == "decode"):
        eng.step()
    before = list(eng.pool.pages(0))
    eng.preempt(0)
    planes = {k: v.copy() for k, v in eng.store._entries["spill:0"]
              .planes.items()}
    committed = reqs[0].spill_len
    while reqs[0].forced_tokens is None:
        eng.step()
    n = next(iter(planes.values())).shape[1]
    after = eng.pool.pages(0)[:n]
    back = gather_pool_pages(eng.state, after)
    assert set(back) == set(planes)
    # the committed rows: whole pages, then the head of the last one (the
    # decode step of the restoring engine step has appended past them)
    full, rem = divmod(committed, eng.block_s)
    for k, v in planes.items():
        got = back[k].numpy()
        assert got[:, :full].tobytes() == v[:, :full].tobytes(), k
        assert (got[:, full, :, :rem].tobytes()
                == v[:, full, :, :rem].tobytes()), k
    large = [k for k in ptrs if k != "total_len"]     # the graph's leaves
    assert {k: eng.state[k].data_ptr() for k in large} == {
        k: ptrs[k] for k in large}
    assert before != eng.pool.pages(0)
    eng.run_to_completion()
    assert [r.out_tokens for r in reqs] == _jax_run(kv8, "none",
                                                    preempt=False)[0]


def test_delayed_restore_holds_only_its_own_slot():
    """Under ``delay`` the restoring slot waits its steps in RESTORING while
    the other request goes on decoding; then the stream is the
    never-preempted one with no prefill chunk."""
    kw = dict(host_pages=32, max_new=8)
    streams, summ, eng, _, pf, held = _run(
        "port", False, fault_plan=FaultPlan(seed=4, delay=1.0,
                                            delay_steps=4), **kw)
    assert len(held) >= 3                     # the delay really held
    assert held[-1] > held[0]                 # request 1 kept decoding
    base, _, _, _, _, _ = _run("port", False, preempt=False, max_new=8)
    assert streams == base
    assert summ["resume_reprefill_chunks"] == 0 and pf == 0
    assert summ["restore_s"]["n"] == 1


def test_preempt_mid_restore_retries_the_entry():
    """A preemption while the restore is held cancels it; the entry stays
    and the next admission restores it."""
    eng = _engine("port", False, host_pages=32,
                  fault_plan=FaultPlan(seed=4, delay=1.0, delay_steps=3))
    rng = np.random.default_rng(7)
    reqs = [Request(rid=i, prompt=rng.integers(0, 512, n).tolist(),
                    max_new_tokens=MAX_NEW) for i, n in enumerate(LENGTHS)]
    for r in reqs:
        eng.submit(r)
    while not (len(reqs[0].out_tokens) >= PREEMPT_AFTER
               and reqs[0].state == "decode"):
        eng.step()
    eng.preempt(0)
    while reqs[0].state != RESTORING:
        eng.step()
    assert eng.preempt(0) and eng.store.has("spill:0")
    eng.run_to_completion()
    s = eng.metrics.summary()
    assert s["preempts"] == 2 and s["restores"] == 1
    assert s["resume_reprefill_chunks"] == 0
    assert [r.out_tokens for r in reqs] == _jax_run(False, "none",
                                                    preempt=False)[0]


def test_session_turn_restores_history_like_the_reference():
    """Turn 2 of a session restores turn 1's pages and teacher-forces the
    fresh tokens: the reference's stream and counters, and no prefill."""
    rng = np.random.default_rng(3)
    turn1 = rng.integers(0, 512, 13).tolist()
    fresh = rng.integers(0, 512, 6).tolist()
    out = {}
    for side in ("jax", "port"):
        eng = _engine(side, False, session_kv=True)
        Req = JaxRequest if side == "jax" else Request
        r1 = Req(rid=0, prompt=list(turn1), max_new_tokens=4,
                 session_id="s0")
        with set_mesh(MESH):
            eng.submit(r1)
            eng.run_to_completion()
            r2 = Req(rid=1, prompt=list(turn1) + r1.out_tokens + fresh,
                     max_new_tokens=4, session_id="s0")
            eng.submit(r2)
            prefills = 0
            while not r2.done:
                eng.step()
                prefills += r2.state == "prefill"
        s = eng.metrics.summary()
        out[side] = (r1.out_tokens, r2.out_tokens, prefills,
                     {k: s[k] for k in COUNTERS}, eng.tier_stats())
    assert out["port"] == out["jax"]
    assert out["port"][2] == 0 and out["port"][3]["restores"] == 1


@pytest.mark.parametrize("host_pages", [0, 32])
def test_prefix_blobs_go_to_the_store_only_with_a_host_tier(host_pages):
    """Prefix sharing with and without a host tier: the reference's streams
    and prefix hits either way.  With ``host_pages`` the prefix index keeps
    its K/V blobs in the store under ``prefix:<seq>`` keys and
    ``tier_stats`` equal the reference's.  Without it the port builds no
    store and its ``tier_stats`` are zeros, where the reference builds a
    store for ``prefix_share`` alone and counts its saves."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, 512, 12).tolist()
    prompts = [head + rng.integers(0, 512, n).tolist() for n in (6, 3, 5)]
    out = {}
    for side in ("jax", "port"):
        eng = _engine(side, False, prefix_share=True, host_pages=host_pages)
        Req = JaxRequest if side == "jax" else Request
        reqs = [Req(rid=i, prompt=list(p), max_new_tokens=4)
                for i, p in enumerate(prompts)]
        with set_mesh(MESH):
            eng.submit(reqs[0])
            eng.run_to_completion()
            for r in reqs[1:]:
                eng.submit(r)
            eng.run_to_completion()
        out[side] = ([r.out_tokens for r in reqs],
                     eng.pool_stats()["prefix_hit_rate"], eng.tier_stats(),
                     eng.store)
    assert out["port"][:2] == out["jax"][:2]
    assert out["port"][1] > 0
    store = out["port"][3]
    if host_pages:
        assert out["port"][2] == out["jax"][2]
        assert any(k.startswith("prefix:") for k in store._entries)
    else:
        assert store is None and not any(out["port"][2].values())
        assert out["jax"][2]["host_saves"] > 0


def test_host_tier_refusals():
    cfg = get_config("granite-3-2b").reduced()
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(cfg, None, None, None, max_batch=2, max_seq=32,
                     hx=HelixConfig(), device="cpu", host_pages=8)
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(cfg, None, None, None, max_batch=2, max_seq=32,
                     hx=HelixConfig(), device="cpu", session_kv=True)
    m2 = get_config("mamba2-780m").reduced()
    with pytest.raises(ValueError, match="paged"):
        DecodeEngine(m2, None, None, None, max_batch=2, max_seq=32,
                     hx=HelixConfig(), device="cpu", host_pages=8)
    hy = get_config("hymba-1.5b").reduced()
    with pytest.raises(ValueError, match="SSM"):
        DecodeEngine(hy, None, None, None, max_batch=2, max_seq=32,
                     hx=HelixConfig(paged_kv=True), device="cpu",
                     host_pages=8)


def test_add_request_matches_reference():
    """The immediate admission past the queue: a prompt that can never fit
    is taken and retired "rejected", one that fits is prefilled at once,
    a full engine refuses; the streams and finish reasons equal the
    reference's."""
    out = {}
    for side in ("jax", "port"):
        eng = _engine(side, False, host_pages=32)
        Req = JaxRequest if side == "jax" else Request
        rng = np.random.default_rng(9)
        reqs = [Req(rid=i, prompt=rng.integers(0, 512, n).tolist(),
                    max_new_tokens=4) for i, n in enumerate((11, 200, 7, 5))]
        with set_mesh(MESH):
            taken = [eng.add_request(r) for r in reqs]
            eng.run_to_completion()
        out[side] = (taken, [(r.out_tokens, r.finish_reason) for r in reqs])
    assert out["port"] == out["jax"]
    assert out["port"][0] == [True, True, True, False]
    assert out["port"][1][1][1] == "rejected"
