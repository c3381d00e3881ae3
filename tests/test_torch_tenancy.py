"""The multi-tenant front end of the port against the JAX package on the CPU:
trace workloads, the weighted-fair scheduler, the TTL governor and the
metrics under a ``VirtualClock``, and ``serve_demo`` with tenants, the
governor, the host tier and sessions on reduced granite-3-2b (f32, weights
carried over with ``params_from_jax``).

The reference's ``serve_demo`` runs with ``mesh=None`` (a (1, 1) mesh and
``kvp_axes=("data",)``), each configuration once per module.  Under the
``VirtualClock`` every latency is the cost model's, so the summaries must
be equal key for key and value for value (the port-only wall-clock keys of
``sync_stats`` aside), and so must the streams.
"""
import dataclasses
import functools
import json

import numpy as np
import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import serve_demo as jax_serve_demo
from repro.models.transformer import init_params as jax_init_params
from repro.serving import governor as jax_governor
from repro.serving import metrics as jax_metrics
from repro.serving import scheduler as jax_scheduler
from repro.serving import workload as jax_workload
from repro.serving.pool import BlockAllocator as JaxBlockAllocator

from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.serve import serve_demo
from repro_torch.serving import governor, metrics, scheduler, workload
from repro_torch.serving.pool import BlockAllocator

QUIET = dict(log=lambda *a: None)
TENANTS = "chat:2:interactive:0.5,bulk:1:batch:0.5"


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


# -------------------------------------------------------------- workload
TRACES = {
    "batch": dict(arrival="batch"),
    "poisson": dict(arrival="poisson", rate=0.7),
    "bursty": dict(arrival="bursty", rate=1.5, burst=3),
    "mix": dict(arrival="poisson", rate=2.0, tenants=TENANTS),
    "ranges": dict(arrival="bursty", rate=0.5, burst=2,
                   tenants="a:3:interactive,b:1:batch:2,c"),
}


def _trace(pkg, case, seed):
    kw = dict(TRACES[case])
    if "tenants" in kw:
        kw["tenants"] = pkg.parse_tenants(kw["tenants"])
        if case == "ranges":
            kw["tenants"] = tuple(
                dataclasses.replace(t, prompt_len=(3, 40), max_tokens=(1, 9))
                if t.name != "c" else t for t in kw["tenants"])
    return pkg.generate_trace(17, prompt_len=12, max_tokens=6, seed=seed,
                              **kw)


@pytest.mark.parametrize("case", list(TRACES))
def test_generate_trace_matches_reference(case, tmp_path):
    for seed in (0, 5):
        rows = _trace(workload, case, seed)
        want = _trace(jax_workload, case, seed)
        assert [r.to_json() for r in rows] == [r.to_json() for r in want]
        assert workload.trace_id(rows) == jax_workload.trace_id(want)
        assert ([workload.prompt_tokens(r, 512, (1, 2, 3)) for r in rows]
                == [jax_workload.prompt_tokens(r, 512, (1, 2, 3))
                    for r in want])
        # each package reads the other's file
        workload.save_trace(tmp_path / "ours.jsonl", rows, meta={"s": seed})
        jax_workload.save_trace(tmp_path / "ref.jsonl", want,
                                meta={"s": seed})
        assert ((tmp_path / "ours.jsonl").read_text()
                == (tmp_path / "ref.jsonl").read_text())
        back = workload.load_trace(tmp_path / "ref.jsonl")
        assert back == rows
        assert ([r.to_json() for r in
                 jax_workload.load_trace(tmp_path / "ours.jsonl")]
                == [r.to_json() for r in rows])


def test_arrivals_tenants_and_trace_refusals_match_reference(tmp_path):
    for n, rate, seed in ((9, 0.3, 1), (20, 4.0, 2)):
        assert (workload.poisson_arrival_steps(n, rate, seed)
                == jax_workload.poisson_arrival_steps(n, rate, seed))
        assert (workload.bursty_arrival_steps(n, rate, 3, seed)
                == jax_workload.bursty_arrival_steps(n, rate, 3, seed))
    for spec in (TENANTS, "a", "a:2,b::batch", "x:1.5:batch:0.2,y"):
        assert ([dataclasses.asdict(t) for t in workload.parse_tenants(spec)]
                == [dataclasses.asdict(t)
                    for t in jax_workload.parse_tenants(spec)])
    with pytest.raises(ValueError):
        workload.parse_tenants("a:1:gold")
    with pytest.raises(ValueError):
        workload.generate_trace(3, arrival="storm")
    path = tmp_path / "t.jsonl"
    path.write_text('{"schema": 2, "kind": "helix-trace"}\n')
    with pytest.raises(ValueError, match="schema"):
        workload.load_trace(path)
    reqs = workload.requests_from_trace(_trace(workload, "mix", 3), 512)
    jreqs = jax_workload.requests_from_trace(_trace(jax_workload, "mix", 3),
                                             512)
    assert ([(r.rid, r.prompt, r.max_new_tokens, r.tenant, r.slo_class)
             for r in reqs]
            == [(r.rid, r.prompt, r.max_new_tokens, r.tenant, r.slo_class)
                for r in jreqs])


# ------------------------------------------------------------- scheduler
def _sched(pkg, pool_pkg, paged, **kw):
    pool = pool_pkg(13, 4) if paged else None
    return pkg.Scheduler(max_batch=3, cap=24, pool=pool, **kw)


def _simulate(pkg, pool_pkg, seed, *, paged, tenancy, policy):
    """A seeded stream of submissions, admissions, served tokens,
    retirements, preemptions and batch-cap moves through one scheduler;
    returns every observable decision."""
    rng = np.random.default_rng(seed)
    kw = {}
    if tenancy:
        kw = dict(tenants=[pkg.TenantConfig("a", 3.0),
                           pkg.TenantConfig("b", 1.0, max_slots=2),
                           pkg.TenantConfig("c", 0.5)])
    sched = _sched(pkg, pool_pkg, paged, policy=policy, **kw)
    reqs, log, rid = {}, [], 0
    for step in range(70):
        for _ in range(int(rng.integers(0, 3))):
            req = pkg.Request(
                rid=rid, prompt=list(range(int(rng.integers(1, 20)))),
                max_new_tokens=8, tenant="abc"[int(rng.integers(0, 3))],
                slo_class=("batch" if rng.random() < 0.4
                           else "interactive"))
            reqs[rid] = req
            sched.submit(req)
            rid += 1
        placed = sched.admit()
        log.append(("admit", [(r.rid, s) for r, s in placed],
                    [r.rid for r in sched.queue],
                    [r.rid for r in sched.rejected]))
        for slot, r in enumerate(sched.slot_rids):
            if r is None:
                continue
            roll = rng.random()
            if roll < 0.5:
                if sched.grow_for_next_token(slot) is None:
                    sched.release(slot)
                    continue
                sched.on_token(slot)
                sched.record_served(slot, int(rng.integers(1, 3)))
            elif roll < 0.65:
                sched.release(slot)
            elif roll < 0.72:
                sched.preempt(slot, reqs[r])
        if tenancy and rng.random() < 0.2:
            sched.batch_cap = int(rng.integers(0, 4))
        sched.check_invariants()
        log.append(("state", list(sched.slot_rids), list(sched.slot_len),
                    dict(sched.served_tokens), sched.batch_cap,
                    [sched.at_capacity(s) for s in range(3)
                     if sched.slot_rids[s] is not None]))
    return log


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("tenancy", [False, True])
@pytest.mark.parametrize("policy", ["fcfs", "sjf"])
def test_scheduler_decisions_match_reference(paged, tenancy, policy):
    for seed in range(3):
        got = _simulate(scheduler, BlockAllocator, seed, paged=paged,
                        tenancy=tenancy, policy=policy)
        want = _simulate(jax_scheduler, JaxBlockAllocator, seed,
                         paged=paged, tenancy=tenancy, policy=policy)
        assert got == want


def test_assign_direct_and_reject_match_reference():
    out = []
    for pkg, pool_pkg in ((scheduler, BlockAllocator),
                          (jax_scheduler, JaxBlockAllocator)):
        sched = _sched(pkg, pool_pkg, True)
        rs = [pkg.Request(rid=i, prompt=list(range(n)))
              for i, n in enumerate((5, 60, 30, 9, 3))]
        out.append([(sched.assign_direct(r), r.finish_reason) for r in rs]
                   + [list(sched.slot_len)])
    assert out[0] == out[1]


# -------------------------------------------------------------- governor
def _governor_log(gpkg, mpkg, seed):
    """Drive a governor from one seeded stream of TTL samples through the
    package's own ``EngineMetrics`` on a ``VirtualClock``."""
    rng = np.random.default_rng(seed)
    clock = mpkg.VirtualClock(base_s=1e-3, decode_slot_s=4e-4)
    met = mpkg.EngineMetrics(clock=clock, ttl_target_s=2e-3,
                             recent_window=64)
    gov = gpkg.TTLGovernor(gpkg.GovernorConfig(
        ttl_target_s=2e-3, window=16, min_samples=4, cooldown_steps=3,
        recover_steps=5, min_batch_slots=1), max_batch=4)

    class Sched:
        batch_cap, max_batch = 4, 4

    sched = Sched()
    for rid, cls in enumerate(("interactive", "interactive", "batch")):
        met.on_submit(rid, tenant=f"t{rid}", slo_class=cls)
    out = []
    for step in range(120):
        busy = step < 60 or 80 <= step < 90
        clock.advance(steps=1, decode_slots=int(rng.integers(1, 5)) + 2 *
                      busy)
        for rid in (0, 1, 2):
            if rid < 2 and not (busy or step < 95):
                continue
            met.on_token(rid)
        victim = gov.step(met, sched, [7, 5, 3][:int(rng.integers(0, 4))])
        out.append((victim, sched.batch_cap, gov.sheds, gov.cap_raises,
                    met.recent_ttl_p95("interactive", window=16,
                                       min_samples=4)))
    for rid in (0, 1, 2):
        met.on_finish(rid, "max_tokens")
    return out, met.summary()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_governor_decisions_match_reference(seed):
    got, summ = _governor_log(governor, metrics, seed)
    want, jsumm = _governor_log(jax_governor, jax_metrics, seed)
    assert got == want and summ == jsumm
    assert any(g[0] is not None for g in got)           # it shed
    assert got[-1][3] > 0                               # and recovered


# ------------------------------------------------------------ serve_demo
BASE = dict(n_requests=8, prompt_len=12, max_new=6, max_batch=4,
            chunk_tokens=4, paged_kv=True, host_pages=64, virtual_clock=True,
            traffic="poisson", arrival_rate=2.0, tenants=TENANTS,
            slo_ttl_ms=2.2)
RUNS = {
    "governor": BASE,
    "governor w4": dict(BASE, decode_window=4, slo_ttl_ms=1.6),
    "governor top-p": dict(BASE, sampling="top_p", temperature=0.9,
                           top_p=0.85),
    "faults": dict(BASE, fault_plan="seed=9,restore_fail=0.5,corrupt=0.3,"
                                    "delay=0.5"),
    "sessions": dict(n_requests=3, prompt_len=12, max_new=4, max_batch=2,
                     chunk_tokens=4, paged_kv=True, session_kv=True,
                     turns=2, virtual_clock=True),
}
RUNS["sessions w4 top-p"] = dict(RUNS["sessions"], decode_window=4,
                                 sampling="top_p", temperature=0.9,
                                 top_p=0.85)
PORT_ONLY = {"decode_host_ms_per_token", "decode_device_ms",
             "graph_captures", "graph_setup_s", "graph_replays",
             "pool_waits", "grouped_steps", "prefill_calls",
             "engine_steps", "wall_s", "tok_s", "kv_cache_dtype"}


@functools.lru_cache(maxsize=None)
def _model():
    cfg = get_config("granite-3-2b").reduced()
    jparams = jax_init_params(jax_get_config("granite-3-2b").reduced(),
                              jax.random.PRNGKey(0))
    return params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


@functools.lru_cache(maxsize=None)
def _jax_serve(name):
    return jax_serve_demo("granite-3-2b", reduced=True, **RUNS[name],
                          **QUIET)


@pytest.mark.parametrize("name", list(RUNS))
def test_serve_demo_matches_reference_under_virtual_clock(name):
    jfin, jsum = _jax_serve(name)
    fin, summ = serve_demo("granite-3-2b", reduced=True, device="cpu",
                           model=_model(), **RUNS[name], **QUIET)
    assert ({r.rid: (r.prompt, r.out_tokens, r.finish_reason) for r in fin}
            == {r.rid: (r.prompt, r.out_tokens, r.finish_reason)
                for r in jfin})
    assert set(summ) - set(jsum) == PORT_ONLY
    assert {k: summ[k] for k in jsum} == jsum
    if name.startswith("governor"):
        assert summ["governor_cap_raises"] >= 1
        assert summ["per_class"]["batch"]["n_finished"] >= 1
    if name in ("governor", "governor top-p", "governor w4"):
        assert summ["governor_sheds"] >= 1
        assert summ["spills"] == summ["restores"] == summ["governor_sheds"]
        assert summ["resume_reprefill_chunks"] == 0
    if name == "faults":
        assert summ["restores_failed"] >= 1
        assert summ["resume_reprefill_chunks"] > 0
    if name.startswith("sessions"):
        assert summ["restores"] == 3 and summ["resume_reprefill_chunks"] == 0
        assert summ["n_finished"] == 6 and summ["turn2_ttft_s"] > 0


def test_serve_cli_takes_the_tier_and_tenancy_flags(capsys, tmp_path):
    rows = workload.generate_trace(5, arrival="bursty", rate=1.0, burst=2,
                                   tenants=workload.parse_tenants(TENANTS),
                                   prompt_len=10, max_tokens=4, seed=2)
    path = tmp_path / "trace.jsonl"
    workload.save_trace(path, rows)
    serve_main(["--reduced", "--device", "cpu", "--dtype", "float32",
                "--max-batch", "2", "--chunk-tokens", "4", "--paged-kv",
                "--host-pages", "32", "--trace", str(path), "--tenants",
                TENANTS, "--slo-ttl-ms", "1.5", "--virtual-clock",
                "--fault-plan", "seed=1,delay=1", "--metrics"])
    summ = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert summ["trace_id"] == workload.trace_id(rows)
    assert summ["n_finished"] == 5 and set(summ["per_tenant"]) == {"chat",
                                                                   "bulk"}
    assert summ["host_pages_capacity"] == 32
    serve_main(["--reduced", "--device", "cpu", "--dtype", "float32",
                "--requests", "2", "--prompt-len", "9", "--max-new", "3",
                "--paged-kv", "--session-kv", "--turns", "2",
                "--traffic", "poisson", "--arrival-rate", "0.5",
                "--virtual-clock", "--metrics"])
    summ = json.loads(capsys.readouterr().out.split("\n", 1)[1])
    assert summ["n_finished"] == 4 and summ["restores"] == 2
    assert summ["turn2_ttft_s"] > 0
