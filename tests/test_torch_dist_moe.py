"""Helix across ranks for the mixture of experts (``torch.distributed``
over gloo, on the CPU): KVP x TPA attention, then the same ranks as EP x
TPF for the experts and TP for arctic's dense residual FFN, against the
port's single-process path and the JAX reference, on reduced
granite-moe-1b-a400m and reduced arctic-480b cut to 4 layers, f32
(reduced: d_model 128, 4 q / 2 kv heads of 32, 8 experts, top 2, expert
d_ff 64, capacity factor 8, so no prefill drops a token; arctic's dense
residual d_ff 256).

The rank runs start once per module, side by side, each behind
``subprocess.run``-style timeouts with a ``file://`` rendezvous under the
module's temporary directory: a world of 2 ranks (KVP 2, EP 2; then
``serve_demo(world=2)`` on reduced arctic), a world of 4 (KVP 4, EP 4;
then KVP 2 x TPA 2, EP 2 x TPF 2 over the same processes) and one JAX
process on 4 fake CPU devices (the reference's sharded ``make_prefill_step``
and ``build_serve_step`` on meshes (2, 2) and (4, 1), HOP-B 2).  This file
is also the rank job's script: ``python tests/test_torch_dist_moe.py JOB
DIR``.  JAX is imported inside the tests only, so the rank processes,
which re-import this module, stay JAX-free.

Tolerances (f32): shares, ``init_rank_params`` and routes exact; the
EP x TPF partials of one MoE layer summed over the grid 1e-6 against the
whole layer (TPF splits each expert's second product into partial sums);
logits after the prefill and 2 decode steps 1e-5 against the emulated
single-process port (the all-reduce sums the partials in another order),
1e-4 against the reference's sharded step (4 layers of width 128-256 over
the 512-row head, as in ``test_torch_dist.py``); bit for bit across ranks
and between HOP-B 1 and 2.
"""
import dataclasses
import os
import pathlib
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.dist import HelixGroup  # noqa: E402
from repro_torch.core.sharding import (HelixConfig,  # noqa: E402
                                       RankLayout, check_ranks,
                                       default_helix_config)
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.layers import activation  # noqa: E402
from repro_torch.models.model_zoo import (build_serve_step,  # noqa: E402
                                          make_prefill_step)
from repro_torch.models.shard import (expert_slice,  # noqa: E402
                                      init_rank_params, shard_model)
from repro_torch.models.transformer import init_params  # noqa: E402
from repro_torch.serving.engine import DecodeEngine  # noqa: E402

ARCHS = ("granite-moe-1b-a400m", "arctic-480b")
LAYERS = 4
B, T, S_CAP, RR = 4, 24, 256, 16
# world -> (kvp, tpa, ep): default_helix_config at model 1 and 2
LAYOUTS = {2: [(2, 1, 2)], 4: [(4, 1, 4), (2, 2, 2)]}
ALL_LAYOUTS = [lay for lays in LAYOUTS.values() for lay in lays]
MESH_OF = {(2, 2, 2): "2x2", (4, 1, 4): "4x1"}
PART_TOL = 1e-6
PORT_TOL = 1e-5
REF_TOL = 1e-4
TIMEOUT_S = 480            # a hang guard; the jobs take ~25 s on an idle host
SILU = activation("silu")
SERVE = dict(reduced=True, n_requests=5, prompt_len=(5, 9), max_new=6,
             max_batch=2, device="cpu")


def reduced(arch, layers=LAYERS):
    return dataclasses.replace(get_config(arch).reduced(), n_layers=layers)


def tokens():
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (B, T + 2)).astype(np.int64))


def run_steps(cfg, hx, model, toks, **kw):
    """Prefill T tokens, then 2 decode steps: logits [3, B, Vp]."""
    l0, st = make_prefill_step(cfg, hx, s_cap=S_CAP,
                               group=kw.get("group"))(model, {
                                   "tokens": toks[:, :T]})
    step = build_serve_step(cfg, hx, return_logits=True, **kw)
    (_, l1), st = step(model, st, toks[:, T].to(torch.int32))
    (_, l2), st = step(model, st, toks[:, T + 1].to(torch.int32))
    return torch.stack([l0, l1, l2])


# ------------------------------------------------------------ rank jobs
def _rank_job(group, d):
    """Every layout of this world over the same processes, for both archs:
    the prefill + 2 steps' logits at HOP-B 1 and 2, and the collectives.
    Saved to ``d/world{n}-rank{r}.pt``."""
    torch.set_num_threads(1)
    res = {}
    for arch in ARCHS:
        cfg = reduced(arch)
        with open(os.path.join(d, f"{arch}.pkl"), "rb") as f:
            model = params_from_jax(pickle.load(f), cfg)
        for kvp, tpa, ep in LAYOUTS[group.world]:
            g = (group if (kvp, tpa, ep) == (group.kvp, group.tpa, group.ep)
                 else HelixGroup(kvp, tpa, device="cpu", ep=ep))
            hx = HelixConfig(kvp=kvp, tpa=tpa, ep=ep, rr_block=RR)
            local = shard_model(model, cfg, g)
            g.reset_stats()
            for hopb in (1, 2):
                res[f"{arch} {kvp}x{tpa} h{hopb}"] = run_steps(
                    cfg, hx, local, tokens(), group=g, hopb_chunks=hopb)
            res[f"{arch} calls {kvp}x{tpa}"] = dict(g.calls)
    torch.save(res, os.path.join(d, f"world{group.world}-rank{group.rank}.pt"))


def _job(name, d):
    """The rank job ``name`` of the module doc, results under ``d``."""
    torch.set_num_threads(1)
    world = int(name[-1])
    kvp, tpa, ep = LAYOUTS[world][0]
    ranks.spawn(world, _rank_job, d, tpa=tpa, ep=ep, backend="gloo",
                device="cpu",
                init_method="file://" + os.path.join(d, f"rdv{world}"),
                timeout_s=TIMEOUT_S)
    if world != 2:
        return
    from repro_torch.launch.serve import serve_demo
    with open(os.path.join(d, "serve_params.pkl"), "rb") as f:
        model = params_from_jax(pickle.load(f),
                                get_config("arctic-480b").reduced())
    fin, summ = serve_demo("arctic-480b", world=2, model=model,
                           log=lambda *a: None,
                           init_method="file://" + os.path.join(d, "rdv_s"),
                           **SERVE)
    with open(os.path.join(d, "serve.pkl"), "wb") as f:
        pickle.dump({"streams": {r.rid: r.out_tokens for r in fin},
                     "summary": summ}, f)


JAX_MESHES = r"""
import os, sys, dataclasses, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs import get_config
from repro.core.sharding import default_helix_config
from repro.models.model_zoo import build_serve_step, make_prefill_step
from repro.utils import make_mesh, set_mesh
d = sys.argv[1]
toks = np.load(os.path.join(d, "tokens.npy")).astype(np.int32)
T = toks.shape[1] - 2
out = {}
for arch in ("granite-moe-1b-a400m", "arctic-480b"):
    with open(os.path.join(d, arch + ".pkl"), "rb") as f:
        params = jax.tree.map(np.asarray, pickle.load(f))
    cfg = dataclasses.replace(get_config(arch).reduced(), n_layers=4)
    for shape in ((2, 2), (4, 1)):
        mesh = make_mesh(shape, ("data", "model"))
        hx = default_helix_config(cfg, mesh)
        prefill = make_prefill_step(cfg, mesh, hx, s_cap=256)
        serve = build_serve_step(cfg, mesh, hx, hopb_chunks=2,
                                 return_logits=True)
        with set_mesh(mesh):
            l0, st = jax.jit(prefill)(params, {"tokens": toks[:, :T]})
            step = jax.jit(serve)
            (_, l1), st = step(params, st, toks[:, T])
            (_, l2), st = step(params, st, toks[:, T + 1])
        out[f"{arch} {shape[0]}x{shape[1]}"] = np.stack(
            [np.asarray(x, np.float32) for x in (l0, l1, l2)])
np.savez(os.path.join(d, "jax_meshes.npz"), **out)
"""


def _jax_params(arch, layers=LAYERS):
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.transformer import init_params as jax_init_params
    jcfg = jax_get_config(arch).reduced()
    if layers:
        jcfg = dataclasses.replace(jcfg, n_layers=layers)
    return jcfg, jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the world-2, world-4 and JAX mesh jobs side by side; wait for
    all three.  Returns the directory of their results."""
    d = tmp_path_factory.mktemp("moe_ranks")
    for arch in ARCHS:
        with open(d / f"{arch}.pkl", "wb") as f:
            pickle.dump(_jax_params(arch)[1], f)
    with open(d / "serve_params.pkl", "wb") as f:
        pickle.dump(_jax_params("arctic-480b", layers=0)[1], f)
    np.save(d / "tokens.npy", tokens().numpy())
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [sys.executable, __file__, name, str(d)] if name != "jax" else
        [sys.executable, "-c", JAX_MESHES, str(d)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in ("world2", "world4", "jax")}
    logs = {}
    try:
        for name, p in procs.items():
            left = max(1.0, TIMEOUT_S - (time.perf_counter() - t0))
            logs[name] = p.communicate(timeout=left)[0]
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    for name, p in procs.items():
        assert p.returncode == 0, f"{name} failed:\n{logs[name][-4000:]}"
    return d


def rank_results(d, world):
    return [torch.load(d / f"world{world}-rank{r}.pt") for r in range(world)]


def _world(lay):
    return lay[0] * lay[1]


# ----------------------------------------------------- single process
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_arctic_config_matches_reference(which):
    """Every port field of arctic-480b equals the reference's, the MoE
    config field by field (reduced: 8 experts, top 2, d_ff 64, capacity
    factor 8)."""
    from repro.configs import get_config as jax_get_config
    cfg, jcfg = get_config("arctic-480b"), jax_get_config("arctic-480b")
    if which == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    for f in dataclasses.fields(cfg):
        if f.name != "moe":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert dataclasses.asdict(cfg.moe) == dataclasses.asdict(jcfg.moe)
    for prop in ("hsz", "q_dim", "kv_dim", "padded_vocab"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    if which == "full":
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.hsz, cfg.d_ff, cfg.vocab, cfg.tie_embeddings) == (
            35, 7168, 56, 8, 128, 4864, 32000, False)
        assert (cfg.moe.n_experts, cfg.moe.topk, cfg.moe.d_ff) == (128, 2,
                                                                   4864)
    else:
        assert (cfg.moe.n_experts, cfg.moe.topk, cfg.moe.d_ff,
                cfg.moe.capacity_factor) == (8, 2, 64, 8.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_default_helix_config_follows_the_reference(arch):
    """TPA as for a dense arch; EP = the mesh's data axis (world / model),
    TPF = its model axis, the reference's ``ep_axis="data"``."""
    from types import SimpleNamespace

    from repro.configs import get_config as jax_get_config
    from repro.core.sharding import default_helix_config as jax_default
    for world, model in ((2, 1), (4, 1), (4, 2), (8, 8), (16, 4)):
        mesh = SimpleNamespace(axis_names=("data", "model"),
                               shape={"data": world // model,
                                      "model": model})
        ref = jax_default(jax_get_config(arch), mesh)
        hx = default_helix_config(get_config(arch), world, model)
        want_tpa = mesh.shape[ref.tpa_axis] if ref.tpa_axis else 1
        assert ref.ep_axis == "data"
        assert (hx.tpa, hx.kvp, hx.ep, hx.tpf) == (
            want_tpa, world // want_tpa, mesh.shape["data"], model)
    for lays in LAYOUTS.values():
        for kvp, tpa, ep in lays:
            hx = default_helix_config(reduced(arch), kvp * tpa, tpa)
            assert (hx.kvp, hx.tpa, hx.ep) == (kvp, tpa, ep)
    assert default_helix_config(get_config("granite-3-2b"), 4, 2).ep == 1


REFUSALS = {
    "experts": ("granite-moe-1b-a400m", {}, dict(kvp=3, ep=3),
                r"ep=3 does not divide .*'s 8 experts"),
    "expert d_ff": ("granite-moe-1b-a400m", {}, dict(kvp=3),
                    r"tpf=3 does not divide .* d_ff=64"),
    "dense residual": ("arctic-480b", dict(d_ff=255), dict(kvp=2, ep=2),
                       r"d_ff=255 does not split over 2 ranks"),
    "ranks": ("arctic-480b", {}, dict(kvp=4, ep=3),
              r"ep=3 does not divide 4 ranks"),
    "dense ep": ("granite-3-2b", {}, dict(kvp=2, ep=2),
                 r"ep=2: granite-3-2b-reduced has no experts"),
    "ssm": ("mamba2-780m", {}, dict(kvp=2), "mamba2-780m-reduced is ssm"),
    "hybrid": ("hymba-1.5b", {}, dict(kvp=2), "hymba-1.5b-reduced is hybrid"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_check_ranks_refuses(case):
    """Each misfit raises ``ValueError`` naming its numbers; the layouts
    tested here pass."""
    arch, change, hx, why = REFUSALS[case]
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    with pytest.raises(ValueError, match=why):
        check_ranks(cfg, HelixConfig(**hx))
    for arch in ARCHS:
        for kvp, tpa, ep in ALL_LAYOUTS:
            check_ranks(reduced(arch), HelixConfig(kvp=kvp, tpa=tpa, ep=ep))


@pytest.mark.parametrize("lay", ALL_LAYOUTS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_model_expert_shares_reassemble(arch, lay):
    """Each rank's experts and expert columns, put back by (EP, TPF)
    index, are the whole leaves; every (e, f) cell is held by one rank;
    the router is whole on every rank; arctic's dense residual splits over
    every rank in rank order."""
    cfg = reduced(arch)
    kvp, tpa, ep = lay
    model = init_params(cfg, 0, device="cpu")
    lays = [RankLayout(r, kvp, tpa, ep) for r in range(kvp * tpa)]
    assert sorted((x.e, x.f) for x in lays) == [
        (e, f) for e in range(ep) for f in range(kvp * tpa // ep)]
    shards = [shard_model(model, cfg, x) for x in lays]
    tpf = kvp * tpa // ep
    for i, lp in enumerate(model.layers):
        cell = {(x.e, x.f): s.layers[i].moe for x, s in zip(lays, shards)}
        for name, dim in (("w1", 2), ("w3", 2), ("w2", 1)):
            rows = [torch.cat([getattr(cell[e, f], name) for f in range(tpf)],
                              dim) for e in range(ep)]
            assert torch.equal(torch.cat(rows, 0), getattr(lp.moe, name))
        for x, s in zip(lays, shards):
            mp = s.layers[i].moe
            first, n, col0, cols = expert_slice(cfg, x)
            assert (mp.first, mp.col0, mp.w1.shape[0], mp.w1.shape[2]) == (
                first, col0, n, cols)
            assert torch.equal(mp.router, lp.moe.router)
            assert mp.router.dtype == torch.float32
        if cfg.d_ff:
            for name, dim in (("w1", 1), ("w3", 1), ("w2", 0)):
                assert torch.equal(torch.cat([getattr(s.layers[i].ffn, name)
                                              for s in shards], dim),
                                   getattr(lp.ffn, name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lay", ALL_LAYOUTS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_init_rank_params_equals_shard_model(arch, lay, dtype):
    """``init_rank_params(cfg, layout, seed)`` == ``shard_model(
    init_params(cfg, seed), layout)`` bit for bit, every leaf, names,
    shapes and dtypes (the router f32), on every rank."""
    cfg = reduced(arch)
    kvp, tpa, ep = lay
    whole = init_params(cfg, 5, dtype=dtype, device="cpu")
    for r in range(kvp * tpa):
        x = RankLayout(r, kvp, tpa, ep)
        want = dict(shard_model(whole, cfg, x).named_parameters())
        got = dict(init_rank_params(cfg, x, 5, dtype=dtype,
                                    device="cpu").named_parameters())
        assert got.keys() == want.keys()
        for name, w in want.items():
            assert got[name].dtype == w.dtype, name
            assert torch.equal(got[name], w), (r, name)


@pytest.mark.parametrize("cf", [8.0, 0.5])
@pytest.mark.parametrize("lay", ALL_LAYOUTS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_partials_sum_to_the_layer(arch, lay, cf):
    """One MoE layer in process: every rank routes as the whole layer
    (same experts and gates, same aux loss), and the EP x TPF partials
    summed over the grid equal ``moe_ffn`` within 1e-6, with drops (cf
    0.5) and without."""
    cfg = reduced(arch, 1)
    kvp, tpa, ep = lay
    model = init_params(cfg, 2, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (24, cfg.d_model)).astype(np.float32))
    mp = model.layers[0].moe
    want, aux = moe.moe_ffn(mp, x, cfg.moe, SILU, capacity_factor=cf)
    r0 = moe.route(mp.router, x, cfg.moe)
    total = torch.zeros_like(want)
    for r in range(kvp * tpa):
        share = shard_model(model, cfg, RankLayout(r, kvp, tpa, ep))
        smp = share.layers[0].moe
        rr = moe.route(smp.router, x, cfg.moe)
        assert torch.equal(rr.expert_idx, r0.expert_idx)
        assert torch.equal(rr.gates, r0.gates)
        y, a = moe.moe_ffn(smp, x, cfg.moe, SILU, capacity_factor=cf)
        assert torch.equal(a, aux)
        total += y
    torch.testing.assert_close(total, want, atol=PART_TOL, rtol=PART_TOL)


def test_rank_engine_admits_moe():
    """The multi-rank engine takes an MoE arch whose experts fit the grid
    (reduced arctic, KVP 2 x TPA 2, EP 2 x TPF 2)."""
    cfg = get_config("arctic-480b").reduced()
    hx = HelixConfig(kvp=2, tpa=2, ep=2)
    lay = RankLayout(3, 2, 2, 2)
    eng = DecodeEngine(cfg, init_rank_params(cfg, lay, device="cpu"), None,
                       None, max_batch=2, max_seq=16, hx=hx, device="cpu",
                       dtype=torch.float32, group=lay)
    assert eng.state["kcache"].shape[2] == cfg.n_kv_heads // 2


def test_gloo_world_one_equals_single_process(tmp_path):
    """Reduced arctic over a gloo group of one (this process): the prefill's
    caches, its last logits and a decode step's logits equal the
    single-process path's bit for bit; 1 all-to-all, 1 LSE all-gather and
    2 all-reduces a layer a step, 2 all-reduces a layer a prefill, 1 head
    all-gather each."""
    import torch.distributed as dist

    from repro_torch.core.dist import init_ranks
    cfg = reduced("arctic-480b")
    model = init_params(cfg, 0, device="cpu")
    toks = tokens()
    hx = HelixConfig(rr_block=RR)
    l0, st = make_prefill_step(cfg, hx)(model, {"tokens": toks[:, :T]})
    nxt = toks[:, T].to(torch.int32)
    init_ranks(0, 1, backend="gloo",
               init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        group = HelixGroup(1, device="cpu")
        local = init_rank_params(cfg, group, 0, device="cpu")
        r0, rst = make_prefill_step(cfg, hx, group=group)(
            local, {"tokens": toks[:, :T]})
        assert all(torch.equal(st[k], rst[k]) for k in ("kcache", "vcache"))
        assert torch.equal(r0, l0)
        (_, l1), _ = build_serve_step(cfg, hx, return_logits=True)(
            model, st, nxt)
        (_, r1), _ = build_serve_step(cfg, hx, return_logits=True,
                                      group=group)(local, rst, nxt)
        assert torch.equal(l1, r1)
        assert group.calls == {"all_to_all": cfg.n_layers,
                               "all_gather": cfg.n_layers + 2,
                               "all_reduce": 4 * cfg.n_layers}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------- rank runs
@pytest.mark.parametrize("lay", ALL_LAYOUTS, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_decode_logits(runs, arch, lay):
    """Prefill + 2 decode steps across ranks: the same bits on every rank
    and at HOP-B 1 and 2; within 1e-5 of the emulated port at the same
    kvp."""
    kvp, tpa, _ = lay
    cfg = reduced(arch)
    res = rank_results(runs, _world(lay))
    got = res[0][f"{arch} {kvp}x{tpa} h1"]
    for rr in res:
        for hopb in (1, 2):
            assert torch.equal(rr[f"{arch} {kvp}x{tpa} h{hopb}"], got)
    model = params_from_jax(_jax_params(arch)[1], cfg)
    port = run_steps(cfg, HelixConfig(kvp=kvp, rr_block=RR), model, tokens())
    torch.testing.assert_close(got, port, atol=PORT_TOL, rtol=PORT_TOL)


@pytest.mark.parametrize("lay", list(MESH_OF), ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_logits_match_the_reference_mesh(runs, arch, lay):
    """The world-4 logits against the reference's sharded step on a fake
    4-device mesh with HOP-B 2 (mesh (2, 2): KVP 2 x TPA 2, EP 2 x TPF 2;
    (4, 1): KVP 4, EP 4), within 1e-4."""
    kvp, tpa, _ = lay
    want = np.load(runs / "jax_meshes.npz")[f"{arch} {MESH_OF[lay]}"]
    got = rank_results(runs, 4)[0][f"{arch} {kvp}x{tpa} h2"]
    v = reduced(arch).vocab
    np.testing.assert_allclose(got.numpy()[..., :v], want[..., :v],
                               atol=REF_TOL, rtol=REF_TOL)


def test_rank_collectives_per_step(runs):
    """The FFN phase adds no collective: one all-to-all and one LSE
    all-gather per layer per step and HOP-B chunk, two all-reduces per
    layer per step and prefill, one logits all-gather per step and
    prefill, as for a dense arch."""
    for arch in ARCHS:
        n = reduced(arch).n_layers
        for lay in ALL_LAYOUTS:
            kvp, tpa, _ = lay
            calls = rank_results(runs, _world(lay))[0][
                f"{arch} calls {kvp}x{tpa}"]
            steps = 2 * (1 + 2)                # decode steps, HOP-B 1 and 2
            assert calls == {"all_to_all": n * steps,
                             "all_reduce": 2 * n * (2 + 4),
                             "all_gather": n * steps + 2 + 4}


def test_serve_demo_world2_streams(runs):
    """serve_demo of reduced arctic over 2 ranks (KVP 2, EP 2) == the
    single-process port == the reference's serve_demo(mesh=None), token
    for token."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.launch.serve import serve_demo as jax_serve_demo
    from repro.models.transformer import init_params as jax_init_params
    from repro.serving.workload import TenantSpec, generate_trace
    from repro_torch.launch.serve import serve_demo
    with open(runs / "serve.pkl", "rb") as f:
        got = pickle.load(f)
    cfg = get_config("arctic-480b").reduced()
    model = params_from_jax(jax.tree.map(np.asarray, jax_init_params(
        jax_get_config("arctic-480b").reduced(), jax.random.PRNGKey(0))),
        cfg)
    fin, _ = serve_demo("arctic-480b", model=model, log=lambda *a: None,
                        **SERVE)
    rows = generate_trace(5, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 9)),), prompt_len=7,
        max_tokens=6, seed=0)
    jfin, _ = jax_serve_demo("arctic-480b", reduced=True, n_requests=5,
                             prompt_len=7, max_new=6, max_batch=2,
                             trace=rows, log=lambda *a: None)
    want = {r.rid: r.out_tokens for r in fin}
    assert got["streams"] == want == {r.rid: r.out_tokens for r in jfin}
    summ = got["summary"]
    assert (summ["world"], summ["kvp"], summ["tpa"], summ["ep"]) == (2, 2,
                                                                     1, 2)
    assert len(summ["rank_collectives"]) == 2


def test_arctic_paged_top_p_window_serve_matches_reference():
    """reduced arctic in one process, top-p sampled windows of 4 from the
    paged pool: ``serve_demo``'s streams == the reference's, window for
    window (the mode granite-moe's ``test_torch_moe.py`` holds)."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.launch.serve import serve_demo as jax_serve_demo
    from repro.models.transformer import init_params as jax_init_params
    from repro.serving.workload import TenantSpec, generate_trace
    from repro_torch.launch.serve import serve_demo
    cfg = get_config("arctic-480b").reduced()
    model = params_from_jax(jax.tree.map(np.asarray, jax_init_params(
        jax_get_config("arctic-480b").reduced(), jax.random.PRNGKey(0))),
        cfg)
    kw = dict(paged_kv=True, sampling="top_p", temperature=0.9, top_p=0.85,
              decode_window=4, n_requests=5, max_new=6, max_batch=2)
    fin, summ = serve_demo("arctic-480b", reduced=True, prompt_len=(5, 9),
                           device="cpu", model=model, log=lambda *a: None,
                           **kw)
    rows = generate_trace(5, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 9)),), prompt_len=7,
        max_tokens=6, seed=0)
    jfin, jsum = jax_serve_demo("arctic-480b", reduced=True, prompt_len=7,
                                trace=rows, log=lambda *a: None, **kw)
    assert ({r.rid: r.out_tokens for r in fin}
            == {r.rid: r.out_tokens for r in jfin})
    assert summ["paged_kv"] and summ["decode_syncs"] == jsum["decode_syncs"]


if __name__ == "__main__":
    _job(sys.argv[1], sys.argv[2])
