"""Helix across ranks (``torch.distributed`` over gloo, on the CPU) against
the port's emulated single-process path and the JAX reference, on reduced
granite-3-2b cut to 4 layers, f32.

The rank runs start once per module, side by side, each behind
``subprocess.run(..., timeout=)`` with a ``file://`` rendezvous under the
module's temporary directory (no fixed port): a world of 2 ranks (KVP 2;
then ``serve_demo(world=2)`` and a rank that fails), a world of 4 ranks
(KVP 4, then KVP 2 x TPA 2 over the same processes; then a rank that
lingers in its teardown) and one JAX process on
4 fake CPU devices (the reference's sharded ``build_serve_step`` on meshes
(2, 2) and (4, 1), HOP-B 2).  This file is also the rank job's script:
``python tests/test_torch_dist.py JOB DIR``.  JAX is imported inside the
tests only, so the rank processes, which re-import this module, stay
JAX-free.

Tolerances (f32): the rank path's attention equals the emulated path's bit
for bit (the same plain kernel version over the same shard, the same
combine over the same fragments), and so do HOP-B 2 and 1; against the
reference's unsharded oracle 2e-5 (softmax in another summation order).
Logits after the prefill and 2 decode steps: 1e-5 against the emulated
single-process port (the all-reduce sums the TP partials in another order
than one matmul), 1e-4 against the reference's ``forward`` and its sharded
step (4 layers of width 128-256 over the 512-row head, as in
``test_torch_model.py``); bit for bit across ranks (the vocab-parallel head
is all-gathered).
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
from repro_torch.core.helix import (helix_attention,  # noqa: E402
                                    prefill_to_rr_layout)
from repro_torch.core.sharding import (HelixConfig,  # noqa: E402
                                       RankLayout, check_ranks,
                                       default_helix_config)
from repro_torch.launch import ranks  # noqa: E402
from repro_torch.models.model_zoo import (build_serve_step,  # noqa: E402
                                          make_prefill_step)
from repro_torch.models.shard import flat_slice, shard_model  # noqa: E402
from repro_torch.models.transformer import (forward,  # noqa: E402
                                            head_weight, init_params)
from repro_torch.serving.engine import DecodeEngine  # noqa: E402
from repro_torch.serving.sampling import SamplingParams  # noqa: E402

LAYERS = 4
B, T, S_CAP, RR = 4, 24, 256, 16
WINDOWS = (0, 64)
TL = (200, 97, 31, 150)           # attention lengths, the new token in
LAYOUTS = {2: [(2, 1)], 4: [(4, 1), (2, 2)]}      # world -> (kvp, tpa)
ATTN_TOL = 2e-5
PORT_TOL = 1e-5
REF_TOL = 1e-4
TIMEOUT_S = 240
LINGER_S = 20
SERVE = dict(reduced=True, n_requests=5, prompt_len=(5, 9), max_new=6,
             max_batch=2, device="cpu")


def granite():
    return dataclasses.replace(get_config("granite-3-2b").reduced(),
                               n_layers=LAYERS)


def attn_inputs():
    """q [B, Qh, hsz], contiguous-position caches [B, Kh, S_CAP, hsz] and
    the new rows [B, Kh, hsz] (numpy, seeded)."""
    cfg = granite()
    rng = np.random.default_rng(3)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return (f(B, cfg.n_heads, cfg.hsz),
            f(B, cfg.n_kv_heads, S_CAP, cfg.hsz),
            f(B, cfg.n_kv_heads, S_CAP, cfg.hsz),
            f(B, cfg.n_kv_heads, cfg.hsz), f(B, cfg.n_kv_heads, cfg.hsz))


def rr_caches(kvp):
    q, k, v, kn, vn = attn_inputs()
    return (torch.from_numpy(q),
            prefill_to_rr_layout(torch.from_numpy(k), kvp, RR),
            prefill_to_rr_layout(torch.from_numpy(v), kvp, RR),
            torch.from_numpy(kn), torch.from_numpy(vn))


def tokens():
    return torch.from_numpy(np.random.default_rng(1).integers(
        0, granite().vocab, (B, T + 2)).astype(np.int64))


def local_shard(x, kvp, tpa, t, k):
    """Rank (t, k)'s shard of a global rr cache [B, Kh, S, hsz]."""
    kh, s_loc = x.shape[1] // tpa, x.shape[2] // kvp
    return x[:, t * kh:(t + 1) * kh, k * s_loc:(k + 1) * s_loc].contiguous()


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
    """Every layout of this world over the same processes: the attention
    outputs and appended shards, and the prefill + 2 steps' logits, at
    HOP-B 1 and 2.  Saved to ``d/world{n}-rank{r}.pt``."""
    torch.set_num_threads(1)
    cfg = granite()
    with open(os.path.join(d, "params.pkl"), "rb") as f:
        model = params_from_jax(pickle.load(f), cfg)
    res = {}
    for kvp, tpa in LAYOUTS[group.world]:
        g = group if (kvp, tpa) == (group.kvp, group.tpa) else HelixGroup(
            kvp, tpa, device="cpu")
        hx = HelixConfig(kvp=kvp, tpa=tpa, rr_block=RR)
        qh = cfg.n_heads // tpa
        for win in WINDOWS:
            for hopb in (1, 2):
                q, kc, vc, kn, vn = rr_caches(kvp)
                kh = kc.shape[1] // tpa
                kl, vl = (local_shard(x, kvp, tpa, g.t, g.k)
                          for x in (kc, vc))
                heads = slice(g.t * kh, (g.t + 1) * kh)
                out = helix_attention(
                    hx, q[:, g.t * qh:(g.t + 1) * qh].contiguous(), kl, vl,
                    torch.tensor(TL, dtype=torch.int32), window=win,
                    k_new=kn[:, heads].contiguous(),
                    v_new=vn[:, heads].contiguous(), group=g,
                    hopb_chunks=hopb)
                res[f"attn {kvp}x{tpa} w{win} h{hopb}"] = (out, kl, vl)
        local = shard_model(model, cfg, g)
        for hopb in (1, 2):
            res[f"e2e {kvp}x{tpa} h{hopb}"] = run_steps(
                cfg, hx, local, tokens(), group=g, hopb_chunks=hopb)
        res[f"calls {kvp}x{tpa}"] = dict(g.calls)
    torch.save(res, os.path.join(d, f"world{group.world}-rank{group.rank}.pt"))


def _failing_rank(group):
    """Rank 1 raises; rank 0 waits in a collective it never completes."""
    if group.rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    group.all_reduce(torch.ones(3))


def _lingering_rank(group):
    """Returns its result, then keeps its process alive past the launch's
    deadline (a thread the interpreter joins at exit)."""
    import threading
    threading.Thread(target=time.sleep, args=(300,)).start()
    return group.rank


def _job(name, d):
    """The rank job ``name`` of the module doc, results under ``d``."""
    torch.set_num_threads(1)
    world = int(name[-1])
    ranks.spawn(world, _rank_job, d, backend="gloo", device="cpu",
                init_method="file://" + os.path.join(d, f"rdv{world}"),
                timeout_s=TIMEOUT_S)
    if world != 2:
        t0 = time.perf_counter()
        try:
            ranks.spawn(2, _lingering_rank, backend="gloo", device="cpu",
                        init_method="file://" + os.path.join(d, "rdv_l"),
                        timeout_s=LINGER_S)
            lingered = None
        except RuntimeError as e:
            lingered = str(e)
        with open(os.path.join(d, "linger.pkl"), "wb") as f:
            pickle.dump({"error": lingered,
                         "s": time.perf_counter() - t0}, f)
        return
    from repro_torch.launch.serve import serve_demo
    with open(os.path.join(d, "serve_params.pkl"), "rb") as f:
        model = params_from_jax(pickle.load(f),
                                get_config("granite-3-2b").reduced())
    fin, summ = serve_demo(world=2, model=model, log=lambda *a: None,
                           init_method="file://" + os.path.join(d, "rdv_s"),
                           **SERVE)
    t0 = time.perf_counter()
    try:
        ranks.spawn(2, _failing_rank, backend="gloo", device="cpu",
                    init_method="file://" + os.path.join(d, "rdv_f"),
                    timeout_s=TIMEOUT_S)
        failed = None
    except RuntimeError as e:
        failed = str(e)
    with open(os.path.join(d, "serve.pkl"), "wb") as f:
        pickle.dump({"streams": {r.rid: r.out_tokens for r in fin},
                     "summary": summ, "failed": failed,
                     "failed_s": time.perf_counter() - t0}, f)


JAX_MESHES = r"""
import os, sys, dataclasses, pickle
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro.configs import get_config
from repro.core.sharding import default_helix_config
from repro.models.model_zoo import build_serve_step, make_prefill_step
from repro.utils import make_mesh, set_mesh
d = sys.argv[1]
with open(os.path.join(d, "params.pkl"), "rb") as f:
    params = jax.tree.map(np.asarray, pickle.load(f))
cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), n_layers=4)
toks = np.load(os.path.join(d, "tokens.npy")).astype(np.int32)
T = toks.shape[1] - 2
out = {}
for shape in ((2, 2), (4, 1)):
    mesh = make_mesh(shape, ("data", "model"))
    hx = default_helix_config(cfg, mesh)
    prefill = make_prefill_step(cfg, mesh, hx, s_cap=256)
    serve = build_serve_step(cfg, mesh, hx, hopb_chunks=2, return_logits=True)
    with set_mesh(mesh):
        l0, st = jax.jit(prefill)(params, {"tokens": toks[:, :T]})
        (_, l1), st = jax.jit(serve)(params, st, toks[:, T])
        (_, l2), st = jax.jit(serve)(params, st, toks[:, T + 1])
    out[f"{shape[0]}x{shape[1]}"] = np.stack([np.asarray(x, np.float32)
                                              for x in (l0, l1, l2)])
np.savez(os.path.join(d, "jax_meshes.npz"), **out)
"""


@pytest.fixture(scope="module")
def jax_granite():
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.transformer import init_params as jax_init_params
    jcfg = dataclasses.replace(jax_get_config("granite-3-2b").reduced(),
                               n_layers=LAYERS)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_granite):
    """Start the world-2, world-4 and JAX mesh jobs side by side; wait for
    all three.  Returns the directory of their results."""
    import jax

    from repro.configs import get_config as jax_get_config
    from repro.models.transformer import init_params as jax_init_params
    d = tmp_path_factory.mktemp("ranks")
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(jax_granite[1], f)
    serve = jax_init_params(jax_get_config("granite-3-2b").reduced(),
                            jax.random.PRNGKey(0))
    with open(d / "serve_params.pkl", "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, serve), f)
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


# ----------------------------------------------------- single process
def test_default_helix_config_follows_the_reference():
    """TPA = the mesh's model axis when K >= it, else pure KVP."""
    from types import SimpleNamespace

    from repro.configs import get_config as jax_get_config
    from repro.core.sharding import default_helix_config as jax_default
    for arch in ("granite-3-2b", "llama-405b", "gemma3-12b"):
        for world, model in ((2, 1), (4, 2), (8, 8), (32, 16)):
            mesh = SimpleNamespace(axis_names=("data", "model"),
                                   shape={"data": world // model,
                                          "model": model})
            ref = jax_default(jax_get_config(arch), mesh)
            hx = default_helix_config(get_config(arch), world, model)
            want_tpa = mesh.shape[ref.tpa_axis] if ref.tpa_axis else 1
            assert (hx.tpa, hx.kvp) == (want_tpa, world // want_tpa)
    with pytest.raises(ValueError):
        default_helix_config(get_config("granite-3-2b"), 6, 4)


@pytest.mark.parametrize("kvp,tpa,why", [
    (1, 3, "must divide"), (2, 4, "must divide"), (3, 1, "d_ff"),
    (3, 2, "split over kvp"), (1, 16, "must divide")])
def test_check_ranks_refuses(kvp, tpa, why):
    cfg = granite()                    # 4 q / 2 kv heads of 32, d_ff 256
    if why == "d_ff":
        cfg = dataclasses.replace(cfg, d_ff=250)
    with pytest.raises(ValueError, match=why):
        check_ranks(cfg, HelixConfig(kvp=kvp, tpa=tpa))
    check_ranks(granite(), HelixConfig(kvp=2, tpa=2))
    with pytest.raises(ValueError, match="rank group"):
        q, kc, vc, _, _ = rr_caches(2)
        helix_attention(HelixConfig(kvp=1, tpa=2), q, kc, vc, 10)


@pytest.mark.parametrize("kvp,tpa", [(2, 1), (4, 1), (2, 2), (3, 1)])
def test_shard_model_reassembles(kvp, tpa):
    """Every weight of every rank's share, put back in the rank order,
    is the model's (wo rows past q_dim are the pad's zeros)."""
    # kvp 3: 128 flat lanes padded to 129, 512 vocab columns to 513
    cfg = dataclasses.replace(granite(), d_ff=240) if kvp == 3 else granite()
    model = init_params(cfg, 0, device="cpu")
    shards = [shard_model(model, cfg, RankLayout(r, kvp, tpa))
              for r in range(kvp * tpa)]
    cat = lambda xs, dim: torch.cat(xs, dim)  # noqa: E731
    assert torch.equal(cat([head_weight(s) for s in shards], 1)[
        :, :cfg.padded_vocab], model.embed.T)
    for i, lp in enumerate(model.layers):
        ls = [s.layers[i] for s in shards]
        heads = [ls[t * kvp].attn for t in range(tpa)]
        for name in ("wq", "wk", "wv"):
            assert torch.equal(cat([getattr(a, name) for a in heads], 1),
                               getattr(lp.attn, name))
            assert all(torch.equal(getattr(s.attn, name),
                                   getattr(ls[r - r % kvp].attn, name))
                       for r, s in enumerate(ls))
        wo = cat([s.attn.wo for s in ls], 0)
        start, sl, q_loc = flat_slice(cfg, RankLayout(0, kvp, tpa))
        assert wo.shape[0] == tpa * sl * kvp >= cfg.q_dim
        assert torch.equal(wo[:cfg.q_dim], lp.attn.wo)
        assert not wo[cfg.q_dim:].any()
        for name, dim in (("w1", 1), ("w3", 1), ("w2", 0)):
            assert torch.equal(cat([getattr(s.ffn, name) for s in ls], dim),
                               getattr(lp.ffn, name))
        assert all(torch.equal(s.ln1, lp.ln1) for s in ls)
    assert all(torch.equal(s.embed, model.embed) for s in shards)


REFUSALS = {
    "paged": dict(hx=HelixConfig(kvp=2, paged_kv=True)),
    "int8 KV": dict(hx=HelixConfig(kvp=2, kv_cache_bits=8)),
    "int8 head": dict(hx=HelixConfig(kvp=2, lm_head_w8=True)),
    "unfused": dict(hx=HelixConfig(kvp=2, fuse_append=False)),
    "grouped": dict(hx=HelixConfig(kvp=2, grouped_decode=True)),
    "chunked": dict(chunk_tokens=8),
    "prefix share": dict(prefix_share=True),
    "sampling": dict(sampling=SamplingParams()),
    "window": dict(decode_window=4),
    "host tier": dict(host_pages=16),
    "sessions": dict(session_kv=True),
    "tenants": dict(tenants={"a": None}),
    "governor": dict(slo_ttl_s=0.1),
    "ssm arch": dict(arch="mamba2-780m"),
    # MoE serves across ranks; an EP that does not divide the ranks not
    "moe arch": dict(arch="granite-moe-1b-a400m",
                     hx=HelixConfig(kvp=2, ep=3)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_rank_engine_refuses(case):
    """Each option the multi-rank path leaves out raises ValueError at
    construction, before any weight or collective is touched."""
    kw = dict(REFUSALS[case])
    cfg = get_config(kw.pop("arch", "granite-3-2b")).reduced()
    hx = kw.pop("hx", HelixConfig(kvp=2))
    with pytest.raises(ValueError):
        DecodeEngine(cfg, None, None, None, max_batch=2, max_seq=16, hx=hx,
                     device="cpu", group=RankLayout(0, 2), **kw)


def test_serve_demo_world_refuses_in_the_parent():
    from repro_torch.launch.serve import serve_demo
    with pytest.raises(ValueError, match="arrivals"):
        serve_demo(world=2, traffic="poisson", **SERVE)
    with pytest.raises(ValueError, match="nccl"):
        serve_demo(world=2, dist_backend="nccl", **SERVE)
    with pytest.raises(ValueError, match="prefix_share"):
        serve_demo(world=2, prefix_share=True, **SERVE)
    # reduced granite has 2 KV heads: TPA 4 falls back to KVP 4 (the
    # reference's rule), so kvp=1 no longer fits the grid
    with pytest.raises(ValueError, match="kvp=1"):
        serve_demo(world=4, tpa=4, kvp=1, **SERVE)


def test_gloo_world_one_equals_single_process(tmp_path):
    """The rank path over a gloo group of one (this process) is the
    single-process path: the prefill's caches and last logits (against
    ``forward(last_only=True)``) and a decode step's logits bit for bit."""
    import torch.distributed as dist

    from repro_torch.core.dist import init_ranks
    cfg = granite()
    model = init_params(cfg, 0, device="cpu")
    toks = tokens()
    hx = HelixConfig(rr_block=RR)
    l0, st = make_prefill_step(cfg, hx)(model, {"tokens": toks[:, :T]})
    nxt = toks[:, T].to(torch.int32)
    init_ranks(0, 1, backend="gloo",
               init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        group = HelixGroup(1, device="cpu")
        local = shard_model(model, cfg, group)
        r0, rst = make_prefill_step(cfg, hx, group=group)(
            local, {"tokens": toks[:, :T]})
        assert all(torch.equal(st[k], rst[k]) for k in ("kcache", "vcache"))
        assert torch.equal(r0, forward(cfg, model, toks[:, :T],
                                       last_only=True)[0][:, -1])
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
def attn_cases():
    return [(w, kvp, tpa, win) for w, lays in LAYOUTS.items()
            for kvp, tpa in lays for win in WINDOWS]


@pytest.mark.parametrize("world,kvp,tpa,win", attn_cases())
def test_helix_attention_ranks(runs, world, kvp, tpa, win):
    """Each rank's slice and appended shard == the emulated call's, bit for
    bit, at HOP-B 1 and 2; the whole == the reference's unsharded oracle
    within 2e-5."""
    import jax.numpy as jnp

    from repro.kernels.flash_decode import flash_decode_ref as jax_ref
    cfg = granite()
    res = rank_results(runs, world)
    q, kc, vc, kn, vn = rr_caches(kvp)
    tl = torch.tensor(TL, dtype=torch.int32)
    want = helix_attention(HelixConfig(kvp=kvp, rr_block=RR), q, kc, vc, tl,
                           window=win, k_new=kn, v_new=vn)
    qh_loc, hsz = cfg.n_heads // tpa, cfg.hsz
    sl = qh_loc * hsz // kvp
    got = torch.zeros_like(want)
    for r, rr in enumerate(res):
        lay = RankLayout(r, kvp, tpa)
        out, kl, vl = rr[f"attn {kvp}x{tpa} w{win} h1"]
        start = lay.t * qh_loc * hsz + lay.k * sl
        assert torch.equal(out, want[:, start:start + sl]), r
        assert torch.equal(kl, local_shard(kc, kvp, tpa, lay.t, lay.k))
        assert torch.equal(vl, local_shard(vc, kvp, tpa, lay.t, lay.k))
        hop = rr[f"attn {kvp}x{tpa} w{win} h2"]
        assert all(torch.equal(a, b) for a, b in zip(hop, (out, kl, vl)))
        got[:, start:start + sl] = out
    # the reference's oracle over the contiguous cache, new rows in place
    q_, k_, v_, kn_, vn_ = attn_inputs()
    for b, n in enumerate(TL):
        k_[b, :, n - 1], v_[b, :, n - 1] = kn_[b], vn_[b]
    o, _ = jax_ref(jnp.asarray(q_), jnp.asarray(k_), jnp.asarray(v_),
                   jnp.asarray(np.array(TL, np.int32)), 0, kvp=1,
                   rr_block=RR, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(o).reshape(B, -1),
                               atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize("world,kvp,tpa", [(w, kvp, tpa)
                                           for w, lays in LAYOUTS.items()
                                           for kvp, tpa in lays])
def test_rank_decode_logits(runs, jax_granite, world, kvp, tpa):
    """Prefill + 2 decode steps across ranks: the same bits on every rank
    and at HOP-B 1 and 2; within 1e-5 of the emulated port at the same kvp
    and 1e-4 of the reference's forward over T + 2 tokens."""
    from repro.models.transformer import forward as jax_forward
    jcfg, jparams = jax_granite
    cfg = granite()
    res = rank_results(runs, world)
    got = res[0][f"e2e {kvp}x{tpa} h1"]
    for rr in res:
        for hopb in (1, 2):
            assert torch.equal(rr[f"e2e {kvp}x{tpa} h{hopb}"], got)
    model = params_from_jax(jparams, cfg)
    port = run_steps(cfg, HelixConfig(kvp=kvp, rr_block=RR), model, tokens())
    torch.testing.assert_close(got, port, atol=PORT_TOL, rtol=PORT_TOL)
    ref, _ = jax_forward(jcfg, jparams, tokens().numpy().astype(np.int32),
                         tp_width=1)
    ref = np.asarray(ref, np.float32)[:, T - 1:T + 2].transpose(1, 0, 2)
    np.testing.assert_allclose(got.numpy()[..., :cfg.vocab],
                               ref[..., :cfg.vocab], atol=REF_TOL,
                               rtol=REF_TOL)


@pytest.mark.parametrize("mesh,layout", [("2x2", (2, 2)), ("4x1", (4, 1))])
def test_rank_logits_match_the_reference_mesh(runs, mesh, layout):
    """The world-4 logits against the reference's sharded step on a fake
    4-device mesh with HOP-B 2 (mesh (2, 2): KVP 2 x TPA 2; (4, 1): KVP
    4), within 1e-4."""
    want = np.load(runs / "jax_meshes.npz")[mesh]
    got = rank_results(runs, 4)[0][f"e2e {layout[0]}x{layout[1]} h2"]
    v = granite().vocab
    np.testing.assert_allclose(got.numpy()[..., :v], want[..., :v],
                               atol=REF_TOL, rtol=REF_TOL)


def test_rank_collectives_per_step(runs):
    """One all-to-all and one LSE all-gather per layer per step and HOP-B
    chunk, two all-reduces per layer per step and prefill, one logits
    all-gather per step and prefill."""
    cfg = granite()
    for world, lays in LAYOUTS.items():
        for kvp, tpa in lays:
            calls = rank_results(runs, world)[0][f"calls {kvp}x{tpa}"]
            attn = len(WINDOWS) * (1 + 2)      # helix_attention calls
            steps = 2 * (1 + 2)                # decode steps, HOP-B 1 and 2
            assert calls["all_to_all"] == attn + cfg.n_layers * steps
            assert calls["all_reduce"] == 2 * cfg.n_layers * (2 + 4)
            assert calls["all_gather"] == (attn + cfg.n_layers * steps
                                           + 2 + 4)


def test_serve_demo_world2_streams(runs):
    """serve_demo over 2 ranks == the single-process port == the
    reference's serve_demo(mesh=None), token for token; a failing rank
    fails the run promptly."""
    import jax

    from repro.launch.serve import serve_demo as jax_serve_demo
    from repro.models.transformer import init_params as jax_init_params
    from repro.serving.workload import TenantSpec, generate_trace
    from repro.configs import get_config as jax_get_config
    from repro_torch.launch.serve import serve_demo
    with open(runs / "serve.pkl", "rb") as f:
        got = pickle.load(f)
    cfg = get_config("granite-3-2b").reduced()
    model = params_from_jax(jax.tree.map(np.asarray, jax_init_params(
        jax_get_config("granite-3-2b").reduced(), jax.random.PRNGKey(0))),
        cfg)
    fin, _ = serve_demo(model=model, log=lambda *a: None, **SERVE)
    rows = generate_trace(5, arrival="batch", tenants=(
        TenantSpec("default", prompt_len=(5, 9)),), prompt_len=7,
        max_tokens=6, seed=0)
    jfin, _ = jax_serve_demo("granite-3-2b", reduced=True, n_requests=5,
                             prompt_len=7, max_new=6, max_batch=2,
                             trace=rows, log=lambda *a: None)
    want = {r.rid: r.out_tokens for r in fin}
    assert got["streams"] == want == {r.rid: r.out_tokens for r in jfin}
    summ = got["summary"]
    assert (summ["world"], summ["kvp"], summ["tpa"]) == (2, 2, 1)
    assert len(summ["rank_collectives"]) == 2
    assert got["failed"] is not None and "rank 1 fails on purpose" \
        in got["failed"]
    assert got["failed_s"] < 30


def test_a_rank_that_lingers_fails_the_launch(runs):
    """A rank alive past the deadline after sending its result (a hang in
    its teardown) fails the launch, which stops it."""
    with open(runs / "linger.pkl", "rb") as f:
        got = pickle.load(f)
    assert got["error"] is not None and "outlived" in got["error"]
    assert got["s"] < LINGER_S + 30


if __name__ == "__main__":
    _job(sys.argv[1], sys.argv[2])
