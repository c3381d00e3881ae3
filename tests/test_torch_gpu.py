"""Tests of the port that need an sm_90 card (``gpu`` marker).  This file
imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Elsewhere each test skips from its fixture.  Tolerance 2e-5 at f32: kernel
and plain version compute the same softmax in f32 and differ only in
summation order; the w8a16 product 1e-5 of its largest |value| for the same
reason.  int8 payloads and scales, pruned == dense, fused == unfused,
paged == fixed and grouped == ungrouped are bit for bit.  The SSD scan
2e-4 of max(1, |y|): kernel and plain version run the same f32 products
over chunks in another summation order (bf16 inputs are converted exactly,
so the same tolerance holds).  bf16 flash_prefill 1.6e-2: the kernel rounds
P to bf16 for the tensor cores and its output to bf16, one bf16 ulp at
|x| <= 2 being 2^-6; paged == fixed and chunk rows == one-shot rows are bit
for bit.  The sampler on the card equals the CPU's bit for bit, and a
decode window replayed from a CUDA graph equals the eager window.
hymba-1.5b's shapes (flash_prefill at G = 3, 5, 6 and 7 query heads per kv
head, flash_decode at G = 5, the SSD scan at ds 16, the untied int8 head)
hold the same tolerances; two full-width hymba layers agree with the plain
path within 1e-3 x max(1, |logits|) (f32 matmuls of width 1600-6482 and
the 32256-row head over summation-order differences of ~1e-6).
whisper-base's and phi-3-vision's kernel modes (flash_prefill non-causal
at T = S and at T != S, head sizes 64 and 96; flash_decode's contiguous
layout and head size 96 in every mode) hold the same tolerances, and two
full-width layers of each model agree with the plain path within 1e-3 x
max(1, |logits|).
granite-moe-1b-a400m's shapes (flash_prefill and flash_decode at G = 2)
hold the same tolerances; its MoE layer at full width routes, slots and
plans every token on the card as on the CPU, its output within 2e-5 x
max(1, |y|).  gemma3-12b's head size 256 (flash_prefill, flash_decode
with windows, grouped decode whose window cuts the shared prefix) holds
the same tolerances.  The host tier moves pool pages to the host and back
as exact bytes, in place, and a preemption between two windows of a
captured graph restores without a recapture, the streams unchanged.
"""
import copy
import dataclasses

import pytest
import torch

from repro_torch.core.helix import append_kv_quant, quantize_kv_token
from repro_torch.core.kvcache import (init_decode_state, quantize_decode_state,
                                      state_to_paged)
from repro_torch.core.sharding import HelixConfig
from repro_torch.kernels import registry
from repro_torch.kernels.flash_decode.ops import (flash_decode_shards,
                                                  flash_decode_shards_plain,
                                                  kernel_block_s, prefix_pass)
from repro_torch.kernels.flash_prefill import (flash_prefill,
                                               flash_prefill_paged_ref,
                                               flash_prefill_ref)
from repro_torch.kernels.ssd_prefill import ssd_prefill, ssd_prefill_plain
from repro_torch.kernels.w8a16_matmul import (quantize_w8, w8a16_matmul,
                                              w8a16_matmul_ref)
from repro_torch.launch.serve import serve_demo
from repro_torch.models import moe
from repro_torch.models.model_zoo import (build_serve_multistep,
                                          build_serve_step, make_prefill_step)
from repro_torch.models.transformer import forward, init_params
from repro_torch.configs import get_config
from repro_torch.serving import sampling
from repro_torch.serving.graph import WindowRunner

ATOL = RTOL = 2e-5
RR = 16


@pytest.fixture
def h100():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_kernels_match_plain_on_card(h100):
    """Both kernels vs their plain versions, and pruned == dense bit for
    bit, with the fused append written in place like the plain version."""
    g = torch.Generator(device=h100).manual_seed(0)
    b, kvp, s_loc = 4, 2, 256
    q = torch.randn(b, 32, 64, generator=g, device=h100)
    k = torch.randn(b, 8, kvp * s_loc, 64, generator=g, device=h100)
    v = torch.randn(b, 8, kvp * s_loc, 64, generator=g, device=h100)
    kn = torch.randn(b, 8, 64, generator=g, device=h100)
    tl = torch.tensor([0, 1, 37, kvp * s_loc], dtype=torch.int32, device=h100)
    kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR, window=0,
              contiguous=False, slot_offset=0, k_new=kn, v_new=kn)
    k1, v1, k2, v2 = k.clone(), v.clone(), k.clone(), v.clone()
    o1, l1 = flash_decode_shards(q, k1, v1, tl, **kw)
    o3, l3 = flash_decode_shards(q, k.clone(), v.clone(), tl, prune=False,
                                 **kw)
    o2, l2 = flash_decode_shards_plain(q, k2, v2, tl, scale=64 ** -0.5,
                                       block_s=kernel_block_s(512, s_loc),
                                       **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o1, o2, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(l1, l2, atol=ATOL, rtol=RTOL)
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    assert torch.equal(o1, o3) and torch.equal(l1, l3)
    qp = torch.randn(2, 200, 32, 64, generator=g, device=h100)
    kp = torch.randn(2, 200, 8, 64, generator=g, device=h100)
    lens = torch.tensor([200, 120], dtype=torch.int32, device=h100)
    offs = torch.tensor([0, 9], dtype=torch.int32, device=h100)
    p1 = flash_prefill(qp, kp, kp, q_offset=offs, seq_lens=lens)
    p2 = flash_prefill_ref(qp, kp, kp, q_offset=offs, seq_lens=lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(p1, p2, atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
def test_serve_on_card_matches_cpu_and_counts_launches(h100):
    """Reduced granite-3-2b at f32: the kernel path on the card emits the
    same greedy streams as the plain path on the CPU, and launches each
    kernel once per layer per decode step / prefill."""
    cfg = get_config("granite-3-2b").reduced()
    model = init_params(cfg, 0, dtype=torch.float32, device="cpu")
    kw = dict(reduced=True, n_requests=5, prompt_len=(5, 40), max_new=6,
              max_batch=2, log=lambda *a: None)
    cpu, _ = serve_demo(device="cpu", model=model, **kw)
    registry.reset_launch_counts()
    gpu, summ = serve_demo(device="cuda", model=model.to(h100), **kw)
    counts = registry.launch_counts()
    assert ({r.rid: r.out_tokens for r in gpu}
            == {r.rid: r.out_tokens for r in cpu})
    assert counts == {"flash_decode": cfg.n_layers * summ["decode_syncs"],
                      "flash_decode_kv8": 0, "flash_decode_paged": 0,
                      "flash_decode_grouped": 0, "prefix_pass": 0,
                      "flash_prefill": cfg.n_layers * 5,
                      "flash_prefill_paged": 0, "w8a16_matmul": 0,
                      "ssd_prefill": 0, "flash_decode_contiguous": 0,
                      "flash_prefill_noncausal": 0,
                      "flash_prefill_cross": 0}


@pytest.mark.gpu
def test_w8a16_kernel_matches_plain_on_card(h100):
    g = torch.Generator(device=h100).manual_seed(1)
    for m, k, n in ((4, 2048, 49664), (8, 2048, 49664), (4, 2053, 49664),
                    (3, 200, 700), (9, 130, 257)):
        x = torch.randn(m, k, generator=g, device=h100)
        qw, scale = quantize_w8(torch.randn(k, n, generator=g, device=h100))
        got = w8a16_matmul(x, qw, scale)
        want = w8a16_matmul_ref(x, qw, scale)
        torch.cuda.synchronize()
        tol = 1e-5 * want.abs().max().item()
        assert (got - want).abs().max().item() <= tol, (m, k, n)


@pytest.mark.gpu
def test_int8_decode_kernel_matches_plain_on_card(h100):
    """int8 mode: kernel vs plain, pruned == dense, the fused quantized
    append equal to ``append_kv_quant`` then attend, bit for bit."""
    g = torch.Generator(device=h100).manual_seed(2)
    b, kvp, s_loc = 4, 2, 256
    q = torch.randn(b, 32, 64, generator=g, device=h100)
    k, ks = quantize_kv_token(torch.randn(b, 8, kvp * s_loc, 64, generator=g,
                                          device=h100))
    v, vs = quantize_kv_token(torch.randn(b, 8, kvp * s_loc, 64, generator=g,
                                          device=h100))
    kn = torch.randn(b, 8, 64, generator=g, device=h100)
    tl = torch.tensor([1, 2, 37, kvp * s_loc], dtype=torch.int32, device=h100)
    kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR, window=0,
              contiguous=False, slot_offset=0, k_new=kn, v_new=-kn)
    c1 = [t.clone() for t in (k, v, ks, vs)]
    c2 = [t.clone() for t in (k, v, ks, vs)]
    c3 = [t.clone() for t in (k, v, ks, vs)]
    o1, l1 = flash_decode_shards(q, c1[0], c1[1], tl, kscale=c1[2],
                                 vscale=c1[3], **kw)
    o2, l2 = flash_decode_shards_plain(q, c2[0], c2[1], tl, scale=64 ** -0.5,
                                       block_s=kernel_block_s(512, s_loc),
                                       kscale=c2[2], vscale=c2[3], **kw)
    append_kv_quant(*c3, kn, -kn, tl, kvp=kvp, rr_block=RR)
    kw.update(k_new=None, v_new=None)
    o3, l3 = flash_decode_shards(q, c3[0], c3[1], tl, kscale=c3[2],
                                 vscale=c3[3], prune=False, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o1, o2, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(l1, l2, atol=ATOL, rtol=RTOL)
    assert torch.equal(o1, o3) and torch.equal(l1, l3)
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    for a, b2, c in zip(c1, c2, c3):       # payloads and scales
        assert torch.equal(bits(a), bits(c)) and torch.equal(bits(a), bits(b2))


@pytest.mark.gpu
def test_paged_decode_kernel_matches_plain_and_fixed_on_card(h100):
    """Paged mode, fp and int8, kvp 2, fused append, a shuffled table with 0
    tails: kernel vs plain within 2e-5, and paged == fixed bit for bit
    (outputs, LSEs and the appended pages without the sink page 0)."""
    g = torch.Generator(device=h100).manual_seed(3)
    b, kvp, s_loc, page = 4, 2, 256, 2 * RR
    tl = torch.tensor([1, 2, 37, kvp * s_loc], dtype=torch.int32, device=h100)
    n_pages = [-(-int(x) // page) for x in tl.tolist()]
    perm = torch.randperm(sum(n_pages)).to(torch.int32) + 1
    tab = torch.zeros(b, kvp * s_loc // page, dtype=torch.int32)
    for r, n in enumerate(n_pages):
        tab[r, :n] = perm[sum(n_pages[:r]):sum(n_pages[:r + 1])]
    q = torch.randn(b, 32, 64, generator=g, device=h100)
    kn = torch.randn(b, 8, 64, generator=g, device=h100)
    fixed = {k: torch.randn(1, b, 8, kvp * s_loc, 64, generator=g,
                            device=h100) for k in ("kcache", "vcache")}
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    for quant in (False, True):
        st = quantize_decode_state(fixed) if quant else fixed
        keys = [k for k in ("kcache", "vcache", "kscale", "vscale") if k in st]
        paged = state_to_paged(st, tab, 1 + sum(n_pages), kvp, page)
        c1, c2, cf = ([p[k][0].clone() for k in keys]
                      for p in (paged, paged, st))
        sc = lambda c: dict(kscale=c[2], vscale=c[3]) if quant else {}
        kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR, window=0,
                  contiguous=False, slot_offset=0, k_new=kn, v_new=-kn)
        o1, l1 = flash_decode_shards(q, c1[0], c1[1], tl, **sc(c1), **kw,
                                     block_tables=paged["block_tables"])
        o2, l2 = flash_decode_shards_plain(
            q, c2[0], c2[1], tl, scale=64 ** -0.5,
            block_s=kernel_block_s(512, s_loc), **sc(c2), **kw,
            block_tables=paged["block_tables"])
        of, lf = flash_decode_shards(q, cf[0], cf[1], tl, **sc(cf), **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(o1, o2, atol=ATOL, rtol=RTOL)
        torch.testing.assert_close(l1, l2, atol=ATOL, rtol=RTOL)
        assert torch.equal(bits(o1), bits(of)) and torch.equal(bits(l1),
                                                                bits(lf))
        back = state_to_paged({k: c[None] for k, c in zip(keys, cf)}, tab,
                              1 + sum(n_pages), kvp, page)
        for a, p2, f in zip(c1, c2, (back[k][0] for k in keys)):
            assert torch.equal(bits(a[1:]), bits(p2[1:]))
            assert torch.equal(bits(a[1:]), bits(f[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_grouped_decode_kernels_match_plain_and_ungrouped_on_card(h100, quant):
    """prefix_pass + the grouped-suffix mode vs the plain grouped decode
    (2e-5) and vs the ungrouped paged kernel, bit for bit in outputs, LSEs
    and appended pages: rows 0, 1, 3 share 5 pages (the split falls inside
    a tile), row 2 decodes alone; kvp 1 and 2, windows 0 and 40."""
    _grouped_case(h100, quant, hsz=64, qh=32, seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_grouped_decode_kernels_at_hsz256_on_card(h100, quant):
    """The grouped decode's case at gemma3's head size 256 (16 q / 8 kv
    heads): with the window of 40 the shared pages lie partly (rows 0, 1)
    or wholly (row 3) before a member's window, whose prefix partial is
    then empty and merges exactly."""
    _grouped_case(h100, quant, hsz=256, qh=16, seed=33)


@pytest.mark.gpu
@pytest.mark.parametrize("reach", [1, 40], ids=["short", "long"])
@pytest.mark.parametrize("qh", [96, 128], ids=["g12", "g16"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_grouped_decode_kernels_at_g12_g16_on_card(h100, quant, qh, reach):
    """The grouped decode's case at 96 or 128 q / 8 kv heads of 128 (G =
    12 and 16): the prefix pass stacks 3 members x G rows; at lengths 40x
    longer (2000-4800 at kvp 1, 30 chunks a rank) its launch is large enough to hold all
    rows in one row block of 8 rows a warp, at the short ones it spreads
    them over blocks of 1 row a warp.  Bit for bit as in the G = 4 case."""
    _grouped_case(h100, quant, hsz=128, qh=qh, seed=qh + reach, reach=reach)


def _grouped_case(h100, quant, *, hsz, qh, seed, reach=1):
    g = torch.Generator(device=h100).manual_seed(seed)
    for kvp in (1, 2):
        page, mp = kvp * RR, 12 * reach
        tl = torch.tensor([100, 90, 50, 120], dtype=torch.int32,
                          device=h100) * kvp * reach
        tab = torch.zeros(4, mp, dtype=torch.int32)
        nxt = 6
        for b in range(4):
            need = -(-int(tl[b]) // page)
            row = [1, 2, 3, 4, 5] if b != 2 else []
            row = (row + list(range(nxt, nxt + mp)))[:need]
            nxt += need
            tab[b, :need] = torch.tensor(row, dtype=torch.int32)
        tab = tab.to(h100)
        n_pool = nxt
        gid = torch.tensor([0, 0, 2, 0], dtype=torch.int32, device=h100)
        gnp = torch.tensor([5, 5, 0, 5], dtype=torch.int32, device=h100)
        cache = {k: torch.randn(n_pool, 8, page, hsz, generator=g,
                                device=h100) for k in ("kcache", "vcache")}
        if quant:
            cache = quantize_decode_state(cache)
        keys = [k for k in ("kcache", "vcache", "kscale", "vscale")
                if k in cache]
        q = torch.randn(4, qh, hsz, generator=g, device=h100)
        kn = torch.randn(4, 8, hsz, generator=g, device=h100)
        for window in (0, 40):
            kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR,
                      window=window, block_tables=tab, k_new=kn, v_new=kn)

            def run(fn, groups, **extra):
                c = [cache[k].clone() for k in keys]
                sc = dict(kscale=c[2], vscale=c[3]) if quant else {}
                o, l = fn(q, c[0], c[1], tl, groups=groups, **sc, **kw,
                          **extra)
                return o, l, c

            registry.reset_launch_counts()
            og, lg, cg = run(flash_decode_shards, (gid, gnp))
            assert registry.launch_counts()["prefix_pass"] == 1
            of, lf, cf = run(flash_decode_shards, None)
            op, lp, cp = run(flash_decode_shards_plain, (gid, gnp),
                             scale=hsz ** -0.5, contiguous=False,
                             slot_offset=0,
                             block_s=kernel_block_s(512, mp * RR))
            torch.cuda.synchronize()
            assert torch.equal(og, of) and torch.equal(lg, lf)
            assert all(torch.equal(a[1:], b[1:]) for a, b in zip(cg, cf))
            assert all(torch.equal(a[1:], b[1:]) for a, b in zip(cg, cp))
            torch.testing.assert_close(og, op, atol=ATOL, rtol=RTOL)
            torch.testing.assert_close(lg, lp, atol=ATOL, rtol=RTOL)
            st = prefix_pass(q, *(cache[k] for k in keys[:2]), tl, tab, gid,
                             gnp, kvp=kvp, n_ranks=kvp, rr_block=RR,
                             window=window, chunks=True,
                             **(dict(kscale=cache["kscale"],
                                     vscale=cache["vscale"]) if quant
                                else {}))
            o2, l2, _ = run(flash_decode_shards, (gid, gnp), prefix_state=st)
            assert torch.equal(o2, og) and torch.equal(l2, lg)


@pytest.mark.gpu
@pytest.mark.parametrize("hd,ds", [(64, 128), (128, 128), (64, 256)],
                         ids=["serve", "hd128", "ds256"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_prefill_kernel_matches_plain_on_card(h100, dtype, hd, ds):
    """The SSD scan kernel vs its plain version at the serve widths (hd 64,
    ds 128) and at states of 16 tiles of 16 x 64 (twice the 8 warps), a
    ragged T with two groups of B/C and an initial state; two halves
    chained through h_final == one pass, bit for bit at a split on the
    chunk grid (64) and within the tolerance off it (100)."""
    g = torch.Generator(device=h100).manual_seed(5)
    b, t, nh = 2, 200, 8
    rnd = lambda *s: torch.randn(*s, generator=g, device=h100)
    x = rnd(b, t, nh, hd).to(dtype)
    dt = torch.nn.functional.softplus(rnd(b, t, nh) - 1.0)
    a = -torch.exp(rnd(nh) * 0.3)
    bm, cm = (rnd(b, t, 2, ds) * 0.5).to(dtype), (rnd(b, t, 2, ds) * 0.5).to(dtype)
    d, h0 = torch.ones(nh, device=h100), rnd(b, nh, hd, ds) * 0.2
    before = registry.launch_counts()["ssd_prefill"]
    y, h = ssd_prefill(x, dt, a, bm, cm, d, h0=h0)
    yp, hp = ssd_prefill_plain(x, dt, a, bm, cm, d, h0=h0)
    torch.cuda.synchronize()
    assert registry.launch_counts()["ssd_prefill"] == before + 1
    for got, want in ((y, yp), (h, hp)):
        tol = 2e-4 * max(1.0, want.abs().max().item())
        assert (got - want).abs().max().item() <= tol
    for cut in (64, 100):
        y1, h1 = ssd_prefill(x[:, :cut], dt[:, :cut].contiguous(), a,
                             bm[:, :cut], cm[:, :cut], d, h0=h0)
        y2, h2 = ssd_prefill(x[:, cut:], dt[:, cut:].contiguous(), a,
                             bm[:, cut:], cm[:, cut:], d, h0=h1)
        if cut % 64 == 0:
            assert torch.equal(torch.cat([y1, y2], 1), y)
            assert torch.equal(h2, h)
        else:
            torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=2e-4,
                                       rtol=2e-4)
            torch.testing.assert_close(h2, h, atol=2e-4, rtol=2e-4)


def _pool(x, tab, n_pool, page, garbage):
    """Fixed-layout K or V [B, S, Kh, hsz] -> pool planes [n_pool, Kh, page,
    hsz] under ``tab`` (entry 0: the sink page, filled with ``garbage``)."""
    b, s, kh, hsz = x.shape
    pages = x.reshape(b, s // page, page, kh, hsz).transpose(2, 3)
    pool = torch.full((n_pool, kh, page, hsz), garbage, dtype=x.dtype,
                      device=x.device)
    live = tab > 0
    pool[tab[live].long()] = pages[live]
    return pool


def _table(lens, max_pages, page, seed):
    need = [-(-int(n) // page) for n in lens.tolist()]
    perm = torch.randperm(sum(need), generator=torch.Generator().manual_seed(
        seed)).to(torch.int32) + 1
    tab = torch.zeros(len(need), max_pages, dtype=torch.int32)
    for r, n in enumerate(need):
        tab[r, :n] = perm[sum(need[:r]):sum(need[:r + 1])]
    return tab.to(lens.device), 1 + sum(need)


PREFILL_TOL = {torch.float32: 2e-5, torch.bfloat16: 1.6e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("hsz", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_kernel_fixed_and_paged_on_card(h100, dtype, hsz):
    """flash_prefill fixed and paged (page 16, shuffled table, a sink page
    of +-1e4) vs the plain version, windows 0 and 64, per-request offsets
    and lengths; paged == fixed bit for bit; lens == 0 rows are zero."""
    g = torch.Generator(device=h100).manual_seed(7)
    b, t, qh, kh, page = 2, 200, 16, 4, 16
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=h100).to(dtype)
    q, k, v = rnd(b, t, qh, hsz), rnd(b, 208, kh, hsz), rnd(b, 208, kh, hsz)
    offs = torch.tensor([0, 9], dtype=torch.int32, device=h100)
    for lens in ([200, 120], [0, 77]):
        lens = torch.tensor(lens, dtype=torch.int32, device=h100)
        tab, n_pool = _table(lens, 208 // page, page, hsz)
        pk, pv = (_pool(x, tab, n_pool, page, 1e4) for x in (k, v))
        for window in (0, 64):
            kw = dict(causal=True, window=window, q_offset=offs,
                      seq_lens=lens)
            before = registry.launch_counts()
            fixed = flash_prefill(q, k, v, **kw)
            paged = flash_prefill(q, pk, pv, block_tables=tab, **kw)
            want = flash_prefill_ref(q, k, v, **kw)
            want_p = flash_prefill_paged_ref(q, pk, pv, tab, lens,
                                             causal=True, window=window,
                                             q_offset=offs)
            torch.cuda.synchronize()
            after = registry.launch_counts()
            assert after["flash_prefill"] == before["flash_prefill"] + 2
            assert (after["flash_prefill_paged"]
                    == before["flash_prefill_paged"] + 1)
            tol = PREFILL_TOL[dtype]
            torch.testing.assert_close(fixed, want, atol=tol, rtol=0)
            torch.testing.assert_close(paged, want_p, atol=tol, rtol=0)
            ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
            assert torch.equal(fixed.view(ints), paged.view(ints))
            if lens[0] == 0:
                assert torch.all(fixed[0] == 0) and torch.all(paged[0] == 0)


@pytest.mark.gpu
def test_prefill_chunk_rows_equal_one_shot_rows_on_card(h100):
    """bf16: rows of 4 chunk calls (T = 256 at q_offset 0/256/512/768,
    seq_lens = offset + 256) == the same rows of one T = 1024 call, bit for
    bit, fixed and paged (page 64)."""
    g = torch.Generator(device=h100).manual_seed(8)
    rnd = lambda *sh: torch.randn(*sh, generator=g,
                                  device=h100).to(torch.bfloat16)
    t, page = 1024, 64
    q, k, v = rnd(1, t, 32, 64), rnd(1, t, 8, 64), rnd(1, t, 8, 64)
    full_lens = torch.tensor([t], dtype=torch.int32, device=h100)
    tab, n_pool = _table(full_lens, t // page, page, 3)
    pk, pv = (_pool(x, tab, n_pool, page, 1e4) for x in (k, v))
    for kv, extra in (((k, v), {}), ((pk, pv), dict(block_tables=tab))):
        one = flash_prefill(q, *kv, seq_lens=full_lens, **extra)
        for off in range(0, t, 256):
            lens = torch.tensor([off + 256], dtype=torch.int32, device=h100)
            part = flash_prefill(q[:, off:off + 256].contiguous(), *kv,
                                 q_offset=off, seq_lens=lens, **extra)
            torch.cuda.synchronize()
            assert torch.equal(part.view(torch.int16),
                               one[:, off:off + 256].view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("g", [3, 5, 6, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_kernel_at_groups_not_dividing_64_on_card(h100, dtype, g):
    """flash_prefill with G query heads per kv head where G does not divide
    the block's 64 rows (hymba's G = 5: 12 positions, 4 dead rows): fixed
    and paged vs the plain version at windows 0 and 64 with per-request
    offsets and lengths, paged == fixed bit for bit, and rows of 4 chunk
    calls == the same rows of one call, bit for bit."""
    _prefill_group_case(h100, dtype, g, kh=5, hsz=64, seed=20 + g)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(48, 4), (128, 8)], ids=["g12", "g16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_kernel_at_g12_g16_on_card(h100, dtype, heads):
    """flash_prefill at starcoder2-15b's 48 q / 4 kv heads (G = 12: 5
    positions and 4 dead rows a block) and llama-405b's 128 / 8 (G = 16: 4
    positions), heads of 128: the checks of the G = 3-7 case."""
    qh, kh = heads
    _prefill_group_case(h100, dtype, qh // kh, kh=kh, hsz=128, seed=qh)


def _prefill_group_case(h100, dtype, g, *, kh, hsz, seed):
    gen = torch.Generator(device=h100).manual_seed(seed)
    rnd = lambda *sh: torch.randn(*sh, generator=gen,
                                  device=h100).to(dtype)
    b, t, page = 2, 256, 16
    q, k, v = rnd(b, t, kh * g, hsz), rnd(b, t, kh, hsz), rnd(b, t, kh, hsz)
    offs = torch.tensor([0, 9], dtype=torch.int32, device=h100)
    lens = torch.tensor([256, 201], dtype=torch.int32, device=h100)
    tab, n_pool = _table(lens, t // page, page, g)
    pk, pv = (_pool(x, tab, n_pool, page, 1e4) for x in (k, v))
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for window in (0, 64):
        kw = dict(causal=True, window=window, q_offset=offs, seq_lens=lens)
        fixed = flash_prefill(q, k, v, **kw)
        paged = flash_prefill(q, pk, pv, block_tables=tab, **kw)
        want = flash_prefill_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(fixed, want, atol=PREFILL_TOL[dtype],
                                   rtol=0)
        assert torch.equal(fixed.view(ints), paged.view(ints))
    full = torch.tensor([t], dtype=torch.int32, device=h100)
    one = flash_prefill(q[:1], k[:1], v[:1], seq_lens=full)
    for off in range(0, t, 64):
        part = flash_prefill(q[:1, off:off + 64].contiguous(), k[:1], v[:1],
                             q_offset=off, seq_lens=full * 0 + off + 64)
        torch.cuda.synchronize()
        assert torch.equal(part.view(ints), one[:, off:off + 64].view(ints))


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_decode_kernel_at_g5_on_card(h100, quant, paged):
    """flash_decode at hymba's 25 q / 5 kv heads, kvp 2, with the fused
    append: kernel vs plain (f32), the appended rows bit for bit, fixed and
    paged, fp and int8."""
    _decode_group_case(h100, quant, paged, g=5, kh=5, seed=21)


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_decode_kernel_at_g2_on_card(h100, quant, paged):
    """flash_decode at granite-moe's 16 q / 8 kv heads (G = 2), kvp 2,
    with the fused append: kernel vs plain (f32), the appended rows bit
    for bit, fixed and paged, fp and int8."""
    _decode_group_case(h100, quant, paged, g=2, kh=8, seed=24)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_decode_kernel_at_hsz256_on_card(h100, quant, paged, window):
    """flash_decode at gemma3's 16 q / 8 kv heads of 256, kvp 2, with the
    fused append and windows 0 and 100 (shorter than 3 of the 4 lengths):
    kernel vs plain (f32), the appended rows bit for bit, fixed and paged,
    fp and int8."""
    _decode_group_case(h100, quant, paged, g=2, kh=8, seed=34, hsz=256,
                       window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("heads", [(48, 4), (128, 8)], ids=["g12", "g16"])
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_decode_kernel_at_g12_g16_on_card(h100, quant, paged, heads):
    """flash_decode at starcoder2-15b's 48 q / 4 kv heads (G = 12: 3 of 4
    rows a warp) and llama-405b's 128 / 8 (G = 16: 4 rows a warp), heads of
    128, kvp 2, with the fused append and windows 0 and 100: kernel vs
    plain (f32), the appended rows bit for bit, fixed and paged, fp and
    int8."""
    qh, kh = heads
    for window in (0, 100):
        _decode_group_case(h100, quant, paged, g=qh // kh, kh=kh, seed=qh,
                           hsz=128, window=window)


@pytest.mark.gpu
def test_decode_kernel_refuses_g16_at_hsz256_on_card(h100):
    """At head size 256 the kernel holds at most 8 query heads per kv head:
    G = 16 raises a ValueError that names the limit and launches nothing
    (no fall back to the plain version)."""
    q = torch.zeros(1, 16, 256, device=h100)
    k = torch.zeros(1, 1, 64, 256, device=h100)
    registry.reset_launch_counts()
    with pytest.raises(ValueError, match="8 at hsz 256"):
        flash_decode_shards(q, k, k.clone(), 10, kvp=1)
    assert registry.launch_counts()["flash_decode"] == 0


def _decode_group_case(h100, quant, paged, *, g, kh, seed, hsz=64,
                       window=0):
    gen = torch.Generator(device=h100).manual_seed(seed)
    b, kvp, s_loc = 4, 2, 256
    rnd = lambda *sh: torch.randn(*sh, generator=gen, device=h100)
    q, kn, vn = rnd(b, g * kh, hsz), rnd(b, kh, hsz), rnd(b, kh, hsz)
    k, v = rnd(b, kh, kvp * s_loc, hsz), rnd(b, kh, kvp * s_loc, hsz)
    tl = torch.tensor([1, 37, 300, kvp * s_loc], dtype=torch.int32,
                      device=h100)
    st = {"kcache": k[None], "vcache": v[None]}
    if quant:
        st = quantize_decode_state(st)
    if paged:
        tab = torch.arange(1, 1 + b * kvp * s_loc // (kvp * RR),
                           dtype=torch.int32).reshape(b, -1)
        st = state_to_paged(dict(st, total_len=tl), tab, 1 + tab.numel(),
                            kvp, kvp * RR)
    planes = {key: val[0] for key, val in st.items()
              if key in ("kcache", "vcache", "kscale", "vscale")}
    kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR, window=window,
              contiguous=False, slot_offset=0, k_new=kn, v_new=vn,
              block_tables=st["block_tables"] if paged else None)
    mine = {key: val.clone() for key, val in planes.items()}
    plain = {key: val.clone() for key, val in planes.items()}
    sc = lambda c: ({"kscale": c["kscale"], "vscale": c["vscale"]} if quant
                    else {})
    o1, l1 = flash_decode_shards(q, mine["kcache"], mine["vcache"], tl,
                                 **sc(mine), **kw)
    o2, l2 = flash_decode_shards_plain(q, plain["kcache"], plain["vcache"],
                                       tl, scale=hsz ** -0.5,
                                       block_s=kernel_block_s(512, s_loc),
                                       **sc(plain), **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(o1, o2, atol=ATOL, rtol=RTOL)
    torch.testing.assert_close(l1, l2, atol=ATOL, rtol=RTOL)
    for key in mine:
        assert torch.equal(mine[key], plain[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_kernel_at_g2_on_card(h100, dtype):
    """flash_prefill at granite-moe's 16 q / 8 kv heads (G = 2, hsz 64):
    fixed and paged vs the plain version, causal, per-request offsets and
    lengths, paged == fixed bit for bit."""
    gen = torch.Generator(device=h100).manual_seed(25)
    rnd = lambda *sh: torch.randn(*sh, generator=gen,
                                  device=h100).to(dtype)
    b, t, kh, hsz, page = 2, 256, 8, 64, 16
    q, k, v = rnd(b, t, 2 * kh, hsz), rnd(b, t, kh, hsz), rnd(b, t, kh, hsz)
    offs = torch.tensor([0, 9], dtype=torch.int32, device=h100)
    lens = torch.tensor([256, 201], dtype=torch.int32, device=h100)
    tab, n_pool = _table(lens, t // page, page, 2)
    pk, pv = (_pool(x, tab, n_pool, page, 1e4) for x in (k, v))
    ints = torch.int16 if dtype == torch.bfloat16 else torch.int32
    kw = dict(causal=True, q_offset=offs, seq_lens=lens)
    fixed = flash_prefill(q, k, v, **kw)
    paged = flash_prefill(q, pk, pv, block_tables=tab, **kw)
    want = flash_prefill_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(fixed, want, atol=PREFILL_TOL[dtype], rtol=0)
    assert torch.equal(fixed.view(ints), paged.view(ints))


@pytest.mark.gpu
@pytest.mark.parametrize("t", [4, 1024])
def test_moe_ffn_on_card_matches_cpu(h100, t):
    """granite-moe's MoE layer at full width (E 32, top 8, H 1024, Fe 512,
    f32) on the card against the CPU: routes, slots and token plans equal,
    y within 2e-5 x max(1, |y|) (f32 matmuls of 1024 and 512 terms in
    another order); T = 4 at the decode capacity factor drops nothing."""
    cfg = get_config("granite-moe-1b-a400m")
    m = cfg.moe
    card = moe.MoEParams(m, cfg.d_model).to(h100)
    moe.init_moe(card, m, cfg.d_model, 26)
    cpu = copy.deepcopy(card).cpu()
    cf = m.decode_capacity_factor if t == 4 else m.capacity_factor
    cap = moe.capacity(t, m, cf)
    x = torch.randn(t, cfg.d_model, device=h100,
                    generator=torch.Generator(device=h100).manual_seed(27))
    outs = []
    for mp, xs in ((card, x), (cpu, x.cpu())):
        r = moe.route(mp.router, xs, m)
        plan = moe.dispatch_plan(r.expert_idx, m.n_experts, cap)
        y, _ = moe.moe_ffn(mp, xs, m, torch.nn.functional.silu,
                           capacity_factor=cf)
        outs.append([v.cpu() for v in (r.expert_idx, *plan, y)])
    (ci, cs, ct, cy), (hi, hs, ht, hy) = outs
    assert torch.equal(ci, hi) and torch.equal(cs, hs) and torch.equal(ct, ht)
    assert (cy - hy).abs().max().item() <= 2e-5 * max(1.0,
                                                      hy.abs().max().item())
    if t == 4:
        assert bool((hs < cap).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_ssd_prefill_kernel_at_hymba_widths_on_card(h100, dtype):
    """The SSD scan kernel at hymba's widths (nh 50, hd 64, ds 16, one B/C
    group: a state tile holds 2 of its 8 column groups and half the warps
    hold no S unit) vs its plain version at T = 1024 and a ragged 37 from
    a nonzero state; two halves split on the chunk grid chained through
    h_final == one pass, bit for bit."""
    gen = torch.Generator(device=h100).manual_seed(22)
    rnd = lambda *s: torch.randn(*s, generator=gen, device=h100)
    nh, hd, ds = 50, 64, 16
    for b, t in ((1, 1024), (2, 37)):
        x = rnd(b, t, nh, hd).to(dtype)
        dt = torch.nn.functional.softplus(rnd(b, t, nh) - 1.0)
        a = -torch.exp(rnd(nh) * 0.3)
        bm, cm = ((rnd(b, t, 1, ds) * 0.5).to(dtype) for _ in range(2))
        d, h0 = torch.ones(nh, device=h100), rnd(b, nh, hd, ds) * 0.2
        y, h = ssd_prefill(x, dt, a, bm, cm, d, h0=h0)
        yp, hp = ssd_prefill_plain(x, dt, a, bm, cm, d, h0=h0)
        torch.cuda.synchronize()
        for got, want in ((y, yp), (h, hp)):
            tol = 2e-4 * max(1.0, want.abs().max().item())
            assert (got - want).abs().max().item() <= tol
        if t == 1024:
            y1, h1 = ssd_prefill(x[:, :512], dt[:, :512].contiguous(), a,
                                 bm[:, :512], cm[:, :512], d, h0=h0)
            y2, h2 = ssd_prefill(x[:, 512:], dt[:, 512:].contiguous(), a,
                                 bm[:, 512:], cm[:, 512:], d, h0=h1)
            assert torch.equal(torch.cat([y1, y2], 1), y)
            assert torch.equal(h2, h)


@pytest.mark.gpu
def test_w8a16_kernel_at_hymba_head_on_card(h100):
    """The int8 head of hymba: K = 1600, N = 32256, M = 1 and 4."""
    g = torch.Generator(device=h100).manual_seed(23)
    qw, scale = quantize_w8(torch.randn(1600, 32256, generator=g,
                                        device=h100))
    for m in (1, 4):
        x = torch.randn(m, 1600, generator=g, device=h100)
        got = w8a16_matmul(x, qw, scale)
        want = w8a16_matmul_ref(x, qw, scale)
        torch.cuda.synchronize()
        assert (got - want).abs().max().item() <= 1e-5 * want.abs().max().item()


@pytest.mark.gpu
def test_hymba_two_layers_kernel_path_matches_plain_path_on_card(h100):
    """Two layers of hymba-1.5b at full width, f32: prefill (128 tokens)
    and 2 decode steps through the kernels (flash_prefill at G = 5,
    ssd_prefill at ds 16, flash_decode at G = 5) against the plain path on
    the card, logits within 1e-3 x max(1, |logits|) (two layers of width
    1600-6482 matmuls and the 32256-row head over summation-order
    differences of ~1e-6); each kernel launched once per layer per call."""
    cfg = dataclasses.replace(get_config("hymba-1.5b"), n_layers=2)
    model = init_params(cfg, 1, dtype=torch.float32, device=h100)
    toks = torch.randint(0, cfg.vocab, (2, 128), device=h100,
                         generator=torch.Generator(device=h100).manual_seed(4))
    plain = HelixConfig(attn_backend="ref", prefill_backend="ref",
                        ssd_backend="ref")
    runs = {}
    for name, hx in (("kernel", HelixConfig()), ("plain", plain)):
        registry.reset_launch_counts()
        logits, state = make_prefill_step(cfg, hx, s_cap=256)(
            model, {"tokens": toks})
        state["total_len"] = torch.full((2,), 128, dtype=torch.int32,
                                        device=h100)
        step = build_serve_step(cfg, hx, return_logits=True)
        cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
        out = [logits]
        for _ in range(2):
            (cur, lg), state = step(model, state, cur)
            out.append(lg)
        torch.cuda.synchronize()
        runs[name] = (torch.stack(out)[..., :cfg.vocab],
                      registry.launch_counts())
    (kern, counts), (ref, plain_counts) = runs["kernel"], runs["plain"]
    assert (kern - ref).abs().max().item() <= 1e-3 * max(
        1.0, ref.abs().max().item())
    assert (counts["flash_prefill"], counts["ssd_prefill"],
            counts["flash_decode"]) == (2, 2, 4)
    assert sum(plain_counts.values()) == 0


@pytest.mark.gpu
def test_sampler_on_card_matches_cpu(h100):
    """The sampler's threefry words, uniforms and Gumbel noise on the card
    equal the CPU's bit for bit (each log is rounded from float64), and so
    do its tokens over a mixed greedy / top-k / top-p batch at V = 49155."""
    gen = torch.Generator().manual_seed(11)
    b, v = 8, 49155
    seeds = torch.randint(0, 2**31 - 1, (b,), generator=gen)
    idx = torch.randint(0, 5000, (b,), generator=gen).to(torch.int32)
    key = sampling.fold_in(sampling.prng_key(seeds), idx)
    bits = sampling.random_bits(key, v)
    dkey = sampling.fold_in(sampling.prng_key(seeds.to(h100)), idx.to(h100))
    dbits = sampling.random_bits(dkey, v)
    assert torch.equal(dbits.cpu(), bits)
    assert torch.equal(sampling.uniform(dbits).cpu(), sampling.uniform(bits))
    assert torch.equal(sampling.gumbel_noise(seeds.to(h100), idx.to(h100),
                                             v).cpu(),
                       sampling.gumbel_noise(seeds, idx, v))
    logits = torch.randn(b, v, generator=gen) * 3
    temp = torch.tensor([0.0, 0.9, 0.9, 1.2, 0.7, 0.9, 1.0, 0.5])
    topk = torch.tensor([0, 0, 5, 0, 40, 0, 0, 3], dtype=torch.int32)
    topp = torch.tensor([1.0, 1.0, 1.0, 0.85, 0.9, 0.5, 0.95, 1.0])
    args = (logits, temp, topk, topp, seeds, idx)
    want = sampling.sample_tokens(*args)
    got = sampling.sample_tokens(*(a.to(h100) for a in args))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-780m",
                                  "hymba-1.5b", "granite-moe-1b-a400m"])
def test_window_graph_equals_eager_window_on_card(h100, arch):
    """A window of 4 replayed from a captured CUDA graph equals the eager
    window bit for bit over the whole state, with one row frozen by its
    budget and top-p rows; the replay adds the launches its capture
    counted."""
    cfg = get_config(arch).reduced()
    model = init_params(cfg, 0, dtype=torch.float32, device=h100)
    hx = HelixConfig()
    b, n, t = 3, 4, 40
    toks = torch.randint(0, cfg.vocab, (b, t), device=h100,
                         generator=torch.Generator(device=h100).manual_seed(3))
    state = init_decode_state(cfg, b, 128, 1, dtype=torch.float32,
                              device=h100, sampling=True)
    _, pre = make_prefill_step(cfg, hx, s_cap=128)(model, {"tokens": toks})
    for key in ("kcache", "vcache", "ssm_conv", "ssm_state"):
        if key in state:
            state[key].copy_(pre[key])
    state["total_len"] = torch.full((b,), t, dtype=torch.int32, device=h100)
    state["sample_temp"].fill_(0.9)
    state["sample_topp"].fill_(0.85)
    state["sample_seed"].copy_(torch.tensor([5, 6, 7], device=h100))
    ctl = (toks[:, -1].to(torch.int32).contiguous(),
           torch.tensor([n, 2, n], dtype=torch.int32, device=h100),
           torch.full((b,), -1, dtype=torch.int32, device=h100),
           torch.zeros(b, n, dtype=torch.int32, device=h100),
           torch.zeros(b, dtype=torch.int32, device=h100))
    multistep = build_serve_multistep(cfg, hx, window=n)
    eager = {k: v.clone() for k, v in state.items()}
    graph = {k: v.clone() for k, v in state.items()}
    runner = WindowRunner(multistep)
    runner.prepare(model, graph, *ctl)
    registry.reset_launch_counts()
    e_out, e_cur, e_new = multistep(model, eager, *ctl)
    eager_counts = registry.launch_counts()
    registry.reset_launch_counts()
    g_out, g_cur, g_new = runner(model, graph, *ctl)
    torch.cuda.synchronize()
    assert runner.captures == 1 and runner.replays == 1
    assert registry.launch_counts() == eager_counts
    assert torch.equal(g_out, e_out) and torch.equal(g_cur, e_cur)
    assert set(g_new) == set(e_new)
    for key in e_new:
        assert torch.equal(g_new[key], e_new[key]), key
    moved = dict(g_new, total_len=g_new["total_len"].clone())
    key = "kcache" if "kcache" in moved else "ssm_state"
    moved[key] = moved[key].clone()
    with pytest.raises(RuntimeError, match="moved"):
        runner(model, moved, *ctl)


@pytest.mark.gpu
@pytest.mark.parametrize("kv8", [False, True])
def test_pool_pages_round_trip_through_host_on_card(h100, kv8):
    """A bf16 (or int8 + f32 scales) pool's pages gathered, copied to host
    numpy (bf16 as int16 views), back and scattered into other pages: the
    bytes exact, every plane written in place."""
    from repro_torch.core.kvcache import (gather_pool_pages,
                                          scatter_pool_pages)
    from repro_torch.serving.tier import device_planes, host_planes
    g = torch.Generator(device=h100).manual_seed(11)
    shape = (4, 17, 8, 16, 64)
    st = {"kcache": torch.randn(shape, generator=g, device=h100)
          .to(torch.bfloat16),
          "vcache": torch.randn(shape, generator=g, device=h100)
          .to(torch.bfloat16)}
    if kv8:
        st = quantize_decode_state({k: v.float() for k, v in st.items()})
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    src, dst = [3, 9, 1, 14], [16, 2, 7, 5]
    want = {k: v[:, src].clone() for k, v in st.items()}
    host = host_planes({k: v.cpu() for k, v in gather_pool_pages(st, src)
                        .items()})
    back = device_planes(host, {k: v.dtype for k, v in st.items()}, h100)
    scatter_pool_pages(st, dst, back)
    for k, v in st.items():
        assert v.data_ptr() == ptrs[k], k
        assert torch.equal(v[:, dst].view(torch.uint8),
                           want[k].view(torch.uint8)), k


@pytest.mark.gpu
def test_preempt_restore_between_graph_windows_on_card(h100):
    """Two full-width granite-3-2b layers (bf16, paged, top-p windows of
    4): one request preempted between two windows of the captured graph
    and restored from the host tier; no recapture, every window a replay,
    and the streams of the run never preempted."""
    from repro_torch.serving import DecodeEngine, Request
    cfg = dataclasses.replace(get_config("granite-3-2b"), n_layers=2)
    model = init_params(cfg, 0, dtype=torch.bfloat16, device=h100)
    hx = HelixConfig(paged_kv=True)
    top_p = sampling.SamplingParams("top_p", temperature=0.9, top_p=0.85,
                                    seed=1)
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=g).tolist()
               for n in (300, 120, 240, 180)]

    def run(preempt_at):
        eng = DecodeEngine(
            cfg, model, build_serve_step(cfg, hx), make_prefill_step(cfg, hx),
            max_batch=4, max_seq=340, hx=hx, dtype=torch.bfloat16,
            device=h100, sampling=top_p, decode_window=4,
            serve_multistep=build_serve_multistep(cfg, hx, window=4),
            host_pages=512)
        reqs = [Request(rid=i, prompt=p, max_new_tokens=24)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        step = 0
        while eng.pending():
            if step == preempt_at:
                assert eng.preempt(next(r.rid for r in eng.slots
                                        if r is not None
                                        and r.state == "decode"))
            eng.step()
            step += 1
        return [r.out_tokens for r in reqs], eng

    base, _ = run(-1)
    streams, eng = run(2)
    summ = eng.metrics.summary()
    assert summ["preempts"] == summ["spills"] == summ["restores"] == 1
    assert summ["resume_reprefill_chunks"] == 0
    runner = eng.window_runner
    assert runner.captures == 1 and runner.replays == eng.decode_syncs
    assert streams == base


# ------------------------------------------ whisper-base, phi-3-vision
@pytest.mark.gpu
@pytest.mark.parametrize("hsz", [64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_kernel_noncausal_and_cross_on_card(h100, dtype, hsz):
    """flash_prefill non-causal: the encoder's self-attention at T = S =
    150 and the decoder's cross-attention at T = 40 over S = 150 (neither a
    multiple of the 64-row blocks), with per-row kv lengths, against the
    plain version."""
    g = torch.Generator(device=h100).manual_seed(hsz)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=h100).to(dtype)
    lens = torch.tensor([150, 97], dtype=torch.int32, device=h100)
    for t in (150, 40):
        q, k, v = rnd(2, t, 8, hsz), rnd(2, 150, 8, hsz), rnd(2, 150, 8, hsz)
        for seq_lens in (None, lens):
            got = flash_prefill(q, k, v, causal=False, seq_lens=seq_lens)
            want = flash_prefill_ref(q, k, v, causal=False,
                                     seq_lens=seq_lens)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=PREFILL_TOL[dtype],
                                       rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 100])
@pytest.mark.parametrize("paged", [False, True], ids=["fixed", "paged"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_decode_kernel_at_hsz96_on_card(h100, quant, paged, window):
    """flash_decode at phi-3-vision's head size 96 (8 MHA heads, G = 1),
    kvp 2, with the fused append and windows 0 and 100: kernel vs plain
    (f32), the appended rows bit for bit, fixed and paged, fp and int8."""
    _decode_group_case(h100, quant, paged, g=1, kh=8, seed=96, hsz=96,
                       window=window)


@pytest.mark.gpu
@pytest.mark.parametrize("kvp", [1, 4])
@pytest.mark.parametrize("hsz", [64, 96])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_decode_kernel_contiguous_on_card(h100, dtype, hsz, kvp):
    """flash_decode's contiguous layout (the cross-attention's static K/V,
    rank r holding slots [r * s_loc, (r + 1) * s_loc)) over 1500 valid of
    1504 slots, B = 4, 8 heads: kernel vs plain, pruned == dense bit for
    bit."""
    g = torch.Generator(device=h100).manual_seed(7 * kvp + hsz)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=h100).to(dtype)
    q, k, v = rnd(4, 8, hsz), rnd(4, 8, 1504, hsz), rnd(4, 8, 1504, hsz)
    tl = torch.tensor(1500, dtype=torch.int32, device=h100)
    kw = dict(kvp=kvp, n_ranks=kvp, rank=0, rr_block=RR, window=0,
              contiguous=True, slot_offset=0, k_new=None, v_new=None)
    o1, l1 = flash_decode_shards(q, k, v, tl, **kw)
    o0, l0 = flash_decode_shards(q, k, v, tl, prune=False, **kw)
    o2, l2 = flash_decode_shards_plain(
        q, k, v, tl, scale=hsz ** -0.5,
        block_s=kernel_block_s(512, 1504 // kvp), **kw)
    torch.cuda.synchronize()
    tol = TOL_DECODE[dtype]
    torch.testing.assert_close(o1, o2, atol=tol, rtol=0)
    torch.testing.assert_close(l1, l2, atol=ATOL, rtol=RTOL)
    assert torch.equal(o1, o0) and torch.equal(l1, l0)


TOL_DECODE = {torch.float32: ATOL, torch.bfloat16: 1.6e-2}


@pytest.mark.gpu
def test_prefix_pass_refuses_hsz96_on_card(h100):
    """prefix_pass is not built at head size 96 and says so (ValueError),
    launching nothing."""
    q = torch.zeros(2, 8, 96, device=h100)
    k = torch.zeros(3, 8, 16, 96, device=h100)
    tab = torch.tensor([[1], [2]], dtype=torch.int32, device=h100)
    gid = torch.zeros(2, dtype=torch.int32, device=h100)
    registry.reset_launch_counts()
    with pytest.raises(ValueError, match="prefix_pass kernel takes hsz"):
        prefix_pass(q, k, k.clone(), 16, tab, gid, gid + 1, kvp=1)
    assert registry.launch_counts()["prefix_pass"] == 0


def _two_layer_paths(h100, arch, batch_fn, t):
    """Two layers of ``arch`` at full width, f32: prefill and 2 decode steps
    through the kernels against the plain path on the card."""
    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    if cfg.is_encdec:
        cfg = dataclasses.replace(cfg, enc_layers=2)
    model = init_params(cfg, 1, dtype=torch.float32, device=h100)
    batch = batch_fn(cfg, torch.Generator(device=h100).manual_seed(4))
    plain = HelixConfig(attn_backend="ref", prefill_backend="ref")
    runs = {}
    for name, hx in (("kernel", HelixConfig()), ("plain", plain),
                     ("kernel kvp=4", HelixConfig(kvp=4))):
        registry.reset_launch_counts()
        logits, state = make_prefill_step(cfg, hx, s_cap=t + 64)(model,
                                                                 batch)
        state["total_len"] = torch.full((2,), t, dtype=torch.int32,
                                        device=h100)
        step = build_serve_step(cfg, hx, return_logits=True)
        cur = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
        out = [logits]
        for _ in range(2):
            (cur, lg), state = step(model, state, cur)
            out.append(lg)
        torch.cuda.synchronize()
        runs[name] = (torch.stack(out)[..., :cfg.vocab],
                      registry.launch_counts())
    ref = runs["plain"][0]
    for name in ("kernel", "kernel kvp=4"):
        got = runs[name][0]
        assert (got - ref).abs().max().item() <= 1e-3 * max(
            1.0, ref.abs().max().item()), name
        assert torch.equal(got.argmax(-1), ref.argmax(-1)), name
    assert sum(runs["plain"][1].values()) == 0
    return runs["kernel"][1]


@pytest.mark.gpu
def test_whisper_two_layers_kernel_path_matches_plain_path_on_card(h100):
    """whisper-base at full width, 2 encoder and 2 decoder layers, f32, 2
    rows of 1500 frames and 64 tokens: kernel path (B2 non-causal in the
    encoder and the cross-attention, B2 causal, B1 fused and contiguous)
    and kvp 4 against the plain path; launches: B2 2 + 2 + 2, B1 2 x 2
    layers x 2 steps."""
    def batch(cfg, g):
        return {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=g,
                                        device=h100),
                "enc_frames": torch.randn(2, 1500, cfg.d_model, generator=g,
                                          device=h100)}
    counts = _two_layer_paths(h100, "whisper-base", batch, 64)
    assert (counts["flash_prefill"], counts["flash_decode"]) == (6, 8)


@pytest.mark.gpu
def test_phi3_two_layers_kernel_path_matches_plain_path_on_card(h100):
    """phi-3-vision at full width, 2 layers, f32 (heads of 96), 2 rows of
    256 patches + 64 tokens: kernel path and kvp 4 against the plain path;
    launches: B2 once a layer, B1 once a layer a step."""
    def batch(cfg, g):
        return {"tokens": torch.randint(0, cfg.vocab, (2, 320), generator=g,
                                        device=h100),
                "patch_embeds": torch.randn(2, 256, cfg.d_model, generator=g,
                                            device=h100)}
    counts = _two_layer_paths(h100, "phi-3-vision-4.2b", batch, 320)
    assert (counts["flash_prefill"], counts["flash_decode"]) == (2, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("kvp", [2, 4])
def test_rank_decode_launch_equals_emulated_shard_on_card(h100, kvp):
    """Helix across ranks: each rank's B1 launch (``n_ranks=1, rank=k``,
    fused append) equals shard k of the emulated one-launch call bit for
    bit, outputs, LSEs and appended caches, bf16 at granite's heads."""
    g = torch.Generator(device=h100).manual_seed(90 + kvp)
    b, s = 4, 1024
    tl = torch.tensor([s, 700, 513, 1], dtype=torch.int32, device=h100)
    rnd = lambda *sh: torch.randn(*sh, generator=g, device=h100).to(  # noqa
        torch.bfloat16)
    q, kn, vn = rnd(b, 32, 64), rnd(b, 8, 64), rnd(b, 8, 64)
    k, v = rnd(b, 8, s, 64), rnd(b, 8, s, 64)
    ke, ve = k.clone(), v.clone()
    out, lse = flash_decode_shards(q, ke, ve, tl, kvp=kvp, n_ranks=kvp,
                                   rank=0, rr_block=RR, k_new=kn, v_new=vn)
    s_loc = s // kvp
    for r in range(kvp):
        sl = slice(r * s_loc, (r + 1) * s_loc)
        kr, vr = k[:, :, sl].clone(), v[:, :, sl].clone()
        o, l_ = flash_decode_shards(q, kr, vr, tl, kvp=kvp, n_ranks=1,
                                    rank=r, rr_block=RR, k_new=kn, v_new=vn)
        torch.cuda.synchronize()
        assert torch.equal(o[0], out[r]) and torch.equal(l_[0], lse[r])
        assert torch.equal(kr, ke[:, :, sl]) and torch.equal(vr, ve[:, :, sl])


@pytest.mark.gpu
def test_nccl_world_one_step_equals_emulated_step_on_card(h100, tmp_path):
    """The group API over an NCCL group of one rank (this process):
    reduced granite-3-2b's rank prefill caches and decode-step logits
    equal the emulated kvp = 1 path's bit for bit, and its prefill logits
    the single-process ``forward(last_only=True)``'s."""
    import torch.distributed as dist

    from repro_torch.core.dist import HelixGroup, init_ranks
    from repro_torch.models.shard import shard_model
    cfg = get_config("granite-3-2b").reduced()
    model = init_params(cfg, 0, dtype=torch.float32, device=h100)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=h100,
                         generator=torch.Generator(device=h100).manual_seed(3))
    hx = HelixConfig()
    l0, st = make_prefill_step(cfg, hx)(model, {"tokens": toks})
    nxt = torch.argmax(l0[:, :cfg.vocab], dim=-1).to(torch.int32)
    init_ranks(0, 1, backend="nccl",
               init_method=f"file://{tmp_path / 'rendezvous'}")
    try:
        group = HelixGroup(1, device=h100)
        local = shard_model(model, cfg, group)
        r0, rst = make_prefill_step(cfg, hx, group=group)(local,
                                                          {"tokens": toks})
        assert all(torch.equal(st[k], rst[k]) for k in ("kcache", "vcache"))
        assert torch.equal(r0, forward(cfg, model, toks,
                                       last_only=True)[0][:, -1])
        (_, l1), st = build_serve_step(cfg, hx, return_logits=True)(
            model, st, nxt)
        (_, r1), rst = build_serve_step(cfg, hx, return_logits=True,
                                        group=group)(local, rst, nxt)
        torch.cuda.synchronize()
        assert torch.equal(l1, r1)
        assert group.calls["all_reduce"] == 4 * cfg.n_layers
    finally:
        dist.destroy_process_group()
