"""Port kernels vs the JAX reference, on the CPU.

Integer range functions must match exactly.  Float outputs (f32) hold to
``ATOL = RTOL = 2e-5``: both sides compute the same softmax in f32 but sum
in different orders (einsum vs the Pallas interpreter's blocked online
softmax), which moves results by a few ulps of values of order 1.  CUDA
launches are tested on the card only (``test_torch_gpu.py``); here the
wrappers take their plain versions because the tensors lie on the CPU.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode import flash_decode_ref as jax_decode_ref
from repro.kernels.flash_decode.kernel import (_append_slot as jax_append_slot,
                                               prune_block_range as jax_prune,
                                               valid_slot_span as jax_span)
from repro.kernels.flash_prefill import flash_prefill_ref as jax_prefill_ref
from repro.kernels.flash_prefill.ops import flash_prefill as jax_flash_prefill
from repro.kernels.flash_prefill.kernel import \
    prefill_block_range as jax_prefill_range
from repro.kernels.pruning import phys_block as jax_phys_block
from repro.utils import round_up as jax_round_up

from repro_torch.core.helix import append_kv
from repro_torch.core.kvcache import quantize_decode_state, state_to_paged
from repro_torch.kernels import build, pruning, registry
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_shards
from repro_torch.kernels.flash_decode.ops import decode_chunks
from repro_torch.kernels.flash_decode.ref import (CHUNK_S, TILE_S,
                                                  cold_state, merge_chunks)
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.ssd_prefill import ssd_prefill
from repro_torch.kernels.ssd_prefill.ops import chunk_len, chunk_spans

ATOL = RTOL = 2e-5      # f32, different summation order (see module doc)
B, QH, KH, HSZ, S_LOC, RR = 4, 4, 2, 32, 64, 16


@pytest.fixture(autouse=True)
def _few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np(x):
    return np.asarray(x)


def _decode_inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return (f(B, QH, HSZ), f(B, KH, S_LOC, HSZ), f(B, KH, S_LOC, HSZ),
            f(B, KH, HSZ), f(B, KH, HSZ))


def _lengths(kvp):
    # empty, one token, a partial block, the full global capacity
    return np.array([0, 1, 37, kvp * S_LOC], np.int32)


# ------------------------------------------------------------- integers
def test_integer_range_functions_match_reference():
    tls = np.arange(-1, 300, 7, dtype=np.int32)
    for kvp, rr, bs, s_true in ((1, 16, 32, 64), (2, 16, 64, 100),
                                (4, 8, 32, 96)):
        for rank in range(kvp):
            for window in (0, 5, 40):
                for off in (0, 3):
                    for contiguous in (False, True):
                        kw = dict(kvp=kvp, rr_block=rr, s_true=s_true,
                                  contiguous=contiguous)
                        a = jax_span(jnp.asarray(tls), rank, off, window, **kw)
                        b = pruning.valid_slot_span(torch.from_numpy(tls),
                                                    rank, off, window, **kw)
                        for x, y in zip(a, b):
                            np.testing.assert_array_equal(_np(x), y.numpy())
                        a = jax_prune(jnp.asarray(tls), rank, off, window,
                                      block_s=bs, **kw)
                        b = pruning.prune_block_range(
                            torch.from_numpy(tls), rank, off, window,
                            block_s=bs, **kw)
                        for x, y in zip(a, b):
                            np.testing.assert_array_equal(_np(x), y.numpy())
        np.testing.assert_array_equal(
            _np(jax_append_slot(jnp.asarray(tls), kvp, rr, 128)),
            pruning.append_slot(torch.from_numpy(tls), kvp, rr, 128).numpy())
    steps, lo, nb = np.meshgrid(np.arange(6), np.arange(5), np.arange(4))
    np.testing.assert_array_equal(
        _np(jax_phys_block(jnp.asarray(steps), jnp.asarray(lo),
                           jnp.asarray(nb), 5)),
        pruning.phys_block(torch.from_numpy(steps), torch.from_numpy(lo),
                           torch.from_numpy(nb), 5).numpy())
    for causal in (True, False):
        for window in (0, 20):
            for qi in range(4):
                lens = np.array([0, 5, 63, 200], np.int32)
                offs = np.array([0, 17, 3, 40], np.int32)
                kw = dict(causal=causal, blk_q=16, blk_k=32, s_true=150)
                a = jax_prefill_range(qi, jnp.asarray(lens), jnp.asarray(offs),
                                      window, **kw)
                b = pruning.prefill_block_range(qi, torch.from_numpy(lens),
                                                torch.from_numpy(offs),
                                                window, **kw)
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(_np(x), y.numpy())


# ---------------------------------------------------------- flash_decode
@pytest.mark.parametrize("contiguous", [False, True], ids=["rr", "contig"])
@pytest.mark.parametrize("kvp", [1, 2, 4])
def test_flash_decode_plain_matches_reference_ref(kvp, contiguous):
    q, k, v, _, _ = _decode_inputs(kvp)
    tl = _lengths(kvp)
    for rank in range(kvp):
        for window in (0, 24):
            for slot_offset in (0, 5):
                if contiguous:
                    ref = jax_decode_ref(q, k, v, tl, 0, kvp=1, rr_block=RR,
                                         window=window,
                                         slot_offset=rank * S_LOC + slot_offset)
                else:
                    ref = jax_decode_ref(q, k, v, tl, rank, kvp=kvp,
                                         rr_block=RR, window=window,
                                         slot_offset=slot_offset)
                for prune in (True, False):
                    out, lse = flash_decode(
                        torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), torch.from_numpy(tl), rank,
                        kvp=kvp, rr_block=RR, window=window,
                        contiguous=contiguous, slot_offset=slot_offset,
                        prune=prune)
                    np.testing.assert_allclose(out.numpy(), _np(ref[0]),
                                               atol=ATOL, rtol=RTOL)
                    np.testing.assert_allclose(lse.numpy(), _np(ref[1]),
                                               atol=ATOL, rtol=RTOL)
                    # the empty row: zero output, lse = NEG_INF
                    assert np.all(out.numpy()[0] == 0)
                    assert np.all(lse.numpy()[0] == -1e30)


@pytest.mark.parametrize("kvp", [1, 2, 4])
def test_flash_decode_fused_append_matches_reference_kernel(kvp):
    """Every rank of a fused-append call vs the reference kernel run by the
    Pallas interpreter: outputs, LSEs and the appended caches."""
    q, k, v, kn, vn = _decode_inputs(10 + kvp)
    tl = _lengths(kvp)
    for rank in range(kvp):
        window = 24 if rank % 2 else 0
        ref = jax_flash_decode(q, k, v, jnp.asarray(tl), rank, kvp=kvp,
                               rr_block=RR, window=window, block_s=32,
                               k_new=kn, v_new=vn, interpret=True)
        kt, vt = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
        out, lse, kc, vc = flash_decode(
            torch.from_numpy(q), kt, vt, torch.from_numpy(tl), rank, kvp=kvp,
            rr_block=RR, window=window, k_new=torch.from_numpy(kn),
            v_new=torch.from_numpy(vn))
        np.testing.assert_allclose(out.numpy(), _np(ref[0]), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(lse.numpy(), _np(ref[1]), atol=ATOL,
                                   rtol=RTOL)
        # appended caches: only the owner rank's row changes; exact
        np.testing.assert_array_equal(kc.numpy(), _np(ref[2]))
        np.testing.assert_array_equal(vc.numpy(), _np(ref[3]))
        assert kc is kt                  # in place


def test_flash_decode_unfused_matches_reference_kernel():
    q, k, v, _, _ = _decode_inputs(3)
    tl = _lengths(2)
    for contiguous in (False, True):
        ref = jax_flash_decode(q, k, v, jnp.asarray(tl), 1, kvp=2,
                               rr_block=RR, window=24, block_s=32,
                               contiguous=contiguous, prune=False,
                               interpret=True)
        out, lse = flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(tl), 1,
                                kvp=2, rr_block=RR, window=24,
                                contiguous=contiguous, prune=False)
        np.testing.assert_allclose(out.numpy(), _np(ref[0]), atol=ATOL,
                                   rtol=RTOL)
        np.testing.assert_allclose(lse.numpy(), _np(ref[1]), atol=ATOL,
                                   rtol=RTOL)


def test_flash_decode_shards_is_per_rank_flash_decode():
    """The multi-rank interface equals one single-shard call per rank on
    the shard slices, including the in-place fused append."""
    kvp = 4
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.standard_normal((B, QH, HSZ)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal(
        (B, KH, kvp * S_LOC, HSZ)).astype(np.float32))
    v = torch.randn_like(k)
    kn, vn = torch.randn(B, KH, HSZ), torch.randn(B, KH, HSZ)
    tl = torch.from_numpy(_lengths(kvp))
    k1, v1 = k.clone(), v.clone()
    outs, lses = flash_decode_shards(q, k1, v1, tl, kvp=kvp, n_ranks=kvp,
                                     rr_block=RR, window=24, k_new=kn,
                                     v_new=vn)
    for r in range(kvp):
        sl = slice(r * S_LOC, (r + 1) * S_LOC)
        k2, v2 = k[:, :, sl].clone(), v[:, :, sl].clone()
        o, l, k2, v2 = flash_decode(q, k2, v2, tl, r, kvp=kvp, rr_block=RR,
                                    window=24, k_new=kn, v_new=vn)
        assert torch.equal(outs[r], o) and torch.equal(lses[r], l)
        assert torch.equal(k1[:, :, sl], k2) and torch.equal(v1[:, :, sl], v2)


# ------------------------------------------- chunks of the decode sweep
def test_decode_chunk_partition_matches_reference_spans():
    """The chunks the decode kernels sweep and merge, exactly: with pruning,
    those holding the tiles of the reference's valid span; without, every
    chunk of the padded capacity; and the counts of CTAs that sweep."""
    tls = np.concatenate([np.arange(-1, 1400, 29), [256, 257, 512, 513,
                                                     1024, 1025]])
    tls = tls.astype(np.int32)
    for kvp, rr, s_true in ((1, 16, 600), (2, 16, 600), (4, 8, 1100)):
        for rank in range(kvp):
            for window in (0, 5, 300):
                for off in (0, 3):
                    for contiguous in (False, True):
                        kw = dict(kvp=kvp, rr_block=rr, s_true=s_true,
                                  contiguous=contiguous)
                        lo, hi = (_np(x) for x in jax_span(
                            jnp.asarray(tls), rank, off, window, **kw))
                        t0, t1 = lo // TILE_S, -(-hi // TILE_S)
                        live = hi > lo
                        want0 = np.where(live, t0 * TILE_S // CHUNK_S, 0)
                        want1 = np.where(live, -(-t1 * TILE_S // CHUNK_S), 0)
                        c0, c1 = pruning.decode_chunk_range(
                            torch.from_numpy(tls), rank, off, window, **kw)
                        np.testing.assert_array_equal(c0.numpy(), want0)
                        np.testing.assert_array_equal(c1.numpy(), want1)
                        d0, d1 = pruning.decode_chunk_range(
                            torch.from_numpy(tls), rank, off, window,
                            prune=False, n_tiles=40, **kw)
                        assert (d0 == 0).all() and (d1 == 5).all()
    # every chunk at or past 256 * c, and the padded capacity's chunks
    assert decode_chunks(600, 512) == 4 and decode_chunks(4096, 512) == 16
    assert decode_chunks(1088, 512) == 6 and decode_chunks(100, 128) == 1
    tl = torch.tensor([4096] * 8, dtype=torch.int32)
    assert pruning.decode_work_items(tl, kvp=1, n_ranks=1, rank=0,
                                     kv_heads=8, rr_block=16,
                                     s_true=4096) == 1024
    assert pruning.decode_work_items(tl, kvp=1, n_ranks=1, rank=0,
                                     kv_heads=8, rr_block=16, s_true=4096,
                                     chunks_per_cta=2) == 512
    tl = torch.tensor([700, 1000, 1], dtype=torch.int32)
    assert pruning.decode_work_items(tl, kvp=1, n_ranks=1, rank=0,
                                     kv_heads=1, rr_block=16, s_true=1088,
                                     chunks_per_cta=2) == 2 + 2 + 1
    tl = torch.tensor([4352] * 8, dtype=torch.int32)
    assert pruning.decode_work_items(
        tl, kvp=1, n_ranks=1, rank=0, kv_heads=8, rr_block=16, s_true=4352,
        group_np=torch.full((8,), 256, dtype=torch.int32),
        page_rows=16) == 64
    gid = torch.tensor([0, 0, 0, 0, 4, 4, 4, 4], dtype=torch.int32)
    assert pruning.prefix_work_items(gid, torch.full((8,), 256), n_ranks=1,
                                     kv_heads=8, page_rows=16) == 256


# -------------------------------- host partitions of B3 and B5's launches
@pytest.mark.parametrize("lc", [32, 64])
@pytest.mark.parametrize("t", [1, 7, 8, 37, 64, 65, 96, 1024, 4097])
def test_ssd_chunk_spans_cover_t_in_order(t, lc):
    """The chunks of ssd_prefill, as the kernel's blocks take them: the
    reference wrapper's chunk (``min(lc, round_up(t, 8))``) and count
    (``round_up(t, chunk) / chunk``), back to back from token 0 to t, every
    chunk full but a ragged last one."""
    spans = chunk_spans(t, lc)
    c = min(lc, jax_round_up(t, 8))
    assert chunk_len(lc, t) == c
    assert len(spans) == jax_round_up(t, c) // c
    assert spans[0][0] == 0 and spans[-1][0] + spans[-1][1] == t
    for (s0, n0), (s1, _) in zip(spans, spans[1:]):
        assert s0 + n0 == s1 and n0 == c
    assert 1 <= spans[-1][1] <= c


def _partials(rng, n, c, r, hsz):
    m = rng.standard_normal((n, c, r)).astype(np.float32) * 3
    l = rng.uniform(1, 5, (n, c, r)).astype(np.float32)
    acc = rng.standard_normal((n, c, r, hsz)).astype(np.float32)
    return [torch.from_numpy(x) for x in (acc, m, l)]


def test_merge_chunks_empty_partials_are_identities_bit_for_bit():
    """The fold of chunk partials skips empty ones (m = NEG_INF, l = 0,
    acc = 0) exactly, wherever they sit, and takes a lone partial as it
    is; a fold of empties is the cold state."""
    rng = np.random.default_rng(21)
    acc, m, l = _partials(rng, 3, 4, 2, 32)
    base = merge_chunks((acc, m, l))
    ca, cm, cl = cold_state(3, 2, 32)
    for at in (0, 2, 4):            # before, inside, after the real ones
        ins = (torch.cat([acc[:, :at], ca[:, None], acc[:, at:]], 1),
               torch.cat([m[:, :at], cm[:, None], m[:, at:]], 1),
               torch.cat([l[:, :at], cl[:, None], l[:, at:]], 1))
        got = merge_chunks(ins)
        assert all(torch.equal(x, y) for x, y in zip(got, base))
    take = torch.tensor([[True, False, True, True]] * 3)
    skipped = merge_chunks((acc, m, l), take)
    dropped = merge_chunks((acc[:, [0, 2, 3]], m[:, [0, 2, 3]],
                            l[:, [0, 2, 3]]))
    assert all(torch.equal(x, y) for x, y in zip(skipped, dropped))
    one = merge_chunks((acc[:, :1], m[:, :1], l[:, :1]))
    assert all(torch.equal(x, y[:, 0]) for x, y in zip(one, (acc, m, l)))
    empty = merge_chunks((ca[:, None].repeat(1, 3, 1, 1),
                          cm[:, None].repeat(1, 3, 1),
                          cl[:, None].repeat(1, 3, 1)))
    assert all(torch.equal(x, y) for x, y in zip(empty, (ca, cm, cl)))


S_CH = 608       # slots per shard in the chunk tests: chunks of 256, 256, 96


def _chunk_case(mode, kvp):
    """Operands over shards of S_CH slots (three chunks, the last partial):
    rows of length 0, a chunk boundary (256 local slots), one slot past it
    (the appended row lands in the next chunk's first slot), mid-chunk and
    full; ``paged``: the same cache in 2-row pages under a shuffled table,
    ``int8``: quantized with per-slot scales."""
    rng = np.random.default_rng(30 + kvp)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    b, s_cap = 5, kvp * S_CH
    q, kn, vn = f(b, QH, HSZ), f(b, KH, HSZ), f(b, KH, HSZ)
    tl = np.array([0, 256 * kvp, 256 * kvp + 1, 777 * kvp // 2,
                   s_cap], np.int32)
    fixed = {"kcache": torch.from_numpy(f(1, b, KH, s_cap, HSZ)),
             "vcache": torch.from_numpy(f(1, b, KH, s_cap, HSZ))}
    if mode == "int8":
        fixed = quantize_decode_state(fixed)
    case = dict(q=q, kn=kn, vn=vn, tl=tl, fixed=fixed, tables=None)
    if mode == "paged":
        page = kvp * 8                      # 8 rows per rank and page
        mp = S_CH // 8
        tab = (1 + rng.permutation(b * mp)).reshape(b, mp).astype(np.int32)
        case["paged"] = state_to_paged(fixed, tab, 1 + b * mp, kvp, page)
        case["tables"] = tab
    return case


def _shard(x, r, kvp, tables):
    """Rank r's slots (fixed) or rows of every page (paged) of a plane."""
    if tables is None:
        return x[:, :, r * S_CH:(r + 1) * S_CH]
    ps = x.shape[2] // kvp
    return x[:, :, r * ps:(r + 1) * ps]


@pytest.mark.parametrize("mode", ["rr", "contig", "paged", "int8"])
def test_chunked_plain_decode_matches_reference(mode):
    """The plain decode, chunk partials folded in order, over shards of
    three chunks against the reference's oracle (fixed fp) and interpreted
    kernel (2e-5), kvp 2: rank 0 with no window, rank 1 with a window of
    300 (starting mid-chunk); pruned == dense bit for bit; with the fused
    append, which lands in a chunk's first slot for the row one past the
    boundary, == append then attend."""
    kvp = 2
    c = _chunk_case(mode, kvp)
    st = c.get("paged", c["fixed"])
    keys = [k for k in ("kcache", "vcache", "kscale", "vscale") if k in st]
    planes = [st[k][0] for k in keys]
    tab = None if c["tables"] is None else torch.from_numpy(c["tables"])
    contiguous = mode == "contig"
    q, tl = torch.from_numpy(c["q"]), torch.from_numpy(c["tl"])
    for rank, window in ((0, 0), (1, 300)):
        sh = [_shard(x, rank, kvp, c["tables"]) for x in planes]
        sc = dict(zip(("kscale", "vscale"), sh[2:]))
        kw = dict(kvp=kvp, rr_block=RR, window=window,
                  contiguous=contiguous, block_tables=tab, **sc)
        got = flash_decode(q, sh[0], sh[1], tl, rank, **kw)
        dense = flash_decode(q, sh[0], sh[1], tl, rank, prune=False,
                             **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, dense))
        jsc = {k: v.numpy() for k, v in sc.items()}
        ref = jax_flash_decode(
            c["q"], sh[0].numpy(), sh[1].numpy(), jnp.asarray(c["tl"]),
            rank, kvp=kvp, rr_block=RR, window=window,
            contiguous=contiguous, interpret=True,
            block_tables=c["tables"], **jsc)
        for x, y in zip(got, ref):
            np.testing.assert_allclose(x.numpy(), _np(y), atol=ATOL,
                                       rtol=RTOL)
        if mode == "rr":
            oracle = jax_decode_ref(c["q"], sh[0].numpy(), sh[1].numpy(),
                                    c["tl"], rank, kvp=kvp, rr_block=RR,
                                    window=window)
            for x, y in zip(got, oracle):
                np.testing.assert_allclose(x.numpy(), _np(y), atol=ATOL,
                                           rtol=RTOL)
    if mode == "rr":                # fused append == append then attend
        tl1 = torch.clamp(tl, min=1)
        kn, vn = torch.from_numpy(c["kn"]), torch.from_numpy(c["vn"])
        ka, va = planes[0].clone(), planes[1].clone()
        fused = flash_decode_shards(q, ka, va, tl1, kvp=kvp, n_ranks=kvp,
                                    rr_block=RR, k_new=kn, v_new=vn)
        kb, vb = planes[0].clone(), planes[1].clone()
        append_kv(kb, vb, kn, vn, tl1, kvp=kvp, rr_block=RR)
        unfused = flash_decode_shards(q, kb, vb, tl1, kvp=kvp, n_ranks=kvp,
                                      rr_block=RR)
        assert torch.equal(ka, kb) and torch.equal(va, vb)
        assert all(torch.equal(x, y) for x, y in zip(fused, unfused))
        # the row one past the boundary appended into rank 0's slot 256
        assert not torch.equal(ka[2, :, 256], planes[0][2, :, 256])


# --------------------------------------------------------- flash_prefill
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "cross"])
def test_flash_prefill_plain_matches_reference_ref(causal):
    rng = np.random.default_rng(5)
    b, t, s = 3, 24, 24 if causal else 40
    q = rng.standard_normal((b, t, QH, HSZ)).astype(np.float32)
    k = rng.standard_normal((b, s, KH, HSZ)).astype(np.float32)
    v = rng.standard_normal((b, s, KH, HSZ)).astype(np.float32)
    lens = np.array([0, s - 7, s], np.int32)
    offs = np.array([0, 3, 11], np.int32)
    for window in (0, 9):
        for q_offset, seq_lens in ((0, None), (offs, lens)):
            if seq_lens is None:
                ref = jax_prefill_ref(q, k, v, causal=causal, window=window)
            else:
                # the reference oracle takes one scalar q_offset: row by row
                ref = np.concatenate([_np(jax_prefill_ref(
                    q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=causal,
                    window=window, q_offset=int(offs[i]),
                    seq_lens=lens[i:i + 1])) for i in range(b)])
            tq = q_offset if np.isscalar(q_offset) else torch.from_numpy(
                q_offset)
            tlens = None if seq_lens is None else torch.from_numpy(seq_lens)
            out = flash_prefill(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), causal=causal,
                                window=window, q_offset=tq, seq_lens=tlens)
            np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL,
                                       rtol=RTOL)
            if seq_lens is not None:
                assert np.all(out.numpy()[0] == 0)      # lens == 0 -> zeros


def _paged_prefill_case(seed, page):
    """q [2, 16, QH, HSZ] at per-request offsets and lengths, and one K/V
    of S = 32 slots both in the fixed layout and as pool pages under a
    shuffled table whose unused entries point at the sink page 0, filled
    with finite garbage (the reference masks it, the port zero-loads it)."""
    rng = np.random.default_rng(seed)
    b, t, s = 2, 16, 32
    mp = s // page
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    q, k, v = f(b, t, QH, HSZ), f(b, s, KH, HSZ), f(b, s, KH, HSZ)
    lens = np.array([s - 7, 20], np.int32)
    offs = np.array([s - 7 - t, 3], np.int32)
    need = -(-lens // page)
    n_pool = 1 + int(need.sum())
    perm = 1 + rng.permutation(n_pool - 1)
    tables = np.zeros((b, mp), np.int32)
    pool_k = 1e4 * np.sign(f(n_pool, KH, page, HSZ))
    pool_v = 1e4 * np.sign(f(n_pool, KH, page, HSZ))
    i = 0
    for r in range(b):
        for p in range(need[r]):
            tables[r, p] = perm[i]
            pool_k[perm[i]] = k[r, p * page:(p + 1) * page].transpose(1, 0, 2)
            pool_v[perm[i]] = v[r, p * page:(p + 1) * page].transpose(1, 0, 2)
            i += 1
    return q, k, v, pool_k, pool_v, tables, lens, offs


@pytest.mark.parametrize("window", [0, 6], ids=["causal", "window"])
@pytest.mark.parametrize("page", [8, 16])
def test_flash_prefill_paged_plain_matches_reference_kernel(page, window):
    """Paged mode vs the reference's paged Pallas kernel (interpreted), with
    per-request offsets and lengths and a garbage sink page."""
    q, _, _, pk, pv, tab, lens, offs = _paged_prefill_case(20 + page, page)
    ref = jax_flash_prefill(q, pk, pv, causal=True, window=window,
                            q_offset=jnp.asarray(offs),
                            seq_lens=jnp.asarray(lens), blk_q=8,
                            block_tables=jnp.asarray(tab), interpret=True)
    out = flash_prefill(torch.from_numpy(q), torch.from_numpy(pk),
                        torch.from_numpy(pv), causal=True, window=window,
                        q_offset=torch.from_numpy(offs),
                        seq_lens=torch.from_numpy(lens),
                        block_tables=torch.from_numpy(tab))
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("page", [8, 16])
def test_flash_prefill_paged_equals_fixed(page):
    """The port's paged mode == its fixed layout, bit for bit, causal and
    windowed, and a lens == 0 row is zero in both."""
    q, k, v, pk, pv, tab, lens, offs = _paged_prefill_case(30 + page, page)
    t = lambda x: torch.from_numpy(x)
    for window in (0, 6):
        for ln in (lens, np.array([0, lens[1]], np.int32)):
            kw = dict(causal=True, window=window, q_offset=t(offs),
                      seq_lens=t(ln))
            fixed = flash_prefill(t(q), t(k), t(v), **kw)
            paged = flash_prefill(t(q), t(pk), t(pv), block_tables=t(tab),
                                  **kw)
            assert torch.equal(fixed, paged)
            assert torch.isfinite(paged).all()
        assert torch.all(paged[0] == 0)


def test_flash_prefill_paged_needs_seq_lens():
    q, _, _, pk, pv, tab, _, _ = _paged_prefill_case(40, 8)
    with pytest.raises(ValueError, match="seq_lens"):
        flash_prefill(torch.from_numpy(q), torch.from_numpy(pk),
                      torch.from_numpy(pv), block_tables=torch.from_numpy(tab))


def test_every_reference_kernel_mode_is_ported():
    """No reference kernel mode is left without a port, and the paged
    prefill mode has its own launch counter."""
    assert registry.NOT_PORTED == {}
    counts = registry.launch_counts()
    assert {"flash_prefill", "flash_prefill_paged"} <= set(counts)
    assert "not ported" not in registry.backend_table()


# ------------------------------------------------- dispatch, no fallback
def test_wrappers_never_take_plain_path_off_cpu():
    """Only CPU tensors take the plain version: any other device goes to
    the kernel path, which refuses what is not a CUDA tensor."""
    q = torch.zeros(B, QH, HSZ, device="meta")
    k = torch.zeros(B, KH, S_LOC, HSZ, device="meta")
    with pytest.raises(ValueError):
        flash_decode(q, k, k, 5, 0)
    with pytest.raises(ValueError):
        kc = torch.zeros(B, KH, S_LOC, HSZ)           # mixed devices
        flash_decode(q, kc, kc, 5, 0)
    qp = torch.zeros(1, 8, QH, HSZ, device="meta")
    kp = torch.zeros(1, 8, KH, HSZ, device="meta")
    with pytest.raises(ValueError):
        flash_prefill(qp, kp, kp)
    pool = torch.zeros(5, KH, 8, HSZ, device="meta")
    tab = torch.zeros(1, 2, dtype=torch.int32, device="meta")
    lens = torch.full((1,), 16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        flash_prefill(qp, pool, pool, block_tables=tab, seq_lens=lens)
    with pytest.raises(ValueError):                   # a CPU table
        flash_prefill(qp, pool, pool,
                      block_tables=torch.zeros(1, 2, dtype=torch.int32),
                      seq_lens=lens)
    meta = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt,
                                                     device="meta")
    with pytest.raises(ValueError):
        ssd_prefill(meta(1, 8, 2, 16), meta(1, 8, 2), meta(2),
                    meta(1, 8, 1, 16), meta(1, 8, 1, 16), meta(2))
    assert build.route(torch.zeros(1)) == "plain"


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(build, "_LOADED", {})
    with pytest.raises(build.KernelUnavailable):
        build.load("flash_decode")
