// flash_decode: Helix decode attention over KVP shards, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py
// flash_decode_kernel (body _decode_kernel): per-request lengths, sliding
// window + slot_offset, round-robin or contiguous layout, block pruning
// on/off, fused KV append, int8 K/V with per-slot f32 scales and an
// in-kernel quantized append, the paged mode (K/V in shared pool pages
// reached through per-request block tables) and the grouped-suffix mode
// (resume the partials of prefix_pass.cu above the shared prefix).
//
// Split sweep, exact merge.  The TPU kernel walks a shard in order on one
// core.  Here each rank's slots are cut into chunks of CH = 256 slots at
// absolute boundaries (decode_tile.cuh).  A CTA per (chunk, batch row x
// kv head, rank) sweeps its chunk's tiles for the G query rows of that kv
// head from the cold state and writes the raw partial (acc, m, l) to an
// f32 workspace; when that grid would not fit the card at once, each CTA
// takes CPC_MAX consecutive chunks, its copies running on from one into
// the next, and still writes one partial per chunk.  CTAs with no tile to
// sweep exit at once.  A second small kernel (merge_kernel, on the same
// stream) folds each query row's partials in ascending chunk order and
// writes out and lse: one C call, no torch op per call.  At B = 8,
// S = 4096, Kh = 8 that is 512 CTAs of 2 x 64 KB (1024 partials), against
// 64 blocks sweeping 4096 slots each before.
//
// Tiles swept.  Pruning on: the tiles holding the row's valid slots
// [lo, hi) (pruning.valid_slot_span; the reference's prune_block_range
// rounds the same interval out to S-blocks, whose extra tiles are all
// masked, so skipping them changes no bit).  Pruning off: every tile of the
// padded capacity n_blocks * block_s.  Chunks outside the swept range are
// not written and not merged; a masked tile or an empty chunk is an exact
// identity (decode_tile.cuh), so pruned == dense bit for bit.
//
// Head size 256 (gemma3): a lane holds 8 dims of a row (two 16-byte units
// in f32, loaded unit by unit through the swizzle); an f32 stage is 64 KB,
// so the ring has its floor of 3 stages and the CTA 212,496 bytes of
// shared memory, one CTA an SM.
//
// Head size 96 (phi-3-vision): a lane holds 3 dims, which may straddle two
// 16-byte units, so load_dims reads them element by element; a bf16 row has
// 12 units and an int8 row 6, so the swizzle permutes a tail of units that
// is not a group of 8 (decode_tile.cuh); 4 rows a warp as at 128.
//
// Rows.  One CTA holds all G query rows of its kv head, so each K/V tile is
// read once for the whole group: RW rows a warp, 1 for G <= 4, 2 for G <= 8
// and 4 for G <= 16 (starcoder2's G = 12, llama's 16), the last only at
// head sizes up to 128 (at 256 a row holds 8 dims a lane, and 4 rows a warp
// would not fit the registers).  A warp's rows past G are not computed at
// all (Rows::n), and each row's arithmetic is the same at any RW
// (decode_tile.cuh), so every bit-exact invariant holds at any G.
//
// Bound: decode reads every K/V byte of the valid span once and does
// ~4*G*hsz flops per slot, far below Hopper's ~295 flop/byte ridge, so it is
// bound by bytes (3.35 TB/s).  The design keeps K/V in their storage type in
// shared memory, a ring of ~32 KB (3..8 tiles) filled by 16-byte cp.async
// copies with one block barrier per tile, ~5 CTAs per SM, scores with
// lane = slot and p.v with lane = dims on CUDA cores, q in shared memory
// read as broadcasts.
//
// Fused append: the owner rank ((tl-1)//rr % kvp == rank) CTA whose chunk
// holds _append_slot substitutes the new row into its tile (the copy reads
// the new row instead of the cache) and stores it in place; other CTAs
// write nothing there.
//
// int8 mode (KT = int8_t; reference _quantize_row and kernel.py:330-371):
// K/V tiles arrive as int8 with their f32 scales; a score is
// (q . k_int) * kscale[slot] and p.v adds (p * vscale[slot]) * v_int.  The
// fused append quantizes the new row exactly as core/helix.quantize_kv_token
// does: amax over hsz (exact in any order), scale = fmaxf(amax / 127,
// 1e-30) and q = clamp(rint(x / scale), -127, 127) with IEEE division and
// round-half-to-even, substitutes the int8 payload and scale into the tile
// (the bytes append-then-attend would load), and stores them.
//
// Paged mode (tables != null; reference decode_index_maps kv_idx/row_idx,
// kernel.py:172-236): K/V (and scales) are pool planes [n_pool, Kh,
// n_ranks * ps, hsz] and rank z holds rows [z*ps, (z+1)*ps) of every page.
// Logical slot jj of a request's shard lives in physical page
// tables[b, jj / ps] at row z*ps + jj % ps; each CTA resolves its chunks'
// slots through the table once, into shared memory.  Only the copy
// addresses change: chunks, tiles, masks and positions are those of the
// fixed layout over the logical capacity s_loc = max_pages * ps, so paged ==
// fixed bit for bit.  Table entries past a request's pages must be 0 (the
// sink page the engine reserves), since a dense sweep reads them masked.
//
// Grouped-suffix mode (gnp != null, paged only; reference sfx_start and
// init_state, kernel.py:421, :447-503): row b's split tile is split =
// gnp[b] * ps / TS.  prefix_pass.cu wrote the partial of every chunk below
// the split and, for the chunk holding it, the partial swept up to the split
// (st_*, [n_ranks, B, Kh, st_nc, G(, hsz)]).  Here chunks wholly below the
// split are not swept, the chunk holding it resumes st's partial at the
// split tile, chunks above start cold, and the merge reads the chunks below
// the split from st: the same partials in the same order as ungrouped
// decode, so grouped == ungrouped bit for bit.  The fused append stays in
// the suffix: the engine caps gnp at each member's committed pages.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;
constexpr int NT = 128;     // threads per CTA (4 warps)
constexpr int NW = NT / 32;
constexpr int MAXG = 16;      // query heads per kv head held by one CTA
constexpr int MAXG_256 = 8;   // the same at head size 256 (2 rows a warp)
constexpr int CPC_MAX = 2;  // chunks one CTA may sweep

struct DecodeArgs {
  const void* q;      // [B, Kh, G, hsz]
  void* k;            // [B, Kh, n_ranks * s_loc, hsz], or the paged pool
  void* v;            // [n_pool, Kh, n_ranks * ps, hsz] (T, or int8)
  float* kscale;      // k's shape without hsz (int8 mode only)
  float* vscale;
  const void* k_new;  // [B, Kh, hsz] (append only)
  const void* v_new;
  const int* tl;      // [B] global lengths incl. the new token, or null: tl0
  const int* tables;  // [B, max_pages] physical pages (paged mode), else null
  const int* gnp;     // [B] shared leading pages (grouped suffix), else null
  const float* st_acc;  // [n_ranks, B, Kh, st_nc, G, hsz] prefix partials
  const float* st_m;    // [n_ranks, B, Kh, st_nc, G]
  const float* st_l;
  void* out;          // [n_ranks, B, Kh, G, hsz]
  float* lse;         // [n_ranks, B, Kh, G]
  float* ws;          // partials: acc [n][G][hsz], m [n][G], l [n][G],
                      // n = n_ranks * B * Kh * nc
  int tl0, B, Kh, G, s_loc, n_ranks, rank0, kvp, rr, block_s;
  int slot_offset, window, contiguous, prune, append;
  int max_pages, ps, st_nc, nc, n_tiles;
  float scale;
  int cpc;            // chunks per CTA (1 or CPC_MAX)
};

// One row's valid slots (sp), the tiles swept for it, [t0, t1) (pruning
// on: the tiles holding sp; off: all n_tiles), and its split tile (grouped
// suffix; 0 otherwise).  The merged chunks are those holding [t0, t1).
struct RowTiles {
  Span sp;
  int t0, t1, split;
};
__device__ __forceinline__ RowTiles row_tiles(const DecodeArgs& a, int b, int tl, int rank) {
  RowTiles r;
  r.sp = valid_span(tl, rank, a.kvp, a.rr, a.s_loc, a.window, a.slot_offset, a.contiguous != 0);
  r.t0 = 0;
  r.t1 = a.n_tiles;
  if (a.prune) {
    r.t0 = r.sp.lo / TS;
    r.t1 = r.sp.hi > r.sp.lo ? (r.sp.hi + TS - 1) / TS : r.t0;
  }
  r.split = a.gnp != nullptr ? a.gnp[b] * a.ps / TS : 0;
  return r;
}

// Quantize one [HSZ] row held in shared memory (x) into q (int-valued
// floats); returns the scale.  Called by one warp.
template <int HSZ>
__device__ __forceinline__ float quantize_row(const float* x, float* q, int lane) {
  float amax = 0.f;
  for (int d = lane; d < HSZ; d += 32) amax = fmaxf(amax, fabsf(x[d]));
  amax = warp_max(amax);
  const float s = fmaxf(amax / 127.0f, 1e-30f);
  for (int d = lane; d < HSZ; d += 32)
    q[d] = fminf(fmaxf(rintf(x[d] / s), -127.f), 127.f);
  return s;
}

// Shared memory of one CTA: the ring, then q (the NW * RW rows it holds),
// the warps' p scratch, the chunk's row offsets and the int8 append's rows.
template <typename KT, int HSZ, int RW>
struct Smem {
  using L = Layout<KT, HSZ>;
  static constexpr int Q = L::RING_BYTES;
  static constexpr int PW = Q + NW * RW * HSZ * 4;
  static constexpr int ROFF = PW + NW * RW * TS * 4;
  static constexpr int NEWQ = ROFF + CPC_MAX * CH * 8;  // int8 rows [2][HSZ]
  static constexpr int NSC = NEWQ + 2 * HSZ;          // [2] f32 (+ pad)
  static constexpr int XF = NSC + 16;                 // [2][HSZ] f32
  static constexpr int BYTES = XF + 2 * HSZ * 4;
};

template <typename T, typename KT, int HSZ, int RW>
__global__ void __launch_bounds__(NT) decode_kernel(DecodeArgs a) {
  using L = Layout<KT, HSZ>;
  using S = Smem<KT, HSZ, RW>;
  constexpr bool Q8 = L::Q8;
  constexpr int DPL = L::DPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::Q);
  float* pws = reinterpret_cast<float*>(smem + S::PW);
  long* roff = reinterpret_cast<long*>(smem + S::ROFF);
  int8_t* newq = reinterpret_cast<int8_t*>(smem + S::NEWQ);
  float* nsc = reinterpret_cast<float*>(smem + S::NSC);
  float* xf = reinterpret_cast<float*>(smem + S::XF);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, z = blockIdx.z;
  const int c_lo = blockIdx.x * a.cpc, c_hi = min(c_lo + a.cpc, a.nc);  // its chunks
  const int b = bh / a.Kh, h = bh % a.Kh;
  const int rank = a.rank0 + z;
  const int G = a.G;
  const int tl = a.tl != nullptr ? a.tl[b] : a.tl0;
  const long ob = (long)z * a.B * a.Kh + bh;   // [z, b, h]
  KT* kp = reinterpret_cast<KT*>(a.k);
  KT* vp = reinterpret_cast<KT*>(a.v);

  // the row's tiles, and what this CTA does with them: it sweeps its chunks
  // among those merged, [C0, C1), from split / CPT on (those below come
  // from prefix_pass)
  const RowTiles rt = row_tiles(a, b, tl, rank);
  const Span sp = rt.sp;
  const int T0 = rt.t0, T1 = rt.t1, split = rt.split;
  const int C0 = T0 < T1 ? T0 / CPT : 0, C1 = T0 < T1 ? (T1 + CPT - 1) / CPT : 0;
  const int w_lo = max(max(c_lo, C0), split / CPT), w_hi = min(c_hi, C1);
  const bool work = w_lo < w_hi;
  const bool resume = work && w_lo * CPT < split;    // the chunk holding the split
  const int ct0 = c_lo * CPT;
  const int ta = max(max(T0, w_lo * CPT), split), te = min(T1, w_hi * CPT);

  // fused append: slot, owner rank, and whether this CTA stores / substitutes
  int j_new = -1;
  bool owner = false;
  if (a.append) {
    const int pos = tl - 1;
    const int blk = floordiv(pos, a.rr);
    j_new = clampi(floordiv(blk, a.kvp) * a.rr + floormod(pos, a.rr), 0,
                   a.n_tiles * TS - 1);
    owner = floormod(blk, a.kvp) == rank;
  }
  const bool store = owner && j_new < a.s_loc && j_new / CH >= c_lo && j_new / CH < c_hi;
  const bool sub = store && work && j_new >= ta * TS && j_new < te * TS;
  const T* knp = reinterpret_cast<const T*>(a.k_new) + (long)bh * HSZ;
  const T* vnp = reinterpret_cast<const T*>(a.v_new) + (long)bh * HSZ;
  if (Q8 && store) {
    for (int i = tid; i < 2 * HSZ; i += NT) xf[i] = to_f(i < HSZ ? knp[i] : vnp[i - HSZ]);
    __syncthreads();
    if (warp < 2) {
      float* row = xf + warp * HSZ;
      const float s = quantize_row<HSZ>(row, row, lane);
      __syncwarp();
      for (int d = lane; d < HSZ; d += 32) newq[warp * HSZ + d] = (int8_t)row[d];
      if (lane == 0) nsc[warp] = s;
    }
    __syncthreads();
  }

  auto slot_row = [&](int jj) -> long {
    if (a.tables == nullptr) return ((long)bh * a.n_ranks + z) * a.s_loc + jj;
    const int pg = a.tables[(long)b * a.max_pages + jj / a.ps];
    return (((long)pg * a.Kh + h) * a.n_ranks + z) * a.ps + jj % a.ps;
  };

  if (work) {
    const T* qp = reinterpret_cast<const T*>(a.q) + (long)bh * G * HSZ;
    for (int i = tid; i < G * HSZ; i += NT) qs[i] = to_f(qp[i]) * a.scale;
    for (int jl = tid; jl < (c_hi - c_lo) * CH; jl += NT) {
      const int jj = c_lo * CH + jl;
      roff[jl] = jj >= a.s_loc ? ROW_NONE : (sub && jj == j_new ? ROW_SUB : slot_row(jj));
    }
    Rows<HSZ, RW> st;
    st.n = 0;
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      if (warp + NW * k < G) st.n = k + 1;
      st.lo[k] = sp.lo;
      st.hi[k] = sp.hi;
    }
    st.cold();
    Ring<KT, HSZ, NT> ring;
    ring.ks = reinterpret_cast<KT*>(smem);
    ring.vs = ring.ks + L::NS * L::ELEMS;
    ring.kss = reinterpret_cast<float*>(ring.vs + L::NS * L::ELEMS);
    ring.vss = ring.kss + L::NS * TS;
    ring.kg = kp;
    ring.vg = vp;
    ring.ksg = a.kscale;
    ring.vsg = a.vscale;
    ring.roff = roff;
    ring.sub_k = Q8 ? reinterpret_cast<const KT*>(newq) : reinterpret_cast<const KT*>(knp);
    ring.sub_v = Q8 ? reinterpret_cast<const KT*>(newq + HSZ)
                    : reinterpret_cast<const KT*>(vnp);
    ring.sub_sc = nsc;
    if (resume) {
      const long p = ob * a.st_nc + w_lo;
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        if (k < st.n) {
          const long r = p * G + warp + NW * k;
          st.m[k] = a.st_m[r];
          st.l[k] = a.st_l[r];
#pragma unroll
          for (int d = 0; d < DPL; ++d) st.acc[k][d] = a.st_acc[r * HSZ + lane * DPL + d];
        }
      }
    }
    __syncthreads();
    // each chunk's partial, written when the sweep leaves it; the next
    // chunk starts cold
    const long n = (long)a.n_ranks * a.B * a.Kh * a.nc;
    auto write_chunk = [&](int cc) {
      const long p = ob * a.nc + cc;
      write_rows<HSZ, RW, NW>(st, a.ws + p * G * HSZ, a.ws + n * G * HSZ + p * G,
                          a.ws + n * G * (HSZ + 1) + p * G, warp, lane);
      st.cold();
    };
    sweep<KT, HSZ, RW, NT>(ring, ta, te, ct0, qs, st, pws + warp * RW * TS, tid, write_chunk);
    write_chunk(w_hi - 1);
  }
  if (store) {
    const long row = slot_row(j_new);
    const KT* kn = Q8 ? reinterpret_cast<const KT*>(newq) : reinterpret_cast<const KT*>(knp);
    const KT* vn = Q8 ? reinterpret_cast<const KT*>(newq + HSZ)
                      : reinterpret_cast<const KT*>(vnp);
    for (int i = tid; i < HSZ; i += NT) {
      kp[row * HSZ + i] = kn[i];
      vp[row * HSZ + i] = vn[i];
    }
    if (Q8 && tid == 0) {
      a.kscale[row] = nsc[0];
      a.vscale[row] = nsc[1];
    }
  }
}

// The merge: one CTA of HSZ threads per (batch row x kv head, rank, query
// row) folds that row's chunk partials in ascending chunk order
// (merge_step; each thread one dim, the loads of up to NB chunks in flight
// at once) and writes out and lse.  Launched after decode_kernel on the
// same stream.
template <typename T, int HSZ>
__global__ void __launch_bounds__(HSZ) merge_kernel(DecodeArgs a) {
  const int bh = blockIdx.x, z = blockIdx.y, g = blockIdx.z, d = threadIdx.x;
  const int b = bh / a.Kh;
  const int G = a.G;
  const long ob = (long)z * a.B * a.Kh + bh;
  const RowTiles rt = row_tiles(a, b, a.tl != nullptr ? a.tl[b] : a.tl0, a.rank0 + z);
  const int C0 = rt.t0 < rt.t1 ? rt.t0 / CPT : 0;
  const int C1 = rt.t0 < rt.t1 ? (rt.t1 + CPT - 1) / CPT : 0;
  const int cw = max(C0, rt.split / CPT);   // chunks below: prefix_pass's
  const long n = (long)a.n_ranks * a.B * a.Kh * a.nc;
  constexpr int NB = 16;
  float m = REPRO_NEG_INF, l = 0.f, acc = 0.f;
  for (int cb = C0; cb < C1; cb += NB) {
    float mc[NB], lc[NB], ac[NB];
#pragma unroll
    for (int u = 0; u < NB; ++u) {
      const int cc = cb + u;
      if (cc < C1) {
        const bool fst = cc < cw;
        const long r = ((fst ? ob * a.st_nc : ob * a.nc) + cc) * G + g;
        mc[u] = fst ? a.st_m[r] : a.ws[n * G * HSZ + r];
        lc[u] = fst ? a.st_l[r] : a.ws[n * G * (HSZ + 1) + r];
        ac[u] = fst ? a.st_acc[r * HSZ + d] : a.ws[r * HSZ + d];
      }
    }
#pragma unroll
    for (int u = 0; u < NB; ++u)
      if (cb + u < C1) merge_step(m, l, acc, mc[u], lc[u], ac[u]);
  }
  T* op = reinterpret_cast<T*>(a.out) + (ob * G + g) * HSZ;
  op[d] = from_f<T>(l > 0.f ? acc / fmaxf(l, 1e-37f) : 0.f);
  if (d == 0) a.lse[ob * G + g] = l > 0.f ? m + logf(fmaxf(l, 1e-37f)) : REPRO_NEG_INF;
}

// Chunks per CTA: 1, or CPC_MAX when one per CTA would not fit the card at
// once (every CTA of the grid resident), so that the grid runs in one wave
// and a CTA's copies run on from one chunk into the next.
template <typename T, typename KT, int HSZ, int RW>
cudaError_t launch(DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = Smem<KT, HSZ, RW>::BYTES;
  // f32 at hsz 256: a 3-stage ring of 64 KB stages, 212,496 bytes in all
  static_assert(Smem<KT, HSZ, RW>::BYTES <= SMEM_OPTIN, "shared memory");
  cudaError_t err = allow_smem(decode_kernel<T, KT, HSZ, RW>, smem);
  if (err != cudaSuccess) return err;
  static int per_sm = 0, sms = 0;
  if (per_sm == 0) {
    int dev;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, decode_kernel<T, KT, HSZ, RW>, NT, smem);
    if (err != cudaSuccess) return err;
  }
  const long items = (long)a.nc * a.B * a.Kh * a.n_ranks;
  a.cpc = items > (long)per_sm * sms ? CPC_MAX : 1;
  dim3 grid((a.nc + a.cpc - 1) / a.cpc, a.B * a.Kh, a.n_ranks);
  decode_kernel<T, KT, HSZ, RW><<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  merge_kernel<T, HSZ><<<dim3(a.B * a.Kh, a.n_ranks, a.G), HSZ, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KT, int HSZ>
cudaError_t launch_rw(DecodeArgs& a, cudaStream_t stream) {
  if (a.G <= NW) return launch<T, KT, HSZ, 1>(a, stream);
  if (a.G <= 2 * NW) return launch<T, KT, HSZ, 2>(a, stream);
  if constexpr (HSZ <= 128) {
    return launch<T, KT, HSZ, 4>(a, stream);
  } else {
    return cudaErrorInvalidValue;   // G > MAXG_256: refused by the launcher
  }
}

template <typename T, typename KT>
cudaError_t launch_hsz(DecodeArgs& a, int hsz, cudaStream_t stream) {
  switch (hsz) {
    case 32: return launch_rw<T, KT, 32>(a, stream);
    case 64: return launch_rw<T, KT, 64>(a, stream);
    case 96: return launch_rw<T, KT, 96>(a, stream);
    case 128: return launch_rw<T, KT, 128>(a, stream);
    case 256: return launch_rw<T, KT, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Slots per chunk: the wrapper sizes the workspace with it.
extern "C" int flash_decode_chunk_slots() { return CH; }

// One launch's operands, filled by the wrapper (its ctypes mirror is
// ops._DecodeParams: keep the two in the same order).  s_loc: slots per
// rank (paged: max_pages * ps, the logical capacity).  tl: [B] lengths, or
// null with every length tl0.  gnp/st_*: the grouped-suffix mode (paged
// only), else null; st_nc: chunks per row of st_*.  ws: >= n_ranks * B *
// Kh * nc * G * (hsz + 2) floats, nc = ceil(ceil(s_loc / block_s) *
// block_s / CH).
struct DecodeParams {
  const void *q, *k, *v, *k_new, *v_new, *tl, *out, *lse, *kscale, *vscale;
  const void *tables, *gnp, *st_acc, *st_m, *st_l, *ws;
  int tl0, dtype, quant, B, Kh, G, hsz, s_loc, n_ranks, rank0, kvp, rr, block_s;
  int slot_offset, window, contiguous, prune, append, max_pages, ps, st_nc;
  float scale;
  int cpc;   // out: chunks per CTA of the launch
};

extern "C" int flash_decode_launch(DecodeParams* p, void* stream) {
  const int G = p->G, block_s = p->block_s, s_loc = p->s_loc;
  if (G < 1 || G > (p->hsz > 128 ? MAXG_256 : MAXG) || block_s % TS != 0 || block_s < TS
      || p->B * p->Kh == 0
      || p->n_ranks < 1 || s_loc < 1 || p->ws == nullptr
      || (p->quant && (p->kscale == nullptr || p->vscale == nullptr))
      || (p->tables != nullptr && (p->max_pages < 1 || p->ps < 1
                                   || s_loc != p->max_pages * p->ps
                                   || p->contiguous || p->slot_offset != 0))
      || (p->gnp != nullptr && (p->tables == nullptr || p->st_acc == nullptr
                                || p->st_m == nullptr || p->st_l == nullptr
                                || p->st_nc < 1)))
    return (int)cudaErrorInvalidValue;
  const int n_tiles = (s_loc + block_s - 1) / block_s * (block_s / TS);
  const int nc = (n_tiles + CPT - 1) / CPT;
  DecodeArgs a{p->q, const_cast<void*>(p->k), const_cast<void*>(p->v),
               static_cast<float*>(const_cast<void*>(p->kscale)),
               static_cast<float*>(const_cast<void*>(p->vscale)), p->k_new, p->v_new,
               static_cast<const int*>(p->tl), static_cast<const int*>(p->tables),
               static_cast<const int*>(p->gnp), static_cast<const float*>(p->st_acc),
               static_cast<const float*>(p->st_m), static_cast<const float*>(p->st_l),
               const_cast<void*>(p->out), static_cast<float*>(const_cast<void*>(p->lse)),
               static_cast<float*>(const_cast<void*>(p->ws)), p->tl0, p->B, p->Kh, G, s_loc,
               p->n_ranks, p->rank0, p->kvp, p->rr, block_s, p->slot_offset, p->window,
               p->contiguous, p->prune, p->append, p->max_pages, p->ps, p->st_nc, nc,
               n_tiles, p->scale, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p->quant)
    err = p->dtype == 1 ? launch_hsz<bf16, int8_t>(a, p->hsz, s)
                        : launch_hsz<float, int8_t>(a, p->hsz, s);
  else
    err = p->dtype == 1 ? launch_hsz<bf16, bf16>(a, p->hsz, s)
                        : launch_hsz<float, float>(a, p->hsz, s);
  p->cpc = a.cpc;
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
