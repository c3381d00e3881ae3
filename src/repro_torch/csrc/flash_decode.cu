// flash_decode: Helix decode attention over KVP shards, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py
// flash_decode_kernel (body _decode_kernel): per-request lengths, sliding
// window + slot_offset, round-robin or contiguous layout, block pruning
// on/off, fused KV append, int8 K/V with per-slot f32 scales and an
// in-kernel quantized append, the paged mode (K/V in shared pool pages
// reached through per-request block tables) and the grouped-suffix mode
// (resume the raw state of prefix_pass.cu above the shared prefix).
//
// One thread block per (batch row, kv head, rank): it holds the G query
// rows of that kv head and sweeps the rank's shard IN ORDER, keeping the
// online softmax (m, l, acc) in f32.  The S blocks visited are
// [lo, lo + nb) from prune_block_range (all blocks when prune == 0); each
// block is walked in tiles of TS slots by decode_tile.cuh's tile_update.  A
// fully masked tile is an exact identity update (alpha = exp(0) = 1,
// p = 0), so pruned and dense sweeps, and fused and unfused appends, give
// bit-identical results.  No split-K.
//
// Bound: decode reads every K/V byte of the valid span once and does
// ~4*G*hsz flops per slot, far below Hopper's ~295 flop/byte ridge, so it is
// bound by bytes (3.35 TB/s).  The design keeps one global read per K/V
// element: coalesced 16-byte loads into registers, issued one tile ahead of
// the tile being computed from shared memory.  Rank is a grid dimension so
// a whole KVP group is one launch.
//
// Fused append: the owner rank ((tl-1)//rr % kvp == rank) substitutes the
// new row into its tile and stores it at _append_slot in place; other ranks
// write nothing.
//
// int8 mode (KT = int8_t; reference _quantize_row and kernel.py:330-371):
// K/V tiles are loaded as int8 (16 slots' bytes per 16-byte load, half the
// bytes of bf16) with their f32 scales, and each element is dequantized as
// float(q) * scale[slot] -- the reference's product -- into shared memory
// before the dot products.  The fused append quantizes the new row exactly
// as core/helix.quantize_kv_token does: amax over hsz (exact in any order),
// scale = fmaxf(amax / 127, 1e-30) and q = clamp(rint(x / scale), -127, 127)
// with IEEE division and round-half-to-even, then substitutes q * scale into
// the tile, so fused stays bit-exact with append-then-attend, and finally
// stores the int8 payload and the f32 scale.
//
// Paged mode (tables != null; reference decode_index_maps kv_idx/row_idx,
// kernel.py:172-236): K/V (and scales) are pool planes [n_pool, Kh,
// n_ranks * ps, hsz] and rank z holds rows [z*ps, (z+1)*ps) of every page.
// Logical slot jj of a request's shard lives in physical page
// tables[b, jj / ps] at row z*ps + jj % ps.  Only the load and store
// addresses change: the sweep, the tiles, the masks and every position are
// those of the fixed layout over the logical capacity s_loc = max_pages *
// ps, so paged == fixed bit for bit at any block_s.  A tile of TS slots may
// span several pages; a K/V row never straddles one, so the 16-byte loads
// stay as they are.  Table entries past a request's pages must be 0 (the
// sink page the engine reserves), since a dense sweep reads them masked.
//
// Grouped-suffix mode (gnp != null, paged only; reference sfx_start and
// init_state, kernel.py:421, :447-503): row b's first tile is
// split = gnp[b] * ps / TS, the whole tiles below its shared pages.  When
// split > 0 the block starts from prefix_pass's raw (acc, m, l) of its rows
// (st_acc/st_m/st_l at [z, b, h]) instead of the cold state and sweeps only
// the tiles at or above split; rows with split == 0 decode exactly as
// ungrouped.  The split falls on a tile boundary, never mid-tile, so every
// row sees the ungrouped sequence of tile updates and grouped == ungrouped
// bit for bit.  The fused append stays in the suffix: the engine caps gnp
// at each member's committed pages.
#include "decode_tile.cuh"

namespace {

using decode_tile::NT;
using decode_tile::TS;
using decode_tile::TilePipe;
using decode_tile::warp_max;
constexpr int MAXG = 8;   // query heads per kv head held by one block

struct DecodeArgs {
  const void* q;      // [B, Kh, G, hsz]
  void* k;            // [B, Kh, n_ranks * s_loc, hsz], or the paged pool
  void* v;            // [n_pool, Kh, n_ranks * ps, hsz] (T, or int8)
  float* kscale;      // k's shape without hsz (int8 mode only)
  float* vscale;
  const void* k_new;  // [B, Kh, hsz] (append only)
  const void* v_new;
  const int* tl;      // [B] global lengths incl. the new token
  const int* tables;  // [B, max_pages] physical pages (paged mode), else null
  const int* gnp;     // [B] shared leading pages (grouped suffix), else null
  const float* st_acc;  // [n_ranks, B, Kh, G, hsz] prefix state (grouped)
  const float* st_m;    // [n_ranks, B, Kh, G]
  const float* st_l;
  void* out;          // [n_ranks, B, Kh, G, hsz]
  float* lse;         // [n_ranks, B, Kh, G]
  int B, Kh, G, s_loc, n_ranks, rank0, kvp, rr, block_s;
  int slot_offset, window, contiguous, prune, append;
  int max_pages, ps;  // paged: table width, rows per rank and page
  float scale;
};

__device__ __forceinline__ int local_valid_len(int tl, int rank, int kvp, int rr) {
  const int cycle = kvp * rr;
  return (tl / cycle) * rr + clampi(tl % cycle - rank * rr, 0, rr);
}

// Mirror of pruning.prune_block_range (reference: flash_decode/kernel.py).
__device__ __forceinline__ void prune_block_range(const DecodeArgs& a, int tl, int rank,
                                                  int& lo, int& nb) {
  tl = max(tl, 0);
  int j_hi, j_lo;
  if (a.contiguous) {
    j_hi = tl - rank * a.s_loc;
    j_lo = tl - a.window - rank * a.s_loc;
  } else {
    j_hi = local_valid_len(tl, rank, a.kvp, a.rr);
    j_lo = local_valid_len(max(tl - a.window, 0), rank, a.kvp, a.rr);
  }
  const int jj_hi = clampi(j_hi - a.slot_offset, 0, a.s_loc);
  const int jj_lo = a.window > 0 ? clampi(j_lo - a.slot_offset, 0, a.s_loc) : 0;
  lo = jj_lo / a.block_s;
  nb = max((jj_hi + a.block_s - 1) / a.block_s - lo, 0);
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

template <typename T, typename KT, int HSZ>
__global__ void __launch_bounds__(NT) decode_kernel(DecodeArgs a) {
  using Pipe = TilePipe<KT, HSZ>;
  constexpr bool Q8 = Pipe::Q8;
  constexpr int SP = Pipe::SP;

  extern __shared__ float smem[];
  float* qs = smem;                   // [MAXG][HSZ] scaled queries
  float* acc = qs + MAXG * HSZ;       // [MAXG][HSZ] raw output sums
  float* ks = acc + MAXG * HSZ;       // [TS][SP]
  float* vs = ks + TS * SP;           // [TS][SP]
  float* ps = vs + TS * SP;           // [MAXG][TS] scores, then p
  float* row_m = ps + MAXG * TS;      // [MAXG]
  float* row_l = row_m + MAXG;        // [MAXG]
  float* row_a = row_l + MAXG;        // [MAXG] alpha of the current tile
  float* knq = row_a + MAXG;          // [HSZ] new K row (int8: quantized)
  float* vnq = knq + HSZ;             // [HSZ]
  float* nsc = vnq + HSZ;             // [2] new row scales (int8 mode)
  int* valid = reinterpret_cast<int*>(nsc + 2);  // [TS]

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;          // b * Kh + h
  const int b = bh / a.Kh;
  const int h = bh % a.Kh;
  const int z = blockIdx.y;
  const int rank = a.rank0 + z;
  const int G = a.G;
  const int tl = a.tl[b];
  const long ob = (long)z * a.B * a.Kh + bh;   // [z, b, h] of out/lse/state
  KT* kp = reinterpret_cast<KT*>(a.k);
  KT* vp = reinterpret_cast<KT*>(a.v);
  Pipe pipe;
  pipe.kp = kp;
  pipe.vp = vp;
  pipe.ksc = Q8 ? a.kscale : nullptr;
  pipe.vsc = Q8 ? a.vscale : nullptr;
  pipe.tab = a.tables != nullptr ? a.tables + (long)b * a.max_pages : nullptr;
  pipe.row0 = ((long)bh * a.n_ranks + z) * a.s_loc;
  pipe.Kh = a.Kh;
  pipe.h = h;
  pipe.n_ranks = a.n_ranks;
  pipe.z = z;
  pipe.ps = a.ps;
  pipe.s_loc = a.s_loc;

  // grouped suffix: resume the prefix pass's raw state above its split
  const int split = a.gnp != nullptr ? a.gnp[b] * a.ps / TS : 0;
  const T* qp = reinterpret_cast<const T*>(a.q) + (long)bh * G * HSZ;
  for (int i = tid; i < G * HSZ; i += NT) {
    qs[i] = to_f(qp[i]) * a.scale;
    acc[i] = split > 0 ? a.st_acc[ob * G * HSZ + i] : 0.f;
  }
  if (tid < G) {
    row_m[tid] = split > 0 ? a.st_m[ob * G + tid] : REPRO_NEG_INF;
    row_l[tid] = split > 0 ? a.st_l[ob * G + tid] : 0.f;
  }

  const int n_blocks = (a.s_loc + a.block_s - 1) / a.block_s;
  int j_new = -1;
  bool owner = false;
  const T* knp = nullptr;
  const T* vnp = nullptr;
  if (a.append) {
    const int pos = tl - 1;
    const int blk = floordiv(pos, a.rr);
    j_new = clampi(floordiv(blk, a.kvp) * a.rr + floormod(pos, a.rr), 0,
                   n_blocks * a.block_s - 1);
    owner = floormod(blk, a.kvp) == rank;
    knp = reinterpret_cast<const T*>(a.k_new) + (long)bh * HSZ;
    vnp = reinterpret_cast<const T*>(a.v_new) + (long)bh * HSZ;
    for (int i = tid; i < HSZ; i += NT) { knq[i] = to_f(knp[i]); vnq[i] = to_f(vnp[i]); }
    if (Q8) {
      __syncthreads();
      const int w = tid / 32;
      if (w < 2) {
        float* row = w == 0 ? knq : vnq;
        const float s = quantize_row<HSZ>(row, row, tid % 32);
        if (tid % 32 == 0) nsc[w] = s;
      }
    }
    __syncthreads();
  }
  const int j_sub = owner ? j_new : -1;

  const int tiles_per_block = a.block_s / TS;
  int t0 = 0, t1 = n_blocks * tiles_per_block;
  if (a.prune) {
    int lo, nb;
    prune_block_range(a, tl, rank, lo, nb);
    t0 = lo * tiles_per_block;
    t1 = (lo + nb) * tiles_per_block;
  }
  t0 = max(t0, split);

  auto stage = [&](int tile) {
    pipe.sstore(tile, tid, ks, vs, j_sub, knq, vnq, nsc);
    if (tid < TS) {
      const int jj = tile * TS + tid;
      const int j = jj + a.slot_offset;
      const int pos = a.contiguous ? rank * a.s_loc + j
                                   : decode_tile::rr_position(j, rank, a.kvp, a.rr);
      valid[tid] = jj < a.s_loc && pos < tl && (a.window <= 0 || pos >= tl - a.window);
    }
  };

  if (t0 < t1) { pipe.gload(t0, tid); stage(t0); }
  __syncthreads();
  for (int t = t0; t < t1; ++t) {
    const bool more = t + 1 < t1;
    if (more) pipe.gload(t + 1, tid);   // next tile's loads in flight
    decode_tile::tile_update<HSZ>(qs, ks, vs, ps, row_m, row_l, row_a, acc,
                                  valid, G, G, tid);
    if (more) { stage(t + 1); __syncthreads(); }
  }

  T* op = reinterpret_cast<T*>(a.out) + ob * G * HSZ;
  for (int i = tid; i < G * HSZ; i += NT) {
    const float l = row_l[i / HSZ];
    op[i] = from_f<T>(l > 0.f ? acc[i] / fmaxf(l, 1e-37f) : 0.f);
  }
  if (tid < G) {
    const float l = row_l[tid];
    a.lse[ob * G + tid] = l > 0.f ? row_m[tid] + logf(fmaxf(l, 1e-37f)) : REPRO_NEG_INF;
  }
  if (owner && j_new < a.s_loc) {
    const long row = pipe.slot_row(j_new);
    for (int i = tid; i < HSZ; i += NT) {
      if (Q8) {
        kp[row * HSZ + i] = (KT)knq[i];
        vp[row * HSZ + i] = (KT)vnq[i];
      } else {
        kp[row * HSZ + i] = knp[i];
        vp[row * HSZ + i] = vnp[i];
      }
    }
    if (Q8 && tid == 0) { a.kscale[row] = nsc[0]; a.vscale[row] = nsc[1]; }
  }
}

template <typename T, typename KT, int HSZ>
cudaError_t launch(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * MAXG * HSZ + 2 * TS * (HSZ + 1) + MAXG * TS
                                       + 3 * MAXG + 2 * HSZ + 2)
                      + sizeof(int) * TS;
  cudaError_t err = allow_smem(decode_kernel<T, KT, HSZ>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.Kh, a.n_ranks);
  decode_kernel<T, KT, HSZ><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t launch_hsz(const DecodeArgs& a, int hsz, cudaStream_t stream) {
  switch (hsz) {
    case 32: return launch<T, KT, 32>(a, stream);
    case 64: return launch<T, KT, 64>(a, stream);
    case 128: return launch<T, KT, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// s_loc: slots per rank (paged: max_pages * ps, the logical capacity).
// gnp/st_*: the grouped-suffix mode (paged only), else null.
extern "C" int flash_decode_launch(
    const void* q, void* k, void* v, const void* k_new, const void* v_new,
    const void* tl, void* out, void* lse, void* kscale, void* vscale,
    const void* tables, const void* gnp, const void* st_acc, const void* st_m,
    const void* st_l, int dtype, int quant, int B, int Kh, int G, int hsz,
    int s_loc, int n_ranks, int rank0, int kvp, int rr, int block_s,
    int slot_offset, int window, int contiguous, int prune, int append,
    int max_pages, int ps, float scale, void* stream) {
  if (G < 1 || G > MAXG || block_s % TS != 0 || B * Kh == 0 || n_ranks < 1
      || (quant && (kscale == nullptr || vscale == nullptr))
      || (tables != nullptr && (max_pages < 1 || ps < 1 || s_loc != max_pages * ps
                                || contiguous || slot_offset != 0))
      || (gnp != nullptr && (tables == nullptr || st_acc == nullptr
                             || st_m == nullptr || st_l == nullptr)))
    return (int)cudaErrorInvalidValue;
  DecodeArgs a{q, k, v, static_cast<float*>(kscale), static_cast<float*>(vscale),
               k_new, v_new, static_cast<const int*>(tl),
               static_cast<const int*>(tables), static_cast<const int*>(gnp),
               static_cast<const float*>(st_acc), static_cast<const float*>(st_m),
               static_cast<const float*>(st_l), out, static_cast<float*>(lse),
               B, Kh, G, s_loc, n_ranks, rank0, kvp, rr, block_s, slot_offset,
               window, contiguous, prune, append, max_pages, ps, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (quant)
    err = dtype == 1 ? launch_hsz<bf16, int8_t>(a, hsz, s)
                     : launch_hsz<float, int8_t>(a, hsz, s);
  else
    err = dtype == 1 ? launch_hsz<bf16, bf16>(a, hsz, s)
                     : launch_hsz<float, float>(a, hsz, s);
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
