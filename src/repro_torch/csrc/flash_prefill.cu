// flash_prefill: GQA full-sequence attention, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_prefill/kernel.py
// flash_prefill_kernel (body _prefill_kernel), both its layouts: the fixed
// one (k/v [B, S, Kh, hsz]) and the paged one (k/v one layer's pool planes
// [n_pool, Kh, page, hsz], kv slot s of request b at page
// tables[b, s / page], row s % page, S = max_pages * page).  Causal or not,
// sliding window, per-request kv lengths (lens) and q_offset, and the
// causal/window/length block skip of prefill_block_range.  Rows whose kv
// span is empty (lens == 0) give zeros.
//
// Both kernels: one thread block per (query block, kv head, batch row).  A
// query block is BQ = 64 / G (rounded down) query positions times the G
// query heads of the kv head: BQ * G live rows of the block's 64, which
// share every K/V tile.  When G does not divide 64 (hymba's G = 5: 12
// positions, 60 live rows) the 64 - BQ * G rows left over are dead: their
// Q loads as zeros, every key is masked for them, and they store nothing;
// each row's arithmetic is its own, so they change no live row's bits.
// G runs from 1 to 64.  The block loops over the kv
// tiles [lo, lo + nb) of prefill_block_range (blk_q = BQ, blk_k = 64), each
// tile at absolute slots kb * 64, with an online softmax in f32.  The tile
// loader is the only place that knows the layout, so the paged mode equals
// the fixed one bit for bit at any page size; kv rows at or beyond
// min(S, lens[b]) load as zeros in both (a paged table points such slots at
// a sink page of arbitrary data, and a masked p = 0 times a non-finite v
// would be NaN).  A row's bits depend only on its own q row and the tiles
// that hold its keys: a tile fully masked for a row is the identity update.
// So rows of chunked calls equal the same rows of one call.
//
// Bound: at T >= 512 the kernel does ~4*hsz flops per (query, key) pair
// against one read of each K/V row per query block, well above the ridge,
// so it is bound by operations (the bf16 tensor cores).
//
// bf16 (prefill_wgmma): one warpgroup of 128 threads owns the 64 rows.  Q
// is staged once in shared memory; K/V tiles of 64 keys stream through a
// 2-stage ring with 16-byte cp.async, the next tile landing while the
// current one is computed.  Each thread computes its rows' offsets (in
// paged mode, the table reads; shifts for a power-of-two page) once per
// tile for K and V together, before its copies start.  Q, K and V sit in
// the 128-byte-swizzled layout wgmma reads through shared-memory
// descriptors (64-column panels).  S = Q K^T runs as wgmma m64n64k16 (bf16
// in, f32 accumulate); the scale and the log2(e) of exp2 are applied to S
// in f32.  The online softmax runs on the accumulator fragments in
// registers (row max and sum over the 4 threads of a quad by shuffles;
// masks only on tiles a row does not fully see).  P is rounded to bf16 in
// registers and O += P V runs as wgmma with P from registers and V from
// shared memory (transposed B, one m64n64 product per 64-column panel of
// hsz).  The epilogue writes O / l in f32 -> bf16, zeros where l == 0.
// The two products and the softmax run in turn inside the warpgroup; the
// ~4 blocks on each SM overlap one another's.  (Issuing the next S before
// the softmax, so that P V runs under it, made ptxas serialize every wgmma
// (C7514: accumulators read while another wgmma is in flight) and was no
// faster.)
//
// Shared tiles hold whole 64-column panels: hsz 32 is zero-padded to one
// and hsz 96 (phi-3-vision) to two (HP = 128, chunks 12-15 of each row
// zero-filled by the copies).  S = Q K^T runs over the HSZ / 16 k-steps
// that hold data (6 at 96), not over the padding.  P V runs one m64n64
// product per panel, at 96 the second over 32 zero columns that the
// epilogue does not store.  That keeps one accumulator shape (32 f32 a
// thread a panel) and the 64-column swizzled panel the descriptors of
// every head size read; an m64n96 product would save those 25% of P V's
// products but need a 48-register fragment and a V tile laid across one
// and a half panels.
//
// f32 (prefill_kernel): both products on the CUDA cores in f32 with 4x4
// register tiles from shared memory; TF32 would lose the f32 parity checks.
#include "common.cuh"

namespace {

constexpr int ROWS = 64;   // query rows (positions x heads) per block
constexpr int BK = 64;     // keys per kv tile

struct PrefillArgs {
  const void* q;      // [B, T, Qh, hsz]
  const void* k;      // [B, S, Kh, hsz], or pool planes [n_pool, Kh, page, hsz]
  const void* v;
  const int* lens;    // [B] valid kv lengths, or nullptr: len0 for every row
  const int* offs;    // [B] global position of query row 0, or nullptr: off0
  const int* tables;  // [B, max_pages] pool pages, or nullptr (fixed layout)
  void* out;          // [B, T, Qh, hsz]
  int off0, len0;
  int B, T, S, Kh, G, causal, window, max_pages, page, page_shift;
  float scale;
};

// Element offset of kv row s of (batch b, kv head h) in either layout
// (page_shift >= 0: the page size is 1 << page_shift).
__device__ __forceinline__ long kv_row(const PrefillArgs& a, int b, int h, int s, int hsz) {
  if (a.tables == nullptr) return (((long)b * a.S + s) * a.Kh + h) * hsz;
  const int pg = a.page_shift >= 0 ? s >> a.page_shift : s / a.page;
  const int row = a.page_shift >= 0 ? s & (a.page - 1) : s % a.page;
  const int phys = a.tables[(long)b * a.max_pages + pg];
  return (((long)phys * a.Kh + h) * a.page + row) * hsz;
}

// prefill_block_range (reference: flash_prefill/kernel.py) with blk_q = bq,
// blk_k = BK: first tile and number of tiles of query block qb.
__device__ __forceinline__ void block_range(const PrefillArgs& a, int qb, int bq,
                                            int q_offset, int kv_len, int& lo, int& nb) {
  int hi_slot = min(a.S, kv_len);
  if (a.causal) hi_slot = min(hi_slot, q_offset + (qb + 1) * bq);
  const int lo_slot = a.window > 0 ? clampi(q_offset + qb * bq - a.window + 1, 0, a.S) : 0;
  lo = lo_slot / BK;
  nb = max(floordiv(hi_slot + BK - 1, BK) - lo, 0);
}

// ---------------------------------------------------------------- f32 path
constexpr int NT = 256;    // 16 x 16 threads
constexpr int RPT = 4;     // rows per thread
constexpr int CPT = BK / 16;  // key columns per thread

template <typename T, int HSZ>
__global__ void __launch_bounds__(NT) prefill_kernel(PrefillArgs a) {
  constexpr int VN = VecN<T>::N;
  constexpr int ROW_VECS = HSZ / VN;
  constexpr int KSP = HSZ + 1;
  constexpr int PSP = BK + 1;
  constexpr int DPT = HSZ / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;                  // [ROWS][HSZ]
  float* ks = qs + ROWS * HSZ;       // [BK][KSP]
  float* vs = ks + BK * KSP;         // [BK][HSZ]
  float* ps = vs + BK * HSZ;         // [ROWS][PSP]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int G = a.G;
  const int BQ = ROWS / G;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Qh = a.Kh * G;
  const int q_offset = a.offs ? a.offs[b] : a.off0;
  const int kv_len = a.lens ? a.lens[b] : a.len0;
  const int kv_hi = min(a.S, kv_len);   // rows at or beyond load as zeros

  const T* qp = reinterpret_cast<const T*>(a.q);
  const int live = BQ * G;   // rows r >= live are dead
  for (int e = tid; e < ROWS * ROW_VECS; e += NT) {
    const int r = e / ROW_VECS, c = (e % ROW_VECS) * VN;
    const int t = qb * BQ + r / G;
    float f[VN];
    if (r < live && t < a.T) {
      const long off = (((long)b * a.T + t) * Qh + h * G + r % G) * HSZ + c;
      unpack(*reinterpret_cast<const uint4*>(qp + off), f, T());
    } else {
#pragma unroll
      for (int u = 0; u < VN; ++u) f[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < VN; ++u) qs[r * HSZ + c + u] = f[u] * a.scale;
  }

  int lo, nb;
  block_range(a, qb, BQ, q_offset, kv_len, lo, nb);

  float m[RPT], l[RPT], o[RPT][DPT];
  int qpos[RPT];
  bool dead[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = REPRO_NEG_INF;
    l[i] = 0.f;
    qpos[i] = q_offset + qb * BQ + (ty * RPT + i) / G;
    dead[i] = ty * RPT + i >= live;
#pragma unroll
    for (int d = 0; d < DPT; ++d) o[i][d] = 0.f;
  }

  const T* kp = reinterpret_cast<const T*>(a.k);
  const T* vp = reinterpret_cast<const T*>(a.v);
  for (int kb = lo; kb < lo + nb; ++kb) {
    __syncthreads();   // previous tile fully consumed
    for (int e = tid; e < BK * ROW_VECS; e += NT) {
      const int r = e / ROW_VECS, c = (e % ROW_VECS) * VN;
      const int s = kb * BK + r;
      float kf[VN], vf[VN];
      if (s < kv_hi) {
        const long off = kv_row(a, b, h, s, HSZ) + c;
        unpack(*reinterpret_cast<const uint4*>(kp + off), kf, T());
        unpack(*reinterpret_cast<const uint4*>(vp + off), vf, T());
      } else {
#pragma unroll
        for (int u = 0; u < VN; ++u) { kf[u] = 0.f; vf[u] = 0.f; }
      }
#pragma unroll
      for (int u = 0; u < VN; ++u) { ks[r * KSP + c + u] = kf[u]; vs[r * HSZ + c + u] = vf[u]; }
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HSZ; ++d) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty * RPT + i) * HSZ + d];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * KSP + d];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    float alpha[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      bool ok[CPT];
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = kb * BK + tx + 16 * j;
        ok[j] = !dead[i] && kpos < kv_hi && (!a.causal || kpos <= qpos[i]) &&
                (a.window <= 0 || kpos > qpos[i] - a.window);
        if (!ok[j]) s[i][j] = REPRO_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty * RPT + i) * PSP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    float pv[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int d = 0; d < DPT; ++d) pv[i][d] = 0.f;
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float vv[DPT], pp[RPT];
#pragma unroll
      for (int d = 0; d < DPT; ++d) vv[d] = vs[c * HSZ + tx + 16 * d];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pp[i] = ps[(ty * RPT + i) * PSP + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int d = 0; d < DPT; ++d) pv[i][d] = fmaf(pp[i], vv[d], pv[i][d]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int d = 0; d < DPT; ++d) o[i][d] = alpha[i] * o[i][d] + pv[i][d];
  }

  T* op = reinterpret_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i;
    const int t = qb * BQ + r / G;
    if (dead[i] || t >= a.T) continue;
    const long base = (((long)b * a.T + t) * Qh + h * G + r % G) * HSZ;
#pragma unroll
    for (int d = 0; d < DPT; ++d)
      op[base + tx + 16 * d] = from_f<T>(l[i] > 0.f ? o[i][d] / fmaxf(l[i], 1e-37f) : 0.f);
  }
}

// --------------------------------------------------------- bf16 wgmma path
constexpr int WG = 128;              // one warpgroup
constexpr int PANEL = 64;            // bf16 columns per 128-byte swizzled row
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of 16-byte chunk c16 of row r in a tile of `rows` rows stored
// as 64-column panels, 128-byte rows, 128-byte swizzle (chunk ^= row % 8):
// the layout wgmma's SWIZZLE_128B descriptors read (tile base 1024-aligned).
__device__ __forceinline__ uint32_t sw_off(int r, int c16, int rows) {
  return (uint32_t)((c16 >> 3) * rows * 128 + r * 128 + (((c16 & 7) ^ (r & 7)) << 4));
}

// Shared-memory matrix descriptor: 128-byte swizzle, 8-row groups 1024 bytes
// apart (SBO), LBO unused (1) for swizzled layouts.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads/writes across wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D32                                                                           \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),       \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),    \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),    \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define WG_REGS32                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "   \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D32
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; A from registers (bf16 pairs), B
// MN-major in shared memory (transposed: rows of B's K are 128-byte rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_REGS32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// s = Q K^T (one commit group) over the first KD columns: Q and the K tile
// are [64][HP] in 64-column panels; each k16 step advances 32 bytes inside
// a panel's swizzled rows.
template <int KD>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t sq, uint32_t sk) {
  constexpr uint32_t PANEL_BYTES = ROWS * 64 * 2;
  static_assert(KD % 16 == 0, "whole k16 steps");
#pragma unroll
  for (int kk = 0; kk < KD / 16; ++kk) {
    const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
    wgmma_ss(s, sw128_desc(sq + off), sw128_desc(sk + off), kk > 0);
  }
  wgmma_commit();
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// HSZ: head size (32, 64, 96, 128, 256); HP: columns held in shared memory
// (HSZ rounded up to the 64-column panel; hsz 32 and 96 are zero-padded).  At 256 a
// thread holds 128 f32 of O (4 panels of 32) beside S's 32 and P's 16
// packed words: 219 registers, no spill and no serialized wgmma (ptxas,
// CUDA 12.8), and 164,864 bytes of shared memory (Q, K[2], V[2]).
template <int HSZ>
__global__ void __launch_bounds__(WG) prefill_wgmma(PrefillArgs a) {
  constexpr int HP = (HSZ + PANEL - 1) / PANEL * PANEL;
  constexpr int NP = HP / PANEL;               // panels
  constexpr int CH = HP / 8;                   // 16-byte chunks per row
  constexpr int CHV = HSZ / 8;                 // chunks holding data
  constexpr uint32_t TILE = ROWS * HP * 2;     // bytes of one Q / K / V tile
  static_assert(BK == ROWS, "one tile size for Q, K and V");
  static_assert(WG % CH == 0 && BK * CH % WG == 0, "whole rows per pass");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sq = (raw + 1023u) & ~1023u;  // Q, K[2], V[2]
  auto sk = [&](int st) { return sq + TILE * (1 + st); };
  auto sv = [&](int st) { return sq + TILE * (3 + st); };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int G = a.G;
  const int BQ = ROWS / G;
  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int Qh = a.Kh * G;
  const int q_offset = a.offs ? a.offs[b] : a.off0;
  const int kv_len = a.lens ? a.lens[b] : a.len0;
  const int kv_hi = min(a.S, kv_len);

  int lo, nb;
  block_range(a, qb, BQ, q_offset, kv_len, lo, nb);

  const bf16* qp = reinterpret_cast<const bf16*>(a.q);
  const bf16* kp = reinterpret_cast<const bf16*>(a.k);
  const bf16* vp = reinterpret_cast<const bf16*>(a.v);

  // kv rows [kb * 64, kb * 64 + 64) of K and V into stage st: this thread
  // copies chunk lc of rows lr + i * (WG / CH); all its row offsets (in
  // paged mode, table reads) are computed before the copies start
  constexpr int PER = BK * CH / WG;
  const int lr = tid / CH, lc = tid % CH;
  auto load_kv = [&](int kb, int st) {
    long off[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int s = kb * BK + lr + i * (WG / CH);
      off[i] = s < kv_hi && lc < CHV ? kv_row(a, b, h, s, HSZ) + lc * 8 : -1;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const uint32_t o = sw_off(lr + i * (WG / CH), lc, BK);
      const long g = off[i] < 0 ? 0 : off[i];
      cp_async16(sk(st) + o, kp + g, off[i] < 0 ? 0 : 16);
      cp_async16(sv(st) + o, vp + g, off[i] < 0 ? 0 : 16);
    }
  };
  if (nb > 0) {
    // Q tile: row r = position qb * BQ + r / G, head h * G + r % G; dead
    // rows (r >= BQ * G) load as zeros
    for (int e = tid; e < ROWS * CH; e += WG) {
      const int r = e / CH, c = e % CH;
      const int t = qb * BQ + r / G;
      const bool ok = r < BQ * G && t < a.T && c < CHV;
      const bf16* src = ok ? qp + (((long)b * a.T + t) * Qh + h * G + r % G) * HSZ + c * 8 : qp;
      cp_async16(sq + sw_off(r, c, ROWS), src, ok ? 16 : 0);
    }
    load_kv(lo, 0);
  }
  cp_async_commit();

  // this thread's two rows of the warpgroup's 64 (accumulator layout):
  // r0 = 16 * warp + lane / 4 and r0 + 8; columns 8 j + 2 (lane % 4) + {0, 1}.
  // A dead row sees no key (kmax = -1).
  const int r0 = 16 * warp + lane / 4;
  int kmin[2], kmax[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q_offset + qb * BQ + (r0 + 8 * i) / G;
    kmax[i] = r0 + 8 * i >= BQ * G ? -1 : a.causal ? min(qpos, kv_hi - 1) : kv_hi - 1;
    kmin[i] = a.window > 0 ? qpos - a.window + 1 : 0;
  }
  const float sl2 = a.scale * LOG2E;
  const float minus_inf = __int_as_float(0xff800000);

  float s[32], o[NP][32];
  uint32_t pa[4][4];
  float m[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[p][i] = 0.f;

  for (int it = 0; it < nb; ++it) {
    const int kb = lo + it, st = it % 2;
    if (it + 1 < nb) load_kv(kb + 1, st ^ 1);   // next tile, other stage
    cp_async_commit();
    cp_async_wait<1>();        // tile it (and Q) landed for this thread
    fence_async_smem();        // visible to the async proxy (wgmma)
    __syncthreads();

    // S = Q K^T
    fence_regs(s);
    wgmma_fence();
    issue_qk<HSZ>(s, sq, sk(st));
    wgmma_wait<0>();
    fence_regs(s);

    // masks (only on tiles a row does not fully see), scale, online softmax
    // on the fragments in the log2 domain; masked scores are -inf
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (kb * BK < kmin[i] || kb * BK + BK - 1 > kmax[i]) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = kb * BK + 8 * j + 2 * (lane % 4) + e;
            if (kpos < kmin[i] || kpos > kmax[i]) s[4 * j + 2 * i + e] = minus_inf;
          }
      }
      float mx = minus_inf;
#pragma unroll
      for (int j = 0; j < 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * sl2);
      alpha[i] = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[4 * j + 2 * i + e];
          x = exp2f(fmaf(x, sl2, -m_new));
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }

    // P (bf16, A-operand fragments) and O = alpha O + P V
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
#pragma unroll
    for (int p = 0; p < NP; ++p) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[p][4 * j + 0] *= alpha[0];
        o[p][4 * j + 1] *= alpha[0];
        o[p][4 * j + 2] *= alpha[1];
        o[p][4 * j + 3] *= alpha[1];
      }
      fence_regs(o[p]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs(o[p], pa[kk], sw128_desc(sv(st) + p * (TILE / NP) + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(o[p]);
    __syncthreads();           // stage st fully read before it is refilled
  }
  cp_async_wait<0>();

  bf16* op = reinterpret_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    const int t = qb * BQ + r / G;
    if (r >= BQ * G || t >= a.T) continue;
    const float den = fmaxf(l[i], 1e-37f);
    bf16* row = op + (((long)b * a.T + t) * Qh + h * G + r % G) * HSZ;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = p * PANEL + 8 * j + 2 * (lane % 4);
        if (d < HSZ)
          *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
              l[i] > 0.f ? o[p][4 * j + 2 * i] / den : 0.f,
              l[i] > 0.f ? o[p][4 * j + 2 * i + 1] / den : 0.f);
      }
  }
}

template <typename T, int HSZ>
cudaError_t launch(const PrefillArgs& a, cudaStream_t stream) {
  const int bq = ROWS / a.G;
  dim3 grid((a.T + bq - 1) / bq, a.Kh, a.B);
  if constexpr (sizeof(T) == 2) {
    constexpr int HP = (HSZ + PANEL - 1) / PANEL * PANEL;
    const size_t smem = 1024 + (size_t)ROWS * HP * 2 * 5;   // Q, K[2], V[2]
    cudaError_t err = allow_smem(prefill_wgmma<HSZ>, smem);
    if (err != cudaSuccess) return err;
    prefill_wgmma<HSZ><<<grid, WG, smem, stream>>>(a);
  } else {
    const size_t smem = sizeof(float) * (ROWS * HSZ + BK * (HSZ + 1) + BK * HSZ + ROWS * (BK + 1));
    cudaError_t err = allow_smem(prefill_kernel<T, HSZ>, smem);
    if (err != cudaSuccess) return err;
    prefill_kernel<T, HSZ><<<grid, NT, smem, stream>>>(a);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hsz(const PrefillArgs& a, int hsz, cudaStream_t stream) {
  switch (hsz) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 96: return launch<T, 96>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// tables == nullptr: fixed layout, S = kv length of k/v.  Otherwise k/v are
// pool planes [n_pool, Kh, page, hsz] and S = max_pages * page.  lens / offs
// == nullptr: every row takes len0 / off0.
extern "C" int flash_prefill_launch(const void* q, const void* k, const void* v,
                                    const void* lens, const void* offs,
                                    const void* tables, void* out, int off0,
                                    int len0, int dtype,
                                    int B, int T, int S, int Kh, int G, int hsz,
                                    int causal, int window, int max_pages,
                                    int page, float scale, void* stream) {
  if (G < 1 || G > ROWS || B * T * Kh == 0) return (int)cudaErrorInvalidValue;
  if (tables != nullptr && (page < 1 || max_pages < 1 || S != max_pages * page))
    return (int)cudaErrorInvalidValue;
  int page_shift = -1;
  for (int sh = 0; sh < 31 && tables != nullptr; ++sh)
    if (page == (1 << sh)) page_shift = sh;
  PrefillArgs a{q, k, v, static_cast<const int*>(lens), static_cast<const int*>(offs),
                static_cast<const int*>(tables), out, off0, len0, B, T, S, Kh, G,
                causal, window, max_pages, page, page_shift, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch_hsz<bf16>(a, hsz, s)
                               : launch_hsz<float>(a, hsz, s);
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
