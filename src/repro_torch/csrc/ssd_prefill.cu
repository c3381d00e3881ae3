// ssd_prefill: the Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_prefill/kernel.py
// ssd_prefill_kernel (body _ssd_kernel).  For each (batch, head) the tokens
// run in chunks of lc.  Per chunk, with cum = cumsum(dt * a):
//   intra:  y  = tril(C B^T o exp(cum_i - cum_j)) diag(dt) X
//   inter:  y += exp(cum_i) * (C h_in^T)
//   skip:   y += D * X
//   state:  h  = exp(cum_last) h_in + S,  S = sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// seeded from h0 (zeros when absent), returning h_final.
//
// Bound: at the serve shape (B 1, T 1024, nh 48, hd 64, ds 128, lc 64) the
// call must move ~23 MB (x, B/C and dt in, y and h out: ~7 us at 3.35 TB/s)
// and do ~2.8 GFLOP (~3 us on the bf16 tensor cores, 42 us on f32 CUDA
// cores): bound by bytes once the products are on the tensor cores.
//
// Design: the TPU walks the chunks in order on one core, carrying the state
// in scratch memory.  Here one block takes one chunk of one (batch, head),
// all of them launched at once, and the state is handed from chunk to chunk:
// a block computes everything that does not need the state it enters (C B^T
// and W, the chunk's own state S and decay), waits until the block of the
// chunk before has handed on its state, folds h = decay h_in + S and hands
// that on (a two-slot ring per (batch, head) in a workspace; the last chunk
// writes h_final), then computes its outputs.  Only the fold is sequential,
// elementwise over hd x ds; the handing on is the block's stores, a barrier
// and one thread's release store of a flag, which the next chunk's block
// acquires.  Blocks take their chunks from a ticket in the order they start
// (all heads' chunk 0, then chunk 1, ...), so a block only ever waits on one
// that has started.  The ticket and the flags live in a small buffer the wrapper
// zeroes once; the last ticket and each (batch, head)'s last chunk set them
// back to 0, so every launch finds them zeroed.  (A split into three
// launches -- every chunk's S, an in-order fold pass, the outputs -- moves
// the 25 MB of chunk states through device memory twice and was slower;
// scripts/torch_ssd_three_pass_ab.py times the two.)  Chunks sit at absolute
// lc boundaries from the start of the call and each chunk's S, decay and
// outputs depend on its tokens and its entering state only, so two calls
// chained through h_final at a multiple of lc give the same bits as one.
//
// The products run on the tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate).  bf16 inputs (x, B, C on the serve path) stay bf16 in shared
// memory and reach the mma by ldmatrix, as they are; f32 operands (W, h_in,
// seg * x, and x/B/C when the inputs are f32) sit in shared memory as f32
// and are split into bf16 terms as a fragment is read, by truncation (hi =
// the top 16 bits, mid and lo the same of what is left): three terms that
// sum to the f32 value exactly.  A product sums the term products whose
// orders add to at most 2 (3 mmas against a bf16 operand, 6 when x/B/C are
// f32; the dropped ones are below 2^-24 of the product).
// C B^T runs only on the 8-column tiles that reach the diagonal and the
// intra product only up to each row tile's diagonal.  S goes in tiles of 16
// x 64 a warp: the first 8 stay in registers through the wait; past hd * ds
// = 8192 (the serve shape's 64 x 128) the rest are computed before them and
// parked in shared memory (an instance of the kernel of its own, so the
// serve shape's code carries none of it): any hd and ds whose chunk fits
// in shared memory work.  The cumsum is a warp
// scan (two tokens a lane) that the plain version mirrors: the decay factors
// exp(cum_i - cum_j) take differences of sums of up to ~50, whose rounding
// would otherwise part the two by ~4e-6.  Shared-memory strides are padded
// so the fragment reads of a warp hit distinct banks.  B/C are read per
// group (g = head / (nh / G)) from the caller's layout with any batch and
// token strides (16-byte loads where aligned, all of a block's in flight at
// once); tokens past T in the last chunk load as zeros with dt = 0, the
// identity step.  The summation order differs from the plain version, so
// they agree to a tolerance, not bit for bit.
#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per block (8 warps)
constexpr int LC = 64;             // chunk tile: lc <= LC tokens
constexpr int UNITS = 4;           // 16-byte reads in flight a thread a matrix

struct Args {
  const void* x; long long sxb, sxt;
  const void* bm; long long sbb, sbt;
  const void* cm; long long scb, sct;
  const float* dt; const float* a; const float* d; const float* h0;
  float* y; float* hout;
  float* ring;            // [B * nh, 2, hd, ds]: the states handed on
  unsigned int* ctrl;     // [0] ticket, [1 + b * nh + h] chunks handed on
  int T, nh, hd, G, ds, lc, nc;
};

// Row strides (floats) of the shared-memory matrices: a fragment read along
// rows (float2, [m][k] or [n][k]) wants a stride of 8 mod 32, one down
// columns ([k][m] or [k][n]) 4 mod 16.
__host__ __device__ constexpr int srow(int cols) { return cols + 8; }
__host__ __device__ constexpr int scol(int cols) { return cols + 4; }

// x/B/C as they sit in shared memory: bf16 inputs stay bf16 (exact, read
// by ldmatrix), f32 inputs f32 (split into terms as they are read).
template <typename T> struct Store { using type = float; };
template <> struct Store<bf16> { using type = bf16; };

// Row stride of x [j][p]: columns read down (f32) or 16-byte rows for
// ldmatrix.trans (bf16).
template <typename S> __host__ __device__ constexpr int xrow(int hd) {
  return sizeof(S) == 2 ? hd + 8 : scol(hd);
}

// The chunk state S in units of 16 rows (of hd) x 64 columns (of ds), one a
// warp a round: the first round's stay in registers through the wait, the
// later rounds' (hd * ds > 8192) are parked in shared memory, a unit's
// fragments (8 tiles x 4 floats a lane) in PARK floats.
constexpr int PARK = 8 * 4 * 32;
__host__ __device__ constexpr int s_units(int hd, int ds) {
  return (hd / 16) * ((ds + 63) / 64);
}
__host__ __device__ constexpr int parked_units(int hd, int ds) {
  return s_units(hd, ds) > NT / 32 ? s_units(hd, ds) - NT / 32 : 0;
}

template <typename T>
size_t chunk_smem(int hd, int ds) {
  using S = typename Store<T>::type;
  const size_t b = (size_t)LC * srow(ds) * sizeof(S);
  const size_t h = (size_t)hd * srow(ds) * sizeof(float);
  return (size_t)LC * srow(ds) * sizeof(S) + (b > h ? b : h)
         + (size_t)LC * xrow<S>(hd) * sizeof(S)
         + sizeof(float) * ((size_t)LC * srow(LC) + 4 * LC
                            + (size_t)parked_units(hd, ds) * PARK);
}

template <typename T> struct Terms;                     // bf16 terms of an input
template <> struct Terms<bf16> { static constexpr int N = 1; };
template <> struct Terms<float> { static constexpr int N = 3; };

// The chunk's block coordinates: chunk c of (batch b, head h).
struct Chunk {
  int b, head, c, bh, t0, len, g;
};

// Chunk c of the (batch, head) bh.
__device__ __forceinline__ Chunk chunk_of(const Args& p, int c, int bh) {
  Chunk k;
  k.c = c;
  k.bh = bh;
  k.b = k.bh / p.nh;
  k.head = k.bh % p.nh;
  k.t0 = k.c * p.lc;
  k.len = min(p.lc, p.T - k.t0);
  k.g = k.head / (p.nh / p.G);
  return k;
}

// Warp 0: cum[j] = sum_{i <= j} dt_i a over the chunk (a warp scan, two
// tokens a lane; tokens past len have dt = 0), dts[j] = dt_j, and, when
// asked, ecum[j] = exp(cum[j]) and seg[j] = exp(cum_last - cum[j]) dt_j.
// The plain version (ops.chunk_cumsum) adds in this order; the _rn
// intrinsics keep nvcc from fusing a product into an add.
__device__ __forceinline__ void chunk_cumsum(const float* dt, long long stride,
                                             int len, float a, float* cum,
                                             float* dts, float* ecum,
                                             float* seg) {
  if (threadIdx.x >= 32) return;
  const int l = threadIdx.x, j0 = 2 * l, j1 = 2 * l + 1;
  const float d0 = j0 < len ? dt[j0 * stride] : 0.f;
  const float d1 = j1 < len ? dt[j1 * stride] : 0.f;
  const float v0 = __fmul_rn(d0, a), v1 = __fmul_rn(d1, a);
  float s = __fadd_rn(v0, v1);
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, s, o);
    if (l >= o) s = __fadd_rn(s, t);
  }
  float e = __shfl_up_sync(0xffffffffu, s, 1);
  if (l == 0) e = 0.f;
  const float c0 = __fadd_rn(e, v0), c1 = __fadd_rn(c0, v1);
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  cum[j0] = c0;
  cum[j1] = c1;
  dts[j0] = d0;
  dts[j1] = d1;
  if (ecum != nullptr) {
    ecum[j0] = expf(c0);
    ecum[j1] = expf(c1);
  }
  if (seg != nullptr) {
    seg[j0] = expf(last - c0) * d0;
    seg[j1] = expf(last - c1) * d1;
  }
}

// A rows x cols matrix of T in global memory (row stride gs elements), rows
// at or past `valid` read as zeros, staged into f32 shared memory (row
// stride ss) in two steps: load() issues every 16-byte read of a round at
// once into registers, store() converts them, times rs[row] when given.
// Rows must start 16-byte aligned with cols a multiple of 16 / sizeof(T)
// (aligned()); otherwise copy_rows reads element by element.
template <typename T, int UN>
struct Stage {
  static constexpr int E = 16 / sizeof(T);   // elements a 16-byte unit
  const T* src; long long gs; int rows, valid, per;
  uint4 u[UN];

  __device__ Stage(const T* s, long long g, int r, int v, int cols)
      : src(s), gs(g), rows(r), valid(v), per(cols / E) {}

  __device__ static bool aligned(const T* s, long long g, int cols) {
    return cols % E == 0
        && (reinterpret_cast<uintptr_t>(s) | (uintptr_t)(g * sizeof(T))) % 16 == 0;
  }
  __device__ int rounds() const { return (rows * per + UN * NT - 1) / (UN * NT); }

  __device__ void load(int round) {
#pragma unroll
    for (int k = 0; k < UN; ++k) {
      const int i = threadIdx.x + (round * UN + k) * NT, r = i / per;
      u[k] = (i < rows * per && r < valid)
                 ? __ldg(reinterpret_cast<const uint4*>(src + r * gs + (i - r * per) * E))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the units as they are, into shared memory of T (row stride ss)
  __device__ void store(int round, T* dst, int ss) const {
#pragma unroll
    for (int k = 0; k < UN; ++k) {
      const int i = threadIdx.x + (round * UN + k) * NT, r = i / per;
      if (i < rows * per)
        *reinterpret_cast<uint4*>(dst + r * ss + (i - r * per) * E) = u[k];
    }
  }

  __device__ void store(int round, float* dst, int ss, const float* rs) const {
#pragma unroll
    for (int k = 0; k < UN; ++k) {
      const int i = threadIdx.x + (round * UN + k) * NT, r = i / per;
      if (i < rows * per) {
        float v[E];
        unpack(u[k], v, T());
        if (rs != nullptr) {
#pragma unroll
          for (int e = 0; e < E; ++e) v[e] *= rs[r];
        }
        float4* o = reinterpret_cast<float4*>(dst + r * ss + (i - r * per) * E);
#pragma unroll
        for (int e = 0; e < E / 4; ++e)
          o[e] = make_float4(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3]);
      }
    }
  }
};

// One matrix on its own: round by round when aligned, else element by
// element.
template <typename T>
__device__ void copy_rows(float* dst, int ss, const T* src, long long gs,
                          int rows, int valid, int cols, const float* rs) {
  if (Stage<T, UNITS>::aligned(src, gs, cols)) {
    Stage<T, UNITS> st(src, gs, rows, valid, cols);
    for (int r = 0; r < st.rounds(); ++r) {
      st.load(r);
      st.store(r, dst, ss, rs);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int r = i / cols, c = i - r * cols;
    float v = r < valid ? to_f(src[r * gs + c]) : 0.f;
    if (rs != nullptr && r < valid) v *= rs[r];
    dst[r * ss + c] = v;
  }
}

// bf16 into bf16 shared memory, as it is.
__device__ void copy_rows(bf16* dst, int ss, const bf16* src, long long gs,
                          int rows, int valid, int cols, const float*) {
  if (Stage<bf16, UNITS>::aligned(src, gs, cols)) {
    Stage<bf16, UNITS> st(src, gs, rows, valid, cols);
    for (int r = 0; r < st.rounds(); ++r) {
      st.load(r);
      st.store(r, dst, ss);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += NT) {
    const int r = i / cols, c = i - r * cols;
    dst[r * ss + c] = r < valid ? src[r * gs + c] : __float2bfloat16(0.f);
  }
}

// ---- tensor-core fragments from f32 shared memory, split into bf16 terms

// The first NS bf16 terms of f (as f32 bits, the term in the top half; the
// low half of the last is left as it is, pack() reads only the top):
// truncation leaves at most 16, then 8 significant bits, so three terms sum
// to f exactly; a bf16 value is its own first term.
template <int NS>
__device__ __forceinline__ void split(float f, uint32_t (&t)[NS]) {
  uint32_t b = __float_as_uint(f);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    t[s] = s + 1 < NS ? b & 0xffff0000u : b;
    if (s + 1 < NS)
      b = __float_as_uint(__fsub_rn(__uint_as_float(b), __uint_as_float(t[s])));
  }
}

// Term s of (lo, hi) as bf16x2 in out[s][r], lo in the low half.
template <int NS, int R>
__device__ __forceinline__ void pack(float lo, float hi, uint32_t (&out)[NS][R],
                                     int r) {
  uint32_t a[NS], b[NS];
  split<NS>(lo, a);
  split<NS>(hi, b);
#pragma unroll
  for (int s = 0; s < NS; ++s) out[s][r] = __byte_perm(a[s], b[s], 0x7632u);
}

__device__ __forceinline__ float2 ld2(const float* s) {
  return *reinterpret_cast<const float2*>(s);
}

// A (16 x 16 at m0, k0) from a [m][k] matrix of stride S.
template <int NS>
__device__ __forceinline__ void frag_a_rows(const float* s, int S, int m0,
                                            int k0, uint32_t (&a)[NS][4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float* p = s + (m0 + g) * S + k0 + 2 * q;
  const float2 v0 = ld2(p), v1 = ld2(p + 8 * S), v2 = ld2(p + 8),
               v3 = ld2(p + 8 * S + 8);
  pack<NS>(v0.x, v0.y, a, 0);
  pack<NS>(v1.x, v1.y, a, 1);
  pack<NS>(v2.x, v2.y, a, 2);
  pack<NS>(v3.x, v3.y, a, 3);
}

// A (16 x 16 at m0, k0) from a [k][m] matrix of stride S.
template <int NS>
__device__ __forceinline__ void frag_a_cols(const float* s, int S, int m0,
                                            int k0, uint32_t (&a)[NS][4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float* p = s + (k0 + 2 * q) * S + m0 + g;
  pack<NS>(p[0], p[S], a, 0);
  pack<NS>(p[8], p[S + 8], a, 1);
  pack<NS>(p[8 * S], p[9 * S], a, 2);
  pack<NS>(p[8 * S + 8], p[9 * S + 8], a, 3);
}

// B (16 x 8 at k0, n0) from a [n][k] matrix of stride S.
template <int NS>
__device__ __forceinline__ void frag_b_rows(const float* s, int S, int n0,
                                            int k0, uint32_t (&b)[NS][2]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float* p = s + (n0 + g) * S + k0 + 2 * q;
  const float2 v0 = ld2(p), v1 = ld2(p + 8);
  pack<NS>(v0.x, v0.y, b, 0);
  pack<NS>(v1.x, v1.y, b, 1);
}

// B (16 x 8 at k0, n0) from a [k][n] matrix of stride S.
template <int NS>
__device__ __forceinline__ void frag_b_cols(const float* s, int S, int n0,
                                            int k0, uint32_t (&b)[NS][2]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
  const float* p = s + (k0 + 2 * q) * S + n0 + g;
  pack<NS>(p[0], p[S], b, 0);
  pack<NS>(p[8 * S], p[9 * S], b, 1);
}

// The same fragments from bf16 shared memory (exact values, one term) by
// ldmatrix: rows of 16 bytes, 16-byte aligned.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

template <int NS>
__device__ __forceinline__ void frag_a_rows(const bf16* s, int S, int m0,
                                            int k0, uint32_t (&a)[NS][4]) {
  static_assert(NS == 1, "bf16 values are their own single term");
  const int l = threadIdx.x & 31;
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0][0]), "=r"(a[0][1]), "=r"(a[0][2]), "=r"(a[0][3])
               : "r"(smem_u32(s + (m0 + (l & 15)) * S + k0 + (l >> 4) * 8)));
}

template <int NS>
__device__ __forceinline__ void frag_b_rows(const bf16* s, int S, int n0,
                                            int k0, uint32_t (&b)[NS][2]) {
  static_assert(NS == 1, "bf16 values are their own single term");
  const int l = threadIdx.x & 31;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0][0]), "=r"(b[0][1])
               : "r"(smem_u32(s + (n0 + (l & 7)) * S + k0 + ((l >> 3) & 1) * 8)));
}

template <int NS>
__device__ __forceinline__ void frag_b_cols(const bf16* s, int S, int n0,
                                            int k0, uint32_t (&b)[NS][2]) {
  static_assert(NS == 1, "bf16 values are their own single term");
  const int l = threadIdx.x & 31;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0][0]), "=r"(b[0][1])
               : "r"(smem_u32(s + (k0 + (l & 7) + ((l >> 3) & 1) * 8) * S + n0)));
}

// d += A B over the term products of order a + b <= 2, smallest first.
template <int NA, int NB>
__device__ __forceinline__ void mma_terms(float (&d)[4],
                                          const uint32_t (&a)[NA][4],
                                          const uint32_t (&b)[NB][2]) {
#pragma unroll
  for (int s = 2; s >= 0; --s)
#pragma unroll
    for (int i = 0; i < NA; ++i)
      if (s - i >= 0 && s - i < NB) mma_bf16(d, a[i], b[s - i]);
}

// u^T fragment (m = p, k = j) from x [j][p] times seg[j].
template <typename S>
__device__ __forceinline__ void frag_u(const S* xs, int R, const float* seg,
                                       int m0, int k0, uint32_t (&a)[3][4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3, j = k0 + 2 * q;
  const S* p = xs + j * R + m0 + g;
  const float s0 = seg[j], s1 = seg[j + 1], s8 = seg[j + 8], s9 = seg[j + 9];
  pack<3>(s0 * to_f(p[0]), s1 * to_f(p[R]), a, 0);
  pack<3>(s0 * to_f(p[8]), s1 * to_f(p[R + 8]), a, 1);
  pack<3>(s8 * to_f(p[8 * R]), s9 * to_f(p[9 * R]), a, 2);
  pack<3>(s8 * to_f(p[8 * R + 8]), s9 * to_f(p[9 * R + 8]), a, 3);
}

// acc = the 16 x 8nt tile of S at (m0, nb): sum over the chunk's tokens j
// of seg_j x_j[p] B_j[n] (zeros when nt = 0).
template <int NI, typename S>
__device__ __forceinline__ void s_tile(const S* xs, int xr, const float* seg,
                                       const S* bs, int ds, int len, int m0,
                                       int nb, int nt, float (&acc)[8][4]) {
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;
  if (nt == 0) return;
  for (int k0 = 0; k0 < len; k0 += 16) {
    uint32_t a[3][4];
    frag_u(xs, xr, seg, m0, k0, a);
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t < nt) {
        uint32_t b[NI][2];
        frag_b_cols<NI>(bs, srow(ds), nb + 8 * t, k0, b);
        mma_terms<3, NI>(acc[t], a, b);
      }
    }
  }
}

// hout = dec h_in + S over the tile of s_tile (h_in in shared memory).
__device__ __forceinline__ void fold_tile(const float* hs, int ds, float* hout,
                                          float dec, int m0, int nb, int nt,
                                          const float (&acc)[8][4]) {
  const int g = (threadIdx.x & 31) >> 2, q = threadIdx.x & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t < nt) {
      const int n = nb + 8 * t + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pr = m0 + g + 8 * h;
        const float* hi = hs + pr * srow(ds) + n;
        *reinterpret_cast<float2*>(hout + pr * ds + n) =
            make_float2(fmaf(dec, hi[0], acc[t][2 * h]),
                        fmaf(dec, hi[1], acc[t][2 * h + 1]));
      }
    }
  }
}

// One chunk of one (batch, head): W, S and the decay; the wait for the
// entering state; the fold, handed on; the outputs.
// PARKED: whether any unit of S is parked (compiled out when none is).
template <typename T, bool PARKED>
__global__ void __launch_bounds__(NT, 2) ssd_chunk_kernel(Args p) {
  constexpr int NI = Terms<T>::N;
  using S = typename Store<T>::type;
  extern __shared__ float4 smem4[];
  __shared__ int ticket;
  const int hd = p.hd, ds = p.ds, tid = threadIdx.x, warp = tid / 32;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int xr = xrow<S>(hd);
  const size_t bbytes = (size_t)LC * srow(ds) * sizeof(S),
               hbytes = (size_t)hd * srow(ds) * sizeof(float);
  S* cs = reinterpret_cast<S*>(smem4);           // [LC][srow(ds)]   C
  S* bs = cs + LC * srow(ds);                    // [LC][srow(ds)]   B, then
  float* hs = reinterpret_cast<float*>(bs);      //   h_in [hd][srow(ds)]
  S* xs = reinterpret_cast<S*>(reinterpret_cast<char*>(bs)
                               + (bbytes > hbytes ? bbytes : hbytes));  // [LC][xr] x
  float* wm = reinterpret_cast<float*>(xs + LC * xr);   // [LC][srow(LC)]   W
  float* cum = wm + LC * srow(LC);               // [LC]
  float* dts = cum + LC;                         // [LC]
  float* ecum = dts + LC;                        // [LC]
  float* seg = ecum + LC;                        // [LC]
  float* park = seg + LC;                        // [parked units][PARK]
  if (tid == 0) {
    ticket = (int)atomicAdd(p.ctrl, 1u);
    if (ticket == (int)gridDim.x - 1) atomicExch(p.ctrl, 0u);   // all taken
  }
  __syncthreads();
  const int bhs = gridDim.x / p.nc;
  const Chunk k = chunk_of(p, ticket / bhs, ticket % bhs);
  unsigned int* flag = p.ctrl + 1 + k.bh;
  const T* x = static_cast<const T*>(p.x) + k.b * p.sxb
               + (long long)k.t0 * p.sxt + (long long)k.head * hd;
  const T* bm = static_cast<const T*>(p.bm) + k.b * p.sbb
                + (long long)k.t0 * p.sbt + (long long)k.g * ds;
  const T* cm = static_cast<const T*>(p.cm) + k.b * p.scb
                + (long long)k.t0 * p.sct + (long long)k.g * ds;
  const float* dt = p.dt + ((long long)k.b * p.T + k.t0) * p.nh + k.head;

  // C, B and x all in flight while warp 0 scans dt
  {
    Stage<T, UNITS> sc(cm, p.sct, LC, k.len, ds), sb(bm, p.sbt, LC, k.len, ds),
        sx(x, p.sxt, LC, k.len, hd);
    const bool vec = Stage<T, UNITS>::aligned(cm, p.sct, ds)
                     && Stage<T, UNITS>::aligned(bm, p.sbt, ds)
                     && Stage<T, UNITS>::aligned(x, p.sxt, hd)
                     && sc.rounds() == 1 && sx.rounds() == 1;
    if (vec) {
      sc.load(0);
      sb.load(0);
      sx.load(0);
    }
    chunk_cumsum(dt, p.nh, k.len, p.a[k.head], cum, dts, ecum, seg);
    if (vec) {
      sc.store(0, cs, srow(ds));
      sb.store(0, bs, srow(ds));
      sx.store(0, xs, xr);
    } else {
      copy_rows(cs, srow(ds), cm, p.sct, LC, k.len, ds, nullptr);
      copy_rows(bs, srow(ds), bm, p.sbt, LC, k.len, ds, nullptr);
      copy_rows(xs, xr, x, p.sxt, LC, k.len, hd, nullptr);
    }
  }
  __syncthreads();

  // W from G = C B^T: m = i, n = j (a warp takes 32 of them), k = state;
  // tiles wholly above the diagonal or past len stay zero
  {
    const int m0 = (warp % 4) * 16, nb = (warp / 4) * 32;
    float acc[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;
    if (m0 < k.len) {
#pragma unroll 2
      for (int k0 = 0; k0 < ds; k0 += 16) {
        uint32_t a[NI][4];
        frag_a_rows<NI>(cs, srow(ds), m0, k0, a);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (nb + 8 * t <= m0 + 15) {
            uint32_t b[NI][2];
            frag_b_rows<NI>(bs, srow(ds), nb + 8 * t, k0, b);
            mma_terms<NI, NI>(acc[t], a, b);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = m0 + g + 8 * h, j = nb + 8 * t + 2 * q;
        float w[2];
#pragma unroll
        for (int c = 0; c < 2; ++c)
          w[c] = (j + c <= i && i < k.len)
                     ? acc[t][2 * h + c] * expf(cum[i] - cum[j + c]) * dts[j + c]
                     : 0.f;
        *reinterpret_cast<float2*>(wm + i * srow(LC) + j) = make_float2(w[0], w[1]);
      }
    }
  }

  // S: m = p (16-row tiles), n = n (64 columns), k = j, unit u at rows
  // 16 (u % mtiles), columns 64 (u / mtiles); warp w takes units w, w + 8,
  // ...: the later ones first, parked, then unit w, held in registers
  // through the wait
  const int mtiles = hd / 16, units = s_units(hd, ds);
  float sacc[8][4];
  if constexpr (PARKED) {
    for (int u = warp + NT / 32; u < units; u += NT / 32) {
      const int nb = (u / mtiles) * 64;
      s_tile<NI>(xs, xr, seg, bs, ds, k.len, (u % mtiles) * 16, nb,
                 min(8, (ds - nb) / 8), sacc);
      float4* pk = reinterpret_cast<float4*>(park + (u - NT / 32) * PARK) + (tid & 31);
#pragma unroll
      for (int t = 0; t < 8; ++t)
        pk[32 * t] = make_float4(sacc[t][0], sacc[t][1], sacc[t][2], sacc[t][3]);
    }
  }
  const int sm0 = (warp % mtiles) * 16, snb = (warp / mtiles) * 64;
  const int snt = warp < units ? min(8, (ds - snb) / 8) : 0;
  s_tile<NI>(xs, xr, seg, bs, ds, k.len, sm0, snb, snt, sacc);
  __syncthreads();                     // B read: r1 takes h_in

  // the entering state: h0 for chunk 0, else the one chunk c - 1 handed on
  if (tid == 0 && k.c > 0) {
    unsigned int v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(flag) : "memory");
    } while (v < (unsigned int)k.c);
  }
  __syncthreads();
  const long long hsz = (long long)hd * ds;
  const float4* hin = reinterpret_cast<const float4*>(
      k.c > 0 ? p.ring + (2 * k.bh + ((k.c - 1) & 1)) * hsz
              : (p.h0 != nullptr ? p.h0 + k.bh * hsz : nullptr));
  for (int e = tid; e < hd * ds / 4; e += NT) {
    const int pr = (4 * e) / ds, n = (4 * e) % ds;
    *reinterpret_cast<float4*>(hs + pr * srow(ds) + n) =
        hin != nullptr ? __ldcg(hin + e) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  // h = decay h_in + S, handed on (the last chunk's is h_final)
  {
    const float dec = expf(cum[LC - 1]);
    const bool last = k.c == p.nc - 1;
    float* hout = last ? p.hout + k.bh * hsz
                       : p.ring + (2 * k.bh + (k.c & 1)) * hsz;
    fold_tile(hs, ds, hout, dec, sm0, snb, snt, sacc);
    if constexpr (PARKED) {
      for (int u = warp + NT / 32; u < units; u += NT / 32) {
        const float4* pk =
            reinterpret_cast<const float4*>(park + (u - NT / 32) * PARK) + (tid & 31);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const float4 v = pk[32 * t];
          sacc[t][0] = v.x;
          sacc[t][1] = v.y;
          sacc[t][2] = v.z;
          sacc[t][3] = v.w;
        }
        const int nb = (u / mtiles) * 64;
        fold_tile(hs, ds, hout, dec, (u % mtiles) * 16, nb,
                  min(8, (ds - nb) / 8), sacc);
      }
    }
    __syncthreads();
    if (tid == 0)      // the last chunk leaves the flag zeroed for the next launch
      asm volatile("st.release.gpu.global.u32 [%0], %1;\n" :: "l"(flag), "r"(last ? 0u : (unsigned int)(k.c + 1)) : "memory");
  }

  // y: m = i, n = p (a warp takes 32 of them); inter k = state, intra k = j
  const float dskip = p.d[k.head];
  const long long yrow = (long long)p.nh * hd;
  float* y = p.y + ((long long)k.b * p.T + k.t0) * yrow + (long long)k.head * hd;
  const int ounits = 4 * ((hd + 31) / 32);
  for (int u = warp; u < ounits; u += NT / 32) {
    const int m0 = (u % 4) * 16, nb = (u / 4) * 32;
    if (m0 >= k.len) continue;
    const int ntile = min(4, (hd - nb) / 8);
    float inter[4][4], intra[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) inter[t][r] = intra[t][r] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < ds; k0 += 16) {
      uint32_t a[NI][4];
      frag_a_rows<NI>(cs, srow(ds), m0, k0, a);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < ntile) {
          uint32_t b[3][2];
          frag_b_rows<3>(hs, srow(ds), nb + 8 * t, k0, b);
          mma_terms<NI, 3>(inter[t], a, b);
        }
      }
    }
    const int kend = min(m0 + 16, k.len);
    for (int k0 = 0; k0 < kend; k0 += 16) {
      uint32_t a[3][4];
      frag_a_rows<3>(wm, srow(LC), m0, k0, a);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < ntile) {
          uint32_t b[NI][2];
          frag_b_cols<NI>(xs, xr, nb + 8 * t, k0, b);
          mma_terms<3, NI>(intra[t], a, b);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (t < ntile) {
        const int pc = nb + 8 * t + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = m0 + g + 8 * h;
          if (i < k.len) {
            const S* xi = xs + i * xr + pc;
            float o[2];
#pragma unroll
            for (int c = 0; c < 2; ++c)
              o[c] = intra[t][2 * h + c] + ecum[i] * inter[t][2 * h + c]
                     + dskip * to_f(xi[c]);
            *reinterpret_cast<float2*>(y + i * yrow + pc) = make_float2(o[0], o[1]);
          }
        }
      }
    }
  }
}

template <typename T, bool PARKED>
cudaError_t launch(const Args& args, int B, cudaStream_t stream) {
  const size_t smem = chunk_smem<T>(args.hd, args.ds);
  cudaError_t err = allow_smem(ssd_chunk_kernel<T, PARKED>, smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T, PARKED><<<B * args.nh * args.nc, NT, smem, stream>>>(args);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& args, int B, cudaStream_t stream) {
  return parked_units(args.hd, args.ds) > 0 ? launch<T, true>(args, B, stream)
                                            : launch<T, false>(args, B, stream);
}

}  // namespace

// ctrl: 1 + B * nh zeroed ints (the wrapper's; the kernel leaves them
// zeroed); ring: B * nh * 2 * hd * ds floats.
extern "C" int ssd_prefill_launch(
    const void* x, long long sxb, long long sxt,
    const void* bm, long long sbb, long long sbt,
    const void* cm, long long scb, long long sct,
    const void* dt, const void* a, const void* d, const void* h0,
    void* y, void* hout, void* ring, void* ctrl,
    int B, int T, int nh, int hd, int G, int ds, int lc, int nc,
    int dtype, void* stream) {
  if (B < 1 || T < 1 || nh < 1 || hd < 16 || hd % 16 != 0 || ds < 16
      || ds % 16 != 0 || lc < 1 || lc > LC || nc != (T + lc - 1) / lc
      || G < 1 || nh % G != 0
      || (dtype == 1 ? chunk_smem<bf16>(hd, ds) : chunk_smem<float>(hd, ds))
             > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Args args{x, sxb, sxt, bm, sbb, sbt, cm, scb, sct,
            static_cast<const float*>(dt), static_cast<const float*>(a),
            static_cast<const float*>(d), static_cast<const float*>(h0),
            static_cast<float*>(y), static_cast<float*>(hout),
            static_cast<float*>(ring), static_cast<unsigned int*>(ctrl),
            T, nh, hd, G, ds, lc, nc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch<bf16>(args, B, s)
                               : launch<float>(args, B, s);
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
