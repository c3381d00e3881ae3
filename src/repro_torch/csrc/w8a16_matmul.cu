// w8a16_matmul: x [M, K] (bf16/f32) @ qw [K, N] (int8) * scale [N] (f32),
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/w8a16_matmul/kernel.py
// w8a16_matmul_kernel (body _w8a16_kernel): int8 weights dequantized in the
// tile, f32 accumulation, the per-column scale applied once after the sum.
//
// Bound: on the decode path M is the batch (<= 8) against the int8 lm_head
// [2048, 49664], so the kernel reads ~100 MB of weights to do ~2 flops per
// weight byte per row -- far below Hopper's ~295 flop/byte ridge.  It is
// bound by weight bytes (3.35 TB/s).  What stands between a kernel and that
// bound is the per-weight instruction count: with f32 FMAs each weight costs
// a conversion plus M FMAs on CUDA cores, ~6 instructions at M = 4, 10 at
// M = 8, which at 100 M weights is about the byte bound's own time.
//
// Design: the weights are converted once and the products go to the tensor
// cores (mma.sync m16n8k16, bf16 in, f32 accumulate), so a weight costs
// ~2.75 instructions whatever M is up to 8: one pass over the weights for M
// <= 8 (x rows are the mma's n = 8).  A warp takes 128 columns x 16 K rows
// a step; each lane reads 4 rows x 16 columns as four 16-byte loads, 128
// bytes a row across the 8 lanes that share them.  The mma's m and k are
// mapped onto those bytes: m row g <-> column 16g + 2i (g + 8 <-> 16g + 2i +
// 1) in the warp's i-th mma, k pair (2q, 2q + 1) <-> rows 4q, 4q + 1 and
// (2q + 8, 2q + 9) <-> rows 4q + 2, 4q + 3, the same mapping for x.  int8 ->
// bf16 exactly without the conversion unit: the byte XOR 0x80 goes into the
// mantissa of 2^23 (a byte permute), one f32 subtract of 2^23 + 128 leaves
// the integer, whose top 16 bits are its bf16 (a second permute packs two).
// bf16 x is exact in the mma; f32 x is split into three bf16 terms (hi, mid,
// lo: ~24 bits) and takes three mmas.  The grid fills the card: one block
// a 128-column tile (x M tiles of 8 above M = 8), a warp keeping one step
// (four 16-byte loads a lane) in flight and registers capped so that 3
// blocks of 8 warps share an SM -- the lm_head's 388 tiles are one wave of
// the 396 resident blocks.  K is split inside the block: its 8 warps take
// the 16-row steps in turn and their sums meet in shared memory in warp
// order; no partial sums leave the block.  (K split across blocks as well,
// summed by a second launch, was slower at the lm_head, which one split
// already runs in one wave.)  Deterministic, not bit-exact with the plain
// version (another summation order).
#include "common.cuh"

namespace {

constexpr int NT = 256;            // threads per block (8 warps)
constexpr int WARPS = NT / 32;
constexpr int TN = 128;            // columns per block (one warp's width)
constexpr int TK = 16;             // K rows per warp step
constexpr int TM = 8;              // x rows per pass (the mma's n)
constexpr int RED = 36;            // padded floats per lane in the reduction
constexpr int BLOCKS_PER_SM = 3;   // registers capped at 80 a thread

struct Args {
  const void* x; const int8_t* qw; const float* scale;
  void* out;
  int M, K, N;
  bool vec;                        // 16-byte weight loads (N % 16 == 0)
};

// Byte E of a word already XORed with 0x80808080, as the f32 bits of its
// int8 value (exact); the bf16 of that value is the top 16 bits.
template <int E>
__device__ __forceinline__ uint32_t i8_f32(uint32_t w) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u + E)) - 8388736.0f);
}

// bf16x2 of the top halves: lo's in the low 16 bits, hi's in the high.
__device__ __forceinline__ uint32_t pack_top(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632u);
}

// Column byte C (0..15) of 16 weight bytes, as f32 bits.
template <int C>
__device__ __forceinline__ uint32_t col_bits(const uint4& w) {
  const uint32_t word = C < 4 ? w.x : C < 8 ? w.y : C < 12 ? w.z : w.w;
  return i8_f32<C % 4>(word);
}

// The I-th mma of a warp step: m row g <-> column 16g + 2I, m row g + 8 <->
// column 16g + 2I + 1 of the lane's 16; k pairs <-> its rows 0, 1 and 2, 3.
template <int I, int NS>
__device__ __forceinline__ void mma_cols(float (&d)[4], const uint4 (&w)[4],
                                         const uint32_t (&b)[NS][2]) {
  const uint32_t a[4] = {pack_top(col_bits<2 * I>(w[0]), col_bits<2 * I>(w[1])),
                         pack_top(col_bits<2 * I + 1>(w[0]), col_bits<2 * I + 1>(w[1])),
                         pack_top(col_bits<2 * I>(w[2]), col_bits<2 * I>(w[3])),
                         pack_top(col_bits<2 * I + 1>(w[2]), col_bits<2 * I + 1>(w[3]))};
#pragma unroll
  for (int t = 0; t < NS; ++t) mma_bf16(d, a, b[t]);
}

__device__ __forceinline__ uint4 load_row(const int8_t* qw, int row, int col,
                                          const Args& p) {
  if (row >= p.K) return make_uint4(0u, 0u, 0u, 0u);
  const int8_t* src = qw + (long long)row * p.N + col;
  if (p.vec) {
    if (col >= p.N) return make_uint4(0u, 0u, 0u, 0u);
    return __ldg(reinterpret_cast<const uint4*>(src));
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const uint32_t b = col + c < p.N ? (uint32_t)(uint8_t)src[c] : 0u;
    w[c / 4] |= b << (8 * (c % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// The x operand of one step: x[m][k], x[m][k + 1] and x[m][k + 2], x[m][k +
// 3] as bf16x2, NS terms (bf16 x: 1; f32 x: hi, mid, lo).
template <typename T> struct XOp;
template <> struct XOp<bf16> {
  static constexpr int NS = 1;
  __device__ static void load(const bf16* x, int m, int k, const Args& p,
                              uint32_t (&b)[NS][2]) {
    const uint16_t* r = reinterpret_cast<const uint16_t*>(x) + (long long)m * p.K;
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = (m < p.M && k + u < p.K) ? (uint32_t)__ldg(r + k + u) : 0u;
    b[0][0] = v[0] | (v[1] << 16);
    b[0][1] = v[2] | (v[3] << 16);
  }
};
template <> struct XOp<float> {
  static constexpr int NS = 3;
  __device__ static void load(const float* x, int m, int k, const Args& p,
                              uint32_t (&b)[NS][2]) {
    const float* r = x + (long long)m * p.K;
    uint32_t t[NS][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float v = (m < p.M && k + u < p.K) ? __ldg(r + k + u) : 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const bf16 h = __float2bfloat16_rn(v);
        t[s][u] = (uint32_t)__bfloat16_as_ushort(h);
        v -= __bfloat162float(h);
      }
    }
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      b[s][0] = t[s][0] | (t[s][1] << 16);
      b[s][1] = t[s][2] | (t[s][3] << 16);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, BLOCKS_PER_SM) w8a16_kernel(Args p) {
  __shared__ float4 red4[WARPS * 32 * RED / 4];
  float* red = reinterpret_cast<float*>(red4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int col = n0 + 16 * g;
  const int steps = (p.K + TK - 1) / TK;
  const T* x = static_cast<const T*>(p.x);
  constexpr int NS = XOp<T>::NS;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int s = warp; s < steps; s += WARPS) {
    const int k = s * TK + 4 * q;
    uint4 w[4];
    uint32_t b[NS][2];
#pragma unroll
    for (int r = 0; r < 4; ++r) w[r] = load_row(p.qw, k + r, col, p);
    XOp<T>::load(x, m0 + g, k, p, b);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      w[r].x ^= 0x80808080u;
      w[r].y ^= 0x80808080u;
      w[r].z ^= 0x80808080u;
      w[r].w ^= 0x80808080u;
    }
    mma_cols<0>(acc[0], w, b);
    mma_cols<1>(acc[1], w, b);
    mma_cols<2>(acc[2], w, b);
    mma_cols<3>(acc[3], w, b);
    mma_cols<4>(acc[4], w, b);
    mma_cols<5>(acc[5], w, b);
    mma_cols<6>(acc[6], w, b);
    mma_cols<7>(acc[7], w, b);
  }

  // the warps' sums meet in warp order
#pragma unroll
  for (int i = 0; i < 8; ++i)
    *reinterpret_cast<float4*>(red + (warp * 32 + lane) * RED + 4 * i) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  const int l = threadIdx.x / 8, i = threadIdx.x % 8;   // lane l's mma i
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  for (int w = 0; w < WARPS; ++w) {
    const float4 t = *reinterpret_cast<const float4*>(red + (w * 32 + l) * RED
                                                      + 4 * i);
    v[0] += t.x; v[1] += t.y; v[2] += t.z; v[3] += t.w;
  }
  // v: rows 2q, 2q + 1 of columns 16g + 2i, 16g + 2i + 1 (g, q of lane l)
  const int cbase = n0 + 16 * (l / 4) + 2 * i, rbase = m0 + 2 * (l % 4);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int m = rbase + (c & 1), n = cbase + (c >> 1);
    if (m < p.M && n < p.N)
      static_cast<T*>(p.out)[(long long)m * p.N + n] = from_f<T>(v[c] * p.scale[n]);
  }
}

template <typename T>
cudaError_t launch(Args p, cudaStream_t stream) {
  dim3 grid((p.N + TN - 1) / TN, (p.M + TM - 1) / TM);
  w8a16_kernel<T><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int w8a16_matmul_launch(const void* x, const void* qw,
                                   const void* scale, void* out, int dtype,
                                   int M, int K, int N, void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  Args p{x, static_cast<const int8_t*>(qw), static_cast<const float*>(scale),
         out, M, K, N, N % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch<bf16>(p, s) : launch<float>(p, s);
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
