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
// bound by weight bytes (3.35 TB/s); tensor cores do not matter here.
//
// Design: each block owns BN = 256 output columns and sweeps all of K.  Its
// 8 warps split K by rows (warp w takes rows w, w+8, ...); a lane owns 8
// consecutive columns and reads them as one 8-byte load, so a warp reads one
// 256-byte row segment, coalesced.  Each warp keeps UNROLL row loads in
// flight before it computes on them.  The x rows of the current K chunk sit
// in shared memory as f32 (broadcast reads).  Accumulators are f32 in
// registers, one per (row, column); at the end the 8 warp partials are
// summed in warp order through shared memory (deterministic), multiplied
// by the column scale and stored in x's type.  Rows beyond M, K and columns
// beyond N are masked in the kernel; M above MT runs as more M tiles
// (grid.y), each re-reading the weights.  Not bit-exact with the plain
// version (another summation order).  Split-K across blocks and wgmma are
// later work.
#include "common.cuh"

namespace {

constexpr int NT = 256;             // threads per block (8 warps)
constexpr int WARPS = NT / 32;
constexpr int CPT = 8;              // columns per lane (one 8-byte load)
constexpr int BN = 32 * CPT;        // columns per block
constexpr int MT = 4;               // x rows per block
constexpr int KC = 512;             // K rows of x staged in shared memory
constexpr int UNROLL = 8;           // weight rows in flight per warp

__device__ __forceinline__ uint2 load8(const int8_t* row, int n0, int N,
                                       bool vec) {
  if (vec && n0 + CPT <= N) return *reinterpret_cast<const uint2*>(row + n0);
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const uint32_t b = n0 + c < N ? (uint32_t)(uint8_t)row[n0 + c] : 0u;
    w[c / 4] |= b << (8 * (c % 4));
  }
  return make_uint2(w[0], w[1]);
}

__device__ __forceinline__ void unpack8(const uint2& u, float* f) {
  const uint32_t w[2] = {u.x, u.y};
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    f[c] = (float)(int8_t)((w[c / 4] >> (8 * (c % 4))) & 0xffu);
}

template <typename T>
__global__ void __launch_bounds__(NT) w8a16_kernel(
    const T* __restrict__ x, const int8_t* __restrict__ qw,
    const float* __restrict__ scale, T* __restrict__ out, int M, int K, int N,
    bool vec) {
  __shared__ float xs[MT][KC];
  __shared__ float part[WARPS][MT][BN];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nb = blockIdx.x * BN;
  const int n0 = nb + lane * CPT;
  const int m0 = blockIdx.y * MT;

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    __syncthreads();                  // the previous chunk's reads are done
    for (int i = threadIdx.x; i < MT * KC; i += NT) {
      const int m = i / KC, kk = i % KC;
      xs[m][kk] = (m0 + m < M && kk < kc)
                      ? to_f(x[(long)(m0 + m) * K + k0 + kk]) : 0.f;
    }
    __syncthreads();
    for (int kk = warp; kk < kc; kk += WARPS * UNROLL) {
      uint2 w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kr = kk + u * WARPS;
        w[u] = kr < kc ? load8(qw + (long)(k0 + kr) * N, n0, N, vec)
                       : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int kr = kk + u * WARPS;
        if (kr < kc) {
          float wf[CPT];
          unpack8(w[u], wf);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const float xv = xs[m][kr];
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) part[warp][m][lane * CPT + c] = acc[m][c];
  __syncthreads();
  for (int i = threadIdx.x; i < MT * BN; i += NT) {
    const int m = i / BN, c = i % BN;
    const int n = nb + c;
    if (m0 + m < M && n < N) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) s += part[w][m][c];
      out[(long)(m0 + m) * N + n] = from_f<T>(s * scale[n]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* qw, const void* scale, void* out,
                   int M, int K, int N, cudaStream_t stream) {
  const bool vec = N % CPT == 0 && reinterpret_cast<uintptr_t>(qw) % 8 == 0;
  dim3 grid((N + BN - 1) / BN, (M + MT - 1) / MT);
  w8a16_kernel<T><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(qw),
      static_cast<const float*>(scale), static_cast<T*>(out), M, K, N, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int w8a16_matmul_launch(const void* x, const void* qw,
                                   const void* scale, void* out, int dtype,
                                   int M, int K, int N, void* stream) {
  if (M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch<bf16>(x, qw, scale, out, M, K, N, s)
                               : launch<float>(x, qw, scale, out, M, K, N, s);
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
