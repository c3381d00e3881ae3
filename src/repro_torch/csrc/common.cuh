// Shared helpers of the port's kernels: 16-byte vector loads converted to
// float, float <-> storage-type conversion, the bf16 tensor-core product,
// floor division and the finite -inf the reference uses
// (repro_torch/utils.py NEG_INF).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define REPRO_NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;

template <typename T> struct VecN;
template <> struct VecN<float> { static constexpr int N = 4; };
template <> struct VecN<bf16> { static constexpr int N = 8; };
template <> struct VecN<int8_t> { static constexpr int N = 16; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Unpack one 16-byte vector into VecN<T>::N floats.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x); f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z); f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, bf16) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b2 = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    float2 p = __bfloat1622float2(b2);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// 16 int8 values (as floats; the caller applies the scale), exactly: the
// byte b + 128 goes into the mantissa of 2^23, then 2^23 + 128 is
// subtracted (a byte permute and an add per value, no int-to-float unit).
__device__ __forceinline__ void unpack(const uint4& u, float* f, int8_t) {
  const uint32_t w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                         u.w ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4B000000u, 0x7540u + i % 4))
           - 8388736.0f;
}

// d += a b on the tensor cores: mma.sync m16n8k16, A row-major 16x16 bf16
// (a0..a3), B column-major 16x8 bf16 (b0, b1), f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int floormod(int a, int b) {
  return a - floordiv(a, b) * b;
}
__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Hopper's largest opt-in dynamic shared memory per block (bytes).
constexpr int SMEM_OPTIN = 232448;

// Set the dynamic shared-memory limit when a kernel needs more than 48 KB;
// without it the launch is refused and only cudaGetLastError says so.
template <typename K>
__host__ inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}
