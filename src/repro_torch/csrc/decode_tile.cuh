// The decode sweep's shared parts: the K/V tile pipeline and the tile's
// online-softmax update, used by decode_kernel (flash_decode.cu) and
// prefix_kernel (prefix_pass.cu).
//
// Grouped decode is bit-exact with ungrouped decode only if every query row
// sees the same arithmetic in both: the same tiles of TS slots, the same
// scale multiply, the same fmaf order in q.k and p.v, the same lane order
// of the max and sum reductions and the same expf.  Both kernels therefore
// call tile_update below (and load tiles with TilePipe), never a copy of it.
//
// A tile whose slots are all masked for a row is an exact identity update
// of that row from any state (m_new = m, alpha = expf(0) = 1, p = 0), so a
// sweep may visit extra masked tiles without changing a bit.
#pragma once
#include "common.cuh"

#include <type_traits>

namespace decode_tile {

constexpr int NT = 128;   // threads per block (4 warps)
constexpr int TS = 32;    // slots per tile (one per lane in the softmax)

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Global position of local slot jj of KVP rank `rank` (round-robin layout).
__device__ __forceinline__ int rr_position(int jj, int rank, int kvp, int rr) {
  return ((jj / rr) * kvp + rank) * rr + jj % rr;
}

// K/V tiles of one shard into shared memory, TS slots at a time: 16-byte
// loads into registers (gload, issued one tile ahead), then conversion to
// float (int8: times the slot's f32 scale) into ks/vs (sstore).  Fixed
// layout: slot jj is storage row row0 + jj.  Paged (tab != null): slot jj
// is row z*ps + jj%ps of physical page tab[jj/ps].
template <typename KT, int HSZ>
struct TilePipe {
  static constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  static constexpr int VN = VecN<KT>::N;
  static constexpr int ROW_VECS = HSZ / VN;
  static constexpr int TILE_VECS = TS * ROW_VECS;
  static constexpr int LOADS = (TILE_VECS + NT - 1) / NT;
  static constexpr int SP = HSZ + 1;   // padded smem row

  const KT* kp;
  const KT* vp;
  const float* ksc;   // int8 mode only
  const float* vsc;
  const int* tab;     // this request's table row (paged), else null
  long row0;          // fixed layout: storage row of slot 0
  int Kh, h, n_ranks, z, ps, s_loc;
  uint4 kr[LOADS], vr[LOADS];
  float ksr[LOADS], vsr[LOADS];

  __device__ __forceinline__ long slot_row(int jj) const {
    if (tab == nullptr) return row0 + jj;
    return (((long)tab[jj / ps] * Kh + h) * n_ranks + z) * ps + jj % ps;
  }

  __device__ __forceinline__ void gload(int tile, int tid) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * NT;
      kr[i] = make_uint4(0, 0, 0, 0);
      vr[i] = make_uint4(0, 0, 0, 0);
      ksr[i] = vsr[i] = 0.f;
      if (e < TILE_VECS) {
        const int jj = tile * TS + e / ROW_VECS;
        if (jj < s_loc) {
          const long row = slot_row(jj);
          const long off = row * HSZ + (e % ROW_VECS) * VN;
          kr[i] = *reinterpret_cast<const uint4*>(kp + off);
          vr[i] = *reinterpret_cast<const uint4*>(vp + off);
          if (Q8) { ksr[i] = ksc[row]; vsr[i] = vsc[row]; }
        }
      }
    }
  }

  // Slot j_sub of this tile (if it lies here) takes the row ksub/vsub
  // instead of what was loaded (the fused append); int8 mode multiplies
  // the substituted int-valued row by its scale sub_sc[0] / sub_sc[1].
  __device__ __forceinline__ void sstore(int tile, int tid, float* ks, float* vs,
                                         int j_sub, const float* ksub,
                                         const float* vsub, const float* sub_sc) {
#pragma unroll
    for (int i = 0; i < LOADS; ++i) {
      const int e = tid + i * NT;
      if (e < TILE_VECS) {
        const int r = e / ROW_VECS;
        const int c = (e % ROW_VECS) * VN;
        float kf[VN], vf[VN];
        if (tile * TS + r == j_sub) {
#pragma unroll
          for (int u = 0; u < VN; ++u) {
            kf[u] = Q8 ? ksub[c + u] * sub_sc[0] : ksub[c + u];
            vf[u] = Q8 ? vsub[c + u] * sub_sc[1] : vsub[c + u];
          }
        } else {
          unpack(kr[i], kf, KT());
          unpack(vr[i], vf, KT());
          if (Q8) {
#pragma unroll
            for (int u = 0; u < VN; ++u) { kf[u] *= ksr[i]; vf[u] *= vsr[i]; }
          }
        }
#pragma unroll
        for (int u = 0; u < VN; ++u) { ks[r * SP + c + u] = kf[u]; vs[r * SP + c + u] = vf[u]; }
      }
    }
  }
};

// One tile of the online softmax for R query rows held in shared memory:
// qs [R][HSZ] scaled queries, ks/vs [TS][HSZ+1] the tile, ps [R][TS]
// scratch, row_m/row_l/row_a [R] and acc [R][HSZ] the raw state.  Rows
// come in members of G rows; valid [members][TS] masks each member's slots.
// Ends with a block barrier.
template <int HSZ>
__device__ __forceinline__ void tile_update(const float* qs, const float* ks,
                                            const float* vs, float* ps,
                                            float* row_m, float* row_l,
                                            float* row_a, float* acc,
                                            const int* valid, int R, int G,
                                            int tid) {
  constexpr int SP = HSZ + 1;
  for (int idx = tid; idx < R * TS; idx += NT) {
    const int g = idx / TS, j = idx % TS;
    float s = 0.f;
#pragma unroll 16
    for (int d = 0; d < HSZ; ++d) s = fmaf(qs[g * HSZ + d], ks[j * SP + d], s);
    ps[g * TS + j] = valid[(g / G) * TS + j] ? s : REPRO_NEG_INF;
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int g = warp; g < R; g += NT / 32) {
    const float s = ps[g * TS + lane];
    const float m_prev = row_m[g];
    const float m_new = fmaxf(m_prev, warp_max(s));
    const float alpha = expf(m_prev - m_new);
    const float p = valid[(g / G) * TS + lane] ? expf(s - m_new) : 0.f;
    const float sum = warp_sum(p);
    ps[g * TS + lane] = p;
    if (lane == 0) {
      row_l[g] = alpha * row_l[g] + sum;
      row_m[g] = m_new;
      row_a[g] = alpha;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * HSZ; idx += NT) {
    const int g = idx / HSZ, d = idx % HSZ;
    float pv = 0.f;
#pragma unroll 8
    for (int j = 0; j < TS; ++j) pv = fmaf(ps[g * TS + j], vs[j * SP + d], pv);
    acc[idx] = row_a[g] * acc[idx] + pv;
  }
  __syncthreads();
}

}  // namespace decode_tile
