// The decode sweep's shared parts, used by decode_kernel (flash_decode.cu)
// and prefix_kernel (prefix_pass.cu): the chunk partition of a KV shard, the
// cp.async tile ring, the ONE online-softmax tile update and the exact
// in-order merge of chunk partials.
//
// Chunks.  A rank's local slots are cut at absolute boundaries into chunks
// of CH = CPT * TS slots (8 tiles of 32).  A CTA sweeps the tiles of a
// chunk from the cold state (m = REPRO_NEG_INF, l = 0, acc = 0) and writes
// the raw partial (acc, m, l) of its rows (of consecutive chunks, one
// partial each); one pass per (rank, row, kv head) then folds the partials
// in ascending chunk order (merge_step).  CH
// depends on nothing but these constants: not on lengths, capacity, layout,
// pruning or grouping, so every mode sees the same partials.
//
// Bit-exactness.  Grouped decode equals ungrouped decode, pruned equals
// dense, paged equals fixed and fused equals unfused only if every query
// row sees the same arithmetic in each: the same tiles of TS slots in the
// same chunks, the same order of products and sums in q.k and p.v, the
// same lane order of the max and sum reductions, the same expf, and the
// same merge order.  Both kernels therefore call tile_update below, whose
// per-row instruction sequence does not depend on how many rows a warp or
// a CTA holds (nor on the CTA's size), and never a copy of it.
//
// Identities.  A tile whose slots are all masked for a row is an exact
// identity update of that row from any state (m_new = m, alpha = expf(0) =
// 1, p = 0), so a sweep may visit extra masked tiles without changing a
// bit; a chunk whose tiles are all masked yields the cold partial.  The
// merge skips a partial with l == 0 (an empty chunk) and takes the first
// non-empty partial as it is, so empty partials are exact identities from
// either side by construction.  REPRO_NEG_INF is finite: never -inf.
//
// Layout in shared memory.  K/V tiles stay in their storage type (f32,
// bf16, or int8 with f32 per-slot scales in a separate array) and are
// converted at use.  A tile is TS rows of HSZ elements; its RV 16-byte
// units are permuted per row (swz) so that the 32 lanes of a warp, one
// slot each, read one unit of 32 different rows without bank conflicts.
// The units in whole groups of 8 are XORed with row & 7 inside their
// group; a tail of T < 8 units (RV = 2, 4; 6 for int8 at head size 96;
// the last 4 of bf16's 12 at 96) is XORed inside itself when T is a power
// of two and rotated by one every 4 rows otherwise, so each 8 lanes read 8
// distinct bank groups at every RV built, and swz stays inside the row.
// Layout::swz_ok checks the permutation at compile time for each layout.
#pragma once
#include "common.cuh"

#include <type_traits>

namespace decode_tile {

constexpr int TS = 32;         // slots per tile (one per lane)
constexpr int CPT = 8;         // tiles per chunk
constexpr int CH = TS * CPT;   // slots per chunk
constexpr long ROW_NONE = -1;  // slot at or past s_loc: zero-filled
constexpr long ROW_SUB = -2;   // the fused append's slot: the new row

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
// Every lane ends with the same bits (each xor step adds the same two
// values on both lanes of a pair); ref._lane0_sum mirrors the order.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int local_valid_len(int tl, int rank, int kvp, int rr) {
  const int cycle = kvp * rr;
  return (tl / cycle) * rr + clampi(tl % cycle - rank * rr, 0, rr);
}

// [lo, hi): the local slots of one rank that a request of global length tl
// attends to (pruning.valid_slot_span).  Positions grow with the slot, so
// the slots with pos < tl and pos >= tl - window form one interval; the
// mask of a slot is lo <= jj < hi.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span valid_span(int tl, int rank, int kvp, int rr, int s_loc,
                                           int window, int slot_offset, bool contiguous) {
  tl = max(tl, 0);
  int j_hi, j_lo;
  if (contiguous) {
    j_hi = tl - rank * s_loc;
    j_lo = tl - window - rank * s_loc;
  } else {
    j_hi = local_valid_len(tl, rank, kvp, rr);
    j_lo = local_valid_len(max(tl - window, 0), rank, kvp, rr);
  }
  Span s;
  s.hi = clampi(j_hi - slot_offset, 0, s_loc);
  s.lo = window > 0 ? clampi(j_lo - slot_offset, 0, s_loc) : 0;
  return s;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16-byte async copy; src_bytes 0 zero-fills the destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Sizes of one K/V tile of storage type KT and head size HSZ.
template <typename KT, int HSZ>
struct Layout {
  static constexpr bool Q8 = std::is_same<KT, int8_t>::value;
  static constexpr int VN = 16 / (int)sizeof(KT);   // elements per 16-byte unit
  static constexpr int RV = HSZ / VN;               // units per row
  static constexpr int DPL = HSZ / 32;              // p.v dims per lane
  static constexpr int ELEMS = TS * HSZ;
  static constexpr int STAGE_BYTES = 2 * ELEMS * (int)sizeof(KT) + (Q8 ? 2 * TS * 4 : 0);
  // ring depth: ~32 KB of tiles per CTA, 3..CPT stages (several CTAs per SM)
  static constexpr int NS0 = 32768 / STAGE_BYTES;
  static constexpr int NS = NS0 < 3 ? 3 : (NS0 > CPT ? CPT : NS0);
  static constexpr int RING_BYTES = NS * STAGE_BYTES;
  static constexpr int G8 = RV / 8 * 8;             // units in groups of 8
  static constexpr int T = RV - G8;                 // the tail's units
  __host__ __device__ static constexpr int swz(int row, int u) {
    return u < G8 ? (u ^ (row & 7))
           : (T & (T - 1)) == 0 ? G8 + ((u - G8) ^ ((row * T / 8) % T))
                                : G8 + (u - G8 + ((row >> 2) & 1)) % T;
  }
  // swz maps each row's units [0, RV) onto themselves, one to one
  static constexpr bool swz_ok() {
    if (RV < 1 || RV > 64 || RV * VN != HSZ) return false;
    for (int row = 0; row < TS; ++row) {
      unsigned long long seen = 0;
      for (int u = 0; u < RV; ++u) {
        const int w = swz(row, u);
        if (w < 0 || w >= RV || ((seen >> w) & 1)) return false;
        seen |= 1ull << w;
      }
    }
    return true;
  }
};

// The ring of NS tile stages in shared memory and the copies that fill it.
// roff[jl] is the storage row of slot jl of the chunk (fixed: row0 + jj;
// paged: through the block table, resolved once per CTA), ROW_NONE for a
// slot at or past s_loc (zero-filled), ROW_SUB for the fused append's
// slot, whose row is taken from sub_k/sub_v instead (fp: the new row in
// global memory; int8: the quantized row in shared memory, with its
// scales).  Every thread issues 16-byte cp.async copies of its units
// (int8 scales: 4-byte copies); unit u of row r lands at swz(r, u).
template <typename KT, int HSZ, int NT>
struct Ring {
  using L = Layout<KT, HSZ>;
  static_assert(L::swz_ok(), "swz must permute each row's 16-byte units");
  static constexpr int UNITS = TS * L::RV;   // 16-byte units per K (or V) tile
  static constexpr int UPT = (UNITS + NT - 1) / NT;
  KT* ks;              // [NS][ELEMS]
  KT* vs;
  float* kss;          // [NS][TS] (int8 only)
  float* vss;
  const KT* kg;        // cache planes
  const KT* vg;
  const float* ksg;    // scale planes (int8 only)
  const float* vsg;
  const long* roff;    // [CH]
  const KT* sub_k;
  const KT* sub_v;
  const float* sub_sc; // [2] (int8 only)

  __device__ __forceinline__ KT* kstage(int s) const { return ks + s * L::ELEMS; }
  __device__ __forceinline__ KT* vstage(int s) const { return vs + s * L::ELEMS; }

  // Copy tile lt of the chunk (slots lt*TS ..) into stage s.
  __device__ __forceinline__ void issue(int lt, int s, int tid) const {
    KT* kd = kstage(s);
    KT* vd = vstage(s);
#pragma unroll
    for (int i = 0; i < UPT; ++i) {
      const int idx = tid + i * NT;
      if (UNITS % NT != 0 && idx >= UNITS) break;
      const int r = idx / L::RV, u = idx % L::RV;
      const long ro = roff[lt * TS + r];
      const int so = r * HSZ + L::swz(r, u) * L::VN;
      if (ro >= 0) {
        cp_async16(kd + so, kg + ro * HSZ + u * L::VN, 16);
        cp_async16(vd + so, vg + ro * HSZ + u * L::VN, 16);
      } else if (ro == ROW_SUB) {
        *reinterpret_cast<uint4*>(kd + so) = *reinterpret_cast<const uint4*>(sub_k + u * L::VN);
        *reinterpret_cast<uint4*>(vd + so) = *reinterpret_cast<const uint4*>(sub_v + u * L::VN);
      } else {
        cp_async16(kd + so, kg, 0);
        cp_async16(vd + so, vg, 0);
      }
    }
    if (L::Q8 && tid < 2 * TS) {
      const bool isv = tid >= TS;
      const int r = tid % TS;
      const long ro = roff[lt * TS + r];
      float* d = (isv ? vss : kss) + s * TS + r;
      if (ro >= 0) cp_async4(d, (isv ? vsg : ksg) + ro);
      else *d = ro == ROW_SUB ? sub_sc[isv ? 1 : 0] : 0.f;
    }
  }
};

// The online-softmax state of the rows one warp holds, in registers: rows
// warp + NW*k for k < n (n <= RW), NW warps per CTA.  lo/hi: each row's valid slots.  m and l
// are the same on every lane; lane i holds acc for dims [i*DPL, (i+1)*DPL).
template <int HSZ, int RW>
struct Rows {
  static constexpr int DPL = HSZ / 32;
  int n;
  int lo[RW], hi[RW];
  float m[RW], l[RW], acc[RW][DPL];

  __device__ __forceinline__ void cold() {
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      m[k] = REPRO_NEG_INF;
      l[k] = 0.f;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[k][d] = 0.f;
    }
  }
};

// Load this lane's DPL dims of row j of a V tile as floats.  Dims of
// different 16-byte units sit at different swizzled places, so DPL beyond
// one unit (f32 at hsz 256: 8 dims, two units) loads unit by unit, and a
// DPL that does not divide the unit (3 at hsz 96: a lane's dims may
// straddle two units) element by element, each through its own unit.
template <typename KT, int HSZ>
__device__ __forceinline__ void load_dims(const KT* vt, int j, int lane, float* f) {
  using L = Layout<KT, HSZ>;
  constexpr int DPL = L::DPL;
  const int d0 = lane * DPL;
  if constexpr (L::VN % DPL != 0 && DPL < L::VN) {
#pragma unroll
    for (int d = 0; d < DPL; ++d) {
      const int e = d0 + d;
      const KT x = vt[j * HSZ + L::swz(j, e / L::VN) * L::VN + e % L::VN];
      if constexpr (std::is_same<KT, int8_t>::value)
        f[d] = __uint_as_float(0x4B000000u | (uint32_t)((uint8_t)x ^ 0x80u)) - 8388736.0f;
      else
        f[d] = to_f(x);
    }
    return;
  }
  if constexpr (DPL > L::VN) {
    constexpr int UPL = DPL / L::VN;   // whole units per lane
#pragma unroll
    for (int i = 0; i < UPL; ++i) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          vt + j * HSZ + L::swz(j, d0 / L::VN + i) * L::VN);
      unpack(raw, f + i * L::VN, KT());
    }
    return;
  }
  const KT* p = vt + j * HSZ + L::swz(j, d0 / L::VN) * L::VN + d0 % L::VN;
  if constexpr (std::is_same<KT, float>::value) {
    if constexpr (DPL == 4) {
      const float4 x = *reinterpret_cast<const float4*>(p);
      f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
    } else if constexpr (DPL == 2) {
      const float2 x = *reinterpret_cast<const float2*>(p);
      f[0] = x.x; f[1] = x.y;
    } else {
      f[0] = *p;
    }
  } else if constexpr (std::is_same<KT, bf16>::value) {
    if constexpr (DPL == 8) {
      unpack(*reinterpret_cast<const uint4*>(p), f, KT());
    } else if constexpr (DPL == 4) {
      const uint2 w = *reinterpret_cast<const uint2*>(p);
      f[0] = __uint_as_float(w.x << 16); f[1] = __uint_as_float(w.x & 0xffff0000u);
      f[2] = __uint_as_float(w.y << 16); f[3] = __uint_as_float(w.y & 0xffff0000u);
    } else if constexpr (DPL == 2) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
      f[0] = __uint_as_float(w << 16); f[1] = __uint_as_float(w & 0xffff0000u);
    } else {
      f[0] = __bfloat162float(*p);
    }
  } else {
    // int8, exactly as unpack: b + 128 in the mantissa of 2^23
#pragma unroll
    for (int d = 0; d < DPL; ++d)
      f[d] = __uint_as_float(0x4B000000u | (uint32_t)((uint8_t)p[d] ^ 0x80u)) - 8388736.0f;
  }
}

// ONE tile of the online softmax for the rows of this warp.  qs: the CTA's
// scaled query rows [rows][HSZ] (f32); kt/vt: the tile's stage; kst/vst its
// slot scales (int8 only); j0: the absolute local slot of the tile's first
// slot; pw: this warp's [RW][TS] scratch.  Scores: lane = slot, q.k in a
// fixed order over d (below), int8 times the slot's K scale after the sum;
// softmax per row across the warp; p.v: lane = DPL dims, slots in a fixed
// order (below), int8 with p times the slot's V scale.  No block barrier.
template <typename KT, int HSZ, int RW, int NW>
__device__ __forceinline__ void tile_update(const float* qs, const KT* kt, const KT* vt,
                                            const float* kst, const float* vst, int j0,
                                            Rows<HSZ, RW>& st, float* pw, int warp, int lane) {
  using L = Layout<KT, HSZ>;
  constexpr int DPL = L::DPL;
  // q.k: one fmaf chain per 16-byte unit (d ascending inside it), the
  // units' sums added in unit order
  float s[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k) s[k] = 0.f;
  const KT* krow = kt + lane * HSZ;
#pragma unroll
  for (int i = 0; i < L::RV; ++i) {
    const int u = i;
    const uint4 raw = *reinterpret_cast<const uint4*>(krow + L::swz(lane, u) * L::VN);
    float kf[L::VN];
    unpack(raw, kf, KT());
#pragma unroll
    for (int k = 0; k < RW; ++k) {
      if (k < st.n) {
        const float* q = qs + (warp + NW * k) * HSZ + u * L::VN;
        float su = 0.f;
#pragma unroll
        for (int e = 0; e < L::VN; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(q + e);
          su = fmaf(qv.x, kf[e], su);
          su = fmaf(qv.y, kf[e + 1], su);
          su = fmaf(qv.z, kf[e + 2], su);
          su = fmaf(qv.w, kf[e + 3], su);
        }
        s[k] = __fadd_rn(s[k], su);
      }
    }
  }
  const int jj = j0 + lane;
  const float ksc = L::Q8 ? kst[lane] : 1.f;
  const float vsc = L::Q8 ? vst[lane] : 1.f;
  float alpha[RW];
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    alpha[k] = 1.f;
    if (k < st.n) {
      const bool ok = jj >= st.lo[k] && jj < st.hi[k];
      const float sc = ok ? (L::Q8 ? s[k] * ksc : s[k]) : REPRO_NEG_INF;
      const float m_new = fmaxf(st.m[k], warp_max(sc));
      alpha[k] = expf(st.m[k] - m_new);
      const float p = ok ? expf(sc - m_new) : 0.f;
      st.l[k] = fmaf(alpha[k], st.l[k], warp_sum(p));
      st.m[k] = m_new;
      pw[k * TS + lane] = L::Q8 ? p * vsc : p;
    }
  }
  __syncwarp();
  // p.v: four fmaf chains per dim (slots j with j % 4 == 0, 1, 2, 3, each
  // ascending), summed as (c0 + c1) + (c2 + c3)
  float pv[RW][4][DPL];
#pragma unroll
  for (int k = 0; k < RW; ++k)
#pragma unroll
    for (int x = 0; x < 4; ++x)
#pragma unroll
      for (int d = 0; d < DPL; ++d) pv[k][x][d] = 0.f;
#pragma unroll
  for (int j4 = 0; j4 < TS; j4 += 4) {
    float4 p4[RW];
#pragma unroll
    for (int k = 0; k < RW; ++k)
      if (k < st.n) p4[k] = *reinterpret_cast<const float4*>(pw + k * TS + j4);
#pragma unroll
    for (int jx = 0; jx < 4; ++jx) {
      float vf[DPL];
      load_dims<KT, HSZ>(vt, j4 + jx, lane, vf);
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        if (k < st.n) {
          const float pj = jx == 0 ? p4[k].x : jx == 1 ? p4[k].y : jx == 2 ? p4[k].z : p4[k].w;
#pragma unroll
          for (int d = 0; d < DPL; ++d) pv[k][jx][d] = fmaf(pj, vf[d], pv[k][jx][d]);
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < RW; ++k)
    if (k < st.n)
#pragma unroll
      for (int d = 0; d < DPL; ++d) {
        const float sum = __fadd_rn(__fadd_rn(pv[k][0][d], pv[k][1][d]),
                                    __fadd_rn(pv[k][2][d], pv[k][3][d]));
        st.acc[k][d] = fmaf(alpha[k], st.acc[k][d], sum);
      }
  __syncwarp();
}

struct NoChunkEnd {
  __device__ __forceinline__ void operator()(int) const {}
};

// Sweep tiles [ta, te) through the ring (roff starting at tile ct0): NS - 1
// tiles in flight ahead of the one computed, one block barrier per tile
// (the tile landed for every thread, the stage about to be refilled is
// free).  Before the first tile of each later chunk, chunk_end(c) is
// called with the chunk just finished (the copies run on across it).
// Every thread of the CTA calls it; warps with no rows only copy.
template <typename KT, int HSZ, int RW, int NT, typename ChunkEnd = NoChunkEnd>
__device__ __forceinline__ void sweep(const Ring<KT, HSZ, NT>& ring, int ta, int te, int ct0,
                                      const float* qs, Rows<HSZ, RW>& st, float* pw,
                                      int tid, ChunkEnd chunk_end = ChunkEnd()) {
  using L = Layout<KT, HSZ>;
  constexpr int NS = L::NS;
  const int warp = tid / 32, lane = tid % 32;
  const int nt = te - ta;
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) {
    if (s < nt) ring.issue(ta + s - ct0, s, tid);
    cp_async_commit();
  }
  for (int i = 0; i < nt; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    const int ni = i + NS - 1;
    if (ni < nt) ring.issue(ta + ni - ct0, ni % NS, tid);
    cp_async_commit();
    const int s = i % NS, t = ta + i;
    if (i > 0 && t % CPT == 0) chunk_end(t / CPT - 1);
    if (st.n > 0)
      tile_update<KT, HSZ, RW, NT / 32>(qs, ring.kstage(s), ring.vstage(s), ring.kss + s * TS,
                               ring.vss + s * TS, t * TS, st, pw, warp, lane);
  }
  cp_async_wait<0>();
}

// Write the rows' raw state to a partial: acc [rows][HSZ], m/l [rows] of
// this chunk (row index warp + NW*k, offset by row0).
template <int HSZ, int RW, int NW>
__device__ __forceinline__ void write_rows(const Rows<HSZ, RW>& st, float* acc, float* m,
                                           float* l, int warp, int lane) {
  constexpr int DPL = HSZ / 32;
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    if (k < st.n) {
      const int r = warp + NW * k;
#pragma unroll
      for (int d = 0; d < DPL; ++d) acc[r * HSZ + lane * DPL + d] = st.acc[k][d];
      if (lane == 0) {
        m[r] = st.m[k];
        l[r] = st.l[k];
      }
    }
  }
}

// Fold one chunk partial (m_c, l_c, a_c) into the state (m, l, a) of one
// element: empty partials (l_c == 0) are skipped, the first non-empty one
// is taken as it is, later ones combine as
//   m = max(m, m_c), l = e^(m-m') l + e^(m_c-m') l_c, a likewise
// with no fused multiply-add (ref.merge_chunks does the same).
__device__ __forceinline__ void merge_step(float& m, float& l, float& a, float m_c, float l_c,
                                           float a_c) {
  if (l_c == 0.f) return;
  if (l == 0.f) {
    m = m_c;
    l = l_c;
    a = a_c;
    return;
  }
  const float mn = fmaxf(m, m_c);
  const float e0 = expf(m - mn), e1 = expf(m_c - mn);
  l = __fadd_rn(__fmul_rn(e0, l), __fmul_rn(e1, l_c));
  a = __fadd_rn(__fmul_rn(e0, a), __fmul_rn(e1, a_c));
  m = mn;
}

}  // namespace decode_tile
