// prefix_pass: the shared-prefix pass of grouped decode, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py
// prefix_pass_kernel (body _prefix_kernel, maps grouped_prefix_index_maps):
// requests whose block tables share their leading pages form a group, and
// each shared page is read ONCE per group for the stacked query rows of
// all its members, with each member's own length and window masks.  It
// emits the raw online-softmax state (acc, m, l) that flash_decode.cu's
// grouped-suffix mode resumes.
//
// One thread block per (group row, kv head, rank).  The groups come as the
// decode state's [B] leaves: group_id (any member's batch row, the same for
// every member) and group_np (shared leading pages; 0 = no group).  The
// block of group row g takes every row b with group_id[b] == g and
// group_np[b] > 0 as a member, reads the members' query rows straight from
// q [B, Kh, G, hsz] (the reference stacks them into [G, Kh, Gm*Qp, hsz]
// first) and writes each member's raw state straight to its own rows of
// st_acc [n_ranks, B, Kh, G, hsz] / st_m, st_l [n_ranks, B, Kh, G], where
// the suffix pass reads it: the reference's gather and scatter around the
// kernel become addressing.  Blocks of rows that lead no group exit at once.
// The row count, members x G, is a launch parameter: shared memory is sized
// for B x G rows.
//
// Bit-exactness with ungrouped decode (decode_tile.cuh): the block sweeps
// the whole tiles of TS slots below split = group_np * ps / TS in the decode
// kernel's order through the same tile_update, and the suffix pass starts
// at that tile.  A tile that straddles the end of the shared pages is left
// to the suffix and read once per member.  Member m's rows see only tiles
// below its own split (a tile above it is an identity update), so members
// with different group_np stay exact too.  Tiles below a member's window
// are fully masked for its rows: identity updates again, from the cold
// state as from any other.
//
// Bound: bytes.  Each shared K/V tile is read once per group instead of once
// per member, so the prefix reads drop by the group size; the ~4*R*hsz
// flops per slot stay far below the ~295 flop/byte ridge at R <= 64 rows.
#include "decode_tile.cuh"

namespace {

using decode_tile::NT;
using decode_tile::TS;
using decode_tile::TilePipe;

struct PrefixArgs {
  const void* q;        // [B, Kh, G, hsz]
  const void* k;        // pool planes [n_pool, Kh, n_ranks * ps, hsz]
  const void* v;
  const float* kscale;  // [n_pool, Kh, n_ranks * ps] (int8 mode only)
  const float* vscale;
  const int* tl;        // [B] global lengths incl. the new token
  const int* tables;    // [B, max_pages]
  const int* gid;       // [B] group row of each request
  const int* gnp;       // [B] shared leading pages (0: no group)
  float* st_acc;        // [n_ranks, B, Kh, G, hsz]
  float* st_m;          // [n_ranks, B, Kh, G]
  float* st_l;
  int B, Kh, G, n_ranks, rank0, kvp, rr, window, max_pages, ps;
  float scale;
};

template <typename T, typename KT, int HSZ>
__global__ void __launch_bounds__(NT) prefix_kernel(PrefixArgs a) {
  using Pipe = TilePipe<KT, HSZ>;
  constexpr int SP = Pipe::SP;
  const int RMAX = a.B * a.G;

  extern __shared__ float smem[];
  float* qs = smem;                   // [RMAX][HSZ] scaled queries
  float* acc = qs + RMAX * HSZ;       // [RMAX][HSZ]
  float* ks = acc + RMAX * HSZ;       // [TS][SP]
  float* vs = ks + TS * SP;           // [TS][SP]
  float* ps = vs + TS * SP;           // [RMAX][TS]
  float* row_m = ps + RMAX * TS;      // [RMAX]
  float* row_l = row_m + RMAX;
  float* row_a = row_l + RMAX;
  int* mem = reinterpret_cast<int*>(row_a + RMAX);  // [B] member rows
  int* msplit = mem + a.B;            // [B] each member's split tile
  int* valid = msplit + a.B;          // [B][TS] per-member slot masks
  __shared__ int n_mem, split;

  const int tid = threadIdx.x;
  const int g0 = blockIdx.x / a.Kh;
  const int h = blockIdx.x % a.Kh;
  const int z = blockIdx.y;
  const int rank = a.rank0 + z;
  const int G = a.G;
  if (tid == 0) {
    int n = 0, hi = 0;
    for (int b = 0; b < a.B; ++b) {
      if (a.gid[b] == g0 && a.gnp[b] > 0) {
        mem[n] = b;
        msplit[n] = a.gnp[b] * a.ps / TS;
        hi = max(hi, msplit[n]);
        ++n;
      }
    }
    n_mem = n;
    split = hi;
  }
  __syncthreads();
  if (n_mem == 0 || split == 0) return;     // the same for the whole block
  const int R = n_mem * G;

  for (int i = tid; i < R * HSZ; i += NT) {
    const int r = i / HSZ, d = i % HSZ;
    const long qrow = ((long)mem[r / G] * a.Kh + h) * G + r % G;
    qs[i] = to_f(reinterpret_cast<const T*>(a.q)[qrow * HSZ + d]) * a.scale;
    acc[i] = 0.f;
  }
  for (int r = tid; r < R; r += NT) { row_m[r] = REPRO_NEG_INF; row_l[r] = 0.f; }

  Pipe pipe;
  pipe.kp = reinterpret_cast<const KT*>(a.k);
  pipe.vp = reinterpret_cast<const KT*>(a.v);
  pipe.ksc = Pipe::Q8 ? a.kscale : nullptr;
  pipe.vsc = Pipe::Q8 ? a.vscale : nullptr;
  // members share the pages below their split: any member's table serves
  pipe.tab = a.tables + (long)mem[0] * a.max_pages;
  pipe.row0 = 0;
  pipe.Kh = a.Kh;
  pipe.h = h;
  pipe.n_ranks = a.n_ranks;
  pipe.z = z;
  pipe.ps = a.ps;
  pipe.s_loc = a.max_pages * a.ps;

  auto stage = [&](int tile) {
    pipe.sstore(tile, tid, ks, vs, -1, nullptr, nullptr, nullptr);
    for (int i = tid; i < n_mem * TS; i += NT) {
      const int m = i / TS;
      const int jj = tile * TS + i % TS;
      const int tl = a.tl[mem[m]];
      const int pos = decode_tile::rr_position(jj, rank, a.kvp, a.rr);
      valid[i] = tile < msplit[m] && jj < pipe.s_loc && pos < tl
                 && (a.window <= 0 || pos >= tl - a.window);
    }
  };

  pipe.gload(0, tid);
  stage(0);
  __syncthreads();
  for (int t = 0; t < split; ++t) {
    const bool more = t + 1 < split;
    if (more) pipe.gload(t + 1, tid);
    decode_tile::tile_update<HSZ>(qs, ks, vs, ps, row_m, row_l, row_a, acc,
                                  valid, R, G, tid);
    if (more) { stage(t + 1); __syncthreads(); }
  }

  // raw state, no normalisation: each member's rows at [z, b, h]
  for (int i = tid; i < R * HSZ; i += NT) {
    const int r = i / HSZ;
    const long o = (((long)z * a.B + mem[r / G]) * a.Kh + h) * G + r % G;
    a.st_acc[o * HSZ + i % HSZ] = acc[i];
  }
  for (int r = tid; r < R; r += NT) {
    const long o = (((long)z * a.B + mem[r / G]) * a.Kh + h) * G + r % G;
    a.st_m[o] = row_m[r];
    a.st_l[o] = row_l[r];
  }
}

size_t smem_bytes(int B, int G, int hsz) {
  const size_t rows = (size_t)B * G;
  return sizeof(float) * (2 * rows * hsz + 2 * TS * (hsz + 1) + rows * TS + 3 * rows)
         + sizeof(int) * (2 * B + B * TS);
}

template <typename T, typename KT, int HSZ>
cudaError_t launch(const PrefixArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.B, a.G, HSZ);
  cudaError_t err = allow_smem(prefix_kernel<T, KT, HSZ>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.Kh, a.n_ranks);
  prefix_kernel<T, KT, HSZ><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KT>
cudaError_t launch_hsz(const PrefixArgs& a, int hsz, cudaStream_t stream) {
  switch (hsz) {
    case 32: return launch<T, KT, 32>(a, stream);
    case 64: return launch<T, KT, 64>(a, stream);
    case 128: return launch<T, KT, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The most shared memory a block may take (H100: 227 KB): B x G rows must
// fit (prefix_pass_smem_bytes tells the wrapper what a launch needs).
extern "C" long prefix_pass_smem_bytes(int B, int G, int hsz) {
  return (long)smem_bytes(B, G, hsz);
}

extern "C" int prefix_pass_launch(
    const void* q, const void* k, const void* v, const void* kscale,
    const void* vscale, const void* tl, const void* tables, const void* gid,
    const void* gnp, void* st_acc, void* st_m, void* st_l, int dtype,
    int quant, int B, int Kh, int G, int hsz, int n_ranks, int rank0, int kvp,
    int rr, int window, int max_pages, int ps, float scale, void* stream) {
  if (G < 1 || B * Kh == 0 || n_ranks < 1 || max_pages < 1 || ps < 1
      || (quant && (kscale == nullptr || vscale == nullptr))
      || smem_bytes(B, G, hsz) > 232448)
    return (int)cudaErrorInvalidValue;
  PrefixArgs a{q, k, v, static_cast<const float*>(kscale),
               static_cast<const float*>(vscale), static_cast<const int*>(tl),
               static_cast<const int*>(tables), static_cast<const int*>(gid),
               static_cast<const int*>(gnp), static_cast<float*>(st_acc),
               static_cast<float*>(st_m), static_cast<float*>(st_l),
               B, Kh, G, n_ranks, rank0, kvp, rr, window, max_pages, ps, scale};
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
