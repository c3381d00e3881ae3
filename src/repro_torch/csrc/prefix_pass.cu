// prefix_pass: the shared-prefix pass of grouped decode, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_decode/kernel.py
// prefix_pass_kernel (body _prefix_kernel, maps grouped_prefix_index_maps):
// requests whose block tables share their leading pages form a group, and
// each shared page is read ONCE per group for the stacked query rows of
// all its members, with each member's own length and window masks.  It
// emits the raw online-softmax partials (acc, m, l) of each chunk below
// each member's split, which flash_decode.cu's grouped-suffix mode resumes
// and merges.
//
// One CTA of 8 warps per (chunk, group row x kv head, rank x row block).  The groups
// come as the decode state's [B] leaves: group_id (any member's batch row,
// the same for every member) and group_np (shared leading pages; 0 = no
// group).  The CTA of group row g takes every row b with group_id[b] == g
// and group_np[b] > 0 as a member, in ascending b, reads the members' query
// rows straight from q [B, Kh, G, hsz] (the reference stacks them into
// [G, Kh, Gm*Qp, hsz] first) and holds NW * RW of the members x G stacked
// rows (row block rb holds rows [rb*NW*RW, ...)); CTAs of rows that lead no
// group, of chunks at or above the group's largest split and of empty row
// blocks exit at once.  Each member row's partial of chunk c goes straight
// to st_* [n_ranks, B, Kh, st_nc, G(, hsz)] at that member's batch row,
// where the suffix pass reads it: the reference's gather and scatter around
// the kernel become addressing.
//
// Bit-exactness with ungrouped decode (decode_tile.cuh): chunks sit at the
// same absolute boundaries and every row goes through the same tile_update,
// whose per-row arithmetic does not depend on the row count.  The CTA of
// chunk c sweeps the chunk's whole tiles below the group's largest split S =
// max(group_np) * ps / TS in order; member m's rows are masked to their own
// valid slots below their split (msplit * TS), so tiles outside are
// identity updates.  A member's partial of chunk c is written only when
// chunk c starts below its split: for chunks wholly below, it is the
// ungrouped decode's partial of that chunk; for the chunk holding the
// split, the state swept up to the split tile, which the suffix resumes.
// A tile that straddles the end of the shared pages is left to the suffix
// and read once per member.
//
// Bound: bytes.  Each shared K/V tile is read once per group (per row block)
// instead of once per member, so the prefix reads drop by the group size;
// the ~4*R*hsz flops per slot stay far below the ~295 flop/byte ridge.  The
// tiles come through decode_tile.cuh's cp.async ring, 256 slots per CTA.
//
// prefix_pass_launch with fold_* pointers also folds each row's partials in
// chunk order into its raw state (the reference pass's output), a second
// small kernel on the same stream: rows that lead or join no group get the
// cold state.
#include "decode_tile.cuh"

namespace {

using namespace decode_tile;
constexpr int NT = 256;     // threads per CTA (8 warps: several rows each)
constexpr int NW = NT / 32;

struct PrefixArgs {
  const void* q;        // [B, Kh, G, hsz]
  const void* k;        // pool planes [n_pool, Kh, n_ranks * ps, hsz]
  const void* v;
  const float* kscale;  // [n_pool, Kh, n_ranks * ps] (int8 mode only)
  const float* vscale;
  const int* tl;        // [B] global lengths incl. the new token, or null: tl0
  const int* tables;    // [B, max_pages]
  const int* gid;       // [B] group row of each request
  const int* gnp;       // [B] shared leading pages (0: no group)
  float* st_acc;        // [n_ranks, B, Kh, st_nc, G, hsz] chunk partials
  float* st_m;          // [n_ranks, B, Kh, st_nc, G]
  float* st_l;
  float* f_acc;         // [n_ranks, B, Kh, G, hsz] folded state (or null)
  float* f_m;           // [n_ranks, B, Kh, G]
  float* f_l;
  int tl0, B, Kh, G, n_ranks, rank0, kvp, rr, window, max_pages, ps, st_nc, nrb;
  float scale;
};

template <typename KT, int HSZ, int RW>
struct Smem {
  using L = Layout<KT, HSZ>;
  static constexpr int Q = L::RING_BYTES;
  static constexpr int PW = Q + NW * RW * HSZ * 4;
  static constexpr int ROFF = PW + NW * RW * TS * 4;
  static constexpr int MEM = ROFF + CH * 8;   // int [B] members, [B] splits
  static size_t bytes(int B) { return MEM + 2 * sizeof(int) * (size_t)B; }
};

template <typename T, typename KT, int HSZ, int RW>
__global__ void __launch_bounds__(NT) prefix_kernel(PrefixArgs a) {
  using L = Layout<KT, HSZ>;
  using S = Smem<KT, HSZ, RW>;
  constexpr int DPL = L::DPL;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::Q);
  float* pws = reinterpret_cast<float*>(smem + S::PW);
  long* roff = reinterpret_cast<long*>(smem + S::ROFF);
  int* mem = reinterpret_cast<int*>(smem + S::MEM);   // [B] member rows
  int* msplit = mem + a.B;                            // [B] their split tiles
  __shared__ int n_mem, split;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x;
  const int g0 = blockIdx.y / a.Kh, h = blockIdx.y % a.Kh;
  const int z = blockIdx.z / a.nrb, rb = blockIdx.z % a.nrb;
  const int rank = a.rank0 + z;
  const int G = a.G;
  const int s_loc = a.max_pages * a.ps;
  bool lead = false;   // does group row g0 have a member? (all threads look)
  for (int b = tid; b < a.B; b += NT) lead |= a.gid[b] == g0 && a.gnp[b] > 0;
  if (!__syncthreads_or(lead)) return;
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
  const int R = n_mem * G;
  const int r0 = rb * NW * RW;
  if (c * CPT >= split || r0 >= R) return;   // the same for the whole CTA

  Rows<HSZ, RW> st;
  st.n = 0;
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    const int r = r0 + warp + NW * k;
    if (r < R) st.n = k + 1;
    const int mi = min(r, R - 1) / G;
    const int tl = a.tl != nullptr ? a.tl[mem[mi]] : a.tl0;
    const Span sp = valid_span(tl, rank, a.kvp, a.rr, s_loc, a.window, 0, false);
    st.lo[k] = sp.lo;
    st.hi[k] = min(sp.hi, msplit[mi] * TS);
  }
  st.cold();
  // members share the pages below their split: the first member's table
  const int* tab = a.tables + (long)mem[0] * a.max_pages;
  for (int jl = tid; jl < CH; jl += NT) {
    const int jj = c * CH + jl;
    roff[jl] = jj >= s_loc ? ROW_NONE
                           : (((long)tab[jj / a.ps] * a.Kh + h) * a.n_ranks + z) * a.ps
                                 + jj % a.ps;
  }
  Ring<KT, HSZ, NT> ring;
  ring.ks = reinterpret_cast<KT*>(smem);
  ring.vs = ring.ks + L::NS * L::ELEMS;
  ring.kss = reinterpret_cast<float*>(ring.vs + L::NS * L::ELEMS);
  ring.vss = ring.kss + L::NS * TS;
  ring.kg = reinterpret_cast<const KT*>(a.k);
  ring.vg = reinterpret_cast<const KT*>(a.v);
  ring.ksg = a.kscale;
  ring.vsg = a.vscale;
  ring.roff = roff;
  ring.sub_k = ring.sub_v = nullptr;
  ring.sub_sc = nullptr;
  for (int i = tid; i < NW * RW * HSZ; i += NT) {
    const int r = r0 + i / HSZ;
    if (r < R) {
      const long qrow = ((long)mem[r / G] * a.Kh + h) * G + r % G;
      qs[i] = to_f(reinterpret_cast<const T*>(a.q)[qrow * HSZ + i % HSZ]) * a.scale;
    }
  }
  __syncthreads();
  const int ct0 = c * CPT;
  sweep<KT, HSZ, RW, NT>(ring, ct0, min(ct0 + CPT, split), ct0, qs, st, pws + warp * RW * TS,
                     tid);

  // each member row's partial of chunk c, where its chunk starts below its split
#pragma unroll
  for (int k = 0; k < RW; ++k) {
    const int r = r0 + warp + NW * k;
    if (k < st.n && msplit[r / G] > ct0) {
      const long o = ((((long)z * a.B + mem[r / G]) * a.Kh + h) * a.st_nc + c) * G + r % G;
#pragma unroll
      for (int d = 0; d < DPL; ++d) a.st_acc[o * HSZ + lane * DPL + d] = st.acc[k][d];
      if (lane == 0) {
        a.st_m[o] = st.m[k];
        a.st_l[o] = st.l[k];
      }
    }
  }
}

// Fold row b's partials of chunks [0, ceil(split_b / CPT)) in order into
// its raw state; rows of no group (split 0) get the cold state.
template <int HSZ>
__global__ void __launch_bounds__(NT) fold_kernel(PrefixArgs a) {
  const int bh = blockIdx.x, z = blockIdx.y;
  const int b = bh / a.Kh;
  const int G = a.G;
  const int split = a.gnp[b] > 0 ? a.gnp[b] * a.ps / TS : 0;
  const int nck = (split + CPT - 1) / CPT;
  const long ob = (long)z * a.B * a.Kh + bh;
  for (int e = threadIdx.x; e < G * HSZ; e += NT) {
    const int g = e / HSZ, d = e % HSZ;
    float m = REPRO_NEG_INF, l = 0.f, acc = 0.f;
    for (int c = 0; c < nck; ++c) {
      const long r = (ob * a.st_nc + c) * G + g;
      merge_step(m, l, acc, a.st_m[r], a.st_l[r], a.st_acc[r * HSZ + d]);
    }
    a.f_acc[(ob * G + g) * HSZ + d] = acc;
    if (d == 0) {
      a.f_m[ob * G + g] = m;
      a.f_l[ob * G + g] = l;
    }
  }
}

template <typename T, typename KT, int HSZ, int RW>
cudaError_t launch(const PrefixArgs& a, cudaStream_t stream) {
  const size_t smem = Smem<KT, HSZ, RW>::bytes(a.B);
  static_assert(Smem<KT, HSZ, RW>::MEM <= SMEM_OPTIN, "shared memory");
  if (smem > SMEM_OPTIN) return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(prefix_kernel<T, KT, HSZ, RW>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.st_nc, a.B * a.Kh, a.n_ranks * a.nrb);
  prefix_kernel<T, KT, HSZ, RW><<<grid, NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.f_acc == nullptr) return err;
  fold_kernel<HSZ><<<dim3(a.B * a.Kh, a.n_ranks), NT, 0, stream>>>(a);
  return cudaGetLastError();
}

// Rows per warp.  A small launch (fewer chunk x group row x kv head items
// than 4 per SM) takes 1, so that a group's rows spread over more CTAs
// (each reading the shared tiles, mostly from L2); otherwise 4, or 8 above
// 4 x NW rows, so that one row block holds all B x G rows up to 8 x NW and
// each shared tile is read once per group.  At hsz 256 a row holds 8 dims
// a lane (40 accumulators in tile_update), and 4 rows a warp would spill
// and, in f32, overflow shared memory (the ring alone is 192 KB): 2 rows a
// warp there, 16 rows a row block.  The rows' arithmetic is the same
// either way (decode_tile.cuh).
template <typename T, typename KT, int HSZ>
cudaError_t launch_rw(PrefixArgs a, cudaStream_t stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const int rows = a.B * a.G;
  const long items = (long)a.st_nc * a.B * a.Kh * a.n_ranks;
  const int rw = items < 4L * sms ? 1 : HSZ >= 256 ? 2 : rows <= 4 * NW ? 4 : 8;
  a.nrb = (rows + NW * rw - 1) / (NW * rw);
  if (rw == 1) return launch<T, KT, HSZ, 1>(a, stream);
  if constexpr (HSZ >= 256) {
    return launch<T, KT, HSZ, 2>(a, stream);
  } else {
    return rw == 4 ? launch<T, KT, HSZ, 4>(a, stream) : launch<T, KT, HSZ, 8>(a, stream);
  }
}

template <typename T, typename KT>
cudaError_t launch_hsz(const PrefixArgs& a, int hsz, cudaStream_t stream) {
  switch (hsz) {
    case 32: return launch_rw<T, KT, 32>(a, stream);
    case 64: return launch_rw<T, KT, 64>(a, stream);
    case 128: return launch_rw<T, KT, 128>(a, stream);
    case 256: return launch_rw<T, KT, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// One launch's operands (ctypes mirror: ops._PrefixParams, same order).
// st_*: chunk partials [n_ranks, B, Kh, st_nc, G(, hsz)], st_nc =
// ceil(max_pages * ps / CH); f_*: the folded raw state, or null.
struct PrefixParams {
  const void *q, *k, *v, *kscale, *vscale, *tl, *tables, *gid, *gnp;
  void *st_acc, *st_m, *st_l, *f_acc, *f_m, *f_l;
  int tl0, dtype, quant, B, Kh, G, hsz, n_ranks, rank0, kvp, rr, window, max_pages, ps;
  int st_nc;
  float scale;
};

extern "C" int prefix_pass_launch(const PrefixParams* p, void* stream) {
  if (p->G < 1 || p->B * p->Kh == 0 || p->n_ranks < 1 || p->max_pages < 1 || p->ps < 1
      || p->st_nc * CH < p->max_pages * p->ps
      || (p->quant && (p->kscale == nullptr || p->vscale == nullptr))
      || (p->f_acc != nullptr && (p->f_m == nullptr || p->f_l == nullptr)))
    return (int)cudaErrorInvalidValue;
  PrefixArgs a{p->q, p->k, p->v, static_cast<const float*>(p->kscale),
               static_cast<const float*>(p->vscale), static_cast<const int*>(p->tl),
               static_cast<const int*>(p->tables), static_cast<const int*>(p->gid),
               static_cast<const int*>(p->gnp), static_cast<float*>(p->st_acc),
               static_cast<float*>(p->st_m), static_cast<float*>(p->st_l),
               static_cast<float*>(p->f_acc), static_cast<float*>(p->f_m),
               static_cast<float*>(p->f_l), p->tl0, p->B, p->Kh, p->G, p->n_ranks,
               p->rank0, p->kvp, p->rr, p->window, p->max_pages, p->ps, p->st_nc, 1,
               p->scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (p->quant)
    err = p->dtype == 1 ? launch_hsz<bf16, int8_t>(a, p->hsz, s)
                        : launch_hsz<float, int8_t>(a, p->hsz, s);
  else
    err = p->dtype == 1 ? launch_hsz<bf16, bf16>(a, p->hsz, s)
                        : launch_hsz<float, float>(a, p->hsz, s);
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
