// The three-launch form of ssd_prefill, kept to be timed against the
// single-launch kernel of src/repro_torch/csrc/ssd_prefill.cu by
// scripts/torch_ssd_three_pass_ab.py (it shares that file's helpers):
//   1. ssd_state_kernel, one block per (batch, head, chunk): the chunk's own
//      state S_c and its decay exp(cum_last) into a workspace ([B * nh,
//      chunks, hd, ds] and [B * nh, chunks]);
//   2. ssd_fold_kernel, one thread per 4 state entries of a (batch, head):
//      h_c = decay_c h_{c-1} + S_c in chunk order from h0, the state each
//      chunk enters written over S_c, and h_final;
//   3. ssd_out_kernel, one block per (batch, head, chunk): the outputs.
// The same products in the same order as the single-launch kernel, so the
// two agree bit for bit; the chunk states cross device memory twice, and
// x/B/C sit in shared memory as f32 here (the single-launch kernel keeps
// bf16 inputs as bf16 and reads them with ldmatrix).
#include "ssd_prefill.cu"

namespace {

struct Args3 : Args {
  float* ws;        // [B * nh, nc, hd, ds]: S_c, then the entering states
  float* decay;     // [B * nh, nc]: exp(cum_last) of each chunk
};

size_t state_smem(int hd, int ds) {
  return sizeof(float) * ((size_t)LC * scol(hd) + (size_t)LC * scol(ds) + 2 * LC);
}

size_t out_smem(int hd, int ds) {
  const size_t rows = hd > LC ? hd : LC;
  return sizeof(float) * ((size_t)LC * srow(ds) + rows * srow(ds)
                          + (size_t)LC * scol(hd) + (size_t)LC * srow(LC)
                          + 3 * LC);
}

// 1. S_c[p][n] = sum_j seg_j x_j[p] B_j[n] and decay_c = exp(cum_last).
template <typename T>
__global__ void __launch_bounds__(NT) ssd_state_kernel(Args3 p) {
  constexpr int NI = Terms<T>::N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = p.hd, ds = p.ds, tid = threadIdx.x, warp = tid / 32;
  float* us = smem;                    // [LC][scol(hd)]  seg_j x_j
  float* bs = us + LC * scol(hd);      // [LC][scol(ds)]  B_j
  float* cum = bs + LC * scol(ds);     // [LC]
  float* seg = cum + LC;               // [LC]            (dt, then seg)
  const Chunk k = chunk_of(p, blockIdx.x % p.nc, blockIdx.x / p.nc);
  const T* x = static_cast<const T*>(p.x) + k.b * p.sxb
               + (long long)k.t0 * p.sxt + (long long)k.head * hd;
  const T* bm = static_cast<const T*>(p.bm) + k.b * p.sbb
                + (long long)k.t0 * p.sbt + (long long)k.g * ds;
  const float* dt = p.dt + ((long long)k.b * p.T + k.t0) * p.nh + k.head;

  // B and x in flight while warp 0 scans dt
  Stage<T, UNITS> sb(bm, p.sbt, LC, k.len, ds), sx(x, p.sxt, LC, k.len, hd);
  const bool vec = Stage<T, UNITS>::aligned(bm, p.sbt, ds)
                   && Stage<T, UNITS>::aligned(x, p.sxt, hd);
  if (vec && sb.rounds() == 1 && sx.rounds() == 1) {
    sb.load(0);
    sx.load(0);
    chunk_cumsum(dt, p.nh, k.len, p.a[k.head], cum, seg, nullptr, seg);
    __syncthreads();                   // seg ready
    sb.store(0, bs, scol(ds), nullptr);
    sx.store(0, us, scol(hd), seg);
  } else {
    chunk_cumsum(dt, p.nh, k.len, p.a[k.head], cum, seg, nullptr, seg);
    __syncthreads();
    copy_rows(bs, scol(ds), bm, p.sbt, LC, k.len, ds, nullptr);
    copy_rows(us, scol(hd), x, p.sxt, LC, k.len, hd, seg);
  }
  if (tid == 0) p.decay[(long long)k.bh * p.nc + k.c] = expf(cum[LC - 1]);
  __syncthreads();

  // m = p (16-row tiles), n = n (a warp takes 64 columns), k = j
  float* ws = p.ws + ((long long)k.bh * p.nc + k.c) * hd * ds;
  const int g = (tid & 31) >> 2, q = tid & 3;
  const int mtiles = hd / 16, units = mtiles * ((ds + 63) / 64);
  const int ksteps = (k.len + 15) / 16;
  for (int u = warp; u < units; u += NT / 32) {
    const int m0 = (u % mtiles) * 16, nb = (u / mtiles) * 64;
    const int ntile = min(8, (ds - nb) / 8);
    float acc[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][r] = 0.f;
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t a[3][4];
      frag_a_cols<3>(us, scol(hd), m0, 16 * ks, a);
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (t < ntile) {
          uint32_t b[NI][2];
          frag_b_cols<NI>(bs, scol(ds), nb + 8 * t, 16 * ks, b);
          mma_terms<3, NI>(acc[t], a, b);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (t < ntile) {
        float* o = ws + (m0 + g) * ds + nb + 8 * t + 2 * q;
        *reinterpret_cast<float2*>(o) = make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(o + 8 * ds) = make_float2(acc[t][2], acc[t][3]);
      }
    }
  }
}

// 2. In chunk order: ws[c] <- h (the state chunk c enters), h <- decay_c h +
// S_c, from h0; h_final out.  Every matrix here is [hd][ds].
__global__ void __launch_bounds__(NT) ssd_fold_kernel(Args3 p) {
  const int per = p.ds * p.hd / 4;
  const int e = blockIdx.x * NT + threadIdx.x;      // float4 of [hd][ds]
  if (e >= per) return;
  const long long bh = blockIdx.y, cs = (long long)p.ds * p.hd;
  float4 h = p.h0 != nullptr
                 ? reinterpret_cast<const float4*>(p.h0 + bh * cs)[e]
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  float4* w = reinterpret_cast<float4*>(p.ws + bh * p.nc * cs) + e;
  const long long cs4 = cs / 4;
  const float* dec = p.decay + bh * p.nc;
  int c = 0;
  for (; c < p.nc; c += 4) {
    const int n = min(4, p.nc - c);
    float4 s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (u < n) s[u] = w[(c + u) * cs4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < n) {
        w[(c + u) * cs4] = h;
        const float gd = dec[c + u];
        h = make_float4(fmaf(gd, h.x, s[u].x), fmaf(gd, h.y, s[u].y),
                        fmaf(gd, h.z, s[u].z), fmaf(gd, h.w, s[u].w));
      }
    }
  }
  reinterpret_cast<float4*>(p.hout + bh * cs)[e] = h;
}

// 3. y_i = sum_{j <= i} W_ij x_j + exp(cum_i) C_i . h_in + D x_i with
// W_ij = (C_i . B_j) exp(cum_i - cum_j) dt_j.
template <typename T>
__global__ void __launch_bounds__(NT, 2) ssd_out_kernel(Args3 p) {
  constexpr int NI = Terms<T>::N;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int hd = p.hd, ds = p.ds, tid = threadIdx.x, warp = tid / 32;
  const int g = (tid & 31) >> 2, q = tid & 3;
  float* cs = smem;                              // [LC][srow(ds)]   C
  float* r1 = cs + LC * srow(ds);                // [LC][srow(ds)]   B, then h_in [hd][srow(ds)]
  float* xs = r1 + (hd > LC ? hd : LC) * srow(ds);   // [LC][scol(hd)] x
  float* wm = xs + LC * scol(hd);                // [LC][srow(LC)]   W
  float* cum = wm + LC * srow(LC);               // [LC]
  float* dts = cum + LC;                         // [LC]
  float* ecum = dts + LC;                        // [LC]
  const Chunk k = chunk_of(p, blockIdx.x % p.nc, blockIdx.x / p.nc);
  const T* x = static_cast<const T*>(p.x) + k.b * p.sxb
               + (long long)k.t0 * p.sxt + (long long)k.head * hd;
  const T* bm = static_cast<const T*>(p.bm) + k.b * p.sbb
                + (long long)k.t0 * p.sbt + (long long)k.g * ds;
  const T* cm = static_cast<const T*>(p.cm) + k.b * p.scb
                + (long long)k.t0 * p.sct + (long long)k.g * ds;
  const float* dt = p.dt + ((long long)k.b * p.T + k.t0) * p.nh + k.head;

  // C, B, x and the entering state (stored once B is no longer needed)
  // all in flight together while warp 0 scans dt
  const float4* hin = reinterpret_cast<const float4*>(
      p.ws + ((long long)k.bh * p.nc + k.c) * hd * ds);
  const int hper = ds * hd / 4;
  constexpr int HREG = 8;
  float4 hreg[HREG];
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
#pragma unroll
    for (int u = 0; u < HREG; ++u) {
      const int e = tid + u * NT;
      hreg[u] = e < hper ? hin[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    chunk_cumsum(dt, p.nh, k.len, p.a[k.head], cum, dts, ecum, nullptr);
    if (vec) {
      sc.store(0, cs, srow(ds), nullptr);
      sb.store(0, r1, srow(ds), nullptr);
      sx.store(0, xs, scol(hd), nullptr);
    } else {
      copy_rows(cs, srow(ds), cm, p.sct, LC, k.len, ds, nullptr);
      copy_rows(r1, srow(ds), bm, p.sbt, LC, k.len, ds, nullptr);
      copy_rows(xs, scol(hd), x, p.sxt, LC, k.len, hd, nullptr);
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
      for (int k0 = 0; k0 < ds; k0 += 16) {
        uint32_t a[NI][4];
        frag_a_rows<NI>(cs, srow(ds), m0, k0, a);
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (nb + 8 * t <= m0 + 15) {
            uint32_t b[NI][2];
            frag_b_rows<NI>(r1, srow(ds), nb + 8 * t, k0, b);
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
  __syncthreads();                     // B read, W written
#pragma unroll
  for (int u = 0; u < HREG; ++u) {
    const int e = tid + u * NT;
    if (e < hper) {
      const int pr = (4 * e) / ds, n = (4 * e) % ds;
      *reinterpret_cast<float4*>(r1 + pr * srow(ds) + n) = hreg[u];
    }
  }
  for (int e = tid + HREG * NT; e < hper; e += NT) {
    const int pr = (4 * e) / ds, n = (4 * e) % ds;
    *reinterpret_cast<float4*>(r1 + pr * srow(ds) + n) = hin[e];
  }
  __syncthreads();

  // y: m = i, n = p (a warp takes 32 of them); inter k = state, intra k = j
  const float dskip = p.d[k.head];
  const long long yrow = (long long)p.nh * hd;
  float* y = p.y + ((long long)k.b * p.T + k.t0) * yrow + (long long)k.head * hd;
  const int units = 4 * ((hd + 31) / 32);
  for (int u = warp; u < units; u += NT / 32) {
    const int m0 = (u % 4) * 16, nb = (u / 4) * 32;
    if (m0 >= k.len) continue;
    const int ntile = min(4, (hd - nb) / 8);
    float inter[4][4], intra[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) inter[t][r] = intra[t][r] = 0.f;
    for (int k0 = 0; k0 < ds; k0 += 16) {
      uint32_t a[NI][4];
      frag_a_rows<NI>(cs, srow(ds), m0, k0, a);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        if (t < ntile) {
          uint32_t b[3][2];
          frag_b_rows<3>(r1, srow(ds), nb + 8 * t, k0, b);
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
          frag_b_cols<NI>(xs, scol(hd), nb + 8 * t, k0, b);
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
            const float* xi = xs + i * scol(hd) + pc;
            float o[2];
#pragma unroll
            for (int c = 0; c < 2; ++c)
              o[c] = intra[t][2 * h + c] + ecum[i] * inter[t][2 * h + c]
                     + dskip * xi[c];
            *reinterpret_cast<float2*>(y + i * yrow + pc) = make_float2(o[0], o[1]);
          }
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch3(const Args3& args, int B, cudaStream_t stream) {
  const size_t s1 = state_smem(args.hd, args.ds), s3 = out_smem(args.hd, args.ds);
  cudaError_t err = allow_smem(ssd_state_kernel<T>, s1);
  if (err == cudaSuccess) err = allow_smem(ssd_out_kernel<T>, s3);
  if (err != cudaSuccess) return err;
  const int blocks = B * args.nh * args.nc;
  ssd_state_kernel<T><<<blocks, NT, s1, stream>>>(args);
  const int per = args.ds * args.hd / 4;
  ssd_fold_kernel<<<dim3((per + NT - 1) / NT, B * args.nh), NT, 0, stream>>>(args);
  ssd_out_kernel<T><<<blocks, NT, s3, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_three_pass_launch(
    const void* x, long long sxb, long long sxt,
    const void* bm, long long sbb, long long sbt,
    const void* cm, long long scb, long long sct,
    const void* dt, const void* a, const void* d, const void* h0,
    void* y, void* hout, void* ws, void* decay,
    int B, int T, int nh, int hd, int G, int ds, int lc, int nc,
    int dtype, void* stream) {
  if (B < 1 || T < 1 || nh < 1 || hd < 16 || hd % 16 != 0 || ds < 16
      || ds % 16 != 0 || lc < 1 || lc > LC || nc != (T + lc - 1) / lc
      || G < 1 || nh % G != 0 || out_smem(hd, ds) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Args3 args;
  static_cast<Args&>(args) = Args{
      x, sxb, sxt, bm, sbb, sbt, cm, scb, sct,
      static_cast<const float*>(dt), static_cast<const float*>(a),
      static_cast<const float*>(d), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(hout), nullptr, nullptr,
      T, nh, hd, G, ds, lc, nc};
  args.ws = static_cast<float*>(ws);
  args.decay = static_cast<float*>(decay);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch3<bf16>(args, B, s)
                               : launch3<float>(args, B, s);
  return (int)err;
}
