// ssd_prefill: the Mamba2 SSD chunked scan, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_prefill/kernel.py
// ssd_prefill_kernel (body _ssd_kernel).  For each (batch, head) it walks
// the tokens in chunks of lc.  Per chunk, with cum = cumsum(dt * a):
//   intra:  y  = tril(C B^T o exp(cum_i - cum_j)) diag(dt) X
//   inter:  y += exp(cum_i) * (C h_in^T)
//   skip:   y += D * X
//   state:  h  = exp(cum_last) h + sum_j exp(cum_last - cum_j) dt_j x_j (x) B_j
// seeded from h0 (zeros when absent), returning h_final.
//
// Bound: at the serve shape (nh 48, hd 64, ds 128, lc 64, T 1024) the call
// moves ~21 MB (x and B/C in, y and h out) and does ~2.8 GFLOP, so on this
// card it is bound by bytes (~6 us at 3.35 TB/s).  This first version runs
// its products on CUDA cores in f32 from shared memory, so shared-memory
// bandwidth and the 48-96 busy blocks set its time, far above the bound;
// wgmma tiles and more blocks per head are later work.
//
// Design: the TPU's sequential chunk axis becomes a loop inside the block,
// and the running state lives in shared memory across it; it reaches device
// memory only as h_final.  One block per (batch, head, slice of PS state
// rows): rows of h[p, :] are independent across channels p, so slicing hd
// doubles the blocks at full width (each slice recomputes the chunk's
// C B^T weights).  B/C are read per group (g = head / (nh / G)) straight
// from the caller's layout; x/B/C may be f32 or bf16 and are converted to
// f32 on load, with any batch and token strides.  The chunk's B, C and the
// state rows sit in shared memory with a padded row (ds + 1) so column
// reads across a warp hit distinct banks.  Tokens past T in the last chunk
// load as zeros with dt = 0, the identity step, so no padding is needed.
// The cumsum runs in token order in one thread.  All math is f32; the
// summation order differs from the plain version, so they agree to a
// tolerance, not bit for bit.
#include "common.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int PS = 32;         // state rows (hd channels) per block

struct Args {
  const void* x; long long sxb, sxt;
  const void* bm; long long sbb, sbt;
  const void* cm; long long scb, sct;
  const float* dt; const float* a; const float* d; const float* h0;
  float* y; float* hout;
  int T, nh, hd, G, ds, lc;
};

size_t smem_bytes(int ds, int lc) {
  const size_t dsp = ds + 1;
  return sizeof(float) * (PS * dsp + 2 * lc * dsp + (size_t)lc * PS
                          + (size_t)lc * lc + 2 * lc);
}

template <typename T>
__global__ void __launch_bounds__(NT) ssd_kernel(Args p) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lc = p.lc, ds = p.ds, dsp = ds + 1;
  float* hs = smem;                    // [PS][dsp] state rows p0 .. p0+ps
  float* bs = hs + PS * dsp;           // [lc][dsp] B of the chunk
  float* cs = bs + lc * dsp;           // [lc][dsp] C of the chunk
  float* xs = cs + lc * dsp;           // [lc][PS]  x of the chunk
  float* ws = xs + lc * PS;            // [lc][lc]  intra-chunk weights
  float* cum = ws + lc * lc;           // [lc]      cumsum(dt * a)
  float* dts = cum + lc;               // [lc]      dt, then seg * dt

  const int nslice = (p.hd + PS - 1) / PS;
  const int slice = blockIdx.x % nslice;
  const int head = (blockIdx.x / nslice) % p.nh;
  const int b = blockIdx.x / (nslice * p.nh);
  const int p0 = slice * PS;
  const int ps = min(PS, p.hd - p0);
  const int g = head / (p.nh / p.G);
  const float a = p.a[head], dskip = p.d[head];
  const T* x = static_cast<const T*>(p.x) + b * p.sxb + (long long)head * p.hd + p0;
  const T* bm = static_cast<const T*>(p.bm) + b * p.sbb + (long long)g * ds;
  const T* cm = static_cast<const T*>(p.cm) + b * p.scb + (long long)g * ds;
  const float* dt = p.dt + (long long)b * p.T * p.nh + head;
  const long long yrow = (long long)p.nh * p.hd;
  float* y = p.y + (long long)b * p.T * yrow + (long long)head * p.hd + p0;
  const long long hbase = ((long long)b * p.nh + head) * p.hd + p0;

  for (int i = tid; i < PS * ds; i += NT) {
    const int r = i / ds, n = i % ds;
    hs[r * dsp + n] = (p.h0 != nullptr && r < ps)
                          ? p.h0[(hbase + r) * ds + n] : 0.f;
  }

  for (int t0 = 0; t0 < p.T; t0 += lc) {
    const int len = min(lc, p.T - t0);
    for (int i = tid; i < lc * ds; i += NT) {
      const int j = i / ds, n = i % ds;
      const bool ok = j < len;
      bs[j * dsp + n] = ok ? to_f(bm[(t0 + j) * p.sbt + n]) : 0.f;
      cs[j * dsp + n] = ok ? to_f(cm[(t0 + j) * p.sct + n]) : 0.f;
    }
    for (int i = tid; i < lc * PS; i += NT) {
      const int j = i / PS, r = i % PS;
      xs[i] = (j < len && r < ps) ? to_f(x[(t0 + j) * p.sxt + r]) : 0.f;
    }
    for (int j = tid; j < lc; j += NT)
      dts[j] = j < len ? dt[(long long)(t0 + j) * p.nh] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int j = 0; j < lc; ++j) {
        s += dts[j] * a;
        cum[j] = s;
      }
    }
    __syncthreads();

    // intra-chunk weights w[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j
    for (int i = tid; i < lc * lc; i += NT) {
      const int r = i / lc, c = i % lc;
      float w = 0.f;
      if (c <= r) {
        float s = 0.f;
        for (int n = 0; n < ds; ++n) s = fmaf(cs[r * dsp + n], bs[c * dsp + n], s);
        w = s * expf(cum[r] - cum[c]) * dts[c];
      }
      ws[i] = w;
    }
    __syncthreads();

    // outputs of the chunk: intra + inter (from the entering state) + skip
    for (int i = tid; i < lc * PS; i += NT) {
      const int r = i / PS, q = i % PS;
      if (r < len && q < ps) {
        float intra = 0.f;
        for (int j = 0; j <= r; ++j) intra = fmaf(ws[r * lc + j], xs[j * PS + q], intra);
        float inter = 0.f;
        for (int n = 0; n < ds; ++n) inter = fmaf(cs[r * dsp + n], hs[q * dsp + n], inter);
        y[(t0 + r) * yrow + q] = intra + expf(cum[r]) * inter + dskip * xs[r * PS + q];
      }
    }
    __syncthreads();

    const float clast = cum[lc - 1];
    for (int j = tid; j < lc; j += NT) dts[j] = expf(clast - cum[j]) * dts[j];
    __syncthreads();

    // state carry: h = exp(cum_last) h + sum_j seg_j dt_j x_j (x) B_j
    const float cd = expf(clast);
    for (int i = tid; i < PS * ds; i += NT) {
      const int q = i / ds, n = i % ds;
      float s = 0.f;
      for (int j = 0; j < lc; ++j) s = fmaf(dts[j] * xs[j * PS + q], bs[j * dsp + n], s);
      hs[q * dsp + n] = cd * hs[q * dsp + n] + s;
    }
    __syncthreads();
  }

  for (int i = tid; i < ps * ds; i += NT) {
    const int r = i / ds, n = i % ds;
    p.hout[(hbase + r) * ds + n] = hs[r * dsp + n];
  }
}

template <typename T>
cudaError_t launch(const Args& args, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(args.ds, args.lc);
  cudaError_t err = allow_smem(ssd_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  const int nslice = (args.hd + PS - 1) / PS;
  ssd_kernel<T><<<B * args.nh * nslice, NT, smem, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_prefill_launch(
    const void* x, long long sxb, long long sxt,
    const void* bm, long long sbb, long long sbt,
    const void* cm, long long scb, long long sct,
    const void* dt, const void* a, const void* d, const void* h0,
    void* y, void* hout, int B, int T, int nh, int hd, int G, int ds, int lc,
    int dtype, void* stream) {
  if (B < 1 || T < 1 || nh < 1 || hd < 1 || ds < 1 || lc < 1 || G < 1
      || nh % G != 0 || smem_bytes(ds, lc) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  Args args{x, sxb, sxt, bm, sbb, sbt, cm, scb, sct,
            static_cast<const float*>(dt), static_cast<const float*>(a),
            static_cast<const float*>(d), static_cast<const float*>(h0),
            static_cast<float*>(y), static_cast<float*>(hout),
            T, nh, hd, G, ds, lc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1 ? launch<bf16>(args, B, s)
                               : launch<float>(args, B, s);
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
