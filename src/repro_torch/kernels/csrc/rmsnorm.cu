// Fused RMSNorm for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (src/repro_torch/kernels/build.py builds it into the
// port's kernel library, src/repro_torch/kernels/rmsnorm.py wraps it).
//
//   rmsnorm_fwd       out = x * rsqrt(mean(x^2) + eps) * w  (or * (1 + w),
//                     the gemma form) over the last axis of x (rows, d),
//                     fp32 inside, out in x's dtype; given a non-null
//                     rstd, also each row's fp32 rstd = rsqrt(mean(x^2) +
//                     eps), which the backward reads.
//   rmsnorm_bwd       the gradient: dx = rstd (w' dy - xhat mean(xhat w'
//                     dy)) with xhat = x rstd and w' = w (or 1 + w), in x's
//                     dtype, and dw = the sum over rows of dy xhat, in w's
//                     dtype, summed in a fixed order (per-block partials,
//                     then one reduce): no float atomics, the same bits
//                     from run to run.
//
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that a refused launch is reported.
#include "attention_common.cuh"

namespace {

constexpr int RMS_VMAX = 9;          // vectors of 8 values a thread holds
constexpr int RMS_BLOCK = 256;       // threads a block, at most
constexpr int RMS_NT = 128;          // threads a row of the two-pass kernel
constexpr int RMS_MAXD = 8192;       // widest row of the register kernel

// 8 consecutive values of x as loaded: one 16-byte word of bf16, two of
// fp32; streaming loads (read once) and stores (written once)
template <typename T>
struct Raw8;

template <>
struct Raw8<__nv_bfloat16> {
  uint4 u;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    u = __ldcs(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void get(float* v) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static void put(__nv_bfloat16* p,
                                             const float* v) {
    uint4 o;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), o);
  }
};

template <>
struct Raw8<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = __ldcs(reinterpret_cast<const float4*>(p));
    b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  }
  __device__ __forceinline__ void get(float* v) const {
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  __device__ __forceinline__ static void put(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(v[4], v[5], v[6], v[7]));
  }
};

// 8 consecutive elements: one 16-byte load of bf16, two of fp32
__device__ __forceinline__ void load8(const float* src, float* dst) {
  load16(src, dst);
  load16(src + 4, dst + 4);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  load16(src, dst);
}

// Replaces, from src/repro/kernels/rmsnorm.py:
//   rmsnorm_pallas  (:27, kernel _rms_kernel :17, pallas_call :40)
// Bound on the card: bytes (x read, out written, about 4 FLOP per
// element).  Design: a row is tpr threads, each holding NVEC vectors of
// 8 values in registers (vector c of thread i is the row's vector i + c
// tpr: neighbouring threads on neighbouring 16 bytes), so x is read once;
// NVEC is a template argument, so a thread keeps only the registers its
// width needs (occupancy is what hides the loads' latency);
// the wrapper picks tpr and nvec per width so that every thread holds a
// whole, equal count (rmsnorm.py's launch_shape), tpr a power of two up
// to 32 (several rows a warp, shuffles only) or a multiple of 32 (a warp
// sum, then one shared-memory exchange and one barrier a row).  A block
// takes rpb rows at a time and walks the row groups with a grid stride;
// it loads w (or 1 + w, the gemma form: the same fp32 value the reference
// multiplies by) once into shared memory, as two planes of 4 floats a
// vector (conflict-free 16-byte reads), while its first rows' loads are
// in flight.  The reference's order of operations: fp32 sum of squares,
// (x * rsqrt(sum / d + eps)) * w, one rounding to x's dtype.
template <typename T, typename W, int NVEC>
__global__ void __launch_bounds__(RMS_BLOCK) rmsnorm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    float* __restrict__ rstd, long rows, int d, float eps, int gemma_style,
    int tpr, int rpb) {
  extern __shared__ float smem[];
  const int nv = d / 8;
  float4* wl = reinterpret_cast<float4*>(smem);  // values 0..3 of a vector
  float4* wh = wl + nv;                          // values 4..7
  float* red = smem + 8 * nv;                    // 2 x (warps a block)
  const int tid = threadIdx.x, nthreads = tpr * rpb;
  const int r = tid / tpr, i = tid - r * tpr;
  const int warp = tid >> 5, lane = tid & 31, wpr = tpr >> 5;

  long grp = blockIdx.x;
  long row = grp * rpb + r;
  Raw8<T> v[NVEC];
#pragma unroll
  for (int c = 0; c < NVEC; ++c)
    if (i + c * tpr < nv && row < rows)
      v[c].load(x + row * d + 8 * (i + c * tpr));
  for (int c = tid; c < nv; c += nthreads) {
    float s[8];
    load8(w + 8 * c, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (gemma_style) s[j] = 1.f + s[j];
    wl[c] = make_float4(s[0], s[1], s[2], s[3]);
    wh[c] = make_float4(s[4], s[5], s[6], s[7]);
  }
  __syncthreads();
  for (int buf = 0;; buf ^= 1) {
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < NVEC; ++c)
      if (i + c * tpr < nv && row < rows) {
        float f[8];
        v[c].get(f);
#pragma unroll
        for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
      }
    if (tpr <= 32) {
      for (int o = tpr >> 1; o > 0; o >>= 1)
        ss += __shfl_xor_sync(0xffffffffu, ss, o);
    } else {
      ss = warp_sum(ss);
      float* rb = red + buf * (RMS_BLOCK / 32);
      if (lane == 0) rb[warp] = ss;
      __syncthreads();
      ss = 0.f;
      for (int k = 0; k < wpr; ++k) ss += rb[r * wpr + k];
    }
    const float rr = rsqrtf(ss / (float)d + eps);
    if (rstd != nullptr && i == 0 && row < rows) rstd[row] = rr;
#pragma unroll
    for (int c = 0; c < NVEC; ++c) {
      const int vi = i + c * tpr;
      if (vi < nv && row < rows) {
        float f[8];
        v[c].get(f);
        const float4 a = wl[vi], b = wh[vi];
        const float s[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) f[j] = (f[j] * rr) * s[j];
        Raw8<T>::put(out + row * d + 8 * vi, f);
      }
    }
    grp += gridDim.x;
    if (grp * rpb >= rows) break;
    row = grp * rpb + r;
#pragma unroll
    for (int c = 0; c < NVEC; ++c)
      if (i + c * tpr < nv && row < rows)
        v[c].load(x + row * d + 8 * (i + c * tpr));
  }
}

// Rows wider than RMS_MAXD (32 KB of fp32 scale; the wrapper's
// launch_shape gives tpr = 0): one block per row sums x^2 in
// fp32 over its 8-element vectors, then reads x again (from L1 / L2) with
// w and writes the output.
template <typename T, typename W>
__global__ void __launch_bounds__(RMS_NT) rmsnorm_wide_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    float* __restrict__ rstd, int d, float eps, int gemma_style) {
  __shared__ float red[RMS_NT / 32];
  const long row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int nv = d / 8;
  float ss = 0.f;
  for (int c = threadIdx.x; c < nv; c += RMS_NT) {
    float v[8];
    load8(xr + 8 * c, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += v[j] * v[j];
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < RMS_NT / 32 ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float r = rsqrtf(red[0] / (float)d + eps);
  if (rstd != nullptr && threadIdx.x == 0) rstd[row] = r;
  for (int c = threadIdx.x; c < nv; c += RMS_NT) {
    float v[8], s[8];
    load8(xr + 8 * c, v);
    load8(w + 8 * c, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (v[j] * r) * (gemma_style ? 1.f + s[j] : s[j]);
    Raw8<T>::put(orow + 8 * c, v);
  }
}

template <typename T, typename W, int NVEC>
int launch_rows(const T* xt, const W* wt, T* ot, float* rstd, long rows,
                int d, float eps, int gemma_style, int tpr, int rpb,
                cudaStream_t stream) {
  auto kern = rmsnorm_kernel<T, W, NVEC>;
  const int threads = tpr * rpb;
  const size_t smem = sizeof(float) * (d + 2 * (RMS_BLOCK / 32));
  // the SM count once, blocks an SM for the last (threads, smem) asked
  static int n_sm = 0, last_threads = 0, per_sm = 0;
  static size_t last_smem = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (threads != last_threads || smem != last_smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads,
                                                  smem);
    last_threads = threads;
    last_smem = smem;
  }
  const long groups = (rows + rpb - 1) / rpb;
  const long resident = (long)max(per_sm, 1) * max(n_sm, 1);
  const unsigned grid = (unsigned)(groups < resident ? groups : resident);
  kern<<<grid, threads, smem, stream>>>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_rms(const void* x, const void* w, void* out, float* rstd,
               long rows, int d, float eps, int gemma_style, int tpr,
               int nvec, int rpb, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  T* ot = static_cast<T*>(out);
  if (tpr == 0) {
    if (rows > 0x7fffffffL) return (int)cudaErrorInvalidValue;
    rmsnorm_wide_kernel<T, W><<<(unsigned)rows, RMS_NT, 0, st>>>(
        xt, wt, ot, rstd, d, eps, gemma_style);
    return (int)cudaGetLastError();
  }
  switch (nvec) {
    case 1: return launch_rows<T, W, 1>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
    case 2: return launch_rows<T, W, 2>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
    case 3: return launch_rows<T, W, 3>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
    case 4: return launch_rows<T, W, 4>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
    case 5: return launch_rows<T, W, 5>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
    case 6: return launch_rows<T, W, 6>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
    case 7: return launch_rows<T, W, 7>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
    case 8: return launch_rows<T, W, 8>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
    case 9: return launch_rows<T, W, 9>(xt, wt, ot, rstd, rows, d, eps,
                                        gemma_style, tpr, rpb, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Bound on the card: bytes (x, dy and rstd read, dx written, about 10 FLOP
// an element).  Design, a simple kernel: a block of RMS_BWD_NT threads
// takes a contiguous run of rows, one row at a time, the threads across
// the row (column c + RMS_BWD_NT j, coalesced), each holding its x and dy
// values in registers between the row's two sweeps (the dot product
// mean(xhat w' dy), one block sum, then dx).  w' sits in shared memory;
// each thread keeps its columns' dw sums in registers over the block's
// rows and writes them, as the block's partial row, to part[blockIdx.x];
// rmsnorm_dw_reduce then sums the partials in block order.  Widths up to
// RMS_MAXD (RMS_BWD_C values a thread).
constexpr int RMS_BWD_NT = 256;
constexpr int RMS_BWD_C = RMS_MAXD / RMS_BWD_NT;

template <typename T, typename W>
__global__ void __launch_bounds__(RMS_BWD_NT) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const W* __restrict__ w,
    const T* __restrict__ dy, const float* __restrict__ rstd,
    T* __restrict__ dx, float* __restrict__ part, long rows, int d,
    int gemma_style, long rows_per_block) {
  extern __shared__ float smem[];
  float* ws = smem;                             // w', d values
  float* red = smem + d;                        // 2 x (warps a block)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int NW = RMS_BWD_NT / 32;
  for (int c = tid; c < d; c += RMS_BWD_NT) {
    const float s = (float)w[c];
    ws[c] = gemma_style ? 1.f + s : s;
  }
  __syncthreads();
  float dw[RMS_BWD_C];
#pragma unroll
  for (int j = 0; j < RMS_BWD_C; ++j) dw[j] = 0.f;
  const long r0 = (long)blockIdx.x * rows_per_block;
  const long r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  int buf = 0;
  for (long row = r0; row < r1; ++row, buf ^= 1) {
    const float rs = rstd[row];
    const T* xr = x + row * d;
    const T* gr = dy + row * d;
    float xh[RMS_BWD_C], g[RMS_BWD_C];
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < RMS_BWD_C; ++j) {
      const int c = tid + RMS_BWD_NT * j;
      if (c < d) {
        xh[j] = (float)xr[c] * rs;
        g[j] = (float)gr[c];
        dot += xh[j] * (ws[c] * g[j]);
      }
    }
    dot = warp_sum(dot);
    float* rb = red + buf * NW;
    if (lane == 0) rb[warp] = dot;
    __syncthreads();
    dot = 0.f;
#pragma unroll
    for (int k = 0; k < NW; ++k) dot += rb[k];
    const float mean = dot / (float)d;
#pragma unroll
    for (int j = 0; j < RMS_BWD_C; ++j) {
      const int c = tid + RMS_BWD_NT * j;
      if (c < d) {
        store(dx + row * d + c, rs * (ws[c] * g[j] - xh[j] * mean));
        dw[j] += g[j] * xh[j];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < RMS_BWD_C; ++j) {
    const int c = tid + RMS_BWD_NT * j;
    if (c < d) part[(long)blockIdx.x * d + c] = dw[j];
  }
}

// dw[c] = the sum of part[b][c] over b = 0 .. nblk - 1, in that order
template <typename W>
__global__ void __launch_bounds__(RMS_BWD_NT) rmsnorm_dw_reduce(
    const float* __restrict__ part, W* __restrict__ dw, int nblk, int d) {
  const int c = blockIdx.x * RMS_BWD_NT + threadIdx.x;
  if (c >= d) return;
  float s = 0.f;
  for (int b = 0; b < nblk; ++b) s += part[(long)b * d + c];
  store(dw + c, s);
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const void* dy,
               const float* rstd, void* dx, void* dw, float* part, long rows,
               int d, int gemma_style, int nblk, cudaStream_t st) {
  const long per = (rows + nblk - 1) / nblk;
  const size_t smem = sizeof(float) * (d + 2 * (RMS_BWD_NT / 32));
  rmsnorm_bwd_kernel<T, W><<<nblk, RMS_BWD_NT, smem, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(dy), rstd, static_cast<T*>(dx), part, rows, d,
      gemma_style, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dw_reduce<W><<<(d + RMS_BWD_NT - 1) / RMS_BWD_NT, RMS_BWD_NT, 0,
                         st>>>(part, static_cast<W*>(dw), nblk, d);
  return (int)cudaGetLastError();
}

int rms_forward(const void* x, const void* w, void* out, float* rstd,
                long rows, int d, float eps, int gemma_style, int x_dtype,
                int w_dtype, int tpr, int nvec, int rpb, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 8 || d % 8) return (int)cudaErrorInvalidValue;
  if (tpr != 0) {
    const bool pow2 = tpr <= 32 && (tpr & (tpr - 1)) == 0;
    if (tpr < 1 || !(pow2 || tpr % 32 == 0) || nvec < 1
        || nvec > RMS_VMAX || (long)tpr * nvec < d / 8 || rpb < 1
        || tpr * rpb > RMS_BLOCK || (tpr * rpb) % 32 || d > RMS_MAXD)
      return (int)cudaErrorInvalidValue;
  }
  if (x_dtype == 1 && w_dtype == 0)
    return launch_rms<__nv_bfloat16, float>(x, w, out, rstd, rows, d, eps,
                                            gemma_style, tpr, nvec, rpb, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_rms<__nv_bfloat16, __nv_bfloat16>(
        x, w, out, rstd, rows, d, eps, gemma_style, tpr, nvec, rpb, st);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_rms<float, float>(x, w, out, rstd, rows, d, eps,
                                    gemma_style, tpr, nvec, rpb, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_rms<float, __nv_bfloat16>(x, w, out, rstd, rows, d, eps,
                                            gemma_style, tpr, nvec, rpb, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16 (out has x's).  d a
// multiple of 8, rows >= 1, x, w and out 16-byte aligned.  The launch
// shape (rmsnorm.py's launch_shape): tpr threads a row (a power of two up
// to 32 or a multiple of 32), nvec vectors of 8 values a thread (tpr nvec
// >= d / 8, nvec <= 9), rpb rows a block (tpr rpb <= 256, d <= 8192);
// tpr = 0 takes the two-pass kernel, one 128-thread block a row.
// rstd: null (serving) or (rows,) fp32, for the backward.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out,
                           void* rstd, long rows, int d, float eps,
                           int gemma_style, int x_dtype, int w_dtype,
                           int tpr, int nvec, int rpb, void* stream) {
  return rms_forward(x, w, out, static_cast<float*>(rstd), rows, d, eps,
                     gemma_style, x_dtype, w_dtype, tpr, nvec, rpb, stream);
}

// The gradient of rmsnorm_fwd: x, dy and dx (rows, d) in x_dtype, w and dw
// (d,) in w_dtype, rstd (rows,) fp32 from rmsnorm_fwd, part an fp32
// workspace of nblk x d (nblk blocks, each a contiguous run of rows).
// 1 <= nblk <= rows, d a multiple of 8 up to 8192.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           const void* rstd, void* dx, void* dw, void* part,
                           long rows, int d, int gemma_style, int x_dtype,
                           int w_dtype, int nblk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || d < 8 || d % 8 || d > RMS_MAXD || nblk < 1
      || nblk > rows)
    return (int)cudaErrorInvalidValue;
  const float* rs = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, w, dy, rs, dx, dw, pt, rows,
                                            d, gemma_style, nblk, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, dy, rs, dx, dw, pt, rows, d, gemma_style, nblk, st);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd<float, float>(x, w, dy, rs, dx, dw, pt, rows, d,
                                    gemma_style, nblk, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, w, dy, rs, dx, dw, pt, rows,
                                            d, gemma_style, nblk, st);
  return (int)cudaErrorInvalidValue;
}
