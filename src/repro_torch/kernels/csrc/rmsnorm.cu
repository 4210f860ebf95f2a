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
//                     dtype, summed in a fixed order (a partial row a
//                     block, then a reduce over ceil(d / 32) blocks): no
//                     float atomics, the same bits from run to run.
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
// an element).  Design, on the forward's pattern: a row is tpr threads,
// each holding NVEC vectors of 8 values of x and of dy in registers
// (vector c of thread i is the row's vector i + c tpr), loaded with
// 16-byte streaming loads; a block takes rpb rows at a time and walks the
// row groups with a grid stride.  The row's dot product mean(xhat w' dy)
// is a shuffle among the row's threads (tpr a power of two up to 32), or,
// for rows of whole warps, a warp sum and one exchange through shared
// memory behind a named barrier of the row's own warps: no block-wide
// barrier a row.  dx = rstd (w' dy - xhat mean) goes out as 16-byte
// streaming stores.  Each thread sums its columns' d scale = dy xhat over
// the rows it takes in registers; at the end the block adds its rpb row
// groups' sums in order (shared memory) into one partial row, part[block],
// and rmsnorm_dw_reduce sums the partial rows in a fixed order over
// ceil(d / 32) blocks.  w' (w, or 1 + w) sits in shared memory as the
// forward's two planes.  rmsnorm.py's bwd_launch_shape picks tpr, NVEC
// (at most RMS_BWD_VMAX: x, dy and the d scale sums share the register
// file) and rpb; widths up to RMS_MAXD.
constexpr int RMS_BWD_VMAX = 4;      // vectors of 8 values a thread holds
constexpr int RMS_RED_COLS = 32;     // columns a block of the d scale reduce

template <typename T, typename W, int NVEC>
__global__ void __launch_bounds__(RMS_BLOCK) rmsnorm_bwd_kernel(
    const T* __restrict__ x, const W* __restrict__ w,
    const T* __restrict__ dy, const float* __restrict__ rstd,
    T* __restrict__ dx, float* __restrict__ part, long rows, int d,
    int gemma_style, int tpr, int rpb) {
  extern __shared__ float smem[];
  const int nv = d / 8;
  float4* wl = reinterpret_cast<float4*>(smem);  // values 0..3 of a vector
  float4* wh = wl + nv;                          // values 4..7
  float* red = smem + 8 * nv;                    // 2 x (warps a block)
  const int tid = threadIdx.x, nthreads = tpr * rpb;
  const int r = tid / tpr, i = tid - r * tpr;
  const int warp = tid >> 5, lane = tid & 31, wpr = tpr >> 5;
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
  float dws[NVEC][8];
#pragma unroll
  for (int c = 0; c < NVEC; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j) dws[c][j] = 0.f;
  int buf = 0;
  for (long grp = blockIdx.x; grp * rpb < rows; grp += gridDim.x, buf ^= 1) {
    const long row = grp * rpb + r;
    const bool live = row < rows;
    Raw8<T> xv[NVEC], gv[NVEC];
#pragma unroll
    for (int c = 0; c < NVEC; ++c)
      if (live && i + c * tpr < nv) {
        xv[c].load(x + row * d + 8 * (i + c * tpr));
        gv[c].load(dy + row * d + 8 * (i + c * tpr));
      }
    const float rs = live ? rstd[row] : 0.f;
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < NVEC; ++c) {
      const int vi = i + c * tpr;
      if (live && vi < nv) {
        float f[8], g[8];
        xv[c].get(f);
        gv[c].get(g);
        const float4 a = wl[vi], b = wh[vi];
        const float s[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) dot += (f[j] * rs) * (s[j] * g[j]);
      }
    }
    if (tpr <= 32) {
      for (int o = tpr >> 1; o > 0; o >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
    } else {
      dot = warp_sum(dot);
      float* rb = red + buf * (RMS_BLOCK / 32);
      if (lane == 0) rb[warp] = dot;
      // the row's wpr warps only: barrier 1 + r of tpr threads
      asm volatile("bar.sync %0, %1;" :: "r"(1 + r), "r"(tpr) : "memory");
      dot = 0.f;
      for (int k = 0; k < wpr; ++k) dot += rb[r * wpr + k];
    }
    const float mean = dot / (float)d;
#pragma unroll
    for (int c = 0; c < NVEC; ++c) {
      const int vi = i + c * tpr;
      if (live && vi < nv) {
        float f[8], g[8];
        xv[c].get(f);
        gv[c].get(g);
        const float4 a = wl[vi], b = wh[vi];
        const float s[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xh = f[j] * rs;
          f[j] = rs * (s[j] * g[j] - xh * mean);
          dws[c][j] += g[j] * xh;
        }
        Raw8<T>::put(dx + row * d + 8 * vi, f);
      }
    }
  }
  // the block's partial row: row group r's sums at acc[r d ..], over w'
  // (no longer read), then added in the order r = 0 .. rpb - 1
  __syncthreads();
  float* acc = smem;
#pragma unroll
  for (int c = 0; c < NVEC; ++c) {
    const int vi = i + c * tpr;
    if (vi < nv)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r * d + 8 * vi + j] = dws[c][j];
  }
  __syncthreads();
  for (int col = tid; col < d; col += nthreads) {
    float s = 0.f;
    for (int k = 0; k < rpb; ++k) s += acc[k * d + col];
    part[(long)blockIdx.x * d + col] = s;
  }
}

// dw[c] = the sum of part[b][c] over b < nblk: 32 columns a block, warp k
// summing the rows b = k, k + 8, ... in order, then the 8 warps' sums in
// order
template <typename W>
__global__ void __launch_bounds__(RMS_BLOCK) rmsnorm_dw_reduce(
    const float* __restrict__ part, W* __restrict__ dw, int nblk, int d) {
  constexpr int NW = RMS_BLOCK / 32;
  __shared__ float sums[NW][RMS_RED_COLS];
  const int lane = threadIdx.x & 31, k = threadIdx.x >> 5;
  const int c = blockIdx.x * RMS_RED_COLS + lane;
  float s = 0.f;
  if (c < d)
    for (int b = k; b < nblk; b += NW) s += part[(long)b * d + c];
  sums[k][lane] = s;
  __syncthreads();
  if (k == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int j = 0; j < NW; ++j) t += sums[j][lane];
    store(dw + c, t);
  }
}

template <typename T, typename W, int NVEC>
int launch_bwd_rows(const void* x, const void* w, const void* dy,
                    const float* rstd, void* dx, void* dw, float* part,
                    long rows, int d, int gemma_style, int tpr, int rpb,
                    int nblk, cudaStream_t st) {
  // w' and the row sums, then (aliasing them) the rpb partial rows
  const size_t smem = sizeof(float) * ((size_t)d * max(rpb, 1)
                                       + 2 * (RMS_BLOCK / 32));
  rmsnorm_bwd_kernel<T, W, NVEC><<<nblk, tpr * rpb, smem, st>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<const T*>(dy), rstd, static_cast<T*>(dx), part, rows, d,
      gemma_style, tpr, rpb);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_dw_reduce<W><<<(d + RMS_RED_COLS - 1) / RMS_RED_COLS, RMS_BLOCK,
                         0, st>>>(part, static_cast<W*>(dw), nblk, d);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch_bwd(const void* x, const void* w, const void* dy,
               const float* rstd, void* dx, void* dw, float* part, long rows,
               int d, int gemma_style, int tpr, int nvec, int rpb, int nblk,
               cudaStream_t st) {
  switch (nvec) {
    case 1: return launch_bwd_rows<T, W, 1>(x, w, dy, rstd, dx, dw, part,
                                            rows, d, gemma_style, tpr, rpb,
                                            nblk, st);
    case 2: return launch_bwd_rows<T, W, 2>(x, w, dy, rstd, dx, dw, part,
                                            rows, d, gemma_style, tpr, rpb,
                                            nblk, st);
    case 3: return launch_bwd_rows<T, W, 3>(x, w, dy, rstd, dx, dw, part,
                                            rows, d, gemma_style, tpr, rpb,
                                            nblk, st);
    case 4: return launch_bwd_rows<T, W, 4>(x, w, dy, rstd, dx, dw, part,
                                            rows, d, gemma_style, tpr, rpb,
                                            nblk, st);
  }
  return (int)cudaErrorInvalidValue;
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
// workspace of nblk x d (nblk blocks walking the row groups with a grid
// stride).  The launch shape (rmsnorm.py's bwd_launch_shape): tpr threads
// a row (a power of two up to 32 or a multiple of 32), nvec vectors of 8
// values a thread (tpr nvec >= d / 8, nvec <= 4), rpb rows a block (tpr
// rpb <= 256, a multiple of 32).  d a multiple of 8 up to 8192; x, dy and
// dx 16-byte aligned.
extern "C" int rmsnorm_bwd(const void* x, const void* w, const void* dy,
                           const void* rstd, void* dx, void* dw, void* part,
                           long rows, int d, int gemma_style, int x_dtype,
                           int w_dtype, int tpr, int nvec, int rpb, int nblk,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pow2 = tpr <= 32 && (tpr & (tpr - 1)) == 0;
  if (rows < 1 || d < 8 || d % 8 || d > RMS_MAXD || nblk < 1 || tpr < 1
      || !(pow2 || tpr % 32 == 0) || nvec < 1 || nvec > RMS_BWD_VMAX
      || (long)tpr * nvec < d / 8 || rpb < 1 || tpr * rpb > RMS_BLOCK
      || (tpr * rpb) % 32)
    return (int)cudaErrorInvalidValue;
  const float* rs = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  if (x_dtype == 1 && w_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(x, w, dy, rs, dx, dw, pt, rows,
                                            d, gemma_style, tpr, nvec, rpb,
                                            nblk, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(
        x, w, dy, rs, dx, dw, pt, rows, d, gemma_style, tpr, nvec, rpb, nblk,
        st);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_bwd<float, float>(x, w, dy, rs, dx, dw, pt, rows, d,
                                    gemma_style, tpr, nvec, rpb, nblk, st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(x, w, dy, rs, dx, dw, pt, rows,
                                            d, gemma_style, tpr, nvec, rpb,
                                            nblk, st);
  return (int)cudaErrorInvalidValue;
}
