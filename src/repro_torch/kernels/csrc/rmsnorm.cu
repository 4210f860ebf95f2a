// Fused RMSNorm for Hopper (sm_90a), with a plain C interface loaded
// through ctypes (src/repro_torch/kernels/build.py builds it into the
// port's kernel library, src/repro_torch/kernels/rmsnorm.py wraps it).
//
//   rmsnorm_fwd  out = x * rsqrt(mean(x^2) + eps) * w  (or * (1 + w), the
//                gemma form) over the last axis of x (rows, d), fp32
//                inside, out in x's dtype.
//
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that a refused launch is reported.
#include "attention_common.cuh"

namespace {

constexpr int RMS_NT = 128;          // threads per row

// 8 consecutive elements: one 16-byte load of bf16, two of fp32
__device__ __forceinline__ void load8(const float* src, float* dst) {
  load16(src, dst);
  load16(src + 4, dst + 4);
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  load16(src, dst);
}

__device__ __forceinline__ void store8(float* dst, const float* x) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = u;
}

// Replaces, from src/repro/kernels/rmsnorm.py:
//   rmsnorm_pallas  (:27, kernel _rms_kernel :17, pallas_call :40)
// Bound on the card: bytes (x read, out written, about 4 FLOP per
// element).  Design: one block per row.  Each thread sums x^2 in fp32 over
// its 8-element vectors (16-byte loads, neighbouring threads on
// neighbouring addresses), warp shuffles and one shared-memory step finish
// the row's sum, then a second pass reads x again (from L1 / L2: a row is
// at most a few tens of KB) with w and writes x * rsqrt(sum / d + eps) * w
// in x's dtype -- the reference's order of operations.  The TPU kernel's
// row blocks of 256 become 132 SMs' worth of one-row blocks; nothing is
// carried between blocks.
template <typename T, typename W>
__global__ void __launch_bounds__(RMS_NT) rmsnorm_kernel(
    const T* __restrict__ x, const W* __restrict__ w, T* __restrict__ out,
    int d, float eps, int gemma_style) {
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
  for (int c = threadIdx.x; c < nv; c += RMS_NT) {
    float v[8], s[8];
    load8(xr + 8 * c, v);
    load8(w + 8 * c, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = (v[j] * r) * (gemma_style ? 1.f + s[j] : s[j]);
    store8(orow + 8 * c, v);
  }
}

template <typename T, typename W>
int launch_rms(const void* x, const void* w, void* out, long rows, int d,
               float eps, int gemma_style, cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<(unsigned)rows, RMS_NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), d, eps, gemma_style);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype / w_dtype: 0 = float32, 1 = bfloat16 (out has x's).  d a
// multiple of 8, rows >= 1, x, w and out 16-byte aligned.
extern "C" int rmsnorm_fwd(const void* x, const void* w, void* out,
                           long rows, int d, float eps, int gemma_style,
                           int x_dtype, int w_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || rows > 0x7fffffffL || d < 8 || d % 8)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 1 && w_dtype == 0)
    return launch_rms<__nv_bfloat16, float>(x, w, out, rows, d, eps,
                                            gemma_style, st);
  if (x_dtype == 1 && w_dtype == 1)
    return launch_rms<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps,
                                                    gemma_style, st);
  if (x_dtype == 0 && w_dtype == 0)
    return launch_rms<float, float>(x, w, out, rows, d, eps, gemma_style,
                                    st);
  if (x_dtype == 0 && w_dtype == 1)
    return launch_rms<float, __nv_bfloat16>(x, w, out, rows, d, eps,
                                            gemma_style, st);
  return (int)cudaErrorInvalidValue;
}
