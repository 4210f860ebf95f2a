// Device code shared by the port's kernels (flash_attention.cu,
// mla_attention.cu, rmsnorm.cu, ssd_scan.cu and, through
// sweep_fragments.cuh, the paged and ring sweeps): the masked-score
// constant, a 16-byte load of 8 bf16 or 4 fp32 values into floats, a
// store from a float into either, and a warp sum.  Everything is internal
// to the translation unit that includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// the JAX reference's masked-score constant, -0.7 * finfo(float32).max
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace
