// Device code shared by the port's attention sweeps (paged_attention.cu,
// ring_attention.cu): the masked-score constant, 16-byte row loads into
// shared memory (with the int8 rows' fused dequant, in 8-byte loads where
// a row's width is not a multiple of 16), warp reductions and the epilogue
// that writes a sweep's result (normalised output for one split, partial
// + log-sum-exp for several).  Everything is internal to the translation
// unit that includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

// the JAX reference's masked-score constant, -0.7 * finfo(float32).max
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int NT = 128;              // threads per sweep block
constexpr int NWARP = NT / 32;

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

// N int8 values in one N-byte load (N = 16, or 8 where rows are only
// 8-byte aligned: a row of 120 values puts every odd row 8 bytes off a
// 16-byte boundary)
template <int N>
__device__ __forceinline__ void load_int8(const int8_t* src, float* dst) {
  static_assert(N == 16 || N == 8, "int8 loads of 16 or 8 bytes");
  using V = typename std::conditional<N == 16, int4, int2>::type;
  const V v = *reinterpret_cast<const V*>(src);
  const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = static_cast<float>(b[i]);
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// n_rows rows of HD elements, row r at base + r * row_stride, into a
// shared-memory fp32 tile whose rows are LD floats apart; 16-byte loads,
// neighbouring threads on neighbouring addresses.
template <typename T, int HD, int LD = HD>
__device__ __forceinline__ void load_rows(const T* base, long row_stride,
                                          int n_rows, float* dst) {
  constexpr int VN = 16 / sizeof(T);
  static_assert(HD % VN == 0, "a row must be whole 16-byte loads");
  constexpr int PER_ROW = HD / VN;
  float v[VN];
  for (int c = threadIdx.x; c < n_rows * PER_ROW; c += NT) {
    const int r = c / PER_ROW;
    const int col = (c - r * PER_ROW) * VN;
    load16(base + r * row_stride + col, v);
#pragma unroll
    for (int j = 0; j < VN; ++j) dst[r * LD + col + j] = v[j];
  }
}

// The fused-dequant load, the port of the JAX sweeps' _load_kv
// (src/repro/kernels/decode_attention.py:94): n_rows int8 rows of HD
// values, row r at base + r * row_stride, each multiplied by its fp32
// scale scale[r * scale_stride] as it lands in the fp32 tile (the JAX
// oracle's q.astype(f32) * scale, the same one rounding).  One 16-byte
// load per 16 values where HD is a multiple of 16, else one 8-byte load
// per 8 (HD 120: rows of 120 bytes are 8-byte aligned only), neighbouring
// threads on neighbouring addresses; the scales are read in place with
// the pool's or ring's own row stride.
template <int HD, int LD = HD>
__device__ __forceinline__ void load_rows_int8(const int8_t* base,
                                               long row_stride,
                                               const float* scale,
                                               long scale_stride, int n_rows,
                                               float* dst) {
  constexpr int VN = HD % 16 == 0 ? 16 : 8;
  static_assert(HD % VN == 0, "an int8 row must be whole 16- or 8-byte "
                "loads");
  constexpr int PER_ROW = HD / VN;
  float v[VN];
  for (int c = threadIdx.x; c < n_rows * PER_ROW; c += NT) {
    const int r = c / PER_ROW;
    const int col = (c - r * PER_ROW) * VN;
    load_int8<VN>(base + r * row_stride + col, v);
    const float s = scale[r * scale_stride];
#pragma unroll
    for (int j = 0; j < VN; ++j) dst[r * LD + col + j] = v[j] * s;
  }
}

// A sweep's k or v rows into the fp32 tile: the int8 storage through the
// dequantizing load (scale rows r * scale_stride apart), any other through
// load_rows (scale unused, null).
template <typename TKV, int HD, int LD = HD>
__device__ __forceinline__ void load_kv_rows(const TKV* base, long row_stride,
                                             const float* scale,
                                             long scale_stride, int n_rows,
                                             float* dst) {
  if constexpr (std::is_same<TKV, int8_t>::value)
    load_rows_int8<HD, LD>(base, row_stride, scale, scale_stride, n_rows,
                           dst);
  else
    load_rows<TKV, HD, LD>(base, row_stride, n_rows, dst);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// The sweep's epilogue for query rows 0..Q-1 of (batch b, q head h, split
// s): one split writes the normalised output straight into out
// (B, Q, Hq, HD) in the query dtype; several write the fp32 partial
// (B, Hq, S, Q, HD) and lse (B, Hq, S, Q), lse = NEG_INF for a split that
// saw no valid key (l == 0).
template <typename T, int HD>
__device__ void write_result(const float* accs, const float* ms,
                             const float* ls, int Q, int b, int h, int s,
                             int Hq, int n_splits, T* __restrict__ out,
                             float* __restrict__ partial,
                             float* __restrict__ lse) {
  if (n_splits == 1) {
    for (int idx = threadIdx.x; idx < Q * HD; idx += NT) {
      const int i = idx / HD, c = idx - i * HD;
      store(out + (((long)b * Q + i) * Hq + h) * HD + c,
            accs[idx] / fmaxf(ls[i], 1e-30f));
    }
  } else {
    const long cell = ((long)b * Hq + h) * n_splits + s;
    for (int idx = threadIdx.x; idx < Q * HD; idx += NT) {
      const int i = idx / HD;
      partial[cell * Q * HD + idx] = accs[idx] / fmaxf(ls[i], 1e-30f);
    }
    if (threadIdx.x < Q) {
      const float l = ls[threadIdx.x];
      lse[cell * Q + threadIdx.x] =
          l > 0.f ? ms[threadIdx.x] + logf(fmaxf(l, 1e-30f)) : NEG_INF;
    }
  }
}

}  // namespace
