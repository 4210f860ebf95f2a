// Device code of the attention sweeps whose online-softmax state lives in
// the C fragments of mma.sync m16n8k16 (tensor_core.cuh), 16 rows a warp:
// the paged sweep (paged_attention.cu), whose keys are spread over the
// warps of a block, every warp holding the state of the same 16 rows, row
// tile against key tile, merged once, at the end, through shared memory;
// and the latent sweep (mla_attention.cu), whose warps each hold a slice
// of the value columns of their rows.
//
// The fragment layout (lane l, quad row l / 4, quad column 2 (l % 4)):
// element e of n8 tile n is row 8 (e >> 1) + l / 4, column 8 n + 2 (l % 4)
// + (e & 1).  A 16-key score tile is two n8 tiles; an output row of HD
// values is HD / 8 n8 tiles.  The CUDA-core forms keep the same layout, so
// everything here serves both.
//
// Everything is internal to the translation unit that includes it.
#pragma once

#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int FRAG_ROWS = 16;         // the rows of a state: one m16 tile

// The online-softmax state of one warp's 16 rows: the output accumulators
// o (NO n8 tiles a row), the running max m and sum l of the two rows this
// thread holds (h = 0: row l / 4, h = 1: row l / 4 + 8).  FAST takes p =
// e^x on the special-function unit (__expf, for bf16 products, whose p
// enters p.v with 16 bits); else expf, as the plain version.
template <int NO, bool FAST>
struct FragRows {
  float o[NO][4];
  float m[2], l[2];

  static __device__ __forceinline__ float ex(float x) {
    return FAST ? __expf(x) : expf(x);
  }

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m[h] = NEG_INF;
      l[h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  }

  // One 16-key tile's update, the reference's _online_softmax_update: s
  // holds the tile's scores, already scaled, capped and masked (NEG_INF
  // for a masked key, -inf for a key that is not part of the sweep, which
  // weighs nothing); they are replaced by p = exp(s - m'), m' = max(m, max
  // s), and l' = l e^(m - m') + sum p, o' = o e^(m - m').  Row max and sum
  // are two quad shuffles.
  __device__ __forceinline__ void update(float (&s)[2][4]) {
    float mx[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                    fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      mx[h] = fmaxf(m[h], mx[h]);
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = ex(s[n][e] - mx[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      const float corr = ex(m[h] - mx[h]);
      l[h] = l[h] * corr + sum[h];
      m[h] = mx[h];
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
    }
  }
};

// Merge the nw warps' states of the block's rows, with the log-sum-exp
// arithmetic of lse_merge: M = max_w m_w, L = sum_w l_w e^(m_w - M), and
// each warp's o scaled by e^(m_w - M) into its own fp32 slice of 16 x OLD
// floats (obuf, which may alias the warp's tiles: the warp is done with
// them).  ml holds nw x 16 (m, l) pairs, rml the 16 (M, L).  A warp that
// saw no key (m = NEG_INF, l = 0, o = 0) adds nothing; where every warp
// saw only masked keys (m = NEG_INF), all weigh 1, as the sequential
// update would have summed them.  Ends with the block's barrier, so the
// rows' o slices, M and L are complete after it.
template <int NO, int OLD, bool FAST>
__device__ void merge_warps(const FragRows<NO, FAST>& st, float* ml,
                            float* rml, float* obuf) {
  constexpr int ROWS = FRAG_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  if ((lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 8 * h + (lane >> 2);
      ml[2 * (warp * ROWS + r)] = st.m[h];
      ml[2 * (warp * ROWS + r) + 1] = st.l[h];
    }
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 8 * h + (lane >> 2);
    float M = NEG_INF;
    for (int w = 0; w < nw; ++w) M = fmaxf(M, ml[2 * (w * ROWS + r)]);
    const float c = expf(st.m[h] - M);
    if (warp == 0 && (lane & 3) == 0) {
      float L = 0.f;
      for (int w = 0; w < nw; ++w)
        L += ml[2 * (w * ROWS + r) + 1] * expf(ml[2 * (w * ROWS + r)] - M);
      rml[2 * r] = M;
      rml[2 * r + 1] = L;
    }
    float* orow = obuf + r * OLD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(st.o[n][2 * h] * c, st.o[n][2 * h + 1] * c);
  }
  __syncthreads();
}

__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

// Where one warp holds the block's only state (a block with at most one
// tile), the sweep's result straight from its fragments, two columns a
// store; rows, layouts and normalisation as write_rows.
template <typename T, int HD, bool FAST>
__device__ void write_state(const FragRows<HD / 8, FAST>& st, int live,
                            int row0, int G, int Q, int b, int hk, int s,
                            int Hq, int n_splits, T* __restrict__ out,
                            float* __restrict__ partial,
                            float* __restrict__ lse) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 8 * h + (lane >> 2);
    if (r >= live) continue;
    const int rr = row0 + r, i = rr / G, hq = hk * G + rr - i * G;
    const float inv = 1.f / fmaxf(st.l[h], 1e-30f);
    if (n_splits == 1) {
      T* o = out + (((long)b * Q + i) * Hq + hq) * HD + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        store2(o + 8 * n, st.o[n][2 * h] * inv, st.o[n][2 * h + 1] * inv);
    } else {
      const long cell = (((long)b * Hq + hq) * n_splits + s) * Q + i;
      float* o = partial + cell * HD + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        store2(o + 8 * n, st.o[n][2 * h] * inv, st.o[n][2 * h + 1] * inv);
      if ((lane & 3) == 0)
        lse[cell] = st.l[h] > 0.f ? st.m[h] + logf(fmaxf(st.l[h], 1e-30f))
                                  : NEG_INF;
    }
  }
}

// The sweep's result from the merged state, for the block's live rows of
// (batch b, kv head hk, split s): row r is (query i, head g) with row0 + r
// = i G + g.  One split writes out (B, Q, Hq, HD) = acc / L in the query
// dtype; several write the fp32 partial (B, Hq, S, Q, HD) = acc / L and
// lse (B, Hq, S, Q) = M + log L, or NEG_INF where L == 0 (a split with no
// key: its partial is 0).  acc sums the nw warp slices in warp order, so
// the result does not depend on timing.  Four columns a thread at a time;
// 1 / L is one reciprocal, not a division an element (a split with no key
// would divide 0 by 1e-30, the division's slow path, in every element).
template <typename T, int HD, int OLD, int WARP_FLOATS>
__device__ void write_rows(const float* obuf0, const float* rml, int live,
                           int row0, int G, int Q, int b, int hk, int s,
                           int Hq, int n_splits, T* __restrict__ out,
                           float* __restrict__ partial,
                           float* __restrict__ lse) {
  constexpr int C4 = HD / 4;
  static_assert(HD % 4 == 0, "rows of whole float4s");
  const int nw = blockDim.x >> 5;
  for (int idx = threadIdx.x; idx < live * C4; idx += blockDim.x) {
    const int r = idx / C4, c = (idx - r * C4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < nw; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(
          obuf0 + (long)w * WARP_FLOATS + r * OLD + c);
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
    }
    const float inv = 1.f / fmaxf(rml[2 * r + 1], 1e-30f);
    a.x *= inv; a.y *= inv; a.z *= inv; a.w *= inv;
    const int rr = row0 + r, i = rr / G, h = hk * G + rr - i * G;
    if (n_splits == 1) {
      T* o = out + (((long)b * Q + i) * Hq + h) * HD + c;
      store2(o, a.x, a.y);
      store2(o + 2, a.z, a.w);
    } else {
      *reinterpret_cast<float4*>(
          partial + ((((long)b * Hq + h) * n_splits + s) * Q + i) * HD + c) = a;
    }
  }
  if (n_splits > 1) {
    for (int r = threadIdx.x; r < live; r += blockDim.x) {
      const int rr = row0 + r, i = rr / G, h = hk * G + rr - i * G;
      const float L = rml[2 * r + 1];
      lse[(((long)b * Hq + h) * n_splits + s) * Q + i] =
          L > 0.f ? rml[2 * r] + logf(fmaxf(L, 1e-30f)) : NEG_INF;
    }
  }
}

}  // namespace
