// Device code of the merge K2b: the exact log-sum-exp merge of S split
// partials of a block's rows, shared by the standalone kernel
// (lse_merge_kernel, paged_attention.cu) and the fused tail of the split
// sweeps (merge_tail, sweep_fragments.cuh: the GQA sweep's and the latent
// sweep's last block of each row tile), so that a fused output is bit for
// bit the standalone merge of the same partials; and the tail's arrival
// at its counter.  Replaces merge_kv_splits_pallas and its
// _lse_merge_kernel, src/repro/kernels/decode_attention.py:172 and :156.
//
// Everything is internal to the translation unit that includes it.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "attention_common.cuh"

namespace {

__device__ __forceinline__ void store2(float* dst, float x, float y) {
  *reinterpret_cast<float2*>(dst) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x, y);
}

constexpr int MERGE_EPT = 2;         // float4 columns a thread sums at once
constexpr int MERGE_SPC = 8;         // splits whose loads go together

// The block merges n_rows rows.  Row r's S log-sum-exps are lse[cell + s
// lstride] and its S partial rows partial[(cell + s lstride) Dv ...],
// cell = rows.cell(r), s = 0 .. S-1; its output is out[rows.out(r) Dv
// ...] in TO:
//   M = max_s lse_s, w_s = e^(lse_s - M), den = max(sum_s w_s, 1e-30),
//   out = (sum_s partial_s w_s) / den,
// the arithmetic of _lse_merge_kernel.  Its time is a few L2 round trips
// and a chain of dependent instructions in few warps (a fused tail's are
// one block's, often one warp), so each thread takes EPT float4 columns
// of a row at a time (MERGE_EPT unless the caller says), j, j + n_cg, ...
// (n_cg = C4 / EPT rounded up: the lanes of a warp read consecutive
// float4s, every 32-byte sector whole), and issues their partials' loads
// and the row's lse loads of SPC splits (MERGE_SPC unless the caller
// says) together (ld.global.cg, L2 only: a fused tail reads what other
// blocks wrote in the same launch): S <= SPC costs one round trip a
// group, each later SPC splits one more.  M, w_s and den are taken again
// by every thread of a row from those loads: a few instructions, where a
// pass of one thread a row through shared memory and a barrier cost a
// round trip and a longer chain (tools/merge_variants.py, PERF.md).  No
// shared memory, no barrier.  Everything is summed in split order s = 0
// .. S-1 and the bits depend on nothing but the inputs (not on SPC or
// EPT), so a fused tail and the standalone kernel agree bit for bit.  A
// row whose every lse is NEG_INF (finite) becomes the uniform average of
// its zero partials.  Dv is a multiple of 4 and every partial row 16-byte
// aligned.
template <int SPC = MERGE_SPC, int EPT = MERGE_EPT, typename TO,
          typename Rows>
__device__ __forceinline__ void merge_rows(const float* lse,
                                           const float* partial, TO* out,
                                           int n_rows, long lstride, int S,
                                           int Dv, const Rows& rows) {
  const int C4 = Dv / 4, n_cg = (C4 + EPT - 1) / EPT;
  const long ps4 = lstride * C4;                // float4s between splits
  for (int g = threadIdx.x; g < n_rows * n_cg; g += blockDim.x) {
    const int r = g / n_cg, j = g - r * n_cg;
    const long cell = rows.cell(r);
    const float* lp = lse + cell;
    const float4* pp = reinterpret_cast<const float4*>(partial)
                       + cell * C4 + j;
    float v[SPC];
    float4 x[SPC][EPT];
    auto load = [&](int s0) {
#pragma unroll
      for (int i = 0; i < SPC; ++i) {
        const bool on = s0 + i < S;
        v[i] = on ? __ldcg(lp + (s0 + i) * lstride) : -INFINITY;
#pragma unroll
        for (int k = 0; k < EPT; ++k)
          x[i][k] = on && j + k * n_cg < C4
                    ? __ldcg(pp + (s0 + i) * ps4 + k * n_cg)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    load(0);
    float m = -INFINITY;
#pragma unroll
    for (int i = 0; i < SPC; ++i) m = fmaxf(m, v[i]);
    for (int s = SPC; s < S; ++s)
      m = fmaxf(m, __ldcg(lp + s * lstride));
    float d = 0.f;
    float4 acc[EPT];
#pragma unroll
    for (int k = 0; k < EPT; ++k)
      acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < S; s0 += SPC) {
      if (s0 > 0) load(s0);
#pragma unroll
      for (int i = 0; i < SPC; ++i) {
        if (s0 + i < S) {
          const float w = expf(v[i] - m);
          d += w;
#pragma unroll
          for (int k = 0; k < EPT; ++k) {
            acc[k].x = fmaf(x[i][k].x, w, acc[k].x);
            acc[k].y = fmaf(x[i][k].y, w, acc[k].y);
            acc[k].z = fmaf(x[i][k].z, w, acc[k].z);
            acc[k].w = fmaf(x[i][k].w, w, acc[k].w);
          }
        }
      }
    }
    d = fmaxf(d, 1e-30f);
    TO* o = out + rows.out(r) * Dv + 4 * j;
#pragma unroll
    for (int k = 0; k < EPT; ++k) {
      if (j + k * n_cg < C4) {
        store2(o + 4 * k * n_cg, acc[k].x / d, acc[k].y / d);
        store2(o + 4 * k * n_cg + 2, acc[k].z / d, acc[k].w / d);
      }
    }
  }
}

// The split-K fix-up's arrival, by every thread of a block that has
// written its split's partial and lse (CUTLASS's split-K semaphore
// pattern): the block meets, so that its threads' stores precede thread
// 0's release fence, and thread 0 counts the block in at *counter.
// Returns, to every thread, whether this block was the last of the S to
// arrive; that one's thread 0 fences again (acquire: every other block's
// partials, released before its count, are visible to the loads after
// the block's barrier) and resets the counter to 0, so the workspace is
// all zero after the launch and a CUDA-graph replay finds it as the
// capture did.
__device__ __forceinline__ bool arrive_last(int* counter, int S) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;" ::: "memory");
    const int seen = atomicAdd(counter, 1);
    last = seen == S - 1;
    if (last) {
      asm volatile("fence.acq_rel.gpu;" ::: "memory");
      *counter = 0;
    }
  }
  __syncthreads();
  return last != 0;
}

}  // namespace
