// Paged GQA attention for Hopper (sm_90a): the two kernels of the serving
// hot path, with a plain C interface loaded through ctypes
// (src/repro_torch/kernels/build.py builds this file, and
// src/repro_torch/kernels/decode_attention.py wraps it).
//
//   paged_attention_sweep      stage 1 of paged GQA attention: the Q query
//                              rows of the G q heads of one kv head over the
//                              pages of one split, online softmax in fp32,
//                              optional in-flight candidate fold; pools in
//                              the query dtype, or int8 with per-row fp32
//                              scales.  bf16 runs on the tensor cores, fp32
//                              on the CUDA cores.
//   paged_attention_occupancy  blocks per SM, dynamic shared memory and
//                              registers of one (head dim, dtype, pools)
//                              form at its widest block.
//   lse_merge                  stage 2: exact log-sum-exp merge of the
//                              splits, for a caller that holds partials;
//                              a split sweep given counters merges its
//                              own splits in its last block instead, on
//                              the same device code (lse_merge.cuh).
//
// They launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so that a refused launch is reported.
#include <math.h>

#include <climits>

#include "sweep_fragments.cuh"

namespace {

// The paged sweep is sweep_fragments.cuh's gqa_sweep_kernel over
// PagedKeys.  It replaces, from src/repro/kernels/decode_attention.py, in
// their bf16/fp32 and their int8 forms (scales (P, ps, Hkv, 1), _load_kv
// :94):
//   paged_decode_attention_pallas           (:1232, kernel :1067)
//   paged_decode_attention_pallas_partials  (:1154, kernel :1110)
//   paged_verify_attention_pallas           (:970,  kernel :781)
//   paged_verify_attention_pallas_partials  (:877,  kernel :825)
// What bounds it: latency.  A decode step reads every live pool byte once
// against G query rows (about 2 G FLOP per byte of bf16 k/v, far under the
// ~295 FLOP a byte where the tensor cores would bind), and at the engine's
// shapes the bytes take well under a microsecond: the time is the chain of
// loads, products and reductions one block waits through (the kernel's
// design: sweep_fragments.cuh).
//
// Where its cached keys are: key position p of batch row b is row
// block_tables[b, p / ps] * ps + p % ps of the pools (P pages of ps rows).
// A split is ppb consecutive table columns.  A page holding no valid key
// for any of the Q rows (the union of their ranges) is skipped, as the
// reference's any(valid) skips it, and its table entry is never read
// (columns past a request's length hold arbitrary ids); its keys weigh
// nothing (-inf), where a key masked for one row inside a page that runs
// is NEG_INF, as in the reference.
struct PagedKeys {
  const int* block_tables;     // (B, nb)
  const int* pos_arr;          // (B,)
  int P, ps, nb, ppb;

  __device__ __forceinline__ int pos(int b) const { return pos_arr[b]; }

  // a block's split: the union over the Q rows of their valid keys, [lo_u,
  // hi_u], widened to whole pages and cut to the split's: keys [kr0, kr1]
  struct Split {
    const int* table;          // batch row b's table row
    int P, ps, pos, verify, window;
    int kr0, kr1, hi_u, full_lo, full_hi, n_tiles;

    // a table id outside the pool inside the request's length stops the
    // kernel rather than drop its keys; ids past the length are never read
    __device__ __forceinline__ int row(int t, int r) const {
      const int kp = kr0 + t * SW_KEYS + r;
      if (kp > kr1) return -1;
      const int j = kp / ps;
      const int page = table[j];
      if (page < 0 || page >= P) __trap();
      return page * ps + kp - j * ps;
    }

    // keys past kr1 are not part of the sweep (-inf), keys outside a row's
    // valid range are masked (NEG_INF); a tile inside [full_lo, full_hi]
    // is valid for every row
    __device__ __forceinline__ void mask(int t, int lane, const int (&qi)[2],
                                         float (&s)[2][4]) const {
      const int k0 = kr0 + t * SW_KEYS;
      if (k0 >= full_lo && k0 + SW_KEYS - 1 <= full_hi) return;
      const int kb = k0 + 2 * (lane & 3);
      int lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hi[h] = hi_u - kb;
        lo[h] = window <= 0 ? INT_MIN / 2
                : (verify ? pos + qi[h] : pos) - window + 1 - kb;
      }
      mask_range(s, kr1 - kb, lo, hi);
    }
  };

  __device__ __forceinline__ Split split(int b, int s, int pos, int verify,
                                         int window, int i_last) const {
    Split x;
    x.table = block_tables + (long)b * nb;
    x.P = P;
    x.ps = ps;
    x.pos = pos;
    x.verify = verify;
    x.window = window;
    x.hi_u = verify ? pos - 1 : pos;
    const int lo_u = window > 0 ? max(pos - window + 1, 0) : 0;
    const int j0 = s * ppb, j1 = min(j0 + ppb, nb);
    x.kr0 = max(j0 * ps, lo_u / ps * ps);
    x.kr1 = min(j1 * ps, (x.hi_u / ps + 1) * ps) - 1;
    x.n_tiles = x.hi_u >= 0 && x.kr1 >= x.kr0
                ? (x.kr1 - x.kr0) / SW_KEYS + 1 : 0;
    x.full_lo = max(x.kr0, window <= 0 ? INT_MIN
                    : (verify ? pos + i_last : pos) - window + 1);
    x.full_hi = min(x.kr1, x.hi_u);
    return x;
  }

  int most_tiles() const { return (ppb * ps + SW_KEYS - 1) / SW_KEYS; }
};

// Replaces merge_kv_splits_pallas, src/repro/kernels/decode_attention.py:172
// (kernel _lse_merge_kernel :156).  Bound on the card: bytes (S fp32
// partial rows in, one row out, ~3 FLOP per byte), but at the engine's
// shapes (tens of KB) a launch of its own costs far more than its bytes:
// about 2 us in a CUDA-graph replay.  So the split sweeps merge their own
// splits in their last block (merge_tail, sweep_fragments.cuh) and no main
// path launches this kernel; it stays K2b's entry for a caller that
// already holds partials.  Design: merge_rows (lse_merge.cuh), one
// thread a group of MERGE_EPT float4 columns of a row, LM_THREADS threads
// a block.
constexpr int LM_THREADS = 128;

// (n, s, r) cells of partial (N, S, R, Dv) and lse (N, S, R); output row
// row0 + r of (N, R, Dv)
struct FlatRows {
  long row0;
  int R, S;
  __device__ __forceinline__ long cell(int r) const {      // split 0's
    const long row = row0 + r, n = row / R;
    return n * S * R + (row - n * R);
  }
  __device__ __forceinline__ long out(int r) const { return row0 + r; }
};

template <typename TO>
__global__ void __launch_bounds__(LM_THREADS)
lse_merge_kernel(const float* __restrict__ partial,
                 const float* __restrict__ lse, TO* __restrict__ out,
                 long rows, int rpb, int S, int R, int Dv) {
  const long row0 = (long)blockIdx.x * rpb;
  merge_rows(lse, partial, out, (int)min((long)rpb, rows - row0), R, S, Dv,
             FlatRows{row0, R, S});
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, candidates and out share it, and
// the pools when k_scale / v_scale are null).  With k_scale / v_scale
// (P, ps, Hkv, 1) fp32, the pools are int8.  head_dim 64, 120 or 128.
// verify = 0: decode (k_new / v_new unused).  n_splits == 1 writes out
// (B, Q, Hq, HD); otherwise partial (B, Hq, S, Q, HD) and lse (B, Hq, S,
// Q), and, with counters (int32, one a (batch, kv head, 16-row tile),
// all zero; zero again after the launch), also the merged out (B, Q, Hq,
// HD) in the query dtype.
extern "C" int paged_attention_sweep(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_new,
    const void* v_new, const void* block_tables, const void* pos, void* out,
    void* partial, void* lse, void* counters, int B, int Q, int Hq, int Hkv,
    int P, int ps, int nb, int head_dim, int n_splits, int ppb, int verify,
    int window, float logit_cap, float scale, int dtype, void* stream) {
  if (B < 1 || Q < 1 || Q > SW_MAX_Q || Hkv < 1 || Hq % Hkv || ps < 1
      || nb < 1 || n_splits < 1 || ppb < 1
      || (k_scale == nullptr) != (v_scale == nullptr)
      || (counters != nullptr && n_splits > 1 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  const SweepArgs a{q, k_pages, v_pages,
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale), k_new, v_new, out,
                    static_cast<float*>(partial), static_cast<float*>(lse),
                    static_cast<int*>(counters), B, Q, Hq, Hkv, n_splits,
                    verify, window, logit_cap, scale,
                    static_cast<cudaStream_t>(stream)};
  const PagedKeys keys{static_cast<const int*>(block_tables),
                       static_cast<const int*>(pos), P, ps, nb, ppb};
  return sweep_dtype<PagedKeys>(dtype, head_dim, k_scale != nullptr,
                                [&](auto form) {
                                  return decltype(form)::run(a, keys);
                                });
}

// info[3] = {blocks per SM, dynamic shared memory bytes, registers a
// thread} of the sweep's kernel for this form (int8 != 0: int8 pools), at
// its widest block
extern "C" int paged_attention_occupancy(int head_dim, int dtype, int int8,
                                         int* info) {
  return sweep_dtype<PagedKeys>(dtype, head_dim, int8 != 0, [&](auto form) {
    return decltype(form)::occupancy(info);
  });
}

// partial (N, S, R, Dv) fp32 + lse (N, S, R) fp32 -> out (N, R, Dv) in
// out_dtype (0 = float32, 1 = bfloat16); Dv a multiple of 4.
extern "C" int lse_merge(const void* partial, const void* lse, void* out,
                         int N, int S, int R, int Dv, int out_dtype,
                         void* stream) {
  if (N < 1 || S < 1 || R < 1 || Dv < 4 || Dv % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long rows = (long)N * R;
  // rows a block: a column group a thread
  const int rpb = max(1, LM_THREADS * MERGE_EPT / (Dv / 4 + MERGE_EPT - 1));
  const unsigned blocks = (unsigned)((rows + rpb - 1) / rpb);
  const float* pp = static_cast<const float*>(partial);
  const float* lp = static_cast<const float*>(lse);
  if (out_dtype == 1)
    lse_merge_kernel<__nv_bfloat16><<<blocks, LM_THREADS, 0, st>>>(
        pp, lp, static_cast<__nv_bfloat16*>(out), rows, rpb, S, R, Dv);
  else if (out_dtype == 0)
    lse_merge_kernel<float><<<blocks, LM_THREADS, 0, st>>>(
        pp, lp, static_cast<float*>(out), rows, rpb, S, R, Dv);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
