// Device code of the attention sweeps whose online-softmax state lives in
// the C fragments of mma.sync m16n8k16 (tensor_core.cuh), 16 rows a warp:
// the GQA sweep, whose keys are spread over the warps of a block, every
// warp holding the state of the same 16 rows, row tile against key tile,
// merged once, at the end, through shared memory -- one kernel template,
// gqa_sweep_kernel, which the paged sweep (paged_attention.cu) and the
// ring sweep (ring_attention.cu) instantiate with their own key addressing
// and masks; and the latent sweep (mla_attention.cu), whose warps each
// hold a slice of the value columns of their rows.  Both end a split
// launch in the same fused merge (merge_tail, on lse_merge.cuh).
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
#include <math.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"
#include "lse_merge.cuh"
#include "tensor_core.cuh"

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
    if (partial == nullptr) {
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
    if (partial == nullptr) {
      T* o = out + (((long)b * Q + i) * Hq + h) * HD + c;
      store2(o, a.x, a.y);
      store2(o + 2, a.z, a.w);
    } else {
      *reinterpret_cast<float4*>(
          partial + ((((long)b * Hq + h) * n_splits + s) * Q + i) * HD + c) = a;
    }
  }
  if (partial != nullptr) {
    for (int r = threadIdx.x; r < live; r += blockDim.x) {
      const int rr = row0 + r, i = rr / G, h = hk * G + rr - i * G;
      const float L = rml[2 * r + 1];
      lse[(((long)b * Hq + h) * n_splits + s) * Q + i] =
          L > 0.f ? rml[2 * r] + logf(fmaxf(L, 1e-30f)) : NEG_INF;
    }
  }
}

// The fused merge, a split-K fix-up: once a block of a split sweep has
// written its split's partial and lse, it arrives at the counter of its
// rows (arrive_last), and the last of their S blocks merges them into out
// (B, Q, Hq, DV) in the query dtype (merge_rows): every split read back
// through L2, its own included and in split order, so the bits do not
// depend on which block came last and equal lse_merge's of the same
// partials.  The block's live rows are (query, head) rows row0 + r = i G
// + g of kv head hk, head hk G + g; partial (B, Hq, S, Q, DV), lse (B,
// Hq, S, Q).  Every block of the split reaches this point, one with no
// key included (its partial 0, its lse NEG_INF).
struct TailRows {
  int row0, G, hk, b, Q, Hq, S;
  __device__ __forceinline__ long cell(int r) const {      // split 0's
    const int rr = row0 + r, i = rr / G;
    return ((long)b * Hq + hk * G + rr - i * G) * S * Q + i;
  }
  __device__ __forceinline__ long out(int r) const {
    const int rr = row0 + r, i = rr / G;
    return ((long)b * Q + i) * Hq + hk * G + rr - i * G;
  }
};

// EPT: float4 columns a thread merges at once (merge_rows).  The latent
// sweep's bf16 blocks of 16 rows take 4: their 512-wide rows, read by one
// block at an SM's L2 rate, then come in half the round trips (tools/
// merge_variants.py, latent EPT 2), at no cost in blocks an SM (their
// shared memory holds them to two); at 2 the 32-row and fp32 blocks keep
// theirs.
template <typename T, int DV, int EPT = MERGE_EPT>
__device__ __forceinline__ void merge_tail(int* counter,
                                           const float* partial,
                                           const float* lse, T* out,
                                           int live, int row0, int G, int hk,
                                           int b, int Q, int Hq, int S) {
  if (!arrive_last(counter, S)) return;
  // head dim 120's bf16 paged sweep keeps its code and registers (and its
  // 6.9 us verify at h2o's heads, against 9.6) only beside the smaller
  // tail of four splits' loads at once (tools/merge_variants.py, SPC 4)
  merge_rows<DV == 120 ? 4 : MERGE_SPC, EPT>(
      lse, partial, out, live, Q, S, DV, TailRows{row0, G, hk, b, Q, Hq, S});
}

// ---------------------------------------------------------------------------
// The GQA sweep over 16-key tiles: the paged sweep's and the ring sweep's
// kernel, their forms' sizing, launch and occupancy.
// ---------------------------------------------------------------------------

constexpr int SW_ROWS = FRAG_ROWS;    // (query, head) rows a block
constexpr int SW_KEYS = 16;           // keys a tile: one k16 step of p.v
constexpr int SW_MAX_Q = 128;         // query rows the wrappers take

// The shapes and shared memory of one (q dtype T, k/v storage TKV, head
// dim HD) form.  A block holds the q tile and, per warp, a ring of two
// stages (k and v tiles of 16 keys in T; for int8 rows also the int8 rows
// as copied and their scales) and, on the CUDA cores, a p tile; at the end
// each warp's area takes its fp32 slice of the merge.  A block has at most
// 8 warps, 4 on the CUDA cores (fp32 tiles are twice as wide).
template <typename T, typename TKV, int HD>
struct SweepForm {
  static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool INT8 = std::is_same<TKV, int8_t>::value;
  static_assert(std::is_same<TKV, T>::value || INT8, "k/v in T or int8");
  static_assert(HD % 8 == 0, "rows of whole n8 tiles");
  static constexpr int MAXW = TC ? 8 : 4;          // warps a block, at most
  static constexpr int DK = (HD + 15) / 16 * 16;   // q.k depth, k16 steps
  // row strides in T: on the tensor cores odd counts of 16-byte chunks
  // (conflict-free ldmatrix), q and k DK wide; on the CUDA cores HD + 4
  // floats, so that the 8 rows (or 4 keys) a warp reads at once fall on
  // distinct banks
  static constexpr int QLD = TC ? tc_ld(DK) : HD + 4;
  static constexpr int KLD = QLD;
  static constexpr int VLD = TC ? tc_ld(HD) : HD + 4;
  static constexpr int PLD = SW_KEYS + 4;          // the p tile's stride
  static constexpr int NO = HD / 8;                // n8 tiles of a row
  static constexpr int OLD = (HD + 31) / 32 * 32 + 8;   // a merge row
  // bytes of one stage: k and v tiles, int8 k and v rows, k and v scales
  static constexpr size_t TILE = SW_KEYS * (KLD + VLD) * sizeof(T);
  static constexpr size_t RAW = INT8 ? 2 * SW_KEYS * HD : 0;
  static constexpr size_t SCALES = INT8 ? 2 * SW_KEYS * sizeof(float) : 0;
  static constexpr size_t STAGE = TILE + RAW + SCALES;
  static constexpr size_t PTILE = TC ? 0 : SW_ROWS * PLD * sizeof(float);
  static constexpr size_t WORK = 2 * STAGE + PTILE;
  static constexpr size_t MERGE = SW_ROWS * OLD * sizeof(float);
  static constexpr size_t WARP = ((WORK > MERGE ? WORK : MERGE) + 15) / 16
                                 * 16;
  static constexpr size_t QTILE = (SW_ROWS * QLD * sizeof(T) + 15) / 16 * 16;
  // each warp's (m, l) of the block's rows, then the merged (M, L)
  static constexpr size_t ML = (MAXW + 1) * SW_ROWS * 2 * sizeof(float);
  static constexpr size_t smem(int nw) { return QTILE + ML + nw * WARP; }
};

// int8 byte k of w as a float, exactly, on the integer and fp32 adders
// (1.5 2^23 + x has x in its low mantissa bits) rather than the
// quarter-rate int-to-float conversion
__device__ __forceinline__ float int8_float(uint32_t w, int k) {
  const int x = static_cast<int8_t>(w >> (8 * k));
  return __int_as_float(0x4B400000 + x) - 12582912.f;
}

// 8 int8 values (one 8-byte load) into 8 elements of a T tile, exactly:
// an int8 value's float has at most 8 significant bits, so its bf16 is
// the float's upper half
__device__ __forceinline__ void widen8(const int8_t* src, __nv_bfloat16* dst) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  uint4 w;
  uint32_t* h = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = i < 2 ? v.x : v.y;
    h[i] = __byte_perm(__float_as_uint(int8_float(x, 2 * (i & 1))),
                       __float_as_uint(int8_float(x, 2 * (i & 1) + 1)),
                       0x7632);
  }
  *reinterpret_cast<uint4*>(dst) = w;
}

__device__ __forceinline__ void widen8(const int8_t* src, float* dst) {
  const uint2 v = *reinterpret_cast<const uint2*>(src);
  *reinterpret_cast<float4*>(dst) =
      make_float4(int8_float(v.x, 0), int8_float(v.x, 1),
                  int8_float(v.x, 2), int8_float(v.x, 3));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(int8_float(v.y, 0), int8_float(v.y, 1),
                  int8_float(v.y, 2), int8_float(v.y, 3));
}

// A tile's scores masked for the thread's two rows, by key index relative
// to kb, the thread's first key (element e of n8 tile n is key kb + 8 n +
// (e & 1)): keys past in_hi are not part of the sweep (-inf: they weigh
// nothing), keys outside [lo[h], hi[h]] are masked for row h (NEG_INF)
__device__ __forceinline__ void mask_range(float (&s)[2][4], int in_hi,
                                           const int (&lo)[2],
                                           const int (&hi)[2]) {
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kr = 8 * n + (e & 1), h = e >> 1;
      s[n][e] = kr > in_hi ? -INFINITY
                : kr >= lo[h] && kr <= hi[h] ? s[n][e] : NEG_INF;
    }
}

// The GQA sweep's kernel.  Keys is the layout of the cached keys and the
// arithmetic of their masks (PagedKeys in paged_attention.cu, RingKeys in
// ring_attention.cu), handed in by value:
//   int pos(int b)   the position of batch row b's first query;
//   Split split(b, s, pos, verify, window, i_last)   split s of batch row
//     b for a block whose last live query is i_last, with
//       int n_tiles                 its tiles of 16 cached keys,
//       int row(int t, int r)       the row, of the (rows, Hkv, HD) k/v
//                                   arrays and their (rows, Hkv) scales,
//                                   of key r of tile t, or -1 for a key
//                                   past the split's (never read),
//       void mask(t, lane, qi, s)   tile t's scores masked for the lane's
//                                   rows, queries qi[0] and qi[1];
//   int most_tiles()  the most tiles of cached keys a split can have.
// Design:
// - One block per (row tile, split, kv head, batch).  The G q heads and Q
//   query rows of a kv head are stacked into M = Q G rows (query i, head
//   g) = row i G + g, so each k/v row is read once per kv head, not G
//   times; a block takes 16 of them, one m16 tile (a block of two tiles
//   was slower at every shape the engine runs but G 7's split verify: its
//   chain grows with each tile); rows past M are zero q and never stored.
//   Each thread works out its rows' query indices once.
// - Keys across warps: the split's cached keys in tiles of 16, and the
//   in-flight candidates of a verify's last split in tiles of 16 more;
//   warp w takes tiles w, w + nw, ... (nw <= 8, no more warps than tiles),
//   each with its own online-softmax state in mma fragments, and the block
//   merges the warps' states once, at the end, with lse_merge's arithmetic
//   (merge_warps), or, where it has at most one tile, writes warp 0's
//   state straight out.  No block barrier a tile.  Candidate tiles past
//   the block's last query row are masked for all its rows, and skipped.
// - bf16 on the tensor cores: q.k^T of a 16-key tile is two n8 tiles over
//   DK / 16 k16 steps, p.v one k16 step over HD / 8 n8 tiles (mma.sync
//   m16n8k16, ldmatrix; .trans for v); the online softmax stays in the
//   score fragments (quad shuffles), and p enters p.v as two bf16 terms, hi
//   + lo (about 16 bits of p: one bf16 rounding parted the host-tier-on and
//   -off greedy streams, whose tier-off run recomputes evicted prefixes
//   through the paged sweep).  fp32 keeps the CUDA cores, in the same
//   fragment layout, p through a small shared tile.  The soft-cap applies
//   in the fragments, before the mask.
// - A cp.async ring of two stages a warp: the next tile's rows are found
//   and its k and v copies issued before this tile's products.
// - int8 rows (D + 4 bytes): copied as int8, widened exactly to T in
//   shared memory, the per-row scales applied outside the products, s =
//   (q . k) k_scale scale and p v_scale before p's split, so nothing is
//   rounded that the plain version does not round.  Rows of 120 bytes are
//   8-byte aligned only: 8-byte copies.
// - Head dim 120: 15 whole 16-byte copies a bf16 row, q.k over columns
//   120..127 of the q and k tiles zeroed once, p.v as 15 n8 tiles.
// - Split, with counters (one int a (batch, kv head, row tile), zero
//   before the launch): the merge K2b folded in (merge_tail).  The S
//   blocks of a row tile sit n_rt apart in blockIdx.x; the last to finish
//   merges their partials and writes out, and no second launch is needed.
template <typename T, typename TKV, int HD, typename Keys>
__global__ void __launch_bounds__(SweepForm<T, TKV, HD>::MAXW * 32)
gqa_sweep_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k_rows,
    const TKV* __restrict__ v_rows, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const Keys keys, T* __restrict__ out,
    float* __restrict__ partial, float* __restrict__ lse,
    int* __restrict__ counters, int Q, int Hq, int Hkv, int n_splits,
    int n_rt, int verify, int window, float logit_cap, float scale) {
  using F = SweepForm<T, TKV, HD>;
  constexpr int ROWS = SW_ROWS, KEYS = SW_KEYS;
  constexpr int QLD = F::QLD, KLD = F::KLD, VLD = F::VLD, NO = F::NO;
  constexpr int VN = 16 / sizeof(T);       // elements of a 16-byte copy
  constexpr int QCH = HD / VN;             // 16-byte copies of a T row
  constexpr unsigned FULL = 0xffffffffu;
  extern __shared__ __align__(16) unsigned char sw_smem[];
  T* qs = reinterpret_cast<T*>(sw_smem);
  float* ml = reinterpret_cast<float*>(sw_smem + F::QTILE);
  float* rml = ml + F::MAXW * ROWS * 2;
  unsigned char* warp0 = sw_smem + F::QTILE + F::ML;

  const int G = Hq / Hkv;
  const int s = blockIdx.x / n_rt, rt = blockIdx.x - s * n_rt;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int pos = keys.pos(b);                  // in flight during the q copies
  const int row0 = rt * ROWS;
  const int live = min(ROWS, Q * G - row0);     // rows backed by a q row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nw = blockDim.x >> 5;
  unsigned char* wbase = warp0 + warp * F::WARP;
  auto tile_k = [&](int sg) {
    return reinterpret_cast<T*>(wbase + sg * F::STAGE);
  };
  auto raw_k = [&](int sg) {
    return reinterpret_cast<int8_t*>(wbase + sg * F::STAGE + F::TILE);
  };
  auto scales = [&](int sg) {
    return reinterpret_cast<float*>(wbase + sg * F::STAGE + F::TILE
                                    + F::RAW);
  };

  // columns HD..DK-1 of the q tile and of the warp's k tiles: zero for
  // q.k's last k16 step (the copies never write them)
  if constexpr (F::TC && F::DK != HD) {
    constexpr int PAD = (F::DK - HD) / 8;
    for (int c = tid; c < ROWS * PAD; c += blockDim.x) {
      const int r = c / PAD;
      *reinterpret_cast<uint4*>(qs + r * QLD + HD + (c - r * PAD) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    for (int c = lane; c < 2 * KEYS * PAD; c += 32) {
      const int r = c / PAD, sg = r / KEYS;
      *reinterpret_cast<uint4*>(tile_k(sg) + (r - sg * KEYS) * KLD + HD
                                + (c - r * PAD) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the q tile: row r = (i, g), row0 + r = i G + g, at q[b, i, hk G + g]
  const long q_row = (long)Hq * HD;
  const T* qb = q + (long)b * Q * q_row + (long)hk * G * HD;
  for (int c = tid; c < ROWS * QCH; c += blockDim.x) {
    const int r = c / QCH, ch = c - r * QCH;
    const int rr = row0 + r, i = rr / G;
    const bool ok = r < live;
    cp_async16(qs + r * QLD + ch * VN,
               ok ? qb + i * q_row + (rr - i * G) * HD + ch * VN : q, ok);
  }
  cp_async_commit();

  // the split's tiles of cached keys, then candidate tiles: a verify's
  // last split, up to the block's last query
  const int i_last = (row0 + live - 1) / G;
  const typename Keys::Split ks = keys.split(b, s, pos, verify, window,
                                             i_last);
  const int n_pool = ks.n_tiles;
  const int n_cand = verify && s == n_splits - 1 ? i_last / KEYS + 1 : 0;
  const int n_items = n_pool + n_cand;

  // this thread's rows 8 h + lane / 4 are queries qi[h]
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qi[h] = (row0 + 8 * h + (lane >> 2)) / G;
  FragRows<NO, F::TC> st;
  st.init();

  // tile t's copies into stage sg, for this warp; tile t < n_pool holds
  // the split's cached keys, tile t - n_pool the candidates 16 (t -
  // n_pool) + r
  auto issue = [&](int t, int sg) {
    T* kt = tile_k(sg);
    T* vt = kt + KEYS * KLD;
    if (t < n_pool) {
      // lanes l and l + 16 find the row of key l
      const int grow = ks.row(t, lane & 15);
      if constexpr (F::INT8) {
        constexpr int RV = HD % 16 == 0 ? 16 : 8;    // bytes a copy
        constexpr int RCH = HD / RV;
        int8_t* kr = raw_k(sg);
        int8_t* vr = kr + KEYS * HD;
        for (int c0 = 0; c0 < KEYS * RCH; c0 += 32) {
          const int c = c0 + lane, r = min(c / RCH, KEYS - 1);
          const int g = __shfl_sync(FULL, grow, r);
          if (c < KEYS * RCH) {
            const int off = (c - r * RCH) * RV;
            const long src = ((long)g * Hkv + hk) * HD + off;
            const bool ok = g >= 0;
            if constexpr (RV == 16) {
              cp_async16(kr + r * HD + off, ok ? k_rows + src : k_rows, ok);
              cp_async16(vr + r * HD + off, ok ? v_rows + src : v_rows, ok);
            } else {
              cp_async8(kr + r * HD + off, ok ? k_rows + src : k_rows, ok);
              cp_async8(vr + r * HD + off, ok ? v_rows + src : v_rows, ok);
            }
          }
        }
        // lanes 0..15 the k scales of the 16 keys, 16..31 the v scales
        const int g = __shfl_sync(FULL, grow, lane & 15);
        const float* sc = lane < 16 ? k_scale : v_scale;
        cp_async4(scales(sg) + lane, g >= 0 ? sc + (long)g * Hkv + hk : sc,
                  g >= 0);
      } else {
        for (int c0 = 0; c0 < KEYS * QCH; c0 += 32) {
          const int c = c0 + lane, r = min(c / QCH, KEYS - 1);
          const int g = __shfl_sync(FULL, grow, r);
          if (c < KEYS * QCH) {
            const int off = (c - r * QCH) * VN;
            const long src = ((long)g * Hkv + hk) * HD + off;
            const bool ok = g >= 0;
            cp_async16(kt + r * KLD + off, ok ? k_rows + src : k_rows, ok);
            cp_async16(vt + r * VLD + off, ok ? v_rows + src : v_rows, ok);
          }
        }
      }
    } else {
      const int jc = (t - n_pool) * KEYS;
      for (int c = lane; c < KEYS * QCH; c += 32) {
        const int r = c / QCH, off = (c - r * QCH) * VN;
        const bool ok = jc + r < Q;
        const long src = (((long)b * Q + jc + r) * Hkv + hk) * HD + off;
        cp_async16(kt + r * KLD + off, ok ? k_new + src : k_new, ok);
        cp_async16(vt + r * VLD + off, ok ? v_new + src : v_new, ok);
      }
    }
  };

  // tile t's update from stage sg
  auto compute = [&](int t, int sg) {
    const bool pool = t < n_pool;
    T* kt = tile_k(sg);
    T* vt = kt + KEYS * KLD;
    const float* sc = scales(sg);
    if constexpr (F::INT8) {
      if (pool) {
        // the int8 rows widened into the k and v tiles, 8 values a lane
        // at a time, the loop unrolled so that its loads overlap
        constexpr int G8 = HD / 8, N8 = 2 * KEYS * G8;
        const int8_t* kr = raw_k(sg);
#pragma unroll
        for (int c0 = 0; c0 < N8; c0 += 32) {
          const int c = c0 + lane;
          if (N8 % 32 == 0 || c < N8) {
            const int rr = c / G8, off = (c - rr * G8) * 8;
            const bool isv = rr >= KEYS;
            const int r = isv ? rr - KEYS : rr;
            widen8(kr + rr * HD + off,
                   (isv ? vt + r * VLD : kt + r * KLD) + off);
          }
        }
        __syncwarp();
      }
    }
    float s_[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s_[n][0] = s_[n][1] = s_[n][2] = s_[n][3] = 0.f;
    if constexpr (F::TC) {
      // s = q . k^T over DK / 16 k16 steps
#pragma unroll
      for (int kk = 0; kk < F::DK / 16; ++kk) {
        uint32_t a[4], bk[4];
        ldmatrix_x4(a, qs + ((lane & 7) + (lane & 8)) * QLD + kk * 16
                           + (lane >> 4) * 8);
        ldmatrix_x4(bk, kt + ((lane & 7) + (lane >> 4) * 8) * KLD + kk * 16
                            + (lane & 8));
        mma_bf16_16816(s_[0], a, bk[0], bk[1]);
        mma_bf16_16816(s_[1], a, bk[2], bk[3]);
      }
    } else {
      // s = q . k^T in fp32 FMAs: this thread's 2 rows x 4 keys
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 kv[2][2];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            kv[n][e] = *reinterpret_cast<const float4*>(
                kt + (8 * n + 2 * (lane & 3) + e) * KLD + d);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 qv = *reinterpret_cast<const float4*>(
              qs + (8 * h + (lane >> 2)) * QLD + d);
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s_[n][2 * h + e];
              x = fmaf(qv.x, kv[n][e].x, x);
              x = fmaf(qv.y, kv[n][e].y, x);
              x = fmaf(qv.z, kv[n][e].z, x);
              x = fmaf(qv.w, kv[n][e].w, x);
            }
        }
      }
    }
    // scale (and k's per-row scale), soft-cap, then the mask
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s_[n][e];
        if constexpr (F::INT8) {
          if (pool) x *= sc[8 * n + (e & 1) + 2 * (lane & 3)];
        }
        x *= scale;
        if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
        s_[n][e] = x;
      }
    if (pool) {
      ks.mask(t, lane, qi, s_);
    } else {
      // candidate j sees query i for j <= i (and j > i - window), j < Q
      const int kb = (t - n_pool) * KEYS + 2 * (lane & 3);
      int lo[2], hi[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        hi[h] = qi[h] - kb;
        lo[h] = window <= 0 ? INT_MIN / 2 : qi[h] - window + 1 - kb;
      }
      mask_range(s_, Q - 1 - kb, lo, hi);
    }
    st.update(s_);
    if constexpr (F::INT8) {
      if (pool) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s_[n][e] *= sc[KEYS + 8 * n + 2 * (lane & 3) + (e & 1)];
      }
    }
    if constexpr (F::TC) {
      // o += p . v, p as hi + lo bf16 A fragments straight from the score
      // registers; each v fragment feeds hi and lo
      uint32_t a[2][4];
      split_bf16(s_[0][0], s_[0][1], a[0][0], a[1][0]);
      split_bf16(s_[0][2], s_[0][3], a[0][1], a[1][1]);
      split_bf16(s_[1][0], s_[1][1], a[0][2], a[1][2]);
      split_bf16(s_[1][2], s_[1][3], a[0][3], a[1][3]);
      const T* vrow = vt + ((lane & 7) + (lane & 8)) * VLD;
#pragma unroll
      for (int nn = 0; nn < NO / 2; ++nn) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vrow + nn * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          mma_bf16_16816(st.o[2 * nn], a[x], bv[0], bv[1]);
          mma_bf16_16816(st.o[2 * nn + 1], a[x], bv[2], bv[3]);
        }
      }
      if constexpr (NO % 2) {
        uint32_t bv[2];
        ldmatrix_x2_trans(bv, vrow + (NO - 1) * 8);
#pragma unroll
        for (int x = 0; x < 2; ++x)
          mma_bf16_16816(st.o[NO - 1], a[x], bv[0], bv[1]);
      }
    } else {
      // o += p . v in fp32 FMAs, p through the warp's p tile
      float* pt = reinterpret_cast<float*>(wbase + 2 * F::STAGE);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          *reinterpret_cast<float2*>(pt + (8 * h + (lane >> 2)) * F::PLD
                                     + 8 * n + 2 * (lane & 3)) =
              make_float2(s_[n][2 * h], s_[n][2 * h + 1]);
      __syncwarp();
#pragma unroll 2
      for (int kk = 0; kk < KEYS; ++kk) {
        float pr[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          pr[h] = pt[(8 * h + (lane >> 2)) * F::PLD + kk];
        const T* vk = vt + kk * VLD + 2 * (lane & 3);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          const float2 v2 = *reinterpret_cast<const float2*>(vk + 8 * n);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            st.o[n][2 * h] = fmaf(pr[h], v2.x, st.o[n][2 * h]);
            st.o[n][2 * h + 1] = fmaf(pr[h], v2.y, st.o[n][2 * h + 1]);
          }
        }
      }
    }
  };

  // this warp's tiles t = warp, warp + nw, ...: the first one's copies
  // join the q tile's, then each tile's copies are issued a tile ahead
  if (warp < n_items) issue(warp, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();            // the q tile and every first tile have landed
  int sg = 0;
  for (int t = warp; t < n_items; t += nw, sg ^= 1) {
    if (t + nw < n_items) issue(t + nw, sg ^ 1);
    cp_async_commit();
    cp_async_wait<1>();       // tile t has landed for this lane
    __syncwarp();             // ... and for the warp
    compute(t, sg);
    __syncwarp();             // stage sg is free for tile t + 2 nw
  }
  cp_async_wait<0>();
  if (n_items <= 1) {
    // one warp holds the block's only state: no merge
    if (warp == 0)
      write_state<T, HD>(st, live, row0, G, Q, b, hk, s, Hq, n_splits, out,
                         partial, lse);
  } else {
    merge_warps<NO, F::OLD>(st, ml, rml, reinterpret_cast<float*>(wbase));
    write_rows<T, HD, F::OLD, (int)(F::WARP / sizeof(float))>(
        reinterpret_cast<const float*>(warp0), rml, live, row0, G, Q, b, hk,
        s, Hq, n_splits, out, partial, lse);
  }
  if (n_splits > 1 && counters != nullptr)
    merge_tail<T, HD>(counters + ((long)b * Hkv + hk) * n_rt + rt, partial,
                      lse, out, live, row0, G, hk, b, Q, Hq, n_splits);
}

// The arguments of a GQA sweep's launch that do not depend on its keys'
// layout: q (B, Q, Hq, HD); the k and v rows and their scales (null unless
// int8); the candidates (B, Q, Hkv, HD) of a verify; the outputs; the
// fused merge's counters (null: a split launch writes its partials only).
struct SweepArgs {
  const void *q, *k, *v;
  const float *ksc, *vsc;
  const void *kn, *vn;
  void* out;
  float *partial, *lse;
  int* counters;
  int B, Q, Hq, Hkv, n_splits, verify, window;
  float logit_cap, scale;
  cudaStream_t stream;
};

// One form's kernel: its launch and its occupancy
template <typename T, typename TKV, int HD, typename Keys>
struct GqaSweep {
  using F = SweepForm<T, TKV, HD>;
  static_assert(F::smem(F::MAXW) <= 232448, "a Hopper block's shared memory");
  static auto kernel() { return gqa_sweep_kernel<T, TKV, HD, Keys>; }

  // opt the kernel into its widest block's dynamic shared memory, once,
  // so that a launch inside a CUDA-graph capture makes no attribute call;
  // a refusal is returned, never worked around
  static cudaError_t opt_in() {
    static bool done = false;
    if (done) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)F::smem(F::MAXW));
    done = e == cudaSuccess;
    return e;
  }

  static int run(const SweepArgs& a, const Keys& keys) {
    const cudaError_t e = opt_in();
    if (e != cudaSuccess) return (int)e;
    // no more warps than the tiles a split can hold: its cached keys and a
    // verify's candidates
    const int most = keys.most_tiles()
                     + (a.verify ? (a.Q + SW_KEYS - 1) / SW_KEYS : 0);
    const int nw = max(1, min(F::MAXW, most));
    const int n_rt = (a.Q * (a.Hq / a.Hkv) + SW_ROWS - 1) / SW_ROWS;
    const dim3 grid(n_rt * a.n_splits, a.Hkv, a.B);
    kernel()<<<grid, 32 * nw, F::smem(nw), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const TKV*>(a.k),
        static_cast<const TKV*>(a.v), a.ksc, a.vsc,
        static_cast<const T*>(a.kn), static_cast<const T*>(a.vn), keys,
        static_cast<T*>(a.out), a.partial, a.lse, a.counters, a.Q, a.Hq,
        a.Hkv, a.n_splits, n_rt, a.verify, a.window, a.logit_cap, a.scale);
    return (int)cudaGetLastError();
  }

  // info = {blocks per SM, dynamic shared memory bytes, registers a
  // thread}, at the widest block
  static int occupancy(int* info) {
    cudaError_t e = opt_in();
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &info[0], kernel(), 32 * F::MAXW, F::smem(F::MAXW));
    info[1] = (int)F::smem(F::MAXW);
    info[2] = e == cudaSuccess ? attr.numRegs : 0;
    return (int)e;
  }
};

// op(GqaSweep<T, TKV, HD, Keys>()) for dtype 0 (T float) or 1 (bf16) and
// the head dims built, 64 (smollm), 120 (h2o-danube) and 128, k/v in T or
// int8; else invalid-value
template <typename Keys, typename T, typename Op>
int sweep_form(int head_dim, bool int8, Op&& op) {
  switch (head_dim) {
    case 64:
      return int8 ? op(GqaSweep<T, int8_t, 64, Keys>())
                  : op(GqaSweep<T, T, 64, Keys>());
    case 120:
      return int8 ? op(GqaSweep<T, int8_t, 120, Keys>())
                  : op(GqaSweep<T, T, 120, Keys>());
    case 128:
      return int8 ? op(GqaSweep<T, int8_t, 128, Keys>())
                  : op(GqaSweep<T, T, 128, Keys>());
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename Keys, typename Op>
int sweep_dtype(int dtype, int head_dim, bool int8, Op&& op) {
  if (dtype == 1) return sweep_form<Keys, __nv_bfloat16>(head_dim, int8, op);
  if (dtype == 0) return sweep_form<Keys, float>(head_dim, int8, op);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
