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
//                              splits.
//
// They launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so that a refused launch is reported.
#include <math.h>

#include <climits>
#include <cstdint>
#include <type_traits>

#include "attention_common.cuh"
#include "sweep_fragments.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int SW_ROWS = FRAG_ROWS;    // (query, head) rows a block
constexpr int SW_KEYS = 16;           // keys a tile: one k16 step of p.v
constexpr int SW_MAX_Q = 128;         // query rows the wrapper takes

// The shapes and shared memory of one (q dtype T, pool storage TKV, head
// dim HD) form.  A block holds the q tile and, per warp, a ring of two
// stages (k and v tiles of 16 keys in T; for int8 pools also the int8 rows
// as copied and their scales) and, on the CUDA cores, a p tile; at the end
// each warp's area takes its fp32 slice of the merge.  A block has at most
// 8 warps, 4 on the CUDA cores (fp32 tiles are twice as wide).
template <typename T, typename TKV, int HD>
struct SweepForm {
  static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value;
  static constexpr bool INT8 = std::is_same<TKV, int8_t>::value;
  static_assert(std::is_same<TKV, T>::value || INT8, "pools in T or int8");
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

// Replaces, from src/repro/kernels/decode_attention.py, in their bf16/fp32
// and their int8 forms (scales (P, ps, Hkv, 1), _load_kv :94):
//   paged_decode_attention_pallas           (:1232, kernel :1067)
//   paged_decode_attention_pallas_partials  (:1154, kernel :1110)
//   paged_verify_attention_pallas           (:970,  kernel :781)
//   paged_verify_attention_pallas_partials  (:877,  kernel :825)
// What bounds it: latency.  A decode step reads every live pool byte once
// against G query rows (about 2 G FLOP per byte of bf16 k/v, far under the
// ~295 FLOP a byte where the tensor cores would bind), and at the engine's
// shapes the bytes take well under a microsecond: the time is the chain of
// loads, products and reductions one block waits through.  Design:
// - One block per (row tile, split, kv head, batch).  The G q heads and Q
//   query rows of a kv head are stacked into M = Q G rows (query i, head
//   g) = row i G + g, so each page is read once per kv head, not G times;
//   a block takes 16 of them, one m16 tile (a block of two tiles was
//   slower at every shape the engine runs but G 7's split verify: its
//   chain grows with each tile); rows past M are zero q and never stored.
//   Each thread works out its rows' query indices once.
// - Keys across warps: the split's valid key range is cut into tiles of 16
//   consecutive positions (a tile may span pages of 8 keys, or take one of
//   two of a page of 32), and the in-flight candidates of a verify's last
//   split into tiles of 16 more; warp w takes tiles w, w + nw, ... (nw <= 8,
//   no more warps than tiles), each with its own online-softmax state in
//   mma fragments, and the block merges the warps' states once, at the end,
//   with lse_merge's arithmetic (sweep_fragments.cuh), or, where it has at
//   most one tile, writes warp 0's state straight out.  No block barrier a
//   tile.
// - Which keys: a page holding no valid key for any of the Q rows (the
//   union of their ranges) is skipped, as the reference's any(valid) skips
//   it, and its table entry is never read (columns past a request's length
//   hold arbitrary ids); its keys weigh nothing (-inf), where a key masked
//   for one row inside a page that runs is NEG_INF, as in the reference.
//   A table id outside the pool inside the request's length stops the
//   kernel (__trap) rather than drop its keys.  Candidate tiles past the
//   block's last query row are masked for all its rows, and skipped.  A
//   tile valid for every row skips the mask.
// - bf16 on the tensor cores: q.k^T of a 16-key tile is two n8 tiles over
//   DK / 16 k16 steps, p.v one k16 step over HD / 8 n8 tiles (mma.sync
//   m16n8k16, ldmatrix; .trans for v); the online softmax stays in the
//   score fragments (quad shuffles), and p enters p.v as two bf16 terms, hi
//   + lo (about 16 bits of p: one bf16 rounding parted the host-tier-on and
//   -off greedy streams, whose tier-off run recomputes evicted prefixes
//   through this sweep).  fp32 keeps the CUDA cores, in the same fragment
//   layout, p through a small shared tile.
// - A cp.async ring of two stages a warp: the next tile's table entries
//   are read and its k and v copies issued before this tile's products.
// - int8 pools (a row D + 4 bytes): the rows are copied as int8, widened
//   exactly to T in shared memory, and the per-row scales are applied
//   outside the products, s = (q . k) k_scale scale and p v_scale before
//   p's split, so nothing is rounded that the plain version does not
//   round.  Rows of 120 bytes are 8-byte aligned only: 8-byte copies.
// - Head dim 120: 15 whole 16-byte copies a bf16 row, q.k over columns
//   120..127 of the q and k tiles zeroed once, p.v as 15 n8 tiles.
template <typename T, typename TKV, int HD>
__global__ void __launch_bounds__(SweepForm<T, TKV, HD>::MAXW * 32)
paged_attention_sweep_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k_pages,
    const TKV* __restrict__ v_pages, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const int* __restrict__ block_tables,
    const int* __restrict__ pos_arr, T* __restrict__ out,
    float* __restrict__ partial, float* __restrict__ lse, int Q, int Hq,
    int Hkv, int P, int ps, int nb, int n_splits, int ppb, int n_rt,
    int verify, int window, float logit_cap, float scale) {
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
  const int pos = pos_arr[b];                   // in flight during the q copies
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

  // the union over the Q rows of their valid keys, [lo_u, hi_u], widened
  // to whole pages and cut to this split's: keys [kr0, kr1]
  const int hi_u = verify ? pos - 1 : pos;
  const int lo_u = window > 0 ? max(pos - window + 1, 0) : 0;
  const int j0 = s * ppb, j1 = min(j0 + ppb, nb);
  const int kr0 = max(j0 * ps, lo_u / ps * ps);
  const int kr1 = min(j1 * ps, (hi_u / ps + 1) * ps) - 1;
  const int n_pool = hi_u >= 0 && kr1 >= kr0 ? (kr1 - kr0) / KEYS + 1 : 0;
  // candidate tiles: a verify's last split, up to the block's last query
  const int i_last = (row0 + live - 1) / G;
  const int n_cand = verify && s == n_splits - 1 ? i_last / KEYS + 1 : 0;
  const int n_items = n_pool + n_cand;
  // a pool tile inside [full_lo, full_hi] is valid for every row
  const int full_lo = max(kr0, window <= 0 ? INT_MIN
                          : (verify ? pos + i_last : pos) - window + 1);
  const int full_hi = min(kr1, hi_u);

  // this thread's rows 8 h + lane / 4 are queries qi[h]
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) qi[h] = (row0 + 8 * h + (lane >> 2)) / G;
  FragRows<NO, F::TC> st;
  st.init();

  // tile t's copies into stage sg, for this warp; pool tile t holds keys
  // kr0 + 16 t + r, candidate tile t - n_pool the candidates 16 (t -
  // n_pool) + r
  auto issue = [&](int t, int sg) {
    T* kt = tile_k(sg);
    T* vt = kt + KEYS * KLD;
    if (t < n_pool) {
      // lanes l and l + 16 find the pool row of key kr0 + 16 t + l
      int grow = -1;
      const int kp = kr0 + t * KEYS + (lane & 15);
      if (kp <= kr1) {
        const int j = kp / ps;
        const int page = block_tables[(long)b * nb + j];
        if (page < 0 || page >= P) __trap();
        grow = page * ps + kp - j * ps;
      }
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
              cp_async16(kr + r * HD + off, ok ? k_pages + src : k_pages, ok);
              cp_async16(vr + r * HD + off, ok ? v_pages + src : v_pages, ok);
            } else {
              cp_async8(kr + r * HD + off, ok ? k_pages + src : k_pages, ok);
              cp_async8(vr + r * HD + off, ok ? v_pages + src : v_pages, ok);
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
            cp_async16(kt + r * KLD + off, ok ? k_pages + src : k_pages, ok);
            cp_async16(vt + r * VLD + off, ok ? v_pages + src : v_pages, ok);
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
    // scale (and k's per-row scale), soft-cap, mask: element e of n8 tile
    // n is key kb + 8 n + (e & 1), kb this thread's first; keys outside
    // [in_lo, in_hi] are not part of the sweep (-inf), keys outside a
    // row's valid range [lo, hi] are masked (NEG_INF)
    const int k0 = pool ? kr0 + t * KEYS : (t - n_pool) * KEYS;
    const bool full = pool && k0 >= full_lo && k0 + KEYS - 1 <= full_hi;
    const int kb = k0 + 2 * (lane & 3);
    const int in_lo = (pool ? kr0 : 0) - kb;
    const int in_hi = (pool ? kr1 : Q - 1) - kb;
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int top = pool ? hi_u : qi[h];
      const int low = window <= 0 ? INT_MIN / 2
                      : pool ? (verify ? pos + qi[h] : pos) - window + 1
                             : qi[h] - window + 1;
      hi[h] = top - kb;
      lo[h] = low - kb;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = 8 * n + (e & 1), h = e >> 1;
        float x = s_[n][e];
        if constexpr (F::INT8) {
          if (pool) x *= sc[kr + 2 * (lane & 3)];
        }
        x *= scale;
        if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
        s_[n][e] = full ? x
                   : kr < in_lo || kr > in_hi ? -INFINITY
                   : kr >= lo[h] && kr <= hi[h] ? x : NEG_INF;
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
    return;
  }
  merge_warps<NO, F::OLD>(st, ml, rml, reinterpret_cast<float*>(wbase));
  write_rows<T, HD, F::OLD, (int)(F::WARP / sizeof(float))>(
      reinterpret_cast<const float*>(warp0), rml, live, row0, G, Q, b, hk, s,
      Hq, n_splits, out, partial, lse);
}

// Replaces merge_kv_splits_pallas, src/repro/kernels/decode_attention.py:172
// (kernel _lse_merge_kernel :156).  Bound on the card: bytes (S fp32
// partial rows in, one row out, ~3 FLOP per byte).  Design: one block per
// output row, one thread per output element; each thread re-derives the
// row's max and denominator from the S log-sum-exps (S <= 16, all in L1),
// so no shared memory or barrier is needed.
template <typename TO>
__global__ void lse_merge_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ lse,
                                 TO* __restrict__ out, int S, int R, int Dv) {
  const long row = blockIdx.x;              // n * R + r
  const long n = row / R;
  const int r = (int)(row - n * R);
  const float* lp = lse + n * S * R + r;
  float m = lp[0];
  for (int s = 1; s < S; ++s) m = fmaxf(m, lp[(long)s * R]);
  float den = 0.f;
  for (int s = 0; s < S; ++s) den += expf(lp[(long)s * R] - m);
  den = fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < Dv; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc += partial[((n * S + s) * R + r) * Dv + d] *
             expf(lp[(long)s * R] - m);
    store(out + row * Dv + d, acc / den);
  }
}

struct SweepArgs {
  const void *q, *kp, *vp;
  const float *ksc, *vsc;
  const void *kn, *vn;
  const int *bt, *pos;
  void* out;
  float *partial, *lse;
  int B, Q, Hq, Hkv, P, ps, nb, n_splits, ppb, verify, window;
  float logit_cap, scale;
  cudaStream_t stream;
};

// One form's kernel: its launch and its occupancy
template <typename T, typename TKV, int HD>
struct Sweep {
  using F = SweepForm<T, TKV, HD>;
  static_assert(F::smem(F::MAXW) <= 232448, "a Hopper block's shared memory");
  static auto kernel() { return paged_attention_sweep_kernel<T, TKV, HD>; }

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

  static int run(const SweepArgs& a) {
    const cudaError_t e = opt_in();
    if (e != cudaSuccess) return (int)e;
    // no more warps than the key tiles a split can hold: its pages' keys
    // and a verify's candidates
    const int most = (a.ppb * a.ps + SW_KEYS - 1) / SW_KEYS
                     + (a.verify ? (a.Q + SW_KEYS - 1) / SW_KEYS : 0);
    const int nw = max(1, min(F::MAXW, most));
    const int n_rt = (a.Q * (a.Hq / a.Hkv) + SW_ROWS - 1) / SW_ROWS;
    const dim3 grid(n_rt * a.n_splits, a.Hkv, a.B);
    auto kern = kernel();
    kern<<<grid, 32 * nw, F::smem(nw), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const TKV*>(a.kp),
        static_cast<const TKV*>(a.vp), a.ksc, a.vsc,
        static_cast<const T*>(a.kn), static_cast<const T*>(a.vn), a.bt,
        a.pos, static_cast<T*>(a.out), a.partial, a.lse, a.Q, a.Hq, a.Hkv,
        a.P, a.ps, a.nb, a.n_splits, a.ppb, n_rt, a.verify, a.window,
        a.logit_cap, a.scale);
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

// op(Sweep<T, TKV, HD>()) for the head dims built, 64 (smollm), 120
// (h2o-danube) and 128, pools in T or int8; else invalid-value
template <typename T, typename Op>
int sweep_form(int head_dim, bool int8, Op&& op) {
  switch (head_dim) {
    case 64:
      return int8 ? op(Sweep<T, int8_t, 64>()) : op(Sweep<T, T, 64>());
    case 120:
      return int8 ? op(Sweep<T, int8_t, 120>()) : op(Sweep<T, T, 120>());
    case 128:
      return int8 ? op(Sweep<T, int8_t, 128>()) : op(Sweep<T, T, 128>());
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename Op>
int sweep_dtype(int dtype, int head_dim, bool int8, Op&& op) {
  if (dtype == 1) return sweep_form<__nv_bfloat16>(head_dim, int8, op);
  if (dtype == 0) return sweep_form<float>(head_dim, int8, op);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, candidates and out share it, and
// the pools when k_scale / v_scale are null).  With k_scale / v_scale
// (P, ps, Hkv, 1) fp32, the pools are int8.  head_dim 64, 120 or 128.
// verify = 0: decode (k_new / v_new unused).  n_splits == 1 writes out
// (B, Q, Hq, HD); otherwise partial (B, Hq, S, Q, HD) and lse (B, Hq, S,
// Q).
extern "C" int paged_attention_sweep(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* k_new,
    const void* v_new, const void* block_tables, const void* pos, void* out,
    void* partial, void* lse, int B, int Q, int Hq, int Hkv, int P, int ps,
    int nb, int head_dim, int n_splits, int ppb, int verify, int window,
    float logit_cap, float scale, int dtype, void* stream) {
  if (B < 1 || Q < 1 || Q > SW_MAX_Q || Hkv < 1 || Hq % Hkv || ps < 1
      || nb < 1 || n_splits < 1 || ppb < 1
      || (k_scale == nullptr) != (v_scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const SweepArgs a{q, k_pages, v_pages,
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale), k_new, v_new,
                    static_cast<const int*>(block_tables),
                    static_cast<const int*>(pos), out,
                    static_cast<float*>(partial), static_cast<float*>(lse),
                    B, Q, Hq, Hkv, P, ps, nb, n_splits, ppb, verify, window,
                    logit_cap, scale, static_cast<cudaStream_t>(stream)};
  return sweep_dtype(dtype, head_dim, k_scale != nullptr,
                     [&](auto form) { return decltype(form)::run(a); });
}

// info[3] = {blocks per SM, dynamic shared memory bytes, registers a
// thread} of the sweep's kernel for this form (int8 != 0: int8 pools), at
// its widest block
extern "C" int paged_attention_occupancy(int head_dim, int dtype, int int8,
                                         int* info) {
  return sweep_dtype(dtype, head_dim, int8 != 0, [&](auto form) {
    return decltype(form)::occupancy(info);
  });
}

// partial (N, S, R, Dv) fp32 + lse (N, S, R) fp32 -> out (N, R, Dv) in
// out_dtype (0 = float32, 1 = bfloat16).
extern "C" int lse_merge(const void* partial, const void* lse, void* out,
                         int N, int S, int R, int Dv, int out_dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = Dv < 256 ? ((Dv + 31) / 32) * 32 : 256;
  const float* pp = static_cast<const float*>(partial);
  const float* lp = static_cast<const float*>(lse);
  if (out_dtype == 1)
    lse_merge_kernel<__nv_bfloat16><<<N * R, threads, 0, st>>>(
        pp, lp, static_cast<__nv_bfloat16*>(out), S, R, Dv);
  else if (out_dtype == 0)
    lse_merge_kernel<float><<<N * R, threads, 0, st>>>(
        pp, lp, static_cast<float*>(out), S, R, Dv);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
