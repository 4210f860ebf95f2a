// The backward of prefill flash attention (K4) for Hopper (sm_90a), with a
// plain C interface loaded through ctypes (src/repro_torch/kernels/build.py
// builds it into the port's kernel library,
// src/repro_torch/kernels/flash_attention.py wraps it in the autograd
// function of K4).
//
//   flash_attention_bwd  dq, dk, dv of attention from q (B, Sq, Hq, D), k
//                        (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv), the forward's
//                        out (B, Sq, Hq, Dv) and lse (B, Hq, Sq) fp32
//                        (flash_attention_fwd) and dout; the gradients
//                        in q's dtype.  Causal, sliding window, tanh
//                        soft-cap, any query scale, q_offset, GQA; (D, Dv)
//                        as the forward's.
//
// FlashAttention-2's backward, in three launches on the caller's stream:
//   1. delta = rowsum(dout * out) in fp32 into a workspace (for the Hopper
//      kernels packed by q tile beside a copy of lse);
//   2. one block per (batch, kv head, tile of 64 keys) sweeps the q tiles
//      that can see its keys, all G q heads of the kv head in one tile (row
//      i * G + g, as the forward), recomputes p = exp(x - lse) and
//      accumulates dv += p^T dout and dk += ds^T q in fp32, with ds = p (dp
//      - delta) (dp = dout v^T), times 1 - tanh^2 under the soft-cap, times
//      the scale; the G heads' sums meet in the block, so no atomics;
//   3. one block per (batch, kv head, q tile) sweeps the key tiles the tile
//      can see and accumulates dq += ds k in fp32.
// No float atomics: every sum runs in a fixed order, the same bits from
// run to run.  bf16 at (64, 64), (120, 120) and (128, 128) runs 2 and 3
// as Hopper kernels (wgmma, TMA copies through an mbarrier ring fed by a
// producer warp, the mask only on the tiles it cuts; below, "the Hopper
// kernels"); bf16 (192, 128) keeps the mma.sync m16n8k16 kernels (the
// forward kernel's fragments), a compile-time choice: at D 192 a
// warpgroup's 96 dk accumulators a thread beside dv's 64 and the scores'
// leave no room; fp32 runs on the CUDA cores in full fp32 (the fp32
// tiles widened in shared memory).
//
// Bound on the card: bytes at smollm's 8 x 512 (q, k, v, out, dout and lse
// read, dq, dk, dv written: 7.56 us on an H100 SXM), against 2.5 times the
// forward's products.  What the Hopper design does about it: products on
// the tensor cores at their full width (wgmma m64n64k16 and m64n32k16,
// p^T and ds^T fed from registers, k and v as register fragments at D
// 64), loads issued by one thread ahead of the products, no per-element
// mask or division on the tiles the band wholly covers.  Occupancy, as
// phase 1 of chip_smoke.py reads it (flash_attention.bwd_occupancy;
// NVIDIA H100 80GB HBM3):
//   dk / dv  grid ceil(Sk / 64) Hkv B blocks of 160 threads, key tile 0
//            first; 85,544 B of shared memory at D 64 (101,672 at D 120
//            and 128); 240 registers a thread at D 64 (205 at D 120 and
//            128), one block an SM;
//   dq       grid ceil(Sq / bq) (QT / 64) Hkv B blocks of 160 threads,
//            the last q tile first; 67,624 B at D 64 (100,392 at D 120
//            and 128); 167 registers (168), two blocks an SM.
// smollm's 8 x 512 at G 3: 192 dk / dv blocks walking up to 13 q tiles
// of 126 rows, 624 dq blocks walking up to 8 key tiles.
//
// It allocates nothing (the wrapper passes delta's workspace) and returns
// cudaGetLastError() so that a refused launch is reported.
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "attention_common.cuh"
#include "hopper.cuh"
#include "tensor_core.cuh"

namespace {

constexpr int BW_NT = 256;           // threads a block: 16 x 16
constexpr int BW_BQ = 64;            // (q position, q head) rows a q tile
constexpr int BW_BK = 64;            // keys a k/v tile
constexpr int BW_RPT = BW_BQ / 16;   // q rows a thread in the score tile
constexpr int BW_KPT = BW_BK / 16;   // keys a thread in the score tile
constexpr int BW_PLD = BW_BK + 1;    // p / ds tile row stride

// shared memory: q, dout, k and v tiles (odd row strides), p and ds tiles,
// lse and delta of the q rows
template <int HD, int HDV>
constexpr size_t bw_smem_bytes() {
  return sizeof(float)
         * ((size_t)BW_BQ * (HD + 1) + (size_t)BW_BQ * (HDV + 1)
            + (size_t)BW_BK * (HD + 1) + (size_t)BW_BK * (HDV + 1)
            + 2 * (size_t)BW_BQ * BW_PLD + 2 * (size_t)BW_BQ);
}
// (192, 128): 198,656 bytes of the 232,448 a Hopper block may opt into
static_assert(bw_smem_bytes<192, 128>() <= 232448, "K4 backward smem");

struct BwArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, Hq, Hkv, D, Dv, bq, causal, window, q_offset;
  float logit_cap, scale;
  cudaStream_t stream;
};

// rows of 16-byte loads widened to fp32 into a shared tile of stride ld;
// rows past n are zero
template <typename T, int W>
__device__ __forceinline__ void tile_rows(float* dst, int ld, int rows,
                                          int n, const T* base,
                                          long stride) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER = W / VN;
  for (int c = threadIdx.x; c < rows * PER; c += BW_NT) {
    const int r = c / PER, col = (c - r * PER) * VN;
    float x[VN];
    if (r < n) {
      load16(base + r * stride + col, x);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) dst[r * ld + col + j] = x[j];
  }
}

// a q-side tile (q or dout, W columns) of rows r = i * G + g < live:
// position q0 + i, head hk * G + g
template <typename T, int W>
__device__ __forceinline__ void tile_q(float* dst, const T* src, int b,
                                       int q0, int hk, int G, int live,
                                       int Sq, int Hq) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER = W / VN;
  const long row = (long)Hq * W;
  for (int c = threadIdx.x; c < BW_BQ * PER; c += BW_NT) {
    const int r = c / PER, col = (c - r * PER) * VN;
    float x[VN];
    if (r < live) {
      const int i = r / G, g = r - (r / G) * G;
      load16(src + ((long)b * Sq + q0 + i) * row + (long)(hk * G + g) * W
             + col, x);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) dst[r * (W + 1) + col + j] = x[j];
  }
}

// the scores of the q tile against the k tile, turned into p and ds in
// shared memory: thread (rg, cg) takes rows rg + 16 j, keys cg + 16 jj.
// Rows past live and keys past nk get p = ds = 0.
template <int HD, int HDV>
__device__ __forceinline__ void scores_to_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lses, const float* dels, float* ps, float* dss, int live,
    int nk, int k0, int qpos0, int G, int causal, int window,
    float logit_cap, float scale) {
  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float s[BW_RPT][BW_KPT], dp[BW_RPT][BW_KPT];
#pragma unroll
  for (int j = 0; j < BW_RPT; ++j)
#pragma unroll
    for (int jj = 0; jj < BW_KPT; ++jj) s[j][jj] = dp[j][jj] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float kd[BW_KPT];
#pragma unroll
    for (int jj = 0; jj < BW_KPT; ++jj) kd[jj] = ks[(cg + 16 * jj) * (HD + 1) + d];
#pragma unroll
    for (int j = 0; j < BW_RPT; ++j) {
      const float qd = qs[(rg + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int jj = 0; jj < BW_KPT; ++jj) s[j][jj] += qd * kd[jj];
    }
  }
#pragma unroll 4
  for (int e = 0; e < HDV; ++e) {
    float ve[BW_KPT];
#pragma unroll
    for (int jj = 0; jj < BW_KPT; ++jj)
      ve[jj] = vs[(cg + 16 * jj) * (HDV + 1) + e];
#pragma unroll
    for (int j = 0; j < BW_RPT; ++j) {
      const float de = dos[(rg + 16 * j) * (HDV + 1) + e];
#pragma unroll
      for (int jj = 0; jj < BW_KPT; ++jj) dp[j][jj] += de * ve[jj];
    }
  }
#pragma unroll
  for (int j = 0; j < BW_RPT; ++j) {
    const int r = rg + 16 * j;
    const int qp = qpos0 + r / G;
    const float lse = lses[r], del = dels[r];
#pragma unroll
    for (int jj = 0; jj < BW_KPT; ++jj) {
      const int kk = cg + 16 * jj;
      const int kp = k0 + kk;
      float x = s[j][jj] * scale, t = 0.f;
      if (logit_cap > 0.f) {
        t = tanhf(x / logit_cap);
        x = logit_cap * t;
      }
      const bool ok = (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
      float p = 0.f, ds = 0.f;
      if (r < live && kk < nk) {
        p = expf((ok ? x : NEG_INF) - lse);
        ds = p * (dp[j][jj] - del);
        if (logit_cap > 0.f) ds *= 1.f - t * t;
        ds *= scale;
      }
      ps[r * BW_PLD + kk] = p;
      dss[r * BW_PLD + kk] = ds;
    }
  }
}

// 1. delta = rowsum(dout * out), one warp a (b, s, h) row, fp32
template <typename T>
__global__ void __launch_bounds__(BW_NT) fa_bwd_delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, long rows, int Sq, int Hq, int Dv) {
  const long row = (long)blockIdx.x * (BW_NT / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * Dv;
  const T* drow = dout + row * Dv;
  float acc = 0.f;
  for (int e = lane; e < Dv; e += 32) acc += (float)orow[e] * (float)drow[e];
  acc = warp_sum(acc);
  if (lane == 0) {
    // row = (b * Sq + s) * Hq + h -> delta[(b * Hq + h) * Sq + s]
    const long bs = row / Hq;
    const int h = (int)(row - bs * Hq);
    const long b = bs / Sq;
    const int s = (int)(bs - b * Sq);
    delta[(b * Hq + h) * Sq + s] = acc;
  }
}

// 2. dk and dv of one (batch, kv head, key tile)
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(BW_NT) fa_bwd_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv,
    int bq, int causal, int window, int q_offset, float logit_cap,
    float scale) {
  constexpr int CK = (HD + 15) / 16, CV = (HDV + 15) / 16;
  extern __shared__ float smem[];
  float* qs = smem;                          // BW_BQ x (HD + 1)
  float* dos = qs + BW_BQ * (HD + 1);        // BW_BQ x (HDV + 1)
  float* ks = dos + BW_BQ * (HDV + 1);       // BW_BK x (HD + 1)
  float* vs = ks + BW_BK * (HD + 1);         // BW_BK x (HDV + 1)
  float* ps = vs + BW_BK * (HDV + 1);        // BW_BQ x BW_PLD
  float* dss = ps + BW_BQ * BW_PLD;          // BW_BQ x BW_PLD
  float* lses = dss + BW_BQ * BW_PLD;        // BW_BQ
  float* dels = lses + BW_BQ;                // BW_BQ

  const int G = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BW_BK;
  const int nk = min(BW_BK, Sk - k0);
  tile_rows<T, HD>(ks, HD + 1, BW_BK, nk,
                   k + ((long)b * Sk + k0) * Hkv * HD + (long)hk * HD,
                   (long)Hkv * HD);
  tile_rows<T, HDV>(vs, HDV + 1, BW_BK, nk,
                    v + ((long)b * Sk + k0) * Hkv * HDV + (long)hk * HDV,
                    (long)Hkv * HDV);

  const int tr = threadIdx.x >> 4, tc = threadIdx.x & 15;
  float akk[BW_KPT][CK], avv[BW_KPT][CV];
#pragma unroll
  for (int j = 0; j < BW_KPT; ++j) {
#pragma unroll
    for (int c = 0; c < CK; ++c) akk[j][c] = 0.f;
#pragma unroll
    for (int c = 0; c < CV; ++c) avv[j][c] = 0.f;
  }

  // the q positions that see a key of [k0, k0 + nk): causal from k0, a
  // window up to k0 + nk - 1 + window - 1
  int i_lo = causal ? max(0, k0 - q_offset) : 0;
  int i_hi = Sq - 1;
  if (window > 0) i_hi = min(i_hi, k0 + nk - 2 + window - q_offset);
  const int t_lo = i_lo / bq, t_hi = i_hi < i_lo ? t_lo - 1 : i_hi / bq;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int q0 = t * bq;
    const int nq = min(bq, Sq - q0);
    const int live = nq * G;
    __syncthreads();                  // the last tile's readers are done
    tile_q<T, HD>(qs, q, b, q0, hk, G, live, Sq, Hq);
    tile_q<T, HDV>(dos, dout, b, q0, hk, G, live, Sq, Hq);
    for (int r = threadIdx.x; r < BW_BQ; r += BW_NT) {
      float l = 0.f, dl = 0.f;
      if (r < live) {
        const int i = r / G, g = r - (r / G) * G;
        const long at = ((long)b * Hq + hk * G + g) * Sq + q0 + i;
        l = lse[at];
        dl = delta[at];
      }
      lses[r] = l;
      dels[r] = dl;
    }
    __syncthreads();
    scores_to_ds<HD, HDV>(qs, dos, ks, vs, lses, dels, ps, dss, live, nk, k0,
                          q_offset + q0, G, causal, window, logit_cap,
                          scale);
    __syncthreads();
    // dv[key] += sum_r p[r][key] dout[r]; dk[key] += sum_r ds[r][key] q[r]
    for (int r = 0; r < live; ++r) {
      float pv[BW_KPT], dsv[BW_KPT];
#pragma unroll
      for (int j = 0; j < BW_KPT; ++j) {
        pv[j] = ps[r * BW_PLD + tr + 16 * j];
        dsv[j] = dss[r * BW_PLD + tr + 16 * j];
      }
#pragma unroll
      for (int c = 0; c < CV; ++c) {
        const int col = tc + 16 * c;
        const float x = (HDV % 16 == 0 || col < HDV)
                            ? dos[r * (HDV + 1) + col] : 0.f;
#pragma unroll
        for (int j = 0; j < BW_KPT; ++j) avv[j][c] += pv[j] * x;
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = tc + 16 * c;
        const float x = (HD % 16 == 0 || col < HD)
                            ? qs[r * (HD + 1) + col] : 0.f;
#pragma unroll
        for (int j = 0; j < BW_KPT; ++j) akk[j][c] += dsv[j] * x;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < BW_KPT; ++j) {
    const int kk = tr + 16 * j;
    if (kk >= nk) continue;
    T* dkr = dk + ((long)b * Sk + k0 + kk) * Hkv * HD + (long)hk * HD;
    T* dvr = dv + ((long)b * Sk + k0 + kk) * Hkv * HDV + (long)hk * HDV;
#pragma unroll
    for (int c = 0; c < CK; ++c)
      if (HD % 16 == 0 || tc + 16 * c < HD) store(dkr + tc + 16 * c, akk[j][c]);
#pragma unroll
    for (int c = 0; c < CV; ++c)
      if (HDV % 16 == 0 || tc + 16 * c < HDV)
        store(dvr + tc + 16 * c, avv[j][c]);
  }
}

// 3. dq of one (batch, kv head, q tile)
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(BW_NT) fa_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Sk, int Hq, int Hkv, int bq, int causal,
    int window, int q_offset, float logit_cap, float scale) {
  constexpr int CK = (HD + 15) / 16;
  extern __shared__ float smem[];
  float* qs = smem;
  float* dos = qs + BW_BQ * (HD + 1);
  float* ks = dos + BW_BQ * (HDV + 1);
  float* vs = ks + BW_BK * (HD + 1);
  float* ps = vs + BW_BK * (HDV + 1);
  float* dss = ps + BW_BQ * BW_PLD;
  float* lses = dss + BW_BQ * BW_PLD;
  float* dels = lses + BW_BQ;

  const int G = Hq / Hkv;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal bands first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq;
  const int nq = min(bq, Sq - q0);
  const int live = nq * G;
  tile_q<T, HD>(qs, q, b, q0, hk, G, live, Sq, Hq);
  tile_q<T, HDV>(dos, dout, b, q0, hk, G, live, Sq, Hq);
  for (int r = threadIdx.x; r < BW_BQ; r += BW_NT) {
    float l = 0.f, dl = 0.f;
    if (r < live) {
      const int i = r / G, g = r - (r / G) * G;
      const long at = ((long)b * Hq + hk * G + g) * Sq + q0 + i;
      l = lse[at];
      dl = delta[at];
    }
    lses[r] = l;
    dels[r] = dl;
  }

  const int rg = threadIdx.x >> 4, cg = threadIdx.x & 15;
  float aq[BW_RPT][CK];
#pragma unroll
  for (int j = 0; j < BW_RPT; ++j)
#pragma unroll
    for (int c = 0; c < CK; ++c) aq[j][c] = 0.f;

  // the k tiles the q range [q_lo, q_hi] can see (as the forward)
  const int q_lo = q_offset + q0, q_hi = q_lo + nq - 1;
  const int k_hi = max(0, causal ? min(Sk, q_hi + 1) : Sk);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_hi = (k_hi + BW_BK - 1) / BW_BK;
  for (int t = k_lo / BW_BK; t < t_hi; ++t) {
    const int k0 = t * BW_BK;
    const int nk = min(BW_BK, Sk - k0);
    __syncthreads();                  // the last tile's readers are done
    tile_rows<T, HD>(ks, HD + 1, BW_BK, nk,
                     k + ((long)b * Sk + k0) * Hkv * HD + (long)hk * HD,
                     (long)Hkv * HD);
    tile_rows<T, HDV>(vs, HDV + 1, BW_BK, nk,
                      v + ((long)b * Sk + k0) * Hkv * HDV + (long)hk * HDV,
                      (long)Hkv * HDV);
    __syncthreads();
    scores_to_ds<HD, HDV>(qs, dos, ks, vs, lses, dels, ps, dss, live, nk, k0,
                          q_lo, G, causal, window, logit_cap, scale);
    __syncthreads();
    // dq[r] += sum_key ds[r][key] k[key]
    for (int kk = 0; kk < nk; ++kk) {
      float kv[CK];
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int col = cg + 16 * c;
        kv[c] = (HD % 16 == 0 || col < HD) ? ks[kk * (HD + 1) + col] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < BW_RPT; ++j) {
        const float ds = dss[(rg + 16 * j) * BW_PLD + kk];
#pragma unroll
        for (int c = 0; c < CK; ++c) aq[j][c] += ds * kv[c];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < BW_RPT; ++j) {
    const int r = rg + 16 * j;
    if (r >= live) continue;
    const int i = r / G, g = r - (r / G) * G;
    T* dqr = dq + ((long)b * Sq + q0 + i) * Hq * HD + (long)(hk * G + g) * HD;
#pragma unroll
    for (int c = 0; c < CK; ++c)
      if (HD % 16 == 0 || cg + 16 * c < HD) store(dqr + cg + 16 * c, aq[j][c]);
  }
}

// ---------------------------------------------------------------------------
// bf16 inputs: the tensor-core kernels
// ---------------------------------------------------------------------------
// Every product on mma.sync m16n8k16 (bf16 in, fp32 accumulators, fed by
// ldmatrix as in the forward's kernel), p and ds rounded once to bf16 as
// the next product's A fragments straight from the score registers.  A
// warp owns 16 rows of its accumulators: 16 keys of dk and dv in the dk /
// dv kernel (it computes s^T = k q^T, so that p^T and ds^T come out with
// keys as rows), 16 (q position, head) rows of dq in the dq kernel.  Four
// warps a block: 64 keys, or 64 q rows (the fp32 kernels' tiles).  q, k,
// v and dout stay bf16 in shared memory, copied with 16-byte cp.async;
// a row is padded to an odd count of 16-byte chunks (conflict-free
// ldmatrix) and, where D or Dv is not a multiple of 16 (120), to the next
// k16 step with columns zeroed once when the block starts.
constexpr int TB_NW = 4;                     // warps a block
constexpr int TB_NT = 32 * TB_NW;
constexpr int TB_ROWS = 16 * TB_NW;          // keys, or q rows, a block
// q rows a warp scores at once in the dk / dv kernel: 16 at D 192, whose
// dk and dv accumulators (160 floats a thread) leave no room for 32
template <int HD>
__host__ __device__ constexpr int tb_half() { return HD > 128 ? 16 : 32; }

template <int HD, int HDV>
struct TbTile {
  static constexpr int DK = (HD + 15) / 16 * 16;   // q.k depth
  static constexpr int VK = (HDV + 15) / 16 * 16;  // dout.v depth
  static constexpr int KLD = tc_ld(DK);            // q and k row strides
  static constexpr int VLD = tc_ld(VK);            // v and dout row strides
  // q, dout, k, v tiles of TB_ROWS rows, then lse and delta of the q rows
  static constexpr size_t smem =
      2 * (size_t)TB_ROWS * 2 * (KLD + VLD) + 2 * sizeof(float) * TB_ROWS;
};
static_assert(TbTile<192, 128>::smem <= 232448, "K4 backward smem");

// zero columns [W, WP) of a tile of TB_ROWS rows of stride ld
template <int W, int WP>
__device__ __forceinline__ void zero_pad(__nv_bfloat16* t, int ld) {
  if constexpr (WP != W) {
    constexpr int PAD = (WP - W) / 8;
    for (int c = threadIdx.x; c < TB_ROWS * PAD; c += TB_NT) {
      const int r = c / PAD;
      *reinterpret_cast<uint4*>(t + r * ld + W + (c - r * PAD) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// rows of W bf16 values (W / 8 16-byte copies) into a tile of stride ld;
// row r < n comes from src + r * stride, other rows are zero-filled
template <int W>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int ld, int n,
                                          const __nv_bfloat16* src,
                                          long stride) {
  constexpr int CH = W / 8;
  for (int c = threadIdx.x; c < TB_ROWS * CH; c += TB_NT) {
    const int r = c / CH, ch = c - r * CH;
    const bool ok = r < n;
    cp_async16(dst + r * ld + ch * 8, ok ? src + r * stride + ch * 8 : src,
               ok);
  }
}

// a q-side tile (rows r = i * G + g < live) of W columns
template <int W>
__device__ __forceinline__ void copy_q_rows(__nv_bfloat16* dst, int ld,
                                            const __nv_bfloat16* src, int b,
                                            int q0, int hk, int G, int live,
                                            int Sq, int Hq) {
  constexpr int CH = W / 8;
  const long row = (long)Hq * W;
  const __nv_bfloat16* base = src + ((long)b * Sq + q0) * row
                              + (long)hk * G * W;
  for (int c = threadIdx.x; c < TB_ROWS * CH; c += TB_NT) {
    const int r = c / CH, ch = c - r * CH;
    const int i = r / G;
    const bool ok = r < live;
    cp_async16(dst + r * ld + ch * 8,
               ok ? base + i * row + (r - i * G) * W + ch * 8 : src, ok);
  }
}

// acc[n] += A . B over k16 steps: A's 16 rows from a row-major tile at
// rows a0, B = the n8 tiles NT0 .. NT0 + NN of a row-major [n][k] tile
// (rows b0 + 8 n), both over ksteps k16 steps
template <int NN>
__device__ __forceinline__ void mma_rows_nk(float (*acc)[4],
                                            const __nv_bfloat16* at,
                                            int a_ld, int a0,
                                            const __nv_bfloat16* bt,
                                            int b_ld, int b0, int ksteps) {
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < ksteps; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, at + (a0 + (lane & 7) + (lane & 8)) * a_ld + kk * 16
                       + (lane >> 4) * 8);
#pragma unroll
    for (int nn = 0; nn < NN / 2; ++nn) {
      uint32_t bk[4];
      ldmatrix_x4(bk, bt + (b0 + nn * 16 + (lane & 7) + (lane >> 4) * 8)
                           * b_ld + kk * 16 + (lane & 8));
      mma_bf16_16816(acc[2 * nn], a, bk[0], bk[1]);
      mma_bf16_16816(acc[2 * nn + 1], a, bk[2], bk[3]);
    }
  }
}

// acc[n] += A . B for one k16 step: A the bf16 fragment a, B the k16 x
// (8 NO) slice of a row-major [k][n] tile at rows k0 (transposed loads)
template <int NO>
__device__ __forceinline__ void mma_kn(float (*acc)[4], const uint32_t* a,
                                       const __nv_bfloat16* bt, int b_ld,
                                       int k0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* brow = bt + (k0 + (lane & 7) + (lane & 8)) * b_ld;
#pragma unroll
  for (int nn = 0; nn < NO / 2; ++nn) {
    uint32_t bv[4];
    ldmatrix_x4_trans(bv, brow + nn * 16 + (lane >> 4) * 8);
    mma_bf16_16816(acc[2 * nn], a, bv[0], bv[1]);
    mma_bf16_16816(acc[2 * nn + 1], a, bv[2], bv[3]);
  }
  if constexpr (NO % 2) {
    uint32_t bv[2];
    ldmatrix_x2_trans(bv, brow + (NO - 1) * 8);
    mma_bf16_16816(acc[NO - 1], a, bv[0], bv[1]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// p and ds of one score element: x the raw q.k, lse and delta of its q
// row, dp = dout . v; ok false gives 0 and 0
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float del,
                                     bool ok, bool masked, float logit_cap,
                                     float scale, float& p, float& ds) {
  float x = s * scale, t = 0.f;
  if (logit_cap > 0.f) {
    t = tanhf(x / logit_cap);
    x = logit_cap * t;
  }
  p = ok ? __expf((masked ? NEG_INF : x) - lse) : 0.f;
  ds = p * (dp - del);
  if (logit_cap > 0.f) ds *= 1.f - t * t;
  ds *= scale;
}

// 2 (tensor cores). dk and dv of one (batch, kv head, tile of 64 keys)
template <int HD, int HDV>
__global__ void __launch_bounds__(TB_NT) fa_bwd_dkdv_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
    __nv_bfloat16* __restrict__ dv, int Sq, int Sk, int Hq, int Hkv, int bq,
    int causal, int window, int q_offset, float logit_cap, float scale) {
  using Tile = TbTile<HD, HDV>;
  constexpr int DK = Tile::DK, VK = Tile::VK;
  constexpr int KLD = Tile::KLD, VLD = Tile::VLD;
  constexpr int HALF = tb_half<HD>();
  constexpr int NH = HALF / 8;         // n8 tiles of a half's scores
  constexpr int NK = HD / 8, NV = HDV / 8;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tb_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tb_smem);      // TB_ROWS x KLD
  bf16* ks = qs + TB_ROWS * KLD;                    // TB_ROWS x KLD
  bf16* vs = ks + TB_ROWS * KLD;                    // TB_ROWS x VLD
  bf16* dos = vs + TB_ROWS * VLD;                   // TB_ROWS x VLD
  float* lses = reinterpret_cast<float*>(dos + TB_ROWS * VLD);
  float* dels = lses + TB_ROWS;

  const int G = Hq / Hkv;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * TB_ROWS;
  const int nk = min(TB_ROWS, Sk - k0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kw = warp * 16;                   // this warp's first key row
  zero_pad<HD, DK>(qs, KLD);
  zero_pad<HD, DK>(ks, KLD);
  zero_pad<HDV, VK>(vs, VLD);
  zero_pad<HDV, VK>(dos, VLD);
  copy_rows<HD>(ks, KLD, nk, k + ((long)b * Sk + k0) * Hkv * HD
                                 + (long)hk * HD, (long)Hkv * HD);
  copy_rows<HDV>(vs, VLD, nk, v + ((long)b * Sk + k0) * Hkv * HDV
                                  + (long)hk * HDV, (long)Hkv * HDV);
  cp_async_commit();

  float adk[NK][4], adv[NV][4];
#pragma unroll
  for (int n = 0; n < NK; ++n) adk[n][0] = adk[n][1] = adk[n][2] = adk[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n) adv[n][0] = adv[n][1] = adv[n][2] = adv[n][3] = 0.f;
  // this thread's two key rows (h = 0, 1) and their positions
  int kp[2];
  kp[0] = k0 + kw + (lane >> 2);
  kp[1] = kp[0] + 8;

  int i_lo = causal ? max(0, k0 - q_offset) : 0;
  int i_hi = Sq - 1;
  if (window > 0) i_hi = min(i_hi, k0 + nk - 2 + window - q_offset);
  const int t_lo = i_lo / bq, t_hi = i_hi < i_lo ? t_lo - 1 : i_hi / bq;
  for (int t = t_lo; t <= t_hi; ++t) {
    const int q0 = t * bq;
    const int nq = min(bq, Sq - q0);
    const int live = nq * G;
    __syncthreads();                  // the last tile's readers are done
    copy_q_rows<HD>(qs, KLD, q, b, q0, hk, G, live, Sq, Hq);
    copy_q_rows<HDV>(dos, VLD, dout, b, q0, hk, G, live, Sq, Hq);
    cp_async_commit();
    for (int r = tid; r < TB_ROWS; r += TB_NT) {
      float l = 0.f, dl = 0.f;
      if (r < live) {
        const int i = r / G;
        const long at = ((long)b * Hq + hk * G + r - i * G) * Sq + q0 + i;
        l = lse[at];
        dl = delta[at];
      }
      lses[r] = l;
      dels[r] = dl;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (kw >= nk) continue;           // a warp past Sk has no key
#pragma unroll
    for (int h = 0; h < TB_ROWS / HALF; ++h) {
      const int c0 = h * HALF;        // the part's first q row
      if (c0 >= live) break;
      float st[NH][4], dpt[NH][4];
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
      // s^T = k q^T (keys x q rows), dp^T = v dout^T
      mma_rows_nk<NH>(st, ks, KLD, kw, qs, KLD, c0, DK / 16);
      mma_rows_nk<NH>(dpt, vs, VLD, kw, dos, VLD, c0, VK / 16);
      // p^T and ds^T in place of s^T and dp^T; element e of n8 tile n is
      // key row kw + lane / 4 + 8 (e >> 1), q row c0 + 8 n + 2 (lane % 4)
      // + (e & 1)
#pragma unroll
      for (int n = 0; n < NH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = c0 + 8 * n + 2 * (lane & 3) + (e & 1);
          const int qp = q_offset + q0 + r / G, key = kp[e >> 1];
          const bool ok = r < live && key < Sk;
          const bool masked = (causal && key > qp)
                              || (window > 0 && key <= qp - window);
          float p, ds;
          p_ds(st[n][e], dpt[n][e], lses[r], dels[r], ok, masked, logit_cap,
               scale, p, ds);
          st[n][e] = p;
          dpt[n][e] = ds;
        }
      // dv += p^T dout, dk += ds^T q over the half's q rows
#pragma unroll
      for (int kk = 0; kk < HALF / 16; ++kk) {
        uint32_t ap[4], ad[4];
        ap[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        ap[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        ap[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        ap[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
        ad[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        ad[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        ad[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        ad[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
        mma_kn<NV>(adv, ap, dos, VLD, c0 + kk * 16);
        mma_kn<NK>(adk, ad, qs, KLD, c0 + kk * 16);
      }
    }
  }

  // dk, dv rows of this thread: keys kp[h], columns 8 n + 2 (lane % 4)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kp[h] >= Sk) continue;
    bf16* dkr = dk + ((long)b * Sk + kp[h]) * Hkv * HD + (long)hk * HD
                + 2 * (lane & 3);
    bf16* dvr = dv + ((long)b * Sk + kp[h]) * Hkv * HDV + (long)hk * HDV
                + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * n) =
          __floats2bfloat162_rn(adk[n][2 * h], adk[n][2 * h + 1]);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * n) =
          __floats2bfloat162_rn(adv[n][2 * h], adv[n][2 * h + 1]);
  }
}

// 3 (tensor cores). dq of one (batch, kv head, q tile of 64 rows)
template <int HD, int HDV>
__global__ void __launch_bounds__(TB_NT) fa_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Sq,
    int Sk, int Hq, int Hkv, int bq, int causal, int window, int q_offset,
    float logit_cap, float scale) {
  using Tile = TbTile<HD, HDV>;
  constexpr int DK = Tile::DK, VK = Tile::VK;
  constexpr int KLD = Tile::KLD, VLD = Tile::VLD;
  constexpr int NS = TB_ROWS / 8;      // n8 tiles of a score row
  constexpr int NK = HD / 8;
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char tb_smem[];
  bf16* qs = reinterpret_cast<bf16*>(tb_smem);
  bf16* ks = qs + TB_ROWS * KLD;
  bf16* vs = ks + TB_ROWS * KLD;
  bf16* dos = vs + TB_ROWS * VLD;

  const int G = Hq / Hkv;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal bands first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq;
  const int nq = min(bq, Sq - q0);
  const int live = nq * G;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp * 16;
  zero_pad<HD, DK>(qs, KLD);
  zero_pad<HD, DK>(ks, KLD);
  zero_pad<HDV, VK>(vs, VLD);
  zero_pad<HDV, VK>(dos, VLD);
  copy_q_rows<HD>(qs, KLD, q, b, q0, hk, G, live, Sq, Hq);
  copy_q_rows<HDV>(dos, VLD, dout, b, q0, hk, G, live, Sq, Hq);
  cp_async_commit();

  // this thread's rows rw + lane / 4 + 8 h: positions, lse, delta
  int qp[2];
  float lr[2], dr[2];
  bool rok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + (lane >> 2) + 8 * h;
    rok[h] = r < live;
    const int i = r / G;
    qp[h] = q_offset + q0 + i;
    const long at = ((long)b * Hq + hk * G + r - i * G) * Sq + q0 + i;
    lr[h] = rok[h] ? lse[at] : 0.f;
    dr[h] = rok[h] ? delta[at] : 0.f;
  }
  float aq[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n) aq[n][0] = aq[n][1] = aq[n][2] = aq[n][3] = 0.f;

  const int q_lo = q_offset + q0, q_hi = q_lo + nq - 1;
  const int k_hi = max(0, causal ? min(Sk, q_hi + 1) : Sk);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_hi = (k_hi + TB_ROWS - 1) / TB_ROWS;
  const bool warp_live = rw < live;
  for (int t = k_lo / TB_ROWS; t < t_hi; ++t) {
    const int k0 = t * TB_ROWS;
    const int nk = min(TB_ROWS, Sk - k0);
    __syncthreads();                  // the last tile's readers are done
    copy_rows<HD>(ks, KLD, nk, k + ((long)b * Sk + k0) * Hkv * HD
                                   + (long)hk * HD, (long)Hkv * HD);
    copy_rows<HDV>(vs, VLD, nk, v + ((long)b * Sk + k0) * Hkv * HDV
                                    + (long)hk * HDV, (long)Hkv * HDV);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!warp_live) continue;
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_rows_nk<NS>(s, qs, KLD, rw, ks, KLD, 0, DK / 16);
    mma_rows_nk<NS>(dp, dos, VLD, rw, vs, VLD, 0, VK / 16);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int key = k0 + 8 * n + 2 * (lane & 3) + (e & 1);
        const bool ok = rok[h] && key < Sk;
        const bool masked = (causal && key > qp[h])
                            || (window > 0 && key <= qp[h] - window);
        float p, ds;
        p_ds(s[n][e], dp[n][e], lr[h], dr[h], ok, masked, logit_cap, scale,
             p, ds);
        dp[n][e] = ds;
      }
    // dq += ds k over the tile's keys
#pragma unroll
    for (int kk = 0; kk < TB_ROWS / 16; ++kk) {
      uint32_t ad[4];
      ad[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      ad[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      ad[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      ad[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
      mma_kn<NK>(aq, ad, ks, KLD, kk * 16);
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!rok[h]) continue;
    const int r = rw + (lane >> 2) + 8 * h;
    const int i = r / G;
    bf16* dqr = dq + ((long)b * Sq + q0 + i) * Hq * HD
                + (long)(hk * G + r - i * G) * HD + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < NK; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqr + 8 * n) =
          __floats2bfloat162_rn(aq[n][2 * h], aq[n][2 * h + 1]);
  }
}

// ---------------------------------------------------------------------------
// bf16 at (64, 64), (120, 120) and (128, 128): the Hopper kernels
// ---------------------------------------------------------------------------
// Every product on wgmma m64nNk16 (hopper.cuh), one consumer warpgroup a
// block owning 64 accumulator rows, fed by one producer warp whose lane 0
// keeps TMA copies in flight on mbarriers: the block's resident tiles
// once, the streamed tiles through a ring of WG_STAGES stages (full
// barrier: the copies landed; empty barrier: the warpgroup's 128 threads
// are done with the stage; four stages measured no faster).  Tiles sit in
// shared memory as the TMA's 128-byte swizzle writes them, in panels of
// 64 columns (D 120 as two panels whose last 8 columns the TMA fills with
// zeros past the tensor's edge), which is the layout the wgmma
// descriptors name.
//
// The GQA-packed q rows (row i G + g of a tile: position q0 + i, head hk G
// + g) are one 4-d tensor map per q-side tensor, (D, Hq, Sq, B) with boxes
// of (64, G, bq, 1): the G heads of a kv head lie next to each other, so
// one box is the whole tile, rows in the packed order.  Positions past Sq
// come in as zeros; rows past bq G (bq = QT / G rounded down) are zeroed
// once when the block starts.  lse and delta of a tile come from the
// workspace fa_bwd_pack_kernel writes, QT lse then QT delta values a
// (batch, kv head, q tile), with lse = +inf and delta = 0 on the rows
// that hold no q row, so that such a row gets p = 0 with no per-element
// test: one bulk copy a tile.
//
// A (q tile, key tile) pair is classified once per tile (tile_class):
// SKIP (no position sees a key), FULL (every position sees every key of a
// whole tile: no per-element mask), MASKED (the diagonal, the window's
// edge or the keys' end cross it: the mask per element, positions from a
// row-to-position table in shared memory, no division).
//
//   dk / dv (fa_bwd_dkdv_wgmma_kernel): a block per (batch, kv head, 64
//     keys), k and v resident; the q tiles its keys can see stream
//     through the ring, with their lse / delta.  Per tile, per chunk of CH
//     q rows: s^T = k q^T and dp^T = v dout^T (A the resident k or v, as
//     register fragments at D 64 (AREG), else from shared memory; B the
//     chunk's q or dout rows, K-major), p^T and ds^T in registers,
//     rounded once to bf16 as the A operands of dv += p^T dout and dk +=
//     ds^T q, whose B is the chunk's dout or q rows read MN-major
//     (trans-b), one 64-column panel an instruction.
// Every role branch (producer, consumer) tests a warp index broadcast by
// __shfl_sync: the compiler then knows it warp-uniform and keeps the
// wgmmas asynchronous (in a branch it takes for divergent, ptxas
// serializes them, warning C7520: 2x slower here).
//   dq (fa_bwd_dq_wgmma_kernel): a block per (batch, kv head, q tile, 64
//     of its rows), the q tile and its dout, lse and delta resident; the
//     key tiles its rows can see stream through the ring.  s = q k^T, dp =
//     dout v^T (ss), ds in registers as the A operand of dq += ds k (B the
//     k tile MN-major).
// No float atomics: each block owns its outputs and sums in a fixed order.
constexpr int WG_KEYS = 64;      // keys a k tile: a warpgroup's 64 rows
constexpr int WG_STAGES = 2;     // stages of the streamed tiles' ring
constexpr int WG_THREADS = 160;  // one consumer warpgroup, one producer warp
constexpr int TILE_SKIP = 0, TILE_FULL = 1, TILE_MASKED = 2;

// The class of q positions [qlo, qhi] against the keys [k0, k0 + nk) of a
// WG_KEYS tile (flash_attention.py's bwd_tile_class mirrors it)
__host__ __device__ __forceinline__ int tile_class(int qlo, int qhi, int k0,
                                                   int nk, int causal,
                                                   int window) {
  const int khi = k0 + nk - 1;
  if (nk <= 0 || qhi < qlo || (causal && k0 > qhi)
      || (window > 0 && qlo - khi >= window))
    return TILE_SKIP;
  if (nk == WG_KEYS && (!causal || khi <= qlo)
      && (window <= 0 || qhi - k0 < window))
    return TILE_FULL;
  return TILE_MASKED;
}

// What the elementwise step of a tile needs, constant over the call: the
// scale, the soft-cap and its reciprocal, and the band of q position -
// key that the mask keeps, [lo, hi] (causal: lo 0; window w: hi w - 1)
struct WgMask {
  float scale, cap, inv_cap;
  int lo, hi;
};

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// p and ds of one score element, branch-free (so that a thread's score
// elements interleave): s the raw q.k, dp = dout . v, lse and delta of its
// q row; keep false gives the masked score NEG_INF.  lse = +inf (a row
// that holds no q row) gives p = 0.
template <bool CAP>
__device__ __forceinline__ void wg_p_ds(float s, float dp, float lse,
                                        float del, bool keep,
                                        const WgMask& m, float& p,
                                        float& ds) {
  float x = s * m.scale, t = 0.f;
  if constexpr (CAP) {
    t = tanhf(x * m.inv_cap);
    x = m.cap * t;
  }
  x = keep ? x : NEG_INF;
  p = ex2_approx((x - lse) * 1.4426950408889634f);
  ds = p * (dp - del);
  if constexpr (CAP) ds *= 1.f - t * t;
  ds *= m.scale;
}

template <int HD, int HDV>
struct WgForm {
  static constexpr int PK = (HD + 63) / 64;    // 64-column panels of q, k
  static constexpr int PV = (HDV + 63) / 64;   // of v, dout
  static constexpr int QT = HD <= 64 ? 128 : 64;   // rows a q tile
  static constexpr int CH = HD <= 64 ? 64 : 32;    // q rows a dk / dv step
  static constexpr int NH = QT / 64;               // dq blocks a q tile
  // dk / dv: k and v as register A fragments (one panel each, 64-column
  // chunks), so that the score products read only q and dout from shared
  // memory
  static constexpr bool AREG = PK == 1 && PV == 1;
  static_assert(!AREG || CH == 64, "register A fragments take N 64");
  static constexpr int QPANEL = QT * 128;          // bytes of a q-side panel
  static constexpr int KPANEL = WG_KEYS * 128;     // of a k-side panel
  static constexpr int LD = 1024;                  // lse and delta, 2 QT floats
  static constexpr int BARS = 8 * (2 * WG_STAGES + 1);
  static constexpr int DKDV_STAGE = (PK + PV) * QPANEL + LD;
  static constexpr int DQ_STAGE = (PK + PV) * KPANEL;
  // 1024 bytes of slack to align the tiles to the swizzle's 1024 bytes
  static constexpr size_t dkdv_smem = 1024 + (PK + PV) * KPANEL
                                      + WG_STAGES * DKDV_STAGE + 4 * QT
                                      + BARS;
  static constexpr size_t dq_smem = 1024 + (PK + PV) * QPANEL + LD
                                    + WG_STAGES * DQ_STAGE + BARS;
  // two blocks an SM (228 KB, 1 KB of it the system's per block)
  static_assert(dkdv_smem <= 113 * 1024 && dq_smem <= 113 * 1024,
                "K4 backward smem");
};

struct WgArgs {
  const float* ws;                  // lse and delta by q tile
  __nv_bfloat16 *dq, *dk, *dv;
  int Sq, Sk, Hq, Hkv, G, bq, ntq, causal, window, q_offset;
  WgMask m;
};

// p (dynamic shared memory) moved up to the next 1024-byte boundary by
// pointer arithmetic, so that the compiler still knows it for shared
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_addr(p) & 1023)) & 1023);
}

// zero rows [rows, QT) of n panels of QT rows, 1024-byte aligned, every
// thread of the block
template <int QT>
__device__ __forceinline__ void zero_rows(unsigned char* panels, int n,
                                          int rows) {
  const int per = (QT - rows) * 8;            // 16-byte chunks a panel
  for (int c = threadIdx.x; c < n * per; c += blockDim.x) {
    const int p = c / per, o = c - p * per;
    *reinterpret_cast<uint4*>(panels + (size_t)p * QT * 128 + rows * 128
                              + o * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the ss product acc (N = 64 or 32 columns) += A B^T over nk16 k16 steps:
// A the K-major panels at a (apanel bytes apart), B the K-major rows at b
template <int N>
__device__ __forceinline__ void wg_ss(float* acc, const unsigned char* a,
                                      int apanel, const unsigned char* b,
                                      int bpanel, int nk16) {
#pragma unroll
  for (int s = 0; s < nk16; ++s) {
    const uint64_t da = sw128_desc(a + (s / 4) * apanel + (s % 4) * 32, 16);
    const uint64_t db = sw128_desc(b + (s / 4) * bpanel + (s % 4) * 32, 16);
    if constexpr (N == 64) wgmma_ss_n64<0, 0>(acc, da, db);
    else wgmma_ss_n32<0, 0>(acc, da, db);
  }
}

// the A fragments of a warpgroup's 64 rows of a swizzled panel, k16 steps
// 0 .. 3 (ldmatrix; warp w reads rows 16 w .. 16 w + 15)
__device__ __forceinline__ void panel_frags(uint32_t (&f)[4][4],
                                            const unsigned char* panel) {
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane & 7) + (lane & 8);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int chunk = 2 * kk + (lane >> 4);
    ldmatrix_x4(f[kk], panel + row * 128 + ((chunk ^ (row & 7)) << 4));
  }
}

// acc (N = 64 columns) += A B^T over one panel: A the register fragments
// f, B the K-major rows at b
__device__ __forceinline__ void wg_rs(float* acc, const uint32_t (&f)[4][4],
                                      const unsigned char* b) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
    wgmma_rs_n64<0>(acc, f[s], sw128_desc(b + s * 32, 16));
}

// A fragment of k16 step kk from accumulators x (n8 tiles 2 kk, 2 kk + 1)
__device__ __forceinline__ void a_frag(uint32_t* f, const float* x, int kk) {
  f[0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
  f[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  f[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  f[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// chunk c's score products into s and dp, issued as one commit group:
// s^T = k q^T, dp^T = v dout^T over q rows c CH .. c CH + CH - 1 of the
// tile at st
template <int HD, int HDV>
__device__ __forceinline__ void dkdv_scores(
    float* s, float* dp, const unsigned char* ks, const unsigned char* vs,
    const uint32_t (&kf)[4][4], const uint32_t (&vf)[4][4],
    const unsigned char* st, int c) {
  using F = WgForm<HD, HDV>;
  constexpr int PK = F::PK, PV = F::PV, CH = F::CH;
#pragma unroll
  for (int i = 0; i < CH / 2; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
  if constexpr (F::AREG) {
    wg_rs(s, kf, st + c * CH * 128);
    wg_rs(dp, vf, st + PK * F::QPANEL + c * CH * 128);
  } else {
    wg_ss<CH>(s, ks, F::KPANEL, st + c * CH * 128, F::QPANEL, 4 * PK);
    wg_ss<CH>(dp, vs, F::KPANEL, st + PK * F::QPANEL + c * CH * 128,
              F::QPANEL, 4 * PV);
  }
  wgmma_commit();
}

// one streamed q tile of the dk / dv kernel (q and dout panels at st, lse
// and delta after them), its chunks of CH rows while they hold live rows:
// the score products, p^T and ds^T in registers, the gradient products
// dv += p^T dout and dk += ds^T q
template <int HD, int HDV, bool MASK, bool CAP>
__device__ __forceinline__ void dkdv_tile(
    float (&adk)[WgForm<HD, HDV>::PK][32],
    float (&adv)[WgForm<HD, HDV>::PV][32], const unsigned char* ks,
    const unsigned char* vs, const uint32_t (&kf)[4][4],
    const uint32_t (&vf)[4][4], const unsigned char* st, const int* rpos,
    int live, int k0, int qlo, const WgArgs& a) {
  using F = WgForm<HD, HDV>;
  constexpr int PK = F::PK, PV = F::PV, CH = F::CH, NA = CH / 2;
  const float* lses =
      reinterpret_cast<const float*>(st + (PK + PV) * F::QPANEL);
  const float* dels = lses + F::QT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kr = k0 + 16 * warp + (lane >> 2);     // key of d[e < 2]
#pragma unroll 1
  for (int c = 0; c < F::QT / CH && c * CH < live; ++c) {
    float s[NA], dp[NA];
    dkdv_scores<HD, HDV>(s, dp, ks, vs, kf, vf, st, c);
    wgmma_wait<0>();
    reg_fence<NA>(s);
    reg_fence<NA>(dp);
    // p^T and ds^T in place: element 4 j + e is key kr + 8 (e / 2), q row
    // c CH + 8 j + 2 (lane % 4) + e % 2
#pragma unroll
    for (int j = 0; j < CH / 8; ++j) {
      const int col = c * CH + 8 * j + 2 * (lane & 3);
      const float2 l = *reinterpret_cast<const float2*>(lses + col);
      const float2 dl = *reinterpret_cast<const float2*>(dels + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool keep = true;
        if constexpr (MASK) {
          const int d = qlo + rpos[col + (e & 1)] - (kr + 8 * (e >> 1));
          keep = d >= a.m.lo && d <= a.m.hi;
        }
        float p, ds;
        wg_p_ds<CAP>(s[4 * j + e], dp[4 * j + e], (e & 1) ? l.y : l.x,
                     (e & 1) ? dl.y : dl.x, keep, a.m, p, ds);
        s[4 * j + e] = p;
        dp[4 * j + e] = ds;
      }
    }
    uint32_t pa[CH / 16][4], da[CH / 16][4];
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      a_frag(pa[kk], s, kk);
      a_frag(da[kk], dp, kk);
    }
    // dv += p^T dout, dk += ds^T q: B the chunk's rows, MN-major
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < CH / 16; ++kk) {
      const unsigned char* rows = st + (c * CH + 16 * kk) * 128;
#pragma unroll
      for (int p = 0; p < PV; ++p)
        wgmma_rs_n64<1>(adv[p], pa[kk], sw128_desc(
            rows + (PK + p) * F::QPANEL, F::QPANEL));
#pragma unroll
      for (int p = 0; p < PK; ++p)
        wgmma_rs_n64<1>(adk[p], da[kk], sw128_desc(rows + p * F::QPANEL,
                                                   F::QPANEL));
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < PV; ++p) reg_fence<32>(adv[p]);
#pragma unroll
    for (int p = 0; p < PK; ++p) reg_fence<32>(adk[p]);
  }
}

// 2 (Hopper). dk and dv of one (batch, kv head, tile of 64 keys); blocks
// in key-tile order, so that the longest causal walks (key tile 0) start
// first
template <int HD, int HDV>
__global__ void __launch_bounds__(WG_THREADS, 1)
    fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const __grid_constant__ CUtensorMap mdo,
                             const WgArgs a) {
  using F = WgForm<HD, HDV>;
  constexpr int PK = F::PK, PV = F::PV, QT = F::QT, NS = WG_STAGES;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* ks = align1024(wg_smem);             // PK panels
  unsigned char* vs = ks + PK * F::KPANEL;            // PV panels
  unsigned char* ring = vs + PV * F::KPANEL;          // NS stages
  int* rpos = reinterpret_cast<int*>(ring + NS * F::DKDV_STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(rpos + QT);
  uint64_t* empty = full + NS;
  uint64_t* res = empty + NS;

  const int nbh = gridDim.x / ((a.Sk + WG_KEYS - 1) / WG_KEYS);  // B Hkv
  const int kt = blockIdx.x / nbh, bh = blockIdx.x - kt * nbh;
  const int hk = bh % a.Hkv, b = bh / a.Hkv;
  const int k0 = kt * WG_KEYS, nk = min(WG_KEYS, a.Sk - k0);
  // a warp index the compiler knows warp-uniform (see above)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int rows = a.bq * a.G;
  // the q tiles holding a position that sees a key of [k0, k0 + nk)
  const int i_lo = a.causal ? max(0, k0 - a.q_offset) : 0;
  int i_hi = a.Sq - 1;
  if (a.window > 0) i_hi = min(i_hi, k0 + nk - 2 + a.window - a.q_offset);
  const int t_lo = i_lo / a.bq, t_hi = i_hi < i_lo ? t_lo - 1 : i_hi / a.bq;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(res, 1);
    mbar_init_fence();
  }
  for (int s = 0; s < NS; ++s)
    zero_rows<QT>(ring + s * F::DKDV_STAGE, PK + PV, rows);
  for (int r = tid; r < QT; r += WG_THREADS) rpos[r] = r / a.G;
  fence_proxy_async();
  __syncthreads();

  if (warp == 4) {                    // the producer
    if (lane == 0) {
      mbar_expect(res, (PK + PV) * F::KPANEL);
      for (int p = 0; p < PK; ++p)
        tma_load_4d(ks + p * F::KPANEL, &mk, res, 64 * p, hk, k0, b);
      for (int p = 0; p < PV; ++p)
        tma_load_4d(vs + p * F::KPANEL, &mv, res, 64 * p, hk, k0, b);
      const float* wsb = a.ws + (size_t)bh * a.ntq * 2 * QT;
      for (int t = t_lo, n = 0; t <= t_hi; ++t, ++n) {
        const int s = n % NS;
        if (n >= NS) mbar_wait(&empty[s], ((n / NS) & 1) ^ 1);
        unsigned char* st = ring + s * F::DKDV_STAGE;
        mbar_expect(&full[s], (PK + PV) * rows * 128 + 2 * QT * 4);
        for (int p = 0; p < PK; ++p)
          tma_load_4d(st + p * F::QPANEL, &mq, &full[s], 64 * p, hk * a.G,
                      t * a.bq, b);
        for (int p = 0; p < PV; ++p)
          tma_load_4d(st + (PK + p) * F::QPANEL, &mdo, &full[s], 64 * p,
                      hk * a.G, t * a.bq, b);
        bulk_load(st + (PK + PV) * F::QPANEL, wsb + (size_t)t * 2 * QT,
                  2 * QT * 4, &full[s]);
      }
    }
    return;
  }

  float adk[PK][32], adv[PV][32];
#pragma unroll
  for (int p = 0; p < PK; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) adk[p][i] = 0.f;
#pragma unroll
  for (int p = 0; p < PV; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) adv[p][i] = 0.f;
  mbar_wait(res, 0);
  uint32_t kf[4][4], vf[4][4];
  if constexpr (F::AREG) {
    panel_frags(kf, ks);
    panel_frags(vf, vs);
  }
  for (int t = t_lo, n = 0; t <= t_hi; ++t, ++n) {
    const int s = n % NS;
    mbar_wait(&full[s], (n / NS) & 1);
    const unsigned char* st = ring + s * F::DKDV_STAGE;
    const int q0 = t * a.bq, nq = min(a.bq, a.Sq - q0);
    const int qlo = a.q_offset + q0;
    const int cls = tile_class(qlo, qlo + nq - 1, k0, nk, a.causal,
                               a.window);
    const int live = nq * a.G;
    if (cls == TILE_FULL && a.m.cap > 0.f)
      dkdv_tile<HD, HDV, false, true>(adk, adv, ks, vs, kf, vf, st, rpos,
                                      live, k0, qlo, a);
    else if (cls == TILE_FULL)
      dkdv_tile<HD, HDV, false, false>(adk, adv, ks, vs, kf, vf, st, rpos,
                                       live, k0, qlo, a);
    else if (cls == TILE_MASKED && a.m.cap > 0.f)
      dkdv_tile<HD, HDV, true, true>(adk, adv, ks, vs, kf, vf, st, rpos,
                                     live, k0, qlo, a);
    else if (cls == TILE_MASKED)
      dkdv_tile<HD, HDV, true, false>(adk, adv, ks, vs, kf, vf, st, rpos,
                                      live, k0, qlo, a);
    mbar_arrive(&empty[s]);
  }

  // dk, dv rows of this thread: keys k0 + 16 warp + lane / 4 + 8 h,
  // columns 64 p + 8 j + 2 (lane % 4)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = k0 + 16 * warp + (lane >> 2) + 8 * h;
    if (key >= a.Sk) continue;
    const size_t row = (size_t)(b * a.Sk + key) * a.Hkv + hk;
    bf16* dkr = a.dk + row * HD + 2 * (lane & 3);
    bf16* dvr = a.dv + row * HDV + 2 * (lane & 3);
#pragma unroll
    for (int p = 0; p < PK; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (HD % 64 == 0 || 64 * p + 8 * j < HD)
          *reinterpret_cast<__nv_bfloat162*>(dkr + 64 * p + 8 * j) =
              __floats2bfloat162_rn(adk[p][4 * j + 2 * h],
                                    adk[p][4 * j + 2 * h + 1]);
#pragma unroll
    for (int p = 0; p < PV; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (HDV % 64 == 0 || 64 * p + 8 * j < HDV)
          *reinterpret_cast<__nv_bfloat162*>(dvr + 64 * p + 8 * j) =
              __floats2bfloat162_rn(adv[p][4 * j + 2 * h],
                                    adv[p][4 * j + 2 * h + 1]);
  }
}

// one streamed key tile of the dq kernel (k and v panels at st) against
// the block's 64 rows r0 .. r0 + 63 of the resident q tile
template <int HD, int HDV, bool MASK, bool CAP>
__device__ __forceinline__ void dq_tile(
    float (&adq)[WgForm<HD, HDV>::PK][32], const unsigned char* qs,
    const unsigned char* st, int r0, int k0, const int* qp,
    const float* lr, const float* dr, const WgArgs& a) {
  using F = WgForm<HD, HDV>;
  constexpr int PK = F::PK, PV = F::PV;
  const int lane = threadIdx.x & 31;
  float s[32], dp[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
  wgmma_fence();
  // s = q k^T, dp = dout v^T
  wg_ss<64>(s, qs + r0 * 128, F::QPANEL, st, F::KPANEL, 4 * PK);
  wg_ss<64>(dp, qs + PK * F::QPANEL + r0 * 128, F::QPANEL,
            st + PK * F::KPANEL, F::KPANEL, 4 * PV);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence<32>(s);
  reg_fence<32>(dp);
  // ds in place: element 4 j + e is row h = e / 2 of this thread, key k0
  // + 8 j + 2 (lane % 4) + e % 2
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      bool keep = true, ok = true;
      if constexpr (MASK) {
        const int key = k0 + 8 * j + 2 * (lane & 3) + (e & 1);
        const int d = qp[h] - key;
        keep = d >= a.m.lo && d <= a.m.hi;
        ok = key < a.Sk;              // a key past Sk weighs 0
      }
      float p, ds;
      wg_p_ds<CAP>(s[4 * j + e], dp[4 * j + e], lr[h], dr[h], keep, a.m, p,
                   ds);
      dp[4 * j + e] = ok ? ds : 0.f;
    }
  uint32_t da[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) a_frag(da[kk], dp, kk);
  // dq += ds k: B the k tile's rows, MN-major
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < PK; ++p)
      wgmma_rs_n64<1>(adq[p], da[kk], sw128_desc(
          st + p * F::KPANEL + 16 * kk * 128, F::KPANEL));
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int p = 0; p < PK; ++p) reg_fence<32>(adq[p]);
}

// 3 (Hopper). dq of 64 rows of one (batch, kv head, q tile); the last q
// tiles (the longest causal walks) first
template <int HD, int HDV>
__global__ void __launch_bounds__(WG_THREADS, 2)
    fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const WgArgs a) {
  using F = WgForm<HD, HDV>;
  constexpr int PK = F::PK, PV = F::PV, QT = F::QT, NS = WG_STAGES;
  using bf16 = __nv_bfloat16;
  extern __shared__ unsigned char wg_smem[];
  unsigned char* qs = align1024(wg_smem);       // PK q panels, PV dout
  unsigned char* ld = qs + (PK + PV) * F::QPANEL;
  unsigned char* ring = ld + F::LD;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + NS * F::DQ_STAGE);
  uint64_t* empty = full + NS;
  uint64_t* res = empty + NS;

  const int per = (int)(gridDim.x / a.ntq);     // B Hkv NH
  const int t = a.ntq - 1 - (int)(blockIdx.x / per);
  const int rem = blockIdx.x % per;
  const int hh = rem % F::NH, bh = rem / F::NH;
  const int hk = bh % a.Hkv, b = bh / a.Hkv;
  const int q0 = t * a.bq, nq = min(a.bq, a.Sq - q0), live = nq * a.G;
  const int r0 = 64 * hh, r1 = min(r0 + 64, live);
  if (r0 >= r1) return;               // no live row: nothing to write
  // a warp index the compiler knows warp-uniform (see above)
  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int rows = a.bq * a.G;
  // the key tiles the block's positions [plo, phi] can see
  const int plo = a.q_offset + q0 + r0 / a.G;
  const int phi = a.q_offset + q0 + (r1 - 1) / a.G;
  const int k_hi = max(0, a.causal ? min(a.Sk, phi + 1) : a.Sk);
  const int k_lo = a.window > 0 ? max(0, plo - a.window + 1) : 0;
  const int kt_lo = k_lo / WG_KEYS, kt_hi = (k_hi + WG_KEYS - 1) / WG_KEYS;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_init(res, 1);
    mbar_init_fence();
  }
  zero_rows<QT>(qs, PK + PV, rows);
  fence_proxy_async();
  __syncthreads();

  if (warp == 4) {                    // the producer
    if (lane == 0) {
      mbar_expect(res, (PK + PV) * rows * 128 + 2 * QT * 4);
      for (int p = 0; p < PK; ++p)
        tma_load_4d(qs + p * F::QPANEL, &mq, res, 64 * p, hk * a.G, q0, b);
      for (int p = 0; p < PV; ++p)
        tma_load_4d(qs + (PK + p) * F::QPANEL, &mdo, res, 64 * p, hk * a.G,
                    q0, b);
      bulk_load(ld, a.ws + ((size_t)bh * a.ntq + t) * 2 * QT, 2 * QT * 4,
                res);
      for (int kt = kt_lo, n = 0; kt < kt_hi; ++kt, ++n) {
        const int s = n % NS;
        if (n >= NS) mbar_wait(&empty[s], ((n / NS) & 1) ^ 1);
        unsigned char* st = ring + s * F::DQ_STAGE;
        mbar_expect(&full[s], F::DQ_STAGE);
        for (int p = 0; p < PK; ++p)
          tma_load_4d(st + p * F::KPANEL, &mk, &full[s], 64 * p, hk,
                      kt * WG_KEYS, b);
        for (int p = 0; p < PV; ++p)
          tma_load_4d(st + (PK + p) * F::KPANEL, &mv, &full[s], 64 * p, hk,
                      kt * WG_KEYS, b);
      }
    }
    return;
  }

  // this thread's rows r0 + 16 warp + lane / 4 + 8 h: positions, lse, delta
  int qp[2];
  float lr[2], dr[2];
  mbar_wait(res, 0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * h;
    qp[h] = a.q_offset + q0 + r / a.G;
    lr[h] = reinterpret_cast<const float*>(ld)[r];
    dr[h] = reinterpret_cast<const float*>(ld)[QT + r];
  }
  float adq[PK][32];
#pragma unroll
  for (int p = 0; p < PK; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) adq[p][i] = 0.f;
  for (int kt = kt_lo, n = 0; kt < kt_hi; ++kt, ++n) {
    const int s = n % NS;
    mbar_wait(&full[s], (n / NS) & 1);
    const unsigned char* st = ring + s * F::DQ_STAGE;
    const int k0 = kt * WG_KEYS;
    const int cls = tile_class(plo, phi, k0, min(WG_KEYS, a.Sk - k0),
                               a.causal, a.window);
    if (cls == TILE_FULL && a.m.cap > 0.f)
      dq_tile<HD, HDV, false, true>(adq, qs, st, r0, k0, qp, lr, dr, a);
    else if (cls == TILE_FULL)
      dq_tile<HD, HDV, false, false>(adq, qs, st, r0, k0, qp, lr, dr, a);
    else if (cls == TILE_MASKED && a.m.cap > 0.f)
      dq_tile<HD, HDV, true, true>(adq, qs, st, r0, k0, qp, lr, dr, a);
    else if (cls == TILE_MASKED)
      dq_tile<HD, HDV, true, false>(adq, qs, st, r0, k0, qp, lr, dr, a);
    mbar_arrive(&empty[s]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * warp + (lane >> 2) + 8 * h;
    if (r >= live) continue;
    const int i = r / a.G;
    bf16* dqr = a.dq + ((size_t)(b * a.Sq + q0 + i) * a.Hq + hk * a.G + r
                        - i * a.G) * HD + 2 * (lane & 3);
#pragma unroll
    for (int p = 0; p < PK; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (HD % 64 == 0 || 64 * p + 8 * j < HD)
          *reinterpret_cast<__nv_bfloat162*>(dqr + 64 * p + 8 * j) =
              __floats2bfloat162_rn(adq[p][4 * j + 2 * h],
                                    adq[p][4 * j + 2 * h + 1]);
  }
}

// 1 (Hopper). lse and delta = rowsum(dout * out) of every row of every q
// tile into the workspace, QT lse then QT delta values a (batch, kv head,
// q tile): 8 lanes a row, each summing the products of its 16-byte
// vectors (vector c of lane l: c = l, l + 8, ...), then the 8 lanes' sums
// by shuffles; rows that hold no q row get lse = +inf and delta = 0
constexpr int PACK_LANES = 8;
__global__ void __launch_bounds__(BW_NT) fa_bwd_pack_kernel(
    const __nv_bfloat16* __restrict__ o,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    float* __restrict__ ws, long n_rows, int QT, int Sq, int Hq, int Hkv,
    int G, int bq, int ntq, int Dv) {
  const long row = (long)blockIdx.x * (BW_NT / PACK_LANES)
                   + threadIdx.x / PACK_LANES;
  const int lane = threadIdx.x % PACK_LANES;
  const bool in = row < n_rows;
  const long tile = in ? row / QT : 0;         // (b Hkv + hk) ntq + t
  const int r = (int)(row - tile * QT);
  const int t = (int)(tile % ntq);
  const long bh = tile / ntq;
  const int hk = (int)(bh % Hkv), b = (int)(bh / Hkv);
  const int i = r / G, h = hk * G + r - i * G, s = t * bq + i;
  const bool live = in && r < bq * G && s < Sq;
  float acc = 0.f;
  if (live) {
    const long at = (((long)b * Sq + s) * Hq + h) * Dv;
    for (int c = lane; c < Dv / 8; c += PACK_LANES) {
      float x[8], y[8];
      load16(o + at + 8 * c, x);
      load16(dout + at + 8 * c, y);
#pragma unroll
      for (int j = 0; j < 8; ++j) acc += x[j] * y[j];
    }
  }
#pragma unroll
  for (int m = PACK_LANES / 2; m > 0; m >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (in && lane == 0) {
    ws[tile * 2 * QT + r] = live ? lse[((long)b * Hq + h) * Sq + s]
                                 : INFINITY;
    ws[tile * 2 * QT + QT + r] = acc;
  }
}

// the CUDA driver's tensor-map encoder, fetched once through the runtime
// (the library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult got = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &got);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &got);
#endif
    if (got == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the 4-d map of a (B, S, H, W) bf16 tensor: boxes of 64 columns (128
// bytes, swizzled) x box_h heads x box_s positions; elements past an edge
// read as zeros
bool make_map(CUtensorMap* m, const void* t, int B, int S, int H, int W,
              int box_h, int box_s) {
  const EncodeTiled enc = tensor_map_encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)H * W * 2,
                                 (cuuint64_t)S * H * W * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_h, (cuuint32_t)box_s, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// opt a kernel into its dynamic shared memory once; a refusal is returned
template <typename K>
cudaError_t opt_in(K kern, size_t smem) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// the backward kernels of a (dtype, D, Dv) form: the CUDA-core kernels for
// fp32, the tensor-core kernels for bf16
template <typename T, int HD, int HDV>
struct BwForm {
  static constexpr size_t smem = bw_smem_bytes<HD, HDV>();
  static constexpr int threads = BW_NT;
  static auto dkdv() { return fa_bwd_dkdv_kernel<T, HD, HDV>; }
  static auto dq() { return fa_bwd_dq_kernel<T, HD, HDV>; }
};
template <int HD, int HDV>
struct BwForm<__nv_bfloat16, HD, HDV> {
  static constexpr size_t smem = TbTile<HD, HDV>::smem;
  static constexpr int threads = TB_NT;
  static auto dkdv() { return fa_bwd_dkdv_mma_kernel<HD, HDV>; }
  static auto dq() { return fa_bwd_dq_mma_kernel<HD, HDV>; }
};

template <typename T, int HD, int HDV>
int launch_bwd(const BwArgs& a) {
  using Form = BwForm<T, HD, HDV>;
  constexpr size_t smem = Form::smem;
  auto kdkdv = Form::dkdv();
  auto kdq = Form::dq();
  static bool done = false;
  if (!done) {
    cudaError_t e = opt_in(kdkdv, smem);
    if (e == cudaSuccess) e = opt_in(kdq, smem);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  const long rows = (long)a.B * a.Sq * a.Hq;
  const unsigned nd = (unsigned)((rows + BW_NT / 32 - 1) / (BW_NT / 32));
  fa_bwd_delta_kernel<T><<<nd, BW_NT, 0, a.stream>>>(
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout), a.delta,
      rows, a.Sq, a.Hq, a.Dv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gk((a.Sk + BW_BK - 1) / BW_BK, a.Hkv, a.B);
  kdkdv<<<gk, Form::threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.Sq, a.Sk,
      a.Hq, a.Hkv, a.bq, a.causal, a.window, a.q_offset, a.logit_cap,
      a.scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 gq((a.Sq + a.bq - 1) / a.bq, a.Hkv, a.B);
  kdq<<<gq, Form::threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(a.dq), a.Sq, a.Sk, a.Hq, a.Hkv, a.bq,
      a.causal, a.window, a.q_offset, a.logit_cap, a.scale);
  return (int)cudaGetLastError();
}

// the Hopper kernels of a bf16 (D, Dv) form: the pack, dk / dv and dq
// launches
template <int HD, int HDV>
int launch_wg(const BwArgs& a) {
  using F = WgForm<HD, HDV>;
  auto kdkdv = fa_bwd_dkdv_wgmma_kernel<HD, HDV>;
  auto kdq = fa_bwd_dq_wgmma_kernel<HD, HDV>;
  static bool done = false;
  if (!done) {
    cudaError_t e = opt_in(kdkdv, F::dkdv_smem);
    if (e == cudaSuccess) e = opt_in(kdq, F::dq_smem);
    if (e != cudaSuccess) return (int)e;
    done = true;
  }
  const int G = a.Hq / a.Hkv;
  if (a.bq * G > F::QT) return (int)cudaErrorInvalidValue;
  const int ntq = (a.Sq + a.bq - 1) / a.bq;
  const int nkt = (a.Sk + WG_KEYS - 1) / WG_KEYS;
  alignas(64) CUtensorMap mq, mk, mv, mdo;
  if (!make_map(&mq, a.q, a.B, a.Sq, a.Hq, a.D, G, a.bq)
      || !make_map(&mdo, a.dout, a.B, a.Sq, a.Hq, a.Dv, G, a.bq)
      || !make_map(&mk, a.k, a.B, a.Sk, a.Hkv, a.D, 1, WG_KEYS)
      || !make_map(&mv, a.v, a.B, a.Sk, a.Hkv, a.Dv, 1, WG_KEYS))
    return (int)cudaErrorNotSupported;
  using bf16 = __nv_bfloat16;
  const long n_rows = (long)a.B * a.Hkv * ntq * F::QT;
  constexpr int per_block = BW_NT / PACK_LANES;
  fa_bwd_pack_kernel<<<(unsigned)((n_rows + per_block - 1) / per_block),
                       BW_NT, 0, a.stream>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      a.lse, a.delta, n_rows, F::QT, a.Sq, a.Hq, a.Hkv, G, a.bq, ntq, a.Dv);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const WgMask m{a.scale, a.logit_cap,
                 a.logit_cap > 0.f ? 1.f / a.logit_cap : 0.f,
                 a.causal ? 0 : INT_MIN / 2,
                 a.window > 0 ? a.window - 1 : INT_MAX / 2};
  const WgArgs w{a.delta, static_cast<bf16*>(a.dq), static_cast<bf16*>(a.dk),
                 static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.Hq, a.Hkv, G,
                 a.bq, ntq, a.causal, a.window, a.q_offset, m};
  kdkdv<<<(unsigned)(nkt * a.Hkv * a.B), WG_THREADS, F::dkdv_smem,
          a.stream>>>(mq, mk, mv, mdo, w);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kdq<<<(unsigned)(ntq * F::NH * a.Hkv * a.B), WG_THREADS, F::dq_smem,
        a.stream>>>(mq, mk, mv, mdo, w);
  return (int)cudaGetLastError();
}

// fp32 forms and bf16 (192, 128): the CUDA-core and mma.sync kernels,
// q tiles of at most BW_BQ rows
template <typename T, int HD, int HDV>
int launch_small(const BwArgs& a) {
  if (a.bq * (a.Hq / a.Hkv) > BW_BQ) return (int)cudaErrorInvalidValue;
  return launch_bwd<T, HD, HDV>(a);
}

template <typename T, int HD, int HDV>
int launch_form(const BwArgs& a) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_wg<HD, HDV>(a);
  else
    return launch_small<T, HD, HDV>(a);
}

template <typename T>
int bwd_dims(const BwArgs& a) {
  if (a.D == 64 && a.Dv == 64) return launch_form<T, 64, 64>(a);
  if (a.D == 120 && a.Dv == 120) return launch_form<T, 120, 120>(a);
  if (a.D == 128 && a.Dv == 128) return launch_form<T, 128, 128>(a);
  // (192, 128) keeps the mma.sync kernels in bf16: a warpgroup's dk
  // accumulators (96 of a thread) beside dv's, s's and dp's leave no room
  if (a.D == 192 && a.Dv == 128) return launch_small<T, 192, 128>(a);
  return (int)cudaErrorInvalidValue;
}

// The kernels of a form as the card runs them: info = {blocks per SM,
// dynamic shared memory bytes, registers a thread} of the dk / dv kernel
// (part 0) or the dq kernel (part 1)
template <typename K>
int kernel_info(K kern, int threads, size_t smem, int* info) {
  cudaError_t e = opt_in(kern, smem);
  cudaFuncAttributes at;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&at, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kern,
                                                      threads, smem);
  info[1] = (int)smem;
  info[2] = e == cudaSuccess ? at.numRegs : 0;
  return (int)e;
}

template <typename T, int HD, int HDV>
int form_info(int part, int* info) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value && HD != 192) {
    using F = WgForm<HD, HDV>;
    return part == 0
               ? kernel_info(fa_bwd_dkdv_wgmma_kernel<HD, HDV>, WG_THREADS,
                             F::dkdv_smem, info)
               : kernel_info(fa_bwd_dq_wgmma_kernel<HD, HDV>, WG_THREADS,
                             F::dq_smem, info);
  } else {
    using Form = BwForm<T, HD, HDV>;
    return part == 0
               ? kernel_info(Form::dkdv(), Form::threads, Form::smem, info)
               : kernel_info(Form::dq(), Form::threads, Form::smem, info);
  }
}

template <typename T>
int info_dims(int D, int Dv, int part, int* info) {
  if (D == 64 && Dv == 64) return form_info<T, 64, 64>(part, info);
  if (D == 120 && Dv == 120) return form_info<T, 120, 120>(part, info);
  if (D == 128 && Dv == 128) return form_info<T, 128, 128>(part, info);
  if (D == 192 && Dv == 128) return form_info<T, 192, 128>(part, info);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv share
// it); lse (B, Hq, Sq) fp32 from flash_attention_fwd.  bq q positions a q
// tile, and delta an fp32 workspace (flash_attention.py's bwd_plan): for
// bf16 at (64, 64), (120, 120), (128, 128), bq G <= QT (128 at D 64, 64
// at D 120 / 128) and B Hkv ceil(Sq / bq) 2 QT values; for fp32 and for
// bf16 (192, 128), bq G <= 64 and B Hq Sq values.  Sq, Sk >= 1; q, k, v,
// dout 16-byte aligned.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int head_dim, int v_head_dim, int bq,
                                   int causal, int window, int q_offset,
                                   float logit_cap, float scale, int dtype,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv || bq < 1)
    return (int)cudaErrorInvalidValue;
  const BwArgs a{q, k, v, out, dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                 head_dim, v_head_dim, bq, causal, window, q_offset,
                 logit_cap, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return bwd_dims<__nv_bfloat16>(a);
  if (dtype == 0) return bwd_dims<float>(a);
  return (int)cudaErrorInvalidValue;
}

// info[3] = {blocks per SM, dynamic shared memory bytes, registers a
// thread} of a form's dk / dv kernel (part 0) or dq kernel (part 1)
extern "C" int flash_attention_bwd_occupancy(int head_dim, int v_head_dim,
                                             int dtype, int part,
                                             int* info) {
  if (part != 0 && part != 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return info_dims<__nv_bfloat16>(head_dim, v_head_dim, part, info);
  if (dtype == 0) return info_dims<float>(head_dim, v_head_dim, part, info);
  return (int)cudaErrorInvalidValue;
}
