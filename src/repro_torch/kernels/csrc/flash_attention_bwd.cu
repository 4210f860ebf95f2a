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
//   1. delta = rowsum(dout * out) in fp32, (B, Hq, Sq), into a workspace;
//   2. one block per (batch, kv head, tile of 64 keys) sweeps the q tiles
//      that can see its keys, all G q heads of the kv head in one tile (row
//      i * G + g, as the forward), recomputes p = exp(x - lse) and
//      accumulates dv += p^T dout and dk += ds^T q in fp32, with ds = p (dp
//      - delta) (dp = dout v^T), times 1 - tanh^2 under the soft-cap, times
//      the scale; the G heads' sums meet in the block, so no atomics;
//   3. one block per (batch, kv head, q tile) sweeps the key tiles the tile
//      can see and accumulates dq += ds k in fp32.
// No float atomics: every sum runs in a fixed order, the same bits from
// run to run.  bf16 runs 2 and 3 on the tensor cores (mma.sync m16n8k16,
// the forward kernel's fragments; below), fp32 on the CUDA cores in full
// fp32 (the fp32 tiles widened in shared memory).  Not yet: wgmma, TMA
// copies, a k/v or q ring that loads the next tile during this one's
// products.
//
// It allocates nothing (the wrapper passes delta's workspace) and returns
// cudaGetLastError() so that a refused launch is reported.
#include <math.h>

#include "attention_common.cuh"
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

template <typename T>
int bwd_dims(const BwArgs& a) {
  if (a.D == 64 && a.Dv == 64) return launch_bwd<T, 64, 64>(a);
  if (a.D == 120 && a.Dv == 120) return launch_bwd<T, 120, 120>(a);
  if (a.D == 128 && a.Dv == 128) return launch_bwd<T, 128, 128>(a);
  if (a.D == 192 && a.Dv == 128) return launch_bwd<T, 192, 128>(a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, out, dout, dq, dk, dv share
// it); lse (B, Hq, Sq) fp32 from flash_attention_fwd; delta an fp32
// workspace of B * Hq * Sq values.  bq <= 64 / (Hq / Hkv) q positions a q
// tile (the wrapper's 64 / G).  Sq, Sk >= 1; (head_dim, v_head_dim) in
// {(64, 64), (120, 120), (128, 128), (192, 128)}.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int head_dim, int v_head_dim, int bq,
                                   int causal, int window, int q_offset,
                                   float logit_cap, float scale, int dtype,
                                   void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv || bq < 1
      || bq * (Hq / Hkv) > BW_BQ)
    return (int)cudaErrorInvalidValue;
  const BwArgs a{q, k, v, out, dout, static_cast<const float*>(lse),
                 static_cast<float*>(delta), dq, dk, dv, B, Sq, Sk, Hq, Hkv,
                 head_dim, v_head_dim, bq, causal, window, q_offset,
                 logit_cap, scale, static_cast<cudaStream_t>(stream)};
  if (dtype == 1) return bwd_dims<__nv_bfloat16>(a);
  if (dtype == 0) return bwd_dims<float>(a);
  return (int)cudaErrorInvalidValue;
}
