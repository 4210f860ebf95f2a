// Prefill flash attention for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (src/repro_torch/kernels/build.py builds it into
// the port's kernel library, src/repro_torch/kernels/flash_attention.py
// wraps it).
//
//   flash_attention_fwd  forward GQA attention of a whole prompt: q (B, Sq,
//                        Hq, D) against k (B, Sk, Hkv, D) and v (B, Sk, Hkv,
//                        Dv), out (B, Sq, Hq, Dv) in q's dtype; fp32 online
//                        softmax; causal, sliding window, tanh soft-cap
//                        (before the mask), any query scale, q_offset.
//                        (D, Dv) is (64, 64), h2o-danube's (120, 120),
//                        (128, 128) or deepseek-v2's MLA prefill (192,
//                        128): [nope | rope] q/k, v 128.
//
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that a refused launch is reported.
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int FA_NT = 256;           // threads per block: 16 x 16
constexpr int FA_ROWS = 128;         // (q position, q head) rows per block
constexpr int FA_BK = 64;            // keys per k/v tile
constexpr int RPT = FA_ROWS / 16;    // rows per thread
constexpr int KPT = FA_BK / 16;      // keys per thread in the score tile
constexpr int PLD = FA_BK + 16;      // p tile row stride: the two rows a
                                     // warp touches sit 16 banks apart

// q and k tiles of HD columns (odd strides), the v tile of HDV, the p tile
template <int HD, int HDV>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * ((size_t)FA_ROWS * (HD + 1) + (size_t)FA_BK * (HD + 1)
                          + (size_t)FA_BK * HDV + (size_t)FA_ROWS * PLD);
}
// the largest pair, (192, 128), needs 221,952 bytes of the 232,448 a
// Hopper block may opt into; (120, 120) 164,608
static_assert(fa_smem_bytes<192, 128>() <= 232448, "K4 shared memory");
static_assert(fa_smem_bytes<120, 120>() <= 232448, "K4 shared memory");

// Replaces, from src/repro/kernels/flash_attention.py:
//   flash_attention  (:94, kernel _fa_kernel :36, pallas_call :130)
// Bound on the card: operations at the prefill shapes (a 512-token tile of
// rows reuses every k/v byte hundreds of times).  Design: one block per
// (batch, kv head, q tile) carries the G q heads that share the kv head,
// as 128 rows (q position i, head g) = row i * G + g, so each k/v tile is
// read once per group; q tiles hold 128 / G positions (64 for gemma2's
// G = 2, 42 for smollm's G = 3).  The block walks only the k tiles of 64
// keys that its q range can see (causal end, window start: the band the
// chunked twin computes), reading q, k and v in place in their (B, S, H,
// D) layout and staging them in shared memory as fp32.  Each thread holds
// 8 rows: their 8 x 4 scores of a tile and their 8 x Dv/16 output
// accumulators, with the (m, l) state, in registers; the 16 lanes of a
// half-warp share those rows, so the row max and sum are 4 shuffles.  A
// Dv that is not a multiple of 16 (h2o-danube's 120) gives each thread
// ceil(Dv / 16) column slots, the last one predicated: lanes whose column
// cg + 16 c lies past Dv read no v and write nothing, so the wrapper
// never pads q, k or v.  G need not divide 128: at G = 7 (llava-next) a
// tile holds 18 positions, 126 rows, and rows 126 and 127 are never
// written.  The
// update is the reference's (_fa_kernel), once per tile.  Ragged Sq and Sk
// are predicated: keys past Sk score -inf (weight exactly 0, their v rows
// zero-filled), q rows past Sq are never written.  Still simple: fp32 FMAs
// on the CUDA cores (no mma / wgmma), no TMA, no overlap of the next
// tile's load with this tile's math.
//
// Rows that see no key: with the reference's finite NEG_INF a row whose
// keys are all masked in every tile its block visits weighs each in-range
// key of those tiles equally (the mean of their v rows), as the Pallas
// kernel does over its own blocks; a row whose block visits no tile gets 0.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(FA_NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk, int Hq,
    int Hkv, int bq, int causal, int window, int q_offset, float logit_cap,
    float scale) {
  constexpr int QLD = HD + 1;        // odd strides: conflict-free columns
  constexpr int KLD = HD + 1;
  constexpr int CPT = (HDV + 15) / 16;   // output column slots per thread
  constexpr int VN = 16 / sizeof(T); // elements per 16-byte load
  static_assert(HD % VN == 0 && HDV % VN == 0,
                "q, k and v rows must be whole 16-byte loads");
  constexpr int PER_ROW = HD / VN;
  constexpr int PER_ROW_V = HDV / VN;
  extern __shared__ float smem[];
  float* qs = smem;                        // FA_ROWS x QLD
  float* ks = qs + FA_ROWS * QLD;          // FA_BK x KLD
  float* vs = ks + FA_BK * KLD;            // FA_BK x HDV
  float* ps = vs + FA_BK * HDV;            // FA_ROWS x PLD

  const int G = Hq / Hkv;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal bands first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq;
  const int nq = min(bq, Sq - q0);             // q positions in this tile
  const int live = nq * G;                     // rows backed by a q row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = 2 * warp + (lane >> 4);       // row group: rows rg + 16 j
  const int cg = lane & 15;                    // key / column group
  // whether column slot c lies inside Dv (always, where 16 divides Dv)
  auto col_ok = [cg](int c) { return HDV % 16 == 0 || cg + 16 * c < HDV; };

  const long q_row = (long)Hq * HD;            // q position stride
  const long o_row = (long)Hq * HDV;           // out position stride
  const long k_row = (long)Hkv * HD;           // k position stride
  const long v_row = (long)Hkv * HDV;          // v position stride
  for (int c = threadIdx.x; c < FA_ROWS * PER_ROW; c += FA_NT) {
    const int r = c / PER_ROW, col = (c - r * PER_ROW) * VN;
    float x[VN];
    if (r < live) {
      const int i = r / G, g = r - (r / G) * G;
      load16(q + ((long)b * Sq + q0 + i) * q_row + (long)(hk * G + g) * HD
             + col, x);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) qs[r * QLD + col + j] = x[j];
  }

  int qpos[RPT];
  float m[RPT], l[RPT], acc[RPT][CPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    qpos[j] = q_offset + q0 + (rg + 16 * j) / G;
    m[j] = NEG_INF;
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[j][c] = 0.f;
  }

  // the k tiles the tile's q range [q_lo, q_hi] can see
  const int q_lo = q_offset + q0, q_hi = q_lo + nq - 1;
  const int k_hi = max(0, causal ? min(Sk, q_hi + 1) : Sk);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_hi = (k_hi + FA_BK - 1) / FA_BK;
  for (int t = k_lo / FA_BK; t < t_hi; ++t) {
    const int k0 = t * FA_BK;
    const int nk = min(FA_BK, Sk - k0);
    __syncthreads();                   // the last tile's readers are done
    for (int c = threadIdx.x; c < FA_BK * PER_ROW; c += FA_NT) {
      const int r = c / PER_ROW, col = (c - r * PER_ROW) * VN;
      float kx[VN];
      if (r < nk) {
        load16(k + ((long)b * Sk + k0 + r) * k_row + (long)hk * HD + col,
               kx);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) kx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) ks[r * KLD + col + j] = kx[j];
    }
    for (int c = threadIdx.x; c < FA_BK * PER_ROW_V; c += FA_NT) {
      const int r = c / PER_ROW_V, col = (c - r * PER_ROW_V) * VN;
      float vx[VN];
      if (r < nk) {
        load16(v + ((long)b * Sk + k0 + r) * v_row + (long)hk * HDV + col,
               vx);
      } else {
#pragma unroll
        for (int j = 0; j < VN; ++j) vx[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < VN; ++j) vs[r * HDV + col + j] = vx[j];
    }
    __syncthreads();

    // scores of rows rg + 16 j against keys cg + 16 jj
    float s[RPT][KPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) s[j][jj] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kd[KPT];
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) kd[jj] = ks[(cg + 16 * jj) * KLD + d];
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float qd = qs[(rg + 16 * j) * QLD + d];
#pragma unroll
        for (int jj = 0; jj < KPT; ++jj) s[j][jj] += qd * kd[jj];
      }
    }

    // online-softmax update of each row, p into shared memory
    float corr[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float mx = NEG_INF;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const int kk = cg + 16 * jj;
        const int kp = k0 + kk;
        float x = s[j][jj] * scale;
        if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
        const bool ok = (!causal || kp <= qpos[j])
                        && (window <= 0 || kp > qpos[j] - window);
        x = kk < nk ? (ok ? x : NEG_INF) : -INFINITY;
        s[j][jj] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[j], mx);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < KPT; ++jj) {
        const float p = expf(s[j][jj] - m_new);
        ps[(rg + 16 * j) * PLD + cg + 16 * jj] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      corr[j] = expf(m[j] - m_new);
      l[j] = l[j] * corr[j] + sum;
      m[j] = m_new;
    }
    __syncthreads();

    // acc = acc * corr + p . v, columns cg + 16 c
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[j][c] *= corr[j];
    for (int kk = 0; kk < nk; ++kk) {
      float vk[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        vk[c] = col_ok(c) ? vs[kk * HDV + cg + 16 * c] : 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const float p = ps[(rg + 16 * j) * PLD + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[j][c] += p * vk[c];
      }
    }
  }

#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int r = rg + 16 * j;
    if (r >= live) continue;
    const int i = r / G, g = r - (r / G) * G;
    T* o = out + ((long)b * Sq + q0 + i) * o_row + (long)(hk * G + g) * HDV;
    const float den = fmaxf(l[j], 1e-30f);
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (col_ok(c)) store(o + cg + 16 * c, acc[j][c] / den);
  }
}

template <typename T, int HD, int HDV>
int launch_fa(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int Hq, int Hkv, int bq, int causal,
              int window, int q_offset, float logit_cap, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = fa_smem_bytes<HD, HDV>();
  auto kern = flash_attention_kernel<T, HD, HDV>;
  // once per instantiation, so that a launch inside a CUDA-graph capture
  // makes no attribute call; a refusal is returned, never worked around
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  kern<<<grid, FA_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, Hq, Hkv, bq,
      causal, window, q_offset, logit_cap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fa_dims(const void* q, const void* k, const void* v, void* out,
                   int B, int Sq, int Sk, int Hq, int Hkv, int D, int Dv,
                   int bq, int causal, int window, int q_offset,
                   float logit_cap, float scale, cudaStream_t stream) {
  if (D == 64 && Dv == 64)
    return launch_fa<T, 64, 64>(q, k, v, out, B, Sq, Sk, Hq, Hkv, bq, causal,
                                window, q_offset, logit_cap, scale, stream);
  if (D == 120 && Dv == 120)
    return launch_fa<T, 120, 120>(q, k, v, out, B, Sq, Sk, Hq, Hkv, bq,
                                  causal, window, q_offset, logit_cap, scale,
                                  stream);
  if (D == 128 && Dv == 128)
    return launch_fa<T, 128, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, bq,
                                  causal, window, q_offset, logit_cap, scale,
                                  stream);
  if (D == 192 && Dv == 128)
    return launch_fa<T, 192, 128>(q, k, v, out, B, Sq, Sk, Hq, Hkv, bq,
                                  causal, window, q_offset, logit_cap, scale,
                                  stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  bq = 128 /
// (Hq / Hkv) q positions per block.  Sq, Sk >= 1.  (head_dim, v_head_dim)
// in {(64, 64), (120, 120), (128, 128), (192, 128)}.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int Hq, int Hkv, int head_dim,
                                   int v_head_dim, int bq, int causal,
                                   int window, int q_offset, float logit_cap,
                                   float scale, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv
      || bq * (Hq / Hkv) > FA_ROWS || bq < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_fa_dims<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, Hq, Hkv,
                                         head_dim, v_head_dim, bq, causal,
                                         window, q_offset, logit_cap, scale,
                                         st);
  if (dtype == 0)
    return launch_fa_dims<float>(q, k, v, out, B, Sq, Sk, Hq, Hkv, head_dim,
                                 v_head_dim, bq, causal, window, q_offset,
                                 logit_cap, scale, st);
  return (int)cudaErrorInvalidValue;
}
