// Absorbed-MLA latent sweep for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (src/repro_torch/kernels/build.py builds it into
// the port's kernel library, src/repro_torch/kernels/decode_attention.py
// wraps it).
//
//   mla_latent_sweep  stage 1 of deepseek-v2's absorbed MLA attention over
//                     a paged latent pool (P, ps, R), R = r_kv + d_rope:
//                     every (query, head) row [q_abs | q_rope] scores the
//                     whole R-wide latent row of each page of its split,
//                     and the value is the same row's first DV lanes (the
//                     compressed c_kv); online softmax in fp32.  Decode (one
//                     query row per head) or verify (Q rows at pos .. pos +
//                     Q - 1 over the pool rows k_pos < pos, then the Q
//                     pending latent rows folded causally, j <= i).  Stage 2
//                     is paged_attention.cu's lse_merge.
//
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that a refused launch is reported.
#include "attention_common.cuh"

namespace {

constexpr int ML_NT = 256;           // threads per block
constexpr int ML_ROWS = 16;          // (query, head) rows per block

enum MlaMode { ML_DECODE = 0, ML_VERIFY = 1, ML_PENDING = 2 };

template <int R>
constexpr size_t mla_smem_bytes(int kt) {
  return sizeof(float) * ((size_t)(ML_ROWS + kt) * (R + 4)
                          + (size_t)ML_ROWS * kt + 3 * ML_ROWS);
}

// n_rows latent rows of R elements, contiguous from src, into a shared-
// memory fp32 tile with rows R + 4 floats apart; rows past n_live are
// zero.  16-byte loads, neighbouring threads on neighbouring addresses.
template <typename T, int R>
__device__ __forceinline__ void load_latent(const T* __restrict__ src,
                                            int n_rows, int n_live,
                                            float* dst) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER_ROW = R / VN;
  for (int c = threadIdx.x; c < n_rows * PER_ROW; c += ML_NT) {
    const int r = c / PER_ROW;
    const int col = (c - r * PER_ROW) * VN;
    float v[VN];
    if (r < n_live) {
      load16(src + (long)r * R + col, v);
    } else {
#pragma unroll
      for (int j = 0; j < VN; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VN; ++j) dst[r * (R + 4) + col + j] = v[j];
  }
}

// One key tile's online-softmax update of the block's ML_ROWS rows: s =
// [q_abs | q_rope] . row * scale over all R lanes, optional tanh cap,
// masked to NEG_INF (ML_DECODE k_pos <= pos, ML_VERIFY k_pos < pos,
// ML_PENDING j <= i for row i's query index); m' = max(m, max s); p =
// exp(s - m'); l' = l e^(m-m') + sum p; acc' = acc e^(m-m') + p . row[:DV].
// The accumulators are the thread's registers: columns threadIdx.x + ML_NT
// c of every row.  Ends with a barrier.
template <int R, int DV>
__device__ void latent_update(const float* qs, const float* ks, float* pr,
                              float* ms, float* ls, float* cs,
                              float (&acc)[ML_ROWS][DV / ML_NT], int nk,
                              int kt, int mode, int k_pos0, int pos, int r0,
                              int Hq, float logit_cap, float scale) {
  constexpr int LD = R + 4;
  constexpr int CPT = DV / ML_NT;
  for (int idx = threadIdx.x; idx < ML_ROWS * nk; idx += ML_NT) {
    const int rr = idx / nk, k = idx - rr * nk;
    const float4* qa = reinterpret_cast<const float4*>(qs + rr * LD);
    const float4* ka = reinterpret_cast<const float4*>(ks + k * LD);
    float d = 0.f;
#pragma unroll 8
    for (int x = 0; x < R / 4; ++x) {
      const float4 a = qa[x], b = ka[x];
      d += a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
    float s = d * scale;
    if (logit_cap > 0.f) s = logit_cap * tanhf(s / logit_cap);
    bool valid;
    if (mode == ML_DECODE) {
      valid = k_pos0 + k <= pos;
    } else if (mode == ML_VERIFY) {
      valid = k_pos0 + k < pos;
    } else {
      valid = k <= (r0 + rr) / Hq;
    }
    pr[rr * kt + k] = valid ? s : NEG_INF;
  }
  __syncthreads();
  if (threadIdx.x < ML_ROWS) {
    const int rr = threadIdx.x;
    float* sr = pr + rr * kt;
    float mx = sr[0];
    for (int k = 1; k < nk; ++k) mx = fmaxf(mx, sr[k]);
    const float m_prev = ms[rr];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int k = 0; k < nk; ++k) {
      const float p = expf(sr[k] - m_new);
      sr[k] = p;
      sum += p;
    }
    const float corr = expf(m_prev - m_new);
    ls[rr] = ls[rr] * corr + sum;
    ms[rr] = m_new;
    cs[rr] = corr;
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < ML_ROWS; ++rr) {
    const float corr = cs[rr];
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[rr][c] *= corr;
  }
  for (int k = 0; k < nk; ++k) {
    float v[CPT];
#pragma unroll
    for (int c = 0; c < CPT; ++c) v[c] = ks[k * LD + threadIdx.x + ML_NT * c];
#pragma unroll
    for (int rr = 0; rr < ML_ROWS; ++rr) {
      const float p = pr[rr * kt + k];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[rr][c] += p * v[c];
    }
  }
  __syncthreads();
}

// Replaces, from src/repro/kernels/decode_attention.py:
//   mla_paged_decode_attention_pallas           (:1483, kernel :1348)
//   mla_paged_decode_attention_pallas_partials  (:1419, kernel :1380)
// and serves paged_verify_attention_pallas (:970) / its _partials (:877)
// in the MLA form mla_verify_paged gives them (Hkv 1, D = R, Dv = r_kv,
// v a leading slice of k's rows).
// Bound on the card: bytes at decode (each latent row, 1152 bytes of
// bf16, feeds 128 heads: about 2 x 128 x 1088 / 1152 = 240 FLOP per byte,
// under the ~295 where the tensor cores would bind, and these are CUDA-
// core FMAs); operations at verify (Q x 128 rows per latent row).
// Design: the TPU kernel keeps all 128 heads of a slot in one tile, whose
// 128 x 512 fp32 accumulator (256 KB) does not fit the 227 KB of shared
// memory a Hopper block may use.  So one block per (tile of 16 (query,
// head) rows, split, batch row) walks its split's contiguous page slice
// in a loop (the TPU's sequential grid axis), loading each page's ps x R
// latent rows into shared memory once and scoring them against all 16
// rows of its tile: R-wide dots with float4 shared-memory loads, one
// (row, key) pair a thread.  The 16 x DV accumulator lives in registers
// (DV / 256 columns of every row a thread), the (m, l) state in shared
// memory.  q's (query, head) rows are contiguous in (B, Q, Hq, R), so a
// tile is 16 consecutive rows.  A page wholly past the valid range is
// skipped by position before its table entry is read; an id outside the
// pool inside the range stops the kernel.  Still simple: fp32 FMAs on the
// CUDA cores (no mma / wgmma), no TMA, and the Q x Hq / 16 tiles of a
// slot each read its pages (L2 keeps the repeats off HBM).
template <typename T, int R, int DV>
__global__ void __launch_bounds__(ML_NT) mla_latent_sweep_kernel(
    const T* __restrict__ q, const T* __restrict__ pool,
    const T* __restrict__ pend, const int* __restrict__ block_tables,
    const int* __restrict__ pos_arr, T* __restrict__ out,
    float* __restrict__ partial, float* __restrict__ lse, int Q, int Hq,
    int P, int ps, int nb, int n_splits, int ppb, int kt, int verify,
    float logit_cap, float scale) {
  static_assert(R % 8 == 0 && DV % ML_NT == 0 && DV <= R, "shape");
  constexpr int LD = R + 4;
  constexpr int CPT = DV / ML_NT;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // ML_ROWS x LD
  float* ks = qs + ML_ROWS * LD;           // kt x LD
  float* pr = ks + kt * LD;                // ML_ROWS x kt
  float* ms = pr + ML_ROWS * kt;
  float* ls = ms + ML_ROWS;
  float* cs = ls + ML_ROWS;

  const int s = blockIdx.y, b = blockIdx.z;
  const int n_rows = Q * Hq;
  const int r0 = blockIdx.x * ML_ROWS;
  const int live = min(ML_ROWS, n_rows - r0);
  load_latent<T, R>(q + ((long)b * n_rows + r0) * R, ML_ROWS, live, qs);
  if (threadIdx.x < ML_ROWS) {
    ms[threadIdx.x] = NEG_INF;
    ls[threadIdx.x] = 0.f;
  }
  float acc[ML_ROWS][CPT];
#pragma unroll
  for (int rr = 0; rr < ML_ROWS; ++rr)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[rr][c] = 0.f;
  __syncthreads();

  const int pos = pos_arr[b];
  const int hi_valid = verify ? pos - 1 : pos;
  const int j0 = s * ppb;
  const int j1 = min(j0 + ppb, nb);
  for (int j = j0; j < j1; ++j) {
    const int k0 = j * ps;
    if (k0 > hi_valid) break;              // block-uniform
    // a column inside the request's length must name a page of the pool:
    // skipping a bad id would drop its rows without a word, so the kernel
    // stops instead, and the launch fails at the next synchronisation
    const int page = block_tables[(long)b * nb + j];
    if (page < 0 || page >= P) __trap();
    load_latent<T, R>(pool + (long)page * ps * R, ps, ps, ks);
    __syncthreads();
    latent_update<R, DV>(qs, ks, pr, ms, ls, cs, acc, ps, kt,
                         verify ? ML_VERIFY : ML_DECODE, k0, pos, r0, Hq,
                         logit_cap, scale);
  }
  if (verify && s == n_splits - 1) {
    // the pending rows fold into the last split only
    load_latent<T, R>(pend + (long)b * Q * R, Q, Q, ks);
    __syncthreads();
    latent_update<R, DV>(qs, ks, pr, ms, ls, cs, acc, Q, kt, ML_PENDING, 0,
                         pos, r0, Hq, logit_cap, scale);
  }

#pragma unroll
  for (int rr = 0; rr < ML_ROWS; ++rr) {
    if (rr >= live) continue;          // rows past Q x Hq: never written
    const int r = r0 + rr;
    const float l = ls[rr];
    const float den = fmaxf(l, 1e-30f);
    if (n_splits == 1) {
      T* o = out + ((long)b * n_rows + r) * DV;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        store(o + threadIdx.x + ML_NT * c, acc[rr][c] / den);
    } else {
      const int i = r / Hq, h = r - i * Hq;
      const long cell = (((long)b * Hq + h) * n_splits + s) * Q + i;
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        partial[cell * DV + threadIdx.x + ML_NT * c] = acc[rr][c] / den;
      if (threadIdx.x == 0)
        lse[cell] = l > 0.f ? ms[rr] + logf(den) : NEG_INF;
    }
  }
}

template <typename T, int R, int DV>
int launch_mla(const void* q, const void* pool, const void* pend,
               const int* bt, const int* pos, void* out, float* partial,
               float* lse, int B, int Q, int Hq, int P, int ps, int nb,
               int n_splits, int ppb, int verify, float logit_cap,
               float scale, cudaStream_t stream) {
  const int kt = (verify && Q > ps) ? Q : ps;
  const size_t smem = mla_smem_bytes<R>(kt);
  auto kern = mla_latent_sweep_kernel<T, R, DV>;
  // the largest amount asked so far, so that a launch inside a CUDA-graph
  // capture makes no attribute call once the shape has run before
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  dim3 grid((Q * Hq + ML_ROWS - 1) / ML_ROWS, n_splits, B);
  kern<<<grid, ML_NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(pool),
      static_cast<const T*>(pend), bt, pos, static_cast<T*>(out), partial,
      lse, Q, Hq, P, ps, nb, n_splits, ppb, kt, verify, logit_cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pool, pending rows and out share
// it).  q (B, Q, Hq, R), pool (P, ps, R), pend (B, Q, R) (verify only),
// block_tables (B, nb) and pos (B,) int32.  n_splits == 1 writes out
// (B, Q, Hq, Dv); otherwise partial (B, Hq, S, Q, Dv) and lse (B, Hq, S, Q),
// fp32.  (R, Dv) = (576, 512): deepseek-v2's kv_lora_rank 512 + rope 64.
extern "C" int mla_latent_sweep(
    const void* q, const void* pool, const void* pend,
    const void* block_tables, const void* pos, void* out, void* partial,
    void* lse, int B, int Q, int Hq, int P, int ps, int nb, int R, int Dv,
    int n_splits, int ppb, int verify, float logit_cap, float scale,
    int dtype, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* pp = static_cast<const int*>(pos);
  float* part = static_cast<float*>(partial);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Q < 1 || Hq < 1 || ps < 1 || nb < 1 || n_splits < 1)
    return (int)cudaErrorInvalidValue;
  if (R == 576 && Dv == 512 && dtype == 1)
    return launch_mla<__nv_bfloat16, 576, 512>(q, pool, pend, bt, pp, out,
        part, lp, B, Q, Hq, P, ps, nb, n_splits, ppb, verify, logit_cap,
        scale, st);
  if (R == 576 && Dv == 512 && dtype == 0)
    return launch_mla<float, 576, 512>(q, pool, pend, bt, pp, out, part, lp,
        B, Q, Hq, P, ps, nb, n_splits, ppb, verify, logit_cap, scale, st);
  return (int)cudaErrorInvalidValue;
}
