// Absorbed-MLA latent sweep for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (src/repro_torch/kernels/build.py builds it into
// the port's kernel library, src/repro_torch/kernels/decode_attention.py
// wraps it).
//
//   mla_latent_sweep      stage 1 of deepseek-v2's absorbed MLA attention
//                         over a paged latent pool (P, ps, R), R = r_kv +
//                         d_rope: every (query, head) row [q_abs | q_rope]
//                         scores the whole R-wide latent row of each key,
//                         and the value is the same row's first DV lanes
//                         (the compressed c_kv); online softmax in fp32.
//                         Decode (one query row per head) or verify (Q rows
//                         at pos .. pos + Q - 1 over the pool rows k_pos <
//                         pos, then the Q pending latent rows folded
//                         causally, j <= i).  bf16 runs on the tensor
//                         cores, fp32 on the CUDA cores.  Stage 2, the
//                         merge, runs in the split's last block when
//                         counters are given (merge_tail,
//                         sweep_fragments.cuh), else it is
//                         paged_attention.cu's lse_merge.
//   mla_latent_occupancy  blocks per SM, dynamic shared memory and
//                         registers of one form (dtype, rows a block).
//
// They launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so that a refused launch is reported.
#include <math.h>

#include "attention_common.cuh"
#include "sweep_fragments.cuh"
#include "tensor_core.cuh"

namespace {

// ==========================================================================
// fp32: the CUDA-core kernel
// ==========================================================================
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

// Replaces, from src/repro/kernels/decode_attention.py, in fp32 (the bf16
// form is mla_latent_mma_kernel below):
//   mla_paged_decode_attention_pallas           (:1483, kernel :1348)
//   mla_paged_decode_attention_pallas_partials  (:1419, kernel :1380)
// and serves paged_verify_attention_pallas (:970) / its _partials (:877)
// in the MLA form mla_verify_paged gives them (Hkv 1, D = R, Dv = r_kv,
// v a leading slice of k's rows).
// Design: one block per (tile of 16 (query, head) rows, split, batch row)
// walks its split's contiguous page slice in a loop (the TPU's sequential
// grid axis), loading each page's ps x R latent rows into shared memory
// once and scoring them against all 16 rows of its tile: R-wide dots with
// float4 shared-memory loads, one (row, key) pair a thread.  The 16 x DV
// accumulator lives in registers (DV / 256 columns of every row a
// thread), the (m, l) state in shared memory.  q's (query, head) rows are
// contiguous in (B, Q, Hq, R), so a tile is 16 consecutive rows.  A page
// wholly past the valid range is skipped by position before its table
// entry is read; an id outside the pool inside the range stops the
// kernel.  fp32 is what the exact-stream gates run, and stays on the CUDA
// cores.  Split, with counters (one int a (batch row, row tile)), the last
// block of a row tile merges its splits (merge_tail).
template <typename T, int R, int DV>
__global__ void __launch_bounds__(ML_NT) mla_latent_sweep_kernel(
    const T* __restrict__ q, const T* __restrict__ pool,
    const T* __restrict__ pend, const int* __restrict__ block_tables,
    const int* __restrict__ pos_arr, T* __restrict__ out,
    float* __restrict__ partial, float* __restrict__ lse,
    int* __restrict__ counters, int Q, int Hq, int P, int ps, int nb,
    int n_splits, int ppb, int kt, int verify, float logit_cap,
    float scale) {
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
  // split, with counters: the merge K2b folded in, as the GQA sweep's
  if (n_splits > 1 && counters != nullptr)
    merge_tail<T, DV>(counters + (long)b * gridDim.x + blockIdx.x, partial,
                      lse, out, live, r0, Hq, 0, b, Q, Hq, n_splits);
}

// opt the fp32 kernel into dynamic shared memory for kt key rows: the
// largest amount asked so far, so that a launch inside a CUDA-graph
// capture makes no attribute call once the shape has run before
cudaError_t mla_fp32_opt_in(int kt) {
  static size_t smem_set = 48 * 1024;
  const size_t smem = mla_smem_bytes<576>(kt);
  if (smem <= smem_set) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      mla_latent_sweep_kernel<float, 576, 512>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) smem_set = smem;
  return e;
}

// ==========================================================================
// bf16: the tensor-core kernel
// ==========================================================================
constexpr int MR = 576;             // a latent row: r_kv 512 + rope 64
constexpr int MDV = 512;            // the value: the row's first 512 lanes
constexpr int MKEYS = 16;           // keys a tile: one k16 step of p.v
constexpr int MWD = 4;              // warps a 16-row tile: the value split
constexpr int MCOLS = MDV / MWD;    // value columns a warp
constexpr int MLD = tc_ld(MR);      // the row stride of a bf16 tile (584)
constexpr int MSTEPS = MR / 16;     // q.k's k16 steps over a latent row
constexpr int MSTAGES = 3;          // the latent ring's tiles
// the warps of a 16-row tile among which q.k's 36 k16 steps are divided
// (each sums the others' partial scores); 1: every warp computes the
// whole score tile itself
constexpr int ML_KSPLIT = 4;

// The shapes and shared memory of the bf16 kernel at MT 16-row tiles a
// block: the q tile, the latent ring (each tile is k for q.k and, its
// first 512 columns, v for p.v) and, for a divided q.k, every warp's
// partial 16 x 16 scores of two tiles, in fragment order.  At the end the
// same memory stages each warp's bf16 output rows.
template <int MT>
struct MlaForm {
  static_assert(MSTEPS % ML_KSPLIT == 0, "whole k16 steps a warp");
  static constexpr int NT = 32 * MWD * MT;
  static constexpr size_t QTILE = (size_t)MT * 16 * MLD * 2;
  static constexpr size_t STAGE = (size_t)MKEYS * MLD * 2;
  static constexpr size_t XBUF = ML_KSPLIT > 1
                                 ? (size_t)2 * MT * MWD * 64 * 16 : 0;
  static constexpr size_t WORK = QTILE + MSTAGES * STAGE + XBUF;
  // a warp's staged 16 x 128 bf16 output slice
  static constexpr size_t OUT = 16 * (MCOLS + 8) * 2;
  static constexpr size_t SMEM = WORK > MT * MWD * OUT ? WORK
                                                        : MT * MWD * OUT;
};

// A warp's 16 rows x 128 value columns (col0 ..) as the sweep's result,
// normalised by 1 / l (one reciprocal a row).  One split writes out (B, Q,
// Hq, 512) in bf16: staged in buf (the warp's own, once the block is done
// with its tiles) and stored 16 bytes a lane, each row's 128 columns
// contiguous (straight from the fragments a quad would store 16 bytes of a
// row at a time).  Several write the fp32 partial (B, Hq, S, Q, 512)
// straight from the fragments (a quad's four float2 fill a 32-byte
// sector) and, from the slice at col0 0, lse (B, Hq, S, Q), NEG_INF where
// l == 0 (a split with no key: its partial is 0).  Row r is (query, head)
// row row0 + r; rows from live on are never written.
__device__ void write_slice(const FragRows<MCOLS / 8, true>& st,
                            __nv_bfloat16* buf,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ partial,
                            float* __restrict__ lse, int live, int row0,
                            int col0, int Q, int Hq, int b, int s,
                            int n_splits) {
  constexpr int LD = MCOLS + 8;      // odd 16-byte chunks a staged row
  constexpr int LPR = MCOLS / 8;     // lanes a row, 8 bf16 a lane
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 8 * h + (lane >> 2);
    const float inv = 1.f / fmaxf(st.l[h], 1e-30f);
    if (n_splits == 1) {
#pragma unroll
      for (int n = 0; n < MCOLS / 8; ++n)
        store2(buf + r * LD + 8 * n + 2 * (lane & 3), st.o[n][2 * h] * inv,
               st.o[n][2 * h + 1] * inv);
      continue;
    }
    if (r >= live) continue;
    const int rr = row0 + r, i = rr / Hq;
    const long cell = (((long)b * Hq + rr - i * Hq) * n_splits + s) * Q + i;
    float* o = partial + cell * MDV + col0 + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < MCOLS / 8; ++n)
      store2(o + 8 * n, st.o[n][2 * h] * inv, st.o[n][2 * h + 1] * inv);
    if (col0 == 0 && (lane & 3) == 0)
      lse[cell] = st.l[h] > 0.f ? st.m[h] + logf(fmaxf(st.l[h], 1e-30f))
                                : NEG_INF;
  }
  if (n_splits > 1) return;
  __syncwarp();
  for (int idx = lane; idx < 16 * LPR; idx += 32) {
    const int r = idx / LPR, c = (idx - r * LPR) * 8;
    if (r >= live) break;
    *reinterpret_cast<uint4*>(out + ((long)b * Q * Hq + row0 + r) * MDV
                              + col0 + c) =
        *reinterpret_cast<const uint4*>(buf + r * LD + c);
  }
}

// Replaces, from src/repro/kernels/decode_attention.py, in bf16:
//   mla_paged_decode_attention_pallas           (:1483, kernel :1348)
//   mla_paged_decode_attention_pallas_partials  (:1419, kernel :1380)
// and serves paged_verify_attention_pallas (:970) / its _partials (:877)
// in the MLA form mla_verify_paged gives them.
// What bounds it: at decode, bytes (each 1152-byte latent row feeds 128
// heads, about 2 x 128 x 1088 / 1152 = 240 FLOP a byte, under the ~295
// where the tensor cores would bind), and at the engine's shapes the
// latency of a block's chain; at verify, q's and the output's bytes (Q x
// Hq rows of 1152 and 1024 bytes against a few pages).  Design:
// - One block per (MT tiles of 16 (query, head) rows, split, batch row).
//   q's rows are contiguous in (B, Q, Hq, R), so a block is 16 MT
//   consecutive rows; rows past Q x Hq are zero q and never stored.  The
//   TPU kernel keeps all 128 heads of a slot in one tile, whose 128 x 512
//   fp32 accumulator does not fit a block; here every latent tile a block
//   loads feeds 16 MT rows, MT 1 or 2 chosen at launch (mla_row_tiles;
//   blocks of 64 rows, one an SM at 128 registers a thread, were slower at
//   every engine shape).
// - The value split across warps: 16 rows x 512 fp32 accumulators are
//   256 registers a thread in one warp, past the 255 a thread may have.
//   So 4 warps share a 16-row tile, each holding 128 columns of it (64
//   accumulators, FragRows in mma fragments), and each computes a quarter
//   of q.k (9 of its 36 k16 steps); the four partial score tiles meet in
//   shared memory at the tile's one block barrier, and every warp sums
//   them in the same order, so all four run the same online softmax on
//   the same scores and apply the same p.
// - bf16 on the tensor cores (mma.sync m16n8k16, ldmatrix): q.k^T of a
//   16-key tile is two n8 tiles a k16 step; p.v one k16 step over the
//   warp's 16 n8 tiles, read through ldmatrix.trans from the same latent
//   tile's first 512 columns (rows 584 bf16 apart: conflict-free).  p
//   enters p.v as two bf16 terms, hi + lo (about 16 bits of p), as in the
//   paged sweep.  Nothing is widened to fp32 in shared memory.
// - The keys: the split's valid key range in tiles of 16 consecutive
//   positions (a tile may span pages of 8, or take one of two of a page of
//   32), then, at a verify's last split, the pending rows in tiles of 16,
//   up to the block's last query index: any Q fits.  A page holding no
//   valid key is skipped, its table entry never read, its keys weigh
//   nothing (-inf); a masked key inside a page that runs is NEG_INF, as in
//   the reference.  An id outside the pool inside the request's length
//   stops the kernel (__trap).
// - A cp.async ring of three latent tiles shared by the block: each
//   thread copies a share of one key's row (its page id read one tile
//   ahead), and tile t + 2's copies are issued after tile t's barrier,
//   before its products.  One block barrier a tile: it lands tile t + 1,
//   frees tile t - 1's stage and publishes tile t's partial scores.  (A
//   fourth tile, copies issued three tiles ahead, gained nothing at 16
//   rows a block and cost 32-row blocks their second block an SM.)
// - The epilogue (write_slice): each warp stages its rows' 128 bf16
//   columns in shared memory and stores them 16 bytes a lane; fp32
//   partials go straight from the fragments.  Split, with counters (one
//   int a (batch row, block of rows)), the block meets once every slice
//   (the col0 0 one with the lse) is written, and the last of the S merges
//   them (merge_tail: all the block's threads, each four float4 columns
//   of a row at a time in blocks of 16 rows, two in blocks of 32).
template <int MT>
__global__ void __launch_bounds__(MlaForm<MT>::NT) mla_latent_mma_kernel(
    const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ pool,
    const __nv_bfloat16* __restrict__ pend,
    const int* __restrict__ block_tables, const int* __restrict__ pos_arr,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
    float* __restrict__ lse, int* __restrict__ counters, int Q, int Hq,
    int P, int ps, int nb, int n_splits, int ppb, int verify,
    float logit_cap, float scale) {
  using F = MlaForm<MT>;
  using T = __nv_bfloat16;
  constexpr int ROWS = 16 * MT;
  constexpr int VN = 8;                    // bf16 values a 16-byte copy
  constexpr int CH = MR / VN;              // 16-byte copies a latent row
  constexpr int TPK = F::NT / MKEYS;       // threads copying one key's row
  constexpr int KS = MSTEPS / ML_KSPLIT;   // q.k's k16 steps a warp
  extern __shared__ __align__(16) unsigned char ml_smem[];
  T* qs = reinterpret_cast<T*>(ml_smem);
  T* ring = reinterpret_cast<T*>(ml_smem + F::QTILE);
  float4* xbuf = reinterpret_cast<float4*>(ml_smem + F::QTILE
                                           + MSTAGES * F::STAGE);

  const int s = blockIdx.y, b = blockIdx.z;
  const int n_rows = Q * Hq;
  const int r0 = blockIdx.x * ROWS;
  const int live = min(ROWS, n_rows - r0);      // rows backed by a q row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mt = warp / MWD, wd = warp - mt * MWD;
  const int pos = pos_arr[b];                   // in flight during q's copies

  // the q tile: row r = (query, head) row r0 + r
  const T* qb = q + ((long)b * n_rows + r0) * MR;
  for (int c = tid; c < ROWS * CH; c += F::NT) {
    const int r = c / CH, ch = c - r * CH;
    const bool ok = r < live;
    cp_async16(qs + r * MLD + ch * VN, ok ? qb + (long)r * MR + ch * VN : q,
               ok);
  }
  cp_async_commit();

  // the split's keys: the valid range [0, hi_u] widened to whole pages
  // and cut to this split's, [kr0, kr1], then the pending tiles up to the
  // block's last query index
  const int hi_u = verify ? pos - 1 : pos;
  const int j0 = s * ppb, j1 = min(j0 + ppb, nb);
  const int kr0 = j0 * ps;
  const int kr1 = hi_u >= 0 ? min(j1 * ps, (hi_u / ps + 1) * ps) - 1 : -1;
  const int n_pool = kr1 >= kr0 ? (kr1 - kr0) / MKEYS + 1 : 0;
  const int i_last = (r0 + live - 1) / Hq;
  const int n_cand = verify && s == n_splits - 1 ? i_last / MKEYS + 1 : 0;
  const int n_items = n_pool + n_cand;
  const int full_hi = min(kr1, hi_u);  // pool keys valid for every row

  // this thread copies copies kc, kc + TPK, ... of key row kr of a tile;
  // page(t) is the table entry of its key of pool tile t (-1 where t is
  // no pool tile or the key lies past kr1: such entries are never read)
  const int kr = tid / TPK, kc = tid - kr * TPK;
  auto page = [&](int t) {
    const int kp = kr0 + t * MKEYS + kr;
    return t < n_pool && kp <= kr1 ? block_tables[(long)b * nb + kp / ps]
                                   : -1;
  };
  // tile t's copies into stage sg, its key's page id pg
  auto issue = [&](int t, int sg, int pg) {
    const T* src = pool;
    bool ok;
    if (t < n_pool) {
      const int kp = kr0 + t * MKEYS + kr;
      ok = kp <= kr1;
      if (ok) {
        // a column inside the request's length must name a page of the
        // pool: the kernel stops rather than drop its rows
        if (pg < 0 || pg >= P) __trap();
        src = pool + ((long)pg * ps + kp % ps) * MR;
      }
    } else {
      const int j = (t - n_pool) * MKEYS + kr;
      ok = j < Q;
      if (ok) src = pend + ((long)b * Q + j) * MR;
    }
    T* dst = ring + (sg * MKEYS + kr) * MLD;
    for (int ch = kc; ch < CH; ch += TPK)
      cp_async16(dst + ch * VN, ok ? src + ch * VN : pool, ok);
  };

  // tiles 0 .. MSTAGES - 2 join the q tile's copies, each its own group;
  // the next tile's page id is read
  int pgs[MSTAGES - 1];
#pragma unroll
  for (int t = 0; t < MSTAGES - 1; ++t) pgs[t] = page(t);
#pragma unroll
  for (int t = 0; t < MSTAGES - 1; ++t) {
    if (t < n_items) issue(t, t, pgs[t]);
    cp_async_commit();
  }
  int pg_next = page(MSTAGES - 1);

  // this thread's rows 8 h + lane / 4 of its 16-row tile are queries qi[h]
  int qi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    qi[h] = (r0 + mt * 16 + 8 * h + (lane >> 2)) / Hq;
  FragRows<MCOLS / 8, true> st;
  st.init();
  const int k_off = (ML_KSPLIT > 1 ? wd * KS : 0) * 16;   // its q.k columns
  const T* qrow = qs + (mt * 16 + (lane & 7) + (lane & 8)) * MLD
                  + (lane >> 4) * 8 + k_off;
  float4* xmine = xbuf + warp * 64;
  const float4* xtile = xbuf + mt * MWD * 64;
  constexpr int XPAR = MT * MWD * 64;           // float4s of one tile's xbuf

  cp_async_wait<MSTAGES - 2>();
  __syncthreads();                // the q tile and tile 0 have landed
  for (int t = 0; t < n_items; ++t) {
    const int sg = t % MSTAGES;
    const T* kt = ring + sg * MKEYS * MLD;
    float s_[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) s_[n][0] = s_[n][1] = s_[n][2] = s_[n][3] = 0.f;
    // this warp's share of s = q . k^T
    const T* krow = kt + ((lane & 7) + (lane >> 4) * 8) * MLD + (lane & 8)
                    + k_off;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], bk[4];
      ldmatrix_x4(a, qrow + kk * 16);
      ldmatrix_x4(bk, krow + kk * 16);
      mma_bf16_16816(s_[0], a, bk[0], bk[1]);
      mma_bf16_16816(s_[1], a, bk[2], bk[3]);
    }
    const int par = (t & 1) * XPAR;
    if constexpr (ML_KSPLIT > 1) {
      xmine[par + lane] = make_float4(s_[0][0], s_[0][1], s_[0][2], s_[0][3]);
      xmine[par + 32 + lane] =
          make_float4(s_[1][0], s_[1][1], s_[1][2], s_[1][3]);
    }
    cp_async_wait<MSTAGES - 3>();  // tile t + 1 has landed for this thread
    __syncthreads();              // ... for all; tile t - 1's stage is free
    if (t + MSTAGES - 1 < n_items) {
      issue(t + MSTAGES - 1, (t + MSTAGES - 1) % MSTAGES, pg_next);
      pg_next = page(t + MSTAGES);
    }
    cp_async_commit();
    if constexpr (ML_KSPLIT > 1) {
      // the tile's four partial score tiles, summed in warp order
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        s_[n][0] = s_[n][1] = s_[n][2] = s_[n][3] = 0.f;
#pragma unroll
        for (int w = 0; w < MWD; ++w) {
          const float4 x = xtile[par + w * 64 + 32 * n + lane];
          s_[n][0] += x.x; s_[n][1] += x.y; s_[n][2] += x.z; s_[n][3] += x.w;
        }
      }
    }
    // scale, soft-cap, mask: element e of n8 tile n is key kb + 8 n + (e &
    // 1); keys past the sweep's (kr1, or the last pending row) weigh
    // nothing (-inf), keys past a row's last valid one are NEG_INF
    const bool pool_t = t < n_pool;
    const int k0 = pool_t ? kr0 + t * MKEYS : (t - n_pool) * MKEYS;
    const bool full = pool_t && k0 + MKEYS - 1 <= full_hi;
    const int kb = k0 + 2 * (lane & 3);
    const int in_hi = (pool_t ? kr1 : Q - 1) - kb;
    int hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) hi[h] = (pool_t ? hi_u : qi[h]) - kb;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = 8 * n + (e & 1);
        float x = s_[n][e] * scale;
        if (logit_cap > 0.f) x = logit_cap * tanhf(x / logit_cap);
        s_[n][e] = full ? x
                   : kk > in_hi ? -INFINITY
                   : kk <= hi[e >> 1] ? x : NEG_INF;
      }
    st.update(s_);
    // o += p . v over this warp's 128 columns, p as hi + lo bf16 A
    // fragments straight from the score registers
    uint32_t a[2][4];
    split_bf16(s_[0][0], s_[0][1], a[0][0], a[1][0]);
    split_bf16(s_[0][2], s_[0][3], a[0][1], a[1][1]);
    split_bf16(s_[1][0], s_[1][1], a[0][2], a[1][2]);
    split_bf16(s_[1][2], s_[1][3], a[0][3], a[1][3]);
    const T* vrow = kt + ((lane & 7) + (lane & 8)) * MLD + wd * MCOLS
                    + (lane >> 4) * 8;
#pragma unroll
    for (int nn = 0; nn < MCOLS / 16; ++nn) {
      uint32_t bv[4];
      ldmatrix_x4_trans(bv, vrow + nn * 16);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mma_bf16_16816(st.o[2 * nn], a[x], bv[0], bv[1]);
        mma_bf16_16816(st.o[2 * nn + 1], a[x], bv[2], bv[3]);
      }
    }
  }
  cp_async_wait<0>();
  if (n_splits == 1) __syncthreads();   // every warp is done with the tiles
  write_slice(st, reinterpret_cast<T*>(ml_smem + warp * F::OUT), out,
              partial, lse, live - mt * 16, r0 + mt * 16, wd * MCOLS, Q, Hq,
              b, s, n_splits);
  if (n_splits > 1 && counters != nullptr)
    merge_tail<T, MDV, MT == 1 ? 4 : MERGE_EPT>(
        counters + (long)b * gridDim.x + blockIdx.x, partial, lse, out, live,
        r0, Hq, 0, b, Q, Hq, n_splits);
}

struct MlaArgs {
  const void *q, *pool, *pend;
  const int *bt, *pos;
  void* out;
  float *partial, *lse;
  int* counters;
  int B, Q, Hq, P, ps, nb, n_splits, ppb, verify;
  float logit_cap, scale;
  cudaStream_t stream;
};

// The bf16 kernel at MT 16-row tiles a block: its launch and occupancy
template <int MT>
struct MlaMma {
  using F = MlaForm<MT>;
  static_assert(F::SMEM <= 232448, "a Hopper block's shared memory");
  static auto kernel() { return mla_latent_mma_kernel<MT>; }

  // opt the kernel into its dynamic shared memory, once, so that a launch
  // inside a CUDA-graph capture makes no attribute call
  static cudaError_t opt_in() {
    static bool done = false;
    if (done) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)F::SMEM);
    done = e == cudaSuccess;
    return e;
  }

  static int run(const MlaArgs& a) {
    const cudaError_t e = opt_in();
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((a.Q * a.Hq + 16 * MT - 1) / (16 * MT), a.n_splits, a.B);
    kernel()<<<grid, F::NT, F::SMEM, a.stream>>>(
        static_cast<const __nv_bfloat16*>(a.q),
        static_cast<const __nv_bfloat16*>(a.pool),
        static_cast<const __nv_bfloat16*>(a.pend), a.bt, a.pos,
        static_cast<__nv_bfloat16*>(a.out), a.partial, a.lse, a.counters,
        a.Q, a.Hq, a.P, a.ps, a.nb, a.n_splits, a.ppb, a.verify, a.logit_cap,
        a.scale);
    return (int)cudaGetLastError();
  }

  static int occupancy(int* info) {
    cudaError_t e = opt_in();
    cudaFuncAttributes attr;
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel());
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &info[0], kernel(), F::NT, F::SMEM);
    info[1] = (int)F::SMEM;
    info[2] = e == cudaSuccess ? attr.numRegs : 0;
    return (int)e;
  }
};

// The 16-row tiles a bf16 block takes: 2 where that still gives each of
// the card's 132 SMs a block, so that a latent tile in shared memory feeds
// twice the rows, else 1
int mla_row_tiles(int B, int Q, int Hq, int n_splits) {
  const long tiles = (Q * Hq + 15) / 16;
  return (tiles + 1) / 2 * n_splits * B >= 132 ? 2 : 1;
}

// op(MlaMma<MT>()) for MT 1 or 2; else invalid-value
template <typename Op>
int mla_form(int mt, Op&& op) {
  switch (mt) {
    case 1: return op(MlaMma<1>());
    case 2: return op(MlaMma<2>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pool, pending rows and out share
// it).  q (B, Q, Hq, R), pool (P, ps, R), pend (B, Q, R) (verify only),
// block_tables (B, nb) and pos (B,) int32.  n_splits == 1 writes out
// (B, Q, Hq, Dv); otherwise partial (B, Hq, S, Q, Dv) and lse (B, Hq, S, Q),
// fp32, and, with counters (int32, one a (batch row, 16-row tile), all
// zero; zero again after the launch), also the merged out (B, Q, Hq, Dv)
// in the query dtype.  (R, Dv) = (576, 512): deepseek-v2's kv_lora_rank
// 512 + rope 64.
extern "C" int mla_latent_sweep(
    const void* q, const void* pool, const void* pend,
    const void* block_tables, const void* pos, void* out, void* partial,
    void* lse, void* counters, int B, int Q, int Hq, int P, int ps, int nb,
    int R, int Dv, int n_splits, int ppb, int verify, float logit_cap,
    float scale, int dtype, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* pp = static_cast<const int*>(pos);
  float* part = static_cast<float*>(partial);
  float* lp = static_cast<float*>(lse);
  int* cnt = static_cast<int*>(counters);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || Q < 1 || Hq < 1 || ps < 1 || nb < 1 || n_splits < 1
      || ppb < 1 || R != 576 || Dv != 512
      || (cnt != nullptr && n_splits > 1 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    const MlaArgs a{q, pool, pend, bt, pp, out, part, lp, cnt, B, Q, Hq, P,
                    ps, nb, n_splits, ppb, verify, logit_cap, scale, st};
    return mla_form(mla_row_tiles(B, Q, Hq, n_splits),
                    [&](auto form) { return decltype(form)::run(a); });
  }
  if (dtype == 0) {
    const int kt = (verify && Q > ps) ? Q : ps;
    const cudaError_t e = mla_fp32_opt_in(kt);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Q * Hq + ML_ROWS - 1) / ML_ROWS, n_splits, B);
    mla_latent_sweep_kernel<float, 576, 512>
        <<<grid, ML_NT, mla_smem_bytes<576>(kt), st>>>(
            static_cast<const float*>(q), static_cast<const float*>(pool),
            static_cast<const float*>(pend), bt, pp,
            static_cast<float*>(out), part, lp, cnt, Q, Hq, P, ps, nb,
            n_splits, ppb, kt, verify, logit_cap, scale);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// info[3] = {blocks per SM, dynamic shared memory bytes, registers a
// thread} of the latent sweep's kernel for dtype (0 = float32: the CUDA-
// core kernel at 16 key rows; 1 = bfloat16: the tensor-core kernel at
// rows (query, head) rows a block, 16 or 32)
extern "C" int mla_latent_occupancy(int dtype, int rows, int* info) {
  if (dtype == 1 && rows % 16 == 0)
    return mla_form(rows / 16, [&](auto form) {
      return decltype(form)::occupancy(info);
    });
  if (dtype != 0 || rows != ML_ROWS) return (int)cudaErrorInvalidValue;
  auto kern = mla_latent_sweep_kernel<float, 576, 512>;
  const size_t smem = mla_smem_bytes<576>(16);
  cudaError_t e = mla_fp32_opt_in(16);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kern, ML_NT,
                                                      smem);
  info[1] = (int)smem;
  info[2] = e == cudaSuccess ? attr.numRegs : 0;
  return (int)e;
}
