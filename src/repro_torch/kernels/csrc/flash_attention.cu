// Prefill flash attention for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (src/repro_torch/kernels/build.py builds it into
// the port's kernel library, src/repro_torch/kernels/flash_attention.py
// wraps it).
//
//   flash_attention_fwd        forward GQA attention of a whole prompt: q
//                              (B, Sq, Hq, D) against k (B, Sk, Hkv, D) and
//                              v (B, Sk, Hkv, Dv), out (B, Sq, Hq, Dv) in
//                              q's dtype; fp32 online softmax; causal,
//                              sliding window, tanh soft-cap (before the
//                              mask), any query scale, q_offset.  (D, Dv) is
//                              (64, 64), h2o-danube's (120, 120), (128, 128)
//                              or deepseek-v2's MLA prefill (192, 128):
//                              [nope | rope] q/k, v 128.  bf16 runs on the
//                              tensor cores, fp32 on the CUDA cores.
//                              Given a non-null lse, it also writes each
//                              row's log-sum-exp (fp32 (B, Hq, Sq), natural
//                              log, in the scaled, soft-capped logit
//                              domain), which the backward kernels of
//                              flash_attention_bwd.cu recompute p from.
//   flash_attention_occupancy  blocks per SM, dynamic shared memory and
//                              registers of one (D, Dv, dtype) form.
//
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that a refused launch is reported.
#include <math.h>

#include <climits>

#include "attention_common.cuh"
#include "tensor_core.cuh"

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


// fp32 inputs: the CUDA-core kernel, kept for exact fp32 streams (no
// TF32).  One block per (batch, kv head, q tile) of 128 rows (q
// position i, head g) = row i * G + g, staged in shared memory as fp32;
// each thread holds 8 rows x 4 scores of a 64-key tile and 8 x ceil(Dv /
// 16) output columns (the last slot predicated where 16 does not divide
// Dv), p goes through shared memory, fp32 FMAs throughout.
//
// Rows that see no key (both kernels): with the reference's finite NEG_INF
// a row whose keys are all masked in every tile its block visits weighs
// each in-range key of those tiles equally (the mean of their v rows), as
// the Pallas kernel does over its own blocks; a row whose block visits no
// tile gets 0.
template <typename T, int HD, int HDV>
__global__ void __launch_bounds__(FA_NT) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, float* __restrict__ lse,
    int Sq, int Sk, int Hq, int Hkv, int bq, int causal, int window,
    int q_offset, float logit_cap, float scale) {
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
    if (lse != nullptr && cg == 0)
      lse[((long)b * Hq + hk * G + g) * Sq + q0 + i] = m[j] + logf(l[j]);
  }
}


// ---------------------------------------------------------------------------
// bf16 inputs: the tensor-core kernel
// ---------------------------------------------------------------------------
constexpr int TC_MT = 2;             // m16 row tiles per warp
constexpr int TC_NT = 32 * FA_ROWS / (16 * TC_MT);  // 4 warps
constexpr int TC_STAGES = 2;         // k/v tiles in the ring
constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the special-function unit (-inf gives 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) = 1 - 2 / (e^2y + 1): one ex2 and one reciprocal; +-1 where e^2y
// overflows or vanishes, about 1e-7 from tanh near 0
__device__ __forceinline__ float fast_tanh(float y) {
  return 1.f - __fdividef(2.f, __expf(2.f * y) + 1.f);
}

template <int HD, int HDV>
struct TcTile {
  static constexpr int DK = (HD + 15) / 16 * 16;  // q.k depth, k16 steps
  static constexpr int QLD = tc_ld(DK);           // q and k row strides
  static constexpr int VLD = tc_ld(HDV);          // v row stride
  // keys per k/v tile: 32 at D 192, whose 64-key ring would leave room
  // for one block an SM
  static constexpr int BK = HD > 128 ? 32 : 64;
  static constexpr size_t smem =
      2 * ((size_t)FA_ROWS * QLD + (size_t)TC_STAGES * BK * (QLD + VLD));
};
// (64, 64) 55,296 bytes; (120, 120) 100,352; (128, 128) 104,448; (192,
// 128) 94,208: two blocks fit a Hopper SM's 228 KB (1 KB each reserved)
static_assert(2 * (TcTile<128, 128>::smem + 1024) <= 233472
                  && 2 * (TcTile<192, 128>::smem + 1024) <= 233472,
              "K4: two blocks an SM");

// Replaces, from src/repro/kernels/flash_attention.py:
//   flash_attention  (:94, kernel _fa_kernel :36, pallas_call :130)
// What bounds it: at the main paths' prefill shapes the card needs about
// as long for the bytes as for the products.  gemma2's 4 x 512 (Hq 32,
// Hkv 16, D 128) moves 50.3 MB (q, k, v read once, out written once): 15.0
// us at 3.35 TB/s, against 8.6 GFLOP over the causal band, 8.7 us at the
// tensor cores' 989 TFLOP/s; on the CUDA cores' fp32 FMAs the same
// products need at least 128 us.  Design:
// - Both products on the tensor cores: mma.sync m16n8k16, bf16 in, fp32
//   accumulators, fed by ldmatrix (.trans for v, so no transposed copy).
// - One block per (batch, kv head, q tile), as in the fp32 kernel: 128
//   rows (q position i, head g) = row i * G + g, so every k/v tile is read
//   once per kv-head group; the G heads of a position are G * D
//   contiguous values of q, so the q tile is one strided copy.  128 / G
//   positions a block: 128 at G 1 (stablelm, deepseek), 64 at gemma2's 2,
//   18 and two dead rows at llava's G 7 (zero q, never stored: the mask is
//   per row, so an m16 tile need not line up with positions).  Longest
//   causal band first; only the k tiles the q range can see (causal end,
//   window start) are visited, and tiles wholly inside the band skip the
//   mask.
// - 4 warps of 32 rows, two m16 tiles each, so every k and v fragment
//   loaded from shared memory feeds two products (240 to 255 registers a
//   thread: two blocks an SM).  The scores (32 x 64 a warp) and the output
//   (32 x Dv) stay in mma accumulator fragments; scale, soft-cap (tanh,
//   fp32) and the causal / window / ragged mask act on them, each row with
//   its own position, the mask comparing constant key offsets against
//   each row's range; row max and sum are two quad shuffles; scores are
//   kept in log2 units, so p = 2^(x - m) is one ex2.  p becomes bf16 A
//   fragments in registers (the C fragments of two n8 score tiles are the
//   A fragment of one k16 step of p.v), so p never touches shared memory:
//   two of them, p = hi + lo, about 16 bits of p.  One bf16 rounding of p
//   moved outputs by a bf16 step against the fp32 p of the paged verify
//   sweep, which recomputes an evicted prefix, and that parted greedy
//   streams; the lo term costs the p.v products a second pass.
// - q, k and v stay bf16 in shared memory, copied with 16-byte cp.async:
//   q once, k/v through a ring of two stages, so tile t + 1 loads during
//   tile t's products, one barrier a tile.  Tiles of 64 keys, 32 at D 192
//   (two blocks an SM).  Rows past Sq or Sk are zero-filled by the copy
//   (source size 0), never read from the next batch's memory.  Rows are
//   padded to an odd count of 16-byte chunks (conflict-free ldmatrix).
//   The output goes back through the q tile's shared memory, so that it
//   leaves in 16-byte stores.
// - D 120 (h2o-danube): a row is 15 whole 16-byte copies; q.k runs 8 k16
//   steps, the last over columns 120..127 of the q and k tiles, zeroed
//   once when the block starts (the copies never write them), never in the
//   wrapper.  p.v at Dv 120 is 15 n8 tiles, so nothing is predicated.
// What still bounds it: latency.  With 8 warps an SM each block waits on
// its q tile and first k/v tile, and the warps of a block run their
// products and their softmax in step.  Not yet: wgmma (m64nNk16, b read
// by the tensor cores from shared memory), TMA copies and a producer warp.
template <int HD, int HDV>
__global__ void __launch_bounds__(TC_NT, 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ lse, int Sq, int Sk, int Hq,
                           int Hkv, int bq, int causal, int window,
                           int q_offset, float logit_cap, float scale) {
  using Tile = TcTile<HD, HDV>;
  constexpr int NT = TC_NT, MT = TC_MT, STAGES = TC_STAGES;
  constexpr int DK = Tile::DK, QLD = Tile::QLD, VLD = Tile::VLD;
  constexpr int BK = Tile::BK;
  constexpr int QCH = HD / 8;            // 16-byte chunks of a q / k row
  constexpr int VCH = HDV / 8;           // of a v row
  constexpr int NS = BK / 8;          // n8 tiles of a score row
  constexpr int NO = HDV / 8;            // n8 tiles of an output row
  static_assert(HD % 8 == 0 && HDV % 8 == 0,
                "q, k and v rows must be whole 16-byte copies");
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char fa_tc_smem[];
  bf16* qs = reinterpret_cast<bf16*>(fa_tc_smem);   // FA_ROWS x QLD
  bf16* ks = qs + FA_ROWS * QLD;                    // stages x BK x QLD
  bf16* vs = ks + STAGES * BK * QLD;          // stages x BK x VLD

  const int G = Hq / Hkv;
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal bands first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * bq;
  const int nq = min(bq, Sq - q0);             // q positions in this tile
  const int live = nq * G;                     // rows backed by a q row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // columns HD..DK-1 of the q and k tiles: zero for the last k16 step
  if constexpr (DK != HD) {
    constexpr int PAD = (DK - HD) / 8;
    for (int c = tid; c < (FA_ROWS + STAGES * BK) * PAD; c += NT) {
      const int r = c / PAD;
      *reinterpret_cast<uint4*>(qs + r * QLD + HD + (c - r * PAD) * 8) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // the q tile: row r = i * G + g at q[b, q0 + i, hk * G + g, :]
  const long q_row = (long)Hq * HD;            // q position stride
  const bf16* qb = q + ((long)b * Sq + q0) * q_row + (long)hk * G * HD;
  for (int c = tid; c < FA_ROWS * QCH; c += NT) {
    const int r = c / QCH, ch = c - r * QCH;
    const int i = r / G;
    const bool ok = r < live;
    cp_async16(qs + r * QLD + ch * 8,
               ok ? qb + i * q_row + (r - i * G) * HD + ch * 8 : q, ok);
  }

  const long k_row = (long)Hkv * HD, v_row = (long)Hkv * HDV;
  const bf16* kb = k + (long)b * Sk * k_row + (long)hk * HD;
  const bf16* vb = v + (long)b * Sk * v_row + (long)hk * HDV;
  // k/v tile t into stage st, committed as one group
  auto load_kv = [&](int t, int st) {
    const int k0 = t * BK;
    bf16* kd = ks + st * BK * QLD;
    bf16* vd = vs + st * BK * VLD;
    for (int c = tid; c < BK * QCH; c += NT) {
      const int r = c / QCH, ch = c - r * QCH;
      const bool ok = k0 + r < Sk;
      cp_async16(kd + r * QLD + ch * 8,
                 ok ? kb + (k0 + r) * k_row + ch * 8 : k, ok);
    }
    for (int c = tid; c < BK * VCH; c += NT) {
      const int r = c / VCH, ch = c - r * VCH;
      const bool ok = k0 + r < Sk;
      cp_async16(vd + r * VLD + ch * 8,
                 ok ? vb + (k0 + r) * v_row + ch * 8 : v, ok);
    }
    cp_async_commit();
  };

  // the k tiles the tile's q range [q_lo, q_hi] can see
  const int q_lo = q_offset + q0, q_hi = q_lo + nq - 1;
  const int k_hi = max(0, causal ? min(Sk, q_hi + 1) : Sk);
  const int k_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;
  // the ring's first STAGES - 1 tiles, the q tile in the first group; a
  // group is committed for every tile slot, empty past t_hi, so that
  // wait<STAGES - 2> below always means "tile t has landed"
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (t_lo + j < t_hi)
      load_kv(t_lo + j, j);
    else
      cp_async_commit();
  }

  // this warp's 16 MT rows from rw; this thread's rows rw + 16 mt + 8 h +
  // lane / 4 (m16 tile mt, half h) sit at positions qp[mt][h]
  const int rw = warp * 16 * MT;
  const bool warp_live = rw < live;
  int qp[MT][2];
  float o[MT][NO][4], m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qp[mt][h] = q_lo + (rw + 16 * mt + 8 * h + (lane >> 2)) / G;
      m[mt][h] = NEG_INF;
      l[mt][h] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  }
  // scores in log2 units, so that p = 2^(x - m) is one ex2: x = s * scale
  // * log2(e), or under the soft-cap cap * log2(e) * tanh(s * scale / cap)
  const float qk_mul = logit_cap > 0.f ? scale / logit_cap : scale * LOG2E;
  const float cap_mul = logit_cap * LOG2E;

  for (int t = t_lo, st = 0; t < t_hi; ++t, st = st + 1 < STAGES ? st + 1
                                                                    : 0) {
    cp_async_wait<STAGES - 2>();
    // tile t (and q) has landed for all, and all are done with tile t - 1,
    // whose stage now takes tile t + STAGES - 1
    __syncthreads();
    {
      const int tn = t + STAGES - 1;
      const int sn = st + STAGES - 1 < STAGES ? st + STAGES - 1
                                              : st - 1;
      if (tn < t_hi)
        load_kv(tn, sn);
      else
        cp_async_commit();
    }
    if (warp_live) {
      const int k0 = t * BK;
      const bf16* kt = ks + st * BK * QLD;
      const bf16* vt = vs + st * BK * VLD;
      // s = q . k^T over DK / 16 k16 steps; each k fragment feeds the MT
      // m16 tiles
      float s[MT][NS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int n = 0; n < NS; ++n)
          s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DK / 16; ++kk) {
        uint32_t a[MT][4], bk[NS / 2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          ldmatrix_x4(a[mt], qs + (rw + 16 * mt + (lane & 7) + (lane & 8))
                                  * QLD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int nn = 0; nn < NS / 2; ++nn)
          ldmatrix_x4(bk[nn], kt + (nn * 16 + (lane & 7) + (lane >> 4) * 8)
                                  * QLD + kk * 16 + (lane & 8));
#pragma unroll
        for (int nn = 0; nn < NS / 2; ++nn)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(s[mt][2 * nn], a[mt], bk[nn][0], bk[nn][1]);
            mma_bf16_16816(s[mt][2 * nn + 1], a[mt], bk[nn][2], bk[nn][3]);
          }
      }
      // scale and soft-cap, each loop branch-free; element e of n8 tile n
      // is row rw + 16 mt + 8 (e >> 1) + lane / 4, key k0 + 8 n + 2 (lane
      // % 4) + (e & 1)
      if (logit_cap > 0.f) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[mt][n][e] = cap_mul * fast_tanh(s[mt][n][e] * qk_mul);
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[mt][n][e] *= qk_mul;
      }
      // the mask, only where the tile crosses the band's or Sk's edge:
      // each row's visible keys [lo, hi] and Sk are taken relative to this
      // thread's first key, so an element compares its constant offset
      if (!(k0 + BK <= Sk && (!causal || k0 + BK - 1 <= q_lo)
            && (window <= 0 || k0 > q_hi - window))) {
        const int kb0 = k0 + 2 * (lane & 3);
        const int sk = Sk - kb0;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          int lo[2], hi[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            hi[h] = (causal ? qp[mt][h] : INT_MAX / 2) - kb0;
            lo[h] = (window > 0 ? qp[mt][h] - window + 1 : 0) - kb0;
          }
#pragma unroll
          for (int n = 0; n < NS; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kr = 8 * n + (e & 1), h = e >> 1;
              s[mt][n][e] = kr >= sk ? -INFINITY
                            : kr >= lo[h] && kr <= hi[h] ? s[mt][n][e]
                                                          : NEG_INF;
            }
        }
      }
      // online softmax of each row: max and sum over the quad, p = 2^(x -
      // m) in place of the scores, the output rescaled
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          mx[0] = fmaxf(mx[0], fmaxf(s[mt][n][0], s[mt][n][1]));
          mx[1] = fmaxf(mx[1], fmaxf(s[mt][n][2], s[mt][n][3]));
        }
        float sum[2] = {0.f, 0.f}, c[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], off));
          mx[h] = fmaxf(m[mt][h], mx[h]);
        }
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][n][e] = exp2_approx(s[mt][n][e] - mx[e >> 1]);
            sum[e >> 1] += s[mt][n][e];
          }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], off);
          c[h] = exp2_approx(m[mt][h] - mx[h]);
          l[mt][h] = l[mt][h] * c[h] + sum[h];
          m[mt][h] = mx[h];
        }
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[mt][n][0] *= c[0]; o[mt][n][1] *= c[0];
          o[mt][n][2] *= c[1]; o[mt][n][3] *= c[1];
        }
      }
      // o += p . v, p in bf16 A fragments straight from the s registers,
      // as two terms p = hi + lo (about 16 bits of p: p.v agrees with an
      // fp32 p to well under a bf16 step of the output); each v fragment
      // feeds the MT m16 tiles, hi and lo
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[MT][2][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          split_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1], a[mt][0][0],
                     a[mt][1][0]);
          split_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3], a[mt][0][1],
                     a[mt][1][1]);
          split_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1],
                     a[mt][0][2], a[mt][1][2]);
          split_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3],
                     a[mt][0][3], a[mt][1][3]);
        }
        const bf16* vrow = vt + (kk * 16 + (lane & 7) + (lane & 8)) * VLD;
#pragma unroll
        for (int nn = 0; nn < NO / 2; ++nn) {
          uint32_t bv[4];
          ldmatrix_x4_trans(bv, vrow + nn * 16 + (lane >> 4) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int x = 0; x < 2; ++x) {
              mma_bf16_16816(o[mt][2 * nn], a[mt][x], bv[0], bv[1]);
              mma_bf16_16816(o[mt][2 * nn + 1], a[mt][x], bv[2], bv[3]);
            }
        }
        if constexpr (NO % 2) {
          uint32_t bv[2];
          ldmatrix_x2_trans(bv, vrow + (NO - 1) * 8);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int x = 0; x < 2; ++x)
              mma_bf16_16816(o[mt][NO - 1], a[mt][x], bv[0], bv[1]);
        }
      }
    }
  }
  cp_async_wait<0>();                  // nothing in flight
  __syncthreads();                     // every warp is done with the q tile

  // out through the q tile's shared memory: each row's Dv values in bf16,
  // then 16-byte stores, the G rows of a position being G * Dv
  // contiguous values of out
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rw + 16 * mt + 8 * h + (lane >> 2);
      const float inv = 1.f / fmaxf(l[mt][h], 1e-30f);
      // the log-sum-exp back in natural-log units (m is in log2 units)
      if (lse != nullptr && (lane & 3) == 0 && r < live) {
        const int i = r / G;
        lse[((long)b * Hq + hk * G + r - i * G) * Sq + q0 + i] =
            (m[mt][h] + log2f(l[mt][h])) * 0.69314718055994531f;
      }
      bf16* orow = qs + r * QLD + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(o[mt][n][2 * h] * inv,
                                  o[mt][n][2 * h + 1] * inv);
    }
  __syncthreads();
  const long o_row = (long)Hq * HDV;           // out position stride
  bf16* ob = out + ((long)b * Sq + q0) * o_row + (long)hk * G * HDV;
  for (int c = tid; c < live * VCH; c += NT) {
    const int r = c / VCH, ch = c - r * VCH;
    const int i = r / G;
    *reinterpret_cast<uint4*>(ob + i * o_row + (r - i * G) * HDV + ch * 8) =
        *reinterpret_cast<const uint4*>(qs + r * QLD + ch * 8);
  }
}

// the kernel of a (dtype, D, Dv) form and its dynamic shared memory
template <typename T, int HD, int HDV>
struct FaForm {
  static constexpr size_t smem = fa_smem_bytes<HD, HDV>();
  static constexpr int threads = FA_NT;
  static auto kernel() { return flash_attention_kernel<T, HD, HDV>; }
};
template <int HD, int HDV>
struct FaForm<__nv_bfloat16, HD, HDV> {
  static constexpr size_t smem = TcTile<HD, HDV>::smem;
  static constexpr int threads = TC_NT;
  static auto kernel() { return flash_attention_mma_kernel<HD, HDV>; }
};

// opt a kernel into its dynamic shared memory, once per instantiation, so
// that a launch inside a CUDA-graph capture makes no attribute call; a
// refusal is returned, never worked around
template <typename Form>
cudaError_t opt_in() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      Form::kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Form::smem);
  done = e == cudaSuccess;
  return e;
}

struct FaArgs {
  const void *q, *k, *v;
  void* out;
  float* lse;                        // null: no log-sum-exp written
  int B, Sq, Sk, Hq, Hkv, bq, causal, window, q_offset;
  float logit_cap, scale;
  cudaStream_t stream;
};

template <typename T, int HD, int HDV>
int launch_fa(const FaArgs& a) {
  using Form = FaForm<T, HD, HDV>;
  auto kern = Form::kernel();
  const cudaError_t e = opt_in<Form>();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + a.bq - 1) / a.bq, a.Hkv, a.B);
  kern<<<grid, Form::threads, Form::smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.Sq, a.Sk,
      a.Hq,
      a.Hkv, a.bq, a.causal, a.window, a.q_offset, a.logit_cap, a.scale);
  return (int)cudaGetLastError();
}

// info = {blocks per SM, dynamic shared memory bytes, registers a thread}
template <typename T, int HD, int HDV>
int occupancy_fa(int* info) {
  using Form = FaForm<T, HD, HDV>;
  auto kern = Form::kernel();
  cudaError_t e = opt_in<Form>();
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kern);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &info[0], kern, Form::threads, Form::smem);
  info[1] = (int)Form::smem;
  info[2] = e == cudaSuccess ? attr.numRegs : 0;
  return (int)e;
}

// F<T, HD, HDV>::run(args...) for the (D, Dv) pair, or invalid-value
template <typename T, template <typename, int, int> class F, typename... A>
int fa_dims(int D, int Dv, A&&... args) {
  if (D == 64 && Dv == 64) return F<T, 64, 64>::run(args...);
  if (D == 120 && Dv == 120) return F<T, 120, 120>::run(args...);
  if (D == 128 && Dv == 128) return F<T, 128, 128>::run(args...);
  if (D == 192 && Dv == 128) return F<T, 192, 128>::run(args...);
  return (int)cudaErrorInvalidValue;
}

template <typename T, int HD, int HDV>
struct Launch {
  static int run(const FaArgs& a) { return launch_fa<T, HD, HDV>(a); }
};
template <typename T, int HD, int HDV>
struct Occupancy {
  static int run(int* info) { return occupancy_fa<T, HD, HDV>(info); }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  bq = 128 /
// (Hq / Hkv) q positions per block.  Sq, Sk >= 1.  (head_dim, v_head_dim)
// in {(64, 64), (120, 120), (128, 128), (192, 128)}.
namespace {
int fa_forward(const void* q, const void* k, const void* v, void* out,
               float* lse, int B, int Sq, int Sk, int Hq, int Hkv,
               int head_dim, int v_head_dim, int bq, int causal, int window,
               int q_offset, float logit_cap, float scale, int dtype,
               void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || Hkv < 1 || Hq % Hkv
      || bq * (Hq / Hkv) > FA_ROWS || bq < 1)
    return (int)cudaErrorInvalidValue;
  const FaArgs a{q, k, v, out, lse, B, Sq, Sk, Hq, Hkv, bq, causal, window,
                 q_offset, logit_cap, scale,
                 static_cast<cudaStream_t>(stream)};
  if (dtype == 1)
    return fa_dims<__nv_bfloat16, Launch>(head_dim, v_head_dim, a);
  if (dtype == 0) return fa_dims<float, Launch>(head_dim, v_head_dim, a);
  return (int)cudaErrorInvalidValue;
}
}  // namespace

// lse: null (serving) or (B, Hq, Sq) fp32 (the training forward, whose
// backward recomputes p = exp(x - lse)); null writes no lse and leaves out
// bit for bit as it is
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int Sq, int Sk, int Hq, int Hkv,
                                   int head_dim, int v_head_dim, int bq,
                                   int causal, int window, int q_offset,
                                   float logit_cap, float scale, int dtype,
                                   void* stream) {
  return fa_forward(q, k, v, out, static_cast<float*>(lse), B, Sq, Sk, Hq,
                    Hkv, head_dim, v_head_dim, bq, causal, window, q_offset,
                    logit_cap, scale, dtype, stream);
}

// info[3] = {blocks per SM, dynamic shared memory bytes, registers a
// thread} of the kernel flash_attention_fwd launches for this form
extern "C" int flash_attention_occupancy(int head_dim, int v_head_dim,
                                         int dtype, int* info) {
  if (dtype == 1)
    return fa_dims<__nv_bfloat16, Occupancy>(head_dim, v_head_dim, info);
  if (dtype == 0)
    return fa_dims<float, Occupancy>(head_dim, v_head_dim, info);
  return (int)cudaErrorInvalidValue;
}
