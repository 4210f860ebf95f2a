// Mamba2's chunked SSD scan for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (src/repro_torch/kernels/build.py builds it into
// the port's kernel library, src/repro_torch/kernels/ssd_scan.py wraps it).
//
//   ssd_scan_fwd  y_t = C_t h_t + D x_t with h_t = exp(dt_t A) h_{t-1} +
//                 dt_t x_t B_t^T, over a whole sequence: x (B, S, H, P) and
//                 B, C (B, S, G, N) in bf16 or fp32 (read in place with a
//                 row stride), dt (B, S, H) and A (H,) fp32, optional D (H,)
//                 and initial state (B, H, P, N) fp32; y (B, S, H, P) in x's
//                 dtype and, when asked, the final state (B, H, P, N) fp32.
//   ssd_incoming_states  (C++, for ssd_scan_bwd.cu) every chunk's incoming
//                 state, by the stage kernels below.
//
// It launches on the caller's stream and returns cudaGetLastError() so
// that a refused launch is reported.  It allocates nothing: the bf16
// kernels' workspace (chunk scores and chunk states, fp32) is the
// caller's, sized by ssd_scan.py's ssd_workspace.
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "tensor_core.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int SSD_QMAX = 128;        // steps per chunk, at most
constexpr int SSD_NMAX = 128;        // state size, at most

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// --------------------------------------------------------------------------
// fp32: the CUDA-core kernel
// --------------------------------------------------------------------------
constexpr int SSD_NT = 256;          // threads per block: 8 warps
constexpr int SSD_PT = 32;           // P columns of the state per block
constexpr int SSD_T = 8;             // chunk rows per output tile (a warp each)

// Shared memory, in floats, for chunk Q and state size N: the chunk's x
// columns (Q x PT), B rows (Q x (N+1)), the state (PT x (N+1)), a tile's C
// rows transposed (N x T), its decay-weighted scores (T x (Q+1)) and three
// per-step vectors (cumulative log decay, dt, the state update weight).
// The odd row strides keep column reads free of bank conflicts.
__host__ __device__ constexpr int ssd_smem_floats(int Q, int N) {
  return align4(Q * SSD_PT) + align4(Q * (N + 1)) + align4(SSD_PT * (N + 1))
         + align4(N * SSD_T) + align4(SSD_T * (Q + 1)) + 3 * align4(Q);
}

// Replaces, from src/repro/kernels/ssd_scan.py:
//   ssd_pallas  (:76, kernel _ssd_kernel :31, pallas_call :101), with the
//   contract of ops.ssd_chunked_jnp (initial_state and return_state, which
//   ssd_pallas hands to the jnp path), for fp32 x, B and C (the exact-stream
//   gates; bf16 takes the tensor-core kernels below).
// Design: one block per (P tile of 32, head, batch row) walks the chunks
// in order -- the loop replaces the TPU's sequential grid axis -- with its
// state tile (32 x N fp32) in shared memory from the first chunk to the
// last; it reaches device memory only as the optional initial and final
// state.  The recurrence is separable over P, so the 32 columns of a tile
// need only their own x columns and the shared dt, B and C.  Per chunk, the
// steps of ssd_scan.py:9-12: (1) the inclusive scan of dt * A, one warp;
// (2)+(3) by tiles of 8 rows, one warp a row: scores C_t . B_s for s <= t
// only, scaled by exp(cs_t - cs_s) dt_s (every exponent <= 0, none
// evaluated above the diagonal), then y_t = sum_s M_ts x_s + exp(cs_t) C_t
// h^T + D x_t; (4) h = exp(cs_last) h + x^T (dt exp(cs_last - cs) B), each
// thread owning 16 (p, n) entries of the state.  A ragged last chunk is
// padded with dt = 0 and x, B, C = 0: those steps leave h unchanged and
// their y rows are not written.  Groups: head h reads group h / (H / G).
// Two blocks fit an SM (106 KB of shared memory each at Q = N = 128).
// fp32 FMAs on the CUDA cores, scalar loads, the score tile recomputed by
// each P tile of a head.
__global__ void __launch_bounds__(SSD_NT, 2) ssd_scan_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ h0, float* __restrict__ y,
    float* __restrict__ hT, float* __restrict__ hin, int S, int H, int P,
    int G, int N, int Q, long x_rs, long b_rs, long c_rs) {
  extern __shared__ float smem[];
  const int LDB = N + 1, LDH = N + 1, LDM = Q + 1;
  float* xs = smem;                              // Q x PT
  float* bs = xs + align4(Q * SSD_PT);           // Q x LDB
  float* hs = bs + align4(Q * LDB);              // PT x LDH
  float* ct = hs + align4(SSD_PT * LDH);         // N x T (C tile, transposed)
  float* ms = ct + align4(N * SSD_T);            // T x LDM
  float* cum = ms + align4(SSD_T * LDM);         // Q
  float* dts = cum + align4(Q);                  // Q
  float* wts = dts + align4(Q);                  // Q

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * SSD_PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const int pw = min(SSD_PT, P - p0);            // live columns of the tile
  const float Ah = A[h];
  const float Dh = Dv != nullptr ? Dv[h] : 0.f;
  const long row0 = (long)b * S;                 // (b, s) row of step 0

  for (int idx = tid; idx < SSD_PT * N; idx += SSD_NT) {
    const int p = idx / N, n = idx - p * N;
    hs[p * LDH + n] = (h0 != nullptr && p < pw)
        ? h0[(((long)b * H + h) * P + p0 + p) * N + n] : 0.f;
  }

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int rows = min(Q, S - c0);
    __syncthreads();               // the last chunk is done with its tiles
    for (int s = tid; s < Q; s += SSD_NT)
      dts[s] = s < rows ? dt[(row0 + c0 + s) * H + h] : 0.f;
    for (int idx = tid; idx < Q * SSD_PT; idx += SSD_NT) {
      const int s = idx / SSD_PT, p = idx - s * SSD_PT;
      xs[idx] = (s < rows && p < pw)
          ? x[(row0 + c0 + s) * x_rs + (long)h * P + p0 + p] : 0.f;
    }
    for (int idx = tid; idx < Q * N; idx += SSD_NT) {
      const int s = idx / N, n = idx - s * N;
      bs[s * LDB + n] = s < rows
          ? Bm[(row0 + c0 + s) * b_rs + (long)g * N + n] : 0.f;
    }
    __syncthreads();
    // (1) cum[s] = sum_{r <= s} dt_r A: each lane of warp 0 sums 4 steps,
    // then an inclusive scan over the lanes
    if (warp == 0) {
      float v[4], run = 0.f;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int s = 4 * lane + k;
        run += s < Q ? dts[s] * Ah : 0.f;
        v[k] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += t;
      }
      const float excl = incl - run;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (4 * lane + k < Q) cum[4 * lane + k] = excl + v[k];
    }
    __syncthreads();
    const float cs_last = cum[Q - 1];
    for (int s = tid; s < Q; s += SSD_NT)
      wts[s] = dts[s] * expf(cs_last - cum[s]);
    if (hin != nullptr) {          // the chunk's incoming state, for the
      const int Np = round16(N);   // backward (slot c0 / Q of P x Np)
      float* slot = hin + (((long)b * H + h) * (S / Q + (S % Q ? 2 : 1))
                           + c0 / Q) * (long)P * Np;
      for (int idx = tid; idx < SSD_PT * N; idx += SSD_NT) {
        const int p = idx / N, n = idx - p * N;
        if (p < pw) slot[(long)(p0 + p) * Np + n] = hs[p * LDH + n];
      }
    }

    // (2) + (3), a tile of T rows at a time; none without outputs
    for (int t0 = 0; t0 < (y != nullptr ? rows : 0); t0 += SSD_T) {
      const int tr = min(SSD_T, rows - t0);      // live rows of the tile
      const int smax = t0 + tr;                  // columns s < smax
      __syncthreads();                           // ct, ms free again
      for (int idx = tid; idx < SSD_T * N; idx += SSD_NT) {
        const int i = idx / N, n = idx - i * N;
        ct[n * SSD_T + i] = i < tr
            ? Cm[(row0 + c0 + t0 + i) * c_rs + (long)g * N + n] : 0.f;
      }
      __syncthreads();
      {  // scores: thread (s, 4 rows), s on the lanes
        const int s = tid & (SSD_QMAX - 1);
        const int i0 = (tid / SSD_QMAX) * 4;
        if (s < smax) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
          const float* brow = bs + s * LDB;
          for (int n = 0; n < N; ++n) {
            const float bv = brow[n];
            const float4 cv = *reinterpret_cast<const float4*>(
                ct + n * SSD_T + i0);
            acc[0] += cv.x * bv;
            acc[1] += cv.y * bv;
            acc[2] += cv.z * bv;
            acc[3] += cv.w * bv;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int t = t0 + i0 + k;
            ms[(i0 + k) * LDM + s] = (i0 + k < tr && s <= t)
                ? acc[k] * expf(cum[t] - cum[s]) * dts[s] : 0.f;
          }
        }
      }
      __syncthreads();
      if (warp < tr) {  // outputs: warp = row, lane = p
        const int i = warp, t = t0 + i, p = lane;
        float acc = 0.f;
        const float* mrow = ms + i * LDM;
        for (int s = 0; s <= t; ++s) acc += mrow[s] * xs[s * SSD_PT + p];
        float off = 0.f;
        const float* hrow = hs + p * LDH;
        for (int n = 0; n < N; ++n) off += ct[n * SSD_T + i] * hrow[n];
        acc += expf(cum[t]) * off;
        if (p < pw) {
          acc += Dh * xs[t * SSD_PT + p];
          y[((row0 + c0 + t) * H + h) * (long)P + p0 + p] = acc;
        }
      }
    }
    __syncthreads();               // every tile has read the old state
    {  // (4) thread (n, 16 columns p)
      const int n = tid & (SSD_NMAX - 1);
      const int pb = (tid / SSD_NMAX) * 16;
      if (n < N) {
        float acc[16];
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] = 0.f;
        for (int s = 0; s < rows; ++s) {
          const float wb = wts[s] * bs[s * LDB + n];
          const float4* xr = reinterpret_cast<const float4*>(
              xs + s * SSD_PT + pb);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 xv = xr[q];
            acc[4 * q] += xv.x * wb;
            acc[4 * q + 1] += xv.y * wb;
            acc[4 * q + 2] += xv.z * wb;
            acc[4 * q + 3] += xv.w * wb;
          }
        }
        const float decay = expf(cs_last);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          float* hp = hs + (pb + k) * LDH + n;
          *hp = decay * *hp + acc[k];
        }
      }
    }
  }
  if (hT != nullptr) {
    __syncthreads();
    for (int idx = tid; idx < SSD_PT * N; idx += SSD_NT) {
      const int p = idx / N, n = idx - p * N;
      if (p < pw)
        hT[(((long)b * H + h) * P + p0 + p) * N + n] = hs[p * LDH + n];
    }
  }
}

// --------------------------------------------------------------------------
// bf16: the SSD's chunk-parallel form on the tensor cores
// --------------------------------------------------------------------------
// Replaces ssd_pallas (above) for bf16 x, B and C.  Bound on the card:
// bytes at the serving shapes (x, B, C, dt read once, y and the final
// state written once: 44.6 MB for a prefill of 8 x 512 at mamba2-370m's
// heads, about 5.4 GFLOP).  Design: Mamba2's chunk-parallel decomposition
// (arXiv:2405.21060 sec. 6), every chunk at once, in four launches on the
// caller's stream:
//   ssd_scores_kernel  per (batch, group, chunk): G = C B^T (Q x Q, fp32)
//                      on the causal band, once for every head of the
//                      group, into the workspace (64 KB a chunk: L2);
//   ssd_states_kernel  per (batch, head, chunk, P tile): the chunk's own
//                      state from zero, x^T (w B) with w = dt exp(cs_last -
//                      cs), and its decay exp(cs_last);
//   ssd_pass_kernel    per (batch, head, 1024 state entries): the fp32
//                      recurrence h_c = exp(total_c) h_{c-1} + S_c over the
//                      chunks, from the initial state; leaves each chunk's
//                      incoming state in the workspace and writes the
//                      final state;
//   ssd_out_kernel     per (batch, head, chunk, P tile): y = (G o L o dt) x
//                      + exp(cs) C h_in^T + D x.
// A sequence of one chunk skips the pass: the state kernel folds the
// initial state into the final state itself, and the outputs read the
// initial state.  Every product runs on bf16 mma.sync m16n8k16 with fp32
// accumulators, fed by ldmatrix from shared memory or built in registers;
// the three fp32 operands (the decayed scores, w x, the incoming state)
// enter as bf16 hi + lo (about 16 bits), and the state is fp32 from the
// first chunk to the last.  Each kernel recomputes its chunk's scan of dt
// A (a few hundred adds).  A chunk of any length 1 to 128 is padded inside
// the kernels to a multiple of 16 steps with dt = 0 and x, B, C = 0
// (shared-memory zero fill): such steps leave the state unchanged and
// write no output.  Decay exponents are evaluated on the causal band only
// and clamped at 0.  Long sequences run in groups of chunks (the
// workspace's size), the state carried between groups in the workspace.
// Tiles reach shared memory by cp.async, all of a block's in flight at
// once.  What bounds it now is the chunk states' round trip (written,
// passed, read: 128 KB a (batch, head, chunk)) and the output kernel; a
// hybrid that walks each (batch, head)'s chunks in order with the state in
// registers measured no faster at 8 x 512 and slower at 2 x 4000, where
// one block walks 32 chunks (PERF.md).

// Rows [0, rows) x columns [0, cols) of a bf16 matrix with row stride rs
// into shared memory (row stride ld, 16-byte aligned rows), zero-filled to
// rows_pad x cols_pad (cols_pad a multiple of 8): 16-byte cp.async copies
// (zero-filling ones past the data) where the source allows, all in flight
// together -- the caller commits and waits -- and elementwise loads for a
// ragged or misaligned source.
__device__ __forceinline__ void copy_tile(bf16* dst, int ld, const bf16* src,
                                          long rs, int rows, int rows_pad,
                                          int cols, int cols_pad, int tid,
                                          int nt) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0
                   && rs % 8 == 0;
  const int c8 = cols_pad / 8;
  for (int idx = tid; idx < rows_pad * c8; idx += nt) {
    const int r = idx / c8, k = (idx - r * c8) * 8;
    bf16* d = dst + r * ld + k;
    const bool live = r < rows && k < cols;
    if (!live || (vec && k + 8 <= cols)) {
      cp_async16(d, live ? src + r * rs + k : src, live);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        d[j] = k + j < cols ? src[r * rs + k + j] : __float2bfloat16(0.f);
    }
  }
}

// the same for an fp32 matrix (cols_pad a multiple of 4)
__device__ __forceinline__ void copy_tile(float* dst, int ld,
                                          const float* src, long rs,
                                          int rows, int rows_pad, int cols,
                                          int cols_pad, int tid, int nt) {
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0
                   && rs % 4 == 0;
  const int c4 = cols_pad / 4;
  for (int idx = tid; idx < rows_pad * c4; idx += nt) {
    const int r = idx / c4, k = (idx - r * c4) * 4;
    float* d = dst + r * ld + k;
    const bool live = r < rows && k < cols;
    if (!live || (vec && k + 4 <= cols)) {
      cp_async16(d, live ? src + r * rs + k : src, live);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = k + j < cols ? src[r * rs + k + j] : 0.f;
    }
  }
}

// The chunk's dt (zero past its rows) into dts[0, Qr) and the inclusive
// scan of dt A into cum[0, Qr) (warp 0: 4 steps a lane, then the lanes);
// ends on a barrier.
__device__ __forceinline__ void chunk_decay(const float* dt, long off, int H,
                                            int rows, int Qr, float Ah,
                                            float* dts, float* cum, int tid,
                                            int nt) {
  for (int s = tid; s < Qr; s += nt)
    dts[s] = s < rows ? dt[off + (long)s * H] : 0.f;
  __syncthreads();
  if (tid < 32) {
    const int lane = tid;
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int s = 4 * lane + k;
      run += s < Qr ? dts[s] * Ah : 0.f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += t;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * lane + k < Qr) cum[4 * lane + k] = excl + v[k];
  }
  __syncthreads();
}

// Shared memory of the three tensor-core kernels, in bytes, for padded
// chunk Qp, padded state size Np and P tile PT
__host__ __device__ constexpr int scores_smem(int Qp, int Np) {
  return 2 * Qp * tc_ld(Np) * 2;
}
__host__ __device__ constexpr int states_smem(int Qp, int Np, int PT) {
  return 3 * SSD_QMAX * 4 + Qp * tc_ld(Np) * 2 + Qp * tc_ld(PT) * 2;
}
__host__ __device__ constexpr int out_smem(int Qp, int Np, int PT) {
  return 2 * SSD_QMAX * 4 + Qp * tc_ld(PT) * 2 + Qp * tc_ld(Np) * 2
         + PT * (Np + 8) * 4;
}

// G = C B^T of chunk c_first + blockIdx.x for group blockIdx.y of batch
// row blockIdx.z, into scores (its slot of Qp x Qp fp32, row t, column
// s).  4 warps; warp w takes the m16 row tiles w and MT - 1 - w (an equal
// share of the causal band) and computes only the 16-column tiles at or
// below the diagonal, which are all that ssd_out_kernel reads.
__global__ void __launch_bounds__(128) ssd_scores_kernel(
    const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
    float* __restrict__ scores, int S, int G, int N, int Q, int c_first,
    int n_slots, long b_rs, long c_rs) {
  extern __shared__ float smem[];
  const int k = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = (c_first + k) * Q;
  const int rows = min(Q, S - c0), MT = (rows + 15) / 16;
  const int Qp = round16(Q), Np = round16(N), LD = tc_ld(Np);
  bf16* cs = reinterpret_cast<bf16*>(smem);      // 16 MT x LD
  bf16* bs = cs + Qp * LD;                       // 16 MT x LD
  const long r0 = (long)b * S + c0;
  copy_tile(cs, LD, Cm + r0 * c_rs + (long)g * N, c_rs, rows, 16 * MT, N,
            Np, tid, 128);
  copy_tile(bs, LD, Bm + r0 * b_rs + (long)g * N, b_rs, rows, 16 * MT, N,
            Np, tid, 128);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* out = scores + (((long)b * G + g) * n_slots + k) * Qp * Qp;
  if (warp >= (MT + 1) / 2) return;
  for (int half = 0; half < 2; ++half) {
    const int i = half ? MT - 1 - warp : warp;
    if (half && i <= warp) break;
    uint32_t a[SSD_NMAX / 16][4];
#pragma unroll
    for (int kk = 0; kk < SSD_NMAX / 16; ++kk)
      if (16 * kk < Np)
        ldmatrix_x4(a[kk], cs + (16 * i + (lane & 7) + (lane & 8)) * LD
                               + 16 * kk + (lane >> 4) * 8);
    for (int np = 0; np <= i; ++np) {
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < SSD_NMAX / 16; ++kk)
        if (16 * kk < Np) {
          uint32_t bb[4];
          ldmatrix_x4(bb, bs + (16 * np + (lane & 7) + (lane >> 4) * 8) * LD
                              + 16 * kk + (lane & 8));
          mma_bf16_16816(acc[0], a[kk], bb[0], bb[1]);
          mma_bf16_16816(acc[1], a[kk], bb[2], bb[3]);
        }
      const int r = 16 * i + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = 16 * np + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(out + (long)r * Qp + col) =
            make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(out + (long)(r + 8) * Qp + col) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// The state of chunk c_first + blockIdx.x / ptiles from zero, S = x^T (w
// B), for P tile blockIdx.x % ptiles of head blockIdx.y, batch row
// blockIdx.z: (w x)^T is the A operand (p rows, steps as k), its
// fragments built in registers from the x tile in shared memory and split
// hi + lo; B the B operand (ldmatrix .trans).  4 warps: PT / 16 m16 tiles
// of p, each over 64 / PT warps splitting the state's n8 tiles.  Writes S
// into workspace slot k + 1 and exp(cs_last) into decay[k]; a sequence of
// one chunk (fold) writes the final state exp(cs_last) h0 + S instead.
template <int PT>
__global__ void __launch_bounds__(128) ssd_states_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const float* __restrict__ h0, float* __restrict__ slots,
    float* __restrict__ decay, float* __restrict__ hT, int S, int H, int P,
    int G, int N, int Q, int c_first, int n_slots, int fold, long x_rs,
    long b_rs) {
  constexpr int MTS = PT / 16;          // m16 tiles of p
  constexpr int NWT = PT / 4;           // n8 tiles a warp, at most (N 128)
  constexpr int LDP = tc_ld(PT);
  extern __shared__ float smem[];
  float* dts = smem;                             // QMAX
  float* cum = dts + SSD_QMAX;                   // QMAX
  float* wts = cum + SSD_QMAX;                   // QMAX
  const int Qp = round16(Q), Np = round16(N), LDN = tc_ld(Np);
  bf16* bs = reinterpret_cast<bf16*>(wts + SSD_QMAX);   // Qp x LDN, [s][n]
  bf16* xs = bs + Qp * LDN;                      // Qp x LDP, [s][p]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ptiles = (P + PT - 1) / PT;
  const int k = blockIdx.x / ptiles, pt = blockIdx.x - k * ptiles;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int p0 = pt * PT;
  const int c0 = (c_first + k) * Q;
  const int rows = min(Q, S - c0), KT = (rows + 15) / 16, Qr = 16 * KT;
  const long r0 = (long)b * S + c0;

  copy_tile(bs, LDN, Bm + r0 * b_rs + (long)g * N, b_rs, rows, Qr, N, Np,
            tid, 128);
  copy_tile(xs, LDP, x + r0 * x_rs + (long)h * P + p0, x_rs, rows, Qr,
            min(PT, P - p0), PT, tid, 128);
  cp_async_commit();
  chunk_decay(dt, r0 * H + h, H, rows, Qr, A[h], dts, cum, tid, 128);
  const float cs_last = cum[Qr - 1];
  for (int s = tid; s < Qr; s += 128)
    wts[s] = dts[s] * expf(cs_last - cum[s]);
  cp_async_wait<0>();
  __syncthreads();

  const int mt = warp % MTS, ng = warp / MTS;
  float acc[NWT][4];
#pragma unroll
  for (int j = 0; j < NWT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int kk = 0; kk < KT; ++kk) {
    // A fragment f: p = 16 mt + lane / 4 (+ 8 for f odd), steps s, s + 1
    // with s = 16 kk + 2 (lane % 4) (+ 8 for f >= 2)
    uint32_t ah[4], al[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int pp = 16 * mt + (lane >> 2) + 8 * (f & 1);
      const int s = 16 * kk + 2 * (lane & 3) + 8 * (f >> 1);
      split_bf16(__bfloat162float(xs[s * LDP + pp]) * wts[s],
                 __bfloat162float(xs[(s + 1) * LDP + pp]) * wts[s + 1],
                 ah[f], al[f]);
    }
#pragma unroll
    for (int jp = 0; jp < NWT / 2; ++jp) {
      const int j = ng * NWT + 2 * jp;
      if (8 * j < Np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, bs + (16 * kk + (lane & 7) + (lane & 8)) * LDN
                                 + 8 * j + (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * jp], ah, bb[0], bb[1]);
        mma_bf16_16816(acc[2 * jp], al, bb[0], bb[1]);
        mma_bf16_16816(acc[2 * jp + 1], ah, bb[2], bb[3]);
        mma_bf16_16816(acc[2 * jp + 1], al, bb[2], bb[3]);
      }
    }
  }
  const float dec = expf(cs_last);
  const long bh = (long)b * H + h;
  if (!fold && pt == 0 && tid == 0) decay[bh * n_slots + k] = dec;
  float* slot = fold ? nullptr
                    : slots + (bh * (n_slots + 1) + k + 1) * (long)P * Np;
#pragma unroll
  for (int jj = 0; jj < NWT; ++jj) {
    const int j = ng * NWT + jj;
    if (8 * j >= Np) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int p = p0 + 16 * mt + (lane >> 2) + 8 * e;
      const int n = 8 * j + 2 * (lane & 3);
      if (p >= P) continue;
      if (!fold) {
        *reinterpret_cast<float2*>(slot + (long)p * Np + n) =
            make_float2(acc[jj][2 * e], acc[jj][2 * e + 1]);
      } else if (hT != nullptr) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
          if (n + q < N) {
            const long at = (bh * P + p) * N + n + q;
            hT[at] = dec * (h0 != nullptr ? h0[at] : 0.f)
                     + acc[jj][2 * e + q];
          }
      }
    }
  }
}

// The recurrence over one group of ng chunks, 4 state entries a thread:
// h = start (h0 with row stride N, the carry with row stride Np, or zero);
// slot 0 := h (unless zero: the outputs then skip it); for each chunk k: h
// = decay_k h + slot_{k+1}, and slot_{k+1} := h while chunks follow.  So
// slot k holds chunk k's incoming state, and h ends as the group's
// outgoing state: into carry (the next group's start; it may alias start,
// each thread reading its own entries before writing them) and, for the
// last group, the final state hT.  The loads of four chunks go out before
// their chain.
__global__ void __launch_bounds__(256) ssd_pass_kernel(
    const float* start, int start_ld, float* __restrict__ slots,
    const float* __restrict__ decay, float* carry, float* __restrict__ hT,
    int H, int P, int N, int n_slots, int ng) {
  const int Np = round16(N);
  const int e = (blockIdx.x * 256 + threadIdx.x) * 4;
  if (e >= P * Np) return;
  const int p = e / Np, n = e - p * Np;
  const long bh = (long)blockIdx.z * H + blockIdx.y;
  float hv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    hv[q] = (start != nullptr && n + q < N)
        ? start[(bh * P + p) * start_ld + n + q] : 0.f;
  const long SK = (long)P * Np;
  float* sl = slots == nullptr
      ? nullptr : slots + bh * (n_slots + 1) * SK + (long)p * Np + n;
  if (sl != nullptr && start != nullptr)
    *reinterpret_cast<float4*>(sl) = make_float4(hv[0], hv[1], hv[2], hv[3]);
  const float* dk = decay + bh * n_slots;
  for (int k0 = 0; k0 < ng; k0 += 4) {
    float4 sv[4];
    float dv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + u < ng) {
        sv[u] = *reinterpret_cast<const float4*>(sl + (k0 + u + 1) * SK);
        dv[u] = dk[k0 + u];
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k0 + u < ng) {
        hv[0] = dv[u] * hv[0] + sv[u].x;
        hv[1] = dv[u] * hv[1] + sv[u].y;
        hv[2] = dv[u] * hv[2] + sv[u].z;
        hv[3] = dv[u] * hv[3] + sv[u].w;
        if (k0 + u + 1 < ng)
          *reinterpret_cast<float4*>(sl + (k0 + u + 1) * SK) =
              make_float4(hv[0], hv[1], hv[2], hv[3]);
      }
  }
  if (carry != nullptr)
    *reinterpret_cast<float4*>(carry + (bh * P + p) * Np + n) =
        make_float4(hv[0], hv[1], hv[2], hv[3]);
  if (hT != nullptr) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (n + q < N) hT[(bh * P + p) * N + n + q] = hv[q];
  }
}

// Launch shape of ssd_out_kernel for P tile PT: n8 tiles of p a warp, and
// warps per pair of m16 row tiles
template <int PT>
struct OutForm {
  static constexpr int NW = PT == 64 ? 4 : 2;
  static constexpr int NG = PT / 8 / NW;
  static constexpr int NT = 128 * NG;
};

// The scores of row tile t0 (and t0 + 8) over the 16 steps of kk, as the
// four A fragments of a m16 x k16 tile want them (fp32 pairs from L2)
__device__ __forceinline__ void load_scores(const float* gs, int Qp, int t0,
                                            int kk, int lane, float2* g) {
  const int s0 = 16 * kk + 2 * (lane & 3);
#pragma unroll
  for (int f = 0; f < 4; ++f)
    g[f] = *reinterpret_cast<const float2*>(
        gs + (long)(t0 + 8 * (f & 1)) * Qp + s0 + 8 * (f >> 1));
}

// The outputs of chunk c_first + blockIdx.x / ptiles, P tile blockIdx.x %
// ptiles, head blockIdx.y, batch row blockIdx.z.  Warp (pair mp, n group
// ng) takes the m16 row tiles mp and MT - 1 - mp (an equal share of the
// causal band) and NW n8 tiles of p.  Per row tile: acc = C h_in^T (C by
// ldmatrix, h_in fp32 from shared memory split hi + lo into the B
// operand, k over the state), scaled per row by exp(cs_t); then acc += M
// x over the band, M's A fragments built in registers from the group's
// scores (fp32 from L2, the next step's loads issued before this one's
// math), exp(min(cs_t - cs_s, 0)) dt_s on s <= t and 0 above, split hi +
// lo; x by ldmatrix .trans.  y = acc + D x, rounded once to bf16.  h_in
// of chunk k is at hin + (b H + h) hin_bh + k hin_k, row p at p hin_ld; a
// null hin (or skip_first on chunk 0) means zero.
template <int PT>
__global__ void __launch_bounds__(OutForm<PT>::NT) ssd_out_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Cm,
    const float* __restrict__ Dv, const float* __restrict__ scores,
    const float* __restrict__ hin, long hin_bh, long hin_k, int hin_ld,
    int skip_first, bf16* __restrict__ y, int S, int H, int P, int G, int N,
    int Q, int c_first, int n_slots, long x_rs, long c_rs) {
  using F = OutForm<PT>;
  constexpr int NW = F::NW;
  constexpr int LDP = tc_ld(PT);
  extern __shared__ float smem[];
  float* dts = smem;                             // QMAX
  float* cum = dts + SSD_QMAX;                   // QMAX
  const int Qp = round16(Q), Np = round16(N);
  const int LDN = tc_ld(Np), LDH = Np + 8;
  bf16* xs = reinterpret_cast<bf16*>(cum + SSD_QMAX);   // Qp x LDP, [s][p]
  bf16* csm = xs + Qp * LDP;                     // Qp x LDN, [t][n]
  float* hs = reinterpret_cast<float*>(csm + Qp * LDN);  // PT x LDH, [p][n]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ptiles = (P + PT - 1) / PT;
  const int k = blockIdx.x / ptiles, pt = blockIdx.x - k * ptiles;
  const int h = blockIdx.y, b = blockIdx.z, g = h / (H / G);
  const int p0 = pt * PT;
  const int c0 = (c_first + k) * Q;
  const int rows = min(Q, S - c0), MT = (rows + 15) / 16, Qr = 16 * MT;
  const long r0 = (long)b * S + c0;
  const long bh = (long)b * H + h;
  const bool has_in = hin != nullptr && !(skip_first && k == 0);

  copy_tile(xs, LDP, x + r0 * x_rs + (long)h * P + p0, x_rs, rows, Qr,
            min(PT, P - p0), PT, tid, F::NT);
  if (has_in) {
    copy_tile(csm, LDN, Cm + r0 * c_rs + (long)g * N, c_rs, rows, Qr, N, Np,
              tid, F::NT);
    copy_tile(hs, LDH, hin + bh * hin_bh + k * hin_k + (long)p0 * hin_ld,
              hin_ld, min(PT, P - p0), PT, N, Np, tid, F::NT);
  }
  cp_async_commit();
  chunk_decay(dt, r0 * H + h, H, rows, Qr, A[h], dts, cum, tid, F::NT);
  cp_async_wait<0>();
  __syncthreads();

  const float Dh = Dv != nullptr ? Dv[h] : 0.f;
  const float* gs = scores + (((long)b * G + g) * n_slots + k) * Qp * Qp;
  const int mp = warp & 3, ng = warp >> 2;
  if (mp >= (MT + 1) / 2) return;
  for (int half = 0; half < 2; ++half) {
    const int i = half ? MT - 1 - mp : mp;
    if (half && i <= mp) break;
    const int t0 = 16 * i + (lane >> 2), t1 = t0 + 8;
    float2 gnext[4];
    load_scores(gs, Qp, t0, 0, lane, gnext);
    float acc[NW][4];
#pragma unroll
    for (int j = 0; j < NW; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (has_in) {
      for (int kk = 0; kk < Np / 16; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, csm + (16 * i + (lane & 7) + (lane & 8)) * LDN
                           + 16 * kk + (lane >> 4) * 8);
#pragma unroll
        for (int jj = 0; jj < NW; ++jj) {
          const float* hr = hs + (8 * (ng * NW + jj) + (lane >> 2)) * LDH
                            + 16 * kk + 2 * (lane & 3);
          const float2 u0 = *reinterpret_cast<const float2*>(hr);
          const float2 u1 = *reinterpret_cast<const float2*>(hr + 8);
          uint32_t bh0, bl0, bh1, bl1;
          split_bf16(u0.x, u0.y, bh0, bl0);
          split_bf16(u1.x, u1.y, bh1, bl1);
          mma_bf16_16816(acc[jj], a, bh0, bh1);
          mma_bf16_16816(acc[jj], a, bl0, bl1);
        }
      }
      const float e0 = expf(cum[t0]), e1 = expf(cum[t1]);
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    const float ct0 = cum[t0], ct1 = cum[t1];
    for (int kk = 0; kk <= i; ++kk) {
      float2 gv[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) gv[f] = gnext[f];
      if (kk < i) load_scores(gs, Qp, t0, kk + 1, lane, gnext);
      const int s0 = 16 * kk + 2 * (lane & 3);
      uint32_t ah[4], al[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int t = f & 1 ? t1 : t0, s = s0 + 8 * (f >> 1);
        const float ct = f & 1 ? ct1 : ct0;
        const float m0 = s <= t
            ? gv[f].x * expf(fminf(ct - cum[s], 0.f)) * dts[s] : 0.f;
        const float m1 = s + 1 <= t
            ? gv[f].y * expf(fminf(ct - cum[s + 1], 0.f)) * dts[s + 1]
            : 0.f;
        split_bf16(m0, m1, ah[f], al[f]);
      }
      const bf16* xr = xs + (16 * kk + (lane & 7) + (lane & 8)) * LDP;
#pragma unroll
      for (int jp = 0; jp < NW / 2; ++jp) {
        const int j = ng * NW + 2 * jp;
        uint32_t bx[4];
        ldmatrix_x4_trans(bx, xr + 8 * j + (lane >> 4) * 8);
        mma_bf16_16816(acc[2 * jp], ah, bx[0], bx[1]);
        mma_bf16_16816(acc[2 * jp], al, bx[0], bx[1]);
        mma_bf16_16816(acc[2 * jp + 1], ah, bx[2], bx[3]);
        mma_bf16_16816(acc[2 * jp + 1], al, bx[2], bx[3]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < NW; ++jj) {
      const int j = ng * NW + jj;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int t = e ? t1 : t0;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int pp = 8 * j + 2 * (lane & 3) + q;
          if (t < rows && p0 + pp < P) {
            const float v = acc[jj][2 * e + q]
                            + Dh * __bfloat162float(xs[t * LDP + pp]);
            y[((r0 + t) * H + h) * (long)P + p0 + pp] = __float2bfloat16(v);
          }
        }
      }
    }
  }
}

// The workspace, in floats, for a group of `group` chunks (ssd_scan.py's
// ssd_workspace computes the same): one chunk's scores, or per group
// scores, the slots (group + 1 states), the carry and the decays
long ssd_workspace_floats(int B, int S, int H, int P, int G, int N, int Q,
                          int group) {
  const long nc = (S + Q - 1) / Q, Qp = round16(Q), Np = round16(N);
  if (nc <= 1) return (long)B * G * Qp * Qp;
  return (long)B * G * group * Qp * Qp + (long)B * H * (group + 1) * P * Np
         + (long)B * H * P * Np + (long)B * H * group;
}

// the P tile: the widest of 64, 32, 16 that still gives two blocks an SM
// over the card's 132 SMs (at most 16 for one chunk of few heads)
int ssd_p_tile(int B, int H, int P, int nc) {
  const long units = (long)B * H * nc;
  for (int pt = 64; pt > 16; pt /= 2)
    if (units * ((P + pt - 1) / pt) >= 2 * 132) return pt;
  return 16;
}

template <typename K>
cudaError_t allow_smem(K kern, int bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int PT>
int launch_tc(const bf16* x, const float* dt, const float* A,
              const bf16* Bm, const bf16* Cm, const float* D,
              const float* h0, bf16* y, float* hT, float* ws, int group,
              int B, int S, int H, int P, int G, int N, int Q, long x_rs,
              long b_rs, long c_rs, cudaStream_t st) {
  // the attributes are set once, for the largest chunk and state, so that
  // a launch inside a CUDA-graph capture makes no attribute call
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = allow_smem(ssd_scores_kernel,
                               scores_smem(SSD_QMAX, SSD_NMAX));
    if (e == cudaSuccess)
      e = allow_smem(ssd_states_kernel<PT>,
                     states_smem(SSD_QMAX, SSD_NMAX, PT));
    if (e == cudaSuccess)
      e = allow_smem(ssd_out_kernel<PT>, out_smem(SSD_QMAX, SSD_NMAX, PT));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int nc = (S + Q - 1) / Q, Qp = round16(Q), Np = round16(N);
  const int ptiles = (P + PT - 1) / PT;
  const int s_scores = scores_smem(Qp, Np);
  const int s_states = states_smem(Qp, Np, PT);
  const int s_out = out_smem(Qp, Np, PT);
  const long PN = (long)P * Np;
  if (nc == 1) {       // one chunk: no pass, the state kernel folds h0
    ssd_scores_kernel<<<dim3(1, G, B), 128, s_scores, st>>>(
        Bm, Cm, ws, S, G, N, Q, 0, 1, b_rs, c_rs);
    if (hT != nullptr)
      ssd_states_kernel<PT><<<dim3(ptiles, H, B), 128, s_states, st>>>(
          x, dt, A, Bm, h0, nullptr, nullptr, hT, S, H, P, G, N, Q, 0, 1,
          1, x_rs, b_rs);
    ssd_out_kernel<PT><<<dim3(ptiles, H, B), OutForm<PT>::NT, s_out, st>>>(
        x, dt, A, Cm, D, ws, h0, (long)P * N, 0, N, 0, y, S, H, P, G, N, Q,
        0, 1, x_rs, c_rs);
    return (int)cudaGetLastError();
  }
  float* sc = ws;
  float* slots = sc + (long)B * G * group * Qp * Qp;
  float* carry = slots + (long)B * H * (group + 1) * PN;
  float* dec = carry + (long)B * H * PN;
  for (int cf = 0; cf < nc; cf += group) {
    const int ng = min(group, nc - cf);
    const bool last = cf + ng == nc;
    ssd_scores_kernel<<<dim3(ng, G, B), 128, s_scores, st>>>(
        Bm, Cm, sc, S, G, N, Q, cf, group, b_rs, c_rs);
    ssd_states_kernel<PT><<<dim3(ng * ptiles, H, B), 128, s_states, st>>>(
        x, dt, A, Bm, nullptr, slots, dec, nullptr, S, H, P, G, N, Q, cf,
        group, 0, x_rs, b_rs);
    ssd_pass_kernel<<<dim3((int)((PN / 4 + 255) / 256), H, B), 256, 0,
                      st>>>(
        cf == 0 ? h0 : carry, cf == 0 ? N : Np, slots, dec,
        last ? nullptr : carry, last ? hT : nullptr, H, P, N, group, ng);
    ssd_out_kernel<PT><<<dim3(ng * ptiles, H, B), OutForm<PT>::NT, s_out,
                         st>>>(
        x, dt, A, Cm, D, sc, slots, (group + 1) * PN, PN, Np,
        cf == 0 && h0 == nullptr, y, S, H, P, G, N, Q, cf, group, x_rs,
        c_rs);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

int launch_ssd_fp32(const float* x, const float* dt, const float* A,
                    const float* Bm, const float* Cm, const float* D,
                    const float* h0, float* y, float* hT, int B, int S,
                    int H, int P, int G, int N, int Q, long x_rs, long b_rs,
                    long c_rs, cudaStream_t stream, float* hin = nullptr) {
  // the attribute is set once, for the largest chunk and state, so that a
  // launch inside a CUDA-graph capture makes no attribute call
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = allow_smem(
        ssd_scan_kernel,
        (int)(sizeof(float) * ssd_smem_floats(SSD_QMAX, SSD_NMAX)));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const size_t smem = sizeof(float) * ssd_smem_floats(Q, N);
  dim3 grid((P + SSD_PT - 1) / SSD_PT, H, B);
  ssd_scan_kernel<<<grid, SSD_NT, smem, stream>>>(
      x, dt, A, Bm, Cm, D, h0, y, hT, hin, S, H, P, G, N, Q, x_rs, b_rs,
      c_rs);
  return (int)cudaGetLastError();
}

template <int PT>
int incoming_states_tc(const bf16* x, const float* dt, const float* A,
                       const bf16* Bm, const float* h0, float* slots,
                       float* decay, int B, int S, int H, int P, int G,
                       int N, int Q, long x_rs, long b_rs, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = allow_smem(ssd_states_kernel<PT>,
                                     states_smem(SSD_QMAX, SSD_NMAX, PT));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int nc = (S + Q - 1) / Q, Np = round16(N);
  if (nc > 1)
    ssd_states_kernel<PT><<<dim3(nc * ((P + PT - 1) / PT), H, B), 128,
                            states_smem(round16(Q), Np, PT), st>>>(
        x, dt, A, Bm, nullptr, slots, decay, nullptr, S, H, P, G, N, Q, 0,
        nc, 0, x_rs, b_rs);
  ssd_pass_kernel<<<dim3((P * Np / 4 + 255) / 256, H, B), 256, 0, st>>>(
      h0, N, slots, decay, nullptr, nullptr, H, P, N, nc, nc > 1 ? nc : 0);
  return (int)cudaGetLastError();
}

}  // namespace

// Every chunk's incoming state, for the backward (ssd_scan_bwd.cu), by the
// forward's own stages, so that the backward sees the states the forward
// used: slots holds (B H) x (nc + 1) states of P x Np fp32 (Np = N rounded
// up to 16), slot k chunk k's incoming state; in bf16 slot 0 is left
// unwritten when h0 is null (the backward reads zero there).  bf16 runs
// ssd_states_kernel over every chunk and ssd_pass_kernel (decay takes (B H)
// x nc values), fp32 ssd_scan_kernel without outputs (decay unused).
int ssd_incoming_states(const void* x, const float* dt, const float* A,
                        const void* Bm, const float* h0, float* slots,
                        float* decay, int B, int S, int H, int P, int G,
                        int N, int Q, long x_rs, long b_rs, int dtype,
                        cudaStream_t st) {
  if (dtype == 0)
    return launch_ssd_fp32(static_cast<const float*>(x), dt, A,
                           static_cast<const float*>(Bm), nullptr, nullptr,
                           h0, nullptr, nullptr, B, S, H, P, G, N, Q, x_rs,
                           b_rs, 0, st, slots);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  switch (ssd_p_tile(B, H, P, (S + Q - 1) / Q)) {
    case 64:
      return incoming_states_tc<64>(xb, dt, A, Bb, h0, slots, decay, B, S, H,
                                    P, G, N, Q, x_rs, b_rs, st);
    case 32:
      return incoming_states_tc<32>(xb, dt, A, Bb, h0, slots, decay, B, S, H,
                                    P, G, N, Q, x_rs, b_rs, st);
    default:
      return incoming_states_tc<16>(xb, dt, A, Bb, h0, slots, decay, B, S, H,
                                    P, G, N, Q, x_rs, b_rs, st);
  }
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  D, h0 and hT may be
// null.  1 <= chunk <= 128, 1 <= N <= 128, H a multiple of G; x_rs, b_rs
// and c_rs are the element strides between consecutive (batch, step) rows
// of x, B and C, whose last two axes are contiguous.  bf16 takes a
// workspace of ws_floats fp32 values (16-byte aligned) holding `group`
// chunks at a time, at least ssd_workspace_floats; fp32 takes none.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            const void* h0, void* y, void* hT, void* ws,
                            int B, int S, int H, int P, int G, int N,
                            int chunk, int group, long x_rs, long b_rs,
                            long c_rs, long ws_floats, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 0 || H < 1 || P < 1 || G < 1 || H % G || N < 1
      || N > SSD_NMAX || chunk < 1 || chunk > SSD_QMAX || B > 65535
      || H > 65535)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  if (dtype == 0)
    return launch_ssd_fp32(
        static_cast<const float*>(x), dtf, Af, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), Df, h0f, static_cast<float*>(y), hTf,
        B, S, H, P, G, N, chunk, x_rs, b_rs, c_rs, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  const int nc = (S + chunk - 1) / chunk;
  if (nc == 0) {       // no step: the final state is the initial one
    if (hTf != nullptr)
      ssd_pass_kernel<<<dim3((P * round16(N) / 4 + 255) / 256, H, B), 256,
                        0, st>>>(h0f, N, nullptr, nullptr, nullptr, hTf, H,
                                 P, N, 0, 0);
    return (int)cudaGetLastError();
  }
  if (group < 1 || ws == nullptr
      || reinterpret_cast<uintptr_t>(ws) % 16
      || ws_floats < ssd_workspace_floats(B, S, H, P, G, N, chunk, group))
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* Bb = static_cast<const bf16*>(Bm);
  const bf16* Cb = static_cast<const bf16*>(Cm);
  bf16* yb = static_cast<bf16*>(y);
  float* wsf = static_cast<float*>(ws);
  switch (ssd_p_tile(B, H, P, nc)) {
    case 64:
      return launch_tc<64>(xb, dtf, Af, Bb, Cb, Df, h0f, yb, hTf, wsf, group,
                           B, S, H, P, G, N, chunk, x_rs, b_rs, c_rs, st);
    case 32:
      return launch_tc<32>(xb, dtf, Af, Bb, Cb, Df, h0f, yb, hTf, wsf, group,
                           B, S, H, P, G, N, chunk, x_rs, b_rs, c_rs, st);
    default:
      return launch_tc<16>(xb, dtf, Af, Bb, Cb, Df, h0f, yb, hTf, wsf, group,
                           B, S, H, P, G, N, chunk, x_rs, b_rs, c_rs, st);
  }
}
