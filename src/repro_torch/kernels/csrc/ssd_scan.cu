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
//
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that a refused launch is reported.
#include <math.h>

#include "attention_common.cuh"

namespace {

constexpr int SSD_NT = 256;          // threads per block: 8 warps
constexpr int SSD_PT = 32;           // P columns of the state per block
constexpr int SSD_T = 8;             // chunk rows per output tile (a warp each)
constexpr int SSD_QMAX = 128;        // steps per chunk, at most
constexpr int SSD_NMAX = 128;        // state size, at most

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

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
//   ssd_pallas hands to the jnp path).
// Bound on the card: bytes at the serving shapes (x, B, C, dt read once, y
// and the final state written once: 44.6 MB for a prefill of 8 x 512 at
// mamba2-370m's heads, against about 5.4 GFLOP).  Design: one block per
// (P tile of 32, head, batch row) walks the chunks in order -- the loop
// replaces the TPU's sequential grid axis -- with its state tile (32 x N
// fp32) in shared memory from the first chunk to the last; it reaches
// device memory only as the optional initial and final state.  The
// recurrence is separable over P, so the 32 columns of a tile need only
// their own x columns and the shared dt, B and C.  Per chunk, the steps
// of ssd_scan.py:9-12: (1) the inclusive scan of dt * A, one warp; (2)+(3)
// by tiles of 8 rows, one warp a row: scores C_t . B_s for s <= t only,
// scaled by exp(cs_t - cs_s) dt_s (every exponent <= 0, none evaluated
// above the diagonal), then y_t = sum_s M_ts x_s + exp(cs_t) C_t h^T +
// D x_t; (4) h = exp(cs_last) h + x^T (dt exp(cs_last - cs) B), each
// thread owning 16 (p, n) entries of the state.  A ragged last chunk is
// padded with dt = 0 and x, B, C = 0: those steps leave h unchanged and
// their y rows are not written.  Groups: head h reads group h / (H / G).
// Two blocks fit an SM (106 KB of shared memory each at Q = N = 128).
// Still simple: fp32 FMAs on the CUDA cores (no mma / wgmma), scalar
// loads, the score tile recomputed by each P tile of a head, no overlap of
// the next chunk's loads with this chunk's math.
template <typename T>
__global__ void __launch_bounds__(SSD_NT, 2) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dv,
    const float* __restrict__ h0, T* __restrict__ y, float* __restrict__ hT,
    int S, int H, int P, int G, int N, int Q, long x_rs, long b_rs,
    long c_rs) {
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
          ? ld(x + (row0 + c0 + s) * x_rs + (long)h * P + p0 + p) : 0.f;
    }
    for (int idx = tid; idx < Q * N; idx += SSD_NT) {
      const int s = idx / N, n = idx - s * N;
      bs[s * LDB + n] = s < rows
          ? ld(Bm + (row0 + c0 + s) * b_rs + (long)g * N + n) : 0.f;
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

    // (2) + (3), a tile of T rows at a time
    for (int t0 = 0; t0 < rows; t0 += SSD_T) {
      const int tr = min(SSD_T, rows - t0);      // live rows of the tile
      const int smax = t0 + tr;                  // columns s < smax
      __syncthreads();                           // ct, ms free again
      for (int idx = tid; idx < SSD_T * N; idx += SSD_NT) {
        const int i = idx / N, n = idx - i * N;
        ct[n * SSD_T + i] = i < tr
            ? ld(Cm + (row0 + c0 + t0 + i) * c_rs + (long)g * N + n) : 0.f;
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
          store(y + ((row0 + c0 + t) * H + h) * (long)P + p0 + p, acc);
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

template <typename T>
int launch_ssd(const void* x, const float* dt, const float* A, const void* Bm,
               const void* Cm, const float* D, const float* h0, void* y,
               float* hT, int B, int S, int H, int P, int G, int N, int Q,
               long x_rs, long b_rs, long c_rs, cudaStream_t stream) {
  auto kern = ssd_scan_kernel<T>;
  // the attribute is set once, for the largest chunk and state, so that a
  // launch inside a CUDA-graph capture makes no attribute call
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * ssd_smem_floats(SSD_QMAX, SSD_NMAX)));
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const size_t smem = sizeof(float) * ssd_smem_floats(Q, N);
  dim3 grid((P + SSD_PT - 1) / SSD_PT, H, B);
  kern<<<grid, SSD_NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, h0, static_cast<T*>(y), hT, S, H, P, G,
      N, Q, x_rs, b_rs, c_rs);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  D, h0 and hT may be
// null.  1 <= chunk <= 128, 1 <= N <= 128, H a multiple of G; x_rs, b_rs
// and c_rs are the element strides between consecutive (batch, step) rows
// of x, B and C, whose last two axes are contiguous.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            const void* h0, void* y, void* hT, int B, int S,
                            int H, int P, int G, int N, int chunk, long x_rs,
                            long b_rs, long c_rs, int dtype, void* stream) {
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
    return launch_ssd<float>(x, dtf, Af, Bm, Cm, Df, h0f, y, hTf, B, S, H,
                             P, G, N, chunk, x_rs, b_rs, c_rs, st);
  if (dtype == 1)
    return launch_ssd<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, h0f, y, hTf, B,
                                     S, H, P, G, N, chunk, x_rs, b_rs, c_rs,
                                     st);
  return (int)cudaErrorInvalidValue;
}
