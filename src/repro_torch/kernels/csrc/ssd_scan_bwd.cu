// The backward of Mamba2's chunked SSD scan (K8) for Hopper (sm_90a), with
// a plain C interface loaded through ctypes (build.py builds it into the
// port's kernel library, ssd_scan.py's ssd_scan_bwd wraps it).
//
//   ssd_scan_bwd  the gradients of ssd_scan_fwd's y (and final state) with
//                 respect to x, dt, A, B, C, D and the initial state, from
//                 the forward's inputs and dy (and dh_T): dx, dB, dC in x's
//                 dtype, ddt, dA, dD and dh0 fp32.
//
// Replaces the gradient of src/repro/kernels/ssd_scan.py's ssd_pallas
// (:76), which JAX takes by differentiating ops.ssd_chunked_jnp, the
// contract ssd_pallas shares.  It computes what ssd_scan.py's
// ssd_scan_bwd_torch computes, stage for stage.  Per (batch, head, chunk),
// cs is the inclusive scan of dt A over the chunk's steps, L[t, s] =
// exp(cs_t - cs_s) on s <= t, M = (C B^T) o L o dt_s, w = dt exp(cs_last -
// cs), decay = exp(cs_last); the forward is y = M x + exp(cs) C h_in^T + D
// x and h_out = decay h_in + x^T (w B).  Launches, on the caller's stream:
//
//   (0) ssd_incoming_states (ssd_scan.cu): every chunk's incoming state
//       h_in, recomputed by the forward's own stage kernels (the saved
//       tensors stay the inputs);
//   the scores C B^T on the band, per (batch, group, chunk): bf16 the
//       forward's ssd_scores_kernel (ssd_chunk_scores), fp32
//       ssd_bwd_scores_kernel;
//   d h_in                 per (batch, head, chunk): the chunk's own d h_in
//                          = sum_t exp(cs_t) dy_t^T C_t, and its decay;
//   ssd_bwd_pass_kernel    per (batch, head, state entry), in reverse over
//                          the chunks: g = d h_in + decay g from dh_T, each
//                          chunk's outgoing-state gradient g_out, and dh0;
//   the chunk kernel       per (batch, head, chunk): (4') dx = M^T dy + D dy,
//                          the band's d scores, the direct ddt and the d cs
//                          of Z = (dy x^T) o M; the carried-in term's dC
//                          and d cs; (2') dx += w B g_out^T, the dB term w
//                          x g_out, dw; d decay = <g_out, h_in>; the head's
//                          dB and dC partials; then da by the reversed scan
//                          of d cs, ddt and the dA and dD partials;
//   the group sum          dB and dC: the partials of a group's heads summed
//                          in head order (fp32 also adds there the d scores'
//                          products, from a d scores workspace);
//   ssd_bwd_reduce_kernel  per head: dA and dD, the partials summed in a
//                          fixed order.
//
// Deterministic: no atomics; every sum runs in a fixed order, so two runs
// agree bit for bit.  A ragged last chunk is its live rows only (the
// forward's padded steps, dt = 0 and x = B = C = 0, add nothing to any
// gradient), and no gradient of a padded step is written.  It allocates
// nothing: the workspace is the caller's (ssd_scan.py's ssd_bwd_workspace).
//
// bf16 (ssd_bwd_dhin_mma_kernel, ssd_bwd_chunk_mma_kernel,
// ssd_bwd_bc_sum_kernel): every product on the tensor cores, mma.sync
// m16n8k16 with fp32 accumulators.  x, dy, B and C enter as the bf16 they
// are, from shared memory by ldmatrix; each fp32 operand enters as bf16 hi
// + lo (about 16 bits), the hi product first: exp(cs) dy (d h_in), g_out
// and h_in (split once a block into hi and lo planes in shared memory),
// and the band's M^T, dS^T and dS, built in the accumulators' registers
// and used there as A fragments.  mma.sync, not wgmma: the band's operands
// are born in registers 16 rows at a time, each warp owning one row tile,
// and the state terms' fp32 B operands would need swizzled hi and lo
// copies beside the tiles in a shared memory that is already full.  Each
// head's d scores are folded into its own dB and dC partials inside the
// chunk kernel (the columns side forms dS^T, the rows side dS, each from
// its own orientation of the band), so no d score reaches device memory.
// What bounds it on the card: the chunk kernel, one block of 8 warps an SM
// (181,312 B of shared memory), its tiles' loads exposed between blocks,
// then the band's chains (its elementwise work between two products) and
// the state products; and the per-head dB and dC partials, written by the
// chunk kernel and read by the group sum (two fp32 copies of B S H N).
//
// fp32 (the ssd_bwd_*_kernel<float> templates, the first, CUDA-core design,
// kept for the exact-stream gates): fp32 products on the CUDA cores,
// scalar shared-memory loads, the d scores through a workspace; bound by
// the chunk kernel's shared-memory traffic.
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tensor_core.cuh"

// ssd_scan.cu: every chunk's incoming state by the forward's stage kernels
int ssd_incoming_states(const void* x, const float* dt, const float* A,
                        const void* Bm, const float* h0, float* slots,
                        float* decay, int B, int S, int H, int P, int G,
                        int N, int Q, long x_rs, long b_rs, int dtype,
                        cudaStream_t st);
// ssd_scan.cu: every chunk's C B^T band by the forward's ssd_scores_kernel
int ssd_chunk_scores(const void* Bm, const void* Cm, float* scores, int B,
                     int S, int G, int N, int Q, long b_rs, long c_rs,
                     cudaStream_t st);

namespace {

using bf16 = __nv_bfloat16;

constexpr int QMAX = 128;            // steps per chunk, at most
constexpr int NMAX = 128;            // state size, at most
constexpr int PMAX = 64;             // head dim, at most
constexpr int NT = 256;              // threads per block: 8 warps
constexpr int NTC = 512;             // the chunk kernel's: 16 warps
constexpr int TR = 16;               // rows of a band tile

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// dst[r * ld + c] = f(r, c) for r < rows, c < cols, by the block: each
// thread issues FILL loads before it stores any, so that they are in
// flight together
constexpr int FILL = 8;
template <typename F>
__device__ __forceinline__ void fill(float* dst, int ld, int rows, int cols,
                                     F f) {
  const int total = rows * cols;
  const int nt = blockDim.x;
  for (int base = threadIdx.x; base < total; base += FILL * nt) {
    float v[FILL];
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int idx = base + u * nt, r = idx / cols;
      v[u] = idx < total ? f(r, idx - r * cols) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int idx = base + u * nt, r = idx / cols;
      if (idx < total) dst[r * ld + idx - r * cols] = v[u];
    }
  }
}

// Four consecutive values from p (16-byte aligned)
__device__ __forceinline__ float4 ld4v(const float* p) { return ld4(p); }

// dst[r * lds + c] = src[r * rs + c] widened to fp32 for r < rows, c < cols,
// and 0 elsewhere in rows_pad x cols_pad (cols_pad a multiple of 4), by
// the block; a null src reads as zero.  Four values a load where src, rs
// and cols allow it, FILL loads of a thread in flight before it stores any.
template <typename T>
__device__ __forceinline__ void fill_rows(float* dst, int lds, int rows_pad,
                                          int cols_pad, const T* src,
                                          long rs, int rows, int cols) {
  const bool vec = src != nullptr && cols % 4 == 0 && rs % 4 == 0
      && reinterpret_cast<uintptr_t>(src) % (4 * sizeof(T)) == 0;
  if (!vec) {
    fill(dst, lds, rows_pad, cols_pad, [&](int r, int c) {
      return src != nullptr && r < rows && c < cols ? ld(src + r * rs + c)
                                                    : 0.f;
    });
    return;
  }
  const int c4 = cols_pad / 4, total = rows_pad * c4, nt = blockDim.x;
  for (int base = threadIdx.x; base < total; base += FILL * nt) {
    float4 v[FILL];
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int idx = base + u * nt, r = idx / c4, c = (idx - r * c4) * 4;
      v[u] = (idx < total && r < rows && c < cols) ? ld4v(src + r * rs + c)
                                                   : make_float4(0.f, 0.f,
                                                                 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int idx = base + u * nt, r = idx / c4, c = (idx - r * c4) * 4;
      if (idx < total) *reinterpret_cast<float4*>(dst + r * lds + c) = v[u];
    }
  }
}

__host__ __device__ constexpr long align4(long n) { return (n + 3) & ~3L; }
__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of v over a block of NTB threads, in a fixed order (lanes, then
// warps); red holds NTB / 32 + 1 floats.  Every thread must call it.
template <int NTB>
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int w = 0; w < NTB / 32; ++w) t += red[w];
    red[NTB / 32] = t;
  }
  __syncthreads();
  const float r = red[NTB / 32];
  __syncthreads();
  return r;
}

// The chunk's dt (zero past its rows) into dts[0, QMAX) and the inclusive
// scan of dt A into cum (warp 0: 4 steps a lane, then the lanes, as the
// forward's); ends on a barrier.
__device__ void chunk_scan(const float* dt, long off, int H, int rows,
                           float Ah, float* dts, float* cum) {
  for (int s = threadIdx.x; s < QMAX; s += blockDim.x)
    dts[s] = s < rows ? dt[off + (long)s * H] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      run += dts[4 * lane + k] * Ah;
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
    for (int k = 0; k < 4; ++k) cum[4 * lane + k] = excl + v[k];
  }
  __syncthreads();
}

// scores[t][s] = C_t . B_s for s <= t < rows, rows t of the 16-row tile
// blockIdx.x % (QMAX / 16) of chunk blockIdx.x / (QMAX / 16), group
// blockIdx.y, batch row blockIdx.z (Q x Q fp32 a chunk; nothing above the
// band is written).  Thread (s = tid % 128, row parity tid / 128); C's rows
// and B's up to the tile's last in shared memory.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_scores_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    float* __restrict__ scores, int S, int G, int N, int Q, long b_rs,
    long c_rs) {
  extern __shared__ __align__(16) float smem[];
  const int NN = (N + 3) & ~3, LD = NN + 4;
  constexpr int TT = QMAX / 16;                     // tiles a chunk
  float* cs_ = smem;                                // 16 x LD
  float* bs_ = smem + 16 * LD;                      // Q x LD
  const int c = blockIdx.x / TT, t0 = (blockIdx.x % TT) * 16;
  const int g = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x / TT, tid = threadIdx.x;
  const int rows = min(Q, S - c * Q);
  if (t0 >= rows) return;
  const int t1 = min(rows, t0 + 16);                // rows [t0, t1)
  const long r0 = (long)b * S + (long)c * Q;
  fill_rows(cs_, LD, t1 - t0, LD, Cm + (r0 + t0) * c_rs + (long)g * N, c_rs,
            t1 - t0, N);
  fill_rows(bs_, LD, t1, LD, Bm + r0 * b_rs + (long)g * N, b_rs, t1, N);
  __syncthreads();
  float* out = scores + (((long)b * G + g) * nc + c) * Q * Q;
  const int s = tid & 127;
  if (s >= t1) return;
  for (int t = max(t0, s) + ((max(t0, s) + (tid >> 7)) & 1); t < t1;
       t += 2) {
    const float* cr = cs_ + (t - t0) * LD;
    const float* br = bs_ + s * LD;
    float acc = 0.f;
    for (int n = 0; n < NN; n += 4) {
      const float4 cv = ld4(cr + n), bv = ld4(br + n);
      acc += cv.x * bv.x + cv.y * bv.y + cv.z * bv.z + cv.w * bv.w;
    }
    out[(long)t * Q + s] = acc;
  }
}

// The chunk's own d h_in = sum_t exp(cs_t) dy_t^T C_t (P x N, into g at
// (batch, head, chunk)) and its decay exp(cs_last), chunk blockIdx.x, head
// blockIdx.y, batch row blockIdx.z.  Thread (4 n's from 4 (tid % 32), 8
// p's from 8 (tid / 32)): per step a float4 of C and two of dy (the same
// for the whole warp) feed 32 FMAs.
template <typename T>
__global__ void __launch_bounds__(NT) ssd_bwd_dhin_kernel(
    const T* __restrict__ dy, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Cm,
    float* __restrict__ g, float* __restrict__ decay, int S, int H, int P,
    int G, int N, int Q, long c_rs) {
  extern __shared__ __align__(16) float smem[];
  const int PD = (P + 7) & ~7, NN = (N + 3) & ~3, LDC = NN + 4;
  float* dts = smem;                      // QMAX
  float* cum = dts + QMAX;                // QMAX
  float* dys = cum + QMAX;                // Q x PD
  float* cs_ = dys + Q * PD;              // Q x LDC
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int grp = h / (H / G);
  const int rows = min(Q, S - c * Q);
  const long r0 = (long)b * S + (long)c * Q;
  const long bhc = ((long)b * H + h) * nc + c;
  chunk_scan(dt, r0 * H + h, H, rows, A[h], dts, cum);
  fill_rows(dys, PD, rows, PD, dy + (r0 * H + h) * (long)P, (long)H * P,
            rows, P);
  fill_rows(cs_, LDC, rows, LDC, Cm + r0 * c_rs + (long)grp * N, c_rs, rows,
            N);
  if (tid == 0) decay[bhc] = expf(cum[rows - 1]);
  __syncthreads();
  const int n4 = 4 * (tid & 31), p8 = 8 * (tid >> 5);
  if (n4 >= NN || p8 >= P) return;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  for (int t = 0; t < rows; ++t) {
    const float et = expf(cum[t]);
    const float4 cv = ld4(cs_ + t * LDC + n4);
    const float4 d0 = ld4(dys + t * PD + p8);
    const float4 d1 = ld4(dys + t * PD + p8 + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float dv = et * comp(i < 4 ? d0 : d1, i & 3);
      acc[i][0] += dv * cv.x;
      acc[i][1] += dv * cv.y;
      acc[i][2] += dv * cv.z;
      acc[i][3] += dv * cv.w;
    }
  }
  float* out = g + bhc * (long)P * N;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (p8 + i < P && n4 + k < N)
        out[(long)(p8 + i) * N + n4 + k] = acc[i][k];
}

// The pass in reverse over the chunks, one state entry a thread of head
// blockIdx.y, batch row blockIdx.z: g starts at dh_T (or zero); for each
// chunk from the last, its own d h_in is read, its slot gets g (the
// gradient of its outgoing state) and g = d h_in + decay g; dh0 gets the
// last g.
__global__ void __launch_bounds__(NT) ssd_bwd_pass_kernel(
    float* __restrict__ g, const float* __restrict__ decay,
    const float* __restrict__ dhT, float* __restrict__ dh0, int H, int PN,
    int nc) {
  const int e = blockIdx.x * NT + threadIdx.x;
  if (e >= PN) return;
  const long bh = (long)blockIdx.z * H + blockIdx.y;
  float gv = dhT != nullptr ? dhT[bh * PN + e] : 0.f;
  float* gb = g + bh * nc * PN + e;
  const float* db = decay + bh * nc;
  for (int c0 = nc - 1; c0 >= 0; c0 -= 4) {       // four chunks' loads first
    float local[4], dec[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 - u >= 0) {
        local[u] = gb[(long)(c0 - u) * PN];
        dec[u] = db[c0 - u];
      }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (c0 - u >= 0) {
        gb[(long)(c0 - u) * PN] = gv;
        gv = local[u] + dec[u] * gv;
      }
  }
  if (dh0 != nullptr) dh0[bh * PN + e] = gv;
}

// Shared memory of the chunk kernel, in floats, for chunk Q, head dim P,
// state size N: x and dy (Q x (PP + 4), PP = P rounded up to 4), sixteen
// per-step vectors and the block sum's scratch, and one region for the
// band's tiles (M and dy x^T, TR x Q each) or the state phase's B or C (Q
// x (NN + 4), NN = N rounded up to 4), g_out and h_in (PP x (NN + 4)
// each).  Rows are 16-byte aligned for float4 loads; their odd number of
// 16-byte words keeps the rows of a warp's loads on distinct banks.
__host__ __device__ constexpr long chunk_region(int Q, int P, int N) {
  return 2L * TR * Q > (long)(Q + 2 * ((P + 3) & ~3)) * (((N + 3) & ~3) + 4)
      ? 2L * TR * Q : (long)(Q + 2 * ((P + 3) & ~3)) * (((N + 3) & ~3) + 4);
}
__host__ __device__ constexpr long chunk_smem_floats(int Q, int P, int N) {
  return 2L * Q * (((P + 3) & ~3) + 4) + 16 * QMAX + 20
         + chunk_region(Q, P, N);
}

// Everything of one (batch, head, chunk) but the group sums of dB and dC:
// chunk blockIdx.x, head blockIdx.y, batch row blockIdx.z, 16 warps.  The
// band runs by tiles of TR rows t, thread (s = tid % 128, a quarter of the
// tile's rows); the state terms and dx are owned by thread (row s = tid /
// 4, q = tid % 4), dx from the band to the write: the p's (or n's) 16 j +
// 4 q + e (e < 4).  Every product reads its operands in float4s along a
// contiguous axis and keeps a register tile, so that a few shared loads
// feed each group of FMAs.
template <typename T>
__global__ void __launch_bounds__(NTC, 1) ssd_bwd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const T* __restrict__ Bm,
    const T* __restrict__ Cm, const float* __restrict__ Dv,
    const T* __restrict__ dy, const float* __restrict__ scores,
    const float* __restrict__ slots, int zero_first,
    const float* __restrict__ gout, T* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dS,
    float* __restrict__ dCp, float* __restrict__ dBp,
    float* __restrict__ dAp, float* __restrict__ dDp, int S, int H, int P,
    int G, int N, int Q, long x_rs, long b_rs, long c_rs) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RQ = TR / 4;                        // band rows a thread
  const int PP = (P + 3) & ~3, NN = (N + 3) & ~3;
  const int LDX = PP + 4, LDN = NN + 4;
  float* xs = smem;                                 // Q x LDX
  float* dys = xs + Q * LDX;                        // Q x LDX
  float* dts = dys + Q * LDX;                       // QMAX each:
  float* cum = dts + QMAX;                          //   cs
  float* wts = cum + QMAX;                          //   w
  float* dcs = wts + QMAX;                          //   d cs
  float* ddd = dcs + QMAX;                          //   ddt, direct terms
  float* zc = ddd + QMAX;                           //   da
  float* ex = zc + QMAX;                            //   exp(cs)
  float* rel = ex + QMAX;                           //   exp(cs_last - cs)
  float* colp = rel + QMAX;                         // 8 QMAX: column sums
  float* red = colp + 8 * QMAX;                     // 20
  float* reg = red + 20;                            // the tiles' region
  float* Mt = reg;                                  // TR x Q
  float* dMt = reg + TR * Q;                        // TR x Q
  float* bsm = reg;                                 // Q x LDN (B, then C)
  float* gs = reg + Q * LDN;                        // PP x LDN
  float* hs = gs + PP * LDN;                        // PP x LDN

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x;
  const int grp = h / (H / G);
  const int rows = min(Q, S - c * Q);
  const long r0 = (long)b * S + (long)c * Q;
  const long bh = (long)b * H + h, bhc = bh * nc + c;
  const float Ah = A[h];
  const float Dh = Dv != nullptr ? Dv[h] : 0.f;

  chunk_scan(dt, r0 * H + h, H, rows, Ah, dts, cum);
  const float cs_last = cum[rows - 1];
  for (int s = tid; s < QMAX; s += NTC) {
    const bool live = s < rows;
    wts[s] = live ? dts[s] * expf(cs_last - cum[s]) : 0.f;
    rel[s] = live ? expf(cs_last - cum[s]) : 0.f;
    ex[s] = live ? expf(cum[s]) : 0.f;
    dcs[s] = 0.f;
  }
  fill_rows(xs, LDX, Q, LDX, x + r0 * x_rs + (long)h * P, x_rs, rows, P);
  fill_rows(dys, LDX, Q, LDX, dy + (r0 * H + h) * (long)P, (long)H * P, rows,
            P);
  __syncthreads();
  float dd = 0.f;                                   // this thread's dy . x
  for (int idx = tid; idx < Q * LDX; idx += NTC) dd += xs[idx] * dys[idx];
  dd = block_sum<NTC>(dd, red);                     // ends on a barrier
  if (tid == 0) dDp[bhc] = dd;

  // (4') the band, TR rows t at a time: dM = dy_t . x_s and M on s <= t
  const int so = tid >> 2, q = tid & 3;             // dx's owner
  const bool live = so < rows;
  float dxa[PMAX / 16][4];
#pragma unroll
  for (int j = 0; j < PMAX / 16; ++j)
    dxa[j][0] = dxa[j][1] = dxa[j][2] = dxa[j][3] = 0.f;
  const int sb = tid & 127, ib = tid >> 7;          // band: (s, row quarter)
  float a_ddt = 0.f, a_z = 0.f;                     // column s's sums
  const float* sc = scores + (((long)b * G + grp) * nc + c) * Q * Q;
  float* dsh = dS + bhc * (long)Q * Q;
  for (int t0 = 0; t0 < rows; t0 += TR) {
    const int tr = min(TR, rows - t0);
    const int kr = min(RQ, tr - ib * RQ);           // this quarter's rows
    float dm[RQ], sv[RQ];                           // dy_t . x_s, scores
#pragma unroll
    for (int k = 0; k < RQ; ++k) {                  // the scores' loads first
      const int t = t0 + ib * RQ + k;
      dm[k] = 0.f;
      sv[k] = (k < kr && sb <= t) ? sc[(long)t * Q + sb] : 0.f;
    }
    if (sb < rows && sb < t0 + tr && kr > 0) {
      const float* xr = xs + sb * LDX;
      const float* d0 = dys + (t0 + ib * RQ) * LDX;
      for (int p = 0; p < PP; p += 4) {
        const float4 xv = ld4(xr + p);
#pragma unroll
        for (int k = 0; k < RQ; ++k)
          if (k < kr) {
            const float4 dv = ld4(d0 + k * LDX + p);
            dm[k] += dv.x * xv.x + dv.y * xv.y + dv.z * xv.z + dv.w * xv.w;
          }
      }
    }
#pragma unroll
    for (int k = 0; k < RQ; ++k) {
      const int i = ib * RQ + k, t = t0 + i;
      float m = 0.f, dmv = 0.f;
      if (sb < Q && i < tr && sb <= t) {
        const float L = expf(cum[t] - cum[sb]);
        dmv = dm[k];
        m = sv[k] * L * dts[sb];
        dsh[(long)t * Q + sb] = dmv * L * dts[sb];
        a_ddt += dmv * sv[k] * L;
        a_z += dmv * m;
      }
      if (sb < Q) {
        Mt[i * Q + sb] = m;
        dMt[i * Q + sb] = dmv;
      }
    }
    __syncthreads();
    if (live) {                     // dx_s += sum_t M_ts dy_t (M is 0 above
      for (int i = max(0, so - t0); i < tr; ++i) {  // the band)
        const float m = Mt[i * Q + so];
        const float* dr = dys + (t0 + i) * LDX + 4 * q;
#pragma unroll
        for (int j = 0; j < PMAX / 16; ++j)
          if (16 * j + 4 * q < PP) {
            const float4 dv = ld4(dr + 16 * j);
            dxa[j][0] += m * dv.x;
            dxa[j][1] += m * dv.y;
            dxa[j][2] += m * dv.z;
            dxa[j][3] += m * dv.w;
          }
      }
    }
    {                                               // d cs_t += sum_s Z_ts
      const int warp = tid >> 5, lane = tid & 31;
      for (int i = warp; i < tr; i += NTC / 32) {
        float z = 0.f;
        for (int s = lane; s <= t0 + i; s += 32)
          z += Mt[i * Q + s] * dMt[i * Q + s];
        z = warp_sum(z);
        if (lane == 0) dcs[t0 + i] += z;
      }
    }
    __syncthreads();
  }
  // the column sums of the four row quarters, added in order
  if (sb < Q) {
    colp[ib * QMAX + sb] = a_ddt;
    colp[(4 + ib) * QMAX + sb] = a_z;
  }
  __syncthreads();
  for (int s = tid; s < rows; s += NTC) {
    float sd = 0.f, sz = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sd += colp[k * QMAX + s];
      sz += colp[(4 + k) * QMAX + s];
    }
    ddd[s] = sd;
    dcs[s] -= sz;
  }

  // (2') the chunk state's terms: B, g_out and h_in into the region
  const float* hin = (zero_first && c == 0)
      ? nullptr : slots + (bh * (nc + 1) + c) * (long)P * round16(N);
  const float* go = gout + bhc * (long)P * N;
  fill_rows(bsm, LDN, Q, LDN, Bm + r0 * b_rs + (long)grp * N, b_rs, rows,
            N);
  fill_rows(gs, LDN, PP, LDN, go, (long)N, P, N);
  fill_rows(hs, LDN, PP, LDN, hin, (long)round16(N), P, N);
  __syncthreads();
  float dec_dot = 0.f;                              // <g_out, h_in>
  for (int idx = tid; idx < PP * LDN; idx += NTC)
    dec_dot += gs[idx] * hs[idx];
  dec_dot = block_sum<NTC>(dec_dot, red);           // ends on a barrier
  float dw = 0.f;                                   // dw of row so
  if (live) {
    float u[PMAX / 16][4];                          // (B g_out^T)[s][p]
#pragma unroll
    for (int j = 0; j < PMAX / 16; ++j)
      u[j][0] = u[j][1] = u[j][2] = u[j][3] = 0.f;
    const float* br = bsm + so * LDN;
    for (int n = 0; n < NN; n += 4) {
      const float4 bv = ld4(br + n);
#pragma unroll
      for (int j = 0; j < PMAX / 16; ++j)
        if (16 * j + 4 * q < PP) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 gv = ld4(gs + (16 * j + 4 * q + e) * LDN + n);
            u[j][e] += bv.x * gv.x + bv.y * gv.y + bv.z * gv.z
                       + bv.w * gv.w;
          }
        }
    }
    const float ws = wts[so];
    T* out = dx + ((r0 + so) * H + h) * (long)P;
#pragma unroll
    for (int j = 0; j < PMAX / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * j + 4 * q + e;
        if (p < P) {
          dw += xs[so * LDX + p] * u[j][e];
          st(out + p, dxa[j][e] + ws * u[j][e] + Dh * dys[so * LDX + p]);
        }
      }
  }
  dw += __shfl_xor_sync(0xffffffffu, dw, 1);        // the row's quarters
  dw += __shfl_xor_sync(0xffffffffu, dw, 2);
  float dw_w = 0.f;                                 // this thread's dw w
  if (live && q == 0) {
    ddd[so] += dw * rel[so];
    dcs[so] -= dw * wts[so];
    dw_w = dw * wts[so];
  }
  if (live) {  // dB partial of this head: w_s sum_p x_s[p] g_out[p][n]
    float acc[NMAX / 16][4];                        // n = 16 j + 4 q + e
#pragma unroll
    for (int j = 0; j < NMAX / 16; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    const float* xr = xs + so * LDX;
    for (int p = 0; p < P; ++p) {
      const float xv = xr[p];
      const float* gr = gs + p * LDN + 4 * q;
#pragma unroll
      for (int j = 0; j < NMAX / 16; ++j)
        if (16 * j + 4 * q < NN) {
          const float4 gv = ld4(gr + 16 * j);
          acc[j][0] += xv * gv.x;
          acc[j][1] += xv * gv.y;
          acc[j][2] += xv * gv.z;
          acc[j][3] += xv * gv.w;
        }
    }
    const float ws = wts[so];
    float* out = dBp + ((r0 + so) * H + h) * (long)N;
#pragma unroll
    for (int j = 0; j < NMAX / 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (16 * j + 4 * q + e < N) out[16 * j + 4 * q + e] = ws * acc[j][e];
  }
  dw_w = block_sum<NTC>(dw_w, red);                 // ends on a barrier
  // C into the region's first part (B is done with)
  fill_rows(bsm, LDN, Q, LDN, Cm + r0 * c_rs + (long)grp * N, c_rs, rows,
            N);
  __syncthreads();
  {  // dC partial of this head: exp(cs_t) sum_p dy_t[p] h_in[p][n], and
     // d cs_t += C_t . that
    float zt = 0.f;
    if (live) {
      float acc[NMAX / 16][4];
#pragma unroll
      for (int j = 0; j < NMAX / 16; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      const float* dr = dys + so * LDX;
      for (int p = 0; p < P; ++p) {
        const float gv = dr[p];
        const float* hr = hs + p * LDN + 4 * q;
#pragma unroll
        for (int j = 0; j < NMAX / 16; ++j)
          if (16 * j + 4 * q < NN) {
            const float4 hv = ld4(hr + 16 * j);
            acc[j][0] += gv * hv.x;
            acc[j][1] += gv * hv.y;
            acc[j][2] += gv * hv.z;
            acc[j][3] += gv * hv.w;
          }
      }
      const float e_t = ex[so];
      const float* cr = bsm + so * LDN;
      float* out = dCp + ((r0 + so) * H + h) * (long)N;
#pragma unroll
      for (int j = 0; j < NMAX / 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 16 * j + 4 * q + e;
          if (n < N) {
            const float v = e_t * acc[j][e];
            out[n] = v;
            zt += cr[n] * v;
          }
        }
    }
    zt += __shfl_xor_sync(0xffffffffu, zt, 1);
    zt += __shfl_xor_sync(0xffffffffu, zt, 2);
    if (live && q == 0) dcs[so] += zt;
  }
  __syncthreads();
  if (tid == 0) dcs[rows - 1] += dw_w + expf(cs_last) * dec_dot;
  __syncthreads();
  // d cs -> da = reversed inclusive scan inside the chunk (warp 0)
  if (tid < 32) {
    const int lane = tid;
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const int r = 4 * lane + k;
      run += r < rows ? dcs[r] : 0.f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (lane + o < 32) incl += t;
    }
    const float excl = incl - run;                  // the lanes above
#pragma unroll
    for (int k = 0; k < 4; ++k) zc[4 * lane + k] = excl + v[k];
  }
  __syncthreads();
  float da_dt = 0.f;
  for (int r = tid; r < rows; r += NTC) {
    ddt[(r0 + r) * H + h] = ddd[r] + zc[r] * Ah;
    da_dt += zc[r] * dts[r];
  }
  da_dt = block_sum<NTC>(da_dt, red);
  if (tid == 0) dAp[bhc] = da_dt;
}

// (1') dC (role 0) or dB (role 1) of a tile of TR rows of chunk
// blockIdx.y, group blockIdx.z % G, batch row blockIdx.z / G; blockIdx.x =
// 2 tile + role.  The group's d scores (the sum over its heads, in order)
// for the tile's rows (dC: d scores[t][s], s <= t) or columns (dB: d
// scores[t][s], t >= s) go to shared memory with the other operand, B or
// C; then out = sum over the group's heads of the partials + that product.
// Thread (4 n's from 4 (tid % 32), 2 rows from 2 (tid / 32)).
template <typename T>
__global__ void __launch_bounds__(NT, 1) ssd_bwd_bc_kernel(
    const T* __restrict__ Bm, const T* __restrict__ Cm,
    const float* __restrict__ dS, const float* __restrict__ dCp,
    const float* __restrict__ dBp, T* __restrict__ dB, T* __restrict__ dC,
    int S, int H, int G, int N, int Q, long b_rs, long c_rs) {
  extern __shared__ __align__(16) float smem[];
  const int NN = (N + 3) & ~3, LDN = NN + 4;
  float* dsg = smem;                                // TR x Q
  float* op = smem + TR * Q;                        // Q x LDN
  const int role = blockIdx.x & 1, i0 = (blockIdx.x >> 1) * TR;
  const int c = blockIdx.y, grp = blockIdx.z % G, b = blockIdx.z / G;
  const int nc = gridDim.y, rep = H / G, tid = threadIdx.x;
  const int rows = min(Q, S - c * Q);
  if (i0 >= rows) return;
  const int tr = min(TR, rows - i0);
  const long r0 = (long)b * S + (long)c * Q;
  const float* ds0 = dS + (((long)b * H + grp * rep) * nc + c) * Q * Q;
  const long hstride = (long)nc * Q * Q;
  // role 0: dsg[i][s] = sum_h dS[i0 + i][s], s <= i0 + i; role 1:
  // dsg[i][t] = sum_h dS[t][i0 + i], t >= i0 + i
  constexpr int BF = FILL / 2;                      // entries at once
  for (int base = tid; base < TR * Q; base += BF * NT) {
    int off[BF];
    float v[BF];
#pragma unroll
    for (int u = 0; u < BF; ++u) {
      const int idx = base + u * NT, i = idx / Q, k = idx - i * Q;
      const int t = role ? k : i0 + i, s = role ? i0 + i : k;
      off[u] = (idx < TR * Q && i < tr && k < rows && s <= t) ? t * Q + s
                                                              : -1;
      v[u] = 0.f;
    }
    for (int r = 0; r < rep; ++r) {
      const float* hr = ds0 + r * hstride;
#pragma unroll
      for (int u = 0; u < BF; ++u)
        if (off[u] >= 0) v[u] += hr[off[u]];
    }
#pragma unroll
    for (int u = 0; u < BF; ++u)
      if (base + u * NT < TR * Q) dsg[base + u * NT] = v[u];
  }
  const T* src = role ? Cm : Bm;
  const long rs = role ? c_rs : b_rs;
  const int k_lo = role ? i0 : 0, k_hi = role ? rows : i0 + tr;
  fill_rows(op + k_lo * LDN, LDN, k_hi - k_lo, LDN,
            src + (r0 + k_lo) * rs + (long)grp * N, rs, k_hi - k_lo, N);
  __syncthreads();
  const int n4 = 4 * (tid & 31), i2 = 2 * (tid >> 5);
  if (n4 >= NN) return;
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int k = k_lo; k < k_hi; ++k) {
    const float4 ov = ld4(op + k * LDN + n4);
    const float g0 = dsg[i2 * Q + k], g1 = dsg[(i2 + 1) * Q + k];
    acc[0][0] += g0 * ov.x;
    acc[0][1] += g0 * ov.y;
    acc[0][2] += g0 * ov.z;
    acc[0][3] += g0 * ov.w;
    acc[1][0] += g1 * ov.x;
    acc[1][1] += g1 * ov.y;
    acc[1][2] += g1 * ov.z;
    acc[1][3] += g1 * ov.w;
  }
  const float* part = role ? dBp : dCp;
  T* out = role ? dB : dC;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = i2 + j;
    if (i >= tr) continue;
    const long row = r0 + i0 + i;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n4 + e;
      if (n >= N) continue;
      const float* pr = part + (row * H + grp * rep) * (long)N + n;
      float v = 0.f;
#pragma unroll 8
      for (int r = 0; r < rep; ++r) v += pr[(long)r * N];
      st(out + (row * G + grp) * (long)N + n, v + acc[j][e]);
    }
  }
}

// dA[h] and dD[h]: the (batch, chunk) partials summed in order
__global__ void ssd_bwd_reduce_kernel(const float* __restrict__ dAp,
                                      const float* __restrict__ dDp,
                                      float* __restrict__ dA,
                                      float* __restrict__ dD, int B, int H,
                                      int nc) {
  const int h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= H) return;
  float sa = 0.f, sd = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < nc; ++c) {
      sa += dAp[((long)b * H + h) * nc + c];
      sd += dDp[((long)b * H + h) * nc + c];
    }
  dA[h] = sa;
  if (dD != nullptr) dD[h] = sd;
}

// --------------------------------------------------------------------------
// bf16: the tensor-core kernels
// --------------------------------------------------------------------------
constexpr int LDPB = tc_ld(PMAX);       // bf16 row of x or dy (P padded)
constexpr int LDNB = tc_ld(NMAX);       // bf16 row of B or C (N padded)
constexpr int NTM = 256;                // the chunk kernel's threads: 8 warps

// Four fp32 values of row p, columns n .. n + 3 of a row-major matrix
// (row stride rs, P x N), zero past its edges; one 16-byte load where vec
// (a 16-byte aligned source, rs a multiple of 4)
__device__ __forceinline__ float4 ld_row4(const float* src, long rs, int p,
                                          int n, int P, int N, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p >= P || n >= N) return v;
  const float* r = src + p * rs + n;
  if (vec && n + 4 <= N) return *reinterpret_cast<const float4*>(r);
  v.x = r[0];
  if (n + 1 < N) v.y = r[1];
  if (n + 2 < N) v.z = r[2];
  if (n + 3 < N) v.w = r[3];
  return v;
}

// four fp32 values as bf16 hi and lo (split_bf16) at hi[0 .. 3], lo[0 .. 3]
__device__ __forceinline__ void store_split4(bf16* hi, bf16* lo, float4 v) {
  uint2 h, l;
  split_bf16(v.x, v.y, h.x, l.x);
  split_bf16(v.z, v.w, h.y, l.y);
  *reinterpret_cast<uint2*>(hi) = h;
  *reinterpret_cast<uint2*>(lo) = l;
}

__device__ __forceinline__ float2 ld_bf2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Row half e of a 16-row tile's accumulators over n8 tiles (this lane's
// columns 8 j + 2 (lane % 4), + 1) into out[0, N): pairs where N is even
__device__ __forceinline__ void store_row(float* out, const float (*acc)[4],
                                          int e, int q, int N) {
#pragma unroll
  for (int j = 0; j < NMAX / 8; ++j) {
    const int n = 8 * j + 2 * q;
    if (N % 2 == 0 && n < N) {
      *reinterpret_cast<float2*>(out + n) =
          make_float2(acc[j][2 * e], acc[j][2 * e + 1]);
    } else {
      if (n < N) out[n] = acc[j][2 * e];
      if (n + 1 < N) out[n + 1] = acc[j][2 * e + 1];
    }
  }
}

// the sum over the four lanes of a quad (the lanes holding one row of an
// mma fragment)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Shared memory of the bf16 kernels, in bytes: d h_in's three per-step
// vectors, dy and C; the chunk kernel's x, dy, B, C, the bf16 hi and lo
// planes of g_out and of h_in, ten per-step vectors and the block sum's
// scratch
constexpr int DHIN_SMEM = 3 * QMAX * 4 + QMAX * LDPB * 2 + QMAX * LDNB * 2;
constexpr int CHUNK_SMEM = 2 * QMAX * LDPB * 2 + 2 * QMAX * LDNB * 2
                           + 4 * PMAX * LDNB * 2 + 10 * QMAX * 4 + 16 * 4;
constexpr int GV = PMAX * NMAX / 4 / NTM;   // g_out's float4s a thread

// The chunk's own d h_in = sum_t exp(cs_t) dy_t^T C_t (P x N fp32, into g
// at (batch, head, chunk)) and its decay exp(cs_last): chunk blockIdx.x,
// head blockIdx.y, batch row blockIdx.z, 4 warps, warp w the m16 tile w of
// p.  The forward's state product with exp(cs) dy in place of w x: the A
// operand (exp(cs) dy)^T built in registers from dy in shared memory and
// split hi + lo (fp32), C the B operand by ldmatrix .trans; mma.sync
// m16n8k16, fp32 accumulators, 16 n8 tiles of the state a warp.
__global__ void __launch_bounds__(128) ssd_bwd_dhin_mma_kernel(
    const bf16* __restrict__ dy, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Cm,
    float* __restrict__ g, float* __restrict__ decay, int S, int H, int P,
    int G, int N, int Q, long c_rs) {
  extern __shared__ __align__(16) float smem[];
  float* dts = smem;                             // QMAX
  float* cum = dts + QMAX;                       // QMAX
  float* ex = cum + QMAX;                        // QMAX: exp(cs)
  bf16* dys = reinterpret_cast<bf16*>(ex + QMAX);   // QMAX x LDPB, [t][p]
  bf16* csm = dys + QMAX * LDPB;                 // QMAX x LDNB, [t][n]
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g8 = lane >> 2, q = lane & 3;
  const int grp = h / (H / G);
  const int rows = min(Q, S - c * Q), KT = (rows + 15) / 16;
  const int Pp = round16(P), Np = round16(N);
  const long r0 = (long)b * S + (long)c * Q;
  const long bhc = ((long)b * H + h) * nc + c;
  copy_tile(dys, LDPB, dy + (r0 * H + h) * (long)P, (long)H * P, rows,
            16 * KT, P, Pp, tid, 128);
  copy_tile(csm, LDNB, Cm + r0 * c_rs + (long)grp * N, c_rs, rows, 16 * KT,
            N, Np, tid, 128);
  cp_async_commit();
  chunk_scan(dt, r0 * H + h, H, rows, A[h], dts, cum);
  for (int s = tid; s < QMAX; s += 128) ex[s] = s < rows ? expf(cum[s]) : 0.f;
  if (tid == 0) decay[bhc] = expf(cum[rows - 1]);
  cp_async_wait<0>();
  __syncthreads();
  if (16 * warp >= Pp) return;
  float acc[NMAX / 8][4];
#pragma unroll
  for (int j = 0; j < NMAX / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  for (int kk = 0; kk < KT; ++kk) {
    // A fragment f: p = 16 warp + lane / 4 (+ 8 for f odd), steps t, t + 1
    // with t = 16 kk + 2 (lane % 4) (+ 8 for f >= 2)
    uint32_t ah[4], al[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      const int p = 16 * warp + g8 + 8 * (f & 1);
      const int t = 16 * kk + 2 * q + 8 * (f >> 1);
      split_bf16(ex[t] * __bfloat162float(dys[t * LDPB + p]),
                 ex[t + 1] * __bfloat162float(dys[(t + 1) * LDPB + p]),
                 ah[f], al[f]);
    }
    const bf16* cr = csm + (16 * kk + (lane & 7) + (lane & 8)) * LDNB
                     + (lane >> 4) * 8;
#pragma unroll
    for (int jp = 0; jp < NMAX / 16; ++jp)
      if (16 * jp < Np) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, cr + 16 * jp);
        mma_bf16_16816(acc[2 * jp], ah, bb[0], bb[1]);
        mma_bf16_16816(acc[2 * jp], al, bb[0], bb[1]);
        mma_bf16_16816(acc[2 * jp + 1], ah, bb[2], bb[3]);
        mma_bf16_16816(acc[2 * jp + 1], al, bb[2], bb[3]);
      }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int p = 16 * warp + g8 + 8 * e;
    if (p < P) store_row(g + (bhc * P + p) * (long)N, acc, e, q, N);
  }
}

// Everything of one (batch, head, chunk) but the sums of dB and dC over a
// group's heads, on the tensor cores: chunk blockIdx.x, head blockIdx.y,
// batch row blockIdx.z, 8 warps.  x, dy, B and C sit in shared memory as
// bf16, brought by cp.async, and g_out and h_in as bf16 hi and lo planes,
// split once a block as they are read.  Warp
// i owns the 16-row tile i twice over, first as the steps s of the band's
// columns, then as the steps t of its rows (the column side has MT - i
// band tiles, the row side i + 1: each warp takes MT + 1):
//   columns s: u = B_s g_out^T, dw_s = x_s . u_s, dx_s = w_s u_s; the dB
//     partial w_s x_s g_out; then over the band's tiles t >= s, dM^T = x_s
//     dy_t^T, M^T and dS^T = dM^T o L o dt_s in the accumulators' registers,
//     ddt's direct term and the columns' Z = dM o M, dx_s += M^T dy_t and
//     dB_s += dS^T C_t;
//   rows t: the dC partial exp(cs_t) dy_t h_in and d cs_t's carried-in
//     term C_t . that; then over the tiles s <= t, dM = dy_t x_s^T, dS, the
//     rows' Z, dC_t += dS B_s.
// Each row's partial of dB (columns) and of dC (rows) is written once, to
// the head's slot; the d scores never leave registers.  Then d cs -> da by
// the reversed scan, ddt, and the dA and dD partials, as the fp32 kernel.
// Every product is mma.sync m16n8k16 (fp32 accumulators), its operands by
// ldmatrix (.trans where the depth runs down the rows): x, dy, B and C as
// they are; g_out and h_in once for their hi plane and once for their lo;
// M^T, dS^T and dS, built in the band's accumulators, as A fragments
// split hi + lo in registers.
__global__ void __launch_bounds__(NTM, 1) ssd_bwd_chunk_mma_kernel(
    const bf16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const bf16* __restrict__ Bm,
    const bf16* __restrict__ Cm, const float* __restrict__ Dv,
    const bf16* __restrict__ dy, const float* __restrict__ scores,
    const float* __restrict__ slots, int zero_first,
    const float* __restrict__ gout, bf16* __restrict__ dx,
    float* __restrict__ ddt, float* __restrict__ dCp,
    float* __restrict__ dBp, float* __restrict__ dAp,
    float* __restrict__ dDp, int S, int H, int P, int G, int N, int Q,
    long x_rs, long b_rs, long c_rs) {
  extern __shared__ __align__(16) float smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);      // QMAX x LDPB, [s][p]
  bf16* dys = xs + QMAX * LDPB;                  // QMAX x LDPB, [t][p]
  bf16* bsm = dys + QMAX * LDPB;                 // QMAX x LDNB, [s][n]
  bf16* csm = bsm + QMAX * LDNB;                 // QMAX x LDNB, [t][n]
  bf16* ghi = csm + QMAX * LDNB;                 // PMAX x LDNB each, [p][n]:
  bf16* glo = ghi + PMAX * LDNB;                 //   g_out hi, lo
  bf16* hhi = glo + PMAX * LDNB;                 //   h_in hi, lo
  bf16* hlo = hhi + PMAX * LDNB;
  float* dts = reinterpret_cast<float*>(hlo + PMAX * LDNB);  // QMAX each:
  float* cum = dts + QMAX;                       //   cs
  float* ex = cum + QMAX;                        //   exp(cs)
  float* wts = ex + QMAX;                        //   w
  float* rel = wts + QMAX;                       //   exp(cs_last - cs)
  float* ddd = rel + QMAX;                       //   ddt, direct terms
  float* dcs = ddd + QMAX;                       //   d cs, the columns'
  float* dct = dcs + QMAX;                       //   d cs, the rows'
  float* zc = dct + QMAX;                        //   da
  float* dww = zc + QMAX;                        //   dw w
  float* red = dww + QMAX;                       // 16

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.x, tid = threadIdx.x, warp = tid >> 5;
  const int lane = tid & 31, g8 = lane >> 2, q = lane & 3;
  const int grp = h / (H / G);
  const int rows = min(Q, S - c * Q), MT = (rows + 15) / 16, Qr = 16 * MT;
  const int Pp = round16(P), Np = round16(N), Qp = round16(Q);
  const long r0 = (long)b * S + (long)c * Q;
  const long bh = (long)b * H + h, bhc = bh * nc + c;
  const float Ah = A[h];
  const float Dh = Dv != nullptr ? Dv[h] : 0.f;
  const bool has_in = !(zero_first && c == 0);

  copy_tile(xs, LDPB, x + r0 * x_rs + (long)h * P, x_rs, rows, Qr, P, Pp,
            tid, NTM);
  copy_tile(dys, LDPB, dy + (r0 * H + h) * (long)P, (long)H * P, rows, Qr, P,
            Pp, tid, NTM);
  copy_tile(bsm, LDNB, Bm + r0 * b_rs + (long)grp * N, b_rs, rows, Qr, N, Np,
            tid, NTM);
  copy_tile(csm, LDNB, Cm + r0 * c_rs + (long)grp * N, c_rs, rows, Qr, N, Np,
            tid, NTM);
  cp_async_commit();
  float dec_dot = 0.f;                           // <g_out, h_in>
  {  // g_out and h_in into their hi and lo planes, every load first
    const float* gsrc = gout + bhc * (long)P * N;
    const float* hsrc = slots + (bh * (nc + 1) + c) * (long)P * round16(N);
    const bool gvec = (reinterpret_cast<uintptr_t>(gsrc) & 15) == 0
                      && N % 4 == 0;
    const int c4 = Np / 4;
    float4 gv[GV], hv[GV];
#pragma unroll
    for (int u = 0; u < GV; ++u) {
      const int idx = tid + u * NTM, pp = idx / c4, n = (idx - pp * c4) * 4;
      gv[u] = ld_row4(gsrc, N, pp, n, idx < Pp * c4 ? P : 0, N, gvec);
      hv[u] = ld_row4(hsrc, round16(N), pp, n, has_in && idx < Pp * c4 ? P
                                                                     : 0,
                      N, true);
    }
#pragma unroll
    for (int u = 0; u < GV; ++u) {
      const int idx = tid + u * NTM, pp = idx / c4, n = (idx - pp * c4) * 4;
      if (idx >= Pp * c4) continue;
      store_split4(ghi + pp * LDNB + n, glo + pp * LDNB + n, gv[u]);
      store_split4(hhi + pp * LDNB + n, hlo + pp * LDNB + n, hv[u]);
      dec_dot += gv[u].x * hv[u].x + gv[u].y * hv[u].y + gv[u].z * hv[u].z
                 + gv[u].w * hv[u].w;
    }
  }
  chunk_scan(dt, r0 * H + h, H, rows, Ah, dts, cum);
  const float cs_last = cum[rows - 1];
  for (int s = tid; s < QMAX; s += NTM) {
    const bool live = s < rows;
    wts[s] = live ? dts[s] * expf(cs_last - cum[s]) : 0.f;
    rel[s] = live ? expf(cs_last - cum[s]) : 0.f;
    ex[s] = live ? expf(cum[s]) : 0.f;
  }
  cp_async_wait<0>();
  __syncthreads();
  float dd = 0.f;                                // this thread's dy . x
  for (int idx = tid; idx < Qr * (PMAX / 8); idx += NTM) {
    const int r = idx / (PMAX / 8), k = 8 * (idx % (PMAX / 8));
    if (k >= Pp) continue;
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const float2 xv = ld_bf2(xs + r * LDPB + k + j);
      const float2 yv = ld_bf2(dys + r * LDPB + k + j);
      dd += xv.x * yv.x + xv.y * yv.y;
    }
  }
  dd = block_sum<NTM>(dd, red);                  // ends on a barrier
  dec_dot = block_sum<NTM>(dec_dot, red);
  const float* sc = scores + (((long)b * G + grp) * nc + c) * Qp * Qp;

  const int i0 = 16 * warp;                      // the warp's rows
  if (warp < MT) {
    // ---- columns s = i0 + lane / 4 (+ 8): u, dx, dB ----
    uint32_t xa[PMAX / 16][4];                   // x_s, depth p
    float dxa[PMAX / 8][4];                      // u, then dx
    float dba[NMAX / 8][4];                      // dB of rows s
    float dw[2] = {0.f, 0.f}, ws[2];             // rows s and s + 8
#pragma unroll
    for (int kk = 0; kk < PMAX / 16; ++kk)
      if (16 * kk < Pp)
        ldmatrix_x4(xa[kk], xs + (i0 + (lane & 7) + (lane & 8)) * LDPB
                                + 16 * kk + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < PMAX / 8; ++j)
      dxa[j][0] = dxa[j][1] = dxa[j][2] = dxa[j][3] = 0.f;
    for (int kk = 0; kk < Np / 16; ++kk) {       // u = B_s g_out^T, depth n
      uint32_t ba[4];
      ldmatrix_x4(ba, bsm + (i0 + (lane & 7) + (lane & 8)) * LDNB + 16 * kk
                          + (lane >> 4) * 8);
      const int go = ((lane & 7) + (lane >> 4) * 8) * LDNB + 16 * kk
                     + (lane & 8);
#pragma unroll
      for (int jp = 0; jp < PMAX / 16; ++jp)
        if (16 * jp < Pp) {
          uint32_t bh[4], bl[4];
          ldmatrix_x4(bh, ghi + 16 * jp * LDNB + go);
          ldmatrix_x4(bl, glo + 16 * jp * LDNB + go);
          mma_bf16_16816(dxa[2 * jp], ba, bh[0], bh[1]);
          mma_bf16_16816(dxa[2 * jp], ba, bl[0], bl[1]);
          mma_bf16_16816(dxa[2 * jp + 1], ba, bh[2], bh[3]);
          mma_bf16_16816(dxa[2 * jp + 1], ba, bl[2], bl[3]);
        }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = i0 + g8 + 8 * e;
#pragma unroll
      for (int j = 0; j < PMAX / 8; ++j)
        if (8 * j < Pp) {
          const float2 xv = ld_bf2(xs + s * LDPB + 8 * j + 2 * q);
          dw[e] += xv.x * dxa[j][2 * e] + xv.y * dxa[j][2 * e + 1];
        }
      dw[e] = quad_sum(dw[e]);
      ws[e] = wts[s];
#pragma unroll
      for (int j = 0; j < PMAX / 8; ++j) {
        dxa[j][2 * e] *= ws[e];
        dxa[j][2 * e + 1] *= ws[e];
      }
    }
#pragma unroll
    for (int j = 0; j < NMAX / 8; ++j)
      dba[j][0] = dba[j][1] = dba[j][2] = dba[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < PMAX / 16; ++kk)       // x_s g_out, depth p
      if (16 * kk < Pp) {
        const int go = (16 * kk + (lane & 7) + (lane & 8)) * LDNB
                       + (lane >> 4) * 8;
#pragma unroll
        for (int jp = 0; jp < NMAX / 16; ++jp)
          if (16 * jp < Np) {
            uint32_t bh[4], bl[4];
            ldmatrix_x4_trans(bh, ghi + go + 16 * jp);
            ldmatrix_x4_trans(bl, glo + go + 16 * jp);
            mma_bf16_16816(dba[2 * jp], xa[kk], bh[0], bh[1]);
            mma_bf16_16816(dba[2 * jp], xa[kk], bl[0], bl[1]);
            mma_bf16_16816(dba[2 * jp + 1], xa[kk], bh[2], bh[3]);
            mma_bf16_16816(dba[2 * jp + 1], xa[kk], bl[2], bl[3]);
          }
      }
#pragma unroll
    for (int j = 0; j < NMAX / 8; ++j) {
      dba[j][0] *= ws[0];
      dba[j][1] *= ws[0];
      dba[j][2] *= ws[1];
      dba[j][3] *= ws[1];
    }
    // the band, tiles t >= s: the scores at (t, s) for this thread's
    // (s = i0 + lane / 4 + 8 e, t = 16 jt + 8 jn + 2 (lane % 4) + u)
    float ddt_r[2] = {0.f, 0.f}, zs[2] = {0.f, 0.f};
    float snext[8];
    auto load_cols = [&](int jt, float* v) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = k & 1, jn = (k >> 1) & 1, u = k >> 2;
        v[k] = sc[(long)(16 * jt + 8 * jn + 2 * q + u) * Qp + i0 + g8
                  + 8 * e];
      }
    };
    load_cols(warp, snext);
    for (int jt = warp; jt < MT; ++jt) {
      float sv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) sv[k] = snext[k];
      if (jt + 1 < MT) load_cols(jt + 1, snext);
      float dm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < PMAX / 16; ++kk)     // dM^T = x_s dy_t^T
        if (16 * kk < Pp) {
          uint32_t bb[4];
          ldmatrix_x4(bb, dys + (16 * jt + (lane & 7) + (lane >> 4) * 8)
                                    * LDPB + 16 * kk + (lane & 8));
          mma_bf16_16816(dm[0], xa[kk], bb[0], bb[1]);
          mma_bf16_16816(dm[1], xa[kk], bb[2], bb[3]);
        }
      uint32_t mh[4], ml[4], dh[4], dl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {              // A fragment f: row half
        const int e = f & 1, jn = f >> 1;        // e, column tile jn
        const int s = i0 + g8 + 8 * e;
        const float cs_s = cum[s], dt_s = dts[s];
        float mv[2], dv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int t = 16 * jt + 8 * jn + 2 * q + u;
          const bool on = t >= s;
          const float L = expf(fminf(cum[t] - cs_s, 0.f));
          const float scv = sv[e + 2 * jn + 4 * u];
          const float dmv = on ? dm[jn][2 * e + u] : 0.f;
          mv[u] = on ? scv * L * dt_s : 0.f;
          dv[u] = dmv * L * dt_s;
          ddt_r[e] += dmv * scv * L;
          zs[e] += dmv * mv[u];
        }
        split_bf16(mv[0], mv[1], mh[f], ml[f]);
        split_bf16(dv[0], dv[1], dh[f], dl[f]);
      }
      const int kr = 16 * jt + (lane & 7) + (lane & 8), kc = (lane >> 4) * 8;
#pragma unroll
      for (int jp = 0; jp < PMAX / 16; ++jp)     // dx_s += M^T dy_t
        if (16 * jp < Pp) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, dys + kr * LDPB + 16 * jp + kc);
          mma_bf16_16816(dxa[2 * jp], mh, bb[0], bb[1]);
          mma_bf16_16816(dxa[2 * jp], ml, bb[0], bb[1]);
          mma_bf16_16816(dxa[2 * jp + 1], mh, bb[2], bb[3]);
          mma_bf16_16816(dxa[2 * jp + 1], ml, bb[2], bb[3]);
        }
#pragma unroll
      for (int jp = 0; jp < NMAX / 16; ++jp)     // dB_s += dS^T C_t
        if (16 * jp < Np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, csm + kr * LDNB + 16 * jp + kc);
          mma_bf16_16816(dba[2 * jp], dh, bb[0], bb[1]);
          mma_bf16_16816(dba[2 * jp], dl, bb[0], bb[1]);
          mma_bf16_16816(dba[2 * jp + 1], dh, bb[2], bb[3]);
          mma_bf16_16816(dba[2 * jp + 1], dl, bb[2], bb[3]);
        }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int s = i0 + g8 + 8 * e;
      const float dr = quad_sum(ddt_r[e]), z = quad_sum(zs[e]);
      if (s >= rows) continue;
      if (q == 0) {
        ddd[s] = dr + dw[e] * rel[s];
        dcs[s] = -z - dw[e] * ws[e];
        dww[s] = dw[e] * ws[e];
      }
      bf16* xo = dx + ((r0 + s) * H + h) * (long)P;
#pragma unroll
      for (int j = 0; j < PMAX / 8; ++j) {
        const int p = 8 * j + 2 * q;
        if (p >= P) continue;
        const float2 dv = ld_bf2(dys + s * LDPB + p);
        const float v0 = dxa[j][2 * e] + Dh * dv.x;
        const float v1 = dxa[j][2 * e + 1] + Dh * dv.y;
        if (P % 2 == 0) {
          *reinterpret_cast<__nv_bfloat162*>(xo + p) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          xo[p] = __float2bfloat16(v0);
          if (p + 1 < P) xo[p + 1] = __float2bfloat16(v1);
        }
      }
      store_row(dBp + ((r0 + s) * H + h) * (long)N, dba, e, q, N);
    }
  }
  if (warp < MT) {
    // ---- rows t = i0 + lane / 4 (+ 8): dC ----
    uint32_t ya[PMAX / 16][4];                   // dy_t, depth p
#pragma unroll
    for (int kk = 0; kk < PMAX / 16; ++kk)
      if (16 * kk < Pp)
        ldmatrix_x4(ya[kk], dys + (i0 + (lane & 7) + (lane & 8)) * LDPB
                                + 16 * kk + (lane >> 4) * 8);
    float dca[NMAX / 8][4];
#pragma unroll
    for (int j = 0; j < NMAX / 8; ++j)
      dca[j][0] = dca[j][1] = dca[j][2] = dca[j][3] = 0.f;
    float carried[2] = {0.f, 0.f};
    if (has_in) {
#pragma unroll
      for (int kk = 0; kk < PMAX / 16; ++kk)     // dy_t h_in, depth p
        if (16 * kk < Pp) {
          const int ho = (16 * kk + (lane & 7) + (lane & 8)) * LDNB
                         + (lane >> 4) * 8;
#pragma unroll
          for (int jp = 0; jp < NMAX / 16; ++jp)
            if (16 * jp < Np) {
              uint32_t bh[4], bl[4];
              ldmatrix_x4_trans(bh, hhi + ho + 16 * jp);
              ldmatrix_x4_trans(bl, hlo + ho + 16 * jp);
              mma_bf16_16816(dca[2 * jp], ya[kk], bh[0], bh[1]);
              mma_bf16_16816(dca[2 * jp], ya[kk], bl[0], bl[1]);
              mma_bf16_16816(dca[2 * jp + 1], ya[kk], bh[2], bh[3]);
              mma_bf16_16816(dca[2 * jp + 1], ya[kk], bl[2], bl[3]);
            }
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) {              // exp(cs_t), C_t . dC_t
        const int t = i0 + g8 + 8 * e;
        const float et = ex[t];
#pragma unroll
        for (int j = 0; j < NMAX / 8; ++j) {
          dca[j][2 * e] *= et;
          dca[j][2 * e + 1] *= et;
          if (8 * j < Np) {
            const float2 cv = ld_bf2(csm + t * LDNB + 8 * j + 2 * q);
            carried[e] += cv.x * dca[j][2 * e] + cv.y * dca[j][2 * e + 1];
          }
        }
        carried[e] = quad_sum(carried[e]);
      }
    }
    // the band, tiles s <= t: the scores at (t, s) for this thread's (t =
    // i0 + lane / 4 + 8 e, s = 16 js + 8 jn + 2 (lane % 4), + 1)
    float zt[2] = {0.f, 0.f};
    float2 snext[4];
    auto load_rows = [&](int js, float2* v) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = k & 1, jn = k >> 1;
        v[k] = *reinterpret_cast<const float2*>(
            sc + (long)(i0 + g8 + 8 * e) * Qp + 16 * js + 8 * jn + 2 * q);
      }
    };
    load_rows(0, snext);
    for (int js = 0; js <= warp; ++js) {
      float2 sv[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) sv[k] = snext[k];
      if (js < warp) load_rows(js + 1, snext);
      float dm[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int kk = 0; kk < PMAX / 16; ++kk)     // dM = dy_t x_s^T
        if (16 * kk < Pp) {
          uint32_t bb[4];
          ldmatrix_x4(bb, xs + (16 * js + (lane & 7) + (lane >> 4) * 8)
                                   * LDPB + 16 * kk + (lane & 8));
          mma_bf16_16816(dm[0], ya[kk], bb[0], bb[1]);
          mma_bf16_16816(dm[1], ya[kk], bb[2], bb[3]);
        }
      uint32_t dh[4], dl[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const int e = f & 1, jn = f >> 1;
        const int t = i0 + g8 + 8 * e;
        const float cs_t = cum[t];
        const float2 scv = sv[f];
        float dv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int s = 16 * js + 8 * jn + 2 * q + u;
          const bool on = s <= t;
          const float L = expf(fminf(cs_t - cum[s], 0.f));
          const float dmv = on ? dm[jn][2 * e + u] : 0.f;
          const float m = on ? (u ? scv.y : scv.x) * L * dts[s] : 0.f;
          dv[u] = dmv * L * dts[s];
          zt[e] += dmv * m;
        }
        split_bf16(dv[0], dv[1], dh[f], dl[f]);
      }
      const int kr = 16 * js + (lane & 7) + (lane & 8), kc = (lane >> 4) * 8;
#pragma unroll
      for (int jp = 0; jp < NMAX / 16; ++jp)     // dC_t += dS B_s
        if (16 * jp < Np) {
          uint32_t bb[4];
          ldmatrix_x4_trans(bb, bsm + kr * LDNB + 16 * jp + kc);
          mma_bf16_16816(dca[2 * jp], dh, bb[0], bb[1]);
          mma_bf16_16816(dca[2 * jp], dl, bb[0], bb[1]);
          mma_bf16_16816(dca[2 * jp + 1], dh, bb[2], bb[3]);
          mma_bf16_16816(dca[2 * jp + 1], dl, bb[2], bb[3]);
        }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int t = i0 + g8 + 8 * e;
      const float z = quad_sum(zt[e]);
      if (t >= rows) continue;
      if (q == 0) dct[t] = z + carried[e];
      store_row(dCp + ((r0 + t) * H + h) * (long)N, dca, e, q, N);
    }
  }
  __syncthreads();
  float dw_w = 0.f;                              // sum_s dw_s w_s
  for (int s = tid; s < rows; s += NTM) {
    dcs[s] += dct[s];
    dw_w += dww[s];
  }
  dw_w = block_sum<NTM>(dw_w, red);              // ends on a barrier
  if (tid == 0) dcs[rows - 1] += dw_w + expf(cs_last) * dec_dot;
  __syncthreads();
  if (tid < 32) {                                // da: reversed scan of d cs
    float v[4], run = 0.f;
#pragma unroll
    for (int k = 3; k >= 0; --k) {
      const int r = 4 * tid + k;
      run += r < rows ? dcs[r] : 0.f;
      v[k] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_down_sync(0xffffffffu, incl, o);
      if (tid + o < 32) incl += t;
    }
    const float excl = incl - run;
#pragma unroll
    for (int k = 0; k < 4; ++k) zc[4 * tid + k] = excl + v[k];
  }
  __syncthreads();
  float da_dt = 0.f;
  for (int r = tid; r < rows; r += NTM) {
    ddt[(r0 + r) * H + h] = ddd[r] + zc[r] * Ah;
    da_dt += zc[r] * dts[r];
  }
  da_dt = block_sum<NTM>(da_dt, red);
  if (tid == 0) {
    dAp[bhc] = da_dt;
    dDp[bhc] = dd;
  }
}

// dC (blockIdx.y 0) or dB (1) in x's dtype: per (batch, step, group) row
// and four state entries a thread, the heads' partials of the group
// summed in head order (bit for bit run to run)
__global__ void __launch_bounds__(256) ssd_bwd_bc_sum_kernel(
    const float* __restrict__ dCp, const float* __restrict__ dBp,
    bf16* __restrict__ dB, bf16* __restrict__ dC, long BS, int H, int G,
    int N) {
  const int N4 = (N + 3) / 4, rep = H / G;
  const long idx = (long)blockIdx.x * 256 + threadIdx.x;
  if (idx >= BS * G * N4) return;
  const long rg = idx / N4;                      // (batch, step) row, group
  const int n = 4 * (int)(idx - rg * N4);
  const long row = rg / G;
  const int grp = (int)(rg - row * G);
  const float* part = (blockIdx.y ? dBp : dCp)
                      + (row * H + (long)grp * rep) * N + n;
  bf16* out = (blockIdx.y ? dB : dC) + rg * N + n;
  if (N % 4 == 0) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int r = 0; r < rep; ++r) {
      const float4 w = *reinterpret_cast<const float4*>(part + (long)r * N);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v.x, v.y);
    *reinterpret_cast<__nv_bfloat162*>(out + 2) =
        __floats2bfloat162_rn(v.z, v.w);
    return;
  }
  for (int k = 0; k < 4 && n + k < N; ++k) {
    float v = 0.f;
    for (int r = 0; r < rep; ++r) v += part[(long)r * N + k];
    out[k] = __float2bfloat16(v);
  }
}

template <typename K>
cudaError_t allow_smem(K kern, long bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The workspace, in floats (ssd_scan.py's ssd_bwd_workspace computes the
// same), each piece a multiple of 4: the incoming states ((B H) x (nc + 1)
// x P x Np), the forward's decays, the state gradients ((B H) x nc x P x
// N), their decays, the scores ((B G) x nc x Q x Q; bf16: Qp x Qp, Qp = Q
// rounded up to 16, as ssd_scores_kernel writes them), fp32 only the
// heads' d scores ((B H) x nc x Q x Q), the dC and dB partials (B S H N
// each), the dA and dD partials ((B H) x nc each).
long ssd_bwd_workspace_floats(int B, int S, int H, int P, int G, int N,
                              int Q, int dtype) {
  const long nc = (S + Q - 1) / Q, bh = (long)B * H;
  const long Qs = dtype == 0 ? Q : round16(Q);
  return align4(bh * (nc + 1) * P * round16(N)) + align4(bh * nc)
         + align4(bh * nc * P * N) + align4(bh * nc)
         + align4((long)B * G * nc * Qs * Qs)
         + (dtype == 0 ? align4(bh * nc * Q * Q) : 0)
         + 2 * align4((long)B * S * H * N) + 2 * align4(bh * nc);
}

// fp32: the CUDA-core kernels above
template <typename T>
int launch_bwd(const T* x, const float* dt, const float* A, const T* Bm,
               const T* Cm, const float* D, const float* h0, const T* dy,
               const float* dhT, T* dx, float* ddt, float* dA, T* dB, T* dC,
               float* dD, float* dh0, float* ws, int B, int S, int H, int P,
               int G, int N, int Q, long x_rs, long b_rs, long c_rs,
               cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = allow_smem(ssd_bwd_scores_kernel<T>,
                               (16L + QMAX) * (NMAX + 4) * 4);
    if (e == cudaSuccess)
      e = allow_smem(ssd_bwd_dhin_kernel<T>,
                     (2L * QMAX + QMAX * PMAX + QMAX * (NMAX + 4)) * 4);
    if (e == cudaSuccess)
      e = allow_smem(ssd_bwd_chunk_kernel<T>,
                     chunk_smem_floats(QMAX, PMAX, NMAX) * 4);
    if (e == cudaSuccess)
      e = allow_smem(ssd_bwd_bc_kernel<T>,
                     ((long)TR * QMAX + (long)QMAX * (NMAX + 4)) * 4);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int nc = (S + Q - 1) / Q;
  const long bh = (long)B * H;
  float* slots = ws;
  float* fdec = slots + align4(bh * (nc + 1) * P * round16(N));
  float* g = fdec + align4(bh * nc);
  float* bdec = g + align4(bh * nc * P * N);
  float* sc = bdec + align4(bh * nc);
  float* dS = sc + align4((long)B * G * nc * Q * Q);
  float* dCp = dS + align4(bh * nc * Q * Q);
  float* dBp = dCp + align4((long)B * S * H * N);
  float* dAp = dBp + align4((long)B * S * H * N);
  float* dDp = dAp + align4(bh * nc);
  int err = ssd_incoming_states(x, dt, A, Bm, h0, slots, fdec, B, S, H, P, G,
                                N, Q, x_rs, b_rs, 0, st);
  if (err != 0) return err;
  ssd_bwd_scores_kernel<T><<<dim3(nc * (QMAX / 16), G, B), NT,
                             (16 + Q) * (((N + 3) & ~3) + 4) * 4, st>>>(
      Bm, Cm, sc, S, G, N, Q, b_rs, c_rs);
  ssd_bwd_dhin_kernel<T><<<dim3(nc, H, B), NT,
                           (2 * QMAX + Q * ((P + 7) & ~7)
                            + Q * (((N + 3) & ~3) + 4)) * 4, st>>>(
      dy, dt, A, Cm, g, bdec, S, H, P, G, N, Q, c_rs);
  ssd_bwd_pass_kernel<<<dim3((P * N + NT - 1) / NT, H, B), NT, 0, st>>>(
      g, bdec, dhT, dh0, H, P * N, nc);
  ssd_bwd_chunk_kernel<T><<<dim3(nc, H, B), NTC,
                            chunk_smem_floats(Q, P, N) * 4, st>>>(
      x, dt, A, Bm, Cm, D, dy, sc, slots, h0 == nullptr, g, dx, ddt, dS,
      dCp, dBp, dAp, dDp, S, H, P, G, N, Q, x_rs, b_rs, c_rs);
  ssd_bwd_bc_kernel<T><<<dim3(2 * ((Q + TR - 1) / TR), nc, B * G), NT,
                         (TR * Q + Q * (((N + 3) & ~3) + 4)) * 4, st>>>(
      Bm, Cm, dS, dCp, dBp, dB, dC, S, H, G, N, Q, b_rs, c_rs);
  ssd_bwd_reduce_kernel<<<(H + 127) / 128, 128, 0, st>>>(dAp, dDp, dA, dD, B,
                                                         H, nc);
  return (int)cudaGetLastError();
}

// bf16: the forward's incoming states and scores, then the tensor-core
// kernels
int launch_bwd_tc(const bf16* x, const float* dt, const float* A,
                  const bf16* Bm, const bf16* Cm, const float* D,
                  const float* h0, const bf16* dy, const float* dhT, bf16* dx,
                  float* ddt, float* dA, bf16* dB, bf16* dC, float* dD,
                  float* dh0, float* ws, int B, int S, int H, int P, int G,
                  int N, int Q, long x_rs, long b_rs, long c_rs,
                  cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t e = allow_smem(ssd_bwd_dhin_mma_kernel, DHIN_SMEM);
    if (e == cudaSuccess) e = allow_smem(ssd_bwd_chunk_mma_kernel, CHUNK_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int nc = (S + Q - 1) / Q, Qp = round16(Q);
  const long bh = (long)B * H;
  float* slots = ws;
  float* fdec = slots + align4(bh * (nc + 1) * P * round16(N));
  float* g = fdec + align4(bh * nc);
  float* bdec = g + align4(bh * nc * P * N);
  float* sc = bdec + align4(bh * nc);
  float* dCp = sc + align4((long)B * G * nc * Qp * Qp);
  float* dBp = dCp + align4((long)B * S * H * N);
  float* dAp = dBp + align4((long)B * S * H * N);
  float* dDp = dAp + align4(bh * nc);
  int err = ssd_incoming_states(x, dt, A, Bm, h0, slots, fdec, B, S, H, P, G,
                                N, Q, x_rs, b_rs, 1, st);
  if (err == 0)
    err = ssd_chunk_scores(Bm, Cm, sc, B, S, G, N, Q, b_rs, c_rs, st);
  if (err != 0) return err;
  ssd_bwd_dhin_mma_kernel<<<dim3(nc, H, B), 128, DHIN_SMEM, st>>>(
      dy, dt, A, Cm, g, bdec, S, H, P, G, N, Q, c_rs);
  ssd_bwd_pass_kernel<<<dim3((P * N + NT - 1) / NT, H, B), NT, 0, st>>>(
      g, bdec, dhT, dh0, H, P * N, nc);
  ssd_bwd_chunk_mma_kernel<<<dim3(nc, H, B), NTM, CHUNK_SMEM, st>>>(
      x, dt, A, Bm, Cm, D, dy, sc, slots, h0 == nullptr, g, dx, ddt, dCp,
      dBp, dAp, dDp, S, H, P, G, N, Q, x_rs, b_rs, c_rs);
  const long BS = (long)B * S;
  ssd_bwd_bc_sum_kernel<<<dim3((unsigned)((BS * G * ((N + 3) / 4) + 255)
                                          / 256), 2), 256, 0, st>>>(
      dCp, dBp, dB, dC, BS, H, G, N);
  ssd_bwd_reduce_kernel<<<(H + 127) / 128, 128, 0, st>>>(dAp, dDp, dA, dD, B,
                                                         H, nc);
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C, dy, dx, dB and dC).  D, h0,
// dhT, dD and dh0 may be null (dD is written when D is given, dh0 when
// it is not null).  1 <= chunk <= 128, 1 <= N <= 128, 1 <= P <= 64, H a
// multiple of G, S >= 1; x_rs, b_rs and c_rs are the element strides
// between consecutive (batch, step) rows of x, B and C, whose last two axes
// are contiguous; dy, dx, ddt, dB and dC are contiguous.  ws holds
// ws_floats fp32 values (16-byte aligned), at least
// ssd_bwd_workspace_floats.
extern "C" int ssd_scan_bwd(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, const void* D,
                            const void* h0, const void* dy, const void* dhT,
                            void* dx, void* ddt, void* dA, void* dB,
                            void* dC, void* dD, void* dh0, void* ws, int B,
                            int S, int H, int P, int G, int N, int chunk,
                            long x_rs, long b_rs, long c_rs, long ws_floats,
                            int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || H < 1 || P < 1 || P > PMAX || G < 1 || H % G
      || N < 1 || N > NMAX || chunk < 1 || chunk > QMAX || B > 65535
      || H > 65535 || (long)B * G > 65535 || ws == nullptr
      || reinterpret_cast<uintptr_t>(ws) % 16
      || (dtype != 0 && dtype != 1)
      || ws_floats < ssd_bwd_workspace_floats(B, S, H, P, G, N, chunk, dtype)
      || (D == nullptr) != (dD == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  const float* h0f = static_cast<const float*>(h0);
  const float* dhTf = static_cast<const float*>(dhT);
  float* wsf = static_cast<float*>(ws);
  if (dtype == 0)
    return launch_bwd<float>(
        static_cast<const float*>(x), dtf, Af, static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), Df, h0f,
        static_cast<const float*>(dy), dhTf, static_cast<float*>(dx),
        static_cast<float*>(ddt), static_cast<float*>(dA),
        static_cast<float*>(dB), static_cast<float*>(dC),
        static_cast<float*>(dD), static_cast<float*>(dh0), wsf, B, S, H, P,
        G, N, chunk, x_rs, b_rs, c_rs, st);
  return launch_bwd_tc(
      static_cast<const bf16*>(x), dtf, Af, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), Df, h0f, static_cast<const bf16*>(dy),
      dhTf, static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dA), static_cast<bf16*>(dB),
      static_cast<bf16*>(dC), static_cast<float*>(dD),
      static_cast<float*>(dh0), wsf, B, S, H, P, G, N, chunk, x_rs, b_rs,
      c_rs, st);
}

// The bf16 kernel `part` (0 d h_in, 1 the chunk kernel, 2 the group sum)
// as the card runs it: info[0] blocks an SM, info[1] dynamic shared memory
// bytes, info[2] registers a thread.
extern "C" int ssd_bwd_occupancy(int part, int* info) {
  cudaFuncAttributes at;
  cudaError_t e = cudaErrorInvalidValue;
  int threads = 0, smem = 0;
  if (part == 0) {
    threads = 128;
    smem = DHIN_SMEM;
    e = allow_smem(ssd_bwd_dhin_mma_kernel, smem);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&at, ssd_bwd_dhin_mma_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &info[0], ssd_bwd_dhin_mma_kernel, threads, smem);
  } else if (part == 1) {
    threads = NTM;
    smem = CHUNK_SMEM;
    e = allow_smem(ssd_bwd_chunk_mma_kernel, smem);
    if (e == cudaSuccess)
      e = cudaFuncGetAttributes(&at, ssd_bwd_chunk_mma_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &info[0], ssd_bwd_chunk_mma_kernel, threads, smem);
  } else if (part == 2) {
    threads = 256;
    e = cudaFuncGetAttributes(&at, ssd_bwd_bc_sum_kernel);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &info[0], ssd_bwd_bc_sum_kernel, threads, 0);
  }
  info[1] = smem;
  info[2] = e == cudaSuccess ? at.numRegs : 0;
  return (int)e;
}
