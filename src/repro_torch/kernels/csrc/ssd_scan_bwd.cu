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
//   ssd_bwd_scores_kernel  per (batch, group, chunk): C B^T on the band;
//   ssd_bwd_dhin_kernel    per (batch, head, chunk): the chunk's own d h_in
//                          = sum_t exp(cs_t) dy_t^T C_t, and its decay;
//   ssd_bwd_pass_kernel    per (batch, head, state entry), in reverse over
//                          the chunks: g = d h_in + decay g from dh_T, each
//                          chunk's outgoing-state gradient g_out, and dh0;
//   ssd_bwd_chunk_kernel   per (batch, head, chunk): (4') dx = M^T dy + D dy,
//                          the band's d scores (into the workspace), the
//                          direct ddt and the d cs of Z = (dy x^T) o M; the
//                          carried-in term's dC (a per-head partial) and d
//                          cs; (2') dx += w B g_out^T, the per-head dB
//                          partial w x g_out, dw; d decay = <g_out, h_in>;
//                          then da by the reversed scan of d cs, ddt and the
//                          dA and dD partials;
//   ssd_bwd_bc_kernel      per (batch, group, chunk, 16-row tile): (1') dC =
//                          sum over the group's heads of the partials + (sum
//                          of d scores) B, dB likewise with C;
//   ssd_bwd_reduce_kernel  per head: dA and dD, the partials summed in a
//                          fixed order.
//
// Deterministic: no atomics; every sum runs in a fixed order, so two runs
// agree bit for bit.  fp32 accumulators and fp32 products on the CUDA cores
// (x, B, C and dy are read in their dtype and widened), scalar shared-memory
// loads; a ragged last chunk is its live rows only (the forward's padded
// steps, dt = 0 and x = B = C = 0, add nothing to any gradient), and no
// gradient of a padded step is written.  What bounds it on the card is the
// chunk kernel's shared-memory traffic (each FMA of its products reads a
// shared operand): a simple design, not yet a fast one.  It allocates
// nothing: the workspace is the caller's (ssd_scan.py's ssd_bwd_workspace).
#include <math.h>
#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// ssd_scan.cu: every chunk's incoming state by the forward's stage kernels
int ssd_incoming_states(const void* x, const float* dt, const float* A,
                        const void* Bm, const float* h0, float* slots,
                        float* decay, int B, int S, int H, int P, int G,
                        int N, int Q, long x_rs, long b_rs, int dtype,
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
__device__ __forceinline__ float ld(const bf16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(bf16* p, float v) {
  *p = __float2bfloat16(v);
}

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

// Four consecutive values from p (16-byte aligned fp32, 8-byte aligned
// bf16), widened to fp32
__device__ __forceinline__ float4 ld4v(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 ld4v(const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

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

template <typename K>
cudaError_t allow_smem(K kern, long bytes) {
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// The workspace, in floats (ssd_scan.py's ssd_bwd_workspace computes the
// same), each piece a multiple of 4: the incoming states ((B H) x (nc + 1)
// x P x Np), the forward's decays, the state gradients ((B H) x nc x P x
// N), their decays, the scores ((B G) x nc x Q x Q), the heads' d scores
// ((B H) x nc x Q x Q), the dC and dB partials (B S H N each), the dA and
// dD partials ((B H) x nc each).
long ssd_bwd_workspace_floats(int B, int S, int H, int P, int G, int N,
                              int Q) {
  const long nc = (S + Q - 1) / Q, bh = (long)B * H;
  return align4(bh * (nc + 1) * P * round16(N)) + align4(bh * nc)
         + align4(bh * nc * P * N) + align4(bh * nc)
         + align4((long)B * G * nc * Q * Q) + align4(bh * nc * Q * Q)
         + 2 * align4((long)B * S * H * N) + 2 * align4(bh * nc);
}

template <typename T>
int launch_bwd(const T* x, const float* dt, const float* A, const T* Bm,
               const T* Cm, const float* D, const float* h0, const T* dy,
               const float* dhT, T* dx, float* ddt, float* dA, T* dB, T* dC,
               float* dD, float* dh0, float* ws, int B, int S, int H, int P,
               int G, int N, int Q, long x_rs, long b_rs, long c_rs,
               int dtype, cudaStream_t st) {
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
                                N, Q, x_rs, b_rs, dtype, st);
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
      || ws_floats < ssd_bwd_workspace_floats(B, S, H, P, G, N, chunk)
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
        G, N, chunk, x_rs, b_rs, c_rs, 0, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  return launch_bwd<bf16>(
      static_cast<const bf16*>(x), dtf, Af, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), Df, h0f, static_cast<const bf16*>(dy),
      dhTf, static_cast<bf16*>(dx), static_cast<float*>(ddt),
      static_cast<float*>(dA), static_cast<bf16*>(dB),
      static_cast<bf16*>(dC), static_cast<float*>(dD),
      static_cast<float*>(dh0), wsf, B, S, H, P, G, N, chunk, x_rs, b_rs,
      c_rs, 1, st);
}
