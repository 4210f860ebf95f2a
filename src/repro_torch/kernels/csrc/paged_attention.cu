// Paged GQA attention for Hopper (sm_90a): the two kernels of the serving
// hot path, with a plain C interface loaded through ctypes
// (src/repro_torch/kernels/build.py builds this file, and
// src/repro_torch/kernels/decode_attention.py wraps it).
//
//   paged_attention_sweep  stage 1 of paged GQA attention: Q query rows per
//                          (batch, q head) over the pages of one split, online
//                          softmax in fp32, optional in-flight candidate fold.
//   lse_merge              stage 2: exact log-sum-exp merge of the splits.
//
// Both launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so that a refused launch is reported.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// the JAX reference's masked-score constant, -0.7 * finfo(float32).max
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int NT = 128;              // threads per sweep block
constexpr int NWARP = NT / 32;

__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 v = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// n_rows rows of HD elements, row r at base + r * row_stride, into a dense
// fp32 tile in shared memory; 16-byte loads, neighbouring threads on
// neighbouring addresses.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(const T* base, long row_stride,
                                          int n_rows, float* dst) {
  constexpr int VN = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VN;
  for (int c = threadIdx.x; c < n_rows * PER_ROW; c += NT) {
    const int r = c / PER_ROW;
    const int col = (c - r * PER_ROW) * VN;
    load16(base + r * row_stride + col, dst + r * HD + col);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

enum Mode { DECODE = 0, VERIFY = 1, CANDIDATES = 2 };

// One key tile's online-softmax update of the Q rows, the body of the JAX
// reference's _online_softmax_update: s = q.k * scale, optional tanh cap,
// masked to NEG_INF; m' = max(m, max s); p = exp(s - m'); l' = l e^(m-m')
// + sum p; acc' = acc e^(m-m') + p.v.  Masks: DECODE k_pos <= pos (and
// k_pos > pos - window), VERIFY k_pos < pos (and k_pos > pos + i - window),
// CANDIDATES j <= i (and j > i - window).  Ends with a barrier.
template <int HD>
__device__ void tile_update(const float* qs, const float* ks, const float* vs,
                            float* ss, float* ms, float* ls, float* cs,
                            float* accs, int Q, int nk, int mode, int k_pos0,
                            int pos, int window, float logit_cap,
                            float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pidx = warp; pidx < Q * nk; pidx += NWARP) {
    const int i = pidx / nk, k = pidx - i * nk;
    const float* qr = qs + i * HD;
    const float* kr = ks + k * HD;
    float d = 0.f;
#pragma unroll
    for (int c = lane; c < HD; c += 32) d += qr[c] * kr[c];
    d = warp_sum(d);
    if (lane == 0) {
      float s = d * scale;
      if (logit_cap > 0.f) s = logit_cap * tanhf(s / logit_cap);
      bool valid;
      if (mode == DECODE) {
        const int kp = k_pos0 + k;
        valid = kp <= pos && (window <= 0 || kp > pos - window);
      } else if (mode == VERIFY) {
        const int kp = k_pos0 + k;
        valid = kp < pos && (window <= 0 || kp > pos + i - window);
      } else {
        valid = k <= i && (window <= 0 || k > i - window);
      }
      ss[i * nk + k] = valid ? s : NEG_INF;
    }
  }
  __syncthreads();
  if (threadIdx.x < Q) {
    const int i = threadIdx.x;
    float* sr = ss + i * nk;
    float mx = sr[0];
    for (int k = 1; k < nk; ++k) mx = fmaxf(mx, sr[k]);
    const float m_prev = ms[i];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int k = 0; k < nk; ++k) {
      const float p = expf(sr[k] - m_new);
      sr[k] = p;
      sum += p;
    }
    const float corr = expf(m_prev - m_new);
    ls[i] = ls[i] * corr + sum;
    ms[i] = m_new;
    cs[i] = corr;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Q * HD; idx += NT) {
    const int i = idx / HD, c = idx - i * HD;
    const float* pr = ss + i * nk;
    float a = 0.f;
    for (int k = 0; k < nk; ++k) a += pr[k] * vs[k * HD + c];
    accs[idx] = accs[idx] * cs[i] + a;
  }
  __syncthreads();
}

// Replaces, from src/repro/kernels/decode_attention.py:
//   paged_decode_attention_pallas           (:1232, kernel :1067)
//   paged_decode_attention_pallas_partials  (:1154, kernel :1110)
//   paged_verify_attention_pallas           (:970,  kernel :781)
//   paged_verify_attention_pallas_partials  (:877,  kernel :825)
// Bound on the card: bytes.  A decode step reads every live pool byte once
// against one query row (about 2 FLOP per byte of bf16 k/v, far under the
// ~295 FLOP/byte where H100's tensor cores would bind), and the suffix
// prefill's Q = 16 rows stay under it too.  Design: one block per
// (batch * q head, split) walks its split's contiguous page slice in a loop
// inside the block (the TPU's sequential grid axis becomes that loop),
// reading each page with 16-byte loads into shared memory and keeping the
// (m, l, acc) state of all Q rows in shared memory in fp32.  A page wholly
// outside the request's valid range is skipped by position before its
// table entry is read (columns past a request's length hold arbitrary
// ids), so the bytes moved follow the requests' lengths, not the table
// width.  Still simple: no wgmma, no TMA, no overlap of the next page's
// load with this page's math, and the G q heads of one kv head read the
// same page separately (L2 keeps the repeats off HBM).
template <typename T, int HD>
__global__ void __launch_bounds__(NT) paged_attention_sweep_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const int* __restrict__ block_tables,
    const int* __restrict__ pos_arr, T* __restrict__ out,
    float* __restrict__ partial, float* __restrict__ lse, int Q, int Hq,
    int Hkv, int P, int ps, int nb, int n_splits, int ppb, int verify,
    int window, float logit_cap, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int s = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int R = (verify && Q > ps) ? Q : ps;   // key-tile rows
  float* qs = smem;
  float* accs = qs + Q * HD;
  float* ks = accs + Q * HD;
  float* vs = ks + R * HD;
  float* ss = vs + R * HD;
  float* ms = ss + Q * R;
  float* ls = ms + Q;
  float* cs = ls + Q;

  load_rows<T, HD>(q + ((long)b * Q * Hq + h) * HD, (long)Hq * HD, Q, qs);
  for (int idx = threadIdx.x; idx < Q * HD; idx += NT) accs[idx] = 0.f;
  if (threadIdx.x < Q) {
    ms[threadIdx.x] = NEG_INF;
    ls[threadIdx.x] = 0.f;
  }
  __syncthreads();

  // union over the Q rows of the valid key range: a page outside it has no
  // valid score for any row, so it is skipped (the reference's any(valid))
  const int pos = pos_arr[b];
  const int hi_valid = verify ? pos - 1 : pos;
  const int lo_valid = window > 0 ? pos - window + 1 : INT_MIN;
  const long kv_row = (long)Hkv * HD;
  const int j0 = s * ppb;
  const int j1 = min(j0 + ppb, nb);
  for (int j = j0; j < j1; ++j) {
    const int k0 = j * ps;
    if (k0 > hi_valid || k0 + ps - 1 < lo_valid) continue;   // block-uniform
    // a column inside the request's length must name a page of the pool:
    // skipping a bad id would drop its keys without a word, so the kernel
    // stops instead, and the launch fails at the next synchronisation
    const int page = block_tables[(long)b * nb + j];
    if (page < 0 || page >= P) __trap();
    const long base = ((long)page * ps * Hkv + hk) * HD;
    load_rows<T, HD>(k_pages + base, kv_row, ps, ks);
    load_rows<T, HD>(v_pages + base, kv_row, ps, vs);
    __syncthreads();
    tile_update<HD>(qs, ks, vs, ss, ms, ls, cs, accs, Q, ps,
                    verify ? VERIFY : DECODE, k0, pos, window, logit_cap,
                    scale);
  }
  if (verify && s == n_splits - 1) {
    // in-flight candidates fold into the last split only
    const long base = ((long)b * Q * Hkv + hk) * HD;
    load_rows<T, HD>(k_new + base, kv_row, Q, ks);
    load_rows<T, HD>(v_new + base, kv_row, Q, vs);
    __syncthreads();
    tile_update<HD>(qs, ks, vs, ss, ms, ls, cs, accs, Q, Q, CANDIDATES, 0,
                    pos, window, logit_cap, scale);
  }

  if (n_splits == 1) {
    // single split: the normalised output, straight in the query dtype
    for (int idx = threadIdx.x; idx < Q * HD; idx += NT) {
      const int i = idx / HD, c = idx - i * HD;
      store(out + (((long)b * Q + i) * Hq + h) * HD + c,
            accs[idx] / fmaxf(ls[i], 1e-30f));
    }
  } else {
    const long cell = ((long)b * Hq + h) * n_splits + s;
    for (int idx = threadIdx.x; idx < Q * HD; idx += NT) {
      const int i = idx / HD;
      partial[cell * Q * HD + idx] = accs[idx] / fmaxf(ls[i], 1e-30f);
    }
    if (threadIdx.x < Q) {
      const float l = ls[threadIdx.x];
      lse[cell * Q + threadIdx.x] =
          l > 0.f ? ms[threadIdx.x] + logf(fmaxf(l, 1e-30f)) : NEG_INF;
    }
  }
}

// Replaces merge_kv_splits_pallas, src/repro/kernels/decode_attention.py:172
// (kernel _lse_merge_kernel :156).  Bound on the card: bytes (S fp32
// partial rows in, one row out, ~3 FLOP per byte).  Design: one block per
// output row, one thread per output element; each thread re-derives the
// row's max and denominator from the S log-sum-exps (S <= 16, all in L1),
// so no shared memory or barrier is needed.
template <typename TO>
__global__ void lse_merge_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ lse,
                                 TO* __restrict__ out, int S, int R, int Dv) {
  const long row = blockIdx.x;              // n * R + r
  const long n = row / R;
  const int r = (int)(row - n * R);
  const float* lp = lse + n * S * R + r;
  float m = lp[0];
  for (int s = 1; s < S; ++s) m = fmaxf(m, lp[(long)s * R]);
  float den = 0.f;
  for (int s = 0; s < S; ++s) den += expf(lp[(long)s * R] - m);
  den = fmaxf(den, 1e-30f);
  for (int d = threadIdx.x; d < Dv; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s)
      acc += partial[((n * S + s) * R + r) * Dv + d] *
             expf(lp[(long)s * R] - m);
    store(out + row * Dv + d, acc / den);
  }
}

template <typename T, int HD>
int launch_sweep(const void* q, const void* kp, const void* vp,
                 const void* kn, const void* vn, const int* bt,
                 const int* pos, void* out, float* partial, float* lse, int B,
                 int Q, int Hq, int Hkv, int P, int ps, int nb, int n_splits,
                 int ppb, int verify, int window, float logit_cap,
                 float scale, cudaStream_t stream) {
  const int R = (verify && Q > ps) ? Q : ps;
  const size_t smem =
      sizeof(float) * (2 * (size_t)Q * HD + 2 * (size_t)R * HD +
                       (size_t)Q * R + 3 * (size_t)Q);
  auto kern = paged_attention_sweep_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * Hq, n_splits);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const T*>(kn),
      static_cast<const T*>(vn), bt, pos, static_cast<T*>(out), partial, lse,
      Q, Hq, Hkv, P, ps, nb, n_splits, ppb, verify, window, logit_cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, pools, candidates and out share it).
// verify = 0: decode (k_new / v_new unused).  n_splits == 1 writes out
// (B, Q, Hq, HD); otherwise partial (B, Hq, S, Q, HD) and lse (B, Hq, S, Q).
extern "C" int paged_attention_sweep(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_new, const void* v_new, const void* block_tables,
    const void* pos, void* out, void* partial, void* lse, int B, int Q,
    int Hq, int Hkv, int P, int ps, int nb, int head_dim, int n_splits,
    int ppb, int verify, int window, float logit_cap, float scale, int dtype,
    void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* ps_arr = static_cast<const int*>(pos);
  float* pp = static_cast<float*>(partial);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > NT) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 64)
    return launch_sweep<__nv_bfloat16, 64>(q, k_pages, v_pages, k_new, v_new,
        bt, ps_arr, out, pp, lp, B, Q, Hq, Hkv, P, ps, nb, n_splits, ppb,
        verify, window, logit_cap, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch_sweep<__nv_bfloat16, 128>(q, k_pages, v_pages, k_new,
        v_new, bt, ps_arr, out, pp, lp, B, Q, Hq, Hkv, P, ps, nb, n_splits,
        ppb, verify, window, logit_cap, scale, st);
  if (dtype == 0 && head_dim == 64)
    return launch_sweep<float, 64>(q, k_pages, v_pages, k_new, v_new, bt,
        ps_arr, out, pp, lp, B, Q, Hq, Hkv, P, ps, nb, n_splits, ppb, verify,
        window, logit_cap, scale, st);
  if (dtype == 0 && head_dim == 128)
    return launch_sweep<float, 128>(q, k_pages, v_pages, k_new, v_new, bt,
        ps_arr, out, pp, lp, B, Q, Hq, Hkv, P, ps, nb, n_splits, ppb, verify,
        window, logit_cap, scale, st);
  return (int)cudaErrorInvalidValue;
}

// partial (N, S, R, Dv) fp32 + lse (N, S, R) fp32 -> out (N, R, Dv) in
// out_dtype (0 = float32, 1 = bfloat16).
extern "C" int lse_merge(const void* partial, const void* lse, void* out,
                         int N, int S, int R, int Dv, int out_dtype,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = Dv < 256 ? ((Dv + 31) / 32) * 32 : 256;
  const float* pp = static_cast<const float*>(partial);
  const float* lp = static_cast<const float*>(lse);
  if (out_dtype == 1)
    lse_merge_kernel<__nv_bfloat16><<<N * R, threads, 0, st>>>(
        pp, lp, static_cast<__nv_bfloat16*>(out), S, R, Dv);
  else if (out_dtype == 0)
    lse_merge_kernel<float><<<N * R, threads, 0, st>>>(
        pp, lp, static_cast<float*>(out), S, R, Dv);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
