// Ring-cache GQA attention for Hopper (sm_90a): the sweep of the static
// batch path, with a plain C interface loaded through ctypes
// (src/repro_torch/kernels/build.py builds it into the same library as
// paged_attention.cu, and src/repro_torch/kernels/decode_attention.py
// wraps it).
//
//   ring_attention_sweep  stage 1 of GQA attention over a ring-buffer cache
//                         (B, C, Hkv, D): Q query rows per (batch, q head)
//                         over the blocks of one split, online softmax in
//                         fp32, optional in-flight candidate fold; caches in
//                         the query dtype, or int8 with per-row fp32 scales
//                         dequantized as each tile lands.  Stage 2 is
//                         paged_attention.cu's lse_merge.
//
// It launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() so that a refused launch is reported.
#include "attention_common.cuh"

namespace {

constexpr int TILE = 64;             // key rows staged in shared memory

// Absolute position held by ring slot ``slot`` when the last position
// written is ``ref``: ref - ((ref - slot) mod C), with a modulo that stays
// in [0, C) for negative operands as jnp.remainder does.  Slots not yet
// written come out negative.
__device__ __forceinline__ int ring_pos(int ref, int slot, int C) {
  int m = (ref - slot) % C;
  if (m < 0) m += C;
  return ref - m;
}

// Validity of key k of the block starting at slot k0 for query row i.
// Decode (ref = pos): k_pos >= 0, and k_pos > pos - window.  Verify (ref =
// pos - 1, row i at pos + i): also k_pos > pos + i - C, the slots the
// sequential loop would already have overwritten by row i, and the window
// against pos + i.
struct RingMask {
  int ref, pos, C, window, verify, k0;
  __device__ __forceinline__ bool operator()(int i, int k) const {
    const int kp = ring_pos(ref, k0 + k, C);
    if (kp < 0) return false;
    const int qp = verify ? pos + i : pos;
    if (verify && kp <= qp - C) return false;
    return window <= 0 || kp > qp - window;
  }
};

// The in-flight candidates of a verify block: row i sees j <= i (and
// j > i - window).
struct CandidateMask {
  int window;
  __device__ __forceinline__ bool operator()(int i, int j) const {
    return j <= i && (window <= 0 || j > i - window);
  }
};

// One key block's online-softmax update of the Q rows, the body of the JAX
// reference's _online_softmax_update over the whole block: s = q.k * scale,
// optional tanh cap, masked to NEG_INF; m' = max(m, max s); p = exp(s - m');
// l' = l e^(m-m') + sum p; acc' = acc e^(m-m') + p.v.  The block's nk keys
// (row r at kbase / vbase + r * row_stride) pass through shared memory in
// tiles of TILE rows, padded to HD + 1 floats so that one thread per
// (row, key) reads conflict-free; the scores of the whole block sit in ss
// (row stride sw) so that the softmax update is one per block, as in the
// reference.  E is the rows' storage: the query dtype (the candidates, an
// unquantized ring) or int8, whose row r's fp32 scale sits at ksbase /
// vsbase + r * scale_stride (null otherwise) and multiplies in as the row
// lands in the tile.  Ends with a barrier.
template <typename E, int HD, typename Mask>
__device__ void block_update(const E* kbase, const E* vbase, long row_stride,
                             const float* ksbase, const float* vsbase,
                             long scale_stride, int nk, const float* qs,
                             float* accs, float* tile, float* ss, int sw,
                             float* ms, float* ls, float* cs, int Q,
                             const Mask& valid, float logit_cap,
                             float scale) {
  constexpr int LD = HD + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int t0 = 0; t0 < nk; t0 += TILE) {
    const int nr = min(TILE, nk - t0);
    load_kv_rows<E, HD, LD>(kbase + t0 * row_stride, row_stride,
                            ksbase ? ksbase + t0 * scale_stride : nullptr,
                            scale_stride, nr, tile);
    __syncthreads();
    for (int idx = threadIdx.x; idx < Q * nr; idx += NT) {
      const int i = idx / nr, r = idx - i * nr;
      const float* qr = qs + i * HD;
      const float* kr = tile + r * LD;
      float d = 0.f;
#pragma unroll 16
      for (int c = 0; c < HD; ++c) d += qr[c] * kr[c];
      float s = d * scale;
      if (logit_cap > 0.f) s = logit_cap * tanhf(s / logit_cap);
      ss[i * sw + t0 + r] = valid(i, t0 + r) ? s : NEG_INF;
    }
    __syncthreads();
  }
  for (int i = warp; i < Q; i += NWARP) {
    float* sr = ss + i * sw;
    float mx = NEG_INF;
    for (int k = lane; k < nk; k += 32) mx = fmaxf(mx, sr[k]);
    mx = warp_max(mx);
    const float m_prev = ms[i];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int k = lane; k < nk; k += 32) {
      const float p = expf(sr[k] - m_new);
      sr[k] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float corr = expf(m_prev - m_new);
      ls[i] = ls[i] * corr + sum;
      ms[i] = m_new;
      cs[i] = corr;
    }
  }
  __syncthreads();
  // each thread owns the same accumulator entries in both loops below
  for (int idx = threadIdx.x; idx < Q * HD; idx += NT)
    accs[idx] *= cs[idx / HD];
  for (int t0 = 0; t0 < nk; t0 += TILE) {
    const int nr = min(TILE, nk - t0);
    __syncthreads();                 // the tile's last readers are done
    load_kv_rows<E, HD, LD>(vbase + t0 * row_stride, row_stride,
                            vsbase ? vsbase + t0 * scale_stride : nullptr,
                            scale_stride, nr, tile);
    __syncthreads();
    for (int idx = threadIdx.x; idx < Q * HD; idx += NT) {
      const int i = idx / HD, c = idx - i * HD;
      const float* pr = ss + i * sw + t0;
      float a = 0.f;
      for (int r = 0; r < nr; ++r) a += pr[r] * tile[r * LD + c];
      accs[idx] += a;
    }
  }
  __syncthreads();
}

// Replaces, from src/repro/kernels/decode_attention.py, in their bf16/fp32
// and their int8 forms (scales (B, C, Hkv, 1), dequantized in the block
// load, _load_kv :94):
//   decode_attention_pallas           (:384, kernel _decode_kernel :207)
//   decode_attention_pallas_partials  (:298, kernel :251)
//   verify_attention_pallas           (:682, kernel _verify_kernel :479)
//   verify_attention_pallas_partials  (:589, kernel :534)
// Bound on the card: bytes.  A decode step reads every live cache byte once
// against one query row (about 2 FLOP per byte of bf16 k/v), and verify's
// Q = K + 1 rows stay far under the ~295 FLOP/byte where the tensor cores
// would bind.  Design: one block per (batch * q head, split) walks its
// split's contiguous run of block_k-slot blocks in a loop inside the block
// (the TPU's sequential grid axis), reading the cache in place in its
// (B, C, Hkv, D) layout -- the JAX wrapper's transpose to (B, Hkv, C, D)
// was for the TPU's BlockSpecs and would copy the cache once per layer and
// step.  Slot positions come from pos (a device tensor) and the ring
// arithmetic; a block in which no row has a valid slot is skipped before
// any of its bytes is read (the reference's any(valid)).  The verify
// candidates fold into the last split only.  Still simple: no wgmma, no TMA,
// no overlap of the next tile's load with this tile's math, and the G q
// heads of one kv head read the same rows separately (L2 keeps the repeats
// off HBM).  TKV is T, or int8_t for an int8 ring: a row then costs HD + 4
// bytes, its scale read in place at the ring's (B, C, Hkv, 1) strides (the
// JAX wrapper's transpose of the scales is not needed either).
template <typename T, typename TKV, int HD>
__global__ void __launch_bounds__(NT) ring_attention_sweep_kernel(
    const T* __restrict__ q, const TKV* __restrict__ k_cache,
    const TKV* __restrict__ v_cache, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const T* __restrict__ k_new,
    const T* __restrict__ v_new, const int* __restrict__ pos_arr,
    int batch_pos, T* __restrict__ out, float* __restrict__ partial,
    float* __restrict__ lse, int Q, int Hq, int Hkv, int C, int block_k,
    int n_k, int n_splits, int kpb, int verify, int window, float logit_cap,
    float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh - b * Hq;
  const int s = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int sw = (verify && Q > block_k) ? Q : block_k;   // score row stride
  float* qs = smem;
  float* accs = qs + Q * HD;
  float* tile = accs + Q * HD;
  float* ss = tile + TILE * (HD + 1);
  float* ms = ss + Q * sw;
  float* ls = ms + Q;
  float* cs = ls + Q;

  load_rows<T, HD>(q + ((long)b * Q * Hq + h) * HD, (long)Hq * HD, Q, qs);
  for (int idx = threadIdx.x; idx < Q * HD; idx += NT) accs[idx] = 0.f;
  if (threadIdx.x < Q) {
    ms[threadIdx.x] = NEG_INF;
    ls[threadIdx.x] = 0.f;
  }
  __syncthreads();

  const int pos = pos_arr[batch_pos ? b : 0];
  const int ref = verify ? pos - 1 : pos;       // last committed position
  const long kv_row = (long)Hkv * HD;
  const int g1 = min((s + 1) * kpb, n_k);
  for (int g = s * kpb; g < g1; ++g) {
    const RingMask mask{ref, pos, C, window, verify, g * block_k};
    bool any = false;
    for (int idx = threadIdx.x; idx < Q * block_k && !any; idx += NT)
      any = mask(idx / block_k, idx % block_k);
    if (!__syncthreads_or(any)) continue;        // block-uniform
    const long srow = ((long)b * C + (long)g * block_k) * Hkv + hk;
    const long base = srow * HD;
    block_update<TKV, HD>(k_cache + base, v_cache + base, kv_row,
                          k_scale ? k_scale + srow : nullptr,
                          v_scale ? v_scale + srow : nullptr, Hkv, block_k,
                          qs, accs, tile, ss, sw, ms, ls, cs, Q, mask,
                          logit_cap, scale);
  }
  if (verify && s == n_splits - 1) {
    const long base = (long)b * Q * kv_row + hk * HD;
    block_update<T, HD>(k_new + base, v_new + base, kv_row, nullptr, nullptr,
                        0, Q, qs, accs, tile, ss, sw, ms, ls, cs, Q,
                        CandidateMask{window}, logit_cap, scale);
  }
  write_result<T, HD>(accs, ms, ls, Q, b, h, s, Hq, n_splits, out, partial,
                      lse);
}

template <typename T, typename TKV, int HD>
int launch_ring(const void* q, const void* kc, const void* vc,
                const float* ksc, const float* vsc, const void* kn,
                const void* vn, const int* pos, int batch_pos, void* out,
                float* partial, float* lse, int B, int Q, int Hq, int Hkv,
                int C, int block_k, int n_k, int n_splits, int kpb,
                int verify, int window, float logit_cap, float scale,
                cudaStream_t stream) {
  const int sw = (verify && Q > block_k) ? Q : block_k;
  const size_t smem =
      sizeof(float) * (2 * (size_t)Q * HD + (size_t)TILE * (HD + 1) +
                       (size_t)Q * sw + 3 * (size_t)Q);
  auto kern = ring_attention_sweep_kernel<T, TKV, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B * Hq, n_splits);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const TKV*>(kc),
      static_cast<const TKV*>(vc), ksc, vsc, static_cast<const T*>(kn),
      static_cast<const T*>(vn), pos, batch_pos, static_cast<T*>(out),
      partial, lse, Q, Hq, Hkv, C, block_k, n_k, n_splits, kpb, verify,
      window, logit_cap, scale);
  return (int)cudaGetLastError();
}

// The caches' storage: the query dtype T (no scales) or int8 (both given).
template <typename T, int HD>
int launch_ring_kv(const void* q, const void* kc, const void* vc,
                   const float* ksc, const float* vsc, const void* kn,
                   const void* vn, const int* pos, int batch_pos, void* out,
                   float* partial, float* lse, int B, int Q, int Hq, int Hkv,
                   int C, int block_k, int n_k, int n_splits, int kpb,
                   int verify, int window, float logit_cap, float scale,
                   cudaStream_t stream) {
  if ((ksc == nullptr) != (vsc == nullptr)) return (int)cudaErrorInvalidValue;
  if (ksc != nullptr)
    return launch_ring<T, int8_t, HD>(q, kc, vc, ksc, vsc, kn, vn, pos,
        batch_pos, out, partial, lse, B, Q, Hq, Hkv, C, block_k, n_k,
        n_splits, kpb, verify, window, logit_cap, scale, stream);
  return launch_ring<T, T, HD>(q, kc, vc, ksc, vsc, kn, vn, pos, batch_pos,
      out, partial, lse, B, Q, Hq, Hkv, C, block_k, n_k, n_splits, kpb,
      verify, window, logit_cap, scale, stream);
}

// The head dims built: 64 (smollm), 120 (h2o-danube) and 128.
template <typename T>
int launch_ring_dims(const void* q, const void* kc, const void* vc,
                     const float* ksc, const float* vsc, const void* kn,
                     const void* vn, const int* pos, int batch_pos, void* out,
                     float* partial, float* lse, int B, int Q, int Hq,
                     int Hkv, int C, int head_dim, int block_k, int n_k,
                     int n_splits, int kpb, int verify, int window,
                     float logit_cap, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_ring_kv<T, 64>(q, kc, vc, ksc, vsc, kn, vn, pos,
          batch_pos, out, partial, lse, B, Q, Hq, Hkv, C, block_k, n_k,
          n_splits, kpb, verify, window, logit_cap, scale, stream);
    case 120:
      return launch_ring_kv<T, 120>(q, kc, vc, ksc, vsc, kn, vn, pos,
          batch_pos, out, partial, lse, B, Q, Hq, Hkv, C, block_k, n_k,
          n_splits, kpb, verify, window, logit_cap, scale, stream);
    case 128:
      return launch_ring_kv<T, 128>(q, kc, vc, ksc, vsc, kn, vn, pos,
          batch_pos, out, partial, lse, B, Q, Hq, Hkv, C, block_k, n_k,
          n_splits, kpb, verify, window, logit_cap, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, candidates and out share it, and
// the caches when k_scale / v_scale are null).  With k_scale / v_scale
// (B, C, Hkv, 1) fp32, the caches are int8.  head_dim 64, 120 or 128.
// pos holds one int32 (batch_pos = 0) or one per batch row (batch_pos =
// 1).  verify = 0: decode (k_new / v_new unused).  n_splits == 1 writes
// out (B, Q, Hq, HD); otherwise partial (B, Hq, S, Q, HD) and lse (B, Hq,
// S, Q).
extern "C" int ring_attention_sweep(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* k_new,
    const void* v_new, const void* pos, void* out, void* partial, void* lse,
    int B, int Q, int Hq, int Hkv, int C, int head_dim, int block_k, int n_k,
    int n_splits, int kpb, int batch_pos, int verify, int window,
    float logit_cap, float scale, int dtype, void* stream) {
  const float* ksc = static_cast<const float*>(k_scale);
  const float* vsc = static_cast<const float*>(v_scale);
  const int* pp = static_cast<const int*>(pos);
  float* part = static_cast<float*>(partial);
  float* lp = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Q < 1 || block_k < 1 || n_k * block_k != C)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_ring_dims<__nv_bfloat16>(q, k_cache, v_cache, ksc, vsc,
        k_new, v_new, pp, batch_pos, out, part, lp, B, Q, Hq, Hkv, C,
        head_dim, block_k, n_k, n_splits, kpb, verify, window, logit_cap,
        scale, st);
  if (dtype == 0)
    return launch_ring_dims<float>(q, k_cache, v_cache, ksc, vsc, k_new,
        v_new, pp, batch_pos, out, part, lp, B, Q, Hq, Hkv, C, head_dim,
        block_k, n_k, n_splits, kpb, verify, window, logit_cap, scale, st);
  return (int)cudaErrorInvalidValue;
}
