// Ring-cache GQA attention for Hopper (sm_90a): the sweep of the static
// batch path and of the engine's private windowed rings, with a plain C
// interface loaded through ctypes (src/repro_torch/kernels/build.py builds
// it into the same library as paged_attention.cu, and
// src/repro_torch/kernels/decode_attention.py wraps it).
//
//   ring_attention_sweep      stage 1 of GQA attention over a ring-buffer
//                             cache (B, C, Hkv, D): the Q query rows of the
//                             G q heads of one kv head over the slots of
//                             one split, online softmax in fp32, optional
//                             in-flight candidate fold; caches in the query
//                             dtype, or int8 with per-row fp32 scales.
//                             bf16 runs on the tensor cores, fp32 on the
//                             CUDA cores.  Stage 2, the merge, runs in the
//                             split's last block when counters are given
//                             (sweep_fragments.cuh, merge_tail), else it is
//                             paged_attention.cu's lse_merge.
//   ring_attention_occupancy  blocks per SM, dynamic shared memory and
//                             registers of one (head dim, dtype, caches)
//                             form at its widest block.
//
// They launch on the caller's stream, allocate nothing and return
// cudaGetLastError() so that a refused launch is reported.
#include <climits>

#include "sweep_fragments.cuh"

namespace {

// The ring sweep is sweep_fragments.cuh's gqa_sweep_kernel over RingKeys.
// It replaces, from src/repro/kernels/decode_attention.py, in their
// bf16/fp32 and their int8 forms (scales (B, C, Hkv, 1), _load_kv :94):
//   decode_attention_pallas           (:384, kernel _decode_kernel :207)
//   decode_attention_pallas_partials  (:298, kernel :251)
//   verify_attention_pallas           (:682, kernel _verify_kernel :479)
//   verify_attention_pallas_partials  (:589, kernel :534)
// What bounds it: latency, as the paged sweep.  A decode step reads every
// live cache byte once against G query rows (verify: Q G), far under the
// ~295 FLOP a byte where the tensor cores would bind, and the bytes take a
// microsecond or two at the batch paths' shapes.  The cache is read in
// place, in its (B, C, Hkv, D) layout (the JAX wrapper's transpose to (B,
// Hkv, C, D) was for the TPU's BlockSpecs and would copy the cache once per
// layer and step): a tile's 16 slots are consecutive rows Hkv D apart, and
// no table is read.
//
// Where its keys are: slot k of batch row b (row b C + k) holds position
// ref - m, m = (ref - k) mod C, with ref = pos (decode) or pos - 1
// (verify, whose row i sits at pos + i), pos from the device, one for all
// rows or one per row (pos_stride 1: the engine's private rings).  Query
// i sees the slot while ref - m >= lo(i): the position is >= 0, past the
// window (> pos + i - window; pos for decode), and for verify > pos + i -
// C, the slots the sequential loop would already have overwritten.  So m
// <= ref - lo(i) = mlim(i), and query 0 sees every slot any row sees.
//
// The block rule: the ring is cut into n_k blocks of bk slots (bk divides
// C), a split is kpb consecutive blocks, and a block in which no row sees a
// slot is skipped (the reference's any(valid)): its keys weigh nothing and
// are never read, where a key masked for one row inside a block that runs
// scores NEG_INF.  Query 0's slots are one cyclic run ending at slot ref
// mod C; widened to whole blocks it is the run of blocks that run, and its
// part in the split's slots is at most two ranges (the run may wrap past
// slot C - 1), each of whole blocks.  The split's tiles of 16 slots cut
// those ranges, the lower range first; a tile's slots past its range's end
// are not part of the sweep (-inf).  So a tile never straddles a skipped
// and a running block, whatever bk is (C = 545 = 5 x 109, 4369 = 257 x 17,
// a prime C has blocks of 1).
//
// A capacity shard (the ring's slots cut over ranks, each sweeping its
// own into partials that the ranks' merge combines) holds slots off .. off
// + C - 1 of a ring of CR slots: the positions, masks and query 0's run
// are the ring's (slot index off + k, modulus CR), the rows and blocks the
// shard's.  off is a multiple of bk and CR of C; the whole ring is off 0,
// CR = C.
struct RingKeys {
  const int* pos_arr;          // (1,) or (B,)
  int pos_stride;              // 0: one pos for all rows, 1: one per row
  int C, bk, n_k, kpb;
  int off, CR;                 // the shard's first slot, the ring's length

  __device__ __forceinline__ int pos(int b) const {
    return pos_arr[b * pos_stride];
  }

  struct Split {
    int base;                  // b C: the row of batch row b's slot 0
    int off;                   // the shard's first slot in the ring
    int C, ref, r0, pos, verify, window;   // C: the ring's length
    int n_low, low0, low1, up0, up1, mlim_all, n_tiles;

    // tile t's first slot in the shard, and the end of its range
    __device__ __forceinline__ int start(int t) const {
      return t < n_low ? low0 + t * SW_KEYS : up0 + (t - n_low) * SW_KEYS;
    }
    __device__ __forceinline__ int end(int t) const {
      return t < n_low ? low1 : up1;
    }

    __device__ __forceinline__ int row(int t, int r) const {
      const int slot = start(t) + r;
      return slot < end(t) ? base + slot : -1;
    }

    // how far below ref query i sees: mlim(i) = ref - lo(i)
    __device__ __forceinline__ int mlim(int i) const {
      int lo = max(verify ? pos + i - C + 1 : 0, 0);
      if (window > 0) lo = max(lo, (verify ? pos + i : pos) - window + 1);
      return ref - lo;
    }

    // a tile of 16 slots inside its range, whose largest m (C - 1 where it
    // holds slots r0 and r0 + 1) is within every row's, is valid for every
    // row
    __device__ __forceinline__ void mask(int t, int lane, const int (&qi)[2],
                                         float (&s)[2][4]) const {
      const int k0 = start(t) + off, k1 = end(t) + off;   // ring slots
      const int m0 = r0 - k0 < 0 ? r0 - k0 + C : r0 - k0;
      const int m_top = k0 <= r0 && r0 < k0 + SW_KEYS - 1 ? C - 1 : m0;
      if (k0 + SW_KEYS <= k1 && m_top <= mlim_all) return;
      const int kb = k0 + 2 * (lane & 3);
      const int in_hi = k1 - 1 - kb, mb = r0 - kb;
      const int ml[2] = {mlim(qi[0]), mlim(qi[1])};
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kr = 8 * n + (e & 1);
          const int m = mb - kr < 0 ? mb - kr + C : mb - kr;
          s[n][e] = kr > in_hi ? -INFINITY
                    : m <= ml[e >> 1] ? s[n][e] : NEG_INF;
        }
    }
  };

  __device__ __forceinline__ Split split(int b, int s, int pos, int verify,
                                         int window, int i_last) const {
    Split x;
    x.base = b * C;
    x.off = off;
    x.C = CR;
    x.pos = pos;
    x.verify = verify;
    x.window = window;
    x.ref = verify ? pos - 1 : pos;
    x.r0 = x.ref % CR < 0 ? x.ref % CR + CR : x.ref % CR;
    x.mlim_all = x.mlim(i_last);
    x.low0 = x.low1 = x.up0 = x.up1 = 0;
    // query 0's n slots r0 - n + 1 .. r0 (cyclic in the ring), widened
    // to whole blocks: the cyclic run [ra, ra + nr), cut to the split's
    // slots (shard slots e0 .. e1, ring slots off + e0 .. off + e1)
    const int n = min(x.mlim(0), CR - 1) + 1;
    if (n > 0) {
      const int sa = x.r0 - n + 1 < 0 ? x.r0 - n + 1 + CR : x.r0 - n + 1;
      const int ra = sa - sa % bk;
      const int nr = min(CR, n + sa % bk + bk - 1 - x.r0 % bk);
      const int e0 = s * kpb * bk, e1 = min((s + 1) * kpb, n_k) * bk;
      x.low0 = e0;
      x.low1 = min(e1, ra + nr - CR - off);
      x.up0 = max(e0, ra - off);
      x.up1 = min(e1, min(ra + nr, CR) - off);
    }
    auto tiles = [](int k0, int k1) {
      return k1 > k0 ? (k1 - k0 + SW_KEYS - 1) / SW_KEYS : 0;
    };
    x.n_low = tiles(x.low0, x.low1);
    x.n_tiles = x.n_low + tiles(x.up0, x.up1);
    return x;
  }

  // two ranges of whole blocks: each may end in a partial tile
  int most_tiles() const { return (kpb * bk + 2 * SW_KEYS - 2) / SW_KEYS; }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, candidates and out share it, and
// the caches when k_scale / v_scale are null).  With k_scale / v_scale
// (B, C, Hkv, 1) fp32, the caches are int8.  head_dim 64, 120 or 128.
// pos holds one int32 (batch_pos = 0) or one per batch row (batch_pos =
// 1).  verify = 0: decode (k_new / v_new unused).  Without partial
// (n_splits 1) it writes out (B, Q, Hq, HD); otherwise partial (B, Hq, S,
// Q, HD) and lse (B, Hq, S, Q), and, with counters (int32, one a (batch,
// kv head, 16-row tile), all zero; zero again after the launch), also the
// merged out (B, Q, Hq, HD) in the query dtype.  The caches hold slots
// slot_offset .. slot_offset + C - 1 of a ring of ring_len slots (0 and C:
// the whole ring).
extern "C" int ring_attention_sweep(
    const void* q, const void* k_cache, const void* v_cache,
    const void* k_scale, const void* v_scale, const void* k_new,
    const void* v_new, const void* pos, void* out, void* partial, void* lse,
    void* counters, int B, int Q, int Hq, int Hkv, int C, int head_dim,
    int block_k, int n_k, int n_splits, int kpb, int slot_offset,
    int ring_len, int batch_pos, int verify, int window, float logit_cap,
    float scale, int dtype, void* stream) {
  if (B < 1 || Q < 1 || Q > SW_MAX_Q || Hkv < 1 || Hq % Hkv || block_k < 1
      || n_k * block_k != C || n_splits < 1 || kpb < 1
      || slot_offset < 0 || slot_offset % block_k || ring_len % block_k
      || slot_offset + C > ring_len
      || (k_scale == nullptr) != (v_scale == nullptr)
      || (partial == nullptr) != (lse == nullptr)
      || (partial == nullptr && (n_splits > 1 || out == nullptr))
      || (counters != nullptr && n_splits > 1 && out == nullptr))
    return (int)cudaErrorInvalidValue;
  const SweepArgs a{q, k_cache, v_cache,
                    static_cast<const float*>(k_scale),
                    static_cast<const float*>(v_scale), k_new, v_new, out,
                    static_cast<float*>(partial), static_cast<float*>(lse),
                    static_cast<int*>(counters), B, Q, Hq, Hkv, n_splits,
                    verify, window, logit_cap, scale,
                    static_cast<cudaStream_t>(stream)};
  const RingKeys keys{static_cast<const int*>(pos), batch_pos ? 1 : 0, C,
                      block_k, n_k, kpb, slot_offset, ring_len};
  return sweep_dtype<RingKeys>(dtype, head_dim, k_scale != nullptr,
                               [&](auto form) {
                                 return decltype(form)::run(a, keys);
                               });
}

// info[3] = {blocks per SM, dynamic shared memory bytes, registers a
// thread} of the sweep's kernel for this form (int8 != 0: int8 caches), at
// its widest block
extern "C" int ring_attention_occupancy(int head_dim, int dtype, int int8,
                                        int* info) {
  return sweep_dtype<RingKeys>(dtype, head_dim, int8 != 0, [&](auto form) {
    return decltype(form)::occupancy(info);
  });
}
