// Inline PTX for the port's tensor-core kernels (flash_attention.cu,
// paged_attention.cu, mla_attention.cu, ssd_scan.cu, ssd_scan_bwd.cu): 16-,
// 8- and 4-byte asynchronous copies into shared memory with zero fill, a
// tile's rows copied that way, ldmatrix fragment loads, the bf16 m16n8k16
// mma with fp32 accumulators, and the padded row stride of a bf16 tile.
// Everything is internal to the translation unit that includes it.
//
// Fragment layouts of mma.sync.aligned.m16n8k16.row.col (lane l, quad
// row l / 4, quad column 2 * (l % 4)):
//   A 16 x 16 (row-major), four .b32 of two bf16: a0 (row, col), a1 (row
//     + 8, col), a2 (row, col + 8), a3 (row + 8, col + 8);
//   B 16 x 8 (k x n), two .b32: b0 (k = col, n = row), b1 (k = col + 8);
//   C/D 16 x 8 fp32: c0, c1 (row, col, col + 1), c2, c3 (row + 8).
// So the C fragments of two neighbouring n8 tiles are, packed to bf16, the
// A fragment of one k16 step: a score tile becomes the next product's
// operand without leaving registers.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously; with ok false
// nothing is read (src may be any valid address) and the 16 bytes are
// zero-filled
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 16 : 0));
}

// the same for 8 or 4 bytes (cached at all levels, since .cg takes only
// 16): int8 rows of 120 values, which are 8-byte aligned only, and single
// fp32 scales
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Rows [0, rows) x columns [0, cols) of a row-major matrix (row stride
// rs) into shared memory (row stride ld, 16-byte aligned rows), zero-filled
// to rows_pad x cols_pad (cols_pad a multiple of 16 bytes), by nt threads:
// 16-byte cp.async copies, zero-filling ones past the data, where the
// source allows, all in flight together -- the caller commits and waits --
// and elementwise loads for a ragged or misaligned source.
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, int ld, const T* src,
                                          long rs, int rows, int rows_pad,
                                          int cols, int cols_pad, int tid,
                                          int nt) {
  constexpr int V = 16 / sizeof(T);              // values a copy
  const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0
                   && rs % V == 0;
  const int cv = cols_pad / V;
  for (int idx = tid; idx < rows_pad * cv; idx += nt) {
    const int r = idx / cv, k = (idx - r * cv) * V;
    T* d = dst + r * ld + k;
    const bool live = r < rows && k < cols;
    if (!live || (vec && k + V <= cols)) {
      cp_async16(d, live ? src + r * rs + k : src, live);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        d[j] = k + j < cols ? src[r * rs + k + j] : T(0.f);
    }
  }
}

// four 8 x 8 b16 matrices; lanes 8 i .. 8 i + 7 give the row addresses of
// matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed (B fragments of a row-major k x n tile)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// two transposed matrices, row addresses from lanes 0 .. 15
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// d += a . b, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16_16816(float* d, const uint32_t* a,
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats x0, x1 (x0 the lower column) as two .b32 of bf16 pairs, hi
// = bf16(x) and lo = bf16(x - hi): hi + lo holds about 16 bits of x
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// A shared-memory row of n bf16 values is padded to an odd number of
// 16-byte chunks, so the 8 row addresses of one ldmatrix fall on 8
// distinct 16-byte bank groups (conflict-free without a swizzle)
__host__ __device__ constexpr int tc_ld(int n) {
  return (n / 8) % 2 ? n : n + 8;
}

}  // namespace
