// Tensor-core building blocks for the bf16 attention kernels, in inline
// PTX for sm_80 and later (sm_90a here): mma.sync m16n8k16 with f32
// accumulators, ldmatrix (plain and transposed), cp.async with zero fill,
// and an XOR-swizzled shared layout for rows of 64 or 128 bf16.
//
// Fragment layouts of mma.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with g = lane / 4 and c = 2 * (lane % 4):
//   A (16 x 16, row-major)  a0: (g, c..c+1)    a1: (g+8, c..c+1)
//                           a2: (g, c+8..c+9)  a3: (g+8, c+8..c+9)
//   B (16 x 8, k x n)       b0: (k = c..c+1, n = g)  b1: (k = c+8..c+9, n = g)
//   C/D (16 x 8, f32)       d0, d1: (g, c..c+1)     d2, d3: (g+8, c..c+1)
// A bf16 pair packs the lower column (or k) in the low 16 bits.
//
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row
// addresses of matrix i, and lane l receives row l / 4, columns
// 2 * (l % 4) and +1 of each (with .trans: column l / 4, rows 2 * (l % 4)
// and +1).  So an A fragment is one ldmatrix.x4 of a row-major tile, a B
// fragment of a matrix stored n-major ([n][k], as K in Q K^T) is a plain
// ldmatrix, and one stored k-major ([k][n], as V in P V) a transposed one.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hvd {
namespace mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a [rows][D] bf16
// tile.  Chunks are XOR-swizzled by the row's low three bits, so the eight
// rows one ldmatrix (or one 128-byte cp.async wavefront) touches at one
// logical chunk fall in eight distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ uint32_t swizzle(int row, int chunk) {
  static_assert(D == 64 || D == 128, "rows of 64 or 128 bf16");
  return static_cast<uint32_t>(row * (D * 2) + ((chunk ^ (row & 7)) << 4));
}

// 16 bytes global -> shared, bypassing L1; with `valid` false nothing is
// read and the 16 bytes are zero-filled (rows past the sequence end).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared (lse, delta, segment ids); zero-filled when
// `valid` is false.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a * b on one 16 x 8 x 16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a bf16 pair (round to nearest even), `lo` in the low
// half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// This lane's ldmatrix.x4 row address for a 16 x 16 block at (row0,
// 16-column block kb) of a swizzled [rows][D] bf16 tile at `base`:
//  * a_frag_addr: matrices rows 0-7 | 8-15, then columns 0-7 | 8-15 -- an
//    A fragment; with .trans, two k-major B fragments (rows being k:
//    regs 0,1 for n 0-7 and 2,3 for n 8-15 of the block);
//  * b_frag_addr: matrices columns 0-7 | 8-15 of rows 0-7, then of rows
//    8-15 -- two n-major B fragments (rows being n: regs 0,1 for n-tile 0
//    and 2,3 for n-tile 1).
template <int D>
__device__ __forceinline__ uint32_t a_frag_addr(uint32_t base, int row0,
                                                int kb, int lane) {
  return base + swizzle<D>(row0 + (lane & 7) + ((lane >> 3) & 1) * 8,
                           2 * kb + (lane >> 4));
}

template <int D>
__device__ __forceinline__ uint32_t b_frag_addr(uint32_t base, int row0,
                                                int kb, int lane) {
  return base + swizzle<D>(row0 + (lane & 7) + (lane >> 4) * 8,
                           2 * kb + ((lane >> 3) & 1));
}

}  // namespace mma
}  // namespace hvd
