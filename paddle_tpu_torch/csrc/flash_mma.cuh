// Tensor-core and copy primitives shared by the flash-attention kernels (sm_80+ PTX, built
// for sm_90a): mma.sync m16n8k16 bf16 with f32 accumulation, ldmatrix operand loads, and
// cp.async copies of row tiles into padded shared memory.
//
// Fragment conventions (PTX ISA, "Matrix fragments for mma.m16n8k16"), g = lane / 4 and
// t = lane % 4:
//   A (16 x 16, row-major): a0 (row g, k 2t..2t+1), a1 (row g+8, k 2t..), a2 (row g,
//     k 2t+8..), a3 (row g+8, k 2t+8..);
//   B (16 x 8, "col"): b0 (k 2t..2t+1, col g), b1 (k 2t+8.., col g);
//   C (16 x 8, f32): c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, cols 2t, 2t+1).
// A C fragment of scores, rounded to bf16 pairwise, is an A fragment of the next product
// (the scores' columns are its k), so P and dS go from registers straight into mma.
//
// Shared-memory rows are padded by 8 elements (16 bytes): at a row stride of 16 * (odd)
// bytes the eight 16-byte rows one ldmatrix matrix reads fall in eight distinct bank
// quads, so every ldmatrix and every 32-bit fragment store is free of bank conflicts.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace flash_mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x (ex2.approx.ftz: 2^-22 relative; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D[16x8] += A[16x16] * B[16x8], bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i, and register i
// receives the thread's (row g, cols 2t, 2t+1) of matrix i (or of its transpose, _t).
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Lane offsets (row, column) into a row-major 16 x 16 block of a tile for one ldmatrix.x4:
//  * a_frag: with ldsm_x4 on an [m][k] tile, the A fragment; with ldsm_x4_t on a [k][n]
//    tile, the B fragments (b0, b1) of two n8 tiles (regs 0-1: cols 0-7; 2-3: cols 8-15);
//  * b_frag: with ldsm_x4 on an [n][k] tile, the B fragments of two n8 tiles (rows 0-7 and
//    8-15); with ldsm_x4_t on a [k][m] tile, the A fragment of its transpose.
__device__ __forceinline__ int a_frag_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_frag_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_frag_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int b_frag_col(int lane) { return ((lane >> 3) & 1) * 8; }

// 16-byte asynchronous copy; a false `valid` fills the 16 bytes with zeros (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
// 4-byte asynchronous copy (one f32); a false `valid` stores 0.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows r0 .. r0 + kRows - 1 of a [*, D] bf16 matrix (row stride `ss` elements) into a padded
// [kRows][D + 8] tile, by cp.async; rows at or past `limit` are zero.
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void stage_rows_async(bf16* dst, const bf16* src, long long ss,
                                                 int r0, int limit, int tid) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool valid = r0 + r < limit;
    cp_async16(dst + r * (D + 8) + c, valid ? src + (r0 + r) * ss + c : src, valid);
  }
}

}  // namespace flash_mma
