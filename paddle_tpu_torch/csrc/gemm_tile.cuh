// The GEMM tile core shared by the 1x1-conv + BN-statistics kernel (conv1x1_bn.cu, bf16)
// and the dynamic int8 matmul (int8_matmul.cu, s8): C[BM x BN] = A[BM x K] B[K x BN] with
// both operands K-major in shared memory, on mma.sync tensor-core instructions, for sm_90a.
//
// Bound: both kernels move few bytes per operation at their main shapes (ResNet-50's 1x1
// convs, BERT-base's fc layers), so what the core must do is keep the tensor pipe fed
// while the copies fly and write the output once, in whole 16-byte stores. What it does:
//  * K tiles are 64 bytes deep (32 bf16 or 64 int8 values) and staged by 16-byte
//    cp.async.cg copies into a ring of kStages slots, so the next tiles are in flight
//    while the current one is multiplied. A chunk that is ragged (past K, past the last
//    row, or an unaligned row) is copied byte by byte with zeros past the edge, so the
//    kernels take any M, K, N and pointer.
//  * Shared rows are padded to 80 bytes: the eight 16-byte rows one ldmatrix matrix reads
//    fall in eight distinct bank quads, so operand loads are free of bank conflicts.
//  * Operands come by ldmatrix.x4. In bytes, the fragments of mma.m16n8k16 bf16 and of
//    mma.m16n8k32 s8 are the same (a0: row g, bytes 4t..4t+3 of a 32-byte k chunk; a1:
//    row g+8; a2, a3: bytes 16+4t; b0, b1 likewise for column g), so one ldmatrix of b16
//    pairs serves both types, and the core is written in bytes.
//  * A block is 8 warps (256 threads) over a BM x BN tile of 64/128 x 64/128; each warp
//    owns a WM x WN sub-tile (MI m16 tiles by NI n8 tiles of accumulators).
//  * The kernel's own epilogue gets the accumulator fragment (acc_row / acc_col say where
//    each element lies), stages the output tile in shared memory and writes it with
//    store_tile: 16-byte coalesced stores, element stores only at a ragged edge.
// Not used: wgmma and TMA. On an H100 the copies cost issue slots of the warps that also
// multiply, so the two add up instead of overlapping; a copy warp (one, or a warpgroup)
// fed by mbarriers issued too slowly and was slower still (PERF.md). TMA, which issues a
// whole tile from one thread, and wgmma are what is left.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace gemm_tile {

using flash_mma::cp_async16;
using flash_mma::cp_commit;
using flash_mma::cp_wait;
using flash_mma::ldsm_x4;

constexpr int kThreads = 256;   // 8 warps
constexpr int kKBytes = 64;     // bytes of K per pipeline stage
constexpr int kRowStride = 80;  // padded shared row of one K tile (bytes)

template <int BM_, int BN_, int WARPS_M_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = 8 / WARPS_M_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(WARPS_M * WARPS_N == 8 && MI >= 1 && NI % 2 == 0, "tile shape");
  static constexpr int kABytes = BM * kRowStride;  // one stage of A
  static constexpr int kBBytes = BN * kRowStride;  // one stage of a K-major B
};

// D[16x8] += A[16x16] B[16x8], bf16 in, f32 accumulation.
struct MmaBf16 {
  using Acc = float;
  static __device__ __forceinline__ void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    flash_mma::mma_bf16(c, a, b0, b1);
  }
};

// D[16x8] += A[16x32] B[32x8], s8 in, s32 accumulation (exact).
struct MmaS8 {
  using Acc = int;
  static __device__ __forceinline__ void mma(Acc (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// One 16-byte chunk of a K-major row: src points at its first byte, n of its bytes lie
// before the edge. Whole and aligned: a cp.async; past the edge: a zero fill; else byte
// loads (zeros past the edge) and one shared store.
__device__ __forceinline__ void load_chunk(uint8_t* dst, const uint8_t* src, int n, bool vec) {
  if (n >= 16 && vec) {
    cp_async16(dst, src, true);
  } else if (n <= 0) {
    cp_async16(dst, src, false);
  } else {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j < n) w[j >> 2] |= (uint32_t)src[j] << (8 * (j & 3));
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// Rows row0 .. row0 + kRows - 1, bytes kb0 .. kb0 + 63 of a K-major matrix (row stride
// `ld` bytes, `kbytes` bytes of K, `rows` rows) into a padded [kRows][kRowStride] slot.
// vec: every row starts 16-byte aligned.
template <int kRows>
__device__ __forceinline__ void load_kmajor(uint8_t* dst, const uint8_t* src, long long ld,
                                            int row0, int rows, int kb0, int kbytes, bool vec,
                                            int tid) {
#pragma unroll
  for (int i = tid; i < kRows * 4; i += kThreads) {
    const int r = i >> 2, c = (i & 3) * 16;
    const int row = row0 + r, kb = kb0 + c;
    const bool live = row < rows && kb < kbytes;
    load_chunk(dst + r * kRowStride + c, live ? src + row * ld + kb : src,
               live ? kbytes - kb : 0, vec);
  }
}

// One 64-byte K stage of the warp's WM x WN sub-tile: two k32-byte steps, A and B
// fragments by ldmatrix from the padded K-major slots.
template <class T, class M>
__device__ __forceinline__ void warp_mma(typename M::Acc (&acc)[T::MI][T::NI][4],
                                         const uint8_t* sA, const uint8_t* sB, int wm, int wn,
                                         int lane) {
  using namespace flash_mma;
#pragma unroll
  for (int ks = 0; ks < kKBytes; ks += 32) {
    // every fragment of the step first, then the products: one wait on shared memory
    uint32_t a[T::MI][4], b[T::NI / 2][4];
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
      ldsm_x4(a[mi], sA + (wm * T::WM + mi * 16 + a_frag_row(lane)) * kRowStride + ks +
                         a_frag_col(lane) * 2);
#pragma unroll
    for (int nj = 0; nj < T::NI / 2; ++nj)
      ldsm_x4(b[nj], sB + (wn * T::WN + nj * 16 + b_frag_row(lane)) * kRowStride + ks +
                         b_frag_col(lane) * 2);
#pragma unroll
    for (int nj = 0; nj < T::NI / 2; ++nj)
#pragma unroll
      for (int mi = 0; mi < T::MI; ++mi) {
        M::mma(acc[mi][2 * nj], a[mi], b[nj][0], b[nj][1]);
        M::mma(acc[mi][2 * nj + 1], a[mi], b[nj][2], b[nj][3]);
      }
  }
}

template <class T, class Acc>
__device__ __forceinline__ void zero_acc(Acc (&acc)[T::MI][T::NI][4]) {
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = Acc(0);
}

// Where accumulator element acc[mi][ni][2 * h + j] lies in the block tile.
template <class T>
__device__ __forceinline__ int acc_row(int wm, int lane, int mi, int h) {
  return wm * T::WM + mi * 16 + (lane >> 2) + 8 * h;
}
template <class T>
__device__ __forceinline__ int acc_col(int wn, int lane, int ni, int j) {
  return wn * T::WN + ni * 8 + (lane & 3) * 2 + j;
}

// The staged BM x BN output tile (shared rows of `stride` bytes) to dst [rows, cols]
// (row stride ld elements) at (row0, col0): 16-byte stores where a chunk is whole and
// vec (dst rows 16-byte aligned), element stores at a ragged edge.
template <int BM, int BN, typename E>
__device__ __forceinline__ void store_tile(E* dst, const uint8_t* sC, int stride, long long ld,
                                           int row0, int rows, int col0, int cols, bool vec,
                                           int tid) {
  constexpr int kPer = 16 / sizeof(E), kChunks = BN / kPer;
  for (int i = tid; i < BM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    const int row = row0 + r, col = col0 + c;
    if (row >= rows || col >= cols) continue;
    const uint8_t* src = sC + r * stride + c * sizeof(E);
    E* out = dst + row * ld + col;
    if (vec && col + kPer <= cols) {
      *reinterpret_cast<uint4*>(out) = *reinterpret_cast<const uint4*>(src);
    } else {
      const E* s = reinterpret_cast<const E*>(src);
      for (int j = 0; j < kPer && col + j < cols; ++j) out[j] = s[j];
    }
  }
}

}  // namespace gemm_tile
