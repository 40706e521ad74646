// Fused 1x1 convolution + batch-norm statistics for Hopper (sm_90a):
//   z  = [prologue: relu((x - mu) * inv * g + b)] x, rounded to x's dtype
//   y  = z @ W, accumulated in f32, rounded to x's dtype
//   s  = sum over rows of y (the rounded values), ss = sum of y^2, both f32.
//
// Replaces: paddle_tpu/ops/pallas_conv_bn.py::fused_conv1x1_bn_fwd / _kernel, the TPU
// Pallas kernel of the conv2d_bn_fused op (a 1x1/s1 NHWC conv as [M, K] x [K, N] with the
// following batch norm's statistics in the epilogue).
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the kernel reads x [M, K] and W
// once and writes y [M, N] once, and does 2*M*K*N FLOPs. At ResNet-50's 1x1 shapes (K, N
// between 64 and 2048) that is 2*K*N / (2*(K + N)) FLOPs per byte, at most ~400 for the
// 2048 <-> 512 convs and ~50 for the 64 <-> 256 ones, so most launches are bound by bytes:
// y (80% of the bytes at M 401408 K 64 N 256) is written once, in whole 16-byte stores, and
// never read back for the statistics.
//
// Design (bf16, the op's path), on the GEMM core of gemm_tile.cuh: 128 x 128 tiles (128 x
// 64 where N <= 64), 8 warps, 64-byte K stages in a 3-slot cp.async ring, ldmatrix
// operands, mma.sync m16n8k16 with f32 accumulation. x [M, K] and the filter as stored,
// W^T = [N, K], are both K-major: neither is transposed. The grid is persistent: a block
// owns one column block and walks a fixed list of M tiles (gy, gy + G, gy + 2G, ..., with
// G = gridDim.y chosen by the wrapper, about two blocks an SM); the ring runs straight
// across its tiles, so one tile's epilogue overlaps the next one's loads. The epilogue
// rounds the accumulator to bf16, adds the rounded values and their squares to column
// sums that each thread carries in registers across all its tiles, stages the tile in
// shared memory and stores it with 16-byte stores. At the end each block reduces its
// column sums (warp shuffles, then its row-warps in a fixed order) to one partial row of
// an f32 scratch [2, G, N], and a second kernel sums the G rows per column in a fixed
// order: deterministic, no atomics, and the scratch is G rows, not M/64. The BN prologue
// (off on the op's path) is a template instantiation of its own: it transforms each x
// stage in shared memory, in f32 with IEEE operations in the TPU kernel's order, rounded
// back to bf16, so the op's instantiation carries none of it.
// The f32 path (not on a main path) is the first version's: 64 x 64 tiles of full-precision
// FMAs with per-tile partials, then the same second kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

constexpr int kBM = 64;  // output rows per block (f32 path)
constexpr int kBN = 64;  // output columns per block (f32 path)

struct Params {
  const void* x;     // [M, K]
  const void* w;     // [N, K] (W transposed, k contiguous)
  const float* mu;   // [K] prologue: mean, rsqrt(var + eps), gamma, beta
  const float* inv;
  const float* g;
  const float* b;
  void* y;           // [M, N]
  float* part;       // [2, rows, N]: per-block column sums, then sums of squares
  int M, K, N;
  int apply_in_bn, relu_in, vec;  // vec: rows 16-byte aligned, K % 8 == 0
};

__device__ __forceinline__ float prologue(float v, int k, const float* mu, const float* inv,
                                          const float* g, const float* b, int apply,
                                          int relu) {
  if (apply) v = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v, mu[k]), inv[k]), g[k]), b[k]);
  if (relu) v = fmaxf(v, 0.f);
  return v;
}

// ---------------------------------------------------------------------------------------
// bf16: persistent tensor-core path on the gemm_tile core
// ---------------------------------------------------------------------------------------

using gemm_tile::kKBytes;
using gemm_tile::kRowStride;
using gemm_tile::kThreads;
using TileWide = gemm_tile::Tile<128, 128, 2>;    // warps 64 x 32
using TileNarrow = gemm_tile::Tile<128, 64, 4>;   // N <= 64: warps 32 x 32
constexpr int kStages = 3;

template <class T>
struct Smem {
  static constexpr int kRing = kStages * (T::kABytes + T::kBBytes);
  static constexpr int kCStride = T::BN * 2 + 16;  // staged y row (bytes)
  static constexpr int kC = T::BM * kCStride;
  static constexpr int kBytes = kRing + kC + 2 * T::WARPS_M * T::BN * 4;
};

// The prologue on one staged x slot (rows m0.., bytes kb0..kb0 + 63), in place; rows past
// M and k past K stay the zeros the loader wrote.
template <class T>
__device__ __forceinline__ void prologue_slot(uint8_t* sA, const Params& p, int m0, int kb0,
                                              int tid) {
  for (int i = tid; i < T::BM * 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    const int k = (kb0 + c) >> 1;
    if (m0 + r >= p.M || k >= p.K) continue;
    uint2* q = reinterpret_cast<uint2*>(sA + r * kRowStride + c);
    uint2 raw = *q;
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
    float v[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = k + j < p.K ? prologue(v[j], k + j, p.mu, p.inv, p.g, p.b, p.apply_in_bn,
                                    p.relu_in)
                         : 0.f;
    __nv_bfloat162 zl = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 zh = __floats2bfloat162_rn(v[2], v[3]);
    *q = make_uint2(*reinterpret_cast<uint32_t*>(&zl), *reinterpret_cast<uint32_t*>(&zh));
  }
}

template <class T, bool kPrologue>
__global__ void __launch_bounds__(kThreads, 2) conv1x1_bn_bf16_kernel(const Params p) {
  using S = Smem<T>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sC = smem + S::kRing;
  float* red = reinterpret_cast<float*>(sC + S::kC);  // [2][WARPS_M][BN]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int n0 = blockIdx.x * T::BN;
  const int G = gridDim.y, gy = blockIdx.y;
  const int tiles = (p.M + T::BM - 1) / T::BM;
  const int kbytes = 2 * p.K, n_k = (kbytes + kKBytes - 1) / kKBytes;
  const int iters = (tiles - gy + G - 1) / G * n_k;  // gy < tiles: the wrapper's G <= tiles
  const long long ld = kbytes;
  const uint8_t* x = static_cast<const uint8_t*>(p.x);
  const uint8_t* w = static_cast<const uint8_t*>(p.w);
  const bool vec = p.vec != 0;

  auto load = [&](int it) {
    uint8_t* sA = smem + (it % kStages) * (T::kABytes + T::kBBytes);
    const int m0 = (gy + (it / n_k) * G) * T::BM, kb0 = (it % n_k) * kKBytes;
    gemm_tile::load_kmajor<T::BM>(sA, x, ld, m0, p.M, kb0, kbytes, vec, tid);
    gemm_tile::load_kmajor<T::BN>(sA + T::kABytes, w, ld, n0, p.N, kb0, kbytes, vec, tid);
  };

  float acc[T::MI][T::NI][4];
  gemm_tile::zero_acc<T>(acc);
  float cs[T::NI][2], css[T::NI][2];  // this thread's column sums over all its tiles
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni) cs[ni][0] = cs[ni][1] = css[ni][0] = css[ni][1] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < iters) load(s);
    gemm_tile::cp_commit();
  }
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  const bool vec_y = p.N % 8 == 0 && reinterpret_cast<uintptr_t>(p.y) % 16 == 0;
  for (int it = 0; it < iters; ++it) {
    gemm_tile::cp_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for all; the slot refilled below is free
    if (it + kStages - 1 < iters) load(it + kStages - 1);
    gemm_tile::cp_commit();
    uint8_t* sA = smem + (it % kStages) * (T::kABytes + T::kBBytes);
    const int m0 = (gy + (it / n_k) * G) * T::BM;
    if constexpr (kPrologue) {
      prologue_slot<T>(sA, p, m0, (it % n_k) * kKBytes, tid);
      __syncthreads();
    }
    gemm_tile::warp_mma<T, gemm_tile::MmaBf16>(acc, sA, sA + T::kABytes, wm, wn, lane);
    if (it % n_k != n_k - 1) continue;

    // the tile is done: round, add to the column sums, stage, store. An interior tile
    // (every block tile but the ragged edge's) sums without per-element masks.
    const bool interior = m0 + T::BM <= p.M && n0 + T::BN <= p.N;
#pragma unroll
    for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gemm_tile::acc_row<T>(wm, lane, mi, h);
          const int c = gemm_tile::acc_col<T>(wn, lane, ni, 0);
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(sC + r * S::kCStride + c * 2) = v;
          const float2 f = __bfloat1622float2(v);
          if (interior) {
            cs[ni][0] += f.x, css[ni][0] = fmaf(f.x, f.x, css[ni][0]);
            cs[ni][1] += f.y, css[ni][1] = fmaf(f.y, f.y, css[ni][1]);
          } else if (m0 + r < p.M) {
            if (n0 + c < p.N) cs[ni][0] += f.x, css[ni][0] = fmaf(f.x, f.x, css[ni][0]);
            if (n0 + c + 1 < p.N) cs[ni][1] += f.y, css[ni][1] = fmaf(f.y, f.y, css[ni][1]);
          }
        }
    gemm_tile::zero_acc<T>(acc);
    __syncthreads();  // sC complete; the next tile's epilogue is past another barrier
    gemm_tile::store_tile<T::BM, T::BN>(y, sC, S::kCStride, p.N, m0, p.M, n0, p.N, vec_y, tid);
  }

  // one partial row per block: the 8 row groups of each warp (shuffles), then the
  // row-warps in order
#pragma unroll
  for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        cs[ni][j] += __shfl_xor_sync(0xffffffffu, cs[ni][j], off);
        css[ni][j] += __shfl_xor_sync(0xffffffffu, css[ni][j], off);
      }
  if (lane < 4) {
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = gemm_tile::acc_col<T>(wn, lane, ni, j);
        red[wm * T::BN + c] = cs[ni][j];
        red[(T::WARPS_M + wm) * T::BN + c] = css[ni][j];
      }
  }
  __syncthreads();
  if (tid < T::BN && n0 + tid < p.N) {
    float a = 0.f, a2 = 0.f;
#pragma unroll
    for (int r = 0; r < T::WARPS_M; ++r)
      a += red[r * T::BN + tid], a2 += red[(T::WARPS_M + r) * T::BN + tid];
    p.part[(size_t)gy * p.N + n0 + tid] = a;
    p.part[(size_t)(G + gy) * p.N + n0 + tid] = a2;
  }
}

template <class T, bool kPrologue>
cudaError_t launch_bf16(const Params& p, int rows, cudaStream_t st) {
  static bool ready = false;  // one attribute call per instantiation and process
  auto kernel = conv1x1_bn_bf16_kernel<T, kPrologue>;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T>::kBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((p.N + T::BN - 1) / T::BN, rows);
  kernel<<<grid, kThreads, Smem<T>::kBytes, st>>>(p);
  return cudaGetLastError();
}

template <bool kPrologue>
cudaError_t launch_bf16_by_n(const Params& p, int rows, cudaStream_t st) {
  return p.N <= 64 ? launch_bf16<TileNarrow, kPrologue>(p, rows, st)
                   : launch_bf16<TileWide, kPrologue>(p, rows, st);
}

// ---------------------------------------------------------------------------------------
// f32: FMA path, 256 threads, each a 4 x 4 sub-tile of the 64 x 64 block tile
// ---------------------------------------------------------------------------------------

constexpr int kF32BK = 16;
constexpr int kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads) conv1x1_bn_f32_kernel(const Params p) {
  __shared__ float sA[kF32BK][kBM + 4];  // k-major: a thread reads 4 consecutive rows
  __shared__ float sB[kF32BK][kBN + 4];
  __shared__ float red[2][16][kBN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // columns tx*4.., rows ty*4..
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w);

  float acc[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kF32BK) {
    for (int it = tid; it < kBM * kF32BK; it += kF32Threads) {
      const int r = it / kF32BK, c = it % kF32BK;
      const int gm = m0 + r, gk = k0 + c;
      float v = 0.f;
      if (gm < p.M && gk < p.K)
        v = prologue(x[(size_t)gm * p.K + gk], gk, p.mu, p.inv, p.g, p.b, p.apply_in_bn,
                     p.relu_in);
      sA[c][r] = v;
    }
    for (int it = tid; it < kBN * kF32BK; it += kF32Threads) {
      const int r = it / kF32BK, c = it % kF32BK;
      const int gn = n0 + r, gk = k0 + c;
      sB[c][r] = (gn < p.N && gk < p.K) ? w[(size_t)gn * p.K + gk] : 0.f;
    }
    __syncthreads();
    for (int k = 0; k < kF32BK; ++k) {
      float a[4], b[4];
      for (int i = 0; i < 4; ++i) a[i] = sA[k][ty * 4 + i];
      for (int j = 0; j < 4; ++j) b[j] = sB[k][tx * 4 + j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* y = static_cast<float*>(p.y);
  float cs[4] = {0.f, 0.f, 0.f, 0.f}, css[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= p.M) continue;
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col >= p.N) continue;
      y[(size_t)row * p.N + col] = acc[i][j];
      cs[j] += acc[i][j];
      css[j] += acc[i][j] * acc[i][j];
    }
  }
  for (int j = 0; j < 4; ++j) {
    red[0][ty][tx * 4 + j] = cs[j];
    red[1][ty][tx * 4 + j] = css[j];
  }
  __syncthreads();
  if (tid < kBN) {
    const int col = n0 + tid;
    if (col < p.N) {
      float s = 0.f, s2 = 0.f;
      for (int r = 0; r < 16; ++r) s += red[0][r][tid], s2 += red[1][r][tid];
      const size_t tiles = gridDim.y;
      p.part[blockIdx.y * (size_t)p.N + col] = s;
      p.part[(tiles + blockIdx.y) * (size_t)p.N + col] = s2;
    }
  }
}

// ---------------------------------------------------------------------------------------
// second pass: s[n], ss[n] = the M tiles' partials summed in a fixed order
// ---------------------------------------------------------------------------------------

__global__ void __launch_bounds__(1024) column_sums_kernel(const float* part, float* s,
                                                           float* ss, int tiles, int N) {
  __shared__ float red[2][32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int col = blockIdx.x * 32 + tx;
  float a = 0.f, a2 = 0.f;
  if (col < N)
    for (int r = ty; r < tiles; r += 32) {
      a += part[(size_t)r * N + col];
      a2 += part[(size_t)(tiles + r) * N + col];
    }
  red[0][ty][tx] = a;
  red[1][ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && col < N) {
    float t1 = 0.f, t2 = 0.f;
    for (int r = 0; r < 32; ++r) t1 += red[0][r][tx], t2 += red[1][r][tx];
    s[col] = t1;
    ss[col] = t2;
  }
}

}  // namespace

// x [M, K], w [N, K] (both in dtype: 0 = float32, 1 = bfloat16), mu/inv/g/b [K] f32 (read
// only when apply_in_bn), y [M, N] in dtype, part an f32 scratch [2, rows, N], s/ss [N]
// f32. rows: bf16, the persistent grid's row count G (1 <= G <= ceil(M/128)); f32,
// ceil(M/64). vec: x and w 16-byte aligned and K % 8 == 0. Launches the product (with the
// prologue instantiation when apply_in_bn or relu_in) and the column sums. Returns a
// cudaError_t (0 = launched).
extern "C" int conv1x1_bn(const void* x, const void* w, const void* mu, const void* inv,
                          const void* g, const void* b, void* y, void* part, void* s,
                          void* ss, int M, int K, int N, int dtype, int apply_in_bn,
                          int relu_in, int vec, int rows, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || rows <= 0 || rows > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (dtype == 1 ? rows > (M + 127) / 128 : rows != (M + kBM - 1) / kBM)
    return cudaErrorInvalidValue;
  Params p;
  p.x = x, p.w = w, p.y = y, p.part = static_cast<float*>(part);
  p.mu = static_cast<const float*>(mu), p.inv = static_cast<const float*>(inv);
  p.g = static_cast<const float*>(g), p.b = static_cast<const float*>(b);
  p.M = M, p.K = K, p.N = N, p.apply_in_bn = apply_in_bn, p.relu_in = relu_in;
  p.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1) {
    err = (apply_in_bn || relu_in) ? launch_bf16_by_n<true>(p, rows, st)
                                   : launch_bf16_by_n<false>(p, rows, st);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, rows);  // column tiles fastest: x tiles reused in L2
    conv1x1_bn_f32_kernel<<<grid, kF32Threads, 0, st>>>(p);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return err;
  column_sums_kernel<<<(N + 31) / 32, dim3(32, 32), 0, st>>>(
      p.part, static_cast<float*>(s), static_cast<float*>(ss), rows, N);
  return cudaGetLastError();
}
