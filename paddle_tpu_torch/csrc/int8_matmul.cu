// Dynamic int8 matmul for Hopper (sm_90a):
//   xs[m]  = max(max_k |x[m, k]| / 127, 1e-12)                      (per-row scale)
//   xq     = clip(round_half_even(x / xs), -127, 127) as int8
//   acc    = xq @ w8, int8 x int8 -> int32
//   out    = (float(acc) * xs[m]) * wscale[n], rounded to x's dtype.
//
// Replaces: paddle_tpu/ops/pallas_int8.py::fused_int8_matmul / _kernel, the TPU Pallas
// kernel of the quantized_mul op (int8 serving after quantize_weights(int8_compute=True)).
//
// Bound on an H100 SXM (3.35 TB/s, 1979 TOP/s dense int8): the function reads x [M, K]
// (bf16 or f32), w8 [K, N] int8 and wscale, and writes out [M, N], and does 2*M*K*N integer
// operations. At BERT-base's shapes (M = 1024 or 4096 tokens, K/N of 768, 2304 and 3072)
// the bytes take longer than the operations: 2.4-10 us, the output most of them.
//
// Design: two launches.
//  1. quantize_rows: one warp per row reads the row twice (the second time from cache):
//     the abs-max (exact in any order), xs with the IEEE division __fdiv_rn, then every
//     code with __fdiv_rn and __float2int_rn (round half to even; never a reciprocal
//     multiply, which would move codes), written to an int8 scratch [M, Kp] whose rows are
//     padded with zeros to Kp = K rounded up to 16. Each element of x is quantised once per
//     call, as the TPU kernel's j == 0 step quantises each row block once into VMEM; the
//     scratch is also the codes the wrapper returns.
//  2. int8_gemm: a pure s8 x s8 -> s32 product on the GEMM core of gemm_tile.cuh (tiles
//     of 128 x 128 or 64 x 64 chosen by the wrapper so that the grid fills the card at
//     M 1024 as at 4096; 8 warps; 64-byte K stages in a 4-slot cp.async ring;
//     ldmatrix operands; mma.sync m16n8k32). The codes are K-major and 16-byte aligned by
//     construction. w8 stays [K, N] (the checkpoint layout), N-major, but the B fragment
//     wants 4 consecutive k of one column: each w8 tile lands as it is stored, in an XOR-
//     swizzled slot, and the block transposes it once into a padded K-major tile (4 x 4
//     byte blocks, byte permutes, conflict-free stores) before its products; so each w8
//     tile is transposed once per row tile of 64 or 128 rows, not per 64-row block and
//     column block. The epilogue rescales in the TPU kernel's association, (acc * xs) *
//     ws, with IEEE multiplies and xs and ws for the block staged once, stages the output
//     tile in shared memory and stores it with 16-byte stores.
// Ragged M, N and K are masked; zero-filled K tails add exact zeros. Every step is exactly
// rounded and in the plain version's order, so the kernel is bit-exact against it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using gemm_tile::kKBytes;
using gemm_tile::kRowStride;
using gemm_tile::kThreads;
constexpr int kStages = 4;

struct Params {
  const void* x;    // [M, K]
  const int8_t* w;  // [K, N]
  const float* ws;  // [N]
  float* xs;        // [M]
  int8_t* xq;       // [M, Kp] codes, zero past K
  void* out;        // [M, N]
  int M, K, N, Kp;
  int vec_x;        // x rows 16-byte aligned
  int vec_w;        // w8 16-byte aligned, N % 16 == 0
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quantize(float v, float scale) {
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

// ---------------------------------------------------------------------------------------
// 1. row scales and codes
// ---------------------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(256) quantize_rows_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);  // elements of one 16-byte load
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= p.M) return;
  const T* r = static_cast<const T*>(p.x) + (size_t)row * p.K;
  const bool vec = p.vec_x != 0;
  float m = 0.f;
  if (vec) {
    for (int k = lane * kVec; k < p.K; k += 32 * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(r + k);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) m = fmaxf(m, fabsf(to_float(e[j])));
    }
  } else {
    for (int k = lane; k < p.K; k += 32) m = fmaxf(m, fabsf(to_float(r[k])));
  }
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float sc = fmaxf(__fdiv_rn(m, 127.f), 1e-12f);
  if (lane == 0) p.xs[row] = sc;

  int8_t* q = p.xq + (size_t)row * p.Kp;
  if (vec) {
    for (int k = lane * kVec; k < p.K; k += 32 * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(r + k);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint32_t word[kVec / 4];
#pragma unroll
      for (int j = 0; j < kVec / 4; ++j) word[j] = 0u;
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        word[j / 4] |= (uint32_t)(quantize(to_float(e[j]), sc) & 0xff) << (8 * (j % 4));
      if constexpr (kVec == 8)
        *reinterpret_cast<uint2*>(q + k) = make_uint2(word[0], word[1]);
      else
        *reinterpret_cast<uint32_t*>(q + k) = word[0];
    }
  } else {
    for (int k = lane; k < p.K; k += 32) q[k] = (int8_t)quantize(to_float(r[k]), sc);
  }
  for (int k = p.K + lane; k < p.Kp; k += 32) q[k] = 0;
}

// ---------------------------------------------------------------------------------------
// 2. the s8 product and the rescale, on the gemm_tile core
// ---------------------------------------------------------------------------------------

template <class T, typename E>
struct Smem {
  static constexpr int kRaw = kKBytes * T::BN;  // one w8 tile as stored, [64 k][BN n]
  static constexpr int kStage = T::kABytes + kRaw;
  static constexpr int kRing = kStages * kStage;
  static constexpr int kCStride = T::BN * (int)sizeof(E) + 16;  // staged output row
  static constexpr int kC = T::BM * kCStride;
  static constexpr int kMain = kRing > kC ? kRing : kC;  // the staging reuses the ring
  static constexpr int kBytes = kMain + T::kBBytes + (T::BM + T::BN) * 4;
};

// Rows kb0 .. kb0 + 63 of w8 (row stride N bytes), bytes n0 .. n0 + BN - 1, into a
// [64][BN] slot; 16-byte chunk c of row r lands at chunk c ^ ((r / 4) % (BN / 16)), so the
// transpose's reads of four rows spread over the banks.
template <int BN>
__device__ __forceinline__ void load_w_raw(uint8_t* dst, const int8_t* w, int K, int N,
                                           int kb0, int n0, bool vec, int tid) {
  constexpr int kChunks = BN / 16;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(w);
#pragma unroll
  for (int i = tid; i < kKBytes * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int k = kb0 + r, n = n0 + c * 16;
    const bool live = k < K && n < N;
    gemm_tile::load_chunk(dst + r * BN + ((c ^ ((r >> 2) & (kChunks - 1))) * 16),
                          live ? src + (size_t)k * N + n : src, live ? N - n : 0, vec);
  }
}

// The landed [64 k][BN n] w8 slot into the K-major B tile [BN n][kRowStride]: a thread
// reads a 4 x 4 byte block (4 k rows of 4 columns) and stores its 4 columns as 4 words
// of 4 consecutive k. Lanes take 16 k blocks of 2 column blocks: the stores hit 32
// distinct banks, the swizzled reads 16.
template <int BN>
__device__ __forceinline__ void transpose_w(uint8_t* sBt, const uint8_t* raw, int tid) {
  constexpr int kChunks = BN / 16;
#pragma unroll
  for (int i = tid; i < 4 * BN; i += kThreads) {
    const int kb = i & 15, nb = i >> 4;
    const uint8_t* base = raw + (((nb >> 2) ^ (kb & (kChunks - 1))) * 16) + (nb & 3) * 4;
    uint32_t r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) r[j] = *reinterpret_cast<const uint32_t*>(base + (4 * kb + j) * BN);
    // column nb * 4 + j is byte j of r[0..3]
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    uint8_t* dst = sBt + (4 * nb) * kRowStride + 4 * kb;
    *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + kRowStride) = __byte_perm(t0, t1, 0x7632);
    *reinterpret_cast<uint32_t*>(dst + 2 * kRowStride) = __byte_perm(t2, t3, 0x5410);
    *reinterpret_cast<uint32_t*>(dst + 3 * kRowStride) = __byte_perm(t2, t3, 0x7632);
  }
}

__device__ __forceinline__ void store_pair(uint8_t* dst, float v0, float v1, float*) {
  *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
}
__device__ __forceinline__ void store_pair(uint8_t* dst, float v0, float v1, __nv_bfloat16*) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
}

template <class T, typename E, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks) int8_gemm_kernel(const Params p) {
  using S = Smem<T, E>;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sBt = smem + S::kMain;
  float* sXs = reinterpret_cast<float*>(sBt + T::kBBytes);
  float* sWs = sXs + T::BM;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  const int n_k = (p.Kp + kKBytes - 1) / kKBytes;

  for (int i = tid; i < T::BM; i += kThreads) sXs[i] = m0 + i < p.M ? p.xs[m0 + i] : 1.f;
  for (int i = tid; i < T::BN; i += kThreads) sWs[i] = n0 + i < p.N ? p.ws[n0 + i] : 0.f;

  auto load = [&](int it) {
    uint8_t* slot = smem + (it % kStages) * S::kStage;
    gemm_tile::load_kmajor<T::BM>(slot, reinterpret_cast<const uint8_t*>(p.xq), p.Kp, m0,
                                  p.M, it * kKBytes, p.Kp, true, tid);
    load_w_raw<T::BN>(slot + T::kABytes, p.w, p.K, p.N, it * kKBytes, n0, p.vec_w != 0, tid);
  };

  int acc[T::MI][T::NI][4];
  gemm_tile::zero_acc<T>(acc);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_k) load(s);
    gemm_tile::cp_commit();
  }
  for (int it = 0; it < n_k; ++it) {
    gemm_tile::cp_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for all; every warp is done with sBt and the
                      // slot refilled below
    if (it + kStages - 1 < n_k) load(it + kStages - 1);
    gemm_tile::cp_commit();
    const uint8_t* slot = smem + (it % kStages) * S::kStage;
    transpose_w<T::BN>(sBt, slot + T::kABytes, tid);
    __syncthreads();
    gemm_tile::warp_mma<T, gemm_tile::MmaS8>(acc, slot, sBt, wm, wn, lane);
  }
  gemm_tile::cp_wait<0>();
  __syncthreads();  // the ring is free for the staged output

  uint8_t* sC = smem;
#pragma unroll
  for (int mi = 0; mi < T::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = gemm_tile::acc_row<T>(wm, lane, mi, h);
        const int c = gemm_tile::acc_col<T>(wn, lane, ni, 0);
        const float xs = sXs[r];
        const float v0 = __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h]), xs), sWs[c]);
        const float v1 =
            __fmul_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * h + 1]), xs), sWs[c + 1]);
        store_pair(sC + r * S::kCStride + c * sizeof(E), v0, v1, static_cast<E*>(nullptr));
      }
  __syncthreads();
  E* out = static_cast<E*>(p.out);
  const bool vec_out = (p.N * sizeof(E)) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  gemm_tile::store_tile<T::BM, T::BN>(out, sC, S::kCStride, p.N, m0, p.M, n0, p.N, vec_out, tid);
}

template <class T, typename E, int kMinBlocks>
cudaError_t launch_gemm(const Params& p, cudaStream_t st) {
  static bool ready = false;  // one attribute call per instantiation and process
  auto kernel = int8_gemm_kernel<T, E, kMinBlocks>;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<T, E>::kBytes);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((p.N + T::BN - 1) / T::BN, (p.M + T::BM - 1) / T::BM);
  kernel<<<grid, kThreads, Smem<T, E>::kBytes, st>>>(p);
  return cudaGetLastError();
}

// tile 0: 128 x 128 (warps 64 x 32); 1: 64 x 64 (32 x 16); two blocks an SM
template <typename E>
cudaError_t launch(const Params& p, int tile, cudaStream_t st) {
  quantize_rows_kernel<E><<<(p.M + 7) / 8, 256, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (tile == 0) return launch_gemm<gemm_tile::Tile<128, 128, 2>, E, 2>(p, st);
  return launch_gemm<gemm_tile::Tile<64, 64, 2>, E, 2>(p, st);
}

}  // namespace

// x [M, K] in dtype (0 = float32, 1 = bfloat16), w8 [K, N] int8, wscale [N] f32, out [M, N]
// in dtype, xs [M] f32 (written: the row scales), xq [M, Kp] int8 (written: the codes, zero
// past K; Kp = K rounded up to 16). vec_x: x 16-byte aligned and K * sizeof(dtype) % 16 ==
// 0; vec_w: w8 16-byte aligned and N % 16 == 0. tile: the product's tile (see launch).
// Returns a cudaError_t (0 = launched).
extern "C" int int8_matmul(const void* x, const void* w8, const void* wscale, void* out,
                           void* xs, void* xq, int M, int K, int N, int Kp, int dtype,
                           int vec_x, int vec_w, int tile, void* stream) {
  const int bm = tile == 0 ? 128 : 64;
  if (M <= 0 || K <= 0 || N <= 0 || Kp % 16 != 0 || Kp < K || Kp >= K + 16 || tile < 0 ||
      tile > 1 || (M + bm - 1) / bm > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Params p;
  p.x = x, p.w = static_cast<const int8_t*>(w8), p.ws = static_cast<const float*>(wscale);
  p.xs = static_cast<float*>(xs), p.xq = static_cast<int8_t*>(xq), p.out = out;
  p.M = M, p.K = K, p.N = N, p.Kp = Kp, p.vec_x = vec_x, p.vec_w = vec_w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, tile, st);
  return launch<float>(p, tile, st);
}
