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
// the bytes take longer than the operations: 2.4-10 us.
//
// What the design does: two launches. A row pass computes xs (one warp per row; max is
// exact in any order, and the division by 127 is IEEE), as the TPU path computes xs outside
// its kernel. The main kernel gives each block a 64 x 128 output tile; it streams x in
// 64 x 64 tiles (the next tiles' loads in flight in registers while the current ones are
// multiplied), quantizes each tile once into shared memory as int8 on its way in (IEEE
// division __fdiv_rn and __float2int_rn, round half to even, never a reciprocal multiply,
// which would move codes), stages the matching 64 x 128 int8 tile of w8, and runs
// mma.sync m16n8k32 s8 x s8 -> s32. w8 is stored [K, N] row-major (the checkpoint format),
// but the B fragment wants 4 consecutive k of one column in a register: each thread reads
// a 4 x 4 byte block (4 rows of 4 columns), transposes it with byte permutes (prmt) and
// stores it k-contiguous, so shared memory holds w8^T. The epilogue rescales in the TPU
// kernel's association, (acc * xs) * ws, with IEEE multiplies. Ragged M, N and K are masked;
// zero-filled K tails add exact zeros. Every step is exactly rounded and in the plain
// version's order, so the kernel is bit-exact against it. Not done yet: cp.async/TMA,
// wgmma, quantizing each x tile once for all column tiles (here every column block
// re-quantizes its rows), vector stores of the output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64, kBN = 128, kBK = 64;
constexpr int kStride = kBK + 16;  // padded smem row (80 bytes): fragment reads hit 32 banks
constexpr int kThreads = 256;      // 8 warps as 2 x 4, each a 32 x 32 sub-tile

struct Params {
  const void* x;       // [M, K]
  const int8_t* w;     // [K, N]
  const float* ws;     // [N]
  const float* xs;     // [M]
  void* out;           // [M, N]
  int8_t* xq;          // [M, K] codes, written by the first column block; may be null
  int M, K, N;
  int vec_x;           // x rows 16-byte aligned, K % 4 == 0
  int vec_w;           // w 4-byte aligned, N % 4 == 0
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The raw bits of 4 consecutive elements of x (8 bytes of bf16, 16 of f32): loaded with
// one vector load where aligned and whole, else element by element with zeros past n.
template <typename T>
struct Raw4;

template <>
struct Raw4<__nv_bfloat16> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* src, int n, int vec) {
    if (vec && n == 4) {
      v = *reinterpret_cast<const uint2*>(src);
      return;
    }
    uint32_t b[4] = {0u, 0u, 0u, 0u};  // bf16 zero is all-zero bits
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) b[j] = __bfloat16_as_ushort(src[j]);
    v = make_uint2(b[0] | (b[1] << 16), b[2] | (b[3] << 16));
  }
  __device__ __forceinline__ void to_float(float (&f)[4]) const {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
    f[0] = lo.x, f[1] = lo.y, f[2] = hi.x, f[3] = hi.y;
  }
};

template <>
struct Raw4<float> {
  float4 v;
  __device__ __forceinline__ void load(const float* src, int n, int vec) {
    if (vec && n == 4) {
      v = *reinterpret_cast<const float4*>(src);
      return;
    }
    v = make_float4(n > 0 ? src[0] : 0.f, n > 1 ? src[1] : 0.f, n > 2 ? src[2] : 0.f,
                    n > 3 ? src[3] : 0.f);
  }
  __device__ __forceinline__ void to_float(float (&f)[4]) const {
    f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
  }
};

template <typename T>
__global__ void __launch_bounds__(256) row_scale_kernel(const T* x, float* xs, int M, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* r = x + (size_t)row * K;
  float m = 0.f;
  for (int k = lane; k < K; k += 32) m = fmaxf(m, fabsf(to_float(r[k])));
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) xs[row] = fmaxf(__fdiv_rn(m, 127.f), 1e-12f);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int quantize(float v, float scale) {
  const int q = __float2int_rn(__fdiv_rn(v, scale));
  return q < -127 ? -127 : (q > 127 ? 127 : q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) int8_matmul_kernel(const Params p) {
  __shared__ __align__(16) int8_t sA[kBM * kStride];  // codes, row-major, k contiguous
  __shared__ __align__(16) int8_t sB[kBN * kStride];  // w8^T: column n, k contiguous
  __shared__ float sXs[kBM];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const T* x = static_cast<const T*>(p.x);
  const bool write_codes = p.xq != nullptr && blockIdx.x == 0;

  for (int i = tid; i < kBM; i += kThreads) sXs[i] = m0 + i < p.M ? p.xs[m0 + i] : 1.f;

  // every loop over acc is unrolled, so acc stays in registers
  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  // The next tiles are loaded into registers while the current ones are multiplied:
  // item i of A is 4 consecutive k of one row, item i of B a 4 x 4 byte block.
  constexpr int kAItems = kBM * kBK / 4 / kThreads;          // 4
  constexpr int kBItems = (kBK / 4) * (kBN / 4) / kThreads;  // 2
  Raw4<T> ra[kAItems];
  uint32_t rb[kBItems][4];
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kAItems; ++i) {
      const int it = tid + i * kThreads;
      const int gm = m0 + it / (kBK / 4), gk = k0 + (it % (kBK / 4)) * 4;
      const int n = gm < p.M ? min(4, p.K - gk) : 0;
      ra[i].load(x + (size_t)gm * p.K + gk, n, p.vec_x);
    }
#pragma unroll
    for (int i = 0; i < kBItems; ++i) {
      const int it = tid + i * kThreads;
      const int gk0 = k0 + (it / (kBN / 4)) * 4, gn = n0 + (it % (kBN / 4)) * 4;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int gk = gk0 + r;
        uint32_t word = 0u;
        if (gk < p.K) {
          const int8_t* src = p.w + (size_t)gk * p.N + gn;
          if (p.vec_w && gn + 3 < p.N) {
            word = *reinterpret_cast<const uint32_t*>(src);
          } else {
            for (int j = 0; j < 4; ++j)
              if (gn + j < p.N) word |= (uint32_t)(uint8_t)src[j] << (8 * j);
          }
        }
        rb[i][r] = word;
      }
    }
  };

  load_tiles(0);
  __syncthreads();  // sXs written
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    // A: quantize the staged 64 x 64 tile, 4 codes to one 32-bit word
#pragma unroll
    for (int i = 0; i < kAItems; ++i) {
      const int it = tid + i * kThreads;
      const int r = it / (kBK / 4), c = (it % (kBK / 4)) * 4;
      const int gm = m0 + r, gk = k0 + c;
      float v[4];
      ra[i].to_float(v);
      const float sc = sXs[r];
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = quantize(v[j], sc);
        word |= (uint32_t)(q & 0xff) << (8 * j);
        if (write_codes && gm < p.M && gk + j < p.K)
          p.xq[(size_t)gm * p.K + gk + j] = (int8_t)q;
      }
      *reinterpret_cast<uint32_t*>(&sA[r * kStride + c]) = word;
    }
    // B: each staged 4 x 4 byte block transposed into sB[n][k]
#pragma unroll
    for (int i = 0; i < kBItems; ++i) {
      const int it = tid + i * kThreads;
      const int kb = (it / (kBN / 4)) * 4, nb = (it % (kBN / 4)) * 4;
      const uint32_t* r = rb[i];
      // out[j] = byte j of r[0..3]: four consecutive k of column nb + j
      const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.b0 r1.b0 r0.b1 r1.b1
      const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
      const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);  // r0.b2 r1.b2 r0.b3 r1.b3
      const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
      *reinterpret_cast<uint32_t*>(&sB[(nb + 0) * kStride + kb]) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(&sB[(nb + 1) * kStride + kb]) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(&sB[(nb + 2) * kStride + kb]) = __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(&sB[(nb + 3) * kStride + kb]) = __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();
    if (k0 + kBK < p.K) load_tiles(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int8_t* base = &sA[(wm * 32 + mi * 16 + g) * kStride + kk + t * 4];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* base = &sB[(wn * 32 + ni * 8 + g) * kStride + kk + t * 4];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 16);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();  // the tiles consumed before the next ones are stored
  }

  T* out = static_cast<T*>(p.out);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = wm * 32 + mi * 16 + g + h * 8;
        const int row = m0 + lr;
        const float xs = sXs[lr];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = n0 + wn * 32 + ni * 8 + t * 2 + j;
          if (row < p.M && col < p.N) {
            const float v = __fmul_rn(
                __fmul_rn(__int2float_rn(acc[mi][ni][2 * h + j]), xs), p.ws[col]);
            store(out + (size_t)row * p.N + col, v);
          }
        }
      }
}

template <typename T>
cudaError_t launch(const Params& p, float* xs, cudaStream_t st) {
  row_scale_kernel<T><<<(p.M + 7) / 8, 256, 0, st>>>(static_cast<const T*>(p.x), xs, p.M,
                                                      p.K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + kBM - 1) / kBM);
  int8_matmul_kernel<T><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x [M, K] in dtype (0 = float32, 1 = bfloat16), w8 [K, N] int8, wscale [N] f32, out [M, N]
// in dtype, xs [M] f32 (written: the row scales), xq [M, K] int8 (written when not null: the
// codes). vec_x: x 16-byte aligned and K % 4 == 0; vec_w: w8 4-byte aligned and N % 4 == 0.
// Returns a cudaError_t (0 = launched).
extern "C" int int8_matmul(const void* x, const void* w8, const void* wscale, void* out,
                           void* xs, void* xq, int M, int K, int N, int dtype, int vec_x,
                           int vec_w, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || (M + kBM - 1) / kBM > 65535 ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Params p;
  p.x = x, p.w = static_cast<const int8_t*>(w8), p.ws = static_cast<const float*>(wscale);
  p.xs = static_cast<const float*>(xs), p.out = out, p.xq = static_cast<int8_t*>(xq);
  p.M = M, p.K = K, p.N = N, p.vec_x = vec_x, p.vec_w = vec_w;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(p, static_cast<float*>(xs), st);
  return launch<float>(p, static_cast<float*>(xs), st);
}
