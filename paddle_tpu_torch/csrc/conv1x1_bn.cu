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
// what matters is that y is written once and never read back for the statistics.
//
// What the design does about that: each block owns a 64 x 64 output tile and loops over K
// in 32-wide tiles staged in shared memory, the next tiles' loads in flight in registers
// while the current ones are multiplied. The prologue (off on the op's path) is applied
// to each x tile on its way into shared memory, in f32 with IEEE operations in the TPU
// kernel's order, then rounded to bf16. bf16 runs mma.sync m16n8k16 with f32 accumulation;
// f32 runs full-precision f32 FMAs (no TF32). The epilogue rounds the accumulator to x's
// dtype, stores y, and sums the rounded values and their squares per column over the
// block's rows (warp shuffles, then the two row-warps in a fixed order). The TPU kernel
// carries the statistics across a sequential M grid; blocks here run in any order, so each
// block writes its column partials to an f32 scratch [2, M tiles, N] and a second kernel
// sums them per column in a fixed order: the result is deterministic, with no atomics.
// The filter is W^T = [N, K] row-major (the OIHW 1x1 filter as stored), which is already
// the "col" B operand of the mma: no transpose. Not done yet: cp.async/TMA, wgmma, a
// larger tile, vector stores of y.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // output rows per block
constexpr int kBN = 64;  // output columns per block

struct Params {
  const void* x;     // [M, K]
  const void* w;     // [N, K] (W transposed, k contiguous)
  const float* mu;   // [K] prologue: mean, rsqrt(var + eps), gamma, beta
  const float* inv;
  const float* g;
  const float* b;
  void* y;           // [M, N]
  float* part;       // [2, M tiles, N]: per-tile column sums, then sums of squares
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
// bf16: tensor-core path, 4 warps as 2 x 2, each a 32 x 32 sub-tile
// ---------------------------------------------------------------------------------------

constexpr int kBK = 32;
constexpr int kStride = kBK + 8;  // padded smem row (80 bytes): fragment reads hit 32 banks
constexpr int kBf16Threads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The column partials of one block: per thread 4 n8 tiles x 2 columns, summed over its
// rows, reduced over the 8 row groups of the warp, then over the two row-warps.
__device__ __forceinline__ void store_partials(float (&cs)[4][2], float (&css)[4][2],
                                               float (*red)[kBN], const Params& p, int wm,
                                               int wn, int lane) {
  for (int ni = 0; ni < 4; ++ni)
    for (int j = 0; j < 2; ++j)
      for (int off = 4; off < 32; off <<= 1) {
        cs[ni][j] += __shfl_xor_sync(0xffffffffu, cs[ni][j], off);
        css[ni][j] += __shfl_xor_sync(0xffffffffu, css[ni][j], off);
      }
  if (lane < 4) {
    for (int ni = 0; ni < 4; ++ni)
      for (int j = 0; j < 2; ++j) {
        const int c = wn * 32 + ni * 8 + lane * 2 + j;
        red[wm][c] = cs[ni][j];
        red[2 + wm][c] = css[ni][j];
      }
  }
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid < kBN) {
    const int col = blockIdx.x * kBN + tid;
    if (col < p.N) {
      const size_t tiles = gridDim.y;
      p.part[blockIdx.y * (size_t)p.N + col] = red[0][tid] + red[1][tid];
      p.part[(tiles + blockIdx.y) * (size_t)p.N + col] = red[2][tid] + red[3][tid];
    }
  }
}

__global__ void __launch_bounds__(kBf16Threads) conv1x1_bn_bf16_kernel(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 sA[kBM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sB[kBN * kStride];
  __shared__ float red[4][kBN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w);

  float acc[2][4][4];  // every loop over acc is unrolled, so acc stays in registers
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0.f;

  // The next tiles are loaded into registers while the current ones are multiplied:
  // item i is 4 consecutive k of one row of x or of the filter (8 bytes of bf16).
  constexpr int kItems = kBM * kBK / 4 / kBf16Threads;  // 4 each for x and the filter
  static_assert(kBM == kBN, "x and filter tiles share one item layout");
  uint2 ra[kItems], rb[kItems];
  auto load4 = [&](const __nv_bfloat16* src, int n) {
    if (p.vec && n == 4) return *reinterpret_cast<const uint2*>(src);
    uint32_t bits[4] = {0u, 0u, 0u, 0u};  // bf16 zero is all-zero bits
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < n) bits[j] = __bfloat16_as_ushort(src[j]);
    return make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
  };
  auto load_tiles = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int it = tid + i * kBf16Threads;
      const int r = it / (kBK / 4), gk = k0 + (it % (kBK / 4)) * 4;
      const int m = m0 + r, n = n0 + r;
      ra[i] = load4(x + (size_t)m * p.K + gk, m < p.M ? min(4, p.K - gk) : 0);
      rb[i] = load4(w + (size_t)n * p.K + gk, n < p.N ? min(4, p.K - gk) : 0);
    }
  };

  load_tiles(0);
  for (int k0 = 0; k0 < p.K; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int it = tid + i * kBf16Threads;
      const int r = it / (kBK / 4), c = (it % (kBK / 4)) * 4;
      const int gk = k0 + c;
      uint2 z = ra[i];
      if (p.apply_in_bn || p.relu_in) {  // the prologue, in f32, rounded back to bf16
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&ra[i]);
        const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
        float v[4] = {lo.x, lo.y, hi.x, hi.y};
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = (m0 + r < p.M && gk + j < p.K)
                     ? prologue(v[j], gk + j, p.mu, p.inv, p.g, p.b, p.apply_in_bn, p.relu_in)
                     : 0.f;
        __nv_bfloat162 zl = __floats2bfloat162_rn(v[0], v[1]);
        __nv_bfloat162 zh = __floats2bfloat162_rn(v[2], v[3]);
        z = make_uint2(*reinterpret_cast<uint32_t*>(&zl), *reinterpret_cast<uint32_t*>(&zh));
      }
      *reinterpret_cast<uint2*>(&sA[r * kStride + c]) = z;
      *reinterpret_cast<uint2*>(&sB[r * kStride + c]) = rb[i];
    }
    __syncthreads();
    if (k0 + kBK < p.K) load_tiles(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* base = &sA[(wm * 32 + mi * 16 + g) * kStride + kk + t * 2];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(base);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kStride + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* base = &sB[(wn * 32 + ni * 8 + g) * kStride + kk + t * 2];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(base);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(base + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();  // the tiles consumed before the next ones are stored
  }

  // epilogue: round, store, per-column sums of the rounded values over valid rows
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  float cs[4][2], css[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) cs[ni][0] = cs[ni][1] = css[ni][0] = css[ni][1] = 0.f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 32 + mi * 16 + g + h * 8;
        const int col = n0 + wn * 32 + ni * 8 + t * 2;
        const __nv_bfloat16 v0 = __float2bfloat16_rn(acc[mi][ni][2 * h]);
        const __nv_bfloat16 v1 = __float2bfloat16_rn(acc[mi][ni][2 * h + 1]);
        if (row < p.M) {
          const float f0 = __bfloat162float(v0), f1 = __bfloat162float(v1);
          if (col < p.N) {
            y[(size_t)row * p.N + col] = v0;
            cs[ni][0] += f0;
            css[ni][0] += f0 * f0;
          }
          if (col + 1 < p.N) {
            y[(size_t)row * p.N + col + 1] = v1;
            cs[ni][1] += f1;
            css[ni][1] += f1 * f1;
          }
        }
      }
  store_partials(cs, css, red, p, wm, wn, lane);
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
// only when apply_in_bn), y [M, N] in dtype, part an f32 scratch of 2 * ceil(M/64) * N,
// s/ss [N] f32. vec: x and w 16-byte aligned and K % 8 == 0. Returns a cudaError_t (0 =
// launched).
extern "C" int conv1x1_bn(const void* x, const void* w, const void* mu, const void* inv,
                          const void* g, const void* b, void* y, void* part, void* s,
                          void* ss, int M, int K, int N, int dtype, int apply_in_bn,
                          int relu_in, int vec, void* stream) {
  const int tiles = (M + kBM - 1) / kBM;
  if (M <= 0 || K <= 0 || N <= 0 || tiles > 65535 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  Params p;
  p.x = x, p.w = w, p.y = y, p.part = static_cast<float*>(part);
  p.mu = static_cast<const float*>(mu), p.inv = static_cast<const float*>(inv);
  p.g = static_cast<const float*>(g), p.b = static_cast<const float*>(b);
  p.M = M, p.K = K, p.N = N, p.apply_in_bn = apply_in_bn, p.relu_in = relu_in;
  p.vec = vec;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kBN - 1) / kBN, tiles);  // column tiles fastest: x tiles reused in L2
  if (dtype == 1)
    conv1x1_bn_bf16_kernel<<<grid, kBf16Threads, 0, st>>>(p);
  else
    conv1x1_bn_f32_kernel<<<grid, kF32Threads, 0, st>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  column_sums_kernel<<<(N + 31) / 32, dim3(32, 32), 0, st>>>(
      p.part, static_cast<float*>(s), static_cast<float*>(ss), tiles, N);
  return cudaGetLastError();
}
