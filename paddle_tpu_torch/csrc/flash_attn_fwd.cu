// Flash-attention forward for Hopper (sm_90a):
// O = dropout(softmax(Q K^T * scale + bias [, causal])) V, and optionally the row LSE.
//
// Replaces: paddle_tpu/ops/pallas_attention.py::_flash_fwd_impl / _fwd_kernel (with _probs),
// the TPU Pallas kernel of the fused_attention op.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the kernel reads Q, K, V and
// writes O once, 4*B*H*S*D elements, and does 4*B*H*S^2*D FLOPs. For BERT-base serving
// (H 12, D 64, bf16) that is 2 FLOPs per byte at S 128 and 8 at S 512, far below the
// ~295 FLOPs per byte where the tensor cores become the limit, so it is memory-bound:
// at B 8 the bound is about 1.9 us (S 128) and 7.5 us (S 512).
//
// What the design does about that bound: it never writes the [S, S] scores or probabilities
// to device memory (the composed version moves 4*B*H*S^2 bytes of f32 scores). Each thread
// block owns one (batch*head, 64-row Q tile), keeps Q in registers, and walks 64-row K/V
// tiles staged in shared memory with an online softmax (running max and sum in f32), so
// each K/V element is read from device memory once per Q tile and O is written once.
// Where the TPU kernel stages whole K/V rows in VMEM, this one streams tiles, so shared
// memory stays at ~28 KB at any S. The bf16 path runs Q K^T and P V on the tensor cores
// (mma.sync m16n8k16, f32 accumulation); P is rounded to bf16 before P V, as the TPU kernel
// rounds P to V's dtype. The f32 path uses full-precision f32 FMAs (no TF32), one query row
// per thread. Not done yet: cp.async/TMA prefetch of the next tile, wgmma, warp
// specialisation; the tile loads are synchronous.
//
// Layout: q/k/v are [B, H, S, D] with D contiguous and any batch/head/row strides (the
// port's attention inputs are transposed views); bias is a contiguous [B, 1, 1, S] row in
// the input dtype, widened to f32 before it is added; o is a contiguous [B, H, S, D].
// Masking uses -1e30 for causal, as the TPU kernel does, and -inf for key positions past S
// (a ragged last tile).
//
// Training adds two optional parts, both off for serving (lse == nullptr, dropout == 0), so
// the serving launches do exactly the work they did before:
//  * lse [B, H, S] f32: m + log(l) of each row (row max and sum of the undropped
//    probabilities), which the backward kernels (flash_attn_bwd.cu) use to recompute P;
//  * attention dropout p with a 64-bit seed: the keep mask comes from Philox4x32-10 inside
//    the kernel (philox.cuh), kept probabilities are scaled by 1/(1-p) before P V, and the
//    row sum l is taken over the undropped probabilities, as the TPU kernel's `pd` is
//    (pallas_attention.py:114-116, :133).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using flash_philox::dropout_bits4;
using flash_philox::word;

constexpr float kCausalMask = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;  // nullptr when there is no bias
  void* o;
  float* lse;        // nullptr: not written
  long long q_sb, q_sh, q_ss;  // element strides of batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int H, S;
  float scale;
  int causal;
  float dropout;     // 0: no dropout
  float keep_scale;  // 1 / (1 - dropout)
  uint32_t threshold;  // uint32(dropout * 2^32): kept when bits >= threshold
  unsigned long long seed;
};

// ---------------------------------------------------------------------------------------
// bf16: tensor-core path
// ---------------------------------------------------------------------------------------

constexpr int kBM = 64;   // query rows per block (4 warps x 16 rows)
constexpr int kBN = 64;   // keys per staged K/V tile
constexpr int kBf16Threads = 128;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

template <int D>
__global__ void __launch_bounds__(kBf16Threads)
    flash_fwd_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0, "head width must be a multiple of 16");
  constexpr int kStride = D + 8;  // padded smem row: fragment reads hit 32 distinct banks
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) __nv_bfloat16 sQ[kBM * kStride];
  __shared__ __align__(16) __nv_bfloat16 sK[kBN * kStride];
  __shared__ __align__(16) __nv_bfloat16 sV[kBN * kStride];
  __shared__ float sBias[kBN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int q0 = blockIdx.x * kBM;

  const __nv_bfloat16* qb =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* bias_row =
      p.bias ? static_cast<const __nv_bfloat16*>(p.bias) + (long long)b * S : nullptr;
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + (long long)bh * S * D;

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < kBM * kChunks; i += kBf16Threads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = zero;
    if (q0 + r < S) val = *reinterpret_cast<const uint4*>(qb + (q0 + r) * p.q_ss + c);
    *reinterpret_cast<uint4*>(&sQ[r * kStride + c]) = val;
  }
  __syncthreads();

  // A fragments of this warp's 16 query rows, kept in registers for every K tile
  const int wr = warp * 16;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const __nv_bfloat16* r0 = &sQ[(wr + g) * kStride + kk * 16 + t * 2];
    const __nv_bfloat16* r1 = r0 + 8 * kStride;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's share of the row sums
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  int n_tiles = (S + kBN - 1) / kBN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBM - 1) / kBN + 1);
  const uint16_t* sVu = reinterpret_cast<const uint16_t*>(sV);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBN * kChunks; i += kBf16Threads) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      uint4 kv = zero, vv = zero;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const uint4*>(kb + (k0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + (k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&sK[r * kStride + c]) = kv;
      *reinterpret_cast<uint4*>(&sV[r * kStride + c]) = vv;
    }
    if (tid < kBN) {
      const int key = k0 + tid;
      sBias[tid] = key >= S ? -INFINITY : (bias_row ? __bfloat162float(bias_row[key]) : 0.f);
    }
    __syncthreads();

    // scores for 16 rows x 64 keys: s[j] is the 16x8 tile of keys j*8 .. j*8+7
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = &sK[(j * 8 + g) * kStride + kk * 16 + t * 2];
        mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        float x = s[j][e] * p.scale + sBias[col];
        if (p.causal && k0 + col > row[e >> 1]) x = kCausalMask;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = __expf(m_run[r] - m_use[r]);
      m_run[r] = m_new;
      l_run[r] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[j][2 * r] *= alpha;
        acc[j][2 * r + 1] *= alpha;
      }
    }

    // P = exp(S - m), rounded to bf16 straight into the A fragments of P V. With dropout,
    // the sum l takes the undropped P and P V the dropped, rescaled one. This thread's two
    // key columns (2t, 2t+1 of each 8-column tile) share one group of four, so one Philox
    // call per row and tile gives both.
    uint32_t pa[kBN / 16][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float p0 = __expf(s[j][0] - m_use[0]);
      const float p1 = __expf(s[j][1] - m_use[0]);
      const float p2 = __expf(s[j][2] - m_use[1]);
      const float p3 = __expf(s[j][3] - m_use[1]);
      l_run[0] += p0 + p1;
      l_run[1] += p2 + p3;
      float f0 = 1.f, f1 = 1.f, f2 = 1.f, f3 = 1.f;
      if (p.dropout > 0.f) {
        const uint32_t col4 = uint32_t(k0 + j * 8 + t * 2) >> 2;
        const int w = (t & 1) * 2;
        const uint4 r0 = dropout_bits4(p.seed, bh, row[0], col4);
        const uint4 r1 = dropout_bits4(p.seed, bh, row[1], col4);
        f0 = word(r0, w) >= p.threshold ? p.keep_scale : 0.f;
        f1 = word(r0, w + 1) >= p.threshold ? p.keep_scale : 0.f;
        f2 = word(r1, w) >= p.threshold ? p.keep_scale : 0.f;
        f3 = word(r1, w + 1) >= p.threshold ? p.keep_scale : 0.f;
      }
      pa[j / 2][(j & 1) * 2] = pack_bf16(p0 * f0, p1 * f1);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p2 * f2, p3 * f3);
    }

    // O += P V: B fragment element (key, d) = V[key][d], two keys per 32-bit register
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const int key = kk * 16 + t * 2;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int d = j * 8 + g;
        const uint32_t b0 = sVu[key * kStride + d] | (uint32_t(sVu[(key + 1) * kStride + d]) << 16);
        const uint32_t b1 =
            sVu[(key + 8) * kStride + d] | (uint32_t(sVu[(key + 9) * kStride + d]) << 16);
        mma_bf16(acc[j], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
    if (row[r] >= S) continue;
    if (p.lse && t == 0) p.lse[(long long)bh * S + row[r]] = m_run[r] + logf(l_run[r]);
    const float inv = 1.f / l_run[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(&ob[(long long)row[r] * D + j * 8 + t * 2]) =
          pack_bf16(acc[j][2 * r] * inv, acc[j][2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------------------
// f32: full-precision FMA path, one query row per thread
// ---------------------------------------------------------------------------------------

constexpr int kF32Rows = 64;  // query rows (threads) per block
constexpr int kF32Keys = 32;  // keys per staged K/V tile

template <int D>
__global__ void __launch_bounds__(kF32Rows) flash_fwd_f32_kernel(const Params p) {
  static_assert(D % 4 == 0, "head width must be a multiple of 4");
  __shared__ __align__(16) float sK[kF32Keys * D];
  __shared__ __align__(16) float sV[kF32Keys * D];
  __shared__ float sBias[kF32Keys];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int q_first = blockIdx.x * kF32Rows;
  const int row = q_first + tid;
  const bool valid = row < S;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* bias_row = p.bias ? static_cast<const float*>(p.bias) + (long long)b * S : nullptr;
  float* ob = static_cast<float*>(p.o) + (long long)bh * S * D;

  float qr[D], acc[D];
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    float4 x = valid ? *reinterpret_cast<const float4*>(qb + row * p.q_ss + d)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = x.x, qr[d + 1] = x.y, qr[d + 2] = x.z, qr[d + 3] = x.w;
    acc[d] = acc[d + 1] = acc[d + 2] = acc[d + 3] = 0.f;
  }
  float m_run = -INFINITY, l_run = 0.f;

  int n_tiles = (S + kF32Keys - 1) / kF32Keys;
  if (p.causal) n_tiles = min(n_tiles, (q_first + kF32Rows - 1) / kF32Keys + 1);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Keys;
    __syncthreads();
    for (int i = tid; i < kF32Keys * D / 4; i += kF32Rows) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kv = zero, vv = zero;
      if (k0 + r < S) {
        kv = *reinterpret_cast<const float4*>(kb + (k0 + r) * p.k_ss + c);
        vv = *reinterpret_cast<const float4*>(vb + (k0 + r) * p.v_ss + c);
      }
      *reinterpret_cast<float4*>(&sK[r * D + c]) = kv;
      *reinterpret_cast<float4*>(&sV[r * D + c]) = vv;
    }
    if (tid < kF32Keys) {
      const int key = k0 + tid;
      sBias[tid] = key >= S ? -INFINITY : (bias_row ? bias_row[key] : 0.f);
    }
    __syncthreads();

    float s[kF32Keys];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], sK[j * D + d], dot);
      float x = dot * p.scale + sBias[j];
      if (p.causal && k0 + j > row) x = kCausalMask;
      s[j] = x;
      mx = fmaxf(mx, x);
    }
    const float m_new = fmaxf(m_run, mx);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = expf(m_run - m_use);
    m_run = m_new;
    l_run *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
    uint4 bits = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < kF32Keys; ++j) {
      float pj = expf(s[j] - m_use);
      l_run += pj;
      if (p.dropout > 0.f) {
        if ((j & 3) == 0) bits = dropout_bits4(p.seed, bh, row, uint32_t(k0 + j) >> 2);
        pj = word(bits, j & 3) >= p.threshold ? pj * p.keep_scale : 0.f;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(pj, sV[j * D + d], acc[d]);
    }
  }

  if (!valid) return;
  if (p.lse) p.lse[(long long)bh * S + row] = m_run + logf(l_run);
  const float inv = 1.f / l_run;
#pragma unroll
  for (int d = 0; d < D; d += 4) {
    *reinterpret_cast<float4*>(&ob[(long long)row * D + d]) =
        make_float4(acc[d] * inv, acc[d + 1] * inv, acc[d + 2] * inv, acc[d + 3] * inv);
  }
}

template <int D>
cudaError_t launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  const int bh = B * p.H;
  if (dtype == 1) {
    dim3 grid((p.S + kBM - 1) / kBM, bh);
    flash_fwd_bf16_kernel<D><<<grid, kBf16Threads, 0, stream>>>(p);
  } else {
    dim3 grid((p.S + kF32Rows - 1) / kF32Rows, bh);
    flash_fwd_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null (not written). dropout in [0, 1);
// threshold = uint32(dropout * 2^32). Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* o, void* lse, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss, int B, int H,
                              int S, int D, float scale, int causal, int has_bias, int dtype,
                              float dropout, unsigned int threshold,
                              unsigned long long seed, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535 || (dtype != 0 && dtype != 1) ||
      !(dropout >= 0.f && dropout < 1.f))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q, p.k = k, p.v = v, p.bias = has_bias ? bias : nullptr, p.o = o;
  p.lse = static_cast<float*>(lse);
  p.dropout = dropout, p.keep_scale = 1.f / (1.f - dropout), p.threshold = threshold;
  p.seed = seed;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.H = H, p.S = S, p.scale = scale, p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, B, dtype, st);
    case 64: return launch<64>(p, B, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}
