// Flash-attention backward for Hopper (sm_90a): dQ, dK, dV of
// O = dropout(softmax(Q K^T * scale + bias [, causal])) V, given dO, O and the forward's row LSE.
//
// Replaces: paddle_tpu/ops/pallas_attention.py::_flash_bwd / _bwd_kernel (:139-182, :245-278),
// the TPU Pallas backward of the fused_attention op. The bias gets no gradient (the op's Bias
// input is non-differentiable, as in the JAX package).
//
// What it computes, per (batch, head), with P = exp(S - LSE) the forward's probabilities
// recomputed from the saved LSE and M the forward's dropout mask regenerated from its seed
// (philox.cuh; M/(1-p) on kept entries, 0 on dropped ones):
//   D_i  = rowsum(dO_i * O_i)                       (equals JAX's row = sum_k dp_k p_k)
//   dV   = (P * M)^T dO
//   dP   = (dO V^T) * M
//   dS   = P * (dP - D)
//   dQ   = dS K * scale,   dK = dS^T Q * scale
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): it reads Q, K, V, O, dO and writes
// dQ, dK, dV once (8 B H S D elements, plus LSE and D), and does 10 B H S^2 D FLOPs (S = QK^T,
// dP, dV, dQ, dK; the recompute of S is counted once per kernel). For BERT-base training
// (B 128, H 12, S 128, D 64, bf16) that is ~201 MB, 0.060 ms at 3.35 TB/s against 0.016 ms of
// tensor-core work: memory-bound, like the forward.
//
// Design. The TPU kernel carries dK/dV in one output block across a sequential grid over Q
// blocks. Here blocks run in parallel in no order, so the work is split three ways, with no
// atomics (the result is deterministic):
//   1. a pre-pass writes D (f32, [B, H, S]);
//   2. kernel A, one block per (batch*head, 64-row K/V tile), keeps its K and V fragments in
//      registers, walks the Q/dO tiles through shared memory, and accumulates dK and dV in f32
//      registers; each is written once;
//   3. kernel B, one block per (batch*head, 64-row Q tile), keeps its Q and dO fragments in
//      registers, walks the K/V tiles, and accumulates dQ in f32 registers.
// The [S, S] matrices never reach device memory. S and dP are computed twice (once in A and
// once in B), which costs FLOPs the card has to spare. The bf16 path runs every product on the
// tensor cores (mma.sync m16n8k16, f32 accumulation); P*M and dS are rounded to bf16 as the
// A operands of the dV, dK and dQ products (the TPU kernel keeps them in f32). The f32 path
// uses full-precision FMAs, one row per thread. Kernel A holds S^T (keys as rows), so each of
// its elements needs its own Philox call (four times the generator work of the forward's
// layout); kernel B shares one call between two elements, as the forward does. Not done yet:
// cp.async/TMA prefetch, wgmma, one fused kernel with dQ accumulated across blocks.
//
// Layout: q/k/v are [B, H, S, D] with D contiguous and any batch/head/row strides (the same
// head-split views the forward takes); o, dout, dq, dk, dv are contiguous [B, H, S, D] in the
// input dtype; lse and delta are contiguous [B, H, S] f32; bias is a contiguous [B, 1, 1, S]
// row in the input dtype. Key positions past S (a ragged last tile) get -inf scores; query rows
// past S get LSE = +inf, so their P is 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

using flash_philox::dropout_bits;
using flash_philox::dropout_bits4;
using flash_philox::word;
using bf16 = __nv_bfloat16;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* bias;  // nullptr when there is no bias
  const void* o;
  const void* dout;
  const float* lse;
  float* delta;
  void* dq;
  void* dk;
  void* dv;
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// ---------------------------------------------------------------------------------------
// pre-pass: D = rowsum(dO * O) in f32, one warp per row
// ---------------------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(128) delta_kernel(const Params p, long long rows) {
  const long long r = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const T* o = static_cast<const T*>(p.o) + r * D;
  const T* d_o = static_cast<const T*>(p.dout) + r * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(to_f(o[d]), to_f(d_o[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

// ---------------------------------------------------------------------------------------
// bf16: tensor-core path
// ---------------------------------------------------------------------------------------

constexpr int kBM = 64;  // rows a block owns (4 warps x 16)
constexpr int kBN = 64;  // rows of each staged tile of the other operand
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

// 64 rows of a [rows, D] bf16 matrix (row stride `ss`) into padded shared memory; rows at or
// past `limit` are zero.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long ss, int r0,
                                           int limit, int tid) {
  constexpr int kStride = D + 8, kChunks = D / 8;
  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int i = tid; i < kBN * kChunks; i += kBf16Threads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = zero;
    if (r0 + r < limit) val = *reinterpret_cast<const uint4*>(src + (r0 + r) * ss + c);
    *reinterpret_cast<uint4*>(&dst[r * kStride + c]) = val;
  }
}

// A fragments (m16n8k16 row-major A) of this warp's 16 rows of a staged tile.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[D / 16][4], const bf16* s, int wr,
                                             int g, int t) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* r0 = &s[(wr + g) * kStride + kk * 16 + t * 2];
    const bf16* r1 = r0 + 8 * kStride;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(r1);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
  }
}

// c[j] (16 x 8, columns j*8..j*8+7) = A (16 x D) * X^T, X the staged [64, D] tile.
template <int D>
__device__ __forceinline__ void mma_abt(float (&c)[kBN / 8][4], const uint32_t (&a)[D / 16][4],
                                        const bf16* x, int g, int t) {
  constexpr int kStride = D + 8;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const bf16* xr = &x[(j * 8 + g) * kStride + kk * 16 + t * 2];
      mma_bf16(c[j], a[kk], *reinterpret_cast<const uint32_t*>(xr),
               *reinterpret_cast<const uint32_t*>(xr + 8));
    }
  }
}

// acc (16 x D) += A (16 x 64, as A fragments) * X, X the staged [64, D] tile.
template <int D>
__device__ __forceinline__ void mma_ax(float (&acc)[D / 8][4], const uint32_t (&a)[kBN / 16][4],
                                       const bf16* x, int g, int t) {
  constexpr int kStride = D + 8;
  const uint16_t* xu = reinterpret_cast<const uint16_t*>(x);
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const int r = kk * 16 + t * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int d = j * 8 + g;
      const uint32_t b0 = xu[r * kStride + d] | (uint32_t(xu[(r + 1) * kStride + d]) << 16);
      const uint32_t b1 =
          xu[(r + 8) * kStride + d] | (uint32_t(xu[(r + 9) * kStride + d]) << 16);
      mma_bf16(acc[j], a[kk], b0, b1);
    }
  }
}

// Kernel A: dK and dV for one 64-row K/V tile. The warp's fragments hold S^T (16 keys x 64
// queries): element e of c[j] is key wr + g + 8 * (e >> 1), query j * 8 + 2t + (e & 1).
template <int D>
__global__ void __launch_bounds__(kBf16Threads) bwd_dkdv_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0, "head width must be a multiple of 16");
  constexpr int kStride = D + 8;
  __shared__ __align__(16) bf16 sQ[kBN * kStride];
  __shared__ __align__(16) bf16 sdO[kBN * kStride];
  __shared__ __align__(16) bf16 sKV[kBM * kStride];
  __shared__ float sLse[kBN];
  __shared__ float sDelta[kBN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int k0 = blockIdx.x * kBM;
  const int wr = warp * 16;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dob = static_cast<const bf16*>(p.dout) + (long long)bh * S * D;
  const bf16* bias_row = p.bias ? static_cast<const bf16*>(p.bias) + (long long)b * S : nullptr;
  const float* lse_b = p.lse + (long long)bh * S;
  const float* delta_b = p.delta + (long long)bh * S;

  uint32_t ka[D / 16][4], va[D / 16][4];
  stage_rows<D>(sKV, kb, p.k_ss, k0, S, tid);
  __syncthreads();
  load_a_frags<D>(ka, sKV, wr, g, t);
  __syncthreads();
  stage_rows<D>(sKV, vb, p.v_ss, k0, S, tid);
  __syncthreads();
  load_a_frags<D>(va, sKV, wr, g, t);

  const int key[2] = {k0 + wr + g, k0 + wr + g + 8};
  float kbias[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    kbias[r] = key[r] >= S ? -INFINITY : (bias_row ? __bfloat162float(bias_row[key[r]]) : 0.f);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  const int n_tiles = (S + kBN - 1) / kBN;
  const int first = p.causal ? k0 / kBN : 0;  // queries before the first key see no key here
  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kBN;
    __syncthreads();  // every warp is done with the previous tile
    stage_rows<D>(sQ, qb, p.q_ss, q0, S, tid);
    stage_rows<D>(sdO, dob, D, q0, S, tid);
    if (tid < kBN) {
      const bool in = q0 + tid < S;
      sLse[tid] = in ? lse_b[q0 + tid] : INFINITY;
      sDelta[tid] = in ? delta_b[q0 + tid] : 0.f;
    }
    __syncthreads();

    float st[kBN / 8][4], dpt[kBN / 8][4];
    mma_abt<D>(st, ka, sQ, g, t);   // S^T = K Q^T
    mma_abt<D>(dpt, va, sdO, g, t);  // (dO V^T)^T = V dO^T

    uint32_t pa[kBN / 16][4], dsa[kBN / 16][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float pd[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const int query = q0 + col;
        const int kr = key[e >> 1];
        float prob = 0.f;
        if (!(p.causal && kr > query))
          prob = __expf(st[j][e] * p.scale + kbias[e >> 1] - sLse[col]);
        float f = 1.f;
        if (p.dropout > 0.f)
          f = dropout_bits(p.seed, bh, query, kr) >= p.threshold ? p.keep_scale : 0.f;
        pd[e] = prob * f;
        ds[e] = prob * (dpt[j][e] * f - sDelta[col]);
      }
      pa[j / 2][(j & 1) * 2] = pack_bf16(pd[0], pd[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(pd[2], pd[3]);
      dsa[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_ax<D>(dv, pa, sdO, g, t);  // dV += (P M)^T dO
    mma_ax<D>(dk, dsa, sQ, g, t);  // dK += dS^T Q
  }

  bf16* dkb = static_cast<bf16*>(p.dk) + (long long)bh * S * D;
  bf16* dvb = static_cast<bf16*>(p.dv) + (long long)bh * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long at = (long long)key[r] * D + j * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(&dkb[at]) =
          pack_bf16(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(&dvb[at]) = pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// Kernel B: dQ for one 64-row Q tile. The warp's fragments hold S (16 queries x 64 keys):
// element e of c[j] is query wr + g + 8 * (e >> 1), key j * 8 + 2t + (e & 1).
template <int D>
__global__ void __launch_bounds__(kBf16Threads) bwd_dq_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0, "head width must be a multiple of 16");
  constexpr int kStride = D + 8;
  __shared__ __align__(16) bf16 sK[kBN * kStride];
  __shared__ __align__(16) bf16 sV[kBN * kStride];
  __shared__ float sBias[kBN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int q0 = blockIdx.x * kBM;
  const int wr = warp * 16;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* dob = static_cast<const bf16*>(p.dout) + (long long)bh * S * D;
  const bf16* bias_row = p.bias ? static_cast<const bf16*>(p.bias) + (long long)b * S : nullptr;

  // Q and dO fragments of this warp's 16 rows, staged through sK / sV
  uint32_t qa[D / 16][4], doa[D / 16][4];
  stage_rows<D>(sK, qb, p.q_ss, q0, S, tid);
  stage_rows<D>(sV, dob, D, q0, S, tid);
  __syncthreads();
  load_a_frags<D>(qa, sK, wr, g, t);
  load_a_frags<D>(doa, sV, wr, g, t);

  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < S;
    lse_r[r] = in ? p.lse[(long long)bh * S + row[r]] : INFINITY;
    delta_r[r] = in ? p.delta[(long long)bh * S + row[r]] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  int n_tiles = (S + kBN - 1) / kBN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBM - 1) / kBN + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBN;
    __syncthreads();
    stage_rows<D>(sK, kb, p.k_ss, k0, S, tid);
    stage_rows<D>(sV, vb, p.v_ss, k0, S, tid);
    if (tid < kBN) {
      const int kr = k0 + tid;
      sBias[tid] = kr >= S ? -INFINITY : (bias_row ? __bfloat162float(bias_row[kr]) : 0.f);
    }
    __syncthreads();

    float s[kBN / 8][4], dpr[kBN / 8][4];
    mma_abt<D>(s, qa, sK, g, t);    // S = Q K^T
    mma_abt<D>(dpr, doa, sV, g, t);  // dO V^T

    uint32_t dsa[kBN / 16][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      float f[4] = {1.f, 1.f, 1.f, 1.f};
      if (p.dropout > 0.f) {
        // keys 2t, 2t+1 of the 8-column tile share one group of four
        const uint32_t col4 = uint32_t(k0 + j * 8 + t * 2) >> 2;
        const int w = (t & 1) * 2;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint4 bits = dropout_bits4(p.seed, bh, row[r], col4);
          f[2 * r] = word(bits, w) >= p.threshold ? p.keep_scale : 0.f;
          f[2 * r + 1] = word(bits, w + 1) >= p.threshold ? p.keep_scale : 0.f;
        }
      }
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + t * 2 + (e & 1);
        const int r = e >> 1;
        float prob = 0.f;
        if (!(p.causal && k0 + col > row[r]))
          prob = __expf(s[j][e] * p.scale + sBias[col] - lse_r[r]);
        ds[e] = prob * (dpr[j][e] * f[e] - delta_r[r]);
      }
      dsa[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
      dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
    }
    mma_ax<D>(dq, dsa, sK, g, t);  // dQ += dS K
  }

  bf16* dqb = static_cast<bf16*>(p.dq) + (long long)bh * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(&dqb[(long long)row[r] * D + j * 8 + t * 2]) =
          pack_bf16(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
  }
}

// ---------------------------------------------------------------------------------------
// f32: full-precision FMA path, one row per thread. The thread's own rows sit in padded
// shared memory (row stride D + 1: the 32 threads of a warp read 32 distinct banks); the
// other operand's tile is read by all threads at once (a broadcast).
// ---------------------------------------------------------------------------------------

constexpr int kF32Rows = 32;  // rows (threads) per block
constexpr int kF32Tile = 32;  // rows per staged tile of the other operand

template <int D>
__device__ __forceinline__ void stage_f32(float* dst, int dst_stride, const float* src,
                                          long long ss, int r0, int limit, int tid) {
  for (int i = tid; i < kF32Tile * D; i += kF32Rows) {
    const int r = i / D, c = i % D;
    dst[r * dst_stride + c] = r0 + r < limit ? src[(r0 + r) * ss + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Rows) bwd_dkdv_f32_kernel(const Params p) {
  __shared__ float sK[kF32Rows * (D + 1)];
  __shared__ float sV[kF32Rows * (D + 1)];
  __shared__ float sQ[kF32Tile * D];
  __shared__ float sdO[kF32Tile * D];
  __shared__ float sLse[kF32Tile];
  __shared__ float sDelta[kF32Tile];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int k0 = blockIdx.x * kF32Rows;
  const int key = k0 + tid;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dob = static_cast<const float*>(p.dout) + (long long)bh * S * D;
  const float* bias_row = p.bias ? static_cast<const float*>(p.bias) + (long long)b * S : nullptr;

  stage_f32<D>(sK, D + 1, kb, p.k_ss, k0, S, tid);
  stage_f32<D>(sV, D + 1, vb, p.v_ss, k0, S, tid);
  const float kbias = key >= S ? -INFINITY : (bias_row ? bias_row[key] : 0.f);
  const float* kr = &sK[tid * (D + 1)];
  const float* vr = &sV[tid * (D + 1)];

  float dk[D], dv[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dk[d] = dv[d] = 0.f;

  const int n_tiles = (S + kF32Tile - 1) / kF32Tile;
  const int first = p.causal ? k0 / kF32Tile : 0;
  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * kF32Tile;
    __syncthreads();
    stage_f32<D>(sQ, D, qb, p.q_ss, q0, S, tid);
    stage_f32<D>(sdO, D, dob, D, q0, S, tid);
    {
      const bool in = q0 + tid < S;
      sLse[tid] = in ? p.lse[(long long)bh * S + q0 + tid] : INFINITY;
      sDelta[tid] = in ? p.delta[(long long)bh * S + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int qi = 0; qi < kF32Tile; ++qi) {
      const int query = q0 + qi;
      const float* qr = &sQ[qi * D];
      const float* dor = &sdO[qi * D];
      float s = 0.f, dpr = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(kr[d], qr[d], s);
        dpr = fmaf(vr[d], dor[d], dpr);
      }
      float prob = 0.f;
      if (!(p.causal && key > query)) prob = expf(s * p.scale + kbias - sLse[qi]);
      float f = 1.f;
      if (p.dropout > 0.f)
        f = dropout_bits(p.seed, bh, query, key) >= p.threshold ? p.keep_scale : 0.f;
      const float pd = prob * f;
      const float ds = prob * (dpr * f - sDelta[qi]);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        dv[d] = fmaf(pd, dor[d], dv[d]);
        dk[d] = fmaf(ds, qr[d], dk[d]);
      }
    }
  }
  if (key >= S) return;
  float* dkb = static_cast<float*>(p.dk) + ((long long)bh * S + key) * D;
  float* dvb = static_cast<float*>(p.dv) + ((long long)bh * S + key) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    dkb[d] = dk[d] * p.scale;
    dvb[d] = dv[d];
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Rows) bwd_dq_f32_kernel(const Params p) {
  __shared__ float sQ[kF32Rows * (D + 1)];
  __shared__ float sdO[kF32Rows * (D + 1)];
  __shared__ float sK[kF32Tile * D];
  __shared__ float sV[kF32Tile * D];
  __shared__ float sBias[kF32Tile];

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int q0 = blockIdx.x * kF32Rows;
  const int row = q0 + tid;
  const bool valid = row < S;

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const float* dob = static_cast<const float*>(p.dout) + (long long)bh * S * D;
  const float* bias_row = p.bias ? static_cast<const float*>(p.bias) + (long long)b * S : nullptr;

  stage_f32<D>(sQ, D + 1, qb, p.q_ss, q0, S, tid);
  stage_f32<D>(sdO, D + 1, dob, D, q0, S, tid);
  const float lse = valid ? p.lse[(long long)bh * S + row] : INFINITY;
  const float delta = valid ? p.delta[(long long)bh * S + row] : 0.f;
  const float* qr = &sQ[tid * (D + 1)];
  const float* dor = &sdO[tid * (D + 1)];

  float dq[D];
#pragma unroll
  for (int d = 0; d < D; ++d) dq[d] = 0.f;

  int n_tiles = (S + kF32Tile - 1) / kF32Tile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kF32Rows - 1) / kF32Tile + 1);
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kF32Tile;
    __syncthreads();
    stage_f32<D>(sK, D, kb, p.k_ss, k0, S, tid);
    stage_f32<D>(sV, D, vb, p.v_ss, k0, S, tid);
    {
      const int kr = k0 + tid;
      sBias[tid] = kr >= S ? -INFINITY : (bias_row ? bias_row[kr] : 0.f);
    }
    __syncthreads();
    for (int kj = 0; kj < kF32Tile; ++kj) {
      const int key = k0 + kj;
      const float* kr = &sK[kj * D];
      const float* vr = &sV[kj * D];
      float s = 0.f, dpr = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) {
        s = fmaf(qr[d], kr[d], s);
        dpr = fmaf(dor[d], vr[d], dpr);
      }
      float prob = 0.f;
      if (!(p.causal && key > row)) prob = expf(s * p.scale + sBias[kj] - lse);
      float f = 1.f;
      if (p.dropout > 0.f)
        f = dropout_bits(p.seed, bh, row, key) >= p.threshold ? p.keep_scale : 0.f;
      const float ds = prob * (dpr * f - delta);
#pragma unroll
      for (int d = 0; d < D; ++d) dq[d] = fmaf(ds, kr[d], dq[d]);
    }
  }
  if (!valid) return;
  float* dqb = static_cast<float*>(p.dq) + ((long long)bh * S + row) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) dqb[d] = dq[d] * p.scale;
}

template <int D>
cudaError_t launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  const int bh = B * p.H;
  const long long rows = (long long)bh * p.S;
  const dim3 dgrid((unsigned)((rows + 3) / 4));
  if (dtype == 1) {
    delta_kernel<bf16, D><<<dgrid, 128, 0, stream>>>(p, rows);
  } else {
    delta_kernel<float, D><<<dgrid, 128, 0, stream>>>(p, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (dtype == 1) {
    const dim3 grid((p.S + kBM - 1) / kBM, bh);
    bwd_dkdv_bf16_kernel<D><<<grid, kBf16Threads, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dq_bf16_kernel<D><<<grid, kBf16Threads, 0, stream>>>(p);
  } else {
    const dim3 grid((p.S + kF32Rows - 1) / kF32Rows, bh);
    bwd_dkdv_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    bwd_dq_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. delta is [B, H, S] f32 scratch. dropout in [0, 1);
// threshold = uint32(dropout * 2^32). Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* o, const void* dout, const void* lse, void* delta,
                              void* dq, void* dk, void* dv, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss, int B, int H,
                              int S, int D, float scale, int causal, int has_bias, int dtype,
                              float dropout, unsigned int threshold,
                              unsigned long long seed, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535 || (dtype != 0 && dtype != 1) ||
      !(dropout >= 0.f && dropout < 1.f))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q, p.k = k, p.v = v, p.bias = has_bias ? bias : nullptr;
  p.o = o, p.dout = dout, p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq, p.dk = dk, p.dv = dv;
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.H = H, p.S = S, p.scale = scale, p.causal = causal;
  p.dropout = dropout, p.keep_scale = 1.f / (1.f - dropout), p.threshold = threshold;
  p.seed = seed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, B, dtype, st);
    case 64: return launch<64>(p, B, dtype, st);
    default: return cudaErrorInvalidValue;
  }
}
