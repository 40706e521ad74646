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
// dQ, dK, dV once (8 B H S D elements, plus the LSE), and does 10 B H S^2 D FLOPs (S, dP, dV,
// dQ, dK). For BERT-base training (B 128, H 12, S 128, D 64, bf16) that is ~201 MB, 0.060 ms
// at 3.35 TB/s against 0.016 ms of tensor-core work: memory-bound, like the forward. With
// dropout the Philox integer work is next: 0.25 generator calls per score element.
//
// Design (bf16 path). Scores are computed in the forward orientation (query rows as the mma's
// M), so each m16n8 fragment of S holds the four elements of one Philox call, as in the
// forward. Two variants, chosen by the wrapper (ops/flash_attention.py::bwd_variant):
//  * fused, S <= 128: one launch, one block of 8 warps per (batch, head) holding all of K and
//    V in shared memory. It walks 64-row Q/dO tiles (both in flight by cp.async from the
//    start) and, per tile, computes S and dP once per element (each warp 16 rows x 64 keys),
//    writes P*M and dS to shared memory as bf16, then accumulates dV += (P*M)^T dO and
//    dK += dS^T Q in registers (each warp 16 keys, A operands by ldmatrix.trans) and writes
//    the tile's dQ = dS K complete (each warp 16 rows x D/2). D = rowsum(dO*O) is taken from
//    the dO and O rows at the start, while the copies are in flight: no pre-pass, no second
//    launch, no cross-block sum, no atomics.
//  * split, any S: two launches with the same building blocks. A dQ kernel (one block of 8
//    warps per 128 query rows, K/V tiles of 64 keys in a two-stage cp.async ring, dS from
//    registers straight into dS K) also writes D for its rows; then the dK/dV kernel above,
//    one block per 128 keys, walks the Q/dO tiles through a two-stage ring and reads D. S and
//    dP are computed twice, once per kernel.
// Every B operand (K, V, Q, dO) and every transposed A operand (P^T, dS^T) is loaded with
// ldmatrix / ldmatrix.trans from rows padded against bank conflicts; all products are
// mma.sync m16n8k16 with f32 accumulation; P*M and dS are rounded to bf16 as the operands of
// the dV, dK and dQ products (the TPU kernel keeps them in f32). Exponentials are base 2 (the
// scale, bias and LSE pre-multiplied by log2 e). The f32 path (not on the main path) is a D
// pre-pass and two FMA kernels, one row per thread, with synchronous loads.
//
// Layout: q/k/v are [B, H, S, D] with D contiguous and any batch/head/row strides (the same
// head-split views the forward takes); o, dout, dq, dk, dv are contiguous [B, H, S, D] in the
// input dtype; lse and delta are contiguous [B, H, S] f32; bias is a contiguous [B, 1, 1, S]
// row in the input dtype. Key positions past S (a ragged last tile) get -inf scores; query rows
// past S get P = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "philox.cuh"

namespace {

using namespace flash_mma;
using flash_philox::dropout_bits;
using flash_philox::dropout_bits4;

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

// ---------------------------------------------------------------------------------------
// bf16: tensor-core path
// ---------------------------------------------------------------------------------------

constexpr int kThreads = 256;  // 8 warps
constexpr int kKeys = 128;     // keys a dK/dV block owns (the fused variant: all of S)
constexpr int kQRows = 64;     // query rows per staged Q/dO tile of the dK/dV kernel
constexpr int kPStride = kKeys + 8;
constexpr int kDqRows = 128;   // query rows a dQ block owns (8 warps x 16)
constexpr int kDqKeys = 64;    // keys per staged K/V tile of the dQ kernel

// D = rowsum(dO * O) in f32 of row `row` (< S), two threads per row (`half` 0 and 1, adjacent
// lanes); the sum is complete in both threads.
template <int D>
__device__ __forceinline__ float delta_of_row(const bf16* ob, const bf16* dob, int row, int half,
                                              bool valid) {
  float acc = 0.f;
  if (valid) {
    const bf16* o = ob + (long long)row * D + half * (D / 2);
    const bf16* d_o = dob + (long long)row * D + half * (D / 2);
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + c);
      const uint4 d = *reinterpret_cast<const uint4*>(d_o + c);
      const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 af = __bfloat1622float2(a2[i]), df = __bfloat1622float2(d2[i]);
        acc = fmaf(af.x, df.x, acc);
        acc = fmaf(af.y, df.y, acc);
      }
    }
  }
  return acc + __shfl_xor_sync(0xffffffffu, acc, 1);
}

template <int D>
constexpr int dkdv_smem_bytes() {
  // sK, sV [kKeys][D+8]; sQ, sdO [2][kQRows][D+8]; sP, sdS [kQRows][kPStride] (bf16);
  // sBias [kKeys], sLse [2][kQRows], sDelta [2][kQRows] (f32)
  return ((2 * kKeys + 4 * kQRows) * (D + 8) + 2 * kQRows * kPStride) * 2 +
         (kKeys + 4 * kQRows) * 4;
}

// dK and dV of the block's kKeys keys (blockIdx.x), and with kFused (S <= kKeys, one block per
// (batch, head)) dQ and D as well.
template <int D, bool kFused>
__global__ void __launch_bounds__(kThreads, 2) bwd_dkdv_bf16_kernel(const Params p) {
  static_assert(D % 32 == 0, "head width must be a multiple of 32");
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kKeys * kStride;
  bf16* sQ = sV + kKeys * kStride;       // [2][kQRows][kStride]
  bf16* sdO = sQ + 2 * kQRows * kStride;  // [2][kQRows][kStride]
  bf16* sP = sdO + 2 * kQRows * kStride;  // [kQRows][kPStride]: P * M of the tile
  bf16* sdS = sP + kQRows * kPStride;     // [kQRows][kPStride]: dS of the tile
  float* sBias = reinterpret_cast<float*>(sdS + kQRows * kPStride);  // [kKeys], base 2
  float* sLse = sBias + kKeys;            // [2][kQRows]
  float* sDelta = sLse + 2 * kQRows;      // [2][kQRows]; fused: [S] rows in order

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int k0 = blockIdx.x * kKeys;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* ob = static_cast<const bf16*>(p.o) + (long long)bh * S * D;
  const bf16* dob = static_cast<const bf16*>(p.dout) + (long long)bh * S * D;
  const bf16* bias_row = p.bias ? static_cast<const bf16*>(p.bias) + (long long)b * S : nullptr;
  const float* lse_b = p.lse + (long long)bh * S;
  const float* delta_b = kFused ? nullptr : p.delta + (long long)bh * S;

  const int n_qt = (S + kQRows - 1) / kQRows;
  const int first = p.causal ? k0 / kQRows : 0;  // earlier queries see none of these keys

  auto stage_q = [&](int qt, int slot) {
    const int q0 = qt * kQRows;
    stage_rows_async<D, kQRows, kThreads>(sQ + slot * kQRows * kStride, qb, p.q_ss, q0, S, tid);
    stage_rows_async<D, kQRows, kThreads>(sdO + slot * kQRows * kStride, dob, D, q0, S, tid);
    if (tid < kQRows) {
      const bool in = q0 + tid < S;
      cp_async4(&sLse[slot * kQRows + tid], lse_b + (in ? q0 + tid : 0), in);
      if (!kFused) cp_async4(&sDelta[slot * kQRows + tid], delta_b + (in ? q0 + tid : 0), in);
    }
  };

  // prologue: K, V and the first two Q/dO tiles in flight
  stage_rows_async<D, kKeys, kThreads>(sK, kb, p.k_ss, k0, S, tid);
  stage_rows_async<D, kKeys, kThreads>(sV, vb, p.v_ss, k0, S, tid);
  if (first < n_qt) stage_q(first, 0);
  cp_commit();
  if (first + 1 < n_qt) stage_q(first + 1, 1);
  cp_commit();
  if (tid < kKeys) {
    const int key = k0 + tid;
    sBias[tid] = key >= S ? -INFINITY
                          : (bias_row ? __bfloat162float(bias_row[key]) * kLog2e : 0.f);
  }
  if (kFused) {  // D of every row (S <= kKeys = 2 * kQRows), read while the copies fly
    const int r = tid >> 1;
    const float d = delta_of_row<D>(ob, dob, r, tid & 1, r < S);
    if ((tid & 1) == 0) sDelta[r] = d;
  }

  const float scale2 = p.scale * kLog2e;
  const int wr = (warp & 3) * 16;   // phase 1: the warp's 16 query rows of the tile
  const int wc = (warp >> 2) * 64;  // phase 1: the warp's 64 keys of the block
  const int kw = warp * 16;         // phase 2: the warp's 16 keys of dK and dV
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int qt = first; qt < n_qt; ++qt) {
    const int slot = (qt - first) & 1;
    const int q0 = qt * kQRows;
    cp_wait<1>();
    __syncthreads();  // tile qt (and K, V, D) has landed
    const bf16* q_s = sQ + slot * kQRows * kStride;
    const bf16* do_s = sdO + slot * kQRows * kStride;

    // phase 1: S = Q K^T and dP = dO V^T for 16 rows x 64 keys, 32 keys at a time; P*M and
    // dS to shared memory as bf16
    {
      const int lr[2] = {wr + g, wr + g + 8};
      float lse2[2], dlt[2];  // LSE in base 2; +inf past S, so that P is 0 there
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = q0 + lr[r] < S ? sLse[slot * kQRows + lr[r]] * kLog2e : INFINITY;
        dlt[r] = sDelta[slot * kQRows + lr[r]];
      }
      const bool diagonal = p.causal && k0 + wc + 63 > q0 + wr;  // some key past some row
#pragma unroll 1
      for (int c = 0; c < 64; c += 32) {
        float st[4][4], dp[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[4], da[4];
          ldsm_x4(qa, &q_s[(wr + a_frag_row(lane)) * kStride + kk * 16 + a_frag_col(lane)]);
          ldsm_x4(da, &do_s[(wr + a_frag_row(lane)) * kStride + kk * 16 + a_frag_col(lane)]);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int kr = wc + c + jj * 16 + b_frag_row(lane);
            uint32_t kf[4], vf[4];
            ldsm_x4(kf, &sK[kr * kStride + kk * 16 + b_frag_col(lane)]);
            ldsm_x4(vf, &sV[kr * kStride + kk * 16 + b_frag_col(lane)]);
            mma_bf16(st[2 * jj], qa, kf[0], kf[1]);
            mma_bf16(st[2 * jj + 1], qa, kf[2], kf[3]);
            mma_bf16(dp[2 * jj], da, vf[0], vf[1]);
            mma_bf16(dp[2 * jj + 1], da, vf[2], vf[3]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kl = wc + c + j * 8 + t * 2;  // block-local key of elements 0 and 2
          float f[4] = {1.f, 1.f, 1.f, 1.f};
          if (p.dropout > 0.f) {
            const uint4 bits = dropout_bits4(p.seed, bh, q0 + lr[0], k0 + kl);
            f[0] = bits.x >= p.threshold ? p.keep_scale : 0.f;
            f[1] = bits.y >= p.threshold ? p.keep_scale : 0.f;
            f[2] = bits.z >= p.threshold ? p.keep_scale : 0.f;
            f[3] = bits.w >= p.threshold ? p.keep_scale : 0.f;
          }
          const float2 bias = *reinterpret_cast<const float2*>(&sBias[kl]);
          float pd[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            float prob =
                exp2_approx(fmaf(st[j][e], scale2, (e & 1) ? bias.y : bias.x) - lse2[r]);
            if (diagonal && k0 + kl + (e & 1) > q0 + lr[r]) prob = 0.f;
            pd[e] = prob * f[e];
            ds[e] = prob * (dp[j][e] * f[e] - dlt[r]);
          }
          *reinterpret_cast<uint32_t*>(&sP[lr[0] * kPStride + kl]) = pack_bf16(pd[0], pd[1]);
          *reinterpret_cast<uint32_t*>(&sP[lr[1] * kPStride + kl]) = pack_bf16(pd[2], pd[3]);
          *reinterpret_cast<uint32_t*>(&sdS[lr[0] * kPStride + kl]) = pack_bf16(ds[0], ds[1]);
          *reinterpret_cast<uint32_t*>(&sdS[lr[1] * kPStride + kl]) = pack_bf16(ds[2], ds[3]);
        }
      }
    }
    __syncthreads();

    // phase 2: dV += (P*M)^T dO and dK += dS^T Q for the warp's 16 keys
#pragma unroll
    for (int kq = 0; kq < kQRows / 16; ++kq) {
      uint32_t pa[4], sa[4];
      const int pr = kq * 16 + b_frag_row(lane), pc = kw + b_frag_col(lane);
      ldsm_x4_t(pa, &sP[pr * kPStride + pc]);
      ldsm_x4_t(sa, &sdS[pr * kPStride + pc]);
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        const int off = (kq * 16 + a_frag_row(lane)) * kStride + dd * 16 + a_frag_col(lane);
        uint32_t of[4], qf[4];
        ldsm_x4_t(of, &do_s[off]);
        ldsm_x4_t(qf, &q_s[off]);
        mma_bf16(dv[2 * dd], pa, of[0], of[1]);
        mma_bf16(dv[2 * dd + 1], pa, of[2], of[3]);
        mma_bf16(dk[2 * dd], sa, qf[0], qf[1]);
        mma_bf16(dk[2 * dd + 1], sa, qf[2], qf[3]);
      }
    }
    if (kFused) {
      // dQ = dS K of the tile, complete: the warp's 16 rows (wr) x D/2 columns
      constexpr int kDh = D / 2;
      const int d0 = (warp >> 2) * kDh;
      float dq[kDh / 8][4];
#pragma unroll
      for (int j = 0; j < kDh / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kKeys / 16; ++ks) {
        uint32_t a[4];
        ldsm_x4(a, &sdS[(wr + a_frag_row(lane)) * kPStride + ks * 16 + a_frag_col(lane)]);
#pragma unroll
        for (int dd = 0; dd < kDh / 16; ++dd) {
          uint32_t kf[4];
          ldsm_x4_t(kf, &sK[(ks * 16 + a_frag_row(lane)) * kStride + d0 + dd * 16 +
                            a_frag_col(lane)]);
          mma_bf16(dq[2 * dd], a, kf[0], kf[1]);
          mma_bf16(dq[2 * dd + 1], a, kf[2], kf[3]);
        }
      }
      bf16* dqb = static_cast<bf16*>(p.dq) + (long long)bh * S * D;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wr + g + 8 * r;
        if (row >= S) continue;
#pragma unroll
        for (int j = 0; j < kDh / 8; ++j)
          *reinterpret_cast<uint32_t*>(&dqb[(long long)row * D + d0 + j * 8 + t * 2]) =
              pack_bf16(dq[j][2 * r] * p.scale, dq[j][2 * r + 1] * p.scale);
      }
    }
    __syncthreads();  // every warp is done with this slot and with sP / sdS
    if (qt + 2 < n_qt) stage_q(qt + 2, slot);
    cp_commit();
  }

  bf16* dkb = static_cast<bf16*>(p.dk) + (long long)bh * S * D;
  bf16* dvb = static_cast<bf16*>(p.dv) + (long long)bh * S * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + kw + g + 8 * r;
    if (key >= S) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const long long at = (long long)key * D + j * 8 + t * 2;
      *reinterpret_cast<uint32_t*>(&dkb[at]) =
          pack_bf16(dk[j][2 * r] * p.scale, dk[j][2 * r + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(&dvb[at]) = pack_bf16(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  // sQ, sdO [kDqRows][D+8]; sK, sV [2][kDqKeys][D+8] (bf16); sBias [2][kDqKeys] (f32)
  return (2 * kDqRows + 4 * kDqKeys) * (D + 8) * 2 + 2 * kDqKeys * 4;
}

// The split variant's dQ of 128 query rows (blockIdx.x), and their D, written to p.delta for
// the dK/dV kernel that runs after it.
template <int D>
__global__ void __launch_bounds__(kThreads, 2) bwd_dq_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0, "head width must be a multiple of 16");
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [kDqRows][kStride]
  bf16* sdO = sQ + kDqRows * kStride;        // [kDqRows][kStride]
  bf16* sK = sdO + kDqRows * kStride;        // [2][kDqKeys][kStride]
  bf16* sV = sK + 2 * kDqKeys * kStride;     // [2][kDqKeys][kStride]
  float* sBias = reinterpret_cast<float*>(sV + 2 * kDqKeys * kStride);  // [2][kDqKeys]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int q0 = blockIdx.x * kDqRows;
  const int wr = warp * 16;

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* ob = static_cast<const bf16*>(p.o) + (long long)bh * S * D;
  const bf16* dob = static_cast<const bf16*>(p.dout) + (long long)bh * S * D;
  const bf16* bias_row = p.bias ? static_cast<const bf16*>(p.bias) + (long long)b * S : nullptr;

  auto bias_at = [&](int key) -> float {
    return key >= S ? -INFINITY : (bias_row ? __bfloat162float(bias_row[key]) * kLog2e : 0.f);
  };
  auto stage_kv = [&](int kt, int slot) {
    stage_rows_async<D, kDqKeys, kThreads>(sK + slot * kDqKeys * kStride, kb, p.k_ss,
                                           kt * kDqKeys, S, tid);
    stage_rows_async<D, kDqKeys, kThreads>(sV + slot * kDqKeys * kStride, vb, p.v_ss,
                                           kt * kDqKeys, S, tid);
  };

  int n_tiles = (S + kDqKeys - 1) / kDqKeys;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kDqRows - 1) / kDqKeys + 1);

  stage_rows_async<D, kDqRows, kThreads>(sQ, qb, p.q_ss, q0, S, tid);
  stage_rows_async<D, kDqRows, kThreads>(sdO, dob, D, q0, S, tid);
  stage_kv(0, 0);
  cp_commit();
  if (tid < kDqKeys) sBias[tid] = bias_at(tid);

  // D of the warp's 16 rows (two lanes per row), kept for rows g and g + 8 and written out
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};
  float dlt[2], lse2[2];
  {
    const int r = q0 + wr + (lane >> 1);
    const float d = delta_of_row<D>(ob, dob, r, lane & 1, r < S);
    if ((lane & 1) == 0 && r < S) p.delta[(long long)bh * S + r] = d;
    dlt[0] = __shfl_sync(0xffffffffu, d, 2 * g);
    dlt[1] = __shfl_sync(0xffffffffu, d, 2 * g + 16);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)  // +inf past S, so that P is 0 there
    lse2[r] = row[r] < S ? p.lse[(long long)bh * S + row[r]] * kLog2e : INFINITY;

  const float scale2 = p.scale * kLog2e;
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1's slot
    const int nslot = (kt + 1) & 1;
    float bias_next = 0.f;
    if (kt + 1 < n_tiles) {
      stage_kv(kt + 1, nslot);
      if (tid < kDqKeys) bias_next = bias_at((kt + 1) * kDqKeys + tid);
    }
    cp_commit();
    const int slot = kt & 1, k0 = kt * kDqKeys;
    const bf16* k_s = sK + slot * kDqKeys * kStride;
    const bf16* v_s = sV + slot * kDqKeys * kStride;
    const float* bias_s = sBias + slot * kDqKeys;
    const bool diagonal = p.causal && k0 + kDqKeys - 1 > q0 + wr;  // some key past some row

#pragma unroll 1
    for (int c = 0; c < kDqKeys; c += 32) {
      float st[4][4], dp[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t qa[4], da[4];
        ldsm_x4(qa, &sQ[(wr + a_frag_row(lane)) * kStride + kk * 16 + a_frag_col(lane)]);
        ldsm_x4(da, &sdO[(wr + a_frag_row(lane)) * kStride + kk * 16 + a_frag_col(lane)]);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int kr = c + jj * 16 + b_frag_row(lane);
          uint32_t kf[4], vf[4];
          ldsm_x4(kf, &k_s[kr * kStride + kk * 16 + b_frag_col(lane)]);
          ldsm_x4(vf, &v_s[kr * kStride + kk * 16 + b_frag_col(lane)]);
          mma_bf16(st[2 * jj], qa, kf[0], kf[1]);
          mma_bf16(st[2 * jj + 1], qa, kf[2], kf[3]);
          mma_bf16(dp[2 * jj], da, vf[0], vf[1]);
          mma_bf16(dp[2 * jj + 1], da, vf[2], vf[3]);
        }
      }
      // dS, rounded to bf16 straight into the A fragments of dS K (32 keys: two k16 steps)
      uint32_t dsa[2][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = c + j * 8 + t * 2;
        float f[4] = {1.f, 1.f, 1.f, 1.f};
        if (p.dropout > 0.f) {
          const uint4 bits = dropout_bits4(p.seed, bh, row[0], k0 + kl);
          f[0] = bits.x >= p.threshold ? p.keep_scale : 0.f;
          f[1] = bits.y >= p.threshold ? p.keep_scale : 0.f;
          f[2] = bits.z >= p.threshold ? p.keep_scale : 0.f;
          f[3] = bits.w >= p.threshold ? p.keep_scale : 0.f;
        }
        const float2 bias = *reinterpret_cast<const float2*>(&bias_s[kl]);
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float prob =
              exp2_approx(fmaf(st[j][e], scale2, (e & 1) ? bias.y : bias.x) - lse2[r]);
          if (diagonal && k0 + kl + (e & 1) > row[r]) prob = 0.f;
          ds[e] = prob * (dp[j][e] * f[e] - dlt[r]);
        }
        dsa[j / 2][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j / 2][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      // dQ += dS K: B fragments of K [key][d] by ldmatrix.trans
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t kf[4];
          ldsm_x4_t(kf, &k_s[(c + ks * 16 + a_frag_row(lane)) * kStride + dd * 16 +
                             a_frag_col(lane)]);
          mma_bf16(dq[2 * dd], dsa[ks], kf[0], kf[1]);
          mma_bf16(dq[2 * dd + 1], dsa[ks], kf[2], kf[3]);
        }
      }
    }
    if (kt + 1 < n_tiles && tid < kDqKeys) sBias[nslot * kDqKeys + tid] = bias_next;
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
// f32: full-precision FMA path, with a D pre-pass, one row per thread. The thread's own
// rows sit in padded shared memory (row stride D + 1: the 32 threads of a warp read 32
// distinct banks); the other operand's tile is read by all threads at once (a broadcast).
// ---------------------------------------------------------------------------------------

// D = rowsum(dO * O) in f32, one warp per row
template <int D>
__global__ void __launch_bounds__(128) delta_f32_kernel(const Params p, long long rows) {
  const long long r = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* o = static_cast<const float*>(p.o) + r * D;
  const float* d_o = static_cast<const float*>(p.dout) + r * D;
  float acc = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) acc = fmaf(o[d], d_o[d], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[r] = acc;
}

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

// Variants of the backward (ops/flash_attention.py::BWD_VARIANTS): 0 = f32 (pre-pass, dK/dV
// and dQ FMA kernels), 1 = bf16 fused (S <= kKeys, one launch), 2 = bf16 split (dQ kernel,
// then dK/dV kernel).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
cudaError_t launch(const Params& p, int B, int variant, cudaStream_t stream) {
  const int bh = B * p.H;
  cudaError_t err;
  if (variant == 1) {
    constexpr int kSmem = dkdv_smem_bytes<D>();
    static const cudaError_t attr = allow_smem(bwd_dkdv_bf16_kernel<D, true>, kSmem);
    if (attr != cudaSuccess) return attr;
    bwd_dkdv_bf16_kernel<D, true><<<dim3(1, bh), kThreads, kSmem, stream>>>(p);
  } else if (variant == 2) {
    constexpr int kDqSmem = dq_smem_bytes<D>(), kSmem = dkdv_smem_bytes<D>();
    static const cudaError_t attr_dq = allow_smem(bwd_dq_bf16_kernel<D>, kDqSmem);
    static const cudaError_t attr = allow_smem(bwd_dkdv_bf16_kernel<D, false>, kSmem);
    if (attr_dq != cudaSuccess) return attr_dq;
    if (attr != cudaSuccess) return attr;
    bwd_dq_bf16_kernel<D><<<dim3((p.S + kDqRows - 1) / kDqRows, bh), kThreads, kDqSmem,
                            stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dkdv_bf16_kernel<D, false><<<dim3((p.S + kKeys - 1) / kKeys, bh), kThreads, kSmem,
                                     stream>>>(p);
  } else {
    const long long rows = (long long)bh * p.S;
    delta_f32_kernel<D><<<dim3((unsigned)((rows + 3) / 4)), 128, 0, stream>>>(p, rows);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    const dim3 grid((p.S + kF32Rows - 1) / kF32Rows, bh);
    bwd_dkdv_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    bwd_dq_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; variant as above (0 with float32, 1 or 2 with bfloat16;
// 1 needs S <= 128). delta is [B, H, S] f32 scratch (unused by variant 1). dropout in [0, 1);
// threshold = uint32(dropout * 2^32). Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_bwd(const void* q, const void* k, const void* v, const void* bias,
                              const void* o, const void* dout, const void* lse, void* delta,
                              void* dq, void* dk, void* dv, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss, int B, int H,
                              int S, int D, float scale, int causal, int has_bias, int dtype,
                              float dropout, unsigned int threshold,
                              unsigned long long seed, int variant, void* stream) {
  const bool variant_ok = dtype == 0 ? variant == 0
                        : dtype == 1 ? (variant == 2 || (variant == 1 && S <= kKeys))
                                     : false;
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535 || !variant_ok ||
      !(dropout >= 0.f && dropout < 1.f) || (variant != 1 && delta == nullptr))
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
    case 32: return launch<32>(p, B, variant, st);
    case 64: return launch<64>(p, B, variant, st);
    default: return cudaErrorInvalidValue;
  }
}
