// Flash-attention forward for Hopper (sm_90a):
// O = dropout(softmax(Q K^T * scale + bias [, causal])) V, and optionally the row LSE.
//
// Replaces: paddle_tpu/ops/pallas_attention.py::_flash_fwd_impl / _fwd_kernel (with _probs),
// the TPU Pallas kernel of the fused_attention op.
//
// Bound on an H100 SXM (3.35 TB/s, 989 TFLOP/s dense bf16): the kernel reads Q, K, V and
// writes O once, 4*B*H*S*D elements, and does 4*B*H*S^2*D FLOPs. For BERT-base (H 12, D 64,
// bf16) that is 2 FLOPs per byte at S 128 and 8 at S 512, far below the ~295 FLOPs per byte
// where the tensor cores become the limit, so it is memory-bound: at B 8 the bound is about
// 1.9 us (S 128) and 7.5 us (S 512); at B 128 S 128 with the LSE, 30 us. With dropout the
// Philox integer work (10 rounds of 2 wide multiplies and xors per call) is the next
// limit after the bytes: 0.25 calls per score element.
//
// Design (bf16 path). The [S, S] scores never reach device memory. A block of 4 warps owns
// 128 query rows of one (batch, head), 32 per warp, so each K/V element is read from device
// memory once per 128 query rows (a second instantiation, kMT 1, owns 64 rows, 16 a warp:
// twice the blocks, each K/V element read once per 64 rows; the autotuner's
// fused_attention.block_sizes picks between them). K/V tiles of 64 keys stream through a two-stage ring of
// cp.async copies in shared memory: the next tile is in flight while the current one is
// multiplied. Scores and P V run on the tensor cores (mma.sync m16n8k16, f32 accumulation);
// every operand is loaded by ldmatrix (Q, K) or ldmatrix.trans (V) from rows padded against
// bank conflicts, and each K or V fragment serves the warp's two 16-row tiles, which halves
// the shared-memory reads per mma against 16 rows a warp. Three blocks fit an SM (168
// registers a thread), so B 8 S 512's 384 blocks run in one wave on 132 SMs. The online
// softmax keeps the running max and sum in f32 and works in base 2 (scale and bias
// pre-multiplied by log2 e: one FFMA and one ex2 per score); the causal mask is applied only
// to tiles that cross the diagonal, and dropout is a separate instantiation, so serving's
// kernel issues no dropout instructions. P is rounded to bf16 straight into the A fragments
// of P V, as the TPU kernel rounds P to V's dtype. The output goes through shared memory so
// that each warp stores its rows with 16-byte writes. The f32 path uses full-precision f32
// FMAs (no TF32), one query row per thread, with synchronous tile loads (not on the main
// path).
//
// Layout: q/k/v are [B, H, S, D] with D contiguous and any batch/head/row strides (the
// port's attention inputs are transposed views of one packed projection); bias is a
// contiguous [B, 1, 1, S] row in the input dtype, widened to f32 before it is added; o is a
// contiguous [B, H, S, D]. Masking uses -1e30 for causal, as the TPU kernel does, and -inf
// for key positions past S (a ragged last tile).
//
// Training adds two optional parts, both off for serving (lse == nullptr, dropout == 0):
//  * lse [B, H, S] f32: m + log(l) of each row (row max and sum of the undropped
//    probabilities), which the backward kernels (flash_attn_bwd.cu) use to recompute P;
//  * attention dropout p with a 64-bit seed, given by value or derived in the kernel from the
//    run counter on the card (philox.cuh, run_seed): the keep mask comes from Philox4x32-10 inside
//    the kernel (philox.cuh), one call per m16n8 score fragment (its four elements are one
//    call's four words), kept probabilities are scaled by 1/(1-p) before P V, and the row
//    sum l is taken over the undropped probabilities, as the TPU kernel's `pd` is
//    (pallas_attention.py:114-116, :133).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "philox.cuh"

namespace {

using namespace flash_mma;
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
  flash_philox::SeedSource rng;  // the dropout seed: by value or from the run counter
};

// ---------------------------------------------------------------------------------------
// bf16: tensor-core path
// ---------------------------------------------------------------------------------------

// kMT (a template parameter): m16 row tiles per warp, 16 * kMT query rows a warp. The
// query tile of a block is kWarps * 16 * kMT rows: 128 at kMT 2 (the default), 64 at 1.
constexpr int kWarps = 4;
constexpr int kBN = 64;                   // keys per staged K/V tile
constexpr int kStages = 2;
constexpr int kBf16Threads = kWarps * 32;

template <int D, int kMT>
constexpr int fwd_smem_bytes() {
  return (kWarps * 16 * kMT + 2 * kStages * kBN) * (D + 8) * 2 + kStages * kBN * 4;
}

// kDrop: p.dropout > 0 (a separate instantiation, so that serving's kernel issues no
// dropout instructions)
template <int D, bool kDrop, int kMT>
__global__ void __launch_bounds__(kBf16Threads, 3) flash_fwd_bf16_kernel(const Params p) {
  static_assert(D % 16 == 0, "head width must be a multiple of 16");
  constexpr int kBM = kWarps * 16 * kMT;  // query rows per block
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);      // [kBM][kStride]; later the output rows
  bf16* sK = sQ + kBM * kStride;                 // [kStages][kBN][kStride]
  bf16* sV = sK + kStages * kBN * kStride;       // [kStages][kBN][kStride]
  float* sBias = reinterpret_cast<float*>(sV + kStages * kBN * kStride);  // [kStages][kBN]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group and column pair
  const int bh = blockIdx.y;
  const unsigned long long seed = kDrop ? flash_philox::run_seed(p.rng) : 0ull;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S;
  const int q0 = blockIdx.x * kBM;
  const int wr = warp * 16 * kMT;         // the warp's first row in the block

  const bf16* qb = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kb = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vb = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  const bf16* bias_row = p.bias ? static_cast<const bf16*>(p.bias) + (long long)b * S : nullptr;
  bf16* ob = static_cast<bf16*>(p.o) + (long long)bh * S * D;

  // bias of key `key` in base-2 units; -inf past S
  auto bias_at = [&](int key) -> float {
    return key >= S ? -INFINITY : (bias_row ? __bfloat162float(bias_row[key]) * kLog2e : 0.f);
  };
  auto stage_kv = [&](int kt, int slot) {
    stage_rows_async<D, kBN, kBf16Threads>(sK + slot * kBN * kStride, kb, p.k_ss, kt * kBN, S,
                                           tid);
    stage_rows_async<D, kBN, kBf16Threads>(sV + slot * kBN * kStride, vb, p.v_ss, kt * kBN, S,
                                           tid);
  };

  int n_tiles = (S + kBN - 1) / kBN;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kBM - 1) / kBN + 1);

  // prologue: Q and the first kStages - 1 K/V tiles
  stage_rows_async<D, kBM, kBf16Threads>(sQ, qb, p.q_ss, q0, S, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) {
      stage_kv(s, s);
      if (tid < kBN) sBias[s * kBN + tid] = bias_at(s * kBN + tid);
    }
    cp_commit();
  }

  const float scale2 = p.scale * kLog2e;
  float acc[kMT][D / 8][4];
  float m_run[kMT][2], l_run[kMT][2];  // base-2 running max; this thread's share of the sums
  int row[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_run[mt][r] = -INFINITY;
      l_run[mt][r] = 0.f;
      row[mt][r] = q0 + wr + 16 * mt + g + 8 * r;
    }
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    cp_wait<kStages - 2>();
    __syncthreads();  // tile kt has landed; every warp is done with tile kt - 1's slot
    const int nxt = kt + kStages - 1, nslot = nxt % kStages;
    float bias_next = 0.f;
    if (nxt < n_tiles) {
      stage_kv(nxt, nslot);
      if (tid < kBN) bias_next = bias_at(nxt * kBN + tid);  // stored after this tile's math
    }
    cp_commit();

    const int slot = kt % kStages;
    const int k0 = kt * kBN;
    const bf16* k_s = sK + slot * kBN * kStride;
    const bf16* v_s = sV + slot * kBN * kStride;
    const float* bias_s = sBias + slot * kBN;

    // scores for 32 rows x 64 keys: s[mt][j] is the 16x8 tile of rows 16 mt.., keys 8 j..;
    // each K fragment serves both row tiles
    float s[kMT][kBN / 8][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        ldsm_x4(qa[mt], &sQ[(wr + 16 * mt + a_frag_row(lane)) * kStride + kk * 16 +
                            a_frag_col(lane)]);
#pragma unroll
      for (int jj = 0; jj < kBN / 16; ++jj) {
        uint32_t kf[4];
        ldsm_x4(kf, &k_s[(jj * 16 + b_frag_row(lane)) * kStride + kk * 16 + b_frag_col(lane)]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(s[mt][2 * jj], qa[mt], kf[0], kf[1]);
          mma_bf16(s[mt][2 * jj + 1], qa[mt], kf[2], kf[3]);
        }
      }
    }

    // online softmax (base 2); P = 2^(S - m), rounded to bf16 straight into the A fragments
    // of P V. With dropout, the sum l takes the undropped P and P V the dropped, rescaled
    // one; the four elements of s[mt][j] are the four words of one Philox call.
    float2 bias_t[kBN / 8];  // the bias of this thread's key columns 2t, 2t + 1 of each j
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      bias_t[j] = *reinterpret_cast<const float2*>(&bias_s[j * 8 + t * 2]);
    uint32_t pa[kMT][kBN / 16][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        s[mt][j][0] = fmaf(s[mt][j][0], scale2, bias_t[j].x);
        s[mt][j][1] = fmaf(s[mt][j][1], scale2, bias_t[j].y);
        s[mt][j][2] = fmaf(s[mt][j][2], scale2, bias_t[j].x);
        s[mt][j][3] = fmaf(s[mt][j][3], scale2, bias_t[j].y);
      }
      if (p.causal && k0 + kBN - 1 > q0 + wr + 16 * mt) {  // the tile crosses the diagonal
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + j * 8 + t * 2 + (e & 1) > row[mt][e >> 1]) s[mt][j][e] = kCausalMask;
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mt][j][0], s[mt][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mt][j][2], s[mt][j][3]));
      }
      float m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[mt][r], mx[r]);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = exp2_approx(m_run[mt][r] - m_use[r]);
        m_run[mt][r] = m_new;
        l_run[mt][r] *= alpha;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[mt][j][2 * r] *= alpha;
          acc[mt][j][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        float p0 = exp2_approx(s[mt][j][0] - m_use[0]);
        float p1 = exp2_approx(s[mt][j][1] - m_use[0]);
        float p2 = exp2_approx(s[mt][j][2] - m_use[1]);
        float p3 = exp2_approx(s[mt][j][3] - m_use[1]);
        l_run[mt][0] += p0 + p1;
        l_run[mt][1] += p2 + p3;
        if (kDrop) {
          const uint4 bits = dropout_bits4(seed, bh, row[mt][0], k0 + j * 8 + t * 2);
          p0 = bits.x >= p.threshold ? p0 * p.keep_scale : 0.f;
          p1 = bits.y >= p.threshold ? p1 * p.keep_scale : 0.f;
          p2 = bits.z >= p.threshold ? p2 * p.keep_scale : 0.f;
          p3 = bits.w >= p.threshold ? p3 * p.keep_scale : 0.f;
        }
        pa[mt][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
        pa[mt][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
    }

    // O += P V: B fragments of V [key][d] by ldmatrix.trans, two d tiles per load, each
    // serving both row tiles
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
#pragma unroll
      for (int dd = 0; dd < D / 16; ++dd) {
        uint32_t vf[4];
        ldsm_x4_t(vf, &v_s[(kk * 16 + a_frag_row(lane)) * kStride + dd * 16 + a_frag_col(lane)]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][2 * dd], pa[mt][kk], vf[0], vf[1]);
          mma_bf16(acc[mt][2 * dd + 1], pa[mt][kk], vf[2], vf[3]);
        }
      }
    }
    if (nxt < n_tiles && tid < kBN) sBias[nslot * kBN + tid] = bias_next;
  }

  // normalise; the warp's 32 output rows go through its own rows of sQ (read by no other
  // warp) so that they leave in 16-byte stores
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float l = l_run[mt][r];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (p.lse && t == 0 && row[mt][r] < S)
        p.lse[(long long)bh * S + row[mt][r]] = m_run[mt][r] * kLn2 + logf(l);
      const float inv = 1.f / l;
      const int lr = wr + 16 * mt + g + 8 * r;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(&sQ[lr * kStride + j * 8 + t * 2]) =
            pack_bf16(acc[mt][j][2 * r] * inv, acc[mt][j][2 * r + 1] * inv);
    }
  }
  __syncwarp();
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = lane; i < 16 * kMT * kChunks; i += 32) {
    const int lr = wr + i / kChunks, c = (i % kChunks) * 8;
    if (q0 + lr < S)
      *reinterpret_cast<uint4*>(&ob[(long long)(q0 + lr) * D + c]) =
          *reinterpret_cast<const uint4*>(&sQ[lr * kStride + c]);
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
  const unsigned long long seed = p.dropout > 0.f ? flash_philox::run_seed(p.rng) : 0ull;
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
  const int word0 = ((row >> 3) & 1) * 2;  // this row's words of a Philox call (philox.cuh)

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
        if ((j & 1) == 0) bits = dropout_bits4(seed, bh, row, k0 + j);  // keys j, j + 1
        pj = word(bits, word0 + (j & 1)) >= p.threshold ? pj * p.keep_scale : 0.f;
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

template <int D, int kMT>
cudaError_t launch_bf16(const Params& p, int bh, cudaStream_t stream) {
  constexpr int kSmem = fwd_smem_bytes<D, kMT>();
  constexpr int kBM = kWarps * 16 * kMT;
  static const cudaError_t attr0 = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, false, kMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, true, kMT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr0 != cudaSuccess) return attr0;
  if (attr1 != cudaSuccess) return attr1;
  dim3 grid((p.S + kBM - 1) / kBM, bh);
  if (p.dropout > 0.f)
    flash_fwd_bf16_kernel<D, true, kMT><<<grid, kBf16Threads, kSmem, stream>>>(p);
  else
    flash_fwd_bf16_kernel<D, false, kMT><<<grid, kBf16Threads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const Params& p, int B, int dtype, int block_q, cudaStream_t stream) {
  const int bh = B * p.H;
  if (dtype == 1) {
    if (block_q == 64) return launch_bf16<D, 1>(p, bh, stream);
    if (block_q == 128) return launch_bf16<D, 2>(p, bh, stream);
    return cudaErrorInvalidValue;
  }
  dim3 grid((p.S + kF32Rows - 1) / kF32Rows, bh);
  flash_fwd_f32_kernel<D><<<grid, kF32Rows, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. lse may be null (not written). dropout in [0, 1);
// threshold = uint32(dropout * 2^32). The dropout seed is `seed` when counter is null, else
// seed_of(program_seed, *counter, salt) (philox.cuh). block_q: the bf16 path's query rows
// a block, 64 or 128 (the f32 path ignores it). Returns a cudaError_t (0 = launched).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v, const void* bias,
                              void* o, void* lse, long long q_sb, long long q_sh,
                              long long q_ss, long long k_sb, long long k_sh, long long k_ss,
                              long long v_sb, long long v_sh, long long v_ss, int B, int H,
                              int S, int D, float scale, int causal, int has_bias, int dtype,
                              float dropout, unsigned int threshold,
                              unsigned long long seed, const void* counter,
                              unsigned long long program_seed, unsigned long long salt,
                              int block_q, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || B * H > 65535 || (dtype != 0 && dtype != 1) ||
      !(dropout >= 0.f && dropout < 1.f))
    return cudaErrorInvalidValue;
  Params p;
  p.q = q, p.k = k, p.v = v, p.bias = has_bias ? bias : nullptr, p.o = o;
  p.lse = static_cast<float*>(lse);
  p.dropout = dropout, p.keep_scale = 1.f / (1.f - dropout), p.threshold = threshold;
  p.rng = {static_cast<const long long*>(counter), program_seed, salt, seed};
  p.q_sb = q_sb, p.q_sh = q_sh, p.q_ss = q_ss;
  p.k_sb = k_sb, p.k_sh = k_sh, p.k_ss = k_ss;
  p.v_sb = v_sb, p.v_sh = v_sh, p.v_ss = v_ss;
  p.H = H, p.S = S, p.scale = scale, p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch<32>(p, B, dtype, block_q, st);
    case 64: return launch<64>(p, B, dtype, block_q, st);
    default: return cudaErrorInvalidValue;
  }
}
