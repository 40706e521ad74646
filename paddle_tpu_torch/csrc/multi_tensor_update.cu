// Multi-tensor optimizer update for Hopper (sm_90a): one launch updates every parameter
// of a run of adam (or momentum, or sgd) ops, each parameter with its own learning rate and
// beta powers, read by pointer; a run of lamb or lars_momentum ops takes two launches, since
// each reads norms of whole tensors before it writes any element of them.
//   adam:      m' = b1 m + (1-b1) g               v' = b2 v + ((1-b2) g) g
//              lr_t = lr sqrt(1 - b2p) / (1 - b1p)
//              p' = p - (lr_t m') / (sqrt(v') + eps)    b1p' = b1p b1, b2p' = b2p b2
//   momentum:  v' = mu v + g    p' = p - lr v'   (nesterov: p' = p - (g + mu v') lr)
//   sgd:       p' = p - lr g
//   lamb:      m', v' as adam's; r = (m' / (1 - b1p)) / (sqrt(v' / (1 - b2p)) + eps) + wd p
//              trust = |p| / |r| (1 where either is 0)    p' = p - (lr trust) r
//              (wd is the tensor's own: a run mixes decayed and excluded parameters)
//   lars_momentum: local_lr = ((lr coeff) |p|) / ((|g| + decay |p|) + 1e-12) (lr where |p| = 0)
//              v' = mu v + local_lr (g + decay p)    p' = p - v'
// p and g are f32 or bf16 (each tensor its own), the accumulators f32; the arithmetic is
// f32, p' is rounded back to p's dtype. The update is in place: p', m', v' and the beta powers
// overwrite p, m, v and the powers (the programs name one variable for both, ParamOut =
// Param), the counterpart of the JAX step's donated state.
//
// Replaces: no Pallas kernel. It is the port's counterpart of the JAX package's
// fuse_all_optimizer_ops (paddle_tpu/compiler.py), under which XLA updates all parameters
// inside the one compiled step; the eager port ran each adam op as ~12 elementwise
// launches (paddle_tpu_torch/ops/optimizer_ops.py).
//
// Bit for bit: every operation is the per-op lowering's, in its order and association,
// written with __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn so that nvcc contracts
// nothing into an FMA; (1-b1) and (1-b2) arrive as floats rounded on the host from doubles,
// as PyTorch rounds the Python scalar; p' is rounded with __float2bfloat16_rn.
//
// Bound on an H100 SXM (3.35 TB/s): a memory pass. Adam reads p, g, m, v and writes p', m',
// v': BERT-base (~110 M parameters, bf16 weights with f32 moments, f32 embeddings) moves
// about 22 B an element, ~2.4 GB, ~0.72 ms; ResNet-50 momentum (~25.6 M, bf16 p and g,
// f32 velocity) about 14 B an element, ~0.36 GB, ~0.11 ms; sgd in f32 12 B an element.
//
// lamb and lars_momentum (the ports of the lamb and lars_momentum ops of
// paddle_tpu/ops/optimizer_ops.py, which XLA computes inside the step): pass 1
// (norm_pass_kernel) walks the same chunks and writes each chunk's two partial sums of
// squares (|p|^2, and |r|^2 or |g|^2; summed in double) to its own pair of f32 slots of a
// scratch buffer the wrapper allocates; lamb also writes m' and v' in place there (no
// reduction touches them: bit for bit to the lowering). Pass 2 (apply_pass_kernel): a block
// sums its tensor's chunk slots in chunk order, in double, so every block of a tensor finds the
// same norm and two runs agree bit for bit (no atomics); then lamb recomputes r from m', v'
// and p and writes p', lars_momentum writes v' and p'. The norms differ from torch.sum's in
// rounding only, so p' lies within an ulp or two of the lowering's. Bound: lamb moves 24 B
// an element in pass 1 and 16 B in pass 2 (f32 p, g, m, v), lars_momentum 2 x 4 B + 16 B
// (bf16 p and g, f32 v).
//
// Design: the wrapper writes a table into one device buffer, built once per parameter layout
// and kept (under a CUDA graph capture, one for the graph: fill_table's launches carry the
// table in their parameters, so every replay writes it again just before the update reads
// it; a buffer of the graph's pool may have held an earlier node's data): a 128-byte
// descriptor per tensor (one pointer for each tensor it reads, or reads
// and writes, its size and flags) and a list of work items (tensor, chunk of 65536
// elements). A grid of up to 16 blocks an SM strides over the items; a block's 256 threads
// each take 8 consecutive elements at a time, with 16-byte loads and stores (bf16: one,
// f32: two) where all of a tensor's pointers are 16-byte aligned, and one element at a time
// otherwise and for the ragged end. Every element is read and written by one thread, through
// one pointer, so the in-place update needs no ordering; the data pointers carry no
// __restrict__ (only the table, which nothing writes, does). The beta powers, which every
// chunk of a tensor reads, are advanced by a second launch after the first (beta_pow_kernel).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;
constexpr long long kPBf16 = 1, kGBf16 = 2, kVector = 4;

struct Desc {                // 16 int64 slots, as ops/multi_tensor.py writes them
  void* p;                   // read and written
  const void* g;
  float* m;                  // moment1 (adam, lamb) or velocity (momentum, lars_momentum):
                             // read and written; sgd: null
  float* v;                  // moment2 (adam, lamb): read and written
  const float* lr;
  float* b1p;                // beta powers (adam, lamb): read, then advanced by beta_pow_kernel
  float* b2p;
  long long n;
  long long flags;
  float wd;                  // lamb: the tensor's weight decay (the low half of slot 9)
  float pad;
  long long first_chunk;     // the tensor's chunks are items first_chunk .. + n_chunks - 1
  long long n_chunks;
  long long unused[4];
};
static_assert(sizeof(Desc) == 128, "descriptor layout");

struct Scalars {
  float b1, omb1, b2, omb2, eps, mu, coeff, decay;
  int nesterov;
};

__device__ __forceinline__ float load1(const void* base, long long i, bool bf16) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[i])
              : static_cast<const float*>(base)[i];
}

__device__ __forceinline__ void store1(void* base, long long i, bool bf16, float x) {
  if (bf16)
    static_cast<__nv_bfloat16*>(base)[i] = __float2bfloat16_rn(x);
  else
    static_cast<float*>(base)[i] = x;
}

__device__ __forceinline__ void load8f(const float* base, long long i, float (&x)[kVec]) {
  const float4* src = reinterpret_cast<const float4*>(base + i);
  const float4 a = src[0], b = src[1];
  x[0] = a.x, x[1] = a.y, x[2] = a.z, x[3] = a.w;
  x[4] = b.x, x[5] = b.y, x[6] = b.z, x[7] = b.w;
}

__device__ __forceinline__ void store8f(float* base, long long i, const float (&x)[kVec]) {
  float4* dst = reinterpret_cast<float4*>(base + i);
  dst[0] = make_float4(x[0], x[1], x[2], x[3]);
  dst[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void load8(const void* base, long long i, bool bf16,
                                      float (&x)[kVec]) {
  if (!bf16) {
    load8f(static_cast<const float*>(base), i, x);
    return;
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(base) + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(void* base, long long i, bool bf16,
                                       const float (&x)[kVec]) {
  if (!bf16) {
    store8f(static_cast<float*>(base), i, x);
    return;
  }
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < kVec; ++k) h[k] = __float2bfloat16_rn(x[k]);
  *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(base) + i) = raw;
}

constexpr int kAdam = 0, kMomentum = 1, kSgd = 2, kLamb = 3, kLarsMomentum = 4;

// One element, in the per-op lowering's order. ``scale`` is lr_t (adam) or lr (momentum,
// sgd).
template <int kKind>
__device__ __forceinline__ float update(float p, float g, float& m, float& v, float scale,
                                        const Scalars& s) {
  if (kKind == kSgd) return __fsub_rn(p, __fmul_rn(scale, g));
  if (kKind == kAdam) {
    m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
    v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
    const float den = __fadd_rn(__fsqrt_rn(v), s.eps);
    return __fsub_rn(p, __fdiv_rn(__fmul_rn(scale, m), den));
  }
  m = __fadd_rn(__fmul_rn(s.mu, m), g);
  if (s.nesterov) return __fsub_rn(p, __fmul_rn(__fadd_rn(g, __fmul_rn(s.mu, m)), scale));
  return __fsub_rn(p, __fmul_rn(scale, m));
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
    multi_tensor_kernel(const Desc* __restrict__ descs, const int2* __restrict__ chunks,
                        int n_chunks, int chunk, Scalars s) {
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int2 item = chunks[c];
    // the descriptor's fields in registers: the loop below stores through
    // pointers the compiler cannot tell from the table's memory
    const Desc& d = descs[item.x];
    void* const p_ptr = d.p;
    const void* const g_ptr = d.g;
    float* const m_ptr = d.m;
    float* const v_ptr = d.v;
    const long long flags = d.flags;
    const long long start = static_cast<long long>(item.y) * chunk;
    const long long end = min(start + chunk, d.n);
    const bool p16 = flags & kPBf16, g16 = flags & kGBf16;
    float scale;
    if (kKind == kAdam) {
      const float b1p = *d.b1p, b2p = *d.b2p;
      scale = __fdiv_rn(__fmul_rn(*d.lr, __fsqrt_rn(__fsub_rn(1.f, b2p))),
                        __fsub_rn(1.f, b1p));
    } else {
      scale = *d.lr;
    }
    long long tail = start;
    if (flags & kVector) {
      const long long groups = (end - start) / kVec;
      for (long long q = threadIdx.x; q < groups; q += kThreads) {
        const long long i = start + q * kVec;
        float p[kVec], g[kVec], m[kVec], v[kVec];
        load8(p_ptr, i, p16, p);
        load8(g_ptr, i, g16, g);
        if (kKind != kSgd) load8f(m_ptr, i, m);
        if (kKind == kAdam) load8f(v_ptr, i, v);
#pragma unroll
        for (int k = 0; k < kVec; ++k) p[k] = update<kKind>(p[k], g[k], m[k], v[k], scale, s);
        store8(p_ptr, i, p16, p);
        if (kKind != kSgd) store8f(m_ptr, i, m);
        if (kKind == kAdam) store8f(v_ptr, i, v);
      }
      tail = start + groups * kVec;
    }
    for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
      float m = kKind != kSgd ? m_ptr[i] : 0.f, v = kKind == kAdam ? v_ptr[i] : 0.f;
      const float p = update<kKind>(load1(p_ptr, i, p16), load1(g_ptr, i, g16), m, v, scale, s);
      store1(p_ptr, i, p16, p);
      if (kKind != kSgd) m_ptr[i] = m;
      if (kKind == kAdam) v_ptr[i] = v;
    }
  }
}

// ---- lamb and lars_momentum: two passes around per-tensor norms ----

// m', v' and r of one lamb element, in the lowering's order. inv1 = 1 - b1p, inv2 = 1 - b2p.
__device__ __forceinline__ float lamb_r(float p, float& m, float& v, float g, float inv1,
                                        float inv2, float wd, const Scalars& s, bool update) {
  if (update) {
    m = __fadd_rn(__fmul_rn(s.b1, m), __fmul_rn(s.omb1, g));
    v = __fadd_rn(__fmul_rn(s.b2, v), __fmul_rn(__fmul_rn(s.omb2, g), g));
  }
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, inv2)), s.eps);
  return __fadd_rn(__fdiv_rn(__fdiv_rn(m, inv1), den), __fmul_rn(wd, p));
}

// Sums a and b over the block (double); the result is valid in thread 0.
__device__ __forceinline__ void block_sum2(double& a, double& b, double (*shared)[2]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    shared[warp][0] = a;
    shared[warp][1] = b;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      a += shared[w][0];
      b += shared[w][1];
    }
  }
  __syncthreads();
}

// Pass 1: each chunk's |p|^2 and |r|^2 (lamb; m' and v' written in place) or |p|^2 and
// |g|^2 (lars_momentum) into partial[2 c], partial[2 c + 1].
template <int kKind>
__global__ void __launch_bounds__(kThreads)
    norm_pass_kernel(const Desc* __restrict__ descs, const int2* __restrict__ chunks,
                     int n_chunks, int chunk, Scalars s, float* __restrict__ partial) {
  __shared__ double shared[kThreads / 32][2];
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int2 item = chunks[c];
    const Desc& d = descs[item.x];
    const void* const p_ptr = d.p;
    const void* const g_ptr = d.g;
    float* const m_ptr = d.m;
    float* const v_ptr = d.v;
    const long long flags = d.flags;
    const long long start = static_cast<long long>(item.y) * chunk;
    const long long end = min(start + chunk, d.n);
    const bool p16 = flags & kPBf16, g16 = flags & kGBf16;
    float inv1 = 0.f, inv2 = 0.f, wd = 0.f;
    if (kKind == kLamb) {
      inv1 = __fsub_rn(1.f, *d.b1p);
      inv2 = __fsub_rn(1.f, *d.b2p);
      wd = d.wd;
    }
    double pp = 0.0, qq = 0.0;
    long long tail = start;
    if (flags & kVector) {
      const long long groups = (end - start) / kVec;
      for (long long q = threadIdx.x; q < groups; q += kThreads) {
        const long long i = start + q * kVec;
        float p[kVec], g[kVec], m[kVec], v[kVec];
        load8(p_ptr, i, p16, p);
        load8(g_ptr, i, g16, g);
        if (kKind == kLamb) {
          load8f(m_ptr, i, m);
          load8f(v_ptr, i, v);
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          const float x = kKind == kLamb ? lamb_r(p[k], m[k], v[k], g[k], inv1, inv2, wd, s, true)
                                         : g[k];
          pp += static_cast<double>(__fmul_rn(p[k], p[k]));
          qq += static_cast<double>(__fmul_rn(x, x));
        }
        if (kKind == kLamb) {
          store8f(m_ptr, i, m);
          store8f(v_ptr, i, v);
        }
      }
      tail = start + groups * kVec;
    }
    for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
      const float p = load1(p_ptr, i, p16), g = load1(g_ptr, i, g16);
      float x = g;
      if (kKind == kLamb) {
        float m = m_ptr[i], v = v_ptr[i];
        x = lamb_r(p, m, v, g, inv1, inv2, wd, s, true);
        m_ptr[i] = m;
        v_ptr[i] = v;
      }
      pp += static_cast<double>(__fmul_rn(p, p));
      qq += static_cast<double>(__fmul_rn(x, x));
    }
    block_sum2(pp, qq, shared);
    if (threadIdx.x == 0) {
      partial[2 * c] = static_cast<float>(pp);
      partial[2 * c + 1] = static_cast<float>(qq);
    }
  }
}

// Pass 2: the tensor's norms from its chunk slots (in chunk order, in double: the same in
// every block), then lamb's p' or lars_momentum's v' and p'. The block of a tensor's chunk 0
// also writes the two norms to norms[2 t], norms[2 t + 1] when norms is not null.
template <int kKind>
__global__ void __launch_bounds__(kThreads)
    apply_pass_kernel(const Desc* __restrict__ descs, const int2* __restrict__ chunks,
                      int n_chunks, int chunk, Scalars s, const float* __restrict__ partial,
                      float* __restrict__ norms) {
  __shared__ float scale_shared;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int2 item = chunks[c];
    const Desc& d = descs[item.x];
    void* const p_ptr = d.p;
    const void* const g_ptr = d.g;
    float* const m_ptr = d.m;
    float* const v_ptr = d.v;
    const long long flags = d.flags;
    const long long start = static_cast<long long>(item.y) * chunk;
    const long long end = min(start + chunk, d.n);
    const bool p16 = flags & kPBf16, g16 = flags & kGBf16;
    const float lr = *d.lr;
    float inv1 = 0.f, inv2 = 0.f, wd = 0.f;
    if (kKind == kLamb) {
      inv1 = __fsub_rn(1.f, *d.b1p);
      inv2 = __fsub_rn(1.f, *d.b2p);
      wd = d.wd;
    }
    if (threadIdx.x == 0) {
      double a = 0.0, b = 0.0;
      for (long long k = d.first_chunk; k < d.first_chunk + d.n_chunks; ++k) {
        a += static_cast<double>(partial[2 * k]);
        b += static_cast<double>(partial[2 * k + 1]);
      }
      const float pn = __fsqrt_rn(static_cast<float>(a)), qn = __fsqrt_rn(static_cast<float>(b));
      float scale;
      if (kKind == kLamb) {
        scale = __fmul_rn(lr, (pn > 0.f && qn > 0.f) ? __fdiv_rn(pn, qn) : 1.f);
      } else {
        scale = pn > 0.f ? __fdiv_rn(__fmul_rn(__fmul_rn(lr, s.coeff), pn),
                                     __fadd_rn(__fadd_rn(qn, __fmul_rn(s.decay, pn)), 1e-12f))
                         : lr;
      }
      scale_shared = scale;
      if (norms != nullptr && item.y == 0) {
        norms[2 * item.x] = pn;
        norms[2 * item.x + 1] = qn;
      }
    }
    __syncthreads();
    const float scale = scale_shared;   // lamb: lr trust; lars_momentum: local_lr
    long long tail = start;
    if (flags & kVector) {
      const long long groups = (end - start) / kVec;
      for (long long q = threadIdx.x; q < groups; q += kThreads) {
        const long long i = start + q * kVec;
        float p[kVec], g[kVec], m[kVec], v[kVec];
        load8(p_ptr, i, p16, p);
        load8f(m_ptr, i, m);
        if (kKind == kLamb) {
          load8f(v_ptr, i, v);
        } else {
          load8(g_ptr, i, g16, g);
        }
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (kKind == kLamb) {
            const float r = lamb_r(p[k], m[k], v[k], 0.f, inv1, inv2, wd, s, false);
            p[k] = __fsub_rn(p[k], __fmul_rn(scale, r));
          } else {
            m[k] = __fadd_rn(__fmul_rn(s.mu, m[k]),
                             __fmul_rn(scale, __fadd_rn(g[k], __fmul_rn(s.decay, p[k]))));
            p[k] = __fsub_rn(p[k], m[k]);
          }
        }
        store8(p_ptr, i, p16, p);
        if (kKind != kLamb) store8f(m_ptr, i, m);
      }
      tail = start + groups * kVec;
    }
    for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
      float p = load1(p_ptr, i, p16), m = m_ptr[i];
      if (kKind == kLamb) {
        float v = v_ptr[i];
        p = __fsub_rn(p, __fmul_rn(scale, lamb_r(p, m, v, 0.f, inv1, inv2, wd, s, false)));
      } else {
        const float g = load1(g_ptr, i, g16);
        m = __fadd_rn(__fmul_rn(s.mu, m), __fmul_rn(scale, __fadd_rn(g, __fmul_rn(s.decay, p))));
        p = __fsub_rn(p, m);
        m_ptr[i] = m;
      }
      store1(p_ptr, i, p16, p);
    }
    __syncthreads();   // scale_shared is written again for the block's next chunk
  }
}

// Adam's beta powers, one tensor a thread: b1p' = b1p b1, b2p' = b2p b2. Launched after
// multi_tensor_kernel, whose every block reads the old powers.
__global__ void __launch_bounds__(kThreads)
    beta_pow_kernel(const Desc* __restrict__ descs, int n_tensors, float b1, float b2) {
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t < n_tensors) {
    *descs[t].b1p = __fmul_rn(*descs[t].b1p, b1);
    *descs[t].b2p = __fmul_rn(*descs[t].b2p, b2);
  }
}

// Words of a table a fill launch carries in its parameters: 8 + 8 * kFillWords + 4 bytes,
// inside the 4 KB a launch's parameters may take.
constexpr int kFillWords = 500;
struct FillWords {
  long long w[kFillWords];
};

__global__ void __launch_bounds__(kThreads)
    fill_table_kernel(long long* __restrict__ dst, const FillWords src, int n) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = src.w[i];
}

}  // namespace

// Writes n_words int64 words from host memory into the device buffer dst, in stream order: one
// launch per kFillWords words, each carrying its words in its parameters (so a captured graph
// holds them). Returns the CUDA error of the launches (0 on success).
extern "C" int fill_table(void* dst, const void* words, long long n_words, void* stream) {
  if (n_words <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* src = static_cast<const long long*>(words);
  for (long long off = 0; off < n_words; off += kFillWords) {
    FillWords chunk;
    const int n = static_cast<int>(n_words - off < kFillWords ? n_words - off : kFillWords);
    for (int i = 0; i < n; ++i) chunk.w[i] = src[off + i];
    fill_table_kernel<<<1, kThreads, 0, st>>>(static_cast<long long*>(dst) + off, chunk, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// table: n_tensors descriptors (128 bytes each), then n_chunks (tensor, chunk) int32 pairs.
// kind: 0 adam (two launches: the update, then the beta powers), 1 momentum, 2 sgd, 3 lamb
// (three: pass 1, pass 2, the beta powers), 4 lars_momentum (two: pass 1, pass 2). lamb and
// lars_momentum take scratch, 2 n_chunks floats, and norms, 2 n_tensors floats or null.
// Returns the CUDA error of the launches (0 on success).
extern "C" int multi_tensor_update(const void* table, int n_tensors, int n_chunks, int chunk,
                                   int kind, float b1, float omb1, float b2, float omb2,
                                   float eps, float mu, float coeff, float decay, int nesterov,
                                   int grid, void* scratch, void* norms, void* stream) {
  if (n_tensors <= 0 || n_chunks <= 0 || chunk <= 0 || chunk % kVec || grid <= 0 ||
      kind < kAdam || kind > kLarsMomentum)
    return cudaErrorInvalidValue;
  const Desc* descs = static_cast<const Desc*>(table);
  const int2* chunks = reinterpret_cast<const int2*>(descs + n_tensors);
  const Scalars s{b1, omb1, b2, omb2, eps, mu, coeff, decay, nesterov};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* partial = static_cast<float*>(scratch);
  float* norm_out = static_cast<float*>(norms);
  if (kind == kMomentum) {
    multi_tensor_kernel<kMomentum><<<grid, kThreads, 0, st>>>(descs, chunks, n_chunks, chunk, s);
    return cudaGetLastError();
  }
  if (kind == kSgd) {
    multi_tensor_kernel<kSgd><<<grid, kThreads, 0, st>>>(descs, chunks, n_chunks, chunk, s);
    return cudaGetLastError();
  }
  if (kind == kLamb || kind == kLarsMomentum) {
    if (partial == nullptr) return cudaErrorInvalidValue;
    if (kind == kLamb) {
      norm_pass_kernel<kLamb><<<grid, kThreads, 0, st>>>(descs, chunks, n_chunks, chunk, s,
                                                         partial);
    } else {
      norm_pass_kernel<kLarsMomentum><<<grid, kThreads, 0, st>>>(descs, chunks, n_chunks, chunk,
                                                                 s, partial);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (kind == kLamb) {
      apply_pass_kernel<kLamb><<<grid, kThreads, 0, st>>>(descs, chunks, n_chunks, chunk, s,
                                                          partial, norm_out);
    } else {
      apply_pass_kernel<kLarsMomentum><<<grid, kThreads, 0, st>>>(descs, chunks, n_chunks, chunk,
                                                                  s, partial, norm_out);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess || kind == kLarsMomentum) return err;
  } else {
    multi_tensor_kernel<kAdam><<<grid, kThreads, 0, st>>>(descs, chunks, n_chunks, chunk, s);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  beta_pow_kernel<<<(n_tensors + kThreads - 1) / kThreads, kThreads, 0, st>>>(descs, n_tensors,
                                                                             b1, b2);
  return cudaGetLastError();
}
