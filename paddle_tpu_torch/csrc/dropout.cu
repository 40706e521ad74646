// Dropout for Hopper (sm_90a): one pass that reads X and writes Out and Mask (Mask in X's
// dtype), for both of Fluid's dropout_implementations, with the keep bits drawn in the kernel.
//   keep_i = bits_i >= threshold            (threshold = uint64(p * 2^32); p = 1 drops all)
//   Mask_i = keep_i ? 1 : 0
//   downgrade_in_infer:  Out_i = X_i * Mask_i
//   upscale_in_train:    Out_i = (X_i * Mask_i) / (1 - p)    (all zeros when p = 1)
// The arithmetic is f32 (__fmul_rn, __fdiv_rn: nothing contracted), rounded once to X's dtype,
// as the plain version (ops/dropout.py::dropout_plain) computes it, so the two agree bit for
// bit; (1 - p) arrives as a float rounded on the host.
//
// Replaces: no Pallas kernel. It is the port's counterpart of the JAX dropout lowering's
// in-step draw (paddle_tpu/ops/nn_ops.py::dropout, jax.random.bernoulli inside the compiled
// step). The eager port drew each mask from a fresh host-seeded torch.Generator, which a CUDA
// graph would replay unchanged at every step.
//
// Bits: Philox4x32-10 (philox.cuh, shared with the flash-attention kernels), keyed by the
// 64-bit seed (low word, high word): the seed by value, or run_seed's derivation from the run
// counter on the card, so a captured step draws the masks of the counter written before each
// replay. Layout: element i (row-major over X) takes word i % 4 of the call with counter
// (g mod 2^32, g >> 32, 0, 0), g = i / 4: each call serves 4 consecutive elements.
//
// Bound on an H100 SXM (3.35 TB/s): a memory pass. It reads X and writes Out and Mask: 6 bytes
// an element in bf16. At BERT-base's hidden dropout ([128 * 128, 768] bf16) that is 75.5 MB,
// 0.0225 ms; the generator adds 2.5 calls of 10 rounds per 8 elements, integer work the card
// hides under the memory traffic.
//
// Design: a grid-stride loop over groups of 8 elements (two generator calls); a thread loads
// and stores a group with 16-byte accesses (bf16: one each, f32: two) where every pointer is
// 16-byte aligned and the group is whole, and one element at a time otherwise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;  // elements a thread takes at a time: two generator calls

struct Params {
  long long n;
  unsigned long long threshold;  // kept when bits >= threshold; 2^32 drops every element
  float one_minus_p;             // the upscale divisor, rounded on the host
  int upscale;                   // 1: upscale_in_train, 0: downgrade_in_infer
  int zero_out;                  // upscale with p = 1: Out is all zeros
  int vector;                    // x, out and mask are 16-byte aligned
  flash_philox::SeedSource rng;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Out and Mask of one element.
template <typename T>
__device__ __forceinline__ void apply(const Params& p, float x, uint32_t bits, T& out, T& mask) {
  const float m = static_cast<unsigned long long>(bits) >= p.threshold ? 1.f : 0.f;
  float o = __fmul_rn(x, m);
  if (p.upscale) o = p.zero_out ? 0.f : __fdiv_rn(o, p.one_minus_p);
  out = from_f32<T>(o);
  mask = from_f32<T>(m);
}

// 8 elements through 16-byte accesses: one uint4 of bf16, two of f32.
template <typename T>
struct Vec8 {
  static constexpr int kWords = kGroup * sizeof(T) / 16;
  uint4 w[kWords];
};

template <typename T>
__global__ void __launch_bounds__(kThreads) dropout_kernel(const T* __restrict__ x,
                                                           T* __restrict__ out,
                                                           T* __restrict__ mask, Params p) {
  const unsigned long long seed = flash_philox::run_seed(p.rng);
  const uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
  const long long groups = (p.n + kGroup - 1) / kGroup;
  for (long long v = blockIdx.x * (long long)kThreads + threadIdx.x; v < groups;
       v += (long long)gridDim.x * kThreads) {
    const unsigned long long g = 2ull * v;  // the first of the two calls' group indices
    const uint4 r0 = flash_philox::philox4x32_10(
        make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u), k0, k1);
    const uint4 r1 = flash_philox::philox4x32_10(
        make_uint4(static_cast<uint32_t>(g + 1), static_cast<uint32_t>((g + 1) >> 32), 0u, 0u),
        k0, k1);
    const uint32_t bits[kGroup] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const long long i0 = v * kGroup;
    if (p.vector && i0 + kGroup <= p.n) {
      Vec8<T> xv, ov, mv;
      const uint4* src = reinterpret_cast<const uint4*>(x + i0);
#pragma unroll
      for (int k = 0; k < Vec8<T>::kWords; ++k) xv.w[k] = src[k];
      const T* xs = reinterpret_cast<const T*>(xv.w);
      T* os = reinterpret_cast<T*>(ov.w);
      T* ms = reinterpret_cast<T*>(mv.w);
#pragma unroll
      for (int e = 0; e < kGroup; ++e) apply<T>(p, to_f32(xs[e]), bits[e], os[e], ms[e]);
      uint4* od = reinterpret_cast<uint4*>(out + i0);
      uint4* md = reinterpret_cast<uint4*>(mask + i0);
#pragma unroll
      for (int k = 0; k < Vec8<T>::kWords; ++k) {
        od[k] = ov.w[k];
        md[k] = mv.w[k];
      }
    } else {
#pragma unroll
      for (int e = 0; e < kGroup; ++e) {
        const long long i = i0 + e;
        if (i < p.n) apply<T>(p, to_f32(x[i]), bits[e], out[i], mask[i]);
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, out and mask hold n contiguous elements. threshold =
// uint64(p * 2^32); one_minus_p = float(1 - p); upscale: 1 for upscale_in_train. The seed is
// `seed` when counter is null, else seed_of(program_seed, *counter, salt) (philox.cuh).
// Returns a cudaError_t (0 = launched).
extern "C" int dropout_fwd(const void* x, void* out, void* mask, long long n, int dtype,
                           unsigned long long threshold, float one_minus_p, int upscale,
                           unsigned long long seed, const void* counter,
                           unsigned long long program_seed, unsigned long long salt, int grid,
                           void* stream) {
  if (n <= 0 || grid <= 0 || (dtype != 0 && dtype != 1) || threshold > (1ull << 32))
    return cudaErrorInvalidValue;
  Params p;
  p.n = n;
  p.threshold = threshold;
  p.one_minus_p = one_minus_p;
  p.upscale = upscale;
  p.zero_out = upscale && threshold == (1ull << 32);
  p.vector = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out) |
               reinterpret_cast<uintptr_t>(mask)) & 15u) == 0;
  p.rng = {static_cast<const long long*>(counter), program_seed, salt, seed};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dropout_kernel<float><<<grid, kThreads, 0, st>>>(static_cast<const float*>(x),
                                                     static_cast<float*>(out),
                                                     static_cast<float*>(mask), p);
  else
    dropout_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out),
        static_cast<__nv_bfloat16*>(mask), p);
  return cudaGetLastError();
}
