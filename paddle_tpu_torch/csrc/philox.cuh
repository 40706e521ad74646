// Attention-dropout bits shared by the flash-attention forward and backward kernels.
//
// Replaces the TPU's in-kernel generator (pltpu.prng_seed / prng_random_bits in
// paddle_tpu/ops/pallas_attention.py::_probs), which has no counterpart here. The bits come
// from Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11),
// a counter-based generator keyed by the 64-bit seed (low word, high word).
//
// Mask layout. Element (query row r, key column c) of head bh = b * H + h takes
//   counter = (c / 2, (r / 16) * 8 + r % 8, bh, 0),   word = 2 * ((r % 16) / 8) + c % 2
// of the generator's output. One call thus serves the four elements that one thread holds
// in an m16n8 mma accumulator fragment in the forward orientation (query rows as M): rows
// r and r + 8 of a 16-row group, key columns 2c and 2c + 1, in the fragment's own element
// order (words x, y: row r; z, w: row r + 8). A bf16 kernel that computes scores with query
// rows as M makes 0.25 calls per element. The bits depend only on (seed, b, h, r, c), never
// on the tile shape, so the backward kernels regenerate the forward's mask exactly, and a
// ragged S is a prefix of a wider one. The plain PyTorch version
// (ops/flash_attention.py::philox_keep_mask) computes the same bits with integer tensor
// arithmetic.
//
// An element is kept when its bits are >= uint32(p * 2^32), as the TPU kernel decides.
//
// The seed. A kernel takes it either by value or as a SeedSource: a pointer to the run
// counter on the card (a one-element int64 tensor the executor writes before each run), the
// program seed and the op's salt. run_seed then computes in the kernel what the host's
// core/registry.py::seed_int computes: three splitmix64 rounds over (program seed, counter,
// salt & 0x7FFFFFFF), cut to 63 bits, all in unsigned 64-bit arithmetic that wraps as the
// host masks to 64 bits. A CUDA graph that captured the launch thus draws the masks of the
// counter written before each replay, and an eager launch with the same counter draws the
// same ones.
//
// Cost: a call is 10 rounds of two 32x32 -> 64-bit multiplies, xors and key additions. At
// 0.25 calls per element that is 6.3 M calls for one BERT-base attention (B 128, H 12, S 128),
// 0.024 ms of the forward on an H100 (PERF.md): after the bytes, the largest part of the
// training-shape kernels.

#pragma once

#include <stdint.h>

namespace flash_philox {

// One splitmix64 round folding v into h (core/registry.py::_mix).
__host__ __device__ __forceinline__ unsigned long long mix64(unsigned long long h,
                                                             unsigned long long v) {
  h = (h ^ v) + 0x9E3779B97F4A7C15ull;
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ull;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBull;
  return h ^ (h >> 31);
}

struct SeedSource {
  const long long* counter;         // the run counter on the card; null: take `seed`
  unsigned long long program_seed;  // Program.random_seed
  unsigned long long salt;          // the op's salt (+ offset); masked to 31 bits below
  unsigned long long seed;          // the seed by value, when counter is null
};

// The 64-bit Philox key of one op in one run (core/registry.py::seed_int).
__host__ __device__ __forceinline__ unsigned long long seed_of(unsigned long long program_seed,
                                                               unsigned long long counter,
                                                               unsigned long long salt) {
  return mix64(mix64(mix64(0ull, program_seed), counter), salt & 0x7FFFFFFFull) &
         0x7FFFFFFFFFFFFFFFull;
}

__device__ __forceinline__ unsigned long long run_seed(const SeedSource& s) {
  if (s.counter == nullptr) return s.seed;
  return seed_of(s.program_seed, static_cast<unsigned long long>(*s.counter), s.salt);
}

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const uint32_t lo0 = 0xD2511F53u * c.x, hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z, hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// The counter's second word for query row r: (r / 16) * 8 + r % 8.
__device__ __forceinline__ uint32_t frag_row(uint32_t row) { return ((row >> 4) << 3) | (row & 7u); }

// The four words of the fragment whose top-left element is (row, key): row % 16 < 8 and key
// even. x: (row, key), y: (row, key + 1), z: (row + 8, key), w: (row + 8, key + 1).
__device__ __forceinline__ uint4 dropout_bits4(unsigned long long seed, uint32_t bh,
                                               uint32_t row, uint32_t key) {
  return philox4x32_10(make_uint4(key >> 1, frag_row(row), bh, 0u), uint32_t(seed),
                       uint32_t(seed >> 32));
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The bits of one element, one generator call each (the f32 kernels, one row per thread).
__device__ __forceinline__ uint32_t dropout_bits(unsigned long long seed, uint32_t bh,
                                                 uint32_t row, uint32_t key) {
  return word(dropout_bits4(seed, bh, row, key), int(((row >> 3) & 1u) * 2u + (key & 1u)));
}

}  // namespace flash_philox
