// Attention-dropout bits shared by the flash-attention forward and backward kernels.
//
// Replaces the TPU's in-kernel generator (pltpu.prng_seed / prng_random_bits in
// paddle_tpu/ops/pallas_attention.py::_probs), which has no counterpart here. The bits come
// from Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC'11),
// a counter-based generator: key = the 64-bit seed (low word, high word), counter =
// (key column / 4, query row, batch*heads + head, 0), and word (key column % 4) of the output
// is the element's 32 bits. The bits of an element depend only on (seed, b, h, row, col),
// never on the tile shape, so the backward kernels regenerate the forward's mask exactly,
// and the plain PyTorch version (ops/flash_attention.py::philox_keep_mask) computes the
// same bits with integer tensor arithmetic.
//
// An element is kept when its bits are >= uint32(p * 2^32), as the TPU kernel decides.

#pragma once

#include <stdint.h>

namespace flash_philox {

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

// The four words for key columns 4*col4 .. 4*col4+3 of query row `row`.
__device__ __forceinline__ uint4 dropout_bits4(unsigned long long seed, uint32_t bh,
                                               uint32_t row, uint32_t col4) {
  return philox4x32_10(make_uint4(col4, row, bh, 0u), uint32_t(seed), uint32_t(seed >> 32));
}

__device__ __forceinline__ uint32_t word(const uint4& r, int i) {
  return i == 0 ? r.x : i == 1 ? r.y : i == 2 ? r.z : r.w;
}

// The bits of one element (one generator call per element: for layouts where neighbouring
// key columns do not sit in one thread).
__device__ __forceinline__ uint32_t dropout_bits(unsigned long long seed, uint32_t bh,
                                                 uint32_t row, uint32_t col) {
  return word(dropout_bits4(seed, bh, row, col >> 2), col & 3);
}

}  // namespace flash_philox
