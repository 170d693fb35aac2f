// Attention-probs dropout bits, shared by the forward (K2) and backward (K3)
// kernels so the backward regenerates the forward's mask exactly.
//
// An element of P is kept when its 32 bits are >= threshold
// (round(rate * 2^32)) and then scaled by keep_scale (1 / (1 - rate) in f32),
// as vln_imagine_tpu/ops/attention.py:_dropout_mask.  Two sources, the same
// bits as the plain versions in ops/attention.py:
//
//   kBitsHash   the JAX package's _hash_mask_bits over one batch item's
//               [H, Lq, Lk] block (the CPU stand-in for the TPU's PRNG), at
//               head h + head_offset
//   kBitsPhilox Philox-4x32-10, counter (k, q, h + head_offset,
//               b + row_offset), key (seed lo, seed hi), first output word;
//               row_offset is the global batch row of the call's row 0, so
//               that a rank of a data-parallel step draws its rows' bits of
//               the global batch, and head_offset the model's head of the
//               call's head 0, so that a rank of a tensor-parallel step
//               draws its heads' bits
#pragma once

#include <stdint.h>

namespace vln {

constexpr int kBitsNone = 0;
constexpr int kBitsHash = 1;
constexpr int kBitsPhilox = 2;

struct DropoutParams {
  int bits;            // kBitsNone: no dropout
  uint32_t threshold;  // keep when bits >= threshold
  float keep_scale;    // value of a kept element's mask
  uint64_t seed;
  uint32_t row_offset;   // global batch row of the call's row 0 (Philox)
  uint32_t head_offset;  // the model's head of the call's head 0
};

__device__ __forceinline__ uint32_t hash_bits(uint32_t h, uint32_t q,
                                              uint32_t k) {
  uint32_t x = (h * 2654435761u) ^ (q * 40503u) ^ (k * 69069u);
  x = (x ^ (x >> 15)) * 0x2C1B3C6Du;
  x = (x ^ (x >> 12)) * 0x297A2D39u;
  return x ^ (x >> 15);
}

__device__ __forceinline__ uint32_t philox_bits(uint64_t seed, uint32_t b,
                                                uint32_t h, uint32_t q,
                                                uint32_t k) {
  uint32_t c0 = k, c1 = q, c2 = h, c3 = b;
  uint32_t k0 = static_cast<uint32_t>(seed);
  uint32_t k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c0;
}

// The mask value of element (b, h, q, k): 0 or keep_scale.
__device__ __forceinline__ float dropout_mask(const DropoutParams& d, int b,
                                              int h, int q, int k) {
  const uint32_t hh = h + d.head_offset;
  const uint32_t bits = d.bits == kBitsHash
                            ? hash_bits(hh, q, k)
                            : philox_bits(d.seed, b + d.row_offset, hh, q, k);
  return bits >= d.threshold ? d.keep_scale : 0.f;
}

// Whether element (b, h, q, k) is kept: the same bits as dropout_mask.
__device__ __forceinline__ bool dropout_keep(const DropoutParams& d, int b,
                                             int h, int q, int k) {
  return dropout_mask(d, b, h, q, k) != 0.f;
}

}  // namespace vln
