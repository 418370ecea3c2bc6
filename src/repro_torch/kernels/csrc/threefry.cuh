// Threefry-2x32 (20 rounds) on the device, bit for bit the draws of
// prng.py, which are those of jax.random under the default
// jax_threefry_partitionable=True:
//
//   split(key, num)[i]     = threefry(key, (0, i)), both output words;
//   random_bits(key)[idx]  = b0 ^ b1 of threefry(key, (idx >> 32, idx)),
//                            idx the element's flat index in the draw's shape;
//   uniform                = bitcast((bits >> 9) | 0x3F800000) - 1.0f;
//   bernoulli(0.5)         = uniform < 0.5f.
//
// About 100 32-bit integer operations a draw: 20 add-rotate-xor rounds and
// five key injections.
#pragma once

#include <stdint.h>

struct Key2x32 {
  uint32_t k0, k1;
};

__host__ __device__ inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__host__ __device__ inline Key2x32 threefry2x32(Key2x32 key, uint32_t x0,
                                                uint32_t x1) {
  const uint32_t ks[3] = {key.k0, key.k1, key.k0 ^ key.k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int step = 0; step < 5; ++step) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl32(x1, rot[step % 2][i]) ^ x0;
    }
    x0 += ks[(step + 1) % 3];
    x1 += ks[(step + 2) % 3] + (uint32_t)(step + 1);
  }
  return {x0, x1};
}

// split(key, num)[i]
__host__ __device__ inline Key2x32 threefry_split(Key2x32 key, uint32_t i) {
  return threefry2x32(key, 0u, i);
}

// random_bits(key, shape) at flat index idx
__host__ __device__ inline uint32_t threefry_bits(Key2x32 key, uint64_t idx) {
  const Key2x32 b = threefry2x32(key, (uint32_t)(idx >> 32), (uint32_t)idx);
  return b.k0 ^ b.k1;
}

// uniform(key, shape) at flat index idx: float32 in [0, 1)
__device__ inline float threefry_uniform(Key2x32 key, uint64_t idx) {
  const uint32_t bits = (threefry_bits(key, idx) >> 9) | 0x3F800000u;
  return __fsub_rn(__uint_as_float(bits), 1.0f);
}

// The key of a lane from its (2,) int64 words, each holding 32 bits.
__host__ __device__ inline Key2x32 key_of(const int64_t* words) {
  return {(uint32_t)words[0], (uint32_t)words[1]};
}
