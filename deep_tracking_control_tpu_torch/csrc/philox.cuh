// Philox4x32-10, the counter-based generator of the port's noise.
//
// Salmon, Moraes, Dror and Shaw, "Parallel random numbers: as easy as
// 1, 2, 3" (SC'11), with the Random123 constants.  The card has no
// generator of its own to take the place of the TPU core's
// (pltpu.prng_random_bits), so every kernel that draws noise calls this
// function: the same (key, counter) gives the same four words in every
// kernel and in the plain PyTorch version (ops/cuda_rng.py `philox4x32`).
//
// Counter layout of the port: flat element i of an output is word i % 4 of
// philox(key, {lo(i / 4), hi(i / 4), stream, 0}); the key is the two low
// words of the (2,) int64 seed.  Bits map to floats as the JAX kernel maps
// them (experimental/pallas_rng.py:41-46): ((bits >> 9) as int) * 2^-22 - 1,
// exact in float32, in [-1, 1).
#pragma once

#include <stdint.h>

struct PhiloxOut {
    uint32_t w[4];
};

__device__ __forceinline__ PhiloxOut philox4x32_10(uint32_t c0, uint32_t c1,
                                                   uint32_t c2, uint32_t c3,
                                                   uint32_t k0, uint32_t k1) {
    const uint32_t M0 = 0xD2511F53u, M1 = 0xCD9E8D57u;
    const uint32_t W0 = 0x9E3779B9u, W1 = 0xBB67AE85u;
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        if (r) {
            k0 += W0;
            k1 += W1;
        }
        const uint32_t hi0 = __umulhi(M0, c0), lo0 = M0 * c0;
        const uint32_t hi1 = __umulhi(M1, c2), lo1 = M1 * c2;
        const uint32_t n0 = hi1 ^ c1 ^ k0, n2 = hi0 ^ c3 ^ k1;
        c0 = n0;
        c1 = lo1;
        c2 = n2;
        c3 = lo0;
    }
    PhiloxOut o;
    o.w[0] = c0;
    o.w[1] = c1;
    o.w[2] = c2;
    o.w[3] = c3;
    return o;
}

// The four words of counter block `blk` (= flat index / 4) on `stream`.
__device__ __forceinline__ PhiloxOut philox_block(long long blk, uint32_t stream,
                                                  uint32_t k0, uint32_t k1) {
    return philox4x32_10((uint32_t)(blk & 0xffffffffLL), (uint32_t)(blk >> 32),
                         stream, 0u, k0, k1);
}

__device__ __forceinline__ float bits_to_pm1(uint32_t b) {
    // (b >> 9) < 2^23 converts exactly; the product is exact and so is the
    // difference (a multiple of 2^-22 in [-1, 1)), with or without an FMA
    return __fsub_rn(__fmul_rn((float)(int)(b >> 9), 0x1p-22f), 1.0f);
}

// The key of a (2,) int64 seed in device memory: its two low words.
__device__ __forceinline__ void philox_key(const long long* seed, uint32_t& k0,
                                           uint32_t& k1) {
    k0 = (uint32_t)((unsigned long long)seed[0] & 0xffffffffull);
    k1 = (uint32_t)((unsigned long long)seed[1] & 0xffffffffull);
}
