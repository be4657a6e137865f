// Keccak-f[1600], shared by kernel K (keccak.cu, Merkle hashing) and
// kernel S (fri.cu, the FRI transcript sponge).
//
// The 25 lanes a[x + 5y] are 64-bit words; every index below is a
// compile-time constant, so a caller that keeps its state in a local array
// keeps it in registers. The 24 rounds stay a loop (#pragma unroll 1),
// which keeps the code of a kernel that inlines several permutations small.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__constant__ uint64_t kRoundConstants[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
    0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};

__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));  // r in [1, 63]
}

// Keccak-f[1600] on the state a[x + 5y].
__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    const uint64_t c0 = a[0] ^ a[5] ^ a[10] ^ a[15] ^ a[20];
    const uint64_t c1 = a[1] ^ a[6] ^ a[11] ^ a[16] ^ a[21];
    const uint64_t c2 = a[2] ^ a[7] ^ a[12] ^ a[17] ^ a[22];
    const uint64_t c3 = a[3] ^ a[8] ^ a[13] ^ a[18] ^ a[23];
    const uint64_t c4 = a[4] ^ a[9] ^ a[14] ^ a[19] ^ a[24];
    const uint64_t d0 = c4 ^ rotl(c1, 1);
    const uint64_t d1 = c0 ^ rotl(c2, 1);
    const uint64_t d2 = c1 ^ rotl(c3, 1);
    const uint64_t d3 = c2 ^ rotl(c4, 1);
    const uint64_t d4 = c3 ^ rotl(c0, 1);
    const uint64_t b0 = a[0] ^ d0;
    const uint64_t b1 = rotl(a[6] ^ d1, 44);
    const uint64_t b2 = rotl(a[12] ^ d2, 43);
    const uint64_t b3 = rotl(a[18] ^ d3, 21);
    const uint64_t b4 = rotl(a[24] ^ d4, 14);
    const uint64_t b5 = rotl(a[3] ^ d3, 28);
    const uint64_t b6 = rotl(a[9] ^ d4, 20);
    const uint64_t b7 = rotl(a[10] ^ d0, 3);
    const uint64_t b8 = rotl(a[16] ^ d1, 45);
    const uint64_t b9 = rotl(a[22] ^ d2, 61);
    const uint64_t b10 = rotl(a[1] ^ d1, 1);
    const uint64_t b11 = rotl(a[7] ^ d2, 6);
    const uint64_t b12 = rotl(a[13] ^ d3, 25);
    const uint64_t b13 = rotl(a[19] ^ d4, 8);
    const uint64_t b14 = rotl(a[20] ^ d0, 18);
    const uint64_t b15 = rotl(a[4] ^ d4, 27);
    const uint64_t b16 = rotl(a[5] ^ d0, 36);
    const uint64_t b17 = rotl(a[11] ^ d1, 10);
    const uint64_t b18 = rotl(a[17] ^ d2, 15);
    const uint64_t b19 = rotl(a[23] ^ d3, 56);
    const uint64_t b20 = rotl(a[2] ^ d2, 62);
    const uint64_t b21 = rotl(a[8] ^ d3, 55);
    const uint64_t b22 = rotl(a[14] ^ d4, 39);
    const uint64_t b23 = rotl(a[15] ^ d0, 41);
    const uint64_t b24 = rotl(a[21] ^ d1, 2);
    a[0] = b0 ^ (~b1 & b2);
    a[1] = b1 ^ (~b2 & b3);
    a[2] = b2 ^ (~b3 & b4);
    a[3] = b3 ^ (~b4 & b0);
    a[4] = b4 ^ (~b0 & b1);
    a[5] = b5 ^ (~b6 & b7);
    a[6] = b6 ^ (~b7 & b8);
    a[7] = b7 ^ (~b8 & b9);
    a[8] = b8 ^ (~b9 & b5);
    a[9] = b9 ^ (~b5 & b6);
    a[10] = b10 ^ (~b11 & b12);
    a[11] = b11 ^ (~b12 & b13);
    a[12] = b12 ^ (~b13 & b14);
    a[13] = b13 ^ (~b14 & b10);
    a[14] = b14 ^ (~b10 & b11);
    a[15] = b15 ^ (~b16 & b17);
    a[16] = b16 ^ (~b17 & b18);
    a[17] = b17 ^ (~b18 & b19);
    a[18] = b18 ^ (~b19 & b15);
    a[19] = b19 ^ (~b15 & b16);
    a[20] = b20 ^ (~b21 & b22);
    a[21] = b21 ^ (~b22 & b23);
    a[22] = b22 ^ (~b23 & b24);
    a[23] = b23 ^ (~b24 & b20);
    a[24] = b24 ^ (~b20 & b21);
    a[0] ^= kRoundConstants[round];
  }
}
