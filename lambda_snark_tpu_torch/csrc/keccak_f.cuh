// Keccak-f[1600] in two forms:
//
// - keccak_f, one thread a state, for kernel K (keccak.cu, Merkle hashing),
//   where thousands of independent hashes hide each other's latency. The
//   25 lanes a[x + 5y] are 64-bit words; every index below is a
//   compile-time constant, so a caller that keeps its state in a local array
//   keeps it in registers. The 24 rounds stay a loop (#pragma unroll 1),
//   which keeps the code of a kernel that inlines several permutations small.
// - KeccakWarp, one warp a state, for kernels S and F (fri.cu, the FRI
//   transcript sponge), where each permutation hashes the last one's digest
//   and nothing hides its latency (below).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

// The round constants: immediates wherever the round is a compile-time
// constant (KeccakWarp's unrolled rounds), and kRoundConstants for
// keccak_f's loop.
__host__ __device__ constexpr uint64_t keccak_round_constant(int round) {
  constexpr uint64_t rc[24] = {
      0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull,
      0x8000000080008000ull, 0x000000000000808Bull, 0x0000000080000001ull,
      0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008Aull,
      0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
      0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull,
      0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
      0x000000000000800Aull, 0x800000008000000Aull, 0x8000000080008081ull,
      0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull};
  return rc[round];
}

__constant__ uint64_t kRoundConstants[24] = {
    keccak_round_constant(0),  keccak_round_constant(1),  keccak_round_constant(2),
    keccak_round_constant(3),  keccak_round_constant(4),  keccak_round_constant(5),
    keccak_round_constant(6),  keccak_round_constant(7),  keccak_round_constant(8),
    keccak_round_constant(9),  keccak_round_constant(10), keccak_round_constant(11),
    keccak_round_constant(12), keccak_round_constant(13), keccak_round_constant(14),
    keccak_round_constant(15), keccak_round_constant(16), keccak_round_constant(17),
    keccak_round_constant(18), keccak_round_constant(19), keccak_round_constant(20),
    keccak_round_constant(21), keccak_round_constant(22), keccak_round_constant(23)};

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

// --- KeccakWarp: one permutation spread over a warp -------------------------
//
// Lane t < 25 of the warp holds a[t] (t = x + 5y); lanes 25-31 run the same
// code on copies and are never read. A round, per lane:
//
//   theta  C[x] from the 4 other lanes of its column (4 shuffles), then
//          C[x - 1] and C[x + 1] from lanes x - 1 and x + 1 (2 shuffles),
//          a ^= C[x - 1] ^ rotl(C[x + 1], 1);
//   rho    the lane's own rotation (a per-lane amount: a half swap for
//          amounts >= 32, then two 32-bit funnel shifts);
//   pi+chi B[p] = rho'd lane PI_SRC[p] (the pi source of position p), so
//          a[p] = B[p] ^ (~B[p + 1 in x] & B[p + 2 in x]) reads the three
//          rho'd lanes PI_SRC[p], PI_SRC[p+1], PI_SRC[p+2] in one level of
//          3 shuffles;
//   iota   lane 0 xors the round constant.
//
// A round's latency is three levels of shuffles and a few logic ops, where
// one thread holding the whole state issues some 190 instructions a round
// into 16-lane integer pipes. The 24 rounds are unrolled with the round
// constants as immediates: read from kRoundConstants, ptxas hoisted them
// into 48 registers and interleaved theta's shuffles with their xors, and
// a permutation took 1.6 times as long (scripts/sponge_candidates.cu). A
// 64-bit shuffle is two 32-bit ones.
struct KeccakWarp {
  int col[4];              // the other lanes of this lane's column
  int left, right;         // lanes x - 1 and x + 1 of row 0
  int pi0, pi1, pi2;       // the pi sources of positions p, p + 1, p + 2 (in x)
  int shift;               // rho amount mod 32
  bool swap, first;        // rho amount >= 32; lane 0

  __device__ explicit KeccakWarp(int lane) {
    const int t = lane < 25 ? lane : lane - 25;
    const int x = t % 5, y = t / 5;
#pragma unroll
    for (int k = 0; k < 4; ++k) col[k] = (t + 5 * (k + 1)) % 25;
    left = (x + 4) % 5;
    right = (x + 1) % 5;
    // position (X, Y) takes lane (x, y) = ((X + 3Y) mod 5, X): X = y, Y = 2x + 3y
    pi0 = (x + 3 * y) % 5 + 5 * x;
    pi1 = ((x + 1) % 5 + 3 * y) % 5 + 5 * ((x + 1) % 5);
    pi2 = ((x + 2) % 5 + 3 * y) % 5 + 5 * ((x + 2) % 5);
    constexpr int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                              25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
    shift = kRho[t] & 31;
    swap = kRho[t] >= 32;
    first = lane == 0;
  }

  __device__ __forceinline__ static uint64_t shfl(uint64_t v, int src) {
    const uint32_t lo = __shfl_sync(0xFFFFFFFFu, (uint32_t)v, src);
    const uint32_t hi = __shfl_sync(0xFFFFFFFFu, (uint32_t)(v >> 32), src);
    return ((uint64_t)hi << 32) | lo;
  }

  // rotl(v, rho amount of this lane)
  __device__ __forceinline__ uint64_t rho(uint64_t v) const {
    const uint32_t lo = (uint32_t)v, hi = (uint32_t)(v >> 32);
    const uint32_t h = swap ? lo : hi, l = swap ? hi : lo;
    return ((uint64_t)__funnelshift_l(l, h, shift) << 32) | __funnelshift_l(h, l, shift);
  }

  // This lane's word of Keccak-f[1600] applied to the warp's state.
  __device__ __forceinline__ uint64_t permute(uint64_t a) const {
#pragma unroll
    for (int round = 0; round < 24; ++round) {
      const uint64_t c = a ^ shfl(a, col[0]) ^ shfl(a, col[1]) ^ shfl(a, col[2]) ^ shfl(a, col[3]);
      const uint64_t cl = shfl(c, left), cr = shfl(c, right);
      const uint64_t b = rho(a ^ cl ^ rotl(cr, 1));
      const uint64_t b0 = shfl(b, pi0), b1 = shfl(b, pi1), b2 = shfl(b, pi2);
      a = b0 ^ (~b1 & b2);
      if (first) a ^= keccak_round_constant(round);
    }
    return a;
  }
};
