// Modular arithmetic on native 64-bit words and the shared-memory radix-2
// NTT stages used by quotient.cu, ring_commit.cu and ntt.cu.
//
// A residue is one uint64_t. Products go through __umul64hi:
// - Goldilocks p = 2^64 - 2^32 + 1 reduces a 128-bit product with
//   2^64 = 2^32 - 1 and 2^96 = -1 (mod p);
// - the 44-bit field prime q = 2^44 - 16982015 reduces by Barrett with
//   k = 44: mu = floor(2^88 / q), q1 = t >> 43, q3 = (q1 mu) >> 45,
//   r = t - q3 q < 3q (Q45, every constant known to the compiler);
// - any other q < 2^47 reduces by the same Barrett with k, mu and q read at
//   run time (Barrett): t < q^2 < 2^94, so q1 mu < 2^96 needs its high word
//   from __umul64hi.
// A field is a value: Goldilocks and Q45 are empty and their members
// static, Barrett carries (q, mu, k); kernels take the field as an argument
// and with_field() picks the type for a modulus at launch.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct Goldilocks {
  static constexpr uint64_t P = 0xFFFFFFFF00000001ull;
  static constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

  __device__ __forceinline__ static uint64_t add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    if (s < a) s += EPS;  // wrapped: s + 2^64 = s + EPS, and that stays < p
    return s >= P ? s - P : s;
  }
  __device__ __forceinline__ static uint64_t sub(uint64_t a, uint64_t b) {
    uint64_t d = a - b;
    return a < b ? d - EPS : d;  // d = a - b + 2^64; want a - b + p
  }
  __device__ __forceinline__ static uint64_t mul(uint64_t a, uint64_t b) {
    uint64_t lo = a * b, hi = __umul64hi(a, b);
    uint64_t hh = hi >> 32, hl = hi & EPS;
    uint64_t t0 = lo - hh;  // hh weighs 2^96 = -1
    if (lo < hh) t0 -= EPS;
    uint64_t t1 = hl * EPS;  // hl weighs 2^64 = 2^32 - 1
    uint64_t r = t0 + t1;
    if (r < t1) r += EPS;
    return r >= P ? r - P : r;
  }
};

struct Q45 {
  static constexpr uint64_t P = 17592169062401ull;   // 44 bits
  static constexpr uint64_t MU = 17592203026447ull;  // floor(2^88 / P)

  __device__ __forceinline__ static uint64_t add(uint64_t a, uint64_t b) {
    uint64_t s = a + b;
    return s >= P ? s - P : s;
  }
  __device__ __forceinline__ static uint64_t sub(uint64_t a, uint64_t b) {
    return a >= b ? a - b : a - b + P;
  }
  __device__ __forceinline__ static uint64_t mul(uint64_t a, uint64_t b) {
    uint64_t lo = a * b, hi = __umul64hi(a, b);  // t < 2^88
    uint64_t q1 = (hi << 21) | (lo >> 43);       // t >> 43 < 2^45
    uint64_t q2lo = q1 * MU, q2hi = __umul64hi(q1, MU);
    uint64_t q3 = (q2hi << 19) | (q2lo >> 45);   // (q1 mu) >> 45
    uint64_t r = lo - q3 * P;                    // true value < 3P
    if (r >= P) r -= P;
    if (r >= P) r -= P;
    return r;
  }
};

struct Barrett {
  uint64_t P, MU;  // q < 2^47 and floor(2^(2k) / q)
  int K;           // bit length of q

  __device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) const {
    uint64_t s = a + b;
    return s >= P ? s - P : s;
  }
  __device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) const {
    return a >= b ? a - b : a - b + P;
  }
  __device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) const {
    uint64_t lo = a * b, hi = __umul64hi(a, b);     // t < 2^(2k)
    uint64_t q1 = (hi << (65 - K)) | (lo >> (K - 1));  // t >> (k-1) < 2^(k+1)
    uint64_t q2lo = q1 * MU, q2hi = __umul64hi(q1, MU);
    uint64_t q3 = (q2hi << (63 - K)) | (q2lo >> (K + 1));  // (q1 mu) >> (k+1)
    uint64_t r = lo - q3 * P;  // true value < 3q
    if (r >= P) r -= P;
    if (r >= P) r -= P;
    return r;
  }
};

// Calls fn(field) with the field type for modulus q: Goldilocks, Q45, or
// Barrett for any other 1 < q < 2^47; returns fn's result, or
// cudaErrorInvalidValue for a modulus outside that range.
template <class Fn>
int with_field(uint64_t q, Fn&& fn) {
  if (q == Goldilocks::P) return fn(Goldilocks{});
  if (q == Q45::P) return fn(Q45{});
  if (q < 2 || q >= (1ull << 47)) return (int)cudaErrorInvalidValue;
  const int k = 64 - __builtin_clzll(q);
  const uint64_t mu = (uint64_t)(((unsigned __int128)1 << (2 * k)) / q);
  return fn(Barrett{q, mu, k});
}

// Bit reversal of i < 2^log_n.
__device__ __forceinline__ int bitrev(int i, int log_n) {
  return (int)(__brev((unsigned)i) >> (32 - log_n));
}

// Decimation in frequency over x[0, 2^log_n) in shared memory: natural
// order in, bit-reversed order out, X[rev(i)] = sum_t x_t w^(t i).
// tw[e] = w^e for e < n/2. The caller synchronises before; this returns
// synchronised.
template <class F>
__device__ void dif(uint64_t* x, const uint64_t* __restrict__ tw, int log_n) {
  const int half_n = 1 << (log_n - 1);
  for (int s = log_n - 1; s >= 0; --s) {
    const int half = 1 << s;
    const int step = log_n - 1 - s;  // twiddle exponent stride n / (2 half)
    for (int i = threadIdx.x; i < half_n; i += blockDim.x) {
      const int j = i & (half - 1);
      const int i0 = ((i >> s) << (s + 1)) | j;
      const uint64_t u = x[i0], v = x[i0 + half];
      x[i0] = F::add(u, v);
      x[i0 + half] = F::mul(F::sub(u, v), tw[j << step]);
    }
    __syncthreads();
  }
}

// Decimation in time: bit-reversed order in, natural order out,
// X_k = sum_t x_t w^(t k) for x_t stored at rev(t).
template <class F>
__device__ void dit(uint64_t* x, const uint64_t* __restrict__ tw, int log_n) {
  const int half_n = 1 << (log_n - 1);
  for (int s = 0; s < log_n; ++s) {
    const int half = 1 << s;
    const int step = log_n - 1 - s;
    for (int i = threadIdx.x; i < half_n; i += blockDim.x) {
      const int j = i & (half - 1);
      const int i0 = ((i >> s) << (s + 1)) | j;
      const uint64_t u = x[i0], v = F::mul(x[i0 + half], tw[j << step]);
      x[i0] = F::add(u, v);
      x[i0 + half] = F::sub(u, v);
    }
    __syncthreads();
  }
}
