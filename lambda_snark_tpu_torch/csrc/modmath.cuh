// Modular arithmetic on native 64-bit words, used by quotient.cu,
// ring_commit.cu and ntt.cu (butterfly.cuh holds the NTT stages).
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
//
// Q45Shoup is the 44-bit field with lazy Shoup/Harvey butterflies (kShoup):
// a product by a known constant w (a twiddle or a table entry) takes its
// companion w' = floor(w 2^64 / q) and gives w x - umulhi(x, w') q, which
// lies in [0, 2q) for any x < 2^64; words stay in [0, 2q) through DIF
// stages and in [0, 4q) through DIT stages, with one conditional subtract
// per butterfly, and are reduced (reduce2, reduce4) where they leave a
// kernel or meet another word in a product (mul, Barrett on canonical
// inputs). The canonical fields have kShoup = false and ignore w'.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct Goldilocks {
  static constexpr bool kShoup = false;
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
  static constexpr bool kShoup = false;
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

struct Q45Shoup : Q45 {
  static constexpr bool kShoup = true;
  static constexpr uint64_t P2 = 2 * P;

  // w x mod q in [0, 2q) for any x, w < q and ws = floor(w 2^64 / q)
  __device__ __forceinline__ static uint64_t mul_tw(uint64_t x, uint64_t w, uint64_t ws) {
    return x * w - __umul64hi(x, ws) * P;
  }
  __device__ __forceinline__ static uint64_t reduce2(uint64_t x) {  // [0, 2q) -> [0, q)
    return x >= P ? x - P : x;
  }
  __device__ __forceinline__ static uint64_t reduce4(uint64_t x) {  // [0, 4q) -> [0, q)
    return reduce2(x >= P2 ? x - P2 : x);
  }
  // Gentleman-Sande: a, b in [0, 2q) -> a + b, (a - b) w, both in [0, 2q)
  __device__ __forceinline__ static void dif(uint64_t& a, uint64_t& b, uint64_t w,
                                             uint64_t ws) {
    const uint64_t s = a + b;
    b = mul_tw(a - b + P2, w, ws);
    a = s >= P2 ? s - P2 : s;
  }
  // Cooley-Tukey: a, b in [0, 4q) -> a + b w, a - b w, both in [0, 4q)
  __device__ __forceinline__ static void dit(uint64_t& a, uint64_t& b, uint64_t w,
                                             uint64_t ws) {
    const uint64_t u = a >= P2 ? a - P2 : a;
    const uint64_t t = mul_tw(b, w, ws);
    a = u + t;
    b = u - t + P2;
  }
};

struct Barrett {
  static constexpr bool kShoup = false;
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
