// NTT stages in registers over a swizzled shared-memory tile, shared by
// kernel T (ntt.cu), kernel Q (quotient.cu) and kernel R (ring_commit.cu).
//
// Positions follow the radix-2 stages of an n-point transform: DIF stage s
// (n/2 > 2^s >= 1, run from the top down) pairs positions i0 and i0 + 2^s
// (bit s of i0 clear) into (u + v, (u - v) t) and DIT stage s (run from
// the bottom up) into (u + v t, u - v t), with t = omega^(j n / 2^(s+1)),
// j = i0 mod 2^s, read from a twiddle table (StridedTwiddles or
// StageTwiddles). A field with kShoup (modmath.cuh) also reads the table's
// Shoup companions.
//
// A thread runs R consecutive stages on the 2^R words they couple, held in
// registers: word k of a group sits at lo + k 2^lo_bits (lo < 2^lo_bits),
// and the stages run lo_bits + R - 1 down to lo_bits (DIF) or up (DIT).
// Radix 8 (R = 3) takes three stages per round trip through the tile and
// one __syncthreads, where a radix-2 stage takes one each.
//
// The tile is XOR-swizzled: word i lives at swz(i), so any 16 threads whose
// indices differ in 4 consecutive bits touch 16 distinct bank pairs, and
// strided loads and stores, bit-reversed gathers and every pass run without
// bank conflicts (64-bit words: 16 threads per wavefront).
#pragma once

#include "modmath.cuh"

__device__ __forceinline__ int swz(int i) {
  return i ^ (((i >> 4) ^ (i >> 8) ^ (i >> 12)) & 15);
}

// One DIF butterfly on (a, b) with twiddle w (and companion ws).
template <class F>
__device__ __forceinline__ void dif_bf(const F& f, uint64_t& a, uint64_t& b, uint64_t w,
                                       uint64_t ws) {
  if constexpr (F::kShoup) {
    F::dif(a, b, w, ws);
  } else {
    const uint64_t u = a, v = b;
    a = f.add(u, v);
    b = f.mul(f.sub(u, v), w);
  }
}

// One DIT butterfly on (a, b) with twiddle w (and companion ws).
template <class F>
__device__ __forceinline__ void dit_bf(const F& f, uint64_t& a, uint64_t& b, uint64_t w,
                                       uint64_t ws) {
  if constexpr (F::kShoup) {
    F::dit(a, b, w, ws);
  } else {
    const uint64_t t = f.mul(b, w);
    b = f.sub(a, t);
    a = f.add(a, t);
  }
}

// x times a known constant w: Shoup's product with companion ws, in
// [0, 2q), for a kShoup field; the canonical product otherwise.
template <class F>
__device__ __forceinline__ uint64_t mul_tab(const F& f, uint64_t x, uint64_t w, uint64_t ws) {
  if constexpr (F::kShoup) return F::mul_tw(x, w, ws);
  else return f.mul(x, w);
}

// Canonical from [0, 2q) (after DIF stages or mul_tab) and from [0, 4q)
// (after DIT stages); the identity for canonical fields.
template <class F>
__device__ __forceinline__ uint64_t canon2(const F&, uint64_t x) {
  if constexpr (F::kShoup) return F::reduce2(x);
  else return x;
}
template <class F>
__device__ __forceinline__ uint64_t canon4(const F&, uint64_t x) {
  if constexpr (F::kShoup) return F::reduce4(x);
  else return x;
}

template <class I>
__device__ __forceinline__ uint64_t ldg_word(const uint64_t* __restrict__ p, I i) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p) + i);
}

// Entry i of a table's Shoup companion for a kShoup field, else 0 (the
// canonical fields pass no companion tables).
template <class F, class I>
__device__ __forceinline__ uint64_t ldg_shoup(const F&, const uint64_t* __restrict__ ws, I i) {
  if constexpr (F::kShoup) return ldg_word(ws, i);
  else return 0;
}

// x - y for canonical x and y in [0, 4q) (after DIT stages): in [0, 2q)
// for a kShoup field, canonical otherwise.
template <class F>
__device__ __forceinline__ uint64_t sub_lazy(const F& f, uint64_t x, uint64_t y) {
  if constexpr (F::kShoup) return x + F::P - F::reduce4(y);
  else return f.sub(x, y);
}

// Twiddles as kernel T stores them: w[e] = omega^e for e < n/2, stage s's
// twiddle at j read as w[j << (log_n - 1 - s)] (strided across a warp).
struct StridedTwiddles {
  const uint64_t* w;
  int log_n;
  __device__ __forceinline__ int index(int s, int j) const { return j << (log_n - 1 - s); }
};

// Stage-major twiddles (kernels Q and R): w[2^s + j] is stage s's twiddle
// at j, so the twiddles of consecutive j are consecutive words; ws holds
// their Shoup companions for a kShoup field (null otherwise).
struct StageTwiddles {
  const uint64_t* w;
  const uint64_t* ws;
  __device__ __forceinline__ int index(int s, int j) const { return (1 << s) + j; }
};

// R DIF (kDit false) or DIT stages on the 2^R words e[] of one group, in
// registers: word k sits at position lo + k 2^lo_bits of its transform;
// the stages run from lo_bits + R - 1 down to lo_bits, or up from lo_bits.
// R = 0 runs none.
template <int R, bool kDit, class F, class Tw>
__device__ __forceinline__ void stages(const F& f, uint64_t* e, const Tw& tw, int lo,
                                       int lo_bits) {
  constexpr int K = 1 << R;
#pragma unroll
  for (int n = 0; n < R; ++n) {
    const int sr = kDit ? n : R - 1 - n;  // stage lo_bits + sr
    const int half = 1 << sr;
    uint64_t w[K > 1 ? K / 2 : 1], ws[K > 1 ? K / 2 : 1];
#pragma unroll
    for (int kk = 0; kk < half; ++kk) {
      const int idx = tw.index(lo_bits + sr, lo + (kk << lo_bits));
      w[kk] = ldg_word(tw.w, idx);
      if constexpr (F::kShoup) ws[kk] = ldg_word(tw.ws, idx);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k & half) continue;
      if constexpr (kDit) dit_bf(f, e[k], e[k + half], w[k & (half - 1)], ws[k & (half - 1)]);
      else dif_bf(f, e[k], e[k + half], w[k & (half - 1)], ws[k & (half - 1)]);
    }
  }
}

template <int R, class F, class Tw>
__device__ __forceinline__ void dif_stages(const F& f, uint64_t* e, const Tw& tw, int lo,
                                           int lo_bits) {
  stages<R, false>(f, e, tw, lo, lo_bits);
}

template <int R, class F, class Tw>
__device__ __forceinline__ void dit_stages(const F& f, uint64_t* e, const Tw& tw, int lo,
                                           int lo_bits) {
  stages<R, true>(f, e, tw, lo, lo_bits);
}

// R stages (DIF or DIT) from lo_bits on every group of 2^R words that they
// couple in `subs` sub-tiles of 2^sub_bits words, one after another in the
// tile: ld(i) reads word i of the tile, st(i, v) writes it. Within a
// sub-tile consecutive threads vary 4 consecutive index bits: the low ones
// when there are 4 below the group's, else the ones above it.
template <int R, int NT, bool kDit, class F, class Tw, class Ld, class St>
__device__ __forceinline__ void radix_groups(const F& f, const Tw& tw, int sub_bits, int subs,
                                             int lo_bits, const Ld& ld, const St& st) {
  constexpr int K = 1 << R;
  const int hi_bits = sub_bits - lo_bits - R;
  const int groups = subs << (sub_bits - R);
  for (int g = threadIdx.x; g < groups; g += NT) {
    const int gi = g & ((1 << (sub_bits - R)) - 1);
    int lo, hi;
    if (lo_bits >= 4 || hi_bits < 4) {
      lo = gi & ((1 << lo_bits) - 1);
      hi = gi >> lo_bits;
    } else {
      hi = gi & ((1 << hi_bits) - 1);
      lo = gi >> hi_bits;
    }
    const int base = (g >> (sub_bits - R) << sub_bits) | lo | (hi << (lo_bits + R));
    uint64_t e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = ld(base + (k << lo_bits));
    stages<R, kDit>(f, e, tw, lo, lo_bits);
#pragma unroll
    for (int k = 0; k < K; ++k) st(base + (k << lo_bits), e[k]);
  }
}

// Word off + i of the swizzled tile s: a sub-tile as a load (ref(i)) and a
// store (ref(i, v)).
struct TileRef {
  uint64_t* s;
  int off;
  __device__ __forceinline__ uint64_t operator()(int i) const { return s[swz(off + i)]; }
  __device__ __forceinline__ void operator()(int i, uint64_t v) const { s[swz(off + i)] = v; }
};

// Three (R = 3), two or one DIF stages, st down to st - R + 1, on the
// swizzled tile s, shared memory to registers and back.
template <int R, int NT, class F>
__device__ __forceinline__ void radix_pass(const F& f, uint64_t* s,
                                           const uint64_t* __restrict__ tw, int log_n,
                                           int tile_bits, int st) {
  const TileRef tile{s, 0};
  radix_groups<R, NT, false>(f, StridedTwiddles{tw, log_n}, tile_bits, 1, st - R + 1, tile,
                             tile);
}

template <int NT, bool kDit, class F, class Tw, class Ld, class St>
__device__ __forceinline__ void radix_groups_r(int r, const F& f, const Tw& tw, int sub_bits,
                                               int subs, int lo_bits, const Ld& ld,
                                               const St& st) {
  if (r == 3) radix_groups<3, NT, kDit>(f, tw, sub_bits, subs, lo_bits, ld, st);
  else if (r == 2) radix_groups<2, NT, kDit>(f, tw, sub_bits, subs, lo_bits, ld, st);
  else radix_groups<1, NT, kDit>(f, tw, sub_bits, subs, lo_bits, ld, st);
}

// Every stage below log_sub (>= 1) of `subs` sub-transforms of 2^log_sub
// words, one after another in a tile, in passes of three stages: a DIF
// starts with the 1-3 top stages and a DIT ends with the 1-3 top ones. The
// first pass reads through first(i), the last writes through last(i, v),
// every other access goes to the sub-tile `tile`; a __syncthreads follows
// each pass but the last.
template <int NT, bool kDit, class F, class Tw, class First, class Last>
__device__ __forceinline__ void tile_stages(const F& f, const TileRef& tile, const Tw& tw,
                                            int log_sub, int subs, const First& first,
                                            const Last& last) {
  const int passes = (log_sub + 2) / 3;
  const int odd = log_sub - 3 * (passes - 1);  // stages in the pass nearest the top
  if (passes == 1) {
    radix_groups_r<NT, kDit>(odd, f, tw, log_sub, subs, 0, first, last);
    return;
  }
  // DIF: the top `odd` stages, then threes down to 0; DIT: threes from 0,
  // then the top `odd`
  if constexpr (kDit) radix_groups<3, NT, true>(f, tw, log_sub, subs, 0, first, tile);
  else radix_groups_r<NT, false>(odd, f, tw, log_sub, subs, log_sub - odd, first, tile);
  __syncthreads();
  for (int p = 1; p < passes - 1; ++p) {
    const int lo_bits = kDit ? 3 * p : log_sub - odd - 3 * p;
    radix_groups<3, NT, kDit>(f, tw, log_sub, subs, lo_bits, tile, tile);
    __syncthreads();
  }
  if constexpr (kDit) {
    radix_groups_r<NT, true>(odd, f, tw, log_sub, subs, log_sub - odd, tile, last);
  } else {
    radix_groups<3, NT, false>(f, tw, log_sub, subs, 0, tile, last);
  }
}
