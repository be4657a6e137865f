// Kernels N and T: batched cyclic NTTs over 64-bit words, natural order in
// and out, X_k = sum_t x_t w^(t k), for Goldilocks, the 44-bit field and any
// q < 2^47 (modmath.cuh's fields); the inverse is the same transform with
// w^-1 and 1/n folded into the store.
//
// Kernel T replaces the TPU kernel ntt_pallas.py::ntt_forward_pallas /
// ntt_inverse_pallas (_run_kernel, pallas_call at ops/ntt_pallas.py:126:
// a (D, TB, S) digit-plane tile resident in VMEM through all log2 S
// roll-based DIT stages, bit reversal outside). Here a row tile stays in
// shared memory through all stages and no bit-reversal pass exists: entry
// ntt_rows, S <= 2^13. Past one tile the same kernel runs as a four-step
// (entry ntt_four_step), two passes up to 2^26 points and one more for
// every further factor of at most 2^13 (the decomposition is built in
// ops/ntt_large.py).
//
// Kernel N replaces the TPU kernels ntt_mxu.py::ntt_forward_mxu_packed
// (_leaf_packed, pallas_call at ops/ntt_mxu.py:631: four-step with
// radix-128 int8-matmul leaves, twiddles fused into the leaf) and its leaf
// ntt_mxu.py::dft_matmul_apply_pallas (_leaf_kernel, pallas_call at
// ops/ntt_mxu.py:378), and carries the kind-7 LDE that the JAX package runs
// as XLA (ntt_large._forward). Since kernel T generalised it, kernel N is
// ntt_four_step with Goldilocks tables and its leaf is ntt_rows.
//
// With x[j C + b] = X[j, b] the four-step of m = R C points is
//
//   pass 1: A[h, b] = sum_j X[j, b] w_R^(j h) * w^(h b)   (R-point, columns)
//   pass 2: out[h + R g] = sum_b A[h, b] w_C^(b g)        (C-point, rows)
//
// and where C is past one tile, pass 2 is itself a four-step over each row
// of A. Each pass is one launch of dft_pass, described by an NttPass: a
// block loads a tile of independent sub-transforms into shared memory,
// runs a decimation-in-frequency transform on each (natural in,
// bit-reversed out) and gathers the results in natural order on the way
// out. Pass 1 multiplies by w^(h b) in its store, read from a table laid
// out in the store's order (w^(h b) at h C + b), so consecutive threads
// read consecutive words. Optional tables fold elementwise products into
// the first load (pre[t], a psi^t twist) and the last store (post[k], a
// psi^-k / n untwist), and a scalar (1/n for the inverse) into the last
// store.
//
// What bounds it: at 64 rows x 2^17 (the kind-7 LDE at m = 2^14) it moves
// 2 x 2 x 64 MiB through device memory (each pass reads and writes every
// word once) and does 64 x 2^16 x 17 Goldilocks butterflies, so integer
// instructions bound it; a row transform at S <= 2^13 reads and writes each
// word once and does S/2 log2 S butterflies per row, integer-bound as well.
// Design:
// - a tile of up to 2^12 words per block (2^13 for a 2^13-point
//   sub-transform), 256 threads; consecutive threads touch consecutive
//   addresses on both load and store (the index order follows whichever of
//   the element and sub-transform strides is 1);
// - the tile is XOR-swizzled: word i of the tile lives at
//   i ^ ((i >> 4 ^ i >> 8 ^ i >> 12) & 15), so any 16 threads whose indices
//   differ in 4 consecutive bits touch 16 distinct bank pairs: the strided
//   load and store, the bit-reversed gather and every butterfly pass run
//   without bank conflicts (64-bit words: 16 threads per wavefront);
// - each thread runs radix-8 butterflies (three stages) on words held in
//   registers, radix 2, 4 or 8 for the first stages: the first stages run
//   on the words as they come from device memory and the last three on
//   the words on their way back, so the words of a 2^9-point sub-transform
//   go into the tile and out of it twice (where the old kernel made ten
//   round trips, one a stage), with one __syncthreads per three stages in
//   between; twiddles are read through the read-only cache;
// - the shared-memory attribute is set once per process and field type.
// The swizzle, the register stages and the radix passes live in
// butterfly.cuh, shared with kernels Q and R.
#include "butterfly.cuh"

constexpr int kThreads = 256;
constexpr int kLogTile = 12;     // words a block takes of shorter sub-transforms
constexpr int kMaxLogN = 13;     // the longest sub-transform: one 64 KiB tile
constexpr int kMaxLevels = 4;

// One pass over `rows` rows of row_stride words. Its sub-transforms are
// indexed u = sum_l d_l 2^(sum_{l' < l} log_count[l']), digit d_l <
// 2^log_count[l]; sub-transform u reads element i at row offset
// sum_l d_l in_stride[l] + i in_elem and writes X_k at
// sum_l d_l out_stride[l] + k out_elem (x and y may be the same buffer:
// each block writes only where it read). Within a row, the load multiplies
// by pre[pos & tab_mask], the store by pw[pos & pw_mask], post[pos &
// tab_mask] and scale, each when given. tw[e] = w_n^e, e < n/2.
struct NttPass {
  const uint64_t* x;
  uint64_t* y;
  const uint64_t* tw;
  const uint64_t* pw;
  const uint64_t* pre;
  const uint64_t* post;
  uint64_t scale;
  long long row_stride;
  unsigned int pw_mask, tab_mask;
  unsigned int in_elem, out_elem;
  unsigned int in_stride[kMaxLevels], out_stride[kMaxLevels];
  int log_count[kMaxLevels];
  int levels, log_n, rows, reserved;
};

// Where a block's sub-transforms and their words lie in its rows.
struct Tile {
  int log_n, log_per, per_mask;
  unsigned int in0, out0, in_sub, out_sub;
};

// The first R stages straight from device memory: group (t, lo) holds words
// lo + k 2^(log_n - R) of sub-transform t; it is loaded (times pre), run
// through the stages and written to the tile.
template <int R, class F>
__device__ __forceinline__ void first_pass(const F& f, const NttPass& p, const Tile& T,
                                           const uint64_t* x, uint64_t* s) {
  constexpr int K = 1 << R;
  const int lo_bits = T.log_n - R;
  const int groups = 1 << (lo_bits + T.log_per);
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    int t, lo;
    if (p.in_elem == 1) {
      lo = g & ((1 << lo_bits) - 1);
      t = g >> lo_bits;
    } else {
      t = g & T.per_mask;
      lo = g >> T.log_per;
    }
    uint64_t e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const unsigned int pos = T.in0 + t * T.in_sub + (lo + (k << lo_bits)) * p.in_elem;
      e[k] = x[pos];
      if (p.pre != nullptr) e[k] = f.mul(e[k], p.pre[pos & p.tab_mask]);
    }
    dif_stages<R>(f, e, StridedTwiddles{p.tw, T.log_n}, lo, lo_bits);
#pragma unroll
    for (int k = 0; k < K; ++k) s[swz((t << T.log_n) | (lo + (k << lo_bits)))] = e[k];
  }
}

// The last three stages into device memory: group (t, kb) holds tile words
// rev(kb) + r, r < 8, whose results are X_k at k = kb + rev3(r) n/8;
// consecutive threads take consecutive kb, so the store is coalesced and
// the tile reads conflict-free.
template <class F>
__device__ __forceinline__ void last_pass(const F& f, const NttPass& p, const Tile& T,
                                          const uint64_t* s, uint64_t* y) {
  const int kb_bits = T.log_n - 3;
  const int groups = 1 << (kb_bits + T.log_per);
  for (int g = threadIdx.x; g < groups; g += kThreads) {
    int t, kb;
    if (p.out_elem == 1) {
      kb = g & ((1 << kb_bits) - 1);
      t = g >> kb_bits;
    } else {
      t = g & T.per_mask;
      kb = g >> T.log_per;
    }
    const int base = (t << T.log_n) | bitrev(kb, T.log_n);
    uint64_t e[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) e[r] = s[swz(base + r)];
    dif_stages<3>(f, e, StridedTwiddles{p.tw, T.log_n}, 0, 0);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int k = kb + (((r & 1) << 2 | (r & 2) | (r >> 2)) << kb_bits);
      const unsigned int pos = T.out0 + t * T.out_sub + k * p.out_elem;
      uint64_t v = e[r];
      if (p.pw != nullptr) v = f.mul(v, p.pw[pos & p.pw_mask]);
      if (p.post != nullptr) v = f.mul(v, p.post[pos & p.tab_mask]);
      if (p.scale != 1) v = f.mul(v, p.scale);
      y[pos] = v;
    }
  }
}

template <class F>
__global__ void __launch_bounds__(kThreads) dft_pass(F f, NttPass p, int log_per) {
  extern __shared__ uint64_t s[];
  Tile T;
  T.log_n = p.log_n;
  T.log_per = log_per;
  T.per_mask = (1 << log_per) - 1;
  const int log_n = p.log_n;
  const int n = 1 << log_n;
  const int tile_bits = log_n + log_per;
  const int total = 1 << tile_bits;
  int log_subs = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l)
    if (l < p.levels) log_subs += p.log_count[l];
  const int log_bpr = log_subs - log_per;  // blocks per row, log2
  const long long row = (long long)blockIdx.x >> log_bpr;
  // the block's first sub-transform and its offsets; the block's `per`
  // sub-transforms differ in digit 0 only (log_per <= log_count[0])
  unsigned int u = (blockIdx.x & ((1u << log_bpr) - 1)) << log_per;
  T.in0 = 0;
  T.out0 = 0;
#pragma unroll
  for (int l = 0; l < kMaxLevels; ++l) {
    if (l < p.levels) {
      const unsigned int d = u & ((1u << p.log_count[l]) - 1);
      u >>= p.log_count[l];
      T.in0 += d * p.in_stride[l];
      T.out0 += d * p.out_stride[l];
    }
  }
  T.in_sub = p.levels > 0 ? p.in_stride[0] : 0;
  T.out_sub = p.levels > 0 ? p.out_stride[0] : 0;
  const uint64_t* x = p.x + row * p.row_stride;
  uint64_t* y = p.y + row * p.row_stride;

  if (log_n >= 4) {
    // stages: r0 = 1..3 from device memory, threes through the tile, the
    // last three into device memory
    const int r0 = (log_n - 4) % 3 + 1;
    if (r0 == 1) first_pass<1>(f, p, T, x, s);
    else if (r0 == 2) first_pass<2>(f, p, T, x, s);
    else first_pass<3>(f, p, T, x, s);
    __syncthreads();
    for (int st = log_n - 1 - r0; st > 2; st -= 3) {
      radix_pass<3, kThreads>(f, s, p.tw, log_n, tile_bits, st);
      __syncthreads();
    }
    last_pass(f, p, T, s, y);
    return;
  }

  // n <= 8: the tile in, one pass of log_n stages, the tile out
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    int t, i;
    if (p.in_elem == 1) {
      t = idx >> log_n;
      i = idx & (n - 1);
    } else {
      t = idx & T.per_mask;
      i = idx >> log_per;
    }
    const unsigned int pos = T.in0 + t * T.in_sub + i * p.in_elem;
    uint64_t v = x[pos];
    if (p.pre != nullptr) v = f.mul(v, p.pre[pos & p.tab_mask]);
    s[swz((t << log_n) | i)] = v;
  }
  __syncthreads();
  if (log_n == 3) radix_pass<3, kThreads>(f, s, p.tw, log_n, tile_bits, 2);
  else if (log_n == 2) radix_pass<2, kThreads>(f, s, p.tw, log_n, tile_bits, 1);
  else radix_pass<1, kThreads>(f, s, p.tw, log_n, tile_bits, 0);
  __syncthreads();
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    int t, k;
    if (p.out_elem == 1) {
      t = idx >> log_n;
      k = idx & (n - 1);
    } else {
      t = idx & T.per_mask;
      k = idx >> log_per;
    }
    const unsigned int pos = T.out0 + t * T.out_sub + k * p.out_elem;
    uint64_t v = s[swz((t << log_n) | bitrev(k, log_n))];
    if (p.pw != nullptr) v = f.mul(v, p.pw[pos & p.pw_mask]);
    if (p.post != nullptr) v = f.mul(v, p.post[pos & p.tab_mask]);
    if (p.scale != 1) v = f.mul(v, p.scale);
    y[pos] = v;
  }
}

template <class F>
static int set_smem_once() {
  static const cudaError_t err = cudaFuncSetAttribute(
      dft_pass<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(uint64_t) << kMaxLogN));
  return (int)err;
}

template <class F>
static int launch_pass(F f, const NttPass& p, cudaStream_t stream) {
  if (p.log_n < 1 || p.log_n > kMaxLogN || p.levels < 0 || p.levels > kMaxLevels ||
      p.rows < 0)
    return (int)cudaErrorInvalidValue;
  if (p.rows == 0) return 0;
  int log_subs = 0;
  for (int l = 0; l < p.levels; ++l) log_subs += p.log_count[l];
  // sub-transforms per block: up to 2^kLogTile words, within digit 0
  int log_per = kLogTile - p.log_n;
  if (log_per < 0) log_per = 0;
  if (p.levels == 0) log_per = 0;
  else if (log_per > p.log_count[0]) log_per = p.log_count[0];
  const long long grid = (long long)p.rows << (log_subs - log_per);
  if (log_subs - log_per > 30 || grid > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  const int rc = set_smem_once<F>();
  if (rc != 0) return rc;
  const int smem = (int)(sizeof(uint64_t) << (p.log_n + log_per));
  dft_pass<F><<<(unsigned)grid, kThreads, smem, stream>>>(f, p, log_per);
  return (int)cudaGetLastError();
}

// `count` passes, one launch each, in order, over modulus q.
extern "C" int ntt_four_step(const NttPass* passes, int count, uint64_t q,
                             cudaStream_t stream) {
  return with_field(q, [&](auto f) {
    for (int i = 0; i < count; ++i) {
      const int rc = launch_pass(f, passes[i], stream);
      if (rc != 0) return rc;
    }
    return 0;
  });
}

// One pass of independent row transforms over modulus q (the pass's level
// indexes the rows of a group, its rows the groups).
extern "C" int ntt_rows(const NttPass* pass, uint64_t q, cudaStream_t stream) {
  return with_field(q, [&](auto f) { return launch_pass(f, *pass, stream); });
}
