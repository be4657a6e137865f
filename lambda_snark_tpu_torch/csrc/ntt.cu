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
// ntt_rows, S <= 2^13. Past one tile the same kernel runs twice as a
// four-step (entry ntt_four_step, up to 2^26 points).
//
// Kernel N replaces the TPU kernels ntt_mxu.py::ntt_forward_mxu_packed
// (_leaf_packed, pallas_call at ops/ntt_mxu.py:631: four-step with
// radix-128 int8-matmul leaves, twiddles fused into the leaf) and its leaf
// ntt_mxu.py::dft_matmul_apply_pallas (_leaf_kernel, pallas_call at
// ops/ntt_mxu.py:378), and carries the kind-7 LDE that the JAX package runs
// as XLA (ntt_large._forward). Since kernel T generalised it, kernel N is
// ntt_four_step with Goldilocks tables and its leaf is ntt_rows.
//
// With x[j C + b] = X[j, b] the four-step is
//
//   pass 1: A[h, b] = sum_j X[j, b] w_R^(j h) * w^(h b)   (R-point, columns)
//   pass 2: out[h + R g] = sum_b A[h, b] w_C^(b g)        (C-point, rows)
//
// Each pass is one launch of dft_pass: a block loads a tile of independent
// sub-transforms into shared memory, runs a decimation-in-frequency
// transform on each (natural in, bit-reversed out) and gathers the results
// in natural order on the way out. Pass 1 multiplies by the twiddle
// w^(h b) in its store; pass 2 stores transposed. Optional tables fold
// elementwise products into the load (pre[t], a psi^t twist) and the store
// (post[k], a psi^-k / n untwist) of the whole transform, and a scalar
// (1/n for the inverse) into the last store.
//
// What bounds it: at 64 rows x 2^16 (the kind-7 LDE) it moves 2 x 2 x 32 MiB
// through device memory (each pass reads and writes every word once) and
// does 64 x 2^15 x 16 Goldilocks butterflies (33.6 M modular products plus
// 4.2 M twiddle products), so integer instructions bound it; a row transform
// at S <= 2^13 reads and writes each word once and does S/2 log2 S
// butterflies per row, integer-bound as well. Design: a tile of at most 8192
// words (64 KiB of shared memory, opted in) per block, so three blocks share
// an SM; consecutive threads touch consecutive addresses on both load and
// store (the index order follows whichever of the element and
// sub-transform strides is 1).
#include "modmath.cuh"

constexpr int kThreads = 512;
constexpr int kTileWords = 8192;

// Sub-transform u of row r reads x[r*row_stride + u*in_sub + i*in_elem]
// (i < n) and writes X_k to y[r*row_stride + u*out_sub + k*out_elem]. Within
// the row, the load multiplies by pre[pos mod 2^log_m] and the store by
// pw[(k u) mod 2^log_m], post[pos mod 2^log_m] and scale, each when given
// (pos the word's offset in its row). tw[e] = w_n^e, e < n/2. Each block
// takes `per` consecutive sub-transforms of one row.
template <class F>
__global__ void __launch_bounds__(kThreads) dft_pass(
    F f, const uint64_t* __restrict__ x, uint64_t* __restrict__ y,
    const uint64_t* __restrict__ tw, const uint64_t* __restrict__ pw,
    const uint64_t* __restrict__ pre, const uint64_t* __restrict__ post,
    uint64_t scale, int log_m, int log_n, int log_per, int blocks_per_row,
    long long row_stride, long long in_sub, long long in_elem,
    long long out_sub, long long out_elem) {
  extern __shared__ uint64_t s[];
  const int n = 1 << log_n;
  const int per_mask = (1 << log_per) - 1;
  const long long m_mask = (1ll << log_m) - 1;
  const long long row = blockIdx.x / blocks_per_row;
  const long long u0 = (long long)(blockIdx.x % blocks_per_row) << log_per;
  const long long base = row * row_stride;
  const int total = n << log_per;

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int t, i;
    if (in_elem == 1) {
      t = idx >> log_n;
      i = idx & (n - 1);
    } else {
      t = idx & per_mask;
      i = idx >> log_per;
    }
    const long long pos = (u0 + t) * in_sub + i * in_elem;
    uint64_t v = x[base + pos];
    if (pre != nullptr) v = f.mul(v, pre[pos & m_mask]);
    s[(t << log_n) + i] = v;
  }
  __syncthreads();

  // DIF over every sub-transform of the tile at once: butterfly i of a stage
  // lies in sub-transform i >> (log_n - 1), as the index formula keeps.
  const int half_total = total >> 1;
  for (int st = log_n - 1; st >= 0; --st) {
    const int half = 1 << st;
    const int step = log_n - 1 - st;
    for (int i = threadIdx.x; i < half_total; i += blockDim.x) {
      const int j = i & (half - 1);
      const int i0 = ((i >> st) << (st + 1)) | j;
      const uint64_t a = s[i0], b = s[i0 + half];
      s[i0] = f.add(a, b);
      s[i0 + half] = f.mul(f.sub(a, b), tw[j << step]);
    }
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    int t, k;
    if (out_elem == 1) {
      t = idx >> log_n;
      k = idx & (n - 1);
    } else {
      t = idx & per_mask;
      k = idx >> log_per;
    }
    const long long u = u0 + t;
    const long long pos = u * out_sub + k * out_elem;
    uint64_t v = s[(t << log_n) + bitrev(k, log_n)];
    if (pw != nullptr) v = f.mul(v, pw[(k * u) & m_mask]);
    if (post != nullptr) v = f.mul(v, post[pos & m_mask]);
    if (scale != 1) v = f.mul(v, scale);
    y[base + pos] = v;
  }
}

// log2 of the sub-transforms per block: the most that fit a tile and
// divide `subs` (a power of two or not).
static int tile_log(int log_n, long long subs) {
  int lp = 0;
  while ((1ll << (log_n + lp + 1)) <= kTileWords && subs % (2ll << lp) == 0)
    ++lp;
  return lp;
}

template <class F>
static int launch_pass(F f, const uint64_t* x, uint64_t* y, const uint64_t* tw,
                       const uint64_t* pw, const uint64_t* pre,
                       const uint64_t* post, uint64_t scale, int log_m,
                       int log_n, int rows, long long subs, long long row_stride,
                       long long in_sub, long long in_elem, long long out_sub,
                       long long out_elem, cudaStream_t stream) {
  if (log_n < 1 || (1 << log_n) > kTileWords) return (int)cudaErrorInvalidValue;
  const int log_per = tile_log(log_n, subs);
  const long long blocks_per_row = subs >> log_per;
  const long long grid = blocks_per_row * rows;
  const int smem = (int)(sizeof(uint64_t) << (log_n + log_per));
  if (grid > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dft_pass<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(uint64_t) * kTileWords));
  if (err != cudaSuccess) return (int)err;
  dft_pass<F><<<(unsigned)grid, kThreads, smem, stream>>>(
      f, x, y, tw, pw, pre, post, scale, log_m, log_n, log_per,
      (int)blocks_per_row, row_stride, in_sub, in_elem, out_sub, out_elem);
  return (int)cudaGetLastError();
}

// rows x m over modulus q, m = 2^(log_r + log_c): pass 1 x -> tmp, pass 2
// tmp -> y. tw_r, tw_c: w_R^e (e < R/2), w_C^e (e < C/2); pw: w^e (e < m);
// pre, post: (m,) tables or null; scale: 1, or 1/m for the inverse.
extern "C" int ntt_four_step(const uint64_t* x, uint64_t* tmp, uint64_t* y,
                             const uint64_t* tw_r, const uint64_t* tw_c,
                             const uint64_t* pw, const uint64_t* pre,
                             const uint64_t* post, uint64_t scale, uint64_t q,
                             int log_r, int log_c, int rows,
                             cudaStream_t stream) {
  return with_field(q, [&](auto f) {
    const int log_m = log_r + log_c;
    const long long m = 1ll << log_m, r = 1ll << log_r, c = 1ll << log_c;
    int rc = launch_pass(f, x, tmp, tw_r, pw, pre, nullptr, 1, log_m, log_r,
                         rows, c, m, 1, c, 1, c, stream);
    if (rc != 0) return rc;
    return launch_pass(f, tmp, y, tw_c, nullptr, nullptr, post, scale, log_m,
                       log_c, rows, r, m, c, 1, 1, r, stream);
  });
}

// `count` independent length-2^log_b transforms of contiguous rows over
// modulus q, each word of the result times scale (1, or 1/b).
extern "C" int ntt_rows(const uint64_t* x, uint64_t* y, const uint64_t* tw,
                        uint64_t scale, uint64_t q, int log_b, int count,
                        cudaStream_t stream) {
  return with_field(q, [&](auto f) {
    const long long b = 1ll << log_b;
    return launch_pass(f, x, y, tw, nullptr, nullptr, nullptr, scale, log_b,
                       log_b, 1, count, 0, b, 1, b, 1, stream);
  });
}
