// Kernel Q: the batched odd-coset quotient, one block per proof row.
//
// Replaces the TPU kernels quotient_pallas.py::quotient_batch_fused
// (_quotient_kernel, pallas_call at ops/quotient_pallas.py:143) and
// ntt_mxu_q45.py::quotient_batch_mxu (_leaf_apply, pallas_call at
// ops/ntt_mxu_q45.py:466). Per row, with w = psi^2 a primitive m-th root:
//
//   a, b, c evals (natural) --DIF(w^-1)--> m * poly (bit-reversed)
//     poly_k = that / m, written out in natural order (A, B, C)
//     * psi^k / m --DIT(w)--> odd-coset evals poly(psi w^t) (natural)
//   N = a_odd * b_odd - c_odd --DIF(w^-1)--> * psi^-k / (m (-2)) --> Q_k
//
// valid[row] = 1 iff a_t * b_t == c_t at every t (the even-coset residual).
//
// A row past one block's shared memory (m > 2^13) takes the long route, a
// chain of kernel T launches (ntt.cu's four-step) around one elementwise
// entry here, quotient_pointwise: interpolate a, b, c (inverse, 1/m in the
// store), psi-twist in the load of the forward transform onto the odd
// coset, N = a_odd b_odd - c_odd with the residual check (this entry), and
// the inverse with psi^-k / (m (-2)) in its store. Device memory then sees
// every intermediate once; ops/quotient.py drives the chain.
//
// What bounds it: at m = 4096, B = 256 it moves 7 x 8 MiB but does
// 7 * 12 * 2048 * 256 = 44 M butterflies with one 64-bit modular product
// each, so integer instructions, not bytes, bound it. Design: the row lives
// in shared memory (two buffers of m words, 64 KiB at m = 4096) for all
// seven transforms, so device memory sees each input once and each output
// once; DIF/DIT pairing removes every bit-reversal pass; outputs are
// gathered from shared memory so global stores stay coalesced.
#include "modmath.cuh"

constexpr int kThreads = 512;

// x holds evals in natural order; on return it holds odd-coset evals in
// natural order and poly_out the interpolated coefficients.
template <class F>
__device__ void to_odd(uint64_t* x, uint64_t* __restrict__ poly_out,
                       const uint64_t* __restrict__ tw_inv,
                       const uint64_t* __restrict__ tw_fwd,
                       const uint64_t* __restrict__ twist, uint64_t inv_m,
                       int log_m) {
  const int m = 1 << log_m;
  __syncthreads();
  dif<F>(x, tw_inv, log_m);
  for (int t = threadIdx.x; t < m; t += blockDim.x)
    poly_out[t] = F::mul(x[bitrev(t, log_m)], inv_m);
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += blockDim.x)
    x[i] = F::mul(x[i], twist[bitrev(i, log_m)]);
  __syncthreads();
  dit<F>(x, tw_fwd, log_m);
}

template <class F>
__global__ void __launch_bounds__(kThreads) quotient_kernel(
    const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
    const uint64_t* __restrict__ c, const uint64_t* __restrict__ tw_inv,
    const uint64_t* __restrict__ tw_fwd, const uint64_t* __restrict__ twist,
    const uint64_t* __restrict__ untwist, uint64_t inv_m,
    uint64_t* __restrict__ q_out, uint64_t* __restrict__ a_out,
    uint64_t* __restrict__ b_out, uint64_t* __restrict__ c_out,
    int32_t* __restrict__ valid, int log_m) {
  extern __shared__ uint64_t smem[];
  const int m = 1 << log_m;
  uint64_t* x = smem;
  uint64_t* y = smem + m;
  const size_t row = (size_t)blockIdx.x * m;

  int bad = 0;
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    const uint64_t av = a[row + t], bv = b[row + t];
    x[t] = av;
    y[t] = bv;
    bad |= F::mul(av, bv) != c[row + t];
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) valid[blockIdx.x] = bad ? 0 : 1;

  to_odd<F>(x, a_out + row, tw_inv, tw_fwd, twist, inv_m, log_m);
  to_odd<F>(y, b_out + row, tw_inv, tw_fwd, twist, inv_m, log_m);
  for (int t = threadIdx.x; t < m; t += blockDim.x) {
    x[t] = F::mul(x[t], y[t]);
    y[t] = c[row + t];
  }
  to_odd<F>(y, c_out + row, tw_inv, tw_fwd, twist, inv_m, log_m);
  for (int t = threadIdx.x; t < m; t += blockDim.x) x[t] = F::sub(x[t], y[t]);
  __syncthreads();
  dif<F>(x, tw_inv, log_m);
  for (int t = threadIdx.x; t < m; t += blockDim.x)
    q_out[row + t] = F::mul(x[bitrev(t, log_m)], untwist[t]);
}

template <class F>
static int launch(const uint64_t* a, const uint64_t* b, const uint64_t* c,
                  const uint64_t* tw_inv, const uint64_t* tw_fwd,
                  const uint64_t* twist, const uint64_t* untwist,
                  uint64_t inv_m, uint64_t* q_out, uint64_t* a_out,
                  uint64_t* b_out, uint64_t* c_out, int32_t* valid, int rows,
                  int log_m, cudaStream_t stream) {
  const int smem = (int)(2 * sizeof(uint64_t)) << log_m;
  cudaError_t err = cudaFuncSetAttribute(
      quotient_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  quotient_kernel<F><<<rows, kThreads, smem, stream>>>(
      a, b, c, tw_inv, tw_fwd, twist, untwist, inv_m, q_out, a_out, b_out,
      c_out, valid, log_m);
  return (int)cudaGetLastError();
}

#define QUOTIENT_ENTRY(NAME, FIELD)                                          \
  extern "C" int NAME(const uint64_t* a, const uint64_t* b,                  \
                      const uint64_t* c, const uint64_t* tw_inv,             \
                      const uint64_t* tw_fwd, const uint64_t* twist,         \
                      const uint64_t* untwist, uint64_t inv_m,               \
                      uint64_t* q_out, uint64_t* a_out, uint64_t* b_out,     \
                      uint64_t* c_out, int32_t* valid, int rows, int log_m,  \
                      cudaStream_t stream) {                                 \
    return launch<FIELD>(a, b, c, tw_inv, tw_fwd, twist, untwist, inv_m,     \
                         q_out, a_out, b_out, c_out, valid, rows, log_m,     \
                         stream);                                            \
  }

QUOTIENT_ENTRY(quotient_q45, Q45)
QUOTIENT_ENTRY(quotient_goldilocks, Goldilocks)

// The long route's pointwise step: n = a_odd b_odd - c_odd over rows x 2^log_m
// words, and valid[row] = 0 where some a_t b_t != c_t (the caller sets
// valid to 1 first). Block b takes words [b * kChunk, (b + 1) * kChunk) of
// row b / chunks, so a block's residual flag belongs to one row.
constexpr int kChunk = 4096;

template <class F>
__global__ void __launch_bounds__(kThreads) pointwise_kernel(
    F f, const uint64_t* __restrict__ a_odd, const uint64_t* __restrict__ b_odd,
    const uint64_t* __restrict__ c_odd, const uint64_t* __restrict__ a,
    const uint64_t* __restrict__ b, const uint64_t* __restrict__ c,
    uint64_t* __restrict__ n_out, int32_t* __restrict__ valid, int log_m,
    int chunks) {
  const long long row = blockIdx.x / chunks;
  const int chunk_len = min(kChunk, 1 << log_m);
  const long long start =
      (row << log_m) + (long long)(blockIdx.x % chunks) * chunk_len;
  int bad = 0;
  for (int i = threadIdx.x; i < chunk_len; i += blockDim.x) {
    const long long t = start + i;
    n_out[t] = f.sub(f.mul(a_odd[t], b_odd[t]), c_odd[t]);
    bad |= f.mul(a[t], b[t]) != c[t];
  }
  bad = __syncthreads_or(bad);
  if (bad && threadIdx.x == 0) valid[row] = 0;
}

extern "C" int quotient_pointwise(const uint64_t* a_odd, const uint64_t* b_odd,
                                  const uint64_t* c_odd, const uint64_t* a,
                                  const uint64_t* b, const uint64_t* c,
                                  uint64_t* n_out, int32_t* valid, uint64_t q,
                                  int rows, int log_m, cudaStream_t stream) {
  return with_field(q, [&](auto f) {
    const int chunks = log_m > 12 ? 1 << (log_m - 12) : 1;
    const long long grid = (long long)rows * chunks;
    if (grid > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
    pointwise_kernel<decltype(f)><<<(unsigned)grid, kThreads, 0, stream>>>(
        f, a_odd, b_odd, c_odd, a, b, c, n_out, valid, log_m, chunks);
    return (int)cudaGetLastError();
  });
}
