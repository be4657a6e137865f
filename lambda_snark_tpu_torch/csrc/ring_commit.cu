// Kernel R: the Goldilocks Module-LWE ring commitment, one block per row.
//
// Replaces the TPU kernels ring_mxu.py::commit_batch_mxu (_leaf_apply,
// pallas_call at ops/ring_mxu.py:229) and ring_pallas.py::fused_commit
// (_fused_kernel, pallas_call at ops/ring_pallas.py:230). Per row, over
// R = Z_p[X]/(X^n + 1) with psi a primitive 2n-th root and w = psi^2:
//
//   acc = sum_j A_hat_j o DIF_w(psi^t s_j)     (bit-reversed NTT domain)
//   c_t = DIT_{w^-1}(acc)_t * psi^-t / n + e_t + msg_t
//
// s (k, rows, n) and e (rows, n) arrive as small signed int32 draws and are
// embedded mod p here; msg is (rows, msg_len), msg_len <= n, zero beyond.
// A_hat is stored bit-reversed, so no permutation pass exists.
//
// What bounds it: at n = 4096, k = 2, B = 256 it moves about 20 MiB and
// does 3 * 12 * 2048 * 256 = 19 M Goldilocks butterflies, so integer
// instructions bound it. Design: the row stays in shared memory (two
// buffers of n words) from the first twist to the last add, so device
// memory sees each input once and the output once.
//
// A ring past one block's shared memory (n > 2^13) takes the long route:
// ring_twist embeds s and multiplies by psi^t, kernel T's four-step
// (ntt.cu) transforms the k B rows, ring_accumulate forms
// sum_j A_hat_j o s_hat_j (A_hat in natural order), the inverse four-step
// folds psi^-t / n into its store, and ring_finish adds e and msg.
// ops/ring_commit.py drives the chain.
#include "modmath.cuh"

constexpr int kThreads = 512;

__device__ __forceinline__ uint64_t embed(int32_t v) {
  return v >= 0 ? (uint64_t)v : Goldilocks::P - (uint64_t)(-(int64_t)v);
}

__global__ void __launch_bounds__(kThreads) ring_commit_kernel(
    const int32_t* __restrict__ s, const int32_t* __restrict__ e,
    const uint64_t* __restrict__ msg, int msg_len,
    const uint64_t* __restrict__ a_hat_rev, const uint64_t* __restrict__ psi,
    const uint64_t* __restrict__ psi_inv_n,
    const uint64_t* __restrict__ tw_fwd, const uint64_t* __restrict__ tw_inv,
    uint64_t* __restrict__ out, int rows, int k, int log_n) {
  using G = Goldilocks;
  extern __shared__ uint64_t smem[];
  const int n = 1 << log_n;
  uint64_t* x = smem;
  uint64_t* acc = smem + n;
  const size_t row = blockIdx.x;

  for (int j = 0; j < k; ++j) {
    const int32_t* sj = s + ((size_t)j * rows + row) * n;
    for (int t = threadIdx.x; t < n; t += blockDim.x)
      x[t] = G::mul(embed(sj[t]), psi[t]);
    __syncthreads();
    dif<G>(x, tw_fwd, log_n);
    const uint64_t* aj = a_hat_rev + (size_t)j * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const uint64_t p = G::mul(x[i], aj[i]);
      acc[i] = j == 0 ? p : G::add(acc[i], p);
    }
    __syncthreads();
  }
  dit<G>(acc, tw_inv, log_n);
  for (int t = threadIdx.x; t < n; t += blockDim.x) {
    uint64_t v = G::add(G::mul(acc[t], psi_inv_n[t]), embed(e[row * n + t]));
    if (t < msg_len) v = G::add(v, msg[row * msg_len + t]);
    out[row * n + t] = v;
  }
}

extern "C" int ring_commit_goldilocks(
    const int32_t* s, const int32_t* e, const uint64_t* msg, int msg_len,
    const uint64_t* a_hat_rev, const uint64_t* psi, const uint64_t* psi_inv_n,
    const uint64_t* tw_fwd, const uint64_t* tw_inv, uint64_t* out, int rows,
    int k, int log_n, cudaStream_t stream) {
  const int smem = (int)(2 * sizeof(uint64_t)) << log_n;
  cudaError_t err = cudaFuncSetAttribute(
      ring_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ring_commit_kernel<<<rows, kThreads, smem, stream>>>(
      s, e, msg, msg_len, a_hat_rev, psi, psi_inv_n, tw_fwd, tw_inv, out,
      rows, k, log_n);
  return (int)cudaGetLastError();
}

constexpr int kFlatThreads = 256;

static unsigned flat_grid(long long total) {
  const long long blocks = (total + kFlatThreads - 1) / kFlatThreads;
  return (unsigned)(blocks < 65536 ? blocks : 65536);
}

// out[i] = embed(s[i]) psi[i mod n] over k rows x n words.
__global__ void twist_kernel(const int32_t* __restrict__ s,
                             const uint64_t* __restrict__ psi,
                             uint64_t* __restrict__ out, long long total,
                             int n_mask) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x)
    out[i] = Goldilocks::mul(embed(s[i]), psi[i & n_mask]);
}

// acc[r, t] = sum_j s_hat[j, r, t] a_hat[j, t] over rows x n words.
__global__ void accumulate_kernel(const uint64_t* __restrict__ s_hat,
                                  const uint64_t* __restrict__ a_hat,
                                  uint64_t* __restrict__ acc, long long total,
                                  int k, int n_mask, int log_n) {
  using G = Goldilocks;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long t = i & n_mask;
    uint64_t v = G::mul(s_hat[i], a_hat[t]);
    for (int j = 1; j < k; ++j)
      v = G::add(v, G::mul(s_hat[j * total + i], a_hat[((long long)j << log_n) + t]));
    acc[i] = v;
  }
}

// out[r, t] = x[r, t] + embed(e[r, t]) + msg[r, t] (msg zero past msg_len).
__global__ void finish_kernel(const uint64_t* __restrict__ x,
                              const int32_t* __restrict__ e,
                              const uint64_t* __restrict__ msg, int msg_len,
                              uint64_t* __restrict__ out, long long total,
                              int n_mask, int log_n) {
  using G = Goldilocks;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long t = i & n_mask;
    uint64_t v = G::add(x[i], embed(e[i]));
    if (t < msg_len) v = G::add(v, msg[(i >> log_n) * msg_len + t]);
    out[i] = v;
  }
}

extern "C" int ring_twist(const int32_t* s, const uint64_t* psi, uint64_t* out,
                          long long rows, int log_n, cudaStream_t stream) {
  const long long total = rows << log_n;
  if (total == 0) return 0;
  twist_kernel<<<flat_grid(total), kFlatThreads, 0, stream>>>(
      s, psi, out, total, (1 << log_n) - 1);
  return (int)cudaGetLastError();
}

extern "C" int ring_accumulate(const uint64_t* s_hat, const uint64_t* a_hat,
                               uint64_t* acc, long long rows, int k, int log_n,
                               cudaStream_t stream) {
  const long long total = rows << log_n;
  if (total == 0) return 0;
  accumulate_kernel<<<flat_grid(total), kFlatThreads, 0, stream>>>(
      s_hat, a_hat, acc, total, k, (1 << log_n) - 1, log_n);
  return (int)cudaGetLastError();
}

extern "C" int ring_finish(const uint64_t* x, const int32_t* e,
                           const uint64_t* msg, int msg_len, uint64_t* out,
                           long long rows, int log_n, cudaStream_t stream) {
  const long long total = rows << log_n;
  if (total == 0) return 0;
  finish_kernel<<<flat_grid(total), kFlatThreads, 0, stream>>>(
      x, e, msg, msg_len, out, total, (1 << log_n) - 1, log_n);
  return (int)cudaGetLastError();
}
