// Kernel R: the Goldilocks Module-LWE ring commitment, one row over a
// thread-block cluster of C blocks (cluster.cuh).
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
// A_hat is stored bit-reversed (a_hat_rev), in the order the DIF leaves
// it, so no permutation pass exists; tw_fwd and tw_inv are stage-major
// twiddle tables (butterfly.cuh's StageTwiddles).
//
// What bounds it: integer instructions. At n = 4096, k = 2, B = 256 it
// moves about 20 MiB and does 3 * 12 * 2048 * 256 = 19 M Goldilocks
// butterflies; at the kind-7 shapes (16 rows of 2^13 or 2^14) one block
// per row left 116 of 132 SMs idle. Design (as kernel Q's):
// - a row over a cluster of C blocks (up to 8, so rings of 2^16 run in one
//   launch), its top DIF and last DIT stages as radix-C exchanges through
//   distributed shared memory, every other stage as radix-8 register
//   passes over butterfly.cuh's swizzled tile;
// - s_j is embedded and multiplied by psi^t in the load that feeds its top
//   DIF stages; the product by A_hat_j and the sum over j go into the last
//   DIF pass's store; psi^-t / n, e and msg go into the store that follows
//   the last DIT stages, straight to device memory in natural order; every
//   load and store of device memory is coalesced;
// - the shared-memory attribute is set once per process.
//
// A ring past 2^16 takes the long route: ring_twist embeds s and multiplies
// by psi^t, kernel T's four-step (ntt.cu) transforms the k B rows,
// ring_accumulate forms sum_j A_hat_j o s_hat_j (A_hat in natural order),
// the inverse four-step folds psi^-t / n into its store, and ring_finish
// adds e and msg. ops/ring_commit.py drives the chain.
#include "cluster.cuh"

__device__ __forceinline__ uint64_t embed(int32_t v) {
  return v >= 0 ? (uint64_t)v : Goldilocks::P - (uint64_t)(-(int64_t)v);
}

template <int C>
__global__ void __launch_bounds__(kRowThreads) ring_commit_kernel(
    const int32_t* __restrict__ s, const int32_t* __restrict__ e,
    const uint64_t* __restrict__ msg, int msg_len,
    const uint64_t* __restrict__ a_hat_rev, const uint64_t* __restrict__ psi,
    const uint64_t* __restrict__ psi_inv_n, const uint64_t* __restrict__ tw_fwd,
    const uint64_t* __restrict__ tw_inv, uint64_t* __restrict__ out, int rows, int k,
    int log_n) {
  using G = Goldilocks;
  constexpr int kc = log2_cluster<C>();
  constexpr int NT = kRowThreads;
  const G f{};
  // the tile: x (the transform of s_j) at words [0, L), acc at [L, 2L)
  extern __shared__ uint64_t sm[];
  const int rank = cluster_rank<C>();
  const long long row = blockIdx.x / C;
  const long long n = 1ll << log_n;
  const int log_l = log_n - kc, L = 1 << log_l;
  const int groups = L >> kc;  // exchange groups p0 <= p < p0 + groups
  const int p0 = rank * groups;
  const TileRef xt{sm, 0}, acc{sm, L};
  const StageTwiddles fwd{tw_fwd, nullptr}, inv{tw_inv, nullptr};

  for (int j = 0; j < k; ++j) {
    if (j > 0) cluster_sync<C>();  // the peers' passes over x are done
    // embed(s_j) psi^t from device memory through the top DIF stages into x
    const int32_t* sj = s + ((long long)j * rows + row) * n;
    for (int g = threadIdx.x; g < groups; g += NT) {
      const int p = p0 + g;
      uint64_t v[C];
#pragma unroll
      for (int r = 0; r < C; ++r) {
        const int i = p + r * L;
        v[r] = G::mul(embed(sj[i]), ldg_word(psi, i));
      }
      dif_stages<kc>(f, v, fwd, p, log_l);
#pragma unroll
      for (int r = 0; r < C; ++r) peer<C>(sm, r)[swz(p)] = v[r];
    }
    cluster_sync<C>();
    // the local DIF stages; the last pass adds A_hat_j o x into acc
    const uint64_t* aj = a_hat_rev + j * n + rank * L;
    auto accumulate = [&](int i, uint64_t v) {
      const uint64_t prod = G::mul(v, ldg_word(aj, i));
      acc(i, j == 0 ? prod : G::add(acc(i), prod));
    };
    tile_stages<NT, false>(f, xt, fwd, log_l, 1, xt, accumulate);
  }
  __syncthreads();
  tile_stages<NT, true>(f, acc, inv, log_l, 1, acc, acc);
  cluster_sync<C>();

  // the last DIT stages, then psi^-t / n, e and msg, into device memory
  const long long o = row * n;
  for (int g = threadIdx.x; g < groups; g += NT) {
    const int p = p0 + g;
    uint64_t v[C];
#pragma unroll
    for (int r = 0; r < C; ++r) v[r] = peer<C>(sm, r)[swz(L + p)];
    dit_stages<kc>(f, v, inv, p, log_l);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const int i = p + r * L;
      uint64_t w = G::add(G::mul(v[r], ldg_word(psi_inv_n, i)), embed(e[o + i]));
      if (i < msg_len) w = G::add(w, msg[row * msg_len + i]);
      out[o + i] = w;
    }
  }
  cluster_sync<C>();  // the peers' exchanges read this block's tile
}

extern "C" int ring_commit_goldilocks(
    const int32_t* s, const int32_t* e, const uint64_t* msg, int msg_len,
    const uint64_t* a_hat_rev, const uint64_t* psi, const uint64_t* psi_inv_n,
    const uint64_t* tw_fwd, const uint64_t* tw_inv, uint64_t* out, int rows, int k,
    int log_n, int cluster, cudaStream_t stream) {
  const int kc = cluster_bits(rows, log_n, cluster);
  if (kc < 0 || k < 1) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int log_l = log_n - kc;
#define RING_LAUNCH(CS)                                                                  \
  return launch_rows<&ring_commit_kernel<CS>, CS>(rows, 2, log_l, stream, s, e, msg,   \
                                                  msg_len, a_hat_rev, psi, psi_inv_n,  \
                                                  tw_fwd, tw_inv, out, rows, k, log_n)
  switch (cluster) {
    case 1: RING_LAUNCH(1);
    case 2: RING_LAUNCH(2);
    case 4: RING_LAUNCH(4);
    default: RING_LAUNCH(8);
  }
#undef RING_LAUNCH
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
