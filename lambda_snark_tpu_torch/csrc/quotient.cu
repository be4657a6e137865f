// Kernel Q: the batched odd-coset quotient, one row over a thread-block
// cluster of C blocks (cluster.cuh).
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
// What bounds it: integer instructions. At m = 4096, B = 256 it moves
// 7 x 8 MiB but does 7 * 12 * 2048 * 256 = 44 M butterflies with one
// 64-bit modular product each; at the kind-7 shapes (16 rows of 2^13 or
// 2^14 Goldilocks words) one block per row left 116 of 132 SMs idle.
// Design:
// - a row is spread over a cluster of C blocks (C chosen by the wrapper so
//   that the grid fills the card; up to 8, so rows of 2^16 words, three
//   buffers of 2^13 per block, run in one launch): its top DIF and last DIT
//   stages run as radix-C exchanges through distributed shared memory,
//   every other stage in the block's chunk as radix-8 register passes over
//   butterfly.cuh's swizzled tile (no bank conflicts), with one barrier per
//   three stages where the old kernel had one per stage;
// - a, b and c are transformed side by side (three buffers, one pass over
//   all three), so only N's transform runs alone; the exchanges are fused
//   with device memory and with each other: a, b and c are loaded straight
//   into their top DIF stages, and the last DIT stages end in
//   N = a_odd b_odd - c_odd and N's top DIF stages;
// - DIF/DIT pairing removes every bit-reversal pass; the twist table is
//   stored pre-permuted (twist_rev[i] = psi^rev(i) / m, as the JAX kernel's
//   twist_rev) and folded into the first DIT pass, and the twiddles are
//   stage-major, so every table read is coalesced; A, B, C and Q are
//   gathered across the cluster in natural order, so every device-memory
//   store is coalesced;
// - the 44-bit field runs lazy Shoup/Harvey butterflies (Q45Shoup: one
//   product by a twiddle is w x - umulhi(x, w') q, words stay in [0, 2q)
//   or [0, 4q) with one conditional subtract per butterfly) and is reduced
//   only where a word leaves the kernel or meets another word in a
//   product; Goldilocks keeps canonical arithmetic (Shoup needs q < 2^62);
// - the shared-memory attribute is set once per process.
//
// A row past 2^16 words takes the long route, a chain of kernel T launches
// (ntt.cu's four-step) around one elementwise entry here,
// quotient_pointwise: interpolate a, b, c (inverse, 1/m in the store),
// psi-twist in the load of the forward transform onto the odd coset,
// N = a_odd b_odd - c_odd with the residual check (this entry), and the
// inverse with psi^-k / (m (-2)) in its store; ops/quotient.py drives it.
#include "cluster.cuh"

// The tables a row reads: the stage-major twiddles of w^-1 and w
// (butterfly.cuh's StageTwiddles), the twist psi^rev(i) / m at DIF position
// i, the untwist psi^-t / (m (-2)) at t and 1/m, each beside its Shoup
// companion (null and 0 for Goldilocks).
struct QuotientTables {
  const uint64_t *tw_inv, *tw_inv_s, *tw, *tw_s, *twist_rev, *twist_rev_s, *untwist,
      *untwist_s;
  uint64_t inv_m, inv_m_s;
};

template <int C, class F>
__global__ void __launch_bounds__(kRowThreads) quotient_kernel(
    F f, const uint64_t* __restrict__ a, const uint64_t* __restrict__ b,
    const uint64_t* __restrict__ c, QuotientTables t, uint64_t* __restrict__ q_out,
    uint64_t* __restrict__ a_out, uint64_t* __restrict__ b_out,
    uint64_t* __restrict__ c_out, int32_t* __restrict__ valid, int log_m) {
  constexpr int kc = log2_cluster<C>();
  constexpr int NT = kRowThreads;
  // the tile: x (a, then a_odd, then N) at words [0, L), y (b) at [L, 2L),
  // z (c) at [2L, 3L)
  extern __shared__ uint64_t s[];
  __shared__ int bad_flag;
  const int rank = cluster_rank<C>();
  const long long row = blockIdx.x / C;
  const long long base = row << log_m;
  const int log_l = log_m - kc, L = 1 << log_l;
  const int groups = L >> kc;  // exchange groups p0 <= p < p0 + groups
  const int p0 = rank * groups;
  const TileRef tile{s, 0};
  const StageTwiddles inv{t.tw_inv, t.tw_inv_s}, fwd{t.tw, t.tw_s};

  // word rank L + i of a row in natural order, from the DIF output of the
  // buffer at tile word off across the cluster
  auto gather = [&](int i, int off) {
    const int tt = rank * L + i;
    const int pos = bitrev(tt >> kc, log_l);
    return peer<C>(s, rev_cluster<C>(tt & (C - 1)))[swz(off + pos)];
  };
  // the first DIT pass's loads: DIF output times twist_rev at its position
  auto twisted = [&](int i) {
    const int k = rank * L + (i & (L - 1));
    return mul_tab(f, tile(i), ldg_word(t.twist_rev, k), ldg_shoup(f, t.twist_rev_s, k));
  };

  // 1. a, b, c from device memory through their top DIF stages into x, y,
  //    z of the peers; the residual a b == c
  int bad = 0;
  for (int g = threadIdx.x; g < groups; g += NT) {
    const int p = p0 + g;
    uint64_t e[3][C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const long long i = base + p + r * L;
      e[0][r] = a[i];
      e[1][r] = b[i];
      e[2][r] = c[i];
      bad |= f.mul(e[0][r], e[1][r]) != e[2][r];
    }
#pragma unroll
    for (int v = 0; v < 3; ++v) {
      dif_stages<kc>(f, e[v], inv, p, log_l);
#pragma unroll
      for (int r = 0; r < C; ++r) peer<C>(s, r)[swz(v * L + p)] = e[v][r];
    }
  }
  bad = __syncthreads_or(bad);
  if (threadIdx.x == 0) bad_flag = bad;
  cluster_sync<C>();
  if (rank == 0 && threadIdx.x == 0) {
    int any = 0;
#pragma unroll
    for (int r = 0; r < C; ++r) any |= *peer<C>(&bad_flag, r);
    valid[row] = any ? 0 : 1;
  }

  // 2. the local DIF stages of x, y and z
  tile_stages<NT, false>(f, tile, inv, log_l, 3, tile, tile);
  cluster_sync<C>();

  // 3. A, B and C coefficients out, gathered in natural order
  for (int i = threadIdx.x; i < L; i += NT) {
    const long long o = base + rank * L + i;
    a_out[o] = canon2(f, mul_tab(f, gather(i, 0), t.inv_m, t.inv_m_s));
    b_out[o] = canon2(f, mul_tab(f, gather(i, L), t.inv_m, t.inv_m_s));
    c_out[o] = canon2(f, mul_tab(f, gather(i, 2 * L), t.inv_m, t.inv_m_s));
  }
  cluster_sync<C>();

  // 4. the twist and the local DIT stages of x, y and z
  tile_stages<NT, true>(f, tile, fwd, log_l, 3, twisted, tile);
  cluster_sync<C>();

  // 5. the last DIT stages of a, b and c, N = a_odd b_odd - c_odd and N's
  //    top DIF stages into x
  for (int g = threadIdx.x; g < groups; g += NT) {
    const int p = p0 + g;
    uint64_t ex[C], ey[C];
#pragma unroll
    for (int r = 0; r < C; ++r) {
      const uint64_t* d = peer<C>(s, r);
      ex[r] = d[swz(p)];
      ey[r] = d[swz(L + p)];
    }
    dit_stages<kc>(f, ex, fwd, p, log_l);
    dit_stages<kc>(f, ey, fwd, p, log_l);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      ex[r] = f.mul(canon4(f, ex[r]), canon4(f, ey[r]));
      ey[r] = peer<C>(s, r)[swz(2 * L + p)];
    }
    dit_stages<kc>(f, ey, fwd, p, log_l);
#pragma unroll
    for (int r = 0; r < C; ++r) ex[r] = sub_lazy(f, ex[r], ey[r]);
    dif_stages<kc>(f, ex, inv, p, log_l);
#pragma unroll
    for (int r = 0; r < C; ++r) peer<C>(s, r)[swz(p)] = ex[r];
  }
  cluster_sync<C>();

  // 6-7. N: local DIF, then Q out with the untwist, in natural order
  tile_stages<NT, false>(f, tile, inv, log_l, 1, tile, tile);
  cluster_sync<C>();
  for (int i = threadIdx.x; i < L; i += NT) {
    const int tt = rank * L + i;
    q_out[base + tt] = canon2(f, mul_tab(f, gather(i, 0), ldg_word(t.untwist, tt),
                                         ldg_shoup(f, t.untwist_s, tt)));
  }
  cluster_sync<C>();  // the peers' gathers read this block's tile
}

template <class F>
static int launch(F f, const uint64_t* a, const uint64_t* b, const uint64_t* c,
                  const QuotientTables& t, uint64_t* q_out, uint64_t* a_out, uint64_t* b_out,
                  uint64_t* c_out, int32_t* valid, int rows, int log_m, int cluster,
                  cudaStream_t stream) {
  const int kc = cluster_bits(rows, log_m, cluster);
  if (kc < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const int log_l = log_m - kc;
#define QUOTIENT_LAUNCH(CS)                                                             \
  return launch_rows<&quotient_kernel<CS, F>, CS>(rows, 3, log_l, stream, f, a, b, c, t, \
                                                  q_out, a_out, b_out, c_out, valid, log_m)
  switch (cluster) {
    case 1: QUOTIENT_LAUNCH(1);
    case 2: QUOTIENT_LAUNCH(2);
    case 4: QUOTIENT_LAUNCH(4);
    default: QUOTIENT_LAUNCH(8);
  }
#undef QUOTIENT_LAUNCH
}

#define QUOTIENT_ENTRY(NAME, FIELD)                                                   \
  extern "C" int NAME(const uint64_t* a, const uint64_t* b, const uint64_t* c,        \
                      const uint64_t* tw_inv, const uint64_t* tw_inv_s,               \
                      const uint64_t* tw, const uint64_t* tw_s,                       \
                      const uint64_t* twist_rev, const uint64_t* twist_rev_s,         \
                      const uint64_t* untwist, const uint64_t* untwist_s,             \
                      uint64_t inv_m, uint64_t inv_m_s, uint64_t* q_out,              \
                      uint64_t* a_out, uint64_t* b_out, uint64_t* c_out,              \
                      int32_t* valid, int rows, int log_m, int cluster,               \
                      cudaStream_t stream) {                                          \
    const QuotientTables t{tw_inv, tw_inv_s, tw, tw_s, twist_rev, twist_rev_s,       \
                           untwist, untwist_s, inv_m, inv_m_s};                       \
    return launch(FIELD{}, a, b, c, t, q_out, a_out, b_out, c_out, valid, rows,      \
                  log_m, cluster, stream);                                            \
  }

QUOTIENT_ENTRY(quotient_q45, Q45Shoup)
QUOTIENT_ENTRY(quotient_goldilocks, Goldilocks)

// The long route's pointwise step: n = a_odd b_odd - c_odd over rows x 2^log_m
// words, and valid[row] = 0 where some a_t b_t != c_t (the caller sets
// valid to 1 first). Block b takes words [b * kChunk, (b + 1) * kChunk) of
// row b / chunks, so a block's residual flag belongs to one row.
constexpr int kChunk = 4096;
constexpr int kThreads = 512;

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
