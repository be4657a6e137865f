// Kernel K: batched single-block SHA3-256 for Merkle trees.
//
// Replaces the TPU kernel keccak_pallas.py::_hash_call (kernels _leaf_kernel,
// _flex_leaf_kernel, _node_kernel; pallas_call at ops/keccak_pallas.py:242),
// reached through hash_leaves (:281), hash_leaves_flex (:294) and
// hash_nodes (:310). Three messages, each one 136-byte rate block:
//
//   group leaf i of tree t:  0x00 || concat_g LE64(v[t,g,i]) LE64(v[t,g,i+n/2])
//                            (G <= 8 oracles; G = 1 is the paired FRI leaf)
//   node j:                  0x01 || digest[2j] || digest[2j+1]
//
// Digests are 4 LE64 words (the first 4 lanes of the state), stored as
// out[h*4 + k], so a level (T, rows, 4) is also the next level's input.
//
// Two kinds of entry. keccak_leaves / keccak_group_leaves / keccak_nodes
// hash one level per launch, one hash per thread (the JAX package's
// functions). keccak_forest / keccak_group_forest build whole Merkle
// forests, leaves to roots, in one launch each: a FRI layer waits for its
// roots before it can draw the next challenge, so a launch per level put
// some 15 host launch latencies on that wait per layer.
//
// What bounds it: integer instructions. A Keccak-f[1600] permutation is
// 24 rounds of about 30 XOR/AND-NOT and 25 rotates on 64-bit lanes (each
// two 32-bit funnel shifts), against at most 136 bytes in and 32 out per
// hash; a forest of L leaves is 2L - 1 permutations. Design: the 25 lanes
// live in registers (every index below is a compile-time constant, so
// nothing spills to local memory), the message block is built in registers
// from the raw codeword words (a leaf reads v[i] and v[i + n/2] straight
// from the LDE, no payload pass), and consecutive threads read and write
// consecutive words (one hash per thread, per-level entries). A forest
// launch takes one block of 64 threads per subtree: each thread hashes
// 2^K leaves (K <= 5, from the wrapper: 5 for the largest forests, less
// where the forest would not fill the card) and every node above them depth
// first, so all lanes of a warp hash until the threads' subtree roots (a
// block of one hash per leaf would leave most lanes idle on its upper
// levels); the block keeps those roots in shared memory, halves them level
// by level with one __syncthreads per level and writes every level out.
// The last block of a tree to finish (a ticket per tree, taken with
// atomicAdd after a __threadfence) reads the other blocks' subtree roots
// through L2 (__ldcg) and hashes the tree's top levels; it then sets the
// ticket back to 0, so the counters reset themselves and the wrapper zeroes
// them only when it allocates them. A tree of at most 2^(K+6) leaves is one
// block and takes no ticket. The per-thread subtrees bring the largest
// forest (16 x 2^16 group leaves) to the per-level entries' time and every
// smaller one below it.
#include <cstdint>
#include <cuda_runtime.h>

#include "keccak_f.cuh"

constexpr int kThreads = 256;

__device__ __forceinline__ void write_digest(uint64_t* out, long long h,
                                             const uint64_t a[25]) {
  uint64_t* d = out + h * 4;
  d[0] = a[0];
  d[1] = a[1];
  d[2] = a[2];
  d[3] = a[3];
}

// Message lanes for prefix byte `pfx` followed by P LE64 words w[0..P) and
// the SHA3 padding (0x06 after the message, 0x80 in byte 135).
template <int P>
__device__ __forceinline__ void absorb_block(uint64_t a[25], uint64_t pfx,
                                             const uint64_t w[P]) {
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  a[0] = pfx | (w[0] << 8);
#pragma unroll
  for (int k = 1; k < P; ++k) a[k] = (w[k - 1] >> 56) | (w[k] << 8);
  a[P] = (w[P - 1] >> 56) | (0x06ull << 8);
  a[16] ^= 0x8000000000000000ull;
}

template <int G>
__global__ void __launch_bounds__(kThreads) group_leaves_kernel(
    const uint64_t* __restrict__ vals, uint64_t* __restrict__ out,
    long long total, int half) {
  const long long n = 2ll * half;
  for (long long h = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       h < total; h += (long long)gridDim.x * blockDim.x) {
    const long long t = h / half;
    const long long i = h - t * half;
    const uint64_t* v = vals + t * G * n + i;
    uint64_t w[2 * G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      w[2 * g] = v[g * n];
      w[2 * g + 1] = v[g * n + half];
    }
    uint64_t a[25];
    absorb_block<2 * G>(a, 0x00ull, w);
    keccak_f(a);
    write_digest(out, h, a);
  }
}

__global__ void __launch_bounds__(kThreads) nodes_kernel(
    const uint64_t* __restrict__ level, uint64_t* __restrict__ out,
    long long total) {
  for (long long h = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       h < total; h += (long long)gridDim.x * blockDim.x) {
    const uint64_t* p = level + h * 8;
    uint64_t w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) w[k] = p[k];
    uint64_t a[25];
    absorb_block<8>(a, 0x01ull, w);
    keccak_f(a);
    write_digest(out, h, a);
  }
}

static int grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < (1ll << 20) ? blocks : (1ll << 20));
}

// vals (trees, groups, 2 half) words -> out (trees, half, 4) digest words.
extern "C" int keccak_group_leaves(const uint64_t* vals, uint64_t* out,
                                   int trees, int groups, int half,
                                   cudaStream_t stream) {
  const long long total = (long long)trees * half;
  if (total == 0) return 0;
  const int grid = grid_for(total);
  switch (groups) {
#define LEAF_CASE(G)                                                       \
  case G:                                                                  \
    group_leaves_kernel<G><<<grid, kThreads, 0, stream>>>(vals, out, total, \
                                                          half);           \
    break;
    LEAF_CASE(1) LEAF_CASE(2) LEAF_CASE(3) LEAF_CASE(4)
    LEAF_CASE(5) LEAF_CASE(6) LEAF_CASE(7) LEAF_CASE(8)
#undef LEAF_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// values (trees, 2 half) words -> out (trees, half, 4): the paired FRI leaf,
// the group leaf with one oracle.
extern "C" int keccak_leaves(const uint64_t* values, uint64_t* out, int trees,
                             int half, cudaStream_t stream) {
  return keccak_group_leaves(values, out, trees, 1, half, stream);
}

// level (count, 2, 4) digest words -> out (count, 4): one Merkle level up.
extern "C" int keccak_nodes(const uint64_t* level, uint64_t* out, long long count,
                            cudaStream_t stream) {
  if (count == 0) return 0;
  nodes_kernel<<<grid_for(count), kThreads, 0, stream>>>(level, out, count);
  return (int)cudaGetLastError();
}

// --- whole forests -----------------------------------------------------------

constexpr int kLogForestThreads = 6;  // 64 threads a forest block
constexpr int kForestThreads = 1 << kLogForestThreads;
constexpr int kMaxLogPerThread = 5;   // leaves a thread takes, log2

// Word offset of level l in a forest buffer of `trees` trees of 2^log_half
// leaves: the levels lie one after another, leaf level first, each a
// (trees, rows_l, 4) block, rows_l = 2^(log_half - l).
__device__ __forceinline__ long long level_offset(int l, int log_half, long long trees) {
  return 4 * trees * ((2ll << log_half) - ((2ll << log_half) >> l));
}

__device__ __forceinline__ void node_digest(uint64_t a[25], const uint64_t w[8]) {
  absorb_block<8>(a, 0x01ull, w);
  keccak_f(a);
}

__device__ __forceinline__ void put_digest(uint64_t* out, int l, int log_half,
                                           long long trees, long long t,
                                           long long row, const uint64_t a[25]) {
  uint64_t* d = out + level_offset(l, log_half, trees) + (t * (1ll << (log_half - l)) + row) * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = a[k];
}

// One block per subtree of 2^log_block leaves, blocks of one tree
// consecutive. Each of the block's 2^(log_block - log_thread) active
// threads builds a subtree of 2^log_thread leaves depth first (its pending
// left digests on a stack in shared memory), so every lane of a warp hashes
// until the threads' roots; the block then halves those roots level by
// level. vals (trees, G, 2 half) words -> out, every level of every tree
// (level_offset's layout). tickets: one zeroed counter per tree.
template <int G>
__global__ void __launch_bounds__(kForestThreads) forest_kernel(
    const uint64_t* __restrict__ vals, uint64_t* out, unsigned int* tickets,
    int log_half, int log_thread, int log_block) {
  __shared__ uint64_t stack[kMaxLogPerThread][kForestThreads][4];
  __shared__ uint64_t dig[2][kForestThreads][4];
  __shared__ bool last;
  const int log_subs = log_half - log_block;  // subtrees per tree, log2
  const int log_thr = log_block - log_thread;  // active threads, log2
  const long long trees = (long long)gridDim.x >> log_subs;
  const long long t = blockIdx.x >> log_subs;
  const long long b = blockIdx.x & ((1 << log_subs) - 1);
  const long long half = 1ll << log_half, n = 2 * half;
  const int tid = threadIdx.x;
  uint64_t a[25];

  if (tid < (1 << log_thr)) {
    const long long first = (b << log_block) + ((long long)tid << log_thread);
    const uint64_t* v = vals + t * G * n + first;
    for (int i = 0; i < (1 << log_thread); ++i) {
      uint64_t w[2 * G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        w[2 * g] = v[g * n + i];
        w[2 * g + 1] = v[g * n + half + i];
      }
      absorb_block<2 * G>(a, 0x00ull, w);
      keccak_f(a);
      put_digest(out, 0, log_half, trees, t, first + i, a);
      int l = 0;
      while ((i >> l) & 1) {  // a completes the left digest pending at level l
        uint64_t m[8];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          m[k] = stack[l][tid][k];
          m[4 + k] = a[k];
        }
        node_digest(a, m);
        ++l;
        put_digest(out, l, log_half, trees, t, (first + i) >> l, a);
      }
      if (l < log_thread) {
#pragma unroll
        for (int k = 0; k < 4; ++k) stack[l][tid][k] = a[k];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) dig[0][tid][k] = a[k];
  }
  __syncthreads();
  int cur = 0;
  for (int l = 1; l <= log_thr; ++l) {
    const int cnt = 1 << (log_thr - l);
    if (tid < cnt) {
      uint64_t m[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        m[k] = dig[cur][2 * tid][k];
        m[4 + k] = dig[cur][2 * tid + 1][k];
      }
      node_digest(a, m);
#pragma unroll
      for (int k = 0; k < 4; ++k) dig[cur ^ 1][tid][k] = a[k];
      put_digest(out, log_thread + l, log_half, trees, t, b * cnt + tid, a);
    }
    cur ^= 1;
    __syncthreads();
  }
  if (log_subs == 0) return;
  // thread 0 wrote the subtree root
  if (tid == 0) {
    __threadfence();
    last = atomicAdd(tickets + t, 1u) == (1u << log_subs) - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int l = log_block + 1; l <= log_half; ++l) {
    const long long cnt = half >> l;
    const uint64_t* prev = out + level_offset(l - 1, log_half, trees) + t * (2 * cnt) * 4;
    for (long long j = tid; j < cnt; j += kForestThreads) {
      uint64_t m[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        m[k] = __ldcg(reinterpret_cast<const unsigned long long*>(prev + j * 8 + k));
      node_digest(a, m);
      put_digest(out, l, log_half, trees, t, j, a);
    }
    __threadfence();
    __syncthreads();
  }
  if (tid == 0) tickets[t] = 0;
}

// vals (trees, groups, 2^(log_half+1)) words -> out: every level of each
// tree's Merkle tree over its 2^log_half group leaves, level-major
// (4 trees (2^(log_half+1) - 1) words), each thread hashing
// 2^log_thread leaves and the nodes above them (log_thread <= 5, cut to
// the tree); tickets: `trees` zeroed counters, left zeroed.
extern "C" int keccak_group_forest(const uint64_t* vals, uint64_t* out,
                                   unsigned int* tickets, int trees, int groups,
                                   int log_half, int log_thread,
                                   cudaStream_t stream) {
  if (trees == 0) return 0;
  if (log_half < 1 || log_half > 30 || log_thread < 0 || log_thread > kMaxLogPerThread)
    return (int)cudaErrorInvalidValue;
  if (log_thread > log_half) log_thread = log_half;
  const int log_thr = log_half - log_thread < kLogForestThreads ? log_half - log_thread
                                                                 : kLogForestThreads;
  const int log_block = log_thread + log_thr;
  const long long grid = (long long)trees << (log_half - log_block);
  if (grid > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  switch (groups) {
#define FOREST_CASE(G)                                                        \
  case G:                                                                     \
    forest_kernel<G><<<(unsigned)grid, kForestThreads, 0, stream>>>(          \
        vals, out, tickets, log_half, log_thread, log_block);                 \
    break;
    FOREST_CASE(1) FOREST_CASE(2) FOREST_CASE(3) FOREST_CASE(4)
    FOREST_CASE(5) FOREST_CASE(6) FOREST_CASE(7) FOREST_CASE(8)
#undef FOREST_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// values (trees, 2^(log_half+1)) -> the forest of paired FRI leaves.
extern "C" int keccak_forest(const uint64_t* values, uint64_t* out,
                             unsigned int* tickets, int trees, int log_half,
                             int log_thread, cudaStream_t stream) {
  return keccak_group_forest(values, out, tickets, trees, 1, log_half, log_thread, stream);
}
