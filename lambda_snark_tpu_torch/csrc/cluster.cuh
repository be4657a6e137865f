// One row over a thread-block cluster of C = 1, 2, 4 or 8 blocks (Hopper's
// distributed shared memory), for kernels Q (quotient.cu) and R
// (ring_commit.cu).
//
// A row of m words and its transform are split into C contiguous chunks of
// L = m / C words, block r of the cluster holding words [r L, (r + 1) L) of
// each of the row's buffers in its shared-memory tile (butterfly.cuh's
// swizzle; buffer b at tile words [b L, (b + 1) L)). The top
// log2 C radix-2 DIF stages of an m-point transform, and the last log2 C
// DIT stages, pair words of different blocks: they run as one exchange, in
// which a thread takes the C words p + r L (r < C) of group p < L, one from
// each block, reads them through distributed shared memory (or from device
// memory), runs the radix-C stages in registers and writes them back, group
// p being block p / (L / C)'s. Every other stage is local to a block's chunk
// (butterfly.cuh's tile_stages). A chunk's DIF output sits at bit-reversed
// positions: global position r L + i holds frequency
// rev(i) C + rev_C(r), so a natural-order read-out gathers word t from
// block rev_C(t mod C) at position rev(t / C). C = 1 is the same code with
// no exchange, and its cluster barriers are block barriers.
#pragma once

#include <cooperative_groups.h>

#include <utility>

#include "butterfly.cuh"

namespace cg = cooperative_groups;

constexpr int kRowThreads = 256;
constexpr int kMaxLogChunk = 13;  // words of each buffer a block holds, log2
constexpr int kMaxBuffers = 3;    // buffers a row keeps (kernel Q: a, b, c)
constexpr int kRowSmem = (int)(kMaxBuffers * sizeof(uint64_t)) << kMaxLogChunk;  // 192 KiB

template <int C>
__host__ __device__ constexpr int log2_cluster() {
  static_assert(C == 1 || C == 2 || C == 4 || C == 8, "clusters of 1, 2, 4 or 8 blocks");
  return C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : 3;
}

template <int C>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (C == 1) __syncthreads();
  else cg::this_cluster().sync();
}

template <int C>
__device__ __forceinline__ int cluster_rank() {
  if constexpr (C == 1) return 0;
  else return (int)cg::this_cluster().block_rank();
}

// p in block r's shared memory (p itself when C = 1).
template <int C, class T>
__device__ __forceinline__ T* peer(T* p, int r) {
  if constexpr (C == 1) return p;
  else return cg::this_cluster().map_shared_rank(p, r);
}

// Bit reversal of r < C over log2 C bits.
template <int C>
__device__ __forceinline__ int rev_cluster(int r) {
  if constexpr (C == 1) return 0;
  else return bitrev(r, log2_cluster<C>());
}

// Launches Kernel over `rows` clusters of C blocks of kRowThreads threads,
// each block with `buffers` buffers of 2^log_chunk words of dynamic shared
// memory, on `stream`. The
// shared-memory attribute is set once per process and kernel; before the
// first launch of a chunk size, cudaOccupancyMaxActiveClusters must find
// room for one cluster, else this returns cudaErrorInvalidConfiguration
// and launches nothing.
template <auto Kernel, int C, class... Args>
int launch_rows(int rows, int buffers, int log_chunk, cudaStream_t stream, Args&&... args) {
  static const cudaError_t attr =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRowSmem);
  if (attr != cudaSuccess) return (int)attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * C);
  cfg.blockDim = dim3(kRowThreads);
  cfg.dynamicSmemBytes = (size_t)(buffers * sizeof(uint64_t)) << log_chunk;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = C;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  static int fits[kMaxLogChunk + 1] = {};  // 0 unknown, 1 room, -1 none
  if (fits[log_chunk] == 0) {
    int clusters = 0;
    const cudaError_t err =
        cudaOccupancyMaxActiveClusters(&clusters, (const void*)Kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    fits[log_chunk] = clusters > 0 ? 1 : -1;
  }
  if (fits[log_chunk] < 0) return (int)cudaErrorInvalidConfiguration;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, Kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// log2 C for a cluster of 1, 2, 4 or 8 blocks over rows of 2^log_m words,
// or -1 where the shape is not one kernels Q and R take: each block needs
// at least one exchange group (m >= C^2) and at most 2^kMaxLogChunk words
// of each buffer.
inline int cluster_bits(int rows, int log_m, int cluster) {
  const int c = cluster == 1 ? 0 : cluster == 2 ? 1 : cluster == 4 ? 2 : cluster == 8 ? 3 : -1;
  if (c < 0 || rows < 0 || (long long)rows * cluster > 0x7FFFFFFFll) return -1;
  const int log_chunk = log_m - c;
  if (log_chunk < c || log_chunk < 1 || log_chunk > kMaxLogChunk) return -1;
  return c;
}
