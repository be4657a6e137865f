// Candidate forms of the Keccak-f[1600] permutation for kernels S and F
// (lambda_snark_tpu_torch/csrc/fri.cu), for scripts/torch_port_ab.py's
// sponge_fold section: `squeezes` squeezes of a one-block message in a row
// per statement, as transcript_squeeze with a mask, each statement's chain
// run by
//
//   design 0  one thread, the 24 rounds unrolled (the one-thread form of
//             keccak_f.cuh's keccak_f, round constants as immediates);
//   design 1  one warp, KeccakWarp of keccak_f.cuh (the kept form);
//   design 2  one warp as design 1, but theta gathers both neighbouring
//             columns in one level of 10 shuffles instead of two levels of
//             4 and 2.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -o libsponge_candidates.so scripts/sponge_candidates.cu
#include <cstdint>
#include <cuda_runtime.h>

#include "../lambda_snark_tpu_torch/csrc/keccak_f.cuh"

namespace {

__device__ __forceinline__ void keccak_thread(uint64_t a[25]) {
  constexpr int kRho[25] = {0,  1,  62, 28, 27, 36, 44, 6,  55, 20, 3,  10, 43,
                            25, 39, 41, 45, 15, 21, 8,  18, 2,  61, 56, 14};
#pragma unroll
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int i = 0; i < 25; ++i) {
      const int x = i % 5, y = i / 5;
      const int src = (x + 3 * y) % 5 + 5 * x;  // the pi source of position i
      const uint64_t v = a[src] ^ c[(src % 5 + 4) % 5] ^ rotl(c[(src % 5 + 1) % 5], 1);
      b[i] = kRho[src] ? rotl(v, kRho[src]) : v;
    }
#pragma unroll
    for (int i = 0; i < 25; ++i) {
      const int x = i % 5, y = i / 5;
      a[i] = b[i] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
    }
    a[0] ^= keccak_round_constant(round);
  }
}

struct KeccakWarpTheta1 : KeccakWarp {
  __device__ explicit KeccakWarpTheta1(int lane) : KeccakWarp(lane) {}
  __device__ __forceinline__ uint64_t permute(uint64_t a) const {
#pragma unroll
    for (int round = 0; round < 24; ++round) {
      uint64_t cl = 0, cr = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        cl ^= shfl(a, left + 5 * k);
        cr ^= shfl(a, right + 5 * k);
      }
      const uint64_t b = rho(a ^ cl ^ rotl(cr, 1));
      const uint64_t b0 = shfl(b, pi0), b1 = shfl(b, pi1), b2 = shfl(b, pi2);
      a = b0 ^ (~b1 & b2);
      if (first) a ^= keccak_round_constant(round);
    }
    return a;
  }
};

struct Block {
  uint64_t lanes[17];  // the squeeze's lanes but the state's and the counter's
  int lane, shift;     // where the LE64 counter starts
};

__device__ __forceinline__ uint64_t counter_bits(int k, uint64_t ctr, const Block& blk) {
  uint64_t v = k == blk.lane ? ctr << (8 * blk.shift) : 0;
  if (blk.shift && k == blk.lane + 1) v |= ctr >> (64 - 8 * blk.shift);
  return v;
}

__global__ void __launch_bounds__(1) squeeze_thread(const uint64_t* __restrict__ state_in,
    uint64_t* __restrict__ state_out, uint64_t* __restrict__ out, Block blk, uint64_t counter0,
    int squeezes, uint64_t mask) {
  const int row = blockIdx.x;
  uint64_t st[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) st[k] = state_in[4 * row + k];
  for (int i = 0; i < squeezes; ++i) {
    const uint64_t ctr = counter0 + (uint64_t)i;
    uint64_t a[25];
#pragma unroll
    for (int k = 0; k < 25; ++k)
      a[k] = k < 4 ? st[k] : k < 17 ? blk.lanes[k] | counter_bits(k, ctr, blk) : 0;
    keccak_thread(a);
#pragma unroll
    for (int k = 0; k < 4; ++k) st[k] = a[k];
    out[(long long)row * squeezes + i] = a[0] & mask;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) state_out[4 * row + k] = st[k];
}

template <class W>
__global__ void __launch_bounds__(32) squeeze_warp(const uint64_t* __restrict__ state_in,
    uint64_t* __restrict__ state_out, uint64_t* __restrict__ out, Block blk, uint64_t counter0,
    int squeezes, uint64_t mask) {
  const int row = blockIdx.x, t = threadIdx.x;
  const W w(t);
  uint64_t a = t < 4 ? state_in[4 * row + t] : 0;
  const uint64_t fixed = t >= 4 && t < 17 ? blk.lanes[t] : 0;
  for (int i = 0; i < squeezes; ++i) {
    if (t >= 4) a = fixed | counter_bits(t, counter0 + (uint64_t)i, blk);
    a = w.permute(a);
    if (t == 0) out[(long long)row * squeezes + i] = a & mask;
  }
  if (t < 4) state_out[4 * row + t] = a;
}

}  // namespace

// lanes: the 17 lanes of the squeeze's block (host memory), as
// ops/keccak.py's squeeze_lanes gives them.
extern "C" int squeeze_candidate(int design, const uint64_t* state_in, uint64_t* state_out,
                                 uint64_t* out, const uint64_t* lanes, int lane, int shift,
                                 uint64_t counter0, int squeezes, uint64_t mask, int count,
                                 cudaStream_t stream) {
  if (count == 0) return 0;
  Block blk;
  for (int k = 0; k < 17; ++k) blk.lanes[k] = lanes[k];
  blk.lane = lane;
  blk.shift = shift;
  if (design == 0)
    squeeze_thread<<<count, 1, 0, stream>>>(state_in, state_out, out, blk, counter0, squeezes,
                                            mask);
  else if (design == 1)
    squeeze_warp<KeccakWarp><<<count, 32, 0, stream>>>(state_in, state_out, out, blk, counter0,
                                                       squeezes, mask);
  else if (design == 2)
    squeeze_warp<KeccakWarpTheta1><<<count, 32, 0, stream>>>(state_in, state_out, out, blk,
                                                             counter0, squeezes, mask);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
