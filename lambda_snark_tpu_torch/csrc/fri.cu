// Kernels S and F: the Fiat-Shamir transcript sponge and the fold of the
// device-resident FRI chain (proof/fri_device.py, fri_chain_dispatch).
//
// Neither replaces a Pallas kernel: they are the hand-written counterparts
// of two XLA device functions of the JAX package's chain,
// lambda_snark_tpu/proof/fri_device.py:
//
//   kernel S  _sha3_bytes_dev (:678), DevTranscript (:736) and
//             _challenge_planes (:767): the SHA3-256 ratchet of
//             FriTranscript run for S statements at once;
//   kernel F  _fold_fn (:203), the fold inside _chain_fn (:782).
//
// --- kernel S ------------------------------------------------------------
//
// A transcript state is 32 bytes, 4 LE64 words. Every absorb and squeeze
// replaces it with
//
//   SHA3-256(state || label || head || payload)
//
// where the label (at most 16 bytes, a compile-time string of the caller)
// starts at byte 32, lane 4, so it enters as the two lanes label[0] and
// label[1]; head is at most one LE64 word (a squeeze's counter, the
// length word of fri-final) and payload W LE64 words of this statement
// (a Merkle root, 4 words; the final polynomial, final_len words). The
// words after the label start at byte 32 + L, so lane j of the message
// takes its stream bytes from two neighbouring stream words (message_lane).
// SHA3's padding puts 0x06 after the message and 0x80 in the last byte of
// its last 136-byte block; where they meet they fold to 0x86.
//
// transcript_absorb writes the new states. transcript_squeeze draws
// `count` digests in a row with counters counter0, counter0 + 1, ...; each
// is the next state, and out[t, i] is the digest's first LE64 word reduced:
// the field challenge (one conditional subtract of p: the word is < 2^64 <
// 2p) or an index, the word AND a mask (the query bound n0/2 is a power of
// two). The last state goes to state_out.
//
// What bounds it: latency. A statement's permutations are sequential (each
// squeeze hashes the last digest), so the kernel takes one thread per
// statement (S <= 256 on the paths: one or two blocks) and lasts one
// Keccak-f per rate block in a row: one block for a root, a fold challenge
// or an index, five for fri-final at final_len 64, thirty in a row for the
// default queries. The lanes are built in registers from the state, the
// label lanes and the payload read from device memory; nothing is staged.
//
// --- kernel F ------------------------------------------------------------
//
// cur (S, n) Goldilocks words -> out (S, n/2):
//
//   out[r, i] = ((lo + hi) + c[r] (lo - hi) inv_x[i]) / 2,
//   lo = cur[r, i], hi = cur[r, i + n/2]
//
// with inv_x the layer's 1/x table (n/2 words) and c the S challenges,
// read from device memory (kernel S's output in the chain). What bounds
// it: bytes, 12 n S bytes moved against 3 products a word. One thread per
// output word, consecutive threads on consecutive words of lo, hi, inv_x
// and out.
#include <cstdint>
#include <cuda_runtime.h>

#include "keccak_f.cuh"
#include "modmath.cuh"

namespace {

constexpr int kRateLanes = 17;  // a SHA3-256 rate block, 136 bytes
constexpr int kRateBytes = 8 * kRateLanes;
constexpr int kSpongeThreads = 128;
constexpr int kFoldThreads = 256;
constexpr uint64_t kInv2 = 0x7FFFFFFF80000001ull;  // (p + 1) / 2

// One statement's message: state || label || head || payload.
struct Message {
  uint64_t state[4];
  uint64_t label0, label1;  // label bytes 0-7 and 8-15, LE, zero-padded
  int label_len;
  uint64_t head;
  int has_head;
  const uint64_t* payload;
  int words;

  __device__ long long length() const {
    return 32 + label_len + 8ll * (has_head + words);
  }
  // Word i of the stream that follows the label (head, then payload); 0
  // outside it.
  __device__ uint64_t stream_word(long long i) const {
    if (i < 0) return 0;
    if (has_head) {
      if (i == 0) return head;
      --i;
    }
    return i < words ? payload[i] : 0;
  }
  // Lane j of the padded message of `padded` bytes.
  __device__ uint64_t lane(long long j, long long len, long long padded) const {
    uint64_t v = j < 4 ? state[j] : 0;
    if (j == 4) v |= label0;
    if (j == 5) v |= label1;
    const long long o = 8 * j - (32 + label_len);  // stream byte at lane byte 0
    const long long a = o >> 3;                    // floor(o / 8)
    const int s = (int)(o & 7);
    uint64_t w = stream_word(a) >> (8 * s);
    if (s) w |= stream_word(a + 1) << (64 - 8 * s);
    v |= w;
    if ((len >> 3) == j) v ^= 0x06ull << (8 * (len & 7));
    if (j == padded / 8 - 1) v ^= 0x80ull << 56;
    return v;
  }
};

// a = the Keccak state after absorbing the padded message; its first 4
// lanes are the digest.
__device__ void sponge(const Message& m, uint64_t a[25]) {
  const long long len = m.length();
  const long long blocks = len / kRateBytes + 1;
  const long long padded = blocks * kRateBytes;
#pragma unroll
  for (int k = 0; k < 25; ++k) a[k] = 0;
  for (long long b = 0; b < blocks; ++b) {
#pragma unroll
    for (int k = 0; k < kRateLanes; ++k) a[k] ^= m.lane(b * kRateLanes + k, len, padded);
    keccak_f(a);
  }
}

__global__ void __launch_bounds__(kSpongeThreads) absorb_kernel(
    const uint64_t* __restrict__ state_in, uint64_t* __restrict__ state_out,
    const uint64_t* __restrict__ payload, int words, uint64_t head, int has_head,
    uint64_t label0, uint64_t label1, int label_len, int count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  Message m;
#pragma unroll
  for (int k = 0; k < 4; ++k) m.state[k] = state_in[4 * t + k];
  m.label0 = label0;
  m.label1 = label1;
  m.label_len = label_len;
  m.head = head;
  m.has_head = has_head;
  m.payload = payload + (long long)t * words;
  m.words = words;
  uint64_t a[25];
  sponge(m, a);
#pragma unroll
  for (int k = 0; k < 4; ++k) state_out[4 * t + k] = a[k];
}

__global__ void __launch_bounds__(kSpongeThreads) squeeze_kernel(
    const uint64_t* __restrict__ state_in, uint64_t* __restrict__ state_out,
    uint64_t* __restrict__ out, uint64_t counter0, int squeezes, uint64_t mask,
    int field, uint64_t label0, uint64_t label1, int label_len, int count) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  Message m;
#pragma unroll
  for (int k = 0; k < 4; ++k) m.state[k] = state_in[4 * t + k];
  m.label0 = label0;
  m.label1 = label1;
  m.label_len = label_len;
  m.has_head = 1;
  m.payload = nullptr;
  m.words = 0;
  uint64_t a[25];
  for (int i = 0; i < squeezes; ++i) {
    m.head = counter0 + (uint64_t)i;
    sponge(m, a);
#pragma unroll
    for (int k = 0; k < 4; ++k) m.state[k] = a[k];
    const uint64_t w = a[0];
    out[(long long)t * squeezes + i] =
        field ? (w >= Goldilocks::P ? w - Goldilocks::P : w) : (w & mask);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) state_out[4 * t + k] = m.state[k];
}

__global__ void __launch_bounds__(kFoldThreads) fold_kernel(
    const uint64_t* __restrict__ cur, const uint64_t* __restrict__ inv_x,
    const uint64_t* __restrict__ c, uint64_t* __restrict__ out, long long total,
    int log_half) {
  const long long half = 1ll << log_half;
  for (long long h = blockIdx.x * (long long)blockDim.x + threadIdx.x; h < total;
       h += (long long)gridDim.x * blockDim.x) {
    const long long r = h >> log_half;
    const long long i = h & (half - 1);
    const uint64_t* row = cur + (r << (log_half + 1));
    const uint64_t lo = row[i], hi = row[half + i];
    const uint64_t t = Goldilocks::mul(Goldilocks::mul(c[r], Goldilocks::sub(lo, hi)), inv_x[i]);
    out[h] = Goldilocks::mul(Goldilocks::add(Goldilocks::add(lo, hi), t), kInv2);
  }
}

int sponge_grid(int count) { return (count + kSpongeThreads - 1) / kSpongeThreads; }

}  // namespace

// state_in, state_out (count, 4) words; payload (count, words) words, or
// null with words = 0; the label as two LE lanes and its length (<= 16).
extern "C" int transcript_absorb(const uint64_t* state_in, uint64_t* state_out,
                                 const uint64_t* payload, int words, uint64_t head,
                                 int has_head, uint64_t label0, uint64_t label1,
                                 int label_len, int count, cudaStream_t stream) {
  if (count == 0) return 0;
  if (label_len < 0 || label_len > 16 || words < 0 || (words > 0 && payload == nullptr))
    return (int)cudaErrorInvalidValue;
  absorb_kernel<<<sponge_grid(count), kSpongeThreads, 0, stream>>>(
      state_in, state_out, payload, words, head, has_head != 0, label0, label1, label_len,
      count);
  return (int)cudaGetLastError();
}

// `squeezes` squeezes of label || LE64(counter0 + i) per statement: out
// (count, squeezes) words, the field challenges (field != 0) or the
// indices (first word AND mask); state_out (count, 4) the last digests.
extern "C" int transcript_squeeze(const uint64_t* state_in, uint64_t* state_out,
                                  uint64_t* out, uint64_t counter0, int squeezes,
                                  uint64_t mask, int field, uint64_t label0,
                                  uint64_t label1, int label_len, int count,
                                  cudaStream_t stream) {
  if (count == 0) return 0;
  if (label_len < 0 || label_len > 16 || squeezes < 1) return (int)cudaErrorInvalidValue;
  squeeze_kernel<<<sponge_grid(count), kSpongeThreads, 0, stream>>>(
      state_in, state_out, out, counter0, squeezes, mask, field, label0, label1, label_len,
      count);
  return (int)cudaGetLastError();
}

// cur (rows, 2^(log_half+1)), inv_x (2^log_half), c (rows) canonical
// Goldilocks words -> out (rows, 2^log_half).
extern "C" int fri_fold(const uint64_t* cur, const uint64_t* inv_x, const uint64_t* c,
                        uint64_t* out, int rows, int log_half, cudaStream_t stream) {
  if (rows == 0) return 0;
  if (log_half < 0 || log_half > 40) return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows << log_half;
  const long long blocks = (total + kFoldThreads - 1) / kFoldThreads;
  const int grid = (int)(blocks < (1ll << 20) ? blocks : (1ll << 20));
  fold_kernel<<<grid, kFoldThreads, 0, stream>>>(cur, inv_x, c, out, total, log_half);
  return (int)cudaGetLastError();
}
