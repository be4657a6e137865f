// Kernels S and F: the Fiat-Shamir transcript sponge and the fold of the
// device-resident FRI chain (proof/fri_device.py, fri_chain_dispatch).
//
// Neither replaces a Pallas kernel: they are the hand-written counterparts
// of XLA device functions of the JAX package's chain,
// lambda_snark_tpu/proof/fri_device.py:
//
//   kernel S  _sha3_bytes_dev (:678), DevTranscript (:736) and
//             _challenge_planes (:767): the SHA3-256 ratchet of
//             FriTranscript run for S statements at once;
//   kernel F  _fold_fn (:203), and the body of a layer of _chain_fn
//             (:820-842): absorb the last layer's root, squeeze the fold
//             challenge, fold.
//
// --- the sponge (both kernels) --------------------------------------------
//
// A transcript state is 32 bytes, 4 LE64 words. Every absorb and squeeze
// replaces it with
//
//   SHA3-256(state || label || head || payload)
//
// where the label (at most 16 bytes) starts at byte 32, lane 4; head is at
// most one LE64 word (a squeeze's counter, the length word of fri-final)
// and payload W LE64 words of this statement (a Merkle root, 4 words; the
// final polynomial, final_len words). The words after the label start at
// byte 32 + L, so lane j of the message takes its stream bytes from two
// neighbouring stream words (message_lane). SHA3's padding puts 0x06 after
// the message and 0x80 in the last byte of its last 136-byte block; where
// they meet they fold to 0x86.
//
// A squeeze's block is static but for the state and the counter: the
// wrapper builds its other lanes (the label, the padding) once a launch
// (ops/keccak.py, squeeze_lanes) and names the lane and byte where the
// LE64 counter starts; the kernel writes the 4 state lanes and ORs the
// counter into one lane, or two where it straddles them. message_lane, the
// general path, serves only absorbs (a runtime payload width).
//
// What bounds it: latency. A statement's permutations form one chain (each
// squeeze hashes the last digest), so its least time is the critical path
// of a permutation, about 7 dependent instructions a round (two LOP3 levels
// for theta's column parity, the 1-bit rotate and xor of D, rho's xor and
// rotate, chi as one LOP3), not the card's throughput. The design:
// one warp a statement, each of the warp's lanes holding one Keccak lane
// (KeccakWarp, keccak_f.cuh: three levels of shuffles a round instead of
// one thread issuing ~190 instructions a round), 24 rounds unrolled, the
// state in registers, statements one block each over the SMs.
//
// sponge_kernel: per statement, an optional absorb, then `squeezes`
// squeezes with counters counter0, counter0 + 1, ...; out[t, i] is the i-th
// digest's first LE64 word reduced: the field challenge (one conditional
// subtract of p: the word is < 2^64 < 2p) or an index, the word AND a mask
// (the query bound n0/2 is a power of two). The last state goes to
// state_out. Entries: transcript_absorb (an absorb), transcript_squeeze
// (squeezes), transcript_final_queries (the chain's fri-final absorb and
// its query squeezes in one launch).
//
// --- kernel F ------------------------------------------------------------
//
// cur (S, n) Goldilocks words -> out (S, n/2):
//
//   out[r, i] = ((lo + hi) + c[r] (lo - hi) inv_x[i]) / 2,
//   lo = cur[r, i], hi = cur[r, i + n/2]
//
// with inv_x the layer's 1/x table (n/2 words). fri_fold_squeeze (the
// chain) draws c[r] itself: it absorbs the last layer's root into the
// state (from the second layer on), squeezes fri-fold at its counter and
// reduces the digest, then writes the new state to state_out; fri_fold
// (kind 9's per-layer route, whose challenges come from the host) reads
// c from a device table. One launch either way.
//
// What bounds it: bytes, 12 n S bytes moved against 3 products a word; in
// the chain also the sponge's latency (two permutations) ahead of the
// fold. fri_fold (fold_kernel) is a word a thread over the grid.
// fri_fold_squeeze (fold_squeeze_kernel) spreads a row over blocks of 256
// threads, two words a thread with 16-byte loads; every block squeezes its
// row's challenge for itself with its first warp, and the grid is one wave
// (kernels.fold_grid: two blocks an SM at the sponge's registers), so every
// thread's first two units are loaded, and their products taken, while the
// warp squeezes. The state and the root are loaded ahead of the codewords,
// so the warp waits on memory once. Clusters whose rank-0 block squeezed
// once for the others were slower at every chain shape: the sponge's
// latency, not its repeats, bounds the launch.
#include <cstdint>
#include <cuda_runtime.h>

#include "keccak_f.cuh"
#include "modmath.cuh"

namespace {

constexpr int kRateLanes = 17;  // a SHA3-256 rate block, 136 bytes
constexpr int kRateBytes = 8 * kRateLanes;
constexpr int kFoldThreads = 256;
constexpr int kFoldBlocksPerSm = 2;  // kernels.FOLD_BLOCKS_PER_SM
constexpr uint64_t kInv2 = 0x7FFFFFFF80000001ull;  // (p + 1) / 2

// An absorb's message: state || label || head || payload.
struct Absorb {
  uint64_t label0, label1;  // label bytes 0-7 and 8-15, LE, zero-padded
  int label_len;
  uint64_t head;
  int has_head;
  int words;  // payload words a statement
};

// A squeeze's block: every lane but the state's (0-3) and the counter's,
// and where the LE64 counter starts (lane, byte).
struct Squeeze {
  uint64_t lanes[kRateLanes];
  int lane, shift;
};

__device__ __forceinline__ uint64_t stream_word(long long i, const Absorb& m,
                                                const uint64_t* payload) {
  if (i < 0) return 0;
  if (m.has_head) {
    if (i == 0) return m.head;
    --i;
  }
  return i < m.words ? payload[i] : 0;
}

// Lane j of the padded absorb message of `len` bytes in `padded`; own is the
// state word j for j < 4.
__device__ uint64_t message_lane(long long j, uint64_t own, const Absorb& m,
                                 const uint64_t* payload, long long len, long long padded) {
  uint64_t v = j < 4 ? own : 0;
  if (j == 4) v |= m.label0;
  if (j == 5) v |= m.label1;
  const long long o = 8 * j - (32 + m.label_len);  // stream byte at lane byte 0
  const long long a = o >> 3;                      // floor(o / 8)
  const int s = (int)(o & 7);
  uint64_t w = stream_word(a, m, payload) >> (8 * s);
  if (s) w |= stream_word(a + 1, m, payload) << (64 - 8 * s);
  v |= w;
  if ((len >> 3) == j) v ^= 0x06ull << (8 * (len & 7));
  if (j == padded / 8 - 1) v ^= 0x80ull << 56;
  return v;
}

__device__ __forceinline__ uint64_t reduce(uint64_t w, uint64_t mask, bool field) {
  return field ? (w >= Goldilocks::P ? w - Goldilocks::P : w) : (w & mask);
}

// One statement's sponge on one warp: `a` is this lane's word of the state
// (the state word for lanes 0-3, else 0); an optional absorb, then
// `squeezes` squeezes, lane 0 writing each output to out[i]. Returns this
// lane's word of the last Keccak state: lanes 0-3 hold the new state.
__device__ uint64_t sponge(const KeccakWarp& w, int t, uint64_t a, bool absorb,
                           const Absorb& ab, const uint64_t* payload, const Squeeze& sq,
                           uint64_t counter0, int squeezes, uint64_t* out, uint64_t mask,
                           bool field) {
  if (absorb) {
    const long long len = 32 + ab.label_len + 8ll * (ab.has_head + ab.words);
    const long long blocks = len / kRateBytes + 1;
    const uint64_t own = a;
    a = 0;
    for (long long b = 0; b < blocks; ++b) {
      if (t < kRateLanes)
        a ^= message_lane(b * kRateLanes + t, own, ab, payload, len, blocks * kRateBytes);
      a = w.permute(a);
    }
  }
  const uint64_t fixed = t >= 4 && t < kRateLanes ? sq.lanes[t] : 0;
  const int s = 8 * sq.shift;
  for (int i = 0; i < squeezes; ++i) {
    const uint64_t ctr = counter0 + (uint64_t)i;
    if (t >= 4) {
      a = fixed;
      if (t == sq.lane) a |= ctr << s;
      if (s && t == sq.lane + 1) a |= ctr >> (64 - s);
    }
    a = w.permute(a);
    if (t == 0) out[i] = reduce(a, mask, field);
  }
  return a;
}

__global__ void __launch_bounds__(32) sponge_kernel(
    const uint64_t* __restrict__ state_in, uint64_t* __restrict__ state_out,
    uint64_t* __restrict__ out, int absorb, Absorb ab, const uint64_t* __restrict__ payload,
    Squeeze sq, uint64_t counter0, int squeezes, uint64_t mask, int field) {
  const int row = blockIdx.x, t = threadIdx.x;
  const KeccakWarp w(t);
  uint64_t a = t < 4 ? state_in[4 * row + t] : 0;
  a = sponge(w, t, a, absorb != 0, ab, payload + (long long)row * ab.words, sq, counter0,
             squeezes, out + (long long)row * squeezes, mask, field != 0);
  if (t < 4) state_out[4 * row + t] = a;
}

// One thread's unit of the fold: two words (vec) or one.
struct FoldUnit {
  uint64_t sum[2], diff[2];  // lo + hi and (lo - hi) inv_x
};

__device__ __forceinline__ FoldUnit fold_load(const uint64_t* lo, const uint64_t* hi,
                                              const uint64_t* x, bool vec) {
  FoldUnit u;
  uint64_t l[2], h[2], v[2];
  if (vec) {
    const ulonglong2 l2 = *reinterpret_cast<const ulonglong2*>(lo);
    const ulonglong2 h2 = *reinterpret_cast<const ulonglong2*>(hi);
    const ulonglong2 v2 = *reinterpret_cast<const ulonglong2*>(x);
    l[0] = l2.x, l[1] = l2.y, h[0] = h2.x, h[1] = h2.y, v[0] = v2.x, v[1] = v2.y;
  } else {
    l[0] = *lo, h[0] = *hi, v[0] = *x;
    l[1] = h[1] = v[1] = 0;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    u.sum[k] = Goldilocks::add(l[k], h[k]);
    u.diff[k] = Goldilocks::mul(Goldilocks::sub(l[k], h[k]), v[k]);
  }
  return u;
}

__device__ __forceinline__ void fold_store(uint64_t* out, const FoldUnit& u, uint64_t c,
                                           bool vec) {
  uint64_t r[2];
#pragma unroll
  for (int k = 0; k < 2; ++k)
    r[k] = Goldilocks::mul(Goldilocks::add(u.sum[k], Goldilocks::mul(c, u.diff[k])), kInv2);
  if (vec) *reinterpret_cast<ulonglong2*>(out) = make_ulonglong2(r[0], r[1]);
  else *out = r[0];
}

// The fold with given challenges c[r] (kind 9's per-layer route), a word a
// thread: kind 9 folds one row of 2^10 to 2^18 words a layer, launches of
// 2-4 us on an H100, where this form ran faster than fold_squeeze_kernel's
// blocks of two words a thread with c given.
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

// The chain's layer: a row of 2^log_half outputs over 2^log_blocks
// blocks, each block a contiguous chunk, its threads two units apart in a
// loop. Each block's first warp absorbs root[r] (if root != null),
// squeezes and reduces into shared memory once every thread has loaded its
// first two units and taken their products; block 0 of the row writes
// state_out[r]. The state and root words are loaded ahead of the
// codewords.
__global__ void __launch_bounds__(kFoldThreads, kFoldBlocksPerSm) fold_squeeze_kernel(
    const uint64_t* __restrict__ cur, const uint64_t* __restrict__ inv_x,
    const uint64_t* __restrict__ state_in, const uint64_t* __restrict__ root,
    uint64_t* __restrict__ state_out, uint64_t* __restrict__ out, Absorb ab, Squeeze sq,
    uint64_t counter, int log_half, int log_blocks, int vec) {
  __shared__ uint64_t challenge, root_words[4];
  const int t = threadIdx.x;
  const int row = blockIdx.x >> log_blocks;
  const int part = blockIdx.x & ((1 << log_blocks) - 1);
  const uint64_t own = t < 4 ? state_in[4 * row + t] : 0;
  const uint64_t mine = t < 4 && root != nullptr ? root[4 * row + t] : 0;
  const long long half = 1ll << log_half;
  const long long chunk = half >> log_blocks;
  const int step = vec ? 2 : 1;
  const long long units = chunk / step;
  const uint64_t* lo = cur + ((long long)row << (log_half + 1)) + (long long)part * chunk;
  const uint64_t* x = inv_x + (long long)part * chunk;
  uint64_t* dst = out + ((long long)row << log_half) + (long long)part * chunk;
  const auto load = [&](long long u) {
    return fold_load(lo + u * step, lo + half + u * step, x + u * step, vec);
  };

  const long long u0 = t, u1 = u0 + kFoldThreads;
  FoldUnit p0 = {}, p1 = {};
  if (u0 < units) p0 = load(u0);
  if (u1 < units) p1 = load(u1);
  if (t < 32) {
    if (t < 4) root_words[t] = mine;
    __syncwarp();
    const KeccakWarp w(t);
    const uint64_t a = sponge(w, t, own, root != nullptr, ab, root_words, sq, counter, 1,
                              &challenge, 0, true);
    if (part == 0 && t < 4) state_out[4 * row + t] = a;
  }
  __syncthreads();
  const uint64_t c = challenge;
  if (u0 < units) fold_store(dst + u0 * step, p0, c, vec);
  if (u1 < units) fold_store(dst + u1 * step, p1, c, vec);
  for (long long u = u0 + 2 * kFoldThreads; u < units; u += 2 * kFoldThreads) {
    const long long v = u + kFoldThreads;
    const FoldUnit a = load(u);
    FoldUnit b = {};
    if (v < units) b = load(v);
    fold_store(dst + u * step, a, c, vec);
    if (v < units) fold_store(dst + v * step, b, c, vec);
  }
}

Absorb make_absorb(uint64_t label0, uint64_t label1, int label_len, uint64_t head,
                   int has_head, int words) {
  return Absorb{label0, label1, label_len, head, has_head != 0, words};
}

// lanes: the 17 lanes of a squeeze's block (host memory, read here).
int make_squeeze(const uint64_t* lanes, int lane, int shift, Squeeze* sq) {
  if (lanes == nullptr || lane < 4 || lane + (shift != 0) >= kRateLanes || shift < 0 ||
      shift > 7)
    return (int)cudaErrorInvalidValue;
  for (int k = 0; k < kRateLanes; ++k) sq->lanes[k] = lanes[k];
  sq->lane = lane;
  sq->shift = shift;
  return 0;
}

int sponge_launch(const uint64_t* state_in, uint64_t* state_out, uint64_t* out, int absorb,
                  const Absorb& ab, const uint64_t* payload, const Squeeze& sq,
                  uint64_t counter0, int squeezes, uint64_t mask, int field, int count,
                  cudaStream_t stream) {
  if (count == 0) return 0;
  if (ab.label_len < 0 || ab.label_len > 16 || ab.words < 0 || squeezes < 0 ||
      (ab.words > 0 && payload == nullptr))
    return (int)cudaErrorInvalidValue;
  sponge_kernel<<<count, 32, 0, stream>>>(state_in, state_out, out, absorb, ab, payload, sq,
                                          counter0, squeezes, mask, field);
  return (int)cudaGetLastError();
}

}  // namespace

// state_in, state_out (count, 4) words; payload (count, words) words, or
// null with words = 0; the label as two LE lanes and its length (<= 16).
extern "C" int transcript_absorb(const uint64_t* state_in, uint64_t* state_out,
                                 const uint64_t* payload, int words, uint64_t head,
                                 int has_head, uint64_t label0, uint64_t label1,
                                 int label_len, int count, cudaStream_t stream) {
  return sponge_launch(state_in, state_out, nullptr, 1,
                       make_absorb(label0, label1, label_len, head, has_head, words), payload,
                       Squeeze{}, 0, 0, 0, 0, count, stream);
}

// `squeezes` squeezes of the block `lanes` with LE64(counter0 + i) at
// (lane, shift) per statement: out (count, squeezes) words, the field
// challenges (field != 0) or the indices (first word AND mask); state_out
// (count, 4) the last digests.
extern "C" int transcript_squeeze(const uint64_t* state_in, uint64_t* state_out,
                                  uint64_t* out, const uint64_t* lanes, int lane, int shift,
                                  uint64_t counter0, int squeezes, uint64_t mask, int field,
                                  int count, cudaStream_t stream) {
  Squeeze sq;
  const int rc = make_squeeze(lanes, lane, shift, &sq);
  if (rc != 0 || squeezes < 1) return rc != 0 ? rc : (int)cudaErrorInvalidValue;
  return sponge_launch(state_in, state_out, out, 0, Absorb{}, nullptr, sq, counter0, squeezes,
                       mask, field, count, stream);
}

// The chain's tail in one launch: absorb label || LE64(head) || payload
// (fri-final: the length word and the final polynomial), then `squeezes`
// index squeezes (fri-query) as transcript_squeeze with field = 0.
extern "C" int transcript_final_queries(const uint64_t* state_in, uint64_t* state_out,
                                        uint64_t* out, const uint64_t* payload, int words,
                                        uint64_t head, uint64_t label0, uint64_t label1,
                                        int label_len, const uint64_t* lanes, int lane,
                                        int shift, uint64_t counter0, int squeezes,
                                        uint64_t mask, int count, cudaStream_t stream) {
  Squeeze sq;
  const int rc = make_squeeze(lanes, lane, shift, &sq);
  if (rc != 0 || squeezes < 1) return rc != 0 ? rc : (int)cudaErrorInvalidValue;
  return sponge_launch(state_in, state_out, out, 1,
                       make_absorb(label0, label1, label_len, head, 1, words), payload, sq,
                       counter0, squeezes, mask, 0, count, stream);
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

// The chain's layer: per row, absorb label || root[r] (root (rows, 4), or
// null on the first layer) into state_in[r], squeeze the block `lanes` with
// LE64(counter) at (lane, shift), reduce the digest mod p to c[r], write
// the state to state_out[r] and fold as fri_fold, over 2^log_blocks blocks
// a row.
extern "C" int fri_fold_squeeze(const uint64_t* cur, const uint64_t* inv_x,
                                const uint64_t* state_in, const uint64_t* root,
                                uint64_t* state_out, uint64_t* out, int rows, int log_half,
                                int log_blocks, uint64_t label0, uint64_t label1, int label_len,
                                const uint64_t* lanes, int lane, int shift, uint64_t counter,
                                cudaStream_t stream) {
  Squeeze sq;
  const int rc = make_squeeze(lanes, lane, shift, &sq);
  if (rc != 0) return rc;
  if (rows == 0) return 0;
  if (log_half < 0 || log_half > 40 || log_blocks < 0 || log_blocks > log_half ||
      (long long)rows << log_blocks > 0x7FFFFFFFll || label_len < 0 || label_len > 16 ||
      state_in == nullptr || state_out == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return ((uintptr_t)p & 15) == 0; };
  const int vec = log_half > log_blocks && aligned(cur) && aligned(inv_x) && aligned(out);
  fold_squeeze_kernel<<<rows << log_blocks, kFoldThreads, 0, stream>>>(
      cur, inv_x, state_in, root, state_out, out, make_absorb(label0, label1, label_len, 0, 0, 4),
      sq, counter, log_half, log_blocks, vec);
  return (int)cudaGetLastError();
}
