"""ChaCha20 generator with bit-parity to Rust's ``rand_chacha::ChaCha20Rng``.

The port's copy of the host part of ``utils/chacha.py``: ``seed_from_u64``
(rand_core 0.6's PCG32 seed expansion), the DJB-variant block function, its
numpy forms over consecutive counters (one key or many), and the generator, with
``next_u64`` = two keystream words, low first, and ``fill_u64`` the same
draws vectorised. ZK blinding factors and masks (``prover_batched``,
``proof.succinct_batch``) and the host Gaussian sampler (``ops.gaussian``)
draw from it.
"""

from __future__ import annotations

from typing import List

import numpy as np

M32 = 0xFFFFFFFF
M64 = 0xFFFFFFFFFFFFFFFF


def seed_from_u64(state: int) -> bytes:
    """Expand a u64 into a 32-byte seed exactly like rand_core 0.6."""
    mul = 6364136223846793005
    inc = 11634580027462260723
    out = bytearray()
    state &= M64
    for _ in range(8):
        state = (state * mul + inc) & M64
        xorshifted = (((state >> 18) ^ state) >> 27) & M32
        rot = (state >> 59) & 31
        x = ((xorshifted >> rot) | (xorshifted << ((32 - rot) & 31))) & M32
        out += x.to_bytes(4, "little")
    return bytes(out)


def _quarter(a: int, b: int, c: int, d: int):
    a = (a + b) & M32
    d ^= a
    d = ((d << 16) | (d >> 16)) & M32
    c = (c + d) & M32
    b ^= c
    b = ((b << 12) | (b >> 20)) & M32
    a = (a + b) & M32
    d ^= a
    d = ((d << 8) | (d >> 24)) & M32
    c = (c + d) & M32
    b ^= c
    b = ((b << 7) | (b >> 25)) & M32
    return a, b, c, d


def chacha20_block(key_words: List[int], counter: int, nonce_words: List[int]) -> List[int]:
    """One 16-word ChaCha20 block (64-bit counter, 64-bit nonce)."""
    state = [
        0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
        *key_words,
        counter & M32, (counter >> 32) & M32,
        nonce_words[0], nonce_words[1],
    ]
    x = list(state)
    for _ in range(10):
        x[0], x[4], x[8], x[12] = _quarter(x[0], x[4], x[8], x[12])
        x[1], x[5], x[9], x[13] = _quarter(x[1], x[5], x[9], x[13])
        x[2], x[6], x[10], x[14] = _quarter(x[2], x[6], x[10], x[14])
        x[3], x[7], x[11], x[15] = _quarter(x[3], x[7], x[11], x[15])
        x[0], x[5], x[10], x[15] = _quarter(x[0], x[5], x[10], x[15])
        x[1], x[6], x[11], x[12] = _quarter(x[1], x[6], x[11], x[12])
        x[2], x[7], x[8], x[13] = _quarter(x[2], x[7], x[8], x[13])
        x[3], x[4], x[9], x[14] = _quarter(x[3], x[4], x[9], x[14])
    return [(xi + si) & M32 for xi, si in zip(x, state)]


def _quarter_np(x, a: int, b: int, c: int, d: int) -> None:
    """A quarter round on state rows of ``x`` (uint32, in place)."""
    x[a] += x[b]
    x[d] ^= x[a]
    x[d] = (x[d] << np.uint32(16)) | (x[d] >> np.uint32(16))
    x[c] += x[d]
    x[b] ^= x[c]
    x[b] = (x[b] << np.uint32(12)) | (x[b] >> np.uint32(20))
    x[a] += x[b]
    x[d] ^= x[a]
    x[d] = (x[d] << np.uint32(8)) | (x[d] >> np.uint32(24))
    x[c] += x[d]
    x[b] ^= x[c]
    x[b] = (x[b] << np.uint32(7)) | (x[b] >> np.uint32(25))


def _blocks_np(state: np.ndarray) -> np.ndarray:
    """Twenty rounds on a uint32 state of 16 rows (any trailing shape),
    plus the input state: the block function, vectorised."""
    x = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):
            _quarter_np(x, 0, 4, 8, 12)
            _quarter_np(x, 1, 5, 9, 13)
            _quarter_np(x, 2, 6, 10, 14)
            _quarter_np(x, 3, 7, 11, 15)
            _quarter_np(x, 0, 5, 10, 15)
            _quarter_np(x, 1, 6, 11, 12)
            _quarter_np(x, 2, 7, 8, 13)
            _quarter_np(x, 3, 4, 9, 14)
        x += state
    return x


def _blocks_state(keys: np.ndarray, counter: int, nonce_words: List[int],
                  nblocks: int) -> np.ndarray:
    """The input states of ``nblocks`` consecutive counters for each key of
    ``keys`` (uint32 (K, 8)), as uint32 (16, K, nblocks)."""
    ctrs = np.arange(nblocks, dtype=np.uint64) + np.uint64(counter)
    state = np.empty((16, keys.shape[0], nblocks), dtype=np.uint32)
    state[0], state[1], state[2], state[3] = 0x61707865, 0x3320646E, 0x79622D32, 0x6B206574
    state[4:12] = keys.T[:, :, None]
    state[12] = (ctrs & np.uint64(M32)).astype(np.uint32)
    state[13] = (ctrs >> np.uint64(32)).astype(np.uint32)
    state[14], state[15] = nonce_words[0], nonce_words[1]
    return state


def chacha20_blocks_np(key_words: List[int], counter: int, nonce_words: List[int],
                       nblocks: int) -> np.ndarray:
    """``nblocks`` consecutive blocks as uint32 (nblocks, 16): row b is
    ``chacha20_block(key, counter + b, nonce)`` word for word."""
    keys = np.asarray(key_words, dtype=np.uint32)[None]
    return _blocks_np(_blocks_state(keys, counter, nonce_words, nblocks))[:, 0].T


def chacha20_blocks_keys_np(keys_words: np.ndarray, counter: int, nonce_words: List[int],
                            nblocks: int) -> np.ndarray:
    """``nblocks`` consecutive blocks for many keys at once: uint32
    (K, nblocks, 16) from ``keys_words`` uint32 (K, 8); row (k, b) is
    ``chacha20_block(keys[k], counter + b, nonce)`` word for word."""
    keys = np.asarray(keys_words, dtype=np.uint32).reshape(-1, 8)
    x = _blocks_np(_blocks_state(keys, counter, nonce_words, nblocks))
    return np.moveaxis(x, 0, -1)


class ChaCha20Rng:
    """Parity implementation of ``rand_chacha::ChaCha20Rng``."""

    def __init__(self, seed: bytes) -> None:
        if len(seed) != 32:
            raise ValueError("ChaCha20Rng seed must be 32 bytes")
        self._key = [int.from_bytes(seed[i : i + 4], "little") for i in range(0, 32, 4)]
        self._counter = 0
        self._buf: List[int] = []

    @classmethod
    def from_u64(cls, seed: int) -> "ChaCha20Rng":
        return cls(seed_from_u64(seed))

    def next_u32(self) -> int:
        if not self._buf:
            self._buf = chacha20_block(self._key, self._counter, [0, 0])
            self._counter += 1
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def gen_u64_mod(self, modulus: int) -> int:
        """``next_u64() % modulus``, the reference's blinding draw."""
        return self.next_u64() % modulus

    def _keystream_u32(self, n: int) -> np.ndarray:
        """The next ``n`` keystream words, as ``n`` calls of ``next_u32``
        give them: the buffered words first, then whole blocks."""
        take = min(len(self._buf), n)
        head = np.array(self._buf[:take], dtype=np.uint32)
        del self._buf[:take]
        rem = n - take
        if rem == 0:
            return head
        nblocks = (rem + 15) // 16
        flat = chacha20_blocks_np(self._key, self._counter, [0, 0], nblocks).reshape(-1)
        self._counter += nblocks
        self._buf = [int(w) for w in flat[rem:]]
        return np.concatenate([head, flat[:rem]])

    def fill_u64(self, count: int) -> np.ndarray:
        """The next ``count`` ``next_u64`` draws as a uint64 array."""
        w = self._keystream_u32(2 * count).astype(np.uint64)
        return w[0::2] | (w[1::2] << np.uint64(32))
