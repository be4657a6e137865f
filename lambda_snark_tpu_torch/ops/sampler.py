"""Discrete Gaussian sampling in torch ops, draw for draw with the JAX
package: counter-mode threefry (``jax.random``) and per-seed ChaCha20
streams (``chacha20_blocks`` / ``sample_chacha_signed``, below).

The counterpart of ``sample_planes_global`` and ``magnitudes_from_bits`` in
the JAX package's ``ops/sampler_jax.py``. The draw for (stream j, statement
b, ring position t) is

    k_t  = fold_in(fold_in(fold_in(key, j), b), t)
    bits = jax.random.bits(k_t, (3,), uint32)      # u_hi, u_lo, sign

under threefry2x32 with ``jax_threefry_partitionable=True`` (jax 0.9.0,
``jax/_src/prng.py``: ``threefry_2x32`` :1092, ``threefry_fold_in`` :1163,
``_threefry_random_bits_partitionable`` :1184). Here that is:

    fold_in(k, d)   = threefry2x32(k, (0, d))           (both output words)
    bits(k, (3,))_i = xor of threefry2x32(k, (0, i))     (i = 0, 1, 2)
    PRNGKey(s)      = (0, s) for 0 <= s < 2^31

The magnitude is the count of CDF entries strictly below u = u_hi:u_lo; the
sign bit negates nonzero magnitudes. 32-bit words live in int64 tensors and
are masked after every add; rotations shift by at most 29 bits, so nothing
overflows.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from . import modarith

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on 32-bit words given as ints or int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for 0 <= seed < 2^31."""
    if not 0 <= seed < (1 << 31):
        raise ValueError(f"seed {seed} outside [0, 2^31)")
    return (0, seed)


def fold_in(key, data):
    """``jax.random.fold_in``: the key (k0, k1) folded with 32-bit ``data``."""
    return threefry2x32(key[0], key[1], 0, data)


def random_bits3(key):
    """``jax.random.bits(key, (3,), uint32)`` as three words."""
    words = []
    for i in range(3):
        y0, y1 = threefry2x32(key[0], key[1], 0, i)
        words.append(y0 ^ y1)
    return words


def magnitudes_from_bits(u_hi: torch.Tensor, u_lo: torch.Tensor,
                         cdf: torch.Tensor) -> torch.Tensor:
    """Count of CDF words (unsigned) strictly below each u = u_hi:u_lo
    (``sampler_jax.magnitudes_from_bits``); ``cdf`` holds u64 words."""
    u = modarith.join(u_hi, u_lo)
    mags = torch.zeros(u.shape, dtype=torch.int32, device=u.device)
    for entry in cdf.unbind(0):
        mags += modarith.ult(entry, u).to(torch.int32)
    return mags


def sample_signed(key: Key, streams: Sequence[int], b_global: torch.Tensor,
                  positions: torch.Tensor, cdf: torch.Tensor) -> torch.Tensor:
    """Signed Gaussian draws (len(streams), B, L) int32 for the statements
    ``b_global`` (B,) and ring positions ``positions`` (L,), both int64.

    Each stream's slice equals the ``signed`` output of
    ``sample_planes_global(key, j, b_global, positions, ...)``."""
    dev = b_global.device
    kj = [fold_in(key, j) for j in streams]
    kj0 = torch.tensor([k[0] for k in kj], dtype=torch.int64, device=dev)[:, None, None]
    kj1 = torch.tensor([k[1] for k in kj], dtype=torch.int64, device=dev)[:, None, None]
    kb = fold_in((kj0, kj1), b_global[None, :, None])  # (S, B, 1)
    kt = fold_in(kb, positions[None, None, :])  # (S, B, L)
    u_hi, u_lo, sign = random_bits3(kt)
    mags = magnitudes_from_bits(u_hi, u_lo, cdf.to(dev))
    flip = ((sign & 1) == 1) & (mags != 0)
    return torch.where(flip, -mags, mags)



# --- ChaCha20 streams (the host commitment's randomness) ----------------------
#
# The counterpart of ``sampler_jax.chacha20_blocks_in_graph`` and
# ``sample_chacha_planes_in_graph``: the per-seed ChaCha20 streams of
# ``lwe.randomness_batch``, generated on the device from the 32-byte keys.

_CHACHA_CONSTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl32(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & M32


def _quarter(x, a: int, b: int, c: int, d: int) -> None:
    x[a] = (x[a] + x[b]) & M32
    x[d] = _rotl32(x[d] ^ x[a], 16)
    x[c] = (x[c] + x[d]) & M32
    x[b] = _rotl32(x[b] ^ x[c], 12)
    x[a] = (x[a] + x[b]) & M32
    x[d] = _rotl32(x[d] ^ x[a], 8)
    x[c] = (x[c] + x[d]) & M32
    x[b] = _rotl32(x[b] ^ x[c], 7)


def chacha20_blocks(key_words: torch.Tensor, nblocks: int) -> torch.Tensor:
    """ChaCha20 keystream blocks (DJB variant, zero nonce, counters
    0..nblocks-1) for keys (S, 8) of 32-bit words in int64: (S, nblocks, 16),
    row (s, b) equal to ``utils.chacha.chacha20_block(key_s, b, [0, 0])``."""
    s = key_words.shape[0]
    dev = key_words.device
    zero = torch.zeros((s, nblocks), dtype=torch.int64, device=dev)
    state = [zero + c for c in _CHACHA_CONSTS]
    state += [zero + key_words[:, i, None] for i in range(8)]
    state += [zero + torch.arange(nblocks, dtype=torch.int64, device=dev), zero, zero, zero]
    x = list(state)
    for _ in range(10):
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return torch.stack([(xi + si) & M32 for xi, si in zip(x, state)], dim=-1)


def sample_chacha_signed(key_words: torch.Tensor, k: int, n: int,
                         cdf: torch.Tensor) -> torch.Tensor:
    """Signed Gaussian draws (S, k + 1, n) int32 for keys (S, 8): per
    statement one ChaCha20 stream gives k + 1 rows of 2n u64 draws, value
    and sign interleaved (value j = words 4j, 4j+1; sign = word 4j+2 bit 0);
    rows 0..k-1 are s_1..s_k and row k is e, as ``lwe.randomness_batch``."""
    s = key_words.shape[0]
    total_words = (k + 1) * 4 * n
    if total_words % 16:
        raise ValueError(f"(k + 1) 4 n = {total_words} must be a multiple of 16")
    w = chacha20_blocks(key_words, total_words // 16).reshape(s, k + 1, 4 * n)
    mags = magnitudes_from_bits(w[..., 1::4], w[..., 0::4], cdf.to(w.device))
    flip = ((w[..., 2::4] & 1) == 1) & (mags != 0)
    return torch.where(flip, -mags, mags)
