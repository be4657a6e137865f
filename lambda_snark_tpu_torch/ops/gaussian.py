"""Discrete Gaussian sampling by a CDT table (the port's copy of
``ops/gaussian.py``).

The table is a protocol constant: support cut at ceil(12 sigma) (at least
8), weights exp(-k^2 / (2 sigma^2)) doubled for k > 0, scaled to u64 in
float64 with sequential summation, last entry forced to 2^64 - 1. A sample
draws one u64 u for its magnitude, the first index k with cdf[k] >= u (the
count of entries strictly below u), and one u64 whose low bit is its sign;
zero is never negated. The host samplers here draw from a
``utils.chacha.ChaCha20Rng``; the device samplers (``ops.sampler``) read the
same table.
"""

from __future__ import annotations

import math
from typing import List

import numpy as np

from ..utils.chacha import ChaCha20Rng

TAIL_CUTOFF = 12.0
U64_MAX = (1 << 64) - 1


def build_cdf(sigma: float) -> np.ndarray:
    """The u64 CDF table for width ``sigma``, bit-identical to the JAX package's."""
    if not (sigma > 0.0) or not math.isfinite(sigma):
        raise ValueError(f"sigma must be positive and finite, got {sigma}")
    bound = max(math.ceil(TAIL_CUTOFF * sigma), 8)
    weights = []
    total = 0.0
    for k in range(bound + 1):
        w = math.exp(-(float(k) * float(k)) / (2.0 * sigma * sigma))
        if k > 0:
            w *= 2.0
        weights.append(w)
        total += w
    out = np.empty(bound + 1, dtype=np.uint64)
    if total == 0.0:
        out.fill(0)
        out[-1] = U64_MAX
        return out
    scale = float(U64_MAX) / total
    cumulative = 0.0
    for k, w in enumerate(weights):
        cumulative += w
        value = cumulative * scale
        if value >= float(U64_MAX):
            out[k] = U64_MAX
        elif value <= 0.0:
            out[k] = 0
        else:
            out[k] = int(value)
    out[-1] = U64_MAX
    return out


def _magnitude_from_uniform(u: int, cdf_list: List[int]) -> int:
    """First index k with cdf[k] >= u."""
    for k, c in enumerate(cdf_list):
        if c >= u:
            return k
    return len(cdf_list) - 1


def sample_signed(rng: ChaCha20Rng, cdf: np.ndarray, count: int) -> np.ndarray:
    """``count`` signed samples as int64, one draw at a time: per sample a
    u64 for the magnitude, then a u64 whose low bit is the sign."""
    out = np.empty(count, dtype=np.int64)
    cdf_list = cdf.tolist()
    for i in range(count):
        mag = _magnitude_from_uniform(rng.next_u64(), cdf_list)
        if rng.next_u64() & 1 and mag != 0:
            mag = -mag
        out[i] = mag
    return out


def magnitudes_from_uniforms(us: np.ndarray, cdf: np.ndarray) -> np.ndarray:
    """Per uniform u, the count of table entries strictly below it."""
    return (cdf[None, :] < us[:, None].astype(np.uint64)).sum(axis=1)


def sample_signed_vectorized(rng: ChaCha20Rng, cdf: np.ndarray, count: int) -> np.ndarray:
    """``sample_signed``, draw for draw, on arrays."""
    draws = rng.fill_u64(2 * count)
    mags = magnitudes_from_uniforms(draws[0::2], cdf).astype(np.int64)
    flip = ((draws[1::2] & np.uint64(1)) == 1) & (mags != 0)
    return np.where(flip, -mags, mags)


def to_field(samples: np.ndarray, modulus: int) -> np.ndarray:
    """Signed samples -> canonical residues mod ``modulus``."""
    return np.array([int(x) % modulus for x in samples.tolist()], dtype=np.uint64)
