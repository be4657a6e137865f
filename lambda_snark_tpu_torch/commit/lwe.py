"""Module-LWE commitment context over the Goldilocks ring (host side).

The port's copy of ``LweContext`` and ``Commitment`` from the JAX package's
``commit/lwe.py``: R = Z_p[X]/(X^n + 1), p = 2^64 - 2^32 + 1, and

    A_j = SHAKE256("LSNARK-TPU/A/v1" || LE64(ctx_seed) || LE64(j)) mod p

by rejection sampling, kept in the negacyclic NTT domain (A-hat). A-hat is
computed with the port's own NTT (``ops.ntt``) on the host; it equals the
JAX package's (``tests/test_torch_ring_commit.py``).
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..core import field
from ..core.errors import InvalidInputError
from ..core.params import NTT_MODULUS, NTT_PRIMITIVE_ROOT, Params
from ..ops import gaussian, modarith
from ..ops.ntt import NttPlan, ntt_forward_negacyclic

RING_MODULUS = NTT_MODULUS

_DOMAIN_A = b"LSNARK-TPU/A/v1"
_DOMAIN_RAND = b"LSNARK-TPU/rand/v1"


def _shake_words_mod_p(tag: bytes, seed_bytes: bytes, count: int) -> np.ndarray:
    """``count`` uniform words mod p: consecutive LE u64 words of one
    SHAKE256 stream, rejecting w >= p."""
    xof = hashlib.shake_256(tag + seed_bytes)
    length = 8 * count + 64
    while True:
        words = np.frombuffer(xof.digest(length), dtype="<u8").astype(np.uint64)
        kept = words[words < np.uint64(RING_MODULUS)]
        if kept.shape[0] >= count:
            return kept[:count].copy()
        length *= 2  # SHAKE output is prefix-consistent


def goldilocks_ring_plan(n: int, device="cpu") -> NttPlan:
    """Negacyclic NTT plan of the commitment ring for degree n."""
    omega = field.mod_pow(NTT_PRIMITIVE_ROOT, (1 << 32) // n, NTT_MODULUS)
    psi = field.mod_pow(NTT_PRIMITIVE_ROOT, (1 << 32) // (2 * n), NTT_MODULUS)
    return NttPlan.create(n, NTT_MODULUS, omega, psi, device=device)


class LweContext:
    """Public commitment context: ring parameters, A-hat (k, n) uint64 and
    the Gaussian CDF table."""

    def __init__(self, params: Params, context_seed: int = 0) -> None:
        params.validate()
        profile = params.profile
        if profile.kind != "ring_b":
            raise InvalidInputError("LweContext requires a RingB profile")
        self.params = params
        self.n = profile.n
        self.k = profile.k
        self.q = profile.q  # field modulus of the committed messages
        self.sigma = profile.sigma
        self.context_seed = context_seed
        seed_bytes = context_seed.to_bytes(8, "little")
        a = np.stack([
            _shake_words_mod_p(_DOMAIN_A, seed_bytes + j.to_bytes(8, "little"), self.n)
            for j in range(self.k)
        ])
        plan = goldilocks_ring_plan(self.n)
        self.a_hat = modarith.to_u64(ntt_forward_negacyclic(plan, modarith.to_words(a)))
        self.cdf = gaussian.build_cdf(self.sigma)


class Commitment:
    """A ring element c as n canonical u64 coefficient words."""

    __slots__ = ("words",)

    def __init__(self, words) -> None:
        self.words = np.asarray(words, dtype=np.uint64)

    def to_bytes(self) -> bytes:
        return self.words.astype("<u8").tobytes()


def randomness_keys(ctx: LweContext, seeds) -> np.ndarray:
    """(S, 8) uint32 ChaCha20 key words of the per-seed randomness streams:
    SHA3-256("LSNARK-TPU/rand/v1" || LE64(ctx_seed) || LE64(seed))."""
    keys = np.empty((len(seeds), 8), dtype=np.uint32)
    for i, seed in enumerate(seeds):
        key = hashlib.sha3_256(
            _DOMAIN_RAND + ctx.context_seed.to_bytes(8, "little")
            + (int(seed) & ((1 << 64) - 1)).to_bytes(8, "little")
        ).digest()
        keys[i] = np.frombuffer(key, dtype="<u4")
    return keys
