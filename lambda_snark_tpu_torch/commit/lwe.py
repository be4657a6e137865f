"""Module-LWE commitments over the Goldilocks ring, on the host.

The port's copy of the JAX package's ``commit/lwe.py``: R = Z_p[X]/(X^n + 1),
p = 2^64 - 2^32 + 1, and

    A_j = SHAKE256("LSNARK-TPU/A/v1" || LE64(ctx_seed) || LE64(j)) mod p
    s_j, e <- discrete Gaussian(sigma), drawn from ChaCha20 keyed by
              SHA3-256("LSNARK-TPU/rand/v1" || LE64(ctx_seed) || LE64(seed))
    c = sum_j A_j s_j + e + m

with A_j kept in the negacyclic NTT domain (A-hat). Everything here runs on
the host (the ring NTTs on CPU tensors with ``ops.ntt``): ``commit`` and
``commit_batch`` are the host provers' commitments and the recommitment of
``verifier.verify_r1cs_with_context``; the batched provers commit on the
card with kernel R (``commit.lwe_device``), to the same words.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core import field
from ..core.errors import CommitmentError, InvalidInputError
from ..core.params import NTT_MODULUS, NTT_PRIMITIVE_ROOT, Params
from ..ops import gaussian, modarith
from ..ops.ntt import NttPlan, ntt_forward_negacyclic, ntt_inverse_negacyclic
from ..utils.chacha import ChaCha20Rng, chacha20_blocks_keys_np

RING_MODULUS = NTT_MODULUS

#: The ring's modulus under the JAX package's name for it.
GOLDILOCKS = NTT_MODULUS

_DOMAIN_A = b"LSNARK-TPU/A/v1"
_DOMAIN_RAND = b"LSNARK-TPU/rand/v1"


def _fresh_norm_bound(sigma: float) -> int:
    """Infinity-norm bound of fresh Gaussian openings: the sampler's tail
    cutoff, ceil(12 sigma), at least 8."""
    return max(8, math.ceil(gaussian.TAIL_CUTOFF * sigma))


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
        self.a_hat = modarith.to_u64(ntt_forward_negacyclic(self.ring_plan, modarith.to_words(a)))
        self.cdf = gaussian.build_cdf(self.sigma)

    @property
    def modulus(self) -> int:
        return self.q

    @functools.cached_property
    def ring_plan(self) -> NttPlan:
        """The ring's negacyclic NTT plan on the host."""
        return goldilocks_ring_plan(self.n)

    def _randomness(self, seed: int):
        """(s (k, n), e (n,)) int64 from the commit seed's ChaCha20 stream:
        k rows of s, then e, each n draws of ``gaussian.sample_signed_vectorized``."""
        rng = ChaCha20Rng(_randomness_key(self, seed))
        s = np.stack([gaussian.sample_signed_vectorized(rng, self.cdf, self.n)
                      for _ in range(self.k)])
        return s, gaussian.sample_signed_vectorized(rng, self.cdf, self.n)


def _signed_to_ring(v: np.ndarray) -> np.ndarray:
    """Small signed int64 values -> canonical residues mod p."""
    neg = v < 0
    out = v.astype(np.int64).astype(np.uint64)
    return np.where(neg, out + np.uint64(RING_MODULUS), v.astype(np.uint64))


@dataclasses.dataclass(frozen=True)
class Opening:
    """A commitment's opening: the message (mod p) and the randomness
    (s, e) as signed ints, with their infinity-norm bound; ``seed`` is set
    when the randomness came from a commit seed."""

    message: np.ndarray  # (n,) uint64, canonical mod p
    s: np.ndarray  # (k, n) int64
    e: np.ndarray  # (n,) int64
    norm_bound: int
    seed: Optional[int] = None

    def norm_ok(self) -> bool:
        return (int(np.abs(self.s).max(initial=0)) <= self.norm_bound
                and int(np.abs(self.e).max(initial=0)) <= self.norm_bound)


class Commitment:
    """A ring element c as n canonical u64 coefficient words."""

    __slots__ = ("words",)

    def __init__(self, words) -> None:
        self.words = np.asarray(words, dtype=np.uint64)

    def as_words(self) -> List[int]:
        """The words as ints, for the Fiat-Shamir transcript."""
        return [int(w) for w in self.words]

    def to_bytes(self) -> bytes:
        return self.words.astype("<u8").tobytes()

    @staticmethod
    def from_bytes(data: bytes) -> "Commitment":
        if len(data) % 8 != 0:
            raise InvalidInputError("commitment byte length must be a multiple of 8")
        return Commitment(np.frombuffer(data, dtype="<u8").astype(np.uint64))

    def digest(self) -> bytes:
        return hashlib.sha3_256(self.to_bytes()).digest()

    def __eq__(self, other) -> bool:
        return isinstance(other, Commitment) and np.array_equal(self.words, other.words)


def _encode_message(ctx: LweContext, message: Sequence[int]) -> np.ndarray:
    """Reduce mod the field q, embed mod p, zero-pad to the ring degree."""
    if len(message) > ctx.n:
        raise CommitmentError(f"message length {len(message)} exceeds ring degree {ctx.n}")
    m = np.zeros(ctx.n, dtype=np.uint64)
    if isinstance(message, np.ndarray) and message.dtype == np.uint64:
        m[: len(message)] = message % np.uint64(ctx.q)
    else:
        m[: len(message)] = [int(v) % ctx.q for v in message]
    return m


def _ring_combine(ctx: LweContext, s: np.ndarray, e: np.ndarray,
                  m: np.ndarray) -> np.ndarray:
    """sum_j A_j s_j + e + m over R for rows s (B, k, n), e (B, n) signed
    and messages m (B, n) mod p: (B, n) uint64."""
    plan, p = ctx.ring_plan, RING_MODULUS
    s_hat = ntt_forward_negacyclic(plan, modarith.to_words(_signed_to_ring(s)))
    acc = modarith.mul_mod(s_hat, modarith.to_words(ctx.a_hat), p)  # (B, k, n)
    total = acc[:, 0]
    for j in range(1, ctx.k):
        total = modarith.add_mod(total, acc[:, j], p)
    c = ntt_inverse_negacyclic(plan, total)
    c = modarith.add_mod(c, modarith.to_words(_signed_to_ring(e)), p)
    return modarith.to_u64(modarith.add_mod(c, modarith.to_words(m), p))


def commit(ctx: LweContext, message: Sequence[int], seed: int):
    """Commit to a message vector: (Commitment, Opening), deterministic in
    (ctx.context_seed, message, seed)."""
    commitments, openings = commit_batch(ctx, [message], [seed])
    return commitments[0], openings[0]


def commit_batch(ctx: LweContext, messages: Sequence[Sequence[int]], seeds: Sequence[int]):
    """``commit`` of each (message, seed), as (list of Commitment, list of
    Opening), the ring products vectorised over the statements."""
    if len(messages) != len(seeds):
        raise InvalidInputError("messages/seeds length mismatch")
    if not messages:
        return [], []
    m = np.stack([_encode_message(ctx, msg) for msg in messages])
    ss, es = randomness_batch(ctx, list(seeds))
    c = _ring_combine(ctx, ss, es, m)
    bound = _fresh_norm_bound(ctx.sigma)
    return ([Commitment(c[i]) for i in range(len(seeds))],
            [Opening(message=m[i], s=ss[i], e=es[i], norm_bound=bound, seed=seeds[i])
             for i in range(len(seeds))])


def verify_opening(ctx: LweContext, commitment: Commitment, opening: Opening) -> bool:
    """Recompute c from the opening and compare; check the norm bound."""
    if not opening.norm_ok():
        return False
    if opening.s.shape != (ctx.k, ctx.n) or opening.e.shape != (ctx.n,):
        return False
    c = _ring_combine(ctx, opening.s[None], opening.e[None],
                      np.asarray(opening.message, dtype=np.uint64)[None])[0]
    return bool(np.array_equal(c, commitment.words))


def linear_combine(ctx: LweContext, commitments: Sequence[Commitment], coeffs: Sequence[int],
                   openings: Optional[Sequence[Opening]] = None):
    """sum gamma_i c_i over R, the coefficients taken mod p; with
    ``openings``, also the opening combined the same way (|gamma| <= 2^31,
    the norm bound growing with |gamma|)."""
    if not commitments:
        raise InvalidInputError("no commitments provided")
    if len(commitments) != len(coeffs):
        raise InvalidInputError("commitments/coeffs length mismatch")
    p = RING_MODULUS

    def combine(vectors) -> np.ndarray:
        acc = torch.zeros(ctx.n, dtype=torch.int64)
        for v, g in zip(vectors, coeffs):
            acc = modarith.add_mod(acc, modarith.mul_mod(
                modarith.to_words(np.asarray(v, dtype=np.uint64)), int(g) % p, p), p)
        return modarith.to_u64(acc)

    combined = Commitment(combine([cm.words for cm in commitments]))
    if openings is None:
        return combined
    s_acc = np.zeros((ctx.k, ctx.n), dtype=np.int64)
    e_acc = np.zeros(ctx.n, dtype=np.int64)
    bound = 0
    for op, g in zip(openings, coeffs):
        gi = int(g) % p
        gi_signed = gi if gi <= p // 2 else gi - p
        if abs(gi_signed) > (1 << 31):
            raise CommitmentError("opening combination only supported for small coefficients "
                                  f"(|gamma| <= 2^31), got {gi_signed}")
        s_acc = s_acc + op.s * gi_signed
        e_acc = e_acc + op.e * gi_signed
        bound += op.norm_bound * abs(gi_signed)
    message = combine([op.message for op in openings])
    return combined, Opening(message=message, s=s_acc, e=e_acc, norm_bound=bound)


def _randomness_key(ctx: LweContext, seed: int) -> bytes:
    """The ChaCha20 key of a commit seed's randomness stream:
    SHA3-256("LSNARK-TPU/rand/v1" || LE64(ctx_seed) || LE64(seed))."""
    return hashlib.sha3_256(
        _DOMAIN_RAND + ctx.context_seed.to_bytes(8, "little")
        + (int(seed) & ((1 << 64) - 1)).to_bytes(8, "little")
    ).digest()


def randomness_keys(ctx: LweContext, seeds) -> np.ndarray:
    """(S, 8) uint32 ChaCha20 key words of the per-seed randomness streams."""
    keys = np.empty((len(seeds), 8), dtype=np.uint32)
    for i, seed in enumerate(seeds):
        keys[i] = np.frombuffer(_randomness_key(ctx, seed), dtype="<u4")
    return keys


def randomness_batch(ctx: LweContext, seeds: Sequence[int]):
    """(ss (S, k, n), es (S, n)) int64: ``ctx._randomness`` of each seed,
    draw for draw, on the host from one multi-key block call (each seed's
    stream is its first 4 n (k + 1) keystream words; the device route,
    ``ops.sampler``, gives the same draws)."""
    s_count, n, k = len(seeds), ctx.n, ctx.k
    total_words = 4 * n * (k + 1)  # 2 n u64 draws a row, k rows of s, then e
    nblocks = -(-total_words // 16)
    blocks = chacha20_blocks_keys_np(randomness_keys(ctx, seeds), 0, [0, 0], nblocks)
    w = blocks.reshape(s_count, 16 * nblocks)[:, :total_words].astype(np.uint64)
    draws = (w[:, 0::2] | (w[:, 1::2] << np.uint64(32))).reshape(s_count, k + 1, 2 * n)
    mags = gaussian.magnitudes_from_uniforms(draws[..., 0::2].reshape(-1), ctx.cdf)
    mags = mags.astype(np.int64).reshape(s_count, k + 1, n)
    flip = ((draws[..., 1::2] & np.uint64(1)) == 1) & (mags != 0)
    signed = np.where(flip, -mags, mags)
    return signed[:, :k], signed[:, k]
