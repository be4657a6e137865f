"""Fiat-Shamir transcript, SHA3-256 (the port's copy of the v1 layout of
``transcript/challenge.py``):

    h = SHA3-256(b"LAMBDA-SNARK-R-FS-v1" || LE64(len(pub)) || LE64(pub_i)...
                 || LE64(len(words)) || LE64(word_i)...)
    alpha = LE64(h[0..8]) mod q;  beta from the public list [alpha].
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Sequence

import numpy as np

DOMAIN_TAG = b"LAMBDA-SNARK-R-FS-v1"
MASK64 = (1 << 64) - 1


def _words_le_bytes(words: Sequence[int]) -> bytes:
    """Length-prefixed LE u64 packing."""
    prefix = (len(words) & MASK64).to_bytes(8, "little")
    if not (isinstance(words, np.ndarray) and words.dtype == np.uint64):
        words = np.fromiter(((int(w) & MASK64) for w in words), dtype=np.uint64,
                            count=len(words))
    return prefix + words.astype("<u8").tobytes()


@dataclasses.dataclass(frozen=True)
class Challenge:
    """Challenge point alpha in F_q plus the 32-byte derivation hash."""

    alpha: int
    hash: bytes

    @staticmethod
    def derive(public_inputs: Sequence[int], commitment_words: Sequence[int],
               modulus: int) -> "Challenge":
        h = hashlib.sha3_256()
        h.update(DOMAIN_TAG)
        h.update(_words_le_bytes(public_inputs))
        h.update(_words_le_bytes(commitment_words))
        digest = h.digest()
        return Challenge(alpha=int.from_bytes(digest[0:8], "little") % modulus, hash=digest)

    def to_bytes(self) -> bytes:
        return self.alpha.to_bytes(8, "little") + self.hash

    @staticmethod
    def from_bytes(data: bytes) -> "Challenge":
        if len(data) != 40:
            raise ValueError(f"challenge encoding must be 40 bytes, got {len(data)}")
        return Challenge(alpha=int.from_bytes(data[0:8], "little"), hash=data[8:40])


def derive_dual(public_inputs: Sequence[int], commitment_words: Sequence[int],
                modulus: int):
    """(alpha, beta): alpha = H(public || comm); beta = H([alpha] || comm)."""
    ch_alpha = Challenge.derive(public_inputs, commitment_words, modulus)
    ch_beta = Challenge.derive([ch_alpha.alpha], commitment_words, modulus)
    return ch_alpha, ch_beta


def derive_dual_v3(public_inputs: Sequence[int], commitment_words: Sequence[int],
                   modulus: int, circuit_digest: bytes):
    """The v3 transcript (wire kind 6): ``derive_dual`` over the commitment
    words followed by the circuit digest as four LE u64 words."""
    words = [int(w) for w in commitment_words] + [
        int.from_bytes(circuit_digest[i:i + 8], "little") for i in range(0, 32, 8)
    ]
    return derive_dual(public_inputs, words, modulus)
