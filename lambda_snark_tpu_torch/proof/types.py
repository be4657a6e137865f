"""Proof containers and their wire bytes, both ways (the port's copy of
``Proof``, ``ProofR1CS``, ``ProofR1csZk``, ``EvalOpening`` and
``deserialize_any`` from the JAX package's ``proof/types.py``).

    magic "LSNKTPU1" | kind u8 | modulus u64 | body

Kinds 1 (simple), 2 (R1CS, v1 transcript), 6 (R1CS, v3 transcript bound to
the circuit digest) and 3 (R1CS, ZK) live here; kinds 4 and 5 are
``proof.compact``, kind 7 ``proof.succinct``, kind 8 ``proof.aggregate``
and kind 9 ``proof.succinct_witness``. The JAX package and the port read each other's bytes.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List

import numpy as np

from ..commit.lwe import Commitment
from ..core.errors import SerializationError
from ..transcript.challenge import Challenge

_MAGIC = b"LSNKTPU1"
_KIND_SIMPLE = 1
_KIND_R1CS = 2
_KIND_R1CS_ZK = 3
_KIND_R1CS_V3 = 6  # the v1 body, circuit-digest-bound transcript
_KIND_SUCCINCT = 7
_KIND_AGGREGATE = 8
_KIND_WITNESS = 9


def _pack_words(words) -> bytes:
    return struct.pack("<Q", len(words)) + b"".join(
        struct.pack("<Q", int(w) & ((1 << 64) - 1)) for w in words
    )


class _Reader:
    """Bounds-checked little-endian reads over proof bytes."""

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def bytes_(self, n: int) -> bytes:
        b = self.data[self.off: self.off + n]
        if len(b) != n:
            raise SerializationError("truncated proof data")
        self.off += n
        return b

    def u64(self) -> int:
        if self.off + 8 > len(self.data):
            raise SerializationError("truncated proof data (u64)")
        return struct.unpack("<Q", self.bytes_(8))[0]

    def u8(self) -> int:
        if self.off >= len(self.data):
            raise SerializationError("truncated proof data (u8)")
        return self.bytes_(1)[0]

    def words(self) -> List[int]:
        n = self.u64()
        if n > (1 << 32):
            raise SerializationError("unreasonable word-vector length")
        return list(struct.unpack(f"<{n}Q", self.bytes_(8 * n)))

    def commitment(self) -> Commitment:
        return Commitment(np.array(self.words(), dtype=np.uint64))

    def challenge(self) -> Challenge:
        return Challenge.from_bytes(self.bytes_(40))

    def evals(self):
        return struct.unpack("<8Q", self.bytes_(64))


def _header(data: bytes, kinds) -> _Reader:
    r = _Reader(data)
    if r.bytes_(8) != _MAGIC:
        raise SerializationError("bad proof magic")
    kind = r.u8()
    if kind not in kinds:
        raise SerializationError(f"unexpected proof kind {kind}")
    return r


@dataclasses.dataclass(frozen=True)
class EvalOpening:
    """Evaluation opening y = f(alpha) plus witness words: [randomness,
    f's coefficients...] for the simple proofs and the R1CS proofs with an
    opening, empty for the stub openings."""

    evaluation: int
    witness: List[int] = dataclasses.field(default_factory=list)

    def to_bytes(self) -> bytes:
        return struct.pack("<Q", self.evaluation) + _pack_words(self.witness)

    @staticmethod
    def read(r: _Reader) -> "EvalOpening":
        ev = r.u64()
        return EvalOpening(evaluation=ev, witness=r.words())


@dataclasses.dataclass(frozen=True)
class Proof:
    """Simple proof: commitment, challenge, opening (kind 1)."""

    commitment: Commitment
    challenge: Challenge
    opening: EvalOpening
    modulus: int

    def to_bytes(self) -> bytes:
        body = (struct.pack("<Q", len(self.commitment.words)) + self.commitment.to_bytes()
                + self.challenge.to_bytes() + self.opening.to_bytes())
        return _MAGIC + bytes([_KIND_SIMPLE]) + struct.pack("<Q", self.modulus) + body

    @staticmethod
    def from_bytes(data: bytes) -> "Proof":
        r = _header(data, (_KIND_SIMPLE,))
        modulus = r.u64()
        return Proof(r.commitment(), r.challenge(), EvalOpening.read(r), modulus)


def _body(commitment: Commitment, evals, ch_a: Challenge, ch_b: Challenge,
          op_a: EvalOpening, op_b: EvalOpening, blinding=None) -> bytes:
    body = struct.pack("<Q", len(commitment.words)) + commitment.to_bytes()
    if blinding is not None:
        body += struct.pack("<Q", blinding)
    body += ch_a.to_bytes() + ch_b.to_bytes()
    body += struct.pack("<8Q", *evals)
    return body + op_a.to_bytes() + op_b.to_bytes()


@dataclasses.dataclass(frozen=True)
class ProofR1CS:
    commitment_q: Commitment
    challenge_alpha: Challenge
    challenge_beta: Challenge
    q_alpha: int
    q_beta: int
    a_z_alpha: int
    b_z_alpha: int
    c_z_alpha: int
    a_z_beta: int
    b_z_beta: int
    c_z_beta: int
    opening_alpha: EvalOpening
    opening_beta: EvalOpening
    modulus: int
    transcript_v: int = 1  # 1: the reference's transcript; 3: circuit-digest-bound

    def to_bytes(self) -> bytes:
        evals = (self.q_alpha, self.q_beta, self.a_z_alpha, self.b_z_alpha,
                 self.c_z_alpha, self.a_z_beta, self.b_z_beta, self.c_z_beta)
        body = _body(self.commitment_q, evals, self.challenge_alpha,
                     self.challenge_beta, self.opening_alpha, self.opening_beta)
        kind = _KIND_R1CS_V3 if self.transcript_v == 3 else _KIND_R1CS
        return _MAGIC + bytes([kind]) + struct.pack("<Q", self.modulus) + body

    @staticmethod
    def from_bytes(data: bytes) -> "ProofR1CS":
        r = _header(data, (_KIND_R1CS, _KIND_R1CS_V3))
        kind = data[8]
        modulus = r.u64()
        comm = r.commitment()
        ch_a, ch_b = r.challenge(), r.challenge()
        evals = r.evals()
        op_a, op_b = EvalOpening.read(r), EvalOpening.read(r)
        return ProofR1CS(comm, ch_a, ch_b, *evals, op_a, op_b, modulus,
                         transcript_v=3 if kind == _KIND_R1CS_V3 else 1)


@dataclasses.dataclass(frozen=True)
class ProofR1csZk:
    """ZK proof: commitment to Q' = Q + r Z_H and the blinding factor r."""

    commitment_q_prime: Commitment
    blinding_factor: int
    challenge_alpha: Challenge
    challenge_beta: Challenge
    q_prime_alpha: int
    q_prime_beta: int
    a_z_alpha: int
    b_z_alpha: int
    c_z_alpha: int
    a_z_beta: int
    b_z_beta: int
    c_z_beta: int
    opening_alpha: EvalOpening
    opening_beta: EvalOpening
    modulus: int

    def to_bytes(self) -> bytes:
        evals = (self.q_prime_alpha, self.q_prime_beta, self.a_z_alpha,
                 self.b_z_alpha, self.c_z_alpha, self.a_z_beta, self.b_z_beta,
                 self.c_z_beta)
        body = _body(self.commitment_q_prime, evals, self.challenge_alpha,
                     self.challenge_beta, self.opening_alpha, self.opening_beta,
                     blinding=self.blinding_factor)
        return _MAGIC + bytes([_KIND_R1CS_ZK]) + struct.pack("<Q", self.modulus) + body

    @staticmethod
    def from_bytes(data: bytes) -> "ProofR1csZk":
        r = _header(data, (_KIND_R1CS_ZK,))
        modulus = r.u64()
        comm = r.commitment()
        blinding = r.u64()
        ch_a, ch_b = r.challenge(), r.challenge()
        evals = r.evals()
        op_a, op_b = EvalOpening.read(r), EvalOpening.read(r)
        return ProofR1csZk(comm, blinding, ch_a, ch_b, *evals, op_a, op_b, modulus)


def deserialize_any(data: bytes):
    """Decode proof bytes by their kind byte, 1 to 9; bad magic and unknown
    kinds raise SerializationError as in the JAX package."""
    if len(data) < 9 or data[:8] != _MAGIC:
        raise SerializationError("bad proof magic")
    kind = data[8]
    if kind == _KIND_SIMPLE:
        return Proof.from_bytes(data)
    if kind in (_KIND_R1CS, _KIND_R1CS_V3):
        return ProofR1CS.from_bytes(data)
    if kind == _KIND_R1CS_ZK:
        return ProofR1csZk.from_bytes(data)
    # the proof modules are imported here, as the JAX package does: they
    # import utils.artifacts, which imports this module
    if kind in (4, 5):
        from .compact import CompactProofR1CS

        return CompactProofR1CS.from_bytes(data)
    if kind == _KIND_SUCCINCT:
        from .succinct import SuccinctProofR1CS

        return SuccinctProofR1CS.from_bytes(data)
    if kind == _KIND_AGGREGATE:
        from .aggregate import AggregatedProofR1CS

        return AggregatedProofR1CS.from_bytes(data)
    if kind == _KIND_WITNESS:
        from .succinct_witness import WitnessProofR1CS

        return WitnessProofR1CS.from_bytes(data)
    raise SerializationError(f"unknown proof kind {kind}")
