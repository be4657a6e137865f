"""Compact proofs: a digest-bound transcript, 193 or 201 bytes (wire kinds 4
and 5).

The port of the JAX package's ``proof/compact.py``. The Fiat-Shamir
transcript binds the SHA3-256 digest of the commitment words and the
circuit digest,

    alpha = H(public || digest words || circuit digest words)
    beta  = H([alpha] || digest words || circuit digest words)

(the v1 byte layout with the commitment words replaced by the 4 LE64 words
of each digest), and the proof carries only the commitment's digest:
9-byte header, 8-byte modulus, 32-byte digest, two 40-byte challenges,
64 bytes of evaluations, and for the ZK kind the 8-byte blinding factor.
Host code: ``R1CS.compute_quotient_poly``, ``r1cs.poly`` and the host
``commit.lwe.commit``.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence

from ..commit import lwe
from ..core import field
from ..core.errors import SerializationError
from ..r1cs import poly as polyops
from ..r1cs.r1cs import R1CS
from ..transcript.challenge import Challenge
from ..utils.artifacts import circuit_digest
from ..utils.chacha import ChaCha20Rng
from .types import _MAGIC, _Reader

_KIND_COMPACT = 4
_KIND_COMPACT_ZK = 5


def digest_words(digest: bytes) -> List[int]:
    """32-byte digest -> 4 LE u64 transcript words."""
    return [int.from_bytes(digest[i: i + 8], "little") for i in range(0, 32, 8)]


def derive_dual_digest(public_inputs, digest: bytes, modulus: int, circuit_dig: bytes = b""):
    """The dual challenges over the commitment digest and (when given) the
    circuit digest."""
    words = digest_words(digest) + (digest_words(circuit_dig) if circuit_dig else [])
    ch_a = Challenge.derive(public_inputs, words, modulus)
    ch_b = Challenge.derive([ch_a.alpha], words, modulus)
    return ch_a, ch_b


def _circuit_digest(r1cs: R1CS) -> bytes:
    return bytes.fromhex(circuit_digest(r1cs))


@dataclasses.dataclass(frozen=True)
class CompactProofR1CS:
    """Digest-bound two-challenge R1CS proof (kind 4; kind 5 with its
    blinding factor)."""

    commitment_digest: bytes  # 32 bytes
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
    modulus: int
    blinding_factor: Optional[int] = None  # set for the ZK kind

    @property
    def is_zk(self) -> bool:
        return self.blinding_factor is not None

    def _evals(self):
        return (self.q_alpha, self.q_beta, self.a_z_alpha, self.b_z_alpha,
                self.c_z_alpha, self.a_z_beta, self.b_z_beta, self.c_z_beta)

    def to_bytes(self) -> bytes:
        kind = _KIND_COMPACT_ZK if self.is_zk else _KIND_COMPACT
        body = struct.pack("<Q", self.modulus) + self.commitment_digest
        body += self.challenge_alpha.to_bytes() + self.challenge_beta.to_bytes()
        body += struct.pack("<8Q", *self._evals())
        if self.is_zk:
            body += struct.pack("<Q", self.blinding_factor)
        return _MAGIC + bytes([kind]) + body

    @staticmethod
    def from_bytes(data: bytes) -> "CompactProofR1CS":
        r = _Reader(data)
        if r.bytes_(8) != _MAGIC:
            raise SerializationError("bad proof magic")
        kind = r.u8()
        if kind not in (_KIND_COMPACT, _KIND_COMPACT_ZK):
            raise SerializationError(f"unexpected proof kind {kind}")
        modulus = r.u64()
        digest = r.bytes_(32)
        ch_a, ch_b = r.challenge(), r.challenge()
        evals = r.evals()
        blinding = r.u64() if kind == _KIND_COMPACT_ZK else None
        return CompactProofR1CS(digest, ch_a, ch_b, *evals, modulus=modulus,
                                blinding_factor=blinding)


def prove_r1cs_compact(r1cs: R1CS, witness: Sequence[int], ctx: lwe.LweContext, seed: int,
                       blinding_seed: Optional[int] = None, zk: bool = False
                       ) -> CompactProofR1CS:
    """A compact proof (plain, or ZK with Q' = Q + r Z_H and r drawn from
    ChaCha20 seeded with ``blinding_seed``, else OS entropy)."""
    q = r1cs.modulus
    q_coeffs = r1cs.compute_quotient_poly(witness)
    blinding_factor = None
    committed = q_coeffs
    if zk:
        if blinding_seed is not None:
            rng = ChaCha20Rng.from_u64(blinding_seed)
        else:
            import secrets

            rng = ChaCha20Rng(secrets.token_bytes(32))
        blinding_factor = rng.next_u64() % q
        z_h = r1cs.domain.vanishing_poly()
        committed = polyops.poly_add(q_coeffs, polyops.poly_mul_scalar(z_h, blinding_factor, q),
                                     q)
    commitment, _op = lwe.commit(ctx, committed, seed)
    digest = commitment.digest()
    ch_a, ch_b = derive_dual_digest(r1cs.public_inputs(witness), digest, q,
                                    _circuit_digest(r1cs))
    alpha, beta = ch_a.alpha, ch_b.alpha
    a_poly, b_poly, c_poly = r1cs.interpolations(witness)
    ev = r1cs.eval_poly
    return CompactProofR1CS(
        digest, ch_a, ch_b, ev(committed, alpha), ev(committed, beta),
        ev(a_poly, alpha), ev(b_poly, alpha), ev(c_poly, alpha),
        ev(a_poly, beta), ev(b_poly, beta), ev(c_poly, beta),
        modulus=q, blinding_factor=blinding_factor)


def verify_r1cs_compact(proof: CompactProofR1CS, public_inputs: Sequence[int],
                        r1cs: R1CS) -> bool:
    q = r1cs.modulus
    ch_a, ch_b = derive_dual_digest(public_inputs, proof.commitment_digest, q,
                                    _circuit_digest(r1cs))
    if proof.challenge_alpha.alpha != ch_a.alpha or proof.challenge_beta.alpha != ch_b.alpha:
        return False
    alpha, beta = ch_a.alpha, ch_b.alpha
    zh_alpha, zh_beta = r1cs.eval_vanishing(alpha), r1cs.eval_vanishing(beta)
    q_alpha, q_beta = proof.q_alpha, proof.q_beta
    if proof.is_zk:
        q_alpha = field.sub_mod(q_alpha, field.mul_mod(proof.blinding_factor, zh_alpha, q), q)
        q_beta = field.sub_mod(q_beta, field.mul_mod(proof.blinding_factor, zh_beta, q), q)
    if field.mul_mod(q_alpha, zh_alpha, q) != field.sub_mod(
            field.mul_mod(proof.a_z_alpha, proof.b_z_alpha, q), proof.c_z_alpha, q):
        return False
    return field.mul_mod(q_beta, zh_beta, q) == field.sub_mod(
        field.mul_mod(proof.a_z_beta, proof.b_z_beta, q), proof.c_z_beta, q)
