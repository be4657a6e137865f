"""Verifiers of the two-challenge R1CS proofs, kinds 2, 3 and 6 (the port's
copy of ``verify_simple``'s opening check, ``verify_r1cs`` and
``verify_r1cs_zk`` from the JAX package's ``verifier.py``):

- ``verify_r1cs``: recompute alpha and beta from the public inputs and the
  commitment words (v3 proofs also hash the circuit digest), then check
  Q(x) Z_H(x) = A(x) B(x) - C(x) at both, and that the openings carry the
  claimed Q values;
- ``verify_r1cs_zk``: the same after unblinding Q(x) = Q'(x) - r Z_H(x).

Host code on Python ints, as in the JAX package. ``verify_r1cs_with_context``
(the recommitment check) needs the host ``lwe.commit`` and waits for
ROADMAP queue A.3.
"""

from __future__ import annotations

from typing import Sequence

from .core import field
from .proof.polynomial import Polynomial
from .proof.types import EvalOpening, ProofR1CS, ProofR1csZk
from .r1cs.r1cs import R1CS
from .transcript.challenge import derive_dual, derive_dual_v3
from .utils.artifacts import circuit_digest


def verify_eval_opening(opening: EvalOpening, alpha: int, modulus: int) -> bool:
    """y = f(alpha) for an opening whose witness is [randomness, f's
    coefficients...] (the reference's ``verify_opening``)."""
    if opening.evaluation >= modulus or len(opening.witness) < 2:
        return False
    expected = Polynomial([c % modulus for c in opening.witness[1:]], modulus).evaluate(alpha)
    return field.sub_mod(opening.evaluation, expected, modulus) == 0


def _challenges_hold(proof, public_inputs, comm_words, q, digest=None) -> bool:
    if digest is None:
        ch_alpha, ch_beta = derive_dual(public_inputs, comm_words, q)
    else:
        ch_alpha, ch_beta = derive_dual_v3(public_inputs, comm_words, q, digest)
    return (proof.challenge_alpha.alpha == ch_alpha.alpha
            and proof.challenge_beta.alpha == ch_beta.alpha)


def _identity_holds(r1cs: R1CS, x: int, q_x: int, a: int, b: int, c: int) -> bool:
    q = r1cs.modulus
    return field.mul_mod(q_x, r1cs.eval_vanishing(x), q) == field.sub_mod(
        field.mul_mod(a, b, q), c, q)


def verify_r1cs(proof: ProofR1CS, public_inputs: Sequence[int], r1cs: R1CS) -> bool:
    """Verify a kind-2 (v1 transcript) or kind-6 (v3) proof."""
    q = r1cs.modulus
    digest = bytes.fromhex(circuit_digest(r1cs)) if proof.transcript_v == 3 else None
    if not _challenges_hold(proof, public_inputs, proof.commitment_q.words, q, digest):
        return False
    alpha, beta = proof.challenge_alpha.alpha, proof.challenge_beta.alpha
    return (_identity_holds(r1cs, alpha, proof.q_alpha, proof.a_z_alpha, proof.b_z_alpha,
                            proof.c_z_alpha)
            and _identity_holds(r1cs, beta, proof.q_beta, proof.a_z_beta, proof.b_z_beta,
                                proof.c_z_beta)
            and proof.opening_alpha.evaluation == proof.q_alpha
            and proof.opening_beta.evaluation == proof.q_beta)


def verify_r1cs_zk(proof: ProofR1csZk, public_inputs: Sequence[int], r1cs: R1CS) -> bool:
    """Verify a kind-3 proof: unblind Q(x) = Q'(x) - r Z_H(x), then check as
    ``verify_r1cs``."""
    q = r1cs.modulus
    if not _challenges_hold(proof, public_inputs, proof.commitment_q_prime.words, q):
        return False
    alpha, beta = proof.challenge_alpha.alpha, proof.challenge_beta.alpha
    r = proof.blinding_factor
    q_alpha = field.sub_mod(proof.q_prime_alpha,
                            field.mul_mod(r, r1cs.eval_vanishing(alpha), q), q)
    q_beta = field.sub_mod(proof.q_prime_beta,
                           field.mul_mod(r, r1cs.eval_vanishing(beta), q), q)
    return (_identity_holds(r1cs, alpha, q_alpha, proof.a_z_alpha, proof.b_z_alpha,
                            proof.c_z_alpha)
            and _identity_holds(r1cs, beta, q_beta, proof.a_z_beta, proof.b_z_beta,
                                proof.c_z_beta)
            and proof.opening_alpha.evaluation == proof.q_prime_alpha
            and proof.opening_beta.evaluation == proof.q_prime_beta)
