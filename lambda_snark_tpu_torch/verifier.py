"""Verifiers of the simple proofs (kind 1) and the two-challenge R1CS
proofs, kinds 2, 3 and 6 (the port's copy of the JAX package's
``verifier.py``):

- ``verify_simple``: recompute alpha, check the opening f(alpha);
- ``verify_r1cs``: recompute alpha and beta from the public inputs and the
  commitment words (v3 proofs also hash the circuit digest), then check
  Q(x) Z_H(x) = A(x) B(x) - C(x) at both, and that the openings carry the
  claimed Q values;
- ``verify_r1cs_with_context``: ``verify_r1cs``, then the opening witness
  [seed, Q's coefficients] must recommit (host ``lwe.commit``) to the
  proof's commitment and evaluate to the claimed Q values;
- ``verify_r1cs_zk``: the same after unblinding Q(x) = Q'(x) - r Z_H(x).

Host code on Python ints, as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence

from .commit import lwe
from .core import field
from .proof.polynomial import Polynomial
from .proof.types import EvalOpening, Proof, ProofR1CS, ProofR1csZk
from .r1cs.r1cs import R1CS
from .transcript.challenge import Challenge, derive_dual, derive_dual_v3
from .utils.artifacts import circuit_digest


def verify_eval_opening(opening: EvalOpening, alpha: int, modulus: int) -> bool:
    """y = f(alpha) for an opening whose witness is [randomness, f's
    coefficients...] (the reference's ``verify_opening``)."""
    if opening.evaluation >= modulus or len(opening.witness) < 2:
        return False
    expected = Polynomial([c % modulus for c in opening.witness[1:]], modulus).evaluate(alpha)
    return field.sub_mod(opening.evaluation, expected, modulus) == 0


def verify_simple(proof: Proof, public_inputs: Sequence[int], modulus: int) -> bool:
    """Verify a kind-1 proof: alpha from the public inputs and the
    commitment words, and the opening's f(alpha)."""
    recomputed = Challenge.derive(public_inputs, proof.commitment.words, modulus)
    if proof.challenge.alpha != recomputed.alpha:
        return False
    return verify_eval_opening(proof.opening, proof.challenge.alpha, modulus)


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
    return _verify_r1cs_equations(proof, r1cs, proof.challenge_alpha.alpha,
                                  proof.challenge_beta.alpha)


def _verify_r1cs_equations(proof: ProofR1CS, r1cs: R1CS, alpha: int, beta: int) -> bool:
    """The quotient identity at alpha and beta, and the openings' claimed
    Q values."""
    return (_identity_holds(r1cs, alpha, proof.q_alpha, proof.a_z_alpha, proof.b_z_alpha,
                            proof.c_z_alpha)
            and _identity_holds(r1cs, beta, proof.q_beta, proof.a_z_beta, proof.b_z_beta,
                                proof.c_z_beta)
            and proof.opening_alpha.evaluation == proof.q_alpha
            and proof.opening_beta.evaluation == proof.q_beta)


def verify_r1cs_with_context(proof: ProofR1CS, public_inputs: Sequence[int], r1cs: R1CS,
                             ctx) -> bool:
    """``verify_r1cs``, then the binding of the commitment: the opening
    witness [seed, Q's coefficients] must recommit to the proof's words and
    evaluate to Q(alpha) and Q(beta)."""
    if not verify_r1cs(proof, public_inputs, r1cs):
        return False
    if any(len(op.witness) < 2 for op in (proof.opening_alpha, proof.opening_beta)):
        return False  # binding needs a real opening
    q = r1cs.modulus
    seed = proof.opening_alpha.witness[0]
    message = [c % q for c in proof.opening_alpha.witness[1:]]
    recommit, _op = lwe.commit(ctx, message, seed)
    if recommit != proof.commitment_q:
        return False
    return (field.horner_eval(message, proof.challenge_alpha.alpha, q) == proof.q_alpha
            and field.horner_eval(message, proof.challenge_beta.alpha, q) == proof.q_beta)


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
