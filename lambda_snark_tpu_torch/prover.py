"""Host provers: simple, zero-knowledge, the simulator and the R1CS pipeline
(the port's copy of the JAX package's ``prover.py``, the golden path).

- ``prove_simple``: commit to f = the witness, open it at alpha (kind 1);
- ``prove_zk``: the same for the blinded f' = f + r;
- ``simulate_proof``: the ZK simulator, a uniform f' and no witness;
- ``prove_r1cs``: the quotient Q, its commitment and the dual challenges
  (kind 2, or kind 6 with ``bind_circuit``); ``with_opening`` attaches
  [seed, Q's coefficients], which ``verifier.verify_r1cs_with_context``
  recommits;
- ``prove_r1cs_zk``: Q' = Q + r Z_H (kind 3).

Python ints and the host commitment (``commit.lwe.commit``), no device:
the batched provers (``prover_batched``) give the same bytes on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .commit import lwe
from .core.errors import InvalidInputError
from .proof.polynomial import Polynomial
from .proof.types import EvalOpening, Proof, ProofR1CS, ProofR1csZk
from .r1cs import poly as polyops
from .r1cs.r1cs import R1CS
from .transcript.challenge import Challenge, derive_dual, derive_dual_v3
from .utils.artifacts import circuit_digest
from .utils.chacha import ChaCha20Rng


def setup(params, context_seed: int = 0) -> lwe.LweContext:
    """The commitment context of ``params``."""
    params.validate()
    return lwe.LweContext(params, context_seed=context_seed)


def _generate_opening(polynomial: Polynomial, alpha: int, randomness: int) -> EvalOpening:
    """f(alpha) with the witness [randomness, f's coefficients...]."""
    return EvalOpening(evaluation=polynomial.evaluate(alpha),
                       witness=[randomness] + list(polynomial.coeffs))


def _prove_polynomial(f: Polynomial, public_inputs: Sequence[int], ctx: lwe.LweContext,
                      modulus: int, seed: int) -> Proof:
    commitment, _opening = lwe.commit(ctx, f.coeffs, seed)
    challenge = Challenge.derive(public_inputs, commitment.as_words(), modulus)
    return Proof(commitment=commitment, challenge=challenge,
                 opening=_generate_opening(f, challenge.alpha, seed), modulus=modulus)


def prove_simple(witness: Sequence[int], public_inputs: Sequence[int], ctx: lwe.LweContext,
                 modulus: int, seed: int) -> Proof:
    if not witness:
        raise InvalidInputError("witness cannot be empty")
    return _prove_polynomial(Polynomial.from_witness(witness, modulus), public_inputs, ctx,
                             modulus, seed)


def prove_zk(witness: Sequence[int], public_inputs: Sequence[int], ctx: lwe.LweContext,
             modulus: int, commit_seed: int, blinding_seed: Optional[int] = None) -> Proof:
    if not witness:
        raise InvalidInputError("witness cannot be empty")
    f = Polynomial.from_witness(witness, modulus)
    r = Polynomial.random_blinding(f.degree(), modulus, blinding_seed)
    return _prove_polynomial(f.add(r), public_inputs, ctx, modulus, commit_seed)


def simulate_proof(degree: int, public_inputs: Sequence[int], ctx: lwe.LweContext,
                   modulus: int, commit_seed: int, sim_seed: Optional[int] = None) -> Proof:
    """A proof of a uniform f' of ``degree``, made without a witness."""
    f_prime = Polynomial.random_blinding(degree, modulus, sim_seed)
    return _prove_polynomial(f_prime, public_inputs, ctx, modulus, commit_seed)


def prove_r1cs(r1cs: R1CS, witness: Sequence[int], ctx: lwe.LweContext, seed: int,
               with_opening: bool = False, bind_circuit: bool = False) -> ProofR1CS:
    """The two-challenge R1CS proof of ``witness``. ``with_opening``
    attaches the opening witness [seed, Q's coefficients] (non-ZK: it
    reveals Q); ``bind_circuit`` hashes the circuit digest into the
    challenges (the v3 transcript, wire kind 6)."""
    q = r1cs.modulus
    q_coeffs = r1cs.compute_quotient_poly(witness)  # validates the witness
    commitment_q, _op = lwe.commit(ctx, q_coeffs, seed)
    comm_words = commitment_q.as_words()
    public_inputs = r1cs.public_inputs(witness)
    if bind_circuit:
        ch_alpha, ch_beta = derive_dual_v3(public_inputs, comm_words, q,
                                           bytes.fromhex(circuit_digest(r1cs)))
    else:
        ch_alpha, ch_beta = derive_dual(public_inputs, comm_words, q)
    alpha, beta = ch_alpha.alpha, ch_beta.alpha
    a_poly, b_poly, c_poly = r1cs.interpolations(witness)
    q_alpha, q_beta = r1cs.eval_poly(q_coeffs, alpha), r1cs.eval_poly(q_coeffs, beta)
    opening_witness = [seed] + list(q_coeffs) if with_opening else []
    return ProofR1CS(
        commitment_q=commitment_q, challenge_alpha=ch_alpha, challenge_beta=ch_beta,
        q_alpha=q_alpha, q_beta=q_beta,
        a_z_alpha=r1cs.eval_poly(a_poly, alpha), b_z_alpha=r1cs.eval_poly(b_poly, alpha),
        c_z_alpha=r1cs.eval_poly(c_poly, alpha), a_z_beta=r1cs.eval_poly(a_poly, beta),
        b_z_beta=r1cs.eval_poly(b_poly, beta), c_z_beta=r1cs.eval_poly(c_poly, beta),
        opening_alpha=EvalOpening(evaluation=q_alpha, witness=opening_witness),
        opening_beta=EvalOpening(evaluation=q_beta, witness=opening_witness),
        modulus=q, transcript_v=3 if bind_circuit else 1)


def prove_r1cs_zk(r1cs: R1CS, witness: Sequence[int], ctx: lwe.LweContext, seed: int,
                  blinding_seed: Optional[int] = None,
                  rng: Optional[ChaCha20Rng] = None) -> ProofR1csZk:
    """The ZK R1CS proof, Q' = Q + r Z_H with r = ``rng.next_u64() % q``
    (``rng``, else ChaCha20 from ``blinding_seed``, else OS entropy)."""
    q = r1cs.modulus
    q_coeffs = r1cs.compute_quotient_poly(witness)
    if rng is None:
        if blinding_seed is not None:
            rng = ChaCha20Rng.from_u64(blinding_seed)
        else:
            import secrets

            rng = ChaCha20Rng(secrets.token_bytes(32))
    blinding_factor = rng.next_u64() % q
    r_z_h = polyops.poly_mul_scalar(r1cs.domain.vanishing_poly(), blinding_factor, q)
    q_blinded = polyops.poly_add(q_coeffs, r_z_h, q)
    commitment_qp, _op = lwe.commit(ctx, q_blinded, seed)
    ch_alpha, ch_beta = derive_dual(r1cs.public_inputs(witness), commitment_qp.as_words(), q)
    alpha, beta = ch_alpha.alpha, ch_beta.alpha
    a_poly, b_poly, c_poly = r1cs.interpolations(witness)
    qp_alpha, qp_beta = r1cs.eval_poly(q_blinded, alpha), r1cs.eval_poly(q_blinded, beta)
    return ProofR1csZk(
        commitment_q_prime=commitment_qp, blinding_factor=blinding_factor,
        challenge_alpha=ch_alpha, challenge_beta=ch_beta,
        q_prime_alpha=qp_alpha, q_prime_beta=qp_beta,
        a_z_alpha=r1cs.eval_poly(a_poly, alpha), b_z_alpha=r1cs.eval_poly(b_poly, alpha),
        c_z_alpha=r1cs.eval_poly(c_poly, alpha), a_z_beta=r1cs.eval_poly(a_poly, beta),
        b_z_beta=r1cs.eval_poly(b_poly, beta), c_z_beta=r1cs.eval_poly(c_poly, beta),
        opening_alpha=EvalOpening(evaluation=qp_alpha),
        opening_beta=EvalOpening(evaluation=qp_beta), modulus=q)
