"""Phase-2 checks: lincheck and mulcheck on a committed witness.

The port of the JAX package's ``proof/checks.py``. The prover commits to
the witness z (Module-LWE, seed-deterministic) beside the base
dual-challenge proof; the verifier checks that the revealed (z, seed)
recommits exactly, that z's public prefix is the statement's public input,
that A z, B z, C z interpolated and evaluated at the proof's own alpha and
beta give its six claimed evaluations (lincheck), and that
(A z) o (B z) = C z (mulcheck). The opening reveals z: binding, not zero
knowledge. Host code on ``prover``, ``verifier`` and ``commit.lwe``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from ..commit import lwe
from ..core import field
from ..core.errors import InvalidInputError, LambdaSnarkError
from .types import ProofR1CS, _Reader


class NotYetImplementedCheck(LambdaSnarkError):
    """Kept for the JAX package's API; the phase-2 checks are implemented."""


@dataclasses.dataclass(frozen=True)
class WitnessBinding:
    """The phase-2 attachment: the commitment to z and its revealing opening."""

    commitment_z: lwe.Commitment
    seed: int
    z: tuple  # the revealed witness (ints mod q)

    _MAGIC = b"LSTW"  # wire tag

    def to_bytes(self) -> bytes:
        return b"".join([
            self._MAGIC,
            len(self.z).to_bytes(8, "little"),
            b"".join(int(v).to_bytes(8, "little") for v in self.z),
            int(self.seed).to_bytes(8, "little"),
            len(self.commitment_z.words).to_bytes(8, "little"),
            self.commitment_z.to_bytes(),
        ])

    @staticmethod
    def from_bytes(data: bytes) -> "WitnessBinding":
        if data[:4] != WitnessBinding._MAGIC:
            raise InvalidInputError("bad witness-binding magic")
        r = _Reader(data[4:])
        n = r.u64()
        if n > 1 << 32:
            raise InvalidInputError("witness length out of range")
        z = tuple(r.u64() for _ in range(n))
        seed = r.u64()
        n_words = r.u64()
        comm = lwe.Commitment.from_bytes(r.bytes_(8 * n_words))
        return WitnessBinding(commitment_z=comm, seed=seed, z=z)


def lincheck_prove(r1cs, witness: Sequence[int], ctx: lwe.LweContext,
                   seed: int) -> WitnessBinding:
    """Commit to the witness z for the phase-2 binding."""
    q = r1cs.modulus
    z = tuple(int(v) % q for v in witness)
    if len(z) != r1cs.n:
        raise InvalidInputError(f"witness length {len(z)} != n = {r1cs.n}")
    commitment, _op = lwe.commit(ctx, list(z), seed)
    return WitnessBinding(commitment_z=commitment, seed=seed, z=z)


def lincheck_verify(binding: WitnessBinding, proof: ProofR1CS, public_inputs: Sequence[int],
                    r1cs, ctx: lwe.LweContext) -> bool:
    """The committed witness gives the proof's A_z, B_z, C_z evaluations:
    it recommits exactly, its public prefix is ``public_inputs``, and its
    interpolations agree at alpha and beta."""
    q = r1cs.modulus
    z = [int(v) % q for v in binding.z]
    if len(z) != r1cs.n:
        return False
    recommit, _op = lwe.commit(ctx, z, binding.seed)
    if recommit != binding.commitment_z:
        return False
    if [v % q for v in public_inputs] != z[: len(public_inputs)]:
        return False
    a_poly, b_poly, c_poly = r1cs.interpolations(z)
    alpha, beta = proof.challenge_alpha.alpha, proof.challenge_beta.alpha
    checks = ((a_poly, proof.a_z_alpha, alpha), (b_poly, proof.b_z_alpha, alpha),
              (c_poly, proof.c_z_alpha, alpha), (a_poly, proof.a_z_beta, beta),
              (b_poly, proof.b_z_beta, beta), (c_poly, proof.c_z_beta, beta))
    return all(r1cs.eval_poly(coeffs, at) == claimed for coeffs, claimed, at in checks)


def mulcheck_verify(binding: WitnessBinding, r1cs) -> bool:
    """(A z) o (B z) = C z on the committed witness."""
    q = r1cs.modulus
    z = [int(v) % q for v in binding.z]
    if len(z) != r1cs.n:
        return False
    az, bz, cz = r1cs.compute_constraint_evals(z)
    return all(field.mul_mod(a, b, q) == c for a, b, c in zip(az, bz, cz))


def prove_r1cs_checked(r1cs, witness: Sequence[int], ctx: lwe.LweContext, seed: int):
    """(the base proof with its opening, the witness binding); the binding's
    seed is ``seed ^ 0x4C494E43`` ("LINC"), so the two commitments never
    share randomness."""
    from .. import prover

    proof = prover.prove_r1cs(r1cs, witness, ctx, seed, with_opening=True)
    z_seed = (int(seed) ^ 0x4C494E43) & ((1 << 64) - 1)
    return proof, lincheck_prove(r1cs, witness, ctx, z_seed)


def verify_r1cs_checked(proof: ProofR1CS, binding: WitnessBinding,
                        public_inputs: Sequence[int], r1cs, ctx: lwe.LweContext) -> bool:
    """The base proof with its LWE-bound opening, then lincheck, then mulcheck."""
    from .. import verifier

    if not verifier.verify_r1cs_with_context(proof, public_inputs, r1cs, ctx):
        return False
    if not lincheck_verify(binding, proof, public_inputs, r1cs, ctx):
        return False
    return mulcheck_verify(binding, r1cs)


def available() -> bool:
    return True
