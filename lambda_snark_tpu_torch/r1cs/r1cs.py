"""R1CS instance (the port's copy of the JAX package's ``r1cs/r1cs.py``):
(Az) o (Bz) = Cz over F_q and the host quotient pipeline

    Q(X) = (A_z(X) B_z(X) - C_z(X)) / Z_H(X)

on Python ints (``compute_quotient_poly``, the golden path of the host
provers), with the constraint evaluations of a whole batch of witnesses
computed in PyTorch for the batched provers (``constraint_evals_batch``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

from ..core import field
from ..core.errors import InvalidDimensionsError, InvalidWitnessError
from ..core.params import (
    NTT_FRIENDLY_MODULUS,
    NTT_MODULUS,
    NTT_PRIMITIVE_ROOT,
    ROOTS_OF_UNITY_45BIT,
)
from . import poly
from .domain import ROOTS, Domain
from .sparse import SparseMatrix


@dataclasses.dataclass
class R1CS:
    """m constraints (Az) o (Bz) = Cz over F_q, n variables, l public inputs
    (the first l witness entries)."""

    m: int
    n: int
    l: int
    a: SparseMatrix
    b: SparseMatrix
    c: SparseMatrix
    modulus: int
    domain: Optional[Domain] = None

    def __post_init__(self) -> None:
        for name, mat in (("A", self.a), ("B", self.b), ("C", self.c)):
            if mat.rows != self.m or mat.cols != self.n:
                raise InvalidDimensionsError(
                    f"matrix {name} must be {self.m}x{self.n}, got {mat.rows}x{mat.cols}"
                )
        if self.l > self.n:
            raise InvalidDimensionsError("public input count l cannot exceed n")
        if self.domain is None:
            self.domain = Domain.select(self.m, self.modulus)

    def validate(self) -> None:
        """Structural checks: m > 0, n > 0, modulus >= 2^24."""
        if self.m == 0:
            raise InvalidDimensionsError("R1CS must have at least one constraint")
        if self.n == 0:
            raise InvalidDimensionsError("R1CS witness size must be > 0")
        if self.modulus < (1 << 24):
            raise InvalidDimensionsError(f"modulus {self.modulus} too small (must exceed 2^24)")

    def is_satisfied(self, witness: Sequence[int]) -> bool:
        """(Az)_i (Bz)_i == (Cz)_i for every constraint i."""
        az, bz, cz = self.compute_constraint_evals(witness)
        q = self.modulus
        return all((az[i] * bz[i]) % q == cz[i] % q for i in range(self.m))

    def public_inputs(self, witness: Sequence[int]) -> List[int]:
        if len(witness) != self.n:
            raise InvalidDimensionsError("witness length must equal n")
        return [int(v) for v in witness[: self.l]]

    def compute_constraint_evals(self, witness: Sequence[int]) -> Tuple[List[int], ...]:
        """Az, Bz, Cz of one witness, on Python ints."""
        if len(witness) != self.n:
            raise InvalidDimensionsError(
                f"witness length {len(witness)} must equal n={self.n}"
            )
        return tuple(mat.mul_vec(witness, self.modulus) for mat in (self.a, self.b, self.c))

    def constraint_evals_batch(self, w: torch.Tensor):
        """Az, Bz, Cz (each (B, m) words) for witnesses w (B, n) of canonical words."""
        return tuple(mat.mul_batch(w, self.modulus) for mat in (self.a, self.b, self.c))

    def eval_poly(self, coeffs: Sequence[int], x: int) -> int:
        return poly.poly_eval(coeffs, x, self.modulus)

    def eval_vanishing(self, x: int) -> int:
        return self.domain.eval_vanishing(x)

    def interpolations(self, witness: Sequence[int]):
        """A_z, B_z, C_z interpolated over the domain."""
        return tuple(poly.lagrange_interpolate(ev, self.domain)
                     for ev in self.compute_constraint_evals(witness))

    def compute_quotient_poly(self, witness: Sequence[int]) -> List[int]:
        """Q = (A_z B_z - C_z) / Z_H, trailing zeros trimmed. Raises
        InvalidWitnessError for a witness that fails the constraints. A
        roots domain of power-of-two size takes the odd-coset form where
        the field has the 2m-th root; any other takes the long division."""
        if not self.is_satisfied(witness):
            raise InvalidWitnessError("witness does not satisfy R1CS constraints")
        if self.domain.kind == ROOTS and (self.m & (self.m - 1)) == 0:
            fast = self._quotient_odd_coset(witness)
            if fast is not None:
                return fast
        return self._quotient_longdiv(witness)

    def compute_quotient_poly_longdiv(self, witness: Sequence[int]) -> List[int]:
        """The O(m^2) oracle: schoolbook product, then long division."""
        if not self.is_satisfied(witness):
            raise InvalidWitnessError("witness does not satisfy R1CS constraints")
        return self._quotient_longdiv(witness)

    def _quotient_longdiv(self, witness: Sequence[int]) -> List[int]:
        a_poly, b_poly, c_poly = self.interpolations(witness)
        numerator = poly.poly_sub(poly.poly_mul(a_poly, b_poly, self.modulus), c_poly,
                                  self.modulus)
        return poly.poly_div_vanishing(numerator, self.domain)

    def _quotient_odd_coset(self, witness: Sequence[int]):
        """The quotient on the odd coset psi <omega>, where Z_H is -2:
        Q's negacyclic NTT is ((A B - C) at the odd points) (-2)^-1. Needs
        a 2m-th root psi with psi^2 = omega; None where there is none."""
        q, m = self.modulus, self.m
        psi = None
        if q == NTT_FRIENDLY_MODULUS and 2 * m in ROOTS_OF_UNITY_45BIT:
            psi = ROOTS_OF_UNITY_45BIT[2 * m]
        elif q == NTT_MODULUS and 2 * m <= (1 << 32):
            psi = field.mod_pow(NTT_PRIMITIVE_ROOT, (1 << 32) // (2 * m), q)
        if psi is None or field.mul_mod(psi, psi, q) != self.domain.omega % q:
            return None
        psi_pows, psi_inv_pows = [1] * m, [1] * m
        psi_inv = field.mod_inverse(psi, q)
        for i in range(1, m):
            psi_pows[i] = field.mul_mod(psi_pows[i - 1], psi, q)
            psi_inv_pows[i] = field.mul_mod(psi_inv_pows[i - 1], psi_inv, q)
        omega = self.domain.omega

        def odd(p):
            padded = list(p) + [0] * (m - len(p))
            return poly.ntt_forward([field.mul_mod(c, w, q) for c, w in zip(padded, psi_pows)],
                                    q, omega)

        a_odd, b_odd, c_odd = (odd(p) for p in self.interpolations(witness))
        neg_half_inv = field.mod_inverse(q - 2, q)
        q_odd = [field.mul_mod(field.sub_mod(field.mul_mod(a_odd[i], b_odd[i], q), c_odd[i], q),
                               neg_half_inv, q) for i in range(m)]
        q_coeffs = [field.mul_mod(c, w, q)
                    for c, w in zip(poly.ntt_inverse(q_odd, q, omega), psi_inv_pows)]
        while len(q_coeffs) > 1 and q_coeffs[-1] == 0:
            q_coeffs.pop()
        return q_coeffs

    def total_nnz(self) -> int:
        return self.a.nnz() + self.b.nnz() + self.c.nnz()

    def density(self) -> float:
        total = 3 * self.m * self.n
        return self.total_nnz() / total if total else 0.0
