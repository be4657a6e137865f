"""Interpolation domains (the port's copy of ``r1cs/domain.py``).

``Domain.select`` picks the roots domain H = {w^i} with Z_H = X^m - 1 for
the Goldilocks modulus and for the 44-bit field with m in the root table;
any other (q, m) gets the sequential domain {0..m-1}, which the batched
provers reject and the host provers (``prover``) and the verifiers take.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..core import field
from ..core.errors import DomainError
from ..core.params import (
    NTT_FRIENDLY_MODULUS,
    NTT_MODULUS,
    NTT_PRIMITIVE_ROOT,
    ROOTS_OF_UNITY_45BIT,
)

SEQUENTIAL = "sequential"
ROOTS = "roots"


@dataclasses.dataclass(frozen=True)
class Domain:
    kind: str
    m: int
    modulus: int
    omega: Optional[int] = None  # primitive m-th root (roots domain only)

    @staticmethod
    def sequential(m: int, modulus: int) -> "Domain":
        return Domain(kind=SEQUENTIAL, m=m, modulus=modulus)

    @staticmethod
    def roots(m: int, modulus: int, omega: int) -> "Domain":
        return Domain(kind=ROOTS, m=m, modulus=modulus, omega=omega)

    @staticmethod
    def select(m: int, modulus: int) -> "Domain":
        if m <= 0:
            raise DomainError("domain size m must be positive")
        is_pow2 = (m & (m - 1)) == 0
        if modulus == NTT_MODULUS and is_pow2 and m <= (1 << 32):
            omega = field.mod_pow(NTT_PRIMITIVE_ROOT, (1 << 32) // m, modulus)
            return Domain.roots(m, modulus, omega)
        if modulus == NTT_FRIENDLY_MODULUS and m in ROOTS_OF_UNITY_45BIT:
            return Domain.roots(m, modulus, ROOTS_OF_UNITY_45BIT[m])
        return Domain.sequential(m, modulus)

    @property
    def use_ntt(self) -> bool:
        """Whether the domain is the roots of unity (NTT interpolation)."""
        return self.kind == ROOTS

    def points(self) -> List[int]:
        """The m domain points, in order."""
        q = self.modulus
        if self.kind == SEQUENTIAL:
            return [i % q for i in range(self.m)]
        pts = [1]
        for _ in range(1, self.m):
            pts.append(field.mul_mod(pts[-1], self.omega, q))
        return pts

    def vanishing_poly(self) -> List[int]:
        """Coefficients of Z_H: X^m - 1 on a roots domain, prod_i (X - i)
        on the sequential one."""
        q = self.modulus
        if self.kind == ROOTS:
            return [q - 1] + [0] * (self.m - 1) + [1]
        poly = [1]
        for i in range(self.m):
            a = i % q
            out = [0] * (len(poly) + 1)
            for j, c in enumerate(poly):  # poly * (X - a)
                out[j + 1] = field.add_mod(out[j + 1], c, q)
                out[j] = field.sub_mod(out[j], field.mul_mod(a, c, q), q)
            poly = out
        return poly

    def eval_vanishing(self, x: int) -> int:
        """Z_H(x): x^m - 1 on a roots domain, prod_i (x - i) on the
        sequential one (the verifiers take both)."""
        q = self.modulus
        if self.kind == ROOTS:
            return field.sub_mod(field.mod_pow(x, self.m, q), 1, q)
        result = 1
        for i in range(self.m):
            result = field.mul_mod(result, field.sub_mod(x, i % q, q), q)
        return result
