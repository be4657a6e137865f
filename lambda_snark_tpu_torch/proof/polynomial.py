"""Witness-encoding polynomial (the port's copy of the JAX package's
``proof/polynomial.py``): a coefficient vector over F_q with Horner
evaluation, ChaCha20-seeded blinding draws (``next_u64() % q`` per
coefficient, as the reference's ``gen::<u64>() % q``) and coefficient-wise
addition. ``verifier`` uses it to check evaluation openings."""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..core import field
from ..utils.chacha import ChaCha20Rng


class Polynomial:
    __slots__ = ("coeffs", "modulus")

    def __init__(self, coeffs: Sequence[int], modulus: int) -> None:
        self.coeffs: List[int] = [int(c) for c in coeffs]
        self.modulus = modulus

    @staticmethod
    def from_witness(witness: Sequence[int], modulus: int) -> "Polynomial":
        return Polynomial([int(v) % modulus for v in witness], modulus)

    def evaluate(self, alpha: int) -> int:
        return field.horner_eval(self.coeffs, alpha, self.modulus)

    def degree(self) -> int:
        return max(len(self.coeffs) - 1, 0)

    @staticmethod
    def random_blinding(degree: int, modulus: int,
                        seed: Optional[int] = None) -> "Polynomial":
        """degree + 1 uniform coefficients: from ChaCha20 seeded with ``seed``
        (bit-identical to the reference), else from OS entropy."""
        if seed is not None:
            rng = ChaCha20Rng.from_u64(seed)
            coeffs = [rng.next_u64() % modulus for _ in range(degree + 1)]
        else:
            import secrets

            coeffs = [secrets.randbits(64) % modulus for _ in range(degree + 1)]
        return Polynomial(coeffs, modulus)

    def add(self, other: "Polynomial") -> "Polynomial":
        if self.modulus != other.modulus:
            raise ValueError("modulus mismatch")
        n = max(len(self.coeffs), len(other.coeffs))
        pad = lambda c: c + [0] * (n - len(c))
        return Polynomial([field.add_mod(a, b, self.modulus)
                           for a, b in zip(pad(self.coeffs), pad(other.coeffs))],
                          self.modulus)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Polynomial) and self.modulus == other.modulus
                and self.coeffs == other.coeffs)
