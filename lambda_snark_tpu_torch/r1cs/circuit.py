"""Circuit builder (the port's copy of ``r1cs/circuit.py``)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from ..core import field
from ..core.errors import InvalidInputError
from .domain import Domain
from .r1cs import R1CS
from .sparse import SparseMatrix

Term = Tuple[int, int]  # (variable index, coefficient)


class CircuitBuilder:
    """Accumulates rank-1 constraints, then builds an ``R1CS``."""

    def __init__(self, modulus: int) -> None:
        self.modulus = modulus
        self._constraints: List[Tuple[List[Term], List[Term], List[Term]]] = []
        self._num_vars = 0
        self._num_public = 0

    def alloc_var(self) -> int:
        idx = self._num_vars
        self._num_vars += 1
        return idx

    def alloc_vars(self, count: int) -> List[int]:
        return [self.alloc_var() for _ in range(count)]

    def set_public_inputs(self, l: int) -> None:
        if l > self._num_vars:
            raise InvalidInputError(
                f"cannot set {l} public inputs with only {self._num_vars} variables"
            )
        self._num_public = l

    def add_constraint(self, a: Sequence[Term], b: Sequence[Term], c: Sequence[Term]) -> None:
        """(A z) * (B z) = (C z), each side a list of (var, coeff) terms."""
        self._constraints.append((list(a), list(b), list(c)))

    def mul_gate(self, x: int, y: int, out: int) -> None:
        """x * y = out."""
        self.add_constraint([(x, 1)], [(y, 1)], [(out, 1)])

    def bool_gate(self, one: int, x: int) -> None:
        """x * x = x (``one`` is unused, as in the JAX package)."""
        self.add_constraint([(x, 1)], [(x, 1)], [(x, 1)])

    def linear_gate(self, one: int, terms: Sequence[Term], out_terms: Sequence[Term]) -> None:
        """(sum terms) * z[one] = (sum out_terms)."""
        self.add_constraint(list(terms), [(one, 1)], list(out_terms))

    @property
    def num_constraints(self) -> int:
        return len(self._constraints)

    @property
    def num_vars(self) -> int:
        return self._num_vars

    def build(self, domain: Optional[Domain] = None) -> R1CS:
        m = len(self._constraints)
        n = self._num_vars
        maps: Tuple[Dict, Dict, Dict] = ({}, {}, {})
        for row, sides in enumerate(self._constraints):
            for side_map, terms in zip(maps, sides):
                for var_idx, coeff in terms:
                    if var_idx >= n:
                        raise InvalidInputError(
                            f"constraint {row} references variable {var_idx} "
                            f"but only {n} allocated"
                        )
                    reduced = coeff % self.modulus
                    if coeff == 0 or reduced == 0:
                        continue
                    key = (row, var_idx)
                    side_map[key] = field.add_mod(side_map.get(key, 0), reduced, self.modulus)
        a, b, c = (SparseMatrix.from_map(m, n, mp) for mp in maps)
        return R1CS(m=m, n=n, l=self._num_public, a=a, b=b, c=c,
                    modulus=self.modulus, domain=domain)
