"""Gallery of simple circuits (the port's copy of the JAX package's
``circuits/simple.py``): each function returns (R1CS, witness) for a common
arithmetic pattern, over the reference CLI's prime by default.
"""

from __future__ import annotations

from typing import List, Tuple

from ..core.params import LEGACY_MODULUS
from ..r1cs.circuit import CircuitBuilder
from ..r1cs.r1cs import R1CS

Q = LEGACY_MODULUS


def multiplication_gate(q: int = Q) -> Tuple[R1CS, List[int]]:
    """a * b = c (7 * 13 = 91)."""
    b = CircuitBuilder(q)
    one, a, bb, c = b.alloc_var(), b.alloc_var(), b.alloc_var(), b.alloc_var()
    b.set_public_inputs(2)
    b.mul_gate(a, bb, c)
    return b.build(), [1, 7, 13, 91]


def two_multiplications(q: int = Q) -> Tuple[R1CS, List[int]]:
    """d = (a*b) * c chained through an intermediate."""
    b = CircuitBuilder(q)
    one = b.alloc_var()
    a, bb, c = b.alloc_vars(3)
    t, d = b.alloc_vars(2)
    b.set_public_inputs(1)
    b.mul_gate(a, bb, t)
    b.mul_gate(t, c, d)
    w = [1, 3, 5, 7, 15, 105]
    return b.build(), w


def addition_gate(q: int = Q) -> Tuple[R1CS, List[int]]:
    """(a + b) * 1 = c."""
    b = CircuitBuilder(q)
    one = b.alloc_var()
    a, bb, c = b.alloc_vars(3)
    b.set_public_inputs(1)
    b.add_constraint([(a, 1), (bb, 1)], [(one, 1)], [(c, 1)])
    return b.build(), [1, 30, 12, 42]


def subtraction_gate(q: int = Q) -> Tuple[R1CS, List[int]]:
    """(a - b) * 1 = c  (coefficients mod q encode the -1)."""
    b = CircuitBuilder(q)
    one = b.alloc_var()
    a, bb, c = b.alloc_vars(3)
    b.set_public_inputs(1)
    b.add_constraint([(a, 1), (bb, q - 1)], [(one, 1)], [(c, 1)])
    return b.build(), [1, 50, 8, 42]


def scalar_multiplication(q: int = Q, k: int = 5) -> Tuple[R1CS, List[int]]:
    """k * a = c for a circuit constant k."""
    b = CircuitBuilder(q)
    one = b.alloc_var()
    a, c = b.alloc_vars(2)
    b.set_public_inputs(1)
    b.add_constraint([(a, k)], [(one, 1)], [(c, 1)])
    return b.build(), [1, 9, 45]


def square_gate(q: int = Q) -> Tuple[R1CS, List[int]]:
    """a * a = c."""
    b = CircuitBuilder(q)
    one = b.alloc_var()
    a, c = b.alloc_vars(2)
    b.set_public_inputs(1)
    b.mul_gate(a, a, c)
    return b.build(), [1, 12, 144]


def boolean_and(q: int = Q) -> Tuple[R1CS, List[int]]:
    """Booleanity of a, b plus c = a AND b = a*b."""
    b = CircuitBuilder(q)
    one = b.alloc_var()
    a, bb, c = b.alloc_vars(3)
    b.set_public_inputs(1)
    b.add_constraint([(a, 1)], [(a, 1), (one, q - 1)], [])
    b.add_constraint([(bb, 1)], [(bb, 1), (one, q - 1)], [])
    b.mul_gate(a, bb, c)
    return b.build(), [1, 1, 1, 1]


def boolean_xor(q: int = Q) -> Tuple[R1CS, List[int]]:
    """c = a XOR b = a + b - 2ab, with booleanity and an ab helper."""
    b = CircuitBuilder(q)
    one = b.alloc_var()
    a, bb, ab, c = b.alloc_vars(4)
    b.set_public_inputs(1)
    b.add_constraint([(a, 1)], [(a, 1), (one, q - 1)], [])
    b.add_constraint([(bb, 1)], [(bb, 1), (one, q - 1)], [])
    b.mul_gate(a, bb, ab)
    b.add_constraint([(a, 1), (bb, 1), (ab, q - 2)], [(one, 1)], [(c, 1)])
    return b.build(), [1, 1, 0, 0, 1]


def fibonacci(q: int = Q, steps: int = 5) -> Tuple[R1CS, List[int]]:
    """f_{i+2} = f_{i+1} + f_i enforced linearly for ``steps`` steps."""
    b = CircuitBuilder(q)
    one = b.alloc_var()
    f = b.alloc_vars(steps + 2)
    b.set_public_inputs(1)
    for i in range(steps):
        b.add_constraint(
            [(f[i], 1), (f[i + 1], 1)], [(one, 1)], [(f[i + 2], 1)]
        )
    vals = [1, 1]
    for _ in range(steps):
        vals.append(vals[-1] + vals[-2])
    return b.build(), [1] + vals


ALL_EXAMPLES = {
    "multiplication_gate": multiplication_gate,
    "two_multiplications": two_multiplications,
    "addition_gate": addition_gate,
    "subtraction_gate": subtraction_gate,
    "scalar_multiplication": scalar_multiplication,
    "square_gate": square_gate,
    "boolean_and": boolean_and,
    "boolean_xor": boolean_xor,
    "fibonacci": fibonacci,
}
