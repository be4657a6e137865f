"""Example circuit families (the port's copy of the JAX package's
``circuits/examples.py``): the 7 x 13 = 91 multiplication, bit-decomposition
range proofs, and m independent multiplication gates (the benchmark
circuits)."""

from __future__ import annotations

import random
from typing import List, Optional, Tuple

from ..core.errors import InvalidInputError
from ..r1cs.circuit import CircuitBuilder
from ..r1cs.domain import Domain
from ..r1cs.r1cs import R1CS


def multiplication_circuit(modulus: int) -> Tuple[R1CS, List[int]]:
    """a * b = c with witness [1, a, b, c] = [1, 7, 13, 91], l = 2."""
    b = CircuitBuilder(modulus)
    b.alloc_var()  # the constant 1
    a, bb, c = b.alloc_vars(3)
    b.set_public_inputs(2)
    b.mul_gate(a, bb, c)
    return b.build(), [1, 7, 13, 91]


def range_proof_circuit(modulus: int, bits: int = 8,
                        domain: Optional[Domain] = None) -> R1CS:
    """0 <= v < 2^bits by bit decomposition: one booleanity constraint per
    bit and one recomposition constraint; public inputs [1, v]."""
    b = CircuitBuilder(modulus)
    one = b.alloc_var()
    value = b.alloc_var()
    b.set_public_inputs(2)
    bit_vars = b.alloc_vars(bits)
    for bit in bit_vars:  # bit * (bit - 1) = 0
        b.add_constraint([(bit, 1)], [(bit, 1), (one, modulus - 1)], [])
    b.add_constraint([(bit, 1 << i) for i, bit in enumerate(bit_vars)], [(one, 1)],
                     [(value, 1)])
    return b.build(domain=domain)


def range_proof_witness(modulus: int, value: int, bits: int = 8) -> List[int]:
    if not 0 <= value < (1 << bits):
        raise InvalidInputError(f"value {value} out of range [0, 2^{bits})")
    return [1, value] + [(value >> i) & 1 for i in range(bits)]


def multiplication_gates_circuit(m: int, modulus: int,
                                 domain: Optional[Domain] = None) -> R1CS:
    """Witness [1, a_1..m, b_1..m, c_1..m], gate i: a_i * b_i = c_i; l = 1."""
    b = CircuitBuilder(modulus)
    b.alloc_var()  # the constant 1
    a_vars = b.alloc_vars(m)
    b_vars = b.alloc_vars(m)
    c_vars = b.alloc_vars(m)
    b.set_public_inputs(1)
    for i in range(m):
        b.mul_gate(a_vars[i], b_vars[i], c_vars[i])
    return b.build(domain=domain)


def multiplication_gates_witness(m: int, modulus: int, seed: int = 0) -> List[int]:
    rng = random.Random(seed)
    a = [rng.randrange(1, modulus) for _ in range(m)]
    b = [rng.randrange(1, modulus) for _ in range(m)]
    c = [(x * y) % modulus for x, y in zip(a, b)]
    return [1] + a + b + c
