"""Host modular arithmetic on Python ints (exact, scalar).

The port's copy of the JAX package's ``core/field.py`` (same semantics: every
op returns 0 when ``modulus <= 1``; ``mod_inverse`` returns None for a value
that has no inverse). Tensor arithmetic lives in ``ops.modarith``.
"""

from __future__ import annotations

from typing import Optional, Sequence

MASK64 = (1 << 64) - 1


def mul_mod(a: int, b: int, modulus: int) -> int:
    if modulus <= 1:
        return 0
    return (a * b) % modulus


def add_mod(a: int, b: int, modulus: int) -> int:
    """(a + b) mod modulus for a, b < modulus."""
    if modulus <= 1:
        return 0
    s = a + b
    return s - modulus if s >= modulus else s


def sub_mod(a: int, b: int, modulus: int) -> int:
    """(a - b) mod modulus for a, b < modulus."""
    if modulus <= 1:
        return 0
    d = a + modulus - b
    return d - modulus if d >= modulus else d


def mod_pow(base: int, exponent: int, modulus: int) -> int:
    """base^exponent mod modulus, the exponent cut to its low 64 bits."""
    if modulus <= 1:
        return 0
    return pow(base % modulus, exponent & MASK64, modulus)


def mod_inverse(value: int, modulus: int) -> Optional[int]:
    """Modular inverse, or None when ``value`` has none."""
    if value == 0 or modulus <= 1:
        return None
    reduced = value % modulus
    if reduced == 0:
        return None
    try:
        return pow(reduced, -1, modulus)
    except ValueError:
        return None


def horner_eval(coeffs: Sequence[int], x: int, modulus: int) -> int:
    """f(x) = sum coeffs[i] x^i by Horner."""
    if modulus <= 1 or len(coeffs) == 0:
        return 0
    acc = coeffs[-1] % modulus
    x = x % modulus
    for c in reversed(coeffs[:-1]):
        acc = (acc * x + c) % modulus
    return acc


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for u64 (12 witnesses).

    Reference: ``rust-api/lambda-snark/src/lean_params.rs:175-220`` — the
    VULN-001 guard against composite moduli such as 2^44+1 = 17 * 1034834473201.
    """
    if n < 2:
        return False
    if n in (2, 3):
        return True
    if n % 2 == 0:
        return False
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if a >= n:
            continue
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True
