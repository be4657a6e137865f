"""Exact polynomial algebra over F_q on Python ints (the port's copy of the
JAX package's ``r1cs/poly.py``, the golden host path).

Coefficient vectors are lists of ints in ascending degree. Each routine
follows a reference function (cited per function): sums and products,
Horner evaluation, Lagrange interpolation over a ``Domain`` (the inverse
NTT on a roots domain, the master-polynomial form on any other), the
radix-2 NTT and its inverse, and exact division by the vanishing
polynomial. The device paths (kernels Q and T) are held against these.
"""

from __future__ import annotations

from typing import List, Sequence

from ..core import field
from ..core.errors import InvalidWitnessError
from .domain import Domain, ROOTS


def poly_add(a: Sequence[int], b: Sequence[int], q: int) -> List[int]:
    """a(X) + b(X), trailing zeros trimmed. Reference ``r1cs.rs:903-925``."""
    n = max(len(a), len(b))
    out = [
        field.add_mod((a[i] if i < len(a) else 0) % q, (b[i] if i < len(b) else 0) % q, q)
        for i in range(n)
    ]
    return _trim(out)


def poly_sub(a: Sequence[int], b: Sequence[int], q: int) -> List[int]:
    """a(X) - b(X), trailing zeros trimmed. Reference ``r1cs.rs:876-899``."""
    n = max(len(a), len(b))
    out = [
        field.sub_mod((a[i] if i < len(a) else 0) % q, (b[i] if i < len(b) else 0) % q, q)
        for i in range(n)
    ]
    return _trim(out)


def poly_mul(a: Sequence[int], b: Sequence[int], q: int) -> List[int]:
    """a(X) * b(X), schoolbook convolution. Reference ``r1cs.rs:846-863``."""
    if not a or not b:
        return [0]
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        if x == 0:
            continue
        xm = x % q
        for j, y in enumerate(b):
            out[i + j] = field.add_mod(out[i + j], field.mul_mod(xm, y % q, q), q)
    return out


def poly_mul_scalar(p: Sequence[int], scalar: int, q: int) -> List[int]:
    """scalar * p(X). Reference ``r1cs.rs:929-939``."""
    s = scalar % q
    return [field.mul_mod(c % q, s, q) for c in p]


def poly_eval(p: Sequence[int], x: int, q: int) -> int:
    """p(x) by Horner. Reference ``r1cs.rs:362-373`` / ``polynomial.rs:97-113``."""
    return field.horner_eval(list(p), x, q)


def _trim(p: List[int]) -> List[int]:
    while len(p) > 1 and p[-1] == 0:
        p.pop()
    return p


# --- interpolation ----------------------------------------------------------


def lagrange_interpolate(evals: Sequence[int], domain: Domain) -> List[int]:
    """Interpolate the unique degree-<m polynomial through the domain points.

    Reference dispatch ``r1cs.rs:746-793``:
    - roots domain: inverse NTT (O(m log m)), identical coefficients to the
      reference's O(m^2) omega-domain Lagrange basis (interpolation is unique).
    - sequential domain: O(m^2) Lagrange basis, bit-exact with
      ``lagrange_basis_sequential`` (``r1cs.rs:655-696``).
    """
    m = len(evals)
    if m == 0:
        return []
    assert m == domain.m, f"evals length {m} != domain size {domain.m}"
    q = domain.modulus
    if domain.kind == ROOTS and (m & (m - 1)) == 0:
        return ntt_inverse(list(evals), q, domain.omega)
    pts = domain.points()
    return _lagrange_generic(list(evals), pts, q)


def _lagrange_generic(evals: List[int], pts: List[int], q: int) -> List[int]:
    """O(m^2) interpolation via the master polynomial M(X) = prod (X - x_j).

    L_i = (M / (X - x_i)) * inv(M'(x_i)) with the division done synthetically
    in O(m). Exact arithmetic => identical coefficients to the naive
    basis-summation the reference uses (``r1cs.rs:746-828``), ~30x faster on
    the host at m ~ 32.
    """
    m = len(evals)
    # master polynomial
    master = [1]
    for x in pts:
        new = [0] * (len(master) + 1)
        xm = x % q
        for k, c in enumerate(master):
            new[k + 1] = field.add_mod(new[k + 1], c, q)
            new[k] = field.sub_mod(new[k], field.mul_mod(xm, c, q), q)
        master = new
    result = [0] * m
    for i in range(m):
        ei = evals[i] % q
        if ei == 0 and m > 1:
            # still need denominators only for nonzero contributions
            continue
        xi = pts[i] % q
        # synthetic division: basis_num = master / (X - xi), degree m-1
        basis = [0] * m
        carry = master[m]  # leading coeff (= 1)
        for j in range(m - 1, -1, -1):
            basis[j] = carry
            carry = field.add_mod(master[j], field.mul_mod(xi, carry, q), q)
        # denominator = basis_num(xi) = M'(xi)
        denom = field.horner_eval(basis, xi, q)
        dinv = field.mod_inverse(denom, q)
        if dinv is None:
            raise InvalidWitnessError(
                f"domain point difference not invertible mod {q} (composite modulus?)"
            )
        scale = field.mul_mod(ei, dinv, q)
        for j in range(m):
            result[j] = field.add_mod(
                result[j], field.mul_mod(scale, basis[j], q), q
            )
    return result


def _lagrange_basis(i: int, pts: List[int], q: int) -> List[int]:
    """L_i(X) coefficients over arbitrary points. Reference ``r1cs.rs:596-696``."""
    m = len(pts)
    poly = [1]
    denom = 1
    for j in range(m):
        if j == i:
            continue
        # poly *= (X - pts[j])
        new = [0] * (len(poly) + 1)
        for k, c in enumerate(poly):
            new[k + 1] = field.add_mod(new[k + 1], c, q)
            new[k] = field.sub_mod(new[k], field.mul_mod(pts[j], c, q), q)
        poly = new
        denom = field.mul_mod(denom, field.sub_mod(pts[i], pts[j], q), q)
    dinv = field.mod_inverse(denom, q)
    if dinv is None:
        raise InvalidWitnessError(
            f"domain point difference not invertible mod {q} (composite modulus?)"
        )
    poly = [field.mul_mod(c, dinv, q) for c in poly]
    poly += [0] * (m - len(poly))
    return poly


# --- host NTT (golden; device version in ops.ntt) ---------------------------


def _bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


def ntt_forward(coeffs: Sequence[int], q: int, omega: int) -> List[int]:
    """Radix-2 DIT cyclic NTT. Bit-exact with reference ``ntt.rs:117-162``."""
    n = len(coeffs)
    assert n & (n - 1) == 0, f"NTT size must be a power of two, got {n}"
    if n == 1:
        return [coeffs[0] % q]
    log_n = n.bit_length() - 1
    data = [coeffs[_bit_reverse(i, log_n)] % q for i in range(n)]
    for s in range(1, log_n + 1):
        m = 1 << s
        half = m >> 1
        omega_m = field.mod_pow(omega, n // m, q)
        for k in range(0, n, m):
            w = 1
            for j in range(half):
                t = field.mul_mod(data[k + j + half], w, q)
                u = data[k + j]
                data[k + j] = field.add_mod(u, t, q)
                data[k + j + half] = field.sub_mod(u, t, q)
                w = field.mul_mod(w, omega_m, q)
    return data


def ntt_inverse(evals: Sequence[int], q: int, omega: int) -> List[int]:
    """Inverse cyclic NTT = forward with omega^-1 then scale by n^-1.

    Reference ``ntt.rs:182-201``.
    """
    n = len(evals)
    if n == 1:
        return [evals[0] % q]
    omega_inv = field.mod_inverse(omega, q)
    n_inv = field.mod_inverse(n, q)
    if omega_inv is None or n_inv is None:
        raise InvalidWitnessError("omega or n not invertible for inverse NTT")
    out = ntt_forward(evals, q, omega_inv)
    return [field.mul_mod(c, n_inv, q) for c in out]


# --- vanishing division -----------------------------------------------------


def poly_div_vanishing(
    numerator: Sequence[int], domain: Domain
) -> List[int]:
    """Exact division by Z_H; raises InvalidWitnessError on nonzero remainder.

    Reference ``r1cs.rs:995-1065`` (long division). For the roots domain
    Z_H = X^m - 1, division reduces to the linear recurrence
    q_i = n_{i+m} + q_{i+m}, computed high-to-low — O(deg) instead of O(deg*m),
    same exactness check.
    """
    q = domain.modulus
    m = domain.m
    num = [c % q for c in numerator]
    if not num:
        return [0]
    if domain.kind == ROOTS:
        deg_num = len(num) - 1
        if deg_num < m:
            if any(num):
                raise InvalidWitnessError("vanishing division: nonzero remainder")
            return [0]
        quot = [0] * (deg_num - m + 1)
        rem = list(num)
        for i in range(deg_num - m, -1, -1):
            c = rem[i + m]
            quot[i] = c
            rem[i + m] = 0
            rem[i] = field.add_mod(rem[i], c, q)  # subtracting (-1)*c
        if any(rem):
            raise InvalidWitnessError("vanishing division: nonzero remainder")
        return _trim(quot)
    divisor = domain.vanishing_poly()
    return _poly_long_division_exact(num, divisor, q)


def _poly_long_division_exact(num: List[int], divisor: List[int], q: int) -> List[int]:
    deg_num = len(num) - 1
    deg_div = len(divisor) - 1
    if deg_num < deg_div:
        if any(num):
            raise InvalidWitnessError("vanishing division: nonzero remainder")
        return [0]
    lead_inv = field.mod_inverse(divisor[deg_div], q)
    if lead_inv is None:
        raise InvalidWitnessError("vanishing divisor leading coeff not invertible")
    rem = list(num)
    quot = [0] * (deg_num - deg_div + 1)
    for i in range(deg_num - deg_div, -1, -1):
        qc = field.mul_mod(rem[i + deg_div], lead_inv, q)
        quot[i] = qc
        if qc:
            for j, d in enumerate(divisor):
                rem[i + j] = field.sub_mod(rem[i + j], field.mul_mod(qc, d, q), q)
    if any(rem):
        raise InvalidWitnessError("vanishing division: nonzero remainder")
    return _trim(quot)
