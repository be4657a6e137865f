"""Public parameters, profiles and field constants.

The port's copy of the parts of the JAX package's ``core/params.py`` that
the provers read: the moduli, the 45-bit roots of unity,
``Params``/``Profile``/``SecurityLevel`` with the same validation, and the
zeroizing ``Witness`` wrapper.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from .errors import InvalidParamsError
from .field import is_prime

#: Goldilocks prime 2^64 - 2^32 + 1 (the commitment ring's modulus).
NTT_MODULUS = 18446744069414584321

#: Primitive 2^32-th root of unity mod NTT_MODULUS.
NTT_PRIMITIVE_ROOT = 1753635133440165772

#: The composite modulus 2^44 + 1 = 17 * 1034834473201 of the test vectors
#: tv-0/1/2 (kept for conformance only).
LEGACY_COMPOSITE_MODULUS = 17592186044417

#: The prime that replaces it in the reference CLI and the example circuits.
LEGACY_MODULUS = 17592186044423

#: 45-bit NTT-friendly prime 2^44 - 16982015; q - 1 = 2147481575 * 2^13.
NTT_FRIENDLY_MODULUS = 17592169062401

#: Healthcare dump prime 2^31 - 2^27 + 1 (2-adicity 27).
HEALTHCARE_DUMP_MODULUS = 2013265921

#: Primitive m-th roots of unity mod NTT_FRIENDLY_MODULUS (generator 3).
ROOTS_OF_UNITY_45BIT = {
    4: 981206394875,
    8: 4268641988953,
    16: 9400386778549,
    32: 15690227524213,
    64: 8332322609789,
    128: 9249819209096,
    256: 5221410271124,
    512: 9594533594163,
    1024: 11016271016603,
    2048: 14373677444369,
    4096: 11176258803537,
    8192: 9037003627149,
}


class SecurityLevel(enum.IntEnum):
    BITS128 = 128
    BITS192 = 192
    BITS256 = 256


@dataclasses.dataclass(frozen=True)
class Profile:
    """Commitment profile; the commitment context takes ``ring_b`` (n, k, q, sigma)."""

    kind: str
    q: int
    sigma: float
    n: int = 0
    k: int = 0

    @staticmethod
    def ring_b(n: int, k: int, q: int, sigma: float) -> "Profile":
        return Profile(kind="ring_b", q=q, sigma=sigma, n=n, k=k)


@dataclasses.dataclass(frozen=True)
class Params:
    """Security level + profile; ``validate`` checks q > 2^24, sigma >= 3,
    and for ``ring_b`` a power-of-two n and a positive k."""

    security: SecurityLevel
    profile: Profile

    @property
    def q(self) -> int:
        return self.profile.q

    @property
    def sigma(self) -> float:
        return self.profile.sigma

    def validate(self) -> None:
        p = self.profile
        if p.q <= (1 << 24):
            raise InvalidParamsError(f"modulus q={p.q} too small (must exceed 2^24)")
        if p.sigma < 3.0:
            raise InvalidParamsError(
                f"gaussian width sigma={p.sigma} too small (minimum 3.0)"
            )
        if p.kind == "ring_b":
            if p.n <= 0 or (p.n & (p.n - 1)) != 0:
                raise InvalidParamsError(f"ring degree n={p.n} must be a power of two")
            if p.k <= 0:
                raise InvalidParamsError(f"module rank k={p.k} must be positive")
        elif p.kind != "scalar_a":
            raise InvalidParamsError(f"unknown profile kind {p.kind!r}")

    def validate_strict(self) -> None:
        """Additionally require a *prime* modulus (VULN-001 guard).

        The canonical test vectors still use the composite legacy field, so
        this check is opt-in, exactly as the reference keeps
        ``lean_params::validate_params`` separate from ``Params::validate``.
        """
        self.validate()
        if not is_prime(self.profile.q):
            raise InvalidParamsError(
                f"modulus q={self.profile.q} is not prime (VULN-001)"
            )


class Witness:
    """Secret witness wrapper that zeroes its buffer on ``close``/GC.

    Best-effort analog of the reference's zeroize-on-drop ``Witness``
    (``lambda-snark-core/src/lib.rs:199-214``): Python cannot guarantee
    erasure of immutable ints, so values are held in a mutable uint64 numpy
    buffer that is explicitly wiped.
    """

    def __init__(self, values) -> None:
        self._buf: Optional[np.ndarray] = np.asarray(
            [int(v) & ((1 << 64) - 1) for v in values], dtype=np.uint64
        )

    def values(self) -> list:
        if self._buf is None:
            raise ValueError("witness has been zeroized")
        return [int(v) for v in self._buf]

    def __len__(self) -> int:
        return 0 if self._buf is None else int(self._buf.shape[0])

    def close(self) -> None:
        if self._buf is not None:
            self._buf.fill(0)
            self._buf = None

    def __enter__(self) -> "Witness":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover - GC timing dependent
        try:
            self.close()
        except Exception:
            pass
