"""Lean parameter record import + security validation.

Parity with reference ``rust-api/lambda-snark/src/lean_params.rs:31-220``:
parse ``{ n := 4096, k := 2, q := 12289, σ := 3.2, λ := 128 }`` and validate

1. q prime (Miller-Rabin; the VULN-001 composite-modulus guard),
2. n a power of two,
3. sigma >= 3.0,
4. lambda in {128, 192, 256}.
"""

from __future__ import annotations

import dataclasses

from ..core.errors import InvalidInputError, InvalidParamsError
from ..core.field import is_prime


@dataclasses.dataclass(frozen=True)
class SecurityParams:
    n: int
    k: int
    q: int
    sigma: float
    lam: int

    @staticmethod
    def from_lean(lean_str: str) -> "SecurityParams":
        trimmed = lean_str.strip()
        if not (trimmed.startswith("{") and trimmed.endswith("}")):
            raise InvalidInputError(
                "Lean params must be in record syntax { ... }"
            )
        content = trimmed[1:-1]
        values = {}
        for fieldstr in content.split(","):
            parts = fieldstr.split(":=")
            if len(parts) != 2:
                continue
            key = parts[0].strip()
            value = parts[1].strip()
            try:
                if key == "n":
                    values["n"] = int(value)
                elif key == "k":
                    values["k"] = int(value)
                elif key == "q":
                    values["q"] = int(value)
                elif key in ("σ", "sigma"):
                    values["sigma"] = float(value)
                elif key in ("λ", "lambda"):
                    values["lam"] = int(value)
            except ValueError as exc:
                raise InvalidInputError(f"invalid {key}: {value}") from exc
        for required in ("n", "k", "q", "sigma", "lam"):
            if required not in values:
                raise InvalidInputError(f"missing field: {required}")
        return SecurityParams(**values)

    def to_lean(self) -> str:
        return (
            "{{ n := {}, k := {}, q := {}, σ := {}, λ := {} }}".format(
                self.n, self.k, self.q, self.sigma, self.lam
            )
        )


def validate_params(params: SecurityParams) -> None:
    if not is_prime(params.q):
        raise InvalidParamsError(
            f"modulus q={params.q} is not prime (VULN-001: composite moduli "
            "break the field assumption)"
        )
    if params.n <= 0 or (params.n & (params.n - 1)) != 0:
        raise InvalidParamsError(
            f"LWE dimension n={params.n} must be a power of two for NTT"
        )
    if params.sigma < 3.0:
        raise InvalidParamsError(
            f"gaussian width sigma={params.sigma} too small (minimum 3.0)"
        )
    if params.lam not in (128, 192, 256):
        raise InvalidParamsError(
            f"security level lambda={params.lam} not supported"
        )
