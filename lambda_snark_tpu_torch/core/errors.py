"""Typed error hierarchy for lambda_snark_tpu_torch (same classes and meanings
as the JAX package, kept as a copy so the port never imports it).

Mirrors the error surface of the reference stack:
- Rust ``Error`` enums (reference ``rust-api/lambda-snark/src/lib.rs:104-125``,
  ``rust-api/lambda-snark-core/src/lib.rs:217-236``)
- C ``LambdaSnarkError`` codes (reference ``cpp-core/include/lambda_snark/types.h:71-79``)
"""

from __future__ import annotations


class LambdaSnarkError(Exception):
    """Base class for all framework errors."""


class InvalidInputError(LambdaSnarkError):
    """Invalid user input (bad parameters, malformed data)."""


class InvalidParamsError(LambdaSnarkError):
    """Parameter validation failure (``Params::validate`` analog)."""


class InvalidWitnessError(LambdaSnarkError):
    """Witness does not satisfy the constraint system.

    Raised where the reference returns
    ``Err("Witness does not satisfy R1CS constraints")``
    (reference ``r1cs.rs:477-481``) or a non-exact vanishing division
    (reference ``r1cs.rs:1052-1057``).
    """


class InvalidDimensionsError(LambdaSnarkError):
    """Dimension mismatch (``Error::InvalidDimensions`` analog)."""


class DomainError(LambdaSnarkError):
    """No valid interpolation domain for the requested (modulus, m) pair."""


class CommitmentError(LambdaSnarkError):
    """Commitment generation failure (a message longer than the ring degree)."""


class SerializationError(LambdaSnarkError):
    """Proof (de)serialization failure."""
