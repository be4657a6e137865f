"""Lean 4 artifact export.

Emits the exact term formats the reference's Lean layer consumes, so the
existing formal proofs remain usable without re-proving (SURVEY.md section 7
step 10):

- ``SparseMatrix.mk rows cols [(r, c, v), ...]`` and the VK anonymous
  constructor ``<m, n, l, q, A, B, C>``
  (reference ``rust-api/lambda-snark/src/lean_export.rs:84-130``),
- the params record ``{ n := ..., k := ..., q := ..., σ := ..., λ := ... }``
  (reference ``cpp-core/src/lean_ffi.cpp:67-77,209-230``),
- the quotient-dump JSON consumed by ``formal/tests/HealthcareQuotient.lean``
  (reference ``examples/healthcare_quotient_dump.rs:18-40``).
"""

from __future__ import annotations

import json
from typing import Sequence

from ..core.params import Params
from ..r1cs.r1cs import R1CS
from ..r1cs.sparse import SparseMatrix


def sparse_matrix_to_lean(mat: SparseMatrix) -> str:
    """``SparseMatrix.mk rows cols [(r, c, v), ...]`` (row-major order)."""
    entries = ", ".join(f"({r}, {c}, {v})" for r, c, v in mat.coo())
    return f"SparseMatrix.mk {mat.rows} {mat.cols} [{entries}]"


def vk_to_lean(r1cs: R1CS) -> str:
    """Anonymous-constructor VK term ``<m, n, l, q, A, B, C>``."""
    return (
        "⟨{}, {}, {}, {},\n  {},\n  {},\n  {}⟩".format(
            r1cs.m,
            r1cs.n,
            r1cs.l,
            r1cs.modulus,
            sparse_matrix_to_lean(r1cs.a),
            sparse_matrix_to_lean(r1cs.b),
            sparse_matrix_to_lean(r1cs.c),
        )
    )


def params_to_lean(params: Params) -> str:
    """Lean record ``{ n := ..., k := ..., q := ..., σ := ..., λ := ... }``."""
    p = params.profile
    return (
        "{{ n := {}, k := {}, q := {}, σ := {}, λ := {} }}".format(
            p.n, p.k, p.q, p.sigma, int(params.security)
        )
    )


def quotient_dump_json(
    r1cs: R1CS,
    witness: Sequence[int],
    q_coeffs: Sequence[int],
    description: str = "",
) -> str:
    """Quotient artifact for the Lean cross-check (HealthcareQuotient.lean)."""
    az, bz, cz = r1cs.compute_constraint_evals(witness)
    payload = {
        "description": description,
        "modulus": r1cs.modulus,
        "m": r1cs.m,
        "n": r1cs.n,
        "l": r1cs.l,
        "witness": [int(v) for v in witness],
        "a_evals": az,
        "b_evals": bz,
        "c_evals": cz,
        "quotient": [int(v) for v in q_coeffs],
        "domain": r1cs.domain.kind,
    }
    return json.dumps(payload, indent=2)


def quotient_dump_reference_format(modulus: int, q_coeffs: Sequence[int]) -> str:
    """The exact JSON shape of the reference dump binary
    (``examples/healthcare_quotient_dump.rs``: {"modulus", "coefficients"}),
    consumable by the existing Lean tooling."""
    return json.dumps(
        {"modulus": modulus, "coefficients": [int(v) for v in q_coeffs]},
        indent=2,
    )


def write_artifact(path: str, content: str) -> None:
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(content)
        if not content.endswith("\n"):
            f.write("\n")
