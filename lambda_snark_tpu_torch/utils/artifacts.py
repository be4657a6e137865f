"""Circuit digests (the port's copy of ``circuit_digest`` from the JAX
package's ``utils/artifacts.py``).

The digest binds the FRI proof kinds' challenges to their circuit (wire
v4, ``proof.succinct.statement_binding_words``).
"""

from __future__ import annotations

import hashlib

from ..r1cs.r1cs import R1CS


def circuit_digest(r1cs: R1CS) -> str:
    """SHA3-256 hex over the canonical circuit description:
    ``"m,n,l,modulus,domain_kind"`` then ``"row,col,val;"`` for every entry
    of A, B and C in CSR order.

    Cached on the instance, as the JAX package does: a circuit mutated in
    place after its first digest keeps the old digest (a reference
    behaviour, kept as it is)."""
    cached = getattr(r1cs, "_circuit_digest_cache", None)
    if cached is not None:
        return cached
    h = hashlib.sha3_256()
    h.update(f"{r1cs.m},{r1cs.n},{r1cs.l},{r1cs.modulus},{r1cs.domain.kind}".encode())
    for mat in (r1cs.a, r1cs.b, r1cs.c):
        for row, col, val in mat.coo():
            h.update(f"{row},{col},{val};".encode())
    digest = h.hexdigest()
    r1cs._circuit_digest_cache = digest
    return digest
