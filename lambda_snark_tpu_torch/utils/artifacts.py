"""Circuit and statement digests and the proof store (the port's copy of
``circuit_digest``, ``statement_digest`` and ``ProofStore`` from the JAX
package's ``utils/artifacts.py``).

The circuit digest binds the FRI proof kinds' challenges to their circuit
(wire v4, ``proof.succinct.statement_binding_words``). ``ProofStore`` keeps
proofs in a directory with a JSON manifest keyed by statement digest, in
the JAX package's layout, so either package reads the other's store; it is
the resume log of ``prove_r1cs_stream``: every value is seed-derived, so a
restarted stream regenerates the same bytes and skips what the store holds.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence

from ..proof.types import ProofR1CS, ProofR1csZk, deserialize_any
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


def statement_digest(r1cs: R1CS, public_inputs: Sequence[int], seed: int,
                     label: str = "") -> str:
    """Key of one proved statement: SHA3-256 hex over the circuit digest,
    the public inputs, the seed and ``label`` (which tells apart batch
    members whose publics and seed coincide)."""
    h = hashlib.sha3_256()
    h.update(circuit_digest(r1cs).encode())
    h.update(b"|")
    for v in public_inputs:
        h.update(f"{int(v)},".encode())
    h.update(f"|{seed}|{label}".encode())
    return h.hexdigest()


class ProofStore:
    """Directory-backed proof store: ``<sha3 of the bytes>.proof`` files and
    ``manifest.json`` (statement digest -> blob, circuit, publics, seed,
    size, kind)."""

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._manifest_path = os.path.join(root, "manifest.json")
        self._manifest: Dict[str, dict] = {}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                self._manifest = json.load(f)

    def _flush(self) -> None:
        tmp = self._manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f, indent=2, sort_keys=True)
        os.replace(tmp, self._manifest_path)

    def contains(self, key: str) -> bool:
        return key in self._manifest

    def save(self, r1cs: R1CS, public_inputs: Sequence[int], seed: int, proof,
             extra: Optional[dict] = None, label: str = "") -> str:
        key = statement_digest(r1cs, public_inputs, seed, label)
        data = proof.to_bytes()
        blob = hashlib.sha3_256(data).hexdigest()
        with open(os.path.join(self.root, f"{blob}.proof"), "wb") as f:
            f.write(data)
        self._manifest[key] = {
            "proof_blob": blob,
            "circuit": circuit_digest(r1cs),
            "public_inputs": [int(v) for v in public_inputs],
            "seed": seed,
            "size_bytes": len(data),
            "kind": type(proof).__name__,
            **(extra or {}),
        }
        self._flush()
        return key

    def load(self, key: str):
        with open(os.path.join(self.root, f"{self._manifest[key]['proof_blob']}.proof"),
                  "rb") as f:
            return deserialize_any(f.read())

    def keys(self) -> List[str]:
        return sorted(self._manifest)

    def verify_all(self, r1cs: R1CS) -> Dict[str, bool]:
        """Re-verify every stored proof of this circuit: kinds 2/3/6, the
        compact kinds 4/5 and kinds 7 and 9 with their verifiers, the FRI
        kinds against their own recorded FRI parameters (an integrity
        sweep, not an acceptance floor). A proof of another type (kind 1,
        the aggregate) records False, as in the JAX package; a blob that
        does not decode raises, as there."""
        from ..proof.compact import CompactProofR1CS, verify_r1cs_compact
        from ..proof.succinct import SuccinctProofR1CS, verify_r1cs_succinct
        from ..proof.succinct_witness import WitnessProofR1CS, verify_r1cs_witness
        from ..verifier import verify_r1cs, verify_r1cs_zk

        cdig = circuit_digest(r1cs)
        results = {}
        for key, entry in self._manifest.items():
            if entry["circuit"] != cdig:
                continue
            proof = self.load(key)
            public = entry["public_inputs"]
            if isinstance(proof, ProofR1csZk):
                results[key] = verify_r1cs_zk(proof, public, r1cs)
            elif isinstance(proof, ProofR1CS):
                results[key] = verify_r1cs(proof, public, r1cs)
            elif isinstance(proof, SuccinctProofR1CS):
                results[key] = verify_r1cs_succinct(proof, public, r1cs,
                                                    min_params=proof.fri_params)
            elif isinstance(proof, WitnessProofR1CS):
                results[key] = verify_r1cs_witness(proof, public, r1cs,
                                                   min_params=proof.fri_params)
            elif isinstance(proof, CompactProofR1CS):
                results[key] = verify_r1cs_compact(proof, public, r1cs)
            else:
                results[key] = False
        return results

    def missing_statements(self, r1cs: R1CS, publics_and_seeds: Sequence,
                           labels: Optional[Sequence[str]] = None) -> List[int]:
        """Indices not yet proved: the resume point of a batched run."""
        return [i for i, (public, seed) in enumerate(publics_and_seeds)
                if not self.contains(statement_digest(r1cs, public, seed,
                                                      labels[i] if labels else ""))]
