"""Deterministic fuzzing harnesses for the untrusted-input surfaces.

The reference lists fuzzing as pending work (``Makefile:fuzz`` →
cargo-fuzz ``fuzz_verify``, "harnesses pending M8-M9", ``README.md:116``);
this module implements it. Three harnesses, all seed-deterministic (every
failure is reproducible from its report line):

- ``fuzz_deserializers``: mutate valid wire bytes (all proof kinds +
  WitnessBinding) with truncation, byte flips, splices and length-field
  corruption. Contract: parsing raises a typed ``LambdaSnarkError`` or
  returns an object that re-serializes without crashing.
- ``fuzz_circuit_parser``: mutate circuit-file JSON structures. Contract:
  ``cli._load_circuit`` returns an R1CS or raises ``InvalidInputError``.
- ``fuzz_verify``: parse mutated proof bytes; when parsing succeeds, run
  the verifier. Contract: never crashes — returns a boolean. Accepts on
  mutated bytes are counted (v1 proofs carry fields the base verifier
  deliberately ignores for reference parity; see SECURITY.md).

The port's copy of the JAX package's ``utils/fuzz.py``: the same mutations,
corpus and counts for the same seed. The corpus's device provers (kinds 7,
8 and 9) take ``device``, which defaults to ``"cuda"`` and raises without a
card unless ``device="cpu"`` is asked for.

Run via ``python -m lambda_snark_tpu_torch fuzz [--iterations N] [--seed S]``.
"""

from __future__ import annotations

import dataclasses
import json
import random
from typing import Callable, List, Optional

from ..core.errors import LambdaSnarkError


@dataclasses.dataclass
class FuzzReport:
    harness: str
    iterations: int
    seed: int
    crashes: List[str]
    parsed_ok: int = 0
    rejected: int = 0
    verify_accepts: int = 0

    @property
    def ok(self) -> bool:
        return not self.crashes

    def summary(self) -> str:
        extra = ""
        if self.harness == "verify":
            extra = f", accepts on mutated bytes: {self.verify_accepts}"
        return (
            f"[{self.harness}] {self.iterations} cases, seed {self.seed}: "
            f"{self.parsed_ok} parsed, {self.rejected} rejected cleanly, "
            f"{len(self.crashes)} CRASHES{extra}"
        )


def _mutate(rng: random.Random, data: bytes) -> bytes:
    """One structured mutation of a byte string."""
    if not data:
        return bytes([rng.randrange(256)])
    choice = rng.randrange(6)
    b = bytearray(data)
    if choice == 0:  # truncate
        return bytes(b[: rng.randrange(len(b))])
    if choice == 1:  # flip random bytes
        for _ in range(rng.randrange(1, 9)):
            b[rng.randrange(len(b))] ^= 1 << rng.randrange(8)
        return bytes(b)
    if choice == 2:  # corrupt an 8-byte aligned word (length fields live here)
        off = 8 * rng.randrange(max(len(b) // 8, 1))
        val = rng.choice([0, 1, 0xFF, 1 << 32, (1 << 64) - 1, len(b) * 2])
        b[off:off + 8] = int(val % (1 << 64)).to_bytes(8, "little")
        return bytes(b)
    if choice == 3:  # splice two regions
        i, j = sorted(rng.randrange(len(b)) for _ in range(2))
        return bytes(b[:i] + b[j:] + b[i:j])
    if choice == 4:  # random garbage of similar length
        return bytes(rng.randrange(256) for _ in range(rng.randrange(1, len(b) + 8)))
    # duplicate-extend
    return bytes(b + b[: rng.randrange(len(b))])


def _proof_corpus(ctx=None, device="cuda"):
    """Valid wire bytes for every proof kind (tiny circuit, fast); kinds 7,
    8 and 9 are proved on ``device``."""
    from .. import (
        CircuitBuilder, Params, Profile, SecurityLevel, prove_r1cs,
        prove_r1cs_zk, prove_simple, setup,
    )
    from ..proof.checks import prove_r1cs_checked
    from ..proof.compact import prove_r1cs_compact

    q = 17592186044417
    b = CircuitBuilder(q)
    _one, x, y, z = (b.alloc_var() for _ in range(4))
    b.set_public_inputs(2)
    b.mul_gate(x, y, z)
    r1cs = b.build()
    witness = [1, 7, 13, 91]
    if ctx is None:
        ctx = setup(
            Params(SecurityLevel.BITS128, Profile.ring_b(64, 1, q, 3.19))
        )
    base = prove_r1cs(r1cs, witness, ctx, seed=1)
    zk = prove_r1cs_zk(r1cs, witness, ctx, seed=2, blinding_seed=3)
    compact = prove_r1cs_compact(r1cs, witness, ctx, seed=4)
    simple = prove_simple(witness, [1, 7], ctx, q, seed=5)
    _p2, binding = prove_r1cs_checked(r1cs, witness, ctx, seed=6)
    corpus = [p.to_bytes() for p in (base, zk, compact, simple)]
    # succinct (kind 7) needs an NTT field + roots domain: tiny q45 circuit
    from ..core.params import NTT_FRIENDLY_MODULUS
    from ..proof.fri import FriParams
    from ..proof.succinct import prove_r1cs_succinct

    b45 = CircuitBuilder(NTT_FRIENDLY_MODULUS)
    for _ in range(4):
        b45.alloc_var()
    b45.set_public_inputs(2)
    b45.mul_gate(1, 2, 3)
    for _ in range(3):  # pad to m=4 (power of two -> roots domain)
        b45.mul_gate(1, 2, 3)
    r45 = b45.build()
    w45 = [1, 7, 13, 91]
    ctx45 = setup(
        Params(
            SecurityLevel.BITS128,
            Profile.ring_b(64, 1, NTT_FRIENDLY_MODULUS, 3.19),
        )
    )
    succinct = prove_r1cs_succinct(
        r45, w45, ctx45, seed=7, fri_params=FriParams(num_queries=4), device=device
    )
    corpus.append(succinct.to_bytes())
    # aggregated (kind 8) needs the Goldilocks roots domain
    from ..core.params import NTT_MODULUS
    from ..proof.aggregate import prove_r1cs_succinct_aggregate

    bgl = CircuitBuilder(NTT_MODULUS)
    for _ in range(4):
        bgl.alloc_var()
    bgl.set_public_inputs(2)
    for _ in range(4):
        bgl.mul_gate(1, 2, 3)
    rgl = bgl.build()
    ctx_gl = setup(
        Params(SecurityLevel.BITS128, Profile.ring_b(64, 1, NTT_MODULUS, 3.19))
    )
    wgl = [1, 7, 13, 91]
    aggregate = prove_r1cs_succinct_aggregate(
        rgl, [wgl, wgl], ctx_gl, [8, 9],
        fri_params=FriParams(num_queries=4), device=device,
    )
    corpus.append(aggregate.to_bytes())
    # committed-witness (kind 9) on the same Goldilocks circuit
    from ..proof.succinct_witness import prove_r1cs_witness

    witness_bound = prove_r1cs_witness(
        rgl, wgl, ctx_gl, seed=10, fri_params=FriParams(num_queries=4), device=device
    )
    corpus.append(witness_bound.to_bytes())
    return r1cs, ctx, corpus, binding.to_bytes(), r45, rgl


def fuzz_deserializers(iterations: int = 2000, seed: int = 0,
                       _corpus=None, device="cuda") -> FuzzReport:
    from ..proof.checks import WitnessBinding
    from ..proof.types import deserialize_any

    rng = random.Random(seed)
    _r1cs, _ctx, corpus, binding_bytes, _r45, _rgl = _corpus or _proof_corpus(device=device)
    rep = FuzzReport("deserializers", iterations, seed, [])
    for i in range(iterations):
        use_binding = rng.randrange(5) == 0
        base = binding_bytes if use_binding else rng.choice(corpus)
        data = _mutate(rng, base)
        try:
            if use_binding:
                obj = WitnessBinding.from_bytes(data)
            else:
                obj = deserialize_any(data)
            obj.to_bytes()  # parse success must round-trip without crashing
            rep.parsed_ok += 1
        except LambdaSnarkError:
            rep.rejected += 1
        except Exception as e:  # noqa: BLE001 — the defect class we hunt
            rep.crashes.append(f"iter {i}: {type(e).__name__}: {e}")
            if len(rep.crashes) >= 10:
                break
    return rep


def _circuit_json_corpus(rng: random.Random) -> dict:
    """One random circuit-file structure, possibly malformed."""
    q = rng.choice([17592186044417, 12289, 0, 1, -5, 2**70])
    m = rng.choice([1, 2, 4, -1, 0, 2**40, "x"])
    n = rng.choice([4, 8, -2, 0, 2**40, None])
    entry = lambda: {
        "row": rng.choice([0, 1, -1, 2**33, "r"]),
        "col": rng.choice([0, 3, -1, 2**33]),
        "value": rng.choice([1, -1, q if isinstance(q, int) else 7, "v", None]),
    }
    data = {
        "m": m, "n": n, "l": rng.choice([1, 2, -1, "l"]),
        "modulus": q,
        "constraints": [
            {s: [entry() for _ in range(rng.randrange(3))] for s in "ABC"}
            for _ in range(rng.randrange(3))
        ],
    }
    # random structural damage
    for _ in range(rng.randrange(3)):
        if data and rng.randrange(2):
            data.pop(rng.choice(list(data)), None)
        else:
            data[rng.choice(["A", "a", "junk", "constraints"])] = rng.choice(
                [None, 3, "s", [], [{"row": 0}]]
            )
    return data


def fuzz_circuit_parser(iterations: int = 1000, seed: int = 0,
                        tmp_dir: Optional[str] = None) -> FuzzReport:
    import os
    import tempfile

    from ..core.errors import InvalidInputError
    from .. import cli

    rng = random.Random(seed)
    rep = FuzzReport("circuit-parser", iterations, seed, [])
    d = tmp_dir or tempfile.mkdtemp(prefix="lsnark_fuzz_")
    path = os.path.join(d, "circuit.json")
    for i in range(iterations):
        data = _circuit_json_corpus(rng)
        with open(path, "w") as f:
            if rng.randrange(10) == 0:
                f.write("{broken json" + "x" * rng.randrange(40))
            else:
                json.dump(data, f, default=str)
        try:
            cli._load_circuit(path)
            rep.parsed_ok += 1
        except InvalidInputError:
            rep.rejected += 1
        except LambdaSnarkError:
            rep.rejected += 1  # typed, acceptable (e.g. dimension errors)
        except Exception as e:  # noqa: BLE001
            rep.crashes.append(
                f"iter {i}: {type(e).__name__}: {e} — {json.dumps(data, default=str)[:200]}"
            )
            if len(rep.crashes) >= 10:
                break
    return rep


def fuzz_verify(iterations: int = 1000, seed: int = 0,
                _corpus=None, device="cuda") -> FuzzReport:
    from ..proof.compact import CompactProofR1CS, verify_r1cs_compact
    from ..proof.succinct import SuccinctProofR1CS, verify_r1cs_succinct
    from ..proof.types import Proof, ProofR1CS, ProofR1csZk, deserialize_any
    from ..verifier import verify_r1cs, verify_r1cs_zk, verify_simple

    rng = random.Random(seed)
    r1cs, _ctx, corpus, _bb, r45, rgl = _corpus or _proof_corpus(device=device)
    public = [1, 7]
    rep = FuzzReport("verify", iterations, seed, [])
    originals = set(corpus)
    for i in range(iterations):
        data = _mutate(rng, rng.choice(corpus))
        try:
            proof = deserialize_any(data)
        except LambdaSnarkError:
            rep.rejected += 1
            continue
        except Exception as e:  # noqa: BLE001
            rep.crashes.append(f"iter {i} parse: {type(e).__name__}: {e}")
            continue
        rep.parsed_ok += 1
        try:
            if isinstance(proof, SuccinctProofR1CS):
                from ..proof.fri import FriParams

                ok = verify_r1cs_succinct(
                    proof, public, r45, min_params=FriParams(num_queries=4)
                )
            elif type(proof).__name__ == "AggregatedProofR1CS":
                from ..proof.aggregate import verify_r1cs_succinct_aggregate
                from ..proof.fri import FriParams

                ok = verify_r1cs_succinct_aggregate(
                    proof, [public] * len(proof.statements), rgl,
                    min_params=FriParams(num_queries=4),
                )
            elif isinstance(proof, CompactProofR1CS):
                ok = verify_r1cs_compact(proof, public, r1cs)
            elif isinstance(proof, ProofR1csZk):
                ok = verify_r1cs_zk(proof, public, r1cs)
            elif isinstance(proof, ProofR1CS):
                ok = verify_r1cs(proof, public, r1cs)
            elif isinstance(proof, Proof):
                ok = verify_simple(proof, public, r1cs.modulus)
            else:
                continue
            if ok and proof.to_bytes() not in originals:
                rep.verify_accepts += 1
        except LambdaSnarkError:
            rep.rejected += 1
        except Exception as e:  # noqa: BLE001
            rep.crashes.append(f"iter {i} verify: {type(e).__name__}: {e}")
            if len(rep.crashes) >= 10:
                break
    return rep


def run_all(iterations: int = 1000, seed: int = 0,
            log: Callable[[str], None] = print, device="cuda") -> bool:
    corpus = _proof_corpus(device=device)
    reports = [
        fuzz_deserializers(2 * iterations, seed, _corpus=corpus),
        fuzz_circuit_parser(iterations, seed),
        fuzz_verify(iterations, seed, _corpus=corpus),
    ]
    ok = True
    for rep in reports:
        log(rep.summary())
        for c in rep.crashes:
            log(f"  CRASH {c}")
        ok = ok and rep.ok
    return ok
