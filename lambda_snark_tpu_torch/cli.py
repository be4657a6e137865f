"""Command-line interface of the PyTorch / CUDA port.

    python -m lambda_snark_tpu_torch [--device cuda|cpu] <command> ...

The JAX package's command line (``lambda_snark_tpu/cli.py``), with the same
subcommands, flags, defaults, file formats, output lines (timings apart)
and exit codes: 0; 1 on REJECT; 2 on a ``LambdaSnarkError``. Subcommand
parity with the reference CLI (``lambda-snark-cli/src/main.rs:14-111``):
setup / prove / verify / info / r1cs-example / range-proof-example /
benchmark / healthcare-example, plus prove-stream, lean-export, dudect,
fuzz and validate-params.

One global option more, ``--device`` (default ``cuda``), goes to every call
that takes a device: ``prove --succinct``, ``prove --witness-bind``,
``prove-stream`` and ``fuzz``'s corpus. Without a card those raise "no CUDA
device" unless ``--device cpu`` is given; the host golden path (``prove``
with no mode flag, ``--zk``, ``--compact``, ``--phase2``) runs on the host
either way.

Circuit files use a JSON schema compatible with the reference test-vector
``constraints.json`` shape (COO entries, signed values).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, Optional

from . import (
    LEGACY_MODULUS,
    Params,
    Profile,
    SecurityLevel,
    deserialize_any,
    prove_r1cs,
    prove_r1cs_zk,
    setup,
    verify_r1cs,
    verify_r1cs_zk,
)
from .core.errors import LambdaSnarkError
from .proof.types import ProofR1CS, ProofR1csZk
from .r1cs.r1cs import R1CS
from .r1cs.sparse import SparseMatrix

DEFAULT_MODULUS = LEGACY_MODULUS  # prime CLI modulus (main.rs:235)
#: the reference checkout's root; healthcare-example regenerates the
#: forking-certificate data from its formal/tests when it is set
REFERENCE_ENV = "LAMBDA_SNARK_REFERENCE"


def _default_params(q: int, n: int = 4096, k: int = 2, sigma: float = 3.19) -> Params:
    return Params(SecurityLevel.BITS128, Profile.ring_b(n=n, k=k, q=q, sigma=sigma))


_MAX_CIRCUIT_DIM = 1 << 26  # allocation guard for untrusted circuit files


def _load_circuit(path: str) -> R1CS:
    """Parse a circuit JSON file; malformed input raises InvalidInputError
    (typed, never a raw KeyError/TypeError — the file is untrusted)."""
    from .core.errors import InvalidInputError, LambdaSnarkError

    try:
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise InvalidInputError("circuit file must be a JSON object")
        q = int(data.get("modulus", DEFAULT_MODULUS))
        m, n, l = int(data["m"]), int(data["n"]), int(data.get("l", 1))
        if not (0 < m <= _MAX_CIRCUIT_DIM and 0 < n <= _MAX_CIRCUIT_DIM):
            raise InvalidInputError(f"circuit dims out of range: m={m} n={n}")
        if q < 2:
            raise InvalidInputError(f"modulus out of range: {q}")
        mats = {}
        if "constraints" in data:
            for side in "ABC":
                entries = {}
                for con in data["constraints"]:
                    for e in con.get(side, []):
                        entries[(int(e["row"]), int(e["col"]))] = (
                            int(e["value"]) % q
                        )
                mats[side] = SparseMatrix.from_map(m, n, entries)
        else:
            for side in "ABC":
                entries = {
                    (int(e["row"]), int(e["col"])): int(e["value"]) % q
                    for e in data[side.lower()]
                }
                mats[side] = SparseMatrix.from_map(m, n, entries)
        return R1CS(m=m, n=n, l=l, a=mats["A"], b=mats["B"], c=mats["C"],
                    modulus=q)
    except LambdaSnarkError:
        raise
    except (KeyError, TypeError, ValueError, AttributeError,
            json.JSONDecodeError) as e:
        raise InvalidInputError(f"malformed circuit file: {e!r}") from e


def _load_witness(path: str) -> List[int]:
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("witness") or data.get("z")
    return [int(v) for v in data]


def cmd_info(args) -> int:
    import torch

    from . import __version__
    from .core.params import (
        LEGACY_COMPOSITE_MODULUS,
        NTT_FRIENDLY_MODULUS,
        NTT_MODULUS,
    )

    print(f"lambda-snark-tpu-torch {__version__}")
    print("lattice-SNARK prover, PyTorch with CUDA kernels for NVIDIA Hopper (sm_90a)")
    print()
    print("Canonical moduli:")
    print(f"  legacy (composite, tv-0/1/2):  {LEGACY_COMPOSITE_MODULUS}")
    print(f"  legacy prime (CLI default):    {LEGACY_MODULUS}")
    print(f"  45-bit NTT-friendly:           {NTT_FRIENDLY_MODULUS}  (m <= 2^13)")
    print(f"  Goldilocks:                    {NTT_MODULUS}  (m <= 2^32)")
    print()
    if torch.cuda.is_available():
        print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, devices: "
              f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    else:
        print(f"torch {torch.__version__}, CUDA unavailable")
    from . import native_bridge

    print(f"native library: {'available' if native_bridge.available() else 'not built'}")
    return 0


def cmd_r1cs_example(args) -> int:
    from .circuits.examples import multiplication_circuit

    q = args.modulus
    print(f"R1CS example: prove knowledge of factors of 91 (mod {q})")
    t0 = time.time()
    r1cs, witness = multiplication_circuit(q)
    build_ms = (time.time() - t0) * 1e3
    assert r1cs.is_satisfied(witness)
    ctx = setup(_default_params(q, n=args.ring_degree))
    t0 = time.time()
    proof = prove_r1cs(r1cs, witness, ctx, seed=args.seed)
    prove_ms = (time.time() - t0) * 1e3
    public = r1cs.public_inputs(witness)
    t0 = time.time()
    ok = verify_r1cs(proof, public, r1cs)
    verify_ms = (time.time() - t0) * 1e3
    print(f"  circuit build: {build_ms:.2f} ms")
    print(f"  prove:         {prove_ms:.2f} ms")
    print(f"  verify:        {verify_ms:.2f} ms -> {'ACCEPT' if ok else 'REJECT'}")
    print(f"  proof size:    {len(proof.to_bytes())} bytes")
    return 0 if ok else 1


def cmd_range_proof_example(args) -> int:
    from .circuits.examples import range_proof_circuit, range_proof_witness

    q = args.modulus
    value, bits = args.value, args.bits
    print(f"Range proof: 0 <= {value} < 2^{bits} (mod {q})")
    r1cs = range_proof_circuit(q, bits=bits)
    witness = range_proof_witness(q, value, bits=bits)
    assert r1cs.is_satisfied(witness)
    ctx = setup(_default_params(q, n=args.ring_degree))
    t0 = time.time()
    proof = prove_r1cs_zk(r1cs, witness, ctx, seed=args.seed, blinding_seed=args.seed)
    prove_ms = (time.time() - t0) * 1e3
    ok = verify_r1cs_zk(proof, r1cs.public_inputs(witness), r1cs)
    print(f"  prove (zk): {prove_ms:.2f} ms, verify -> {'ACCEPT' if ok else 'REJECT'}")
    return 0 if ok else 1


def cmd_healthcare_example(args) -> int:
    from .circuits.healthcare import (
        build_healthcare_circuit,
        high_risk_witness,
        low_risk_witness,
    )
    from .lean import export as lean_export

    q = args.modulus
    print(f"Healthcare diagnosis circuit (mod {q})")
    r1cs = build_healthcare_circuit(q)
    ctx = setup(_default_params(q, n=args.ring_degree))
    for label, witness in (
        ("high-risk", high_risk_witness(q)),
        ("low-risk", low_risk_witness(q)),
    ):
        assert r1cs.is_satisfied(witness)
        proof = prove_r1cs_zk(r1cs, witness, ctx, seed=args.seed, blinding_seed=args.seed)
        ok = verify_r1cs_zk(proof, r1cs.public_inputs(witness), r1cs)
        print(f"  {label}: risk={witness[1]}, verify -> {'ACCEPT' if ok else 'REJECT'}")
        if not ok:
            return 1
    # Lean artifacts (reference run_example writes artifacts/r1cs/healthcare.term)
    out_dir = args.artifacts
    lean_export.write_artifact(
        f"{out_dir}/r1cs/healthcare.term", lean_export.vk_to_lean(r1cs)
    )
    witness = high_risk_witness(q)
    q_coeffs = r1cs.compute_quotient_poly(witness)
    lean_export.write_artifact(
        f"{out_dir}/r1cs/healthcare_quotient.json",
        lean_export.quotient_dump_json(
            r1cs, witness, q_coeffs, description="healthcare high-risk quotient"
        ),
    )
    # reference-format dump at the Lean certificate modulus (2013265921):
    # reproduces formal/tests/HealthcareQuotient.lean's golden coefficients
    hc_q = 2013265921
    hc_r1cs = build_healthcare_circuit(hc_q)
    hc_qc = hc_r1cs.compute_quotient_poly(high_risk_witness(hc_q))
    lean_export.write_artifact(
        f"{out_dir}/r1cs/healthcare_quotient_lean.json",
        lean_export.quotient_dump_reference_format(hc_q, hc_qc),
    )
    # Lean certificate data files (reference: formal/tests/*.lean — the
    # circuit, witness-data and forking-example certificates regenerate from
    # this stack; parse+match pinned in tests/test_certificates.py)
    from .lean import certificates as _certs

    hc_wit = high_risk_witness(hc_q)
    lean_export.write_artifact(
        f"{out_dir}/lean/HealthcareCircuitData.lean",
        _certs.certificate_data_lean(hc_r1cs, hc_wit),
    )
    lean_export.write_artifact(
        f"{out_dir}/lean/HealthcareWitnessData.lean",
        _certs.witness_data_lean(hc_r1cs, hc_wit),
    )
    ref_forking = os.path.join(os.environ.get(REFERENCE_ENV, ""), "formal", "tests",
                               "ForkingCertificateExample.lean")
    if os.environ.get(REFERENCE_ENV) and os.path.exists(ref_forking):
        with open(ref_forking) as f:
            fork_data = _certs.parse_forking_example(f.read())
        lean_export.write_artifact(
            f"{out_dir}/lean/ForkingCertificateData.lean",
            _certs.forking_example_data_lean(fork_data),
        )
    print(f"  lean artifacts written under {out_dir}/r1cs/ and {out_dir}/lean/")
    return 0


def cmd_benchmark(args) -> int:
    from .circuits.examples import (
        multiplication_gates_circuit,
        multiplication_gates_witness,
    )

    q = args.modulus
    sizes = [int(s) for s in args.sizes.split(",")]
    ctx = setup(_default_params(q, n=args.ring_degree))
    rows = []
    if args.compare_zk:
        print(f"{'m':>6} {'plain ms':>10} {'zk ms':>10} {'overhead':>9}")
        from .circuits.examples import (
            multiplication_gates_circuit as _mgc,
            multiplication_gates_witness as _mgw,
        )
        for m in sizes:
            r1cs = _mgc(m, q)
            witness = _mgw(m, q, seed=42)
            t0 = time.time()
            p1 = prove_r1cs(r1cs, witness, ctx, seed=args.seed)
            plain_ms = (time.time() - t0) * 1e3
            t0 = time.time()
            p2 = prove_r1cs_zk(r1cs, witness, ctx, seed=args.seed,
                               blinding_seed=args.seed)
            zk_ms = (time.time() - t0) * 1e3
            public = r1cs.public_inputs(witness)
            assert verify_r1cs(p1, public, r1cs)
            assert verify_r1cs_zk(p2, public, r1cs)
            ratio = zk_ms / plain_ms if plain_ms > 0 else float("inf")
            print(f"{m:>6} {plain_ms:>10.2f} {zk_ms:>10.2f} {ratio:>8.3f}x")
        return 0
    print(f"{'m':>6} {'build ms':>10} {'prove ms':>10} {'verify ms':>10} {'proof B':>8}")
    for m in sizes:
        t0 = time.time()
        r1cs = multiplication_gates_circuit(m, q)
        build_ms = (time.time() - t0) * 1e3
        witness = multiplication_gates_witness(m, q, seed=42)
        t0 = time.time()
        if args.zk:
            proof = prove_r1cs_zk(r1cs, witness, ctx, seed=args.seed,
                                  blinding_seed=args.seed)
        else:
            proof = prove_r1cs(r1cs, witness, ctx, seed=args.seed)
        prove_ms = (time.time() - t0) * 1e3
        public = r1cs.public_inputs(witness)
        t0 = time.time()
        ok = (verify_r1cs_zk(proof, public, r1cs) if args.zk
              else verify_r1cs(proof, public, r1cs))
        verify_ms = (time.time() - t0) * 1e3
        assert ok
        size = len(proof.to_bytes())
        rows.append((m, prove_ms))
        print(f"{m:>6} {build_ms:>10.2f} {prove_ms:>10.2f} {verify_ms:>10.2f} {size:>8}")
    if len(rows) >= 2:
        # empirical scaling exponent (reference main.rs:602-748 analysis)
        (m0, t0_), (m1, t1_) = rows[0], rows[-1]
        if t0_ > 0 and m1 > m0:
            exponent = math.log(t1_ / t0_) / math.log(m1 / m0)
            print(f"empirical scaling exponent: {exponent:.2f}")
    return 0


def cmd_setup(args) -> int:
    params = _default_params(args.modulus, n=args.ring_degree, k=args.rank,
                             sigma=args.sigma)
    params.validate()
    if args.strict:
        params.validate_strict()
    descriptor = {
        "profile": "ring_b",
        "n": args.ring_degree,
        "k": args.rank,
        "q": args.modulus,
        "sigma": args.sigma,
        "security": 128,
        "context_seed": args.context_seed,
    }
    with open(args.out, "w") as f:
        json.dump(descriptor, f, indent=2)
    print(f"context descriptor written to {args.out}")
    return 0


def _ctx_from_descriptor(path: Optional[str], q: int, n: int):
    if path:
        with open(path) as f:
            d = json.load(f)
        params = _default_params(d["q"], n=d["n"], k=d["k"], sigma=d["sigma"])
        return setup(params, context_seed=d.get("context_seed", 0))
    return setup(_default_params(q, n=n))


def cmd_prove(args) -> int:
    r1cs = _load_circuit(args.circuit)
    witness = _load_witness(args.witness)
    ctx = _ctx_from_descriptor(args.context, r1cs.modulus, args.ring_degree)
    t0 = time.time()
    if getattr(args, "witness_bind", False):
        from .proof.succinct_witness import prove_r1cs_witness

        proof = prove_r1cs_witness(
            r1cs, witness, ctx, seed=args.seed, zk=args.zk,
            blinding_seed=args.blinding_seed, device=args.device,
        )
    elif getattr(args, "succinct", False):
        from .proof.succinct import prove_r1cs_succinct

        proof = prove_r1cs_succinct(
            r1cs, witness, ctx, seed=args.seed, zk=args.zk,
            blinding_seed=args.blinding_seed, device=args.device,
        )
    elif args.compact:
        from .proof.compact import prove_r1cs_compact

        proof = prove_r1cs_compact(
            r1cs, witness, ctx, seed=args.seed,
            blinding_seed=args.blinding_seed, zk=args.zk,
        )
    elif args.zk:
        proof = prove_r1cs_zk(r1cs, witness, ctx, seed=args.seed,
                              blinding_seed=args.blinding_seed)
    elif getattr(args, "phase2", False):
        from .proof.checks import prove_r1cs_checked

        proof, binding = prove_r1cs_checked(r1cs, witness, ctx, seed=args.seed)
        with open(args.out + ".witness-binding", "wb") as f:
            f.write(binding.to_bytes())
    else:
        proof = prove_r1cs(r1cs, witness, ctx, seed=args.seed,
                           bind_circuit=getattr(args, "bind_circuit", False))
    elapsed = (time.time() - t0) * 1e3
    data = proof.to_bytes()
    with open(args.out, "wb") as f:
        f.write(data)
    print(f"proof written to {args.out} ({len(data)} bytes, {elapsed:.2f} ms)")
    if getattr(args, "phase2", False) and not args.zk and not args.compact:
        print(f"phase-2 witness binding written to {args.out}.witness-binding")
    return 0


def _load_witnesses(path: str) -> List[List[int]]:
    """Witness-stream file: a JSON list of witness vectors (or
    ``{"witnesses": [...]}``)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("witnesses")
    return [[int(v) for v in w] for w in data]


def cmd_prove_stream(args) -> int:
    r1cs = _load_circuit(args.circuit)
    witnesses = _load_witnesses(args.witnesses)
    ctx = _ctx_from_descriptor(args.context, r1cs.modulus, args.ring_degree)
    store = None
    if args.store:
        from .utils.artifacts import ProofStore

        store = ProofStore(args.store)
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
    t0 = time.time()
    total = 0
    count = 0
    if args.succinct:
        from .proof.succinct_batch import prove_r1cs_succinct_stream

        stream = prove_r1cs_succinct_stream(
            r1cs, witnesses, ctx, seed=args.seed, batch=args.batch,
            zk=args.zk, blinding_seed=args.blinding_seed, store=store,
            pipeline_chunk=args.pipeline_chunk, device=args.device,
        )
    else:
        from .prover_batched import prove_r1cs_stream

        stream = enumerate(
            prove_r1cs_stream(
                r1cs, witnesses, ctx, seed=args.seed, batch=args.batch,
                zk=args.zk, blinding_seed=args.blinding_seed, store=store,
                device=args.device,
            )
        )
    for index, proof in stream:
        data = proof.to_bytes()
        total += len(data)
        count += 1
        if args.out_dir:
            with open(os.path.join(args.out_dir, f"{index}.proof"), "wb") as f:
                f.write(data)
    elapsed = time.time() - t0
    rate = count / elapsed if elapsed > 0 else float("inf")
    kind = "succinct" if args.succinct else ("zk" if args.zk else "base")
    print(
        f"proved {count} statements ({kind}, batch={args.batch}) in "
        f"{elapsed*1e3:.1f} ms = {rate:.1f} proofs/s, {total} proof bytes"
        + (f"; store: {args.store}" if args.store else "")
        + (f"; proofs in {args.out_dir}" if args.out_dir else "")
    )
    return 0


def cmd_verify(args) -> int:
    r1cs = _load_circuit(args.circuit)
    with open(args.proof, "rb") as f:
        proof = deserialize_any(f.read())
    public = [int(v) for v in args.public.split(",")]
    t0 = time.time()
    from .proof.compact import CompactProofR1CS, verify_r1cs_compact

    from .proof.succinct import SuccinctProofR1CS, verify_r1cs_succinct
    from .proof.succinct_witness import WitnessProofR1CS, verify_r1cs_witness

    if isinstance(proof, WitnessProofR1CS):
        ok = verify_r1cs_witness(proof, public, r1cs)
    elif isinstance(proof, SuccinctProofR1CS):
        ok = verify_r1cs_succinct(proof, public, r1cs)
    elif isinstance(proof, CompactProofR1CS):
        ok = verify_r1cs_compact(proof, public, r1cs)
    elif isinstance(proof, ProofR1csZk):
        ok = verify_r1cs_zk(proof, public, r1cs)
    elif isinstance(proof, ProofR1CS):
        binding_path = args.proof + ".witness-binding"
        if getattr(args, "phase2", False):
            from .proof.checks import WitnessBinding, verify_r1cs_checked

            ctx = _ctx_from_descriptor(args.context, r1cs.modulus,
                                       args.ring_degree)
            with open(binding_path, "rb") as f:
                binding = WitnessBinding.from_bytes(f.read())
            ok = verify_r1cs_checked(proof, binding, public, r1cs, ctx)
        else:
            ok = verify_r1cs(proof, public, r1cs)
    else:
        print("unsupported proof kind for R1CS verification", file=sys.stderr)
        return 2
    elapsed = (time.time() - t0) * 1e3
    print(f"verify: {'ACCEPT' if ok else 'REJECT'} ({elapsed:.2f} ms)")
    return 0 if ok else 1


def cmd_lean_export(args) -> int:
    from .lean import export as lean_export

    r1cs = _load_circuit(args.circuit)
    term = lean_export.vk_to_lean(r1cs)
    if args.out:
        lean_export.write_artifact(args.out, term)
        print(f"VK term written to {args.out}")
    else:
        print(term)
    return 0


def cmd_dudect(args) -> int:
    from .utils.dudect import gaussian_timing_report, mod_pow_timing_report

    p1 = mod_pow_timing_report(args.modulus, samples=args.samples, out_dir=args.out)
    p2 = gaussian_timing_report(samples=max(args.samples // 2, 200), out_dir=args.out)
    print(f"reports written: {p1}, {p2}")
    return 0


def cmd_fuzz(args) -> int:
    """Deterministic fuzz campaign over deserializers, circuit parser and
    verifier (the reference's pending cargo-fuzz ``fuzz_verify`` target,
    implemented)."""
    from .utils.fuzz import run_all

    ok = run_all(iterations=args.iterations, seed=args.seed, device=args.device)
    print("fuzz: OK" if ok else "fuzz: CRASHES FOUND")
    return 0 if ok else 1


def cmd_validate_params(args) -> int:
    from .lean.params_io import SecurityParams, validate_params

    params = SecurityParams.from_lean(args.lean)
    validate_params(params)
    print(f"params valid: {params.to_lean()}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lambda-snark-tpu-torch",
        description="lattice SNARK prover/verifier (PyTorch, CUDA kernels for NVIDIA Hopper)",
    )
    p.add_argument("--device", default="cuda",
                   help="device of the card-backed provers (default cuda; cpu runs "
                        "every kernel as its plain PyTorch twin)")
    p.add_argument("--modulus", type=int, default=DEFAULT_MODULUS)
    p.add_argument("--ring-degree", type=int, default=1024,
                   help="commitment ring degree n (production: 4096)")
    p.add_argument("--seed", type=lambda s: int(s, 0), default=0x1234)
    sub = p.add_subparsers(dest="command", required=True)

    sub.add_parser("info", help="framework + device info").set_defaults(fn=cmd_info)
    sub.add_parser("r1cs-example", help="7 x 13 = 91 walkthrough").set_defaults(
        fn=cmd_r1cs_example
    )

    rp = sub.add_parser("range-proof-example", help="bit-decomposition range proof")
    rp.add_argument("--value", type=int, default=42)
    rp.add_argument("--bits", type=int, default=8)
    rp.set_defaults(fn=cmd_range_proof_example)

    hc = sub.add_parser("healthcare-example", help="healthcare risk circuit + lean export")
    hc.add_argument("--artifacts", default="artifacts")
    hc.set_defaults(fn=cmd_healthcare_example)

    bm = sub.add_parser("benchmark", help="prove/verify scaling table")
    bm.add_argument("--sizes", default="10,20,30")
    bm.add_argument("--zk", action="store_true")
    bm.add_argument("--compare-zk", action="store_true",
                    help="report the ZK/plain overhead ratio per size")
    bm.set_defaults(fn=cmd_benchmark)

    st = sub.add_parser("setup", help="write a context descriptor")
    st.add_argument("--rank", type=int, default=2)
    st.add_argument("--sigma", type=float, default=3.19)
    st.add_argument("--context-seed", type=lambda s: int(s, 0), default=0)
    st.add_argument("--strict", action="store_true",
                    help="require a prime modulus (VULN-001 guard)")
    st.add_argument("--out", default="context.json")
    st.set_defaults(fn=cmd_setup)

    pv = sub.add_parser("prove", help="prove a circuit file")
    pv.add_argument("--circuit", required=True)
    pv.add_argument("--witness", required=True)
    pv.add_argument("--context")
    pv.add_argument("--zk", action="store_true")
    pv.add_argument("--succinct", action="store_true",
                    help="FRI-bound openings: non-revealing, binding for all "
                         "claimed evaluations (NTT fields only); combine with "
                         "--zk for vanishing-mask hiding")
    pv.add_argument("--compact", action="store_true",
                    help="193/201-byte digest-bound proof")
    pv.add_argument("--blinding-seed", type=lambda s: int(s, 0), default=None)
    pv.add_argument("--bind-circuit", action="store_true",
                    help="v3 transcript: hash the circuit digest into the "
                         "challenges (closes v1 cross-circuit malleability)")
    pv.add_argument("--witness-bind", action="store_true",
                    help="kind-9 committed-witness succinct proof: "
                         "lincheck/mulcheck bound to a hidden z (add --zk "
                         "for vanishing-mask hiding)")
    pv.add_argument("--phase2", action="store_true",
                    help="attach the committed-witness lincheck/mulcheck "
                         "binding (non-ZK; writes <out>.witness-binding)")
    pv.add_argument("--out", default="proof.bin")
    pv.set_defaults(fn=cmd_prove)

    ps = sub.add_parser(
        "prove-stream",
        help="prove a witness stream in device-amortized batches "
             "(resume-safe with --store)",
    )
    ps.add_argument("--circuit", required=True)
    ps.add_argument("--witnesses", required=True,
                    help="JSON list of witness vectors")
    ps.add_argument("--context")
    ps.add_argument("--batch", type=int, default=8)
    ps.add_argument("--pipeline-chunk", type=int, default=None,
                    help="software-pipeline succinct batches in chunks of "
                         "this many statements (overlaps transfers with "
                         "device compute; byte-identical)")
    ps.add_argument("--succinct", action="store_true",
                    help="FRI-bound succinct proofs (NTT fields only)")
    ps.add_argument("--zk", action="store_true")
    ps.add_argument("--blinding-seed", type=lambda s: int(s, 0), default=None)
    ps.add_argument("--store", default=None,
                    help="ProofStore directory (resume log)")
    ps.add_argument("--out-dir", default=None,
                    help="also write each proof as <index>.proof")
    ps.set_defaults(fn=cmd_prove_stream)

    vf = sub.add_parser("verify", help="verify a proof file")
    vf.add_argument("--circuit", required=True)
    vf.add_argument("--proof", required=True)
    vf.add_argument("--public", required=True, help="comma-separated public inputs")
    vf.add_argument("--phase2", action="store_true",
                    help="also verify <proof>.witness-binding "
                         "(lincheck + mulcheck + LWE binding)")
    vf.add_argument("--context", help="context descriptor for --phase2")
    vf.set_defaults(fn=cmd_verify)

    le = sub.add_parser("lean-export", help="emit the Lean VK term")
    le.add_argument("--circuit", required=True)
    le.add_argument("--out")
    le.set_defaults(fn=cmd_lean_export)

    dd = sub.add_parser("dudect", help="regenerate constant-time timing reports")
    dd.add_argument("--out", default="artifacts/dudect")
    dd.add_argument("--samples", type=int, default=3000)
    dd.set_defaults(fn=cmd_dudect)

    fz = sub.add_parser("fuzz", help="fuzz deserializers/parser/verifier")
    fz.add_argument("--iterations", type=int, default=2000)
    fz.add_argument("--seed", type=lambda s: int(s, 0), default=0)
    fz.set_defaults(fn=cmd_fuzz)

    vp = sub.add_parser("validate-params", help="validate a Lean params record")
    vp.add_argument("--lean", required=True)
    vp.set_defaults(fn=cmd_validate_params)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except LambdaSnarkError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
