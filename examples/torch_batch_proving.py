"""End-to-end batched proving on the PyTorch / CUDA port.

The port's counterpart of ``examples/batch_proving.py``: builds a 64-gate
circuit over the 45-bit NTT-friendly prime, proves a batch of 8 witnesses
on the card (kernels Q and R; plain and ZK), stores the proofs in a
content-addressed ``ProofStore``, re-verifies everything, and makes one
compact proof on the host.

Run:  python examples/torch_batch_proving.py               (an NVIDIA GPU)
      python examples/torch_batch_proving.py --device cpu  (the kernels' plain
                                                            PyTorch twins)
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import lambda_snark_tpu_torch as ls


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    device = parser.parse_args(argv).device

    q = ls.NTT_FRIENDLY_MODULUS
    m, batch = 64, 8
    r1cs = ls.multiplication_gates_circuit(m, q)
    witnesses = [ls.multiplication_gates_witness(m, q, seed=s) for s in range(batch)]
    params = ls.Params(ls.SecurityLevel.BITS128, ls.Profile.ring_b(n=128, k=2, q=q, sigma=3.19))
    ctx = ls.setup(params, context_seed=1)

    t0 = time.time()
    proofs = ls.prove_r1cs_batched(r1cs, witnesses, ctx, seed=42, device=device)
    elapsed = time.time() - t0
    print(f"proved {batch} statements in {elapsed:.2f}s (m={m} gates each, on {device})")

    store = ls.ProofStore(os.path.join(tempfile.mkdtemp(), "proofs"))
    for i, (w, p) in enumerate(zip(witnesses, proofs)):
        store.save(r1cs, r1cs.public_inputs(w), 42, p, label=str(i))
    results = store.verify_all(r1cs)
    assert len(results) == batch and all(results.values())
    stored_bytes = sum(e["size_bytes"] for e in store._manifest.values())
    print(f"stored + re-verified {len(results)} proofs ({stored_bytes} bytes total)")

    zk = ls.prove_r1cs_batched(r1cs, witnesses[:2], ctx, seed=43, zk=True, device=device)
    zk_ok = all(ls.verify_r1cs_zk(p, r1cs.public_inputs(w), r1cs)
                for w, p in zip(witnesses, zk))
    assert zk_ok
    print(f"zero-knowledge batch verifies: {zk_ok}")

    compact = ls.prove_r1cs_compact(r1cs, witnesses[0], ctx, seed=44)
    compact_ok = ls.verify_r1cs_compact(compact, r1cs.public_inputs(witnesses[0]), r1cs)
    assert compact_ok
    print(f"compact proof: {len(compact.to_bytes())} bytes, verifies={compact_ok}")
    return dict(seconds=elapsed, proofs=[p.to_bytes() for p in proofs],
                zk=[p.to_bytes() for p in zk], compact=compact.to_bytes())


if __name__ == "__main__":
    main()
