"""Succinct FRI-bound openings on the PyTorch / CUDA port.

The port's counterpart of ``examples/succinct_openings.py``: the three
opening modes side by side on one circuit (m = 1024 multiplication gates
over Goldilocks, ring n = 4096, k = 2):

1. base proof       evaluations claimed on faith (the host golden path),
2. succinct proof   every claimed evaluation bound to a Merkle-committed
                    low-degree polynomial by a 30-query FRI proximity test
                    (kind 7 on the card: kernels Q, R, T, K, S and F),
3. succinct ZK      vanishing masks on top, so even the authenticated
                    codeword spots are uniform.

Run:  python examples/torch_succinct_openings.py               (an NVIDIA GPU)
      python examples/torch_succinct_openings.py --device cpu  (the kernels'
                                                                plain twins)
"""

import argparse
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import lambda_snark_tpu_torch as ls


def build_circuit(m, q):
    builder = ls.CircuitBuilder(q)
    builder.alloc_var()  # the constant-one wire
    a = builder.alloc_vars(m)
    b = builder.alloc_vars(m)
    c = builder.alloc_vars(m)
    builder.set_public_inputs(1)
    for i in range(m):
        builder.mul_gate(a[i], b[i], c[i])
    return builder.build()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    device = parser.parse_args(argv).device

    q = ls.NTT_MODULUS  # Goldilocks: the roots domain, the device route
    m = 1024
    r1cs = build_circuit(m, q)
    rng = random.Random(2026)
    xs = [rng.randrange(1, q) for _ in range(m)]
    ys = [rng.randrange(1, q) for _ in range(m)]
    witness = [1] + xs + ys + [(x * y) % q for x, y in zip(xs, ys)]
    public = r1cs.public_inputs(witness)

    ctx = ls.setup(ls.Params(ls.SecurityLevel.BITS128, ls.Profile.ring_b(4096, 2, q, 3.19)))

    t0 = time.time()
    base = ls.prove_r1cs(r1cs, witness, ctx, seed=7)
    t_base = time.time() - t0
    assert ls.verify_r1cs(base, public, r1cs)
    print(f"base proof      {len(base.to_bytes()):>8} B  prove {t_base * 1e3:8.1f} ms  "
          "(evaluations claimed, not bound)")

    t0 = time.time()
    succ = ls.prove_r1cs_succinct(r1cs, witness, ctx, seed=7, device=device)
    t_succ = time.time() - t0
    t0 = time.time()
    assert ls.verify_r1cs_succinct(succ, public, r1cs)
    t_ver = time.time() - t0
    print(f"succinct proof  {len(succ.to_bytes()):>8} B  prove {t_succ * 1e3:8.1f} ms  "
          f"verify {t_ver * 1e3:.1f} ms  (all 4 evaluations FRI-bound, on {device})")

    t0 = time.time()
    zk = ls.prove_r1cs_succinct(r1cs, witness, ctx, seed=7, zk=True, blinding_seed=11,
                                device=device)
    t_zk = time.time() - t0
    assert ls.verify_r1cs_succinct(zk, public, r1cs)
    print(f"succinct ZK     {len(zk.to_bytes()):>8} B  prove {t_zk * 1e3:8.1f} ms  "
          f"(vanishing masks, mask_len={zk.mask_len})")

    # the succinct proof carries Merkle roots and spot checks, never Q itself
    q_coeffs = r1cs.compute_quotient_poly(witness)
    needle = b"".join(int(c).to_bytes(8, "little") for c in q_coeffs[:4])
    assert needle not in succ.to_bytes()
    print("quotient polynomial does not appear in the succinct wire bytes - OK")
    return dict(seconds=dict(base=t_base, succinct=t_succ, verify=t_ver, zk=t_zk),
                base=base.to_bytes(), succinct=succ.to_bytes(), zk=zk.to_bytes())


if __name__ == "__main__":
    main()
