"""Streamed and sharded proving on the PyTorch / CUDA port.

The port's counterpart of ``examples/proof_service.py``, its two serving
shapes:

1. ``prove_r1cs_stream``: proofs of a witness stream in batches on one
   device, each saved to a ``ProofStore`` as it is made;
2. ``ShardedProofService``: the same stream sharded over a (dp, sp) = (2, 2)
   mesh of four ranks, with the store as a resume log: a run over the first
   three statements, then a new service over the same store, which serves
   those three from the store and proves the rest.

The four ranks are processes (``parallel.multihost.spawn_local``). On the
card all four share it over gloo; with ``--device cpu`` they are CPU ranks.
Every rank runs the service on the same witnesses; rank 0 holds the store
and yields the proofs. Each rank reports its kernel launches.

Run:  python examples/torch_proof_service.py               (an NVIDIA GPU)
      python examples/torch_proof_service.py --device cpu  (CPU ranks, the
                                                            kernels' plain twins)
"""

import argparse
import itertools
import os
import random
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import lambda_snark_tpu_torch as ls
from lambda_snark_tpu_torch import kernels
from lambda_snark_tpu_torch.parallel.mesh import make_mesh
from lambda_snark_tpu_torch.parallel.multihost import spawn_local
from lambda_snark_tpu_torch.parallel.service import ShardedProofService

Q = 17592169062401  # 45-bit NTT-friendly prime
M = 64
MESH = (2, 2)
CUT = 3


def build_circuit():
    b = ls.CircuitBuilder(Q)
    b.alloc_var()  # constant-one slot
    xs = [b.alloc_var() for _ in range(M)]
    ys = [b.alloc_var() for _ in range(M)]
    zs = [b.alloc_var() for _ in range(M)]
    b.set_public_inputs(1)
    for x, y, z in zip(xs, ys, zs):
        b.mul_gate(x, y, z)
    return b.build()


def witnesses(count, seed=0):
    rng = random.Random(seed)
    out = []
    for _ in range(count):
        xv = [rng.randrange(1, Q) for _ in range(M)]
        yv = [rng.randrange(1, Q) for _ in range(M)]
        out.append([1] + xv + yv + [(a * b) % Q for a, b in zip(xv, yv)])
    return out


def context():
    params = ls.Params(ls.SecurityLevel.BITS128, ls.Profile.ring_b(n=M, k=2, q=Q, sigma=3.19))
    return ls.setup(params, context_seed=7)


def service_rank(ws, store_dir: str, device: str) -> dict:
    """One rank of the (2, 2) mesh: a run over the first ``CUT`` statements
    into the store, then a resumed run over all of them. Rank 0 returns
    the proofs (index, bytes) of both runs and the store's size between
    them; every rank its launches."""
    import torch.distributed as dist

    r1cs = build_circuit()
    ctx = context()
    mesh = make_mesh(list(MESH), ["dp", "sp"], device=device)
    kernels.reset_launches()
    store = ls.ProofStore(store_dir) if dist.get_rank() == 0 else None
    svc = ShardedProofService(r1cs, ctx, mesh, store=store, batch=2)
    first = [(i, p.to_bytes()) for i, p in svc.prove_stream(itertools.islice(ws, CUT), seed=21)]
    held = len(store.keys()) if store is not None else None
    store = ls.ProofStore(store_dir) if dist.get_rank() == 0 else None
    svc2 = ShardedProofService(r1cs, ctx, mesh, store=store, batch=2, prover=svc.prover)
    resumed = [(i, p.to_bytes()) for i, p in svc2.prove_stream(ws, seed=21)]
    return dict(first=first, held=held, resumed=resumed, launches=kernels.launches())


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    device = parser.parse_args(argv).device

    r1cs = build_circuit()
    ws = witnesses(6)
    ctx = context()

    # 1. streamed proving on one device
    store = ls.ProofStore(tempfile.mkdtemp(prefix="lsnark_svc_"))
    print(f"streaming proofs (one device, {device})...")
    stream = []
    for i, proof in enumerate(ls.prove_r1cs_stream(r1cs, iter(ws[:4]), ctx, seed=11, batch=2,
                                                   store=store, device=device)):
        ok = ls.verify_r1cs(proof, r1cs.public_inputs(ws[i]), r1cs)
        assert ok
        stream.append(proof.to_bytes())
        print(f"  proof {i}: {len(proof.to_bytes())} B, verify={ok}")
    assert len(store.keys()) == 4 and all(store.verify_all(r1cs).values())

    # 2. the sharded service with resume over a fresh store, four ranks
    svc_dir = tempfile.mkdtemp(prefix="lsnark_svc2_")
    print(f"sharded service on a {MESH} mesh of four ranks, first pass over {CUT} "
          "statements...")
    ranks = spawn_local(4, service_rank, (ws, svc_dir, device), device=device,
                        backend="gloo")
    first, resumed = ranks[0]["first"], ranks[0]["resumed"]
    for i, _blob in first:
        print(f"  proved {i}")
    print(f"store then held {ranks[0]['held']} proofs; resumed...")
    assert [i for i, _b in first] == list(range(CUT)) and ranks[0]["held"] == CUT
    assert [i for i, _b in resumed] == list(range(len(ws)))
    assert resumed[:CUT] == first  # served from the store, bytes unchanged
    for i, blob in resumed:
        src = "store" if i < CUT else "proved"
        ok = ls.verify_r1cs(ls.deserialize_any(blob), r1cs.public_inputs(ws[i]), r1cs)
        assert ok
        print(f"  {src} {i}: verify={ok}")
    svc_store = ls.ProofStore(svc_dir)
    assert len(svc_store.keys()) == len(ws) and all(svc_store.verify_all(r1cs).values())
    print(f"done: {len(svc_store.keys())} proofs in {svc_dir}")
    return dict(stream=stream, first=first, resumed=resumed,
                rank_launches=[r["launches"] for r in ranks])


if __name__ == "__main__":
    main()
