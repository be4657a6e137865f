"""The port's counterparts of the repository's ``__graft_entry__``:
``entry()``, the flagship step, the batched device prove stage
(interpolation, odd-coset quotient in kernel Q, Module-LWE commitment in
kernel R), on tiny shapes; and ``dryrun_multichip(n)``, one step of each
product surface over a mesh of n ranks (below).

    fn, args = entry()            # on the card
    q, a, b, c, commitment, valid = fn(*args)

The shapes and data are the JAX entry's: m = 16 multiplication gates over the
44-bit field, ring degree n = 32, k = 2, B = 2 statements whose evaluations
come from ``random.Random(0)``, and the threefry key of seed 0. The
evaluations are (B, m) int64 words where the JAX entry passes digit planes.
"""

from __future__ import annotations

import os
import random
import time

from .commit.lwe import LweContext
from .commit.lwe_device import DeviceCommitContext
from .core.params import NTT_FRIENDLY_MODULUS, Params, Profile, SecurityLevel
from .device import resolve
from .ops import modarith
from .ops.sampler import prng_key
from .pipeline import ProvePlan, prove_stage_batch


def tiny_problem(m: int, n_ring: int, batch: int):
    """(q, context, a, b, c) with (batch, m) evaluations a b = c, as lists."""
    q = NTT_FRIENDLY_MODULUS
    ctx = LweContext(Params(SecurityLevel.BITS128,
                            Profile.ring_b(n=n_ring, k=2, q=q, sigma=3.19)), context_seed=1)
    rng = random.Random(0)
    evs = []
    for _ in range(batch):
        a = [rng.randrange(1, q) for _ in range(m)]
        b = [rng.randrange(1, q) for _ in range(m)]
        evs.append((a, b, [(x * y) % q for x, y in zip(a, b)]))
    return q, ctx, *([e[i] for e in evs] for i in range(3))


def entry(device="cuda"):
    """(fn, example_args): the batched prove stage at m = 16, n = 32, B = 2."""
    dev = resolve(device)
    m, n_ring, batch = 16, 32, 2
    q, ctx, a_e, b_e, c_e = tiny_problem(m, n_ring, batch)
    pp = ProvePlan.create(m, q, DeviceCommitContext.from_host(ctx, dev))

    def fn(a_evals, b_evals, c_evals, key):
        return prove_stage_batch(pp, a_evals, b_evals, c_evals, key)

    return fn, (*(modarith.to_words(x, dev) for x in (a_e, b_e, c_e)), prng_key(0))


# --- the multi-device dry run -------------------------------------------------------


def dryrun_multichip(n_devices: int, device="cuda", backend=None) -> dict:
    """A world of ``n_devices`` ranks on this host (``parallel.multihost.
    spawn_local``) and one step of each product surface on its mesh, the
    legs of JAX's ``__graft_entry__.dryrun_multichip`` (:79-483) with its
    assertions; mesh (2, n/2) for n >= 4, else (1, n):

    (a) the sharded prove step (``ShardedProver``, all_to_all NTTs and an
        all_reduce) at m = ring degree = max(1024, 4 sp^2): the quotient
        equals the host ``R1CS.compute_quotient_poly`` and a (1, 1)-mesh
        run, the commitment a (1, 1) run and the host's recomputation from
        the returned (s, e);
    (b) batched kind 7 bytes == sequential proofs (m = 2^10), and the
        device route == the host route at m = 2^6;
    (c) a ``ShardedProofService`` round with a ``ProofStore`` resume, bytes
        equal to a (1, 1)-mesh service;
    (d) a kind-8 aggregate: deterministic bytes and a wire round trip;
    (e) kind 9 (deterministic bytes, a wire round trip) and the phase-2
        checked proof;
    (f) budget permitting, the sharded step at m = 2^12 against (1, 1).

    Legs (b), (d) and (e) run on rank 0's device, on the port's own routes.
    The (1, 1) references run first, in a world of one. ``DRYRUN_BUDGET_S``
    (default 420) and ``DRYRUN_M`` are read as JAX reads them. Prints one
    line a leg (from rank 0) and returns rank 0's record: the seconds at
    the end of each leg, each rank's kernel launches (``launches``), the
    reference world's (``reference_launches``), and the launches of every
    process of the run summed by (entry, shape, variant) (``shapes``, as
    ``kernels.LAUNCHES`` keys them)."""
    from .parallel.multihost import spawn_local

    dev = resolve(device)
    t0 = time.time()
    budget = float(os.environ.get("DRYRUN_BUDGET_S", "420"))
    if n_devices >= 4:
        dp, sp = 2, n_devices // 2
    else:
        dp, sp = 1, n_devices
    m = int(os.environ.get("DRYRUN_M", "0")) or max(1024, 4 * sp * sp)
    while m & (m - 1):
        m += 1
    m_big = 0 if os.environ.get("DRYRUN_M") else 1 << 12
    ref = spawn_local(1, _dryrun_reference, (m, 2 * dp, m_big, dev.type), backend, dev)[0]
    ranks = spawn_local(n_devices, _dryrun_rank,
                        ((dp, sp), m, m_big, ref, t0, budget, dev.type), backend, dev)
    shapes = {}
    for r in [ref, *ranks]:
        for key, n in r["shapes"].items():
            shapes[key] = shapes.get(key, 0) + n
    record = ranks[0]
    record.update(launches=[r["launches"] for r in ranks], reference_launches=ref["launches"],
                  shapes=shapes)
    print(f"dryrun_multichip ok: mesh=({dp}x{sp}), m={m}, batch={2 * dp}, "
          f"devices={n_devices}, {time.time() - t0:.0f}s", flush=True)
    return record


def _mult_instance(m: int, batch: int, device):
    """JAX's leg (a) instance: (context, circuit, witnesses, evals a, b, c)."""
    from .circuits.examples import multiplication_gates_circuit, multiplication_gates_witness
    from .prover_batched import witness_words

    q = NTT_FRIENDLY_MODULUS
    ctx = LweContext(Params(SecurityLevel.BITS128, Profile.ring_b(n=m, k=2, q=q, sigma=3.19)),
                     context_seed=1)
    r1cs = multiplication_gates_circuit(m, q)
    ws = [multiplication_gates_witness(m, q, seed=s) for s in range(batch)]
    evals = r1cs.constraint_evals_batch(modarith.to_words(witness_words(ws, r1cs.n, q), device))
    return ctx, r1cs, ws, evals


def _dryrun_reference(m: int, batch: int, m_big: int, device_type: str) -> dict:
    """The (1, 1)-mesh runs that legs (a), (c) and (f) compare with, and
    their kernel launches by (entry, shape, variant)."""
    from . import kernels
    from .parallel.mesh import make_mesh, mesh_device
    from .parallel.pipeline_sharded import ShardedProver
    from .parallel.service import ShardedProofService

    kernels.reset_launches()
    mesh1 = make_mesh([1, 1], device=device_type)
    dev = mesh_device(mesh1)
    ctx, r1cs, ws, (a_e, b_e, c_e) = _mult_instance(m, batch, dev)
    prover1 = ShardedProver(m, r1cs.modulus, ctx, mesh1)
    out = prover1.run(a_e, b_e, c_e, seed=7)
    svc = ShardedProofService(r1cs, ctx, mesh1, batch=batch, prover=prover1)
    ref = {"quotient": prover1.coeff_layout_to_flat(out[0]).cpu(),
           "commitment": prover1.coeff_layout_to_flat(out[4]).cpu(),
           "service": {i: p.to_bytes() for i, p in svc.prove_stream(ws, seed=21)}}
    if m_big:
        ctx_b, r1cs_b, _ws, evals_b = _mult_instance(m_big, batch, dev)
        prover_b1 = ShardedProver(m_big, r1cs_b.modulus, ctx_b, mesh1)
        ref["quotient_big"] = prover_b1.coeff_layout_to_flat(
            prover_b1.run(*evals_b, seed=9)[0]).cpu()
    ref.update(launches=kernels.launches(), shapes=dict(kernels.LAUNCHES))
    return ref


def _succinct_instance(m_s: int, n_ws: int):
    """JAX's kind-7/8/9 dry-run instance: m_s squaring gates over
    Goldilocks, public input [1], n_ws witnesses from ``random.Random(3)``."""
    from .core.params import NTT_MODULUS
    from .prover import setup
    from .r1cs.circuit import CircuitBuilder

    gl = NTT_MODULUS
    b = CircuitBuilder(gl)
    b.alloc_var()
    xs = b.alloc_vars(m_s)
    ys = b.alloc_vars(m_s)
    b.set_public_inputs(1)
    for x, y in zip(xs, ys):
        b.mul_gate(x, x, y)
    r1cs = b.build()
    rnd = random.Random(3)
    ws = []
    for _ in range(n_ws):
        vals = [rnd.randrange(gl) for _ in range(m_s)]
        ws.append([1] + vals + [v * v % gl for v in vals])
    ctx = setup(Params(SecurityLevel.BITS128, Profile.ring_b(m_s, 1, gl, 3.19)))
    return r1cs, ws, ctx


def _dryrun_rank(shape, m: int, m_big: int, ref: dict, t0: float, budget: float,
                 device_type: str) -> dict:
    """One rank of the dry run's world: legs (a), (c) and (f) on every rank,
    the checks, the lines and legs (b), (d), (e) on rank 0."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from . import kernels
    from .commit.lwe import _ring_combine
    from .core.params import NTT_MODULUS
    from .parallel.mesh import make_mesh, mesh_device
    from .parallel.pipeline_sharded import ShardedProver
    from .parallel.service import ShardedProofService
    from .proof.aggregate import (
        AggregatedProofR1CS,
        prove_r1cs_succinct_aggregate,
        verify_r1cs_succinct_aggregate,
    )
    from .proof.checks import prove_r1cs_checked, verify_r1cs_checked
    from .proof.fri import FriParams
    from .proof.succinct import _prove_host, prove_r1cs_succinct, verify_r1cs_succinct
    from .proof.succinct_batch import prove_r1cs_succinct_batch
    from .proof.succinct_witness import (
        WitnessProofR1CS,
        prove_r1cs_witness,
        verify_r1cs_witness,
    )
    from .prover import setup
    from .utils.artifacts import ProofStore

    kernels.reset_launches()
    lead = dist.get_rank() == 0
    dp, sp = shape
    batch = 2 * dp
    legs = {}

    def remaining() -> float:
        return budget - (time.time() - t0)

    def done(leg: str, line: str) -> None:
        legs[leg] = time.time() - t0
        if lead:
            print(f"dryrun ({leg}) {line} [{legs[leg]:.0f}s]", flush=True)

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise AssertionError(what)

    mesh = make_mesh([dp, sp], device=device_type)
    dev = mesh_device(mesh)

    # --- (a) the sharded prove step ------------------------------------------------
    ctx, r1cs, ws, (a_e, b_e, c_e) = _mult_instance(m, batch, dev)
    prover = ShardedProver(m, r1cs.modulus, ctx, mesh)
    out = prover.run(a_e, b_e, c_e, seed=7)
    check(bool(out[7].all()), "dryrun witnesses must be valid")
    q_flat = prover.coeff_layout_to_flat(out[0]).cpu()
    c_flat = prover.coeff_layout_to_flat(out[4]).cpu()
    check(tuple(q_flat.shape) == (batch, m), f"quotient shape {tuple(q_flat.shape)}")
    if lead:
        # the host quotient (degree m - 2: m - 1 coefficients, zero-padded)
        for i, w in enumerate(ws):
            want = r1cs.compute_quotient_poly(w)
            got = [int(v) for v in modarith.to_u64(q_flat[i])]
            check(got[:len(want)] == want and not any(got[len(want):]),
                  f"sharded quotient {i} != host golden")
        # the commitment recomputed on the host from the returned (s, e)
        s = prover.coeff_layout_to_flat(out[5]).cpu().numpy().astype(np.int64)
        e = prover.coeff_layout_to_flat(out[6]).cpu().numpy().astype(np.int64)
        host = _ring_combine(ctx, s.transpose(1, 0, 2), e, modarith.to_u64(q_flat))
        check(np.array_equal(host, modarith.to_u64(c_flat)), "commitment != host recompute")
        check(torch.equal(q_flat, ref["quotient"]), "sharded quotient != single-device quotient")
        check(torch.equal(c_flat, ref["commitment"]),
              "sharded commitment != single-device commitment")
    done("a", f"sharded prove ok: mesh=({dp}x{sp}), m={m}, batch={batch}, quotient+commitment "
         "== host golden AND single-device bit-identical")

    fp = FriParams(log_blowup=3, num_queries=8)
    if lead:
        # --- (b) batched kind 7 == sequential; device route == host route --------
        m_host = 1024 if remaining() > 150 else 256
        r1cs_s, ws_s, sctx = _succinct_instance(m_host, 2)
        batch_proofs = prove_r1cs_succinct_batch(r1cs_s, ws_s, sctx, seeds=[7, 8],
                                                 fri_params=fp, device=dev)
        seq = prove_r1cs_succinct(r1cs_s, ws_s[0], sctx, seed=7, fri_params=fp, device=dev)
        check(batch_proofs[0].to_bytes() == seq.to_bytes(),
              f"batched succinct proof != sequential proof bytes (m={m_host})")
        check(verify_r1cs_succinct(batch_proofs[1], [1], r1cs_s, min_params=fp),
              "batched succinct proof does not verify")
        r1cs_d, ws_d, dctx = _succinct_instance(64, 2)
        dev_proofs = prove_r1cs_succinct_batch(r1cs_d, ws_d, dctx, seeds=[7, 8],
                                               fri_params=fp, device=dev)
        host_proofs = [_prove_host(r1cs_d, w, dctx, s_, fp) for w, s_ in zip(ws_d, [7, 8])]
        check([p.to_bytes() for p in dev_proofs] == [p.to_bytes() for p in host_proofs],
              "device-route succinct proofs != host-route bytes (m=2^6)")
    done("b", "batched succinct ok: batch==sequential bytes; device route == host route "
         "bytes at m=2^6")

    # --- (c) the service with a resume, bytes == a (1, 1) service -------------------
    with tempfile.TemporaryDirectory() as td:
        store = ProofStore(os.path.join(td, "store"))
        svc = ShardedProofService(r1cs, ctx, mesh, store=store, batch=batch, prover=prover)
        first = [(i, p.to_bytes()) for i, p in svc.prove_stream(ws, seed=21)]
        svc2 = ShardedProofService(r1cs, ctx, mesh, store=ProofStore(os.path.join(td, "store")),
                                   batch=batch, prover=prover)
        resumed = {i: p.to_bytes() for i, p in svc2.prove_stream(ws, seed=21)}
    if lead:
        check(len(first) == batch, f"{len(first)} service proofs for {batch} witnesses")
        for i, data in first:
            check(resumed[i] == data, f"resume changed proof {i}")
            check(ref["service"][i] == data, f"sharded service proof {i} != single-device")
    done("c", f"service stream ok: {len(first)} proofs, resume + single-device bytes identical")

    if lead:
        # --- (d) a kind-8 aggregate ------------------------------------------------
        r1cs_a, ws_a, actx = _succinct_instance(256, 3)
        agg = prove_r1cs_succinct_aggregate(r1cs_a, ws_a, actx, seeds=[11, 12, 13],
                                            fri_params=fp, device=dev)
        agg2 = prove_r1cs_succinct_aggregate(r1cs_a, ws_a, actx, seeds=[11, 12, 13],
                                             fri_params=fp, device=dev)
        check(agg.to_bytes() == agg2.to_bytes(), "aggregate bytes nondeterministic")
        back = AggregatedProofR1CS.from_bytes(agg.to_bytes())
        check(verify_r1cs_succinct_aggregate(back, [[1]] * 3, r1cs_a, min_params=fp),
              "aggregate verify failed under mesh")
    done("d", "kind-8 aggregate ok: S=3, m=256, deterministic bytes + round-trip verify")

    if lead:
        # --- (e) kind 9 and the revealing phase-2 checks ----------------------------
        r1cs_w, ws_w, wctx = _succinct_instance(256, 1)
        wp = prove_r1cs_witness(r1cs_w, ws_w[0], wctx, seed=5, fri_params=fp, device=dev)
        wp2 = prove_r1cs_witness(r1cs_w, ws_w[0], wctx, seed=5, fri_params=fp, device=dev)
        check(wp.to_bytes() == wp2.to_bytes(), "kind-9 bytes nondeterministic")
        backw = WitnessProofR1CS.from_bytes(wp.to_bytes())
        check(verify_r1cs_witness(backw, [1], r1cs_w, min_params=fp),
              "kind-9 verify failed under mesh")
        # the phase-2 binding LWE-commits the whole witness (n = 513 here)
        wctx2 = setup(Params(SecurityLevel.BITS128, Profile.ring_b(1024, 1, NTT_MODULUS, 3.19)))
        p2_proof, binding = prove_r1cs_checked(r1cs_w, ws_w[0], wctx2, seed=6)
        check(verify_r1cs_checked(p2_proof, binding, [1], r1cs_w, wctx2),
              "phase-2 checked verify failed under mesh")
    done("e", "kind-9 witness + phase-2 ok: deterministic bytes + round-trip verify")

    # --- (f) m = 2^12, budget permitting -------------------------------------------
    go = torch.tensor([int(bool(m_big) and remaining() > 200)], device=dev)
    dist.broadcast(go, src=0)  # rank 0's clock decides for every rank
    if go.item():
        ctx_b, r1cs_b, _ws, evals_b = _mult_instance(m_big, batch, dev)
        prover_b = ShardedProver(m_big, r1cs_b.modulus, ctx_b, mesh)
        qb_flat = prover_b.coeff_layout_to_flat(prover_b.run(*evals_b, seed=9)[0]).cpu()
        check(torch.equal(qb_flat, ref["quotient_big"]), "m=2^12 sharded quotient != single-device")
        done("f", f"m=2^12 sharded leg ok: mesh=({dp}x{sp}) quotient == single-device")
    elif lead:
        print(f"dryrun (f) m=2^12 leg skipped (budget {remaining():.0f}s left)", flush=True)
    return {"legs_s": legs, "launches": kernels.launches(), "shapes": dict(kernels.LAUNCHES)}
