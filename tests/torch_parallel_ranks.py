"""Rank functions for the multi-device tests (``tests/test_torch_parallel.py``,
``test_torch_pipeline_sharded.py``, ``test_torch_service.py``,
``test_torch_imports.py``): a helper module, not a test file.

``parallel.multihost.spawn_local`` starts each rank in a fresh interpreter
that imports the module of the function it runs, so these functions live
here, in a module that imports neither ``jax`` nor ``lambda_snark_tpu``
(a test file would pull JAX into every rank). Each runs on CPU ranks over
gloo and returns plain tensors, numbers and bytes; rank 0's result carries
the outputs, the other ranks' carry what only they can tell.
"""

from __future__ import annotations

import itertools
import sys

import torch
import torch.distributed as dist

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import DomainError, InvalidWitnessError
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.parallel.mesh import make_mesh, ring_mesh
from lambda_snark_tpu_torch.parallel.multihost import spawn_local
from lambda_snark_tpu_torch.parallel.ntt_sharded import ShardedNtt
from lambda_snark_tpu_torch.parallel.pipeline_sharded import ShardedProver
from lambda_snark_tpu_torch.parallel.service import ShardedProofService
from lambda_snark_tpu_torch.prover_batched import witness_words

Q = port.NTT_FRIENDLY_MODULUS


def foreign_modules() -> list:
    """The modules of jax or the JAX package this process has imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                                "lambda_snark_tpu"))


def context(m: int, seed: int = 5):
    """The JAX tests' sharded context: ring n = m, k = 2, sigma = 3.19."""
    return port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=m, k=2, q=Q, sigma=3.19)),
                           context_seed=seed)


def ntt_rank(cases) -> dict:
    """ShardedNtt over the whole world (a ring mesh) for each (q, m, omega,
    a, b) case: the gathered raw eval layout of a, its natural order, the
    round trip of a, and the natural order of the pointwise product of a's
    and b's transforms; and the meshes' shapes and errors."""
    mesh = ring_mesh(device="cpu")
    out = {"foreign": foreign_modules(), "ring": tuple(mesh.shape),
           "ring_names": mesh.mesh_dim_names}
    for q, m, omega, a, b in cases:
        sh = ShardedNtt(m, q, omega, mesh)
        fa = sh.forward(sh.coeff_to_device(a))
        fb = sh.forward(sh.coeff_to_device(b))
        out[q] = dict(raw=sh.gather(fa), natural=sh.eval_layout_to_natural(fa),
                      back=sh.coeff_from_device(sh.inverse(fa)),
                      product=sh.eval_layout_to_natural(sh.pointwise_mul(fa, fb)),
                      layout=sh.eval_layout_to_natural(sh.natural_to_eval_layout(
                          sh.eval_layout_to_natural(fa))),
                      tw=sh.tw_device().shape, r=sh.r, c=sh.c)
    world = dist.get_world_size()
    if world == 4:
        out["grid"] = tuple(make_mesh([2, 2], device="cpu").shape)
        for shape in ([4, 2], [1, 2]):
            try:
                make_mesh(shape, device="cpu")
            except ValueError as exc:
                out[f"error {shape}"] = str(exc)
    return out


def mesh_keywords_rank() -> dict:
    """On a world of 2: ``make_mesh(devices=)`` over the ranks in order
    (and a longer list, of which it takes the first two),
    ``ring_mesh(n_devices=)``, and the keywords' errors."""
    out = {"listed": make_mesh([2], ["sp"], device="cpu", devices=[0, 1]).mesh.tolist(),
           "longer": make_mesh([1, 2], device="cpu", devices=[0, 1, 5]).mesh.tolist(),
           "ring": tuple(ring_mesh(n_devices=2, device="cpu").shape)}
    errors = {}
    for name, fn in (("reversed", lambda: make_mesh([2], ["sp"], device="cpu", devices=[1, 0])),
                     ("short", lambda: make_mesh([2], ["sp"], device="cpu", devices=[0])),
                     ("disagree", lambda: ring_mesh(2, device="cpu", n_devices=1))):
        try:
            fn()
        except ValueError as exc:
            errors[name] = str(exc)
    out["errors"] = errors
    return out


def evals_of(r1cs, witnesses):
    """(3, B, m) constraint evaluations of the witnesses, as int64 words."""
    w = modarith.to_words(witness_words(witnesses, r1cs.n, r1cs.modulus))
    return torch.stack(r1cs.constraint_evals_batch(w))


def sharded_witnesses(m: int):
    """Four multiplication-gate witnesses (seeds 0-3), and the same with
    c_m of witness 1 off by one."""
    ws = [port.multiplication_gates_witness(m, Q, seed=s) for s in range(4)]
    broken = [list(w) for w in ws]
    broken[1][-1] = (broken[1][-1] + 1) % Q
    return ws, broken


def spawn_meshes(m: int, seed: int, meshes) -> dict:
    """(In the test process) ``prover_rank``'s results on each mesh, for the
    batches of ``sharded_witnesses``."""
    r1cs = port.multiplication_gates_circuit(m, Q)
    batches = [evals_of(r1cs, ws) for ws in sharded_witnesses(m)]
    return {shape: spawn_local(shape[0] * shape[1], prover_rank, (shape, m, batches, seed),
                               device="cpu")
            for shape in meshes}


def prover_rank(shape, m: int, batches, seed: int) -> dict:
    """ShardedProver on a ``shape`` mesh, one run for each (3, B, m)
    evaluation batch: rank 0 gets every output, flattened to (.., B, m)."""
    mesh = make_mesh(shape, device="cpu")
    prover = ShardedProver(m, Q, context(m), mesh)
    runs = []
    for evals in batches:
        out = prover.run(*evals, seed)
        runs.append([prover.coeff_layout_to_flat(t) if t.dim() >= 3 else t for t in out])
    return {"foreign": foreign_modules(), "runs": runs if dist.get_rank() == 0 else None,
            "rows": prover.rows, "index": (prover.dp_index, prover.sp_index)}


def service_rank(shape, m: int, witnesses, seed: int, batch: int, store_root=None,
                 cut=None, rank0_store=False) -> dict:
    """ShardedProofService on a ``shape`` mesh: the whole stream; with
    ``store_root``, a run over the first ``cut`` witnesses (a cut stream)
    and then a run over all of them, both with the store (on rank 0 alone
    with ``rank0_store``; the other ranks pass None). Rank 0 gets the
    (index, bytes) of each run; every rank what it yielded."""
    mesh = make_mesh(shape, device="cpu")
    r1cs = port.multiplication_gates_circuit(m, Q)
    ctx = context(m)
    svc = ShardedProofService(r1cs, ctx, mesh, batch=batch)
    runs = [[(i, p.to_bytes()) for i, p in svc.prove_stream(witnesses, seed)]]
    if store_root is not None:
        for ws in (itertools.islice(witnesses, cut), witnesses):
            store = None if rank0_store and dist.get_rank() else port.ProofStore(store_root)
            again = ShardedProofService(r1cs, ctx, mesh, store=store, batch=batch,
                                        prover=svc.prover)
            runs.append([(i, p.to_bytes()) for i, p in again.prove_stream(ws, seed)])
    return {"runs": runs, "batch": svc.batch}


def service_errors_rank(m: int) -> dict:
    """The ShardedProofService's DomainErrors on a (2, 2) mesh, by case, and
    the InvalidWitnessError of a batch with a broken witness (on every rank,
    so no rank waits in a collective)."""
    mesh = make_mesh([2, 2], device="cpu")
    r1cs = port.multiplication_gates_circuit(m, Q)
    ctx = context(m)
    prover = ShardedProver(m, Q, ctx, mesh)
    cases = {
        "default_batch": lambda: ShardedProofService(r1cs, ctx, mesh, prover=prover).batch,
        "batch": lambda: ShardedProofService(r1cs, ctx, mesh, batch=3, prover=prover),
        "domain": lambda: ShardedProofService(
            port.multiplication_gates_circuit(m, Q, domain=port.Domain.sequential(m, Q)), ctx, mesh,
            prover=prover),
        "prover_ctx": lambda: ShardedProofService(r1cs, context(m, seed=6), mesh, prover=prover),
        "prover_axes": lambda: ShardedProofService(r1cs, ctx, mesh, prover=prover,
                                                   dp_axis="sp", sp_axis="dp"),
        "ring_degree": lambda: ShardedProver(m, Q, context(2 * m), mesh),
        "invalid": lambda: list(ShardedProofService(r1cs, ctx, mesh, batch=4, prover=prover)
                                .prove_stream(sharded_witnesses(m)[1], 3)),
    }
    out = {}
    for name, fn in cases.items():
        try:
            out[name] = fn()
        except (DomainError, InvalidWitnessError) as exc:
            out[name] = f"{type(exc).__name__}: {exc}"
    return out


def modules_rank() -> list:
    """What a spawned rank has imported of jax and the JAX package."""
    return foreign_modules()
