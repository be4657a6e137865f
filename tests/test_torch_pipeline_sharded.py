"""The port's sharded prove step (``parallel.pipeline_sharded.ShardedProver``)
against the JAX package's, on the CPU.

At M = 64 multiplication gates over the 44-bit field, ring n = M, k = 2,
context seed 5, four witnesses and seed 17 (JAX's
``tests/test_pipeline_sharded.py``), the port's step on meshes (1, 1),
(1, 2), (2, 2) and (1, 4) of gloo CPU ranks (every local transform on
kernel T's plain twin) must give Q, A, B, C, the commitment, s, e and the
validity flags of JAX's ``ShardedProver`` on a (2, 2) mesh word for word
(``test_torch_pipeline_sharded_stage.py`` holds the same runs against JAX's
unsharded ``prove_stage_batch_jit``): the randomness is drawn by global
statement and coefficient index, so no byte depends on the mesh. The
commitment is also recomputed from the returned (s, e) with JAX's host
Goldilocks ring, and a batch with one broken witness is flagged at that
row.

The JAX package is imported inside fixtures, so the ``cuda`` test at the
end runs on a card machine without JAX:
``python -m pytest tests/test_torch_pipeline_sharded.py -m cuda --noconftest -q``.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.ops import modarith

import torch_parallel_ranks as ranks

Q = port.NTT_FRIENDLY_MODULUS
M, SEED = 64, 17
MESHES = [(1, 1), (1, 2), (2, 2), (1, 4)]
NAMES = ["Q", "A", "B", "C", "commitment", "s", "e", "valid"]


@pytest.fixture(scope="module")
def port_pending():
    """The port's ranks, started in a thread of their own so that they run
    while JAX compiles its reference."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(ranks.spawn_meshes, M, SEED, MESHES)


@pytest.fixture(scope="module")
def port_runs(port_pending, jax_runs):
    return port_pending.result()


@pytest.fixture(scope="module")
def jax_runs(port_pending):
    """JAX's ShardedProver on a (2, 2) mesh, both batches, as numpy: uint64
    words, int signed draws."""
    from lambda_snark_tpu import Params, Profile, SecurityLevel
    from lambda_snark_tpu.commit.lwe import LweContext
    from lambda_snark_tpu.ops.limb import from_limbs_u64, to_limbs
    from lambda_snark_tpu.parallel.mesh import make_mesh
    from lambda_snark_tpu.parallel.pipeline_sharded import ShardedProver as JaxProver
    from lambda_snark_tpu.circuits.examples import multiplication_gates_circuit

    ctx = LweContext(Params(SecurityLevel.BITS128, Profile.ring_b(n=M, k=2, q=Q, sigma=3.19)),
                     context_seed=5)
    r1cs = multiplication_gates_circuit(M, Q)
    prover = JaxProver(M, Q, ctx, make_mesh([2, 2], ["dp", "sp"]))
    d = prover.fq_ctx.d
    out = {"ctx": ctx, "runs": []}
    for ws in ranks.sharded_witnesses(M):
        evs = [r1cs.compute_constraint_evals(w) for w in ws]
        planes = [to_limbs(np.array([e[i] for e in evs], dtype=object), d) for i in range(3)]
        res = prover.run(*planes, seed=SEED)
        flat = [from_limbs_u64(prover.coeff_layout_to_flat(np.asarray(t))) for t in res[:5]]
        s = np.asarray(res[5]).reshape(2, 4, M)
        e = np.asarray(res[6]).reshape(4, M)
        out["runs"].append(flat + [s, e, np.asarray(res[7]).reshape(-1)])
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return modarith.to_u64(t) if t.dtype == torch.int64 else t.numpy()


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("index", range(8), ids=NAMES)
def test_outputs_equal_jax_sharded_prover(port_runs, jax_runs, shape, index):
    for got, want in zip(port_runs[shape][0]["runs"], jax_runs["runs"]):
        g = _np(got[index])
        assert g.shape == np.asarray(want[index]).shape
        assert np.array_equal(g.astype(np.asarray(want[index]).dtype), want[index])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_commitment_opens_on_the_host(port_runs, jax_runs, shape):
    """c = sum_j A_j s_j + e + Q over the ring, from the returned (s, e),
    with the JAX package's numpy Goldilocks ring."""
    from lambda_snark_tpu.commit.lwe import RING_MODULUS
    from lambda_snark_tpu.ops.goldilocks_np import gl_add, goldilocks_ntt

    ctx = jax_runs["ctx"]
    q_w, _a, _b, _c, comm, s, e, _v = (_np(t) for t in port_runs[shape][0]["runs"][0])
    ntt = goldilocks_ntt(M)
    ring = lambda v: np.where(v < 0, v.astype(np.int64).astype(np.uint64) + np.uint64(RING_MODULUS),
                              v.astype(np.uint64))
    for i in range(4):
        acc = np.zeros(M, dtype=np.uint64)
        for j in range(2):
            acc = gl_add(acc, ntt.negacyclic_mul(ntt.inverse_negacyclic(ctx.a_hat[j]),
                                                 ring(s[j, i])))
        acc = gl_add(gl_add(acc, ring(e[i])), q_w[i])
        assert np.array_equal(acc, comm[i]), i


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_invalid_witness_flagged(port_runs, shape):
    valid, broken = (run[7].tolist() for run in port_runs[shape][0]["runs"])
    assert valid == [True] * 4
    assert broken == [True, False, True, True]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_rank_blocks(port_runs, shape):
    """Rank (i, j) holds batch block i and row block j of R = 8 rows."""
    dp, sp = shape
    got = [(r["index"], r["rows"]) for r in port_runs[shape]]
    assert got == [((i, j), 8 // sp) for i in range(dp) for j in range(sp)]
    assert all(r["foreign"] == [] for r in port_runs[shape])


@pytest.mark.cuda
def test_sharded_step_on_card_equals_prove_stage_batch():
    """26a of ``chip_smoke.py`` at m = n = 256: a world of one under NCCL,
    the (1, 1) step bit-equal to ``prove_stage_batch`` (kernels Q and R),
    with kernel T's row entry launched and Q and R not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.ops.sampler import prng_key
    from lambda_snark_tpu_torch.parallel.mesh import make_mesh
    from lambda_snark_tpu_torch.parallel.multihost import initialize_multihost
    from lambda_snark_tpu_torch.parallel.pipeline_sharded import ShardedProver
    from lambda_snark_tpu_torch.pipeline import prove_stage_batch
    from lambda_snark_tpu_torch.prover_batched import prove_plan

    m = 256
    dev = torch.device("cuda")
    ctx = ranks.context(m)
    r1cs = port.multiplication_gates_circuit(m, Q)
    ws = [port.multiplication_gates_witness(m, Q, seed=s) for s in range(8)]
    evals = [x.to(dev) for x in ranks.evals_of(r1cs, ws)]
    initialize_multihost(backend="nccl")
    try:
        prover = ShardedProver(m, Q, ctx, make_mesh([1, 1], device="cuda"))
        kernels.reset_launches()
        out = prover.run(*evals, SEED)
        torch.cuda.synchronize()
        launches = kernels.launches()
    finally:
        dist.destroy_process_group()
    want = prove_stage_batch(prove_plan(r1cs, ctx, dev), *evals, prng_key(SEED))
    for got, w in zip(out[:5], want[:5]):
        assert torch.equal(prover.coeff_layout_to_flat(got), w)
    assert torch.equal(out[7], want[5]) and bool(out[7].all())
    assert 1 <= launches["ntt_rows"] <= 20
    assert launches["quotient_q45"] == launches["ring_commit_goldilocks"] == 0
