"""The port's sharded prove step against the JAX package's unsharded
``prove_stage_batch_jit``, on the CPU.

The runs of ``test_torch_pipeline_sharded.py`` (M = 64, ring n = M, k = 2,
context seed 5, four witnesses, seed 17; meshes (1, 1), (1, 2), (2, 2) and
(1, 4) of gloo CPU ranks) must give Q, A, B, C, the commitment and the
validity flags of JAX's single-device stage under
``PRNGKey(17 & 0x7FFFFFFF)`` (JAX's ``test_commitment_mesh_invariant``),
and of the port's own ``pipeline.prove_stage_batch`` on the CPU (kernels Q
and R as their plain twins). JAX compiles its stage while the port's ranks
run.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.ops.sampler import prng_key
from lambda_snark_tpu_torch.pipeline import prove_stage_batch
from lambda_snark_tpu_torch.prover_batched import prove_plan

import torch_parallel_ranks as ranks

Q = port.NTT_FRIENDLY_MODULUS
M, SEED = 64, 17
MESHES = [(1, 1), (1, 2), (2, 2), (1, 4)]
NAMES = ["Q", "A", "B", "C", "commitment", "valid"]
INDEX = [0, 1, 2, 3, 4, 7]  # those outputs' places in ``ShardedProver.run``'s


@pytest.fixture(scope="module")
def port_pending():
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(ranks.spawn_meshes, M, SEED, MESHES)


@pytest.fixture(scope="module")
def jax_stage(port_pending):
    """JAX's ``prove_stage_batch_jit`` on the valid batch, as numpy."""
    import jax
    import jax.numpy as jnp

    from lambda_snark_tpu import Params, Profile, SecurityLevel
    from lambda_snark_tpu.circuits.examples import multiplication_gates_circuit
    from lambda_snark_tpu.commit.lwe import LweContext
    from lambda_snark_tpu.commit.lwe_jax import DeviceCommitContext
    from lambda_snark_tpu.ops.limb import from_limbs_u64, modulus_ctx, to_limbs
    from lambda_snark_tpu.pipeline import ProvePlan, prove_stage_batch_jit

    ctx = LweContext(Params(SecurityLevel.BITS128, Profile.ring_b(n=M, k=2, q=Q, sigma=3.19)),
                     context_seed=5)
    r1cs = multiplication_gates_circuit(M, Q)
    evs = [r1cs.compute_constraint_evals(w) for w in ranks.sharded_witnesses(M)[0]]
    d = modulus_ctx(Q).d
    planes = [jnp.asarray(to_limbs(np.array([e[i] for e in evs], dtype=object), d))
              for i in range(3)]
    pp = ProvePlan.create(M, Q, DeviceCommitContext.from_host(ctx))
    out = prove_stage_batch_jit(pp, *planes, jax.random.PRNGKey(SEED & 0x7FFFFFFF))
    return [from_limbs_u64(np.asarray(t)) for t in out[:5]] + [np.asarray(out[5]).reshape(-1)]


@pytest.fixture(scope="module")
def port_runs(port_pending, jax_stage):
    return port_pending.result()


@pytest.fixture(scope="module")
def port_stage():
    """The port's unsharded stage on the CPU, same inputs and key."""
    r1cs = port.multiplication_gates_circuit(M, Q)
    evals = ranks.evals_of(r1cs, ranks.sharded_witnesses(M)[0])
    pp = prove_plan(r1cs, ranks.context(M), torch.device("cpu"))
    return prove_stage_batch(pp, *evals, prng_key(SEED & 0x7FFFFFFF))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("pos", range(6), ids=NAMES)
def test_outputs_equal_jax_prove_stage_batch(port_runs, jax_stage, shape, pos):
    got = port_runs[shape][0]["runs"][0][INDEX[pos]]
    want = jax_stage[pos]
    got = modarith.to_u64(got) if got.dtype == torch.int64 else got.numpy()
    assert np.array_equal(got.astype(want.dtype), want)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("pos", range(6), ids=NAMES)
def test_outputs_equal_port_prove_stage_batch(port_runs, port_stage, shape, pos):
    assert torch.equal(port_runs[shape][0]["runs"][0][INDEX[pos]], port_stage[pos])
