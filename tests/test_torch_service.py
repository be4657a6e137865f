"""The port's sharded proof service (``parallel.service.ShardedProofService``)
against the JAX package's, on the CPU.

At M = 64 (ring n = M, k = 2, context seed 5) over eight witnesses and
seed 21 in batches of 4, the port's service on a (2, 2) mesh of gloo CPU
ranks must yield the proofs in order with the bytes of JAX's service on a
(2, 2) mesh of virtual CPU devices (JAX's ``tests/test_service.py``). A
run cut after 3 statements and resumed from its ``ProofStore`` must serve
those bytes again and prove the rest; a tail batch on a (4, 1) mesh (dp = 4;
JAX's test takes a (4, 2) mesh of 8 devices) is padded by repeating the
last witness and gives the in-order run's bytes; a store passed on rank 0
alone resumes the same way (the other ranks follow rank 0's store); the
service raises JAX's
``DomainError``s, and a batch with a broken witness raises
``InvalidWitnessError`` on every rank (so none waits in a collective). JAX
builds its service while the port's ranks run.
"""

from concurrent.futures import ThreadPoolExecutor

import pytest

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.parallel.multihost import spawn_local

import torch_parallel_ranks as ranks

Q = port.NTT_FRIENDLY_MODULUS
M, SEED, COUNT = 64, 21, 8


def _witnesses():
    return [port.multiplication_gates_witness(M, Q, seed=s) for s in range(COUNT)]


def _spawn(store_root, rank0_root):
    ws = _witnesses()
    return {
        "grid": spawn_local(4, ranks.service_rank, ((2, 2), M, ws, SEED, 4), device="cpu"),
        "resume": spawn_local(4, ranks.service_rank, ((2, 2), M, ws, SEED, 2, store_root, 3),
                              device="cpu"),
        "rank0_store": spawn_local(4, ranks.service_rank,
                                   ((2, 2), M, ws, SEED, 2, rank0_root, 3, True), device="cpu"),
        "tail": spawn_local(4, ranks.service_rank, ((4, 1), M, ws[:5], SEED, 4), device="cpu"),
        "errors": spawn_local(4, ranks.service_errors_rank, (M,), device="cpu"),
    }


@pytest.fixture(scope="module")
def port_pending(tmp_path_factory):
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_spawn, str(tmp_path_factory.mktemp("svc_store")),
                          str(tmp_path_factory.mktemp("svc_store_rank0")))


@pytest.fixture(scope="module")
def jax_bytes(port_pending):
    """JAX's ShardedProofService on a (2, 2) mesh, batches of 4: (index, bytes)."""
    from lambda_snark_tpu import Params, Profile, SecurityLevel
    from lambda_snark_tpu.circuits.examples import multiplication_gates_circuit
    from lambda_snark_tpu.commit.lwe import LweContext
    from lambda_snark_tpu.parallel.mesh import make_mesh
    from lambda_snark_tpu.parallel.service import ShardedProofService

    ctx = LweContext(Params(SecurityLevel.BITS128, Profile.ring_b(n=M, k=2, q=Q, sigma=3.19)),
                     context_seed=5)
    svc = ShardedProofService(multiplication_gates_circuit(M, Q), ctx,
                              make_mesh([2, 2], ["dp", "sp"]), batch=4)
    return [(i, p.to_bytes()) for i, p in svc.prove_stream(_witnesses(), seed=SEED)]


@pytest.fixture(scope="module")
def port_runs(port_pending, jax_bytes):
    return port_pending.result()


def _verifies(data: bytes, i: int) -> bool:
    r1cs = port.multiplication_gates_circuit(M, Q)
    w = _witnesses()[i]
    return port.verify_r1cs(port.deserialize_any(data), r1cs.public_inputs(w), r1cs)


def test_stream_in_order_equals_jax(port_runs, jax_bytes):
    got = port_runs["grid"][0]["runs"][0]
    assert [i for i, _b in got] == list(range(COUNT))
    assert got == jax_bytes
    assert all(_verifies(b, i) for i, b in got)


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_other_ranks_yield_nothing(port_runs, rank):
    assert port_runs["grid"][rank]["runs"] == [[]]
    assert port_runs["resume"][rank]["runs"] == [[], [], []]


def test_resume_serves_the_stored_proofs(port_runs):
    whole, cut, resumed = port_runs["resume"][0]["runs"]
    assert [i for i, _b in cut] == [0, 1, 2]
    assert [i for i, _b in resumed] == list(range(COUNT))
    # the stored statements come back byte for byte; the batch partition,
    # so the seed, of the rest starts at the cut
    assert resumed[:3] == cut == whole[:3]
    assert all(_verifies(b, i) for i, b in resumed)


@pytest.mark.parametrize("rank", range(4))
def test_store_on_rank_0_alone(port_runs, rank):
    """Only rank 0 passes a store: every rank follows it into the same
    broadcasts, and rank 0 resumes as when every rank passes one."""
    got = port_runs["rank0_store"][rank]["runs"]
    assert got == (port_runs["resume"][0]["runs"] if rank == 0 else [[], [], []])


def test_tail_batch_is_padded(port_runs):
    """Five statements over dp = 4: a full batch and a tail of one, padded
    to four rows; the bytes are the in-order run's."""
    got = port_runs["tail"][0]["runs"][0]
    assert port_runs["tail"][0]["batch"] == 4
    assert got == port_runs["grid"][0]["runs"][0][:5]


@pytest.mark.parametrize("case,message", [
    ("batch", "batch 3 must divide over dp=2"),
    ("domain", "sharded proving requires a roots (NTT) domain"),
    ("prover_ctx", "supplied prover does not match"),
    ("prover_axes", "supplied prover does not match"),
    ("ring_degree", "the sharded path needs m == ring degree (m=64, n=128)"),
])
def test_domain_errors(port_runs, case, message):
    got = port_runs["errors"][0][case]
    assert isinstance(got, str) and got.startswith("DomainError: ") and message in got


@pytest.mark.parametrize("rank", range(4))
def test_invalid_witness_raises_on_every_rank(port_runs, rank):
    assert port_runs["errors"][rank]["invalid"] == \
        "InvalidWitnessError: witnesses [1] do not satisfy the R1CS"


def test_default_batch_is_two_dp(port_runs):
    assert port_runs["errors"][0]["default_batch"] == 4
