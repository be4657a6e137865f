"""The port's ZK stream against the JAX package's, on the CPU: per-batch
blinding factors from ChaCha20 seeded with ``(blinding_seed or seed) ^ k``,
5 witnesses in batches of 2 (a partial tail batch), byte-identical proofs
that both verifiers accept."""

import pytest

import lambda_snark_tpu as J
from lambda_snark_tpu.circuits.examples import multiplication_gates_circuit as jax_circuit
from lambda_snark_tpu.circuits.examples import multiplication_gates_witness as jax_witness
from lambda_snark_tpu.prover_batched import prove_r1cs_stream as jax_stream
from lambda_snark_tpu.verifier import verify_r1cs_zk as jax_verify_zk

import lambda_snark_tpu_torch as port

Q = port.NTT_FRIENDLY_MODULUS
M, N, SEED = 8, 16, 7


@pytest.fixture(scope="module")
def setup():
    jax_ctx = J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(N, 1, Q, 3.19)))
    ctx = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                      port.Profile.ring_b(n=N, k=1, q=Q, sigma=3.19)))
    ws = [jax_witness(M, Q, seed=s) for s in range(5)]
    return jax_ctx, jax_circuit(M, Q), ctx, port.multiplication_gates_circuit(M, Q), ws


@pytest.mark.parametrize("blinding_seed", [None, 77])
def test_zk_stream_bytes_equal_jax(setup, blinding_seed):
    jax_ctx, jr, ctx, pr, ws = setup
    theirs = list(jax_stream(jr, iter(ws), jax_ctx, SEED, batch=2, zk=True,
                             blinding_seed=blinding_seed))
    mine = list(port.prove_r1cs_stream(pr, iter(ws), ctx, SEED, batch=2, zk=True,
                                       blinding_seed=blinding_seed, device="cpu"))
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]
    factors = [p.blinding_factor for p in mine]
    assert len(set(factors)) == 5  # one draw per statement, per-batch streams
    for w, p in zip(ws, mine):
        back = port.deserialize_any(p.to_bytes())
        assert port.verify_r1cs_zk(back, pr.public_inputs(w), pr)
        assert jax_verify_zk(J.deserialize_any(p.to_bytes()), jr.public_inputs(w), jr)


def test_zk_stream_needs_ring_degree_above_m(setup):
    _jax_ctx, _jr, _ctx, pr, ws = setup
    small = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                        port.Profile.ring_b(n=M, k=1, q=Q, sigma=3.19)))
    with pytest.raises(port.DomainError, match="m=8\\+1 for ZK"):
        next(port.prove_r1cs_stream(pr, iter(ws), small, SEED, zk=True, device="cpu"))
