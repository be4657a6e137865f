"""The port's streamed prover, its proof store and ``entry()`` against the
JAX package, on the CPU: byte-identical streams (a partial tail batch, a
resume from a store), the same store layout read by either package, the
stream index in an invalid-witness error, and the prove stage of
``entry()``. The ZK stream is ``tests/test_torch_stream_zk.py``. Every
comparison is exact."""

import os

import numpy as np
import pytest

import __graft_entry__
import lambda_snark_tpu as J
from lambda_snark_tpu.circuits.examples import multiplication_gates_circuit as jax_circuit
from lambda_snark_tpu.circuits.examples import multiplication_gates_witness as jax_witness
from lambda_snark_tpu.core.errors import InvalidWitnessError as JaxInvalidWitness
from lambda_snark_tpu.ops.limb import from_limbs_u64
from lambda_snark_tpu.prover_batched import prove_r1cs_batched as jax_batched
from lambda_snark_tpu.prover_batched import prove_r1cs_stream as jax_stream
from lambda_snark_tpu.utils import artifacts as jax_artifacts

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import InvalidWitnessError
from lambda_snark_tpu_torch.ops import modarith

Q = port.NTT_FRIENDLY_MODULUS
M, N, SEED = 8, 16, 7


@pytest.fixture(scope="module")
def setup():
    jax_ctx = J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(N, 1, Q, 3.19)))
    ctx = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                      port.Profile.ring_b(n=N, k=1, q=Q, sigma=3.19)))
    ws = [jax_witness(M, Q, seed=s) for s in range(5)]
    return jax_ctx, jax_circuit(M, Q), ctx, port.multiplication_gates_circuit(M, Q), ws


def _streams(setup, zk, blinding_seed, batch=2, store=None, jax_store=None):
    jax_ctx, jr, ctx, pr, ws = setup
    theirs = list(jax_stream(jr, iter(ws), jax_ctx, SEED, batch=batch, zk=zk,
                             blinding_seed=blinding_seed, store=jax_store))
    mine = list(port.prove_r1cs_stream(pr, iter(ws), ctx, SEED, batch=batch, zk=zk,
                                       blinding_seed=blinding_seed, store=store,
                                       device="cpu"))
    return theirs, mine


def test_stream_bytes_equal_jax(setup):
    """5 witnesses in batches of 2: a partial tail batch of 1."""
    theirs, mine = _streams(setup, False, None)
    assert len(mine) == 5
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]
    assert all(port.verify_r1cs(port.deserialize_any(p.to_bytes()), [1], setup[3])
               for p in mine)


def test_stream_first_batch_is_the_batched_prover(setup):
    """Batch 0 is keyed from seed ^ 0x9E3779B97F4A7C15, so the stream's
    first batch equals ``prove_r1cs_batched`` under that key, in both
    packages."""
    jax_ctx, jr, ctx, pr, ws = setup
    key = (SEED ^ 0x9E3779B97F4A7C15) & ((1 << 63) - 1)
    _theirs, mine = _streams(setup, False, None)
    batched = port.prove_r1cs_batched(pr, ws[:2], ctx, key, device="cpu")
    assert [p.to_bytes() for p in batched] == [p.to_bytes() for p in mine[:2]]
    assert [p.to_bytes() for p in jax_batched(jr, ws[:2], jax_ctx, key)] == \
        [p.to_bytes() for p in mine[:2]]


def test_stream_resume_from_store(setup, tmp_path):
    """A stream cut after 3 proofs leaves them in the store; the restarted
    stream regenerates identical bytes and completes the store, whose
    manifest keys and blobs equal the JAX package's for the same stream."""
    _jax_ctx, jr, ctx, pr, ws = setup
    store = port.ProofStore(str(tmp_path / "port"))
    cut = port.prove_r1cs_stream(pr, iter(ws), ctx, SEED, batch=2, store=store, device="cpu")
    first = [next(cut).to_bytes() for _ in range(3)]
    cut.close()
    publics = [(pr.public_inputs(w), SEED) for w in ws]
    labels = [f"stream-{i}" for i in range(5)]
    assert store.missing_statements(pr, publics, labels) == [3, 4]
    jax_store = jax_artifacts.ProofStore(str(tmp_path / "jax"))
    theirs, mine = _streams(setup, False, None, store=store, jax_store=jax_store)
    assert [p.to_bytes() for p in mine[:3]] == first
    assert store.missing_statements(pr, publics, labels) == []
    assert store.keys() == jax_store.keys()
    for i, key in enumerate(store.keys()):
        assert store._manifest[key] == jax_store._manifest[key]
    for i, w in enumerate(ws):
        key = port.statement_digest(pr, pr.public_inputs(w), SEED, f"stream-{i}")
        assert key == jax_artifacts.statement_digest(jr, jr.public_inputs(w), SEED,
                                                     f"stream-{i}")
        assert store.load(key).to_bytes() == theirs[i].to_bytes()
    assert all(store.verify_all(pr).values()) and len(store.verify_all(pr)) == 5
    # each package sweeps the other's store
    assert all(jax_artifacts.ProofStore(store.root).verify_all(jr).values())
    assert all(port.ProofStore(jax_store.root).verify_all(pr).values())


def test_stream_invalid_witness_names_its_stream_index(setup):
    jax_ctx, jr, ctx, pr, ws = setup
    bad = [list(w) for w in ws]
    bad[3][-1] = (bad[3][-1] + 1) % Q  # the second batch's second witness
    with pytest.raises(JaxInvalidWitness) as theirs:
        list(jax_stream(jr, iter(bad), jax_ctx, SEED, batch=2))
    with pytest.raises(InvalidWitnessError) as mine:
        list(port.prove_r1cs_stream(pr, iter(bad), ctx, SEED, batch=2, device="cpu"))
    assert str(mine.value) == str(theirs.value) == "witnesses [3] do not satisfy the R1CS"


def test_store_records_kinds_it_cannot_load(setup, tmp_path):
    """A stored blob whose kind byte was rewritten (a kind-2 body under
    kind 9) does not decode: both packages' ``verify_all`` raise the same
    SerializationError on it (every kind decodes, so the port records no
    failure of its own)."""
    _jax_ctx, jr, ctx, pr, ws = setup
    store = port.ProofStore(str(tmp_path))
    proof = port.prove_r1cs_batched(pr, ws[:1], ctx, 3, device="cpu")[0]
    key = store.save(pr, [1], 3, proof)
    blob = os.path.join(store.root, store._manifest[key]["proof_blob"] + ".proof")
    with open(blob, "r+b") as f:
        f.seek(8)
        f.write(bytes([9]))  # now a malformed committed-witness (kind-9) proof
    with pytest.raises(J.SerializationError) as theirs:
        jax_artifacts.ProofStore(str(tmp_path)).verify_all(jr)
    with pytest.raises(port.SerializationError) as mine:
        store.verify_all(pr)
    assert str(mine.value) == str(theirs.value)


def test_entry_matches_jax_entry():
    """``entry()`` on the CPU: the same evaluations and the same prove-stage
    outputs (Q, A, B, C, commitment words, validity) as the JAX entry."""
    fn, args = port.entry(device="cpu")
    jfn, jargs = __graft_entry__.entry()
    for mine, theirs in zip(args[:3], jargs[:3]):
        assert np.array_equal(modarith.to_u64(mine), from_limbs_u64(np.asarray(theirs)))
    out, jout = fn(*args), jfn(*jargs)
    for mine, theirs in zip(out[:5], jout[:5]):
        assert np.array_equal(modarith.to_u64(mine), from_limbs_u64(np.asarray(theirs)))
    assert out[5].tolist() == np.asarray(jout[5]).tolist() == [True, True]
