"""The port's chunk-pipelined kind-7 prover and ``prove_r1cs_succinct_stream``
against the JAX package, on the CPU (m = 16, ring n = 64, k = 1,
``FriParams(log_blowup=3, num_queries=8)``).

- ``pipeline_chunk=2`` on 3 statements (an uneven tail chunk) gives the
  bytes of JAX's pipelined and unchunked provers, and on 5 statements
  JAX's pipelined bytes;
- the stream's bytes do not depend on its batch size and equal JAX's
  stream, plain and ZK, with per-index seeds (``_index_seed``);
- a ``ProofStore`` resume serves the stored statements byte-identical;
- ``witness_bind=True`` (kind 9) gives the JAX stream's bytes."""

import numpy as np
import pytest

from lambda_snark_tpu import Params, Profile, SecurityLevel, setup
from lambda_snark_tpu.proof.fri import FriParams as JaxFriParams
from lambda_snark_tpu.proof.succinct_batch import _index_seed as jax_index_seed
from lambda_snark_tpu.proof.succinct_batch import prove_r1cs_succinct_batch as jax_prove
from lambda_snark_tpu.proof.succinct_batch import prove_r1cs_succinct_stream as jax_stream
from lambda_snark_tpu.utils.artifacts import ProofStore as JaxStore

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import InvalidWitnessError
from lambda_snark_tpu_torch.proof.fri import FriParams
from lambda_snark_tpu_torch.proof.succinct_batch import _index_seed

from test_succinct import mult_circuit, mult_witness

GL = port.NTT_MODULUS
M = 16
FAST = (3, 8)


@pytest.fixture(scope="module")
def setup_():
    jax_ctx = setup(Params(SecurityLevel.BITS128, Profile.ring_b(64, 1, GL, 3.19)))
    ours = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=64, k=1, q=GL, sigma=3.19)))
    return jax_ctx, ours, mult_circuit(M, GL), port.multiplication_gates_circuit(M, GL)


def _bytes(proofs):
    return [p.to_bytes() for p in proofs]


@pytest.fixture(scope="module")
def jax_pipelined(setup_):
    """(witnesses, seeds, JAX's unchunked proofs, JAX's pipelined proofs at
    pipeline_chunk=2: a chunk of 2 and a tail of 1)."""
    jax_ctx, _ours, jr, _pr = setup_
    ws = [mult_witness(M, GL, seed=i) for i in range(3)]
    seeds = [21, 22, 23]
    unchunked = jax_prove(jr, ws, jax_ctx, seeds, fri_params=JaxFriParams(*FAST),
                          device_lde=False)
    piped = jax_prove(jr, ws, jax_ctx, seeds, fri_params=JaxFriParams(*FAST), pipeline_chunk=2)
    return ws, seeds, unchunked, piped


@pytest.mark.parametrize("chunk", [1, 2])
def test_pipelined_bytes_equal_jax_pipelined_and_unchunked(setup_, jax_pipelined, chunk):
    _jax_ctx, ours, _jr, pr = setup_
    ws, seeds, unchunked, piped = jax_pipelined
    mine = port.prove_r1cs_succinct_batch(pr, ws, ours, seeds, fri_params=FriParams(*FAST),
                                          pipeline_chunk=chunk, device="cpu")
    assert _bytes(mine) == _bytes(piped) == _bytes(unchunked)


def test_pipelined_s5_bytes_equal_jax_pipelined(setup_):
    """S = 5 in chunks of 2 (two full chunks and a tail): the port's
    three-phase prover gives the bytes of JAX's ``_prove_pipelined`` (the
    same chunk shapes as the fixture's, compiled once in this process)."""
    jax_ctx, ours, jr, pr = setup_
    ws = [mult_witness(M, GL, seed=20 + i) for i in range(5)]
    seeds = [81, 82, 83, 84, 85]
    piped = jax_prove(jr, ws, jax_ctx, seeds, fri_params=JaxFriParams(*FAST), pipeline_chunk=2)
    mine = port.prove_r1cs_succinct_batch(pr, ws, ours, seeds, fri_params=FriParams(*FAST),
                                          pipeline_chunk=2, device="cpu")
    assert _bytes(mine) == _bytes(piped)


def test_pipelined_names_a_bad_witness_by_its_batch_index(setup_):
    _jax_ctx, ours, _jr, pr = setup_
    ws = [mult_witness(M, GL, seed=i) for i in range(3)]
    ws[2] = list(ws[2])
    ws[2][1] = (ws[2][1] + 1) % GL
    with pytest.raises(InvalidWitnessError, match="witness 2"):
        port.prove_r1cs_succinct_batch(pr, ws, ours, [1, 2, 3], fri_params=FriParams(*FAST),
                                       pipeline_chunk=2, device="cpu")


def test_index_seed_matches_jax():
    for master in (0, 7, 99, (1 << 64) - 1):
        for index in (0, 1, 5, 1000):
            assert _index_seed(master, index) == jax_index_seed(master, index)


@pytest.mark.parametrize("zk", [False, True])
def test_stream_partition_invariant_and_equal_jax(setup_, zk):
    jax_ctx, ours, jr, pr = setup_
    ws = [mult_witness(M, GL, seed=10 + i) for i in range(5)]
    theirs = list(jax_stream(jr, ws, jax_ctx, seed=99, batch=2, zk=zk,
                             fri_params=JaxFriParams(*FAST), device_lde=False))
    by2, by3 = (list(port.prove_r1cs_succinct_stream(pr, ws, ours, 99, batch=b, zk=zk,
                                                     fri_params=FriParams(*FAST),
                                                     device="cpu"))
                for b in (2, 3))
    assert [i for i, _p in by2] == [i for i, _p in by3] == list(range(5))
    assert _bytes(p for _i, p in by2) == _bytes(p for _i, p in by3) \
        == _bytes(p for _i, p in theirs)
    assert all(port.verify_r1cs_succinct(p, [1], pr, min_params=FriParams(*FAST))
               for _i, p in by2)
    assert all(p.mask_len == (2 * FAST[1] + 8 if zk else 0) for _i, p in by2)


def test_zk_stream_deterministic_with_blinding_seed(setup_):
    jax_ctx, ours, jr, pr = setup_
    ws = [mult_witness(M, GL, seed=30 + i) for i in range(2)]
    run = lambda: _bytes(p for _i, p in port.prove_r1cs_succinct_stream(
        pr, ws, ours, 1, batch=2, zk=True, fri_params=FriParams(*FAST), blinding_seed=5,
        device="cpu"))
    theirs = _bytes(p for _i, p in jax_stream(jr, ws, jax_ctx, 1, batch=2, zk=True,
                                              fri_params=JaxFriParams(*FAST), blinding_seed=5,
                                              device_lde=False))
    assert run() == run() == theirs


def test_stream_pipelined_equals_unchunked(setup_):
    _jax_ctx, ours, _jr, pr = setup_
    ws = [mult_witness(M, GL, seed=40 + i) for i in range(5)]
    plain, piped = (_bytes(p for _i, p in port.prove_r1cs_succinct_stream(
        pr, ws, ours, 3, batch=5, fri_params=FriParams(*FAST), pipeline_chunk=chunk,
        device="cpu")) for chunk in (None, 2))
    assert plain == piped


def test_store_resume_byte_identical(tmp_path, setup_):
    jax_ctx, ours, jr, pr = setup_
    ws = [mult_witness(M, GL, seed=20 + i) for i in range(4)]
    store = port.ProofStore(str(tmp_path / "proofs"))
    first = list(port.prove_r1cs_succinct_stream(pr, ws[:2], ours, 7, batch=2,
                                                 fri_params=FriParams(*FAST), store=store,
                                                 device="cpu"))
    assert len(store.keys()) == 2
    resumed = list(port.prove_r1cs_succinct_stream(pr, ws, ours, 7, batch=2,
                                                   fri_params=FriParams(*FAST), store=store,
                                                   device="cpu"))
    assert [(i, p.to_bytes()) for i, p in first] == \
        [(i, p.to_bytes()) for i, p in resumed[:2]]
    fresh = list(port.prove_r1cs_succinct_stream(pr, ws, ours, 7, batch=3,
                                                 fri_params=FriParams(*FAST), device="cpu"))
    assert _bytes(p for _i, p in resumed) == _bytes(p for _i, p in fresh)
    results = store.verify_all(pr)
    assert len(results) == 4 and all(results.values())
    # the JAX package reads the port's store, keys and labels alike
    jax_store = JaxStore(str(tmp_path / "proofs"))
    assert sorted(jax_store.keys()) == sorted(store.keys())
    assert all(jax_store.verify_all(jr).values())


def test_witness_bind_not_ported(setup_):
    """``witness_bind=True`` proves: kind-9 proofs under the labels
    ``succinct-w-{index}``, the JAX stream's bytes (the store and ZK cases:
    ``tests/test_torch_witness_stream.py``)."""
    jax_ctx, ours, jr, pr = setup_
    ws = [mult_witness(M, GL, seed=i) for i in range(2)]
    theirs = list(jax_stream(jr, ws, jax_ctx, 1, fri_params=JaxFriParams(*FAST),
                             witness_bind=True, device_lde=False))
    mine = list(port.prove_r1cs_succinct_stream(pr, ws, ours, 1, fri_params=FriParams(*FAST),
                                                witness_bind=True, device="cpu"))
    assert [i for i, _p in mine] == [0, 1]
    assert [type(p).__name__ for _i, p in mine] == ["WitnessProofR1CS"] * 2
    assert _bytes(p for _i, p in mine) == _bytes(p for _i, p in theirs)


def test_stream_of_numpy_witnesses(setup_):
    """(S, n) uint64 rows prove as the lists do."""
    _jax_ctx, ours, _jr, pr = setup_
    ws = [mult_witness(M, GL, seed=50 + i) for i in range(3)]
    rows = np.array(ws, dtype=np.uint64)
    a, b = (_bytes(p for _i, p in port.prove_r1cs_succinct_stream(
        pr, src, ours, 4, batch=2, fri_params=FriParams(*FAST), device="cpu"))
        for src in (ws, rows))
    assert a == b
