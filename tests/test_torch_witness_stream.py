"""The port's kind-9 batch and ``witness_bind`` stream against the JAX
package, on the CPU (m = 8, ring n = 64, k = 1,
``FriParams(log_blowup=3, num_queries=8)``; JAX with ``device_lde=False``).

- ``prove_r1cs_witness_batch`` gives the JAX batch's bytes, plain and ZK,
  one ``prove_r1cs_witness`` per statement, and refuses bad seed counts
  with JAX's errors;
- ``prove_r1cs_succinct_stream(witness_bind=True)`` gives the JAX stream's
  bytes whatever its batch size, stores each proof under
  ``{prefix}-w-{index}``, serves a cut run's stored statements
  byte-identical on resume, and either package's ``ProofStore`` reads and
  verifies the other's kind-9 store."""

import pytest

from lambda_snark_tpu import Params, Profile, SecurityLevel, setup
from lambda_snark_tpu.proof.fri import FriParams as JaxFriParams
from lambda_snark_tpu.proof.succinct_batch import prove_r1cs_succinct_stream as jax_stream
from lambda_snark_tpu.proof.succinct_batch import prove_r1cs_witness_batch as jax_batch
from lambda_snark_tpu.utils.artifacts import ProofStore as JaxStore

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import InvalidDimensionsError
from lambda_snark_tpu_torch.proof.fri import FriParams
from lambda_snark_tpu_torch.proof.succinct_batch import _index_seed
from lambda_snark_tpu_torch.utils.artifacts import statement_digest

from test_succinct import mult_circuit, mult_witness

GL = port.NTT_MODULUS
M = 8
FAST = (3, 8)


@pytest.fixture(scope="module")
def setup_():
    jax_ctx = setup(Params(SecurityLevel.BITS128, Profile.ring_b(64, 1, GL, 3.19)))
    ours = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=64, k=1, q=GL, sigma=3.19)))
    ws = [mult_witness(M, GL, seed=i) for i in range(3)]
    return jax_ctx, ours, mult_circuit(M, GL), port.multiplication_gates_circuit(M, GL), ws


def _bytes(proofs):
    return [p.to_bytes() for p in proofs]


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_witness_batch_bytes_equal_jax(setup_, zk):
    jax_ctx, ours, jr, pr, ws = setup_
    blinds = [31, 32, 33] if zk else None
    theirs = jax_batch(jr, ws, jax_ctx, [10, 11, 12], zk=zk, fri_params=JaxFriParams(*FAST),
                       blinding_seeds=blinds, device_lde=False)
    mine = port.prove_r1cs_witness_batch(pr, ws, ours, [10, 11, 12], zk=zk,
                                         fri_params=FriParams(*FAST), blinding_seeds=blinds,
                                         device="cpu")
    assert _bytes(mine) == _bytes(theirs)
    single = port.prove_r1cs_witness(pr, ws[1], ours, 11, zk=zk, fri_params=FriParams(*FAST),
                                     blinding_seed=32, device="cpu")
    assert single.to_bytes() == mine[1].to_bytes()
    assert all(port.verify_r1cs_witness(p, [1], pr, min_params=FriParams(*FAST)) for p in mine)


@pytest.mark.parametrize("case", ["seed_count", "zk_blinds"])
def test_witness_batch_refusals_equal_jax(setup_, case):
    jax_ctx, ours, jr, pr, ws = setup_
    kw = dict(zk=True, blinding_seeds=[1]) if case == "zk_blinds" else {}
    seeds = [1, 2] if case == "seed_count" else [1, 2, 3]
    with pytest.raises(Exception) as theirs:
        jax_batch(jr, ws, jax_ctx, seeds, **kw)
    with pytest.raises(InvalidDimensionsError) as mine:
        port.prove_r1cs_witness_batch(pr, ws, ours, seeds, device="cpu", **kw)
    assert type(theirs.value).__name__ == "InvalidDimensionsError"
    assert str(mine.value) == str(theirs.value)


@pytest.fixture(scope="module")
def jax_streams(setup_):
    """The JAX witness streams, plain and ZK (batch 2), by zk."""
    jax_ctx, _ours, jr, _pr, ws = setup_
    return {zk: list(jax_stream(jr, ws, jax_ctx, 77, batch=2, zk=zk,
                                fri_params=JaxFriParams(*FAST), witness_bind=True,
                                device_lde=False))
            for zk in (False, True)}


@pytest.mark.parametrize("batch", [1, 2, 3])
@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_witness_stream_bytes_equal_jax(setup_, jax_streams, zk, batch):
    _jax_ctx, ours, _jr, pr, ws = setup_
    mine = list(port.prove_r1cs_succinct_stream(pr, ws, ours, 77, batch=batch, zk=zk,
                                                fri_params=FriParams(*FAST), witness_bind=True,
                                                device="cpu"))
    assert [i for i, _p in mine] == [0, 1, 2]
    assert _bytes(p for _i, p in mine) == _bytes(p for _i, p in jax_streams[zk])


def test_witness_stream_store_resume_and_both_stores(setup_, jax_streams, tmp_path):
    """A run cut after two proofs, then a full run: the stored statements
    come back byte-identical under their ``succinct-w-{index}`` labels,
    and either package's store verifies the other's."""
    jax_ctx, ours, jr, pr, ws = setup_
    store = port.ProofStore(str(tmp_path / "port"))
    kw = dict(batch=2, fri_params=FriParams(*FAST), store=store, witness_bind=True,
              device="cpu")
    stream = port.prove_r1cs_succinct_stream(pr, ws, ours, 77, **kw)
    cut = [next(stream), next(stream)]
    assert len(store.keys()) == 2
    resumed = list(port.prove_r1cs_succinct_stream(pr, ws, ours, 77, **kw))
    assert _bytes(p for _i, p in resumed[:2]) == _bytes(p for _i, p in cut)
    assert _bytes(p for _i, p in resumed) == _bytes(p for _i, p in jax_streams[False])
    assert sorted(store.keys()) == sorted(
        statement_digest(pr, [1], _index_seed(77, i), f"succinct-w-{i}") for i in range(3))
    jax_store = JaxStore(str(tmp_path / "jax"))
    list(jax_stream(jr, ws, jax_ctx, 77, batch=2, fri_params=JaxFriParams(*FAST),
                    store=jax_store, witness_bind=True, device_lde=False))
    assert sorted(jax_store.keys()) == sorted(store.keys())
    for results in (store.verify_all(pr), jax_store.verify_all(jr),
                    JaxStore(store.root).verify_all(jr),
                    port.ProofStore(jax_store.root).verify_all(pr)):
        assert len(results) == 3 and all(results.values())
