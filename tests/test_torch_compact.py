"""The port's compact proofs (wire kinds 4 and 5) against the JAX package.

``prove_r1cs_compact`` must give the JAX package's bytes (193 bytes plain,
201 with the blinding factor), ``deserialize_any`` must read them both
ways, and ``verify_r1cs_compact`` must decide as JAX's does on valid and
tampered proofs (mirroring ``tests/test_compact.py``), over the
test-vector modulus 2^44 + 1 and the healthcare circuit's 2^44 + 7."""

import dataclasses

import pytest

from lambda_snark_tpu import Params, Profile, SecurityLevel, setup
from lambda_snark_tpu.proof import compact as jcompact
from lambda_snark_tpu.proof.types import deserialize_any as jax_deserialize

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.circuits import healthcare
from lambda_snark_tpu_torch.proof.compact import (
    CompactProofR1CS,
    derive_dual_digest,
    digest_words,
)
from lambda_snark_tpu_torch.r1cs.sparse import SparseMatrix

from test_r1cs import mult_gate_r1cs, mult_witness, multiplication_gates

Q = 17592186044417
HEALTH_Q = 17592186044423


def _port_r1cs(jr):
    """The port's copy of a JAX R1CS (same matrices, domain and modulus)."""
    mats = [SparseMatrix.from_map(jr.m, jr.n, {(i, j): v for i, j, v in mat.coo()})
            for mat in (jr.a, jr.b, jr.c)]
    return port.R1CS(jr.m, jr.n, jr.l, *mats, modulus=jr.modulus,
                     domain=port.Domain(kind=jr.domain.kind, m=jr.domain.m,
                                        modulus=jr.domain.modulus, omega=jr.domain.omega))


def _ctxs(q=Q):
    return (setup(Params(SecurityLevel.BITS128, Profile.ring_b(64, 1, q, 3.19))),
            port.setup(port.Params(port.SecurityLevel.BITS128,
                                   port.Profile.ring_b(n=64, k=1, q=q, sigma=3.19))))


@pytest.fixture(scope="module")
def ctxs():
    return _ctxs()


CASES = {
    "mult_gate": lambda: (mult_gate_r1cs(), [1, 7, 13, 91]),
    "gates3": lambda: (multiplication_gates(3, Q), mult_witness(3, Q, seed=4)),
}


@pytest.mark.parametrize("zk", [False, True], ids=["kind4", "kind5"])
@pytest.mark.parametrize("case", list(CASES))
def test_compact_bytes_equal_jax(ctxs, case, zk):
    jctx, ours = ctxs
    jr, w = CASES[case]()
    pr = _port_r1cs(jr)
    kw = dict(blinding_seed=5, zk=True) if zk else {}
    theirs = jcompact.prove_r1cs_compact(jr, w, jctx, 3, **kw)
    mine = port.prove_r1cs_compact(pr, w, ours, 3, **kw)
    blob = mine.to_bytes()
    assert blob == theirs.to_bytes()
    assert len(blob) == (201 if zk else 193) and blob[8] == (5 if zk else 4)
    public = pr.public_inputs(w)
    assert port.verify_r1cs_compact(mine, public, pr)
    assert jcompact.verify_r1cs_compact(jax_deserialize(blob), public, jr)
    back = port.deserialize_any(theirs.to_bytes())
    assert isinstance(back, CompactProofR1CS) and back.to_bytes() == blob
    assert back.is_zk == zk


def test_compact_healthcare_bytes_equal_jax():
    from lambda_snark_tpu.circuits import healthcare as jhealth

    jctx, ours = _ctxs(HEALTH_Q)
    jr, pr = jhealth.build_healthcare_circuit(HEALTH_Q), healthcare.build_healthcare_circuit(
        HEALTH_Q)
    w = healthcare.high_risk_witness(HEALTH_Q)
    for kw in ({}, dict(blinding_seed=9, zk=True)):
        theirs = jcompact.prove_r1cs_compact(jr, w, jctx, 11, **kw)
        mine = port.prove_r1cs_compact(pr, w, ours, 11, **kw)
        assert mine.to_bytes() == theirs.to_bytes()
        assert port.verify_r1cs_compact(mine, pr.public_inputs(w), pr)


def _tampered(proof, case):
    if case == "blinding":
        return dataclasses.replace(proof, blinding_factor=(proof.blinding_factor + 1) % Q)
    if case == "digest":
        return dataclasses.replace(proof, commitment_digest=bytes(32))
    return dataclasses.replace(proof, **{case: (getattr(proof, case) + 1) % Q})


TAMPER = ["q_alpha", "a_z_beta", "c_z_alpha", "digest", "blinding"]


@pytest.mark.parametrize("case", TAMPER)
def test_compact_tamper_rejected_by_both(ctxs, case):
    jctx, ours = ctxs
    jr, w = CASES["gates3"]()
    pr = _port_r1cs(jr)
    proof = port.prove_r1cs_compact(pr, w, ours, 3, blinding_seed=5, zk=True)
    bad = _tampered(proof, case)
    public = pr.public_inputs(w)
    assert not port.verify_r1cs_compact(bad, public, pr)
    assert not jcompact.verify_r1cs_compact(jcompact.CompactProofR1CS.from_bytes(bad.to_bytes()),
                                            public, jr)


def test_compact_wrong_public_inputs_and_other_circuit_rejected(ctxs):
    jctx, ours = ctxs
    jr = mult_gate_r1cs()
    pr = _port_r1cs(jr)
    proof = port.prove_r1cs_compact(pr, [1, 7, 13, 91], ours, 1)
    assert not port.verify_r1cs_compact(proof, [1, 8], pr)
    # the same shape with another A matrix: the circuit digest differs
    other = port.R1CS(1, 4, 2, SparseMatrix.from_map(1, 4, {(0, 1): 2}), pr.b, pr.c, modulus=Q)
    assert not port.verify_r1cs_compact(proof, [1, 7], other)
    assert port.verify_r1cs_compact(proof, [1, 7], pr)


def test_compact_deterministic_and_digest_helpers(ctxs):
    jctx, ours = ctxs
    jr = mult_gate_r1cs()
    pr = _port_r1cs(jr)
    p1 = port.prove_r1cs_compact(pr, [1, 7, 13, 91], ours, 7)
    assert p1.to_bytes() == port.prove_r1cs_compact(pr, [1, 7, 13, 91], ours, 7).to_bytes()
    digest = bytes(range(32))
    assert digest_words(digest) == jcompact.digest_words(digest)
    for circ in (b"", bytes(range(32, 64))):
        mine = derive_dual_digest([1, 7], digest, Q, circ)
        theirs = jcompact.derive_dual_digest([1, 7], digest, Q, circ)
        assert [c.to_bytes() for c in mine] == [c.to_bytes() for c in theirs]


@pytest.mark.parametrize("cut", [0, 1, 8, 9, 20, 192])
def test_compact_truncation_is_typed(ctxs, cut):
    """Truncated blobs raise SerializationError in both packages."""
    jctx, ours = ctxs
    pr = _port_r1cs(mult_gate_r1cs())
    good = port.prove_r1cs_compact(pr, [1, 7, 13, 91], ours, 1).to_bytes()
    with pytest.raises(Exception) as theirs:
        jax_deserialize(good[:cut])
    with pytest.raises(port.SerializationError) as mine:
        port.deserialize_any(good[:cut])
    assert type(theirs.value).__name__ == "SerializationError"
    assert str(mine.value) == str(theirs.value)


def test_compact_proofs_verify_in_both_stores(ctxs, tmp_path):
    """A kind-4 and a kind-5 proof saved to the port's store and to the
    JAX package's: every store's ``verify_all`` gives True, and each
    package reads the other's directory alike."""
    from lambda_snark_tpu.utils.artifacts import ProofStore as JaxStore

    jctx, ours = ctxs
    jr, w = CASES["mult_gate"]()
    pr = _port_r1cs(jr)
    public = pr.public_inputs(w)
    mine, theirs = port.ProofStore(str(tmp_path / "port")), JaxStore(str(tmp_path / "jax"))
    for seed, kw in ((3, {}), (4, dict(zk=True, blinding_seed=5))):
        mine.save(pr, public, seed, port.prove_r1cs_compact(pr, w, ours, seed, **kw))
        theirs.save(jr, public, seed, jcompact.prove_r1cs_compact(jr, w, jctx, seed, **kw))
    for store, r1cs in ((mine, pr), (theirs, jr), (port.ProofStore(theirs.root), pr),
                        (JaxStore(mine.root), jr)):
        results = store.verify_all(r1cs)
        assert len(results) == 2 and all(results.values())
