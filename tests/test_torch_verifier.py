"""The port's proof decoding and kind-2/3/6 verifiers against the JAX
package, on the CPU: ``deserialize_any`` both ways for kinds 2, 3, 6 and 7
(kind 1: ``tests/test_torch_host_prover.py``; kind 9:
``tests/test_torch_witness.py``), malformed bodies of kinds 4, 5, 8 and 9
refused as JAX refuses them, the same decisions on valid and tampered
proofs, the opening check and ``Polynomial``, and the parameter lists of
the ported entry points (C.2: JAX's order, then ``device``)."""

import dataclasses
import inspect

import pytest

import lambda_snark_tpu as J
from lambda_snark_tpu.circuits.examples import multiplication_gates_circuit as jax_circuit
from lambda_snark_tpu.circuits.examples import multiplication_gates_witness as jax_witness
from lambda_snark_tpu.proof.fri import FriParams as JaxFriParams
from lambda_snark_tpu.proof.polynomial import Polynomial as JaxPolynomial
from lambda_snark_tpu.proof.types import deserialize_any as jax_deserialize
from lambda_snark_tpu.prover_batched import prove_r1cs_stream as jax_stream
from lambda_snark_tpu.utils import artifacts as jax_artifacts
from lambda_snark_tpu import verifier as jax_verifier
from lambda_snark_tpu.proof import checks as jax_checks

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch import prover_batched, verifier
from lambda_snark_tpu_torch.core.errors import SerializationError
from lambda_snark_tpu_torch.proof import succinct, succinct_batch
from lambda_snark_tpu_torch.proof.polynomial import Polynomial
from lambda_snark_tpu_torch.utils import artifacts

Q = port.NTT_FRIENDLY_MODULUS
M, N = 8, 16


@pytest.fixture(scope="module")
def setup():
    jax_ctx = J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(N, 1, Q, 3.19)))
    ctx = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                      port.Profile.ring_b(n=N, k=1, q=Q, sigma=3.19)))
    ws = [jax_witness(M, Q, seed=s) for s in range(5)]
    return jax_ctx, jax_circuit(M, Q), ctx, port.multiplication_gates_circuit(M, Q), ws


def _jax_proofs(setup):
    """JAX proofs of kinds 2 (stub and real openings, and on the sequential
    domain of m = 3 gates), 3, 6 and 7."""
    jax_ctx, jr, _ctx, _pr, ws = setup
    gl = port.NTT_MODULUS
    jr7 = jax_circuit(16, gl)
    ctx7 = J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(64, 1, gl, 3.19)))
    jr3 = jax_circuit(3, Q)
    assert jr3.domain.kind == "sequential"
    return {
        "kind2": (jr, J.prove_r1cs(jr, ws[0], jax_ctx, 3)),
        "kind2_sequential": (jr3, J.prove_r1cs(jr3, jax_witness(3, Q, seed=9), jax_ctx, 8)),
        "kind2_opening": (jr, J.prove_r1cs(jr, ws[1], jax_ctx, 4, with_opening=True)),
        "kind3": (jr, J.prove_r1cs_zk(jr, ws[2], jax_ctx, 5)),
        "kind6": (jr, J.prove_r1cs(jr, ws[3], jax_ctx, 6, with_opening=True,
                                   bind_circuit=True)),
        "kind7": (jr7, J.prove_r1cs_succinct(jr7, jax_witness(16, gl, seed=1), ctx7, 7,
                                             fri_params=JaxFriParams(3, 8, 64))),
    }


KINDS = ["kind2", "kind2_opening", "kind2_sequential", "kind3", "kind6", "kind7"]


@pytest.fixture(scope="module")
def jax_proofs(setup):
    return _jax_proofs(setup)


@pytest.mark.parametrize("kind", KINDS)
def test_deserialize_any_reads_jax_bytes(jax_proofs, kind):
    _jr, proof = jax_proofs[kind]
    blob = proof.to_bytes()
    mine = port.deserialize_any(blob)
    assert type(mine).__name__ == type(proof).__name__
    assert mine.to_bytes() == blob
    assert jax_deserialize(mine.to_bytes()).to_bytes() == blob


@pytest.mark.parametrize("zk", [False, True])
def test_jax_reads_port_bytes(setup, zk):
    _jax_ctx, _jr, ctx, pr, ws = setup
    for proof in port.prove_r1cs_batched(pr, ws[:2], ctx, 9, zk=zk, device="cpu"):
        blob = proof.to_bytes()
        theirs = jax_deserialize(blob)
        assert type(theirs).__name__ == type(proof).__name__
        assert port.deserialize_any(theirs.to_bytes()).to_bytes() == blob


@pytest.mark.parametrize("kind", [4, 5, 8, 9])
def test_deserialize_any_refuses_kinds_not_ported(kind):
    """Kinds 4, 5, 8 and 9 are decoded (no kind is left unported), so a
    body of zeros is refused as the JAX package refuses it."""
    blob = b"LSNKTPU1" + bytes([kind]) + bytes(64)
    with pytest.raises(J.SerializationError) as theirs:
        jax_deserialize(blob)
    with pytest.raises(SerializationError) as mine:
        port.deserialize_any(blob)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("blob,message", [
    (b"LSNKTPU2" + bytes(80), "bad proof magic"),
    (b"LSNK", "bad proof magic"),
    (b"LSNKTPU1" + bytes([42]) + bytes(16), "unknown proof kind 42"),
])
def test_deserialize_any_rejects_as_jax(blob, message):
    with pytest.raises(SerializationError, match=message):
        port.deserialize_any(blob)
    with pytest.raises(J.SerializationError, match=message):
        jax_deserialize(blob)


@pytest.mark.parametrize("kind", ["kind2", "kind3", "kind6"])
def test_truncated_bytes_rejected(jax_proofs, kind):
    blob = jax_proofs[kind][1].to_bytes()
    for cut in (12, len(blob) // 2, len(blob) - 1):
        with pytest.raises(SerializationError):
            port.deserialize_any(blob[:cut])


def _tamper(proof, how, q):
    if how == "valid":
        return proof
    if how == "publics":
        return proof  # the verifier gets other public inputs
    if how == "alpha":
        ch = proof.challenge_alpha
        return dataclasses.replace(proof, challenge_alpha=dataclasses.replace(
            ch, alpha=(ch.alpha + 1) % q))
    if how == "opening":
        op = proof.opening_alpha
        return dataclasses.replace(proof, opening_alpha=dataclasses.replace(
            op, evaluation=(op.evaluation + 1) % q))
    if how == "blinding":
        return dataclasses.replace(proof, blinding_factor=(proof.blinding_factor + 1) % q)
    return dataclasses.replace(proof, **{how: (getattr(proof, how) + 1) % q})


VERIFY_CASES = [("kind2", h) for h in ("valid", "publics", "alpha", "opening", "q_alpha",
                                       "a_z_beta", "c_z_alpha")] + \
               [("kind3", h) for h in ("valid", "publics", "blinding", "q_prime_beta",
                                       "b_z_alpha")] + \
               [("kind6", h) for h in ("valid", "publics", "q_beta")] + \
               [("kind2_sequential", h) for h in ("valid", "q_beta")]


@pytest.mark.parametrize("kind,how", VERIFY_CASES)
def test_verifiers_agree(jax_proofs, kind, how):
    """Port and JAX decide alike on valid and tampered kind-2/3/6 proofs; a
    v3 (kind 6) proof is bound to its circuit digest; Z_H on a sequential
    domain is prod (x - i)."""
    jr, proof = jax_proofs[kind]
    pr = port.multiplication_gates_circuit(jr.m, jr.modulus)
    bad = _tamper(proof, how, Q)
    blob = bad.to_bytes()
    publics = [2] if how == "publics" else [1]
    jax_check = jax_verifier.verify_r1cs_zk if kind == "kind3" else jax_verifier.verify_r1cs
    check = port.verify_r1cs_zk if kind == "kind3" else port.verify_r1cs
    theirs = jax_check(jax_deserialize(blob), publics, jr)
    assert check(port.deserialize_any(blob), publics, pr) is theirs is (how == "valid")


@pytest.mark.parametrize("seed", [None, 11])
def test_polynomial_matches_jax(seed):
    coeffs = [5, Q - 1, 123456789, 0, 42]
    mine, theirs = Polynomial(coeffs, Q), JaxPolynomial(coeffs, Q)
    assert mine.evaluate(987654321) == theirs.evaluate(987654321)
    assert mine.add(Polynomial([1, 2], Q)).coeffs == theirs.add(JaxPolynomial([1, 2], Q)).coeffs
    if seed is not None:
        assert Polynomial.random_blinding(6, Q, seed).coeffs == \
            JaxPolynomial.random_blinding(6, Q, seed).coeffs


def test_eval_opening_matches_jax(jax_proofs):
    _jr, proof = jax_proofs["kind2_opening"]
    op, alpha = proof.opening_alpha, proof.challenge_alpha.alpha
    assert verifier.verify_eval_opening(op, alpha, Q) is \
        jax_verifier._verify_eval_opening(op, alpha, Q) is True
    bad = dataclasses.replace(op, evaluation=(op.evaluation + 1) % Q)
    assert verifier.verify_eval_opening(bad, alpha, Q) is \
        jax_verifier._verify_eval_opening(bad, alpha, Q) is False


SIGNATURES = [
    (port.prove_r1cs_batched, J.prove_r1cs_batched),
    (port.prove_r1cs_stream, jax_stream),
    (port.prove_r1cs_succinct, J.prove_r1cs_succinct),
    (succinct_batch.prove_r1cs_succinct_batch, J.prove_r1cs_succinct_batch),
    (port.verify_r1cs, jax_verifier.verify_r1cs),
    (port.verify_r1cs_zk, jax_verifier.verify_r1cs_zk),
    (succinct.verify_r1cs_succinct, J.verify_r1cs_succinct),
    (port.deserialize_any, jax_deserialize),
    (port.prove_r1cs_succinct_aggregate, J.prove_r1cs_succinct_aggregate),
    (port.verify_r1cs_succinct_aggregate, J.verify_r1cs_succinct_aggregate),
    (port.prove_r1cs_compact, J.prove_r1cs_compact),
    (port.verify_r1cs_compact, J.verify_r1cs_compact),
    (port.prove_r1cs_checked, jax_checks.prove_r1cs_checked),
    (port.verify_r1cs_checked, jax_checks.verify_r1cs_checked),
    (artifacts.statement_digest, jax_artifacts.statement_digest),
    (port.ProofStore.save, jax_artifacts.ProofStore.save),
    (port.ProofStore.verify_all, jax_artifacts.ProofStore.verify_all),
    (port.ProofStore.missing_statements, jax_artifacts.ProofStore.missing_statements),
    (prover_batched.assemble_proofs, J.prover_batched._assemble_proofs),
    (port.prove_r1cs_succinct_stream, J.prove_r1cs_succinct_stream),
    (port.succinct_view, J.proof.succinct.succinct_view),
    (port.simulate_succinct_view, J.proof.succinct.simulate_succinct_view),
    (port.setup, J.setup),
    (port.prove_simple, J.prove_simple),
    (port.prove_zk, J.prove_zk),
    (port.simulate_proof, J.simulate_proof),
    (port.prove_r1cs, J.prove_r1cs),
    (port.prove_r1cs_zk, J.prove_r1cs_zk),
    (port.verify_simple, jax_verifier.verify_simple),
    (port.verify_r1cs_with_context, jax_verifier.verify_r1cs_with_context),
    (port.commit, J.commit),
    (port.verify_opening, J.verify_opening),
    (port.linear_combine, J.linear_combine),
    (port.R1CS.compute_quotient_poly, J.R1CS.compute_quotient_poly),
]


@pytest.mark.parametrize("ours,theirs", SIGNATURES, ids=lambda f: f.__qualname__)
def test_signature_matches_jax(ours, theirs):
    """Same parameter names, order, kinds and defaults as the JAX entry
    point, up to the port's trailing ``device``."""
    mine = list(inspect.signature(ours).parameters.values())
    if mine and mine[-1].name == "device":
        mine = mine[:-1]
    shape = lambda ps: [(p.name, p.kind, p.default) for p in ps]
    assert shape(mine) == shape(inspect.signature(theirs).parameters.values())


def test_zk_kind7_refused_with_its_queue_item(setup):
    """ZK kind 7 over the 44-bit field, once refused, now takes the host
    route: the single and the batch prover give the JAX package's bytes,
    and the proofs verify."""
    jax_ctx, jr, ctx, pr, ws = setup
    fast = dict(fri_params=JaxFriParams(3, 8))
    theirs = J.prove_r1cs_succinct(jr, ws[0], jax_ctx, 1, True, blinding_seed=2, **fast)
    mine = port.prove_r1cs_succinct(pr, ws[0], ctx, 1, True, port.FriParams(3, 8),
                                    blinding_seed=2, device="cpu")
    assert mine.to_bytes() == theirs.to_bytes()
    batch = port.prove_r1cs_succinct_batch(pr, ws[:1], ctx, [1], True, port.FriParams(3, 8),
                                           blinding_seeds=[2], device="cpu")
    assert batch[0].to_bytes() == theirs.to_bytes()
    assert port.verify_r1cs_succinct(mine, pr.public_inputs(ws[0]), pr,
                                     min_params=port.FriParams(3, 8))
