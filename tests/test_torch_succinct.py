"""The port's kind-7 prover and verifier against the JAX package.

``prove_r1cs_succinct_batch(device="cpu")`` (every kernel as its plain
twin) must give the bytes of the JAX ``prove_r1cs_succinct_batch(...,
device_lde=False)`` (whose device route gives the same bytes by
``tests/test_succinct_batch.py``), and ``verify_r1cs_succinct`` must decide
as the JAX verifier does on valid and tampered proofs. Sizes follow
``tests/test_succinct.py``: m = 16 and 64, S = 3, ring n = 64, k = 1,
``FriParams(log_blowup=3, num_queries=8)``."""

import dataclasses

import numpy as np
import pytest

from lambda_snark_tpu import Params, Profile, SecurityLevel, setup
from lambda_snark_tpu import prove_r1cs_succinct as jax_prove_one
from lambda_snark_tpu import verify_r1cs_succinct as jax_verify
from lambda_snark_tpu.core.params import NTT_FRIENDLY_MODULUS, NTT_MODULUS
from lambda_snark_tpu.proof.fri import FriParams as JaxFriParams
from lambda_snark_tpu.proof.succinct import SuccinctProofR1CS as JaxProof
from lambda_snark_tpu.proof.succinct_batch import _gl_batch_frontend
from lambda_snark_tpu.proof.succinct_batch import prove_r1cs_succinct_batch as jax_prove
from lambda_snark_tpu.utils.artifacts import circuit_digest as jax_circuit_digest

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import (
    DomainError,
    InvalidWitnessError,
    SerializationError,
)
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.proof.fri import FriParams, _gl_powers, coset_offset
from lambda_snark_tpu_torch.proof.succinct import SuccinctProofR1CS, _check_instance
from lambda_snark_tpu_torch.proof.succinct_batch import _embed_and_eval
from lambda_snark_tpu_torch.proof.succinct_device import eval_device, quotient_lde_device
from lambda_snark_tpu_torch.utils.artifacts import circuit_digest

from test_succinct import mult_circuit, mult_witness

GL = NTT_MODULUS
Q45 = NTT_FRIENDLY_MODULUS
SEEDS = [11, 12, 13]
FAST = (3, 8, 64)


def _ctxs(q=GL, n=64):
    jax_ctx = setup(Params(SecurityLevel.BITS128, Profile.ring_b(n, 1, q, 3.19)))
    ours = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=n, k=1, q=q, sigma=3.19)))
    return jax_ctx, ours


@pytest.fixture(scope="module")
def ctxs():
    return _ctxs()


def _instance(m, q=GL):
    return (mult_circuit(m, q), port.multiplication_gates_circuit(m, q),
            [mult_witness(m, q, seed=i) for i in range(3)])


@pytest.fixture(scope="module")
def proved(ctxs):
    """(JAX circuit, port circuit, witnesses, JAX proofs, port proofs) at m = 16."""
    jax_ctx, ours = ctxs
    jr, pr, ws = _instance(16)
    theirs = jax_prove(jr, ws, jax_ctx, SEEDS, fri_params=JaxFriParams(*FAST), device_lde=False)
    mine = port.prove_r1cs_succinct_batch(pr, ws, ours, SEEDS, fri_params=FriParams(*FAST),
                                          device="cpu")
    return jr, pr, ws, theirs, mine


@pytest.mark.parametrize("m,q", [(16, GL), (64, GL), (16, Q45)])
def test_circuit_digest_matches_and_is_cached(m, q):
    jr, pr, _ws = _instance(m, q)
    assert circuit_digest(pr) == jax_circuit_digest(jr)
    before = circuit_digest(pr)
    pr.a.values[0] += 1  # an in-place mutation keeps the cached digest, as in JAX
    assert circuit_digest(pr) == before


def test_frontend_matches_jax_host_frontend(ctxs):
    jax_ctx, ours = ctxs
    jr, pr, ws = _instance(16)
    params = FriParams(*FAST)
    fe = _gl_batch_frontend(jr, ws, jax_ctx, SEEDS, False, JaxFriParams(*FAST), None, False)
    d_bound, n0, _omega = _check_instance(pr, params, 0)
    az, bz, cz = _embed_and_eval(pr, ws, "cpu")
    lde, comms, polys, forest = quotient_lde_device(az, bz, cz, n0, coset_offset(GL), ours,
                                                    SEEDS)
    assert np.array_equal(modarith.to_u64(lde), fe.cw)
    assert forest.roots == [r[0] for r in fe.roots]
    assert all(np.array_equal(a.words, b.words) for a, b in zip(comms, fe.commitments))
    assert np.array_equal(eval_device(polys, fe.alphas, fe.betas), fe.evals)


def test_batch_bytes_equal_jax_m16(proved):
    _jr, _pr, _ws, theirs, mine = proved
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]


@pytest.mark.parametrize("final_len", [64, 4])
def test_batch_bytes_equal_jax_m64(ctxs, final_len):
    """final_len 64 folds straight to the final polynomial; 4 commits three
    fold layers (their trees, roots and paths)."""
    jax_ctx, ours = ctxs
    jr, pr, ws = _instance(64)
    theirs = jax_prove(jr, ws, jax_ctx, SEEDS, fri_params=JaxFriParams(3, 8, final_len),
                       device_lde=False)
    mine = port.prove_r1cs_succinct_batch(pr, ws, ours, SEEDS,
                                          fri_params=FriParams(3, 8, final_len), device="cpu")
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]
    if final_len == 4:
        assert len(mine[0].fri.layer_roots) == 3


def test_single_equals_jax_single(ctxs):
    jax_ctx, ours = ctxs
    jr, pr, ws = _instance(16)
    theirs = jax_prove_one(jr, ws[1], jax_ctx, seed=5, fri_params=JaxFriParams(*FAST))
    mine = port.prove_r1cs_succinct(pr, ws[1], ours, 5, fri_params=FriParams(*FAST),
                                    device="cpu")
    assert mine.to_bytes() == theirs.to_bytes()


def test_wire_round_trip(proved):
    _jr, _pr, _ws, _theirs, mine = proved
    blob = mine[0].to_bytes()
    assert SuccinctProofR1CS.from_bytes(blob).to_bytes() == blob
    assert JaxProof.from_bytes(blob).to_bytes() == blob
    with pytest.raises(SerializationError):
        SuccinctProofR1CS.from_bytes(blob[:9] + bytes([3]) + blob[10:])
    with pytest.raises(SerializationError):
        SuccinctProofR1CS.from_bytes(blob[:-5])


def _tamper(proof, how: str, q: int):
    if how in ("a_alpha", "b_alpha", "c_alpha", "q_alpha", "a_beta", "q_beta"):
        return dataclasses.replace(proof, **{how: (getattr(proof, how) + 1) % q})
    if how == "consistent_lie":
        zh = (pow(proof.challenge_alpha.alpha, proof.m, q) - 1) % q
        a_new = (proof.a_alpha + 1) % q
        q_new = (a_new * proof.b_alpha - proof.c_alpha) * pow(zh, -1, q) % q
        return dataclasses.replace(proof, a_alpha=a_new, q_alpha=q_new)
    if how == "root":
        return dataclasses.replace(proof, input_root=bytes(32))
    fri = proof.fri
    q0 = fri.queries[0]
    if how == "final":
        final = (((fri.final_coeffs[0] + 1) % q,) + fri.final_coeffs[1:])
        return dataclasses.replace(proof, fri=dataclasses.replace(fri, final_coeffs=final))
    op0 = q0.input_openings[0]
    if how == "path":
        op0 = dataclasses.replace(op0, path=bytes(32) + op0.path[32:])
    elif how == "noncanonical":  # the Q oracle's lo value v, re-encoded as v + q
        vals = list(op0.values)
        assert vals[6] + q < 1 << 64
        vals[6] += q
        op0 = dataclasses.replace(op0, values=tuple(vals))
    else:  # the Q oracle's lo value
        vals = list(op0.values)
        vals[6] = (vals[6] + 1) % q
        op0 = dataclasses.replace(op0, values=tuple(vals))
    q0 = dataclasses.replace(q0, input_openings=(op0,) + q0.input_openings[1:])
    return dataclasses.replace(proof, fri=dataclasses.replace(
        fri, queries=(q0,) + fri.queries[1:]))


TAMPERS = ["a_alpha", "b_alpha", "c_alpha", "q_alpha", "a_beta", "q_beta",
           "consistent_lie", "root", "final", "path", "leaf_value", "noncanonical"]


@pytest.fixture(scope="module")
def zero_proved(ctxs):
    """The port's proof of the all-zero witness (x = y = z = 0) at m = 16,
    whose codewords are all 0: every opened value v has a second encoding
    v + q below 2^64. Its bytes equal the JAX package's."""
    jax_ctx, ours = ctxs
    jr, pr, _ws = _instance(16)
    zero = [1] + [0] * (pr.n - 1)
    mine = port.prove_r1cs_succinct_batch(pr, [zero], ours, SEEDS[:1],
                                          fri_params=FriParams(*FAST), device="cpu")[0]
    theirs = jax_prove(jr, [zero], jax_ctx, SEEDS[:1], fri_params=JaxFriParams(*FAST),
                       device_lde=False)[0]
    assert mine.to_bytes() == theirs.to_bytes()
    return mine


@pytest.mark.parametrize("how", TAMPERS)
def test_verifiers_agree_on_tampered(proved, how, request):
    jr, pr, ws, _theirs, mine = proved
    proof = request.getfixturevalue("zero_proved") if how == "noncanonical" else mine[0]
    if how == "noncanonical":
        assert port.verify_r1cs_succinct(proof, [1], pr, min_params=FriParams(*FAST))
    bad = _tamper(proof, how, GL)
    blob = bad.to_bytes()
    ours = port.verify_r1cs_succinct(SuccinctProofR1CS.from_bytes(blob), [1], pr,
                                     min_params=FriParams(*FAST))
    theirs = jax_verify(JaxProof.from_bytes(blob), [1], jr, min_params=JaxFriParams(*FAST))
    assert ours is False and theirs is False


@pytest.mark.parametrize("case", ["valid", "public_inputs", "weaker_params"])
def test_verifiers_agree(proved, case):
    jr, pr, ws, theirs, mine = proved
    for proof, jax_proof in zip(mine, theirs):
        publics = [1] if case != "public_inputs" else [2]
        floor = (3, 8 + (case == "weaker_params"), 64)
        ours = port.verify_r1cs_succinct(proof, publics, pr, min_params=FriParams(*floor))
        jax_ok = jax_verify(jax_proof, publics, jr, min_params=JaxFriParams(*floor))
        assert ours == jax_ok == (case == "valid")


@pytest.mark.parametrize("zk,q", [(False, Q45), (True, GL), (True, Q45)])
def test_port_verifies_jax_proofs_of_other_kinds(zk, q):
    """ZK proofs and the 44-bit field are not proved by the port, but its
    verifier accepts the JAX package's and rejects them tampered."""
    jax_ctx, _ours = _ctxs(q)
    jr, pr, ws = _instance(16, q)
    proof = jax_prove_one(jr, ws[0], jax_ctx, seed=3, zk=zk, fri_params=JaxFriParams(*FAST),
                          blinding_seed=9 if zk else None)
    mine = SuccinctProofR1CS.from_bytes(proof.to_bytes())
    assert port.verify_r1cs_succinct(mine, [1], pr, min_params=FriParams(*FAST))
    for how in ("q_beta", "path"):
        assert not port.verify_r1cs_succinct(_tamper(mine, how, q), [1], pr,
                                             min_params=FriParams(*FAST))


def test_invalid_witness_rejected(ctxs):
    _jax_ctx, ours = ctxs
    _jr, pr, ws = _instance(16)
    bad = list(ws[1])
    bad[1] = (bad[1] + 1) % GL
    with pytest.raises(InvalidWitnessError, match="witness 1"):
        port.prove_r1cs_succinct_batch(pr, [ws[0], bad], ours, [1, 2],
                                       fri_params=FriParams(*FAST), device="cpu")


def test_non_goldilocks_circuit_rejected():
    """A circuit off the Goldilocks device route proves on the host, as the
    JAX package's batch does (the 44-bit field here); one over a field with
    no 2-adic subgroup is rejected by both packages."""
    jax_ctx, ours = _ctxs(Q45)
    jr, pr, ws = _instance(16, Q45)
    theirs = jax_prove(jr, ws, jax_ctx, SEEDS, fri_params=JaxFriParams(*FAST))
    mine = port.prove_r1cs_succinct_batch(pr, ws, ours, SEEDS, fri_params=FriParams(*FAST),
                                          device="cpu")
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]
    composite = 17592186044417  # the test-vector modulus: no registered subgroup
    jax_ctx, ours = _ctxs(composite)
    jr, pr, ws = _instance(4, composite)
    with pytest.raises(Exception) as err:
        jax_prove(jr, ws, jax_ctx, SEEDS, fri_params=JaxFriParams(*FAST))
    assert type(err.value).__name__ == "DomainError"
    with pytest.raises(DomainError) as mine:
        port.prove_r1cs_succinct_batch(pr, ws, ours, SEEDS, fri_params=FriParams(*FAST),
                                       device="cpu")
    assert str(mine.value) == str(err.value)


def test_ring_degree_below_m_rejected():
    """At ring degree n < m a random witness's quotient (m - 1 words) does
    not fit one ring element: both packages raise CommitmentError."""
    jax_ctx, small = _ctxs(n=32)
    jr, pr, ws = _instance(64)
    with pytest.raises(Exception) as theirs:
        jax_prove(jr, ws, jax_ctx, SEEDS, fri_params=JaxFriParams(*FAST))
    assert type(theirs.value).__name__ == "CommitmentError"
    with pytest.raises(port.CommitmentError, match="message length 63 exceeds ring degree 32"):
        port.prove_r1cs_succinct_batch(pr, ws, small, SEEDS, fri_params=FriParams(*FAST),
                                       device="cpu")
    assert str(theirs.value) == "message length 63 exceeds ring degree 32"


@pytest.mark.parametrize("base,n,scale", [(7, 1, 1), (GL - 2, 37, 5), (3, 64, GL - 1)])
def test_gl_powers_match_python_ints(base, n, scale):
    want = [scale * pow(base, i, GL) % GL for i in range(n)]
    assert [int(v) for v in _gl_powers(base, n, scale=scale)] == want


def test_convert_proofs_and_digests(proved):
    from lambda_snark_tpu.ops import keccak_pallas as kp

    from lambda_snark_tpu_torch.convert import (
        digests_from_jax_words,
        digests_to_jax_words,
        fri_proof_from_jax,
        succinct_proof_from_jax,
    )
    from lambda_snark_tpu_torch.ops import keccak

    _jr, _pr, _ws, theirs, mine = proved
    assert fri_proof_from_jax(theirs[1].fri) == mine[1].fri
    assert succinct_proof_from_jax(theirs[2]).to_bytes() == mine[2].to_bytes()
    level = np.random.default_rng(8).integers(0, 1 << 32, size=(8, 2, 16), dtype=np.uint32)
    ours = digests_from_jax_words(level)
    assert np.array_equal(digests_to_jax_words(ours), level)
    want = np.asarray(kp.hash_nodes(level[..., 0::2], level[..., 1::2]))
    assert np.array_equal(digests_to_jax_words(keccak.hash_nodes(ours)), want)


def test_lwe_context_carried_across():
    from lambda_snark_tpu_torch.convert import lwe_context_from_jax

    jax_ctx = setup(Params(SecurityLevel.BITS128, Profile.ring_b(8192, 1, GL, 3.19)))
    ours = lwe_context_from_jax(jax_ctx)
    assert (ours.n, ours.k, ours.q, ours.context_seed) == (8192, 1, GL, jax_ctx.context_seed)
    assert np.array_equal(ours.a_hat, jax_ctx.a_hat)
