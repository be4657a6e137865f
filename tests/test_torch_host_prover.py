"""The port's host golden path against the JAX package, on the CPU.

``r1cs/poly`` and the R1CS quotient pipeline on Python ints, the host
Module-LWE commitment (``commit.lwe``: commit, openings, linear
combinations, the Gaussian sampler and its ChaCha20 draws), the host
provers of ``prover`` (kinds 1, 2, 6 and 3) and the verifiers
``verify_simple`` and ``verify_r1cs_with_context``, kind 1 through
``deserialize_any``, and the example circuits: every value and every proof
byte equal to the JAX package's on the same inputs and seeds, and the
healthcare quotient equal to ``artifacts/r1cs/healthcare_quotient.json``."""

import dataclasses
import json
import os
import random

import numpy as np
import pytest

import lambda_snark_tpu as J
from lambda_snark_tpu import prover as jax_prover
from lambda_snark_tpu import verifier as jax_verifier
from lambda_snark_tpu.circuits import examples as jax_examples
from lambda_snark_tpu.circuits import healthcare as jax_healthcare
from lambda_snark_tpu.circuits import simple as jax_simple
from lambda_snark_tpu.circuits import test_vectors as jax_tv
from lambda_snark_tpu.commit import lwe as jax_lwe
from lambda_snark_tpu.ops import gaussian as jax_gaussian
from lambda_snark_tpu.proof.types import deserialize_any as jax_deserialize
from lambda_snark_tpu.r1cs import poly as jax_poly
from lambda_snark_tpu.r1cs.domain import Domain as JaxDomain
from lambda_snark_tpu.utils.chacha import ChaCha20Rng as JaxRng

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch import prover, verifier
from lambda_snark_tpu_torch.circuits import examples, healthcare, simple, test_vectors
from lambda_snark_tpu_torch.commit import lwe
from lambda_snark_tpu_torch.core.errors import (
    CommitmentError,
    InvalidInputError,
    InvalidWitnessError,
)
from lambda_snark_tpu_torch.ops import gaussian
from lambda_snark_tpu_torch.r1cs import poly
from lambda_snark_tpu_torch.r1cs.domain import Domain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q45 = port.NTT_FRIENDLY_MODULUS
GL = port.NTT_MODULUS
LEG = port.LEGACY_MODULUS
HC = 2013265921  # the healthcare certificate field


def _rand_poly(rng, q, n):
    return [rng.randrange(q) for _ in range(n)]


# --- r1cs/poly ---------------------------------------------------------------------

POLY_CASES = [(q, la, lb) for q in (Q45, GL, LEG) for la, lb in ((1, 1), (5, 3), (8, 13))]


@pytest.mark.parametrize("q,la,lb", POLY_CASES)
def test_poly_arithmetic_matches_jax(q, la, lb):
    rng = random.Random(q ^ la ^ (lb << 8))
    a, b = _rand_poly(rng, q, la), _rand_poly(rng, q, lb) + [0, 0]
    x, s = rng.randrange(q), rng.randrange(q)
    for name in ("poly_add", "poly_sub", "poly_mul"):
        assert getattr(poly, name)(a, b, q) == getattr(jax_poly, name)(a, b, q), name
    assert poly.poly_mul_scalar(a, s, q) == jax_poly.poly_mul_scalar(a, s, q)
    assert poly.poly_eval(b, x, q) == jax_poly.poly_eval(b, x, q)
    assert poly.poly_mul([], b, q) == jax_poly.poly_mul([], b, q) == [0]


@pytest.mark.parametrize("q,m", [(Q45, 8), (Q45, 64), (GL, 16), (GL, 128), (LEG, 10),
                                 (HC, 10), (Q45, 12)])
def test_interpolation_and_vanishing_division_match_jax(q, m):
    rng = random.Random(m * 31 + q % 97)
    evals = _rand_poly(rng, q, m)
    ours, theirs = Domain.select(m, q), JaxDomain.select(m, q)
    assert (ours.kind, ours.omega) == (theirs.kind, theirs.omega)
    assert ours.points() == theirs.points()
    assert ours.vanishing_poly() == theirs.vanishing_poly()
    coeffs = poly.lagrange_interpolate(evals, ours)
    assert coeffs == jax_poly.lagrange_interpolate(evals, theirs)
    assert [poly.poly_eval(coeffs, x, q) for x in ours.points()] == evals
    multiple = poly.poly_mul(ours.vanishing_poly(), _rand_poly(rng, q, 5), q)
    assert poly.poly_div_vanishing(multiple, ours) == jax_poly.poly_div_vanishing(multiple,
                                                                                 theirs)
    bad = poly.poly_add(multiple, [1], q)
    with pytest.raises(InvalidWitnessError, match="remainder"):
        poly.poly_div_vanishing(bad, ours)


@pytest.mark.parametrize("q,n", [(Q45, 8), (Q45, 4096), (GL, 2), (GL, 64)])
def test_ntt_matches_jax(q, n):
    rng = random.Random(n)
    x = _rand_poly(rng, q, n)
    omega = Domain.select(n, q).omega
    fwd = poly.ntt_forward(x, q, omega)
    assert fwd == jax_poly.ntt_forward(x, q, omega)
    assert poly.ntt_inverse(fwd, q, omega) == jax_poly.ntt_inverse(fwd, q, omega) == x


def test_lagrange_basis_matches_jax():
    pts = [3, 7, 11, 19]
    for i in range(4):
        assert poly._lagrange_basis(i, pts, LEG) == jax_poly._lagrange_basis(i, pts, LEG)


# --- R1CS host methods ------------------------------------------------------------


def _circuits():
    """(name, JAX circuit, port circuit, witness) over every domain kind."""
    hc_w = jax_healthcare.high_risk_witness(LEG)
    out = [("healthcare", jax_healthcare.build_healthcare_circuit(LEG),
            healthcare.build_healthcare_circuit(LEG), hc_w),
           ("healthcare_hc", jax_healthcare.build_healthcare_circuit(HC),
            healthcare.build_healthcare_circuit(HC), jax_healthcare.high_risk_witness(HC)),
           ("range", jax_examples.range_proof_circuit(LEG), examples.range_proof_circuit(LEG),
            jax_examples.range_proof_witness(LEG, 201))]
    for q, m in ((Q45, 16), (GL, 32), (LEG, 8)):
        out.append((f"gates_{m}", jax_examples.multiplication_gates_circuit(m, q),
                    examples.multiplication_gates_circuit(m, q),
                    jax_examples.multiplication_gates_witness(m, q, seed=m)))
    return out


CIRCUITS = _circuits()


@pytest.mark.parametrize("case", CIRCUITS, ids=lambda c: c[0])
def test_r1cs_host_methods_match_jax(case):
    _name, jr, pr, w = case
    assert pr.domain.kind == jr.domain.kind
    pr.validate()
    assert pr.is_satisfied(w) is jr.is_satisfied(w) is True
    assert pr.interpolations(w) == jr.interpolations(w)
    quotient = pr.compute_quotient_poly(w)
    assert quotient == jr.compute_quotient_poly(w) == pr.compute_quotient_poly_longdiv(w)
    assert pr._quotient_odd_coset(w) == jr._quotient_odd_coset(w)
    x = 123456789
    assert pr.eval_poly(quotient, x) == jr.eval_poly(quotient, x)
    assert (pr.total_nnz(), pr.density()) == (jr.total_nnz(), jr.density())
    bad = list(w)
    bad[-1] = (bad[-1] + 1) % pr.modulus
    assert pr.is_satisfied(bad) is jr.is_satisfied(bad) is False
    with pytest.raises(InvalidWitnessError):
        pr.compute_quotient_poly(bad)


def test_healthcare_quotient_equals_artifact():
    with open(os.path.join(REPO, "artifacts", "r1cs", "healthcare_quotient.json")) as f:
        art = json.load(f)
    r1cs = healthcare.build_healthcare_circuit(art["modulus"])
    w = healthcare.high_risk_witness(art["modulus"])
    assert (r1cs.m, r1cs.n, r1cs.l) == (art["m"], art["n"], art["l"])
    assert w == art["witness"]
    az, bz, cz = r1cs.compute_constraint_evals(w)
    assert (az, bz, cz) == (art["a_evals"], art["b_evals"], art["c_evals"])
    assert r1cs.compute_quotient_poly(w) == art["quotient"]


def test_healthcare_quotient_in_the_certificate_field():
    r1cs = healthcare.build_healthcare_circuit(HC)
    assert r1cs.compute_quotient_poly(healthcare.high_risk_witness(HC)) == [
        536591292, 151123296, 1268815861, 1689701572, 1641423289,
        1200004351, 1233086762, 1322307170, 1694015127]


def test_r1cs_validate_rejects():
    small = examples.multiplication_gates_circuit(2, 1 << 20)
    with pytest.raises(port.InvalidDimensionsError, match="too small"):
        small.validate()


# --- Gaussian sampler and ChaCha20 draws ------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_gaussian_samplers_match_jax(seed):
    cdf = gaussian.build_cdf(3.19)
    ours, theirs = port.ChaCha20Rng.from_u64(seed), JaxRng.from_u64(seed)
    ours.next_u32()  # an odd offset into the keystream first
    theirs.next_u32()
    assert np.array_equal(gaussian.sample_signed(ours, cdf, 37),
                          jax_gaussian.sample_signed(theirs, cdf, 37))
    assert np.array_equal(gaussian.sample_signed_vectorized(ours, cdf, 500),
                          jax_gaussian.sample_signed_vectorized(theirs, cdf, 500))
    assert np.array_equal(ours.fill_u64(9), theirs.fill_u64(9))
    assert ours.next_u64() == theirs.next_u64()
    samples = gaussian.sample_signed_vectorized(ours, cdf, 64)
    assert np.array_equal(gaussian.to_field(samples, Q45), jax_gaussian.to_field(samples, Q45))


# --- the host commitment ----------------------------------------------------------


def _ctx_pair(n=64, k=2, q=Q45, context_seed=3):
    jax_ctx = J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(n, k, q, 3.19)),
                      context_seed=context_seed)
    ours = prover.setup(port.Params(port.SecurityLevel.BITS128,
                                    port.Profile.ring_b(n=n, k=k, q=q, sigma=3.19)),
                        context_seed=context_seed)
    return jax_ctx, ours


@pytest.fixture(scope="module")
def ctxs():
    return _ctx_pair()


@pytest.mark.parametrize("n,k,msg_len", [(64, 2, 0), (64, 2, 64), (256, 1, 100),
                                         (4096, 2, 4096)])
def test_commit_matches_jax(n, k, msg_len):
    jax_ctx, ours = _ctx_pair(n, k)
    msg = [(i * 7919 + 1) % Q45 for i in range(msg_len)]
    c, op = lwe.commit(ours, msg, 0xCAFE)
    jc, jop = jax_lwe.commit(jax_ctx, msg, 0xCAFE)
    assert np.array_equal(c.words, jc.words)
    assert np.array_equal(op.s, jop.s) and np.array_equal(op.e, jop.e)
    assert np.array_equal(op.message, jop.message)
    assert (op.norm_bound, op.seed) == (jop.norm_bound, jop.seed)
    assert lwe.verify_opening(ours, c, op) is jax_lwe.verify_opening(jax_ctx, jc, jop) is True


def test_commit_batch_and_randomness_match_jax(ctxs):
    jax_ctx, ours = ctxs
    msgs = [[1, 2, 3], list(range(64)), np.arange(10, dtype=np.uint64)]
    seeds = [1, 2, (1 << 64) - 1]
    cs, ops = lwe.commit_batch(ours, msgs, seeds)
    jcs, _jops = jax_lwe.commit_batch(jax_ctx, msgs, seeds)
    assert all(np.array_equal(a.words, b.words) for a, b in zip(cs, jcs))
    for msg, seed, c in zip(msgs, seeds, cs):
        assert lwe.commit(ours, msg, seed)[0] == c
    ss, es = lwe.randomness_batch(ours, seeds)
    jss, jes = jax_lwe.randomness_batch(jax_ctx, seeds)
    assert np.array_equal(ss, jss) and np.array_equal(es, jes)
    s0, e0 = ours._randomness(seeds[0])
    assert np.array_equal(s0, jax_ctx._randomness(seeds[0])[0])
    assert lwe.commit_batch(ours, [], []) == ([], [])


@pytest.mark.parametrize("how", ["valid", "message", "s", "norm", "shape"])
def test_verify_opening_matches_jax(ctxs, how):
    jax_ctx, ours = ctxs
    c, op = lwe.commit(ours, [5, 6, 7], 11)
    jc, jop = jax_lwe.commit(jax_ctx, [5, 6, 7], 11)
    tweak = {
        "valid": {},
        "message": {"message": np.where(np.arange(64) == 0, op.message + np.uint64(1),
                                        op.message)},
        "s": {"s": op.s + (np.arange(op.s.size).reshape(op.s.shape) == 3)},
        "norm": {"norm_bound": 0},
        "shape": {"e": op.e[:-1]},
    }[how]
    mine = lwe.verify_opening(ours, c, dataclasses.replace(op, **tweak))
    theirs = jax_lwe.verify_opening(jax_ctx, jc, dataclasses.replace(jop, **tweak))
    assert mine is theirs is (how == "valid")


def test_linear_combine_matches_jax(ctxs):
    jax_ctx, ours = ctxs
    pairs = [lwe.commit(ours, [i + 1, 2 * i], 20 + i) for i in range(3)]
    jpairs = [jax_lwe.commit(jax_ctx, [i + 1, 2 * i], 20 + i) for i in range(3)]
    coeffs = [3, lwe.RING_MODULUS - 2, 1]
    combined, opening = lwe.linear_combine(ours, [c for c, _ in pairs], coeffs,
                                           [o for _, o in pairs])
    jcombined, jopening = jax_lwe.linear_combine(jax_ctx, [c for c, _ in jpairs], coeffs,
                                                 [o for _, o in jpairs])
    assert np.array_equal(combined.words, jcombined.words)
    assert np.array_equal(opening.message, jopening.message)
    assert np.array_equal(opening.s, jopening.s) and opening.norm_bound == jopening.norm_bound
    assert lwe.verify_opening(ours, combined, opening)
    alone = lwe.linear_combine(ours, [c for c, _ in pairs], coeffs)
    assert alone == combined
    with pytest.raises(CommitmentError, match="small coefficients"):
        lwe.linear_combine(ours, [pairs[0][0]], [1 << 40], [pairs[0][1]])
    with pytest.raises(InvalidInputError):
        lwe.linear_combine(ours, [], [])


def test_commitment_bytes_and_errors(ctxs):
    jax_ctx, ours = ctxs
    c, _op = lwe.commit(ours, [9, 8, 7], 4)
    blob = c.to_bytes()
    assert lwe.Commitment.from_bytes(blob) == c
    assert np.array_equal(jax_lwe.Commitment.from_bytes(blob).words, c.words)
    assert c.digest() == jax_lwe.Commitment(c.words).digest()
    assert c.as_words() == jax_lwe.Commitment(c.words).as_words()
    with pytest.raises(InvalidInputError):
        lwe.Commitment.from_bytes(blob[:-1])
    with pytest.raises(CommitmentError, match="exceeds ring degree"):
        lwe.commit(ours, [1] * 65, 1)
    x = np.array([-3, 0, 5], dtype=np.int64)
    assert np.array_equal(lwe._signed_to_ring(x), jax_lwe._signed_to_ring(x))


# --- host provers and verifiers ---------------------------------------------------


@pytest.fixture(scope="module")
def hc():
    jax_ctx, ours = _ctx_pair(q=LEG)
    jr = jax_healthcare.build_healthcare_circuit(LEG)
    pr = healthcare.build_healthcare_circuit(LEG)
    return jax_ctx, ours, jr, pr, healthcare.high_risk_witness(LEG)


@pytest.mark.parametrize("kw", [{}, {"with_opening": True}, {"bind_circuit": True},
                                {"with_opening": True, "bind_circuit": True}],
                         ids=["kind2", "opening", "kind6", "opening_kind6"])
def test_prove_r1cs_bytes_equal_jax(hc, kw):
    jax_ctx, ours, jr, pr, w = hc
    mine = prover.prove_r1cs(pr, w, ours, 0xDEADBEEF, **kw)
    theirs = jax_prover.prove_r1cs(jr, w, jax_ctx, 0xDEADBEEF, **kw)
    assert mine.to_bytes() == theirs.to_bytes()
    assert port.verify_r1cs(mine, [1, 3], pr)
    assert port.deserialize_any(mine.to_bytes()).to_bytes() == mine.to_bytes()


@pytest.mark.parametrize("how", ["seed", "rng"])
def test_prove_r1cs_zk_bytes_equal_jax(hc, how):
    jax_ctx, ours, jr, pr, w = hc
    if how == "seed":
        mine = prover.prove_r1cs_zk(pr, w, ours, 5, blinding_seed=6)
        theirs = jax_prover.prove_r1cs_zk(jr, w, jax_ctx, 5, blinding_seed=6)
    else:
        mine = prover.prove_r1cs_zk(pr, w, ours, 5, rng=port.ChaCha20Rng.from_u64(8))
        theirs = jax_prover.prove_r1cs_zk(jr, w, jax_ctx, 5, rng=JaxRng.from_u64(8))
    assert mine.to_bytes() == theirs.to_bytes()
    assert port.verify_r1cs_zk(mine, [1, 3], pr)


@pytest.mark.parametrize("m,q", [(16, Q45), (8, GL)])
def test_host_prover_equals_batched_prover(m, q):
    """The golden path and the batched prover (kind 2, plain twins) agree
    where both apply: JAX pins its batched prover to its host prover, and
    each of the port's to JAX's."""
    jax_ctx, ours = _ctx_pair(n=64, k=2, q=q)
    jr = jax_examples.multiplication_gates_circuit(m, q)
    pr = examples.multiplication_gates_circuit(m, q)
    w = jax_examples.multiplication_gates_witness(m, q, seed=3)
    mine = prover.prove_r1cs(pr, w, ours, 77)
    assert mine.to_bytes() == jax_prover.prove_r1cs(jr, w, jax_ctx, 77).to_bytes()
    assert port.verify_r1cs(mine, pr.public_inputs(w), pr)


@pytest.mark.parametrize("name", ["simple", "zk", "simulate"])
def test_simple_provers_bytes_equal_jax(ctxs, name):
    jax_ctx, ours = ctxs
    witness, public = [3, 1, 4, 1, 5, 9, 2, 6], [3, 1]
    if name == "simple":
        mine = prover.prove_simple(witness, public, ours, Q45, 42)
        theirs = jax_prover.prove_simple(witness, public, jax_ctx, Q45, 42)
    elif name == "zk":
        mine = prover.prove_zk(witness, public, ours, Q45, 42, blinding_seed=43)
        theirs = jax_prover.prove_zk(witness, public, jax_ctx, Q45, 42, blinding_seed=43)
    else:
        mine = prover.simulate_proof(7, public, ours, Q45, 42, sim_seed=44)
        theirs = jax_prover.simulate_proof(7, public, jax_ctx, Q45, 42, sim_seed=44)
    blob = mine.to_bytes()
    assert blob == theirs.to_bytes() and blob[8] == 1
    decoded = port.deserialize_any(blob)
    assert isinstance(decoded, port.Proof) and decoded.to_bytes() == blob
    assert jax_deserialize(blob).to_bytes() == blob
    assert verifier.verify_simple(decoded, public, Q45) is \
        jax_verifier.verify_simple(jax_deserialize(blob), public, Q45) is True
    with pytest.raises(InvalidInputError):
        prover.prove_simple([], public, ours, Q45, 1)


@pytest.mark.parametrize("how", ["valid", "publics", "evaluation", "alpha", "truncated"])
def test_verify_simple_matches_jax(ctxs, how):
    jax_ctx, ours = ctxs
    proof = prover.prove_simple([2, 7, 1, 8], [2], ours, Q45, 9)
    public = [3] if how == "publics" else [2]
    if how == "evaluation":
        proof = dataclasses.replace(proof, opening=dataclasses.replace(
            proof.opening, evaluation=(proof.opening.evaluation + 1) % Q45))
    elif how == "alpha":
        proof = dataclasses.replace(proof, challenge=dataclasses.replace(
            proof.challenge, alpha=(proof.challenge.alpha + 1) % Q45))
    elif how == "truncated":
        proof = dataclasses.replace(proof, opening=dataclasses.replace(
            proof.opening, witness=proof.opening.witness[:1]))
    blob = proof.to_bytes()
    mine = verifier.verify_simple(port.deserialize_any(blob), public, Q45)
    theirs = jax_verifier.verify_simple(jax_deserialize(blob), public, Q45)
    assert mine is theirs is (how == "valid")


@pytest.mark.parametrize("how", ["valid", "stub", "commitment", "coefficient", "seed",
                                 "q_alpha"])
def test_verify_r1cs_with_context_matches_jax(hc, how):
    jax_ctx, ours, jr, pr, w = hc
    proof = prover.prove_r1cs(pr, w, ours, 31, with_opening=how != "stub")
    if how == "commitment":
        words = proof.commitment_q.words.copy()
        words[0] ^= np.uint64(1)
        proof = dataclasses.replace(proof, commitment_q=lwe.Commitment(words))
    elif how in ("coefficient", "seed"):
        wit = list(proof.opening_alpha.witness)
        wit[1 if how == "coefficient" else 0] += 1
        proof = dataclasses.replace(
            proof, opening_alpha=dataclasses.replace(proof.opening_alpha, witness=wit),
            opening_beta=dataclasses.replace(proof.opening_beta, witness=wit))
    elif how == "q_alpha":
        proof = dataclasses.replace(proof, q_alpha=(proof.q_alpha + 1) % LEG)
    blob = proof.to_bytes()
    mine = verifier.verify_r1cs_with_context(port.deserialize_any(blob), [1, 3], pr, ours)
    theirs = jax_verifier.verify_r1cs_with_context(jax_deserialize(blob), [1, 3], jr, jax_ctx)
    assert mine is theirs is (how == "valid")


def test_deserialize_any_kind1_rejects_truncation(ctxs):
    _jax_ctx, ours = ctxs
    blob = prover.prove_simple([1, 2, 3], [1], ours, Q45, 5).to_bytes()
    for cut in (9, 20, len(blob) - 1):
        with pytest.raises(port.SerializationError):
            port.deserialize_any(blob[:cut])


# --- circuits -----------------------------------------------------------------------


def _same_circuit(pr, jr):
    assert (pr.m, pr.n, pr.l, pr.modulus, pr.domain.kind) == \
        (jr.m, jr.n, jr.l, jr.modulus, jr.domain.kind)
    for a, b in ((pr.a, jr.a), (pr.b, jr.b), (pr.c, jr.c)):
        assert a.coo() == b.coo()
    assert port.circuit_digest(pr) == J.utils.artifacts.circuit_digest(jr)


@pytest.mark.parametrize("name", sorted(simple.ALL_EXAMPLES))
def test_simple_gallery_matches_jax(name):
    pr, pw = simple.ALL_EXAMPLES[name]()
    jr, jw = jax_simple.ALL_EXAMPLES[name]()
    _same_circuit(pr, jr)
    assert pw == jw and pr.is_satisfied(pw)


def test_example_circuits_match_jax():
    pr, pw = examples.multiplication_circuit(LEG)
    jr, jw = jax_examples.multiplication_circuit(LEG)
    _same_circuit(pr, jr)
    assert pw == jw
    for bits, value in ((8, 201), (4, 9)):
        _same_circuit(examples.range_proof_circuit(LEG, bits),
                      jax_examples.range_proof_circuit(LEG, bits))
        assert examples.range_proof_witness(LEG, value, bits) == \
            jax_examples.range_proof_witness(LEG, value, bits)
    with pytest.raises(InvalidInputError):
        examples.range_proof_witness(LEG, 256)


@pytest.mark.parametrize("which", ["high", "low"])
def test_healthcare_circuit_matches_jax(which):
    _same_circuit(healthcare.build_healthcare_circuit(LEG),
                  jax_healthcare.build_healthcare_circuit(LEG))
    fn = f"{which}_risk_witness"
    assert getattr(healthcare, fn)(LEG) == getattr(jax_healthcare, fn)(LEG)


@pytest.mark.parametrize("index", [0, 1, 2])
def test_test_vectors_match_jax(tv_dir, index):
    tv = test_vectors.load_test_vector(index, tv_dir)
    jtv = jax_tv.load_test_vector(index, tv_dir)
    _same_circuit(tv.r1cs, jtv.r1cs)
    assert (tv.witness, tv.public_inputs, tv.seed) == (jtv.witness, jtv.public_inputs, jtv.seed)
    assert tv.raw_json_witness == jtv.raw_json_witness
    ours = prover.setup(tv.params)
    theirs = J.setup(jtv.params)
    assert prover.prove_r1cs(tv.r1cs, tv.witness, ours, tv.seed).to_bytes() == \
        jax_prover.prove_r1cs(jtv.r1cs, jtv.witness, theirs, jtv.seed).to_bytes()
    if index:
        assert test_vectors.expected_evals(index, tv_dir) == jax_tv.expected_evals(index, tv_dir)


def test_test_vector_root_default(monkeypatch, tmp_path):
    # No default directory: the root comes from the caller or the environment.
    monkeypatch.delenv(test_vectors.TV_ROOT_ENV, raising=False)
    with pytest.raises(ValueError, match=test_vectors.TV_ROOT_ENV):
        test_vectors.load_test_vector(1)
    with pytest.raises(ValueError, match=test_vectors.TV_ROOT_ENV):
        test_vectors.expected_evals(1)
    assert test_vectors.tv_root(str(tmp_path)) == str(tmp_path)
    monkeypatch.setenv(test_vectors.TV_ROOT_ENV, str(tmp_path))
    assert test_vectors.tv_root() == str(tmp_path)
    with pytest.raises(FileNotFoundError):
        test_vectors.load_test_vector(1)
