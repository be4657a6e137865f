"""The port's kind-9 committed-witness proofs against the JAX package, on the CPU.

``prove_r1cs_witness(device="cpu")`` (the device route with every kernel as
its plain twin for Goldilocks, the host route on Python ints for the 44-bit
field and the healthcare prime) must give the bytes of the JAX
``prove_r1cs_witness`` (its host route, ``device_lde=False``, whose bytes
JAX pins equal to its device route), plain and ZK, at the JAX tests' shapes
(``tests/test_succinct_witness.py``: ``mult_circuit`` at m = 8 and 16, the
stride-one ``narrow_circuit``, ring n = 64, k = 1,
``FriParams(log_blowup=3, num_queries=8)``) and at ring degree n < m; both
verifiers must decide alike on every valid, forged and tampered proof; and
the device pieces kind 9 adds (``deep_combine_terms_device``, ``fri_open``
over groups of unequal sizes, kernel K's group forests at G = 2, 5, 6) are
held against the host builds, the JAX host ``fri_prove`` and ``hashlib``.

The JAX package is imported inside fixtures, so the ``cuda`` test at the
end runs on a card machine without JAX:
``python -m pytest tests/test_torch_witness.py -m cuda --noconftest -q``.
"""

import dataclasses
import hashlib
import importlib
import random
import struct
import types

import numpy as np
import pytest
import torch

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import (
    CommitmentError,
    DomainError,
    InvalidDimensionsError,
    InvalidWitnessError,
    SerializationError,
)
from lambda_snark_tpu_torch.core.params import HEALTHCARE_DUMP_MODULUS
from lambda_snark_tpu_torch.ops import keccak, modarith
from lambda_snark_tpu_torch.ops.ntt import ntt_inverse
from lambda_snark_tpu_torch.proof import fri, fri_device, succinct
from lambda_snark_tpu_torch.proof import succinct_witness as sw
from lambda_snark_tpu_torch.proof.succinct_witness import WitnessProofR1CS, _witness_geometry
from lambda_snark_tpu_torch.r1cs.circuit import CircuitBuilder
from lambda_snark_tpu_torch.r1cs.domain import Domain

GL = port.NTT_MODULUS
Q45 = port.NTT_FRIENDLY_MODULUS
HC = HEALTHCARE_DUMP_MODULUS
FAST = fri.FriParams(log_blowup=3, num_queries=8)
#: case -> (modulus, m); the JAX tests' mult_circuit shapes and the host fields
CASES = {"gl8": (GL, 8), "gl16": (GL, 16), "q45": (Q45, 8), "healthcare": (HC, 8)}


def _port_ctx(q=GL, n=64):
    return port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=n, k=1, q=q, sigma=3.19)))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces, imported here (not on a card machine)."""
    J = importlib.import_module("lambda_snark_tpu")
    jfri = importlib.import_module("lambda_snark_tpu.proof.fri")
    return types.SimpleNamespace(
        J=J, fri=jfri, sw=importlib.import_module("lambda_snark_tpu.proof.succinct_witness"),
        succ=importlib.import_module("lambda_snark_tpu.proof.succinct"),
        Domain=importlib.import_module("lambda_snark_tpu.r1cs.domain").Domain,
        Builder=importlib.import_module("lambda_snark_tpu.r1cs.circuit").CircuitBuilder,
        tsw=importlib.import_module("test_succinct_witness"),
        FAST=jfri.FriParams(log_blowup=3, num_queries=8),
        ctx=lambda q, n=64: J.setup(J.Params(J.SecurityLevel.BITS128,
                                             J.Profile.ring_b(n, 1, q, 3.19))))


def _circuits(jx, q, m):
    """The JAX test circuit and the port's, on the roots domain (the
    healthcare prime's default domain is sequential)."""
    jr, pr = jx.tsw.mult_circuit(m, q), port.multiplication_gates_circuit(m, q)
    if jr.domain.kind != "roots":
        omega = fri.root_of_order(q, m)
        jr = dataclasses.replace(jr, domain=jx.Domain.roots(m, q, omega))
        pr = dataclasses.replace(pr, domain=Domain.roots(m, q, omega))
    return jr, pr


@pytest.fixture(scope="module")
def proved(jx):
    """(case, zk) -> (JAX circuit, port circuit, witness, JAX proof, port proof)."""
    out = {}
    for case, (q, m) in CASES.items():
        jctx, ours = jx.ctx(q), _port_ctx(q)
        jr, pr = _circuits(jx, q, m)
        w = port.multiplication_gates_witness(m, q, seed=3)
        for zk in (False, True):
            theirs = jx.sw.prove_r1cs_witness(jr, w, jctx, 42, zk=zk, fri_params=jx.FAST,
                                              blinding_seed=77)
            mine = port.prove_r1cs_witness(pr, w, ours, 42, zk=zk, fri_params=FAST,
                                           blinding_seed=77, device="cpu")
            out[case, zk] = (jr, pr, w, theirs, mine)
    return out


def _jax_proof(jx, proof):
    return jx.sw.WitnessProofR1CS.from_bytes(proof.to_bytes())


# --- completeness and bytes ----------------------------------------------------------


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
@pytest.mark.parametrize("case", list(CASES))
def test_witness_bytes_equal_jax(proved, case, zk):
    _jr, pr, _w, theirs, mine = proved[case, zk]
    assert succinct._gl_frontend_applicable(pr) == (pr.modulus == GL)
    assert mine.to_bytes() == theirs.to_bytes()
    assert mine.mask_len == (2 * FAST.num_queries + 8 if zk else 0)
    assert mine.n_pre == (6 if zk else 5) and len(mine.evals_gamma) == mine.n_pre + 1


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
@pytest.mark.parametrize("case", list(CASES))
def test_witness_cross_verification(jx, proved, case, zk):
    """Each verifier accepts the other package's proof and refuses it for
    the public input [2]."""
    jr, pr, _w, theirs, mine = proved[case, zk]
    back = WitnessProofR1CS.from_bytes(theirs.to_bytes())
    assert port.verify_r1cs_witness(back, [1], pr, min_params=FAST)
    assert jx.sw.verify_r1cs_witness(_jax_proof(jx, mine), [1], jr, min_params=jx.FAST)
    assert not port.verify_r1cs_witness(back, [2], pr, min_params=FAST)
    assert not jx.sw.verify_r1cs_witness(_jax_proof(jx, mine), [2], jr, min_params=jx.FAST)


def test_stride_one_domain_equals_jax(jx):
    """n <= m: the sumcheck domain is the constraint domain (M = m) on the
    device route."""
    def narrow(builder_cls):
        b = builder_cls(GL)
        b.alloc_var()
        x, y = b.alloc_var(), b.alloc_var()
        b.set_public_inputs(1)
        for _ in range(16):
            b.mul_gate(x, x, y)
        return b.build()

    jr, pr = narrow(jx.Builder), narrow(CircuitBuilder)
    assert _witness_geometry(pr, FAST, 0)[0] == 16 and succinct._gl_frontend_applicable(pr)
    theirs = jx.sw.prove_r1cs_witness(jr, [1, 5, 25], jx.ctx(GL), 11, fri_params=jx.FAST)
    mine = port.prove_r1cs_witness(pr, [1, 5, 25], _port_ctx(), 11, fri_params=FAST,
                                   device="cpu")
    assert mine.to_bytes() == theirs.to_bytes()
    assert port.verify_r1cs_witness(mine, [1], pr, min_params=FAST)


def test_deterministic_bytes():
    pr = port.multiplication_gates_circuit(8, GL)
    w = port.multiplication_gates_witness(8, GL)
    p1, p2 = (port.prove_r1cs_witness(pr, w, _port_ctx(), 5, zk=True, fri_params=FAST,
                                      blinding_seed=13, device="cpu") for _ in range(2))
    assert p1.to_bytes() == p2.to_bytes()


def test_zk_hides_witness_bytes(proved):
    _jr, _pr, w, _theirs, mine = proved["gl8", True]
    blob = mine.to_bytes()
    assert all(v.to_bytes(8, "little") not in blob for v in w[1:9])


def test_deserialize_any_both_ways(jx, proved):
    for zk in (False, True):
        _jr, _pr, _w, theirs, mine = proved["gl16", zk]
        blob = mine.to_bytes()
        back = port.deserialize_any(theirs.to_bytes())
        assert isinstance(back, WitnessProofR1CS) and back == mine and back.to_bytes() == blob
        assert WitnessProofR1CS.from_bytes(blob) == mine
        jback = jx.J.deserialize_any(blob)
        assert type(jback).__name__ == "WitnessProofR1CS" and jback.to_bytes() == blob


@pytest.mark.parametrize("gl_fast", [True, False], ids=["arrays", "ints"])
def test_device_route_equals_host_tail(gl_fast):
    """The device route's proof equals ``_prove_from_parts`` (the host
    tail) fed the host helpers' polynomials, as uint64 arrays
    (``gl_fast``) or as lists of ints (the Python-int branches, where the
    JAX package's ``g_rem[1:] or [0]`` cannot take a Goldilocks array)."""
    pr, ctx = port.multiplication_gates_circuit(16, GL), _port_ctx()
    w = port.multiplication_gates_witness(16, GL, seed=9)
    geo = _witness_geometry(pr, FAST, 0)
    polys = succinct._gl_quotient_and_interpolations(pr, w)
    z = [v % GL for v in w]
    polys += (_z_poly(z, geo[0]),)
    if not gl_fast:
        polys = tuple([int(v) for v in p] for p in polys)
    q_coeffs, a_p, b_p, c_p, z_poly = polys
    host = sw._prove_from_parts(pr, z, a_p, b_p, c_p, q_coeffs, z_poly, None, q_coeffs, ctx,
                                4, FAST, 0, *geo, gl_fast)
    assert host.to_bytes() == port.prove_r1cs_witness(pr, w, ctx, 4, fri_params=FAST,
                                                      device="cpu").to_bytes()


# --- ring degree n < m ----------------------------------------------------------------


def _identity_circuit(builder_cls, q, m):
    """m gates a_i * 1 = c_i: A = C on the domain, so Q = 0."""
    b = builder_cls(q)
    one = b.alloc_var()
    a, c = b.alloc_vars(m), b.alloc_vars(m)
    b.set_public_inputs(1)
    for i in range(m):
        b.add_constraint([(a[i], 1)], [(one, 1)], [(c[i], 1)])
    return b.build()


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_ring_degree_below_m_zero_quotient_proves(jx, zk):
    m = 16
    jr, pr = _identity_circuit(jx.Builder, GL, m), _identity_circuit(CircuitBuilder, GL, m)
    rng = random.Random(1)
    a = [rng.randrange(GL) for _ in range(m)]
    w = [1] + a + a
    theirs = jx.sw.prove_r1cs_witness(jr, w, jx.ctx(GL, 8), 3, zk=zk, fri_params=jx.FAST,
                                      blinding_seed=4)
    mine = port.prove_r1cs_witness(pr, w, _port_ctx(GL, 8), 3, zk=zk, fri_params=FAST,
                                   blinding_seed=4, device="cpu")
    assert mine.to_bytes() == theirs.to_bytes()
    assert port.verify_r1cs_witness(mine, [1], pr, min_params=FAST)


def test_ring_degree_below_m_random_witness_raises_commitment_error(jx):
    jr, pr = jx.tsw.mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    w = port.multiplication_gates_witness(16, GL, seed=1)
    with pytest.raises(Exception) as theirs:
        jx.sw.prove_r1cs_witness(jr, w, jx.ctx(GL, 8), 1, fri_params=jx.FAST)
    assert type(theirs.value).__name__ == "CommitmentError"
    with pytest.raises(CommitmentError) as mine:
        port.prove_r1cs_witness(pr, w, _port_ctx(GL, 8), 1, fri_params=FAST, device="cpu")
    assert str(mine.value) == str(theirs.value)


# --- refused inputs -------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["unsatisfied", "short"])
@pytest.mark.parametrize("case", ["gl16", "q45"])
def test_invalid_witness_raises_as_jax(jx, case, bad):
    """A witness that fails the constraints, or is one word short: the
    JAX package's error type and message, on both routes."""
    q, m = CASES[case]
    jr, pr = _circuits(jx, q, m)
    w = port.multiplication_gates_witness(m, q, seed=2)
    if bad == "short":
        w, want = w[:-1], InvalidDimensionsError
    else:
        w[-1], want = (w[-1] + 1) % q, InvalidWitnessError
    with pytest.raises(Exception) as theirs:
        jx.sw.prove_r1cs_witness(jr, w, jx.ctx(q), 1, fri_params=jx.FAST)
    with pytest.raises(want) as mine:
        port.prove_r1cs_witness(pr, w, _port_ctx(q), 1, fri_params=FAST, device="cpu")
    assert type(theirs.value).__name__ == want.__name__
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("case", ["sequential", "unsupported_field", "codeword_too_long"])
def test_geometry_refusals_equal_jax(jx, case):
    """The same DomainError message as the JAX package's ``_witness_geometry``."""
    q, m, params, jparams = Q45, 8, FAST, jx.FAST
    if case == "unsupported_field":
        q = 17592186044417  # 2^44 + 1: no registered 2-adic subgroup
    jr, pr = jx.tsw.mult_circuit(m, q), port.multiplication_gates_circuit(m, q)
    if case == "sequential":
        jr = dataclasses.replace(jr, domain=jx.Domain.sequential(m, q))
        pr = dataclasses.replace(pr, domain=Domain.sequential(m, q))
    elif case == "codeword_too_long":  # 64 << 8 words past the 44-bit field's 2^13
        params, jparams = fri.FriParams(log_blowup=8), jx.fri.FriParams(log_blowup=8)
    w = port.multiplication_gates_witness(m, q)
    with pytest.raises(Exception) as theirs:
        jx.sw.prove_r1cs_witness(jr, w, jx.ctx(q), 1, fri_params=jparams)
    with pytest.raises(DomainError) as mine:
        port.prove_r1cs_witness(pr, w, _port_ctx(q), 1, fri_params=params, device="cpu")
    assert str(mine.value) == str(theirs.value)


# --- soundness: forged polynomials through _prove_from_parts (both packages) --------


def _z_poly(z, big_m: int) -> np.ndarray:
    """z^: z padded to M, interpolated over H_s (the host plan)."""
    z_pad = np.zeros(big_m, dtype=np.uint64)
    z_pad[: len(z)] = z
    return modarith.to_u64(ntt_inverse(succinct._gl_plan(big_m), modarith.to_words(z_pad)))


def _forge(helpers, tail, r1cs, ctx, params, z_witness, poly_witness, **kw):
    """One package's ``_prove_from_parts`` (``tail``), z^ from ``z_witness``
    and A, B, C, Q from ``poly_witness`` by that package's ``helpers``."""
    geo = tail._witness_geometry(r1cs, params, 0)
    q_coeffs, a_p, b_p, c_p = helpers._gl_quotient_and_interpolations(r1cs, poly_witness)
    z = [int(v) % GL for v in z_witness]
    return tail._prove_from_parts(r1cs, z, a_p, b_p, c_p, q_coeffs, _z_poly(z, geo[0]), None,
                                  q_coeffs, ctx, 42, params, 0, *geo, True, **kw)


def _forgers(jx):
    """(helpers, tail, context, params) of the JAX package, then the port."""
    return (jx.succ, jx.sw, jx.ctx(GL), jx.FAST), (succinct, sw, _port_ctx(), FAST)


def test_rejects_witness_substitution(jx):
    """z^ commits one witness, A~, B~, C~, Q~ come from another: the same
    bytes from both packages' tails, and both verifiers reject."""
    jr, pr = jx.tsw.mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    w_z = port.multiplication_gates_witness(16, GL, seed=0)
    w_p = port.multiplication_gates_witness(16, GL, seed=1)
    theirs_args, mine_args = _forgers(jx)
    theirs = _forge(*theirs_args[:2], jr, *theirs_args[2:], w_z, w_p, _allow_bad_sum=True)
    mine = _forge(*mine_args[:2], pr, *mine_args[2:], w_z, w_p, _allow_bad_sum=True)
    assert mine.to_bytes() == theirs.to_bytes()
    assert not port.verify_r1cs_witness(mine, [1], pr, min_params=FAST)
    assert not jx.sw.verify_r1cs_witness(theirs, [1], jr, min_params=jx.FAST)
    with pytest.raises(DomainError, match="sumcheck remainder nonzero"):
        _forge(*mine_args[:2], pr, *mine_args[2:], w_z, w_p)


def test_public_forgery_breaks_low_degreeness(jx):
    """Publics that differ from z^'s prefix: FRI's final polynomial exceeds
    its bound in both packages' tails."""
    jr, pr = jx.tsw.mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    w = port.multiplication_gates_witness(16, GL)
    theirs_args, mine_args = _forgers(jx)
    with pytest.raises(Exception) as theirs:
        _forge(*theirs_args[:2], jr, *theirs_args[2:], w, w, public_override=[2])
    with pytest.raises(DomainError) as mine:
        _forge(*mine_args[:2], pr, *mine_args[2:], w, w, public_override=[2])
    assert str(mine.value) == str(theirs.value)


def test_rejects_consistent_public_forgery(jx):
    """A doctored z^ (z'[0] = 2) consistent with the claimed publics passes
    FRI but fails the lincheck in both verifiers."""
    def constrained(builder_cls):
        b = builder_cls(GL)
        b.alloc_var()
        x, y = b.alloc_var(), b.alloc_var()
        b.set_public_inputs(1)
        for _ in range(16):
            b.mul_gate(0, x, y)
        return b.build()

    jr, pr = constrained(jx.Builder), constrained(CircuitBuilder)
    w = [1, 5, 5]
    theirs_args, mine_args = _forgers(jx)
    kw = dict(public_override=[2], _allow_bad_sum=True)
    theirs = _forge(*theirs_args[:2], jr, *theirs_args[2:], [2, 5, 5], w, **kw)
    mine = _forge(*mine_args[:2], pr, *mine_args[2:], [2, 5, 5], w, **kw)
    assert mine.to_bytes() == theirs.to_bytes()
    assert not port.verify_r1cs_witness(mine, [2], pr, min_params=FAST)
    assert not jx.sw.verify_r1cs_witness(theirs, [2], jr, min_params=jx.FAST)


# --- tampered proofs ------------------------------------------------------------------


def _tampered(proof, case: str):
    if case.startswith("gamma"):
        i = int(case[5:])
        evals = list(proof.evals_gamma)
        evals[i] = (evals[i] + 1) % GL
        return dataclasses.replace(proof, evals_gamma=tuple(evals))
    if case.startswith("ab"):
        i = int(case[2:])
        evals = list(proof.evals_ab)
        evals[i] = (evals[i] + 1) % GL
        return dataclasses.replace(proof, evals_ab=tuple(evals))
    if case == "fri_path":
        q0 = proof.fri.queries[0]
        op = q0.input_openings[1]
        bad_op = dataclasses.replace(op, path=bytes([op.path[0] ^ 1]) + op.path[1:])
        bad_q = dataclasses.replace(q0, input_openings=(q0.input_openings[0], bad_op))
        return dataclasses.replace(proof, fri=dataclasses.replace(
            proof.fri, queries=(bad_q,) + proof.fri.queries[1:]))
    return dataclasses.replace(proof, **{case: bytes(32)})  # sum_root, pre_root


TAMPER = ([f"gamma{i}" for i in range(7)] + [f"ab{i}" for i in range(8)]
          + ["sum_root", "pre_root", "fri_path"])


@pytest.mark.parametrize("case", TAMPER)
def test_tampered_proof_rejected_by_both(jx, proved, case):
    jr, pr, _w, _theirs, mine = proved["gl16", True]
    bad = _tampered(mine, case)
    assert not port.verify_r1cs_witness(bad, [1], pr, min_params=FAST)
    assert not jx.sw.verify_r1cs_witness(_jax_proof(jx, bad), [1], jr, min_params=jx.FAST)


def test_byte_corruption_decided_alike(jx, proved):
    """24 flipped bytes: each blob fails to decode in both packages, or
    decodes in both and both verifiers reject it."""
    jr, pr, _w, _theirs, mine = proved["gl16", False]
    blob = mine.to_bytes()
    rng = random.Random(0)
    for _ in range(24):
        i = rng.randrange(9, len(blob))
        mutated = bytearray(blob)
        mutated[i] ^= 0xFF
        mutated = bytes(mutated)
        try:
            theirs = jx.sw.WitnessProofR1CS.from_bytes(mutated)
        except Exception as exc:  # the JAX package's SerializationError
            assert type(exc).__name__ == "SerializationError"
            with pytest.raises(SerializationError) as mine:
                WitnessProofR1CS.from_bytes(mutated)
            assert str(mine.value) == str(exc)
            continue
        ours = WitnessProofR1CS.from_bytes(mutated)
        assert not port.verify_r1cs_witness(ours, [1], pr, min_params=FAST)
        assert not jx.sw.verify_r1cs_witness(theirs, [1], jr, min_params=jx.FAST)


def test_truncation_raises(proved):
    blob = proved["gl16", False][4].to_bytes()
    for cut in (10, 40, 100, len(blob) // 2, len(blob) - 1):
        with pytest.raises(SerializationError):
            WitnessProofR1CS.from_bytes(blob[:cut])


def test_weak_params_against_the_floor(jx):
    pr, jr = port.multiplication_gates_circuit(16, GL), jx.tsw.mult_circuit(16, GL)
    w = port.multiplication_gates_witness(16, GL)
    weak = fri.FriParams(log_blowup=1, num_queries=2)
    mine = port.prove_r1cs_witness(pr, w, _port_ctx(), 9, fri_params=weak, device="cpu")
    theirs = jx.sw.prove_r1cs_witness(jr, w, jx.ctx(GL), 9,
                                      fri_params=jx.fri.FriParams(log_blowup=1, num_queries=2))
    assert mine.to_bytes() == theirs.to_bytes()
    assert not port.verify_r1cs_witness(mine, [1], pr, min_params=FAST)
    assert port.verify_r1cs_witness(mine, [1], pr, min_params=weak)
    assert not jx.sw.verify_r1cs_witness(theirs, [1], jr, min_params=jx.FAST)


# --- the host helpers against JAX's ----------------------------------------------------


@pytest.mark.parametrize("case", ["gl16", "q45"])
def test_row_weights_and_lagrange_sums_equal_jax(jx, case):
    q, m = CASES[case]
    jr, pr = _circuits(jx, q, m)
    rng = random.Random(5)
    r, etas, gamma = rng.randrange(q), tuple(rng.randrange(q) for _ in range(3)), rng.randrange(q)
    u, r_pows = sw._row_weights(pr, r, etas)
    ju, jr_pows = jx.sw._row_weights(jr, r, etas)
    assert [int(v) for v in u] == [int(v) for v in ju]
    assert [int(v) for v in r_pows] == [int(v) for v in jr_pows]
    big_m, omega_s = _witness_geometry(pr, FAST, 0)[:2]
    positions = [2 * i + 1 for i in range(len(u))]
    assert sw._lagrange_sum(list(u), positions, gamma, omega_s, big_m, q) == \
        jx.sw._lagrange_sum(list(ju), positions, gamma, omega_s, big_m, q)
    if q == GL:
        assert sw._lagrange_sum_geometric(u, omega_s, gamma, omega_s, big_m, q) == \
            jx.sw._lagrange_sum_geometric(ju, omega_s, gamma, omega_s, big_m, q)
        exps = [rng.randrange(1 << 40) for _ in range(9)]
        assert np.array_equal(sw._gl_pow_vec_int(r, exps), jx.sw._gl_pow_vec_int(r, exps))


@pytest.mark.parametrize("length", [5, 32, 33, 95, 96])
@pytest.mark.parametrize("q", [GL, Q45], ids=["goldilocks", "q45"])
def test_fold_by_vanishing_equals_jax(jx, q, length):
    rng = random.Random(length)
    f = [rng.randrange(q) for _ in range(length)]
    arg = np.array(f, dtype=np.uint64) if q == GL else f
    h, g = sw._fold_by_vanishing(arg, 32, q)
    jh, jg = jx.sw._fold_by_vanishing(arg, 32, q)
    assert [int(v) for v in h] == [int(v) for v in jh]
    assert [int(v) for v in g] == [int(v) for v in jg]


def test_goldilocks_helpers_equal_jax(jx):
    rng = np.random.default_rng(1)
    a = rng.integers(0, GL, size=37, dtype=np.uint64)
    b = rng.integers(0, GL, size=20, dtype=np.uint64)
    assert np.array_equal(succinct._gl_conv(a, b), jx.succ._gl_conv(a, b))
    assert succinct._gl_poly_eval(a, 12345) == jx.succ._gl_poly_eval(a, 12345)
    assert np.array_equal(succinct._gl_zh_mul(b, 16), jx.succ._gl_zh_mul(b, 16))
    assert np.array_equal(succinct._gl_add_padded(a, b), jx.succ._gl_add_padded(a, b))
    jr, pr = jx.tsw.mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    w = port.multiplication_gates_witness(16, GL, seed=6)
    for mine, theirs in zip(succinct._gl_quotient_and_interpolations(pr, w),
                            jx.succ._gl_quotient_and_interpolations(jr, w)):
        assert np.array_equal(mine, theirs)


# --- the device pieces ------------------------------------------------------------------


def test_deep_combine_terms_device_equals_host_builds():
    """``deep_combine_terms_device`` (torch ops) equals the host Goldilocks
    build (``_deep_host_goldilocks``) and a Python-int evaluation of the
    same sum, for a kind-9-shaped term table (points repeat, one public)."""
    k_in, n0 = 7, 64
    rng = np.random.default_rng(4)
    cw = rng.integers(0, GL, size=(k_in, n0), dtype=np.uint64)
    pts = [int(v) for v in rng.integers(0, GL, size=3, dtype=np.uint64)] + [1]
    terms = [(k, pts[j], int(rng.integers(0, GL, dtype=np.uint64)))
             for j in range(2) for k in range(4)]
    terms += [(k, pts[2], int(rng.integers(0, GL, dtype=np.uint64))) for k in (0, 1, 2, 4, 5, 6)]
    terms.append((4, pts[3], 1))
    lam = int(rng.integers(0, GL, dtype=np.uint64))
    weights = sw._lambda_weights(len(terms), lam, GL)
    offset, omega, sh = fri.coset_offset(GL), fri.root_of_order(GL, n0), 5
    got = modarith.to_u64(fri_device.deep_combine_terms_device(
        modarith.to_words(cw), np.array(pts, dtype=np.uint64), [t[0] for t in terms],
        [pts.index(t[1]) for t in terms], np.array(weights[:-1], dtype=np.uint64),
        np.array([t[2] for t in terms], dtype=np.uint64), offset, omega, k_in - 1, sh,
        weights[-1]))
    host = sw._deep_host_goldilocks(list(cw), terms, weights, offset, omega, n0, k_in - 1, sh)
    assert np.array_equal(got, host)
    for i in range(0, n0, 9):
        x = offset * pow(omega, i, GL) % GL
        want = sum(w * (int(cw[k, i]) - v) * pow(x - pt, GL - 2, GL)
                   for w, (k, pt, v) in zip(weights, terms))
        want += weights[-1] * pow(x, sh, GL) * int(cw[k_in - 1, i])
        assert int(got[i]) == want % GL


def test_fri_open_unequal_groups_equals_jax_fri_prove(jx):
    """One FRI statement over a group of 5 oracles and a group of 2 (kind
    9's pre and sum groups) gives the JAX host ``fri_prove``'s bytes."""
    n0 = 128
    rng = np.random.default_rng(8)
    pre = rng.integers(0, GL, size=(5, n0), dtype=np.uint64)
    summ = rng.integers(0, GL, size=(2, n0), dtype=np.uint64)
    offset, omega = fri.coset_offset(GL), fri.root_of_order(GL, n0)
    coeffs = rng.integers(0, GL, size=n0 // 8, dtype=np.uint64)
    g = np.asarray(jx.fri.lde(coeffs, n0, offset, omega, GL), dtype=np.uint64)
    jtr = jx.fri.FriTranscript()
    jtr.absorb(b"seed", b"witness")
    theirs = jx.fri.fri_prove(g, [(list(pre), jx.fri.commit_codeword_group(list(pre))),
                                  (list(summ), jx.fri.commit_codeword_group(list(summ)))],
                              offset, omega, GL, jx.FAST, jtr)
    tr = fri.FriTranscript()
    tr.absorb(b"seed", b"witness")
    inputs = []
    for vals in (pre, summ):
        words = modarith.to_words(vals)[None]
        inputs.append((words, fri_device.commit_planes_dev_groups(words)))
    mine = fri_device.fri_prove_device(modarith.to_words(g)[None], inputs, offset, omega, GL,
                                       FAST, [tr])[0]
    assert mine.to_bytes() == theirs.to_bytes()
    assert [len(op.values) for op in mine.queries[0].input_openings] == [10, 4]


def _hashlib_levels(vals: np.ndarray):
    """Every level of the group tree of (G, n) words with hashlib: leaf i is
    SHA3(0x00 || each oracle's pair (i, i + n/2)), a node SHA3(0x01 || l || r)."""
    half = vals.shape[1] // 2
    level = [hashlib.sha3_256(b"\x00" + b"".join(
        struct.pack("<QQ", int(v[i]), int(v[i + half])) for v in vals)).digest()
        for i in range(half)]
    levels = [level]
    while len(level) > 1:
        level = [hashlib.sha3_256(b"\x01" + level[i] + level[i + 1]).digest()
                 for i in range(0, len(level), 2)]
        levels.append(level)
    return levels


@pytest.mark.parametrize("groups", [2, 5, 6])
def test_group_forest_plain_equals_hashlib(groups):
    """Kernel K's plain twin at kind 9's group sizes: every level of every
    tree equals a hashlib tree."""
    rng = np.random.default_rng(groups)
    vals = rng.integers(0, 1 << 64, size=(2, groups, 32), dtype=np.uint64, endpoint=False)
    levels = keccak.merkle_forest_flex_plain(modarith.to_words(vals))
    for t in range(2):
        want = _hashlib_levels(vals[t])
        got = [[bytes(row) for row in fri_device.digest_bytes(level[t])] for level in levels]
        assert got == want


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_witness_on_card_equals_cpu(zk):
    """Kind 9 on the card (kernels Q, R, T, K) gives the CPU route's bytes
    at m = 256 (FRI commits layers, so paired-leaf forests too), verifies,
    and launches every kernel of the route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch import kernels

    m = 256
    r1cs = port.multiplication_gates_circuit(m, GL)
    w = port.multiplication_gates_witness(m, GL, seed=1)
    ctx = _port_ctx(n=m)
    kw = dict(zk=zk, fri_params=FAST, blinding_seed=7)
    cpu = port.prove_r1cs_witness(r1cs, w, ctx, 3, device="cpu", **kw)
    kernels.reset_launches()
    card = port.prove_r1cs_witness(r1cs, w, ctx, 3, device="cuda", **kw)
    launches = kernels.launches()
    assert card.to_bytes() == cpu.to_bytes()
    assert min(launches[e] for e in ("quotient_goldilocks", "ring_commit_goldilocks",
                                     "keccak_group_forest", "keccak_forest",
                                     "ntt_four_step")) >= 1
    assert port.verify_r1cs_witness(card, [1], r1cs, min_params=FAST)
