"""The port's Lean modules against the JAX package's: the VK and params
terms, the quotient dumps, the parameter records and their validation, the
regenerated certificate data (byte-equal to the committed
``artifacts/lean/*.lean``) and the forking-certificate parsers and bound.
The reference's own Lean files are read only where
``LAMBDA_SNARK_REFERENCE`` names a checkout of it; those tests skip
otherwise, as the JAX package's skip without the reference."""

import os
from fractions import Fraction

import pytest

from lambda_snark_tpu.circuits import healthcare as jax_healthcare
from lambda_snark_tpu.lean import certificates as jax_certs
from lambda_snark_tpu.lean import export as jax_export
from lambda_snark_tpu.lean import params_io as jax_params_io
import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.circuits import healthcare
from lambda_snark_tpu_torch.cli import REFERENCE_ENV
from lambda_snark_tpu_torch.core.errors import InvalidInputError, InvalidParamsError
from lambda_snark_tpu_torch.lean import certificates, export, params_io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q_LEAN = 2013265921  # the certificate field (healthcare_quotient_dump.rs:10)
MODULI = [Q_LEAN, port.LEGACY_MODULUS]


def _both(q):
    return ((healthcare.build_healthcare_circuit(q), healthcare.high_risk_witness(q)),
            (jax_healthcare.build_healthcare_circuit(q), jax_healthcare.high_risk_witness(q)))


@pytest.mark.parametrize("q", MODULI)
def test_export_equals_jax(q):
    (r1cs, w), (jr1cs, jw) = _both(q)
    assert export.vk_to_lean(r1cs) == jax_export.vk_to_lean(jr1cs)
    for side in ("a", "b", "c"):
        assert export.sparse_matrix_to_lean(getattr(r1cs, side)) == \
            jax_export.sparse_matrix_to_lean(getattr(jr1cs, side))
    params = port.Params(port.SecurityLevel.BITS128, port.Profile.ring_b(4096, 2, q, 3.19))
    jparams = jax_params_io.SecurityParams(4096, 2, q, 3.19, 128)
    assert export.params_to_lean(params) == jparams.to_lean()
    quotient = r1cs.compute_quotient_poly(w)
    assert quotient == jr1cs.compute_quotient_poly(jw)
    assert export.quotient_dump_json(r1cs, w, quotient, description="d") == \
        jax_export.quotient_dump_json(jr1cs, jw, quotient, description="d")
    assert export.quotient_dump_reference_format(q, quotient) == \
        jax_export.quotient_dump_reference_format(q, quotient)


@pytest.mark.parametrize("q", MODULI)
def test_certificates_equal_jax(q):
    (r1cs, w), (jr1cs, jw) = _both(q)
    assert certificates.circuit_coo(r1cs) == jax_certs.circuit_coo(jr1cs)
    assert certificates.certificate_data_lean(r1cs, w) == jax_certs.certificate_data_lean(jr1cs, jw)
    assert certificates.constraint_residuals(r1cs, w) == [0] * r1cs.m
    if (q - 1) % r1cs.m == 0:
        assert certificates.healthcare_omega(q) == jax_certs.healthcare_omega(q)
        assert certificates.witness_data_lean(r1cs, w) == jax_certs.witness_data_lean(jr1cs, jw)
    else:
        with pytest.raises(ValueError):
            certificates.healthcare_omega(q)
    assert certificates.least_primitive_root(q) == jax_certs.least_primitive_root(q)
    assert certificates.security_params_lean() == jax_certs.security_params_lean()


@pytest.mark.parametrize("name", ["HealthcareCircuitData", "HealthcareWitnessData",
                                  "SecurityParamsData"])
def test_committed_lean_artifacts_regenerate_byte_for_byte(name, tmp_path):
    r1cs, w = healthcare.build_healthcare_circuit(Q_LEAN), healthcare.high_risk_witness(Q_LEAN)
    text = {"HealthcareCircuitData": lambda: certificates.certificate_data_lean(r1cs, w),
            "HealthcareWitnessData": lambda: certificates.witness_data_lean(r1cs, w),
            "SecurityParamsData": certificates.security_params_lean}[name]()
    out = tmp_path / f"{name}.lean"
    export.write_artifact(str(out), text)
    with open(os.path.join(REPO, "artifacts", "lean", f"{name}.lean"), "rb") as f:
        assert out.read_bytes() == f.read()


@pytest.mark.parametrize("q", MODULI)
def test_certificate_data_roundtrips(q):
    r1cs, w = healthcare.build_healthcare_circuit(q), healthcare.high_risk_witness(q)
    back = certificates.parse_reference_circuit(certificates.certificate_data_lean(r1cs, w))
    coo = certificates.circuit_coo(r1cs)
    assert back["q"] == q and back["n_vars"] == r1cs.n and back["n_cons"] == r1cs.m
    assert back["n_pub"] == r1cs.l
    for name in "ABC":
        assert sorted(back[name]) == sorted(coo[name]), name
    assert back["witness"] == [v % q for v in w]
    assert back == jax_certs.parse_reference_circuit(certificates.certificate_data_lean(r1cs, w))


@pytest.mark.parametrize("record,error", [
    ("{ n := 4096, k := 2, q := 17592186044423, σ := 3.19, λ := 128 }", None),
    ("{ n := 4096, k := 2, q := 17592186044417, σ := 3.19, λ := 128 }", InvalidParamsError),
    ("{ n := 1000, k := 2, q := 17592186044423, σ := 3.19, λ := 128 }", InvalidParamsError),
    ("{ n := 4096, k := 2, q := 17592186044423, σ := 2.5, λ := 128 }", InvalidParamsError),
    ("{ n := 4096, k := 2, q := 17592186044423, sigma := 3.2, lambda := 100 }",
     InvalidParamsError),
    ("n := 4096", InvalidInputError),
    ("{ n := 4096, k := 2, q := 12289, σ := 3.2 }", InvalidInputError),
    ("{ n := x, k := 2, q := 12289, σ := 3.2, λ := 128 }", InvalidInputError),
])
def test_params_io_equals_jax(record, error):
    def outcome(mod):
        try:
            p = mod.SecurityParams.from_lean(record)
            mod.validate_params(p)
            return p.to_lean()
        except Exception as exc:  # noqa: BLE001 - the two packages' error classes
            return type(exc).__name__

    got = outcome(params_io)
    assert got == outcome(jax_params_io)
    if error is None:
        assert got == record
    else:
        assert got == error.__name__


FORKING_EXAMPLE = """
def trivialSparseMatrix : SparseMatrix (ZMod 17) where
  nRows := 1
  nCols := 2
  entries := []

def trivialR1CS : R1CS (ZMod 17) where
  nVars := 2
  nCons := 1
  nPub := 1

def t1 : Transcript := { alpha := 3 }
def t2 : Transcript := { alpha := 5 }
"""

FORK_BOUNDS = """
lemma a : 1 ≥ ((1 : ℝ) / 2) ^ 2 / 2 - 1 / (17 : ℝ) := by norm_num
lemma b : 1 ≥ (3 : ℝ) ^ 2 / 2 - 1 / (2013265921 : ℝ) := by norm_num
"""

FORKING_EQUATIONS = """
axiom sis : ModuleSIS_Hard 256 2 12289 1024
theorem healthcare_square :
  healthcareR1CS.nVars = healthcareR1CS.nCons := rfl
"""


def test_forking_parsers_and_bound_equal_jax():
    data = certificates.parse_forking_example(FORKING_EXAMPLE)
    assert data == jax_certs.parse_forking_example(FORKING_EXAMPLE)
    assert (data["q"], data["n_vars"], data["alphas"]) == (17, 2, [3, 5])
    assert certificates.forking_example_data_lean(data) == \
        jax_certs.forking_example_data_lean(data)
    pairs = certificates.parse_fork_probability_bounds(FORK_BOUNDS)
    assert pairs == jax_certs.parse_fork_probability_bounds(FORK_BOUNDS)
    assert pairs == [(17, Fraction(1, 2)), (2013265921, Fraction(3))]
    assert [certificates.check_fork_success_bound(q, e) for q, e in pairs] == [True, False]
    assert certificates.check_fork_success_bound(2, Fraction(3, 2))
    eqs = certificates.parse_forking_equations(FORKING_EQUATIONS)
    assert eqs == jax_certs.parse_forking_equations(FORKING_EQUATIONS)
    assert eqs == {"sis_n": 256, "sis_k": 2, "sis_q": 12289, "sis_beta": 1024,
                   "asserts_square_domain": True}
    with pytest.raises(ValueError):
        certificates.parse_fork_probability_bounds("no bounds here")


def _reference_file(*parts) -> str:
    root = os.environ.get(REFERENCE_ENV)
    path = os.path.join(root or "", "formal", "tests", *parts)
    if not root or not os.path.exists(path):
        pytest.skip(f"reference Lean tests not available (set {REFERENCE_ENV})")
    with open(path) as f:
        return f.read()


def test_reference_certificate_matches_our_circuit():
    ref = certificates.parse_reference_circuit(_reference_file("HealthcareCircuit.lean"))
    r1cs, w = healthcare.build_healthcare_circuit(Q_LEAN), healthcare.high_risk_witness(Q_LEAN)
    assert (ref["q"], ref["n_vars"], ref["n_cons"], ref["n_pub"]) == \
        (r1cs.modulus, r1cs.n, r1cs.m, r1cs.l)
    coo = certificates.circuit_coo(r1cs)
    for name in "ABC":
        assert sorted(ref[name]) == sorted(coo[name]), name
    assert ref["witness"] == [v % Q_LEAN for v in w]


def test_reference_fork_bounds_hold():
    pairs = certificates.parse_fork_probability_bounds(
        _reference_file("ForkProbabilityBounds.lean"))
    assert all(certificates.check_fork_success_bound(q, e) for q, e in pairs)
