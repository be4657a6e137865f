"""The port's phase-2 checks (lincheck, mulcheck, the checked proof)
against the JAX package: ``prove_r1cs_checked`` and ``WitnessBinding``
give JAX's bytes, and both packages decide alike on the JAX tests' cases
(``tests/test_checks.py``): x * y = z over 2^44 + 1, ring n = 64, k = 1."""

import dataclasses

import pytest

from lambda_snark_tpu import Params, Profile, SecurityLevel, setup
from lambda_snark_tpu.proof import checks as jchecks

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import InvalidInputError
from lambda_snark_tpu_torch.proof import checks

from test_checks import _mult_circuit
from test_torch_compact import _port_r1cs

Q = 17592186044417


@pytest.fixture(scope="module")
def env():
    jctx = setup(Params(SecurityLevel.BITS128, Profile.ring_b(64, 1, Q, 3.19)))
    ours = port.setup(port.Params(port.SecurityLevel.BITS128,
                                  port.Profile.ring_b(n=64, k=1, q=Q, sigma=3.19)))
    jr, witness = _mult_circuit()
    return jctx, ours, jr, _port_r1cs(jr), witness


@pytest.mark.parametrize("seed", [0xBEEF, 7, (1 << 64) - 1])
def test_checked_proof_bytes_equal_jax(env, seed):
    jctx, ours, jr, pr, w = env
    jproof, jbind = jchecks.prove_r1cs_checked(jr, w, jctx, seed)
    proof, binding = port.prove_r1cs_checked(pr, w, ours, seed)
    assert proof.to_bytes() == jproof.to_bytes()
    assert binding.to_bytes() == jbind.to_bytes()
    assert binding.seed == (seed ^ 0x4C494E43) & ((1 << 64) - 1)
    public = pr.public_inputs(w)
    assert port.verify_r1cs_checked(proof, binding, public, pr, ours)
    assert checks.lincheck_verify(binding, proof, public, pr, ours)
    assert checks.mulcheck_verify(binding, pr)


def test_binding_round_trip_both_ways(env):
    jctx, ours, jr, pr, w = env
    binding = checks.lincheck_prove(pr, w, ours, 11)
    data = binding.to_bytes()
    back = checks.WitnessBinding.from_bytes(data)
    assert (back.z, back.seed, back.commitment_z) == (binding.z, binding.seed,
                                                     binding.commitment_z)
    theirs = jchecks.WitnessBinding.from_bytes(data)
    assert theirs.to_bytes() == data
    with pytest.raises(InvalidInputError):
        checks.WitnessBinding.from_bytes(b"XXXX" + data[4:])
    with pytest.raises(InvalidInputError):
        checks.lincheck_prove(pr, w[:3], ours, 1)
    assert checks.available() and issubclass(checks.NotYetImplementedCheck,
                                             port.LambdaSnarkError)


def _case(env, case):
    """(ours, theirs): each a zero-argument decision of one tamper case."""
    jctx, ours, jr, pr, w = env
    public = pr.public_inputs(w)
    proof, binding = port.prove_r1cs_checked(pr, w, ours, 7)
    jproof, jbind = jchecks.prove_r1cs_checked(jr, w, jctx, 7)
    if case == "witness_substitution":
        return (lambda: checks.lincheck_verify(dataclasses.replace(binding, z=(1, 6, 7, 43)),
                                               proof, public, pr, ours),
                lambda: jchecks.lincheck_verify(dataclasses.replace(jbind, z=(1, 6, 7, 43)),
                                                jproof, public, jr, jctx))
    if case == "forged_commitment":
        return (lambda: checks.lincheck_verify(checks.lincheck_prove(pr, [1, 5, 9, 45], ours, 99),
                                               proof, public, pr, ours),
                lambda: jchecks.lincheck_verify(
                    jchecks.lincheck_prove(jr, [1, 5, 9, 45], jctx, 99), jproof, public, jr,
                    jctx))
    if case == "public_input_mismatch":
        return (lambda: checks.lincheck_verify(binding, proof, [2], pr, ours),
                lambda: jchecks.lincheck_verify(jbind, jproof, [2], jr, jctx))
    if case == "unsatisfying_witness":
        return (lambda: checks.mulcheck_verify(checks.lincheck_prove(pr, [1, 6, 7, 41], ours, 3),
                                               pr),
                lambda: jchecks.mulcheck_verify(
                    jchecks.lincheck_prove(jr, [1, 6, 7, 41], jctx, 3), jr))
    bad = dataclasses.replace(proof, a_z_alpha=(proof.a_z_alpha + 1) % Q)  # tampered_eval
    jbad = dataclasses.replace(jproof, a_z_alpha=(jproof.a_z_alpha + 1) % Q)
    return (lambda: checks.verify_r1cs_checked(bad, binding, public, pr, ours),
            lambda: jchecks.verify_r1cs_checked(jbad, jbind, public, jr, jctx))


CASES = ["witness_substitution", "forged_commitment", "public_input_mismatch",
         "unsatisfying_witness", "tampered_eval"]


@pytest.mark.parametrize("case", CASES)
def test_tamper_cases_rejected_by_both(env, case):
    ours, theirs = _case(env, case)
    assert ours() is False and theirs() is False
