"""The port's three examples (``examples/torch_*.py``) on the CPU.

Each example's ``main(["--device", "cpu"])`` runs its walkthrough with
every kernel as its plain PyTorch twin and asserts what the JAX package's
example of the same name asserts, and more; here its proofs are also read
and verified by the JAX package. Without ``--device cpu`` an example runs
on the card, and raises where there is none (it never falls back).
"""

import importlib
import os
import random

import pytest
import torch

import lambda_snark_tpu as J
from lambda_snark_tpu.circuits.examples import (
    multiplication_gates_circuit,
    multiplication_gates_witness,
)
from lambda_snark_tpu.proof import fri as jfri

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
NAMES = ("torch_batch_proving", "torch_proof_service", "torch_succinct_openings")


@pytest.fixture
def example(monkeypatch):
    """Imports an example by name (the examples directory on sys.path,
    which the proof service's spawned ranks inherit)."""
    monkeypatch.syspath_prepend(EXAMPLES)
    return importlib.import_module


def _jax_mult_circuit(m: int, q: int):
    """The examples' circuit, built by the JAX package: m gates a_i b_i = c_i
    over [1, a, b, c], one public input."""
    builder = J.CircuitBuilder(q)
    builder.alloc_var()
    a, b, c = (builder.alloc_vars(m) for _ in range(3))
    builder.set_public_inputs(1)
    for i in range(m):
        builder.mul_gate(a[i], b[i], c[i])
    return builder.build()


def test_batch_proving_on_the_cpu(example):
    out = example("torch_batch_proving").main(["--device", "cpu"])
    q = J.NTT_FRIENDLY_MODULUS
    r1cs = multiplication_gates_circuit(64, q)
    ws = [multiplication_gates_witness(64, q, seed=s) for s in range(8)]
    assert len(out["proofs"]) == 8 and len(out["zk"]) == 2
    for w, blob in zip(ws, out["proofs"]):
        assert J.verify_r1cs(J.deserialize_any(blob), r1cs.public_inputs(w), r1cs)
    for w, blob in zip(ws, out["zk"]):
        assert J.verify_r1cs_zk(J.deserialize_any(blob), r1cs.public_inputs(w), r1cs)
    assert J.verify_r1cs_compact(J.deserialize_any(out["compact"]), r1cs.public_inputs(ws[0]),
                                 r1cs)


def test_proof_service_on_the_cpu(example):
    mod = example("torch_proof_service")
    out = mod.main(["--device", "cpu"])
    ws = mod.witnesses(6)
    assert len(out["stream"]) == 4 and len(out["rank_launches"]) == 4
    assert [i for i, _b in out["first"]] == list(range(mod.CUT))
    assert [i for i, _b in out["resumed"]] == list(range(6))
    assert out["resumed"][:mod.CUT] == out["first"]
    # every CPU rank ran the plain twins: no kernel launched
    assert all(not any(r.values()) for r in out["rank_launches"])
    r1cs = _jax_mult_circuit(mod.M, mod.Q)
    for i, blob in enumerate(out["stream"]):
        assert J.verify_r1cs(J.deserialize_any(blob), r1cs.public_inputs(ws[i]), r1cs)
    for i, blob in out["resumed"]:
        assert J.verify_r1cs(J.deserialize_any(blob), r1cs.public_inputs(ws[i]), r1cs)


def test_succinct_openings_on_the_cpu(example, monkeypatch):
    monkeypatch.setattr(jfri, "NATIVE_VERIFY", False)  # build no native library of JAX's
    out = example("torch_succinct_openings").main(["--device", "cpu"])
    q, m = J.NTT_MODULUS, 1024
    rng = random.Random(2026)
    xs = [rng.randrange(1, q) for _ in range(m)]
    ys = [rng.randrange(1, q) for _ in range(m)]
    r1cs = _jax_mult_circuit(m, q)
    public = r1cs.public_inputs([1] + xs + ys + [(x * y) % q for x, y in zip(xs, ys)])
    assert J.verify_r1cs(J.deserialize_any(out["base"]), public, r1cs)
    for key in ("succinct", "zk"):
        assert J.verify_r1cs_succinct(J.deserialize_any(out[key]), public, r1cs)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", NAMES)
def test_examples_raise_without_a_card(example, name):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main([])
