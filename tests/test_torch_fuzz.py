"""The port's ``utils/fuzz``, ``utils/dudect`` and ``utils/timing``: the
fuzz corpus blob for blob and the campaigns' counts equal the JAX
package's for the same seeds, the dudect statistic and reports match, and
the timing helpers hold their arithmetic (the bounds of the H100 that
``chip_smoke.py`` reads), their stage marks and their CPU timer."""

import math
import os
import re
import time

import pytest
import torch

from lambda_snark_tpu.utils import dudect as jax_dudect
from lambda_snark_tpu.utils import fuzz as jax_fuzz
from lambda_snark_tpu_torch import cli as port_cli
from lambda_snark_tpu_torch.utils import dudect, fuzz, timing


@pytest.fixture(autouse=True)
def _jax_host_verifier(monkeypatch):
    """The JAX package's verifiers on their hashlib path (the same
    decisions), so that no test here builds its native library in
    ``native/build/``."""
    from lambda_snark_tpu.proof import fri as jax_fri

    monkeypatch.setattr(jax_fri, "NATIVE_VERIFY", False)


@pytest.fixture(scope="module")
def corpora():
    """Each package's corpus, built once (the port's kinds 7-9 on the CPU)."""
    return jax_fuzz._proof_corpus(), fuzz._proof_corpus(device="cpu")


def test_corpus_is_the_jax_corpus(corpora):
    theirs, mine = corpora
    assert len(mine[2]) == len(theirs[2]) == 7  # kinds 2, 3, 4, 1, 7, 8, 9
    for blob_j, blob_p in zip(theirs[2], mine[2]):
        assert blob_p == blob_j
    assert mine[3] == theirs[3]  # the phase-2 witness binding


@pytest.mark.parametrize("seed", [0, 1])
def test_deserializer_campaign_counts_equal_jax(corpora, seed):
    theirs, mine = corpora
    rep = fuzz.fuzz_deserializers(100, seed, _corpus=mine)
    ref = jax_fuzz.fuzz_deserializers(100, seed, _corpus=theirs)
    assert rep.ok and ref.ok
    assert (rep.parsed_ok, rep.rejected) == (ref.parsed_ok, ref.rejected)
    assert rep.summary() == ref.summary()


@pytest.mark.parametrize("seed", [0, 1])
def test_circuit_parser_campaign_counts_equal_jax(seed, tmp_path):
    rep = fuzz.fuzz_circuit_parser(100, seed, tmp_dir=str(tmp_path))
    ref = jax_fuzz.fuzz_circuit_parser(100, seed, tmp_dir=str(tmp_path))
    assert rep.ok and ref.ok and rep.rejected > 0
    assert rep.summary() == ref.summary()


@pytest.mark.parametrize("seed", [0, 1])
def test_verify_campaign_counts_equal_jax(corpora, seed):
    theirs, mine = corpora
    rep = fuzz.fuzz_verify(100, seed, _corpus=mine)
    ref = jax_fuzz.fuzz_verify(100, seed, _corpus=theirs)
    assert rep.ok and ref.ok
    assert (rep.parsed_ok, rep.rejected, rep.verify_accepts) == \
        (ref.parsed_ok, ref.rejected, ref.verify_accepts)
    assert rep.summary() == ref.summary()


def test_fuzz_command_prints_the_reports(capsys, monkeypatch, corpora):
    """``fuzz`` on the CPU prints one summary per harness and "fuzz: OK"."""
    monkeypatch.setattr(fuzz, "_proof_corpus", lambda device="cuda": corpora[1])
    assert port_cli.main(["--device", "cpu", "fuzz", "--iterations", "20", "--seed", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split("]")[0] for ln in lines[:3]] == ["[deserializers", "[circuit-parser",
                                                      "[verify"]
    assert lines[-1] == "fuzz: OK"


def test_welch_t_equals_jax():
    a = [1.0, 2.0, 3.5, 4.25, 9.0, 2.5]
    b = [2.0, 2.0, 5.0, 7.5, 1.0]
    assert dudect.welch_t(a, b) == jax_dudect.welch_t(a, b)
    assert dudect.welch_t([1.0], b) == 0.0 == dudect.welch_t([2.0, 2.0], [2.0, 2.0])
    expect = (sum(a) / 6 - sum(b) / 5) / math.sqrt(
        sum((x - sum(a) / 6) ** 2 for x in a) / 5 / 6 + sum((x - sum(b) / 5) ** 2 for x in b) / 4 / 5)
    assert dudect.welch_t(a, b) == pytest.approx(expect, rel=1e-12)


def _skeleton(path) -> list:
    """A report's headings and field names, without its measured values."""
    with open(path) as f:
        lines = f.read().splitlines()
    return [re.sub(r":.*", ":", ln) if ln.startswith("- ") else ln for ln in lines]


@pytest.mark.parametrize("report", ["mod_pow", "gaussian"])
def test_dudect_reports_have_the_jax_headings(report, tmp_path, monkeypatch):
    from lambda_snark_tpu import native_bridge as jax_native

    # the JAX side samples in Python: its native library is not built here
    monkeypatch.setattr(jax_native, "available", lambda: False)
    outs = {}
    for side, mod in (("jax", jax_dudect), ("port", dudect)):
        d = str(tmp_path / side)
        if report == "mod_pow":
            outs[side] = mod.mod_pow_timing_report(17592186044423, samples=50, out_dir=d)
        else:
            outs[side] = mod.gaussian_timing_report(samples=50, out_dir=d)
        assert os.path.basename(outs[side]) == ("mod_arith_report.md" if report == "mod_pow"
                                               else "gaussian_sampler_report.md")
    assert _skeleton(outs["port"]) == _skeleton(outs["jax"])
    with open(outs["port"]) as f:
        text = f.read()
    assert "- verdict: " in text and "- Welch t statistic: " in text


def test_h100_spec_and_roofline():
    h = timing.H100
    assert h.name == "H100 80GB HBM3, 700 W"
    assert h.mem_bytes_per_s == 3.35e12 and h.int32_ops_per_s == 132 * 64 * 1.98e9
    r = timing.roofline(3.35e9, 1e9)
    assert r["t_memory_s"] == pytest.approx(1e-3) and r["bound_by"] == "bytes"
    assert r["speed_of_light_s"] == r["t_memory_s"]
    r = timing.roofline(0.0, 16.7e12)
    assert r["bound_by"] == "operations"
    assert r["speed_of_light_s"] == pytest.approx(16.7e12 / h.int32_ops_per_s)
    n = timing.ntt_roofline(1 << 10, rows=4)
    assert n["t_memory_s"] == pytest.approx((4 * 2 * 8 * 1024 + 512 * 8) / 3.35e12)
    assert n["t_int32_s"] == pytest.approx(4 * 512 * 10 * timing.NTT_BUTTERFLY_OPS
                                           / h.int32_ops_per_s)


def test_stage_marks_on_and_off(monkeypatch):
    monkeypatch.setattr(timing, "_STAGE_LOG", [])
    monkeypatch.setattr(timing, "STAGE_ENABLED", False)
    timing.stage("a")
    assert timing.stage_report() == ""
    monkeypatch.setattr(timing, "STAGE_ENABLED", True)
    timing.stage("a")
    time.sleep(0.002)
    timing.stage("b")
    timing.stage("c")
    report = timing.stage_report(reset=False)
    lines = report.splitlines()
    assert len(lines) == 2 and lines[0].endswith("ms  a -> b") and lines[1].endswith("b -> c")
    assert float(lines[0].split()[0]) >= 1.0
    assert timing.stage_report() == report and timing.stage_report() == ""


def test_stage_marks_cover_a_kind7_batch(monkeypatch):
    """A kind-7 batch on the CPU route leaves the prover's marks in order."""
    import lambda_snark_tpu_torch as port
    from lambda_snark_tpu_torch.proof.fri import FriParams

    monkeypatch.setattr(timing, "_STAGE_LOG", [])
    monkeypatch.setattr(timing, "STAGE_ENABLED", True)
    gl = port.NTT_MODULUS
    r1cs = port.multiplication_gates_circuit(16, gl)
    ws = [port.multiplication_gates_witness(16, gl, seed=i) for i in range(2)]
    ctx = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                      port.Profile.ring_b(n=16, k=1, q=gl, sigma=3.19)))
    port.prove_r1cs_succinct_batch(r1cs, ws, ctx, [1, 2], fri_params=FriParams(3, 8),
                                   device="cpu")
    labels = [label for label, _t in timing._STAGE_LOG]
    assert labels == ["prove:start", "frontend:lde-dispatch", "frontend:lde-pulled",
                      "frontend:challenges", "frontend:evals-pulled", "prove:transcripts-seeded",
                      "prove:deep-dispatched", "fri:dispatch", "fri:queries-pulled",
                      "prove:fri-done"]


def test_device_timer_on_the_cpu():
    calls = []

    def step(x):
        calls.append(1)
        return x + 1

    timer = timing.DeviceTimer(step, chain=4, device="cpu")
    seconds = timer.measure(torch.zeros(3), iters=2, warmup=1)
    assert seconds >= 0.0 and len(calls) == 4 * 3


def test_device_timer_and_trace_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        timing.DeviceTimer(lambda x: x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with timing.trace(str(tmp_path / "t.json")):
            pass


def test_trace_on_the_cpu(tmp_path):
    path = tmp_path / "trace.json"
    with timing.trace(str(path), device="cpu") as prof:
        torch.ones(64).cumsum(0)
    assert path.exists() and path.stat().st_size > 0
    assert prof.key_averages() is not None
