"""``prove-stream`` in the port's command line against the JAX package's:
m = 16 multiplication gates over the 44-bit field, four witnesses in
batches of two (one batch size, so the JAX stream compiles its stage once
a mode), plain, ``--zk`` and ``--succinct``, with ``--out-dir`` and a
``--store`` resume; and ``prove-stream --succinct`` on the card against the
CPU route. JAX is imported inside the fixtures, so that the ``cuda`` test
runs on a machine without it."""

import io
import json
import os
import re
from contextlib import redirect_stdout

import pytest
import torch

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch import cli as port_cli

Q45 = port.NTT_FRIENDLY_MODULUS
M, COUNT, BATCH = 16, 4, 2
MODES = {"base": [], "zk": ["--zk", "--blinding-seed", "9"], "succinct": ["--succinct"]}


def write_circuit(r1cs, path) -> str:
    data = {"m": r1cs.m, "n": r1cs.n, "l": r1cs.l, "modulus": r1cs.modulus}
    for side, mat in (("a", r1cs.a), ("b", r1cs.b), ("c", r1cs.c)):
        data[side] = [{"row": i, "col": j, "value": v} for i, j, v in mat.coo()]
    with open(path, "w") as f:
        json.dump(data, f)
    return str(path)


def stream_files(d, m: int, q: int, count: int):
    r1cs = port.multiplication_gates_circuit(m, q)
    ws = [port.multiplication_gates_witness(m, q, seed=i) for i in range(count)]
    circuit = write_circuit(r1cs, d / "circuit.json")
    with open(d / "witnesses.json", "w") as f:
        json.dump({"witnesses": ws}, f)
    with open(d / "cut.json", "w") as f:
        json.dump(ws[:BATCH], f)
    return r1cs, ws, circuit


def masked(text: str, *paths) -> str:
    for p in paths:
        text = text.replace(str(p), "<dir>")
    return re.sub(r" *-?\d+\.\d+", " <x>", text)


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX command line's stream of each mode: its out-dir and stdout."""
    from lambda_snark_tpu import cli as jax_cli

    d = tmp_path_factory.mktemp("cli_stream")
    r1cs, ws, circuit = stream_files(d, M, Q45, COUNT)
    runs = {}
    for mode, flags in MODES.items():
        out = d / f"jax_{mode}"
        argv = ["--ring-degree", "64", "prove-stream", "--circuit", circuit, "--witnesses",
                str(d / "witnesses.json"), "--batch", str(BATCH), "--out-dir", str(out), *flags]
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert jax_cli.main(argv) == 0
        runs[mode] = (out, buf.getvalue())
    return d, r1cs, ws, circuit, runs


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prove_stream_writes_the_jax_bytes(mode, jax_runs, tmp_path, capsys):
    d, r1cs, ws, circuit, runs = jax_runs
    jax_out, jax_stdout = runs[mode]
    out = tmp_path / "out"
    argv = ["--device", "cpu", "--ring-degree", "64", "prove-stream", "--circuit", circuit,
            "--witnesses", str(d / "witnesses.json"), "--batch", str(BATCH), "--out-dir",
            str(out), *MODES[mode]]
    assert port_cli.main(argv) == 0
    stdout = capsys.readouterr().out
    assert masked(stdout, out) == masked(jax_stdout, jax_out)
    assert stdout.startswith(f"proved {COUNT} statements ({mode}, batch={BATCH})")
    assert sorted(os.listdir(out)) == sorted(os.listdir(jax_out)) == \
        [f"{i}.proof" for i in range(COUNT)]
    for i in range(COUNT):
        assert read(out / f"{i}.proof") == read(jax_out / f"{i}.proof"), i
    # the command line verifies the first and the last proof
    for i in (0, COUNT - 1):
        public = ",".join(map(str, r1cs.public_inputs(ws[i])))
        assert port_cli.main(["verify", "--circuit", circuit, "--proof",
                              str(out / f"{i}.proof"), "--public", public]) == 0
    assert capsys.readouterr().out.count("verify: ACCEPT") == 2


@pytest.mark.parametrize("mode", ["base", "succinct"])
def test_prove_stream_store_resumes_a_cut_run(mode, jax_runs, tmp_path, capsys):
    """A run cut after one batch leaves its proofs in the store; the full
    run over the same store writes the JAX stream's bytes, and the store
    holds and verifies every statement."""
    d, r1cs, _ws, circuit, runs = jax_runs
    store = tmp_path / "store"
    common = ["--device", "cpu", "--ring-degree", "64", "prove-stream", "--circuit", circuit,
              "--batch", str(BATCH), "--store", str(store), *MODES[mode]]
    assert port_cli.main([*common, "--witnesses", str(d / "cut.json")]) == 0
    assert len(port.ProofStore(str(store)).keys()) == BATCH
    out = tmp_path / "out"
    assert port_cli.main([*common, "--witnesses", str(d / "witnesses.json"), "--out-dir",
                          str(out)]) == 0
    assert f"; store: {store}" in capsys.readouterr().out
    jax_out = runs[mode][0]
    for i in range(COUNT):
        assert read(out / f"{i}.proof") == read(jax_out / f"{i}.proof"), i
    verdicts = port.ProofStore(str(store)).verify_all(r1cs)
    assert len(verdicts) == COUNT and all(verdicts.values())


def test_prove_stream_refuses_a_modulus_without_roots(tmp_path, capsys):
    """At the CLI's default modulus (no NTT domain) the stream is a
    ``DomainError``: exit code 2 in both command lines."""
    from lambda_snark_tpu import cli as jax_cli

    _r1cs, _ws, circuit = stream_files(tmp_path, 4, port.LEGACY_MODULUS, 2)
    argv = ["prove-stream", "--circuit", circuit, "--witnesses",
            str(tmp_path / "witnesses.json")]
    assert jax_cli.main(argv) == 2
    err_j = capsys.readouterr().err
    assert port_cli.main(["--device", "cpu", *argv]) == 2
    err_p = capsys.readouterr().err
    assert err_j == err_p and err_p.startswith("error: ")


@pytest.mark.cuda
def test_prove_stream_succinct_on_card_equals_cpu(tmp_path, capsys):
    """``prove-stream --succinct`` at m = 2^10 over Goldilocks on the card
    (kernels Q, R, T and K) writes the CPU route's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch import kernels

    gl = port.NTT_MODULUS
    r1cs, ws, circuit = stream_files(tmp_path, 1 << 10, gl, 3)
    ctx = str(tmp_path / "ctx.json")
    assert port_cli.main(["--modulus", str(gl), "--ring-degree", str(1 << 10), "setup",
                          "--rank", "1", "--context-seed", "3", "--out", ctx]) == 0
    outs = {}
    for device in ("cuda", "cpu"):
        outs[device] = tmp_path / device
        kernels.reset_launches()
        assert port_cli.main(["--device", device, "prove-stream", "--circuit", circuit,
                              "--witnesses", str(tmp_path / "witnesses.json"), "--context",
                              ctx, "--batch", "2", "--succinct", "--out-dir",
                              str(outs[device])]) == 0
        if device == "cuda":
            counts = kernels.launches()
            for entry in ("quotient_goldilocks", "ring_commit_goldilocks", "ntt_four_step",
                          "ntt_rows", "keccak_group_forest", "keccak_forest"):
                assert counts[entry] >= 1, (entry, counts)
    for i in range(3):
        assert read(outs["cuda"] / f"{i}.proof") == read(outs["cpu"] / f"{i}.proof")
        public = ",".join(map(str, r1cs.public_inputs(ws[i])))
        assert port_cli.main(["verify", "--circuit", circuit, "--proof",
                              str(outs["cuda"] / f"{i}.proof"), "--public", public]) == 0
    capsys.readouterr()
