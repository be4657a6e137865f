"""The port's command line against the JAX package's: the same files in,
the same proof bytes, descriptors, Lean artifacts, output lines and exit
codes out (``--device cpu`` for the port, whose kernels run as their plain
twins here). The streamed provers are ``test_torch_cli_stream.py``'s."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from lambda_snark_tpu import cli as jax_cli
from lambda_snark_tpu_torch import cli as port_cli
import lambda_snark_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GL = port.NTT_MODULUS
Q45 = port.NTT_FRIENDLY_MODULUS


@pytest.fixture(autouse=True)
def _jax_host_verifier(monkeypatch):
    """The JAX package's verifiers on their hashlib path (the same
    decisions), so that no test here builds its native library in
    ``native/build/``."""
    from lambda_snark_tpu.proof import fri as jax_fri

    monkeypatch.setattr(jax_fri, "NATIVE_VERIFY", False)


def write_circuit(r1cs, path) -> str:
    """``_load_circuit``'s {"a", "b", "c"} COO form of ``r1cs``."""
    data = {"m": r1cs.m, "n": r1cs.n, "l": r1cs.l, "modulus": r1cs.modulus}
    for side, mat in (("a", r1cs.a), ("b", r1cs.b), ("c", r1cs.c)):
        data[side] = [{"row": i, "col": j, "value": v} for i, j, v in mat.coo()]
    with open(path, "w") as f:
        json.dump(data, f)
    return str(path)


def run_both(argv, capsys):
    """(JAX rc, JAX stdout, port rc, port stdout) of one command line."""
    rc_j = jax_cli.main(list(argv))
    out_j = capsys.readouterr().out
    rc_p = port_cli.main(["--device", "cpu", *argv])
    out_p = capsys.readouterr().out
    return rc_j, out_j, rc_p, out_p


def masked(text: str) -> str:
    """Output with every decimal number masked (timings, rates), with the
    padding before it (fixed-width columns)."""
    return re.sub(r" *-?\d+\.\d+", " <x>", text)


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Circuit and witness files: the 7 x 13 = 91 circuit at the CLI's
    default modulus, and 4 multiplication gates over Goldilocks and over
    the 44-bit field."""
    d = tmp_path_factory.mktemp("cli")
    out = {}
    circuits = {"mult": port.multiplication_circuit(port.LEGACY_MODULUS)}
    for name, q in (("gl", GL), ("q45", Q45)):
        circuits[name] = (port.multiplication_gates_circuit(4, q),
                          port.multiplication_gates_witness(4, q, seed=1))
    for name, (r1cs, w) in circuits.items():
        with open(d / f"{name}_w.json", "w") as f:
            json.dump({"witness": w}, f)
        out[name] = (write_circuit(r1cs, d / f"{name}.json"), str(d / f"{name}_w.json"),
                     r1cs.public_inputs(w))
    return out


PROVE_CASES = {
    "kind2": ("mult", []),
    "kind3": ("mult", ["--zk", "--blinding-seed", "5"]),
    "compact": ("mult", ["--compact"]),
    "compact_zk": ("mult", ["--compact", "--zk", "--blinding-seed", "5"]),
    "phase2": ("mult", ["--phase2"]),
    "kind6": ("mult", ["--bind-circuit"]),
    "succinct_goldilocks": ("gl", ["--succinct"]),
    "succinct_44bit": ("q45", ["--succinct"]),
    "succinct_zk_goldilocks": ("gl", ["--succinct", "--zk", "--blinding-seed", "5"]),
    "witness_bind": ("gl", ["--witness-bind"]),
    "witness_bind_zk": ("gl", ["--witness-bind", "--zk", "--blinding-seed", "5"]),
}


@pytest.mark.parametrize("case", sorted(PROVE_CASES))
def test_prove_writes_the_jax_bytes_and_verifies(case, files, tmp_path, capsys):
    circuit, wit_path, public = files[PROVE_CASES[case][0]]
    outs = [str(tmp_path / f"{side}.bin") for side in ("jax", "port")]
    rc_j = jax_cli.main(["prove", "--circuit", circuit, "--witness", wit_path, "--out", outs[0],
                         *PROVE_CASES[case][1]])
    out_j = capsys.readouterr().out
    rc_p = port_cli.main(["--device", "cpu", "prove", "--circuit", circuit, "--witness",
                          wit_path, "--out", outs[1], *PROVE_CASES[case][1]])
    out_p = capsys.readouterr().out
    assert rc_j == rc_p == 0
    assert read(outs[0]) == read(outs[1])
    assert masked(out_j).replace("jax.bin", "port.bin") == masked(out_p)
    if case == "phase2":
        assert read(outs[0] + ".witness-binding") == read(outs[1] + ".witness-binding")
    argv = ["verify", "--circuit", circuit, "--proof", outs[1], "--public",
            ",".join(map(str, public))]
    if case == "phase2":
        argv.append("--phase2")
    rc_j, out_j, rc_p, out_p = run_both(argv, capsys)
    assert rc_j == rc_p == 0
    assert masked(out_j) == masked(out_p) == "verify: ACCEPT ( <x> ms)\n"


def _proof_file(files, tmp_path, case) -> tuple:
    circuit, wit_path, public = files[PROVE_CASES[case][0]]
    out = str(tmp_path / f"{case}.bin")
    assert port_cli.main(["--device", "cpu", "prove", "--circuit", circuit, "--witness",
                          wit_path, "--out", out, *PROVE_CASES[case][1]]) == 0
    return circuit, out, list(public)


@pytest.mark.parametrize("case", ["kind2", "kind3", "compact", "succinct_goldilocks",
                                  "witness_bind"])
@pytest.mark.parametrize("tamper", ["public", "flip", "truncate"])
def test_verify_exit_codes_agree(case, tamper, files, tmp_path, capsys):
    """A wrong public input and a proof whose bytes still decode are
    rejected (rc 1); a proof that no longer decodes is an error (rc 2)."""
    circuit, proof, public = _proof_file(files, tmp_path, case)
    capsys.readouterr()
    data = bytearray(read(proof))
    if tamper == "public":
        public[0] += 1
    elif tamper == "flip":
        data[-40] ^= 0x01  # in the last query's path (kinds 7, 9) or a trailing field
    else:
        data = data[: len(data) // 2]
    with open(proof, "wb") as f:
        f.write(bytes(data))
    rc_j, out_j, rc_p, out_p = run_both(
        ["verify", "--circuit", circuit, "--proof", proof, "--public",
         ",".join(map(str, public))], capsys)
    assert rc_j == rc_p
    assert rc_p == (2 if tamper == "truncate" else 1)
    assert masked(out_j) == masked(out_p)


def test_malformed_circuit_is_an_error(tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text('{"m": 2, "n": "x", "a": []}')
    argv = ["verify", "--circuit", str(bad), "--proof", str(bad), "--public", "1"]
    rc_j = jax_cli.main(argv)
    err_j = capsys.readouterr().err
    rc_p = port_cli.main(["--device", "cpu", *argv])
    err_p = capsys.readouterr().err
    assert rc_j == rc_p == 2
    assert err_j == err_p and err_p.startswith("error: malformed circuit file")


def test_setup_writes_the_jax_descriptor(tmp_path, capsys):
    outs = [str(tmp_path / f"{side}.json") for side in ("jax", "port")]
    argv = ["--modulus", str(GL), "--ring-degree", "8192", "setup", "--rank", "1",
            "--context-seed", "0x2a", "--strict"]
    assert jax_cli.main([*argv, "--out", outs[0]]) == 0
    assert port_cli.main(["--device", "cpu", *argv, "--out", outs[1]]) == 0
    assert read(outs[0]) == read(outs[1])
    assert json.loads(read(outs[1]))["context_seed"] == 42
    capsys.readouterr()
    # --strict refuses the composite legacy modulus in both
    argv = ["--modulus", str(port.LEGACY_COMPOSITE_MODULUS), "setup", "--strict", "--out",
            str(tmp_path / "x.json")]
    rc_j, _, rc_p, _ = run_both(argv, capsys)
    assert rc_j == rc_p == 2


def test_prove_with_a_context_file(files, tmp_path, capsys):
    """``--context``: the descriptor's ring and seed, in both CLIs."""
    circuit, wit_path, _w = files["gl"]
    ctx = str(tmp_path / "ctx.json")
    assert port_cli.main(["--device", "cpu", "--modulus", str(GL), "--ring-degree", "16",
                          "setup", "--rank", "1", "--context-seed", "7", "--out", ctx]) == 0
    outs = [str(tmp_path / f"{side}.bin") for side in ("jax", "port")]
    for main, pre, out in ((jax_cli.main, [], outs[0]),
                           (port_cli.main, ["--device", "cpu"], outs[1])):
        assert main([*pre, "prove", "--circuit", circuit, "--witness", wit_path, "--context",
                     ctx, "--succinct", "--out", out]) == 0
    assert read(outs[0]) == read(outs[1])


@pytest.mark.parametrize("argv", [
    ["r1cs-example"],
    ["range-proof-example", "--value", "200", "--bits", "8"],
    ["--ring-degree", "64", "benchmark", "--sizes", "4,8"],
    ["--ring-degree", "64", "benchmark", "--sizes", "4", "--zk"],
    ["--ring-degree", "64", "benchmark", "--sizes", "4,8", "--compare-zk"],
    ["validate-params", "--lean", "{ n := 4096, k := 2, q := 17592186044423, σ := 3.19, λ := 128 }"],
    ["validate-params", "--lean", "{ n := 4096, k := 2, q := 17592186044417, σ := 3.19, λ := 128 }"],
], ids=["r1cs", "range", "benchmark", "benchmark_zk", "compare_zk", "params", "params_composite"])
def test_examples_print_the_jax_lines(argv, capsys):
    rc_j, out_j, rc_p, out_p = run_both(argv, capsys)
    assert rc_j == rc_p
    assert masked(out_j) == masked(out_p)
    if argv[0] == "--ring-degree":
        assert len(out_p.splitlines()) >= 2


def test_lean_export_prints_and_writes_the_jax_term(files, tmp_path, capsys):
    circuit = files["mult"][0]
    rc_j, out_j, rc_p, out_p = run_both(["lean-export", "--circuit", circuit], capsys)
    assert rc_j == rc_p == 0 and out_j == out_p and out_p.startswith("⟨1, 4, 2, ")
    outs = [str(tmp_path / f"{side}.lean") for side in ("jax", "port")]
    assert jax_cli.main(["lean-export", "--circuit", circuit, "--out", outs[0]]) == 0
    assert port_cli.main(["--device", "cpu", "lean-export", "--circuit", circuit, "--out",
                          outs[1]]) == 0
    assert read(outs[0]) == read(outs[1])


def test_healthcare_example_writes_the_jax_artifacts(tmp_path, capsys, monkeypatch):
    """Into ``--artifacts`` under tmp_path (never the repository's
    ``artifacts/``): the same lines and the same files, and the Lean data
    files equal the committed ones."""
    monkeypatch.delenv(port_cli.REFERENCE_ENV, raising=False)
    dirs = {side: tmp_path / side for side in ("jax", "port")}
    assert jax_cli.main(["healthcare-example", "--artifacts", str(dirs["jax"])]) == 0
    out_j = capsys.readouterr().out
    assert port_cli.main(["--device", "cpu", "healthcare-example", "--artifacts",
                          str(dirs["port"])]) == 0
    out_p = capsys.readouterr().out
    assert out_j.replace(str(dirs["jax"]), "<dir>") == out_p.replace(str(dirs["port"]), "<dir>")
    listing = {side: sorted(os.path.relpath(os.path.join(r, f), d)
                            for r, _, fs in os.walk(d) for f in fs)
               for side, d in dirs.items()}
    assert listing["jax"] == listing["port"] and len(listing["port"]) >= 5
    for rel in listing["port"]:
        assert read(dirs["jax"] / rel) == read(dirs["port"] / rel), rel
    for name in ("HealthcareCircuitData", "HealthcareWitnessData"):
        assert read(dirs["port"] / "lean" / f"{name}.lean") == \
            read(os.path.join(REPO, "artifacts", "lean", f"{name}.lean"))


def test_info_names_the_port_without_jax():
    code = ("import sys, runpy\n"
            "sys.argv = ['lambda_snark_tpu_torch', 'info']\n"
            "try:\n    runpy.run_module('lambda_snark_tpu_torch', run_name='__main__')\n"
            "except SystemExit as e:\n    rc = e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'lambda_snark_tpu')]\n"
            "print('RC', rc, 'BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=env, timeout=120, check=True).stdout
    assert out.startswith("lambda-snark-tpu-torch 0.8.0\n")
    assert "Goldilocks:                    18446744069414584321" in out
    assert ("CUDA unavailable" in out) != torch.cuda.is_available()
    assert "native library: " in out
    assert out.rstrip().endswith("RC 0 BAD []")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


@pytest.mark.parametrize("mode", ["succinct", "witness_bind", "prove_stream", "fuzz"])
def test_device_commands_default_to_cuda(mode, files, tmp_path):
    """Every command whose library call takes ``device`` raises "no CUDA
    device" without a card unless ``--device cpu`` is given; nothing goes on
    on the CPU."""
    _no_card()
    circuit, wit_path, _public = files["gl"]
    out = str(tmp_path / "p.bin")
    if mode == "prove_stream":
        ws = tmp_path / "ws.json"
        ws.write_text(json.dumps([json.loads(open(wit_path).read())["witness"]]))
        argv = ["prove-stream", "--circuit", circuit, "--witnesses", str(ws), "--succinct",
                "--out-dir", str(tmp_path / "out")]
    elif mode == "fuzz":
        argv = ["fuzz", "--iterations", "1"]
    else:
        argv = ["prove", "--circuit", circuit, "--witness", wit_path, "--out", out,
                "--succinct" if mode == "succinct" else "--witness-bind"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_cli.main(argv)
    assert not os.path.exists(out) and not os.path.exists(tmp_path / "out" / "0.proof")


@pytest.mark.parametrize("flags", [[], ["--zk", "--blinding-seed", "5"], ["--compact"],
                                   ["--phase2"]], ids=["plain", "zk", "compact", "phase2"])
def test_host_golden_path_needs_no_card(flags, files, tmp_path, capsys):
    """``prove`` with no mode flag, ``--zk``, ``--compact`` and ``--phase2``
    stay on the host, as in the JAX package: the default ``--device cuda``
    does not matter to them."""
    circuit, wit_path, _w = files["mult"]
    out = str(tmp_path / "p.bin")
    assert port_cli.main(["prove", "--circuit", circuit, "--witness", wit_path, "--out", out,
                          *flags]) == 0
    assert os.path.getsize(out) > 0
    capsys.readouterr()
