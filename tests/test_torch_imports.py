"""The PyTorch port stands alone: no jax, no lambda_snark_tpu, CUDA by
default, and ``chip_smoke.py`` refuses to run without a card or without
the repository around it."""

import ast
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch import kernels
from lambda_snark_tpu_torch.commit.lwe_device import DeviceCommitContext
from lambda_snark_tpu_torch.device import resolve
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.ops.quotient import QuotientPlan, quotient
from lambda_snark_tpu_torch.ops.ring_commit import RingCommitPlan, ring_commit
from lambda_snark_tpu_torch.pipeline import field_psi_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = port.NTT_FRIENDLY_MODULUS


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(port.__path__, "lambda_snark_tpu_torch.")
    )


def test_every_module_imports_without_jax():
    # ``__main__`` runs the command line when imported: its import is
    # test_torch_cli.py's ``python -m lambda_snark_tpu_torch info``
    mods = [m for m in _port_modules() if not m.endswith(".__main__")]
    assert len(mods) >= 25
    code = (
        "import sys, importlib\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'lambda_snark_tpu' or m.startswith('lambda_snark_tpu.')]\n"
        "print(repr(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", ["chip_smoke.py", "lambda_snark_tpu_torch"])
def test_no_source_names_jax(path):
    root = os.path.join(REPO, path)
    files = [root] if root.endswith(".py") else [
        os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs if f.endswith(".py")
    ]
    for fname in files:
        with open(fname) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "lambda_snark_tpu"), (fname, name)


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def _ctx():
    return port.LweContext(
        port.Params(port.SecurityLevel.BITS128,
                    port.Profile.ring_b(n=16, k=2, q=Q, sigma=3.19)),
        context_seed=2,
    )


NEW_HOST_MODULES = ["prover", "verifier", "r1cs.poly", "circuits.simple",
                    "circuits.healthcare", "circuits.test_vectors"]


@pytest.mark.parametrize("name", NEW_HOST_MODULES)
def test_host_golden_path_is_walked_by_the_import_rule(name):
    """The host golden path's modules are among those that
    ``test_every_module_imports_without_jax`` imports, and name no device."""
    assert f"lambda_snark_tpu_torch.{name}" in _port_modules()
    with open(os.path.join(REPO, "lambda_snark_tpu_torch", *name.split(".")) + ".py") as f:
        tree = ast.parse(f.read())
    params = [a.arg for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)
              for a in node.args.args + node.args.kwonlyargs]
    assert "device" not in params


CLI_ENTRIES = ["cli_succinct", "cli_witness_bind", "cli_prove_stream", "cli_fuzz"]


def _cli_argv(entry: str, tmp_path) -> list:
    """A command line of the port's CLI whose library call takes ``device``,
    on a 4-gate Goldilocks circuit written to ``tmp_path``."""
    import json

    gl = port.NTT_MODULUS
    r1cs = port.multiplication_gates_circuit(4, gl)
    witness = port.multiplication_gates_witness(4, gl)
    data = {"m": r1cs.m, "n": r1cs.n, "l": r1cs.l, "modulus": gl}
    for side, mat in (("a", r1cs.a), ("b", r1cs.b), ("c", r1cs.c)):
        data[side] = [{"row": i, "col": j, "value": v} for i, j, v in mat.coo()]
    (tmp_path / "c.json").write_text(json.dumps(data))
    (tmp_path / "w.json").write_text(json.dumps([witness]))
    (tmp_path / "ws.json").write_text(json.dumps([witness]))
    files = ["--circuit", str(tmp_path / "c.json")]
    if entry == "cli_fuzz":
        return ["fuzz", "--iterations", "1"]
    if entry == "cli_prove_stream":
        return ["prove-stream", *files, "--witnesses", str(tmp_path / "ws.json")]
    flag = "--succinct" if entry == "cli_succinct" else "--witness-bind"
    (tmp_path / "w.json").write_text(json.dumps(witness))
    return ["prove", *files, "--witness", str(tmp_path / "w.json"), flag,
            "--out", str(tmp_path / "p.bin")]


@pytest.mark.parametrize("entry", ["resolve", "commit_context", "prove", "succinct_batch",
                                   "succinct", "succinct_zk", "succinct_stream", "aggregate",
                                   "succinct_host_route", "witness", "witness_batch",
                                   "witness_stream", "witness_host_route", "device_timer",
                                   *CLI_ENTRIES])
def test_entry_points_default_to_cuda(entry, tmp_path):
    _no_card()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry in CLI_ENTRIES:
            from lambda_snark_tpu_torch import cli

            cli.main(_cli_argv(entry, tmp_path))
        elif entry == "device_timer":
            from lambda_snark_tpu_torch.utils.timing import DeviceTimer

            DeviceTimer(lambda x: x)
        elif entry == "resolve":
            resolve()
        elif entry == "commit_context":
            DeviceCommitContext.from_host(_ctx())
        elif entry == "prove":
            r1cs = port.multiplication_gates_circuit(8, Q)
            port.prove_r1cs_batched(r1cs, [port.multiplication_gates_witness(8, Q)],
                                    _ctx(), seed=1)
        else:
            gl = port.NTT_MODULUS
            r1cs = port.multiplication_gates_circuit(8, gl)
            witness = port.multiplication_gates_witness(8, gl)
            if entry == "succinct":
                port.prove_r1cs_succinct(r1cs, witness, _ctx(), 1)
            elif entry == "succinct_zk":
                port.prove_r1cs_succinct_batch(r1cs, [witness], _ctx(), [1], True,
                                               blinding_seeds=[2])
            elif entry == "succinct_stream":
                port.prove_r1cs_succinct_stream(r1cs, [witness], _ctx(), 1)
            elif entry == "aggregate":
                port.prove_r1cs_succinct_aggregate(r1cs, [witness], _ctx(), [1])
            elif entry in ("succinct_host_route", "witness_host_route"):
                # a 44-bit circuit proves on the host, but the entry point
                # still resolves its device first
                r1cs = port.multiplication_gates_circuit(8, Q)
                prove = port.prove_r1cs_succinct if entry == "succinct_host_route" else \
                    port.prove_r1cs_witness
                prove(r1cs, port.multiplication_gates_witness(8, Q), _ctx(), 1)
            elif entry == "witness":
                port.prove_r1cs_witness(r1cs, witness, _ctx(), 1)
            elif entry == "witness_batch":
                port.prove_r1cs_witness_batch(r1cs, [witness], _ctx(), [1])
            elif entry == "witness_stream":
                port.prove_r1cs_succinct_stream(r1cs, [witness], _ctx(), 1, witness_bind=True)
            else:
                port.prove_r1cs_succinct_batch(r1cs, [witness], _ctx(), [1])


SLICE_MODULES = ["proof.aggregate", "proof.compact", "proof.checks", "proof.succinct_witness",
                 "proof.succinct_witness_device"]
#: the slice modules whose entry points take ``device``
DEVICE_MODULES = ("proof.aggregate", "proof.succinct_witness", "proof.succinct_witness_device")


@pytest.mark.parametrize("name", SLICE_MODULES)
def test_slice_modules_are_walked_by_the_import_rule(name):
    """The kind-8, compact, phase-2 and kind-9 modules are among those that
    ``test_every_module_imports_without_jax`` imports; the host-only ones
    name no device."""
    assert f"lambda_snark_tpu_torch.{name}" in _port_modules()
    with open(os.path.join(REPO, "lambda_snark_tpu_torch", *name.split(".")) + ".py") as f:
        tree = ast.parse(f.read())
    params = [a.arg for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)
              for a in node.args.args + node.args.kwonlyargs]
    assert ("device" in params) == (name in DEVICE_MODULES)


A6_MODULES = ["cli", "__main__", "native_bridge", "lean", "lean.export", "lean.params_io",
              "lean.certificates", "utils.timing", "utils.fuzz", "utils.dudect"]


@pytest.mark.parametrize("name", A6_MODULES)
def test_command_line_modules_are_walked_by_the_import_rule(name):
    """The command line and its auxiliary modules are among the modules
    that ``test_every_module_imports_without_jax`` imports (``__main__``
    through ``python -m``) and whose sources ``test_no_source_names_jax``
    reads."""
    assert f"lambda_snark_tpu_torch.{name}" in _port_modules()


def test_every_jax_export_is_exported():
    """Every name in the JAX package's ``__all__`` is in the port's, and
    every name the port lists exists."""
    jax_init = os.path.join(REPO, "lambda_snark_tpu", "__init__.py")
    with open(jax_init) as f:
        tree = ast.parse(f.read())
    jax_all = next(node.value for node in tree.body if isinstance(node, ast.Assign)
                   and node.targets[0].id == "__all__")
    names = [ast.literal_eval(e) for e in jax_all.elts]
    assert len(names) >= 60
    assert set(names) <= set(port.__all__)
    assert all(hasattr(port, n) for n in port.__all__)
    assert port.__version__ == "0.8.0"
    assert port.Challenge.__module__ == "lambda_snark_tpu_torch.transcript.challenge"


@pytest.mark.parametrize("kind", range(1, 10))
def test_deserialize_any_decodes_every_kind(kind):
    """Kinds 1 to 9 all decode: a body of zeros fails as malformed, and
    never as a kind the port has not ported."""
    blob = b"LSNKTPU1" + bytes([kind]) + bytes(64)
    try:
        port.deserialize_any(blob)
    except port.SerializationError as exc:
        assert "not ported" not in str(exc)


def _run_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True,
                          text=True, cwd=cwd, env=env, timeout=120)


def test_chip_smoke_fails_without_card():
    _no_card()
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_kernel_sources_and_build_dir():
    for fname in kernels.SOURCES.values():
        assert os.path.exists(os.path.join(kernels.CSRC_DIR, fname))
    build = os.path.relpath(kernels.build_dir(), REPO)
    assert build.startswith(os.path.join("build", "torch_kernels"))
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()
    # one launch counter per C entry, and every entry defined in its source
    assert set(kernels.PROTOTYPES) == set(kernels.SOURCES)
    entries = {fn for protos in kernels.PROTOTYPES.values() for fn in protos}
    assert set(kernels.launches()) == entries
    for name, protos in kernels.PROTOTYPES.items():
        with open(os.path.join(kernels.CSRC_DIR, kernels.SOURCES[name])) as f:
            text = f.read()
        for fn in protos:
            assert fn in text


def test_launch_counts_sum_per_entry():
    """``kernels.count`` keys launches by C entry, input shape and variant;
    ``launches()`` sums them per entry, 0 for an entry not launched."""
    saved = dict(kernels.LAUNCHES)
    try:
        kernels.reset_launches()
        kernels.count("ntt_four_step", 2, torch.Size([16, 1 << 14]), "forward mod 5")
        kernels.count("ntt_four_step", 2, (16, 1 << 14), "forward mod 5")
        kernels.count("ntt_four_step", 2, (48, 1 << 14), "inverse mod 5")
        kernels.count("keccak_nodes", 1, (16, 8, 4))
        assert kernels.LAUNCHES == {("ntt_four_step", (16, 1 << 14), "forward mod 5"): 4,
                                    ("ntt_four_step", (48, 1 << 14), "inverse mod 5"): 2,
                                    ("keccak_nodes", (16, 8, 4), ""): 1}
        totals = kernels.launches()
        assert totals["ntt_four_step"] == 6 and totals["keccak_nodes"] == 1
        assert sum(totals.values()) == 7
        kernels.reset_launches()
        assert not kernels.LAUNCHES and not any(kernels.launches().values())
    finally:
        kernels.reset_launches()
        kernels.LAUNCHES.update(saved)


def _qplan():
    return QuotientPlan.create(8, Q, field_psi_for(8, Q))


def _words(shape, dtype=torch.int64):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize("bad", ["width", "dtype", "mismatch", "strided"])
def test_quotient_wrapper_rejects(bad):
    a = _words((2, 8))
    b, c = a.clone(), a.clone()
    if bad == "width":
        a = _words((2, 16))
    elif bad == "dtype":
        a = a.to(torch.int32)
    elif bad == "mismatch":
        b = _words((3, 8))
    else:
        a = _words((8, 2)).t()
    with pytest.raises(ValueError):
        quotient(_qplan(), a, b, c)


def _ring_plan():
    from lambda_snark_tpu_torch.commit.lwe import goldilocks_ring_plan

    return RingCommitPlan.create(np.zeros((2, 16), dtype=np.uint64), goldilocks_ring_plan(16))


@pytest.mark.parametrize("bad", ["s_dtype", "s_shape", "e_shape", "msg_long"])
def test_ring_commit_wrapper_rejects(bad):
    s = _words((2, 3, 16), torch.int32)
    e = _words((3, 16), torch.int32)
    msg = _words((3, 16))
    if bad == "s_dtype":
        s = s.to(torch.int64)
    elif bad == "s_shape":
        s = _words((1, 3, 16), torch.int32)
    elif bad == "e_shape":
        e = _words((3, 8), torch.int32)
    else:
        msg = _words((3, 17))
    with pytest.raises(ValueError):
        ring_commit(_ring_plan(), s, e, msg)


@pytest.mark.cuda
@pytest.mark.parametrize("q", [port.NTT_FRIENDLY_MODULUS, port.NTT_MODULUS])
def test_kernels_match_plain_on_card(q):
    """Kernel Q and kernel R against their plain twins on the card (run with
    ``python -m pytest tests/test_torch_imports.py -m cuda`` on a GPU host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch.ops.quotient import quotient_plain
    from lambda_snark_tpu_torch.ops.ring_commit import ring_commit_plain

    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    plan = QuotientPlan.create(64, q, field_psi_for(64, q), device=dev)
    a, b = (modarith.to_words(rng.integers(0, q, size=(5, 64), dtype=np.uint64), dev)
            for _ in range(2))
    c = modarith.mul_mod(a, b, q)
    for g, w in zip(quotient(plan, a, b, c), quotient_plain(plan, a, b, c)):
        assert torch.equal(g, w)
    dctx = DeviceCommitContext.from_host(_ctx(), dev)
    s = torch.from_numpy(rng.integers(-9, 10, size=(2, 5, 16), dtype=np.int32)).to(dev)
    e = torch.from_numpy(rng.integers(-9, 10, size=(5, 16), dtype=np.int32)).to(dev)
    msg = modarith.to_words(rng.integers(0, Q, size=(5, 9), dtype=np.uint64), dev)
    assert torch.equal(ring_commit(dctx.ring, s, e, msg), ring_commit_plain(dctx.ring, s, e, msg))


@pytest.mark.cuda
def test_keccak_and_ntt_kernels_match_plain_on_card():
    """Kernel K and kernel N against their plain twins on the card (run with
    ``python -m pytest tests/test_torch_imports.py -m cuda`` on a GPU host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch.ops import keccak
    from lambda_snark_tpu_torch.ops.ntt import NttPlan, ntt_forward
    from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched
    from lambda_snark_tpu_torch.ops.ntt_large import (
        NttLargePlan,
        ntt_forward_large,
        ntt_forward_large_plain,
    )
    from lambda_snark_tpu_torch.proof.fri import root_of_order

    rng = np.random.default_rng(6)
    dev = torch.device("cuda")
    gl = port.NTT_MODULUS
    words = lambda shape: modarith.to_words(rng.integers(0, gl, size=shape, dtype=np.uint64), dev)
    for g in range(1, 9):
        vals = words((3, g, 64))
        assert torch.equal(keccak.hash_leaves_flex(vals), keccak.hash_leaves_flex_plain(vals))
    level = words((3, 32, 4))
    assert torch.equal(keccak.hash_nodes(level), keccak.hash_nodes_plain(level))
    for m in (4, 1024, 1 << 13):
        plan = NttLargePlan.create(m, root_of_order(gl, m), device=dev)
        x = words((5, m))
        assert torch.equal(ntt_forward_large(plan, x), ntt_forward_large_plain(plan, x))
    leaf = NttPlan.create(128, gl, root_of_order(gl, 128), device=dev)
    x = words((6, 128))
    assert torch.equal(ntt_forward_batched(leaf, x), ntt_forward(leaf, x))


@pytest.mark.cuda
@pytest.mark.parametrize("q", [port.NTT_FRIENDLY_MODULUS, port.NTT_MODULUS, 2013265921])
def test_kernel_t_matches_plain_on_card(q):
    """Kernel T (``ntt_rows`` up to 2^13 points, ``ntt_four_step`` above, over
    the constexpr fields and the run-time Barrett one) against ``ops.ntt``,
    forward and inverse, on the card (run with ``python -m pytest
    tests/test_torch_imports.py -m cuda --noconftest -q`` on a GPU host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch.ops.ntt import NttPlan, ntt_forward, ntt_inverse
    from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
    from lambda_snark_tpu_torch.proof.fri import root_of_order

    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    sizes = (2, 8, 256, 1 << 13) if q == port.NTT_FRIENDLY_MODULUS else (2, 256, 1 << 13, 1 << 14)
    for size in sizes:
        plan = NttPlan.create(size, q, root_of_order(q, size), device=dev)
        x = modarith.to_words(rng.integers(0, q, size=(3, size), dtype=np.uint64), dev)
        assert torch.equal(ntt_forward_batched(plan, x), ntt_forward(plan, x)), size
        assert torch.equal(ntt_inverse_batched(plan, x), ntt_inverse(plan, x)), size


@pytest.mark.cuda
def test_long_routes_match_plain_on_card():
    """The long routes of kernels Q and R (kernel T's four-step around the
    elementwise entries), called directly at m = n = 2^14, against the plain
    twins, and the four-step with folded pre/post tables."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch.commit.lwe import goldilocks_ring_plan
    from lambda_snark_tpu_torch.ops.ntt_large import (
        NttLargePlan,
        ntt_forward_large,
        ntt_forward_large_plain,
        ntt_inverse_large,
        ntt_inverse_large_plain,
    )
    from lambda_snark_tpu_torch.ops.quotient import quotient_long, quotient_plain
    from lambda_snark_tpu_torch.ops.ring_commit import ring_commit_long, ring_commit_plain
    from lambda_snark_tpu_torch.proof.fri import root_of_order

    rng = np.random.default_rng(8)
    dev = torch.device("cuda")
    gl, m = port.NTT_MODULUS, 1 << 14
    words = lambda shape: modarith.to_words(rng.integers(0, gl, size=shape, dtype=np.uint64), dev)
    plan = QuotientPlan.create(m, gl, field_psi_for(m, gl), device=dev)
    a, b = words((3, m)), words((3, m))
    c = modarith.mul_mod(a, b, gl)
    c[1, 5] = 0
    got, want = quotient_long(plan, a, b, c), quotient_plain(plan, a, b, c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[4].tolist() == [True, False, True]
    ring = RingCommitPlan.create(rng.integers(0, gl, size=(2, m), dtype=np.uint64),
                                 goldilocks_ring_plan(m, dev))
    s = torch.from_numpy(rng.integers(-9, 10, size=(2, 3, m), dtype=np.int32)).to(dev)
    e = torch.from_numpy(rng.integers(-9, 10, size=(3, m), dtype=np.int32)).to(dev)
    msg = words((3, m - 1))
    assert torch.equal(ring_commit_long(ring, s, e, msg), ring_commit_plain(ring, s, e, msg))
    large = NttLargePlan.create(1 << 15, root_of_order(gl, 1 << 15), dev)
    x, pre, post = words((2, 1 << 15)), words((1 << 15,)), words((1 << 15,))
    assert torch.equal(ntt_inverse_large(large, x, pre=pre, post=post),
                       ntt_inverse_large_plain(large, x, pre=pre, post=post))
    assert torch.equal(ntt_forward_large(large, x, pre=pre, post=post),
                       ntt_forward_large_plain(large, x, pre=pre, post=post))


def _hold_q_and_r(rng, dev, q, m, rows, k=2):
    """Kernels Q and R (R over Goldilocks) at one shape against their twins."""
    from lambda_snark_tpu_torch.commit.lwe import goldilocks_ring_plan
    from lambda_snark_tpu_torch.ops.quotient import quotient_plain
    from lambda_snark_tpu_torch.ops.ring_commit import ring_commit_plain

    gl = port.NTT_MODULUS
    words = lambda shape, mod: modarith.to_words(
        rng.integers(0, mod, size=shape, dtype=np.uint64), dev)
    plan = QuotientPlan.create(m, q, field_psi_for(m, q), device=dev)
    a, b = words((rows, m), q), words((rows, m), q)
    c = modarith.mul_mod(a, b, q)
    c[rows - 1:, m // 3:m // 3 + 1] = modarith.add_mod(
        c[rows - 1:, m // 3:m // 3 + 1], torch.ones((1, 1), dtype=torch.int64, device=dev), q)
    got, want = quotient(plan, a, b, c), quotient_plain(plan, a, b, c)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (q, m, rows)
    assert got[4].tolist() == [True] * (rows - 1) + [False]
    if q != gl:
        return
    ring = RingCommitPlan.create(rng.integers(0, gl, size=(k, m), dtype=np.uint64),
                                 goldilocks_ring_plan(m, dev))
    s = torch.from_numpy(rng.integers(-39, 40, size=(k, rows, m), dtype=np.int32)).to(dev)
    e = torch.from_numpy(rng.integers(-39, 40, size=(rows, m), dtype=np.int32)).to(dev)
    msg = words((rows, m // 2 + 1), gl)
    assert torch.equal(ring_commit(ring, s, e, msg), ring_commit_plain(ring, s, e, msg)), m


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
def test_cluster_kernels_match_plain_on_card(monkeypatch, cluster):
    """Kernels Q and R with each row forced onto a cluster of 1, 2, 4 or 8
    blocks, against their twins: both fields of Q, R with k = 1 and 2, rows
    of 2^6 to 2^13 words and, where the cluster holds them, 2^14 and 2^16,
    each in one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(kernels, "cluster_size", lambda rows, m, words: cluster)
    rng = np.random.default_rng(11)
    dev = torch.device("cuda")
    gl = port.NTT_MODULUS
    shapes = [(Q, 64, 3, 2), (Q, 4096, 5, 2), (gl, 64, 3, 2), (gl, 1 << 13, 4, 1)]
    if cluster >= 2:
        shapes.append((gl, 1 << 14, 3, 2))
    if cluster == 8:
        shapes.append((gl, 1 << 16, 2, 1))
    for q, m, rows, k in shapes:
        kernels.reset_launches()
        _hold_q_and_r(rng, dev, q, m, rows, k)
        counts = kernels.launches()
        assert counts["quotient_pointwise"] == counts["ring_twist"] == 0
        assert all(v == f"cluster {cluster}" for (e, _, v) in kernels.LAUNCHES
                   if e in ("quotient_q45", "quotient_goldilocks", "ring_commit_goldilocks"))


@pytest.mark.cuda
def test_cluster_rule_routes_on_card():
    """The default rule: rows of 2^13, 2^14 and 2^16 words in one launch of
    kernels Q and R, rows of 2^17 on the long routes; a cluster that does
    not fit the row raises instead of falling back."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(12)
    dev = torch.device("cuda")
    gl = port.NTT_MODULUS
    for m, rows, one_launch in ((1 << 13, 16, True), (1 << 14, 16, True), (1 << 16, 3, True),
                                (1 << 17, 2, False)):
        kernels.reset_launches()
        _hold_q_and_r(rng, dev, gl, m, rows)
        counts = kernels.launches()
        assert counts["quotient_goldilocks"] == counts["ring_commit_goldilocks"] \
            == (1 if one_launch else 0), m
        assert counts["quotient_pointwise"] == counts["ring_finish"] == (0 if one_launch else 1)
    plan = QuotientPlan.create(16, gl, field_psi_for(16, gl), device=dev)
    x = torch.zeros((2, 16), dtype=torch.int64, device=dev)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "cluster_size", lambda rows, m, words: 8)  # 8^2 > 16
        with pytest.raises(RuntimeError, match="kernel Q"):
            quotient(plan, x, x, x)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3, 8])
def test_forest_entries_match_plain_on_card(g):
    """Kernel K's forest entries (every level in one launch) against their
    twin on the card, for trees smaller and larger than one 64-thread
    block, with each thread taking 1 to 16 leaves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch.ops import keccak

    rng = np.random.default_rng(9)
    dev = torch.device("cuda")
    saved = keccak.FOREST_LOG_LEAVES_PER_THREAD, keccak._FOREST_MIN_LOG_THREADS
    try:
        for log_thread in (0, 2, 4):
            keccak.FOREST_LOG_LEAVES_PER_THREAD, keccak._FOREST_MIN_LOG_THREADS = log_thread, 0
            for trees, half in ((3, 2), (2, 64), (5, 1 << 10), (16, 1 << 14)):
                vals = modarith.to_words(rng.integers(0, 1 << 63, size=(trees, g, 2 * half),
                                                      dtype=np.uint64), dev)
                got = (keccak.merkle_forest(vals[:, 0].contiguous()) if g == 1
                       else keccak.merkle_forest_flex(vals))
                want = keccak.merkle_forest_flex_plain(vals)
                assert len(got) == len(want)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (log_thread, half)
    finally:
        keccak.FOREST_LOG_LEAVES_PER_THREAD, keccak._FOREST_MIN_LOG_THREADS = saved


@pytest.mark.cuda
@pytest.mark.parametrize("q", [port.NTT_FRIENDLY_MODULUS, port.NTT_MODULUS, 2013265921])
def test_dft_pass_deep_routes_match_plain_on_card(monkeypatch, q):
    """Kernel T's ``dft_pass`` on three- and four-pass routes (the leaf cap
    forced to 2^5 points) and on rows of 2 to 2^13 points, forward and
    inverse with ``pre`` / ``post`` / ``scale``, against the twins."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch.ops import ntt_large
    from lambda_snark_tpu_torch.ops.ntt import NttPlan, ntt_forward, ntt_inverse
    from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
    from lambda_snark_tpu_torch.proof.fri import root_of_order

    rng = np.random.default_rng(10)
    dev = torch.device("cuda")
    words = lambda shape: modarith.to_words(rng.integers(0, q, size=shape, dtype=np.uint64), dev)
    for size in (2, 4, 8, 16, 128, 512, 1 << 12):
        plan = NttPlan.create(size, q, root_of_order(q, size), device=dev)
        x = words((6, size))
        assert torch.equal(ntt_forward_batched(plan, x), ntt_forward(plan, x)), size
        assert torch.equal(ntt_inverse_batched(plan, x), ntt_inverse(plan, x)), size
    monkeypatch.setattr(ntt_large, "_MAX_LOG_LEAF", 5)
    deep = (12, 3) if q == port.NTT_FRIENDLY_MODULUS else (16, 4)  # 2-adicity 13 for the 44-bit q
    for log_m, n_passes in ((11, 3), (12, 3), deep):
        m = 1 << log_m
        large = ntt_large.NttLargePlan.create(m, root_of_order(q, m), device=dev, q=q)
        assert large.n_passes == n_passes
        x, pre, post = words((3, m)), words((m,)), words((m,))
        assert torch.equal(ntt_large.ntt_forward_large(large, x, pre=pre, post=post),
                           ntt_large.ntt_forward_large_plain(large, x, pre=pre, post=post))
        assert torch.equal(ntt_large.ntt_inverse_large(large, x, pre=pre, post=post, scale=3),
                           ntt_large.ntt_inverse_large_plain(large, x, pre=pre, post=post,
                                                              scale=3))


def _kind7_instance(m: int, count: int):
    """m multiplication gates over Goldilocks, ``count`` witnesses, a ring
    of n = m (k = 1) and small FRI parameters."""
    from lambda_snark_tpu_torch.proof.fri import FriParams

    gl = port.NTT_MODULUS
    r1cs = port.multiplication_gates_circuit(m, gl)
    ws = [port.multiplication_gates_witness(m, gl, seed=i) for i in range(count)]
    ctx = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                      port.Profile.ring_b(n=m, k=1, q=gl, sigma=3.19)))
    return r1cs, ws, ctx, FriParams(3, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 1 << 10])
def test_zk_kind7_on_card_equals_cpu(m):
    """ZK kind 7 on the card (kernel Q, the mask products and the LDE on
    kernel T, kernels K and R) gives the CPU path's bytes, and the proofs
    verify."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r1cs, ws, ctx, params = _kind7_instance(m, 3)
    seeds, blinds = [1, 2, 3], [4, 5, 6]
    kernels.reset_launches()
    card = port.prove_r1cs_succinct_batch(r1cs, ws, ctx, seeds, True, params, blinds)
    counts = kernels.launches()
    cpu = port.prove_r1cs_succinct_batch(r1cs, ws, ctx, seeds, True, params, blinds,
                                         device="cpu")
    assert [p.to_bytes() for p in card] == [p.to_bytes() for p in cpu]
    assert all(port.verify_r1cs_succinct(p, [1], r1cs, min_params=params) for p in card)
    for entry in ("quotient_goldilocks", "ring_commit_goldilocks", "ntt_four_step",
                  "ntt_rows", "keccak_group_forest"):
        assert counts[entry] >= 1, (entry, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2, 3])
def test_pipelined_on_card_equals_unchunked(chunk):
    """The chunk-pipelined prover on the card (the next chunk's front end
    enqueued before the last chunk is assembled) gives the unchunked
    prover's bytes, tail chunk included, and so does the stream over it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r1cs, ws, ctx, params = _kind7_instance(256, 7)
    seeds = list(range(10, 17))
    plain = port.prove_r1cs_succinct_batch(r1cs, ws, ctx, seeds, fri_params=params)
    piped = port.prove_r1cs_succinct_batch(r1cs, ws, ctx, seeds, fri_params=params,
                                           pipeline_chunk=chunk)
    assert [p.to_bytes() for p in piped] == [p.to_bytes() for p in plain]
    cpu = port.prove_r1cs_succinct_batch(r1cs, ws[:2], ctx, seeds[:2], fri_params=params,
                                         pipeline_chunk=1, device="cpu")
    assert [p.to_bytes() for p in piped[:2]] == [p.to_bytes() for p in cpu]
    streamed = [p for _i, p in port.prove_r1cs_succinct_stream(
        r1cs, ws, ctx, 5, batch=4, fri_params=params, pipeline_chunk=chunk)]
    again = [p for _i, p in port.prove_r1cs_succinct_stream(r1cs, ws, ctx, 5, batch=7,
                                                            fri_params=params)]
    assert [p.to_bytes() for p in streamed] == [p.to_bytes() for p in again]
