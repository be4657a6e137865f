"""The port's native bridge against the port's own host code: the library
built by hand from ``native/src`` into ``build/torch_native/`` (never the
JAX package's ``native/build/``), its NTTs, commitments, sampler, R1CS,
Lean export and batched SHA3 and Merkle checks, and ``fri_verify``'s
native path, which must decide as the ``hashlib`` path does on valid and
tampered kind-7, kind-8 and kind-9 proofs. Skips only where no C++
compiler is found."""

import hashlib
import os
import random
import re
import subprocess
import sys

import numpy as np
import pytest

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch import native_bridge as nb
from lambda_snark_tpu_torch.commit import lwe
from lambda_snark_tpu_torch.core import field
from lambda_snark_tpu_torch.ops import gaussian
from lambda_snark_tpu_torch.proof import fri
from lambda_snark_tpu_torch.proof.fri import FriParams
from lambda_snark_tpu_torch.proof.merkle import MerkleTree
from lambda_snark_tpu_torch.r1cs import poly
from lambda_snark_tpu_torch.utils.chacha import ChaCha20Rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q45 = port.NTT_FRIENDLY_MODULUS
GL = port.NTT_MODULUS
TV_Q = 17592186044417


@pytest.fixture(scope="module")
def lib():
    """The built library; a failed build with a compiler present fails."""
    if nb.compiler() is None:
        pytest.skip("no C++ compiler found")
    assert nb.available(), nb.load_error()
    return nb


def test_sources_are_the_cmake_files():
    with open(os.path.join(REPO, "native", "CMakeLists.txt")) as f:
        text = f.read()
    block = re.search(r"add_library\(lambda_snark_native SHARED(.*?)\)", text, re.S).group(1)
    assert list(nb.SOURCES) == [p.split("/")[-1] for p in block.split()]


def test_library_lies_under_build_torch_native(lib):
    path = os.path.relpath(nb.build(), REPO)
    assert path.startswith(os.path.join("build", "torch_native") + os.sep)
    assert path.endswith(nb.LIB_NAME)
    assert not path.startswith(os.path.join("native", "build"))


def test_importing_builds_nothing():
    """Importing every module of the port leaves the bridge untried."""
    code = ("import importlib, pkgutil, lambda_snark_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, 'lambda_snark_tpu_torch.'):\n"
            "    if not m.name.endswith('__main__'): importlib.import_module(m.name)\n"
            "from lambda_snark_tpu_torch import native_bridge as nb\n"
            "print(nb._lib is None and nb.load_error() is None)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120, check=True)
    assert out.stdout.strip() == "True"


def test_two_processes_building_at_once_both_load(lib, tmp_path):
    code = ("import sys; from lambda_snark_tpu_torch import native_bridge as nb\n"
            f"nb.BUILD_ROOT = {str(tmp_path)!r}\n"
            "ok = nb.available()\n"
            "print(ok, nb.build() if ok else nb.load_error())\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = [o.strip() for o, _e in outs]
    assert lines[0] == lines[1] and lines[0].startswith(f"True {tmp_path}")
    built = [f for _r, _d, fs in os.walk(tmp_path) for f in fs]
    assert built.count(nb.LIB_NAME) == 1 and not any(f.endswith(".tmp") for f in built)


def test_ntt_matches_the_host_transforms(lib):
    n = 64
    ntt = nb.NativeNtt(n, Q45)
    psi, omega = ntt.psi, ntt.omega
    assert field.mul_mod(psi, psi, Q45) == omega and field.mod_pow(psi, n, Q45) == Q45 - 1
    rng = random.Random(1)
    data = [rng.randrange(Q45) for _ in range(n)]
    got = ntt.forward_cyclic(data)
    assert got == poly.ntt_forward(data, Q45, omega)
    assert ntt.inverse_cyclic(got) == data
    fa = ntt.forward(data)
    assert ntt.inverse(fa) == data
    data2 = [rng.randrange(Q45) for _ in range(n)]
    prod = ntt.inverse(ntt.mul_pointwise(fa, ntt.forward(data2)))
    full = poly.poly_mul(data, data2, Q45) + [0] * (2 * n)
    assert prod == [(full[i] - full[i + n]) % Q45 for i in range(n)]  # negacyclic
    with pytest.raises(ValueError):
        ntt.forward(data[:-1])


def test_goldilocks_ntt_roundtrip_and_convolution(lib):
    n = 32
    ntt = nb.NativeNtt(n, GL)
    rng = random.Random(2)
    a = [rng.randrange(GL) for _ in range(n)]
    b = [rng.randrange(GL) for _ in range(n)]
    assert ntt.inverse(ntt.forward(a)) == a
    full = poly.poly_mul(a, b, GL) + [0] * (2 * n)
    got = ntt.inverse(ntt.mul_pointwise(ntt.forward(a), ntt.forward(b)))
    assert got == [(full[i] - full[i + n]) % GL for i in range(n)]


def test_commitment_matches_commit_lwe(lib):
    n, k = 64, 2
    params = port.Params(port.SecurityLevel.BITS128, port.Profile.ring_b(n=n, k=k, q=TV_Q,
                                                                        sigma=3.19))
    ctx = lwe.LweContext(params, context_seed=9)
    nat = nb.NativeLwe(n=n, k=k, q=TV_Q, sigma=3.19, context_seed=9)
    for j in range(k):
        assert nat.matrix_row(j) == [int(v) for v in ctx.a_hat[j]]
    msg = [1, 7, 13, 91, TV_Q - 1]
    for seed in (0, 1, 0xCAFEBABE):
        comm, _opening = lwe.commit(ctx, msg, seed)
        assert nat.commit_words(msg, seed) == comm.as_words(), seed
    words = nat.commit_words(msg, 42)
    assert nat.verify_opening(words, msg, 42)
    assert not nat.verify_opening(words, [1, 7, 13, 91, 6], 42)
    assert not nat.verify_opening(words, msg, 43)
    c1, _ = lwe.commit(ctx, [1, 2, 3], 5)
    c2, _ = lwe.commit(ctx, [4, 5, 6], 6)
    combined = lwe.linear_combine(ctx, [c1, c2], [2, 3])
    assert nat.linear_combine_words([nat.commit_words([1, 2, 3], 5),
                                     nat.commit_words([4, 5, 6], 6)], [2, 3]) == \
        combined.as_words()


@pytest.mark.parametrize("sigma", [3.19, 3.2, 4.5, 0.7])
def test_cdt_table_equals_build_cdf(lib, sigma):
    assert np.array_equal(nb.gaussian_cdt_table(sigma), gaussian.build_cdf(sigma))


def test_seeded_sampler_equals_the_host_sampler(lib):
    key = hashlib.sha3_256(b"test-key").digest()
    want = gaussian.sample_signed_vectorized(ChaCha20Rng(key), gaussian.build_cdf(3.19), 500)
    assert np.array_equal(nb.sample_gaussian_seeded(500, 3.19, key), want)
    samples = nb.sample_gaussian(4000, 3.19)
    assert abs(float(samples.mean())) < 0.3 and 2.7 < float(samples.std()) < 3.7
    with pytest.raises(ValueError):
        nb.sample_gaussian_seeded(4, 3.19, b"short")


def test_r1cs_signed_values_and_spmv(lib):
    """-1 as a u64 two's complement is q - 1 (tv-2's semantics)."""
    nat = nb.NativeR1cs(1, 3, TV_Q, [(0, 0, 1)], [(0, 1, 1), (0, 2, -1)], [])
    assert nat.validate_witness([1, 5, 5]) and not nat.validate_witness([1, 5, 4])
    r1cs = port.multiplication_gates_circuit(8, TV_Q)
    w = port.multiplication_gates_witness(8, TV_Q, seed=3)
    nat = nb.NativeR1cs(r1cs.m, r1cs.n, r1cs.modulus, r1cs.a.coo(), r1cs.b.coo(), r1cs.c.coo())
    assert nat.validate_witness(w)
    az, bz, cz = r1cs.compute_constraint_evals(w)
    assert [nat.sparse_mv(i, w) for i in range(3)] == [az, bz, cz]


def test_lean_export_equals_lean_export_module(lib):
    from lambda_snark_tpu_torch.circuits.healthcare import build_healthcare_circuit
    from lambda_snark_tpu_torch.lean import export as lean_export
    from lambda_snark_tpu_torch.lean.params_io import SecurityParams

    r1cs = build_healthcare_circuit(TV_Q)
    nat = nb.NativeR1cs(r1cs.m, r1cs.n, r1cs.modulus, r1cs.a.coo(), r1cs.b.coo(), r1cs.c.coo())
    assert nat.vk_to_lean(r1cs.l) == lean_export.vk_to_lean(r1cs)
    parsed = SecurityParams.from_lean(nb.params_to_lean(4096, 2, TV_Q, 3.19, 128))
    assert (parsed.n, parsed.k, parsed.q, parsed.lam) == (4096, 2, TV_Q, 128)


@pytest.mark.parametrize("msg_len", [16, 65, 96, 129, 135])
def test_sha3_batch_equals_hashlib(lib, msg_len):
    msgs = np.random.default_rng(msg_len).integers(0, 256, (37, msg_len), dtype=np.uint8)
    got = nb.sha3_256_batch(msgs)
    for i in range(msgs.shape[0]):
        assert bytes(got[i]) == hashlib.sha3_256(msgs[i].tobytes()).digest()


@pytest.mark.parametrize("width,n_leaves", [(16, 64), (64, 32)])
def test_merkle_verify_batch_equals_verify_path(lib, width, n_leaves):
    rng = np.random.default_rng(3)
    raw = [rng.integers(0, 256, width, dtype=np.uint8).tobytes() for _ in range(n_leaves)]
    tree = MerkleTree(raw)
    depth = n_leaves.bit_length() - 1
    lanes = n_leaves + 3  # every honest lane and three corrupted ones
    leaves = np.zeros((lanes, width), dtype=np.uint8)
    idx = np.zeros(lanes, dtype=np.uint64)
    sib = np.zeros((lanes, depth, 32), dtype=np.uint8)
    for i in range(lanes):
        src = i if i < n_leaves else 0
        leaves[i] = np.frombuffer(raw[src], dtype=np.uint8)
        idx[i] = src
        for lvl, digest in enumerate(tree.path(src)):
            sib[i, lvl] = np.frombuffer(digest, dtype=np.uint8)
    leaves[n_leaves, 0] ^= 0xFF
    idx[n_leaves + 1] = 1
    sib[n_leaves + 2, 0, 0] ^= 0xFF
    ok = nb.merkle_verify_batch(leaves, idx, sib, np.full(lanes, depth, dtype=np.uint32),
                                np.tile(np.frombuffer(tree.root, dtype=np.uint8), (lanes, 1)))
    assert bool(ok[:n_leaves].all()) and not ok[n_leaves:].any()
    for i in range(lanes):
        path = [sib[i, lvl].tobytes() for lvl in range(depth)]
        assert fri.verify_path(tree.root, int(idx[i]), leaves[i].tobytes(), path) == ok[i]


# --- fri_verify: the native path decides as the hashlib path does -------------


@pytest.fixture(scope="module")
def proofs():
    """Kind 7 (3 statements), kind 8 (their aggregate) and kind 9 (plain
    and ZK), at m = 16 over Goldilocks on the CPU twins."""
    m = 16
    r1cs = port.multiplication_gates_circuit(m, GL)
    ws = [port.multiplication_gates_witness(m, GL, seed=i) for i in range(3)]
    ctx = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                      port.Profile.ring_b(n=m, k=1, q=GL, sigma=3.19)))
    fp = FriParams(3, 8)
    publics = [r1cs.public_inputs(w) for w in ws]
    k7 = port.prove_r1cs_succinct_batch(r1cs, ws, ctx, [1, 2, 3], fri_params=fp, device="cpu")
    k8 = port.prove_r1cs_succinct_aggregate(r1cs, ws, ctx, [1, 2, 3], fri_params=fp,
                                            device="cpu")
    k9 = port.prove_r1cs_witness(r1cs, ws[0], ctx, 5, fri_params=fp, device="cpu")
    k9z = port.prove_r1cs_witness(r1cs, ws[0], ctx, 5, zk=True, blinding_seed=6, fri_params=fp,
                                  device="cpu")
    return {
        "kind7": (k7[0], lambda p: port.verify_r1cs_succinct(p, publics[0], r1cs,
                                                             min_params=fp)),
        "kind8": (k8, lambda p: port.verify_r1cs_succinct_aggregate(p, publics, r1cs,
                                                                    min_params=fp)),
        "kind9": (k9, lambda p: port.verify_r1cs_witness(p, publics[0], r1cs, min_params=fp)),
        "kind9_zk": (k9z, lambda p: port.verify_r1cs_witness(p, publics[0], r1cs,
                                                             min_params=fp)),
    }


def _decisions(monkeypatch, verify, proof):
    out = []
    for flag in (True, False):
        monkeypatch.setattr(fri, "NATIVE_VERIFY", flag)
        out.append(verify(proof))
    return out


@pytest.mark.parametrize("kind", ["kind7", "kind8", "kind9", "kind9_zk"])
def test_fri_verify_native_decides_as_hashlib(lib, proofs, kind, monkeypatch):
    """The valid proof is accepted on both paths; 24 proofs with one bit
    flipped (18 of them inside the FRI proof, which ends the wire bytes)
    that still decode get the same decision from both, nearly all a
    rejection."""
    proof, verify = proofs[kind]
    calls = []
    real = nb.merkle_verify_batch
    monkeypatch.setattr(nb, "merkle_verify_batch",
                        lambda *a: calls.append(1) or real(*a))
    assert _decisions(monkeypatch, verify, proof) == [True, True]
    assert calls, "the native path was not taken"
    data = proof.to_bytes()
    fri_start = len(data) - len(proof.fri.to_bytes())
    rng = random.Random(kind)
    compared = rejected = 0
    assert data.endswith(proof.fri.to_bytes())
    for trial in range(24):
        lo = fri_start if trial % 4 else 0
        bad = bytearray(data)
        i = rng.randrange(lo, len(bad))
        bad[i] ^= 1 << rng.randrange(8)
        try:
            tampered = port.deserialize_any(bytes(bad))
        except port.LambdaSnarkError:
            continue
        native, host = _decisions(monkeypatch, verify, tampered)
        assert native == host, (kind, i)
        compared += 1
        rejected += not host
    assert compared >= 12 and rejected >= compared - 1
