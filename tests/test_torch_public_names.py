"""The port's counterparts of the JAX package's last public names, against
the JAX package on the CPU.

Each name is held against JAX's on the same numpy-seeded inputs, exactly:
``core.field.vec_mod``, ``core.params.TOY_MODULUS``,
``proof.fri.MAX_GROUP_ORACLES``, ``utils.chacha.chacha20_blocks_keys_np``
(row for row against ``chacha20_block``, as ``tests/test_chacha.py`` does
for JAX's) with ``commit.lwe.randomness_batch`` on it (against JAX's and
the per-seed loop, S = 0, 1, 5 at n = 64, k = 2), ``ChaCha20Rng.gen_u64_mod``,
``commit.lwe.GOLDILOCKS``, ``ops.modarith.reduce_mod``; the members
``SparseMatrix.{from_dense, from_coo, get, to_dense}`` with their corner
cases, ``CircuitBuilder.{bool_gate, linear_gate, num_constraints,
num_vars}``, ``Domain.use_ntt``, ``Profile.scalar_a`` (and ``setup``'s
``InvalidInputError`` on it), ``MerkleTree.from_u64_pairs``; the keywords
``make_mesh(devices=)``, ``ring_mesh(n_devices=)`` and
``native_bridge.build(force=)``; and ``proof.succinct.GL_FAST_FRONTEND``
switched off, at m = 16: kind 7 (plain and ZK, single and batch) proves
on the host route with JAX's bytes, kind 8 raises JAX's ``DomainError``,
and kind 9 proves with JAX's switch-on bytes where JAX's prover raises.
"""

import os
import stat

import jax
import numpy as np
import pytest

import lambda_snark_tpu as J
from lambda_snark_tpu.commit import lwe as jlwe
from lambda_snark_tpu.core import field as jfield
from lambda_snark_tpu.core import params as jparams
from lambda_snark_tpu.core.errors import DomainError as JaxDomainError
from lambda_snark_tpu.core.errors import InvalidInputError as JaxInvalidInputError
from lambda_snark_tpu.core.errors import InvalidParamsError as JaxInvalidParamsError
from lambda_snark_tpu.parallel import mesh as jmesh
from lambda_snark_tpu.proof import fri as jfri
from lambda_snark_tpu.proof import merkle as jmerkle
from lambda_snark_tpu.proof import succinct as jsuccinct
from lambda_snark_tpu.proof.aggregate import prove_r1cs_succinct_aggregate as jax_aggregate
from lambda_snark_tpu.proof.succinct_batch import prove_r1cs_succinct_batch as jax_batch
from lambda_snark_tpu.r1cs.circuit import CircuitBuilder as JaxBuilder
from lambda_snark_tpu.r1cs.domain import Domain as JaxDomain
from lambda_snark_tpu.r1cs.sparse import SparseMatrix as JaxSparse
from lambda_snark_tpu.utils import chacha as jchacha

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch import native_bridge
from lambda_snark_tpu_torch.commit import lwe
from lambda_snark_tpu_torch.core import field, params
from lambda_snark_tpu_torch.core.errors import DomainError, InvalidInputError, InvalidParamsError
from lambda_snark_tpu_torch.ops import keccak, modarith
from lambda_snark_tpu_torch.parallel.multihost import spawn_local
from lambda_snark_tpu_torch.proof import fri, merkle, succinct
from lambda_snark_tpu_torch.r1cs.circuit import CircuitBuilder
from lambda_snark_tpu_torch.r1cs.domain import Domain
from lambda_snark_tpu_torch.r1cs.sparse import SparseMatrix
from lambda_snark_tpu_torch.utils import chacha

import torch_parallel_ranks as ranks
from test_succinct import mult_circuit, mult_witness

GL = port.NTT_MODULUS
Q45 = port.NTT_FRIENDLY_MODULUS
FAST = fri.FriParams(log_blowup=3, num_queries=8)
JFAST = jfri.FriParams(log_blowup=3, num_queries=8)
MODULI = {"goldilocks": GL, "q45": Q45, "toy": 12289, "seven": 7}


# --- the five names of A.9 --------------------------------------------------------------


@pytest.mark.parametrize("q", list(MODULI.values()), ids=list(MODULI))
def test_vec_mod_equals_jax(q):
    rng = np.random.default_rng(q % 1000)
    values = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, size=64)]
    values += [0, -1, q, -q, q - 1, 3 * q + 2, -(1 << 70), (1 << 70) + 5]
    assert field.vec_mod(values, q) == jfield.vec_mod(values, q)
    assert field.vec_mod(values, q) == [v % q for v in values]


def test_toy_modulus_equals_jax():
    assert params.TOY_MODULUS == jparams.TOY_MODULUS == 12289


def test_max_group_oracles_is_one_definition_equal_to_jax():
    assert fri.MAX_GROUP_ORACLES == jfri.MAX_GROUP_ORACLES
    assert fri.MAX_GROUP_ORACLES is keccak.MAX_GROUP_ORACLES


def _keys(count: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(count, 8), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("count, counter, nblocks, nonce", [
    (3, 0, 3, [7, 9]),
    (3, (1 << 32) - 1, 3, [7, 9]),
    (5, 12345, 4, [0, 0]),
    (1, 0, 1, [1, 2]),
    (0, 0, 2, [0, 0]),
])
def test_chacha20_blocks_keys_np_row_for_row(count, counter, nblocks, nonce):
    keys = _keys(count, count + nblocks)
    out = chacha.chacha20_blocks_keys_np(keys, counter, nonce, nblocks)
    assert out.shape == (count, nblocks, 16) and out.dtype == np.uint32
    for ki in range(count):
        for b in range(nblocks):
            assert [int(w) for w in out[ki, b]] == chacha.chacha20_block(
                [int(k) for k in keys[ki]], counter + b, nonce), (ki, b)
    assert np.array_equal(out, jchacha.chacha20_blocks_keys_np(keys, counter, nonce, nblocks))


def test_chacha20_blocks_np_equals_jax():
    key = [int(k) for k in _keys(1, 3)[0]]
    for counter in (0, (1 << 32) - 2):
        assert np.array_equal(chacha.chacha20_blocks_np(key, counter, [4, 5], 5),
                              jchacha.chacha20_blocks_np(key, counter, [4, 5], 5))


@pytest.fixture(scope="module")
def contexts_64():
    """The JAX and port commitment contexts at n = 64, k = 2."""
    return (J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(64, 2, GL, 3.19)),
                    context_seed=3),
            port.setup(port.Params(port.SecurityLevel.BITS128,
                                   port.Profile.ring_b(n=64, k=2, q=GL, sigma=3.19)),
                       context_seed=3))


@pytest.mark.parametrize("s", [0, 1, 5])
def test_randomness_batch_equals_jax_and_the_per_seed_loop(contexts_64, s):
    jctx, ctx = contexts_64
    seeds = [int(x) for x in np.random.default_rng(s).integers(0, 1 << 63, size=s)]
    ss, es = lwe.randomness_batch(ctx, seeds)
    assert ss.shape == (s, 2, 64) and es.shape == (s, 64)
    assert ss.dtype == es.dtype == np.int64
    jss, jes = jlwe.randomness_batch(jctx, seeds)
    assert np.array_equal(ss, jss) and np.array_equal(es, jes)
    for i, seed in enumerate(seeds):
        s_i, e_i = ctx._randomness(seed)
        assert np.array_equal(ss[i], s_i) and np.array_equal(es[i], e_i)


@pytest.mark.parametrize("q", list(MODULI.values()), ids=list(MODULI))
def test_gen_u64_mod_equals_jax(q):
    ours, theirs = chacha.ChaCha20Rng.from_u64(q), jchacha.ChaCha20Rng.from_u64(q)
    assert [ours.gen_u64_mod(q) for _ in range(40)] == [theirs.gen_u64_mod(q) for _ in range(40)]
    # and the stream goes on in step with next_u64
    assert ours.next_u64() == theirs.next_u64()


def test_goldilocks_name_in_commit_lwe():
    assert lwe.GOLDILOCKS == jlwe.GOLDILOCKS == lwe.RING_MODULUS == GL


@pytest.mark.parametrize("q", [GL, Q45], ids=["goldilocks", "q45"])
def test_reduce_mod_equals_jax(q):
    """``reduce_mod`` against JAX's on digit planes, over JAX's domain
    (values below 3q and the planes' 2^(16 D)), and against ``%`` on any
    64-bit word."""
    from lambda_snark_tpu.ops import modarith as jmodarith
    from lambda_snark_tpu.ops.limb import from_limbs, modulus_ctx, to_limbs

    ctx = modulus_ctx(q)
    top = min(3 * q, 1 << (16 * ctx.d))  # 2^64 for Goldilocks
    rng = np.random.default_rng(q % 977)
    v = [int(x) for x in rng.integers(0, 1 << 62, size=200)]
    v = [x * 7 % top for x in v] + [x for x in (0, q - 1, q, 2 * q - 1, top - 1) if x < top]
    got = modarith.to_u64(modarith.reduce_mod(modarith.to_words(np.array(v, np.uint64)), q))
    want = from_limbs(np.asarray(jmodarith.reduce_mod(ctx, to_limbs(np.array(v, np.uint64),
                                                                    ctx.d))))
    assert [int(x) for x in got] == [int(x) for x in np.asarray(want).reshape(-1)]
    words = rng.integers(0, 1 << 64, size=300, dtype=np.uint64, endpoint=False)
    got = modarith.to_u64(modarith.reduce_mod(modarith.to_words(words), q))
    assert [int(x) for x in got] == [int(x) % q for x in words]


# --- GL_FAST_FRONTEND off ----------------------------------------------------------------


@pytest.fixture(scope="module")
def gl16():
    """The JAX and port contexts (n = 64, k = 1) and circuits at m = 16 over
    Goldilocks, and three witnesses."""
    jctx = J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(64, 1, GL, 3.19)))
    ctx = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                      port.Profile.ring_b(n=64, k=1, q=GL, sigma=3.19)))
    return (jctx, ctx, mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL),
            [mult_witness(16, GL, seed=s) for s in range(3)])


@pytest.fixture
def switched_off(monkeypatch):
    monkeypatch.setattr(jsuccinct, "GL_FAST_FRONTEND", False)
    monkeypatch.setattr(succinct, "GL_FAST_FRONTEND", False)


def test_switch_defaults_on_and_gates_the_device_route(gl16, monkeypatch):
    _jctx, _ctx, jr, pr, _ws = gl16
    assert succinct.GL_FAST_FRONTEND is True and jsuccinct.GL_FAST_FRONTEND is True
    assert succinct._gl_frontend_applicable(pr) and jsuccinct._gl_frontend_applicable(jr)
    monkeypatch.setattr(succinct, "GL_FAST_FRONTEND", False)
    assert not succinct._gl_frontend_applicable(pr)


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_kind7_single_with_the_switch_off(gl16, switched_off, zk):
    jctx, ctx, jr, pr, ws = gl16
    theirs = J.prove_r1cs_succinct(jr, ws[0], jctx, 5, zk=zk, fri_params=JFAST,
                                   blinding_seed=77)
    mine = port.prove_r1cs_succinct(pr, ws[0], ctx, 5, zk=zk, fri_params=FAST,
                                    blinding_seed=77, device="cpu")
    assert mine.to_bytes() == theirs.to_bytes()
    assert port.verify_r1cs_succinct(mine, pr.public_inputs(ws[0]), pr, min_params=FAST)


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_kind7_batch_with_the_switch_off(gl16, switched_off, zk):
    jctx, ctx, jr, pr, ws = gl16
    blinding = [4, 5, 6] if zk else None
    theirs = jax_batch(jr, ws, jctx, [1, 2, 3], zk=zk, fri_params=JFAST,
                       blinding_seeds=blinding)
    mine = port.prove_r1cs_succinct_batch(pr, ws, ctx, [1, 2, 3], zk=zk, fri_params=FAST,
                                          blinding_seeds=blinding, device="cpu")
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_kind8_with_the_switch_off_raises_jax_domain_error(gl16, switched_off, zk):
    jctx, ctx, jr, pr, ws = gl16
    blinding = [4, 5, 6] if zk else None
    with pytest.raises(JaxDomainError) as theirs:
        jax_aggregate(jr, ws, jctx, [1, 2, 3], zk=zk, fri_params=JFAST, blinding_seeds=blinding)
    with pytest.raises(DomainError) as mine:
        port.prove_r1cs_succinct_aggregate(pr, ws, ctx, [1, 2, 3], zk=zk, fri_params=FAST,
                                           blinding_seeds=blinding, device="cpu")
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_kind9_with_the_switch_off_proves_jax_switch_on_bytes(gl16, monkeypatch, zk):
    """JAX's kind-9 prover raises off its fast front end on a Goldilocks
    circuit (numpy words reach its Python-int polynomial code); the port's
    host route proves with the bytes JAX gives with the switch on."""
    jctx, ctx, jr, pr, ws = gl16
    on = J.prove_r1cs_witness(jr, ws[0], jctx, 5, zk=zk, fri_params=JFAST, blinding_seed=9)
    monkeypatch.setattr(jsuccinct, "GL_FAST_FRONTEND", False)
    monkeypatch.setattr(succinct, "GL_FAST_FRONTEND", False)
    with pytest.raises(OverflowError):
        J.prove_r1cs_witness(jr, ws[0], jctx, 5, zk=zk, fri_params=JFAST, blinding_seed=9)
    mine = port.prove_r1cs_witness(pr, ws[0], ctx, 5, zk=zk, fri_params=FAST, blinding_seed=9,
                                   device="cpu")
    assert mine.to_bytes() == on.to_bytes()
    assert port.verify_r1cs_witness(mine, pr.public_inputs(ws[0]), pr, min_params=FAST)


# --- members -----------------------------------------------------------------------------


def _csr(mat) -> tuple:
    return mat.rows, mat.cols, mat.row_ptr, mat.col_indices, mat.values


def _outcome(fn):
    """(the result, None) or (None, the exception's type name and text)."""
    try:
        return fn(), None
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return None, (type(exc).__name__, str(exc))


DENSE = {
    "random": np.random.default_rng(1).integers(-3, 4, size=(5, 7)).tolist(),
    "zero_rows": [[0, 0, 0], [0, 5, 0], [0, 0, 0]],
    "empty": [],
    "ragged": [[1, 2], [3]],
    "big": [[(1 << 64) - 1, 0], [0, 1 << 63]],
}


@pytest.mark.parametrize("name", list(DENSE))
def test_sparse_from_dense_equals_jax(name):
    rows = DENSE[name]
    mine, mine_err = _outcome(lambda: SparseMatrix.from_dense(rows))
    theirs, theirs_err = _outcome(lambda: JaxSparse.from_dense(rows))
    assert mine_err == theirs_err
    if mine_err is None:
        assert _csr(mine) == _csr(theirs)


COO = {
    "empty": (3, 4, []),
    "duplicates": (3, 3, [(0, 1, 5), (0, 1, 7), (2, 2, 1), (2, 0, -4), (1, 1, 9)]),
    "cancel": (2, 2, [(0, 0, 3), (0, 0, -3), (1, 1, 2), (1, 0, 0)]),
    "unsorted": (4, 5, [(3, 4, 1), (0, 2, 2), (3, 0, 3), (1, 1, 4), (0, 0, 5)]),
    "out_of_bounds": (2, 2, [(2, 0, 1)]),
}


@pytest.mark.parametrize("name", list(COO))
def test_sparse_from_coo_equals_jax(name):
    rows, cols, entries = COO[name]
    mine, mine_err = _outcome(lambda: SparseMatrix.from_coo(rows, cols, entries))
    theirs, theirs_err = _outcome(lambda: JaxSparse.from_coo(rows, cols, entries))
    assert mine_err == theirs_err
    if mine_err is None:
        assert _csr(mine) == _csr(theirs)


@pytest.mark.parametrize("name", ["duplicates", "cancel", "unsorted", "empty"])
@pytest.mark.parametrize("modulus", [None, 7, GL], ids=["raw", "mod7", "goldilocks"])
def test_sparse_get_and_to_dense_equal_jax(name, modulus):
    rows, cols, entries = COO[name]
    mine, theirs = SparseMatrix.from_coo(rows, cols, entries), JaxSparse.from_coo(rows, cols,
                                                                                  entries)
    for r in range(rows):
        for c in range(cols):  # absent entries included
            assert mine.get(r, c) == theirs.get(r, c)
    got, got_err = _outcome(lambda: mine.to_dense(modulus))
    want, want_err = _outcome(lambda: theirs.to_dense(modulus))
    assert got_err == want_err
    if got_err is None:
        assert got.dtype == want.dtype == np.uint64 and np.array_equal(got, want)


def test_sparse_to_dense_defaults_to_no_modulus():
    mine = SparseMatrix.from_dense([[9, 0], [0, 12]])
    assert np.array_equal(mine.to_dense(), JaxSparse.from_dense([[9, 0], [0, 12]]).to_dense())
    assert mine.to_dense(5).tolist() == [[4, 0], [0, 2]]


def _builders():
    """The same circuit built in both packages with every gate kind."""
    out = []
    for cls, q in ((CircuitBuilder, Q45), (JaxBuilder, Q45)):
        b = cls(q)
        one, x, y, z, s = b.alloc_var(), b.alloc_var(), b.alloc_var(), b.alloc_var(), b.alloc_var()
        b.set_public_inputs(1)
        counts = [(b.num_constraints, b.num_vars)]
        b.bool_gate(one, x)
        b.mul_gate(x, y, z)
        b.linear_gate(one, [(x, 3), (y, 1), (x, 2)], [(s, 1)])
        b.linear_gate(one, [(z, q - 1), (s, 0)], [(y, q - 1)])
        counts.append((b.num_constraints, b.num_vars))
        out.append((b.build(), counts))
    return out


def test_circuit_builder_gates_and_counts_equal_jax():
    (mine, mine_counts), (theirs, theirs_counts) = _builders()
    assert mine_counts == theirs_counts == [(0, 5), (4, 5)]
    for side in ("a", "b", "c"):
        assert _csr(getattr(mine, side)) == _csr(getattr(theirs, side))
    witness = [1, 1, 6, 6, 11]  # x boolean, z = x y, s = 5 x + y, z = y
    assert mine.is_satisfied(witness) and theirs.is_satisfied(witness)
    assert not mine.is_satisfied([1, 2, 6, 12, 16]) and not theirs.is_satisfied([1, 2, 6, 12, 16])


@pytest.mark.parametrize("m, q", [(16, GL), (8, Q45), (6, Q45), (5, 12289)])
def test_domain_use_ntt_equals_jax(m, q):
    mine, theirs = Domain.select(m, q), JaxDomain.select(m, q)
    assert mine.kind == theirs.kind and mine.use_ntt == theirs.use_ntt == (mine.kind == "roots")
    assert Domain.sequential(m, q).use_ntt is False


def test_profile_scalar_a_equals_jax_and_setup_raises_jax_error():
    mine, theirs = port.Profile.scalar_a(Q45, 3.19), J.Profile.scalar_a(Q45, 3.19)
    assert (mine.kind, mine.q, mine.sigma, mine.n, mine.k) == \
        (theirs.kind, theirs.q, theirs.sigma, theirs.n, theirs.k)
    port.Params(port.SecurityLevel.BITS128, mine).validate()
    with pytest.raises(JaxInvalidInputError) as want:
        J.setup(J.Params(J.SecurityLevel.BITS128, theirs))
    with pytest.raises(InvalidInputError) as got:
        port.setup(port.Params(port.SecurityLevel.BITS128, mine))
    assert str(got.value) == str(want.value) == "LweContext requires a RingB profile"
    # validation comes first, as in JAX
    with pytest.raises(JaxInvalidParamsError) as want:
        J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.scalar_a(97, 3.19)))
    with pytest.raises(InvalidParamsError) as got:
        port.setup(port.Params(port.SecurityLevel.BITS128, port.Profile.scalar_a(97, 3.19)))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 2, 16, 256])
def test_merkle_from_u64_pairs_equals_jax(n):
    rng = np.random.default_rng(n)
    lo = rng.integers(0, 1 << 64, size=n, dtype=np.uint64, endpoint=False)
    hi = rng.integers(0, 1 << 64, size=n, dtype=np.uint64, endpoint=False)
    mine, theirs = merkle.MerkleTree.from_u64_pairs(lo, hi), jmerkle.MerkleTree.from_u64_pairs(lo,
                                                                                               hi)
    assert mine.root == theirs.root and mine.num_leaves == theirs.num_leaves == n
    for i in range(n):
        assert mine.path(i) == theirs.path(i)
    leaves = [int(a).to_bytes(8, "little") + int(b).to_bytes(8, "little") for a, b in zip(lo, hi)]
    assert mine.root == merkle.MerkleTree(leaves).root


@pytest.mark.parametrize("n", [3, 6])
def test_merkle_from_u64_pairs_rejects_like_jax(n):
    lo = np.arange(n, dtype=np.uint64)
    with pytest.raises(ValueError) as want:
        jmerkle.MerkleTree.from_u64_pairs(lo, lo)
    with pytest.raises(ValueError) as got:
        merkle.MerkleTree.from_u64_pairs(lo, lo)
    assert str(got.value) == str(want.value)


# --- keywords ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh_keywords():
    return spawn_local(2, ranks.mesh_keywords_rank, (), device="cpu")


def test_make_mesh_devices_takes_the_first_as_jax_does(mesh_keywords):
    devices = jax.devices()
    want = [d.id for d in jmesh.make_mesh([2], ["sp"], devices=devices[:2]).devices.reshape(-1)]
    assert mesh_keywords[0]["listed"] == want == [0, 1]
    longer = jmesh.make_mesh([1, 2], devices=devices[:3]).devices
    assert mesh_keywords[0]["longer"] == [[d.id for d in row] for row in longer] == [[0, 1]]


def test_ring_mesh_n_devices_and_the_keyword_errors(mesh_keywords):
    run = mesh_keywords[0]
    assert run["ring"] == (2,) == tuple(jmesh.ring_mesh(n_devices=2).devices.shape)
    assert run["errors"] == {
        "reversed": "devices [1, 0] must be the world's ranks in order, 0 to 1",
        "short": "need 2 ranks, have 1",
        "disagree": "n=2 and n_devices=1 disagree",
    }
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        jmesh.make_mesh([2], ["sp"], devices=jax.devices()[:1])


def _fake_compiler(tmp_path):
    """A stand-in C++ compiler that logs each call and writes its ``-o``."""
    log = tmp_path / "calls.log"
    script = tmp_path / "fake-cxx"
    script.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{log}"\n'
        'out=""; prev=""\n'
        'for a in "$@"; do if [ "$prev" = "-o" ]; then out="$a"; fi; prev="$a"; done\n'
        'if [ -n "$out" ] && [ "$out" != "/dev/null" ]; then echo lib > "$out"; fi\n')
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script), log


def test_native_build_force_rebuilds(tmp_path, monkeypatch):
    cxx, log = _fake_compiler(tmp_path)
    monkeypatch.setattr(native_bridge, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(native_bridge, "compiler", lambda: cxx)
    builds = lambda: sum(" -shared " in f" {line} " and "-o /dev/null" not in line
                         for line in log.read_text().splitlines())
    path = native_bridge.build()
    assert os.path.exists(path) and builds() == 1
    assert native_bridge.build() == path and builds() == 1  # built: nothing to do
    assert native_bridge.build(force=False) == path and builds() == 1
    assert native_bridge.build(force=True) == path and builds() == 2
    assert os.path.exists(path)
