"""Kind 7 off the Goldilocks device route, against the JAX package, on the CPU.

The port proves on the host, as the JAX package does, every circuit its
device front end does not take: the 44-bit field 2^44 - 16982015 and the
healthcare prime 2013265921 (both FRI fields of ``proof/fri.py``), and a
Goldilocks circuit proved by ``succinct._prove_host`` directly (the JAX
prover with ``GL_FAST_FRONTEND`` off). The bytes must equal JAX's
``prove_r1cs_succinct``, plain and ZK, singly and through the batch; the
host FRI pieces (``lde``, ``fri_prove``, ``commit_codeword*``,
``batch_inverse``, the folds) must equal JAX's; at ring degree n < m a
circuit whose quotient is zero proves with JAX's bytes and a random
witness raises JAX's ``CommitmentError``; and both verifiers must reject
the JAX tests' tampered ``proof45`` (``tests/test_succinct.py:179-265``)
made by the port. Shapes: m = 16 (8 for the healthcare prime), ring
n = 64, k = 1, ``FriParams(log_blowup=3, num_queries=8)``."""

import dataclasses
import random

import numpy as np
import pytest

from lambda_snark_tpu import Params, Profile, SecurityLevel, setup
from lambda_snark_tpu import prove_r1cs_succinct as jax_prove
from lambda_snark_tpu import verify_r1cs_succinct as jax_verify
from lambda_snark_tpu.core.params import HEALTHCARE_DUMP_MODULUS
from lambda_snark_tpu.proof import fri as jfri
from lambda_snark_tpu.proof import merkle as jmerkle
from lambda_snark_tpu.proof import succinct as jsuccinct
from lambda_snark_tpu.proof.succinct import SuccinctProofR1CS as JaxProof
from lambda_snark_tpu.proof.succinct_batch import prove_r1cs_succinct_batch as jax_batch
from lambda_snark_tpu.r1cs.circuit import CircuitBuilder as JaxBuilder
from lambda_snark_tpu.r1cs.domain import Domain as JaxDomain
from lambda_snark_tpu.utils.chacha import ChaCha20Rng as JaxRng

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import DomainError
from lambda_snark_tpu_torch.proof import fri, merkle
from lambda_snark_tpu_torch.proof.succinct import (
    SuccinctProofR1CS,
    _gl_frontend_applicable,
    _prove_host,
)
from lambda_snark_tpu_torch.r1cs.domain import Domain
from lambda_snark_tpu_torch.utils.chacha import ChaCha20Rng

from test_succinct import mult_circuit, mult_witness

GL = port.NTT_MODULUS
Q45 = port.NTT_FRIENDLY_MODULUS
HC = HEALTHCARE_DUMP_MODULUS
FAST = fri.FriParams(log_blowup=3, num_queries=8)
JFAST = jfri.FriParams(log_blowup=3, num_queries=8)
FIELDS = {"q45": (Q45, 16), "healthcare": (HC, 8)}


def _ctxs(q, n=64):
    return (setup(Params(SecurityLevel.BITS128, Profile.ring_b(n, 1, q, 3.19))),
            port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                        port.Profile.ring_b(n=n, k=1, q=q, sigma=3.19))))


def _circuits(q, m):
    """The JAX test circuit and the port's, on the roots domain (the
    healthcare prime's default domain is sequential)."""
    jr, pr = mult_circuit(m, q), port.multiplication_gates_circuit(m, q)
    if jr.domain.kind != "roots":
        omega = fri.root_of_order(q, m)
        jr = dataclasses.replace(jr, domain=JaxDomain.roots(m, q, omega))
        pr = dataclasses.replace(pr, domain=Domain.roots(m, q, omega))
    return jr, pr


@pytest.fixture(scope="module")
def proved():
    """(field, zk) -> (JAX circuit, port circuit, witness, JAX proof, port proof)."""
    out = {}
    for name, (q, m) in FIELDS.items():
        jctx, ours = _ctxs(q)
        jr, pr = _circuits(q, m)
        w = mult_witness(m, q, seed=3)
        for zk in (False, True):
            theirs = jax_prove(jr, w, jctx, 42, zk=zk, fri_params=JFAST, blinding_seed=77)
            mine = port.prove_r1cs_succinct(pr, w, ours, 42, zk=zk, fri_params=FAST,
                                            blinding_seed=77, device="cpu")
            out[name, zk] = (jr, pr, w, theirs, mine)
    return out


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
@pytest.mark.parametrize("name", list(FIELDS))
def test_kind7_bytes_equal_jax(proved, name, zk):
    jr, pr, w, theirs, mine = proved[name, zk]
    assert not _gl_frontend_applicable(pr)
    assert mine.to_bytes() == theirs.to_bytes()
    assert mine.mask_len == (2 * FAST.num_queries + 8 if zk else 0)
    assert port.verify_r1cs_succinct(mine, pr.public_inputs(w), pr, min_params=FAST)
    assert jax_verify(JaxProof.from_bytes(mine.to_bytes()), jr.public_inputs(w), jr,
                      min_params=JFAST)


def test_kind7_with_a_generator_equals_jax():
    jctx, ours = _ctxs(Q45)
    jr, pr = _circuits(Q45, 16)
    w = mult_witness(16, Q45, seed=4)
    theirs = jax_prove(jr, w, jctx, 1, zk=True, fri_params=JFAST, rng=JaxRng.from_u64(5))
    mine = port.prove_r1cs_succinct(pr, w, ours, 1, zk=True, fri_params=FAST,
                                    rng=ChaCha20Rng.from_u64(5), device="cpu")
    assert mine.to_bytes() == theirs.to_bytes()


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_goldilocks_host_route_equals_jax_golden(monkeypatch, zk):
    """``_prove_host`` on a Goldilocks circuit equals the JAX prover with its
    fast front end switched off (as tests/test_succinct.py:531-553 does)."""
    jctx, ours = _ctxs(GL)
    jr, pr = mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    w = mult_witness(16, GL, seed=2)
    monkeypatch.setattr(jsuccinct, "GL_FAST_FRONTEND", False)
    theirs = jax_prove(jr, w, jctx, 5, zk=zk, blinding_seed=77, fri_params=JFAST)
    mine = _prove_host(pr, w, ours, 5, FAST, ChaCha20Rng.from_u64(77) if zk else None)
    assert mine.to_bytes() == theirs.to_bytes()
    # and the device route (on the CPU twins) gives the same bytes
    assert port.prove_r1cs_succinct(pr, w, ours, 5, zk=zk, blinding_seed=77, fri_params=FAST,
                                    device="cpu").to_bytes() == theirs.to_bytes()


def test_goldilocks_other_root_takes_the_host_route():
    """A Goldilocks circuit whose roots domain uses another primitive
    m-th root is off the device route in both packages and proves on the
    host with JAX's bytes."""
    jctx, ours = _ctxs(GL)
    m = 16
    omega = pow(fri.root_of_order(GL, m), 3, GL)  # another generator of the order-16 group
    jr = dataclasses.replace(mult_circuit(m, GL), domain=JaxDomain.roots(m, GL, omega))
    pr = dataclasses.replace(port.multiplication_gates_circuit(m, GL),
                             domain=Domain.roots(m, GL, omega))
    assert not _gl_frontend_applicable(pr) and not jsuccinct._gl_frontend_applicable(jr)
    ws = [mult_witness(m, GL, seed=i) for i in range(2)]
    theirs = jax_batch(jr, ws, jctx, [1, 2], fri_params=JFAST)
    mine = port.prove_r1cs_succinct_batch(pr, ws, ours, [1, 2], fri_params=FAST, device="cpu")
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
@pytest.mark.parametrize("name", list(FIELDS))
def test_batch_equals_sequential_proofs(name, zk):
    q, m = FIELDS[name]
    jctx, ours = _ctxs(q)
    jr, pr = _circuits(q, m)
    ws = [mult_witness(m, q, seed=10 + i) for i in range(3)]
    kw = dict(zk=zk, blinding_seeds=[21, 22, 23] if zk else None)
    theirs = jax_batch(jr, ws, jctx, [1, 2, 3], fri_params=JFAST, **kw)
    mine = port.prove_r1cs_succinct_batch(pr, ws, ours, [1, 2, 3], fri_params=FAST,
                                          device="cpu", **kw)
    single = [port.prove_r1cs_succinct(pr, w, ours, s, zk=zk, fri_params=FAST,
                                       blinding_seed=b if zk else None, device="cpu")
              for w, s, b in zip(ws, [1, 2, 3], [21, 22, 23])]
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]
    assert [p.to_bytes() for p in single] == [p.to_bytes() for p in theirs]


def test_stream_over_the_44bit_field_equals_batch():
    """The kind-7 stream sends the host-route circuit through the batch."""
    _jctx, ours = _ctxs(Q45)
    _jr, pr = _circuits(Q45, 16)
    ws = [mult_witness(16, Q45, seed=30 + i) for i in range(3)]
    out = list(port.prove_r1cs_succinct_stream(pr, ws, ours, 9, batch=2, fri_params=FAST,
                                               device="cpu"))
    assert [i for i, _p in out] == [0, 1, 2]
    assert all(port.verify_r1cs_succinct(p, [1], pr, min_params=FAST) for _i, p in out)


# --- host FRI pieces against JAX's ---------------------------------------------------


@pytest.mark.parametrize("q", [Q45, GL, HC], ids=["q45", "goldilocks", "healthcare"])
def test_lde_equals_jax(q):
    rng = random.Random(q % 97)
    n = 64
    coeffs = [rng.randrange(q) for _ in range(20)]
    offset, omega = fri.coset_offset(q), fri.root_of_order(q, n)
    mine = fri.lde(coeffs, n, offset, omega, q)
    theirs = jfri.lde(coeffs, n, offset, omega, q)
    assert [int(v) for v in mine] == [int(v) for v in theirs]
    assert isinstance(mine, np.ndarray) == (q == GL)
    with pytest.raises(DomainError):
        fri.lde(coeffs, 16, offset, fri.root_of_order(q, 16), q)


@pytest.mark.parametrize("q", [Q45, GL, HC], ids=["q45", "goldilocks", "healthcare"])
def test_fold_codeword_and_pair_equal_jax(q):
    rng = random.Random(7)
    n = 32
    offset, omega = fri.coset_offset(q), fri.root_of_order(q, n)
    values = [rng.randrange(q) for _ in range(n)]
    c = rng.randrange(q)
    arg = np.array(values, dtype=np.uint64) if q == GL else values
    mine = fri._fold_codeword(arg, offset, omega, c, q)
    theirs = jfri._fold_codeword(arg, offset, omega, c, q)
    assert [int(v) for v in mine] == [int(v) for v in theirs]
    x = offset * pow(omega, 3, q) % q
    assert fri._fold_pair(values[3], values[19], x, c, q) == jfri._fold_pair(
        values[3], values[19], x, c, q)


def test_batch_inverse_and_gl_inverse_array_equal_jax():
    vals = [random.Random(1).randrange(1, Q45) for _ in range(17)]
    assert fri.batch_inverse(vals, Q45) == jfri.batch_inverse(vals, Q45)
    with pytest.raises(DomainError):
        fri.batch_inverse([5, 0, 7], Q45)
    arr = np.array([1, 2, 3, GL - 1, 12345678901234567], dtype=np.uint64)
    assert np.array_equal(fri._gl_inverse_array(arr), jfri._gl_inverse_array(arr))
    with pytest.raises(DomainError):
        fri._gl_inverse_array(np.array([1, 0], dtype=np.uint64))
    assert fri.coset_points(3, 5, 9, Q45) == jfri.coset_points(3, 5, 9, Q45)


@pytest.mark.parametrize("q", [Q45, GL], ids=["q45", "goldilocks"])
def test_commit_codewords_equal_jax(q):
    rng = np.random.default_rng(4)
    cws = [rng.integers(0, q, size=64, dtype=np.uint64) for _ in range(4)]
    lists = [[int(v) for v in cw] for cw in cws]
    assert fri.commit_codeword(lists[0]).root == jfri.commit_codeword(lists[0]).root
    assert fri.commit_codeword_group(cws).root == jfri.commit_codeword_group(lists).root
    assert [t.root for t in fri.commit_codeword_groups([cws[:2], cws[2:]])] == \
        [t.root for t in jfri.commit_codeword_groups([lists[:2], lists[2:]])]
    assert [t.root for t in fri.commit_codewords(cws)] == \
        [t.root for t in jfri.commit_codewords(lists)]
    tree = fri.commit_codeword_group(cws)
    assert tree.path(5) == jfri.commit_codeword_group(lists).path(5)
    with pytest.raises(DomainError):
        fri.commit_codeword_group([cws[0]] * 9)


def test_merkle_forests_equal_jax_trees():
    """The hashlib forests equal the JAX package's trees (its device-hashed
    forests above 4096 leaves, its hashlib trees below)."""
    rng = np.random.default_rng(6)
    lo, hi = (rng.integers(0, GL, size=(3, 8), dtype=np.uint64) for _ in range(2))
    mine = merkle.build_forest_u64_pairs(lo, hi)
    for t in range(3):
        leaves = [lo[t, i].tobytes() + hi[t, i].tobytes() for i in range(8)]
        assert mine[t].root == jmerkle.MerkleTree(leaves).root
    vals = rng.integers(0, GL, size=(2, 3, 16), dtype=np.uint64)
    groups = merkle.build_forest_u64_groups(vals)
    for t in range(2):
        leaves = [b"".join(vals[t, g, i].tobytes() + vals[t, g, i + 8].tobytes()
                           for g in range(3)) for i in range(8)]
        assert groups[t].root == jmerkle.MerkleTree(leaves).root


@pytest.mark.parametrize("q", [Q45, GL, HC], ids=["q45", "goldilocks", "healthcare"])
def test_fri_prove_equals_jax(q):
    """The host fri_prove on a low-degree codeword and one input group."""
    n0 = 256
    rng = random.Random(q % 89)
    offset, omega = fri.coset_offset(q), fri.root_of_order(q, n0)
    polys = [[rng.randrange(q) for _ in range(n0 // 8)] for _ in range(3)]
    mine_cws = [fri.lde(p, n0, offset, omega, q) for p in polys]
    their_cws = [jfri.lde(p, n0, offset, omega, q) for p in polys]
    proofs = []
    for mod, cws in ((fri, mine_cws), (jfri, their_cws)):
        tr = mod.FriTranscript()
        tr.absorb(b"input-root", b"x" * 32)
        tree = mod.commit_codeword_group(cws)
        proofs.append(mod.fri_prove(cws[0], [(cws, tree)], offset, omega, q,
                                    mod.FriParams(3, 8, 8), tr).to_bytes())
    assert proofs[0] == proofs[1]


# --- ring degree n < m ----------------------------------------------------------------


def _identity_circuit(builder_cls, q, m):
    """m gates a_i * 1 = c_i: A = C on the domain, so Q = 0."""
    b = builder_cls(q)
    one = b.alloc_var()
    a = b.alloc_vars(m)
    c = b.alloc_vars(m)
    b.set_public_inputs(1)
    for i in range(m):
        b.add_constraint([(a[i], 1)], [(one, 1)], [(c[i], 1)])
    return b.build()


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_ring_degree_below_m_zero_quotient_proves(zk):
    m = 16
    jctx, ours = _ctxs(GL, n=8)
    jr, pr = _identity_circuit(JaxBuilder, GL, m), _identity_circuit(port.CircuitBuilder, GL, m)
    rng = random.Random(1)
    ws = []
    for _ in range(3):
        a = [rng.randrange(GL) for _ in range(m)]
        ws.append([1] + a + a)
    kw = dict(zk=zk, blinding_seeds=[4, 5, 6] if zk else None)
    # plain: JAX's unfused device branch (its front end without the fused
    # commitment); ZK: its host front end, which commits the same trimmed Q
    theirs = jax_batch(jr, ws, jctx, [1, 2, 3], fri_params=JFAST, device_lde=not zk, **kw)
    mine = port.prove_r1cs_succinct_batch(pr, ws, ours, [1, 2, 3], fri_params=FAST,
                                          device="cpu", **kw)
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]
    assert all(port.verify_r1cs_succinct(p, [1], pr, min_params=FAST) for p in mine)


def test_ring_degree_below_m_random_witness_raises_commitment_error():
    jctx, ours = _ctxs(GL, n=8)
    jr, pr = mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    w = mult_witness(16, GL, seed=1)
    with pytest.raises(Exception) as theirs:
        jax_batch(jr, [w], jctx, [1], fri_params=JFAST, device_lde=False)
    assert type(theirs.value).__name__ == "CommitmentError"
    with pytest.raises(port.CommitmentError) as mine:
        port.prove_r1cs_succinct_batch(pr, [w], ours, [1], fri_params=FAST, device="cpu")
    assert str(mine.value) == str(theirs.value)


def test_pipelined_prover_keeps_its_ring_condition():
    """pipeline_chunk at n < m proves unchunked: the same bytes."""
    m = 16
    _jctx, ours = _ctxs(GL, n=8)
    pr = _identity_circuit(port.CircuitBuilder, GL, m)
    ws = [[1] + [i + 1] * m + [i + 1] * m for i in range(3)]
    whole = port.prove_r1cs_succinct_batch(pr, ws, ours, [1, 2, 3], fri_params=FAST,
                                           device="cpu")
    chunked = port.prove_r1cs_succinct_batch(pr, ws, ours, [1, 2, 3], fri_params=FAST,
                                             pipeline_chunk=1, device="cpu")
    assert [p.to_bytes() for p in chunked] == [p.to_bytes() for p in whole]


# --- tamper cases on the port's proof45 ------------------------------------------------


def _tamper(proof, case, q):
    if case == "wrong_public_inputs":
        return proof, [2]
    if case.startswith("eval_"):
        name = case[5:]
        return dataclasses.replace(proof, **{name: (getattr(proof, name) + 1) % q}), [1]
    if case == "consistent_lie":
        x = proof.challenge_alpha.alpha
        zh = (pow(x, proof.m, q) - 1) % q
        a_new = (proof.a_alpha + 1) % q
        q_new = (a_new * proof.b_alpha - proof.c_alpha) * pow(zh, q - 2, q) % q
        return dataclasses.replace(proof, a_alpha=a_new, q_alpha=q_new), [1]
    if case == "root":
        return dataclasses.replace(proof, input_root=bytes(32)), [1]
    if case == "fri_final":
        final = list(proof.fri.final_coeffs)
        final[0] = (final[0] + 1) % q
        return dataclasses.replace(proof, fri=dataclasses.replace(
            proof.fri, final_coeffs=tuple(final))), [1]
    q0 = proof.fri.queries[0]
    op0 = q0.input_openings[0]
    if case == "path":
        bad_op = dataclasses.replace(op0, path=bytes(32) + op0.path[32:])
    else:  # leaf_value: the Q~ oracle's lo value
        vals = list(op0.values)
        vals[6] = (vals[6] + 1) % q
        bad_op = dataclasses.replace(op0, values=tuple(vals))
    bad_q0 = dataclasses.replace(q0, input_openings=(bad_op,))
    return dataclasses.replace(proof, fri=dataclasses.replace(
        proof.fri, queries=(bad_q0,) + proof.fri.queries[1:])), [1]


TAMPER = ["wrong_public_inputs", "eval_a_alpha", "eval_b_alpha", "eval_c_alpha",
          "eval_q_alpha", "eval_a_beta", "eval_q_beta", "consistent_lie", "root", "fri_final",
          "path", "leaf_value"]


@pytest.fixture(scope="module")
def proof45():
    jctx, ours = _ctxs(Q45)
    jr, pr = _circuits(Q45, 16)
    w = mult_witness(16, Q45)
    mine = port.prove_r1cs_succinct(pr, w, ours, 42, fri_params=FAST, device="cpu")
    assert mine.to_bytes() == jax_prove(jr, w, jctx, 42, fri_params=JFAST).to_bytes()
    return jr, pr, mine


@pytest.mark.parametrize("case", TAMPER)
def test_tampered_proof45_rejected_by_both(proof45, case):
    jr, pr, proof = proof45
    assert port.verify_r1cs_succinct(proof, [1], pr, min_params=FAST)
    bad, public = _tamper(proof, case, Q45)
    assert not port.verify_r1cs_succinct(bad, public, pr, min_params=FAST)
    assert not jax_verify(JaxProof.from_bytes(bad.to_bytes()), public, jr, min_params=JFAST)


def test_weaker_params_rejected_by_policy(proof45):
    jr, pr, proof = proof45
    floor = fri.FriParams(log_blowup=3, num_queries=proof.num_queries + 1)
    assert not port.verify_r1cs_succinct(proof, [1], pr, min_params=floor)
    assert not jax_verify(JaxProof.from_bytes(proof.to_bytes()), [1], jr,
                          min_params=jfri.FriParams(3, proof.num_queries + 1))


def test_q45_two_adic_limit_keeps_its_error():
    """The 44-bit field's codewords stop at 2^13: m = 2^11 at blowup 8
    raises the same DomainError in both packages."""
    jctx, ours = _ctxs(Q45)
    m = 2048
    jr, pr = _circuits(Q45, m)
    w = [1] + [1] * (3 * m)
    with pytest.raises(Exception) as theirs:
        jax_prove(jr, w, jctx, 1, fri_params=JFAST)
    with pytest.raises(DomainError) as mine:
        port.prove_r1cs_succinct(pr, w, ours, 1, fri_params=FAST, device="cpu")
    assert str(mine.value) == str(theirs.value)


def test_q45_largest_codeword_proves():
    """The largest 44-bit instance at blowup 8 (m = 2^10, n0 = 2^13) proves
    with JAX's bytes and verifies."""
    m = 1024
    jctx, ours = _ctxs(Q45, n=m)
    jr, pr = _circuits(Q45, m)
    w = mult_witness(m, Q45, seed=8)
    mine = port.prove_r1cs_succinct(pr, w, ours, 1, fri_params=FAST, device="cpu")
    assert mine.to_bytes() == jax_prove(jr, w, jctx, 1, fri_params=JFAST).to_bytes()
    assert isinstance(port.deserialize_any(mine.to_bytes()), SuccinctProofR1CS)
    assert port.verify_r1cs_succinct(mine, [1], pr, min_params=FAST)
