"""The port's zero-knowledge kind 7 against the JAX package, on the CPU.

``prove_r1cs_succinct_batch(zk=True, device="cpu")`` (every kernel as its
plain twin: kernel Q, the mask products and the LDE on kernel T, kernels K
and R) must give the bytes of the JAX ``prove_r1cs_succinct_batch(zk=True,
device_lde=False)``, at m = 16 (mask_len 24 > m, where Z_H rho overlaps
itself) and m = 64, with ``FriParams(log_blowup=3, num_queries=8)``. The
single prover must equal JAX's with a blinding seed and with a generator;
both verifiers must accept the proofs and reject tampered ones; the view
of a proof and the simulated view must equal JAX's."""

import dataclasses

import numpy as np
import pytest

from lambda_snark_tpu import Params, Profile, SecurityLevel, setup
from lambda_snark_tpu.proof.fri import FriParams as JaxFriParams
from lambda_snark_tpu.proof.succinct import prove_r1cs_succinct as jax_prove_one
from lambda_snark_tpu.proof.succinct import simulate_succinct_view as jax_simulate
from lambda_snark_tpu.proof.succinct import succinct_view as jax_view
from lambda_snark_tpu.proof.succinct import verify_r1cs_succinct as jax_verify
from lambda_snark_tpu.proof.succinct import SuccinctProofR1CS as JaxProof
from lambda_snark_tpu.proof.succinct_batch import _gl_batch_frontend
from lambda_snark_tpu.proof.succinct_batch import prove_r1cs_succinct_batch as jax_prove
from lambda_snark_tpu.utils.chacha import ChaCha20Rng as JaxRng

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import InvalidDimensionsError
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.proof import succinct_device
from lambda_snark_tpu_torch.proof.fri import FriParams, coset_offset
from lambda_snark_tpu_torch.proof.succinct import _check_instance
from lambda_snark_tpu_torch.proof.succinct_batch import _draw_masks, _embed_and_eval

from test_succinct import mult_circuit, mult_witness

GL = port.NTT_MODULUS
SEEDS, BLINDS = [11, 12, 13], [101, 102, 103]
FAST = (3, 8)


def _ctxs(q=GL, n=64):
    jax_ctx = setup(Params(SecurityLevel.BITS128, Profile.ring_b(n, 1, q, 3.19)))
    ours = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=n, k=1, q=q, sigma=3.19)))
    return jax_ctx, ours


@pytest.fixture(scope="module")
def ctxs():
    return _ctxs()


def _instance(m, q=GL):
    return (mult_circuit(m, q), port.multiplication_gates_circuit(m, q),
            [mult_witness(m, q, seed=i) for i in range(3)])


@pytest.fixture(scope="module")
def proved(ctxs):
    """m -> (JAX circuit, port circuit, witnesses, JAX proofs, port proofs)."""
    jax_ctx, ours = ctxs
    out = {}
    for m in (16, 64):
        jr, pr, ws = _instance(m)
        theirs = jax_prove(jr, ws, jax_ctx, SEEDS, zk=True, fri_params=JaxFriParams(*FAST),
                           blinding_seeds=BLINDS, device_lde=False)
        mine = port.prove_r1cs_succinct_batch(pr, ws, ours, SEEDS, zk=True,
                                              fri_params=FriParams(*FAST),
                                              blinding_seeds=BLINDS, device="cpu")
        out[m] = (jr, pr, ws, theirs, mine)
    return out


@pytest.mark.parametrize("m", [16, 64])
def test_zk_batch_bytes_equal_jax(proved, m):
    _jr, _pr, _ws, theirs, mine = proved[m]
    assert [p.to_bytes() for p in mine] == [p.to_bytes() for p in theirs]
    assert all(p.mask_len == 2 * FAST[1] + 8 for p in mine)


@pytest.mark.parametrize("m", [16, 64])
def test_zk_frontend_matches_jax_host_frontend(ctxs, m):
    """The masked polynomials' codewords, roots, commitments (to the
    unmasked Q) and evaluations equal JAX's host front end."""
    jax_ctx, ours = ctxs
    jr, pr, ws = _instance(m)
    fe = _gl_batch_frontend(jr, ws, jax_ctx, SEEDS, True, JaxFriParams(*FAST), BLINDS, False)
    mask_len = 2 * FAST[1] + 8
    _d_bound, n0, _omega = _check_instance(pr, FriParams(*FAST), mask_len)
    masks = _draw_masks([port.ChaCha20Rng.from_u64(b) for b in BLINDS], mask_len, GL)
    az, bz, cz = _embed_and_eval(pr, ws, "cpu")
    lde, comms, polys, forest = succinct_device.quotient_lde_device(
        az, bz, cz, n0, coset_offset(GL), ours, SEEDS, masks)
    assert polys.shape == (3, 4, m + 2 * mask_len)
    assert np.array_equal(modarith.to_u64(lde), fe.cw)
    assert forest.roots == [r[0] for r in fe.roots]
    assert all(np.array_equal(a.words, b.words) for a, b in zip(comms, fe.commitments))
    assert np.array_equal(succinct_device.eval_device(polys, fe.alphas, fe.betas), fe.evals)


@pytest.mark.parametrize("out_len", [2, 39, 135])
def test_mask_products_are_exact(out_len):
    """Kernel T's convolutions (the plain twin here) give the schoolbook
    products, summed, at any length."""
    rng = np.random.default_rng(out_len)
    la = (out_len + 1) // 2
    lb = out_len + 1 - la
    xs = [rng.integers(0, GL, size=(2, la), dtype=np.uint64) for _ in range(2)]
    ys = [rng.integers(0, GL, size=(2, lb), dtype=np.uint64) for _ in range(2)]
    got = succinct_device._sum_of_products([modarith.to_words(x) for x in xs],
                                           [modarith.to_words(y) for y in ys], out_len)
    want = np.zeros((2, out_len), dtype=object)
    for x, y in zip(xs, ys):
        for r in range(2):
            for i, a in enumerate(x[r].tolist()):
                for j, b in enumerate(y[r].tolist()):
                    want[r, i + j] = (want[r, i + j] + a * b) % GL
    assert modarith.to_u64(got).tolist() == want.tolist()


@pytest.mark.parametrize("how", ["seed", "rng"])
def test_zk_single_equals_jax_single(ctxs, how):
    jax_ctx, ours = ctxs
    jr, pr, ws = _instance(16)
    if how == "seed":
        theirs = jax_prove_one(jr, ws[1], jax_ctx, 5, True, JaxFriParams(*FAST), blinding_seed=9)
        mine = port.prove_r1cs_succinct(pr, ws[1], ours, 5, True, FriParams(*FAST),
                                        blinding_seed=9, device="cpu")
    else:
        theirs = jax_prove_one(jr, ws[1], jax_ctx, 5, True, JaxFriParams(*FAST),
                               rng=JaxRng.from_u64(77))
        rng = port.ChaCha20Rng.from_u64(77)
        mine = port.prove_r1cs_succinct(pr, ws[1], ours, 5, True, FriParams(*FAST), rng=rng,
                                        device="cpu")
        # three masks of mask_len draws each, as the JAX prover takes them
        after = JaxRng.from_u64(77)
        for _ in range(3 * (2 * FAST[1] + 8)):
            after.next_u64()
        assert rng.next_u64() == after.next_u64()
    assert mine.to_bytes() == theirs.to_bytes()


def test_zk_batch_equals_singles(proved):
    _jr, pr, ws, _theirs, mine = proved[16]
    _jax_ctx, ours = _ctxs()
    for w, seed, blind, proof in zip(ws, SEEDS, BLINDS, mine):
        single = port.prove_r1cs_succinct(pr, w, ours, seed, True, FriParams(*FAST),
                                          blinding_seed=blind, device="cpu")
        assert single.to_bytes() == proof.to_bytes()


def test_zk_os_entropy_proofs_verify(ctxs):
    """No seed and no generator: fresh masks, a proof that verifies and
    differs from run to run."""
    _jax_ctx, ours = ctxs
    _jr, pr, ws = _instance(16)
    a, b = (port.prove_r1cs_succinct(pr, ws[0], ours, 5, True, FriParams(*FAST), device="cpu")
            for _ in range(2))
    assert a.to_bytes() != b.to_bytes()
    assert port.verify_r1cs_succinct(a, [1], pr, min_params=FriParams(*FAST))


def _tamper(proof, how):
    if how == "valid":
        return proof
    if how == "q_alpha":
        return dataclasses.replace(proof, q_alpha=(proof.q_alpha + 1) % GL)
    if how == "mask_len":
        return dataclasses.replace(proof, mask_len=proof.mask_len - 1)
    q0 = proof.fri.queries[0]
    op = q0.input_openings[0]
    if how == "path":
        op = dataclasses.replace(op, path=bytes([op.path[0] ^ 1]) + op.path[1:])
    else:  # an opened value of the masked A~
        op = dataclasses.replace(op, values=((op.values[0] + 1) % GL,) + op.values[1:])
    q0 = dataclasses.replace(q0, input_openings=(op,))
    fri = dataclasses.replace(proof.fri, queries=(q0,) + proof.fri.queries[1:])
    return dataclasses.replace(proof, fri=fri)


@pytest.mark.parametrize("how", ["valid", "q_alpha", "mask_len", "path", "value"])
def test_verifiers_agree_on_zk_proofs(proved, how):
    jr, pr, _ws, _theirs, mine = proved[64]
    blob = _tamper(mine[0], how).to_bytes()
    theirs = jax_verify(JaxProof.from_bytes(blob), [1], jr, min_params=JaxFriParams(*FAST))
    ours = port.verify_r1cs_succinct(port.deserialize_any(blob), [1], pr,
                                     min_params=FriParams(*FAST))
    assert ours is theirs is (how == "valid")


@pytest.mark.parametrize("m", [16, 64])
def test_succinct_view_equals_jax(proved, m):
    jr, pr, _ws, theirs, mine = proved[m]
    view = port.succinct_view(mine[2], pr)
    assert dataclasses.astuple(view) == dataclasses.astuple(jax_view(theirs[2], jr))
    assert len(view.positions) == len(view.leaves) == FAST[1]


@pytest.mark.parametrize("sim_seed", [0, 3, 12345])
def test_simulated_view_equals_jax(sim_seed):
    jr, pr, _ws = _instance(64)
    mine = port.simulate_succinct_view(pr, sim_seed, FriParams(*FAST))
    theirs = jax_simulate(jr, sim_seed, JaxFriParams(*FAST))
    assert dataclasses.astuple(mine) == dataclasses.astuple(theirs)
    q, x = GL, mine.alpha
    a, b, c, qv = mine.evals[:4]
    assert qv * (pow(x, pr.m, q) - 1) % q == (a * b - c) % q


def test_zk_needs_one_blinding_seed_per_witness(ctxs):
    _jax_ctx, ours = ctxs
    _jr, pr, ws = _instance(16)
    for blinds in (None, [1, 2]):
        with pytest.raises(InvalidDimensionsError, match="blinding seed"):
            port.prove_r1cs_succinct_batch(pr, ws, ours, SEEDS, zk=True, blinding_seeds=blinds,
                                           device="cpu")


def test_zk_ring_degree_below_m_names_its_queue_item():
    """ZK at ring degree n < m commits to the unmasked, trimmed Q on the
    host, as the JAX package does: a random witness's quotient is too long,
    and both raise the same CommitmentError."""
    jax_ctx, small = _ctxs(n=8)
    jr, pr, ws = _instance(16)
    with pytest.raises(Exception) as theirs:
        jax_prove_one(jr, ws[0], jax_ctx, 1, True, JaxFriParams(*FAST), blinding_seed=2)
    assert type(theirs.value).__name__ == "CommitmentError"
    with pytest.raises(port.CommitmentError) as mine:
        port.prove_r1cs_succinct(pr, ws[0], small, 1, True, FriParams(*FAST), blinding_seed=2,
                                 device="cpu")
    assert str(mine.value) == str(theirs.value)


def test_pipeline_chunk_ignored_under_zk(proved):
    """ZK batches take the unchunked route, as in JAX: the same bytes."""
    _jr, pr, ws, _theirs, mine = proved[16]
    _jax_ctx, ours = _ctxs()
    again = port.prove_r1cs_succinct_batch(pr, ws, ours, SEEDS, zk=True,
                                           fri_params=FriParams(*FAST), blinding_seeds=BLINDS,
                                           pipeline_chunk=1, device="cpu")
    assert [p.to_bytes() for p in again] == [p.to_bytes() for p in mine]
