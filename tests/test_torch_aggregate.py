"""The port's kind-8 aggregated proofs against the JAX package, on the CPU.

``prove_r1cs_succinct_aggregate(device="cpu")`` (every kernel as its plain
twin) must give the bytes of the JAX ``prove_r1cs_succinct_aggregate``
(its host route, ``device_lde=False``), plain and zero-knowledge, at the
JAX tests' shape: ``mult_circuit(16, GL)``, 4 witnesses, seeds 1-4, ring
n = 64, k = 1, ``FriParams(log_blowup=3, num_queries=8)``; and S = 1. Both
verifiers must accept each other's proofs and reject the JAX tests'
tampered ones (``tests/test_aggregate.py``). The device pieces the
aggregate adds (``deep_combine_device(lam_tables=...)``,
``sum_statements_device``, ``fri_open`` over one group in S trees) are held against
the JAX host DEEP loop and ``fri_prove``.

The JAX package is imported inside fixtures, so the ``cuda`` test at the
end runs on a card machine without JAX:
``python -m pytest tests/test_torch_aggregate.py -m cuda --noconftest -q``.
"""

import dataclasses
import importlib
import types

import numpy as np
import pytest
import torch

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.core.errors import (
    DomainError,
    InvalidDimensionsError,
    SerializationError,
)
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.proof import fri_device
from lambda_snark_tpu_torch.proof.aggregate import AggregatedProofR1CS, StatementOpening
from lambda_snark_tpu_torch.proof.fri import (
    MAX_AGGREGATE_STATEMENTS,
    FriParams,
    FriTranscript,
    coset_offset,
    root_of_order,
)

GL = port.NTT_MODULUS
Q45 = port.NTT_FRIENDLY_MODULUS
FAST = FriParams(log_blowup=3, num_queries=8)
SEEDS, BLINDS = [1, 2, 3, 4], [5, 6, 7, 8]


def _port_ctx(q=GL, n=64):
    return port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=n, k=1, q=q, sigma=3.19)))


@pytest.fixture(scope="module")
def jx():
    """The JAX package's pieces, imported here (not on a card machine)."""
    J = importlib.import_module("lambda_snark_tpu")
    agg = importlib.import_module("lambda_snark_tpu.proof.aggregate")
    jfri = importlib.import_module("lambda_snark_tpu.proof.fri")
    ts = importlib.import_module("test_succinct")
    ctx = J.setup(J.Params(J.SecurityLevel.BITS128, J.Profile.ring_b(64, 1, GL, 3.19)))
    return types.SimpleNamespace(J=J, agg=agg, fri=jfri, ts=ts, ctx=ctx,
                                 FAST=jfri.FriParams(log_blowup=3, num_queries=8))


@pytest.fixture(scope="module")
def proved(jx):
    """zk -> (JAX circuit, port circuit, witnesses, JAX proof, port proof)."""
    ours = _port_ctx()
    jr, pr = jx.ts.mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    ws = [jx.ts.mult_witness(16, GL, seed=50 + i) for i in range(4)]
    out = {}
    for zk in (False, True):
        blinds = BLINDS if zk else None
        theirs = jx.agg.prove_r1cs_succinct_aggregate(jr, ws, jx.ctx, SEEDS, zk=zk,
                                                      fri_params=jx.FAST,
                                                      blinding_seeds=blinds,
                                                      device_lde=False)
        mine = port.prove_r1cs_succinct_aggregate(pr, ws, ours, SEEDS, zk=zk, fri_params=FAST,
                                                  blinding_seeds=blinds, device="cpu")
        out[zk] = (jr, pr, ws, theirs, mine)
    return out


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_aggregate_bytes_equal_jax(proved, zk):
    _jr, _pr, _ws, theirs, mine = proved[zk]
    assert mine.to_bytes() == theirs.to_bytes()
    assert mine.mask_len == (2 * FAST.num_queries + 8 if zk else 0)
    assert len(mine.statements) == 4 and len(mine.fri.queries[0].input_openings) == 4


def test_aggregate_single_statement_bytes_equal_jax(jx):
    jr, pr = jx.ts.mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    w = jx.ts.mult_witness(16, GL, seed=80)
    theirs = jx.agg.prove_r1cs_succinct_aggregate(jr, [w], jx.ctx, [9], fri_params=jx.FAST,
                                                  device_lde=False)
    mine = port.prove_r1cs_succinct_aggregate(pr, [w], _port_ctx(), [9], fri_params=FAST,
                                              device="cpu")
    assert mine.to_bytes() == theirs.to_bytes()
    assert port.verify_r1cs_succinct_aggregate(mine, [[1]], pr, min_params=FAST)


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_aggregate_from_bytes_round_trip(jx, proved, zk):
    _jr, pr, ws, theirs, mine = proved[zk]
    blob = mine.to_bytes()
    back = port.deserialize_any(blob)
    assert isinstance(back, AggregatedProofR1CS) and back.to_bytes() == blob
    assert AggregatedProofR1CS.from_bytes(theirs.to_bytes()).to_bytes() == blob
    assert jx.J.deserialize_any(blob).to_bytes() == blob
    assert port.verify_r1cs_succinct_aggregate(back, [[1]] * len(ws), pr, min_params=FAST)
    with pytest.raises(SerializationError):
        AggregatedProofR1CS.from_bytes(blob[: len(blob) // 2])


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_aggregate_cross_verification(jx, proved, zk):
    """The port verifies the JAX package's proof, and JAX verifies the port's."""
    jr, pr, ws, theirs, mine = proved[zk]
    publics = [[1]] * len(ws)
    assert port.verify_r1cs_succinct_aggregate(AggregatedProofR1CS.from_bytes(theirs.to_bytes()),
                                               publics, pr, min_params=FAST)
    jax_mine = jx.agg.AggregatedProofR1CS.from_bytes(mine.to_bytes())
    assert jx.agg.verify_r1cs_succinct_aggregate(jax_mine, publics, jr, min_params=jx.FAST)


def _tampered(proof, case: str):
    """(tampered proof, public inputs) for one of the tamper cases."""
    publics = [[1]] * len(proof.statements)
    st = proof.statements[2]
    sts = lambda bad: proof.statements[:2] + (bad,) + proof.statements[3:]
    q0 = proof.fri.queries[0]
    if case == "evaluation":
        bad = dataclasses.replace(st, evals=tuple((v + (i == 3)) % GL
                                                  for i, v in enumerate(st.evals)))
        return dataclasses.replace(proof, statements=sts(bad)), publics
    if case == "root":
        return dataclasses.replace(proof, statements=sts(
            dataclasses.replace(st, input_root=bytes(32)))), publics
    if case == "public_inputs":
        return proof, [[1], [1], [2], [1]]
    if case == "statement_count":
        return proof, [[1]] * 3
    if case == "fri_path":
        op = q0.input_openings[1]
        bad_op = dataclasses.replace(op, path=bytes([op.path[0] ^ 1]) + op.path[1:])
        bad_q = dataclasses.replace(q0, input_openings=(q0.input_openings[0], bad_op)
                                    + q0.input_openings[2:])
        return dataclasses.replace(proof, fri=dataclasses.replace(
            proof.fri, queries=(bad_q,) + proof.fri.queries[1:])), publics
    if case == "leaf_value":
        op = q0.input_openings[3]
        vals = list(op.values)
        vals[6] = (vals[6] + 1) % GL
        bad_q = dataclasses.replace(q0, input_openings=q0.input_openings[:3] + (
            dataclasses.replace(op, values=tuple(vals)),))
        return dataclasses.replace(proof, fri=dataclasses.replace(
            proof.fri, queries=(bad_q,) + proof.fri.queries[1:])), publics
    final = list(proof.fri.final_coeffs)  # "final"
    final[0] = (final[0] + 1) % GL
    return dataclasses.replace(proof, fri=dataclasses.replace(
        proof.fri, final_coeffs=tuple(final))), publics


TAMPER = ["evaluation", "root", "public_inputs", "statement_count", "fri_path", "leaf_value",
          "final"]


@pytest.mark.parametrize("case", TAMPER)
def test_aggregate_tamper_rejected(jx, proved, case):
    """Each tamper case is rejected by both verifiers, on the port's proof."""
    jr, pr, _ws, _theirs, mine = proved[False]
    assert port.verify_r1cs_succinct_aggregate(mine, [[1]] * 4, pr, min_params=FAST)
    bad, publics = _tampered(mine, case)
    assert not port.verify_r1cs_succinct_aggregate(bad, publics, pr, min_params=FAST)
    jax_bad = jx.agg.AggregatedProofR1CS.from_bytes(bad.to_bytes())
    assert not jx.agg.verify_r1cs_succinct_aggregate(jax_bad, publics, jr, min_params=jx.FAST)


def test_aggregate_param_floor(jx, proved):
    jr, pr, ws, theirs, mine = proved[False]
    strong = FriParams(log_blowup=3, num_queries=mine.num_queries + 1)
    assert not port.verify_r1cs_succinct_aggregate(mine, [[1]] * 4, pr, min_params=strong)
    assert not jx.agg.verify_r1cs_succinct_aggregate(
        theirs, [[1]] * 4, jr, min_params=jx.fri.FriParams(3, mine.num_queries + 1))
    # the default floor (30 queries) refuses the 8-query test proofs in both
    assert not port.verify_r1cs_succinct_aggregate(mine, [[1]] * 4, pr)
    assert not jx.agg.verify_r1cs_succinct_aggregate(theirs, [[1]] * 4, jr)


VALIDATION = ["empty", "too_many", "seed_count", "zk_blinds", "field"]


@pytest.mark.parametrize("case", VALIDATION)
def test_aggregate_input_validation(jx, case):
    """The same error type and message as the JAX package for each refused
    input (checked before any work)."""
    jr, pr = jx.ts.mult_circuit(16, GL), port.multiplication_gates_circuit(16, GL)
    w = jx.ts.mult_witness(16, GL, seed=70)
    jctx, ours, kw = jx.ctx, _port_ctx(), {}
    ws, seeds = [w], [1]
    if case == "empty":
        ws, seeds = [], []
    elif case == "too_many":
        ws = seeds = [w] * (MAX_AGGREGATE_STATEMENTS + 1)
    elif case == "seed_count":
        seeds = [1, 2]
    elif case == "zk_blinds":
        kw = dict(zk=True, blinding_seeds=[1, 2])
    else:
        jr, pr = jx.ts.mult_circuit(8, Q45), port.multiplication_gates_circuit(8, Q45)
        ws = [jx.ts.mult_witness(8, Q45)]
        jctx = jx.J.setup(jx.J.Params(jx.J.SecurityLevel.BITS128,
                                      jx.J.Profile.ring_b(64, 1, Q45, 3.19)))
        ours = _port_ctx(Q45)
    with pytest.raises(Exception) as theirs:
        jx.agg.prove_r1cs_succinct_aggregate(jr, ws, jctx, seeds, fri_params=jx.FAST, **kw)
    want = DomainError if case == "field" else InvalidDimensionsError
    assert type(theirs.value).__name__ == want.__name__
    with pytest.raises(want) as mine:
        port.prove_r1cs_succinct_aggregate(pr, ws, ours, seeds, fri_params=FAST,
                                           device="cpu", **kw)
    assert str(mine.value) == str(theirs.value)


# --- the device pieces, held against the JAX host route -----------------------------


def _codewords(s: int, n0: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, GL, size=(s, 4, n0), dtype=np.uint64)


def test_deep_combine_lam_tables_and_sum_equal_jax_host_loop(jx):
    """deep_combine_device with one lambda ladder across the statements,
    then sum_statements_device, gives the JAX aggregate's host g."""
    glnp = importlib.import_module("lambda_snark_tpu.ops.goldilocks_np")
    sb = importlib.import_module("lambda_snark_tpu.proof.succinct_batch")
    s, n0 = 5, 64
    cw = _codewords(s, n0, 1)
    rng = np.random.default_rng(2)
    alphas, betas = (rng.integers(0, GL, size=s, dtype=np.uint64) for _ in range(2))
    evals = rng.integers(0, GL, size=(s, 8), dtype=np.uint64)
    lam = int(rng.integers(0, GL, dtype=np.uint64))
    offset, omega = coset_offset(GL), root_of_order(GL, n0)
    # the JAX aggregate's host loop (proof/aggregate.py, the route without a forest)
    xs = glnp.gl_mul(np.uint64(offset), sb._gl_powers(omega, n0))
    inv_a = sb._gl_inverse_batch(glnp.gl_sub(xs[None, :], alphas[:, None]))
    inv_b = sb._gl_inverse_batch(glnp.gl_sub(xs[None, :], betas[:, None]))
    want = np.zeros(n0, dtype=np.uint64)
    lam_pow = 1
    for i in range(s):
        for k in range(4):
            lam2 = lam_pow * lam % GL
            term_a = glnp.gl_mul(glnp.gl_mul(np.uint64(lam_pow),
                                             glnp.gl_sub(cw[i, k], evals[i, k])), inv_a[i])
            term_b = glnp.gl_mul(glnp.gl_mul(np.uint64(lam2),
                                             glnp.gl_sub(cw[i, k], evals[i, 4 + k])), inv_b[i])
            want = glnp.gl_add(want, glnp.gl_add(term_a, term_b))
            lam_pow = lam2 * lam % GL
    g = fri_device.deep_combine_device(modarith.to_words(cw), alphas, betas, None, evals,
                                       offset, omega,
                                       lam_tables=fri_device.lambda_ladder(lam, s, 4))
    assert g.shape == (s, n0)
    got = fri_device.sum_statements_device(g)
    assert got.shape == (1, n0)
    assert np.array_equal(modarith.to_u64(got)[0], want)


@pytest.mark.parametrize("s", [1, 2, 3, 8])
def test_sum_statements_equals_sequential_sum(s):
    rows = np.random.default_rng(s).integers(0, GL, size=(s, 32), dtype=np.uint64)
    want = [sum(int(v) for v in col) % GL for col in rows.T]
    got = modarith.to_u64(fri_device.sum_statements_device(modarith.to_words(rows)))
    assert got.shape == (1, 32) and [int(v) for v in got[0]] == want


@pytest.mark.parametrize("s", [1, 3])
def test_fri_open_n_groups_equals_jax_fri_prove(jx, s):
    """One FRI statement over S group trees (fri_prove_device with one
    input group of 4 S oracles in S trees) gives the JAX host fri_prove's
    bytes on the same inputs."""
    n0 = 128
    cw = _codewords(s, n0, 3 + s)
    offset, omega = coset_offset(GL), root_of_order(GL, n0)
    # a low-degree g: the sum of the statements' first rows' low-degree parts
    coeffs = np.random.default_rng(9).integers(0, GL, size=n0 // 8, dtype=np.uint64)
    g = np.asarray(jx.fri.lde(coeffs, n0, offset, omega, GL), dtype=np.uint64)
    jax_inputs = [([cw[i, k] for k in range(4)], jx.fri.commit_codeword_group(list(cw[i])))
                  for i in range(s)]
    jtr = jx.fri.FriTranscript()
    jtr.absorb(b"seed", b"aggregate")
    theirs = jx.fri.fri_prove(g, jax_inputs, offset, omega, GL, jx.FAST, jtr)
    tr = FriTranscript()
    tr.absorb(b"seed", b"aggregate")
    vals = modarith.to_words(cw)
    forest = fri_device.commit_planes_dev_groups(vals)
    mine = fri_device.fri_prove_device(modarith.to_words(g)[None],
                                       [(vals.reshape(1, 4 * s, n0), forest)], offset, omega,
                                       GL, FAST, [tr])[0]
    assert mine.to_bytes() == theirs.to_bytes()
    assert all(len(qy.input_openings) == s for qy in mine.queries)


def test_fri_prove_device_refuses_a_forest_of_the_wrong_size():
    """8 oracles over a forest of 3 trees, and a g of two rows over one
    FRI statement's codewords, are refused before any work."""
    n0 = 64
    vals = modarith.to_words(_codewords(2, n0, 4)).reshape(1, 8, n0)
    three = fri_device.commit_planes_dev_groups(modarith.to_words(_codewords(3, n0, 5)))
    two = fri_device.commit_planes_dev_groups(vals.reshape(2, 4, n0))
    for g, forest in ((torch.zeros((1, n0), dtype=torch.int64), three),
                      (torch.zeros((2, n0), dtype=torch.int64), two)):
        with pytest.raises(ValueError, match="disagree on shape"):
            fri_device.fri_prove_device(g, [(vals, forest)], coset_offset(GL),
                                        root_of_order(GL, n0), GL, FAST, [FriTranscript()])


def test_statement_opening_round_trip(proved):
    st = proved[True][4].statements[1]
    blob = st.to_bytes()
    back, off = StatementOpening.read(blob, 0)
    assert off == len(blob) and back == st and back.to_bytes() == blob
    with pytest.raises(SerializationError):
        StatementOpening.read(blob[:-1], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_aggregate_on_card_equals_cpu(zk):
    """Kind 8 on the card (kernels Q, R, T, K) gives the CPU path's bytes
    at S = 3, m = 256 (the least m of these FriParams with a committed FRI
    layer, so a paired-leaf forest too), and verifies."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lambda_snark_tpu_torch import kernels

    m, s = 256, 3
    r1cs = port.multiplication_gates_circuit(m, GL)
    ws = [port.multiplication_gates_witness(m, GL, seed=i) for i in range(s)]
    ctx = _port_ctx(n=m)
    kw = dict(zk=zk, fri_params=FAST, blinding_seeds=[7, 8, 9] if zk else None)
    cpu = port.prove_r1cs_succinct_aggregate(r1cs, ws, ctx, [1, 2, 3], device="cpu", **kw)
    kernels.reset_launches()
    card = port.prove_r1cs_succinct_aggregate(r1cs, ws, ctx, [1, 2, 3], device="cuda", **kw)
    launches = kernels.launches()
    assert card.to_bytes() == cpu.to_bytes()
    assert min(launches[e] for e in ("quotient_goldilocks", "ring_commit_goldilocks",
                                     "keccak_group_forest", "keccak_forest")) >= 1
    assert launches["ntt_four_step"] + launches["ntt_rows"] >= 1
    assert port.verify_r1cs_succinct_aggregate(card, [r1cs.public_inputs(w) for w in ws], r1cs,
                                               min_params=FAST)
