"""The port's quotient (kernel Q's plain twin) against the JAX package: the
XLA route of ``pipeline.quotient_batch`` (B < 64) and the two TPU kernels as
the CPU runs them, ``quotient_batch_fused`` (interpret mode, the Goldilocks
route) and ``quotient_batch_mxu`` (the 44-bit route); then kernel Q's
tables and a Python-int model of its cluster stage order and lazy
arithmetic (``torch_cluster_model``) against the plain twin."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cluster_model as model

from lambda_snark_tpu import Params, Profile, SecurityLevel
from lambda_snark_tpu.commit.lwe import LweContext
from lambda_snark_tpu.commit.lwe_jax import DeviceCommitContext
from lambda_snark_tpu.core.params import NTT_FRIENDLY_MODULUS, NTT_MODULUS
from lambda_snark_tpu.ops.limb import u64_to_limbs
from lambda_snark_tpu.ops.ntt_mxu_q45 import q45_quotient_plan, quotient_batch_mxu
from lambda_snark_tpu.ops.quotient_pallas import QuotientPlan as JaxQuotientPlan
from lambda_snark_tpu.ops.quotient_pallas import quotient_batch_fused
from lambda_snark_tpu.pipeline import ProvePlan as JaxProvePlan
from lambda_snark_tpu.pipeline import quotient_batch as jax_quotient_batch

from lambda_snark_tpu_torch.convert import words_to_planes
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.ops.quotient import QuotientPlan, quotient, quotient_plain
from lambda_snark_tpu_torch.pipeline import field_psi_for

M = 16
MODULI = {"q45": NTT_FRIENDLY_MODULUS, "goldilocks": NTT_MODULUS}
DIGITS = {NTT_FRIENDLY_MODULUS: 3, NTT_MODULUS: 4}


def _inputs(q, batch, seed, bad_row=None, m=M):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, q, size=(batch, m), dtype=np.uint64)
    b = rng.integers(0, q, size=(batch, m), dtype=np.uint64)
    a[0, :3] = [0, 1, q - 1]
    c = modarith.to_u64(modarith.mul_mod(modarith.to_words(a), modarith.to_words(b), q))
    if bad_row is not None:
        c[bad_row, 2] = (c[bad_row, 2] + np.uint64(1)) % np.uint64(q)
    planes = [jnp.asarray(u64_to_limbs(x, DIGITS[q])) for x in (a, b, c)]
    return [modarith.to_words(x) for x in (a, b, c)], planes


def _port(q, words):
    m = words[0].shape[1]
    return quotient(QuotientPlan.create(m, q, field_psi_for(m, q)), *words)


def _assert_same(ours, theirs, d):
    for name, o, t in zip(("Q", "A", "B", "C"), ours[:4], theirs[:4]):
        assert np.array_equal(words_to_planes(o, d), np.asarray(t)), name
    assert np.array_equal(ours[4].numpy(), np.asarray(theirs[4]))


@pytest.fixture(scope="module")
def jax_plans():
    out = {}
    for name, q in MODULI.items():
        host = LweContext(Params(SecurityLevel.BITS128,
                                 Profile.ring_b(n=M, k=2, q=q, sigma=3.19)), context_seed=1)
        out[q] = JaxProvePlan.create(M, q, DeviceCommitContext.from_host(host))
    return out


@pytest.mark.parametrize("name", sorted(MODULI))
def test_quotient_matches_xla_route(name, jax_plans):
    q = MODULI[name]
    words, planes = _inputs(q, batch=4, seed=1, bad_row=2)
    theirs = jax_quotient_batch(jax_plans[q], *planes)
    ours = _port(q, words)
    assert not bool(ours[4][2]) and bool(ours[4][0])
    _assert_same(ours, theirs, DIGITS[q])


def test_quotient_matches_fused_pallas_goldilocks():
    q = NTT_MODULUS
    words, planes = _inputs(q, batch=8, seed=2, bad_row=5)
    theirs = quotient_batch_fused(JaxQuotientPlan.create(M, q, field_psi_for(M, q)), *planes)
    _assert_same(_port(q, words), theirs, DIGITS[q])


def test_quotient_matches_mxu_q45():
    q = NTT_FRIENDLY_MODULUS
    m = 64  # the four-step leaves need whole rows of the 128-lane tile
    words, planes = _inputs(q, batch=2, seed=3, bad_row=1, m=m)
    theirs = quotient_batch_mxu(q45_quotient_plan(m, field_psi_for(m, q)), *planes)
    _assert_same(_port(q, words), theirs, DIGITS[q])


@pytest.mark.parametrize("name", sorted(MODULI))
def test_quotient_identity(name):
    """A B - C = Q (X^m - 1) as polynomials, checked on Python ints."""
    q = MODULI[name]
    words, _ = _inputs(q, batch=2, seed=4)
    qc, ac, bc, cc, valid = (modarith.to_u64(t).tolist() if t.dtype != torch.bool else t
                            for t in _port(q, words))
    assert bool(valid.all())
    for i in range(2):
        lhs = [0] * (2 * M)
        for x, av in enumerate(ac[i]):
            for y, bv in enumerate(bc[i]):
                lhs[x + y] += av * bv
        for x, cv in enumerate(cc[i]):
            lhs[x] -= cv
        rhs = [0] * (2 * M)
        for x, qv in enumerate(qc[i]):
            rhs[x + M] += qv
            rhs[x] -= qv
        assert [v % q for v in lhs] == [v % q for v in rhs]


def _ints(t):
    return [int(v) for v in modarith.to_u64(t)]


@pytest.mark.parametrize("name", sorted(MODULI))
def test_plan_tables_match_definitions(name):
    """The tables kernel Q reads: the twiddles of omega and omega^-1 in
    stage-major order (stage s's twiddle at j at 2^s + j), the twist
    psi^k / m at the DIF position that holds coefficient k (twist_rev), the
    untwist psi^-k / (m (-2)) in natural order, and, for the 44-bit field,
    every table's Shoup companion floor(w 2^64 / q), against their
    Python-int definitions."""
    q, m = MODULI[name], 64
    psi = field_psi_for(m, q)
    plan = QuotientPlan.create(m, q, psi)
    inv_m, psi_inv = pow(m, q - 2, q), pow(psi, q - 2, q)
    neg_half_inv = pow(q - 2, q - 2, q)
    twist_rev = [pow(psi, model.rev(i, 6), q) * inv_m % q for i in range(m)]
    untwist = [pow(psi_inv, k, q) * inv_m * neg_half_inv % q for k in range(m)]
    omega = psi * psi % q
    stage = lambda w: [1] + [pow(w, j * (m >> (s + 1)), q) for s in range(6) for j in range(1 << s)]
    assert _ints(plan.tw_stage) == stage(omega)
    assert _ints(plan.tw_inv_stage) == stage(pow(omega, q - 2, q))
    assert _ints(plan.twist_rev) == twist_rev
    assert _ints(plan.untwist) == untwist
    if q == NTT_MODULUS:
        assert plan.shoup is None
        return
    shoup = lambda vals: [(w << 64) // q for w in vals]
    assert _ints(plan.shoup.tw_stage) == shoup(stage(omega))
    assert _ints(plan.shoup.tw_inv_stage) == shoup(stage(pow(omega, q - 2, q)))
    assert _ints(plan.shoup.twist_rev) == shoup(twist_rev)
    assert _ints(plan.shoup.untwist) == shoup(untwist)
    assert plan.shoup.inv_m == (inv_m << 64) // q


@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("log_m", [6, 7, 8, 9])
@pytest.mark.parametrize("name", sorted(MODULI))
def test_cluster_model_matches_plain(name, log_m, cluster):
    """Kernel Q's stage order over a cluster of C blocks (the cross-block
    radix-C exchanges, the local stages, the natural-order gathers) and its
    arithmetic (the 44-bit field's lazy Shoup words in [0, 2q) / [0, 4q),
    asserted at every step) as Python ints, on the plan's tables, equal
    ``quotient_plain``, which the tests above hold against the JAX package."""
    q, m = MODULI[name], 1 << log_m
    plan = QuotientPlan.create(m, q, field_psi_for(m, q))
    words, _ = _inputs(q, batch=2, seed=log_m + cluster, bad_row=1, m=m)
    sh = plan.shoup
    comp = lambda attr: None if sh is None else _ints(getattr(sh, attr))
    tables = (_ints(plan.tw_inv_stage), comp("tw_inv_stage"), _ints(plan.tw_stage),
              comp("tw_stage"),
              _ints(plan.twist_rev), comp("twist_rev"), _ints(plan.untwist), comp("untwist"),
              plan.ntt.inv_m, 0 if sh is None else sh.inv_m)
    fld = model.Shoup(q) if q == NTT_FRIENDLY_MODULUS else model.Canonical(q)
    want = quotient_plain(plan, *words)
    for i in range(2):
        got = model.quotient_row(fld, tables, *(_ints(w[i]) for w in words), cluster)
        assert [list(g) for g in got[:4]] == [_ints(w[i]) for w in want[:4]]
        assert got[4] == bool(want[4][i]) == (i != 1)
