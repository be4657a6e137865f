"""Kernel T's plain twin and the generalised four-step against the JAX
package, on the CPU, exactly:

- ``ntt_forward_batched`` / ``ntt_inverse_batched`` against the TPU kernel
  ``ntt_forward_pallas`` / ``ntt_inverse_pallas`` (interpret mode here, as
  ``tests/test_ntt_pallas.py`` runs it) on the same numpy-seeded inputs, as
  (B, S) words on one side and (D, B, S) digit planes on the other;
- the four-step (``ops.ntt_large``), forward and inverse, against
  ``ops.ntt`` for Goldilocks at 2^14 and 2^21 points and for the Barrett
  field 2013265921 at 2^14, and against the JAX ``ops/ntt_large.py``.

The long routes built on the four-step are ``tests/test_torch_long_routes.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambda_snark_tpu.ops import ntt_pallas
from lambda_snark_tpu.ops.limb import u64_to_limbs
from lambda_snark_tpu.ops.ntt_large import four_step_plan
from lambda_snark_tpu.ops.ntt_large import ntt_forward_large as jax_forward_large
from lambda_snark_tpu.ops.ntt_large import ntt_inverse_large as jax_inverse_large

from lambda_snark_tpu_torch.convert import planes_to_words, words_to_planes
from lambda_snark_tpu_torch.core.params import (
    HEALTHCARE_DUMP_MODULUS,
    NTT_FRIENDLY_MODULUS,
    NTT_MODULUS,
)
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.ops.ntt import NttPlan, ntt_forward, ntt_inverse
from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
from lambda_snark_tpu_torch.ops.ntt_large import (
    NttLargePlan,
    ntt_forward_large,
    ntt_inverse_large,
)
from lambda_snark_tpu_torch.proof.fri import root_of_order

GL = NTT_MODULUS
Q45 = NTT_FRIENDLY_MODULUS


def _words(q, shape, seed):
    return modarith.to_words(np.random.default_rng(seed).integers(0, q, size=shape,
                                                                   dtype=np.uint64))


@pytest.mark.parametrize("q,s_len", [(Q45, 8), (Q45, 256), (GL, 128)])
@pytest.mark.parametrize("inverse", [False, True])
def test_twin_matches_ntt_pallas(q, s_len, inverse):
    omega = root_of_order(q, s_len)
    pp = ntt_pallas.pallas_ntt_plan(s_len, q, omega)
    x = _words(q, (4, s_len), seed=s_len)
    planes = jnp.asarray(words_to_planes(x, pp.plan.ctx.d))
    jax_fn = ntt_pallas.ntt_inverse_pallas if inverse else ntt_pallas.ntt_forward_pallas
    want = planes_to_words(np.asarray(jax_fn(pp, planes)))
    plan = NttPlan.create(s_len, q, omega)
    got = (ntt_inverse_batched if inverse else ntt_forward_batched)(plan, x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("q", [Q45, GL, HEALTHCARE_DUMP_MODULUS])
def test_round_trip(q):
    plan = NttPlan.create(64, q, root_of_order(q, 64))
    x = _words(q, (3, 64), seed=5)
    assert torch.equal(ntt_inverse_batched(plan, ntt_forward_batched(plan, x)), x)


@pytest.mark.parametrize("bad", ["modulus", "width", "dtype"])
def test_batched_rejects(bad):
    plan = NttPlan.create(8, Q45, root_of_order(Q45, 8))
    x = torch.zeros((2, 8), dtype=torch.int64)
    if bad == "modulus":  # a Mersenne prime past 2^47: no reduction for it
        plan = NttPlan.create(8, (1 << 61) - 1, 2)
    elif bad == "width":
        x = torch.zeros((2, 16), dtype=torch.int64)
    else:
        x = x.to(torch.int32)
    with pytest.raises(ValueError):
        ntt_forward_batched(plan, x)


@pytest.mark.parametrize("q,log_m,rows", [(GL, 14, 3), (GL, 21, 1),
                                          (HEALTHCARE_DUMP_MODULUS, 14, 2)])
def test_four_step_matches_ops_ntt(q, log_m, rows):
    m = 1 << log_m
    omega = root_of_order(q, m)
    plan, large = NttPlan.create(m, q, omega), NttLargePlan.create(m, omega, q=q)
    x = _words(q, (rows, m), seed=log_m)
    fwd = ntt_forward_large(large, x)
    assert torch.equal(fwd, ntt_forward(plan, x))
    assert torch.equal(ntt_inverse_large(large, x), ntt_inverse(plan, x))
    assert torch.equal(ntt_inverse_large(large, fwd), x)


@pytest.mark.parametrize("inverse", [False, True])
def test_four_step_matches_jax_ntt_large(inverse):
    m = 1 << 14
    omega = root_of_order(GL, m)
    x = _words(GL, (2, m), seed=14)
    jax_fn = jax_inverse_large if inverse else jax_forward_large
    want = planes_to_words(np.asarray(jax_fn(four_step_plan(m, GL, omega),
                                             jnp.asarray(u64_to_limbs(modarith.to_u64(x), 4)))))
    ours = ntt_inverse_large if inverse else ntt_forward_large
    assert torch.equal(ours(NttLargePlan.create(m, omega), x), want)


# the leaf cap forced small: (log2 of the leaf, log2 m) give three passes
# (2, 5: 2 x 4 x 4) and four (2, 7: 2 x 4 x 4 x 4) at sizes the CPU runs
@pytest.mark.parametrize("q", [GL, Q45, HEALTHCARE_DUMP_MODULUS])
@pytest.mark.parametrize("leaf,log_m,n_passes", [(2, 5, 3), (2, 7, 4)])
def test_deep_four_step_matches_ops_ntt_and_jax(monkeypatch, q, leaf, log_m, n_passes):
    """Past two leaves the C-point row transforms are a four-step of their
    own: with the leaf cap forced small the plan takes three and four
    passes, and forward and inverse, with ``pre`` / ``post`` / ``scale``,
    equal ``ops.ntt`` and the JAX package's four-step, exactly."""
    from lambda_snark_tpu_torch.ops import ntt_large

    monkeypatch.setattr(ntt_large, "_MAX_LOG_LEAF", leaf)
    m = 1 << log_m
    omega = root_of_order(q, m)
    large, plan = NttLargePlan.create(m, omega, q=q), NttPlan.create(m, q, omega)
    assert large.n_passes == n_passes == len(ntt_large.passes(large, False))
    x, pre, post = _words(q, (3, m), 1), _words(q, (m,), 2), _words(q, (m,), 3)
    fsp = four_step_plan(m, q, omega)
    planes = jnp.asarray(words_to_planes(x, fsp.plan_r.ctx.d))
    fwd = ntt_forward_large(large, x)
    assert torch.equal(fwd, ntt_forward(plan, x))
    assert torch.equal(fwd, planes_to_words(np.asarray(jax_forward_large(fsp, planes))))
    inv = ntt_inverse_large(large, x)
    assert torch.equal(inv, ntt_inverse(plan, x))
    assert torch.equal(inv, planes_to_words(np.asarray(jax_inverse_large(fsp, planes))))
    mul = lambda a, b: modarith.mul_mod(a, b, q)
    assert torch.equal(ntt_forward_large(large, x, pre=pre, post=post),
                       mul(ntt_forward(plan, mul(x, pre)), post))
    assert torch.equal(ntt_inverse_large(large, x, pre=pre, post=post, scale=7),
                       mul(mul(ntt_inverse(plan, mul(x, pre)), post), 7 * m % q))
