"""Kernel N's plain twin (``lambda_snark_tpu_torch.ops.ntt_large``) against
the JAX package: the TPU kernels ``ntt_forward_mxu_packed`` (ops/ntt_mxu.py)
and its leaf ``dft_matmul_apply_pallas`` (kernel T's row entry,
``ntt_forward_batched``) as the CPU runs them, at the sizes of
``tests/test_ntt_mxu.py``, and the four-step ``ntt_forward_large``.
Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambda_snark_tpu.core.params import NTT_MODULUS
from lambda_snark_tpu.ops import ntt_mxu
from lambda_snark_tpu.ops.limb import u64_to_limbs
from lambda_snark_tpu.ops.ntt_large import four_step_plan, ntt_forward_large as jax_large
from lambda_snark_tpu.ops.ntt_large import ntt_inverse_large as jax_inverse_large
from lambda_snark_tpu.proof import fri as jax_fri

from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.ops.ntt import NttPlan
from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
from lambda_snark_tpu_torch.ops.ntt_large import NttLargePlan, ntt_forward_large
from lambda_snark_tpu_torch.proof import fri

P = NTT_MODULUS


def _vals(shape, seed):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def _from_planes(planes) -> np.ndarray:
    planes = np.asarray(planes).astype(np.uint64)
    return sum(planes[i] << np.uint64(16 * i) for i in range(planes.shape[0]))


@pytest.mark.parametrize("m", [256, 1024])
def test_four_step_matches_ntt_forward_mxu_packed(m):
    plan = ntt_mxu.mxu_ntt_plan(m)
    x = _vals((2, m), seed=m)
    x2 = ntt_mxu.pack_planes_jnp(jnp.asarray(u64_to_limbs(x, 4)))
    want = _from_planes(ntt_mxu.unpack_planes_jnp(ntt_mxu.ntt_forward_mxu_packed(plan, x2)))
    got = ntt_forward_large(NttLargePlan.create(m, plan.omega), modarith.to_words(x))
    assert np.array_equal(modarith.to_u64(got), want)


@pytest.mark.parametrize("b", [64, 128])
def test_leaf_matches_dft_matmul_apply_pallas(b):
    plan = ntt_mxu.DftMatmulPlan.create(b, ntt_mxu.mxu_ntt_plan(b).omega)
    rows = 256 // (128 // b)
    x = _vals((rows, b), seed=1000 + b)
    want = _from_planes(ntt_mxu.dft_matmul_apply_pallas(plan, jnp.asarray(u64_to_limbs(x, 4))))
    got = ntt_forward_batched(NttPlan.create(b, P, plan.omega), modarith.to_words(x))
    assert np.array_equal(modarith.to_u64(got), want)


def test_matches_ntt_forward_large_at_lde_root():
    m = 1 << 10
    omega = jax_fri.root_of_order(P, m)
    assert fri.root_of_order(P, m) == omega
    x = _vals((3, m), seed=7)
    want = _from_planes(jax_large(four_step_plan(m, P, omega), jnp.asarray(u64_to_limbs(x, 4))))
    got = ntt_forward_large(NttLargePlan.create(m, omega), modarith.to_words(x))
    assert np.array_equal(modarith.to_u64(got), want)


@pytest.mark.parametrize("m", [4, 8, 32])
def test_small_sizes_match_naive_dft(m):
    omega = fri.root_of_order(P, m)
    x = _vals((2, m), seed=m)
    got = modarith.to_u64(ntt_forward_large(NttLargePlan.create(m, omega), modarith.to_words(x)))
    for r in range(2):
        want = [sum(int(x[r, t]) * pow(omega, t * k, P) for t in range(m)) % P for k in range(m)]
        assert [int(v) for v in got[r]] == want


@pytest.mark.parametrize("bad", ["not_pow2", "too_large", "not_primitive", "width", "leaf"])
def test_plans_and_wrappers_reject(bad):
    if bad == "not_pow2":
        with pytest.raises(ValueError):
            NttLargePlan.create(48, 1)
    elif bad == "too_large":  # past the field's roots: Goldilocks has none of order 2^33
        with pytest.raises(ValueError):
            NttLargePlan.create(1 << 33, fri.root_of_order(P, 1 << 32))
    elif bad == "not_primitive":
        with pytest.raises(ValueError):
            NttLargePlan.create(16, fri.root_of_order(P, 8))
    elif bad == "width":
        plan = NttLargePlan.create(16, fri.root_of_order(P, 16))
        with pytest.raises(ValueError):
            ntt_forward_large(plan, torch.zeros((2, 8), dtype=torch.int64))
    else:  # the leaf (kernel T's row entry) takes rows of its plan's width only
        leaf = NttPlan.create(128, P, fri.root_of_order(P, 128))
        with pytest.raises(ValueError):
            ntt_forward_batched(leaf, torch.zeros((2, 64), dtype=torch.int64))


@pytest.mark.parametrize("inverse", [False, True])
def test_batched_past_one_tile_matches_jax_four_step(inverse):
    """Kernel T's wrappers past the 2^13-point leaf (the four-step on the
    card, ``ops.ntt`` here) equal the JAX package's four-step."""
    m = 1 << 14
    omega = fri.root_of_order(P, m)
    x = _vals((2, m), seed=15)
    jax_fn = jax_inverse_large if inverse else jax_large
    want = _from_planes(jax_fn(four_step_plan(m, P, omega), jnp.asarray(u64_to_limbs(x, 4))))
    ours = ntt_inverse_batched if inverse else ntt_forward_batched
    got = ours(NttPlan.create(m, P, omega), modarith.to_words(x))
    assert np.array_equal(modarith.to_u64(got), want)


@pytest.mark.parametrize("n,final_len", [(2, 1), (512, 64), (16384, 2048)])
def test_final_polynomial_inverts_the_codeword(n, final_len):
    """FRI's final polynomials through kernel N's twins (the leaf up to
    2^13 points, the four-step above): the coefficients of a codeword of
    degree < final_len on the coset off <om> come back, and a higher one is
    refused."""
    from lambda_snark_tpu_torch.core.errors import DomainError
    from lambda_snark_tpu_torch.ops.ntt import NttPlan, ntt_forward
    from lambda_snark_tpu_torch.proof.fri_device import _final_polynomial

    off, om = fri.coset_offset(P), fri.root_of_order(P, n)
    coeffs = np.zeros((2, n), dtype=np.uint64)
    coeffs[:, :final_len] = _vals((2, final_len), n)
    twisted = [[int(c) * pow(off, i, P) % P for i, c in enumerate(row)] for row in coeffs]
    cur = ntt_forward(NttPlan.create(n, P, om), modarith.to_words(twisted))
    assert _final_polynomial(cur, off, om, final_len) == [
        [int(c) for c in row[:final_len]] for row in coeffs]
    if final_len < n:
        high = ntt_forward(NttPlan.create(n, P, om),
                           modarith.to_words(np.eye(1, n, final_len, dtype=np.uint64)))
        with pytest.raises(DomainError):
            _final_polynomial(high, off, om, final_len)


@pytest.mark.parametrize("r,c", [(2, 4), (8, 8), (8, 16)])
def test_store_order_twiddle_table(r, c):
    """Pass 1's twiddles lie in its store's order, omega^(h b) at h C + b,
    and the plan keeps them for both directions."""
    from lambda_snark_tpu_torch.core import field
    from lambda_snark_tpu_torch.ops.ntt_large import store_order_table

    m = r * c
    omega = fri.root_of_order(P, m)
    table = modarith.to_u64(store_order_table(omega, r, c, P))
    assert [int(v) for v in table] == [pow(omega, h * b, P) for h in range(r) for b in range(c)]
    plan = NttLargePlan.create(m, omega)
    assert (plan.r, plan.c) == (r, c)
    assert torch.equal(plan.pw, store_order_table(omega, r, c, P))
    assert torch.equal(plan.pw_inv, store_order_table(field.mod_inverse(omega, P), r, c, P))


@pytest.mark.parametrize("q", [P, 2013265921])
def test_plan_past_2pow26(q):
    """A 2^27-point plan is three passes of 2^9-point leaves (made on the
    meta device here: tables of 2^27 words, no transform at that size)."""
    from lambda_snark_tpu_torch.ops.ntt_large import MAX_LEVELS, passes

    m = 1 << 27
    plan = NttLargePlan.create(m, fri.root_of_order(q, m), device="meta", q=q)
    assert (plan.r, plan.c, plan.n_passes) == (1 << 9, 1 << 18, 3)
    assert plan.sub.r == plan.sub.c == 1 << 9 and plan.sub.sub is None
    assert plan.pw.shape == (m,) and plan.pw_inv.shape == (m,) and plan.sub.pw.shape == (1 << 18,)
    steps = passes(plan, inverse=True, scale=plan.inv_m)
    assert [p.leaf.m for p in steps] == [1 << 9] * 3
    assert [(p.src, p.dst) for p in steps] == [(0, 1), (1, 1), (1, 2)]
    assert [p.levels for p in steps] == [
        ((1 << 18, 1, 1),),
        ((1 << 9, 1, 1), (1 << 9, 1 << 18, 1 << 18)),
        ((1 << 9, 1 << 18, 1), (1 << 9, 1 << 9, 1 << 9))]
    assert [(p.in_elem, p.out_elem) for p in steps] == [(1 << 18, 1 << 18), (1 << 9, 1 << 9),
                                                        (1, 1 << 18)]
    assert steps[-1].scale == plan.inv_m and all(len(p.levels) <= MAX_LEVELS for p in steps)


@pytest.mark.parametrize("s_len,rows", [(8, 6), (256, 64), (1 << 13, 3)])
def test_row_entry_pass_layout(s_len, rows):
    """Kernel T's row entry: one pass whose level groups the rows a tile
    holds; run as its plain twin it is ``ops.ntt``, both directions."""
    from lambda_snark_tpu_torch.ops.ntt import ntt_forward, ntt_inverse
    from lambda_snark_tpu_torch.ops.ntt_batched import row_pass
    from lambda_snark_tpu_torch.ops.ntt_large import run_passes_plain

    plan = NttPlan.create(s_len, P, fri.root_of_order(P, s_len))
    x = modarith.to_words(_vals((rows, s_len), seed=s_len))
    for inverse, want in ((False, ntt_forward(plan, x)), (True, ntt_inverse(plan, x))):
        p = row_pass(plan, rows, inverse)
        group = p.levels[0][0]
        assert rows % group == 0 and (rows // group) % 2 == 1
        got = run_passes_plain(P, 1, x.reshape(rows // group, group * s_len), [p])
        assert torch.equal(got.reshape(rows, s_len), want)
