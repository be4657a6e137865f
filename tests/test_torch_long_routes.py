"""The long routes of kernels Q and R (rows past a cluster's shared memory,
m = n > 2^16; run here at 2^14) with every step as its plain twin, on the
CPU: the chain of four-step transforms with folded twist and untwist tables
and the elementwise entries' twins gives exactly ``quotient_plain`` and
``ring_commit_plain``, which ``tests/test_torch_quotient.py`` and
``tests/test_torch_ring_commit.py`` hold against the JAX package. Then the
rule that picks a cluster size for kernels Q and R, or the long route."""

import numpy as np
import pytest
import torch

from lambda_snark_tpu_torch import kernels
from lambda_snark_tpu_torch.commit.lwe import goldilocks_ring_plan
from lambda_snark_tpu_torch.core.params import NTT_MODULUS
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.ops.ntt import NttPlan
from lambda_snark_tpu_torch.ops.ntt_large import NttLargePlan, ntt_inverse_large, power_table
from lambda_snark_tpu_torch.ops.quotient import (
    QuotientPlan,
    quotient_long,
    quotient_plain,
    quotient_pointwise,
)
from lambda_snark_tpu_torch.ops.ring_commit import (
    RingCommitPlan,
    ring_accumulate,
    ring_commit_long,
    ring_commit_plain,
    ring_finish,
    ring_twist,
)
from lambda_snark_tpu_torch.pipeline import field_psi_for
from lambda_snark_tpu_torch.proof.fri import root_of_order

GL = NTT_MODULUS


def _words(q, shape, seed):
    return modarith.to_words(np.random.default_rng(seed).integers(0, q, size=shape,
                                                                   dtype=np.uint64))


def test_pre_and_post_tables_fold_elementwise_products():
    m = 1 << 14
    large = NttLargePlan.create(m, root_of_order(GL, m))
    x, pre, post = _words(GL, (2, m), 1), _words(GL, (m,), 2), _words(GL, (m,), 3)
    want = modarith.mul_mod(ntt_inverse_large(large, modarith.mul_mod(x, pre, GL)), post, GL)
    assert torch.equal(ntt_inverse_large(large, x, pre=pre, post=post), want)
    assert torch.equal(power_table(7, 1000, GL)[999:], modarith.to_words([pow(7, 999, GL)]))


def test_quotient_long_route_matches_plain():
    m = 1 << 14
    plan = QuotientPlan.create(m, GL, field_psi_for(m, GL))
    a, b = _words(GL, (3, m), 1), _words(GL, (3, m), 2)
    c = modarith.mul_mod(a, b, GL)
    c[2, 9] = 0
    got, want = quotient_long(plan, a, b, c), quotient_plain(plan, a, b, c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert got[4].tolist() == [True, True, False]


@pytest.mark.parametrize("k", [1, 2])
def test_ring_commit_long_route_matches_plain(k):
    n, rows = 1 << 14, 2
    rng = np.random.default_rng(4)
    ring = RingCommitPlan.create(rng.integers(0, GL, size=(k, n), dtype=np.uint64),
                                 goldilocks_ring_plan(n))
    s = torch.from_numpy(rng.integers(-39, 40, size=(k, rows, n), dtype=np.int32))
    e = torch.from_numpy(rng.integers(-39, 40, size=(rows, n), dtype=np.int32))
    msg = _words(GL, (rows, n - 5), 6)
    assert torch.equal(ring_commit_long(ring, s, e, msg), ring_commit_plain(ring, s, e, msg))


def test_inverse_scale_and_shared_plan():
    """The inverse four-step's scale replaces its 1/m; an NttPlan builds
    its four-step plan once."""
    m = 1 << 14
    plan = NttPlan.create(m, GL, root_of_order(GL, m))
    assert plan.large is plan.large and plan.large.m == m
    x = _words(GL, (2, m), 7)
    want = modarith.mul_mod(ntt_inverse_large(plan.large, x), m, GL)
    assert torch.equal(ntt_inverse_large(plan.large, x, scale=1), want)


def _step_case(bad):
    """A long-route step wrapper and arguments of which one is malformed."""
    m, rows = 16, 2
    words = _words(GL, (rows, m), 8)
    small = torch.zeros((1, rows, m), dtype=torch.int32)
    ring = RingCommitPlan.create(np.ones((1, m), dtype=np.uint64), goldilocks_ring_plan(m))
    e, msg = small[0], words
    if bad == "pointwise_dtype":
        return quotient_pointwise, (GL, words, words, words, words, words, words.to(torch.int32))
    if bad == "pointwise_strided":
        wide = _words(GL, (rows, 2 * m), 9)[:, ::2]
        return quotient_pointwise, (GL, words, words, wide, words, words, words)
    if bad == "pointwise_rows":
        return quotient_pointwise, (GL, words, words, words[:1], words, words, words)
    if bad == "pointwise_width":
        odd = _words(GL, (rows, 12), 10)
        return quotient_pointwise, (GL, *(odd,) * 6)
    if bad == "twist_dtype":
        return lambda: ring_twist(ring, small.to(torch.int64)), ()
    if bad == "twist_width":
        return lambda: ring_twist(ring, small[:, :, :8].contiguous()), ()
    if bad == "accumulate_dtype":
        return lambda: ring_accumulate(ring, small), ()
    if bad == "accumulate_strided":
        return lambda: ring_accumulate(ring, _words(GL, (1, rows, 2 * m), 12)[:, :, ::2]), ()
    if bad == "finish_dtype":
        return lambda: ring_finish(ring, words.to(torch.int32), e, msg), ()
    if bad == "finish_long_message":
        return lambda: ring_finish(ring, words, e, _words(GL, (rows, m + 1), 11)), ()
    return lambda: ring_finish(ring, words, e[:1], msg), ()


@pytest.mark.parametrize("bad", [
    "pointwise_dtype", "pointwise_strided", "pointwise_rows", "pointwise_width",
    "twist_dtype", "twist_width", "accumulate_dtype", "accumulate_strided",
    "finish_dtype", "finish_long_message", "finish_rows"])
def test_step_wrappers_reject(bad):
    """Each step of the long routes checks its inputs before it picks the
    kernel or the twin, so a malformed tensor never reaches the card."""
    fn, args = _step_case(bad)
    with pytest.raises(ValueError):
        fn(*args)


@pytest.mark.parametrize("rows,m,buffers,want", [
    (256, 4096, 3, 1), (256, 2048, 3, 1), (256, 4096, 2, 1),  # kinds 2/3: Q and R
    (16, 1 << 13, 3, 8), (16, 1 << 13, 2, 8),  # kind 7 at m = 2^13
    (16, 1 << 14, 3, 8), (16, 1 << 14, 2, 8),  # kind 7 at m = 2^14
    (16, 1 << 16, 3, 8), (1, 1 << 16, 2, 8),  # the longest rows in one launch
    (16, 1 << 17, 3, None), (16, 1 << 17, 2, None), (1, 1 << 20, 2, None),  # long routes
    (0, 64, 3, 8), (1, 64, 2, 8), (0, 2, 3, 1), (1, 2, 2, 1), (1, 4, 3, 2), (5, 16, 2, 4),
    (132, 4096, 3, 1), (66, 4096, 3, 2), (132, 1 << 15, 3, 4), (132, 1 << 15, 2, 4),
])
def test_cluster_size_rule(rows, m, buffers, want):
    """Blocks per row of kernels Q (three buffers of m words a row) and R
    (two) at the path shapes and the edges; None sends a row to the long
    route."""
    assert kernels.cluster_size(rows, m, buffers * m) == want


@pytest.mark.parametrize("buffers", [2, 3])
@pytest.mark.parametrize("rows", [0, 1, 3, 16, 33, 131, 256, 4096])
def test_cluster_size_invariants(rows, buffers):
    """Wherever a cluster is chosen, it is 1, 2, 4 or 8 blocks, each block
    holds at most 2^13 words of each buffer and takes at least one exchange
    group (C^2 <= m), and the grid fills the card's SMs unless C is already
    as large as the row allows; a row of 2^16 words always fits."""
    for log_m in range(1, 18):
        m = 1 << log_m
        c = kernels.cluster_size(rows, m, buffers * m)
        if c is None:
            assert m > 1 << 16
            continue
        assert c in (1, 2, 4, 8) and m // c <= 1 << 13 and c * c <= m
        assert rows * c >= kernels.SM_COUNT or c == 8 or 4 * c * c > m
        assert c == 1 or rows * c // 2 < kernels.SM_COUNT or m // c * 2 > 1 << 13
