"""The port's ring commitment (kernel R's plain twin, the sampler, the
context) against the JAX package: ``lwe_jax.commit_batch`` and the TPU
kernels as the CPU runs them, ``commit_batch_mxu`` and ``fused_commit``;
then a Python-int model of kernel R's cluster stage order
(``torch_cluster_model``) against the plain twin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cluster_model as model

from lambda_snark_tpu import Params, Profile, SecurityLevel
from lambda_snark_tpu.commit.lwe import LweContext as JaxLweContext
from lambda_snark_tpu.commit.lwe_jax import DeviceCommitContext as JaxDeviceCommitContext
from lambda_snark_tpu.commit.lwe_jax import commit_batch_jit
from lambda_snark_tpu.core.params import NTT_FRIENDLY_MODULUS
from lambda_snark_tpu.ops.limb import u64_to_limbs
from lambda_snark_tpu.ops.ring_mxu import RingMxuPlan, commit_batch_mxu
from lambda_snark_tpu.ops.ring_pallas import RingCommitPlan as JaxRingPlan
from lambda_snark_tpu.ops.ring_pallas import fused_commit

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.commit.lwe_device import DeviceCommitContext, commit_batch
from lambda_snark_tpu_torch.convert import commit_context_from_numpy, words_to_planes
from lambda_snark_tpu_torch.ops import modarith
from lambda_snark_tpu_torch.commit.lwe import goldilocks_ring_plan
from lambda_snark_tpu_torch.ops.ring_commit import (
    P,
    RingCommitPlan,
    embed_signed,
    ring_commit,
    ring_commit_plain,
)
from lambda_snark_tpu_torch.ops.sampler import prng_key

Q = NTT_FRIENDLY_MODULUS
N = 64
BATCH = 4


def _contexts(n, seed=3):
    jax_ctx = JaxLweContext(Params(SecurityLevel.BITS128,
                                   Profile.ring_b(n=n, k=2, q=Q, sigma=3.19)), context_seed=seed)
    ours = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                       port.Profile.ring_b(n=n, k=2, q=Q, sigma=3.19)),
                           context_seed=seed)
    return jax_ctx, ours


@pytest.fixture(scope="module")
def ctxs():
    jax_ctx, ours = _contexts(N)
    return jax_ctx, JaxDeviceCommitContext.from_host(jax_ctx), ours, \
        DeviceCommitContext.from_host(ours, "cpu")


@pytest.mark.parametrize("n,seed", [(64, 3), (4096, 1)])
def test_context_matches(n, seed):
    jax_ctx, ours = _contexts(n, seed)
    assert np.array_equal(ours.a_hat, jax_ctx.a_hat)
    assert np.array_equal(ours.cdf, jax_ctx.cdf)


def test_context_from_numpy_equals_derived(ctxs):
    _jc, jd, _ours, dctx = ctxs
    carried = commit_context_from_numpy(jd.a_hat_planes, jd.cdf_hi, jd.cdf_lo,
                                        jd.n, jd.k, jd.sigma, device="cpu")
    assert torch.equal(carried.ring.a_hat, dctx.ring.a_hat)
    assert torch.equal(carried.ring.a_hat_rev, dctx.ring.a_hat_rev)
    assert torch.equal(carried.cdf, dctx.cdf)
    msgs = modarith.to_words(np.random.default_rng(2).integers(0, Q, size=(BATCH, N), dtype=np.uint64))
    assert torch.equal(commit_batch(carried, msgs, prng_key(9))[0],
                       commit_batch(dctx, msgs, prng_key(9))[0])


def _randomness(seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(-39, 40, size=(2, BATCH, N), dtype=np.int32)
    e = rng.integers(-39, 40, size=(BATCH, N), dtype=np.int32)
    s[0, 0, :2] = [-39, 39]
    return torch.from_numpy(s), torch.from_numpy(e)


@pytest.mark.parametrize("msg_len", [N, N // 2 + 1])
def test_ring_commit_matches_fused_pallas(ctxs, msg_len):
    jax_ctx, _jd, _ours, dctx = ctxs
    s, e = _randomness(msg_len)
    msg = np.random.default_rng(5).integers(0, Q, size=(BATCH, msg_len), dtype=np.uint64)
    padded = np.zeros((BATCH, N), dtype=np.uint64)
    padded[:, :msg_len] = msg
    planes = lambda w: jnp.asarray(words_to_planes(w, 4))
    s_planes = jnp.swapaxes(planes(embed_signed(s)), 0, 1)  # (k, D, B, n)
    theirs = fused_commit(JaxRingPlan.create(jax_ctx), s_planes,
                          planes(embed_signed(e)), jnp.asarray(u64_to_limbs(padded, 4)))
    ours = ring_commit(dctx.ring, s, e, modarith.to_words(msg))
    assert np.array_equal(words_to_planes(ours, 4), np.asarray(theirs))


@pytest.mark.parametrize("route", ["xla", "mxu"])
def test_commit_batch_matches_jax(ctxs, route):
    jax_ctx, jd, _ours, dctx = ctxs
    msgs = np.random.default_rng(6).integers(0, Q, size=(BATCH, N), dtype=np.uint64)
    key = jax.random.PRNGKey(11)
    msg_planes = jnp.asarray(u64_to_limbs(msgs, 4))
    if route == "xla":
        want_c, want_s, want_e = commit_batch_jit(jd, msg_planes, key)
    else:
        want_c, want_s, want_e = commit_batch_mxu(RingMxuPlan.create(jax_ctx), jd, msg_planes, key)
    got_c, got_s, got_e = commit_batch(dctx, modarith.to_words(msgs), prng_key(11))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))
    assert np.array_equal(words_to_planes(got_c, 4), np.asarray(want_c))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cluster", [1, 2, 4, 8])
@pytest.mark.parametrize("log_n", [6, 7, 8, 9])
def test_cluster_model_matches_plain(log_n, cluster, k):
    """Kernel R's stage order over a cluster of C blocks (embed and psi^t
    into the top DIF stages' exchange, the local stages with A_hat_j o x
    summed in the last pass, the last DIT stages' exchange into psi^-t / n,
    e and msg) as Python ints, on the plan's tables, equals
    ``ring_commit_plain``, which the tests above hold against the JAX
    package."""
    n, rows = 1 << log_n, 2
    rng = np.random.default_rng(log_n * 10 + cluster + k)
    ring = RingCommitPlan.create(rng.integers(0, P, size=(k, n), dtype=np.uint64),
                                 goldilocks_ring_plan(n))
    s = torch.from_numpy(rng.integers(-39, 40, size=(k, rows, n), dtype=np.int32))
    e = torch.from_numpy(rng.integers(-39, 40, size=(rows, n), dtype=np.int32))
    msg = modarith.to_words(rng.integers(0, P, size=(rows, n // 2 + 1), dtype=np.uint64))
    ints = lambda t: [int(v) for v in modarith.to_u64(t)]
    want = ring_commit_plain(ring, s, e, msg)
    a_hat_rev = [ints(ring.a_hat_rev[j]) for j in range(k)]
    tables = (ints(ring.ntt.psi_pows), ints(ring.ntt.psi_inv_n), ints(ring.tw_stage),
              ints(ring.tw_inv_stage))
    for i in range(rows):
        got = model.ring_commit_row(P, s[:, i].tolist(), e[i].tolist(), ints(msg[i]),
                                    a_hat_rev, *tables, cluster)
        assert got == ints(want[i])
