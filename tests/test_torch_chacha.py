"""The port's ChaCha20 randomness and the kind-7 commitment against the JAX
package: ``sampler_jax.chacha20_blocks_in_graph``, ``lwe.randomness_keys``,
``lwe.randomness_batch`` and ``lwe.commit_batch``. Every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambda_snark_tpu import Params, Profile, SecurityLevel
from lambda_snark_tpu.commit import lwe as jax_lwe
from lambda_snark_tpu.core.params import NTT_FRIENDLY_MODULUS, NTT_MODULUS
from lambda_snark_tpu.ops import sampler_jax
from lambda_snark_tpu.utils.chacha import chacha20_block

import lambda_snark_tpu_torch as port
from lambda_snark_tpu_torch.commit.lwe import randomness_keys
from lambda_snark_tpu_torch.commit.lwe_device import DeviceCommitContext, commit_batch_chacha
from lambda_snark_tpu_torch.ops import modarith, sampler

GL = NTT_MODULUS
SEEDS = [7, 100, (1 << 64) - 3]


def _contexts(n, k, q=GL, seed=0):
    jc = jax_lwe.LweContext(Params(SecurityLevel.BITS128, Profile.ring_b(n, k, q, 3.19)),
                            context_seed=seed)
    pc = port.LweContext(port.Params(port.SecurityLevel.BITS128,
                                     port.Profile.ring_b(n=n, k=k, q=q, sigma=3.19)),
                         context_seed=seed)
    return jc, pc


def test_randomness_keys_match():
    jc, pc = _contexts(64, 1, seed=5)
    assert np.array_equal(randomness_keys(pc, SEEDS), jax_lwe.randomness_keys(jc, SEEDS))


def test_chacha_blocks_match_jax_and_scalar():
    keys = np.random.default_rng(3).integers(0, 1 << 32, size=(3, 8), dtype=np.uint32)
    got = sampler.chacha20_blocks(torch.from_numpy(keys.astype(np.int64)), 5).numpy()
    want = np.asarray(sampler_jax.chacha20_blocks_in_graph(jnp.asarray(keys), 5))
    assert np.array_equal(got, want.astype(np.int64))
    assert got[2, 4].tolist() == chacha20_block([int(w) for w in keys[2]], 4, [0, 0])


@pytest.mark.parametrize("n,k", [(64, 1), (64, 2), (16, 1)])
def test_draws_match_randomness_batch(n, k):
    jc, pc = _contexts(n, k)
    ss, es = jax_lwe.randomness_batch(jc, SEEDS)
    keys = torch.from_numpy(randomness_keys(pc, SEEDS).astype(np.int64))
    signed = sampler.sample_chacha_signed(keys, k, n, modarith.to_words(pc.cdf)).numpy()
    assert np.array_equal(signed[:, :k], ss)
    assert np.array_equal(signed[:, k], es)


@pytest.mark.parametrize("q", [GL, NTT_FRIENDLY_MODULUS])
def test_commit_matches_commit_batch(q):
    jc, pc = _contexts(64, 1, q=q, seed=2)
    msgs = np.random.default_rng(4).integers(0, q, size=(3, 64), dtype=np.uint64)
    want, _ = jax_lwe.commit_batch(jc, list(msgs), SEEDS)
    dctx = DeviceCommitContext.from_host(pc, "cpu")
    got = modarith.to_u64(commit_batch_chacha(dctx, modarith.to_words(msgs), pc, SEEDS))
    for i in range(3):
        assert np.array_equal(got[i], want[i].words)
