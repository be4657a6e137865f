"""Batched Module-LWE commitments on the device.

The counterpart of the JAX package's ``commit/lwe_jax.py``
(``DeviceCommitContext``, ``commit_batch``, ``commit_in_graph_chacha``).
Two sources of randomness, both in torch ops (``ops.sampler``):

- ``commit_batch``: counter-mode threefry keyed by (key, stream j,
  statement b, position t), so a statement's draws do not depend on the
  batch it is in (the batched prover of kinds 2 and 3);
- ``commit_batch_chacha``: one ChaCha20 stream per commit seed, value-
  identical to the host ``lwe.commit_batch`` (the succinct kind 7).

The ring product is kernel R (``ops.ring_commit``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve
from ..ops import modarith, sampler
from ..ops.ring_commit import RingCommitPlan, ring_commit
from .lwe import LweContext, goldilocks_ring_plan, randomness_keys


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceCommitContext:
    """A-hat, the CDF table and the ring tables, staged on one device."""

    n: int
    k: int
    sigma: float
    ring: RingCommitPlan
    cdf: torch.Tensor  # (T,) u64 CDF words

    @staticmethod
    def create(a_hat: np.ndarray, cdf: np.ndarray, sigma: float,
               device="cuda") -> "DeviceCommitContext":
        """From A-hat (k, n) uint64 and the u64 CDF table."""
        dev = resolve(device)
        k, n = a_hat.shape
        ring = RingCommitPlan.create(a_hat, goldilocks_ring_plan(n, dev))
        return DeviceCommitContext(n=n, k=k, sigma=sigma, ring=ring,
                                   cdf=modarith.to_words(cdf, dev))

    @staticmethod
    def from_host(ctx: LweContext, device="cuda") -> "DeviceCommitContext":
        return DeviceCommitContext.create(ctx.a_hat, ctx.cdf, ctx.sigma, device)

    @property
    def device(self) -> torch.device:
        return self.cdf.device


def sample_randomness(dctx: DeviceCommitContext, key, batch: int):
    """(s (k, B, n), e (B, n)) int32 draws for statements 0..B-1."""
    dev = dctx.device
    signed = sampler.sample_signed(
        key, range(dctx.k + 1),
        torch.arange(batch, dtype=torch.int64, device=dev),
        torch.arange(dctx.n, dtype=torch.int64, device=dev),
        dctx.cdf,
    )
    return signed[: dctx.k].contiguous(), signed[dctx.k].contiguous()


def commit_batch(dctx: DeviceCommitContext, messages: torch.Tensor, key):
    """Commit to messages (B, L) int64 words, L <= n, canonical mod p.

    Returns (commitment words (B, n), s (k, B, n) int32, e (B, n) int32)."""
    s, e = sample_randomness(dctx, key, messages.shape[0])
    return ring_commit(dctx.ring, s, e, messages.contiguous()), s, e


def commit_batch_chacha(dctx: DeviceCommitContext, messages: torch.Tensor,
                        ctx: LweContext, seeds) -> torch.Tensor:
    """Commit to messages (S, L) int64 words, L <= n, with the randomness of
    ``lwe.commit(ctx, message, seed)`` per statement; returns (S, n) words.
    Messages enter as they are (canonical mod p): the host path's reduction
    mod the field q is the caller's."""
    keys = torch.from_numpy(randomness_keys(ctx, seeds).astype(np.int64)).to(dctx.device)
    signed = sampler.sample_chacha_signed(keys, dctx.k, dctx.n, dctx.cdf)  # (S, k+1, n)
    s = signed[:, : dctx.k].transpose(0, 1).contiguous()
    e = signed[:, dctx.k].contiguous()
    return ring_commit(dctx.ring, s, e, messages.contiguous())
