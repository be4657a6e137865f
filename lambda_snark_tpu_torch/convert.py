"""State carried across from the JAX package.

The JAX package stores a residue as D 16-bit digits in (D, ...) uint32
planes and a SHA3 digest as 8 uint32 words on a leading axis; the port
stores one 64-bit word and a digest as 4 words on a trailing axis. Proofs
cross as their wire bytes; a commitment context is rebuilt from its
parameters and checked. These helpers take the JAX package's objects by
their fields (duck-typed) and are used at the test boundary, where both
packages meet.
"""

from __future__ import annotations

import numpy as np
import torch

from .commit.lwe import LweContext
from .commit.lwe_device import DeviceCommitContext
from .core.params import Params, Profile, SecurityLevel
from .ops import modarith
from .proof.fri import FriProof
from .proof.succinct import SuccinctProofR1CS


def planes_to_words(planes: np.ndarray) -> torch.Tensor:
    """(D, ...) uint32 16-bit digit planes -> (...) int64 words (CPU)."""
    planes = np.asarray(planes, dtype=np.uint64)
    acc = np.zeros(planes.shape[1:], dtype=np.uint64)
    for i in range(planes.shape[0]):
        acc |= planes[i] << np.uint64(16 * i)
    return modarith.to_words(acc)


def words_to_planes(words: torch.Tensor, d: int) -> np.ndarray:
    """(...) int64 words -> (d, ...) uint32 16-bit digit planes."""
    vals = modarith.to_u64(words)
    return np.stack([
        ((vals >> np.uint64(16 * i)) & np.uint64(0xFFFF)).astype(np.uint32)
        for i in range(d)
    ])


def commit_context_from_numpy(a_hat_planes: np.ndarray, cdf_hi: np.ndarray,
                              cdf_lo: np.ndarray, n: int, k: int, sigma: float,
                              device="cuda") -> DeviceCommitContext:
    """The port's commit context from the numpy fields of a JAX
    ``DeviceCommitContext`` (A-hat as (k, D, n) planes, the CDF split in
    (hi, lo) uint32 halves)."""
    a_hat = modarith.to_u64(planes_to_words(np.moveaxis(np.asarray(a_hat_planes), 1, 0)))
    if a_hat.shape != (k, n):
        raise ValueError(f"A-hat planes give shape {a_hat.shape}, expected {(k, n)}")
    cdf = (np.asarray(cdf_hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(cdf_lo, dtype=np.uint64)
    return DeviceCommitContext.create(a_hat, cdf, sigma, device)


def digests_from_jax_words(words8: np.ndarray) -> torch.Tensor:
    """JAX digest words [8, ...] uint32 -> the port's (..., 4) int64 words."""
    w = np.moveaxis(np.asarray(words8, dtype=np.uint32), 0, -1)
    return modarith.to_words(np.ascontiguousarray(w).view(np.uint64))


def digests_to_jax_words(digests: torch.Tensor) -> np.ndarray:
    """The port's (..., 4) digest words -> JAX digest words [8, ...] uint32."""
    return np.moveaxis(modarith.to_u64(digests).view(np.uint32), -1, 0)


def fri_proof_from_jax(proof) -> FriProof:
    """A JAX ``FriProof`` as the port's, through its wire bytes."""
    blob = proof.to_bytes()
    ours, end = FriProof.read(blob, 0)
    if end != len(blob):
        raise ValueError("trailing bytes after the FRI proof")
    return ours


def succinct_proof_from_jax(proof) -> SuccinctProofR1CS:
    """A JAX ``SuccinctProofR1CS`` as the port's, through its wire bytes."""
    return SuccinctProofR1CS.from_bytes(proof.to_bytes())


def lwe_context_from_jax(ctx) -> LweContext:
    """The port's commitment context with the parameters of a JAX
    ``LweContext``; its A-hat and CDF must equal the JAX context's."""
    ours = LweContext(Params(SecurityLevel(int(ctx.params.security)),
                             Profile.ring_b(n=ctx.n, k=ctx.k, q=ctx.q, sigma=ctx.sigma)),
                      context_seed=ctx.context_seed)
    if not (np.array_equal(ours.a_hat, ctx.a_hat) and np.array_equal(ours.cdf, ctx.cdf)):
        raise ValueError("the rebuilt commitment context differs from the JAX one")
    return ours
