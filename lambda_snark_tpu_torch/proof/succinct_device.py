"""The device front end of batched kind-7 proving (Goldilocks).

The counterpart of the JAX package's ``proof/succinct_device.py``
(``quotient_lde_device`` with the fused commitment, ``eval_device``):

    (az, bz, cz) (S, m) constraint evaluations
      -> kernel Q: A, B, C interpolated, Q = (A B - C) / Z_H   (ops.quotient)
      -> pad to n0, twist by offset^i                          (torch ops)
      -> kernel N: the LDE on offset <omega_n0>                (ops.ntt_large)
      -> kernel K: one interleaved-group Merkle tree per statement
      -> ChaCha20 draws (torch ops), kernel R: the commitment to Q

The codewords, polynomials and trees stay on the device; the host gets the
commitment words and the roots. ``eval_device`` evaluates A, B, C, Q at the
dual challenges without pulling the polynomials.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..commit.lwe import Commitment, LweContext
from ..commit.lwe_device import DeviceCommitContext, commit_batch_chacha
from ..core.errors import DomainError, InvalidWitnessError
from ..ops import modarith
from ..ops.ntt_large import NttLargePlan, ntt_forward_large
from ..ops.quotient import QuotientPlan, quotient
from ..pipeline import field_psi_for
from .fri import _gl_powers, root_of_order
from .fri_device import DevForest, commit_planes_dev_groups

P = modarith.GOLDILOCKS


@dataclasses.dataclass(frozen=True, eq=False)
class FrontendPlan:
    """Tables of the front end for (m, n0, offset) on one device."""

    m: int
    n0: int
    qplan: QuotientPlan
    lde: NttLargePlan
    twist: torch.Tensor  # (m,) offset^i: only the first m coefficients are nonzero

    @staticmethod
    def create(m: int, n0: int, offset: int, device) -> "FrontendPlan":
        return FrontendPlan(
            m=m, n0=n0,
            qplan=QuotientPlan.create(m, P, field_psi_for(m, P), device=device),
            lde=NttLargePlan.create(n0, root_of_order(P, n0), device=device),
            twist=modarith.to_words(_gl_powers(offset, m), device),
        )


_PLANS: dict = {}


def frontend_plan(m: int, n0: int, offset: int, device) -> FrontendPlan:
    key = (m, n0, offset, str(device))
    if key not in _PLANS:
        _PLANS[key] = FrontendPlan.create(m, n0, offset, device)
    return _PLANS[key]


_COMMIT_CTX: dict = {}


def device_commit_context(ctx: LweContext, device) -> DeviceCommitContext:
    key = (id(ctx), str(device))
    if key not in _COMMIT_CTX:
        _COMMIT_CTX[key] = (ctx, DeviceCommitContext.from_host(ctx, device))
    return _COMMIT_CTX[key][1]


def commit_quotients(ctx: LweContext, q_poly: torch.Tensor, seeds) -> List[Commitment]:
    """Module-LWE commitments to the quotients (S, m), m <= n, one seed
    each: the quotient enters the ring as it is (the JAX fused commit)."""
    dctx = device_commit_context(ctx, q_poly.device)
    words = modarith.to_u64(commit_batch_chacha(dctx, q_poly.contiguous(), ctx, seeds))
    return [Commitment(words[i].copy()) for i in range(words.shape[0])]


def quotient_lde_device(az: torch.Tensor, bz: torch.Tensor, cz: torch.Tensor, n0: int,
                        offset: int, ctx: LweContext, seeds
                        ) -> Tuple[torch.Tensor, List[Commitment], torch.Tensor, DevForest]:
    """(S, m) constraint evaluations -> (LDE codewords (S, 4, n0), commitments,
    polynomials (S, 4, m) in the order A, B, C, Q, the group forest).

    Raises InvalidWitnessError if some a_t b_t != c_t (kernel Q's flags),
    and DomainError if the ring degree n is below m: the JAX package takes
    its device front end only for n >= m, and its host route for n < m is
    not ported."""
    s, m = az.shape
    if ctx.n < m:
        raise DomainError(f"ring degree {ctx.n} < m = {m}: the device front end "
                          f"commits to the whole quotient in one ring element")
    plan = frontend_plan(m, n0, offset, az.device)
    q_poly, a_poly, b_poly, c_poly, valid = quotient(plan.qplan, az, bz, cz)
    if not bool(valid.all()):
        bad = int(torch.nonzero(~valid)[0, 0])
        raise InvalidWitnessError(f"witness {bad} does not satisfy R1CS constraints")
    polys = torch.stack([a_poly, b_poly, c_poly, q_poly], dim=1)  # (S, 4, m)
    padded = torch.zeros((s, 4, n0), dtype=torch.int64, device=az.device)
    padded[..., :m] = modarith.mul_mod(polys, plan.twist, P)
    lde = ntt_forward_large(plan.lde, padded.reshape(4 * s, n0)).reshape(s, 4, n0)
    forest = commit_planes_dev_groups(lde)
    commitments = commit_quotients(ctx, q_poly, seeds)
    return lde, commitments, polys, forest


def eval_device(polys: torch.Tensor, alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """A, B, C, Q (S, 4, m) at the dual challenges: (S, 8) uint64 in the
    wire order (A, B, C, Q at alpha, then at beta)."""
    s, k, m = polys.shape
    pts = modarith.to_words(np.stack([alphas, betas], axis=1).astype(np.uint64),
                            polys.device)  # (S, 2)
    pows = torch.ones((s, 2, 1), dtype=torch.int64, device=polys.device)
    cur = pts[:, :, None]
    while pows.shape[-1] < m:
        step = min(pows.shape[-1], m - pows.shape[-1])
        pows = torch.cat([pows, modarith.mul_mod(pows[..., :step], cur, P)], dim=-1)
        cur = modarith.mul_mod(cur, cur, P)
    terms = modarith.mul_mod(polys[:, None, :, :], pows[:, :, None, :], P)  # (S, 2, 4, m)
    while terms.shape[-1] > 1:
        if terms.shape[-1] & 1:
            terms = torch.cat([terms, torch.zeros_like(terms[..., :1])], dim=-1)
        terms = modarith.add_mod(terms[..., 0::2], terms[..., 1::2], P)
    return modarith.to_u64(terms[..., 0]).reshape(s, 2 * k)
