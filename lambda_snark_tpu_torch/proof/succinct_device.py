"""The device front end of batched kind-7 proving (Goldilocks), shared by
kinds 8 and 9.

The counterpart of the JAX package's ``proof/succinct_device.py``
(``quotient_lde_device`` with the fused commitment, its ``defer_pull`` /
``finish_quotient_lde`` split, ``eval_device``) and of the zero-knowledge
masks of its ``succinct_batch._gl_batch_frontend``:

    (az, bz, cz) (S, m) constraint evaluations
      -> kernel Q: A, B, C interpolated, Q = (A B - C) / Z_H   (ops.quotient)
      -> ZK: A~ = A + Z_H rho_A, B~ and C~ alike, and
         Q~ = Q + rho_A B + rho_B A + Z_H rho_A rho_B - rho_C, whose
         products are exact convolutions on kernel T at the next power of
         two (one forward launch for every factor, one inverse for the sum)
      -> pad to n0, with any extra rows of the group (kind 9: z^, mu);
         kernel T: the LDE on offset <omega_n0>, the offset^i twist
         folded into its first pass                      (ops.ntt_large)
      -> kernel K: one interleaved-group Merkle tree per statement
      -> ChaCha20 draws (torch ops), kernel R: the commitment to the
         unmasked Q                                      (commit.lwe_device)

``quotient_lde_dispatch`` enqueues all of it on the current stream;
``finish_quotient_lde`` pulls the validity flags, the commitment words and
the roots in one transfer. At ring degree n < m kernel R does not run:
the pull carries the quotients instead, and each, without its trailing
zeros, is committed on the host (``commit.lwe.commit_batch``), as the JAX
package's unfused branch does. The
codewords, polynomials and trees stay on the device. ``eval_device``
evaluates A, B, C, Q at the dual challenges without pulling them
(``eval_at``: any rows at any points).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..commit.lwe import Commitment, LweContext, commit_batch
from ..commit.lwe_device import DeviceCommitContext, commit_batch_chacha
from ..core.errors import InvalidWitnessError
from ..core.params import NTT_MODULUS, NTT_PRIMITIVE_ROOT  # noqa: F401 (the JAX module's names)
from ..ops import modarith
from ..ops.ntt import NttPlan
from ..ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
from ..ops.ntt_large import NttLargePlan, ntt_forward_large, power_table
from ..ops.quotient import QuotientPlan, quotient
from ..pipeline import field_psi_for
from .fri import root_of_order
from .succinct import _gl_trim
from .fri_device import DevForest, forest_from_levels, group_forest_levels

P = NTT_MODULUS


@dataclasses.dataclass(frozen=True, eq=False)
class FrontendPlan:
    """Tables of the front end for (m, n0, offset) on one device."""

    m: int
    n0: int
    qplan: QuotientPlan
    lde: NttLargePlan
    twist: torch.Tensor  # (n0,) offset^i, the LDE's pre-table

    @staticmethod
    def create(m: int, n0: int, offset: int, device) -> "FrontendPlan":
        return FrontendPlan(
            m=m, n0=n0,
            qplan=QuotientPlan.create(m, P, field_psi_for(m, P), device=device),
            lde=NttLargePlan.create(n0, root_of_order(P, n0), device=device),
            twist=power_table(offset, n0, P, device),
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


# --- zero-knowledge masks ---------------------------------------------------------

_CONV_PLANS: dict = {}


def _conv_plan(n: int, device) -> NttPlan:
    key = (n, str(device))
    if key not in _CONV_PLANS:
        _CONV_PLANS[key] = NttPlan.create(n, P, root_of_order(P, n), device=device)
    return _CONV_PLANS[key]


def _pad(x: torch.Tensor, width: int) -> torch.Tensor:
    out = torch.zeros(x.shape[:-1] + (width,), dtype=torch.int64, device=x.device)
    out[..., : x.shape[-1]] = x
    return out


def _zh_mul(rho: torch.Tensor, m: int) -> torch.Tensor:
    """(X^m - 1) rho over the rows: (S, L) -> (S, m + L)."""
    length = rho.shape[1]
    out = _pad(rho.new_zeros((rho.shape[0], m)), m + length)
    out[:, m:] = rho
    out[:, :length] = modarith.sub_mod(out[:, :length], rho, P)
    return out


def _sum_of_products(xs: List[torch.Tensor], ys: List[torch.Tensor],
                     out_len: int) -> torch.Tensor:
    """sum_i x_i y_i as exact polynomial products of rows, (S, out_len):
    cyclic convolutions at the next power of two >= out_len, every factor
    in one forward launch of kernel T and the sum in one inverse."""
    n = max(2, 1 << (out_len - 1).bit_length())
    plan = _conv_plan(n, xs[0].device)
    s, k = xs[0].shape[0], len(xs)
    buf = torch.zeros((2 * k * s, n), dtype=torch.int64, device=xs[0].device)
    for i, t in enumerate(xs + ys):
        buf[i * s: (i + 1) * s, : t.shape[1]] = t
    f = ntt_forward_batched(plan, buf).reshape(2 * k, s, n)
    acc = modarith.mul_mod(f[0], f[k], P)
    for i in range(1, k):
        acc = modarith.add_mod(acc, modarith.mul_mod(f[i], f[k + i], P), P)
    return ntt_inverse_batched(plan, acc.contiguous())[:, :out_len]


def mask_polys(q_poly, a_poly, b_poly, c_poly, rho: torch.Tensor) -> torch.Tensor:
    """The masked polynomials (S, 4, m + 2L) in the order A~, B~, C~, Q~
    for masks rho (3, S, L) = (rho_A, rho_B, rho_C), each zero-padded to
    the longest, Q~'s."""
    m, length = a_poly.shape[1], rho.shape[2]
    rho_a, rho_b, rho_c = rho
    width = m + 2 * length
    masked = [_pad(modarith.add_mod(_pad(p, m + length), _zh_mul(r, m), P), width)
              for p, r in ((a_poly, rho_a), (b_poly, rho_b), (c_poly, rho_c))]
    cross = _sum_of_products([rho_a, rho_b], [b_poly, a_poly], m + length - 1)
    rho_ab = _sum_of_products([rho_a], [rho_b], 2 * length - 1)
    q_t = modarith.add_mod(_pad(q_poly, width), _pad(cross, width), P)
    q_t = modarith.add_mod(q_t, _pad(_zh_mul(rho_ab, m), width), P)
    q_t = modarith.sub_mod(q_t, _pad(rho_c, width), P)
    return torch.stack(masked + [q_t], dim=1)


# --- the front end ----------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Dispatched:
    """A front end enqueued on the device and not pulled yet."""

    lde: torch.Tensor  # (S, 4 + E, n0) codewords, the extra rows last
    polys: torch.Tensor  # (S, 4, width) A, B, C, Q (masked under ZK)
    levels: List[torch.Tensor]  # the group forest, leaf level first
    valid: torch.Tensor  # (S,) bool, kernel Q's a b = c flags
    commitment: Optional[torch.Tensor]  # (S, n) words of the commitments to Q
    # n < m: the quotients (S, m) and what their host commitment takes
    q_poly: Optional[torch.Tensor] = None
    host_commit: Optional[Tuple[LweContext, list]] = None


def quotient_lde_dispatch(az: torch.Tensor, bz: torch.Tensor, cz: torch.Tensor, n0: int,
                          offset: int, ctx: LweContext, seeds,
                          masks: Optional[np.ndarray] = None,
                          extra: Sequence[torch.Tensor] = ()) -> Dispatched:
    """Enqueue the front end of (S, m) constraint evaluations on the
    current stream. ``masks`` (3, S, L) uint64 (rho_A, rho_B, rho_C) makes
    it the zero-knowledge front end; the commitment is to the unmasked Q
    either way; below m (the ring degree n) it is left to
    ``finish_quotient_lde``. Each ``extra`` (S, w) polynomial row joins the
    group after A, B, C, Q: one LDE launch and one forest for 4 + E
    oracles (kind 9's z^ and mu)."""
    s, m = az.shape
    dev = az.device
    plan = frontend_plan(m, n0, offset, dev)
    q_poly, a_poly, b_poly, c_poly, valid = quotient(plan.qplan, az, bz, cz)
    if masks is None:
        polys = torch.stack([a_poly, b_poly, c_poly, q_poly], dim=1)
    else:
        rho = torch.from_numpy(np.ascontiguousarray(masks).view(np.int64)).to(dev)
        polys = mask_polys(q_poly, a_poly, b_poly, c_poly, rho)
    padded = _pad(polys, n0)
    if extra:
        padded = torch.cat([padded] + [_pad(x, n0)[:, None] for x in extra], dim=1)
    k = padded.shape[1]
    lde = ntt_forward_large(plan.lde, padded.reshape(k * s, n0),
                            pre=plan.twist).reshape(s, k, n0)
    levels = group_forest_levels(lde)
    if ctx.n < m:
        return Dispatched(lde=lde, polys=polys, levels=levels, valid=valid, commitment=None,
                          q_poly=q_poly, host_commit=(ctx, list(seeds)))
    commitment = commit_batch_chacha(device_commit_context(ctx, dev), q_poly, ctx, seeds)
    return Dispatched(lde=lde, polys=polys, levels=levels, valid=valid, commitment=commitment)


def finish_quotient_lde(d: Dispatched, first: int = 0) -> Tuple[List[Commitment], DevForest]:
    """Pull a dispatched front end's flags, commitment words (or, at n < m,
    quotients) and roots in one transfer: (commitments, the group forest).
    Raises InvalidWitnessError if some a_t b_t != c_t, naming the witness
    by its index plus ``first``; at n < m, CommitmentError for a quotient
    longer than the ring degree."""
    rows = d.commitment if d.commitment is not None else d.q_poly
    s, n = rows.shape
    pack = modarith.to_u64(torch.cat([d.valid.to(torch.int64), rows.reshape(-1),
                                      d.levels[-1][:, 0].reshape(-1)]))
    valid, words = pack[:s], pack[s: s + s * n].reshape(s, n)
    if not valid.all():
        bad = first + int(np.flatnonzero(valid == 0)[0])
        raise InvalidWitnessError(f"witness {bad} does not satisfy R1CS constraints")
    forest = forest_from_levels(d.levels, root_words=pack[s + s * n:].reshape(s, 4))
    if d.commitment is None:
        ctx, seeds = d.host_commit
        commitments, _openings = commit_batch(ctx, [_gl_trim(row) for row in words], seeds)
        return commitments, forest
    return [Commitment(words[i].copy()) for i in range(s)], forest


def quotient_lde_device(az, bz, cz, n0: int, offset: int, ctx: LweContext, seeds,
                        masks: Optional[np.ndarray] = None
                        ) -> Tuple[torch.Tensor, List[Commitment], torch.Tensor, DevForest]:
    """The front end, dispatched and pulled: (LDE codewords (S, 4, n0),
    commitments, polynomials (S, 4, width) in the order A, B, C, Q, the
    group forest)."""
    d = quotient_lde_dispatch(az, bz, cz, n0, offset, ctx, seeds, masks)
    commitments, forest = finish_quotient_lde(d)
    return d.lde, commitments, d.polys, forest


def eval_at(polys: torch.Tensor, points: np.ndarray) -> np.ndarray:
    """Each statement's K polynomials (S, K, width) at its P points (S, P)
    uint64: (S, P, K) uint64."""
    s, k, m = polys.shape
    pts = modarith.to_words(np.asarray(points, dtype=np.uint64), polys.device)  # (S, P)
    pows = torch.ones(pts.shape + (1,), dtype=torch.int64, device=polys.device)
    cur = pts[:, :, None]
    while pows.shape[-1] < m:
        step = min(pows.shape[-1], m - pows.shape[-1])
        pows = torch.cat([pows, modarith.mul_mod(pows[..., :step], cur, P)], dim=-1)
        cur = modarith.mul_mod(cur, cur, P)
    terms = modarith.mul_mod(polys[:, None, :, :], pows[:, :, None, :], P)  # (S, P, K, m)
    while terms.shape[-1] > 1:
        if terms.shape[-1] & 1:
            terms = torch.cat([terms, torch.zeros_like(terms[..., :1])], dim=-1)
        terms = modarith.add_mod(terms[..., 0::2], terms[..., 1::2], P)
    return modarith.to_u64(terms[..., 0])


def eval_device(polys: torch.Tensor, alphas: np.ndarray, betas: np.ndarray) -> np.ndarray:
    """A, B, C, Q (S, 4, width) at the dual challenges: (S, 8) uint64 in the
    wire order (A, B, C, Q at alpha, then at beta)."""
    s, k, _m = polys.shape
    return eval_at(polys, np.stack([alphas, betas], axis=1)).reshape(s, 2 * k)
