"""The batched odd-coset quotient: kernel Q (``csrc/quotient.cu``) and its
plain PyTorch twin.

For (B, m) constraint evaluations a, b, c on the m-th roots (natural order)
it returns the coefficients of Q = (A B - C) / (X^m - 1) and of A, B, C,
and valid[i] = (a_i * b_i == c_i everywhere). On the odd coset psi w^t the
vanishing polynomial is -2, so Q's negacyclic NTT is (A B - C)(psi w^t) *
(-2)^-1: interpolate, negacyclic forward, pointwise, inverse negacyclic.

Kernel Q replaces the TPU kernels ``quotient_batch_fused``
(ops/quotient_pallas.py:143) and ``quotient_batch_mxu``
(ops/ntt_mxu_q45.py:466) for the 44-bit field and the Goldilocks field.
``quotient`` launches it for CUDA tensors and runs ``quotient_plain`` for
CPU tensors. Kernel Q keeps a row in the shared memory of a cluster of
``kernels.cluster_size`` blocks, up to m = 2^16 in one launch; a longer row
(Goldilocks, whose 2-adicity is 32; the 44-bit field stops at m = 2^12)
takes the long route on the card: kernel T's four-step for the three
transforms, with the twist folded into a load and the untwist into a store,
around kernel Q's elementwise entry ``quotient_pointwise``.

The plan's tables are what the kernel reads: the twiddles of omega and
omega^-1 in stage-major order (``ops.ntt.stage_index``: consecutive
threads read consecutive words), the twist psi^k / m stored at the DIF
position that holds coefficient k (``twist_rev``, as the JAX kernel's),
the untwist in natural order, and for the 44-bit field, whose
kernel multiplies by known constants with Shoup's lazy product, each table's
companion floor(w 2^64 / q) (``shoup``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from .. import kernels
from ..core import field
from . import modarith
from .ntt import (
    NttPlan,
    bitrev,
    ntt_forward_negacyclic,
    ntt_inverse,
    ntt_inverse_negacyclic,
    powers,
    stage_index,
)
from .ntt_large import check_rows, ntt_forward_large, ntt_inverse_large


def shoup(values: List[int], q: int) -> List[int]:
    """Shoup companions floor(w 2^64 / q) of canonical values w < q."""
    return [(w << 64) // q for w in values]


@dataclasses.dataclass(frozen=True, eq=False)
class ShoupTables:
    """The companions floor(w 2^64 / q) of a quotient plan's tables."""

    tw_stage: torch.Tensor  # (m,)
    tw_inv_stage: torch.Tensor  # (m,)
    twist_rev: torch.Tensor  # (m,)
    untwist: torch.Tensor  # (m,)
    inv_m: int


@dataclasses.dataclass(frozen=True, eq=False)
class QuotientPlan:
    """Tables for one (m, q, psi) on one device; omega = psi^2."""

    m: int
    q: int
    ntt: NttPlan  # holds omega^e, omega^-e, 1/m
    tw_stage: torch.Tensor  # (m,) omega's twiddles in stage-major order (ops.ntt.stage_index)
    tw_inv_stage: torch.Tensor  # (m,) omega^-1's
    twist_rev: torch.Tensor  # (m,) psi^rev(i) / m at DIF position i
    untwist: torch.Tensor  # (m,) psi^-k / (m (-2))
    neg_half_inv: int
    shoup: Optional[ShoupTables]  # the 44-bit field's companions, else None

    @staticmethod
    def create(m: int, q: int, psi: int, device="cpu") -> "QuotientPlan":
        omega = field.mul_mod(psi, psi, q)
        ntt = NttPlan.create(m, q, omega, psi, device=device)
        neg_half_inv = field.mod_inverse(q - 2, q)
        untwist_scale = field.mul_mod(ntt.inv_m, neg_half_inv, q)
        psi_inv = field.mod_inverse(psi, q)
        twist = powers(psi, m, q, scale=ntt.inv_m)
        twist_rev = [twist[i] for i in bitrev(m).tolist()]
        untwist = powers(psi_inv, m, q, scale=untwist_scale)
        stages = stage_index(m).to(device)
        companions = None
        if q == modarith.Q45:
            words = lambda vals: modarith.to_words(shoup(vals, q), device)
            companions = ShoupTables(
                tw_stage=words(powers(omega, m // 2, q)).index_select(0, stages),
                tw_inv_stage=words(powers(field.mod_inverse(omega, q), m // 2, q)
                                   ).index_select(0, stages),
                twist_rev=words(twist_rev), untwist=words(untwist),
                inv_m=shoup([ntt.inv_m], q)[0],
            )
        return QuotientPlan(
            m=m, q=q, ntt=ntt,
            tw_stage=ntt.tw.index_select(0, stages),
            tw_inv_stage=ntt.tw_inv.index_select(0, stages),
            twist_rev=modarith.to_words(twist_rev, device),
            untwist=modarith.to_words(untwist, device),
            neg_half_inv=neg_half_inv, shoup=companions,
        )


def quotient_plain(plan: QuotientPlan, a, b, c):
    """The same function as kernel Q, from ``ops.ntt`` and ``ops.modarith``."""
    q, ntt = plan.q, plan.ntt
    polys = [ntt_inverse(ntt, x) for x in (a, b, c)]
    a_odd, b_odd, c_odd = (ntt_forward_negacyclic(ntt, p) for p in polys)
    n_odd = modarith.sub_mod(modarith.mul_mod(a_odd, b_odd, q), c_odd, q)
    q_coeffs = ntt_inverse_negacyclic(ntt, modarith.mul_mod(n_odd, plan.neg_half_inv, q))
    valid = (modarith.mul_mod(a, b, q) == c).all(dim=-1)
    return (q_coeffs, *polys, valid)


def _check_inputs(plan: QuotientPlan, a, b, c) -> None:
    for x in (a, b, c):
        if x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != plan.m:
            raise ValueError(f"expected (B, {plan.m}) int64 words, got {x.dtype} {tuple(x.shape)}")
        if x.shape != a.shape or x.device != plan.untwist.device:
            raise ValueError("a, b, c must share one shape and the plan's device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")


def quotient(plan: QuotientPlan, a, b, c):
    """(B, m) int64 words a, b, c -> (Q, A, B, C coefficients (B, m), valid (B,) bool)."""
    _check_inputs(plan, a, b, c)
    if a.device.type == "cpu":
        return quotient_plain(plan, a, b, c)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    rows, log_m = a.shape[0], plan.m.bit_length() - 1
    cluster = kernels.cluster_size(rows, plan.m, 3 * plan.m)
    if cluster is None:
        return quotient_long(plan, a, b, c)
    if plan.q == modarith.Q45:
        entry = "quotient_q45"
    elif plan.q == modarith.GOLDILOCKS:
        entry = "quotient_goldilocks"
    else:
        raise ValueError(f"kernel Q has no reduction for q = {plan.q}")
    outs = [torch.empty_like(a) for _ in range(4)]
    valid = torch.empty(rows, dtype=torch.int32, device=a.device)
    if rows == 0:
        return (*outs, valid.bool())
    sh = plan.shoup
    companion = lambda name: None if sh is None else getattr(sh, name).data_ptr()
    tables = (plan.tw_inv_stage.data_ptr(), companion("tw_inv_stage"),
              plan.tw_stage.data_ptr(), companion("tw_stage"),
              plan.twist_rev.data_ptr(), companion("twist_rev"),
              plan.untwist.data_ptr(), companion("untwist"),
              plan.ntt.inv_m, 0 if sh is None else sh.inv_m)
    fn = getattr(kernels.load("quotient"), entry)
    rc = kernels.launch(a.device, fn, a.data_ptr(), b.data_ptr(), c.data_ptr(), *tables,
                        *(o.data_ptr() for o in outs), valid.data_ptr(), rows, log_m, cluster)
    kernels.check(rc, f"kernel Q (quotient, clusters of {cluster} blocks)")
    kernels.count(entry, 1, a.shape, f"cluster {cluster}")
    return (*outs, valid.bool())


def quotient_pointwise_plain(q: int, a_odd, b_odd, c_odd, a, b, c):
    """The same function as ``quotient_pointwise``, from ``ops.modarith``."""
    n_odd = modarith.sub_mod(modarith.mul_mod(a_odd, b_odd, q), c_odd, q)
    return n_odd, (modarith.mul_mod(a, b, q) == c).all(dim=-1)


def quotient_pointwise(q: int, a_odd, b_odd, c_odd, a, b, c):
    """(n = a_odd b_odd - c_odd, valid (B,) bool: a_t b_t == c_t everywhere)
    for contiguous (B, m) words, m a power of two: kernel Q's
    ``quotient_pointwise`` entry on CUDA tensors, its plain twin on CPU
    tensors."""
    modarith.check_modulus(q)
    m = a.shape[1] if a.dim() == 2 else 0
    if m < 1 or m & (m - 1):
        raise ValueError(f"expected (B, m) words with m a power of two, got {tuple(a.shape)}")
    for x in (a_odd, b_odd, c_odd, a, b, c):
        check_rows(x, m, a.device)
        if x.shape != a.shape:
            raise ValueError("the six inputs must share one shape")
    if a.device.type == "cpu":
        return quotient_pointwise_plain(q, a_odd, b_odd, c_odd, a, b, c)
    rows = a.shape[0]
    n_odd = torch.empty_like(a)
    valid = torch.ones(rows, dtype=torch.int32, device=a.device)
    if rows:
        fn = kernels.load("quotient").quotient_pointwise
        with torch.cuda.device(a.device):
            rc = fn(*(t.data_ptr() for t in (a_odd, b_odd, c_odd, a, b, c, n_odd, valid)), q,
                    rows, m.bit_length() - 1, torch.cuda.current_stream().cuda_stream)
        kernels.check(rc, "kernel Q (pointwise)")
        kernels.count("quotient_pointwise", 1, a.shape)
    return n_odd, valid.bool()


def quotient_long(plan: QuotientPlan, a, b, c):
    """The long route (m > 2^16): interpolate a, b, c (inverse four-step),
    move them onto the odd coset (forward four-step, psi^t in its load),
    N = a_odd b_odd - c_odd and the residual flags (``quotient_pointwise``),
    Q = iNTT(N) psi^-k / (-2) (the untwist in the last store). The card runs
    it from ``quotient``; on CPU tensors every step is its plain twin."""
    rows, large = a.shape[0], plan.ntt.large
    polys = ntt_inverse_large(large, torch.cat([a, b, c]))  # (3B, m)
    odd = ntt_forward_large(large, polys, pre=plan.ntt.psi_pows)
    n_odd, valid = quotient_pointwise(plan.q, odd[:rows], odd[rows:2 * rows],
                                      odd[2 * rows:], a, b, c)
    q_coeffs = ntt_inverse_large(large, n_odd, post=plan.untwist, scale=1)  # untwist has 1/m
    return (q_coeffs, polys[:rows], polys[rows:2 * rows], polys[2 * rows:], valid)
