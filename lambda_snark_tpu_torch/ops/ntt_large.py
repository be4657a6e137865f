"""Batched cyclic NTTs past one block's tile: the four-step of kernels N and
T (``csrc/ntt.cu``, entry ``ntt_four_step``) and its plain twins.

``ntt_forward_large(plan, x)`` maps rows x (B, m) of int64 words to
X_k = sum_t x_t omega^(t k) in natural order, for m = R C up to 2^26, any
primitive m-th root omega of any modulus ``ops.modarith`` supports (the
plan's); ``ntt_inverse_large`` is the transform with omega^-1 times 1/m.
Both take optional (m,) tables folded into the transform: ``pre`` multiplies
x_t before it, ``post`` multiplies X_k after it (a psi-twist and a
psi^-k / m untwist make them negacyclic); the inverse's ``scale`` (1/m
unless given) multiplies every word in the last store, so an untwist table
that already holds its 1/m passes ``scale=1``. Four steps, as the JAX package's
``ops/ntt_large.py``: R-point NTTs down the columns of x viewed as (R, C),
the twiddle omega^(h b), C-point NTTs along the rows, and the transposed
read-out out[h + R g].

The size cap is the tile: each sub-transform of a pass lives in one block's
64 KiB of shared memory, so R, C <= 2^13 and m <= 2^26. The cap was once
2^20, the largest size at which the JAX package runs its TPU four-step
(``ops/ntt_mxu.py``), with the m-word twiddle table built as a list of Python
ints; neither bounds the kernel. The table is made on the plan's device by
doubling (log2 m products), so a 2^26-point plan's two 512 MiB tables take
no host time.

Kernel N replaces the TPU kernels ``ntt_forward_mxu_packed``
(ops/ntt_mxu.py:631) and its leaf ``dft_matmul_apply_pallas``
(ops/ntt_mxu.py:378); it runs the kind-7 LDE and, as kernel T, the long
routes of ``ops.quotient`` and ``ops.ring_commit``. Its leaf is kernel T's
row entry (``ops.ntt_batched``). The wrappers launch it for CUDA tensors
and take the ``*_plain`` twins (built on ``ops.ntt``) for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import kernels
from ..core import field
from . import modarith
from .ntt import NttPlan, ntt_forward, ntt_inverse

P = modarith.GOLDILOCKS
_MAX_LOG_LEAF = 13  # one sub-transform fills a 64 KiB shared-memory tile
MAX_LEAF_LEN = 1 << _MAX_LOG_LEAF
_MAX_LOG_M = 2 * _MAX_LOG_LEAF


def check_rows(x: torch.Tensor, width: int, device) -> None:
    """Raise unless x is a contiguous (B, width) int64 tensor on ``device``."""
    if x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"expected (B, {width}) int64 words, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if x.device != device:
        raise ValueError("input must lie on the plan's device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def power_table(base: int, count: int, q: int, device="cpu") -> torch.Tensor:
    """(count,) words base^e mod q, e < count, by doubling on ``device``."""
    out = modarith.to_words([1], device)
    step = base % q
    while out.shape[0] < count:
        out = torch.cat([out, modarith.mul_mod(out, step, q)])
        step = step * step % q
    return out[:count]


@dataclasses.dataclass(frozen=True, eq=False)
class NttLargePlan:
    """Tables for the m-point transform with root omega mod q on one device."""

    m: int
    q: int
    omega: int
    inv_m: int
    r: int
    c: int
    plan_r: NttPlan  # root omega^C, order R (its tw_inv serves the inverse)
    plan_c: NttPlan  # root omega^R, order C
    pw: torch.Tensor  # (m,) omega^e
    pw_inv: torch.Tensor  # (m,) omega^-e

    @staticmethod
    def create(m: int, omega: int, device="cpu", q: int = P) -> "NttLargePlan":
        modarith.check_modulus(q)
        log_m = m.bit_length() - 1
        if m != 1 << log_m or not 2 <= log_m <= _MAX_LOG_M:
            raise ValueError(f"m = {m} must be a power of two in [4, 2^{_MAX_LOG_M}]")
        if field.mod_pow(omega, m // 2, q) != q - 1:
            raise ValueError(f"omega is not a primitive {m}-th root of unity mod {q}")
        r = 1 << (log_m // 2)
        c = m // r
        return NttLargePlan(
            m=m, q=q, omega=omega, inv_m=field.mod_inverse(m, q), r=r, c=c,
            plan_r=NttPlan.create(r, q, field.mod_pow(omega, c, q), device=device),
            plan_c=NttPlan.create(c, q, field.mod_pow(omega, r, q), device=device),
            pw=power_table(omega, m, q, device),
            pw_inv=power_table(field.mod_inverse(omega, q), m, q, device),
        )


def _four_step_plain(plan: NttLargePlan, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The four steps over ``ops.ntt``; the inverse sub-transforms' 1/R and
    1/C make the 1/m."""
    rows, r, c, q = x.shape[0], plan.r, plan.c, plan.q
    sub = ntt_inverse if inverse else ntt_forward
    a = sub(plan.plan_r, x.reshape(rows, r, c).transpose(1, 2))  # (B, C, R)
    h = torch.arange(r, device=x.device)
    b = torch.arange(c, device=x.device)
    pw = plan.pw_inv if inverse else plan.pw
    twiddle = pw[(b[:, None] * h[None, :]) % plan.m]  # (C, R): omega^(+-h b)
    f = sub(plan.plan_c, modarith.mul_mod(a, twiddle, q).transpose(1, 2))
    return f.transpose(1, 2).reshape(rows, plan.m)


def _plain(plan, x, inverse, pre, post, scale):
    if pre is not None:
        x = modarith.mul_mod(x, pre, plan.q)
    out = _four_step_plain(plan, x, inverse)  # the inverse's 1/m included
    if post is not None:
        out = modarith.mul_mod(out, post, plan.q)
    extra = scale * plan.m % plan.q if inverse else scale
    return out if extra == 1 else modarith.mul_mod(out, extra, plan.q)


def ntt_forward_large_plain(plan: NttLargePlan, x, pre=None, post=None) -> torch.Tensor:
    """The same function as ``ntt_forward_large``, in four steps over ``ops.ntt``."""
    return _plain(plan, x, False, pre, post, 1)


def ntt_inverse_large_plain(plan: NttLargePlan, x, pre=None, post=None,
                            scale=None) -> torch.Tensor:
    """The same function as ``ntt_inverse_large``, in four steps over ``ops.ntt``."""
    return _plain(plan, x, True, pre, post, plan.inv_m if scale is None else scale % plan.q)


def _check_table(plan: NttLargePlan, t: Optional[torch.Tensor]) -> None:
    if t is not None and (t.dtype != torch.int64 or tuple(t.shape) != (plan.m,)
                          or t.device != plan.pw.device or not t.is_contiguous()):
        raise ValueError(f"pre/post must be contiguous ({plan.m},) int64 words "
                         "on the plan's device")


def _four_step(plan: NttLargePlan, x, inverse: bool, pre, post, scale: int) -> torch.Tensor:
    """``scale``: 1 for the forward, the factor of every output word for
    the inverse."""
    check_rows(x, plan.m, plan.pw.device)
    _check_table(plan, pre)
    _check_table(plan, post)
    if x.device.type == "cpu":
        return _plain(plan, x, inverse, pre, post, scale)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    tmp = torch.empty_like(x)
    tw_r = plan.plan_r.tw_inv if inverse else plan.plan_r.tw
    tw_c = plan.plan_c.tw_inv if inverse else plan.plan_c.tw
    pw = plan.pw_inv if inverse else plan.pw
    fn = kernels.load("ntt").ntt_four_step
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), tmp.data_ptr(), out.data_ptr(), tw_r.data_ptr(), tw_c.data_ptr(),
                pw.data_ptr(), None if pre is None else pre.data_ptr(),
                None if post is None else post.data_ptr(), scale,
                plan.q, plan.r.bit_length() - 1, plan.c.bit_length() - 1, x.shape[0],
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "kernel T (four-step NTT)")
    kernels.count("ntt_four_step", 2, x.shape,  # pass 1 and pass 2
                  f"{'inverse' if inverse else 'forward'} mod {plan.q}")
    return out


def ntt_forward_large(plan: NttLargePlan, x, pre=None, post=None) -> torch.Tensor:
    """(B, m) int64 words -> post o NTT(pre o x) per row, natural order."""
    return _four_step(plan, x, False, pre, post, 1)


def ntt_inverse_large(plan: NttLargePlan, x, pre=None, post=None, scale=None) -> torch.Tensor:
    """(B, m) int64 words -> scale post o iNTT'(pre o x) per row, where
    iNTT' is the transform with omega^-1 and scale is 1/m unless given."""
    return _four_step(plan, x, True, pre, post, plan.inv_m if scale is None else scale % plan.q)

