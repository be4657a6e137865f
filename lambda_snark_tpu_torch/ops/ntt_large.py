"""The batched Goldilocks cyclic NTT for large m: kernel N
(``csrc/ntt_goldilocks.cu``) and its plain four-step twin.

``ntt_forward_large(plan, x)`` maps rows x (B, m) of int64 words to
X_k = sum_t x_t omega^(t k) in natural order, for m = R C up to 2^20, any
primitive m-th root omega (the plan's). Four steps, as the JAX package's
``ops/ntt_large.py``: R-point NTTs down the columns of x viewed as (R, C),
the twiddle omega^(h b), C-point NTTs along the rows, and the transposed
read-out out[h + R g]. ``dft_rows(plan, x)`` is the leaf on its own: a
length-B DFT of every row of x (M, B), B <= 8192.

Kernel N replaces the TPU kernels ``ntt_forward_mxu_packed``
(ops/ntt_mxu.py:631) and its leaf ``dft_matmul_apply_pallas``
(ops/ntt_mxu.py:378); it runs the kind-7 LDE, and its leaf runs the
inverse transform of FRI's final polynomial (``proof.fri_device``). The wrappers launch it for
CUDA tensors and take the ``*_plain`` twins (built on ``ops.ntt``) for CPU
tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import kernels
from ..core import field
from . import modarith
from .ntt import NttPlan, ntt_forward, powers

P = modarith.GOLDILOCKS
_MAX_LOG_M = 20
_MAX_LOG_LEAF = 13  # one sub-transform fills kernel N's 64 KiB tile
MAX_LEAF_LEN = 1 << _MAX_LOG_LEAF


@dataclasses.dataclass(frozen=True, eq=False)
class NttLargePlan:
    """Tables for the m-point transform with root omega on one device."""

    m: int
    omega: int
    r: int
    c: int
    plan_r: NttPlan  # root omega^C, order R
    plan_c: NttPlan  # root omega^R, order C
    pw: torch.Tensor  # (m,) omega^e

    @staticmethod
    def create(m: int, omega: int, device="cpu") -> "NttLargePlan":
        log_m = m.bit_length() - 1
        if m != 1 << log_m or not 2 <= log_m <= _MAX_LOG_M:
            raise ValueError(f"m = {m} must be a power of two in [4, 2^{_MAX_LOG_M}]")
        if field.mod_pow(omega, m // 2, P) != P - 1:
            raise ValueError(f"omega is not a primitive {m}-th root of unity")
        r = 1 << (log_m // 2)
        c = m // r
        return NttLargePlan(
            m=m, omega=omega, r=r, c=c,
            plan_r=NttPlan.create(r, P, field.mod_pow(omega, c, P), device=device),
            plan_c=NttPlan.create(c, P, field.mod_pow(omega, r, P), device=device),
            pw=modarith.to_words(powers(omega, m, P), device),
        )


def ntt_forward_large_plain(plan: NttLargePlan, x: torch.Tensor) -> torch.Tensor:
    """The same function as kernel N, in four steps over ``ops.ntt``."""
    rows, r, c = x.shape[0], plan.r, plan.c
    a = ntt_forward(plan.plan_r, x.reshape(rows, r, c).transpose(1, 2))  # (B, C, R)
    h = torch.arange(r, device=x.device)
    b = torch.arange(c, device=x.device)
    twiddle = plan.pw[(b[:, None] * h[None, :]) % plan.m]  # (C, R): omega^(h b)
    f = ntt_forward(plan.plan_c, modarith.mul_mod(a, twiddle, P).transpose(1, 2))
    return f.transpose(1, 2).reshape(rows, plan.m)


def _check(x: torch.Tensor, width: int, device) -> None:
    if x.dtype != torch.int64 or x.dim() != 2 or x.shape[1] != width:
        raise ValueError(f"expected (B, {width}) int64 words, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("input must be contiguous")
    if x.device != device:
        raise ValueError("input must lie on the plan's device")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def ntt_forward_large(plan: NttLargePlan, x: torch.Tensor) -> torch.Tensor:
    """(B, m) int64 words -> their m-point NTTs, natural order."""
    _check(x, plan.m, plan.pw.device)
    if x.device.type == "cpu":
        return ntt_forward_large_plain(plan, x)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    tmp = torch.empty_like(x)
    fn = kernels.load("ntt_goldilocks").ntt_goldilocks_forward
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), tmp.data_ptr(), out.data_ptr(), plan.plan_r.tw.data_ptr(),
                plan.plan_c.tw.data_ptr(), plan.pw.data_ptr(), plan.r.bit_length() - 1,
                plan.c.bit_length() - 1, x.shape[0], torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "kernel N (four-step NTT)")
    kernels.LAUNCHES["ntt_goldilocks_forward"] += 2  # pass 1 and pass 2
    return out


def dft_plan(b: int, omega: int, device="cpu") -> NttPlan:
    """The leaf's plan: length b <= 8192, root omega of order b."""
    if b < 2 or b & (b - 1) or b > 1 << _MAX_LOG_LEAF:
        raise ValueError(f"leaf length {b} must be a power of two in [2, 2^{_MAX_LOG_LEAF}]")
    return NttPlan.create(b, P, omega, device=device)


def dft_rows_plain(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    return ntt_forward(plan, x)


def dft_rows(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """(M, b) int64 words -> the length-b DFT of every row (kernel N's leaf)."""
    if plan.q != P:
        raise ValueError("kernel N is the Goldilocks transform")
    _check(x, plan.m, plan.tw.device)
    if x.device.type == "cpu":
        return dft_rows_plain(plan, x)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    fn = kernels.load("ntt_goldilocks").ntt_goldilocks_rows
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), out.data_ptr(), plan.tw.data_ptr(), plan.m.bit_length() - 1,
                x.shape[0], torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "kernel N (DFT rows)")
    kernels.LAUNCHES["ntt_goldilocks_rows"] += 1
    return out
