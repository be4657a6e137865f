"""The batched resident NTT: kernel T (``csrc/ntt.cu``) and its plain twin.

The counterpart of the JAX package's ``ops/ntt_pallas.py``
(``ntt_forward_pallas`` / ``ntt_inverse_pallas``, the TPU kernel at
ops/ntt_pallas.py:126): the cyclic NTT of every row of x (B, S),

    forward  X_k = sum_t x_t omega^(t k)
    inverse  x_t = S^-1 sum_k X_k omega^(-t k)

natural order in and out, for the plan's (S, q, omega) and any modulus
``ops.modarith`` supports (Goldilocks, the 44-bit field, any q < 2^47). Where
the TPU kernel takes (D, B, S) 16-bit digit planes, this takes (B, S) int64
words (``ops.modarith``'s layout) and returns the same values.

CUDA tensors launch kernel T: entry ``ntt_rows`` for S <= 2^13 (one pass:
a block takes whole rows, up to 2^12 words of them, all log2 S stages in
shared memory, 1/S folded into the store; also kernel N's leaf), the
four-step of ``ops.ntt_large`` above (the plan's ``large``). CPU tensors
run the plain twin, ``ops.ntt.ntt_forward`` / ``ntt_inverse``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from . import modarith
from .ntt import NttPlan, ntt_forward, ntt_inverse
from .ntt_large import (
    MAX_LEAF_LEN,
    Pass,
    cached_descs,
    check_rows,
    ntt_forward_large,
    ntt_inverse_large,
    pass_struct,
)


def row_pass(plan: NttPlan, rows: int, inverse: bool) -> Pass:
    """The row entry's pass over B = ``rows`` rows: one level of 2^k rows,
    2^k the largest power of two dividing B, every row an S-point
    sub-transform; the launch takes B / 2^k such row groups, and the
    kernel puts as many rows of a group in a block as its tile holds."""
    k = (rows & -rows).bit_length() - 1
    return Pass(leaf=plan, inverse=inverse, levels=((1 << k, plan.m, plan.m),), in_elem=1,
                out_elem=1, src=0, dst=2, scale=plan.inv_m if inverse else 1)


def _launch_rows(plan: NttPlan, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """Kernel T's row entry on CUDA rows x (B, S), S <= 2^13."""
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    fn = kernels.load("ntt").ntt_rows

    def build():
        p = row_pass(plan, x.shape[0], inverse)
        group = p.levels[0][0]
        return pass_struct(p, x, out, x.shape[0] // group, plan.m * group, 1)

    desc = cached_descs(plan, ("rows", inverse, x.shape[0]), build)
    desc.x, desc.y = x.data_ptr(), out.data_ptr()
    rc = kernels.launch(x.device, fn, ctypes.addressof(desc), plan.q)
    kernels.check(rc, "kernel T (row NTT)")
    kernels.count("ntt_rows", 1, x.shape, f"{'inverse' if inverse else 'forward'} mod {plan.q}")
    return out


def _batched(plan: NttPlan, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    modarith.check_modulus(plan.q)
    check_rows(x, plan.m, plan.tw.device)
    if x.device.type == "cpu":
        return (ntt_inverse if inverse else ntt_forward)(plan, x)
    if plan.m <= MAX_LEAF_LEN:
        return _launch_rows(plan, x, inverse)
    return (ntt_inverse_large if inverse else ntt_forward_large)(plan.large, x)


def ntt_forward_batched(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """(B, S) int64 words -> the cyclic forward NTT of every row."""
    return _batched(plan, x, inverse=False)


def ntt_inverse_batched(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """(B, S) int64 words -> the cyclic inverse NTT of every row (1/S included)."""
    return _batched(plan, x, inverse=True)
