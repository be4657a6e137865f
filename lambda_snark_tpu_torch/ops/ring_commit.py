"""The Goldilocks ring commitment: kernel R (``csrc/ring_commit.cu``) and its
plain PyTorch twin.

    c = iNTT( sum_j A_hat_j o NTT(psi-twist s_j) ) psi^-t / n + e + msg

over R = Z_p[X]/(X^n + 1), p = 2^64 - 2^32 + 1, for explicit small signed
randomness s (k, B, n) and e (B, n) int32, and messages msg (B, L) int64
words with L <= n (zero beyond L). Kernel R replaces the TPU kernels
``commit_batch_mxu`` (ops/ring_mxu.py:229) and ``fused_commit``
(ops/ring_pallas.py:230). ``ring_commit`` launches it for CUDA tensors and
runs ``ring_commit_plain`` for CPU tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from . import modarith
from .ntt import NttPlan, bitrev, ntt_forward_negacyclic, ntt_inverse_negacyclic

P = modarith.GOLDILOCKS
_MAX_LOG_N = 13


@dataclasses.dataclass(frozen=True, eq=False)
class RingCommitPlan:
    n: int
    k: int
    ntt: NttPlan  # Goldilocks negacyclic plan of degree n
    a_hat: torch.Tensor  # (k, n) A_hat words, natural NTT order
    a_hat_rev: torch.Tensor  # (k, n) the same, bit-reversed

    @staticmethod
    def create(a_hat: np.ndarray, ntt: NttPlan) -> "RingCommitPlan":
        k, n = a_hat.shape
        words = modarith.to_words(a_hat, ntt.tw.device)
        return RingCommitPlan(
            n=n, k=k, ntt=ntt, a_hat=words,
            a_hat_rev=words.index_select(1, bitrev(n).to(words.device)).contiguous(),
        )


def embed_signed(v: torch.Tensor) -> torch.Tensor:
    """Small signed ints -> canonical Z_p words (p + v for v < 0)."""
    v = v.to(torch.int64)
    return torch.where(v < 0, v + (P - (1 << 64)), v)


def ring_commit_plain(plan: RingCommitPlan, s, e, msg):
    """The same function as kernel R, from ``ops.ntt`` and ``ops.modarith``."""
    s_hat = ntt_forward_negacyclic(plan.ntt, embed_signed(s))  # (k, B, n)
    acc = None
    for j in range(plan.k):
        term = modarith.mul_mod(s_hat[j], plan.a_hat[j], P)
        acc = term if acc is None else modarith.add_mod(acc, term, P)
    c = modarith.add_mod(ntt_inverse_negacyclic(plan.ntt, acc), embed_signed(e), P)
    length = msg.shape[1]
    return torch.cat(
        [modarith.add_mod(c[:, :length], msg, P), c[:, length:]], dim=1
    )


def _check_inputs(plan: RingCommitPlan, s, e, msg) -> None:
    rows = e.shape[0] if e.dim() == 2 else -1
    if s.dtype != torch.int32 or tuple(s.shape) != (plan.k, rows, plan.n):
        raise ValueError(f"s must be ({plan.k}, B, {plan.n}) int32, got {s.dtype} {tuple(s.shape)}")
    if e.dtype != torch.int32 or tuple(e.shape) != (rows, plan.n):
        raise ValueError(f"e must be (B, {plan.n}) int32, got {e.dtype} {tuple(e.shape)}")
    if msg.dtype != torch.int64 or msg.dim() != 2 or msg.shape[0] != rows or msg.shape[1] > plan.n:
        raise ValueError(f"msg must be (B, L <= {plan.n}) int64 words, got {msg.dtype} {tuple(msg.shape)}")
    for x in (s, e, msg):
        if x.device != plan.a_hat.device:
            raise ValueError("s, e, msg must lie on the plan's device")
        if not x.is_contiguous():
            raise ValueError("inputs must be contiguous")


def ring_commit(plan: RingCommitPlan, s, e, msg):
    """Commitment words (B, n) int64 for s (k, B, n), e (B, n) int32 and msg (B, L)."""
    _check_inputs(plan, s, e, msg)
    if s.device.type == "cpu":
        return ring_commit_plain(plan, s, e, msg)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    log_n = plan.n.bit_length() - 1
    if log_n > _MAX_LOG_N:
        raise ValueError(f"kernel R takes n <= 2^{_MAX_LOG_N}, got n = {plan.n}")
    rows = e.shape[0]
    out = torch.empty((rows, plan.n), dtype=torch.int64, device=s.device)
    if rows == 0:
        return out
    fn = kernels.load("ring_commit").ring_commit_goldilocks
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(s.data_ptr(), e.data_ptr(), msg.data_ptr(), msg.shape[1],
                plan.a_hat_rev.data_ptr(), plan.ntt.psi_pows.data_ptr(),
                plan.ntt.psi_inv_n.data_ptr(), plan.ntt.tw.data_ptr(),
                plan.ntt.tw_inv.data_ptr(), out.data_ptr(), rows, plan.k, log_n, stream)
    kernels.check(rc, "kernel R (ring commit)")
    kernels.LAUNCHES["ring_commit_goldilocks"] += 1
    return out
