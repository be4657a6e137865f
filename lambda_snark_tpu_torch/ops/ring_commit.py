"""The Goldilocks ring commitment: kernel R (``csrc/ring_commit.cu``) and its
plain PyTorch twin.

    c = iNTT( sum_j A_hat_j o NTT(psi-twist s_j) ) psi^-t / n + e + msg

over R = Z_p[X]/(X^n + 1), p = 2^64 - 2^32 + 1, for explicit small signed
randomness s (k, B, n) and e (B, n) int32, and messages msg (B, L) int64
words with L <= n (zero beyond L). Kernel R replaces the TPU kernels
``commit_batch_mxu`` (ops/ring_mxu.py:229) and ``fused_commit``
(ops/ring_pallas.py:230). ``ring_commit`` launches it for CUDA tensors and
runs ``ring_commit_plain`` for CPU tensors. Kernel R keeps a row in the
shared memory of a cluster of ``kernels.cluster_size`` blocks, up to
n = 2^16 in one launch; a larger ring takes the long route on the card
(``ring_commit_long``): kernel R's elementwise entries ``ring_twist``,
``ring_accumulate`` and ``ring_finish`` around kernel T's four-step, with
the untwist psi^-t / n folded into the inverse's store.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import kernels
from . import modarith
from .ntt import NttPlan, bitrev, ntt_forward_negacyclic, ntt_inverse_negacyclic, stage_index
from .ntt_large import ntt_forward_large, ntt_inverse_large

P = modarith.GOLDILOCKS


@dataclasses.dataclass(frozen=True, eq=False)
class RingCommitPlan:
    n: int
    k: int
    ntt: NttPlan  # Goldilocks negacyclic plan of degree n
    a_hat: torch.Tensor  # (k, n) A_hat words, natural NTT order
    a_hat_rev: torch.Tensor  # (k, n) the same, bit-reversed
    tw_stage: torch.Tensor  # (n,) the ring NTT's twiddles in stage-major order (kernel R)
    tw_inv_stage: torch.Tensor  # (n,) the inverse's

    @staticmethod
    def create(a_hat: np.ndarray, ntt: NttPlan) -> "RingCommitPlan":
        k, n = a_hat.shape
        dev = ntt.tw.device
        words = modarith.to_words(a_hat, dev)
        stages = stage_index(n).to(dev)
        return RingCommitPlan(
            n=n, k=k, ntt=ntt, a_hat=words,
            a_hat_rev=words.index_select(1, bitrev(n).to(dev)).contiguous(),
            tw_stage=ntt.tw.index_select(0, stages),
            tw_inv_stage=ntt.tw_inv.index_select(0, stages),
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


def _check(plan: RingCommitPlan, x, what: str, dtype, shape) -> None:
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{what} must be {shape} {dtype}, got {x.dtype} {tuple(x.shape)}")
    if x.device != plan.a_hat.device:
        raise ValueError(f"{what} must lie on the plan's device")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _check_tail(plan: RingCommitPlan, e, msg) -> None:
    """e (B, n) int32 and msg (B, L <= n) int64 words, B = e's rows."""
    rows = e.shape[0] if e.dim() == 2 else -1
    _check(plan, e, "e", torch.int32, (rows, plan.n))
    length = msg.shape[1] if msg.dim() == 2 else -1
    _check(plan, msg, "msg", torch.int64, (rows, min(length, plan.n)))


def _check_inputs(plan: RingCommitPlan, s, e, msg) -> None:
    _check_tail(plan, e, msg)
    _check(plan, s, "s", torch.int32, (plan.k, e.shape[0], plan.n))


def ring_commit(plan: RingCommitPlan, s, e, msg):
    """Commitment words (B, n) int64 for s (k, B, n), e (B, n) int32 and msg (B, L)."""
    _check_inputs(plan, s, e, msg)
    if s.device.type == "cpu":
        return ring_commit_plain(plan, s, e, msg)
    if s.device.type != "cuda":
        raise ValueError(f"unsupported device {s.device}")
    rows, log_n = e.shape[0], plan.n.bit_length() - 1
    cluster = kernels.cluster_size(rows, plan.n, 2 * plan.n)
    if cluster is None:
        return ring_commit_long(plan, s, e, msg)
    out = torch.empty((rows, plan.n), dtype=torch.int64, device=s.device)
    if rows == 0:
        return out
    fn = kernels.load("ring_commit").ring_commit_goldilocks
    rc = kernels.launch(s.device, fn, s.data_ptr(), e.data_ptr(), msg.data_ptr(), msg.shape[1],
                        plan.a_hat_rev.data_ptr(), plan.ntt.psi_pows.data_ptr(),
                        plan.ntt.psi_inv_n.data_ptr(), plan.tw_stage.data_ptr(),
                        plan.tw_inv_stage.data_ptr(), out.data_ptr(), rows, plan.k, log_n, cluster)
    kernels.check(rc, f"kernel R (ring commit, clusters of {cluster} blocks)")
    kernels.count("ring_commit_goldilocks", 1, e.shape, f"cluster {cluster}")
    return out


def _launch(entry: str, *args) -> None:
    fn = getattr(kernels.load("ring_commit"), entry)
    with torch.cuda.device(args[0].device):
        rc = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, f"kernel R ({entry})")
    kernels.count(entry, 1, args[0].shape)


def ring_twist_plain(plan: RingCommitPlan, s) -> torch.Tensor:
    return modarith.mul_mod(embed_signed(s), plan.ntt.psi_pows, P)


def ring_twist(plan: RingCommitPlan, s) -> torch.Tensor:
    """(k, B, n) small signed int32 -> their Z_p words times psi^t."""
    _check(plan, s, "s", torch.int32, (plan.k, s.shape[1] if s.dim() == 3 else -1, plan.n))
    if s.device.type == "cpu":
        return ring_twist_plain(plan, s)
    out = torch.empty(s.shape, dtype=torch.int64, device=s.device)
    _launch("ring_twist", s, plan.ntt.psi_pows, out, s.numel() // plan.n,
            plan.n.bit_length() - 1)
    return out


def ring_accumulate_plain(plan: RingCommitPlan, s_hat) -> torch.Tensor:
    acc = modarith.mul_mod(s_hat[0], plan.a_hat[0], P)
    for j in range(1, plan.k):
        acc = modarith.add_mod(acc, modarith.mul_mod(s_hat[j], plan.a_hat[j], P), P)
    return acc


def ring_accumulate(plan: RingCommitPlan, s_hat) -> torch.Tensor:
    """(k, B, n) NTT-domain words -> sum_j A_hat_j o s_hat_j, (B, n)."""
    _check(plan, s_hat, "s_hat", torch.int64,
           (plan.k, s_hat.shape[1] if s_hat.dim() == 3 else -1, plan.n))
    if s_hat.device.type == "cpu":
        return ring_accumulate_plain(plan, s_hat)
    rows = s_hat.shape[1]
    out = torch.empty((rows, plan.n), dtype=torch.int64, device=s_hat.device)
    _launch("ring_accumulate", s_hat, plan.a_hat, out, rows, plan.k, plan.n.bit_length() - 1)
    return out


def ring_finish_plain(plan: RingCommitPlan, x, e, msg) -> torch.Tensor:
    c = modarith.add_mod(x, embed_signed(e), P)
    length = msg.shape[1]
    return torch.cat([modarith.add_mod(c[:, :length], msg, P), c[:, length:]], dim=1)


def ring_finish(plan: RingCommitPlan, x, e, msg) -> torch.Tensor:
    """x (B, n) + embedded e (B, n) + msg (B, L), zero past L."""
    _check_tail(plan, e, msg)
    _check(plan, x, "x", torch.int64, tuple(e.shape))
    if x.device.type == "cpu":
        return ring_finish_plain(plan, x, e, msg)
    out = torch.empty_like(x)
    _launch("ring_finish", x, e, msg, msg.shape[1], out, x.shape[0], plan.n.bit_length() - 1)
    return out


def ring_commit_long(plan: RingCommitPlan, s, e, msg) -> torch.Tensor:
    """The long route (n > 2^16): twist, forward four-step of the k B rows,
    the A_hat accumulation, the inverse four-step with psi^-t / n in its
    store, + e + msg. The card runs it from ``ring_commit``; on CPU tensors
    every step is its plain twin."""
    k, rows, n = s.shape
    large = plan.ntt.large
    s_hat = ntt_forward_large(large, ring_twist(plan, s).reshape(k * rows, n))
    acc = ring_accumulate(plan, s_hat.reshape(k, rows, n))
    x = ntt_inverse_large(large, acc, post=plan.ntt.psi_inv_n, scale=1)  # psi_inv_n has 1/n
    return ring_finish(plan, x, e, msg)
