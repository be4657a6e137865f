"""Batched cyclic and negacyclic NTTs on 64-bit words, in plain PyTorch.

The counterpart of the JAX package's ``ops/ntt_jax.py``: radix-2
decimation-in-time over the last axis (bit-reversal gather first), any
leading batch axes, with the same outputs for the same inputs. The
negacyclic (X^m + 1) forward transform twists by psi^i first; its inverse
folds 1/m into the psi^-i untwist.

The plan's tables are also what the CUDA kernels read: ``tw``/``tw_inv`` hold
omega^e and omega^-e for e < m/2, and every stage takes its twiddles from
them with a stride.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..core import field
from . import modarith


def bitrev(m: int) -> torch.Tensor:
    """The bit-reversal permutation of range(m) (m a power of two)."""
    bits = m.bit_length() - 1
    idx = torch.arange(m, dtype=torch.int64)
    rev = torch.zeros(m, dtype=torch.int64)
    for _ in range(bits):
        rev = (rev << 1) | (idx & 1)
        idx = idx >> 1
    return rev


def stage_index(n: int) -> torch.Tensor:
    """Where the twiddles of an n-point transform's radix-2 stages sit in a
    table of omega^e (e < n/2): entry 2^s + j of the stage-major order
    (kernels Q and R read it, ``csrc/butterfly.cuh``) is stage s's twiddle
    at j, omega^(j n / 2^(s+1)), at index j << (log2 n - 1 - s); entry 0 is
    unused and points at omega^0."""
    log_n = n.bit_length() - 1
    idx = [0] + [j << (log_n - 1 - s) for s in range(log_n) for j in range(1 << s)]
    return torch.tensor(idx, dtype=torch.int64)


def powers(base: int, count: int, q: int, scale: int = 1) -> list:
    """[scale * base^i mod q for i < count] as Python ints."""
    out = []
    acc = scale % q
    for _ in range(count):
        out.append(acc)
        acc = acc * base % q
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class NttPlan:
    """Tables for a fixed (m, q, omega[, psi]) transform on one device."""

    m: int
    q: int
    omega: int
    inv_m: int
    rev: torch.Tensor  # (m,) bit-reversal gather indices
    tw: torch.Tensor  # (m/2,) omega^e
    tw_inv: torch.Tensor  # (m/2,) omega^-e
    psi_pows: Optional[torch.Tensor] = None  # (m,) psi^i
    psi_inv_n: Optional[torch.Tensor] = None  # (m,) psi^-i / m

    @staticmethod
    def create(m: int, q: int, omega: int, psi: Optional[int] = None,
               device="cpu") -> "NttPlan":
        if m < 2 or m & (m - 1):
            raise ValueError(f"transform length {m} must be a power of two >= 2")
        omega_inv = field.mod_inverse(omega, q)
        inv_m = field.mod_inverse(m, q)
        words = lambda vals: modarith.to_words(vals, device)
        psi_pows = psi_inv_n = None
        if psi is not None:
            psi_pows = words(powers(psi, m, q))
            psi_inv_n = words(powers(field.mod_inverse(psi, q), m, q, scale=inv_m))
        return NttPlan(
            m=m, q=q, omega=omega, inv_m=inv_m,
            rev=bitrev(m).to(device),
            tw=words(powers(omega, m // 2, q)),
            tw_inv=words(powers(omega_inv, m // 2, q)),
            psi_pows=psi_pows, psi_inv_n=psi_inv_n,
        )

    @functools.cached_property
    def large(self):
        """The four-step plan (``ops.ntt_large.NttLargePlan``) of the same
        transform, built at first use: kernel T's route past 2^13 points,
        shared by ``ops.ntt_batched`` and the long routes of ``ops.quotient``
        and ``ops.ring_commit``."""
        from .ntt_large import NttLargePlan

        return NttLargePlan.create(self.m, self.omega, self.tw.device, q=self.q)


def _transform(plan: NttPlan, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    m, q = plan.m, plan.q
    lead = x.shape[:-1]
    x = x.index_select(-1, plan.rev)
    span = 2
    while span <= m:
        half = span // 2
        x = x.reshape(lead + (m // span, span))
        t = modarith.mul_mod(x[..., half:], tw[:: m // span], q)
        u = x[..., :half]
        x = torch.cat([modarith.add_mod(u, t, q), modarith.sub_mod(u, t, q)], dim=-1)
        span *= 2
    return x.reshape(lead + (m,))


def ntt_forward(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Cyclic forward NTT over the last axis: X_k = sum_t x_t omega^(tk)."""
    return _transform(plan, x, plan.tw)


def ntt_inverse(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Cyclic inverse NTT: forward with omega^-1, then times 1/m."""
    return modarith.mul_mod(_transform(plan, x, plan.tw_inv), plan.inv_m, plan.q)


def ntt_forward_negacyclic(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Negacyclic forward: psi-twist, then the cyclic forward NTT."""
    return _transform(plan, modarith.mul_mod(x, plan.psi_pows, plan.q), plan.tw)


def ntt_inverse_negacyclic(plan: NttPlan, x: torch.Tensor) -> torch.Tensor:
    """Negacyclic inverse: cyclic transform with omega^-1, then psi^-i / m."""
    return modarith.mul_mod(_transform(plan, x, plan.tw_inv), plan.psi_inv_n, plan.q)
