"""Sharded four-step NTT: local transforms on kernel T and all_to_all
transposes over one mesh axis.

The counterpart of the JAX package's ``parallel/ntt_sharded.py``
(``_local_forward`` / ``_local_inverse`` :42-80, ``ShardedNtt`` :82-172).
The coefficients of an m = R C transform lie row-major as an (R, C)
matrix whose R rows are split over the N ranks of the axis; rank i holds
rows [i R/N, (i + 1) R/N). Per rank, on (B, rows, C) int64 words (one word
an element, where JAX carries a digit axis in front):

    coeff layout (B, R/N, C)
      --all_to_all-->  (B, C/N, R)   full columns, a C/N column block
      --R-point NTTs-> A_t[b, h]
      --twiddle omega^(h b) (the rank's rows of the transposed table)
      --all_to_all-->  (B, R/N, C)   an h block, every b
      --C-point NTTs-> eval layout F[h, g] = f_hat[h + R g]

and the inverse backwards; exactly two all_to_alls a transform. The local
transforms are kernel T's row entry (``ops.ntt_batched``) on CUDA tensors
and its plain twin on CPU tensors: the port's counterpart of the
``ops/ntt_jax`` transforms JAX's sharded code calls. The (R, C) split is
JAX's, R = 2^floor(log2 m / 2) (``ops/ntt_large.py:69-71``), which the
two-pass ``ops.ntt_large.NttLargePlan`` also takes, so the raw eval layouts
equal JAX's and not only the natural order.

``torch.distributed.all_to_all_single`` exchanges blocks of dim 0, so each
exchange views (B, X, Y) as (B, X, N, Y/N), brings the N axis to the
front, exchanges, and lays the received blocks side by side along the
transform axis: (B, Y/N, N X) (``exchange``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import modarith
from ..ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
from ..ops.ntt_large import NttLargePlan
from .mesh import mesh_device, shard_rows


def exchange(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The transposing all_to_all of (B, X, Y) blocks over ``group`` of n
    ranks: block k of Y goes to rank k, and the X blocks that come back,
    rank k's at [k X, (k + 1) X), give (B, Y/N, N X)."""
    b, rows, cols = x.shape
    send = x.reshape(b, rows, n, cols // n).permute(2, 0, 1, 3).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return recv.permute(1, 3, 0, 2).reshape(b, cols // n, n * rows).contiguous()


def _rows(fn, plan, x: torch.Tensor) -> torch.Tensor:
    """A transform of every row of (B, X, S) words along S."""
    return fn(plan, x.reshape(-1, x.shape[-1])).reshape(x.shape)


class LocalFourStep:
    """One rank's half of an m-point four-step over an axis of n ranks:
    the leaf plans, the rank's (C/N, R) rows of the transposed twiddle
    tables, and ``forward`` / ``inverse`` on (B, R/N, C) blocks."""

    def __init__(self, m: int, q: int, omega: int, group, n: int, index: int, device) -> None:
        self.plan = NttLargePlan.create(m, omega, device, q)
        if self.plan.plan_c is None:
            raise ValueError(f"m = {m} is past the two-pass four-step")
        r, c = self.plan.r, self.plan.c
        if r % n or c % n:
            raise ValueError(f"R={r}, C={c} must be divisible by the axis size {n}")
        self.m, self.q, self.r, self.c = m, q, r, c
        self.group, self.n, self.index = group, n, index
        # transposed twiddles tw_t[b, h] = omega^(h b): the store-order table
        # (omega^(h b) at h C + b) viewed (R, C) and transposed; rank i reads
        # rows [i C/N, (i + 1) C/N)
        block = slice(index * c // n, (index + 1) * c // n)
        self.tw = self.plan.pw.reshape(r, c).t()[block].contiguous()
        self.tw_inv = self.plan.pw_inv.reshape(r, c).t()[block].contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, R/N, C) coefficient layout -> (B, R/N, C) eval layout."""
        p = self.plan
        a_t = _rows(ntt_forward_batched, p.plan_r, exchange(x, self.group, self.n))
        t_t = modarith.mul_mod(a_t, self.tw, self.q)
        return _rows(ntt_forward_batched, p.plan_c, exchange(t_t, self.group, self.n))

    def inverse(self, f: torch.Tensor) -> torch.Tensor:
        """(B, R/N, C) eval layout -> (B, R/N, C) coefficient layout."""
        p = self.plan
        t_t = exchange(_rows(ntt_inverse_batched, p.plan_c, f), self.group, self.n)
        a_t = modarith.mul_mod(t_t, self.tw_inv, self.q)
        return exchange(_rows(ntt_inverse_batched, p.plan_r, a_t), self.group, self.n)


def gather_rows(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """The axis's blocks (..., R/N, C) of every rank, in rank order along
    the rows: (..., R, C)."""
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-2)


class ShardedNtt:
    """m-point NTT over mesh axis ``axis``, on this rank's blocks.

    Inputs and outputs are (..., R/N, C) blocks of words on the mesh's
    device: rank i of the axis holds rows [i R/N, (i + 1) R/N) of the
    coefficient layout (``coeff_to_device``) or of the eval layout, whose
    flattening is the coefficient vector or the evaluations in the order
    ``eval_layout_to_natural`` undoes. Every rank of the axis calls every
    method that exchanges (``forward``, ``inverse``, the ``*_natural`` /
    ``*_from_device`` readers)."""

    def __init__(self, m: int, q: int, omega: int, mesh, axis: str = "sp") -> None:
        self.m, self.q, self.omega = m, q, omega
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)
        self.n_dev = mesh.size(mesh.mesh_dim_names.index(axis))
        self.index = mesh.get_local_rank(axis)
        self.device = mesh_device(mesh)
        self.local = LocalFourStep(m, q, omega, self.group, self.n_dev, self.index, self.device)
        self.r, self.c = self.local.r, self.local.c

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        return shard_rows(x, self.mesh, self.axis, -2).contiguous()

    def _words(self, values) -> torch.Tensor:
        if isinstance(values, torch.Tensor):
            return values.to(self.device)
        return modarith.to_words(values, self.device)

    def _lead(self, x: torch.Tensor, fn) -> torch.Tensor:
        y = fn(x.reshape((-1,) + x.shape[-2:]))
        return y.reshape(x.shape[:-2] + y.shape[-2:])

    # -- host-facing helpers ----------------------------------------------------

    def coeff_to_device(self, values) -> torch.Tensor:
        """(..., m) coefficients -> this rank's (..., R/N, C) block."""
        x = self._words(values)
        return self._block(x.reshape(x.shape[:-1] + (self.r, self.c)))

    def tw_device(self, inverse: bool = False) -> torch.Tensor:
        """This rank's (C/N, R) rows of the transposed twiddle table."""
        return self.local.tw_inv if inverse else self.local.tw

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Coefficient layout -> eval layout (this rank's blocks)."""
        return self._lead(x, self.local.forward)

    def inverse(self, f: torch.Tensor) -> torch.Tensor:
        """Eval layout -> coefficient layout (this rank's blocks)."""
        return self._lead(f, self.local.inverse)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of the axis: (..., R, C)."""
        return self._lead(x, lambda v: gather_rows(v, self.group, self.n_dev))

    def eval_layout_to_natural(self, f: torch.Tensor) -> torch.Tensor:
        """This rank's eval-layout block -> the natural-order evaluations
        (..., m), f_hat[h + R g] = F[h, g]."""
        full = self.gather(f)
        return full.transpose(-1, -2).reshape(full.shape[:-2] + (self.m,))

    def natural_to_eval_layout(self, evals) -> torch.Tensor:
        """(..., m) natural-order evaluations -> this rank's eval-layout block."""
        x = self._words(evals)
        lay = x.reshape(x.shape[:-1] + (self.c, self.r)).transpose(-1, -2)
        return self._block(lay)

    def coeff_from_device(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's coefficient block -> the coefficients (..., m)."""
        full = self.gather(x)
        return full.reshape(full.shape[:-2] + (self.m,))

    def pointwise_mul(self, fa: torch.Tensor, fb: torch.Tensor) -> torch.Tensor:
        """The product of two eval-layout blocks (no communication)."""
        return modarith.mul_mod(fa, fb, self.q)

