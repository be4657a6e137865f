"""The FRI fold: kernel F (``csrc/fri.cu``) and its plain PyTorch twin.

One fold layer over Goldilocks, (S, n) codewords on the coset
off <om> -> (S, n/2) on off^2 <om^2>:

    v'[i] = ((lo + hi) + c (lo - hi) / x_i) / 2,  lo = v[i], hi = v[i + n/2]

with 1/x_i = inv(off) inv(om)^i from the caller's table and one challenge
c per row. Kernel F is the counterpart of the JAX package's ``_fold_fn``
(lambda_snark_tpu/proof/fri_device.py:203) and of the fold inside its
chain (``_chain_fn``, :782), XLA device functions, not Pallas kernels.
``fold`` launches it for CUDA tensors and runs ``fold_plain`` (torch ops
on the words of ``ops.modarith``) for CPU tensors. The challenges are a
device tensor either way: in the chain they are kernel S's output and
never pass through the host.
"""

from __future__ import annotations

import torch

from .. import kernels
from . import modarith

P = modarith.GOLDILOCKS
INV2 = (P + 1) // 2


def fold_plain(cur: torch.Tensor, inv_x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    half = cur.shape[1] // 2
    lo, hi = cur[:, :half], cur[:, half:]
    t = modarith.mul_mod(modarith.mul_mod(cs[:, None], modarith.sub_mod(lo, hi, P), P), inv_x, P)
    return modarith.mul_mod(modarith.add_mod(modarith.add_mod(lo, hi, P), t, P), INV2, P)


def fold(cur: torch.Tensor, inv_x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """(S, n) canonical words, the n/2-word 1/x table and S challenges ->
    the folded (S, n/2) words; n a power of two >= 2."""
    if cur.dim() != 2 or cur.shape[1] < 2 or cur.shape[1] & (cur.shape[1] - 1):
        raise ValueError(f"fold: expected (S, n) words, n a power of two, got {tuple(cur.shape)}")
    s, n = cur.shape
    if inv_x.shape != (n // 2,) or cs.shape != (s,):
        raise ValueError(f"fold: table {tuple(inv_x.shape)} and challenges {tuple(cs.shape)} "
                         f"do not fit ({s}, {n})")
    for x in (cur, inv_x, cs):
        if x.dtype != torch.int64 or x.device != cur.device or not x.is_contiguous():
            raise ValueError("fold: contiguous int64 words on one device")
    if cur.device.type == "cpu":
        return fold_plain(cur, inv_x, cs)
    out = torch.empty((s, n // 2), dtype=torch.int64, device=cur.device)
    rc = kernels.launch(cur.device, kernels.load("fri").fri_fold, cur.data_ptr(),
                        inv_x.data_ptr(), cs.data_ptr(), out.data_ptr(), s,
                        n.bit_length() - 2)
    kernels.check(rc, "kernel F (fri_fold)")
    kernels.count("fri_fold", 1, cur.shape)
    return out
