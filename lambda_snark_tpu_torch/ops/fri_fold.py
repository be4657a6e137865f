"""The FRI fold: kernel F (``csrc/fri.cu``) and its plain PyTorch twins.

One fold layer over Goldilocks, (S, n) codewords on the coset
off <om> -> (S, n/2) on off^2 <om^2>:

    v'[i] = ((lo + hi) + c (lo - hi) / x_i) / 2,  lo = v[i], hi = v[i + n/2]

with 1/x_i = inv(off) inv(om)^i from the caller's table and one challenge
c per row. Kernel F is the counterpart of the JAX package's ``_fold_fn``
(lambda_snark_tpu/proof/fri_device.py:203) and of a layer of its chain
(``_chain_fn``, :820-842), XLA device functions, not Pallas kernels.

- ``fold`` takes the challenges as a device tensor (kind 9's per-layer
  route, whose challenges come from the host transcripts);
- ``fold_squeeze`` draws them in the same launch, as the chain does: per
  row it absorbs the last layer's root into the transcript state (from the
  second layer on), squeezes ``fri-fold`` at the chain's counter, reduces
  the digest's first word mod p and folds; it returns the new states.

Both launch the kernel for CUDA tensors and run their twins (torch ops on
the words of ``ops.modarith`` and kernel S's twins) for CPU tensors.
``fold`` runs a word a thread; ``fold_squeeze`` spreads a row over
``kernels.fold_grid`` blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import kernels
from . import keccak, modarith

P = modarith.GOLDILOCKS
INV2 = (P + 1) // 2
FOLD_LABEL = b"fri-fold"
ROOT_LABEL = b"fri-layer-root"


def fold_plain(cur: torch.Tensor, inv_x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    half = cur.shape[1] // 2
    lo, hi = cur[:, :half], cur[:, half:]
    t = modarith.mul_mod(modarith.mul_mod(cs[:, None], modarith.sub_mod(lo, hi, P), P), inv_x, P)
    return modarith.mul_mod(modarith.add_mod(modarith.add_mod(lo, hi, P), t, P), INV2, P)


def fold_squeeze_plain(cur: torch.Tensor, inv_x: torch.Tensor, state: torch.Tensor,
                       counter: int, root: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    if root is not None:
        state = keccak.transcript_absorb_plain(state, ROOT_LABEL, root)
    state, cs = keccak.transcript_squeeze_plain(state, FOLD_LABEL, counter, 1)
    return fold_plain(cur, inv_x, cs[:, 0]), state


def _check_fold(cur: torch.Tensor, inv_x: torch.Tensor, rows) -> Tuple[int, int]:
    """(S, n) of cur once the table and the per-row inputs ``rows``, (tensor,
    trailing shape) pairs, fit it."""
    if cur.dim() != 2 or cur.shape[1] < 2 or cur.shape[1] & (cur.shape[1] - 1):
        raise ValueError(f"fold: expected (S, n) words, n a power of two, got {tuple(cur.shape)}")
    s, n = cur.shape
    if inv_x.shape != (n // 2,) or any(tuple(x.shape) != (s, *tail) for x, tail in rows):
        raise ValueError(f"fold: table {tuple(inv_x.shape)} and "
                         f"{[tuple(x.shape) for x, _ in rows]} do not fit ({s}, {n})")
    for x in (cur, inv_x, *(x for x, _ in rows)):
        if x.dtype != torch.int64 or x.device != cur.device or not x.is_contiguous():
            raise ValueError("fold: contiguous int64 words on one device")
    return s, n


def fold(cur: torch.Tensor, inv_x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """(S, n) canonical words, the n/2-word 1/x table and S challenges ->
    the folded (S, n/2) words; n a power of two >= 2."""
    s, n = _check_fold(cur, inv_x, [(cs, ())])
    if cur.device.type == "cpu":
        return fold_plain(cur, inv_x, cs)
    out = torch.empty((s, n // 2), dtype=torch.int64, device=cur.device)
    rc = kernels.launch(cur.device, kernels.load("fri").fri_fold, cur.data_ptr(),
                        inv_x.data_ptr(), cs.data_ptr(), out.data_ptr(), s, n.bit_length() - 2)
    kernels.check(rc, "kernel F (fri_fold)")
    kernels.count("fri_fold", 1, cur.shape)
    return out


def fold_squeeze(cur: torch.Tensor, inv_x: torch.Tensor, state: torch.Tensor, counter: int,
                 root: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer of the FRI chain: the transcript states (S, 4) absorb
    ``fri-layer-root`` || root (root (S, 4) digest words, if given), squeeze
    ``fri-fold`` || LE64(counter), and fold (S, n) words with the reduced
    digests as the challenges. Returns (the folded (S, n/2), the new
    states), as ``fold_squeeze_plain``."""
    s, n = _check_fold(cur, inv_x, [(state, (4,))] + ([] if root is None else [(root, (4,))]))
    if cur.device.type == "cpu":
        return fold_squeeze_plain(cur, inv_x, state, counter, root)
    lanes, lane, shift = keccak.squeeze_lanes(FOLD_LABEL)
    lo, hi = keccak.label_lanes(ROOT_LABEL)
    out = torch.empty((s, n // 2), dtype=torch.int64, device=cur.device)
    new = torch.empty_like(state)
    rc = kernels.launch(cur.device, kernels.load("fri").fri_fold_squeeze, cur.data_ptr(),
                        inv_x.data_ptr(), state.data_ptr(),
                        0 if root is None else root.data_ptr(), new.data_ptr(), out.data_ptr(),
                        s, n.bit_length() - 2, kernels.fold_grid(s, n // 2), lo, hi,
                        len(ROOT_LABEL), lanes.ctypes.data, lane, shift, counter)
    kernels.check(rc, "kernel F (fri_fold_squeeze)")
    kernels.count("fri_fold_squeeze", 1, cur.shape, "root" if root is not None else "")
    return out, new
