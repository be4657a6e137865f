"""Modular arithmetic on 64-bit words held in ``torch.int64`` tensors.

The port keeps every residue as one 64-bit word (the JAX package splits it
into 16-bit digit planes only because the TPU has no 64-bit integers). A
Goldilocks residue (p = 2^64 - 2^32 + 1) does not fit a signed int64, so a
word is the int64 *bit pattern* of the unsigned value, and no operation here
lets a signed int64 overflow:

- a word is split into 32-bit limbs with masks (``split``/``join``); an
  arithmetic ``>>`` followed by a mask gives the right bits;
- products are formed from 16-bit digits, whose products and column sums
  stay far below 2^63 (``mul_wide``);
- unsigned order is signed order after flipping the sign bit (``ult``).

This is the plain PyTorch arithmetic behind ``ops.ntt``, the plain twins of
the CUDA kernels, the SpMV and the sampler; it replaces the JAX package's
``ops/modarith.py`` and ``ops/limb.py``. Supported moduli: the Goldilocks
prime, and any q < 2^47 (which covers the 45-bit field).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

GOLDILOCKS = 18446744069414584321  # 2^64 - 2^32 + 1
Q45 = 17592169062401  # 2^44 - 16982015
M16 = 0xFFFF
M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)
_SMALL_Q = 1 << 47  # r < q -> (r << 16) < 2^63


def to_words(values, device="cpu") -> torch.Tensor:
    """uint64 values (numpy array or sequence of ints < 2^64) -> int64 words."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return torch.from_numpy(arr.view(np.int64)).to(device)


def to_u64(words: torch.Tensor) -> np.ndarray:
    """int64 words -> numpy uint64 values (a copy on the host)."""
    return words.detach().cpu().contiguous().numpy().view(np.uint64)


def split(w: torch.Tensor):
    """A word's (hi, lo) 32-bit limbs, each in [0, 2^32)."""
    return (w >> 32) & M32, w & M32


def join(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Limbs hi, lo in [0, 2^32) -> the word hi * 2^32 + lo (as a bit pattern)."""
    hi_signed = hi - ((hi >> 31) << 32)  # in [-2^31, 2^31): no overflow below
    return hi_signed * (1 << 32) + lo


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned a < b on 64-bit words."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def mul_wide(a, b) -> List[torch.Tensor]:
    """The 128-bit product of two words as four 32-bit limbs, low first."""
    ad = [(a >> s) & M16 for s in (0, 16, 32, 48)]
    bd = [(b >> s) & M16 for s in (0, 16, 32, 48)]
    cols = [0] * 7
    for i in range(4):
        for j in range(4):
            cols[i + j] = cols[i + j] + ad[i] * bd[j]  # < 2^34 per column
    digits = []
    carry = 0
    for k in range(8):
        tot = (cols[k] if k < 7 else 0) + carry
        digits.append(tot & M16)
        carry = tot >> 16
    return [digits[2 * i] | (digits[2 * i + 1] << 16) for i in range(4)]


def check_modulus(q: int) -> None:
    if q != GOLDILOCKS and not 1 < q < _SMALL_Q:
        raise ValueError(f"unsupported modulus {q}: Goldilocks or q < 2^47 only")


def add_mod(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a + b) mod q for canonical a, b."""
    check_modulus(q)
    if q != GOLDILOCKS:
        s = a + b
        return torch.where(s >= q, s - q, s)
    ah, al = split(a)
    bh, bl = split(b)
    hi, lo = ah + bh, al + bl
    # value - p, p = (2^32 - 1) * 2^32 + 1
    dl = lo - 1
    dh = hi - M32 + (dl >> 32)
    dl = dl & M32
    ge = dh >= 0
    hi = torch.where(ge, dh, hi + (lo >> 32))
    lo = torch.where(ge, dl, lo & M32)
    return join(hi, lo)


def sub_mod(a: torch.Tensor, b: torch.Tensor, q: int) -> torch.Tensor:
    """(a - b) mod q for canonical a, b."""
    check_modulus(q)
    if q != GOLDILOCKS:
        d = a - b
        return torch.where(d < 0, d + q, d)
    ah, al = split(a)
    bh, bl = split(b)
    lo = al - bl
    hi = ah - bh + (lo >> 32)
    lo = lo & M32
    # a < b: add p
    pl = lo + 1
    ph = hi + M32 + (pl >> 32)
    neg = hi < 0
    return join(torch.where(neg, ph, hi), torch.where(neg, pl & M32, lo))


def reduce_mod(a: torch.Tensor, q: int) -> torch.Tensor:
    """The canonical residues mod q of words holding any value below 2^64
    (the JAX package's ``reduce_mod`` canonicalises values below 3q)."""
    check_modulus(q)
    hi, lo = split(a)
    zero = torch.zeros_like(lo)
    if q == GOLDILOCKS:
        return _reduce_goldilocks([lo, hi, zero, zero])
    return _reduce_small([lo, hi, zero], q)


def _reduce_goldilocks(t: Sequence[torch.Tensor]) -> torch.Tensor:
    """t0 + t1 2^32 + t2 2^64 + t3 2^96 mod p, using 2^64 = 2^32 - 1 and
    2^96 = -1: the value is (t1 + t2) 2^32 + (t0 - t2 - t3)."""
    lo = t[0] - t[2] - t[3]
    hi = t[1] + t[2]
    for _ in range(3):
        hi = hi + (lo >> 32)
        lo = lo & M32
        h1 = hi >> 32  # h1 * 2^64 = h1 * 2^32 - h1
        hi = (hi & M32) + h1
        lo = lo - h1
    hi = hi + (lo >> 32)
    lo = lo & M32
    ge = (hi == M32) & (lo >= 1)  # value >= p
    return join(torch.where(ge, torch.zeros_like(hi), hi), torch.where(ge, lo - 1, lo))


def _reduce_small(t: Sequence[torch.Tensor], q: int) -> torch.Tensor:
    """t0 + t1 2^32 + t2 2^64 mod q < 2^47 (t3 = 0), Horner in base 2^32."""
    r = t[2] % q
    for limb in (t[1], t[0]):
        r = ((r << 16) % q << 16) % q
        r = (r + limb) % q
    return r


def mul_mod(a, b, q: int) -> torch.Tensor:
    """(a * b) mod q for canonical words (or Python ints) a, b."""
    check_modulus(q)
    t = mul_wide(a, b)
    if q == GOLDILOCKS:
        return _reduce_goldilocks(t)
    return _reduce_small(t, q)
