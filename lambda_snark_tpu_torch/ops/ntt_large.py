"""Batched cyclic NTTs past one block's tile: the four-step of kernels N and
T (``csrc/ntt.cu``, entry ``ntt_four_step``) and its plain twins.

``ntt_forward_large(plan, x)`` maps rows x (B, m) of int64 words to
X_k = sum_t x_t omega^(t k) in natural order, for any power of two m >= 4
with a primitive m-th root omega of any modulus ``ops.modarith`` supports
(the plan's); ``ntt_inverse_large`` is the transform with omega^-1 times
1/m. Both take optional (m,) tables folded into the transform: ``pre``
multiplies x_t before it, ``post`` multiplies X_k after it (a psi-twist and
a psi^-k / m untwist make them negacyclic); the inverse's ``scale`` (1/m
unless given) multiplies every word in the last store, so an untwist table
that already holds its 1/m passes ``scale=1``. Four steps, as the JAX
package's ``ops/ntt_large.py``: R-point NTTs down the columns of x viewed as
(R, C), the twiddle omega^(h b), C-point NTTs along the rows, and the
transposed read-out out[h + R g].

Each sub-transform of a pass lives in one block's shared-memory tile, so a
leaf has at most 2^``_MAX_LOG_LEAF`` points. Up to 2^26 points the plan has
two passes; past it the C-point row transforms are a four-step of their
own, recursively, so m = 2^27 takes three passes (2^9 x 2^9 x 2^9) and no
size has a cap but the field's roots. ``_MAX_LOG_LEAF`` is read when a plan
is made, so a test can make it small and exercise three and four passes at
small m. The plan holds, per four-step level, the twiddles omega^(h b) in
pass 1's store order (at h C + b) for both directions: m words each at the
top level, so a 2^27-point plan keeps two 1 GiB tables on its device; they
are made there by doubling, with no host time.

``passes(plan, ...)`` lists the launches of one transform (strides, tables,
buffers); the CUDA wrapper hands that list to kernel T and the plain twin
runs the same list with ``ops.ntt`` on index tensors, so the CPU tests hold
the decomposition and the table layouts the kernel reads.

Kernel N replaces the TPU kernels ``ntt_forward_mxu_packed``
(ops/ntt_mxu.py:631) and its leaf ``dft_matmul_apply_pallas``
(ops/ntt_mxu.py:378); it runs the kind-7 LDE and, as kernel T, the long
routes of ``ops.quotient`` and ``ops.ring_commit``. Its leaf is kernel T's
row entry (``ops.ntt_batched``). The wrappers launch it for CUDA tensors
and take the ``*_plain`` twins for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import List, Optional, Tuple

import torch

from .. import kernels
from ..core import field
from . import modarith
from .ntt import NttPlan, _transform

P = modarith.GOLDILOCKS
_MAX_LOG_LEAF = 13  # one sub-transform fills a 64 KiB shared-memory tile
MAX_LEAF_LEN = 1 << _MAX_LOG_LEAF
MAX_LEVELS = 4  # sub-transform index levels a pass takes (csrc/ntt.cu)


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


def store_order_table(omega: int, r: int, c: int, q: int, device="cpu") -> torch.Tensor:
    """(r c,) words omega^(h b) at h c + b (h < r, b < c): pass 1's twiddles
    in the order its store writes them. Row h is the power table of
    omega^h, made by doubling along b on ``device``."""
    step = power_table(omega, r, q, device)[:, None]  # omega^h
    out = torch.ones((r, 1), dtype=torch.int64, device=device)
    while out.shape[1] < c:
        out = torch.cat([out, modarith.mul_mod(out, step, q)], dim=1)
        step = modarith.mul_mod(step, step, q)
    return out[:, :c].reshape(-1)


@dataclasses.dataclass(frozen=True, eq=False)
class NttLargePlan:
    """Tables for the m-point transform with root omega mod q on one device:
    an R-point leaf, then a C-point leaf (``plan_c``) or, past one tile, a
    C-point four-step of its own (``sub``)."""

    m: int
    q: int
    omega: int
    inv_m: int
    r: int
    c: int
    plan_r: NttPlan  # root omega^C, order R (its tw_inv serves the inverse)
    plan_c: Optional[NttPlan]  # root omega^R, order C; None when ``sub`` is set
    sub: Optional["NttLargePlan"]  # the C-point four-step past one tile
    pw: torch.Tensor  # (m,) omega^(h b) at h C + b
    pw_inv: torch.Tensor  # (m,) omega^-(h b) at h C + b

    @staticmethod
    def create(m: int, omega: int, device="cpu", q: int = P) -> "NttLargePlan":
        modarith.check_modulus(q)
        log_m = m.bit_length() - 1
        if m != 1 << log_m or log_m < 2:
            raise ValueError(f"m = {m} must be a power of two >= 4")
        if field.mod_pow(omega, m // 2, q) != q - 1:
            raise ValueError(f"omega is not a primitive {m}-th root of unity mod {q}")
        n_pass = max(2, -(-log_m // _MAX_LOG_LEAF))
        r = 1 << (log_m // n_pass)
        c = m // r
        omega_c = field.mod_pow(omega, r, q)
        deep = c > 1 << _MAX_LOG_LEAF
        omega_inv = field.mod_inverse(omega, q)
        return NttLargePlan(
            m=m, q=q, omega=omega, inv_m=field.mod_inverse(m, q), r=r, c=c,
            plan_r=NttPlan.create(r, q, field.mod_pow(omega, c, q), device=device),
            plan_c=None if deep else NttPlan.create(c, q, omega_c, device=device),
            sub=NttLargePlan.create(c, omega_c, device, q) if deep else None,
            pw=store_order_table(omega, r, c, q, device),
            pw_inv=store_order_table(omega_inv, r, c, q, device),
        )

    @property
    def n_passes(self) -> int:
        return 1 + (self.sub.n_passes if self.sub is not None else 1)


@dataclasses.dataclass(frozen=True, eq=False)
class Pass:
    """One launch of kernel T's ``dft_pass`` (``struct NttPass``): n-point
    sub-transforms (``leaf``, its ``tw`` or ``tw_inv``) over a row of the
    batch, indexed by ``levels`` (count, in stride, out stride), lowest
    first; element i at i ``in_elem``, X_k at k ``out_elem``. ``src`` /
    ``dst`` name the buffers: 0 the input, 1 the scratch, 2 the output.
    ``pw`` is read at (store position mod its length), ``pre`` / ``post``
    at (position mod m)."""

    leaf: NttPlan
    inverse: bool
    levels: Tuple[Tuple[int, int, int], ...]
    in_elem: int
    out_elem: int
    src: int
    dst: int
    pw: Optional[torch.Tensor] = None
    pre: Optional[torch.Tensor] = None
    post: Optional[torch.Tensor] = None
    scale: int = 1


def passes(plan: NttLargePlan, inverse: bool, pre=None, post=None, scale: int = 1) -> List[Pass]:
    """The passes of one transform, in launch order: pass 1 of each level
    in place in the scratch buffer (the first reads the input), the last
    C-point leaf into the output. ``scale`` multiplies the last store."""
    out: List[Pass] = []

    def level(p: NttLargePlan, outer: List[Tuple[int, int, int]], s_out: int) -> None:
        # p's transform over every index of ``outer``: elements at stride 1
        # from the offsets' inputs, X_k at stride s_out from their outputs
        first = not out
        out.append(Pass(
            leaf=p.plan_r, inverse=inverse,
            levels=((p.c, 1, 1),) + tuple((cnt, i, i) for cnt, i, _ in outer),
            in_elem=p.c, out_elem=p.c, src=0 if first else 1, dst=1,
            pw=p.pw_inv if inverse else p.pw, pre=pre if first else None))
        rows = outer + [(p.r, p.c, s_out)]
        if p.sub is not None:
            level(p.sub, rows, p.r * s_out)
        else:
            out.append(Pass(
                leaf=p.plan_c, inverse=inverse, levels=tuple(rows), in_elem=1,
                out_elem=p.r * s_out, src=1, dst=2, post=post, scale=scale))

    level(plan, [], 1)
    return out


def run_passes_plain(q: int, tab_len: int, x: torch.Tensor, steps: List[Pass]) -> torch.Tensor:
    """Kernel T's passes over rows x (B, width) with ``ops.ntt`` on index
    tensors: gather each pass's sub-transforms, fold its tables
    (``pre`` / ``post`` of length ``tab_len``), transform, scatter."""
    dev = x.device
    bufs = [x, torch.empty_like(x), torch.empty_like(x)]
    for p in steps:
        n = p.leaf.m
        in_off = torch.zeros(1, dtype=torch.int64, device=dev)
        out_off = torch.zeros(1, dtype=torch.int64, device=dev)
        for cnt, s_in, s_out in reversed(p.levels):  # digit 0 fastest
            d = torch.arange(cnt, device=dev)
            in_off = (in_off[:, None] + d * s_in).reshape(-1)
            out_off = (out_off[:, None] + d * s_out).reshape(-1)
        e = torch.arange(n, device=dev)
        in_pos = in_off[:, None] + e * p.in_elem  # (subs, n)
        out_pos = out_off[:, None] + e * p.out_elem
        v = bufs[p.src][:, in_pos]
        if p.pre is not None:
            v = modarith.mul_mod(v, p.pre[in_pos % tab_len], q)
        v = _transform(p.leaf, v, p.leaf.tw_inv if p.inverse else p.leaf.tw)
        if p.pw is not None:
            v = modarith.mul_mod(v, p.pw[out_pos % p.pw.shape[0]], q)
        if p.post is not None:
            v = modarith.mul_mod(v, p.post[out_pos % tab_len], q)
        if p.scale != 1:
            v = modarith.mul_mod(v, p.scale, q)
        bufs[p.dst][:, out_pos] = v
    return bufs[2]


def _plain(plan, x, inverse, pre, post, scale):
    return run_passes_plain(plan.q, plan.m, x, passes(plan, inverse, pre, post, scale))


def ntt_forward_large_plain(plan: NttLargePlan, x, pre=None, post=None) -> torch.Tensor:
    """The same function as ``ntt_forward_large``: kernel T's passes over
    ``ops.ntt``."""
    return _plain(plan, x, False, pre, post, 1)


def ntt_inverse_large_plain(plan: NttLargePlan, x, pre=None, post=None,
                            scale=None) -> torch.Tensor:
    """The same function as ``ntt_inverse_large``: kernel T's passes over
    ``ops.ntt``."""
    return _plain(plan, x, True, pre, post, plan.inv_m if scale is None else scale % plan.q)


def _check_table(plan: NttLargePlan, t: Optional[torch.Tensor]) -> None:
    if t is not None and (t.dtype != torch.int64 or tuple(t.shape) != (plan.m,)
                          or t.device != plan.pw.device or not t.is_contiguous()):
        raise ValueError(f"pre/post must be contiguous ({plan.m},) int64 words "
                         "on the plan's device")


class NttPassStruct(ctypes.Structure):
    """``struct NttPass`` of ``csrc/ntt.cu``."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("y", ctypes.c_void_p), ("tw", ctypes.c_void_p),
        ("pw", ctypes.c_void_p), ("pre", ctypes.c_void_p), ("post", ctypes.c_void_p),
        ("scale", ctypes.c_uint64), ("row_stride", ctypes.c_longlong),
        ("pw_mask", ctypes.c_uint32), ("tab_mask", ctypes.c_uint32),
        ("in_elem", ctypes.c_uint32), ("out_elem", ctypes.c_uint32),
        ("in_stride", ctypes.c_uint32 * MAX_LEVELS), ("out_stride", ctypes.c_uint32 * MAX_LEVELS),
        ("log_count", ctypes.c_int * MAX_LEVELS),
        ("levels", ctypes.c_int), ("log_n", ctypes.c_int), ("rows", ctypes.c_int),
        ("reserved", ctypes.c_int),
    ]


def pass_struct(p: Pass, src: torch.Tensor, dst: torch.Tensor, rows: int, row_stride: int,
                tab_len: int) -> NttPassStruct:
    """The C descriptor of pass ``p`` from buffer ``src`` to ``dst``."""
    if len(p.levels) > MAX_LEVELS:
        raise ValueError(f"a pass takes at most {MAX_LEVELS} index levels")
    if row_stride > 1 << 32:  # positions within a row are 32-bit in the kernel
        raise ValueError(f"a pass spans at most 2^32 words a row, not {row_stride}")
    ptr = lambda t: None if t is None else t.data_ptr()
    tw = p.leaf.tw_inv if p.inverse else p.leaf.tw
    s = NttPassStruct(
        x=src.data_ptr(), y=dst.data_ptr(), tw=tw.data_ptr(), pw=ptr(p.pw), pre=ptr(p.pre),
        post=ptr(p.post), scale=p.scale, row_stride=row_stride,
        pw_mask=(p.pw.shape[0] if p.pw is not None else 1) - 1, tab_mask=tab_len - 1,
        in_elem=p.in_elem, out_elem=p.out_elem, levels=len(p.levels),
        log_n=p.leaf.m.bit_length() - 1, rows=rows)
    for i, (cnt, s_in, s_out) in enumerate(p.levels):
        s.log_count[i] = cnt.bit_length() - 1
        s.in_stride[i] = s_in
        s.out_stride[i] = s_out
    return s


_DESCS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cached_descs(plan, key, build):
    """The C descriptors ``build()`` makes for ``plan`` under ``key``, made
    once: a call only points them at its own buffers (building them takes
    tens of microseconds of host time, which the small shapes would pay on
    every launch)."""
    per_plan = _DESCS.setdefault(plan, {})
    if key not in per_plan:
        per_plan[key] = build()
    return per_plan[key]


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
    rows = x.shape[0]

    def build():
        steps = passes(plan, inverse, pre, post, scale)
        descs = (NttPassStruct * len(steps))(*[
            pass_struct(p, x, x, rows, plan.m, plan.m) for p in steps])
        return descs, [(p.src, p.dst) for p in steps]

    descs, route = cached_descs(plan, (inverse, None if pre is None else pre.data_ptr(),
                                       None if post is None else post.data_ptr(), scale, rows),
                                build)
    tmp = torch.empty_like(x)  # the passes' scratch, held until the launch
    bufs = (x.data_ptr(), tmp.data_ptr(), out.data_ptr())
    for d, (src, dst) in zip(descs, route):
        d.x, d.y = bufs[src], bufs[dst]
    rc = kernels.launch(x.device, kernels.load("ntt").ntt_four_step, ctypes.addressof(descs),
                        len(descs), plan.q)
    kernels.check(rc, "kernel T (four-step NTT)")
    kernels.count("ntt_four_step", len(descs), x.shape,  # one kernel per pass
                  f"{'inverse' if inverse else 'forward'} mod {plan.q}"
                  + (" pre" if pre is not None else "") + (" post" if post is not None else ""))
    return out


def ntt_forward_large(plan: NttLargePlan, x, pre=None, post=None) -> torch.Tensor:
    """(B, m) int64 words -> post o NTT(pre o x) per row, natural order."""
    return _four_step(plan, x, False, pre, post, 1)


def ntt_inverse_large(plan: NttLargePlan, x, pre=None, post=None, scale=None) -> torch.Tensor:
    """(B, m) int64 words -> scale post o iNTT'(pre o x) per row, where
    iNTT' is the transform with omega^-1 and scale is 1/m unless given."""
    return _four_step(plan, x, True, pre, post, plan.inv_m if scale is None else scale % plan.q)
