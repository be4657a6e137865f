"""FRI on the host: field registry, transcript, proof containers, verifier.

The port's copy of the host parts of the JAX package's ``proof/fri.py``:

- ``root_of_order``, ``coset_offset`` and ``_gl_powers`` (the coset
  ``offset * <omega>`` that codewords live on);
- ``FriTranscript``, the SHA3-256 ratchet every absorb and squeeze goes
  through, and ``FriParams``;
- ``LayerOpening``, ``GroupOpening``, ``FriQuery``, ``FriProof`` with their
  wire bytes both ways;
- ``fri_verify``, the verifier: ``hashlib`` paths and Python-int field
  math, or, where ``native_bridge`` loads, its batched Merkle, DEEP and
  fold checks (the JAX package's native fast path), with the same
  decisions;
- the host prover: ``lde``, ``commit_codeword*``, ``_fold_codeword`` and
  ``fri_prove``, the route of every circuit off the Goldilocks fast front
  end (the 44-bit field, the healthcare prime, other Goldilocks domains).
  Goldilocks arrays are uint64 numpy, their arithmetic torch ops on CPU
  words (the JAX package's vectorised numpy backend); the other fields are
  Python ints, their NTT ``r1cs.poly.ntt_forward``. Trees hash with
  ``hashlib`` (``proof.merkle``): the bytes are those of the JAX package's
  device-hashed trees.

Fold rule: with f(x) = f_e(x^2) + x f_o(x^2) and challenge c, the next
layer is v' = ((lo + hi) + c (lo - hi) / x) / 2. The device prover is
``proof.fri_device``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..core import field
from ..core.errors import DomainError, SerializationError
from ..core.params import (
    HEALTHCARE_DUMP_MODULUS,
    NTT_FRIENDLY_MODULUS,
    NTT_MODULUS,
    NTT_PRIMITIVE_ROOT,
    ROOTS_OF_UNITY_45BIT,
)
from ..ops import modarith
from ..ops.keccak import MAX_GROUP_ORACLES
from ..ops.ntt import NttPlan, ntt_forward as _ntt_forward_words
from ..r1cs.poly import ntt_forward, ntt_inverse
from .merkle import MerkleTree, build_forest_u64_groups, build_forest_u64_pairs, verify_path

#: modulus -> (two-adicity, generator of the order-2^two_adicity subgroup,
#: coset offset = a multiplicative generator of F_q^*)
_FRI_FIELDS = {
    NTT_MODULUS: (32, NTT_PRIMITIVE_ROOT, 7),
    NTT_FRIENDLY_MODULUS: (13, ROOTS_OF_UNITY_45BIT[8192], 3),
    HEALTHCARE_DUMP_MODULUS: (27, pow(31, 15, HEALTHCARE_DUMP_MODULUS), 31),
}

_GL = modarith.GOLDILOCKS

#: Cap on statements in an aggregated proof (a bound of ``FriQuery.read``).
MAX_AGGREGATE_STATEMENTS = 4096


def fri_supported(modulus: int) -> bool:
    return modulus in _FRI_FIELDS


def max_codeword_size(modulus: int) -> int:
    return 1 << _FRI_FIELDS[modulus][0] if modulus in _FRI_FIELDS else 0


def root_of_order(modulus: int, size: int) -> int:
    """Primitive ``size``-th root of unity (size a power of two)."""
    if modulus not in _FRI_FIELDS:
        raise DomainError(
            f"FRI unsupported for modulus {modulus}: no registered 2-adic subgroup")
    two_adicity, max_root, _ = _FRI_FIELDS[modulus]
    if size & (size - 1) or size < 1:
        raise DomainError(f"codeword size must be a power of two, got {size}")
    log = size.bit_length() - 1
    if log > two_adicity:
        raise DomainError(
            f"codeword size {size} exceeds the 2-adic subgroup 2^{two_adicity} "
            f"of modulus {modulus}")
    return pow(max_root, 1 << (two_adicity - log), modulus)


def coset_offset(modulus: int) -> int:
    """The LDE coset shift: a multiplicative generator of F_q^*."""
    if modulus not in _FRI_FIELDS:
        raise DomainError(f"FRI unsupported for modulus {modulus}")
    return _FRI_FIELDS[modulus][2]


def _gl_powers(base: int, n: int, scale: int = 1) -> np.ndarray:
    """[scale * base^i for i < n] mod Goldilocks (uint64), by log-doubling
    on CPU words."""
    out = modarith.to_words([scale % _GL])
    cur = base % _GL
    while out.shape[0] < n:
        m = min(out.shape[0], n - out.shape[0])
        out = torch.cat([out, modarith.mul_mod(out[:m], cur, _GL)])
        cur = cur * cur % _GL
    return modarith.to_u64(out[:n])


def _gl_pow_array(a: np.ndarray, exp: int) -> np.ndarray:
    """Elementwise a^exp mod Goldilocks (square and multiply on the array)."""
    base = modarith.to_words(np.ascontiguousarray(a, dtype=np.uint64).reshape(-1))
    result = torch.ones_like(base)
    while exp:
        if exp & 1:
            result = modarith.mul_mod(result, base, _GL)
        exp >>= 1
        if exp:
            base = modarith.mul_mod(base, base, _GL)
    return modarith.to_u64(result).reshape(np.shape(a))


def _gl_inverse_array(a: np.ndarray) -> np.ndarray:
    """Elementwise inverse mod Goldilocks (Fermat); raises DomainError on a
    zero element."""
    if bool((np.asarray(a) == 0).any()):
        raise DomainError("batch_inverse: zero element (challenge hit the domain)")
    return _gl_pow_array(a, _GL - 2)


def batch_inverse(vals: Sequence[int], q: int) -> List[int]:
    """Montgomery batch inversion; raises DomainError on a zero element."""
    n = len(vals)
    prefix = [0] * n
    acc = 1
    for i, v in enumerate(vals):
        prefix[i] = acc
        acc = acc * v % q
    if acc == 0:
        raise DomainError("batch_inverse: zero element (challenge hit the domain)")
    inv_acc = field.mod_inverse(acc, q)
    if inv_acc is None:
        raise DomainError("batch_inverse: non-invertible product")
    out = [0] * n
    for i in range(n - 1, -1, -1):
        out[i] = prefix[i] * inv_acc % q
        inv_acc = inv_acc * vals[i] % q
    return out


def coset_points(offset: int, omega: int, n: int, q: int) -> List[int]:
    pts = [0] * n
    acc = offset % q
    for i in range(n):
        pts[i] = acc
        acc = acc * omega % q
    return pts


_LDE_PLANS: dict = {}


def _gl_u64(values) -> np.ndarray:
    """Values as uint64 reduced mod Goldilocks (uint64 arrays are taken as
    reduced already, as the JAX package does)."""
    if isinstance(values, np.ndarray) and values.dtype == np.uint64:
        return values
    return np.array([int(c) % _GL for c in values], dtype=np.uint64)


def lde(coeffs: Sequence[int], n: int, offset: int, omega: int, q: int):
    """The polynomial on the size-``n`` coset offset <omega>: its coefficients
    twisted by offset^i, then one cyclic NTT. Goldilocks gives uint64
    (the transform's root is ``root_of_order(q, n)``, as in the JAX
    package), the other fields a list of ints."""
    if len(coeffs) > n:
        raise DomainError(f"polynomial length {len(coeffs)} exceeds codeword size {n}")
    if q == _GL:
        padded = np.zeros(n, dtype=np.uint64)
        padded[: len(coeffs)] = _gl_u64(coeffs)
        if n not in _LDE_PLANS:
            _LDE_PLANS[n] = NttPlan.create(n, _GL, root_of_order(_GL, n))
        twisted = modarith.mul_mod(modarith.to_words(padded),
                                   modarith.to_words(_gl_powers(offset, n)), _GL)
        return modarith.to_u64(_ntt_forward_words(_LDE_PLANS[n], twisted))
    padded = [c % q for c in coeffs] + [0] * (n - len(coeffs))
    acc = 1
    twisted = [0] * n
    for i, c in enumerate(padded):
        twisted[i] = c * acc % q
        acc = acc * offset % q
    return ntt_forward(twisted, q, omega)


def commit_codeword(values: Sequence[int]) -> MerkleTree:
    """Merkle-commit a codeword with paired leaves (i, i + n/2)."""
    values = np.asarray(values, dtype=np.uint64)
    half = len(values) // 2
    return build_forest_u64_pairs(values[None, :half], values[None, half:])[0]


def commit_codeword_group(codewords: Sequence[Sequence[int]]) -> MerkleTree:
    """Merkle-commit a group of equal-size codewords in one interleaved tree
    (leaf i = concat_g pack("<QQ", cw_g[i], cw_g[i + n/2]))."""
    if len(codewords) > MAX_GROUP_ORACLES:
        raise DomainError(
            f"group of {len(codewords)} oracles exceeds MAX_GROUP_ORACLES "
            f"({MAX_GROUP_ORACLES}: the single-Keccak-block leaf limit)")
    n = len(codewords[0])
    if any(len(cw) != n for cw in codewords):
        raise DomainError("group codewords must share one size")
    return build_forest_u64_groups(
        np.stack([np.asarray(cw, dtype=np.uint64) for cw in codewords])[None])[0]


def commit_codeword_groups(groups: Sequence[Sequence[Sequence[int]]]) -> List[MerkleTree]:
    """``commit_codeword_group`` of each group."""
    return [commit_codeword_group(grp) for grp in groups]


def commit_codewords(codewords: Sequence[Sequence[int]]) -> List[MerkleTree]:
    """``commit_codeword`` of each codeword."""
    return [commit_codeword(cw) for cw in codewords]


def _fold_codeword(values, offset: int, omega: int, c: int, q: int):
    """One fold of a whole codeword on offset <omega> (n -> n/2)."""
    half = len(values) // 2
    inv2 = field.mod_inverse(2, q)
    if q == _GL:
        v = modarith.to_words(np.asarray(values, dtype=np.uint64))
        lo, hi = v[:half], v[half:]
        inv_xs = modarith.to_words(_gl_powers(field.mod_inverse(omega, q), half,
                                              scale=field.mod_inverse(offset, q)))
        t = modarith.mul_mod(modarith.mul_mod(modarith.sub_mod(lo, hi, q), c % q, q),
                             inv_xs, q)
        return modarith.to_u64(modarith.mul_mod(
            modarith.add_mod(modarith.add_mod(lo, hi, q), t, q), inv2, q))
    inv_xs = batch_inverse(coset_points(offset, omega, half, q), q)
    out = [0] * half
    for i in range(half):
        lo, hi = values[i], values[i + half]
        out[i] = ((lo + hi) + c * ((lo - hi) % q) % q * inv_xs[i]) % q * inv2 % q
    return out


def _fold_pair(lo: int, hi: int, x: int, c: int, q: int) -> int:
    inv2x = field.mod_inverse(2 * x % q, q)
    if inv2x is None:
        raise DomainError("fold point not invertible")
    inv2 = field.mod_inverse(2, q)
    return ((lo + hi) % q * inv2 + c * ((lo - hi) % q) % q * inv2x) % q


# --- Fiat-Shamir transcript ---------------------------------------------------


class FriTranscript:
    """Deterministic SHA3-256 ratchet: every absorb and squeeze replaces the
    state with SHA3-256(state || label || data)."""

    DOMAIN_TAG = b"LAMBDA-SNARK-R-FRI-v1"

    def __init__(self) -> None:
        self._state = hashlib.sha3_256(self.DOMAIN_TAG).digest()
        self._counter = 0

    def absorb(self, label: bytes, data: bytes) -> None:
        self._state = hashlib.sha3_256(self._state + label + data).digest()

    def absorb_words(self, label: bytes, words: Sequence[int]) -> None:
        blob = struct.pack("<Q", len(words)) + b"".join(
            struct.pack("<Q", int(w) & ((1 << 64) - 1)) for w in words)
        self.absorb(label, blob)

    def _squeeze(self, label: bytes) -> bytes:
        self._counter += 1
        digest = hashlib.sha3_256(
            self._state + label + struct.pack("<Q", self._counter)).digest()
        self._state = digest
        return digest

    def challenge_field(self, q: int, label: bytes) -> int:
        """First 8 squeezed bytes (LE) mod q."""
        return int.from_bytes(self._squeeze(label)[:8], "little") % q

    def challenge_indices(self, bound: int, count: int, label: bytes) -> List[int]:
        return [int.from_bytes(self._squeeze(label)[:8], "little") % bound
                for _ in range(count)]


# --- proof containers ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class FriParams:
    """Rate 1/2^log_blowup, query count, and the final polynomial's length
    cap (defaults: 1/8, 30 queries, 64)."""

    log_blowup: int = 3
    num_queries: int = 30
    final_len: int = 64

    def validate(self) -> None:
        if not 1 <= self.log_blowup <= 8:
            raise DomainError(f"log_blowup out of range: {self.log_blowup}")
        if not 1 <= self.num_queries <= 1024:
            raise DomainError(f"num_queries out of range: {self.num_queries}")
        if self.final_len < 1 or self.final_len & (self.final_len - 1):
            raise DomainError(f"final_len must be a power of two: {self.final_len}")

    def at_least(self, floor: "FriParams") -> bool:
        return (self.log_blowup >= floor.log_blowup
                and self.num_queries >= floor.num_queries)


def _joined(path) -> bytes:
    return path if isinstance(path, (bytes, bytearray)) else b"".join(path)


@dataclasses.dataclass(frozen=True)
class LayerOpening:
    """One authenticated fold-layer pair (v[i], v[i + N/2]); ``path`` is the
    contiguous blob of sibling digests, bottom-up."""

    v_lo: int
    v_hi: int
    path: bytes

    def __post_init__(self) -> None:
        object.__setattr__(self, "path", _joined(self.path))

    def to_bytes(self) -> bytes:
        return struct.pack("<QQB", self.v_lo, self.v_hi, len(self.path) // 32) + self.path

    @staticmethod
    def read(data: bytes, off: int) -> Tuple["LayerOpening", int]:
        if off + 17 > len(data):
            raise SerializationError("truncated FRI opening")
        v_lo, v_hi, plen = struct.unpack_from("<QQB", data, off)
        off += 17
        end = off + 32 * plen
        if end > len(data):
            raise SerializationError("truncated FRI path")
        return LayerOpening(v_lo, v_hi, data[off:end]), end


@dataclasses.dataclass(frozen=True)
class GroupOpening:
    """One authenticated interleaved-group leaf: ``values`` is
    (lo_0, hi_0, lo_1, hi_1, ...) in oracle order, under one path."""

    values: Tuple[int, ...]
    path: bytes

    def __post_init__(self) -> None:
        object.__setattr__(self, "path", _joined(self.path))
        if not isinstance(self.values, tuple):
            object.__setattr__(self, "values", tuple(self.values))

    def leaf_bytes(self) -> bytes:
        return b"".join(struct.pack("<Q", int(v)) for v in self.values)

    def to_bytes(self) -> bytes:
        out = struct.pack("<B", len(self.values)) + self.leaf_bytes()
        return out + struct.pack("<B", len(self.path) // 32) + self.path

    @staticmethod
    def read(data: bytes, off: int) -> Tuple["GroupOpening", int]:
        if off + 1 > len(data):
            raise SerializationError("truncated FRI group opening")
        n_vals = data[off]
        off += 1
        if n_vals == 0 or n_vals & 1 or n_vals > 2 * MAX_GROUP_ORACLES:
            raise SerializationError(f"bad group opening width {n_vals}")
        if off + 8 * n_vals + 1 > len(data):
            raise SerializationError("truncated group opening values")
        values = struct.unpack_from(f"<{n_vals}Q", data, off)
        off += 8 * n_vals
        plen = data[off]
        off += 1
        end = off + 32 * plen
        if end > len(data):
            raise SerializationError("truncated group opening path")
        return GroupOpening(values, data[off:end]), end


@dataclasses.dataclass(frozen=True)
class FriQuery:
    input_openings: Tuple[GroupOpening, ...]  # one per input oracle group
    layer_openings: Tuple[LayerOpening, ...]  # one per committed fold layer

    def to_bytes(self) -> bytes:
        out = struct.pack("<HH", len(self.input_openings), len(self.layer_openings))
        return out + b"".join(op.to_bytes() for op in self.input_openings + self.layer_openings)

    @staticmethod
    def read(data: bytes, off: int) -> Tuple["FriQuery", int]:
        if off + 4 > len(data):
            raise SerializationError("truncated FRI query")
        n_in, n_layer = struct.unpack_from("<HH", data, off)
        off += 4
        if n_in > MAX_AGGREGATE_STATEMENTS or n_layer > 64:
            raise SerializationError(
                f"unreasonable FRI query counts ({n_in}, {n_layer}) — "
                "possibly a pre-0.8 proof blob")
        ins, layers = [], []
        for _ in range(n_in):
            op, off = GroupOpening.read(data, off)
            ins.append(op)
        for _ in range(n_layer):
            op, off = LayerOpening.read(data, off)
            layers.append(op)
        return FriQuery(tuple(ins), tuple(layers)), off


@dataclasses.dataclass(frozen=True)
class FriProof:
    layer_roots: Tuple[bytes, ...]
    final_coeffs: Tuple[int, ...]
    queries: Tuple[FriQuery, ...]

    def to_bytes(self) -> bytes:
        out = struct.pack("<H", len(self.layer_roots)) + b"".join(self.layer_roots)
        out += struct.pack("<H", len(self.final_coeffs))
        out += b"".join(struct.pack("<Q", c) for c in self.final_coeffs)
        out += struct.pack("<H", len(self.queries))
        return out + b"".join(qy.to_bytes() for qy in self.queries)

    @staticmethod
    def read(data: bytes, off: int) -> Tuple["FriProof", int]:
        if off + 2 > len(data):
            raise SerializationError("truncated FRI proof")
        (n_roots,) = struct.unpack_from("<H", data, off)
        off += 2
        roots = []
        for _ in range(n_roots):
            if off + 32 > len(data):
                raise SerializationError("truncated FRI roots")
            roots.append(data[off: off + 32])
            off += 32
        if off + 2 > len(data):
            raise SerializationError("truncated FRI final length")
        (n_final,) = struct.unpack_from("<H", data, off)
        off += 2
        if n_final > 4096:
            raise SerializationError("unreasonable FRI final polynomial length")
        if off + 8 * n_final > len(data):
            raise SerializationError("truncated FRI final coeffs")
        final = struct.unpack_from(f"<{n_final}Q", data, off)
        off += 8 * n_final
        if off + 2 > len(data):
            raise SerializationError("truncated FRI query count")
        (n_q,) = struct.unpack_from("<H", data, off)
        off += 2
        if n_q > 4096:
            raise SerializationError("unreasonable FRI query count")
        queries = []
        for _ in range(n_q):
            qy, off = FriQuery.read(data, off)
            queries.append(qy)
        return FriProof(tuple(roots), tuple(final), tuple(queries)), off


# --- verifier -----------------------------------------------------------------


def _fold_pair_xinv(lo: int, hi: int, x_inv: int, c: int, q: int, inv2: int) -> int:
    """One fold of the pair (lo, hi) at the point with inverse ``x_inv``."""
    inv2x = inv2 * x_inv % q
    return ((lo + hi) % q * inv2 + c * ((lo - hi) % q) % q * inv2x) % q


def _effective_final_len(d_bound: int, final_len: int) -> int:
    """At least one fold must happen; shrink final_len for tiny instances."""
    return min(final_len, max(1, d_bound >> 1))


def _query_positions(indices, n0: int, n_layers: int) -> np.ndarray:
    """pos[:, 0] = i0; pos[:, k+1] = pos[:, k] % (n0 >> (k+2))."""
    pos = np.empty((len(indices), n_layers + 1), dtype=np.int64)
    pos[:, 0] = np.asarray(indices, dtype=np.int64)
    for k in range(n_layers):
        pos[:, k + 1] = pos[:, k] % (n0 >> (k + 2))
    return pos


#: use the native library's batched Merkle, DEEP and fold checks when it
#: loads (tests switch it off to hold the two paths to the same decisions)
NATIVE_VERIFY = True

_native_mod = None


def _native():
    """The ``native_bridge`` module if its library loads, else None."""
    global _native_mod
    if _native_mod is None:
        from .. import native_bridge

        _native_mod = native_bridge if native_bridge.available() else False
    return _native_mod or None


def _verify_paths_native(proof: FriProof, groups: Sequence[Tuple[bytes, int]],
                         indices: Sequence[int], pos: np.ndarray, n0: int,
                         grp_vals: Sequence[np.ndarray], lay_vals: np.ndarray) -> bool:
    """Every group and layer path of every query in a few native calls (one
    per distinct group width and one for the layers), deciding as
    ``verify_path`` does path by path. ``grp_vals[g]``: uint64 [q_n,
    2 size_g] opened values; ``lay_vals``: uint64 [q_n, n_layers, 2]."""
    nb = _native()
    q_n = len(indices)
    n_layers = len(proof.layer_roots)
    depth_in = (n0 // 2).bit_length() - 1
    layer_depths = [(n0 >> (k + 2)).bit_length() - 1 for k in range(n_layers)]
    if q_n == 0:
        return True
    idx_arr = np.asarray(indices, dtype=np.uint64)
    for size in sorted({size for _root, size in groups}):
        g_ids = [g for g, (_r, s) in enumerate(groups) if s == size]
        n_g, leaf_len = len(g_ids), 16 * size
        leaves = np.empty((q_n, n_g, leaf_len), dtype=np.uint8)
        sib = np.empty((q_n, n_g, depth_in, 32), dtype=np.uint8)
        for j, g in enumerate(g_ids):  # query-major, group-minor lanes
            leaves[:, j] = np.ascontiguousarray(grp_vals[g]).view(np.uint8)
            blob = b"".join(qy.input_openings[g].path for qy in proof.queries)
            sib[:, j] = np.frombuffer(blob, dtype=np.uint8).reshape(q_n, depth_in, 32)
        roots = np.tile(np.frombuffer(b"".join(groups[g][0] for g in g_ids),
                                      dtype=np.uint8).reshape(n_g, 32), (q_n, 1))
        ok = nb.merkle_verify_batch(leaves.reshape(q_n * n_g, leaf_len),
                                    np.repeat(idx_arr, n_g),
                                    sib.reshape(q_n * n_g, depth_in, 32),
                                    np.full(q_n * n_g, depth_in, dtype=np.uint32), roots)
        if not bool(ok.all()):
            return False
    if n_layers == 0:
        return True
    lanes, max_depth = q_n * n_layers, max(layer_depths)
    sib = np.zeros((q_n, n_layers, max_depth, 32), dtype=np.uint8)
    blob = np.frombuffer(b"".join(op.path for qy in proof.queries for op in qy.layer_openings),
                         dtype=np.uint8).reshape(q_n, 32 * sum(layer_depths))
    cursor = 0
    for k, d in enumerate(layer_depths):
        sib[:, k, :d] = blob[:, cursor:cursor + 32 * d].reshape(q_n, d, 32)
        cursor += 32 * d
    roots = np.tile(np.frombuffer(b"".join(proof.layer_roots), dtype=np.uint8)
                    .reshape(n_layers, 32), (q_n, 1))
    ok = nb.merkle_verify_batch(
        np.ascontiguousarray(lay_vals).reshape(lanes, 2).view(np.uint8).reshape(lanes, 16),
        pos[:, 1:].astype(np.uint64).reshape(-1), sib.reshape(lanes, max_depth, 32),
        np.tile(np.asarray(layer_depths, dtype=np.uint32), q_n), roots)
    return bool(ok.all())


def fri_verify(
    proof: FriProof,
    input_groups: Sequence,
    g_eval: Callable[[int, int, Sequence[int], Sequence[int]], Tuple[int, int]],
    n0: int,
    offset: int,
    omega: int,
    q: int,
    params: FriParams,
    tr: FriTranscript,
    deep=None,
    g_eval_batch=None,
) -> bool:
    """Verify a FriProof, deciding as the JAX package's ``fri_verify`` does.

    ``input_groups``: ``(root, group_size)`` pairs (a bare root is a group of
    one). ``g_eval(index, half, lo_values, hi_values) -> (g_lo, g_hi)``
    computes the virtual oracle from the authenticated per-oracle values
    (raise DomainError to reject). Opened values must be canonical and every
    path must have the exact tree depth.

    Where the native library loads (and ``NATIVE_VERIFY``), the paths, the
    oracle and the fold walk are checked in a few C calls: ``deep``, six
    length-``n_in`` arrays ``(wa, wb, ea, eb, alphas, betas)``, names the
    standard batched-DEEP oracle g(x) = sum_k wa[k] (f_k(x) - ea[k]) /
    (x - alphas[k]) + wb[k] (f_k(x) - eb[k]) / (x - betas[k]), evaluated
    natively; else ``g_eval_batch(indices_u64, half, in_lo[q, k], in_hi[q,
    k]) -> (g_lo[q], g_hi[q])`` evaluates it over all queries at once (kind
    9); else ``g_eval`` query by query. Each decides as ``g_eval`` does.
    The ``hashlib`` path with ``g_eval`` is the reference."""
    params.validate()
    d_bound = n0 >> params.log_blowup
    final_len = _effective_final_len(d_bound, params.final_len)
    if len(proof.final_coeffs) > final_len:
        return False

    fold_challenges: List[int] = []
    d = d_bound
    layer_idx = 0
    while True:
        fold_challenges.append(tr.challenge_field(q, b"fri-fold"))
        d >>= 1
        if d <= final_len:
            break
        if layer_idx >= len(proof.layer_roots):
            return False
        tr.absorb(b"fri-layer-root", proof.layer_roots[layer_idx])
        layer_idx += 1
    if layer_idx != len(proof.layer_roots):
        return False
    tr.absorb_words(b"fri-final", list(proof.final_coeffs))
    indices = tr.challenge_indices(n0 // 2, params.num_queries, b"fri-query")
    if len(proof.queries) != len(indices):
        return False
    inv2 = field.mod_inverse(2, q)
    inv_offset = field.mod_inverse(offset, q)
    inv_omega = field.mod_inverse(omega, q)
    if inv2 is None or inv_offset is None or inv_omega is None:
        return False

    groups = [(g, 1) if isinstance(g, (bytes, bytearray)) else (g[0], int(g[1]))
              for g in input_groups]
    n_in = sum(size for _r, size in groups)
    n_layers = len(proof.layer_roots)
    q_n = len(indices)
    depth_in = (n0 // 2).bit_length() - 1
    layer_depths = [(n0 >> (k + 2)).bit_length() - 1 for k in range(n_layers)]
    for query in proof.queries:
        if len(query.input_openings) != len(groups) or len(query.layer_openings) != n_layers:
            return False
        for op, (_root, size) in zip(query.input_openings, groups):
            if len(op.values) != 2 * size or len(op.path) != 32 * depth_in:
                return False
        for k, op in enumerate(query.layer_openings):
            if len(op.path) != 32 * layer_depths[k]:
                return False
    try:
        grp_vals = [np.array([qy.input_openings[g].values for qy in proof.queries],
                             dtype=np.uint64).reshape(q_n, 2 * size)
                    for g, (_root, size) in enumerate(groups)]
        in_vals = (np.concatenate(grp_vals, axis=1).reshape(q_n, n_in, 2) if groups
                   else np.empty((q_n, 0, 2), dtype=np.uint64))
        lay_vals = np.array([[(op.v_lo, op.v_hi) for op in qy.layer_openings]
                             for qy in proof.queries], dtype=np.uint64).reshape(q_n, n_layers, 2)
    except (ValueError, OverflowError):
        return False
    if int(in_vals.max(initial=0)) >= q or int(lay_vals.max(initial=0)) >= q:
        return False

    pos = _query_positions(indices, n0, n_layers)
    half0 = n0 // 2
    nb = _native() if NATIVE_VERIFY else None
    if nb is not None:
        if not _verify_paths_native(proof, groups, indices, pos, n0, grp_vals, lay_vals):
            return False
        idx_arr = np.asarray(indices, dtype=np.uint64)
        in_lo, in_hi = in_vals[:, :, 0], in_vals[:, :, 1]
        try:
            if deep is not None:
                g = nb.fri_deep_g_eval(q, offset, omega, n0, idx_arr, in_lo, in_hi, *deep)
                if g is None:
                    return False
                g_lo, g_hi = g
            elif g_eval_batch is not None:
                g_lo, g_hi = g_eval_batch(idx_arr, half0, in_lo, in_hi)
            else:
                g_lo = np.empty(q_n, dtype=np.uint64)
                g_hi = np.empty(q_n, dtype=np.uint64)
                for qi, i0 in enumerate(indices):
                    g_lo[qi], g_hi[qi] = g_eval(i0, half0, [int(v) for v in in_lo[qi]],
                                                [int(v) for v in in_hi[qi]])
        except DomainError:
            return False
        return nb.fri_fold_walk(q, offset, omega, n0, [c % q for c in fold_challenges], idx_arr,
                                g_lo, g_hi, lay_vals[:, :, 0], lay_vals[:, :, 1],
                                [c % q for c in proof.final_coeffs])

    for qi, (i0, query) in enumerate(zip(indices, proof.queries)):
        for op, (root, _size) in zip(query.input_openings, groups):
            if not verify_path(root, i0, op.leaf_bytes(), op.path):
                return False
        for k, op in enumerate(query.layer_openings):
            leaf = struct.pack("<QQ", op.v_lo, op.v_hi)
            if not verify_path(proof.layer_roots[k], int(pos[qi, k + 1]), leaf, op.path):
                return False
        try:
            g_lo, g_hi = g_eval(i0, half0, [int(v) for v in in_vals[qi, :, 0]],
                                [int(v) for v in in_vals[qi, :, 1]])
        except DomainError:
            return False

        # walk the fold layers; x_inv squares per layer
        size = n0
        off, om = offset, omega
        v_lo, v_hi = g_lo, g_hi
        x_inv = inv_offset * pow(inv_omega, i0, q) % q
        for k, c in enumerate(fold_challenges):
            folded = _fold_pair_xinv(v_lo, v_hi, x_inv, c, q, inv2)
            x_inv = x_inv * x_inv % q
            size //= 2
            off = off * off % q
            om = om * om % q
            if k < n_layers:
                half = size // 2
                if pos[qi, k] >= half:
                    # x_{k+1} = -x_k^2 there: om_k^(size_k/2) = -1
                    x_inv = (q - x_inv) % q
                op = query.layer_openings[k]
                expect = op.v_lo if pos[qi, k] < half else op.v_hi
                if folded != expect:
                    return False
                v_lo, v_hi = op.v_lo, op.v_hi
            else:
                x_fin = off * pow(om, int(pos[qi, k]), q) % q
                fin = 0
                for cf in reversed(proof.final_coeffs):
                    fin = (fin * x_fin + cf) % q
                if folded != fin:
                    return False
    return True


# --- host prover ----------------------------------------------------------------


def fri_prove(g_codeword, inputs: Sequence[Tuple[Sequence[Sequence[int]], MerkleTree]],
              offset: int, omega: int, q: int, params: FriParams,
              tr: FriTranscript) -> FriProof:
    """Prove that ``g_codeword`` is close to degree < len / 2^log_blowup, on
    the host, byte for byte the JAX package's ``fri_prove``.

    ``inputs``: groups ``(codewords, tree)`` whose tree commits the group's
    codewords position-wise; each query opens one path per group. The
    caller has absorbed the input roots and the claimed evaluations."""
    params.validate()
    n0 = len(g_codeword)
    d_bound = n0 >> params.log_blowup
    final_len = _effective_final_len(d_bound, params.final_len)

    committed: List[Tuple[Sequence[int], MerkleTree]] = []
    roots: List[bytes] = []
    cur = g_codeword
    off, om, d = offset, omega, d_bound
    while True:
        c = tr.challenge_field(q, b"fri-fold")
        cur = _fold_codeword(cur, off, om, c, q)
        off, om, d = off * off % q, om * om % q, d >> 1
        if d <= final_len:
            break
        tree = commit_codeword(cur)
        committed.append((cur, tree))
        roots.append(tree.root)
        tr.absorb(b"fri-layer-root", tree.root)

    # the final polynomial: inverse NTT on the residual coset, untwisted
    coeffs = ntt_inverse([int(v) for v in cur], q, om)
    inv_off = field.mod_inverse(off, q)
    acc, final = 1, []
    for cf in coeffs:
        final.append(cf * acc % q)
        acc = acc * inv_off % q
    if any(final[final_len:]):
        raise DomainError("FRI final polynomial exceeds its degree bound")
    final = final[:final_len]
    tr.absorb_words(b"fri-final", final)

    indices = tr.challenge_indices(n0 // 2, params.num_queries, b"fri-query")
    queries: List[FriQuery] = []
    for i0 in indices:
        input_openings = []
        for group_cws, tree in inputs:
            half = len(group_cws[0]) // 2
            vals = tuple(int(v) for cw in group_cws for v in (cw[i0], cw[i0 + half]))
            input_openings.append(GroupOpening(vals, tuple(tree.path(i0))))
        layer_openings = []
        pos = i0
        for values, tree in committed:
            half = len(values) // 2
            p = pos % half
            layer_openings.append(LayerOpening(int(values[p]), int(values[p + half]),
                                               tuple(tree.path(p))))
            pos = p
        queries.append(FriQuery(tuple(input_openings), tuple(layer_openings)))
    return FriProof(tuple(roots), tuple(final), tuple(queries))
