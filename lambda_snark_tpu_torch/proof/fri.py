"""FRI on the host: field registry, transcript, proof containers, verifier.

The port's copy of the host parts of the JAX package's ``proof/fri.py``:

- ``root_of_order``, ``coset_offset`` and ``_gl_powers`` (the coset
  ``offset * <omega>`` that codewords live on);
- ``FriTranscript``, the SHA3-256 ratchet every absorb and squeeze goes
  through, and ``FriParams``;
- ``LayerOpening``, ``GroupOpening``, ``FriQuery``, ``FriProof`` with their
  wire bytes both ways;
- ``fri_verify``, the scalar verifier (``hashlib`` paths, Python-int field
  math; the JAX package's native fast path is not carried over).

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
from .merkle import verify_path

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
) -> bool:
    """Verify a FriProof, deciding as the JAX package's ``fri_verify`` does.

    ``input_groups``: ``(root, group_size)`` pairs (a bare root is a group of
    one). ``g_eval(index, half, lo_values, hi_values) -> (g_lo, g_hi)``
    computes the virtual oracle from the authenticated per-oracle values
    (raise DomainError to reject). Opened values must be canonical and every
    path must have the exact tree depth."""
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
    n_layers = len(proof.layer_roots)
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
        values = [v for op in query.input_openings for v in op.values]
        values += [v for op in query.layer_openings for v in (op.v_lo, op.v_hi)]
        if any(not 0 <= int(v) < q for v in values):
            return False

    pos = _query_positions(indices, n0, n_layers)
    half0 = n0 // 2
    for qi, (i0, query) in enumerate(zip(indices, proof.queries)):
        for op, (root, _size) in zip(query.input_openings, groups):
            if not verify_path(root, i0, op.leaf_bytes(), op.path):
                return False
        for k, op in enumerate(query.layer_openings):
            leaf = struct.pack("<QQ", op.v_lo, op.v_hi)
            if not verify_path(proof.layer_roots[k], int(pos[qi, k + 1]), leaf, op.path):
                return False
        in_vals = [v for op in query.input_openings for v in op.values]
        try:
            g_lo, g_hi = g_eval(i0, half0, [int(v) for v in in_vals[0::2]],
                                [int(v) for v in in_vals[1::2]])
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
