"""SHA3-256 Merkle trees on the host (the port's copy of the host parts of
``proof/merkle.py``).

Leaves hash as SHA3-256(0x00 || data), interior nodes as
SHA3-256(0x01 || left || right). A tree is a list of digest levels, uint8
arrays [rows, 32] from the hashed leaves up to the one-row root level.
Device-built levels (``proof.fri_device``, kernel K) reach the host only as
roots and opened paths; ``MerkleTree(_levels=...)`` wraps levels that were
built elsewhere, and ``_finish_levels`` hashes a partial stack up to its
root. ``build_forest_u64_pairs`` / ``build_forest_u64_groups`` build the
FRI leaf layouts of uint64 codewords with ``hashlib`` (the JAX package
hashes them on its device above 4096 leaves; the trees are the same).
"""

from __future__ import annotations

import hashlib
from typing import List, Optional, Sequence

import numpy as np

_LEAF_PREFIX = b"\x00"
_NODE_PREFIX = b"\x01"

HASH_BYTES = 32


def _hash_leaf(data: bytes) -> bytes:
    return hashlib.sha3_256(_LEAF_PREFIX + data).digest()


def _hash_node(left: bytes, right: bytes) -> bytes:
    return hashlib.sha3_256(_NODE_PREFIX + left + right).digest()


def _finish_levels(levels: List[np.ndarray]) -> List[np.ndarray]:
    """Extend digest levels by host hashing until the root level."""
    while len(levels[-1]) > 1:
        prev = levels[-1]
        nxt = np.empty((len(prev) // 2, HASH_BYTES), dtype=np.uint8)
        for i in range(0, len(prev), 2):
            nxt[i // 2] = np.frombuffer(
                _hash_node(prev[i].tobytes(), prev[i + 1].tobytes()), dtype=np.uint8
            )
        levels.append(nxt)
    return levels


class MerkleTree:
    """Binary Merkle tree over a power-of-two list of byte leaves."""

    def __init__(self, leaves: Optional[Sequence[bytes]] = None,
                 _levels: Optional[List[np.ndarray]] = None) -> None:
        if _levels is not None:
            self._levels = _levels
            self.num_leaves = len(_levels[0])
            return
        n = len(leaves) if leaves is not None else 0
        if n == 0 or (n & (n - 1)) != 0:
            raise ValueError(f"Merkle leaf count must be a power of two, got {n}")
        self.num_leaves = n
        level0 = np.frombuffer(
            b"".join(_hash_leaf(leaf) for leaf in leaves), dtype=np.uint8
        ).reshape(n, HASH_BYTES)
        self._levels = _finish_levels([level0])

    @classmethod
    def from_u64_pairs(cls, v_lo: np.ndarray, v_hi: np.ndarray) -> "MerkleTree":
        """The tree over leaves pack("<QQ", v_lo[i], v_hi[i]), as
        ``MerkleTree`` of those leaves gives it."""
        return build_forest_u64_pairs(np.asarray(v_lo, dtype=np.uint64)[None],
                                      np.asarray(v_hi, dtype=np.uint64)[None])[0]

    @property
    def root(self) -> bytes:
        return self._levels[-1][0].tobytes()

    def path(self, index: int) -> List[bytes]:
        """Sibling hashes from the leaf level up to (excluding) the root."""
        if not 0 <= index < self.num_leaves:
            raise IndexError(f"leaf index {index} out of range")
        out: List[bytes] = []
        for level in self._levels[:-1]:
            out.append(level[index ^ 1].tobytes())
            index >>= 1
        return out


def _leaf_blobs(vals: np.ndarray) -> List[MerkleTree]:
    """(T, half, width) uint64 leaf words -> T trees, leaf i the LE bytes of
    row i."""
    t, half, width = vals.shape
    if half == 0 or half & (half - 1):
        raise ValueError(f"Merkle leaf count must be a power of two, got {half}")
    blob = np.ascontiguousarray(vals, dtype="<u8").tobytes()
    size = 8 * width
    return [MerkleTree([blob[(ti * half + i) * size: (ti * half + i + 1) * size]
                        for i in range(half)]) for ti in range(t)]


def build_forest_u64_pairs(v_lo: np.ndarray, v_hi: np.ndarray) -> List[MerkleTree]:
    """T trees from uint64 (T, half) arrays: leaf i of tree t is
    pack("<QQ", v_lo[t, i], v_hi[t, i])."""
    return _leaf_blobs(np.stack([np.asarray(v_lo, dtype=np.uint64),
                                 np.asarray(v_hi, dtype=np.uint64)], axis=2))


def build_forest_u64_groups(vals: np.ndarray) -> List[MerkleTree]:
    """T interleaved-group trees from uint64 (T, G, n): leaf i of tree t is
    concat_g pack("<QQ", vals[t, g, i], vals[t, g, i + n/2])."""
    vals = np.asarray(vals, dtype=np.uint64)
    half = vals.shape[2] // 2
    pairs = np.stack([vals[:, :, :half], vals[:, :, half:]], axis=3)  # (T, G, half, 2)
    return _leaf_blobs(pairs.transpose(0, 2, 1, 3).reshape(vals.shape[0], half, -1))


def verify_path(root: bytes, index: int, leaf_data: bytes, path) -> bool:
    """Check that ``leaf_data`` sits at ``index`` under ``root``; ``path`` is
    a sequence of 32-byte sibling digests or one contiguous blob of them,
    bottom-up."""
    if isinstance(path, (bytes, bytearray)):
        if len(path) % HASH_BYTES:
            return False
        path = [path[i: i + HASH_BYTES] for i in range(0, len(path), HASH_BYTES)]
    node = _hash_leaf(leaf_data)
    for sibling in path:
        if len(sibling) != HASH_BYTES:
            return False
        if index & 1:
            node = _hash_node(sibling, node)
        else:
            node = _hash_node(node, sibling)
        index >>= 1
    return node == root
