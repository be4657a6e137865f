"""Kernel K's plain twin (``lambda_snark_tpu_torch.ops.keccak``) and the
port's Merkle trees against the JAX package: ``keccak_pallas.hash_leaves``,
``hash_leaves_flex`` and ``hash_nodes`` (which run ``keccak_jax`` on the
CPU), the host ``MerkleTree`` and ``hashlib.sha3_256``. Every comparison is
exact."""

import hashlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lambda_snark_tpu.ops import keccak_jax as kj
from lambda_snark_tpu.ops import keccak_pallas as kp
from lambda_snark_tpu.proof import merkle as jax_merkle

from lambda_snark_tpu_torch.ops import keccak, modarith
from lambda_snark_tpu_torch.proof import merkle
from lambda_snark_tpu_torch.proof.fri_device import (
    commit_planes_dev,
    commit_planes_dev_groups,
    digest_bytes,
)


def _u64(shape, seed):
    return np.random.default_rng(seed).integers(0, 1 << 64, size=shape, dtype=np.uint64,
                                                endpoint=False)


def _jax_digests(words8) -> np.ndarray:
    """JAX digest words [8, ...] uint32 -> uint8 [..., 32]."""
    return kj.digest_words_to_bytes(np.moveaxis(np.asarray(words8), 0, -1))


def _u32(v: np.ndarray):
    return (jnp.asarray((v & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
            jnp.asarray((v >> np.uint64(32)).astype(np.uint32)))


@pytest.mark.parametrize("g", range(1, 9))
def test_group_leaves_match_jax_and_hashlib(g):
    vals = _u64((2, g, 16), seed=g)
    got = digest_bytes(keccak.hash_leaves_flex(modarith.to_words(vals)))
    want = _jax_digests(kp.hash_leaves_flex([jnp.asarray(w) for w in kj.group_leaf_words(vals)]))
    assert np.array_equal(got, want)
    for t in range(2):
        for i in (0, 5, 7):
            msg = b"\x00" + b"".join(struct.pack("<QQ", int(vals[t, k, i]), int(vals[t, k, i + 8]))
                                     for k in range(g))
            assert got[t, i].tobytes() == hashlib.sha3_256(msg).digest()


def test_paired_leaves_match_jax():
    values = _u64((3, 32), seed=11)
    got = digest_bytes(keccak.hash_leaves(modarith.to_words(values)))
    a0, a1 = _u32(values[:, :16])
    b0, b1 = _u32(values[:, 16:])
    assert np.array_equal(got, _jax_digests(kp.hash_leaves(a0, a1, b0, b1)))


def test_nodes_match_jax_and_hashlib():
    level = _u64((2, 16, 4), seed=12)
    got = digest_bytes(keccak.hash_nodes(modarith.to_words(level)))
    w32 = np.moveaxis(level.view(np.uint32), -1, 0)  # [8, T, rows]
    want = _jax_digests(kp.hash_nodes(jnp.asarray(w32[..., 0::2]), jnp.asarray(w32[..., 1::2])))
    assert np.array_equal(got, want)
    raw = level.view(np.uint8)
    assert got[1, 3].tobytes() == hashlib.sha3_256(
        b"\x01" + raw[1, 6].tobytes() + raw[1, 7].tobytes()).digest()


@pytest.mark.parametrize("g,n", [(4, 64), (1, 32)])
def test_device_forest_matches_host_tree(g, n):
    vals = _u64((3, g, n), seed=100 + g)
    forest = (commit_planes_dev_groups(modarith.to_words(vals)) if g > 1
              else commit_planes_dev(modarith.to_words(vals[:, 0])))
    half = n // 2
    for t in range(3):
        leaves = [b"".join(struct.pack("<QQ", int(vals[t, k, i]), int(vals[t, k, i + half]))
                           for k in range(g)) for i in range(half)]
        ours = merkle.MerkleTree(leaves)
        theirs = jax_merkle.MerkleTree(leaves)
        assert forest.roots[t] == ours.root == theirs.root
        levels = [digest_bytes(lvl[t]) for lvl in forest.levels]
        for i in (0, 3, half - 1):
            path = [levels[d][(i >> d) ^ 1].tobytes() for d in range(len(levels) - 1)]
            assert path == ours.path(i) == theirs.path(i)
            assert merkle.verify_path(ours.root, i, leaves[i], b"".join(path))
            assert not merkle.verify_path(ours.root, i ^ 1, leaves[i], path)


def test_finish_levels_matches_jax():
    leaves = [bytes([i]) * 16 for i in range(8)]
    level0 = np.frombuffer(b"".join(merkle._hash_leaf(x) for x in leaves),
                           dtype=np.uint8).reshape(8, 32)
    ours = merkle._finish_levels([level0.copy()])
    theirs = jax_merkle._finish_levels([level0.copy()])
    assert all(np.array_equal(a, b) for a, b in zip(ours, theirs))
    with pytest.raises(ValueError):
        merkle.MerkleTree([b"a", b"b", b"c"])


@pytest.mark.parametrize("bad", ["too_many", "odd", "dtype", "node_shape"])
def test_wrappers_reject(bad):
    if bad == "too_many":
        with pytest.raises(ValueError):
            keccak.hash_leaves_flex(torch.zeros((1, 9, 8), dtype=torch.int64))
    elif bad == "odd":
        with pytest.raises(ValueError):
            keccak.hash_leaves(torch.zeros((1, 7), dtype=torch.int64))
    elif bad == "dtype":
        with pytest.raises(ValueError):
            keccak.hash_leaves(torch.zeros((1, 8), dtype=torch.int32))
    else:
        with pytest.raises(ValueError):
            keccak.hash_nodes(torch.zeros((1, 4, 3), dtype=torch.int64))


# --- whole forests: kernel K's forest entries (one launch per forest) --------

# (G, leaves per tree): G = 1 is the paired FRI leaf; trees from 2 leaves to
# 2^12, smaller and larger than the kernel's 2^8-leaf subtree block
_FORESTS = [(1, 2), (1, 256), (1, 4096), (2, 4), (2, 512), (4, 64), (4, 2048),
            (8, 2), (8, 1024), (3, 16)]


@pytest.mark.parametrize("g,half", _FORESTS)
def test_forest_matches_jax_levels_and_host_tree(g, half):
    """The forest twin's level-major buffer, level by level, equals the JAX
    package's ``merkle_levels_u64_pairs`` / ``merkle_levels_u64_groups`` and
    the host ``MerkleTree``; ``commit_planes_dev*`` hand back its views."""
    vals = _u64((2, g, 2 * half), seed=1000 * g + half)
    words = modarith.to_words(vals)
    levels = (keccak.merkle_forest(words[:, 0].contiguous()) if g == 1
              else keccak.merkle_forest_flex(words))
    if g == 1:
        want = kj.merkle_levels_u64_pairs(vals[:, 0, :half], vals[:, 0, half:])
    else:
        want = kj.merkle_levels_u64_groups(vals)
    assert len(levels) == len(want) == half.bit_length()
    for ours, theirs in zip(levels, want):
        assert np.array_equal(digest_bytes(ours), kj.digest_words_to_bytes(np.asarray(theirs)))
    forest = (commit_planes_dev(words[:, 0].contiguous()) if g == 1
              else commit_planes_dev_groups(words))
    assert all(torch.equal(a, b) for a, b in zip(forest.levels, levels))
    for t in range(2):
        leaves = [b"".join(struct.pack("<QQ", int(vals[t, k, i]), int(vals[t, k, i + half]))
                           for k in range(g)) for i in range(half)]
        tree = merkle.MerkleTree(leaves)
        assert forest.roots[t] == tree.root
        i = half - 1
        path = [digest_bytes(lvl[t])[(i >> d) ^ 1].tobytes()
                for d, lvl in enumerate(forest.levels[:-1])]
        assert path == tree.path(i)


@pytest.mark.parametrize("trees,half", [(1, 2), (3, 8), (16, 64)])
def test_forest_levels_are_views_of_one_level_major_buffer(trees, half):
    """Level l is the contiguous (T, half >> l, 4) block at word
    4 T (2 half - 2 half / 2^l) of one buffer of 4 T (2 half - 1) words."""
    vals = modarith.to_words(_u64((trees, 2, 2 * half), seed=trees))
    levels = keccak.merkle_forest_flex(vals)
    base = levels[0]._base
    assert base.numel() == 4 * trees * (2 * half - 1)
    for lvl, level in enumerate(levels):
        rows = half >> lvl
        assert level.shape == (trees, rows, 4) and level.is_contiguous()
        assert level._base is base
        assert level.storage_offset() == 4 * trees * (2 * half - (2 * half >> lvl))
    assert torch.equal(levels[-1], keccak.merkle_levels(keccak.hash_leaves_flex(vals))[-1])


@pytest.mark.parametrize("bad", ["not_pow2", "too_short", "too_many", "dtype"])
def test_forest_wrappers_reject(bad):
    with pytest.raises(ValueError):
        if bad == "not_pow2":
            keccak.merkle_forest(torch.zeros((1, 12), dtype=torch.int64))
        elif bad == "too_short":
            keccak.merkle_forest(torch.zeros((1, 2), dtype=torch.int64))
        elif bad == "too_many":
            keccak.merkle_forest_flex(torch.zeros((1, 9, 8), dtype=torch.int64))
        else:
            keccak.merkle_forest_flex(torch.zeros((1, 2, 8), dtype=torch.int32))
