"""Kernels S and F of the FRI chain (``csrc/fri.cu``) at the level the CPU
can check, exact, small sizes:

- (a) a numpy model of ``KeccakWarp`` (``csrc/keccak_f.cuh``): one Keccak
  lane per lane of a warp, every shuffle a gather by its source-lane index
  array (the kernel's formulas), rho as its half swap and two 32-bit funnel
  shifts, against ``keccak_f_plain`` and ``hashlib.sha3_256``;
- (b) the host-built constant lanes of a squeeze (``squeeze_lanes``) with
  the state and the counter written in as the kernels write them, against
  ``_sponge_plain``'s padded block, for every label length and at counters
  that cross a byte boundary;
- (c) kernel F's chain twin (``fold_squeeze_plain``: absorb the root,
  squeeze, reduce, fold) against the old sequence of separate twins and
  hashlib, and kernel S's tail twin (``transcript_final_queries_plain``)
  against an absorb then squeezes and hashlib, at those counters;
- (d) ``kernels.fold_grid``, the rule that spreads a row of kernel F over
  blocks;
- (e) the chain calls kernel F's chain entry once a layer and kernel S
  once a batch, and no other S or F entry.
"""

import hashlib
import struct

import numpy as np
import pytest
import torch

from lambda_snark_tpu_torch import kernels
from lambda_snark_tpu_torch.ops import fri_fold, keccak, modarith
from lambda_snark_tpu_torch.proof import fri_device
from lambda_snark_tpu_torch.proof.fri import FriParams, FriTranscript, coset_offset, root_of_order

P = modarith.GOLDILOCKS
M32, M64 = (1 << 32) - 1, (1 << 64) - 1
COUNTERS = (1, 255, 256, (1 << 32) - 1, 1 << 32)
RHO = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61, 56,
       14]


# --- (a) the warp permutation ------------------------------------------------


def warp_sources():
    """KeccakWarp's per-lane constants for the 32 lanes of a warp, as index
    arrays (lane t >= 25 takes t - 25's, as the kernel does)."""
    t = np.array([lane if lane < 25 else lane - 25 for lane in range(32)])
    x, y = t % 5, t // 5
    col = [(t + 5 * (k + 1)) % 25 for k in range(4)]
    pi = [((x + d) % 5 + 3 * y) % 5 + 5 * ((x + d) % 5) for d in range(3)]
    rho = np.array([RHO[i] for i in t])
    return dict(col=col, left=(x + 4) % 5, right=(x + 1) % 5, pi=pi, shift=rho & 31,
                swap=rho >= 32, first=np.arange(32) == 0)


def _funnel_left(lo: int, hi: int, s: int) -> int:
    """__funnelshift_l(lo, hi, s): the high 32 bits of (hi:lo) << s."""
    return (((hi << 32) | lo) << s >> 32) & M32


def warp_permute(a):
    """Keccak-f on a warp's 32 words (lane t < 25 holds lane t of the state),
    round by round as KeccakWarp::permute runs them."""
    src = warp_sources()
    a = [int(v) for v in a]
    rotl = lambda v, r: ((v << r) | (v >> (64 - r))) & M64
    for rc in keccak._RC:
        for sources in src["col"] + [src["left"], src["right"]] + src["pi"]:
            assert max(sources) < 25  # no lane reads lanes 25-31
        gather = lambda v, idx: [v[i] for i in idx]
        c = list(a)
        for sources in src["col"]:
            c = [ci ^ si for ci, si in zip(c, gather(a, sources))]
        cl, cr = gather(c, src["left"]), gather(c, src["right"])
        b = []
        for lane in range(32):
            v = a[lane] ^ cl[lane] ^ rotl(cr[lane], 1)
            lo, hi = v & M32, v >> 32
            h, l = (lo, hi) if src["swap"][lane] else (hi, lo)
            s = int(src["shift"][lane])
            b.append((_funnel_left(l, h, s) << 32) | _funnel_left(h, l, s))
        b0, b1, b2 = (gather(b, p) for p in src["pi"])
        a = [u ^ (~v & M64 & w) for u, v, w in zip(b0, b1, b2)]
        a[0] ^= rc
    return a


def _plain_permute(lanes):
    out = keccak.keccak_f_plain([modarith.to_words(np.array([v], dtype=np.uint64))
                                 for v in lanes])
    return [int(modarith.to_u64(v)[0]) for v in out]


@pytest.mark.parametrize("seed", range(4))
def test_warp_model_equals_keccak_f_plain(seed):
    rng = np.random.default_rng(seed)
    state = [int(v) for v in rng.integers(0, 1 << 64, size=25, dtype=np.uint64, endpoint=False)]
    got = warp_permute(state + [int(v) for v in rng.integers(0, 1 << 64, size=7, dtype=np.uint64,
                                                              endpoint=False)])
    assert got[:25] == _plain_permute(state)


@pytest.mark.parametrize("length", [0, 46, 78, 135])
def test_warp_model_equals_hashlib(length):
    """One rate block absorbed into the zero state and permuted on the
    model: its first 4 lanes are SHA3-256 of the message."""
    rng = np.random.default_rng(length)
    msg = bytes(rng.integers(0, 256, size=length, dtype=np.uint8))
    block = bytearray(msg.ljust(136, b"\0"))
    block[length] ^= 0x06
    block[135] ^= 0x80
    lanes = list(np.frombuffer(bytes(block), dtype="<u8")) + [0] * 15
    digest = warp_permute(lanes)[:4]
    assert struct.pack("<4Q", *digest) == hashlib.sha3_256(msg).digest()


def test_warp_sources_are_the_pi_and_chi_neighbours():
    """The model's gather indices are keccak_f_plain's pi source and chi
    neighbours, and rho's amounts its rotation table."""
    src = warp_sources()
    for i in range(25):
        assert src["pi"][0][i] == keccak._PI_SRC[i]
        assert src["pi"][1][i] == keccak._PI_SRC[keccak._CHI_1[i]]
        assert src["pi"][2][i] == keccak._PI_SRC[keccak._CHI_2[i]]
        assert src["shift"][i] + 32 * src["swap"][i] == keccak._ROT[i]


# --- (b) the squeeze's constant lanes ------------------------------------------


@pytest.mark.parametrize("label", [b"", b"fri-fold", b"fri-query", b"x" * 7, b"y" * 16])
@pytest.mark.parametrize("counter", COUNTERS + (M64,))
def test_squeeze_lanes_equal_the_padded_block(label, counter):
    """The block a kernel builds (squeeze_lanes, the 4 state words in lanes
    0-3, LE64(counter) ORed in at its lane and byte) is _sponge_plain's
    padded block of state || label || LE64(counter)."""
    rng = np.random.default_rng(len(label))
    state = rng.integers(0, 1 << 64, size=(1, 4), dtype=np.uint64, endpoint=False)
    lanes, lane, shift = keccak.squeeze_lanes(label)
    got = [int(v) for v in lanes]
    assert got[:4] == [0] * 4 and lanes.dtype == np.uint64 and 4 <= lane and lane + 1 < 17
    got[:4] = [int(v) for v in state[0]]
    got[lane] |= (counter << 8 * shift) & M64
    if shift:
        got[lane + 1] |= counter >> (64 - 8 * shift)
    blocks = keccak._padded_lanes(modarith.to_words(state), label,
                                  modarith.to_words(np.array([[counter]], dtype=np.uint64)))
    assert len(blocks) == 1
    assert got == [int(modarith.to_u64(v)[0]) for v in blocks[0]]


# --- (c) the fused twins ----------------------------------------------------------


def _words(rng, shape, high=1 << 64):
    return modarith.to_words(rng.integers(0, high, size=shape, dtype=np.uint64, endpoint=False))


@pytest.mark.parametrize("counter", COUNTERS)
@pytest.mark.parametrize("with_root", [False, True])
def test_fold_squeeze_twin_equals_the_old_sequence_and_hashlib(counter, with_root):
    rng = np.random.default_rng(counter % 1000 + with_root)
    rows, n = 3, 32
    cur, inv_x, state = _words(rng, (rows, n), P), _words(rng, (n // 2,), P), _words(rng, (rows, 4))
    root = _words(rng, (rows, 4)) if with_root else None
    out, new = fri_fold.fold_squeeze(cur, inv_x, state, counter, root)
    # the old sequence: kernel S's absorb and squeeze, then kernel F
    old = state if root is None else keccak.transcript_absorb(state, b"fri-layer-root", root)
    old, cs = keccak.transcript_squeeze_field(old, b"fri-fold", counter)
    assert torch.equal(new, old) and torch.equal(out, fri_fold.fold(cur, inv_x, cs))
    # hashlib
    want_cs = []
    for i, st in enumerate(modarith.to_u64(state)):
        st = st.tobytes()
        if with_root:
            st += b"fri-layer-root" + modarith.to_u64(root[i]).tobytes()
            st = hashlib.sha3_256(st).digest()
        st = hashlib.sha3_256(st + b"fri-fold" + struct.pack("<Q", counter)).digest()
        assert modarith.to_u64(new[i]).tobytes() == st
        want_cs.append(int.from_bytes(st[:8], "little") % P)
    assert modarith.to_u64(cs).tolist() == want_cs


@pytest.mark.parametrize("counter", COUNTERS)
@pytest.mark.parametrize("final_len", [4, 64])
def test_final_queries_twin_equals_absorb_then_squeezes_and_hashlib(counter, final_len):
    rng = np.random.default_rng(final_len + counter % 997)
    state, fin = _words(rng, (2, 4)), _words(rng, (2, final_len), P)
    new, idx = keccak.transcript_final_queries(state, b"fri-final", fin, final_len, b"fri-query",
                                               counter, 5, 1 << 12)
    old = keccak.transcript_absorb(state, b"fri-final", fin, final_len)
    old, old_idx = keccak.transcript_squeeze_indices(old, b"fri-query", counter, 5, 1 << 12)
    assert torch.equal(new, old) and torch.equal(idx, old_idx)
    for i, st in enumerate(modarith.to_u64(state)):
        st = hashlib.sha3_256(st.tobytes() + b"fri-final" + struct.pack("<Q", final_len)
                              + modarith.to_u64(fin[i]).tobytes()).digest()
        want = []
        for k in range(5):
            st = hashlib.sha3_256(st + b"fri-query" + struct.pack("<Q", counter + k)).digest()
            want.append(int.from_bytes(st[:8], "little") & ((1 << 12) - 1))
        assert modarith.to_u64(idx[i]).tolist() == want
        assert modarith.to_u64(new[i]).tobytes() == st


def test_final_queries_refuses_a_bad_bound():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):
        keccak.transcript_final_queries(_words(rng, (1, 4)), b"fri-final", _words(rng, (1, 4)), 4,
                                        b"fri-query", 1, 3, 24)


def test_fold_squeeze_refuses_mismatched_rows():
    rng = np.random.default_rng(1)
    cur, inv_x = _words(rng, (2, 16), P), _words(rng, (8,), P)
    with pytest.raises(ValueError):
        fri_fold.fold_squeeze(cur, inv_x, _words(rng, (3, 4)), 1)
    with pytest.raises(ValueError):
        fri_fold.fold_squeeze(cur, inv_x, _words(rng, (2, 4)), 1, _words(rng, (2, 3)))


# --- (d) the grid rule ----------------------------------------------------------------


@pytest.mark.parametrize("rows,half,want", [
    (16, 1 << 15, 4),  # k7a's first layer: 16 blocks a row, 256 in all
    (16, 1 << 16, 4),  # k7b's
    (16, 256, 0),  # k7a's last: one block a row
    (1, 1 << 15, 6),  # agg13's first: 64 blocks
    (1, 1 << 17, 8),  # kind 9's first: 256 blocks
    (128, 1 << 12, 1),  # agg10's first
    (32, 1 << 15, 3),  # a pipelined chunk's first
    (1, 1, 0),
    (300, 1 << 15, 0),  # more rows than fit at once: a block a row
])
def test_fold_grid_rule(rows, half, want):
    assert kernels.fold_grid(rows, half) == want


@pytest.mark.parametrize("rows", [1, 2, 3, 16, 32, 128, 264, 1000])
def test_fold_grid_invariants(rows):
    for log_half in range(0, 21):
        half = 1 << log_half
        blocks = 1 << kernels.fold_grid(rows, half)
        assert blocks <= max(1, half // kernels.FOLD_BLOCK_WORDS)
        assert blocks == 1 or rows * blocks <= kernels.SM_COUNT * kernels.FOLD_BLOCKS_PER_SM


# --- (e) the chain's launches -------------------------------------------------------------


def test_chain_calls_one_fold_entry_a_layer_and_one_sponge_launch(monkeypatch):
    calls = []
    for module, name in ((fri_fold, "fold_squeeze"), (fri_fold, "fold"),
                         (keccak, "transcript_final_queries"), (keccak, "transcript_absorb"),
                         (keccak, "transcript_squeeze")):
        real = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda *a, _r=real, _n=name, **k: (calls.append(_n), _r(*a, **k))[1])
    rng = np.random.default_rng(2)
    s, n0 = 2, 256
    params = FriParams(log_blowup=2, num_queries=4, final_len=4)
    g = modarith.to_words(np.zeros((s, n0), dtype=np.uint64))
    vals = _words(rng, (s, 4, n0), P)
    trs = []
    for i in range(s):
        tr = FriTranscript()
        tr.absorb(b"case", bytes([i]))
        trs.append(tr)
    fri_device.fri_chain_dispatch(g, [(vals, fri_device.commit_planes_dev_groups(vals))],
                                  coset_offset(P), root_of_order(P, n0), P, params, trs)
    # d_bound 64 -> final_len 4: four folds, one tail
    assert calls == ["fold_squeeze"] * 4 + ["transcript_final_queries"]
