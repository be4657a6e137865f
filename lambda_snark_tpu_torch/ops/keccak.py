"""Batched SHA3-256: kernel K (``csrc/keccak.cu``, Merkle hashing), kernel
S (``csrc/fri.cu``, the FRI transcript sponge) and their plain PyTorch
twins.

Three single-block messages, the Merkle layer of the FRI proofs:

- ``hash_leaves(values)``: values (T, n) words; leaf i of tree t is
  0x00 || LE64(v[t, i]) || LE64(v[t, i + n/2]) (a FRI fold layer);
- ``hash_leaves_flex(vals)``: vals (T, G, n) words, G <= 8; leaf i of tree t
  is 0x00 || concat_g LE64(v[t, g, i]) || LE64(v[t, g, i + n/2]) (the
  interleaved input-oracle group);
- ``hash_nodes(level)``: level (T, rows, 4) digests -> (T, rows/2, 4),
  node j = 0x01 || digest[2j] || digest[2j+1].

``merkle_forest(values)`` / ``merkle_forest_flex(vals)`` build whole Merkle
forests, every level from the leaves of ``hash_leaves`` /
``hash_leaves_flex`` up to the roots, in one launch of kernel K (entries
``keccak_forest`` / ``keccak_group_forest``). The levels come back as views
of one level-major buffer: level l is a contiguous (T, half >> l, 4) block.
``merkle_levels`` is the per-level route (one ``hash_nodes`` launch per
level) that the forest entries replace on the proving path; it stays as
the yardstick they are timed against.

A digest is 4 LE64 words (int64 bit patterns), so ``to_u64(d).view(uint8)``
is its 32 bytes. Kernel K replaces the TPU kernel
``keccak_pallas._hash_call`` (ops/keccak_pallas.py:242) behind
``hash_leaves`` / ``hash_leaves_flex`` / ``hash_nodes`` and the forest
wrappers. The wrappers launch it for CUDA tensors and run the ``*_plain``
twins for CPU tensors.

Kernel S runs ``proof.fri.FriTranscript``'s SHA3-256 ratchet for S
statements at once, states (S, 4) words on the device:
``transcript_absorb`` (SHA3-256(state || label || head || payload), the
layer roots and ``fri-final``) and ``transcript_squeeze`` (squeezes of
label || LE64(counter) in a row: the fold challenges reduced mod p, the
query indices masked). It is the counterpart of the JAX package's
``_sha3_bytes_dev`` / ``DevTranscript`` / ``_challenge_planes``
(lambda_snark_tpu/proof/fri_device.py:678-779), XLA device functions; its
twins are ``transcript_absorb_plain`` and ``transcript_squeeze_plain``, a
sponge over ``keccak_f_plain``.

The twins keep each 64-bit lane as one int64 tensor: ``<<`` wraps mod 2^64,
and the arithmetic ``>>`` is masked to the bits a logical shift would give.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import kernels

#: Oracles per interleaved group leaf: 8 give 129-byte messages, the most
#: that fit one 136-byte SHA3-256 rate block.
MAX_GROUP_ORACLES = 8

_ROT_XY = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
_ROT = [_ROT_XY[i % 5][i // 5] for i in range(25)]  # lane i = x + 5y
_PI_SRC = [((i % 5) + 3 * (i // 5)) % 5 + 5 * (i % 5) for i in range(25)]
_CHI_1 = [(i % 5 + 1) % 5 + 5 * (i // 5) for i in range(25)]
_CHI_2 = [(i % 5 + 2) % 5 + 5 * (i // 5) for i in range(25)]
_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]


def _signed(v: int) -> int:
    """A u64 constant as the int64 with the same bits."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return x if r == 0 else (x << r) | _shr(x, 64 - r)


def keccak_f_plain(a: List[torch.Tensor]) -> List[torch.Tensor]:
    """Keccak-f[1600] on 25 int64 lane tensors a[x + 5y]."""
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x + 4) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        b = [_rotl(a[s] ^ d[s % 5], _ROT[s]) for s in _PI_SRC]
        a = [b[i] ^ (~b[_CHI_1[i]] & b[_CHI_2[i]]) for i in range(25)]
        a[0] = a[0] ^ _signed(rc)
    return a


def _digest_plain(prefix: int, words: List[torch.Tensor]) -> torch.Tensor:
    """SHA3-256 of prefix || LE64(words...) (one rate block) -> (..., 4)."""
    p = len(words)
    zero = torch.zeros_like(words[0])
    a = [zero] * 25
    a[0] = (words[0] << 8) | prefix
    for k in range(1, p):
        a[k] = _shr(words[k - 1], 56) | (words[k] << 8)
    a[p] = _shr(words[p - 1], 56) | (0x06 << 8)
    a[16] = a[16] ^ _signed(0x80 << 56)
    return torch.stack(keccak_f_plain(a)[:4], dim=-1)


def hash_leaves_flex_plain(vals: torch.Tensor) -> torch.Tensor:
    half = vals.shape[-1] // 2
    words = []
    for g in range(vals.shape[1]):
        words += [vals[:, g, :half], vals[:, g, half:]]
    return _digest_plain(0x00, words)


def hash_leaves_plain(values: torch.Tensor) -> torch.Tensor:
    return hash_leaves_flex_plain(values[:, None, :])


def hash_nodes_plain(level: torch.Tensor) -> torch.Tensor:
    pairs = level.reshape(level.shape[0], level.shape[1] // 2, 8)
    return _digest_plain(0x01, list(pairs.unbind(-1)))


def _check(x: torch.Tensor, dims: int, what: str) -> None:
    if x.dtype != torch.int64 or x.dim() != dims:
        raise ValueError(f"{what}: expected {dims}-d int64 words, got {x.dtype} {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: input must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _leaves(vals: torch.Tensor, paired: bool) -> torch.Tensor:
    t, g, n = vals.shape
    if not 1 <= g <= MAX_GROUP_ORACLES:
        raise ValueError(f"group of {g} oracles: 1..{MAX_GROUP_ORACLES} fit one Keccak block")
    if n < 2 or n % 2:
        raise ValueError(f"codeword length {n} must be even and >= 2")
    if vals.device.type == "cpu":
        return hash_leaves_flex_plain(vals)
    out = torch.empty((t, n // 2, 4), dtype=torch.int64, device=vals.device)
    if out.numel() == 0:
        return out
    lib = kernels.load("keccak")
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream().cuda_stream
        if paired:
            entry, rc = "keccak_leaves", lib.keccak_leaves(
                vals.data_ptr(), out.data_ptr(), t, n // 2, stream)
        else:
            entry, rc = "keccak_group_leaves", lib.keccak_group_leaves(
                vals.data_ptr(), out.data_ptr(), t, g, n // 2, stream)
    kernels.check(rc, f"kernel K ({entry})")
    kernels.count(entry, 1, vals.shape)
    return out


def hash_leaves_flex(vals: torch.Tensor) -> torch.Tensor:
    """Group-leaf digests (T, n/2, 4) of vals (T, G, n) words, G <= 8."""
    _check(vals, 3, "hash_leaves_flex")
    return _leaves(vals, paired=False)


def hash_leaves(values: torch.Tensor) -> torch.Tensor:
    """Paired-leaf digests (T, n/2, 4) of values (T, n) words."""
    _check(values, 2, "hash_leaves")
    return _leaves(values[:, None, :], paired=True)


def hash_nodes(level: torch.Tensor) -> torch.Tensor:
    """One Merkle level up: (T, rows, 4) digests -> (T, rows/2, 4)."""
    _check(level, 3, "hash_nodes")
    t, rows, four = level.shape
    if four != 4 or rows < 2 or rows % 2:
        raise ValueError(f"hash_nodes: expected (T, even rows, 4), got {tuple(level.shape)}")
    if level.device.type == "cpu":
        return hash_nodes_plain(level)
    out = torch.empty((t, rows // 2, 4), dtype=torch.int64, device=level.device)
    fn = kernels.load("keccak").keccak_nodes
    with torch.cuda.device(level.device):
        rc = fn(level.data_ptr(), out.data_ptr(), t * (rows // 2),
                torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "kernel K (keccak_nodes)")
    kernels.count("keccak_nodes", 1, level.shape)
    return out


def merkle_levels(leaves: torch.Tensor) -> List[torch.Tensor]:
    """Leaf digests (T, half, 4) -> every level up to the root (T, 1, 4),
    one ``hash_nodes`` launch per level (the per-level route)."""
    levels = [leaves]
    while levels[-1].shape[1] > 1:
        levels.append(hash_nodes(levels[-1]))
    return levels


def forest_views(buf: torch.Tensor, trees: int, half: int) -> List[torch.Tensor]:
    """The levels of a level-major forest buffer of 4 T (2 half - 1) words:
    level l is the (T, half >> l, 4) view at word 4 T (2 half - 2 half / 2^l),
    leaf level first, root level (T, 1, 4) last."""
    levels, off, rows = [], 0, half
    while rows >= 1:
        levels.append(buf.as_strided((trees, rows, 4), (4 * rows, 4, 1), off))
        off += 4 * trees * rows
        rows //= 2
    return levels


def merkle_forest_flex_plain(vals: torch.Tensor) -> List[torch.Tensor]:
    """The twin of ``merkle_forest_flex``: the leaf twin, then
    ``hash_nodes_plain`` per level, written into the same buffer layout."""
    t, _, n = vals.shape
    buf = torch.empty(4 * t * (n - 1), dtype=torch.int64, device=vals.device)
    levels = forest_views(buf, t, n // 2)
    levels[0].copy_(hash_leaves_flex_plain(vals))
    for lo, hi in zip(levels, levels[1:]):
        hi.copy_(hash_nodes_plain(lo))
    return levels


def merkle_forest_plain(values: torch.Tensor) -> List[torch.Tensor]:
    return merkle_forest_flex_plain(values[:, None, :])


#: Leaves each thread of a forest launch hashes, log2, before the block
#: joins the threads' subtree roots: at most 5 (2^5 leaves and 2^5 - 1
#: nodes per thread), lowered so that a forest still gives 2^14 threads:
#: more leaves a thread keep its lanes busy longer against the block's
#: partly idle upper levels, fewer keep a small forest's card full.
FOREST_LOG_LEAVES_PER_THREAD = 5
_FOREST_MIN_LOG_THREADS = 14


def forest_log_thread(trees: int, half: int) -> int:
    """log2 of the leaves a forest launch gives each thread."""
    log_leaves = (trees * half).bit_length() - 1
    return max(0, min(FOREST_LOG_LEAVES_PER_THREAD, log_leaves - _FOREST_MIN_LOG_THREADS))


_TICKETS: Dict[Tuple[str, int], torch.Tensor] = {}


def _tickets(device: torch.device, stream: int, trees: int) -> torch.Tensor:
    """Per device and stream, at least ``trees`` int32 ticket counters for
    the forest entries. They are zeroed once, here; each launch leaves them
    zeroed again (the last block of a tree resets its ticket)."""
    key = (str(device), stream)
    have = _TICKETS.get(key)
    if have is None or have.numel() < trees:
        have = torch.zeros(max(trees, 64), dtype=torch.int32, device=device)
        _TICKETS[key] = have
    return have


def _forest(vals: torch.Tensor, paired: bool) -> List[torch.Tensor]:
    t, g, n = vals.shape
    if not 1 <= g <= MAX_GROUP_ORACLES:
        raise ValueError(f"group of {g} oracles: 1..{MAX_GROUP_ORACLES} fit one Keccak block")
    if n < 4 or n & (n - 1):
        raise ValueError(f"codeword length {n} must be a power of two >= 4")
    if vals.device.type == "cpu":
        return merkle_forest_flex_plain(vals)
    buf = torch.empty(4 * t * (n - 1), dtype=torch.int64, device=vals.device)
    if t == 0:
        return forest_views(buf, t, n // 2)
    lib = kernels.load("keccak")
    log_half = n.bit_length() - 2
    log_thread = forest_log_thread(t, n // 2)
    tickets = _tickets(vals.device, kernels.stream_handle(vals.device), t)
    if paired:
        entry, rc = "keccak_forest", kernels.launch(
            vals.device, lib.keccak_forest, vals.data_ptr(), buf.data_ptr(),
            tickets.data_ptr(), t, log_half, log_thread)
    else:
        entry, rc = "keccak_group_forest", kernels.launch(
            vals.device, lib.keccak_group_forest, vals.data_ptr(), buf.data_ptr(),
            tickets.data_ptr(), t, g, log_half, log_thread)
    kernels.check(rc, f"kernel K ({entry})")
    kernels.count(entry, 1, vals.shape)
    return forest_views(buf, t, n // 2)  # made while the card hashes


def merkle_forest_flex(vals: torch.Tensor) -> List[torch.Tensor]:
    """Every level of T group-leaf Merkle trees over vals (T, G, n) words,
    G <= 8, n a power of two >= 4: leaf level (T, n/2, 4) first, roots
    (T, 1, 4) last, views of one level-major buffer."""
    _check(vals, 3, "merkle_forest_flex")
    return _forest(vals, paired=False)


def merkle_forest(values: torch.Tensor) -> List[torch.Tensor]:
    """Every level of T paired-leaf Merkle trees over values (T, n) words
    (leaf i pairs values i and i + n/2), as ``merkle_forest_flex``."""
    _check(values, 2, "merkle_forest")
    return _forest(values[:, None, :], paired=True)


# --- kernel S: the FRI transcript sponge ------------------------------------------

GOLDILOCKS = 18446744069414584321
_RATE_LANES = 17  # a SHA3-256 rate block, 136 bytes
_RATE_BYTES = 8 * _RATE_LANES
_MAX_LABEL = 16  # label bytes: lanes 4 and 5 of the message


def label_lanes(label: bytes) -> Tuple[int, int]:
    """A transcript label's bytes as message lanes 4 and 5 (LE, zero-padded)."""
    if len(label) > _MAX_LABEL:
        raise ValueError(f"transcript label of {len(label)} bytes: at most {_MAX_LABEL}")
    padded = label.ljust(_MAX_LABEL, b"\0")
    return int.from_bytes(padded[:8], "little"), int.from_bytes(padded[8:], "little")


@functools.lru_cache(maxsize=None)
def squeeze_lanes(label: bytes) -> Tuple[np.ndarray, int, int]:
    """The static part of a squeeze's one-block message state || label ||
    LE64(counter): (its 17 lanes with the state lanes 0-3 and the counter
    zero, as uint64; the counter's first lane; its byte shift in that
    lane). The label and the padding (0x06 after the counter, 0x80 in byte
    135) are the same for every statement and counter, so kernel S and F
    take them once a launch and write only the state and the counter. The
    lanes are read-only: one array serves every launch with the label."""
    label_lanes(label)  # refuses a label longer than lanes 4 and 5
    block = bytearray(_RATE_BYTES)
    block[32:32 + len(label)] = label
    block[40 + len(label)] ^= 0x06
    block[_RATE_BYTES - 1] ^= 0x80
    start = 32 + len(label)
    lanes = np.frombuffer(bytes(block), dtype="<u8").astype(np.uint64)
    lanes.flags.writeable = False
    return lanes, start // 8, start % 8


def _padded_lanes(state: torch.Tensor, label: bytes,
                  stream: torch.Tensor) -> List[List[torch.Tensor]]:
    """The padded message state || label || LE64(stream words) per row, as
    its rate blocks of 17 lane tensors (S,): state (S, 4), stream (S, W)."""
    s, width = stream.shape
    base = 32 + len(label)  # the stream's first byte
    length = base + 8 * width
    blocks = length // _RATE_BYTES + 1
    lab = label_lanes(label)
    zero = torch.zeros(s, dtype=torch.int64, device=state.device)

    def word(i: int) -> torch.Tensor:
        return stream[:, i] if 0 <= i < width else zero

    out = []
    for b in range(blocks):
        lanes = []
        for k in range(_RATE_LANES):
            j = b * _RATE_LANES + k
            lane = state[:, j] if j < 4 else zero
            if j in (4, 5):
                lane = lane | _signed(lab[j - 4])
            off = 8 * j - base
            q, r = off >> 3, off & 7
            w = _shr(word(q), 8 * r) | (word(q + 1) << (64 - 8 * r)) if r else word(q)
            lane = lane | w
            if length >> 3 == j:
                lane = lane ^ _signed(0x06 << (8 * (length & 7)))
            if j == blocks * _RATE_LANES - 1:
                lane = lane ^ _signed(0x80 << 56)
            lanes.append(lane)
        out.append(lanes)
    return out


def _sponge_plain(state: torch.Tensor, label: bytes, stream: torch.Tensor) -> torch.Tensor:
    """SHA3-256(state || label || LE64(stream words)) per row: state (S, 4)
    and stream (S, W) words -> digests (S, 4)."""
    zero = torch.zeros(state.shape[0], dtype=torch.int64, device=state.device)
    a = [zero] * 25
    for lanes in _padded_lanes(state, label, stream):
        a = keccak_f_plain([x ^ y for x, y in zip(a, lanes)] + a[_RATE_LANES:])
    return torch.stack(a[:4], dim=1)


def challenge_words(first: torch.Tensor) -> torch.Tensor:
    """A digest's first LE64 word (S,) -> the canonical field challenge: the
    word less p once where it is >= p (it is < 2^64 < 2p), as
    ``FriTranscript.challenge_field`` reduces it mod p."""
    p_signed = _signed(GOLDILOCKS)  # -(2^32 - 1): words >= p are [p_signed, -1]
    over = (first < 0) & (first >= p_signed)
    return first - over.to(torch.int64) * p_signed


def _stream(state: torch.Tensor, payload, head) -> torch.Tensor:
    parts = []
    if head is not None:
        parts.append(torch.full((state.shape[0], 1), _signed(head), dtype=torch.int64,
                                device=state.device))
    if payload is not None:
        parts.append(payload)
    if not parts:
        return state.new_zeros((state.shape[0], 0))
    return torch.cat(parts, dim=1)


def transcript_absorb_plain(state: torch.Tensor, label: bytes, payload=None,
                            head=None) -> torch.Tensor:
    return _sponge_plain(state, label, _stream(state, payload, head))


def transcript_squeeze_plain(state: torch.Tensor, label: bytes, counter: int, count: int,
                             mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    outs = []
    for i in range(count):
        state = _sponge_plain(state, label, _stream(state, None, counter + i))
        first = state[:, 0]
        outs.append(challenge_words(first) if mask is None else first & mask)
    return state, torch.stack(outs, dim=1)


def transcript_final_queries_plain(state: torch.Tensor, final_label: bytes,
                                   payload: torch.Tensor, head: int, query_label: bytes,
                                   counter: int, count: int, mask: int):
    state = transcript_absorb_plain(state, final_label, payload, head)
    return transcript_squeeze_plain(state, query_label, counter, count, mask)


def _check_state(state: torch.Tensor) -> None:
    _check(state, 2, "transcript state")
    if state.shape[1] != 4:
        raise ValueError(f"transcript state: expected (S, 4) words, got {tuple(state.shape)}")


def _check_payload(state: torch.Tensor, payload) -> None:
    if payload is not None:
        _check(payload, 2, "transcript payload")
        if payload.shape[0] != state.shape[0] or payload.device != state.device:
            raise ValueError("transcript payload: one row per state, on the state's device")


def _check_mask(bound: int, count: int) -> int:
    if bound < 1 or bound & (bound - 1) or count < 1:
        raise ValueError(f"index squeeze: bound {bound} must be a power of two, count >= 1")
    return bound - 1


def transcript_absorb(state: torch.Tensor, label: bytes, payload=None,
                      head=None) -> torch.Tensor:
    """The states (S, 4) after absorbing ``label``, the LE64 word ``head``
    (if given) and each statement's payload row (S, W) words:
    SHA3-256(state || label || head || payload) per statement, as
    ``FriTranscript.absorb`` (``absorb_words`` is head = the word count)."""
    _check_state(state)
    _check_payload(state, payload)
    if state.device.type == "cpu":
        return transcript_absorb_plain(state, label, payload, head)
    lo, hi = label_lanes(label)
    words = 0 if payload is None else payload.shape[1]
    out = torch.empty_like(state)
    rc = kernels.launch(state.device, kernels.load("fri").transcript_absorb, state.data_ptr(),
                        out.data_ptr(), 0 if payload is None else payload.data_ptr(), words,
                        0 if head is None else head, int(head is not None), lo, hi,
                        len(label), state.shape[0])
    kernels.check(rc, "kernel S (transcript_absorb)")
    variant = label.decode() + ("" if head is None else " head")
    kernels.count("transcript_absorb", 1, (state.shape[0], words), variant)
    return out


def transcript_squeeze(state: torch.Tensor, label: bytes, counter: int, count: int,
                       mask=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``count`` squeezes of ``label`` || LE64(counter + i) in a row per
    statement: (the last states (S, 4), the outputs (S, count)), each the
    digest's first LE64 word reduced mod p (``mask`` None) or ANDed with
    ``mask``."""
    _check_state(state)
    if state.device.type == "cpu":
        return transcript_squeeze_plain(state, label, counter, count, mask)
    lanes, lane, shift = squeeze_lanes(label)
    new = torch.empty_like(state)
    out = torch.empty((state.shape[0], count), dtype=torch.int64, device=state.device)
    rc = kernels.launch(state.device, kernels.load("fri").transcript_squeeze, state.data_ptr(),
                        new.data_ptr(), out.data_ptr(), lanes.ctypes.data, lane, shift, counter,
                        count, 0 if mask is None else mask, int(mask is None), state.shape[0])
    kernels.check(rc, "kernel S (transcript_squeeze)")
    variant = label.decode() + (" field" if mask is None else f" mask {mask}")
    kernels.count("transcript_squeeze", 1, (state.shape[0], count), variant)
    return new, out


def transcript_squeeze_field(state: torch.Tensor, label: bytes, counter: int):
    """One squeeze of ``label`` || LE64(counter) per statement: (the new
    states, the field challenges (S,)), as ``FriTranscript.challenge_field``
    over Goldilocks with its counter at ``counter``."""
    new, out = transcript_squeeze(state, label, counter, 1)
    return new, out[:, 0]


def transcript_squeeze_indices(state: torch.Tensor, label: bytes, counter: int, count: int,
                               bound: int):
    """``count`` squeezes in a row, counters ``counter``, ``counter`` + 1,
    ...: (the last states, the indices (S, count) in [0, bound)), as
    ``FriTranscript.challenge_indices`` for a power-of-two ``bound``."""
    return transcript_squeeze(state, label, counter, count, _check_mask(bound, count))


def transcript_final_queries(state: torch.Tensor, final_label: bytes, payload: torch.Tensor,
                             head: int, query_label: bytes, counter: int, count: int,
                             bound: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FRI chain's tail in one launch of kernel S: absorb
    ``final_label`` || LE64(head) || payload (S, W) (``fri-final``, its
    length word and the final polynomials), then ``count`` index squeezes
    of ``query_label`` from ``counter`` on, as ``transcript_absorb`` then
    ``transcript_squeeze_indices``: (the last states, the indices)."""
    _check_state(state)
    _check_payload(state, payload)
    mask = _check_mask(bound, count)
    if state.device.type == "cpu":
        return transcript_final_queries_plain(state, final_label, payload, head, query_label,
                                              counter, count, mask)
    lo, hi = label_lanes(final_label)
    lanes, lane, shift = squeeze_lanes(query_label)
    new = torch.empty_like(state)
    out = torch.empty((state.shape[0], count), dtype=torch.int64, device=state.device)
    rc = kernels.launch(state.device, kernels.load("fri").transcript_final_queries,
                        state.data_ptr(), new.data_ptr(), out.data_ptr(), payload.data_ptr(),
                        payload.shape[1], head, lo, hi, len(final_label), lanes.ctypes.data,
                        lane, shift, counter, count, mask, state.shape[0])
    kernels.check(rc, "kernel S (transcript_final_queries)")
    kernels.count("transcript_final_queries", 1, (state.shape[0], payload.shape[1]),
                  f"{final_label.decode()} {query_label.decode()} {count} mask {mask}")
    return new, out
