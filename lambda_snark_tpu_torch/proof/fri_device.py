"""Device-resident FRI proving over Goldilocks (the port's counterpart of
the JAX package's ``proof/fri_device.py``, on its per-layer host-transcript
branch, ``DEVICE_TRANSCRIPT = False``).

- codewords stay on the device as (S, n) or (S, K, n) int64 words;
- every Merkle forest is built there by one launch of kernel K
  (``ops.keccak.merkle_forest``), leaf level to root; the host sees 32-byte
  roots;
- each fold layer is a handful of torch ops with a cached 1/x table;
- the DEEP combination runs in torch ops (Montgomery batch inversion, with
  one host inverse per row); the aggregate (kind 8) passes its
  cross-statement lambda ladder as tables and sums the statements'
  quotients into one codeword (``sum_statements_device``); kind 9's takes
  a table of (oracle, point, value) terms and a shifted degree-bound
  column (``deep_combine_terms_device``);
- the final polynomials come from kernel N (the inverse transform of the
  residual codewords) on the device;
- the query openings (values and authentication paths of every layer) are
  gathered on the device and pulled in one transfer per batch; a FRI
  statement's input oracles may sit in several groups of unequal sizes
  (kind 9's pre and sum groups) and a group in several trees (the
  aggregate's one tree per statement), each opened at the same indices.

Transcripts stay on the host (``proof.fri.FriTranscript``); the per-layer
roots absorb there, in the JAX order. Proof bytes equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..core import field
from ..core.errors import DomainError
from ..ops import keccak, modarith
from ..ops.ntt import NttPlan
from ..ops.ntt_batched import ntt_forward_batched
from ..utils.timing import stage
from .fri import (
    FriParams,
    FriProof,
    FriQuery,
    FriTranscript,
    GroupOpening,
    LayerOpening,
    _effective_final_len,
    _gl_powers,
)

P = modarith.GOLDILOCKS


def _words(values, device) -> torch.Tensor:
    return modarith.to_words(np.asarray(values, dtype=np.uint64), device)


def digest_bytes(level: torch.Tensor) -> np.ndarray:
    """(..., 4) digest words (any device) -> uint8 (..., 32) on the host."""
    return modarith.to_u64(level).view(np.uint8)


@dataclasses.dataclass(eq=False)
class DevForest:
    """T Merkle trees with every level on the device: ``levels[l]`` is
    (T, rows_l, 4) digest words, leaf level first, root level (T, 1, 4)
    last."""

    levels: List[torch.Tensor]
    roots: List[bytes]
    num_leaves: int

    @property
    def n_trees(self) -> int:
        return len(self.roots)


def forest_from_levels(levels: List[torch.Tensor], root_words=None) -> DevForest:
    """The forest of device ``levels``; its roots are pulled from the root
    level unless given as (T, 4) uint64 words already on the host."""
    digests = digest_bytes(levels[-1][:, 0]) if root_words is None else \
        np.ascontiguousarray(root_words).view(np.uint8)
    roots = [bytes(r) for r in digests]
    return DevForest(levels=levels, roots=roots, num_leaves=levels[0].shape[1])


def _check_size(n: int) -> None:
    if n < 4 or n & (n - 1):
        raise DomainError(f"codeword size must be a power of two >= 4, got {n}")


def commit_planes_dev(values: torch.Tensor) -> DevForest:
    """(T, n) codewords -> T trees; leaf i pairs values (i, i + n/2). One
    launch of kernel K builds every level."""
    _check_size(values.shape[-1])
    return forest_from_levels(keccak.merkle_forest(values))


def group_forest_levels(vals: torch.Tensor) -> List[torch.Tensor]:
    """(S, K, n) codewords -> every level of S interleaved-group trees, on
    the device; leaf i holds every oracle's pair (i, i + n/2). One launch
    of kernel K builds every level."""
    _check_size(vals.shape[-1])
    return keccak.merkle_forest_flex(vals)


def commit_planes_dev_groups(vals: torch.Tensor) -> DevForest:
    """``group_forest_levels`` with its roots on the host."""
    return forest_from_levels(group_forest_levels(vals))


# --- fold -----------------------------------------------------------------------

_TABLE_CACHE: dict = {}


def _layer_inv_tables(n0: int, offset: int, omega: int, device) -> List[torch.Tensor]:
    """Per fold layer k, the 1/x table inv(off_k) inv(om_k)^i (i < n_k / 2)
    of the coset offset^(2^k) <omega^(2^k)>."""
    key = (n0, offset, omega, str(device))
    if key not in _TABLE_CACHE:
        tabs = []
        off, om, n = offset, omega, n0
        while n >= 4:
            inv_xs = _gl_powers(field.mod_inverse(om, P), n // 2,
                                scale=field.mod_inverse(off, P))
            tabs.append(_words(inv_xs, device))
            off, om, n = off * off % P, om * om % P, n // 2
        _TABLE_CACHE[key] = tabs
    return _TABLE_CACHE[key]


_INV2 = field.mod_inverse(2, P)


def _fold(cur: torch.Tensor, inv_x: torch.Tensor, cs: torch.Tensor) -> torch.Tensor:
    """(S, n) -> (S, n/2): v' = ((lo + hi) + c (lo - hi) / x) / 2."""
    half = cur.shape[1] // 2
    lo, hi = cur[:, :half], cur[:, half:]
    t = modarith.mul_mod(modarith.mul_mod(cs[:, None], modarith.sub_mod(lo, hi, P), P), inv_x, P)
    return modarith.mul_mod(modarith.add_mod(modarith.add_mod(lo, hi, P), t, P), _INV2, P)


# --- DEEP combination -------------------------------------------------------------


def _batch_inverse(x: torch.Tensor) -> torch.Tensor:
    """Row-wise inverses of (S, n) nonzero words: prefix and suffix products
    by log-doubling, one host inverse per row."""
    s, n = x.shape
    pre, suf = x.clone(), x.clone()
    shift = 1
    while shift < n:
        pre[:, shift:] = modarith.mul_mod(pre[:, shift:], pre[:, :-shift], P)
        suf[:, :-shift] = modarith.mul_mod(suf[:, :-shift], suf[:, shift:], P)
        shift <<= 1
    totals = modarith.to_u64(pre[:, -1])
    if not totals.all():
        raise DomainError("batch_inverse: zero element (challenge hit the domain)")
    total_inv = _words([field.mod_inverse(int(t), P) for t in totals], x.device)
    one = torch.ones((s, 1), dtype=torch.int64, device=x.device)
    left = torch.cat([one, pre[:, :-1]], dim=1)  # product of x[:i]
    right = torch.cat([suf[:, 1:], one], dim=1)  # product of x[i+1:]
    return modarith.mul_mod(modarith.mul_mod(left, right, P), total_inv[:, None], P)


_XS_CACHE: dict = {}


def _coset_points(n0: int, offset: int, omega: int, device) -> torch.Tensor:
    key = (n0, offset, omega, str(device))
    if key not in _XS_CACHE:
        xs = _gl_powers(omega, n0, scale=offset)
        _XS_CACHE[key] = _words(xs, device)
    return _XS_CACHE[key]


def lambda_ladder(lam: int, rows: int, k_in: int):
    """The weights (lam_a, lam_b), uint64 (rows, K), of one ladder run across
    the rows in order: lam_pow_0 = 1; lam2 = lam_pow lam; next lam_pow =
    lam2 lam (the JAX order)."""
    lam_a = np.empty((rows, k_in), dtype=np.uint64)
    lam_b = np.empty((rows, k_in), dtype=np.uint64)
    lam_pow = 1
    for si in range(rows):
        for k in range(k_in):
            lam2 = lam_pow * lam % P
            lam_a[si, k], lam_b[si, k] = lam_pow, lam2
            lam_pow = lam2 * lam % P
    return lam_a, lam_b


def deep_combine_device(input_vals: torch.Tensor, alphas, betas, lams, evals,
                        offset: int, omega: int, lam_tables=None) -> torch.Tensor:
    """The batched DEEP quotient, (S, K, n0) codewords -> g (S, n0):

        g = sum_k lam_a[k] (cw_k - ev_a_k) / (x - alpha)
                  + lam_b[k] (cw_k - ev_b_k) / (x - beta)

    alphas/betas/lams (S,) and evals (S, 2K) (the alpha block, then beta)
    are host uint64. Each statement's weights are its own ladder of
    ``lams[i]`` (``lambda_ladder``) unless ``lam_tables`` = (lam_a, lam_b),
    uint64 (S, K), gives them (the aggregate's one ladder across the
    statements); ``lams`` is then unused."""
    s, k_in, n0 = input_vals.shape
    dev = input_vals.device
    xs = _coset_points(n0, offset, omega, dev)
    if lam_tables is not None:
        lam_a, lam_b = lam_tables
    else:
        ladders = [lambda_ladder(int(lams[si]), 1, k_in) for si in range(s)]
        lam_a = np.concatenate([a for a, _b in ladders])
        lam_b = np.concatenate([b for _a, b in ladders])
    points = _words(np.stack([alphas, betas]), dev)  # (2, S)
    inv = _batch_inverse(modarith.sub_mod(xs[None, None, :], points[:, :, None], P)
                         .reshape(2 * s, n0)).reshape(2, s, 1, n0)
    ev = _words(evals, dev).reshape(s, 2, k_in).transpose(0, 1)[..., None]  # (2, S, K, 1)
    lam_t = _words(np.stack([lam_a, lam_b]), dev)[..., None]  # (2, S, K, 1)
    terms = modarith.mul_mod(
        modarith.mul_mod(lam_t, modarith.sub_mod(input_vals[None], ev, P), P), inv, P)
    g = terms[0, :, 0]
    for j in range(2):
        for k in range(k_in):
            if j or k:
                g = modarith.add_mod(g, terms[j, :, k], P)
    return g


def sum_statements_device(g: torch.Tensor) -> torch.Tensor:
    """(S, n) per-statement quotients -> (1, n), their exact sum mod p (a
    pairwise tree of torch adds on the device)."""
    while g.shape[0] > 1:
        if g.shape[0] & 1:
            g = torch.cat([g, torch.zeros_like(g[:1])])
        g = modarith.add_mod(g[0::2], g[1::2], P)
    return g


def _sum_words(x: torch.Tensor) -> torch.Tensor:
    """(R, n) canonical words -> (n,), their exact sum mod p: the 32-bit
    halves summed without reduction (R < 2^31 rows keeps each sum below
    2^63), then lo + hi 2^32 mod p."""
    lo = (x & modarith.M32).sum(dim=0)
    hi = ((x >> 32) & modarith.M32).sum(dim=0)
    # lo, hi < R 2^32 < p: canonical words
    return modarith.add_mod(lo, modarith.mul_mod(hi, (1 << 32) % P, P), P)


_SHIFT_CACHE: dict = {}


def deep_combine_terms_device(cw: torch.Tensor, points, term_oracle: Sequence[int],
                              term_point_idx: Sequence[int], weights, values, offset: int,
                              omega: int, shift_oracle: int, shift_exp: int,
                              shift_weight: int) -> torch.Tensor:
    """Kind 9's DEEP quotient over (K, n0) codewords on offset <omega>:

        g = sum_t weights[t] (cw[term_oracle[t]] - values[t])
                  / (x - points[term_point_idx[t]])
            + shift_weight x^shift_exp cw[shift_oracle]

    points (P,), weights and values (T,) are host uint64; returns g (n0,).
    The terms of one point are summed before their one product by that
    point's inverse row (field arithmetic is exact, so the order does not
    change a word): T scalar products, P inverse rows, P row products."""
    k_in, n0 = cw.shape
    dev = cw.device
    pts = _words(points, dev)
    inv = _batch_inverse(modarith.sub_mod(_coset_points(n0, offset, omega, dev)[None, :],
                                          pts[:, None], P))  # (P, n0)
    oracle = torch.tensor(list(term_oracle), dtype=torch.int64, device=dev)
    terms = modarith.mul_mod(modarith.sub_mod(cw.index_select(0, oracle),
                                              _words(values, dev)[:, None], P),
                             _words(weights, dev)[:, None], P)  # (T, n0)
    by_point = [[t for t, p in enumerate(term_point_idx) if p == i] for i in range(len(pts))]
    acc = torch.stack([_sum_words(terms[sel]) for sel in by_point])  # (P, n0)
    key = (n0, offset, omega, shift_exp, str(dev))
    if key not in _SHIFT_CACHE:  # x^e on the coset: offset^e (omega^e)^i
        _SHIFT_CACHE[key] = _words(_gl_powers(pow(omega, shift_exp, P), n0,
                                              scale=pow(offset, shift_exp, P)), dev)
    shifted = modarith.mul_mod(modarith.mul_mod(cw[shift_oracle], shift_weight % P, P),
                               _SHIFT_CACHE[key], P)
    return _sum_words(torch.cat([modarith.mul_mod(acc, inv, P), shifted[None]]))


# --- the prover -------------------------------------------------------------------


def _gather_pull(parts: List[torch.Tensor]) -> List[np.ndarray]:
    """One device-to-host transfer for every gathered tensor."""
    flat = modarith.to_u64(torch.cat([p.reshape(-1) for p in parts]))
    out, off = [], 0
    for p in parts:
        out.append(flat[off: off + p.numel()].reshape(tuple(p.shape)))
        off += p.numel()
    return out


_FINAL_CACHE: dict = {}


def _final_tables(n: int, off: int, om: int, device):
    """The n-point transform with root om^-1 (kernel T: its row entry up to
    2^13 points, its four-step above) and the untwist off^-i / n."""
    key = (n, off, om, str(device))
    if key not in _FINAL_CACHE:
        om_inv = field.mod_inverse(om, P)
        transform = functools.partial(ntt_forward_batched,
                                      NttPlan.create(n, P, om_inv, device=device))
        untwist = _gl_powers(field.mod_inverse(off, P), n, scale=field.mod_inverse(n, P))
        _FINAL_CACHE[key] = (transform, _words(untwist, device))
    return _FINAL_CACHE[key]


def _final_polynomial(cur: torch.Tensor, off: int, om: int, final_len: int) -> List[List[int]]:
    """Per row of the residual codewords (S, n) on off <om>: the inverse
    transform, untwisted by off^-i, pulled to the host; every coefficient
    from ``final_len`` on must vanish."""
    transform, untwist = _final_tables(cur.shape[1], off, om, cur.device)
    fin = modarith.to_u64(modarith.mul_mod(transform(cur.contiguous()), untwist, P))
    if fin[:, final_len:].any():
        raise DomainError("FRI final polynomial exceeds its degree bound")
    return [[int(v) for v in row[:final_len]] for row in fin]


def fri_commit_layers(g: torch.Tensor, offset: int, omega: int, q: int,
                      params: FriParams, trs: Sequence[FriTranscript]):
    """The commit phase of FRI on g (S, n0): fold with each transcript's
    challenge, commit every layer above the final length (kernel K) and
    absorb its roots, then absorb the final polynomials and draw the query
    indices. Returns (committed [(values (S, n), forest)], finals,
    indices (S, Q) on the device)."""
    stage("fri:dispatch")
    if q != P:
        raise DomainError("device FRI is implemented for the Goldilocks modulus")
    params.validate()
    s, n0 = g.shape
    dev = g.device
    d_bound = n0 >> params.log_blowup
    final_len = _effective_final_len(d_bound, params.final_len)
    tabs = _layer_inv_tables(n0, offset, omega, dev)
    committed: List[Tuple[torch.Tensor, DevForest]] = []
    cur = g
    off, om, d = offset, omega, d_bound
    layer = 0
    while True:
        cs = _words([tr.challenge_field(q, b"fri-fold") for tr in trs], dev)
        cur = _fold(cur, tabs[layer], cs)
        layer += 1
        off, om, d = off * off % q, om * om % q, d >> 1
        if d <= final_len:
            break
        forest = commit_planes_dev(cur)
        committed.append((cur, forest))
        for si in range(s):
            trs[si].absorb(b"fri-layer-root", forest.roots[si])
    finals = _final_polynomial(cur, off, om, final_len)
    for tr, fin in zip(trs, finals):
        tr.absorb_words(b"fri-final", fin)
    idx = torch.tensor([tr.challenge_indices(n0 // 2, params.num_queries, b"fri-query")
                        for tr in trs], dtype=torch.int64, device=dev)
    return committed, finals, idx


def _take_siblings(forest: DevForest, pos: torch.Tensor) -> List[torch.Tensor]:
    """The path of every leaf in ``pos`` (S, Q): one (S, Q, 4) tensor per
    level below the root."""
    return [lvl.gather(1, ((pos >> i) ^ 1)[:, :, None].expand(-1, -1, 4))
            for i, lvl in enumerate(forest.levels[:-1])]


def _trees_per_statement(inputs, s: int) -> List[int]:
    """Each input group's trees per FRI statement, T = n_trees / S; its K
    oracles split evenly over them."""
    trees = []
    for vals, forest in inputs:
        t = forest.n_trees // s if s else 0
        if vals.shape[0] != s or not t or forest.n_trees != s * t or vals.shape[1] % t:
            raise ValueError("g, the input codewords and the forest disagree on shape")
        trees.append(t)
    return trees


def fri_open(inputs, committed, finals, idx: torch.Tensor) -> List[FriProof]:
    """The query phase: gather every opened value and path on the device,
    pull them in one transfer, and assemble one FriProof per statement.

    ``inputs`` lists the input groups in the order of a query's openings,
    each as (codewords (S, K, n0), forest); statement i's K oracles of a
    group sit in T = n_trees / S trees of K / T oracles (trees i T + t),
    each opened at its indices. Groups may differ in K and T (kind 7: one
    group of 4 oracles; kind 8: one of 4 S' oracles in S' trees; kind 9:
    the pre group of 5 or 6 and the sum group of 2)."""
    s, nq = idx.shape
    parts, specs = [], []
    for (vals, forest), trees in zip(inputs, _trees_per_statement(inputs, s)):
        k_in, n0 = vals.shape[1:]
        idx_k = idx[:, None, :].expand(-1, k_in, -1)
        parts += [vals.gather(2, idx_k), vals.gather(2, idx_k + n0 // 2)]
        parts += _take_siblings(forest, idx.repeat_interleave(trees, dim=0))
        specs.append((k_in // trees, trees, len(forest.levels) - 1))
    depths = []
    pos = idx
    for values, forest in committed:
        half = forest.num_leaves
        pos = pos % half
        parts += [values.gather(1, pos), values.gather(1, pos + half)]
        parts += _take_siblings(forest, pos)
        depths.append(len(forest.levels) - 1)
    pulled = iter(_gather_pull(parts))
    stage("fri:queries-pulled")

    def path_bytes(depth: int, rows: int) -> np.ndarray:  # (rows, Q, depth * 32)
        levels = [next(pulled) for _ in range(depth)]
        return np.stack(levels, axis=2).view(np.uint8).reshape(rows, nq, 32 * depth)

    groups = []
    for gsize, trees, depth in specs:
        in_lo, in_hi = next(pulled), next(pulled)  # (S, K, Q)
        # (S, Q, T, 2 gsize): each tree's (lo, hi) pairs in oracle order
        vals = np.stack([in_lo, in_hi], axis=3).transpose(0, 2, 1, 3).reshape(
            s, nq, trees, 2 * gsize).tolist()
        groups.append((trees, vals, path_bytes(depth, s * trees).reshape(s, trees, nq, -1)))
    layers = []
    for depth in depths:
        v_lo, v_hi = next(pulled).tolist(), next(pulled).tolist()
        layers.append((v_lo, v_hi, path_bytes(depth, s)))

    proofs: List[FriProof] = []
    for si in range(s):
        queries = []
        for qi in range(nq):
            opened = tuple(GroupOpening(tuple(vals[si][qi][t]), paths[si, t, qi].tobytes())
                           for trees, vals, paths in groups for t in range(trees))
            layer_ops = tuple(LayerOpening(v_lo[si][qi], v_hi[si][qi], path[si, qi].tobytes())
                              for v_lo, v_hi, path in layers)
            queries.append(FriQuery(opened, layer_ops))
        roots = tuple(forest.roots[si] for _v, forest in committed)
        proofs.append(FriProof(roots, tuple(finals[si]), tuple(queries)))
    return proofs


def fri_prove_device(g: torch.Tensor, inputs, offset: int, omega: int, q: int,
                     params: FriParams, trs: Sequence[FriTranscript]) -> List[FriProof]:
    """One FriProof per statement, byte-identical to the JAX prover.

    g (S, n0): combined DEEP quotients; ``inputs``: the committed input
    groups as ``fri_open`` takes them (the aggregate passes its (S', 4, n0)
    codewords as (1, 4 S', n0) with its S' trees); trs: one transcript per
    statement, seeded with the roots and evaluations already."""
    s, n0 = g.shape
    _trees_per_statement(inputs, s)
    if any(vals.shape[2] != n0 for vals, _f in inputs):
        raise ValueError("g, the input codewords and the forest disagree on shape")
    return fri_open(inputs, *fri_commit_layers(g, offset, omega, q, params, trs))
