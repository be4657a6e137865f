"""Succinct R1CS proofs with a committed witness (wire kind 9, v4).

The port of the JAX package's ``proof/succinct_witness.py``: the full SNARK
statement, "I know z with public prefix x such that (Az) o (Bz) = Cz", with
z never revealed.

- The witness is committed as the low-degree extension z^ of z over the
  sumcheck domain H_s = <w_s> of size M = max(m, next_pow2(n)), beside
  A~, B~, C~ and Q~ in one interleaved Merkle tree (the pre group).
- mulcheck is kind 7's quotient identity Q~ Z_H = A~ B~ - C~ at the dual
  challenges alpha, beta.
- lincheck ties the codewords to z: for a transcript challenge r and
  weights eta_A, eta_B, eta_C, with the rows embedded in H_s at stride
  s = M/m, sum_{H_s} [R_s (eta . [A~, B~, C~]) - U_s z^] = 0, where R_s
  interpolates r^i at w_s^{is} and U_s interpolates u = sum_M eta_M r^T M.
- The sum is proven by a univariate sumcheck: F = Z_Hs h + X p with
  deg p <= M - 2; h and p are committed in the sum group, the identity is
  checked at a transcript point gamma, and p's degree bound rides in the
  DEEP batch as the shifted column lambda^T X^sh p(X).
- The public prefix of z is bound by one DEEP column
  (z^(X) - x_j)/(X - w_s^j) per public input.
- Zero knowledge: A~, B~, C~, Q~ carry kind 7's vanishing masks, z^ one of
  its own (Z_Hs rho_z), and the sumcheck is masked by a committed mu with
  sum_{H_s} mu = 0 (the sixth pre-group oracle).

One batched FRI proof binds everything. Routes: a Goldilocks circuit on
the roots domain (every Goldilocks circuit ``_witness_geometry`` accepts)
takes the device route, ``proof.succinct_witness_device``; every other
circuit (the 44-bit field, the healthcare prime) the host route on Python
ints, ``_prove_from_parts``, the JAX package's prover tail with its
signature. Its Goldilocks branches (``gl_fast``, the DEEP build on CPU
words) are the reference the device route is held to. The verifier runs
on the host. Proof bytes equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..commit import lwe
from ..commit.lwe import Commitment, LweContext
from ..core import field
from ..core.errors import DomainError, SerializationError
from ..device import resolve
from ..ops import modarith
from ..ops.modarith import GOLDILOCKS
from ..ops.ntt import ntt_inverse
from ..r1cs import poly as polyops
from ..r1cs.domain import ROOTS
from ..r1cs.r1cs import R1CS
from ..transcript.challenge import Challenge, derive_dual
from ..utils.chacha import ChaCha20Rng
from .fri import (
    FriParams,
    FriProof,
    FriTranscript,
    _gl_inverse_array,
    _gl_pow_array,
    _gl_powers,
    _gl_u64,
    batch_inverse,
    commit_codeword_group,
    coset_offset,
    coset_points,
    fri_prove,
    fri_supported,
    fri_verify,
    lde,
    max_codeword_size,
    root_of_order,
)
from .succinct import (
    _MAGIC,
    _MASK_LEN_CAP,
    WIRE_VERSION,
    _check_wire_version,
    _gl_add_padded,
    _gl_conv,
    _gl_frontend_applicable,
    _gl_plan,
    _gl_poly_eval,
    _gl_sum,
    _gl_trim,
    _gl_words,
    _next_pow2,
    _roots_to_words,
    statement_binding_words,
    zk_mask_len,
)

KIND_R1CS_WITNESS = 9

__all__ = ["WitnessProofR1CS", "prove_r1cs_witness", "verify_r1cs_witness"]

P = GOLDILOCKS


def _gl_scale(p, s: int) -> np.ndarray:
    return modarith.to_u64(modarith.mul_mod(_gl_words(p), s % P, P))


def _gl_neg(p) -> np.ndarray:
    x = _gl_words(p)
    return modarith.to_u64(modarith.sub_mod(torch.zeros_like(x), x, P))


# --- instance geometry --------------------------------------------------------


def _witness_geometry(r1cs: R1CS, params: FriParams,
                      mask_len: int) -> Tuple[int, int, int, int, int]:
    """Validate the instance; return (M, omega_s, d_bound, n0, omega_n): the
    sumcheck domain's size and generator, the shared FRI degree bound, the
    codeword size and the coset generator."""
    q = r1cs.modulus
    if not fri_supported(q):
        raise DomainError(f"witness-bound openings need an NTT field (modulus {q} has no "
                          "registered 2-adic subgroup)")
    if r1cs.domain.kind != ROOTS:
        raise DomainError("witness-bound openings require a roots interpolation domain "
                          f"(got {r1cs.domain.kind})")
    m = r1cs.m
    if m < 2 or m & (m - 1):
        raise DomainError(f"witness-bound openings require a power-of-two constraint count "
                          f"(got m={m})")
    big_m = max(m, _next_pow2(r1cs.n))
    if big_m > max_codeword_size(q):
        raise DomainError(f"sumcheck domain {big_m} exceeds the 2-adic limit of modulus {q}")
    omega_s = root_of_order(q, big_m)
    if pow(omega_s, big_m // m, q) != r1cs.domain.omega % q:
        raise DomainError("R1CS domain generator is not on the field's 2-adic root ladder")
    # committed lengths: A~/B~/C~ = m+mask, Q~ <= m+2*mask, z^ = M+mask,
    # h <= M+mask-1, p = M-1, mu = 2M+mask-1, F <= 2M+mask-1
    d_bound = _next_pow2(max(2 * big_m + mask_len - 1, m + 2 * mask_len, big_m + 1))
    n0 = d_bound << params.log_blowup
    if n0 > max_codeword_size(q):
        raise DomainError(
            f"codeword size {n0} exceeds the 2-adic limit {max_codeword_size(q)} of modulus "
            f"{q}; lower log_blowup or the circuit size")
    return big_m, omega_s, d_bound, n0, root_of_order(q, n0)


def _row_weights(r1cs: R1CS, r: int, etas: Tuple[int, int, int]):
    """(u, r_pows): u = eta_A (r^T A) + eta_B (r^T B) + eta_C (r^T C)
    (length n) and the length-m ladder of powers of r it used (the
    verifier's R_s sum takes the same ladder).

    Goldilocks (uint64 arrays): every term of every matrix in one pass off
    the CSR arrays, its 32-bit halves scatter-added per column; each half
    is below 2^32, so a column's half-sums stay below nnz x 2^32, which must
    be below 2^64 (and below p, to be canonical) for the recombination
    lo + hi 2^32 mod p to be exact. Other fields: Python ints."""
    q = r1cs.modulus
    if q == P:
        r_pows = _gl_words(_gl_powers(r % q, r1cs.m))
        acc_lo = torch.zeros(r1cs.n, dtype=torch.int64)
        acc_hi = torch.zeros(r1cs.n, dtype=torch.int64)
        for mat, eta in zip((r1cs.a, r1cs.b, r1cs.c), etas):
            counts = torch.tensor(np.diff(np.asarray(mat.row_ptr, dtype=np.int64)))
            rows = torch.repeat_interleave(torch.arange(r1cs.m), counts)
            cols = torch.tensor(mat.col_indices, dtype=torch.int64)
            vals = _gl_words([v % q for v in mat.values])
            terms = modarith.mul_mod(modarith.mul_mod(r_pows[rows], eta % q, P), vals, P)
            acc_lo.index_add_(0, cols, terms & modarith.M32)
            acc_hi.index_add_(0, cols, (terms >> 32) & modarith.M32)
        u = modarith.add_mod(acc_lo, modarith.mul_mod(acc_hi, (1 << 32) % q, P), P)
        return modarith.to_u64(u), modarith.to_u64(r_pows)
    r_pows = [1] * r1cs.m
    for i in range(1, r1cs.m):
        r_pows[i] = r_pows[i - 1] * r % q
    u = [0] * r1cs.n
    for mat, eta in zip((r1cs.a, r1cs.b, r1cs.c), etas):
        for i, j, v in mat.coo():
            u[j] = (u[j] + eta * r_pows[i] % q * v) % q
    return u, r_pows


def _gl_pow_vec_int(base: int, exps: Sequence[int]) -> np.ndarray:
    """[base^e for e in exps] mod Goldilocks."""
    e = torch.tensor(list(exps), dtype=torch.int64)
    out = torch.ones(len(e), dtype=torch.int64)
    b = base % P
    for _ in range(int(e.max()).bit_length() if len(e) else 0):
        sel = (e & 1).bool()
        out[sel] = modarith.mul_mod(out[sel], b, P)
        b = b * b % P
        e >>= 1
    return modarith.to_u64(out)


def _gl_lagrange_terms(weights, pts: np.ndarray, gamma: int) -> int:
    """sum_k w_k pts_k / (gamma - pts_k) over Goldilocks."""
    pts_w = _gl_words(pts)
    inv = _gl_words(_gl_inverse_array(modarith.to_u64(modarith.sub_mod(gamma % P, pts_w, P))))
    return _gl_sum(modarith.mul_mod(modarith.mul_mod(_gl_words(weights), pts_w, P), inv, P))


def _lagrange_sum(weights: Sequence[int], positions: Sequence[int], gamma: int, omega_s: int,
                  big_m: int, q: int) -> int:
    """sum_k w_k L_{positions[k]}(gamma) over the size-M subgroup <omega_s>:
    L_k(gamma) = (omega_s^k / M) Z(gamma) / (gamma - omega_s^k)."""
    z_g = (pow(gamma, big_m, q) - 1) % q
    if z_g == 0:
        raise DomainError("sumcheck point fell on the domain")
    if q == P:
        acc = _gl_lagrange_terms([x % q for x in weights], _gl_pow_vec_int(omega_s, positions),
                                 gamma)
        return acc * (z_g * field.mod_inverse(big_m % q, q) % q) % q
    pts = [pow(omega_s, k, q) for k in positions]
    inv = batch_inverse([(gamma - pt) % q for pt in pts], q)
    acc = 0
    for w, pt, iv in zip(weights, pts, inv):
        acc = (acc + w % q * pt % q * iv) % q
    return acc * z_g % q * field.mod_inverse(big_m % q, q) % q


def _lagrange_sum_geometric(weights, base: int, gamma: int, omega_s: int, big_m: int,
                            q: int) -> int:
    """Goldilocks ``_lagrange_sum`` where weights[k] sits at the point
    base^k (both of the verifier's sums: R_s at the stride-embedded rows,
    U_s at consecutive columns)."""
    z_g = (pow(gamma, big_m, q) - 1) % q
    if z_g == 0:
        raise DomainError("sumcheck point fell on the domain")
    acc = _gl_lagrange_terms(weights, _gl_powers(base % q, len(weights)), gamma)
    return acc * z_g % q * field.mod_inverse(big_m % q, q) % q


def _fold_words(f: torch.Tensor, big_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_fold_by_vanishing`` of Goldilocks words f (len,) on their device:
    (h, g) with len(h) = max(len - M, 1) and len(g) = M."""
    n = f.shape[0]
    blocks = torch.zeros(-(-n // big_m) * big_m, dtype=torch.int64, device=f.device)
    blocks[:n] = f
    blocks = blocks.reshape(-1, big_m)
    g = blocks[0]
    for b in blocks[1:]:
        g = modarith.add_mod(g, b, P)
    # h's block s is the sum of f's blocks t > s
    suffix, h_blocks = torch.zeros_like(g), []
    for t in range(blocks.shape[0] - 1, 0, -1):
        suffix = modarith.add_mod(suffix, blocks[t], P)
        h_blocks.insert(0, suffix)
    h = torch.cat(h_blocks)[: n - big_m] if h_blocks else torch.zeros_like(g[:1])
    return h, g


def _fold_by_vanishing(f, big_m: int, q: int):
    """Euclid by Z = X^M - 1 by coefficient folding: f = Z h + g with
    g_j = sum_t f[j + tM] and h_k = sum_{t>=1} f[k + tM]. Returns (h, g),
    len(g) = M (uint64 arrays over Goldilocks, lists otherwise)."""
    if q == P:
        return tuple(modarith.to_u64(x) for x in _fold_words(_gl_words(f), big_m))
    n = len(f)
    g = [0] * big_m
    h = [0] * max(n - big_m, 1)
    for i, c in enumerate(f):
        c = c % q
        g[i % big_m] = (g[i % big_m] + c) % q
        t = i - big_m
        while t >= 0:
            h[t] = (h[t] + c) % q
            t -= big_m
    return h, g


# --- proof container ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WitnessProofR1CS:
    """Succinct R1CS proof with a committed witness (wire kind 9).

    ``pre_root`` commits the pre-challenge oracles in one interleaved tree
    (A~, B~, C~, Q~, z^[, mu]), ``sum_root`` the sumcheck pair (h, p).
    ``mask_len > 0`` marks the zero-knowledge variant (and the mu oracle)."""

    commitment_q: Commitment
    pre_root: bytes
    sum_root: bytes
    challenge_alpha: Challenge
    challenge_beta: Challenge
    evals_ab: Tuple[int, ...]  # (A~, B~, C~, Q~) at alpha, then at beta
    evals_gamma: Tuple[int, ...]  # (A~, B~, C~, z^, h, p[, mu]) at gamma
    fri: FriProof
    m: int
    n_vars: int
    mask_len: int
    log_blowup: int
    num_queries: int
    final_len: int
    modulus: int

    @property
    def fri_params(self) -> FriParams:
        return FriParams(log_blowup=self.log_blowup, num_queries=self.num_queries,
                         final_len=self.final_len)

    @property
    def zk(self) -> bool:
        return self.mask_len > 0

    @property
    def n_pre(self) -> int:
        """Oracles of the pre-challenge group (A~, B~, C~, Q~, z^[, mu])."""
        return 6 if self.zk else 5

    def input_groups(self):
        """``fri_verify``'s group spec: (root, size) per interleaved tree."""
        return [(self.pre_root, self.n_pre), (self.sum_root, 2)]

    def to_bytes(self) -> bytes:
        out = _MAGIC + bytes([KIND_R1CS_WITNESS, WIRE_VERSION])
        out += struct.pack("<QQQIBHH", self.modulus, self.m, self.n_vars, self.mask_len,
                           self.log_blowup, self.num_queries, self.final_len)
        out += struct.pack("<Q", len(self.commitment_q.words)) + self.commitment_q.to_bytes()
        out += self.pre_root + self.sum_root
        out += self.challenge_alpha.to_bytes() + self.challenge_beta.to_bytes()
        out += struct.pack("<8Q", *self.evals_ab)
        out += bytes([len(self.evals_gamma)])
        out += struct.pack(f"<{len(self.evals_gamma)}Q", *self.evals_gamma)
        return out + self.fri.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "WitnessProofR1CS":
        if len(data) < 9 or data[:8] != _MAGIC or data[8] != KIND_R1CS_WITNESS:
            raise SerializationError("bad witness-proof header")
        off = _check_wire_version(data, 9)
        if off + 33 > len(data):
            raise SerializationError("truncated witness proof header")
        modulus, m, n_vars, mask_len, log_blowup, num_queries, final_len = struct.unpack_from(
            "<QQQIBHH", data, off)
        off += 33
        if off + 8 > len(data):
            raise SerializationError("truncated commitment length")
        (n_words,) = struct.unpack_from("<Q", data, off)
        off += 8
        if n_words > (1 << 24):
            raise SerializationError("unreasonable commitment length")
        if off + 8 * n_words > len(data):
            raise SerializationError("truncated commitment words")
        words = np.frombuffer(data, dtype="<u8", count=n_words, offset=off).astype(np.uint64)
        off += 8 * n_words
        if off + 64 > len(data):
            raise SerializationError("truncated roots")
        pre_root, sum_root = data[off: off + 32], data[off + 32: off + 64]
        off += 64
        if off + 80 > len(data):
            raise SerializationError("truncated challenges")
        ch_a = Challenge.from_bytes(data[off: off + 40])
        ch_b = Challenge.from_bytes(data[off + 40: off + 80])
        off += 80
        if off + 64 > len(data):
            raise SerializationError("truncated evaluations")
        evals_ab = struct.unpack_from("<8Q", data, off)
        off += 64
        if off + 1 > len(data):
            raise SerializationError("truncated gamma eval count")
        n_g = data[off]
        off += 1
        if n_g not in (6, 7):
            raise SerializationError(f"bad gamma eval count {n_g}")
        if off + 8 * n_g > len(data):
            raise SerializationError("truncated gamma evals")
        evals_gamma = struct.unpack_from(f"<{n_g}Q", data, off)
        off += 8 * n_g
        fri_proof, off = FriProof.read(data, off)
        return WitnessProofR1CS(
            commitment_q=Commitment(words), pre_root=pre_root, sum_root=sum_root,
            challenge_alpha=ch_a, challenge_beta=ch_b, evals_ab=tuple(evals_ab),
            evals_gamma=tuple(evals_gamma), fri=fri_proof, m=m, n_vars=n_vars,
            mask_len=mask_len, log_blowup=log_blowup, num_queries=num_queries,
            final_len=final_len, modulus=modulus)


# --- transcript ---------------------------------------------------------------


def _seed_witness_transcript(q: int, m: int, n_vars: int, big_m: int, mask_len: int,
                             params: FriParams, d_bound: int, input_roots: Sequence[bytes],
                             alpha: int, beta: int, evals_ab: Sequence[int]) -> FriTranscript:
    tr = FriTranscript()
    tr.absorb_words(b"witness-params",
                    [KIND_R1CS_WITNESS, q, m, n_vars, big_m, mask_len, params.log_blowup,
                     params.num_queries, params.final_len, d_bound])
    for root in input_roots:
        tr.absorb(b"input-root", root)
    tr.absorb_words(b"points", [alpha, beta])
    tr.absorb_words(b"evals", list(evals_ab))
    return tr


def _lincheck_challenges(tr: FriTranscript, q: int):
    """(r, (eta_A, eta_B, eta_C), tau), in the transcript's order."""
    r = tr.challenge_field(q, b"lincheck-r")
    etas = tuple(tr.challenge_field(q, b"lincheck-eta") for _ in range(3))
    return r, etas, tr.challenge_field(q, b"sumcheck-tau")


def _deep_terms(zk: bool, alpha: int, beta: int, gamma: int, evals_ab: Sequence[int],
                evals_gamma: Sequence[int], pub_points: Sequence[int],
                pub_values: Sequence[int]) -> List[Tuple[int, int, int]]:
    """The ordered DEEP quotient columns (oracle index, point, claimed
    value); oracles A~ = 0, B~ = 1, C~ = 2, Q~ = 3, z^ = 4[, mu = 5], then
    h, p. The shifted degree-bound column on p comes after them, with
    weight lambda^len(terms)."""
    z_i = 4
    h_i = 6 if zk else 5
    p_i = h_i + 1
    terms = [(k, pt, evals_ab[4 * j + k]) for j, pt in enumerate((alpha, beta))
             for k in range(4)]
    terms += [(k, gamma, v) for k, v in zip((0, 1, 2, z_i, h_i, p_i), evals_gamma)]
    if zk:
        terms.append((5, gamma, evals_gamma[6]))
    terms += [(z_i, pt, v) for pt, v in zip(pub_points, pub_values)]
    return terms


def _lambda_weights(n_terms: int, lam: int, q: int) -> List[int]:
    """lambda^0 .. lambda^n_terms: the terms' weights, then the shifted
    column's."""
    weights = [1]
    for _ in range(n_terms):
        weights.append(weights[-1] * lam % q)
    return weights


# --- prover -------------------------------------------------------------------


def _draw_masks(rng: ChaCha20Rng, mask_len: int, big_m: int, q: int):
    """The zero-knowledge draws, in order: rho_A, rho_B, rho_C, rho_z
    (``mask_len`` words each), then mu (2M + mask_len - 1 words) with mu[0]
    fixed so that sum_{H_s} mu = M sum_t mu[tM] = 0."""
    rhos = [[rng.next_u64() % q for _ in range(mask_len)] for _ in range(4)]
    mu_len = 2 * big_m + mask_len - 1
    mu = [rng.next_u64() % q for _ in range(mu_len)]
    mu[0] = (q - sum(mu[big_m::big_m]) % q) % q
    return rhos, mu


def prove_r1cs_witness(r1cs: R1CS, witness: Sequence[int], ctx: LweContext, seed: int,
                       zk: bool = False, fri_params: Optional[FriParams] = None,
                       blinding_seed: Optional[int] = None, device_lde: bool = False,
                       device="cuda") -> WitnessProofR1CS:
    """Prove R1CS satisfaction with the witness bound to a hidden
    commitment, byte-identical to the JAX package's ``prove_r1cs_witness``.

    The parameters are the JAX package's, in its order, then ``device``. A
    Goldilocks circuit takes the device route (on the card unless
    ``device="cpu"``, where every kernel runs as its plain twin); any other
    the host route. ``zk=True`` draws the masks from ChaCha20 seeded with
    ``blinding_seed``, else from OS entropy. ``device_lde`` chooses between
    JAX routes with the same bytes and is ignored."""
    params = fri_params or FriParams()
    params.validate()
    q = r1cs.modulus
    mask_len = zk_mask_len(params) if zk else 0
    geometry = _witness_geometry(r1cs, params, mask_len)
    dev = resolve(device)
    rng = None
    if zk:
        if blinding_seed is not None:
            rng = ChaCha20Rng.from_u64(blinding_seed)
        else:
            import secrets

            rng = ChaCha20Rng(secrets.token_bytes(32))
    if _gl_frontend_applicable(r1cs):
        from .succinct_witness_device import prove_witness_device

        return prove_witness_device(r1cs, witness, ctx, seed, params, mask_len, geometry, rng,
                                    dev)
    big_m, omega_s = geometry[:2]
    z = [int(v) % q for v in witness]
    q_coeffs = r1cs.compute_quotient_poly(witness)
    a_poly, b_poly, c_poly = r1cs.interpolations(witness)
    z_poly = polyops.ntt_inverse(z + [0] * (big_m - len(z)), q, omega_s)
    mu_poly = None
    if zk:
        (rho_a, rho_b, rho_c, rho_z), mu_poly = _draw_masks(rng, mask_len, big_m, q)
        add, mul = polyops.poly_add, polyops.poly_mul
        z_h = r1cs.domain.vanishing_poly()
        a_t = add(a_poly, mul(z_h, rho_a, q), q)
        b_t = add(b_poly, mul(z_h, rho_b, q), q)
        c_t = add(c_poly, mul(z_h, rho_c, q), q)
        q_t = add(q_coeffs, mul(rho_a, b_poly, q), q)
        q_t = add(q_t, mul(rho_b, a_poly, q), q)
        q_t = add(q_t, mul(z_h, mul(rho_a, rho_b, q), q), q)
        q_t = polyops.poly_sub(q_t, rho_c, q)
        z_hs = [q - 1] + [0] * (big_m - 1) + [1]  # X^M - 1
        z_t = add(z_poly, mul(z_hs, rho_z, q), q)
    else:
        a_t, b_t, c_t, q_t, z_t = a_poly, b_poly, c_poly, q_coeffs, z_poly
    return _prove_from_parts(r1cs, z, a_t, b_t, c_t, q_t, z_t, mu_poly, q_coeffs, ctx, seed,
                             params, mask_len, *geometry, False)


def _prove_from_parts(r1cs: R1CS, z: Sequence[int], a_t, b_t, c_t, q_t, z_t, mu_poly,
                      q_coeffs, ctx: LweContext, seed: int, params: FriParams, mask_len: int,
                      big_m: int, omega_s: int, d_bound: int, n0: int, omega_n: int,
                      gl_fast: bool, public_override: Optional[Sequence[int]] = None,
                      device_lde: bool = False,
                      _allow_bad_sum: bool = False) -> WitnessProofR1CS:
    """The host prover's tail, the JAX package's (its signature, so tests
    can feed forged polynomials through the honest transcript;
    ``_allow_bad_sum`` commits a sumcheck with a nonzero remainder as a
    cheating prover would). ``gl_fast`` takes the polynomials as uint64
    arrays of Goldilocks words (CPU-word arithmetic), else as lists of ints;
    the DEEP quotient is built on CPU words over Goldilocks and in Python
    ints otherwise. ``device_lde`` is ignored (same bytes)."""
    q, m = r1cs.modulus, r1cs.m
    zk = mask_len > 0
    offset = coset_offset(q)
    pre_cw = [lde(p, n0, offset, omega_n, q)
              for p in [a_t, b_t, c_t, q_t, z_t] + ([mu_poly] if zk else [])]
    pre_tree = commit_codeword_group(pre_cw)
    pre_root = pre_tree.root
    commitment_q, _op = lwe.commit(ctx, q_coeffs, seed)
    comm_words = np.concatenate([statement_binding_words(commitment_q, r1cs),
                                 np.array(_roots_to_words([pre_root]), dtype=np.uint64)])
    public_inputs = list(public_override) if public_override is not None else \
        [z[j] for j in range(r1cs.l)]
    ch_alpha, ch_beta = derive_dual(public_inputs, comm_words, q)
    alpha, beta = ch_alpha.alpha, ch_beta.alpha
    evaluate = _gl_poly_eval if gl_fast else \
        (lambda p, x: polyops.poly_eval([int(v) for v in p], x, q))
    evals_ab = [evaluate(p, x) for x in (alpha, beta) for p in (a_t, b_t, c_t, q_t)]
    tr = _seed_witness_transcript(q, m, r1cs.n, big_m, mask_len, params, d_bound, [pre_root],
                                  alpha, beta, evals_ab)
    r, etas, tau = _lincheck_challenges(tr, q)

    # F = R_s (eta . [A~, B~, C~]) - U_s z^ (+ tau mu)
    u, _r_pows = _row_weights(r1cs, r, etas)
    stride = big_m // m
    if gl_fast:
        rho = np.zeros(big_m, dtype=np.uint64)
        rho[::stride] = _gl_powers(r, m)
        u_pad = np.zeros(big_m, dtype=np.uint64)
        u_pad[: len(u)] = u
        plan = _gl_plan(big_m)
        r_s, u_s = (modarith.to_u64(ntt_inverse(plan, _gl_words(x))) for x in (rho, u_pad))
        combo = _gl_add_padded(*(_gl_scale(p, eta) for p, eta in zip((a_t, b_t, c_t), etas)))
        f_poly = _gl_add_padded(_gl_conv(r_s, combo), _gl_neg(_gl_conv(u_s, _gl_u64(z_t))),
                                *([_gl_scale(mu_poly, tau)] if zk else []))
        h_poly, g_rem = _fold_by_vanishing(f_poly, big_m, q)
        if int(g_rem[0]) != 0 and not _allow_bad_sum:
            raise DomainError("sumcheck remainder nonzero (witness bug)")
        p_poly = g_rem[1:]  # M >= 2: never empty
        h_poly = _gl_trim(h_poly)
    else:
        rho = [0] * big_m
        for k, rk in enumerate(_r_pows):
            rho[k * stride] = int(rk)
        r_s = polyops.ntt_inverse(rho, q, omega_s)
        u_s = polyops.ntt_inverse([int(x) % q for x in u] + [0] * (big_m - len(u)), q, omega_s)
        combo = polyops.poly_add(
            polyops.poly_add([x * etas[0] % q for x in a_t], [x * etas[1] % q for x in b_t], q),
            [x * etas[2] % q for x in c_t], q)
        f_poly = polyops.poly_sub(polyops.poly_mul(r_s, combo, q),
                                  polyops.poly_mul(u_s, list(z_t), q), q)
        if zk:
            f_poly = polyops.poly_add(f_poly, [x * tau % q for x in mu_poly], q)
        h_poly, g_rem = _fold_by_vanishing(f_poly, big_m, q)
        if int(g_rem[0]) % q != 0 and not _allow_bad_sum:
            raise DomainError("sumcheck remainder nonzero (witness bug)")
        # ints: over Goldilocks the fold gives an array, whose truth value
        # the JAX package's ``g_rem[1:] or [0]`` cannot take
        p_poly = [int(v) for v in g_rem[1:]] or [0]

    sum_cw = [lde(h_poly, n0, offset, omega_n, q), lde(p_poly, n0, offset, omega_n, q)]
    sum_tree = commit_codeword_group(sum_cw)
    tr.absorb(b"sum-root", sum_tree.root)
    gamma = tr.challenge_field(q, b"sumcheck-gamma")
    if pow(gamma, big_m, q) == 1:  # pragma: no cover - a 2^-64 event
        raise DomainError("sumcheck challenge fell on the domain")
    evals_gamma = [evaluate(p, gamma)
                   for p in [a_t, b_t, c_t, z_t, h_poly, p_poly] + ([mu_poly] if zk else [])]
    tr.absorb_words(b"gamma-evals", evals_gamma)
    lam = tr.challenge_field(q, b"fri-lambda")

    terms = _deep_terms(zk, alpha, beta, gamma, evals_ab, evals_gamma,
                        [pow(omega_s, j, q) for j in range(len(public_inputs))],
                        [v % q for v in public_inputs])
    weights = _lambda_weights(len(terms), lam, q)
    sh_p = d_bound - (big_m - 1)
    codewords = pre_cw + sum_cw
    if q == P:
        g = _deep_host_goldilocks(codewords, terms, weights, offset, omega_n, n0,
                                  len(codewords) - 1, sh_p)
    else:
        xs = coset_points(offset, omega_n, n0, q)
        inv_cache = {}
        g = [0] * n0
        for w, (k, pt, v) in zip(weights, terms):
            if pt not in inv_cache:
                inv_cache[pt] = batch_inverse([(x - pt) % q for x in xs], q)
            cw, iv = codewords[k], inv_cache[pt]
            for i in range(n0):
                g[i] = (g[i] + w * ((int(cw[i]) - v) % q) % q * iv[i]) % q
        p_cw = codewords[-1]
        for i in range(n0):
            g[i] = (g[i] + weights[-1] * pow(xs[i], sh_p, q) % q * int(p_cw[i])) % q
    fri_proof = fri_prove(g, [(pre_cw, pre_tree), (sum_cw, sum_tree)], offset, omega_n, q,
                          params, tr)
    return WitnessProofR1CS(
        commitment_q=commitment_q, pre_root=pre_root, sum_root=sum_tree.root,
        challenge_alpha=ch_alpha, challenge_beta=ch_beta,
        evals_ab=tuple(int(v) for v in evals_ab), evals_gamma=tuple(int(v) for v in evals_gamma),
        fri=fri_proof, m=m, n_vars=r1cs.n, mask_len=mask_len, log_blowup=params.log_blowup,
        num_queries=params.num_queries, final_len=params.final_len, modulus=q)


def _deep_host_goldilocks(codewords, terms, weights, offset: int, omega_n: int, n0: int,
                          shift_oracle: int, shift_exp: int) -> np.ndarray:
    """The DEEP quotient on CPU words: sum_t w_t (cw[o_t] - v_t) / (x - pt_t)
    + w_last x^shift_exp cw[shift_oracle], one inverse ladder per distinct
    point (the reference of ``fri_device.deep_combine_terms_device``)."""
    xs_u64 = _gl_powers(omega_n, n0, scale=offset)
    xs = _gl_words(xs_u64)
    inv_cache = {}
    g = torch.zeros(n0, dtype=torch.int64)
    for w, (k, pt, v) in zip(weights, terms):
        if pt not in inv_cache:
            inv_cache[pt] = _gl_words(_gl_inverse_array(
                modarith.to_u64(modarith.sub_mod(xs, pt % P, P))))
        diff = modarith.sub_mod(_gl_words(codewords[k]), v % P, P)
        g = modarith.add_mod(g, modarith.mul_mod(modarith.mul_mod(diff, w, P),
                                                 inv_cache[pt], P), P)
    shifted = modarith.mul_mod(_gl_words(codewords[shift_oracle]), weights[-1], P)
    g = modarith.add_mod(g, modarith.mul_mod(shifted, _gl_words(_gl_pow_array(xs_u64,
                                                                             shift_exp)), P), P)
    return modarith.to_u64(g)


# --- verifier -----------------------------------------------------------------


def verify_r1cs_witness(proof: WitnessProofR1CS, public_inputs: Sequence[int], r1cs: R1CS,
                        min_params: Optional[FriParams] = None) -> bool:
    """Verify a kind-9 proof on the host, deciding as the JAX package's
    ``verify_r1cs_witness``: (a) the quotient identity at alpha and beta,
    (b) the lincheck sumcheck identity at gamma for the verifier's own
    R_s(gamma) and U_s(gamma), (c) z^'s public prefix (the per-point DEEP
    columns) and (d) the batched FRI. ``min_params`` (default
    ``FriParams()``) is the floor on the prover's FRI parameters."""
    q = r1cs.modulus
    if proof.modulus != q or proof.m != r1cs.m or proof.n_vars != r1cs.n:
        return False
    if proof.mask_len > _MASK_LEN_CAP or len(public_inputs) != r1cs.l:
        return False
    params = proof.fri_params
    try:
        params.validate()
        big_m, omega_s, d_bound, n0, omega_n = _witness_geometry(r1cs, params, proof.mask_len)
    except DomainError:
        return False
    if not params.at_least(min_params or FriParams()):
        return False
    zk = proof.zk
    if len(proof.evals_gamma) != (7 if zk else 6):
        return False

    comm_words = np.concatenate([statement_binding_words(proof.commitment_q, r1cs),
                                 np.array(_roots_to_words([proof.pre_root]), dtype=np.uint64)])
    ch_alpha = Challenge.derive(public_inputs, comm_words, q)
    if proof.challenge_alpha.alpha != ch_alpha.alpha:
        return False
    alpha = ch_alpha.alpha
    ch_beta = Challenge.derive([alpha], comm_words, q)
    if proof.challenge_beta.alpha != ch_beta.alpha:
        return False
    beta = ch_beta.alpha
    evals_ab = proof.evals_ab
    if any(v >= q for v in evals_ab) or any(v >= q for v in proof.evals_gamma):
        return False
    for x, (a, b, c, qv) in ((alpha, evals_ab[:4]), (beta, evals_ab[4:])):
        if field.mul_mod(qv, r1cs.eval_vanishing(x), q) != field.sub_mod(
                field.mul_mod(a, b, q), c, q):
            return False

    tr = _seed_witness_transcript(q, r1cs.m, r1cs.n, big_m, proof.mask_len, params, d_bound,
                                  [proof.pre_root], alpha, beta, evals_ab)
    r, etas, tau = _lincheck_challenges(tr, q)
    tr.absorb(b"sum-root", proof.sum_root)
    gamma = tr.challenge_field(q, b"sumcheck-gamma")
    if pow(gamma, big_m, q) == 1:
        return False
    tr.absorb_words(b"gamma-evals", list(proof.evals_gamma))
    lam = tr.challenge_field(q, b"fri-lambda")

    # the lincheck sumcheck identity at gamma
    u, r_pows = _row_weights(r1cs, r, etas)
    stride = big_m // r1cs.m
    try:
        if q == P:
            r_s_g = _lagrange_sum_geometric(r_pows, pow(omega_s, stride, q), gamma, omega_s,
                                            big_m, q)
            u_s_g = _lagrange_sum_geometric(u, omega_s, gamma, omega_s, big_m, q)
        else:
            r_s_g = _lagrange_sum(r_pows, [i * stride for i in range(r1cs.m)], gamma, omega_s,
                                  big_m, q)
            nz = [(j, v) for j, v in enumerate(u) if v]
            u_s_g = _lagrange_sum([v for _, v in nz], [j for j, _ in nz], gamma, omega_s,
                                  big_m, q) if nz else 0
    except DomainError:
        return False
    a_g, b_g, c_g, z_g, h_g, p_g = proof.evals_gamma[:6]
    mu_g = proof.evals_gamma[6] if zk else 0
    lhs = (r_s_g * ((etas[0] * a_g + etas[1] * b_g + etas[2] * c_g) % q) - u_s_g * z_g
           + tau * mu_g) % q
    if lhs != ((pow(gamma, big_m, q) - 1) * h_g + gamma * p_g) % q:
        return False

    offset = coset_offset(q)
    terms = _deep_terms(zk, alpha, beta, gamma, evals_ab, proof.evals_gamma,
                        [pow(omega_s, j, q) for j in range(len(public_inputs))],
                        [v % q for v in public_inputs])
    weights = _lambda_weights(len(terms), lam, q)
    sh_p = d_bound - (big_m - 1)
    p_idx = proof.n_pre + 1
    distinct_pts = list(dict.fromkeys(pt for _k, pt, _v in terms))

    def g_eval(index, half, lo_vals, hi_vals):
        out = []
        for pos, vals in ((index, lo_vals), (index + half, hi_vals)):
            x = offset * pow(omega_n, pos, q) % q
            invs = dict(zip(distinct_pts, batch_inverse([(x - pt) % q for pt in distinct_pts],
                                                        q)))
            acc = 0
            for w, (k, pt, v) in zip(weights, terms):
                acc = (acc + w * ((vals[k] - v) % q) % q * invs[pt]) % q
            out.append((acc + weights[-1] * pow(x, sh_p, q) % q * vals[p_idx]) % q)
        return out[0], out[1]

    def g_eval_batch(idx_arr, half, in_lo, in_hi):
        # g_eval over every query at once (fri_verify's native path): one
        # batch inversion of all the denominators, with g_eval's
        # DomainError on a zero one
        w_half = pow(omega_n, half, q)
        xs = [offset * pow(omega_n, int(i), q) % q for i in idx_arr]
        xs += [x * w_half % q for x in xs]
        n_pts = len(distinct_pts)
        invs = batch_inverse([(x - pt) % q for x in xs for pt in distinct_pts], q)
        rows = np.concatenate([in_lo, in_hi]).tolist()
        out = np.empty(len(xs), dtype=np.uint64)
        for j, (x, vals) in enumerate(zip(xs, rows)):
            inv = dict(zip(distinct_pts, invs[j * n_pts:(j + 1) * n_pts]))
            acc = 0
            for w, (k, pt, v) in zip(weights, terms):
                acc = (acc + w * ((vals[k] - v) % q) % q * inv[pt]) % q
            out[j] = (acc + weights[-1] * pow(x, sh_p, q) % q * vals[p_idx]) % q
        return out[:len(idx_arr)], out[len(idx_arr):]

    return fri_verify(proof.fri, proof.input_groups(), g_eval, n0, offset, omega_n, q, params,
                      tr, g_eval_batch=g_eval_batch if q == P else None)
