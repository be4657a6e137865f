"""Succinct R1CS proofs with FRI-bound openings (wire kind 7, v4).

The port's copy of the JAX package's ``proof/succinct.py``: the proof
container and its bytes, the wire-v4 challenge binding (SHA3 of the
commitment words, then the circuit digest, then the input root), the shared
transcript seeding, the prover (plain or zero-knowledge: the batch of one on
the device route for Goldilocks circuits on the power-of-two roots domain,
``_gl_frontend_applicable``; the host route ``_prove_host`` for every other
circuit, chosen by field and domain as in the JAX package), a host verifier (``hashlib`` and Python ints, no native
library), and the zero-knowledge view of a proof with its simulator
(``succinct_view``, ``simulate_succinct_view``).

Zero knowledge: with rho_A, rho_B, rho_C uniform of length ``mask_len`` =
2 num_queries + 8, the committed polynomials are A~ = A + Z_H rho_A, B~ and
C~ alike, and Q~ = Q + rho_A B + rho_B A + Z_H rho_A rho_B - rho_C, so
A~ B~ - C~ = Q~ Z_H still holds and any ``mask_len`` codeword positions are
jointly uniform; the lattice commitment stays on the unmasked Q.

The verifier checks the quotient identity Q(x) Z_H(x) = A(x) B(x) - C(x) at
the dual Fiat-Shamir challenges and binds every claimed evaluation to its
committed polynomial through FRI on the DEEP quotient
G = sum_k lambda^t (f_k(X) - v_k) / (X - point).
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..commit import lwe
from ..commit.lwe import Commitment, LweContext
from ..core import field
from ..core.errors import DomainError, InvalidWitnessError, SerializationError
from ..device import resolve
from ..ops import modarith
from ..ops.modarith import GOLDILOCKS
from ..ops.ntt import (
    NttPlan,
    ntt_forward,
    ntt_forward_negacyclic,
    ntt_inverse,
    ntt_inverse_negacyclic,
)
from ..r1cs import poly as polyops
from ..r1cs.domain import ROOTS
from ..r1cs.r1cs import R1CS
from ..transcript.challenge import Challenge, derive_dual
from ..utils.artifacts import circuit_digest
from ..utils.chacha import ChaCha20Rng
from .fri import (
    FriParams,
    FriProof,
    FriTranscript,
    _gl_powers,
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

_MAGIC = b"LSNKTPU1"
KIND_R1CS_SUCCINCT = 7
WIRE_VERSION = 4

#: Verifier-side cap on the prover-chosen mask length.
_MASK_LEN_CAP = 4096


def commitment_digest_words(commitment: Commitment) -> np.ndarray:
    """SHA3-256("LSNK-commitment-v4" || LE64 words) as 4 LE64 words."""
    words = np.ascontiguousarray(np.asarray(commitment.words, dtype=np.uint64)).astype("<u8")
    dig = hashlib.sha3_256(b"LSNK-commitment-v4" + words.tobytes()).digest()
    return np.frombuffer(dig, dtype="<u8")


def statement_binding_words(commitment: Commitment, r1cs: R1CS) -> np.ndarray:
    """The v4 challenge prefix: commitment digest || circuit digest (8 words)."""
    cdig = bytes.fromhex(circuit_digest(r1cs))
    return np.concatenate([commitment_digest_words(commitment),
                           np.frombuffer(cdig, dtype="<u8")])


def _check_wire_version(data: bytes, off: int) -> int:
    if off >= len(data):
        raise SerializationError("truncated proof header")
    ver = data[off]
    if ver != WIRE_VERSION:
        raise SerializationError(
            f"unsupported succinct wire version {ver} (expected "
            f"{WIRE_VERSION}; odd values indicate a pre-0.7 blob)")
    return off + 1


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 1 else 1


def zk_mask_len(params: FriParams) -> int:
    """Zero-knowledge mask length: every queried pair plus alpha and beta."""
    return 2 * params.num_queries + 8


def _degree_bound(m: int, mask_len: int) -> int:
    """Smallest power of two covering every committed polynomial."""
    return _next_pow2(m + 2 * mask_len) if mask_len else _next_pow2(m)


def _roots_to_words(roots: Sequence[bytes]) -> List[int]:
    return [int.from_bytes(root[i: i + 8], "little") for root in roots for i in range(0, 32, 8)]


@dataclasses.dataclass(frozen=True)
class SuccinctProofR1CS:
    """R1CS proof with FRI-bound openings (wire kind 7); ``mask_len > 0``
    marks the zero-knowledge variant."""

    commitment_q: Commitment
    input_root: bytes
    challenge_alpha: Challenge
    challenge_beta: Challenge
    a_alpha: int
    b_alpha: int
    c_alpha: int
    q_alpha: int
    a_beta: int
    b_beta: int
    c_beta: int
    q_beta: int
    fri: FriProof
    m: int
    mask_len: int
    log_blowup: int
    num_queries: int
    final_len: int
    modulus: int

    @property
    def fri_params(self) -> FriParams:
        return FriParams(log_blowup=self.log_blowup, num_queries=self.num_queries,
                         final_len=self.final_len)

    def _evals(self) -> Tuple[int, ...]:
        return (self.a_alpha, self.b_alpha, self.c_alpha, self.q_alpha,
                self.a_beta, self.b_beta, self.c_beta, self.q_beta)

    def to_bytes(self) -> bytes:
        out = _MAGIC + bytes([KIND_R1CS_SUCCINCT, WIRE_VERSION])
        out += struct.pack("<QQIBHH", self.modulus, self.m, self.mask_len,
                           self.log_blowup, self.num_queries, self.final_len)
        out += struct.pack("<Q", len(self.commitment_q.words)) + self.commitment_q.to_bytes()
        out += self.input_root
        out += self.challenge_alpha.to_bytes() + self.challenge_beta.to_bytes()
        out += struct.pack("<8Q", *self._evals())
        return out + self.fri.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "SuccinctProofR1CS":
        if len(data) < 9 or data[:8] != _MAGIC or data[8] != KIND_R1CS_SUCCINCT:
            raise SerializationError("bad succinct-proof header")
        off = _check_wire_version(data, 9)
        if off + 25 > len(data):
            raise SerializationError("truncated succinct proof header")
        modulus, m, mask_len, log_blowup, num_queries, final_len = struct.unpack_from(
            "<QQIBHH", data, off)
        off += 25
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
        if off + 32 > len(data):
            raise SerializationError("truncated input root")
        input_root = data[off: off + 32]
        off += 32
        if off + 80 > len(data):
            raise SerializationError("truncated challenges")
        ch_a = Challenge.from_bytes(data[off: off + 40])
        ch_b = Challenge.from_bytes(data[off + 40: off + 80])
        off += 80
        if off + 64 > len(data):
            raise SerializationError("truncated evaluations")
        evals = struct.unpack_from("<8Q", data, off)
        off += 64
        fri_proof, off = FriProof.read(data, off)
        return SuccinctProofR1CS(
            Commitment(words), input_root, ch_a, ch_b, *evals, fri=fri_proof, m=m,
            mask_len=mask_len, log_blowup=log_blowup, num_queries=num_queries,
            final_len=final_len, modulus=modulus)


def _seed_fri_transcript(q: int, m: int, mask_len: int, params: FriParams, d_bound: int,
                         input_roots: Sequence[bytes], alpha: int, beta: int,
                         evals: Sequence[int]) -> FriTranscript:
    tr = FriTranscript()
    tr.absorb_words(b"succinct-params", [q, m, mask_len, params.log_blowup,
                                         params.num_queries, params.final_len, d_bound])
    for root in input_roots:
        tr.absorb(b"input-root", root)
    tr.absorb_words(b"points", [alpha, beta])
    tr.absorb_words(b"evals", list(evals))
    return tr


def _check_instance(r1cs: R1CS, params: FriParams, mask_len: int) -> Tuple[int, int, int]:
    """Validate field and domain support; return (d_bound, n0, omega_n0)."""
    q = r1cs.modulus
    if not fri_supported(q):
        raise DomainError(
            f"succinct openings need an NTT field (modulus {q} has no "
            "registered 2-adic subgroup); use the revealing openings instead")
    if r1cs.domain.kind != ROOTS:
        raise DomainError("succinct openings require a roots interpolation domain "
                          f"(got {r1cs.domain.kind})")
    d_bound = _degree_bound(r1cs.m, mask_len)
    n0 = d_bound << params.log_blowup
    if n0 > max_codeword_size(q):
        raise DomainError(
            f"codeword size {n0} exceeds the 2-adic limit {max_codeword_size(q)} of "
            f"modulus {q}; lower log_blowup, num_queries, or the circuit size")
    return d_bound, n0, root_of_order(q, n0)


def _gl_frontend_applicable(r1cs: R1CS) -> bool:
    """Whether the circuit takes the device route: Goldilocks, on the roots
    domain of a power of two m >= 2 with omega = root_of_order(q, m)."""
    m = r1cs.m
    if r1cs.modulus != GOLDILOCKS or r1cs.domain.kind != ROOTS or m & (m - 1) or m < 2:
        return False
    return root_of_order(GOLDILOCKS, m) == r1cs.domain.omega % GOLDILOCKS


def _gl_trim(p: np.ndarray) -> np.ndarray:
    """p without its trailing zero coefficients (at least one left)."""
    nz = np.nonzero(p)[0]
    return p[: int(nz[-1]) + 1 if len(nz) else 1]


# --- Goldilocks host helpers: uint64 arrays in and out, torch ops on CPU words ----

_GL_PLANS: dict = {}


def _gl_plan(n: int) -> NttPlan:
    """The n-point Goldilocks transform on the CPU, omega = root_of_order(p, n),
    with psi = root_of_order(p, 2n) for the negacyclic one (the JAX
    package's ``goldilocks_ntt(n)``)."""
    if n not in _GL_PLANS:
        _GL_PLANS[n] = NttPlan.create(n, GOLDILOCKS, root_of_order(GOLDILOCKS, n),
                                      root_of_order(GOLDILOCKS, 2 * n))
    return _GL_PLANS[n]


def _gl_words(p) -> torch.Tensor:
    return modarith.to_words(np.asarray(p, dtype=np.uint64))


def _gl_sum(terms: torch.Tensor) -> int:
    """The sum mod p of canonical words, from exact sums of their 32-bit halves."""
    lo, hi = int((terms & modarith.M32).sum()), int(((terms >> 32) & modarith.M32).sum())
    return (lo + (hi << 32)) % GOLDILOCKS


def _gl_quotient_and_interpolations(r1cs: R1CS, witness: Sequence[int]):
    """(Q, A_z, B_z, C_z) as uint64 arrays, Q without its trailing zeros: the
    odd-coset quotient of ``R1CS.compute_quotient_poly`` and the
    interpolations of ``R1CS.interpolations``, on CPU words. Raises
    InvalidWitnessError for a witness that fails the constraints."""
    q = r1cs.modulus
    az, bz, cz = (_gl_words(ev) for ev in r1cs.compute_constraint_evals(witness))
    if not bool((modarith.mul_mod(az, bz, q) == cz).all()):
        raise InvalidWitnessError("witness does not satisfy R1CS constraints")
    plan = _gl_plan(r1cs.m)
    polys = [ntt_inverse(plan, x) for x in (az, bz, cz)]
    a_odd, b_odd, c_odd = (ntt_forward_negacyclic(plan, p) for p in polys)
    q_odd = modarith.mul_mod(modarith.sub_mod(modarith.mul_mod(a_odd, b_odd, q), c_odd, q),
                             field.mod_inverse(q - 2, q), q)
    q_coeffs = modarith.to_u64(ntt_inverse_negacyclic(plan, q_odd))
    return (_gl_trim(q_coeffs), *(modarith.to_u64(p) for p in polys))


def _gl_poly_eval(p, x: int) -> int:
    """p(x) mod p for uint64 coefficients."""
    if len(p) == 0:
        return 0
    return _gl_sum(modarith.mul_mod(_gl_words(p), _gl_words(_gl_powers(x, len(p))), GOLDILOCKS))


def _gl_conv(a, b) -> np.ndarray:
    """The exact product of two polynomials: a cyclic NTT of the next power
    of two >= len(a) + len(b) - 1."""
    out_len = len(a) + len(b) - 1
    plan = _gl_plan(max(_next_pow2(out_len), 2))
    fa, fb = (ntt_forward(plan, _gl_words(np.pad(np.asarray(x, dtype=np.uint64),
                                                 (0, plan.m - len(x))))) for x in (a, b))
    return modarith.to_u64(ntt_inverse(plan, modarith.mul_mod(fa, fb, GOLDILOCKS)))[:out_len]


def _gl_zh_mul(rho, m: int) -> np.ndarray:
    """(X^m - 1) rho."""
    rho = np.asarray(rho, dtype=np.uint64)
    out = np.zeros(m + len(rho), dtype=np.uint64)
    out[m:] = rho
    out[: len(rho)] = modarith.to_u64(modarith.sub_mod(_gl_words(out[: len(rho)]),
                                                       _gl_words(rho), GOLDILOCKS))
    return out


def _gl_add_padded(*polys) -> np.ndarray:
    """The sum of polynomials of any lengths, as long as the longest."""
    n = max(len(p) for p in polys)
    acc = torch.zeros(n, dtype=torch.int64)
    for p in polys:
        acc[: len(p)] = modarith.add_mod(acc[: len(p)], _gl_words(p), GOLDILOCKS)
    return modarith.to_u64(acc)


def _prove_host(r1cs: R1CS, witness: Sequence[int], ctx: LweContext, seed: int,
                params: FriParams, rng=None) -> SuccinctProofR1CS:
    """One kind-7 proof on the host (Python ints; ``proof.fri``'s host
    prover), the JAX package's route off the fast front end. ``rng`` (a
    ChaCha20 generator) makes it zero-knowledge."""
    q, m = r1cs.modulus, r1cs.m
    mask_len = zk_mask_len(params) if rng is not None else 0
    d_bound, n0, omega_n = _check_instance(r1cs, params, mask_len)
    offset = coset_offset(q)
    q_coeffs = r1cs.compute_quotient_poly(witness)  # validates the witness
    a_poly, b_poly, c_poly = r1cs.interpolations(witness)
    if rng is not None:
        rho_a, rho_b, rho_c = ([rng.next_u64() % q for _ in range(mask_len)] for _ in range(3))
        z_h = r1cs.domain.vanishing_poly()
        add, mul = polyops.poly_add, polyops.poly_mul
        a_t = add(a_poly, mul(z_h, rho_a, q), q)
        b_t = add(b_poly, mul(z_h, rho_b, q), q)
        c_t = add(c_poly, mul(z_h, rho_c, q), q)
        q_t = add(q_coeffs, mul(rho_a, b_poly, q), q)
        q_t = add(q_t, mul(rho_b, a_poly, q), q)
        q_t = add(q_t, mul(z_h, mul(rho_a, rho_b, q), q), q)
        q_t = polyops.poly_sub(q_t, rho_c, q)
    else:
        a_t, b_t, c_t, q_t = a_poly, b_poly, c_poly, q_coeffs
    polys = [a_t, b_t, c_t, q_t]
    codewords = [lde(p, n0, offset, omega_n, q) for p in polys]
    tree = commit_codeword_group(codewords)
    root = tree.root
    # the lattice commitment is to the unmasked Q
    commitment_q, _op = lwe.commit(ctx, q_coeffs, seed)
    comm_words = np.concatenate([statement_binding_words(commitment_q, r1cs),
                                 np.array(_roots_to_words([root]), dtype=np.uint64)])
    ch_alpha, ch_beta = derive_dual(r1cs.public_inputs(witness), comm_words, q)
    alpha, beta = ch_alpha.alpha, ch_beta.alpha
    evals = [polyops.poly_eval(p, x, q) for x in (alpha, beta) for p in polys]
    tr = _seed_fri_transcript(q, m, mask_len, params, d_bound, [root], alpha, beta, evals)
    lam = tr.challenge_field(q, b"fri-lambda")

    # the DEEP quotient sum_k lam^2k (f_k - v_k)/(x - alpha) + lam^(2k+1) (f_k - w_k)/(x - beta)
    xs = coset_points(offset, omega_n, n0, q)
    inv_a = batch_inverse([(x - alpha) % q for x in xs], q)
    inv_b = batch_inverse([(x - beta) % q for x in xs], q)
    g = [0] * n0
    lam_pow = 1
    for k, cw in enumerate(codewords):
        cw = [int(v) for v in cw]
        va, vb = evals[k], evals[4 + k]
        lam2 = lam_pow * lam % q
        for i in range(n0):
            g[i] = (g[i] + lam_pow * ((cw[i] - va) % q) % q * inv_a[i]
                    + lam2 * ((cw[i] - vb) % q) % q * inv_b[i]) % q
        lam_pow = lam2 * lam % q
    fri_proof = fri_prove(g, [(codewords, tree)], offset, omega_n, q, params, tr)
    return SuccinctProofR1CS(
        commitment_q, root, ch_alpha, ch_beta, *evals, fri=fri_proof, m=m,
        mask_len=mask_len, log_blowup=params.log_blowup, num_queries=params.num_queries,
        final_len=params.final_len, modulus=q)


def prove_r1cs_succinct(r1cs: R1CS, witness: Sequence[int], ctx: LweContext, seed: int,
                        zk: bool = False, fri_params: Optional[FriParams] = None,
                        blinding_seed: Optional[int] = None, rng=None,
                        device_lde: bool = False, device="cuda") -> SuccinctProofR1CS:
    """One kind-7 proof: the batch prover on a batch of one (the JAX
    package pins the two byte-equal), which takes the device route for a
    circuit of ``_gl_frontend_applicable`` and the host route otherwise.
    The parameters are the JAX package's, in its order, then ``device``.
    ``zk=True`` draws the masks from ``rng``,
    else from ChaCha20 seeded with ``blinding_seed``, else from OS entropy:
    rho_A, rho_B, rho_C in turn, ``mask_len`` draws ``next_u64() % q`` each.
    ``device_lde`` chooses a route in the JAX package whose bytes are the
    same either way, and is ignored."""
    from .succinct_batch import _prove_batch

    params = fri_params or FriParams()
    params.validate()
    dev = resolve(device)
    rngs = None
    if zk:
        if rng is None:
            if blinding_seed is not None:
                rng = ChaCha20Rng.from_u64(blinding_seed)
            else:
                import secrets

                rng = ChaCha20Rng(secrets.token_bytes(32))
        rngs = [rng]
    return _prove_batch(r1cs, [witness], ctx, [seed], params, rngs, None, dev)[0]


def verify_r1cs_succinct(proof: SuccinctProofR1CS, public_inputs: Sequence[int],
                         r1cs: R1CS, min_params: Optional[FriParams] = None) -> bool:
    """Verify a kind-7 proof (ZK or not) on the host. ``min_params``
    (default: ``FriParams()``) is the floor on the prover's FRI parameters."""
    q = r1cs.modulus
    if proof.modulus != q or proof.m != r1cs.m or proof.mask_len > _MASK_LEN_CAP:
        return False
    params = proof.fri_params
    try:
        params.validate()
        d_bound, n0, omega_n = _check_instance(r1cs, params, proof.mask_len)
    except DomainError:
        return False
    if not params.at_least(min_params or FriParams()):
        return False

    comm_words = np.concatenate([
        statement_binding_words(proof.commitment_q, r1cs),
        np.array(_roots_to_words([proof.input_root]), dtype=np.uint64)])
    ch_alpha = Challenge.derive(public_inputs, comm_words, q)
    if proof.challenge_alpha.alpha != ch_alpha.alpha:
        return False
    alpha = ch_alpha.alpha
    ch_beta = Challenge.derive([alpha], comm_words, q)
    if proof.challenge_beta.alpha != ch_beta.alpha:
        return False
    beta = ch_beta.alpha

    evals = proof._evals()
    if any(v >= q for v in evals):
        return False
    for x, (a, b, c, qv) in ((alpha, evals[:4]), (beta, evals[4:])):
        if field.mul_mod(qv, r1cs.eval_vanishing(x), q) != field.sub_mod(
                field.mul_mod(a, b, q), c, q):
            return False

    offset = coset_offset(q)
    tr = _seed_fri_transcript(q, r1cs.m, proof.mask_len, params, d_bound,
                              [proof.input_root], alpha, beta, evals)
    lam = tr.challenge_field(q, b"fri-lambda")

    def g_eval(index, half, lo_vals, hi_vals):
        out = []
        for pos, vals in ((index, lo_vals), (index + half, hi_vals)):
            x = offset * pow(omega_n, pos, q) % q
            da, db = (x - alpha) % q, (x - beta) % q
            iab = field.mod_inverse(da * db % q, q)
            if iab is None:
                raise DomainError("challenge point on the evaluation domain")
            ia, ib = iab * db % q, iab * da % q
            acc, lam_pow = 0, 1
            for k, fv in enumerate(vals):
                lam2 = lam_pow * lam % q
                acc = (acc + lam_pow * ((fv - evals[k]) % q) % q * ia
                       + lam2 * ((fv - evals[4 + k]) % q) % q * ib) % q
                lam_pow = lam2 * lam % q
            out.append(acc)
        return out[0], out[1]

    return fri_verify(proof.fri, [(proof.input_root, 4)], g_eval, n0, offset, omega_n, q,
                      params, tr, deep=_deep_arrays(lam, evals, alpha, beta, q))


def _deep_arrays(lam, evals, alpha, beta, q, n_polys: int = 4):
    """The standard DEEP weight, evaluation and point arrays for
    ``fri_verify(deep=...)``: the lambda ladder of the combined quotient,
    one column per committed polynomial."""
    wa = np.empty(n_polys, dtype=np.uint64)
    wb = np.empty(n_polys, dtype=np.uint64)
    lam_pow = 1
    for k in range(n_polys):
        lam2 = lam_pow * lam % q
        wa[k], wb[k] = lam_pow, lam2
        lam_pow = lam2 * lam % q
    ea = np.array([evals[k] % q for k in range(n_polys)], dtype=np.uint64)
    eb = np.array([evals[n_polys + k] % q for k in range(n_polys)], dtype=np.uint64)
    return (wa, wb, ea, eb, np.full(n_polys, alpha % q, dtype=np.uint64),
            np.full(n_polys, beta % q, dtype=np.uint64))


# --- zero-knowledge view and its simulator -------------------------------------------


@dataclasses.dataclass(frozen=True)
class SuccinctView:
    """What a (possibly simulated) kind-7 proof reveals of its polynomials:
    the claimed evaluations at alpha and beta and the queried codeword
    values, (a, b, c, q) value pairs per query."""

    alpha: int
    beta: int
    evals: Tuple[int, ...]  # (a, b, c, q) at alpha, then at beta
    positions: Tuple[int, ...]  # query indices in [0, n0/2)
    leaves: Tuple[Tuple[Tuple[int, int], ...], ...]  # [query][k] = (lo, hi)


def succinct_view(proof: SuccinctProofR1CS, r1cs: R1CS) -> SuccinctView:
    """The view of a real proof, its query positions replayed from the
    transcript as the verifier derives them."""
    params = proof.fri_params
    d_bound, n0, _omega_n = _check_instance(r1cs, params, proof.mask_len)
    q = proof.modulus
    evals = proof._evals()
    tr = _seed_fri_transcript(q, r1cs.m, proof.mask_len, params, d_bound, [proof.input_root],
                              proof.challenge_alpha.alpha, proof.challenge_beta.alpha, evals)
    tr.challenge_field(q, b"fri-lambda")
    for root in proof.fri.layer_roots:
        tr.challenge_field(q, b"fri-fold")
        tr.absorb(b"fri-layer-root", root)
    tr.challenge_field(q, b"fri-fold")
    tr.absorb_words(b"fri-final", proof.fri.final_coeffs)
    indices = tr.challenge_indices(n0 // 2, params.num_queries, b"fri-query")
    leaves = tuple(
        tuple((qr.input_openings[0].values[2 * k], qr.input_openings[0].values[2 * k + 1])
              for k in range(4))
        for qr in proof.fri.queries)
    return SuccinctView(alpha=proof.challenge_alpha.alpha, beta=proof.challenge_beta.alpha,
                        evals=evals, positions=tuple(indices), leaves=leaves)


def simulate_succinct_view(r1cs: R1CS, sim_seed: Optional[int] = None,
                           fri_params: Optional[FriParams] = None) -> SuccinctView:
    """A view drawn without a witness: alpha, beta and the positions
    uniform, (a, b, c) uniform at every revealed point and q through
    q = (a b - c) / Z_H(x), as the masked values of a real ZK proof are
    distributed. ``sim_seed`` seeds ChaCha20 (OS entropy when None)."""
    params = fri_params or FriParams()
    params.validate()
    q = r1cs.modulus
    _d_bound, n0, omega_n = _check_instance(r1cs, params, zk_mask_len(params))
    offset = coset_offset(q)
    if sim_seed is not None:
        rng = ChaCha20Rng.from_u64(sim_seed)
    else:
        import secrets

        rng = ChaCha20Rng(secrets.token_bytes(32))

    def u() -> int:
        return rng.next_u64() % q

    def zh(x: int) -> int:
        return (pow(x, r1cs.m, q) - 1) % q

    def point(x: int) -> Tuple[int, int, int, int]:
        a, b, c = u(), u(), u()
        return a, b, c, (a * b - c) % q * field.mod_inverse(zh(x), q) % q

    alpha = u()
    while not zh(alpha):
        alpha = u()
    beta = u()
    while not zh(beta):
        beta = u()
    ev = point(alpha) + point(beta)
    half = n0 // 2
    positions = tuple(rng.next_u64() % half for _ in range(params.num_queries))
    leaves = []
    for i0 in positions:
        lo = point(offset * pow(omega_n, i0, q) % q)
        hi = point(offset * pow(omega_n, i0 + half, q) % q)
        leaves.append(tuple((lo[k], hi[k]) for k in range(4)))
    return SuccinctView(alpha=alpha, beta=beta, evals=ev, positions=positions,
                        leaves=tuple(leaves))
