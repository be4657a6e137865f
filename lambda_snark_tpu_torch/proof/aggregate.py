"""Aggregated succinct proofs: S statements under one shared FRI (wire kind 8).

The port of the JAX package's ``proof/aggregate.py``. The statements' 4S
DEEP quotients fold into one combined low-degree claim under one
Fiat-Shamir challenge, so the fold layers, the final polynomial and the
query indices are shared. Per statement the proof keeps the lattice
commitment to Q, one interleaved input root (A~, B~, C~, Q~), the dual
challenges and the eight claimed evaluations, and one group opening per
shared query.

The prover is the kind-7 batch front end on the device (kernel Q, the ZK
masks and the LDE on kernel T, the group forest on kernel K, the
commitment on kernel R, or on the host at ring degree n < m), then:

    host    the aggregate transcript over every statement's root, points
            and evaluations; lambda; one ladder of lambda across the
            statements                                  (lambda_ladder)
    device  the DEEP quotients with those weights, summed over the
            statements into one codeword            (deep_combine_device,
                                                     sum_statements_device)
    device  one FRI over it, opening the S group trees at the shared
            indices                                 (fri_prove_device)

Plain and zero-knowledge proofs both take this route (the JAX package
proves ZK aggregates on its host route; the bytes are the same). The
verifier runs on the host. Proof bytes equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..commit.lwe import Commitment, LweContext
from ..core import field
from ..core.errors import DomainError, InvalidDimensionsError, SerializationError
from ..device import resolve
from ..r1cs.r1cs import R1CS
from ..transcript.challenge import Challenge
from ..utils.chacha import ChaCha20Rng
from . import fri_device
from .fri import (
    MAX_AGGREGATE_STATEMENTS,
    FriParams,
    FriProof,
    FriTranscript,
    coset_offset,
    fri_verify,
)
from .succinct import (
    _MAGIC,
    _MASK_LEN_CAP,
    WIRE_VERSION,
    _check_instance,
    _check_wire_version,
    _gl_frontend_applicable,
    _roots_to_words,
    statement_binding_words,
    zk_mask_len,
)
from .succinct_batch import _derive_batch_challenges, _draw_masks, _embed_and_eval, _Geometry
from .succinct_device import eval_device, finish_quotient_lde, quotient_lde_dispatch

KIND_R1CS_AGGREGATE = 8

__all__ = [
    "AggregatedProofR1CS",
    "StatementOpening",
    "prove_r1cs_succinct_aggregate",
    "verify_r1cs_succinct_aggregate",
]


@dataclasses.dataclass(frozen=True)
class StatementOpening:
    """One statement of an aggregated proof: the non-FRI fields of a kind-7
    proof."""

    commitment_q: Commitment
    input_root: bytes  # one interleaved Merkle root (A~, B~, C~, Q~)
    challenge_alpha: Challenge
    challenge_beta: Challenge
    evals: Tuple[int, ...]  # (A, B, C, Q at alpha), then at beta

    def to_bytes(self) -> bytes:
        out = struct.pack("<Q", len(self.commitment_q.words)) + self.commitment_q.to_bytes()
        out += self.input_root
        out += self.challenge_alpha.to_bytes() + self.challenge_beta.to_bytes()
        return out + struct.pack("<8Q", *self.evals)

    @staticmethod
    def read(data: bytes, off: int) -> Tuple["StatementOpening", int]:
        if off + 8 > len(data):
            raise SerializationError("truncated aggregate commitment length")
        (n_words,) = struct.unpack_from("<Q", data, off)
        off += 8
        if n_words > (1 << 24):
            raise SerializationError("unreasonable commitment length")
        if off + 8 * n_words > len(data):
            raise SerializationError("truncated aggregate commitment words")
        words = np.frombuffer(data, dtype="<u8", count=n_words, offset=off).astype(np.uint64)
        off += 8 * n_words
        if off + 32 > len(data):
            raise SerializationError("truncated aggregate input root")
        input_root = data[off: off + 32]
        off += 32
        if off + 80 > len(data):
            raise SerializationError("truncated aggregate challenges")
        ch_a = Challenge.from_bytes(data[off: off + 40])
        ch_b = Challenge.from_bytes(data[off + 40: off + 80])
        off += 80
        if off + 64 > len(data):
            raise SerializationError("truncated aggregate evaluations")
        evals = struct.unpack_from("<8Q", data, off)
        off += 64
        return StatementOpening(Commitment(words), input_root, ch_a, ch_b, tuple(evals)), off


@dataclasses.dataclass(frozen=True)
class AggregatedProofR1CS:
    """S succinct statements sharing one FRI proof (wire kind 8)."""

    statements: Tuple[StatementOpening, ...]
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

    def to_bytes(self) -> bytes:
        out = _MAGIC + bytes([KIND_R1CS_AGGREGATE, WIRE_VERSION])
        out += struct.pack("<QQIBHH", self.modulus, self.m, self.mask_len,
                           self.log_blowup, self.num_queries, self.final_len)
        out += struct.pack("<H", len(self.statements))
        out += b"".join(st.to_bytes() for st in self.statements)
        return out + self.fri.to_bytes()

    @staticmethod
    def from_bytes(data: bytes) -> "AggregatedProofR1CS":
        if len(data) < 9 or data[:8] != _MAGIC or data[8] != KIND_R1CS_AGGREGATE:
            raise SerializationError("bad aggregated-proof header")
        off = _check_wire_version(data, 9)
        if off + 25 > len(data):
            raise SerializationError("truncated aggregated proof header")
        modulus, m, mask_len, log_blowup, num_queries, final_len = struct.unpack_from(
            "<QQIBHH", data, off)
        off += 25
        if off + 2 > len(data):
            raise SerializationError("truncated statement count")
        (n_st,) = struct.unpack_from("<H", data, off)
        off += 2
        if n_st == 0 or n_st > MAX_AGGREGATE_STATEMENTS:
            raise SerializationError("unreasonable statement count")
        statements = []
        for _ in range(n_st):
            st, off = StatementOpening.read(data, off)
            statements.append(st)
        fri_proof, off = FriProof.read(data, off)
        return AggregatedProofR1CS(tuple(statements), fri_proof, m=m, mask_len=mask_len,
                                   log_blowup=log_blowup, num_queries=num_queries,
                                   final_len=final_len, modulus=modulus)


def _seed_aggregate_transcript(q: int, m: int, mask_len: int, params: FriParams,
                               d_bound: int,
                               statements: Sequence[Tuple[Sequence[bytes], int, int,
                                                          Sequence[int]]]) -> FriTranscript:
    """Absorb every statement's (roots, alpha, beta, evals): lambda is drawn
    only after every commitment and claim is fixed."""
    tr = FriTranscript()
    tr.absorb_words(b"aggregate-params",
                    [q, m, mask_len, params.log_blowup, params.num_queries,
                     params.final_len, d_bound, len(statements)])
    for roots, alpha, beta, evals in statements:
        for root in roots:
            tr.absorb(b"input-root", root)
        tr.absorb_words(b"points", [alpha, beta])
        tr.absorb_words(b"evals", list(evals))
    return tr


def prove_r1cs_succinct_aggregate(r1cs: R1CS, witnesses: Sequence[Sequence[int]],
                                  ctx: LweContext, seeds: Sequence[int], zk: bool = False,
                                  fri_params: Optional[FriParams] = None,
                                  blinding_seeds: Optional[Sequence[int]] = None,
                                  device_lde: bool = True, device="cuda") -> AggregatedProofR1CS:
    """One aggregated proof of a batch of statements of one Goldilocks
    roots-domain circuit, byte-identical to the JAX package's. Runs on the
    card unless ``device="cpu"`` (every kernel as its plain twin).

    The parameters are the JAX package's, in its order, then ``device``;
    ``zk=True`` needs one blinding seed per witness, and ``device_lde``
    chooses between JAX routes with the same bytes and is ignored."""
    params = fri_params or FriParams()
    params.validate()
    s = len(witnesses)
    if s == 0:
        raise InvalidDimensionsError("aggregate proving needs at least one witness")
    if s > MAX_AGGREGATE_STATEMENTS:
        raise InvalidDimensionsError(f"aggregate batch {s} exceeds MAX_AGGREGATE_STATEMENTS "
                                     f"({MAX_AGGREGATE_STATEMENTS})")
    if len(seeds) != s:
        raise InvalidDimensionsError("need one seed per witness")
    if zk and (blinding_seeds is None or len(blinding_seeds) != s):
        raise InvalidDimensionsError("zk aggregate proving needs one blinding seed per witness")
    if not _gl_frontend_applicable(r1cs):
        raise DomainError("aggregated succinct proving requires a Goldilocks roots-domain "
                          "circuit (the batched front-end's field)")
    dev = resolve(device)
    geo = _Geometry(r1cs, params, zk_mask_len(params) if zk else 0)
    q, n0 = geo.q, geo.n0
    masks = None
    if zk:
        masks = _draw_masks([ChaCha20Rng.from_u64(b) for b in blinding_seeds], geo.mask_len, q)
    d = quotient_lde_dispatch(*_embed_and_eval(r1cs, witnesses, dev), n0, geo.offset, ctx,
                              list(seeds), masks)
    commitments, forest = finish_quotient_lde(d)
    chals, alphas, betas = _derive_batch_challenges(r1cs, witnesses, commitments, forest.roots,
                                                    q)
    evals = eval_device(d.polys, alphas, betas)
    tr = _seed_aggregate_transcript(
        q, geo.m, geo.mask_len, params, geo.d_bound,
        [([forest.roots[i]], int(alphas[i]), int(betas[i]), [int(v) for v in evals[i]])
         for i in range(s)])
    lam = tr.challenge_field(q, b"fri-lambda")
    g = fri_device.deep_combine_device(d.lde, alphas, betas, None, evals, geo.offset,
                                       geo.omega_n,
                                       lam_tables=fri_device.lambda_ladder(lam, s, 4))
    fri_proof = fri_device.fri_prove_device(
        fri_device.sum_statements_device(g), [(d.lde.reshape(1, 4 * s, n0), forest)],
        geo.offset, geo.omega_n, q, params, [tr])[0]
    statements = tuple(
        StatementOpening(commitments[i], forest.roots[i], *chals[i],
                         tuple(int(v) for v in evals[i]))
        for i in range(s))
    return AggregatedProofR1CS(statements, fri_proof, m=geo.m, mask_len=geo.mask_len,
                               log_blowup=params.log_blowup, num_queries=params.num_queries,
                               final_len=params.final_len, modulus=q)


def verify_r1cs_succinct_aggregate(proof: AggregatedProofR1CS,
                                   public_inputs_list: Sequence[Sequence[int]], r1cs: R1CS,
                                   min_params: Optional[FriParams] = None) -> bool:
    """Verify an aggregated proof on the host (one public-input vector per
    statement, in order); ``min_params`` (default ``FriParams()``) is the
    floor on the prover's FRI parameters."""
    q = r1cs.modulus
    if proof.modulus != q or proof.m != r1cs.m or proof.mask_len > _MASK_LEN_CAP:
        return False
    s = len(proof.statements)
    if s == 0 or len(public_inputs_list) != s:
        return False
    params = proof.fri_params
    try:
        params.validate()
        d_bound, n0, omega_n = _check_instance(r1cs, params, proof.mask_len)
    except DomainError:
        return False
    if not params.at_least(min_params or FriParams()):
        return False

    # 1. per statement: its challenges and the quotient identity at both
    alphas: List[int] = []
    betas: List[int] = []
    for st, public in zip(proof.statements, public_inputs_list):
        comm_words = (list(statement_binding_words(st.commitment_q, r1cs))
                      + _roots_to_words([st.input_root]))
        ch_alpha = Challenge.derive(public, comm_words, q)
        if st.challenge_alpha.alpha != ch_alpha.alpha:
            return False
        alpha = ch_alpha.alpha
        ch_beta = Challenge.derive([alpha], comm_words, q)
        if st.challenge_beta.alpha != ch_beta.alpha:
            return False
        beta = ch_beta.alpha
        evals = st.evals
        if len(evals) != 8 or any(v >= q for v in evals):
            return False
        for x, (a, b, c, qv) in ((alpha, evals[:4]), (beta, evals[4:])):
            if field.mul_mod(qv, r1cs.eval_vanishing(x), q) != field.sub_mod(
                    field.mul_mod(a, b, q), c, q):
                return False
        alphas.append(alpha)
        betas.append(beta)

    # 2. the shared FRI over the combined DEEP quotient
    offset = coset_offset(q)
    tr = _seed_aggregate_transcript(
        q, r1cs.m, proof.mask_len, params, d_bound,
        [([st.input_root], alphas[i], betas[i], list(st.evals))
         for i, st in enumerate(proof.statements)])
    lam = tr.challenge_field(q, b"fri-lambda")
    all_evals = [st.evals for st in proof.statements]

    def g_eval(index, half, lo_vals, hi_vals):
        out = []
        for pos, vals in ((index, lo_vals), (index + half, hi_vals)):
            x = offset * pow(omega_n, pos, q) % q
            acc, lam_pow = 0, 1
            for i in range(s):
                ia = field.mod_inverse((x - alphas[i]) % q, q)
                ib = field.mod_inverse((x - betas[i]) % q, q)
                if ia is None or ib is None:
                    raise DomainError("challenge point on the evaluation domain")
                for k in range(4):
                    fv = vals[4 * i + k]
                    lam2 = lam_pow * lam % q
                    acc = (acc + lam_pow * ((fv - all_evals[i][k]) % q) % q * ia
                           + lam2 * ((fv - all_evals[i][4 + k]) % q) % q * ib) % q
                    lam_pow = lam2 * lam % q
            out.append(acc)
        return out[0], out[1]

    return fri_verify(proof.fri, [(st.input_root, 4) for st in proof.statements], g_eval, n0,
                      offset, omega_n, q, params, tr)
