"""Batched kind-7 proving: many FRI-bound proofs per device pass; kind 9 in
batches and streams.

The port of the JAX package's ``prove_r1cs_succinct_batch`` (its device
front end and device FRI chain), its chunk-pipelined prover
``_prove_pipelined`` and its service ``prove_r1cs_succinct_stream``:

    host    witnesses -> (S, n) words                      (_embed_and_eval)
    host    ZK: rho_A, rho_B, rho_C from ChaCha20 per statement (_draw_masks)
    device  SpMV, kernel Q, ZK masks (kernel T), LDE (kernel T), kernel K
            (the group forest), kernel R (the commitment)  (succinct_device)
    host    dual challenges over commitment digest, circuit digest, root
    device  A, B, C, Q at alpha and beta                   (eval_device)
    host    FRI transcripts, lambda                        (_seed_batch_transcripts)
    device  DEEP combination; the FRI chain: transcripts (kernel S), folds
            (kernel F), a forest per layer (kernel K), the final
            polynomials (kernel T), indices and openings (proof.fri_device)
    host    query assembly from one pull

That is the route of Goldilocks circuits on the power-of-two roots domain
(``succinct._gl_frontend_applicable``). Every other circuit (the 44-bit
field, the healthcare prime, other Goldilocks domains) is proved statement
by statement on the host (``succinct._prove_host``), as the JAX package
does. At ring degree n < m the device front end runs without kernel R: the
quotients come back in the front end's one pull and are committed on the
host (``succinct_device.finish_quotient_lde``).

With ``pipeline_chunk`` the batch runs in chunks, in the JAX package's
three phases: every chunk's front end is enqueued, then each chunk is
pulled and its FRI chain enqueued, then every chain's bundle is pulled.
Its gate is JAX's: a non-ZK batch longer than the chunk at ring degree
n >= m with ``fri_device.DEVICE_TRANSCRIPT`` on; otherwise the batch is
proved unchunked. Proofs depend only on (witness, seed, blinding seed), so
the bytes are the unchunked prover's.

Kind 9 (``prove_r1cs_witness_batch``, and the stream with
``witness_bind=True``) proves one ``prove_r1cs_witness`` per statement, as
the JAX package does.

Proof bytes equal the JAX package's for the same (context, circuit,
witnesses, seeds, blinding seeds, parameters).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..commit.lwe import LweContext
from ..core.errors import InvalidDimensionsError
from ..device import resolve
from ..ops import modarith
from ..r1cs.r1cs import R1CS
from ..transcript.challenge import derive_dual
from ..utils.chacha import ChaCha20Rng
from ..utils.timing import stage
from . import fri_device
from .fri import FriParams, coset_offset
from .succinct import (
    SuccinctProofR1CS,
    _check_instance,
    _gl_frontend_applicable,
    _prove_host,
    _roots_to_words,
    _seed_fri_transcript,
    statement_binding_words,
    zk_mask_len,
)
from .succinct_device import Dispatched, eval_device, finish_quotient_lde, quotient_lde_dispatch
from .succinct_witness import prove_r1cs_witness

__all__ = ["prove_r1cs_succinct_batch", "prove_r1cs_succinct_stream",
           "prove_r1cs_witness_batch"]

#: the seed-fold constant shared with ``prover_batched.prove_r1cs_stream``
_SEED_FOLD = 0x9E3779B97F4A7C15
#: salt separating the default blinding-seed stream from the proof seeds
_BLIND_SALT = 0xA5A5A5A55A5A5A5A


def _embed(r1cs: R1CS, witnesses) -> np.ndarray:
    """Witnesses -> (S, n) uint64 canonical mod q. Signed numpy values never
    pass through a uint64 cast (it would wrap them silently)."""
    q, n = r1cs.modulus, r1cs.n
    z = np.empty((len(witnesses), n), dtype=np.uint64)
    for i, w in enumerate(witnesses):
        if len(w) != n:
            raise InvalidDimensionsError(f"witness {i} length {len(w)} must equal n={n}")
        arr = None
        if isinstance(w, np.ndarray):
            if w.dtype == np.uint64:
                arr = w
            elif np.issubdtype(w.dtype, np.integer) and bool((w >= 0).all()):
                arr = w.astype(np.uint64)
        elif type(w) is list and all(type(v) is int for v in w):
            try:
                arr = np.asarray(w, dtype=np.uint64)
            except (OverflowError, TypeError, ValueError):
                arr = None
        if arr is not None and bool((arr < q).all()):
            z[i] = arr
        else:
            z[i] = np.array([int(v) % q for v in w], dtype=np.uint64)
    return z


def _embed_and_eval(r1cs: R1CS, witnesses, device):
    """(az, bz, cz) (S, m) words on ``device``; the SpMV runs there."""
    w = modarith.to_words(_embed(r1cs, witnesses), device)
    return r1cs.constraint_evals_batch(w)


def _draw_masks(rngs, mask_len: int, q: int) -> np.ndarray:
    """(3, S, L) uint64: per statement's generator, rho_A, rho_B, rho_C of
    ``mask_len`` draws ``next_u64() % q`` each, in that order."""
    masks = np.empty((3, len(rngs), mask_len), dtype=np.uint64)
    for i, rng in enumerate(rngs):
        for k in range(3):
            masks[k, i] = [rng.next_u64() % q for _ in range(mask_len)]
    return masks


def _derive_batch_challenges(r1cs: R1CS, witnesses, commitments, roots, q: int):
    """Per statement, the dual challenges over commitment digest, circuit
    digest and input root (wire v4)."""
    chals = []
    for w, comm, root in zip(witnesses, commitments, roots):
        comm_words = np.concatenate([statement_binding_words(comm, r1cs),
                                     np.array(_roots_to_words([root]), dtype=np.uint64)])
        chals.append(derive_dual(r1cs.public_inputs(w), comm_words, q))
    alphas = np.array([a.alpha for a, _b in chals], dtype=np.uint64)
    betas = np.array([b.alpha for _a, b in chals], dtype=np.uint64)
    return chals, alphas, betas


def _seed_batch_transcripts(q, m, mask_len, params, d_bound, roots, alphas, betas, evals):
    """Per statement, the seeded FRI transcript and its lambda."""
    trs, lams = [], np.empty(len(roots), dtype=np.uint64)
    for i, root in enumerate(roots):
        tr = _seed_fri_transcript(q, m, mask_len, params, d_bound, [root], int(alphas[i]),
                                  int(betas[i]), [int(v) for v in evals[i]])
        lams[i] = tr.challenge_field(q, b"fri-lambda")
        trs.append(tr)
    return trs, lams


class _Geometry:
    """The shapes shared by every chunk of one batch."""

    def __init__(self, r1cs: R1CS, params: FriParams, mask_len: int) -> None:
        self.q, self.m, self.mask_len, self.params = r1cs.modulus, r1cs.m, mask_len, params
        self.d_bound, self.n0, self.omega_n = _check_instance(r1cs, params, mask_len)
        self.offset = coset_offset(self.q)


def _back_end(r1cs: R1CS, witnesses, d: Dispatched, first: int, geo: _Geometry):
    """A chunk's challenges, evaluations, transcripts, DEEP and FRI. With
    ``DEVICE_TRANSCRIPT`` the FRI chain is only enqueued; either way the
    result is a function that returns the chunk's proofs (on the chain,
    after one pull of its bundle)."""
    q, params = geo.q, geo.params
    commitments, forest = finish_quotient_lde(d, first)
    stage("frontend:lde-pulled")
    chals, alphas, betas = _derive_batch_challenges(r1cs, witnesses, commitments, forest.roots,
                                                    q)
    stage("frontend:challenges")
    evals = eval_device(d.polys, alphas, betas)
    stage("frontend:evals-pulled")
    trs, lams = _seed_batch_transcripts(q, geo.m, geo.mask_len, params, geo.d_bound,
                                        forest.roots, alphas, betas, evals)
    stage("prove:transcripts-seeded")
    g = fri_device.deep_combine_device(d.lde, alphas, betas, lams, evals, geo.offset,
                                       geo.omega_n)
    stage("prove:deep-dispatched")
    fri_args = (g, [(d.lde, forest)], geo.offset, geo.omega_n, q, params, trs)
    pending, fri_proofs = None, None
    if fri_device.DEVICE_TRANSCRIPT:
        pending = fri_device.fri_chain_dispatch(*fri_args)
    else:
        fri_proofs = fri_device.fri_prove_device(*fri_args)

    def finish() -> List[SuccinctProofR1CS]:
        proofs = fri_device.fri_chain_finish(*pending) if fri_proofs is None else fri_proofs
        stage("prove:fri-done")
        return [
            SuccinctProofR1CS(
                commitments[i], forest.roots[i], *chals[i], *(int(v) for v in evals[i]),
                fri=proofs[i], m=geo.m, mask_len=geo.mask_len,
                log_blowup=params.log_blowup, num_queries=params.num_queries,
                final_len=params.final_len, modulus=q)
            for i in range(len(witnesses))
        ]

    return finish


def _prove_chunks(r1cs: R1CS, witnesses, ctx: LweContext, seeds, params: FriParams,
                  masks: Optional[np.ndarray], chunk: int, dev: torch.device
                  ) -> List[SuccinctProofR1CS]:
    """Prove the batch in chunks of ``chunk`` statements (one chunk: the
    unchunked prover) in the JAX package's three phases
    (``_prove_pipelined``): (A) every chunk's front end enqueued, (B) per
    chunk its pull, challenges, evaluations, DEEP and FRI chain enqueued,
    (C) every chunk's FRI bundle pulled and its proofs assembled."""
    geo = _Geometry(r1cs, params, 0 if masks is None else masks.shape[2])
    slices = [slice(i, min(i + chunk, len(witnesses))) for i in range(0, len(witnesses), chunk)]
    stage("prove:start")
    fronts = []
    for sl in slices:
        stage("frontend:lde-dispatch")
        fronts.append(quotient_lde_dispatch(*_embed_and_eval(r1cs, witnesses[sl], dev), geo.n0,
                                            geo.offset, ctx, list(seeds[sl]),
                                            None if masks is None else masks[:, sl]))
    finishes = [_back_end(r1cs, witnesses[sl], d, sl.start, geo)
                for sl, d in zip(slices, fronts)]
    return [proof for finish in finishes for proof in finish()]


def _prove_batch(r1cs: R1CS, witnesses, ctx: LweContext, seeds, params: FriParams,
                 mask_rngs, pipeline_chunk: Optional[int], dev: torch.device
                 ) -> List[SuccinctProofR1CS]:
    """Kind-7 proofs of a batch; ``mask_rngs`` (one generator per
    statement) makes them zero-knowledge. A circuit off the device route is
    proved on the host, statement by statement."""
    if len(witnesses) == 0:
        return []
    if not _gl_frontend_applicable(r1cs):
        return [_prove_host(r1cs, w, ctx, seed, params, rng)
                for w, seed, rng in zip(witnesses, seeds, mask_rngs or [None] * len(seeds))]
    zk = mask_rngs is not None
    masks = _draw_masks(mask_rngs, zk_mask_len(params), r1cs.modulus) if zk else None
    s = len(witnesses)
    chunk = s
    if (pipeline_chunk and not zk and fri_device.DEVICE_TRANSCRIPT and ctx.n >= r1cs.m
            and s > pipeline_chunk):
        chunk = pipeline_chunk
    return _prove_chunks(r1cs, witnesses, ctx, seeds, params, masks, chunk, dev)


def prove_r1cs_succinct_batch(r1cs: R1CS, witnesses: Sequence[Sequence[int]],
                              ctx: LweContext, seeds: Sequence[int], zk: bool = False,
                              fri_params: Optional[FriParams] = None,
                              blinding_seeds: Optional[Sequence[int]] = None,
                              device_lde: bool = True, pipeline_chunk: Optional[int] = None,
                              device="cuda") -> List[SuccinctProofR1CS]:
    """Kind-7 proofs for a batch of witnesses of one circuit, one commit
    seed each; byte-identical to the JAX package's
    ``prove_r1cs_succinct_batch`` and ``prove_r1cs_succinct``. Runs on the
    card unless ``device="cpu"`` (every kernel as its plain twin); a circuit
    off the device route is proved on the host either way.

    The parameters are the JAX package's, in its order, then ``device``.
    ``zk=True`` needs one blinding seed per witness: statement i's masks
    come from ChaCha20 seeded with ``blinding_seeds[i]``. ``pipeline_chunk``
    proves a non-ZK batch longer than it in chunks of that many statements
    (the same bytes; see ``_prove_chunks``); ``device_lde`` chooses
    between JAX routes with the same bytes and is ignored."""
    params = fri_params or FriParams()
    params.validate()
    if len(seeds) != len(witnesses):
        raise InvalidDimensionsError("need one seed per witness")
    if zk and (blinding_seeds is None or len(blinding_seeds) != len(witnesses)):
        raise InvalidDimensionsError("zk batch proving needs one blinding seed per witness")
    dev = resolve(device)
    rngs = [ChaCha20Rng.from_u64(b) for b in blinding_seeds] if zk else None
    return _prove_batch(r1cs, witnesses, ctx, seeds, params, rngs, pipeline_chunk, dev)


def prove_r1cs_witness_batch(r1cs: R1CS, witnesses: Sequence[Sequence[int]], ctx: LweContext,
                             seeds: Sequence[int], zk: bool = False,
                             fri_params: Optional[FriParams] = None,
                             blinding_seeds: Optional[Sequence[int]] = None,
                             device_lde: bool = True, device="cuda") -> list:
    """Kind-9 proofs for a batch of witnesses of one circuit, one
    ``prove_r1cs_witness`` per statement (as the JAX package proves them),
    byte-identical to the JAX package's ``prove_r1cs_witness_batch``.
    The parameters are the JAX package's, in its order, then ``device``;
    ``zk=True`` needs one blinding seed per witness, and ``device_lde`` is
    ignored."""
    params = fri_params or FriParams()
    params.validate()
    if len(seeds) != len(witnesses):
        raise InvalidDimensionsError("need one seed per witness")
    if zk and (blinding_seeds is None or len(blinding_seeds) != len(witnesses)):
        raise InvalidDimensionsError(
            "zk witness batch proving needs one blinding seed per witness")
    dev = resolve(device)
    return [prove_r1cs_witness(r1cs, w, ctx, seed, zk=zk, fri_params=params,
                               blinding_seed=blinding_seeds[i] if zk else None, device=dev)
            for i, (w, seed) in enumerate(zip(witnesses, seeds))]


def _index_seed(master: int, index: int) -> int:
    """Statement ``index``'s seed: the same for any partition of the stream."""
    return (master ^ (_SEED_FOLD * (index + 1))) & ((1 << 63) - 1)


def prove_r1cs_succinct_stream(r1cs: R1CS, witnesses, ctx: LweContext, seed: int,
                               batch: int = 8, zk: bool = False,
                               fri_params: Optional[FriParams] = None,
                               blinding_seed: Optional[int] = None, store=None,
                               device_lde: bool = True, label_prefix: str = "succinct",
                               pipeline_chunk: Optional[int] = None,
                               witness_bind: bool = False, device="cuda"):
    """Yield ``(index, proof)`` for a witness stream, in order, proved in
    batches of ``batch``: kind 7 (``prove_r1cs_succinct_batch``), or kind 9
    (``prove_r1cs_witness_batch``) with ``witness_bind=True``.

    Statement i's seed is ``_index_seed(seed, i)`` and, under ZK, its
    blinding seed ``_index_seed(b, i)`` with b = ``blinding_seed`` or
    ``seed ^ _BLIND_SALT``, so any partition of the stream gives the same
    bytes. With ``store`` (a ``ProofStore``) each proof is saved under the
    label ``"{label_prefix}-{index}"`` (kind 9: ``"{label_prefix}-w-{index}"``)
    as it is yielded, and a statement the store holds is served from it,
    byte-identical, so a cut run resumes."""
    params = fri_params or FriParams()
    params.validate()
    dev = resolve(device)
    return _stream(r1cs, witnesses, ctx, seed, batch, zk, params, blinding_seed, store,
                   label_prefix, pipeline_chunk, witness_bind, dev)


def _stream(r1cs, witnesses, ctx, seed, batch, zk, params, blinding_seed, store,
            label_prefix, pipeline_chunk, witness_bind, dev):
    from ..utils.artifacts import statement_digest

    blind_master = blinding_seed if blinding_seed is not None else seed ^ _BLIND_SALT
    prefix = f"{label_prefix}-w" if witness_bind else label_prefix
    pending: list = []  # (index, witness)

    def flush():
        if not pending:
            return
        idxs = [i for i, _w in pending]
        ws = [w for _i, w in pending]
        seeds = [_index_seed(seed, i) for i in idxs]
        blinds = [_index_seed(blind_master, i) for i in idxs] if zk else None
        if witness_bind:
            proofs = prove_r1cs_witness_batch(r1cs, ws, ctx, seeds, zk=zk, fri_params=params,
                                              blinding_seeds=blinds, device=dev)
        else:
            proofs = prove_r1cs_succinct_batch(r1cs, ws, ctx, seeds, zk=zk, fri_params=params,
                                               blinding_seeds=blinds,
                                               pipeline_chunk=pipeline_chunk, device=dev)
        for (index, w), proof, s in zip(pending, proofs, seeds):
            if store is not None:
                store.save(r1cs, r1cs.public_inputs(w), s, proof, label=f"{prefix}-{index}")
            yield index, proof
        pending.clear()

    for index, w in enumerate(witnesses):
        if store is not None:
            key = statement_digest(r1cs, r1cs.public_inputs(w), _index_seed(seed, index),
                                   f"{prefix}-{index}")
            if store.contains(key):
                yield from flush()
                yield index, store.load(key)
                continue
        pending.append((index, w))
        if len(pending) == batch:
            yield from flush()
    yield from flush()
