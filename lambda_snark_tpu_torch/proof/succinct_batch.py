"""Batched kind-7 proving: many FRI-bound proofs per device pass.

The port of the JAX package's ``prove_r1cs_succinct_batch(...,
device_lde=True)`` on its device front end (``_device_frontend``, non-ZK)
and its device FRI with host transcripts:

    host    witnesses -> (S, n) words                      (_embed_and_eval)
    device  SpMV (R1CS.constraint_evals_batch)
    device  kernel Q, twist, kernel N (LDE), kernel K (forest), kernel R
    host    dual challenges over commitment digest, circuit digest, root
    device  A, B, C, Q at alpha and beta                   (eval_device)
    host    FRI transcripts, lambda                        (_seed_batch_transcripts)
    device  DEEP combination, folds, kernel K per layer    (proof.fri_device)
    host    query assembly from one pull

Proof bytes equal the JAX package's for the same (context, circuit,
witnesses, seeds, parameters).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..commit.lwe import LweContext
from ..core.errors import DomainError, InvalidDimensionsError
from ..device import resolve
from ..ops import modarith
from ..r1cs.domain import ROOTS
from ..r1cs.r1cs import R1CS
from ..transcript.challenge import derive_dual
from . import fri_device
from .fri import FriParams, coset_offset, root_of_order
from .succinct import (
    _ZK_NOT_PORTED,
    SuccinctProofR1CS,
    _check_instance,
    _roots_to_words,
    _seed_fri_transcript,
    statement_binding_words,
)
from .succinct_device import eval_device, quotient_lde_device

__all__ = ["prove_r1cs_succinct_batch"]


def _check_circuit(r1cs: R1CS) -> None:
    """The port proves kind 7 over Goldilocks roots-domain circuits (the JAX
    package's vectorised front end); other fields are not ported."""
    m = r1cs.m
    if (r1cs.modulus != modarith.GOLDILOCKS or r1cs.domain.kind != ROOTS
            or m < 2 or m & (m - 1)
            or root_of_order(r1cs.modulus, m) != r1cs.domain.omega % r1cs.modulus):
        raise DomainError("the port proves kind 7 over Goldilocks circuits with the "
                          "power-of-two roots domain only")


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


def _device_frontend(r1cs, witnesses, ctx, seeds, params, device):
    """Constraint evaluations, quotient, LDE, forest, commitments, challenges
    and claimed evaluations for the whole batch."""
    q, m = r1cs.modulus, r1cs.m
    d_bound, n0, omega_n = _check_instance(r1cs, params, 0)
    offset = coset_offset(q)
    az, bz, cz = _embed_and_eval(r1cs, witnesses, device)
    lde, commitments, polys, forest = quotient_lde_device(az, bz, cz, n0, offset, ctx, seeds)
    chals, alphas, betas = _derive_batch_challenges(r1cs, witnesses, commitments,
                                                    forest.roots, q)
    evals = eval_device(polys, alphas, betas)
    return dict(d_bound=d_bound, n0=n0, omega_n=omega_n, offset=offset, lde=lde,
                commitments=commitments, forest=forest, chals=chals, alphas=alphas,
                betas=betas, evals=evals)


def prove_r1cs_succinct_batch(r1cs: R1CS, witnesses: Sequence[Sequence[int]],
                              ctx: LweContext, seeds: Sequence[int], zk: bool = False,
                              fri_params: Optional[FriParams] = None,
                              blinding_seeds: Optional[Sequence[int]] = None,
                              device_lde: bool = True, pipeline_chunk: Optional[int] = None,
                              device="cuda") -> List[SuccinctProofR1CS]:
    """Non-ZK kind-7 proofs for a batch of witnesses of one circuit, one
    commit seed each; byte-identical to the JAX package's
    ``prove_r1cs_succinct_batch`` and ``prove_r1cs_succinct``. Runs on the
    card unless ``device="cpu"`` (every kernel as its plain twin).

    The parameters are the JAX package's, in its order, then ``device``.
    ``zk=True`` raises NotImplementedError (ZK kind 7 is ROADMAP queue A.2).
    ``device_lde`` and ``pipeline_chunk`` choose routes in the JAX package
    that give the same bytes; the port proves the whole batch on its one
    device route."""
    params = fri_params or FriParams()
    params.validate()
    if len(seeds) != len(witnesses):
        raise InvalidDimensionsError("need one seed per witness")
    if zk:
        raise NotImplementedError(_ZK_NOT_PORTED)
    dev = resolve(device)
    if len(witnesses) == 0:
        return []
    _check_circuit(r1cs)
    q, m = r1cs.modulus, r1cs.m
    fe = _device_frontend(r1cs, witnesses, ctx, seeds, params, dev)
    trs, lams = _seed_batch_transcripts(q, m, 0, params, fe["d_bound"], fe["forest"].roots,
                                        fe["alphas"], fe["betas"], fe["evals"])
    g = fri_device.deep_combine_device(fe["lde"], fe["alphas"], fe["betas"], lams,
                                       fe["evals"], fe["offset"], fe["omega_n"])
    fri_proofs = fri_device.fri_prove_device(g, fe["lde"], fe["forest"], fe["offset"],
                                             fe["omega_n"], q, params, trs)
    evals = fe["evals"]
    return [
        SuccinctProofR1CS(
            fe["commitments"][i], fe["forest"].roots[i], *fe["chals"][i],
            *(int(v) for v in evals[i]), fri=fri_proofs[i], m=m, mask_len=0,
            log_blowup=params.log_blowup, num_queries=params.num_queries,
            final_len=params.final_len, modulus=q)
        for i in range(len(witnesses))
    ]
