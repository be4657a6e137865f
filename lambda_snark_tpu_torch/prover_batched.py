"""Batched R1CS proving: the device prove stage between host steps.

The counterpart of ``prove_r1cs_batched`` and ``prove_r1cs_stream`` in the
JAX package's ``prover_batched.py``:

    host:   witnesses -> (B, n) words; SpMV (on the device, ``R1CS.constraint_evals_batch``)
    device: kernel Q (quotient), threefry sampler, kernel R (commitment)
    host:   SHA3 transcripts, Horner evaluations, proof assembly

For the same (context, circuit, witnesses, seed) they return proofs whose
``to_bytes()`` equal the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .commit.lwe import Commitment, LweContext
from .commit.lwe_device import DeviceCommitContext
from .core import field
from .core.errors import DomainError, InvalidDimensionsError, InvalidWitnessError
from .device import resolve
from .ops import modarith
from .ops.sampler import prng_key
from .pipeline import ProvePlan, prove_stage_batch, prove_stage_batch_zk
from .proof.types import EvalOpening, ProofR1CS, ProofR1csZk
from .r1cs.r1cs import R1CS
from .transcript.challenge import derive_dual
from .utils.chacha import ChaCha20Rng

_PLAN_CACHE: dict = {}


def prove_plan(r1cs: R1CS, ctx: LweContext, device) -> ProvePlan:
    """The cached prove plan for (m, q, ctx, device)."""
    key = (r1cs.m, r1cs.modulus, id(ctx), str(device))
    if key not in _PLAN_CACHE:
        dctx = DeviceCommitContext.from_host(ctx, device)
        _PLAN_CACHE[key] = (ctx, ProvePlan.create(r1cs.m, r1cs.modulus, dctx))
    return _PLAN_CACHE[key][1]


def witness_words(witnesses, n: int, q: int) -> np.ndarray:
    """Witnesses (B sequences of n ints, or a (B, n) array) -> (B, n) uint64 mod q."""
    try:
        arr = np.asarray(witnesses, dtype=np.uint64)
    except OverflowError:  # negative or >= 2^64 entries
        arr = np.array([[int(v) % q for v in w] for w in witnesses], dtype=np.uint64)
    except ValueError as exc:  # ragged rows
        raise InvalidDimensionsError(f"witnesses must all have {n} entries") from exc
    if arr.ndim != 2 or arr.shape[1] != n:
        raise InvalidDimensionsError(f"witnesses must be (B, {n}), got {arr.shape}")
    return arr % np.uint64(q)


def prove_r1cs_batched(
    r1cs: R1CS,
    witnesses: Sequence[Sequence[int]],
    ctx: LweContext,
    seed: int,
    zk: bool = False,
    blinding_seed: Optional[int] = None,
    device="cuda",
):
    """Prove B witnesses of one roots-domain R1CS in one device stage.

    ``zk=True`` commits to Q' = Q + r Z_H with per-proof r drawn from
    ChaCha20 seeded by ``blinding_seed`` (default ``seed``); it needs ring
    degree n >= m + 1. Returns a list of ProofR1CS or ProofR1csZk."""
    dev = resolve(device)
    pp = _checked_plan(r1cs, ctx, zk, dev)
    out, blinding = _dispatch(r1cs, pp, witnesses, seed & 0x7FFFFFFF, zk,
                              blinding_seed if blinding_seed is not None else seed)
    return assemble_proofs(r1cs, witnesses, out, zk=zk, blinding=blinding)


def _checked_plan(r1cs: R1CS, ctx: LweContext, zk: bool, dev) -> ProvePlan:
    if r1cs.domain.kind != "roots":
        raise DomainError(
            "batched device proving requires a roots (NTT) domain; "
            f"got {r1cs.domain.kind} for q={r1cs.modulus}, m={r1cs.m}"
        )
    if r1cs.m > ctx.n or (zk and r1cs.m + 1 > ctx.n):
        raise DomainError(
            f"quotient length (m={r1cs.m}{'+1 for ZK' if zk else ''}) "
            f"exceeds ring degree {ctx.n}"
        )
    pp = prove_plan(r1cs, ctx, dev)
    if pp.omega != r1cs.domain.omega % r1cs.modulus:
        raise DomainError("device plan omega != r1cs domain omega")
    return pp


def _dispatch(r1cs: R1CS, pp: ProvePlan, witnesses, key_seed: int, zk: bool,
              blinding_seed: int):
    """Witness upload, SpMV and the device stage of one batch, enqueued on
    the device without waiting for it: (device outputs, blinding or None)."""
    q = r1cs.modulus
    dev = pp.dctx.device
    w = _upload(witness_words(witnesses, r1cs.n, q), dev)
    a_e, b_e, c_e = r1cs.constraint_evals_batch(w)
    key = prng_key(key_seed)
    if not zk:
        return prove_stage_batch(pp, a_e, b_e, c_e, key), None
    rng = ChaCha20Rng.from_u64(blinding_seed)
    blinding = [rng.next_u64() % q for _ in range(w.shape[0])]
    return prove_stage_batch_zk(pp, a_e, b_e, c_e, _upload(blinding, dev), key), blinding


def _upload(values, dev) -> torch.Tensor:
    """uint64 values -> int64 words on ``dev``; to a card from pinned memory
    without a wait, so the host goes on while the copy runs."""
    if dev.type != "cuda":
        return modarith.to_words(values, dev)
    return modarith.to_words(values).pin_memory().to(dev, non_blocking=True)


def prove_r1cs_stream(
    r1cs: R1CS,
    witness_iter,
    ctx: LweContext,
    seed: int,
    batch: int = 16,
    zk: bool = False,
    blinding_seed: Optional[int] = None,
    store=None,
    device="cuda",
):
    """Prove a stream of witnesses in batches, yielding proofs in witness
    order, with host and device overlapped (double buffering).

    Batch k's device stage is enqueued before batch k-1 is assembled, so the
    card proves batch k while the host hashes transcripts and evaluates
    polynomials for batch k-1; the pull in assembly is the only wait. Each
    batch is keyed on its own, from ``seed ^ (0x9E3779B97F4A7C15 * (k + 1))``
    (63 bits, then the threefry key's 31), and a ZK batch draws its blinding
    factors from ChaCha20 seeded with ``x ^ k``, x = ``blinding_seed`` or,
    when that is None, ``seed``; so a resumed stream regenerates the same
    bytes. ``store`` (a
    ``utils.artifacts.ProofStore``) saves each proof as it is yielded, under
    the label ``stream-<index>``."""
    dev = resolve(device)
    pp = _checked_plan(r1cs, ctx, zk, dev)
    base = blinding_seed if blinding_seed is not None else seed

    def batches():
        buf = []
        for w in witness_iter:
            buf.append(w)
            if len(buf) == batch:
                yield buf
                buf = []
        if buf:
            yield buf

    prev = None  # (witnesses, device outputs, blinding, offset)
    offset = 0
    for batch_idx, ws in enumerate(batches()):
        batch_seed = (seed ^ (0x9E3779B97F4A7C15 * (batch_idx + 1))) & ((1 << 63) - 1)
        out, blinding = _dispatch(r1cs, pp, ws, batch_seed & 0x7FFFFFFF, zk, base ^ batch_idx)
        if prev is not None:
            yield from _emit(r1cs, prev, zk, store, seed)
        prev = (ws, out, blinding, offset)
        offset += len(ws)
    if prev is not None:
        yield from _emit(r1cs, prev, zk, store, seed)


def _emit(r1cs: R1CS, staged, zk: bool, store, seed: int):
    ws, out, blinding, offset = staged
    proofs = assemble_proofs(r1cs, ws, out, zk=zk, blinding=blinding, batch_offset=offset)
    for i, (w, proof) in enumerate(zip(ws, proofs)):
        if store is not None:
            store.save(r1cs, r1cs.public_inputs(w), seed, proof, label=f"stream-{offset + i}")
        yield proof


def assemble_proofs(r1cs: R1CS, witnesses, device_out, zk: bool, blinding,
                    batch_offset: int = 0):
    """Host side: pull the device results, derive transcripts, build proofs.
    ``batch_offset`` makes the indices of an invalid-witness error the
    stream's."""
    q = r1cs.modulus
    q_t, a_t, b_t, c_t, comm_t, valid = device_out
    valid = valid.cpu().numpy()
    if not valid.all():
        bad = [batch_offset + i for i, v in enumerate(valid) if not v]
        raise InvalidWitnessError(f"witnesses {bad} do not satisfy the R1CS")
    q_host, a_host, b_host, c_host, comm_words = (
        modarith.to_u64(t) for t in (q_t, a_t, b_t, c_t, comm_t)
    )
    proofs = []
    for i in range(len(witnesses)):
        commitment = Commitment(comm_words[i])
        ch_a, ch_b = derive_dual(r1cs.public_inputs(witnesses[i]), commitment.words, q)
        alpha, beta = ch_a.alpha, ch_b.alpha
        qc = q_host[i].tolist()
        ac, bc, cc = a_host[i].tolist(), b_host[i].tolist(), c_host[i].tolist()
        q_alpha = field.horner_eval(qc, alpha, q)
        q_beta = field.horner_eval(qc, beta, q)
        common = dict(
            challenge_alpha=ch_a,
            challenge_beta=ch_b,
            a_z_alpha=field.horner_eval(ac, alpha, q),
            b_z_alpha=field.horner_eval(bc, alpha, q),
            c_z_alpha=field.horner_eval(cc, alpha, q),
            a_z_beta=field.horner_eval(ac, beta, q),
            b_z_beta=field.horner_eval(bc, beta, q),
            c_z_beta=field.horner_eval(cc, beta, q),
            modulus=q,
        )
        if zk:
            r = blinding[i]
            qp_alpha = field.add_mod(q_alpha, field.mul_mod(r, r1cs.eval_vanishing(alpha), q), q)
            qp_beta = field.add_mod(q_beta, field.mul_mod(r, r1cs.eval_vanishing(beta), q), q)
            proofs.append(ProofR1csZk(
                commitment_q_prime=commitment,
                blinding_factor=r,
                q_prime_alpha=qp_alpha,
                q_prime_beta=qp_beta,
                opening_alpha=EvalOpening(evaluation=qp_alpha),
                opening_beta=EvalOpening(evaluation=qp_beta),
                **common,
            ))
        else:
            proofs.append(ProofR1CS(
                commitment_q=commitment,
                q_alpha=q_alpha,
                q_beta=q_beta,
                opening_alpha=EvalOpening(evaluation=q_alpha),
                opening_beta=EvalOpening(evaluation=q_beta),
                **common,
            ))
    return proofs
