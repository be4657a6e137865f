"""The device route of kind-9 proving (Goldilocks circuits on the roots domain).

The route ``succinct_witness.prove_r1cs_witness`` takes for a circuit of
``_gl_frontend_applicable``, one proof per call, on the card (kernels Q,
R, T and K) unless ``device="cpu"`` (their plain twins):

    host    the witness as words; ZK: rho_A, rho_B, rho_C, rho_z and mu
            from ChaCha20                   (succinct_witness._draw_masks)
    device  SpMV; kernel T: z^ = the inverse transform of z at M; ZK:
            z~ = z^ + Z_Hs rho_z
    device  the kind-7 front end with z~ (and mu) as extra rows: kernel Q,
            the ZK masks, one LDE launch of the pre group (5 or 6 rows),
            one group forest on kernel K, kernel R
                                  (succinct_device.quotient_lde_dispatch)
    host    alpha, beta; A~, B~, C~, Q~ at both (eval_device); r, eta, tau
    host    u = eta . r^T [A; B; C], O(nnz)   (succinct_witness._row_weights)
    device  kernel T: R_s and U_s, one inverse launch of two rows at M;
            F = R_s (eta . [A~, B~, C~]) - U_s z~ (+ tau mu), one
            ``_sum_of_products`` (kernel T); F folded by Z_Hs into h, p
    device  h, p: one LDE launch, one G = 2 forest on kernel K
    host    gamma; A~, B~, C~, z~, h, p (, mu) at gamma (eval_at); lambda
    device  the DEEP quotient over the seven or eight codewords
            (fri_device.deep_combine_terms_device), FRI on kernels K and T
            with the host transcript, and both groups' openings in one pull
                                            (fri_commit_layers, fri_open)

The codewords are never pulled whole. Proof bytes equal the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..commit.lwe import LweContext
from ..core.errors import DomainError, InvalidDimensionsError, InvalidWitnessError
from ..ops import modarith
from ..ops.ntt_batched import ntt_inverse_batched
from ..ops.ntt_large import ntt_forward_large
from ..r1cs.r1cs import R1CS
from ..transcript.challenge import derive_dual
from ..utils.chacha import ChaCha20Rng
from . import fri_device
from .fri import FriParams, coset_offset
from .succinct import _roots_to_words, statement_binding_words
from .succinct_batch import _embed
from .succinct_device import (
    _conv_plan,
    _pad,
    _sum_of_products,
    _zh_mul,
    eval_at,
    eval_device,
    finish_quotient_lde,
    frontend_plan,
    quotient_lde_dispatch,
)
from .succinct_witness import (
    WitnessProofR1CS,
    _deep_terms,
    _draw_masks,
    _fold_words,
    _lambda_weights,
    _lincheck_challenges,
    _row_weights,
    _seed_witness_transcript,
)

P = modarith.GOLDILOCKS


def _scale(x: torch.Tensor, s: int) -> torch.Tensor:
    return modarith.mul_mod(x, s % P, P)


def prove_witness_device(r1cs: R1CS, witness, ctx: LweContext, seed: int, params: FriParams,
                         mask_len: int, geometry: Tuple[int, int, int, int, int],
                         rng: Optional[ChaCha20Rng], device: torch.device) -> WitnessProofR1CS:
    """One kind-9 proof of a Goldilocks roots-domain circuit on ``device``;
    ``geometry`` is ``_witness_geometry``'s, ``rng`` the ZK masks'
    generator (None: plain)."""
    q, m, l = r1cs.modulus, r1cs.m, r1cs.l
    big_m, omega_s, d_bound, n0, omega_n = geometry
    zk = mask_len > 0
    offset = coset_offset(q)
    if len(witness) != r1cs.n:
        raise InvalidDimensionsError(f"witness length {len(witness)} must equal n={r1cs.n}")
    z = _embed(r1cs, [witness])  # (1, n) canonical
    w = modarith.to_words(z, device)
    plan_m = _conv_plan(big_m, device)
    z_t = ntt_inverse_batched(plan_m, _pad(w, big_m))  # (1, M)
    masks, extra = None, [z_t]
    if zk:
        (rho_a, rho_b, rho_c, rho_z), mu = _draw_masks(rng, mask_len, big_m, q)
        masks = np.array([[rho_a], [rho_b], [rho_c]], dtype=np.uint64)
        z_t = modarith.add_mod(_pad(z_t, big_m + mask_len),
                               _zh_mul(modarith.to_words([rho_z], device), big_m), P)
        extra = [z_t, modarith.to_words([mu], device)]

    # the pre group A~, B~, C~, Q~, z~ (, mu): one LDE, one forest, kernel R
    d = quotient_lde_dispatch(*r1cs.constraint_evals_batch(w), n0, offset, ctx, [seed], masks,
                              extra)
    try:
        commitments, pre_forest = finish_quotient_lde(d)
    except InvalidWitnessError:
        raise InvalidWitnessError("witness does not satisfy R1CS constraints") from None
    pre_root = pre_forest.roots[0]
    publics = [int(v) for v in z[0, :l]]
    comm_words = np.concatenate([statement_binding_words(commitments[0], r1cs),
                                 np.array(_roots_to_words([pre_root]), dtype=np.uint64)])
    ch_alpha, ch_beta = derive_dual(publics, comm_words, q)
    alpha, beta = ch_alpha.alpha, ch_beta.alpha
    evals_ab = [int(v) for v in eval_device(d.polys, np.array([alpha], dtype=np.uint64),
                                            np.array([beta], dtype=np.uint64))[0]]
    tr = _seed_witness_transcript(q, m, r1cs.n, big_m, mask_len, params, d_bound, [pre_root],
                                  alpha, beta, evals_ab)
    r, etas, tau = _lincheck_challenges(tr, q)

    # the sumcheck: F = R_s (eta . [A~, B~, C~]) - U_s z~ (+ tau mu) = Z_Hs h + X p
    u, r_pows = _row_weights(r1cs, r, etas)
    rows = np.zeros((2, big_m), dtype=np.uint64)
    rows[0, :: big_m // m] = r_pows
    rows[1, : len(u)] = u
    r_s, u_s = ntt_inverse_batched(plan_m, modarith.to_words(rows, device))
    abc = d.polys[0, :3, : m + mask_len]  # A~, B~, C~ at their true width
    combo = modarith.add_mod(modarith.add_mod(_scale(abc[0], etas[0]), _scale(abc[1], etas[1]),
                                              P), _scale(abc[2], etas[2]), P)
    f = _sum_of_products([r_s[None], modarith.sub_mod(torch.zeros_like(u_s), u_s, P)[None]],
                         [combo[None], z_t], big_m + z_t.shape[1] - 1)[0]
    if zk:
        f = modarith.add_mod(f, _scale(extra[1][0], tau), P)
    h, g = _fold_words(f, big_m)
    plan = frontend_plan(m, n0, offset, device)
    sum_lde = ntt_forward_large(plan.lde, torch.stack([_pad(h, n0), _pad(g[1:], n0)]),
                                pre=plan.twist)[None]  # (1, 2, n0): h, p
    levels = fri_device.group_forest_levels(sum_lde)
    pack = modarith.to_u64(torch.cat([g[:1], levels[-1][0, 0]]))
    if pack[0]:
        raise DomainError("sumcheck remainder nonzero (witness bug)")
    sum_forest = fri_device.forest_from_levels(levels, root_words=pack[1:].reshape(1, 4))
    tr.absorb(b"sum-root", sum_forest.roots[0])
    gamma = tr.challenge_field(q, b"sumcheck-gamma")
    if pow(gamma, big_m, q) == 1:  # pragma: no cover - a 2^-64 event
        raise DomainError("sumcheck challenge fell on the domain")
    g_rows = [abc[0], abc[1], abc[2], z_t[0], h, g[1:]] + ([extra[1][0]] if zk else [])
    width = max(x.shape[0] for x in g_rows)
    evals_gamma = [int(v) for v in eval_at(
        torch.stack([_pad(x, width) for x in g_rows])[None],
        np.array([[gamma]], dtype=np.uint64))[0, 0]]
    tr.absorb_words(b"gamma-evals", evals_gamma)
    lam = tr.challenge_field(q, b"fri-lambda")

    # DEEP over the pre and sum groups' codewords, then FRI
    terms = _deep_terms(zk, alpha, beta, gamma, evals_ab, evals_gamma,
                        [pow(omega_s, j, q) for j in range(l)], publics)
    weights = _lambda_weights(len(terms), lam, q)
    points = list(dict.fromkeys(pt for _k, pt, _v in terms))
    cw = torch.cat([d.lde[0], sum_lde[0]])
    g_deep = fri_device.deep_combine_terms_device(
        cw, np.array(points, dtype=np.uint64), [k for k, _pt, _v in terms],
        [points.index(pt) for _k, pt, _v in terms], np.array(weights[:-1], dtype=np.uint64),
        np.array([v for _k, _pt, v in terms], dtype=np.uint64), offset, omega_n,
        cw.shape[0] - 1, d_bound - (big_m - 1), weights[-1])
    committed, finals, idx = fri_device.fri_commit_layers(g_deep[None], offset, omega_n, q,
                                                          params, [tr])
    fri_proof = fri_device.fri_open([(d.lde, pre_forest), (sum_lde, sum_forest)], committed,
                                    finals, idx)[0]
    return WitnessProofR1CS(
        commitment_q=commitments[0], pre_root=pre_root, sum_root=sum_forest.roots[0],
        challenge_alpha=ch_alpha, challenge_beta=ch_beta, evals_ab=tuple(evals_ab),
        evals_gamma=tuple(evals_gamma), fri=fri_proof, m=m, n_vars=r1cs.n, mask_len=mask_len,
        log_blowup=params.log_blowup, num_queries=params.num_queries,
        final_len=params.final_len, modulus=q)
