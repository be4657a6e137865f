"""The batched prove step sharded over a (dp, sp) mesh.

The counterpart of the JAX package's ``parallel/pipeline_sharded.py``
(``ShardedProver`` :82-309). Proof batches shard over ``dp``, polynomial
and ring coefficients over ``sp``. Each rank computes, on its
(B/dp, R/sp, C) blocks of int64 words (JAX's steps 1-6, :177-256):

    inputs  a/b/c evaluations (eval layout)
    1. sharded inverse field NTT        -> A, B, C coefficients
    2. psi twist + sharded forward NTT  -> odd-coset evaluations
    3. pointwise (A B - C) (-2)^-1      -> the quotient's odd evaluations
    4. sharded inverse + psi untwist    -> Q coefficients
    5. validity: the residual's nonzero count, all_reduced over sp
    6. the Goldilocks ring commitment: threefry (s, e), psi_r twist,
       sharded forward NTT, product with the rank's block of A-hat, sum
       over k, sharded inverse, untwist, + e + Q

a, b and c share each transform (one batch of 3 B/dp rows), and the k
streams of s share theirs: five sharded transforms, ten launches of
kernel T's row entry and ten all_to_alls a step. Kernels Q and R, which
take a whole row in one launch, do not run here: the all_to_alls fall
between their stages.

The randomness is drawn by GLOBAL statement and coefficient index: the
draw for (stream, statement b, position t) is ``ops.sampler``'s
counter-mode threefry at b = dp_rank B/dp + local row and t = the natural
coefficient index of the rank's rows, so the commitment words do not
depend on the mesh and equal the unsharded ``pipeline.prove_stage_batch``
(kernels Q and R) for the same key. The quotient length m must equal the
ring degree n, as in JAX.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..commit.lwe import LweContext
from ..core import field
from ..core.errors import DomainError
from ..core.params import NTT_MODULUS, NTT_PRIMITIVE_ROOT
from ..ops import modarith
from ..ops.ntt_large import power_table
from ..ops.ring_commit import embed_signed
from ..ops.sampler import prng_key, sample_signed
from ..pipeline import field_psi_for
from .mesh import mesh_device, shard_rows
from .ntt_sharded import LocalFourStep

P = modarith.GOLDILOCKS


class ShardedProver:
    """The batched prove step bound to a (dp, sp) mesh, on this rank's blocks."""

    def __init__(self, m: int, q: int, host_ctx: LweContext, mesh, dp_axis: str = "dp",
                 sp_axis: str = "sp") -> None:
        if m != host_ctx.n:
            raise DomainError(f"the sharded path needs m == ring degree (m={m}, n={host_ctx.n})")
        self.m, self.q, self.host_ctx, self.mesh = m, q, host_ctx, mesh
        self.dp, self.sp = dp_axis, sp_axis
        names = list(mesh.mesh_dim_names)
        self.n_dp, self.n_sp = (mesh.size(names.index(a)) for a in (dp_axis, sp_axis))
        self.dp_index, self.sp_index = (mesh.get_local_rank(a) for a in (dp_axis, sp_axis))
        # world rank of each (dp, sp) coordinate, for the gather of ``run``
        self.grid = mesh.mesh.permute(names.index(dp_axis), names.index(sp_axis))
        self.sp_group = mesh.get_group(sp_axis)
        self.device = dev = mesh_device(mesh)

        # field domain: cyclic four-step of root omega = psi^2, psi twists
        psi = field_psi_for(m, q)
        self.field = LocalFourStep(m, q, field.mul_mod(psi, psi, q), self.sp_group, self.n_sp,
                                   self.sp_index, dev)
        self.r, self.c = self.field.r, self.field.c
        self.rows = self.r // self.n_sp
        self.psi_f = self._row_block(power_table(psi, m, q, dev))
        self.psi_f_inv = self._row_block(power_table(field.mod_inverse(psi, q), m, q, dev))

        # ring domain (Goldilocks, degree n = m): the same (R, C) split
        n, k = host_ctx.n, host_ctx.k
        omega_r = field.mod_pow(NTT_PRIMITIVE_ROOT, (1 << 32) // n, NTT_MODULUS)
        psi_r = field.mod_pow(NTT_PRIMITIVE_ROOT, (1 << 32) // (2 * n), NTT_MODULUS)
        self.ring = LocalFourStep(n, P, omega_r, self.sp_group, self.n_sp, self.sp_index, dev)
        self.psi_r = self._row_block(power_table(psi_r, n, P, dev))
        self.psi_r_inv = self._row_block(power_table(field.mod_inverse(psi_r, P), n, P, dev))
        # A-hat in eval layout: F[h, g] = A_hat[h + R g]
        a_hat = modarith.to_words(host_ctx.a_hat, dev).reshape(k, self.c, self.r).transpose(1, 2)
        self.a_hat = shard_rows(a_hat, mesh, sp_axis, 1).contiguous()
        self.k = k
        self.cdf = modarith.to_words(host_ctx.cdf, dev)
        self.neg_half_inv = field.mod_inverse(q - 2, q)

    def _row_block(self, table: torch.Tensor) -> torch.Tensor:
        """This rank's rows of an (m,) table laid out (R, C)."""
        return shard_rows(table.reshape(self.r, self.c), self.mesh, self.sp, 0).contiguous()

    # -- the per-rank step ------------------------------------------------------------

    def step(self, a_e: torch.Tensor, b_e: torch.Tensor, c_e: torch.Tensor, key):
        """This rank's (B/dp, R/sp, C) eval-layout blocks and a threefry key
        -> its blocks of (Q, A, B, C, commitment) (int64 words), s
        (k, B/dp, R/sp, C) and e (B/dp, R/sp, C) (int32 draws), valid (B/dp,)."""
        q, k = self.q, self.k
        bl = a_e.shape[0]
        # 1-2. interpolate, then the odd coset
        polys = self.field.inverse(torch.cat([a_e, b_e, c_e]))
        odd = self.field.forward(modarith.mul_mod(polys, self.psi_f, q))
        a_odd, b_odd, c_odd = odd.split(bl)
        # 3-4. the quotient's odd evaluations, back to coefficients
        n_odd = modarith.sub_mod(modarith.mul_mod(a_odd, b_odd, q), c_odd, q)
        q_odd = modarith.mul_mod(n_odd, self.neg_half_inv, q)
        q_coeffs = modarith.mul_mod(self.field.inverse(q_odd), self.psi_f_inv, q)
        # 5. validity over the even coset, summed over sp
        residual = modarith.sub_mod(modarith.mul_mod(a_e, b_e, q), c_e, q)
        nonzero = (residual != 0).sum(dim=(1, 2))
        dist.all_reduce(nonzero, group=self.sp_group)
        valid = nonzero == 0
        # 6. the commitment, randomness by global statement and coefficient
        dev = a_e.device
        length = self.rows * self.c
        b_idx = self.dp_index * bl + torch.arange(bl, dtype=torch.int64, device=dev)
        pos = self.sp_index * length + torch.arange(length, dtype=torch.int64, device=dev)
        signed = sample_signed(key, range(k + 1), b_idx, pos, self.cdf)
        signed = signed.reshape(k + 1, bl, self.rows, self.c)
        s_tw = modarith.mul_mod(embed_signed(signed[:k]).reshape(k * bl, self.rows, self.c),
                                self.psi_r, P)
        s_hat = self.ring.forward(s_tw).reshape(k, bl, self.rows, self.c)
        acc = modarith.mul_mod(s_hat[0], self.a_hat[0], P)
        for j in range(1, k):
            acc = modarith.add_mod(acc, modarith.mul_mod(s_hat[j], self.a_hat[j], P), P)
        c_ring = modarith.mul_mod(self.ring.inverse(acc), self.psi_r_inv, P)
        c_ring = modarith.add_mod(c_ring, embed_signed(signed[k]), P)
        c_ring = modarith.add_mod(c_ring, q_coeffs, P)
        a_poly, b_poly, c_poly = polys.split(bl)
        return q_coeffs, a_poly, b_poly, c_poly, c_ring, signed[:k], signed[k], valid

    # -- host-facing API ---------------------------------------------------------------

    def natural_to_eval_layout(self, evals: torch.Tensor) -> torch.Tensor:
        """(B, m) natural-order evaluations -> (B, R, C) eval layout."""
        return evals.reshape(evals.shape[0], self.c, self.r).transpose(1, 2)

    def coeff_layout_to_flat(self, x: torch.Tensor) -> torch.Tensor:
        """(..., B, R, C) coefficient layout -> (..., B, m) coefficients."""
        return x.reshape(x.shape[:-2] + (self.m,))

    def shard(self, evals) -> torch.Tensor:
        """(B, m) natural-order evaluations (words or a uint64 array) -> this
        rank's (B/dp, R/sp, C) eval-layout block on the mesh's device."""
        x = evals.to(self.device) if isinstance(evals, torch.Tensor) else \
            modarith.to_words(evals, self.device)
        lay = shard_rows(self.natural_to_eval_layout(x), self.mesh, self.dp, 0)
        return shard_rows(lay, self.mesh, self.sp, 1).contiguous()

    def gather(self, x: torch.Tensor, dst=None):
        """Every rank's (..., B/dp, R/sp, C) block, over the world:
        (..., B, R, C) on every rank, or with ``dst`` on that rank alone
        (None on the others)."""
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        if dst is None:
            dist.all_gather(parts, x.contiguous())
        else:
            lead = dist.get_rank() == dst
            dist.gather(x.contiguous(), parts if lead else None, dst=dst)
            if not lead:
                return None
        rows = [torch.cat([parts[int(r)] for r in ranks], dim=-2) for ranks in self.grid]
        return torch.cat(rows, dim=-3)

    def run(self, a_evals, b_evals, c_evals, seed: int, dst=None):
        """(B, m) natural-order evaluations on every rank -> (Q, A, B, C,
        commitment (B, R, C) words in coefficient layout, s (k, B, R, C)
        and e (B, R, C) int32, valid (B,)) for the whole batch, on every
        rank; the key is ``prng_key(seed & 0x7FFFFFFF)``. With ``dst``, the
        five word planes go to that rank alone (None on the others), s and
        e are not gathered (None), and valid still reaches every rank."""
        out = self.step(self.shard(a_evals), self.shard(b_evals), self.shard(c_evals),
                        prng_key(seed & 0x7FFFFFFF))
        words = self.gather(torch.stack(out[:5]), dst)
        words = [None] * 5 if words is None else words.unbind(0)
        s = e = None
        if dst is None:
            draws = self.gather(torch.cat([out[5], out[6][None]]))
            s, e = draws[:self.k], draws[self.k]
        valid = self.gather(out[7].to(torch.int64)[:, None, None])[:, 0, 0] == 1
        return (*words, s, e, valid)
