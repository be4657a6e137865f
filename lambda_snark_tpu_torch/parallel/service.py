"""A sharded proof service: a witness stream proven over a (dp, sp) mesh,
with a ``ProofStore`` resume log.

The counterpart of the JAX package's ``parallel/service.py``
(``ShardedProofService`` :36-154): statements stream in, proof batches
shard over dp while each proof's coefficients shard over sp
(``pipeline_sharded.ShardedProver``), and every finished proof is saved at
once under the label ``svc-<index>``. Restarting with the same store
resumes: stored statements are served from the store, bytes unchanged,
and only the rest is proven (a batch's seed folds the master seed with its
leading statement index, so a rerun of the same partition is
deterministic).

Every rank of the mesh builds the service and runs ``prove_stream`` on
the same witnesses and seed. Rank 0's store decides: at construction
rank 0 tells every rank whether it has one (the other ranks may pass
``None``), and only rank 0 reads and writes it. Rank 0 gathers each
batch's words, assembles the proofs and yields them; with a store it
tells the other ranks which statements the store holds (one broadcast a
statement). The other ranks take part in the collectives of every batch
and yield nothing.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from ..commit.lwe import LweContext
from ..core.errors import DomainError, InvalidWitnessError
from ..ops import modarith
from ..prover_batched import assemble_proofs, witness_words
from ..r1cs.r1cs import R1CS
from ..utils.artifacts import ProofStore, statement_digest
from .pipeline_sharded import ShardedProver


class ShardedProofService:
    """Prove a stream of witnesses against one R1CS over a device mesh."""

    def __init__(self, r1cs: R1CS, host_ctx: LweContext, mesh,
                 store: Optional[ProofStore] = None, batch: Optional[int] = None,
                 dp_axis: str = "dp", sp_axis: str = "sp",
                 prover: Optional[ShardedProver] = None) -> None:
        if r1cs.domain.kind != "roots":
            raise DomainError("sharded proving requires a roots (NTT) domain")
        self.r1cs = r1cs
        self.store = store
        dp = mesh.size(list(mesh.mesh_dim_names).index(dp_axis))
        self.batch = batch if batch is not None else max(2 * dp, dp)
        if self.batch % dp != 0:
            raise DomainError(f"batch {self.batch} must divide over dp={dp}")
        if prover is not None:
            # reuse a prover's plans and tables (they are per instance)
            if (prover.m != r1cs.m or prover.q != r1cs.modulus or prover.mesh is not mesh
                    or prover.host_ctx is not host_ctx or prover.dp != dp_axis
                    or prover.sp != sp_axis):
                raise DomainError("supplied prover does not match this service's "
                                  "circuit/mesh/commitment context/axes")
            self.prover = prover
        else:
            self.prover = ShardedProver(r1cs.m, r1cs.modulus, host_ctx, mesh,
                                        dp_axis=dp_axis, sp_axis=sp_axis)
        self.rank = dist.get_rank()
        # rank 0's store decides for every rank, so all of them enter the
        # same per-statement broadcasts
        flag = torch.tensor([int(store is not None)], dtype=torch.int64,
                            device=self.prover.device)
        dist.broadcast(flag, src=0)
        self.resume = bool(flag.item())

    def _label(self, index: int) -> str:
        return f"svc-{index}"

    def _key(self, witness: Sequence[int], index: int, seed: int) -> str:
        return statement_digest(self.r1cs, self.r1cs.public_inputs(witness), seed,
                                self._label(index))

    def _stored(self, witness: Sequence[int], index: int, seed: int) -> bool:
        """Whether the store holds statement ``index``: rank 0 looks, and
        every rank learns its answer."""
        flag = torch.zeros(1, dtype=torch.int64, device=self.prover.device)
        if self.rank == 0:
            flag += int(self.store.contains(self._key(witness, index, seed)))
        dist.broadcast(flag, src=0)
        return bool(flag.item())

    def prove_stream(self, witnesses: Iterable[Sequence[int]], seed: int):
        """Yield (index, proof) in order on rank 0 (nothing on the other
        ranks); stored proofs are loaded, new ones proven in dp-sharded
        batches and saved."""
        r1cs = self.r1cs
        prover = self.prover
        pending: list = []  # (index, witness)

        def flush():
            if not pending:
                return
            ws = [w for _i, w in pending]
            # pad the tail batch to a multiple of dp by repeating the last
            # witness (the padding's proofs are dropped)
            padded = ws + [ws[-1]] * ((-len(ws)) % prover.n_dp)
            w = modarith.to_words(witness_words(padded, r1cs.n, r1cs.modulus), prover.device)
            a_e, b_e, c_e = r1cs.constraint_evals_batch(w)
            first = pending[0][0]
            batch_seed = (seed ^ (0x9E3779B97F4A7C15 * (first + 1))) & ((1 << 63) - 1)
            q_pl, a_pl, b_pl, c_pl, c_ring, _s, _e, valid = prover.run(a_e, b_e, c_e, batch_seed,
                                                                      dst=0)
            if not bool(valid.all()):  # every rank raises, so none waits on another
                bad = [first + i for i, v in enumerate(valid.tolist()[:len(ws)]) if not v]
                raise InvalidWitnessError(f"witnesses {bad} do not satisfy the R1CS")
            if self.rank == 0:
                words = (prover.coeff_layout_to_flat(t) for t in (q_pl, a_pl, b_pl, c_pl, c_ring))
                proofs = assemble_proofs(r1cs, padded, (*words, valid), zk=False, blinding=None,
                                         batch_offset=first)
                for (index, w_i), proof in zip(pending, proofs):
                    if self.store is not None:
                        self.store.save(r1cs, r1cs.public_inputs(w_i), seed, proof,
                                        label=self._label(index))
                    yield index, proof
            pending.clear()

        for index, w in enumerate(witnesses):
            if self.resume and self._stored(w, index, seed):
                # resume: flush what precedes, then serve the stored proof
                yield from flush()
                if self.rank == 0:
                    yield index, self.store.load(self._key(w, index, seed))
                continue
            pending.append((index, w))
            if len(pending) == self.batch:
                yield from flush()
        yield from flush()

