#!/usr/bin/env python3
"""Time the orders of the chunked kind-7 prover against one batch, on one GPU.

    python3 scripts/torch_pipeline_ab.py [--sizes 64,128] [--chunk 32] [--reps 5]

At chip_smoke's kind-7 instance (m = 2^13 squaring gates over Goldilocks,
ring n = 8192, k = 1, default ``FriParams``) and each batch size S, three
routes through ``lambda_snark_tpu_torch.proof.succinct_batch`` give the
same proof bytes (checked):

- ``unchunked``: ``prove_r1cs_succinct_batch`` on the whole batch;
- ``chunked``: the same with ``pipeline_chunk=CHUNK``, the library's
  order: each chunk proved and assembled before the next one's front end
  is enqueued;
- ``chunked_deferred``: the same chunks with chunk i's query openings
  pulled into pinned memory under an event and assembled on the host after
  chunk i+1's front end is enqueued, so the device runs that front end
  meanwhile (composed here from the library's steps; the assembly is
  ``fri_device.fri_open``'s).

Runs alternate (U, C, D, D, C, U, ...) so drift of the host clock falls on
every route, and each pass gives two adjacent (C, D) pairs. Prints the card's name and power limit, then one JSON line
with every time (host clock after ``torch.cuda.synchronize()``), the
medians, and each route's device idle share of one profiled batch
(``chip_smoke.device_busy``). Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="64,128", help="batch sizes S, comma-separated")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5,
                    help="at least this many timed batches per route and size")
    args = ap.parse_args()
    sys.path.insert(0, REPO)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_pipeline_ab: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    import lambda_snark_tpu_torch as lst
    from lambda_snark_tpu_torch.proof import fri_device
    from lambda_snark_tpu_torch.proof import succinct_batch as sb
    from lambda_snark_tpu_torch.proof.fri import (
        FriParams,
        FriProof,
        FriQuery,
        GroupOpening,
        LayerOpening,
    )
    from lambda_snark_tpu_torch.proof.succinct import SuccinctProofR1CS
    from lambda_snark_tpu_torch.proof.succinct_device import (
        eval_device,
        finish_quotient_lde,
        quotient_lde_dispatch,
    )

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(20240617)
    m, chunk = chip_smoke.KIND7_M, args.chunk
    sizes = [int(v) for v in args.sizes.split(",")]
    ctx, r1cs = chip_smoke.kind7_context(lst, m), chip_smoke.kind7_circuit(lst, m)
    wits = chip_smoke.kind7_witnesses(np, lst, dev, rng, max(sizes), m)
    seeds = list(range(500, 500 + max(sizes)))
    geo = sb._Geometry(r1cs, FriParams(), 0)

    def open_deferred(input_vals, input_forest, committed, finals, idx):
        """``fri_device.fri_open`` with its pull started into pinned memory;
        returns a function that waits for it and assembles the FriProofs."""
        s, k_in, n0 = input_vals.shape
        nq = idx.shape[1]
        idx_k = idx[:, None, :].expand(-1, k_in, -1)
        parts = [input_vals.gather(2, idx_k), input_vals.gather(2, idx_k + n0 // 2)]
        parts += fri_device._take_siblings(input_forest, idx)
        depths = [len(input_forest.levels) - 1]
        pos = idx
        for values, forest in committed:
            half = forest.num_leaves
            pos = pos % half
            parts += [values.gather(1, pos), values.gather(1, pos + half)]
            parts += fri_device._take_siblings(forest, pos)
            depths.append(len(forest.levels) - 1)
        flat = torch.cat([p.reshape(-1) for p in parts])
        host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        host.copy_(flat, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        shapes = [tuple(p.shape) for p in parts]

        def assemble():
            event.synchronize()
            words, arrays, off = host.numpy().view(np.uint64), [], 0
            for shape in shapes:
                size = int(np.prod(shape))
                arrays.append(words[off: off + size].reshape(shape))
                off += size
            pulled = iter(arrays)

            def path_bytes(depth):
                levels = [next(pulled) for _ in range(depth)]
                return np.stack(levels, axis=2).view(np.uint8).reshape(s, nq, 32 * depth)

            in_lo, in_hi = next(pulled), next(pulled)
            in_path = path_bytes(depths[0])
            layers = [(next(pulled), next(pulled), path_bytes(depth)) for depth in depths[1:]]
            proofs = []
            for si in range(s):
                queries = []
                for qi in range(nq):
                    vals = tuple(int(v) for k in range(k_in)
                                 for v in (in_lo[si, k, qi], in_hi[si, k, qi]))
                    layer_ops = tuple(LayerOpening(int(lo[si, qi]), int(hi[si, qi]),
                                                   path[si, qi].tobytes())
                                      for lo, hi, path in layers)
                    queries.append(FriQuery((GroupOpening(vals, in_path[si, qi].tobytes()),),
                                            layer_ops))
                roots = tuple(forest.roots[si] for _v, forest in committed)
                proofs.append(FriProof(roots, tuple(finals[si]), tuple(queries)))
            return proofs

        return assemble

    def back_end_deferred(ws, d, first):
        """``succinct_batch._back_end`` with ``open_deferred`` for its query
        phase; returns a function that assembles the chunk's proofs."""
        q, params = geo.q, geo.params
        commitments, forest = finish_quotient_lde(d, first)
        chals, alphas, betas = sb._derive_batch_challenges(r1cs, ws, commitments,
                                                           forest.roots, q)
        evals = eval_device(d.polys, alphas, betas)
        trs, lams = sb._seed_batch_transcripts(q, geo.m, geo.mask_len, params, geo.d_bound,
                                               forest.roots, alphas, betas, evals)
        g = fri_device.deep_combine_device(d.lde, alphas, betas, lams, evals, geo.offset,
                                           geo.omega_n)
        committed, finals, idx = fri_device.fri_commit_layers(g, geo.offset, geo.omega_n, q,
                                                              params, trs)
        fri_later = open_deferred(d.lde, forest, committed, finals, idx)

        def assemble():
            fri = fri_later()
            return [SuccinctProofR1CS(
                commitments[i], forest.roots[i], *chals[i], *(int(v) for v in evals[i]),
                fri=fri[i], m=geo.m, mask_len=geo.mask_len, log_blowup=params.log_blowup,
                num_queries=params.num_queries, final_len=params.final_len, modulus=q)
                for i in range(len(ws))]

        return assemble

    def deferred(s: int):
        proofs, assemble = [], None
        for start in range(0, s, chunk):
            sl = slice(start, min(start + chunk, s))
            d = quotient_lde_dispatch(*sb._embed_and_eval(r1cs, wits[sl], dev), geo.n0,
                                      geo.offset, ctx, seeds[sl])
            if assemble is not None:
                proofs += assemble()
            assemble = back_end_deferred(wits[sl], d, start)
        return proofs + assemble()

    trace = os.path.join(REPO, "build", "pipeline_ab_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    order = ("unchunked", "chunked", "chunked_deferred",
             "chunked_deferred", "chunked", "unchunked")
    out = {}
    for s in sizes:
        runs = {
            "unchunked": lambda s=s: lst.prove_r1cs_succinct_batch(r1cs, wits[:s], ctx,
                                                                   seeds[:s]),
            "chunked": lambda s=s: lst.prove_r1cs_succinct_batch(
                r1cs, wits[:s], ctx, seeds[:s], pipeline_chunk=chunk),
            "chunked_deferred": lambda s=s: deferred(s),
        }
        want = [p.to_bytes() for p in runs["unchunked"]()]  # warm-up and reference
        for route in ("chunked", "chunked_deferred"):
            if [p.to_bytes() for p in runs[route]()] != want:
                raise RuntimeError(f"S={s} {route}: bytes differ from the unchunked prover's")
        times = {route: [] for route in runs}
        while min(len(v) for v in times.values()) < args.reps:
            for route in order:
                torch.cuda.synchronize()
                t = time.time()
                runs[route]()
                torch.cuda.synchronize()
                times[route].append(time.time() - t)
        median = {r: sorted(v)[len(v) // 2] for r, v in times.items()}
        c, dfr = times["chunked"], times["chunked_deferred"]
        deferred_wins = sum(b < a for a, b in zip(c, dfr))
        idle = {}
        for route, fn in runs.items():
            wall, busy, _top = chip_smoke.device_busy(torch, fn, trace)
            idle[route] = None if busy is None else 1.0 - busy / wall
        out[s] = dict(chunk=chunk, times_s=times, median_s=median,
                      deferred_wins_of_pairs=[deferred_wins, len(c)],
                      proofs_per_s={r: s / v for r, v in median.items()},
                      device_idle_share=idle)
        print(f"S={s} chunk={chunk}: medians " + ", ".join(
            f"{r} {v:.4f} s" for r, v in median.items())
            + f"; deferred faster in {deferred_wins} of {len(c)} adjacent pairs"
            + f"; idle shares {idle}", flush=True)
    print(json.dumps({"pipeline_ab": out, "m": m}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
