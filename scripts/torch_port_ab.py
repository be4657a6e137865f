#!/usr/bin/env python3
"""Time one checkout of the PyTorch / CUDA port on one GPU, for A/B runs.

    python3 scripts/torch_port_ab.py --root DIR --label NAME [--out FILE]

imports ``lambda_snark_tpu_torch`` from the checkout at DIR (built there
with ``nvcc`` at first use) and prints one JSON line with:

- ``ntt``: kernel T (entries ``ntt_rows`` and ``ntt_four_step``, through
  ``ntt_forward_batched`` / ``ntt_inverse_batched``) at the shapes of the
  port's paths, ms per call, mean of 20 after a warm-up (CUDA events);
- ``q_and_r``: kernels Q and R through ``quotient`` / ``ring_commit`` at
  the port's path shapes (kinds 2/3: 256 x 4096 and 256 x 2048 over the
  44-bit field, the ring at n = 4096, k = 2 with both message lengths;
  kind 7: 16 rows of 2^13 and 2^14 Goldilocks words, and 16 x 2^16),
  whatever route the checkout takes, ms per call as above;
- ``clusters``: where the checkout spreads rows over thread-block clusters
  (``kernels.cluster_size``), the same shapes with the cluster forced to
  each size the kernels take, ms per call;
- ``long_routes``: ``quotient_long`` and ``ring_commit_long`` (kernel T's
  four-step around the elementwise entries) at m = n = 2^14, 16 rows;
- ``forests``: each Merkle forest shape of the kind-7 paths at m = 2^13 and
  2^14 through ``fri_device.commit_planes_dev`` / ``commit_planes_dev_groups``
  (whatever route the checkout takes), ms per call as above, and the host
  time from codewords to roots on the host, median of 20;
- ``kind7``: ``prove_r1cs_succinct_batch`` at m = 2^13 and 2^14, S = 16, the
  median of five batches (host clock) and the device idle share of one
  batch under ``torch.profiler``;
- ``sponge_fold``: kernels S and F by device time (CUDA events around a
  CUDA graph of 20 captured calls, ms per call): the 30 query squeezes
  (``transcript_squeeze``) at S = 1, 16, 128; a chain layer at the chain
  shapes, without and with a root to absorb (the checkout's chain calls: a
  squeeze, the fold and a root absorb, or ``fold_squeeze``); the fold with
  given challenges (``fold``); the chain's tail (the ``fri-final`` absorb
  and the 30 query squeezes, or ``transcript_final_queries``) at S = 1, 16,
  32, 128; and the host time to enqueue ``fri_chain_dispatch`` at k7a
  (median of five);
- ``sponge_candidates`` (from this repository, whatever ``--root``): the
  forms of the permutation in ``scripts/sponge_candidates.cu`` (one thread
  unrolled, the warp form kept in ``csrc/keccak_f.cuh``, a warp form with
  theta in one shuffle level) at the 30 query squeezes, S = 1, 16, 128,
  each held against the twin, with each kernel's SASS instruction count.

``--sections`` picks sections (default: all).

Inputs are made from a fixed seed, so two checkouts see the same words.
Run checkouts in turns in one process tree on one card (A, B, B, A): host
and device times move between machines. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

SHAPES_T = (  # (modulus name, rows, points)
    ("q45", 256, 1 << 13), ("q45", 64, 256), ("goldilocks", 256, 1 << 13),
    ("goldilocks", 64, 256), ("barrett", 16, 1 << 13), ("goldilocks", 16, 512),
    ("goldilocks", 32768, 128),
    ("goldilocks", 16, 1 << 14), ("goldilocks", 48, 1 << 14), ("barrett", 16, 1 << 14),
    ("goldilocks", 64, 1 << 16), ("goldilocks", 16, 1 << 17), ("goldilocks", 64, 1 << 17),
    ("goldilocks", 1, 1 << 20), ("goldilocks", 1, 1 << 21),
)
Q_SHAPES = (  # (modulus name, rows, m)
    ("q45", 256, 4096), ("q45", 256, 2048), ("goldilocks", 16, 1 << 13),
    ("goldilocks", 16, 1 << 14), ("goldilocks", 16, 1 << 16),
)
R_SHAPES = (  # (rows, n, k, message words)
    (256, 4096, 2, 4096), (256, 4096, 2, 2049), (16, 1 << 13, 1, 1 << 13),
    (16, 1 << 14, 1, 1 << 14), (16, 1 << 16, 1, 1 << 16),
)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORESTS = [(16, 4, 1 << 16), (16, 4, 1 << 17)] + [(16, 1, 1 << k) for k in range(10, 17)]
KIND7_SIZES, KIND7_S, KIND7_REPS = (1 << 13, 1 << 14), 16, 5
SECTIONS = ("ntt", "q_and_r", "long_routes", "forests", "kind7", "sponge_fold",
            "sponge_candidates")
# chain layers (rows, n): k7a's largest, middle and last, k7b's and agg13z's
# first, agg13's, agg10's, a pipelined chunk's, kind 9's first
FOLD_SHAPES = ((16, 1 << 16), (16, 1 << 13), (16, 1 << 10), (16, 1 << 17), (1, 1 << 17),
               (1, 1 << 16), (1, 1 << 13), (128, 1 << 13), (32, 1 << 16), (1, 1 << 18))
SPONGE_STATEMENTS = (1, 16, 32, 128)
QUERIES, QUERY_MASK = 30, (1 << 15) - 1


def sponge_fold(torch, np, lst, dev, words) -> dict:
    """The ``sponge_fold`` section for the imported checkout."""
    from chip_smoke import graph_ms  # this repository's (main)
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.ops import fri_fold, keccak
    from lambda_snark_tpu_torch.proof import fri_device
    from lambda_snark_tpu_torch.proof.fri import FriParams, FriTranscript, coset_offset, root_of_order

    kernels.build(["fri", "keccak", "ntt"])  # the chain's libraries, in parallel
    gl = lst.NTT_MODULUS
    fused = hasattr(fri_fold, "fold_squeeze")
    out = dict(fused=fused, squeeze30={}, layer={}, fold={}, tail={})
    for s in (1, 16, 128):
        st = words((s, 4), 1 << 64)
        out["squeeze30"][f"S={s}"] = graph_ms(
            torch, lambda st=st: keccak.transcript_squeeze(st, b"fri-query", 9, QUERIES,
                                                          QUERY_MASK))
    for rows, n in FOLD_SHAPES:
        cur, inv_x, cs = words((rows, n), gl), words((n // 2,), gl), words((rows,), gl)
        st, root = words((rows, 4), 1 << 64), words((rows, 4), 1 << 64)
        out["fold"][f"{rows}x{n}"] = graph_ms(torch, lambda: fri_fold.fold(cur, inv_x, cs))
        for with_root in (False, True):
            r = root if with_root else None
            if fused:
                layer = lambda r=r: fri_fold.fold_squeeze(cur, inv_x, st, 5, r)
            else:
                def layer(r=r):
                    state = st if r is None else keccak.transcript_absorb(st, b"fri-layer-root", r)
                    state, c = keccak.transcript_squeeze_field(state, b"fri-fold", 5)
                    return fri_fold.fold(cur, inv_x, c), state
            key = f"{rows}x{n}{' root' if with_root else ''}"
            out["layer"][key] = graph_ms(torch, layer)
    for s in SPONGE_STATEMENTS:
        st, fin = words((s, 4), 1 << 64), words((s, 64), gl)
        if fused:
            tail = lambda st=st, fin=fin: keccak.transcript_final_queries(
                st, b"fri-final", fin, 64, b"fri-query", 9, QUERIES, QUERY_MASK + 1)
        else:
            tail = lambda st=st, fin=fin: keccak.transcript_squeeze(
                keccak.transcript_absorb(st, b"fri-final", fin, 64), b"fri-query", 9, QUERIES,
                QUERY_MASK)
        out["tail"][f"S={s}"] = graph_ms(torch, tail)
    # the host's enqueue of a k7a chain: g (16, 2^16), one group of 4 oracles
    s, n0 = 16, 1 << 16
    g, vals = words((s, n0), gl), words((s, 4, n0), gl)
    inputs = [(vals, fri_device.commit_planes_dev_groups(vals))]
    trs = []
    for i in range(s):
        tr = FriTranscript()
        tr.absorb(b"ab", bytes([i]))
        trs.append(tr)
    args = (g, inputs, coset_offset(gl), root_of_order(gl, n0), gl, FriParams(), trs)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fri_device.fri_chain_dispatch(*args)
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    times = times[1:]  # the first caches the shape's tables
    out["chain_enqueue_ms_k7a"] = sorted(times)[len(times) // 2]
    return out


def sponge_candidates(torch, np, dev, words) -> dict:
    """The ``sponge_candidates`` section: ``scripts/sponge_candidates.cu``
    built with ``nvcc`` into ``build/``, each design held against the twin."""
    import ctypes
    import subprocess

    import chip_smoke
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.ops import keccak

    src = os.path.join(REPO, "scripts", "sponge_candidates.cu")
    lib_path = os.path.join(REPO, "build", "sponge_candidates", "libsponge_candidates.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", lib_path, src], check=True,
                   capture_output=True, text=True)
    lib = ctypes.CDLL(lib_path)
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
    lib.squeeze_candidate.argtypes = [I, P, P, P, P, I, I, U, I, U, I, P]
    lanes, lane, shift = keccak.squeeze_lanes(b"fri-query")
    out = {"sass": {fn: mix["total"] for fn, mix in chip_smoke.sass_mix(lib_path).items()}}
    for s in (1, 16, 128):
        st = words((s, 4), 1 << 64)
        want = keccak.transcript_squeeze_plain(st.cpu(), b"fri-query", 9, QUERIES, QUERY_MASK)
        for design, name in enumerate(("thread", "warp", "warp_theta1")):
            new = torch.empty_like(st)
            idx = torch.empty((s, QUERIES), dtype=torch.int64, device=dev)
            call = lambda d=design, new=new, idx=idx, st=st: lib.squeeze_candidate(
                d, st.data_ptr(), new.data_ptr(), idx.data_ptr(), lanes.ctypes.data, lane,
                shift, 9, QUERIES, QUERY_MASK, s, kernels.stream_handle(dev))
            if call() != 0:
                raise RuntimeError(f"sponge candidate {name}: launch failed")
            torch.cuda.synchronize()
            if not (torch.equal(new.cpu(), want[0]) and torch.equal(idx.cpu(), want[1])):
                raise RuntimeError(f"sponge candidate {name} at S={s} disagrees with the twin")
            out[f"{name} S={s}"] = chip_smoke.graph_ms(torch, call)
    return out


def cuda_ms(torch, fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def idle_share(torch, fn) -> float:
    """1 - device busy / wall of one call, as ``chip_smoke.device_busy``
    reads them from a ``torch.profiler`` trace."""
    import chip_smoke

    trace = os.path.join(REPO, "build", "ab_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    wall, busy, _ = chip_smoke.device_busy(torch, fn, trace)
    return None if busy is None else 1.0 - busy / wall


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="checkout holding lambda_snark_tpu_torch/")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", help="also write the JSON line to this file")
    ap.add_argument("--sections", nargs="+", choices=SECTIONS, default=list(SECTIONS))
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke  # noqa: F401  this repository's timers and profiler reading, not --root's
    sys.path[0] = os.path.abspath(args.root)  # the port comes from --root

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_port_ab: no CUDA device", file=sys.stderr)
        return 2
    import lambda_snark_tpu_torch as lst
    from lambda_snark_tpu_torch.commit.lwe import goldilocks_ring_plan
    from lambda_snark_tpu_torch.core.params import HEALTHCARE_DUMP_MODULUS
    from lambda_snark_tpu_torch.ops import modarith
    from lambda_snark_tpu_torch.ops import quotient as qmod
    from lambda_snark_tpu_torch.ops import ring_commit as rmod
    from lambda_snark_tpu_torch.ops.ntt import NttPlan
    from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
    from lambda_snark_tpu_torch.pipeline import field_psi_for
    from lambda_snark_tpu_torch.proof import fri_device
    from lambda_snark_tpu_torch.proof.fri import root_of_order
    from lambda_snark_tpu_torch.r1cs.circuit import CircuitBuilder

    if not lst.__file__.startswith(os.path.abspath(args.root)):
        raise RuntimeError(f"imported {lst.__file__}, not the checkout at {args.root}")
    dev = torch.device("cuda")
    rng = np.random.default_rng(20240617)
    gl = lst.NTT_MODULUS
    moduli = {"q45": lst.NTT_FRIENDLY_MODULUS, "goldilocks": gl,
              "barrett": HEALTHCARE_DUMP_MODULUS}

    def words(shape, q):
        return modarith.to_words(rng.integers(0, q, size=shape, dtype=np.uint64), dev)

    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    record = dict(label=args.label, root=os.path.abspath(args.root),
                  device=torch.cuda.get_device_name(0), nvidia_smi=smi, ntt={}, q_and_r={},
                  clusters={}, long_routes={}, forests={}, kind7={})
    if "sponge_fold" in args.sections:
        record["sponge_fold"] = sponge_fold(torch, np, lst, dev, words)
    if "sponge_candidates" in args.sections:
        record["sponge_candidates"] = sponge_candidates(torch, np, dev, words)

    for name, rows, size in SHAPES_T if "ntt" in args.sections else ():
        q = moduli[name]
        plan = NttPlan.create(size, q, root_of_order(q, size), device=dev)
        x = words((rows, size), q)
        for direction, fn in (("forward", ntt_forward_batched), ("inverse", ntt_inverse_batched)):
            record["ntt"][f"{name} {rows}x{size} {direction}"] = cuda_ms(
                torch, lambda fn=fn: fn(plan, x))

    from lambda_snark_tpu_torch import kernels

    shaped = {}  # label -> (kernel call, rows, m, ring words per row or None)
    for name, rows, m in Q_SHAPES if "q_and_r" in args.sections else ():
        q = moduli[name]
        qplan = qmod.QuotientPlan.create(m, q, field_psi_for(m, q), device=dev)
        a, b = words((rows, m), q), words((rows, m), q)
        c = modarith.mul_mod(a, b, q)
        shaped[f"Q {name} {rows}x{m}"] = (lambda p=qplan, a=a, b=b, c=c: qmod.quotient(p, a, b, c),
                                          rows, m)
    for rows, n, k, msg_len in R_SHAPES if "q_and_r" in args.sections else ():
        ring = rmod.RingCommitPlan.create(rng.integers(0, gl, size=(k, n), dtype=np.uint64),
                                          goldilocks_ring_plan(n, dev))
        s_draws = torch.from_numpy(rng.integers(-39, 40, size=(k, rows, n), dtype=np.int32)).to(dev)
        e_draws = torch.from_numpy(rng.integers(-39, 40, size=(rows, n), dtype=np.int32)).to(dev)
        msg = words((rows, msg_len), gl)
        shaped[f"R {rows}x{n} k={k} msg={msg_len}"] = (
            lambda r=ring, s_=s_draws, e_=e_draws, mm=msg: rmod.ring_commit(r, s_, e_, mm), rows, n)
    for label, (fn, _, _) in shaped.items():
        record["q_and_r"][label] = cuda_ms(torch, fn)
    rule = getattr(kernels, "cluster_size", None)
    if rule is not None:
        try:
            for label, (fn, rows, m) in shaped.items():
                for cluster in (1, 2, 4, 8):
                    if m > cluster * (1 << 13) or cluster * cluster > m:
                        continue
                    kernels.cluster_size = lambda *_, cluster=cluster: cluster
                    record["clusters"][f"{label} C={cluster}"] = cuda_ms(torch, fn)
        finally:
            kernels.cluster_size = rule

    if "long_routes" in args.sections:
        m, s = 1 << 14, 16
        qplan = qmod.QuotientPlan.create(m, gl, field_psi_for(m, gl), device=dev)
        a, b = words((s, m), gl), words((s, m), gl)
        c = modarith.mul_mod(a, b, gl)
        record["long_routes"]["quotient 16x2^14"] = cuda_ms(
            torch, lambda: qmod.quotient_long(qplan, a, b, c))
        ctx = lst.LweContext(lst.Params(lst.SecurityLevel.BITS128,
                                        lst.Profile.ring_b(n=m, k=1, q=gl, sigma=3.19)),
                             context_seed=0)
        ring = rmod.RingCommitPlan.create(ctx.a_hat, goldilocks_ring_plan(m, dev))
        s_draws = torch.from_numpy(rng.integers(-39, 40, size=(1, s, m), dtype=np.int32)).to(dev)
        e_draws = torch.from_numpy(rng.integers(-39, 40, size=(s, m), dtype=np.int32)).to(dev)
        msg = words((s, m), gl)
        record["long_routes"]["ring_commit 16x2^14"] = cuda_ms(
            torch, lambda: rmod.ring_commit_long(ring, s_draws, e_draws, msg))

    if "forests" in args.sections:
        for trees, groups, n in FORESTS:
            vals = words((trees, groups, n), gl)
            if groups == 1:
                vals = vals[:, 0].contiguous()
                fn = lambda v=vals: fri_device.commit_planes_dev(v)
            else:
                fn = lambda v=vals: fri_device.commit_planes_dev_groups(v)
            dev_ms = cuda_ms(torch, fn)
            times = []
            for _ in range(20):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn()  # the roots reach the host inside
                times.append((time.perf_counter() - t) * 1e3)
            record["forests"][f"{trees}x{groups}x{n}"] = dict(
                ms=dev_ms, leaves_to_roots_host_ms=sorted(times)[len(times) // 2])

    if "kind7" in args.sections:
        for m in KIND7_SIZES:
            builder = CircuitBuilder(gl)
            builder.alloc_var()
            xs_v, ys_v = builder.alloc_vars(m), builder.alloc_vars(m)
            builder.set_public_inputs(1)
            for xv, yv in zip(xs_v, ys_v):
                builder.mul_gate(xv, xv, yv)
            r1cs = builder.build()
            ctx = lst.LweContext(lst.Params(lst.SecurityLevel.BITS128,
                                            lst.Profile.ring_b(n=m, k=1, q=gl, sigma=3.19)),
                                 context_seed=0)
            xs = rng.integers(0, gl, size=(KIND7_S, m), dtype=np.uint64)
            ys = modarith.to_u64(modarith.mul_mod(modarith.to_words(xs, dev),
                                                  modarith.to_words(xs, dev), gl))
            wits = np.concatenate([np.ones((KIND7_S, 1), np.uint64), xs, ys], axis=1)
            seeds = list(range(300, 300 + KIND7_S))
            batch = lambda: lst.prove_r1cs_succinct_batch(r1cs, wits, ctx, seeds)
            batch()
            times = []
            for _ in range(KIND7_REPS):
                torch.cuda.synchronize()
                t = time.time()
                batch()
                times.append(time.time() - t)
            median = sorted(times)[len(times) // 2]
            record["kind7"][f"m={m}"] = dict(end_to_end_s=times, median_s=median,
                                             proofs_per_s=KIND7_S / median,
                                             idle_share=idle_share(torch, batch))
    line = json.dumps(record)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
