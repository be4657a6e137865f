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
  batch under ``torch.profiler``.

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
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.append(REPO)  # chip_smoke's profiler reading; the port comes from --root

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

    for name, rows, size in SHAPES_T:
        q = moduli[name]
        plan = NttPlan.create(size, q, root_of_order(q, size), device=dev)
        x = words((rows, size), q)
        for direction, fn in (("forward", ntt_forward_batched), ("inverse", ntt_inverse_batched)):
            record["ntt"][f"{name} {rows}x{size} {direction}"] = cuda_ms(
                torch, lambda fn=fn: fn(plan, x))

    from lambda_snark_tpu_torch import kernels

    shaped = {}  # label -> (kernel call, rows, m, ring words per row or None)
    for name, rows, m in Q_SHAPES:
        q = moduli[name]
        qplan = qmod.QuotientPlan.create(m, q, field_psi_for(m, q), device=dev)
        a, b = words((rows, m), q), words((rows, m), q)
        c = modarith.mul_mod(a, b, q)
        shaped[f"Q {name} {rows}x{m}"] = (lambda p=qplan, a=a, b=b, c=c: qmod.quotient(p, a, b, c),
                                          rows, m)
    for rows, n, k, msg_len in R_SHAPES:
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
