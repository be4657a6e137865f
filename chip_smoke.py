#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``lambda_snark_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one flushed line with the seconds since start:

1. the device: ``torch.cuda`` name and ``nvidia-smi`` name and power limit;
2. the build of every CUDA kernel from ``lambda_snark_tpu_torch/csrc``
   (one ``nvcc`` per source, started together), each kernel function's
   registers and spills, and the SASS instruction mix of kernel T's
   ``dft_pass``, kernel K's forest kernel (G = 1 and 4, the kind-7 path's;
   2, 5 and 6, kind 9's), kernels Q and R at each cluster size and kernels
   S (``sponge_kernel``) and F (``fold_kernel``, ``fold_squeeze_kernel``);
   beside
   them, the native host library (``native_bridge``, ``g++`` on
   ``native/src``) where there is a C++ compiler: a failed build fails the
   script;
3. kernel Q against its plain PyTorch twin at B = 256, bit-exact: the 44-bit
   field at m = 4096 (plain prover) and m = 2048 (ZK prover), Goldilocks at
   m = 4096, each at the cluster size ``kernels.cluster_size`` picks;
4. kernel R against its plain twin at n = 4096, k = 2, B = 256, bit-exact,
   for messages of 4096 words (plain prover) and 2049 (ZK prover);
5. ``prove_r1cs_batched`` at m = n = 4096, k = 2, B = 256 on the card: every
   proof satisfies a b - c = Q (x^m - 1) at alpha and beta, the first 8
   proofs equal a ``device="cpu"`` run byte for byte, and both kernels'
   launch counts moved during the run;
6. the same for ``zk=True`` at m = 2048;
7. the device-stage and sampler times of the batched prover and a
   host-clock breakdown of one batch;
8. kernel K (Keccak Merkle hashing) against its plain twin, bit-exact:
   group leaves of G = 4 oracles over 16 x 32768 leaves, paired leaves over
   16 x 16384, nodes over 16 x 16384; 256 sampled digests against
   ``hashlib.sha3_256``;
9. kernel N (Goldilocks four-step NTT) against its plain twin, bit-exact, at
   64 x 2^16 (the kind-7 LDE) and 1 x 2^20, and its leaf entry at B = 128
   and at 16 x 512 (FRI's final polynomials);
10. kernel Q (Goldilocks) at m = 8192 x 16 rows and kernel R at n = 8192,
    k = 1, a message of 8192 words x 16 rows, the kind-7 shapes (a row over
    a cluster of 8 blocks);
11. ``prove_r1cs_succinct_batch`` at m = 2^13, S = 16, default FriParams on
    the card: every proof passes ``verify_r1cs_succinct``, proofs 0 and 1
    equal a ``device="cpu"`` run byte for byte, a flipped byte in a FRI path
    and a flipped ``q_alpha`` are rejected, and the launch counts of kernels
    K, N, Q and R all moved during the run (kernel K: one forest launch per
    Merkle forest, 7 a batch, and no per-level launch); then kernel K's
    forest entries at every forest shape of that run against their twin,
    and the leaves-to-roots host time of the largest and the smallest
    forest by the forest entry and by the per-level route (``hash_leaves``
    + one ``hash_nodes`` per level), median of 20;
12. a host-clock breakdown of kind-7 batches by stage, each part the median
    of five staged batches, and the device-busy time and idle share of one
    batch under ``torch.profiler``, from the CUDA activity of its trace;
13. kernel T (``csrc/ntt.cu``, the port of the TPU's batched resident NTT)
    against ``ops.ntt``, forward and inverse, bit-exact: the 44-bit field
    and Goldilocks at 256 x 2^13 and 64 x 256 (entry ``ntt_rows``),
    2013265921 (run-time Barrett) at 16 x 2^13 and 16 x 2^14, and the
    four-step at 16 and 48 x 2^14, 16 and 64 x 2^17 and 1 x 2^21; then the
    three-pass four-step at 1 x 2^27 (Goldilocks, past the two-pass range),
    with the peak device memory of that phase;
14. kernels Q and R at m = n = 2^14 x 16 rows: their long routes through
    kernel T (``quotient_long``, ``ring_commit_long``, called directly)
    against ``quotient_plain`` and ``ring_commit_plain``, and each
    elementwise entry of the routes against its twin; then both kernels in
    one launch each (clusters of 8 blocks) at 16 x 2^14 and 16 x 2^16;
15. ``prove_r1cs_succinct_batch`` at m = 2^14, S = 16 on the card: every
    proof verifies, proofs 0 and 1 equal a ``device="cpu"`` run byte for
    byte, the median of five batches, and every entry of the path launched
    (kernels Q and R once each and kernel T's four-step twice, for the LDE,
    with no launch of the long routes' entries; kernel K: 8 forest launches
    a batch, no per-level launch); then kernel
    K at every input shape that run launched it at (the group forest
    16 x 4 x 2^17, each paired-leaf forest), kernel T at each of its shapes
    that phase 13 did not hold, against their twins, and the forest times
    as in phase 11;
16. ``prove_r1cs_stream`` at m = n = 4096 in batches of 256 (3 batches and a
    tail of 100): every proof through ``deserialize_any`` and
    ``verify_r1cs``, the first 8 equal a CPU run, proofs/s; a ``ProofStore``
    resume (a run cut after 300 proofs, then a full run) gives the same
    bytes and a store that verifies; the ZK stream at m = 2048 (a batch and
    a tail) through ``verify_r1cs_zk``;
17. ``entry()``: the prove stage at m = 16, n = 32, B = 2 equals the CPU's;
18. ``prove_r1cs_succinct_batch(zk=True)`` at m = 2^13, S = 16 (masks of 68
    words, n0 = 2^17): every proof verifies, proofs 0 and 1 equal a
    ``device="cpu"`` run byte for byte, a flipped FRI path byte and a
    flipped ``q_alpha`` are rejected, kernels Q, R, T and K launched (the
    counts printed per batch), the median of five batches and the idle
    share of one profiled batch; then kernels
    K, T, Q, R, S and F at every shape that run launched them at, against
    their twins (each shape held once in the script);
19. the chunk-pipelined prover (``pipeline_chunk=32``, the JAX package's
    three phases: every front end, then every FRI chain, then every
    bundle pulled) at m = 2^13,
    S = 64 and 128: bytes equal to the unchunked prover's on the card for
    every statement, every proof verifies, one front end per chunk; the
    median of three batches of each route, alternated, and the idle share
    of one profiled batch of each; then the S = 128 run's shapes as in 18;
20. ``prove_r1cs_succinct_stream`` at m = 2^13, 40 witnesses in batches of
    16: every proof through ``deserialize_any`` and the verifier, the same
    bytes as one batch of 40, proofs/s, and a ``ProofStore`` resume (a run
    cut after 20 proofs, then a full run); then its shapes as in 18;
21. the host golden path on the card's machine (no card): the healthcare
    quotient against ``artifacts/r1cs/healthcare_quotient.json``,
    ``prove_r1cs(with_opening=True)`` through ``verify_r1cs_with_context``,
    and kinds 1, 2, 3 and 6 through ``deserialize_any`` and their verifiers;
22. ``prove_r1cs_succinct_aggregate`` (kind 8) at the JAX benchmark's two
    shapes: agg13 (m = 2^13, S = 16, plain and ZK) and agg10 (m = 2^10,
    S = 128, plain), ring n = m, k = 1, default FriParams: every aggregate
    verifies after ``deserialize_any``, a flipped FRI path byte and a
    flipped statement evaluation are rejected, a card run at a reduced S
    (2 at agg13, 8 at agg10) equals a ``device="cpu"`` run byte for byte,
    kernels Q, R, T and K launched (counts per batch printed), the median
    of five batches, proofs/s and bytes per statement, and the idle share of
    one profiled batch; then kernels K, T, Q, R, S and F at every shape each run
    launched them at, as in 18;
23. the host routes: kind 7 over the 44-bit field and the healthcare prime
    (plain and ZK), kind 7 at ring degree n < m (a zero-quotient circuit on
    the card's front end, the quotient committed on the host), compact
    kinds 4 and 5 and the phase-2 checked proof on the healthcare circuit;
    each verifies and a tampered one is rejected; host seconds per route;
24. ``prove_r1cs_witness`` (kind 9) at the JAX benchmark's shape: m = 2^12
    squaring gates (M = 2^14), ring n = m, k = 1, default FriParams, plain
    (n0 = 2^18) and ZK (n0 = 2^19): the proof verifies after
    ``deserialize_any``, a flipped FRI path byte, a flipped gamma
    evaluation and the public input [2] are rejected, the bytes equal a
    ``device="cpu"`` run, kernels Q, R, T and K launched (counts per proof
    printed), the median of five proofs, proofs/s, bytes, the idle share
    of one profiled proof and a host-clock breakdown by stage (median of
    three staged proofs); ``prove_r1cs_witness_batch`` at S = 4 and the
    ``witness_bind`` stream at m = 2^10 (10 witnesses in batches of 4, a
    ``ProofStore`` resume): every proof verifies, the stream's bytes are one
    batch's; then kernels K, T, Q, R, S and F at every shape each run launched
    them at, as in 18;
25. the command line (``cli.main`` in this process, the entry point of
    ``python -m lambda_snark_tpu_torch``), on circuit, witness and context
    files in a temporary directory (contexts from its own ``setup``):
    ``prove-stream --succinct --batch 16`` at k7a (m = 2^13, S = 16, ring
    n = 8192, k = 1), ``prove --witness-bind`` at m = 2^12 plain and
    ``--zk``, and ``prove-stream`` of 256 witnesses at m = 4096 (and
    ``--zk`` at m = 2048) over the 44-bit field, ring n = 4096, k = 2:
    every proof file equals the library call's bytes on the same inputs
    (``prove_r1cs_succinct_stream``, ``prove_r1cs_witness``,
    ``prove_r1cs_stream``), ``verify`` accepts (exit 0) and a flipped FRI
    path byte exits 1, the launches equal phases 11 and 24's (kernels Q and
    R once a batch for kinds 2/3), and a ``--store`` run cut after 128
    proofs resumes with the same bytes; the native host library is built
    and the host verifier decides the same with it and without it (both
    rates printed); ``fuzz --iterations 200`` on the card gives the CPU
    run's counts; ``python -m lambda_snark_tpu_torch info`` in a process
    of its own names the card and imports neither ``jax`` nor
    ``lambda_snark_tpu``; then kernels K, T, Q, R, S and F at every shape the
    command line launched them at, as in 18;
26. the multi-device layer (``parallel/``) at m = n = 4096, k = 2, B = 256
    on phase 16's first batch and key: (a) a world of one under NCCL (this
    process): ``ShardedProver`` on a (1, 1) mesh equals
    ``prove_stage_batch`` (kernels Q and R) in Q, A, B, C, the commitment
    and the flags, the first 8 commitments are recomputed on the host from
    the returned (s, e), one run launches kernel T's row entry (at most
    20 times) and neither Q nor R, and its step is timed beside
    ``prove_stage_batch`` (CUDA events, median of 20); (c)
    ``ShardedProofService`` on that mesh over phase 16's 868 witnesses:
    every proof through ``deserialize_any`` and ``verify_r1cs``, the first
    256 equal ``prove_r1cs_stream``'s, a ``ProofStore`` run cut after 300
    and resumed serves those bytes, proofs/s; (b) four ranks that share the
    card over gloo (``spawn_local``), meshes (2, 2) and (1, 4): outputs
    equal (a)'s, each rank's launches and step times, and no rank imports
    jax; (d) ``entry.dryrun_multichip(4, backend="gloo")`` on the card,
    legs (a)-(f); (e) kernel T at every row shape (a) and (b) launched, as
    in 18;
27. the FRI chain (``proof.fri_device``, ``DEVICE_TRANSCRIPT``), which
    every kind-7 and kind-8 phase above runs by default: kernel S (the
    transcript sponge, ``csrc/fri.cu``) at S = 1, 16, 32 and 128 for each
    entry (a layer root, ``fri-final`` at final_len 64, a fold challenge,
    30 query indices, and the chain's ``fri-final`` absorb with its 30
    query squeezes in one launch) against its twin and
    ``hashlib.sha3_256``; then k7a, k7b, ZK k7a, agg13 (plain and ZK),
    agg10 and the pipelined prover at S = 64 and 128 (chunks of 32)
    proved with the switch on and off in turns: the bytes equal both ways,
    the chain's proofs verify and tampered ones are rejected, per route
    the median of three batches, the idle share of one profiled batch, the
    launches of kernels S, F, K and T (the chain's S and F asserted:
    ``CHAIN_LAUNCHES``) and the host synchronisations of one batch
    (PyTorch's sync debug mode in ``warn``); kernels S and F held at every
    shape each chain run launched them at, and kernel F's chain entry
    (``fold_squeeze``) both with and without a root at each of its shapes,
    its states, challenges and words against ``hashlib.sha3_256``; and
    ``fri_chain_dispatch`` of a k7a batch under
    ``torch.cuda.set_sync_debug_mode("error")``, whose
    ``fri_chain_finish`` synchronises once. Kernels S and F are timed by
    device time (CUDA events around a CUDA graph of 20 captured calls:
    their wrappers' enqueue outlasts them), and each S and F shape gets a
    latency bound beside its throughput bound (the ``fri_chain`` line);
28. the port's examples (``examples/torch_*.py``) and last public names:
    each example's ``main`` on the card (batched kinds 2/3 with the store
    and a compact proof; the stream and ``ShardedProofService`` with resume
    on a (2, 2) mesh of four ranks sharing the card over gloo; base,
    succinct and ZK-succinct proofs at m = 2^10), its assertions, its
    launches (kernels Q, R, K and T each launched by the three) and bytes
    equal to its ``--device cpu`` run; ``commit.lwe.randomness_batch`` on
    the multi-key ChaCha20 blocks against the per-seed loop at n = 4096,
    k = 2, S = 256 (equal draws; both host times, medians of three in
    turns); kind 7 at m = 2^10, S = 2 with ``proof.succinct.GL_FAST_FRONTEND``
    off (the host route) with the device route's bytes, and the switch on
    again after;

then the JSON lines: kind 7 at m = 2^13 (proofs/s, breakdown, idle share),
kind 7 at m = 2^14, the streams, ZK kind 7, the pipelined prover, the
kind-7 stream, the host path, kind 8 (one line per shape), the host routes,
kind 9, the command line, the multi-device layer (per-leg seconds, step
times, launches, the service's proofs/s), the FRI chain against the
per-layer route per shape, the examples and names of phase 28, and the
``kernels`` line: for each kernel
on each path its time, its plain twin's time, its bound and its launches in
that path's run, counted per C entry (the four-step NTT's entry launches
two kernels, one per pass) and, for kernels K and T on the m = 2^14 kind-7
path, per input shape and direction; kernels Q and R also give the blocks
of the cluster each row ran on (null for the long routes).

Any failure ends the script with a non-zero exit and no result line. The
last line is ``{"ok": true, "device": {...}}``. It needs one CUDA card; it
imports neither ``jax`` nor ``lambda_snark_tpu``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

T0 = time.time()

SEED = 20240617
BATCH = 256
M_PLAIN, M_ZK, RING_N, RING_K, SIGMA = 4096, 2048, 4096, 2, 3.19
CHECK_ROWS = 8  # proofs compared byte for byte with a CPU run

# Bounds on the H100 (3.35 TB/s of device memory, 16.7 T 32-bit integer
# operations/s, from NVIDIA's data sheet) come from the port's
# ``utils.timing.H100`` (``bound_ms``).
# Least 32-bit integer instructions per 64-bit modular operation, from the
# kernels' arithmetic (csrc/modmath.cuh): a 64 x 64 -> 128 product is four
# 32 x 32 -> 64 multiplies; Barrett (44-bit field) adds two more partial
# 64-bit products, the Goldilocks fold one 32 x 32 multiply; an add or
# subtract is a 64-bit add (2) plus a compare-select (1). Kernel Q's 44-bit
# field multiplies by known constants (twiddles, tables, 1/m) with Shoup's
# product w x - umulhi(x, w') q mod 2^64: the low word of x w (3 multiplies),
# umulhi (4), the low word of the quotient times q (3) and a 64-bit subtract
# (2), 12 where Barrett counts 16 (OPS_MUL_TABLE); a product of two data
# words keeps Barrett's count.
OPS_MUL = {"q45": 16, "goldilocks": 12, "barrett": 16}
OPS_MUL_TABLE = {"q45": 12, "goldilocks": 12}
OPS_ADD = 3
# Least 32-bit instructions per Keccak-f[1600] permutation (csrc/keccak.cu):
# per round and 32-bit half of the 25 lanes, theta's column sums take 2
# three-input logic ops (LOP3) each (5 columns), its rotated mix 1 funnel
# shift each (5) and 1 LOP3 per lane (25); rho 1 funnel shift per rotated
# lane (24); chi 1 LOP3 per lane (25); iota 1 on lane 0: 90 per half, 180
# per round, 24 rounds.
OPS_KECCAK = 24 * 180

KIND7_M, KIND7_S = 1 << 13, 16
KIND7_CHECK = 2  # kind-7 proofs compared byte for byte with a CPU run
KIND7_REPS = 5  # timed kind-7 batches (the first one counts launches)
# the C entries the kind-7 path must launch (kernels.launches() keys), and
# kernel K's per-level entries, which it must not: one forest launch builds
# each Merkle forest (the input oracles' group forest and one paired-leaf
# forest per committed FRI layer)
KIND7_ENTRIES = ("keccak_group_forest", "keccak_forest", "ntt_four_step", "ntt_rows",
                 "quotient_goldilocks", "ring_commit_goldilocks")
KECCAK_PER_LEVEL = ("keccak_group_leaves", "keccak_leaves", "keccak_nodes")
KIND7_FORESTS, KIND7_LONG_FORESTS = 7, 8
FOREST_TIME_REPS = 20  # host-clock leaves-to-roots times, median
# kind 7 one size up, m = 2^14: kernels Q and R each run once a batch, a
# row over a cluster of 8 blocks, and kernel T's four-step only for the LDE
# (one forward transform, two passes); the long routes' entries run no time
KIND7_LONG_M = 1 << 14
KIND7_LONG_COUNTS = {"quotient_goldilocks": 1, "ring_commit_goldilocks": 1, "ntt_four_step": 2,
                     "quotient_pointwise": 0, "ring_twist": 0, "ring_accumulate": 0,
                     "ring_finish": 0}
# rows past a cluster's shared memory take the long routes; 2^16 is the
# longest row kernels Q and R take in one launch
ONE_LAUNCH_M = 1 << 16
# the four-step past two passes: 1 x 2^27 Goldilocks words, three passes
NTT_DEEP_LOG_M = 27
# prove_r1cs_stream: three full batches and a partial tail; ZK at m = 2048
STREAM_COUNT, STREAM_ZK_COUNT, STREAM_CUT = 3 * BATCH + 100, BATCH + 100, 300
# ZK kind 7: the default FriParams' 30 queries give masks of 2 x 30 + 8 words
FRI_QUERIES = 30
# the chunk-pipelined prover: S = 64 and 128 in chunks of 32
PIPE_SIZES, PIPE_CHUNK = (64, 128), 32
# prove_r1cs_succinct_stream: two batches of 16 and a tail of 8
STREAM7_COUNT, STREAM7_BATCH = 40, 16
# kind 8 at the JAX benchmark's shapes (bench.py:713-726, 748-762):
# (label, m, statements, zk, statements of the CPU comparison)
KIND8 = (("agg13", 1 << 13, 16, False, 2), ("agg13_zk", 1 << 13, 16, True, 2),
         ("agg10", 1 << 10, 128, False, 8))
# kind 9 at the JAX benchmark's shape (bench.py:627-660): m = 2^12 squaring
# gates (n = 2m + 1 variables, so M = 2^14), ring n = m, k = 1, default
# FriParams; the batch at S = 4; the witness_bind stream at m = 2^10, 10
# witnesses in batches of 4
KIND9_M, KIND9_BATCH = 1 << 12, 4
KIND9_STREAM_M, KIND9_STREAM_COUNT, KIND9_STREAM_BATCH = 1 << 10, 10, 4


def sass_mix(path: str) -> dict:
    """Per kernel function of a built library, its SASS instruction count
    and the share of integer multiply-adds (IMAD) and of compare-selects
    (ISETP, SEL), from ``cuobjdump -sass``; empty where the tool is
    missing."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                         timeout=120).stdout
    mix, name = {}, None
    for line in out.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            mix[name] = {"total": 0, "IMAD": 0, "ISETP+SEL": 0}
            continue
        op = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)", line)
        if name and op:
            mix[name]["total"] += 1
            key = {"IMAD": "IMAD", "ISETP": "ISETP+SEL", "SEL": "ISETP+SEL"}.get(op.group(1))
            if key:
                mix[name][key] += 1
    return mix


def ptxas_resources(log: str) -> list:
    """(kernel function, registers, spills) for each entry function of an
    ``nvcc -Xptxas -v`` log."""
    import re

    out, name, spills = [], None, ""
    for line in log.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name, spills = found.group(1), ""
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name:
            out.append((name, line.split(":", 1)[-1].strip(), spills))
            name = None
    return out


def nonzero(launches: dict) -> dict:
    """The entries of a launch count that moved."""
    return {k: v for k, v in launches.items() if v}


def phase(msg: str) -> None:
    print(f"[{time.time() - T0:7.1f}s] {msg}", flush=True)


def cuda_ms(torch, fn, reps: int, each: bool = False) -> float:
    """Device time of ``fn`` in ms after a warm-up: the mean of ``reps``
    calls between one pair of CUDA events, or with ``each`` the median of
    ``reps`` calls, each between its own pair."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps if each else 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(1 if each else reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / (1 if each else reps))
    return sorted(times)[len(times) // 2]


def graph_ms(torch, fn, reps: int = 20) -> float:
    """Device time of ``fn`` in ms: CUDA events around one replay of a CUDA
    graph of ``reps`` captured calls, the median of five replays. For
    kernels that run shorter than their wrappers' enqueue, which
    back-to-back calls would time instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return sorted(times)[len(times) // 2]


def max_abs_err(np, modarith, got, want) -> float:
    """max |got - want| over unsigned 64-bit words."""
    g, w = modarith.to_u64(got), modarith.to_u64(want)
    return float(np.where(g >= w, g - w, w - g).max()) if g.size else 0.0


def bound_ms(nbytes: float, ops: float):
    """The least time in ms of work moving ``nbytes`` bytes and doing
    ``ops`` 32-bit integer operations on the H100, and which bounds it."""
    from lambda_snark_tpu_torch.utils.timing import roofline

    r = roofline(nbytes, ops)
    return r["speed_of_light_s"] * 1e3, r["bound_by"]


def quotient_work(rows: int, m: int, field: str):
    log_m = m.bit_length() - 1
    butterflies = 7 * (m // 2) * log_m * rows
    table_muls = butterflies + 7 * m * rows  # twiddles, 1/m and twist (x3), untwist
    data_muls = 2 * m * rows  # the residual a b and a_odd b_odd
    adds = 2 * butterflies + m * rows
    nbytes = 7 * rows * m * 8 + 4 * rows + (2 * (m // 2) + 2 * m) * 8
    return nbytes, (table_muls * OPS_MUL_TABLE[field] + data_muls * OPS_MUL[field]
                    + adds * OPS_ADD)


def ring_work(rows: int, n: int, k: int, msg_len: int):
    log_n = n.bit_length() - 1
    butterflies = (k + 1) * (n // 2) * log_n * rows
    muls = butterflies + (2 * k + 1) * n * rows  # twist, A-hat, untwist
    adds = 2 * butterflies + (k + 1) * n * rows
    nbytes = (k * rows * n + rows * n) * 4 + rows * msg_len * 8 + rows * n * 8 \
        + (k * n + 2 * n + n) * 8
    return nbytes, muls * OPS_MUL["goldilocks"] + adds * OPS_ADD


def keccak_work(hashes: int, in_bytes: int):
    return in_bytes + 32 * hashes, hashes * OPS_KECCAK


def ntt_work(rows: int, m: int, twiddled: bool, field: str = "goldilocks",
             scaled: bool = False, tables: int = 0):
    """Bytes and ops of ``rows`` m-point NTTs (the four-step adds one
    twiddle product per word, the inverse one 1/m product, each pre or
    post table one product per word; tables are read once)."""
    butterflies = rows * (m // 2) * (m.bit_length() - 1)
    muls = butterflies + rows * m * (int(twiddled) + int(scaled) + tables)
    nbytes = 2 * rows * m * 8 + (m if twiddled else m // 2) * 8 + tables * m * 8
    return nbytes, muls * OPS_MUL[field] + 2 * butterflies * OPS_ADD


def ntt_hold(np, dev, rng, entry: str, shape, variant: str):
    """(kernel, twin, input, work) of kernel T at one (entry, shape,
    variant) of a path's launches. A forward four-step whose variant has
    ``pre`` is the kind-7 LDE: it is held with the path's own offset^i
    pre-table (``power_table(coset_offset(q), n0)``)."""
    from lambda_snark_tpu_torch.ops import modarith
    from lambda_snark_tpu_torch.ops.ntt import NttPlan, ntt_forward, ntt_inverse
    from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
    from lambda_snark_tpu_torch.ops.ntt_large import (
        NttLargePlan,
        ntt_forward_large,
        ntt_forward_large_plain,
        power_table,
    )
    from lambda_snark_tpu_torch.proof.fri import coset_offset, root_of_order

    direction, _mod, q, *tables = variant.split()
    q, (rows, size) = int(q), shape
    inverse = direction == "inverse"
    field = "goldilocks" if q == modarith.GOLDILOCKS else "barrett"
    x = modarith.to_words(rng.integers(0, q, size=shape, dtype=np.uint64), dev)
    if tables == ["pre"] and entry == "ntt_four_step" and not inverse:
        plan = NttLargePlan.create(size, root_of_order(q, size), device=dev)
        pre = power_table(coset_offset(q), size, q, dev)
        return (lambda v: ntt_forward_large(plan, v, pre=pre),
                lambda v: ntt_forward_large_plain(plan, v, pre=pre), x,
                ntt_work(rows, size, True, field, tables=1))
    if tables:
        raise RuntimeError(f"kernel T {entry} {variant}: no holder for these tables")
    plan = NttPlan.create(size, q, root_of_order(q, size), device=dev)
    return (lambda v: (ntt_inverse_batched if inverse else ntt_forward_batched)(plan, v),
            lambda v: (ntt_inverse if inverse else ntt_forward)(plan, v), x,
            ntt_work(rows, size, entry == "ntt_four_step", field, inverse))


def ntt_name(variant: str) -> str:
    """A kernel-line name's suffix for a transform variant: its direction,
    its tables (``forward_pre``) and, off Goldilocks, its field
    (``inverse_q45`` for the 44-bit field 2^44 - 16982015)."""
    direction, _mod, q, *tables = variant.split()
    field = {"18446744069414584321": [], "17592169062401": ["q45"]}.get(q, [f"mod{q}"])
    return "_".join([direction] + tables + field)


def forest_work(trees: int, groups: int, n: int):
    """Bytes and ops of whole Merkle forests over (trees, groups, n) words:
    every word read once, 2 (n/2) - 1 digests of 32 bytes written and
    hashed per tree."""
    hashes = trees * (n - 1)
    return trees * groups * n * 8 + 32 * hashes, hashes * OPS_KECCAK


FOREST_ENTRIES = ("keccak_group_forest", "keccak_forest")
KECCAK_SRC = "lambda_snark_tpu/ops/keccak_pallas.py:242"
# kernels S and F (csrc/fri.cu): the counterparts of XLA device functions of
# the JAX chain, not of Pallas kernels
SPONGE_ENTRIES = ("transcript_absorb", "transcript_squeeze", "transcript_final_queries")
FOLD_ENTRIES = ("fri_fold", "fri_fold_squeeze")
CHAIN_ENTRIES = SPONGE_ENTRIES + FOLD_ENTRIES
SPONGE_SRC = "lambda_snark_tpu/proof/fri_device.py:678 (_sha3_bytes_dev, DevTranscript :736)"
FOLD_SRC = "lambda_snark_tpu/proof/fri_device.py:203 (_fold_fn; the fold of _chain_fn :782)"
# A Keccak-f's critical path on one statement's chain: 24 rounds of about 7
# dependent instructions (two LOP3 levels for theta's column parity, the
# 1-bit rotate and xor of D, rho's xor and rotate, chi as one LOP3 with iota)
# at about 4 cycles each and 1.98 GHz (the H100 SXM's boost clock)
KECCAK_LATENCY_MS = 24 * 7 * 4 / 1.98e9 * 1e3


def sponge_blocks(label_len: int, words: int) -> int:
    """SHA3-256 rate blocks of state || label || words LE64 words."""
    return (32 + label_len + 8 * words) // 136 + 1


def sponge_perms(entry: str, shape, variant: str) -> int:
    """Keccak-f permutations a statement chains in one launch of kernels S
    or F at a recorded (entry, shape, variant): one per rate block."""
    _s, width = shape
    label_len = len(variant.split()[0]) if variant else 0
    if entry == "transcript_absorb":
        return sponge_blocks(label_len, width + int(variant.endswith(" head")))
    if entry == "transcript_squeeze":
        return width * sponge_blocks(label_len, 1)
    if entry == "transcript_final_queries":  # "fri-final fri-query <count> mask <m>"
        return sponge_blocks(label_len, width + 1) + int(variant.split()[2])
    if entry == "fri_fold_squeeze":  # a root absorb (one block) and the squeeze
        return 1 + int(variant == "root")
    return 0


def sponge_work(entry: str, shape, variant: str):
    """Bytes and ops of one kernel S launch at a recorded (entry, shape,
    variant): every state read and written once, the payload read and the
    outputs written; one Keccak-f per rate block of each statement."""
    s, width = shape
    outs = width if entry == "transcript_squeeze" else \
        int(variant.split()[2]) if entry == "transcript_final_queries" else 0
    payload = 0 if entry == "transcript_squeeze" else width
    return s * (64 + 8 * payload + 8 * outs), s * sponge_perms(entry, shape, variant) * OPS_KECCAK


def latency_ms(entry: str, shape, variant: str) -> float:
    """The least time of a launch of kernel S or F bound by its chain of
    permutations: each statement's Keccak-fs one after another."""
    return sponge_perms(entry, shape, variant) * KECCAK_LATENCY_MS


def fold_work(rows: int, n: int, entry: str = "fri_fold", variant: str = ""):
    """Bytes and ops of one kernel F launch over (rows, n) words: the
    codewords, the n/2-word table and the challenges (or the states and
    roots) read once, the (rows, n/2) output (and the states) written;
    three products and three sums a word, and the chain entry's
    permutations."""
    half = rows * (n // 2)
    perms = sponge_perms(entry, (rows, n), variant)
    extra = rows * (8 if entry == "fri_fold" else 64 + 32 * int(variant == "root"))
    return ((rows * n + half + n // 2) * 8 + extra,
            half * (3 * OPS_MUL["goldilocks"] + 3 * OPS_ADD) + rows * perms * OPS_KECCAK)


def chain_hold(np, dev, rng, entry: str, shape, variant: str):
    """(kernel, twin, inputs, work) of kernel S or F at one recorded
    (entry, shape, variant)."""
    from lambda_snark_tpu_torch.ops import fri_fold, keccak, modarith

    gl = modarith.GOLDILOCKS
    words = lambda shp, high=1 << 64: modarith.to_words(
        rng.integers(0, high, size=shp, dtype=np.uint64, endpoint=False), dev)
    if entry == "fri_fold":
        rows, n = shape
        return (fri_fold.fold, fri_fold.fold_plain,
                (words(shape, gl), words((n // 2,), gl), words((rows,), gl)),
                fold_work(rows, n))
    if entry == "fri_fold_squeeze":  # variant "root" from the second layer on
        rows, n = shape
        args = (words(shape, gl), words((n // 2,), gl), words((rows, 4)))
        if variant == "root":
            args += (words((rows, 4)),)
        return (lambda *a: fri_fold.fold_squeeze(*a[:3], 7, *a[3:]),
                lambda *a: fri_fold.fold_squeeze_plain(*a[:3], 7, *a[3:]), args,
                fold_work(rows, n, entry, variant))
    s, width = shape
    label, *rest = variant.split()
    label = label.encode()
    state = words((s, 4))
    if entry == "transcript_final_queries":  # "fri-final fri-query <count> mask <m>"
        query, count, mask = rest[0].encode(), int(rest[1]), int(rest[3])
        return (lambda st, fin: keccak.transcript_final_queries(st, label, fin, width, query, 7,
                                                                count, mask + 1),
                lambda st, fin: keccak.transcript_final_queries_plain(st, label, fin, width,
                                                                      query, 7, count, mask),
                (state, words(shape, gl)), sponge_work(entry, shape, variant))
    if entry == "transcript_absorb":
        head = width if rest == ["head"] else None
        return (lambda st, pl: keccak.transcript_absorb(st, label, pl, head),
                lambda st, pl: keccak.transcript_absorb_plain(st, label, pl, head),
                (state, words(shape)), sponge_work(entry, shape, variant))
    mask = None if rest == ["field"] else int(rest[1])
    return (lambda st: keccak.transcript_squeeze(st, label, 7, width, mask),
            lambda st: keccak.transcript_squeeze_plain(st, label, 7, width, mask),
            (state,), sponge_work(entry, shape, variant))


def forest_inputs(np, modarith, dev, rng, entry: str, shape):
    """Random words of a forest launch's recorded input shape (T, G, n),
    with the wrapper and its twin (the paired entry takes (T, n))."""
    from lambda_snark_tpu_torch.ops import keccak

    x = modarith.to_words(rng.integers(0, 1 << 64, size=shape, dtype=np.uint64,
                                       endpoint=False), dev)
    if entry == "keccak_forest":
        return (x[:, 0].contiguous(), lambda v: tuple(keccak.merkle_forest(v)),
                lambda v: tuple(keccak.merkle_forest_plain(v)),
                lambda v: keccak.merkle_levels(keccak.hash_leaves(v)))
    return (x, lambda v: tuple(keccak.merkle_forest_flex(v)),
            lambda v: tuple(keccak.merkle_forest_flex_plain(v)),
            lambda v: keccak.merkle_levels(keccak.hash_leaves_flex(v)))


def hold_forests(np, torch, dev, rng, hold, shapes, tag: str) -> list:
    """Kernel K's forest entries at every (entry, shape) of a kind-7 run's
    ``shapes`` (``kernels.LAUNCHES``) against their twin; ``kernels`` line
    entries with the run's launches at each shape."""
    from lambda_snark_tpu_torch.ops import modarith

    out = []
    for (entry, shape, _), launches in sorted(shapes.items()):
        if entry not in FOREST_ENTRIES:
            continue
        x, fn, plain, _ = forest_inputs(np, modarith, dev, rng, entry, shape)
        rec = hold(f"{tag} {entry} {'x'.join(map(str, shape))}", fn, plain, (x,),
                   forest_work(*shape), plain_reps=1)
        out.append(dict(name=f"{entry}_{tag.replace(' ', '_')}_{'x'.join(map(str, shape))}",
                        route="cuda", source="lambda_snark_tpu_torch/csrc/keccak.cu",
                        replaces=KECCAK_SRC, launches=launches, **rec, library_ms=None))
    return out


def forest_times(np, torch, dev, rng, shapes, tag: str) -> list:
    """Host-clock time from leaves to roots on the host (the wait of a FRI
    layer) of the largest and the smallest forest of a kind-7 run: one
    forest launch against the per-level route (``hash_leaves`` and one
    ``hash_nodes`` launch per level), alternated, median of
    FOREST_TIME_REPS each after a warm-up."""
    from lambda_snark_tpu_torch.ops import modarith

    forests = sorted({(entry, shape) for (entry, shape, _) in shapes if entry in FOREST_ENTRIES},
                     key=lambda es: (es[1][0] * es[1][1] * es[1][2], es[0]))
    records = []
    for entry, shape in (forests[-1], forests[0]):
        x, fn, _, per_level = forest_inputs(np, modarith, dev, rng, entry, shape)
        routes = {"forest": fn, "per_level": per_level}
        roots = {k: modarith.to_u64(f(x)[-1]) for k, f in routes.items()}
        if not np.array_equal(roots["forest"], roots["per_level"]):
            raise RuntimeError(f"{tag}: the forest entry and the per-level route disagree")
        times = {k: [] for k in routes}
        for _ in range(FOREST_TIME_REPS):
            for k, f in routes.items():
                torch.cuda.synchronize()
                t = time.perf_counter()
                modarith.to_u64(f(x)[-1])  # the roots on the host
                times[k].append((time.perf_counter() - t) * 1e3)
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        records.append(dict(path=tag, entry=entry, shape=list(shape),
                            forest_ms=med["forest"], per_level_ms=med["per_level"]))
        phase(f"{tag} forest {entry} {'x'.join(map(str, shape))}: leaves to roots on the host "
              f"{med['forest']:.4f} ms in one launch, {med['per_level']:.4f} ms per level "
              f"(median of {FOREST_TIME_REPS})")
    return records


def cluster_of(kernels, rows: int, m: int, buffers: int) -> int:
    """Blocks per row kernel Q (three buffers of m words a row) or R (two)
    takes at (rows, m)."""
    return kernels.cluster_size(rows, m, buffers * m)


def elementwise_work(read_bytes: int, write_bytes: int, muls: int, adds: int):
    return read_bytes + write_bytes, muls * OPS_MUL["goldilocks"] + adds * OPS_ADD


def device_busy(torch, fn, trace_path: str):
    """Profile one call of ``fn`` with torch.profiler: (wall s, device-busy
    s, the six kernels with the most device time as (name, ms)). Busy time
    is the union of the kernel, memcpy and memset spans of the exported
    trace; it is None when the trace holds no device activity."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
              and "dur" in e]
    busy, end = 0.0, None
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in device):
        if end is None or start > end:
            busy, end = busy + stop - start, stop
        elif stop > end:
            busy, end = busy + stop - end, stop
    per_kernel = {}
    for e in device:
        if e["cat"] == "kernel":
            per_kernel[e["name"]] = per_kernel.get(e["name"], 0.0) + e["dur"]
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return wall, (busy / 1e6 if device else None), [(k[:80], v / 1e3) for k, v in top]


def kind7_circuit(lst, m: int):
    """m squaring gates x_i * x_i = y_i over Goldilocks (the JAX package's
    kind-7 bench circuit); witness [1, x_1..m, y_1..m]."""
    from lambda_snark_tpu_torch.r1cs.circuit import CircuitBuilder

    builder = CircuitBuilder(lst.NTT_MODULUS)
    builder.alloc_var()
    xs = builder.alloc_vars(m)
    ys = builder.alloc_vars(m)
    builder.set_public_inputs(1)
    for x, y in zip(xs, ys):
        builder.mul_gate(x, x, y)
    return builder.build()


def tamper_fri_path(proof):
    """``proof`` with one byte flipped in its first query's first path."""
    import dataclasses

    q0 = proof.fri.queries[0]
    field_name = "layer_openings" if q0.layer_openings else "input_openings"
    ops = getattr(q0, field_name)
    bad_op = dataclasses.replace(ops[0], path=bytes([ops[0].path[0] ^ 1]) + ops[0].path[1:])
    bad_q = dataclasses.replace(q0, **{field_name: (bad_op,) + ops[1:]})
    return dataclasses.replace(proof, fri=dataclasses.replace(
        proof.fri, queries=(bad_q,) + proof.fri.queries[1:]))


def reject_tampered(proof, r1cs, q: int, label: str) -> None:
    """A kind-7 proof with a flipped byte in a FRI path, and one with a
    flipped ``q_alpha``, must not verify."""
    import dataclasses

    from lambda_snark_tpu_torch.proof.succinct import verify_r1cs_succinct

    tampered = [tamper_fri_path(proof),
                dataclasses.replace(proof, q_alpha=(proof.q_alpha + 1) % q)]
    if any(verify_r1cs_succinct(p, [1], r1cs) for p in tampered):
        raise RuntimeError(f"{label}: a tampered proof verified")


def kind7_phases(np, torch, lst, dev, rng, hold, report):
    """Phases 8-12: kernels K and N, kernels Q and R at the kind-7 shapes,
    and ``prove_r1cs_succinct_batch`` on the card. Returns (kind-7 path
    launches, its launches per (entry, shape, variant), the kind-7
    end-to-end record)."""
    import hashlib
    import struct

    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.commit.lwe_device import DeviceCommitContext
    from lambda_snark_tpu_torch.ops import keccak, modarith
    from lambda_snark_tpu_torch.ops.ntt import NttPlan, ntt_forward
    from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched
    from lambda_snark_tpu_torch.ops.ntt_large import (
        NttLargePlan,
        ntt_forward_large,
        ntt_forward_large_plain,
        power_table,
    )
    from lambda_snark_tpu_torch.ops.quotient import QuotientPlan, quotient, quotient_plain
    from lambda_snark_tpu_torch.ops.ring_commit import ring_commit, ring_commit_plain
    from lambda_snark_tpu_torch.pipeline import field_psi_for
    from lambda_snark_tpu_torch.proof import fri_device
    from lambda_snark_tpu_torch.proof import succinct_batch as sb
    from lambda_snark_tpu_torch.proof.fri import FriParams, coset_offset, root_of_order
    from lambda_snark_tpu_torch.proof.succinct import SuccinctProofR1CS, verify_r1cs_succinct
    from lambda_snark_tpu_torch.proof.succinct_device import eval_device, quotient_lde_device

    gl = lst.NTT_MODULUS
    m, s = KIND7_M, KIND7_S
    n0 = 8 * m  # default FriParams: log_blowup 3

    def words(shape, high=None):
        vals = rng.integers(0, high or (1 << 64) - 1, size=shape, dtype=np.uint64,
                            endpoint=high is None)
        return modarith.to_words(vals, dev)

    # --- phase 8: kernel K ------------------------------------------------------
    vals = words((s, 4, n0))
    report["keccak_group_leaves"] = hold(
        f"phase 8 kernel K group leaves G=4 {s}x{n0 // 2}", keccak.hash_leaves_flex,
        keccak.hash_leaves_flex_plain, (vals,), keccak_work(s * n0 // 2, vals.numel() * 8))
    pairs = words((s, n0 // 2))
    report["keccak_leaves"] = hold(
        f"phase 8 kernel K paired leaves {s}x{n0 // 4}", keccak.hash_leaves,
        keccak.hash_leaves_plain, (pairs,), keccak_work(s * n0 // 4, pairs.numel() * 8))
    level = words((s, n0 // 2, 4))
    report["keccak_nodes"] = hold(
        f"phase 8 kernel K nodes {s}x{n0 // 4}", keccak.hash_nodes, keccak.hash_nodes_plain,
        (level,), keccak_work(s * n0 // 4, level.numel() * 8))
    v_host = modarith.to_u64(vals)
    leaf_dig = modarith.to_u64(keccak.hash_leaves_flex(vals)).view(np.uint8)
    lvl_host = modarith.to_u64(level).view(np.uint8)
    node_dig = modarith.to_u64(keccak.hash_nodes(level)).view(np.uint8)
    for _ in range(128):
        t, i = int(rng.integers(s)), int(rng.integers(n0 // 2))
        msg = b"\x00" + b"".join(struct.pack("<QQ", int(v_host[t, g, i]),
                                             int(v_host[t, g, i + n0 // 2])) for g in range(4))
        j = int(rng.integers(n0 // 4))
        node = b"\x01" + lvl_host[t, 2 * j].tobytes() + lvl_host[t, 2 * j + 1].tobytes()
        if (leaf_dig[t, i].tobytes() != hashlib.sha3_256(msg).digest()
                or node_dig[t, j].tobytes() != hashlib.sha3_256(node).digest()):
            raise RuntimeError("kernel K disagrees with hashlib.sha3_256")
    phase("phase 8 kernel K: 256 sampled digests equal hashlib.sha3_256")

    # --- phase 9: kernel N ------------------------------------------------------
    # the LDE (4 S x n0) with its offset^i pre-table, as the path runs it
    for key_, rows, size, pre in (
            ("ntt_goldilocks", 4 * s, n0, power_table(coset_offset(gl), n0, gl, dev)),
            ("ntt_goldilocks_2pow20", 1, 1 << 20, None)):
        plan = NttLargePlan.create(size, root_of_order(gl, size), device=dev)
        x = words((rows, size), gl)
        report[key_] = hold(
            f"phase 9 kernel N {rows}x{size}{'' if pre is None else ' pre-table'}",
            lambda v, plan=plan, pre=pre: ntt_forward_large(plan, v, pre=pre),
            lambda v, plan=plan, pre=pre: ntt_forward_large_plain(plan, v, pre=pre), (x,),
            ntt_work(rows, size, True, tables=int(pre is not None)))
    # the leaf at B = 128 (the TPU leaf's radix), and at the kind-7 path's
    # shape: FRI's final polynomials, S rows of final_len << log_blowup
    # points with the inverse root
    final_n = FriParams().final_len << FriParams().log_blowup
    for key_, b, rows, omega in (
            ("ntt_goldilocks_leaf", 128, 4 * s * n0 // 128, root_of_order(gl, 128)),
            ("ntt_goldilocks_leaf_kind7", final_n, s,
             pow(root_of_order(gl, final_n), gl - 2, gl))):
        leaf = NttPlan.create(b, gl, omega, device=dev)
        x = words((rows, b), gl)
        report[key_] = hold(
            f"phase 9 kernel N leaf B={b} x {rows} rows",
            lambda v, leaf=leaf: ntt_forward_batched(leaf, v),
            lambda v, leaf=leaf: ntt_forward(leaf, v), (x,), ntt_work(rows, b, False))

    # --- phase 10: kernels Q and R at the kind-7 shapes ---------------------------
    qplan = QuotientPlan.create(m, gl, field_psi_for(m, gl), device=dev)
    a, b = words((s, m), gl), words((s, m), gl)
    c = modarith.mul_mod(a, b, gl)
    report["quotient_goldilocks_kind7"] = hold(
        f"phase 10 kernel Q goldilocks m={m} rows={s} cluster={cluster_of(kernels, s, m, 3)}",
        lambda *v: quotient(qplan, *v), lambda *v: quotient_plain(qplan, *v), (a, b, c),
        quotient_work(s, m, "goldilocks"))
    report["quotient_goldilocks_kind7"]["cluster"] = cluster_of(kernels, s, m, 3)
    ctx7 = kind7_context(lst, m)
    ring7 = DeviceCommitContext.from_host(ctx7, dev).ring
    s_draws = torch.from_numpy(rng.integers(-39, 40, size=(1, s, m), dtype=np.int32)).to(dev)
    e_draws = torch.from_numpy(rng.integers(-39, 40, size=(s, m), dtype=np.int32)).to(dev)
    msg = words((s, m), gl)
    report["ring_commit_kind7"] = hold(
        f"phase 10 kernel R n={m} k=1 rows={s} msg_len={m} "
        f"cluster={cluster_of(kernels, s, m, 2)}",
        lambda *v: ring_commit(ring7, *v), lambda *v: ring_commit_plain(ring7, *v),
        (s_draws, e_draws, msg), ring_work(s, m, 1, m))
    report["ring_commit_kind7"]["cluster"] = cluster_of(kernels, s, m, 2)

    # --- phase 11: prove_r1cs_succinct_batch on the card -------------------------
    r1cs7 = kind7_circuit(lst, m)
    wits = kind7_witnesses(np, lst, dev, rng, s, m)
    seeds = [7] + list(range(100, 100 + s - 1))
    params = FriParams()
    lst.prove_r1cs_succinct_batch(r1cs7, wits, ctx7, seeds)  # warm-up
    cpu = lst.prove_r1cs_succinct_batch(r1cs7, wits[:KIND7_CHECK], ctx7, seeds[:KIND7_CHECK],
                                        device="cpu")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    proofs = lst.prove_r1cs_succinct_batch(r1cs7, wits, ctx7, seeds)
    elapsed = time.time() - t
    launches = kernels.launches()
    shapes = dict(kernels.LAUNCHES)
    check_kind7_launches(launches, "kind 7")
    if sum(launches[e] for e in FOREST_ENTRIES) != KIND7_FORESTS:
        raise RuntimeError(f"kind 7: not one forest launch per Merkle forest: {launches}")
    if len(proofs) != s or not all(verify_r1cs_succinct(p, [1], r1cs7) for p in proofs):
        raise RuntimeError("kind 7: a proof from the card does not verify")
    for i in range(KIND7_CHECK):
        if proofs[i].to_bytes() != cpu[i].to_bytes():
            raise RuntimeError(f"kind 7: proof {i} differs from the CPU run")
    p0 = proofs[0]
    reject_tampered(p0, r1cs7, gl, "kind 7")
    times = [elapsed]
    for _ in range(KIND7_REPS - 1):
        torch.cuda.synchronize()
        t = time.time()
        lst.prove_r1cs_succinct_batch(r1cs7, wits, ctx7, seeds)
        times.append(time.time() - t)
    elapsed = sorted(times)[len(times) // 2]
    phase(f"phase 11 prove_r1cs_succinct_batch m={m} S={s} n0={n0}: {s} proofs verify, "
          f"first {KIND7_CHECK} byte-identical to the CPU run, a flipped path byte and "
          f"a flipped q_alpha rejected; launches {nonzero(launches)}; end to end "
          f"{[round(x, 4) for x in times]} s, median {elapsed:.4f} s "
          f"({s / elapsed:.2f} proofs/s), {len(p0.to_bytes())} bytes per proof")

    # --- phase 12: host-clock breakdown of kind-7 batches ------------------------
    def staged():
        """One batch through the entry point's stages, timed part by part."""
        parts = {}
        torch.cuda.synchronize()
        t = time.time()
        d_bound, n0_, omega_n = sb._check_instance(r1cs7, params, 0)
        offset = sb.coset_offset(gl)
        az, bz, cz = sb._embed_and_eval(r1cs7, wits, dev)
        lde, comms, polys, forest = quotient_lde_device(az, bz, cz, n0_, offset, ctx7, seeds)
        torch.cuda.synchronize()
        parts["frontend_on_card_s"] = time.time() - t
        t = time.time()
        chals, alphas, betas = sb._derive_batch_challenges(r1cs7, wits, comms, forest.roots, gl)
        evals = eval_device(polys, alphas, betas)
        trs, lams = sb._seed_batch_transcripts(gl, m, 0, params, d_bound, forest.roots,
                                               alphas, betas, evals)
        parts["challenges_and_transcripts_s"] = time.time() - t
        t = time.time()
        g = fri_device.deep_combine_device(lde, alphas, betas, lams, evals, offset, omega_n)
        bundle, layout = fri_device.fri_chain_dispatch(g, [(lde, forest)], offset, omega_n, gl,
                                                       params, trs)
        torch.cuda.synchronize()
        parts["deep_and_fri_on_card_s"] = time.time() - t
        t = time.time()
        fri_proofs = fri_device.fri_chain_finish(bundle, layout)
        again = [SuccinctProofR1CS(
            comms[i], forest.roots[i], *chals[i], *(int(v) for v in evals[i]),
            fri=fri_proofs[i], m=m, mask_len=0, log_blowup=params.log_blowup,
            num_queries=params.num_queries, final_len=params.final_len, modulus=gl)
            for i in range(s)]
        parts["fri_pull_and_assembly_s"] = time.time() - t
        if [p.to_bytes() for p in again] != [p.to_bytes() for p in proofs]:
            raise RuntimeError("kind 7: the staged run differs from the entry point's proofs")
        return parts

    runs = [staged() for _ in range(KIND7_REPS)]
    parts = {key: sorted(r[key] for r in runs)[len(runs) // 2] for key in runs[0]}
    total = sum(parts.values())
    phase(f"phase 12 kind-7 host-clock breakdown, median of {KIND7_REPS} batches "
          f"({total:.3f} s): {parts}")
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "kind7_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    wall, busy, top = device_busy(
        torch, lambda: lst.prove_r1cs_succinct_batch(r1cs7, wits, ctx7, seeds), trace)
    idle = None if busy is None else 1.0 - busy / wall
    phase(f"phase 12 kind-7 profiled batch: {wall:.4f} s wall, device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} s, idle share {idle:.3f}'}; "
          f"most device time: {[(k, round(v, 3)) for k, v in top]}")
    return launches, shapes, dict(m=m, statements=s, n0=n0, end_to_end_s=times,
                          end_to_end_median_s=elapsed, proofs_per_s=s / elapsed,
                          breakdown_median_s=parts, proof_bytes=len(p0.to_bytes()),
                          profiled_wall_s=wall, device_busy_s=busy, device_idle_share=idle,
                          top_kernels_ms=top)


def kernel_t_phases(np, torch, lst, dev, rng, hold, report):
    """Phases 13-14: kernel T against ``ops.ntt`` (rows and four-step, both
    directions, three fields), then kernels Q and R at m = n = 2^14 x 16
    rows, by their long routes (each elementwise entry against its twin)
    and in one launch, and in one launch at 2^16."""
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.commit.lwe import goldilocks_ring_plan
    from lambda_snark_tpu_torch.core.params import HEALTHCARE_DUMP_MODULUS
    from lambda_snark_tpu_torch.ops import modarith
    from lambda_snark_tpu_torch.ops import quotient as qmod
    from lambda_snark_tpu_torch.ops import ring_commit as rmod
    from lambda_snark_tpu_torch.ops.ntt import NttPlan, ntt_forward, ntt_inverse
    from lambda_snark_tpu_torch.ops.ntt_batched import ntt_forward_batched, ntt_inverse_batched
    from lambda_snark_tpu_torch.ops.ntt_large import (
        NttLargePlan,
        ntt_forward_large,
        ntt_forward_large_plain,
        ntt_inverse_large,
        ntt_inverse_large_plain,
    )
    from lambda_snark_tpu_torch.pipeline import field_psi_for
    from lambda_snark_tpu_torch.proof.fri import root_of_order

    gl, q45, bq = lst.NTT_MODULUS, lst.NTT_FRIENDLY_MODULUS, HEALTHCARE_DUMP_MODULUS
    names = {gl: "goldilocks", q45: "q45", bq: "barrett"}

    def words(shape, q):
        return modarith.to_words(rng.integers(0, q, size=shape, dtype=np.uint64), dev)

    # --- phase 13: kernel T ----------------------------------------------------
    # rows: both fields at 2^13 x 256 and 256 x 64, Barrett at 2^13 x 16;
    # four-step: 16 x 2^14 and 48 x 2^14 (the long routes of the m = 2^14
    # kind-7 path), 16 x 2^17 and 64 x 2^17 (its LDE), 1 x 2^21, Barrett
    for q, rows, size in ((q45, 256, 1 << 13), (q45, 64, 256), (gl, 256, 1 << 13),
                          (gl, 64, 256), (bq, 16, 1 << 13), (gl, 16, 1 << 14),
                          (gl, 48, 1 << 14), (gl, 16, 1 << 17), (gl, 64, 1 << 17),
                          (gl, 1, 1 << 21), (bq, 16, 1 << 14)):
        plan = NttPlan.create(size, q, root_of_order(q, size), device=dev)
        x = words((rows, size), q)
        four = size > 1 << 13
        for inverse, fn, plain in ((False, ntt_forward_batched, ntt_forward),
                                   (True, ntt_inverse_batched, ntt_inverse)):
            key_ = (f"ntt_{'four_step' if four else 'rows'}_{names[q]}_{rows}x{size}_"
                    f"{'inverse' if inverse else 'forward'}")
            report[key_] = dict(entry="ntt_four_step" if four else "ntt_rows",
                                shape=(rows, size),
                                variant=f"{'inverse' if inverse else 'forward'} mod {q}")
            report[key_].update(hold(
                f"phase 13 kernel T {'inverse' if inverse else 'forward'} {names[q]} "
                f"{rows}x{size}", lambda v, plan=plan, fn=fn: fn(plan, v),
                lambda v, plan=plan, plain=plain: plain(plan, v), (x,),
                ntt_work(rows, size, four, names[q], inverse)))

    # --- phase 13, continued: three passes, 1 x 2^27 --------------------------
    # Peak reckoned before the run: the plan's two 1 GiB store-order tables
    # (and 2 x 2 MiB for its inner four-step), x, the kernel's scratch and
    # output (1 GiB each), and the twin's three buffers, index tensors and
    # 16-bit-digit products (about 30 GiB at its widest): 35-45 GiB.
    m = 1 << NTT_DEEP_LOG_M
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    large = NttLargePlan.create(m, root_of_order(gl, m), device=dev)
    if large.n_passes != 3:
        raise RuntimeError(f"the 2^{NTT_DEEP_LOG_M}-point plan has {large.n_passes} passes, not 3")
    x = words((1, m), gl)
    for inverse, fn, plain in ((False, ntt_forward_large, ntt_forward_large_plain),
                               (True, ntt_inverse_large, ntt_inverse_large_plain)):
        key_ = f"ntt_four_step_goldilocks_1x{m}_{'inverse' if inverse else 'forward'}"
        report[key_] = dict(entry="ntt_four_step", shape=(1, m),
                            variant=f"{'inverse' if inverse else 'forward'} mod {gl}")
        report[key_].update(hold(
            f"phase 13 kernel T three-pass four-step {'inverse' if inverse else 'forward'} "
            f"goldilocks 1x2^{NTT_DEEP_LOG_M}", lambda v, fn=fn: fn(large, v),
            lambda v, plain=plain: plain(large, v), (x,),
            ntt_work(1, m, True, "goldilocks", inverse), plain_reps=1))
    peak = torch.cuda.max_memory_allocated()
    del large, x
    torch.cuda.empty_cache()
    phase(f"phase 13 three-pass four-step at 1x2^{NTT_DEEP_LOG_M}: peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (torch.cuda.max_memory_allocated)")

    # --- phase 14: kernels Q and R at m = n = 2^14 and 2^16 ----------------------
    # the long routes, called directly at 16 x 2^14, with each elementwise
    # entry against its twin; then the one-launch kernels at 16 x 2^14 (the
    # m = 2^14 kind-7 shapes) and 16 x 2^16, each launched once a call
    m, s = KIND7_LONG_M, KIND7_S
    qplan = qmod.QuotientPlan.create(m, gl, field_psi_for(m, gl), device=dev)
    a, b = words((s, m), gl), words((s, m), gl)
    c = modarith.mul_mod(a, b, gl)
    c[1, 5] = modarith.add_mod(c[1:2, 5:6], torch.ones_like(c[1:2, 5:6]), gl)[0, 0]
    if qmod.quotient_long(qplan, a, b, c)[4].tolist() != [i != 1 for i in range(s)]:
        raise RuntimeError("kernel Q long route: validity flags wrong")
    report["quotient_long"] = hold(
        f"phase 14 kernel Q long route goldilocks m={m} rows={s}",
        lambda *v: qmod.quotient_long(qplan, *v), lambda *v: qmod.quotient_plain(qplan, *v),
        (a, b, c), quotient_work(s, m, "goldilocks"))
    odd = [ntt_forward_large(qplan.ntt.large, p, pre=qplan.ntt.psi_pows)
           for p in (a, b, c)]  # stand-ins for the odd-coset evaluations
    report["quotient_pointwise"] = hold(
        f"phase 14 kernel Q pointwise m={m} rows={s}",
        lambda *v: qmod.quotient_pointwise(gl, *v),
        lambda *v: qmod.quotient_pointwise_plain(gl, *v), (*odd, a, b, c),
        elementwise_work(6 * s * m * 8, s * m * 8 + s * 4, 2 * s * m, 2 * s * m))
    ctx7 = kind7_context(lst, m)
    ring = rmod.RingCommitPlan.create(ctx7.a_hat, goldilocks_ring_plan(m, dev))
    s_draws = torch.from_numpy(rng.integers(-39, 40, size=(1, s, m), dtype=np.int32)).to(dev)
    e_draws = torch.from_numpy(rng.integers(-39, 40, size=(s, m), dtype=np.int32)).to(dev)
    msg = words((s, m), gl)
    report["ring_commit_long"] = hold(
        f"phase 14 kernel R long route n={m} k=1 rows={s} msg_len={m}",
        lambda *v: rmod.ring_commit_long(ring, *v), lambda *v: rmod.ring_commit_plain(ring, *v),
        (s_draws, e_draws, msg), ring_work(s, m, 1, m))
    report["ring_twist"] = hold(
        f"phase 14 kernel R twist n={m} rows={s}", lambda v: rmod.ring_twist(ring, v),
        lambda v: rmod.ring_twist_plain(ring, v), (s_draws,),
        elementwise_work(s * m * 4 + m * 8, s * m * 8, s * m, s * m))
    s_hat = words((1, s, m), gl)
    report["ring_accumulate"] = hold(
        f"phase 14 kernel R accumulate n={m} k=1 rows={s}",
        lambda v: rmod.ring_accumulate(ring, v), lambda v: rmod.ring_accumulate_plain(ring, v),
        (s_hat,), elementwise_work(s * m * 8 + m * 8, s * m * 8, s * m, 0))
    x = words((s, m), gl)
    report["ring_finish"] = hold(
        f"phase 14 kernel R finish n={m} rows={s} msg_len={m}",
        lambda *v: rmod.ring_finish(ring, *v), lambda *v: rmod.ring_finish_plain(ring, *v),
        (x, e_draws, msg), elementwise_work(2 * s * m * 8 + s * m * 4, s * m * 8, 0, 3 * s * m))

    for size in (m, ONE_LAUNCH_M):
        tag = "kind7_2pow14" if size == m else "2pow16"
        qp = qplan if size == m else qmod.QuotientPlan.create(size, gl, field_psi_for(size, gl),
                                                              device=dev)
        rp = ring if size == m else rmod.RingCommitPlan.create(
            rng.integers(0, gl, size=(1, size), dtype=np.uint64), goldilocks_ring_plan(size, dev))
        if size != m:
            a, b = words((s, size), gl), words((s, size), gl)
            c = modarith.mul_mod(a, b, gl)
            s_draws = torch.from_numpy(rng.integers(-39, 40, size=(1, s, size),
                                                    dtype=np.int32)).to(dev)
            e_draws = torch.from_numpy(rng.integers(-39, 40, size=(s, size),
                                                    dtype=np.int32)).to(dev)
            msg = words((s, size), gl)
        kernels.reset_launches()
        qmod.quotient(qp, a, b, c)
        rmod.ring_commit(rp, s_draws, e_draws, msg)
        counts = kernels.launches()
        if (counts["quotient_goldilocks"], counts["ring_commit_goldilocks"]) != (1, 1) \
                or sum(counts.values()) != 2:
            raise RuntimeError(f"m={size}: kernels Q and R not in one launch each: "
                               f"{nonzero(counts)}")
        report[f"quotient_goldilocks_{tag}"] = hold(
            f"phase 14 kernel Q one launch goldilocks m={size} rows={s} "
            f"cluster={cluster_of(kernels, s, size, 3)}",
            lambda *v, qp=qp: qmod.quotient(qp, *v), lambda *v, qp=qp: qmod.quotient_plain(qp, *v),
            (a, b, c), quotient_work(s, size, "goldilocks"), plain_reps=1)
        report[f"ring_commit_goldilocks_{tag}"] = hold(
            f"phase 14 kernel R one launch n={size} k=1 rows={s} msg_len={size} "
            f"cluster={cluster_of(kernels, s, size, 2)}",
            lambda *v, rp=rp: rmod.ring_commit(rp, *v),
            lambda *v, rp=rp: rmod.ring_commit_plain(rp, *v), (s_draws, e_draws, msg),
            ring_work(s, size, 1, size), plain_reps=1)
        report[f"quotient_goldilocks_{tag}"]["cluster"] = cluster_of(kernels, s, size, 3)
        report[f"ring_commit_goldilocks_{tag}"]["cluster"] = cluster_of(kernels, s, size, 2)
    for key_ in ("quotient_long", "quotient_pointwise", "ring_commit_long", "ring_twist",
                 "ring_accumulate", "ring_finish"):
        report[key_]["cluster"] = None  # the long routes: kernel T and elementwise entries


def kind7_long_phase(np, torch, lst, rng):
    """Phase 15: ``prove_r1cs_succinct_batch`` at m = 2^14, S = 16 on the card.
    Returns (the path's launches, its record)."""
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.proof.succinct import verify_r1cs_succinct

    m, s = KIND7_LONG_M, KIND7_S
    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    wits = kind7_witnesses(np, lst, torch.device("cuda"), rng, s, m)
    seeds = list(range(200, 200 + s))
    lst.prove_r1cs_succinct_batch(r1cs, wits, ctx, seeds)  # warm-up
    cpu = lst.prove_r1cs_succinct_batch(r1cs, wits[:KIND7_CHECK], ctx, seeds[:KIND7_CHECK],
                                        device="cpu")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    proofs = lst.prove_r1cs_succinct_batch(r1cs, wits, ctx, seeds)
    times = [time.time() - t]
    launches = kernels.launches()
    shapes = dict(kernels.LAUNCHES)
    check_kind7_launches(launches, f"kind 7 at m={m}")
    if any(launches[e] != n for e, n in KIND7_LONG_COUNTS.items()):
        raise RuntimeError(f"kind 7 at m={m}: launches {nonzero(launches)}, expected "
                           f"{KIND7_LONG_COUNTS}")
    if sum(launches[e] for e in FOREST_ENTRIES) != KIND7_LONG_FORESTS:
        raise RuntimeError(f"kind 7 at m={m}: not one forest launch per Merkle forest: "
                           f"{launches}")
    if len(proofs) != s or not all(verify_r1cs_succinct(p, [1], r1cs) for p in proofs):
        raise RuntimeError(f"kind 7 at m={m}: a proof from the card does not verify")
    for i in range(KIND7_CHECK):
        if proofs[i].to_bytes() != cpu[i].to_bytes():
            raise RuntimeError(f"kind 7 at m={m}: proof {i} differs from the CPU run")
    for _ in range(KIND7_REPS - 1):
        torch.cuda.synchronize()
        t = time.time()
        lst.prove_r1cs_succinct_batch(r1cs, wits, ctx, seeds)
        times.append(time.time() - t)
    median = sorted(times)[len(times) // 2]
    phase(f"phase 15 prove_r1cs_succinct_batch m={m} S={s}: {s} proofs verify, first "
          f"{KIND7_CHECK} byte-identical to the CPU run; launches {nonzero(launches)}; end "
          f"to end {[round(x, 4) for x in times]} s, median {median:.4f} s ({s / median:.2f} "
          f"proofs/s), {len(proofs[0].to_bytes())} bytes per proof")
    return launches, shapes, dict(m=m, statements=s, end_to_end_s=times,
                                  end_to_end_median_s=median, proofs_per_s=s / median,
                                  proof_bytes=len(proofs[0].to_bytes()))


def kind7_long_shapes_phase(np, torch, lst, dev, rng, hold, shapes, report):
    """Phase 15, continued: kernel K at every (entry, input shape) of the
    m = 2^14 kind-7 run's ``shapes`` (``kernels.LAUNCHES``), and kernel T
    at each (entry, shape, direction) of it that phase 13 did not hold,
    each against its twin on fresh random words of that shape. Returns
    ``kernels`` line entries with the run's launches at each shape."""
    from lambda_snark_tpu_torch.ops import modarith

    held_t = {(r["entry"], r["shape"], r["variant"]) for r in report.values() if "entry" in r}
    src = "lambda_snark_tpu_torch/csrc"
    out = []
    for (entry, shape, variant), launches in sorted(shapes.items()):
        label = f"phase 15 {entry} {'x'.join(map(str, shape))} {variant}".rstrip()
        if entry in FOREST_ENTRIES:  # (T, G, n) words; the paired entry takes (T, n)
            x, fn, plain, _ = forest_inputs(np, modarith, dev, rng, entry, shape)
            rec = hold(label, fn, plain, (x,), forest_work(*shape), plain_reps=1)
            replaces = KECCAK_SRC
            src_file = "keccak.cu"
        elif entry.startswith("ntt_") and (entry, shape, variant) not in held_t:
            fn, plain, x, work = ntt_hold(np, dev, rng, entry, shape, variant)
            rec = hold(label, fn, plain, (x,), work)
            replaces = "lambda_snark_tpu/ops/ntt_pallas.py:126"
            src_file = "ntt.cu"
        else:
            continue
        name = f"{entry}_kind7_2pow14_{'x'.join(map(str, shape))}"
        if variant:
            name += f"_{ntt_name(variant)}" if entry.startswith("ntt_") else ""
        out.append(dict(name=name, route="cuda", source=f"{src}/{src_file}", replaces=replaces,
                        launches=launches, **rec, library_ms=None))
    return out


def stream_phases(np, torch, lst, dev, rng, ctx, q):
    """Phases 16-17: ``prove_r1cs_stream`` (plain at m = n = 4096, ZK at
    m = 2048; batches of 256 and a partial tail) with deserialize_any,
    the verifiers and a ProofStore resume; then ``entry()``. Returns
    (launches per path, the stream record, (circuit, witnesses, proofs) of
    the plain stream, which phase 26 proves again)."""
    import shutil

    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.ops import modarith

    def witness_rows(count: int, m: int) -> list:
        wa = rng.integers(1, q, size=(count, m), dtype=np.uint64)
        wb = rng.integers(1, q, size=(count, m), dtype=np.uint64)
        wc = modarith.to_u64(modarith.mul_mod(modarith.to_words(wa, dev),
                                              modarith.to_words(wb, dev), q))
        return list(np.concatenate([np.ones((count, 1), np.uint64), wa, wb, wc], axis=1))

    launches, record = {}, {}
    for label, m, count, zk in (("stream", M_PLAIN, STREAM_COUNT, False),
                                ("stream_zk", M_ZK, STREAM_ZK_COUNT, True)):
        r1cs = lst.multiplication_gates_circuit(m, q)
        ws = witness_rows(count, m)
        check = lst.verify_r1cs_zk if zk else lst.verify_r1cs
        list(lst.prove_r1cs_stream(r1cs, iter(ws[:BATCH]), ctx, SEED, batch=BATCH, zk=zk))
        cpu = list(lst.prove_r1cs_stream(r1cs, iter(ws[:CHECK_ROWS]), ctx, SEED, batch=BATCH,
                                         zk=zk, device="cpu"))
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.time()
        proofs = list(lst.prove_r1cs_stream(r1cs, iter(ws), ctx, SEED, batch=BATCH, zk=zk))
        elapsed = time.time() - t
        launches[label] = kernels.launches()
        batches = -(-count // BATCH)
        if min(launches[label]["quotient_q45"], launches[label]["ring_commit_goldilocks"]) \
                != batches:
            raise RuntimeError(f"{label}: kernels Q and R not launched once per batch: "
                               f"{launches[label]}")
        if len(proofs) != count:
            raise RuntimeError(f"{label}: {len(proofs)} proofs for {count} witnesses")
        for i, (w, p) in enumerate(zip(ws, proofs)):
            if not check(lst.deserialize_any(p.to_bytes()), r1cs.public_inputs(w), r1cs):
                raise RuntimeError(f"{label}: proof {i} does not verify after deserialize_any")
        if [p.to_bytes() for p in proofs[:CHECK_ROWS]] != [p.to_bytes() for p in cpu]:
            raise RuntimeError(f"{label}: the first {CHECK_ROWS} proofs differ from the CPU run")
        record[label] = dict(m=m, proofs=count, batches=batches, end_to_end_s=elapsed,
                             proofs_per_s=count / elapsed)
        phase(f"phase 16 prove_r1cs_stream {label} m={m} n={RING_N} batch={BATCH}: {count} "
              f"proofs in {batches} batches, each through deserialize_any and "
              f"{check.__name__}, first {CHECK_ROWS} byte-identical to the CPU run; launches "
              f"{nonzero(launches[label])}; {elapsed:.3f} s ({count / elapsed:.1f} proofs/s)")
        if zk:
            continue
        plain = (r1cs, ws, proofs)
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "stream_store")
        shutil.rmtree(root, ignore_errors=True)
        store = lst.ProofStore(root)
        cut = lst.prove_r1cs_stream(r1cs, iter(ws), ctx, SEED, batch=BATCH, store=store)
        first = [next(cut).to_bytes() for _ in range(STREAM_CUT)]
        cut.close()
        again = list(lst.prove_r1cs_stream(r1cs, iter(ws), ctx, SEED, batch=BATCH,
                                           store=lst.ProofStore(root)))
        store = lst.ProofStore(root)
        publics = [(r1cs.public_inputs(w), SEED) for w in ws]
        labels = [f"stream-{i}" for i in range(count)]
        swept = store.verify_all(r1cs)
        if (first != [p.to_bytes() for p in proofs[:STREAM_CUT]]
                or [p.to_bytes() for p in again] != [p.to_bytes() for p in proofs]
                or store.missing_statements(r1cs, publics, labels)
                or len(swept) != count or not all(swept.values())):
            raise RuntimeError("stream: the resumed run or the store disagrees")
        phase(f"phase 16 ProofStore resume: a run cut after {STREAM_CUT} proofs, then a "
              f"full run, regenerate identical bytes; the store holds and verifies all "
              f"{count}")

    # --- phase 17: entry() -------------------------------------------------------
    fn, args = lst.entry()
    cpu_fn, cpu_args = lst.entry(device="cpu")
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn(*args)
    torch.cuda.synchronize()
    launches["entry"] = kernels.launches()
    want = cpu_fn(*cpu_args)
    if min(launches["entry"]["quotient_q45"], launches["entry"]["ring_commit_goldilocks"]) < 1 \
            or not all(torch.equal(g.cpu(), w) for g, w in zip(out, want)) \
            or not bool(out[5].all()):
        raise RuntimeError("entry(): the card's prove stage differs from the CPU's")
    phase(f"phase 17 entry(): prove stage m=16 n=32 B=2 equals the CPU run; launches "
          f"{nonzero(launches['entry'])}")
    return launches, record, plain


def kind7_witnesses(np, lst, dev, rng, count: int, m: int) -> np.ndarray:
    """``count`` witnesses [1, x, x^2] of ``kind7_circuit``."""
    from lambda_snark_tpu_torch.ops import modarith

    gl = lst.NTT_MODULUS
    xs = rng.integers(0, gl, size=(count, m), dtype=np.uint64)
    ys = modarith.to_u64(modarith.mul_mod(modarith.to_words(xs, dev),
                                          modarith.to_words(xs, dev), gl))
    return np.concatenate([np.ones((count, 1), np.uint64), xs, ys], axis=1)


def kind7_context(lst, m: int):
    return lst.LweContext(lst.Params(lst.SecurityLevel.BITS128,
                                     lst.Profile.ring_b(n=m, k=1, q=lst.NTT_MODULUS,
                                                        sigma=SIGMA)), context_seed=0)


def check_kind7_launches(launches: dict, label: str) -> None:
    """Every kernel of a kind-7 path launched, one forest launch per Merkle
    forest (no per-level launch of kernel K)."""
    if min(launches[e] for e in KIND7_ENTRIES) < 1:
        raise RuntimeError(f"{label}: a kernel of the path was not launched: {nonzero(launches)}")
    if any(launches[e] for e in KECCAK_PER_LEVEL):
        raise RuntimeError(f"{label}: kernel K launched per level: {nonzero(launches)}")


def kind7_zk_phase(np, torch, lst, dev, rng):
    """Phase 18: ``prove_r1cs_succinct_batch(zk=True)`` at m = 2^13, S = 16
    on the card. Returns (the path's launches, its launches per (entry,
    shape, variant), its record)."""
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.proof.succinct import verify_r1cs_succinct

    gl, m, s = lst.NTT_MODULUS, KIND7_M, KIND7_S
    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    wits = kind7_witnesses(np, lst, dev, rng, s, m)
    seeds, blinds = list(range(300, 300 + s)), list(range(400, 400 + s))

    def prove(device="cuda", rows=s):
        return lst.prove_r1cs_succinct_batch(r1cs, wits[:rows], ctx, seeds[:rows], True,
                                             blinding_seeds=blinds[:rows], device=device)

    prove()  # warm-up
    cpu = prove("cpu", KIND7_CHECK)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    proofs = prove()
    times = [time.time() - t]
    launches, shapes = kernels.launches(), dict(kernels.LAUNCHES)
    check_kind7_launches(launches, "ZK kind 7")
    if len(proofs) != s or not all(verify_r1cs_succinct(p, [1], r1cs) for p in proofs):
        raise RuntimeError("ZK kind 7: a proof from the card does not verify")
    if any(p.mask_len != 2 * FRI_QUERIES + 8 for p in proofs):
        raise RuntimeError("ZK kind 7: a proof without its masks")
    for i in range(KIND7_CHECK):
        if proofs[i].to_bytes() != cpu[i].to_bytes():
            raise RuntimeError(f"ZK kind 7: proof {i} differs from the CPU run")
    reject_tampered(proofs[0], r1cs, gl, "ZK kind 7")
    for _ in range(KIND7_REPS - 1):
        torch.cuda.synchronize()
        t = time.time()
        prove()
        times.append(time.time() - t)
    median = sorted(times)[len(times) // 2]
    size = len(proofs[0].to_bytes())
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "kind7_zk_trace.json")
    wall, busy, top = device_busy(torch, prove, trace)
    idle = None if busy is None else 1.0 - busy / wall
    phase(f"phase 18 prove_r1cs_succinct_batch zk=True m={m} S={s} mask_len "
          f"{proofs[0].mask_len}: {s} proofs verify, first {KIND7_CHECK} byte-identical to the "
          f"CPU run, a flipped path byte and a flipped q_alpha rejected; launches per batch "
          f"{nonzero(launches)}; end to end {[round(x, 4) for x in times]} s, median "
          f"{median:.4f} s ({s / median:.2f} proofs/s), {size} bytes per proof; one profiled "
          f"batch {wall:.4f} s wall, device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} s, idle share {idle:.3f}'}; "
          f"most device time: {[(k, round(v, 3)) for k, v in top]}")
    return launches, shapes, dict(m=m, statements=s, mask_len=proofs[0].mask_len,
                                  end_to_end_s=times, end_to_end_median_s=median,
                                  proofs_per_s=s / median, proof_bytes=size,
                                  launches_per_batch=nonzero(launches), profiled_wall_s=wall,
                                  device_busy_s=busy, device_idle_share=idle,
                                  top_kernels_ms=top)


def pipelined_phase(np, torch, lst, dev, rng):
    """Phase 19: the chunk-pipelined prover (``pipeline_chunk``) at m = 2^13,
    S = 64 and 128, against the unchunked prover in the same call. Returns
    (the S = 128 pipelined run's launches, its launches per shape, the
    record)."""
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.proof.succinct import verify_r1cs_succinct

    m = KIND7_M
    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    wits = kind7_witnesses(np, lst, dev, rng, max(PIPE_SIZES), m)
    seeds = list(range(500, 500 + max(PIPE_SIZES)))
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "pipelined_trace.json")
    record, launches, shapes = {}, {}, {}
    for s in PIPE_SIZES:
        runs = {route: (lambda chunk=chunk, s=s: lst.prove_r1cs_succinct_batch(
            r1cs, wits[:s], ctx, seeds[:s], pipeline_chunk=chunk))
            for route, chunk in (("unchunked", None), ("pipelined", PIPE_CHUNK))}
        want = [p.to_bytes() for p in runs["unchunked"]()]  # warm-up and reference
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = runs["pipelined"]()
        launches[s], shapes[s] = kernels.launches(), dict(kernels.LAUNCHES)
        check_kind7_launches(launches[s], f"pipelined S={s}")
        chunks = -(-s // PIPE_CHUNK)
        if (launches[s]["quotient_goldilocks"], launches[s]["ring_commit_goldilocks"],
                launches[s]["keccak_group_forest"]) != (chunks,) * 3:
            raise RuntimeError(f"pipelined S={s}: not one front end per chunk: "
                               f"{nonzero(launches[s])}")
        if [p.to_bytes() for p in got] != want:
            raise RuntimeError(f"pipelined S={s}: bytes differ from the unchunked prover's")
        if not all(verify_r1cs_succinct(p, [1], r1cs) for p in got):
            raise RuntimeError(f"pipelined S={s}: a proof does not verify")
        times = {route: [] for route in runs}
        for route in ("unchunked", "pipelined", "pipelined", "unchunked", "unchunked",
                      "pipelined"):
            torch.cuda.synchronize()
            t = time.time()
            runs[route]()
            times[route].append(time.time() - t)
        median = {route: sorted(v)[len(v) // 2] for route, v in times.items()}
        idle = {}
        for route, fn in runs.items():
            wall, busy, _top = device_busy(torch, fn, trace)
            idle[route] = dict(profiled_wall_s=wall, device_busy_s=busy,
                               device_idle_share=None if busy is None else 1.0 - busy / wall)
        record[s] = dict(statements=s, chunk=PIPE_CHUNK, end_to_end_s=times,
                         median_s=median, proofs_per_s={r: s / v for r, v in median.items()},
                         profiled=idle, launches_pipelined=nonzero(launches[s]))
        phase(f"phase 19 pipeline_chunk={PIPE_CHUNK} S={s} m={m}: {s} proofs byte-identical "
              f"to the unchunked prover's, all verify; launches {nonzero(launches[s])}; "
              f"median of 3: " + ", ".join(f"{r} {v:.4f} s ({s / v:.2f} proofs/s)"
                                           for r, v in median.items())
              + "; idle share of one profiled batch "
              + ", ".join(f"{r} {v['device_idle_share'] if v['device_idle_share'] is None else round(v['device_idle_share'], 3)}"
                          for r, v in idle.items()))
    big = max(PIPE_SIZES)
    return launches[big], shapes[big], record


def kind7_stream_phase(np, torch, lst, dev, rng):
    """Phase 20: ``prove_r1cs_succinct_stream`` at m = 2^13 in batches of 16
    (two and a half batches): every proof through ``deserialize_any`` and
    ``verify_r1cs_succinct``, proofs/s, and a ``ProofStore`` resume (a run
    cut after half the proofs, then a full run). Returns (the run's
    launches, its launches per shape, the record)."""
    import shutil

    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.proof.succinct import verify_r1cs_succinct

    m = KIND7_M
    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    ws = list(kind7_witnesses(np, lst, dev, rng, STREAM7_COUNT, m))

    def stream(src, store=None, batch=STREAM7_BATCH):
        return lst.prove_r1cs_succinct_stream(r1cs, iter(src), ctx, SEED, batch=batch,
                                              store=store)

    list(stream(ws[:STREAM7_BATCH]))  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    out = list(stream(ws))
    elapsed = time.time() - t
    launches, shapes = kernels.launches(), dict(kernels.LAUNCHES)
    check_kind7_launches(launches, "kind-7 stream")
    if [i for i, _p in out] != list(range(STREAM7_COUNT)):
        raise RuntimeError("kind-7 stream: indices out of order")
    if not all(verify_r1cs_succinct(lst.deserialize_any(p.to_bytes()), [1], r1cs)
               for _i, p in out):
        raise RuntimeError("kind-7 stream: a proof does not verify after deserialize_any")
    whole = [p.to_bytes() for _i, p in stream(ws, batch=STREAM7_COUNT)]
    if whole != [p.to_bytes() for _i, p in out]:
        raise RuntimeError("kind-7 stream: the bytes depend on the batch size")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "kind7_store")
    shutil.rmtree(root, ignore_errors=True)
    cut = stream(ws, lst.ProofStore(root))
    first = [next(cut)[1].to_bytes() for _ in range(STREAM7_COUNT // 2)]
    cut.close()
    again = [p.to_bytes() for _i, p in stream(ws, lst.ProofStore(root))]
    swept = lst.ProofStore(root).verify_all(r1cs)
    if (first != whole[: STREAM7_COUNT // 2] or again != whole
            or len(swept) != STREAM7_COUNT or not all(swept.values())):
        raise RuntimeError("kind-7 stream: the resumed run or the store disagrees")
    phase(f"phase 20 prove_r1cs_succinct_stream m={m} batch={STREAM7_BATCH}: "
          f"{STREAM7_COUNT} proofs in order, each through deserialize_any and "
          f"verify_r1cs_succinct, the same bytes in one batch; launches {nonzero(launches)}; "
          f"{elapsed:.3f} s ({STREAM7_COUNT / elapsed:.2f} proofs/s); a ProofStore run cut "
          f"after {STREAM7_COUNT // 2} proofs, then a full run, gives the same bytes and a "
          f"store of {len(swept)} that verifies")
    return launches, shapes, dict(m=m, proofs=STREAM7_COUNT, batch=STREAM7_BATCH,
                                  end_to_end_s=elapsed, proofs_per_s=STREAM7_COUNT / elapsed)


def host_golden_phase(np, lst):
    """Phase 21: the host golden path (Python ints, no card): the healthcare
    quotient against ``artifacts/r1cs/healthcare_quotient.json``,
    ``prove_r1cs(with_opening=True)`` through ``verify_r1cs_with_context``
    (and a flipped commitment word rejected), and kinds 1, 2, 3 and 6
    through ``deserialize_any`` and their verifiers. Returns host seconds
    per step."""
    import dataclasses

    from lambda_snark_tpu_torch.circuits import healthcare

    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "artifacts", "r1cs", "healthcare_quotient.json")) as f:
        art = json.load(f)
    q = art["modulus"]
    r1cs = healthcare.build_healthcare_circuit(q)
    w = healthcare.high_risk_witness(q)
    public = r1cs.public_inputs(w)
    times = {}
    t = time.time()
    if r1cs.compute_quotient_poly(w) != art["quotient"]:
        raise RuntimeError("host path: the healthcare quotient differs from the artifact")
    times["quotient_s"] = time.time() - t
    t = time.time()
    ctx = lst.setup(lst.Params(lst.SecurityLevel.BITS128,
                               lst.Profile.ring_b(n=RING_N, k=RING_K, q=q, sigma=SIGMA)))
    times["setup_s"] = time.time() - t
    t = time.time()
    proof = lst.deserialize_any(lst.prove_r1cs(r1cs, w, ctx, 0xCAFEBABE,
                                               with_opening=True).to_bytes())
    times["prove_r1cs_with_opening_s"] = time.time() - t
    t = time.time()
    if not lst.verify_r1cs_with_context(proof, public, r1cs, ctx):
        raise RuntimeError("host path: verify_r1cs_with_context rejects an honest proof")
    times["verify_r1cs_with_context_s"] = time.time() - t
    words = proof.commitment_q.words.copy()
    words[0] ^= np.uint64(1)
    if lst.verify_r1cs_with_context(dataclasses.replace(proof, commitment_q=lst.Commitment(words)),
                                    public, r1cs, ctx):
        raise RuntimeError("host path: a flipped commitment word verified")
    cases = (
        ("kind1", lambda: lst.prove_simple(w, public, ctx, q, 7),
         lambda p: lst.verify_simple(p, public, q)),
        ("kind2", lambda: lst.prove_r1cs(r1cs, w, ctx, 7),
         lambda p: lst.verify_r1cs(p, public, r1cs)),
        ("kind3", lambda: lst.prove_r1cs_zk(r1cs, w, ctx, 7, blinding_seed=8),
         lambda p: lst.verify_r1cs_zk(p, public, r1cs)),
        ("kind6", lambda: lst.prove_r1cs(r1cs, w, ctx, 7, bind_circuit=True),
         lambda p: lst.verify_r1cs(p, public, r1cs)))
    for label, prove, check in cases:
        t = time.time()
        blob = prove().to_bytes()
        decoded = lst.deserialize_any(blob)
        if decoded.to_bytes() != blob or blob[8] != int(label[-1]) or not check(decoded):
            raise RuntimeError(f"host path: {label} does not round-trip and verify")
        times[f"{label}_prove_round_trip_verify_s"] = time.time() - t
    phase(f"phase 21 host golden path (healthcare, q={q}, ring n={RING_N} k={RING_K}): the "
          f"quotient equals the artifact, prove_r1cs(with_opening=True) passes "
          f"verify_r1cs_with_context and a flipped commitment word does not; kinds 1, 2, 3, 6 "
          f"round-trip through deserialize_any and verify; host s {times}")
    return times


def reject_tampered_aggregate(proof, r1cs, label: str) -> None:
    """A kind-8 aggregate with a flipped byte in a FRI path, and one with a
    flipped evaluation of its middle statement, must not verify."""
    import dataclasses

    from lambda_snark_tpu_torch.proof.aggregate import verify_r1cs_succinct_aggregate

    s = len(proof.statements)
    st = proof.statements[s // 2]
    bad_st = dataclasses.replace(st, evals=(st.evals[0] ^ 1,) + st.evals[1:])
    tampered = [
        tamper_fri_path(proof),
        dataclasses.replace(proof, statements=proof.statements[: s // 2] + (bad_st,)
                            + proof.statements[s // 2 + 1:]),
    ]
    if any(verify_r1cs_succinct_aggregate(p, [[1]] * s, r1cs) for p in tampered):
        raise RuntimeError(f"{label}: a tampered aggregate verified")


def kind8_phase(np, torch, lst, dev, rng, label: str, m: int, s: int, zk: bool, check: int):
    """Phase 22: ``prove_r1cs_succinct_aggregate`` at m, S on the card.
    Returns (the run's launches, its launches per shape, its record)."""
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.proof.aggregate import verify_r1cs_succinct_aggregate

    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    wits = kind7_witnesses(np, lst, dev, rng, s, m)
    seeds, blinds = list(range(600, 600 + s)), list(range(900, 900 + s))

    def prove(device="cuda", rows=s):
        return lst.prove_r1cs_succinct_aggregate(
            r1cs, wits[:rows], ctx, seeds[:rows], zk,
            blinding_seeds=blinds[:rows] if zk else None, device=device)

    prove()  # warm-up
    if prove(rows=check).to_bytes() != prove("cpu", check).to_bytes():
        raise RuntimeError(f"kind 8 {label}: the card's S={check} aggregate differs from the "
                           "CPU run")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    proof = prove()
    times = [time.time() - t]
    launches, shapes = kernels.launches(), dict(kernels.LAUNCHES)
    check_kind7_launches(launches, f"kind 8 {label}")
    blob = proof.to_bytes()
    publics = [[1]] * s
    t = time.time()
    if not verify_r1cs_succinct_aggregate(lst.deserialize_any(blob), publics, r1cs):
        raise RuntimeError(f"kind 8 {label}: the aggregate does not verify")
    verify_s = time.time() - t
    reject_tampered_aggregate(proof, r1cs, f"kind 8 {label}")
    for _ in range(KIND7_REPS - 1):
        torch.cuda.synchronize()
        t = time.time()
        prove()
        times.append(time.time() - t)
    median = sorted(times)[len(times) // 2]
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         f"kind8_{label}_trace.json")
    wall, busy, top = device_busy(torch, prove, trace)
    idle = None if busy is None else 1.0 - busy / wall
    phase(f"phase 22 prove_r1cs_succinct_aggregate {label} m={m} S={s} zk={zk}: the aggregate "
          f"verifies after deserialize_any ({verify_s:.3f} s), a flipped FRI path byte and a "
          f"flipped statement evaluation rejected, the S={check} aggregate byte-identical to "
          f"the CPU run; launches per batch {nonzero(launches)}; end to end "
          f"{[round(x, 4) for x in times]} s, median {median:.4f} s ({s / median:.2f} "
          f"proofs/s), {len(blob)} bytes ({len(blob) / s:.1f} per statement); one profiled "
          f"batch {wall:.4f} s wall, device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} s, idle share {idle:.3f}'}; "
          f"most device time: {[(k, round(v, 3)) for k, v in top]}")
    return launches, shapes, dict(
        label=label, m=m, statements=s, zk=zk, mask_len=proof.mask_len, end_to_end_s=times,
        end_to_end_median_s=median, proofs_per_s=s / median, proof_bytes=len(blob),
        bytes_per_statement=len(blob) / s, verify_s=verify_s,
        launches_per_batch=nonzero(launches), profiled_wall_s=wall, device_busy_s=busy,
        device_idle_share=idle, top_kernels_ms=top)


def reject_tampered_witness(proof, r1cs, label: str) -> None:
    """A kind-9 proof with a flipped byte in a FRI path, one with a flipped
    gamma evaluation, and the proof against the public input [2] must not
    verify."""
    import dataclasses

    from lambda_snark_tpu_torch.proof.succinct_witness import verify_r1cs_witness

    tampered = [
        (tamper_fri_path(proof), [1]),
        (dataclasses.replace(proof, evals_gamma=(proof.evals_gamma[0] ^ 1,)
                             + proof.evals_gamma[1:]), [1]),
        (proof, [2]),
    ]
    if any(verify_r1cs_witness(p, public, r1cs) for p, public in tampered):
        raise RuntimeError(f"{label}: a tampered proof verified")


# the kind-9 device route's stages, timed by host clock between
# synchronisations (module, function name): the front end, the sumcheck,
# the sum group's LDE and forest, DEEP, FRI and the queries
KIND9_STAGES = (
    ("succinct_witness_device", ("_draw_masks", "quotient_lde_dispatch", "finish_quotient_lde",
                                 "eval_device", "_row_weights", "_sum_of_products",
                                 "_fold_words", "ntt_forward_large", "eval_at")),
    ("fri_device", ("group_forest_levels", "deep_combine_terms_device", "fri_commit_layers",
                    "fri_open")))


def kind9_stages(torch, prove, reps: int = 3) -> dict:
    """Host-clock seconds of each ``KIND9_STAGES`` function in one proof
    (median of ``reps`` staged proofs), a synchronisation before and after
    each call, and the rest of the proof as "rest"."""
    import importlib

    runs = []
    for _ in range(reps):
        parts, saved = {}, []

        def timed(fn, name):
            def call(*args, **kwargs):
                torch.cuda.synchronize()
                t = time.time()
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
                parts[name] = parts.get(name, 0.0) + time.time() - t
                return out
            return call

        for module, names in KIND9_STAGES:
            mod = importlib.import_module(f"lambda_snark_tpu_torch.proof.{module}")
            for name in names:
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, timed(getattr(mod, name), name))
        try:
            torch.cuda.synchronize()
            t = time.time()
            prove()
            total = time.time() - t
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        parts["rest"] = total - sum(parts.values())
        parts["total"] = total
        runs.append(parts)
    return {k: sorted(r.get(k, 0.0) for r in runs)[reps // 2] for k in runs[0]}


def kind9_phase(np, torch, lst, dev, rng, zk: bool):
    """Phase 24: ``prove_r1cs_witness`` at m = 2^12 on the card. Returns
    (one proof's launches, its launches per shape, the record)."""
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.proof.succinct_witness import _witness_geometry

    label = "kind9_zk" if zk else "kind9"
    m = KIND9_M
    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    wit = kind7_witnesses(np, lst, dev, rng, 1, m)[0]

    def prove(device="cuda"):
        return lst.prove_r1cs_witness(r1cs, wit, ctx, 700, zk=zk, blinding_seed=900,
                                      device=device)

    prove()  # warm-up
    t = time.time()
    cpu = prove("cpu")
    cpu_s = time.time() - t
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    proof = prove()
    times = [time.time() - t]
    launches, shapes = kernels.launches(), dict(kernels.LAUNCHES)
    check_kind7_launches(launches, label)
    blob = proof.to_bytes()
    if blob != cpu.to_bytes():
        raise RuntimeError(f"{label}: the card's proof differs from the CPU run")
    t = time.time()
    if not lst.verify_r1cs_witness(lst.deserialize_any(blob), [1], r1cs):
        raise RuntimeError(f"{label}: the proof does not verify after deserialize_any")
    verify_s = time.time() - t
    reject_tampered_witness(proof, r1cs, label)
    for _ in range(KIND7_REPS - 1):
        torch.cuda.synchronize()
        t = time.time()
        prove()
        times.append(time.time() - t)
    median = sorted(times)[len(times) // 2]
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         f"{label}_trace.json")
    wall, busy, top = device_busy(torch, prove, trace)
    idle = None if busy is None else 1.0 - busy / wall
    stages = kind9_stages(torch, prove)
    n0 = _witness_geometry(r1cs, proof.fri_params, proof.mask_len)[3]
    phase(f"phase 24 prove_r1cs_witness m={m} zk={zk} n0={n0}: the proof verifies after "
          f"deserialize_any ({verify_s:.3f} s), a flipped FRI path byte, a flipped gamma "
          f"evaluation and the public input [2] rejected, the bytes equal the CPU run "
          f"({cpu_s:.2f} s on the CPU); launches per proof "
          f"{nonzero(launches)}; end to end {[round(x, 4) for x in times]} s, median "
          f"{median:.4f} s ({1 / median:.3f} proofs/s), {len(blob)} bytes; one profiled proof "
          f"{wall:.4f} s wall, device busy "
          f"{'not measured' if busy is None else f'{busy:.4f} s, idle share {idle:.3f}'}; "
          f"most device time: {[(k, round(v, 3)) for k, v in top]}; host-clock stages of one "
          f"proof (median of 3) {[(k, round(v, 4)) for k, v in stages.items()]}")
    return launches, shapes, dict(
        label=label, m=m, zk=zk, mask_len=proof.mask_len, n0=n0, stages_s=stages,
        end_to_end_s=times,
        end_to_end_median_s=median, proofs_per_s=1 / median, proof_bytes=len(blob),
        cpu_route_s=cpu_s, verify_s=verify_s, launches_per_proof=nonzero(launches),
        profiled_wall_s=wall, device_busy_s=busy, device_idle_share=idle, top_kernels_ms=top)


def kind9_batch_stream_phase(np, torch, lst, dev, rng):
    """Phase 24: ``prove_r1cs_witness_batch`` at m = 2^12, S = 4, and the
    ``witness_bind`` stream at m = 2^10 (10 witnesses in batches of 4) with
    a ``ProofStore`` resume: every proof verifies, and the stream's bytes
    equal one batch. Returns ((label, the run's launches, its launches per
    shape, context) for the batch and the stream, the record)."""
    import shutil

    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.proof.succinct_witness import verify_r1cs_witness

    runs, record = [], {}
    m = KIND9_M
    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    ws = list(kind7_witnesses(np, lst, dev, rng, KIND9_BATCH, m))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    proofs = lst.prove_r1cs_witness_batch(r1cs, ws, ctx, list(range(40, 40 + KIND9_BATCH)))
    elapsed = time.time() - t
    runs.append(("kind9_batch", kernels.launches(), dict(kernels.LAUNCHES), ctx))
    if not all(verify_r1cs_witness(p, [1], r1cs) for p in proofs):
        raise RuntimeError("kind-9 batch: a proof does not verify")
    record["batch"] = dict(m=m, statements=KIND9_BATCH, end_to_end_s=elapsed,
                           proofs_per_s=KIND9_BATCH / elapsed)

    m = KIND9_STREAM_M
    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    ws = list(kind7_witnesses(np, lst, dev, rng, KIND9_STREAM_COUNT, m))

    def stream(store=None, batch=KIND9_STREAM_BATCH):
        return lst.prove_r1cs_succinct_stream(r1cs, iter(ws), ctx, SEED, batch=batch,
                                              store=store, witness_bind=True)

    torch.cuda.synchronize()
    kernels.reset_launches()
    t = time.time()
    out = list(stream())
    elapsed = time.time() - t
    runs.append(("kind9_stream", kernels.launches(), dict(kernels.LAUNCHES), ctx))
    whole = [p.to_bytes() for _i, p in stream(batch=KIND9_STREAM_COUNT)]
    if ([i for i, _p in out] != list(range(KIND9_STREAM_COUNT))
            or [p.to_bytes() for _i, p in out] != whole
            or not all(verify_r1cs_witness(lst.deserialize_any(b), [1], r1cs) for b in whole)):
        raise RuntimeError("kind-9 stream: out of order, not one batch's bytes, or unverified")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "kind9_store")
    shutil.rmtree(root, ignore_errors=True)
    cut = stream(lst.ProofStore(root))
    first = [next(cut)[1].to_bytes() for _ in range(KIND9_STREAM_COUNT // 2)]
    cut.close()
    again = [p.to_bytes() for _i, p in stream(lst.ProofStore(root))]
    swept = lst.ProofStore(root).verify_all(r1cs)
    if (first != whole[: KIND9_STREAM_COUNT // 2] or again != whole
            or len(swept) != KIND9_STREAM_COUNT or not all(swept.values())):
        raise RuntimeError("kind-9 stream: the resumed run or the store disagrees")
    record["stream"] = dict(m=m, proofs=KIND9_STREAM_COUNT, batch=KIND9_STREAM_BATCH,
                            end_to_end_s=elapsed, proofs_per_s=KIND9_STREAM_COUNT / elapsed)
    phase(f"phase 24 prove_r1cs_witness_batch m={KIND9_M} S={KIND9_BATCH}: every proof "
          f"verifies, {record['batch']['end_to_end_s']:.3f} s "
          f"({record['batch']['proofs_per_s']:.3f} proofs/s); witness_bind stream m={m} "
          f"batch={KIND9_STREAM_BATCH}: {KIND9_STREAM_COUNT} proofs in order through "
          f"deserialize_any and verify_r1cs_witness, one batch's bytes, {elapsed:.3f} s "
          f"({KIND9_STREAM_COUNT / elapsed:.2f} proofs/s); a ProofStore run cut after "
          f"{KIND9_STREAM_COUNT // 2} proofs, then a full run, gives the same bytes and a "
          f"store of {len(swept)} that verifies")
    return runs, record


def host_routes_phase(np, lst):
    """Phase 23: the host routes at the JAX tests' shapes (FriParams(3, 8),
    ring n = 64, k = 1): kind 7 over the 44-bit field and the healthcare
    prime, plain and ZK; kind 7 at ring degree n < m (n = 8, m = 16, a
    zero-quotient circuit; the front end on the card); compact kinds 4/5
    and the checked proof on the healthcare circuit. Returns host seconds
    per route."""
    import dataclasses

    from lambda_snark_tpu_torch.circuits import healthcare
    from lambda_snark_tpu_torch.core.params import HEALTHCARE_DUMP_MODULUS
    from lambda_snark_tpu_torch.proof.fri import root_of_order
    from lambda_snark_tpu_torch.r1cs.domain import Domain

    fast = lst.FriParams(log_blowup=3, num_queries=8)

    def ctx_of(q, n=64, k=1):
        return lst.LweContext(lst.Params(lst.SecurityLevel.BITS128,
                                         lst.Profile.ring_b(n=n, k=k, q=q, sigma=SIGMA)))

    def kind7(label, r1cs, w, ctx, zk, seeds=(1,)):
        t = time.time()
        proofs = lst.prove_r1cs_succinct_batch(r1cs, [w] * len(seeds), ctx, list(seeds), zk,
                                               fast, blinding_seeds=[5] * len(seeds) if zk
                                               else None)
        elapsed = time.time() - t
        public = r1cs.public_inputs(w)
        for p in proofs:
            if not lst.verify_r1cs_succinct(lst.deserialize_any(p.to_bytes()), public, r1cs,
                                            min_params=fast):
                raise RuntimeError(f"host routes: {label} does not verify")
        bad = dataclasses.replace(proofs[0], q_alpha=(proofs[0].q_alpha + 1) % r1cs.modulus)
        if lst.verify_r1cs_succinct(bad, public, r1cs, min_params=fast):
            raise RuntimeError(f"host routes: a tampered {label} proof verified")
        return elapsed

    times = {}
    rng = np.random.default_rng(SEED)
    for name, q, m in (("q45", lst.NTT_FRIENDLY_MODULUS, 16),
                       ("healthcare_prime", HEALTHCARE_DUMP_MODULUS, 8)):
        r1cs = lst.multiplication_gates_circuit(m, q)
        r1cs = dataclasses.replace(r1cs, domain=Domain.roots(m, q, root_of_order(q, m)))
        a = [int(v) for v in rng.integers(1, q, size=m)]
        b = [int(v) for v in rng.integers(1, q, size=m)]
        w = [1] + a + b + [x * y % q for x, y in zip(a, b)]
        for zk in (False, True):
            times[f"kind7_{name}_{'zk' if zk else 'plain'}_s"] = kind7(
                f"kind 7 over {name}", r1cs, w, ctx_of(q), zk)
    # n < m: m = 16 gates a_i * 1 = c_i (Q = 0) with ring n = 8, three statements
    gl, m = lst.NTT_MODULUS, 16
    builder = lst.CircuitBuilder(gl)
    one, xs, ys = builder.alloc_var(), builder.alloc_vars(m), builder.alloc_vars(m)
    builder.set_public_inputs(1)
    for x, y in zip(xs, ys):
        builder.add_constraint([(x, 1)], [(one, 1)], [(y, 1)])
    xs_w = [int(v) for v in rng.integers(0, gl, size=m, dtype=np.uint64)]
    times["kind7_ring_below_m_s"] = kind7("kind 7 at n < m", builder.build(), [1] + xs_w + xs_w,
                                          ctx_of(gl, n=8), False, seeds=(1, 2, 3))
    # compact kinds 4 and 5, the checked proof: the healthcare circuit
    q = 17592186044423
    r1cs = healthcare.build_healthcare_circuit(q)
    w = healthcare.high_risk_witness(q)
    public = r1cs.public_inputs(w)
    ctx = lst.setup(lst.Params(lst.SecurityLevel.BITS128,
                               lst.Profile.ring_b(n=RING_N, k=RING_K, q=q, sigma=SIGMA)))
    for kind, kw in ((4, {}), (5, dict(blinding_seed=9, zk=True))):
        t = time.time()
        blob = lst.prove_r1cs_compact(r1cs, w, ctx, 11, **kw).to_bytes()
        proof = lst.deserialize_any(blob)
        if blob[8] != kind or len(blob) != (193 if kind == 4 else 201) or \
                not lst.verify_r1cs_compact(proof, public, r1cs):
            raise RuntimeError(f"host routes: compact kind {kind} does not round-trip and verify")
        if lst.verify_r1cs_compact(dataclasses.replace(proof, q_alpha=(proof.q_alpha + 1) % q),
                                   public, r1cs):
            raise RuntimeError(f"host routes: a tampered compact kind {kind} verified")
        times[f"compact_kind{kind}_s"] = time.time() - t
    t = time.time()
    proof, binding = lst.prove_r1cs_checked(r1cs, w, ctx, 0xBEEF)
    if not lst.verify_r1cs_checked(proof, binding, public, r1cs, ctx):
        raise RuntimeError("host routes: the checked proof does not verify")
    bad = dataclasses.replace(proof, a_z_alpha=(proof.a_z_alpha + 1) % q)
    if lst.verify_r1cs_checked(bad, binding, public, r1cs, ctx):
        raise RuntimeError("host routes: a tampered checked proof verified")
    times["checked_s"] = time.time() - t
    phase(f"phase 23 host routes: kind 7 over the 44-bit field and the healthcare prime (plain "
          f"and ZK), kind 7 at n < m, compact kinds 4 and 5 and the checked proof (healthcare) "
          f"verify, and their tampered twins do not; host s {times}")
    return times


def hold_path_shapes(np, torch, lst, dev, rng, hold, shapes, held, tag, ctx, num) -> list:
    """Kernels K, T, Q, R, S and F at every (entry, input shape, variant) of a
    path's run (``kernels.LAUNCHES``) against their twins, each shape held
    once in the script (``held`` keeps the records); returns ``kernels``
    line entries with the run's launches at each shape, and fails unless
    every launch of those entries is listed. ``ctx`` is the path's ring
    context, or a function of the ring degree n that gives it."""
    from lambda_snark_tpu_torch.ops import modarith
    from lambda_snark_tpu_torch.ops.quotient import QuotientPlan, quotient, quotient_plain
    from lambda_snark_tpu_torch.ops.ring_commit import ring_commit, ring_commit_plain
    from lambda_snark_tpu_torch.pipeline import field_psi_for
    from lambda_snark_tpu_torch.proof.succinct_device import device_commit_context

    gl = lst.NTT_MODULUS
    src = "lambda_snark_tpu_torch/csrc"
    ring_src = "lambda_snark_tpu/ops/ring_mxu.py:229; lambda_snark_tpu/ops/ring_pallas.py:230"
    where = {"quotient_goldilocks": ("quotient.cu", "lambda_snark_tpu/ops/quotient_pallas.py:143"),
             "ring_commit_goldilocks": ("ring_commit.cu", ring_src),
             "ntt_rows": ("ntt.cu", "lambda_snark_tpu/ops/ntt_pallas.py:126"),
             "ntt_four_step": ("ntt.cu", "lambda_snark_tpu/ops/ntt_pallas.py:126; "
                                         "lambda_snark_tpu/ops/ntt_mxu.py:631"),
             "keccak_group_forest": ("keccak.cu", KECCAK_SRC),
             "keccak_forest": ("keccak.cu", KECCAK_SRC),
             "transcript_absorb": ("fri.cu", SPONGE_SRC),
             "transcript_squeeze": ("fri.cu", SPONGE_SRC),
             "transcript_final_queries": ("fri.cu", SPONGE_SRC),
             "fri_fold": ("fri.cu", FOLD_SRC),
             "fri_fold_squeeze": ("fri.cu", FOLD_SRC)}
    words = lambda shape, q=gl: modarith.to_words(rng.integers(0, q, size=shape,
                                                               dtype=np.uint64), dev)
    out = []
    for key, launches in sorted(shapes.items()):
        entry, shape, variant = key
        if entry not in where:
            raise RuntimeError(f"{tag}: an entry with no holder on this path: {entry}")
        label = f"phase {num} {tag} {entry} {'x'.join(map(str, shape))} {variant}".rstrip()
        if key not in held:
            if entry in FOREST_ENTRIES:
                x, fn, plain, _ = forest_inputs(np, modarith, dev, rng, entry, shape)
                held[key] = hold(label, fn, plain, (x,), forest_work(*shape), plain_reps=1)
            elif entry.startswith("ntt_"):
                fn, plain, x, work = ntt_hold(np, dev, rng, entry, shape, variant)
                held[key] = hold(label, fn, plain, (x,), work, plain_reps=1)
            elif entry in CHAIN_ENTRIES:
                fn, plain, args, work = chain_hold(np, dev, rng, entry, shape, variant)
                held[key] = hold(label, fn, plain, args, work, plain_reps=1, graph=True)
            elif entry == "quotient_goldilocks":
                rows, m = shape
                plan = QuotientPlan.create(m, gl, field_psi_for(m, gl), device=dev)
                a, b = words(shape), words(shape)
                held[key] = hold(label, lambda *v: quotient(plan, *v),
                                 lambda *v: quotient_plain(plan, *v),
                                 (a, b, modarith.mul_mod(a, b, gl)),
                                 quotient_work(rows, m, "goldilocks"), plain_reps=1)
            else:  # ring_commit_goldilocks: e (rows, n), a message of n words
                rows, n = shape
                ring_ctx = ctx(n) if callable(ctx) else ctx
                ring = device_commit_context(ring_ctx, dev).ring
                s_draws = torch.from_numpy(rng.integers(-39, 40, size=(ring_ctx.k, rows, n),
                                                        dtype=np.int32)).to(dev)
                e_draws = torch.from_numpy(rng.integers(-39, 40, size=shape,
                                                        dtype=np.int32)).to(dev)
                held[key] = hold(label, lambda *v: ring_commit(ring, *v),
                                 lambda *v: ring_commit_plain(ring, *v),
                                 (s_draws, e_draws, words(shape)),
                                 ring_work(rows, n, ring_ctx.k, n), plain_reps=1)
        src_file, replaces = where[entry]
        name = f"{entry}_{tag}_{'x'.join(map(str, shape))}"
        if variant:
            name += f"_{ntt_name(variant)}" if entry.startswith("ntt_") else \
                f"_{variant.replace(' ', '_' if entry in CHAIN_ENTRIES else '')}"
        out.append(dict(name=name, route="cuda", source=f"{src}/{src_file}", replaces=replaces,
                        launches=launches, **held[key], library_ms=None))
    for entry in where:
        listed = sum(e["launches"] for e in out if e["name"].startswith(f"{entry}_{tag}_"))
        run = sum(n for (e, _s, _v), n in shapes.items() if e == entry)
        if listed != run:
            raise RuntimeError(f"{tag}: {entry} launched {run} times, {listed} listed")
    phase(f"phase {num} {tag}: kernels K, T, Q, R, S and F held at each of the {len(shapes)} "
          f"(entry, shape, variant) triples of the run; every launch of theirs listed")
    return out


# the command line's phase (25): kind 7 at k7a through prove-stream
# --succinct, kind 9 at m = 2^12 through prove --witness-bind (plain and
# ZK), kinds 2/3 through prove-stream at B = 256 (a store resume in batches
# of 128), the native host verifier, and fuzz on the card and on the CPU
CLI_SEED = 0x5EED
CLI_CUT = BATCH // 2
CLI_FUZZ_ITERATIONS = 200
CLI_STREAM_LAUNCHES = {"quotient_q45": 1, "ring_commit_goldilocks": 1}  # one batch of B


def write_circuit(path: str, r1cs) -> str:
    """``cli._load_circuit``'s {"a", "b", "c"} COO form of ``r1cs``."""
    data = {"m": r1cs.m, "n": r1cs.n, "l": r1cs.l, "modulus": r1cs.modulus}
    for side, mat in (("a", r1cs.a), ("b", r1cs.b), ("c", r1cs.c)):
        data[side] = [{"row": i, "col": j, "value": int(v)} for i, j, v in mat.coo()]
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def write_json(path: str, data) -> str:
    with open(path, "w") as f:
        json.dump(data, f)
    return path


def cli_run(argv) -> tuple:
    """``cli.main(argv)`` in this process: (exit code, stdout, host seconds)."""
    import contextlib
    import io

    from lambda_snark_tpu_torch import cli

    buf = io.StringIO()
    t = time.time()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([str(a) for a in argv])
    return rc, buf.getvalue(), time.time() - t


def cli_ok(argv, label: str) -> tuple:
    rc, out, seconds = cli_run(argv)
    if rc != 0:
        raise RuntimeError(f"{label}: exit code {rc}: {out}")
    return out, seconds


def cli_verify(circuit: str, proof_path: str, public, label: str, expect: int) -> float:
    rc, out, seconds = cli_run(["verify", "--circuit", circuit, "--proof", proof_path,
                                "--public", ",".join(map(str, public))])
    if rc != expect:
        raise RuntimeError(f"{label}: verify of {os.path.basename(proof_path)} gave exit code "
                           f"{rc}, not {expect}: {out}")
    return seconds


def native_build_start():
    """Start the native host library's build (g++, beside the nvcc builds)
    where there is a C++ compiler: (thread, result) or None."""
    import threading

    from lambda_snark_tpu_torch import native_bridge

    if native_bridge.compiler() is None:
        return None
    result = {}

    def run():
        t = time.time()
        try:
            result["path"] = native_bridge.build()
        except RuntimeError as exc:
            result["error"] = exc
        result["s"] = time.time() - t

    thread = threading.Thread(target=run)
    thread.start()
    return thread, result


def native_build_finish(started) -> str:
    """Wait for the native build; raise where a compiler failed it."""
    from lambda_snark_tpu_torch import native_bridge

    if started is None:
        return "no C++ compiler on this machine: not built, the host verifier runs on hashlib"
    thread, result = started
    thread.join()
    if "error" in result:
        raise RuntimeError(f"native host library: {result['error']}")
    if not native_bridge.available():
        raise RuntimeError(f"native host library not loaded: {native_bridge.load_error()}")
    root = os.path.dirname(os.path.abspath(__file__))
    return f"built in {result['s']:.1f} s and loaded ({os.path.relpath(result['path'], root)})"


def cli_phase(np, torch, lst, dev, rng, hold, held, report, k7, k9, smi: str):
    """Phase 25: the port's command line (``cli.main`` in this process, as a
    user runs ``python -m lambda_snark_tpu_torch``) on the card at the
    slices' widths, every proof byte-equal to the library call's on the same
    files, verified by the command line, with the kernels' launches of each
    command; the native host verifier; fuzz on the card and the CPU; and
    ``python -m lambda_snark_tpu_torch info`` as a process of its own.
    Returns (``kernels`` line entries, the record)."""
    import tempfile

    from lambda_snark_tpu_torch import kernels, native_bridge
    from lambda_snark_tpu_torch.proof import fri as port_fri

    gl, q45 = lst.NTT_MODULUS, lst.NTT_FRIENDLY_MODULUS
    record, entries = {}, []
    tmp_dir = tempfile.TemporaryDirectory(prefix="lsnark_cli_")
    tmp = tmp_dir.name
    path = lambda name: os.path.join(tmp, name)

    def setup(q: int, n: int, k: int, context_seed: int):
        cli_ok(["--modulus", q, "--ring-degree", n, "setup", "--rank", k, "--context-seed",
                context_seed, "--out", path(f"ctx_{q}_{n}.json")], "setup")
        params = lst.Params(lst.SecurityLevel.BITS128, lst.Profile.ring_b(n=n, k=k, q=q,
                                                                          sigma=SIGMA))
        return path(f"ctx_{q}_{n}.json"), lst.setup(params, context_seed=context_seed)

    # --- (a) kind 7 at k7a: prove-stream --succinct --batch 16 ------------------------
    m, s = KIND7_M, KIND7_S
    r1cs7 = kind7_circuit(lst, m)
    circuit7 = write_circuit(path("kind7.json"), r1cs7)
    ws7 = kind7_witnesses(np, lst, dev, rng, s, m)
    witnesses7 = write_json(path("kind7_w.json"), {"witnesses": ws7.tolist()})
    ctx7_path, ctx7 = setup(gl, m, 1, 11)
    out7 = path("kind7_out")
    argv = ["--seed", CLI_SEED, "prove-stream", "--circuit", circuit7, "--witnesses", witnesses7,
            "--context", ctx7_path, "--batch", s, "--succinct", "--out-dir", out7]
    torch.cuda.synchronize()
    kernels.reset_launches()
    line7, host7 = cli_ok(argv, "kind 7")
    torch.cuda.synchronize()
    launches7, shapes7 = kernels.launches(), dict(kernels.LAUNCHES)
    check_kind7_launches(launches7, "CLI kind 7")
    if nonzero(launches7) != nonzero(k7):
        raise RuntimeError(f"CLI kind 7: launches {nonzero(launches7)}, phase 11 {nonzero(k7)}")
    lib7 = [p for _i, p in lst.prove_r1cs_succinct_stream(r1cs7, list(ws7), ctx7, CLI_SEED,
                                                          batch=s)]
    blobs7 = []
    for i, p in enumerate(lib7):
        with open(os.path.join(out7, f"{i}.proof"), "rb") as f:
            blobs7.append(f.read())
        if blobs7[-1] != p.to_bytes():
            raise RuntimeError(f"CLI kind 7: {i}.proof differs from prove_r1cs_succinct_stream")
    verify7 = [cli_verify(circuit7, os.path.join(out7, f"{i}.proof"), [1], "CLI kind 7", 0)
               for i in range(s)]
    bad7 = tamper_fri_path(lib7[0])
    with open(path("kind7_bad.proof"), "wb") as f:
        f.write(bad7.to_bytes())
    cli_verify(circuit7, path("kind7_bad.proof"), [1], "CLI kind 7 tampered", 1)
    record["kind7"] = dict(m=m, statements=s, end_to_end_s=host7, proofs_per_s=s / host7,
                           verify_s=verify7, launches=nonzero(launches7))
    phase(f"phase 25 CLI prove-stream --succinct m={m} S={s}: {line7.strip()}; every "
          f"<i>.proof equals prove_r1cs_succinct_stream's bytes, verify ACCEPT (exit 0) on each "
          f"(median {sorted(verify7)[s // 2]:.3f} s a call), a flipped FRI path byte exit 1; "
          f"launches {nonzero(launches7)} (phase 11's); {host7:.3f} s host "
          f"({s / host7:.2f} proofs/s, JSON load included)")
    entries += hold_path_shapes(np, torch, lst, dev, rng, hold, shapes7, held, "cli_kind7",
                                ctx7, 25)

    # --- (b) kind 9 at m = 2^12: prove --witness-bind, plain and ZK --------------------
    m9 = KIND9_M
    r1cs9 = kind7_circuit(lst, m9)
    circuit9 = write_circuit(path("kind9.json"), r1cs9)
    w9 = kind7_witnesses(np, lst, dev, rng, 1, m9)[0]
    witness9 = write_json(path("kind9_w.json"), w9.tolist())
    ctx9_path, ctx9 = setup(gl, m9, 1, 0)
    record["kind9"] = {}
    for zk in (False, True):
        label = "kind9_zk" if zk else "kind9"
        out9 = path(f"{label}.proof")
        argv = ["--seed", 700, "prove", "--circuit", circuit9, "--witness", witness9,
                "--context", ctx9_path, "--witness-bind", "--out", out9]
        if zk:
            argv += ["--zk", "--blinding-seed", 900]
        torch.cuda.synchronize()
        kernels.reset_launches()
        line9, host9 = cli_ok(argv, f"CLI {label}")
        torch.cuda.synchronize()
        launches9, shapes9 = kernels.launches(), dict(kernels.LAUNCHES)
        if nonzero(launches9) != nonzero(k9[zk]):
            raise RuntimeError(f"CLI {label}: launches {nonzero(launches9)}, phase 24 "
                               f"{nonzero(k9[zk])}")
        lib9 = lst.prove_r1cs_witness(r1cs9, w9, ctx9, 700, zk=zk, blinding_seed=900)
        with open(out9, "rb") as f:
            if f.read() != lib9.to_bytes():
                raise RuntimeError(f"CLI {label}: the proof differs from prove_r1cs_witness")
        verify9 = cli_verify(circuit9, out9, [1], f"CLI {label}", 0)
        with open(path(f"{label}_bad.proof"), "wb") as f:
            f.write(tamper_fri_path(lib9).to_bytes())
        cli_verify(circuit9, path(f"{label}_bad.proof"), [1], f"CLI {label} tampered", 1)
        record["kind9"][label] = dict(m=m9, end_to_end_s=host9, verify_s=verify9,
                                      launches=nonzero(launches9))
        phase(f"phase 25 CLI prove --witness-bind{' --zk' if zk else ''} m={m9}: "
              f"{line9.strip()}; the bytes equal prove_r1cs_witness's, verify ACCEPT "
              f"({verify9:.3f} s), a flipped FRI path byte exit 1; launches "
              f"{nonzero(launches9)} (phase 24's)")
        entries += hold_path_shapes(np, torch, lst, dev, rng, hold, shapes9, held,
                                    f"cli_{label}", ctx9, 25)

    # --- (c) kinds 2/3: prove-stream at B = 256, plain m = 4096, ZK m = 2048 -----------
    ctx23_path, ctx23 = setup(q45, RING_N, RING_K, 1)
    record["kinds23"] = {}
    src = "lambda_snark_tpu_torch/csrc"
    quotient_src = ("lambda_snark_tpu/ops/ntt_mxu_q45.py:466; "
                    "lambda_snark_tpu/ops/quotient_pallas.py:143")
    ring_src = "lambda_snark_tpu/ops/ring_mxu.py:229; lambda_snark_tpu/ops/ring_pallas.py:230"
    for label, m23, zk in (("stream", M_PLAIN, False), ("stream_zk", M_ZK, True)):
        r1cs = lst.multiplication_gates_circuit(m23, q45)
        circuit = write_circuit(path(f"{label}.json"), r1cs)
        wa = rng.integers(1, q45, size=(BATCH, m23), dtype=np.uint64)
        wb = rng.integers(1, q45, size=(BATCH, m23), dtype=np.uint64)
        wc = (wa.astype(object) * wb.astype(object)) % q45
        ws = np.concatenate([np.ones((BATCH, 1), object), wa.astype(object),
                             wb.astype(object), wc], axis=1).tolist()
        witnesses = write_json(path(f"{label}_w.json"), ws)
        out = path(f"{label}_out")
        flags = ["--zk", "--blinding-seed", 5] if zk else []
        argv = ["--seed", CLI_SEED, "prove-stream", "--circuit", circuit, "--witnesses",
                witnesses, "--context", ctx23_path, "--batch", BATCH, "--out-dir", out, *flags]
        torch.cuda.synchronize()
        kernels.reset_launches()
        line, host = cli_ok(argv, f"CLI {label}")
        torch.cuda.synchronize()
        launches = kernels.launches()
        if nonzero(launches) != CLI_STREAM_LAUNCHES:
            raise RuntimeError(f"CLI {label}: launches {nonzero(launches)}, not Q and R once")
        lib = list(lst.prove_r1cs_stream(r1cs, iter(ws), ctx23, CLI_SEED, batch=BATCH, zk=zk,
                                         blinding_seed=5 if zk else None))
        for i, p in enumerate(lib):
            with open(os.path.join(out, f"{i}.proof"), "rb") as f:
                if f.read() != p.to_bytes():
                    raise RuntimeError(f"CLI {label}: {i}.proof differs from prove_r1cs_stream")
        for i in (0, BATCH - 1):
            cli_verify(circuit, os.path.join(out, f"{i}.proof"), r1cs.public_inputs(ws[i]),
                       f"CLI {label}", 0)
        resumed = None
        if not zk:
            # a run cut after one batch of 128, then the full run over its store
            store = path("store")
            cut = write_json(path("cut_w.json"), ws[:CLI_CUT])
            common = ["--seed", CLI_SEED, "prove-stream", "--circuit", circuit, "--context",
                      ctx23_path, "--batch", CLI_CUT, "--store", store]
            cli_ok([*common, "--witnesses", cut], "CLI stream cut run")
            held_after_cut = len(lst.ProofStore(store).keys())
            cli_ok([*common, "--witnesses", witnesses, "--out-dir", path("resumed")],
                   "CLI stream resumed run")
            lib_r = list(lst.prove_r1cs_stream(r1cs, iter(ws), ctx23, CLI_SEED, batch=CLI_CUT))
            for i, p in enumerate(lib_r):
                with open(os.path.join(path("resumed"), f"{i}.proof"), "rb") as f:
                    if f.read() != p.to_bytes():
                        raise RuntimeError(f"CLI stream resume: {i}.proof differs")
            keys = lst.ProofStore(store).keys()
            if held_after_cut != CLI_CUT or len(keys) != BATCH:
                raise RuntimeError(f"CLI stream resume: the store held {held_after_cut}, then "
                                   f"{len(keys)}")
            resumed = f"; --store: a run cut after {CLI_CUT} proofs, then the full run in " \
                      f"batches of {CLI_CUT}, the library's bytes, the store holds all {BATCH}"
        record["kinds23"][label] = dict(m=m23, proofs=BATCH, end_to_end_s=host,
                                        proofs_per_s=BATCH / host, launches=nonzero(launches))
        phase(f"phase 25 CLI prove-stream{' --zk' if zk else ''} m={m23} B={BATCH}: "
              f"{line.strip()}; every proof equals prove_r1cs_stream's bytes, proofs 0 and "
              f"{BATCH - 1} verify ACCEPT{resumed or ''}; launches {nonzero(launches)}; "
              f"{host:.3f} s host ({BATCH / host:.1f} proofs/s, JSON load included)")
        sfx = "_zk" if zk else ""
        entries += [
            dict(name=f"quotient_q45_cli_{label}", route="cuda", source=f"{src}/quotient.cu",
                 replaces=quotient_src, launches=launches["quotient_q45"],
                 **report[f"quotient_q45{sfx}"], library_ms=None),
            dict(name=f"ring_commit_goldilocks_cli_{label}", route="cuda",
                 source=f"{src}/ring_commit.cu", replaces=ring_src,
                 launches=launches["ring_commit_goldilocks"], **report[f"ring_commit{sfx}"],
                 library_ms=None)]

    # --- (d) the native library (built in phase 2) and the host verifier ----------------
    proofs7 = [lst.deserialize_any(b) for b in blobs7]
    if native_bridge.compiler() is None:
        phase("phase 25 native library: no C++ compiler on this machine; the host verifier "
              "runs on hashlib alone")
        record["native"] = None
    else:
        if not native_bridge.available():
            raise RuntimeError(f"native library not loaded: {native_bridge.load_error()}")
        lib_path = native_bridge.build()
        rates = {}
        saved = port_fri.NATIVE_VERIFY
        try:
            for flag in (True, False):
                port_fri.NATIVE_VERIFY = flag
                t = time.time()
                ok = [lst.verify_r1cs_succinct(p, [1], r1cs7) for p in proofs7]
                rates["native" if flag else "hashlib"] = len(ok) / (time.time() - t)
                if not all(ok) or lst.verify_r1cs_succinct(bad7, [1], r1cs7):
                    raise RuntimeError(f"NATIVE_VERIFY={flag}: a wrong decision on kind 7")
        finally:
            port_fri.NATIVE_VERIFY = saved
        record["native"] = dict(verify_statements_per_s=rates, card=smi)
        phase(f"phase 25 native library: loaded "
              f"({os.path.relpath(lib_path, os.path.dirname(os.path.abspath(__file__)))}); "
              f"the host verifier decides the same with NATIVE_VERIFY on and "
              f"off ({s} proofs accepted, the tampered one rejected); kind-7 verify "
              f"{rates['native']:.1f} statements/s native, {rates['hashlib']:.1f} hashlib ({smi})")

    # --- (e) fuzz on the card, against the CPU run of the same seed ---------------------
    fuzz_out = {}
    for device in ("cuda", "cpu"):
        fuzz_out[device], seconds = cli_ok(["--device", device, "fuzz", "--iterations",
                                            CLI_FUZZ_ITERATIONS], f"fuzz on {device}")
        record[f"fuzz_{device}_s"] = seconds
    if fuzz_out["cuda"] != fuzz_out["cpu"] or not fuzz_out["cuda"].endswith("fuzz: OK\n"):
        raise RuntimeError(f"fuzz: the card's run {fuzz_out['cuda']!r} differs from the CPU's "
                           f"{fuzz_out['cpu']!r}")
    phase(f"phase 25 CLI fuzz --iterations {CLI_FUZZ_ITERATIONS} --device cuda: no crash, the "
          f"CPU run's counts: {' | '.join(fuzz_out['cuda'].strip().splitlines())}")

    # --- python -m lambda_snark_tpu_torch info, a process of its own ---------------------
    root = os.path.dirname(os.path.abspath(__file__))
    info = subprocess.run([sys.executable, "-X", "importtime", "-m", "lambda_snark_tpu_torch",
                           "info"], capture_output=True, text=True, cwd=root, timeout=300)
    imported = {ln.rsplit("|", 1)[-1].strip() for ln in info.stderr.splitlines()
                if ln.startswith("import time:")}
    foreign = sorted(n for n in imported if n.split(".")[0] in ("jax", "lambda_snark_tpu"))
    kind = torch.cuda.get_device_name(0)
    if info.returncode != 0 or kind not in info.stdout or foreign or not imported:
        raise RuntimeError(f"python -m lambda_snark_tpu_torch info: rc {info.returncode}, "
                           f"imported {foreign}: {info.stdout} {info.stderr[-2000:]}")
    phase(f"phase 25 python -m lambda_snark_tpu_torch info: names the card "
          f"({[ln for ln in info.stdout.splitlines() if kind in ln][0].strip()}); "
          f"{len(imported)} modules imported, none of jax or lambda_snark_tpu")
    tmp_dir.cleanup()
    return entries, record


# the multi-device layer's phase (26): the sharded prove step in a world of
# one under NCCL (26a) and in four ranks that share the card over gloo
# (26b, meshes (2, 2) and (1, 4)), the sharded service over phase 16's
# witnesses (26c), the dry run's legs on four ranks (26d), and kernel T's
# row entry at every shape 26a and 26b launched (26e)
SHARED_CARD = "4 ranks share one card; the collectives are staged through gloo"
SHARDED_MESHES = ((2, 2), (1, 4))
SHARDED_REPS = 20


def sharded_context(lst):
    """Phase 4's commitment context: ring n = 4096, k = 2, sigma = 3.19."""
    q = lst.NTT_FRIENDLY_MODULUS
    return lst.LweContext(lst.Params(lst.SecurityLevel.BITS128,
                                     lst.Profile.ring_b(n=RING_N, k=RING_K, q=q, sigma=SIGMA)),
                          context_seed=1)


def sharded_rank(evals, seed: int) -> dict:
    """One of 26b's ranks (all on the one card, over gloo): the sharded step
    on each mesh of ``SHARDED_MESHES`` over the (3, B, m) evaluations; per
    mesh, rank 0's outputs, this rank's launches of one ``run`` and its
    median step time; and whether jax or the JAX package was imported."""
    import torch
    import torch.distributed as dist

    import lambda_snark_tpu_torch as lst
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.ops.sampler import prng_key
    from lambda_snark_tpu_torch.parallel.mesh import make_mesh
    from lambda_snark_tpu_torch.parallel.pipeline_sharded import ShardedProver

    ctx = sharded_context(lst)
    out = {"foreign_modules": sorted(m for m in sys.modules if m.split(".")[0] in
                                     ("jax", "jaxlib", "lambda_snark_tpu"))}
    for shape in SHARDED_MESHES:
        mesh = make_mesh(shape, device="cuda")
        prover = ShardedProver(M_PLAIN, lst.NTT_FRIENDLY_MODULUS, ctx, mesh)
        blocks = [prover.shard(e) for e in evals]
        key = prng_key(seed & 0x7FFFFFFF)
        prover.run(*evals, seed)  # warm-up: plans, kernel loads
        torch.cuda.synchronize()
        dist.barrier()
        kernels.reset_launches()
        res = prover.run(*evals, seed)
        torch.cuda.synchronize()
        launches, shapes = kernels.launches(), dict(kernels.LAUNCHES)
        times = cuda_ms(torch, lambda: prover.step(*blocks, key), SHARDED_REPS, each=True)
        out[shape] = dict(launches=launches, shapes=shapes, step_ms=times,
                          outputs=[t.cpu() for t in res] if dist.get_rank() == 0 else None)
    return out


def multidevice_phase(np, torch, lst, dev, rng, hold, held, plain_stream, stream_rec,
                      smi: str):
    """Phase 26: the multi-device layer (``parallel/``) on the card. Returns
    (``kernels`` line entries, the record)."""
    import shutil

    import torch.distributed as dist

    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.commit.lwe import _ring_combine
    from lambda_snark_tpu_torch.entry import dryrun_multichip
    from lambda_snark_tpu_torch.ops import modarith
    from lambda_snark_tpu_torch.ops.sampler import prng_key, sample_signed
    from lambda_snark_tpu_torch.parallel.mesh import make_mesh
    from lambda_snark_tpu_torch.parallel.multihost import initialize_multihost, spawn_local
    from lambda_snark_tpu_torch.parallel.pipeline_sharded import ShardedProver
    from lambda_snark_tpu_torch.parallel.service import ShardedProofService
    from lambda_snark_tpu_torch.pipeline import prove_stage_batch
    from lambda_snark_tpu_torch.prover_batched import prove_plan, witness_words

    q = lst.NTT_FRIENDLY_MODULUS
    ctx = sharded_context(lst)
    r1cs, ws, stream_proofs = plain_stream
    record, entries = {"card": smi, "note": SHARED_CARD}, []
    # phase 16's first batch and its key (batch 0 of prove_r1cs_stream)
    seed0 = (SEED ^ 0x9E3779B97F4A7C15) & ((1 << 63) - 1)
    key = prng_key(seed0 & 0x7FFFFFFF)
    w = modarith.to_words(witness_words(ws[:BATCH], r1cs.n, q), dev)
    evals = r1cs.constraint_evals_batch(w)

    # --- 26a: a world of one under NCCL --------------------------------------------
    t = time.time()
    initialize_multihost(backend="nccl")
    try:
        mesh = make_mesh([1, 1], device="cuda")
        prover = ShardedProver(M_PLAIN, q, ctx, mesh)
        prover.run(*evals, seed0)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        out = prover.run(*evals, seed0)
        torch.cuda.synchronize()
        launches_a, shapes_a = kernels.launches(), dict(kernels.LAUNCHES)
        pp = prove_plan(r1cs, ctx, dev)
        want = prove_stage_batch(pp, *evals, key)
        flat = [prover.coeff_layout_to_flat(x) for x in out[:5]]
        if not (all(torch.equal(g, w_) for g, w_ in zip(flat, want[:5]))
                and torch.equal(out[7], want[5]) and bool(out[7].all())):
            raise RuntimeError("26a: the sharded step differs from prove_stage_batch")
        s = prover.coeff_layout_to_flat(out[5][:, :CHECK_ROWS]).cpu().numpy().astype(np.int64)
        e = prover.coeff_layout_to_flat(out[6][:CHECK_ROWS]).cpu().numpy().astype(np.int64)
        host = _ring_combine(ctx, s.transpose(1, 0, 2), e, modarith.to_u64(flat[0][:CHECK_ROWS]))
        if not np.array_equal(host, modarith.to_u64(flat[4][:CHECK_ROWS])):
            raise RuntimeError("26a: a commitment differs from the host's recomputation")
        if launches_a["ntt_rows"] < 1 or launches_a["ntt_rows"] > 20 or any(
                launches_a[e_] for e_ in ("quotient_q45", "quotient_goldilocks",
                                          "ring_commit_goldilocks")):
            raise RuntimeError(f"26a: launches {nonzero(launches_a)}")
        blocks = [prover.shard(x) for x in evals]
        sharded = cuda_ms(torch, lambda: prover.step(*blocks, key), SHARDED_REPS, each=True)
        single = cuda_ms(torch, lambda: prove_stage_batch(pp, *evals, key), SHARDED_REPS,
                         each=True)
        # where the step's time goes: its sampler call and its five sharded
        # transforms (all_to_alls included) alone at the step's shapes, the
        # rest (twists, products, sums, the validity count) by difference,
        # and one profiled step
        b_idx = torch.arange(BATCH, dtype=torch.int64, device=dev)
        pos = torch.arange(M_PLAIN, dtype=torch.int64, device=dev)
        x3, xk = torch.cat(blocks), torch.cat(blocks[:1] * RING_K)

        def transforms():
            prover.field.forward(prover.field.inverse(x3))
            prover.field.inverse(blocks[0])
            prover.ring.inverse(prover.ring.forward(xk))

        stages = dict(
            sampler=cuda_ms(torch, lambda: sample_signed(key, range(RING_K + 1), b_idx, pos,
                                                         prover.cdf), SHARDED_REPS, each=True),
            transforms=cuda_ms(torch, transforms, SHARDED_REPS, each=True))
        stages["rest"] = sharded - stages["sampler"] - stages["transforms"]
        trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                             "sharded_step_trace.json")
        os.makedirs(os.path.dirname(trace), exist_ok=True)
        wall, busy, top = device_busy(torch, lambda: prover.step(*blocks, key), trace)
        idle = None if busy is None else 1.0 - busy / wall
        record["26a"] = dict(step_ms=sharded, prove_stage_batch_ms=single, stages_ms=stages,
                             profiled_wall_s=wall, device_busy_s=busy, device_idle_share=idle,
                             top_kernels_ms=top, launches=nonzero(launches_a),
                             seconds=time.time() - t)
        phase(f"phase 26a ShardedProver mesh=(1x1) nccl m=n={M_PLAIN} B={BATCH}: Q, A, B, C, "
              f"commitment and valid bit-equal to prove_stage_batch (kernels Q and R); first "
              f"{CHECK_ROWS} commitments recomputed on the host from (s, e); launches "
              f"{nonzero(launches_a)} (Q and R 0); step {sharded:.3f} ms against "
              f"prove_stage_batch {single:.3f} ms (median of {SHARDED_REPS}, CUDA events; "
              f"{smi})")
        phase(f"phase 26a the step's parts (median of {SHARDED_REPS}, CUDA events): sampler "
              f"{stages['sampler']:.3f} ms, five sharded transforms {stages['transforms']:.3f} "
              f"ms, the rest {stages['rest']:.3f} ms; one profiled step {wall * 1e3:.3f} ms "
              f"wall, device busy "
              f"{'not measured' if busy is None else f'{busy * 1e3:.3f} ms, idle share {idle:.3f}'}"
              f"; most device time: {[(k, round(v, 4)) for k, v in top]}")

        # --- 26c: the service on 26a's mesh -----------------------------------------
        t = time.time()
        svc = ShardedProofService(r1cs, ctx, mesh, batch=BATCH, prover=prover)
        t_run = time.time()
        got = list(svc.prove_stream(ws, SEED))
        elapsed = time.time() - t_run
        if [i for i, _p in got] != list(range(len(ws))):
            raise RuntimeError("26c: the service's indices are out of order")
        for (i, p), w_i in zip(got, ws):
            if not lst.verify_r1cs(lst.deserialize_any(p.to_bytes()), r1cs.public_inputs(w_i),
                                   r1cs):
                raise RuntimeError(f"26c: proof {i} does not verify after deserialize_any")
        if [p.to_bytes() for _i, p in got[:BATCH]] != \
                [p.to_bytes() for p in stream_proofs[:BATCH]]:
            raise RuntimeError(f"26c: the first {BATCH} proofs differ from prove_r1cs_stream's")
        root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "svc_store")
        shutil.rmtree(root, ignore_errors=True)
        resume = lambda: ShardedProofService(r1cs, ctx, mesh, store=lst.ProofStore(root),
                                             batch=BATCH, prover=prover).prove_stream(ws, SEED)
        cut = resume()
        first = [next(cut)[1].to_bytes() for _ in range(STREAM_CUT)]
        cut.close()
        # the resumed run serves the stored proofs and proves the rest in
        # batches that start at the cut (their seeds fold the new leading
        # index, as in JAX); a third run serves every proof from the store
        again = [p.to_bytes() for _i, p in resume()]
        stored = [p.to_bytes() for _i, p in resume()]
        if (first != [p.to_bytes() for _i, p in got[:STREAM_CUT]] or again[:STREAM_CUT] != first
                or stored != again or len(lst.ProofStore(root).keys()) != len(ws)):
            raise RuntimeError("26c: the resumed service disagrees")
        for i in range(STREAM_CUT, len(ws)):
            if not lst.verify_r1cs(lst.deserialize_any(again[i]), r1cs.public_inputs(ws[i]), r1cs):
                raise RuntimeError(f"26c: resumed proof {i} does not verify")
        record["26c"] = dict(proofs=len(ws), seconds=elapsed, proofs_per_s=len(ws) / elapsed,
                             stream_proofs_per_s=stream_rec["proofs_per_s"])
        phase(f"phase 26c ShardedProofService mesh=(1x1) batch={BATCH}: {len(ws)} proofs in "
              f"order, each through deserialize_any and verify_r1cs; the first {BATCH} equal "
              f"prove_r1cs_stream's; a run cut after {STREAM_CUT}, then a full run, serves "
              f"those bytes from the store and proves the rest (verified), a third run serves "
              f"all {len(ws)}; {elapsed:.3f} s ({len(ws) / elapsed:.1f} proofs/s; phase 16's "
              f"stream {stream_rec['proofs_per_s']:.1f}; {smi}) [{time.time() - t:.0f}s]")
    finally:
        dist.destroy_process_group()

    # --- 26b: four ranks on the one card over gloo -----------------------------------
    t = time.time()
    ranks = spawn_local(4, sharded_rank, ([x.cpu() for x in evals], seed0), backend="gloo",
                        device="cuda")
    record["26b"] = {}
    for shape in SHARDED_MESHES:
        got = ranks[0][shape]["outputs"]
        if not (all(torch.equal(g.to(dev), w_) for g, w_ in zip(got, out))):
            raise RuntimeError(f"26b: mesh {shape} differs from 26a")
        for r, rank in enumerate(ranks):
            n_rows = rank[shape]["launches"]["ntt_rows"]
            if n_rows < 1 or n_rows > 20 or rank["foreign_modules"]:
                raise RuntimeError(f"26b: rank {r} launched {n_rows} ntt_rows, imported "
                                   f"{rank['foreign_modules']}")
        ms = [rank[shape]["step_ms"] for rank in ranks]
        tag = "x".join(map(str, shape))
        record["26b"][tag] = dict(step_ms_rank0=ms[0], step_ms_max=max(ms),
                                  launches=[nonzero(rank[shape]["launches"]) for rank in ranks])
        phase(f"phase 26b ShardedProver mesh=({tag}) gloo, 4 ranks on {dev}: outputs bit-equal "
              f"to 26a; each rank launched {[rk[shape]['launches']['ntt_rows'] for rk in ranks]} "
              f"ntt_rows, imported neither jax nor lambda_snark_tpu; step {ms[0]:.3f} ms on "
              f"rank 0, {max(ms):.3f} ms the slowest (median of {SHARDED_REPS}; {SHARED_CARD}; "
              f"{smi})")
    record["26b"]["seconds"] = time.time() - t

    # --- 26d: the dry run on four ranks ----------------------------------------------
    t = time.time()
    dry = dryrun_multichip(4, device="cuda", backend="gloo")
    run, by_shape = {}, {}
    for counts in dry["launches"] + [dry["reference_launches"]]:
        for e_, n_ in counts.items():
            run[e_] = run.get(e_, 0) + n_
    for (e_, _s, _v), n_ in dry["shapes"].items():
        by_shape[e_] = by_shape.get(e_, 0) + n_
    if nonzero(run) != by_shape:
        raise RuntimeError(f"26d: launches by shape {by_shape} != the processes' {nonzero(run)}")
    record["26d"] = dict(legs_s=dry["legs_s"], seconds=time.time() - t,
                         launches=[nonzero(x) for x in dry["launches"]],
                         reference_launches=nonzero(dry["reference_launches"]))
    phase(f"phase 26d dryrun_multichip(4) gloo on one card: legs {sorted(dry['legs_s'])} "
          f"passed in {time.time() - t:.0f}s ({SHARED_CARD}; {smi})")

    # --- 26e: every kernel at every shape 26a, 26b and 26d launched ------------------
    # (the dry run's kinds 7/8/9 commit over Goldilocks rings of degree m, k = 1)
    entries += hold_path_shapes(np, torch, lst, dev, rng, hold, dry["shapes"], held,
                                "dryrun_2x2", lambda n: kind7_context(lst, n), 26)
    entries += hold_path_shapes(np, torch, lst, dev, rng, hold, shapes_a, held, "sharded_1x1",
                                ctx, 26)
    for shape in SHARDED_MESHES:
        summed = {}
        for rank in ranks:
            for k_, n_ in rank[shape]["shapes"].items():
                summed[k_] = summed.get(k_, 0) + n_
        entries += hold_path_shapes(np, torch, lst, dev, rng, hold, summed, held,
                                    f"sharded_{'x'.join(map(str, shape))}", ctx, 26)
    return entries, record


# phase 27: the FRI chain (proof.fri_device.DEVICE_TRANSCRIPT, kernels S and
# F) against the per-layer route on every kind-7 and kind-8 shape of the
# script: (label, kind, m, statements, zk, pipeline_chunk). With the switch
# off the pipelined prover proves unchunked, as the JAX package's gate does.
CHAIN_SHAPES = (("k7a", 7, KIND7_M, KIND7_S, False, None),
                ("k7b", 7, KIND7_LONG_M, KIND7_S, False, None),
                ("k7a_zk", 7, KIND7_M, KIND7_S, True, None),
                ("agg13", 8, 1 << 13, 16, False, None),
                ("agg13_zk", 8, 1 << 13, 16, True, None),
                ("agg10", 8, 1 << 10, 128, False, None),
                ("pipelined_s64", 7, KIND7_M, 64, False, PIPE_CHUNK),
                ("pipelined_s128", 7, KIND7_M, 128, False, PIPE_CHUNK))
CHAIN_ORDER = (True, False, False, True, True, False)  # the switch, alternated
# kernel F's chain entry and kernel S's tail a batch on the chain, and
# kernel F a batch per layer: one fri_fold_squeeze a fold layer and one
# transcript_final_queries a chunk, and no other S or F entry; per layer one
# fri_fold a fold layer of the unchunked batch (the gate), no S
CHAIN_LAUNCHES = {"k7a": (7, 1, 7), "k7b": (8, 1, 8), "k7a_zk": (8, 1, 8), "agg13": (7, 1, 7),
                  "agg13_zk": (8, 1, 8), "agg10": (4, 1, 4), "pipelined_s64": (14, 2, 7),
                  "pipelined_s128": (28, 4, 7)}
SPONGE_STATEMENTS = (1, 16, 32, 128)
# kernel S's entries at the chain's default FriParams: a layer root, the
# final polynomial (final_len 64 and its length word), a fold challenge,
# the 30 query indices of an n0 = 2^16 codeword, and the chain's tail (the
# final polynomial's absorb and the 30 index squeezes in one launch)
SPONGE_CALLS = (("transcript_absorb", 4, "fri-layer-root"),
                ("transcript_absorb", 64, "fri-final head"),
                ("transcript_squeeze", 1, "fri-fold field"),
                ("transcript_squeeze", FRI_QUERIES, f"fri-query mask {(1 << 15) - 1}"),
                ("transcript_final_queries", 64,
                 f"fri-final fri-query {FRI_QUERIES} mask {(1 << 15) - 1}"))


def count_syncs(torch, fn):
    """(fn(), the host synchronisations PyTorch's sync debug mode reports
    while it runs)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def kernel_groups(launches: dict) -> dict:
    """Launches of kernels S, F, K and T in a run, from its per-entry counts."""
    return {"S": sum(launches[e] for e in SPONGE_ENTRIES),
            "F": sum(launches[e] for e in FOLD_ENTRIES),
            "K": sum(launches[e] for e in FOREST_ENTRIES + KECCAK_PER_LEVEL),
            "T": launches["ntt_rows"] + launches["ntt_four_step"]}


def sponge_phase(np, torch, dev, rng, hold, held) -> None:
    """Phase 27 (a): kernel S at S = 1, 16, 32 and 128 statements for each
    of its entries against its twin (``hold``) and hashlib."""
    import hashlib
    import struct

    from lambda_snark_tpu_torch.ops import modarith

    gl = modarith.GOLDILOCKS
    for s in SPONGE_STATEMENTS:
        for entry, width, variant in SPONGE_CALLS:
            key = (entry, (s, width), variant)
            fn, plain, args, work = chain_hold(np, dev, rng, entry, (s, width), variant)
            if key not in held:
                held[key] = hold(f"phase 27 kernel S {entry} S={s} {variant}", fn, plain, args,
                                 work, plain_reps=1, graph=True)
            got = fn(*args)
            states = modarith.to_u64(args[0])
            label = variant.split()[0].encode()
            for i in range(s):
                st = states[i].tobytes()
                if entry != "transcript_squeeze":  # an absorb first, then any squeezes
                    payload = modarith.to_u64(args[1][i]).tobytes()
                    head = struct.pack("<Q", width) if variant.endswith("head") or \
                        entry == "transcript_final_queries" else b""
                    st = hashlib.sha3_256(st + label + head + payload).digest()
                if entry == "transcript_absorb":
                    want, have = [st], [modarith.to_u64(got[i]).tobytes()]
                else:
                    squeeze = variant.split()[1].encode() if entry != "transcript_squeeze" \
                        else label
                    count = int(variant.split()[2]) if entry != "transcript_squeeze" else width
                    want, have = [], []
                    for k in range(count):
                        st = hashlib.sha3_256(st + squeeze + struct.pack("<Q", 7 + k)).digest()
                        first = int.from_bytes(st[:8], "little")
                        want.append(first % gl if variant.endswith("field")
                                    else first & int(variant.split()[-1]))
                    have = modarith.to_u64(got[1][i]).tolist()
                    want.append(st)
                    have.append(modarith.to_u64(got[0][i]).tobytes())
                if have != want:
                    raise RuntimeError(f"kernel S {entry} {variant}: row {i} of S={s} "
                                       "disagrees with hashlib.sha3_256")
    phase(f"phase 27 kernel S: every entry at S = {SPONGE_STATEMENTS} bit-exact against its "
          "twin and hashlib.sha3_256")


def check_fold_squeeze(np, dev, rng, shape, with_root: bool) -> None:
    """Kernel F's chain entry at (rows, n) against ``hashlib.sha3_256``:
    each row's new state is SHA3-256(SHA3-256(state || fri-layer-root ||
    root) || fri-fold || LE64(7)) (the inner hash without a root), its
    challenge that digest's first LE64 word mod p, and the fold the twin's
    with those challenges."""
    import hashlib
    import struct

    import torch

    from lambda_snark_tpu_torch.ops import fri_fold, modarith

    gl = modarith.GOLDILOCKS
    rows, n = shape
    words = lambda shp, high=1 << 64: modarith.to_words(
        rng.integers(0, high, size=shp, dtype=np.uint64, endpoint=False), dev)
    cur, inv_x, state = words(shape, gl), words((n // 2,), gl), words((rows, 4))
    root = words((rows, 4)) if with_root else None
    out, new = fri_fold.fold_squeeze(cur, inv_x, state, 7, root)
    states, cs = [], []
    for i, st in enumerate(modarith.to_u64(state)):
        st = st.tobytes()
        if with_root:
            st = hashlib.sha3_256(st + b"fri-layer-root"
                                  + modarith.to_u64(root[i]).tobytes()).digest()
        st = hashlib.sha3_256(st + b"fri-fold" + struct.pack("<Q", 7)).digest()
        states.append(st)
        cs.append(int.from_bytes(st[:8], "little") % gl)
    want = fri_fold.fold_plain(cur, inv_x, modarith.to_words(cs, dev))
    if [bytes(r) for r in modarith.to_u64(new)] != states or not torch.equal(out, want):
        raise RuntimeError(f"kernel F fri_fold_squeeze {rows}x{n} root={with_root}: the states, "
                           "challenges or words disagree with hashlib.sha3_256")


def chain_phase(np, torch, lst, dev, rng, hold, held, smi: str):
    """Phase 27: kernel S against hashlib; then every kind-7 and kind-8
    shape proved with ``DEVICE_TRANSCRIPT`` on (the chain) and off (the
    per-layer route) in turns: the bytes equal, the chain's proofs verify
    and tampered ones are rejected, per route the median of three batches,
    the idle share of one profiled batch, the launches of kernels S, F, K
    and T and the host synchronisations of one batch; fri_chain_dispatch
    under ``torch.cuda.set_sync_debug_mode("error")`` with one pull in
    fri_chain_finish; kernels S and F held at every shape the chain runs
    launched. Returns (``kernels`` line entries, the record)."""
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.proof import fri_device
    from lambda_snark_tpu_torch.proof import succinct_batch as sb
    from lambda_snark_tpu_torch.proof.aggregate import verify_r1cs_succinct_aggregate
    from lambda_snark_tpu_torch.proof.fri import FriParams
    from lambda_snark_tpu_torch.proof.succinct import verify_r1cs_succinct
    from lambda_snark_tpu_torch.proof.succinct_device import eval_device, quotient_lde_device

    sponge_phase(np, torch, dev, rng, hold, held)
    record, entries = {"card": smi}, []
    trace = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "chain_trace.json")
    try:
        for label, kind, m, s, zk, chunk in CHAIN_SHAPES:
            ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
            wits = kind7_witnesses(np, lst, dev, rng, s, m)
            seeds, blinds = list(range(700, 700 + s)), list(range(800, 800 + s))
            if kind == 7:
                prove = lambda: lst.prove_r1cs_succinct_batch(
                    r1cs, wits, ctx, seeds, zk, blinding_seeds=blinds if zk else None,
                    pipeline_chunk=chunk)
                blobs = lambda out: [p.to_bytes() for p in out]
            else:
                prove = lambda: lst.prove_r1cs_succinct_aggregate(
                    r1cs, wits, ctx, seeds, zk, blinding_seeds=blinds if zk else None)
                blobs = lambda out: [out.to_bytes()]
            rec, outs, per_entry = {}, {}, {}
            for on in (True, False):
                fri_device.DEVICE_TRANSCRIPT = on
                prove()  # a batch after one of another shape synchronises more often
                kernels.reset_launches()
                outs[on], syncs = count_syncs(torch, prove)
                per_entry[on] = launches = kernels.launches()
                if on:
                    shapes = dict(kernels.LAUNCHES)
                rec["chain" if on else "per_layer"] = dict(
                    launches=kernel_groups(launches), host_syncs_per_batch=syncs, times=[])
            folds, tails, layer_folds = CHAIN_LAUNCHES[label]
            on, off = per_entry[True], per_entry[False]
            want_on = {e: 0 for e in CHAIN_ENTRIES}
            want_on.update(fri_fold_squeeze=folds, transcript_final_queries=tails)
            want_off = {e: 0 for e in CHAIN_ENTRIES}
            want_off.update(fri_fold=layer_folds)
            if ({e: on[e] for e in CHAIN_ENTRIES} != want_on
                    or {e: off[e] for e in CHAIN_ENTRIES} != want_off):
                raise RuntimeError(f"phase 27 {label}: kernel S and F launches "
                                   f"{nonzero({e: on[e] for e in CHAIN_ENTRIES})} on the chain, "
                                   f"{nonzero({e: off[e] for e in CHAIN_ENTRIES})} per layer; "
                                   f"want {nonzero(want_on)} and {nonzero(want_off)}")
            chain, per_layer, chain_out = rec["chain"], rec["per_layer"], outs[True]
            if blobs(chain_out) != blobs(outs[False]):
                raise RuntimeError(f"phase 27 {label}: the chain and the per-layer route differ")
            if kind == 7:
                if not all(verify_r1cs_succinct(p, [1], r1cs) for p in chain_out):
                    raise RuntimeError(f"phase 27 {label}: a chain proof does not verify")
                reject_tampered(chain_out[0], r1cs, lst.NTT_MODULUS, f"phase 27 {label}")
            else:
                if not verify_r1cs_succinct_aggregate(chain_out, [[1]] * s, r1cs):
                    raise RuntimeError(f"phase 27 {label}: the chain's aggregate does not verify")
                reject_tampered_aggregate(chain_out, r1cs, f"phase 27 {label}")
            for on in CHAIN_ORDER:
                fri_device.DEVICE_TRANSCRIPT = on
                torch.cuda.synchronize()
                t = time.time()
                prove()
                rec["chain" if on else "per_layer"]["times"].append(time.time() - t)
            for on in (True, False):
                fri_device.DEVICE_TRANSCRIPT = on
                wall, busy, _top = device_busy(torch, prove, trace)
                route = rec["chain" if on else "per_layer"]
                route.update(median_s=sorted(route["times"])[len(route["times"]) // 2],
                             profiled_wall_s=wall, device_busy_s=busy,
                             device_idle_share=None if busy is None else 1.0 - busy / wall)
            fri_device.DEVICE_TRANSCRIPT = True
            record[label] = dict(kind=kind, m=m, statements=s, zk=zk, chunk=chunk, **rec)

            def fmt(r, s=s):
                idle = r["device_idle_share"]
                return (f"median {r['median_s']:.4f} s ({s / r['median_s']:.2f} proofs/s), "
                        f"idle share {idle if idle is None else round(idle, 3)}, "
                        f"launches {r['launches']}, host syncs {r['host_syncs_per_batch']}")

            phase(f"phase 27 {label} m={m} S={s} zk={zk} chunk={chunk}: byte-identical on both "
                  f"routes, verified, tampered rejected; chain {fmt(chain)}; per-layer "
                  f"{fmt(per_layer)}")
            chain_shapes = {k: v for k, v in shapes.items() if k[0] in CHAIN_ENTRIES}
            entries += hold_path_shapes(np, torch, lst, dev, rng, hold, chain_shapes, held,
                                        f"chain_{label}", ctx, 27)
            # kernel F's chain entry with and without a root at each of its shapes
            for entry, shape, _v in list(chain_shapes):
                if entry != "fri_fold_squeeze":
                    continue
                for variant in ("", "root"):
                    key = (entry, shape, variant)
                    if key not in held:
                        fn, plain, args, work = chain_hold(np, dev, rng, entry, shape, variant)
                        held[key] = hold(f"phase 27 kernel F {entry} {'x'.join(map(str, shape))} "
                                         f"{variant}".rstrip(), fn, plain, args, work,
                                         plain_reps=1, graph=True)
                        check_fold_squeeze(np, dev, rng, shape, variant == "root")
            phase(f"phase 27 {label}: kernel S {tails} and F {folds} launches a batch as "
                  "CHAIN_LAUNCHES; fri_fold_squeeze with and without a root at each of its "
                  "shapes bit-exact against its twin and hashlib.sha3_256")
    finally:
        fri_device.DEVICE_TRANSCRIPT = True

    # the chain of one k7a batch from dispatch to finish: no host
    # synchronisation while it is enqueued, one pull in fri_chain_finish
    m, s = KIND7_M, KIND7_S
    ctx, r1cs = kind7_context(lst, m), kind7_circuit(lst, m)
    wits = kind7_witnesses(np, lst, dev, rng, s, m)
    seeds = list(range(700, 700 + s))
    params = FriParams()
    d_bound, n0, omega_n = sb._check_instance(r1cs, params, 0)
    offset = sb.coset_offset(lst.NTT_MODULUS)
    lde, comms, polys, forest = quotient_lde_device(*sb._embed_and_eval(r1cs, wits, dev), n0,
                                                    offset, ctx, seeds)
    chals, alphas, betas = sb._derive_batch_challenges(r1cs, wits, comms, forest.roots,
                                                       lst.NTT_MODULUS)
    evals = eval_device(polys, alphas, betas)
    trs, lams = sb._seed_batch_transcripts(lst.NTT_MODULUS, m, 0, params, d_bound, forest.roots,
                                           alphas, betas, evals)
    g = fri_device.deep_combine_device(lde, alphas, betas, lams, evals, offset, omega_n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t = time.perf_counter()
        bundle, layout = fri_device.fri_chain_dispatch(g, [(lde, forest)], offset, omega_n,
                                                       lst.NTT_MODULUS, params, trs)
        enqueue_ms = (time.perf_counter() - t) * 1e3
    finally:
        torch.cuda.set_sync_debug_mode("default")
    proofs, pulls = count_syncs(torch, lambda: fri_device.fri_chain_finish(bundle, layout))
    if pulls != 1:
        raise RuntimeError(f"phase 27: fri_chain_finish synchronised {pulls} times, not once")
    want = lst.prove_r1cs_succinct_batch(r1cs, wits, ctx, seeds)
    if [p.to_bytes() for p in proofs] != [p.fri.to_bytes() for p in want]:
        raise RuntimeError("phase 27: the staged chain differs from the entry point's proofs")
    record["sync_check_k7a"] = dict(dispatch_enqueue_ms=enqueue_ms, finish_host_syncs=pulls)
    # kernels S and F at each held shape: device ms, the throughput bound
    # (bytes or operations) and the latency bound (the chained Keccak-fs)
    record["s_and_f_bounds"] = {
        f"{entry} {'x'.join(map(str, shape))} {variant}".rstrip(): dict(
            ms=r["ms"], throughput_bound_ms=r["bound_ms"], throughput_bound_by=r["bound_by"],
            latency_bound_ms=latency_ms(entry, shape, variant),
            bound_by="latency" if latency_ms(entry, shape, variant) > r["bound_ms"]
            else r["bound_by"])
        for (entry, shape, variant), r in held.items() if entry in CHAIN_ENTRIES}
    phase(f"phase 27 fri_chain_dispatch at k7a under set_sync_debug_mode('error'): no host "
          f"synchronisation ({enqueue_ms:.3f} ms to enqueue), fri_chain_finish one pull, the "
          f"FRI proofs those of prove_r1cs_succinct_batch")
    return entries, record


# the port's examples and last public names (28): the three examples of
# ``examples/torch_*.py`` on the card against a CPU run, ``randomness_batch``
# on the multi-key ChaCha20 blocks against the per-seed loop at the
# kinds-2/3 width, and kind 7 with ``GL_FAST_FRONTEND`` off
EXAMPLES = {  # example -> the kernels (by source) its path must launch
    "torch_batch_proving": ("Q", "R"),
    "torch_proof_service": ("Q", "R", "T"),
    "torch_succinct_openings": ("Q", "R", "K", "T", "S", "F"),
}
RANDOMNESS_SEEDS, RANDOMNESS_REPS = 256, 3
GL_OFF_M, GL_OFF_S = 1 << 10, 2


def source_groups(kernels, launches: dict) -> dict:
    """Launches of kernels Q, R, K, T, S and F in a run, from its per-entry
    counts (Q, R, K and T by source file, S and F by entry)."""
    by_file = lambda name: sum(launches.get(e, 0) for e in kernels.PROTOTYPES[name])
    return {"Q": by_file("quotient"), "R": by_file("ring_commit"), "K": by_file("keccak"),
            "T": by_file("ntt"), "S": sum(launches.get(e, 0) for e in SPONGE_ENTRIES),
            "F": sum(launches.get(e, 0) for e in FOLD_ENTRIES)}


def examples_phase(np, torch, lst, rng, smi: str) -> dict:
    """Phase 28: the three examples' ``main`` on the card (each asserts what
    the JAX package's example asserts; the proof service's four ranks share
    the card over gloo) with the launches of each run, the same ``main``
    with ``--device cpu`` (equal bytes); ``randomness_batch`` against the
    per-seed loop at n = 4096, k = 2, S = 256 (equal draws, host times);
    kind 7 at m = 2^10, S = 2 with ``GL_FAST_FRONTEND`` off (the host
    route) against the device route (equal bytes), the switch on again
    after. Returns the record."""
    import importlib

    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.commit import lwe
    from lambda_snark_tpu_torch.proof import succinct

    record = {"examples": {}}
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples"))
    total = {}
    for name, needed in EXAMPLES.items():
        mod = importlib.import_module(name)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.time()
        card = mod.main([])
        torch.cuda.synchronize()
        elapsed = time.time() - t
        launches = kernels.launches()
        for rank in card.get("rank_launches", []):
            launches = {e: n + rank.get(e, 0) for e, n in launches.items()}
        groups = source_groups(kernels, launches)
        if [g for g in needed if groups[g] < 1]:
            raise RuntimeError(f"28: {name} did not launch each of {needed}: {groups}")
        cpu = mod.main(["--device", "cpu"])
        for key, value in card.items():
            if key not in ("seconds", "rank_launches") and value != cpu[key]:
                raise RuntimeError(f"28: {name}'s {key} on the card differs from the CPU run")
        total = {g: total.get(g, 0) + n for g, n in groups.items()}
        record["examples"][name] = dict(end_to_end_s=elapsed, launches=nonzero(launches),
                                        kernels=groups, reported_s=card.get("seconds"))
        phase(f"phase 28 {name}: its assertions held on the card and its bytes equal a "
              f"--device cpu run; launches {groups}; {elapsed:.3f} s end to end "
              f"(host clock; {smi})")
    if [g for g in ("Q", "R", "K", "T") if total[g] < 1]:
        raise RuntimeError(f"28: the examples did not launch each of Q, R, K and T: {total}")

    ctx = sharded_context(lst)
    seeds = [int(x) for x in rng.integers(0, 1 << 63, size=RANDOMNESS_SEEDS)]
    times = {"batched": [], "per_seed": []}
    for rep in range(RANDOMNESS_REPS):
        for route in (("batched", "per_seed") if rep % 2 == 0 else ("per_seed", "batched")):
            t = time.perf_counter()
            if route == "batched":
                ss, es = lwe.randomness_batch(ctx, seeds)
            else:
                draws = [ctx._randomness(seed) for seed in seeds]
            times[route].append(time.perf_counter() - t)
    if not (np.array_equal(ss, np.stack([d[0] for d in draws]))
            and np.array_equal(es, np.stack([d[1] for d in draws]))):
        raise RuntimeError("28: randomness_batch differs from the per-seed loop")
    med = {route: sorted(v)[len(v) // 2] for route, v in times.items()}
    record["randomness_batch"] = dict(n=ctx.n, k=ctx.k, seeds=RANDOMNESS_SEEDS,
                                      host_s=times, median_s=med)
    phase(f"phase 28 randomness_batch n={ctx.n} k={ctx.k} S={RANDOMNESS_SEEDS}: draws equal "
          f"the per-seed loop's; host medians of {RANDOMNESS_REPS} in turns: multi-key blocks "
          f"{med['batched']:.4f} s, per-seed loop {med['per_seed']:.4f} s (host times of the "
          f"card's machine)")

    r1cs = kind7_circuit(lst, GL_OFF_M)
    ctx7 = kind7_context(lst, GL_OFF_M)
    ws = [[int(v) for v in row] for row in kind7_witnesses(np, lst, torch.device("cuda"), rng,
                                                            GL_OFF_S, GL_OFF_M)]
    seeds7 = list(range(1, GL_OFF_S + 1))
    device_route = lst.prove_r1cs_succinct_batch(r1cs, ws, ctx7, seeds7)
    kernels.reset_launches()
    succinct.GL_FAST_FRONTEND = False
    try:
        t = time.time()
        host_route = lst.prove_r1cs_succinct_batch(r1cs, ws, ctx7, seeds7)
        host_s = time.time() - t
    finally:
        succinct.GL_FAST_FRONTEND = True
    host_launches = kernels.launches()
    if succinct.GL_FAST_FRONTEND is not True:
        raise RuntimeError("28: GL_FAST_FRONTEND is not back on")
    if [p.to_bytes() for p in host_route] != [p.to_bytes() for p in device_route]:
        raise RuntimeError("28: kind 7 with GL_FAST_FRONTEND off differs from the device route")
    for w, p in zip(ws, host_route):
        if not lst.verify_r1cs_succinct(p, r1cs.public_inputs(w), r1cs):
            raise RuntimeError("28: a host-route kind-7 proof does not verify")
    record["gl_fast_frontend_off"] = dict(m=GL_OFF_M, s=GL_OFF_S, host_s=host_s,
                                          launches=nonzero(host_launches))
    phase(f"phase 28 kind 7 m={GL_OFF_M} S={GL_OFF_S} with GL_FAST_FRONTEND off: the host "
          f"route's bytes equal the device route's, every proof verifies, {host_s:.3f} s "
          f"(host clock), launches {nonzero(host_launches)}; the switch is on again")
    return record


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import lambda_snark_tpu_torch as lst
    except ImportError as exc:
        print(f"chip_smoke: the port's package is missing: {exc}", file=sys.stderr)
        return 2
    from lambda_snark_tpu_torch import kernels
    from lambda_snark_tpu_torch.commit.lwe_device import sample_randomness
    from lambda_snark_tpu_torch.core.params import NTT_FRIENDLY_MODULUS, NTT_MODULUS
    from lambda_snark_tpu_torch.ops import modarith
    from lambda_snark_tpu_torch.ops.quotient import QuotientPlan, quotient, quotient_plain
    from lambda_snark_tpu_torch.ops.ring_commit import ring_commit, ring_commit_plain
    from lambda_snark_tpu_torch.ops.sampler import prng_key
    from lambda_snark_tpu_torch.pipeline import field_psi_for, prove_stage_batch
    from lambda_snark_tpu_torch.prover_batched import (
        assemble_proofs,
        prove_plan,
        prove_r1cs_batched,
        witness_words,
    )

    if "jax" in sys.modules or "lambda_snark_tpu" in sys.modules:
        raise RuntimeError("the port pulled in jax or lambda_snark_tpu")
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase(f"phase 1 device: {kind} (count {count}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(smi, flush=True)

    t = time.time()
    native = native_build_start()
    paths = kernels.build()
    phase(f"phase 2 build: {len(paths)} libraries in {time.time() - t:.1f}s "
          f"under {os.path.relpath(kernels.build_dir())}")
    phase(f"phase 2 native host library: {native_build_finish(native)}")
    for name in paths:
        with open(os.path.join(kernels.build_dir(), f"lib{name}.log")) as f:
            for fn, regs, spills in ptxas_resources(f.read()):
                print(f"  {name} {fn}: {regs}; {spills}", flush=True)
    for name in ("ntt", "keccak", "quotient", "ring_commit", "fri"):
        for fn, mix in sass_mix(paths[name]).items():
            if any(k in fn for k in ("dft_pass", "forest_kernelILi1E", "forest_kernelILi2E",
                                     "forest_kernelILi4E", "forest_kernelILi5E",
                                     "forest_kernelILi6E", "quotient_kernel",
                                     "ring_commit_kernel", "sponge_kernel", "fold_kernel",
                                     "fold_squeeze_kernel")):
                print(f"  {name} SASS {fn}: {mix}", flush=True)

    rng = np.random.default_rng(SEED)
    report = {}

    def hold(label: str, fn, plain, args, work, plain_reps: int = 3, graph: bool = False) -> dict:
        """Run a kernel and its plain twin on the same card tensors, demand
        equal outputs, then time both; ``work`` is (bytes, 32-bit ops).
        With ``plain_reps=1`` the twin's time is its comparison call's,
        between CUDA events (the twins take up to seconds a call). With
        ``graph`` the kernel's time is ``graph_ms``'s (kernels S and F)."""
        got = fn(*args)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        want = plain(*args)
        end.record()
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(max_abs_err(np, modarith, g.to(torch.int64), w.to(torch.int64))
                  for g, w in zip(got, want))
        if (err != 0.0 or len(got) != len(want)
                or not all(torch.equal(g, w) for g, w in zip(got, want))):
            raise RuntimeError(f"{label} disagrees with its plain twin (max |err| {err})")
        del got, want
        ms = (graph_ms if graph else cuda_ms)(torch, lambda: fn(*args), 20)
        plain_ms = start.elapsed_time(end) if plain_reps == 1 else \
            cuda_ms(torch, lambda: plain(*args), plain_reps)
        bms, by = bound_ms(*work)
        phase(f"{label}: bit-exact; {ms:.4f} ms (plain {plain_ms:.2f} ms, "
              f"bound {bms:.4f} ms by {by})")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, max_abs_err=err)

    # --- phase 3: kernel Q against its plain twin, both fields, and the ----
    # --- 44-bit field at the ZK path's m ------------------------------------
    for key_, field_name, q, m in (("quotient_q45", "q45", NTT_FRIENDLY_MODULUS, M_PLAIN),
                                   ("quotient_q45_zk", "q45", NTT_FRIENDLY_MODULUS, M_ZK),
                                   ("quotient_goldilocks", "goldilocks", NTT_MODULUS, M_PLAIN)):
        plan = QuotientPlan.create(m, q, field_psi_for(m, q), device=dev)
        a = modarith.to_words(rng.integers(1, q, size=(BATCH, m), dtype=np.uint64), dev)
        b = modarith.to_words(rng.integers(1, q, size=(BATCH, m), dtype=np.uint64), dev)
        c = modarith.mul_mod(a, b, q)
        c[3, 5] = modarith.add_mod(c[3:4, 5:6], torch.ones_like(c[3:4, 5:6]), q)[0, 0]
        valid = quotient(plan, a, b, c)[4]
        if valid.sum().item() != BATCH - 1 or valid[3].item():
            raise RuntimeError("kernel Q validity flags wrong")
        cluster = cluster_of(kernels, BATCH, m, 3)
        report[key_] = hold(f"phase 3 kernel Q {field_name} m={m} B={BATCH} cluster={cluster}",
                            lambda *x, plan=plan: quotient(plan, *x),
                            lambda *x, plan=plan: quotient_plain(plan, *x),
                            (a, b, c), quotient_work(BATCH, m, field_name))
        report[key_]["cluster"] = cluster

    # --- phase 4: kernel R against its plain twin, at both message lengths --
    q = NTT_FRIENDLY_MODULUS
    ctx = lst.LweContext(
        lst.Params(lst.SecurityLevel.BITS128,
                   lst.Profile.ring_b(n=RING_N, k=RING_K, q=q, sigma=SIGMA)),
        context_seed=1,
    )
    r1cs = lst.multiplication_gates_circuit(M_PLAIN, q)
    pp = prove_plan(r1cs, ctx, dev)
    ring = pp.dctx.ring
    s = torch.from_numpy(rng.integers(-39, 40, size=(RING_K, BATCH, RING_N), dtype=np.int32)).to(dev)
    e = torch.from_numpy(rng.integers(-39, 40, size=(BATCH, RING_N), dtype=np.int32)).to(dev)
    # the plain prover commits to Q (m words), the ZK prover to Q' (m + 1)
    for key_, msg_len in (("ring_commit", M_PLAIN), ("ring_commit_zk", M_ZK + 1)):
        msg = modarith.to_words(rng.integers(0, q, size=(BATCH, msg_len), dtype=np.uint64), dev)
        cluster = cluster_of(kernels, BATCH, RING_N, 2)
        report[key_] = hold(
            f"phase 4 kernel R n={RING_N} k={RING_K} B={BATCH} msg_len={msg_len} "
            f"cluster={cluster}",
            lambda *x: ring_commit(ring, *x), lambda *x: ring_commit_plain(ring, *x),
            (s, e, msg), ring_work(BATCH, RING_N, RING_K, msg_len))
        report[key_]["cluster"] = cluster

    # --- phases 5 and 6: the batched prover ---------------------------------
    def witnesses(m: int) -> np.ndarray:
        wa = rng.integers(1, q, size=(BATCH, m), dtype=np.uint64)
        wb = rng.integers(1, q, size=(BATCH, m), dtype=np.uint64)
        wc = modarith.to_u64(modarith.mul_mod(modarith.to_words(wa, dev),
                                              modarith.to_words(wb, dev), q))
        return np.concatenate([np.ones((BATCH, 1), np.uint64), wa, wb, wc], axis=1)

    def check_identity(proofs, m: int, zk: bool) -> None:
        for i, p in enumerate(proofs):
            for x, a_, b_, c_, qv in (
                (p.challenge_alpha.alpha, p.a_z_alpha, p.b_z_alpha, p.c_z_alpha,
                 p.q_prime_alpha if zk else p.q_alpha),
                (p.challenge_beta.alpha, p.a_z_beta, p.b_z_beta, p.c_z_beta,
                 p.q_prime_beta if zk else p.q_beta),
            ):
                z = (pow(x, m, q) - 1) % q
                if zk:
                    qv = (qv - p.blinding_factor * z) % q
                if (a_ * b_ - c_ - qv * z) % q != 0:
                    raise RuntimeError(f"proof {i}: a b - c != Q (x^m - 1)")

    stage = {}
    for label, m, zk in (("plain", M_PLAIN, False), ("zk", M_ZK, True)):
        circuit = r1cs if m == M_PLAIN else lst.multiplication_gates_circuit(m, q)
        w = witnesses(m)
        prove_r1cs_batched(circuit, w, ctx, seed=SEED, zk=zk)  # warm-up
        cpu = prove_r1cs_batched(circuit, w[:CHECK_ROWS], ctx, seed=SEED, zk=zk, device="cpu")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t = time.time()
        proofs = prove_r1cs_batched(circuit, w, ctx, seed=SEED, zk=zk)
        elapsed = time.time() - t
        launches = kernels.launches()
        if min(launches["quotient_q45"], launches["ring_commit_goldilocks"]) < 1:
            raise RuntimeError(f"{label}: a kernel of the path was not launched: {launches}")
        if len(proofs) != BATCH:
            raise RuntimeError(f"{label}: {len(proofs)} proofs for {BATCH} witnesses")
        check_identity(proofs, m, zk)
        for i in range(CHECK_ROWS):
            if proofs[i].to_bytes() != cpu[i].to_bytes():
                raise RuntimeError(f"{label}: proof {i} differs from the CPU run")
        stage[label] = dict(m=m, launches=launches, end_to_end_s=elapsed)
        phase(f"phase {5 if not zk else 6} prove_r1cs_batched {label} m={m} n={RING_N} "
              f"B={BATCH}: {BATCH} proofs hold a b - c = Q Z_H at alpha and beta, first "
              f"{CHECK_ROWS} byte-identical to the CPU run; launches {nonzero(launches)}; "
              f"{elapsed:.3f} s end to end ({BATCH / elapsed:.1f} proofs/s)")

    # --- phase 7: device-stage and sampler times, the kernels line ----------
    # host-clock breakdown of one plain batch: SpMV, device stage, assembly
    w_host = witnesses(M_PLAIN)
    key = prng_key(SEED)
    breakdown = {}
    torch.cuda.synchronize()
    t = time.time()
    w = modarith.to_words(witness_words(w_host, r1cs.n, q), dev)
    a_e, b_e, c_e = r1cs.constraint_evals_batch(w)
    torch.cuda.synchronize()
    breakdown["witness_and_spmv_s"] = time.time() - t
    t = time.time()
    out = prove_stage_batch(pp, a_e, b_e, c_e, key)
    torch.cuda.synchronize()
    breakdown["device_stage_s"] = time.time() - t
    t = time.time()
    assemble_proofs(r1cs, w_host, out, zk=False, blinding=None)
    breakdown["assembly_s"] = time.time() - t
    stage_ms = cuda_ms(torch, lambda: prove_stage_batch(pp, a_e, b_e, c_e, key), 5)
    sampler_ms = cuda_ms(torch, lambda: sample_randomness(pp.dctx, key, BATCH), 5)
    src = "lambda_snark_tpu_torch/csrc"
    # one entry per kernel and path: the plain prover (m = 4096) and the ZK
    # prover (m = 2048, message m + 1); launches are that path's run's count
    quotient_src = ("lambda_snark_tpu/ops/ntt_mxu_q45.py:466; "
                    "lambda_snark_tpu/ops/quotient_pallas.py:143")
    ring_src = "lambda_snark_tpu/ops/ring_mxu.py:229; lambda_snark_tpu/ops/ring_pallas.py:230"
    entries = []
    for path in ("plain", "zk"):
        sfx = "" if path == "plain" else "_zk"
        entries += [
            dict(name=f"quotient_q45{sfx}", route="cuda", source=f"{src}/quotient.cu",
                 replaces=quotient_src, launches=stage[path]["launches"]["quotient_q45"],
                 **report[f"quotient_q45{sfx}"], library_ms=None),
            dict(name=f"ring_commit_goldilocks{sfx}", route="cuda",
                 source=f"{src}/ring_commit.cu", replaces=ring_src,
                 launches=stage[path]["launches"]["ring_commit_goldilocks"],
                 **report[f"ring_commit{sfx}"], library_ms=None),
        ]
    phase(f"phase 7 device stage m={M_PLAIN} B={BATCH}: {stage_ms:.3f} ms "
          f"({BATCH / stage_ms * 1e3:.1f} proofs/s); threefry sampler {sampler_ms:.3f} ms; "
          f"kernel Q goldilocks {report['quotient_goldilocks']['ms']:.4f} ms")
    phase(f"phase 7 host-clock breakdown of one batch: {breakdown}")
    print(json.dumps({"device_stage_ms": stage_ms, "sampler_ms": sampler_ms,
                      "breakdown_s": breakdown,
                      "end_to_end_s": {k: v["end_to_end_s"] for k, v in stage.items()}}),
          flush=True)

    k7, k7a_shapes, kind7 = kind7_phases(np, torch, lst, dev, rng, hold, report)
    entries += hold_forests(np, torch, dev, rng, hold, k7a_shapes, "phase 11 kind7")
    forests = forest_times(np, torch, dev, rng, k7a_shapes, "phase 11 kind7")
    keccak_src = KECCAK_SRC
    # launches: the kind-7 run's count of the entry that serves the shape.
    # Its only four-step transform is the n0 = 2^16-point LDE and its only
    # leaf transform the final polynomials (S x 512), so the 2^20 and the
    # B = 128 shapes (more calls of the same entries) have none of them;
    # kernel K's per-level entries are no longer on the path (0).
    for name, rep, src_file, replaces, launches in (
            ("keccak_group_leaves", "keccak_group_leaves", "keccak.cu", keccak_src,
             k7["keccak_group_leaves"]),
            ("keccak_leaves", "keccak_leaves", "keccak.cu", keccak_src, k7["keccak_leaves"]),
            ("keccak_nodes", "keccak_nodes", "keccak.cu", keccak_src, k7["keccak_nodes"]),
            ("ntt_goldilocks", "ntt_goldilocks", "ntt.cu",
             "lambda_snark_tpu/ops/ntt_mxu.py:631", k7["ntt_four_step"]),
            ("ntt_goldilocks_2pow20", "ntt_goldilocks_2pow20", "ntt.cu",
             "lambda_snark_tpu/ops/ntt_mxu.py:631", 0),
            ("ntt_goldilocks_leaf", "ntt_goldilocks_leaf", "ntt.cu",
             "lambda_snark_tpu/ops/ntt_mxu.py:378", 0),
            ("ntt_goldilocks_leaf_kind7", "ntt_goldilocks_leaf_kind7", "ntt.cu",
             "lambda_snark_tpu/ops/ntt_mxu.py:378", k7["ntt_rows"]),
            ("quotient_goldilocks_kind7", "quotient_goldilocks_kind7", "quotient.cu",
             "lambda_snark_tpu/ops/quotient_pallas.py:143", k7["quotient_goldilocks"]),
            ("ring_commit_goldilocks_kind7", "ring_commit_kind7", "ring_commit.cu",
             ring_src, k7["ring_commit_goldilocks"])):
        entries.append(dict(name=name, route="cuda", source=f"{src}/{src_file}",
                            replaces=replaces, launches=launches, **report[rep],
                            library_ms=None))
    kernel_t_phases(np, torch, lst, dev, rng, hold, report)
    k7_long, k7_shapes, kind7_long = kind7_long_phase(np, torch, lst, rng)
    # kernel T: each held shape and direction gets the m = 2^14 kind-7
    # path's launches of its entry at that shape and direction
    # (kernels.LAUNCHES); shapes the path does not run get 0
    pallas_src = "lambda_snark_tpu/ops/ntt_pallas.py:126"
    shaped = []
    for key_, rep in list(report.items()):
        if key_.startswith(("ntt_rows_", "ntt_four_step_")):
            rep = dict(rep)
            entry = rep.pop("entry")
            launches = k7_shapes.get((entry, rep.pop("shape"), rep.pop("variant")), 0)
            shaped.append(dict(name=key_, route="cuda", source=f"{src}/ntt.cu",
                               replaces=pallas_src, launches=launches, **rep,
                               library_ms=None))
    shaped += kind7_long_shapes_phase(np, torch, lst, dev, rng, hold, k7_shapes, report)
    forests += forest_times(np, torch, dev, rng, k7_shapes, "phase 15 kind7")
    # every launch of kernels K and T on the m = 2^14 path is in the line,
    # under the shape it was held at
    for entry in FOREST_ENTRIES + ("ntt_four_step", "ntt_rows"):
        listed = sum(e["launches"] for e in shaped if e["name"].startswith(entry + "_"))
        if listed != k7_long[entry]:
            raise RuntimeError(f"kind 7 at m=2^14: {entry} launched {k7_long[entry]} times, "
                               f"{listed} of them at a held shape")
    entries += shaped
    phase(f"phase 15 kernels K and T held at each of the {len(k7_shapes)} (entry, shape, "
          f"direction) triples of the m={KIND7_LONG_M} run; every launch of theirs listed")
    st, stream, plain_stream = stream_phases(np, torch, lst, dev, rng, ctx, q)
    for name, rep, src_file, replaces, launches in (
            ("quotient_long_kind7_2pow14", "quotient_long", "quotient.cu",
             "lambda_snark_tpu/ops/quotient_pallas.py:143; " + pallas_src,
             k7_long["quotient_pointwise"]),
            ("quotient_pointwise_kind7_2pow14", "quotient_pointwise", "quotient.cu",
             "lambda_snark_tpu/ops/quotient_pallas.py:143", k7_long["quotient_pointwise"]),
            ("ring_commit_long_kind7_2pow14", "ring_commit_long", "ring_commit.cu",
             ring_src + "; " + pallas_src, k7_long["ring_finish"]),
            ("ring_twist_kind7_2pow14", "ring_twist", "ring_commit.cu", ring_src,
             k7_long["ring_twist"]),
            ("ring_accumulate_kind7_2pow14", "ring_accumulate", "ring_commit.cu", ring_src,
             k7_long["ring_accumulate"]),
            ("ring_finish_kind7_2pow14", "ring_finish", "ring_commit.cu", ring_src,
             k7_long["ring_finish"]),
            ("quotient_goldilocks_kind7_2pow14", "quotient_goldilocks_kind7_2pow14",
             "quotient.cu", "lambda_snark_tpu/ops/quotient_pallas.py:143",
             k7_long["quotient_goldilocks"]),
            ("ring_commit_goldilocks_kind7_2pow14", "ring_commit_goldilocks_kind7_2pow14",
             "ring_commit.cu", ring_src, k7_long["ring_commit_goldilocks"]),
            ("quotient_goldilocks_2pow16", "quotient_goldilocks_2pow16", "quotient.cu",
             "lambda_snark_tpu/ops/quotient_pallas.py:143", 0),
            ("ring_commit_goldilocks_2pow16", "ring_commit_goldilocks_2pow16", "ring_commit.cu",
             ring_src, 0),
            ("quotient_q45_stream", "quotient_q45", "quotient.cu", quotient_src,
             st["stream"]["quotient_q45"]),
            ("ring_commit_goldilocks_stream", "ring_commit", "ring_commit.cu", ring_src,
             st["stream"]["ring_commit_goldilocks"]),
            ("quotient_q45_stream_zk", "quotient_q45_zk", "quotient.cu", quotient_src,
             st["stream_zk"]["quotient_q45"]),
            ("ring_commit_goldilocks_stream_zk", "ring_commit_zk", "ring_commit.cu", ring_src,
             st["stream_zk"]["ring_commit_goldilocks"])):
        entries.append(dict(name=name, route="cuda", source=f"{src}/{src_file}",
                            replaces=replaces, launches=launches, **report[rep],
                            library_ms=None))
    held = {(r["entry"], tuple(r["shape"]), r["variant"]):
            {k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            for r in report.values() if "entry" in r}
    ctx7 = kind7_context(lst, KIND7_M)
    zk_launches, zk_shapes, kind7_zk = kind7_zk_phase(np, torch, lst, dev, rng)
    entries += hold_path_shapes(np, torch, lst, dev, rng, hold, zk_shapes, held, "kind7_zk",
                                ctx7, 18)
    pipe_launches, pipe_shapes, pipelined = pipelined_phase(np, torch, lst, dev, rng)
    entries += hold_path_shapes(np, torch, lst, dev, rng, hold, pipe_shapes, held,
                                f"pipelined_s{max(PIPE_SIZES)}", ctx7, 19)
    s7_launches, s7_shapes, stream7 = kind7_stream_phase(np, torch, lst, dev, rng)
    entries += hold_path_shapes(np, torch, lst, dev, rng, hold, s7_shapes, held,
                                "kind7_stream", ctx7, 20)
    host = host_golden_phase(np, lst)
    kind8_lines = []
    for label, m, s8, zk8, check in KIND8:
        k8_launches, k8_shapes, rec = kind8_phase(np, torch, lst, dev, rng, label, m, s8, zk8,
                                                  check)
        entries += hold_path_shapes(np, torch, lst, dev, rng, hold, k8_shapes, held,
                                    f"kind8_{label}", kind7_context(lst, m), 22)
        kind8_lines.append({"kind8": rec, f"launches_kind8_{label}": nonzero(k8_launches)})
    host_routes = host_routes_phase(np, lst)
    kind9, k9_path = {}, {}
    for zk9 in (False, True):
        k9_launches, k9_shapes, rec = kind9_phase(np, torch, lst, dev, rng, zk9)
        k9_path[zk9] = k9_launches
        entries += hold_path_shapes(np, torch, lst, dev, rng, hold, k9_shapes, held,
                                    rec["label"], kind7_context(lst, KIND9_M), 24)
        kind9[rec["label"]] = rec
    runs, kind9["batch_and_stream"] = kind9_batch_stream_phase(np, torch, lst, dev, rng)
    for tag, _launches, shapes9, ctx9 in runs:
        entries += hold_path_shapes(np, torch, lst, dev, rng, hold, shapes9, held, tag, ctx9, 24)
    kind9["launches"] = {tag: nonzero(launches9) for tag, launches9, _s, _c in runs}
    cli_entries, cli_record = cli_phase(np, torch, lst, dev, rng, hold, held, report, k7, k9_path,
                                        smi)
    entries += cli_entries
    md_entries, multidevice = multidevice_phase(np, torch, lst, dev, rng, hold, held,
                                                plain_stream, stream["stream"], smi)
    entries += md_entries
    chain_entries, chain_record = chain_phase(np, torch, lst, dev, rng, hold, held, smi)
    entries += chain_entries
    examples_record = examples_phase(np, torch, lst, rng, smi)
    print(json.dumps({"kind7": kind7}), flush=True)
    print(json.dumps({"kind7_2pow14": kind7_long, "launches_kind7_2pow14": k7_long,
                      "shape_launches_kind7_2pow14": [
                          [e, list(shape), v, n] for (e, shape, v), n in k7_shapes.items()]}),
          flush=True)
    print(json.dumps({"stream": stream, "launches_stream": st}), flush=True)
    print(json.dumps({"forest_leaves_to_roots_ms": forests}), flush=True)
    print(json.dumps({"kind7_zk": kind7_zk, "launches_kind7_zk": nonzero(zk_launches)}),
          flush=True)
    print(json.dumps({"pipelined": pipelined,
                      f"launches_pipelined_s{max(PIPE_SIZES)}": nonzero(pipe_launches)}),
          flush=True)
    print(json.dumps({"kind7_stream": stream7, "launches_kind7_stream": nonzero(s7_launches)}),
          flush=True)
    print(json.dumps({"host_golden_s": host}), flush=True)
    for line in kind8_lines:
        print(json.dumps(line), flush=True)
    print(json.dumps({"host_routes_s": host_routes}), flush=True)
    print(json.dumps({"kind9": kind9}), flush=True)
    print(json.dumps({"cli": cli_record}), flush=True)
    print(json.dumps({"multidevice": multidevice}), flush=True)
    print(json.dumps({"fri_chain": chain_record}), flush=True)
    print(json.dumps({"examples_and_names": examples_record}), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
