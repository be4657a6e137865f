"""Performance observation: the card's bounds, timers, profiler traces and
stage marks.

- ``ChipSpec`` and ``H100``: the card's device-memory rate and its 32-bit
  integer rate, the two figures every bound in this package and in
  ``chip_smoke.py`` is computed from;
- ``roofline``: the least time of a piece of work on that card, from its
  bytes and 32-bit integer operations, and which of the two bounds it;
- ``ntt_roofline``: the same for one radix-2 NTT over 64-bit words;
- ``DeviceTimer``: the time of one application of ``fn``, from a chain of
  applications timed with CUDA events on the card (the host clock where the
  caller asks for ``device="cpu"``);
- ``trace``: a ``torch.profiler`` trace of the block, written as a Chrome
  trace;
- ``stage`` and ``stage_report``: host-clock marks between named points of
  the kind-7 prover, on under ``LSNARK_STAGE_TIMING=1`` and free otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Callable, List, Tuple

from ..device import resolve


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """A card's peak rates for bound estimates."""

    name: str
    mem_bytes_per_s: float
    int32_ops_per_s: float


#: NVIDIA H100 SXM, from NVIDIA's data sheet: 80 GB of HBM3 at 3.35 TB/s;
#: 64 INT32 lanes per SM x 132 SMs x 1.98 GHz boost = 16.7 T 32-bit integer
#: operations/s (the data sheet's 67 TFLOP/s float32 is 128 lanes x 2 flops
#: per FMA at the same clock). Both at the full 700 W power limit.
H100 = ChipSpec(name="H100 80GB HBM3, 700 W", mem_bytes_per_s=3.35e12,
                int32_ops_per_s=132 * 64 * 1.98e9)


def roofline(bytes_accessed: float, int32_ops: float = 0.0, chip: ChipSpec = H100) -> dict:
    """The least time (seconds) of work that moves ``bytes_accessed`` bytes
    of device memory and does ``int32_ops`` 32-bit integer operations: the
    larger of the two times, and which one it is."""
    t_mem = bytes_accessed / chip.mem_bytes_per_s
    t_ops = int32_ops / chip.int32_ops_per_s
    bound_by, t = ("bytes", t_mem) if t_mem >= t_ops else ("operations", t_ops)
    return {"t_memory_s": t_mem, "t_int32_s": t_ops, "bound_by": bound_by,
            "speed_of_light_s": t}


#: least 32-bit integer instructions of one radix-2 butterfly over 64-bit
#: words: a Goldilocks product by a twiddle (a 64 x 64 -> 128 product as
#: four 32 x 32 -> 64 multiplies and the fold, 12) and a modular add and
#: subtract (3 each)
NTT_BUTTERFLY_OPS = 18


def ntt_roofline(m: int, rows: int = 1, chip: ChipSpec = H100) -> dict:
    """The bound of ``rows`` radix-2 NTTs of m points over 64-bit words.
    Bytes: each row read once and written once, 2 x 8 m bytes a row (the
    twiddles, m / 2 words, are counted once). Operations: (m / 2) log2 m
    butterflies a row at ``NTT_BUTTERFLY_OPS`` each."""
    log_m = int(math.log2(m))
    bytes_accessed = rows * 2 * m * 8 + (m // 2) * 8
    ops = rows * (m // 2) * log_m * NTT_BUTTERFLY_OPS
    return roofline(bytes_accessed, int32_ops=ops, chip=chip)


class DeviceTimer:
    """The time of one application of ``fn``, ``fn`` mapping its argument to
    an output of the same shape so that it can be chained: one measurement
    is ``chain`` applications in a row divided by ``chain``. On the card
    the chain is timed with CUDA events; with ``device="cpu"`` by the host
    clock. Entry into a CUDA run raises without a card."""

    def __init__(self, fn: Callable, chain: int = 32, device="cuda") -> None:
        self.fn = fn
        self.chain = chain
        self.device = resolve(device)

    def _run(self, x):
        for _ in range(self.chain):
            x = self.fn(x)
        return x

    def measure(self, x, iters: int = 5, warmup: int = 1) -> float:
        """Seconds per application, over ``iters`` chains after ``warmup``."""
        import torch

        for _ in range(warmup):
            x = self._run(x)
        if self.device.type == "cpu":
            t0 = time.perf_counter()
            for _ in range(iters):
                x = self._run(x)
            return (time.perf_counter() - t0) / (iters * self.chain)
        torch.cuda.synchronize(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            x = self._run(x)
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / 1e3 / (iters * self.chain)


@contextlib.contextmanager
def trace(path: str, device="cuda"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity on the card) and write it to ``path`` as a Chrome trace.
    Yields the profiler, whose ``key_averages()`` sums time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = resolve(device)
    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    prof.export_chrome_trace(path)


# --- stage marks (LSNARK_STAGE_TIMING=1) ---------------------------------------
#
# The kind-7 prover interleaves device work, blocking pulls and host field
# math; stage marks give the host-clock time between named points (without
# a synchronisation, so a mark after an enqueue measures the enqueue) at no
# cost when off.

STAGE_ENABLED = os.environ.get("LSNARK_STAGE_TIMING") == "1"
_STAGE_LOG: List[Tuple[str, float]] = []


def stage(label: str) -> None:
    if STAGE_ENABLED:
        _STAGE_LOG.append((label, time.perf_counter()))


def stage_report(reset: bool = True) -> str:
    """One line per pair of consecutive marks: the milliseconds between
    them; clears the log unless ``reset`` is False."""
    lines = [f"{(tb - ta) * 1e3:9.1f} ms  {a} -> {b}"
             for (a, ta), (b, tb) in zip(_STAGE_LOG, _STAGE_LOG[1:])]
    if reset:
        _STAGE_LOG.clear()
    return "\n".join(lines)
