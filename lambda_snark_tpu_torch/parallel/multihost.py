"""Joining a ``torch.distributed`` world, scaling sweeps, and local worlds.

The counterpart of the JAX package's ``parallel/multihost.py``
(``initialize_multihost``, ``pod_mesh``, ``ScalingPoint``,
``measure_scaling`` at :27-83). JAX joins hosts with
``jax.distributed.initialize`` and one controller then sees every device;
here each rank is a process that joins the world with
``init_process_group``: NCCL for ranks on separate cards (one rank a card;
NCCL refuses two ranks on one GPU), gloo for CPU ranks and for several
ranks that share one card. The backend is chosen once, by the caller or
from the device, and never switched.

``spawn_local`` starts n ranks on this host (``torch.multiprocessing.spawn``
with a ``file://`` rendezvous in a temporary directory, so concurrent
callers never race for a port) and returns each rank's result: the
multi-controller counterpart of JAX's single controller, without which the
layer cannot run on one host. A rank that raises fails the spawn: the
other ranks are stopped and the caller gets the error.

Scaling efficiency is JAX's weak-scaling figure,
    eff(N) = T(1) / T(N)
for a fixed per-device problem (the step factory scales the work with N).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..device import resolve
from .mesh import make_mesh

#: how long a collective may wait for its peers before the world fails
TIMEOUT = datetime.timedelta(minutes=5)


def default_backend(device="cuda") -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks (raises without a card for
    ``"cuda"``)."""
    return "nccl" if resolve(device).type == "cuda" else "gloo"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None) -> None:
    """Join the world as rank ``process_id`` of ``num_processes``.

    ``coordinator_address`` is ``host:port`` (a TCP rendezvous) or a URL
    (``tcp://...``, ``file://...``). With no address and at most one
    process, the world is this process alone, on an in-memory store. The
    backend is ``backend``, else NCCL (``default_backend()``, which raises
    without a card); CPU ranks pass ``backend="gloo"``."""
    backend = backend or default_backend()
    n = num_processes or 1
    if coordinator_address is None:
        if n != 1:
            raise ValueError(f"{n} processes need a coordinator address")
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0,
                                timeout=TIMEOUT)
        return
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=n, rank=process_id or 0,
                            timeout=TIMEOUT)


def pod_mesh(dp: int = 1, axis_names=("dp", "sp"), device="cuda"):
    """A (dp, world / dp) mesh over every rank of the world, sp innermost
    so that coefficient all_to_alls stay among neighbouring ranks."""
    total = dist.get_world_size()
    if total % dp != 0:
        raise ValueError(f"dp={dp} must divide the world size {total}")
    return make_mesh([dp, total // dp], list(axis_names), device)


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    per_step_s: float
    efficiency: float


def measure_scaling(step_factory: Callable[[int], Callable[[], object]], device_counts,
                    iters: int = 5) -> list:
    """Weak-scaling sweep: ``step_factory(n)`` returns a zero-argument
    callable running one step on an n-rank mesh with n-proportional work.
    Each step ends in ``torch.cuda.synchronize()`` when CUDA is in use, so
    the host clock reads the device's time."""
    sync = torch.cuda.synchronize if torch.cuda.is_initialized() else (lambda: None)
    points = []
    base = None
    for n in device_counts:
        step = step_factory(n)
        step()  # warm-up: plans, kernel loads, communicators
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
            sync()
        per_step = (time.perf_counter() - t0) / iters
        if base is None:
            base = per_step
        points.append(ScalingPoint(n_devices=n, per_step_s=per_step,
                                   efficiency=base / per_step if per_step > 0 else 0.0))
    return points


def _rank_main(rank: int, n: int, fn, args: tuple, backend: str, device: str,
               root: str) -> None:
    """One spawned rank: join the world, run ``fn(*args)``, save its result."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)  # ranks share the host's cores
    initialize_multihost(f"file://{os.path.join(root, 'rendezvous')}", n, rank, backend)
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(root, f"result-{rank}.pt"))


def spawn_local(n: int, fn: Callable, args: Sequence = (), backend: Optional[str] = None,
                device="cuda") -> list:
    """Run ``fn(*args)`` in n fresh processes that form a world on this
    host, and return their results, rank 0 first (loaded to the CPU).

    ``fn`` must be importable by name (a module-level function), since the
    ranks start from a fresh interpreter. CUDA ranks take card
    ``rank % device_count`` (under gloo, n ranks may share one card); CPU
    ranks run one thread each. The backend is ``backend``, else
    ``default_backend(device)``; NCCL takes one rank per card."""
    dev = resolve(device)
    backend = backend or default_backend(dev)
    if backend == "nccl":
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if n > cards:
            raise RuntimeError(f"NCCL takes one rank per card: {n} ranks on {cards} card(s) "
                               "would fail with 'Duplicate GPU detected'; use backend='gloo' "
                               "to share a card")
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="spawn_local-") as root:
        mp.spawn(_rank_main, args=(n, fn, tuple(args), backend, str(dev), root), nprocs=n,
                 join=True)
        return [torch.load(os.path.join(root, f"result-{r}.pt"), map_location="cpu",
                           weights_only=False) for r in range(n)]
