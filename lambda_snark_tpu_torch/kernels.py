"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``csrc/`` (``quotient.cu`` kernel Q, ``ring_commit.cu``
kernel R, ``keccak.cu`` kernel K, ``ntt.cu`` kernels N and T, ``fri.cu``
kernels S and F; the headers ``modmath.cuh``, ``butterfly.cuh``,
``cluster.cuh`` and ``keccak_f.cuh`` they share) is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes``; nothing includes PyTorch's headers. Libraries go to
``build/torch_kernels/<digest>/`` beside the package, keyed by a digest of
the sources and flags, and are built at first use, one ``nvcc`` process per
source, all started together. ``nvcc -Xptxas -v`` output (registers, shared
memory, spills) is kept beside each library as ``lib<name>.log``.

``LAUNCHES`` counts kernel launches per C entry (the names in
``PROTOTYPES``), the shape of the entry's input and a variant (a
transform's direction and modulus, and for the four-step whether a
``pre`` or ``post`` table rode its passes): each wrapper calls ``count`` where it
calls an entry, with the number of kernels that entry launches (one per
pass for ``ntt_four_step``: two up to 2^26 points, three at 2^27; one for
every other entry, a whole Merkle forest for ``keccak_forest`` and
``keccak_group_forest``), and nowhere else. ``launches()`` sums them per
C entry.

``cluster_size`` picks how many blocks of a thread-block cluster kernels Q
and R spread one row over; ``fold_grid`` how many blocks kernel F's chain
entry spreads a row over.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Optional, Tuple

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "torch_kernels")
SOURCES = {
    "quotient": "quotient.cu",
    "ring_commit": "ring_commit.cu",
    "keccak": "keccak.cu",
    "ntt": "ntt.cu",
    "fri": "fri.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_longlong
# a, b, c, four tables and their Shoup companions, 1/m and its companion,
# five outputs, rows, log2 m, the cluster size, the stream
_QUOTIENT_ARGS = [_P] * 11 + [_U64, _U64] + [_P] * 5 + [_I, _I, _I, _P]
PROTOTYPES = {
    "quotient": {
        "quotient_q45": _QUOTIENT_ARGS,
        "quotient_goldilocks": _QUOTIENT_ARGS,
        "quotient_pointwise": [_P] * 8 + [_U64, _I, _I, _P],
    },
    "ring_commit": {
        "ring_commit_goldilocks": [_P, _P, _P, _I] + [_P] * 6 + [_I, _I, _I, _I, _P],
        "ring_twist": [_P, _P, _P, _I64, _I, _P],
        "ring_accumulate": [_P, _P, _P, _I64, _I, _I, _P],
        "ring_finish": [_P, _P, _P, _I, _P, _I64, _I, _P],
    },
    "keccak": {
        "keccak_leaves": [_P, _P, _I, _I, _P],
        "keccak_group_leaves": [_P, _P, _I, _I, _I, _P],
        "keccak_nodes": [_P, _P, _I64, _P],
        "keccak_forest": [_P, _P, _P, _I, _I, _I, _P],
        "keccak_group_forest": [_P, _P, _P, _I, _I, _I, _I, _P],
    },
    "ntt": {  # a pointer to host NttPass descriptors (ops.ntt_large.NttPassStruct)
        "ntt_four_step": [_P, _I, _U64, _P],
        "ntt_rows": [_P, _U64, _P],
    },
    "fri": {
        # state in, state out, payload, words, head, has head, the label's
        # two lanes and length, statements, the stream
        "transcript_absorb": [_P, _P, _P, _I, _U64, _I, _U64, _U64, _I, _I, _P],
        # state in, state out, out, the squeeze block's lanes (host) with the
        # counter's lane and byte, first counter, squeezes, mask, field,
        # statements, the stream
        "transcript_squeeze": [_P, _P, _P, _P, _I, _I, _U64, _I, _U64, _I, _I, _P],
        # state in, state out, out, payload, words, head, the absorb label's
        # two lanes and length, then transcript_squeeze's block, counter,
        # squeezes and mask, statements, the stream
        "transcript_final_queries": [_P, _P, _P, _P, _I, _U64, _U64, _U64, _I, _P, _I, _I,
                                     _U64, _I, _U64, _I, _P],
        "fri_fold": [_P, _P, _P, _P, _I, _I, _P],
        # cur, 1/x, state in, root, state out, out, rows, log2 n/2, log2
        # blocks a row, the root label's two lanes and length, the squeeze
        # block's lanes (host), lane, byte, counter, the stream
        "fri_fold_squeeze": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _U64, _U64, _I, _P, _I, _I,
                             _U64, _P],
    },
}

LAUNCHES: Dict[Tuple[str, Tuple[int, ...], str], int] = {}

SM_COUNT = 132  # streaming multiprocessors of an H100 SXM
MAX_CLUSTER = 8  # the largest portable thread-block cluster
CLUSTER_BLOCK_BYTES = 192 << 10  # a block's share of a row: 3 x 2^13 words (csrc/cluster.cuh)


def cluster_size(rows: int, m: int, words: int) -> Optional[int]:
    """Blocks per row of kernels Q and R, for ``rows`` rows of m points
    whose buffers hold ``words`` 64-bit words a row (kernel Q: three of m,
    kernel R: two of n): the smallest power of two C <= 8 whose rows x C
    blocks fill the card's SMs, at least as many as keep a block's share of
    the words within CLUSTER_BLOCK_BYTES and at most C^2 <= m (a block takes
    at least one group of the cross-block exchange). None where no C <= 8
    holds the row: such a row takes the long route."""
    c = 1
    while words * 8 > CLUSTER_BLOCK_BYTES * c:
        c *= 2
    if c > MAX_CLUSTER or c * c > m:
        return None
    while rows * c < SM_COUNT and 2 * c <= MAX_CLUSTER and 4 * c * c <= m:
        c *= 2
    return c


FOLD_BLOCK_WORDS = 512  # outputs of one pass of a kernel F block: 256 threads, two words each
FOLD_BLOCKS_PER_SM = 2  # fold_squeeze_kernel's __launch_bounds__ (csrc/fri.cu): 128 registers


def fold_grid(rows: int, half: int) -> int:
    """log2 of the blocks a row of ``fri_fold_squeeze`` (kernel F's chain
    entry) takes over ``rows`` rows of ``half`` outputs: a block for every
    FOLD_BLOCK_WORDS outputs (each thread two words, 16-byte loads), halved
    until the rows' blocks fit on the card at once (FOLD_BLOCKS_PER_SM an
    SM), so that every block's first loads are in flight while its row's
    challenge is squeezed."""
    blocks = max(1, half // FOLD_BLOCK_WORDS)
    while blocks > 1 and rows * blocks > SM_COUNT * FOLD_BLOCKS_PER_SM:
        blocks //= 2
    return blocks.bit_length() - 1


_LIBS: Dict[str, ctypes.CDLL] = {}


def count(entry: str, launches: int, shape, variant: str = "") -> None:
    """Record ``launches`` kernels of C entry ``entry`` on an input of ``shape``."""
    key = (entry, tuple(shape), variant)
    LAUNCHES[key] = LAUNCHES.get(key, 0) + launches


def launches() -> Dict[str, int]:
    """Launches per C entry since the last reset, 0 for an entry not launched."""
    out = {fn: 0 for entries in PROTOTYPES.values() for fn in entries}
    for (entry, _, _), n in LAUNCHES.items():
        out[entry] += n
    return out


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(CSRC_DIR, fname), "rb") as f:
                h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile the named libraries that are not built yet, in parallel;
    return name -> library path. Raises with nvcc's output on failure."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    paths = {name: os.path.join(out_dir, f"lib{name}.so") for name in names}
    procs = {}
    for name, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        with open(os.path.join(out_dir, f"lib{name}.log"), "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    if name not in _LIBS:
        lib = ctypes.CDLL(build([name])[name])
        for fn, argtypes in PROTOTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def stream_handle(device) -> int:
    """The raw handle of the current CUDA stream of ``device``."""
    import torch

    index = torch.device(device).index or 0
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return raw(index) if raw is not None else torch.cuda.current_stream(index).cuda_stream


def launch(device, fn, *args) -> int:
    """``fn(*args, stream)`` for the current stream of ``device``, with
    ``device`` the current CUDA device; the device is switched only when
    it is not (a switch and a stream object cost microseconds a launch)."""
    import torch

    index = torch.device(device).index or 0
    if torch.cuda.current_device() == index:
        return fn(*args, stream_handle(index))
    with torch.cuda.device(index):
        return fn(*args, stream_handle(index))


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
