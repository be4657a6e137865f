"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``csrc/`` (``quotient.cu`` kernel Q, ``ring_commit.cu``
kernel R, ``keccak.cu`` kernel K, ``ntt_goldilocks.cu`` kernel N) is compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface and
loaded with ``ctypes``; nothing includes PyTorch's headers. Libraries go to
``build/torch_kernels/<digest>/`` beside the package, keyed by a digest of
the sources and flags, and are built at first use, one ``nvcc`` process per
source, all started together. ``nvcc -Xptxas -v`` output (registers, shared
memory, spills) is kept beside each library as ``lib<name>.log``.

``LAUNCHES`` counts kernel launches per C entry (the names in
``PROTOTYPES``): each wrapper adds, where it calls an entry, the number of
kernels that entry launches (two for ``ntt_goldilocks_forward``, one pass
each; one for every other entry), and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(PACKAGE_DIR), "build", "torch_kernels")
SOURCES = {
    "quotient": "quotient.cu",
    "ring_commit": "ring_commit.cu",
    "keccak": "keccak.cu",
    "ntt_goldilocks": "ntt_goldilocks.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_U64 = ctypes.c_uint64
_I64 = ctypes.c_longlong
_QUOTIENT_ARGS = [_P] * 7 + [_U64] + [_P] * 5 + [_I, _I, _P]
PROTOTYPES = {
    "quotient": {
        "quotient_q45": _QUOTIENT_ARGS,
        "quotient_goldilocks": _QUOTIENT_ARGS,
    },
    "ring_commit": {
        "ring_commit_goldilocks": [_P, _P, _P, _I] + [_P] * 6 + [_I, _I, _I, _P],
    },
    "keccak": {
        "keccak_leaves": [_P, _P, _I, _I, _P],
        "keccak_group_leaves": [_P, _P, _I, _I, _I, _P],
        "keccak_nodes": [_P, _P, _I64, _P],
    },
    "ntt_goldilocks": {
        "ntt_goldilocks_forward": [_P] * 6 + [_I, _I, _I, _P],
        "ntt_goldilocks_rows": [_P, _P, _P, _I, _I, _P],
    },
}

LAUNCHES: Dict[str, int] = {fn: 0 for entries in PROTOTYPES.values() for fn in entries}

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def check(rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
