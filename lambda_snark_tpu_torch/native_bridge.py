"""ctypes bindings for the native host library, the port's own copy.

The library is built from the unchanged C++ sources of ``native/src`` (the
seven that ``native/CMakeLists.txt`` lists), which mirror the reference's
extern "C" kernel surface: negacyclic and cyclic NTTs, Module-LWE
commitments, R1CS validation and SpMV, Lean export, the CDT Gaussian
sampler, batched SHA3-256 and Merkle path checks, and the FRI verifier's
field math. These bindings are thin typed wrappers with ownership handled
by finalizers.

The build runs the host C++ compiler by hand (no cmake or ninja, which a
machine may lack) with the CMake file's flags: ``-O3 -std=c++17 -fPIC
-shared -pthread``, plus ``-march=native`` and ``-mprefer-vector-width=512``
where the compiler accepts them. The library goes to
``build/torch_native/<digest>/`` beside the package, keyed by the sources,
the flags and the host CPU, under a file lock, written to a temporary name
and renamed into place, so that processes that build at once all load one
library. Importing this module builds nothing; ``available()`` builds and
loads at its first call.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from typing import List, Optional, Sequence

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE_DIR = os.path.join(_REPO, "native")
SOURCES = ("keccak.cpp", "keccak_batch.cpp", "fri_verify.cpp", "ntt.cpp", "gaussian.cpp",
           "commitment.cpp", "r1cs.cpp")
BUILD_ROOT = os.path.join(_REPO, "build", "torch_native")
LIB_NAME = "liblambda_snark_native.so"
BASE_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
#: taken where the compiler accepts them, as the CMake file does
OPTIONAL_FLAGS = ["-march=native", "-mprefer-vector-width=512"]

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None


class PublicParams(ctypes.Structure):
    _fields_ = [
        ("profile", ctypes.c_uint32),
        ("security", ctypes.c_uint32),
        ("modulus", ctypes.c_uint64),
        ("ring_degree", ctypes.c_uint64),
        ("module_rank", ctypes.c_uint64),
        ("sigma", ctypes.c_double),
        ("context_seed", ctypes.c_uint64),
    ]


class CLweCommitment(ctypes.Structure):
    _fields_ = [("data", ctypes.POINTER(ctypes.c_uint64)), ("len", ctypes.c_size_t)]


class CLweOpening(ctypes.Structure):
    _fields_ = [
        ("randomness", ctypes.POINTER(ctypes.c_uint64)),
        ("rand_len", ctypes.c_size_t),
    ]


class CSparseEntry(ctypes.Structure):
    _fields_ = [
        ("row", ctypes.c_uint32),
        ("col", ctypes.c_uint32),
        ("value", ctypes.c_uint64),
    ]


def compiler() -> Optional[str]:
    """The host C++ compiler: ``$CXX``, else ``g++``, else ``c++``; None
    where there is none."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        found = name and shutil.which(name)
        if found:
            return found
    return None


def _accepts(cxx: str, flag: str) -> bool:
    probe = subprocess.run([cxx, flag, "-x", "c++", "-c", "-o", os.devnull, "-"],
                           input="int main() { return 0; }\n", capture_output=True, text=True)
    return probe.returncode == 0


def _cpu_identity() -> bytes:
    """The host CPU's model and feature flags (``-march=native`` builds for
    them, so a library built on another CPU is not reused)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return b""
    keep = [ln for ln in lines if ln.startswith((b"model name", b"flags"))]
    return b"\n".join(sorted(set(keep)))


def _flags(cxx: str) -> List[str]:
    return BASE_FLAGS + [f for f in OPTIONAL_FLAGS if _accepts(cxx, f)]


def build_dir(cxx: str, flags: Sequence[str]) -> str:
    """``BUILD_ROOT/<digest>``, the digest over the compiler, the flags, the
    host CPU and every file of ``native/src`` and ``native/include``."""
    h = hashlib.sha256(" ".join([cxx, *flags]).encode() + b"\0" + _cpu_identity())
    for sub in ("src", "include"):
        for root, dirs, files in os.walk(os.path.join(NATIVE_DIR, sub)):
            dirs.sort()
            for fname in sorted(files):
                path = os.path.join(root, fname)
                with open(path, "rb") as f:
                    h.update(os.path.relpath(path, NATIVE_DIR).encode() + b"\0" + f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build() -> str:
    """Compile the library if it is not built yet; return its path. Raises
    RuntimeError where there is no C++ compiler or the build fails (with
    the compiler's output)."""
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (g++ or c++ on PATH, or $CXX)")
    flags = _flags(cxx)
    out_dir = build_dir(cxx, flags)
    path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(path):
        return path
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if os.path.exists(path):  # another process built it meanwhile
                return path
            tmp = f"{path}.{os.getpid()}.tmp"
            cmd = [cxx, *flags, "-I", os.path.join(NATIVE_DIR, "include"), "-o", tmp,
                   *(os.path.join(NATIVE_DIR, "src", f) for f in SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            with open(os.path.join(out_dir, "build.log"), "w") as f:
                f.write(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(f"native library build failed (rc {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return path


def _declare(lib: ctypes.CDLL) -> None:
    u64p = ctypes.POINTER(ctypes.c_uint64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    # ntt
    lib.ntt_context_create.restype = ctypes.c_void_p
    lib.ntt_context_create.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
    lib.ntt_context_free.argtypes = [ctypes.c_void_p]
    for fn in ("ntt_forward", "ntt_inverse", "ntt_forward_cyclic", "ntt_inverse_cyclic"):
        f = getattr(lib, fn)
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, u64p]
    lib.ntt_mul_pointwise.restype = ctypes.c_int
    lib.ntt_mul_pointwise.argtypes = [ctypes.c_void_p, u64p, u64p, u64p]
    lib.ntt_context_psi.restype = ctypes.c_uint64
    lib.ntt_context_psi.argtypes = [ctypes.c_void_p]
    lib.ntt_context_omega.restype = ctypes.c_uint64
    lib.ntt_context_omega.argtypes = [ctypes.c_void_p]
    # commitment
    lib.lwe_context_create.restype = ctypes.c_void_p
    lib.lwe_context_create.argtypes = [ctypes.POINTER(PublicParams)]
    lib.lwe_context_free.argtypes = [ctypes.c_void_p]
    lib.lwe_commit.restype = ctypes.POINTER(CLweCommitment)
    lib.lwe_commit.argtypes = [ctypes.c_void_p, u64p, ctypes.c_size_t, ctypes.c_uint64]
    lib.lwe_verify_opening.restype = ctypes.c_int
    lib.lwe_verify_opening.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(CLweCommitment), u64p, ctypes.c_size_t,
        ctypes.POINTER(CLweOpening),
    ]
    lib.lwe_linear_combine.restype = ctypes.POINTER(CLweCommitment)
    lib.lwe_linear_combine.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(CLweCommitment)), u64p,
        ctypes.c_size_t,
    ]
    lib.lwe_commitment_clone.restype = ctypes.POINTER(CLweCommitment)
    lib.lwe_commitment_clone.argtypes = [ctypes.POINTER(CLweCommitment)]
    lib.lwe_commitment_free.argtypes = [ctypes.POINTER(CLweCommitment)]
    lib.lwe_context_ring_modulus.restype = ctypes.c_uint64
    lib.lwe_context_ring_modulus.argtypes = []
    lib.lwe_context_matrix_row.restype = ctypes.c_int
    lib.lwe_context_matrix_row.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, u64p, ctypes.c_size_t,
    ]
    # r1cs
    lib.lambda_snark_r1cs_create.restype = ctypes.c_void_p
    lib.lambda_snark_r1cs_create.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
        ctypes.POINTER(CSparseEntry), ctypes.c_size_t,
        ctypes.POINTER(CSparseEntry), ctypes.c_size_t,
        ctypes.POINTER(CSparseEntry), ctypes.c_size_t,
    ]
    lib.lambda_snark_r1cs_free.argtypes = [ctypes.c_void_p]
    lib.lambda_snark_r1cs_validate_witness.restype = ctypes.c_int
    lib.lambda_snark_r1cs_validate_witness.argtypes = [ctypes.c_void_p, u64p, ctypes.c_size_t]
    lib.lambda_snark_r1cs_num_constraints.restype = ctypes.c_uint32
    lib.lambda_snark_r1cs_num_constraints.argtypes = [ctypes.c_void_p]
    lib.lambda_snark_r1cs_num_variables.restype = ctypes.c_uint32
    lib.lambda_snark_r1cs_num_variables.argtypes = [ctypes.c_void_p]
    lib.lambda_snark_r1cs_sparse_mv.restype = ctypes.c_int
    lib.lambda_snark_r1cs_sparse_mv.argtypes = [
        ctypes.c_void_p, ctypes.c_int, u64p, ctypes.c_size_t, u64p,
    ]
    # lean export
    lib.export_vk_to_lean.restype = ctypes.c_void_p
    lib.export_vk_to_lean.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.export_params_to_lean.restype = ctypes.c_void_p
    lib.export_params_to_lean.argtypes = [ctypes.POINTER(PublicParams)]
    lib.lambda_snark_string_free.argtypes = [ctypes.c_void_p]
    # batched hashing and Merkle verification (keccak_batch.cpp)
    lib.ls_sha3_256_batch.restype = ctypes.c_int
    lib.ls_sha3_256_batch.argtypes = [u8p, ctypes.c_size_t, ctypes.c_size_t, u8p]
    lib.ls_merkle_verify_batch.restype = ctypes.c_int
    lib.ls_merkle_verify_batch.argtypes = [
        u8p, ctypes.c_size_t, u64p, u8p, ctypes.POINTER(ctypes.c_uint32),
        ctypes.c_size_t, u8p, ctypes.c_size_t, u8p,
    ]
    # the FRI verifier's field math (fri_verify.cpp)
    lib.ls_fri_deep_g_eval.restype = ctypes.c_int
    lib.ls_fri_deep_g_eval.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        u64p, ctypes.c_size_t, u64p, u64p, ctypes.c_size_t,
        u64p, u64p, u64p, u64p, u64p, u64p, u64p, u64p,
    ]
    lib.ls_fri_fold_walk.restype = ctypes.c_int
    lib.ls_fri_fold_walk.argtypes = [
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        u64p, ctypes.c_size_t, u64p, ctypes.c_size_t,
        u64p, u64p, u64p, u64p, u64p, ctypes.c_size_t,
    ]
    # gaussian
    lib.sample_gaussian.restype = ctypes.c_int
    lib.sample_gaussian.argtypes = [u64p, ctypes.c_size_t, ctypes.c_double]
    lib.sample_gaussian_seeded.restype = ctypes.c_int
    lib.sample_gaussian_seeded.argtypes = [
        u64p, ctypes.c_size_t, ctypes.c_double, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.gaussian_cdt_table.restype = ctypes.c_int
    lib.gaussian_cdt_table.argtypes = [ctypes.c_double, u64p, ctypes.c_size_t]


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None (and the reason in
    ``load_error()``) where it cannot be built or loaded."""
    global _lib, _load_error
    if _lib is None and _load_error is None:
        try:
            lib = ctypes.CDLL(build())
            _declare(lib)
            _lib = lib
        except (RuntimeError, OSError) as exc:
            _load_error = str(exc)
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    """Why the library did not load (None if it did, or was not tried)."""
    return _load_error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_load_error}")
    return lib


def _as_u64_array(values: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray([int(v) & ((1 << 64) - 1) for v in values], dtype=np.uint64)


def _u64p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class NativeNtt:
    """Wrapper over ntt_context_* (negacyclic and cyclic)."""

    def __init__(self, n: int, modulus: int) -> None:
        self._lib = _require()
        self._ctx = self._lib.ntt_context_create(n, modulus)
        if not self._ctx:
            raise ValueError(f"ntt_context_create failed for n={n}, q={modulus}")
        self.n = n
        self.modulus = modulus

    @property
    def psi(self) -> int:
        return int(self._lib.ntt_context_psi(self._ctx))

    @property
    def omega(self) -> int:
        return int(self._lib.ntt_context_omega(self._ctx))

    def _inplace(self, fn_name: str, data: Sequence[int]) -> List[int]:
        arr = _as_u64_array(data)
        if arr.shape[0] != self.n:
            raise ValueError(f"{fn_name}: {arr.shape[0]} values for n={self.n}")
        rc = getattr(self._lib, fn_name)(self._ctx, _u64p(arr))
        if rc != 0:
            raise RuntimeError(f"{fn_name} failed: {rc}")
        return [int(v) for v in arr]

    def forward(self, data):
        return self._inplace("ntt_forward", data)

    def inverse(self, data):
        return self._inplace("ntt_inverse", data)

    def forward_cyclic(self, data):
        return self._inplace("ntt_forward_cyclic", data)

    def inverse_cyclic(self, data):
        return self._inplace("ntt_inverse_cyclic", data)

    def mul_pointwise(self, a, b):
        aa, bb = _as_u64_array(a), _as_u64_array(b)
        if aa.shape[0] != self.n or bb.shape[0] != self.n:
            raise ValueError(f"ntt_mul_pointwise: operands of n={self.n} values expected")
        out = np.zeros(self.n, dtype=np.uint64)
        rc = self._lib.ntt_mul_pointwise(self._ctx, _u64p(aa), _u64p(bb), _u64p(out))
        if rc != 0:
            raise RuntimeError(f"ntt_mul_pointwise failed: {rc}")
        return [int(v) for v in out]

    def __del__(self):  # pragma: no cover
        if getattr(self, "_ctx", None):
            self._lib.ntt_context_free(self._ctx)


class NativeLwe:
    """Wrapper over lwe_context_* (deterministic Module-LWE commitments)."""

    def __init__(self, n: int, k: int, q: int, sigma: float,
                 context_seed: int = 0, security: int = 128) -> None:
        self._lib = _require()
        params = PublicParams(profile=1, security=security, modulus=q, ring_degree=n,
                              module_rank=k, sigma=sigma, context_seed=context_seed)
        self._ctx = self._lib.lwe_context_create(ctypes.byref(params))
        if not self._ctx:
            raise ValueError("lwe_context_create failed")
        self.n = n
        self.k = k

    def commit_words(self, message: Sequence[int], seed: int) -> List[int]:
        msg = _as_u64_array(message)
        comm = self._lib.lwe_commit(self._ctx, _u64p(msg), len(message), seed)
        if not comm:
            raise RuntimeError("lwe_commit failed")
        try:
            return [int(comm.contents.data[i]) for i in range(comm.contents.len)]
        finally:
            self._lib.lwe_commitment_free(comm)

    def verify_opening(self, words: Sequence[int], message: Sequence[int], seed: int) -> bool:
        msg = _as_u64_array(message)
        data = _as_u64_array(words)
        comm = CLweCommitment(data=_u64p(data), len=len(words))
        rand = np.array([seed], dtype=np.uint64)
        opening = CLweOpening(randomness=_u64p(rand), rand_len=1)
        rc = self._lib.lwe_verify_opening(self._ctx, ctypes.byref(comm), _u64p(msg),
                                          len(message), ctypes.byref(opening))
        if rc < 0:
            raise RuntimeError(f"lwe_verify_opening error {rc}")
        return rc == 1

    def linear_combine_words(self, words_list, coeffs) -> List[int]:
        comms, keep = [], []
        for words in words_list:
            data = _as_u64_array(words)
            keep.append(data)
            comms.append(ctypes.pointer(CLweCommitment(data=_u64p(data), len=len(words))))
        arr = (ctypes.POINTER(CLweCommitment) * len(comms))(*comms)
        cf = _as_u64_array(coeffs)
        out = self._lib.lwe_linear_combine(self._ctx, arr, _u64p(cf), len(comms))
        if not out:
            raise RuntimeError("lwe_linear_combine failed")
        try:
            return [int(out.contents.data[i]) for i in range(out.contents.len)]
        finally:
            self._lib.lwe_commitment_free(out)

    def matrix_row(self, j: int) -> List[int]:
        out = np.zeros(self.n, dtype=np.uint64)
        rc = self._lib.lwe_context_matrix_row(self._ctx, j, _u64p(out), self.n)
        if rc != 0:
            raise RuntimeError(f"lwe_context_matrix_row failed: {rc}")
        return [int(v) for v in out]

    def __del__(self):  # pragma: no cover
        if getattr(self, "_ctx", None):
            self._lib.lwe_context_free(self._ctx)


class NativeR1cs:
    """Wrapper over lambda_snark_r1cs_* (COO validation and SpMV)."""

    def __init__(self, m: int, n: int, modulus: int, a_coo, b_coo, c_coo) -> None:
        self._lib = _require()

        def entries(coo):
            arr = (CSparseEntry * max(len(coo), 1))()
            for i, (r, c, v) in enumerate(coo):
                arr[i] = CSparseEntry(row=r, col=c, value=int(v) & ((1 << 64) - 1))
            return arr

        self._a, self._b, self._c = entries(a_coo), entries(b_coo), entries(c_coo)
        self._ctx = self._lib.lambda_snark_r1cs_create(
            m, n, modulus, self._a, len(a_coo), self._b, len(b_coo), self._c, len(c_coo))
        if not self._ctx:
            raise ValueError("lambda_snark_r1cs_create failed")
        self.m = m
        self.n = n

    def validate_witness(self, witness) -> bool:
        w = _as_u64_array(witness)
        rc = self._lib.lambda_snark_r1cs_validate_witness(self._ctx, _u64p(w), len(witness))
        if rc < 0:
            raise RuntimeError(f"validate_witness error {rc}")
        return rc == 1

    def vk_to_lean(self, num_public: int) -> str:
        ptr = self._lib.export_vk_to_lean(self._ctx, num_public)
        if not ptr:
            raise RuntimeError("export_vk_to_lean failed")
        try:
            return ctypes.string_at(ptr).decode("utf-8")
        finally:
            self._lib.lambda_snark_string_free(ptr)

    def sparse_mv(self, which: int, vec) -> List[int]:
        v = _as_u64_array(vec)
        out = np.zeros(self.m, dtype=np.uint64)
        rc = self._lib.lambda_snark_r1cs_sparse_mv(self._ctx, which, _u64p(v), len(vec),
                                                   _u64p(out))
        if rc != 0:
            raise RuntimeError(f"sparse_mv error {rc}")
        return [int(x) for x in out]

    def __del__(self):  # pragma: no cover
        if getattr(self, "_ctx", None):
            self._lib.lambda_snark_r1cs_free(self._ctx)


def sha3_256_batch(msgs: np.ndarray) -> np.ndarray:
    """SHA3-256 over n equal-length messages: uint8 [n, msg_len] -> [n, 32]
    (8-lane Keccak, native/src/keccak_batch.cpp), ``hashlib.sha3_256`` per
    row."""
    lib = _require()
    msgs = np.ascontiguousarray(msgs, dtype=np.uint8)
    n, msg_len = msgs.shape
    out = np.empty((n, 32), dtype=np.uint8)
    rc = lib.ls_sha3_256_batch(_u8p(msgs), msg_len, n, _u8p(out))
    if rc != 0:
        raise RuntimeError(f"ls_sha3_256_batch failed: {rc}")
    return out


def merkle_verify_batch(leaves: np.ndarray, indices: np.ndarray, siblings: np.ndarray,
                        depths: np.ndarray, roots: np.ndarray) -> np.ndarray:
    """Verify many Merkle authentication paths in one native call.

    leaves uint8 [lanes, leaf_len]; indices uint64 [lanes]; siblings uint8
    [lanes, max_depth, 32] (the first depths[i] used); depths uint32
    [lanes]; roots uint8 [lanes, 32]. Returns bool [lanes], lane by lane
    ``proof.merkle.verify_path``."""
    lib = _require()
    leaves = np.ascontiguousarray(leaves, dtype=np.uint8)
    indices = np.ascontiguousarray(indices, dtype=np.uint64)
    siblings = np.ascontiguousarray(siblings, dtype=np.uint8)
    depths = np.ascontiguousarray(depths, dtype=np.uint32)
    roots = np.ascontiguousarray(roots, dtype=np.uint8)
    lanes, leaf_len = leaves.shape
    max_depth = siblings.shape[1] if siblings.ndim == 3 else 0
    if not (indices.shape == depths.shape == (lanes,) and roots.shape == (lanes, 32)
            and siblings.shape[0] == lanes and int(depths.max(initial=0)) <= max_depth):
        raise ValueError("merkle_verify_batch: inconsistent lane shapes")
    ok = np.empty(lanes, dtype=np.uint8)
    rc = lib.ls_merkle_verify_batch(
        _u8p(leaves), leaf_len, _u64p(indices), _u8p(siblings),
        depths.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), max_depth,
        _u8p(roots), lanes, _u8p(ok))
    if rc != 0:
        raise RuntimeError(f"ls_merkle_verify_batch failed: {rc}")
    return ok.astype(bool)


def fri_deep_g_eval(q, offset, omega, n0, indices, in_lo, in_hi, wa, wb, ea, eb, alphas,
                    betas):
    """The batched DEEP virtual oracle at every query (fri_verify.cpp).

    Returns (g_lo, g_hi) uint64 arrays, or None if a denominator vanished
    (the verifier must reject); the same values as the Python ``g_eval``
    of ``proof/succinct.py`` and ``proof/aggregate.py``."""
    lib = _require()
    indices = np.ascontiguousarray(indices, dtype=np.uint64)
    in_lo = np.ascontiguousarray(in_lo, dtype=np.uint64)
    in_hi = np.ascontiguousarray(in_hi, dtype=np.uint64)
    n_q = len(indices)
    n_in = in_lo.shape[1] if in_lo.ndim == 2 else 0
    arrs = [np.ascontiguousarray(a, dtype=np.uint64) for a in (wa, wb, ea, eb, alphas, betas)]
    if in_hi.shape != in_lo.shape or any(a.shape != (n_in,) for a in arrs):
        raise ValueError("fri_deep_g_eval: inconsistent oracle shapes")
    g_lo = np.empty(n_q, dtype=np.uint64)
    g_hi = np.empty(n_q, dtype=np.uint64)
    rc = lib.ls_fri_deep_g_eval(q, offset, omega, n0, _u64p(indices), n_q, _u64p(in_lo),
                                _u64p(in_hi), n_in, *(_u64p(a) for a in arrs), _u64p(g_lo),
                                _u64p(g_hi))
    if rc == -1:
        return None
    if rc != 0:
        raise RuntimeError(f"ls_fri_deep_g_eval failed: {rc}")
    return g_lo, g_hi


def fri_fold_walk(q, offset, omega, n0, fold_challenges, indices, g_lo, g_hi, lay_lo, lay_hi,
                  final_coeffs) -> bool:
    """The fold-consistency walk over all queries (fri_verify.cpp)."""
    lib = _require()
    fc = np.ascontiguousarray(fold_challenges, dtype=np.uint64)
    idx = np.ascontiguousarray(indices, dtype=np.uint64)
    g_lo = np.ascontiguousarray(g_lo, dtype=np.uint64)
    g_hi = np.ascontiguousarray(g_hi, dtype=np.uint64)
    lay_lo = np.ascontiguousarray(lay_lo, dtype=np.uint64)
    lay_hi = np.ascontiguousarray(lay_hi, dtype=np.uint64)
    fin = np.ascontiguousarray(final_coeffs, dtype=np.uint64)
    rc = lib.ls_fri_fold_walk(q, offset, omega, n0, _u64p(fc), len(fc), _u64p(idx), len(idx),
                              _u64p(g_lo), _u64p(g_hi), _u64p(lay_lo), _u64p(lay_hi),
                              _u64p(fin), len(fin))
    if rc < 0:
        raise RuntimeError(f"ls_fri_fold_walk failed: {rc}")
    return rc == 1


def params_to_lean(n: int, k: int, q: int, sigma: float, lam: int = 128) -> str:
    lib = _require()
    params = PublicParams(profile=1, security=lam, modulus=q, ring_degree=n, module_rank=k,
                          sigma=sigma, context_seed=0)
    ptr = lib.export_params_to_lean(ctypes.byref(params))
    if not ptr:
        raise RuntimeError("export_params_to_lean failed")
    try:
        return ctypes.string_at(ptr).decode("utf-8")
    finally:
        lib.lambda_snark_string_free(ptr)


def gaussian_cdt_table(sigma: float) -> np.ndarray:
    lib = _require()
    size = lib.gaussian_cdt_table(sigma, None, 0)
    if size <= 0:
        raise ValueError("gaussian_cdt_table failed")
    out = np.zeros(size, dtype=np.uint64)
    lib.gaussian_cdt_table(sigma, _u64p(out), size)
    return out


def sample_gaussian_seeded(count: int, sigma: float, key: bytes) -> np.ndarray:
    lib = _require()
    if len(key) != 32:
        raise ValueError("sample_gaussian_seeded: the key must be 32 bytes")
    out = np.zeros(count, dtype=np.uint64)
    key_arr = (ctypes.c_uint8 * 32)(*key)
    rc = lib.sample_gaussian_seeded(_u64p(out), count, sigma, key_arr)
    if rc != 0:
        raise RuntimeError("sample_gaussian_seeded failed")
    return out.astype(np.int64)


def sample_gaussian(count: int, sigma: float) -> np.ndarray:
    lib = _require()
    out = np.zeros(count, dtype=np.uint64)
    rc = lib.sample_gaussian(_u64p(out), count, sigma)
    if rc != 0:
        raise RuntimeError("sample_gaussian failed")
    return out.astype(np.int64)
