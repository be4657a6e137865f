"""Loaders of the reference's conformance vectors tv-0/1/2 (the port's copy
of the JAX package's ``circuits/test_vectors.py``), read from their JSON
files:

- params.json -> ``Params`` and the fixed seed,
- constraints.json COO entries -> ``R1CS``, values read as signed integers
  and reduced mod q (tv-2's -1 coefficients become q - 1),
- tv-0 (no constraints.json): the 5 x 5 linear system Az = b as rows
  (A_i . z) * 1 = b_i with witness [1, z] and public input [1]; its JSON
  witness does not solve the system, so the loader solves it mod q and
  keeps the raw vector in ``raw_json_witness``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from ..core.params import Params, Profile, SecurityLevel
from ..r1cs.r1cs import R1CS
from ..r1cs.sparse import SparseMatrix

#: The environment variable that names the directory of the reference's
#: vectors when a caller passes no ``root``. There is no built-in default:
#: the vectors are not part of the repository.
TV_ROOT_ENV = "LAMBDA_SNARK_TV_ROOT"

TV_DIRS = {
    0: "tv-0-linear-system",
    1: "tv-1-multiplication",
    2: "tv-2-plaquette",
}


@dataclasses.dataclass
class TestVector:
    index: int
    params: Params
    seed: int
    r1cs: R1CS
    witness: List[int]
    public_inputs: List[int]
    expected_valid: bool
    #: tv-0 only: the raw witness.json z-vector does NOT satisfy Az = b
    #: (A.z = [4,10,18,28,34] vs claimed b = [5,11,17,23,29]); the reference
    #: never checks it (its conformance test only loads the files). We keep
    #: the raw vector here and put the true mod-q solution in ``witness``.
    raw_json_witness: List[int] = dataclasses.field(default_factory=list)


def _solve_linear_mod(a_rows: List[List[int]], b_vec: List[int], q: int) -> List[int]:
    """Gauss-Jordan solve of Az = b over Z_q (gcd-aware pivoting for the
    composite legacy modulus)."""
    import math

    n = len(b_vec)
    M = [[a_rows[i][j] % q for j in range(n)] + [b_vec[i] % q] for i in range(n)]

    def inv(a: int) -> int:
        t, nt, r, nr = 0, 1, q, a % q
        while nr:
            qd = r // nr
            t, nt = nt, t - qd * nt
            r, nr = nr, r - qd * nr
        if r != 1:
            raise ValueError(f"pivot {a} not invertible mod {q}")
        return t % q

    for col in range(n):
        piv = next(
            r for r in range(col, n) if M[r][col] and math.gcd(M[r][col], q) == 1
        )
        M[col], M[piv] = M[piv], M[col]
        pinv = inv(M[col][col])
        M[col] = [(x * pinv) % q for x in M[col]]
        for r in range(n):
            if r != col and M[r][col]:
                f = M[r][col]
                M[r] = [(M[r][j] - f * M[col][j]) % q for j in range(n + 1)]
    return [M[i][n] for i in range(n)]


def _load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _load_params(tv_path: str) -> Tuple[Params, int]:
    data = _load_json(os.path.join(tv_path, "params.json"))
    prof = data["profile"]
    assert prof["type"].lower() in ("ringb", "ring-b")
    params = Params(
        SecurityLevel(data["security_level"]),
        Profile.ring_b(n=prof["n"], k=prof["k"], q=prof["q"], sigma=prof["sigma"]),
    )
    seed = int(data["random_seed"], 16)
    return params, seed


def _matrices_from_constraints(
    constraints, m: int, n: int, q: int
) -> Tuple[SparseMatrix, SparseMatrix, SparseMatrix]:
    mats = []
    for side in ("A", "B", "C"):
        entries: Dict[Tuple[int, int], int] = {}
        for con in constraints:
            for e in con.get(side, []):
                # signed semantics (static_cast<long>), reduced mod q
                entries[(e["row"], e["col"])] = int(e["value"]) % q
        mats.append(SparseMatrix.from_map(m, n, entries))
    return tuple(mats)


def tv_root(root: Optional[str] = None) -> str:
    """``root`` if given, else the directory named by ``LAMBDA_SNARK_TV_ROOT``;
    raises ``ValueError`` when neither is set."""
    if root is None:
        root = os.environ.get(TV_ROOT_ENV)
    if not root:
        raise ValueError(f"no test-vector directory: pass root or set {TV_ROOT_ENV}")
    return root


def load_test_vector(index: int, root: Optional[str] = None) -> TestVector:
    tv_path = os.path.join(tv_root(root), TV_DIRS[index])
    params, seed = _load_params(tv_path)
    q = params.q
    expected = _load_json(os.path.join(tv_path, "expected.json"))["valid"]

    if index == 0:
        stmt = _load_json(os.path.join(tv_path, "params.json"))["statement"]
        matrix_a = stmt["matrix_A"]
        b_vec = stmt["vector_b"]
        z = _load_json(os.path.join(tv_path, "witness.json"))["z"]
        m = len(matrix_a)
        n = 1 + len(z)
        a_entries: Dict[Tuple[int, int], int] = {}
        b_entries: Dict[Tuple[int, int], int] = {}
        c_entries: Dict[Tuple[int, int], int] = {}
        for i, row in enumerate(matrix_a):
            for j, v in enumerate(row):
                if v:
                    a_entries[(i, 1 + j)] = int(v) % q
            b_entries[(i, 0)] = 1
            if b_vec[i]:
                c_entries[(i, 0)] = int(b_vec[i]) % q
        r1cs = R1CS(
            m=m,
            n=n,
            l=1,
            a=SparseMatrix.from_map(m, n, a_entries),
            b=SparseMatrix.from_map(m, n, b_entries),
            c=SparseMatrix.from_map(m, n, c_entries),
            modulus=q,
        )
        raw_witness = [1] + [int(v) for v in z]
        if r1cs.is_satisfied(raw_witness):
            witness = raw_witness
        else:
            witness = [1] + _solve_linear_mod(matrix_a, b_vec, q)
        public_inputs = r1cs.public_inputs(witness)
        return TestVector(
            0, params, seed, r1cs, witness, public_inputs, expected,
            raw_json_witness=raw_witness,
        )

    cons = _load_json(os.path.join(tv_path, "constraints.json"))
    m = cons["m"]
    n = cons["n"]
    a, b, c = _matrices_from_constraints(cons["constraints"], m, n, q)
    witness = [int(v) % q for v in cons["verification"]["witness"]]
    # public input conventions: tv-1 exposes [1, c]=witness[0],witness[3];
    # tv-2 exposes [1]. Both use the input.json "public" list.
    input_data = _load_json(os.path.join(tv_path, "input.json"))
    public_list = input_data.get("public", [1])
    l = 1  # prefix convention: z[0] = 1 is the only guaranteed prefix public
    r1cs = R1CS(m=m, n=n, l=l, a=a, b=b, c=c, modulus=q)
    return TestVector(index, params, seed, r1cs, witness, [int(v) for v in public_list], expected)


def expected_evals(index: int, root: Optional[str] = None):
    """(Az, Bz, Cz) recorded in constraints.json (tv-1/2 only)."""
    tv_path = os.path.join(tv_root(root), TV_DIRS[index])
    cons = _load_json(os.path.join(tv_path, "constraints.json"))
    v = cons["verification"]
    return (
        [int(x) for x in v["Az"]],
        [int(x) for x in v["Bz"]],
        [int(x) for x in v["Cz"]],
    )
