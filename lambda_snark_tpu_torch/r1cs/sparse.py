"""CSR sparse matrices over F_q (the port's copy of ``r1cs/sparse.py``),
with a batched SpMV in PyTorch."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import field
from ..core.errors import InvalidDimensionsError
from ..ops import modarith


class SparseMatrix:
    """Immutable CSR matrix with integer values (reduced mod q in SpMV)."""

    def __init__(self, rows: int, cols: int, row_ptr: Sequence[int],
                 col_indices: Sequence[int], values: Sequence[int]) -> None:
        if len(row_ptr) != rows + 1:
            raise InvalidDimensionsError("row_ptr length must be rows+1")
        if row_ptr[0] != 0 or row_ptr[-1] != len(col_indices):
            raise InvalidDimensionsError("row_ptr must start at 0 and end at nnz")
        if any(row_ptr[i] > row_ptr[i + 1] for i in range(rows)):
            raise InvalidDimensionsError("row_ptr must be non-decreasing")
        if len(col_indices) != len(values):
            raise InvalidDimensionsError("col_indices/values length mismatch")
        if any(c >= cols for c in col_indices):
            raise InvalidDimensionsError("column index out of range")
        self.rows = rows
        self.cols = cols
        self.row_ptr = list(row_ptr)
        self.col_indices = list(col_indices)
        self.values = [int(v) for v in values]
        self._staged: Dict[tuple, tuple] = {}

    @staticmethod
    def from_dense(rows: Sequence[Sequence[int]]) -> "SparseMatrix":
        """Build from a dense row-major table; zeros dropped."""
        m = len(rows)
        n = len(rows[0]) if m else 0
        if any(len(r) != n for r in rows):
            raise InvalidDimensionsError("ragged dense rows")
        return SparseMatrix.from_map(m, n, {(i, j): v for i, r in enumerate(rows)
                                            for j, v in enumerate(r)})

    @staticmethod
    def from_map(rows: int, cols: int, entries: Dict[Tuple[int, int], int]) -> "SparseMatrix":
        """Build from a {(row, col): value} map, sorted by (row, col); zeros dropped."""
        items = sorted((rc, v) for rc, v in entries.items() if v != 0)
        row_ptr = [0] * (rows + 1)
        col_indices: List[int] = []
        values: List[int] = []
        cur = 0
        for (r, c), v in items:
            if r >= rows or c >= cols:
                raise InvalidDimensionsError(f"entry ({r},{c}) out of bounds")
            while cur < r:
                cur += 1
                row_ptr[cur] = len(col_indices)
            col_indices.append(c)
            values.append(int(v))
        while cur < rows:
            cur += 1
            row_ptr[cur] = len(col_indices)
        return SparseMatrix(rows, cols, row_ptr, col_indices, values)

    @staticmethod
    def from_coo(rows: int, cols: int, entries: Sequence[Tuple[int, int, int]]) -> "SparseMatrix":
        """Build from (row, col, value) triples: duplicates summed as
        integers, zero sums dropped."""
        acc: Dict[Tuple[int, int], int] = {}
        for r, c, v in entries:
            acc[(r, c)] = acc.get((r, c), 0) + int(v)
        return SparseMatrix.from_map(rows, cols, acc)

    def get(self, row: int, col: int) -> int:
        """The entry at (row, col), 0 when absent."""
        for i in range(self.row_ptr[row], self.row_ptr[row + 1]):
            if self.col_indices[i] == col:
                return self.values[i]
        return 0

    def to_dense(self, modulus: Optional[int] = None) -> np.ndarray:
        """The matrix as a dense (rows, cols) uint64 array, each value
        reduced mod ``modulus`` when one is given."""
        out = np.zeros((self.rows, self.cols), dtype=np.uint64)
        for row, col, v in self.coo():
            out[row, col] = v if modulus is None else v % modulus
        return out

    def nnz(self) -> int:
        return len(self.values)

    def coo(self) -> List[Tuple[int, int, int]]:
        """(row, col, value) triples in CSR order (row-major, as stored)."""
        return [
            (row, self.col_indices[i], self.values[i])
            for row in range(self.rows)
            for i in range(self.row_ptr[row], self.row_ptr[row + 1])
        ]

    def mul_vec(self, v: Sequence[int], modulus: int) -> List[int]:
        """Modular SpMV of one vector on Python ints."""
        if len(v) != self.cols:
            raise InvalidDimensionsError(f"vector length {len(v)} != cols {self.cols}")
        out = []
        for row in range(self.rows):
            s = 0
            for i in range(self.row_ptr[row], self.row_ptr[row + 1]):
                term = field.mul_mod(self.values[i] % modulus,
                                     v[self.col_indices[i]] % modulus, modulus)
                s = field.add_mod(s, term, modulus)
            out.append(s)
        return out

    def _stage(self, modulus: int, device: torch.device):
        """Column indices, values mod q and, for each p, the entries that
        are the p-th of their row with those rows, on ``device``; built on
        the host once, so ``mul_batch`` never waits for the device."""
        key = (modulus, str(device))
        if key not in self._staged:
            ptr = np.asarray(self.row_ptr, dtype=np.int64)
            counts = np.diff(ptr)
            row_of = np.repeat(np.arange(self.rows, dtype=np.int64), counts)
            pos = np.arange(self.nnz(), dtype=np.int64) - ptr[row_of]
            vals = modarith.to_words([v % modulus for v in self.values], device)
            to_dev = lambda a: torch.from_numpy(a).to(device)
            groups = []
            for p in range(int(counts.max(initial=0))):
                sel = np.flatnonzero(pos == p)
                groups.append((to_dev(sel), to_dev(row_of[sel])))
            self._staged[key] = (to_dev(np.asarray(self.col_indices, dtype=np.int64)),
                                 vals, groups)
        return self._staged[key]

    def mul_batch(self, w: torch.Tensor, modulus: int) -> torch.Tensor:
        """Modular SpMV of a batch: w (B, cols) canonical words -> (B, rows)."""
        if w.dim() != 2 or w.shape[1] != self.cols:
            raise InvalidDimensionsError(f"witness batch must be (B, {self.cols})")
        cols, vals, groups = self._stage(modulus, w.device)
        terms = modarith.mul_mod(w[:, cols], vals, modulus)  # (B, nnz)
        out = torch.zeros((w.shape[0], self.rows), dtype=torch.int64, device=w.device)
        for sel, rows in groups:  # the p-th entry of every row at once
            out[:, rows] = modarith.add_mod(out[:, rows], terms[:, sel], modulus)
        return out
