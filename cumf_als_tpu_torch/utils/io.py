"""Binary sparse-matrix IO (the reference's file contract).

Raw little-endian int32/float32 arrays, as the reference's data-prep
scripts emit them:

    R_train_csr.{data,indptr,indices}.bin   float32 / int32 / int32
    R_train_csc.{data,indices,indptr}.bin   float32 / int32 / int32
    R_train_coo.row.bin                     int32
    R_test_coo.{data,row,col}.bin           float32 / int32 / int32

Host-side numpy, a copy of the JAX package's numpy paths (the native
dataplane is not ported yet).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class CSRMatrix:
    """Host-side CSR (row-compressed) ratings. indptr is (num_rows+1,)."""
    indptr: np.ndarray   # int32/int64 (num_rows+1,)
    indices: np.ndarray  # int32 (nnz,)
    data: np.ndarray     # float32 (nnz,)
    num_rows: int
    num_cols: int

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr)

    def to_coo_rows(self) -> np.ndarray:
        """Expand indptr to per-nonzero row ids."""
        return np.repeat(
            np.arange(self.num_rows, dtype=np.int32),
            np.diff(self.indptr).astype(np.int64))


@dataclass
class COOMatrix:
    row: np.ndarray   # int32 (nnz,)
    col: np.ndarray   # int32 (nnz,)
    data: np.ndarray  # float32 (nnz,)
    num_rows: int
    num_cols: int

    @property
    def nnz(self) -> int:
        return int(self.row.shape[0])


def _read(path: str, dtype, count: int = -1) -> np.ndarray:
    arr = np.fromfile(path, dtype=dtype, count=count)
    if count >= 0 and arr.shape[0] != count:
        raise IOError(
            f"{path}: expected {count} {np.dtype(dtype).name} entries, "
            f"got {arr.shape[0]}")
    return arr


def load_csr(data_dir: str, m: int, n: int, nnz: int,
             prefix: str = "R_train_csr") -> CSRMatrix:
    indptr = _read(os.path.join(data_dir, f"{prefix}.indptr.bin"),
                   np.int32, m + 1)
    indices = _read(os.path.join(data_dir, f"{prefix}.indices.bin"),
                    np.int32, nnz)
    data = _read(os.path.join(data_dir, f"{prefix}.data.bin"),
                 np.float32, nnz)
    return CSRMatrix(indptr=indptr, indices=indices, data=data,
                     num_rows=m, num_cols=n)


def load_csc_as_csr(data_dir: str, m: int, n: int, nnz: int,
                    prefix: str = "R_train_csc") -> CSRMatrix:
    """Load the CSC binaries as the CSR of the transpose (rows are the
    original columns): the theta update reads R^T row by row."""
    indptr = _read(os.path.join(data_dir, f"{prefix}.indptr.bin"),
                   np.int32, n + 1)
    indices = _read(os.path.join(data_dir, f"{prefix}.indices.bin"),
                    np.int32, nnz)
    data = _read(os.path.join(data_dir, f"{prefix}.data.bin"),
                 np.float32, nnz)
    return CSRMatrix(indptr=indptr, indices=indices, data=data,
                     num_rows=n, num_cols=m)


def load_test_coo(data_dir: str, m: int, n: int, nnz_test: int) -> COOMatrix:
    data = _read(os.path.join(data_dir, "R_test_coo.data.bin"),
                 np.float32, nnz_test)
    row = _read(os.path.join(data_dir, "R_test_coo.row.bin"),
                np.int32, nnz_test)
    col = _read(os.path.join(data_dir, "R_test_coo.col.bin"),
                np.int32, nnz_test)
    return COOMatrix(row=row, col=col, data=data, num_rows=m, num_cols=n)


def write_dataset(data_dir: str, train_csr: CSRMatrix,
                  test_coo: COOMatrix) -> None:
    """Emit the full binary contract for a dataset directory."""
    os.makedirs(data_dir, exist_ok=True)

    def out(name, arr, dtype):
        np.ascontiguousarray(arr, dtype=dtype).tofile(
            os.path.join(data_dir, name))

    out("R_train_csr.data.bin", train_csr.data, np.float32)
    out("R_train_csr.indptr.bin", train_csr.indptr, np.int32)
    out("R_train_csr.indices.bin", train_csr.indices, np.int32)
    csc = transpose_csr(train_csr)
    out("R_train_csc.data.bin", csc.data, np.float32)
    out("R_train_csc.indptr.bin", csc.indptr, np.int32)
    out("R_train_csc.indices.bin", csc.indices, np.int32)
    out("R_train_coo.row.bin", train_csr.to_coo_rows(), np.int32)
    out("R_test_coo.data.bin", test_coo.data, np.float32)
    out("R_test_coo.row.bin", test_coo.row, np.int32)
    out("R_test_coo.col.bin", test_coo.col, np.int32)


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """np.argsort(keys, kind="stable"), multi-threaded (a stable sort has
    one answer, so the permutation is the same). Read-only keys (a
    memory-mapped data set) are copied: a tensor must not share
    read-only pages."""
    if not keys.flags.writeable:
        keys = keys.copy()
    return torch.sort(torch.from_numpy(keys), stable=True)[1].numpy()


def transpose_csr(csr: CSRMatrix) -> CSRMatrix:
    """CSR -> CSR of the transpose (the CSC arrays of the original),
    counting in int64."""
    n = csr.num_cols
    counts = np.bincount(csr.indices, minlength=n).astype(np.int64)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    order = _stable_argsort(csr.indices)
    rows = csr.to_coo_rows()
    out_dtype = np.int32 if csr.nnz < 2**31 else np.int64
    return CSRMatrix(
        indptr=indptr.astype(out_dtype),
        indices=rows[order].astype(np.int32),
        data=csr.data[order],
        num_rows=n,
        num_cols=csr.num_rows,
    )


def coo_to_csr(coo: COOMatrix) -> CSRMatrix:
    """COO -> CSR with column indices sorted within each row. Duplicate
    (row, col) entries are kept as they are."""
    m = coo.num_rows
    counts = np.bincount(coo.row, minlength=m).astype(np.int64)
    indptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    # stable sort by (row, col): the same order as np.lexsort((col, row))
    key = coo.row.astype(np.int64) * max(1, coo.num_cols) + coo.col
    order = _stable_argsort(key)
    out_dtype = np.int32 if coo.nnz < 2**31 else np.int64
    return CSRMatrix(
        indptr=indptr.astype(out_dtype),
        indices=coo.col[order].astype(np.int32),
        data=coo.data[order].astype(np.float32),
        num_rows=m,
        num_cols=coo.num_cols,
    )
