"""ctypes bindings for the native data plane (dataplane.cpp).

The port's own copy of the JAX package's native data plane: the same C++
source, byte for byte, and the same Python entry points. The library is
built at first use with

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared \\
        -o cumf_als_tpu_torch/_build/libdataplane.so native/dataplane.cpp

(the JAX package's flags, so that the floating-point steps of the
synthetic generator round the same way and its data are the same bit for
bit). A stamp beside the library (`libdataplane.so.target`) holds a hash
of what `-march=native` means to this host's compiler; the library is
rebuilt when the source is newer than it or when the stamp names another
target, so a library built on another CPU (a copied tree, a shared disk)
is never loaded.

`available()` builds and loads the library when it has not yet, and
says whether that worked. Every caller keeps a numpy path for a machine
without `g++`, as the JAX package does; a build that fails says so once
on stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_PATH = os.path.join(_DIR, "dataplane.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libdataplane.so")
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared"]
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _stamp_path() -> str:
    return LIB_PATH + ".target"


def _target() -> Optional[str]:
    """A hash of the compiler's version, the flags and the target options
    that `-march=native` selects on this host; None without `g++`."""
    try:
        out = [subprocess.run(["g++", *args], capture_output=True,
                              text=True, check=True).stdout
               for args in (["--version"],
                            ["-march=native", "-Q", "--help=target"])]
    except (OSError, subprocess.CalledProcessError):
        return None
    return hashlib.sha256("\0".join(out + CXX_FLAGS).encode()).hexdigest()


def _stale() -> bool:
    if (not os.path.exists(LIB_PATH) or
            os.path.getmtime(LIB_PATH) < os.path.getmtime(SRC_PATH)):
        return True
    try:
        with open(_stamp_path()) as fh:
            stamp = fh.read().strip()
    except OSError:
        return True
    return stamp != _target()


def _compile() -> bool:
    """Compile into a temporary file beside the library, then rename it
    into place, so a concurrent process never loads half a library."""
    global _build_failed
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        out = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SRC_PATH],
                             capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(out.stderr.strip())
        target = _target()
        os.replace(tmp, LIB_PATH)
        with open(_stamp_path(), "w") as fh:
            fh.write(f"{target}\n")
        return True
    except (OSError, RuntimeError) as exc:
        if not _build_failed:
            print(f"[native] building {LIB_PATH} failed; the numpy paths "
                  f"run instead: {exc}", file=sys.stderr, flush=True)
        _build_failed = True
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    if _stale() and not _compile():
        return None
    lib = ctypes.CDLL(LIB_PATH)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.csr_transpose.restype = ctypes.c_int
    lib.csr_transpose.argtypes = [ctypes.c_int64] * 3 + [
        i64p, i32p, f32p, i64p, i32p, f32p]
    lib.coo_to_csr.restype = ctypes.c_int
    lib.coo_to_csr.argtypes = [ctypes.c_int64] * 3 + [
        i32p, i32p, f32p, i64p, i32p, f32p]
    lib.materialize_chunk.restype = ctypes.c_int
    lib.materialize_chunk.argtypes = [
        i64p, i32p, f32p, i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int64, i32p, i32p,
        i32p, f32p]
    lib.materialize_subrows.restype = ctypes.c_int
    lib.materialize_subrows.argtypes = [
        i32p, f32p, i64p, i32p, i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        i32p, i32p, i32p, f32p]
    lib.expand_indptr.restype = ctypes.c_int
    lib.expand_indptr.argtypes = [ctypes.c_int64, i64p, i32p]
    lib.sum_squares.restype = ctypes.c_double
    lib.sum_squares.argtypes = [f32p, ctypes.c_int64]
    lib.synth_sample_keys.restype = ctypes.c_int64
    lib.synth_sample_keys.argtypes = [
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f64p, f64p,
        ctypes.c_uint64, ctypes.c_int64, i64p]
    lib.synth_counts.restype = ctypes.c_int
    lib.synth_counts.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, i64p]
    lib.synth_emit.restype = ctypes.c_int
    lib.synth_emit.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, f32p, f32p,
        ctypes.c_int64, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64, i64p, i32p,
        f32p, i32p, i32p, f32p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native data plane is not built; check "
                           "available() before calling it")
    return lib


def _p(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def csr_transpose(m: int, n: int, indptr: np.ndarray, indices: np.ndarray,
                  data: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _need()
    nnz = indices.shape[0]
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    out_indptr = np.zeros(n + 1, np.int64)
    out_indices = np.empty(nnz, np.int32)
    out_data = np.empty(nnz, np.float32)
    rc = lib.csr_transpose(m, n, nnz, _p(indptr, ctypes.c_int64),
                           _p(indices, ctypes.c_int32),
                           _p(data, ctypes.c_float),
                           _p(out_indptr, ctypes.c_int64),
                           _p(out_indices, ctypes.c_int32),
                           _p(out_data, ctypes.c_float))
    if rc != 0:
        raise ValueError("csr_transpose: column index out of range")
    return out_indptr, out_indices, out_data


def coo_to_csr(m: int, n: int, row: np.ndarray, col: np.ndarray,
               data: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    lib = _need()
    nnz = row.shape[0]
    row = np.ascontiguousarray(row, np.int32)
    col = np.ascontiguousarray(col, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    out_indptr = np.zeros(m + 1, np.int64)
    out_indices = np.empty(nnz, np.int32)
    out_data = np.empty(nnz, np.float32)
    rc = lib.coo_to_csr(m, n, nnz, _p(row, ctypes.c_int32),
                        _p(col, ctypes.c_int32), _p(data, ctypes.c_float),
                        _p(out_indptr, ctypes.c_int64),
                        _p(out_indices, ctypes.c_int32),
                        _p(out_data, ctypes.c_float))
    if rc != 0:
        raise ValueError("coo_to_csr: index out of range")
    return out_indptr, out_indices, out_data


def materialize_chunk(indptr: np.ndarray, indices: np.ndarray,
                      data: np.ndarray, rows: np.ndarray, width: int,
                      pad_col: int, pad_row: int, num_rows: int
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    """One padded bucket chunk of the listed rows; a row id outside
    [0, num_rows) is a dummy tail row (id pad_row, no slots)."""
    lib = _need()
    r = rows.shape[0]
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    rows = np.ascontiguousarray(rows, np.int32)
    rows_out = np.empty(r, np.int32)
    nnz_out = np.empty(r, np.int32)
    cols_out = np.empty((r, width), np.int32)
    vals_out = np.empty((r, width), np.float32)
    rc = lib.materialize_chunk(
        _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int32),
        _p(data, ctypes.c_float), _p(rows, ctypes.c_int32), r, width,
        pad_col, pad_row, num_rows, _p(rows_out, ctypes.c_int32),
        _p(nnz_out, ctypes.c_int32), _p(cols_out, ctypes.c_int32),
        _p(vals_out, ctypes.c_float))
    if rc != 0:
        raise ValueError("materialize_chunk: row longer than bucket width")
    return rows_out, nnz_out, cols_out, vals_out


def materialize_subrows(indices: np.ndarray, data: np.ndarray,
                        sub_off: np.ndarray, sub_len: np.ndarray,
                        sub_rows: np.ndarray, r_pad: int, width: int,
                        base: int, pad_col: int, pad_row: int
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
    """One padded panel chunk of (offset, length) subrows, columns made
    panel-local (col - base); rows past the subrows are dummy tails."""
    lib = _need()
    k = sub_off.shape[0]
    indices = np.ascontiguousarray(indices, np.int32)
    data = np.ascontiguousarray(data, np.float32)
    sub_off = np.ascontiguousarray(sub_off, np.int64)
    sub_len = np.ascontiguousarray(sub_len, np.int32)
    sub_rows = np.ascontiguousarray(sub_rows, np.int32)
    rows_out = np.empty(r_pad, np.int32)
    nnz_out = np.empty(r_pad, np.int32)
    cols_out = np.empty((r_pad, width), np.int32)
    vals_out = np.empty((r_pad, width), np.float32)
    rc = lib.materialize_subrows(
        _p(indices, ctypes.c_int32), _p(data, ctypes.c_float),
        _p(sub_off, ctypes.c_int64), _p(sub_len, ctypes.c_int32),
        _p(sub_rows, ctypes.c_int32), k, r_pad, width, base, pad_col,
        pad_row, _p(rows_out, ctypes.c_int32), _p(nnz_out, ctypes.c_int32),
        _p(cols_out, ctypes.c_int32), _p(vals_out, ctypes.c_float))
    if rc != 0:
        raise ValueError("materialize_subrows: subrow longer than width")
    return rows_out, nnz_out, cols_out, vals_out


def expand_indptr(indptr: np.ndarray, nnz: int) -> np.ndarray:
    lib = _need()
    m = indptr.shape[0] - 1
    indptr = np.ascontiguousarray(indptr, np.int64)
    out = np.empty(nnz, np.int32)
    lib.expand_indptr(m, _p(indptr, ctypes.c_int64),
                      _p(out, ctypes.c_int32))
    return out


def sum_squares(x: np.ndarray) -> float:
    lib = _need()
    x = np.ascontiguousarray(x, np.float32)
    return float(lib.sum_squares(_p(x, ctypes.c_float), x.shape[0]))


def synth_sample_keys(m: int, n: int, total: int, row_w: np.ndarray,
                      col_w: np.ndarray, seed: int) -> np.ndarray:
    """Unique sorted flat keys r*n+c by alias sampling. The achieved
    count may pass `total`: synth_split_emit thins it with a hash
    threshold."""
    lib = _need()
    row_w = np.ascontiguousarray(row_w, np.float64)
    col_w = np.ascontiguousarray(col_w, np.float64)
    cap = total + total // 8 + 64
    keys = np.empty(cap, np.int64)
    k = lib.synth_sample_keys(m, n, total, _p(row_w, ctypes.c_double),
                              _p(col_w, ctypes.c_double),
                              ctypes.c_uint64(seed & (2**64 - 1)), cap,
                              _p(keys, ctypes.c_int64))
    if k < 0:
        raise ValueError("synth_sample_keys: capacity too small")
    return keys[:k]


def synth_split_emit(keys: np.ndarray, m: int, n: int, u: np.ndarray,
                     v: np.ndarray, noise: float, lo: float, hi: float,
                     seed: int, total: int, test_frac: float):
    """Planted-model ratings, the hash train/test split and the CSR/COO
    emit in one native pass. Returns (indptr, cols, vals, trow, tcol,
    tvals)."""
    lib = _need()
    k = keys.shape[0]
    keep_t = min(1.0, total / max(1, k))
    test_t = min(1.0, test_frac)
    keep_u = ctypes.c_uint64(min(int(keep_t * 2.0**64), 2**64 - 1))
    test_u = ctypes.c_uint64(min(int(test_t * 2.0**64), 2**64 - 1))
    seed_u = ctypes.c_uint64(seed & (2**64 - 1))
    counts = np.zeros(2, np.int64)
    lib.synth_counts(_p(keys, ctypes.c_int64), k, seed_u, keep_u, test_u,
                     _p(counts, ctypes.c_int64))
    n_train, n_test = int(counts[0]), int(counts[1])
    u = np.ascontiguousarray(u, np.float32)
    v = np.ascontiguousarray(v, np.float32)
    indptr = np.zeros(m + 1, np.int64)
    cols = np.empty(n_train, np.int32)
    vals = np.empty(n_train, np.float32)
    trow = np.empty(n_test, np.int32)
    tcol = np.empty(n_test, np.int32)
    tvals = np.empty(n_test, np.float32)
    rc = lib.synth_emit(
        _p(keys, ctypes.c_int64), k, m, n, _p(u, ctypes.c_float),
        _p(v, ctypes.c_float), u.shape[1], ctypes.c_float(noise),
        ctypes.c_float(lo), ctypes.c_float(hi), seed_u, keep_u, test_u,
        _p(indptr, ctypes.c_int64), _p(cols, ctypes.c_int32),
        _p(vals, ctypes.c_float), _p(trow, ctypes.c_int32),
        _p(tcol, ctypes.c_int32), _p(tvals, ctypes.c_float))
    if rc != 0:
        raise ValueError("synth_emit failed")
    return indptr, cols, vals, trow, tcol, tvals
