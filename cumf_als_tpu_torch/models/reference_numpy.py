"""Pure-numpy ALS oracle for the tests: per-row Gram + regularizer, exact
solve, RMSE, in float64 (a copy of the JAX package's oracle)."""

from __future__ import annotations

import numpy as np

from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix, transpose_csr


def _update(csr: CSRMatrix, table: np.ndarray, lam: float) -> np.ndarray:
    f = table.shape[1]
    out = np.zeros((csr.num_rows, f), np.float64)
    table = table.astype(np.float64)
    for i in range(csr.num_rows):
        lo, hi = int(csr.indptr[i]), int(csr.indptr[i + 1])
        if hi == lo:
            continue  # empty row -> zero factor
        t = table[csr.indices[lo:hi]]
        r = csr.data[lo:hi].astype(np.float64)
        a = t.T @ t + (hi - lo) * lam * np.eye(f)
        b = t.T @ r
        out[i] = np.linalg.solve(a, b)
    return out


def numpy_als(train_csr: CSRMatrix, test_coo: COOMatrix, x0, theta0,
              lam: float, iters: int):
    """Run `iters` ALS iterations; returns (x, theta, history of
    (train_rmse, test_rmse))."""
    csc = transpose_csr(train_csr)
    x = np.array(x0, np.float64)
    theta = np.array(theta0, np.float64)
    rows_train = train_csr.to_coo_rows()
    history = []
    for _ in range(iters):
        x = _update(train_csr, theta, lam)
        theta = _update(csc, x, lam)
        tr = _rmse(x, theta, rows_train, train_csr.indices, train_csr.data)
        te = _rmse(x, theta, test_coo.row, test_coo.col, test_coo.data)
        history.append((tr, te))
    return x, theta, history


def _rmse(x, theta, rows, cols, vals) -> float:
    pred = np.einsum("ij,ij->i", x[rows], theta[cols])
    e = vals.astype(np.float64) - pred
    return float(np.sqrt(np.mean(e * e)))
