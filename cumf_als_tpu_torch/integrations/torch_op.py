"""PyTorch surface: the DoAls op for torch users, native to the port.

The reference shipped only a TensorFlow wrapper (reference
tensorflow/als_tf.cc); this is the same op for PyTorch, on the port's
`ALS`, with the same tensor layout: thetat (f, n), xt (f, m), rmse
(1, 1), the factors initialized inside the op with 0.1 * rand
(als_tf.cc:120-126).
"""

from __future__ import annotations

import numpy as np
import torch

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.models.als import ALS, resolve_device
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix


def _host(t, dtype) -> np.ndarray:
    return t.detach().cpu().numpy().astype(dtype)


def op_factors(n: int, f: int) -> np.ndarray:
    """The op's initial theta, 0.1 * U(0, 1) from RandomState(0); X
    starts at 0 (als_tf.cc:120-126)."""
    rng = np.random.RandomState(0)
    return (0.1 * rng.random_sample((n, f))).astype(np.float32)


def do_als(csrrow, csrcol, csrval, coorowtest, coocoltest, coovaltest,
           m: int, n: int, f: int, lambda_: float, iters: int = 10,
           solver: str = "cg", device=None):
    """Run ALS on the ratings in CSR (csrrow, csrcol, csrval) and the test
    COO triple, given as CPU or CUDA tensors. Returns (thetat, xt, rmse)
    tensors in the DoAls layout on the run's device: CUDA unless
    `device="cpu"` (raises without a card)."""
    dev = resolve_device(device)
    csr = CSRMatrix(indptr=_host(csrrow, np.int64),
                    indices=_host(csrcol, np.int32),
                    data=_host(csrval, np.float32), num_rows=m, num_cols=n)
    test = COOMatrix(row=_host(coorowtest, np.int32),
                     col=_host(coocoltest, np.int32),
                     data=_host(coovaltest, np.float32), num_rows=m,
                     num_cols=n)
    cfg = ALSConfig(m=m, n=n, f=f, nnz=csr.nnz, nnz_test=test.nnz,
                    lam=float(lambda_), iters=iters, solver=solver,
                    verbose=False, debug_timing=False)
    theta0 = op_factors(n, f)
    x0 = np.zeros((m, f), np.float32)
    res = ALS(cfg, csr, None, test, device=dev).run(x0, theta0)
    return (torch.from_numpy(res.theta.T.copy()).to(dev),
            torch.from_numpy(res.x.T.copy()).to(dev),
            torch.tensor([[res.final_test_rmse]], dtype=torch.float32,
                         device=dev))


class TorchMF:
    """Serving-side wrapper: holds trained factors as torch tensors and
    predicts ratings for (row, col) index tensors."""

    def __init__(self, xt, thetat):
        self.x = xt.T.contiguous() if xt.shape[0] != xt.shape[1] else xt.T
        self.theta = thetat.T.contiguous()

    def predict(self, rows, cols):
        return (self.x[rows.long()] * self.theta[cols.long()]).sum(-1)
