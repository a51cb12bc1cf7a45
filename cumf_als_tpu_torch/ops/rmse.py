"""RMSE evaluation (the JAX package's ops/rmse.py in torch).

Entries whose row or column had no training ratings see zero factors,
so they contribute e = r (prediction 0).
"""

from __future__ import annotations

import numpy as np
import torch

from cumf_als_tpu_torch.ops.precision import full_f32


def rmse_direct(x: torch.Tensor, theta: torch.Tensor, rows, cols, vals,
                chunk: int = 1 << 21) -> float:
    """sqrt(mean(e^2)) over the given COO entries (host numpy arrays),
    chunked so the factor gathers stay bounded. Partial sums stay on the
    device; one scalar is read at the end. Each chunk is copied (the
    arrays may be a read-only memory-mapped data set)."""
    nnz = int(vals.shape[0])
    if nnz == 0:
        return 0.0
    dev = x.device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for lo in range(0, nnz, chunk):
        hi = min(lo + chunk, nnz)
        r = torch.from_numpy(np.array(rows[lo:hi])).to(dev)
        c = torch.from_numpy(np.array(cols[lo:hi])).to(dev)
        v = torch.from_numpy(np.array(vals[lo:hi])).to(dev)
        pred = (x.index_select(0, r.long()).float() *
                theta.index_select(0, c.long()).float()).sum(-1)
        e = v.float() - pred
        total = total + (e * e).sum()
    return float(np.sqrt(float(total) / nnz))


def fused_sq_err(a, b, vals, nnz, lam: float, x_new) -> torch.Tensor:
    """Sum of per-row squared training errors from the Gram identity

        se_j = sum_i r_ij^2 - 2 x_j.b_j + x_j^T (A_j - diag_j I) x_j

    with A_j the regularized Gram (diag_j = nnz_j*lam + [nnz_j == 0]),
    evaluated per row and clamped at 0, in full float32 (`full_f32`).
    Returns a device scalar."""
    xt = x_new.float()
    v32 = vals.float()   # vals may arrive bf16: square in f32
    r2 = (v32 * v32).sum(-1)
    cross = (xt * b).sum(-1)
    with full_f32():
        aq = torch.einsum("rfg,rg->rf", a.float(), xt)
    quad = (xt * aq).sum(-1)
    nnzf = nnz.float()
    diag = nnzf * lam + (nnzf == 0).float()
    reg = diag * (xt * xt).sum(-1)
    return torch.clamp_min(r2 - 2.0 * cross + quad - reg, 0.0).sum()
