"""Batched f x f SPD solvers (the JAX package's ops/solve.py in torch).

  - "cg": warm start, at most cg_iters steps, x updated with the step's
    alpha before the per-system exit test rsnew < cg_tol, guarded
    divisions (zero systems return x0);
  - "cholesky": batched Cholesky + two triangular solves;
  - "lu": pivoted LU (torch.linalg.solve, as the JAX package uses
    jnp.linalg.solve).
"""

from __future__ import annotations

import torch


def solve_cholesky(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via Cholesky. a: (R, f, f), b: (R, f)."""
    low = torch.linalg.cholesky(a.float())
    return torch.cholesky_solve(b.float()[..., None], low)[..., 0]


def solve_lu(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched general solve (pivoted LU)."""
    return torch.linalg.solve(a.float(), b.float()[..., None])[..., 0]


def solve_cg(a: torch.Tensor, b: torch.Tensor, x0: torch.Tensor,
             cg_iters: int = 6, cg_tol: float = 1e-4) -> torch.Tensor:
    """Batched CG with the semantics of the JAX package's solve_cg.

    a: (R, f, f) f32 or bf16; b, x0: (R, f) f32. As there, the matvec
    takes p in A's storage dtype and sums in f32."""
    af = a.float()

    def matvec(p):
        return torch.einsum("rfg,rg->rf", af, p.to(a.dtype).float())

    x = x0.float()
    r = b.float() - matvec(x)
    p = r
    rsold = (r * r).sum(-1)
    active = torch.ones_like(rsold, dtype=torch.bool)
    for _ in range(cg_iters):
        ap = matvec(p)
        pap = (p * ap).sum(-1)
        safe = torch.where(pap.abs() > 0, pap, torch.ones_like(pap))
        alpha = torch.where(active & (pap != 0), rsold / safe,
                            torch.zeros_like(pap))
        x = x + alpha[:, None] * p
        r = r - alpha[:, None] * ap
        rsnew = (r * r).sum(-1)
        still = active & (rsnew >= cg_tol)
        beta = torch.where(
            still, rsnew / torch.where(rsold > 0, rsold,
                                       torch.ones_like(rsold)),
            torch.zeros_like(rsnew))
        p = torch.where(still[:, None], r + beta[:, None] * p, p)
        rsold = torch.where(still, rsnew, rsold)
        active = still
    return x


def solve(a, b, x0, solver: str = "cg", cg_iters: int = 6,
          cg_tol: float = 1e-4, backend: str = "xla", diag=None):
    """Dispatch one batched solve.

    diag: optional (R,) Tikhonov diagonal; `a` is then the RAW Gram and
    the regularizer is added at solve time. With solver "cg", backend
    "pallas" and a diagonal, the solve is kernel K3
    (ops/cuda_solve.solve_cg_reg), which adds it on the f32 copy of A in
    the kernel, so a bf16 A is never widened in device memory; K3's
    plain version serves tensors on the CPU. Without a diagonal (the
    already-regularized form, TPU kernel B4, not ported yet) and on the
    "xla" backend, the plain torch CG runs."""
    if solver == "cg" and backend == "pallas" and diag is not None:
        from cumf_als_tpu_torch.ops.cuda_solve import solve_cg_reg
        return solve_cg_reg(a, diag.float(), b, x0, cg_iters=cg_iters,
                            cg_tol=cg_tol)
    if diag is not None:
        f = a.shape[-1]
        a = a.float() + diag.float()[:, None, None] * torch.eye(
            f, dtype=torch.float32, device=a.device)
    if solver == "cg":
        return solve_cg(a, b, x0, cg_iters=cg_iters, cg_tol=cg_tol)
    if solver == "cholesky":
        return solve_cholesky(a, b)
    if solver == "lu":
        return solve_lu(a, b)
    raise ValueError(f"unknown solver {solver!r}")
