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

from cumf_als_tpu_torch.ops import cuda_solve


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
          cg_tol: float = 1e-4, backend: str = "xla", diag=None,
          aug: bool = False):
    """Dispatch one batched solve.

    diag: optional (R,) Tikhonov diagonal; `a` is then the RAW Gram and
    the regularizer is added at solve time.
    aug: `a` is the augmented accumulator carrying b in row f-1 (pass
    b=None); requires diag.

    With solver "cg" and backend "pallas" the solve is one of three
    kernels of ops/cuda_solve (their plain versions for tensors on the
    CPU; on a CUDA tensor the kernel launches or the call raises):
    `solve_cg_aug` (K5b) with aug, which unpacks b and masks row/column
    f-1 in the kernel; `solve_cg_reg` (K3) with a diagonal, which adds
    it on the f32 copy of A in the kernel, so a bf16 A is never widened
    in device memory; `solve_cg` (K4) without one, on `a` as given.
    Every other combination runs in plain torch: an aug `a` is unpacked
    first (one A-sized pass), then the diagonal is added."""
    if aug and diag is None:
        raise ValueError("aug solve requires diag")
    if solver == "cg" and backend == "pallas":
        kw = dict(cg_iters=cg_iters, cg_tol=cg_tol)
        if aug:
            return cuda_solve.solve_cg_aug(a, diag.float(), x0, **kw)
        if diag is not None:
            return cuda_solve.solve_cg_reg(a, diag.float(), b, x0, **kw)
        return cuda_solve.solve_cg(a, b, x0, **kw)
    if aug:
        a, b, _ = cuda_solve.unpack_aug(a)
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
