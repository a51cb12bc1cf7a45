"""The three hand-written kernels of the main path, their wrappers, their
plain PyTorch versions and their launch counts.

=====================  ================================  =====================
wrapper                TPU kernel it replaces            CUDA source
=====================  ================================  =====================
``gather_gram_cg``     pallas_solve.py ``_kernel``       csrc/gather_gram_cg.cu
``gather_gram_out``    pallas_solve.py ``_gram_kernel``  csrc/gather_gram_out.cu
``solve_cg_reg``       ``_cg_solve_reg_kernel``          csrc/solve_cg_reg.cu
=====================  ================================  =====================

Each wrapper takes its plain version for tensors on the CPU and
launches its kernel for tensors on a CUDA device; anything else raises.
There is no fallback from the kernel to the plain version. On the card
the plain versions are only called to check the kernels against them.

The row gather runs inside the kernels, so the wrappers keep the
contracts of the JAX wrappers (`gather_gram_cg`, `gather_gram_out`),
not those of the inner ``pallas_call``. Importing this module builds
and loads nothing (see ops/_build.py).
"""

from __future__ import annotations

from typing import Dict

import torch

from cumf_als_tpu_torch.ops import _build

# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"gather_gram_cg": 0, "gather_gram_out": 0,
                            "solve_cg_reg": 0}

_FLOATS = (torch.float32, torch.bfloat16)
_ERRORS = {1: "cudaErrorInvalidValue (unsupported f?)",
           2: "cudaErrorMemoryAllocation",
           9: "cudaErrorInvalidConfiguration"}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU, False when every one lies
    on one CUDA device; raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def _check(name: str, t: torch.Tensor, shape, dtypes) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_f(f: int) -> None:
    if f % 16 or not 16 <= f <= 128:
        raise ValueError(f"the kernels take f a multiple of 16 up to 128, "
                         f"got {f}")


def _launch(name: str, *args) -> None:
    fn = _build.load(name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} "
                           f"({_ERRORS.get(err, 'see cudaError_t')})")
    LAUNCHES[name] += 1


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


# ----------------------------------------------------------------- CG --
def cg_loop_plain(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                  cg_iters: int, cg_tol: float) -> torch.Tensor:
    """pallas_solve._cg_loop in plain torch: batched CG on f32 A (R, f, f)
    from the warm start x, with the per-system freeze written as masks.
    The frozen iterations change nothing, so running all cg_iters of them
    (no early exit, hence no host sync) gives the kernel's results."""
    def matvec(v):
        return torch.einsum("rfg,rg->rf", a, v)

    r = b - matvec(x)
    p = r
    rsold = (r * r).sum(-1, keepdim=True)
    active = torch.ones_like(rsold)
    for _ in range(cg_iters):
        ap = matvec(p)
        pap = (p * ap).sum(-1, keepdim=True)
        nonzero = (pap.abs() > 0).float()
        alpha = active * nonzero * rsold / (pap + (1.0 - nonzero))
        x = x + alpha * p
        r = r - alpha * ap
        rsnew = (r * r).sum(-1, keepdim=True)
        still = active * (rsnew >= cg_tol).float()
        beta = still * rsnew / (rsold + (rsold <= 0).float())
        p = still * (r + beta * p) + (1.0 - still) * p
        rsold = still * rsnew + (1.0 - still) * rsold
        active = still
    return x


def _eye(f: int, device) -> torch.Tensor:
    return torch.eye(f, dtype=torch.float32, device=device)


# --------------------------------------------------- K1 gather_gram_cg --
def gather_gram_cg_plain(table_ext, cols, vals, nnz, x0, lam: float,
                         cg_iters: int = 6, cg_tol: float = 1e-4):
    """Plain version of K1: index_select, f32 einsum, masked CG, se."""
    r, p = cols.shape
    f = table_ext.shape[1]
    g = table_ext.index_select(0, cols.reshape(-1).long()).reshape(r, p, f)
    g = g.float()
    v = vals.float()   # vals may arrive bf16: square in f32
    a = torch.einsum("rpf,rpg->rfg", g, g)
    b = torch.einsum("rp,rpf->rf", v, g)
    r2 = (v * v).sum(-1, keepdim=True)
    del g
    nnzf = nnz.float()
    diag = nnzf * lam + (nnzf == 0).float()
    a = a + diag[:, None, None] * _eye(f, a.device)
    x = cg_loop_plain(a, b, x0.float(), cg_iters, cg_tol)
    x = x * (nnzf > 0).float()[:, None]
    cross = (x * b).sum(-1, keepdim=True)
    aq = torch.einsum("rfg,rg->rf", a, x)
    quad = (x * aq).sum(-1, keepdim=True) - \
        diag[:, None] * (x * x).sum(-1, keepdim=True)
    return x, torch.clamp_min(r2 - 2.0 * cross + quad, 0.0)


def gather_gram_cg(table_ext, cols, vals, nnz, x0, lam: float,
                   cg_iters: int = 6, cg_tol: float = 1e-4):
    """Solve one chunk of rows: gather + Gram + regularized CG + per-row
    train squared error (pallas_solve.gather_gram_cg).

    table_ext (n+1, f) f32/bf16, zero-extended (a bf16 run casts the
    table before the gather, as models/als.py does); cols (R, P) int32,
    pad id n, pad slots at each row's tail; vals (R, P) f32/bf16; nnz
    (R,) int32; x0 (R, f) f32. Returns x (R, f) f32 and se (R, 1) f32."""
    if _on_cpu(table_ext, cols, vals, nnz, x0):
        return gather_gram_cg_plain(table_ext, cols, vals, nnz, x0, lam,
                                    cg_iters, cg_tol)
    r, p = cols.shape
    f = table_ext.shape[1]
    _check_f(f)
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    _check("nnz", nnz, (r,), (torch.int32,))
    _check("x0", x0, (r, f), (torch.float32,))
    x = torch.empty((r, f), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _launch("gather_gram_cg", table_ext.data_ptr(), _bf16(table_ext),
                cols.data_ptr(), vals.data_ptr(), _bf16(vals),
                nnz.data_ptr(), x0.data_ptr(), x.data_ptr(), se.data_ptr(),
                r, p, f, float(lam), int(cg_iters), float(cg_tol))
    return x, se


# -------------------------------------------------- K2 gather_gram_out --
def gather_gram_out_plain(table_ext, cols, vals,
                          out_dtype: torch.dtype = torch.float32):
    """Plain version of K2: index_select, f32 einsum, A cast at the end."""
    r, p = cols.shape
    f = table_ext.shape[1]
    g = table_ext.index_select(0, cols.reshape(-1).long()).reshape(r, p, f)
    g = g.float()
    a = torch.einsum("rpf,rpg->rfg", g, g)
    b = torch.einsum("rp,rpf->rf", vals.float(), g)
    return a.to(out_dtype), b


def gather_gram_out(table_ext, cols, vals,
                    out_dtype: torch.dtype = torch.float32):
    """Raw partial (A, b) of one panel chunk, no regularizer
    (pallas_solve.gather_gram_out). table_ext (s+1, f) f32/bf16 with a
    zero row at the pad id s; cols (R, P) int32 panel-local; vals (R, P)
    f32/bf16. Returns A (R, f, f) in out_dtype (summed in f32) and
    b (R, f) f32."""
    if _on_cpu(table_ext, cols, vals):
        return gather_gram_out_plain(table_ext, cols, vals, out_dtype)
    r, p = cols.shape
    f = table_ext.shape[1]
    _check_f(f)
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {_FLOATS}")
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    a = torch.empty((r, f, f), dtype=out_dtype, device=cols.device)
    b = torch.empty((r, f), dtype=torch.float32, device=cols.device)
    if r:
        _launch("gather_gram_out", table_ext.data_ptr(), _bf16(table_ext),
                cols.data_ptr(), vals.data_ptr(), _bf16(vals),
                a.data_ptr(), _bf16(a), b.data_ptr(), r, p, f)
    return a, b


# ----------------------------------------------------- K3 solve_cg_reg --
def solve_cg_reg_plain(a, diag, b, x0, cg_iters: int = 6,
                       cg_tol: float = 1e-4):
    """Plain version of K3: CG on f32(A) + diag I."""
    f = a.shape[-1]
    af = a.float() + diag.float()[:, None, None] * _eye(f, a.device)
    return cg_loop_plain(af, b.float(), x0.float(), cg_iters, cg_tol)


def solve_cg_reg(a, diag, b, x0, cg_iters: int = 6, cg_tol: float = 1e-4):
    """Batched CG on the raw Gram plus a per-system diagonal
    (pallas_solve.solve_cg_pallas with diag). a (R, f, f) f32/bf16,
    diag (R,) f32, b and x0 (R, f) f32. Returns x (R, f) f32."""
    if _on_cpu(a, diag, b, x0):
        return solve_cg_reg_plain(a, diag, b, x0, cg_iters, cg_tol)
    r, f, _ = a.shape
    _check_f(f)
    _check("a", a, (r, f, f), _FLOATS)
    _check("diag", diag, (r,), (torch.float32,))
    _check("b", b, (r, f), (torch.float32,))
    _check("x0", x0, (r, f), (torch.float32,))
    x = torch.empty((r, f), dtype=torch.float32, device=a.device)
    if r:
        _launch("solve_cg_reg", a.data_ptr(), _bf16(a), diag.data_ptr(),
                b.data_ptr(), x0.data_ptr(), x.data_ptr(), r, f,
                int(cg_iters), float(cg_tol))
    return x
