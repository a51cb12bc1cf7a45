"""The hand-written kernels of the port, their wrappers, their plain
PyTorch versions and their launch counts.

===========================  ==========================  ==========================
wrapper                      TPU kernel it replaces      CUDA source
===========================  ==========================  ==========================
``gather_gram_cg``           ``_kernel``                 csrc/gather_gram_cg.cu
``gather_gram_out``          ``_gram_kernel``            csrc/gather_gram_out.cu
``solve_cg_reg``             ``_cg_solve_reg_kernel``    csrc/solve_cg_reg.cu
``solve_cg``                 ``_cg_solve_kernel``        csrc/solve_cg.cu
``gather_gram_aug_out``      ``_gram_kernel_aug``        csrc/gather_gram_aug_out.cu
``solve_cg_aug``             ``_cg_solve_aug_kernel``    csrc/solve_cg_aug.cu
``gather_gram_cg(aug=True)`` ``_kernel_aug``             csrc/gather_gram_cg_aug.cu
===========================  ==========================  ==========================

(TPU kernels: cumf_als_tpu/ops/pallas_solve.py.) Each wrapper takes its
plain version for tensors on the CPU and launches its kernel for tensors
on a CUDA device; anything else raises. There is no fallback from the
kernel to the plain version. On the card the plain versions are only
called to check the kernels against them.

The augmented-lane ("aug") forms need a free lane: the true factor width
is at most f - 1, so lane f - 1 of the gather table is all zero and
carries the rating value instead. One Gram A' then holds A (rows and
columns < f - 1), b (row and column f - 1) and sum v^2 (the corner).
The wrappers cannot check a whole table cheaply; `aug_enabled` and
`panel_aug_enabled` are the gates that guarantee the free lane, and
models/als.py calls the aug forms only behind them.

The row gather runs inside the kernels, so the wrappers keep the
contracts of the JAX wrappers (`gather_gram_cg`, `gather_gram_out`,
`gather_gram_aug_out`), not those of the inner ``pallas_call``.
Importing this module builds and loads nothing (see ops/_build.py).
"""

from __future__ import annotations

from typing import Dict

import torch

from cumf_als_tpu_torch.ops import _build

# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}

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


# -------------------------------------------------------------- gates --
def aug_enabled(cfg) -> bool:
    """Whether the direct route's fused kernel takes the augmented-lane
    form (pallas_solve.aug_enabled): only with aug_gram="force" and a
    free lane; "auto" resolves to off on the direct route. The caller
    applies it only where that route uses the fused kernel (backend
    "pallas" with CG)."""
    return cfg.aug_gram == "force" and cfg.f < cfg.f_pad


def panel_aug_enabled(cfg) -> bool:
    """Whether the accumulate-then-solve routes keep ONE augmented
    accumulator A' (pallas_solve.panel_aug_enabled): CG only (cholesky
    and lu keep split buffers), no save_model (its dumps are split
    (A, b)), aug_gram not "off", a free lane, and f32 accumulators
    unless aug_gram="force". It holds on both backends ("xla" takes the
    einsum/unpack twin) and reads cfg.gram_dtype, not the promoted
    accumulator dtype: a bf16 run whose accumulators were promoted to
    f32 keeps split buffers. With "force" and bf16 accumulators, b and
    sum v^2 ride a bf16 buffer and the reported train RMSE differs from
    the split-buffer value, as in the JAX package."""
    if cfg.solver != "cg" or cfg.save_model or cfg.aug_gram == "off" or \
            cfg.f >= cfg.f_pad:
        return False
    return cfg.gram_dtype == "f32" or cfg.aug_gram == "force"


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


def _gather(table_ext, cols) -> torch.Tensor:
    r, p = cols.shape
    return table_ext.index_select(0, cols.reshape(-1).long()).reshape(
        r, p, table_ext.shape[1])


def augment_g(g: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Splice the rating values into lane f-1 of the gathered block
    (pallas_solve.augment_g). Values round to G's dtype HERE, so b and
    sum v^2 of the aug form come from the value as stored: a bf16 G
    turns 3.3 into bf16(3.3)."""
    f = g.shape[2]
    return torch.cat([g[:, :, :f - 1], vals[:, :, None].to(g.dtype)], dim=2)


def unpack_aug(a_aug: torch.Tensor):
    """(A, b, r2) of an augmented A' (R, f, f), in f32: b is row f-1 with
    lane f-1 zeroed, r2 (R, 1) the corner, A is A' with row and column
    f-1 zeroed (b is copied out before the mask)."""
    af = a_aug.float()
    f = af.shape[-1]
    keep = (torch.arange(f, device=af.device) < f - 1).float()
    b = af[:, f - 1, :] * keep
    r2 = af[:, f - 1, f - 1:f]
    return af * keep[None, :, None] * keep[None, None, :], b, r2


# ----------------------------------------- K1 / K6 gather_gram_cg(_aug) --
def _solve_and_se(a, b, r2, nnz, x0, lam, cg_iters, cg_tol):
    """The tail the fused kernels share: regularize the raw f32 A, CG,
    zero the empty rows, and the per-row train squared error."""
    nnzf = nnz.float()
    diag = nnzf * lam + (nnzf == 0).float()
    a = a + diag[:, None, None] * _eye(a.shape[-1], a.device)
    x = cg_loop_plain(a, b, x0.float(), cg_iters, cg_tol)
    x = x * (nnzf > 0).float()[:, None]
    cross = (x * b).sum(-1, keepdim=True)
    aq = torch.einsum("rfg,rg->rf", a, x)
    quad = (x * aq).sum(-1, keepdim=True) - \
        diag[:, None] * (x * x).sum(-1, keepdim=True)
    return x, torch.clamp_min(r2 - 2.0 * cross + quad, 0.0)


def gather_gram_cg_plain(table_ext, cols, vals, nnz, x0, lam: float,
                         cg_iters: int = 6, cg_tol: float = 1e-4):
    """Plain version of K1: index_select, f32 einsum, masked CG, se."""
    g = _gather(table_ext, cols).float()
    v = vals.float()   # vals may arrive bf16: square in f32
    a = torch.einsum("rpf,rpg->rfg", g, g)
    b = torch.einsum("rp,rpf->rf", v, g)
    r2 = (v * v).sum(-1, keepdim=True)
    del g
    return _solve_and_se(a, b, r2, nnz, x0, lam, cg_iters, cg_tol)


def gather_gram_cg_aug_plain(table_ext, cols, vals, nnz, x0, lam: float,
                             cg_iters: int = 6, cg_tol: float = 1e-4):
    """Plain version of K6: index_select, augment_g, ONE f32 einsum, then
    b and r2 unpacked from row f-1, masked CG, se."""
    g = augment_g(_gather(table_ext, cols), vals).float()
    a, b, r2 = unpack_aug(torch.einsum("rpf,rpg->rfg", g, g))
    del g
    return _solve_and_se(a, b, r2, nnz, x0, lam, cg_iters, cg_tol)


def gather_gram_cg(table_ext, cols, vals, nnz, x0, lam: float,
                   cg_iters: int = 6, cg_tol: float = 1e-4,
                   aug: bool = False):
    """Solve one chunk of rows: gather + Gram + regularized CG + per-row
    train squared error (pallas_solve.gather_gram_cg).

    table_ext (n+1, f) f32/bf16, zero-extended (a bf16 run casts the
    table before the gather, as models/als.py does); cols (R, P) int32,
    pad id n, pad slots at each row's tail; vals (R, P) f32/bf16; nnz
    (R,) int32; x0 (R, f) f32. Returns x (R, f) f32 and se (R, 1) f32.

    aug=True takes the augmented-lane kernel (K6, counted as
    "gather_gram_cg_aug"): lane f-1 of the table must be all zero (true
    factor width < f) and lane f-1 of x0 zero; the values ride lane f-1
    of G, rounded to the table's dtype, and lane f-1 of x comes back
    exactly 0."""
    if _on_cpu(table_ext, cols, vals, nnz, x0):
        plain = gather_gram_cg_aug_plain if aug else gather_gram_cg_plain
        return plain(table_ext, cols, vals, nnz, x0, lam, cg_iters, cg_tol)
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
        _launch("gather_gram_cg_aug" if aug else "gather_gram_cg",
                table_ext.data_ptr(), _bf16(table_ext),
                cols.data_ptr(), vals.data_ptr(), _bf16(vals),
                nnz.data_ptr(), x0.data_ptr(), x.data_ptr(), se.data_ptr(),
                r, p, f, float(lam), int(cg_iters), float(cg_tol))
    return x, se


# -------------------------------------------------- K2 gather_gram_out --
def gather_gram_out_plain(table_ext, cols, vals,
                          out_dtype: torch.dtype = torch.float32):
    """Plain version of K2: index_select, f32 einsum, A cast at the end."""
    g = _gather(table_ext, cols).float()
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


# --------------------------------------------------------- K4 solve_cg --
def solve_cg_plain(a, b, x0, cg_iters: int = 6, cg_tol: float = 1e-4):
    """Plain version of K4: CG on f32(A) as given."""
    return cg_loop_plain(a.float(), b.float(), x0.float(), cg_iters, cg_tol)


def solve_cg(a, b, x0, cg_iters: int = 6, cg_tol: float = 1e-4):
    """Batched CG on already regularized systems
    (pallas_solve.solve_cg_pallas without diag). a (R, f, f) f32/bf16,
    b and x0 (R, f) f32. Returns x (R, f) f32; a system of zeros returns
    its x0."""
    if _on_cpu(a, b, x0):
        return solve_cg_plain(a, b, x0, cg_iters, cg_tol)
    r, f, _ = a.shape
    _check_f(f)
    _check("a", a, (r, f, f), _FLOATS)
    _check("b", b, (r, f), (torch.float32,))
    _check("x0", x0, (r, f), (torch.float32,))
    x = torch.empty((r, f), dtype=torch.float32, device=a.device)
    if r:
        _launch("solve_cg", a.data_ptr(), _bf16(a), b.data_ptr(),
                x0.data_ptr(), x.data_ptr(), r, f, int(cg_iters),
                float(cg_tol))
    return x


# --------------------------------------------- K5a gather_gram_aug_out --
def gather_gram_aug_out_plain(table_ext, cols, vals,
                              out_dtype: torch.dtype = torch.float32):
    """Plain version of K5a: index_select, augment_g, f32 einsum, cast."""
    g = augment_g(_gather(table_ext, cols), vals).float()
    return torch.einsum("rpf,rpg->rfg", g, g).to(out_dtype)


def gather_gram_aug_out(table_ext, cols, vals,
                        out_dtype: torch.dtype = torch.float32):
    """Raw partial augmented Gram A' of one panel chunk
    (pallas_solve.gather_gram_aug_out). table_ext (s+1, f) f32/bf16 with
    a zero row at the pad id s and lane f-1 all zero (true factor width
    < f); cols (R, P) int32 panel-local; vals (R, P) f32/bf16, rounded to
    the table's dtype as they enter lane f-1. Returns A' (R, f, f) in
    out_dtype (summed in f32): A in rows/columns < f-1, b in row and
    column f-1, sum v^2 in the corner."""
    if _on_cpu(table_ext, cols, vals):
        return gather_gram_aug_out_plain(table_ext, cols, vals, out_dtype)
    r, p = cols.shape
    f = table_ext.shape[1]
    _check_f(f)
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {_FLOATS}")
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    a = torch.empty((r, f, f), dtype=out_dtype, device=cols.device)
    if r:
        _launch("gather_gram_aug_out", table_ext.data_ptr(),
                _bf16(table_ext), cols.data_ptr(), vals.data_ptr(),
                _bf16(vals), a.data_ptr(), _bf16(a), r, p, f)
    return a


# ---------------------------------------------------- K5b solve_cg_aug --
def solve_cg_aug_plain(a_aug, diag, x0, cg_iters: int = 6,
                       cg_tol: float = 1e-4):
    """Plain version of K5b: unpack b, mask row/column f-1, add diag I on
    the whole diagonal, CG."""
    a, b, _ = unpack_aug(a_aug)
    a = a + diag.float()[:, None, None] * _eye(a.shape[-1], a.device)
    return cg_loop_plain(a, b, x0.float(), cg_iters, cg_tol)


def solve_cg_aug(a_aug, diag, x0, cg_iters: int = 6, cg_tol: float = 1e-4):
    """Batched CG on an augmented accumulator plus a per-system diagonal
    (pallas_solve.solve_cg_pallas with aug=True): b is row f-1 of A',
    row and column f-1 are masked, and the unpack never passes over
    device memory. a_aug (R, f, f) f32/bf16, diag (R,) f32, x0 (R, f)
    f32 with lane f-1 zero. Returns x (R, f) f32, lane f-1 exactly 0."""
    if _on_cpu(a_aug, diag, x0):
        return solve_cg_aug_plain(a_aug, diag, x0, cg_iters, cg_tol)
    r, f, _ = a_aug.shape
    _check_f(f)
    _check("a_aug", a_aug, (r, f, f), _FLOATS)
    _check("diag", diag, (r,), (torch.float32,))
    _check("x0", x0, (r, f), (torch.float32,))
    x = torch.empty((r, f), dtype=torch.float32, device=a_aug.device)
    if r:
        _launch("solve_cg_aug", a_aug.data_ptr(), _bf16(a_aug),
                diag.data_ptr(), x0.data_ptr(), x.data_ptr(), r, f,
                int(cg_iters), float(cg_tol))
    return x
