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
``gather_gram_cg_wide``      ``_kernel_wide``            csrc/gather_gram_cg_wide.cu
``fused_gram_cg_cat``        ``_kernel_cat``             csrc/fused_gram_cg_cat.cu
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

Factor widths 128 < F <= 256 pad to f = 256 lanes. ``gather_gram_cg``
takes f = 256 as it takes the narrower widths (its kernel switches to
the triangle-of-tiles body of csrc/wide.cuh); ``gather_gram_cg_wide``
solves only the 128 + f2 live lanes (f2 = `wide_f2(F)`) and returns
exact zeros above them; ``fused_gram_cg_cat`` is the 256-lane body over
an already gathered, lane-packed G. `wide_enabled` is the opt-in gate of
the second. The panel and solve kernels (K2-K5b) and the augmented fused
kernel (K6) take f <= 128 only.

The Gram kernels K1, K2, K5a and K6 are bound by operations on an H100
(K2 and K5a by the write of A as well when A is f32), and what feeds
them is the L2: the table stays there, but every slot moves its 256-byte
table row to an SM. For a bf16 table at f = 128, the main path, they
gather with cp.async into a ring of swizzled bf16 tiles and run the Gram
on the tensor cores (csrc/gram_mma.cuh); K1 and K6 stop each row at its
nnz and run the CG on the wgmma fragment in registers
(csrc/frag_cg.cuh). A float32 table and a bf16 table at f < 128 keep the
f32 FMA body of csrc/common.cuh. `gram_body` is that rule. One block
takes one row at a time, so a chunk with fewer rows than the card has
SMs leaves SMs idle. K7, K8 and K1 at f = 256 run the FMA body of
csrc/wide.cuh.

The row gather runs inside the kernels, so the wrappers keep the
contracts of the JAX wrappers (`gather_gram_cg`, `gather_gram_out`,
`gather_gram_aug_out`, `gather_gram_cg_wide`), not those of the inner
``pallas_call``; ``fused_gram_cg_cat`` has no gather wrapper there and
keeps its own.
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
    on the current CUDA device; raises on anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index not in (None, torch.cuda.current_device()):
        # the kernels launch on the current device's current stream
        raise ValueError(f"tensors on {dev}, but the current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return False


def _check(name: str, t: torch.Tensor, shape, dtypes) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_f(name: str, f: int, wide_ok: bool = False) -> None:
    """f must be a multiple of 16 up to 128; `wide_ok` also admits 256."""
    if wide_ok and f == 256:
        return
    if f % 16 or not 16 <= f <= 128:
        raise ValueError(f"{name}: the kernel takes f a multiple of 16 up "
                         f"to 128{' or f = 256' if wide_ok else ''}, got "
                         f"{f}")


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


def wide_f2(f: int) -> int:
    """Packed lane width of the second factor block for true width f
    (128 < f <= 256): the remainder padded to a multiple of 32
    (pallas_solve.wide_f2)."""
    return min(128, -(-(f - 128) // 32) * 32)


def wide_enabled(cfg) -> bool:
    """Whether the fused routes (direct and split) take the two-block
    wide-F kernel K7 (pallas_solve.wide_enabled): explicit opt-in only
    (wide_kernel="on"), 128 < F <= 256 (so f_pad is 256), CG, backend
    "pallas". The route is opt-in as in the JAX package; with it off,
    those widths run K1 at f = 256."""
    if cfg.wide_kernel != "on":
        return False
    if not 128 < cfg.f <= 256 or cfg.f_pad != 256:
        return False
    return cfg.solver == "cg" and cfg.backend == "pallas"


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
    table before the gather, as models/als.py does), f a multiple of 16
    up to 128, or 256 (without aug); cols (R, P) int32,
    pad id n, pad slots at each row's tail; vals (R, P) f32/bf16; nnz
    (R,) int32; x0 (R, f) f32. Returns x (R, f) f32 and se (R, 1) f32.

    aug=True takes the augmented-lane kernel (K6, counted as
    "gather_gram_cg_aug"): lane f-1 of the table must be all zero (true
    factor width < f) and lane f-1 of x0 zero; the values ride lane f-1
    of G, rounded to the table's dtype, and lane f-1 of x comes back
    exactly 0. On a card the Gram runs in the body `gram_body` names (f
    = 256 in that of csrc/wide.cuh); on the tensor cores the bf16
    products are exact and the f32 sums are taken in the hardware's
    order."""
    if _on_cpu(table_ext, cols, vals, nnz, x0):
        plain = gather_gram_cg_aug_plain if aug else gather_gram_cg_plain
        return plain(table_ext, cols, vals, nnz, x0, lam, cg_iters, cg_tol)
    r, p = cols.shape
    f = table_ext.shape[1]
    name = "gather_gram_cg_aug" if aug else "gather_gram_cg"
    _check_f(name, f, wide_ok=not aug)
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    _check("nnz", nnz, (r,), (torch.int32,))
    _check("x0", x0, (r, f), (torch.float32,))
    x = torch.empty((r, f), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _check_gram_table(table_ext, cols)
        _launch(name, table_ext.data_ptr(), _bf16(table_ext),
                cols.data_ptr(), vals.data_ptr(), _bf16(vals),
                nnz.data_ptr(), x0.data_ptr(), x.data_ptr(), se.data_ptr(),
                r, p, f, float(lam), int(cg_iters), float(cg_tol))
    return x, se


# ------------------------------------------- K2 / K5a the panel Grams --
def gram_body(table_ext: torch.Tensor) -> str:
    """Which Gram body the kernels K1, K2, K5a and K6 run for this table
    on a card, by its dtype and width alone: "wgmma" (csrc/gram_mma.cuh:
    cp.async gather into swizzled bf16 tiles, tensor-core Gram; for K1
    and K6 the CG on the fragment of csrc/frag_cg.cuh) for a bf16 table
    at f = 128, the width of the main path; "fma" (the f32 FMA bodies of
    csrc/common.cuh, and for K1 at f = 256 of csrc/wide.cuh) for a
    float32 table, which bf16 tensor cores would round, and for every
    other width. A caller cannot choose, and neither body gives way to
    the other or to the plain version."""
    if table_ext.dtype == torch.bfloat16 and table_ext.shape[1] == 128:
        return "wgmma"
    return "fma"


def _check_gram_table(table_ext: torch.Tensor, cols: torch.Tensor) -> None:
    """The tensor-core body copies 16 bytes at a time: the table's rows
    must lie on 16-byte boundaries. It counts a chunk's slots in 32
    bits."""
    if gram_body(table_ext) != "wgmma":
        return
    if table_ext.data_ptr() % 16:
        raise ValueError("table_ext: its storage must start on a 16-byte "
                         "boundary")
    if cols.numel() >= 2 ** 31:
        raise ValueError(f"cols: {cols.numel()} slots, the kernel takes "
                         f"fewer than 2^31")


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
    b (R, f) f32. On a card the Gram runs in the body `gram_body` names;
    on the tensor cores the bf16 products are exact and the f32 sums are
    taken in the hardware's order."""
    if _on_cpu(table_ext, cols, vals):
        return gather_gram_out_plain(table_ext, cols, vals, out_dtype)
    r, p = cols.shape
    f = table_ext.shape[1]
    _check_f("gather_gram_out", f)
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {_FLOATS}")
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    a = torch.empty((r, f, f), dtype=out_dtype, device=cols.device)
    b = torch.empty((r, f), dtype=torch.float32, device=cols.device)
    if r:
        _check_gram_table(table_ext, cols)
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
    _check_f("solve_cg_reg", f)
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
    _check_f("solve_cg", f)
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
    column f-1, sum v^2 in the corner. On a card the Gram runs in the
    body `gram_body` names."""
    if _on_cpu(table_ext, cols, vals):
        return gather_gram_aug_out_plain(table_ext, cols, vals, out_dtype)
    r, p = cols.shape
    f = table_ext.shape[1]
    _check_f("gather_gram_aug_out", f)
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {_FLOATS}")
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    a = torch.empty((r, f, f), dtype=out_dtype, device=cols.device)
    if r:
        _check_gram_table(table_ext, cols)
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
    _check_f("solve_cg_aug", f)
    _check("a_aug", a_aug, (r, f, f), _FLOATS)
    _check("diag", diag, (r,), (torch.float32,))
    _check("x0", x0, (r, f), (torch.float32,))
    x = torch.empty((r, f), dtype=torch.float32, device=a_aug.device)
    if r:
        _launch("solve_cg_aug", a_aug.data_ptr(), _bf16(a_aug),
                diag.data_ptr(), x0.data_ptr(), x.data_ptr(), r, f,
                int(cg_iters), float(cg_tol))
    return x


# ------------------------------------ K7 gather_gram_cg_wide / K8 cat --
def cg_loop_wide_plain(a11, a12, a22, b1, b2, x1, x2, cg_iters: int,
                       cg_tol: float):
    """pallas_solve._cg_loop_wide in plain torch: cg_loop_plain on the
    two-block system [[A11, A12], [A12^T, A22]], the carries split in
    (128, f2) halves and every dot product summed half by half."""
    def matvec(p1, p2):
        y1 = torch.einsum("rfg,rg->rf", a11, p1) + \
            torch.einsum("rfg,rg->rf", a12, p2)
        y2 = torch.einsum("rfg,rf->rg", a12, p1) + \
            torch.einsum("rfg,rg->rf", a22, p2)
        return y1, y2

    def dot(u1, u2, v1, v2):
        return (u1 * v1).sum(-1, keepdim=True) + \
            (u2 * v2).sum(-1, keepdim=True)

    ax1, ax2 = matvec(x1, x2)
    r1, r2 = b1 - ax1, b2 - ax2
    p1, p2 = r1, r2
    rsold = dot(r1, r2, r1, r2)
    active = torch.ones_like(rsold)
    for _ in range(cg_iters):
        ap1, ap2 = matvec(p1, p2)
        pap = dot(p1, p2, ap1, ap2)
        nonzero = (pap.abs() > 0).float()
        alpha = active * nonzero * rsold / (pap + (1.0 - nonzero))
        x1, x2 = x1 + alpha * p1, x2 + alpha * p2
        r1, r2 = r1 - alpha * ap1, r2 - alpha * ap2
        rsnew = dot(r1, r2, r1, r2)
        still = active * (rsnew >= cg_tol).float()
        beta = still * rsnew / (rsold + (rsold <= 0).float())
        p1 = still * (r1 + beta * p1) + (1.0 - still) * p1
        p2 = still * (r2 + beta * p2) + (1.0 - still) * p2
        rsold = still * rsnew + (1.0 - still) * rsold
        active = still
    return x1, x2


def fused_gram_cg_wide_plain(g1, g2, vals, nnz, x01, x02, lam: float,
                             cg_iters: int = 6, cg_tol: float = 1e-4):
    """pallas_solve.fused_gram_cg_wide in plain torch: g1 (R, P, 128) and
    g2 (R, P, f2) are the lane blocks of the gathered rows. Three f32
    einsums (A11, A12, A22), the diagonal on A11 and A22, the two-block
    CG, and the train error on the blocked system. Returns x1 (R, 128),
    x2 (R, f2), se (R, 1)."""
    g1, g2, v = g1.float(), g2.float(), vals.float()
    a11 = torch.einsum("rpf,rpg->rfg", g1, g1)
    a12 = torch.einsum("rpf,rpg->rfg", g1, g2)
    a22 = torch.einsum("rpf,rpg->rfg", g2, g2)
    b1 = torch.einsum("rp,rpf->rf", v, g1)
    b2 = torch.einsum("rp,rpf->rf", v, g2)
    r2 = (v * v).sum(-1, keepdim=True)
    del g1, g2
    nnzf = nnz.float()
    diag = nnzf * lam + (nnzf == 0).float()
    a11 = a11 + diag[:, None, None] * _eye(a11.shape[-1], a11.device)
    a22 = a22 + diag[:, None, None] * _eye(a22.shape[-1], a22.device)
    x1, x2 = cg_loop_wide_plain(a11, a12, a22, b1, b2, x01.float(),
                                x02.float(), cg_iters, cg_tol)
    live = (nnzf > 0).float()[:, None]
    x1, x2 = x1 * live, x2 * live
    cross = (x1 * b1).sum(-1, keepdim=True) + (x2 * b2).sum(-1, keepdim=True)
    aq1 = torch.einsum("rfg,rg->rf", a11, x1) + \
        torch.einsum("rfg,rg->rf", a12, x2)
    aq2 = torch.einsum("rfg,rf->rg", a12, x1) + \
        torch.einsum("rfg,rg->rf", a22, x2)
    quad = (x1 * aq1).sum(-1, keepdim=True) + \
        (x2 * aq2).sum(-1, keepdim=True) - diag[:, None] * (
            (x1 * x1).sum(-1, keepdim=True) + (x2 * x2).sum(-1, keepdim=True))
    return x1, x2, torch.clamp_min(r2 - 2.0 * cross + quad, 0.0)


def gather_gram_cg_wide_plain(table_ext, cols, vals, nnz, x0, lam: float,
                              f2: int, cg_iters: int = 6,
                              cg_tol: float = 1e-4):
    """Plain version of K7: index_select on the two lane ranges, then
    fused_gram_cg_wide_plain; lanes >= 128 + f2 of x are zero."""
    r, p = cols.shape
    idx = cols.reshape(-1).long()
    g1 = table_ext[:, :128].index_select(0, idx).reshape(r, p, 128)
    g2 = table_ext[:, 128:128 + f2].index_select(0, idx).reshape(r, p, f2)
    x1, x2, se = fused_gram_cg_wide_plain(
        g1, g2, vals, nnz, x0[:, :128], x0[:, 128:128 + f2], lam, cg_iters,
        cg_tol)
    return torch.cat([x1, x2, x1.new_zeros((r, 128 - f2))], dim=1), se


def gather_gram_cg_wide(table_ext, cols, vals, nnz, x0, lam: float, f2: int,
                        cg_iters: int = 6, cg_tol: float = 1e-4):
    """Solve one chunk of rows at a factor width 128 < F <= 256 over its
    128 + f2 live lanes only (pallas_solve.gather_gram_cg_wide):
    gather + two-block Gram + regularized CG + per-row train error.

    table_ext (n+1, 256) f32/bf16, zero-extended (a bf16 run casts the
    table before the gather); cols (R, P) int32, pad id n, pad slots at
    each row's tail; vals (R, P) f32/bf16; nnz (R,) int32; x0 (R, 256)
    f32; f2 = wide_f2(F) in {32, 64, 96, 128}. Lanes >= 128 + f2 of the
    table and of x0 are neither read nor computed. Returns x (R, 256) f32
    with lanes >= 128 + f2 exactly 0 and se (R, 1) f32."""
    if f2 not in (32, 64, 96, 128):
        raise ValueError(f"gather_gram_cg_wide: f2 must be 32, 64, 96 or "
                         f"128, got {f2}")
    if _on_cpu(table_ext, cols, vals, nnz, x0):
        return gather_gram_cg_wide_plain(table_ext, cols, vals, nnz, x0,
                                         lam, f2, cg_iters, cg_tol)
    r, p = cols.shape
    _check("table_ext", table_ext, (table_ext.shape[0], 256), _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    _check("nnz", nnz, (r,), (torch.int32,))
    _check("x0", x0, (r, 256), (torch.float32,))
    x = torch.empty((r, 256), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _launch("gather_gram_cg_wide", table_ext.data_ptr(),
                _bf16(table_ext), cols.data_ptr(), vals.data_ptr(),
                _bf16(vals), nnz.data_ptr(), x0.data_ptr(), x.data_ptr(),
                se.data_ptr(), r, p, int(f2), float(lam), int(cg_iters),
                float(cg_tol))
    return x, se


def fused_gram_cg_cat_plain(g1, g2, vals, nnz, x0, lam: float,
                            cg_iters: int = 6, cg_tol: float = 1e-4):
    """Plain version of K8: cat + zero pad to 256 lanes, f32 einsums,
    then the monolithic tail (_solve_and_se)."""
    r, p, _ = g1.shape
    g = torch.cat([g1, g2, g1.new_zeros((r, p, 128 - g2.shape[2]))],
                  dim=2).float()
    v = vals.float()
    a = torch.einsum("rpf,rpg->rfg", g, g)
    b = torch.einsum("rp,rpf->rf", v, g)
    r2 = (v * v).sum(-1, keepdim=True)
    del g
    return _solve_and_se(a, b, r2, nnz, x0, lam, cg_iters, cg_tol)


def fused_gram_cg_cat(g1, g2, vals, nnz, x0, lam: float, cg_iters: int = 6,
                      cg_tol: float = 1e-4):
    """Fused Gram + CG over a lane-packed, already gathered G
    (pallas_solve.fused_gram_cg_cat): g1 (R, P, 128) and g2 (R, P, f2),
    f2 <= 128, both f32 or both bf16, joined to 256 lanes with zeros
    above 128 + f2; vals (R, P) f32/bf16; nnz (R,) int32; x0 (R, 256)
    f32. Solves the full 256-lane system (the dead lanes carry the
    diagonal only). Returns x (R, 256) f32 and se (R, 1) f32."""
    if _on_cpu(g1, g2, vals, nnz, x0):
        return fused_gram_cg_cat_plain(g1, g2, vals, nnz, x0, lam, cg_iters,
                                       cg_tol)
    r, p, _ = g1.shape
    f2 = g2.shape[2] if g2.dim() == 3 else 0
    if not 1 <= f2 <= 128:
        raise ValueError(f"fused_gram_cg_cat: g2 must hold 1 to 128 lanes, "
                         f"got shape {tuple(g2.shape)}")
    _check("g1", g1, (r, p, 128), _FLOATS)
    _check("g2", g2, (r, p, f2), (g1.dtype,))
    _check("vals", vals, (r, p), _FLOATS)
    _check("nnz", nnz, (r,), (torch.int32,))
    _check("x0", x0, (r, 256), (torch.float32,))
    x = torch.empty((r, 256), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _launch("fused_gram_cg_cat", g1.data_ptr(), g2.data_ptr(),
                _bf16(g1), vals.data_ptr(), _bf16(vals), nnz.data_ptr(),
                x0.data_ptr(), x.data_ptr(), se.data_ptr(), r, p, f2,
                float(lam), int(cg_iters), float(cg_tol))
    return x, se
