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
(K1 at f = 256, K7 and K8    ``_kernel_wide``,           csrc/wide_span_gram.cu
in two passes: pass 1 FMA    ``_kernel`` at 256 lanes,   or wide_span_gram_mma.cu,
or tensor cores, pass 2)     ``_kernel_cat``             csrc/wide_span_solve.cu
``gram_span_sum`` (pass 2    ``_gram_kernel``,           csrc/gram_span_sum.cu
of K2's and K5a's cut)       ``_gram_kernel_aug``
``frag_span_solve`` (pass 2  ``_kernel``,                csrc/frag_span_solve.cu
of K1's and K6's cut)        ``_kernel_aug``
``tile_gram`` (f >= 384:     ``_gram_kernel``,           csrc/tile_gram.cu
K2, K5a; pass 1 of K1, K6)   ``_gram_kernel_aug``,
                             ``_kernel``, ``_kernel_aug``
``global_cg`` (f >= 384:     ``_cg_solve_reg_kernel``,   csrc/global_cg.cu
K3, K4, K5b; pass 2 of K1,   ``_cg_solve_kernel``,
K6)                          ``_cg_solve_aug_kernel``
===========================  ==========================  ==========================

(TPU kernels: cumf_als_tpu/ops/pallas_solve.py.) Each wrapper takes its
plain version for tensors on the CPU and launches its kernel for tensors
on a CUDA device; anything else raises. The two passes of the row cut
are the card half of ``gather_gram_cg`` at f = 256 and
``gather_gram_cg_wide``, whose CPU tensors take the uncut plain
versions: their wrappers take card tensors only, and `row_cut_plain` is
the plain version of the pair; so are the two passes of K1's and K6's
cut at f = 128 (`theta_span_grams`, ``frag_span_solve``), whose plain
version is `theta_cut_plain`. There is no fallback from the kernel to
the plain version. On the card the plain versions are only called to
check the kernels against them. The plain versions' float32 products
run in full float32 whatever TF32 setting the caller chose
(`full_f32`), as the JAX package's run at Precision.HIGHEST.

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
the second. The panel Grams (K2, K5a) and the batched solves (K3, K4,
K5b) take f = 256 too, so the accumulate-then-solve routes (the panel
and batched-panel routes, out-of-core theta, the sharded partials) run
at those widths; so does the augmented fused kernel (K6, with
aug_gram="force" at 128 < F < 256), as K1 runs there.

The Gram kernels K1, K2, K5a and K6 are bound by operations on an H100
(K2 and K5a by the write of A as well when A is f32), and what feeds
them is the L2: the table stays there, but every slot moves its 256-byte
table row to an SM. For a bf16 table at f = 128, the main path, they
gather with cp.async into a ring of swizzled bf16 tiles and run the Gram
on the tensor cores (csrc/gram_mma.cuh); K1 and K6 stop each row at its
nnz and run the CG on the wgmma fragment in registers
(csrc/frag_cg.cuh). On a float32 table at f = 128 and 256 K2 and K5a cut
each entry into three bf16 pieces and run six of their products on the
same tensor cores (csrc/split_gram_mma.cuh at 128, csrc/
wide_split_mma.cuh at 256, `panel_body` "split"), which keeps A to f32
accuracy; K1 and K6 there, and every kernel at f < 128, keep the f32
FMA bodies of csrc/common.cuh and csrc/wide.cuh. `gram_body` is the
rule of K1, K6 and K7, `panel_body` that of K2 and K5a. One block takes
one row at a time, so a chunk with fewer rows than the blocks that fit
the card would leave SMs idle: K2 and K5a cut such a chunk at f = 128
and 256 (a bf16 or a float32 table)
(`gram_spans`, from the shape, the table's dtype and the SM count
alone): each row's P slots in S spans of whole 64-slot tiles, the kernel
run unchanged over the (R S, P / S) view of cols and vals (span s of row
r is its row r S + s) writing f32 partials to scratch, then pass 2
(``gram_span_sum``) adding each row's S partials in span order into A in
its dtype and b, so a result repeats bit for bit; the cut is bound by
the gather, now spread over the card, and the partials' bytes. K1 and
K6 cut such a chunk at f = 128 by the same rule (`theta_spans`): pass 1
is their own entry point over the same view, each span stopping at its
row's nnz and writing an f32 record (A, b and r2; K6's A'), counted
under "gather_gram_cg" or "gather_gram_cg_aug" as the uncut launch is,
and pass 2 (``frag_span_solve``) adds each row's live records in span
order and runs the uncut kernel's CG and train error on them
(csrc/frag_cg.cuh), so a chunk counts one launch of its kernel whether
cut or not, and one of pass 2 when cut. The shorter f32 sums of a span
also bound the error of A, b and r2 on a long row.

K1 and K6 at f = 256 and K7 (the 256-lane body, csrc/wide.cuh) run as
two passes that meet at a record in scratch memory: pass 1 writes the
Gram, b and r2 of each span of a row's slots (K6: the Gram A' with the
values in lane 255), pass 2 (``wide_span_solve``) adds a row's records
in span order and runs the CG (K6: b and r2 taken from A' first), so a
result repeats bit for bit. With a bf16 table (`gram_body` "wgmma")
every chunk takes them, pass 1 on the tensor cores
(``wide_span_gram_mma``: three 128 x 128 blocks of A, each on
gram_mma.cuh's wgmma over a cp.async ring) in the spans of
`row_spans`: one span a row on a chunk of as many
rows as the card has SMs, unless a row is longer than
`SPAN_MAX_TILES_MMA` tiles (the error of the fragment's f32 sums grows
with the span), and the cut below that; its bound is the gather and the
record's bytes, no longer the FMA rate. A float32 table keeps the FMA
body: one block a row (the uncut kernels), or on a chunk with fewer rows
than the card has SMs the cut with pass 1 on the FMA body
(``wide_span_gram``). The records of one launch stay under
`SPAN_SCRATCH_BYTES` (a chunk is cut into batches of rows). K8 takes
the same two passes for a bf16 G whose f2 is a multiple of 32
(`cat_body`): pass 1 reads the two slabs g1 and g2 where the gather
reads the table, and sums every slot up to P, as `_kernel_cat` does; a
float32 G keeps the uncut FMA body. Each pass counts its own launches.

K2 and K5a at f = 256 write the whole symmetric A: a bf16 table runs
the panel body of csrc/wide_gram_mma.cuh on the tensor cores (one block
of two warpgroups a row of A, each slot gathered once, A written through
shared memory; a chunk of fewer rows than SMs in the cut above, or,
where the cut leaves it whole and 3 R is at most the SM count, the row
cut's three-block pass 1), a float32 table the same strips and epilogue
on the three bf16 pieces of each entry (csrc/wide_split_mma.cuh, 32-slot
tiles; a chunk of fewer rows than SMs in the cut above).

K3 (``solve_cg_reg``), K4 (``solve_cg``) and K5b (``solve_cg_aug``) are
one body (csrc/bulk_cg.cuh) with a compile-time switch each: persistent
blocks (`cg_grid`) that bring each system's A, b and x0 into
shared-memory stages with bulk-async copies and run the CG with A in
registers. At f <= 128 one block a system, a ring of two stages, two
block-wide barriers a step; at f = 256 one cluster of two blocks a
system, each block holding half of A's rows, A p exchanged between the
two through distributed shared memory once a step, so A is read from
device memory once a system there too.

Factor widths F > 256 pad to f = 128 T lanes, T >= 3 (`tiled`). There
every route runs two kernels and no other: ``tile_gram``, the Gram in
128 x 128 tiles of A (`tile_gram_body`: on a bf16 table at f = 384 and
512 a thread-block cluster a row, `cluster_plan`, each slab of the
gathered rows gathered once and handed between the blocks over
distributed shared memory, on the tensor cores; at f >= 640 one block a
row and a tile; an FMA tile a block on a float32 table), for K2 and K5a
and as pass 1 of K1 and K6 (f32 scratch of A, b and r2 in row batches
under `TILED_SCRATCH_BYTES`); and ``global_cg``, the CG with each
system's A read from device memory at every matvec (an f32 A of 576 KB
at f = 384 fits no SM), for K3, K4 and K5b and as pass 2 of K1 and K6.
Each counts its own launches. K2 and K5a cut a chunk of fewer rows than
the clusters that fit the card on the cluster body as at f = 128
(`gram_spans`, then ``gram_span_sum``); K1's and K6's `spans` is refused
there.

The row gather runs inside the kernels, so the wrappers keep the
contracts of the JAX wrappers (`gather_gram_cg`, `gather_gram_out`,
`gather_gram_aug_out`, `gather_gram_cg_wide`), not those of the inner
``pallas_call``; ``fused_gram_cg_cat`` has no gather wrapper there and
keeps its own.
Importing this module builds and loads nothing (see ops/_build.py).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch

from cumf_als_tpu_torch.ops import _build
from cumf_als_tpu_torch.ops.precision import full_f32

# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {name: 0 for name in _build.KERNELS}

_FLOATS = (torch.float32, torch.bfloat16)
TILE_LANES = 128     # lanes of a slab and of a tile of A at f >= 384
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


def _on_card(name: str, *tensors, plain: str = "row_cut_plain") -> None:
    """Raises unless the tensors lie on the current CUDA device: a
    kernel that is only ever the card half of another wrapper's route
    (on the CPU its route's plain version is `plain`)."""
    if _on_cpu(*tensors):
        raise ValueError(f"{name}: takes card tensors only (on the CPU the "
                         f"plain version is {plain})")


def _check(name: str, t: torch.Tensor, shape, dtypes) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def tiled(f: int) -> bool:
    """Whether width f takes the kernels of factor widths F > 256: f a
    multiple of 128 from 384 on (``tile_gram``, ``global_cg``)."""
    return f >= 384 and f % TILE_LANES == 0


def _check_f(name: str, f: int) -> None:
    """f must be a multiple of 16 up to 128, 256, or a multiple of 128
    from 384 on."""
    if f == 256 or tiled(f) or (f % 16 == 0 and 16 <= f <= 128):
        return
    raise ValueError(f"{name}: the kernel takes f a multiple of 16 up to "
                     f"128 or f = 256, or f a multiple of 128 from 384 on, "
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
@full_f32()
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
@full_f32()
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


@full_f32()
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


@full_f32()
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
                   aug: bool = False, spans: Optional[int] = None):
    """Solve one chunk of rows: gather + Gram + regularized CG + per-row
    train squared error (pallas_solve.gather_gram_cg).

    table_ext (n+1, f) f32/bf16, zero-extended (a bf16 run casts the
    table before the gather, as models/als.py does), f a multiple of 16
    up to 128, 256, or a multiple of 128 from 384 on; cols (R, P) int32,
    pad id n, pad slots at each row's tail; vals (R, P) f32/bf16; nnz
    (R,) int32; x0 (R, f) f32. Returns x (R, f) f32 and se (R, 1) f32.

    aug=True takes the augmented-lane kernel (K6, counted as
    "gather_gram_cg_aug"): lane f-1 of the table must be all zero (true
    factor width < f) and lane f-1 of x0 zero; the values ride lane f-1
    of G, rounded to the table's dtype, and lane f-1 of x comes back
    exactly 0. On a card the Gram runs in the body `gram_body` names; on
    the tensor cores the bf16 products are exact and the f32 sums are
    taken in the hardware's order.

    At f = 128 a bf16 table on a chunk of fewer rows than the blocks
    that fit the card, P a whole number of 64-slot tiles, takes the cut
    of `theta_spans`: pass 1 the kernel's own entry point over the
    (R S, P / S) view, counted under "gather_gram_cg" or
    "gather_gram_cg_aug" as the uncut kernel is, then pass 2,
    ``frag_span_solve`` (its plain version: `theta_cut_plain`). Every
    other chunk at f = 128 runs the uncut kernel, one block a row.

    At f = 256 a bf16 table takes the two passes of the row cut on every
    chunk, pass 1 on the tensor cores; a float32 table takes them on a
    chunk with fewer rows than the card has SMs (`row_spans`) and the
    uncut kernel otherwise; with aug both in the aug layout (pass 1's
    records hold A', pass 2 unpacks b and r2 from it). Each kernel
    counts its own launches: a chunk on the two passes counts one under
    each pass and none under "gather_gram_cg" or "gather_gram_cg_aug",
    which count the uncut kernel. At f >= 384 (F > 256) every chunk
    takes the two passes of `_tiled_gram_cg`, ``tile_gram`` then
    ``global_cg``, each counting its own launches, in row batches whose
    f32 scratch stays under `TILED_SCRATCH_BYTES`. `spans` forces the
    number of spans a row is cut into (1: one span a row, which at
    f = 128, and on a float32 table at 256, is the uncut kernel) and is
    taken at f = 128 and 256 only; at f = 128 a cut (spans > 1) needs a bf16 table and P
    a multiple of 64 spans. Tensors on the CPU take the plain version
    whatever `spans` says."""
    name = "gather_gram_cg_aug" if aug else "gather_gram_cg"
    _check_spans(name, spans, table_ext.shape[1] in (128, 256))
    if _on_cpu(table_ext, cols, vals, nnz, x0):
        plain = gather_gram_cg_aug_plain if aug else gather_gram_cg_plain
        return plain(table_ext, cols, vals, nnz, x0, lam, cg_iters, cg_tol)
    r, p = cols.shape
    f = table_ext.shape[1]
    _check_f(name, f)
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    _check("nnz", nnz, (r,), (torch.int32,))
    _check("x0", x0, (r, f), (torch.float32,))
    if r and f == 128:
        s = _gram_spans_of(name, table_ext, r, p, spans, rule=theta_spans,
                           body=gram_body)
        if s > 1:
            part = theta_span_grams(table_ext, cols, vals, nnz, s, aug)
            return frag_span_solve(part, nnz, x0, lam, p, s, cg_iters,
                                   cg_tol, aug)
    if r and f == 256:
        n_spans, span_len = _chunk_spans(x0.device, r, p, spans,
                                         **span_plan(table_ext))
        if n_spans > 1 or gram_body(table_ext) == "wgmma":
            return _row_cut(table_ext, cols, vals, nnz, x0, lam, 256,
                            n_spans, span_len, cg_iters, cg_tol, aug)
    if tiled(f):
        return _tiled_gram_cg(table_ext, cols, vals, nnz, x0, lam, cg_iters,
                              cg_tol, aug)
    x = torch.empty((r, f), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _check_gram_table(table_ext, cols)
        _launch(name, table_ext.data_ptr(), _bf16(table_ext),
                cols.data_ptr(), vals.data_ptr(), _bf16(vals),
                nnz.data_ptr(), x0.data_ptr(), x.data_ptr(), se.data_ptr(),
                r, p, f, float(lam), int(cg_iters), float(cg_tol), None,
                0)
    return x, se


# ------------------------------------------- K2 / K5a the panel Grams --
def gram_body(table_ext: torch.Tensor) -> str:
    """Which Gram body the kernels K1, K6 and K7 (and K2 and K5a but for
    a float32 table at f = 128 or 256, `panel_body` "split") run for this
    table on a card, by its dtype and width alone: "wgmma" (cp.async
    gather into swizzled bf16 tiles, tensor-core Gram) for a bf16 table
    at f = 128, the width of the main path (csrc/gram_mma.cuh; for K1 and
    K6 the CG on the fragment of csrc/frag_cg.cuh), and at f = 256 (K1, K6
    and K7: pass 1 of the row cut on the tensor cores,
    csrc/wide_span_gram_mma.cu, then pass 2; K2 and K5a: the panel body
    of csrc/wide_gram_mma.cuh), and at f = 128 T, T >= 3 (the tiled Gram
    of csrc/tile_gram.cu); "fma" (the f32 FMA bodies of csrc/common.cuh,
    csrc/wide.cuh and tile_gram.cu) for a float32 table, whose entries
    bf16 tensor cores would round (K2 and K5a at f = 128 and 256 split
    them into three bf16 pieces instead), and for every other width. A
    caller cannot choose, and neither body gives way to the other or to
    the plain version."""
    f = table_ext.shape[1]
    if table_ext.dtype == torch.bfloat16 and (f in (128, 256) or tiled(f)):
        return "wgmma"
    return "fma"


def panel_body(table_ext: torch.Tensor) -> str:
    """Which Gram body the panel kernels K2 and K5a run for this table on
    a card, by its dtype and width alone: "split" for a float32 table at
    f = 128 and 256 (csrc/split_gram_mma.cuh and csrc/wide_split_mma.cuh:
    each entry cut into three bf16 pieces, hi + mid + lo, and six of
    their products, all but mid.lo, lo.mid and lo.lo, summed in f32 on
    the tensor cores), and what `gram_body` says for every other table.
    Neither body gives way to another or to the plain version."""
    if table_ext.dtype == torch.float32 and table_ext.shape[1] in (128, 256):
        return "split"
    return gram_body(table_ext)


def _check_gram_table(table_ext: torch.Tensor, cols: torch.Tensor,
                      body: Optional[str] = None) -> None:
    """The tensor-core bodies (`body`, default `gram_body`'s: "wgmma", or
    K2's and K5a's "split") copy 16 bytes at a time: the table's rows
    must lie on 16-byte boundaries. They count a chunk's slots in 32
    bits."""
    if (body or gram_body(table_ext)) not in ("wgmma", "split"):
        return
    if table_ext.data_ptr() % 16:
        raise ValueError("table_ext: its storage must start on a 16-byte "
                         "boundary")
    if cols.numel() >= 2 ** 31:
        raise ValueError(f"cols: {cols.numel()} slots, the kernel takes "
                         f"fewer than 2^31")


@full_f32()
def gather_gram_out_plain(table_ext, cols, vals,
                          out_dtype: torch.dtype = torch.float32):
    """Plain version of K2: index_select, f32 einsum, A cast at the end."""
    g = _gather(table_ext, cols).float()
    a = torch.einsum("rpf,rpg->rfg", g, g)
    b = torch.einsum("rp,rpf->rf", vals.float(), g)
    return a.to(out_dtype), b


def gather_gram_out(table_ext, cols, vals,
                    out_dtype: torch.dtype = torch.float32,
                    spans: Optional[int] = None):
    """Raw partial (A, b) of one panel chunk, no regularizer
    (pallas_solve.gather_gram_out). table_ext (s+1, f) f32/bf16 with a
    zero row at the pad id s; cols (R, P) int32 panel-local; vals (R, P)
    f32/bf16. Returns A (R, f, f) in out_dtype (summed in f32) and
    b (R, f) f32; f a multiple of 16 up to 128, 256, or a multiple of
    128 from 384 on (``tile_gram`` there). On a card the
    Gram runs in the body `panel_body` names; on the tensor cores the
    bf16 products (of a float32 table's three pieces) are exact and the
    f32 sums are taken in the hardware's order, and a chunk of few rows
    takes the cut of `gram_spans` (each row's slots in S spans across
    blocks, then ``gram_span_sum``).
    `spans` forces S on a card (1: the uncut kernel); tensors on the CPU
    take the plain version whatever it says."""
    if _on_cpu(table_ext, cols, vals):
        return gather_gram_out_plain(table_ext, cols, vals, out_dtype)
    return _panel_gram("gather_gram_out", table_ext, cols, vals, out_dtype,
                       spans, aug=False)


# ----------------------------------------------------- K3 solve_cg_reg --
def solve_cg_reg_plain(a, diag, b, x0, cg_iters: int = 6,
                       cg_tol: float = 1e-4):
    """Plain version of K3: CG on f32(A) + diag I."""
    f = a.shape[-1]
    af = a.float() + diag.float()[:, None, None] * _eye(f, a.device)
    return cg_loop_plain(af, b.float(), x0.float(), cg_iters, cg_tol)


@functools.lru_cache(maxsize=None)
def _cg_blocks_per_sm(index: int, kernel: str, f: int, a_bf16: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.load(f"{kernel}_blocks_per_sm")(
            f, a_bf16, ctypes.addressof(out))
    if err or out.value < 1:
        raise RuntimeError(f"{kernel}: occupancy query at f = {f}: CUDA "
                           f"error {err}, {out.value} blocks an SM")
    return out.value


def cg_blocks_per_sm(device, f: int, dtype: torch.dtype, kernel: str) -> int:
    """Blocks of the batched CG `kernel` (K3 "solve_cg_reg", K4
    "solve_cg" or K5b "solve_cg_aug", one body) at this f and A dtype
    that fit one SM of the card `device` names, as the kernel's own
    occupancy query gives them from its registers and shared memory
    (csrc/bulk_cg.cuh): two at f = 128 with a bf16 A, one with an f32 A
    (two rings of two stages pass the SM's shared memory), more at
    smaller f (three at f = 96 with an f32 A). At f = 256 it counts
    clusters, not blocks an SM: the clusters of two blocks (one system
    each) that the whole card holds at once
    (cudaOccupancyMaxActiveClusters, as the GPCs place them): an f32
    tile takes one block an SM (66 clusters on an H100), a bf16 tile two
    (132). Widths f >= 384 run ``global_cg``, which has no such grid:
    they raise here.
    """
    _check_bulk_f(kernel, f)
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _cg_blocks_per_sm(index, kernel, f,
                             int(dtype == torch.bfloat16))


def _check_bulk_f(kernel: str, f: int) -> None:
    """The bulk body copies a system's A whole into shared memory (at
    f = 256 half of it into each block of a cluster): it takes the widths
    of `_check_f` but those of ``global_cg``."""
    _check_f(kernel, f)
    if tiled(f):
        raise ValueError(f"{kernel}: the bulk CG takes f up to 256, got {f} "
                         f"(f >= 384 runs global_cg)")


def cg_grid(r: int, sms: int, per_sm: int, clusters: int = 0) -> int:
    """Persistent blocks of one K3, K4 or K5b launch over R systems: one
    a system up to the blocks that fit the card at once, `per_sm` on each
    of `sms` SMs; above that each block walks R / grid systems. At
    f = 256 a system takes a cluster of two blocks: given `clusters`,
    what `cg_blocks_per_sm` counts there (the clusters the card holds),
    two blocks a system up to that many clusters (`sms` and `per_sm` are
    not read), so the grid is even, 2 <= grid <= 2 R."""
    if clusters:
        return 2 * max(1, min(r, clusters))
    return max(1, min(r, per_sm * sms))


def solve_grid(device, r: int, f: int, dtype: torch.dtype,
               kernel: str) -> int:
    """The grid of one launch of `kernel` (K3, K4 or K5b) over R systems
    at this f and A dtype on the card `device` names: `cg_grid` from the
    kernel's occupancy query (clusters at f = 256); f <= 128 or 256."""
    units = cg_blocks_per_sm(device, f, dtype, kernel)
    if f == 256:
        return cg_grid(r, 0, 0, clusters=units)
    return cg_grid(r, _sms(device), units)


def _bulk_solve(name: str, a, diag, b, x0, cg_iters: int, cg_tol: float):
    """Checks and one launch of the batched CG `name` (K3, K4 or K5b) on
    card tensors: a (R, f, f) f32/bf16, f a multiple of 16 up to 128 or
    256; diag (R,) f32 or None (K4); b (R, f) f32 or None (K5b); x0 (R, f)
    f32. The kernel copies each system's A, b and x0 whole into shared
    memory (at f = 256 each of two blocks half of A's rows): their
    storage must start on 16-byte boundaries. At f >= 384 the solve is
    ``global_cg``'s (A read from device memory at every matvec), counted
    under its own name."""
    r, f, _ = a.shape
    _check_f(name, f)
    _check("a", a, (r, f, f), _FLOATS)
    if diag is not None:
        _check("diag", diag, (r,), (torch.float32,))
    if b is not None:
        _check("b", b, (r, f), (torch.float32,))
    _check("x0", x0, (r, f), (torch.float32,))
    for what, t in (("a", a), ("b", b), ("x0", x0)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: the storage of {what} must start on "
                             f"a 16-byte boundary")
    if tiled(f):
        return global_cg(a, x0, cg_iters, cg_tol, diag=diag, b=b,
                         aug=name == "solve_cg_aug")
    x = torch.empty((r, f), dtype=torch.float32, device=a.device)
    if r:
        grid = solve_grid(a.device, r, f, a.dtype, name)
        _launch(name, a.data_ptr(), _bf16(a),
                None if diag is None else diag.data_ptr(),
                None if b is None else b.data_ptr(), x0.data_ptr(),
                x.data_ptr(), r, f, int(cg_iters), float(cg_tol), grid)
    return x


def solve_cg_reg(a, diag, b, x0, cg_iters: int = 6, cg_tol: float = 1e-4):
    """Batched CG on the raw Gram plus a per-system diagonal
    (pallas_solve.solve_cg_pallas with diag). a (R, f, f) f32/bf16,
    diag (R,) f32, b and x0 (R, f) f32, f a multiple of 16 up to 128,
    256, or a multiple of 128 from 384 on (``global_cg`` there). Returns
    x (R, f) f32. On a card a, b and x0 must start on
    16-byte boundaries (csrc/bulk_cg.cuh)."""
    if _on_cpu(a, diag, b, x0):
        return solve_cg_reg_plain(a, diag, b, x0, cg_iters, cg_tol)
    return _bulk_solve("solve_cg_reg", a, diag, b, x0, cg_iters, cg_tol)


# --------------------------------------------------------- K4 solve_cg --
def solve_cg_plain(a, b, x0, cg_iters: int = 6, cg_tol: float = 1e-4):
    """Plain version of K4: CG on f32(A) as given."""
    return cg_loop_plain(a.float(), b.float(), x0.float(), cg_iters, cg_tol)


def solve_cg(a, b, x0, cg_iters: int = 6, cg_tol: float = 1e-4):
    """Batched CG on already regularized systems
    (pallas_solve.solve_cg_pallas without diag). a (R, f, f) f32/bf16,
    b and x0 (R, f) f32, f a multiple of 16 up to 128, 256, or a
    multiple of 128 from 384 on. Returns x (R, f) f32; a system of zeros
    returns its x0. On a card a, b and x0
    must start on 16-byte boundaries (K3's body, csrc/bulk_cg.cuh)."""
    if _on_cpu(a, b, x0):
        return solve_cg_plain(a, b, x0, cg_iters, cg_tol)
    return _bulk_solve("solve_cg", a, None, b, x0, cg_iters, cg_tol)


# --------------------------------------------- K5a gather_gram_aug_out --
@full_f32()
def gather_gram_aug_out_plain(table_ext, cols, vals,
                              out_dtype: torch.dtype = torch.float32):
    """Plain version of K5a: index_select, augment_g, f32 einsum, cast."""
    g = augment_g(_gather(table_ext, cols), vals).float()
    return torch.einsum("rpf,rpg->rfg", g, g).to(out_dtype)


def gather_gram_aug_out(table_ext, cols, vals,
                        out_dtype: torch.dtype = torch.float32,
                        spans: Optional[int] = None):
    """Raw partial augmented Gram A' of one panel chunk
    (pallas_solve.gather_gram_aug_out). table_ext (s+1, f) f32/bf16 with
    a zero row at the pad id s and lane f-1 all zero (true factor width
    < f); cols (R, P) int32 panel-local; vals (R, P) f32/bf16, rounded to
    the table's dtype as they enter lane f-1. Returns A' (R, f, f) in
    out_dtype (summed in f32): A in rows/columns < f-1, b in row and
    column f-1, sum v^2 in the corner; f a multiple of 16 up to 128,
    256, or a multiple of 128 from 384 on. On a card the Gram runs in the
    body `panel_body` names, a chunk of few rows in the cut of
    `gram_spans`, as K2's; `spans` as K2's."""
    if _on_cpu(table_ext, cols, vals):
        return gather_gram_aug_out_plain(table_ext, cols, vals, out_dtype)
    return _panel_gram("gather_gram_aug_out", table_ext, cols, vals,
                       out_dtype, spans, aug=True)[0]


# ------------------------- the cut of the panel Grams K2 and K5a --------
GRAM_TILE = 64      # slots of a tile of the tensor-core bodies (mma::kSlots)
# the fewest tiles of a span, and the spans of a chunk an SM (at most
# the blocks of the body that fit an SM): `gram_spans`
GRAM_CUT_MIN_TILES = 4
GRAM_CUT_TARGET = 2
# at f = 256 against the three-block body (3 R <= SMs): a span's tile
# costs this many of the three-block body's, and the cut this many tiles
# more (its two launches and the partials)
GRAM_CUT_TILE_COST_256 = 1.5
GRAM_CUT_EXTRA_TILES_256 = 8


def gram_blocks_per_sm(f: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Blocks of the tensor-core panel body that fit one SM: two at
    f = 128 on a bf16 table (csrc/gram_mma.cuh, 128 registers a thread),
    one on a float32 table there (the split body of
    csrc/split_gram_mma.cuh, ~195 KB of shared memory) and one at f = 256
    (the panel body of csrc/wide_gram_mma.cuh, ~200 KB, on a bf16 table;
    the split body of csrc/wide_split_mma.cuh, ~226 KB, on a float32
    one)."""
    return 2 if f == 128 and dtype == torch.bfloat16 else 1


def gram_spans(r: int, p: int, f: int, sms: int,
               dtype: torch.dtype = torch.bfloat16,
               min_tiles: int = GRAM_CUT_MIN_TILES,
               target: int = GRAM_CUT_TARGET) -> int:
    """S, the spans of whole `GRAM_TILE`-slot tiles each row of a K2 or
    K5a chunk of R rows of P slots is cut into on a card of `sms` SMs,
    from the shape alone: span s of row r covers slots [s L, (s + 1) L),
    L = P / S, and the S spans cover [0, P) once. S = 1 (the uncut
    kernel) unless the table takes a tensor-core panel body (f = 128 or
    256, a bf16 or a float32 table: `panel_body` "wgmma" or "split"), P
    is a whole number of tiles and R is below the blocks that fit the
    card at once (`gram_blocks_per_sm` an SM: 264 on a bf16 table at
    f = 128, 132 otherwise, on an H100); else
    the largest S that divides P's tiles, leaves no span under
    `min_tiles` tiles, keeps R S within `target` spans an SM (at most
    the body's blocks an SM) and the f32 partials of R S spans within
    `SPAN_SCRATCH_BYTES`. At f = 256 a chunk of 3 R <= SMs on a bf16
    table runs uncut on the three-block body (a float32 table has none),
    which spreads each row over three SMs: there
    the cut must beat it, GRAM_CUT_TILE_COST_256 T / S +
    GRAM_CUT_EXTRA_TILES_256 < T for T tiles a row, else S = 1. At
    f = 128 T', T' >= 3, the same rule on ``tile_gram``'s cluster body
    (a bf16 table, `tile_gram_body` "cluster"), with the clusters that
    fit the card (`tile_gram_clusters`) in place of the blocks: R below
    them, R S within them.

    The constants are measured (scripts/torch_gram_cut_sweep.py; PERF.md,
    the cut's findings; an H100 SXM at 700 W): over the 244 Netflix X
    panel chunks
    under 264 rows at f = 128, K2 took 7.857 ms at target 2 and min_tiles
    4 against 8.648 at target 1, 7.904 and 7.966 at min_tiles 2 and 8,
    and 10.328 uncut, and no chunk the cut took was slower than uncut;
    over the 207 chunks under 132 rows at f = 256, 7.385 ms against
    8.848 uncut, with four chunks of 3 R <= SMs and 960 to 1664 slots 1
    to 12% slower than the three-block body, which the last condition
    leaves whole (the three-block body there: 10.6 us + 1.41 us a tile,
    the cut 21.4 us + 2.1 us a tile of a span)."""
    tiles, rest = divmod(p, GRAM_TILE)
    if tiled(f):
        # the cluster body: one cluster a row, one block an SM
        items = tile_gram_clusters(f, sms) if dtype == torch.bfloat16 \
            else 0
        if rest or r >= items:
            return 1
    else:
        per_sm = gram_blocks_per_sm(f, dtype)
        if f not in (128, 256) or rest or r >= per_sm * sms:
            return 1
        items = min(target, per_sm) * sms
    record = (f * f + f) * 4
    best = 1
    for s in range(2, tiles // min_tiles + 1):
        if r * s > items or r * s * record > SPAN_SCRATCH_BYTES:
            break
        if tiles % s == 0:
            best = s
    if f == 256 and dtype == torch.bfloat16 and 3 * r <= sms and \
            GRAM_CUT_TILE_COST_256 * tiles / best + \
            GRAM_CUT_EXTRA_TILES_256 >= tiles:
        return 1
    return best


def _gram_spans_of(name: str, table_ext, r: int, p: int, spans,
                   rule=gram_spans, body=panel_body) -> int:
    """S for this chunk on this card: `rule` (`gram_spans`, or K1's
    `theta_spans` with `body` `gram_body`), or what `spans` forces (a
    divisor of P's whole tiles on a tensor-core body; 1 anywhere)."""
    f = table_ext.shape[1]
    if spans is None:
        return rule(r, p, f, _sms(table_ext.device), table_ext.dtype)
    s = int(spans)
    if s < 1:
        raise ValueError(f"{name}: spans must be at least 1, got {spans}")
    if s == 1:
        return 1
    cut = tile_gram_body(table_ext) == "cluster" if tiled(f) else \
        body(table_ext) in ("wgmma", "split")
    if not cut or p % (GRAM_TILE * s):
        raise ValueError(f"{name}: spans = {spans} cuts a chunk on a "
                         f"tensor-core body (a bf16 table at f = 128 or "
                         f"256, a float32 one there for K2 and K5a, or "
                         f"f = 384 or 512 on tile_gram's cluster body) "
                         f"whose P ({p}) is a multiple of {GRAM_TILE} x "
                         f"spans only")
    return s


def _panel_gram(name: str, table_ext, cols, vals, out_dtype, spans,
                aug: bool):
    """K2 (`name` "gather_gram_out") or K5a ("gather_gram_aug_out") on
    card tensors: (A, b), b None for K5a. At f >= 384 one launch of
    ``tile_gram`` (counted under its name). A chunk that `gram_spans` (or
    `spans`) cuts into S > 1 spans runs as two passes: the kernel itself
    (``tile_gram`` at f >= 384) over the (R S, P / S) view of cols and
    vals, each span a row of it, writing f32 partials (one launch,
    counted under `name`, or under "tile_gram"), then ``gram_span_sum``
    adding each row's S partials in span order into A in out_dtype (and
    b). Both passes repeat bit for bit."""
    r, p = cols.shape
    f = table_ext.shape[1]
    _check_f(name, f)
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {_FLOATS}")
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    dev = cols.device
    s = 1
    if r:
        _check_gram_table(table_ext, cols, panel_body(table_ext))
        s = _gram_spans_of(name, table_ext, r, p, spans)
    if tiled(f):
        if s > 1:
            a_part, b_part, _ = tile_gram(
                table_ext, cols.view(r * s, p // s), vals.view(r * s, p // s),
                None, torch.float32, aug=aug, with_b=not aug)
            return gram_span_sum(a_part, b_part, s, out_dtype)
        a, b, _ = tile_gram(table_ext, cols, vals, None, out_dtype, aug=aug,
                            with_b=not aug)
        return a, b

    def grams(a_out, b_out, rows, slots):
        args = (table_ext.data_ptr(), _bf16(table_ext), cols.data_ptr(),
                vals.data_ptr(), _bf16(vals), a_out.data_ptr(),
                _bf16(a_out))
        tail = (rows, slots, f)
        if aug:
            _launch(name, *args, *tail)
        else:
            _launch(name, *args, b_out.data_ptr(), *tail)

    if s > 1:
        a_part = torch.empty((r * s, f, f), dtype=torch.float32, device=dev)
        b_part = None if aug else torch.empty((r * s, f),
                                              dtype=torch.float32, device=dev)
        grams(a_part, b_part, r * s, p // s)
        return gram_span_sum(a_part, b_part, s, out_dtype)
    a = torch.empty((r, f, f), dtype=out_dtype, device=dev)
    b = None if aug else torch.empty((r, f), dtype=torch.float32,
                                     device=dev)
    if r:
        grams(a, b, r, p)
    return a, b


def gram_span_sum_plain(a_part, b_part, spans: int,
                        out_dtype: torch.dtype = torch.float32):
    """Plain version of pass 2 (``gram_span_sum``): the partials of each
    row's `spans` spans (rows r S .. r S + S - 1 of a_part (R S, f, f)
    and b_part (R S, f) f32, b_part None for K5a) added in span order, A
    cast to out_dtype. Returns (A, b)."""
    def add(parts):
        parts = parts.reshape(-1, spans, *parts.shape[1:])
        acc = parts[:, 0]
        for k in range(1, spans):
            acc = acc + parts[:, k]
        return acc
    return add(a_part).to(out_dtype), \
        None if b_part is None else add(b_part)


def gram_span_sum(a_part, b_part, spans: int,
                  out_dtype: torch.dtype = torch.float32):
    """Pass 2 of the cut of K2 and K5a (csrc/gram_span_sum.cu): the f32
    partials of each row's `spans` spans, a_part (R S, f, f) and b_part
    (R S, f) or None (K5a), added in span order into A (R, f, f) in
    out_dtype and b (R, f) f32 (None for K5a). Card tensors only; its
    plain version is `gram_span_sum_plain`."""
    _on_card("gram_span_sum", *(t for t in (a_part, b_part)
                                if t is not None),
             plain="gram_span_sum_plain")
    rs, f, _ = a_part.shape
    if spans < 1 or rs % spans:
        raise ValueError(f"gram_span_sum: {rs} partials are not rows of "
                         f"{spans} spans")
    r = rs // spans
    _check("a_part", a_part, (rs, f, f), (torch.float32,))
    if b_part is not None:
        _check("b_part", b_part, (rs, f), (torch.float32,))
    a = torch.empty((r, f, f), dtype=out_dtype, device=a_part.device)
    b = None if b_part is None else \
        torch.empty((r, f), dtype=torch.float32, device=a_part.device)
    if r:
        _launch("gram_span_sum", a_part.data_ptr(),
                None if b_part is None else b_part.data_ptr(), a.data_ptr(),
                _bf16(a), None if b is None else b.data_ptr(), r, spans, f)
    return a, b


@full_f32()
def gram_cut_plain(table_ext, cols, vals, spans: int,
                   out_dtype: torch.dtype = torch.float32,
                   aug: bool = False):
    """Plain version of the cut (K2, or K5a with aug): each of the
    `spans` equal spans of a row's slots gathered and its Gram (and b)
    summed in f32 (with aug the values ride lane f-1, `augment_g`), the
    spans' partials added in span order, A cast at the end. Returns
    (A, b), b None with aug."""
    r, p = cols.shape
    if p % spans:
        raise ValueError(f"gram_cut_plain: {spans} spans do not divide "
                         f"P = {p}")
    c = cols.reshape(r * spans, p // spans)
    v = vals.reshape(r * spans, p // spans)
    g = _gather(table_ext, c)
    if aug:
        g = augment_g(g, v)
    g = g.float()
    a_parts = torch.einsum("rpf,rpg->rfg", g, g)
    b_parts = None if aug else torch.einsum("rp,rpf->rf", v.float(), g)
    del g
    return gram_span_sum_plain(a_parts, b_parts, spans, out_dtype)


# ---------------------------- the cut of K1 and K6 at f = 128 ----------
# floats of one span's record (kRecordFloats of csrc/frag_cg.cuh): A
# (128 x 128), b (128), r2 (1), padded to a multiple of 4
THETA_RECORD_FLOATS = 128 * 128 + 128 + 4
# the fewest tiles of a span of K1's and K6's cut (`theta_spans`)
THETA_CUT_MIN_TILES = 8


def theta_spans(r: int, p: int, f: int, sms: int,
                dtype: torch.dtype = torch.bfloat16) -> int:
    """S, the spans each row of a K1 or K6 chunk of R rows of P slots is
    cut into on a card of `sms` SMs: on a bf16 table at f = 128 the rule
    of K2's cut, `gram_spans` (R below the two blocks an SM that fit the
    card and P a whole number of 64-slot tiles; the largest S of whole
    tiles with R S at most `GRAM_CUT_TARGET` spans an SM), with no span
    under `THETA_CUT_MIN_TILES` tiles where K2 takes four; 1 on a float32
    table (the uncut FMA body) and at every other width (f = 256 has the
    row cut of `row_spans`). On an H100 (132 SMs) the widest direct theta
    chunk of sharded out-of-core training, 8 x 196,608, takes S = 32, the
    hugewiki driver's 32 x 81,920 S = 8.

    The constants are measured (scripts/torch_theta_cut_sweep.py;
    PERF.md, the cut's findings; an H100 SXM at 700 W): K1's rows stop at
    their nnz, and a few-row chunk's rows are often far shorter than P
    (Netflix's 8 x 8192 holds 125 live tiles of 1,024), so spans past
    the rows' ends cost launches and records for nothing. Over the 22
    Netflix theta chunks the cut can take, K1 took 1.012 ms at min_tiles
    8 against 1.213 at 4 and 1.365 at 1 or 2 (2.267 uncut, 0.989 at each
    chunk's best S), target 2 against 1: 1.012 against 1.024; over the 41
    of hugewiki_mini's in-core theta plan 6.436 against 6.440 (43.664
    uncut; target 1: 7.626); over the 49 of the hugewiki driver's 18.777
    at every min_tiles (94.520 uncut; target 1: 26.312)."""
    if f != 128 or dtype != torch.bfloat16:
        return 1
    return gram_spans(r, p, f, sms, dtype, min_tiles=THETA_CUT_MIN_TILES)


def theta_span_grams(table_ext, cols, vals, nnz, spans: int,
                     aug: bool = False) -> torch.Tensor:
    """Pass 1 of the cut of K1 (with aug, K6) at f = 128: the records
    (R S, THETA_RECORD_FLOATS) f32 of each span of each row, span s of
    row r (record r S + s) over slots [s L, min((s + 1) L, nnz, P)),
    L = P / S: its A row-major, then b and r2 (`theta_records_unpack`);
    with aug the values ride lane 127 of G, rounded to bf16, and A holds
    A' alone. The kernel's own entry point runs it, so the launch counts
    under "gather_gram_cg" (or "gather_gram_cg_aug"). table_ext (n+1,
    128) bf16 on a 16-byte boundary, cols and vals (R, P), P a multiple
    of 64 S, nnz (R,) int32, all on the card. A span with no slots is
    left as `torch.empty` made it (pass 2 reads only live spans)."""
    name = "gather_gram_cg_aug" if aug else "gather_gram_cg"
    _on_card(name, table_ext, cols, vals, nnz, plain="theta_cut_plain")
    r, p = cols.shape
    if gram_body(table_ext) != "wgmma" or table_ext.shape[1] != 128 or \
            spans < 1 or p % (GRAM_TILE * spans):
        raise ValueError(f"{name}: its cut takes a bf16 table at f = 128 "
                         f"and P a multiple of {GRAM_TILE} x spans, got "
                         f"{table_ext.dtype}, f = {table_ext.shape[1]}, "
                         f"P = {p}, spans = {spans}")
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    _check("nnz", nnz, (r,), (torch.int32,))
    _check_gram_table(table_ext, cols)
    part = torch.empty((r * spans, THETA_RECORD_FLOATS),
                       dtype=torch.float32, device=cols.device)
    if r:
        _launch(name, table_ext.data_ptr(), 1, cols.data_ptr(),
                vals.data_ptr(), _bf16(vals), nnz.data_ptr(), None, None,
                None, r, p, 128, 0.0, 0, 0.0, part.data_ptr(), int(spans))
    return part


def theta_records_unpack(part: torch.Tensor, r: int, spans: int):
    """(A, b, r2) of K1's span records (R S, THETA_RECORD_FLOATS) as
    (R, S, 128, 128), (R, S, 128) and (R, S, 1); K6's records hold A'
    in A alone."""
    f = 128
    rec = part.view(r, spans, THETA_RECORD_FLOATS)
    return (rec[..., :f * f].reshape(r, spans, f, f),
            rec[..., f * f:f * f + f], rec[..., f * f + f:f * f + f + 1])


@full_f32()
def frag_span_solve_plain(part, nnz, x0, lam: float, p: int, spans: int,
                          cg_iters: int = 6, cg_tol: float = 1e-4,
                          aug: bool = False):
    """Plain version of pass 2 (``frag_span_solve``): each row's live
    records (span s live below min(nnz, P), s P / S < min(nnz, P); the
    others were never written) added in span order, then the tail the
    fused kernels share (`_solve_and_se`); with aug b and r2 come out of
    the summed A' (`unpack_aug`)."""
    r = nnz.shape[0]
    a_s, b_s, r2_s = theta_records_unpack(part, r, spans)
    live = _span_live(nnz, p, spans, p // spans)
    a, b, r2 = (torch.zeros_like(t[:, 0]) for t in (a_s, b_s, r2_s))
    for k in range(spans):
        on = live[:, k]
        a = a + torch.where(on[:, None, None], a_s[:, k], 0.0)
        b = b + torch.where(on[:, None], b_s[:, k], 0.0)
        r2 = r2 + torch.where(on[:, None], r2_s[:, k], 0.0)
    if aug:
        a, b, r2 = unpack_aug(a)
    return _solve_and_se(a, b, r2, nnz, x0, lam, cg_iters, cg_tol)


def frag_span_solve(part, nnz, x0, lam: float, p: int, spans: int,
                    cg_iters: int = 6, cg_tol: float = 1e-4,
                    aug: bool = False):
    """Pass 2 of the cut of K1 and K6 at f = 128
    (csrc/frag_span_solve.cu): part (R S, THETA_RECORD_FLOATS) f32 from
    pass 1 over P = `p` slots a row in `spans` spans, nnz (R,) int32, x0
    (R, 128) f32. Each row's live records added in span order, then the
    regularized CG and the train error as K1 (with aug K6: b and r2 from
    row 127 of the summed A', lane 127 of x exactly 0) runs them. Returns
    x (R, 128) f32 and se (R, 1). Card tensors only; its plain version
    is `frag_span_solve_plain`."""
    _on_card("frag_span_solve", part, nnz, x0, plain="frag_span_solve_plain")
    r = nnz.shape[0]
    if spans < 1 or p % spans:
        raise ValueError(f"frag_span_solve: {spans} spans do not cut "
                         f"P = {p}")
    _check("part", part, (r * spans, THETA_RECORD_FLOATS), (torch.float32,))
    _check("nnz", nnz, (r,), (torch.int32,))
    _check("x0", x0, (r, 128), (torch.float32,))
    x = torch.empty((r, 128), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _launch("frag_span_solve", part.data_ptr(), nnz.data_ptr(),
                x0.data_ptr(), x.data_ptr(), se.data_ptr(), r, int(p),
                int(spans), int(aug), float(lam), int(cg_iters),
                float(cg_tol))
    return x, se


def theta_cut_plain(table_ext, cols, vals, nnz, x0, lam: float, spans: int,
                    cg_iters: int = 6, cg_tol: float = 1e-4,
                    aug: bool = False):
    """Plain version of the cut of K1 (with aug, K6) at f = 128: each of
    the `spans` equal spans of a row's slots, [s L, (s + 1) L) up to the
    row's nnz, summed into its own f32 A, b and r2 (with aug the values
    ride lane 127, `augment_g`, and A' holds them), the spans added in
    span order, then the fused kernels' tail (`_solve_and_se`; with aug
    b and r2 unpacked first): `row_cut_plain` at fl = f."""
    r, p = cols.shape
    if p % spans:
        raise ValueError(f"theta_cut_plain: {spans} spans do not divide "
                         f"P = {p}")
    return row_cut_plain(table_ext, cols, vals, nnz, x0, lam,
                         table_ext.shape[1], spans, p // spans, cg_iters,
                         cg_tol, aug)


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
    device memory. a_aug (R, f, f) f32/bf16, f a multiple of 16 up to
    128, 256, or a multiple of 128 from 384 on, diag (R,) f32, x0 (R, f) f32 with lane f-1 zero. Returns
    x (R, f) f32, lane f-1 exactly 0. On a card a_aug and x0 must start
    on 16-byte boundaries (K3's body, csrc/bulk_cg.cuh)."""
    if _on_cpu(a_aug, diag, x0):
        return solve_cg_aug_plain(a_aug, diag, x0, cg_iters, cg_tol)
    return _bulk_solve("solve_cg_aug", a_aug, diag, None, x0, cg_iters,
                       cg_tol)


# ------------------------------------ K7 gather_gram_cg_wide / K8 cat --
@full_f32()
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


@full_f32()
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
                        cg_iters: int = 6, cg_tol: float = 1e-4,
                        spans: Optional[int] = None):
    """Solve one chunk of rows at a factor width 128 < F <= 256 over its
    128 + f2 live lanes only (pallas_solve.gather_gram_cg_wide):
    gather + two-block Gram + regularized CG + per-row train error.

    table_ext (n+1, 256) f32/bf16, zero-extended (a bf16 run casts the
    table before the gather); cols (R, P) int32, pad id n, pad slots at
    each row's tail; vals (R, P) f32/bf16; nnz (R,) int32; x0 (R, 256)
    f32; f2 = wide_f2(F) in {32, 64, 96, 128}. Lanes >= 128 + f2 of the
    table and of x0 are neither read nor computed. Returns x (R, 256) f32
    with lanes >= 128 + f2 exactly 0 and se (R, 1) f32. A bf16 table
    takes the two passes of the row cut on every chunk, pass 1 on the
    tensor cores; a float32 table takes them on a chunk with fewer rows
    than the card has SMs (`row_spans`) and the uncut kernel otherwise.
    `spans` forces the number of spans (1: one span a row, on a float32
    table the uncut kernel), on a card only."""
    if f2 not in (32, 64, 96, 128):
        raise ValueError(f"gather_gram_cg_wide: f2 must be 32, 64, 96 or "
                         f"128, got {f2}")
    _check_spans("gather_gram_cg_wide", spans, True)
    if _on_cpu(table_ext, cols, vals, nnz, x0):
        return gather_gram_cg_wide_plain(table_ext, cols, vals, nnz, x0,
                                         lam, f2, cg_iters, cg_tol)
    r, p = cols.shape
    _check("table_ext", table_ext, (table_ext.shape[0], 256), _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    _check("nnz", nnz, (r,), (torch.int32,))
    _check("x0", x0, (r, 256), (torch.float32,))
    if r:
        n_spans, span_len = _chunk_spans(x0.device, r, p, spans,
                                         **span_plan(table_ext))
        if n_spans > 1 or gram_body(table_ext) == "wgmma":
            return _row_cut(table_ext, cols, vals, nnz, x0, lam, 128 + f2,
                            n_spans, span_len, cg_iters, cg_tol)
    x = torch.empty((r, 256), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _launch("gather_gram_cg_wide", table_ext.data_ptr(),
                _bf16(table_ext), cols.data_ptr(), vals.data_ptr(),
                _bf16(vals), nnz.data_ptr(), x0.data_ptr(), x.data_ptr(),
                se.data_ptr(), r, p, int(f2), float(lam), int(cg_iters),
                float(cg_tol))
    return x, se


# ------------------- the row cut of the 256-lane body (K1 at 256, K7) --
SPAN_TILE = 32       # slots a tile of csrc/wide.cuh stages (kTile)
SPAN_TILE_MMA = 64   # slots a tile of the tensor-core pass 1 (mma::kSlots)
# the most tiles of a span on the tensor cores: a span's Gram is summed in
# one f32 fragment, and the error of its 16-slot steps adds up with their
# number, so longer rows take more spans (PERF.md, the span cap)
SPAN_MAX_TILES_MMA = 32
# the most scratch memory the records of one pass-1 launch take; a chunk
# whose records would take more runs as batches of rows
SPAN_SCRATCH_BYTES = 1 << 30


def span_plan(table_ext: torch.Tensor) -> Dict[str, int]:
    """`row_spans`' keywords for the pass 1 that takes this table
    (`gram_body`; a span is a whole number of its tiles): the FMA body's
    32-slot tile with the defaults, or the tensor-core pass 1's
    64-slot tile, spans of at most `SPAN_MAX_TILES_MMA` tiles and the
    constants measured for it: over the 89 chunks under 132 rows of the
    Netflix F=200 plans, on an H100 SXM at 700 W, K7 took 18.8 ms at
    target 1 and min_tiles 8 against 22.7 at the FMA body's 4 and 4
    (PERF.md, the sweep; scripts/torch_wide_span_sweep.py)."""
    return dict(_SPAN_PLANS[gram_body(table_ext)])


_SPAN_PLANS = {"wgmma": dict(tile=SPAN_TILE_MMA, min_tiles=8, target=1,
                             max_tiles=SPAN_MAX_TILES_MMA),
               "fma": dict(tile=SPAN_TILE)}


def _cut(tiles: int, want: int, tile: int) -> Tuple[int, int]:
    """(S, L) for rows of `tiles` tiles cut into at most `want` spans of
    whole tiles; the last span may be shorter."""
    if tiles <= 1 or want <= 1:
        return 1, max(tiles, 1) * tile
    per = -(-tiles // want)
    return -(-tiles // per), per * tile


def row_spans(r: int, p: int, sms: int, tile: int = SPAN_TILE,
              min_tiles: int = 4, target: int = 4,
              max_tiles: Optional[int] = None) -> Tuple[int, int]:
    """The row cut of a chunk of R rows of P slots on a card of `sms`
    SMs, from the shape alone (no read of nnz from the card): S, the
    spans a row is cut into, and L, the slots of a span, a whole number
    of `tile`-slot tiles; span s covers slots [s L, (s + 1) L), and the
    S spans cover [0, P) once. S = 1 (the uncut kernel, one block a row)
    when R >= sms; else R S is about `target` blocks an SM, with no span
    under `min_tiles` tiles unless P is (then S = 1). The plans put a
    row's live slots first, so span s of row r is live iff
    s L < min(nnz[r], P). `tile` is the pass-1 body's (`span_plan`):
    32 slots on the FMA body, 64 on the tensor cores, where no span is
    longer than `max_tiles` tiles either (so S > 1 also where R >= sms
    when P is). The defaults were measured on the FMA body: over the 67
    split X chunks under 132 rows of the Netflix F=200 plans, on an H100
    SXM at 700 W, K7 took 103.0 ms at target 4 against 112.4 at 2 and
    129.9 at 1, min_tiles 2-8 within 5% (PERF.md, the row cut's
    findings)."""
    tiles = -(-p // tile)
    want = 1 if r >= sms else -(-target * sms // max(r, 1))
    want = min(want, max(1, tiles // min_tiles))
    if max_tiles:
        want = max(want, -(-tiles // max_tiles))
    return _cut(tiles, want, tile)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device) -> int:
    """The SM count of the card `device` names (its current one if none)."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    return _sm_count(index)


def _check_spans(name: str, spans, allowed: bool) -> None:
    if spans is None:
        return
    if not allowed:
        raise ValueError(f"{name}: spans applies at f = 128 and f = 256 "
                         f"only")
    if not 1 <= int(spans) <= 65535:
        raise ValueError(f"{name}: spans must be 1 to 65535, got {spans}")


def _chunk_spans(device, r: int, p: int, spans, tile: int = SPAN_TILE,
                 **plan) -> Tuple[int, int]:
    """`row_spans` on this card in tiles of `tile` slots with the other
    keywords of `span_plan`, or the cut `spans` forces."""
    if spans is None:
        return row_spans(r, p, _sms(device), tile, **plan)
    return _cut(-(-p // tile), int(spans), tile)


def span_record_floats(fl: int) -> int:
    """Floats of one span's record in scratch (SpanRecord of
    csrc/wide.cuh): 64 entries for each of the T (T + 1) / 2 tiles of
    the upper triangle (T = fl / 8), then b (fl), then r2 (1), rounded
    up to a multiple of 64."""
    t = fl // 8
    return -(-(64 * (t * (t + 1) // 2) + fl + 1) // 64) * 64


def _triangle(fl: int, device):
    """Tile row and column of each tile of csrc/wide.cuh's `tile_of`:
    (ti, tj), ti <= tj, row-major over the upper triangle of T = fl / 8
    tiles a side."""
    t = fl // 8
    pairs = [(i, j) for i in range(t) for j in range(i, t)]
    return (torch.tensor([i for i, _ in pairs], device=device),
            torch.tensor([j for _, j in pairs], device=device))


def span_record_unpack(rec: torch.Tensor, fl: int):
    """(A, b, r2) of span records (..., span_record_floats(fl)), read
    through the tile layout of csrc/wide.cuh: entry k * 8 + l of tile i
    at [i * 64 + k * 8 + l]; A (..., fl, fl) is the upper triangle of
    tiles mirrored, b (..., fl), r2 (..., 1)."""
    t = fl // 8
    ti, tj = _triangle(fl, rec.device)
    n = ti.numel()
    lead = rec.shape[:-1]
    blocks = rec[..., :64 * n].reshape(-1, n, 8, 8)
    a = rec.new_zeros((blocks.shape[0], t, t, 8, 8))
    a[:, tj, ti] = blocks.transpose(-1, -2)
    a[:, ti, tj] = blocks      # a diagonal tile holds its full block
    a = a.permute(0, 1, 3, 2, 4).reshape(*lead, fl, fl)
    b = 64 * n
    return a, rec[..., b:b + fl], rec[..., b + fl:b + fl + 1]


@full_f32()
def span_gram_plain(table_ext, cols, vals, nnz, lo: int, hi: int, fl: int,
                    aug: bool = False):
    """Plain version of pass 1 (``wide_span_gram``) for one span: the
    dense A (R, fl, fl), b (R, fl) and r2 (R, 1) of slots
    [lo, min(hi, nnz[r], P)) of each row over table lanes < fl, in f32
    einsums. With aug (K6, fl = 256) the values ride lane fl - 1 of G
    (`augment_g`), so A is the span's A'; pass 2 reads b and r2 from it."""
    r = cols.shape[0]
    c = cols[:, lo:hi]
    live = (torch.arange(lo, lo + c.shape[1], device=cols.device)[None, :]
            < nnz.long()[:, None]).float()
    g = table_ext[:, :fl].index_select(0, c.reshape(-1).long()).reshape(
        r, c.shape[1], fl)
    if aug:
        g = augment_g(g, vals[:, lo:hi])
    g = g.float() * live[:, :, None]
    v = vals[:, lo:hi].float() * live
    a = torch.einsum("rpf,rpg->rfg", g, g)
    b = torch.einsum("rp,rpf->rf", v, g)
    return a, b, (v * v).sum(-1, keepdim=True)


def span_solve_plain(parts, nnz, x0, lam: float, cg_iters: int = 6,
                     cg_tol: float = 1e-4, aug: bool = False):
    """Plain version of pass 2 (``wide_span_solve``): the (A, b, r2) of
    `parts` summed in span order, then the tail of the fused kernels
    (`_solve_and_se`) on the fl live lanes. With aug the summed A is A'
    and b and r2 come from it (`unpack_aug`), as K6 takes them. x0
    (R, 256); returns x (R, 256) with lanes >= fl exactly 0, and se
    (R, 1)."""
    a, b, r2 = parts[0]
    for pa, pb, pr in parts[1:]:
        a, b, r2 = a + pa, b + pb, r2 + pr
    if aug:
        a, b, r2 = unpack_aug(a)
    fl = a.shape[-1]
    x, se = _solve_and_se(a, b, r2, nnz, x0[:, :fl], lam, cg_iters, cg_tol)
    return torch.nn.functional.pad(x, (0, x0.shape[1] - fl)), se


def row_cut_plain(table_ext, cols, vals, nnz, x0, lam: float, fl: int,
                  spans: int, span_len: int, cg_iters: int = 6,
                  cg_tol: float = 1e-4, aug: bool = False):
    """The CPU reference of the row cut: `span_gram_plain` over spans
    0 .. spans - 1 of `span_len` slots, then `span_solve_plain` (with aug
    both in K6's layout, fl = 256)."""
    parts = [span_gram_plain(table_ext, cols, vals, nnz, s * span_len,
                             (s + 1) * span_len, fl, aug)
             for s in range(spans)]
    return span_solve_plain(parts, nnz, x0, lam, cg_iters, cg_tol, aug)


def _span_live(nnz, p: int, spans: int, span_len: int) -> torch.Tensor:
    """(R, spans) bool: span s of row r holds slots, s L < min(nnz, P)."""
    starts = torch.arange(spans, device=nnz.device) * span_len
    return starts[None, :] < nnz.long().clamp(max=p)[:, None]


def span_grams(table_ext, cols, vals, nnz, fl: int, spans: int,
               span_len: int, aug: bool = False) -> torch.Tensor:
    """Pass 1 of the row cut: the records (R, spans,
    span_record_floats(fl)) of the Gram of every span, span s of a row
    over slots [s L, min((s + 1) L, nnz, P)), L = `span_len` (a multiple
    of the tile of `span_plan(table_ext)`). table_ext (n+1, 256) f32/bf16, cols,
    vals (R, P), nnz (R,) int32, all on the card; fl in (160, 192, 224,
    256), the live lanes. A bf16 table runs on the tensor cores
    (``wide_span_gram_mma``: the bf16 products are exact, the f32 sums
    taken in the hardware's order), a float32 table on the FMA body
    (``wide_span_gram``). A span with no slots is left as `torch.empty`
    made it (pass 2 reads only live spans). With aug (K6, fl = 256) the
    values ride lane 255 of G, rounded to the table's dtype, so each
    record's tiles hold the span's A' (its b and r2 are not pass 2's)."""
    if fl not in (160, 192, 224, 256) or (aug and fl != 256):
        raise ValueError(f"wide_span_gram: fl must be 160, 192, 224 or 256 "
                         f"(256 with aug), got {fl}")
    tile = span_plan(table_ext)["tile"]
    if span_len <= 0 or span_len % tile:
        raise ValueError(f"wide_span_gram: span_len must be a positive "
                         f"multiple of {tile}, got {span_len}")
    _on_card("wide_span_gram", table_ext, cols, vals, nnz)
    r, p = cols.shape
    _check("table_ext", table_ext, (table_ext.shape[0], 256), _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    _check("nnz", nnz, (r,), (torch.int32,))
    part = torch.empty((r, spans, span_record_floats(fl)),
                       dtype=torch.float32, device=cols.device)
    if not r:
        return part
    if gram_body(table_ext) == "wgmma":
        _check_gram_table(table_ext, cols)
        _launch("wide_span_gram_mma", table_ext.data_ptr(), None,
                cols.data_ptr(), vals.data_ptr(), _bf16(vals),
                nnz.data_ptr(), part.data_ptr(), r, p, fl, 0, spans,
                span_len, int(aug))
    else:
        _launch("wide_span_gram", table_ext.data_ptr(), _bf16(table_ext),
                cols.data_ptr(), vals.data_ptr(), _bf16(vals),
                nnz.data_ptr(), part.data_ptr(), r, p, fl, spans, span_len,
                int(aug))
    return part


def span_solve(part, nnz, x0, lam: float, p: int, span_len: int,
               cg_iters: int = 6, cg_tol: float = 1e-4,
               all_slots: bool = False, aug: bool = False):
    """Pass 2 of the row cut: each row's live records of `part` (from
    `span_grams` over P = `p` slots) summed in span order, the
    regularized CG from x0 (R, 256) f32 and the train error, as
    `gather_gram_cg_wide` and `gather_gram_cg` at f = 256 return them:
    x (R, 256) with lanes >= fl exactly 0, and se (R, 1). A span is live
    below min(nnz, P), or with `all_slots` (K8's records from
    `cat_span_grams`, over every slot) below P; nnz sets the regularizer
    either way. With aug (K6's records from `span_grams(aug=True)`, 256
    lanes) b and r2 come from the summed A': its last column and corner,
    then its last row and column are zeroed; lane 255 of x comes back
    exactly 0. Card tensors only."""
    r, spans, size = part.shape
    sizes = {span_record_floats(fl): fl for fl in (160, 192, 224, 256)}
    if size not in sizes:
        raise ValueError(f"wide_span_solve: records of {size} floats")
    fl = sizes[size]
    if aug and (fl != 256 or all_slots):
        raise ValueError("wide_span_solve: aug takes 256-lane records of "
                         "a gather (not all_slots)")
    _on_card("wide_span_solve", part, nnz, x0)
    _check("part", part, part.shape, (torch.float32,))
    _check("nnz", nnz, (r,), (torch.int32,))
    _check("x0", x0, (r, 256), (torch.float32,))
    x = torch.empty((r, 256), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _launch("wide_span_solve", part.data_ptr(), nnz.data_ptr(),
                x0.data_ptr(), x.data_ptr(), se.data_ptr(), r, int(p), fl,
                spans, int(span_len), int(all_slots), int(aug), float(lam),
                int(cg_iters), float(cg_tol))
    return x, se


def row_batches(spans: int, fl: int,
                budget: int = SPAN_SCRATCH_BYTES) -> int:
    """Rows of one batch of the row cut: as many as keep the records of
    a pass-1 launch (spans records of span_record_floats(fl) floats a
    row) within `budget` bytes, at least one."""
    return max(1, budget // (spans * span_record_floats(fl) * 4))


def _two_passes(grams, nnz, x0, lam, fl, p, spans, span_len, cg_iters,
                cg_tol, all_slots=False, aug=False):
    """The two passes over a chunk of P = `p` slots a row, in batches of
    `row_batches` rows: grams(lo, hi) is pass 1 over rows [lo, hi)."""
    r = x0.shape[0]
    step = row_batches(spans, fl)
    xs, ses = [], []
    for lo in range(0, r, step):
        hi = min(lo + step, r)
        part = grams(lo, hi)
        x, se = span_solve(part, nnz[lo:hi], x0[lo:hi], lam, p, span_len,
                           cg_iters, cg_tol, all_slots, aug)
        del part
        xs.append(x)
        ses.append(se)
    if len(xs) == 1:
        return xs[0], ses[0]
    return torch.cat(xs), torch.cat(ses)


def _row_cut(table_ext, cols, vals, nnz, x0, lam, fl, spans, span_len,
             cg_iters, cg_tol, aug=False):
    """The two passes over a chunk gathered from a table (K1, K7; K6
    with aug)."""
    def grams(lo, hi):
        return span_grams(table_ext, cols[lo:hi], vals[lo:hi], nnz[lo:hi],
                          fl, spans, span_len, aug)
    return _two_passes(grams, nnz, x0, lam, fl, cols.shape[1], spans,
                       span_len, cg_iters, cg_tol, aug=aug)


@full_f32()
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


def cat_body(dtype: torch.dtype, f2: int) -> str:
    """Which body K8 runs on a card, by G's dtype and f2 alone: "wgmma"
    (the two passes of the row cut, pass 1 on the tensor cores reading
    the two slabs, `cat_span_grams`, then `span_solve` over all 256
    lanes) for a bf16 G whose f2 is a multiple of 32, as `wide_f2` gives
    it; "fma" (the uncut kernel of csrc/fused_gram_cg_cat.cu) for a
    float32 G, which bf16 tensor cores would round, and for any other
    f2. A caller cannot choose, and neither gives way to the other."""
    if dtype == torch.bfloat16 and f2 % 32 == 0:
        return "wgmma"
    return "fma"


@full_f32()
def cat_span_gram_plain(g1, g2, vals, lo: int, hi: int):
    """Plain version of pass 1 on a packed G (``cat_span_grams``) for
    one span: the dense A (R, 256, 256), b (R, 256) and r2 (R, 1) of
    slots [lo, min(hi, P)) of each row, every slot whatever nnz, lanes
    >= 128 + f2 zero."""
    r = g1.shape[0]
    g1, g2 = g1[:, lo:hi], g2[:, lo:hi]
    g = torch.cat([g1, g2, g1.new_zeros((r, g1.shape[1],
                                         128 - g2.shape[2]))], dim=2).float()
    v = vals[:, lo:hi].float()
    a = torch.einsum("rpf,rpg->rfg", g, g)
    b = torch.einsum("rp,rpf->rf", v, g)
    return a, b, (v * v).sum(-1, keepdim=True)


def cat_row_cut_plain(g1, g2, vals, nnz, x0, lam: float, spans: int,
                      span_len: int, cg_iters: int = 6,
                      cg_tol: float = 1e-4):
    """The CPU reference of K8's route on the card: `cat_span_gram_plain`
    over spans 0 .. spans - 1 of `span_len` slots, then
    `span_solve_plain` on the 256 lanes."""
    parts = [cat_span_gram_plain(g1, g2, vals, s * span_len,
                                 (s + 1) * span_len) for s in range(spans)]
    return span_solve_plain(parts, nnz, x0, lam, cg_iters, cg_tol)


def cat_span_grams(g1, g2, vals, spans: int, span_len: int) -> torch.Tensor:
    """Pass 1 of K8's route: the records (R, spans,
    span_record_floats(256)) of the Gram of every span of a packed bf16
    G, span s of a row over slots [s L, min((s + 1) L, P)), every slot
    whatever nnz (``wide_span_gram_mma`` reading g1 and g2 where the
    gather reads the table). g1 (R, P, 128) and g2 (R, P, f2) bf16 on
    16-byte boundaries, f2 a multiple of 32; vals (R, P); L a multiple of
    `SPAN_TILE_MMA`. Card tensors only."""
    if span_len <= 0 or span_len % SPAN_TILE_MMA:
        raise ValueError(f"wide_span_gram: span_len must be a positive "
                         f"multiple of {SPAN_TILE_MMA}, got {span_len}")
    _on_card("wide_span_gram", g1, g2, vals)
    r, p, _ = g1.shape
    f2 = g2.shape[2]
    if cat_body(g1.dtype, f2) != "wgmma":
        raise ValueError(f"wide_span_gram: a packed G must be bf16 with f2 "
                         f"a multiple of 32, got {g1.dtype}, f2 = {f2}")
    _check("g1", g1, (r, p, 128), (torch.bfloat16,))
    _check("g2", g2, (r, p, f2), (torch.bfloat16,))
    _check("vals", vals, (r, p), _FLOATS)
    for name, t in (("g1", g1), ("g2", g2)):
        if t.data_ptr() % 16:
            raise ValueError(f"wide_span_gram: the storage of {name} must "
                             f"start on a 16-byte boundary")
    part = torch.empty((r, spans, span_record_floats(256)),
                       dtype=torch.float32, device=g1.device)
    if r:
        _launch("wide_span_gram_mma", g1.data_ptr(), g2.data_ptr(), None,
                vals.data_ptr(), _bf16(vals), None, part.data_ptr(), r, p,
                256, f2, spans, span_len, 0)
    return part


def fused_gram_cg_cat(g1, g2, vals, nnz, x0, lam: float, cg_iters: int = 6,
                      cg_tol: float = 1e-4, spans: Optional[int] = None):
    """Fused Gram + CG over a lane-packed, already gathered G
    (pallas_solve.fused_gram_cg_cat): g1 (R, P, 128) and g2 (R, P, f2),
    f2 <= 128, both f32 or both bf16, joined to 256 lanes with zeros
    above 128 + f2; vals (R, P) f32/bf16; nnz (R,) int32; x0 (R, 256)
    f32. The Gram sums every one of the P slots (nnz sets only the
    regularizer and the [nnz > 0] mask). Solves the full 256-lane system
    (the dead lanes carry the diagonal only). Returns x (R, 256) f32 and
    se (R, 1) f32.

    On a card the body is `cat_body`'s: a bf16 G with f2 a multiple of
    32 takes the two passes of the row cut in the spans of K1 at 256
    lanes on a bf16 table (`row_spans` with the tensor-core plan), pass 1
    on the tensor cores (the bf16 products exact, the f32 sums in the
    hardware's order); its launches count under the passes' own
    counters (``wide_span_gram_mma``, ``wide_span_solve``), and
    ``fused_gram_cg_cat`` counts the FMA kernel's alone. `spans` forces
    the number of spans there (1: one span a row). Any other G takes the
    uncut FMA kernel, which `spans` cannot cut. Tensors on the CPU take
    the plain version whatever `spans` says."""
    _check_spans("fused_gram_cg_cat", spans, True)
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
    passes = cat_body(g1.dtype, f2) == "wgmma"
    if not passes and spans not in (None, 1):
        raise ValueError("fused_gram_cg_cat: spans cuts the bf16 route "
                         "only (f2 a multiple of 32); the FMA kernel takes "
                         "one block a row")
    if r and passes:
        n_spans, span_len = _chunk_spans(x0.device, r, p, spans,
                                         **_SPAN_PLANS["wgmma"])

        def grams(lo, hi):
            return cat_span_grams(g1[lo:hi], g2[lo:hi], vals[lo:hi],
                                  n_spans, span_len)
        return _two_passes(grams, nnz, x0, lam, 256, p, n_spans, span_len,
                           cg_iters, cg_tol, all_slots=True)
    x = torch.empty((r, 256), dtype=torch.float32, device=x0.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=x0.device)
    if r:
        _launch("fused_gram_cg_cat", g1.data_ptr(), g2.data_ptr(),
                _bf16(g1), vals.data_ptr(), _bf16(vals), nnz.data_ptr(),
                x0.data_ptr(), x.data_ptr(), se.data_ptr(), r, p, f2,
                float(lam), int(cg_iters), float(cg_tol))
    return x, se


# ------------------ factor widths F > 256: f = 128 T, T >= 3 ----------
# the most scratch memory (A, b and r2 in f32) one row batch of K1's or
# K6's two passes takes at f >= 384: 3,631 rows at f = 384
TILED_SCRATCH_BYTES = 2 << 30


def tiled_batch_rows(f: int) -> int:
    """Rows of one batch of K1's and K6's two passes at f >= 384: as many
    as keep their f32 scratch (A, b, r2: f^2 + f + 1 floats a row)
    within `TILED_SCRATCH_BYTES`, at least one."""
    return max(1, TILED_SCRATCH_BYTES // ((f * f + f + 1) * 4))


@full_f32()
def tile_gram_plain(table_ext, cols, vals, nnz=None,
                    out_dtype: torch.dtype = torch.float32,
                    aug: bool = False):
    """Plain version of ``tile_gram``: each row's first min(nnz, P)
    slots (all P without nnz) gathered, A = G^T G summed in f32 and cast
    to out_dtype, b = sum v g and r2 = sum v^2 (R,) in f32. With aug the
    values ride lane f - 1 (`augment_g`), A is A' and b and r2 are None
    (A' holds them)."""
    r, p = cols.shape
    g = _gather(table_ext, cols)
    if aug:
        g = augment_g(g, vals)
    g, v = g.float(), vals.float()
    if nnz is not None:
        live = (torch.arange(p, device=cols.device)[None, :]
                < nnz.long()[:, None]).float()
        g, v = g * live[:, :, None], v * live
    a = torch.einsum("rpf,rpg->rfg", g, g).to(out_dtype)
    if aug:
        return a, None, None
    return a, torch.einsum("rp,rpf->rf", v, g), (v * v).sum(-1)


def cluster_plan(t: int):
    """The blocks of ``tile_gram``'s cluster body at f = 128 t lanes
    (t >= 3 slabs of 128 lanes), by rank: (a, b, diag) for a block that
    owns the tile (a, b) of A, a != b, and where diag also the diagonal
    tile (a, a) and the gather of slab a, which it hands to every other
    block that reads it (a or b of that block). Block c < t takes (c, c)
    and (c, c + 1 mod t); each tile (c, c + k mod t), 2 <= k <= t // 2
    (for k = t / 2 only c < t / 2), is a block of its own. So every tile
    of the upper triangle is owned once, each block reads two slabs and
    owns one or two tiles (two tiles of f32 sums are 128 registers a
    thread), and each slab is gathered by one block and read by the same
    number of others: t (t - 1) / 2 blocks in all, 3 at t = 3 and 6 at
    t = 4."""
    if t < 3:
        raise ValueError(f"cluster_plan: takes t >= 3 slabs, got {t}")
    blocks = [(c, (c + 1) % t, True) for c in range(t)]
    for k in range(2, t // 2 + 1):
        blocks += [(c, (c + k) % t, False)
                   for c in range(t if 2 * k < t else t // 2)]
    return blocks


# the blocks a cluster of the cluster body may hold (the portable most)
CLUSTER_MAX_BLOCKS = 8
# slots a row of the tensor-core bodies of ``tile_gram`` sums in its
# fragment before it adds them to the row's sums (kSpanTiles tiles); the
# cluster body keeps those sums in a scratch the wrapper passes when P
# is longer
TILE_GRAM_SPAN_SLOTS = 32 * GRAM_TILE


def tile_gram_body(table_ext: torch.Tensor) -> str:
    """Which body of ``tile_gram`` runs for this table, by its dtype and
    width alone: "cluster" (a bf16 table whose `cluster_plan` fits one
    cluster, f = 384 and 512: a cluster a row of A, each slab gathered
    once), "tile" (a bf16 table at f >= 640: one block a row and a tile,
    each block gathering both of its slabs), "fma" (a float32 table)."""
    if table_ext.dtype != torch.bfloat16:
        return "fma"
    t = table_ext.shape[1] // TILE_LANES
    return "cluster" if len(cluster_plan(t)) <= CLUSTER_MAX_BLOCKS \
        else "tile"


def tile_gram_clusters(f: int, sms: int) -> int:
    """Clusters of the cluster body at width f that a card of `sms` SMs
    holds at once at most (one block an SM; the GPCs may fit fewer: 39
    of 3 blocks on a 132-SM H100, PERF.md)."""
    return sms // len(cluster_plan(f // TILE_LANES))


def tile_gram(table_ext, cols, vals, nnz=None,
              out_dtype: torch.dtype = torch.float32, aug: bool = False,
              with_b: bool = True, with_r2: bool = False):
    """The Gram of one chunk at f = 128 T lanes, T >= 3
    (csrc/tile_gram.cu), the whole symmetric A written, in the body
    `tile_gram_body` names: on a bf16 table at T = 3 or 4 a thread-block
    cluster a row of A (`cluster_plan`: each slab of the gathered rows
    gathered by one block and handed to the others over distributed
    shared memory), at T >= 5 one block a row and a 128 x 128 tile
    (ti <= tj) of its A; on a float32 table an FMA tile a block. K2
    (with b), K5a (aug) and pass 1 of K1 (nnz, b and r2 into f32
    scratch) and K6 (nnz, aug) at f >= 384 run it. table_ext (n+1, f)
    bf16 (the tensor cores, on a 16-byte boundary) or f32; cols and vals
    (R, P); nnz (R,) int32 or None (every slot). Returns A (R, f, f) in
    out_dtype (summed in f32), b (R, f) f32 or None, r2 (R,) f32 or None;
    with aug the values ride lane f - 1, rounded to the table's dtype,
    and b and r2 are None. Card tensors only; its plain version is
    `tile_gram_plain`."""
    live = [t for t in (table_ext, cols, vals, nnz) if t is not None]
    _on_card("tile_gram", *live, plain="tile_gram_plain")
    r, p = cols.shape
    f = table_ext.shape[1]
    if not tiled(f):
        raise ValueError(f"tile_gram: takes f a multiple of 128 from 384 "
                         f"on, got {f}")
    if aug and (with_b or with_r2):
        raise ValueError("tile_gram: with aug, A' holds b and r2")
    if out_dtype not in _FLOATS:
        raise ValueError(f"out_dtype {out_dtype} not in {_FLOATS}")
    _check("table_ext", table_ext, table_ext.shape, _FLOATS)
    _check("cols", cols, (r, p), (torch.int32,))
    _check("vals", vals, (r, p), _FLOATS)
    if nnz is not None:
        _check("nnz", nnz, (r,), (torch.int32,))
    if table_ext.data_ptr() % 16:
        raise ValueError("tile_gram: the storage of table_ext must start "
                         "on a 16-byte boundary")
    _check_gram_table(table_ext, cols)
    dev = cols.device
    a = torch.empty((r, f, f), dtype=out_dtype, device=dev)
    b = torch.empty((r, f), dtype=torch.float32, device=dev) if with_b \
        else None
    r2 = torch.empty((r,), dtype=torch.float32, device=dev) if with_r2 \
        else None
    if r:
        plan, scratch, sms = None, None, _sms(dev)
        if tile_gram_body(table_ext) == "cluster":
            flat = [v for blk in cluster_plan(f // TILE_LANES) for v in blk]
            plan = (ctypes.c_int * len(flat))(*map(int, flat))
            # the cluster body copies f32 values (bf16 widen exactly)
            vals = vals.float()
            if p > TILE_GRAM_SPAN_SLOTS:
                # the earlier spans' sums of two tiles a block, one block
                # an SM
                scratch = torch.empty((sms, 2, TILE_LANES * TILE_LANES),
                                      dtype=torch.float32, device=dev)
        _launch("tile_gram", table_ext.data_ptr(), _bf16(table_ext),
                cols.data_ptr(), vals.data_ptr(), _bf16(vals),
                None if nnz is None else nnz.data_ptr(), a.data_ptr(),
                _bf16(a), None if b is None else b.data_ptr(),
                None if r2 is None else r2.data_ptr(), r, p, f, int(aug),
                None if plan is None else ctypes.addressof(plan),
                0 if plan is None else len(plan) // 3,
                None if scratch is None else scratch.data_ptr(), sms)
    return a, b, r2


def global_cg_plain(a, x0, cg_iters: int = 6, cg_tol: float = 1e-4,
                    diag=None, b=None, aug: bool = False):
    """Plain version of ``global_cg`` in the modes of K3–K5b: K5b's unpack
    with aug (`solve_cg_aug_plain`), K3's diagonal (`solve_cg_reg_plain`),
    K4's A as given (`solve_cg_plain`). With nnz (pass 2 of K1 and K6)
    the plain version is the tail of `gather_gram_cg_plain` and
    `gather_gram_cg_aug_plain`."""
    if aug:
        return solve_cg_aug_plain(a, diag, x0, cg_iters, cg_tol)
    if diag is not None:
        return solve_cg_reg_plain(a, diag, b, x0, cg_iters, cg_tol)
    return solve_cg_plain(a, b, x0, cg_iters, cg_tol)


def global_cg(a, x0, cg_iters: int = 6, cg_tol: float = 1e-4, diag=None,
              b=None, r2=None, nnz=None, lam: float = 0.0, aug: bool = False):
    """The batched CG at f = 128 T lanes, T >= 3, with each system's A
    read from device memory at every matvec (csrc/global_cg.cu): K3 (diag
    and b), K4 (b), K5b (aug and diag: b from row f - 1 of A', row and
    column f - 1 read as 0) and pass 2 of K1 (nnz, lam, b, r2) and K6
    (nnz, lam, aug) at f >= 384. a (R, f, f) f32/bf16 on a 16-byte
    boundary, summed in f32; diag (R,) f32; b (R, f) f32; r2 (R,) f32;
    nnz (R,) int32; x0 (R, f) f32. Returns x (R, f) f32, and with nnz
    (x [nnz > 0], se (R, 1)) as K1 returns them. Card tensors only; its
    plain version is `global_cg_plain`, with nnz the tail of
    `gather_gram_cg_plain` (`gather_gram_cg_aug_plain` with aug)."""
    live = [t for t in (a, x0, diag, b, r2, nnz) if t is not None]
    _on_card("global_cg", *live, plain="global_cg_plain")
    r, f, _ = a.shape
    if not tiled(f):
        raise ValueError(f"global_cg: takes f a multiple of 128 from 384 "
                         f"on, got {f}")
    fused = nnz is not None
    mode = 3 if fused else 2 if aug else 0 if diag is not None else 1
    need = {0: ("diag", "b"), 1: ("b",), 2: ("diag",),
            3: ("nnz",) if aug else ("nnz", "b", "r2")}[mode]
    given = dict(diag=diag, b=b, r2=r2, nnz=nnz)
    for what in need:
        if given[what] is None:
            raise ValueError(f"global_cg: this mode needs {what}")
    _check("a", a, (r, f, f), _FLOATS)
    _check("x0", x0, (r, f), (torch.float32,))
    for what, shape, dtype in (("diag", (r,), torch.float32),
                               ("b", (r, f), torch.float32),
                               ("r2", (r,), torch.float32),
                               ("nnz", (r,), torch.int32)):
        if what in need:
            _check(what, given[what], shape, (dtype,))
    for what, t in (("a", a), ("b", b), ("x0", x0)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"global_cg: the storage of {what} must start "
                             f"on a 16-byte boundary")
    x = torch.empty((r, f), dtype=torch.float32, device=a.device)
    se = torch.empty((r, 1), dtype=torch.float32, device=a.device) \
        if fused else None
    if r:
        def ptr(what):
            return given[what].data_ptr() if what in need else None
        _launch("global_cg", a.data_ptr(), _bf16(a), ptr("diag"), ptr("b"),
                ptr("r2"), ptr("nnz"), x0.data_ptr(), x.data_ptr(),
                None if se is None else se.data_ptr(), r, f, mode, int(aug),
                float(lam), int(cg_iters), float(cg_tol))
    return (x, se) if fused else x


def _tiled_gram_cg(table_ext, cols, vals, nnz, x0, lam, cg_iters, cg_tol,
                   aug):
    """K1 (K6 with aug) at f >= 384 on card tensors: in batches of
    `tiled_batch_rows` rows, pass 1 ``tile_gram`` (A, and without aug b
    and r2, of each row's live slots, into f32 scratch), then pass 2
    ``global_cg`` with nnz."""
    r = cols.shape[0]
    step = tiled_batch_rows(table_ext.shape[1])
    xs, ses = [], []
    for lo in range(0, r, step):
        hi = min(lo + step, r)
        a, b, r2 = tile_gram(table_ext, cols[lo:hi], vals[lo:hi],
                             nnz[lo:hi], aug=aug, with_b=not aug,
                             with_r2=not aug)
        x, se = global_cg(a, x0[lo:hi], cg_iters, cg_tol, b=b, r2=r2,
                          nnz=nnz[lo:hi], lam=lam, aug=aug)
        del a, b, r2
        xs.append(x)
        ses.append(se)
    if len(xs) == 1:
        return xs[0], ses[0]
    if not xs:
        return (torch.empty((0, x0.shape[1]), device=x0.device),
                torch.empty((0, 1), device=x0.device))
    return torch.cat(xs), torch.cat(ses)
