"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. card and build: the card's name and power limit, the torch/CUDA
   versions, and the build of every CUDA kernel from csrc/ (nine);
2. each kernel against its plain PyTorch version on the card, on real
   chunks of the Netflix-shaped plans, with kernel, plain, yardstick and
   bound times: the widest and the most populous theta-phase chunk for
   K1 and K6, the most populous X-phase panel chunk for K2 and K5a, one
   full solve slice of the X-phase accumulators for K3 (split, bf16),
   K5b (augmented, f32) and K4 (the same slice unpacked and regularized
   beforehand, through `ops.solve.solve` without a diagonal);
3. small Netflix-shaped runs (scale 0.01, lowered panel_size so both
   routes engage) on the card against the same runs on the CPU: bf16
   accumulators, f32 with aug_gram="auto", f32 with aug_gram="force";
4. two paths at full width, `ALS.run` for 3 iterations each on the
   Netflix workload at scale 1.0 (~99M ratings, F=100, bf16 factors,
   backend "pallas", CG), X phase on the panel route and theta on the
   direct route, every kernel's launch count read around each run alone:
   a. bf16 Gram accumulators: split buffers, kernels K1, K2, K3;
   b. f32 accumulators with aug_gram="force": the augmented-lane forms,
      kernels K5a, K5b, K6;
   and K4's path, the public dispatcher `ops.solve.solve` without a
   diagonal, over every solve slice of the X-phase accumulators, held
   against the augmented solve of the same systems;
5. the factor widths above 128, on the same data at F=200 (f_pad 256,
   f2 = 96), X phase on the split route (4 table parts of 131,072 rows)
   and theta on the direct route:
   a. K7, K1 at f=256 and K8 against their plain versions on the most
      populous and the widest theta chunk and (K7) the most populous
      split X chunk, K8 also against K1 at f=256 on the same G;
   b. small runs (scale 0.01, F=130, forced split X route with 3 parts)
      on the card against the CPU, wide_kernel on and off;
   c. `ALS.run` for 3 iterations with wide_kernel="on" (K7 alone), then
      2 iterations with wide_kernel="off" (K1 alone);
   d. K8's path: `fused_gram_cg_cat` over every theta chunk on a G
      gathered with torch, each held against K1 at f=256.

It prints a `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ITERS = 3
REPLACES = {
    "gather_gram_cg": "cumf_als_tpu/ops/pallas_solve.py:299",
    "gather_gram_out": "cumf_als_tpu/ops/pallas_solve.py:534",
    "solve_cg_reg": "cumf_als_tpu/ops/pallas_solve.py:1105",
    "solve_cg": "cumf_als_tpu/ops/pallas_solve.py:1097",
    "gather_gram_aug_out": "cumf_als_tpu/ops/pallas_solve.py:610",
    "solve_cg_aug": "cumf_als_tpu/ops/pallas_solve.py:1122",
    "gather_gram_cg_aug": "cumf_als_tpu/ops/pallas_solve.py:345",
    "gather_gram_cg_wide": "cumf_als_tpu/ops/pallas_solve.py:804",
    "fused_gram_cg_cat": "cumf_als_tpu/ops/pallas_solve.py:956",
}
SPLIT_KERNELS = ("gather_gram_cg", "gather_gram_out", "solve_cg_reg")
AUG_KERNELS = ("gather_gram_cg_aug", "gather_gram_aug_out", "solve_cg_aug")
WIDE_KERNELS = ("gather_gram_cg_wide", "fused_gram_cg_cat")
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2 --
def check_k1(cs, table_ext, ch, theta, cfg, label, aug=False):
    """K1 (or, with aug, K6) on one theta-phase chunk: kernel vs plain."""
    k = ch.n_real
    x0 = torch.nn.functional.pad(theta.index_select(0, ch.rows_real),
                                 (0, 0, 0, ch.rows.shape[0] - k))
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    plain_fn = cs.gather_gram_cg_aug_plain if aug else \
        cs.gather_gram_cg_plain
    x, se = cs.gather_gram_cg(*args, aug=aug, **kw)
    px, pse = plain_fn(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    lane_ok = not aug or bool((x[:, -1] == 0).all())
    ms = time_ms(lambda: cs.gather_gram_cg(*args, aug=aug, **kw))
    plain = time_ms(lambda: plain_fn(*args, **kw), reps=3)
    r, p = ch.cols.shape
    f = table_ext.shape[1]
    flops = 2.0 * float(ch.nnz.sum().item()) * f * f
    bms, by = bound_ms(nbytes(table_ext, ch.cols, ch.vals, ch.nnz, x0, x,
                              se), flops, table_ext.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3 and lane_ok
    name = "K6 gather_gram_cg_aug" if aug else "K1 gather_gram_cg"
    log(f"[{name}] {label} chunk R={r} P={p}: max|dx|={err:.3e} "
        f"(limit 2e-3), max rel dse={se_rel:.3e} (limit 1e-3); kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def check_k2(cs, tp, ch, a_dtype):
    """K2 on one X-phase panel chunk: kernel vs plain, and torch.bmm on a
    pre-gathered G as the yardstick (it leaves out the gather and b)."""
    args = (tp, ch.cols, ch.vals)
    a, b = cs.gather_gram_out(*args, out_dtype=a_dtype)
    pa, pb = cs.gather_gram_out_plain(*args, out_dtype=a_dtype)
    af, paf = a.float(), pa.float()
    err = (af - paf).abs().max().item()
    big = torch.maximum(af.abs(), paf.abs())
    # one bf16 ulp of the larger value (both round one f32 sum)
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7)
    a_ok = bool(((af - paf).abs() <= (ulp if a_dtype == torch.bfloat16
                                      else 1e-5 * big + 1e-5)).all())
    b_rel = ((b - pb).abs() / pb.abs().clamp_min(1.0)).max().item()
    del af, paf, big, ulp, a, pa
    ms = time_ms(lambda: cs.gather_gram_out(*args, out_dtype=a_dtype))
    plain = time_ms(lambda: cs.gather_gram_out_plain(
        *args, out_dtype=a_dtype), reps=3)
    r, p = ch.cols.shape
    f = tp.shape[1]
    g = tp.index_select(0, ch.cols.reshape(-1).long()).reshape(r, p, f)
    gt = g.transpose(1, 2)
    lib = time_ms(lambda: torch.bmm(gt, g))
    del g, gt
    flops = 2.0 * float(ch.nnz.sum().item()) * f * f
    out_bytes = r * f * f * torch.tensor([], dtype=a_dtype).element_size()
    bms, by = bound_ms(nbytes(tp, ch.cols, ch.vals) + out_bytes + r * f * 4,
                       flops, tp.dtype)
    ok = a_ok and b_rel <= 1e-5
    log(f"[K2 gather_gram_out] panel {ch.panel} chunk R={r} P={p}: "
        f"max|dA|={err:.3e} (limit one bf16 ulp: {a_ok}), max rel db="
        f"{b_rel:.3e} (limit 1e-5); kernel {ms:.3f} ms, plain {plain:.3f} "
        f"ms, torch.bmm on pre-gathered G (no gather, no b) {lib:.3f} ms, "
        f"bound {bms:.4f} ms ({by}); {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)


def check_k3(cs, a_buf, b_buf, x0_full, row_nnz, lo, batch, cfg):
    """K3 on one solve slice of the X-phase accumulators."""
    a = a_buf[lo:lo + batch]
    b = b_buf[lo:lo + batch]
    x0 = x0_full[lo:lo + batch]
    nnzf = row_nnz[lo:lo + batch].float()
    diag = nnzf * cfg.lam + (nnzf == 0).float()
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    x = cs.solve_cg_reg(a, diag, b, x0, **kw)
    px = cs.solve_cg_reg_plain(a, diag, b, x0, **kw)
    err = (x - px).abs().max().item()
    ms = time_ms(lambda: cs.solve_cg_reg(a, diag, b, x0, **kw))
    plain = time_ms(lambda: cs.solve_cg_reg_plain(a, diag, b, x0, **kw),
                    reps=3)
    f = a.shape[-1]
    # the least CG work: one matvec per system
    bms, by = bound_ms(nbytes(a, diag, b, x0, x), 2.0 * batch * f * f,
                       a.dtype)
    ok = err <= 2e-3
    log(f"[K3 solve_cg_reg] slice of {batch} systems, A {a.dtype}: "
        f"max|dx|={err:.3e} (limit 2e-3); kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def check_k5a(cs, tp, ch):
    """K5a on one X-phase panel chunk, f32 A': kernel vs plain, and
    torch.bmm on a pre-gathered, pre-augmented G as the yardstick (it
    leaves out the gather and the value splice, and writes a bf16 A')."""
    args = (tp, ch.cols, ch.vals)
    a = cs.gather_gram_aug_out(*args)
    pa = cs.gather_gram_aug_out_plain(*args)
    err = (a - pa).abs().max().item()
    ok = bool(((a - pa).abs() <= 1e-5 * torch.maximum(a.abs(), pa.abs())
               + 1e-5).all())
    del a, pa
    ms = time_ms(lambda: cs.gather_gram_aug_out(*args))
    plain = time_ms(lambda: cs.gather_gram_aug_out_plain(*args), reps=3)
    r, p = ch.cols.shape
    f = tp.shape[1]
    g = cs.augment_g(tp.index_select(0, ch.cols.reshape(-1).long())
                     .reshape(r, p, f), ch.vals)
    gt = g.transpose(1, 2)
    lib = time_ms(lambda: torch.bmm(gt, g))
    del g, gt
    flops = 2.0 * float(ch.nnz.sum().item()) * f * f
    bms, by = bound_ms(nbytes(tp, ch.cols, ch.vals) + r * f * f * 4, flops,
                       tp.dtype)
    log(f"[K5a gather_gram_aug_out] panel {ch.panel} chunk R={r} P={p}, "
        f"f32 A': max|dA'|={err:.3e} (limit rtol 1e-5 + 1e-5: {ok}); "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, torch.bmm on "
        f"pre-gathered, pre-augmented G (no gather, no splice, bf16 out) "
        f"{lib:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib)


def check_k5b(cs, a, diag, x0, cfg):
    """K5b on one solve slice of the augmented X-phase accumulator."""
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    x = cs.solve_cg_aug(a, diag, x0, **kw)
    px = cs.solve_cg_aug_plain(a, diag, x0, **kw)
    err = (x - px).abs().max().item()
    lane_ok = bool((x[:, -1] == 0).all())
    ms = time_ms(lambda: cs.solve_cg_aug(a, diag, x0, **kw))
    plain = time_ms(lambda: cs.solve_cg_aug_plain(a, diag, x0, **kw),
                    reps=3)
    batch, f, _ = a.shape
    # the least CG work: one matvec per system
    bms, by = bound_ms(nbytes(a, diag, x0, x), 2.0 * batch * f * f, a.dtype)
    ok = err <= 2e-3 and lane_ok
    log(f"[K5b solve_cg_aug] slice of {batch} systems, A' {a.dtype}: "
        f"max|dx|={err:.3e} (limit 2e-3), lane f-1 of x zero: {lane_ok}; "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms "
        f"({by}); {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def check_k4(cs, solve, a_reg, b, x0, cfg):
    """K4 through the public dispatcher, on one solve slice with the
    diagonal already added."""
    kw = dict(solver="cg", cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
              backend="pallas")
    before = cs.LAUNCHES["solve_cg"]
    x = solve(a_reg, b, x0, **kw)
    rose = cs.LAUNCHES["solve_cg"] == before + 1
    px = cs.solve_cg_plain(a_reg, b, x0, cfg.cg_iters, cfg.cg_tol)
    err = (x - px).abs().max().item()
    ms = time_ms(lambda: solve(a_reg, b, x0, **kw))
    plain = time_ms(lambda: cs.solve_cg_plain(a_reg, b, x0, cfg.cg_iters,
                                              cfg.cg_tol), reps=3)
    batch, f, _ = a_reg.shape
    bms, by = bound_ms(nbytes(a_reg, b, x0, x), 2.0 * batch * f * f,
                       a_reg.dtype)
    ok = err <= 2e-3 and rose
    log(f"[K4 solve_cg] ops.solve.solve without diag, slice of {batch} "
        f"systems, A {a_reg.dtype}: max|dx|={err:.3e} (limit 2e-3), the "
        f"dispatcher launched the kernel: {rose}; kernel {ms:.3f} ms, "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def chunk_x0(ch, current):
    """The warm start of one chunk: the rows' current factors, zeros for
    the dummy tail rows."""
    return torch.nn.functional.pad(
        current.index_select(0, ch.rows_real),
        (0, 0, 0, ch.rows.shape[0] - ch.n_real))


def check_fused_256(cs, table_ext, ch, current, cfg, label, f2=None):
    """K7 (with f2) or K1 at f=256 on one chunk of a 256-lane table:
    kernel vs plain, limits as K1's; K7's dead lanes and empty rows must
    be exactly 0. The operations counted are those of the live lanes:
    2 * nnz * (128 + f2)^2 for K7, 2 * nnz * 256^2 for K1."""
    x0 = chunk_x0(ch, current)
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    if f2 is None:
        name, live = "K1 gather_gram_cg f=256", 256
        fn, plain_fn = cs.gather_gram_cg, cs.gather_gram_cg_plain
    else:
        name, live = f"K7 gather_gram_cg_wide f2={f2}", 128 + f2
        args = args + (f2,)
        fn, plain_fn = cs.gather_gram_cg_wide, cs.gather_gram_cg_wide_plain
    x, se = fn(*args, **kw)
    px, pse = plain_fn(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    zero_ok = bool((x[:, live:] == 0).all()) and \
        bool((x[ch.nnz == 0] == 0).all())
    del px, pse
    ms = time_ms(lambda: fn(*args, **kw))
    plain = time_ms(lambda: plain_fn(*args, **kw), reps=3)
    r, p = ch.cols.shape
    flops = 2.0 * float(ch.nnz.sum().item()) * live * live
    item = table_ext.element_size()
    bms, by = bound_ms(table_ext.shape[0] * live * item + r * live * 4 +
                       nbytes(ch.cols, ch.vals, ch.nnz, x, se), flops,
                       table_ext.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3 and zero_ok
    log(f"[{name}] {label} chunk R={r} P={p}: max|dx|={err:.3e} (limit "
        f"2e-3), max rel dse={se_rel:.3e} (limit 1e-3), dead lanes and "
        f"empty rows exactly 0: {zero_ok}; kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def gathered_slabs(table_ext, ch, f2):
    """G of one chunk, gathered with torch into the two lane slabs K8
    takes: g1 (R, P, 128) and the packed g2 (R, P, f2)."""
    r, p = ch.cols.shape
    idx = ch.cols.reshape(-1).long()
    g1 = table_ext[:, :128].index_select(0, idx).reshape(r, p, 128)
    g2 = table_ext[:, 128:128 + f2].index_select(0, idx).reshape(r, p, f2)
    return g1, g2


def check_k8(cs, table_ext, ch, current, cfg, f2, label):
    """K8 on the gathered G of one theta chunk: kernel vs plain, and
    against K1 at f=256 on the same rows (rtol 1e-5 + 1e-6)."""
    x0 = chunk_x0(ch, current)
    g1, g2 = gathered_slabs(table_ext, ch, f2)
    args = (g1, g2, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    x, se = cs.fused_gram_cg_cat(*args, **kw)
    px, pse = cs.fused_gram_cg_cat_plain(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    del px, pse
    mx, mse = cs.gather_gram_cg(table_ext, ch.cols, ch.vals, ch.nnz, x0,
                                cfg.lam, **kw)
    mono_ok = bool(((x - mx).abs() <= 1e-5 * mx.abs() + 1e-6).all()) and \
        bool(((se - mse).abs() <= 1e-5 * mse.abs() + 1e-6).all())
    mono_err = (x - mx).abs().max().item()
    del mx, mse
    ms = time_ms(lambda: cs.fused_gram_cg_cat(*args, **kw))
    plain = time_ms(lambda: cs.fused_gram_cg_cat_plain(*args, **kw), reps=3)
    r, p = ch.cols.shape
    bms, by = bound_ms(nbytes(g1, g2, ch.vals, ch.nnz, x0, x, se),
                       2.0 * r * p * 256 * 256, g1.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3 and mono_ok
    log(f"[K8 fused_gram_cg_cat f2={f2}] {label} chunk R={r} P={p}, G "
        f"{g1.dtype}: max|dx|={err:.3e} (limit 2e-3), max rel dse="
        f"{se_rel:.3e} (limit 1e-3), against K1 at f=256 max|dx|="
        f"{mono_err:.3e} (limit rtol 1e-5 + 1e-6: {mono_ok}); kernel "
        f"{ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def phase_totals(cs, al, theta_t, x_t):
    """Device time summed over one phase's chunks (CUDA events): the
    fused kernel (K1, or K6 when the config takes the augmented form)
    over the theta phase; the Gram kernel alone (K2 or K5a) over the X
    phase; and the X phase's whole Gram step (that kernel + the
    index_add_ scatter into the accumulators)."""
    cfg = al.cfg
    f = cfg.f_pad

    def timed(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    table_ext = torch.cat([x_t.to(torch.bfloat16),
                           x_t.new_zeros((1, f), dtype=torch.bfloat16)])
    aug_direct = cs.aug_enabled(cfg)

    def k1_phase():
        for ch in al.plan_theta[1]:
            x0 = torch.zeros((ch.rows.shape[0], f), device="cuda")
            cs.gather_gram_cg(table_ext, ch.cols, ch.vals, ch.nnz, x0,
                              cfg.lam, cg_iters=cfg.cg_iters,
                              cg_tol=cfg.cg_tol, aug=aug_direct)

    plan, chunks, _ = al.plan_x
    s = plan.panel_size
    th16 = torch.nn.functional.pad(theta_t.to(torch.bfloat16),
                                   (0, 0, 0, plan.n_panels * s -
                                    theta_t.shape[0]))
    zero = th16.new_zeros((1, f))
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks),
                              plan.num_rows)

    gram = cs.gather_gram_aug_out if al._use_panel_aug() else \
        cs.gather_gram_out

    def k2_phase():
        for ch in chunks:
            tp = torch.cat([th16[ch.panel * s:(ch.panel + 1) * s], zero])
            gram(tp, ch.cols, ch.vals, out_dtype=a_dtype)

    return (timed(k1_phase), timed(k2_phase),
            timed(lambda: al.accumulate_panels(theta_t, al.plan_x)))


def full_width(cs, model, label, expect, absent, x0, th0, iters=ITERS):
    """One full-width path: ALS.run with every launch count read around
    it alone."""
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launch_counts()
    res = model.run(x0, th0)
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_iter = [h.x_seconds + h.theta_seconds for h in res.history]
    for h in res.history:
        log(f"[{label}] iter {h.iteration}: x {h.x_seconds:.4f} s, "
            f"theta {h.theta_seconds:.4f} s, rmse {h.rmse_seconds:.4f} "
            f"s, train {h.train_rmse:.6f}, test {h.test_rmse:.6f}")
    log(f"[{label}] seconds per iteration (x + theta): "
        f"{[round(t, 4) for t in per_iter]}, median "
        f"{statistics.median(per_iter):.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    tr = [h.train_rmse for h in res.history]
    if len(tr) != iters or \
            not np.all(np.isfinite(tr + [h.test_rmse for h in res.history])):
        raise AssertionError(f"{label}: non-finite RMSE")
    if not tr[-1] < tr[0]:
        raise AssertionError(f"{label}: train RMSE did not fall")
    for name in expect:
        if launches[name] < iters:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times in "
                f"{iters} iterations")
    for name in absent:
        if launches[name]:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times on a "
                f"path that does not run it")
    return res.history, launches


def wide_paths(cs, ALS, cfg, train, csc, test, small_train, small_test,
               results):
    """Phase 5: the F > 128 path. Fills results[...] for K7 and K8, adds
    K1's numbers at f=256 to its entry, and returns the launch counts
    of K7 (the wide_kernel="on" run) and K8 (its own path)."""
    import copy

    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.models import als as als_mod
    from cumf_als_tpu_torch.ops.tiling import SplitPlan, UpdatePlan

    cfg_w = cfg.replace(f=200, wide_kernel="on")
    f2 = cs.wide_f2(cfg_w.f)
    split_s = []
    build_split_plan = als_mod.build_split_plan

    def timed_split_plan(*a, **k):
        t0 = time.monotonic()
        plan = build_split_plan(*a, **k)
        split_s.append(time.monotonic() - t0)
        return plan

    als_mod.build_split_plan = timed_split_plan
    try:
        al = ALS(cfg_w, train, csc, test, device=DEV)
    finally:
        als_mod.build_split_plan = build_split_plan
    plan_x, chunks_x, aux_x = al.plan_x
    log(f"[wide] F={cfg_w.f} f_pad={cfg_w.f_pad} f2={f2}: plans "
        f"{al.plan_seconds:.1f} s, of which the numpy build_split_plan "
        f"{sum(split_s):.1f} s; X phase: {type(plan_x).__name__} "
        f"({len(chunks_x)} chunks, {plan_x.n_parts} parts of "
        f"{plan_x.part_size} rows, expansion {plan_x.expansion:.3f}), "
        f"theta phase: {type(al.plan_theta[0]).__name__} "
        f"({len(al.plan_theta[1])} chunks)")
    if not (isinstance(plan_x, SplitPlan) and plan_x.n_parts == 4 and
            plan_x.part_size == 131072 and
            isinstance(al.plan_theta[0], UpdatePlan) and
            cs.wide_enabled(cfg_w) and cfg_w.f_pad == 256):
        raise AssertionError("expected the split X route with 4 parts of "
                             "131072 rows and the direct theta route")

    # ---- 5a. the three kernels against their plain versions
    x0_np, th0_np = init_factors(cfg_w.m, cfg_w.n, cfg_w.f, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(2)
    theta_t = al._pad_f(th0_np)
    # a stand-in X for the theta-phase table: the real X starts at zero
    x_t = al._pad_f(0.2 * torch.rand((cfg_w.m, cfg_w.f), generator=gen,
                                     device=DEV).cpu().numpy())

    def ext16(t):
        return torch.cat([t.to(torch.bfloat16),
                          t.new_zeros((1, t.shape[1]),
                                      dtype=torch.bfloat16)])

    x_ext = ext16(x_t)
    chunks_t = al.plan_theta[1]
    widest = max(chunks_t, key=lambda c: c.width)
    populous = max(chunks_t, key=lambda c: c.rows.shape[0] * c.width)
    ok_all = True
    ok, _ = check_fused_256(cs, x_ext, widest, theta_t, cfg_w,
                            "theta widest", f2=f2)
    ok_all &= ok
    ok, results["gather_gram_cg_wide"] = check_fused_256(
        cs, x_ext, populous, theta_t, cfg_w, "theta most populous", f2=f2)
    ok_all &= ok
    ch_x = max(chunks_x, key=lambda c: c.rows.shape[0] * c.width)
    parts = plan_x.chunks[chunks_x.index(ch_x)].parts
    th_perm_ext = ext16(theta_t.index_select(0, aux_x["perm"]))
    ok, _ = check_fused_256(cs, th_perm_ext, ch_x, x_t, cfg_w,
                            f"split X (parts {parts}) most populous", f2=f2)
    ok_all &= ok
    del th_perm_ext
    ok, _ = check_fused_256(cs, x_ext, widest, theta_t, cfg_w,
                            "theta widest")
    ok_all &= ok
    ok, k1_256 = check_fused_256(cs, x_ext, populous, theta_t, cfg_w,
                                 "theta most populous")
    ok_all &= ok
    ok, _ = check_k8(cs, x_ext, widest, theta_t, cfg_w, f2, "theta widest")
    ok_all &= ok
    ok, results["fused_gram_cg_cat"] = check_k8(
        cs, x_ext, populous, theta_t, cfg_w, f2, "theta most populous")
    ok_all &= ok
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # where the two phases spend their time: K7 chunk by chunk (CUDA
    # events), with the share of the chunks that hold fewer rows than the
    # card has SMs (one block solves one row, so those leave SMs idle)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    th_perm_ext = ext16(theta_t.index_select(0, aux_x["perm"]))
    for label, chunks, table, current in (
            ("theta", chunks_t, x_ext, theta_t),
            ("split X", chunks_x, th_perm_ext, x_t)):
        total = few = 0.0
        n_few = 0
        for ch in chunks:
            x0 = chunk_x0(ch, current)
            ms = time_ms(lambda: cs.gather_gram_cg_wide(
                table, ch.cols, ch.vals, ch.nnz, x0, cfg_w.lam, f2,
                cg_iters=cfg_w.cg_iters, cg_tol=cfg_w.cg_tol), reps=1)
            total += ms
            if ch.n_real < sms:
                few += ms
                n_few += 1
        log(f"[wide phase totals] K7 over the {len(chunks)} {label} chunks "
            f"{total:.1f} ms, of which {few:.1f} ms in the {n_few} chunks "
            f"with fewer than {sms} rows (the widest chunk: "
            f"{max(c.width for c in chunks)} slots)")
    del th_perm_ext
    torch.cuda.empty_cache()

    # ---- 5b. small runs with both new routes: card against CPU
    scfg = cfg.replace(m=small_train.num_rows, n=small_train.num_cols,
                       nnz=small_train.nnz, nnz_test=small_test.nnz, f=130,
                       panel_size=2048, split_gather="force", verbose=False,
                       debug_timing=False)
    sx0, sth0 = init_factors(scfg.m, scfg.n, scfg.f, seed=0)
    for label, extra, lim_tr, lim_te in (
            ("bf16 wide on", dict(wide_kernel="on"), 5e-3, 1e-2),
            ("f32 wide on", dict(wide_kernel="on", factor_dtype="f32",
                                 gram_dtype="f32"), 1e-3, 1e-3),
            ("f32 wide off", dict(wide_kernel="off", factor_dtype="f32",
                                  gram_dtype="f32"), 1e-3, 1e-3)):
        item = 2 if extra.get("factor_dtype", "bf16") == "bf16" else 4
        part_rows = -(-scfg.n // 3 // 8) * 8
        c = scfg.replace(gather_part_bytes=part_rows * 256 * item, **extra)
        small = {}
        for dev in (DEV, "cpu"):
            model = ALS(c, small_train, None, small_test, device=dev)
            assert isinstance(model.plan_x[0], SplitPlan)
            assert model.plan_x[0].n_parts == 3
            assert isinstance(model.plan_theta[0], UpdatePlan)
            assert cs.wide_enabled(c) == (extra["wide_kernel"] == "on")
            small[dev] = model.run(sx0, sth0).history
        for hg, hc in zip(small[DEV], small["cpu"]):
            dtr = abs(hg.train_rmse - hc.train_rmse)
            dte = abs(hg.test_rmse - hc.test_rmse)
            log(f"[small F=130 split, {label}] iter {hg.iteration}: card "
                f"train {hg.train_rmse:.6f} test {hg.test_rmse:.6f} | cpu "
                f"train {hc.train_rmse:.6f} test {hc.test_rmse:.6f} (limits "
                f"{lim_tr:g}, {lim_te:g})")
            if not (dtr <= lim_tr and dte <= lim_te):
                raise AssertionError("card and CPU runs disagree")

    # ---- 5c. the F = 200 path at full width
    others = SPLIT_KERNELS + AUG_KERNELS + ("solve_cg",)
    _, launches_on = full_width(
        cs, al, "wide on", ("gather_gram_cg_wide",),
        others + ("fused_gram_cg_cat",), x0_np, th0_np)
    al_off = copy.copy(al)     # the same plans; wide_kernel steers no plan
    al_off.cfg = cfg_w.replace(wide_kernel="off", iters=2)
    _, launches_off = full_width(
        cs, al_off, "wide off", ("gather_gram_cg",),
        others[1:] + WIDE_KERNELS, x0_np, th0_np, iters=2)

    # ---- 5d. K8's path: no route of ALS calls it (as in the JAX
    # package), so its public wrapper runs over every theta chunk on a G
    # gathered with torch, each chunk held against K1 at f=256
    kw = dict(cg_iters=cfg_w.cg_iters, cg_tol=cfg_w.cg_tol)
    cs.reset_launch_counts()
    worst = 0.0
    k8_ok = True
    for ch in chunks_t:
        x0 = chunk_x0(ch, theta_t)
        g1, g2 = gathered_slabs(x_ext, ch, f2)
        x8, se8 = cs.fused_gram_cg_cat(g1, g2, ch.vals, ch.nnz, x0,
                                       cfg_w.lam, **kw)
        del g1, g2
        x1, se1 = cs.gather_gram_cg(x_ext, ch.cols, ch.vals, ch.nnz, x0,
                                    cfg_w.lam, **kw)
        worst = max(worst, (x8 - x1).abs().max().item())
        k8_ok &= bool(((x8 - x1).abs() <= 1e-5 * x1.abs() + 1e-6).all())
        k8_ok &= bool(((se8 - se1).abs() <= 1e-5 * se1.abs() + 1e-6).all())
        k8_ok &= bool(torch.isfinite(x8).all())
    torch.cuda.synchronize()
    k8_launches = cs.LAUNCHES["fused_gram_cg_cat"]
    log(f"[K8 path] fused_gram_cg_cat over the {len(chunks_t)} theta "
        f"chunks: {k8_launches} launches, max|x - x_K1|={worst:.3e} (limit "
        f"rtol 1e-5 + 1e-6: {k8_ok})")
    if k8_launches < len(chunks_t) or not k8_ok:
        raise AssertionError("K8 path failed")

    results["gather_gram_cg"].update(
        {f"f256_{k}": v for k, v in k1_256.items()},
        f256_launches=launches_off["gather_gram_cg"])
    return {"gather_gram_cg_wide": launches_on["gather_gram_cg_wide"],
            "fused_gram_cg_cat": k8_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   workload_ratings)
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops import _build
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    from cumf_als_tpu_torch.ops.solve import solve
    from cumf_als_tpu_torch.ops.tiling import PanelPlan, UpdatePlan
    from cumf_als_tpu_torch.utils.io import transpose_csr

    # ---- 1. card and build
    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    t0 = time.monotonic()
    _build.build(force=True)
    if set(_build.KERNELS) != set(REPLACES):
        raise AssertionError("the kernel table and this script disagree")
    log(f"[build] {len(_build.KERNELS)} kernels built in "
        f"{time.monotonic() - t0:.1f} s")

    # ---- data and plans of the full Netflix shape (shared by 2 and 4)
    t0 = time.monotonic()
    train, test = workload_ratings("netflix", scale=1.0, seed=0)
    csc = transpose_csr(train)
    gen_s = time.monotonic() - t0
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=ITERS, backend="pallas",
                          solver="cg", factor_dtype="bf16",
                          gram_dtype="bf16", verbose=True,
                          debug_timing=True)
    t0 = time.monotonic()
    al = ALS(cfg, train, csc, test, device="cuda")
    plan_s = time.monotonic() - t0
    log(f"[data] netflix scale 1.0: m={train.num_rows} n={train.num_cols} "
        f"nnz={train.nnz} nnz_test={test.nnz}; generation+transpose "
        f"{gen_s:.1f} s, plans (built and moved to the card) {plan_s:.1f} s")
    x_route = type(al.plan_x[0]).__name__
    t_route = type(al.plan_theta[0]).__name__
    log(f"[routes] X phase: {x_route} ({len(al.plan_x[1])} chunks), theta "
        f"phase: {t_route} ({len(al.plan_theta[1])} chunks)")
    if not (isinstance(al.plan_x[0], PanelPlan) and
            isinstance(al.plan_theta[0], UpdatePlan)):
        raise AssertionError("expected the panel X route and direct theta")

    # ---- 2a. the split kernels against their plain versions, at
    # main-path shapes
    x0_np, th0_np = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    theta_t = al._pad_f(th0_np)
    # a stand-in X for the theta-phase table: the real X starts at zero
    x_t = al._pad_f(0.2 * torch.rand((cfg.m, cfg.f), generator=gen,
                                     device="cuda").cpu().numpy())
    table_ext = torch.cat([x_t.to(torch.bfloat16),
                           torch.zeros((1, cfg.f_pad), dtype=torch.bfloat16,
                                       device="cuda")])

    def theta_chunks(model):
        chunks = model.plan_theta[1]
        return (max(chunks, key=lambda c: c.width),
                max(chunks, key=lambda c: c.rows.shape[0] * c.width))

    def x_chunk_and_panel(model):
        plan, chunks, _ = model.plan_x
        ch = max(chunks, key=lambda c: c.rows.shape[0] * c.width)
        s = plan.panel_size
        th16 = theta_t.to(torch.bfloat16)
        return ch, torch.cat([th16[ch.panel * s:(ch.panel + 1) * s],
                              th16.new_zeros((1, cfg.f_pad))])

    def totals(model, names):
        k1_tot, k2_tot, gram_tot = phase_totals(cs, model, theta_t, x_t)
        log(f"[phase totals] {names[0]} over the {len(model.plan_theta[1])} "
            f"theta chunks {k1_tot:.1f} ms; {names[1]} over the "
            f"{len(model.plan_x[1])} X chunks {k2_tot:.1f} ms; X-phase Gram "
            f"step ({names[1]} + index_add_) {gram_tot:.1f} ms")

    results, ok_all = {}, True
    widest, populous = theta_chunks(al)
    ok, _ = check_k1(cs, table_ext, widest, theta_t, cfg, "widest")
    ok_all &= ok
    ok, results["gather_gram_cg"] = check_k1(cs, table_ext, populous,
                                             theta_t, cfg, "most populous")
    ok_all &= ok

    plan_x, chunks_x, aux_x = al.plan_x
    ch2, tp = x_chunk_and_panel(al)
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks_x),
                              plan_x.num_rows)
    ok, results["gather_gram_out"] = check_k2(cs, tp, ch2, a_dtype)
    ok_all &= ok
    del tp, ch2, widest, populous

    a_buf, b_buf = al.accumulate_panels(theta_t, al.plan_x)
    x0_full = torch.zeros((aux_x["m_pad"], cfg.f_pad), device="cuda")
    ok, results["solve_cg_reg"] = check_k3(
        cs, a_buf, b_buf, x0_full, aux_x["row_nnz_pad"], 0,
        aux_x["solve_batch"], cfg)
    ok_all &= ok
    del a_buf, b_buf, x0_full
    totals(al, ("K1", "K2"))
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # ---- 3. small Netflix-shaped runs: card against CPU. The f32 limits
    # are those of the CPU tests: the card's f32 index_add_ adds with
    # atomics in an order that changes from run to run, which moves the
    # accumulators by rounding only.
    str_, ste = workload_ratings("netflix", scale=0.01, seed=1)
    scfg = cfg.replace(m=str_.num_rows, n=str_.num_cols, nnz=str_.nnz,
                       nnz_test=ste.nnz, panel_size=2048, verbose=False,
                       debug_timing=False)
    sx0, sth0 = init_factors(scfg.m, scfg.n, scfg.f, seed=0)
    for label, extra, aug_panel, lim_tr, lim_te in (
            ("bf16", {}, False, 5e-3, 1e-2),
            ("f32 aug auto", dict(gram_dtype="f32"), True, 1e-3, 1e-3),
            ("f32 aug force", dict(gram_dtype="f32", aug_gram="force"),
             True, 1e-3, 1e-3)):
        small = {}
        for dev in ("cuda", "cpu"):
            model = ALS(scfg.replace(**extra), str_, None, ste, device=dev)
            assert isinstance(model.plan_x[0], PanelPlan)
            assert isinstance(model.plan_theta[0], UpdatePlan)
            assert model._use_panel_aug() == aug_panel
            small[dev] = model.run(sx0, sth0).history
        for hg, hc in zip(small["cuda"], small["cpu"]):
            dtr = abs(hg.train_rmse - hc.train_rmse)
            dte = abs(hg.test_rmse - hc.test_rmse)
            log(f"[small {label}] iter {hg.iteration}: card train "
                f"{hg.train_rmse:.6f} test {hg.test_rmse:.6f} | cpu train "
                f"{hc.train_rmse:.6f} test {hc.test_rmse:.6f} (limits "
                f"{lim_tr:g}, {lim_te:g})")
            if not (dtr <= lim_tr and dte <= lim_te):
                raise AssertionError("card and CPU runs disagree")

    # ---- 4a. the bf16 path at full width (split buffers: K1, K2, K3)
    log(f"[main] data {gen_s:.1f} s, plans {plan_s:.1f} s")
    hist_main, launches = full_width(
        cs, al, "main", SPLIT_KERNELS,
        AUG_KERNELS + WIDE_KERNELS + ("solve_cg",), x0_np, th0_np)
    del al, plan_x, chunks_x, aux_x   # frees the plans on the card
    torch.cuda.empty_cache()

    # ---- 2b. the augmented kernels and K4 against their plain versions,
    # on the plans of this slice's configuration
    cfg_aug = cfg.replace(gram_dtype="f32", aug_gram="force")
    t0 = time.monotonic()
    al_aug = ALS(cfg_aug, train, csc, test, device="cuda")
    log(f"[aug] plans of the f32 aug_gram=force configuration "
        f"{time.monotonic() - t0:.1f} s")
    if not (isinstance(al_aug.plan_x[0], PanelPlan) and
            isinstance(al_aug.plan_theta[0], UpdatePlan) and
            al_aug._use_panel_aug() and cs.aug_enabled(cfg_aug)):
        raise AssertionError("expected the aug panel X route and the aug "
                             "direct theta route")
    widest, populous = theta_chunks(al_aug)
    ok, _ = check_k1(cs, table_ext, widest, theta_t, cfg_aug, "widest",
                     aug=True)
    ok_all &= ok
    ok, results["gather_gram_cg_aug"] = check_k1(
        cs, table_ext, populous, theta_t, cfg_aug, "most populous", aug=True)
    ok_all &= ok
    ch5, tp = x_chunk_and_panel(al_aug)
    ok, results["gather_gram_aug_out"] = check_k5a(cs, tp, ch5)
    ok_all &= ok
    del tp, ch5, widest, populous

    aux_x = al_aug.plan_x[2]
    batch, m_pad = aux_x["solve_batch"], aux_x["m_pad"]
    a_aug, none = al_aug.accumulate_panels(theta_t, al_aug.plan_x)
    if none is not None or a_aug.dtype != torch.float32:
        raise AssertionError("expected one f32 augmented accumulator")
    x0_full = torch.zeros((m_pad, cfg.f_pad), device="cuda")
    nnzf = aux_x["row_nnz_pad"].float()
    diag_full = nnzf * cfg.lam + (nnzf == 0).float()
    ok, results["solve_cg_aug"] = check_k5b(
        cs, a_aug[:batch], diag_full[:batch], x0_full[:batch], cfg_aug)
    ok_all &= ok

    def regularized(lo):
        """Systems [lo, lo + batch) unpacked, diagonal already added."""
        ua, ub, _ = cs.unpack_aug(a_aug[lo:lo + batch])
        ua.diagonal(dim1=1, dim2=2).add_(diag_full[lo:lo + batch, None])
        return ua, ub

    a_reg, b_reg = regularized(0)
    ok, results["solve_cg"] = check_k4(cs, solve, a_reg, b_reg,
                                       x0_full[:batch], cfg_aug)
    ok_all &= ok
    del a_reg, b_reg
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # K4's path: the dispatcher without a diagonal over every solve slice,
    # held against the augmented solve of the same systems (K5b adds the
    # same diagonal to the same f32 entries, so the two agree closely)
    kw = dict(solver="cg", cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
              backend="pallas")
    cs.reset_launch_counts()
    k4_err = 0.0
    for lo in range(0, m_pad, batch):
        a_reg, b_reg = regularized(lo)
        x4 = solve(a_reg, b_reg, x0_full[lo:lo + batch], **kw)
        del a_reg, b_reg
        x5 = solve(a_aug[lo:lo + batch], None, x0_full[lo:lo + batch],
                   diag=diag_full[lo:lo + batch], aug=True, **kw)
        k4_err = max(k4_err, (x4 - x5).abs().max().item())
        if not bool(torch.isfinite(x4).all()):
            raise AssertionError("K4 path: non-finite solution")
    torch.cuda.synchronize()
    k4_launches = cs.LAUNCHES["solve_cg"]
    log(f"[K4 path] ops.solve.solve(cg, pallas, no diag) over "
        f"{m_pad // batch} slices of {batch} systems: {k4_launches} "
        f"launches, max|x - x_aug|={k4_err:.3e} (limit 1e-5)")
    if k4_launches < m_pad // batch or k4_err > 1e-5:
        raise AssertionError("K4 path failed")
    del a_aug, x0_full, diag_full, nnzf
    totals(al_aug, ("K6", "K5a"))
    del theta_t, x_t, table_ext
    torch.cuda.empty_cache()

    # ---- 4b. this slice's path at full width (f32 accumulators,
    # aug_gram="force": K5a, K5b, K6)
    hist_aug, launches_aug = full_width(
        cs, al_aug, "aug", AUG_KERNELS,
        SPLIT_KERNELS + WIDE_KERNELS + ("solve_cg",), x0_np, th0_np)
    for hm, ha in zip(hist_main, hist_aug):
        log(f"[main | aug] iter {hm.iteration}: train {hm.train_rmse:.6f} | "
            f"{ha.train_rmse:.6f}, test {hm.test_rmse:.6f} | "
            f"{ha.test_rmse:.6f} (no limit: bf16 and f32 accumulators "
            f"round differently by design)")

    del al_aug, aux_x   # frees the plans on the card
    torch.cuda.empty_cache()

    # ---- 5. the factor widths above 128
    wide_launches = wide_paths(cs, ALS, cfg, train, csc, test, str_, ste,
                               results)

    launches.update({k: launches_aug[k] for k in AUG_KERNELS})
    launches["solve_cg"] = k4_launches
    launches.update(wide_launches)
    kernels = [dict(name=name, route="cuda",
                    source=f"cumf_als_tpu_torch/csrc/{name}.cu",
                    replaces=REPLACES[name], launches=launches[name],
                    **results[name]) for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
