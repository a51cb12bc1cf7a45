"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. card and build: the card's name and power limit, the torch/CUDA
   versions, and the build of every CUDA kernel from csrc/ (seven);
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
   against the augmented solve of the same systems.

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
}
SPLIT_KERNELS = ("gather_gram_cg", "gather_gram_out", "solve_cg_reg")
AUG_KERNELS = ("gather_gram_cg_aug", "gather_gram_aug_out", "solve_cg_aug")


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

    def full_width(model, label, expect, absent):
        """One full-width path: ALS.run with every launch count read
        around it alone."""
        torch.cuda.reset_peak_memory_stats()
        cs.reset_launch_counts()
        res = model.run(x0_np, th0_np)
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
        if not np.all(np.isfinite(tr + [h.test_rmse for h in res.history])):
            raise AssertionError(f"{label}: non-finite RMSE")
        if not tr[-1] < tr[0]:
            raise AssertionError(f"{label}: train RMSE did not fall")
        for name in expect:
            if launches[name] < ITERS:
                raise AssertionError(
                    f"{label}: {name} launched {launches[name]} times in "
                    f"{ITERS} iterations")
        for name in absent:
            if launches[name]:
                raise AssertionError(
                    f"{label}: {name} launched {launches[name]} times on a "
                    f"path that does not run it")
        return res.history, launches

    # ---- 4a. the bf16 path at full width (split buffers: K1, K2, K3)
    log(f"[main] data {gen_s:.1f} s, plans {plan_s:.1f} s")
    hist_main, launches = full_width(al, "main", SPLIT_KERNELS,
                                     AUG_KERNELS + ("solve_cg",))
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
    hist_aug, launches_aug = full_width(al_aug, "aug", AUG_KERNELS,
                                        SPLIT_KERNELS + ("solve_cg",))
    for hm, ha in zip(hist_main, hist_aug):
        log(f"[main | aug] iter {hm.iteration}: train {hm.train_rmse:.6f} | "
            f"{ha.train_rmse:.6f}, test {hm.test_rmse:.6f} | "
            f"{ha.test_rmse:.6f} (no limit: bf16 and f32 accumulators "
            f"round differently by design)")

    launches.update({k: launches_aug[k] for k in AUG_KERNELS})
    launches["solve_cg"] = k4_launches
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
