"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. card and build: the card's name and power limit, the torch/CUDA
   versions, and the build of every CUDA kernel from csrc/;
2. each kernel against its plain PyTorch version on the card, on real
   chunks of the Netflix-shaped plans (the widest and the most populous
   theta-phase chunk for K1, the most populous X-phase panel chunk for
   K2, one full solve slice of the X-phase accumulators for K3), with
   kernel, plain, yardstick and bound times;
3. a small Netflix-shaped run (scale 0.01, lowered panel_size so both
   routes engage) on the card against the same run on the CPU;
4. the main path at full width: `ALS.run` for 3 iterations on the
   Netflix workload at scale 1.0 (~99M ratings, F=100, bf16 factors and
   Gram accumulators, backend "pallas", CG), with the X phase on the
   panel route and theta on the direct route, every kernel's launch
   count read around that run alone.

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
}


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
def check_k1(cs, table_ext, ch, theta, cfg, label):
    """K1 on one theta-phase chunk: kernel vs plain."""
    k = ch.n_real
    x0 = torch.nn.functional.pad(theta.index_select(0, ch.rows_real),
                                 (0, 0, 0, ch.rows.shape[0] - k))
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    x, se = cs.gather_gram_cg(*args, **kw)
    px, pse = cs.gather_gram_cg_plain(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    ms = time_ms(lambda: cs.gather_gram_cg(*args, **kw))
    plain = time_ms(lambda: cs.gather_gram_cg_plain(*args, **kw), reps=3)
    r, p = ch.cols.shape
    f = table_ext.shape[1]
    flops = 2.0 * float(ch.nnz.sum().item()) * f * f
    bms, by = bound_ms(nbytes(table_ext, ch.cols, ch.vals, ch.nnz, x0, x,
                              se), flops, table_ext.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3
    log(f"[K1 gather_gram_cg] {label} chunk R={r} P={p}: max|dx|={err:.3e} "
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


def phase_totals(cs, al, theta_t, x_t):
    """Device time summed over one phase's chunks (CUDA events): K1 over
    the theta phase; K2 alone over the X phase; and the X phase's whole
    Gram step (K2 + the index_add_ scatter into the accumulators)."""
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

    def k1_phase():
        for ch in al.plan_theta[1]:
            x0 = torch.zeros((ch.rows.shape[0], f), device="cuda")
            cs.gather_gram_cg(table_ext, ch.cols, ch.vals, ch.nnz, x0,
                              cfg.lam, cg_iters=cfg.cg_iters,
                              cg_tol=cfg.cg_tol)

    plan, chunks, _ = al.plan_x
    s = plan.panel_size
    th16 = torch.nn.functional.pad(theta_t.to(torch.bfloat16),
                                   (0, 0, 0, plan.n_panels * s -
                                    theta_t.shape[0]))
    zero = th16.new_zeros((1, f))
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks),
                              plan.num_rows)

    def k2_phase():
        for ch in chunks:
            tp = torch.cat([th16[ch.panel * s:(ch.panel + 1) * s], zero])
            cs.gather_gram_out(tp, ch.cols, ch.vals, out_dtype=a_dtype)

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

    # ---- 2. each kernel against its plain version, at main-path shapes
    x0_np, th0_np = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    theta_t = al._pad_f(th0_np)
    # a stand-in X for the theta-phase table: the real X starts at zero
    x_t = al._pad_f(0.2 * torch.rand((cfg.m, cfg.f), generator=gen,
                                     device="cuda").cpu().numpy())
    table_ext = torch.cat([x_t.to(torch.bfloat16),
                           torch.zeros((1, cfg.f_pad), dtype=torch.bfloat16,
                                       device="cuda")])
    chunks_t = al.plan_theta[1]
    widest = max(chunks_t, key=lambda c: c.width)
    populous = max(chunks_t, key=lambda c: c.rows.shape[0] * c.width)
    results, ok_all = {}, True
    ok, _ = check_k1(cs, table_ext, widest, theta_t, cfg, "widest")
    ok_all &= ok
    ok, results["gather_gram_cg"] = check_k1(cs, table_ext, populous,
                                             theta_t, cfg, "most populous")
    ok_all &= ok

    plan_x, chunks_x, aux_x = al.plan_x
    ch2 = max(chunks_x, key=lambda c: c.rows.shape[0] * c.width)
    s = plan_x.panel_size
    th16 = theta_t.to(torch.bfloat16)
    tp = torch.cat([th16[ch2.panel * s:(ch2.panel + 1) * s],
                    th16.new_zeros((1, cfg.f_pad))])
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks_x),
                              plan_x.num_rows)
    ok, results["gather_gram_out"] = check_k2(cs, tp, ch2, a_dtype)
    ok_all &= ok
    del tp

    a_buf, b_buf = al.accumulate_panels(theta_t, al.plan_x)
    x0_full = torch.zeros((aux_x["m_pad"], cfg.f_pad), device="cuda")
    ok, results["solve_cg_reg"] = check_k3(
        cs, a_buf, b_buf, x0_full, aux_x["row_nnz_pad"], 0,
        aux_x["solve_batch"], cfg)
    ok_all &= ok
    del a_buf, b_buf, x0_full
    k1_tot, k2_tot, gram_tot = phase_totals(cs, al, theta_t, x_t)
    log(f"[phase totals] K1 over the {len(chunks_t)} theta chunks "
        f"{k1_tot:.1f} ms; K2 over the {len(chunks_x)} X chunks "
        f"{k2_tot:.1f} ms; X-phase Gram step (K2 + index_add_) "
        f"{gram_tot:.1f} ms")
    del theta_t, x_t, table_ext, th16
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # ---- 3. small Netflix-shaped run: card against CPU
    str_, ste = workload_ratings("netflix", scale=0.01, seed=1)
    scfg = cfg.replace(m=str_.num_rows, n=str_.num_cols, nnz=str_.nnz,
                       nnz_test=ste.nnz, panel_size=2048, verbose=False,
                       debug_timing=False)
    sx0, sth0 = init_factors(scfg.m, scfg.n, scfg.f, seed=0)
    small = {}
    for dev in ("cuda", "cpu"):
        model = ALS(scfg, str_, None, ste, device=dev)
        assert isinstance(model.plan_x[0], PanelPlan)
        assert isinstance(model.plan_theta[0], UpdatePlan)
        small[dev] = model.run(sx0, sth0).history
    for hg, hc in zip(small["cuda"], small["cpu"]):
        dtr = abs(hg.train_rmse - hc.train_rmse)
        dte = abs(hg.test_rmse - hc.test_rmse)
        log(f"[small] iter {hg.iteration}: card train {hg.train_rmse:.6f} "
            f"test {hg.test_rmse:.6f} | cpu train {hc.train_rmse:.6f} "
            f"test {hc.test_rmse:.6f} (limits 5e-3, 1e-2)")
        if not (dtr <= 5e-3 and dte <= 1e-2):
            raise AssertionError("card and CPU runs disagree")

    # ---- 4. the main path at full width
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launch_counts()
    res = al.run(x0_np, th0_np)
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_iter = [h.x_seconds + h.theta_seconds for h in res.history]
    for h in res.history:
        log(f"[main] iter {h.iteration}: x {h.x_seconds:.4f} s, theta "
            f"{h.theta_seconds:.4f} s, rmse {h.rmse_seconds:.4f} s, train "
            f"{h.train_rmse:.6f}, test {h.test_rmse:.6f}")
    log(f"[main] seconds per iteration (x + theta): "
        f"{[round(t, 4) for t in per_iter]}, median "
        f"{statistics.median(per_iter):.4f}; data {gen_s:.1f} s, plans "
        f"{plan_s:.1f} s; peak device memory {peak / 2**30:.2f} GiB; "
        f"launches {launches}")
    tr = [h.train_rmse for h in res.history]
    if not np.all(np.isfinite(tr + [h.test_rmse for h in res.history])):
        raise AssertionError("non-finite RMSE")
    if not tr[-1] < tr[0]:
        raise AssertionError("train RMSE did not fall")
    for name in REPLACES:
        if launches[name] < ITERS:
            raise AssertionError(f"{name} launched {launches[name]} times "
                                 f"in {ITERS} iterations")

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
