"""K3's and K8's times on the card, with the CG and the G dtype apart,
beside K4 and K5b (PyTorch/CUDA port).

    python3 scripts/torch_solve_cat_readings.py [--cache DIR]
    python3 scripts/torch_solve_cat_readings.py --f256

Run from the root of the repository on a machine with a CUDA card. It
builds the Netflix-shaped data (scale 1.0) as chip_smoke.py does, and:

- K3 (`solve_cg_reg`) on the main path's first solve slice of the
  X-phase accumulators (F=100, bf16 split buffers: 16,384 systems of
  128 x 128, warm start zero, the slice chip_smoke.py's `check_k3`
  takes), with the bf16 A and with the same A widened to float32 (what
  a gram_dtype="f32" run without aug feeds K3), each at cg_iters 0 and
  6. At 0 the kernel still loads A and forms b - A x0, so the difference
  is the CG. Times are CUDA events around one launch (`time_ms`) and
  device time behind queued work (`queued_ms`); x against the plain
  version at cg_iters 6.
- K4 (`solve_cg`) and K5b (`solve_cg_aug`) on the same slice in
  float32: K4 on f32(A) + diag I with b beside it, K5b on the augmented
  A' that carries b in row and column f - 1 (lane 127 is free at F=100),
  at the run's cg_iters, by events and device time. Both run K3's body
  (csrc/bulk_cg.cuh); a tree from before that change ran them on a
  one-block-a-system CG, so the two trees compare the designs.
- K8 (`fused_gram_cg_cat`) on the most populous theta chunk of the
  F=200 plan (R=16384, P=256, f2 = 96), G gathered with torch from the
  bf16 table and from a float32 copy of it, by events, and beside it K1
  at f = 256 as its wrapper routes that chunk on the bf16 table (device
  time).

`--f256` times the solves at f = 256 alone, without the Netflix data:
K3 and K5b on chip_smoke.py's phase-13a systems (16,384 rows of a
synthetic panel chunk, P = 64, seed 11: K2's A and b and K5a's A', from
the plain versions, so any tree of the port builds the same inputs; the
diagonal nnz lam + [nnz = 0], a warm start with lane 255 and the empty
rows zero), with an f32 and a bf16 A, each at cg_iters 0 and 6
(cg_tol 1e-4), by events and device time; x against the plain version
at cg_iters 6, and the bound (A, diag, b, x0 and x read or written
once).

`--cache DIR` keeps those inputs in DIR (about 0.8 GB) after a first run
and reads them from there in later runs, so two trees of the port can be
timed on the same inputs in one call without building the data twice;
put DIR in a directory that .gitignore lists. Only the wrappers'
arguments of the earliest port are used, so the script also times an
older tree: copy it into that tree's scripts/ and run it there. Prints
one line of JSON with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def build_inputs(smoke, cs):
    """The K3 slice and the K8 chunk, built from the Netflix data."""
    import torch
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   workload_ratings)
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.utils.io import transpose_csr

    train, test = workload_ratings("netflix", scale=1.0, seed=0)
    csc = transpose_csr(train)
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=1, backend="pallas",
                          solver="cg", factor_dtype="bf16", gram_dtype="bf16",
                          verbose=False, debug_timing=False)
    al = ALS(cfg, train, csc, test, device="cuda")
    _, th0_np = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    theta_t = al._pad_f(th0_np)
    aux = al.plan_x[2]
    batch = aux["solve_batch"]
    a_buf, b_buf = al.accumulate_panels(theta_t, al.plan_x)
    nnzf = aux["row_nnz_pad"][:batch].float()
    k3 = dict(a=a_buf[:batch].clone(), b=b_buf[:batch].clone(),
              diag=nnzf * cfg.lam + (nnzf == 0).float(),
              x0=torch.zeros((batch, cfg.f_pad), device="cuda"),
              lam=cfg.lam, cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    del al, a_buf, b_buf, theta_t
    torch.cuda.empty_cache()
    al, cfg_w, f2, _, _, theta_t, _, x_ext = smoke.wide_setup(
        cs, ALS, cfg, train, csc, test)
    chunks = al.plan_theta[1]
    ch = max(chunks, key=lambda c: c.rows.shape[0] * c.width)
    k8 = dict(table=x_ext, cols=ch.cols, vals=ch.vals, nnz=ch.nnz,
              x0=smoke.chunk_x0(ch, theta_t), f2=f2, lam=cfg_w.lam)
    return k3, k8


def f256_readings(smoke, cs, lam=0.048, r=16384, p=64, seed=11):
    """K3 and K5b at f = 256 on the phase-13a systems (see above)."""
    import torch
    f = 256
    tp, ch = smoke.panel_chunk(f, r, p, seed)
    nnzf = ch.nnz.float()
    diag = nnzf * lam + (nnzf == 0).float()
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    x0 = 0.1 * torch.randn((r, f), generator=gen, device="cuda")
    x0[ch.nnz == 0] = 0
    x0[:, f - 1] = 0
    kw = dict(cg_tol=1e-4)
    rows = []
    for name in ("solve_cg_reg", "solve_cg_aug"):
        if name == "solve_cg_reg":
            a, b = cs.gather_gram_out_plain(tp, ch.cols, ch.vals)
            rest = (diag, b, x0)
        else:
            a = cs.gather_gram_aug_out_plain(tp, ch.cols, ch.vals)
            rest = (diag, x0)
        for dtype in (torch.float32, torch.bfloat16):
            ad = a.to(dtype)
            fn = getattr(cs, name)
            row = {"kernel": name, "a_dtype": str(dtype), "systems": r,
                   "f": f}
            for iters in (0, 6):
                def call():
                    return fn(ad, *rest, cg_iters=iters, **kw)
                row[f"events_ms_cg{iters}"] = smoke.time_ms(call)
                row[f"device_ms_cg{iters}"] = smoke.queued_ms(call)
            x = fn(ad, *rest, cg_iters=6, **kw)
            px = getattr(cs, f"{name}_plain")(ad, *rest, cg_iters=6, **kw)
            row["max_abs_err"] = (x - px).abs().max().item()
            row["bound_ms"] = smoke.bound_ms(
                smoke.nbytes(ad, *rest, x), 2.0 * r * f * f, dtype)[0]
            smoke.log(f"[f256 readings] {row}")
            rows.append(row)
            del ad, x, px
            torch.cuda.empty_cache()
        del a, rest
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_solve_cat_readings: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--cache", default=None)
    ap.add_argument("--f256", action="store_true")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as smoke
    from cumf_als_tpu_torch.ops import cuda_solve as cs

    card = smoke.card_line()
    if args.f256:
        print(json.dumps({"card": card, "root": ROOT,
                          "f256": f256_readings(smoke, cs)}))
        return 0
    path = os.path.join(args.cache, "inputs.pt") if args.cache else None
    if path and os.path.exists(path):
        k3, k8 = torch.load(path, map_location="cuda")
    else:
        k3, k8 = build_inputs(smoke, cs)
        if path:
            os.makedirs(args.cache, exist_ok=True)
            torch.save((k3, k8), path)
    out = {"card": card}

    kw = dict(cg_tol=k3["cg_tol"])
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        a = k3["a"].to(dtype)
        row = {"a_dtype": str(dtype), "systems": a.shape[0],
               "f": a.shape[-1]}
        for iters in (0, k3["cg_iters"]):
            def fn():
                return cs.solve_cg_reg(a, k3["diag"], k3["b"], k3["x0"],
                                       cg_iters=iters, **kw)
            row[f"events_ms_cg{iters}"] = smoke.time_ms(fn)
            row[f"device_ms_cg{iters}"] = smoke.queued_ms(fn)
        x = cs.solve_cg_reg(a, k3["diag"], k3["b"], k3["x0"],
                            cg_iters=k3["cg_iters"], **kw)
        px = cs.solve_cg_reg_plain(a, k3["diag"], k3["b"], k3["x0"],
                                   cg_iters=k3["cg_iters"], **kw)
        row["max_abs_err"] = (x - px).abs().max().item()
        row["bound_ms"] = smoke.bound_ms(
            smoke.nbytes(a, k3["diag"], k3["b"], k3["x0"], x),
            2.0 * a.shape[0] * a.shape[-1] ** 2, dtype)[0]
        smoke.log(f"[K3 readings] {row}")
        rows.append(row)
        del a, x, px
    out["k3"] = rows

    a32 = k3["a"].float()
    f = a32.shape[-1]
    a_reg = a32.clone()
    a_reg.diagonal(dim1=1, dim2=2).add_(k3["diag"][:, None])
    a_aug = a32.clone()
    a_aug[:, f - 1, :f - 1] = k3["b"][:, :f - 1]
    a_aug[:, :f - 1, f - 1] = k3["b"][:, :f - 1]
    del a32
    kw = dict(cg_iters=k3["cg_iters"], cg_tol=k3["cg_tol"])
    rows = []
    for name, fn in (
            ("K4 solve_cg",
             lambda: cs.solve_cg(a_reg, k3["b"], k3["x0"], **kw)),
            ("K5b solve_cg_aug",
             lambda: cs.solve_cg_aug(a_aug, k3["diag"], k3["x0"], **kw))):
        row = {"kernel": name, "events_ms": smoke.time_ms(fn),
               "device_ms": smoke.queued_ms(fn)}
        smoke.log(f"[K4/K5b readings] {row}")
        rows.append(row)
    out["k4_k5b"] = rows
    del a_reg, a_aug

    table, f2 = k8["table"], k8["f2"]
    ch = type("Chunk", (), dict(cols=k8["cols"]))
    rows = []
    kw = dict(cg_iters=k3["cg_iters"], cg_tol=k3["cg_tol"])
    for name, tab in (("bf16", table), ("float32", table.float())):
        g1, g2 = smoke.gathered_slabs(tab, ch, f2)
        args8 = (g1, g2, k8["vals"], k8["nnz"], k8["x0"], k8["lam"])
        cs.reset_launch_counts()
        x = cs.fused_gram_cg_cat(*args8, **kw)[0]
        torch.cuda.synchronize()
        row = {"g_dtype": name, "shape": list(k8["cols"].shape), "f2": f2,
               "launched": {k: v for k, v in cs.LAUNCHES.items() if v},
               "events_ms": smoke.time_ms(
                   lambda: cs.fused_gram_cg_cat(*args8, **kw))}
        px = cs.fused_gram_cg_cat_plain(*args8, **kw)[0]
        row["max_abs_err"] = (x - px).abs().max().item()
        smoke.log(f"[K8 readings] {row}")
        rows.append(row)
        del g1, g2, x, px
    k1 = cs.gather_gram_cg(table, k8["cols"], k8["vals"], k8["nnz"],
                           k8["x0"], k8["lam"], **kw)
    del k1
    rows.append({"k1_256_routed_device_ms": smoke.queued_ms(
        lambda: cs.gather_gram_cg(table, k8["cols"], k8["vals"], k8["nnz"],
                                  k8["x0"], k8["lam"], **kw))})
    smoke.log(f"[K8 readings] {rows[-1]}")
    out["k8"] = rows
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
