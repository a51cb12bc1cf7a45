"""How far the batched-panel route sits from the panel route on the card,
and how far that moves from run to run (PyTorch/CUDA port).

    python3 scripts/torch_batched_readings.py [--runs 5] [--out FILE]

Run from the root of the repository on a machine with a CUDA card. On
the full Netflix data (the bench's cache, as chip_smoke.py phase 6 takes
it) it builds phase 6's two models for each accumulator dtype (bf16 and
f32; Cholesky, `panel_budget_bytes` 2^29 and `batch_rows` 4096 against
the default budget) and:

- runs `chip_smoke.x_phase_rows` three times: one X phase of each route
  on iteration 0's theta, the Grams entry by entry as a share of their
  rounding bound and x row by row;
- runs the panel route's X phase twice on the same theta and reports the
  per-row relative difference of x between the two runs (index_add_
  adds with atomics, so this is the run-to-run floor);
- runs `--runs` 3-iteration trajectories of each route with bf16
  accumulators (2 with f32) and reports, per iteration, the smallest and
  largest train and test RMSE gap between the routes over the runs.

Prints one line of JSON with the card's name and power limit, and with
`--out FILE` also writes it there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_batched_readings: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as smoke
    from cumf_als_tpu_torch import bench
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops import _build
    from cumf_als_tpu_torch.utils.io import transpose_csr

    out = {"card": smoke.card_line()}
    _build.build(["gather_gram_out"])
    train, test = smoke.netflix_data(bench)
    csc = transpose_csr(train)
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=smoke.ITERS,
                          backend="pallas", factor_dtype="bf16",
                          debug_timing=False)
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    for gram_dtype, runs in (("bf16", args.runs), ("f32", 2)):
        batched, panel = smoke.batched_models(ALS, cfg, train, csc, test,
                                              gram_dtype)
        theta = smoke.iteration0_theta(panel, th0)
        rows = [smoke.x_phase_rows(batched, panel, theta) for _ in range(3)]
        for r in rows:
            smoke.log(f"[{gram_dtype} X phase rows] {r}")
        p1 = panel._update_phase(theta, torch.zeros_like(theta[:cfg.m]),
                                 panel.plan_x, False)[0]
        p2 = panel._update_phase(theta, torch.zeros_like(theta[:cfg.m]),
                                 panel.plan_x, False)[0]
        live = torch.from_numpy(np.diff(train.indptr) > 0).to("cuda")
        rerun = ((p1 - p2)[live].norm(dim=1)
                 / p2[live].norm(dim=1).clamp_min(1e-30))
        floor = {"x_rel_max": rerun.max().item(),
                 "x_rel_median": rerun.median().item()}
        smoke.log(f"[{gram_dtype} panel X phase, run against run] {floor}")
        del p1, p2
        gaps = []
        for k in range(runs):
            got = batched.run(x0, th0).history
            want = panel.run(x0, th0).history
            gaps.append([(abs(g.train_rmse - w.train_rmse),
                          abs(g.test_rmse - w.test_rmse))
                         for g, w in zip(got, want)])
            smoke.log(f"[{gram_dtype} trajectory {k}] gaps (train, test) "
                      f"per iteration {gaps[-1]}; batched train "
                      f"{[round(h.train_rmse, 6) for h in got]}, panel "
                      f"{[round(h.train_rmse, 6) for h in want]}")
        per_iter = [{"train": [min(g[i][0] for g in gaps),
                               max(g[i][0] for g in gaps)],
                     "test": [min(g[i][1] for g in gaps),
                              max(g[i][1] for g in gaps)]}
                    for i in range(len(gaps[0]))]
        out[gram_dtype] = {
            "x_phase_rows": rows, "panel_rerun": floor, "runs": runs,
            "gap_min_max_per_iteration": per_iter}
        del batched, panel
        torch.cuda.empty_cache()
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
