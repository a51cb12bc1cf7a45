"""Sweep of the row cut's constants on the tensor-core route (PyTorch/CUDA
port).

    python3 scripts/torch_wide_span_sweep.py

Run from the root of the repository on a machine with a CUDA card. It
builds the Netflix-shaped data (scale 1.0) and the F=200 plans as
chip_smoke.py does, then times K7 (`gather_gram_cg_wide`, f2 = 96) and
K1 at f = 256 (`gather_gram_cg`) on a bf16 table (the two passes, pass 1
on the tensor cores) over every chunk with fewer rows than the card has
SMs, split X and theta, with the spans that `row_spans` gives in 64-slot
tiles of at most `SPAN_MAX_TILES_MMA` a span for each `target` and
`min_tiles` of a grid, forced through the wrappers' `spans`. Device time chunk by chunk behind queued work
(chip_smoke.queued_each). Prints one line of JSON with the card's name
and power limit and the total of each setting.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TARGETS = (1, 2, 4, 8)
MIN_TILES = (2, 4, 8, 16)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_span_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import workload_ratings
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    from cumf_als_tpu_torch.utils.io import transpose_csr

    card = smoke.card_line()
    train, test = workload_ratings("netflix", scale=1.0, seed=0)
    csc = transpose_csr(train)
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=1, backend="pallas",
                          solver="cg", factor_dtype="bf16", gram_dtype="bf16",
                          verbose=False, debug_timing=False)
    al, cfg_w, f2, _, _, theta_t, x_t, x_ext = smoke.wide_setup(
        cs, ALS, cfg, train, csc, test)
    sms = smoke.sm_count()
    th_perm_ext = smoke.ext16(theta_t.index_select(0, al.plan_x[2]["perm"]))
    phases = (("split X", th_perm_ext, x_t, al.plan_x[1]),
              ("theta", x_ext, theta_t, al.plan_theta[1]))
    out = []
    for kf2 in (f2, None):
        kernel = "K1 f=256" if kf2 is None else f"K7 f2={kf2}"
        for label, table, current, chunks in phases:
            few = [c for c in chunks if c.cols.shape[0] < sms]
            runs = [smoke.cut_runner(cs, table, ch, smoke.chunk_x0(ch, current),
                                     cfg_w, kf2)[0] for ch in few]
            for target in TARGETS:
                for min_tiles in MIN_TILES:
                    spans = [cs.row_spans(*ch.cols.shape, sms, 64, min_tiles,
                                          target, cs.SPAN_MAX_TILES_MMA)[0]
                             for ch in few]
                    times = smoke.queued_each(
                        [lambda fn=fn, s=s: fn(spans=s)
                         for fn, s in zip(runs, spans)])
                    row = dict(kernel=kernel, phase=label, chunks=len(few),
                               target=target, min_tiles=min_tiles,
                               ms=sum(times))
                    smoke.log(f"[span sweep] {row}")
                    out.append(row)
    print(json.dumps({"card": card, "span_sweep": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
