"""The CG's share of the 256-lane body on the card (PyTorch/CUDA port).

    python3 scripts/torch_wide_cg_share.py

Run from the root of the repository on a machine with a CUDA card. It
builds the Netflix-shaped data (scale 1.0) and the F=200 plans as
chip_smoke.py does (X on the split route, theta direct, f2 = 96), then
times K7 (`gather_gram_cg_wide`) and K1 at f = 256 (`gather_gram_cg`)
as the wrappers route them at cg_iters=0 and at cg_iters=6 on the most
populous theta chunk and the most populous split X chunk (both of more
rows than the card has SMs: the uncut kernel on the FMA body; since the
tensor-core pass 1, the two passes), as device time behind queued work
(chip_smoke.queued_ms). `cg_iters` is a runtime argument,
so the two readings run the same build; their difference is the CG's
share of the time (at cg_iters=0 the kernel still forms b - A x0 and the
train error). Where the wrappers take the two passes of the row cut on
that route, pass 1 (`span_grams`) is also timed alone. Prints one line
of JSON with the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_cg_share: no CUDA device", file=sys.stderr)
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
    chunks_t = al.plan_theta[1]
    chunks_x = al.plan_x[1]
    th_perm_ext = smoke.ext16(theta_t.index_select(0, al.plan_x[2]["perm"]))
    picks = (("theta most populous", x_ext, theta_t,
              max(chunks_t, key=lambda c: c.rows.shape[0] * c.width)),
             ("split X most populous", th_perm_ext, x_t,
              max(chunks_x, key=lambda c: c.rows.shape[0] * c.width)))
    out = []
    for label, table, current, ch in picks:
        x0 = smoke.chunk_x0(ch, current)
        for kf2 in (f2, None):
            fl = 256 if kf2 is None else 128 + kf2
            row = dict(chunk=label, shape=list(ch.cols.shape),
                       kernel="K1 f=256" if kf2 is None else f"K7 f2={kf2}")
            for iters in (0, 6):
                cfg_i = cfg_w.replace(cg_iters=iters)
                fn = smoke.cut_runner(cs, table, ch, x0, cfg_i, kf2)[0]
                cs.reset_launch_counts()
                fn()
                torch.cuda.synchronize()
                row["launched"] = {k: v for k, v in cs.LAUNCHES.items() if v}
                row[f"ms_cg{iters}"] = smoke.queued_ms(fn)
            row["cg_ms"] = row["ms_cg6"] - row["ms_cg0"]
            if any(k.startswith("wide_span_gram") for k in row["launched"]):
                n_spans, span = cs._chunk_spans(
                    x0.device, *ch.cols.shape, None, **cs.span_plan(table))
                row["spans"] = [n_spans, span]
                row["pass1_ms"] = smoke.queued_ms(lambda: cs.span_grams(
                    table, ch.cols, ch.vals, ch.nnz, fl, n_spans, span))
            smoke.log(f"[cg share] {row}")
            out.append(row)
    print(json.dumps({"card": card, "cg_share": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
