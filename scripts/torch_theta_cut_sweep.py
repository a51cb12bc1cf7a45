"""Sweep of the cut of K1 (`gather_gram_cg`) on theta chunks of few rows
at f = 128 (PyTorch/CUDA port).

    python3 scripts/torch_theta_cut_sweep.py [OUT]

Run from the root of the repository on a machine with a CUDA card. It
builds the theta plans of three configurations as chip_smoke.py does:
Netflix (scale 1.0, F=100, the main path's direct theta route),
hugewiki_mini (scale 1.0, F=100, the in-core ALS of phase 9) and the
hugewiki driver (hugewiki at chip_smoke.HUGEWIKI_SCALE, its sharded
out-of-core configuration with X on the card, phase 12a). For every
theta chunk with fewer rows than the blocks that fit the card (two an
SM) whose P is a whole number of 64-slot tiles, it times K1 on a table
of random factors (0.2 U(0, 1), bf16, as init_factors makes them) at
every S that divides P's tiles and keeps R S within those blocks,
forced through the wrapper's `spans` (S = 1: the uncut kernel); device
time behind queued work (chip_smoke.queued_each). Then it scores rules
of the form of `cs.gram_spans` (the largest such S within `target`
spans an SM and no span under `min_tiles` tiles, and S = 1 unless
T / S + `extra` < T for T tiles a row) by their summed time on each
configuration, against the uncut kernel and the best S of each chunk.
Prints one line of JSON with the card's name and power limit and writes
it to OUT (default .bench_cache/theta_cut_sweep.json).
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TARGETS = (1, 2)
MIN_TILES = (1, 2, 4, 8)
EXTRA_TILES = (0, 4, 8, 12, 16, 24)
F = 128


def candidates(r: int, tiles: int, sms: int):
    """S = 1 and every S > 1 that divides the tiles with R S within the
    two blocks an SM that fit the card."""
    return [1] + [s for s in range(2, tiles + 1)
                  if tiles % s == 0 and r * s <= 2 * sms]


def rule_spans(r: int, tiles: int, sms: int, target: int, min_tiles: int,
               extra: int) -> int:
    best = 1
    for s in range(2, tiles // min_tiles + 1):
        if r * s > target * sms:
            break
        if tiles % s == 0:
            best = s
    if best > 1 and tiles / best + extra >= tiles:
        return 1
    return best


def sweep(smoke, cs, label, chunks, table, lam):
    """Times of K1 on each cut-eligible chunk at each candidate S."""
    import torch
    sms = smoke.sm_count()
    out = []
    for ch in chunks:
        r, p = ch.cols.shape
        if r >= 2 * sms or p % 64 or p < 128:
            continue
        tiles = p // 64
        spans = candidates(r, tiles, sms)
        x0 = torch.zeros((r, F), device="cuda")
        times = smoke.queued_each([
            (lambda s=s: cs.gather_gram_cg(table, ch.cols, ch.vals, ch.nnz,
                                           x0, lam, spans=s))
            for s in spans])
        live = int(((ch.nnz.long().clamp(max=p) + 63) // 64).sum())
        out.append(dict(r=r, p=p, live_tiles=live,
                        ms={str(s): t for s, t in zip(spans, times)}))
    print(f"[theta cut sweep] {label}: {len(out)} chunks", file=sys.stderr,
          flush=True)
    return out


def score(rows, sms):
    """Summed ms of each rule, uncut and at each chunk's best S."""
    res = dict(uncut=sum(c["ms"]["1"] for c in rows),
               best=sum(min(c["ms"].values()) for c in rows), rules={})
    for target in TARGETS:
        for mt in MIN_TILES:
            for extra in EXTRA_TILES:
                tot = sum(c["ms"][str(rule_spans(c["r"], c["p"] // 64, sms,
                                                 target, mt, extra))]
                          for c in rows)
                res["rules"][f"target={target},min_tiles={mt},"
                             f"extra={extra}"] = tot
    return res


def table_of(rows: int, gen):
    import torch
    t = (0.2 * torch.rand((rows + 1, F), generator=gen, device="cuda")
         ).to(torch.bfloat16)
    t[rows] = 0
    t[:, F - 1] = 0
    return t


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_theta_cut_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from cumf_als_tpu_torch import bench
    from cumf_als_tpu_torch import hugewiki_full as hw
    from cumf_als_tpu_torch.config import NETFLIX, ALSConfig
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    from cumf_als_tpu_torch.parallel import sharded_ooc as so
    from cumf_als_tpu_torch.utils.io import transpose_csr

    card = smoke.card_line()
    sms = smoke.sm_count()
    gen = torch.Generator(device="cuda").manual_seed(7)
    runs = {}

    train, test, _ = smoke.workload_data(bench, "netflix",
                                         smoke.RECORDED_NETFLIX)
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=1, backend="pallas",
                          solver="cg", factor_dtype="bf16",
                          gram_dtype="bf16", verbose=False,
                          debug_timing=False)
    al = ALS(cfg, train, transpose_csr(train), test, device="cuda")
    runs["netflix"] = sweep(smoke, cs, "netflix theta", al.plan_theta[1],
                            table_of(cfg.m, gen), cfg.lam)
    del al, train, test
    torch.cuda.empty_cache()

    train, test, _ = smoke.workload_data(bench, "hugewiki_mini",
                                         smoke.RECORDED_HUGEWIKI_MINI)
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=100,
                    nnz=train.nnz, nnz_test=test.nnz, lam=0.048, iters=1,
                    solver="cg", backend="pallas", factor_dtype="bf16",
                    gram_dtype="bf16", use_panels="never", verbose=False,
                    debug_timing=False)
    al = ALS(cfg, train, transpose_csr(train), test, device="cuda")
    runs["hugewiki_mini"] = sweep(smoke, cs, "hugewiki_mini theta",
                                  al.plan_theta[1], table_of(cfg.m, gen),
                                  cfg.lam)
    del al, train, test
    torch.cuda.empty_cache()

    train, test = bench.load_workload("hugewiki", smoke.HUGEWIKI_SCALE)
    args = hw.build_parser().parse_args(
        ["--scale", str(smoke.HUGEWIKI_SCALE), "--iters", "1"])
    model = so.ShardedOutOfCoreALS(hw.make_config(args, train, test),
                                   train, None, test, n_devices=1,
                                   device="cuda")
    m_loc = model.row_plan.m_loc     # the device X as run() makes it
    table = torch.zeros((model.m_loc_pad, F), dtype=torch.bfloat16,
                        device="cuda")
    table[:m_loc] = table_of(m_loc, gen)[:m_loc]
    chunks = [model._th.upload(i, i + 1, torch.device("cuda"))[0][0]
              for i in range(len(model.th_plan.chunks))]
    runs["hugewiki_driver"] = sweep(smoke, cs, "hugewiki driver theta",
                                    chunks, table, model.cfg.lam)
    del model, chunks, table

    out = dict(card=card, sms=sms, chunks=runs,
               scores={k: score(v, sms) for k, v in runs.items()})
    line = json.dumps(out)
    print(line)
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, ".bench_cache", "theta_cut_sweep.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
