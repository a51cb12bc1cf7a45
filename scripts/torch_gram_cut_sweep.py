"""Sweep of the constants of K2's and K5a's cut on chunks of few rows
(PyTorch/CUDA port).

    python3 scripts/torch_gram_cut_sweep.py [OUT]

Run from the root of the repository on a machine with a CUDA card. It
builds the Netflix data (scale 1.0) and the F=100 plans as chip_smoke.py
does, then times K2 (`gather_gram_out`, bf16 A) over every X panel chunk
with fewer rows than the blocks of its body that fit the card
(`cs.gram_blocks_per_sm`), on a random bf16 table of the panel's rows at
f = 128 and at f = 256, uncut (spans=1) and with the spans that
`cs.gram_spans` gives for each `target` and `min_tiles` of a grid,
forced through the wrapper's `spans`; the same for K5a (f32 A) at the
default constants. At f = 256 a chunk of 3 R <= SMs runs uncut on the
three-block body; it also runs on the panel body there (its rows padded
with rows of pad slots only past SMs / 3, which adds no time: each row
has a block of its own). Then a synthetic hot-segment chunk (R = 16,
P = 2^18, a 2,000,001-row table, f32 A) at every S, and pass 1 alone at
the rule's S. Device time behind queued work (chip_smoke.queued_each
and queued_ms). Prints one line of JSON with the card's name and power
limit and writes it to OUT (default .bench_cache/gram_cut_sweep.json).
"""

from __future__ import annotations

import json
import os
import sys
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TARGETS = (1, 2)
MIN_TILES = (2, 4, 8)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_gram_cut_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from cumf_als_tpu_torch import bench
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    from cumf_als_tpu_torch.utils.io import transpose_csr

    card = smoke.card_line()
    train, test, _ = smoke.workload_data(bench, "netflix",
                                         smoke.RECORDED_NETFLIX)
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=1, backend="pallas",
                          solver="cg", factor_dtype="bf16",
                          gram_dtype="bf16", verbose=False,
                          debug_timing=False)
    al = ALS(cfg, train, transpose_csr(train), test, device="cuda")
    chunks = al.plan_x[1]
    sms = smoke.sm_count()
    gen = torch.Generator(device="cuda").manual_seed(9)
    out = dict(card=card, sms=sms, widths={})

    def total(table, few, spans, aug=False, a_dtype=torch.bfloat16):
        fn = cs.gather_gram_aug_out if aug else cs.gather_gram_out
        times = smoke.queued_each([
            lambda ch=ch, s=s: fn(table, ch.cols, ch.vals, out_dtype=a_dtype,
                                  spans=s) for ch, s in zip(few, spans)])
        return times

    for f in (128, 256):
        per_sm = cs.gram_blocks_per_sm(f)
        table = smoke.synthetic_table(gen, 65536, f)
        few = [c for c in chunks if c.cols.shape[0] < per_sm * sms]
        shapes = [tuple(c.cols.shape) for c in few]
        res = dict(chunks=len(few), settings={})
        uncut = total(table, few, [1] * len(few))
        res["uncut_ms"] = sum(uncut)
        default = None
        for t in TARGETS if per_sm > 1 else (1,):
            for m in MIN_TILES:
                spans = [cs.gram_spans(r, p, f, sms, min_tiles=m, target=t)
                         for r, p in shapes]
                times = total(table, few, spans)
                key = f"target {t} min_tiles {m}"
                res["settings"][key] = dict(
                    ms=sum(times), cut=sum(s > 1 for s in spans),
                    slower=[(r, p, s, round(a, 4), round(b, 4))
                            for (r, p), s, a, b in zip(shapes, spans, times,
                                                       uncut)
                            if s > 1 and a > b])
                if (t, m) == (min(cs.GRAM_CUT_TARGET, per_sm),
                              cs.GRAM_CUT_MIN_TILES):
                    default = (spans, times)
        spans, times = default
        res["default_longest"] = sorted(
            [(round(b, 4), round(a, 4), r, p, s) for (r, p), s, a, b in
             zip(shapes, spans, times, uncut)], reverse=True)[:24]
        aug_uncut = total(table, few, [1] * len(few), True, torch.float32)
        aug_cut = total(table, few, [None] * len(few), True, torch.float32)
        res["k5a_uncut_ms"], res["k5a_routed_ms"] = sum(aug_uncut), \
            sum(aug_cut)
        if f == 256:
            # the panel body on the chunks the three-block body takes
            k = sms // 3 + 1
            three = [(c, i) for i, c in enumerate(few)
                     if 3 * c.cols.shape[0] <= sms]
            padded = []
            for c, _ in three:
                r, p = c.cols.shape
                cols = torch.full((k, p), 65536, dtype=torch.int32,
                                  device="cuda")
                vals = torch.zeros((k, p), device="cuda")
                cols[:r], vals[:r] = c.cols, c.vals
                padded.append(SimpleNamespace(cols=cols, vals=vals))
            body = total(table, padded, [1] * len(padded))
            res["three_block_chunks"] = [
                (tuple(c.cols.shape), round(uncut[i], 4), round(b, 4),
                 round(times[i], 4), spans[i])
                for (c, i), b in zip(three, body)]
        out["widths"][f] = res
        del table
        torch.cuda.empty_cache()
        print(json.dumps({f: res}), flush=True)

    # the hot-segment shape
    for f in (128, 256):
        big = smoke.synthetic_table(gen, 2_000_000, f)
        r, p = 16, 1 << 18
        ch = smoke.synthetic_chunk(gen, r, p, 2_000_000)
        hot = {}
        for s in (1, 2, 4, 8, 16, 32):
            hot[s] = smoke.queued_ms(lambda s=s: cs.gather_gram_out(
                big, ch.cols, ch.vals, out_dtype=torch.float32, spans=s))
        s = cs.gram_spans(r, p, f, sms)
        view = (ch.cols.view(r * s, p // s), ch.vals.view(r * s, p // s))
        hot["pass 1 alone at the rule's S"] = smoke.queued_ms(
            lambda: cs.gather_gram_out(big, *view, out_dtype=torch.float32,
                                       spans=1))
        hot["rule S"] = s
        if f == 256:
            k = sms // 3 + 1
            cols = torch.full((k, p), 2_000_000, dtype=torch.int32,
                              device="cuda")
            vals = torch.zeros((k, p), device="cuda")
            cols[:r], vals[:r] = ch.cols, ch.vals
            hot["panel body uncut"] = smoke.queued_ms(
                lambda: cs.gather_gram_out(big, cols, vals,
                                           out_dtype=torch.float32, spans=1))
            del cols, vals
        out[f"hot_{f}"] = hot
        print(json.dumps({f"hot_{f}": hot}), flush=True)
        del big, ch
        torch.cuda.empty_cache()

    line = json.dumps(out)
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, ".bench_cache", "gram_cut_sweep.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
