"""``tile_gram`` on the card against the body it replaced, in one call
(PyTorch/CUDA port, factor widths F > 256).

    python3 scripts/torch_tile_gram_readings.py --fetch REV   # needs git
    python3 scripts/torch_tile_gram_readings.py [--out FILE]  # needs a card

`--fetch REV` writes csrc/tile_gram.cu of commit REV and the headers it
includes (`git show`) into cumf_als_tpu_torch/_build/parent_tile_gram/,
a directory that .gitignore lists, and exits: run it where the
repository's history is (the card's machine may have none), then copy
the tree there with that directory in it. Without it, from the root of
the repository on a machine with a CUDA card, the script builds that
source with the port's nvcc flags into the same directory, loads it
beside the port's own ``tile_gram`` (each library keeps its kernels to
itself) and times both bodies on the same inputs, device time behind
queued work (chip_smoke.py's `queued_ms`, median of 5 after a warm-up):

- K2 and K5a (``gather_gram_out`` / ``gather_gram_aug_out``, no nnz) on
  phase 14k's synthetic X panel chunk (R = 2304, P = 576 over a
  65,537-row bf16 panel, chip_smoke.py's `panel_chunk`, seed 14) at
  f = 384 and 512, A in bf16 and in f32;
- the same on a chunk of few long rows, R = 16, P = 16384 (as routed:
  at f = 384 the cut of `cs.gram_spans`, two launches), over an
  unsigned table (`panel_chunk(..., signed=False)`, as chip_smoke.py's);
- pass 1 of K1 (``tile_gram`` with nnz, b and r2, A in f32) on a
  synthetic chunk of the most populous theta chunk's shape at F = 300
  (R = 3631, one row batch of `cs.tiled_batch_rows(384)`, P = 256) and
  of the widest one's (R = 8, P = 8192, unsigned).

Beside each: torch.bmm on the pre-gathered G (K5a: G with the values in
lane f - 1), the bound (each input read once, A and b written once, or
the Gram's operations, whichever is longer; chip_smoke.py's `bound_ms`,
`gram_ops`), and the two bodies' largest difference in A (the parent's
kernel is the same arithmetic on other blocks, so equal or within
`gram_limit`) and in b (summed in another order: within 1e-5 of
max(|b|, 1)). Prints one line of JSON with the card's name and power
limit, writes it to --out (default tile_gram_readings.json in the
ignored cumf_als_tpu_torch/_build/), and exits 1 if a difference passes
its limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PARENT_DIR = os.path.join(ROOT, "cumf_als_tpu_torch", "_build",
                          "parent_tile_gram")
SOURCES = ("tile_gram.cu", "common.cuh", "gram_mma.cuh")
# the C entry of the parent's one-block-a-tile tree: no plan, no scratch
_VP, _I = ctypes.c_void_p, ctypes.c_int
PARENT_ARGS = [_VP, _I, _VP, _VP, _I, _VP, _VP, _I, _VP, _VP,
               _I, _I, _I, _I, _VP]


def fetch(rev: str) -> None:
    os.makedirs(PARENT_DIR, exist_ok=True)
    for name in SOURCES:
        src = subprocess.run(
            ["git", "show", f"{rev}:cumf_als_tpu_torch/csrc/{name}"],
            cwd=ROOT, check=True, capture_output=True).stdout
        with open(os.path.join(PARENT_DIR, name), "wb") as out:
            out.write(src)
    print(f"wrote {', '.join(SOURCES)} of {rev} into {PARENT_DIR}")


def build_parent():
    from cumf_als_tpu_torch.ops import _build
    lib = os.path.join(PARENT_DIR, "libtile_gram.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
                    os.path.join(PARENT_DIR, "tile_gram.cu")], check=True)
    fn = ctypes.CDLL(lib).cumf_tile_gram
    fn.argtypes = PARENT_ARGS
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fetch", metavar="REV")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "cumf_als_tpu_torch", "_build", "tile_gram_readings.json"))
    args = ap.parse_args()
    if args.fetch:
        fetch(args.fetch)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_tile_gram_readings: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from cumf_als_tpu_torch.ops import cuda_solve as cs

    parent = build_parent()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def parent_gram(table, ch, out_dtype, aug, nnz=None, with_r2=False):
        r, p = ch.cols.shape
        f = table.shape[1]
        a = torch.empty((r, f, f), dtype=out_dtype, device="cuda")
        b = None if aug else torch.empty((r, f), device="cuda")
        r2 = torch.empty((r,), device="cuda") if with_r2 else None
        err = parent(table.data_ptr(), 1, ch.cols.data_ptr(),
                     ch.vals.data_ptr(), 0,
                     None if nnz is None else nnz.data_ptr(), a.data_ptr(),
                     int(out_dtype == torch.bfloat16),
                     None if b is None else b.data_ptr(),
                     None if r2 is None else r2.data_ptr(), r, p, f,
                     int(aug), stream())
        if err:
            raise RuntimeError(f"the parent's tile_gram: CUDA error {err}")
        return a, b

    def new_gram(table, ch, out_dtype, aug):
        if aug:
            return cs.gather_gram_aug_out(table, ch.cols, ch.vals,
                                          out_dtype=out_dtype), None
        return cs.gather_gram_out(table, ch.cols, ch.vals,
                                  out_dtype=out_dtype)

    def bmm_ms(table, ch, aug):
        r, p = ch.cols.shape
        f = table.shape[1]
        g = table.index_select(0, ch.cols.reshape(-1).long()).reshape(r, p, f)
        if aug:
            g = cs.augment_g(g, ch.vals)
        gt = g.transpose(1, 2)
        ms = smoke.queued_ms(lambda: torch.bmm(gt, g), reps=5)
        del g, gt
        return ms

    rows = []

    def reading(label, table, ch, out_dtype, aug, new_fn, parent_fn,
                with_b):
        r, p = ch.cols.shape
        f = table.shape[1]
        before = dict(cs.LAUNCHES)
        a_new, b_new = new_fn()
        launches = {k: v - before[k] for k, v in cs.LAUNCHES.items()
                    if v != before[k]}
        a_old, b_old = parent_fn()
        diff = (a_new.float() - a_old.float()).abs()
        lim, _ = smoke.gram_limit(a_new, a_old, p, "wgmma")
        same = torch.equal(a_new, a_old)
        within = bool((diff <= lim).all())
        b_same = b_new is None or torch.equal(b_new, b_old)
        # b is summed in another order by each body: within 1e-5 of
        # max(|b|, 1), chip_smoke.py's limit
        b_rel = 0.0 if b_new is None else (
            (b_new - b_old).abs() / b_old.abs().clamp_min(1.0)).max().item()
        err = diff.max().item()
        del a_new, a_old, b_new, b_old, diff, lim
        torch.cuda.empty_cache()
        ms_new = smoke.queued_ms(new_fn, reps=5)
        ms_old = smoke.queued_ms(parent_fn, reps=5)
        lib = bmm_ms(table, ch, aug)
        out_bytes = r * f * f * torch.tensor([], dtype=out_dtype
                                             ).element_size()
        if with_b:
            out_bytes += r * f * 4
        bms, by = smoke.bound_ms(
            smoke.nbytes(table, ch.cols, ch.vals) + out_bytes,
            smoke.gram_ops(ch, f, b=with_b), table.dtype)
        row = dict(label=label, f=f, shape=[r, p], a=str(out_dtype),
                   aug=aug, ms=ms_new, parent_ms=ms_old, library_ms=lib,
                   bound_ms=bms, bound_by=by, launches=launches,
                   max_abs_diff=err, equal_bits=same, within_limit=within,
                   b_equal_bits=b_same, b_rel_diff=b_rel)
        print(f"[{label}] f={f} R={r} P={p} A {out_dtype}: new {ms_new:.3f} "
              f"ms (launches {launches}), parent {ms_old:.3f} ms, torch.bmm "
              f"{lib:.3f} ms, bound {bms:.4f} ms ({by}); A equal bits "
              f"{same}, max|dA| {err:.3e} within gram_limit {within}, b "
              f"equal bits {b_same}, max rel db {b_rel:.3e} (limit 1e-5)",
              flush=True)
        rows.append(row)
        return within and b_rel <= 1e-5

    ok = True
    for f in (384, 512):
        for r, p in ((2304, 576), (16, 16384)):
            # the few long rows on factors as gathered at iteration 0, as
            # chip_smoke.py's (signed ones cancel in b over 16,384 slots)
            tp, ch = smoke.panel_chunk(f, r, p, seed=14, signed=r != 16)
            for aug in (False, True):
                for out_dtype in (torch.bfloat16, torch.float32):
                    name = ("K5a" if aug else "K2") + (
                        " few rows" if r == 16 else "")
                    ok &= reading(
                        name, tp, ch, out_dtype, aug,
                        lambda: new_gram(tp, ch, out_dtype, aug),
                        lambda: parent_gram(tp, ch, out_dtype, aug),
                        not aug)
            del tp, ch
            torch.cuda.empty_cache()
    # pass 1 of K1 at F = 300: one row batch of theta-populous's shape,
    # and a chunk of few long rows (theta-widest's shape)
    f = 384
    for label, r, p in (("K1 pass 1", cs.tiled_batch_rows(f), 256),
                        ("K1 pass 1 few rows", 8, 8192)):
        tp, ch = smoke.panel_chunk(f, r, p, seed=15, signed=r != 8)
        ok &= reading(
            label, tp, ch, torch.float32, False,
            lambda: cs.tile_gram(tp, ch.cols, ch.vals, ch.nnz,
                                 with_r2=True)[:2],
            lambda: parent_gram(tp, ch, torch.float32, False, nnz=ch.nnz,
                                with_r2=True),
            True)
        del tp, ch
    line = dict(card=smoke.card_line(), ok=ok, readings=rows)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as out:
        json.dump(line, out)
    print(json.dumps(line))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
