"""Where the time of K2 and K5a at f = 256 on a bf16 table goes, on the
card (PyTorch/CUDA port): the tensor-core panel Gram of
csrc/wide_gram_mma.cuh, split into its gather, its tensor-core work and
its store of A, in two trees of the port read in one process.

    python3 scripts/torch_panel_256_readings.py [--parent CSRC] \\
        [--change CSRC] [--work DIR] [--out FILE]

Run from the root of the repository on a machine with a CUDA card. For
each tree (this one's cumf_als_tpu_torch/csrc, or the csrc directory
--change names, and, with --parent, the csrc directory of another tree,
say a `git archive` of the parent commit under _archive/) it copies the
sources into DIR (default _archive/panel_256_readings, which .gitignore
lists) and builds K2 (gather_gram_out.cu) as shipped ("full"), without
the store of A ("no store": the sums stay alive, nothing is written),
without the wgmma ("no mma": the gathered tiles are never multiplied),
without the gather ("no gather": every 16-byte copy is a zero-fill that
reads no device memory) and, in the one-block design, without b's sum
on the CUDA cores ("no b"); and K5a (gather_gram_aug_out.cu) as shipped.
The parts are taken out by text patches of the copied header, each
checked to apply; the shipped header has no such switch. First each
tree's K2 and K5a as shipped are held to their plain versions
(`gram_limit` of chip_smoke.py for A, rtol 1e-5 for b, a second launch
equal bit for bit; whether A is exactly symmetric is printed) on the X
panel chunk below and, bit for bit, on tables of small integers at P =
8, 72, 136 and 520 (the tile's edges); a tree that fails is reported
and not timed. Each variant is timed on three chunks, as device time
behind queued work (`queued_ms` of chip_smoke.py, the median of 5
launches), the trees in turn (parent, this tree, this tree, parent):

- the X panel chunk of phase 13a: R = 2304, P = 576, a 65,537-row bf16
  panel (`panel_chunk`), bf16 and f32 A;
- an out-of-core theta chunk's shape: R = 6656, P = 72, f32 A;
- a hot-segment chunk: R = 16 full rows of P = 2^18 slots over a
  2,000,000-row table (hugewiki_mini's X), f32 A.

Beside them: torch.bmm on the pre-gathered G (A in G's dtype, no gather,
no b) and the bound (the table rows the chunk names once, ids, values
and the output written once over 3.35 TB/s, or 2 nnz 256^2 over 989
TFLOP/s). Then gather = full - no gather, tensor cores = full - no mma,
store = full - no store, b = full - no b: the parts overlap, so they need
not add up to the full time, and what is left after taking one out is
what bounds the rest. Writes every reading to FILE (default
_archive/panel_256_readings/readings.json) and prints one line of JSON
with the card's name and power limit last.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

HEADER = "wide_gram_mma.cuh"
# where the readings go by default
READINGS = os.path.join(ROOT, "_archive", "panel_256_readings",
                        "readings.json")
# text patches of the panel kernel's header, by the tree's design: a
# variant applies every pair of its list, each of which must match
NOOP = ("\ntemplate <typename... A>\n"
        "__device__ __forceinline__ void cumf_reading_noop(A&&...) {}\n")
PATCHES = {
    # the three-block kernel of the first port (one 128 x 128 block of A a
    # thread block, grid (R, 1, 3))
    "three_blocks": {
        "no store": [
            ("        store2<OT>(a_row + rr * F + cc, e0, e1);\n"
             "        if (off_diag) {\n"
             "          a_row[cc * F + rr] = cumf::from_f32<OT>(e0);\n"
             "          a_row[(cc + 1) * F + rr] = cumf::from_f32<OT>(e1);\n"
             "        }\n", "")],
        "no mma": [
            ("#pragma once\n", "#pragma once\n" + NOOP),
            ("      mma::wgmma_m64n128k16(\n          acc,",
             "      cumf_reading_noop(\n          acc,")],
        "no gather": [
            ("live && x_live ? 16 : 0", "0"),
            ("live && y_live ? 16 : 0", "0")],
    },
    # the one-block panel body (every slot gathered once a row of A,
    # three warpgroups, the epilogue through shared memory)
    "one_block": {
        "no store": [
            ("      store_out<AUG, OT>(a_row,",
             "      if (false) store_out<AUG, OT>(a_row,")],
        "no mma": [
            ("      panel_mma<", "      if (false) panel_mma<")],
        "no gather": [
            ("got ? 16 : 0", "0")],
        "no b": [
            ("for (int atom = ROLE; atom < 2 * k_steps; atom += 2)",
             "for (int atom = ROLE; atom < 0; atom += 2)")],
    },
}
VARIANTS = ("full", "no store", "no mma", "no gather", "no b")


def design(csrc):
    text = open(os.path.join(csrc, HEADER)).read()
    return "one_block" if "panel_stream_kernel" in text else "three_blocks"


def build(trees, work):
    """Copy each tree's csrc into `work` once a variant, patch, and build
    K2 (every variant) and K5a (full) there, all nvcc processes at once.
    Returns {(tree, variant, kernel): library path}."""
    from cumf_als_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    procs, libs = [], {}
    for tree, csrc in trees.items():
        kind = design(csrc)
        for variant in VARIANTS:
            if variant != "full" and variant not in PATCHES[kind]:
                continue    # a part this design does not have
            d = os.path.join(work, tree, variant.replace(" ", "_"))
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            path = os.path.join(d, HEADER)
            text = open(path).read()
            # the tree's own design must take the patch; the other
            # design's kernel, where the tree keeps it too (the few-row
            # chunks), takes its own patch as well
            for name, pairs in PATCHES.items():
                pairs = pairs.get(variant, [])
                if not all(old in text for old, _ in pairs):
                    if name == kind:
                        raise AssertionError(
                            f"{tree} ({kind}), {variant}: a patch does "
                            f"not apply")
                    continue
                for old, new in pairs:
                    text = text.replace(old, new, 1 if old.startswith(
                        "#pragma once") else -1)
            open(path, "w").write(text)
            kernels = ("gather_gram_out", "gather_gram_aug_out") if \
                variant == "full" else ("gather_gram_out",)
            for name in kernels:
                lib = os.path.join(d, f"lib{name}.so")
                cmd = [nvcc, *_build.NVCC_FLAGS, "-o", lib,
                       os.path.join(d, f"{name}.cu")]
                procs.append(((tree, variant, name), lib, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
    for key, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = lib
    return libs


def entry(lib, name):
    from cumf_als_tpu_torch.ops import _build
    symbol, argtypes = _build.KERNELS[name]
    fn = getattr(ctypes.CDLL(lib, mode=ctypes.RTLD_LOCAL), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def run(fn, name, tp, ch, a_dtype):
    """One launch of `fn` (K2 or K5a's entry point) on chunk `ch` of the
    bf16 table tp: A (and K2's b)."""
    import torch
    r, p = ch.cols.shape
    a = torch.empty((r, 256, 256), dtype=a_dtype, device="cuda")
    b = torch.empty((r, 256), dtype=torch.float32, device="cuda")
    tail = (a.data_ptr(), int(a_dtype == torch.bfloat16))
    tail += (b.data_ptr(),) if name == "gather_gram_out" else ()
    err = fn(tp.data_ptr(), 1, ch.cols.data_ptr(), ch.vals.data_ptr(),
             int(ch.vals.dtype == torch.bfloat16), *tail, r, p, 256,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return a, (b if name == "gather_gram_out" else None)


def check(tree, fns):
    """K2 and K5a as shipped in `tree` against their plain versions (see
    the head of this file). Prints what failed; returns whether all
    held."""
    import numpy as np
    import torch
    from types import SimpleNamespace

    import chip_smoke as smoke
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    cases = [("X panel chunk R=2304 P=576",) + smoke.panel_chunk(
        256, 2304, 576, seed=12) + (False,)]
    for p in (8, 72, 136, 520):
        rng = np.random.RandomState(7 + p)
        n, r = 60, 5
        table = rng.randint(-4, 5, (n + 1, 256)).astype(np.float32)
        table[n] = 0
        table[:, 255] = 0
        nnz = rng.randint(1, p + 1, (r,))
        nnz[0], nnz[2] = p, 0
        mask = np.arange(p)[None, :] < nnz[:, None]
        cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
        vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2 * mask
                ).astype(np.float32)
        ch = SimpleNamespace(
            cols=torch.from_numpy(cols).cuda(),
            vals=torch.from_numpy(vals).cuda(),
            nnz=torch.from_numpy(nnz.astype(np.int32)).cuda())
        cases.append((f"integer table P={p}",
                      torch.from_numpy(table).cuda().to(torch.bfloat16), ch,
                      True))
    ok, asym = True, False
    for label, tp, ch, exact in cases:
        for name in ("gather_gram_out", "gather_gram_aug_out"):
            plain = cs.gather_gram_out_plain if name == "gather_gram_out" \
                else cs.gather_gram_aug_out_plain
            for a_dtype in (torch.float32, torch.bfloat16):
                a, b = run(fns[(tree, "full", name)], name, tp, ch, a_dtype)
                a2, b2 = run(fns[(tree, "full", name)], name, tp, ch,
                             a_dtype)
                got = plain(tp, ch.cols, ch.vals, out_dtype=a_dtype)
                pa, pb = got if b is not None else (got, None)
                if exact:
                    good = torch.equal(a, pa) and (
                        b is None or torch.equal(b, pb))
                else:
                    lim, _ = smoke.gram_limit(a, pa, ch.cols.shape[1],
                                              "wgmma")
                    good = bool(((a.float() - pa.float()).abs() <= lim)
                                .all())
                    if b is not None:
                        good &= bool(((b - pb).abs() <=
                                      1e-5 * pb.abs().clamp_min(1.0))
                                     .all())
                sym = torch.equal(a, a.transpose(1, 2))
                same = torch.equal(a, a2) and (b is None or
                                               torch.equal(b, b2))
                empty = ch.nnz == 0
                zero = bool((a[empty] == 0).all())
                if not sym:
                    smoke.log(f"[panel 256 readings] {tree} {name} {label} "
                              f"A {a_dtype}: not exactly symmetric")
                    asym = True
                if not (good and same and zero):
                    ok = False
                    d = (a.float() - pa.float()).abs()
                    smoke.log(f"[panel 256 readings] {tree} {name} {label} "
                              f"A {a_dtype}: against plain {good} (max|dA| "
                              f"{d.max().item():.3e} at "
                              f"{np.unravel_index(int(d.argmax()), d.shape)}"
                              f"), symmetric {sym}, repeat {same}, empty "
                              f"rows 0 {zero}")
                del a, b, a2, b2, pa, pb
    torch.cuda.synchronize()
    smoke.log(f"[panel 256 readings] {tree}: K2 and K5a against their plain "
              f"versions (X panel chunk to gram_limit, integer tables bit "
              f"for bit, repeat): {'OK' if ok else 'FAIL'}; exactly "
              f"symmetric: {not asym}")
    return ok


def chunks():
    """The three chunk shapes: (label, table, ch, A dtypes)."""
    import torch
    from types import SimpleNamespace

    import chip_smoke as smoke
    out = []
    tp, ch = smoke.panel_chunk(256, 2304, 576, seed=12)
    out.append(("X panel R=2304 P=576", tp, ch,
                (torch.bfloat16, torch.float32)))
    tp2, ch2 = smoke.panel_chunk(256, 6656, 72, seed=13)
    out.append(("out-of-core theta shape R=6656 P=72", tp2, ch2,
                (torch.float32,)))
    gen = torch.Generator(device="cuda").manual_seed(14)
    n, r, p = 2_000_000, 16, 1 << 18
    big = (0.2 * torch.rand((n + 1, 256), generator=gen, device="cuda")
           ).to(torch.bfloat16)
    big[n] = 0
    cols = torch.randint(0, n, (r, p), generator=gen, device="cuda",
                         dtype=torch.int32)
    vals = (torch.randint(2, 11, (r, p), generator=gen, device="cuda") / 2.0
            ).float()
    hot = SimpleNamespace(cols=cols, vals=vals,
                          nnz=torch.full((r,), p, device="cuda",
                                         dtype=torch.int32), panel=0)
    out.append(("hot segment R=16 P=2^18", big, hot, (torch.float32,)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None)
    ap.add_argument("--change", default=os.path.join(
        ROOT, "cumf_als_tpu_torch", "csrc"))
    ap.add_argument("--work", default=os.path.join(
        ROOT, "_archive", "panel_256_readings"))
    ap.add_argument("--out", default=READINGS)
    args = ap.parse_args()
    import torch

    import chip_smoke as smoke
    if not torch.cuda.is_available():
        print("torch_panel_256_readings: no CUDA device", file=sys.stderr)
        return 2
    card = smoke.card_line()
    trees = {"change": os.path.abspath(args.change)}
    if args.parent:
        trees["parent"] = os.path.abspath(args.parent)
    libs = build(trees, args.work)
    fns = {k: entry(lib, k[2]) for k, lib in libs.items()}
    readings = {"card": card, "designs": {t: design(c)
                                          for t, c in trees.items()}}
    right = {t: check(t, fns) for t in trees}
    readings["checks"] = right
    trees = {t: c for t, c in trees.items() if right[t]}
    order = [t for t in ("parent", "change", "change", "parent")
             if t in trees]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for label, tp, ch, dtypes in chunks():
        r, p = ch.cols.shape
        g = tp.index_select(0, ch.cols.reshape(-1).long()).reshape(r, p, 256)
        gt = g.transpose(1, 2)
        bmm = smoke.queued_ms(lambda: torch.bmm(gt, g))
        del g, gt
        rows = torch.unique(ch.cols).numel()
        flops = 2.0 * float(ch.nnz.sum().item()) * 256 * 256
        for a_dtype in dtypes:
            a = torch.empty((r, 256, 256), dtype=a_dtype, device="cuda")
            b = torch.empty((r, 256), dtype=torch.float32, device="cuda")
            out_b = r * 256 * 256 * a.element_size()
            bound, by = smoke.bound_ms(
                rows * 512 + smoke.nbytes(ch.cols, ch.vals) + out_b +
                r * 256 * 4, flops, torch.bfloat16)
            got = {}
            for tree in order:
                for variant in VARIANTS:
                    for name in ("gather_gram_out", "gather_gram_aug_out"):
                        key = (tree, variant, name)
                        if key not in fns:
                            continue
                        fn = fns[key]
                        tail = (a.data_ptr(), int(a_dtype == torch.bfloat16))
                        tail += (b.data_ptr(),) if name == \
                            "gather_gram_out" else ()

                        def call(fn=fn, tail=tail, name=name):
                            err = fn(tp.data_ptr(), 1, ch.cols.data_ptr(),
                                     ch.vals.data_ptr(), 0, *tail, r, p,
                                     256, stream())
                            if err:
                                raise RuntimeError(f"{name}: CUDA error "
                                                   f"{err}")
                        ms = smoke.queued_ms(call)
                        got.setdefault(f"{tree} {name} {variant}",
                                       []).append(ms)
            med = {k: statistics.median(v) for k, v in got.items()}
            key = f"{label}, A {str(a_dtype).split('.')[-1]}"
            readings[key] = dict(ms=med, torch_bmm_ms=bmm, bound_ms=bound,
                                 bound_by=by)
            for tree in trees:
                k2 = f"{tree} gather_gram_out"
                full = med[f"{k2} full"]
                split = {v: full - med[f"{k2} {v}"] for v in VARIANTS[1:]
                         if f"{k2} {v}" in med}
                readings[key][f"{tree} split"] = split
                k5a = med.get(f"{tree} gather_gram_aug_out full")
                smoke.log(
                    f"[panel 256 readings] {key}, {tree} "
                    f"({readings['designs'][tree]}): K2 {full:.3f} ms, "
                    f"without the store {med[f'{k2} no store']:.3f}, "
                    f"without the mma {med[f'{k2} no mma']:.3f}, without "
                    f"the gather {med[f'{k2} no gather']:.3f} (so store "
                    f"{split['no store']:.3f}, tensor cores "
                    f"{split['no mma']:.3f}, gather {split['no gather']:.3f}"
                    + (f", b on the CUDA cores {split['no b']:.3f}"
                       if "no b" in split else "") +
                    f" ms); K5a {k5a:.3f} ms; torch.bmm {bmm:.3f} ms, bound "
                    f"{bound:.4f} ms ({by}); each the median of "
                    f"{len(got[f'{k2} full'])} readings")
            del a, b
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(readings, fh, indent=1)
    print(card)
    ok = all(right.values())
    print(json.dumps({"ok": ok, "checks": right,
                      "out": os.path.relpath(args.out, ROOT)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
