"""Where the time of K2 and K5a at f = 256 on a bf16 table goes, on the
card (PyTorch/CUDA port): the tensor-core panel Gram of
csrc/wide_gram_mma.cuh, split into its gather, its tensor-core work and
its store of A, in two trees of the port read in one process. With
--f32 the same on a float32 table: the split-bf16 body of
csrc/wide_split_mma.cuh.

    python3 scripts/torch_panel_256_readings.py [--f32] [--parent CSRC] \\
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
on the CUDA cores ("no b"), and in the split body also without the
split of the gathered floats into bf16 pieces ("no split": the pieces
are never written) and with one product of the six ("hi.hi only");
and K5a (gather_gram_aug_out.cu) as shipped.
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
  panel (`panel_chunk`; with --f32 a float32 panel of full-mantissa
  entries, `float32_table`), bf16 and f32 A;
- an out-of-core theta chunk's shape: R = 6656, P = 72, f32 A;
- a hot-segment chunk: R = 16 full rows of P = 2^18 slots over a
  2,000,000-row table (hugewiki_mini's X), f32 A.

Beside them: torch.bmm on the pre-gathered G (A in G's dtype, no gather,
no b) and the bound (the table rows the chunk names once, ids, values
and the output written once over 3.35 TB/s, or the operations of
`panel_gram_ops` of chip_smoke.py over the card's peaks). Then gather =
full - no gather, tensor cores = full - no mma, store = full - no store,
b = full - no b, split = full - no split, the five products past hi.hi
= full - hi.hi only: the parts overlap, so they need
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

# the header that holds each design's kernel
HEADERS = {"three_blocks": "wide_gram_mma.cuh", "one_block":
           "wide_gram_mma.cuh", "split": "wide_split_mma.cuh"}
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
    # the split-bf16 body of a float32 table (the one-block body's strips
    # on three bf16 pieces of each entry, 32-slot tiles)
    "split": {
        "no store": [
            ("wm::store_strip<false, OT, true>(",
             "if (false) wm::store_strip<false, OT, true>(")],
        "no mma": [
            ("mma_quarter<ROLE>(acc0, acc1, set,",
             "if (false) mma_quarter<ROLE>(acc0, acc1, set,")],
        "no gather": [
            ("got ? 16 : 0", "0")],
        "no b": [
            ("for (int j = 0; j < 16 * k_steps; j += 2)",
             "for (int j = 0; j < 0; j += 2)")],
        "no split": [
            ("      cumf::split::split2(x.x, x.y, hi.x, mid.x, lo.x);\n"
             "      cumf::split::split2(x.z, x.w, hi.y, mid.y, lo.y);\n",
             "      if (x.x != -1.f) continue;\n"
             "      hi = mid = lo = make_uint2(0u, 0u);\n")],
        "hi.hi only": [
            (f"    product<ROLE>(acc0, acc1, e0, e1, {i}, {j}, 1);", "")
            for i, j in ((0, 1), (1, 0), (0, 2), (2, 0), (1, 1))],
    },
}
VARIANTS = ("full", "no store", "no mma", "no gather", "no b", "no split",
            "hi.hi only")


def design(csrc, f32=False):
    if f32:
        return "split"
    text = open(os.path.join(csrc, HEADERS["one_block"])).read()
    return "one_block" if "panel_stream_kernel" in text else "three_blocks"


def build(trees, work, f32):
    """Copy each tree's csrc into `work` once a variant, patch, and build
    K2 (every variant) and K5a (full) there, all nvcc processes at once.
    Returns {(tree, variant, kernel): library path}."""
    from cumf_als_tpu_torch.ops import _build
    nvcc = _build._nvcc()
    procs, libs = [], {}
    for tree, csrc in trees.items():
        kind = design(csrc, f32)
        for variant in VARIANTS:
            if variant != "full" and variant not in PATCHES[kind]:
                continue    # a part this design does not have
            d = os.path.join(work, tree, variant.replace(" ", "_"))
            shutil.rmtree(d, ignore_errors=True)
            shutil.copytree(csrc, d)
            path = os.path.join(d, HEADERS[kind])
            text = open(path).read()
            # the tree's own design must take the patch; the other
            # design's kernel in the same header, where the tree keeps it
            # too (the few-row chunks), takes its own patch as well
            for name, pairs in PATCHES.items():
                if HEADERS[name] != HEADERS[kind]:
                    continue
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
    table tp: A (and K2's b)."""
    import torch
    r, p = ch.cols.shape
    a = torch.empty((r, 256, 256), dtype=a_dtype, device="cuda")
    b = torch.empty((r, 256), dtype=torch.float32, device="cuda")
    tail = (a.data_ptr(), int(a_dtype == torch.bfloat16))
    tail += (b.data_ptr(),) if name == "gather_gram_out" else ()
    err = fn(tp.data_ptr(), int(tp.dtype == torch.bfloat16),
             ch.cols.data_ptr(), ch.vals.data_ptr(),
             int(ch.vals.dtype == torch.bfloat16), *tail, r, p, 256,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return a, (b if name == "gather_gram_out" else None)


def check(tree, fns, f32):
    """K2 and K5a as shipped in `tree` against their plain versions (see
    the head of this file), on a bf16 table or, with f32, a float32 one.
    Prints what failed; returns whether all held."""
    import numpy as np
    import torch
    from types import SimpleNamespace

    import chip_smoke as smoke
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    dtype, body = (torch.float32, "split") if f32 else \
        (torch.bfloat16, "wgmma")
    cases = [("X panel chunk R=2304 P=576",) + panel_chunk(
        2304, 576, 12, f32) + (False,)]
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
                      torch.from_numpy(table).cuda().to(dtype), ch, True))
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
                                              body)
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


def panel_chunk(r, p, seed, f32):
    """chip_smoke.py's `panel_chunk` at f = 256: its bf16 panel, or with
    f32 a float32 panel of full-mantissa entries of the same shape."""
    import torch

    import chip_smoke as smoke
    tp, ch = smoke.panel_chunk(256, r, p, seed=seed)
    if f32:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tp = smoke.float32_table(gen, tp.shape[0] - 1, 256)
    return tp, ch


def chunks(f32):
    """The three chunk shapes: (label, table, ch, A dtypes)."""
    import torch
    from types import SimpleNamespace

    out = []
    tp, ch = panel_chunk(2304, 576, 12, f32)
    out.append(("X panel R=2304 P=576", tp, ch,
                (torch.bfloat16, torch.float32)))
    tp2, ch2 = panel_chunk(6656, 72, 13, f32)
    out.append(("out-of-core theta shape R=6656 P=72", tp2, ch2,
                (torch.float32,)))
    gen = torch.Generator(device="cuda").manual_seed(14)
    n, r, p = 2_000_000, 16, 1 << 18
    big = 0.2 * torch.rand((n + 1, 256), generator=gen, device="cuda")
    if not f32:
        big = big.to(torch.bfloat16)
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
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--change", default=os.path.join(
        ROOT, "cumf_als_tpu_torch", "csrc"))
    ap.add_argument("--work", default=os.path.join(
        ROOT, "_archive", "panel_256_readings"))
    ap.add_argument("--out", default=READINGS)
    args = ap.parse_args()
    import torch

    import chip_smoke as smoke
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    if not torch.cuda.is_available():
        print("torch_panel_256_readings: no CUDA device", file=sys.stderr)
        return 2
    card = smoke.card_line()
    trees = {"change": os.path.abspath(args.change)}
    if args.parent:
        trees["parent"] = os.path.abspath(args.parent)
    libs = build(trees, args.work, args.f32)
    fns = {k: entry(lib, k[2]) for k, lib in libs.items()}
    readings = {"card": card, "designs": {t: design(c, args.f32)
                                          for t, c in trees.items()}}
    right = {t: check(t, fns, args.f32) for t in trees}
    readings["checks"] = right
    trees = {t: c for t, c in trees.items() if right[t]}
    order = [t for t in ("parent", "change", "change", "parent")
             if t in trees]
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for label, tp, ch, dtypes in chunks(args.f32):
        r, p = ch.cols.shape
        g = tp.index_select(0, ch.cols.reshape(-1).long()).reshape(r, p, 256)
        gt = g.transpose(1, 2)
        bmm = smoke.queued_ms(lambda: torch.bmm(gt, g))
        del g, gt
        rows = torch.unique(ch.cols).numel()
        flops = smoke.panel_gram_ops(ch, 256, True, cs.panel_body(tp),
                                     tp.dtype)
        for a_dtype in dtypes:
            a = torch.empty((r, 256, 256), dtype=a_dtype, device="cuda")
            b = torch.empty((r, 256), dtype=torch.float32, device="cuda")
            out_b = r * 256 * 256 * a.element_size()
            bound, by = smoke.bound_ms(
                rows * 256 * tp.element_size() +
                smoke.nbytes(ch.cols, ch.vals) + out_b + r * 256 * 4, flops)
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
                            err = fn(tp.data_ptr(),
                                     int(tp.dtype == torch.bfloat16),
                                     ch.cols.data_ptr(),
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
                       if "no b" in split else "")
                    + (f", the split into pieces {split['no split']:.3f}, "
                       f"the five products past hi.hi "
                       f"{split['hi.hi only']:.3f}"
                       if "no split" in split else "") +
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
