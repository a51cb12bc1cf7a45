"""K2 and K5a on a float32 table at f = 128 or, with --f256, at f = 256
on the card: the split-bf16 body against the FMA body it replaced, in
one call (PyTorch/CUDA port).

    python3 scripts/torch_f32_gram_readings.py --fetch REV   # needs git
    python3 scripts/torch_f32_gram_readings.py [--f256] [--out FILE]

`--fetch REV` writes csrc/gather_gram_out.cu, gather_gram_aug_out.cu,
gather_gram_cg.cu and gather_gram_cg_aug.cu of commit REV and every
header of its csrc/ (`git show`) into
cumf_als_tpu_torch/_build/parent_f32_gram/, a directory that .gitignore
lists, and exits: run it where the repository's history is (the card's
machine may have none), then copy the tree there with that directory in
it. Without it, from the root of the repository on a machine with a
CUDA card, the script builds those sources with the port's nvcc flags
into the same directory, loads them beside the port's own kernels (each
library keeps its kernels to itself) and times both bodies on the same
inputs, device time behind queued work (chip_smoke.py's `queued_ms`,
median of 5 after a warm-up), in turns (new, parent, new, parent; each
body's time is the lower of its two turns' medians, both printed):

- K2 (``gather_gram_out``) and K5a (``gather_gram_aug_out``) with an f32
  and a bf16 A, on the chunks that chip_smoke.py's phase 2a holds on a
  full-mantissa float32 table: the Netflix X phase's most populous chunk
  (R = 2304, P = 576), its widest (R = 240, P = 4096) and its fewest-row
  one among those K2's cut takes (R = 8, P = 3840: the new body cuts it,
  `cs.gram_spans`; also timed uncut, spans=1), from the bench's Netflix
  data at scale 1.0 (generated into its cache on first use, ~45 s, and
  held to its recorded counts and CRC-32s) and the plans of `ALS`, each
  on its panel of the float32 initial factors (`init_factors`, seed 0:
  full 24-bit mantissas) with the zero row after it.

Then the shared stream (a guard): `gram_mma.cuh`'s `Feed`, the gather's
bookkeeping that the split body shares with the bf16 body's
`gram_stream`, now drives K1, K2, K5a and K6 on a bf16 table too. So
the script also times those four, new against the parent, on a bf16
table: K2 and K5a (f32 A) on the most populous X chunk's bf16 panel of
the initial factors, K1 and K6 on the θ phase's most populous chunk (R
= 16384, P = 256) over a bf16 stand-in X (0.2 U(0, 1), seed 1, as
chip_smoke.py's phase 2a), each warm-started as there
(`chunk_x0`), and requires both to give the same bits.

Beside each: torch.bmm on the pre-gathered G (K5a: G with the values in
lane 127; TF32 off, so a float32 product on the CUDA cores), and the
bound (each input read once, A and b written once, or the operations
of the f32-accurate Gram at the card's fastest rate for it, six bf16
products of the triangle on the tensor cores and b at the float32 rate,
whichever is longer; chip_smoke.py's `bound_ms`, `panel_gram_ops`).
Each body is held to the plain version within
its `gram_limit` ("split", "fma"), b within 1e-5 of max(|b|, 1), and the
two bodies' largest difference is printed. Prints one line of JSON with
the card's name and power limit, writes it to --out (default
f32_gram_readings.json in the ignored cumf_als_tpu_torch/_build/), and
exits 1 if a body passes its limit.

With --f256 (needs no data set: every chunk is made from a seed, each
over a float32 table of entries 0.2 U(0, 1) with full mantissas, a
factor as the X phase gathers it at iteration 0, its zero row and lane
255 zero) the same comparison at f = 256, where the parent runs the FMA
body of wide.cuh (`panel_gram`, one block a row, never cut) and the new
one csrc/wide_split_mma.cuh: K2 and K5a with an f32 and a bf16 A on the
shape of chip_smoke.py's phase 13a (R = 2304, P = 576, chip_smoke.py's
`panel_chunk`, a 65,537-row panel), the out-of-core theta chunk's shape
(R = 6656, P = 72), the fewest-row X panel shape (R = 16, P = 4096: the
new body cuts it) and the hot-segment shape (R = 16, P = 2^18 over a
2,000,001-row table, K2 with an f32 A alone, as the hot segments run),
the cut ones also timed uncut; beside each torch.bmm on the pre-gathered
G and the restated bound (the f32-accurate Gram as six bf16 products of
the triangle on the tensor cores, `panel_gram_ops` "split"; the table's
bytes the rows the chunk names). Then the guard of the bf16 paths: K2
and K5a on a bf16 table at f = 256 (the panel body) and at f = 128, and
K1 and K6 at f = 128 (R = 16384, P = 256), new against the parent in
turns, the same bits required (that code did not change).
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
                          "parent_f32_gram")
KERNELS = ("gather_gram_out", "gather_gram_aug_out", "gather_gram_cg",
           "gather_gram_cg_aug")


def fetch(rev: str) -> None:
    os.makedirs(PARENT_DIR, exist_ok=True)
    listed = subprocess.run(
        ["git", "ls-tree", "--name-only", rev, "cumf_als_tpu_torch/csrc/"],
        cwd=ROOT, check=True, capture_output=True, text=True).stdout.split()
    headers = tuple(os.path.basename(p) for p in listed if p.endswith(".cuh"))
    sources = tuple(f"{k}.cu" for k in KERNELS) + headers
    for name in sources:
        src = subprocess.run(
            ["git", "show", f"{rev}:cumf_als_tpu_torch/csrc/{name}"],
            cwd=ROOT, check=True, capture_output=True).stdout
        with open(os.path.join(PARENT_DIR, name), "wb") as out:
            out.write(src)
    print(f"wrote {', '.join(sources)} of {rev} into {PARENT_DIR}")


def build_parent():
    """The parent's two entry points, built in parallel; the C interface
    is the port's (`_build.KERNELS`)."""
    from cumf_als_tpu_torch.ops import _build
    procs = []
    for name in KERNELS:
        lib = os.path.join(PARENT_DIR, f"lib{name}.so")
        procs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib,
             os.path.join(PARENT_DIR, f"{name}.cu")])))
    fns = {}
    for name, lib, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for the parent's {name}")
        symbol, argtypes = _build.KERNELS[name]
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def netflix_chunks(smoke):
    """The three X chunks of the Netflix plans that chip_smoke.py's phase
    2a picks (its `x_chunks_and_panels`), each with its panel of the
    float32 initial factors and the zero row: [(label, table, chunk)];
    then the θ phase's most populous chunk with its bf16 table (a stand-in
    X and the zero row), its warm start and λ."""
    import torch
    from cumf_als_tpu_torch import bench
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    from cumf_als_tpu_torch.utils.io import transpose_csr
    train, test, _ = smoke.workload_data(bench, "netflix",
                                         smoke.RECORDED_NETFLIX)
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, backend="pallas", solver="cg",
                          factor_dtype="bf16", gram_dtype="bf16")
    al = ALS(cfg, train, transpose_csr(train), test, device="cuda")
    plan, chunks, _ = al.plan_x
    s = plan.panel_size
    _, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    th32 = al._pad_f(th0)
    th32 = torch.nn.functional.pad(
        th32, (0, 0, 0, plan.n_panels * s - th32.shape[0]))
    sms = smoke.sm_count()
    cut = [c for c in chunks
           if cs.gram_spans(*c.cols.shape, cfg.f_pad, sms) > 1]
    picks = (("most populous",
              max(chunks, key=lambda c: c.rows.shape[0] * c.width)),
             ("widest", max(chunks, key=lambda c: c.width)),
             ("fewest rows",
              min(cut, key=lambda c: (c.rows.shape[0], -c.width))))
    x_picks = [(label, torch.cat([th32[ch.panel * s:(ch.panel + 1) * s],
                                  th32.new_zeros((1, cfg.f_pad))]), ch)
               for label, ch in picks]
    gen = torch.Generator(device="cuda").manual_seed(1)
    x_t = al._pad_f(0.2 * torch.rand((cfg.m, cfg.f), generator=gen,
                                     device="cuda").cpu().numpy())
    x_table = torch.cat([x_t, x_t.new_zeros((1, cfg.f_pad))]).to(
        torch.bfloat16)
    th = max(al.plan_theta[1], key=lambda c: c.rows.shape[0] * c.width)
    theta = (x_table, th, smoke.chunk_x0(th, al._pad_f(th0)), cfg.lam)
    return x_picks, theta


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fetch", metavar="REV")
    ap.add_argument("--f256", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        ROOT, "cumf_als_tpu_torch", "_build", "f32_gram_readings.json"))
    args = ap.parse_args()
    if args.fetch:
        fetch(args.fetch)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_f32_gram_readings: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.f256:
        return main_f256(args.out)
    import chip_smoke as smoke
    from cumf_als_tpu_torch.ops import cuda_solve as cs

    parent = build_parent()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def parent_gram(table, ch, out_dtype, aug):
        r, p = ch.cols.shape
        a = torch.empty((r, 128, 128), dtype=out_dtype, device="cuda")
        b = None if aug else torch.empty((r, 128), device="cuda")
        head = (table.data_ptr(), int(table.dtype == torch.bfloat16),
                ch.cols.data_ptr(), ch.vals.data_ptr(),
                int(ch.vals.dtype == torch.bfloat16), a.data_ptr(),
                int(out_dtype == torch.bfloat16))
        tail = (r, p, 128, stream())
        err = parent[KERNELS[aug]](*head, *tail) if aug else \
            parent[KERNELS[0]](*head, b.data_ptr(), *tail)
        if err:
            raise RuntimeError(f"the parent's {KERNELS[aug]}: CUDA error "
                               f"{err}")
        return a, b

    def new_gram(table, ch, out_dtype, aug, spans=None):
        if aug:
            return cs.gather_gram_aug_out(table, ch.cols, ch.vals,
                                          out_dtype=out_dtype,
                                          spans=spans), None
        return cs.gather_gram_out(table, ch.cols, ch.vals,
                                  out_dtype=out_dtype, spans=spans)

    def plain_gram(table, ch, out_dtype, aug):
        if aug:
            return cs.gather_gram_aug_out_plain(
                table, ch.cols, ch.vals, out_dtype=out_dtype), None
        return cs.gather_gram_out_plain(table, ch.cols, ch.vals,
                                        out_dtype=out_dtype)

    def bmm_ms(table, ch, aug):
        r, p = ch.cols.shape
        g = table.index_select(0, ch.cols.reshape(-1).long()).reshape(
            r, p, 128)
        if aug:
            g = cs.augment_g(g, ch.vals)
        gt = g.transpose(1, 2)
        ms = smoke.queued_ms(lambda: torch.bmm(gt, g), reps=5)
        del g, gt
        return ms

    def held(a, b, pa, pb, p, body):
        diff = (a.float() - pa.float()).abs()
        lim, _ = smoke.gram_limit(a, pa, p, body)
        within = bool((diff <= lim).all())
        b_rel = 0.0 if b is None else (
            (b - pb).abs() / pb.abs().clamp_min(1.0)).max().item()
        return within and b_rel <= 1e-5, diff.max().item(), b_rel

    def parent_k1(table, ch, x0, lam, aug):
        r, p = ch.cols.shape
        x = torch.empty((r, 128), device="cuda")
        se = torch.empty((r, 1), device="cuda")
        name = KERNELS[2 + aug]
        err = parent[name](
            table.data_ptr(), int(table.dtype == torch.bfloat16),
            ch.cols.data_ptr(), ch.vals.data_ptr(),
            int(ch.vals.dtype == torch.bfloat16), ch.nnz.data_ptr(),
            x0.data_ptr(), x.data_ptr(), se.data_ptr(), r, p, 128,
            float(lam), 6, 1e-4, None, 0, stream())
        if err:
            raise RuntimeError(f"the parent's {name}: CUDA error {err}")
        return x, se

    def same(new, old):
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(new, old) if a is not None)

    rows, ok = [], True
    x_picks, (x_table, th, x0, lam) = netflix_chunks(smoke)
    shared = []  # the guard of the shared stream: (label, new, parent)
    tp16, ch16 = x_picks[0][1].to(torch.bfloat16), x_picks[0][2]
    for aug in (False, True):
        shared.append((f"{'K5a' if aug else 'K2'} bf16 table, X most "
                       f"populous, f32 A",
                       lambda aug=aug: new_gram(tp16, ch16, torch.float32,
                                                aug),
                       lambda aug=aug: parent_gram(tp16, ch16,
                                                   torch.float32, aug)))
        shared.append((f"{'K6' if aug else 'K1'} bf16 table, theta most "
                       f"populous",
                       lambda aug=aug: cs.gather_gram_cg(
                           x_table, th.cols, th.vals, th.nnz, x0, lam,
                           aug=aug),
                       lambda aug=aug: parent_k1(x_table, th, x0, lam, aug)))
    for label, new_fn, old_fn in shared:
        bits = same(new_fn(), old_fn())
        turns = [smoke.queued_ms(fn, reps=5)
                 for fn in (new_fn, old_fn) * 2]
        ms_new, ms_old = min(turns[0::2]), min(turns[1::2])
        print(f"[shared stream] {label}: new {ms_new:.3f} ms (turns "
              f"{[round(t, 3) for t in turns[0::2]]}), parent "
              f"{ms_old:.3f} ms (turns {[round(t, 3) for t in turns[1::2]]})"
              f"; the same bits: {bits}", flush=True)
        rows.append(dict(label=label, ms=ms_new, parent_ms=ms_old,
                         turns_ms=turns, same_bits=bits))
        ok &= bits
    for label, tp, ch in x_picks:
        r, p = ch.cols.shape
        spans = cs.gram_spans(r, p, 128, smoke.sm_count(), torch.float32)
        for aug in (False, True):
            for out_dtype in (torch.float32, torch.bfloat16):
                name = "K5a" if aug else "K2"
                before = dict(cs.LAUNCHES)
                a_new, b_new = new_gram(tp, ch, out_dtype, aug)
                launches = {k: v - before[k] for k, v in cs.LAUNCHES.items()
                            if v != before[k]}
                a_old, b_old = parent_gram(tp, ch, out_dtype, aug)
                pa, pb = plain_gram(tp, ch, out_dtype, aug)
                new_ok, new_err, new_db = held(a_new, b_new, pa, pb, p,
                                               "split")
                old_ok, old_err, old_db = held(a_old, b_old, pa, pb, p,
                                               "fma")
                between = (a_new.float() - a_old.float()).abs().max().item()
                zero = bool((a_new[ch.nnz == 0] == 0).all())
                del a_new, a_old, b_new, b_old, pa, pb
                torch.cuda.empty_cache()
                turns = [smoke.queued_ms(fn, reps=5) for fn in (
                    lambda: new_gram(tp, ch, out_dtype, aug),
                    lambda: parent_gram(tp, ch, out_dtype, aug)) * 2]
                ms_new, ms_old = min(turns[0::2]), min(turns[1::2])
                uncut = smoke.queued_ms(lambda: new_gram(
                    tp, ch, out_dtype, aug, spans=1), reps=5) \
                    if spans > 1 else None
                lib = bmm_ms(tp, ch, aug)
                out_bytes = r * 128 * 128 * torch.tensor(
                    [], dtype=out_dtype).element_size()
                if not aug:
                    out_bytes += r * 128 * 4
                bms, by = smoke.bound_ms(
                    smoke.nbytes(tp, ch.cols, ch.vals) + out_bytes,
                    smoke.panel_gram_ops(ch, 128, not aug, "split",
                                         torch.float32))
                row = dict(label=label, kernel=name, shape=[r, p],
                           a=str(out_dtype), spans=spans, ms=ms_new,
                           parent_ms=ms_old, turns_ms=turns,
                           uncut_ms=uncut, library_ms=lib, bound_ms=bms,
                           bound_by=by, launches=launches,
                           max_abs_err=new_err, parent_max_abs_err=old_err,
                           max_abs_diff_between=between, b_rel_err=new_db,
                           parent_b_rel_err=old_db, within_limits=new_ok,
                           parent_within_limits=old_ok,
                           pad_rows_zero=zero)
                print(f"[{name} {label}] R={r} P={p} A {out_dtype}, S={spans}"
                      f": split {ms_new:.3f} ms (turns "
                      f"{[round(t, 3) for t in turns[0::2]]}; uncut "
                      f"{'-' if uncut is None else f'{uncut:.3f}'}; "
                      f"launches {launches}), parent FMA {ms_old:.3f} ms "
                      f"(turns {[round(t, 3) for t in turns[1::2]]}), "
                      f"torch.bmm {lib:.3f} ms, bound {bms:.4f} ms ({by}); "
                      f"max|dA| to plain {new_err:.3e} (split limit "
                      f"{new_ok}) / parent {old_err:.3e} (fma limit "
                      f"{old_ok}), between the bodies {between:.3e}, max "
                      f"rel db {new_db:.3e} / {old_db:.3e} (limit 1e-5), "
                      f"rows of pad slots only 0: {zero}", flush=True)
                rows.append(row)
                ok &= new_ok and old_ok and zero
        del tp, ch
        torch.cuda.empty_cache()
    line = dict(card=smoke.card_line(), ok=ok, readings=rows)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as out:
        json.dump(line, out)
    print(json.dumps(line))
    return 0 if ok else 1


def main_f256(out_path) -> int:
    """--f256: the split body at f = 256 against the parent's FMA body,
    then the bf16 guard (the module's docstring)."""
    import torch
    import chip_smoke as smoke
    from cumf_als_tpu_torch.ops import cuda_solve as cs

    parent = build_parent()
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def run(fn, args, f, out_dtype, aug):
        """One launch of a C entry point (the parent's) on chunk args."""
        table, ch = args
        r, p = ch.cols.shape
        a = torch.empty((r, f, f), dtype=out_dtype, device="cuda")
        b = None if aug else torch.empty((r, f), device="cuda")
        head = (table.data_ptr(), int(table.dtype == torch.bfloat16),
                ch.cols.data_ptr(), ch.vals.data_ptr(),
                int(ch.vals.dtype == torch.bfloat16), a.data_ptr(),
                int(out_dtype == torch.bfloat16))
        tail = (r, p, f, stream())
        err = fn(*head, *tail) if aug else fn(*head, b.data_ptr(), *tail)
        if err:
            raise RuntimeError(f"the parent's Gram: CUDA error {err}")
        return a, b

    def parent_gram(table, ch, out_dtype, aug):
        return run(parent[KERNELS[aug]], (table, ch), table.shape[1],
                   out_dtype, aug)

    def new_gram(table, ch, out_dtype, aug, spans=None):
        if aug:
            return cs.gather_gram_aug_out(table, ch.cols, ch.vals,
                                          out_dtype=out_dtype,
                                          spans=spans), None
        return cs.gather_gram_out(table, ch.cols, ch.vals,
                                  out_dtype=out_dtype, spans=spans)

    def plain_gram(table, ch, out_dtype, aug):
        if aug:
            return cs.gather_gram_aug_out_plain(
                table, ch.cols, ch.vals, out_dtype=out_dtype), None
        return cs.gather_gram_out_plain(table, ch.cols, ch.vals,
                                        out_dtype=out_dtype)

    def held(a, b, pa, pb, p, body):
        diff = (a.float() - pa.float()).abs()
        lim, _ = smoke.gram_limit(a, pa, p, body)
        within = bool((diff <= lim).all())
        b_rel = 0.0 if b is None else (
            (b - pb).abs() / pb.abs().clamp_min(1.0)).max().item()
        return within and b_rel <= 1e-5, diff.max().item(), b_rel

    def turns_of(fns):
        turns = [smoke.queued_ms(fn, reps=5) for fn in fns * 2]
        return turns, min(turns[0::2]), min(turns[1::2])

    f, rows, ok = 256, [], True
    gen = torch.Generator(device="cuda").manual_seed(21)
    panel = smoke.float32_table(
        torch.Generator(device="cuda").manual_seed(22), 65536, f)
    big = smoke.float32_table(
        torch.Generator(device="cuda").manual_seed(23), 2_000_000, f)
    _, ch_13a = smoke.panel_chunk(f, 2304, 576, seed=12)
    shapes = (("13a X panel chunk", panel, ch_13a),
              ("out-of-core theta shape", panel,
               smoke.synthetic_chunk(gen, 6656, 72, 65536)),
              ("fewest-row X panel shape", panel,
               smoke.synthetic_chunk(gen, 16, 4096, 65536)),
              ("hot-segment shape", big,
               smoke.synthetic_chunk(gen, 16, 1 << 18, 2_000_000)))
    for label, tp, ch in shapes:
        r, p = ch.cols.shape
        hot = p == 1 << 18
        spans = cs.gram_spans(r, p, f, smoke.sm_count(), torch.float32)
        table_rows = smoke.live_rows(ch) if hot else tp.shape[0]
        for aug in (False, True):
            for out_dtype in (torch.float32, torch.bfloat16):
                if hot and (aug or out_dtype == torch.bfloat16):
                    continue   # the hot segments run K2 with an f32 A
                name = "K5a" if aug else "K2"
                before = dict(cs.LAUNCHES)
                a_new, b_new = new_gram(tp, ch, out_dtype, aug)
                launches = {k: v - before[k] for k, v in cs.LAUNCHES.items()
                            if v != before[k]}
                a_old, b_old = parent_gram(tp, ch, out_dtype, aug)
                pa, pb = plain_gram(tp, ch, out_dtype, aug)
                new_ok, new_err, new_db = held(a_new, b_new, pa, pb, p,
                                               "split")
                old_ok, old_err, old_db = held(a_old, b_old, pa, pb, p,
                                               "fma")
                between = (a_new.float() - a_old.float()).abs().max().item()
                zero = bool((a_new[ch.nnz == 0] == 0).all())
                symmetric = bool(torch.equal(a_new, a_new.transpose(1, 2)))
                del a_new, a_old, b_new, b_old, pa, pb
                torch.cuda.empty_cache()
                turns, ms_new, ms_old = turns_of(
                    (lambda: new_gram(tp, ch, out_dtype, aug),
                     lambda: parent_gram(tp, ch, out_dtype, aug)))
                uncut = smoke.queued_ms(lambda: new_gram(
                    tp, ch, out_dtype, aug, spans=1), reps=5) \
                    if spans > 1 else None
                g = tp.index_select(0, ch.cols.reshape(-1).long()).reshape(
                    r, p, f)
                if aug:
                    g = cs.augment_g(g, ch.vals)
                gt = g.transpose(1, 2)
                lib = smoke.queued_ms(lambda: torch.bmm(gt, g), reps=5)
                del g, gt
                torch.cuda.empty_cache()
                out_bytes = r * f * f * torch.tensor(
                    [], dtype=out_dtype).element_size()
                if not aug:
                    out_bytes += r * f * 4
                bms, by = smoke.bound_ms(
                    table_rows * f * 4 + smoke.nbytes(ch.cols, ch.vals) +
                    out_bytes,
                    smoke.panel_gram_ops(ch, f, not aug, "split",
                                         torch.float32))
                gathered = r * p * f * 4
                row = dict(label=label, kernel=name, shape=[r, p],
                           a=str(out_dtype), spans=spans, ms=ms_new,
                           parent_ms=ms_old, turns_ms=turns,
                           uncut_ms=uncut, library_ms=lib, bound_ms=bms,
                           bound_by=by, launches=launches,
                           gathered_tb_per_s=gathered / ms_new / 1e9,
                           max_abs_err=new_err, parent_max_abs_err=old_err,
                           max_abs_diff_between=between, b_rel_err=new_db,
                           parent_b_rel_err=old_db, within_limits=new_ok,
                           parent_within_limits=old_ok,
                           pad_rows_zero=zero, symmetric=symmetric)
                print(f"[{name} f=256 {label}] R={r} P={p} A {out_dtype}, "
                      f"S={spans}: split {ms_new:.3f} ms (turns "
                      f"{[round(t, 3) for t in turns[0::2]]}; uncut "
                      f"{'-' if uncut is None else f'{uncut:.3f}'}; "
                      f"launches {launches}; gathered "
                      f"{gathered / ms_new / 1e9:.3f} TB/s), parent FMA "
                      f"{ms_old:.3f} ms (turns "
                      f"{[round(t, 3) for t in turns[1::2]]}), torch.bmm "
                      f"{lib:.3f} ms, bound {bms:.4f} ms ({by}); max|dA| "
                      f"to plain {new_err:.3e} (split limit {new_ok}) / "
                      f"parent {old_err:.3e} (fma limit {old_ok}), between "
                      f"the bodies {between:.3e}, max rel db {new_db:.3e} "
                      f"/ {old_db:.3e} (limit 1e-5), rows of pad slots "
                      f"only 0: {zero}, symmetric: {symmetric}", flush=True)
                rows.append(row)
                ok &= new_ok and old_ok and zero and symmetric
        del ch
        torch.cuda.empty_cache()
    del panel, big, shapes
    torch.cuda.empty_cache()

    # the bf16 guard: the same bits and the time of the parent
    def same(new, old):
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(new, old) if a is not None)

    guard = []
    for width in (256, 128):
        tp, ch = smoke.panel_chunk(width, 2304, 576, seed=12)
        for aug in (False, True):
            guard.append((f"{'K5a' if aug else 'K2'} bf16 table f={width} "
                          f"R=2304 P=576, f32 A",
                          lambda tp=tp, ch=ch, aug=aug: new_gram(
                              tp, ch, torch.float32, aug),
                          lambda tp=tp, ch=ch, aug=aug: parent_gram(
                              tp, ch, torch.float32, aug)))
    tp, th = smoke.panel_chunk(128, 16384, 256, seed=13)
    x0 = 0.1 * torch.randn((16384, 128), generator=gen, device="cuda")
    x0[:, 127] = 0

    def parent_k1(aug):
        r, p = th.cols.shape
        x = torch.empty((r, 128), device="cuda")
        se = torch.empty((r, 1), device="cuda")
        err = parent[KERNELS[2 + aug]](
            tp.data_ptr(), 1, th.cols.data_ptr(), th.vals.data_ptr(), 0,
            th.nnz.data_ptr(), x0.data_ptr(), x.data_ptr(), se.data_ptr(),
            r, p, 128, 0.048, 6, 1e-4, None, 0, stream())
        if err:
            raise RuntimeError(f"the parent's K1/K6: CUDA error {err}")
        return x, se

    for aug in (False, True):
        guard.append((f"{'K6' if aug else 'K1'} bf16 table f=128 R=16384 "
                      f"P=256",
                      lambda aug=aug: cs.gather_gram_cg(
                          tp, th.cols, th.vals, th.nnz, x0, 0.048, aug=aug),
                      lambda aug=aug: parent_k1(aug)))
    for label, new_fn, old_fn in guard:
        bits = same(new_fn(), old_fn())
        turns, ms_new, ms_old = turns_of((new_fn, old_fn))
        print(f"[bf16 guard] {label}: new {ms_new:.3f} ms (turns "
              f"{[round(t, 3) for t in turns[0::2]]}), parent {ms_old:.3f} "
              f"ms (turns {[round(t, 3) for t in turns[1::2]]}), "
              f"{100 * (ms_new / ms_old - 1):+.1f}%; the same bits: {bits}",
              flush=True)
        rows.append(dict(label=label, ms=ms_new, parent_ms=ms_old,
                         turns_ms=turns, same_bits=bits))
        ok &= bits
    line = dict(card=smoke.card_line(), ok=ok, readings=rows)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as out:
        json.dump(line, out)
    print(json.dumps(line))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
