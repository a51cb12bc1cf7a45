"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result line):

1. card and build: the card's name and power limit, the torch/CUDA
   versions, the build of the native data plane (`g++`; without it the
   run fails), and the build of every CUDA kernel from csrc/ (twelve)
   with `-Xptxas -v`: registers, spills and added wgmma waits of the
   tensor-core entry functions of K1, K2, K5a, K6 and the tensor-core
   pass 1 of the 256-lane body, registers and spills of the other
   256-lane entry functions;
2. each kernel against its plain PyTorch version on the card, on real
   chunks of the Netflix-shaped plans, with kernel, plain, yardstick and
   bound times: the widest, the most populous and the fewest-row
   theta-phase chunk for K1 and K6 (device time, `queued_ms`), small
   chunks whose rows stop at the edges of the 64-slot tile, and their
   time over the whole theta phase split by chunks under and over 132
   rows; for K2 and K5a the most populous, the widest and the
   fewest-row X-phase panel chunk (the most populous with a bf16 and an
   f32 A, the widest and the fewest-row one also with a float32 table,
   which keeps the FMA body), small chunks at the edges of their 64-slot
   tile (integer
   tables: bit for bit, the proof of the tile layout), and their time
   over the whole X phase split by chunks under and over 132 rows; one
   full solve slice of the X-phase accumulators for K3 (split, bf16, at
   cg_iters 0 and 6, and the same slice widened to float32), K5b
   (augmented, f32) and K4 (the same slice unpacked and regularized
   beforehand, through `ops.solve.solve` without a diagonal);
3. small Netflix-shaped runs (scale 0.01, lowered panel_size so both
   routes engage) on the card against the same runs on the CPU: bf16
   accumulators, f32 with aug_gram="auto", f32 with aug_gram="force";
4. two paths at full width, `ALS.run` for 3 iterations each on the
   Netflix workload at scale 1.0 (~99M ratings, F=100, bf16 factors,
   backend "pallas", CG), X phase on the panel route and theta on the
   direct route, every kernel's launch count read around each run alone,
   train RMSE after the third iteration held to the recorded trajectory
   (within 1e-3) and test RMSE falling:
   a. bf16 Gram accumulators: split buffers, kernels K1, K2, K3;
   b. f32 accumulators with aug_gram="force": the augmented-lane forms,
      kernels K5a, K5b, K6;
   and K4's path, the public dispatcher `ops.solve.solve` without a
   diagonal, over every solve slice of the X-phase accumulators, held
   against the augmented solve of the same systems;
5. the factor widths above 128, on the same data at F=200 (f_pad 256,
   f2 = 96), X phase on the split route (4 table parts of 131,072 rows)
   and theta on the direct route. K7 and K1 at f=256 on a bf16 table
   run as two passes on every chunk, pass 1 on the tensor cores
   (`wide_span_gram_mma`) and pass 2 (`wide_span_solve`), one span a
   row on a chunk of as many rows as the card has SMs and the row cut
   below that; a float32 table keeps the FMA body (the uncut kernels,
   or the cut with `wide_span_gram`):
   a. K7 and K1 at f=256 as routed against their plain versions on the
      widest and the most populous theta chunk and the most populous
      split X chunk, and their uncut FMA kernels on a float32 copy of
      the table; K8 against its plain version, on a bf16 G (the two
      passes) equal to K1 at f=256 as routed on the bf16 table and on a
      float32 G (the FMA kernel) against K1's uncut kernel on a float32
      copy of the table; the tensor-core pass 1 bit for bit on integer
      tables; the cut on the split X chunk with the fewest
      rows, one of about 32 rows and the widest theta chunk, against the
      plain cut route and one span a row; each pass alone (pass 1
      through the record layout) on the chunk of about 32 rows (bf16
      and float32 tables) and the most populous theta chunk; the
      span-edge grid; both kernels' time over both phases, as routed
      and with one span a row, split by chunks under and over the SM
      count; the FMA body's earlier times printed beside;
   b. small runs (scale 0.01, F=130, forced split X route with 3 parts)
      on the card against the CPU: bf16 wide_kernel on (the two passes
      alone), float32 wide_kernel on and off (the FMA kernels);
   c. `ALS.run` for 3 iterations with wide_kernel="on", then 2
      iterations with wide_kernel="off": every chunk runs the two
      passes (pass 1 on the tensor cores) and no other 256-lane kernel;
   d. K8's path: `fused_gram_cg_cat` over every theta chunk on a G
      gathered with torch from the bf16 table (the two passes, pass 1 on
      the tensor cores reading the two slabs), each equal bit for bit to
      K1 at f=256 as routed on that table, and one chunk on a float32 G
      (the FMA kernel) against K1's uncut kernel on a float32 copy;
6. the batched-panel route at full width on the same data, F=100, bf16
   factors, backend "pallas", Cholesky, `panel_budget_bytes` 2^29 and
   `batch_rows` 4096: the X accumulators (1.16 GB) pass the budget, so X
   runs in 5 row batches through K2 (theta stays direct, in plain torch:
   Cholesky reaches no fused kernel); with f32 and then bf16
   accumulators, each against the panel route on the same settings with
   the default budget: one X phase on iteration 0's theta row by row
   (every batch's Gram accumulators entry by entry within their rounding
   bound, every rated row written, f32 x per row within 1e-5), then 3
   iterations (train RMSE within 1e-3, test RMSE within 2e-3 at every
   iteration; with bf16, or within the distance between the panel
   route's bf16 and f32 runs where that is larger), K2 launched every
   iteration and no K1, K3, K5a;
7. the port's bench, `python -m cumf_als_tpu_torch.bench`, in a
   subprocess on the cached data set: `--workload netflix --iters 3
   --repeat 3` (the root bench's keys, the card's name, the main path's
   train RMSE within 1e-3);
8. the bench's accuracy contracts: `--workload netflix_cal --scale 0.25
   --accuracy-check` and `--workload ml10m_cal --accuracy-check` must
   both pass;
9. out-of-core training: `hugewiki_mini` at scale 1.0 (2,000,000 x 39,780, 124M
   ratings, the native generator's data, counts and CRC-32s pinned to
   the JAX package's); `OutOfCoreALS` (X in pinned host memory, K1 on
   the streamed X chunks, K2 on the streamed X panels, K3 on the theta
   slices) and the in-core `ALS` (X and theta direct, K1) for 3
   iterations each at F=100, lambda 0.048, bf16 factors, CG, "pallas":
   train and test RMSE within 2e-3 at every iteration, x and theta
   within rtol/atol 2e-2, K1, K2 and K3 launched exactly as the plans
   say (chunks and slices times iterations, read around the out-of-core
   run alone), the out-of-core peak device memory below the in-core
   one, the X store pinned and no device tensor of X's rows live after
   the run; then `python -m cumf_als_tpu_torch.bench --workload
   hugewiki_mini --out-of-core --iters 3` once (the root bench's keys,
   its train RMSE within 2e-3 of the phase's run). The plans and the
   CSC go through the bench's plan cache;
10. sharded training, `ShardedALS` on the same Netflix data, F=100, bf16,
   CG, "pallas" (the main configuration), plans and CSC through the
   bench's plan cache:
   a. one rank on an NCCL group of one, 3 iterations: X on the panel
      steps (K2, K3), theta's reduce blocks solved by K1; train and test
      RMSE within 2e-3 of phase 4a's run at every iteration; K1 on the
      most populous reduce block against its plain version at phase 2a's
      limits (initial factors); one more iteration traced by
      torch.profiler for the device-busy share (`[profile]`, traced);
   b. two ranks spawned on the one card (both on cuda:0, gloo: NCCL
      refuses two ranks on one card; the partials go through host
      memory, so its s/iter is a gloo-over-one-card time, not a
      multi-GPU one), 2 iterations, one `run` call an iteration: RMSE
      within 2e-3 of (a), theta's SHA-256 equal on both ranks after each
      iteration, the gathered X equal to each rank's rows; K2 on rank 0's
      partial of the most populous reduce block (bf16 A) and K3 on that
      block summed over both ranks as the all-reduce sums it, against
      their plain versions.
   K1, K2 and K3 launch exactly as the plans say in each run (read
   around the run alone); the counts go into the `kernels` line as
   `sharded_launches`.

The data sets come through the bench's loader (`bench.load_workload`),
which generates each once into .bench_cache/torch/ and memory-maps it;
their counts and CRC-32s are held to those of the JAX package's
`workload_ratings(name, 1.0, 0)` (both pass 2^26 ratings, so both come
from the native generator).

It prints a `kernels` JSON line, the card line, and last
{"ok": true, "device": {...}}. It imports nothing of JAX.

    python3 chip_smoke.py --gram

is the short call after a change to K2, K5a or csrc/gram_mma.cuh: it
builds those two kernels alone (with the ptxas report), runs the edge
cases and three synthetic chunk shapes against the plain versions with
their times, and prints no result line.

    python3 chip_smoke.py --theta

is the short call after a change to K1, K6 or csrc/frag_cg.cuh (or to
gram_mma.cuh, which they share): it builds those two kernels alone (with
the ptxas report), runs the edge grid (rows that stop at different nnz
inside one chunk), times three synthetic chunk shapes and the most
populous, the widest and the fewest-row chunk of the real Netflix theta
plan against the plain versions, and prints no result line.

    python3 chip_smoke.py --ooc

is the short call for the out-of-core path: it builds K1, K2 and K3
alone, runs phase 9 and prints no result line.

    python3 chip_smoke.py --sharded

is the short call for sharded training: it builds K1, K2 and K3 alone,
runs phase 4a's main path (its RMSE is (a)'s reference), then phase 10,
and prints no result line.

    python3 chip_smoke.py --wide

is the short call after a change to csrc/wide.cuh or the passes: it
builds K1, K7 and the three pass kernels alone (with the ptxas report),
runs the tensor-core pass 1 on integer tables, the span-edge grid and
synthetic few-row chunks (cut against one span a row, with times), then
the few-row chunks of the real Netflix F=200 plans and each pass alone
(phase 5a's cut checks), and prints no result line.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM published peaks (NVIDIA data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ITERS = 3
REPLACES = {
    "gather_gram_cg": "cumf_als_tpu/ops/pallas_solve.py:299",
    "gather_gram_out": "cumf_als_tpu/ops/pallas_solve.py:534",
    "solve_cg_reg": "cumf_als_tpu/ops/pallas_solve.py:1105",
    "solve_cg": "cumf_als_tpu/ops/pallas_solve.py:1097",
    "gather_gram_aug_out": "cumf_als_tpu/ops/pallas_solve.py:610",
    "solve_cg_aug": "cumf_als_tpu/ops/pallas_solve.py:1122",
    "gather_gram_cg_aug": "cumf_als_tpu/ops/pallas_solve.py:345",
    "gather_gram_cg_wide": "cumf_als_tpu/ops/pallas_solve.py:804",
    "fused_gram_cg_cat": "cumf_als_tpu/ops/pallas_solve.py:956",
    # the two passes of the row cut of K7 and of K1 at 256 lanes (pass 1
    # on the FMA body or on the tensor cores)
    "wide_span_gram": "cumf_als_tpu/ops/pallas_solve.py:804",
    "wide_span_gram_mma": "cumf_als_tpu/ops/pallas_solve.py:804",
    "wide_span_solve": "cumf_als_tpu/ops/pallas_solve.py:804",
}
# the Gram body each kernel's measured launches ran ("cg": a solve alone)
# ("bulk-cg": K3's persistent blocks on bulk-async copies, csrc/bulk_cg.cuh;
# K8's own kernel is the FMA body a float32 G takes: a bf16 G launches the
# two passes, pass 1 on the tensor cores, which count under their names)
BODY = {"gather_gram_cg": "wgmma", "gather_gram_out": "wgmma",
        "solve_cg_reg": "bulk-cg", "solve_cg": "cg",
        "gather_gram_aug_out": "wgmma", "solve_cg_aug": "cg",
        "gather_gram_cg_aug": "wgmma", "gather_gram_cg_wide": "fma",
        "fused_gram_cg_cat": "fma", "wide_span_gram": "fma",
        "wide_span_gram_mma": "wgmma", "wide_span_solve": "cg"}
SPLIT_KERNELS = ("gather_gram_cg", "gather_gram_out", "solve_cg_reg")
AUG_KERNELS = ("gather_gram_cg_aug", "gather_gram_aug_out", "solve_cg_aug")
WIDE_KERNELS = ("gather_gram_cg_wide", "fused_gram_cg_cat")
GRAM_KERNELS = ("gather_gram_out", "gather_gram_aug_out")
THETA_KERNELS = ("gather_gram_cg", "gather_gram_cg_aug")
SPAN_KERNELS = ("wide_span_gram", "wide_span_gram_mma", "wide_span_solve")
# the route of K7 and K1 at f=256 on a bf16 table: the two passes, pass 1
# on the tensor cores
MMA_PASSES = ("wide_span_gram_mma", "wide_span_solve")
WIDE_SHORT = ("gather_gram_cg", "gather_gram_cg_wide") + SPAN_KERNELS
# the device times (ms) of the 256-lane kernels on the same chunks on the
# FMA body, before the tensor-core pass 1 (the bracketed times of PERF.md
# §6; NVIDIA H100 80GB HBM3, 700.00 W):
# (kernel, chunk) -> as routed then (the cut on a chunk under 132 rows),
# and uncut
FMA_MS = {
    ("K7", "theta most populous"): (11.499, 11.499),
    ("K7", "theta widest"): (0.121, 2.413),
    ("K7", "split X most populous"): (10.892, 10.892),
    ("K7", "split X fewest rows"): (4.803, 91.325),
    ("K7", "split X about 32 rows"): (1.774, 6.638),
    ("K1", "theta most populous"): (13.049, 13.049),
    ("K1", "theta widest"): (0.153, 2.769),
    ("K1", "split X most populous"): (11.936, 11.936),
    ("K1", "split X fewest rows"): (5.028, 99.214),
    ("K1", "split X about 32 rows"): (1.866, 7.216),
    ("pass 1", "split X about 32 rows"): (1.723, 1.723),
    ("pass 2", "split X about 32 rows"): (0.050, 0.050),
    # phase totals as routed: (theta, split X)
    ("K7", "phase totals"): (292.0, 348.6),
    ("K1", "phase totals"): (336.6, 379.9),
}
# K3's and K8's times before their redesign, by CUDA events around one
# launch (the bracketed times of PERF.md §6; NVIDIA H100 80GB HBM3,
# 700.00 W): K3 on the first X solve slice (16,384 bf16 systems), K8 on
# theta most populous with a bf16 G
BEFORE_MS = {"K3": 0.541, "K8": 16.209}
# train RMSE after the last iteration of the full-width Netflix paths
# (3 iterations at F=100, main and aug; at F=200 3 with wide_kernel "on"
# and 2 with "off"), read on the card from the native generator's data
# (99,077,413 ratings; PERF.md §2 has the values read on the earlier
# numpy-path data beside them)
RECORDED_TRAIN_RMSE = {"main": 0.428543, "aug": 0.428718,
                       "wide on": 0.425283, "wide off": 0.514406}
# phase 6 with f32 accumulators: the largest relative difference of a
# row's x between the batched-panel and panel routes after one X phase
# (3.0e-6 read on the card, and 2.9e-6 between two runs of the panel
# route: scripts/torch_batched_readings.py)
F32_X_ROW_LIMIT = 1e-5
DEV = "cuda"
ROOT = os.path.dirname(os.path.abspath(__file__))
# the root bench's output keys in its order (bench.py:339-382), and those
# it adds with --repeat > 1 and with --accuracy-check
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline",
              "baseline_sec_per_iter", "ns_per_nnz", "test_rmse_final",
              "train_rmse_final", "total_seconds", "gram_gflops", "solver",
              "backend", "device"]
REPEAT_KEYS = ["repeats", "spread_min", "spread_max"]
ACCURACY_KEYS = ["accuracy_check", "accuracy_contract"]
# the JAX package's workload_ratings(name, 1.0, 0): counts and each
# member's CRC-32 (bench.dataset_crc32), computed from cumf_als_tpu with
# its native generator (both workloads pass 2^26 ratings), which the
# port's data must equal bit for bit
RECORDED_NETFLIX = {"nnz": 99_077_413, "nnz_test": 1_408_586, "crc32": {
    "indptr": 3106220693, "indices": 2907137272, "data": 1322421219,
    "trow": 3812812321, "tcol": 2404904807, "tdata": 330818980}}
RECORDED_HUGEWIKI_MINI = {
    "nnz": 124_000_582, "nnz_test": 1_999_293, "crc32": {
        "indptr": 1898438497, "indices": 2973046940, "data": 3688028508,
        "trow": 2441910573, "tcol": 2051445344, "tdata": 241349327}}
# iterations of each run of the out-of-core phase
OOC_ITERS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 5) -> float:
    """Median of `reps` CUDA-event timings of fn, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def keep_busy(n: int) -> None:
    """Queue n large matrix products (~1.5 ms each) on the current stream,
    so that what the host launches next waits on the device and the
    events between those launches read device time alone."""
    busy = torch.ones((8192, 8192), dtype=torch.bfloat16, device=DEV)
    for _ in range(n):
        torch.mm(busy, busy)


def queued_ms(fn, reps: int = 5) -> float:
    """Median device time of fn over `reps` launches queued behind other
    work, after one warm-up: for a kernel that can be shorter than the
    host's work to launch it."""
    fn()
    torch.cuda.synchronize()
    keep_busy(8)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    marks[0].record()
    for i in range(reps):
        fn()
        marks[i + 1].record()
    torch.cuda.synchronize()
    return statistics.median(marks[i].elapsed_time(marks[i + 1])
                             for i in range(reps))


def gram_limit(a: torch.Tensor, a_plain: torch.Tensor, p: int, body: str):
    """What a card's K2 or K5a is held to against the plain version: the
    elementwise limit on |A - A_plain| and its name, for rows of p slots
    run in `body`. Both bodies add in another order than the plain
    version (the tensor cores also truncate where they align the terms
    of a 16-slot step), so the error follows the size of the sum, not of
    the value: an entry whose terms cancel keeps the error of its large
    partial sums. The terms of A_ij sum in magnitude to at most
    sqrt(A_ii A_jj) (Cauchy-Schwarz), so the limit is steps x 2^-23 x
    sqrt(A_ii A_jj) + 1e-5: one f32 ulp of the sum's size for each
    accumulation step (a slot in the FMA body, 16 slots on the tensor
    cores) and 4 for the plain version's own rounding. A bf16 A adds one
    bf16 ulp of the larger value: both sides round an f32 sum to
    nearest."""
    af, pf = a.float(), a_plain.float()
    steps = (p if body == "fma" else -(-p // 16)) + 4
    d = pf.diagonal(dim1=-2, dim2=-1).clamp_min(0).sqrt()
    lim = steps * 2.0 ** -23 * d[..., :, None] * d[..., None, :] + 1e-5
    name = f"{steps} x 2^-23 sqrt(A_ii A_jj) + 1e-5"
    if a.dtype != torch.bfloat16:
        return lim, name
    big = torch.maximum(af.abs(), pf.abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7)
    return lim + ulp, name + " + one bf16 ulp"


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def wide_work(table_ext, ch, fl):
    """What one launch of the 256-lane body (csrc/wide.cuh: K1 at f=256,
    K7, pass 1 of the row cut) must do on chunk `ch` at fl live lanes:
    the bytes it reads (each distinct table row its live slots name, once,
    at fl lanes; the live slots' ids and values; nnz) and its operations
    (the Gram's upper triangle of 8x8 tiles, nnz fl (fl + 8), and b, 2
    nnz fl). The warm start and the outputs are the caller's to add."""
    r, p = ch.cols.shape
    live = torch.arange(p, device=ch.cols.device)[None, :] < \
        ch.nnz.long()[:, None]
    rows = torch.unique(ch.cols[live]).numel()
    slots = float(ch.nnz.sum().item())
    read = rows * fl * table_ext.element_size() + \
        slots * (4 + ch.vals.element_size()) + nbytes(ch.nnz)
    return read, slots * fl * (fl + 8) + 2.0 * slots * fl


def card_line() -> str:
    """The card's name and power limit (the bench's reading of
    nvidia-smi)."""
    from cumf_als_tpu_torch.bench import card_line as read
    return read()


# ------------------------------------------------------------ phase 1 --
def ptxas_lines(build_log):
    """What ptxas reports for the tensor-core entry functions of K1, K2,
    K5a, K6 and the tensor-core pass 1 of the 256-lane body (registers
    and spill stores of each instantiation, static shared memory where it
    names any; the tiles are dynamic shared memory), the registers and
    spills of the 256-lane entry functions and of K3, and every warning of
    the build. Returns False if one of them spills or ptxas added a wgmma
    wait."""
    import re
    ok = True
    for name in GRAM_KERNELS + THETA_KERNELS + ("wide_span_gram_mma",):
        if name not in build_log:
            continue
        lines = build_log[name].splitlines()
        regs, spills, smem = [], [], []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "mma_kernel" in line:
                info = " ".join(lines[i + 1:i + 5])
                regs += [int(x) for x in re.findall(r"Used (\d+) registers",
                                                    info)]
                spills += [int(x) for x in re.findall(
                    r"(\d+) bytes spill stores", info)]
                smem += [int(x) for x in re.findall(r"(\d+) bytes smem",
                                                    info)]
        # C7517: ptxas makes every turn of the tile loop wait for all of
        # its wgmma where plain code touches the sums inside the loop;
        # only these entry functions issue wgmma, so every such note of
        # the build counts
        waits = sum("C7517" in line for line in lines)
        # C7519: a warpgroup.arrive ptxas placed itself (no wait)
        arrives = sum("C7519" in line for line in lines)
        ok &= bool(regs) and max(spills, default=0) == 0 and waits == 0
        log(f"[ptxas] {name}, the {len(regs)} tensor-core entry functions: "
            f"registers {regs}, spill stores {spills} bytes, static shared "
            f"memory {max(smem, default=0)} bytes (dynamic: the ring of "
            f"tiles), wgmma waits added by ptxas (C7517): {waits}, "
            f"warpgroup arrives added by ptxas (C7519): {arrives}")
    for name in WIDE_SHORT:
        if name not in build_log or name == "wide_span_gram_mma":
            continue
        lines = build_log[name].splitlines()
        regs, spills = [], []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and any(
                    k in line for k in ("_256_kernel", "wide_kernel",
                                        "span_gram_kernel",
                                        "span_solve_kernel")):
                info = " ".join(lines[i + 1:i + 5])
                regs += [int(x) for x in re.findall(r"Used (\d+) registers",
                                                    info)]
                spills += [int(x) for x in re.findall(
                    r"(\d+) bytes spill stores", info)]
        log(f"[ptxas] {name}, the {len(regs)} 256-lane entry functions "
            f"(csrc/wide.cuh): registers {sorted(set(regs))}, spill stores "
            f"up to {max(spills, default=0)} bytes")
    if "solve_cg_reg" in build_log:
        lines = build_log["solve_cg_reg"].splitlines()
        regs, spills = [], []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and \
                    "solve_cg_reg_kernel" in line:
                info = " ".join(lines[i + 1:i + 5])
                regs += [int(x) for x in re.findall(r"Used (\d+) registers",
                                                    info)]
                spills += [int(x) for x in re.findall(
                    r"(\d+) bytes spill stores", info)]
        log(f"[ptxas] solve_cg_reg, the {len(regs)} entry functions of K3 "
            f"(csrc/bulk_cg.cuh, f = 16..128, bf16 and f32 A): registers "
            f"{regs}, spill stores {spills} bytes")
    for name, out in build_log.items():
        for line in out.splitlines():
            if "warning" in line.lower() or "Potential" in line:
                log(f"[ptxas] {name}: {line.strip()[:300]}")
    return ok


def gram_synthetic(cs):
    """K2 and K5a at the shapes of the most populous X panel chunk
    (R=2304, P=576, a 65,537-row bf16 panel) and of two chunks of few
    long rows, on data made from a seed, without the plans: kernel vs
    plain and the times."""
    from types import SimpleNamespace
    gen = torch.Generator(device=DEV).manual_seed(3)
    r, p, n = 2304, 4096, 65536
    tp = (0.3 * torch.randn((n + 1, 128), generator=gen, device=DEV)
          ).to(torch.bfloat16)
    tp[n] = 0
    tp[:, 127] = 0
    nnz = torch.randint(p // 2, p + 1, (r,), generator=gen, device=DEV,
                        dtype=torch.int32)
    nnz[5] = 0
    mask = torch.arange(p, device=DEV)[None, :] < nnz[:, None]
    cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                           device=DEV), n).to(torch.int32)
    vals = (torch.randint(2, 11, (r, p), generator=gen, device=DEV) / 2.0
            * mask).float()
    ok = True
    for rows, slots in ((2304, 576), (32, 3840), (8, 4096)):
        ch = SimpleNamespace(cols=cols[:rows, :slots].contiguous(),
                             vals=vals[:rows, :slots].contiguous(),
                             nnz=nnz[:rows].clamp(max=slots), panel=0)
        for aug in (False, True):
            for a_dtype in (torch.bfloat16, torch.float32):
                ok &= check_gram(cs, tp, ch, a_dtype, aug, "synthetic")[0]
    return ok


# ------------------------------------------------------------ phase 2 --
def check_k1(cs, table_ext, ch, theta, cfg, label, aug=False):
    """K1 (or, with aug, K6) on one theta-phase chunk: kernel vs plain,
    x within 2e-3 and se within 1e-3 relative; rows without ratings
    exactly 0 in x and se, and with aug lane f-1 of x exactly 0. Kernel
    and plain are timed by one clock, device time behind queued work
    (`queued_ms`): a few-row chunk's kernel is not much longer than the
    host's work to launch it."""
    x0 = chunk_x0(ch, theta)
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    plain_fn = cs.gather_gram_cg_aug_plain if aug else \
        cs.gather_gram_cg_plain
    x, se = cs.gather_gram_cg(*args, aug=aug, **kw)
    px, pse = plain_fn(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    empty = ch.nnz == 0
    zero_ok = bool((x[empty] == 0).all()) and bool((se[empty] == 0).all())
    if aug:
        zero_ok &= bool((x[:, -1] == 0).all())
    del px, pse
    ms = queued_ms(lambda: cs.gather_gram_cg(*args, aug=aug, **kw))
    plain = queued_ms(lambda: plain_fn(*args, **kw), reps=3)
    r, p = ch.cols.shape
    f = table_ext.shape[1]
    flops = 2.0 * float(ch.nnz.sum().item()) * f * f
    bms, by = bound_ms(nbytes(table_ext, ch.cols, ch.vals, ch.nnz, x0, x,
                              se), flops, table_ext.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3 and zero_ok
    name = "K6 gather_gram_cg_aug" if aug else "K1 gather_gram_cg"
    log(f"[{name}] {label} chunk R={r} P={p}, table {table_ext.dtype}, "
        f"body {cs.gram_body(table_ext)}: max|dx|={err:.3e} (limit 2e-3), "
        f"max rel dse={se_rel:.3e} (limit 1e-3), {int(empty.sum())} rows "
        f"without ratings{' and lane f-1' if aug else ''} exactly 0: "
        f"{zero_ok}; device time: kernel {ms:.3f} ms, plain {plain:.3f} "
        f"ms, bound {bms:.4f} ms ({by}); {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def theta_chunk(p, seed, aug, vals_dtype, n=60, f=128):
    """A theta chunk of P = p slots whose rows stop at the edges of the
    64-slot tile, made from a seed: one row for each nnz in (0, 1, 15,
    16, 17, 63, 64, 65, 128, 129, p) up to p, pad slots at each row's
    tail (the zero row n, value 0), and a dummy tail row without ratings
    whose warm start is zero, as a plan's chunk ends. The table is bf16
    (the tensor-core body); with aug its lane f-1 is free and one value
    (3.3) is not exact in bf16."""
    rng = np.random.RandomState(seed + 17 * p)
    nnz = np.array([k for k in (0, 1, 15, 16, 17, 63, 64, 65, 128, 129)
                    if k < p] + [p, 0], dtype=np.int32)
    r = len(nnz)
    table = (rng.standard_normal((n + 1, f)) * 0.3).astype(np.float32)
    table[n] = 0.0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    vals[-2, 0] = 3.3
    x0 = (rng.standard_normal((r, f)) * 0.1).astype(np.float32)
    x0[-1] = 0.0
    if aug:
        table[:, f - 1] = 0.0
        x0[:, f - 1] = 0.0
    return (torch.from_numpy(table).to(DEV).to(torch.bfloat16),
            torch.from_numpy(cols).to(DEV),
            torch.from_numpy(vals * mask).to(DEV).to(vals_dtype),
            torch.from_numpy(nnz).to(DEV), torch.from_numpy(x0).to(DEV))


def theta_edges(cs, lam=0.048):
    """K1 and K6 against their plain versions on `theta_chunk`s: P = 64,
    256 and 520 (1, 4 and 9 tiles; rows of 0 to P slots in one chunk), f32
    and bf16 values: x within 2e-3, se within 1e-3 relative, rows without
    ratings exactly 0 in x and se, K6's lane 127 of x exactly 0."""
    ok_all = True
    worst = {}
    for p in (64, 256, 520):
        for aug in (False, True):
            for v_dtype in (torch.float32, torch.bfloat16):
                args = theta_chunk(p, 5, aug, v_dtype)
                x, se = cs.gather_gram_cg(*args, lam, aug=aug)
                plain = cs.gather_gram_cg_aug_plain if aug else \
                    cs.gather_gram_cg_plain
                px, pse = plain(*args, lam)
                err = (x - px).abs().max().item()
                se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)
                          ).max().item()
                empty = args[3] == 0
                ok = err <= 2e-3 and se_rel <= 1e-3 and \
                    bool((x[empty] == 0).all()) and \
                    bool((se[empty] == 0).all())
                if aug:
                    ok &= bool((x[:, -1] == 0).all())
                key = "K6" if aug else "K1"
                w = worst.setdefault(key, [0.0, 0.0])
                w[0], w[1] = max(w[0], err), max(w[1], se_rel)
                if not ok:
                    log(f"[theta edges] FAIL {key} P={p} vals {v_dtype}: "
                        f"max|dx|={err:.3e} max rel dse={se_rel:.3e}")
                ok_all &= ok
    log(f"[theta edges] K1 and K6, P in (64, 256, 520) x vals (f32, bf16), "
        f"bf16 table, f=128, rows of nnz (0, 1, 15, 16, 17, 63, 64, 65, "
        f"128, 129, P) and a dummy tail row: worst (max|dx|, max rel dse) "
        f"{ {k: [float(f'{e:.3e}') for e in v] for k, v in worst.items()} } "
        f"(limits 2e-3, 1e-3); rows without ratings exactly 0, K6 lane 127 "
        f"exactly 0; {'OK' if ok_all else 'FAIL'}")
    return ok_all


def theta_synthetic(cs, lam=0.048):
    """K1 and K6 at the shapes of the most populous (R=16384, P=256) and
    the widest (R=8, P=8192) theta chunk and of a few-row one (R=4,
    P=1024), on data made from a seed without the plans, each row of
    between P/2 and P ratings: kernel vs plain and the times."""
    from types import SimpleNamespace
    gen = torch.Generator(device=DEV).manual_seed(4)
    n = 17770
    tab = (0.3 * torch.randn((n + 1, 128), generator=gen, device=DEV)
           ).to(torch.bfloat16)
    tab[n] = 0
    tab[:, 127] = 0
    cfg = SimpleNamespace(lam=lam, cg_iters=6, cg_tol=1e-4)
    ok = True
    for r, p in ((16384, 256), (8, 8192), (4, 1024)):
        nnz = torch.randint(p // 2 + 1, p + 1, (r,), generator=gen,
                            device=DEV, dtype=torch.int32)
        mask = torch.arange(p, device=DEV)[None, :] < nnz[:, None]
        cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                               device=DEV), n)
        vals = torch.randint(2, 11, (r, p), generator=gen, device=DEV) / 2.0
        ch = SimpleNamespace(
            cols=cols.to(torch.int32), vals=(vals * mask).float(), nnz=nnz,
            n_real=r, rows=torch.arange(r, device=DEV),
            rows_real=torch.arange(r, device=DEV))
        theta = 0.1 * torch.randn((r, 128), generator=gen, device=DEV)
        theta[:, 127] = 0
        for aug in (False, True):
            ok &= check_k1(cs, tab, ch, theta, cfg, "synthetic", aug=aug)[0]
    return ok


def check_gram(cs, tp, ch, a_dtype, aug, label):
    """K2 (or, with aug, K5a) on one X-phase panel chunk: kernel vs plain,
    and torch.bmm on a pre-gathered (and, with aug, pre-augmented) G as
    the yardstick: it leaves out the gather, the value splice and b, and
    writes A in G's dtype. All three times are device time (`queued_ms`:
    on a few-row chunk the kernel is shorter than the host's work to
    launch it). A is held to `gram_limit`, b to 1e-5 relative;
    the line prints the measured error relative to the size of the sum,
    max |dA_ij| / sqrt(A_ii A_jj), in units of 2^-23."""
    args = (tp, ch.cols, ch.vals)
    if aug:
        name, fn, plain_fn = ("K5a gather_gram_aug_out",
                              cs.gather_gram_aug_out,
                              cs.gather_gram_aug_out_plain)
        a, b = fn(*args, out_dtype=a_dtype), None
        pa = plain_fn(*args, out_dtype=a_dtype)
    else:
        name, fn, plain_fn = ("K2 gather_gram_out", cs.gather_gram_out,
                              cs.gather_gram_out_plain)
        a, b = fn(*args, out_dtype=a_dtype)
        pa, pb = plain_fn(*args, out_dtype=a_dtype)
    af, paf = a.float(), pa.float()
    diff = (af - paf).abs()
    err = diff.max().item()
    body = cs.gram_body(tp)
    lim, limit = gram_limit(a, pa, ch.cols.shape[1], body)
    a_ok = bool((diff <= lim).all())
    d = paf.diagonal(dim1=1, dim2=2).clamp_min(0).sqrt()
    of_sum = (diff / (d[:, :, None] * d[:, None, :]).clamp_min(1e-30)
              )[diff > 0]
    of_sum = of_sum.max().item() / 2.0 ** -23 if of_sum.numel() else 0.0
    del lim
    pad_rows = ch.nnz == 0
    zero_ok = bool((af[pad_rows] == 0).all())
    b_rel = 0.0
    if b is not None:
        b_rel = ((b - pb).abs() / pb.abs().clamp_min(1.0)).max().item()
        zero_ok &= bool((b[pad_rows] == 0).all())
    del af, paf, diff, d, a, pa
    ms = queued_ms(lambda: fn(*args, out_dtype=a_dtype))
    plain = queued_ms(lambda: plain_fn(*args, out_dtype=a_dtype), reps=3)
    r, p = ch.cols.shape
    f = tp.shape[1]
    g = tp.index_select(0, ch.cols.reshape(-1).long()).reshape(r, p, f)
    if aug:
        g = cs.augment_g(g, ch.vals)
    gt = g.transpose(1, 2)
    lib = queued_ms(lambda: torch.bmm(gt, g))
    del g, gt
    flops = 2.0 * float(ch.nnz.sum().item()) * f * f
    out_bytes = r * f * f * torch.tensor([], dtype=a_dtype).element_size()
    if not aug:
        out_bytes += r * f * 4
    bms, by = bound_ms(nbytes(tp, ch.cols, ch.vals) + out_bytes, flops,
                       tp.dtype)
    gathered = r * p * f * tp.element_size()
    rate = gathered / (ms * 1e-3) / 1e12
    ok = a_ok and b_rel <= 1e-5 and zero_ok
    log(f"[{name}] {label}: panel {ch.panel} chunk R={r} P={p}, table "
        f"{tp.dtype}, A {a_dtype}, body {body}: max|dA|={err:.3e} (limit "
        f"{limit}: {a_ok}), max |dA_ij|/sqrt(A_ii A_jj)={of_sum:.2f} x 2^-23, "
        f"max rel db={b_rel:.3e} (limit 1e-5), rows of pad slots only "
        f"exactly 0: {zero_ok}; device time: kernel {ms:.3f} ms, plain "
        f"{plain:.3f} ms, torch.bmm on pre-gathered G (no gather, no "
        f"{'splice' if aug else 'b'}, A in G's dtype) {lib:.3f} ms, bound "
        f"{bms:.4f} ms ({by}); gathered from the L2 {gathered / 1e6:.1f} "
        f"MB, {rate:.3f} TB/s; {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=lib, body=body,
                    gathered_bytes=gathered, gathered_tb_per_s=rate)


def check_k3(cs, a_buf, b_buf, x0_full, row_nnz, lo, batch, cfg,
             what="slice"):
    """K3 on one solve slice of the X-phase accumulators, at the run's
    cg_iters and at 0 (at 0 the kernel still loads A and forms b - A x0,
    so the difference is the CG), with the slice's A as stored and
    widened to float32 (what a gram_dtype="f32" run without aug feeds
    K3); the stored dtype's numbers fill the entry, the float32 ones go
    under f32_* (a float32 A is checked once). `what` names the systems
    in the log line; the time before K3's redesign, on the main path's
    X slice, is printed beside a "slice" alone."""
    b = b_buf[lo:lo + batch]
    x0 = x0_full[lo:lo + batch]
    nnzf = row_nnz[lo:lo + batch].float()
    diag = nnzf * cfg.lam + (nnzf == 0).float()
    ok_all, out = True, {}
    a_s = a_buf[lo:lo + batch]
    for a in (a_s,) if a_s.dtype == torch.float32 else (a_s, a_s.float()):
        kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
        x = cs.solve_cg_reg(a, diag, b, x0, **kw)
        px = cs.solve_cg_reg_plain(a, diag, b, x0, **kw)
        err = (x - px).abs().max().item()
        del px
        ms = time_ms(lambda: cs.solve_cg_reg(a, diag, b, x0, **kw))
        ms0 = time_ms(lambda: cs.solve_cg_reg(a, diag, b, x0, cg_iters=0,
                                              cg_tol=cfg.cg_tol))
        plain = time_ms(lambda: cs.solve_cg_reg_plain(a, diag, b, x0, **kw),
                        reps=3)
        f = a.shape[-1]
        # the least CG work: one matvec per system
        bms, by = bound_ms(nbytes(a, diag, b, x0, x), 2.0 * batch * f * f,
                           a.dtype)
        ok = err <= 2e-3
        per_sm = cs.cg_reg_blocks_per_sm(a.device, f, a.dtype)
        before = f"before: {BEFORE_MS['K3']:.3f} ms" if a.dtype == \
            torch.bfloat16 and what == "slice" else "before: not measured"
        log(f"[K3 solve_cg_reg] {what} of {batch} systems, A {a.dtype}: "
            f"max|dx|={err:.3e} (limit 2e-3); kernel {ms:.3f} ms ({before}), "
            f"at cg_iters 0 {ms0:.3f} ms (the CG: {ms - ms0:.3f} ms), plain "
            f"{plain:.3f} ms, bound {bms:.4f} ms ({by}), {bms / ms:.0%} of "
            f"the bound; {per_sm} blocks an SM (the kernel's occupancy "
            f"query); {'OK' if ok else 'FAIL'}")
        ok_all &= ok
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None, ms_cg0=ms0,
                   blocks_per_sm=per_sm)
        if out:
            out.update({f"f32_{k}": v for k, v in res.items()})
        else:
            out = res
        del a, x
    return ok_all, out


def gram_edges(cs):
    """K2 and K5a at the edges of the 64-slot tile, on small chunks made
    from a seed: P = 8, 24, 72, 136 (one k-step, a ragged last tile, one
    slot group past a tile, two tiles and a half k-step), P = 520 and
    1288 (long rows: 9 and 21 tiles through the ring of 4), R = 1 and a
    chunk with a row of pad slots only. The table holds small integers
    and the values halves, so every sum is exact in f32 whatever its
    order: the kernels must equal their plain versions bit for bit, which
    proves the tile layout (a misplaced piece changes a sum). Then the
    same shapes on a random table within `gram_limit`, for a bf16 and a
    float32 table."""
    rng = np.random.RandomState(7)
    n, f = 300, 128
    worst = {}
    ok_all = True
    for p in (8, 24, 72, 136, 520, 1288):
        for r in (1, 5):
            nnz = rng.randint(1, p + 1, (r,))
            if r > 1:
                nnz[2] = 0          # a row of pad slots only
                nnz[0] = p          # a full row
            mask = np.arange(p)[None, :] < nnz[:, None]
            cols = torch.from_numpy(np.where(
                mask, rng.randint(0, n, (r, p)), n).astype(np.int32)).to(DEV)
            vals = torch.from_numpy((np.round(rng.uniform(1, 5, (r, p)) * 2)
                                     / 2 * mask).astype(np.float32)).to(DEV)
            for kind in ("integers", "random"):
                if kind == "integers":
                    tab = rng.randint(-4, 5, (n + 1, f)).astype(np.float32)
                else:
                    tab = (rng.standard_normal((n + 1, f)) * 0.3
                           ).astype(np.float32)
                tab[n] = 0.0
                tab[:, f - 1] = 0.0     # the free lane of the aug form
                for t_dtype, v_dtype, a_dtype in (
                        (torch.bfloat16, torch.float32, torch.float32),
                        (torch.bfloat16, torch.bfloat16, torch.bfloat16),
                        (torch.float32, torch.float32, torch.float32)):
                    table = torch.from_numpy(tab).to(DEV).to(t_dtype)
                    args = (table, cols, vals.to(v_dtype))
                    a, b = cs.gather_gram_out(*args, out_dtype=a_dtype)
                    pa, pb = cs.gather_gram_out_plain(*args,
                                                      out_dtype=a_dtype)
                    a5 = cs.gather_gram_aug_out(*args, out_dtype=a_dtype)
                    pa5 = cs.gather_gram_aug_out_plain(*args,
                                                       out_dtype=a_dtype)
                    pairs = (("K2 A", a, pa), ("K2 b", b, pb),
                             ("K5a A'", a5, pa5))
                    for what, got, want in pairs:
                        got, want = got.float(), want.float()
                        diff = (got - want).abs()
                        big = torch.maximum(got.abs(), want.abs())
                        if kind == "integers":
                            ok = bool((diff == 0).all())
                        elif what == "K2 b":
                            ok = bool((diff <= 1e-5 * big + 1e-5).all())
                        else:
                            ok = bool((diff <= gram_limit(
                                a if what == "K2 A" else a5, want, p,
                                cs.gram_body(table))[0]).all())
                        ok &= bool((got[nnz == 0] == 0).all())
                        key = (what, kind)
                        worst[key] = max(worst.get(key, 0.0),
                                         diff.max().item())
                        if not ok:
                            log(f"[gram edges] FAIL {what} P={p} R={r} "
                                f"{kind} table {t_dtype} vals {v_dtype} A "
                                f"{a_dtype}: max|d|={diff.max().item():.3e}")
                        ok_all &= ok
    log(f"[gram edges] P in (8, 24, 72, 136, 520, 1288) x R in (1, 5, one "
        f"row of pad slots only) x (bf16 table f32 A, bf16 table bf16 vals "
        f"bf16 A, f32 table f32 A), f=128: integer tables equal the plain "
        f"version bit for bit (the layout proof), random tables within gram_limit "
        f"(b: rtol 1e-5 + 1e-5); worst |d| "
        f"{ {' '.join(k): round(v, 9) for k, v in worst.items()} }; "
        f"{'OK' if ok_all else 'FAIL'}")
    return ok_all


def check_k5b(cs, a, diag, x0, cfg):
    """K5b on one solve slice of the augmented X-phase accumulator."""
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    x = cs.solve_cg_aug(a, diag, x0, **kw)
    px = cs.solve_cg_aug_plain(a, diag, x0, **kw)
    err = (x - px).abs().max().item()
    lane_ok = bool((x[:, -1] == 0).all())
    ms = time_ms(lambda: cs.solve_cg_aug(a, diag, x0, **kw))
    plain = time_ms(lambda: cs.solve_cg_aug_plain(a, diag, x0, **kw),
                    reps=3)
    batch, f, _ = a.shape
    # the least CG work: one matvec per system
    bms, by = bound_ms(nbytes(a, diag, x0, x), 2.0 * batch * f * f, a.dtype)
    ok = err <= 2e-3 and lane_ok
    log(f"[K5b solve_cg_aug] slice of {batch} systems, A' {a.dtype}: "
        f"max|dx|={err:.3e} (limit 2e-3), lane f-1 of x zero: {lane_ok}; "
        f"kernel {ms:.3f} ms, plain {plain:.3f} ms, bound {bms:.4f} ms "
        f"({by}); {'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def check_k4(cs, solve, a_reg, b, x0, cfg):
    """K4 through the public dispatcher, on one solve slice with the
    diagonal already added."""
    kw = dict(solver="cg", cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
              backend="pallas")
    before = cs.LAUNCHES["solve_cg"]
    x = solve(a_reg, b, x0, **kw)
    rose = cs.LAUNCHES["solve_cg"] == before + 1
    px = cs.solve_cg_plain(a_reg, b, x0, cfg.cg_iters, cfg.cg_tol)
    err = (x - px).abs().max().item()
    ms = time_ms(lambda: solve(a_reg, b, x0, **kw))
    plain = time_ms(lambda: cs.solve_cg_plain(a_reg, b, x0, cfg.cg_iters,
                                              cfg.cg_tol), reps=3)
    batch, f, _ = a_reg.shape
    bms, by = bound_ms(nbytes(a_reg, b, x0, x), 2.0 * batch * f * f,
                       a_reg.dtype)
    ok = err <= 2e-3 and rose
    log(f"[K4 solve_cg] ops.solve.solve without diag, slice of {batch} "
        f"systems, A {a_reg.dtype}: max|dx|={err:.3e} (limit 2e-3), the "
        f"dispatcher launched the kernel: {rose}; kernel {ms:.3f} ms, "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None)


def chunk_x0(ch, current):
    """The warm start of one chunk: the rows' current factors, zeros for
    the dummy tail rows."""
    return torch.nn.functional.pad(
        current.index_select(0, ch.rows_real),
        (0, 0, 0, ch.rows.shape[0] - ch.n_real))


def route_of(cs, table_ext, r, p, spans=None):
    """How the wrappers of K7 and K1 at f=256 run a chunk of R rows of P
    slots on this table: (text, S, L)."""
    n_spans, span = cs._chunk_spans(torch.device(DEV, 0), r, p, spans,
                                    **cs.span_plan(table_ext))
    if cs.gram_body(table_ext) == "wgmma":
        return (f"two passes, S={n_spans} span(s) of {span} slots, pass 1 "
                f"on the tensor cores", n_spans, span)
    if n_spans > 1:
        return (f"two passes, S={n_spans} spans of {span} slots, pass 1 on "
                f"the FMA body", n_spans, span)
    return "uncut kernel, FMA body", n_spans, span


def fma_note(kernel, label, which=0):
    """The FMA body's earlier time of this kernel on this chunk (FMA_MS),
    as text."""
    old = FMA_MS.get((kernel, label))
    return f"FMA body before: {old[which]:.3f} ms" if old else \
        "FMA body before: not measured"


def check_fused_256(cs, table_ext, ch, current, cfg, label, f2=None,
                    chunk=None):
    """K7 (with f2) or K1 at f=256 on one chunk of a 256-lane table, as
    the wrapper routes it (a bf16 table: the two passes, pass 1 on the
    tensor cores; a float32 table: the uncut kernel, or the cut on a
    chunk with fewer rows than the card has SMs): kernel vs the uncut
    plain version, limits as K1's; K7's dead lanes and empty rows must be
    exactly 0. The bound counts the live lanes (`wide_work`): 128 + f2
    for K7, 256 for K1, whatever body runs it. `chunk` names the chunk in
    FMA_MS, whose time is printed beside."""
    x0 = chunk_x0(ch, current)
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    if f2 is None:
        name, live, key = "K1 gather_gram_cg f=256", 256, "K1"
        fn, plain_fn = cs.gather_gram_cg, cs.gather_gram_cg_plain
    else:
        name, live, key = f"K7 gather_gram_cg_wide f2={f2}", 128 + f2, "K7"
        args = args + (f2,)
        fn, plain_fn = cs.gather_gram_cg_wide, cs.gather_gram_cg_wide_plain
    x, se = fn(*args, **kw)
    px, pse = plain_fn(*args, **kw)
    err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    zero_ok = bool((x[:, live:] == 0).all()) and \
        bool((x[ch.nnz == 0] == 0).all())
    del px, pse
    ms = queued_ms(lambda: fn(*args, **kw))
    plain = queued_ms(lambda: plain_fn(*args, **kw), reps=3)
    r, p = ch.cols.shape
    read, flops = wide_work(table_ext, ch, live)
    bms, by = bound_ms(read + r * live * 4 + nbytes(x, se), flops,
                       table_ext.dtype)
    ok = err <= 2e-3 and se_rel <= 1e-3 and zero_ok
    route = route_of(cs, table_ext, r, p)[0]
    log(f"[{name}] {label} chunk R={r} P={p}, table {table_ext.dtype} "
        f"({route}): max|dx|={err:.3e} (limit 2e-3), max rel dse="
        f"{se_rel:.3e} (limit 1e-3), dead lanes and empty rows exactly 0: "
        f"{zero_ok}; device time {ms:.3f} ms ({fma_note(key, chunk)}), "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                    bound_by=by, library_ms=None, shape=[r, p],
                    body=cs.gram_body(table_ext))


def gathered_slabs(table_ext, ch, f2):
    """G of one chunk, gathered with torch into the two lane slabs K8
    takes: g1 (R, P, 128) and the packed g2 (R, P, f2)."""
    r, p = ch.cols.shape
    idx = ch.cols.reshape(-1).long()
    g1 = table_ext[:, :128].index_select(0, idx).reshape(r, p, 128)
    g2 = table_ext[:, 128:128 + f2].index_select(0, idx).reshape(r, p, f2)
    return g1, g2


def check_k8(cs, table_ext, ch, current, cfg, f2, label):
    """K8 on the gathered G of one theta chunk, G gathered from the bf16
    table and from a float32 copy of it: each against its plain version
    (x 2e-3, se 1e-3 relative); the bf16 G (the two passes) equal bit
    for bit to K1 at f=256 as routed on the bf16 table (-0 equals +0),
    the float32 G (the FMA kernel) against K1's uncut kernel at f=256 on
    the float32 copy (rtol 1e-5 + 1e-6: the same FMA body). The float32
    numbers fill the entry (the kernel of csrc/fused_gram_cg_cat.cu,
    whose launches it counts), the bf16 ones (the two passes) go under
    bf16_*."""
    x0 = chunk_x0(ch, current)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    r, p = ch.cols.shape
    ok_all, out = True, {}
    for table in (table_ext, table_ext.float()):
        g1, g2 = gathered_slabs(table, ch, f2)
        args = (g1, g2, ch.vals, ch.nnz, x0, cfg.lam)
        x, se = cs.fused_gram_cg_cat(*args, **kw)
        px, pse = cs.fused_gram_cg_cat_plain(*args, **kw)
        err = (x - px).abs().max().item()
        se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
        del px, pse
        if cs.cat_body(g1.dtype, f2) == "wgmma":
            mx, mse = cs.gather_gram_cg(table, ch.cols, ch.vals, ch.nnz, x0,
                                        cfg.lam, **kw)
            same_ok = torch.equal(x, mx) and torch.equal(se, mse)
            same = f"equal to K1 at f=256 routed on the bf16 table: {same_ok}"
            route = "two passes, pass 1 on the tensor cores"
        else:
            mx, mse = cs.gather_gram_cg(table, ch.cols, ch.vals, ch.nnz, x0,
                                        cfg.lam, spans=1, **kw)
            same_ok = bool(((x - mx).abs() <= 1e-5 * mx.abs() + 1e-6).all()) \
                and bool(((se - mse).abs() <= 1e-5 * mse.abs() + 1e-6).all())
            same = (f"against K1's uncut kernel at f=256 max|dx|="
                    f"{(x - mx).abs().max().item():.3e} (limit rtol 1e-5 + "
                    f"1e-6: {same_ok})")
            route = "uncut FMA kernel"
        del mx, mse
        ms = time_ms(lambda: cs.fused_gram_cg_cat(*args, **kw))
        plain = time_ms(lambda: cs.fused_gram_cg_cat_plain(*args, **kw),
                        reps=3)
        slots = float(r * p)   # the Gram's upper triangle over every slot
        bms, by = bound_ms(nbytes(g1, g2, ch.vals, ch.nnz, x0, x, se),
                           slots * 256 * (256 + 8) + 2.0 * slots * 256,
                           g1.dtype)
        ok = err <= 2e-3 and se_rel <= 1e-3 and same_ok
        before = f"before: {BEFORE_MS['K8']:.3f} ms" if \
            g1.dtype == torch.bfloat16 and label == "theta most populous" \
            else "before: not measured"
        log(f"[K8 fused_gram_cg_cat f2={f2}] {label} chunk R={r} P={p}, G "
            f"{g1.dtype} ({route}): max|dx|={err:.3e} (limit 2e-3), max "
            f"rel dse={se_rel:.3e} (limit 1e-3), {same}; kernel {ms:.3f} ms "
            f"({before}), plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
            f"{'OK' if ok else 'FAIL'}")
        ok_all &= ok
        res = dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                   bound_by=by, library_ms=None)
        prefix = "" if g1.dtype == torch.float32 else "bf16_"
        out.update({f"{prefix}{k}": v for k, v in res.items()})
        del g1, g2, args, x, se, table
    return ok_all, out


def queued_each(calls):
    """Device time of each of `calls`, launched in turn behind a run of
    large matrix products so that the events between them read device
    time (a chunk's kernel can be shorter than the host's work to launch
    it); the first three run once before as a warm-up."""
    for call in calls[:3]:      # the first launch loads the kernel
        call()
    torch.cuda.synchronize()
    keep_busy(80)
    marks = [torch.cuda.Event(enable_timing=True)
             for _ in range(len(calls) + 1)]
    marks[0].record()
    for i, call in enumerate(calls):
        call()
        marks[i + 1].record()
    queued = not marks[0].query()   # the device had not reached them yet
    torch.cuda.synchronize()
    if not queued:
        raise AssertionError("the launches did not queue behind the matrix "
                             "products: the events between them would "
                             "read the host's time")
    return [marks[i].elapsed_time(marks[i + 1]) for i in range(len(calls))]


def split_by_rows(times, chunks, sms):
    """Sum of per-chunk times, and of those of the chunks with fewer rows
    than the card has SMs (one block takes one row at a time, so those
    leave SMs idle), with the longest four of them, ms and (R, P)."""
    split = dict(total=sum(times), few=0.0, n_few=0, sms=sms,
                 widest=max(c.cols.shape[1] for c in chunks))
    few = []
    for ms, ch in zip(times, chunks):
        if ch.cols.shape[0] < sms:
            split["few"] += ms
            split["n_few"] += 1
            few.append((ms, tuple(ch.cols.shape)))
    split["longest_few"] = sorted(few, reverse=True)[:4]
    return split


def sm_count() -> int:
    return torch.cuda.get_device_properties(0).multi_processor_count


def cut_runner(cs, table_ext, ch, x0, cfg, f2):
    """fn(spans=None) solving one chunk through K7 (with f2) or K1 at
    f=256, and the kernel's name and live lanes."""
    args = (table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam)
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    if f2 is None:
        return (lambda spans=None: cs.gather_gram_cg(*args, spans=spans, **kw),
                "gather_gram_cg", 256)
    return (lambda spans=None: cs.gather_gram_cg_wide(*args, f2, spans=spans,
                                                      **kw),
            "gather_gram_cg_wide", 128 + f2)


def check_cut(cs, table_ext, ch, current, cfg, label, f2=None):
    """The row cut of K7 (with f2) or of K1 at f=256 on one chunk with
    fewer rows than the card has SMs, as the wrapper chooses it
    (`row_spans` in the pass-1 body's tiles): the launch counts show the
    two passes (pass 1 on the tensor cores for a bf16 table) and not the
    uncut kernel; x within 2e-3 and se within 1e-3 relative of the plain
    cut route and of the uncut kernel (on a bf16 table: on a float32
    copy of it, the FMA body); rows without ratings and K7's dead lanes
    exactly 0. The cut, one span a row (spans=1; on a bf16 table the two
    passes at S = 1) and the plain route timed as device time
    (`queued_ms`), the FMA body's earlier times beside."""
    x0 = chunk_x0(ch, current)
    r, p = ch.cols.shape
    route, n_spans, span = route_of(cs, table_ext, r, p)
    fn, name, fl = cut_runner(cs, table_ext, ch, x0, cfg, f2)
    pass1 = "wide_span_gram_mma" if cs.gram_body(table_ext) == "wgmma" \
        else "wide_span_gram"
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    cs.reset_launch_counts()
    x, se = fn()
    torch.cuda.synchronize()
    took = n_spans > 1 and cs.LAUNCHES[pass1] == 1 and \
        cs.LAUNCHES["wide_span_solve"] == 1 and cs.LAUNCHES[name] == 0
    px, pse = cs.row_cut_plain(table_ext, ch.cols, ch.vals, ch.nnz, x0,
                               cfg.lam, fl, n_spans, span, **kw)
    ux, use = cut_runner(cs, table_ext.float(), ch, x0, cfg, f2)[0](spans=1)

    def errs(x2, se2):
        return ((x - x2).abs().max().item(),
                ((se - se2).abs() / se2.abs().clamp_min(1.0)).max().item())

    err, se_rel = errs(px, pse)
    uerr, use_rel = errs(ux, use)
    empty = ch.nnz == 0
    zero_ok = bool((x[:, fl:] == 0).all()) and bool((x[empty] == 0).all()) \
        and bool((se[empty] == 0).all())
    del px, pse, ux, use
    ms = queued_ms(fn)
    uncut = queued_ms(lambda: fn(spans=1))
    plain = queued_ms(lambda: cs.row_cut_plain(
        table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam, fl, n_spans,
        span, **kw), reps=3)
    read, flops = wide_work(table_ext, ch, fl)
    bms, by = bound_ms(read + r * fl * 4 + nbytes(x, se), flops,
                       table_ext.dtype)
    ok = took and zero_ok and max(err, uerr) <= 2e-3 and \
        max(se_rel, use_rel) <= 1e-3
    tag = "K1 gather_gram_cg f=256" if f2 is None else \
        f"K7 gather_gram_cg_wide f2={f2}"
    key = "K1" if f2 is None else "K7"
    one = route_of(cs, table_ext, r, p, spans=1)[0]
    log(f"[cut {tag}] {label} chunk R={r} P={p}: {route}, the two passes "
        f"launched and not the uncut kernel: {took}; against the plain cut "
        f"route max|dx|={err:.3e}, max rel dse={se_rel:.3e}; against the "
        f"uncut FMA kernel (float32 table) max|dx|={uerr:.3e}, max rel dse="
        f"{use_rel:.3e} (limits 2e-3, 1e-3); dead lanes and empty rows "
        f"exactly 0: {zero_ok}; device time: cut {ms:.3f} ms "
        f"({fma_note(key, label)}), one span a row ({one}) {uncut:.3f} ms "
        f"({fma_note(key, label, 1)} uncut), "
        f"plain {plain:.3f} ms, bound {bms:.4f} ms ({by}); "
        f"{'OK' if ok else 'FAIL'}")
    return ok, dict(ms=ms, uncut_ms=uncut, plain_ms=plain, bound_ms=bms,
                    bound_by=by, max_abs_err=err, spans=n_spans,
                    span_len=span, shape=[r, p])


def check_span_passes(cs, table_ext, ch, current, cfg, f2, label):
    """Each pass of the row cut alone on one chunk (K7's lanes), with the
    spans `row_spans` gives it in the tiles of the body that takes the
    table. Pass 1 (`span_grams`: on the tensor cores for a bf16 table, on
    the FMA body for a float32 one) against `span_gram_plain`, read
    through the record layout of csrc/wide.cuh (`span_record_unpack`):
    every live span's A within `gram_limit`'s steps for a span's slots in
    that body, b and r2 within rtol 1e-5 + 1e-5. Pass 2 (`span_solve`) on
    pass 1's own records against `span_solve_plain` on the same records
    unpacked: x within 2e-3, se within 1e-3 relative. Returns the
    kernels-line entries of the two passes, keyed by kernel name."""
    fl = 128 + f2
    x0 = chunk_x0(ch, current)
    r, p = ch.cols.shape
    _, n_spans, span = route_of(cs, table_ext, r, p)
    body = cs.gram_body(table_ext)
    pass1 = "wide_span_gram_mma" if body == "wgmma" else "wide_span_gram"
    gargs = (table_ext, ch.cols, ch.vals, ch.nnz, fl, n_spans, span)
    part = cs.span_grams(*gargs)
    live = cs._span_live(ch.nnz, p, n_spans, span)
    plain_parts = [cs.span_gram_plain(table_ext, ch.cols, ch.vals, ch.nnz,
                                      k * span, (k + 1) * span, fl)
                   for k in range(n_spans)]
    pa = torch.stack([q[0] for q in plain_parts], dim=1)[live]
    pb = torch.stack([q[1] for q in plain_parts], dim=1)[live]
    pr2 = torch.stack([q[2] for q in plain_parts], dim=1)[live]
    del plain_parts
    a, b, r2 = cs.span_record_unpack(part[live], fl)
    lim, limit = gram_limit(a, pa, span, body)
    diff = (a - pa).abs()
    a_err = diff.max().item()
    a_ok = bool((diff <= lim).all())
    b_ok = bool(((b - pb).abs() <= 1e-5 * pb.abs() + 1e-5).all()) and \
        bool(((r2 - pr2).abs() <= 1e-5 * pr2.abs() + 1e-5).all())
    n_live = int(live.sum().item())
    del lim, diff, a, b, r2, pa, pb, pr2
    kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
    x, se = cs.span_solve(part, ch.nnz, x0, cfg.lam, p, span, **kw)
    ua, ub, ur2 = cs.span_record_unpack(
        torch.where(live[:, :, None], part, torch.zeros_like(part)), fl)
    card_parts = [(ua[:, k], ub[:, k], ur2[:, k]) for k in range(n_spans)]
    px, pse = cs.span_solve_plain(card_parts, ch.nnz, x0, cfg.lam, **kw)
    x_err = (x - px).abs().max().item()
    se_rel = ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()
    del px, pse
    ms1 = queued_ms(lambda: cs.span_grams(*gargs))
    plain1 = queued_ms(lambda: [cs.span_gram_plain(
        table_ext, ch.cols, ch.vals, ch.nnz, k * span, (k + 1) * span, fl)
        for k in range(n_spans)], reps=3)
    ms2 = queued_ms(lambda: cs.span_solve(part, ch.nnz, x0, cfg.lam, p,
                                          span, **kw))
    plain2 = queued_ms(lambda: cs.span_solve_plain(
        card_parts, ch.nnz, x0, cfg.lam, **kw), reps=3)
    del ua, ub, ur2, card_parts, part
    rec_bytes = n_live * cs.span_record_floats(fl) * 4
    read, flops = wide_work(table_ext, ch, fl)
    b1, by1 = bound_ms(read + rec_bytes, flops, table_ext.dtype)
    # pass 2: the records once, and the CG's cg_iters + 2 matvecs a row
    b2, by2 = bound_ms(rec_bytes + nbytes(ch.nnz, x, se) + r * fl * 4,
                       r * (cfg.cg_iters + 2) * 2.0 * fl * fl, torch.float32)
    ok1 = a_ok and b_ok
    ok2 = x_err <= 2e-3 and se_rel <= 1e-3
    log(f"[span passes f2={f2}] {label} chunk R={r} P={p}, table "
        f"{table_ext.dtype}, S={n_spans} spans of {span} slots, {n_live} "
        f"live: pass 1 ({pass1}, body {body}) max|dA|={a_err:.3e} (limit "
        f"{limit}: {a_ok}), b and r2 within rtol 1e-5 + 1e-5: {b_ok}; pass "
        f"2 on the same records max|dx|={x_err:.3e}, max rel dse="
        f"{se_rel:.3e} (limits 2e-3, 1e-3); device time: pass 1 {ms1:.3f} "
        f"ms ({fma_note('pass 1', label)}; plain {plain1:.3f}, bound "
        f"{b1:.4f} ms, {by1}), pass 2 {ms2:.3f} ms "
        f"({fma_note('pass 2', label)}; plain {plain2:.3f}, bound {b2:.4f} "
        f"ms, {by2}); {'OK' if ok1 and ok2 else 'FAIL'}")
    return ok1 and ok2, {
        pass1: dict(max_abs_err=a_err, ms=ms1, plain_ms=plain1,
                    bound_ms=b1, bound_by=by1, library_ms=None,
                    shape=[r, p], spans=n_spans, span_len=span),
        "wide_span_solve": dict(max_abs_err=x_err, ms=ms2, plain_ms=plain2,
                                bound_ms=b2, bound_by=by2, library_ms=None,
                                shape=[r, p], spans=n_spans, span_len=span)}


def span_gram_edges(cs):
    """The tensor-core pass 1 against `span_gram_plain` on the card
    tests' integer tables (`span_int_chunk` of tests/test_torch_cuda.py:
    small integers in lanes < FL, NaN above, rows that stop at nnz 0, 1,
    63, 64, 65 and P): bit for bit (every sum is exact), at FL = 160, 192,
    224, 256, P = 63, 64, 65, 127, 129 (`SPAN_P`), one span a row and a
    forced cut of two; the proof of its tiling, record layout and
    zero-fill."""
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import SPAN_P, span_int_chunk
    ok_all, n = True, 0
    for p in SPAN_P:
        for fl in (160, 192, 224, 256):
            table, cols, vals, nnz = (t.to(DEV) for t in
                                      span_int_chunk(fl, p))
            for spans in (1, 2):
                n_spans, span = cs._cut(-(-p // 64), spans, 64)
                part = cs.span_grams(table, cols, vals, nnz, fl, n_spans,
                                     span)
                live = cs._span_live(nnz, p, n_spans, span)
                a, b, r2 = cs.span_record_unpack(part[live], fl)
                want = [cs.span_gram_plain(table, cols, vals, nnz, k * span,
                                           (k + 1) * span, fl)
                        for k in range(n_spans)]
                pa, pb, pr2 = (torch.stack([w[i] for w in want], dim=1)[live]
                               for i in range(3))
                ok = torch.equal(a, pa) and torch.equal(b, pb) and \
                    torch.equal(r2, pr2)
                if not ok:
                    log(f"[span gram edges] FAIL FL={fl} P={p} S={n_spans}: "
                        f"max|dA|={(a - pa).abs().max().item():.3e}")
                ok_all &= ok
                n += 1
    log(f"[span gram edges] the tensor-core pass 1 on integer tables, "
        f"{n} cases (FL = 160, 192, 224, 256; P = {SPAN_P}; S = 1 and 2; "
        f"NaN in lanes >= FL): equal to span_gram_plain bit for bit: "
        f"{ok_all}; {'OK' if ok_all else 'FAIL'}")
    return ok_all


def span_edges(cs, lam=0.048):
    """The row cut forced at the S and P of the card tests (`CUTS` of
    tests/test_torch_cuda.py: S = 2, 3, 7) on their chunks (`cut_chunk`:
    rows that stop at nnz 0, 1, 31, 32, 33, on the span edge, one past it
    and at P, and a dummy tail row), for T = 20, 24, 28, 32 (K7 at f2 =
    32, 64, 96, 128) and K1 at f=256, f32 and bf16 tables (spans of whole
    tiles of the pass-1 body: 32 slots on the FMA body, 64 on the tensor
    cores): against the plain cut route and one span a row (spans=1),
    x within 2e-3, se within 1e-3 relative; empty rows and dead lanes
    exactly 0; a second run bit for bit."""
    from pathlib import Path
    from types import SimpleNamespace
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_cuda import CUTS, cut_chunk
    cfg = SimpleNamespace(lam=lam, cg_iters=6, cg_tol=1e-4)
    kw = dict(cg_iters=6, cg_tol=1e-4)
    worst = [0.0, 0.0, 0.0, 0.0]
    ok_all = True
    for p, spans in CUTS:
        for f_true, f2 in ((130, 32), (161, 64), (200, 96), (256, 128),
                           (200, None)):
            for dtype in (torch.float32, torch.bfloat16):
                tile = 64 if dtype == torch.bfloat16 else 32
                n_spans, span = cs._cut(-(-p // tile), spans, tile)
                table, cols, vals, nnz, x0 = (t.to(DEV) for t in cut_chunk(
                    f_true, dtype, p, span, seed=f_true))
                ch = SimpleNamespace(cols=cols, vals=vals, nnz=nnz)
                fn, _, fl = cut_runner(cs, table, ch, x0, cfg, f2)
                x, se = fn(spans=n_spans)
                px, pse = cs.row_cut_plain(table, cols, vals, nnz, x0, lam,
                                           fl, n_spans, span, **kw)
                ux, use = fn(spans=1)
                x2, se2 = fn(spans=n_spans)
                e = [(x - px).abs().max().item(),
                     ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item(),
                     (x - ux).abs().max().item(),
                     ((se - use).abs() / use.abs().clamp_min(1.0)).max().item()]
                worst = [max(w, v) for w, v in zip(worst, e)]
                ok = max(e[0], e[2]) <= 2e-3 and max(e[1], e[3]) <= 1e-3 \
                    and torch.equal(x, x2) and torch.equal(se, se2) and \
                    bool((x[:, fl:] == 0).all()) and \
                    bool((x[nnz == 0] == 0).all()) and \
                    bool((se[nnz == 0] == 0).all())
                if not ok:
                    log(f"[span edges] FAIL P={p} S={n_spans} f_true="
                        f"{f_true} f2={f2} {dtype}: {e}")
                ok_all &= ok
    log(f"[span edges] the cut forced at S = 2, 3, 7 (P = 300, 300, 448), "
        f"rows of nnz (0, 1, 31, 32, 33, L, L + 1, P) and a dummy tail row, "
        f"K7 at f2 = 32, 64, 96, 128 and K1 at f=256, f32 and bf16 tables: "
        f"worst against the plain cut route max|dx|={worst[0]:.3e}, max rel "
        f"dse={worst[1]:.3e}, against one span a row {worst[2]:.3e}, "
        f"{worst[3]:.3e} (limits 2e-3, 1e-3); repeats bit for bit, empty "
        f"rows and dead lanes exactly 0; {'OK' if ok_all else 'FAIL'}")
    return ok_all


def wide_synthetic(cs, lam=0.048):
    """K7 (f2 = 96) and K1 at f=256 on seeded few-row chunks at the
    shapes of the Netflix F=200 plans' few-row chunks (the widest theta
    chunk R=8 P=8192, split X chunks of about 32 rows, one long row),
    each row of between P/2 and P ratings over a bf16 table: the cut the
    wrapper chooses (pass 1 on the tensor cores) against the uncut FMA
    kernel on a float32 copy of the table (x within 2e-3, se within 1e-3
    relative; one span a row on the tensor cores is no reference for a
    long row, PERF.md), and the cut and one span a row (spans=1)
    as device time."""
    from types import SimpleNamespace
    gen = torch.Generator(device=DEV).manual_seed(5)
    n = 131072
    tab = (0.2 * torch.rand((n + 1, 256), generator=gen, device=DEV)
           ).to(torch.bfloat16)
    tab[n] = 0
    tab[:, 200:] = 0
    cfg = SimpleNamespace(lam=lam, cg_iters=6, cg_tol=1e-4)
    ok_all = True
    for r, p in ((8, 8192), (32, 16384), (100, 4096), (1, 241664)):
        nnz = torch.randint(p // 2 + 1, p + 1, (r,), generator=gen,
                            device=DEV, dtype=torch.int32)
        mask = torch.arange(p, device=DEV)[None, :] < nnz[:, None]
        cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                               device=DEV), n)
        vals = torch.randint(2, 11, (r, p), generator=gen, device=DEV) / 2.0
        ch = SimpleNamespace(cols=cols.to(torch.int32),
                             vals=(vals * mask).float(), nnz=nnz)
        x0 = 0.1 * torch.rand((r, 256), generator=gen, device=DEV)
        x0[:, 200:] = 0
        route = route_of(cs, tab, r, p)[0]
        for f2 in (96, None):
            fn, _, _ = cut_runner(cs, tab, ch, x0, cfg, f2)
            x, se = fn()
            ux, use = cut_runner(cs, tab.float(), ch, x0, cfg, f2)[0](spans=1)
            err = (x - ux).abs().max().item()
            se_rel = ((se - use).abs() / use.abs().clamp_min(1.0)).max().item()
            ok = err <= 2e-3 and se_rel <= 1e-3
            ok_all &= ok
            ms = queued_ms(fn)
            uncut = queued_ms(lambda: fn(spans=1))
            log(f"[wide synthetic] {'K7 f2=96' if f2 else 'K1 f=256'} R={r} "
                f"P={p}: {route}; against the uncut FMA kernel (float32 "
                f"table) max|dx|={err:.3e}, max rel dse={se_rel:.3e}; device "
                f"time cut "
                f"{ms:.3f} ms, one span a row {uncut:.3f} ms; "
                f"{'OK' if ok else 'FAIL'}")
    return ok_all


def cut_totals(cs, label, chunks, table, current, cfg, f2):
    """Device time of K7 (with f2) or of K1 at f=256 over one phase's
    chunks (`queued_each`), as the wrappers choose (the cut on chunks
    with fewer rows than the card has SMs) and with one span a row
    (spans=1; on a float32 table the uncut kernel), each split by chunks
    under and over the SM count, with the spans chosen for each chunk
    under it; the FMA body's earlier times as routed beside."""
    sms = sm_count()
    x0s = [chunk_x0(ch, current) for ch in chunks]
    runs = [cut_runner(cs, table, ch, x0, cfg, f2)[0]
            for ch, x0 in zip(chunks, x0s)]
    cut = queued_each(runs)
    uncut = queued_each([lambda fn=fn: fn(spans=1) for fn in runs])
    del x0s, runs
    few = [i for i, ch in enumerate(chunks) if ch.cols.shape[0] < sms]
    spans = [route_of(cs, table, *chunks[i].cols.shape)[1] for i in few]
    tot = dict(cut=sum(cut), uncut=sum(uncut), n=len(chunks), n_few=len(few),
               cut_few=sum(cut[i] for i in few),
               uncut_few=sum(uncut[i] for i in few),
               spans=sorted(set(spans)))
    longest = sorted(((uncut[i], cut[i], tuple(chunks[i].cols.shape), sp)
                      for i, sp in zip(few, spans)), reverse=True)[:4]
    kern = "K1 f=256" if f2 is None else f"K7 f2={f2}"
    old = FMA_MS[("K1" if f2 is None else "K7", "phase totals")][
        0 if label == "theta" else 1]
    log(f"[wide phase totals] {kern} over the {len(chunks)} {label} chunks, "
        f"table {table.dtype} (body {cs.gram_body(table)}): as routed "
        f"{tot['cut']:.1f} ms (FMA body before: {old} ms), of which "
        f"{tot['cut_few']:.1f} ms in the {len(few)} chunks with fewer than "
        f"{sms} rows (cut) and {tot['cut'] - tot['cut_few']:.1f} ms in the "
        f"others; one span a row {tot['uncut']:.1f} ms, of which "
        f"{tot['uncut_few']:.1f} ms in those {len(few)} chunks; spans chosen "
        f"under {sms} rows: {tot['spans']}; the longest of them with one "
        f"span a row (ms one span, ms cut, (R, P), S): "
        f"{[(round(u, 3), round(c, 3), rp, sp) for u, c, rp, sp in longest]}"
        f" (device time between events, launches queued behind other work)")
    return tot


def phase_totals(cs, al, theta_t, x_t):
    """Device time of one phase's kernel chunk by chunk (`queued_each`),
    split by chunks with fewer rows than the card has SMs: the fused
    kernel (K1, or K6 when the config takes the augmented form) over the
    theta phase, from the warm starts of theta_t's shape; the Gram
    kernel alone (K2 or K5a) over the X phase (the panels' tables made
    outside the timing), with the bytes gathered and written; and the X
    phase's whole Gram step (that kernel + the index_add_ scatter into
    the accumulators)."""
    cfg = al.cfg
    f = cfg.f_pad
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    table_ext = torch.cat([x_t.to(torch.bfloat16),
                           x_t.new_zeros((1, f), dtype=torch.bfloat16)])
    aug_direct = cs.aug_enabled(cfg)
    chunks_t = al.plan_theta[1]
    x0s = [torch.zeros((ch.rows.shape[0], f), device="cuda")
           for ch in chunks_t]
    theta = split_by_rows(queued_each([
        lambda ch=ch, x0=x0: cs.gather_gram_cg(
            table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam,
            cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol, aug=aug_direct)
        for ch, x0 in zip(chunks_t, x0s)]), chunks_t, sms)
    del x0s, table_ext

    plan, chunks, _ = al.plan_x
    s = plan.panel_size
    th16 = torch.nn.functional.pad(theta_t.to(torch.bfloat16),
                                   (0, 0, 0, plan.n_panels * s -
                                    theta_t.shape[0]))
    zero = th16.new_zeros((1, f))
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks),
                              plan.num_rows)
    gram = cs.gather_gram_aug_out if al._use_panel_aug() else \
        cs.gather_gram_out
    tables = {p: torch.cat([th16[p * s:(p + 1) * s], zero])
              for p in sorted({ch.panel for ch in chunks})}
    split = split_by_rows(queued_each([
        lambda ch=ch: gram(tables[ch.panel], ch.cols, ch.vals,
                           out_dtype=a_dtype) for ch in chunks]), chunks, sms)
    del tables
    a_item = torch.tensor([], dtype=a_dtype).element_size()
    split["gathered"] = sum(ch.cols.numel() * f * 2 for ch in chunks)
    split["written"] = sum(ch.cols.shape[0] * f * f * a_item
                           for ch in chunks)

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    al.accumulate_panels(theta_t, al.plan_x)
    end.record()
    end.synchronize()
    return theta, split, start.elapsed_time(end)


def full_width(cs, model, label, expect, absent, x0, th0, iters=ITERS):
    """One full-width path: ALS.run with every launch count read around
    it alone; a path of RECORDED_TRAIN_RMSE must reach that train RMSE
    after its last iteration (within 1e-3) and lower its test RMSE."""
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launch_counts()
    res = model.run(x0, th0)
    torch.cuda.synchronize()
    launches = dict(cs.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    per_iter = [h.x_seconds + h.theta_seconds for h in res.history]
    for h in res.history:
        log(f"[{label}] iter {h.iteration}: x {h.x_seconds:.4f} s, "
            f"theta {h.theta_seconds:.4f} s, rmse {h.rmse_seconds:.4f} "
            f"s, train {h.train_rmse:.6f}, test {h.test_rmse:.6f}")
    log(f"[{label}] seconds per iteration (x + theta): "
        f"{[round(t, 4) for t in per_iter]}, median "
        f"{statistics.median(per_iter):.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB; launches {launches}")
    tr = [h.train_rmse for h in res.history]
    if len(tr) != iters or \
            not np.all(np.isfinite(tr + [h.test_rmse for h in res.history])):
        raise AssertionError(f"{label}: non-finite RMSE")
    if not tr[-1] < tr[0]:
        raise AssertionError(f"{label}: train RMSE did not fall")
    if label in RECORDED_TRAIN_RMSE:
        want = RECORDED_TRAIN_RMSE[label]
        te = [h.test_rmse for h in res.history]
        log(f"[{label}] train RMSE after iteration {iters} {tr[-1]:.6f}, "
            f"recorded {want} (limit 1e-3); test RMSE "
            f"{[round(t, 6) for t in te]}")
        if abs(tr[-1] - want) > 1e-3 or not te[-1] < te[0]:
            raise AssertionError(f"{label}: the RMSE trajectory moved")
    for name in expect:
        if launches[name] < iters:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times in "
                f"{iters} iterations")
    for name in absent:
        if launches[name]:
            raise AssertionError(
                f"{label}: {name} launched {launches[name]} times on a "
                f"path that does not run it")
    return res.history, launches


def ext16(t):
    """A bf16 gather table: t and one zero row."""
    return torch.cat([t.to(torch.bfloat16),
                      t.new_zeros((1, t.shape[1]), dtype=torch.bfloat16)])


def wide_setup(cs, ALS, cfg, train, csc, test):
    """The F=200 model on the Netflix data (f_pad 256, f2 = 96; X on the
    split route, theta direct), its initial factors, and the stand-in
    tables of the kernel checks: returns al, cfg_w, f2, x0_np, th0_np,
    theta_t, x_t, x_ext."""
    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.models import als as als_mod
    from cumf_als_tpu_torch.ops.tiling import SplitPlan, UpdatePlan

    cfg_w = cfg.replace(f=200, wide_kernel="on")
    f2 = cs.wide_f2(cfg_w.f)
    split_s = []
    build_split_plan = als_mod.build_split_plan

    def timed_split_plan(*a, **k):
        t0 = time.monotonic()
        plan = build_split_plan(*a, **k)
        split_s.append(time.monotonic() - t0)
        return plan

    als_mod.build_split_plan = timed_split_plan
    try:
        al = ALS(cfg_w, train, csc, test, device=DEV)
    finally:
        als_mod.build_split_plan = build_split_plan
    plan_x, chunks_x, aux_x = al.plan_x
    sms = sm_count()
    log(f"[wide] F={cfg_w.f} f_pad={cfg_w.f_pad} f2={f2}: plans "
        f"{al.plan_seconds:.1f} s, of which the numpy build_split_plan "
        f"{sum(split_s):.1f} s; X phase: {type(plan_x).__name__} "
        f"({len(chunks_x)} chunks, {plan_x.n_parts} parts of "
        f"{plan_x.part_size} rows, expansion {plan_x.expansion:.3f}; "
        f"{sum(c.cols.shape[0] < sms for c in chunks_x)} chunks under {sms} "
        f"rows), theta phase: {type(al.plan_theta[0]).__name__} "
        f"({len(al.plan_theta[1])} chunks; "
        f"{sum(c.cols.shape[0] < sms for c in al.plan_theta[1])} under "
        f"{sms} rows)")
    if not (isinstance(plan_x, SplitPlan) and plan_x.n_parts == 4 and
            plan_x.part_size == 131072 and
            isinstance(al.plan_theta[0], UpdatePlan) and
            cs.wide_enabled(cfg_w) and cfg_w.f_pad == 256):
        raise AssertionError("expected the split X route with 4 parts of "
                             "131072 rows and the direct theta route")
    x0_np, th0_np = init_factors(cfg_w.m, cfg_w.n, cfg_w.f, seed=0)
    gen = torch.Generator(device=DEV).manual_seed(2)
    theta_t = al._pad_f(th0_np)
    # a stand-in X for the theta-phase table: the real X starts at zero
    x_t = al._pad_f(0.2 * torch.rand((cfg_w.m, cfg_w.f), generator=gen,
                                     device=DEV).cpu().numpy())
    return al, cfg_w, f2, x0_np, th0_np, theta_t, x_t, ext16(x_t)


def cut_checks(cs, al, cfg_w, f2, theta_t, x_t, x_ext):
    """The row cut on the few-row chunks of the F=200 plans: the split X
    chunk with the fewest rows, the split X chunk under the SM count
    nearest 32 rows, and the widest theta chunk, each for K7 and K1 at
    f=256 (`check_cut`); each pass alone (`check_span_passes`) on the
    chunk of about 32 rows with the bf16 table (pass 1 on the tensor
    cores) and a float32 copy of it (pass 1 on the FMA body), and on the
    most populous theta chunk (one span a row, the tensor cores). Returns
    (ok, the passes' kernels-line entries, the cut results by chunk)."""
    sms = sm_count()
    chunks_x = al.plan_x[1]
    few_x = [c for c in chunks_x if c.cols.shape[0] < sms]
    picks = (("split X fewest rows", "x",
              min(chunks_x, key=lambda c: (c.cols.shape[0], -c.width))),
             ("split X about 32 rows", "x",
              min(few_x, key=lambda c: (abs(c.cols.shape[0] - 32),
                                        -c.width))),
             ("theta widest", "theta",
              max(al.plan_theta[1], key=lambda c: c.width)))
    th_perm_ext = ext16(theta_t.index_select(0, al.plan_x[2]["perm"]))
    tables = {"x": (th_perm_ext, x_t), "theta": (x_ext, theta_t)}
    ok_all = True
    cuts = {}
    for label, phase, ch in picks:
        table, current = tables[phase]
        for kf2 in (f2, None):
            ok, res = check_cut(cs, table, ch, current, cfg_w, label, f2=kf2)
            ok_all &= ok
            cuts[f"{'K7' if kf2 else 'K1_f256'} {label}"] = res
    ok, cut32 = check_span_passes(cs, th_perm_ext, picks[1][2], x_t, cfg_w,
                                  f2, picks[1][0])
    ok_all &= ok
    ok, fma32 = check_span_passes(cs, th_perm_ext.float(), picks[1][2], x_t,
                                  cfg_w, f2, picks[1][0])
    ok_all &= ok
    del th_perm_ext
    torch.cuda.empty_cache()
    populous = max(al.plan_theta[1], key=lambda c: c.rows.shape[0] * c.width)
    ok, passes = check_span_passes(cs, x_ext, populous, theta_t, cfg_w, f2,
                                   "theta most populous")
    ok_all &= ok
    for k, v in cut32.items():
        passes[k]["cut_chunk"] = v
    passes["wide_span_gram"] = fma32["wide_span_gram"]
    torch.cuda.empty_cache()
    return ok_all, passes, cuts


def wide_paths(cs, ALS, cfg, train, csc, test, small_train, small_test,
               results):
    """Phase 5: the F > 128 path. Fills results[...] for K7, K8 and the
    three pass kernels, adds K1's numbers at f=256 to its entry, and
    returns the launch counts of the two tensor-core route passes (the
    wide_kernel="on" run), of the FMA-only kernels (the small float32
    run) and of K8 (its own path)."""
    import copy

    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.ops.tiling import SplitPlan, UpdatePlan

    al, cfg_w, f2, x0_np, th0_np, theta_t, x_t, x_ext = wide_setup(
        cs, ALS, cfg, train, csc, test)
    plan_x, chunks_x, aux_x = al.plan_x

    # ---- 5a. the kernels against their plain versions: as the wrappers
    # route a bf16 table (the two passes, pass 1 on the tensor cores), and
    # the uncut FMA kernels on a float32 copy of the table
    chunks_t = al.plan_theta[1]
    widest = max(chunks_t, key=lambda c: c.width)
    populous = max(chunks_t, key=lambda c: c.rows.shape[0] * c.width)
    ch_x = max(chunks_x, key=lambda c: c.rows.shape[0] * c.width)
    parts = plan_x.chunks[chunks_x.index(ch_x)].parts
    th_perm_ext = ext16(theta_t.index_select(0, aux_x["perm"]))
    ok_all = True
    routed = {}
    for kf2, key in ((f2, "K7"), (None, "K1")):
        for label, table, current, ch, text in (
                ("theta widest", x_ext, theta_t, widest, "theta widest"),
                ("theta most populous", x_ext, theta_t, populous,
                 "theta most populous"),
                ("split X most populous", th_perm_ext, x_t, ch_x,
                 f"split X (parts {parts}) most populous")):
            ok, routed[(key, label)] = check_fused_256(
                cs, table, ch, current, cfg_w, text, f2=kf2, chunk=label)
            ok_all &= ok
    del th_perm_ext
    x_ext32 = x_ext.float()
    ok, results["gather_gram_cg_wide"] = check_fused_256(
        cs, x_ext32, populous, theta_t, cfg_w,
        "theta most populous, float32 table", f2=f2,
        chunk="theta most populous")
    ok_all &= ok
    ok, k1_256 = check_fused_256(
        cs, x_ext32, populous, theta_t, cfg_w,
        "theta most populous, float32 table", chunk="theta most populous")
    ok_all &= ok
    del x_ext32
    ok, _ = check_k8(cs, x_ext, widest, theta_t, cfg_w, f2, "theta widest")
    ok_all &= ok
    ok, results["fused_gram_cg_cat"] = check_k8(
        cs, x_ext, populous, theta_t, cfg_w, f2, "theta most populous")
    ok_all &= ok
    ok_all &= span_edges(cs)
    ok_all &= span_gram_edges(cs)
    ok, passes, cuts = cut_checks(cs, al, cfg_w, f2, theta_t, x_t, x_ext)
    ok_all &= ok
    results.update(passes)
    results["gather_gram_cg_wide"].update(
        routed={label: v for (key, label), v in routed.items()
                if key == "K7"},
        cut={k: v for k, v in cuts.items() if k.startswith("K7")})
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # where the two phases spend their time: K7 and K1 at f=256 chunk by
    # chunk, as routed (the cut under the SM count) and uncut
    th_perm_ext = ext16(theta_t.index_select(0, aux_x["perm"]))
    totals = {}
    for kf2 in (f2, None):
        for label, chunks, table, current in (
                ("theta", chunks_t, x_ext, theta_t),
                ("split X", chunks_x, th_perm_ext, x_t)):
            totals[(kf2, label)] = cut_totals(cs, label, chunks, table,
                                              current, cfg_w, kf2)
    del th_perm_ext
    torch.cuda.empty_cache()

    # ---- 5b. small runs with both new routes: card against CPU, the two
    # passes taken in each card run (pass 1 on the tensor cores with bf16
    # factors, on the FMA body with float32 ones, which also run the
    # uncut FMA kernels on chunks of 132 rows or more)
    scfg = cfg.replace(m=small_train.num_rows, n=small_train.num_cols,
                       nnz=small_train.nnz, nnz_test=small_test.nnz, f=130,
                       panel_size=2048, split_gather="force", verbose=False,
                       debug_timing=False)
    sx0, sth0 = init_factors(scfg.m, scfg.n, scfg.f, seed=0)
    small_launches = {}
    for label, extra, lim_tr, lim_te, want in (
            ("bf16 wide on", dict(wide_kernel="on"), 5e-3, 1e-2, MMA_PASSES),
            ("f32 wide on", dict(wide_kernel="on", factor_dtype="f32",
                                 gram_dtype="f32"), 1e-3, 1e-3,
             ("wide_span_gram", "wide_span_solve", "gather_gram_cg_wide")),
            ("f32 wide off", dict(wide_kernel="off", factor_dtype="f32",
                                  gram_dtype="f32"), 1e-3, 1e-3,
             ("wide_span_gram", "wide_span_solve", "gather_gram_cg"))):
        item = 2 if extra.get("factor_dtype", "bf16") == "bf16" else 4
        part_rows = -(-scfg.n // 3 // 8) * 8
        c = scfg.replace(gather_part_bytes=part_rows * 256 * item, **extra)
        small = {}
        for dev in (DEV, "cpu"):
            model = ALS(c, small_train, None, small_test, device=dev)
            assert isinstance(model.plan_x[0], SplitPlan)
            assert model.plan_x[0].n_parts == 3
            assert isinstance(model.plan_theta[0], UpdatePlan)
            assert cs.wide_enabled(c) == (extra["wide_kernel"] == "on")
            cs.reset_launch_counts()
            small[dev] = model.run(sx0, sth0).history
            if dev == DEV:
                counts = {k: v for k, v in cs.LAUNCHES.items() if v}
        small_launches[label] = counts
        for hg, hc in zip(small[DEV], small["cpu"]):
            dtr = abs(hg.train_rmse - hc.train_rmse)
            dte = abs(hg.test_rmse - hc.test_rmse)
            log(f"[small F=130 split, {label}] iter {hg.iteration}: card "
                f"train {hg.train_rmse:.6f} test {hg.test_rmse:.6f} | cpu "
                f"train {hc.train_rmse:.6f} test {hc.test_rmse:.6f} (limits "
                f"{lim_tr:g}, {lim_te:g})")
            if not (dtr <= lim_tr and dte <= lim_te):
                raise AssertionError("card and CPU runs disagree")
        log(f"[small F=130 split, {label}] launches in the card run: "
            f"{counts} (expected among them: {list(want)})")
        if min(counts.get(k, 0) for k in want) == 0:
            raise AssertionError(f"the card run did not launch {want}")
        if label.startswith("bf16") and set(counts) - set(MMA_PASSES):
            raise AssertionError("a bf16 run launched another 256-lane "
                                 "kernel than the two passes")

    # ---- 5c. the F = 200 path at full width: with a bf16 table every
    # 256-lane chunk runs the two passes, pass 1 on the tensor cores, and
    # no uncut kernel and no FMA pass 1
    others = SPLIT_KERNELS + AUG_KERNELS + ("solve_cg",)
    fma_256 = WIDE_KERNELS + ("wide_span_gram",)
    _, launches_on = full_width(
        cs, al, "wide on", MMA_PASSES, others + fma_256, x0_np, th0_np)
    al_off = copy.copy(al)     # the same plans; wide_kernel steers no plan
    al_off.cfg = cfg_w.replace(wide_kernel="off", iters=2)
    _, launches_off = full_width(
        cs, al_off, "wide off", MMA_PASSES, others + fma_256, x0_np, th0_np,
        iters=2)
    n_chunks = len(chunks_x) + len(chunks_t)
    log(f"[wide passes] launches of the two passes (pass 1 on the tensor "
        f"cores, pass 2): wide on (3 iterations) "
        f"{[launches_on[k] for k in MMA_PASSES]}, wide off (2 iterations) "
        f"{[launches_off[k] for k in MMA_PASSES]}, over {n_chunks} chunks an "
        f"iteration ({len(chunks_x)} split X, {len(chunks_t)} theta)")
    for launches, iters in ((launches_on, ITERS), (launches_off, 2)):
        if launches["wide_span_gram_mma"] != launches["wide_span_solve"] or \
                launches["wide_span_gram_mma"] < n_chunks * iters:
            raise AssertionError("a 256-lane chunk did not run the tensor-"
                                 "core pass 1")

    # ---- 5d. K8's path: no route of ALS calls it (as in the JAX
    # package), so its public wrapper runs over every theta chunk on a G
    # gathered with torch from the bf16 table (the two passes, pass 1 on
    # the tensor cores reading the slabs, counted under their own names;
    # the FMA kernel never), each chunk equal bit for bit to K1 at f=256
    # as routed on that table; then the populous chunk once on a float32
    # G (the FMA kernel, once) against K1's uncut kernel on a float32 copy
    # of the table (the FMA body both keep)
    kw = dict(cg_iters=cfg_w.cg_iters, cg_tol=cfg_w.cg_tol)
    k8_ok = True
    k8_launches = dict.fromkeys(("fused_gram_cg_cat",) + MMA_PASSES, 0)
    for ch in chunks_t:
        x0 = chunk_x0(ch, theta_t)
        g1, g2 = gathered_slabs(x_ext, ch, f2)
        cs.reset_launch_counts()
        x8, se8 = cs.fused_gram_cg_cat(g1, g2, ch.vals, ch.nnz, x0,
                                       cfg_w.lam, **kw)
        torch.cuda.synchronize()
        for k in k8_launches:
            k8_launches[k] += cs.LAUNCHES[k]
        del g1, g2
        x1, se1 = cs.gather_gram_cg(x_ext, ch.cols, ch.vals, ch.nnz, x0,
                                    cfg_w.lam, **kw)
        k8_ok &= torch.equal(x8, x1) and torch.equal(se8, se1)
        k8_ok &= bool(torch.isfinite(x8).all())
    log(f"[K8 path] fused_gram_cg_cat over the {len(chunks_t)} theta "
        f"chunks, bf16 G: launches {k8_launches}, every chunk equal bit for "
        f"bit to K1 at f=256 routed on the bf16 table: {k8_ok}")
    if k8_launches["fused_gram_cg_cat"] or \
            min(k8_launches[k] for k in MMA_PASSES) < len(chunks_t) or \
            not k8_ok:
        raise AssertionError("K8 path failed")
    x_ext32 = x_ext.float()
    x0 = chunk_x0(populous, theta_t)
    g1, g2 = gathered_slabs(x_ext32, populous, f2)
    cs.reset_launch_counts()
    x8, se8 = cs.fused_gram_cg_cat(g1, g2, populous.vals, populous.nnz, x0,
                                   cfg_w.lam, **kw)
    fma_ok = {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "fused_gram_cg_cat": 1}
    k8_launches["fused_gram_cg_cat"] += cs.LAUNCHES["fused_gram_cg_cat"]
    del g1, g2
    x1, se1 = cs.gather_gram_cg(x_ext32, populous.cols, populous.vals,
                                populous.nnz, x0, cfg_w.lam, spans=1, **kw)
    worst = (x8 - x1).abs().max().item()
    fma_ok &= bool(((x8 - x1).abs() <= 1e-5 * x1.abs() + 1e-6).all())
    fma_ok &= bool(((se8 - se1).abs() <= 1e-5 * se1.abs() + 1e-6).all())
    del x_ext32, x8, se8, x1, se1
    log(f"[K8 path] theta most populous on a float32 G (the FMA kernel): "
        f"max|x - x_K1|={worst:.3e} against K1's uncut kernel at f=256 on "
        f"the float32 table (limit rtol 1e-5 + 1e-6: {fma_ok})")
    if not fma_ok:
        raise AssertionError("K8 path failed on a float32 G")

    results["gather_gram_cg"].update(
        {f"f256_{k}": v for k, v in k1_256.items()},
        f256_routed={label: v for (key, label), v in routed.items()
                     if key == "K1"},
        f256_launches=launches_off["wide_span_gram_mma"],
        f256_launches_path="ALS.run F=200 wide off (bf16): the two passes",
        f256_cut={k: v for k, v in cuts.items() if k.startswith("K1")})
    for k in MMA_PASSES:
        results[k]["launches_wide_off"] = launches_off[k]
        results[k]["launches_path"] = "ALS.run F=200 wide on (bf16)"
    # the FMA-only kernels run on float32 tables: their launches are those
    # of the small float32 card run of 5b
    results["gather_gram_cg_wide"]["launches_path"] = \
        "ALS.run F=130 f32 wide on, scale 0.01 (5b)"
    results["wide_span_gram"]["launches_path"] = \
        "ALS.run F=130 f32 wide on, scale 0.01 (5b)"
    results["fused_gram_cg_cat"].update(
        launches_path="K8's path (5d): the float32-G chunk; its "
        f"{len(chunks_t)} bf16-G chunks launch the two passes "
        "(launches_k8_path of wide_span_gram_mma and wide_span_solve)",
        bf16_route="wide_span_gram_mma + wide_span_solve")
    for k in MMA_PASSES:
        results[k]["launches_k8_path"] = k8_launches[k]
    results["gather_gram_cg_wide"]["phase_totals"] = {
        label: v for (kf2, label), v in totals.items() if kf2}
    results["gather_gram_cg"]["f256_phase_totals"] = {
        label: v for (kf2, label), v in totals.items() if kf2 is None}
    f32_on = small_launches["f32 wide on"]
    return {"gather_gram_cg_wide": f32_on["gather_gram_cg_wide"],
            "wide_span_gram": f32_on["wide_span_gram"],
            "fused_gram_cg_cat": k8_launches["fused_gram_cg_cat"],
            **{k: launches_on[k] for k in MMA_PASSES}}


def run_bench(args, label):
    """`python -m cumf_als_tpu_torch.bench ARGS` in a subprocess from this
    checkout; its stderr is logged, its JSON line returned."""
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, "-m", "cumf_als_tpu_torch.bench", *args], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    for line in out.stderr.splitlines():
        log(f"[{label}] {line}")
    if out.returncode != 0:
        raise AssertionError(f"{label}: the bench exited {out.returncode}")
    line = json.loads(out.stdout.strip().splitlines()[-1])
    log(f"[{label}] {json.dumps(line)} ({time.monotonic() - t0:.1f} s)")
    return line


def bench_main():
    """The bench's main path on the cached Netflix data: the root bench's
    keys, this card, the main path's train RMSE."""
    line = run_bench(["--workload", "netflix", "--iters", str(ITERS),
                      "--repeat", "3"], "bench main")
    want = RECORDED_TRAIN_RMSE["main"]
    if list(line) != BENCH_KEYS + REPEAT_KEYS:
        raise AssertionError(f"bench main: keys {list(line)}")
    if line["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench main: device {line['device']!r}")
    if abs(line["train_rmse_final"] - want) > 1e-3:
        raise AssertionError(f"bench main: train RMSE "
                             f"{line['train_rmse_final']}, recorded {want}")
    if not (math.isfinite(line["value"]) and line["value"] > 0):
        raise AssertionError(f"bench main: value {line['value']}")


def bench_accuracy():
    """Both calibrated contracts under 2^26 ratings, at 10 iterations."""
    for args in (["--workload", "netflix_cal", "--scale", "0.25"],
                 ["--workload", "ml10m_cal"]):
        line = run_bench(args + ["--accuracy-check"], "bench accuracy")
        if list(line) != BENCH_KEYS + ACCURACY_KEYS or \
                line["accuracy_check"] != "pass":
            raise AssertionError(f"bench accuracy: {args[1]} "
                                 f"{line.get('accuracy_check')}")


def workload_data(bench, name, want):
    """A workload at scale 1.0 through the bench's loader, held to its
    recorded counts and CRC-32s (and to those its cache recorded when it
    was written). Returns the data and the loader's seconds."""
    t0 = time.monotonic()
    train, test = bench.load_workload(name, 1.0)
    load_s = time.monotonic() - t0
    crc = bench.dataset_crc32(train, test)
    with open(os.path.join(bench.dataset_dir(name, 1.0), "meta.json")) as fh:
        meta = json.load(fh)
    log(f"[data] {name}: the bench's cache ({meta['entry']['generator']} "
        f"generator): nnz {train.nnz}, nnz_test {test.nnz}, CRC-32 {crc}; "
        f"{load_s:.1f} s to load (generating it on first use)")
    if (train.nnz, test.nnz) != (want["nnz"], want["nnz_test"]) or \
            crc != meta["crc32"] or crc != want["crc32"]:
        raise AssertionError(f"the cached {name} data is not the recorded "
                             f"workload_ratings({name!r}, 1.0, 0)")
    return train, test, load_s


def ooc_run(cs, model, label, expect):
    """model.run for OOC_ITERS iterations with the launch counts and the
    peak device memory read around it alone; `expect`: the launches each
    kernel must make (every other kernel none)."""
    x0, th0 = init_factors_np(model)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cs.reset_launch_counts()
    res = model.run(x0, th0)
    torch.cuda.synchronize()
    launches = {k: v for k, v in cs.LAUNCHES.items() if v}
    peak = torch.cuda.max_memory_allocated()
    per_iter = [h.x_seconds + h.theta_seconds for h in res.history]
    for h in res.history:
        log(f"[{label}] iter {h.iteration}: x {h.x_seconds:.4f} s, theta "
            f"{h.theta_seconds:.4f} s, rmse {h.rmse_seconds:.4f} s, train "
            f"{h.train_rmse:.6f}, test {h.test_rmse:.6f}")
    log(f"[{label}] seconds per iteration (x + theta): "
        f"{[round(t, 4) for t in per_iter]}, median "
        f"{statistics.median(per_iter):.4f}; peak device memory "
        f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} GiB allocated before "
        f"the run); launches {launches}")
    if launches != {k: v for k, v in expect.items() if v}:
        raise AssertionError(f"{label}: launches {launches}, expected "
                             f"{expect}")
    if not all(np.isfinite([h.train_rmse for h in res.history] +
                           [h.test_rmse for h in res.history])):
        raise AssertionError(f"{label}: non-finite RMSE")
    return res, launches, peak


def init_factors_np(model):
    from cumf_als_tpu_torch.data.synthetic import init_factors
    cfg = model.cfg
    return init_factors(cfg.m, cfg.n, cfg.f, seed=0)


def cuda_tensors_of_rows(rows: int):
    """Shapes of the live CUDA tensors with `rows` rows (by their type
    alone: some objects warn when their attributes are read)."""
    import gc
    gc.collect()
    return [tuple(t.shape) for t in gc.get_objects()
            if issubclass(type(t), torch.Tensor) and t.is_cuda and t.dim()
            and t.shape[0] == rows]


def ooc_kernel_checks(cs, ooc, theta_np):
    """K1, K2 and K3 against their plain versions at the shapes the
    out-of-core path gives them. K1 on the X chunk with the most ratings
    at iteration 0's state (table: the initial theta; warm start: the
    initial X), as the Netflix checks hold K1 at the initial factors;
    K2 and K3 on the state the run left: the theta panel chunk with the
    most ratings (table: its X panel from the host store, A in the run's
    accumulator dtype), and the first solve slice of the theta
    accumulators that X gives (warm start: the run's theta). Returns ok
    and each kernel's numbers."""
    from types import SimpleNamespace
    from cumf_als_tpu_torch.ops.gram import extend_table
    cfg, dev = ooc.cfg, torch.device(DEV)
    n, f_pad = ooc.plan_theta.num_rows, cfg.f_pad

    def padded(arr):
        out = torch.zeros((arr.shape[0], f_pad), dtype=torch.float32)
        out[:, :cfg.f] = torch.from_numpy(np.asarray(arr, np.float32))
        return out.to(dev)

    def most_rated(plan):
        return max(range(len(plan.chunks)),
                   key=lambda i: int(plan.chunks[i].nnz.sum()))

    x0, th0 = init_factors_np(ooc)
    theta0 = padded(th0) * torch.from_numpy(
        ooc.plan_theta.row_nnz > 0).to(dev)[:, None]
    i = most_rated(ooc.plan_x)
    (c,), _ = ooc._host_x.upload(i, i + 1, dev)
    k = c.n_real
    ch = SimpleNamespace(cols=c.cols, vals=c.vals, nnz=c.nnz, rows=c.rows,
                         n_real=k, rows_real=torch.arange(k, device=dev))
    current = padded(x0[c.rows[:k].cpu().numpy()])   # all rated rows
    ok1, k1 = check_k1(cs, extend_table(theta0.to(torch.bfloat16)), ch,
                       current, cfg, f"out-of-core X chunk {i} of "
                       f"{len(ooc.plan_x.chunks)}, iteration 0")
    del current, ch, c, theta0
    theta = padded(theta_np)

    j = most_rated(ooc.plan_theta)
    (c,), _ = ooc._host_th.upload(j, j + 1, dev)
    s = ooc.plan_theta.panel_size
    lo, hi = c.panel * s, min(c.panel * s + s, ooc.plan_theta.num_cols)
    tp = torch.zeros((s + 1, f_pad), dtype=torch.bfloat16, device=dev)
    tp[:hi - lo] = ooc.x_store[lo:hi].to(dev)
    ok2, k2 = check_gram(cs, tp, c, ooc.accum_dtype, False,
                         f"out-of-core theta chunk {j} of "
                         f"{len(ooc.plan_theta.chunks)}")
    del tp, c

    a_buf, b_buf = ooc.theta_accumulators()
    theta_pad = torch.nn.functional.pad(theta, (0, 0, 0, ooc.n_pad - n))
    ok3, k3 = check_k3(cs, a_buf, b_buf, theta_pad, ooc._theta_nnz_pad, 0,
                       ooc.solve_batch, cfg)
    del a_buf, b_buf, theta_pad, theta
    torch.cuda.empty_cache()
    return ok1 and ok2 and ok3, {"gather_gram_cg": k1,
                                 "gather_gram_out": k2, "solve_cg_reg": k3}


def out_of_core(cs, bench):
    """Phase 9: OutOfCoreALS at full width on hugewiki_mini (scale 1.0,
    the native generator's data, CRC-32s pinned), against the in-core ALS
    with the same settings (X and theta direct), then once through the
    bench. Returns the out-of-core run's launches and the numbers of K1,
    K2 and K3 held against their plain versions at its shapes."""
    from cumf_als_tpu_torch import native
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
    from cumf_als_tpu_torch.utils.plan_cache import cached_transpose
    if not native.available():
        raise AssertionError("the native data plane is not built")
    train, test, load_s = workload_data(bench, "hugewiki_mini",
                                        RECORDED_HUGEWIKI_MINI)
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=100,
                    nnz=train.nnz, nnz_test=test.nnz, lam=0.048,
                    iters=OOC_ITERS, solver="cg", backend="pallas",
                    factor_dtype="bf16", gram_dtype="bf16",
                    plan_cache_dir=bench.plan_cache_dir(), verbose=False,
                    debug_timing=False)
    t0 = time.monotonic()
    csc = cached_transpose(cfg.plan_cache_dir, train)
    csc_s = time.monotonic() - t0
    t0 = time.monotonic()
    ooc = OutOfCoreALS(cfg.replace(host_offload_x=True), train, csc, test,
                       device="cuda")
    log(f"[ooc] set-up with the native library: data {load_s:.1f} s, CSC "
        f"{csc_s:.1f} s, out-of-core plans and pinned buffers "
        f"{time.monotonic() - t0:.1f} s (cached in {cfg.plan_cache_dir}); "
        f"X phase {len(ooc.plan_x.chunks)} chunks, theta phase "
        f"{len(ooc.plan_theta.chunks)} chunks over "
        f"{ooc.plan_theta.n_panels} X panels of "
        f"{ooc.plan_theta.panel_size} rows, {ooc.n_slices} solve slices of "
        f"{ooc.solve_batch}; theta accumulators {ooc.accum_dtype}")
    if not ooc.x_store.is_pinned():
        raise AssertionError("the X store is not pinned host memory")
    n = OOC_ITERS
    expect = {"gather_gram_cg": len(ooc.plan_x.chunks) * n,
              "gather_gram_out": len(ooc.plan_theta.chunks) * n,
              "solve_cg_reg": ooc.n_slices * n}
    res_o, launches, peak_o = ooc_run(cs, ooc, "ooc", expect)
    full_x = cuda_tensors_of_rows(train.num_rows)
    log(f"[ooc] live CUDA tensors of X's {train.num_rows} rows after the "
        f"run: {full_x}")
    if full_x:
        raise AssertionError("a device tensor of X's full shape is live")
    checks_ok, checks = ooc_kernel_checks(cs, ooc, res_o.theta)
    if not checks_ok:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the out-of-core path's shapes")
    acc = ooc.accum_dtype
    del ooc
    torch.cuda.empty_cache()

    t0 = time.monotonic()
    inc = ALS(cfg.replace(use_panels="never", train_rmse_method="direct"),
              train, csc, test, device="cuda")
    log(f"[in-core] plans {time.monotonic() - t0:.1f} s; X phase "
        f"{len(inc.plan_x[1])} chunks, theta phase {len(inc.plan_theta[1])} "
        f"chunks (both direct)")
    res_i, _, peak_i = ooc_run(cs, inc, "in-core", {
        "gather_gram_cg": (len(inc.plan_x[1]) + len(inc.plan_theta[1])) * n})
    del inc
    torch.cuda.empty_cache()
    worst = 0.0
    for ho, hi in zip(res_o.history, res_i.history):
        d = max(abs(ho.train_rmse - hi.train_rmse),
                abs(ho.test_rmse - hi.test_rmse))
        worst = max(worst, d)
        log(f"[ooc | in-core] iter {ho.iteration}: train {ho.train_rmse:.6f}"
            f" | {hi.train_rmse:.6f}, test {ho.test_rmse:.6f} | "
            f"{hi.test_rmse:.6f} (limit 2e-3)")
    x_ok = np.allclose(res_o.x, res_i.x, rtol=2e-2, atol=2e-2)
    th_ok = np.allclose(res_o.theta, res_i.theta, rtol=2e-2, atol=2e-2)
    log(f"[ooc | in-core] max|x diff| {np.abs(res_o.x - res_i.x).max():.3e},"
        f" max|theta diff| {np.abs(res_o.theta - res_i.theta).max():.3e} "
        f"(rtol, atol 2e-2); peak device memory {peak_o / 2**30:.2f} | "
        f"{peak_i / 2**30:.2f} GiB; accumulators {acc} | none (direct)")
    if worst > 2e-3 or not (x_ok and th_ok):
        raise AssertionError("out-of-core and in-core runs disagree")
    if not peak_o < peak_i:
        raise AssertionError("the out-of-core run's peak device memory is "
                             "not below the in-core run's")
    line = run_bench(["--workload", "hugewiki_mini", "--out-of-core",
                      "--iters", str(OOC_ITERS)], "bench ooc")
    if list(line) != BENCH_KEYS or \
            line["device"] != torch.cuda.get_device_name(0):
        raise AssertionError(f"bench ooc: {line}")
    if abs(line["train_rmse_final"] - res_o.history[-1].train_rmse) > 2e-3:
        raise AssertionError("bench ooc: train RMSE off the phase's run")
    return launches, checks


def sharded_log(label, history, peak, launches, what):
    """The per-iteration lines and the summary line of a sharded run."""
    for h in history:
        log(f"[{label}] iter {h.iteration}: x {h.x_seconds:.4f} s, theta "
            f"{h.theta_seconds:.4f} s, rmse {h.rmse_seconds:.4f} s, train "
            f"{h.train_rmse:.6f}, test {h.test_rmse:.6f}")
    per_iter = [h.x_seconds + h.theta_seconds for h in history]
    log(f"[{label}] {what} seconds per iteration (x + theta): "
        f"{[round(t, 4) for t in per_iter]}, median "
        f"{statistics.median(per_iter):.4f}; peak device memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}; "
        f"launches { {k: v for k, v in launches.items() if v} }")


def rmse_gaps(label, hist, ref, ref_label, limit=2e-3):
    """Train and test RMSE of `hist` against `ref`, iteration by
    iteration (as far as both go); raises past `limit`."""
    worst = 0.0
    for h, r in zip(hist, ref):
        worst = max(worst, abs(h.train_rmse - r.train_rmse),
                    abs(h.test_rmse - r.test_rmse))
        log(f"[{label} | {ref_label}] iter {h.iteration}: train "
            f"{h.train_rmse:.6f} | {r.train_rmse:.6f}, test "
            f"{h.test_rmse:.6f} | {r.test_rmse:.6f} (limit {limit:g})")
    if worst > limit:
        raise AssertionError(f"{label}: RMSE off {ref_label} by {worst:.3e}")
    return worst


def sharded_profile(model, x0, th0):
    """The device-busy share of one traced iteration of `model` (its X
    and theta phases from the initial factors, set up outside the trace):
    the union of the CUDA activities' intervals over the window's wall
    time, from torch.profiler (None when the trace holds no device
    activity). Traced: the profiler's own cost is in the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = model.shard_x(x0 * (np.diff(model.train_csr.indptr) > 0)[:, None])
    theta = model.replicate_theta(
        th0 * (np.diff(model.train_csc.indptr) > 0)[:, None])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        x = model.x_phase(theta, x)
        theta, se = model.theta_phase(x, theta)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for a, b in spans:   # the union of the intervals, in us
        if b > end:
            busy += b - max(a, end)
            end = b
    if not spans:
        log("[profile] the trace holds no device activity: device-busy "
            "share not measured")
        return None
    share = busy * 1e-6 / wall
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    log(f"[profile] one traced iteration (X and theta phases) of the "
        f"sharded run at one rank: wall {wall:.4f} s, device busy "
        f"{busy / 1e3:.1f} ms (the union of {len(spans)} CUDA activities), "
        f"device-busy share {share:.3f} (traced); most self device time: "
        f"{[(e.key[:48], round(e.self_device_time_total / 1e3, 2)) for e in top[:6]]}")
    return share


def sharded(cs, bench, cfg, train, test, hist_main):
    """Phase 10: ShardedALS on the Netflix data at full width (F=100,
    bf16, CG, "pallas"), (a) at one rank on an NCCL group of one, 3
    iterations, against phase 4a's ALS run; (b) at two ranks on the one
    card, both on cuda:0 over gloo (NCCL refuses two ranks on one card),
    spawned, 2 iterations, against (a). Launch counts equal the plans'
    counts; K1 (a), K2 and K3 (b) are held to their plain versions at the
    sharded shapes. Returns the launches and the checks' numbers."""
    import functools

    import torch.distributed as dist

    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.parallel.mesh import (Mesh, free_port,
                                                  init_distributed, spawn)
    from cumf_als_tpu_torch.parallel.sharded_als import (ShardedALS,
                                                         run_rank)
    from cumf_als_tpu_torch.utils.plan_cache import cached_transpose
    scfg = cfg.replace(plan_cache_dir=bench.plan_cache_dir(), verbose=False,
                       debug_timing=True, iters=ITERS)
    t0 = time.monotonic()
    csc = cached_transpose(scfg.plan_cache_dir, train)   # the ranks' too
    log(f"[sharded] CSC through the plan cache {time.monotonic() - t0:.1f} "
        f"s ({scfg.plan_cache_dir})")
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    dev = torch.device(DEV, 0)
    launches, checks = {}, {}

    # (a) one rank on an NCCL group of one
    mesh = init_distributed("nccl", f"tcp://localhost:{free_port()}", 1, 0,
                            device=dev)
    try:
        t0 = time.monotonic()
        one = ShardedALS(scfg, train, csc, test, mesh=mesh)
        if one.x_steps is None or not one.single_fused():
            raise AssertionError("expected the panel X route and K1 on theta")
        slices = one._x_m_pad // one._x_solve_batch
        blocks = one._blocks
        log(f"[sharded one rank] plans {time.monotonic() - t0:.1f} s "
            f"(built once into the plan cache); backend "
            f"{mesh.backend}, world {mesh.world_size}; X {len(one.x_steps)} "
            f"panel steps over {one.x_n_panels} panels, {slices} solve "
            f"slices of {one._x_solve_batch}; theta {len(blocks)} reduce "
            f"blocks, K1 on each")
        expect = {"gather_gram_cg": ITERS * len(blocks),
                  "gather_gram_out": ITERS * len(one.x_steps),
                  "solve_cg_reg": ITERS * slices}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cs.reset_launch_counts()
        res = one.run(x0, th0)
        torch.cuda.synchronize()
        got = {k: v for k, v in cs.LAUNCHES.items() if v}
        sharded_log("sharded one rank", res.history,
                    torch.cuda.max_memory_allocated(), got, "NCCL, one card:")
        if got != expect:
            raise AssertionError(f"sharded one rank: launches {got}, the "
                                 f"plans say {expect}")
        launches["one_rank"] = expect
        rmse_gaps("sharded one rank", res.history, hist_main, "main")
        # K1 on the most populous reduce block at the initial factors (a
        # stand-in X: the real one starts at zero), as phase 2a holds it
        gen = torch.Generator(device=DEV).manual_seed(1)
        x_t = one.shard_x((0.2 * torch.rand((cfg.m, cfg.f), generator=gen,
                                            device=DEV)).cpu().numpy())
        theta_t = one.replicate_theta(
            th0 * (np.diff(csc.indptr) > 0)[:, None])
        i = max(range(len(blocks)),
                key=lambda k: blocks[k].rows.shape[0] * blocks[k].width)
        ok, checks["gather_gram_cg"] = check_k1(
            cs, ext16(x_t), blocks[i], theta_t, scfg,
            f"sharded one rank: reduce block {i} of {len(blocks)}")
        if not ok:
            raise AssertionError("K1 disagrees at the sharded shapes")
        del x_t, theta_t
        share = sharded_profile(one, x0, th0)
        checks["gather_gram_cg"]["device_busy_share_traced"] = share
        del one
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # (b) two ranks on the one card over gloo, spawned
    its = 2
    t0 = time.monotonic()
    ranks = spawn(2, run_rank, scfg.replace(iters=its),
                  functools.partial(bench.load_workload, "netflix", 1.0),
                  x0, th0, backend="gloo", device=DEV + ":0", timeout=900)
    log(f"[sharded two ranks] spawned, built and ran in "
        f"{time.monotonic() - t0:.1f} s")
    for r, out in enumerate(ranks):
        sharded_log(f"sharded two ranks, rank {r}", out["history"],
                    out["peak_bytes"], out["launches"],
                    "gloo over one card (two processes on cuda:0, the "
                    "partials through host memory; not a multi-GPU time):")
        want = {"gather_gram_out": its * (out["x_steps"] + out["n_blocks"]),
                "solve_cg_reg": its * (out["x_slices"] + out["n_blocks"])}
        got = {k: v for k, v in out["launches"].items() if v}
        if got != want:
            raise AssertionError(f"rank {r}: launches {got}, the plans say "
                                 f"{want}")
        if not np.array_equal(out["x"][out["own_ids"]], out["own_x"]):
            raise AssertionError(f"rank {r}: gathered X is not its rows")
        rmse_gaps(f"sharded two ranks, rank {r}", out["history"],
                  res.history, "one rank")
    launches["two_ranks_each"] = want
    same = ranks[0]["theta_sha256"] == ranks[1]["theta_sha256"] and \
        np.array_equal(ranks[0]["x"], ranks[1]["x"])
    log(f"[sharded two ranks] theta SHA-256 after each iteration, rank 0 "
        f"{[d[:12] for d in ranks[0]['theta_sha256']]}, rank 1 "
        f"{[d[:12] for d in ranks[1]['theta_sha256']]}: equal bit for bit "
        f"{same}")
    if not same:
        raise AssertionError("the two ranks' theta (or X) differ")

    # K2 on rank 0's most populous theta partial (bf16 A) and K3 on that
    # block summed over both ranks as the all-reduce sums it (bf16 A: one
    # rounded add), at the final factors: each rank's view rebuilt here
    # from the plan cache (a Mesh of that rank with no group)
    views = [ShardedALS(scfg, train, csc, None,
                        mesh=Mesh(rank=r, world_size=2, device=dev))
             for r in range(2)]
    tables = [ext16(v.shard_x(ranks[0]["x"])) for v in views]
    blocks = views[0]._blocks
    i = max(range(len(blocks)),
            key=lambda k: blocks[k].rows.shape[0] * blocks[k].width)
    ok2, checks["gather_gram_out"] = check_gram(
        cs, tables[0], blocks[i], torch.bfloat16, False,
        f"sharded two ranks: rank 0's partial of reduce block {i} of "
        f"{len(blocks)}")
    parts = [cs.gather_gram_out(t, v._blocks[i].cols, v._blocks[i].vals,
                                out_dtype=torch.bfloat16)
             for t, v in zip(tables, views)]
    a = (parts[0][0].float() + parts[1][0].float()).to(torch.bfloat16)
    b = parts[0][1] + parts[1][1]
    theta = views[0].replicate_theta(ranks[0]["theta"])
    ok3, checks["solve_cg_reg"] = check_k3(
        cs, a, b, chunk_x0(blocks[i], theta), blocks[i].nnz, 0,
        a.shape[0], scfg, what=f"reduce block {i} summed over the two ranks")
    del views, tables, parts, a, b, theta
    torch.cuda.empty_cache()
    if not (ok2 and ok3):
        raise AssertionError("K2 or K3 disagrees at the sharded shapes")
    return launches, checks


def batched_models(ALS, cfg, train, csc, test, gram_dtype):
    """The batched-panel model (X in 5 row batches of 4096) and the panel
    model it is held against, both built from a config with this
    gram_dtype."""
    from cumf_als_tpu_torch.ops.tiling import (BatchedPanelPlan, PanelPlan,
                                               UpdatePlan)
    base = cfg.replace(solver="cholesky", gram_dtype=gram_dtype,
                       verbose=False)
    t0 = time.monotonic()
    batched = ALS(base.replace(panel_budget_bytes=1 << 29, batch_rows=4096),
                  train, csc, test, device="cuda")
    panel = ALS(base, train, csc, test, device="cuda")
    plan = batched.plan_x[0]
    if not (isinstance(plan, BatchedPanelPlan) and len(plan.batches) == 5
            and isinstance(batched.plan_theta[0], UpdatePlan)
            and isinstance(panel.plan_x[0], PanelPlan)):
        raise AssertionError(f"{gram_dtype}: expected 5 row batches of X "
                             "and direct theta")
    log(f"[batched panel] {gram_dtype} plans {time.monotonic() - t0:.1f} "
        f"s; X phase: {len(plan.batches)} batches of {plan.batch_rows} "
        f"rows, {sum(len(b.plan.chunks) for b in plan.batches)} chunks "
        f"(the panel route: {len(panel.plan_x[1])}); theta: "
        f"{len(batched.plan_theta[1])} direct chunks")
    return batched, panel


def x_row_terms(batched_plan, panel_plan, m):
    """Per X row, the larger of the two routes' count of partials added
    into its accumulator (its subrows, d) and its longest subrow (w): the
    terms of `x_phase_rows`' bound."""
    depth = np.zeros((2, m), np.int64)
    width = np.zeros((2, m), np.int64)

    def add(k, rows, nnz):
        np.add.at(depth[k], rows, 1)
        np.maximum.at(width[k], rows, nnz)

    for c in panel_plan.chunks:
        live = c.nnz > 0
        add(0, c.rows[live], c.nnz[live])
    for b in batched_plan.batches:
        for c in b.plan.chunks:
            live = c.nnz > 0
            add(1, b.global_ids[c.rows[live]], c.nnz[live])
    return depth.max(axis=0), width.max(axis=0)


def iteration0_theta(model, th0):
    """The table the first X phase of `model.run(x0, th0)` reads."""
    theta = model._pad_f(th0)
    theta *= torch.from_numpy(
        np.diff(model.train_csc.indptr) > 0).to(DEV)[:, None]
    return theta


def x_phase_rows(batched, panel, theta):
    """One X phase of each route on the same theta, row by row.

    Grams: every batch's accumulators (A, b) against the panel route's at
    the batch's global ids, entry by entry. With theta >= 0 and ratings
    > 0 every partial is >= 0 entry by entry, so the partials of a row
    sum in absolute value to A and b themselves, and a route's sums lie
    within (w 2^-22 + d u + u_p) of them: the kernel's f32 sum over a
    subrow's w live slots (2^-22 a slot leaves room for tensor cores that
    truncate), one rounding to the accumulator's unit u (2^-9 bf16, 2^-24
    f32) per partial added, and u_p = 2^-9 for a bf16 partial (b is f32:
    its u is 2^-24, u_p 0). The two routes may differ by twice that;
    another 10% covers taking the panel route's A for the exact one.
    Returns the largest |difference| / bound of A and of b, which must be
    at most 1.

    Solutions: both routes start from a sentinel; every row with ratings
    must be written, and the per-row relative difference of x is
    returned (its limit is the caller's)."""
    from cumf_als_tpu_torch.models.als import accumulate_into
    plan, _, aux = batched.plan_x
    m = plan.num_rows
    if not bool((theta >= 0).all()):
        raise AssertionError("the bound needs theta >= 0")
    depth, width = x_row_terms(plan, panel.plan_x[0], m)
    depth = torch.from_numpy(depth).to(DEV, torch.float32)
    width = torch.from_numpy(width).to(DEV, torch.float32)
    a_p, b_p = panel.accumulate_panels(theta, panel.plan_x)
    bf16 = a_p.dtype == torch.bfloat16
    u_a = 2.0 ** -9 if bf16 else 2.0 ** -24
    term_a = 2.2 * (width * 2.0 ** -22 + depth * u_a
                    + (2.0 ** -9 if bf16 else 0.0))
    term_b = 2.2 * (width * 2.0 ** -22 + depth * 2.0 ** -24)
    table_pad = batched._panel_table(
        theta, -(-plan.num_cols // plan.panel_size), plan.panel_size)
    a_full, b_full = batched._accumulators(plan.batch_rows + 1, a_p.dtype)
    worst_a = worst_b = 0.0
    for gids, _, chunks in aux["batches"]:
        a_full.zero_()
        b_full.zero_()
        accumulate_into(a_full, b_full, table_pad, chunks, plan.panel_size,
                        batched.cfg.backend == "pallas")
        k = gids.shape[0]
        want = a_p.index_select(0, gids).float()
        bound = term_a[gids][:, None, None] * want.abs()
        diff = (a_full[:k].float() - want).abs()
        worst_a = max(worst_a, (diff / bound.clamp_min(1e-30)).max().item())
        del want, bound, diff
        want = b_p.index_select(0, gids)
        bound = term_b[gids][:, None] * want.abs()
        diff = (b_full[:k] - want).abs()
        worst_b = max(worst_b, (diff / bound.clamp_min(1e-30)).max().item())
    del a_p, b_p, a_full, b_full
    live = torch.from_numpy(np.diff(batched.train_csr.indptr) > 0).to(DEV)
    sentinel = torch.full((m, theta.shape[1]), 7.0, device=DEV)
    gx, _ = batched._update_phase(theta, sentinel.clone(), batched.plan_x,
                                  False)
    px, _ = panel._update_phase(theta, sentinel.clone(), panel.plan_x,
                                False)
    written = bool((~(gx[live] == 7.0).all(dim=1)).all()) and \
        bool((~(px[live] == 7.0).all(dim=1)).all())
    rel = ((gx - px)[live].norm(dim=1)
           / px[live].norm(dim=1).clamp_min(1e-30))
    torch.cuda.synchronize()
    return {"gram_a_of_bound": worst_a, "gram_b_of_bound": worst_b,
            "rows_written": written, "x_rel_max": rel.max().item(),
            "x_rel_p999": rel.quantile(0.999).item(),
            "x_rel_median": rel.median().item(),
            "max_depth": int(depth.max().item()),
            "max_width": int(width.max().item())}


def batched_panel(cs, ALS, cfg, train, csc, test, x0, th0):
    """The batched-panel X route (K2 into 4096-row accumulators, Cholesky)
    against the panel route on the same settings, with f32 and with bf16
    accumulators: one X phase row by row (`x_phase_rows`), then the
    trajectory, each iteration within 1e-3 (train) and 2e-3 (test) of
    the panel route's. With bf16 accumulators a limit widens to the
    distance that bf16 rounding itself puts between the panel route's
    bf16 and f32 runs at that iteration, where that is larger: the order
    of the bf16 adds differs between the routes, and at iteration 1 that
    alone moved the gap from 5.8e-4 to 1.1e-3 over five runs
    (scripts/torch_batched_readings.py). Returns K2's launches on the
    route (bf16, f32)."""
    if not float(train.data.min()) > 0:
        raise AssertionError("the Gram bound needs ratings > 0")
    others = tuple(k for k in REPLACES if k != "gather_gram_out")
    k2, runs = {}, {}
    for gram_dtype in ("f32", "bf16"):
        batched, panel = batched_models(ALS, cfg, train, csc, test,
                                        gram_dtype)
        rows = x_phase_rows(batched, panel, iteration0_theta(panel, th0))
        limit = F32_X_ROW_LIMIT if gram_dtype == "f32" else None
        log(f"[batched panel] {gram_dtype} one X phase against the panel "
            f"route, row by row: {rows} (Gram entries within their "
            f"rounding bound at <= 1; x per row {limit or 'logged'})")
        if not (rows["rows_written"] and rows["gram_a_of_bound"] <= 1.0
                and rows["gram_b_of_bound"] <= 1.0
                and (limit is None or rows["x_rel_max"] <= limit)):
            raise AssertionError(f"{gram_dtype}: the batched-panel X phase "
                                 "differs from the panel route's")
        got, launches = full_width(cs, batched, f"batched {gram_dtype}",
                                   ("gather_gram_out",), others, x0, th0)
        want, _ = full_width(cs, panel, f"panel {gram_dtype}",
                             ("gather_gram_out",), others, x0, th0)
        k2[gram_dtype] = launches["gather_gram_out"]
        runs[gram_dtype] = (got, want)
        del batched, panel
        torch.cuda.empty_cache()
    ok = True
    for gram_dtype in ("f32", "bf16"):
        got, want = runs[gram_dtype]
        for g, w, w32 in zip(got, want, runs["f32"][1]):
            lim_tr, lim_te = 1e-3, 2e-3
            if gram_dtype == "bf16":
                lim_tr = max(lim_tr, abs(w.train_rmse - w32.train_rmse))
                lim_te = max(lim_te, abs(w.test_rmse - w32.test_rmse))
            dtr = abs(g.train_rmse - w.train_rmse)
            dte = abs(g.test_rmse - w.test_rmse)
            log(f"[batched panel] {gram_dtype} iter {g.iteration}: train "
                f"{g.train_rmse:.6f} | panel {w.train_rmse:.6f} (gap "
                f"{dtr:.2e}, limit {lim_tr:.2e}), test {g.test_rmse:.6f} | "
                f"{w.test_rmse:.6f} (gap {dte:.2e}, limit {lim_te:.2e})")
            ok &= dtr <= lim_tr and dte <= lim_te
    if not ok:
        raise AssertionError("the batched-panel route left the panel "
                             "route's trajectory")
    return [k2["bf16"], k2["f32"]]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cumf_als_tpu_torch import bench, native
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   workload_ratings)
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops import _build
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    from cumf_als_tpu_torch.ops.solve import solve
    from cumf_als_tpu_torch.ops.tiling import PanelPlan, UpdatePlan
    from cumf_als_tpu_torch.utils.io import transpose_csr

    # ---- 1. card and build
    card = card_line()
    log(f"[card] {card}")
    log(f"[versions] python {sys.version.split()[0]} torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    short = {(): None, ("--gram",): GRAM_KERNELS,
             ("--theta",): THETA_KERNELS, ("--wide",): WIDE_SHORT,
             ("--ooc",): SPLIT_KERNELS, ("--sharded",): SPLIT_KERNELS}
    if tuple(sys.argv[1:]) not in short:
        print("usage: chip_smoke.py [--gram | --theta | --wide | --ooc | "
              "--sharded]", file=sys.stderr)
        return 2
    only = short[tuple(sys.argv[1:])]
    sharded_only = tuple(sys.argv[1:]) == ("--sharded",)
    t0 = time.monotonic()
    _build.build(only, force=True, ptxas_info=True)
    if set(_build.KERNELS) != set(REPLACES):
        raise AssertionError("the kernel table and this script disagree")
    log(f"[build] {len(_build.BUILD_LOG)} kernels built in "
        f"{time.monotonic() - t0:.1f} s")
    # the native data plane: the data sets are the JAX package's only
    # through it, and the out-of-core plans build through it
    t0 = time.monotonic()
    if not native.available():
        raise AssertionError("the native data plane did not build")
    log(f"[build] native data plane {native.LIB_PATH} in "
        f"{time.monotonic() - t0:.1f} s")
    ptxas_ok = ptxas_lines(_build.BUILD_LOG)
    if only == GRAM_KERNELS:
        ok = ptxas_ok and gram_edges(cs) and gram_synthetic(cs)
        log(f"[gram] {'OK' if ok else 'FAIL'} (the short call: no result "
            f"line)")
        return 0 if ok else 1
    if only == THETA_KERNELS:
        ok = theta_edges(cs) and theta_synthetic(cs)
        if not ok:
            log("[theta] FAIL (the short call: no result line)")
            return 1
    elif only == WIDE_SHORT:
        ok = ptxas_ok and span_gram_edges(cs) and span_edges(cs) and \
            wide_synthetic(cs)
        if not ok:
            log("[wide] FAIL (the short call: no result line)")
            return 1
    elif only == SPLIT_KERNELS and not sharded_only:
        out_of_core(cs, bench)
        log("[ooc] OK (the short call: no result line)")
        return 0
    elif not ptxas_ok:
        raise AssertionError("a tensor-core kernel spills or waits for "
                             "every wgmma")

    # ---- data and plans of the full Netflix shape (shared by 2 and 4),
    # through the bench's loader: generated into its cache on first use
    t0 = time.monotonic()
    train, test, _ = workload_data(bench, "netflix", RECORDED_NETFLIX)
    csc = transpose_csr(train)
    gen_s = time.monotonic() - t0
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=ITERS, backend="pallas",
                          solver="cg", factor_dtype="bf16",
                          gram_dtype="bf16", verbose=True,
                          debug_timing=True)
    if sharded_only:
        x0_np, th0_np = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
        al = ALS(cfg, train, csc, test, device="cuda")
        hist_main, _ = full_width(
            cs, al, "main", SPLIT_KERNELS,
            AUG_KERNELS + WIDE_KERNELS + SPAN_KERNELS + ("solve_cg",),
            x0_np, th0_np)
        del al
        torch.cuda.empty_cache()
        sharded(cs, bench, cfg, train, test, hist_main)
        log("[sharded] OK (the short call: no result line)")
        return 0
    if only == WIDE_SHORT:
        al, cfg_w, f2, _, _, theta_t, x_t, x_ext = wide_setup(
            cs, ALS, cfg, train, csc, test)
        ok = cut_checks(cs, al, cfg_w, f2, theta_t, x_t, x_ext)[0]
        log(f"[wide] {'OK' if ok else 'FAIL'} (the short call: no result "
            f"line)")
        return 0 if ok else 1
    t0 = time.monotonic()
    al = ALS(cfg, train, csc, test, device="cuda")
    plan_s = time.monotonic() - t0
    log(f"[data] netflix scale 1.0: m={train.num_rows} n={train.num_cols} "
        f"nnz={train.nnz} nnz_test={test.nnz}; generation+transpose "
        f"{gen_s:.1f} s, plans (built and moved to the card) {plan_s:.1f} s")
    x_route = type(al.plan_x[0]).__name__
    t_route = type(al.plan_theta[0]).__name__
    log(f"[routes] X phase: {x_route} ({len(al.plan_x[1])} chunks), theta "
        f"phase: {t_route} ({len(al.plan_theta[1])} chunks)")
    if not (isinstance(al.plan_x[0], PanelPlan) and
            isinstance(al.plan_theta[0], UpdatePlan)):
        raise AssertionError("expected the panel X route and direct theta")

    # ---- 2a. the split kernels against their plain versions, at
    # main-path shapes
    x0_np, th0_np = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    theta_t = al._pad_f(th0_np)
    # a stand-in X for the theta-phase table: the real X starts at zero
    x_t = al._pad_f(0.2 * torch.rand((cfg.m, cfg.f), generator=gen,
                                     device="cuda").cpu().numpy())
    table_ext = torch.cat([x_t.to(torch.bfloat16),
                           torch.zeros((1, cfg.f_pad), dtype=torch.bfloat16,
                                       device="cuda")])

    def check_theta(model, c, aug, key):
        """K1 (or, with aug, K6) on the widest, the most populous (fills
        results[key]) and the fewest-row theta chunk of the model's
        plan."""
        chunks = model.plan_theta[1]
        ok_all = True
        for label, ch in (
                ("widest", max(chunks, key=lambda c: c.width)),
                ("most populous",
                 max(chunks, key=lambda c: c.rows.shape[0] * c.width)),
                ("fewest rows", min(chunks, key=lambda c: c.rows.shape[0]))):
            ok, res = check_k1(cs, table_ext, ch, theta_t, c, label, aug=aug)
            ok_all &= ok
            if label == "most populous":
                results[key] = dict(res, **results.get(key, {}))
            else:
                tag = label.split()[0]
                results.setdefault(key, {}).update(
                    {f"{tag}_{k}": res[k] for k in ("ms", "max_abs_err",
                                                    "bound_ms")},
                    **{f"{tag}_shape": list(ch.cols.shape)})
        return ok_all

    def totals(model, names):
        th, x, gram_tot = phase_totals(cs, model, theta_t, x_t)
        n_x = len(model.plan_x[1])
        log(f"[phase totals] {names[0]} over the {len(model.plan_theta[1])} "
            f"theta chunks {th['total']:.1f} ms, of which {th['few']:.1f} ms "
            f"in the {th['n_few']} chunks with fewer than {th['sms']} rows "
            f"(the longest of them, ms and (R, P): "
            f"{[(round(m, 3), rp) for m, rp in th['longest_few']]}); "
            f"{names[1]} over the {n_x} X "
            f"chunks {x['total']:.1f} ms, of which {x['few']:.1f} ms in the "
            f"{x['n_few']} chunks with fewer than {x['sms']} rows (the "
            f"longest of them, ms and (R, P): "
            f"{[(round(m, 3), rp) for m, rp in x['longest_few']]}; device "
            f"time between events, launches queued behind other work); "
            f"the widest chunk: {x['widest']} slots; it "
            f"gathered "
            f"{x['gathered'] / 1e9:.2f} GB from the L2 and wrote "
            f"{x['written'] / 1e9:.2f} GB, "
            f"{x['gathered'] / x['total'] / 1e9:.3f} TB/s gathered over the "
            f"phase; X-phase Gram step ({names[1]} + index_add_) "
            f"{gram_tot:.1f} ms")

    def x_chunks_and_panels(model):
        """The most populous, the widest and the fewest-row chunk of the
        X phase, each with its panel's zero-extended bf16 table."""
        plan, chunks, _ = model.plan_x
        s = plan.panel_size
        th16 = torch.nn.functional.pad(
            theta_t.to(torch.bfloat16),
            (0, 0, 0, plan.n_panels * s - theta_t.shape[0]))
        picks = (("most populous",
                  max(chunks, key=lambda c: c.rows.shape[0] * c.width)),
                 ("widest", max(chunks, key=lambda c: c.width)),
                 ("fewest rows", min(chunks, key=lambda c: c.rows.shape[0])))
        return [(label, ch, torch.cat(
            [th16[ch.panel * s:(ch.panel + 1) * s],
             th16.new_zeros((1, cfg.f_pad))])) for label, ch in picks]

    def check_grams(model, aug, a_dtype, key):
        """K2 (or, with aug, K5a) on the three chunks (the most populous fills
        results[key], the other two add their times to it), on the most
        populous also with the other A dtype, and on the widest and the
        fewest-row chunk with a float32 table, which takes the FMA body."""
        ok_all = True
        for label, ch, tp in x_chunks_and_panels(model):
            ok, res = check_gram(cs, tp, ch, a_dtype, aug, label)
            ok_all &= ok
            if label == "most populous":
                results[key] = res
                other = torch.float32 if a_dtype == torch.bfloat16 else \
                    torch.bfloat16
                ok, res = check_gram(cs, tp, ch, other, aug, label)
                ok_all &= ok
                tag = "f32_out" if other == torch.float32 else "bf16_out"
                results[key].update({f"{tag}_{k}": res[k]
                                     for k in ("ms", "max_abs_err")})
            else:
                tag = label.split()[0]
                results[key].update(
                    {f"{tag}_{k}": v for k, v in res.items()},
                    **{f"{tag}_shape": list(ch.cols.shape)})
                ok, _ = check_gram(cs, tp.float(), ch, torch.float32, aug,
                                   label + ", float32 table")
                ok_all &= ok
        return ok_all

    results, ok_all = {}, True
    ok_all &= check_theta(al, cfg, False, "gather_gram_cg")
    if only == THETA_KERNELS:
        # K6 on the same chunks: lane 127 of the table is free at F=100
        ok_all &= check_theta(al, cfg, True, "gather_gram_cg_aug")
        ok_all &= ptxas_ok
        log(f"[theta] {'OK' if ok_all else 'FAIL'} (the short call: no "
            f"result line)")
        return 0 if ok_all else 1
    ok_all &= theta_edges(cs)

    plan_x, chunks_x, aux_x = al.plan_x
    a_dtype = al._accum_dtype(sum(c.rows.shape[0] for c in chunks_x),
                              plan_x.num_rows)
    ok_all &= gram_edges(cs)
    ok_all &= check_grams(al, False, a_dtype, "gather_gram_out")

    a_buf, b_buf = al.accumulate_panels(theta_t, al.plan_x)
    x0_full = torch.zeros((aux_x["m_pad"], cfg.f_pad), device="cuda")
    ok, results["solve_cg_reg"] = check_k3(
        cs, a_buf, b_buf, x0_full, aux_x["row_nnz_pad"], 0,
        aux_x["solve_batch"], cfg)
    ok_all &= ok
    del a_buf, b_buf, x0_full
    totals(al, ("K1", "K2"))
    torch.cuda.empty_cache()
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # ---- 3. small Netflix-shaped runs: card against CPU. The f32 limits
    # are those of the CPU tests: the card's f32 index_add_ adds with
    # atomics in an order that changes from run to run, which moves the
    # accumulators by rounding only.
    str_, ste = workload_ratings("netflix", scale=0.01, seed=1)
    scfg = cfg.replace(m=str_.num_rows, n=str_.num_cols, nnz=str_.nnz,
                       nnz_test=ste.nnz, panel_size=2048, verbose=False,
                       debug_timing=False)
    sx0, sth0 = init_factors(scfg.m, scfg.n, scfg.f, seed=0)
    for label, extra, aug_panel, lim_tr, lim_te in (
            ("bf16", {}, False, 5e-3, 1e-2),
            ("f32 aug auto", dict(gram_dtype="f32"), True, 1e-3, 1e-3),
            ("f32 aug force", dict(gram_dtype="f32", aug_gram="force"),
             True, 1e-3, 1e-3)):
        small = {}
        for dev in ("cuda", "cpu"):
            model = ALS(scfg.replace(**extra), str_, None, ste, device=dev)
            assert isinstance(model.plan_x[0], PanelPlan)
            assert isinstance(model.plan_theta[0], UpdatePlan)
            assert model._use_panel_aug() == aug_panel
            small[dev] = model.run(sx0, sth0).history
        for hg, hc in zip(small["cuda"], small["cpu"]):
            dtr = abs(hg.train_rmse - hc.train_rmse)
            dte = abs(hg.test_rmse - hc.test_rmse)
            log(f"[small {label}] iter {hg.iteration}: card train "
                f"{hg.train_rmse:.6f} test {hg.test_rmse:.6f} | cpu train "
                f"{hc.train_rmse:.6f} test {hc.test_rmse:.6f} (limits "
                f"{lim_tr:g}, {lim_te:g})")
            if not (dtr <= lim_tr and dte <= lim_te):
                raise AssertionError("card and CPU runs disagree")

    # ---- 4a. the bf16 path at full width (split buffers: K1, K2, K3)
    log(f"[main] data {gen_s:.1f} s, plans {plan_s:.1f} s")
    hist_main, launches = full_width(
        cs, al, "main", SPLIT_KERNELS,
        AUG_KERNELS + WIDE_KERNELS + SPAN_KERNELS + ("solve_cg",), x0_np,
        th0_np)
    del al, plan_x, chunks_x, aux_x   # frees the plans on the card
    torch.cuda.empty_cache()

    # ---- 2b. the augmented kernels and K4 against their plain versions,
    # on the plans of this slice's configuration
    cfg_aug = cfg.replace(gram_dtype="f32", aug_gram="force")
    t0 = time.monotonic()
    al_aug = ALS(cfg_aug, train, csc, test, device="cuda")
    log(f"[aug] plans of the f32 aug_gram=force configuration "
        f"{time.monotonic() - t0:.1f} s")
    if not (isinstance(al_aug.plan_x[0], PanelPlan) and
            isinstance(al_aug.plan_theta[0], UpdatePlan) and
            al_aug._use_panel_aug() and cs.aug_enabled(cfg_aug)):
        raise AssertionError("expected the aug panel X route and the aug "
                             "direct theta route")
    ok_all &= check_theta(al_aug, cfg_aug, True, "gather_gram_cg_aug")
    ok_all &= check_grams(al_aug, True, torch.float32,
                          "gather_gram_aug_out")

    aux_x = al_aug.plan_x[2]
    batch, m_pad = aux_x["solve_batch"], aux_x["m_pad"]
    a_aug, none = al_aug.accumulate_panels(theta_t, al_aug.plan_x)
    if none is not None or a_aug.dtype != torch.float32:
        raise AssertionError("expected one f32 augmented accumulator")
    x0_full = torch.zeros((m_pad, cfg.f_pad), device="cuda")
    nnzf = aux_x["row_nnz_pad"].float()
    diag_full = nnzf * cfg.lam + (nnzf == 0).float()
    ok, results["solve_cg_aug"] = check_k5b(
        cs, a_aug[:batch], diag_full[:batch], x0_full[:batch], cfg_aug)
    ok_all &= ok

    def regularized(lo):
        """Systems [lo, lo + batch) unpacked, diagonal already added."""
        ua, ub, _ = cs.unpack_aug(a_aug[lo:lo + batch])
        ua.diagonal(dim1=1, dim2=2).add_(diag_full[lo:lo + batch, None])
        return ua, ub

    a_reg, b_reg = regularized(0)
    ok, results["solve_cg"] = check_k4(cs, solve, a_reg, b_reg,
                                       x0_full[:batch], cfg_aug)
    ok_all &= ok
    del a_reg, b_reg
    if not ok_all:
        raise AssertionError("a kernel disagrees with its plain version")

    # K4's path: the dispatcher without a diagonal over every solve slice,
    # held against the augmented solve of the same systems (K5b adds the
    # same diagonal to the same f32 entries, so the two agree closely)
    kw = dict(solver="cg", cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
              backend="pallas")
    cs.reset_launch_counts()
    k4_err = 0.0
    for lo in range(0, m_pad, batch):
        a_reg, b_reg = regularized(lo)
        x4 = solve(a_reg, b_reg, x0_full[lo:lo + batch], **kw)
        del a_reg, b_reg
        x5 = solve(a_aug[lo:lo + batch], None, x0_full[lo:lo + batch],
                   diag=diag_full[lo:lo + batch], aug=True, **kw)
        k4_err = max(k4_err, (x4 - x5).abs().max().item())
        if not bool(torch.isfinite(x4).all()):
            raise AssertionError("K4 path: non-finite solution")
    torch.cuda.synchronize()
    k4_launches = cs.LAUNCHES["solve_cg"]
    log(f"[K4 path] ops.solve.solve(cg, pallas, no diag) over "
        f"{m_pad // batch} slices of {batch} systems: {k4_launches} "
        f"launches, max|x - x_aug|={k4_err:.3e} (limit 1e-5)")
    if k4_launches < m_pad // batch or k4_err > 1e-5:
        raise AssertionError("K4 path failed")
    del a_aug, x0_full, diag_full, nnzf
    totals(al_aug, ("K6", "K5a"))
    del theta_t, x_t, table_ext
    torch.cuda.empty_cache()

    # ---- 4b. this slice's path at full width (f32 accumulators,
    # aug_gram="force": K5a, K5b, K6)
    hist_aug, launches_aug = full_width(
        cs, al_aug, "aug", AUG_KERNELS,
        SPLIT_KERNELS + WIDE_KERNELS + SPAN_KERNELS + ("solve_cg",), x0_np,
        th0_np)
    for hm, ha in zip(hist_main, hist_aug):
        log(f"[main | aug] iter {hm.iteration}: train {hm.train_rmse:.6f} | "
            f"{ha.train_rmse:.6f}, test {hm.test_rmse:.6f} | "
            f"{ha.test_rmse:.6f} (no limit: bf16 and f32 accumulators "
            f"round differently by design)")

    del al_aug, aux_x   # frees the plans on the card
    torch.cuda.empty_cache()

    # ---- 5. the factor widths above 128
    wide_launches = wide_paths(cs, ALS, cfg, train, csc, test, str_, ste,
                               results)

    # ---- 6. the batched-panel route
    results["gather_gram_out"]["batched_panel_launches"] = batched_panel(
        cs, ALS, cfg, train, csc, test, x0_np, th0_np)

    # ---- 7, 8. the port's bench on the cached data, and its accuracy
    # contracts
    bench_main()
    bench_accuracy()

    # ---- 9. out-of-core training on hugewiki_mini
    ooc_launches, ooc_checks = out_of_core(cs, bench)
    for name in SPLIT_KERNELS:
        results[name]["ooc_launches"] = ooc_launches[name]
        results[name]["ooc_check"] = ooc_checks[name]

    # ---- 10. sharded training on the Netflix data: one rank (NCCL), two
    # ranks on the one card (gloo)
    sh_launches, sh_checks = sharded(cs, bench, cfg, train, test, hist_main)
    for name in SPLIT_KERNELS:
        results[name]["sharded_launches"] = {
            k: v.get(name, 0) for k, v in sh_launches.items()}
        results[name]["sharded_check"] = sh_checks[name]

    launches.update({k: launches_aug[k] for k in AUG_KERNELS})
    launches["solve_cg"] = k4_launches
    launches.update(wide_launches)
    kernels = [{"name": name, "route": "cuda",
                "source": f"cumf_als_tpu_torch/csrc/{name}.cu",
                "replaces": REPLACES[name], "launches": launches[name],
                "body": BODY[name], **results[name]} for name in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
