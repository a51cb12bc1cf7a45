"""Benchmark of the port: ALS on a named synthetic workload, one JSON line.

    python -m cumf_als_tpu_torch.bench [--workload netflix] [--iters 10]
        [--repeat N] [--accuracy-check] [--device cuda|cpu] [...]

The root bench.py's contract on the port: the same flags, defaults and
output keys. It prints ONE JSON line,

  {"metric": ..., "value": N, "unit": "s/iter", "vs_baseline": N, ...}

where `value` is seconds per iteration: the X and theta phases of each
iteration (each ending in a device sync), the median over iterations 1
onward, then the median over `--repeat` runs. Set-up (data, plans, the
kernel build) and the test-RMSE step are outside it. On stderr it logs
the card's name and power limit, the kernel build's seconds, the route of
each phase, and one line per iteration.

Data sets are generated once per (workload, scale, seed) and cached under
.bench_cache/torch/<workload>_s<scale>_seed<seed>/ in the root bench's
directory format (one .npy per member and meta.json), then read back
memory-mapped. meta.json records the workload entry the data came from,
with the generator that made it ("native" at 2^26 ratings and above when
the native data plane is built, else "numpy"), and each member's
CRC-32: a cache from another entry is regenerated, and one whose members
no longer match their CRC-32s raises. The JAX package's bench keeps its
own cache in another layout beside it. Built plans are cached under
.bench_cache/plans/ (utils/plan_cache.py), the root bench's plan cache,
whose format and keys the two packages share, unless `--no-plan-cache`.

`--out-of-core` runs OutOfCoreALS (X in host memory, streamed through the
card) on the workload, as the root bench does. `--mesh N` runs ShardedALS
over N ranks, one process a rank under torchrun (`torchrun
--nproc-per-node N -m cumf_als_tpu_torch.bench --mesh N`): rank 0 loads
or generates the data cache while the others wait, then they read it;
only rank 0 logs and prints the JSON line. `--mesh N` with
`--out-of-core` runs ShardedOutOfCoreALS (each rank's X shard in host
memory), as the root bench does.

Runs on the first CUDA device unless `--device cpu` (or `--platform
cpu`) is given; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import zlib

import numpy as np

# The bar every workload is compared with: cuMF on a P100 runs a Netflix
# F=100 iteration in ~1.0 s over 99,072,112 ratings, scaled by each run's
# training nnz (per-iteration cost at fixed F is nnz-proportional).
BASELINE_NS_PER_NNZ = 1.0e9 / 99_072_112  # ~10.09 ns per rating per iter


def baseline_sec_per_iter(nnz: int) -> float:
    return BASELINE_NS_PER_NNZ * nnz / 1e9


# Accuracy contracts, frozen (the root bench's table): per calibrated
# workload, both the final and the best test RMSE must lie in `band`
# (the published regime of the real data set at F=100 and the
# reference's lambda), the final may exceed the best by at most
# `rel_drift`, and final / iteration 1 must fall below `converged`.
ACCURACY_CONTRACTS = {
    "netflix_cal": {"band": (0.89, 0.95), "rel_drift": 0.02,
                    "converged": 0.97},
    "ml10m_cal": {"band": (0.78, 0.87), "rel_drift": 0.02,
                  "converged": 0.97},
    "yahoo_cal": {"band": (20.0, 25.0), "rel_drift": 0.02,
                  "converged": 0.97},
}
# the reference's lambda per workload
LAMBDA = {"netflix": 0.048, "ml10m": 0.05, "yahoo": 1.4,
          "hugewiki_mini": 0.048, "hugewiki": 0.048,
          "netflix_cal": 0.048, "ml10m_cal": 0.05, "yahoo_cal": 1.4}
WORKLOADS = ["netflix", "ml10m", "yahoo", "hugewiki_mini", "hugewiki",
             "netflix_cal", "ml10m_cal", "yahoo_cal"]
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench_cache", "torch")
# the plan cache beside the data caches: the root bench's, whose format
# and keys the port shares (utils/plan_cache.py)
def plan_cache_dir() -> str:
    return os.path.join(os.path.dirname(CACHE_DIR), "plans")


_DSET_MEMBERS = ("indptr", "indices", "data", "trow", "tcol", "tdata")
# flags of the root bench that steer only the JAX toolchain
_NO_EFFECT = "accepted; no effect in the port"


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _members(train, test):
    return (train.indptr, train.indices, train.data, test.row, test.col,
            test.data)


def dataset_crc32(train, test) -> dict:
    """CRC-32 of each member's bytes: the check that a cached data set is
    the one that was generated."""
    return {k: zlib.crc32(np.ascontiguousarray(a).view(np.uint8))
            for k, a in zip(_DSET_MEMBERS, _members(train, test))}


def _load_dataset_dir(path: str):
    """Memory-map a cached data set. The pages are file-backed, so a
    large data set does not stay resident as anonymous memory; arrays
    are read-only."""
    from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix
    meta = _read_meta(path)
    a = {k: np.load(os.path.join(path, k + ".npy"), mmap_mode="r")
         for k in _DSET_MEMBERS}
    train = CSRMatrix(indptr=a["indptr"], indices=a["indices"],
                      data=a["data"], num_rows=meta["m"],
                      num_cols=meta["n"])
    test = COOMatrix(row=a["trow"], col=a["tcol"], data=a["tdata"],
                     num_rows=meta["m"], num_cols=meta["n"])
    return train, test


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as fh:
        return json.load(fh)


def _workload_entry(name: str, scale: float, seed: int) -> dict:
    """What a cached data set was generated from: the workload's table
    entry, its scale and seed, and the generator. A cache whose entry
    differs is stale."""
    from cumf_als_tpu_torch.data.synthetic import (WORKLOAD_SHAPES,
                                                   native_generator,
                                                   workload_shape)
    shp = workload_shape(name, scale)
    gen = "native" if native_generator(shp["nnz"] + shp["nnz_test"]) \
        else "numpy"
    return json.loads(json.dumps({"workload": name, "scale": scale,
                                  "seed": seed,
                                  "shape": WORKLOAD_SHAPES[name],
                                  "generator": gen}))


def _check_cached(path: str, train, test) -> None:
    """Raise unless the memory-mapped members are the arrays whose
    shape and CRC-32s the cache's meta.json recorded."""
    meta = _read_meta(path)
    nnz = int(train.indptr[-1])
    if (train.indptr.size != meta["m"] + 1 or train.indices.size != nnz
            or train.data.size != nnz
            or not test.row.size == test.col.size == test.data.size
            or dataset_crc32(train, test) != meta["crc32"]):
        raise RuntimeError(
            f"cached data set {path} does not match its meta.json "
            "(truncated or overwritten); delete the directory to "
            "regenerate it")


def dataset_dir(name: str, scale: float, seed: int = 0) -> str:
    return os.path.join(CACHE_DIR, f"{name}_s{scale:g}_seed{seed}")


def load_workload(name: str, scale: float, seed: int = 0, say=log):
    """The workload's (train CSR, test COO), generated with
    `workload_ratings` and written to the cache on first use, then
    memory-mapped from it. `say` logs."""
    import shutil

    from cumf_als_tpu_torch.data.synthetic import workload_ratings
    dpath = dataset_dir(name, scale, seed)
    entry = _workload_entry(name, scale, seed)
    if os.path.isdir(dpath):
        if _read_meta(dpath).get("entry") == entry:
            say(f"[bench] loading cached dataset {dpath} (mmap)")
            train, test = _load_dataset_dir(dpath)
            _check_cached(dpath, train, test)
            return train, test
        say(f"[bench] cached dataset {dpath} was generated from another "
            "workload entry; regenerating")
        shutil.rmtree(dpath)
    say(f"[bench] generating synthetic {name} (scale={scale}) ...")
    t0 = time.monotonic()
    train, test = workload_ratings(name, scale=scale, seed=seed)
    say(f"[bench] generated nnz={train.nnz} nnz_test={test.nnz} "
        f"in {time.monotonic() - t0:.1f}s")
    tmp = dpath + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    for k, arr in zip(_DSET_MEMBERS, _members(train, test)):
        np.save(os.path.join(tmp, k + ".npy"), arr)
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump({"m": train.num_rows, "n": train.num_cols,
                   "crc32": dataset_crc32(train, test), "entry": entry},
                  fh)
    os.rename(tmp, dpath)
    # reopen memory-mapped so the generated arrays' pages are freed
    return _load_dataset_dir(dpath)


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi gives them
    (a card may be set below its maximum power and then runs slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cumf_als_tpu_torch.bench",
        description="ALS benchmark of the PyTorch/CUDA port: one JSON line")
    p.add_argument("--workload", default="netflix", choices=WORKLOADS)
    p.add_argument("--accuracy-check", action="store_true",
                   help="hold a calibrated *_cal workload's test RMSE to "
                        "its frozen contract (ACCURACY_CONTRACTS); needs "
                        "--iters >= 3")
    p.add_argument("--out-of-core", action="store_true",
                   help="X in host memory, streamed through the card "
                        "(OutOfCoreALS)")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--f", type=int, default=100)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--solver", default="cg",
                   choices=["cg", "cholesky", "lu"])
    p.add_argument("--gram-precision", default="highest",
                   choices=["highest", "high", "default"], help=_NO_EFFECT)
    p.add_argument("--factor-dtype", default="bf16", choices=["f32", "bf16"])
    p.add_argument("--factor-store", default="f32", choices=["f32", "bf16"])
    # pallas = the hand-written CUDA kernels (their plain versions on the
    # CPU); xla = plain torch gather + einsum + solve
    p.add_argument("--backend", default="pallas", choices=["xla", "pallas"])
    p.add_argument("--use-panels", default="auto", choices=["auto", "never"])
    p.add_argument("--no-fuse-phase", action="store_true", help=_NO_EFFECT)
    p.add_argument("--no-plan-cache", action="store_true",
                   help="disable the on-disk plan cache")
    p.add_argument("--chunk-nnz", type=int, default=1 << 22)
    p.add_argument("--gram-dtype", default="bf16", choices=["f32", "bf16"])
    p.add_argument("--aug-gram", default="auto",
                   choices=["auto", "off", "force"])
    p.add_argument("--octave-points", type=int, default=8,
                   choices=[4, 8, 16])
    p.add_argument("--split-gather", default="auto",
                   choices=["auto", "off", "force"])
    p.add_argument("--fused-step", default="auto",
                   choices=["auto", "on", "off"],
                   help=_NO_EFFECT + " (it steers the sharded model only)")
    p.add_argument("--wide-kernel", default="off", choices=["off", "on"])
    p.add_argument("--mesh", type=int, default=0,
                   help="shard over N ranks (ShardedALS); run under "
                        "torchrun --nproc-per-node N")
    p.add_argument("--platform", default=None,
                   help="'cpu' means --device cpu; nothing else is taken")
    p.add_argument("--panel-size", type=int, default=None)
    p.add_argument("--debug-timing", action="store_true",
                   help="per-phase device-synced timing lines")
    p.add_argument("--repeat", type=int, default=1,
                   help="run the training loop N times; report the median "
                        "of the runs' medians and their min/max")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p


def run_median(history) -> float:
    """Median x + theta seconds over iterations 1 onward (iteration 0
    alone when it is the only one)."""
    its = [h.x_seconds + h.theta_seconds for h in history[1:]]
    return float(np.median(its)) if its else \
        history[0].x_seconds + history[0].theta_seconds


def accuracy_check(workload: str, history):
    """("pass" | "fail", the contract's record) for a run's history."""
    if workload not in ACCURACY_CONTRACTS:
        return "fail", {"workload": workload,
                        "error": "accuracy contracts exist only for the "
                                 "calibrated *_cal workloads"}
    c = ACCURACY_CONTRACTS[workload]
    tr = [h.test_rmse for h in history]
    best = float(np.min(tr))
    in_band = c["band"][0] <= tr[-1] <= c["band"][1]
    best_in_band = c["band"][0] <= best <= c["band"][1]
    bounded_drift = tr[-1] <= best * (1.0 + c["rel_drift"])
    converged = (tr[-1] / tr[1] < c["converged"]
                 if len(tr) > 1 else False)
    ok = in_band and best_in_band and bounded_drift and converged
    return ("pass" if ok else "fail"), {
        "band": list(c["band"]), "final": round(tr[-1], 4),
        "best": round(best, 4), "in_band": in_band,
        "best_in_band": best_in_band, "bounded_drift": bounded_drift,
        "converged": converged, "workload": workload}


def _describe(plan_pair) -> str:
    from cumf_als_tpu_torch.ops.tiling import BatchedPanelPlan
    plan, chunks, aux = plan_pair
    if isinstance(plan, BatchedPanelPlan):
        n = sum(len(c) for _, _, c in aux["batches"])
        return (f"BatchedPanelPlan ({len(aux['batches'])} batches of "
                f"{plan.batch_rows} rows, {n} chunks)")
    return f"{type(plan).__name__} ({len(chunks)} chunks)"


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.platform not in (None, "cpu"):
        raise ValueError(f"--platform {args.platform!r}: the port takes "
                         f"only 'cpu' (the same as --device cpu)")
    if args.accuracy_check and args.iters < 3:
        p.error("--accuracy-check needs --iters >= 3: with fewer the "
                "convergence test compares iteration 1 with itself")
    from cumf_als_tpu_torch.models.als import resolve_device

    dev = resolve_device("cpu" if args.platform == "cpu" else args.device)
    mesh = None
    if args.mesh:   # before the data is loaded or generated
        from cumf_als_tpu_torch.parallel.mesh import current_mesh
        mesh = current_mesh(dev.type).require_world(args.mesh)
        dev = mesh.device
    try:
        return _bench(args, dev, mesh)
    finally:
        import torch.distributed as dist
        if mesh is not None and dist.is_initialized():
            dist.destroy_process_group()


def _bench(args, dev, mesh) -> int:
    """The run of main(): on every rank with --mesh, rank 0 alone
    logging and printing."""
    import torch

    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.models.factory import make_model
    rank = mesh.rank if mesh else 0
    say = log if rank == 0 else (lambda msg: None)
    if dev.type == "cuda":
        say(f"[bench] card: {card_line()}")
    # rank 0 writes the data cache; the other ranks read it after
    if rank > 0:
        mesh.barrier()
    train, test = load_workload(args.workload, args.scale, say=say)
    if mesh is not None and rank == 0:
        mesh.barrier()
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=args.f,
                    nnz=train.nnz, nnz_test=test.nnz,
                    lam=LAMBDA[args.workload], iters=args.iters,
                    solver=args.solver, gram_precision=args.gram_precision,
                    factor_dtype=args.factor_dtype,
                    factor_store=args.factor_store,
                    gram_dtype=args.gram_dtype, aug_gram=args.aug_gram,
                    chunk_nnz=args.chunk_nnz,
                    octave_points=args.octave_points,
                    split_gather=args.split_gather,
                    fused_step=args.fused_step,
                    wide_kernel=args.wide_kernel, backend=args.backend,
                    use_panels=args.use_panels,
                    fuse_phase=not args.no_fuse_phase,
                    plan_cache_dir=(None if args.no_plan_cache else
                                    plan_cache_dir()),
                    host_offload_x=args.out_of_core,
                    mesh_shape=(args.mesh,) if args.mesh else None,
                    train_rmse_method="fused", verbose=False,
                    debug_timing=args.debug_timing,
                    **({"panel_size": args.panel_size}
                       if args.panel_size else {}))
    if dev.type == "cuda":
        # built here, not at first use inside the timed run
        from cumf_als_tpu_torch.ops import _build
        say(f"[bench] kernels built in {_build.build():.1f} s")
    t0 = time.monotonic()
    model = make_model(cfg, train, None, test, device=dev)
    if args.mesh and args.out_of_core:
        say(f"[bench] sharded+OOC plans built in "
            f"{time.monotonic() - t0:.1f}s ({model.n_panels} local X panels "
            f"x {model.n_dev} devices)")
    elif args.mesh:
        say(f"[bench] sharded plans built in {time.monotonic() - t0:.1f}s "
            f"({len(model.row_plan.chunks)} chunks, "
            f"{len(model.reduce_plan.blocks)} reduce blocks, "
            f"{model.n_dev} devices)")
    elif args.out_of_core:
        say(f"[bench] OOC plans built in {time.monotonic() - t0:.1f}s "
            f"({model.plan_theta.n_panels} X panels; X phase "
            f"{len(model.plan_x.chunks)} chunks, theta phase "
            f"{len(model.plan_theta.chunks)} chunks, "
            f"{model.n_slices} solve slices)")
    else:
        say(f"[bench] plans built in {time.monotonic() - t0:.1f}s; X phase: "
            f"{_describe(model.plan_x)}, theta phase: "
            f"{_describe(model.plan_theta)}")

    from cumf_als_tpu_torch.ops import cuda_solve
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=cfg.seed)
    cuda_solve.reset_launch_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    res = model.run(x0, th0)
    total = time.monotonic() - t0
    launched = {k: v for k, v in cuda_solve.LAUNCHES.items() if v}
    peak = (f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB"
            if dev.type == "cuda" else "not measured (CPU)")
    say(f"[bench] first run: kernel launches {launched}, peak device "
        f"memory {peak}")
    for h in res.history:
        say(f"[bench] iter {h.iteration}: "
            f"x+theta={h.x_seconds + h.theta_seconds:.3f}s "
            f"train_rmse={h.train_rmse:.4f} test_rmse={h.test_rmse:.4f}")
    run_medians = [run_median(res.history)]
    for rep in range(1, args.repeat):
        run_medians.append(run_median(model.run(x0, th0).history))
        say(f"[bench] repeat {rep}: {run_medians[-1]:.4f} s/iter")
    sec_per_iter = float(np.median(run_medians))
    # effective Gram throughput: 2 phases * 2*nnz*f_pad^2 flops
    gflops = 4.0 * train.nnz * cfg.f_pad ** 2 / sec_per_iter / 1e9

    out = {
        "metric": f"{args.workload}_f{args.f}_sec_per_iter",
        "value": round(sec_per_iter, 4),
        "unit": "s/iter",
        "vs_baseline": round(
            baseline_sec_per_iter(train.nnz) / sec_per_iter, 3),
        "baseline_sec_per_iter": round(baseline_sec_per_iter(train.nnz), 4),
        "ns_per_nnz": round(sec_per_iter * 1e9 / max(1, train.nnz), 2),
        "test_rmse_final": round(res.history[-1].test_rmse, 5),
        "train_rmse_final": round(res.history[-1].train_rmse, 5),
        "total_seconds": round(total, 2),
        "gram_gflops": round(gflops, 1),
        "solver": args.solver,
        "backend": args.backend,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if args.repeat > 1:
        out["repeats"] = args.repeat
        out["spread_min"] = round(min(run_medians), 4)
        out["spread_max"] = round(max(run_medians), 4)
    if args.accuracy_check:
        out["accuracy_check"], out["accuracy_contract"] = accuracy_check(
            args.workload, res.history)
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
