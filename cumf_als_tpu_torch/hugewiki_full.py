"""Full-hugewiki run: the reference's flagship workload (M=50,082,603,
N=39,780, NNZ=3,101,144,313; reference hugewiki/hugewiki.cu:27-42) through
the sharded out-of-core model (parallel/sharded_ooc.py) on one card, or
on N ranks under torchrun:

  - X on the card (`--x-placement device`, 50M x 128 bf16 = 12.8 GB) or
    in a pinned host shard streamed a chunk and a panel at a time
    (`--x-placement host`, the reference's XT_h, hugewiki.cu:2300-2302);
  - above 2^28 ratings the plans are lazy: a chunk's padded arrays are
    made when it is streamed (hugewiki.cu:2508-2516), and the compacted
    arrays of the first pass are kept in the plan cache's stream stores;
  - every flat index is int64 (nnz > 2^31).

    python -m cumf_als_tpu_torch.hugewiki_full [--scale 1.0] [--iters 1]
    torchrun --nproc-per-node N -m cumf_als_tpu_torch.hugewiki_full \\
        --devices N ...

Prints one JSON line with the per-iteration timings and RMSEs, under the
keys of the JAX package's scripts/hugewiki_full.py. With `--state-dir D`
it runs ONE iteration a process and persists (state.json, theta.npy and,
with X on the host, x_host.npy) in D, in the files and layout of the JAX
script, so that a state directory carries across the two packages; it
is re-invoked until `--iters` are done (scripts/
torch_hugewiki_full_driver.sh), which bounds a process's host memory and
makes a long run restartable. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

import numpy as np
import torch

# np.save of the JAX package's bf16 store (an ml_dtypes.bfloat16 array)
# names its dtype '<V2'; the file is read back as 2-byte voids
_BF16_DESCR = "<V2"


def rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def save_store(path: str, t: torch.Tensor) -> None:
    """The bf16 host store as .npy: its bits under the '<V2' descr, byte
    for byte what the JAX script's np.save of its store writes."""
    bits = np.ascontiguousarray(t.view(torch.int16).numpy())
    with open(path, "wb") as fh:
        np.lib.format.write_array_header_1_0(
            fh, {"descr": _BF16_DESCR, "fortran_order": False,
                 "shape": bits.shape})
        bits.tofile(fh)


def load_store(path: str) -> torch.Tensor:
    """A bf16 store written by `save_store` or by the JAX script (2-byte
    voids) as a torch.bfloat16 tensor."""
    return torch.from_numpy(np.load(path).view(np.int16)).view(
        torch.bfloat16)


def _save_atomic(state_dir: str, name: str, write) -> None:
    """write(tmp path), then the file replaces `name`.npy at once: a crash
    mid-save leaves the last checkpoint whole."""
    tmp = os.path.join(state_dir, name + ".tmp.npy")
    write(tmp)
    os.replace(tmp, os.path.join(state_dir, name + ".npy"))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cumf_als_tpu_torch.hugewiki_full")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--iters", type=int, default=1)
    p.add_argument("--devices", type=int, default=1,
                   help="ranks, one process each: N > 1 runs under "
                        "torchrun --nproc-per-node N")
    p.add_argument("--f", type=int, default=100)
    p.add_argument("--cg-iters", type=int, default=20,
                   help="CG budget (the reference's hugewiki uses "
                        "cgIter=100 from cold starts, hugewiki.cu:2569); "
                        "each system stops at cg_tol")
    p.add_argument("--x-placement", default="device",
                   choices=["device", "host"],
                   help="device: X shards on the card, the ratings "
                        "streamed in chunks; host: X in a pinned host "
                        "store, streamed (the reference's XT_h)")
    p.add_argument("--state-dir", default=None,
                   help="run ONE iteration a process, persisting "
                        "(x_host, theta, iteration) here; re-invoke until "
                        "--iters are done")
    p.add_argument("--x-warm-start", default="auto",
                   choices=["auto", "on", "off"],
                   help="device-X CG warm start from the card's shard. "
                        "auto: on, except off under --state-dir, which "
                        "persists theta alone with X on the card, so the "
                        "state-dir trajectory equals the single-process "
                        "one only under cold starts")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or "
                        "'cpu'")
    return p


def _read_state(state_dir: str):
    path = os.path.join(state_dir, "state.json")
    if not os.path.exists(path):
        return None
    with open(path) as fh:
        return json.load(fh)


def make_config(args, train, test, next_iter: int = 0):
    """The run's ALSConfig (the JAX script's fields): bf16 factors and
    Gram, the kernels, X out of core, the plan cache of the bench;
    under --state-dir one iteration, `next_iter`."""
    from cumf_als_tpu_torch import bench
    from cumf_als_tpu_torch.config import ALSConfig
    device_x = args.x_placement == "device"
    warm = (args.x_warm_start == "on" or
            (args.x_warm_start == "auto" and not args.state_dir))
    return ALSConfig(m=train.num_rows, n=train.num_cols, f=args.f,
                     nnz=train.nnz, nnz_test=test.nnz, lam=0.048,
                     iters=(next_iter + 1 if args.state_dir
                            else args.iters),
                     solver="cg", x_warm_start=warm,
                     cg_iters=args.cg_iters, factor_dtype="bf16",
                     gram_dtype="bf16", backend="pallas",
                     host_offload_x=True, verbose=True,
                     x_placement=args.x_placement,
                     # 2^22 slots bound a chunk's transient gathered slab
                     # at ~1 GB; fewer rows a chunk with X on the host,
                     # whose warm starts and solved rows cross the bus
                     chunk_nnz=1 << 22,
                     chunk_rows=(1 << 17 if device_x else 1 << 14),
                     plan_cache_dir=bench.plan_cache_dir(),
                     stream_val_dtype="f16", debug_timing=True)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from cumf_als_tpu_torch.models.als import resolve_device
    from cumf_als_tpu_torch.parallel.mesh import current_mesh

    dev = resolve_device(args.device)
    # before the data is read: the world must have --devices ranks
    mesh = current_mesh(dev.type).require_world(args.devices)
    try:
        return _run(args, mesh)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, mesh) -> int:
    from cumf_als_tpu_torch import bench
    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.ops import _build
    from cumf_als_tpu_torch.parallel.sharded_ooc import ShardedOutOfCoreALS

    rank, dev = mesh.rank, mesh.device
    say = bench.log if rank == 0 else (lambda msg: None)
    card = bench.card_line() if dev.type == "cuda" else "cpu"
    say(f"[hugewiki] device: {dev} ({card}), {mesh.world_size} rank(s)")
    built0 = len(_build.BUILT)

    # state-dir mode runs one iteration a process; the resume index
    # comes before the config, whose iters it sets
    next_iter = 0
    if args.state_dir:
        st = _read_state(args.state_dir)
        next_iter = st["next_iter"] if st else 0
        if next_iter >= args.iters:
            if rank == 0:
                with open(os.path.join(args.state_dir, "state.json")) as fh:
                    print(fh.read(), flush=True)
            return 0

    t0 = time.monotonic()
    # rank 0 writes the data cache; the other ranks read it after
    if rank > 0:
        mesh.barrier()
    train, test = bench.load_workload("hugewiki", args.scale, say=say)
    if rank == 0:
        mesh.barrier()
    say(f"[hugewiki] dataset ready in {time.monotonic() - t0:.0f}s: "
        f"m={train.num_rows} n={train.num_cols} nnz={train.nnz} "
        f"nnz_test={test.nnz} rss={rss_gb():.1f}GB")

    device_x = args.x_placement == "device"
    cfg = make_config(args, train, test, next_iter)
    t0 = time.monotonic()
    model = ShardedOutOfCoreALS(cfg, train, None, test,
                                n_devices=args.devices, mesh=mesh)
    plan_s = time.monotonic() - t0
    n_theta = (len(model.th_plan.chunks) if model.th_plan is not None
               else len(model.theta_steps))
    say(f"[hugewiki] plans built in {plan_s:.0f}s ({model.n_panels} local "
        f"X panels x {model.n_dev} devices, {len(model.row_plan.chunks)} X "
        f"chunks, {n_theta} theta "
        f"{'chunks (direct)' if model.th_plan is not None else 'steps'}, "
        f"{model._hot_rows.size} hot columns) rss={rss_gb():.1f}GB")

    if args.state_dir:
        return _one_iteration(args, mesh, model, cfg, plan_s, built0)

    x0 = (None if device_x else
          np.zeros((cfg.m, cfg.f), np.float32))  # reference init: X = 0
    _, th0 = init_factors(8, cfg.n, cfg.f, seed=cfg.seed)
    t0 = time.monotonic()
    res = model.run(x0, th0)
    total = time.monotonic() - t0
    # libraries built after iteration 0's phase time had passed were
    # built inside the timed steady loop
    iter0_end = t0 + (res.history[0].x_seconds +
                      res.history[0].theta_seconds if res.history else 0)
    built = _build.BUILT[built0:]
    in_loop = [name for ts, name in built if ts > iter0_end]
    out = {
        "metric": "hugewiki_f%d_sec_per_iter" % args.f,
        "value": round(total / max(1, args.iters), 2),
        "unit": "s/iter",
        "scale": args.scale,
        "m": cfg.m, "n": cfg.n, "nnz": train.nnz,
        "iters": args.iters,
        "plan_seconds": round(plan_s, 1),
        "x_seconds": [round(h.x_seconds, 1) for h in res.history],
        "theta_seconds": [round(h.theta_seconds, 1)
                          for h in res.history],
        "train_rmse": [round(h.train_rmse, 5) for h in res.history],
        "test_rmse": [round(h.test_rmse, 5) for h in res.history],
        "rss_gb": round(rss_gb(), 1),
        # kernel libraries built by this process (0 with a warm _build/)
        "n_compiles": len(built),
        "n_compiles_in_loop": len(in_loop),
        "in_loop_compiles": in_loop[:8],
        "device": card,
    }
    if rank == 0:
        print(json.dumps(out), flush=True)
    return 0


def _one_iteration(args, mesh, model, cfg, plan_s, built0) -> int:
    """--state-dir: iteration next_iter from the persisted state (or
    from the initial factors), then the state written by rank 0."""
    from cumf_als_tpu_torch.data.synthetic import init_factors
    from cumf_als_tpu_torch.ops import _build

    device_x = args.x_placement == "device"
    if mesh.rank == 0:
        os.makedirs(args.state_dir, exist_ok=True)
    st = _read_state(args.state_dir)
    x_host0 = None
    if st is not None:
        it = st["next_iter"]
        if not device_x:
            x_host0 = load_store(os.path.join(args.state_dir, "x_host.npy"))
        th0 = np.load(os.path.join(args.state_dir, "theta.npy"))
    else:
        st = {"next_iter": 0, "history": []}
        it = 0
        _, th0 = init_factors(8, cfg.n, cfg.f, seed=cfg.seed)
    t0 = time.monotonic()
    res = model.run(
        None if (x_host0 is not None or device_x) else np.zeros(
            (cfg.m, cfg.f), np.float32),
        th0, start_iter=it, x_host0=x_host0, keep_sharded=True)
    iter_s = time.monotonic() - t0
    # with X on the card the state is theta alone: X is solved anew from
    # theta each iteration, and copying the card's shard out would cost
    # its size in host memory and bus time for nothing
    x_host = None if device_x else model.gather_x_store()   # collective
    if mesh.rank == 0:
        _save_atomic(args.state_dir, "theta",
                     lambda p: np.save(p, res.theta))
        if x_host is not None:
            _save_atomic(args.state_dir, "x_host",
                         lambda p: save_store(p, x_host))
        h = res.history[-1]
        st["history"].append(
            {"iter": it, "x_seconds": round(h.x_seconds, 1),
             "theta_seconds": round(h.theta_seconds, 1),
             "train_rmse": round(h.train_rmse, 5),
             "test_rmse": round(h.test_rmse, 5),
             "iter_seconds": round(iter_s, 1),
             "plan_seconds": round(plan_s, 1),
             # kernel libraries this process built: 0 with a warm
             # _build/; a nonzero count explains an iteration-time spike
             "n_compiles": len(_build.BUILT) - built0,
             "rss_gb": round(rss_gb(), 1)})
        st["next_iter"] = it + 1
        path = os.path.join(args.state_dir, "state.json")
        with open(path + ".tmp", "w") as fh:
            json.dump(st, fh)
        os.replace(path + ".tmp", path)
        print(json.dumps(st["history"][-1]), flush=True)
    mesh.barrier()   # no rank reads the state before rank 0 wrote it
    return 0


if __name__ == "__main__":
    sys.exit(main())
