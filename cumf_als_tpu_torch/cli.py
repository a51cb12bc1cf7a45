"""CLI entry point: the reference main.cpp's nine positional arguments.

    python -m cumf_als_tpu_torch.cli M N F NNZ NNZ_TEST lambda X_BATCH \\
        THETA_BATCH DATA_DIR [flags]

e.g. for the netflix data set, on the GPU with the CUDA kernels:
    python -m cumf_als_tpu_torch.cli 17770 480189 100 99072112 1408395 \\
        0.048 1 3 ./data/netflix/ --backend pallas

Initialization: theta ~ 0.2*U(0,1) at the seed, X = 0. The run uses the
first CUDA device unless `--device cpu` is given.

Sharded over N ranks (ShardedALS), one process a rank, rank r on
cuda:r, under torchrun:
    torchrun --nproc-per-node N -m cumf_als_tpu_torch.cli ... --mesh N
Only rank 0 prints. `--profile-dir DIR` writes a torch.profiler trace of
the training loop into DIR (CPU and CUDA activity on a card).
"""

from __future__ import annotations

import argparse
import contextlib
import sys

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.factory import SHARDED_OOC, make_model
from cumf_als_tpu_torch.utils.io import (load_csc_as_csr, load_csr,
                                         load_test_coo)
from cumf_als_tpu_torch.utils.timing import seconds

USAGE = """Usage: give M, N, F, NNZ, NNZ_TEST, lambda, X_BATCH, THETA_BATCH and DATA_DIR.
E.g., for netflix data set, use:
python -m cumf_als_tpu_torch.cli 17770 480189 100 99072112 1408395 0.048 1 3 ./data/netflix/
E.g., for movielens 10M data set, use:
python -m cumf_als_tpu_torch.cli 71567 65133 100 9000048 1000006 0.05 1 1 ./data/ml10M/
E.g., for yahooMusic data set, use:
python -m cumf_als_tpu_torch.cli 1000990 624961 100 252800275 4003960 1.4 6 3 ./data/yahoo/"""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cumf_als_tpu_torch", usage=USAGE,
        description="ALS matrix factorization on PyTorch/CUDA")
    for name, typ in [("M", int), ("N", int), ("F", int), ("NNZ", int),
                      ("NNZ_TEST", int), ("lambda_", float),
                      ("X_BATCH", int), ("THETA_BATCH", int),
                      ("DATA_DIR", str)]:
        p.add_argument(name, type=typ)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--solver", choices=["cg", "cholesky", "lu"],
                   default="cg")
    p.add_argument("--cg-iters", type=int, default=6)
    p.add_argument("--cg-tol", type=float, default=1e-4)
    p.add_argument("--factor-dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--gram-dtype", choices=["f32", "bf16"], default="f32")
    p.add_argument("--gram-precision",
                   choices=["highest", "high", "default"], default="highest",
                   help="accepted; no effect (Gram sums are f32)")
    p.add_argument("--train-rmse", choices=["direct", "fused"],
                   default="fused")
    # pallas = the hand-written CUDA kernels (their plain versions on the
    # CPU); xla = plain torch gather + einsum + solve
    p.add_argument("--backend", choices=["xla", "pallas"],
                   default="pallas")
    p.add_argument("--use-panels", choices=["auto", "never"],
                   default="auto")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard over N ranks (ShardedALS); run under "
                        "torchrun --nproc-per-node N")
    p.add_argument("--x-placement", choices=["host", "device"],
                   default=None,
                   help="sharded out-of-core X placement (not ported yet: "
                        "A12, sharded out-of-core)")
    p.add_argument("--out-of-core", action="store_true",
                   help="keep X in host memory and stream it through the "
                        "card (OutOfCoreALS)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--plan-cache", default="auto",
                   help="plan cache directory ('auto' = <DATA_DIR>/"
                        ".plan_cache, 'off'); the JAX package's format, "
                        "so either package reads the other's entries")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the training loop "
                        "into this directory")
    p.add_argument("--quiet", action="store_true")
    return p


def config_from_args(a) -> ALSConfig:
    import os
    plan_cache = None if a.plan_cache == "off" else (
        os.path.join(a.DATA_DIR, ".plan_cache")
        if a.plan_cache == "auto" else a.plan_cache)
    return ALSConfig(
        plan_cache_dir=plan_cache,
        m=a.M, n=a.N, f=a.F, nnz=a.NNZ, nnz_test=a.NNZ_TEST,
        lam=a.lambda_, x_batch=a.X_BATCH, theta_batch=a.THETA_BATCH,
        data_dir=a.DATA_DIR, iters=a.iters, solver=a.solver,
        cg_iters=a.cg_iters, cg_tol=a.cg_tol, factor_dtype=a.factor_dtype,
        gram_dtype=a.gram_dtype, gram_precision=a.gram_precision,
        train_rmse_method=a.train_rmse, seed=a.seed,
        backend=a.backend, use_panels=a.use_panels,
        mesh_shape=(a.mesh,) if a.mesh else None,
        host_offload_x=a.out_of_core,
        checkpoint_dir=a.checkpoint_dir,
        checkpoint_every=a.checkpoint_every, resume=a.resume,
        profile_dir=a.profile_dir, verbose=not a.quiet,
        debug_timing=not a.quiet)


def profiled(profile_dir, device):
    """A torch.profiler context over the training loop writing its trace
    into `profile_dir` (the JAX CLI's jax.profiler.trace): CPU and CUDA
    activity on a card, CPU alone on the CPU. No profile_dir: none."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts,
                   on_trace_ready=tensorboard_trace_handler(profile_dir))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 9:
        print(USAGE)
        return 0
    args = build_parser().parse_args(argv)
    if args.x_placement is not None or (args.mesh and args.out_of_core):
        raise NotImplementedError(SHARDED_OOC)
    cfg = config_from_args(args)
    rank = 0
    if args.mesh:   # before any data is read
        from cumf_als_tpu_torch.parallel.mesh import current_mesh
        rank = current_mesh(args.device).require_world(args.mesh).rank
    try:
        return _train(args, cfg, print if rank == 0 else
                      (lambda *a, **k: None))
    finally:
        import torch.distributed as dist
        if args.mesh and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, cfg, say) -> int:
    """Load, train and report; `say` prints (rank 0) or not."""
    say(f"M = {cfg.m}, N = {cfg.n}, F = {cfg.f}, NNZ = {cfg.nnz}, "
          f"NNZ_TEST = {cfg.nnz_test}, lambda = {cfg.lam:f}\n"
          f"X_BATCH = {cfg.x_batch}, THETA_BATCH = {cfg.theta_batch}\n"
          f"DATA_DIR = {cfg.data_dir} ")

    say("*******start loading training and testing sets to host.")
    test = load_test_coo(cfg.data_dir, cfg.m, cfg.n, cfg.nnz_test)
    csr = load_csr(cfg.data_dir, cfg.m, cfg.n, cfg.nnz)
    csc = load_csc_as_csr(cfg.data_dir, cfg.m, cfg.n, cfg.nnz)

    x0, theta0 = init_factors(cfg.m, cfg.n, cfg.f, cfg.seed,
                              cfg.init_scale)
    start_iter = 0
    if cfg.resume and cfg.checkpoint_dir:
        from cumf_als_tpu_torch.utils.checkpoint import (latest_checkpoint,
                                                         load_checkpoint)
        if latest_checkpoint(cfg.checkpoint_dir) is not None:
            x0, theta0, it = load_checkpoint(cfg.checkpoint_dir, cfg=cfg)
            start_iter = it + 1
            say(f"*******resuming from checkpoint at iteration {it}.")

    t0 = seconds()
    model = make_model(cfg, csr, csc, test, device=args.device)
    with profiled(cfg.profile_dir, model.device):
        model.run(x0, theta0, start_iter=start_iter)
    say(f"\ndoALS takes seconds: {seconds() - t0:.3f} for F = {cfg.f}")
    say("\nALS Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
