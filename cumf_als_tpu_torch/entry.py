"""Entry points of the port: a one-step check of the core compute
(`entry`) and a multi-rank dry run of the sharded models
(`dryrun_multichip`), the counterparts of the JAX package's root
__graft_entry__.py.

    python -c "from cumf_als_tpu_torch.entry import dryrun_multichip; \\
        dryrun_multichip(2, device='cpu')"

runs the multi-rank path on the CPU, two gloo ranks, with no card.
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device=None):
    """(fn, example_args): one ALS half-update of the flagship model and
    the rating prediction on its result.

    fn gathers theta's rows for each X row, forms the per-row Gram and
    right-hand side (`ops.gram.gram_rhs`), solves them by CG from x0 in
    6 steps, zeroes the rows without ratings, then predicts the queried
    (row, col) ratings (reference als.cu:443-659, cg.cu:36-231 and the
    RMSE kernel, als.cu:191-219). The solve goes through
    `ops.solve.solve(..., backend="pallas")` without a diagonal: K4 on a
    card, its plain version on the CPU. The arguments are the JAX
    package's (RandomState(0); m=256, n=384, f=128, 32 slots a row, 512
    queries), on `device`: CUDA unless "cpu"."""
    from cumf_als_tpu_torch.models.als import resolve_device
    from cumf_als_tpu_torch.ops.gram import extend_table, gram_rhs
    from cumf_als_tpu_torch.ops.solve import solve

    dev = resolve_device(device)

    def half_update_and_predict(theta, cols, vals, nnz, x0, rows_q,
                                cols_q):
        a, b = gram_rhs(extend_table(theta), cols, vals, nnz, 0.048)
        x = solve(a, b, x0, solver="cg", cg_iters=6, backend="pallas")
        x = x * (nnz > 0).float()[:, None]
        xg = x.index_select(0, rows_q)
        tg = theta.index_select(0, cols_q)
        return (xg * tg).sum(-1)

    rng = np.random.RandomState(0)
    m, n, f, width, batch = 256, 384, 128, 32, 512
    theta = (0.2 * rng.random_sample((n, f))).astype(np.float32)
    nnz = rng.randint(1, width + 1, m).astype(np.int32)
    mask = np.arange(width)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (m, width)), n)
    vals = np.where(mask, rng.uniform(1, 5, (m, width)), 0.0)
    rows_q = rng.randint(0, m, batch).astype(np.int32)
    cols_q = rng.randint(0, n, batch).astype(np.int32)
    args = (theta, cols.astype(np.int32), vals.astype(np.float32), nnz,
            np.zeros((m, f), np.float32), rows_q, cols_q)
    return half_update_and_predict, tuple(
        torch.from_numpy(a).to(dev) for a in args)


def _dryrun_rank(mesh, n_devices: int) -> dict:
    """One rank of the dry run: the JAX package's three models on its
    tiny shapes (__graft_entry__.py:61-116)."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.parallel.sharded_als import ShardedALS
    from cumf_als_tpu_torch.parallel.sharded_ooc import ShardedOutOfCoreALS

    train, test = synthetic_ratings(m=64, n=48, nnz=1500, nnz_test=200,
                                    rank=4, noise=0.1, seed=0)
    # panel_size below n takes the panel X phase: each rank's partial
    # Grams over panels of the replicated table
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=16, lam=0.05,
                    iters=1, verbose=False, debug_timing=False,
                    chunk_nnz=1 << 10, solver="cg", panel_size=16)
    model = ShardedALS(cfg, train, None, test, block_rows=16, mesh=mesh)
    assert model.x_steps is not None, "dryrun must exercise panel X phase"
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    x = model.shard_x(x0)
    theta = model.replicate_theta(
        th0 * (np.diff(model.train_csc.indptr) > 0)[:, None])
    # one training step: the X phase, then the summed theta phase
    x = model.x_phase(theta, x)
    theta, se = model.theta_phase(x, theta)
    se = float(se)
    assert np.isfinite(se), "non-finite train error from sharded step"
    assert bool(torch.isfinite(theta).all())

    # the hugewiki program: X shards in host memory streamed a panel at
    # a time (panels smaller than a rank's 64 / n_devices rows)
    cfg2 = cfg.replace(host_offload_x=True,
                       panel_size=max(2, 32 // max(n_devices, 1)),
                       mesh_shape=(n_devices,))
    ooc = ShardedOutOfCoreALS(cfg2, train, None, test, mesh=mesh)
    assert ooc.n_panels > 1, "dryrun must exercise panel streaming"
    res = ooc.run(x0, th0)
    assert np.isfinite(res.history[-1].train_rmse)

    # X on the card, cold-started CG: the full-hugewiki run mode
    dev = ShardedOutOfCoreALS(cfg2.replace(x_placement="device",
                                           cg_iters=20),
                              train, None, test, mesh=mesh)
    res_d = dev.run(None, th0)
    assert np.isfinite(res_d.history[-1].train_rmse)
    assert np.isfinite(res_d.history[-1].test_rmse)
    return {"train_se": se,
            "ooc_train_rmse": res.history[-1].train_rmse,
            "n_panels": ooc.n_panels,
            "device_x_train_rmse": res_d.history[-1].train_rmse,
            "device_x_test_rmse": res_d.history[-1].test_rmse}


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One step of sharded ALS (panel X phase, theta partials summed over
    the ranks), a sharded out-of-core run with X streamed from host
    shards, and one with X on the card, over `n_devices` ranks spawned by
    `parallel.mesh.spawn`, on tiny shapes. Prints the JAX package's line
    and returns rank 0's numbers.

    device="cpu": gloo ranks on the CPU. Otherwise (the default) the
    ranks take the cards: rank r on cuda:r over NCCL when there are
    n_devices cards, else every rank on cuda:0 over gloo (NCCL refuses
    two ranks on one card); raises without a card."""
    from cumf_als_tpu_torch.models.als import resolve_device
    from cumf_als_tpu_torch.parallel.mesh import spawn

    dev = resolve_device(device)
    if dev.type == "cpu":
        kw = dict(device="cpu")
    elif n_devices <= torch.cuda.device_count():
        kw = dict(backend="nccl")
    else:
        kw = dict(backend="gloo", device=f"cuda:{dev.index or 0}")
    out = spawn(n_devices, _dryrun_rank, n_devices, timeout=600, **kw)[0]
    print(f"dryrun_multichip({n_devices}): ok, "
          f"train_se={out['train_se']:.4f}, "
          f"sharded+ooc train_rmse={out['ooc_train_rmse']:.4f} "
          f"({out['n_panels']} panels streamed), device-X "
          f"train_rmse={out['device_x_train_rmse']:.4f}", flush=True)
    return out
