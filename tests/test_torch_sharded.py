"""The port's sharded training (cumf_als_tpu_torch/parallel/) against the
JAX package's parallel/: the plans array for array at 1, 2 and 4 ranks,
sharded plan-cache entries across the two packages both ways, and
ShardedALS against the JAX ShardedALS (backend "xla", on the conftest's
8-device CPU mesh) at one rank in this process and at two ranks on gloo
through the spawn helper, whose ranks import no JAX. The port runs the
"xla" backend and the "pallas" one, whose wrappers take the kernels'
plain versions for CPU tensors. Two ranks on the card are held to two
ranks on the CPU in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.parallel import plan as jplan
from cumf_als_tpu.parallel.sharded_als import ShardedALS as JShardedALS
from cumf_als_tpu.utils import plan_cache as jpc
from cumf_als_tpu.utils.io import transpose_csr as jtranspose

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.als import ALS
from cumf_als_tpu_torch.parallel import plan
from cumf_als_tpu_torch.parallel.mesh import current_mesh, spawn
from cumf_als_tpu_torch.parallel.sharded_als import ShardedALS, run_rank
from cumf_als_tpu_torch.utils import plan_cache as pc
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix, transpose_csr


def _port(train, test=None):
    csr = CSRMatrix(indptr=train.indptr, indices=train.indices,
                    data=train.data, num_rows=train.num_rows,
                    num_cols=train.num_cols)
    if test is None:
        return csr
    return csr, COOMatrix(row=test.row, col=test.col, data=test.data,
                          num_rows=test.num_rows, num_cols=test.num_cols)


def _plans(mod, csr, csc, n_dev):
    """The three eager sharded plans made by `mod` (the port's
    or the JAX package's parallel/plan.py)."""
    row = mod.build_sharded_row_plan(csr, n_dev, chunk_nnz=1 << 10,
                                     chunk_rows=64, octave_points=8)
    red = mod.build_reduce_plan(csc, row, block_rows=64)
    steps = mod.AlignedSteps(*mod.build_sharded_x_panel_steps(
        csr, row, 64, chunk_nnz=1 << 10, chunk_rows=64))
    return {"sharded_row": row, "reduce": red, "aligned_steps": steps}


def _arrays(p):
    """Every array and count of a sharded plan, in one flat list."""
    if hasattr(p, "blocks"):
        return [p.n_dev, p.n, p.m_loc, len(p.blocks)] + [
            a for b in p.blocks for a in (b.width, b.rows, b.nnz_local,
                                          b.nnz_total, b.cols, b.vals)]
    chunks = p.steps if hasattr(p, "steps") else p.chunks
    head = [p.n_panels] if hasattr(p, "steps") else \
        [p.n_dev, p.m, p.m_loc, p.num_cols, p.global_ids]
    return head + [len(chunks)] + [
        a for c in chunks for a in (c.width, getattr(c, "panel", -1),
                                    c.rows, c.nnz, c.cols, c.vals)]


def _same(a, b):
    aa, bb = _arrays(a), _arrays(b)
    assert len(aa) == len(bb)
    for x, y in zip(aa, bb):
        if isinstance(x, np.ndarray):
            assert np.asarray(y).dtype == x.dtype
            np.testing.assert_array_equal(np.asarray(y), x)
        else:
            assert x == y


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_plans_equal_the_jax_plans(medium_problem, n_dev):
    jtrain = medium_problem[0]
    csr = _port(jtrain)
    ours = _plans(plan, csr, transpose_csr(csr), n_dev)
    theirs = _plans(jplan, jtrain, jtranspose(jtrain), n_dev)
    for kind in ours:
        _same(ours[kind], theirs[kind])


@pytest.mark.parametrize("kind", ["sharded_row", "reduce",
                                  "aligned_steps"])
def test_entries_carry_across_both_ways(medium_problem, tmp_path, kind):
    jtrain = medium_problem[0]
    csr = _port(jtrain)
    ours = _plans(plan, csr, transpose_csr(csr), 2)[kind]
    theirs = _plans(jplan, jtrain, jtranspose(jtrain), 2)[kind]
    pc.save_plan(str(tmp_path), "port", ours)
    jpc.save_plan(str(tmp_path), "jax", theirs)
    _same(theirs, jpc.load_plan(str(tmp_path), "port"))
    _same(ours, pc.load_plan(str(tmp_path), "jax"))


def _base(train, **kw):
    return dict(dict(m=train.num_rows, n=train.num_cols, f=16, lam=0.5,
                     iters=2, verbose=False, debug_timing=False,
                     chunk_nnz=1 << 11), **kw)


_JAX_RUNS = {}


def _jax_run(problem, n_dev, **kw):
    """The JAX ShardedALS on its "xla" backend (memoized: the port's two
    backends share it)."""
    key = (id(problem), n_dev, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        train, test = problem
        x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
        _JAX_RUNS[key] = JShardedALS(
            JConfig(backend="xla", **_base(train, **kw)), train, None, test,
            n_devices=n_dev, block_rows=64).run(x0, th0)
    return _JAX_RUNS[key]


def _close(history, x, theta, ref):
    for a, b in zip(ref.history, history, strict=True):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=2e-3)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=2e-3)
    np.testing.assert_allclose(x, ref.x, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(theta, ref.theta, rtol=2e-2, atol=2e-2)


# panels of 32 theta rows: X takes the panel steps in both packages
PANEL = dict(panel_size=32, chunk_rows=32)


@pytest.mark.parametrize("backend,extra", [
    ("xla", {}), ("pallas", {}),
    ("pallas", dict(gram_dtype="f32", aug_gram="force")),
    ("pallas", PANEL)])
def test_world_one_matches_jax(small_problem, backend, extra):
    """One rank in this process: on "pallas" K1 (K6 with aug "force")
    solves each reduce block directly, on "xla" the partial Grams go
    through the (identity) sum and the solve. With PANEL X takes the
    panel steps (K5a, K5b; plain versions here)."""
    train, test = _port(*small_problem)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    model = ShardedALS(ALSConfig(backend=backend, **_base(train, **extra)),
                       train, None, test, n_devices=1, block_rows=64,
                       device="cpu")
    assert model.single_fused() == (backend == "pallas")
    assert (model.x_steps is not None) == (extra is PANEL)
    res = model.run(x0, th0)
    _close(res.history, res.x, res.theta,
           _jax_run(small_problem, 1, **extra))


@pytest.mark.parametrize("backend,extra", [
    ("xla", {}), ("pallas", {}), ("pallas", PANEL)])
def test_world_two_matches_jax(small_problem, backend, extra):
    """Two ranks on gloo, spawned: each against the JAX ShardedALS on two
    mesh devices; theta equal bit for bit on both ranks, the gathered X
    equal to each rank's own rows. With PANEL X takes the panel steps."""
    train, test = _port(*small_problem)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    cfg = ALSConfig(backend=backend, **_base(train, **extra))
    ranks = spawn(2, run_rank, cfg, (train, test), x0, th0, 64,
                  device="cpu", timeout=120)
    ref = _jax_run(small_problem, 2, **extra)
    for r in ranks:
        assert (r["x_steps"] > 0) == (extra is PANEL)
        _close(r["history"], r["x"], ranks[0]["theta"], ref)
        np.testing.assert_array_equal(r["x"][r["own_ids"]], r["own_x"])
    assert ranks[0]["theta_sha256"] == ranks[1]["theta_sha256"]
    assert len(set(ranks[0]["theta_sha256"])) == 2   # theta moved
    assert np.array_equal(ranks[0]["x"], ranks[1]["x"])
    assert sorted(np.concatenate([r["own_ids"] for r in ranks])) == \
        list(range(train.num_rows))


def test_panel_x_phase_matches_single_device(medium_problem):
    """A small panel_size puts X on the panel steps (as
    tests/test_parallel.py does for the JAX package): K5a into the
    augmented accumulators, K5b over the solve slices (plain versions),
    against the port's single-device ALS (the same steps against the JAX
    ShardedALS: test_world_one_matches_jax, test_world_two_matches_jax)."""
    train, test = _port(*medium_problem)
    base = _base(train, backend="pallas", panel_size=32, chunk_rows=64)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    model = ShardedALS(ALSConfig(**base), train, None, test, block_rows=64,
                       device="cpu")
    assert model.x_steps is not None and model.x_n_panels > 1
    assert model._x_m_pad // model._x_solve_batch > 1
    res = model.run(x0, th0)
    ref = ALS(ALSConfig(use_panels="never", train_rmse_method="direct",
                        **base), train, None, test, device="cpu").run(x0, th0)
    _close(res.history, res.x, res.theta, ref)


def test_the_world_must_match_and_no_silent_cpu(small_problem):
    train, test = _port(*small_problem)
    cfg = ALSConfig(**_base(train))
    mesh = current_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    t = torch.arange(6.0).reshape(3, 2)
    assert mesh.all_reduce_sum(t) is t and mesh.all_gather(t).shape == \
        (1, 3, 2)
    with pytest.raises(ValueError, match="world has 1 rank"):
        ShardedALS(cfg, train, None, test, n_devices=2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ShardedALS(cfg, train, None, test)
        # a spawned rank runs on the card unless named otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            spawn(1, run_rank, cfg, (train, test), None, None, timeout=60)
