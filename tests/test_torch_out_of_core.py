"""The port's out-of-core ALS (cumf_als_tpu_torch/models/out_of_core.py)
against the port's in-memory ALS and against the JAX package's
OutOfCoreALS; the model factory; the CLI and the bench with
--out-of-core. The streamed run on the card is held to the same run on
the CPU in tests/test_torch_cuda.py."""

import json

import numpy as np
import pytest
import torch

from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.out_of_core import OutOfCoreALS as JOutOfCoreALS

from cumf_als_tpu_torch import bench, cli
from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors, synthetic_ratings
from cumf_als_tpu_torch.models.als import ALS
from cumf_als_tpu_torch.models.factory import make_model
from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix, write_dataset


def _port(train, test):
    return (CSRMatrix(indptr=train.indptr, indices=train.indices,
                      data=train.data, num_rows=train.num_rows,
                      num_cols=train.num_cols),
            COOMatrix(row=test.row, col=test.col, data=test.data,
                      num_rows=test.num_rows, num_cols=test.num_cols))


def _base(train, **kw):
    base = dict(m=train.num_rows, n=train.num_cols, f=16, lam=0.05,
                iters=3, verbose=False, debug_timing=False,
                chunk_nnz=1 << 11, chunk_rows=128)
    base.update(kw)
    return base


def _close(res, ref, tol=2e-3):
    for a, b in zip(ref.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=tol)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=tol)
    np.testing.assert_allclose(res.x, ref.x, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(res.theta, ref.theta, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("solver", [
    pytest.param("cholesky", marks=pytest.mark.slow), "cg"])
def test_ooc_matches_in_memory(medium_problem, solver):
    train, test = _port(*medium_problem)
    base = _base(train, solver=solver, backend="pallas")
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    ref = ALS(ALSConfig(use_panels="never", train_rmse_method="direct",
                        **base), train, None, test, device="cpu").run(x0, th0)
    ooc = OutOfCoreALS(ALSConfig(panel_size=64, **base), train, None, test,
                       device="cpu")
    res = ooc.run(x0, th0)
    assert ooc.plan_theta.n_panels > 1   # X streamed in panels
    assert ooc.n_slices > 1              # theta solved in slices
    _close(res, ref)


@pytest.mark.parametrize("dtypes,lam", [("f32", 0.05), ("bf16", 0.5)])
def test_ooc_matches_the_jax_ooc(medium_problem, dtypes, lam):
    """The same x0 and theta0 from a numpy seed through both packages'
    OutOfCoreALS: the port on the kernels' plain versions (K1, K2, K3),
    the JAX package on its XLA route. bf16 factors and bf16 Gram
    accumulators are the chip's configuration (the accumulators stay
    bf16 at this depth). With them, at lam 0.05, the JAX run alone moves
    by 4e-3 in train RMSE and 0.2 in x when theta0 moves by 1e-6: a
    flipped bf16 rounding grows through CG-6 there, so that case runs at
    lam 0.5, where CG-6 converges (as the in-core parity tests do)."""
    jtrain, jtest = medium_problem
    train, test = _port(jtrain, jtest)
    kw = dict(factor_dtype=dtypes, gram_dtype=dtypes, panel_size=64,
              solver="cg", lam=lam)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=3)
    ooc = OutOfCoreALS(ALSConfig(backend="pallas", **_base(train, **kw)),
                       train, None, test, device="cpu")
    assert ooc.accum_dtype == (torch.bfloat16 if dtypes == "bf16"
                               else torch.float32)
    res = ooc.run(x0, th0)
    ref = JOutOfCoreALS(JConfig(backend="xla", **_base(jtrain, **kw)),
                        jtrain, None, jtest).run(x0, th0)
    _close(res, ref)


def test_ooc_hugewiki_shape_smoke():
    """Tall-skinny hugewiki shape (m >> n) at toy scale."""
    train, test = synthetic_ratings(m=5000, n=40, nnz=60000, nnz_test=3000,
                                    rank=4, noise=0.1, skew=(0.3, 0.3),
                                    seed=9)
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=16, lam=0.05,
                    iters=2, verbose=False, debug_timing=False,
                    panel_size=1024, chunk_rows=512, solver="cg",
                    backend="pallas")
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    res = OutOfCoreALS(cfg, train, None, test, device="cpu").run(x0, th0)
    assert res.history[-1].train_rmse < res.history[0].train_rmse
    assert np.isfinite(res.history[-1].test_rmse)


@pytest.mark.parametrize("gram_dtype,panel_size,accum", [
    ("bf16", 64, torch.bfloat16), ("bf16", 8, torch.float32),
    ("f32", 64, torch.float32)])
def test_accumulator_depth_guard(medium_problem, gram_dtype, panel_size,
                                 accum, capsys):
    """bf16 accumulators only up to 16 partial adds per theta row (at
    panel size 8 the rows take ~30)."""
    train, test = _port(*medium_problem)
    ooc = OutOfCoreALS(ALSConfig(gram_dtype=gram_dtype,
                                 panel_size=panel_size, **_base(train)),
                       train, None, test, device="cpu")
    assert ooc.accum_dtype == accum
    assert f"theta accumulators {accum}" in capsys.readouterr().err


def test_ooc_checkpoints_and_metrics(medium_problem, tmp_path):
    from cumf_als_tpu_torch.utils.checkpoint import load_checkpoint
    train, test = _port(*medium_problem)
    cfg = ALSConfig(panel_size=64, iters=2, checkpoint_every=1,
                    checkpoint_dir=str(tmp_path / "ck"),
                    metrics_jsonl=str(tmp_path / "m.jsonl"),
                    **{k: v for k, v in _base(train).items()
                       if k != "iters"})
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=1)
    res = OutOfCoreALS(cfg, train, None, test, device="cpu").run(x0, th0)
    x, th, it = load_checkpoint(str(tmp_path / "ck"), cfg=cfg)
    assert it == 1
    np.testing.assert_array_equal(x, res.x)
    np.testing.assert_array_equal(th, res.theta)
    lines = open(tmp_path / "m.jsonl").read().splitlines()
    assert [json.loads(s)["iteration"] for s in lines] == [0, 1]


def test_factory_picks_the_model(medium_problem):
    train, test = _port(*medium_problem)
    base = _base(train, panel_size=64)
    assert type(make_model(ALSConfig(**base), train, None, test,
                           device="cpu")) is ALS
    assert type(make_model(ALSConfig(host_offload_x=True, **base), train,
                           None, test, device="cpu")) is OutOfCoreALS
    from cumf_als_tpu_torch.parallel.sharded_als import ShardedALS
    assert type(make_model(ALSConfig(mesh_shape=(1,), **base), train, None,
                           test, device="cpu")) is ShardedALS
    with pytest.raises(ValueError, match="world has 1 rank"):
        make_model(ALSConfig(mesh_shape=(2,), **base), train, None, test,
                   device="cpu")
    from cumf_als_tpu_torch.parallel.sharded_ooc import ShardedOutOfCoreALS
    assert type(make_model(ALSConfig(mesh_shape=(1,), host_offload_x=True,
                                     **base), train, None, test,
                           device="cpu")) is ShardedOutOfCoreALS
    with pytest.raises(ValueError, match="world has 1 rank"):
        make_model(ALSConfig(mesh_shape=(2,), host_offload_x=True, **base),
                   train, None, test, device="cpu")
    if not torch.cuda.is_available():   # no silent CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_model(ALSConfig(host_offload_x=True, **base), train)


def test_cli_out_of_core_on_the_cpu(tmp_path, capsys):
    tr, te = synthetic_ratings(m=60, n=45, nnz=1400, nnz_test=200, rank=4,
                               seed=3)
    d = str(tmp_path / "ds")
    write_dataset(d, tr, te)
    argv = ["60", "45", "16", str(tr.nnz), str(te.nnz), "0.05", "1", "1",
            d, "--iters", "2", "--device", "cpu", "--backend", "pallas",
            "--out-of-core"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "*******out-of-core: X host-resident, theta on device" in out
    assert "--------- Test RMSE in iter 1:" in out and "ALS Done." in out


def test_bench_out_of_core_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path / "cache"))
    args = ["--device", "cpu", "--workload", "ml10m", "--scale", "0.005",
            "--iters", "3"]
    assert bench.main(args + ["--out-of-core"]) == 0
    captured = capsys.readouterr()
    ooc = json.loads(captured.out.strip().splitlines()[-1])
    assert "[bench] OOC plans built" in captured.err
    assert (tmp_path / "plans").is_dir()   # the plan cache took the plans
    assert bench.main(args) == 0
    inc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(ooc) == list(inc)
    assert ooc["train_rmse_final"] == pytest.approx(inc["train_rmse_final"],
                                                    abs=2e-3)
    assert ooc["test_rmse_final"] == pytest.approx(inc["test_rmse_final"],
                                                   abs=2e-3)
