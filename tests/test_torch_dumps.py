"""The save_model dumps of the port's ALS against the JAX package's ALS:
the same file names, each array within 2e-3, on each of the three routes
that dump a Gram (direct, panel, batched panel); OutOfCoreALS and
ShardedALS take save_model and, as in the JAX package, write nothing;
and the CLI's --profile-dir trace."""

import glob
import json
import os

import numpy as np
import pytest

from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.als import ALS as JALS

from cumf_als_tpu_torch import cli
from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors, synthetic_ratings
from cumf_als_tpu_torch.models.als import ALS
from cumf_als_tpu_torch.models.factory import make_model
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix, write_dataset

ROUTES = {
    "direct": {},
    "panel": dict(panel_size=16),
    # the full accumulators (61 x 128^2 x 4 B) pass the budget
    "batched_panel": dict(panel_size=16, panel_budget_bytes=1 << 20,
                          batch_rows=32, solver="cholesky"),
}


def _port(train, test):
    return (CSRMatrix(indptr=train.indptr, indices=train.indices,
                      data=train.data, num_rows=train.num_rows,
                      num_cols=train.num_cols),
            COOMatrix(row=test.row, col=test.col, data=test.data,
                      num_rows=test.num_rows, num_cols=test.num_cols))


def _base(train, out, **kw):
    return dict(dict(m=train.num_rows, n=train.num_cols, f=16, lam=0.5,
                     iters=2, verbose=False, debug_timing=False,
                     save_model=True, save_model_dir=str(out)), **kw)


def _dumps(d):
    return {os.path.basename(p): np.fromfile(p, np.float32)
            for p in glob.glob(os.path.join(str(d), "*.bin"))}


@pytest.mark.parametrize("route", list(ROUTES))
def test_dumps_equal_the_jax_dumps(small_problem, tmp_path, route):
    jtrain, jtest = small_problem
    train, test = _port(jtrain, jtest)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    kw = ROUTES[route]
    model = ALS(ALSConfig(**_base(train, tmp_path / "port", **kw)), train,
                None, test, device="cpu")
    assert {type(model.plan_x[0]).__name__,
            type(model.plan_theta[0]).__name__} >= {
        "direct": {"UpdatePlan"}, "panel": {"PanelPlan"},
        "batched_panel": {"BatchedPanelPlan"}}[route]
    model.run(x0, th0)
    JALS(JConfig(**_base(jtrain, tmp_path / "jax", **kw)), jtrain, None,
         jtest).run(x0, th0)
    ours, theirs = _dumps(tmp_path / "port"), _dumps(tmp_path / "jax")
    assert sorted(ours) == sorted(theirs)
    for it in range(2):
        for stem in ("tt", "ytheta", "xx", "yTX", "XT", "thetaT"):
            assert f"{stem}_iter{it:03d}.bin" in ours
    for name, arr in theirs.items():
        np.testing.assert_allclose(ours[name], arr, rtol=2e-3, atol=2e-3,
                                   err_msg=name)


@pytest.mark.parametrize("model", ["out_of_core", "sharded"])
def test_other_models_take_save_model_and_write_nothing(small_problem,
                                                        tmp_path, model):
    train, test = _port(*small_problem)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    kw = dict(host_offload_x=True, panel_size=16) if model == \
        "out_of_core" else dict(mesh_shape=(1,))
    cfg = ALSConfig(**_base(train, tmp_path / "log", **kw))
    res = make_model(cfg, train, None, test, device="cpu").run(x0, th0)
    assert len(res.history) == 2 and np.isfinite(res.history[-1].test_rmse)
    assert not os.path.exists(tmp_path / "log")


def test_profile_dir_writes_a_trace(tmp_path, capsys):
    tr, te = synthetic_ratings(m=30, n=20, nnz=300, nnz_test=40, seed=1)
    d = str(tmp_path / "ds")
    write_dataset(d, tr, te)
    argv = ["30", "20", "16", str(tr.nnz), str(te.nnz), "0.05", "1", "1",
            d, "--device", "cpu", "--iters", "2", "--backend", "pallas",
            "--profile-dir", str(tmp_path / "trace")]
    assert cli.main(argv) == 0
    assert "ALS Done." in capsys.readouterr().out
    (path,) = glob.glob(str(tmp_path / "trace" / "*.json"))
    with open(path) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
