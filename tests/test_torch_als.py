"""The port's ALS as a whole against the JAX package's ALS (its Pallas
kernels run in interpret mode) and the numpy oracle.

The problem is the transposed `small_problem` (45 rows, 60 columns), so
that with panel_size=40 the X phase gathers from a 60-row table and
takes the panel route while the theta phase (a 45-row table) stays
direct: both routes of the main path run, as on the Netflix shape. With
f32 accumulators and aug_gram="auto" (the defaults) the panel route
keeps one augmented accumulator; tests/test_torch_als_aug.py holds the
tests of the augmented routes and their gates."""

import contextlib
import io

import numpy as np
import pytest
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.als import ALS as JALS
from cumf_als_tpu.ops.tiling import PanelPlan as JPanelPlan
from cumf_als_tpu.ops.tiling import UpdatePlan as JUpdatePlan
from cumf_als_tpu.utils.io import COOMatrix as JCOO
from cumf_als_tpu.utils.io import transpose_csr as j_transpose

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.als import ALS, do_als
from cumf_als_tpu_torch.models.reference_numpy import numpy_als
from cumf_als_tpu_torch.ops.tiling import PanelPlan, UpdatePlan
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix, coo_to_csr


@pytest.fixture()
def interpret_pallas(monkeypatch):
    """Every pallas_call of the JAX package in interpret mode, with the
    probe caches reset so its availability gates re-probe under the
    interpreter (on the CPU they would otherwise send it down its XLA
    route)."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    flags = ("_STATUS", "_AUG_STATUS", "_CG_STATUS", "_PANEL_AUG_STATUS",
             "_WIDE_STATUS")
    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    for flag in flags:
        monkeypatch.setattr(ps, flag, None)
    yield
    for flag in flags:
        setattr(ps, flag, None)


@pytest.fixture(scope="module")
def problem(small_problem):
    """small_problem transposed, in both packages' matrix types."""
    train, test = small_problem
    tt = j_transpose(train)
    csr = CSRMatrix(indptr=tt.indptr, indices=tt.indices, data=tt.data,
                    num_rows=tt.num_rows, num_cols=tt.num_cols)
    coo = COOMatrix(row=test.col, col=test.row, data=test.data,
                    num_rows=test.num_cols, num_cols=test.num_rows)
    jcoo = JCOO(row=test.col, col=test.row, data=test.data,
                num_rows=test.num_cols, num_cols=test.num_rows)
    return tt, jcoo, csr, coo


# lam=0.5: with f=100 and ~30 ratings per row every Gram is rank-deficient
# apart from its ridge, and at lam=0.05 six CG steps in f32 amplify
# rounding until the JAX package itself drifts beyond these tolerances
# from the exact oracle; at lam=0.5 CG-6 converges and the comparison is
# sharp.
FIELDS = dict(f=100, lam=0.5, iters=3, verbose=False, debug_timing=False,
              chunk_nnz=1 << 12, backend="pallas", solver="cg",
              panel_size=40, train_rmse_method="fused")
DTYPES = {"f32": dict(factor_dtype="f32", gram_dtype="f32"),
          "bf16": dict(factor_dtype="bf16", gram_dtype="bf16")}
# per-iteration (train, test) RMSE tolerances (tests/test_als_e2e.py)
TOLS = {"f32": (1e-3, 1e-3), "bf16": (5e-3, 1e-2)}


def _runs(problem, dtype, **extra):
    jtrain, jtest, train, test = problem
    kw = dict(FIELDS, m=train.num_rows, n=train.num_cols, **DTYPES[dtype],
              **extra)
    x0, th0 = init_factors(kw["m"], kw["n"], kw["f"], seed=1)
    jal = JALS(JConfig(**kw), jtrain, None, jtest)
    al = ALS(ALSConfig(**kw), train, None, test, device="cpu")
    return jal, al, x0, th0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_trajectory_matches_jax_and_oracle(problem, interpret_pallas,
                                           dtype):
    jal, al, x0, th0 = _runs(problem, dtype)
    assert isinstance(jal.plan_x[0], JPanelPlan)
    assert isinstance(jal.plan_theta[0], JUpdatePlan)
    assert isinstance(al.plan_x[0], PanelPlan)
    assert isinstance(al.plan_theta[0], UpdatePlan)
    jres = jal.run(x0, th0)
    res = al.run(x0, th0)
    _, _, ref = numpy_als(problem[2], problem[3], x0, th0, FIELDS["lam"],
                          FIELDS["iters"])
    tol_tr, tol_te = TOLS[dtype]
    for got, want, (rt, re) in zip(res.history, jres.history, ref):
        assert got.train_rmse == pytest.approx(want.train_rmse, abs=tol_tr)
        assert got.test_rmse == pytest.approx(want.test_rmse, abs=tol_te)
        assert got.train_rmse == pytest.approx(rt, abs=tol_tr)
        assert got.test_rmse == pytest.approx(re, abs=tol_te)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_exact_solver_matches_oracle(problem, backend):
    """Cholesky on either backend: the panel route's K2 plain version (or
    the plain einsum) and the direct route's gram_rhs feed an exact solve,
    so the trajectory is the oracle's within f32 rounding."""
    _, _, train, test = problem
    cfg = ALSConfig(**dict(FIELDS, m=train.num_rows, n=train.num_cols,
                           backend=backend, solver="cholesky", f=16,
                           lam=0.05))
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=1)
    res = do_als(train, None, test, th0, x0, cfg, device="cpu")
    _, _, ref = numpy_als(train, test, x0, th0, cfg.lam, cfg.iters)
    for got, (rt, re) in zip(res.history, ref):
        assert got.train_rmse == pytest.approx(rt, abs=1e-3)
        assert got.test_rmse == pytest.approx(re, abs=1e-3)


def test_empty_rows_get_zero_factors():
    # rows 3 and 7 of m=10 have no ratings; cols 5+ of n=8 empty
    rows = np.array([0, 0, 1, 2, 4, 5, 6, 8, 9, 1], np.int32)
    cols = np.array([0, 1, 2, 3, 4, 0, 1, 2, 3, 4], np.int32)
    vals = np.linspace(1, 5, 10).astype(np.float32)
    train = coo_to_csr(COOMatrix(row=rows, col=cols, data=vals,
                                 num_rows=10, num_cols=8))
    test = COOMatrix(row=np.array([3], np.int32),
                     col=np.array([7], np.int32),
                     data=np.array([2.5], np.float32),
                     num_rows=10, num_cols=8)
    cfg = ALSConfig(m=10, n=8, f=8, lam=0.05, iters=2, verbose=False,
                    debug_timing=False, backend="pallas", solver="cg")
    x0, th0 = init_factors(10, 8, 8, seed=0)
    res = do_als(train, None, test, th0, x0, cfg, device="cpu")
    np.testing.assert_allclose(res.x[3], 0.0)
    np.testing.assert_allclose(res.x[7], 0.0)
    np.testing.assert_allclose(res.theta[5:], 0.0)
    # prediction 0 => test RMSE = |r|
    assert res.history[-1].test_rmse == pytest.approx(2.5, abs=1e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_nonfinite_guard(problem, backend):
    _, _, train, test = problem
    cfg = ALSConfig(**dict(FIELDS, m=train.num_rows, n=train.num_cols,
                           backend=backend, iters=1, lam=float("nan")))
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    with pytest.raises(FloatingPointError):
        do_als(train, None, test, th0, x0, cfg, device="cpu")


def _contract_lines(text: str):
    """The stdout contract lines with the RMSE digits cut off."""
    out = []
    for line in text.splitlines():
        if "RMSE in iter" in line:
            line = line.rsplit(":", 1)[0]
        out.append(line)
    return out


def test_stdout_contract_matches_jax(problem, interpret_pallas):
    jal, al, x0, th0 = _runs(problem, "bf16", verbose=True)
    jbuf, buf = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        jal.run(x0, th0)
    with contextlib.redirect_stdout(buf):
        al.run(x0, th0)
    lines = _contract_lines(buf.getvalue())
    assert lines == _contract_lines(jbuf.getvalue())
    assert sum("Train RMSE in iter" in ln for ln in lines) == 3
    assert sum("Test RMSE in iter" in ln for ln in lines) == 3


def test_checkpoint_resume_identical(problem, tmp_path):
    _, _, train, test = problem
    cfg = ALSConfig(**dict(FIELDS, m=train.num_rows, n=train.num_cols,
                           iters=4, solver="cholesky", f=16,
                           checkpoint_dir=str(tmp_path),
                           checkpoint_every=1))
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    full = do_als(train, None, test, th0, x0, cfg, device="cpu")
    from cumf_als_tpu_torch.utils.checkpoint import load_checkpoint
    x1, th1, it = load_checkpoint(str(tmp_path), 1, cfg=cfg)
    rest = ALS(cfg, train, None, test, device="cpu").run(x1, th1,
                                                         start_iter=it + 1)
    np.testing.assert_allclose(rest.x, full.x, rtol=1e-5, atol=1e-6)
    assert rest.history[-1].test_rmse == pytest.approx(
        full.history[-1].test_rmse, abs=1e-6)
