"""The panel Grams and the batched solves at f = 256 lanes (factor widths
128 < F <= 256), and the accumulate-then-solve routes that take them,
against the JAX package:

  - the plain versions of K2 and K5a (`gather_gram_out_plain`,
    `gather_gram_aug_out_plain`) against the JAX `gather_gram_out` and
    `gather_gram_aug_out` with the Pallas kernels in interpret mode (as
    tests/test_pallas.py runs them), f32 and bf16 tables and A: b within
    rtol 1e-5, A within the f32 rounding of its sums ((P + 4) ulps of
    sqrt(A_ii A_jj), plus one bf16 ulp for a bf16 A: both sides round
    the f32 sum to nearest);
  - the plain versions of K3, K4 and K5b against `solve_cg_pallas` with
    a diagonal, without, and with aug=True: x within 2e-3
    (tests/test_pallas.py's CG limit);
  - the port's `ALS` forced onto the panel route (a small panel_size) and
    its `OutOfCoreALS`, at F = 136 (f_pad 256), against the JAX
    package's same models on the CPU: RMSE trajectories within 1e-3
    (f32) and 5e-3 / 1e-2 (bf16) at every iteration, the tolerances of
    tests/test_als_e2e.py.

On the card the kernels are held to these plain versions in
tests/test_torch_cuda.py and chip_smoke.py (phase 13)."""

import numpy as np
import pytest
import torch

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.out_of_core import OutOfCoreALS as JOutOfCoreALS
from cumf_als_tpu.ops.tiling import PanelPlan as JPanelPlan

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
from cumf_als_tpu_torch.ops import cuda_solve as cs
from cumf_als_tpu_torch.ops.tiling import PanelPlan

from test_torch_als import (TOLS, _runs, interpret_pallas,  # noqa: F401
                            problem)
from test_torch_out_of_core import _base, _port

F = 256
R, P = 4, 32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _chunk(table_dtype, seed=0, n=40):
    """A zero-extended table (n + 1, 256) with lane 255 zero (the free
    lane of the aug form), cols (R, P) with pad slots naming row n at
    each row's tail and one row of pad slots only, values; numpy from a
    seed."""
    rng = np.random.RandomState(seed)
    table = (rng.standard_normal((n + 1, F)) * 0.3).astype(np.float32)
    table[n] = 0.0
    table[:, F - 1] = 0.0
    nnz = rng.randint(1, P + 1, R)
    nnz[2] = 0
    mask = np.arange(P)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (R, P)), n).astype(np.int32)
    vals = (rng.uniform(1, 5, (R, P)) * mask).astype(np.float32)
    t = torch.from_numpy(table)
    if table_dtype == "bf16":
        t = t.to(torch.bfloat16)
    return table, t, cols, vals


def _within_rounding(a, want, p):
    """|A - A_ref| within (p + 4) f32 ulps of sqrt(A_ii A_jj), + 1e-5, +
    one bf16 ulp of the larger entry when A is bf16."""
    got, ref = a.float().numpy(), want.astype(np.float32)
    d = np.sqrt(np.clip(np.diagonal(ref, axis1=1, axis2=2), 0, None))
    lim = (p + 4) * 2.0 ** -23 * d[:, :, None] * d[:, None, :] + 1e-5
    if a.dtype == torch.bfloat16:
        big = np.maximum(np.abs(got), np.abs(ref))
        lim = lim + np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= lim)


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_panel_grams_at_256_match_jax(interpret_pallas, aug, table_dtype,
                                      out_dtype):
    table_np, table, cols, vals = _chunk(table_dtype, seed=1)
    out = getattr(torch, out_dtype)
    args = (table, torch.from_numpy(cols), torch.from_numpy(vals))
    jargs = (table_np, cols, vals)
    jkw = dict(factor_dtype=table_dtype, out_dtype=out_dtype)
    if aug:
        a = cs.gather_gram_aug_out(*args, out_dtype=out)
        want = np.asarray(ps.gather_gram_aug_out(*jargs, **jkw),
                          dtype=np.float32)
    else:
        a, b = cs.gather_gram_out(*args, out_dtype=out)
        ja, jb = ps.gather_gram_out(*jargs, **jkw)
        want = np.asarray(ja, dtype=np.float32)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                                   atol=1e-6)
    assert a.shape == (R, F, F) and a.dtype == out
    _within_rounding(a, want, P)
    assert torch.all(a[2] == 0)


def _systems(seed, a_dtype):
    """R regularized systems at f = 256 (A = M M^T of a narrow M, so the
    CG has work to do), a diagonal, b and a warm start with lane 255 zero
    (the aug contract); A exact in `a_dtype`."""
    rng = np.random.RandomState(seed)
    m = rng.standard_normal((R, F, 40)).astype(np.float32) * (2 / np.sqrt(F))
    a = torch.from_numpy(np.einsum("rik,rjk->rij", m, m))
    if a_dtype == "bf16":
        a = a.to(torch.bfloat16)
    diag = rng.uniform(0.5, 2.0, R).astype(np.float32)
    b = rng.standard_normal((R, F)).astype(np.float32)
    x0 = (rng.standard_normal((R, F)) * 0.1).astype(np.float32)
    x0[:, F - 1] = 0.0
    return a, diag, b, x0


@pytest.mark.parametrize("kind", ["reg", "plain", "aug"])
@pytest.mark.parametrize("a_dtype", ["f32", "bf16"])
def test_cg_solves_at_256_match_jax(interpret_pallas, kind, a_dtype):
    a, diag, b, x0 = _systems(2, a_dtype)
    if kind == "plain":   # K4 takes systems already regularized
        a = (a.float() + torch.from_numpy(diag)[:, None, None] *
             torch.eye(F)).to(a.dtype)
    ja = a.float().numpy().astype(np.float32)
    if a_dtype == "bf16":
        import jax.numpy as jnp
        ja = jnp.asarray(ja).astype(jnp.bfloat16)
    kw = dict(cg_iters=6, cg_tol=1e-4)
    t = torch.from_numpy
    if kind == "reg":
        x = cs.solve_cg_reg(a, t(diag), t(b), t(x0), **kw)
        want = ps.solve_cg_pallas(ja, b, x0, diag=diag, **kw)
    elif kind == "plain":
        x = cs.solve_cg(a, t(b), t(x0), **kw)
        want = ps.solve_cg_pallas(ja, b, x0, **kw)
    else:
        x = cs.solve_cg_aug(a, t(diag), t(x0), **kw)
        want = ps.solve_cg_pallas(ja, None, x0, diag=diag, aug=True, **kw)
        assert torch.all(x[:, F - 1] == 0)
    assert x.shape == (R, F)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), atol=2e-3,
                               rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_panel_route_at_f_136_matches_jax(problem, interpret_pallas, dtype,
                                          monkeypatch):
    """ALS with the X phase on the panel route at f_pad 256: bf16 split
    buffers (K2, K3) or f32 with aug "auto" (K5a, K5b), every panel Gram
    and solve of the port at f = 256."""
    widths = []
    for name in ("gather_gram_out_plain", "gather_gram_aug_out_plain",
                 "solve_cg_reg_plain", "solve_cg_aug_plain"):
        plain = getattr(cs, name)

        def counted(*a, _plain=plain, _name=name, **k):
            widths.append((_name, a[0].shape[-1]))
            return _plain(*a, **k)
        monkeypatch.setattr(cs, name, counted)
    jal, al, x0, th0 = _runs(problem, dtype, f=136)
    assert al.cfg.f_pad == 256
    assert isinstance(al.plan_x[0], PanelPlan)
    assert isinstance(jal.plan_x[0], JPanelPlan)
    assert al._use_panel_aug() == (dtype == "f32")
    res = al.run(x0, th0)
    gram, solve = (("gather_gram_aug_out_plain", "solve_cg_aug_plain")
                   if dtype == "f32" else
                   ("gather_gram_out_plain", "solve_cg_reg_plain"))
    assert {n for n, _ in widths} == {gram, solve}
    assert {w for _, w in widths} == {F}
    tol_tr, tol_te = TOLS[dtype]
    for got, want in zip(res.history, jal.run(x0, th0).history):
        assert got.train_rmse == pytest.approx(want.train_rmse, abs=tol_tr)
        assert got.test_rmse == pytest.approx(want.test_rmse, abs=tol_te)


def test_out_of_core_at_f_136_matches_jax(medium_problem):
    """OutOfCoreALS at f_pad 256 (theta through K2 and K3 at f = 256 on
    the plain versions) against the JAX OutOfCoreALS on its XLA route, f32
    factors and accumulators, lam 0.5 (where CG-6 converges at this
    width, as the in-core parity tests choose)."""
    jtrain, jtest = medium_problem
    train, test = _port(jtrain, jtest)
    kw = dict(f=136, lam=0.5, factor_dtype="f32", gram_dtype="f32",
              panel_size=64, solver="cg")
    x0, th0 = init_factors(train.num_rows, train.num_cols, 136, seed=3)
    ooc = OutOfCoreALS(ALSConfig(backend="pallas", **_base(train, **kw)),
                       train, None, test, device="cpu")
    assert ooc.cfg.f_pad == 256 and ooc.plan_theta.n_panels > 1
    res = ooc.run(x0, th0)
    ref = JOutOfCoreALS(JConfig(backend="xla", **_base(jtrain, **kw)),
                        jtrain, None, jtest).run(x0, th0)
    for got, want in zip(res.history, ref.history):
        assert got.train_rmse == pytest.approx(want.train_rmse, abs=1e-3)
        assert got.test_rmse == pytest.approx(want.test_rmse, abs=1e-3)
