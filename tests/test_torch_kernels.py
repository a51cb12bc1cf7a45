"""The plain versions of the port's split-buffer kernels against the JAX
package's Pallas kernels (interpret mode), on the same numpy inputs (the
augmented-lane kernels and the solve without a diagonal have
tests/test_torch_aug.py):

  K1 gather_gram_cg   <-> pallas_solve.gather_gram_cg   (B1, _kernel)
  K2 gather_gram_out  <-> pallas_solve.gather_gram_out  (B2, _gram_kernel)
  K3 solve_cg_reg     <-> pallas_solve.solve_cg_pallas(diag=...)
                                                  (B3, _cg_solve_reg_kernel)

On the CPU each wrapper takes its plain version, and that is what these
tests reach through the wrappers. The CUDA kernels themselves run only
on a card: tests/test_torch_cuda.py compares them with the plain
versions there.

Tolerances: A and b rtol 1e-5 in f32 (the same sums in another order);
bf16 A within one bf16 ulp (both round one f32 sum, which may differ in
its last bits); x and se 2e-3 absolute at the default cg_iters=6 (the
tolerance of tests/test_pallas.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu_torch.ops import cuda_solve as cs


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    yield


R, P, F, N, LAM = 16, 48, 128, 50, 0.05


def _chunk(seed=0, zero_rows=(3,)):
    """A plan-shaped chunk: pad slots at each row's tail name the zero
    row N of the extended table and carry value 0."""
    rng = np.random.RandomState(seed)
    table = (rng.standard_normal((N + 1, F)) * 0.3).astype(np.float32)
    table[N] = 0.0
    nnz = rng.randint(1, P + 1, (R,)).astype(np.int32)
    for z in zero_rows:
        nnz[z] = 0
    mask = np.arange(P)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, N, (R, P)), N).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (R, P)) * 2) / 2 * mask
            ).astype(np.float32)
    x0 = (rng.standard_normal((R, F)) * 0.1).astype(np.float32)
    return table, cols, vals, nnz, x0


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _table(a, factor_dtype):
    """The gather table as models/als.py hands it to the kernels: a bf16
    run casts it before the gather, as the JAX wrappers' factor_dtype."""
    return _t(a, torch.bfloat16 if factor_dtype == "bf16" else None)


def _j(a, bf16=False):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else None)


def _bf16_ulp(a):
    a = np.abs(a).astype(np.float32)
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


# ---------------------------------------------------------------- K1 --
@pytest.mark.parametrize("factor_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("vals_bf16", [False, True])
def test_gather_gram_cg_matches_pallas(factor_dtype, vals_bf16):
    table, cols, vals, nnz, x0 = _chunk()
    jx, jse = ps.gather_gram_cg(_j(table), _j(cols), _j(vals, vals_bf16),
                                _j(nnz), _j(x0), LAM,
                                factor_dtype=factor_dtype)
    x, se = cs.gather_gram_cg(
        _table(table, factor_dtype), _t(cols),
        _t(vals, torch.bfloat16 if vals_bf16 else None),
        _t(nnz), _t(x0), LAM)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-3)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), atol=2e-3)
    np.testing.assert_array_equal(x.numpy()[3], 0.0)   # the empty row


def _exact(table, cols, vals, nnz):
    g = np.where((cols < N)[:, :, None], table[cols], 0.0).astype(np.float64)
    x = np.zeros((R, F))
    se = np.zeros(R)
    for i in range(R):
        a = g[i].T @ g[i] + (nnz[i] * LAM + (nnz[i] == 0)) * np.eye(F)
        x[i] = np.linalg.solve(a, g[i].T @ vals[i]) * (nnz[i] > 0)
        e = vals[i][:nnz[i]] - g[i][:nnz[i]] @ x[i]
        se[i] = np.sum(e * e)
    return x, se


def test_gather_gram_cg_converges_to_exact_solve():
    table, cols, vals, nnz, _ = _chunk(seed=1)
    x, se = cs.gather_gram_cg(_t(table), _t(cols), _t(vals), _t(nnz),
                              torch.zeros(R, F), LAM, cg_iters=40,
                              cg_tol=1e-12)
    ref_x, ref_se = _exact(table, cols, vals, nnz)
    np.testing.assert_allclose(x.numpy(), ref_x, atol=2e-3)
    np.testing.assert_allclose(se.numpy()[:, 0], ref_se, rtol=1e-2,
                               atol=1e-2)


def test_gather_gram_cg_early_exits_match_pallas():
    """Rows that stop in CG iteration 1 (every slot names one table row
    g and x0 = 0, so the residual b is an eigenvector of A = k g g^T +
    ridge and one step is exact), and rows warm-started at the solution
    (rsold below tol from the start)."""
    table, cols, vals, nnz, x0 = _chunk(seed=2, zero_rows=())
    cols[:4] = np.where(cols[:4] < N, 7, N)
    x0[:4] = 0.0
    ref_x, _ = _exact(table, cols, vals, nnz)
    x0[4:8] = ref_x[4:8]
    args = (table, cols, vals, nnz, x0)
    jx, jse = ps.gather_gram_cg(*map(_j, args), LAM)
    x, se = cs.gather_gram_cg(*map(_t, args), LAM)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-3)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), atol=2e-3)
    np.testing.assert_allclose(x.numpy()[:8], ref_x[:8], atol=2e-3)


# ---------------------------------------------------------------- K2 --
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("vals_bf16", [False, True])
def test_gather_gram_out_matches_pallas(out_dtype, factor_dtype, vals_bf16):
    table, cols, vals, _, _ = _chunk(seed=3)
    ja, jb = ps.gather_gram_out(_j(table), _j(cols), _j(vals, vals_bf16),
                                factor_dtype=factor_dtype,
                                out_dtype=out_dtype)
    a, b = cs.gather_gram_out(
        _table(table, factor_dtype), _t(cols),
        _t(vals, torch.bfloat16 if vals_bf16 else None),
        out_dtype=getattr(torch, out_dtype))
    assert a.dtype == getattr(torch, out_dtype) and b.dtype == torch.float32
    ja = np.asarray(ja, np.float32)
    af = a.float().numpy()
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
    if out_dtype == "float32":
        np.testing.assert_allclose(af, ja, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(af - ja) <= _bf16_ulp(np.maximum(
            np.abs(af), np.abs(ja))))


# ---------------------------------------------------------------- K3 --
def _systems(seed=4, a_bf16=False):
    table, cols, vals, nnz, x0 = _chunk(seed=seed)
    g = np.where((cols < N)[:, :, None], table[cols], 0.0)
    a = np.einsum("rpf,rpg->rfg", g, g).astype(np.float32)
    b = np.einsum("rp,rpf->rf", vals, g).astype(np.float32)
    diag = (nnz * LAM + (nnz == 0)).astype(np.float32)
    # a zero system with diag 0: p.Ap == 0 from the start, x stays x0
    a[5], b[5], diag[5] = 0.0, 1.0, 0.0
    if a_bf16:
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a, diag, b, x0


@pytest.mark.parametrize("a_bf16", [False, True])
def test_solve_cg_reg_matches_pallas(a_bf16):
    a, diag, b, x0 = _systems(a_bf16=a_bf16)
    ja = _j(a, a_bf16)
    jx = ps.solve_cg_pallas(ja, _j(b), _j(x0), diag=_j(diag))
    x = cs.solve_cg_reg(_t(a, torch.bfloat16 if a_bf16 else None),
                        _t(diag), _t(b), _t(x0))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-3)
    np.testing.assert_array_equal(x.numpy()[5], x0[5])


def test_solve_cg_reg_converges_to_exact_solve():
    a, diag, b, x0 = _systems(seed=5)
    x = cs.solve_cg_reg(_t(a), _t(diag), _t(b), _t(x0), cg_iters=40,
                        cg_tol=1e-12)
    for i in range(R):
        if i == 5:
            continue
        ref = np.linalg.solve(a[i].astype(np.float64) + diag[i] * np.eye(F),
                              b[i].astype(np.float64))
        np.testing.assert_allclose(x.numpy()[i], ref, atol=2e-3)


def test_solve_cg_reg_matches_xla_cg_semantics():
    """K3 is the JAX package's plain CG (ops/solve.solve_cg) on A + diag I,
    the iterate for iterate semantics of the reference cg.cu."""
    from cumf_als_tpu.ops.solve import solve_cg
    a, diag, b, x0 = _systems(seed=6)
    areg = a + diag[:, None, None] * np.eye(F, dtype=np.float32)
    jx = solve_cg(_j(areg), _j(b), _j(x0), cg_iters=6, cg_tol=1e-4)
    x = cs.solve_cg_reg(_t(a), _t(diag), _t(b), _t(x0))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=2e-3,
                               atol=2e-3)


# ------------------------------------------------------------ wrappers --
def test_plain_route_counts_no_launch():
    cs.reset_launch_counts()
    table, cols, vals, nnz, x0 = _chunk()
    cs.gather_gram_cg(*map(_t, (table, cols, vals, nnz, x0)), LAM)
    a, b = cs.gather_gram_out(_t(table), _t(cols), _t(vals))
    cs.solve_cg_reg(a, _t(nnz).float(), b, _t(x0))
    assert all(cs.LAUNCHES[k] == 0 for k in (
        "gather_gram_cg", "gather_gram_out", "solve_cg_reg"))
    assert sum(cs.LAUNCHES.values()) == 0


def test_wrappers_refuse_other_devices():
    meta = torch.empty((R, P), dtype=torch.int32, device="meta")
    table, cols, vals, nnz, x0 = _chunk()
    with pytest.raises(ValueError):
        cs.gather_gram_cg(_t(table), meta, _t(vals), _t(nnz), _t(x0), LAM)
    with pytest.raises(ValueError):
        cs.gather_gram_out(_t(table).to("meta"), meta, _t(vals).to("meta"))
