"""The augmented-lane kernels of the port, the already-regularized CG
solve and the gates that choose them, against the JAX package's Pallas
kernels (interpret mode) on the same numpy inputs:

  K4  solve_cg                 <-> pallas_solve.solve_cg_pallas(a, b, x0)
                                                       (B4, _cg_solve_kernel)
  K5a gather_gram_aug_out      <-> pallas_solve.gather_gram_aug_out
                                                       (B5a, _gram_kernel_aug)
  K5b solve_cg_aug             <-> pallas_solve.solve_cg_pallas(aug=True)
                                                   (B5b, _cg_solve_aug_kernel)
  K6  gather_gram_cg(aug=True) <-> pallas_solve.gather_gram_cg(aug=True)
                                                            (B6, _kernel_aug)

On the CPU each wrapper takes its plain version, and that is what these
tests reach through the wrappers; the CUDA kernels run only on a card
(tests/test_torch_cuda.py).

The chunk has true factor width 100 in f = 128 lanes (lane f-1 free),
one empty row, and one rating value (3.3) that bf16 does not hold
exactly, so a version that rounds the value at another place than
`augment_g` fails the bf16-table cases.

Tolerances: A' rtol 1e-5 in f32 (the same sums in another order), one
bf16 ulp for a bf16 A' (both round one f32 sum); x and se 2e-3 absolute
at the default cg_iters=6 (tests/test_pallas.py); aug against split on
f32 inputs rtol/atol 1e-5 for x and 1e-4 for se
(tests/test_pallas.py, TestAugmentedGram)."""

import itertools

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.ops.solve import solve as j_solve
from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.ops import cuda_solve as cs
from cumf_als_tpu_torch.ops.solve import solve

R, P, F, F_TRUE, N, LAM = 16, 48, 128, 100, 50, 0.05
STATUS_FLAGS = ("_STATUS", "_AUG_STATUS", "_CG_STATUS", "_PANEL_AUG_STATUS",
                "_WIDE_STATUS")


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    """Every pallas_call in interpret mode, and the probe caches reset so
    the JAX dispatcher `ops.solve.solve` re-probes under the interpreter
    (on the CPU it would otherwise take its XLA route)."""
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    for flag in STATUS_FLAGS:
        monkeypatch.setattr(ps, flag, None)
    yield
    for flag in STATUS_FLAGS:
        setattr(ps, flag, None)


def _chunk(seed=0, zero_rows=(3,), exact_vals=False):
    """A plan-shaped chunk with a free lane: table lanes >= F_TRUE are
    zero, pad slots at each row's tail name the zero row N and carry
    value 0, x0 is zero in the padded lanes."""
    rng = np.random.RandomState(seed)
    table = np.zeros((N + 1, F), np.float32)
    table[:N, :F_TRUE] = rng.standard_normal((N, F_TRUE)) * 0.3
    nnz = rng.randint(1, P + 1, (R,)).astype(np.int32)
    for z in zero_rows:
        nnz[z] = 0
    mask = np.arange(P)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, N, (R, P)), N).astype(np.int32)
    vals = np.round(rng.uniform(1, 5, (R, P)) * 2) / 2
    if not exact_vals:
        vals[0, 0] = 3.3      # nnz[0] >= 1: a live slot bf16 cannot hold
    vals = (vals * mask).astype(np.float32)
    x0 = np.zeros((R, F), np.float32)
    x0[:, :F_TRUE] = rng.standard_normal((R, F_TRUE)) * 0.1
    return table, cols, vals, nnz, x0


def _t(a, bf16=False):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


def _j(a, bf16=False):
    return jnp.asarray(a, jnp.bfloat16 if bf16 else None)


def _bf16_ulp(a):
    a = np.abs(a).astype(np.float32)
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _np(x):
    return np.asarray(x, np.float32)


DTYPE_GRID = list(itertools.product(["f32", "bf16"], [False, True]))


# --------------------------------------------------------------- K5a --
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor_dtype,vals_bf16", DTYPE_GRID)
def test_gather_gram_aug_out_matches_pallas(out_dtype, factor_dtype,
                                            vals_bf16):
    table, cols, vals, _, _ = _chunk(seed=3)
    ja = ps.gather_gram_aug_out(_j(table), _j(cols), _j(vals, vals_bf16),
                                factor_dtype=factor_dtype,
                                out_dtype=out_dtype)
    a = cs.gather_gram_aug_out(_t(table, factor_dtype == "bf16"), _t(cols),
                               _t(vals, vals_bf16),
                               out_dtype=getattr(torch, out_dtype))
    assert a.dtype == getattr(torch, out_dtype)
    ja, af = _np(ja), a.float().numpy()
    if out_dtype == "float32":
        np.testing.assert_allclose(af, ja, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(af - ja) <= _bf16_ulp(np.maximum(
            np.abs(af), np.abs(ja))))


@pytest.mark.parametrize("factor_dtype,vals_bf16", DTYPE_GRID)
def test_gather_gram_aug_out_blocks_are_a_b_r2(factor_dtype, vals_bf16):
    """A' = [[A, b], [b^T, sum v^2]]: its blocks equal K2's (A, b) and
    sum v^2 once the values are rounded where augment_g rounds them (to
    the table's dtype); with the unrounded 3.3 and a bf16 table, b
    differs beyond the tolerance."""
    table, cols, vals, _, _ = _chunk(seed=4)
    tt = _t(table, factor_dtype == "bf16")
    tv = _t(vals, vals_bf16)
    a_aug = cs.gather_gram_aug_out(tt, _t(cols), tv)
    stored = tv.to(tt.dtype).float()
    a, b = cs.gather_gram_out(tt, _t(cols), stored)
    f = F - 1
    torch.testing.assert_close(a_aug[:, :f, :f], a[:, :f, :f], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(a_aug[:, f, :f], b[:, :f], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(a_aug[:, :f, f], b[:, :f], rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(a_aug[:, f, f], (stored * stored).sum(-1),
                               rtol=1e-5, atol=1e-5)
    assert torch.all(b[:, f] == 0)          # the free lane
    if factor_dtype == "bf16" and not vals_bf16:
        _, b_raw = cs.gather_gram_out(tt, _t(cols), tv)
        assert (a_aug[0, f, :f] - b_raw[0, :f]).abs().max() > 1e-4


def test_augment_g_matches_jax():
    rng = np.random.RandomState(0)
    g = rng.standard_normal((4, 6, 16)).astype(np.float32)
    v = rng.uniform(1, 5, (4, 6)).astype(np.float32)
    for bf16 in (False, True):
        want = _np(ps.augment_g(_j(g, bf16), _j(v)))
        got = cs.augment_g(_t(g, bf16), _t(v)).float().numpy()
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- K5b and K4 --
def _aug_systems(seed=5, a_bf16=False):
    """Augmented accumulators as the panel route builds them, with the
    Tikhonov diagonal; system 5 is all zeros with diag 0."""
    table, cols, vals, nnz, x0 = _chunk(seed=seed, exact_vals=True)
    a = cs.gather_gram_aug_out(_t(table), _t(cols), _t(vals)).numpy()
    diag = (nnz * LAM + (nnz == 0)).astype(np.float32)
    a[5], diag[5] = 0.0, 0.0
    if a_bf16:
        a = _np(jnp.asarray(a, jnp.bfloat16))
    return a, diag, x0


@pytest.mark.parametrize("a_bf16", [False, True])
def test_solve_cg_aug_matches_pallas(a_bf16):
    a, diag, x0 = _aug_systems(a_bf16=a_bf16)
    jx = ps.solve_cg_pallas(_j(a, a_bf16), None, _j(x0), diag=_j(diag),
                            aug=True)
    x = cs.solve_cg_aug(_t(a, a_bf16), _t(diag), _t(x0))
    np.testing.assert_allclose(x.numpy(), _np(jx), atol=2e-3)
    np.testing.assert_array_equal(x.numpy()[:, F - 1], 0.0)
    np.testing.assert_array_equal(_np(jx)[:, F - 1], 0.0)
    np.testing.assert_array_equal(x.numpy()[5], x0[5])


def test_solve_cg_aug_converges_to_exact_solve():
    a, diag, x0 = _aug_systems(seed=6)
    x = cs.solve_cg_aug(_t(a), _t(diag), _t(x0), cg_iters=40, cg_tol=1e-12)
    f = F - 1
    for i in range(R):
        if i == 5:
            continue
        ref = np.linalg.solve(a[i, :f, :f].astype(np.float64) +
                              diag[i] * np.eye(f), a[i, f, :f])
        np.testing.assert_allclose(x.numpy()[i, :f], ref, atol=2e-3)


def test_solve_cg_aug_equals_solve_cg_reg_on_the_unpacked_system():
    a, diag, x0 = _aug_systems(seed=7)
    ua, ub, _ = cs.unpack_aug(_t(a))
    x = cs.solve_cg_aug(_t(a), _t(diag), _t(x0))
    want = cs.solve_cg_reg(ua, _t(diag), ub, _t(x0))
    torch.testing.assert_close(x, want, rtol=0, atol=0)


def _reg_systems(seed=8, a_bf16=False):
    """Already regularized split systems; system 5 is all zeros."""
    a, diag, x0 = _aug_systems(seed=seed)
    ua, ub, _ = cs.unpack_aug(_t(a))
    areg = (ua + _t(diag)[:, None, None] * torch.eye(F)).numpy()
    b = ub.numpy().copy()
    b[5] = 1.0                      # a zero A with a non-zero b: p.Ap == 0
    if a_bf16:
        areg = _np(jnp.asarray(areg, jnp.bfloat16))
    return areg, b, x0


@pytest.mark.parametrize("a_bf16", [False, True])
def test_solve_cg_matches_pallas(a_bf16):
    a, b, x0 = _reg_systems(a_bf16=a_bf16)
    jx = ps.solve_cg_pallas(_j(a, a_bf16), _j(b), _j(x0))
    x = cs.solve_cg(_t(a, a_bf16), _t(b), _t(x0))
    np.testing.assert_allclose(x.numpy(), _np(jx), atol=2e-3)
    np.testing.assert_array_equal(x.numpy()[5], x0[5])   # the alpha guard


def test_solve_cg_converges_to_exact_solve():
    a, b, x0 = _reg_systems(seed=9)
    x = cs.solve_cg(_t(a), _t(b), _t(x0), cg_iters=40, cg_tol=1e-12)
    for i in range(R):
        if i == 5:
            continue
        ref = np.linalg.solve(a[i].astype(np.float64), b[i])
        np.testing.assert_allclose(x.numpy()[i], ref, atol=2e-3)


# ------------------------------------------------------ the dispatcher --
def test_solve_dispatch_aug_backends_agree_and_match_jax():
    a, diag, x0 = _aug_systems(seed=10)
    kw = dict(solver="cg", diag=_t(diag), aug=True)
    x_kernel = solve(_t(a), None, _t(x0), backend="pallas", **kw)
    x_twin = solve(_t(a), None, _t(x0), backend="xla", **kw)
    np.testing.assert_allclose(x_twin.numpy(), x_kernel.numpy(), atol=2e-3)
    jkw = dict(solver="cg", diag=_j(diag), aug=True)
    j_twin = j_solve(_j(a), None, _j(x0), backend="xla", **jkw)
    j_kernel = j_solve(_j(a), None, _j(x0), backend="pallas", **jkw)
    np.testing.assert_allclose(x_twin.numpy(), _np(j_twin), atol=2e-3)
    np.testing.assert_allclose(x_kernel.numpy(), _np(j_kernel), atol=2e-3)
    np.testing.assert_array_equal(x_twin.numpy()[:, F - 1], 0.0)


def test_solve_dispatch_without_diag_takes_k4(monkeypatch):
    """cg + pallas + no diag is kernel K4's wrapper, never the plain torch
    CG of the "xla" backend; with a diag K3's, with aug K5b's."""
    a, b, x0 = _reg_systems(seed=11)
    taken = []
    for name in ("solve_cg", "solve_cg_reg", "solve_cg_aug"):
        monkeypatch.setattr(
            cs, name, lambda *args, _n=name, **kw: taken.append(_n))
    diag = torch.ones(R)
    solve(_t(a), _t(b), _t(x0), solver="cg", backend="pallas")
    solve(_t(a), _t(b), _t(x0), solver="cg", backend="pallas", diag=diag)
    solve(_t(a), None, _t(x0), solver="cg", backend="pallas", diag=diag,
          aug=True)
    assert taken == ["solve_cg", "solve_cg_reg", "solve_cg_aug"]
    with pytest.raises(ValueError):
        solve(_t(a), None, _t(x0), solver="cg", backend="pallas", aug=True)


def test_solve_dispatch_without_diag_matches_jax():
    a, b, x0 = _reg_systems(seed=12)
    x = solve(_t(a), _t(b), _t(x0), solver="cg", backend="pallas")
    jx = j_solve(_j(a), _j(b), _j(x0), solver="cg", backend="pallas")
    np.testing.assert_allclose(x.numpy(), _np(jx), atol=2e-3)


@pytest.mark.parametrize("solver", ["cholesky", "lu"])
def test_solve_dispatch_aug_exact_solvers_unpack(solver):
    a, diag, x0 = _aug_systems(seed=13)
    diag[5] = 1.0
    x = solve(_t(a), None, _t(x0), solver=solver, diag=_t(diag), aug=True)
    jx = j_solve(_j(a), None, _j(x0), solver=solver, diag=_j(diag),
                 aug=True)
    np.testing.assert_allclose(x.numpy(), _np(jx), atol=2e-3)


# ---------------------------------------------------------------- K6 --
@pytest.mark.parametrize("factor_dtype,vals_bf16", DTYPE_GRID)
def test_gather_gram_cg_aug_matches_pallas(factor_dtype, vals_bf16):
    table, cols, vals, nnz, x0 = _chunk()
    jx, jse = ps.gather_gram_cg(_j(table), _j(cols), _j(vals, vals_bf16),
                                _j(nnz), _j(x0), LAM,
                                factor_dtype=factor_dtype, aug=True)
    x, se = cs.gather_gram_cg(_t(table, factor_dtype == "bf16"), _t(cols),
                              _t(vals, vals_bf16), _t(nnz), _t(x0), LAM,
                              aug=True)
    np.testing.assert_allclose(x.numpy(), _np(jx), atol=2e-3)
    np.testing.assert_allclose(se.numpy(), _np(jse), atol=2e-3)
    np.testing.assert_array_equal(x.numpy()[3], 0.0)       # the empty row
    np.testing.assert_array_equal(x.numpy()[:, F - 1], 0.0)


def test_gather_gram_cg_aug_matches_split_kernel():
    table, cols, vals, nnz, _ = _chunk(seed=1)
    args = (_t(table), _t(cols), _t(vals), _t(nnz), torch.zeros(R, F), LAM)
    x, se = cs.gather_gram_cg(*args, aug=True)
    px, pse = cs.gather_gram_cg(*args)
    torch.testing.assert_close(x, px, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(se, pse, rtol=1e-4, atol=1e-4)
    jx, jse = ps.gather_gram_cg(*map(_j, (table, cols, vals, nnz)),
                                jnp.zeros((R, F)), LAM, aug=True)
    np.testing.assert_allclose(x.numpy(), _np(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(se.numpy(), _np(jse), rtol=1e-4, atol=1e-4)


def test_gather_gram_cg_aug_converges_to_exact_solve():
    table, cols, vals, nnz, _ = _chunk(seed=2)
    x, se = cs.gather_gram_cg(_t(table), _t(cols), _t(vals), _t(nnz),
                              torch.zeros(R, F), LAM, cg_iters=40,
                              cg_tol=1e-12, aug=True)
    g = table[cols].astype(np.float64)
    for i in range(R):
        a = g[i].T @ g[i] + (nnz[i] * LAM + (nnz[i] == 0)) * np.eye(F)
        ref = np.linalg.solve(a, g[i].T @ vals[i]) * (nnz[i] > 0)
        np.testing.assert_allclose(x.numpy()[i], ref, atol=2e-3)
        e = vals[i][:nnz[i]] - g[i][:nnz[i]] @ ref
        np.testing.assert_allclose(se.numpy()[i, 0], np.sum(e * e),
                                   rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------ wrappers --
def test_new_plain_routes_count_no_launch():
    cs.reset_launch_counts()
    table, cols, vals, nnz, x0 = map(_t, _chunk())
    cs.gather_gram_cg(table, cols, vals, nnz, x0, LAM, aug=True)
    a = cs.gather_gram_aug_out(table, cols, vals)
    diag = nnz.float() + 1.0
    cs.solve_cg_aug(a, diag, x0)
    cs.solve_cg(a, x0, x0)
    assert set(cs.LAUNCHES) == {
        "gather_gram_cg", "gather_gram_out", "solve_cg_reg", "solve_cg",
        "gather_gram_aug_out", "solve_cg_aug", "gather_gram_cg_aug"}
    assert sum(cs.LAUNCHES.values()) == 0


def test_new_wrappers_refuse_other_devices():
    table, cols, vals, nnz, x0 = map(_t, _chunk())
    meta = cols.to("meta")
    with pytest.raises(ValueError):
        cs.gather_gram_cg(table, meta, vals, nnz, x0, LAM, aug=True)
    with pytest.raises(ValueError):
        cs.gather_gram_aug_out(table.to("meta"), meta, vals.to("meta"))
    a = torch.zeros((R, F, F))
    with pytest.raises(ValueError):
        cs.solve_cg_aug(a.to("meta"), nnz.float().to("meta"), x0.to("meta"))
    with pytest.raises(ValueError):
        cs.solve_cg(a, x0.to("meta"), x0)


# --------------------------------------------------------------- gates --
GATE_GRID = list(itertools.product(
    ["auto", "off", "force"], ["f32", "bf16"], ["cg", "cholesky", "lu"],
    ["xla", "pallas"], [100, 128]))


@pytest.mark.parametrize("aug_gram,gram_dtype,solver,backend,f", GATE_GRID)
def test_gates_match_jax(monkeypatch, aug_gram, gram_dtype, solver, backend,
                         f):
    """The port's gates are the JAX package's with its availability
    probes answering True (the port has no probes: a kernel either builds
    or the run fails)."""
    for flag in STATUS_FLAGS:
        monkeypatch.setattr(ps, flag, True)
    kw = dict(m=10, n=10, f=f, aug_gram=aug_gram, gram_dtype=gram_dtype,
              solver=solver, backend=backend)
    jcfg, cfg = JConfig(**kw), ALSConfig(**kw)
    assert cs.aug_enabled(cfg) == ps.aug_enabled(jcfg)
    assert cs.panel_aug_enabled(cfg) == ps.panel_aug_enabled(jcfg)


def test_gates_need_a_free_lane_and_no_save_model():
    base = dict(m=10, n=10, aug_gram="force")
    assert cs.aug_enabled(ALSConfig(f=100, **base))
    assert not cs.aug_enabled(ALSConfig(f=128, **base))
    assert not cs.aug_enabled(ALSConfig(f=100, m=10, n=10))   # "auto"
    assert cs.panel_aug_enabled(ALSConfig(f=100, m=10, n=10))
    assert not cs.panel_aug_enabled(ALSConfig(f=128, **base))
    assert not cs.panel_aug_enabled(ALSConfig(f=100, save_model=True,
                                              **base))
