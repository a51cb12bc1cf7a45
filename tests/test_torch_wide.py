"""The wide-F tier (128 < F <= 256) of the port against the JAX package:
the plain versions of K7 (`gather_gram_cg_wide`, and the two-block body
`fused_gram_cg_wide_plain`), K8 (`fused_gram_cg_cat`) and K1 at f = 256
against the Pallas kernels in interpret mode on the same seeded numpy
inputs, and the `wide_f2` / `wide_enabled` gates.

Tolerances: x and se rtol 1e-3 / atol 1e-4 at CG-30 (the two packages
sum in other orders, and CG-30 at cg_tol 1e-10 converges both); 2e-3
absolute at CG-6 (tests/test_pallas.py); lanes >= 128 + f2 of K7's x and
empty rows exactly 0; the cat form against the monolithic form on the
same G rtol 1e-5 / atol 1e-6 (tests/test_wide_f.py)."""

import numpy as np
import pytest
import torch
import jax.experimental.pallas as pl
import jax.numpy as jnp

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu.config import ALSConfig as JConfig

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.ops import cuda_solve as cs

LAM = 0.05


@pytest.fixture()
def interp(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gathered(f2, bf16=False, seed=0, r=16, p=32):
    """G (R, P, 256) with lanes >= flive zero, one dummy row, a warm
    start that is zero on the dead lanes."""
    rng = np.random.default_rng(seed)
    flive = 128 + max(1, f2 - 7)
    g = (rng.standard_normal((r, p, 256)) * 0.4).astype(np.float32)
    g[:, :, flive:] = 0.0
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    nnz = np.full((r,), p, np.int32)
    nnz[-1] = 0      # the dummy-row contract: no slots, zero G and vals
    g[-1] = 0.0
    vals[-1] = 0.0
    x0 = (rng.standard_normal((r, 256)) * 0.1).astype(np.float32)
    x0[:, flive:] = 0.0
    if bf16:   # a G that bf16 holds exactly, so both packages see one G
        g = np.asarray(jnp.asarray(g).astype(jnp.bfloat16).astype(
            jnp.float32))
    return g, vals, nnz, x0, flive


def _jg(g, bf16):
    return jnp.asarray(g).astype(jnp.bfloat16) if bf16 else g


def _tg(g, bf16):
    t = _t(g)
    return t.to(torch.bfloat16) if bf16 else t


@pytest.mark.parametrize("f2,bf16,iters,tol", [
    (32, False, 30, 1e-10), (96, False, 30, 1e-10), (128, False, 30, 1e-10),
    (96, True, 30, 1e-10), (32, False, 6, 1e-4), (128, True, 6, 1e-4)])
def test_two_block_body_matches_pallas(interp, f2, bf16, iters, tol):
    g, vals, nnz, x0, flive = _gathered(f2, bf16, seed=f2)
    g1, g2 = g[:, :, :128], g[:, :, 128:128 + f2]
    jx1, jx2, jse = ps.fused_gram_cg_wide(
        _jg(g1, bf16), _jg(g2, bf16), vals, nnz, x0[:, :128],
        x0[:, 128:128 + f2], LAM, cg_iters=iters, cg_tol=tol)
    x1, x2, se = cs.fused_gram_cg_wide_plain(
        _tg(g1, bf16), _tg(g2, bf16), _t(vals), _t(nnz), _t(x0[:, :128]),
        _t(x0[:, 128:128 + f2]), LAM, cg_iters=iters, cg_tol=tol)
    got = torch.cat([x1, x2], dim=1).numpy()
    want = np.concatenate([np.asarray(jx1), np.asarray(jx2)], axis=1)
    if iters == 30:
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-3,
                                   atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
        np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-3,
                                   atol=2e-3)
    assert np.abs(got[:, flive:]).max() == 0.0   # dead lanes
    assert np.abs(got[-1]).max() == 0.0          # the dummy row
    assert np.abs(got[:-1, :flive]).min() > 0.0


def _table_chunk(f, seed=2, n=40, r=8, p=16):
    """A zero-extended 256-lane table of true width f and a chunk with
    ragged rows (pad id n at each row's tail) and one empty row."""
    rng = np.random.default_rng(seed)
    table = np.zeros((n + 1, 256), np.float32)
    table[:n, :f] = rng.standard_normal((n, f)) * 0.4
    nnz = rng.integers(1, p + 1, (r,)).astype(np.int32)
    nnz[0], nnz[5] = p, 0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.integers(0, n, (r, p)), n).astype(np.int32)
    vals = (rng.random((r, p)) * mask).astype(np.float32)
    x0 = np.zeros((r, 256), np.float32)
    x0[:, :f] = rng.standard_normal((r, f)) * 0.1
    return table, cols, vals, nnz, x0


@pytest.mark.parametrize("factor_dtype", ["f32", "bf16"])
def test_gather_wide_wrapper_matches_pallas(interp, factor_dtype):
    """`gather_gram_cg_wide` at F = 130 (f2 = 32) on CPU tensors (its
    plain version) against the JAX wrapper; a bf16 run casts the table
    before the gather."""
    f = 130
    f2 = cs.wide_f2(f)
    table, cols, vals, nnz, x0 = _table_chunk(f)
    jx, jse = ps.gather_gram_cg_wide(table, cols, vals, nnz, x0, LAM, f2=f2,
                                     cg_iters=30, cg_tol=1e-10,
                                     factor_dtype=factor_dtype)
    tt = _t(table)
    if factor_dtype == "bf16":
        tt = tt.to(torch.bfloat16)
    x, se = cs.gather_gram_cg_wide(tt, _t(cols), _t(vals), _t(nnz), _t(x0),
                                   LAM, f2, cg_iters=30, cg_tol=1e-10)
    assert x.shape == (8, 256) and se.shape == (8, 1)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-3,
                               atol=1e-4)
    assert np.abs(x.numpy()[:, f:]).max() == 0.0
    assert np.abs(x.numpy()[5]).max() == 0.0
    with pytest.raises(ValueError):
        cs.gather_gram_cg_wide(tt, _t(cols), _t(vals), _t(nnz), _t(x0), LAM,
                               48)


def test_cat_matches_pallas_and_monolithic(interp):
    """K8's plain version at f2 = 32 against `fused_gram_cg_cat`, and
    against the monolithic 256-lane form on the same G."""
    f2 = 32
    g, vals, nnz, x0, _ = _gathered(f2, seed=4, r=8, p=48)
    g[:, :, 128 + f2:] = 0.0
    g1, g2 = g[:, :, :128], g[:, :, 128:128 + f2]
    jx, jse = ps.fused_gram_cg_cat(g1, g2, vals, nnz, x0, LAM, cg_iters=20,
                                   cg_tol=1e-10)
    args = (_t(vals), _t(nnz), _t(x0), LAM)
    x, se = cs.fused_gram_cg_cat(_t(g1), _t(g2), *args, cg_iters=20,
                                 cg_tol=1e-10)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-3,
                               atol=1e-4)
    # the monolithic form needs a table: one row per slot
    r, p, _ = g.shape
    table = _t(np.concatenate([g.reshape(r * p, 256),
                               np.zeros((1, 256), np.float32)]))
    cols = torch.arange(r * p, dtype=torch.int32).reshape(r, p)
    mx, mse = cs.gather_gram_cg(table, cols, *args, cg_iters=20,
                                cg_tol=1e-10)
    torch.testing.assert_close(x, mx, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(se, mse, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("factor_dtype,iters,tol", [
    ("f32", 30, 1e-10), ("bf16", 6, 1e-4)])
def test_k1_at_256_lanes_matches_pallas(interp, factor_dtype, iters, tol):
    """`gather_gram_cg` on a 256-lane table (F = 200) against the JAX
    wrapper, whose kernel takes one 256-lane block."""
    table, cols, vals, nnz, x0 = _table_chunk(200, seed=5)
    jx, jse = ps.gather_gram_cg(table, cols, vals, nnz, x0, LAM,
                                cg_iters=iters, cg_tol=tol,
                                factor_dtype=factor_dtype)
    tt = _t(table)
    if factor_dtype == "bf16":
        tt = tt.to(torch.bfloat16)
    x, se = cs.gather_gram_cg(tt, _t(cols), _t(vals), _t(nnz), _t(x0), LAM,
                              cg_iters=iters, cg_tol=tol)
    kw = dict(rtol=1e-3, atol=1e-4) if iters == 30 else \
        dict(rtol=0, atol=2e-3)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **kw)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-3,
                               atol=kw["atol"])
    assert np.abs(x.numpy()[5]).max() == 0.0


def test_wide_f2_matches():
    for f in range(129, 257):
        assert cs.wide_f2(f) == ps.wide_f2(f)
        assert cs.wide_f2(f) in (32, 64, 96, 128)
        assert 128 + cs.wide_f2(f) >= f
    assert [cs.wide_f2(f) for f in (130, 160, 161, 200, 256)] == \
        [32, 32, 64, 96, 128]


BASE = dict(m=64, n=64, lam=0.05, solver="cg", backend="pallas",
            wide_kernel="on")


@pytest.mark.parametrize("fields,want", [
    (dict(f=100), False), (dict(f=128), False), (dict(f=130), True),
    (dict(f=200), True), (dict(f=256), True),
    (dict(f=130, solver="cholesky"), False),
    (dict(f=130, backend="xla"), False),
    (dict(f=130, wide_kernel="off"), False)])
def test_wide_enabled_matches(monkeypatch, fields, want):
    """The gate of K7 over the grid of tests/test_wide_f.py; the JAX
    package's compile probe has no counterpart in the port (a kernel
    builds or the run fails), so it is patched to True."""
    monkeypatch.setattr(ps, "wide_available", lambda: True)
    kw = dict(BASE, **fields)
    assert cs.wide_enabled(ALSConfig(**kw)) is want
    assert ps.wide_enabled(JConfig(**kw)) is want


def test_k2_to_k6_name_themselves_at_256_lanes():
    """The f check takes 256 for every kernel (K1-K6 all run there), and
    refuses a width off the grid with a message that names the kernel
    that refused; the checks run before any device work."""
    for name in ("gather_gram_out", "solve_cg_reg", "solve_cg",
                 "gather_gram_aug_out", "solve_cg_aug",
                 "gather_gram_cg_aug"):
        cs._check_f(name, 256)
        for bad in (136, 192):
            with pytest.raises(ValueError, match=name):
                cs._check_f(name, bad)
    cs._check_f("gather_gram_cg", 256)
    with pytest.raises(ValueError, match="or f = 256"):
        cs._check_f("gather_gram_cg", 192)
