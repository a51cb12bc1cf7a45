"""K6, the augmented-lane fused kernel, at f = 256 lanes (factor widths
128 < F < 256 with aug_gram="force"), on the CPU:

  - `gather_gram_cg(aug=True)` at f = 256 (the plain version the CPU
    takes) against the JAX package's `gather_gram_cg(aug=True)` with its
    Pallas kernel `_kernel_aug` in interpret mode, on the same numpy
    inputs: an empty row and P = 40, not a multiple of the 64-slot tile;
  - the plain cut route of K6 at f = 256 on the card (`row_cut_plain`
    with aug: pass 1's records hold A', pass 2 unpacks b and r2 from
    their sum) against the uncut plain version;
  - a small `ALS` at F = 136 (f_pad 256) with aug_gram="force" against
    the JAX `ALS`, and the gate that sends the fused routes to K6.

Tolerances: against the JAX kernel x 1e-5 and se 1e-4 relative (both
run CG-6 in f32 on the same A, b and r2; only the order of the f32 sums
differs); the cut against the uncut plain version x 1e-4 and se 1e-4
relative (se = r2 - 2 x.b + x^T A x cancels terms a hundred times its
size here, and the cut sums r2 in the corner of A' span by span); the
ALS trajectories as tests/test_torch_als_aug.py (1e-3 a step in f32).
Lane 255 of x is exactly 0 everywhere."""

import numpy as np
import pytest
import torch

import cumf_als_tpu.ops.pallas_solve as ps
import jax.experimental.pallas as pl
import jax.numpy as jnp

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.ops import cuda_solve as cs
from cumf_als_tpu_torch.ops.tiling import PanelPlan, UpdatePlan

from test_torch_als import (FIELDS, TOLS, _runs,  # noqa: F401
                            interpret_pallas, problem)

LAM = 0.05


@pytest.fixture()
def interp(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)


def aug_chunk(r=8, p=40, f_true=200, n=50, seed=0):
    """A chunk over a 256-lane table of true width f_true (lanes above
    zero, lane 255 free for the values), rows of 0 to P ratings (row 3
    empty), pad slots at each row's tail naming the zero row n, one value
    (3.3) not exact in bf16, and a warm start zero above f_true."""
    rng = np.random.RandomState(seed)
    table = np.zeros((n + 1, 256), np.float32)
    table[:n, :f_true] = rng.standard_normal((n, f_true)) * 0.3
    nnz = rng.randint(1, p + 1, (r,)).astype(np.int32)
    nnz[3] = 0
    nnz[0] = p
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = np.round(rng.uniform(1, 5, (r, p)) * 2) / 2
    vals[0, 0] = 3.3
    vals = (vals * mask).astype(np.float32)
    x0 = np.zeros((r, 256), np.float32)
    x0[:, :f_true] = rng.standard_normal((r, f_true)) * 0.1
    x0[3] = 0.0
    return table, cols, vals, nnz, x0


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


@pytest.mark.parametrize("factor_dtype", ["f32", "bf16"])
def test_k6_at_256_matches_pallas(interp, factor_dtype):
    table, cols, vals, nnz, x0 = aug_chunk()
    t_dtype = torch.bfloat16 if factor_dtype == "bf16" else torch.float32
    x, se = cs.gather_gram_cg(_t(table, t_dtype), _t(cols), _t(vals),
                              _t(nnz), _t(x0), LAM, aug=True)
    jx, jse = ps.gather_gram_cg(jnp.asarray(table), jnp.asarray(cols),
                                jnp.asarray(vals), jnp.asarray(nnz),
                                jnp.asarray(x0), LAM,
                                factor_dtype=factor_dtype, aug=True)
    jx, jse = np.asarray(jx), np.asarray(jse)
    np.testing.assert_allclose(x.numpy(), jx, atol=1e-5, rtol=0)
    np.testing.assert_allclose(se.numpy(), jse, rtol=1e-4, atol=1e-5)
    assert bool((x[:, 255] == 0).all())
    assert bool((x[3] == 0).all()) and float(se[3, 0]) == 0.0
    # the split kernel on the same chunk: the aug layout changes only the
    # order of the f32 sums
    sx, sse = cs.gather_gram_cg_plain(
        _t(table, t_dtype), _t(cols),
        _t(vals, t_dtype).float(), _t(nnz), _t(x0), LAM)
    np.testing.assert_allclose(x.numpy(), sx.numpy(), atol=1e-5, rtol=0)
    assert sum(cs.LAUNCHES.values()) == 0


@pytest.mark.parametrize("spans,span_len", [(1, 64), (2, 32), (3, 16)])
@pytest.mark.parametrize("t_dtype", [torch.float32, torch.bfloat16])
def test_k6_cut_route_matches_the_uncut_plain_version(spans, span_len,
                                                      t_dtype):
    """K6's route on the card at f = 256 in plain torch: each span's A'
    (the values in lane 255, rounded to the table's dtype), summed in
    span order, b and r2 unpacked from the sum, then the solve; against
    `gather_gram_cg_aug_plain` on the whole row."""
    table, cols, vals, nnz, x0 = aug_chunk(seed=4)
    args = (_t(table, t_dtype), _t(cols), _t(vals), _t(nnz), _t(x0))
    x, se = cs.row_cut_plain(*args, LAM, 256, spans, span_len, aug=True)
    ux, use = cs.gather_gram_cg_aug_plain(*args, LAM)
    torch.testing.assert_close(x, ux, atol=1e-4, rtol=0)
    torch.testing.assert_close(se, use, rtol=1e-4, atol=1e-5)
    assert bool((x[:, 255] == 0).all()) and bool((x[3] == 0).all())
    # each span's record: A' of its slots, value lane and corner included
    a, _, _ = cs.span_gram_plain(*args[:4], 0, span_len, 256, aug=True)
    k = min(span_len, cols.shape[1])
    g = cs.augment_g(args[0][args[1][:, :k].long()],
                     args[2][:, :k]).float()
    live = (torch.arange(k)[None, :] < args[3][:, None]).float()
    g = g * live[:, :, None]
    torch.testing.assert_close(a, torch.einsum("rpf,rpg->rfg", g, g),
                               rtol=1e-6, atol=1e-6)


def test_aug_passes_take_256_lanes_only():
    table, cols, vals, nnz, _ = aug_chunk()
    with pytest.raises(ValueError, match="256 with aug"):
        cs.span_grams(_t(table), _t(cols), _t(vals), _t(nnz), 224, 1, 64,
                      aug=True)


def test_the_gate_sends_f_200_force_to_k6():
    """aug_enabled at F = 200 with "force" (lane 255 free); K7 wins with
    wide_kernel="on" (the route's choice, models/als.py); off at F = 256
    (no free lane) and with "auto"."""
    base = dict(m=10, n=10, backend="pallas", solver="cg")
    on = ALSConfig(f=200, aug_gram="force", **base)
    assert on.f_pad == 256 and cs.aug_enabled(on)
    assert not cs.wide_enabled(on)
    wide = ALSConfig(f=200, aug_gram="force", wide_kernel="on", **base)
    assert cs.wide_enabled(wide)        # the route takes K7, not K6
    assert not cs.aug_enabled(ALSConfig(f=256, aug_gram="force", **base))
    assert not cs.aug_enabled(ALSConfig(f=200, aug_gram="auto", **base))


def test_wide_on_takes_k7_not_k6(problem, monkeypatch):
    """With wide_kernel="on" the fused routes take K7 even where the aug
    gate holds (models/als.py): no chunk reaches K6 at 256."""
    _, al, x0, th0 = _runs(problem, "f32", aug_gram="force", f=136,
                           wide_kernel="on", iters=1)
    assert cs.aug_enabled(al.cfg) and cs.wide_enabled(al.cfg)
    seen = {"aug": 0, "wide": 0}
    aug_plain, wide_plain = (cs.gather_gram_cg_aug_plain,
                             cs.gather_gram_cg_wide_plain)

    def count(key, fn):
        def wrapped(*a, **k):
            seen[key] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(cs, "gather_gram_cg_aug_plain",
                        count("aug", aug_plain))
    monkeypatch.setattr(cs, "gather_gram_cg_wide_plain",
                        count("wide", wide_plain))
    al.run(x0, th0)
    assert seen["aug"] == 0 and seen["wide"] == len(al.plan_theta[1])


def test_forced_aug_at_f_136_matches_jax(problem, interpret_pallas,
                                         monkeypatch):
    """ALS at F = 136 (f_pad 256), f32, aug_gram="force": theta on the
    direct route through K6 at f = 256 (its plain version here), X on
    the panel route through K5a and K5b at 256; against the JAX ALS,
    whose direct route runs `_kernel_aug` at 256 lanes."""
    jal, al, x0, th0 = _runs(problem, "f32", aug_gram="force", f=136)
    assert al.cfg.f_pad == 256 and cs.aug_enabled(al.cfg)
    assert isinstance(al.plan_theta[0], UpdatePlan)
    assert isinstance(al.plan_x[0], PanelPlan) and al._use_panel_aug()
    seen = []
    plain = cs.gather_gram_cg_aug_plain
    monkeypatch.setattr(cs, "gather_gram_cg_aug_plain",
                        lambda *a, **k: seen.append(a[0].shape[1]) or
                        plain(*a, **k))
    hist = al.run(x0, th0).history
    assert seen and set(seen) == {256}
    assert len(seen) == FIELDS["iters"] * len(al.plan_theta[1])
    want = jal.run(x0, th0).history
    tol_tr, tol_te = TOLS["f32"]
    assert len(hist) == len(want) == FIELDS["iters"]
    for got, ref in zip(hist, want):
        assert got.train_rmse == pytest.approx(ref.train_rmse, abs=tol_tr)
        assert got.test_rmse == pytest.approx(ref.test_rmse, abs=tol_te)
