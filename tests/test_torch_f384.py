"""Factor widths F > 256 (f_pad = 128 T, T >= 3) against the JAX package:

  - the plain K1 and K6 at f = 384 and 512 (`gather_gram_cg_plain` and
    `gather_gram_cg_aug_plain`, what the card's two passes ``tile_gram``
    then ``global_cg`` are held to) against the JAX `gather_gram_cg`
    (aug=True for K6) with its Pallas kernel in interpret mode: x within
    1e-5, se within 1e-4 relative, lanes >= F of x exactly 0;
  - the plain tiled Gram (`tile_gram_plain`, K2 and K5a at f >= 384)
    against `gather_gram_out` and `gather_gram_aug_out`: b and an f32 A
    within rtol 1e-5 (atol 1e-6), a bf16 A within one bf16 ulp more;
  - the plain global CG in the modes of K3, K4 and K5b
    (`global_cg_plain`) against `solve_cg_pallas` (diag / None / aug):
    x within 1e-5;
  - `_check_f` and the widths it takes;
  - `ALS` at F = 300 against the JAX `ALS` on every strategy that width
    reaches (direct, panel, split, batched panel, aug "force"), RMSE
    within the tolerances of tests/test_torch_als.py (`TOLS`); one
    `OutOfCoreALS` at F = 300 against the in-core run; the carry-over of
    interop.py at F = 300.

Every chunk holds a row that fills P, an empty row, and P = 40 (not a
whole number of 64-slot tiles). On the card tests/test_torch_cuda.py and
chip_smoke.py (phase 14) hold the kernels to these plain versions."""

import dataclasses

import numpy as np
import pytest
import torch

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.als import ALS as JALS
from cumf_als_tpu.ops.tiling import BatchedPanelPlan as JBatchedPanelPlan

from cumf_als_tpu_torch import interop
from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.als import ALS
from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
from cumf_als_tpu_torch.ops import cuda_solve as cs
from cumf_als_tpu_torch.ops.tiling import (BatchedPanelPlan, PanelPlan,
                                           SplitPlan, UpdatePlan)

from test_torch_als import (DTYPES, FIELDS, TOLS, _runs,  # noqa: F401
                            interpret_pallas, problem)
from test_torch_split import probes_true  # noqa: F401

R, P, N = 4, 40, 50
LAM = 0.5
# the true factor width at each f: lanes >= F of the table and x0 are 0
TRUE_F = {384: 300, 512: 428}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _chunk(f, table_dtype, seed=0):
    """A zero-extended table (N + 1, f) with lanes >= TRUE_F[f] zero, and
    a chunk of R rows of P slots: row 0 fills P, row 2 is empty, pad
    slots name row N at each row's tail; values and a warm start with
    the table's zero lanes; numpy from a seed."""
    rng = np.random.RandomState(seed)
    fl = TRUE_F[f]
    table = np.zeros((N + 1, f), np.float32)
    table[:N, :fl] = rng.standard_normal((N, fl)) * 0.3
    nnz = np.array([P, 17, 0, 29], np.int32)
    mask = np.arange(P)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, N, (R, P)), N).astype(np.int32)
    vals = (rng.uniform(1, 5, (R, P)) * mask).astype(np.float32)
    x0 = np.zeros((R, f), np.float32)
    x0[:, :fl] = rng.standard_normal((R, fl)) * 0.1
    t = _t(table)
    if table_dtype == "bf16":
        t = t.to(torch.bfloat16)
    return table, t, cols, vals, nnz, x0


@pytest.mark.parametrize("f", [384, 512])
@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("aug", [False, True])
def test_two_pass_k1_k6_match_jax(interpret_pallas, f, table_dtype, aug):
    table_np, table, cols, vals, nnz, x0 = _chunk(f, table_dtype, seed=f)
    jx, jse = ps.gather_gram_cg(table_np, cols, vals, nnz, x0, LAM,
                                factor_dtype=table_dtype, aug=aug)
    args = (table, _t(cols), _t(vals), _t(nnz), _t(x0), LAM)
    x, se = cs.gather_gram_cg(*args, aug=aug)
    assert x.shape == (R, f) and se.shape == (R, 1)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), rtol=1e-4,
                               atol=1e-6)
    assert torch.all(x[:, TRUE_F[f]:] == 0) and torch.all(x[2] == 0)
    # the CPU route is the plain version, no launch counted
    plain = cs.gather_gram_cg_aug_plain if aug else cs.gather_gram_cg_plain
    px, pse = plain(*args)
    assert torch.equal(x, px) and torch.equal(se, pse)


@pytest.mark.parametrize("f", [384, 512])
@pytest.mark.parametrize("table_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("aug", [False, True])
def test_tiled_gram_matches_jax(interpret_pallas, f, table_dtype, out_dtype,
                                aug):
    table_np, table, cols, vals, _, _ = _chunk(f, table_dtype, seed=f + 1)
    out = getattr(torch, out_dtype)
    a, b, r2 = cs.tile_gram_plain(table, _t(cols), _t(vals), None, out,
                                  aug=aug)
    jkw = dict(factor_dtype=table_dtype, out_dtype=out_dtype)
    if aug:
        want = np.asarray(ps.gather_gram_aug_out(table_np, cols, vals,
                                                 **jkw), np.float32)
        assert b is None and r2 is None
    else:
        ja, jb = ps.gather_gram_out(table_np, cols, vals, **jkw)
        want = np.asarray(ja, np.float32)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r2.numpy(), (vals * vals).sum(1),
                                   rtol=1e-5)
    assert a.shape == (R, f, f) and a.dtype == out
    got = a.float().numpy()
    lim = 1e-5 * np.abs(want) + 1e-6
    if out == torch.bfloat16:   # both round an f32 sum to nearest
        big = np.maximum(np.abs(got), np.abs(want))
        lim = lim + np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= lim)
    assert torch.all(a[2] == 0)
    # nnz stops each row: the live slots alone give the same Gram
    nnz = _t(np.array([P, P, 0, P], np.int32))
    a2, _, _ = cs.tile_gram_plain(table, _t(cols), _t(vals), nnz, out,
                                  aug=aug)
    assert torch.equal(a2, a)


def _systems(f, seed, a_dtype):
    """R regularized systems at f lanes (A = M M^T of a narrow M, so the
    CG has work to do), a diagonal, b and a warm start with lane f - 1
    zero (the aug contract); A exact in `a_dtype`."""
    rng = np.random.RandomState(seed)
    m = rng.standard_normal((R, f, 40)).astype(np.float32) * (2 / np.sqrt(f))
    a = _t(np.einsum("rik,rjk->rij", m, m))
    if a_dtype == "bf16":
        a = a.to(torch.bfloat16)
    diag = rng.uniform(0.5, 2.0, R).astype(np.float32)
    b = rng.standard_normal((R, f)).astype(np.float32)
    x0 = (rng.standard_normal((R, f)) * 0.1).astype(np.float32)
    x0[:, f - 1] = 0.0
    return a, diag, b, x0


@pytest.mark.parametrize("kind", ["reg", "plain", "aug"])
@pytest.mark.parametrize("a_dtype", ["f32", "bf16"])
def test_global_cg_modes_match_jax(interpret_pallas, kind, a_dtype):
    f = 384
    a, diag, b, x0 = _systems(f, 3, a_dtype)
    if kind == "plain":   # K4 takes systems already regularized
        a = (a.float() + _t(diag)[:, None, None] * torch.eye(f)).to(a.dtype)
    ja = a.float().numpy()
    if a_dtype == "bf16":
        import jax.numpy as jnp
        ja = jnp.asarray(ja).astype(jnp.bfloat16)
    kw = dict(cg_iters=6, cg_tol=1e-4)
    if kind == "reg":
        x = cs.global_cg_plain(a, _t(x0), diag=_t(diag), b=_t(b), **kw)
        want = ps.solve_cg_pallas(ja, b, x0, diag=diag, **kw)
        via = cs.solve_cg_reg(a, _t(diag), _t(b), _t(x0), **kw)
    elif kind == "plain":
        x = cs.global_cg_plain(a, _t(x0), b=_t(b), **kw)
        want = ps.solve_cg_pallas(ja, b, x0, **kw)
        via = cs.solve_cg(a, _t(b), _t(x0), **kw)
    else:
        x = cs.global_cg_plain(a, _t(x0), diag=_t(diag), aug=True, **kw)
        want = ps.solve_cg_pallas(ja, None, x0, diag=diag, aug=True, **kw)
        via = cs.solve_cg_aug(a, _t(diag), _t(x0), **kw)
        assert torch.all(x[:, f - 1] == 0)
    assert x.shape == (R, f)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert torch.equal(x, via)


@pytest.mark.parametrize("f", [384, 512, 640, 1024])
def test_check_f_takes_multiples_of_128_from_384(f):
    for name in ("gather_gram_cg", "gather_gram_out", "solve_cg_reg",
                 "tile_gram", "global_cg"):
        cs._check_f(name, f)
    assert cs.tiled(f) and cs.gram_body(
        torch.zeros((2, f), dtype=torch.bfloat16)) == "wgmma"
    assert cs.gram_body(torch.zeros((2, f))) == "fma"


@pytest.mark.parametrize("f", [320, 272, 300, 448])
def test_check_f_refuses_other_widths_above_256(f):
    with pytest.raises(ValueError, match="multiple of 128 from 384"):
        cs._check_f("gather_gram_cg", f)
    assert not cs.tiled(f)
    # the bulk body of K3-K5b takes no width above 256: its grid raises
    with pytest.raises(ValueError, match="global_cg"):
        cs._check_bulk_f("solve_cg_reg", 384)


def test_tiled_batches_keep_the_scratch_under_its_budget(monkeypatch):
    """K1's two passes at f = 384 take 3,631 rows a batch: the widest
    direct theta chunk of the Netflix plan (16,384 rows) takes five; a
    batch holds one row at least."""
    rows = cs.tiled_batch_rows(384)
    assert rows == 3631
    assert rows * (384 * 384 + 385) * 4 <= cs.TILED_SCRATCH_BYTES
    assert (rows + 1) * (384 * 384 + 385) * 4 > cs.TILED_SCRATCH_BYTES
    assert -(-16384 // rows) == 5
    monkeypatch.setattr(cs, "TILED_SCRATCH_BYTES", 1)
    assert cs.tiled_batch_rows(512) == 1


def test_wrappers_refuse_spans_at_384():
    """`spans=` cuts K1 and K6 at f = 128 and 256 only; at f >= 384 it
    cuts K2 and K5a on ``tile_gram``'s cluster body alone (a bf16 table
    at f = 384 or 512, P a multiple of 64 spans), not on a float32 table
    nor on the one-block-a-tile body of f >= 640."""
    table, cols = torch.zeros((9, 384)), torch.zeros((2, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match="spans"):
        cs.gather_gram_cg(table, cols, torch.zeros((2, 64)),
                          torch.zeros(2, dtype=torch.int32),
                          torch.zeros((2, 384)), 0.1, spans=2)
    for f in (384, 512):
        bf16 = torch.zeros((9, f), dtype=torch.bfloat16)
        assert cs._gram_spans_of("gather_gram_out", bf16, 2, 256, 4) == 4
        for bad in (torch.zeros((9, f)), bf16):
            p = 256 if bad.dtype == torch.float32 else 192
            with pytest.raises(ValueError, match="spans"):
                cs._gram_spans_of("gather_gram_out", bad, 2, p, 4)
    with pytest.raises(ValueError, match="spans"):
        cs._gram_spans_of("gather_gram_aug_out",
                          torch.zeros((9, 640), dtype=torch.bfloat16), 2,
                          256, 2)


@pytest.mark.parametrize("t", range(3, 9))
def test_cluster_plan_owns_each_tile_once(t):
    """``tile_gram``'s cluster plan at t slabs: every tile of the upper
    triangle owned by one block; each block reads two slabs (a != b) and
    owns one tile or two (with the diagonal); each slab gathered by one
    block, its diagonal block, and read by as many other blocks as every
    other slab; t (t - 1) / 2 blocks, t of them with two tiles."""
    plan = cs.cluster_plan(t)
    tiles = []
    for a, b, diag in plan:
        assert a != b and 0 <= a < t and 0 <= b < t
        tiles.append((min(a, b), max(a, b)))
        if diag:
            tiles.append((a, a))
    assert sorted(tiles) == [(i, j) for i in range(t) for j in range(i, t)]
    assert sorted(a for a, _, diag in plan if diag) == list(range(t))
    readers = [sum(1 for a, b, diag in plan
                   if b == c or (a == c and not diag)) for c in range(t)]
    assert len(set(readers)) == 1 and readers[0] >= 1
    assert len(plan) == t * (t - 1) // 2
    assert sum(diag for *_, diag in plan) == t
    # the cluster body's reach: a portable cluster of at most 8 blocks
    body = cs.tile_gram_body(torch.zeros((2, 128 * t), dtype=torch.bfloat16))
    assert body == ("cluster" if t <= 4 else "tile")
    assert (len(plan) <= cs.CLUSTER_MAX_BLOCKS) == (t <= 4)
    assert cs.tile_gram_body(torch.zeros((2, 128 * t))) == "fma"


@pytest.mark.parametrize("r, p, f, dtype, want", [
    (16, 16384, 384, torch.bfloat16, 2),    # 44 clusters of 3 on 132 SMs
    (8, 8192, 384, torch.bfloat16, 4),
    (2304, 576, 384, torch.bfloat16, 1),    # more rows than clusters
    (44, 576, 384, torch.bfloat16, 1),
    (16, 16384, 512, torch.bfloat16, 1),    # 22 clusters of 6: 2 spans pass
    (3, 16384, 512, torch.bfloat16, 4),
    (16, 16384, 640, torch.bfloat16, 1),    # the one-block-a-tile body
    (16, 16384, 384, torch.float32, 1),     # the FMA body
    (16, 16010, 384, torch.bfloat16, 1),    # P not whole tiles
])
def test_gram_spans_at_384(r, p, f, dtype, want):
    """`gram_spans` at f >= 384: the cut of the cluster body on a chunk
    of fewer rows than the clusters a 132-SM card holds (one block an
    SM), R S within them, no span under 4 tiles."""
    assert cs.gram_spans(r, p, f, 132, dtype) == want


def test_gram_cut_plain_at_384():
    """The plain cut (K2, and K5a with aug) at f = 384 in 2 spans against
    the uncut plain Gram: A and b within rtol 1e-5."""
    _, table, cols, vals, _, _ = _chunk(384, "f32", seed=5)
    for aug in (False, True):
        a, b = cs.gram_cut_plain(table, _t(cols), _t(vals), 2, aug=aug)
        pa, pb, _ = cs.tile_gram_plain(table, _t(cols), _t(vals), aug=aug)
        torch.testing.assert_close(a, pa, rtol=1e-5, atol=1e-6)
        if not aug:
            torch.testing.assert_close(b, pb, rtol=1e-5, atol=1e-6)


def _assert_close(res, ref, dtype):
    tol_tr, tol_te = TOLS[dtype]
    assert len(res.history) == len(ref.history) == 2
    for got, want in zip(res.history, ref.history):
        assert got.train_rmse == pytest.approx(want.train_rmse, abs=tol_tr)
        assert got.test_rmse == pytest.approx(want.test_rmse, abs=tol_te)


STRATEGIES = {
    "direct": ("bf16", dict(use_panels="never"), UpdatePlan),
    "panel": ("bf16", {}, PanelPlan),
    "split": ("f32", dict(split_gather="force",
                          gather_part_bytes=16 * 384 * 4), SplitPlan),
    "batched panel": ("f32", dict(solver="cholesky", lam=0.05,
                                  panel_budget_bytes=1 << 20,
                                  batch_rows=16), BatchedPanelPlan),
    "aug force": ("f32", dict(aug_gram="force"), PanelPlan),
}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_als_at_f_300_matches_jax(problem, interpret_pallas, probes_true,
                                  strategy):
    """ALS at F = 300 (f_pad 384): the X phase on each strategy that
    width reaches, theta direct, 2 iterations, against the JAX ALS."""
    dtype, extra, plan = STRATEGIES[strategy]
    jal, al, x0, th0 = _runs(problem, dtype, f=300, iters=2, **extra)
    assert al.cfg.f_pad == jal.cfg.f_pad == 384
    assert isinstance(al.plan_x[0], plan)
    assert type(jal.plan_x[0]).__name__ == plan.__name__
    if strategy == "batched panel":
        assert isinstance(jal.plan_x[0], JBatchedPanelPlan)
    if strategy == "aug force":
        assert cs.aug_enabled(al.cfg) and al._use_panel_aug()
    _assert_close(al.run(x0, th0), jal.run(x0, th0), dtype)


def test_out_of_core_at_f_300_matches_in_core(problem):
    """OutOfCoreALS at F = 300 (X on the host, theta through K2 and K3 at
    f = 384 on the plain versions) against the in-core ALS, f32."""
    _, _, train, test = problem
    kw = dict(FIELDS, m=train.num_rows, n=train.num_cols, f=300, iters=2,
              panel_size=16, **DTYPES["f32"])
    x0, th0 = init_factors(train.num_rows, train.num_cols, 300, seed=3)
    ooc = OutOfCoreALS(ALSConfig(**kw), train, None, test, device="cpu")
    assert ooc.cfg.f_pad == 384 and ooc.plan_theta.n_panels > 1
    res = ooc.run(x0, th0)
    ref = ALS(ALSConfig(**kw), train, None, test, device="cpu").run(x0, th0)
    for got, want in zip(res.history, ref.history):
        assert got.train_rmse == pytest.approx(want.train_rmse, abs=2e-3)
        assert got.test_rmse == pytest.approx(want.test_rmse, abs=2e-3)
    np.testing.assert_allclose(res.x, ref.x, rtol=2e-2, atol=2e-2)


def test_resume_from_a_jax_run_at_f_300(problem, interpret_pallas):
    """A JAX run at F = 300 stopped after iteration 1 is carried across
    with interop.from_reference (factors padded to 384 lanes); the port's
    next iteration is JAX's iteration 2, and to_reference gives the JAX
    state back."""
    jtrain, jtest, train, test = problem
    kw = dict(FIELDS, m=train.num_rows, n=train.num_cols, f=300,
              **DTYPES["f32"])
    x0, th0 = init_factors(kw["m"], kw["n"], 300, seed=1)
    full = JALS(JConfig(**dict(kw, iters=2)), jtrain, None,
                jtest).run(x0, th0)
    jcfg = JConfig(**dict(kw, iters=1))
    first = JALS(jcfg, jtrain, None, jtest).run(x0, th0)
    cfg, x1, th1 = interop.from_reference(
        dataclasses.asdict(jcfg.replace(iters=2)), first.x, first.theta,
        device="cpu")
    assert x1.shape == (kw["m"], 384) and torch.all(x1[:, 300:] == 0)
    fields, xb, thb = interop.to_reference(cfg, x1, th1)
    np.testing.assert_array_equal(xb, np.asarray(first.x))
    np.testing.assert_array_equal(thb, np.asarray(first.theta))
    rest = ALS(cfg, train, None, test, device="cpu").run(x1, th1,
                                                          start_iter=1)
    assert [h.iteration for h in rest.history] == [1]
    assert rest.history[0].train_rmse == pytest.approx(
        full.history[1].train_rmse, abs=1e-3)
    assert rest.history[0].test_rmse == pytest.approx(
        full.history[1].test_rmse, abs=1e-3)
