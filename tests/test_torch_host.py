"""Host layer of the port against the JAX package: synthetic data,
initial factors and the update / panel plans are bit-identical for the
same seed and CSR, and the strategy choice is the same.

The JAX package builds plans through its native dataplane when that
library is built; the port copies its numpy fallback, so the plan tests
compare against the fallback (native.available patched to False).
test_native_plans_match_fallback then records where the native
dataplane agrees with that fallback."""

import dataclasses

import numpy as np
import pytest

import cumf_als_tpu.native as jnative
import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.data import synthetic as jsyn
from cumf_als_tpu.models.als import ALS as JALS
from cumf_als_tpu.ops import tiling as jtiling
from cumf_als_tpu.utils.io import transpose_csr as j_transpose

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data import synthetic as syn
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.als import ALS, do_als
from cumf_als_tpu_torch.ops import tiling
from cumf_als_tpu_torch.ops.tiling import PanelPlan
from cumf_als_tpu_torch.utils.io import CSRMatrix, transpose_csr


@pytest.fixture()
def numpy_dataplane(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)


def _port_csr(c) -> CSRMatrix:
    return CSRMatrix(indptr=c.indptr, indices=c.indices, data=c.data,
                     num_rows=c.num_rows, num_cols=c.num_cols)


def _assert_same_arrays(a, b):
    for name in ("indptr", "indices", "data", "row", "col"):
        if hasattr(a, name):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert (a.num_rows, a.num_cols) == (b.num_rows, b.num_cols)


@pytest.mark.parametrize("kw", [
    dict(m=60, n=45, nnz=1400, nnz_test=200, rank=4, noise=0.05, seed=3),
    dict(m=300, n=220, nnz=12000, nnz_test=1500, rank=6, noise=0.1, seed=7,
         skew=(0.5, 0.35), rating_range=(0.5, 5.0)),
])
def test_synthetic_ratings_bit_identical(numpy_dataplane, kw):
    jtr, jte = jsyn.synthetic_ratings(**kw)
    tr, te = syn.synthetic_ratings(**kw)
    _assert_same_arrays(jtr, tr)
    _assert_same_arrays(jte, te)


def test_workload_tables_equal():
    assert sorted(syn.WORKLOAD_SHAPES) == sorted(jsyn.WORKLOAD_SHAPES)
    for name, shape in jsyn.WORKLOAD_SHAPES.items():
        assert syn.WORKLOAD_SHAPES[name] == shape, name


@pytest.mark.parametrize("name", sorted(jsyn.WORKLOAD_SHAPES))
def test_workload_ratings_bit_identical(numpy_dataplane, name):
    """Every workload at a scale of ~30k requested ratings (far under the
    2^26 where the JAX package may switch to its native generator)."""
    shape = jsyn.WORKLOAD_SHAPES[name]
    scale = 3e4 / shape["nnz"]
    assert (shape["nnz"] + shape["nnz_test"]) * scale < 2 ** 26
    jtr, jte = jsyn.workload_ratings(name, scale=scale, seed=2)
    tr, te = syn.workload_ratings(name, scale=scale, seed=2)
    assert tr.nnz > 0 and te.nnz > 0
    _assert_same_arrays(jtr, tr)
    _assert_same_arrays(jte, te)


def test_init_factors_bit_identical():
    for a, b in zip(jsyn.init_factors(40, 30, 100, seed=5, init_scale=0.3),
                    init_factors(40, 30, 100, seed=5, init_scale=0.3)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _same_chunks(jchunks, chunks, fields):
    assert len(jchunks) == len(chunks)
    for jc, c in zip(jchunks, chunks):
        for name in fields:
            x, y = getattr(jc, name), getattr(c, name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            else:
                assert x == y, name


@pytest.mark.parametrize("kw", [
    dict(chunk_nnz=256), dict(chunk_nnz=1 << 12, octave_points=8),
    dict(chunk_nnz=512, chunk_rows=16, min_width=16, octave_points=16)])
def test_update_plan_bit_identical(numpy_dataplane, medium_problem, kw):
    train, _ = medium_problem
    for jcsr in (train, j_transpose(train)):
        jp = jtiling.build_update_plan(jcsr, **kw)
        p = tiling.build_update_plan(_port_csr(jcsr), **kw)
        assert (jp.num_rows, jp.num_cols, jp.true_nnz, jp.padded_nnz) == \
            (p.num_rows, p.num_cols, p.true_nnz, p.padded_nnz)
        _same_chunks(jp.chunks, p.chunks,
                     ("width", "rows", "nnz", "cols", "vals"))


@pytest.mark.parametrize("kw", [
    dict(panel_size=64, chunk_nnz=1 << 11, chunk_rows=128),
    dict(panel_size=48, chunk_nnz=512, split_width=16, octave_points=8),
    dict(panel_size=32, split_width=0),
    dict(panel_size=48, chunk_nnz=512, min_bucket_rows=16),
    dict(panel_size=64, chunk_nnz=1 << 11, chunk_rows=128,
         min_bucket_rows=4)])
def test_panel_plan_bit_identical(numpy_dataplane, medium_problem, kw):
    train, _ = medium_problem
    for jcsr in (train, j_transpose(train)):
        jp = jtiling.build_panel_plan(jcsr, **kw)
        p = tiling.build_panel_plan(_port_csr(jcsr), **kw)
        assert (jp.num_rows, jp.num_cols, jp.panel_size, jp.n_panels,
                jp.true_nnz, jp.padded_nnz) == \
            (p.num_rows, p.num_cols, p.panel_size, p.n_panels, p.true_nnz,
             p.padded_nnz)
        np.testing.assert_array_equal(jp.row_nnz, p.row_nnz)
        _same_chunks(jp.chunks, p.chunks,
                     ("panel", "width", "rows", "nnz", "cols", "vals"))


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("kw", [
    dict(panel_size=64, batch_rows=64, chunk_nnz=512),
    dict(panel_size=48, batch_rows=100, chunk_nnz=1 << 11, chunk_rows=32,
         split_width=16, octave_points=8),
    dict(panel_size=32, batch_rows=37, min_bucket_rows=4)])
def test_batched_panel_plan_bit_identical(medium_problem, monkeypatch, kw,
                                          native):
    """The batched-panel plan, array for array the JAX package's, with its
    numpy fallback and (where built) its native dataplane."""
    if not native:
        monkeypatch.setattr(jnative, "available", lambda: False)
    elif not jnative.available():
        pytest.skip("the JAX package's native dataplane is not built")
    train, _ = medium_problem
    for jcsr in (train, j_transpose(train)):
        jp = jtiling.build_batched_panel_plan(jcsr, **kw)
        p = tiling.build_batched_panel_plan(_port_csr(jcsr), **kw)
        assert (jp.num_rows, jp.num_cols, jp.panel_size, jp.batch_rows,
                jp.true_nnz, jp.padded_nnz, len(jp.batches)) == \
            (p.num_rows, p.num_cols, p.panel_size, p.batch_rows,
             p.true_nnz, p.padded_nnz, len(p.batches))
        assert any(b.global_ids[-1] < jcsr.num_rows for b in p.batches)
        for jb, b in zip(jp.batches, p.batches):
            for name in ("global_ids", "row_nnz"):
                x, y = getattr(jb, name), getattr(b, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            assert (jb.plan.num_rows, jb.plan.n_panels, jb.plan.padded_nnz) \
                == (b.plan.num_rows, b.plan.n_panels, b.plan.padded_nnz)
            _same_chunks(jb.plan.chunks, b.plan.chunks,
                         ("panel", "width", "rows", "nnz", "cols", "vals"))


def test_native_plans_match_fallback(medium_problem, monkeypatch):
    """Where the JAX package's native dataplane is built, its plans equal
    its numpy fallback's, so the port's plans equal both."""
    if not jnative.available():
        pytest.skip("the JAX package's native dataplane is not built")
    train, _ = medium_problem
    kw = dict(panel_size=48, chunk_nnz=512, split_width=16)
    native_u = jtiling.build_update_plan(train, chunk_nnz=256)
    native_p = jtiling.build_panel_plan(train, **kw)
    monkeypatch.setattr(jnative, "available", lambda: False)
    _same_chunks(native_u.chunks,
                 jtiling.build_update_plan(train, chunk_nnz=256).chunks,
                 ("width", "rows", "nnz", "cols", "vals"))
    _same_chunks(native_p.chunks, jtiling.build_panel_plan(train, **kw).chunks,
                 ("panel", "width", "rows", "nnz", "cols", "vals"))


def test_width_grid_and_row_rounding_match():
    for mw, ml, op in [(8, 3000, 4), (8, 230000, 8), (16, 999, 16),
                       (8, 7, 8)]:
        assert jtiling.make_width_grid(mw, ml, octave_points=op) == \
            tiling.make_width_grid(mw, ml, octave_points=op)
    for r in range(1, 3000, 37):
        assert jtiling._round_rows(r, 2048) == tiling._round_rows(r, 2048)
    for w in (8, 40, 1000, 70000):
        assert jtiling._rows_per_chunk(w, 1 << 22, 1 << 14) == \
            tiling._rows_per_chunk(w, 1 << 22, 1 << 14)


@pytest.fixture()
def jax_fused_available(monkeypatch):
    """The JAX package's strategy choice asks whether its fused kernel
    compiles; on a TPU it does, and the port's kernels always exist."""
    monkeypatch.setattr(ps, "fused_available", lambda: True)


def _strategies(csr_j, fields):
    jal = JALS.__new__(JALS)
    jal.cfg = JConfig(**fields)
    al = ALS.__new__(ALS)
    al.cfg = ALSConfig(**fields)
    return jal._phase_strategy(csr_j), al._phase_strategy(_port_csr(csr_j))


# (config fields, expected strategy) on the medium problem (300 x 220)
STRATEGY_CASES = [
    (dict(), "direct"),
    (dict(panel_size=64), "panel"),
    (dict(panel_size=64, use_panels="never"), "direct"),
    (dict(panel_size=64, panel_budget_bytes=1 << 20), "batched_panel"),
    (dict(panel_size=64, panel_budget_bytes=1 << 20, backend="pallas"),
     "direct"),
    (dict(panel_size=64, panel_budget_bytes=1 << 20, backend="pallas",
          gather_part_bytes=64 * 128 * 4, split_min_table_bytes=0),
     "split"),
    (dict(split_gather="force", gather_part_bytes=64 * 128 * 4), "split"),
    (dict(split_gather="off", panel_size=64, panel_budget_bytes=1 << 20,
          backend="pallas", solver="cholesky"), "batched_panel"),
    (dict(panel_size=64, panel_budget_bytes=1 << 20, backend="pallas",
          solver="cholesky"), "batched_panel"),
    (dict(panel_size=64, panel_budget_bytes=1 << 20, backend="pallas",
          solver="lu", gram_dtype="bf16"), "batched_panel"),
    (dict(panel_size=64, panel_budget_bytes=1 << 20, solver="lu",
          gram_dtype="bf16", batch_rows=32), "batched_panel"),
]


@pytest.mark.parametrize("fields,want", STRATEGY_CASES)
def test_phase_strategy_matches(jax_fused_available, medium_problem, fields,
                                want):
    train, _ = medium_problem
    base = dict(m=train.num_rows, n=train.num_cols, f=100)
    got_j, got = _strategies(train, dict(base, **fields))
    assert got_j == got == want


def test_split_strategy_builds_its_plan(medium_problem):
    """The split strategy builds its plan for both phases."""
    train, test = medium_problem
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=16,
                    panel_size=64, panel_budget_bytes=1 << 20)
    split = ALS(cfg.replace(backend="pallas",
                            gather_part_bytes=64 * 128 * 4,
                            split_min_table_bytes=0), _port_csr(train),
                None, None, device="cpu")
    assert isinstance(split.plan_x[0], tiling.SplitPlan)
    assert isinstance(split.plan_theta[0], tiling.SplitPlan)


PLAN_OF = {"direct": tiling.UpdatePlan, "panel": PanelPlan,
           "split": tiling.SplitPlan,
           "batched_panel": tiling.BatchedPanelPlan}


@pytest.mark.parametrize("fields,want", STRATEGY_CASES)
def test_phase_plan_follows_strategy(medium_problem, fields, want):
    """Every strategy builds its plan: the X phase's plan is the class of
    the strategy chosen for it, on the CPU."""
    train, _ = medium_problem
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=16, **fields)
    al = ALS(cfg, _port_csr(train), None, None, device="cpu")
    assert type(al.plan_x[0]) is PLAN_OF[want]


def test_panel_route_matches_direct(medium_problem):
    """Same math, other blocking: the panel route (with subrows cut at
    split_width, so one chunk scatter-adds into the same row several
    times) reproduces the direct route."""
    train, test = medium_problem
    train = _port_csr(train)
    base = dict(m=train.num_rows, n=train.num_cols, f=16, lam=0.05,
                iters=3, verbose=False, debug_timing=False,
                chunk_nnz=1 << 11, chunk_rows=128, solver="cg",
                backend="pallas")
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    direct = do_als(train, None, test, th0, x0,
                    ALSConfig(use_panels="never", **base), device="cpu")
    model = ALS(ALSConfig(panel_size=64, split_width=8, **base), train,
                None, test, device="cpu")
    assert isinstance(model.plan_x[0], PanelPlan)
    rows = np.concatenate([c.rows for c in model.plan_x[0].chunks])
    assert len(np.unique(rows)) < len(rows)   # repeated ids in a phase
    res = model.run(x0, th0)
    for a, b in zip(direct.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-3)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=2e-3)
    np.testing.assert_allclose(res.x, direct.x, rtol=2e-2, atol=2e-2)


def test_deep_panel_bf16_accumulators_promote_to_f32(numpy_dataplane):
    """Past BF16_ACCUM_MAX_DEPTH partial adds per accumulator row the
    Gram accumulators are f32 (as in the JAX package), and the run stays
    finite."""
    import torch
    jtr, jte = jsyn.synthetic_ratings(m=24, n=2400, nnz=12000,
                                      nnz_test=800, rank=4, noise=0.1,
                                      seed=11)
    train = _port_csr(jtr)
    fields = dict(m=train.num_rows, n=train.num_cols, f=16, lam=0.05,
                  iters=3, solver="cg", gram_dtype="bf16", panel_size=64,
                  split_width=64, verbose=False, backend="pallas")
    model = ALS(ALSConfig(**fields), train, None, None, device="cpu")
    slots = sum(c.rows.shape[0] for c in model.plan_x[1])
    assert model._accum_dtype(slots, train.num_rows) == torch.float32
    jal = JALS(JConfig(**fields), jtr, None, None)
    assert jal._accum_dtype(slots, train.num_rows).dtype.name == "float32"
    x0, th0 = init_factors(fields["m"], fields["n"], 16, seed=1)
    res = model.run(x0, th0)
    assert np.isfinite([h.train_rmse for h in res.history]).all()


def test_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(JConfig)}
    pf = {f.name: f.default for f in dataclasses.fields(ALSConfig)}
    assert jf == pf
    cfg = ALSConfig(m=3, n=4, f=100)
    assert cfg.f_pad == JConfig(m=3, n=4, f=100).f_pad == 128
    assert cfg.split_part_rows() == JConfig(m=3, n=4, f=100).split_part_rows()


def test_transpose_matches(numpy_dataplane, small_problem):
    train, _ = small_problem
    _assert_same_arrays(j_transpose(train), transpose_csr(_port_csr(train)))
