"""The split-table route of the port against the JAX package: the numpy
`build_split_plan` array for array, what the device holds of a split
chunk (one id space over the permuted table, each row compacted so that
live slots come first), and `ALS.run` trajectories on the split route
against the JAX `ALS` (its Pallas kernels in interpret mode, its compile
probes patched to True as on a TPU), on the problem and with the helpers
of tests/test_torch_als.py.

Tolerances per iteration (train, test): 1e-3 for f32 and 5e-3 / 1e-2
with bf16 factors, as tests/test_als_e2e.py."""

import numpy as np
import pytest
import torch

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.als import ALS as JALS
from cumf_als_tpu.ops import tiling as jtiling
from cumf_als_tpu.ops.tiling import SplitPlan as JSplitPlan
from cumf_als_tpu.utils.io import transpose_csr as j_transpose

from cumf_als_tpu_torch.config import NETFLIX, ALSConfig
from cumf_als_tpu_torch.models.als import ALS, DeviceChunk
from cumf_als_tpu_torch.ops import cuda_solve, tiling
from cumf_als_tpu_torch.ops.tiling import SplitPlan, UpdatePlan
from cumf_als_tpu_torch.utils.io import CSRMatrix

from test_torch_als import (TOLS, _runs, interpret_pallas,  # noqa: F401
                            problem)


def _port_csr(c) -> CSRMatrix:
    return CSRMatrix(indptr=c.indptr, indices=c.indices, data=c.data,
                     num_rows=c.num_rows, num_cols=c.num_cols)


# the second set leaves more raw width-tuple groups than max_groups, so
# _merge_tuple_groups has to merge; the third keeps the table's order
PLAN_CASES = [
    dict(part_size=40, chunk_nnz=1 << 10),
    dict(part_size=24, chunk_nnz=1 << 11, max_groups=3, octave_points=4),
    dict(part_size=64, by_popularity=False, chunk_rows=16, min_width=16),
    dict(part_size=1 << 10),
]


@pytest.mark.parametrize("which", ["small", "medium"])
@pytest.mark.parametrize("kw", PLAN_CASES)
def test_split_plan_bit_identical(small_problem, medium_problem, which, kw):
    train, _ = small_problem if which == "small" else medium_problem
    for jcsr in (train, j_transpose(train)):
        jp = jtiling.build_split_plan(jcsr, **kw)
        p = tiling.build_split_plan(_port_csr(jcsr), **kw)
        assert (jp.num_rows, jp.num_cols, jp.part_size, jp.n_parts,
                jp.true_nnz, jp.padded_nnz) == \
            (p.num_rows, p.num_cols, p.part_size, p.n_parts, p.true_nnz,
             p.padded_nnz)
        assert jp.perm.dtype == p.perm.dtype
        np.testing.assert_array_equal(jp.perm, p.perm)
        assert len(jp.chunks) == len(p.chunks) > 0
        for jc, c in zip(jp.chunks, p.chunks):
            assert jc.parts == c.parts and jc.widths == c.widths
            for name in ("rows", "nnz", "vals"):
                x, y = getattr(jc, name), getattr(c, name)
                assert x.dtype == y.dtype, name
                np.testing.assert_array_equal(x, y, err_msg=name)
            assert len(jc.cols) == len(c.cols)
            for x, y in zip(jc.cols, c.cols):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_merge_case_really_merges(medium_problem):
    """PLAN_CASES[1] bounds the groups below the raw tuple count."""
    train, _ = medium_problem
    kw = dict(PLAN_CASES[1])
    few = tiling.build_split_plan(_port_csr(train), **kw)
    kw["max_groups"] = 1 << 20
    many = tiling.build_split_plan(_port_csr(train), **kw)
    shapes = {(c.parts, c.widths) for c in few.chunks}
    assert len(shapes) < len({(c.parts, c.widths) for c in many.chunks})
    assert few.true_nnz == many.true_nnz == train.nnz


def _device_split_chunk(ch, plan, device):
    return DeviceChunk(tiling.flatten_split_chunk(ch, plan), plan.num_rows,
                       device)


def test_device_chunk_compacts_pad_slots_inside_a_row(medium_problem):
    """A SplitChunk pads each part's segment at its own tail. The plan
    carries a row whose first part is shorter than its padded width, so
    a live slot of the next part follows a pad slot; on the device the
    row is compacted (live slots first, one id space over the permuted
    table, pad id num_cols), and a kernel that stops at nnz sees every
    rating."""
    train = _port_csr(medium_problem[0])
    plan = tiling.build_split_plan(train, part_size=40, chunk_nnz=1 << 10)
    s, n = plan.part_size, plan.num_cols
    found = 0
    for ch in plan.chunks:
        dev = _device_split_chunk(ch, plan, torch.device("cpu"))
        cols, vals = dev.cols.numpy(), dev.vals.float().numpy()
        assert cols.shape == vals.shape == (ch.num_rows, ch.width)
        assert cols.dtype == np.int32 and dev.cols.is_contiguous()
        for r in range(ch.num_rows):
            k = int(ch.nnz[r])
            if len(ch.parts) > 1 and k and ch.cols[0][r, -1] == s and \
                    (ch.cols[1][r] != s).any():
                found += 1    # pad slot of part 0 before a live slot
            assert (cols[r, :k] < n).all() and (cols[r, k:] == n).all()
            assert (vals[r, k:] == 0).all()
            row = int(ch.rows[r])
            if row == plan.num_rows:
                assert k == 0
                continue
            lo, hi = train.indptr[row], train.indptr[row + 1]
            orig = plan.perm[cols[r, :k]]       # permuted id -> table row
            order = np.argsort(orig, kind="stable")
            np.testing.assert_array_equal(orig[order], train.indices[lo:hi])
            np.testing.assert_array_equal(vals[r, :k][order],
                                          train.data[lo:hi])
    assert found > 0
    # stopping at nnz loses nothing: the slots past nnz are all pad
    ch = max(plan.chunks, key=lambda c: len(c.parts))
    dev = _device_split_chunk(ch, plan, torch.device("cpu"))
    rng = np.random.default_rng(0)
    table = torch.from_numpy(
        np.concatenate([rng.standard_normal((n, 16)) * 0.3,
                        np.zeros((1, 16))]).astype(np.float32))
    x0 = torch.zeros((ch.num_rows, 16))
    x, se = cuda_solve.gather_gram_cg(table, dev.cols, dev.vals, dev.nnz, x0,
                                      0.05)
    keep = torch.arange(ch.width)[None, :] < dev.nnz[:, None]
    x2, se2 = cuda_solve.gather_gram_cg(
        table, torch.where(keep, dev.cols, n).int(), dev.vals * keep,
        dev.nnz, x0, 0.05)
    assert torch.equal(x, x2) and torch.equal(se, se2)


@pytest.fixture()
def probes_true(monkeypatch):
    """The JAX package's compile probes answer as on a TPU."""
    monkeypatch.setattr(ps, "fused_available", lambda: True)
    monkeypatch.setattr(ps, "wide_available", lambda: True)
    monkeypatch.setattr(ps, "aug_available", lambda: True)


def _split_runs(problem, dtype, f, **extra):
    """Both packages' ALS on the split route for both phases: parts of 16
    table rows, so the 60-row table has 4 parts and the 45-row one 3."""
    f_pad = 128 if f <= 128 else 256
    item = 2 if dtype == "bf16" else 4
    jal, al, x0, th0 = _runs(problem, dtype, f=f, iters=2,
                             split_gather="force",
                             gather_part_bytes=16 * f_pad * item, **extra)
    assert al.cfg.split_part_rows() == 16
    for model, cls in ((jal, JSplitPlan), (al, SplitPlan)):
        assert isinstance(model.plan_x[0], cls)
        assert isinstance(model.plan_theta[0], cls)
        assert model.plan_x[0].n_parts == 4
        assert model.plan_theta[0].n_parts == 3
    return jal, al, x0, th0


def _assert_close(al, jal, x0, th0, dtype="f32"):
    got, want = al.run(x0, th0).history, jal.run(x0, th0).history
    tol_tr, tol_te = TOLS[dtype]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.train_rmse == pytest.approx(w.train_rmse, abs=tol_tr)
        assert g.test_rmse == pytest.approx(w.test_rmse, abs=tol_te)


def _count_calls(monkeypatch, name):
    seen = []
    plain = getattr(cuda_solve, name)
    monkeypatch.setattr(cuda_solve, name,
                        lambda *a, **k: seen.append(1) or plain(*a, **k))
    return seen


@pytest.mark.parametrize("backend,dtype", [
    ("pallas", "f32"), ("pallas", "bf16"), ("xla", "f32")])
def test_split_route_f16_matches_jax(problem, interpret_pallas, probes_true,
                                     monkeypatch, backend, dtype):
    jal, al, x0, th0 = _split_runs(problem, dtype, 16, backend=backend)
    k1 = _count_calls(monkeypatch, "gather_gram_cg_plain")
    _assert_close(al, jal, x0, th0, dtype)
    # K1 (here its plain version) solves every chunk on "pallas" only
    n_chunks = len(al.plan_x[1]) + len(al.plan_theta[1])
    assert len(k1) == (2 * n_chunks if backend == "pallas" else 0)


def test_split_route_exact_solver_on_pallas_backend(problem, probes_true):
    """A non-CG solver under split_gather="force" takes the gather +
    einsum + solve branch on either backend."""
    jal, al, x0, th0 = _split_runs(problem, "f32", 16, backend="pallas",
                                   solver="cholesky", lam=0.05)
    _assert_close(al, jal, x0, th0)


@pytest.mark.parametrize("wide", ["on", "off"])
def test_split_route_f130_matches_jax(problem, interpret_pallas, probes_true,
                                      monkeypatch, wide):
    """F = 130 (f_pad 256) on the split route: K7 with wide_kernel="on",
    K1 at 256 lanes with it off."""
    jal, al, x0, th0 = _split_runs(problem, "f32", 130, wide_kernel=wide)
    assert al.cfg.f_pad == 256
    assert cuda_solve.wide_enabled(al.cfg) == (wide == "on")
    k7 = _count_calls(monkeypatch, "gather_gram_cg_wide_plain")
    k1 = _count_calls(monkeypatch, "gather_gram_cg_plain")
    _assert_close(al, jal, x0, th0)
    n_chunks = len(al.plan_x[1]) + len(al.plan_theta[1])
    assert (len(k7), len(k1)) == ((2 * n_chunks, 0) if wide == "on"
                                  else (0, 2 * n_chunks))


def test_split_route_forced_aug_matches_jax(problem, interpret_pallas,
                                            probes_true, monkeypatch):
    jal, al, x0, th0 = _split_runs(problem, "f32", 100, aug_gram="force")
    k6 = _count_calls(monkeypatch, "gather_gram_cg_aug_plain")
    _assert_close(al, jal, x0, th0)
    assert len(k6) == 2 * (len(al.plan_x[1]) + len(al.plan_theta[1]))


@pytest.mark.parametrize("wide", ["on", "off"])
def test_direct_route_f130_matches_jax(problem, interpret_pallas,
                                       probes_true, monkeypatch, wide):
    """The direct route's wide branch (wide wins over aug)."""
    jal, al, x0, th0 = _runs(problem, "f32", f=130, iters=2,
                             use_panels="never", wide_kernel=wide,
                             aug_gram="force")
    assert isinstance(al.plan_x[0], UpdatePlan)
    k7 = _count_calls(monkeypatch, "gather_gram_cg_wide_plain")
    k6 = _count_calls(monkeypatch, "gather_gram_cg_aug_plain")
    _assert_close(al, jal, x0, th0)
    n_chunks = len(al.plan_x[1]) + len(al.plan_theta[1])
    assert (len(k7), len(k6)) == ((2 * n_chunks, 0) if wide == "on"
                                  else (0, 2 * n_chunks))


@pytest.mark.parametrize("f,want_x", [(200, "split"), (130, "split"),
                                      (100, "panel")])
def test_netflix_header_strategies(probes_true, f, want_x):
    """The Netflix shape: at F > 128 the X phase's accumulators pass
    panel_budget_bytes and its bf16 gather table split_min_table_bytes,
    so it takes the split route (4 parts of 131,072 rows); theta stays
    direct. Only the header of the matrix is read."""
    fields = dict(m=NETFLIX.m, n=NETFLIX.n, f=f, backend="pallas",
                  solver="cg", factor_dtype="bf16", gram_dtype="bf16")
    empty = dict(indptr=np.zeros(1, np.int64), indices=np.zeros(0, np.int32),
                 data=np.zeros(0, np.float32))
    x_csr = CSRMatrix(num_rows=NETFLIX.m, num_cols=NETFLIX.n, **empty)
    th_csr = CSRMatrix(num_rows=NETFLIX.n, num_cols=NETFLIX.m, **empty)
    al, jal = ALS.__new__(ALS), JALS.__new__(JALS)
    al.cfg, jal.cfg = ALSConfig(**fields), JConfig(**fields)
    assert al._phase_strategy(x_csr) == jal._phase_strategy(x_csr) == want_x
    assert al._phase_strategy(th_csr) == jal._phase_strategy(th_csr) == \
        "direct"
    if f > 128:
        assert al.cfg.split_part_rows() == 131072
        assert -(-NETFLIX.n // al.cfg.split_part_rows()) == 4
