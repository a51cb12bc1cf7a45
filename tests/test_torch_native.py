"""The port's native data plane (cumf_als_tpu_torch/native) against the
JAX package's library and against numpy and scipy, bit for bit: each
function, the native synthetic generator, and every plan kind built
with and without the library."""

import os

import numpy as np
import pytest
import scipy.sparse as sp

from cumf_als_tpu import native as jnative

from cumf_als_tpu_torch import native
from cumf_als_tpu_torch.ops import tiling
from cumf_als_tpu_torch.utils import io


@pytest.fixture(autouse=True)
def libraries():
    """Both packages' libraries, built here when missing (inside the
    test, not while the module is imported)."""
    if not native.available() or not (jnative.available() or
                                      jnative.build()):
        pytest.skip("a native library is not buildable (no g++)")


def _coo(m, n, nnz, seed=0):
    rng = np.random.RandomState(seed)
    k = rng.choice(m * n, size=nnz, replace=False)
    return (k // n).astype(np.int32), (k % n).astype(np.int32), \
        rng.uniform(1, 5, nnz).astype(np.float32)


def _equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def test_coo_to_csr():
    m, n = 43, 37
    row, col, dat = _coo(m, n, 400, seed=1)
    got = native.coo_to_csr(m, n, row, col, dat)
    _equal(got, jnative.coo_to_csr(m, n, row, col, dat))
    ref = sp.coo_matrix((dat, (row, col)), shape=(m, n)).tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(got[0], ref.indptr)
    np.testing.assert_array_equal(got[1], ref.indices)
    np.testing.assert_array_equal(got[2], ref.data)


def test_csr_transpose():
    m, n = 31, 45
    row, col, dat = _coo(m, n, 300, seed=2)
    indptr, indices, data = native.coo_to_csr(m, n, row, col, dat)
    got = native.csr_transpose(m, n, indptr, indices, data)
    _equal(got, jnative.csr_transpose(m, n, indptr, indices, data))
    ref = sp.csr_matrix((data, indices, indptr), shape=(m, n)).T.tocsr()
    ref.sort_indices()
    np.testing.assert_array_equal(got[0], ref.indptr)
    np.testing.assert_array_equal(got[1], ref.indices)
    np.testing.assert_array_equal(got[2], ref.data)


def test_materialize_chunk_and_its_overflow_rejection():
    m, n = 20, 15
    row, col, dat = _coo(m, n, 80, seed=3)
    indptr, indices, data = native.coo_to_csr(m, n, row, col, dat)
    rows = np.array([3, 7, 1, -1, -1], np.int32)   # two dummy tails
    args = (indptr, indices, data, rows)
    kw = dict(width=16, pad_col=n, pad_row=m, num_rows=m)
    got = native.materialize_chunk(*args, **kw)
    _equal(got, jnative.materialize_chunk(*args, **kw))
    # the numpy path of the port's plans
    csr = io.CSRMatrix(indptr=indptr, indices=indices, data=data,
                       num_rows=m, num_cols=n)
    want = tiling._materialize_numpy(csr, rows[:3], 16, 5)
    _equal(got, (want.rows, want.nnz, want.cols, want.vals))
    long_row = (np.array([0, 20], np.int64), np.zeros(20, np.int32),
                np.zeros(20, np.float32), np.array([0], np.int32))
    for lib in (native, jnative):
        with pytest.raises(ValueError):
            lib.materialize_chunk(*long_row, width=8, pad_col=5, pad_row=1,
                                  num_rows=1)


def test_materialize_subrows():
    m, n = 25, 40
    row, col, dat = _coo(m, n, 300, seed=4)
    indptr, indices, data = native.coo_to_csr(m, n, row, col, dat)
    # three subrows of panel 1 (columns 16..31), base 16, one dummy tail
    sub_off, sub_len, sub_rows = [], [], []
    for r in (2, 5, 11):
        seg = np.flatnonzero((indices[indptr[r]:indptr[r + 1]] >= 16) &
                             (indices[indptr[r]:indptr[r + 1]] < 32))
        sub_off.append(indptr[r] + seg[0])
        sub_len.append(seg.size)
        sub_rows.append(r)
    args = (indices, data, np.asarray(sub_off, np.int64),
            np.asarray(sub_len, np.int32), np.asarray(sub_rows, np.int32))
    kw = dict(r_pad=4, width=16, base=16, pad_col=16, pad_row=m)
    got = native.materialize_subrows(*args, **kw)
    _equal(got, jnative.materialize_subrows(*args, **kw))
    rows, nnz, cols, vals = got
    assert rows.tolist() == sub_rows + [m] and nnz[3] == 0
    for i, (o, k) in enumerate(zip(sub_off, sub_len)):
        np.testing.assert_array_equal(cols[i, :k], indices[o:o + k] - 16)
        assert np.all(cols[i, k:] == 16) and np.all(vals[i, k:] == 0)
    with pytest.raises(ValueError):
        native.materialize_subrows(*args, **dict(kw, width=1))


def test_expand_indptr_and_sum_squares():
    indptr = np.array([0, 2, 2, 5], np.int64)
    _equal([native.expand_indptr(indptr, 5)],
           [jnative.expand_indptr(indptr, 5)])
    np.testing.assert_array_equal(native.expand_indptr(indptr, 5),
                                  [0, 0, 2, 2, 2])
    x = np.random.RandomState(5).standard_normal(10_001).astype(np.float32)
    assert native.sum_squares(x) == jnative.sum_squares(x)
    assert native.sum_squares(x) == pytest.approx(
        np.sum(x.astype(np.float64) ** 2), rel=1e-12)


def _native_synth(mod, m=900, n=700, nnz=30_000, nnz_test=3_000, seed=11):
    rng = np.random.RandomState(seed)
    u = rng.standard_normal((m, 6)).astype(np.float32) / np.sqrt(6)
    v = rng.standard_normal((n, 6)).astype(np.float32)
    return mod._native_synthetic(m, n, nnz, nnz_test, u, v, 0.2, 0.5, 0.4,
                                 1.0, 5.0, seed, rng)


def test_native_synthetic_equals_jax():
    from cumf_als_tpu.data import synthetic as jsyn
    from cumf_als_tpu_torch.data import synthetic as tsyn
    (tr, te), (jtr, jte) = _native_synth(tsyn), _native_synth(jsyn)
    _equal([tr.indptr, tr.indices, tr.data, te.row, te.col, te.data],
           [jtr.indptr, jtr.indices, jtr.data, jte.row, jte.col, jte.data])
    assert _train_sorted(tr)


def _train_sorted(tr) -> bool:
    lens = np.diff(tr.indptr)
    return all(np.all(np.diff(tr.indices[tr.indptr[r]:tr.indptr[r + 1]]) > 0)
               for r in np.flatnonzero(lens > 1))


def test_the_native_generator_runs_from_2_26_ratings(monkeypatch):
    """The same switch as the JAX package's: at 2^26 ratings and above,
    when the library is built; a test stand-in for the generator proves
    which path synthetic_ratings takes."""
    from cumf_als_tpu_torch.data import synthetic as tsyn
    assert tsyn.NATIVE_MIN_RATINGS == 1 << 26
    assert tsyn.native_generator(1 << 26)
    assert not tsyn.native_generator((1 << 26) - 1)
    monkeypatch.setattr(native, "available", lambda: False)
    assert not tsyn.native_generator(1 << 27)
    monkeypatch.undo()
    taken = []
    monkeypatch.setattr(tsyn, "_native_synthetic",
                        lambda *a: taken.append(a[:4]) or "native")
    assert tsyn.synthetic_ratings(m=50, n=40, nnz=(1 << 26) - 1,
                                  nnz_test=1) == "native"
    assert taken == [(50, 40, (1 << 26) - 1, 1)]


def _plans(csr):
    return {
        "update": tiling.build_update_plan(csr, chunk_nnz=1 << 9,
                                           chunk_rows=32),
        "panel": tiling.build_panel_plan(csr, panel_size=16,
                                         chunk_nnz=1 << 9, chunk_rows=32,
                                         split_width=8),
        "batched_panel": tiling.build_batched_panel_plan(
            csr, panel_size=16, batch_rows=24, chunk_nnz=1 << 9,
            chunk_rows=32, min_bucket_rows=4),
        "split": tiling.build_split_plan(csr, part_size=16,
                                         chunk_nnz=1 << 9, chunk_rows=32),
    }


def _chunk_arrays(plan):
    if isinstance(plan, tiling.BatchedPanelPlan):
        return [a for b in plan.batches
                for a in [b.global_ids, b.row_nnz, b.plan.row_nnz] +
                _chunk_arrays(b.plan)]
    out = []
    for c in plan.chunks:
        cols = list(c.cols) if isinstance(c.cols, tuple) else [c.cols]
        out += [c.rows, c.nnz, *cols, c.vals]
    return out + ([plan.perm] if isinstance(plan, tiling.SplitPlan) else [])


@pytest.mark.parametrize("kind", ["update", "panel", "batched_panel",
                                  "split"])
def test_plans_with_and_without_the_library_are_equal(kind, monkeypatch):
    row, col, dat = _coo(70, 50, 900, seed=6)
    coo = io.COOMatrix(row=row, col=col, data=dat, num_rows=70, num_cols=50)
    with_lib = _plans(io.coo_to_csr(coo))[kind]
    monkeypatch.setattr(native, "available", lambda: False)
    csr = io.coo_to_csr(coo)
    without = _plans(csr)[kind]
    assert (with_lib.true_nnz, with_lib.padded_nnz) == \
        (without.true_nnz, without.padded_nnz)
    _equal(_chunk_arrays(with_lib), _chunk_arrays(without))
    # the CSC view too, both ways
    csc_np = io.transpose_csr(csr)
    monkeypatch.undo()
    csc = io.transpose_csr(csr)
    _equal([csc.indptr, csc.indices, csc.data],
           [csc_np.indptr, csc_np.indices, csc_np.data])


def test_a_failed_build_says_so_once(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "dataplane.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC_PATH", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "LIB_PATH",
                        str(tmp_path / "build" / "libdataplane.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    assert not native.available()
    assert not native.available()   # tried once: no second message
    err = capsys.readouterr().err
    assert err.count("[native] building") == 1 and "numpy paths" in err
    assert os.listdir(tmp_path / "build") == []   # no half-built file


def test_a_library_built_for_another_target_is_rebuilt(tmp_path,
                                                       monkeypatch):
    """The stamp beside the library names what -march=native means on
    this host; a library whose stamp names another CPU, or has none, is
    stale and is built again rather than loaded."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libdataplane.so"))
    monkeypatch.setattr(native, "_build_failed", False)
    assert native._stale()
    assert native._compile() and not native._stale()
    stamp = tmp_path / "libdataplane.so.target"
    assert stamp.read_text().strip() == native._target() is not None
    stamp.write_text("another host\n")
    assert native._stale()
    stamp.unlink()
    assert native._stale()
    assert native._compile() and not native._stale()


def test_the_library_is_built_into_the_build_directory():
    assert native.LIB_PATH.startswith(native.BUILD_DIR)
    assert os.path.basename(native.BUILD_DIR) == "_build"
    assert os.path.exists(native.LIB_PATH) and not native._stale()
    with open(native.SRC_PATH, "rb") as fh, \
            open(os.path.join(os.path.dirname(jnative.__file__),
                              "dataplane.cpp"), "rb") as jfh:
        assert fh.read() == jfh.read()   # the JAX package's source
