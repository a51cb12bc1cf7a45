"""The port's plan cache (cumf_als_tpu_torch/utils/plan_cache.py): round
trips of the single-device plan kinds, keys and fingerprints equal to
the JAX package's, entries that each package writes and the other loads
as an equal plan, the refusal of sharded entries, and ALS runs that are
the same with the cache."""

import os

import numpy as np
import pytest

from cumf_als_tpu.ops import tiling as jtiling
from cumf_als_tpu.utils import plan_cache as jpc
from cumf_als_tpu.utils.io import CSRMatrix as JCSR

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.als import ALS
from cumf_als_tpu_torch.ops import tiling
from cumf_als_tpu_torch.utils import plan_cache as pc
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix, transpose_csr

KINDS = ["update", "panel", "batched_panel", "split"]


def _port(train):
    return CSRMatrix(indptr=train.indptr, indices=train.indices,
                     data=train.data, num_rows=train.num_rows,
                     num_cols=train.num_cols)


def _build(mod, kind, csr):
    """A small plan of each kind by the builders of `mod` (the port's or
    the JAX package's tiling)."""
    if kind == "update":
        return mod.build_update_plan(csr, chunk_nnz=1 << 10)
    if kind == "panel":
        return mod.build_panel_plan(csr, panel_size=64, chunk_nnz=1 << 10)
    if kind == "batched_panel":
        return mod.build_batched_panel_plan(csr, panel_size=64,
                                            batch_rows=64,
                                            chunk_nnz=1 << 10)
    return mod.build_split_plan(csr, part_size=64, chunk_nnz=1 << 10)


def _arrays(plan):
    """Every array and count of a plan of any single-device kind, in one
    flat list (rows, nnz, cols, vals chunk by chunk)."""
    head = [plan.num_rows, plan.num_cols, plan.true_nnz, plan.padded_nnz]
    if hasattr(plan, "batches"):
        head += [plan.panel_size, plan.batch_rows, len(plan.batches)]
        return head + [a for b in plan.batches for a in
                       [b.global_ids, b.row_nnz] + _arrays(b.plan)]
    if hasattr(plan, "perm"):
        head += [plan.part_size, plan.n_parts, plan.perm]
    if hasattr(plan, "row_nnz"):
        head += [plan.panel_size, plan.n_panels, plan.row_nnz]
    out = head + [len(plan.chunks)]
    for c in plan.chunks:
        cols = list(c.cols) if isinstance(c.cols, tuple) else [c.cols]
        out += [c.width, getattr(c, "panel", -1), getattr(c, "parts", ()),
                c.rows, c.nnz, *cols, c.vals]
    return out


def _same(a, b):
    aa, bb = _arrays(a), _arrays(b)
    assert len(aa) == len(bb)
    for x, y in zip(aa, bb):
        if isinstance(x, np.ndarray):
            assert np.asarray(y).dtype == x.dtype
            np.testing.assert_array_equal(np.asarray(y), x)
        else:
            assert x == y


@pytest.mark.parametrize("kind", KINDS)
def test_round_trip(medium_problem, tmp_path, kind):
    plan = _build(tiling, kind, _port(medium_problem[0]))
    pc.save_plan(str(tmp_path), "k", plan)
    got = pc.load_plan(str(tmp_path), "k")
    assert type(got) is type(plan)
    _same(plan, got)


def test_missing_key_returns_none(tmp_path):
    assert pc.load_plan(str(tmp_path), "nope") is None


def test_fingerprint_and_keys_are_the_jax_packages(medium_problem):
    import dataclasses
    train = medium_problem[0]
    fp = pc.dataset_fingerprint(_port(train))
    assert fp == jpc.dataset_fingerprint(train)
    params = dict(panel_size=64, min_width=8, chunk_nnz=1 << 10)
    assert pc.plan_key("panel", fp, params) == \
        jpc.plan_key("panel", fp, params)
    bumped = dataclasses.replace(_port(train),
                                 data=train.data + np.float32(1.0))
    assert pc.dataset_fingerprint(bumped) != fp


@pytest.mark.parametrize("kind", KINDS)
def test_a_jax_entry_loads_in_the_port(medium_problem, tmp_path, kind):
    train = medium_problem[0]
    jpc.save_plan(str(tmp_path), "k", _build(jtiling, kind, train))
    got = pc.load_plan(str(tmp_path), "k")
    _same(_build(tiling, kind, _port(train)), got)


@pytest.mark.parametrize("kind", KINDS)
def test_a_port_entry_loads_in_jax(medium_problem, tmp_path, kind):
    train = medium_problem[0]
    pc.save_plan(str(tmp_path), "k", _build(tiling, kind, _port(train)))
    got = jpc.load_plan(str(tmp_path), "k")
    _same(_build(jtiling, kind, train), got)


def test_a_sharded_entry_raises_naming_a12(medium_problem, tmp_path):
    """Once refused naming A12: an eager sharded entry of the JAX package
    loads (ShardedALS's kinds; tests/test_torch_sharded.py holds them
    array for array), and so does a lazy one, of sharded out-of-core
    training, re-bound to the caller's CSR: its chunks materialize the
    JAX chunks' arrays. Without the CSR it loads as no entry, and
    cached_build with `csr_for_lazy` takes it rather than rebuilding
    (tests/test_torch_sharded_ooc.py holds both lazy kinds both ways)."""
    from cumf_als_tpu.parallel.plan import build_sharded_row_plan
    train = medium_problem[0]
    csr = _port(train)
    params = dict(n_dev=2)
    key = pc.plan_key("sh_row", pc.dataset_fingerprint(csr), params)
    jpc.save_plan(str(tmp_path), key, build_sharded_row_plan(
        train, 2, chunk_nnz=1 << 10, chunk_rows=64))
    plan = pc.load_plan(str(tmp_path), key)
    assert plan.n_dev == 2 and plan.chunks[0].cols.shape[0] == 2
    jlazy = build_sharded_row_plan(train, 2, chunk_nnz=1 << 10,
                                   chunk_rows=64, lazy=True)
    jpc.save_plan(str(tmp_path), "lazy", jlazy)
    assert pc.load_plan(str(tmp_path), "lazy") is None
    got = pc.load_plan(str(tmp_path), "lazy", csr=csr)
    assert len(got.chunks) == len(jlazy.chunks)
    for a, b in zip(jlazy.chunks, got.chunks):
        for x, y in zip(a.materialize(), b.materialize()):
            np.testing.assert_array_equal(y, x)
    lazy_key = pc.plan_key("sh_row_lazy", pc.dataset_fingerprint(csr),
                           params)
    os.rename(tmp_path / "lazy", tmp_path / lazy_key)

    def rebuild():
        raise AssertionError("the lazy entry was rebuilt")

    plan = pc.cached_build(str(tmp_path), "sh_row_lazy", csr, params,
                           rebuild, csr_for_lazy=csr)
    assert plan.chunks[0]._csr is csr


def test_a_corrupt_entry_is_rebuilt(medium_problem, tmp_path):
    csr = _port(medium_problem[0])
    key = pc.plan_key("update", pc.dataset_fingerprint(csr), {})
    os.makedirs(tmp_path / key)
    (tmp_path / key / "meta.json").write_text("{not json")
    plan = pc.cached_build(str(tmp_path), "update", csr, {},
                           lambda: _build(tiling, "update", csr))
    _same(_build(tiling, "update", csr), plan)


def test_cached_transpose(medium_problem, tmp_path):
    csr = _port(medium_problem[0])
    want = transpose_csr(csr)
    for _ in range(2):   # built and stored, then loaded
        got = pc.cached_transpose(str(tmp_path), csr)
        for a, b in ((got.indptr, want.indptr), (got.indices, want.indices),
                     (got.data, want.data)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert not got.indices.flags.writeable   # memory-mapped from the cache
    jgot = jpc.cached_transpose(str(tmp_path), JCSR(
        csr.indptr, csr.indices, csr.data, csr.num_rows, csr.num_cols))
    np.testing.assert_array_equal(jgot.indices, want.indices)


def _base(train, tmp_path):
    return dict(m=train.num_rows, n=train.num_cols, f=16, lam=0.05,
                iters=3, verbose=False, debug_timing=False,
                chunk_nnz=1 << 12, panel_size=64,
                plan_cache_dir=str(tmp_path))


def test_als_results_identical_with_cache(medium_problem, tmp_path):
    train, test = medium_problem
    csr = _port(train)
    te = COOMatrix(row=test.row, col=test.col, data=test.data,
                   num_rows=test.num_rows, num_cols=test.num_cols)
    cfg = ALSConfig(**_base(train, tmp_path))
    x0, th0 = init_factors(cfg.m, cfg.n, 16, seed=1)
    r0 = ALS(cfg.replace(plan_cache_dir=None), csr, None, te,
             device="cpu").run(x0, th0)
    r1 = ALS(cfg, csr, None, te, device="cpu").run(x0, th0)
    entries = sorted(os.listdir(tmp_path))
    assert {e.split("-")[0] for e in entries} == {"csc", "panel"}
    r2 = ALS(cfg, csr, None, te, device="cpu").run(x0, th0)   # loads
    assert sorted(os.listdir(tmp_path)) == entries
    for a, b, c in zip(r0.history, r1.history, r2.history):
        assert a.train_rmse == b.train_rmse == c.train_rmse
        assert a.test_rmse == b.test_rmse == c.test_rmse
    np.testing.assert_array_equal(r0.x, r2.x)


def test_als_writes_the_jax_packages_keys(medium_problem, tmp_path):
    """The port's ALS stores each phase's plan under the key the JAX
    ALS uses for it, on the direct and panel routes and on the
    batched-panel route (whose JAX key names its ragged-tail rule)."""
    from cumf_als_tpu.config import ALSConfig as JConfig
    from cumf_als_tpu.models.als import ALS as JALS
    train = medium_problem[0]
    for extra in ({}, dict(panel_budget_bytes=1 << 16, solver="cholesky",
                           chunk_rows=128)):
        pdir = tmp_path / f"port{len(extra)}"
        jdir = tmp_path / f"jax{len(extra)}"
        ALS(ALSConfig(**dict(_base(train, pdir), **extra)), _port(train),
            device="cpu")
        JALS(JConfig(**dict(_base(train, jdir), **extra)), train)
        assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
    assert any(e.startswith("batched_panel-") for e in os.listdir(pdir))
