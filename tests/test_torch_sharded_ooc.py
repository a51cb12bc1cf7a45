"""The port's sharded out-of-core training
(cumf_als_tpu_torch/parallel/sharded_ooc.py) against the JAX package's
parallel/sharded_ooc.py: ShardedOutOfCoreALS at one rank in this process
and at two ranks on gloo through the spawn helper (whose ranks import no
JAX), X on the host and on the device, the direct theta route with hot
columns, the cold start, keep_sharded, fetch_x and the two resumes, the
accumulator dtype and its depth guard, lazy plans against eager ones,
the lazy plan-cache kinds and the stream cache carried across the two
packages, and LazyPanelChunk with and without the native data plane.

The JAX reference runs on its "xla" backend (on the conftest's 8-device
CPU mesh); the port runs "xla" and "pallas", whose wrappers take the
kernels' plain versions for CPU tensors. Unless a test says otherwise,
RMSE is held within 2e-3 and the factors within rtol/atol 2e-2. The
same model on the card is held to its CPU run in
tests/test_torch_cuda.py."""

import os

import ml_dtypes
import numpy as np
import pytest
import torch

from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.ops import tiling as jtiling
from cumf_als_tpu.parallel import sharded_ooc as jso
from cumf_als_tpu.utils import stream_cache as jsc

from cumf_als_tpu_torch import native
from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models import als
from cumf_als_tpu_torch.ops import tiling
from cumf_als_tpu_torch.parallel import sharded_ooc as so
from cumf_als_tpu_torch.parallel.mesh import spawn
from cumf_als_tpu_torch.utils import stream_cache as sc
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for the port's runs: these problems are too
    small to gain from more, and in a suite run beside other workers the
    threads' waits cost many times the work."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(train, test):
    return (CSRMatrix(indptr=train.indptr, indices=train.indices,
                      data=train.data, num_rows=train.num_rows,
                      num_cols=train.num_cols),
            COOMatrix(row=test.row, col=test.col, data=test.data,
                      num_rows=test.num_rows, num_cols=test.num_cols))


def _base(train, **kw):
    return dict(dict(m=train.num_rows, n=train.num_cols, f=16, lam=0.05,
                     iters=2, verbose=False, debug_timing=False,
                     chunk_nnz=1 << 11, panel_size=32, chunk_rows=64,
                     solver="cg"), **kw)


_JAX_RUNS = {}


def _jax_run(problem, n_dev, **kw):
    """The JAX ShardedOutOfCoreALS on its "xla" backend (memoized)."""
    key = (id(problem), n_dev, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        train, test = problem
        x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
        _JAX_RUNS[key] = jso.ShardedOutOfCoreALS(
            JConfig(backend="xla", **_base(train, **kw)), train, None, test,
            n_devices=n_dev).run(x0, th0)
    return _JAX_RUNS[key]


def _port_run(problem, backend="pallas", **kw):
    train, test = _port(*problem)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    model = so.ShardedOutOfCoreALS(
        ALSConfig(backend=backend, **_base(train, **kw)), train, None, test,
        n_devices=1, device="cpu")
    return model, model.run(x0, th0)


def _close(history, x, theta, ref, tol=2e-3, ftol=2e-2):
    for a, b in zip(ref.history, history, strict=True):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=tol)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=tol)
    np.testing.assert_allclose(x, ref.x, rtol=ftol, atol=ftol)
    np.testing.assert_allclose(theta, ref.theta, rtol=ftol, atol=ftol)


@pytest.mark.parametrize("backend,extra", [
    ("xla", dict(solver="cholesky")), ("pallas", {}),
    ("pallas", dict(gram_dtype="f32", aug_gram="force"))])
def test_world_one_matches_jax(small_problem, backend, extra):
    """One rank, X on the host: on "pallas" with CG K1 solves the X
    chunks (K6 with aug "force"), K2 forms the theta partials, K3 solves
    theta (plain versions here); on "xla" the plain Gram and Cholesky.
    Several X panels stream per theta phase."""
    model, res = _port_run(small_problem, backend, **extra)
    assert model.n_panels > 1 and len(model.theta_steps) > model.n_panels
    assert model.x_store.dtype == torch.float32
    _close(res.history, res.x, res.theta,
           _jax_run(small_problem, 1, **extra))


_SPAWNED = {}


def _spawned(problem, place, lazy_nnz_threshold=None):
    """Two ranks on gloo, spawned (memoized)."""
    key = (id(problem), place, lazy_nnz_threshold)
    if key not in _SPAWNED:
        train, test = _port(*problem)
        x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
        cfg = ALSConfig(backend="pallas",
                        **_base(train, x_placement=place))
        _SPAWNED[key] = spawn(2, so.run_rank, cfg, (train, test), x0, th0,
                              lazy_nnz_threshold, device="cpu",
                              timeout=120)
    return _SPAWNED[key]


@pytest.mark.parametrize("place", ["host", "device"])
def test_world_two_matches_jax(small_problem, place):
    """Two ranks against the JAX model on two mesh devices: theta equal
    bit for bit on both ranks after each iteration, the gathered X equal
    to each rank's own rows. With X on the device the theta phase takes
    panels sliced from it."""
    ranks = _spawned(small_problem, place)
    ref = _jax_run(small_problem, 2, x_placement=place)
    for r in ranks:
        assert r["theta_steps"] > 0 and not r["lazy"]
        assert r["own_rows_match"]
        # the mesh's count: A and b of n_pad = 64 theta rows at f_pad
        # 128 in f32, and the test error's f64 sum
        assert r["allreduce_bytes"] == 64 * (128 * 128 + 128) * 4 + 8
    _close(ranks[1]["history"], ranks[0]["x"], ranks[0]["theta"], ref)
    _close(ranks[0]["history"], ranks[0]["x"], ranks[0]["theta"], ref)
    assert ranks[0]["theta_sha256"] == ranks[1]["theta_sha256"]
    assert len(set(ranks[0]["theta_sha256"])) == 2   # theta moved
    assert ranks[0]["x_sha256"] == ranks[1]["x_sha256"]
    assert sorted(np.concatenate([r["own_ids"] for r in ranks])) == \
        list(range(small_problem[0].num_rows))


def test_device_placement_matches_jax(small_problem):
    """One rank, X on the device: theta solved directly against it (K1
    on the device X, plain here), against the JAX direct route."""
    model, res = _port_run(small_problem, x_placement="device")
    assert model._theta_direct and model.theta_steps == []
    assert model._hot_rows.size == 0 and model.x_store is None
    _close(res.history, res.x, res.theta,
           _jax_run(small_problem, 1, x_placement="device"))


def test_hot_columns_match_host_placement(small_problem, monkeypatch):
    """THETA_SEG_W=32 sends the columns of more ratings through the hot
    segments (K2 with an f32 A, then K3; plain here): with an exact
    solver the trajectory equals the host placement's within 5e-5, and
    the factors within rtol 1e-3, atol 1e-4 (the JAX package's own
    limits for the same check)."""
    kw = dict(solver="cholesky", iters=3)
    _, host = _port_run(small_problem, "pallas", x_placement="host", **kw)
    monkeypatch.setattr(so.ShardedOutOfCoreALS, "THETA_SEG_W", 32)
    model, dev = _port_run(small_problem, "pallas", x_placement="device",
                           **kw)
    assert model._hot_rows.size > 0 and model._hot_chunks
    _close(dev.history, dev.x, dev.theta, host, tol=5e-5)
    np.testing.assert_allclose(dev.x, host.x, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(dev.theta, host.theta, rtol=1e-3, atol=1e-4)


def test_cold_start_matches_jax(small_problem):
    """x_warm_start=False: the device placement's CG starts from zero,
    as the JAX package's does."""
    kw = dict(x_placement="device", x_warm_start=False, iters=3)
    _, res = _port_run(small_problem, **kw)
    _close(res.history, res.x, res.theta, _jax_run(small_problem, 1, **kw))


def test_keep_sharded_fetch_and_resume(small_problem, tmp_path):
    """keep_sharded leaves X in the shard (x None), fetch_x gathers it;
    a run resumed from x_host0 and one resumed from a checkpoint equal
    the uninterrupted run (rtol 1e-5, atol 1e-6, the JAX package's
    limits for its resume)."""
    train, test = _port(*small_problem)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    ck = str(tmp_path / "ck")

    def model(**kw):
        return so.ShardedOutOfCoreALS(
            ALSConfig(backend="pallas", **_base(
                train, solver="cholesky", **kw)), train, None, test,
            n_devices=1, device="cpu")

    full = model(iters=3, checkpoint_dir=ck, checkpoint_every=1).run(x0,
                                                                     th0)
    head = model(iters=1)
    one = head.run(x0, th0, keep_sharded=True)
    assert one.x is None and head.x_host is head.x_store
    rest = model(iters=3).run(None, one.theta, start_iter=1,
                              x_host0=head.x_host[None])
    from cumf_als_tpu_torch.utils.checkpoint import load_checkpoint
    x1, th1, it = load_checkpoint(ck, 1)
    rest2 = model(iters=3).run(x1, th1, start_iter=it + 1)
    for r in (rest, rest2):
        assert r.history[-1].iteration == full.history[-1].iteration == 2
        np.testing.assert_allclose(r.x, full.x, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(r.theta, full.theta, rtol=1e-5,
                                   atol=1e-6)
    dev = model(iters=2, x_placement="device")
    res = dev.run(x0, th0, keep_sharded=True)
    assert res.x is None
    x = dev.fetch_x()
    assert x.shape == (train.num_rows, 16) and np.isfinite(x).all()
    np.testing.assert_array_equal(
        x, model(iters=2, x_placement="device").run(x0, th0).x)


@pytest.mark.parametrize("max_depth,dtype", [(2, torch.float32),
                                             (16, torch.bfloat16)])
def test_accumulators_and_depth_guard_equal_jax(small_problem, capfd,
                                                monkeypatch, max_depth,
                                                dtype):
    """gram_dtype "bf16": the theta accumulators stay bf16 up to
    BF16_ACCUM_MAX_DEPTH partial adds a row (3.0 here) and are promoted
    to f32 above it, with the JAX model's stderr line (the limit lowered
    to 2 in both packages for the promoted case); bf16 factors keep a
    bf16 X store."""
    monkeypatch.setattr(jso.ShardedOutOfCoreALS, "BF16_ACCUM_MAX_DEPTH",
                        max_depth)
    monkeypatch.setattr(als, "BF16_ACCUM_MAX_DEPTH", max_depth)
    train, test = small_problem
    kw = _base(train, gram_dtype="bf16", factor_dtype="bf16", iters=1)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    jm = jso.ShardedOutOfCoreALS(JConfig(backend="xla", **kw), train, None,
                                 test, n_devices=1)
    jm.run(x0, th0)
    jerr = [ln for ln in capfd.readouterr().err.splitlines()
            if ln.startswith("[sharded_ooc]")]
    ptrain, ptest = _port(train, test)
    pm = so.ShardedOutOfCoreALS(ALSConfig(backend="pallas", **kw), ptrain,
                                None, ptest, n_devices=1, device="cpu")
    perr = [ln for ln in capfd.readouterr().err.splitlines()
            if ln.startswith("[sharded_ooc]")]
    assert perr == jerr and len(perr) == int(dtype == torch.float32)
    assert pm._theta_accum_depth() == jm._theta_accum_depth()
    assert pm.accum_dtype == dtype and pm.x_store.dtype == torch.bfloat16
    res = pm.run(x0, th0)
    assert np.isfinite(res.history[-1].train_rmse)


def test_lazy_plans_match_eager_one_rank(small_problem, monkeypatch):
    """LAZY_NNZ_THRESHOLD=1: every plan lazy (each chunk made when
    streamed), the trajectory equal to the eager plans' within 1e-6 and
    X within 1e-5 (the JAX package's limits), X on the host and on the
    device."""
    for place in ("host", "device"):
        _, eager = _port_run(small_problem, x_placement=place)
        monkeypatch.setattr(so, "LAZY_NNZ_THRESHOLD", 1)
        model, lazy = _port_run(small_problem, x_placement=place)
        monkeypatch.undo()
        assert model.lazy and all(not hasattr(c, "cols")
                                  for c in model.row_plan.chunks)
        steps = model.th_plan.chunks if place == "device" else \
            model.theta_steps
        assert steps and all(not hasattr(s, "cols") for s in steps)
        _close(lazy.history, lazy.x, lazy.theta, eager, tol=1e-6,
               ftol=1e-5)


def test_lazy_plans_match_eager_two_ranks(small_problem):
    """The same at two ranks: the lazy per-rank panel plans aligned into
    lazy steps, each rank's slice of every chunk made when streamed."""
    eager = _spawned(small_problem, "host")
    lazy = _spawned(small_problem, "host", lazy_nnz_threshold=1)
    for e, lz in zip(eager, lazy):
        assert lz["lazy"] and lz["theta_steps"] == e["theta_steps"]
        assert lz["own_rows_match"]
        for a, b in zip(e["history"], lz["history"], strict=True):
            assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-6)
            assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-6)
    np.testing.assert_allclose(lazy[0]["x"], eager[0]["x"], rtol=1e-5,
                               atol=1e-5)
    assert lazy[0]["theta_sha256"] == lazy[1]["theta_sha256"]


@pytest.mark.parametrize("use_native", [True, False])
def test_lazy_panel_chunk_materializes_the_eager_chunk(
        medium_problem, monkeypatch, use_native):
    """build_panel_plan(lazy=True): each LazyPanelChunk materializes the
    eager chunk's arrays, array for array, through the native data plane
    and through numpy, and the JAX package's lazy chunk's too."""
    if use_native and not native.available():
        native.build()
    monkeypatch.setattr(native, "available", lambda: use_native)
    train = _port(*medium_problem)[0]
    kw = dict(panel_size=64, chunk_nnz=1 << 10, split_width=32)
    eager = tiling.build_panel_plan(train, **kw)
    lazy = tiling.build_panel_plan(train, lazy=True, **kw)
    theirs = jtiling.build_panel_plan(medium_problem[0], lazy=True, **kw)
    assert len(eager.chunks) == len(lazy.chunks) == len(theirs.chunks)
    assert eager.padded_nnz == lazy.padded_nnz
    for e, lz, j in zip(eager.chunks, lazy.chunks, theirs.chunks):
        assert isinstance(lz, tiling.LazyPanelChunk)
        assert (lz.panel, lz.width) == (e.panel, e.width) == (j.panel,
                                                              j.width)
        got = lz.materialize()
        for x, y, z in zip((e.rows, e.nnz, e.cols, e.vals), got,
                           j.materialize()):
            assert y.dtype == x.dtype
            np.testing.assert_array_equal(y, x)
            np.testing.assert_array_equal(y, z)


def _tree(d):
    """{relative path: bytes} of every file under d."""
    out = {}
    for root, _, files in os.walk(d):
        for fn in files:
            path = os.path.join(root, fn)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, d)] = fh.read()
    return out


def _npy_and_streams_equal(a, b):
    """Two cache directories hold the same entries under the same keys:
    each entry's meta.json and .npy arrays, and each stream store's steps
    array for array (read through the JAX package's StreamCache)."""
    ta, tb = _tree(a), _tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        if rel.endswith(".json") and not rel.startswith("streams"):
            assert ta[rel] == tb[rel], rel
        elif rel.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(a, rel)),
                                          np.load(os.path.join(b, rel)))
    keys = {rel[len("streams/"):-len(".bin")] for rel in ta
            if rel.startswith("streams") and rel.endswith(".bin")}
    assert keys
    for key in keys:
        sa, sb = jsc.StreamCache(a, key), jsc.StreamCache(b, key)
        assert sa.ready and sb.ready and sa._entries.keys() == \
            sb._entries.keys()
        for step in sa._entries:
            ea, eb = sa.get(int(step)), sb.get(int(step))
            assert ea.keys() == eb.keys()
            for name in ea:
                assert ea[name].dtype == eb[name].dtype
                np.testing.assert_array_equal(ea[name], eb[name])
    return keys


@pytest.mark.parametrize("place", ["host", "device"])
def test_lazy_entries_and_streams_carry_across(small_problem, tmp_path,
                                               monkeypatch, place):
    """Lazy plans with a plan cache, in both packages: each writes its
    lazy plan entries (sharded_row_lazy, with X on the host
    aligned_steps_lazy) and its stream stores (the theta steps', with X
    on the device the X chunks' and the direct theta chunks') under the
    same keys with the same arrays; a run of either package on the
    other's directory reads every entry and store and writes nothing."""
    monkeypatch.setattr(so, "LAZY_NNZ_THRESHOLD", 1)
    monkeypatch.setattr(jso, "LAZY_NNZ_THRESHOLD", 1)
    train, test = small_problem
    ptrain, ptest = _port(train, test)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)

    def jax(d):
        return jso.ShardedOutOfCoreALS(JConfig(backend="xla", **_base(
            train, x_placement=place, plan_cache_dir=d)), train, None,
            test, n_devices=1).run(x0, th0)

    def port(d):
        return so.ShardedOutOfCoreALS(ALSConfig(backend="pallas", **_base(
            train, x_placement=place, plan_cache_dir=d)), ptrain, None,
            ptest, n_devices=1, device="cpu").run(x0, th0)

    a, b = str(tmp_path / "jax"), str(tmp_path / "port")
    ja = jax(a)
    pb = port(b)
    keys = _npy_and_streams_equal(a, b)
    kinds = {k.split("-")[0] for k in keys}
    assert kinds == ({"thstream"} if place == "host" else
                     {"xstream", "thstream"})
    meta = {k.split("-")[0] for k in os.listdir(a) if k != "streams"}
    assert meta == {"csc", "sh_row", "sh_ooc_theta" if place == "host"
                    else "sh_thdir"}
    before_a, before_b = _tree(a), _tree(b)
    pa = port(a)   # the port on the JAX package's entries and stores
    jb = jax(b)
    assert _tree(a) == before_a and _tree(b) == before_b
    _close(pa.history, pa.x, pa.theta, ja)
    _close(pb.history, pb.x, pb.theta, jb)


def test_stream_cache_dtypes_both_ways(tmp_path):
    """A store written by either package is read by the other array for
    array: int32, uint16 ids, float16, float32 and bfloat16 (the JAX
    package's ml_dtypes array; the port's torch.bfloat16 tensor, read
    back as its uint16 bits)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    arrays = dict(rows=np.arange(6, dtype=np.int32).reshape(2, 3),
                  cols=np.arange(65530, 65536, dtype=np.uint16),
                  h=f32.astype(np.float16), v=f32)
    bf = f32.astype(ml_dtypes.bfloat16)
    jw = jsc.StreamCache(str(tmp_path / "j"), "k")
    jw.begin()
    jw.put(0, dict(arrays, bf=bf))
    jw.put(1, dict(rows=arrays["rows"] + 1))
    jw.finish()
    pr = sc.StreamCache(str(tmp_path / "j"), "k")
    got = pr.get(0)
    for name, arr in arrays.items():
        assert got[name].dtype == arr.dtype
        np.testing.assert_array_equal(got[name], arr)
    np.testing.assert_array_equal(got["bf"], bf.view(np.uint16))
    assert sc.bf16_tensor(got["bf"]).dtype == torch.bfloat16
    np.testing.assert_array_equal(
        sc.bf16_tensor(got["bf"]).float().numpy(), bf.astype(np.float32))
    np.testing.assert_array_equal(pr.get(1)["rows"], arrays["rows"] + 1)
    assert pr.get(2) is None

    pw = sc.StreamCache(str(tmp_path / "p"), "k")
    pw.begin()
    pw.put(0, dict(arrays, bf=torch.from_numpy(f32).to(torch.bfloat16)))
    pw.finish()
    back = jsc.StreamCache(str(tmp_path / "p"), "k").get(0)
    for name, arr in arrays.items():
        assert back[name].dtype == arr.dtype
        np.testing.assert_array_equal(back[name], arr)
    assert back["bf"].dtype == bf.dtype
    np.testing.assert_array_equal(back["bf"], bf)


def test_unfinished_stream_store_leaves_no_index(tmp_path):
    """A build that stops before finish() leaves no index: the next
    process builds again (and a store finished by another process is
    found by refresh())."""
    w = sc.StreamCache(str(tmp_path), "k")
    w.begin()
    w.put(0, dict(a=np.ones(3, np.float32)))
    assert not os.path.exists(os.path.join(str(tmp_path), "streams",
                                           "k.idx.json"))
    again = sc.StreamCache(str(tmp_path), "k")
    assert not again.ready and again.get(0) is None
    assert not jsc.StreamCache(str(tmp_path), "k").ready
    w.finish()
    assert again.refresh() and again.get(0)["a"].tolist() == [1.0] * 3
