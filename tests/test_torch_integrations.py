"""The port's framework surfaces (cumf_als_tpu_torch/integrations/)
against the JAX package's: the torch DoAls op and TorchMF against
cumf_als_tpu.integrations.torch_op, the TF DoAls op and the native TF
predict against cumf_als_tpu.integrations.tf_op (where TensorFlow is
installed), and the refusals of both.

On `small_problem` (f=16, lambda 0.05, 3 iterations, the ops' default
"xla" backend): the final test RMSE within 1e-4 and the factors within
atol 2e-2 (CG exits a system once rsnew < cg_tol, so a row near the
threshold can stop one step apart in the two packages; Cholesky within
1e-3); TorchMF's predictions equal the JAX class's, and their RMSE is
the op's within 1e-3 relative. The same op on the card is held to its
CPU run in tests/test_torch_cuda.py."""

import sys

import numpy as np
import pytest
import torch

from cumf_als_tpu.integrations import torch_op as jop

from cumf_als_tpu_torch.integrations import tf_op, torch_op


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch_args(problem):
    train, test = problem
    return (torch.from_numpy(np.asarray(train.indptr, np.int64)),
            torch.from_numpy(train.indices), torch.from_numpy(train.data),
            torch.from_numpy(test.row), torch.from_numpy(test.col),
            torch.from_numpy(test.data), train.num_rows, train.num_cols,
            16, 0.05)


_JAX = {}


def _jax_op(problem, solver):
    if solver not in _JAX:
        _JAX[solver] = jop.do_als(*_torch_args(problem), iters=3,
                                  solver=solver)
    return _JAX[solver]


@pytest.mark.parametrize("solver,ftol", [("cg", 2e-2), ("cholesky", 1e-3)])
def test_torch_op_matches_jax(small_problem, solver, ftol):
    train, _ = small_problem
    jt, jx, jr = _jax_op(small_problem, solver)
    thetat, xt, rmse = torch_op.do_als(*_torch_args(small_problem),
                                       iters=3, solver=solver, device="cpu")
    assert thetat.shape == (16, train.num_cols) and thetat.device.type == \
        "cpu"
    assert xt.shape == (16, train.num_rows) and rmse.shape == (1, 1)
    assert float(rmse) == pytest.approx(float(jr), abs=1e-4)
    np.testing.assert_allclose(thetat.numpy(), jt.numpy(), atol=ftol)
    np.testing.assert_allclose(xt.numpy(), jx.numpy(), atol=ftol)


def test_torch_mf_predicts_as_jax(small_problem):
    _, test = small_problem
    jt, jx, _ = _jax_op(small_problem, "cg")
    thetat, xt, rmse = torch_op.do_als(*_torch_args(small_problem),
                                       iters=3, device="cpu")
    rows = torch.from_numpy(test.row.astype(np.int64))
    cols = torch.from_numpy(test.col.astype(np.int64))
    assert torch.equal(torch_op.TorchMF(jx, jt).predict(rows, cols),
                       jop.TorchMF(jx, jt).predict(rows, cols))
    pred = torch_op.TorchMF(xt, thetat).predict(rows.int(), cols.int())
    e = pred.numpy() - test.data
    assert np.sqrt(np.mean(e * e)) == pytest.approx(float(rmse), rel=1e-3)


def test_torch_op_refuses_silent_cpu(small_problem):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        torch_op.do_als(*_torch_args(small_problem), iters=1)


def test_tf_surface_needs_tensorflow(monkeypatch):
    """Without TensorFlow both TF entry points raise ImportError naming
    the torch op."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="integrations.torch_op"):
        tf_op.make_tf_predict()
    with pytest.raises(ImportError, match="integrations.torch_op"):
        tf_op.do_als(*([None] * 20))


def _tf_args(tf, train, test):
    return (tf.constant(np.asarray(train.indptr, np.int32)),
            tf.constant(train.indices), tf.constant(train.data),
            tf.constant(np.zeros(1, np.int32)),   # cscrow (derived)
            tf.constant(np.zeros(1, np.int32)),
            tf.constant(np.zeros(1, np.float32)),
            tf.constant(np.zeros(1, np.int32)),   # coorow
            tf.constant(test.row), tf.constant(test.col),
            tf.constant(test.data),
            tf.constant(train.num_rows), tf.constant(train.num_cols),
            tf.constant(16), tf.constant(train.nnz, tf.int64),
            tf.constant(test.nnz, tf.int64), tf.constant(0.05),
            tf.constant(3), tf.constant(1), tf.constant(1),
            tf.constant(0))


def test_tf_do_als_matches_jax(small_problem):
    tf = pytest.importorskip("tensorflow")
    from cumf_als_tpu.integrations import tf_op as jtf
    train, test = small_problem
    args = _tf_args(tf, train, test)
    jt, jx, jr = jtf.do_als(*args)
    thetat, xt, rmse = tf_op.do_als(*args, device="cpu")
    assert tuple(thetat.shape) == (16, train.num_cols)
    assert tuple(xt.shape) == (16, train.num_rows)
    assert float(rmse.numpy()[0, 0]) == pytest.approx(
        float(jr.numpy()[0, 0]), abs=1e-4)
    np.testing.assert_allclose(thetat.numpy(), jt.numpy(), atol=2e-2)
    np.testing.assert_allclose(xt.numpy(), jx.numpy(), atol=2e-2)
    if not torch.cuda.is_available():   # deviceid 0 names a card
        with pytest.raises(Exception, match="device='cpu'"):
            tf_op.do_als(*args)


@pytest.mark.parametrize("with_gradient", [False, True])
def test_tf_predict_matches_jax(small_problem, with_gradient):
    """The native TF predict against the jax2tf export: the same ratings
    (rtol 1e-6), and the same gradient behaviour: without with_gradient
    a tape raises LookupError, with it the gradients agree (1e-5)."""
    tf = pytest.importorskip("tensorflow")
    from cumf_als_tpu.integrations import tf_op as jtf
    train, _ = small_problem
    rng = np.random.RandomState(0)
    xt = tf.Variable(rng.standard_normal((8, train.num_rows)).astype(
        np.float32))
    thetat = tf.Variable(rng.standard_normal((8, train.num_cols)).astype(
        np.float32))
    rows = rng.randint(0, train.num_rows, 50).astype(np.int32)
    cols = rng.randint(0, train.num_cols, 50).astype(np.int32)
    ref = np.einsum("fi,fi->i", xt.numpy()[:, rows],
                    thetat.numpy()[:, cols])
    grads = []
    for make in (jtf.make_tf_predict, tf_op.make_tf_predict):
        fn = make(with_gradient=with_gradient)
        got = fn(xt, thetat, tf.constant(rows), tf.constant(cols))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
        if not with_gradient:
            with pytest.raises(LookupError):
                with tf.GradientTape() as tape:
                    out = tf.reduce_sum(fn(xt, thetat, rows, cols) ** 2)
                tape.gradient(out, [xt, thetat])
            continue
        with tf.GradientTape() as tape:
            out = tf.reduce_sum(fn(xt, thetat, rows, cols) ** 2)
        grads.append([tf.convert_to_tensor(g).numpy()
                      for g in tape.gradient(out, [xt, thetat])])
    if with_gradient:
        for a, b in zip(*grads):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
