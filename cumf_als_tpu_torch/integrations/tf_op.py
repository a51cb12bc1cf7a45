"""TensorFlow surface: the DoAls custom op on the port.

The reference wraps its whole solver as a CPU-placed TF op with 20 input
tensors and 3 outputs, thetat (f, n), xt (f, m), rmse (1, 1), the
factors initialized inside the op with 0.1 * rand (reference
tensorflow/als_tf.cc:7-30, 120-126). Here:

  - do_als(...)   : the same signature and outputs, the port's ALS
                    behind a tf.py_function boundary (the reference's
                    CPU op driving a GPU);
  - make_tf_predict(): the serving forward as a native TF graph function
                    of tf.gather and tf.reduce_sum, with no Python
                    boundary (the reference's wish to "wrap individual
                    cuMF kernels as TF ops", als_tf.cc:3-5).

TensorFlow is optional: without it both raise ImportError.
"""

from __future__ import annotations

import numpy as np


def _require_tf():
    try:
        import tensorflow as tf
        return tf
    except ImportError as e:
        raise ImportError(
            "tensorflow is not installed; the TF surface is optional — "
            "use cumf_als_tpu_torch.integrations.torch_op or the Python "
            "API") from e


def do_als(csrrow, csrcol, csrval, cscrow, csccol, cscval, coorow,
           coorowtest, coocoltest, coovaltest, m, n, f, nnz, nnz_test,
           lambda_, iters, xbatch, thetabatch, deviceid, *, device=None):
    """DoAls: returns (thetat (f, n), xt (f, m), rmse (1, 1)) tf tensors.

    The arguments' order and meaning are REGISTER_OP("DoAls")'s
    (als_tf.cc:7-30); the CSC triple, coorow, xbatch and thetabatch are
    taken for the signature alone (the CSC is derived, batching is the
    plans'). The run takes cuda:{deviceid}, or `device` when given
    ("cpu" runs on the CPU)."""
    tf = _require_tf()

    def _run(csrrow, csrcol, csrval, coorowtest, coocoltest, coovaltest,
             m, n, f, nnz, nnz_test, lambda_, iters, deviceid):
        from cumf_als_tpu_torch.config import ALSConfig
        from cumf_als_tpu_torch.integrations.torch_op import op_factors
        from cumf_als_tpu_torch.models.als import ALS, resolve_device
        from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix
        dev = resolve_device(device if device is not None
                             else f"cuda:{int(deviceid)}")
        m, n, f = int(m), int(n), int(f)
        csr = CSRMatrix(indptr=np.asarray(csrrow, np.int64),
                        indices=np.asarray(csrcol, np.int32),
                        data=np.asarray(csrval, np.float32),
                        num_rows=m, num_cols=n)
        test = COOMatrix(row=np.asarray(coorowtest, np.int32),
                         col=np.asarray(coocoltest, np.int32),
                         data=np.asarray(coovaltest, np.float32),
                         num_rows=m, num_cols=n)
        cfg = ALSConfig(m=m, n=n, f=f, nnz=int(nnz),
                        nnz_test=int(nnz_test), lam=float(lambda_),
                        iters=int(iters), verbose=False,
                        debug_timing=False)
        x0 = np.zeros((m, f), np.float32)
        res = ALS(cfg, csr, None, test, device=dev).run(x0, op_factors(n, f))
        rmse = np.asarray([[res.final_test_rmse]], np.float32)
        return res.theta.T.copy(), res.x.T.copy(), rmse

    thetat, xt, rmse = tf.py_function(
        _run,
        [csrrow, csrcol, csrval, coorowtest, coocoltest, coovaltest,
         m, n, f, nnz, nnz_test, lambda_, iters, deviceid],
        [tf.float32, tf.float32, tf.float32])
    return thetat, xt, rmse


def make_tf_predict(with_gradient: bool = False):
    """The prediction forward as a native TF function:
    predict(xt (f, m), thetat (f, n), rows, cols) -> ratings. Without
    `with_gradient`, differentiating it raises (tf PreventGradient), as
    the JAX package's jax2tf export does."""
    tf = _require_tf()

    def predict(xt, thetat, rows, cols):
        xg = tf.gather(tf.transpose(xt), rows)
        tg = tf.gather(tf.transpose(thetat), cols)
        out = tf.reduce_sum(xg * tg, axis=-1)
        if with_gradient:
            return out
        return tf.raw_ops.PreventGradient(
            input=out, message="make_tf_predict(with_gradient=False) "
            "does not support gradients; pass with_gradient=True")

    return tf.function(predict, autograph=False)
