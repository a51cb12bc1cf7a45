"""The plain versions of the fused kernels K1 (`gather_gram_cg`) and K6
(`gather_gram_cg(aug=True)`) against the JAX package's Pallas kernels
(interpret mode) on chunks whose rows stop at different nnz inside one
chunk, at the edges of the CUDA kernels' 64-slot tile: nnz in (0, 1, 15,
16, 17, 63, 64, 65, 128, 129, P) up to P, and a dummy tail row without
ratings; P = 64, 256 and 520 (1, 4 and 9 tiles); f32 and bf16 tables and
values. The plain versions are what the CUDA kernels are held to on a
card (tests/test_torch_cuda.py runs the same chunks there), so these
tests tie that grid to the reference.

Tolerances: x 2e-3 absolute at the default cg_iters=6 (the tolerance of
tests/test_torch_kernels.py and tests/test_pallas.py); se 2e-3 absolute
and 1e-4 relative, as the card tests of tests/test_torch_cuda.py hold
it: a row of 520 ratings has se near 1e3, where f32 sums in another
order differ by a few 1e-3 (2.7e-6 relative). Rows
without ratings are exactly 0 in x and se, and K6's lane 127 of x is
exactly 0, on both sides."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu_torch.ops import cuda_solve as cs
from test_torch_cuda import LAM, THETA_NNZ, theta_chunk


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    yield


@pytest.mark.parametrize("p", [64, 256, 520])
@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("factor_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("vals_bf16", [False, True])
def test_fused_plain_where_rows_stop_matches_pallas(p, aug, factor_dtype,
                                                    vals_bf16):
    table, cols, vals, nnz, x0 = theta_chunk(p, aug)
    jv = jnp.asarray(vals, jnp.bfloat16 if vals_bf16 else None)
    jx, jse = ps.gather_gram_cg(jnp.asarray(table), jnp.asarray(cols), jv,
                                jnp.asarray(nnz), jnp.asarray(x0), LAM,
                                factor_dtype=factor_dtype, aug=aug)
    t = torch.from_numpy(table)
    x, se = cs.gather_gram_cg(
        t.to(torch.bfloat16) if factor_dtype == "bf16" else t,
        torch.from_numpy(cols),
        torch.from_numpy(vals).to(torch.bfloat16 if vals_bf16 else
                                  torch.float32),
        torch.from_numpy(nnz), torch.from_numpy(x0), LAM, aug=aug)
    assert x.shape == (len(nnz), 128) and se.shape == (len(nnz), 1)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-3)
    np.testing.assert_allclose(se.numpy(), np.asarray(jse), atol=2e-3,
                               rtol=1e-4)
    empty = nnz == 0
    assert np.all(x.numpy()[empty] == 0) and np.all(se.numpy()[empty] == 0)
    assert np.all(np.asarray(jx)[empty] == 0)
    if aug:
        assert np.all(x.numpy()[:, 127] == 0)
        assert np.all(np.asarray(jx)[:, 127] == 0)


def test_theta_chunk_stops_rows_at_the_tile_edges():
    """The grid the card tests and these run: every nnz of THETA_NNZ
    below P, a full row, a dummy tail row; pad slots only at each row's
    tail, naming the zero row with value 0."""
    for p in (64, 256, 520):
        table, cols, vals, nnz, x0 = theta_chunk(p, aug=True)
        want = [k for k in THETA_NNZ if k < p] + [p, 0]
        assert nnz.tolist() == want
        n = table.shape[0] - 1
        live = np.arange(p)[None, :] < nnz[:, None]
        assert np.all((cols == n) == ~live) and np.all(vals[~live] == 0)
        assert np.all(table[n] == 0) and np.all(table[:, 127] == 0)
        assert np.all(x0[-1] == 0) and np.all(x0[:, 127] == 0)
