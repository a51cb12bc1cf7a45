"""The batched-panel route of the port (both sides big: the gather table
passes the panel size and the full accumulators pass the budget) against
the JAX package's ALS and against the port's own panel route."""

import numpy as np
import pytest
import torch

from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.als import ALS as JALS
from cumf_als_tpu.ops.tiling import BatchedPanelPlan as JBatchedPanelPlan

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.als import ALS
from cumf_als_tpu_torch.ops.tiling import BatchedPanelPlan, PanelPlan
from cumf_als_tpu_torch.utils.io import CSRMatrix

# rows of the medium problem: X 300 (two full batches of 128 and one of
# 44), theta 220 (one full batch and one of 92)
BATCHED = dict(panel_size=64, panel_budget_bytes=1 << 20, batch_rows=128)
BASE = dict(f=16, lam=0.05, iters=3, verbose=False, debug_timing=False,
            chunk_nnz=1 << 11, chunk_rows=64)


def _port_csr(c) -> CSRMatrix:
    return CSRMatrix(indptr=c.indptr, indices=c.indices, data=c.data,
                     num_rows=c.num_rows, num_cols=c.num_cols)


def _close(got, want):
    for a, b in zip(want.history, got.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-3)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=2e-3)
    assert len(got.history) == len(want.history) == BASE["iters"]
    np.testing.assert_allclose(got.x, want.x, rtol=2e-2, atol=2e-2)


def _fields(train, **extra):
    return dict(m=train.num_rows, n=train.num_cols, **BASE, **extra)


def test_batched_panel_matches_jax(medium_problem):
    """CG on backend "xla" reaches the route in both packages (the JAX
    package's fast-gate case); with the default float32 accumulators it
    runs the augmented twin."""
    train, test = medium_problem
    fields = _fields(train, solver="cg", backend="xla", **BATCHED)
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    jal = JALS(JConfig(**fields), train, None, test)
    assert isinstance(jal.plan_x[0], JBatchedPanelPlan)
    want = jal.run(x0, th0)
    al = ALS(ALSConfig(**fields), _port_csr(train), None, test,
             device="cpu")
    assert isinstance(al.plan_x[0], BatchedPanelPlan)
    assert isinstance(al.plan_theta[0], BatchedPanelPlan)
    assert al._use_panel_aug()
    _close(al.run(x0, th0), want)


@pytest.mark.parametrize("solver", ["cholesky", "lu"])
def test_batched_panel_matches_panel_route(medium_problem, solver):
    """Cholesky and LU on backend "pallas" (the plain K2 on the CPU) take
    the route; the same run with the default budget takes the panel route
    for X and the direct route for theta."""
    train, test = medium_problem
    train = _port_csr(train)
    fields = _fields(train, solver=solver, backend="pallas")
    x0, th0 = init_factors(train.num_rows, train.num_cols, 16, seed=1)
    ref = ALS(ALSConfig(**dict(fields, panel_size=64)), train, None, test,
              device="cpu")
    assert isinstance(ref.plan_x[0], PanelPlan)
    al = ALS(ALSConfig(**fields, **BATCHED), train, None, test,
             device="cpu")
    assert isinstance(al.plan_x[0], BatchedPanelPlan)
    assert not al._use_panel_aug()
    _close(al.run(x0, th0), ref.run(x0, th0))


def test_full_batch_padding_stays_out_of_real_rows(medium_problem):
    """A full batch's dummy chunk rows carry id B (one past the batch) and
    a partial batch's padding ids equal num_rows: one X phase neither
    raises nor writes a row that has no ratings, and every row it solves
    equals the panel route's."""
    train, _ = medium_problem
    # two rows without ratings: they are in no batch
    indptr = np.asarray(train.indptr, np.int64).copy()
    keep = np.ones(train.nnz, bool)
    for r in (0, train.num_rows - 1):
        keep[indptr[r]:indptr[r + 1]] = False
    lens = np.diff(indptr)
    lens[[0, train.num_rows - 1]] = 0
    new_indptr = np.zeros_like(indptr)
    np.cumsum(lens, out=new_indptr[1:])
    csr = CSRMatrix(indptr=new_indptr.astype(np.int32),
                    indices=train.indices[keep], data=train.data[keep],
                    num_rows=train.num_rows, num_cols=train.num_cols)
    fields = _fields(csr, solver="cholesky", backend="pallas")
    al = ALS(ALSConfig(**fields, **BATCHED), csr, None, None, device="cpu")
    plan = al.plan_x[0]
    full = [b for b in plan.batches if b.plan.num_rows == plan.batch_rows]
    assert full and any(
        (c.rows == plan.batch_rows).any() for b in full for c in b.plan.chunks)
    assert (plan.batches[-1].global_ids == csr.num_rows).any()
    ref = ALS(ALSConfig(**dict(fields, panel_size=64)), csr, None, None,
              device="cpu")
    _, th0 = init_factors(csr.num_rows, csr.num_cols, 16, seed=1)
    theta = ref._pad_f(th0)
    sentinel = torch.full((csr.num_rows, 128), 7.0)
    got, _ = al._update_phase(theta, sentinel.clone(), al.plan_x, False)
    want, _ = ref._update_phase(theta, sentinel.clone(), ref.plan_x, False)
    empty = [0, csr.num_rows - 1]
    assert torch.all(got[empty] == 7.0)
    live = torch.ones(csr.num_rows, dtype=torch.bool)
    live[empty] = False
    torch.testing.assert_close(got[live], want[live], rtol=1e-4, atol=1e-4)


def test_batch_rows_follow_the_accumulator_dtype():
    """2^17 rows with bf16 accumulators, 2^16 with float32, unless set."""
    al = ALS.__new__(ALS)
    for gram_dtype, batch_rows, want in (("bf16", 0, 1 << 17),
                                         ("f32", 0, 1 << 16),
                                         ("bf16", 4096, 4096)):
        al.cfg = ALSConfig(m=3, n=4, f=16, gram_dtype=gram_dtype,
                           batch_rows=batch_rows)
        jal = JALS.__new__(JALS)
        jal.cfg = JConfig(m=3, n=4, f=16, gram_dtype=gram_dtype,
                          batch_rows=batch_rows)
        assert al._batch_rows() == jal._batch_rows() == want
