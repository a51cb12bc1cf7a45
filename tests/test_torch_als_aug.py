"""The augmented-lane routes of the port's ALS against the JAX package's
ALS (its Pallas kernels in interpret mode), on the problem and with the
helpers of tests/test_torch_als.py:

  - gram_dtype="f32", aug_gram="auto" (the defaults): the panel route
    keeps ONE augmented accumulator on both backends;
  - aug_gram="force": the direct route takes the augmented fused kernel
    too, and bf16 accumulators also become augmented;
  - aug_gram="off", bf16 accumulators under "auto", promoted
    accumulators and F = f_pad keep split (A, b) buffers.

Tolerances per iteration (train, test): 1e-3 for f32 and 5e-3 / 1e-2
for bf16, as tests/test_als_e2e.py."""

import dataclasses

import numpy as np
import pytest
import torch

from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.als import ALS as JALS
from cumf_als_tpu.ops.tiling import PanelPlan as JPanelPlan

from cumf_als_tpu_torch import interop
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.als import ALS
from cumf_als_tpu_torch.ops import cuda_solve
from cumf_als_tpu_torch.ops.tiling import PanelPlan, UpdatePlan

from test_torch_als import (DTYPES, FIELDS, TOLS, _runs,  # noqa: F401
                            interpret_pallas, problem)


def _assert_close(got_hist, want_hist, dtype="f32"):
    tol_tr, tol_te = TOLS[dtype]
    assert len(got_hist) == len(want_hist) == FIELDS["iters"]
    for got, want in zip(got_hist, want_hist):
        assert got.train_rmse == pytest.approx(want.train_rmse, abs=tol_tr)
        assert got.test_rmse == pytest.approx(want.test_rmse, abs=tol_te)


def _accumulators(al, plan_pair):
    """The panel accumulators of a fresh Gram step over `plan_pair`."""
    n = plan_pair[0].num_cols
    table = torch.zeros((n, al.cfg.f_pad))
    return al.accumulate_panels(table, plan_pair)


# panel_size=40: X panel, theta direct; panel_size=30 puts the 45-row X
# table over the panel threshold too, so BOTH phases are panel routes and
# the train RMSE comes from _se_terms_aug.
@pytest.mark.parametrize("backend,panel_size", [
    ("pallas", 40), ("pallas", 30), ("xla", 40), ("xla", 30)])
def test_default_f32_config_takes_the_aug_panel_route(
        problem, interpret_pallas, backend, panel_size):
    jal, al, x0, th0 = _runs(problem, "f32", backend=backend,
                             panel_size=panel_size)
    assert al.cfg.aug_gram == "auto" and al._use_panel_aug()
    assert jal._use_panel_aug()
    assert isinstance(al.plan_x[0], PanelPlan)
    assert isinstance(jal.plan_x[0], JPanelPlan)
    both = panel_size == 30
    assert isinstance(al.plan_theta[0], PanelPlan) == both
    assert isinstance(jal.plan_theta[0], JPanelPlan) == both
    a_buf, b_buf = _accumulators(al, al.plan_x)
    assert b_buf is None and a_buf.dtype.is_floating_point
    _assert_close(al.run(x0, th0).history, jal.run(x0, th0).history)


def test_forced_aug_direct_route_matches_jax_and_split(problem,
                                                       interpret_pallas,
                                                       monkeypatch):
    jal, al, x0, th0 = _runs(problem, "f32", aug_gram="force")
    _, off, _, _ = _runs(problem, "f32", aug_gram="off")
    assert isinstance(al.plan_theta[0], UpdatePlan)
    seen = []
    plain = cuda_solve.gather_gram_cg_aug_plain
    monkeypatch.setattr(
        cuda_solve, "gather_gram_cg_aug_plain",
        lambda *a, **k: seen.append(1) or plain(*a, **k))
    hist = al.run(x0, th0).history
    assert len(seen) == FIELDS["iters"] * len(al.plan_theta[1])
    _assert_close(hist, jal.run(x0, th0).history)
    seen.clear()
    _assert_close(hist, off.run(x0, th0).history)
    assert not seen          # "off": the split kernel's plain version


def test_forced_aug_bf16_accumulators_match_jax(problem, interpret_pallas):
    """With "force" and bf16 accumulators b and sum v^2 ride a bf16
    buffer; the port mirrors that, so it stays within the bf16
    tolerances of the JAX run (not of the split-buffer run)."""
    jal, al, x0, th0 = _runs(problem, "bf16", aug_gram="force")
    a_buf, b_buf = _accumulators(al, al.plan_x)
    assert b_buf is None and a_buf.dtype == torch.bfloat16
    _assert_close(al.run(x0, th0).history, jal.run(x0, th0).history, "bf16")


@pytest.mark.parametrize("dtype,want_dtype", [("f32", "float32"),
                                              ("bf16", "bfloat16")])
def test_aug_off_keeps_split_buffers(problem, dtype, want_dtype):
    _, al, x0, th0 = _runs(problem, dtype, aug_gram="off")
    a_buf, b_buf = _accumulators(al, al.plan_x)
    assert a_buf.dtype == getattr(torch, want_dtype)
    assert b_buf is not None and b_buf.dtype == torch.float32
    assert not al._use_panel_aug()


# Train and test RMSE of the split-buffer path (aug_gram="off") as the
# port computed them before the augmented routes existed, at 3 iterations
# of the problem above: the split path must not have moved. Held to 1e-6
# and not to the bit, because the CPU's BLAS may order its f32 sums
# differently from one machine or thread count to another.
SPLIT_RMSE = {
    "f32": [(1.020759522503617, 0.9650770431894712),
            (1.038589341082705, 0.9870517231343414),
            (1.034762102393222, 0.9909567334176637)],
    "bf16": [(1.0207659769932869, 0.9650663600530861),
             (1.038613702379781, 0.9870665030389585),
             (1.034826125809337, 0.9909927308788226)],
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_aug_off_reproduces_the_split_path(problem, dtype):
    _, al, x0, th0 = _runs(problem, dtype, aug_gram="off")
    got = [(h.train_rmse, h.test_rmse) for h in al.run(x0, th0).history]
    assert np.asarray(got) == pytest.approx(np.asarray(SPLIT_RMSE[dtype]),
                                            abs=1e-6)
    if dtype == "bf16":     # "auto" with bf16 accumulators is that path
        _, auto, _, _ = _runs(problem, dtype)
        assert [(h.train_rmse, h.test_rmse)
                for h in auto.run(x0, th0).history] == got


def test_no_free_lane_takes_the_split_path(problem, monkeypatch):
    """F = 128 fills f_pad: "force" cannot apply, and neither aug kernel
    is called."""
    _, al, x0, th0 = _runs(problem, "f32", aug_gram="force", f=128,
                           iters=1)
    assert not al._use_panel_aug() and not cuda_solve.aug_enabled(al.cfg)

    def refuse(*a, **k):
        raise AssertionError("an aug kernel ran without a free lane")

    for name in ("gather_gram_aug_out", "gather_gram_aug_out_plain",
                 "gather_gram_cg_aug_plain", "solve_cg_aug"):
        monkeypatch.setattr(cuda_solve, name, refuse)
    a_buf, b_buf = _accumulators(al, al.plan_x)
    assert b_buf is not None and b_buf.dtype == torch.float32
    hist = al.run(x0, th0).history
    assert np.isfinite(hist[0].train_rmse)


def test_promoted_bf16_accumulators_keep_split_buffers(problem):
    """The gate reads cfg.gram_dtype, not the accumulator dtype: a bf16
    run whose accumulators were promoted to f32 (more than 16 partial
    adds per row) still keeps split (A, b) buffers."""
    _, al, _, _ = _runs(problem, "bf16", panel_size=2)
    assert isinstance(al.plan_x[0], PanelPlan)
    a_buf, b_buf = _accumulators(al, al.plan_x)
    assert a_buf.dtype == torch.float32      # promoted
    assert b_buf is not None and not al._use_panel_aug()


def test_resume_from_a_jax_run_under_the_aug_config(problem,
                                                    interpret_pallas):
    """A JAX run stopped after iteration 1 is carried across with
    interop.from_reference; the port's next iteration is JAX's
    iteration 2."""
    jtrain, jtest, train, test = problem
    kw = dict(FIELDS, m=train.num_rows, n=train.num_cols, **DTYPES["f32"])
    x0, th0 = init_factors(kw["m"], kw["n"], kw["f"], seed=1)
    full = JALS(JConfig(**kw), jtrain, None, jtest).run(x0, th0)
    jcfg = JConfig(**dict(kw, iters=1))
    first = JALS(jcfg, jtrain, None, jtest).run(x0, th0)
    cfg, x1, th1 = interop.from_reference(
        dataclasses.asdict(jcfg.replace(iters=2)), first.x, first.theta,
        device="cpu")
    al = ALS(cfg, train, None, test, device="cpu")
    assert al._use_panel_aug() and al.cfg.aug_gram == "auto"
    assert al.cfg.gram_dtype == "f32"
    rest = al.run(x1, th1, start_iter=1)
    assert [h.iteration for h in rest.history] == [1]
    assert rest.history[0].train_rmse == pytest.approx(
        full.history[1].train_rmse, abs=1e-3)
    assert rest.history[0].test_rmse == pytest.approx(
        full.history[1].test_rmse, abs=1e-3)
