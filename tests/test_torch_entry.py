"""The port's entry points and package surface against the JAX
package's: `entry()` against the root __graft_entry__.entry(),
`dryrun_multichip(2, device="cpu")` (two spawned gloo ranks) against the
line the JAX dryrun_multichip(2) prints on the conftest's 8 CPU devices,
the package's exports and presets, and PhaseTimer's report.

Tolerances: entry()'s predictions (O(1)) within atol 3e-3: its 6-step CG
exits a system once rsnew < cg_tol, and 12 of the 256 rows stop one
step apart in the two packages' float32 sums (with cg_tol 0 they agree
to 1e-4); the dry run's squared-error sum within 1e-4 relative and its
RMSEs within 2e-4 (the JAX line prints 4 decimals)."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_entry_matches_jax(monkeypatch):
    import __graft_entry__ as g

    from cumf_als_tpu_torch.entry import entry
    from cumf_als_tpu_torch.ops import cuda_solve
    jfn, jargs = g.entry()
    ref = np.asarray(jfn(*jargs))
    fn, args = entry(device="cpu")
    for a, b in zip(jargs, args, strict=True):
        assert b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the solve goes through K4's wrapper (its plain version here)
    calls = []
    k4 = cuda_solve.solve_cg
    monkeypatch.setattr(cuda_solve, "solve_cg",
                        lambda *a, **k: calls.append(1) or k4(*a, **k))
    got = fn(*args)
    assert len(calls) == 1 and got.shape == ref.shape == (512,)
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-3, rtol=0)


def test_entry_refuses_silent_cpu():
    from cumf_als_tpu_torch.entry import dryrun_multichip, entry
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


def _jax_line(capsys) -> dict:
    import __graft_entry__ as g
    g.dryrun_multichip(2)
    out = capsys.readouterr().out.strip().splitlines()[-1]
    m = re.fullmatch(
        r"dryrun_multichip\(2\): ok, train_se=([\d.]+), sharded\+ooc "
        r"train_rmse=([\d.]+) \((\d+) panels streamed\), device-X "
        r"train_rmse=([\d.]+)", out)
    assert m, out
    return {"train_se": float(m[1]), "ooc_train_rmse": float(m[2]),
            "n_panels": int(m[3]), "device_x_train_rmse": float(m[4])}


def test_dryrun_multichip_matches_jax(capsys):
    from cumf_als_tpu_torch.entry import dryrun_multichip
    ref = _jax_line(capsys)
    got = dryrun_multichip(2, device="cpu")
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): ok, train_se=")
    assert got["n_panels"] == ref["n_panels"] == 2
    assert got["train_se"] == pytest.approx(ref["train_se"], rel=1e-4)
    for k in ("ooc_train_rmse", "device_x_train_rmse"):
        assert got[k] == pytest.approx(ref[k], abs=2e-4)
    assert np.isfinite(got["device_x_test_rmse"])


def test_package_surface_covers_jax():
    """__all__ holds every name of the JAX package's, each resolves, and
    the sharded models import lazily (a bare import of the package loads
    none of parallel/)."""
    import cumf_als_tpu

    import cumf_als_tpu_torch
    assert set(cumf_als_tpu.__all__) <= set(cumf_als_tpu_torch.__all__)
    for name in cumf_als_tpu_torch.__all__:
        assert getattr(cumf_als_tpu_torch, name) is not None
    out = subprocess.run(
        [sys.executable, "-c", "import sys, cumf_als_tpu_torch; print("
         "sorted(m for m in sys.modules if m.startswith("
         "'cumf_als_tpu_torch.parallel.s')))"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("name", ["NETFLIX", "ML10M", "YAHOO", "HUGEWIKI"])
def test_presets_equal_jax(name):
    import cumf_als_tpu.config as jcfg

    import cumf_als_tpu_torch.config as cfg
    assert dataclasses.asdict(getattr(cfg, name)) == \
        dataclasses.asdict(getattr(jcfg, name))


def test_phase_timer_reports_as_jax():
    """The same phases give the same report lines but for the times;
    `sync` takes a device or a tensor."""
    from cumf_als_tpu.utils.timing import PhaseTimer as JTimer

    from cumf_als_tpu_torch.utils.timing import PhaseTimer
    reports = []
    for timer, syncs in ((JTimer(), (None, None, None)),
                         (PhaseTimer(), (None, torch.zeros(2), "cpu"))):
        for name, s in zip(("theta", "x", "x"), syncs):
            with timer.phase(name, sync=s):
                pass
        assert timer.counts == {"theta": 1, "x": 2}
        reports.append(re.sub(r"\d+\.\d{6}", "T", timer.report()))
    assert reports[0] == reports[1] == \
        "theta: T s over 1 calls\nx: T s over 2 calls"
