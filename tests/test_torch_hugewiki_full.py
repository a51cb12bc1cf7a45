"""The port's full-hugewiki driver (cumf_als_tpu_torch/hugewiki_full.py)
against itself and the JAX package's scripts/hugewiki_full.py: the
state-dir flow, one iteration a process, against the single-process
run (the JAX test's contract, tests/test_hugewiki_driver.py: RMSE within
2e-4 at every iteration, and a further invocation is a no-op); a state
directory resumed across the two packages both ways (each package reads
the other's state as its writer meant it: the test RMSE of the factors
it reads within 2e-4 of what the writer recorded); the bf16 host
store's '<V2' file against what np.save writes of the JAX package's
ml_dtypes array; the driver loop; and the entry point's refusals.

The runs are at hugewiki scale 0.00005 (2,504 x 8, 18,029 ratings after
deduplication), F=16, CG 6 steps, on one intra-op thread."""

import importlib.util
import io
import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from cumf_als_tpu_torch import bench as tbench
from cumf_als_tpu_torch import hugewiki_full as hw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--scale", "0.00005", "--f", "16", "--cg-iters", "6", "--device",
        "cpu"]


@pytest.fixture(autouse=True)
def _one_thread_and_cache(tmp_path, monkeypatch):
    """One intra-op thread, and the data and plan caches of both packages
    in one scratch directory (the port's plans go to the JAX script's
    directory, `<root cache>/plans`)."""
    import bench
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(tbench, "CACHE_DIR",
                        str(tmp_path / "cache" / "torch"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _state(sd):
    with open(os.path.join(sd, "state.json")) as fh:
        return json.load(fh)


def _close(history, single, iters):
    assert [h["iter"] for h in history] == list(iters)
    for h in history:
        i = h["iter"]
        assert h["train_rmse"] == pytest.approx(single["train_rmse"][i],
                                                abs=2e-4)
        assert h["test_rmse"] == pytest.approx(single["test_rmse"][i],
                                               abs=2e-4)


def test_state_dir_matches_single_process(tmp_path, capsys):
    """X on the card's placement (here the CPU), cold CG starts on both
    sides: the state dir persists theta alone, so --x-warm-start auto is
    off under it."""
    iters = 2
    assert hw.main(BASE + ["--iters", str(iters), "--x-warm-start",
                           "off"]) == 0
    single = _last_json(capsys)
    assert single["metric"] == "hugewiki_f16_sec_per_iter"
    assert single["n_compiles"] == single["n_compiles_in_loop"] == 0
    assert single["device"] == "cpu" and single["nnz"] == 18029
    sd = str(tmp_path / "state")
    for _ in range(iters):
        assert hw.main(BASE + ["--iters", str(iters), "--state-dir",
                               sd]) == 0
        capsys.readouterr()
    st = _state(sd)
    assert st["next_iter"] == iters
    _close(st["history"], single, range(iters))
    assert sorted(os.listdir(sd)) == ["state.json", "theta.npy"]
    # a further invocation is a no-op that reports the final state
    assert hw.main(BASE + ["--iters", str(iters), "--state-dir", sd]) == 0
    assert _last_json(capsys) == st


def _jax_main():
    spec = importlib.util.spec_from_file_location(
        "hugewiki_full", os.path.join(REPO, "scripts", "hugewiki_full.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _state_test_rmse(x, theta, test) -> float:
    """The test RMSE of the factors a state holds, in float64."""
    pred = np.einsum("ij,ij->i", x[test.row].astype(np.float64),
                     theta[test.col].astype(np.float64))
    return float(np.sqrt(np.mean((test.data - pred) ** 2)))


def test_state_dir_resumes_across_packages(tmp_path, capsys, monkeypatch):
    """X on the host: the port writes iteration 0, the JAX script resumes
    iteration 1 from that directory (its x_host.npy and theta.npy), and
    the port resumes iteration 2 from what the JAX script wrote. Each
    package reads the other's state as its writer meant it: the factors
    that the reader unshards from a state (the JAX model's
    unshard_x_host, the port model's) give the test RMSE its writer
    recorded for that iteration, within 2e-4 (the JSON rounds to 1e-5).

    The iterations themselves are not held to each other across the
    packages: on the CPU the JAX script's "pallas" backend runs its XLA
    route (the bf16 A of the Gram in CG), the port the kernels' plain
    versions (an f32 A), and on 8 columns at F=16 the two trajectories
    part by ~1e-2 within an iteration."""
    from cumf_als_tpu.config import ALSConfig as JConfig
    from cumf_als_tpu.parallel import sharded_ooc as jso
    from cumf_als_tpu.utils import jax_setup

    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.parallel import sharded_ooc as so
    # the JAX set-up of the test run stands (no compile cache in HOME)
    monkeypatch.setattr(jax_setup, "setup_jax", lambda *a, **k: None)
    # the JAX script's CPU route: its gates probe anew, and no kernel a test
    # traced in interpret mode before this one answers a probe from the jit
    # caches (it would pass, and the script would take its Pallas route)
    import jax
    import cumf_als_tpu.ops.pallas_solve as ps
    jax.clear_caches()
    for flag in ("_STATUS", "_AUG_STATUS", "_CG_STATUS",
                 "_PANEL_AUG_STATUS", "_WIDE_STATUS"):
        monkeypatch.setattr(ps, flag, None)
    host = BASE + ["--iters", "3", "--x-placement", "host"]
    sd = str(tmp_path / "state")
    assert hw.main(host + ["--state-dir", sd]) == 0
    x0 = np.load(os.path.join(sd, "x_host.npy"))
    th0 = np.load(os.path.join(sd, "theta.npy"))
    assert x0.dtype == np.dtype("V2") and x0.shape == (1, 2504, 128)
    st0 = _state(sd)["history"][0]
    assert _jax_main()(["--scale", "0.00005", "--f", "16", "--cg-iters",
                        "6", "--iters", "3", "--x-placement", "host",
                        "--state-dir", sd]) == 0
    st1 = _state(sd)["history"][1]
    x1, th1 = hw.load_store(os.path.join(sd, "x_host.npy")), np.load(
        os.path.join(sd, "theta.npy"))
    assert hw.main(host + ["--state-dir", sd]) == 0
    capsys.readouterr()
    st = _state(sd)
    assert st["next_iter"] == 3 and [h["iter"] for h in st["history"]] == \
        [0, 1, 2]
    assert np.isfinite([[h["train_rmse"], h["test_rmse"]]
                        for h in st["history"]]).all()

    train, test = tbench.load_workload("hugewiki", 0.00005)
    kw = dict(m=train.num_rows, n=train.num_cols, f=16, lam=0.048,
              iters=1, factor_dtype="bf16", gram_dtype="bf16",
              host_offload_x=True, chunk_nnz=1 << 22, chunk_rows=1 << 14,
              verbose=False, debug_timing=False)
    # iteration 0's state, written by the port, as the JAX model reads it
    jm = jso.ShardedOutOfCoreALS(JConfig(**kw), train, None, test,
                                 n_devices=1)
    xj = jm.unshard_x_host(x0.view(ml_dtypes.bfloat16))
    assert _state_test_rmse(xj, th0, test) == pytest.approx(
        st0["test_rmse"], abs=2e-4)
    # iteration 1's state, written by the JAX script, as the port reads it
    pm = so.ShardedOutOfCoreALS(ALSConfig(**kw), train, None, test,
                                n_devices=1, device="cpu")
    xp = pm._unshard(x1)
    assert _state_test_rmse(xp, th1, test) == pytest.approx(
        st1["test_rmse"], abs=2e-4)


def test_bf16_store_file_is_the_jax_scripts(tmp_path):
    """save_store writes a bf16 store byte for byte as np.save writes the
    JAX package's ml_dtypes.bfloat16 store ('<V2'); load_store reads it,
    and the JAX script's own file, back bit for bit."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((2, 5, 8)).astype(np.float32)
    jx = x.astype(ml_dtypes.bfloat16)
    t = torch.from_numpy(x).to(torch.bfloat16)
    ref = io.BytesIO()
    np.save(ref, jx)
    path = str(tmp_path / "x_host.npy")
    hw.save_store(path, t)
    with open(path, "rb") as fh:
        assert fh.read() == ref.getvalue()
    jpath = str(tmp_path / "jax.npy")
    np.save(jpath, jx)
    for p in (path, jpath):
        back = hw.load_store(p)
        assert back.dtype == torch.bfloat16 and torch.equal(back, t)
        # the JAX script's read of the file
        np.testing.assert_array_equal(
            np.load(p).view(ml_dtypes.bfloat16).view(np.uint16),
            jx.view(np.uint16))


def test_refusals(tmp_path):
    """--devices N needs a world of N ranks; without --device cpu the
    driver needs a card and raises rather than run on the CPU."""
    with pytest.raises(ValueError, match="world has 1 rank"):
        hw.main(BASE + ["--devices", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            hw.main(["--scale", "0.00005", "--f", "16"])
    assert not os.path.exists(str(tmp_path / "cache"))


def test_driver_script_runs_to_its_end(tmp_path):
    """scripts/torch_hugewiki_full_driver.sh: once every iteration is
    done it starts no process and prints the state."""
    import subprocess
    sd = tmp_path / "state"
    sd.mkdir()
    st = {"next_iter": 2, "history": [{"iter": 0}, {"iter": 1}]}
    (sd / "state.json").write_text(json.dumps(st))
    out = subprocess.run(
        ["bash", os.path.join(REPO, "scripts",
                              "torch_hugewiki_full_driver.sh"), "2",
         "0.00005", str(sd), "--device", "cpu"], capture_output=True,
        text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert "[driver] all 2 iterations done" in out.stdout
    assert json.loads(out.stdout.strip().splitlines()[-1]) == st
