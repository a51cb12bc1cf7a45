"""Package-level rules of the port: it imports no JAX, its entry points
default to CUDA and refuse to fall back to the CPU, state carries across
from and to the JAX package, and the CLI runs end to end."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cumf_als_tpu.config import ALSConfig as JConfig
from cumf_als_tpu.models.als import ALS as JALS
from cumf_als_tpu.utils import checkpoint as jckpt

from cumf_als_tpu_torch import ALS, ALSConfig, CSRMatrix, do_als
from cumf_als_tpu_torch import cli
from cumf_als_tpu_torch.data.synthetic import init_factors, synthetic_ratings
from cumf_als_tpu_torch.interop import from_reference, to_reference
from cumf_als_tpu_torch.utils.io import write_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import sys
import cumf_als_tpu_torch as pkg
from cumf_als_tpu_torch.data.synthetic import init_factors, synthetic_ratings
import cumf_als_tpu_torch.cli, cumf_als_tpu_torch.interop
import cumf_als_tpu_torch.ops.cuda_solve, cumf_als_tpu_torch.ops._build
import cumf_als_tpu_torch.bench, cumf_als_tpu_torch.data.prepare
import cumf_als_tpu_torch.native, cumf_als_tpu_torch.utils.plan_cache
import cumf_als_tpu_torch.models.out_of_core
import cumf_als_tpu_torch.parallel.plan, cumf_als_tpu_torch.parallel.mesh
import cumf_als_tpu_torch.parallel.sharded_als
import cumf_als_tpu_torch.parallel.sharded_ooc
import cumf_als_tpu_torch.utils.stream_cache
import cumf_als_tpu_torch.hugewiki_full
import cumf_als_tpu_torch.integrations.tf_op
from cumf_als_tpu_torch.entry import entry
from cumf_als_tpu_torch.integrations.torch_op import TorchMF, do_als
from cumf_als_tpu_torch.models.factory import make_model
tr, te = synthetic_ratings(m=30, n=20, nnz=300, nnz_test=40, seed=1)
cfg = pkg.ALSConfig(m=30, n=20, f=16, iters=2, verbose=False,
                    debug_timing=False, backend="pallas")
x0, th0 = init_factors(30, 20, 16)
res = pkg.do_als(tr, None, te, th0, x0, cfg, device="cpu")
assert len(res.history) == 2
ooc = make_model(cfg.replace(host_offload_x=True, panel_size=8), tr, None,
                 te, device="cpu")
assert len(ooc.run(x0, th0).history) == 2
sharded = make_model(cfg.replace(mesh_shape=(1,)), tr, None, te,
                     device="cpu")
assert len(sharded.run(x0, th0).history) == 2
for place in ("host", "device"):
    sooc = make_model(cfg.replace(mesh_shape=(1,), host_offload_x=True,
                                  x_placement=place, panel_size=8), tr,
                      None, te, device="cpu")
    assert len(sooc.run(x0, th0).history) == 2
import torch
thetat, xt, rmse = do_als(torch.from_numpy(tr.indptr.astype("int64")),
                          torch.from_numpy(tr.indices),
                          torch.from_numpy(tr.data), torch.from_numpy(te.row),
                          torch.from_numpy(te.col), torch.from_numpy(te.data),
                          30, 20, 16, 0.05, iters=1, device="cpu")
assert TorchMF(xt, thetat).predict(torch.from_numpy(te.row),
                                   torch.from_numpy(te.col)).shape == (te.nnz,)
fn, args = entry(device="cpu")
assert fn(*args).shape == (512,)
assert pkg.ShardedALS and pkg.ShardedOutOfCoreALS and pkg.HUGEWIKI
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "cumf_als_tpu" or m.startswith("cumf_als_tpu."))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


SPAWN = r"""
from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors, synthetic_ratings
from cumf_als_tpu_torch.parallel.mesh import spawn
from cumf_als_tpu_torch.parallel.sharded_als import run_rank
tr, te = synthetic_ratings(m=30, n=20, nnz=300, nnz_test=40, seed=1)
cfg = ALSConfig(m=30, n=20, f=16, iters=2, verbose=False,
                debug_timing=False, backend="pallas")
x0, th0 = init_factors(30, 20, 16)
ranks = spawn(2, run_rank, cfg, (tr, te), x0, th0, 8, device="cpu",
              timeout=120)
assert ranks[0]["theta_sha256"] == ranks[1]["theta_sha256"]
print("RANKS OK")
"""


def test_spawned_ranks_import_no_jax(tmp_path):
    """Two spawned ranks of ShardedALS (parallel.mesh.spawn, run_rank)
    with jax and the JAX package blocked from import in the parent and
    in the ranks: packages of those names that raise first on the path."""
    for name in ("jax", "cumf_als_tpu"):
        os.makedirs(tmp_path / name)
        (tmp_path / name / "__init__.py").write_text(
            f"raise ImportError('{name} is blocked')\n")
    out = subprocess.run([sys.executable, "-c", SPAWN], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ,
                                  PYTHONPATH=f"{tmp_path}:{REPO}"))
    assert out.returncode == 0, out.stderr
    assert "RANKS OK" in out.stdout


def _problem():
    return synthetic_ratings(m=30, n=20, nnz=300, nnz_test=40, seed=1)


def test_entry_points_refuse_silent_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    tr, te = _problem()
    cfg = ALSConfig(m=30, n=20, f=16, iters=1, verbose=False)
    x0, th0 = init_factors(30, 20, 16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ALS(cfg, tr, None, te)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        do_als(tr, None, te, th0, x0, cfg)


def _jax_checkpoint(tmp_path):
    """A JAX run that checkpoints after iteration 0 (f=100, so the
    factors carry across f_pad=128 padding)."""
    from cumf_als_tpu.data.synthetic import synthetic_ratings as jsyn
    jtr, jte = jsyn(m=30, n=20, nnz=300, nnz_test=40, seed=1)
    jcfg = JConfig(m=30, n=20, f=100, lam=0.5, iters=1, verbose=False,
                   debug_timing=False, solver="cholesky",
                   checkpoint_dir=str(tmp_path), checkpoint_every=1)
    x0, th0 = init_factors(30, 20, 100, seed=2)
    JALS(jcfg, jtr, None, jte).run(x0, th0)
    x, th, it = jckpt.load_checkpoint(str(tmp_path), cfg=jcfg)
    return jcfg, jtr, jte, x, th, it


def test_interop_round_trip(tmp_path):
    import dataclasses
    jcfg, jtr, jte, x, th, it = _jax_checkpoint(tmp_path)
    fields = dataclasses.asdict(jcfg)
    cfg, xt, tt = from_reference(fields, x, th, device="cpu")
    assert xt.shape == (30, 128) and tt.shape == (20, 128)
    assert torch.all(xt[:, 100:] == 0)
    fields2, x2, th2 = to_reference(cfg, xt, tt)
    assert fields2 == fields
    np.testing.assert_array_equal(x2, x)
    np.testing.assert_array_equal(th2, th)
    assert JConfig(**fields2) == jcfg
    # padded input carries across unchanged as well
    _, xt2, _ = from_reference(fields, xt.numpy(), tt.numpy(), device="cpu")
    assert torch.equal(xt2, xt)
    with pytest.raises(ValueError):
        from_reference(dict(fields, tpu_only_knob=1), x, th, device="cpu")
    if not torch.cuda.is_available():
        # like every entry point, the default device is CUDA: no silent CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            from_reference(fields, x, th)


@pytest.mark.parametrize("f,f_pad", [(130, 256), (200, 256), (256, 256)])
def test_interop_pads_wide_factors(f, f_pad):
    """F > 128 pads to 256 lanes both ways, as in the JAX package."""
    import dataclasses
    jcfg = JConfig(m=30, n=20, f=f, wide_kernel="on", backend="pallas")
    assert jcfg.f_pad == f_pad
    x0, th0 = init_factors(30, 20, f, seed=3)
    cfg, xt, tt = from_reference(dataclasses.asdict(jcfg), x0, th0,
                                 device="cpu")
    assert cfg.f_pad == f_pad and cfg.wide_kernel == "on"
    assert xt.shape == (30, f_pad) and tt.shape == (20, f_pad)
    assert torch.all(xt[:, f:] == 0) and torch.all(tt[:, f:] == 0)
    fields, x2, th2 = to_reference(cfg, xt, tt)
    assert JConfig(**fields) == jcfg
    np.testing.assert_array_equal(x2, x0)
    np.testing.assert_array_equal(th2, th0)
    with pytest.raises(ValueError):     # neither F nor f_pad wide
        from_reference(fields, x0[:, :128], th0, device="cpu")


def test_resume_from_jax_checkpoint_matches_jax(tmp_path):
    """A port run resumed from a JAX checkpoint takes the same next step
    as the JAX run resumed from it."""
    import dataclasses
    jcfg, jtr, jte, x, th, it = _jax_checkpoint(tmp_path)
    jcfg = jcfg.replace(iters=2, checkpoint_every=0)
    jres = JALS(jcfg, jtr, None, jte).run(x, th, start_iter=it + 1)
    cfg, xt, tt = from_reference(dataclasses.asdict(jcfg), x, th,
                                 device="cpu")
    tr = CSRMatrix(indptr=jtr.indptr, indices=jtr.indices, data=jtr.data,
                   num_rows=30, num_cols=20)
    res = ALS(cfg, tr, None, jte, device="cpu").run(xt, tt,
                                                    start_iter=it + 1)
    assert res.history[-1].iteration == jres.history[-1].iteration == 1
    assert res.history[-1].test_rmse == pytest.approx(
        jres.history[-1].test_rmse, abs=1e-4)
    np.testing.assert_allclose(res.theta, jres.theta, atol=1e-3)


def _dataset(tmp_path):
    tr, te = _problem()
    d = str(tmp_path / "ds")
    write_dataset(d, tr, te)
    return d, tr, te


def test_cli_runs_on_cpu(tmp_path, capsys):
    d, tr, te = _dataset(tmp_path)
    argv = ["30", "20", "16", str(tr.nnz), str(te.nnz), "0.05", "1", "1",
            d, "--iters", "2", "--device", "cpu", "--backend", "pallas",
            "--factor-dtype", "bf16", "--gram-dtype", "bf16"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "--------- Train RMSE in iter 1:" in out
    assert "--------- Test RMSE in iter 1:" in out
    assert "ALS Done." in out


def test_cli_usage_and_unported_models(tmp_path, capsys):
    assert cli.main([]) == 0
    assert "Usage: give M, N, F" in capsys.readouterr().out
    d, tr, te = _dataset(tmp_path)
    base = ["30", "20", "16", str(tr.nnz), str(te.nnz), "0.05", "1", "1",
            d, "--device", "cpu", "--iters", "1"]
    # --mesh N needs a world of N ranks (torchrun), with --out-of-core too
    for flags in (["--mesh=2", "--out-of-core"], ["--mesh=2"]):
        with pytest.raises(ValueError, match="world has 1 rank"):
            cli.main(base + flags)
    capsys.readouterr()
    # out-of-core, sharded and sharded out-of-core training run
    assert cli.main(base + ["--out-of-core"]) == 0
    assert "*******out-of-core:" in capsys.readouterr().out
    assert cli.main(base + ["--mesh=1"]) == 0
    assert "*******mesh: 1 devices over axis 'data'." in \
        capsys.readouterr().out
    assert cli.main(base + ["--mesh=1", "--out-of-core"]) == 0
    assert "*******mesh: 1 devices; X host-resident" in \
        capsys.readouterr().out


def test_cli_resume_from_checkpoint(tmp_path, capsys):
    d, tr, te = _dataset(tmp_path)
    ck = str(tmp_path / "ck")
    base = ["30", "20", "16", str(tr.nnz), str(te.nnz), "0.05", "1", "1",
            d, "--device", "cpu", "--solver", "cholesky",
            "--checkpoint-dir", ck, "--checkpoint-every", "1"]
    assert cli.main(base + ["--iters", "2"]) == 0
    capsys.readouterr()
    assert cli.main(base + ["--iters", "3", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resuming from checkpoint at iteration 1" in out
    assert "Train RMSE in iter 2" in out and "iter 1:" not in out


def test_every_included_header_rebuilds_its_kernels():
    """An edited header must rebuild on the card: every `#include "..."`
    of csrc/ names a header of _build.HEADERS (the names `_stale` looks
    at), every header there exists, and every kernel has its source."""
    import re
    from cumf_als_tpu_torch.ops import _build
    sources = sorted(f for f in os.listdir(_build.CSRC)
                     if f.endswith((".cu", ".cuh")))
    assert sources
    included = set()
    for name in sources:
        with open(os.path.join(_build.CSRC, name)) as fh:
            included |= set(re.findall(r'#include\s+"([^"]+)"', fh.read()))
    assert included and included <= set(_build.HEADERS)
    assert "gram_mma.cuh" in included
    for name in _build.HEADERS:
        assert os.path.exists(os.path.join(_build.CSRC, name))
    for name in _build.KERNELS:
        assert os.path.exists(os.path.join(_build.CSRC, f"{name}.cu"))
    assert {f[:-3] for f in sources if f.endswith(".cu")} == \
        set(_build.KERNELS)


@pytest.mark.parametrize("dtype,f,body", [
    (torch.bfloat16, 128, "wgmma"), (torch.float32, 128, "fma"),
    (torch.bfloat16, 112, "fma"), (torch.bfloat16, 16, "fma"),
    (torch.float32, 64, "fma"), (torch.bfloat16, 256, "wgmma"),
    (torch.float32, 256, "fma")])
def test_gram_body_goes_by_dtype_and_width_alone(dtype, f, body):
    """The tensor-core Gram body (K1, K2, K5a, K6; K1 at f = 256 and K7
    through pass 1 of the row cut) takes a bf16 table at f = 128 or 256;
    every other table these kernels take keeps an FMA body."""
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    assert cs.gram_body(torch.zeros((3, f), dtype=dtype)) == body


@pytest.mark.parametrize("case", ["aligned", "offset", "too many slots",
                                  "float32"])
def test_tensor_core_body_checks_what_its_copies_need(case):
    """The wrappers' check before a launch on the tensor-core body: its
    16-byte copies need table rows on 16-byte boundaries, and it counts
    a chunk's slots in 32 bits. A float32 table (the FMA body) is not
    held to either."""
    from cumf_als_tpu_torch.ops import cuda_solve as cs
    flat = torch.zeros(9 * 128 + 1, dtype=torch.bfloat16)
    table = flat[:-1].view(9, 128)
    cols = torch.zeros((4, 8), dtype=torch.int32)
    if case == "offset":
        table = flat[1:].view(9, 128)        # 2 bytes past a boundary
    many = torch.zeros((1, 1), dtype=torch.int32).expand(2 ** 16, 2 ** 15)
    if case == "too many slots":
        cols = many
    elif case == "float32":
        table, cols = torch.zeros(9 * 128 + 1)[1:].view(9, 128), many
    if case in ("aligned", "float32"):
        cs._check_gram_table(table, cols)
    else:
        with pytest.raises(ValueError):
            cs._check_gram_table(table, cols)


from cumf_als_tpu_torch.ops import _build  # noqa: E402


@pytest.mark.parametrize("name", sorted(_build.KERNELS))
def test_c_entry_point_takes_what_ctypes_passes(name):
    """The argument list of each kernel's `extern "C"` entry point in
    csrc/ against the ctypes argument types of `_build.KERNELS`: ctypes
    checks neither the count nor the kinds, so a mismatch would pass
    garbage to the kernel."""
    import ctypes
    import re
    symbol, argtypes = _build.KERNELS[name]
    with open(os.path.join(_build.CSRC, f"{name}.cu")) as fh:
        src = fh.read()
    found = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert found, f"{symbol} not declared in {name}.cu"
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in arg else kinds[arg.split()[0]]
            for arg in found.group(1).split(",")]
    assert want == argtypes


@pytest.mark.parametrize("name", sorted(_build.QUERIES))
def test_c_query_takes_what_ctypes_passes(name):
    """The same check for each query `_build.QUERIES` loads from a
    kernel's library (an occupancy query beside the kernel)."""
    import ctypes
    import re
    lib, symbol, argtypes = _build.QUERIES[name]
    assert lib in _build.KERNELS
    with open(os.path.join(_build.CSRC, f"{lib}.cu")) as fh:
        src = fh.read()
    found = re.search(r'extern "C" int ' + symbol + r"\(([^)]*)\)", src)
    assert found, f"{symbol} not declared in {lib}.cu"
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    want = [ctypes.c_void_p if "*" in arg else kinds[arg.split()[0]]
            for arg in found.group(1).split(",")]
    assert want == argtypes
