"""The port's bench (`python -m cumf_als_tpu_torch.bench`) against the
root bench.py: the same flags, tables and output keys, a cache the root
bench reads, and a result equal to a direct ALS run of the port."""

import ast
import importlib.util
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from cumf_als_tpu_torch import bench
from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.data.synthetic import init_factors
from cumf_als_tpu_torch.models.als import ALS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_BENCH = os.path.join(REPO, "bench.py")
ARGS = ["--device", "cpu", "--workload", "ml10m", "--scale", "0.005",
        "--iters", "3"]
TIMINGS = {"value", "vs_baseline", "ns_per_nnz", "total_seconds",
           "gram_gflops", "spread_min", "spread_max"}


def _root_bench():
    spec = importlib.util.spec_from_file_location("root_bench", ROOT_BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _root_out_keys():
    """The keys of the root bench's JSON line: those of its `out = {...}`
    literal, and those it adds with `out[...] = ...` (the repeat and
    accuracy keys)."""
    tree = ast.parse(open(ROOT_BENCH).read())
    base, added = [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and tgt.id == "out" and \
                    isinstance(node.value, ast.Dict):
                base = [k.value for k in node.value.keys]
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Name) and tgt.value.id == "out":
                added.add(tgt.slice.value)
    assert base and added
    return base, added


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    monkeypatch.setattr(bench, "CACHE_DIR", str(tmp_path / "cache"))
    return tmp_path / "cache"


def test_line_keys_and_result_match_a_direct_run(cache, capsys):
    base, _ = _root_out_keys()
    assert bench.main(ARGS) == 0
    line = _line(capsys)
    assert list(line) == base
    assert line["device"] == "cpu" and line["unit"] == "s/iter"
    assert line["metric"] == "ml10m_f100_sec_per_iter"
    assert np.isfinite(line["value"]) and line["value"] > 0
    # a direct ALS run of the port on the same data and configuration
    train, test = bench.load_workload("ml10m", 0.005)
    cfg = ALSConfig(m=train.num_rows, n=train.num_cols, f=100,
                    nnz=train.nnz, nnz_test=test.nnz, lam=0.05, iters=3,
                    factor_dtype="bf16", gram_dtype="bf16",
                    backend="pallas", train_rmse_method="fused",
                    verbose=False, debug_timing=False)
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=cfg.seed)
    res = ALS(cfg, train, None, test, device="cpu").run(x0, th0)
    assert line["train_rmse_final"] == round(res.history[-1].train_rmse, 5)
    assert line["test_rmse_final"] == round(res.history[-1].test_rmse, 5)
    assert line["baseline_sec_per_iter"] == round(
        bench.baseline_sec_per_iter(train.nnz), 4)


def test_second_run_reads_the_cache(cache, capsys):
    assert bench.main(ARGS + ["--repeat", "2"]) == 0
    first = _line(capsys)
    (tag,) = os.listdir(cache)
    stamp = os.path.getmtime(cache / tag / "indices.npy")
    assert bench.main(ARGS + ["--repeat", "2"]) == 0
    captured = capsys.readouterr()
    assert "loading cached dataset" in captured.err
    second = json.loads(captured.out.strip().splitlines()[-1])
    assert os.path.getmtime(cache / tag / "indices.npy") == stamp
    assert set(first) == set(second)
    assert {k: v for k, v in first.items() if k not in TIMINGS} == \
        {k: v for k, v in second.items() if k not in TIMINGS}
    assert second["repeats"] == 2
    assert second["spread_min"] <= second["value"] <= second["spread_max"]


def test_root_bench_reads_the_cache(cache):
    from cumf_als_tpu_torch.data.synthetic import workload_ratings
    train, test = bench.load_workload("ml10m", 0.005)
    assert not train.indices.flags.writeable      # memory-mapped
    rtrain, rtest = _root_bench()._load_dataset_dir(
        bench.dataset_dir("ml10m", 0.005))
    gtrain, gtest = workload_ratings("ml10m", scale=0.005, seed=0)
    for a, b, c in ((rtrain.indptr, train.indptr, gtrain.indptr),
                    (rtrain.indices, train.indices, gtrain.indices),
                    (rtrain.data, train.data, gtrain.data),
                    (rtest.row, test.row, gtest.row),
                    (rtest.col, test.col, gtest.col),
                    (rtest.data, test.data, gtest.data)):
        assert a.dtype == b.dtype == c.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert (rtrain.num_rows, rtrain.num_cols) == \
        (train.num_rows, train.num_cols)
    with open(os.path.join(bench.dataset_dir("ml10m", 0.005),
                           "meta.json")) as fh:
        assert json.load(fh)["crc32"] == bench.dataset_crc32(gtrain, gtest)


def test_stale_cache_is_regenerated(cache, monkeypatch):
    """A cache written from another table entry is generated anew."""
    from cumf_als_tpu_torch.data import synthetic
    train, _ = bench.load_workload("ml10m", 0.005)
    shapes = dict(synthetic.WORKLOAD_SHAPES)
    shapes["ml10m"] = dict(shapes["ml10m"], nnz=shapes["ml10m"]["nnz"] // 2)
    monkeypatch.setattr(synthetic, "WORKLOAD_SHAPES", shapes)
    fresh, _ = bench.load_workload("ml10m", 0.005)
    assert fresh.nnz < train.nnz
    with open(os.path.join(bench.dataset_dir("ml10m", 0.005),
                           "meta.json")) as fh:
        assert json.load(fh)["entry"]["shape"]["nnz"] == \
            shapes["ml10m"]["nnz"]


def test_a_cache_of_the_other_generator_is_regenerated(cache, capsys):
    """meta.json names the generator, so a cache the numpy path wrote of
    a workload the native generator now makes (Netflix) is made again.
    Here a small ml10m cache is marked as the native generator's."""
    from cumf_als_tpu_torch import native
    want = "native" if native.available() else "numpy"
    assert bench._workload_entry("netflix", 1.0, 0)["generator"] == want
    bench.load_workload("ml10m", 0.005)
    path = os.path.join(bench.dataset_dir("ml10m", 0.005), "meta.json")
    with open(path) as fh:
        meta = json.load(fh)
    assert meta["entry"]["generator"] == "numpy"   # under 2^26 ratings
    meta["entry"]["generator"] = "native"
    with open(path, "w") as fh:
        json.dump(meta, fh)
    capsys.readouterr()
    bench.load_workload("ml10m", 0.005)
    assert "generated from another workload entry" in capsys.readouterr().err
    with open(path) as fh:
        assert json.load(fh)["entry"]["generator"] == "numpy"


def test_damaged_cache_raises(cache):
    """A member that no longer matches its CRC-32 is an error, not data."""
    bench.load_workload("ml10m", 0.005)
    path = os.path.join(bench.dataset_dir("ml10m", 0.005), "data.npy")
    arr = np.load(path)
    arr[0] += 1.0
    np.save(path, arr)
    with pytest.raises(RuntimeError, match="does not match its meta.json"):
        bench.load_workload("ml10m", 0.005)


def test_accuracy_check_keys(cache, capsys):
    base, added = _root_out_keys()
    assert bench.main(ARGS[:3] + ["ml10m_cal", "--scale", "0.005",
                                  "--iters", "3", "--repeat", "2",
                                  "--accuracy-check"]) == 0
    line = _line(capsys)
    assert set(line) == set(base) | added
    assert line["accuracy_check"] in ("pass", "fail")
    assert line["accuracy_contract"]["workload"] == "ml10m_cal"
    assert line["accuracy_contract"]["band"] == [0.78, 0.87]


def test_root_help_options_parse():
    """Every option the root bench's --help prints parses in the port's
    parser, each choice of it too. The root exits in parse_args, before
    it imports JAX."""
    out = subprocess.run([sys.executable, ROOT_BENCH, "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    found = re.findall(r"(--[a-z][a-z0-9-]*)(?: (\{[^}]*\}|[A-Z_]+))?",
                       out.stdout)
    options = {}
    for opt, arg in found:
        options.setdefault(opt, set()).add(arg)
    assert len(options) >= 25, options
    assert options["--workload"] == {"{" + ",".join(bench.WORKLOADS) + "}"}
    parser = bench.build_parser()
    for opt, args in options.items():
        if opt == "--help":
            continue
        values = set()
        for arg in args - {""}:
            values |= set(arg[1:-1].split(",")) if arg.startswith("{") \
                else {"2" if opt in ("--mesh", "--panel-size") else "1"}
        if opt == "--platform":
            values = {"cpu"}
        for value in values or {None}:
            argv = [opt] if value is None else [opt, value]
            parser.parse_args(argv)


def test_tables_match_root():
    root = _root_bench()
    assert bench.ACCURACY_CONTRACTS == root.ACCURACY_CONTRACTS
    assert bench.BASELINE_NS_PER_NNZ == root.BASELINE_NS_PER_NNZ
    for nnz in (1, 99_072_112, 3_101_144_313):
        assert bench.baseline_sec_per_iter(nnz) == \
            root.baseline_sec_per_iter(nnz)
    lam = re.search(r"lam = (\{[^}]*\})\[args\.workload\]",
                    open(ROOT_BENCH).read())
    assert bench.LAMBDA == ast.literal_eval(lam.group(1))


@pytest.mark.parametrize("extra,err,match", [
    # --mesh N, with --out-of-core too, runs N ranks under torchrun; here
    # the world has one
    (["--out-of-core", "--mesh", "2"], ValueError, "world has 1 rank"),
    (["--mesh", "2"], ValueError, "world has 1 rank"),
    (["--platform", "tpu"], ValueError, "cpu")])
def test_unported_options_raise(cache, extra, err, match):
    with pytest.raises(err, match=match):
        bench.main(ARGS + extra)
    assert not os.path.exists(cache)


def test_mesh_runs_the_sharded_model(cache, capsys):
    """--mesh 1 in one process: ShardedALS on a world of one rank, the
    root bench's keys, the sharded plans' log line."""
    base, _ = _root_out_keys()
    assert bench.main(ARGS + ["--mesh", "1", "--iters", "1"]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == base and np.isfinite(line["train_rmse_final"])
    assert "[bench] sharded plans built in" in out.err
    assert "reduce blocks, 1 devices)" in out.err


def test_mesh_out_of_core_runs_the_sharded_ooc_model(cache, capsys):
    """--mesh 1 --out-of-core in one process: ShardedOutOfCoreALS on a
    world of one rank, the root bench's keys and its log line."""
    base, _ = _root_out_keys()
    assert bench.main(ARGS + ["--mesh", "1", "--out-of-core", "--iters",
                              "1"]) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert list(line) == base and np.isfinite(line["train_rmse_final"])
    assert "[bench] sharded+OOC plans built in" in out.err
    assert "local X panels x 1 devices)" in out.err


def test_accuracy_check_needs_three_iterations(cache, capsys):
    with pytest.raises(SystemExit):
        bench.main(["--device", "cpu", "--workload", "ml10m_cal",
                    "--accuracy-check", "--iters", "2"])
    assert "--iters >= 3" in capsys.readouterr().err
    assert not os.path.exists(cache)


def test_runs_on_the_card_unless_told(cache):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(ARGS[2:])
    assert not os.path.exists(cache)


def test_platform_cpu_means_device_cpu(cache, capsys):
    assert bench.main(ARGS[2:] + ["--platform", "cpu"]) == 0
    assert _line(capsys)["device"] == "cpu"
