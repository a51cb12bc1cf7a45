"""The port's CLI takes every flag of the JAX package's CLI
(cumf_als_tpu/cli.py): `--plan-cache` caches the plans on disk and
leaves the results as they are, and `--profile-dir` and `--x-placement`
name the ROADMAP items that will port them, as `--mesh` does."""

import os

import pytest

from cumf_als_tpu import cli as jcli

from cumf_als_tpu_torch import cli
from cumf_als_tpu_torch.data.synthetic import synthetic_ratings
from cumf_als_tpu_torch.utils.io import write_dataset


def _options(parser):
    return {o for a in parser._actions for o in a.option_strings}


def test_every_flag_of_the_reference_parses():
    assert _options(jcli.build_parser()) <= _options(cli.build_parser())


@pytest.mark.parametrize("value", [None, "auto", "off", "/some/dir"])
def test_plan_cache_maps_as_in_the_reference(value):
    argv = ["30", "20", "16", "500", "50", "0.05", "1", "1", "/data/ds"]
    if value is not None:
        argv += ["--plan-cache", value]
    got = cli.config_from_args(cli.build_parser().parse_args(argv))
    want = jcli.config_from_args(jcli.build_parser().parse_args(argv))
    assert got.plan_cache_dir == want.plan_cache_dir


def test_plan_cache_has_no_effect(tmp_path, capsys):
    """...on the results: every run prints the same RMSE lines, and the
    cache holds the plans of the runs that name it (the default 'auto'
    puts it in the data set's directory)."""
    tr, te = synthetic_ratings(m=30, n=20, nnz=300, nnz_test=40, seed=2)
    d = str(tmp_path / "ds")
    write_dataset(d, tr, te)
    base = ["30", "20", "16", str(tr.nnz), str(te.nnz), "0.05", "1", "1",
            d, "--device", "cpu", "--iters", "2", "--solver", "cholesky"]
    outs = []
    for extra in ([], ["--plan-cache", "off"],
                  ["--plan-cache", str(tmp_path / "pc")],
                  ["--plan-cache", str(tmp_path / "pc")]):
        assert cli.main(base + extra) == 0
        outs.append([line for line in capsys.readouterr().out.splitlines()
                     if "RMSE" in line])
    assert outs[0] and outs[0] == outs[1] == outs[2] == outs[3]
    kinds = {e.split("-")[0] for e in os.listdir(tmp_path / "pc")}
    assert kinds == {"update"}   # the CLI reads the CSC; both phases direct
    assert os.listdir(tmp_path / "ds" / ".plan_cache")


@pytest.mark.parametrize("flags,item", [
    (["--x-placement", "host"], "A12, sharded out-of-core"),
    (["--x-placement", "device"], "A12, sharded out-of-core"),
    (["--mesh", "2", "--out-of-core"], "A12, sharded out-of-core")])
def test_unported_flags_name_their_roadmap_item(flags, item):
    """They raise before any data is read (the directory does not
    exist)."""
    argv = ["30", "20", "16", "500", "50", "0.05", "1", "1",
            "/nonexistent/ds", "--device", "cpu"] + flags
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


def test_profile_dir_traces_the_run(tmp_path, capsys):
    """--profile-dir (once refused as unported) traces the run into the
    directory; tests/test_torch_dumps.py reads the trace."""
    d = str(tmp_path / "ds")
    tr, te = synthetic_ratings(m=30, n=20, nnz=300, nnz_test=40, seed=1)
    write_dataset(d, tr, te)
    argv = ["30", "20", "16", str(tr.nnz), str(te.nnz), "0.05", "1", "1",
            d, "--device", "cpu", "--iters", "1", "--solver", "cholesky",
            "--profile-dir", str(tmp_path / "trace")]
    assert cli.main(argv) == 0
    assert "ALS Done." in capsys.readouterr().out
    assert os.listdir(tmp_path / "trace")
