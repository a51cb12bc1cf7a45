"""The port's CLI takes every flag of the JAX package's CLI
(cumf_als_tpu/cli.py): `--plan-cache` is accepted and has no effect yet
(plans are rebuilt each run, as `plan_cache_dir` says), and
`--profile-dir` and `--x-placement` name the ROADMAP items that will
port them, as `--mesh` does."""

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
    tr, te = synthetic_ratings(m=30, n=20, nnz=300, nnz_test=40, seed=2)
    d = str(tmp_path / "ds")
    write_dataset(d, tr, te)
    base = ["30", "20", "16", str(tr.nnz), str(te.nnz), "0.05", "1", "1",
            d, "--device", "cpu", "--iters", "2", "--solver", "cholesky"]
    outs = []
    for extra in ([], ["--plan-cache", "off"],
                  ["--plan-cache", str(tmp_path / "pc")]):
        assert cli.main(base + extra) == 0
        outs.append([line for line in capsys.readouterr().out.splitlines()
                     if "RMSE" in line])
    assert outs[0] and outs[0] == outs[1] == outs[2]
    assert not (tmp_path / "pc").exists()


@pytest.mark.parametrize("flags,item", [
    (["--profile-dir", "/tmp/trace"], "A9"),
    (["--x-placement", "host"], "A12"),
    (["--x-placement", "device"], "A12")])
def test_unported_flags_name_their_roadmap_item(flags, item):
    """They raise before any data is read (the directory does not
    exist)."""
    argv = ["30", "20", "16", "500", "50", "0.05", "1", "1",
            "/nonexistent/ds", "--device", "cpu"] + flags
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)
