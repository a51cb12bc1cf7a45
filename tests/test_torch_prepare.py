"""The port's data preparation against the JAX package's: the same text
triplets or the same --synthetic arguments give the same files, byte for
byte."""

import os

import numpy as np
import pytest

import cumf_als_tpu.native as jnative
from cumf_als_tpu.data import prepare as jprep

from cumf_als_tpu_torch.data import prepare as prep

FILES = ("R_train_csr.data.bin", "R_train_csr.indptr.bin",
         "R_train_csr.indices.bin", "R_train_csc.data.bin",
         "R_train_csc.indptr.bin", "R_train_csc.indices.bin",
         "R_train_coo.row.bin", "R_test_coo.data.bin", "R_test_coo.row.bin",
         "R_test_coo.col.bin")


@pytest.fixture(params=["numpy", "native"])
def dataplane(request, monkeypatch):
    """The JAX package's host paths with and without its native
    dataplane (where that library is built)."""
    if request.param == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
    elif not jnative.available():
        pytest.skip("the JAX package's native dataplane is not built")
    return request.param


def _same_files(a, b):
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == sorted(FILES)
    for name in FILES:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


def _triplets(path, n_lines=400, seed=1, sep="::"):
    rng = np.random.RandomState(seed)
    lines = [f"{rng.randint(1, 40)}{sep}{rng.randint(1, 30)}{sep}"
             f"{rng.randint(1, 11) / 2}{sep}{rng.randint(10 ** 8)}"
             for _ in range(n_lines)]
    path.write_text("\n".join(lines) + "\n\n")
    return str(path)


@pytest.mark.parametrize("sep", ["::", ",", " "])
def test_text_input_files_match_jax(tmp_path, dataplane, sep, capsys):
    src = _triplets(tmp_path / "r.dat", sep=sep)
    args = ["--input", src, "--sep", sep, "--test-size", "37",
            "--m", "45", "--n", "31"]
    assert jprep.main(args + ["--out", str(tmp_path / "jax")]) == 0
    jout = capsys.readouterr().out
    assert prep.main(args + ["--out", str(tmp_path / "port")]) == 0
    out = capsys.readouterr().out
    _same_files(tmp_path / "jax", tmp_path / "port")
    # the summary line is the same; the CLI hint names the port's CLI
    assert out.splitlines()[0].replace("port", "jax") == \
        jout.splitlines()[0]
    assert "python -m cumf_als_tpu_torch.cli 45 31 100" in out


@pytest.mark.parametrize("name,scale", [("ml10m", 0.002),
                                        ("netflix", 0.0005),
                                        ("yahoo", 0.0001)])
def test_synthetic_files_match_jax(tmp_path, dataplane, name, scale):
    args = ["--synthetic", name, "--scale", str(scale), "--seed", "5"]
    assert jprep.main(args + ["--out", str(tmp_path / "jax")]) == 0
    assert prep.main(args + ["--out", str(tmp_path / "port")]) == 0
    _same_files(tmp_path / "jax", tmp_path / "port")


def test_load_triplets_and_split_match_jax(tmp_path):
    src = _triplets(tmp_path / "r.dat", n_lines=200, seed=3)
    got, want = prep.load_triplets(src), jprep.load_triplets(src)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    tr, te = prep.prepare(*got, test_size=20, seed=7)
    jtr, jte = jprep.prepare(*want, test_size=20, seed=7)
    for x, y in ((tr.indptr, jtr.indptr), (tr.indices, jtr.indices),
                 (tr.data, jtr.data), (te.row, jte.row), (te.col, jte.col),
                 (te.data, jte.data)):
        np.testing.assert_array_equal(x, y)
    assert (tr.num_rows, tr.num_cols) == (jtr.num_rows, jtr.num_cols)


def test_needs_an_input(tmp_path):
    with pytest.raises(SystemExit):
        prep.main(["--out", str(tmp_path / "ds")])
