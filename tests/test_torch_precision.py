"""The port's float32 matrix products outside the kernels (`gram_rhs`,
`fused_sq_err`, the plain `solve_cg`, the panel route's `_se_terms` and
the kernels' plain versions in ops/cuda_solve.py) run in full float32 whatever TF32 or bf16 setting the caller chose, as
the JAX package pins Precision.HIGHEST, and leave the caller's setting
as they found it. On the CPU the products themselves cannot show TF32,
so the test reads the setting each `torch.einsum` runs under."""

import numpy as np
import pytest
import torch

from cumf_als_tpu_torch.models import als as als_mod
from cumf_als_tpu_torch.ops import cuda_solve as cs
from cumf_als_tpu_torch.ops import gram, rmse, solve
from cumf_als_tpu_torch.ops.precision import full_f32

CUDA = torch.backends.cuda.matmul
MKLDNN = torch.backends.mkldnn.matmul
NEW_API = hasattr(CUDA, "fp32_precision")


def _setting():
    """Every switch there is, each as read (or "raises": newer PyTorch's
    legacy getters refuse to read a setting made through both APIs)."""
    out = {}
    reads = {"legacy": torch.get_float32_matmul_precision,
             "allow_tf32": lambda: CUDA.allow_tf32}
    if NEW_API:
        reads.update(cuda=lambda: CUDA.fp32_precision,
                     mkldnn=lambda: MKLDNN.fp32_precision)
    for name, read in reads.items():
        try:
            out[name] = read()
        except RuntimeError:
            out[name] = "raises"
    return out


@pytest.fixture()
def caller():
    """The process's setting before the test, put back after it."""
    legacy = torch.get_float32_matmul_precision()
    new = (CUDA.fp32_precision, MKLDNN.fp32_precision) if NEW_API else None
    yield
    torch.set_float32_matmul_precision(legacy)
    if NEW_API:
        CUDA.fp32_precision, MKLDNN.fp32_precision = new


CALLERS = {
    "allow_tf32": lambda: setattr(CUDA, "allow_tf32", True),
    "high": lambda: torch.set_float32_matmul_precision("high"),
    "medium": lambda: torch.set_float32_matmul_precision("medium"),
    "per-backend tf32": lambda: (
        setattr(CUDA, "fp32_precision", "tf32") if NEW_API
        else torch.set_float32_matmul_precision("high")),
}


def _calls():
    rng = np.random.default_rng(0)
    r, p, f, n = 4, 6, 16, 10
    table = torch.from_numpy(rng.standard_normal((n + 1, f)).astype(
        np.float32))
    cols = torch.from_numpy(rng.integers(0, n + 1, (r, p)).astype(np.int32))
    vals = torch.from_numpy(rng.random((r, p)).astype(np.float32))
    nnz = torch.full((r,), p, dtype=torch.int32)
    a, b = gram.gram_rhs(table, cols, vals, nnz, 0.1)
    x0 = torch.zeros((r, f))
    return {
        "gram_rhs": lambda: gram.gram_rhs(table, cols, vals, nnz, 0.1),
        "fused_sq_err": lambda: rmse.fused_sq_err(a, b, vals, nnz, 0.1, x0),
        "solve_cg": lambda: solve.solve_cg(a, b, x0),
        "_se_terms": lambda: als_mod._se_terms(a, b, x0, 2),
    }


@pytest.mark.parametrize("style", sorted(CALLERS))
def test_products_run_in_full_f32_and_restore_the_setting(
        caller, monkeypatch, style):
    seen = []
    einsum = torch.einsum

    def spy(*args, **kw):
        seen.append(_setting())
        return einsum(*args, **kw)

    calls = _calls()
    CALLERS[style]()
    before = _setting()
    assert before["allow_tf32"] in (True, "raises")
    monkeypatch.setattr(torch, "einsum", spy)
    for name, call in calls.items():
        seen.clear()
        call()
        assert seen, name
        for inside in seen:
            assert inside["legacy"] == "highest", name
            assert inside["allow_tf32"] is False, name
            if NEW_API:
                assert inside["cuda"] == inside["mkldnn"] == "ieee", name
        assert _setting() == before, name


def _plain_calls():
    """The kernels' plain versions (ops/cuda_solve.py) on small seeded
    CPU tensors: f = 16 for K1-K6, 256 lanes for K7, K8 and the cut."""
    rng = np.random.default_rng(1)
    r, p, n = 3, 40, 12

    def arr(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))

    t16, t256 = arr(n + 1, 16), arr(n + 1, 256)
    t16[:, 15] = 0.0
    cols = torch.from_numpy(rng.integers(0, n, (r, p)).astype(np.int32))
    vals = arr(r, p)
    nnz = torch.full((r,), p, dtype=torch.int32)
    x16, x256, diag = arr(r, 16), arr(r, 256), arr(r).abs() + 1.0
    a = cs.gather_gram_out_plain(t16, cols, vals)[0]
    a_aug = cs.gather_gram_aug_out_plain(t16, cols, vals)
    g1, g2 = arr(r, p, 128), arr(r, p, 96)
    return {
        "gather_gram_cg_plain": lambda: cs.gather_gram_cg_plain(
            t16, cols, vals, nnz, x16, 0.1),
        "gather_gram_cg_aug_plain": lambda: cs.gather_gram_cg_aug_plain(
            t16, cols, vals, nnz, x16, 0.1),
        "gather_gram_out_plain": lambda: cs.gather_gram_out_plain(
            t16, cols, vals),
        "gather_gram_aug_out_plain": lambda: cs.gather_gram_aug_out_plain(
            t16, cols, vals),
        "solve_cg_reg_plain": lambda: cs.solve_cg_reg_plain(
            a, diag, x16, x16),
        "solve_cg_plain": lambda: cs.solve_cg_plain(a, x16, x16),
        "solve_cg_aug_plain": lambda: cs.solve_cg_aug_plain(a_aug, diag, x16),
        "gather_gram_cg_wide_plain": lambda: cs.gather_gram_cg_wide_plain(
            t256, cols, vals, nnz, x256, 0.1, 96),
        "fused_gram_cg_cat_plain": lambda: cs.fused_gram_cg_cat_plain(
            g1, g2, vals, nnz, x256, 0.1),
        "row_cut_plain": lambda: cs.row_cut_plain(
            t256, cols, vals, nnz, x256, 0.1, 224, 2, 32),
    }


@pytest.mark.parametrize("name", sorted(_plain_calls()))
def test_plain_versions_run_in_full_f32(caller, monkeypatch, name):
    """Every product of a kernel's plain version (the CPU route of the
    wrappers, and the reference the card's kernels are held to) runs in
    full float32 under a caller's TF32 switch, which it gives back."""
    seen = []
    einsum = torch.einsum

    def spy(*args, **kw):
        seen.append(_setting())
        return einsum(*args, **kw)

    call = _plain_calls()[name]
    CALLERS["allow_tf32"]()
    before = _setting()
    monkeypatch.setattr(torch, "einsum", spy)
    call()
    assert seen
    for inside in seen:
        assert inside["legacy"] == "highest"
        assert inside["allow_tf32"] is False
        if NEW_API:
            assert inside["cuda"] == inside["mkldnn"] == "ieee"
    assert _setting() == before


def test_full_f32_restores_on_an_exception(caller):
    torch.set_float32_matmul_precision("medium")
    before = _setting()
    with pytest.raises(ZeroDivisionError):
        with full_f32():
            assert torch.get_float32_matmul_precision() == "highest"
            1 / 0
    assert _setting() == before
