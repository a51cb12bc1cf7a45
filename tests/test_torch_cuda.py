"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Marked `cuda`; without a card they skip. This file imports no JAX
(the machine with the card has none), so run it there without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py: rtol 1e-5 for an f32 A
and for b, one bf16 ulp for a bf16 A, 2e-3 absolute for x and se at
CG-6."""

import numpy as np
import pytest
import torch

from cumf_als_tpu_torch.ops import cuda_solve as cs

pytestmark = pytest.mark.cuda

R, P, N, LAM = 16, 48, 50, 0.05


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    cs.reset_launch_counts()
    return torch.device("cuda")


def _chunk(f, seed=0):
    rng = np.random.RandomState(seed)
    table = (rng.standard_normal((N + 1, f)) * 0.3).astype(np.float32)
    table[N] = 0.0
    nnz = rng.randint(1, P + 1, (R,)).astype(np.int32)
    nnz[3] = 0
    mask = np.arange(P)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, N, (R, P)), N).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (R, P)) * 2) / 2 * mask
            ).astype(np.float32)
    x0 = (rng.standard_normal((R, f)) * 0.1).astype(np.float32)
    return [torch.from_numpy(a) for a in (table, cols, vals, nnz, x0)]


def _within_bf16_ulp(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    big = torch.maximum(a.abs(), b.abs()).clamp_min(1e-30)
    return bool(((a - b).abs() <= torch.exp2(torch.floor(torch.log2(big))
                                             - 7)).all())


@pytest.mark.parametrize("f", [16, 48, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain(card, f, dtype):
    cpu = _chunk(f)
    cpu[0] = cpu[0].to(dtype)
    cpu[2] = cpu[2].to(dtype)
    gpu = [t.to(card) for t in cpu]
    x, se = cs.gather_gram_cg(*gpu, LAM)
    px, pse = cs.gather_gram_cg(*cpu, LAM)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), pse, atol=2e-3, rtol=1e-4)
    assert torch.all(x[3] == 0)
    a, b = cs.gather_gram_out(*gpu[:3], out_dtype=dtype)
    pa, pb = cs.gather_gram_out(*cpu[:3], out_dtype=dtype)
    assert a.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(a.cpu(), pa, rtol=1e-5, atol=1e-5)
    else:
        assert _within_bf16_ulp(a, pa)
    torch.testing.assert_close(b.cpu(), pb, rtol=1e-5, atol=1e-5)
    diag = cpu[3].float() * LAM + (cpu[3] == 0).float()
    x3 = cs.solve_cg_reg(a, diag.to(card), b, gpu[4])
    px3 = cs.solve_cg_reg(a.cpu(), diag, b.cpu(), cpu[4])
    torch.testing.assert_close(x3.cpu(), px3, atol=2e-3, rtol=0)
    assert cs.LAUNCHES == {"gather_gram_cg": 1, "gather_gram_out": 1,
                           "solve_cg_reg": 1}


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    table, cols, vals, nnz, x0 = (t.to(card) for t in _chunk(128))
    with pytest.raises(ValueError):     # f not a multiple of 16 <= 128
        cs.gather_gram_out(torch.zeros((N + 1, 136), device=card), cols,
                           vals)
    with pytest.raises(ValueError):     # int64 ids
        cs.gather_gram_cg(table, cols.long(), vals, nnz, x0, LAM)
    with pytest.raises(ValueError):     # a strided view
        cs.solve_cg_reg(torch.zeros((R, 128, 256), device=card)[..., ::2],
                        torch.ones(R, device=card), x0, x0)
    assert sum(cs.LAUNCHES.values()) == 0
