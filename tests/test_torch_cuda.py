"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Marked `cuda`; without a card they skip. This file imports no JAX
(the machine with the card has none), so run it there without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py and tests/test_torch_aug.py:
rtol 1e-5 for an f32 A or A' and for b, one bf16 ulp for a bf16 A or A',
2e-3 absolute for x and se at CG-6."""

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
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_cg": 1, "gather_gram_out": 1, "solve_cg_reg": 1}


@pytest.mark.parametrize("f", [16, 48, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_aug_kernels_match_plain(card, f, dtype):
    """K5a, K5b, K6 and K4 against their plain versions. The true factor
    width is f - 4 (lane f-1 free), and one value (3.3) is not exact in
    bf16, so the kernels must round it where augment_g does."""
    cpu = _chunk(f, seed=1)
    cpu[0][:, f - 4:] = 0.0
    cpu[4][:, f - 4:] = 0.0
    cpu[2][0, 0] = 3.3
    cpu[0] = cpu[0].to(dtype)
    gpu = [t.to(card) for t in cpu]
    x, se = cs.gather_gram_cg(*gpu, LAM, aug=True)
    px, pse = cs.gather_gram_cg(*cpu, LAM, aug=True)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), pse, atol=2e-3, rtol=1e-4)
    assert torch.all(x[3] == 0) and torch.all(x[:, f - 1] == 0)
    a = cs.gather_gram_aug_out(*gpu[:3], out_dtype=dtype)
    pa = cs.gather_gram_aug_out(*cpu[:3], out_dtype=dtype)
    assert a.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(a.cpu(), pa, rtol=1e-5, atol=1e-5)
    else:
        assert _within_bf16_ulp(a, pa)
    diag = cpu[3].float() * LAM + (cpu[3] == 0).float()
    x5 = cs.solve_cg_aug(a, diag.to(card), gpu[4])
    px5 = cs.solve_cg_aug(a.cpu(), diag, cpu[4])
    torch.testing.assert_close(x5.cpu(), px5, atol=2e-3, rtol=0)
    assert torch.all(x5[:, f - 1] == 0)
    # K4 on the same systems, unpacked and regularized beforehand
    ua, ub, _ = cs.unpack_aug(a.cpu())
    areg = (ua + diag[:, None, None] * torch.eye(f)).to(dtype)
    areg[5] = 0.0                   # a zero system returns its x0
    x4 = cs.solve_cg(areg.to(card), ub.to(card), gpu[4])
    px4 = cs.solve_cg(areg, ub, cpu[4])
    torch.testing.assert_close(x4.cpu(), px4, atol=2e-3, rtol=0)
    assert torch.equal(x4[5].cpu(), cpu[4][5])
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_cg_aug": 1, "gather_gram_aug_out": 1,
        "solve_cg_aug": 1, "solve_cg": 1}


def test_solve_dispatch_launches_a_kernel_or_raises(card):
    """On the card, solve(cg, pallas) launches K3, K4 or K5b and never
    runs the plain torch CG; what the kernels do not take raises."""
    from cumf_als_tpu_torch.ops.solve import solve
    f = 128
    a = torch.eye(f, device=card).repeat(R, 1, 1).contiguous()
    b = torch.ones((R, f), device=card)
    x0 = torch.zeros((R, f), device=card)
    diag = torch.ones(R, device=card)
    kw = dict(solver="cg", backend="pallas")
    torch.testing.assert_close(solve(a, b, x0, **kw), b)
    assert cs.LAUNCHES["solve_cg"] == 1
    solve(a, b, x0, diag=diag, **kw)
    assert cs.LAUNCHES["solve_cg_reg"] == 1
    solve(a, None, x0, diag=diag, aug=True, **kw)
    assert cs.LAUNCHES["solve_cg_aug"] == 1
    wide = torch.eye(256, device=card).repeat(R, 1, 1).contiguous()
    with pytest.raises(ValueError):
        solve(wide, torch.ones((R, 256), device=card),
              torch.zeros((R, 256), device=card), **kw)
    assert sum(cs.LAUNCHES.values()) == 3


def test_wrappers_reject_what_the_kernels_do_not_take(card):
    table, cols, vals, nnz, x0 = (t.to(card) for t in _chunk(128))
    with pytest.raises(ValueError):     # f not a multiple of 16 <= 128
        cs.gather_gram_out(torch.zeros((N + 1, 136), device=card), cols,
                           vals)
    with pytest.raises(ValueError):     # int64 ids
        cs.gather_gram_cg(table, cols.long(), vals, nnz, x0, LAM)
    strided = torch.zeros((R, 128, 256), device=card)[..., ::2]
    with pytest.raises(ValueError):     # a strided view
        cs.solve_cg_reg(strided, torch.ones(R, device=card), x0, x0)
    with pytest.raises(ValueError):
        cs.solve_cg(strided, x0, x0)
    with pytest.raises(ValueError):
        cs.solve_cg_aug(strided, torch.ones(R, device=card), x0)
    with pytest.raises(ValueError):     # bf16 warm start
        cs.gather_gram_cg(table, cols, vals, nnz, x0.bfloat16(), LAM,
                          aug=True)
    with pytest.raises(ValueError):     # int64 ids
        cs.gather_gram_aug_out(table, cols.long(), vals)
    assert sum(cs.LAUNCHES.values()) == 0
