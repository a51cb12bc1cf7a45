"""The host side of K3's persistent design and of K8's two-pass route,
and the plain version of that route against the JAX package.

K3 (`solve_cg_reg`) launches persistent blocks: `cg_grid` (one
block a system up to what fits the card; the blocks an SM come from the
kernel's occupancy query, held on the card in tests/test_torch_cuda.py). K8 (`fused_gram_cg_cat`) chooses its body from G's dtype and f2
alone (`cat_body`); on the two passes its CPU reference is
`cat_row_cut_plain`: span Grams of G over every slot (`cat_span_gram_plain`),
added in span order, then `span_solve_plain`. That is held against the
JAX `fused_gram_cg_cat` with the Pallas kernel in interpret mode (as
tests/test_torch_wide.py runs it), on a G and values that are not zero
past nnz, at S = 1, 2 and 3 spans: x and se rtol 1e-3 / atol 1e-4 at
CG-20 (the two packages sum in other orders; CG-20 at cg_tol 1e-10
converges both), 2e-3 absolute at CG-6 (tests/test_pallas.py)."""

import functools

import numpy as np
import pytest
import torch

import cumf_als_tpu.ops.pallas_solve as ps

from cumf_als_tpu_torch.ops import cuda_solve as cs

LAM = 0.05


@pytest.mark.parametrize("r,sms,per_sm,want", [
    (1, 132, 2, 1), (263, 132, 2, 263), (264, 132, 2, 264),
    (265, 132, 2, 264), (16384, 132, 2, 264), (16384, 132, 1, 132),
    (5, 114, 1, 5)])
def test_k3_persistent_grid(r, sms, per_sm, want):
    """One block a system up to the blocks that fit the card at once;
    above that every block walks several systems."""
    assert cs.cg_grid(r, sms, per_sm) == want


@pytest.mark.parametrize("dtype,f2,want", [
    (torch.bfloat16, 32, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 96, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 40, "fma"), (torch.bfloat16, 7, "fma"),
    (torch.float32, 96, "fma"), (torch.float32, 128, "fma")])
def test_k8_route_goes_by_dtype_and_f2_alone(dtype, f2, want):
    assert cs.cat_body(dtype, f2) == want


def _packed(f2, seed, r=8, p=192):
    """g1, g2, vals, nnz, x0 with G and values not zero past nnz, one row
    with nnz 0, and G exact in bf16 (so both packages see one G)."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal((r, p, 128 + f2)) * 0.3).astype(np.float32)
    g = torch.from_numpy(g).bfloat16().float().numpy()
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    nnz = rng.integers(1, p, r).astype(np.int32)
    nnz[2] = 0
    x0 = (rng.standard_normal((r, 256)) * 0.1).astype(np.float32)
    return (np.ascontiguousarray(g[:, :, :128]),
            np.ascontiguousarray(g[:, :, 128:]), vals, nnz, x0)


@functools.lru_cache(maxsize=None)
def _jax_cat(f2, iters, tol):
    g1, g2, vals, nnz, x0 = _packed(f2, seed=f2)
    orig = ps.pl.pallas_call
    ps.pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        jx, jse = ps.fused_gram_cg_cat(g1, g2, vals, nnz, x0, LAM,
                                       cg_iters=iters, cg_tol=tol)
    finally:
        ps.pl.pallas_call = orig
    return np.asarray(jx), np.asarray(jse)


@pytest.mark.parametrize("f2", [32, 96])
@pytest.mark.parametrize("spans", [1, 2, 3])
@pytest.mark.parametrize("iters,tol", [(20, 1e-10), (6, 1e-4)])
def test_cat_row_cut_plain_matches_pallas(f2, spans, iters, tol):
    """K8's route span by span (span Grams of G over every slot, added
    in span order, then the 256-lane solve) against the JAX
    `fused_gram_cg_cat`, at S = 1, 2, 3 spans of 64-slot tiles over
    P = 192; and the wrapper on CPU tensors (the plain version, whatever
    `spans` says) within rounding of the cut."""
    g1, g2, vals, nnz, x0 = _packed(f2, seed=f2)
    jx, jse = _jax_cat(f2, iters, tol)
    n_spans, span = cs._cut(-(-192 // 64), spans, 64)
    assert n_spans == spans
    t = [torch.from_numpy(a) for a in (g1, g2, vals, nnz, x0)]
    x, se = cs.cat_row_cut_plain(*t, LAM, n_spans, span, cg_iters=iters,
                                 cg_tol=tol)
    kw = dict(rtol=1e-3, atol=1e-4) if iters == 20 else \
        dict(rtol=0, atol=2e-3)
    np.testing.assert_allclose(x.numpy(), jx, **kw)
    np.testing.assert_allclose(se.numpy(), jse, rtol=1e-3, atol=kw["atol"])
    assert np.abs(x.numpy()[2]).max() == 0.0
    wx, wse = cs.fused_gram_cg_cat(*t, LAM, cg_iters=iters, cg_tol=tol,
                                   spans=spans)
    torch.testing.assert_close(wx, x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(wse, se, rtol=1e-5, atol=1e-5)


def test_cat_span_grams_sum_to_the_whole_gram():
    """The span Grams of `cat_span_gram_plain` cover every slot once: in
    span order they add up to the Gram of all P slots (f32 sums, so
    within rounding), whatever nnz says."""
    g1, g2, vals, _, _ = (torch.from_numpy(a) for a in _packed(64, seed=1))
    whole = cs.cat_span_gram_plain(g1, g2, vals, 0, 192)
    parts = [cs.cat_span_gram_plain(g1, g2, vals, k * 64, (k + 1) * 64)
             for k in range(3)]
    for i in range(3):
        torch.testing.assert_close(sum(p[i] for p in parts), whole[i],
                                   rtol=1e-5, atol=1e-4)
    assert torch.all(whole[0][:, 128 + 64:, :] == 0)
    assert torch.all(whole[1][:, 128 + 64:] == 0)


def test_fused_gram_cg_cat_checks_spans():
    g1, g2, vals, nnz, x0 = (torch.from_numpy(a) for a in _packed(32, 0))
    with pytest.raises(ValueError, match="spans"):
        cs.fused_gram_cg_cat(g1, g2, vals, nnz, x0, LAM, spans=0)
