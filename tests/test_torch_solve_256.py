"""The host side of the batched solves at f = 256, where a system takes a
cluster of two blocks (csrc/bulk_cg.cuh), and K5b's reference on an A'
that is not symmetric:

  - `cg_grid` at f = 256, given the clusters the card holds (what the
    kernels' occupancy query counts there): an even grid, 2 <= grid <=
    2 R, never more than two blocks a cluster it is given; the f <= 128
    sizing unchanged beside it;
  - the plain version of K5b (`solve_cg_aug_plain`) on an A' whose row
    f - 1 (b) and column f - 1 differ, at f = 256 and f = 128, against
    the JAX `solve_cg_pallas(aug=True)` with the Pallas kernel in
    interpret mode (it reads b from row f - 1, pallas_solve.py:
    _cg_solve_aug_kernel): x within 2e-3 (tests/test_pallas.py's CG
    limit), lane f - 1 exactly 0. On the card the kernel is held to
    this plain version in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import cumf_als_tpu.ops.pallas_solve as ps

from cumf_als_tpu_torch.ops import cuda_solve as cs

from test_torch_als import interpret_pallas  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("r", [1, 2, 3, 65, 66, 67, 132, 16384])
@pytest.mark.parametrize("clusters", [1, 2, 60, 66])
def test_cluster_grid_at_256(r, clusters):
    """Two blocks a system up to the clusters the card holds: even,
    within [2, 2 R], never past 2 clusters; the SM count and blocks an
    SM are not read."""
    grid = cs.cg_grid(r, 132, 1, clusters=clusters)
    assert grid % 2 == 0
    assert 2 <= grid <= 2 * r
    assert grid <= 2 * clusters
    assert grid == 2 * min(r, clusters)
    assert cs.cg_grid(r, 7, 5, clusters=clusters) == grid


@pytest.mark.parametrize("r,sms,per_sm,want", [
    (1, 132, 1, 1), (131, 132, 1, 131), (16384, 132, 1, 132),
    (16384, 132, 2, 264)])
def test_block_grid_below_256_is_unchanged(r, sms, per_sm, want):
    """Without clusters the grid is one block a system up to per_sm on
    each SM, as before."""
    assert cs.cg_grid(r, sms, per_sm) == want


def _aug_systems(f, a_dtype, seed, r=4):
    """R augmented systems at width f whose row f - 1 (b, lane f - 1 the
    corner) and column f - 1 differ; A = M M^T of a narrow M, a diagonal
    and a warm start with lane f - 1 zero. A' exact in `a_dtype`."""
    rng = np.random.RandomState(seed)
    m = rng.standard_normal((r, f, f // 6)).astype(np.float32) * (
        2 / np.sqrt(f))
    aug = np.einsum("rik,rjk->rij", m, m).astype(np.float32)
    aug[:, f - 1, :] = rng.standard_normal((r, f)).astype(np.float32)
    aug[:, :f - 1, f - 1] = rng.standard_normal((r, f - 1)).astype(
        np.float32)
    a = torch.from_numpy(aug)
    if a_dtype == "bf16":
        a = a.to(torch.bfloat16)
    diag = rng.uniform(0.5, 2.0, r).astype(np.float32)
    x0 = (rng.standard_normal((r, f)) * 0.1).astype(np.float32)
    x0[:, f - 1] = 0.0
    return a, diag, x0


@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("a_dtype", ["f32", "bf16"])
def test_k5b_plain_reads_row_not_column(interpret_pallas, f, a_dtype):
    a, diag, x0 = _aug_systems(f, a_dtype, seed=f)
    assert not torch.equal(a[:, f - 1, :f - 1], a[:, :f - 1, f - 1])
    kw = dict(cg_iters=6, cg_tol=1e-4)
    x = cs.solve_cg_aug(a, torch.from_numpy(diag), torch.from_numpy(x0),
                        **kw)
    ja = a.float().numpy()
    if a_dtype == "bf16":
        import jax.numpy as jnp
        ja = jnp.asarray(ja).astype(jnp.bfloat16)
    want = ps.solve_cg_pallas(ja, None, x0, diag=diag, aug=True, **kw)
    assert x.shape == (4, f)
    assert torch.all(x[:, f - 1] == 0)
    np.testing.assert_allclose(x.numpy(), np.asarray(want), atol=2e-3,
                               rtol=0)
    # the column would give another b, and another x
    at = a.clone()
    at[:, f - 1, :f - 1] = a[:, :f - 1, f - 1]
    xt = cs.solve_cg_aug(at, torch.from_numpy(diag), torch.from_numpy(x0),
                         **kw)
    assert (xt - x).abs().max().item() > 1e-2
