"""The plain versions of the panel Gram kernels K2 (`gather_gram_out`)
and K5a (`gather_gram_aug_out`) against the JAX package's Pallas kernels
(interpret mode) at the shapes that stress the edges of the CUDA
kernels' 64-slot tile: P = 8 (one 16-slot step, half empty), 24 (a
ragged step), 72 (one slot group past a tile), 136 (two tiles and half
a step); one row alone; a row of pad slots only; f32 and bf16 tables;
f32 and bf16 A. The plain versions are what the CUDA kernels are held
to on a card (tests/test_torch_cuda.py runs the same grid there), so
these tests tie that grid to the reference.

Tolerances, those of tests/test_torch_kernels.py and
tests/test_torch_aug.py: A, A' and b rtol 1e-5 in f32 (the same sums in
another order), a bf16 A or A' within one bf16 ulp (both round one f32
sum)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu_torch.ops import cuda_solve as cs
from test_torch_cuda import gram_limit

F, N = 128, 60


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    yield


def edge_chunk(p, r, aug, seed=0):
    """A plan-shaped chunk of r rows and p slots: pad slots at each row's
    tail name the zero row N and carry value 0; with r > 1 row 0 is full
    and row 2 holds pad slots only. With aug, the table's lane F - 1 is
    free (zero) and one value (3.3) is not exact in bf16."""
    rng = np.random.RandomState(seed + 131 * p + r)
    table = (rng.standard_normal((N + 1, F)) * 0.3).astype(np.float32)
    table[N] = 0.0
    if aug:
        table[:, F - 1] = 0.0
    nnz = rng.randint(1, p + 1, (r,))
    if r > 1:
        nnz[0], nnz[2] = p, 0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, N, (r, p)), N).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    vals[0, 0] = 3.3
    return table, cols, vals * mask, nnz


def _bf16_ulp(a):
    a = np.abs(a).astype(np.float32)
    e = np.floor(np.log2(np.maximum(a, np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _assert_gram_close(a, ja, out_dtype):
    af, ja = a.float().numpy(), np.asarray(ja, np.float32)
    if out_dtype == "float32":
        np.testing.assert_allclose(af, ja, rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(af - ja) <= _bf16_ulp(np.maximum(
            np.abs(af), np.abs(ja))))


GRID = dict(argnames="p,r,factor_dtype,out_dtype", argvalues=[
    (p, r, fd, od) for p in (8, 24, 72, 136) for r in (1, 5)
    for fd in ("f32", "bf16") for od in ("float32", "bfloat16")])


@pytest.mark.parametrize(**GRID)
def test_gather_gram_out_tile_edges_match_pallas(p, r, factor_dtype,
                                                 out_dtype):
    table, cols, vals, nnz = edge_chunk(p, r, aug=False)
    ja, jb = ps.gather_gram_out(jnp.asarray(table), jnp.asarray(cols),
                                jnp.asarray(vals),
                                factor_dtype=factor_dtype,
                                out_dtype=out_dtype)
    t = torch.from_numpy(table)
    a, b = cs.gather_gram_out(
        t.to(torch.bfloat16) if factor_dtype == "bf16" else t,
        torch.from_numpy(cols), torch.from_numpy(vals),
        out_dtype=getattr(torch, out_dtype))
    assert a.shape == (r, F, F) and a.dtype == getattr(torch, out_dtype)
    assert b.shape == (r, F) and b.dtype == torch.float32
    _assert_gram_close(a, ja, out_dtype)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                               atol=1e-5)
    empty = nnz == 0
    assert torch.all(a[empty] == 0) and torch.all(b[empty] == 0)


@pytest.mark.parametrize(**GRID)
def test_gather_gram_aug_out_tile_edges_match_pallas(p, r, factor_dtype,
                                                     out_dtype):
    table, cols, vals, nnz = edge_chunk(p, r, aug=True, seed=1)
    ja = ps.gather_gram_aug_out(jnp.asarray(table), jnp.asarray(cols),
                                jnp.asarray(vals),
                                factor_dtype=factor_dtype,
                                out_dtype=out_dtype)
    t = torch.from_numpy(table)
    a = cs.gather_gram_aug_out(
        t.to(torch.bfloat16) if factor_dtype == "bf16" else t,
        torch.from_numpy(cols), torch.from_numpy(vals),
        out_dtype=getattr(torch, out_dtype))
    assert a.shape == (r, F, F) and a.dtype == getattr(torch, out_dtype)
    _assert_gram_close(a, ja, out_dtype)
    assert torch.all(a[nnz == 0] == 0)
    if out_dtype == "float32":
        # the corner holds sum v^2 of the values as the table stores them
        v = torch.from_numpy(vals)
        if factor_dtype == "bf16":
            v = v.to(torch.bfloat16).float()
        np.testing.assert_allclose(a[:, F - 1, F - 1].numpy(),
                                   (v * v).sum(1).numpy(), rtol=1e-5)


@pytest.mark.parametrize("p,span", [
    (136, 64), (264, 128), (520, 256), (576, 64), (1288, 256), (1288, 704),
    (3840, 512), (4096, 1024)])
def test_plain_gram_adds_over_spans_of_slots(p, span):
    """A row's Gram is the sum of the Grams over any cut of its slots:
    what lets the panel route scatter-add partial (A, b) of one row from
    several chunks, and the CUDA kernels add a row tile by tile."""
    table, cols, vals, _ = edge_chunk(p, 3, aug=False)
    t = torch.from_numpy(table).to(torch.bfloat16)
    args = (torch.from_numpy(cols), torch.from_numpy(vals))
    a, b = cs.gather_gram_out_plain(t, *args)
    parts = [cs.gather_gram_out_plain(t, *(x[:, lo:lo + span] for x in args))
             for lo in range(0, p, span)]
    torch.testing.assert_close(sum(x[0] for x in parts), a, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(sum(x[1] for x in parts), b, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("body,p,a_dtype,name", [
    ("fma", 136, torch.float32, "140 x 2^-23 sqrt(A_ii A_jj) + 1e-5"),
    ("fma", 48, torch.bfloat16,
     "52 x 2^-23 sqrt(A_ii A_jj) + 1e-5 + one bf16 ulp"),
    ("fma", 520, torch.float32, "524 x 2^-23 sqrt(A_ii A_jj) + 1e-5"),
    ("wgmma", 576, torch.float32, "40 x 2^-23 sqrt(A_ii A_jj) + 1e-5"),
    ("wgmma", 8, torch.bfloat16,
     "5 x 2^-23 sqrt(A_ii A_jj) + 1e-5 + one bf16 ulp"),
    ("split", 576, torch.float32, "222 x 2^-23 sqrt(A_ii A_jj) + 1e-5"),
    ("split", 8, torch.bfloat16,
     "12 x 2^-23 sqrt(A_ii A_jj) + 1e-5 + one bf16 ulp"),
    ("split", 136, torch.float32, "60 x 2^-23 sqrt(A_ii A_jj) + 1e-5")])
def test_gram_limit_names_what_each_body_is_held_to(body, p, a_dtype, name):
    """`gram_limit`, the tolerance of the card checks
    (tests/test_torch_cuda.py): on the size of the sum, steps x 2^-23
    sqrt(A_ii A_jj) + 1e-5, a step a slot in the FMA body and 16 slots
    on the tensor cores (six a 16-slot step and two more for the split
    body of a float32 table, never looser than the FMA body's), one bf16
    ulp more for a bf16 A; an entry that cancels to 0 keeps room for the
    rounding of its terms."""
    g = torch.tensor([[3.0, -3.0, 1.0], [3.0, 3.0, 0.5]])
    a = (g.T @ g)[None].to(a_dtype)       # A_01 = 0 by cancellation
    lim, got = gram_limit(a, a.float(), p, body)
    assert got == name and lim.shape == a.shape and bool((lim > 0).all())
    steps = int(name.split()[0])
    assert steps <= p + 4       # no looser than the FMA body's
    want = steps * 2.0 ** -23 * 18.0 + 1e-5
    if a_dtype == torch.bfloat16:
        want += 2.0 ** -7 * 1e-30     # the ulp of an exact zero: none
    assert float(lim[0, 0, 1]) == pytest.approx(want, rel=1e-6)
    ulp = 2.0 ** -3 if a_dtype == torch.bfloat16 else 0.0   # of 18
    assert float(lim[0, 0, 0]) == pytest.approx(want + ulp, rel=1e-6)
