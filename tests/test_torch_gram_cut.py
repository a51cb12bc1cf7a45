"""The cut of the panel Grams K2 (`gather_gram_out`) and K5a
(`gather_gram_aug_out`) on chunks of few rows, on the CPU:

  - the span rule `gram_spans` as cases: S spans of whole 64-slot tiles
    that cover [0, P) once, S = 1 where the cut does not apply (at or
    above the blocks that fit the card, a width other than 128 or 256, P
    not a whole number of tiles), R S within the
    spans an SM allow and near them where P's tiles let it, no span
    under `GRAM_CUT_MIN_TILES` tiles, the f32 partials within
    `SPAN_SCRATCH_BYTES`;
  - the cut's plain version `gram_cut_plain` (each span's Gram in f32,
    summed in span order) against the uncut plain versions
    `gather_gram_out_plain` / `gather_gram_aug_out_plain`, and the
    plain version of pass 2 against a sum in span order;
  - the cut's plain version against the JAX package's `gather_gram_out`
    and `gather_gram_aug_out` with the Pallas kernels in interpret mode
    (as tests/test_pallas.py runs them), on few-row chunks with pad
    slots: f = 128 at R = 8, P = 1536 and f = 256 at R = 4, P = 384.

Tolerances: b rtol 1e-5 (f32 sums in another order); A within the f32
rounding of its sums, (P / 16 + S + 4) ulps of sqrt(A_ii A_jj) + 1e-5
(the tensor cores' 16-slot steps of each span, the S adds of pass 2 and
the reference's own rounding: `gram_limit` of tests/test_torch_cuda.py
with the cut's steps), plus one bf16 ulp of the larger entry for a bf16
A (both sides round one f32 sum to nearest). On the card the kernels are
held to the uncut plain versions in tests/test_torch_cuda.py and
chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu_torch.ops import cuda_solve as cs

SMS = 132   # an H100's SMs


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    yield


@pytest.mark.parametrize("r,p,f", [
    (16, 1 << 18, 128), (16, 1 << 18, 256), (16, 4096, 128),
    (16, 4096, 256), (40, 3840, 128), (40, 3840, 256), (64, 3072, 128),
    (100, 2048, 128), (120, 640, 128), (131, 4096, 256), (8, 1536, 128),
    (8, 96, 128), (4, 384, 256), (263, 4096, 128), (264, 4096, 128),
    (132, 4096, 256), (2304, 576, 128), (16, 4160, 128), (16, 4100, 128),
    (1, 1 << 20, 256)])
def test_span_rule(r, p, f):
    # a bf16 table, and a float32 one at f = 128 and 256 (the split
    # bodies, one block an SM); every other width keeps the uncut kernel
    for dtype in (torch.bfloat16, torch.float32):
        s = cs.gram_spans(r, p, f, SMS, dtype)
        per_sm = cs.gram_blocks_per_sm(f, dtype)
        tiles = p // cs.GRAM_TILE
        assert s >= 1 and p % s == 0
        if s > 1:
            span = p // s
            assert span % cs.GRAM_TILE == 0                 # whole tiles
            assert span * s == p                            # [0, P) once
            assert span // cs.GRAM_TILE >= cs.GRAM_CUT_MIN_TILES
            assert r < per_sm * SMS
            assert r * s <= min(cs.GRAM_CUT_TARGET, per_sm) * SMS
            assert r * s * (f * f + f) * 4 <= cs.SPAN_SCRATCH_BYTES
            # no larger S of whole tiles fits the same limits
            items = min(cs.GRAM_CUT_TARGET, per_sm) * SMS
            assert not [k for k in range(s + 1, tiles + 1)
                        if tiles % k == 0 and r * k <= items and
                        tiles // k >= cs.GRAM_CUT_MIN_TILES]
        if r >= per_sm * SMS or p % cs.GRAM_TILE or \
                tiles < 2 * cs.GRAM_CUT_MIN_TILES:
            assert s == 1
    assert cs.gram_spans(r, p, 112, SMS) == 1
    assert cs.gram_spans(r, p, 112, SMS, torch.float32) == 1


@pytest.mark.parametrize("r,p,f", [(16, 1 << 18, 128), (16, 4096, 128),
                                   (16, 1 << 18, 256), (40, 3840, 256)])
def test_span_rule_fills_the_card(r, p, f):
    """Where P's tiles have divisors to spare, R S comes within a factor
    of two of the spans the card takes at once."""
    items = min(cs.GRAM_CUT_TARGET, cs.gram_blocks_per_sm(f)) * SMS
    s = cs.gram_spans(r, p, f, SMS)
    assert items / 2 < r * s <= items


@pytest.mark.parametrize("r,p,s", [
    (40, 960, 1), (40, 1024, 1), (32, 1408, 1), (24, 1664, 1),
    (24, 1536, 4), (16, 1792, 7), (40, 3584, 2), (16, 1 << 18, 8),
    (48, 1024, 2)])
def test_span_rule_at_256_keeps_the_three_block_body_where_it_wins(r, p, s):
    """At f = 256 a chunk of 3 R <= SMs runs uncut on the three-block body:
    the cut takes it only where 1.5 T / S + 8 < T for T tiles a row (the
    few-row X panel shapes that were slower cut than there are left
    whole); a chunk of more rows has no three-block body to beat."""
    assert cs.gram_spans(r, p, 256, SMS) == s


def few_row_chunk(r, p, f, seed=0, n=70, aug=False):
    """A zero-extended table (n + 1, f), cols (R, P) with pad slots naming
    row n at each row's tail (row 1 all pad slots, row 0 full), values
    in halves (one, 3.3, not exact in bf16); with aug lane f - 1 of the
    table is zero (the free lane)."""
    rng = np.random.RandomState(seed + 7 * p + r)
    table = (rng.standard_normal((n + 1, f)) * 0.3).astype(np.float32)
    table[n] = 0.0
    if aug:
        table[:, f - 1] = 0.0
    nnz = rng.randint(p // 3, p + 1, (r,))
    nnz[0], nnz[1] = p, 0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    vals[0, 0] = 3.3
    return table, cols, (vals * mask).astype(np.float32), nnz


def within_rounding(a, want, p, spans):
    """|A - A_ref| within (P / 16 + S + 4) f32 ulps of sqrt(A_ii A_jj),
    + 1e-5, + one bf16 ulp of the larger entry when A is bf16."""
    got = a.float().numpy()
    ref = np.asarray(want, np.float32)
    d = np.sqrt(np.clip(np.diagonal(ref, axis1=1, axis2=2), 0, None))
    steps = -(-p // 16) + spans + 4
    lim = steps * 2.0 ** -23 * d[:, :, None] * d[:, None, :] + 1e-5
    if a.dtype == torch.bfloat16:
        big = np.maximum(np.abs(got), np.abs(ref))
        lim = lim + np.exp2(np.floor(np.log2(np.maximum(big, 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= lim)


@pytest.mark.parametrize("spans", [1, 2, 3, 4, 6, 12, 24])
@pytest.mark.parametrize("aug", [False, True])
def test_cut_plain_equals_the_uncut_plain(spans, aug):
    p, r, f = 1536, 8, 128
    table, cols, vals, nnz = few_row_chunk(r, p, f, aug=aug)
    t = torch.from_numpy(table).to(torch.bfloat16)
    args = (t, torch.from_numpy(cols), torch.from_numpy(vals))
    a, b = cs.gram_cut_plain(*args, spans, aug=aug)
    if aug:
        want, wb = cs.gather_gram_aug_out_plain(*args), None
        assert b is None
    else:
        want, wb = cs.gather_gram_out_plain(*args)
        np.testing.assert_allclose(b.numpy(), wb.numpy(), rtol=1e-5,
                                   atol=1e-5)
    within_rounding(a, want.numpy(), p, spans)
    assert torch.all(a[1] == 0)


def test_pass_2_plain_adds_in_span_order():
    rng = np.random.RandomState(3)
    a_part = torch.from_numpy(rng.standard_normal((12, 8, 8)).astype(
        np.float32))
    b_part = torch.from_numpy(rng.standard_normal((12, 8)).astype(
        np.float32))
    for spans in (1, 3, 4):
        a, b = cs.gram_span_sum_plain(a_part, b_part, spans, torch.bfloat16)
        want = a_part.view(-1, spans, 8, 8)[:, 0]
        wb = b_part.view(-1, spans, 8)[:, 0]
        for k in range(1, spans):
            want = want + a_part.view(-1, spans, 8, 8)[:, k]
            wb = wb + b_part.view(-1, spans, 8)[:, k]
        assert torch.equal(a, want.to(torch.bfloat16)) and torch.equal(b, wb)
    assert cs.gram_span_sum_plain(a_part, None, 4)[1] is None
    with pytest.raises(ValueError, match="card tensors only"):
        cs.gram_span_sum(a_part, b_part, 4)


def test_cpu_tensors_take_the_plain_version_whatever_spans_says():
    table, cols, vals, _ = few_row_chunk(4, 256, 128)
    args = (torch.from_numpy(table), torch.from_numpy(cols),
            torch.from_numpy(vals))
    a, b = cs.gather_gram_out(*args, spans=4)
    pa, pb = cs.gather_gram_out_plain(*args)
    assert torch.equal(a, pa) and torch.equal(b, pb)
    assert torch.equal(cs.gather_gram_aug_out(*args, spans=2),
                       cs.gather_gram_aug_out_plain(*args))


@pytest.mark.parametrize("f,r,p,spans", [
    (128, 8, 1536, None), (128, 8, 1536, 4),
    (256, 4, 384, 3), (256, 4, 384, 2)])
@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("factor_dtype,out_dtype", [
    ("bf16", "float32"), ("bf16", "bfloat16")])
def test_cut_plain_matches_pallas(f, r, p, spans, aug, factor_dtype,
                                  out_dtype):
    """The cut as the card runs it (the rule's S on an H100, or a forced
    one) against the JAX kernels on a bf16 table, as the cut takes only
    such tables."""
    s = cs.gram_spans(r, p, f, SMS) if spans is None else spans
    assert s > 1
    table, cols, vals, nnz = few_row_chunk(r, p, f, seed=1, aug=aug)
    jargs = (table, cols, vals)
    jkw = dict(factor_dtype=factor_dtype, out_dtype=out_dtype)
    t = torch.from_numpy(table).to(torch.bfloat16)
    a, b = cs.gram_cut_plain(t, torch.from_numpy(cols),
                             torch.from_numpy(vals), s,
                             out_dtype=getattr(torch, out_dtype), aug=aug)
    if aug:
        want = ps.gather_gram_aug_out(*jargs, **jkw)
    else:
        want, jb = ps.gather_gram_out(*jargs, **jkw)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                                   atol=1e-5)
    assert a.shape == (r, f, f) and a.dtype == getattr(torch, out_dtype)
    within_rounding(a, np.asarray(want, np.float32), p, s)
    assert torch.all(a[nnz == 0] == 0)
