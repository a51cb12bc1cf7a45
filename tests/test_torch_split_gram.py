"""The split-bf16 bodies of the panel Grams K2 and K5a on a float32 table
at f = 128 and 256 (csrc/split_gram_mma.cuh and csrc/wide_split_mma.cuh,
`cs.panel_body` "split"), on the CPU:

  - its arithmetic, emulated in torch: each f32 entry cut into three bf16
    pieces by round-to-nearest (hi, mid, lo), six of their products
    (hi.hi, hi.mid, mid.hi, hi.lo, lo.hi, mid.mid) summed a 16-slot
    k-step at a time, each product's step rounded once into an f32 sum,
    as a wgmma adds into its f32 fragment; against an f64 einsum of the
    same slab within the body's limit (`gram_limit` "split" of
    tests/test_torch_cuda.py, 6 ceil(P / 16) + 2 + 4 steps of 2^-23
    sqrt(A_ii A_jj), + 1e-5), on seeded tables with full 24-bit
    mantissas and signed entries, with and without K5a's value lane (lane
    127, or lane 255 at f = 256); a bf16 table's one product (hi.hi
    alone) misses that limit up to P = 576, so the check sees what the
    two lower pieces carry;
  - on small-integer tables the pieces are the entries (mid = lo = 0)
    and the emulation equals the exact Gram bit for bit;
  - the names: `panel_body` for K2 and K5a, `gram_body` (K1, K6, K7)
    unchanged for the same tables;
  - the cut on few-row chunks for a float32 table at f = 128 and 256
    (`gram_spans` with one block an SM, `gram_blocks_per_sm`; at 256
    without the three-block condition of a bf16 table) on the fewest-row
    Netflix X shapes and the hot-segment shape, and `spans=` allowed
    there for K2 and K5a but not for K1;
  - the cut's plain version on a float32 table at f = 128 and 256
    against the JAX package's `gather_gram_out` / `gather_gram_aug_out`
    in interpret mode.

On the card the kernels are held to their plain versions in
tests/test_torch_cuda.py and chip_smoke.py."""

import math

import numpy as np
import pytest
import torch
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu_torch.ops import cuda_solve as cs
from test_torch_cuda import gram_limit

SMS = 132   # an H100's SMs
F = 128


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    yield


def pieces(x: torch.Tensor):
    """hi, mid, lo: the three bf16 pieces of f32 x, each by
    round-to-nearest-even of what the pieces before it leave."""
    hi = x.to(torch.bfloat16)
    rest = x - hi.float()                  # exact in f32
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


PRODUCTS = ((0, 0), (0, 1), (1, 0), (0, 2), (2, 0), (1, 1))


def split_gram(g: torch.Tensor, products=PRODUCTS) -> torch.Tensor:
    """A = G^T G of a gathered (R, P, f) f32 slab as the split body sums
    it: for each 16-slot k-step, each kept product of pieces in turn, its
    16 terms (exact: two 8-bit significands) added exactly and the step
    rounded once into the f32 sum."""
    r, p, f = g.shape
    parts = [t.double() for t in pieces(g)]
    acc = torch.zeros((r, f, f), dtype=torch.float32)
    for k in range(0, p, 16):
        for i, j in products:
            step = torch.einsum("rpf,rpg->rfg", parts[i][:, k:k + 16],
                                parts[j][:, k:k + 16])
            acc = (acc.double() + step).float()
    return acc


def slab(r, p, seed, integers=False, aug=False, signed=True, f=F):
    """A gathered f32 slab (R, P, f) from a seeded table (full-mantissa
    entries, 0.3 N(0, 1), or with `signed` False 0.2 U(0, 1) as
    init_factors makes a factor; or small integers), pad slots at each
    row's tail
    (row 0 full, the last row all pad slots: exact zeros), and the
    values; with aug lane f - 1 carries each slot's value, as K5a's."""
    rng = np.random.RandomState(seed)
    n = 300
    if integers:
        table = rng.randint(-4, 5, (n + 1, f)).astype(np.float32)
    elif signed:
        table = (rng.standard_normal((n + 1, f)) * 0.3).astype(np.float32)
    else:
        table = (0.2 * rng.random_sample((n + 1, f))).astype(np.float32)
    table[n] = 0.0
    if aug:
        table[:, f - 1] = 0.0
    nnz = rng.randint(1, p + 1, (r,))
    nnz[0], nnz[-1] = p, 0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    if integers:
        vals = rng.randint(1, 6, (r, p)).astype(np.float32)
    else:   # full-mantissa values, 3.3 among them
        vals = rng.uniform(1, 5, (r, p)).astype(np.float32)
        vals[0, 0] = 3.3
    vals = (vals * mask).astype(np.float32)
    t = torch.from_numpy(table)
    g = t[torch.from_numpy(cols).long()]
    if aug:
        g = cs.augment_g(g, torch.from_numpy(vals))
    return g, t, torch.from_numpy(cols), torch.from_numpy(vals)


def exact_gram(g: torch.Tensor) -> torch.Tensor:
    return torch.einsum("rpf,rpg->rfg", g.double(), g.double())


def test_the_pieces_add_up_to_each_entry():
    """hi + mid + lo == x exactly for full-mantissa f32 entries (24 bits
    in three 8-bit pieces), each piece at most half an ulp of the one
    before it."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(np.concatenate([
        rng.standard_normal(4096) * 0.3, rng.uniform(1, 5, 1024),
        -rng.uniform(1e-6, 1e-3, 1024), [0.0, 3.3, -1.0]]).astype(np.float32))
    hi, mid, lo = pieces(x)
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    assert torch.all(mid.float().abs() <= hi.float().abs() * 2.0 ** -8)
    assert torch.all(lo.float().abs() <= mid.float().abs() * 2.0 ** -8)
    assert bool((mid != 0).any()) and bool((lo != 0).any())


@pytest.mark.parametrize("p", [8, 136, 576, 4096])
@pytest.mark.parametrize("aug", [False, True])
def test_split_arithmetic_holds_the_f32_limit(p, aug):
    """The emulated split body against the exact Gram (f64) within
    `gram_limit` "split"; rows of pad slots only exactly 0. Up to
    P = 576 a Gram of the hi pieces alone (a bf16 table's one product)
    misses the same limit: the check sees the lower pieces (the limit
    grows as P, that error as sqrt(P))."""
    r = 3 if p < 4096 else 2
    g, _, _, _ = slab(r, p, seed=p + int(aug), aug=aug)
    got = split_gram(g)
    want = exact_gram(g)
    lim, name = gram_limit(got, want.float(), p, "split")
    assert name.startswith(f"{6 * math.ceil(p / 16) + 6} x 2^-23")
    diff = (got.double() - want).abs()
    assert bool((diff <= lim.double()).all())
    assert torch.all(got[-1] == 0)
    if p <= 576:
        one = split_gram(g, products=((0, 0),))
        assert not bool(((one.double() - want).abs() <= lim.double()).all())


@pytest.mark.parametrize("p", [8, 576])
@pytest.mark.parametrize("aug", [False, True])
def test_split_arithmetic_at_256_holds_the_f32_limit(p, aug):
    """The same at f = 256 (csrc/wide_split_mma.cuh: the same six products
    a 16-slot k-step, K5a's f32 value in lane 255 before the split):
    within `gram_limit` "split" of the exact Gram, rows of pad slots only
    exactly 0, and hi.hi alone off that limit."""
    g, _, _, vals = slab(2, p, seed=p + 5 + int(aug), aug=aug, f=256)
    got = split_gram(g)
    want = exact_gram(g)
    lim, name = gram_limit(got, want.float(), p, "split")
    assert name.startswith(f"{6 * math.ceil(p / 16) + 6} x 2^-23")
    assert bool(((got.double() - want).abs() <= lim.double()).all())
    assert torch.all(got[-1] == 0)
    if aug:   # lane 255 holds each slot's f32 value as it is
        assert torch.equal(g[..., 255], vals)
    one = split_gram(g, products=((0, 0),))
    assert not bool(((one.double() - want).abs() <= lim.double()).all())


@pytest.mark.parametrize("p", [8, 136, 576])
@pytest.mark.parametrize("aug", [False, True])
def test_small_integer_tables_are_exact(p, aug):
    """A table of small integers (and integer values): every piece below
    hi is zero, every sum exact in f32, so the emulated body equals the
    exact Gram and the port's plain version bit for bit."""
    g, t, cols, vals = slab(4, p, seed=7 * p, integers=True, aug=aug)
    hi, mid, lo = pieces(g)
    assert not bool(mid.any()) and not bool(lo.any())
    got = split_gram(g)
    assert torch.equal(got.double(), exact_gram(g))
    plain = cs.gather_gram_aug_out_plain(t, cols, vals) if aug else \
        cs.gather_gram_out_plain(t, cols, vals)[0]
    assert torch.equal(got, plain)


@pytest.mark.parametrize("dtype,f,panel,fused", [
    (torch.float32, 128, "split", "fma"),
    (torch.bfloat16, 128, "wgmma", "wgmma"),
    (torch.float32, 256, "split", "fma"),
    (torch.bfloat16, 256, "wgmma", "wgmma"),
    (torch.float32, 112, "fma", "fma"),
    (torch.bfloat16, 112, "fma", "fma"),
    (torch.float32, 64, "fma", "fma"),
    (torch.float32, 384, "fma", "fma"),
    (torch.bfloat16, 384, "wgmma", "wgmma")])
def test_panel_body_names_k2_and_k5a_gram_body_stays(dtype, f, panel, fused):
    """`panel_body` (K2, K5a) says "split" for a float32 table at f = 128
    and 256 only, and what `gram_body` says elsewhere; `gram_body` (K1,
    K6, K7) keeps the FMA body for a float32 table."""
    table = torch.zeros((3, f), dtype=dtype)
    assert cs.panel_body(table) == panel
    assert cs.gram_body(table) == fused


@pytest.mark.parametrize("r,p,s", [
    (8, 3840, 15), (40, 3840, 3), (16, 1 << 18, 8), (131, 4096, 1),
    (132, 4096, 1), (66, 4096, 2), (8, 192, 1), (8, 512, 2)])
def test_gram_spans_on_a_float32_table_at_128(r, p, s):
    """The cut of the split body (one block an SM): S whole tiles of at
    least `GRAM_CUT_MIN_TILES`, R S within the SMs, R below them; a float32
    table at f = 256 (the split body of csrc/wide_split_mma.cuh, one
    block an SM too) is cut the same; K1's rule (`theta_spans`, the FMA
    body) stays uncut."""
    assert cs.gram_blocks_per_sm(128, torch.float32) == 1
    assert cs.gram_blocks_per_sm(128) == 2
    assert cs.gram_spans(r, p, 128, SMS, torch.float32) == s
    assert r * s <= SMS
    assert cs.gram_spans(r, p, 256, SMS, torch.float32) == s
    assert cs.theta_spans(r, p, 128, SMS, torch.float32) == 1


def test_spans_is_allowed_for_k2_on_the_split_body_only():
    """`spans=` cuts a float32 table's chunk at f = 128 (and 256) for K2
    and K5a (`panel_body` "split"), not for K1 (`gram_body` "fma"), and
    only into whole 64-slot tiles."""
    table = torch.zeros((5, 128))
    assert cs._gram_spans_of("gather_gram_out", table, 2, 512, 4) == 4
    with pytest.raises(ValueError, match="spans"):
        cs._gram_spans_of("gather_gram_out", table, 2, 520, 4)
    with pytest.raises(ValueError, match="spans"):
        cs._gram_spans_of("gather_gram_cg", table, 2, 512, 4,
                          rule=cs.theta_spans, body=cs.gram_body)
    assert cs._gram_spans_of("gather_gram_out", torch.zeros((5, 256)), 2,
                             512, 4) == 4


@pytest.mark.parametrize("r,p,s,s_bf16", [
    (8, 3840, 15, 15), (16, 1 << 18, 8, 8), (131, 4096, 1, 1),
    (132, 4096, 1, 1), (2304, 576, 1, 1), (6656, 72, 1, 1),
    (40, 3840, 3, 3), (24, 1664, 2, 1), (32, 1408, 2, 1), (16, 4096, 8, 8)])
def test_gram_spans_on_a_float32_table_at_256(r, p, s, s_bf16):
    """At f = 256 a float32 table's split body (csrc/wide_split_mma.cuh)
    takes one block an SM and the cut of `gram_spans` as at f = 128: R
    below the SMs, R S within them, spans of at least
    `GRAM_CUT_MIN_TILES` whole tiles. The three-block condition stays a
    bf16 table's (it has a three-block body to beat): at 24 x 1664 and
    32 x 1408 the float32 table is cut, the bf16 one kept whole."""
    assert cs.gram_blocks_per_sm(256, torch.float32) == 1
    got = cs.gram_spans(r, p, 256, SMS, torch.float32)
    assert got == s and r * got <= max(SMS, r)
    if got > 1:
        assert p % (cs.GRAM_TILE * got) == 0
        assert p // got // cs.GRAM_TILE >= cs.GRAM_CUT_MIN_TILES
    assert cs.gram_spans(r, p, 256, SMS, torch.bfloat16) == s_bf16
    assert cs.theta_spans(r, p, 256, SMS, torch.float32) == 1


@pytest.mark.parametrize("name", ["gather_gram_out", "gather_gram_aug_out"])
def test_spans_at_256_on_a_float32_table_for_k2_and_k5a_only(name):
    """`spans=` forces S on a float32 table at f = 256 for K2 and K5a (the
    split body), only into whole 64-slot tiles; K1 there (`gram_body`
    "fma", the row cut's own rule) refuses it."""
    table = torch.zeros((5, 256))
    assert cs.panel_body(table) == "split"
    assert cs._gram_spans_of(name, table, 2, 1024, 8) == 8
    assert cs._gram_spans_of(name, table, 2, 1024, 1) == 1
    with pytest.raises(ValueError, match="spans"):
        cs._gram_spans_of(name, table, 2, 1024, 3)
    with pytest.raises(ValueError, match="spans"):
        cs._gram_spans_of("gather_gram_cg", table, 2, 1024, 2,
                          rule=cs.theta_spans, body=cs.gram_body)


@pytest.mark.parametrize("aug", [False, True])
def test_cut_at_256_on_a_float32_table_matches_pallas(aug):
    """The cut as the card runs it on a float32 table at f = 256 (R = 4,
    P = 512: S = 2 from `gram_spans`) against the JAX kernels at f32
    (factor_dtype "f32") in interpret mode, and the emulated split body
    within its limit; the table a factor at iteration 0 (unsigned), so
    rtol 1e-5 of |b| measures b's rounding."""
    r, p = 4, 512
    s = cs.gram_spans(r, p, 256, SMS, torch.float32)
    assert s == 2
    g, t, cols, vals = slab(r, p, seed=13, aug=aug, signed=False, f=256)
    a, b = cs.gram_cut_plain(t, cols, vals, s, aug=aug)
    jargs = (t.numpy(), cols.numpy(), vals.numpy())
    jkw = dict(factor_dtype="f32", out_dtype="float32")
    if aug:
        want = ps.gather_gram_aug_out(*jargs, **jkw)
    else:
        want, jb = ps.gather_gram_out(*jargs, **jkw)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                                   atol=1e-5)
    want = torch.from_numpy(np.array(want, np.float32))
    lim, _ = gram_limit(a, want, p, "split")
    assert bool(((a - want).abs() <= lim).all())
    emulated = split_gram(g)
    assert bool(((emulated - want).abs() <= lim).all())
    assert torch.all(a[-1] == 0)


@pytest.mark.parametrize("case", ["aligned", "offset"])
def test_split_body_checks_the_tables_alignment(case):
    """The split body copies 16 bytes at a time: a float32 table's rows
    must lie on 16-byte boundaries for K2 and K5a (K1's FMA body is not
    held to it)."""
    flat = torch.zeros(9 * 128 + 1)
    table = flat[:-1].view(9, 128) if case == "aligned" else \
        flat[1:].view(9, 128)
    cols = torch.zeros((4, 8), dtype=torch.int32)
    cs._check_gram_table(table, cols)
    if case == "aligned":
        cs._check_gram_table(table, cols, cs.panel_body(table))
    else:
        with pytest.raises(ValueError, match="16-byte"):
            cs._check_gram_table(table, cols, cs.panel_body(table))


@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_cut_on_a_float32_table_matches_pallas(aug, out_dtype):
    """The cut as the card runs it on a float32 table at f = 128 (S from
    `gram_spans` with one block an SM) against the JAX kernels at f32
    (factor_dtype "f32") in interpret mode, and the emulated split body
    on the same slab within its limit. The table is a factor as the X
    phase gathers it at iteration 0 (unsigned): with signed entries b's
    sums cancel and rtol 1e-5 of |b| no longer measures their
    rounding."""
    r, p = 8, 1536
    s = cs.gram_spans(r, p, F, SMS, torch.float32)
    assert s == 6
    g, t, cols, vals = slab(r, p, seed=11, aug=aug, signed=False)
    a, b = cs.gram_cut_plain(t, cols, vals, s,
                             out_dtype=getattr(torch, out_dtype), aug=aug)
    jargs = (t.numpy(), cols.numpy(), vals.numpy())
    jkw = dict(factor_dtype="f32", out_dtype=out_dtype)
    if aug:
        want = ps.gather_gram_aug_out(*jargs, **jkw)
    else:
        want, jb = ps.gather_gram_out(*jargs, **jkw)
        np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=1e-5,
                                   atol=1e-5)
    want = torch.from_numpy(np.array(want, np.float32))
    lim, _ = gram_limit(a, want, p, "split")
    assert bool(((a.float() - want).abs() <= lim).all())
    emulated = split_gram(g).to(a.dtype)
    lim, _ = gram_limit(emulated, want, p, "split")
    assert bool(((emulated.float() - want).abs() <= lim).all())
    assert torch.all(a[-1] == 0)
