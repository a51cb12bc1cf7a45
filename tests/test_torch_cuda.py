"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Marked `cuda`; without a card they skip. This file imports no JAX
(the machine with the card has none), so run it there without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances as in tests/test_torch_kernels.py and tests/test_torch_aug.py:
rtol 1e-5 for an f32 A or A' and for b, one bf16 ulp for a bf16 A or A',
2e-3 absolute for x and se at CG-6; the 256-lane kernels (K7, K8, K1 at
f = 256) as in tests/test_torch_wide.py: dead lanes and empty rows
exactly 0, K8 against K1 at f = 256 on the same G rtol 1e-5.

The Gram kernels K1, K2, K5a and K6 run their tensor-core body for a
bf16 table at f = 128, and K1 at f = 256 and K7 theirs (pass 1 of the
row cut, then pass 2) for a bf16 table at 256 lanes (`cs.gram_body`).
There the products are exact and the f32 sums are taken in the
hardware's order, so the error follows the size of the sum, not of the
value: `gram_limit` states the limit for each body. An integer table
makes every sum exact and the comparison bit for bit: the proof of the
tile and record layout. K1 and K6 stop each row at its nnz;
`theta_chunk` puts rows that stop at the edges of the 64-slot tile into
one chunk, x within 2e-3 and se within 1e-3 relative."""

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


def gram_limit(a, a_plain, p, body):
    """What a card's K2 or K5a is held to against the plain version: the
    elementwise limit on |A - A_plain| and its name, for rows of p slots
    run in `body`. Both bodies add in another order than the plain
    version, so the error follows the size of the sum, not of the value:
    an entry whose terms cancel keeps the error of its large partial
    sums. The terms of A_ij sum in magnitude to at most sqrt(A_ii A_jj)
    (Cauchy-Schwarz), so the limit is steps x 2^-23 x sqrt(A_ii A_jj) +
    1e-5: one f32 ulp of the sum's size for each accumulation step (a
    slot in the FMA body, 16 slots on the tensor cores; the split body of
    a float32 table, "split", six wgmma a 16-slot step and two for the
    three products it drops, mid.lo, lo.mid and lo.lo, at most 2^-23
    |g_i| |g_j| a slot) and 4 for the plain version's own rounding. A
    bf16 A adds one bf16 ulp of the larger value: both sides round an f32
    sum to nearest."""
    af, pf = a.float(), a_plain.float()
    k_steps = -(-p // 16)
    steps = {"fma": p, "split": 6 * k_steps + 2}.get(body, k_steps) + 4
    d = pf.diagonal(dim1=-2, dim2=-1).clamp_min(0).sqrt()
    lim = steps * 2.0 ** -23 * d[..., :, None] * d[..., None, :] + 1e-5
    name = f"{steps} x 2^-23 sqrt(A_ii A_jj) + 1e-5"
    if a.dtype != torch.bfloat16:
        return lim, name
    big = torch.maximum(af.abs(), pf.abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp_min(1e-30))) - 7)
    return lim + ulp, name + " + one bf16 ulp"


def _assert_gram_close(a, pa, p, body):
    """A (or A') of a card kernel against the plain version's, within
    `gram_limit` for the body that ran."""
    lim, _ = gram_limit(a.cpu(), pa, p, body)
    assert bool(((a.float().cpu() - pa.float()).abs() <= lim).all())


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
    _assert_gram_close(a, pa, P, cs.panel_body(gpu[0]))
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
    _assert_gram_close(a, pa, P, cs.panel_body(gpu[0]))
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


def _edge_chunk(p, r, kind, seed=0, f=128):
    """The chunk of tests/test_torch_gram.py: r rows of p slots at
    f = 128 (or `f`), pad slots at each row's tail; with r > 1 row 0 is
    full and row 2 holds pad slots only; lane f - 1 of the table free for
    the aug form. kind "integers": a table of small integers, so that
    every sum is exact in f32 in any order."""
    n = 60
    rng = np.random.RandomState(seed + 131 * p + r)
    if kind == "integers":
        table = rng.randint(-4, 5, (n + 1, f)).astype(np.float32)
    else:
        table = (rng.standard_normal((n + 1, f)) * 0.3).astype(np.float32)
    table[n] = 0.0
    table[:, f - 1] = 0.0
    nnz = rng.randint(1, p + 1, (r,))
    if r > 1:
        nnz[0], nnz[2] = p, 0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    if kind != "integers":
        vals[0, 0] = 3.3            # not exact in bf16
    return (torch.from_numpy(table), torch.from_numpy(cols),
            torch.from_numpy(vals * mask), torch.from_numpy(nnz == 0))


@pytest.mark.parametrize("p", [8, 24, 72, 136, 520, 1288])
@pytest.mark.parametrize("r", [1, 5])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["integers", "random"])
def test_gram_kernels_at_the_tile_edges(card, p, r, table_dtype, out_dtype,
                                        kind):
    """K2 and K5a against their plain versions at the edges of the
    64-slot tile, in both bodies (a bf16 table runs the tensor cores on
    its entries, a float32 table on their three bf16 pieces, the split
    body), and at P = 520 and 1288 with rows of 9 and 21 tiles through
    the rings: bit for bit on an integer table, within
    `_assert_gram_close` on a random one (full f32 mantissas: the split
    body's mid and lo pieces are not zero); rows of pad slots only
    exactly 0."""
    table, cols, vals, empty = _edge_chunk(p, r, kind)
    cpu = (table.to(table_dtype), cols, vals)
    gpu = tuple(t.to(card) for t in cpu)
    body = cs.panel_body(gpu[0])
    assert body == ("wgmma" if table_dtype == torch.bfloat16 else "split")
    a, b = cs.gather_gram_out(*gpu, out_dtype=out_dtype)
    pa, pb = cs.gather_gram_out(*cpu, out_dtype=out_dtype)
    a5 = cs.gather_gram_aug_out(*gpu, out_dtype=out_dtype)
    pa5 = cs.gather_gram_aug_out(*cpu, out_dtype=out_dtype)
    assert a.dtype == a5.dtype == out_dtype and b.dtype == torch.float32
    if kind == "integers":
        assert torch.equal(a.cpu(), pa) and torch.equal(b.cpu(), pb)
        assert torch.equal(a5.cpu(), pa5)
    else:
        _assert_gram_close(a, pa, p, body)
        _assert_gram_close(a5, pa5, p, body)
        torch.testing.assert_close(b.cpu(), pb, rtol=1e-5, atol=1e-5)
    for out in (a, b, a5):
        assert torch.all(out[empty.to(card)] == 0)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_out": 1, "gather_gram_aug_out": 1}


@pytest.mark.parametrize("p", [8, 72, 136, 520])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["integers", "random"])
def test_panel_grams_at_256_lanes(card, p, table_dtype, out_dtype, kind):
    """K2 and K5a at f = 256 (factor widths 128 < F <= 256) against their
    plain versions, in both bodies (a bf16 table runs the three
    tensor-core blocks of csrc/wide_gram_mma.cuh, a float32 table the
    split body of csrc/wide_split_mma.cuh): bit for bit on an integer
    table (the proof of the block layout, the transposed (1, 0) block
    and the value in lane 255), within `gram_limit` on a random one; A
    symmetric; rows of pad slots only exactly 0."""
    table, cols, vals, empty = _edge_chunk(p, 5, kind, f=256)
    cpu = (table.to(table_dtype), cols, vals)
    gpu = tuple(t.to(card) for t in cpu)
    body = cs.panel_body(gpu[0])
    assert body == ("wgmma" if table_dtype == torch.bfloat16 else "split")
    a, b = cs.gather_gram_out(*gpu, out_dtype=out_dtype)
    pa, pb = cs.gather_gram_out(*cpu, out_dtype=out_dtype)
    a5 = cs.gather_gram_aug_out(*gpu, out_dtype=out_dtype)
    pa5 = cs.gather_gram_aug_out(*cpu, out_dtype=out_dtype)
    assert a.shape == a5.shape == (5, 256, 256)
    if kind == "integers":
        assert torch.equal(a.cpu(), pa) and torch.equal(b.cpu(), pb)
        assert torch.equal(a5.cpu(), pa5)
    else:
        _assert_gram_close(a, pa, p, body)
        _assert_gram_close(a5, pa5, p, body)
        torch.testing.assert_close(b.cpu(), pb, rtol=1e-5, atol=1e-5)
    for out in (a, a5):
        off = out[:, :128, 128:]
        assert torch.equal(off, out[:, 128:, :128].transpose(1, 2))
    for out in (a, b, a5):
        assert torch.all(out[empty.to(card)] == 0)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_out": 1, "gather_gram_aug_out": 1}


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_panel_grams_at_256_repeat_and_are_symmetric(card, out_dtype,
                                                      vals_dtype):
    """K2 and K5a at f = 256 on a bf16 table (the panel body of
    csrc/wide_gram_mma.cuh, one block a row of A, its blocks walking
    rows) on more rows than the card has SMs, the ids and values a view
    that starts at an odd slot (P = 199): two launches give the same
    bits, A is exactly symmetric (both triangles written from one sum),
    A and b against the plain version (`gram_limit`, b rtol 1e-5), and
    A' carries b and sum v^2 in row and column 255 as the plain version's
    value lane does."""
    table, cols, vals, empty = _edge_chunk(199, 301, "random", f=256)
    gpu = (table.to(torch.bfloat16).to(card), cols[1:].to(card),
           vals.to(vals_dtype)[1:].to(card))
    empty = empty[1:]
    a, b = cs.gather_gram_out(*gpu, out_dtype=out_dtype)
    a2, b2 = cs.gather_gram_out(*gpu, out_dtype=out_dtype)
    assert torch.equal(a, a2) and torch.equal(b, b2)
    pa, pb = cs.gather_gram_out_plain(*gpu, out_dtype=out_dtype)
    _assert_gram_close(a, pa.cpu(), 199, "wgmma")
    torch.testing.assert_close(b, pb, rtol=1e-5, atol=1e-5)
    a5 = cs.gather_gram_aug_out(*gpu, out_dtype=out_dtype)
    assert torch.equal(a5, cs.gather_gram_aug_out(*gpu, out_dtype=out_dtype))
    for out in (a, a5):
        assert torch.equal(out, out.transpose(1, 2))
    pa5 = cs.gather_gram_aug_out_plain(*gpu, out_dtype=out_dtype)
    _assert_gram_close(a5, pa5.cpu(), 199, "wgmma")
    assert torch.all(a[empty.to(card)] == 0) and \
        torch.all(a5[empty.to(card)] == 0)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_out": 2, "gather_gram_aug_out": 2}


def _few_row_chunk(r, p, n, f, seed=0):
    """A chunk of few rows on the card (bf16 table of n rows and a zero
    row, lane f - 1 zero, entries 0.2 U(0, 1) as init_factors makes a
    factor: with signed ones b's sums over 2^18 slots cancel and rtol
    1e-5 of |b| no longer measures their rounding; each row's first nnz
    slots live, nnz from P / 2 to P, row 1 of pad slots only; values in
    halves)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = (0.2 * torch.rand((n + 1, f), generator=gen, device="cuda")
             ).to(torch.bfloat16)
    table[n] = 0
    table[:, f - 1] = 0
    nnz = torch.randint(p // 2, p + 1, (r,), generator=gen, device="cuda")
    nnz[1] = 0
    mask = torch.arange(p, device="cuda")[None, :] < nnz[:, None]
    cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                           device="cuda"), n).to(torch.int32)
    vals = (torch.randint(2, 11, (r, p), generator=gen, device="cuda") / 2.0
            * mask).float()
    return table, cols, vals


@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("aug", [False, True])
def test_gram_cut_on_the_hot_shape(card, f, aug):
    """K2 and K5a on a chunk of the hot segments' shape (R = 16, P = 2^18,
    a 2,000,001-row table, f32 A) take the cut of `cs.gram_spans` (one
    launch of the kernel over the spans, one of pass 2): A (and b)
    within `gram_limit` of the plain version, the same bits twice, and
    spans=1 (the uncut kernel, no pass 2) within the same limit."""
    r, p = 16, 1 << 18
    table, cols, vals = _few_row_chunk(r, p, 2_000_000, f)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert cs.gram_spans(r, p, f, sms) > 1
    fn = cs.gather_gram_aug_out if aug else cs.gather_gram_out
    plain = cs.gather_gram_aug_out_plain if aug else \
        cs.gather_gram_out_plain

    def run(**kw):
        out = fn(table, cols, vals, out_dtype=torch.float32, **kw)
        return (out, None) if aug else out

    a, b = run()
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        fn.__name__: 1, "gram_span_sum": 1}
    a2, b2 = run()
    assert torch.equal(a.view(torch.int32), a2.view(torch.int32))
    pa = plain(table, cols, vals)
    pa, pb = (pa, None) if aug else pa
    _assert_gram_close(a, pa.cpu(), p, "wgmma")
    if not aug:
        assert torch.equal(b.view(torch.int32), b2.view(torch.int32))
        torch.testing.assert_close(b, pb, rtol=1e-5, atol=1e-5)
    assert torch.all(a[1] == 0)
    cs.reset_launch_counts()
    a1, b1 = run(spans=1)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {fn.__name__: 1}
    _assert_gram_close(a1, pa.cpu(), p, "wgmma")


@pytest.mark.parametrize("f", [128, 256])
def test_gram_chunks_of_many_rows_keep_the_uncut_kernel(card, f):
    """A chunk of as many rows as the blocks of its body that fit the
    card takes the uncut kernel, no pass 2: the same bits as spans=1; a
    chunk of few rows cut as routed equals the chunk forced to the same
    S; `spans` must cut P into whole 64-slot tiles; a float32 table's
    split body (f = 128 and 256) cuts as a bf16 table's body does."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    r = cs.gram_blocks_per_sm(f) * sms
    table, cols, vals = _few_row_chunk(r, 512, 600, f, seed=1)
    assert cs.gram_spans(r, 512, f, sms) == 1
    a, b = cs.gather_gram_out(table, cols, vals)
    a1, b1 = cs.gather_gram_out(table, cols, vals, spans=1)
    assert torch.equal(a.view(torch.int32), a1.view(torch.int32))
    assert torch.equal(b.view(torch.int32), b1.view(torch.int32))
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_out": 2}
    few = _few_row_chunk(8, 4096, 600, f, seed=2)
    table = few[0]
    s = cs.gram_spans(8, 4096, f, sms)
    assert s > 1
    a = cs.gather_gram_aug_out(*few, out_dtype=torch.bfloat16)
    a2 = cs.gather_gram_aug_out(*few, out_dtype=torch.bfloat16, spans=s)
    assert torch.equal(a.view(torch.int16), a2.view(torch.int16))
    # the split body of a float32 table cuts as the bf16 body does, its
    # cut held to the plain version within the body's limit on entries
    # with full mantissas (zero row and lane f - 1 kept)
    gen = torch.Generator(device=card).manual_seed(3)
    t32 = 0.2 * torch.rand(table.shape, generator=gen, device=card)
    t32[table.shape[0] - 1] = 0
    t32[:, f - 1] = 0
    assert cs.panel_body(t32) == "split"
    a32 = cs.gather_gram_aug_out(t32, *few[1:], spans=2)
    pa32 = cs.gather_gram_aug_out_plain(t32.cpu(),
                                        *(t.cpu() for t in few[1:]))
    _assert_gram_close(a32, pa32, 4096, "split")
    for t in (table, t32):
        with pytest.raises(ValueError, match="spans"):
            cs.gather_gram_out(t, *few[1:], spans=3)


@pytest.mark.parametrize("shape", ["many rows", "out-of-core theta",
                                   "fewest rows", "hot segment"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_split_grams_at_256_on_a_float32_table(card, shape, out_dtype):
    """K2 and K5a on a float32 table at f = 256 (the split body of
    csrc/wide_split_mma.cuh; entries 0.2 U(0, 1) with full mantissas, a
    factor at iteration 0) against their plain versions on the shapes
    the paths give it: more rows than SMs with the ids and values a view
    from an odd slot and bf16 values (P = 199), the out-of-core theta
    chunk (R = 6656, P = 72), the fewest-row X panel chunk (R = 16,
    P = 4096) and the hot segments (R = 16, P = 2^18, K2 alone), the last
    two cut (`gram_spans`: one launch of the kernel, one of pass 2). A
    within `gram_limit` "split", b within rtol 1e-5, A exactly symmetric,
    rows of pad slots only exactly 0, the same bits twice."""
    r, p, n = {"many rows": (301, 199, 600),
               "out-of-core theta": (6656, 72, 65_536),
               "fewest rows": (16, 4096, 65_536),
               "hot segment": (16, 1 << 18, 2_000_000)}[shape]
    table, cols, vals = _few_row_chunk(r, p, n, 256, seed=4)
    gen = torch.Generator(device=card).manual_seed(5)
    table = 0.2 * torch.rand(table.shape, generator=gen, device=card)
    table[n] = 0
    table[:, 255] = 0
    if shape == "many rows":
        cols, vals = cols[1:], vals.to(torch.bfloat16)[1:]
        r -= 1
    empty = (cols == n).all(dim=1)
    spans = cs.gram_spans(r, p, 256, torch.cuda.get_device_properties(
        card).multi_processor_count, torch.float32)
    assert (spans > 1) == (shape in ("fewest rows", "hot segment"))
    for aug in (False, True):
        if shape == "hot segment" and (aug or out_dtype == torch.bfloat16):
            continue
        fn = cs.gather_gram_aug_out if aug else cs.gather_gram_out
        plain = cs.gather_gram_aug_out_plain if aug else \
            cs.gather_gram_out_plain
        cs.reset_launch_counts()
        out = fn(table, cols, vals, out_dtype=out_dtype)
        assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
            fn.__name__: 1} | ({"gram_span_sum": 1} if spans > 1 else {})
        again = fn(table, cols, vals, out_dtype=out_dtype)
        want = plain(table, cols, vals, out_dtype=out_dtype)
        a, b = (out, None) if aug else out
        a2, b2 = (again, None) if aug else again
        pa, pb = (want, None) if aug else want
        assert _same_bits(a.float(), a2.float())
        _assert_gram_close(a, pa.cpu(), p, "split")
        assert torch.equal(a, a.transpose(1, 2))
        assert torch.all(a[empty] == 0)
        if b is not None:
            assert _same_bits(b, b2) and torch.all(b[empty] == 0)
            torch.testing.assert_close(b, pb, rtol=1e-5, atol=1e-5)


# ------------------- the cut of K1 and K6 on few-row chunks (f = 128) --
def _theta_few_rows(r, p, n, aug, seed=0):
    """A theta chunk of few rows at f = 128 on the card: a bf16 table of
    n rows and a zero row, entries 0.2 U(0, 1) as init_factors makes a
    factor, lane 127 zero; row 0 of P - 3000 slots (much longer than the
    rest), row 1 without ratings, row 2 stopping at the edge of a quarter
    of P (a span's edge), the others P / 64 to P / 8; values in halves,
    one 3.3 (not exact in bf16); warm starts 0.1 N(0, 1), zero where nnz
    is 0, and in lane 127 with aug."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = (0.2 * torch.rand((n + 1, 128), generator=gen, device="cuda")
             ).to(torch.bfloat16)
    table[n] = 0
    table[:, 127] = 0
    nnz = torch.randint(p // 64, p // 8 + 1, (r,), generator=gen,
                        device="cuda", dtype=torch.int32)
    nnz[0], nnz[1], nnz[2] = p - 3000, 0, p // 4
    mask = torch.arange(p, device="cuda")[None, :] < nnz[:, None]
    cols = torch.where(mask, torch.randint(0, n, (r, p), generator=gen,
                                           device="cuda"), n).to(torch.int32)
    vals = (torch.randint(2, 11, (r, p), generator=gen, device="cuda") / 2.0
            * mask).float()
    vals[0, 0] = 3.3
    x0 = 0.1 * torch.randn((r, 128), generator=gen, device="cuda")
    x0[nnz == 0] = 0
    if aug:
        x0[:, 127] = 0
    return table, cols, vals, nnz, x0


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("r,p,n", [(8, 196608, 2_000_000),
                                   (32, 81920, 2_000_000),
                                   (16, 8192, 17_770)])
@pytest.mark.parametrize("aug", [False, True])
def test_theta_cut_on_few_row_chunks(card, r, p, n, aug):
    """K1 and K6 on a chunk of few rows at f = 128 take the cut of
    `cs.theta_spans` (one launch of the kernel's entry point for pass 1,
    one of pass 2): x within 2e-3 and se within 1e-3 relative of the
    plain version, rows without ratings exactly 0 (K6: lane 127 too), the
    same bits twice; spans=1 is the uncut kernel, no pass 2, x within
    2e-3 of the plain version."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert cs.theta_spans(r, p, 128, sms) > 1
    args = _theta_few_rows(r, p, n, aug)
    name = "gather_gram_cg_aug" if aug else "gather_gram_cg"
    x, se = cs.gather_gram_cg(*args, LAM, aug=aug)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        name: 1, "frag_span_solve": 1}
    x2, se2 = cs.gather_gram_cg(*args, LAM, aug=aug)
    assert _same_bits(x, x2) and _same_bits(se, se2)
    plain = cs.gather_gram_cg_aug_plain if aug else cs.gather_gram_cg_plain
    px, pse = plain(*args, LAM)
    torch.testing.assert_close(x, px, atol=2e-3, rtol=0)
    assert bool(((se - pse).abs() <= 1e-3 * pse.abs().clamp_min(1.0)).all())
    empty = args[3] == 0
    assert torch.all(x[empty] == 0) and torch.all(se[empty] == 0)
    if aug:
        assert torch.all(x[:, 127] == 0)
    cs.reset_launch_counts()
    x1, _ = cs.gather_gram_cg(*args, LAM, aug=aug, spans=1)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {name: 1}
    torch.testing.assert_close(x1, px, atol=2e-3, rtol=0)


@pytest.mark.parametrize("aug", [False, True])
def test_theta_chunks_of_many_rows_keep_the_uncut_kernel(card, aug):
    """A chunk of as many rows as the blocks that fit the card (two an
    SM) takes the uncut kernel, no pass 2: the same bits as spans=1; a
    chunk of few rows cut as routed equals the chunk forced to the same
    S; `spans` must cut P into whole 64-slot tiles of a bf16 table."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    r = 2 * sms
    args = _theta_few_rows(r, 4096, 600, aug, seed=1)
    assert cs.theta_spans(r, 4096, 128, sms) == 1
    name = "gather_gram_cg_aug" if aug else "gather_gram_cg"
    x, se = cs.gather_gram_cg(*args, LAM, aug=aug)
    x1, se1 = cs.gather_gram_cg(*args, LAM, aug=aug, spans=1)
    assert _same_bits(x, x1) and _same_bits(se, se1)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {name: 2}
    few = _theta_few_rows(8, 4096, 600, aug, seed=2)
    s = cs.theta_spans(8, 4096, 128, sms)
    assert s > 1
    x, se = cs.gather_gram_cg(*few, LAM, aug=aug)
    xs, ses = cs.gather_gram_cg(*few, LAM, aug=aug, spans=s)
    assert _same_bits(x, xs) and _same_bits(se, ses)
    for bad, t in ((3, few[0]), (2, few[0].float())):
        with pytest.raises(ValueError, match="spans"):
            cs.gather_gram_cg(t, *few[1:], LAM, aug=aug, spans=bad)


@pytest.mark.parametrize("spans", [4, 16])
@pytest.mark.parametrize("aug", [False, True])
def test_theta_cut_passes_alone(card, spans, aug):
    """Pass 1 of the cut on an integer table (every sum exact) equals the
    plain span Grams bit for bit in each live record (A row-major, then
    b and r2; K6's A' with the values in lane 127): the proof of the
    record layout and of `SpanLen`, rows stopping inside a span, at its
    edge and at the tile's. Pass 2 alone on those records: x within 2e-3
    and se within 1e-3 relative of its plain version."""
    rng = np.random.RandomState(spans)
    r, p, n = 8, 1024, 60
    table = torch.from_numpy(rng.randint(-2, 3, (n + 1, 128)).astype(
        np.float32))
    table[n] = 0
    table[:, 127] = 0
    nnz = torch.tensor([1024, 0, 1, 63, 64, 65, 256, 700], dtype=torch.int32)
    mask = torch.arange(p)[None, :] < nnz[:, None].long()
    cols = torch.where(mask, torch.from_numpy(rng.randint(0, n, (r, p))),
                       n).to(torch.int32)
    vals = torch.from_numpy(rng.randint(1, 6, (r, p)).astype(np.float32)) \
        * mask
    x0 = torch.from_numpy((rng.standard_normal((r, 128)) * 0.1).astype(
        np.float32))
    x0[:, 127] = 0
    gpu = [t.to(card) for t in (table.to(torch.bfloat16), cols, vals, nnz,
                                x0)]
    name = "gather_gram_cg_aug" if aug else "gather_gram_cg"
    part = cs.theta_span_grams(*gpu[:4], spans, aug=aug)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {name: 1}
    a_s, b_s, r2_s = cs.theta_records_unpack(part, r, spans)
    live = cs._span_live(gpu[3], p, spans, p // spans)
    span = p // spans
    for k in range(spans):
        a, b, r2 = cs.span_gram_plain(*gpu[:4], k * span, (k + 1) * span,
                                      128, aug)
        on = live[:, k]
        assert torch.equal(a_s[on, k], a[on])
        if not aug:
            assert torch.equal(b_s[on, k], b[on])
            assert torch.equal(r2_s[on, k], r2[on])
    x, se = cs.frag_span_solve(part, gpu[3], gpu[4], LAM, p, spans, aug=aug)
    px, pse = cs.frag_span_solve_plain(part, gpu[3], gpu[4], LAM, p, spans,
                                       aug=aug)
    torch.testing.assert_close(x, px, atol=2e-3, rtol=0)
    assert bool(((se - pse).abs() <= 1e-3 * pse.abs().clamp_min(1.0)).all())
    assert torch.all(x[1] == 0) and torch.all(se[1] == 0)
    if aug:
        assert torch.all(x[:, 127] == 0)
    assert cs.LAUNCHES["frag_span_solve"] == 1


THETA_NNZ = (0, 1, 15, 16, 17, 63, 64, 65, 128, 129)


def theta_chunk(p, aug, seed=0):
    """A theta chunk of P = p slots at f = 128 whose rows stop at the
    edges of the fused kernels' 64-slot tile: one row for each nnz of
    THETA_NNZ up to p and one of p, pad slots at each row's tail (the
    zero row N, value 0), and a dummy tail row without ratings whose warm
    start is zero, as a plan's chunk ends. With aug the table's lane 127
    and the warm start's are free (zero), and one value (3.3) is not
    exact in bf16. Returns numpy arrays: table, cols, vals, nnz, x0."""
    f = 128
    rng = np.random.RandomState(seed + 17 * p)
    nnz = np.array([k for k in THETA_NNZ if k < p] + [p, 0], dtype=np.int32)
    r = len(nnz)
    table = (rng.standard_normal((N + 1, f)) * 0.3).astype(np.float32)
    table[N] = 0.0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, N, (r, p)), N).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    vals[-2, 0] = 3.3
    x0 = (rng.standard_normal((r, f)) * 0.1).astype(np.float32)
    x0[-1] = 0.0
    if aug:
        table[:, f - 1] = 0.0
        x0[:, f - 1] = 0.0
    return table, cols, vals * mask, nnz, x0


@pytest.mark.parametrize("p", [64, 256, 520])
@pytest.mark.parametrize("aug", [False, True])
@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("vals_dtype", [torch.float32, torch.bfloat16])
def test_fused_kernels_where_rows_stop(card, p, aug, table_dtype,
                                       vals_dtype):
    """K1 (or, with aug, K6) against its plain version on `theta_chunk`:
    rows of 0 to P slots in one chunk, a bf16 table in the tensor-core
    body (rows of 1, 4 and 9 tiles), a float32 table in the FMA body; x
    within 2e-3, se within 1e-3 relative (the limits of the Netflix
    chunks in chip_smoke.py); rows without ratings exactly 0 in x and
    se, and K6's lane 127 of x exactly 0."""
    table, cols, vals, nnz, x0 = (torch.from_numpy(a) for a in
                                  theta_chunk(p, aug))
    cpu = (table.to(table_dtype), cols, vals.to(vals_dtype), nnz, x0)
    gpu = tuple(t.to(card) for t in cpu)
    assert cs.gram_body(gpu[0]) == (
        "wgmma" if table_dtype == torch.bfloat16 else "fma")
    x, se = cs.gather_gram_cg(*gpu, LAM, aug=aug)
    px, pse = cs.gather_gram_cg(*cpu, LAM, aug=aug)
    x, se = x.cpu(), se.cpu()
    torch.testing.assert_close(x, px, atol=2e-3, rtol=0)
    assert bool(((se - pse).abs() <= 1e-3 * pse.abs().clamp_min(1.0)).all())
    empty = nnz == 0
    assert torch.all(x[empty] == 0) and torch.all(se[empty] == 0)
    if aug:
        assert torch.all(x[:, 127] == 0)
    name = "gather_gram_cg_aug" if aug else "gather_gram_cg"
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {name: 1}


def _wide_chunk(f_true, dtype, seed=2):
    """A chunk over a 256-lane table whose lanes >= f_true are zero, and
    a warm start that is zero there too."""
    cpu = _chunk(256, seed=seed)
    cpu[0][:, f_true:] = 0.0
    cpu[4][:, f_true:] = 0.0
    cpu[0] = cpu[0].to(dtype)
    cpu[2] = cpu[2].to(dtype)
    return cpu


def _wide_launches(dtype, uncut: str, n: int) -> dict:
    """The launch counts of n calls of K7 (uncut = "gather_gram_cg_wide")
    or K1 at f = 256 (uncut = "gather_gram_cg") with spans=1: a float32
    table runs the uncut kernel, a bf16 table the two passes, one span a
    row, pass 1 on the tensor cores."""
    if dtype == torch.bfloat16:
        return dict.fromkeys(cs.LAUNCHES, 0) | {"wide_span_gram_mma": n,
                                                "wide_span_solve": n}
    return dict.fromkeys(cs.LAUNCHES, 0) | {uncut: n}


@pytest.mark.parametrize("f_true", [130, 161, 200, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_kernel_matches_plain(card, f_true, dtype):
    """K7 at every f2 (32, 64, 96, 128) against its plain version; a bf16
    table runs the two passes, pass 1 on the tensor cores."""
    f2 = cs.wide_f2(f_true)
    cpu = _wide_chunk(f_true, dtype)
    gpu = [t.to(card) for t in cpu]
    x, se = cs.gather_gram_cg_wide(*gpu, LAM, f2)
    px, pse = cs.gather_gram_cg_wide(*cpu, LAM, f2)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), pse, atol=2e-3, rtol=1e-4)
    assert torch.all(x[3] == 0) and torch.all(x[:, 128 + f2:] == 0)
    # the kernel reads no lane >= 128 + f2: garbage there changes nothing
    dirty = gpu[0].clone()
    dirty[:, 128 + f2:] = 7.0
    x0_dirty = gpu[4].clone()
    x0_dirty[:, 128 + f2:] = 7.0
    x2, se2 = cs.gather_gram_cg_wide(dirty, gpu[1], gpu[2], gpu[3],
                                     x0_dirty, LAM, f2)
    assert torch.equal(x2, x) and torch.equal(se2, se)
    # not even NaN there (the tensor-core pass 1 zero-fills those pieces)
    dirty[:, 128 + f2:] = float("nan")
    x3, se3 = cs.gather_gram_cg_wide(dirty, gpu[1], gpu[2], gpu[3],
                                     x0_dirty, LAM, f2)
    assert torch.equal(x3, x) and torch.equal(se3, se)
    assert cs.LAUNCHES == _wide_launches(dtype, "gather_gram_cg_wide", 3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_at_256_and_cat_kernel_match_plain(card, dtype):
    """K1 at f = 256 and K8 against their plain versions, and K8 against
    K1 at f = 256 on the same G (zero past nnz, as K8 walks all P slots).
    A bf16 G takes the two passes K1 takes on a bf16 table, so there the
    two are equal bit for bit; a float32 G keeps the FMA body, held to
    K1's uncut FMA kernel on the float32 table within rtol 1e-5."""
    cpu = _wide_chunk(200, dtype, seed=3)
    gpu = [t.to(card) for t in cpu]
    x, se = cs.gather_gram_cg(*gpu, LAM)
    px, pse = cs.gather_gram_cg(*cpu, LAM)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), pse, atol=2e-3, rtol=1e-4)
    assert torch.all(x[3] == 0)
    assert cs.LAUNCHES == _wide_launches(dtype, "gather_gram_cg", 1)
    cs.reset_launch_counts()
    f2 = cs.wide_f2(200)
    g = cpu[0].index_select(0, cpu[1].reshape(-1).long()).reshape(R, P, 256)
    g1, g2 = g[:, :, :128].contiguous(), g[:, :, 128:128 + f2].contiguous()
    cat_cpu = (g1, g2, cpu[2], cpu[3], cpu[4])
    xc, sec = cs.fused_gram_cg_cat(*(t.to(card) for t in cat_cpu), LAM)
    pxc, psec = cs.fused_gram_cg_cat(*cat_cpu, LAM)
    torch.testing.assert_close(xc.cpu(), pxc, atol=2e-3, rtol=0)
    torch.testing.assert_close(sec.cpu(), psec, atol=2e-3, rtol=1e-4)
    if dtype == torch.bfloat16:
        assert torch.equal(xc, x) and torch.equal(sec, se)
        assert cs.LAUNCHES == _wide_launches(dtype, "", 1)
    else:
        torch.testing.assert_close(xc, x, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(sec, se, rtol=1e-5, atol=1e-6)
        assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
            "fused_gram_cg_cat": 1}


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
    # f = 256 (128 < F <= 256): K4, K3 and K5b launch there too
    wide = torch.eye(256, device=card).repeat(R, 1, 1).contiguous()
    bw = torch.ones((R, 256), device=card)
    x0w = torch.zeros((R, 256), device=card)
    torch.testing.assert_close(solve(wide, bw, x0w, **kw), bw)
    torch.testing.assert_close(solve(wide, bw, x0w, diag=diag, **kw),
                               bw / 2)
    xa = solve(wide, None, x0w, diag=diag, aug=True, **kw)
    # A' = I: b, row 255 without its lane 255, is 0
    assert bool((xa == 0).all())
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "solve_cg": 2, "solve_cg_reg": 2, "solve_cg_aug": 2}
    odd = torch.eye(136, device=card).repeat(R, 1, 1).contiguous()
    with pytest.raises(ValueError):
        solve(odd, torch.ones((R, 136), device=card),
              torch.zeros((R, 136), device=card), **kw)
    assert sum(cs.LAUNCHES.values()) == 6


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
    # K6 takes f = 256 as K1 does; what it still refuses: f off the grid
    # (it names itself), and aug records narrower than 256 lanes or of
    # all slots in the passes
    odd = torch.zeros((N + 1, 136), device=card)
    with pytest.raises(ValueError, match="gather_gram_cg_aug"):
        cs.gather_gram_cg(odd, cols, vals, nnz,
                          torch.zeros((R, 136), device=card), LAM, aug=True)
    wide = torch.zeros((N + 1, 256), device=card)
    x0w = torch.zeros((R, 256), device=card)
    with pytest.raises(ValueError, match="256 with aug"):
        cs.span_grams(wide, cols, vals, nnz, 224, 1, 64, aug=True)
    part = torch.zeros((R, 1, cs.span_record_floats(256)), device=card)
    with pytest.raises(ValueError, match="aug"):
        cs.span_solve(part, nnz, x0w, LAM, P, 64, all_slots=True, aug=True)
    with pytest.raises(ValueError):     # a 128-lane table
        cs.gather_gram_cg_wide(table, cols, vals, nnz, x0w, LAM, 32)
    with pytest.raises(ValueError):     # f2 off the grid
        cs.gather_gram_cg_wide(wide, cols, vals, nnz, x0w, LAM, 48)
    g1 = torch.zeros((R, P, 128), device=card)
    with pytest.raises(ValueError):     # g2 of another dtype than g1
        cs.fused_gram_cg_cat(g1, g1[:, :, :32].bfloat16().contiguous(),
                             vals, nnz, x0w, LAM)
    with pytest.raises(ValueError):     # a strided g2
        cs.fused_gram_cg_cat(g1, g1[:, :, :32], vals, nnz, x0w, LAM)
    assert sum(cs.LAUNCHES.values()) == 0
    # K2 and K5a at f = 256 launch and agree with their plain versions
    wide = torch.from_numpy(
        np.random.RandomState(5).standard_normal((N + 1, 256)).astype(
            np.float32) * 0.3).to(card).to(torch.bfloat16)
    wide[N] = 0
    wide[:, 255] = 0
    a, b = cs.gather_gram_out(wide, cols, vals)
    pa, pb = cs.gather_gram_out_plain(wide, cols, vals)
    _assert_gram_close(a, pa.cpu(), P, "wgmma")
    torch.testing.assert_close(b, pb, rtol=1e-5, atol=1e-5)
    a5 = cs.gather_gram_aug_out(wide, cols, vals)
    _assert_gram_close(a5, cs.gather_gram_aug_out_plain(wide, cols,
                                                         vals).cpu(),
                       P, "wgmma")
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_out": 1, "gather_gram_aug_out": 1}


# ----------------------- the row cut of the 256-lane body (K1, K7) --
def cut_chunk(f_true, dtype, p, span, seed=0, n=60):
    """A chunk over a 256-lane table of true width f_true (lanes above
    zero, in the table and the warm start) whose rows stop at nnz 0, 1,
    31, 32, 33, on the span edge `span`, one past it, and at P = p, pad
    slots at each row's tail (the zero row n, value 0), and a dummy tail
    row without ratings whose warm start is zero; on the CPU."""
    rng = np.random.RandomState(seed + p)
    nnz = np.array([0, 1, 31, 32, 33, span, span + 1, p, 0], np.int32)
    r = len(nnz)
    table = np.zeros((n + 1, 256), np.float32)
    table[:n, :f_true] = rng.standard_normal((n, f_true)) * 0.3
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2 * mask
            ).astype(np.float32)
    x0 = np.zeros((r, 256), np.float32)
    x0[:-1, :f_true] = rng.standard_normal((r - 1, f_true)) * 0.1
    return [torch.from_numpy(table).to(dtype), torch.from_numpy(cols),
            torch.from_numpy(vals).to(dtype), torch.from_numpy(nnz),
            torch.from_numpy(x0)]


CUTS = [(300, 2), (300, 3), (448, 7)]      # (P, spans): S = 2, 3, 7


@pytest.mark.parametrize("p,spans", CUTS)
@pytest.mark.parametrize("f_true,kernel", [
    (130, "K7"), (161, "K7"), (200, "K7"), (256, "K7"), (200, "K1")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_cut_matches_plain_and_the_uncut_kernel(card, p, spans, f_true,
                                                    kernel, dtype):
    """The cut forced at S = 2, 3, 7 for T = 20, 24, 28, 32 (K7 at f2 =
    32, 64, 96, 128) and K1 at f = 256, on the span-edge grid (spans of
    whole tiles of the pass-1 body: 32 slots on the FMA body of a float32
    table, 64 on the tensor cores of a bf16 one): against the plain cut
    route and against one span a row (spans=1: the uncut kernel of a
    float32 table; with a bf16 table the two passes at S = 1, and the
    uncut kernel on a float32 copy of the table), x within 2e-3 and se
    within 2e-3 + 1e-4 relative; empty rows and dead lanes exactly 0; a
    second run repeats the first bit for bit; the launch counts show the
    two passes, and the uncut kernel only where it ran."""
    tile = 64 if dtype == torch.bfloat16 else 32
    n_spans, span = cs._cut(-(-p // tile), spans, tile)
    assert n_spans == spans
    cpu = cut_chunk(f_true, dtype, p, span, seed=f_true)
    gpu = [t.to(card) for t in cpu]
    pass1 = "wide_span_gram_mma" if dtype == torch.bfloat16 else \
        "wide_span_gram"
    if kernel == "K7":
        f2 = cs.wide_f2(f_true)
        fl, name = 128 + f2, "gather_gram_cg_wide"

        def run(spans, table=gpu[0]):
            return cs.gather_gram_cg_wide(table, *gpu[1:], LAM, f2,
                                          spans=spans)
    else:
        fl, name = 256, "gather_gram_cg"

        def run(spans, table=gpu[0]):
            return cs.gather_gram_cg(table, *gpu[1:], LAM, spans=spans)
    x, se = run(spans)
    torch.cuda.synchronize()
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        pass1: 1, "wide_span_solve": 1}
    px, pse = cs.row_cut_plain(*cpu, LAM, fl, spans, span)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), pse, atol=2e-3, rtol=1e-4)
    ux, use = run(1)
    if dtype == torch.bfloat16:
        assert cs.LAUNCHES[pass1] == 2 and cs.LAUNCHES[name] == 0
        torch.testing.assert_close(x, ux, atol=2e-3, rtol=0)
        torch.testing.assert_close(se, use, atol=2e-3, rtol=1e-4)
        ux, use = run(1, gpu[0].float())
    assert cs.LAUNCHES[name] == 1 and cs.LAUNCHES[pass1] == \
        (2 if dtype == torch.bfloat16 else 1)
    torch.testing.assert_close(x, ux, atol=2e-3, rtol=0)
    torch.testing.assert_close(se, use, atol=2e-3, rtol=1e-4)
    empty = gpu[3] == 0
    assert torch.all(x[empty] == 0) and torch.all(se[empty] == 0)
    assert torch.all(x[:, fl:] == 0)
    x2, se2 = run(spans)
    assert torch.equal(x2, x) and torch.equal(se2, se)


@pytest.mark.parametrize("p,spans", CUTS + [(300, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_at_256_matches_plain_and_repeats(card, p, spans, dtype):
    """K6 (gather_gram_cg(aug=True)) at f = 256, F = 200, lane 255 free:
    one span a row and the cut forced at S = 2, 3, 7, on the span-edge
    grid of `cut_chunk`, a bf16 table (the two passes, pass 1 on the
    tensor cores with the values over lane 255) and a float32 one (the
    passes on the FMA body, or at S = 1 the uncut kernel of
    gather_gram_cg_aug.cu): against the uncut plain version and the plain
    cut route, x within 2e-3 and se within 2e-3 + 1e-4 relative, as K1's
    cut; lane 255 of x, empty rows and the dummy row exactly 0; a second
    run equal bit for bit; each kernel that ran counts its one launch:
    the two passes, or "gather_gram_cg_aug" for the uncut kernel."""
    tile = 64 if dtype == torch.bfloat16 else 32
    n_spans, span = cs._cut(-(-p // tile), spans, tile)
    cpu = cut_chunk(200, dtype, p, span, seed=17)
    gpu = [t.to(card) for t in cpu]
    x, se = cs.gather_gram_cg(*gpu, LAM, aug=True, spans=spans)
    torch.cuda.synchronize()
    pass1 = "wide_span_gram_mma" if dtype == torch.bfloat16 else \
        "wide_span_gram"
    passes = dtype == torch.bfloat16 or n_spans > 1
    want = {pass1: 1, "wide_span_solve": 1} if passes else {
        "gather_gram_cg_aug": 1}
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | want
    px, pse = cs.gather_gram_cg_aug_plain(*cpu, LAM)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), pse, atol=2e-3, rtol=1e-4)
    cx, cse = cs.row_cut_plain(*cpu, LAM, 256, n_spans, span, aug=True)
    torch.testing.assert_close(x.cpu(), cx, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), cse, atol=2e-3, rtol=1e-4)
    empty = gpu[3] == 0
    assert torch.all(x[:, 255] == 0)
    assert torch.all(x[empty] == 0) and torch.all(se[empty] == 0)
    x2, se2 = cs.gather_gram_cg(*gpu, LAM, aug=True, spans=spans)
    assert torch.equal(x2, x) and torch.equal(se2, se)


@pytest.mark.parametrize("fl", [160, 192, 224, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_span_gram_alone_through_the_record_layout(card, fl, dtype):
    """Pass 1 alone against its plain version, read through the tile
    layout of csrc/wide.cuh (`span_record_unpack`): every live span's A
    within `gram_limit`'s steps for its slots in the body that ran (FMA
    for a float32 table, the tensor cores for a bf16 one), b and r2
    within rtol 1e-5 + 1e-5."""
    p, spans = 448, 7
    body = "wgmma" if dtype == torch.bfloat16 else "fma"
    tile = 64 if body == "wgmma" else 32
    n_spans, span = cs._cut(-(-p // tile), spans, tile)
    cpu = cut_chunk(fl, dtype, p, span, seed=fl)
    part = cs.span_grams(*(t.to(card) for t in cpu[:4]), fl, n_spans, span)
    assert cs.gram_body(cpu[0]) == body
    assert cs.LAUNCHES["wide_span_gram_mma" if body == "wgmma" else
                       "wide_span_gram"] == 1
    live = cs._span_live(cpu[3], p, n_spans, span)
    a, b, r2 = cs.span_record_unpack(part.cpu()[live], fl)
    want = [cs.span_gram_plain(*cpu[:4], k * span, (k + 1) * span, fl)
            for k in range(n_spans)]
    pa, pb, pr2 = (torch.stack([w[i] for w in want], dim=1)[live]
                   for i in range(3))
    _assert_gram_close(a, pa, span, body)
    torch.testing.assert_close(b, pb, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(r2, pr2, rtol=1e-5, atol=1e-5)


SPAN_P = (63, 64, 65, 127, 129)           # around the 64-slot tile
SPAN_NNZ = (0, 1, 63, 64, 65)


def span_int_chunk(fl, p, seed=0, n=60):
    """A chunk for the tensor-core pass 1 at the edges of its 64-slot
    tile: a bf16 256-lane table of small integers in lanes < fl and NaN in
    lanes >= fl (which the pass must never read), rows that stop at nnz
    0, 1, 63, 64, 65 (those up to p) and at p, pad slots at each row's
    tail (the zero row n, value 0) and half-integer values, so that every
    sum is exact in f32 in any order. Returns CPU tensors: table, cols,
    vals, nnz."""
    rng = np.random.RandomState(seed + 7 * p + fl)
    table = np.full((n + 1, 256), np.nan, np.float32)
    table[:, :fl] = rng.randint(-4, 5, (n + 1, fl))
    table[n, :fl] = 0.0
    nnz = np.array([k for k in SPAN_NNZ if k <= p] + [p], np.int32)
    r = len(nnz)
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2 * mask
            ).astype(np.float32)
    return (torch.from_numpy(table).to(torch.bfloat16),
            torch.from_numpy(cols), torch.from_numpy(vals),
            torch.from_numpy(nnz))


@pytest.mark.parametrize("p", SPAN_P)
@pytest.mark.parametrize("fl", [160, 192, 224, 256])
@pytest.mark.parametrize("spans", [1, 2])
def test_tensor_core_pass_1_is_exact_on_integer_tables(card, p, fl, spans):
    """The tensor-core pass 1 equals `span_gram_plain` bit for bit on a
    table of small integers (every sum exact): A read through the record
    layout, b and r2, for every live span, at P around the 64-slot tile,
    rows that stop at nnz 0, 1, 63, 64, 65 and P, one span a row and two
    (where P has two tiles), with NaN in the table's lanes >= fl. The
    proof of the three-block tiling, of the record's layout and of the
    zero-fill at the span's and the live lanes' edges."""
    table, cols, vals, nnz = span_int_chunk(fl, p)
    n_spans, span = cs._cut(-(-p // 64), spans, 64)
    part = cs.span_grams(table.to(card), cols.to(card), vals.to(card),
                         nnz.to(card), fl, n_spans, span)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "wide_span_gram_mma": 1}
    live = cs._span_live(nnz, p, n_spans, span)
    a, b, r2 = cs.span_record_unpack(part.cpu()[live], fl)
    want = [cs.span_gram_plain(table, cols, vals, nnz, k * span,
                               (k + 1) * span, fl) for k in range(n_spans)]
    pa, pb, pr2 = (torch.stack([w[i] for w in want], dim=1)[live]
                   for i in range(3))
    assert torch.equal(a, pa) and torch.equal(b, pb) and \
        torch.equal(r2, pr2)


@pytest.mark.parametrize("f_true,kernel", [(130, "K7"), (200, "K7"),
                                           (200, "K1")])
def test_tensor_core_route_ignores_dead_lanes_and_repeats(card, f_true,
                                                          kernel):
    """K7 and K1 at f = 256 on a bf16 table (the two passes, pass 1 on
    the tensor cores, one span a row): the same x and se whether the
    table's lanes >= FL hold zeros or NaN (K7: FL = 128 + f2; K1 at
    f = 256 reads all 256 lanes, so its table is dirtied nowhere), and a
    second run equal to the first bit for bit; within 2e-3 (x) and 2e-3
    + 1e-4 relative (se) of the plain version."""
    cpu = _wide_chunk(f_true, torch.bfloat16, seed=5)
    gpu = [t.to(card) for t in cpu]
    f2 = cs.wide_f2(f_true)

    def run(table):
        if kernel == "K7":
            return cs.gather_gram_cg_wide(table, *gpu[1:], LAM, f2)
        return cs.gather_gram_cg(table, *gpu[1:], LAM)
    x, se = run(gpu[0])
    px, pse = (cs.gather_gram_cg_wide(*cpu, LAM, f2) if kernel == "K7"
               else cs.gather_gram_cg(*cpu, LAM))
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), pse, atol=2e-3, rtol=1e-4)
    x2, se2 = run(gpu[0])
    assert torch.equal(x2, x) and torch.equal(se2, se)
    if kernel == "K7":
        dirty = gpu[0].clone()
        dirty[:, 128 + f2:] = float("nan")
        x3, se3 = run(dirty)
        assert torch.equal(x3, x) and torch.equal(se3, se)
    assert cs.LAUNCHES["wide_span_gram_mma"] == (3 if kernel == "K7" else 2)


def _unpinned(monkeypatch):
    """Every `full_f32` pin of the port's host products made a no-op: the
    port as it would be without them (a reading, not a route)."""
    import contextlib

    from cumf_als_tpu_torch.models import als as als_mod
    from cumf_als_tpu_torch.ops import gram, rmse, solve
    for mod in (als_mod, gram, rmse, solve):
        monkeypatch.setattr(mod, "full_f32", contextlib.nullcontext)


@pytest.mark.parametrize("route", ["panel", "xla"])
def test_tf32_does_not_reach_the_f32_sums(card, monkeypatch, route):
    """With TF32 switched on for float32 matrix products, train RMSE at
    scale 0.01 is what it is with TF32 off; the caller's switch is as it
    was. "panel": the pallas panel route (f32 split accumulators, whose
    train error `_se_terms` forms with a batched matrix-vector product),
    within 1e-5 (the card's f32 index_add_ adds in an order that changes
    from run to run). "xla": the direct routes of backend "xla"
    (`gram_rhs`, the plain `solve_cg`, `fused_sq_err`), bit for bit, and
    with the pins removed (`_unpinned`) TF32 moves it: the Gram's batched
    product runs in TF32 when allowed. Both readings are printed."""
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   workload_ratings)
    from cumf_als_tpu_torch.models.als import ALS
    from cumf_als_tpu_torch.ops.tiling import PanelPlan, UpdatePlan
    train, test = workload_ratings("netflix", scale=0.01, seed=1)
    cfg = NETFLIX.replace(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
                          nnz_test=test.nnz, iters=2, backend="pallas",
                          solver="cg", factor_dtype="f32", gram_dtype="f32",
                          aug_gram="off", verbose=False, debug_timing=False)
    cfg = cfg.replace(panel_size=2048) if route == "panel" else \
        cfg.replace(backend="xla")
    x0, th0 = init_factors(cfg.m, cfg.n, cfg.f, seed=0)
    model = ALS(cfg, train, None, test, device=card)
    assert isinstance(model.plan_x[0],
                      PanelPlan if route == "panel" else UpdatePlan)
    off = [h.train_rmse for h in model.run(x0, th0).history]
    legacy = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        on = [h.train_rmse for h in model.run(x0, th0).history]
        assert torch.backends.cuda.matmul.allow_tf32 is True
        _unpinned(monkeypatch)
        bare = [h.train_rmse for h in model.run(x0, th0).history]
    finally:
        torch.set_float32_matmul_precision(legacy)
    print(f"[tf32 rmse] {route}: train RMSE by iteration: TF32 off {off}; "
          f"TF32 on {on}; TF32 on without the pins {bare}; max |on - off| "
          f"{max(abs(u - v) for u, v in zip(on, off)):.3e}, without the "
          f"pins {max(abs(u - v) for u, v in zip(bare, off)):.3e}",
          flush=True)
    if route == "panel":
        assert np.allclose(on, off, rtol=0, atol=1e-5), (on, off)
    else:
        assert on == off and bare != off, (on, off, bare)


def _products(card):
    """The four pinned host products on seeded card tensors (512 rows of
    256 slots, f = 128): name -> call."""
    from cumf_als_tpu_torch.models import als as als_mod
    from cumf_als_tpu_torch.ops import gram, rmse, solve
    rng = np.random.default_rng(7)
    r, p, f, n = 512, 256, 128, 4096
    table = (rng.standard_normal((n + 1, f)) * 0.3).astype(np.float32)
    table[n] = 0.0
    cols = rng.integers(0, n + 1, (r, p)).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    x = (rng.standard_normal((r, f)) * 0.1).astype(np.float32)
    table, cols, vals, x = (torch.from_numpy(t).to(card)
                            for t in (table, cols, vals, x))
    nnz = torch.full((r,), p, dtype=torch.int32, device=card)
    a, b = gram.gram_rhs(table, cols, vals, nnz, LAM)
    return {
        "gram_rhs": lambda: gram.gram_rhs(table, cols, vals, nnz, LAM),
        "fused_sq_err": lambda: rmse.fused_sq_err(a, b, vals, nnz, LAM, x),
        "solve_cg": lambda: solve.solve_cg(a, b, x),
        "_se_terms": lambda: als_mod._se_terms(a, b, x, 128),
    }


@pytest.mark.parametrize("name", ["gram_rhs", "fused_sq_err", "solve_cg",
                                  "_se_terms"])
def test_tf32_does_not_reach_a_pinned_product(card, monkeypatch, name):
    """Each pinned host product gives, with TF32 switched on, what it
    gives with TF32 off, bit for bit (the same full-f32 cuBLAS call on the
    same inputs). With its pin removed (`_unpinned`) `gram_rhs`, a
    batched matrix product, differs under TF32: the pin is what holds it.
    The other three are batched matrix-vector products, which cuBLAS ran
    without TF32 on an H100 either way (PERF.md): for them the pin
    guards against another library's choice, and only the reading is
    printed."""
    with torch.no_grad():
        call = _products(card)[name]
        legacy = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            off = call()
            torch.backends.cuda.matmul.allow_tf32 = True
            on = call()
            _unpinned(monkeypatch)
            bare = call()
        finally:
            torch.set_float32_matmul_precision(legacy)
    off, on, bare = ([t.float() for t in (v if isinstance(v, tuple) else (v,))]
                     for v in (off, on, bare))

    def rel(u, v):
        return max(((a - b).abs().max() / b.abs().max()).item()
                   for a, b in zip(u, v))

    print(f"[tf32 product] {name}: TF32 on, pinned: max rel diff "
          f"{rel(on, off):.3e}; pin removed: {rel(bare, off):.3e}",
          flush=True)
    assert all(torch.equal(u, v) for u, v in zip(on, off))
    if name == "gram_rhs":
        assert not all(torch.equal(u, v) for u, v in zip(bare, off))


# ---------- K3 on its persistent, bulk-async design (csrc/bulk_cg.cuh) --
def k3_systems(r, f, dtype, seed=0):
    """R regularized systems on the CPU: A = M M^T (M of f/4 + 1 columns,
    so the CG has work to do), stored in `dtype`, diag 0.5 to 2, b and a
    warm start."""
    rng = np.random.RandomState(seed + f)
    m = rng.standard_normal((r, f, f // 4 + 1)).astype(np.float32) * (
        2.0 / np.sqrt(f))
    a = torch.from_numpy(np.einsum("rik,rjk->rij", m, m)).to(dtype)
    diag = torch.from_numpy(rng.uniform(0.5, 2.0, r).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((r, f)).astype(np.float32))
    x0 = torch.from_numpy((rng.standard_normal((r, f)) * 0.1
                           ).astype(np.float32))
    return a, diag, b, x0


def _k3_grid(card, f, dtype):
    return cs.cg_grid(1 << 30, cs._sms(card),
                      cs.cg_blocks_per_sm(card, f, dtype, "solve_cg_reg"))


@pytest.mark.parametrize("f,dtype,least,most", [
    (128, torch.bfloat16, 2, 2), (128, torch.float32, 1, 1),
    (112, torch.float32, 2, 2), (96, torch.float32, 3, 3),
    (16, torch.float32, 2, 8), (64, torch.bfloat16, 2, 8)])
def test_k3_blocks_per_sm(card, f, dtype, least, most):
    """The kernel's occupancy query: at least two blocks an SM (its
    launch bounds) unless two rings of two stages of A, b and x0 pass
    half the SM's 228 KB, as an f32 A at f = 128 does (2 x 65.5 KB of
    stages a block: one block); more where a block's registers and
    stages leave room (three at f = 96 with an f32 A), at most the SM's
    2,048 threads. It launches nothing."""
    assert least <= cs.cg_blocks_per_sm(card, f, dtype,
                                        "solve_cg_reg") <= most
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0)


@pytest.mark.parametrize("f", list(range(16, 129, 16)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain_at_every_width(card, f, dtype):
    """K3 against `solve_cg_reg_plain` (x within 2e-3) at every f it
    takes, with a bf16 and a float32 A; one launch."""
    cpu = k3_systems(40, f, dtype)
    x = cs.solve_cg_reg(*(t.to(card) for t in cpu))
    px = cs.solve_cg_reg(*cpu)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {"solve_cg_reg": 1}


@pytest.mark.parametrize("f", [48, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["one", "below", "equal", "above",
                                   "thrice"])
def test_k3_around_the_persistent_grid(card, f, dtype, where):
    """R = 1, and R one below, equal to, one above and about three times
    the persistent grid (every block walks one system, some one more, or
    three or four), at f = 128, where a float32 A holds one block an SM
    and a bf16 one two, and at f = 48, where more fit; within 2e-3 of
    the plain version."""
    grid = _k3_grid(card, f, dtype)
    r = {"one": 1, "below": grid - 1, "equal": grid, "above": grid + 1,
         "thrice": 3 * grid + 5}[where]
    cpu = k3_systems(r, f, dtype, seed=r)
    x = cs.solve_cg_reg(*(t.to(card) for t in cpu))
    px = cs.solve_cg_reg(*cpu)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)


@pytest.mark.parametrize("f", [48, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_zero_and_nan_systems_iters_0_and_repeat(card, f, dtype):
    """An all-zero system with diag 0 returns its x0 exactly (p.Ap = 0,
    alpha 0); a NaN in one system leaves that system all NaN and the
    others as the plain version has them; cg_iters 0 returns x0 exactly;
    a second run equals the first bit for bit (over more systems than the
    persistent grid, so blocks walk several)."""
    r = _k3_grid(card, f, dtype) + 7
    a, diag, b, x0 = k3_systems(r, f, dtype, seed=3)
    a[2] = 0.0
    diag[2] = 0.0
    a[4, 5, 7] = float("nan")
    gpu = [t.to(card) for t in (a, diag, b, x0)]
    x = cs.solve_cg_reg(*gpu)
    assert torch.equal(x[2].cpu(), x0[2])
    assert bool(torch.isnan(x[4]).all())
    px = cs.solve_cg_reg(a, diag, b, x0)
    keep = torch.ones(r, dtype=torch.bool)
    keep[4] = False
    torch.testing.assert_close(x.cpu()[keep], px[keep], atol=2e-3, rtol=0)
    again = cs.solve_cg_reg(*gpu)      # (NaN equals nothing, so row 4 apart)
    assert torch.equal(again[keep.to(card)], x[keep.to(card)])
    assert bool(torch.isnan(again[4]).all())
    x_0 = cs.solve_cg_reg(*gpu, cg_iters=0)
    assert torch.equal(x_0.cpu(), x0)
    assert torch.equal(cs.solve_cg_reg(a, diag, b, x0, cg_iters=0), x0)


def test_k3_takes_storage_on_16_byte_boundaries_only(card):
    """The bulk copies need each system's bytes on 16-byte boundaries:
    a view that starts 4 bytes past one raises before any launch."""
    a, diag, b, x0 = (t.to(card) for t in k3_systems(4, 16, torch.float32))
    flat = torch.zeros(a.numel() + 1, device=card)
    shifted = flat[1:].view(a.shape)
    shifted.copy_(a)
    with pytest.raises(ValueError, match="16-byte"):
        cs.solve_cg_reg(shifted, diag, b, x0)
    assert cs.LAUNCHES["solve_cg_reg"] == 0


# ------------------- K3, K4 and K5b: one body (csrc/bulk_cg.cuh) ------
SOLVES = ("solve_cg_reg", "solve_cg", "solve_cg_aug")


def solve_args(kernel, cpu):
    """The arguments of `kernel` from k3_systems' (a, diag, b, x0): K4
    takes A + diag I and b; K5b takes A' = A with b in row f - 1 (and
    its column) and the diagonal, and x0 with lane f - 1 zero."""
    a, diag, b, x0 = cpu
    f = a.shape[-1]
    if kernel == "solve_cg_reg":
        return a, diag, b, x0
    if kernel == "solve_cg":
        return (a.float() + diag[:, None, None] * torch.eye(f)).to(
            a.dtype), b, x0
    aug = a.clone()
    aug[:, f - 1, :] = b.to(a.dtype)
    aug[:, :, f - 1] = b.to(a.dtype)
    x0 = x0.clone()
    x0[:, f - 1] = 0.0
    return aug, diag, x0


def run_solve(kernel, args, **kw):
    return getattr(cs, kernel)(*args, **kw)


def in_flight(card, f, dtype, kernel):
    """The systems one launch of `kernel` holds at once: a block each, or
    at f = 256 a cluster of two blocks each."""
    grid = cs.solve_grid(card, 1 << 30, f, dtype, kernel)
    return grid // 2 if f == 256 else grid


@pytest.mark.parametrize("kernel", SOLVES)
@pytest.mark.parametrize("f", list(range(16, 129, 16)) + [256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_solves_match_plain_at_every_width(card, kernel, f, dtype):
    """K3, K4 and K5b against their plain versions (x within 2e-3) at
    every f they take, f = 256 included, with a bf16 and a float32 A;
    one launch, on a grid of the kernel's own occupancy query; K5b's
    lane f - 1 of x exactly 0."""
    cpu = solve_args(kernel, k3_systems(40, f, dtype))
    x = run_solve(kernel, [t.to(card) for t in cpu])
    px = run_solve(kernel, cpu)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    if kernel == "solve_cg_aug":
        assert bool((x[:, f - 1] == 0).all())
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {kernel: 1}


@pytest.mark.parametrize("kernel", SOLVES)
@pytest.mark.parametrize("f", [128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_solves_zero_systems_iters_0_repeat_and_grid(card, kernel, f,
                                                     dtype):
    """Over more systems than the persistent grid holds in flight: an
    all-zero system (K3 and K5b with diag 0) returns its x0 exactly;
    cg_iters 0 returns x0 exactly; a second run equals the first bit for
    bit; the kernel's occupancy query gives at least one block an SM (at
    f = 256 at least one cluster of two blocks, and no more than two
    blocks an SM: an f32 tile takes one, a bf16 tile two)."""
    per_sm = cs.cg_blocks_per_sm(card, f, dtype, kernel)
    assert per_sm >= 1
    if f == 256:
        assert per_sm <= cs._sms(card) * (2 if dtype == torch.bfloat16
                                          else 1) // 2
    r = in_flight(card, f, dtype, kernel) + 7
    a, diag, b, x0 = k3_systems(r, f, dtype, seed=4)
    a[2] = 0.0
    diag[2] = 0.0
    b[2] = 0.0
    args = solve_args(kernel, (a, diag, b, x0))
    gpu = [t.to(card) for t in args]
    x = run_solve(kernel, gpu)
    x0_used = args[-1]
    assert torch.equal(x[2].cpu(), x0_used[2])
    torch.testing.assert_close(x.cpu(), run_solve(kernel, args), atol=2e-3,
                               rtol=0)
    assert torch.equal(run_solve(kernel, gpu), x)
    assert torch.equal(run_solve(kernel, gpu, cg_iters=0).cpu(), x0_used)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5b_at_256_reads_b_from_row_255(card, dtype):
    """K5b at f = 256 on an A' whose row 255 (b) and column 255 differ:
    b comes from the row, which only the second block of a cluster holds
    (pallas_solve.py:_cg_solve_aug_kernel reads row f - 1); within 2e-3
    of the plain version, lane 255 exactly 0, bits repeating. A kernel
    reading the column would solve for another b."""
    a, diag, b, x0 = k3_systems(40, 256, dtype, seed=5)
    aug, diag, x0 = solve_args("solve_cg_aug", (a, diag, b, x0))
    rng = np.random.RandomState(6)
    aug[:, :255, 255] = torch.from_numpy(
        rng.standard_normal((40, 255)).astype(np.float32)).to(dtype)
    assert not torch.equal(aug[:, 255, :255], aug[:, :255, 255])
    gpu = [t.to(card) for t in (aug, diag, x0)]
    x = cs.solve_cg_aug(*gpu)
    px = cs.solve_cg_aug(aug, diag, x0)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    assert bool((x[:, 255] == 0).all())
    assert torch.equal(cs.solve_cg_aug(*gpu), x)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "solve_cg_aug": 2}


@pytest.mark.parametrize("kernel", SOLVES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_solves_at_256_stop_at_different_steps(card, kernel, dtype):
    """K3, K4 and K5b at f = 256 with a cg_tol that stops the systems of
    one launch at different steps: b and x0 scaled by 1e-5 (r.r below
    the tolerance from the start: the first step's update, then the
    exit), 3e-3 (a few steps) and 1 (never, in 20). Both blocks of a
    cluster must take the same exit, or the launch hangs at the next
    exchange (and traps). Held to the plain version with x scaled back,
    x within 2e-3; bits repeating."""
    _stop_at_different_steps(card, kernel, 256, dtype,
                             3 * in_flight(card, 256, dtype, kernel) + 5)


def _stop_at_different_steps(card, kernel, f, dtype, r):
    """The early-exit check of `test_solves_at_256_stop_at_different_steps`
    on R systems at width f."""
    a, diag, b, x0 = k3_systems(r, f, dtype, seed=7)
    scale = torch.tensor([1e-5, 3e-3, 1.0]).repeat(r // 3 + 1)[:r]
    args = solve_args(kernel, (a, diag, b * scale[:, None],
                               x0 * scale[:, None]))
    kw = dict(cg_iters=20, cg_tol=1e-6)
    gpu = [t.to(card) for t in args]
    x = run_solve(kernel, gpu, **kw)
    px = run_solve(kernel, args, **kw)
    torch.testing.assert_close(x.cpu() / scale[:, None],
                               px / scale[:, None], atol=2e-3, rtol=0)
    assert torch.equal(run_solve(kernel, gpu, **kw), x)
    # the tolerance does stop systems early: never stopping moves x
    full = run_solve(kernel, args, cg_iters=20, cg_tol=0.0)
    assert not torch.equal(full, px)


@pytest.mark.parametrize("kernel", SOLVES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["one", "three", "above"])
def test_solves_at_256_around_the_cluster_grid(card, kernel, dtype, where):
    """K3, K4 and K5b at f = 256 on R = 1 and 3 systems (a grid of 2 and
    6 blocks) and on one more system than the clusters in flight (one
    cluster walks two); within 2e-3 of the plain version, one launch,
    bits repeating."""
    r = {"one": 1, "three": 3,
         "above": in_flight(card, 256, dtype, kernel) + 1}[where]
    assert cs.solve_grid(card, r, 256, dtype, kernel) == 2 * min(
        r, cs.cg_blocks_per_sm(card, 256, dtype, kernel))
    args = solve_args(kernel, k3_systems(r, 256, dtype, seed=r))
    gpu = [t.to(card) for t in args]
    x = run_solve(kernel, gpu)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {kernel: 1}
    torch.testing.assert_close(x.cpu(), run_solve(kernel, args), atol=2e-3,
                               rtol=0)
    assert torch.equal(run_solve(kernel, gpu), x)


# ------------------------- K8 on the two passes of the row cut (bf16 G) --
def cat_slabs(table, cols, f2):
    """G of a chunk gathered from a 256-lane table into K8's two slabs."""
    r, p = cols.shape
    g = table.index_select(0, cols.reshape(-1).long()).reshape(r, p, 256)
    return g[:, :, :128].contiguous(), g[:, :, 128:128 + f2].contiguous()


def _se_rel(se, pse):
    return ((se - pse).abs() / pse.abs().clamp_min(1.0)).max().item()


@pytest.mark.parametrize("f2", [32, 96, 128])
@pytest.mark.parametrize("spans", [1, 2, 5])
def test_cat_two_passes_equal_k1_at_256_routed(card, f2, spans):
    """K8 on a bf16 G gathered from a bf16 table (zeros past nnz) equals
    K1 at f = 256 as routed on that table, forced to the same spans, bit
    for bit (`torch.equal`; -0 equals +0: K8 adds zero records where K1
    has none); both within 2e-3 (x) and 1e-3 relative (se) of the plain
    version. The call launches the two passes once each and never the
    FMA kernel (`fused_gram_cg_cat`'s counter stays 0)."""
    table, cols, vals, nnz, x0 = cut_chunk(128 + f2, torch.bfloat16, 300,
                                           64, seed=f2)
    g1, g2 = cat_slabs(table, cols, f2)
    gpu = [t.to(card) for t in (table, cols, vals, nnz, x0, g1, g2)]
    x1, se1 = cs.gather_gram_cg(*gpu[:5], LAM, spans=spans)
    cs.reset_launch_counts()
    x8, se8 = cs.fused_gram_cg_cat(gpu[5], gpu[6], *gpu[2:5], LAM,
                                   spans=spans)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "wide_span_gram_mma": 1, "wide_span_solve": 1}
    assert torch.equal(x8, x1) and torch.equal(se8, se1)
    px, pse = cs.fused_gram_cg_cat(g1, g2, vals, nnz, x0, LAM)
    torch.testing.assert_close(x8.cpu(), px, atol=2e-3, rtol=0)
    assert _se_rel(se8.cpu(), pse) <= 1e-3


@pytest.mark.parametrize("f2", [32, 64, 96, 128])
def test_cat_sums_the_slots_past_nnz(card, f2):
    """A G and values that are not zero past nnz: K8 sums every one of
    the P slots (nnz sets only the regularizer and the mask), as
    `_kernel_cat` and the plain version do, and matches the plain
    version there (x 2e-3, se 1e-3 relative), at S = 1 and 4; a row with
    nnz 0 still solves to x = 0."""
    rng = np.random.RandomState(f2)
    r, p = 12, 200
    g1 = torch.from_numpy((rng.standard_normal((r, p, 128)) * 0.3
                           ).astype(np.float32)).bfloat16()
    g2 = torch.from_numpy((rng.standard_normal((r, p, f2)) * 0.3
                           ).astype(np.float32)).bfloat16()
    vals = torch.from_numpy((np.round(rng.uniform(1, 5, (r, p)) * 2) / 2
                             ).astype(np.float32))
    nnz = torch.from_numpy(rng.randint(1, p, r).astype(np.int32))
    nnz[3] = 0
    x0 = torch.from_numpy((rng.standard_normal((r, 256)) * 0.1
                           ).astype(np.float32))
    cpu = (g1, g2, vals, nnz, x0)
    px, pse = cs.fused_gram_cg_cat(*cpu, LAM)
    for spans in (1, 4):
        x, se = cs.fused_gram_cg_cat(*(t.to(card) for t in cpu), LAM,
                                     spans=spans)
        torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
        assert _se_rel(se.cpu(), pse) <= 1e-3
        assert torch.all(x[3] == 0)
    assert cs.LAUNCHES["wide_span_gram_mma"] == 2
    assert cs.LAUNCHES["fused_gram_cg_cat"] == 0


@pytest.mark.parametrize("dtype,f2", [(torch.float32, 96),
                                      (torch.bfloat16, 40)])
def test_cat_float32_or_odd_f2_takes_the_fma_kernel(card, dtype, f2):
    """A float32 G, or a bf16 G whose f2 is not a multiple of 32, takes
    the uncut FMA kernel of csrc/fused_gram_cg_cat.cu (its own counter
    alone), within 2e-3 of the plain version; `spans` cannot cut it."""
    table, cols, vals, nnz, x0 = cut_chunk(128 + f2, dtype, 300, 64)
    g1, g2 = cat_slabs(table, cols, f2)
    assert cs.cat_body(dtype, f2) == "fma"
    gpu = [t.to(card) for t in (g1, g2, vals, nnz, x0)]
    x, se = cs.fused_gram_cg_cat(*gpu, LAM)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "fused_gram_cg_cat": 1}
    px, pse = cs.fused_gram_cg_cat(g1, g2, vals, nnz, x0, LAM)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    assert _se_rel(se.cpu(), pse) <= 1e-3
    with pytest.raises(ValueError, match="spans"):
        cs.fused_gram_cg_cat(*gpu, LAM, spans=2)


@pytest.mark.parametrize("p", SPAN_P)
@pytest.mark.parametrize("f2", [32, 64, 96, 128])
@pytest.mark.parametrize("spans", [1, 2])
def test_packed_pass_1_is_exact_on_integer_g(card, p, f2, spans):
    """Pass 1 on a packed bf16 G of small integers equals
    `cat_span_gram_plain` bit for bit (every sum exact): A read through
    the record layout, b and r2, for every span, at P around the 64-slot
    tile, with G and values not zero past nnz (the pass sums every slot
    up to P). The proof of the slabs' addressing and of the zero-fill
    above 128 + f2."""
    rng = np.random.RandomState(p + f2)
    r = 5
    g1 = torch.from_numpy(rng.randint(-4, 5, (r, p, 128)).astype(
        np.float32)).bfloat16()
    g2 = torch.from_numpy(rng.randint(-4, 5, (r, p, f2)).astype(
        np.float32)).bfloat16()
    vals = torch.from_numpy((np.round(rng.uniform(1, 5, (r, p)) * 2) / 2
                             ).astype(np.float32))
    n_spans, span = cs._cut(-(-p // 64), spans, 64)
    part = cs.cat_span_grams(g1.to(card), g2.to(card), vals.to(card),
                             n_spans, span)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "wide_span_gram_mma": 1}
    a, b, r2 = cs.span_record_unpack(part.cpu(), 256)
    want = [cs.cat_span_gram_plain(g1, g2, vals, k * span, (k + 1) * span)
            for k in range(n_spans)]
    pa, pb, pr2 = (torch.stack([w[i] for w in want], dim=1)
                   for i in range(3))
    assert torch.equal(a, pa) and torch.equal(b, pb) and \
        torch.equal(r2, pr2)


@pytest.mark.parametrize("factor_dtype", ["bf16", "f32"])
def test_out_of_core_on_the_card_matches_the_cpu(card, factor_dtype):
    """OutOfCoreALS on the card against the same run on the CPU (the
    kernels' plain versions), with panels of 16 X rows and X chunks of at
    most 32 rows, so the two table buffers and the two chunk slots turn
    over many times in a phase: a buffer refilled while a kernel still
    reads it shows as a theta or x that is wrong on the card only. K1, K2
    and K3 each launch as often as the plans say."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    cfg = ALSConfig(m=300, n=220, f=100, lam=0.5, iters=3, verbose=False,
                    debug_timing=False, panel_size=16, chunk_nnz=1 << 9,
                    chunk_rows=32, factor_dtype=factor_dtype,
                    gram_dtype="f32", backend="pallas", solver="cg")
    x0, th0 = init_factors(300, 220, 100, seed=2)
    model = OutOfCoreALS(cfg, train, None, test, device=card)
    assert model.x_store.is_pinned() and model.plan_theta.n_panels == 19
    res = model.run(x0, th0)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_cg": 3 * len(model.plan_x.chunks),
        "gather_gram_out": 3 * len(model.plan_theta.chunks),
        "solve_cg_reg": 3 * model.n_slices}
    ref = OutOfCoreALS(cfg, train, None, test, device="cpu").run(x0, th0)
    for a, b in zip(ref.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-4)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-4)
    np.testing.assert_allclose(res.x, ref.x, atol=2e-3)
    np.testing.assert_allclose(res.theta, ref.theta, atol=2e-3)


def test_out_of_core_at_f_200_aug_force_on_the_card(card):
    """OutOfCoreALS at F = 200 (f_pad 256) with aug_gram="force" on the
    card against the same run on the CPU, as the test above: the X
    chunks through K6 at f = 256 (the two passes on the bf16 table, at
    least one launch each a chunk; K6 counts none of its own), theta
    through K2 and K3 at 256."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    cfg = ALSConfig(m=300, n=220, f=200, lam=0.5, iters=3, verbose=False,
                    debug_timing=False, panel_size=16, chunk_nnz=1 << 9,
                    chunk_rows=32, factor_dtype="bf16", gram_dtype="f32",
                    aug_gram="force", backend="pallas", solver="cg")
    assert cs.aug_enabled(cfg)
    x0, th0 = init_factors(300, 220, 200, seed=2)
    model = OutOfCoreALS(cfg, train, None, test, device=card)
    res = model.run(x0, th0)
    got = {k: v for k, v in cs.LAUNCHES.items() if k not in K1_PASSES}
    assert got == dict.fromkeys(got, 0) | {
        "gather_gram_out": 3 * len(model.plan_theta.chunks),
        "solve_cg_reg": 3 * model.n_slices}
    assert cs.LAUNCHES["wide_span_gram_mma"] == \
        cs.LAUNCHES["wide_span_solve"] >= 3 * len(model.plan_x.chunks)
    ref = OutOfCoreALS(cfg, train, None, test, device="cpu").run(x0, th0)
    for a, b in zip(ref.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-4)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-4)
    np.testing.assert_allclose(res.x, ref.x, atol=2e-3)
    np.testing.assert_allclose(res.theta, ref.theta, atol=2e-3)


# K1 at f = 256 on a bf16 table runs as the two passes of its row cut,
# each counted under its own name, as often as the row batches set
K1_PASSES = ("wide_span_gram_mma", "wide_span_solve")


@pytest.mark.parametrize("x_route", ["panel", "direct"])
def test_sharded_world_one_at_f_200_aug_force_on_the_card(card, x_route):
    """ShardedALS at one rank, F = 200 with aug_gram="force", on the card
    against the same run on the CPU: theta's reduce blocks through K6 at
    f = 256 (the two passes, at least one launch each a block; K6 counts
    none of its own); X on the panel route
    through K5a and K5b at 256 (f32 accumulators, panels of 16 theta
    rows), or with the default panel size on the direct route through
    K6 at 256 as well."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.parallel.sharded_als import ShardedALS
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    panel = dict(panel_size=16) if x_route == "panel" else {}
    cfg = ALSConfig(m=300, n=220, f=200, lam=0.5, iters=3, verbose=False,
                    debug_timing=False, chunk_nnz=1 << 9, chunk_rows=32,
                    factor_dtype="bf16", gram_dtype="f32",
                    aug_gram="force", backend="pallas", solver="cg",
                    **panel)
    x0, th0 = init_factors(300, 220, 200, seed=2)
    model = ShardedALS(cfg, train, None, test, block_rows=32, device=card)
    assert (model.x_steps is not None) == (x_route == "panel")
    assert model.single_fused()
    res = model.run(x0, th0)
    got = {k: v for k, v in cs.LAUNCHES.items() if k not in K1_PASSES}
    if x_route == "panel":
        slices = model._x_m_pad // model._x_solve_batch
        want = {"gather_gram_aug_out": 3 * len(model.x_steps),
                "solve_cg_aug": 3 * slices}
        k6_chunks = 3 * len(model.reduce_plan.blocks)
    else:
        want = {}
        k6_chunks = 3 * (len(model.reduce_plan.blocks) +
                         len(model._x_chunks))
    assert got == dict.fromkeys(got, 0) | want
    assert cs.LAUNCHES["wide_span_gram_mma"] == \
        cs.LAUNCHES["wide_span_solve"] >= k6_chunks
    ref = ShardedALS(cfg, train, None, test, block_rows=32,
                     device="cpu").run(x0, th0)
    for a, b in zip(ref.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-4)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-4)
    np.testing.assert_allclose(res.x, ref.x, atol=2e-3)
    np.testing.assert_allclose(res.theta, ref.theta, atol=2e-3)


def _counted_at_f384(want):
    """The plans' counts `want` (under the names of the f <= 256 kernels)
    as the launch counters see them at f_pad >= 384, every chunk within
    one row batch of `cs.tiled_batch_rows`: each Gram (K1's and K6's pass
    1, K2, K5a) under tile_gram, each solve (their pass 2, K3, K4, K5b)
    under global_cg."""
    fused = want.get("gather_gram_cg", 0) + want.get("gather_gram_cg_aug", 0)
    gram = fused + want.get("gather_gram_out", 0) + \
        want.get("gather_gram_aug_out", 0)
    cg = fused + sum(want.get(k, 0) for k in SOLVES)
    return {k: v for k, v in (("tile_gram", gram), ("global_cg", cg)) if v}


def _launched_as_planned(want, f):
    """cs.LAUNCHES against the plans' counts `want`, every other kernel
    none: exact at f_pad = 128; at f_pad = 256 K1's count (under
    gather_gram_cg in `want`) goes to the two passes of its row cut,
    which must both launch where K1 runs, and every other count is
    exact; at f_pad >= 384 every count goes to the two kernels there
    (`_counted_at_f384`)."""
    if f > 256:
        assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | \
            _counted_at_f384(want)
        return
    if f <= 128:
        assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | want
        return
    k1 = want.pop("gather_gram_cg", 0)
    got = {k: v for k, v in cs.LAUNCHES.items() if k not in K1_PASSES}
    assert got == dict.fromkeys(got, 0) | want
    assert all((cs.LAUNCHES[k] > 0) == (k1 > 0) for k in K1_PASSES)


@pytest.mark.parametrize("gram_dtype", ["bf16", "f32"])
@pytest.mark.parametrize("f", [100, 200, 300])
def test_sharded_world_one_on_the_card_matches_the_cpu(card, gram_dtype, f):
    """ShardedALS at one rank on the card against the same run on the CPU,
    with X on the panel route (panels of 16 theta rows) and theta in
    reduce blocks of 32 rows solved by K1: bf16 accumulators take K2 and
    K3, f32 ones the augmented K5a and K5b. Each kernel launches as often
    as the plans say; two ranks on the card (gloo, both on cuda:0) match
    two ranks on the CPU, theta equal bit for bit on the two ranks. At
    F = 200 (f_pad = 256) every kernel of the two routes runs at 256
    lanes; at F = 300 (f_pad = 384) at 384, on tile_gram and
    global_cg."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.parallel.mesh import spawn
    from cumf_als_tpu_torch.parallel.sharded_als import ShardedALS, run_rank
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    cfg = ALSConfig(m=300, n=220, f=f, lam=0.5, iters=3, verbose=False,
                    debug_timing=False, panel_size=16, chunk_nnz=1 << 9,
                    chunk_rows=32, factor_dtype="bf16",
                    gram_dtype=gram_dtype, backend="pallas", solver="cg")
    x0, th0 = init_factors(300, 220, f, seed=2)
    model = ShardedALS(cfg, train, None, test, block_rows=32, device=card)
    assert model.x_steps is not None and model.single_fused()
    res = model.run(x0, th0)
    gram, sol = ("gather_gram_out", "solve_cg_reg") if gram_dtype == \
        "bf16" else ("gather_gram_aug_out", "solve_cg_aug")
    slices = model._x_m_pad // model._x_solve_batch
    _launched_as_planned({
        "gather_gram_cg": 3 * len(model.reduce_plan.blocks),
        gram: 3 * len(model.x_steps), sol: 3 * slices}, f)
    ref = ShardedALS(cfg, train, None, test, block_rows=32,
                     device="cpu").run(x0, th0)
    for a, b in zip(ref.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-4)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-4)
    np.testing.assert_allclose(res.x, ref.x, atol=2e-3)
    np.testing.assert_allclose(res.theta, ref.theta, atol=2e-3)
    two = spawn(2, run_rank, cfg, (train, test), x0, th0, 32,
                backend="gloo", device="cuda:0")
    ref2 = spawn(2, run_rank, cfg, (train, test), x0, th0, 32,
                 device="cpu")
    assert two[0]["theta_sha256"] == two[1]["theta_sha256"]
    for a, b in zip(ref2[0]["history"], two[0]["history"]):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-4)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-4)
    np.testing.assert_allclose(two[0]["theta"], ref2[0]["theta"], atol=2e-3)
    for r in two:   # at two ranks theta takes partials: no K1
        want = {gram: 3 * (r["x_steps"] + r["n_blocks"]),
                sol: 3 * (r["x_slices"] + r["n_blocks"])}
        assert r["launches"] == dict.fromkeys(cs.LAUNCHES, 0) | (
            want if f <= 256 else _counted_at_f384(want))


@pytest.mark.parametrize("place", ["host", "device"])
@pytest.mark.parametrize("f", [100, 200, 300])
def test_sharded_ooc_on_the_card_matches_the_cpu(card, place, f,
                                                 monkeypatch):
    """ShardedOutOfCoreALS at one rank on the card against the same run on
    the CPU, with panels of 16 X rows and X chunks of at most 32 rows (the
    table buffers and chunk slots turn over many times a phase). X on the
    host: K1 on the X chunks, K2 on the theta steps, K3 once an iteration
    over all of theta. X on the card: K1 on the X chunks and on theta's
    rows against the device X, and with THETA_SEG_W = 64 the hot columns'
    segments by K2 (f32 A) and their solve by K3. Each kernel launches as
    often as the plans say. At F = 200 (f_pad = 256) K1 takes the two
    passes of its row cut, K2 and K3 their 256-lane bodies; at F = 300
    (f_pad = 384) every one runs on tile_gram and global_cg."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.parallel import sharded_ooc as so
    monkeypatch.setattr(so.ShardedOutOfCoreALS, "THETA_SEG_W", 64)
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    cfg = ALSConfig(m=300, n=220, f=f, lam=0.5, iters=3, verbose=False,
                    debug_timing=False, panel_size=16, chunk_nnz=1 << 9,
                    chunk_rows=32, factor_dtype="bf16", gram_dtype="f32",
                    backend="pallas", solver="cg", x_placement=place)
    x0, th0 = init_factors(300, 220, f, seed=2)
    model = so.ShardedOutOfCoreALS(cfg, train, None, test, device=card)
    res = model.run(x0, th0)
    n_x = len(model.row_plan.chunks)
    if place == "host":
        assert model.x_store.is_pinned() and model.n_panels == 19
        want = {"gather_gram_cg": 3 * n_x,
                "gather_gram_out": 3 * len(model.theta_steps),
                "solve_cg_reg": 3}
    else:
        assert model._hot_chunks and model.x_store is None
        want = {"gather_gram_cg": 3 * (n_x + len(model.th_plan.chunks)),
                "gather_gram_out": 3 * len(model._hot_chunks),
                "solve_cg_reg": 3}
    _launched_as_planned(want, f)
    ref = so.ShardedOutOfCoreALS(cfg, train, None, test,
                                 device="cpu").run(x0, th0)
    for a, b in zip(ref.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-4)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-4)
    np.testing.assert_allclose(res.x, ref.x, atol=2e-3)
    np.testing.assert_allclose(res.theta, ref.theta, atol=2e-3)


@pytest.mark.parametrize("place", ["host", "device"])
def test_sharded_ooc_at_f_200_aug_force_on_the_card(card, place,
                                                     monkeypatch):
    """ShardedOutOfCoreALS at one rank, F = 200 with aug_gram="force", on
    the card against the same run on the CPU, as the test above: its X
    chunks (and with X on the card its direct theta chunks) through K6 at
    f = 256 (the two passes, at least one launch each a chunk; K6 counts
    none of its own), the rest as there."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.parallel import sharded_ooc as so
    monkeypatch.setattr(so.ShardedOutOfCoreALS, "THETA_SEG_W", 64)
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    cfg = ALSConfig(m=300, n=220, f=200, lam=0.5, iters=3, verbose=False,
                    debug_timing=False, panel_size=16, chunk_nnz=1 << 9,
                    chunk_rows=32, factor_dtype="bf16", gram_dtype="f32",
                    aug_gram="force", backend="pallas", solver="cg",
                    x_placement=place)
    x0, th0 = init_factors(300, 220, 200, seed=2)
    model = so.ShardedOutOfCoreALS(cfg, train, None, test, device=card)
    res = model.run(x0, th0)
    n_x = len(model.row_plan.chunks)
    if place == "host":
        want = {"gather_gram_out": 3 * len(model.theta_steps),
                "solve_cg_reg": 3}
        k6_chunks = 3 * n_x
    else:
        want = {"gather_gram_out": 3 * len(model._hot_chunks),
                "solve_cg_reg": 3}
        k6_chunks = 3 * (n_x + len(model.th_plan.chunks))
    got = {k: v for k, v in cs.LAUNCHES.items() if k not in K1_PASSES}
    assert got == dict.fromkeys(got, 0) | want
    assert cs.LAUNCHES["wide_span_gram_mma"] == \
        cs.LAUNCHES["wide_span_solve"] >= k6_chunks
    ref = so.ShardedOutOfCoreALS(cfg, train, None, test,
                                 device="cpu").run(x0, th0)
    for a, b in zip(ref.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-4)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-4)
    np.testing.assert_allclose(res.x, ref.x, atol=2e-3)
    np.testing.assert_allclose(res.theta, ref.theta, atol=2e-3)


@pytest.mark.parametrize("table_dtype", [torch.float32, torch.bfloat16])
def test_k2_on_a_hot_segment_chunk(card, table_dtype):
    """K2 with an f32 A on the shape of a hot-segment chunk of the direct
    theta route: R = 16 segments of P = 2^18 slots, the last ones partly
    filled and one empty, against its plain version: A to `gram_limit`,
    b within rtol 1e-5 + 1e-5, as phase 2 of chip_smoke.py holds K2's b."""
    rng = np.random.RandomState(3)
    r, p, n, f = 16, 1 << 18, 100_000, 128
    table = torch.from_numpy(
        0.2 * rng.random_sample((n + 1, f)).astype(np.float32))
    table[n] = 0
    lens = np.full(r, p)
    lens[-3:] = (p // 3, 17, 0)
    cols = np.full((r, p), n, np.int32)
    vals = np.zeros((r, p), np.float32)
    for i, k in enumerate(lens):
        cols[i, :k] = rng.randint(0, n, k)
        vals[i, :k] = rng.randint(1, 11, k) / 2
    args = (table.to(table_dtype).to(card), torch.from_numpy(cols).to(card),
            torch.from_numpy(vals).to(card))
    a, b = cs.gather_gram_out(*args, out_dtype=torch.float32)
    assert cs.LAUNCHES["gather_gram_out"] == 1
    pa, pb = cs.gather_gram_out_plain(*args, out_dtype=torch.float32)
    body = cs.panel_body(args[0])
    _assert_gram_close(a, pa.cpu(), p, body)
    torch.testing.assert_close(b, pb, rtol=1e-5, atol=1e-5)
    assert bool((a[-1] == 0).all()) and bool((b[-1] == 0).all())


def test_k2_at_256_on_a_hot_segment_chunk(card):
    """K2 at f = 256 (the hot segments of sharded out-of-core training at
    F > 128) on a bf16 table with an f32 A: R = 16 segments of P = 2^18
    slots, the last ones partly filled and one empty, against its plain
    version, A to `gram_limit`, b within rtol 1e-5 + 1e-5."""
    rng = np.random.RandomState(4)
    r, p, n, f = 16, 1 << 18, 100_000, 256
    table = torch.from_numpy(
        0.2 * rng.random_sample((n + 1, f)).astype(np.float32))
    table[n] = 0
    lens = np.full(r, p)
    lens[-3:] = (p // 3, 17, 0)
    cols = np.full((r, p), n, np.int32)
    vals = np.zeros((r, p), np.float32)
    for i, k in enumerate(lens):
        cols[i, :k] = rng.randint(0, n, k)
        vals[i, :k] = rng.randint(1, 11, k) / 2
    args = (table.to(torch.bfloat16).to(card),
            torch.from_numpy(cols).to(card), torch.from_numpy(vals).to(card))
    a, b = cs.gather_gram_out(*args, out_dtype=torch.float32)
    assert cs.LAUNCHES["gather_gram_out"] == 1
    pa, pb = cs.gather_gram_out_plain(*args, out_dtype=torch.float32)
    _assert_gram_close(a, pa.cpu(), p, "wgmma")
    del pa
    torch.testing.assert_close(b, pb, rtol=1e-5, atol=1e-5)
    assert bool((a[-1] == 0).all()) and bool((b[-1] == 0).all())


@pytest.mark.parametrize("solver", ["cg", "cholesky"])
def test_torch_op_on_the_card_matches_the_cpu(card, solver):
    """integrations.torch_op.do_als on card tensors against the same op
    on the CPU: outputs on the card, RMSE within 1e-4, factors within
    atol 2e-2 (a CG row near the exit threshold may stop one step apart);
    TorchMF's RMSE on the card is the op's within 1e-3 relative."""
    from cumf_als_tpu_torch.data.synthetic import synthetic_ratings
    from cumf_als_tpu_torch.integrations.torch_op import TorchMF, do_als
    train, test = synthetic_ratings(m=60, n=45, nnz=1400, nnz_test=200,
                                    rank=4, noise=0.05, seed=3)
    host = [torch.from_numpy(a) for a in (
        train.indptr.astype(np.int64), train.indices, train.data, test.row,
        test.col, test.data)]
    runs = {}
    for dev, args in (("cuda", [t.to(card) for t in host]), ("cpu", host)):
        runs[dev] = do_als(*args, 60, 45, 16, 0.05, iters=3, solver=solver,
                           device=dev)
    thetat, xt, rmse = runs["cuda"]
    assert thetat.is_cuda and xt.is_cuda and rmse.is_cuda
    assert float(rmse) == pytest.approx(float(runs["cpu"][2]), abs=1e-4)
    for a, b in zip(runs["cuda"][:2], runs["cpu"][:2]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=2e-2)
    pred = TorchMF(xt, thetat).predict(host[3].to(card), host[4].to(card))
    e = pred.cpu().numpy() - test.data
    assert np.sqrt(np.mean(e * e)) == pytest.approx(float(rmse), rel=1e-3)


def test_entry_on_the_card_matches_the_cpu(card):
    """entry()'s function on the card (its CG through K4, launched once)
    against the same function on the CPU (K4's plain version): the
    predictions (O(1)) within atol 5e-3, the slack of a CG row that
    stops one step apart at the exit threshold."""
    from cumf_als_tpu_torch.entry import entry
    fn, args = entry()
    assert all(a.is_cuda for a in args)
    cs.reset_launch_counts()
    got = fn(*args)
    torch.cuda.synchronize()
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {"solve_cg": 1}
    cfn, cargs = entry(device="cpu")
    np.testing.assert_allclose(got.cpu().numpy(), cfn(*cargs).numpy(),
                               atol=5e-3, rtol=0)


# ---------- factor widths F > 256: tile_gram and global_cg at f >= 384 --
def _tiled_chunk(f, p, seed=0, n=60, r=6):
    """A chunk at f = 128 T lanes with lanes >= f - 84 of the table and
    of x0 zero (so lane f - 1 is free for the aug forms): row 0 fills P,
    row 2 is empty, the others stop inside and at the edge of a 64-slot
    tile; values in halves (one 3.3, not exact in bf16); on the CPU."""
    rng = np.random.RandomState(seed + f + p)
    fl = f - 84
    table = np.zeros((n + 1, f), np.float32)
    table[:n, :fl] = rng.standard_normal((n, fl)) * 0.3
    nnz = np.array([p, min(p, 17), 0, min(p, 64), max(1, p - 1),
                    min(p, 29)][:r], np.int32)
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2 * mask
            ).astype(np.float32)
    vals[0, 0] = 3.3
    x0 = np.zeros((r, f), np.float32)
    x0[:, :fl] = rng.standard_normal((r, fl)) * 0.1
    return [torch.from_numpy(a) for a in (table, cols, vals, nnz, x0)]


TILED = [384, 512, 640]


@pytest.mark.parametrize("f", TILED)
@pytest.mark.parametrize("p", [40, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aug", [False, True])
def test_tile_gram_matches_plain(card, f, p, dtype, aug):
    """The tiled Gram (K2, K5a and pass 1 of K1 and K6 at f >= 384)
    against `tile_gram_plain`: A within `gram_limit` of the body that
    ran, the whole square (both triangles) and symmetric bit for bit
    off the diagonal tiles' mirror, b within rtol 1e-5, r2 within rtol
    1e-5; with nnz each row stops at its nnz; a repeat equal bit for
    bit; one launch each."""
    table, cols, vals, nnz, _ = _tiled_chunk(f, p)
    table = table.to(dtype)
    gpu = [t.to(card) for t in (table, cols, vals, nnz)]
    kw = dict(aug=aug, with_b=not aug, with_r2=not aug)
    a, b, r2 = cs.tile_gram(*gpu, **kw)
    a2, _, _ = cs.tile_gram(*gpu, **kw)
    pa, pb, pr2 = cs.tile_gram_plain(table, cols, vals, nnz, aug=aug)
    assert cs.LAUNCHES["tile_gram"] == 2
    _assert_gram_close(a, pa, p, cs.gram_body(gpu[0]))
    assert torch.equal(a, a2)
    assert torch.equal(a, a.transpose(1, 2))
    assert bool((a[2] == 0).all())
    if not aug:
        torch.testing.assert_close(b.cpu(), pb, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(r2.cpu(), pr2, rtol=1e-5, atol=0)
    # the panel form: every slot, A in bf16 (K2) or A' in f32 (K5a)
    out = torch.float32 if aug else torch.bfloat16
    if aug:
        pa = cs.gather_gram_aug_out(table, cols, vals, out_dtype=out)
        ka = cs.gather_gram_aug_out(*gpu[:3], out_dtype=out)
    else:
        pa, pb = cs.gather_gram_out(table, cols, vals, out_dtype=out)
        ka, kb = cs.gather_gram_out(*gpu[:3], out_dtype=out)
        torch.testing.assert_close(kb.cpu(), pb, rtol=1e-5, atol=1e-5)
    assert ka.dtype == out
    _assert_gram_close(ka, pa, p, cs.gram_body(gpu[0]))
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {"tile_gram": 3}


def _int_rows(f, r, p, seed):
    """R rows of P slots at f = 128 T lanes over an integer table (entries
    -3..3 in lanes < f - 84, so lane f - 1 is free for aug): every sum of
    the Gram exact, so the card's A equals the plain version's bit for
    bit. Row nnz drawn in [0, P], row 1 full, every 50th row without
    slots; values in halves. On the card: (table bf16, cols, vals, nnz)."""
    rng = np.random.RandomState(seed)
    n, fl = 60, f - 84
    table = np.zeros((n + 1, f), np.float32)
    table[:n, :fl] = rng.randint(-3, 4, (n, fl))
    nnz = rng.randint(0, p + 1, r).astype(np.int32)
    nnz[::50] = 0
    nnz[1] = p
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2 * mask
            ).astype(np.float32)
    return (torch.from_numpy(table).to(torch.bfloat16).cuda(),
            *(torch.from_numpy(a).cuda() for a in (cols, vals, nnz)))


@pytest.mark.parametrize("f", [384, 512])
@pytest.mark.parametrize("aug", [False, True])
def test_tile_gram_cluster_long_and_many_rows(card, f, aug):
    """The cluster body (`tile_gram_body` "cluster": one cluster a row,
    each slab gathered by one block and handed to the others) on 300
    rows, more than the clusters that fit the card, so each cluster walks
    several, and P = 2117 slots (33 tiles and 5 slots: a row of two spans
    of the fragment's sums, the first kept in the scratch) over an
    integer table: A, b and r2 equal to `tile_gram_plain` bit for bit,
    with nnz (pass 1 of K1 and K6) and without (K2, K5a); the rows
    without slots exactly 0; a repeat equal bit for bit."""
    table, cols, vals, nnz = _int_rows(f, 300, 2117, seed=f)
    assert cs.tile_gram_body(table) == "cluster"
    for live in (nnz, None):
        kw = dict(aug=aug, with_b=not aug, with_r2=not aug and live is not None)
        a, b, r2 = cs.tile_gram(table, cols, vals, live, **kw)
        a2, b2, r22 = cs.tile_gram(table, cols, vals, live, **kw)
        pa, pb, pr2 = cs.tile_gram_plain(table, cols, vals, live, aug=aug)
        assert torch.equal(a, pa) and torch.equal(a, a2)
        assert bool((a[nnz == 0] == 0).all())
        if not aug:
            assert torch.equal(b, pb) and torch.equal(b, b2)
        if kw["with_r2"]:
            assert torch.equal(r2, pr2) and torch.equal(r2, r22)
        del a, a2, pa
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {"tile_gram": 4}


@pytest.mark.parametrize("f", [384, 512])
def test_tile_gram_few_rows_cut(card, f):
    """K2 and K5a at f >= 384 on a chunk of 16 rows of 16,384 slots, fewer
    rows than the clusters that fit the card: `gram_spans` cuts it at
    f = 384 (one launch of ``tile_gram`` over the (R S, P / S) view, then
    ``gram_span_sum``); f = 512 runs it uncut, and `spans=4` forces the
    cut there. Over an integer table every result equals the plain
    version bit for bit, cut or not, and repeats; at f = 640 (the
    one-block-a-tile body) `spans` raises."""
    r, p = 16, 16384
    table, cols, vals, _ = _int_rows(f, r, p, seed=3 * f)
    s = cs.gram_spans(r, p, f, cs._sms(card))
    assert (s > 1) == (f == 384)
    pa, pb = cs.gather_gram_out_plain(table, cols, vals, torch.bfloat16)
    a, b = cs.gather_gram_out(table, cols, vals, out_dtype=torch.bfloat16)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "tile_gram": 1} | ({"gram_span_sum": 1} if s > 1 else {})
    assert torch.equal(a, pa) and torch.equal(b, pb)
    a2, b2 = cs.gather_gram_out(table, cols, vals, out_dtype=torch.bfloat16)
    assert torch.equal(a, a2) and torch.equal(b, b2)
    for spans in (1, 4):
        a1, b1 = cs.gather_gram_out(table, cols, vals,
                                    out_dtype=torch.bfloat16, spans=spans)
        assert torch.equal(a1, pa) and torch.equal(b1, pb)
    del a, a1, a2, pa
    pa = cs.gather_gram_aug_out_plain(table, cols, vals, torch.float32)
    for spans in (None, 4):
        a = cs.gather_gram_aug_out(table, cols, vals, out_dtype=torch.float32,
                                   spans=spans)
        assert torch.equal(a, pa)
    wide = torch.zeros((61, 640), dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="spans"):
        cs.gather_gram_out(wide, cols, vals, spans=2)


@pytest.mark.parametrize("f", TILED)
@pytest.mark.parametrize("p", [40, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("aug", [False, True])
def test_k1_k6_at_f384_match_plain(card, f, p, dtype, aug):
    """K1 (K6 with aug) at f >= 384 as routed: the two passes, one launch
    of each, against the plain version (`gather_gram_cg_plain`, with aug
    `gather_gram_cg_aug_plain`; x within 2e-3, se within 1e-3 relative),
    lanes >= F of x and the empty row exactly 0, a repeat equal bit for
    bit."""
    cpu = _tiled_chunk(f, p, seed=1)
    cpu[0] = cpu[0].to(dtype)
    gpu = [t.to(card) for t in cpu]
    x, se = cs.gather_gram_cg(*gpu, LAM, aug=aug)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "tile_gram": 1, "global_cg": 1}
    x2, se2 = cs.gather_gram_cg(*gpu, LAM, aug=aug)
    assert torch.equal(x, x2) and torch.equal(se, se2)
    px, pse = cs.gather_gram_cg(*cpu, LAM, aug=aug)
    torch.testing.assert_close(x.cpu(), px, atol=2e-3, rtol=0)
    torch.testing.assert_close(se.cpu(), pse, atol=1e-4, rtol=1e-3)
    assert bool((x[:, f - 84:] == 0).all()) and bool((x[2] == 0).all())


@pytest.mark.parametrize("kernel", SOLVES)
@pytest.mark.parametrize("f", TILED)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_solves_at_f384_match_plain(card, kernel, f, dtype):
    """K3, K4 and K5b at f >= 384 run `global_cg` (one launch, counted
    under its name): x within 2e-3 of the plain version; K5b's lane f - 1
    exactly 0; an all-zero system (K3 and K5b with diag 0) returns its x0
    exactly; cg_iters 0 returns x0; a repeat equal bit for bit."""
    cpu = list(solve_args(kernel, k3_systems(24, f, dtype)))
    cpu[0][5] = 0.0
    if kernel != "solve_cg":
        cpu[1][5] = 0.0
    gpu = [t.to(card) for t in cpu]
    x = run_solve(kernel, gpu)
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {"global_cg": 1}
    torch.testing.assert_close(x.cpu(), run_solve(kernel, cpu), atol=2e-3,
                               rtol=0)
    assert torch.equal(x[5].cpu(), cpu[-1][5])
    assert torch.equal(x, run_solve(kernel, gpu))
    assert torch.equal(run_solve(kernel, gpu, cg_iters=0).cpu(), cpu[-1])
    if kernel == "solve_cg_aug":
        assert bool((x[:, f - 1] == 0).all())
    with pytest.raises(ValueError, match="global_cg"):
        cs.solve_grid(card, 8, f, dtype, kernel)


@pytest.mark.parametrize("kernel", SOLVES)
@pytest.mark.parametrize("f", [384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_solves_at_f384_stop_at_different_steps(card, kernel, f, dtype):
    """K3, K4 and K5b at f >= 384 (``global_cg``, one block a system)
    with a cg_tol that stops the systems of one launch at different
    steps, as at f = 256: b and x0 scaled by 1e-5 (the first step's
    update, then the exit), 3e-3 (a few steps) and 1 (never, in 20) on
    35 systems. Held to the plain version with x scaled back, x within
    2e-3; bits repeating; never stopping moves x."""
    _stop_at_different_steps(card, kernel, f, dtype, 35)
    assert cs.LAUNCHES["global_cg"] == 2


def test_solve_above_2_31_elements_of_a(card):
    """K3 at f = 384 on 16,384 bf16 systems (2.4e9 elements of A, past
    2^31): the systems past element 2^31 (from 14,564 on) solve as the
    plain version solves them, so A is indexed in 64 bits."""
    f, r = 384, 16384
    base, diag0, b0, x00 = k3_systems(8, f, torch.bfloat16)
    a = base.to(card).repeat(r // 8, 1, 1)
    scale = 1.0 + torch.arange(r, device=card, dtype=torch.float32) / r
    a.mul_(scale.to(torch.bfloat16)[:, None, None])
    assert a.numel() > 2 ** 31
    diag = diag0.to(card).repeat(r // 8)
    b = b0.to(card).repeat(r // 8, 1)
    x0 = x00.to(card).repeat(r // 8, 1)
    x = cs.solve_cg_reg(a, diag, b, x0)
    assert cs.LAUNCHES["global_cg"] == 1
    for sel in (slice(0, 4), slice(14560, 14572), slice(r - 4, r)):
        want = cs.solve_cg_reg(a[sel].cpu(), diag[sel].cpu(), b[sel].cpu(),
                               x0[sel].cpu())
        torch.testing.assert_close(x[sel].cpu(), want, atol=2e-3, rtol=0)
    del a


F300 = {
    "direct": ("bf16", dict(use_panels="never")),
    "panel": ("bf16", dict(panel_size=2048)),
    "split": ("bf16", dict(split_gather="force",
                           gather_part_bytes=1024 * 384 * 2)),
    "batched panel": ("f32", dict(solver="cholesky", panel_size=2048,
                                  panel_budget_bytes=1 << 20,
                                  batch_rows=64)),
    "aug force": ("f32", dict(aug_gram="force", panel_size=2048)),
}


@pytest.mark.parametrize("strategy", sorted(F300))
def test_als_at_f300_on_the_card_matches_the_cpu(card, strategy):
    """ALS at F = 300 (f_pad 384) on Netflix at scale 0.01, 2 iterations,
    on each strategy that width reaches for the X phase (theta direct),
    on the card against the same run on the CPU: train and test RMSE
    within 5e-3 / 1e-2 (bf16) or 1e-3 (f32) at every iteration (phase 3
    of chip_smoke.py); the kernels it launches are the f >= 384 ones, and
    on the panel route K2's cut's pass 2 as often as the plan says."""
    from cumf_als_tpu_torch.config import NETFLIX
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   workload_ratings)
    from cumf_als_tpu_torch.models.als import ALS
    train, test = workload_ratings("netflix", scale=0.01, seed=1)
    dtype, extra = F300[strategy]
    cfg = NETFLIX.replace(**dict(
        dict(m=train.num_rows, n=train.num_cols, nnz=train.nnz,
             nnz_test=test.nnz, f=300, iters=2, backend="pallas",
             solver="cg", factor_dtype=dtype, gram_dtype=dtype,
             verbose=False, debug_timing=False), **extra))
    x0, th0 = init_factors(cfg.m, cfg.n, 300, seed=0)
    model = ALS(cfg, train, None, test, device=card)
    assert model.cfg.f_pad == 384
    assert type(model.plan_x[0]).__name__ == {
        "direct": "UpdatePlan", "panel": "PanelPlan", "split": "SplitPlan",
        "batched panel": "BatchedPanelPlan",
        "aug force": "PanelPlan"}[strategy]
    assert type(model.plan_theta[0]).__name__ == "UpdatePlan"
    cs.reset_launch_counts()
    got = model.run(x0, th0).history
    launched = {k for k, v in cs.LAUNCHES.items() if v}
    # K2 and K5a on an X panel chunk of few rows add their cut's pass 2,
    # once an iteration on each chunk `cs.gram_spans` cuts (a bf16 table)
    cut = 0
    if type(model.plan_x[0]).__name__ == "PanelPlan":
        table = torch.bfloat16 if dtype == "bf16" else torch.float32
        cut = cfg.iters * sum(
            cs.gram_spans(*c.cols.shape, 384, cs._sms(card), table) > 1
            for c in model.plan_x[1])
    assert cs.LAUNCHES["gram_span_sum"] == cut
    assert launched - {"gram_span_sum"} <= {"tile_gram", "global_cg"} and \
        launched, launched
    want = ALS(cfg, train, None, test, device="cpu").run(x0, th0).history
    tol_tr, tol_te = (5e-3, 1e-2) if dtype == "bf16" else (1e-3, 1e-3)
    for g, w in zip(got, want):
        assert g.train_rmse == pytest.approx(w.train_rmse, abs=tol_tr)
        assert g.test_rmse == pytest.approx(w.test_rmse, abs=tol_te)


def test_out_of_core_at_f300_on_the_card_matches_the_cpu(card):
    """OutOfCoreALS at F = 300 on the card (K1 on the X chunks, K2 and K3
    on theta, all at f = 384: `tile_gram` and `global_cg`) against the
    same run on the CPU, RMSE within 1e-4 at every iteration."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    cfg = ALSConfig(m=300, n=220, f=300, lam=0.5, iters=2, verbose=False,
                    debug_timing=False, panel_size=64, chunk_nnz=1 << 10,
                    chunk_rows=64, factor_dtype="f32", gram_dtype="f32",
                    backend="pallas", solver="cg")
    x0, th0 = init_factors(300, 220, 300, seed=2)
    model = OutOfCoreALS(cfg, train, None, test, device=card)
    res = model.run(x0, th0)
    launched = {k for k, v in cs.LAUNCHES.items() if v}
    assert launched == {"tile_gram", "global_cg"}, launched
    ref = OutOfCoreALS(cfg, train, None, test, device="cpu").run(x0, th0)
    for a, b in zip(ref.history, res.history):
        assert b.train_rmse == pytest.approx(a.train_rmse, abs=1e-4)
        assert b.test_rmse == pytest.approx(a.test_rmse, abs=1e-4)
