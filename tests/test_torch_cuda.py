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
    slot in the FMA body, 16 slots on the tensor cores) and 4 for the
    plain version's own rounding. A bf16 A adds one bf16 ulp of the
    larger value: both sides round an f32 sum to nearest."""
    af, pf = a.float(), a_plain.float()
    steps = (p if body == "fma" else -(-p // 16)) + 4
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
    _assert_gram_close(a, pa, P, cs.gram_body(gpu[0]))
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
    _assert_gram_close(a, pa, P, cs.gram_body(gpu[0]))
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


def _edge_chunk(p, r, kind, seed=0):
    """The chunk of tests/test_torch_gram.py: r rows of p slots at
    f = 128, pad slots at each row's tail; with r > 1 row 0 is full and
    row 2 holds pad slots only; lane 127 of the table free for the aug
    form. kind "integers": a table of small integers, so that every sum
    is exact in f32 in any order."""
    n, f = 60, 128
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
    64-slot tile, in both bodies (a bf16 table runs the tensor cores, a
    float32 table the FMAs), and at P = 520 and 1288 with rows of 9 and
    21 tiles through the ring of 4: bit for bit on an integer table,
    within `_assert_gram_close` on a random one; rows of pad slots only
    exactly 0."""
    table, cols, vals, empty = _edge_chunk(p, r, kind)
    cpu = (table.to(table_dtype), cols, vals)
    gpu = tuple(t.to(card) for t in cpu)
    body = cs.gram_body(gpu[0])
    assert body == ("wgmma" if table_dtype == torch.bfloat16 else "fma")
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
    # f = 256: K1 alone takes it; K6 and the panel kernels name themselves
    wide = torch.zeros((N + 1, 256), device=card)
    x0w = torch.zeros((R, 256), device=card)
    with pytest.raises(ValueError, match="gather_gram_cg_aug"):
        cs.gather_gram_cg(wide, cols, vals, nnz, x0w, LAM, aug=True)
    with pytest.raises(ValueError, match="gather_gram_out"):
        cs.gather_gram_out(wide, cols, vals)
    with pytest.raises(ValueError, match="gather_gram_aug_out"):
        cs.gather_gram_aug_out(wide, cols, vals)
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
    return cs.cg_reg_grid(1 << 30, cs._sms(card),
                          cs.cg_reg_blocks_per_sm(card, f, dtype))


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
    assert least <= cs.cg_reg_blocks_per_sm(card, f, dtype) <= most
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


@pytest.mark.parametrize("gram_dtype", ["bf16", "f32"])
def test_sharded_world_one_on_the_card_matches_the_cpu(card, gram_dtype):
    """ShardedALS at one rank on the card against the same run on the CPU,
    with X on the panel route (panels of 16 theta rows) and theta in
    reduce blocks of 32 rows solved by K1: bf16 accumulators take K2 and
    K3, f32 ones the augmented K5a and K5b. Each kernel launches as often
    as the plans say; two ranks on the card (gloo, both on cuda:0) match
    two ranks on the CPU, theta equal bit for bit on the two ranks."""
    from cumf_als_tpu_torch.config import ALSConfig
    from cumf_als_tpu_torch.data.synthetic import (init_factors,
                                                   synthetic_ratings)
    from cumf_als_tpu_torch.parallel.mesh import spawn
    from cumf_als_tpu_torch.parallel.sharded_als import ShardedALS, run_rank
    train, test = synthetic_ratings(m=300, n=220, nnz=12000, nnz_test=1500,
                                    rank=6, noise=0.1, seed=7)
    cfg = ALSConfig(m=300, n=220, f=100, lam=0.5, iters=3, verbose=False,
                    debug_timing=False, panel_size=16, chunk_nnz=1 << 9,
                    chunk_rows=32, factor_dtype="bf16",
                    gram_dtype=gram_dtype, backend="pallas", solver="cg")
    x0, th0 = init_factors(300, 220, 100, seed=2)
    model = ShardedALS(cfg, train, None, test, block_rows=32, device=card)
    assert model.x_steps is not None and model.single_fused()
    res = model.run(x0, th0)
    gram, sol = ("gather_gram_out", "solve_cg_reg") if gram_dtype == \
        "bf16" else ("gather_gram_aug_out", "solve_cg_aug")
    slices = model._x_m_pad // model._x_solve_batch
    assert cs.LAUNCHES == dict.fromkeys(cs.LAUNCHES, 0) | {
        "gather_gram_cg": 3 * len(model.reduce_plan.blocks),
        gram: 3 * len(model.x_steps), sol: 3 * slices}
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
        assert r["launches"] == dict.fromkeys(cs.LAUNCHES, 0) | {
            gram: 3 * (r["x_steps"] + r["n_blocks"]),
            sol: 3 * (r["x_slices"] + r["n_blocks"])}
