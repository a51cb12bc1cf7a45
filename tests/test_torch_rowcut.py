"""The row cut of the 256-lane body (K1 at f = 256 and K7) on the CPU:
the span plan `row_spans`, the record layout of the two passes, and the
plain cut route (`span_gram_plain` composed with `span_solve_plain`,
`row_cut_plain`) against the JAX package's `gather_gram_cg_wide` and
`gather_gram_cg` at f_pad 256 in interpret mode and against the uncut
plain versions, on rows that stop at nnz 0, 1, 31, 32, 33, on a span
edge and at P.

Tolerances as in tests/test_torch_wide.py: x and se rtol 1e-3 / atol
1e-4 at CG-30 against the JAX package (the two sum in other orders and
CG-30 at cg_tol 1e-10 converges both); lanes >= FL and empty rows
exactly 0. Against the uncut plain version the cut changes only where
the f32 Gram sums are split (span by span, then added in span order):
x within 1e-4 and se within 1e-5 relative at CG-6 against K1's uncut
form, which runs the same CG; K7's uncut form runs the two-block CG, so
it is held to the JAX tolerance."""

import numpy as np
import pytest
import torch
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps

from cumf_als_tpu_torch.ops import cuda_solve as cs

LAM = 0.05


@pytest.fixture()
def interp(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ the plan --
@pytest.mark.parametrize("sms", [132, 114, 8])
@pytest.mark.parametrize("p", [1, 31, 32, 100, 128, 129, 300, 4096, 8192,
                               241664])
def test_row_spans_cover_each_row_once_in_whole_tiles(sms, p):
    """For every R: the spans cover [0, P) once, in whole 32-slot tiles;
    S = 1 whenever R >= sms; no span under 4 tiles unless S = 1; R S
    about four blocks an SM and no more spans than that; the same answer
    every time."""
    tiles = -(-p // 32)
    for r in (1, 2, 3, 7, 8, 31, 32, 67, 100, sms - 1, sms, sms + 1, 500):
        if r < 1:
            continue
        s, span = cs.row_spans(r, p, sms)
        assert (s, span) == cs.row_spans(r, p, sms)
        assert s >= 1 and span % 32 == 0 and span > 0
        assert (s - 1) * span < max(p, 1) <= s * span
        if r >= sms:
            assert s == 1
        elif tiles >= 8:      # room for two spans of 4 tiles
            assert s > 1
        if s > 1:
            assert span >= 4 * 32
            assert r * s <= 4 * sms + r


def test_row_spans_fills_the_card_on_few_long_rows():
    """The widest theta chunk and the longest split-X rows of the
    Netflix shape: R S reaches four blocks an SM where the row has the
    tiles for it."""
    assert cs.row_spans(8, 8192, 132) == (64, 128)
    assert cs.row_spans(8, 8192, 132, target=2) == (32, 256)
    s, span = cs.row_spans(1, 241664, 132)
    assert s > 3 * 132 and (s - 1) * span < 241664 <= s * span
    assert cs.row_spans(512, 7360, 132) == (1, 7360)


@pytest.mark.parametrize("p,spans,want", [
    (300, 1, (1, 320)), (300, 2, (2, 160)), (300, 3, (3, 128)),
    (300, 7, (5, 64)), (224, 7, (7, 32)), (48, 7, (2, 32)),
    (32, 5, (1, 32))])
def test_forced_spans(p, spans, want):
    """The cut a wrapper's `spans` forces: whole tiles, at most `spans`
    spans, none of them empty."""
    got = cs._chunk_spans(torch.device("cuda", 0), 3, p, spans)
    assert got == want
    s, span = got
    assert (s - 1) * span < p <= s * span


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("p", [1, 63, 64, 65, 127, 129, 300, 4096, 8192,
                               241664])
def test_row_spans_at_the_tensor_core_tile(sms, p):
    """At the tensor-core pass 1's 64-slot tile, spans of at most
    `SPAN_MAX_TILES_MMA` tiles (`span_plan` of a bf16 table): the spans
    cover [0, P) once, in whole 64-slot tiles; S = 1 whenever R >= sms
    and P fits one span; no span under min_tiles tiles unless S = 1 or
    the cap asks for more spans; the forced cut of `spans` keeps whole
    tiles and ignores the cap."""
    plan = cs.span_plan(torch.zeros((2, 256), dtype=torch.bfloat16))
    tile, cap, least = plan["tile"], plan["max_tiles"], plan["min_tiles"]
    assert (tile, cap) == (cs.SPAN_TILE_MMA, cs.SPAN_MAX_TILES_MMA)
    assert cs.span_plan(torch.zeros((2, 256))) == dict(tile=cs.SPAN_TILE)
    tiles = -(-p // 64)
    for r in (1, 2, 7, 8, 32, 100, sms - 1, sms, 500):
        if r < 1:
            continue
        s, span = cs.row_spans(r, p, sms, **plan)
        assert span % 64 == 0 and 0 < span <= cap * 64
        assert (s - 1) * span < max(p, 1) <= s * span
        if r >= sms:
            assert s == -(-tiles // cap)
        elif tiles >= 2 * least:
            assert s > 1
        if s > 1 and tiles <= least * cap:
            assert span >= least * 64
    for spans in (1, 2, 3, 7):
        s, span = cs._chunk_spans(torch.device("cuda", 0), 3, p, spans,
                                  cs.SPAN_TILE_MMA)
        assert span % 64 == 0 and 1 <= s <= spans
        assert (s - 1) * span < max(p, 1) <= s * span


@pytest.mark.parametrize("dtype,tile", [(torch.bfloat16, 64),
                                        (torch.float32, 32)])
def test_span_tile_follows_the_pass_1_body(dtype, tile):
    """A bf16 256-lane table runs pass 1 on the tensor cores in 64-slot
    tiles, a float32 one on the FMA body in 32-slot tiles (`span_plan`)."""
    table = torch.zeros((5, 256), dtype=dtype)
    assert cs.span_plan(table)["tile"] == tile
    assert cs.gram_body(table) == ("wgmma" if tile == 64 else "fma")


@pytest.mark.parametrize("fl", [160, 192, 224, 256])
def test_row_batches_keep_the_records_in_budget(fl):
    """A chunk's records are written in batches of rows whose records fit
    `SPAN_SCRATCH_BYTES` (one row at least): the populous theta chunk of
    the Netflix F=200 plans (16,384 rows, one span) takes one batch at
    160 live lanes, two at 192 and 224, three at 256."""
    size = cs.span_record_floats(fl) * 4
    for spans in (1, 7, 528, 60000):
        step = cs.row_batches(spans, fl)
        assert step >= 1
        assert step * spans * size <= cs.SPAN_SCRATCH_BYTES or step == 1
        assert (step + 1) * spans * size > cs.SPAN_SCRATCH_BYTES
    assert cs.row_batches(1, fl, budget=10 * size) == 10
    batches = -(-16384 // cs.row_batches(1, fl))
    assert batches == -(-16384 * size // cs.SPAN_SCRATCH_BYTES)
    assert batches == (1 if fl == 160 else 2 if fl < 256 else 3)
    assert cs.row_batches(66, fl) >= 8


def _mma_epilogue(fl):
    """Where the tensor-core pass 1 (csrc/wide_span_gram_mma.cu) writes
    each accumulator: for block z (0: (0, 0), 1: (0, 1), 2: (1, 1)),
    warpgroup g, warp w, lane t, fragment column tile i and half h, the
    entry (row, column) of A that acc[4 i + 2 h + j] holds (the m64n128
    fragment: row 128 bi + 64 g + 16 w + 8 h + t // 4, column 128 bj +
    8 i + 2 (t % 4) + j) and the record index it is stored at, if it is
    stored (tile (ti, tj) with ti <= tj < T: index tile * 64 + 2 t + j).
    Returns {record index: (row, column)}, and the number of stores."""
    t_side = fl // 8
    pairs = [(i, j) for i in range(t_side) for j in range(i, t_side)]
    index = {pair: k for k, pair in enumerate(pairs)}
    where, stores = {}, 0
    for z, (bi, bj) in enumerate(((0, 0), (0, 1), (1, 1))):
        for g in range(2):
            for w in range(4):
                for i in range(16):
                    for h in range(2):
                        ti = 16 * bi + 8 * g + 2 * w + h
                        tj = 16 * bj + i
                        if not ti <= tj < t_side:
                            continue
                        for lane in range(32):
                            for j in range(2):
                                row = 128 * bi + 64 * g + 16 * w + 8 * h + \
                                    lane // 4
                                col = 128 * bj + 8 * i + 2 * (lane % 4) + j
                                where[index[(ti, tj)] * 64 + 2 * lane + j] = \
                                    (row, col)
                                stores += 1
    return where, stores


@pytest.mark.parametrize("fl", [160, 192, 224, 256])
def test_tensor_core_epilogue_writes_every_entry_once(fl):
    """The record index map of the tensor-core pass 1's epilogue: every
    entry of the upper triangle of 8 x 8 tiles inside the fl live lanes
    is stored exactly once, at the place `span_record_unpack` reads it
    from (entry (k, l) of tile (ti, tj) is A[8 ti + k, 8 tj + l])."""
    where, stores = _mma_epilogue(fl)
    t_side = fl // 8
    n_tiles = t_side * (t_side + 1) // 2
    assert stores == len(where) == 64 * n_tiles
    assert sorted(where) == list(range(64 * n_tiles))
    a = torch.arange(fl * fl, dtype=torch.float32).reshape(fl, fl)
    a = torch.triu(a) + torch.triu(a, 1).T      # symmetric, distinct
    rec = torch.zeros(cs.span_record_floats(fl))
    for idx, (row, col) in where.items():
        rec[idx] = a[row, col]
    ua, _, _ = cs.span_record_unpack(rec, fl)
    assert torch.equal(ua, a)


def _record(a, b, r2):
    """Span records of dense A (R, fl, fl), b (R, fl), r2 (R, 1), written
    index by index in the tile layout of csrc/wide.cuh: entry k * 8 + l
    of tile i at [i * 64 + k * 8 + l], the tiles row-major over the
    upper triangle, b then r2 after them, the rest zero."""
    fl = a.shape[-1]
    t = fl // 8
    pairs = [(i, j) for i in range(t) for j in range(i, t)]
    tiles = len(pairs)
    rec = np.zeros((a.shape[0], cs.span_record_floats(fl)), np.float32)
    an = a.numpy()
    for i, (ti, tj) in enumerate(pairs):
        for k in range(8):
            rec[:, i * 64 + k * 8 + np.arange(8)] = \
                an[:, ti * 8 + k, tj * 8:tj * 8 + 8]
    rec[:, 64 * tiles:64 * tiles + fl] = b.numpy()
    rec[:, 64 * tiles + fl] = r2.numpy()[:, 0]
    return _t(rec)


def test_record_layout_round_trip():
    """`span_record_unpack` reads back records written in the tile
    layout of csrc/wide.cuh (`_record`): A mirrored from the upper
    triangle of tiles, b and r2."""
    rng = np.random.default_rng(1)
    for fl in (160, 192, 224, 256):
        g = _t(rng.standard_normal((3, 5, fl)).astype(np.float32))
        a = torch.einsum("rpf,rpg->rfg", g, g)
        b = _t(rng.standard_normal((3, fl)).astype(np.float32))
        r2 = _t(rng.standard_normal((3, 1)).astype(np.float32))
        rec = _record(a, b, r2)
        t = fl // 8
        tiles = t * (t + 1) // 2
        size = cs.span_record_floats(fl)
        assert size % 64 == 0 and 0 <= size - (64 * tiles + fl + 1) < 64
        # tile 1 is (0, 1): its entry (k, l) = (2, 5) is A[2, 8 + 5]
        assert rec[0, 64 + 2 * 8 + 5] == a[0, 2, 13]
        # the last tile is (T-1, T-1)
        assert rec[0, 64 * tiles - 1] == a[0, -1, -1]
        ua, ub, ur2 = cs.span_record_unpack(rec, fl)
        assert torch.equal(ua, a) and torch.equal(ub, b) and \
            torch.equal(ur2, r2)


# ------------------------------------------------------ the plain route --
def _edge_chunk(f, p, span, rows, seed, n=60):
    """A 256-lane table of true width f and a chunk of P = p slots whose
    rows stop at the given nnz ("edge" = the span edge `span`, "edge+1"
    one slot past it, "P" = p), pad slots at each row's tail (the zero
    row n, value 0)."""
    rng = np.random.default_rng(seed)
    table = np.zeros((n + 1, 256), np.float32)
    table[:n, :f] = rng.standard_normal((n, f)) * 0.4
    nnz = np.array([{"edge": span, "edge+1": span + 1, "P": p}.get(k, k)
                    for k in rows], np.int32)
    r = len(nnz)
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.integers(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2 * mask
            ).astype(np.float32)
    x0 = np.zeros((r, 256), np.float32)
    x0[:, :f] = rng.standard_normal((r, f)) * 0.1
    return table, cols, vals, nnz, x0


ROWS = {"tile edges": (0, 1, 31, 32, 33, "P"),
        "span edges": (0, "edge", "edge+1", 1, 31, "P")}


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("f,p,spans", [(130, 300, 2), (200, 300, 3),
                                       (200, 256, 4)])
def test_cut_route_matches_pallas_and_the_uncut_form(interp, rows, f, p,
                                                     spans):
    """The plain cut route at FL = 128 + f2 (K7) and FL = 256 (K1 at
    f = 256) against the JAX wrappers and against the uncut plain
    versions."""
    n_spans, span = cs._cut(-(-p // 32), spans, 32)
    assert n_spans == spans
    table, cols, vals, nnz, x0 = _edge_chunk(f, p, span, ROWS[rows], seed=f)
    targs = (_t(table), _t(cols), _t(vals), _t(nnz), _t(x0))
    empty = nnz == 0
    f2 = cs.wide_f2(f)
    conv = dict(cg_iters=30, cg_tol=1e-10)
    tol = dict(rtol=1e-3, atol=1e-4)
    for fl, jfn in ((128 + f2, lambda: ps.gather_gram_cg_wide(
            table, cols, vals, nnz, x0, LAM, f2=f2, **conv)),
                    (256, lambda: ps.gather_gram_cg(
            table, cols, vals, nnz, x0, LAM, **conv))):
        jx, jse = jfn()
        x, se = cs.row_cut_plain(*targs, LAM, fl, spans, span, **conv)
        np.testing.assert_allclose(x.numpy(), np.asarray(jx), **tol)
        np.testing.assert_allclose(se.numpy(), np.asarray(jse), **tol)
        assert not np.any(x.numpy()[:, fl:])
        assert np.abs(x.numpy()[empty]).max() == 0.0
        assert np.abs(se.numpy()[empty]).max() == 0.0
    # against the uncut plain versions at the kernels' CG-6
    x, se = cs.row_cut_plain(*targs, LAM, 256, spans, span)
    ux, use = cs.gather_gram_cg_plain(*targs, LAM)
    torch.testing.assert_close(x, ux, rtol=0, atol=1e-4)
    torch.testing.assert_close(se, use, rtol=1e-5, atol=1e-5)
    x, se = cs.row_cut_plain(*targs, LAM, 128 + f2, spans, span, **conv)
    ux, use = cs.gather_gram_cg_wide_plain(*targs, LAM, f2, **conv)
    torch.testing.assert_close(x, ux, **tol)
    torch.testing.assert_close(se, use, **tol)


@pytest.mark.parametrize("fl", [160, 256])
def test_the_two_passes_take_card_tensors_only(fl):
    """The passes are the card half of the cut (CPU tensors of
    `gather_gram_cg` and `gather_gram_cg_wide` take the uncut plain
    versions; `row_cut_plain` is the pair's plain version): on CPU
    tensors both raise and count no launch. `_span_live` marks the spans
    pass 2 reads: span s of a row is live iff s L < min(nnz, P)."""
    cs.reset_launch_counts()
    p, spans = 300, 3
    n_spans, span = cs._cut(-(-p // 32), spans, 32)
    table, cols, vals, nnz, x0 = (_t(a) for a in _edge_chunk(
        fl - 8, p, span, ROWS["span edges"], seed=3))
    with pytest.raises(ValueError, match="card tensors"):
        cs.span_grams(table, cols, vals, nnz, fl, n_spans, span)
    part = torch.zeros((6, n_spans, cs.span_record_floats(fl)))
    with pytest.raises(ValueError, match="card tensors"):
        cs.span_solve(part, nnz, x0, LAM, p, span)
    assert sum(cs.LAUNCHES.values()) == 0
    live = cs._span_live(nnz, p, n_spans, span)
    assert live.tolist() == [[False] * 3, [True, False, False],
                             [True, True, False], [True, False, False],
                             [True, False, False], [True] * 3]


def test_wrappers_take_spans_on_the_256_lane_body_only():
    """`spans` is a keyword of `gather_gram_cg` at f = 256 (K1 and, with
    aug, K6) and of `gather_gram_cg_wide`, and of `gather_gram_cg` at
    f = 128 too (the cut of K1 and K6 on few-row chunks); below 128 it is
    refused. CPU tensors take the plain version whatever it says, and
    nothing counts a launch."""
    cs.reset_launch_counts()
    table, cols, vals, nnz, x0 = (_t(a) for a in _edge_chunk(
        200, 64, 32, ROWS["tile edges"], seed=4))
    x, se = cs.gather_gram_cg(table, cols, vals, nnz, x0, LAM)
    xs, ses = cs.gather_gram_cg(table, cols, vals, nnz, x0, LAM, spans=2)
    assert torch.equal(x, xs) and torch.equal(se, ses)
    xw, sew = cs.gather_gram_cg_wide(table, cols, vals, nnz, x0, LAM, 96,
                                     spans=2)
    assert torch.equal(xw, cs.gather_gram_cg_wide(
        table, cols, vals, nnz, x0, LAM, 96)[0])
    narrow = (table[:, :128].contiguous(), cols, vals, nnz,
              x0[:, :128].contiguous())
    assert torch.equal(cs.gather_gram_cg(*narrow, LAM, spans=2)[0],
                       cs.gather_gram_cg_plain(*narrow, LAM)[0])
    narrower = (table[:, :64].contiguous(), cols, vals, nnz,
                x0[:, :64].contiguous())
    with pytest.raises(ValueError, match="f = 128 and f = 256 only"):
        cs.gather_gram_cg(*narrower, LAM, spans=2)
    xa, sea = cs.gather_gram_cg(table, cols, vals, nnz, x0, LAM, aug=True,
                                spans=2)
    assert torch.equal(xa, cs.gather_gram_cg_aug_plain(
        table, cols, vals, nnz, x0, LAM)[0])
    assert torch.equal(cs.gather_gram_cg(*narrow, LAM, aug=True, spans=2)[0],
                       cs.gather_gram_cg_aug_plain(*narrow, LAM)[0])
    with pytest.raises(ValueError, match="f = 128 and f = 256 only"):
        cs.gather_gram_cg(*narrower, LAM, aug=True, spans=2)
    for bad in (0, 70000):
        with pytest.raises(ValueError, match="spans"):
            cs.gather_gram_cg_wide(table, cols, vals, nnz, x0, LAM, 96,
                                   spans=bad)
    with pytest.raises(ValueError, match="fl"):
        cs.span_grams(table, cols, vals, nnz, 200, 2, 32)
    with pytest.raises(ValueError, match="span_len"):
        cs.span_grams(table, cols, vals, nnz, 256, 2, 48)
    assert sum(cs.LAUNCHES.values()) == 0
