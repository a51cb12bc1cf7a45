"""The cut of the fused kernels K1 (`gather_gram_cg`) and K6
(`gather_gram_cg(aug=True)`) on chunks of few rows at f = 128, on the
CPU:

  - the span rule `theta_spans` as cases: S = 1 at and above the blocks
    that fit the card (two an SM), on a float32 table, at f other than
    128 and for P not a whole number of 64-slot tiles or too short for
    two spans of `THETA_CUT_MIN_TILES` tiles; elsewhere spans of whole
    tiles that cover [0, P) once, R S within the blocks that fit the
    card, the records within `SPAN_SCRATCH_BYTES`, and the shapes of the
    widest direct theta chunk of sharded out-of-core training and of the
    hugewiki driver's chunks;
  - the cut's plain version `theta_cut_plain` (each span's A, b and r2
    in f32, summed in span order, then the fused kernels' tail) against
    the uncut plain versions `gather_gram_cg_plain` and
    `gather_gram_cg_aug_plain`, on a chunk with spans past each row's
    nnz, rows without ratings and one row much longer than the others;
    the plain version of pass 2 against it, on records whose dead spans
    hold NaN (pass 1 never writes them);
  - the cut's plain version against the JAX package's `gather_gram_cg`
    with its Pallas kernel in interpret mode (as tests/test_pallas.py
    runs it), at f = 128, R = 8, P = 1536, with and without aug.

Tolerances: against the JAX package, x within 2e-3 absolute and se
within 1e-3 relative (of max(|se|, 1)), the limits the card holds the
kernels to in chip_smoke.py; the plain cut against the uncut plain
versions (both f32, the sums in another order) x within 1e-4 and se
within 1e-4 relative. Rows without ratings are exactly 0 in x and se,
and K6's lane 127 of x is exactly 0. On the card the kernels are held to
the uncut plain versions in tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import jax.experimental.pallas as pl

import cumf_als_tpu.ops.pallas_solve as ps
from cumf_als_tpu_torch.ops import cuda_solve as cs

SMS = 132   # an H100's SMs
LAM = 0.048
F = 128


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ps.pl, "pallas_call", patched)
    yield


@pytest.mark.parametrize("r,p,want", [
    (8, 196608, 32), (32, 81920, 8), (16, 163840, 16), (64, 40960, 4),
    (8, 8192, 16), (8, 1536, 3), (120, 1536, 2), (263, 4096, 1),
    (264, 4096, 1), (300, 8192, 1), (8, 4100, 1), (16, 96, 1), (8, 960, 1),
    (8, 1024, 2), (131, 512, 1)])
def test_span_rule(r, p, want):
    """S on an H100 for a bf16 table at f = 128; S = 1 (the uncut kernel)
    at and above 264 rows and where P is not a whole number of tiles or
    too short to cut; spans of whole tiles covering [0, P) once, none
    under `THETA_CUT_MIN_TILES` tiles, R S at most two an SM, the records
    within the scratch cap."""
    s = cs.theta_spans(r, p, F, SMS)
    assert s == want
    assert p % s == 0
    if s > 1:
        span = p // s
        assert span % cs.GRAM_TILE == 0 and span * s == p
        assert span // cs.GRAM_TILE >= cs.THETA_CUT_MIN_TILES
        assert r < 2 * SMS and r * s <= 2 * SMS
        assert r * s * cs.THETA_RECORD_FLOATS * 4 <= cs.SPAN_SCRATCH_BYTES


@pytest.mark.parametrize("what", ["float32 table", "f = 256", "f = 112",
                                  "f = 64"])
def test_span_rule_cuts_a_bf16_table_at_f_128_only(what):
    """Every other table and width keeps S = 1 on the shapes the rule
    cuts at f = 128 (f = 256 has the row cut of `row_spans`)."""
    for r, p in ((8, 196608), (32, 81920), (8, 1536)):
        assert cs.theta_spans(r, p, F, SMS) > 1
        if what == "float32 table":
            assert cs.theta_spans(r, p, F, SMS, torch.float32) == 1
        else:
            assert cs.theta_spans(r, p, int(what.split()[-1]), SMS) == 1


def cut_chunk(r, p, nnz, seed=0, aug=False, n=90):
    """A theta chunk over a zero-extended table (n + 1, 128) f32, cols
    (R, P) with pad slots naming row n at each row's tail, values in
    halves (one, 3.3, not exact in bf16), warm starts 0.1 N(0, 1) with a
    zero one for each row without ratings; with aug lane 127 of the
    table and of x0 is zero (the free lane)."""
    rng = np.random.RandomState(seed + 11 * p + r)
    nnz = np.asarray(nnz, np.int32)
    table = (rng.standard_normal((n + 1, F)) * 0.3).astype(np.float32)
    table[n] = 0.0
    mask = np.arange(p)[None, :] < nnz[:, None]
    cols = np.where(mask, rng.randint(0, n, (r, p)), n).astype(np.int32)
    vals = (np.round(rng.uniform(1, 5, (r, p)) * 2) / 2).astype(np.float32)
    vals[0, 0] = 3.3
    x0 = (rng.standard_normal((r, F)) * 0.1).astype(np.float32)
    x0[nnz == 0] = 0.0
    if aug:
        table[:, F - 1] = 0.0
        x0[:, F - 1] = 0.0
    return table, cols, (vals * mask).astype(np.float32), nnz, x0


# one row of every slot, one much shorter than a span, rows without
# ratings, rows that stop inside and at the edge of a span of 256 slots
NNZ = [1536, 0, 70, 700, 65, 1, 256, 0]


def torch_args(table, cols, vals, nnz, x0):
    return (torch.from_numpy(table).to(torch.bfloat16),
            torch.from_numpy(cols), torch.from_numpy(vals),
            torch.from_numpy(nnz), torch.from_numpy(x0))


def assert_zero_rows(x, se, nnz, aug):
    empty = torch.from_numpy(np.asarray(nnz) == 0)
    assert torch.all(x[empty] == 0) and torch.all(se[empty] == 0)
    if aug:
        assert torch.all(x[:, F - 1] == 0)


@pytest.mark.parametrize("spans", [1, 2, 3, 4, 6, 12, 24])
@pytest.mark.parametrize("aug", [False, True])
def test_cut_plain_equals_the_uncut_plain(spans, aug):
    """Spans past a row's nnz add nothing and the row's spans add up to
    its Gram, so the cut solves as the uncut plain version does."""
    args = torch_args(*cut_chunk(8, 1536, NNZ, aug=aug))
    x, se = cs.theta_cut_plain(*args, LAM, spans, aug=aug)
    plain = cs.gather_gram_cg_aug_plain if aug else cs.gather_gram_cg_plain
    px, pse = plain(*args, LAM)
    assert x.shape == (8, F) and se.shape == (8, 1)
    torch.testing.assert_close(x, px, atol=1e-4, rtol=0)
    assert torch.all((se - pse).abs() <= 1e-4 * pse.abs().clamp_min(1.0))
    assert_zero_rows(x, se, NNZ, aug)


@pytest.mark.parametrize("spans", [4, 6])
@pytest.mark.parametrize("aug", [False, True])
def test_pass_2_plain_reads_the_live_records_only(spans, aug):
    """The plain version of pass 2 on records laid out as pass 1 writes
    them (A row-major, then b and r2; K6's A' alone), every span past its
    row's nnz left NaN: it equals the plain cut."""
    table, cols, vals, nnz, x0 = cut_chunk(8, 1536, NNZ, seed=2, aug=aug)
    t, c, v, n, x0t = torch_args(table, cols, vals, nnz, x0)
    r, p = c.shape
    span = p // spans
    part = torch.full((r * spans, cs.THETA_RECORD_FLOATS), float("nan"))
    a_s, b_s, r2_s = cs.theta_records_unpack(part, r, spans)
    live = cs._span_live(n, p, spans, span)
    for k in range(spans):
        a, b, r2 = cs.span_gram_plain(t, c, v, n, k * span, (k + 1) * span,
                                      F, aug)
        for i in torch.nonzero(live[:, k])[:, 0].tolist():
            a_s[i, k] = a[i]
            if not aug:
                b_s[i, k], r2_s[i, k] = b[i], r2[i]
    x, se = cs.frag_span_solve_plain(part, n, x0t, LAM, p, spans, aug=aug)
    want_x, want_se = cs.theta_cut_plain(t, c, v, n, x0t, LAM, spans,
                                         aug=aug)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(se).all())
    torch.testing.assert_close(x, want_x, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(se, want_se, atol=1e-5, rtol=1e-6)
    assert_zero_rows(x, se, nnz, aug)
    with pytest.raises(ValueError, match="card tensors only"):
        cs.frag_span_solve(part, n, x0t, LAM, p, spans, aug=aug)


@pytest.mark.parametrize("aug", [False, True])
def test_cut_plain_matches_pallas(aug):
    """The cut as the card runs it on an H100 (the rule's S = 3 at R = 8,
    P = 1536) against the JAX kernel on a bf16 table, as the cut takes
    only such tables."""
    r, p = 8, 1536
    s = cs.theta_spans(r, p, F, SMS)
    assert s == 3
    table, cols, vals, nnz, x0 = cut_chunk(r, p, NNZ, seed=1, aug=aug)
    jx, jse = ps.gather_gram_cg(jnp.asarray(table), jnp.asarray(cols),
                                jnp.asarray(vals), jnp.asarray(nnz),
                                jnp.asarray(x0), LAM, factor_dtype="bf16",
                                aug=aug)
    x, se = cs.theta_cut_plain(*torch_args(table, cols, vals, nnz, x0), LAM,
                               s, aug=aug)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=2e-3,
                               rtol=0)
    jse = np.asarray(jse)
    assert np.all(np.abs(se.numpy() - jse) <=
                  1e-3 * np.maximum(np.abs(jse), 1.0))
    assert_zero_rows(x, se, nnz, aug)
    assert np.all(np.asarray(jx)[np.asarray(nnz) == 0] == 0)


@pytest.mark.parametrize("spans", [1, 4])
@pytest.mark.parametrize("aug", [False, True])
def test_cpu_tensors_take_the_plain_version_whatever_spans_says(spans, aug):
    """At f = 128 `spans` is taken (1: the uncut kernel on a card) and a
    CPU tensor takes the plain version whatever it says; below 128 it is
    refused; no launch is counted."""
    cs.reset_launch_counts()
    args = torch_args(*cut_chunk(8, 1536, NNZ, seed=3, aug=aug))
    x, se = cs.gather_gram_cg(*args, LAM, aug=aug, spans=spans)
    plain = cs.gather_gram_cg_aug_plain if aug else cs.gather_gram_cg_plain
    px, pse = plain(*args, LAM)
    assert torch.equal(x, px) and torch.equal(se, pse)
    narrow = (args[0][:, :64].contiguous(), *args[1:4],
              args[4][:, :64].contiguous())
    with pytest.raises(ValueError, match="spans"):
        cs.gather_gram_cg(*narrow, LAM, aug=aug, spans=spans)
    assert sum(cs.LAUNCHES.values()) == 0
