"""Sharded update plans (the JAX package's parallel/plan.py, host numpy,
copied so that the port imports nothing of the JAX package).

The reference's hugewiki app shards the rating matrix across 4 GPUs with
hardcoded row splits and balances uneven batches with an OpenMP
critical-section work counter (reference hugewiki.cu:2273-2275,
2490-2496). Here the split is decided on the host, once: rows are
assigned to ranks balanced by nonzero count, and every rank gets
identically shaped bucket chunks (padded with dummy rows where needed),
so that the ranks run the same steps in lockstep and meet at the same
collectives.

Two layouts:
  - ShardedRowPlan (large-factor phase): each rank owns a disjoint row
    shard; the gather table (the small factor) is replicated; no
    collectives.
  - ReducePlan (small-factor phase): every rank sees the same
    small-factor rows per block, with its local ratings only; the
    partial Gram/RHS are summed over the ranks (all_reduce), the
    collective form of the reference's anchor-GPU cudaMemcpy +
    cublasSaxpy reduction (hugewiki.cu:2703-2730).

Every plan equals the JAX package's array for array
(tests/test_torch_sharded.py). Arrays carry a leading rank axis; rank d
takes index d.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from cumf_als_tpu_torch.ops.tiling import (_rows_per_chunk, build_panel_plan,
                                           make_width_grid)
from cumf_als_tpu_torch.utils.io import CSRMatrix


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def assign_rows_balanced(row_nnz: np.ndarray, n_dev: int) -> np.ndarray:
    """Balanced static assignment: rows sorted by nnz descending, dealt
    in a snake (0..n-1, n-1..0, ...) so per-device loads and row counts
    stay even. Vectorized — hugewiki-scale row counts (50M) rule out a
    per-row greedy loop. This is the static replacement for
    hugewiki's dynamic work counter (hugewiki.cu:2490-2496)."""
    m = row_nnz.shape[0]
    order = np.argsort(-row_nnz, kind="stable")
    cycle = np.arange(m, dtype=np.int64) % (2 * n_dev)
    dev = np.where(cycle < n_dev, cycle, 2 * n_dev - 1 - cycle)
    assign = np.empty(m, np.int32)
    assign[order] = dev.astype(np.int32)
    return assign


@dataclasses.dataclass
class ShardedChunk:
    """One lockstep work unit: arrays carry a leading device axis."""
    width: int
    rows: np.ndarray   # (n_dev, R) int32 LOCAL row ids (== m_loc for dummy)
    nnz: np.ndarray    # (n_dev, R) int32
    cols: np.ndarray   # (n_dev, R, P) int32 global ids into the table
    vals: np.ndarray   # (n_dev, R, P) float32

    def materialize(self):
        return self.rows, self.nnz, self.cols, self.vals


class LazyShardedChunk:
    """A ShardedChunk whose padded (cols, vals) materialize on demand
    from the CSR (per-device global row lists are kept; local rows/nnz
    are precomputed cheaply). The hugewiki-scale streaming form: eager
    plan arrays are ~8 B/padded-nnz (~28 GB at 3.1e9 nnz), these hold
    4 B/row."""

    __slots__ = ("width", "rows", "nnz", "_csr", "_grows", "_r")

    def __init__(self, csr: CSRMatrix, width: int, grows, local_rows,
                 r: int, m_loc: int, lens_all: np.ndarray = None):
        """grows/local_rows: per-device lists of global/local row ids
        (may be shorter than r — the rest are dummy tails, rows ==
        m_loc). lens_all: precomputed np.diff(indptr) — pass it when
        building many chunks (recomputing is O(m) per chunk)."""
        self.width = width
        self._csr = csr
        self._grows = grows
        self._r = r
        n_dev = len(grows)
        self.rows = np.full((n_dev, r), m_loc, np.int32)
        self.nnz = np.zeros((n_dev, r), np.int32)
        if lens_all is None:
            lens_all = np.diff(np.asarray(csr.indptr))
        for d in range(n_dev):
            k = grows[d].size
            self.rows[d, :k] = local_rows[d]
            self.nnz[d, :k] = lens_all[grows[d]]

    def materialize(self):
        from cumf_als_tpu_torch import native
        csr = self._csr
        n_dev = len(self._grows)
        r, width = self._r, self.width
        cols = np.empty((n_dev, r, width), np.int32)
        vals = np.empty((n_dev, r, width), np.float32)
        use_native = native.available()
        indptr = np.asarray(csr.indptr, np.int64)
        for d in range(n_dev):
            g = self._grows[d]
            if use_native:
                rows_in = np.full(r, -1, np.int32)
                rows_in[:g.size] = g
                _ro, _nz, cols[d], vals[d] = native.materialize_chunk(
                    indptr, csr.indices, csr.data, rows_in, width,
                    csr.num_cols, csr.num_rows, csr.num_rows)
            else:
                cols[d] = csr.num_cols
                vals[d] = 0.0
                lens = (indptr[g + 1] - indptr[g]).astype(np.int32)
                offs = indptr[g]
                aw = np.arange(width, dtype=np.int64)[None, :]
                idx = offs[:, None] + aw
                mask = aw < lens[:, None]
                idx = np.where(mask, idx, 0)
                cols[d, :g.size] = np.where(mask, csr.indices[idx],
                                            csr.num_cols)
                vals[d, :g.size] = np.where(mask, csr.data[idx], 0.0)
        return self.rows, self.nnz, cols, vals


@dataclasses.dataclass
class ShardedRowPlan:
    n_dev: int
    m: int                      # global rows
    m_loc: int                  # rows per device shard (padded)
    global_ids: np.ndarray      # (n_dev, m_loc) int32, == m for padding
    num_cols: int               # gather table size
    chunks: List[ShardedChunk]


def build_sharded_row_plan(csr: CSRMatrix, n_dev: int,
                           min_width: int = 8,
                           max_width: int = 1 << 18,
                           chunk_nnz: int = 1 << 22,
                           chunk_rows: int = 1 << 14,
                           lazy: bool = False,
                           octave_points: int = 0,
                           fine_max_width: int = 1024,
                           row_mask=None) -> ShardedRowPlan:
    """Shard csr's rows over n_dev devices with aligned bucket chunks.
    lazy=True keeps chunks as LazyShardedChunk (cols/vals materialize at
    stream time — the hugewiki-scale form).

    octave_points > 0 buckets rows on the fine (mantissa) width grid of
    ops/tiling.make_width_grid instead of pure powers of two — the same
    padded-slot win the single-device plans took in round 2 (per-row pad
    bound drops from 2x to 1.125-1.25x). Fine points stop at width 1024
    to bound the compiled-shape count; the streamed X solve can't split
    rows (each row solves in exactly one chunk), so long rows stay on
    the pow2 tail of the grid. Ragged tail chunks round their row count
    to the next power of two instead of padding to a full chunk.

    fine_max_width: where the fine grid points stop (pure pow2 above);
    the direct-theta hugewiki path raises this to 2^18 because ALL its
    rows are tens of thousands of nonzeros long.
    row_mask: optional bool (num_rows,) — rows where False are treated
    as empty (planned elsewhere, e.g. the hot-row segment path)."""
    row_nnz = np.diff(csr.indptr).astype(np.int64)
    if row_mask is not None:
        row_nnz = np.where(row_mask, row_nnz, 0)
    assign = assign_rows_balanced(row_nnz, n_dev)
    m_loc = -(-csr.num_rows // n_dev)
    global_ids = np.full((n_dev, m_loc), csr.num_rows, np.int32)
    local_of = np.zeros(csr.num_rows, np.int32)
    for d in range(n_dev):
        rows_d = np.nonzero(assign == d)[0]
        global_ids[d, :rows_d.size] = rows_d
        local_of[rows_d] = np.arange(rows_d.size, dtype=np.int32)

    # Global bucket widths so all devices agree.
    max_nnz = int(row_nnz.max()) if row_nnz.size else 1
    if octave_points > 0:
        widths = make_width_grid(min_width, max(1, max_nnz),
                                 max_width=fine_max_width,
                                 octave_points=octave_points)
    else:
        widths = []
        w = max(8, _next_pow2(min_width))
        top = max(w, _next_pow2(max(1, max_nnz)))
        while w <= top:
            widths.append(w)
            w *= 2

    # Per device, group nonempty rows by bucket.
    per_dev_buckets: List[List[np.ndarray]] = []
    for d in range(n_dev):
        rows_d = np.nonzero((assign == d) & (row_nnz > 0))[0]
        b_of = np.searchsorted(widths, row_nnz[rows_d])
        per_dev_buckets.append(
            [rows_d[b_of == b] for b in range(len(widths))])

    chunks: List[ShardedChunk] = []
    for b, width in enumerate(widths):
        rows_per_chunk = _rows_per_chunk(width, chunk_nnz, chunk_rows)
        n_rows_max = max(per_dev_buckets[d][b].size
                         for d in range(n_dev))
        n_chunks = -(-n_rows_max // rows_per_chunk) if n_rows_max else 0
        arange_w = np.arange(width, dtype=np.int64)[None, :]
        for c in range(n_chunks):
            # ragged tail: pad the last chunk to the next power of two
            # of the largest per-device remainder, not to a full chunk
            k_max = min(n_rows_max - c * rows_per_chunk, rows_per_chunk)
            r_c = min(rows_per_chunk, _next_pow2(max(8, k_max)))
            if lazy:
                grows = [per_dev_buckets[d][b][c * rows_per_chunk:
                                               (c + 1) * rows_per_chunk]
                         for d in range(n_dev)]
                lrows = [local_of[g] for g in grows]
                chunks.append(LazyShardedChunk(
                    csr, width, grows, lrows, r_c, m_loc,
                    lens_all=row_nnz))
                continue
            rows = np.full((n_dev, r_c), m_loc, np.int32)
            nnz = np.zeros((n_dev, r_c), np.int32)
            cols = np.full((n_dev, r_c, width), csr.num_cols,
                           np.int32)
            vals = np.zeros((n_dev, r_c, width), np.float32)
            for d in range(n_dev):
                rows_d = per_dev_buckets[d][b][c * rows_per_chunk:
                                               (c + 1) * rows_per_chunk]
                k = rows_d.size
                if k == 0:
                    continue
                lens = (csr.indptr[rows_d + 1] -
                        csr.indptr[rows_d]).astype(np.int32)
                offs = np.asarray(csr.indptr)[rows_d].astype(np.int64)
                idx = offs[:, None] + arange_w
                mask = arange_w < lens[:, None]
                idx = np.where(mask, idx, 0)
                rows[d, :k] = local_of[rows_d]
                nnz[d, :k] = lens
                cols[d, :k] = np.where(mask, csr.indices[idx],
                                       csr.num_cols)
                vals[d, :k] = np.where(mask, csr.data[idx], 0.0)
            chunks.append(ShardedChunk(width=width, rows=rows, nnz=nnz,
                                       cols=cols, vals=vals))
    return ShardedRowPlan(n_dev=n_dev, m=csr.num_rows, m_loc=m_loc,
                          global_ids=global_ids, num_cols=csr.num_cols,
                          chunks=chunks)


@dataclasses.dataclass
class ReduceBlock:
    """One all-reduced block of the small-factor update: all devices hold the
    same small-factor rows; cols are LOCAL large-factor ids."""
    width: int
    rows: np.ndarray       # (C,) int32 global small-factor row ids
    nnz_local: np.ndarray  # (n_dev, C) int32 per-device ratings count
    nnz_total: np.ndarray  # (C,) int32 total ratings count (for lambda)
    cols: np.ndarray       # (n_dev, C, P) int32 LOCAL ids into x shard
    vals: np.ndarray       # (n_dev, C, P) float32


@dataclasses.dataclass
class ReducePlan:
    n_dev: int
    n: int                 # small-factor rows
    m_loc: int             # local large-factor shard size (gather table)
    blocks: List[ReduceBlock]


def build_reduce_plan(csc: CSRMatrix, row_plan: ShardedRowPlan,
                      block_rows: int = 1 << 14,
                      chunk_nnz: int = 1 << 22,
                      octave_points: int = 8) -> ReducePlan:
    """Build the data-parallel small-factor plan from the transpose view.

    csc: rows = small-factor ids, cols = large-factor ids (global).
    Ratings are split by which device owns the large-factor row. Rows
    are bucketed by the power-of-two-grid width of their largest
    per-device rating count (the padded gather width is the max over
    devices), then buckets split into blocks bounded by block_rows rows
    AND chunk_nnz per-device padded nonzeros — the same layout law as
    the X side. (The earlier fixed-1024-row nnz-sorted blocks padded
    every row to the block's hottest row: 1.55x expansion and 469
    dispatches on Netflix; bucketing gets ~1.1x in ~40.)
    """
    n_dev = row_plan.n_dev
    n = csc.num_rows
    row_nnz = np.diff(csc.indptr).astype(np.int64)

    # device owner + local id of each large-factor (column) id
    owner = np.full(row_plan.m + 1, 0, np.int32)
    local = np.full(row_plan.m + 1, row_plan.m_loc, np.int32)
    for d in range(n_dev):
        ids = row_plan.global_ids[d]
        valid = ids < row_plan.m
        owner[ids[valid]] = d
        local[ids[valid]] = np.arange(row_plan.m_loc, dtype=np.int32)[valid]

    indptr = np.asarray(csc.indptr, np.int64)
    dev_flat = owner[csc.indices].astype(np.int64)
    row_flat = np.repeat(np.arange(n, dtype=np.int64), row_nnz)
    # per-(device, row) rating count -> per-row padded gather width
    counts_dr = np.bincount(dev_flat * n + row_flat,
                            minlength=n_dev * n).reshape(n_dev, n)
    max_local = counts_dr.max(axis=0)
    max_w = int(max_local.max()) if n else 1
    # fine widths only below 1024: the hot-row tail holds few rows, so
    # pure powers of two there cost ~nothing in padding but divide the
    # compiled-shape count by ~2
    widths = make_width_grid(8, max(1, max_w), max_width=1024,
                             octave_points=octave_points)
    wof = np.searchsorted(widths, max_local)

    nonempty = np.nonzero(row_nnz > 0)[0]
    border = np.argsort(wof[nonempty], kind="stable")
    nonempty = nonempty[border]
    starts = np.searchsorted(wof[nonempty], np.arange(len(widths) + 1))

    blocks: List[ReduceBlock] = []
    for wi, width in enumerate(widths):
        rows_w = nonempty[starts[wi]:starts[wi + 1]]
        if rows_w.size == 0:
            continue
        rpc = _rows_per_chunk(width, chunk_nnz, block_rows)
        for lo in range(0, rows_w.size, rpc):
            rows_b = rows_w[lo:lo + rpc]
            b = rows_b.size
            c_pad = rpc if b == rpc else max(8, -(-b // 8) * 8)
            lens = row_nnz[rows_b]
            total = int(lens.sum())
            # flat (local_row, device, local_col, val) for the block,
            # via a vectorized ragged gather
            sub_indptr = np.zeros(b + 1, np.int64)
            np.cumsum(lens, out=sub_indptr[1:])
            pos = (np.arange(total, dtype=np.int64)
                   - np.repeat(sub_indptr[:-1], lens)
                   + np.repeat(indptr[rows_b], lens))
            lrow = np.repeat(np.arange(b, dtype=np.int64), lens)
            gcol = csc.indices[pos]
            dev = owner[gcol].astype(np.int64)
            lcol = local[gcol]
            val = csc.data[pos]
            # group by (device, local_row) with one stable sort
            key = dev * c_pad + lrow
            sort = np.argsort(key, kind="stable")
            key_s = key[sort]
            counts = np.bincount(key_s, minlength=n_dev * c_pad)
            nnz_local = counts.reshape(n_dev, c_pad).astype(np.int32)
            nnz_total = np.zeros(c_pad, np.int32)
            nnz_total[:b] = lens
            run_start = np.zeros(n_dev * c_pad, np.int64)
            np.cumsum(counts[:-1], out=run_start[1:])
            offset = np.arange(total, dtype=np.int64) - run_start[key_s]
            flat = key_s * width + offset
            cols = np.full(n_dev * c_pad * width, row_plan.m_loc,
                           np.int32)
            vals = np.zeros(n_dev * c_pad * width, np.float32)
            cols[flat] = lcol[sort]
            vals[flat] = val[sort]
            rows_out = np.full(c_pad, n, np.int32)
            rows_out[:b] = rows_b
            blocks.append(ReduceBlock(
                width=width, rows=rows_out, nnz_local=nnz_local,
                nnz_total=nnz_total,
                cols=cols.reshape(n_dev, c_pad, width),
                vals=vals.reshape(n_dev, c_pad, width)))
    return ReducePlan(n_dev=n_dev, n=n, m_loc=row_plan.m_loc,
                      blocks=blocks)


class AlignedPanelChunk:
    """One lockstep panel step: every device's subrow chunk for the
    same (panel index, shape). Arrays carry a leading device axis;
    devices with fewer chunks in this (panel, width) group get dummy
    rows (nnz 0, sentinel cols) that contribute zero partials."""

    __slots__ = ("panel", "width", "rows", "nnz", "cols", "vals")

    def __init__(self, panel, width, rows, nnz, cols, vals):
        self.panel = panel
        self.width = width
        self.rows = rows      # (n_dev, R) local row ids, sentinel dummies
        self.nnz = nnz        # (n_dev, R) subrow lengths
        self.cols = cols      # (n_dev, R, P) panel-LOCAL gather ids
        self.vals = vals      # (n_dev, R, P)

    def materialize(self):
        return self.rows, self.nnz, self.cols, self.vals


class LazyAlignedPanelChunk:
    """Aligned step over per-device lazy chunks (anything whose
    materialize() gives rows, nnz, cols, vals): the (n_dev, R, P)
    padded arrays materialize at stream time (hugewiki-scale form)."""

    __slots__ = ("panel", "width", "_per_dev", "_r", "_sentinel",
                 "_panel_size")

    def __init__(self, panel, width, per_dev, r, sentinel_row,
                 panel_size):
        self.panel = panel
        self.width = width
        self._per_dev = per_dev      # list of LazyPanelChunk or None
        self._r = r
        self._sentinel = sentinel_row
        self._panel_size = panel_size

    def materialize(self):
        n_dev = len(self._per_dev)
        r, width = self._r, self.width
        rows = np.full((n_dev, r), self._sentinel, np.int32)
        nnz = np.zeros((n_dev, r), np.int32)
        cols = np.full((n_dev, r, width), self._panel_size, np.int32)
        vals = np.zeros((n_dev, r, width), np.float32)
        for d, ch in enumerate(self._per_dev):
            if ch is not None:
                rows[d], nnz[d], cols[d], vals[d] = ch.materialize()
        return rows, nnz, cols, vals


@dataclasses.dataclass
class AlignedSteps:
    """A cacheable bundle of align_panel_plans output: the lockstep
    panel schedule plus its panel count (utils/plan_cache.py serializes
    this for the sharded paths)."""
    steps: List[AlignedPanelChunk]
    n_panels: int


def align_panel_plans(plans, sentinel_row: int, panel_size: int):
    """Merge per-device PanelPlans into a lockstep schedule: for each
    panel index, chunks grouped by shape and padded with dummy chunks so
    all devices run the same steps. `sentinel_row` is the
    dummy-row scatter id (one past the valid accumulator rows)."""
    n_dev = len(plans)
    n_panels = max(p.n_panels for p in plans)
    steps: List[AlignedPanelChunk] = []
    for pi in range(n_panels):
        # shape -> list of per-device chunk lists
        by_shape = {}
        for d, plan in enumerate(plans):
            for ch in plan.chunks:
                if ch.panel != pi:
                    continue
                key = (ch.rows.shape[0], ch.width)
                by_shape.setdefault(key, [[] for _ in range(n_dev)])
                by_shape[key][d].append(ch)
        for (r, width), per_dev in sorted(by_shape.items()):
            count = max(len(c) for c in per_dev)
            for k in range(count):
                members = [per_dev[d][k] if k < len(per_dev[d]) else None
                           for d in range(n_dev)]
                if any(not hasattr(ch, "cols") for ch in members
                       if ch is not None):
                    # lazy chunks: defer the (n_dev, R, P) copy
                    steps.append(LazyAlignedPanelChunk(
                        pi, width, members, r, sentinel_row, panel_size))
                    continue
                rows = np.full((n_dev, r), sentinel_row, np.int32)
                nnz = np.zeros((n_dev, r), np.int32)
                cols = np.full((n_dev, r, width), panel_size, np.int32)
                vals = np.zeros((n_dev, r, width), np.float32)
                for d in range(n_dev):
                    if members[d] is not None:
                        ch = members[d]
                        rows[d] = ch.rows
                        nnz[d] = ch.nnz
                        cols[d] = ch.cols
                        vals[d] = ch.vals
                steps.append(AlignedPanelChunk(pi, width, rows, nnz,
                                               cols, vals))
    return steps, n_panels


def build_sharded_x_panel_steps(csr: CSRMatrix, row_plan: ShardedRowPlan,
                                panel_size: int, min_width: int = 8,
                                chunk_nnz: int = 1 << 22,
                                chunk_rows: int = 1 << 14,
                                split_width: int = 4096,
                                octave_points: int = 8):
    """Panelized layout for the sharded LARGE-factor phase: per-device
    panel plans over each device's local row shard (cols = panel-local
    ids into the replicated small factor), aligned into lockstep steps.

    This brings the single-device PanelPlan optimization (gather tables
    <= panel_size rows stay at on-chip gather rate) to the sharded X-phase,
    which otherwise gathers from the full replicated table at HBM rate.
    Returns (steps, n_panels)."""
    n_dev = row_plan.n_dev
    m = row_plan.m
    m_loc = row_plan.m_loc
    indptr = np.asarray(csr.indptr, np.int64)
    row_nnz = np.diff(indptr)
    plans = []
    for d in range(n_dev):
        ids = row_plan.global_ids[d]
        valid = ids < m
        lens = np.zeros(m_loc, np.int64)
        lens[valid] = row_nnz[ids[valid]]
        sub_indptr = np.zeros(m_loc + 1, np.int64)
        np.cumsum(lens, out=sub_indptr[1:])
        total = int(sub_indptr[-1])
        starts = np.zeros(m_loc, np.int64)
        starts[valid] = indptr[ids[valid]]
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(sub_indptr[:-1], lens)
               + np.repeat(starts, lens))
        sub = CSRMatrix(indptr=sub_indptr, indices=csr.indices[pos],
                        data=csr.data[pos], num_rows=m_loc,
                        num_cols=csr.num_cols)
        plans.append(build_panel_plan(
            sub, panel_size=panel_size, min_width=min_width,
            chunk_nnz=chunk_nnz, chunk_rows=chunk_rows,
            split_width=split_width, octave_points=octave_points))
    return align_panel_plans(plans, m_loc, panel_size)
