"""Row bucketing / padding plans (host numpy).

A copy of the JAX package's ops/tiling.py, so that a plan here is array
for array the JAX package's plan. Chunks are materialized by the native
data plane when its library is built, else by numpy; the two give the
same arrays. Rows are
grouped into buckets of a few widths per octave, each row's column list
is padded to its bucket's width, and buckets are cut into chunks of at
most `chunk_nnz` padded slots and `chunk_rows` rows. The padding
contract the kernels rely on:

  - `cols` pads with the id one past the gather table, whose row is
    zero, and `vals` pads with 0, so pad slots add nothing;
  - pad slots sit at the tail of each row (the kernels may stop at the
    row's nnz); a SplitChunk pads each part's segment at its own tail
    instead and is compacted (flatten_split_chunk) before a kernel sees
    it;
  - ragged tail rows of a chunk have `rows == num_rows`, `nnz == 0` and
    all-pad slots; the write-back skips them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from cumf_als_tpu_torch.utils.io import CSRMatrix


@dataclasses.dataclass
class PlanChunk:
    """One unit of work: R rows, each padded to width P."""
    width: int            # P
    rows: np.ndarray      # (R,) int32, == num_rows for dummy tail rows
    nnz: np.ndarray       # (R,) int32 true row lengths
    cols: np.ndarray      # (R, P) int32 gather indices into the fixed factor
    vals: np.ndarray      # (R, P) float32 ratings, 0-padded

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def padded_nnz(self) -> int:
        return self.rows.shape[0] * self.width


@dataclasses.dataclass
class UpdatePlan:
    """Bucketed layout of one side of the ALS update (X or theta phase)."""
    num_rows: int         # rows of the factor being updated (m or n)
    num_cols: int         # rows of the gather table (n or m)
    chunks: List[PlanChunk]
    true_nnz: int
    padded_nnz: int

    @property
    def expansion(self) -> float:
        return self.padded_nnz / max(1, self.true_nnz)


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def make_width_grid(min_width: int, max_len: int, fine: bool = True,
                    max_width: Optional[int] = None,
                    octave_points: int = 4) -> List[int]:
    """Bucket widths: powers of two, plus the quarter-octave points
    (5/4, 3/2, 7/4 * 2^k) from 16 up when `fine`, the eighth-octave
    points from 64 up when octave_points >= 8 and the sixteenth-octave
    points from 256 up when octave_points >= 16. Above `max_width` only
    powers of two remain. The grid stops at the first width >= max_len."""
    grid = set()
    w = max(8, _next_pow2(min_width))
    top = max(w, _next_pow2(max(1, max_len)))
    while w <= top:
        grid.add(w)
        if fine and (max_width is None or w < max_width):
            grid.add(w * 3 // 2)
            if w >= 16:
                grid.add(w * 5 // 4)
                grid.add(w * 7 // 4)
            if octave_points >= 8 and w >= 64:
                grid.add(w * 9 // 8)
                grid.add(w * 11 // 8)
                grid.add(w * 13 // 8)
                grid.add(w * 15 // 8)
            if octave_points >= 16 and w >= 256:
                for q in range(17, 32, 2):
                    grid.add(w * q // 16)
        w *= 2
    widths = sorted(x for x in grid
                    if max_width is None or x <= max_width
                    or (x & (x - 1)) == 0)
    cut = next(x for x in widths if x >= max_len)
    return [x for x in widths if x <= cut]


def _round_rows(r: int, cap: int) -> int:
    """Row count of a ragged final chunk: the next multiple of 8 up to
    128, then the next 4-bit-mantissa value ({8..15} * 2^e), at most
    `cap`."""
    if r >= cap:
        return cap
    r8 = max(8, -(-r // 8) * 8)
    if r8 <= 128:
        return min(cap, r8)
    e = r8.bit_length() - 4
    return min(cap, -(-r8 >> e) << e)


def _rows_per_chunk(width: int, chunk_nnz: int, chunk_rows: int) -> int:
    """Rows per full chunk: a power of two, at least 8."""
    r = max(8, min(chunk_nnz // width, chunk_rows))
    return 1 << (r.bit_length() - 1)


def build_update_plan(
    csr: CSRMatrix,
    min_width: int = 8,
    max_width: int = 1 << 18,
    chunk_nnz: int = 1 << 22,
    chunk_rows: int = 1 << 14,
    widths: Optional[Sequence[int]] = None,
    octave_points: int = 4,
) -> UpdatePlan:
    """The direct route's plan: every nonempty row once, whole, in the
    smallest bucket that holds it. Empty rows are left out (their
    factors are zeroed by the training loop)."""
    row_nnz = np.diff(csr.indptr).astype(np.int64)
    max_nnz = int(row_nnz.max()) if row_nnz.size else 0
    if widths is None:
        widths = make_width_grid(min_width, max_nnz, max_width=max_width,
                                 octave_points=octave_points)
    widths = sorted(set(int(w) for w in widths))

    nonempty = np.nonzero(row_nnz > 0)[0]
    bucket_of = np.searchsorted(widths, row_nnz[nonempty])
    order = np.argsort(bucket_of, kind="stable")
    nonempty = nonempty[order]
    bucket_of = bucket_of[order]

    chunks: List[PlanChunk] = []
    padded_total = 0
    starts = np.searchsorted(bucket_of, np.arange(len(widths) + 1))
    for b, width in enumerate(widths):
        rows_b = nonempty[starts[b]:starts[b + 1]]
        if rows_b.size == 0:
            continue
        rows_per_chunk = _rows_per_chunk(width, chunk_nnz, chunk_rows)
        for lo in range(0, rows_b.size, rows_per_chunk):
            rows_c = rows_b[lo:lo + rows_per_chunk]
            r = rows_c.size
            r_pad = rows_per_chunk if r == rows_per_chunk else \
                _round_rows(r, rows_per_chunk)
            chunk = _materialize_chunk(csr, rows_c, width, r_pad)
            chunks.append(chunk)
            padded_total += chunk.padded_nnz
    return UpdatePlan(num_rows=csr.num_rows, num_cols=csr.num_cols,
                      chunks=chunks, true_nnz=int(row_nnz.sum()),
                      padded_nnz=padded_total)


@dataclasses.dataclass
class PanelChunk:
    """A bucket chunk whose gathers address one column panel only: `cols`
    are panel-local (0..panel_size-1), padded with `panel_size` (the zero
    row appended to the panel). Its partial (A, b) are scatter-added into
    the phase accumulators at `rows`."""
    panel: int
    width: int
    rows: np.ndarray   # (R,) int32, == num_rows for dummy tails
    nnz: np.ndarray    # (R,) int32 subrow length
    cols: np.ndarray   # (R, P) int32 panel-local
    vals: np.ndarray   # (R, P) float32


@dataclasses.dataclass
class PanelPlan:
    """Panel route layout: each row's (sorted) column list is split at
    panel boundaries into subrows, and a row's Gram is the sum of its
    subrows' partial Grams."""
    num_rows: int
    num_cols: int
    panel_size: int
    n_panels: int
    chunks: List[PanelChunk]
    row_nnz: np.ndarray    # (num_rows,) int32 total nnz per row
    true_nnz: int
    padded_nnz: int

    @property
    def expansion(self) -> float:
        return self.padded_nnz / max(1, self.true_nnz)


def build_panel_plan(csr: CSRMatrix, panel_size: int = 1 << 16,
                     min_width: int = 8, chunk_nnz: int = 1 << 22,
                     chunk_rows: int = 1 << 14,
                     split_width: int = 4096,
                     octave_points: int = 4,
                     min_bucket_rows: int = 0) -> PanelPlan:
    """Split each row's column list at panel boundaries (cols are sorted
    within rows, so subrows are contiguous slices), cut subrows longer
    than `split_width` into exact segments plus a remainder, then bucket
    subrows by width per (panel, width) group.

    `min_bucket_rows` merges a (panel, width) group of fewer subrows into
    the next width up. The batched-panel plan uses it (one sub-plan per
    row batch would otherwise scatter its work over many tiny chunks)."""
    m = csr.num_rows
    n_panels = -(-csr.num_cols // panel_size)
    row_nnz = np.diff(csr.indptr).astype(np.int64)
    nnz_total = int(row_nnz.sum())

    # Subrow table: a subrow is a maximal run of one row's columns in one
    # panel; run starts are panel changes on the flat axis unioned with
    # row starts, owners recovered by searchsorted.
    if panel_size & (panel_size - 1) == 0:
        p_flat = csr.indices >> int(np.log2(panel_size))
    else:
        p_flat = csr.indices // np.int32(panel_size)
    if nnz_total:
        pc = np.flatnonzero(p_flat[1:] != p_flat[:-1]).astype(np.int64) + 1
        indptr64 = np.asarray(csr.indptr[:-1], np.int64)
        starts = np.unique(np.concatenate([pc, indptr64]))
        starts = starts[starts < nnz_total]
        ends = np.concatenate([starts[1:],
                               np.asarray([nnz_total], np.int64)])
        # owner row: largest r with indptr[r] <= start (empty rows share
        # start values and lose the tie to the owning nonempty row)
        sub_rows = (np.searchsorted(csr.indptr, starts, side="right")
                    - 1).astype(np.int32)
        sub_panel = p_flat[starts].astype(np.int32)
    else:
        starts = np.zeros(0, np.int64)
        ends = np.zeros(0, np.int64)
        sub_rows = np.zeros(0, np.int32)
        sub_panel = np.zeros(0, np.int32)
    sub_off = starts
    sub_len = ends - starts

    # Split subrows longer than split_width into exact segments + rest.
    if split_width and sub_len.size and int(sub_len.max()) > split_width:
        n_full = sub_len // split_width
        rem = sub_len - n_full * split_width
        counts = (n_full + (rem > 0)).astype(np.int64)
        idx = np.repeat(np.arange(sub_len.size, dtype=np.int64), counts)
        excl = np.zeros(sub_len.size, np.int64)
        np.cumsum(counts[:-1], out=excl[1:])
        seg_i = np.arange(idx.size, dtype=np.int64) - excl[idx]
        sub_off = sub_off[idx] + seg_i * split_width
        sub_len = np.where(seg_i < n_full[idx], split_width, rem[idx])
        sub_rows = sub_rows[idx]
        sub_panel = sub_panel[idx]

    max_len = int(sub_len.max()) if sub_len.size else 1
    widths = make_width_grid(min_width, max_len,
                             octave_points=octave_points)
    widx = np.searchsorted(widths, sub_len)

    # Sparse-bucket promotion: a (panel, width) group with fewer than
    # min_bucket_rows subrows joins the next width up.
    if min_bucket_rows > 1 and sub_len.size:
        nw = len(widths)
        counts = np.bincount(sub_panel.astype(np.int64) * nw + widx,
                             minlength=n_panels * nw).reshape(n_panels,
                                                              nw)
        fmap = np.tile(np.arange(nw), (n_panels, 1))
        for p in range(n_panels):
            c = counts[p].astype(np.int64)
            for b in range(nw - 1):
                if 0 < c[b] < min_bucket_rows:
                    c[b + 1] += c[b]
                    c[b] = 0
                    fmap[p, fmap[p] == b] = b + 1
        widx = fmap[sub_panel, widx]

    # group subrows by (panel, width) with one argsort
    group = sub_panel.astype(np.int64) * len(widths) + widx
    order = np.argsort(group, kind="stable")
    group_sorted = group[order]
    bounds = np.searchsorted(
        group_sorted, np.arange(n_panels * len(widths) + 1))

    from cumf_als_tpu_torch import native
    use_native = native.available()
    chunks: List[PanelChunk] = []
    padded = 0
    for gid in range(n_panels * len(widths)):
        sel = order[bounds[gid]:bounds[gid + 1]]
        if sel.size == 0:
            continue
        p, b = divmod(gid, len(widths))
        width = widths[b]
        base = p * panel_size
        rows_per_chunk = _rows_per_chunk(width, chunk_nnz, chunk_rows)
        arange_w = np.arange(width, dtype=np.int64)[None, :]
        for lo_i in range(0, sel.size, rows_per_chunk):
            part = sel[lo_i:lo_i + rows_per_chunk]
            k = part.size
            r_pad = rows_per_chunk if k == rows_per_chunk else \
                _round_rows(k, rows_per_chunk)
            if use_native:
                rows, nnz, cols, vals = native.materialize_subrows(
                    csr.indices, csr.data, sub_off[part], sub_len[part],
                    sub_rows[part], r_pad, width, base, panel_size, m)
                chunks.append(PanelChunk(panel=p, width=width, rows=rows,
                                         nnz=nnz, cols=cols, vals=vals))
                padded += r_pad * width
                continue
            rows = np.full(r_pad, m, np.int32)
            nnz = np.zeros(r_pad, np.int32)
            cols = np.full((r_pad, width), panel_size, np.int32)
            vals = np.zeros((r_pad, width), np.float32)
            lens = sub_len[part]
            idx = sub_off[part][:, None] + arange_w
            mask = arange_w < lens[:, None]
            idx = np.where(mask, idx, 0)
            rows[:k] = sub_rows[part]
            nnz[:k] = lens
            cols[:k] = np.where(mask, csr.indices[idx] - base, panel_size)
            vals[:k] = np.where(mask, csr.data[idx], 0.0)
            chunks.append(PanelChunk(panel=p, width=width, rows=rows,
                                     nnz=nnz, cols=cols, vals=vals))
            padded += r_pad * width
    return PanelPlan(num_rows=m, num_cols=csr.num_cols,
                     panel_size=panel_size, n_panels=n_panels,
                     chunks=chunks,
                     row_nnz=row_nnz.astype(np.int32),
                     true_nnz=int(row_nnz.sum()), padded_nnz=padded)


@dataclasses.dataclass
class SplitChunk:
    """A bucket chunk whose gather indices are split across fixed-size
    *parts* of the (permuted) gather table. The row's G block is the
    concatenation of the per-part gathers along the contraction axis, so
    one fused Gram+CG instance still sees the whole row and no partial
    Gram accumulators exist on this route.

    Contract:
      - `parts[i]` is the part id of `cols[i]` (ascending);
      - `cols[i]` is (R, widths[i]) int32 LOCAL to that part, padded
        with part_size (each part's gather table carries one zero
        extension row at index part_size);
      - `vals` is (R, sum(widths)) f32, segment i aligned with cols[i]
        in concatenation order, 0-padded;
      - dummy tail rows have rows == num_rows and nnz == 0.

    Every segment pads at its OWN tail, so inside one row live slots of
    a later part follow pad slots of an earlier one, and `nnz` is the
    row's true total: a consumer that stops at nnz must compact the row
    first (flatten_split_chunk).
    """
    parts: tuple          # included part ids, ascending
    widths: tuple         # per included part: padded width
    rows: np.ndarray      # (R,) int32
    nnz: np.ndarray       # (R,) int32 true total row lengths
    cols: tuple           # per included part: (R, W_i) int32 part-local
    vals: np.ndarray      # (R, sum(widths)) float32

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def width(self) -> int:
        return int(sum(self.widths))

    @property
    def padded_nnz(self) -> int:
        return self.num_rows * self.width


@dataclasses.dataclass
class SplitPlan:
    """Direct (non-accumulating) phase layout over a popularity-permuted,
    part-split gather table, for phases whose gather table AND
    accumulators are both large. `perm` maps permuted slot -> original
    table row; part k of the permuted table is rows [k*part_size,
    (k+1)*part_size). The popularity ordering concentrates the nonzero
    mass in part 0, which keeps the per-part padding tails small."""
    num_rows: int
    num_cols: int          # gather-table rows (original space)
    part_size: int
    n_parts: int
    perm: np.ndarray       # (num_cols,) int32
    chunks: List[SplitChunk]
    true_nnz: int
    padded_nnz: int

    @property
    def expansion(self) -> float:
        return self.padded_nnz / max(1, self.true_nnz)


def flatten_split_chunk(chunk: SplitChunk, plan: SplitPlan) -> PlanChunk:
    """A SplitChunk in the layout of the direct route, for kernels that
    gather themselves and stop at each row's nnz.

    With the gather inside the kernels there is no per-part gather to
    keep small, so the per-part column blocks are joined into ONE id
    space over the permuted table (part k's local id c becomes
    k * part_size + c, every pad slot the id num_cols of the one zero
    row), and each row is compacted: live slots first, in their stored
    order, pad slots at the tail."""
    s, pad = plan.part_size, plan.num_cols
    cols = np.concatenate(
        [np.where(c == s, pad, c + k * s)
         for k, c in zip(chunk.parts, chunk.cols)], axis=1).astype(np.int32)
    order = np.argsort(cols == pad, axis=1, kind="stable")
    return PlanChunk(width=chunk.width, rows=chunk.rows, nnz=chunk.nnz,
                     cols=np.take_along_axis(cols, order, axis=1),
                     vals=np.take_along_axis(chunk.vals, order, axis=1))


def _merge_tuple_groups(raw_groups, grid_w, max_groups: int):
    """Greedy min-cost merging of lexicographically adjacent width-tuple
    groups: (a) until the group count is at most max_groups, and (b)
    beyond that whenever a merge SAVES padding: merging two groups pads
    every row to the elementwise-max tuple, but NOT merging pays each
    group's ragged chunk tail (8-row minimum + mantissa rounding), which
    dominates for the long tail of tiny tuple groups.

    raw_groups: [(lo, hi, widx)] over the lex-sorted row order, widx the
    per-part width-grid INDEX tuple (0 = part unused). Returns
    [(lo, hi, per-part grid widths)].
    """
    import heapq

    n = len(raw_groups)
    if n == 0:
        return []
    lo = [g[0] for g in raw_groups]
    hi = [g[1] for g in raw_groups]
    wid = [g[2] for g in raw_groups]
    rows = [h - l for l, h in zip(lo, hi)]
    nxt = list(range(1, n)) + [-1]
    prv = [-1] + list(range(n - 1))
    alive = [True] * n
    ver = [0] * n

    def wsum(i):
        return int(grid_w(wid[i]).sum())

    def ragged(r, s):
        # padding the ragged chunk tail costs: dummy rows up to the
        # 8-row floor plus ~6% mantissa rounding of one chunk
        return (max(8, -(-r // 8) * 8) - r) * s + (s * min(r, 128)) // 16

    def cost(i, j):
        wm = np.maximum(wid[i], wid[j])
        sm = int(grid_w(wm).sum())
        merge_pad = rows[i] * (sm - wsum(i)) + rows[j] * (sm - wsum(j))
        save = ragged(rows[i], wsum(i)) + ragged(rows[j], wsum(j)) \
            - ragged(rows[i] + rows[j], sm)
        return merge_pad - save

    heap = []
    for i in range(n - 1):
        heapq.heappush(heap, (cost(i, i + 1), ver[i], ver[i + 1], i,
                              i + 1))
    count = n
    while heap:
        c, vi, vj, i, j = heapq.heappop(heap)
        if not (alive[i] and alive[j]) or ver[i] != vi or ver[j] != vj \
                or nxt[i] != j:
            continue
        if c >= 0 and count <= max_groups:
            break
        # merge j into i
        wid[i] = np.maximum(wid[i], wid[j])
        hi[i] = hi[j]
        rows[i] += rows[j]
        alive[j] = False
        nxt[i] = nxt[j]
        if nxt[i] >= 0:
            prv[nxt[i]] = i
        ver[i] += 1
        count -= 1
        if prv[i] >= 0:
            heapq.heappush(heap, (cost(prv[i], i), ver[prv[i]], ver[i],
                                  prv[i], i))
        if nxt[i] >= 0:
            heapq.heappush(heap, (cost(i, nxt[i]), ver[i], ver[nxt[i]],
                                  i, nxt[i]))
    return [(lo[i], hi[i], grid_w(wid[i])) for i in range(n) if alive[i]]


def build_split_plan(
    csr: CSRMatrix,
    part_size: int,
    min_width: int = 8,
    max_width: int = 1 << 18,
    chunk_nnz: int = 1 << 22,
    chunk_rows: int = 1 << 14,
    octave_points: int = 8,
    by_popularity: bool = True,
    max_groups: int = 96,
) -> SplitPlan:
    """The split route's plan: rows grouped by their quantized per-part
    width tuple, so every row in a group pads each part to ITS OWN
    quantized width; adjacent groups merge (_merge_tuple_groups) to
    bound the number of chunk shapes; per chunk, one padded column block
    per included part."""
    m, n = csr.num_rows, csr.num_cols
    row_nnz = np.diff(csr.indptr).astype(np.int64)
    nnz_total = int(row_nnz.sum())
    n_parts = max(1, -(-n // part_size))

    # Popularity permutation of the gather table: most-rated columns
    # first, so part 0 carries most of the mass.
    if by_popularity and n_parts > 1:
        pop = np.bincount(csr.indices, minlength=n)
        perm = np.argsort(-pop, kind="stable").astype(np.int32)
    else:
        perm = np.arange(n, dtype=np.int32)
    rank = np.empty(n, np.int32)
    rank[perm] = np.arange(n, dtype=np.int32)

    # Per-nonzero part/local ids and a stable (row, part) grouping.
    new_flat = rank[csr.indices]
    part_flat = (new_flat // part_size).astype(np.int32)
    local_flat = (new_flat - part_flat.astype(np.int64) * part_size
                  ).astype(np.int32)
    row_ids = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
    key = row_ids * n_parts + part_flat
    order = np.argsort(key, kind="stable")
    h = np.bincount(key, minlength=m * n_parts).reshape(m, n_parts)
    grp_off = np.zeros(m * n_parts + 1, np.int64)
    np.cumsum(h.reshape(-1), out=grp_off[1:])
    del key, row_ids, new_flat

    max_nnz = int(row_nnz.max()) if row_nnz.size else 0
    widths = make_width_grid(min_width, max_nnz, max_width=max_width,
                             octave_points=octave_points)
    warr = np.asarray(widths, np.int64)

    # rows in lexicographic order of their width-index tuples
    nonempty = np.nonzero(row_nnz > 0)[0]
    nw = len(warr)
    qidx = np.minimum(np.searchsorted(warr, h[nonempty]), nw - 1)
    qidx = np.where(h[nonempty] > 0, qidx + 1, 0).astype(np.int32)
    o = np.lexsort(tuple(qidx[:, k]
                         for k in range(n_parts - 1, -1, -1)))
    nonempty = nonempty[o]
    q_sorted = qidx[o]

    local_sorted = local_flat[order]
    vals_sorted = np.asarray(csr.data, np.float32)[order]

    if nonempty.size:
        change = np.any(q_sorted[1:] != q_sorted[:-1], axis=1)
        bounds = np.concatenate([[0], np.flatnonzero(change) + 1,
                                 [nonempty.size]])
    else:
        bounds = np.asarray([0, 0])

    def _grid_w(widx):
        return np.where(widx > 0, warr[np.maximum(widx - 1, 0)], 0)

    groups = _merge_tuple_groups(
        [(int(bounds[i]), int(bounds[i + 1]),
          q_sorted[int(bounds[i])].copy())
         for i in range(len(bounds) - 1)
         if bounds[i] < bounds[i + 1]],
        _grid_w, max_groups)

    chunks: List[SplitChunk] = []
    padded_total = 0
    for g_lo, g_hi, wq in groups:
        rows_g = nonempty[g_lo:g_hi]
        width = int(wq.sum())
        rows_per_chunk = _rows_per_chunk(width, chunk_nnz, chunk_rows)
        inc = np.nonzero(wq)[0]
        for lo in range(0, rows_g.size, rows_per_chunk):
            rows_c = rows_g[lo:lo + rows_per_chunk]
            r = rows_c.size
            r_pad = rows_per_chunk if r == rows_per_chunk else \
                _round_rows(r, rows_per_chunk)
            hc = h[rows_c]                       # (r, n_parts)
            cols_parts, vals_parts = [], []
            rows_out = np.full(r_pad, m, np.int32)
            rows_out[:r] = rows_c
            nnz_out = np.zeros(r_pad, np.int32)
            nnz_out[:r] = row_nnz[rows_c]
            for k in inc:
                wk = int(wq[k])
                ck = np.full((r_pad, wk), part_size, np.int32)
                vk = np.zeros((r_pad, wk), np.float32)
                offs = grp_off[rows_c * n_parts + k]
                lens = hc[:, k]
                arange_w = np.arange(wk, dtype=np.int64)[None, :]
                idx = offs[:, None] + arange_w
                mask = arange_w < lens[:, None]
                idx = np.where(mask, idx, 0)
                ck[:r] = np.where(mask, local_sorted[idx], part_size)
                vk[:r] = np.where(mask, vals_sorted[idx], 0.0)
                cols_parts.append(ck)
                vals_parts.append(vk)
            vals_cat = np.concatenate(vals_parts, axis=1) if vals_parts \
                else np.zeros((r_pad, 0), np.float32)
            chunk = SplitChunk(parts=tuple(int(k) for k in inc),
                               widths=tuple(int(wq[k]) for k in inc),
                               rows=rows_out, nnz=nnz_out,
                               cols=tuple(cols_parts), vals=vals_cat)
            chunks.append(chunk)
            padded_total += chunk.padded_nnz
    return SplitPlan(num_rows=m, num_cols=n, part_size=part_size,
                     n_parts=n_parts, perm=perm, chunks=chunks,
                     true_nnz=nnz_total, padded_nnz=padded_total)


@dataclasses.dataclass
class RowBatch:
    """One row batch of a BatchedPanelPlan: a panel sub-plan whose rows
    are batch-local (0..b-1, dummy tail rows carry id b)."""
    global_ids: np.ndarray   # (batch_rows,) int32, == num_rows for padding
    row_nnz: np.ndarray      # (batch_rows,) int32 total nnz
    plan: PanelPlan          # rows local to the batch


@dataclasses.dataclass
class BatchedPanelPlan:
    """Layout for phases where both sides are big: the gather table
    passes panel_size (so it is read in panels) and the updated factor's
    full accumulators pass the budget (so rows are taken in batches of
    `batch_rows` with one reusable (B, f, f) accumulator). Rows are
    sorted by nnz, so a batch's rows have similar widths."""
    num_rows: int
    num_cols: int
    panel_size: int
    batch_rows: int
    batches: List[RowBatch]
    true_nnz: int
    padded_nnz: int

    @property
    def expansion(self) -> float:
        return self.padded_nnz / max(1, self.true_nnz)


def build_batched_panel_plan(csr: CSRMatrix, panel_size: int = 1 << 16,
                             batch_rows: int = 1 << 14,
                             min_width: int = 8,
                             chunk_nnz: int = 1 << 22,
                             chunk_rows: int = 1 << 14,
                             split_width: int = 4096,
                             octave_points: int = 4,
                             min_bucket_rows: int = 16
                             ) -> BatchedPanelPlan:
    """Nonempty rows in descending nnz order (stable), cut into batches
    of `batch_rows`; each batch's rows, renumbered 0..b-1, get their own
    panel plan."""
    row_nnz = np.diff(csr.indptr).astype(np.int64)
    order = np.argsort(-row_nnz, kind="stable")
    order = order[row_nnz[order] > 0]
    batches: List[RowBatch] = []
    padded = true = 0
    for lo in range(0, order.size, batch_rows):
        ids = order[lo:lo + batch_rows]
        b = ids.size
        lens = row_nnz[ids]
        sub_indptr = np.zeros(b + 1, np.int64)
        np.cumsum(lens, out=sub_indptr[1:])
        total = int(sub_indptr[-1])
        # ragged gather of the batch rows' nonzeros
        pos = (np.arange(total, dtype=np.int64)
               - np.repeat(sub_indptr[:-1], lens)
               + np.repeat(np.asarray(csr.indptr)[ids].astype(np.int64),
                           lens))
        sub = CSRMatrix(indptr=sub_indptr, indices=csr.indices[pos],
                        data=csr.data[pos], num_rows=b,
                        num_cols=csr.num_cols)
        plan = build_panel_plan(sub, panel_size, min_width, chunk_nnz,
                                chunk_rows, split_width=split_width,
                                octave_points=octave_points,
                                min_bucket_rows=min_bucket_rows)
        gids = np.full(batch_rows, csr.num_rows, np.int32)
        gids[:b] = ids
        nnz_b = np.zeros(batch_rows, np.int32)
        nnz_b[:b] = lens
        batches.append(RowBatch(global_ids=gids, row_nnz=nnz_b,
                                plan=plan))
        padded += plan.padded_nnz
        true += plan.true_nnz
    return BatchedPanelPlan(num_rows=csr.num_rows, num_cols=csr.num_cols,
                            panel_size=panel_size, batch_rows=batch_rows,
                            batches=batches, true_nnz=true,
                            padded_nnz=padded)


def _materialize_chunk(csr: CSRMatrix, rows: np.ndarray, width: int,
                       r_pad: int) -> PlanChunk:
    from cumf_als_tpu_torch import native
    if native.available():
        rows_in = np.full(r_pad, -1, np.int32)   # -1: a dummy tail row
        rows_in[:rows.size] = rows
        rows_out, nnz, cols, vals = native.materialize_chunk(
            np.asarray(csr.indptr, np.int64), csr.indices, csr.data,
            rows_in, width, csr.num_cols, csr.num_rows, csr.num_rows)
        return PlanChunk(width=width, rows=rows_out, nnz=nnz, cols=cols,
                         vals=vals)
    return _materialize_numpy(csr, rows, width, r_pad)


def _materialize_numpy(csr: CSRMatrix, rows: np.ndarray, width: int,
                       r_pad: int) -> PlanChunk:
    r = rows.size
    nnz = np.diff(csr.indptr)[rows].astype(np.int32)
    offs = csr.indptr[rows].astype(np.int64)
    idx = offs[:, None] + np.arange(width, dtype=np.int64)[None, :]
    mask = np.arange(width, dtype=np.int32)[None, :] < nnz[:, None]
    idx = np.where(mask, idx, 0)
    cols = np.where(mask, csr.indices[idx], csr.num_cols).astype(np.int32)
    vals = np.where(mask, csr.data[idx], 0.0).astype(np.float32)
    if r_pad > r:
        pad = r_pad - r
        rows = np.concatenate([rows, np.full(pad, csr.num_rows)])
        nnz = np.concatenate([nnz, np.zeros(pad, np.int32)])
        cols = np.concatenate(
            [cols, np.full((pad, width), csr.num_cols, np.int32)])
        vals = np.concatenate([vals, np.zeros((pad, width), np.float32)])
    return PlanChunk(width=width, rows=rows.astype(np.int32), nnz=nnz,
                     cols=cols, vals=vals)
