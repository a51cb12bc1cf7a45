"""Sharded out-of-core ALS on torch.distributed (the JAX package's
parallel/sharded_ooc.py in PyTorch): the reference hugewiki app's three
mechanisms in one program (reference hugewiki/hugewiki.cu:2248-2888),
over ranks, one process and one device each.

  - X, the large factor, is row-sharded over the ranks, balanced by
    nonzero count (parallel/plan.py). Each rank holds its shard in pinned
    host memory in the store dtype (`x_store`, bf16 when factor_dtype is
    "bf16"; the reference's XT_h, hugewiki.cu:2300-2302) or, with
    x_placement="device", on its card (`_x_dev`, zero at the start);
  - X phase: the rank's chunks of the row plan stream to the card with
    their warm starts, are solved by K1 (`gather_gram_cg`; K6 with
    aug_gram="force") against the replicated theta, and the solved rows
    stream back two deep into the host shard (the reference's per-GPU
    streaming loop, hugewiki.cu:2447-2496), or are written in place into
    the device shard;
  - theta phase: for each panel of the rank's X rows, the panel goes to
    the card one panel ahead, and K2 (`gather_gram_out`) adds each step's
    partial (A, b) into the rank's accumulators; the accumulators are
    widened to f32 and summed over the ranks (`all_reduce`, in place of
    the anchor-GPU memcpy and cublasSaxpy, hugewiki.cu:2703-2730), then
    every rank solves all of theta at once with the diagonal (K3) and
    takes the train error from the summed raw A. At one rank with
    x_placement="device" theta takes the direct route instead: K1 on
    theta's rows against the device X, and the few columns with more
    than THETA_SEG_W ratings accumulated in segments by K2 (f32 out) and
    solved by K3;
  - above LAZY_NNZ_THRESHOLD ratings the plans are lazy: each chunk's
    padded arrays are made when it is streamed (hugewiki.cu:2508-2516),
    and with a plan cache the compacted arrays of the first pass are
    stored (utils/stream_cache.py) and read back memory-mapped after it.

Rank r computes what the JAX program computes on mesh device d = r: the
plans are the JAX package's, and a rank takes index r of their leading
axis. Every rank runs every step, so the ranks meet at each collective.
Each write is masked to a chunk's real rows (the JAX package drops the
dummy rows' writes with mode="drop"). Ids travel as 16 bits where their
table has at most 2^16 rows, and values as float16 with
stream_val_dtype="f16"; the kernels see int32 ids and f32 or bf16
values. Rank 0 alone prints and writes checkpoints and the metrics
JSONL; `unshard_x_host`, `fetch_x` and a due checkpoint gather X from
every rank, so every rank calls them.

Not ported, XLA dispatch and TPU-memory workarounds:
`call_with_vmem_backoff`, the grouping of theta steps by
`fuse_max_chunks`. At F > 128 (f_pad 256) the theta steps and the hot
segments go through K2 and K3 at f = 256, as at 128.
"""

from __future__ import annotations

import collections
import hashlib
import os
import sys
from types import SimpleNamespace
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.models import als
from cumf_als_tpu_torch.models.als import (ALSResult, IterationMetrics,
                                           _se_terms, accum_dtype,
                                           accumulate_panel, end_iteration,
                                           sum_r2)
from cumf_als_tpu_torch.models.out_of_core import (TEST_CHUNK, Streams,
                                                   _Chunk, _HostChunks,
                                                   _panel_runs, widen_ids,
                                                   widen_vals)
from cumf_als_tpu_torch.ops import cuda_solve
from cumf_als_tpu_torch.ops.gram import extend_table, gram_rhs
from cumf_als_tpu_torch.ops.precision import full_f32
from cumf_als_tpu_torch.ops.rmse import fused_sq_err
from cumf_als_tpu_torch.ops.solve import solve
from cumf_als_tpu_torch.ops.tiling import build_panel_plan
from cumf_als_tpu_torch.parallel.mesh import Mesh, current_mesh
from cumf_als_tpu_torch.parallel.plan import (AlignedSteps,
                                              align_panel_plans,
                                              build_sharded_row_plan)
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix
from cumf_als_tpu_torch.utils.plan_cache import (cached_build,
                                                 cached_transpose,
                                                 dataset_fingerprint,
                                                 plan_key)
from cumf_als_tpu_torch.utils.stream_cache import StreamCache
from cumf_als_tpu_torch.utils.timing import seconds, sync

# At this many ratings and above the plans are lazy (LazyShardedChunk,
# LazyPanelChunk): their padded arrays are made when streamed.
LAZY_NNZ_THRESHOLD = 1 << 28

# rows of the summed theta accumulators whose train-error terms are
# taken at once
SE_ROWS = 4096


def _maybe_log_rss(phase: str, step: int) -> None:
    """CUMF_RSS_LOG=N: the host's resident memory every N streamed steps
    (the reference's per-batch DEBUG printf, hugewiki.cu:2538-2572)."""
    every = int(os.environ.get("CUMF_RSS_LOG", "0"))
    if every and step % every == 0:
        with open("/proc/self/statm") as fh:
            rss = int(fh.read().split()[1]) * 4096 / 1e9
        print(f"[rss] {phase} step {step}: {rss:.2f} GB", file=sys.stderr,
              flush=True)


def _compact_ids(ids: np.ndarray, table_rows: int) -> np.ndarray:
    """uint16 ids where the table they name has at most 2^16 rows."""
    return ids.astype(np.uint16) if table_rows <= 1 << 16 else ids


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A tensor of a numpy array's values (a copy: the array may be a
    read-only page of a memory-mapped store); uint16 as int16 bits,
    which `widen_ids` reads back."""
    a = np.array(a)
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16
                            else a)


class _RankChunks:
    """One rank's part of a sharded plan's chunks (row chunks, aligned
    theta steps or direct theta chunks), uploaded in plan order.

    Eager chunks are packed once into pinned host tensors (`_HostChunks`).
    Lazy chunks are made when uploaded, compacted as the JAX package
    streams them: ids to 16 bits where `id_rows` (and, for the rows,
    `row_ids`) allow, values to float16 with `f16`. With a StreamCache
    the first pass stores every rank's compacted arrays (rank 0 writes,
    as the one JAX process does) and later passes read them."""

    def __init__(self, chunks, rank: int, num_rows: int, pin: bool,
                 id_rows: int, f16: bool, with_nnz: bool = True,
                 row_ids: Optional[int] = None,
                 cache: Optional[StreamCache] = None, writer: bool = True):
        self.chunks, self.rank, self.num_rows = chunks, rank, num_rows
        self.panel = [getattr(c, "panel", -1) for c in chunks]
        self.id_rows, self.f16, self.with_nnz = id_rows, f16, with_nnz
        self.row_ids, self.cache, self.writer = row_ids, cache, writer
        self.host = None
        if not any(not hasattr(c, "cols") for c in chunks):
            views = [SimpleNamespace(
                panel=p, width=c.width, rows=c.rows[rank], nnz=c.nnz[rank],
                cols=c.cols[rank], vals=c.vals[rank])
                for p, c in zip(self.panel, chunks)]
            self.host = _HostChunks(SimpleNamespace(
                chunks=views, num_rows=num_rows), pin, id_rows, f16)

    def __len__(self) -> int:
        return len(self.chunks)

    def real_rows(self, i: int) -> torch.Tensor:
        """The real rows of row chunk i (int64, on the host)."""
        rows = np.asarray(self.chunks[i].rows[self.rank])
        return torch.from_numpy(
            rows[rows < self.num_rows].astype(np.int64))

    def begin(self) -> None:
        """Before a pass: rank 0 starts building an unfinished store; the
        others look for one finished since."""
        if self.cache is None:
            return
        if self.writer:
            self.cache.begin()
        else:
            self.cache.refresh()

    def finish(self) -> None:
        if self.cache is not None and self.writer:
            self.cache.finish()

    def _arrays(self, k: int):
        """Chunk k's compacted (rows, nnz, cols, vals) of every rank."""
        sc = self.cache
        ent = sc.get(k) if sc is not None else None
        if ent is None:
            rows, nnz, cols, vals = self.chunks[k].materialize()
            if self.row_ids is not None:
                rows = _compact_ids(rows, self.row_ids)
            ent = dict(rows=rows, nnz=nnz,
                       cols=_compact_ids(cols, self.id_rows),
                       vals=vals.astype(np.float16) if self.f16 else vals)
            if not self.with_nnz:
                del ent["nnz"]
            if sc is not None and sc.building:
                sc.put(k, ent)
        return ent

    def upload(self, i: int, j: int, device: torch.device):
        """Chunks [i, j) on `device`, and the tensors they view (see
        _HostChunks.upload)."""
        if self.host is not None:
            return self.host.upload(i, j, device)
        out, bases = [], []
        for k in range(i, j):
            ent = self._arrays(k)
            r = self.rank
            rows = ent["rows"][r]
            t = [widen_ids(_host_tensor(rows).to(device)).long(),
                 _host_tensor(ent["nnz"][r]).to(device)
                 if "nnz" in ent else None,
                 widen_ids(_host_tensor(ent["cols"][r]).to(device)),
                 widen_vals(_host_tensor(ent["vals"][r]).to(device))]
            out.append(_Chunk(self.chunks[k].width, self.panel[k],
                              int(np.count_nonzero(
                                  rows.astype(np.int64) < self.num_rows)),
                              *t))
            bases += [a for a in t if a is not None]
        return out, bases


class ShardedOutOfCoreALS(Streams):
    """Sharded ALS with the large factor's shard in host memory (or, with
    x_placement="device", on the card) on every rank.

    `mesh` defaults to `parallel.mesh.current_mesh(device)`: the process
    group when one exists, the torchrun world, or one rank on `device`
    (CUDA unless "cpu"). `n_devices`, when given, must equal its world
    size. `lazy_nnz_threshold` is a test hook: when given, it takes the
    place of the module's LAZY_NNZ_THRESHOLD for this model, so that the
    tests and chip_smoke.py drive lazy plans at a small size, also in
    spawned ranks, which do not see a patched module."""

    # Above this many ratings a theta column's gathered row would not fit
    # one chunk: on the direct theta route it is accumulated in segments
    # of this many ratings (K2) and solved apart (K3).
    THETA_SEG_W = 1 << 18

    def __init__(self, cfg: ALSConfig, train_csr: CSRMatrix,
                 train_csc: Optional[CSRMatrix] = None,
                 test_coo: Optional[COOMatrix] = None,
                 n_devices: Optional[int] = None, device=None,
                 mesh: Optional[Mesh] = None,
                 lazy_nnz_threshold: Optional[int] = None):
        self.mesh = mesh or current_mesh(device)
        if n_devices is not None:
            self.mesh.require_world(n_devices)
        self.n_dev, self.rank = self.mesh.world_size, self.mesh.rank
        self.device = self.mesh.device
        self.cfg = cfg
        self.train_csr = train_csr
        self.test_coo = test_coo
        t0 = seconds()
        # rank 0 builds the CSC and the plans into the plan cache first;
        # the other ranks then load them (two ranks never write one entry)
        if cfg.plan_cache_dir and self.rank > 0:
            self.mesh.barrier()
        self._build_plans(train_csc, LAZY_NNZ_THRESHOLD
                          if lazy_nnz_threshold is None
                          else lazy_nnz_threshold)
        if cfg.plan_cache_dir and self.rank == 0:
            self.mesh.barrier()
        self._rank_plans()
        self._test = self._test_entries(test_coo)
        self._rank_cfg = cfg if self.rank == 0 else cfg.replace(
            verbose=False, debug_timing=False, metrics_jsonl=None,
            checkpoint_dir=None)
        self._open_streams(self.device)
        sync(self.device)   # the buffers' zeros land before a side stream
        self.plan_seconds = seconds() - t0

    # ----- plans (the JAX package's, under its cache kinds and keys) -----
    def _build_plans(self, train_csc, lazy_nnz: int) -> None:
        cfg, csr, n_dev = self.cfg, self.train_csr, self.n_dev
        cache = cfg.plan_cache_dir
        self.train_csc = train_csc or cached_transpose(cache, csr)
        csc = self.train_csc
        self.lazy = lazy = csr.nnz >= lazy_nnz
        row_params = dict(n_dev=n_dev, min_w=cfg.min_bucket_width,
                          max_w=cfg.max_bucket_width,
                          chunk_nnz=cfg.chunk_nnz,
                          chunk_rows=cfg.chunk_rows,
                          octave=cfg.octave_points)
        self.row_plan = cached_build(
            cache, "sh_row", csr, dict(row_params, lazy=lazy),
            lambda: build_sharded_row_plan(
                csr, n_dev, cfg.min_bucket_width, cfg.max_bucket_width,
                cfg.chunk_nnz, cfg.chunk_rows, lazy=lazy,
                octave_points=cfg.octave_points),
            csr_for_lazy=csr if lazy else None)
        m_loc = self.row_plan.m_loc
        # panel-local ids, the pad id (== panel_size) included, fit the
        # 16-bit transport
        self.panel_size = min(cfg.panel_size, (1 << 16) - 8)
        self._theta_direct = cfg.x_placement == "device" and n_dev == 1
        self.theta_nnz = np.diff(np.asarray(csc.indptr)).astype(np.int32)
        th_params = dict(row_params, panel=self.panel_size,
                         split_w=cfg.split_width, octave=cfg.octave_points,
                         lazy=lazy)
        self.th_plan = None
        self._hot_rows = np.zeros(0, np.int32)
        self._hot_chunks = []
        if self._theta_direct:
            self.theta_steps = []
            self.n_panels = -(-m_loc // self.panel_size)
            seg_w = self.THETA_SEG_W
            lens = np.diff(np.asarray(csc.indptr)).astype(np.int64)
            csc_loc = CSRMatrix(indptr=csc.indptr, indices=csc.indices,
                                data=csc.data, num_rows=csc.num_rows,
                                num_cols=m_loc)
            self.th_plan = cached_build(
                cache, "sh_thdir", csr, dict(th_params, seg_w=seg_w,
                                             direct=True),
                lambda: build_sharded_row_plan(
                    csc_loc, 1, cfg.min_bucket_width, seg_w, cfg.chunk_nnz,
                    cfg.chunk_rows, lazy=lazy,
                    octave_points=cfg.octave_points, fine_max_width=seg_w,
                    row_mask=lens <= seg_w),
                csr_for_lazy=csc_loc if lazy else None)
            self._build_hot_segments(csc, lens, seg_w)
        else:
            aligned = cached_build(
                cache, "sh_ooc_theta", csr, th_params,
                lambda: AlignedSteps(*align_panel_plans(
                    self._build_per_dev_plans(lazy), csc.num_rows,
                    self.panel_size)),
                csr_for_lazy=csc if lazy else None)
            self.theta_steps, self.n_panels = aligned.steps, aligned.n_panels
        self.x_on_device = cfg.x_placement == "device"
        self.m_loc_pad = self.n_panels * self.panel_size
        if self.m_loc_pad <= m_loc:
            # the direct theta route's pad id (== m_loc) must name a
            # device row that stays zero
            self.m_loc_pad = m_loc + 8
        # theta accumulator rows: a multiple of 1024, with room for the
        # dummy rows' id n
        batch = min(cfg.chunk_rows, 1024)
        n = csc.num_rows
        self.n_pad = -(-(n + 1) // batch) * batch
        # the compacted-stream stores: lazy plans and a plan cache only
        self._x_stream = self._theta_stream = None
        if cache and lazy:
            fp = dataset_fingerprint(csr)
            sv = cfg.stream_val_dtype
            self._x_stream = StreamCache(cache, plan_key(
                "xstream", fp, dict(row_params, lazy=lazy, sv=sv)))
            self._theta_stream = StreamCache(cache, plan_key(
                "thstream", fp, dict(th_params, sv=sv, n_pad=self.n_pad,
                                     direct=self._theta_direct)))

    def _build_per_dev_plans(self, lazy: bool):
        """Each rank's panel plan over its own X rows (theta rows x the
        rank's local X ids), as the JAX package builds them."""
        cfg, csr, csc = self.cfg, self.train_csr, self.train_csc
        m_loc = self.row_plan.m_loc
        kw = dict(panel_size=self.panel_size,
                  min_width=cfg.min_bucket_width, chunk_nnz=cfg.chunk_nnz,
                  chunk_rows=cfg.chunk_rows, split_width=cfg.split_width,
                  octave_points=cfg.octave_points, lazy=lazy)
        if self.n_dev == 1:
            # one shard: its local ids are the global ones, so the CSC
            # itself is the rank's matrix
            return [build_panel_plan(CSRMatrix(
                indptr=csc.indptr, indices=csc.indices, data=csc.data,
                num_rows=csc.num_rows, num_cols=m_loc), **kw)]
        col_owner = np.zeros(csr.num_rows + 1, np.int32)
        col_local = np.zeros(csr.num_rows + 1, np.int32)
        for d in range(self.n_dev):
            ids = self.row_plan.global_ids[d]
            valid = ids < csr.num_rows
            col_owner[ids[valid]] = d
            col_local[ids[valid]] = np.arange(m_loc, dtype=np.int32)[valid]
        lens = np.diff(np.asarray(csc.indptr, np.int64))
        owner_flat = col_owner[csc.indices]
        local_flat = col_local[csc.indices]
        row_of = np.repeat(np.arange(csc.num_rows, dtype=np.int64), lens)
        plans = []
        for d in range(self.n_dev):
            sel = owner_flat == d
            r_d, c_d, v_d = row_of[sel], local_flat[sel], csc.data[sel]
            order = np.lexsort((c_d, r_d))
            r_d, c_d, v_d = r_d[order], c_d[order], v_d[order]
            sub_indptr = np.zeros(csc.num_rows + 1, np.int64)
            np.cumsum(np.bincount(r_d, minlength=csc.num_rows),
                      out=sub_indptr[1:])
            plans.append(build_panel_plan(CSRMatrix(
                indptr=sub_indptr, indices=c_d.astype(np.int32),
                data=v_d.astype(np.float32), num_rows=csc.num_rows,
                num_cols=m_loc), **kw))
        return plans

    def _build_hot_segments(self, csc, lens: np.ndarray, seg_w: int) -> None:
        """The hot theta columns (more than seg_w ratings) cut into
        segments of seg_w ratings, (hot index, flat offset, length) each,
        packed into chunks of r_seg segments (sentinel index H = the hot
        count)."""
        hot = np.nonzero(lens > seg_w)[0].astype(np.int32)
        self._hot_rows = hot
        self._hot_nnz = lens[hot].astype(np.int64)
        if hot.size == 0:
            return
        indptr = np.asarray(csc.indptr, np.int64)
        segs = []
        for h, row in enumerate(hot):
            off, rem = int(indptr[row]), int(lens[row])
            while rem > 0:
                take = min(seg_w, rem)
                segs.append((h, off, take))
                off += take
                rem -= take
        r_seg = max(8, min(self.cfg.chunk_nnz // seg_w, 64))
        for lo in range(0, len(segs), r_seg):
            rows = np.full(r_seg, hot.size, np.int32)
            offs = np.zeros(r_seg, np.int64)
            ls = np.zeros(r_seg, np.int32)
            for j, (h, off, take) in enumerate(segs[lo:lo + r_seg]):
                rows[j], offs[j], ls[j] = h, off, take
            self._hot_chunks.append((rows, offs, ls))

    def _materialize_hot(self, chunk):
        """(rows, cols (R, THETA_SEG_W), vals) of one hot-segment chunk;
        pad slots name the zero row m_loc of the device X."""
        rows, offs, ls = chunk
        csc = self.train_csc
        seg_w = self.THETA_SEG_W
        r = rows.shape[0]
        cols = np.full((r, seg_w), self.row_plan.m_loc, np.int32)
        vals = np.zeros((r, seg_w), np.float32)
        for j in range(r):
            k, o = int(ls[j]), int(offs[j])
            cols[j, :k] = csc.indices[o:o + k]
            vals[j, :k] = csc.data[o:o + k]
        return rows, cols, vals

    def _theta_accum_depth(self) -> float:
        """Partial adds per theta accumulator row (dummy rows included,
        which only overestimates)."""
        slots = sum(int(st.rows.shape[1]) if hasattr(st, "rows")
                    else int(st._r) for st in self.theta_steps)
        return slots / max(1, self.train_csc.num_rows)

    def _rank_plans(self) -> None:
        """This rank's part of the plans, its buffers, and the X store."""
        cfg, r, dev = self.cfg, self.rank, self.device
        rp = self.row_plan
        pin = dev.type == "cuda"
        f16 = cfg.stream_val_dtype == "f16"
        writer = self.rank == 0
        # the X chunks' store serves the device placement alone, as in
        # the JAX package
        self._x = _RankChunks(rp.chunks, r, rp.m_loc, pin, rp.num_cols + 1,
                              f16, cache=self._x_stream if self.x_on_device
                              else None, writer=writer)
        if self._theta_direct:
            self._th = _RankChunks(self.th_plan.chunks, 0, self.th_plan.m,
                                   pin, rp.m_loc + 1, f16,
                                   cache=self._theta_stream, writer=writer)
        else:
            self._th = _RankChunks(self.theta_steps, r, self.train_csc.
                                   num_rows, pin, self.panel_size + 1, f16,
                                   with_nnz=False, row_ids=self.n_pad + 1,
                                   cache=self._theta_stream, writer=writer)
        self._panels = [] if self._theta_direct else _panel_runs(self._th)
        n = self.train_csc.num_rows
        nnz_pad = np.zeros(self.n_pad, np.int32)
        nnz_pad[:n] = self.theta_nnz
        self._theta_nnz_pad = torch.from_numpy(nnz_pad).to(dev)
        self.store_dtype = torch.bfloat16 if cfg.factor_dtype == "bf16" \
            else torch.float32
        # the direct theta route accumulates its hot segments in f32
        self.accum_dtype = torch.float32
        if not self._theta_direct:
            depth = self._theta_accum_depth()
            self.accum_dtype = accum_dtype(cfg.gram_dtype, depth)
            if cfg.gram_dtype == "bf16" and \
                    self.accum_dtype == torch.float32 and self.rank == 0:
                print(f"[sharded_ooc] ~{depth:.0f} partial adds per theta "
                      f"row > {als.BF16_ACCUM_MAX_DEPTH}: promoting Gram "
                      f"accumulators bf16 -> f32 (swamping guard)",
                      file=sys.stderr, flush=True)
        f_pad = cfg.f_pad

        def host(rows):
            return torch.zeros((rows, f_pad), dtype=self.store_dtype,
                               pin_memory=pin)

        self.x_store = self.x_host = self._x_dev = None
        if not self.x_on_device:
            # the rank's X shard, and per chunk in flight the warm start
            # and the solved rows
            self.x_store = host(rp.m_loc)
            r_max = max((c.rows.shape[1] for c in rp.chunks), default=0)
            self._x_slots = [(host(r_max), host(r_max)) for _ in range(2)]
            self._test_stage = host(TEST_CHUNK)
        # two table buffers of a panel of X (its rows, then one zero row)
        self._tables = [torch.zeros((self.panel_size + 1, f_pad),
                                    dtype=self.store_dtype, device=dev)
                        for _ in range(2 if self._panels else 0)]

    def _test_entries(self, coo: Optional[COOMatrix]):
        """This rank's test entries (those of its X rows) in local row
        order: local rows (on the device with the device X), theta ids,
        values, and the count over every rank."""
        if coo is None or not coo.nnz:
            return None
        rp = self.row_plan
        ids = rp.global_ids[self.rank]
        valid = ids < rp.m
        local = np.full(rp.m, -1, np.int64)
        local[ids[valid]] = np.arange(rp.m_loc)[valid]
        lr = local[np.asarray(coo.row)]
        mine = np.nonzero(lr >= 0)[0]
        order = mine[np.argsort(lr[mine], kind="stable")]
        rows = torch.from_numpy(lr[order])
        if self.x_on_device:
            rows = rows.to(self.device)
        return (rows, torch.from_numpy(np.asarray(coo.col)[order].astype(
            np.int64)).to(self.device),
            torch.from_numpy(np.asarray(coo.data, np.float32)[order]).to(
                self.device), coo.nnz)

    # ----- factor layout -----
    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n_dev, *t.shape): every rank's t, in rank order, on the host
        (a collective). NCCL takes card tensors only."""
        if self.mesh.backend == "nccl":
            t = t.to(self.device)
        return self.mesh.all_gather(t).cpu()

    def _unshard(self, xs: torch.Tensor) -> np.ndarray:
        rp = self.row_plan
        out = np.zeros((rp.m, self.cfg.f), np.float32)
        for d in range(self.n_dev):
            ids = rp.global_ids[d]
            valid = ids < rp.m
            out[ids[valid]] = xs[d][torch.from_numpy(valid), :self.cfg.f
                                    ].float().numpy()
        return out

    def gather_x_store(self) -> torch.Tensor:
        """Every rank's host shard, (n_dev, m_loc, f_pad) in the store
        dtype on the host: the JAX package's `x_host` layout, which
        `run(x_host0=)` takes back (a collective: every rank calls it)."""
        return self._gather(self.x_store)

    def unshard_x_host(self) -> np.ndarray:
        """Every rank's host shard gathered into the (m, f) factors (a
        collective: every rank calls it)."""
        return self._unshard(self.gather_x_store())

    def fetch_x(self) -> np.ndarray:
        """Every rank's device shard gathered into the (m, f) factors (a
        collective: every rank calls it)."""
        return self._unshard(self._gather(
            self._x_dev[:self.row_plan.m_loc]))

    def _shard_into_store(self, x0: np.ndarray) -> None:
        """The rank's rows of the (m, f) factors into its host shard, in
        the store dtype (padding rows and lanes zero)."""
        rp = self.row_plan
        ids = rp.global_ids[self.rank]
        valid = ids < rp.m
        x0 = np.asarray(x0, np.float32) * (
            np.diff(self.train_csr.indptr) > 0)[:, None]
        self.x_store.zero_()
        self.x_store[torch.from_numpy(valid), :x0.shape[1]] = \
            torch.from_numpy(x0[ids[valid]]).to(self.store_dtype)

    def _table(self, t: torch.Tensor) -> torch.Tensor:
        """A gather table in the factor dtype (cast before the gather)."""
        return t.to(torch.bfloat16) if self.cfg.factor_dtype == "bf16" \
            else t

    # ----- the X phase -----
    def _solve_rows(self, table_ext, x0, ch) -> torch.Tensor:
        """One chunk's rows solved against the replicated theta: K1 (K6
        with aug) on "pallas" with CG, else the plain Gram and `solve`."""
        cfg = self.cfg
        if cfg.backend == "pallas" and cfg.solver == "cg":
            solved, _ = cuda_solve.gather_gram_cg(
                table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam,
                cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
                aug=cuda_solve.aug_enabled(cfg))
            return solved
        a, b = gram_rhs(table_ext, ch.cols, ch.vals, ch.nnz, cfg.lam,
                        factor_dtype=cfg.factor_dtype,
                        gram_dtype=cfg.gram_dtype)
        solved = solve(a, b, x0, solver=cfg.solver, cg_iters=cfg.cg_iters,
                       cg_tol=cfg.cg_tol, backend=cfg.backend)
        return solved * (ch.nnz > 0).float()[:, None]

    def _x_phase(self, theta: torch.Tensor) -> None:
        """Host placement: each chunk's warm start gathered from the host
        shard into pinned staging, sent with the chunk on the copy
        stream, solved, and its rows sent back on the second stream and
        scattered into the shard once they landed, two chunks in flight."""
        table_ext = extend_table(self._table(theta))
        hx = self._x
        hx.begin()
        pending = collections.deque()
        for i in range(len(hx)):
            _maybe_log_rss("x", i)
            x0_h, out_h = self._x_slots[i % 2]
            rows_h = hx.real_rows(i)
            k = rows_h.shape[0]
            torch.index_select(self.x_store, 0, rows_h, out=x0_h[:k])
            with self._on(self._copy):
                (ch,), bases = hx.upload(i, i + 1, self.device)
                r = ch.rows.shape[0]
                x0_h[k:r].zero_()
                x0 = x0_h[:r].to(self.device, non_blocking=True)
                ready = self._record()
            self._wait(ready)
            self._keep(bases + [x0])
            solved = self._solve_rows(table_ext, x0.float(), ch).to(
                self.store_dtype)
            solved_ev = self._record()
            with self._on(self._back):
                self._wait(solved_ev)
                out_h[:r].copy_(solved, non_blocking=True)
                self._keep([solved])
                done = self._record()
            pending.append((rows_h, out_h[:k], done))
            if len(pending) >= 2:
                self._drain_one(pending)
        while pending:
            self._drain_one(pending)
        hx.finish()

    def _drain_one(self, pending) -> None:
        """The oldest chunk's solved rows into the host shard, once their
        copy has landed."""
        rows, out, done = pending.popleft()
        if done is not None:
            done.synchronize()
        self.x_store.index_copy_(0, rows, out)

    def _x_phase_device(self, theta: torch.Tensor) -> None:
        """Device placement: each chunk solved from the device shard's
        rows (a cold start without x_warm_start), written in place."""
        table_ext = extend_table(self._table(theta))
        hx = self._x
        hx.begin()
        for i in range(len(hx)):
            _maybe_log_rss("x", i)
            with self._on(self._copy):
                (ch,), bases = hx.upload(i, i + 1, self.device)
                ready = self._record()
            self._wait(ready)
            self._keep(bases)
            if self.cfg.x_warm_start:   # dummy rows read the zero row m_loc
                x0 = self._x_dev.index_select(0, ch.rows).float()
            else:
                x0 = torch.zeros((ch.rows.shape[0], self.cfg.f_pad),
                                 dtype=torch.float32, device=self.device)
            solved = self._solve_rows(table_ext, x0, ch)
            k = ch.n_real
            self._x_dev.index_copy_(0, ch.rows[:k],
                                    solved[:k].to(self._x_dev.dtype))
        hx.finish()

    # ----- the theta phase over panel steps -----
    def _issue_panel(self, k: int, free):
        """On the copy stream: the panel of run k into its table buffer
        (from the host shard; the device shard's panel is copied on the
        compute stream, `_panel_table`), and the run's steps, once
        `free[slot]` says K2 is done with the buffer."""
        p, i, j = self._panels[k]
        slot = k % 2
        s = self.panel_size
        lo, hi = p * s, min(p * s + s, self.row_plan.m_loc)
        table = self._tables[slot]
        with self._on(self._copy):
            self._wait(free[slot])
            if not self.x_on_device:
                table[:hi - lo].copy_(self.x_store[lo:hi], non_blocking=True)
                table[hi - lo:].zero_()
            chunks, bases = self._th.upload(i, j, self.device)
            ready = self._record()
        return p, slot, chunks, bases, ready

    def theta_accumulators(self):
        """The rank's partial (A, b) over all theta rows from its own X
        shard: a_buf (n_pad, f, f) in `accum_dtype`, b_buf (n_pad, f)
        f32, each step by K2 on "pallas" (its plain version otherwise),
        the panels streamed one ahead."""
        f = self.cfg.f_pad
        a_buf = torch.zeros((self.n_pad, f, f), dtype=self.accum_dtype,
                            device=self.device)
        b_buf = torch.zeros((self.n_pad, f), dtype=torch.float32,
                            device=self.device)
        pallas = self.cfg.backend == "pallas"
        s = self.panel_size
        self._th.begin()
        free = [None, None]
        nxt = self._issue_panel(0, free) if self._panels else None
        for k in range(len(self._panels)):
            _maybe_log_rss("theta", k)
            p, slot, chunks, bases, ready = nxt
            self._wait(ready)
            self._keep(bases)
            if k + 1 < len(self._panels):   # the next panel, one ahead
                nxt = self._issue_panel(k + 1, free)
            table = self._tables[slot]
            if self.x_on_device:   # the device shard's rows past m_loc are 0
                table[:s].copy_(self._x_dev[p * s:p * s + s])
            # dummy rows carry id n, inside a_buf (n_pad > n)
            accumulate_panel(a_buf, b_buf, table, chunks, pallas)
            free[slot] = self._record()
        self._th.finish()
        return a_buf, b_buf

    def _theta_phase(self, theta: torch.Tensor):
        """The partials widened to f32 and summed over the ranks, then all
        of theta solved at once with the diagonal (K3 on "pallas" with
        CG); returns theta and the train squared error (a float)."""
        cfg = self.cfg
        n = self.train_csc.num_rows
        a_buf, b_buf = self.theta_accumulators()
        a = a_buf if a_buf.dtype == torch.float32 else a_buf.float()
        del a_buf
        self.mesh.all_reduce_sum(a)
        self.mesh.all_reduce_sum(b_buf)
        nnzf = self._theta_nnz_pad.float()
        diag = nnzf * cfg.lam + (nnzf == 0).float()
        th = solve(a, b_buf, F.pad(theta, (0, 0, 0, self.n_pad - n)),
                   solver=cfg.solver, cg_iters=cfg.cg_iters,
                   cg_tol=cfg.cg_tol, backend=cfg.backend, diag=diag)
        th = th * (nnzf > 0).float()[:, None]
        # train squared error from the summed raw A and b (full f32); the
        # sum of r^2 is taken once on the host
        se = float(_se_terms(a, b_buf, th, SE_ROWS)) + self._sum_r2()
        del a, b_buf
        return th[:n].contiguous(), se

    def _sum_r2(self) -> float:
        if not hasattr(self, "_r2"):
            self._r2 = sum_r2(self.train_csr)
        return self._r2

    # ----- the theta phase, direct (one rank, X on the card) -----
    def _theta_phase_direct(self, theta: torch.Tensor):
        """Theta's rows solved directly against the device X (K1, K6 with
        aug, on "pallas" with CG), then the hot columns by segments;
        returns theta and the train squared error (a float)."""
        cfg = self.cfg
        f, n = cfg.f_pad, self.train_csc.num_rows
        dev = self.device
        th_new = torch.zeros((self.n_pad, f), dtype=torch.float32,
                             device=dev)
        theta_pad = F.pad(theta, (0, 0, 0, self.n_pad - n))
        table = self._x_dev   # its row m_loc, the pad id, stays zero
        kernel = cfg.backend == "pallas" and cfg.solver == "cg"
        se = torch.zeros((), dtype=torch.float32, device=dev)
        th = self._th
        th.begin()
        for i in range(len(th)):
            _maybe_log_rss("theta", i)
            with self._on(self._copy):
                (ch,), bases = th.upload(i, i + 1, dev)
                ready = self._record()
            self._wait(ready)
            self._keep(bases)
            x0 = theta_pad.index_select(0, ch.rows)
            if kernel:
                solved, se_rows = cuda_solve.gather_gram_cg(
                    table, ch.cols, ch.vals, ch.nnz, x0, cfg.lam,
                    cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
                    aug=cuda_solve.aug_enabled(cfg))
                se = se + se_rows.sum()
            else:
                a, b = gram_rhs(table, ch.cols, ch.vals, ch.nnz, cfg.lam,
                                factor_dtype=cfg.factor_dtype,
                                gram_dtype=cfg.gram_dtype)
                solved = solve(a, b, x0, solver=cfg.solver,
                               cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
                               backend=cfg.backend)
                se = se + fused_sq_err(a, b, ch.vals, ch.nnz, cfg.lam,
                                       solved)
                del a, b
            solved = solved * (ch.nnz > 0).float()[:, None]
            th_new.index_copy_(0, ch.rows[:ch.n_real], solved[:ch.n_real])
        th.finish()
        if self._hot_rows.size:
            se = se + self._hot_columns(table, theta, th_new)
        return th_new[:n], float(se)

    def _hot_columns(self, table, theta, th_new) -> torch.Tensor:
        """The hot columns: each segment's raw partial (A, b) by K2 with
        an f32 A (its plain version off "pallas") and sum v^2 added per
        column, then the columns solved with the diagonal (K3 on "pallas"
        with CG) into th_new; returns their train squared error."""
        cfg = self.cfg
        f, dev = cfg.f_pad, self.device
        hot = self._hot_rows.size
        h_pad = max(8, -(-hot // 8) * 8)
        a_h = torch.zeros((h_pad, f, f), dtype=torch.float32, device=dev)
        b_h = torch.zeros((h_pad, f), dtype=torch.float32, device=dev)
        v_h = torch.zeros(h_pad, dtype=torch.float32, device=dev)
        gram = cuda_solve.gather_gram_out if cfg.backend == "pallas" else \
            cuda_solve.gather_gram_out_plain
        f16 = cfg.stream_val_dtype == "f16"
        for chunk in self._hot_chunks:
            rows, cols, vals = self._materialize_hot(chunk)
            k = int(np.count_nonzero(rows < hot))
            rows_t = torch.from_numpy(rows[:k].astype(np.int64)).to(dev)
            cols_t = torch.from_numpy(cols).to(dev)
            vals_t = widen_vals(torch.from_numpy(
                vals.astype(np.float16) if f16 else vals).to(dev))
            a_part, b_part = gram(table, cols_t, vals_t,
                                  out_dtype=torch.float32)
            a_h.index_add_(0, rows_t, a_part[:k])
            b_h.index_add_(0, rows_t, b_part[:k])
            v_h.index_add_(0, rows_t, (vals_t[:k] * vals_t[:k]).sum(-1))
            del a_part, b_part
        th0 = torch.zeros((h_pad, f), dtype=torch.float32, device=dev)
        hot_t = torch.from_numpy(self._hot_rows.astype(np.int64)).to(dev)
        th0[:hot] = theta.index_select(0, hot_t)
        nnz = np.zeros(h_pad, np.float32)
        nnz[:hot] = np.minimum(self._hot_nnz, np.iinfo(np.int32).max)
        nnzf = torch.from_numpy(nnz).to(dev)
        diag = nnzf * cfg.lam + (nnzf == 0).float()
        th = solve(a_h, b_h, th0, solver=cfg.solver, cg_iters=cfg.cg_iters,
                   cg_tol=cfg.cg_tol, backend=cfg.backend, diag=diag)
        th = th * (nnzf > 0).float()[:, None]
        cross = (th * b_h).sum(-1)
        with full_f32():
            aq = torch.einsum("rfg,rg->rf", a_h, th)
        quad = (th * aq).sum(-1)
        th_new.index_copy_(0, hot_t, th[:hot])
        return (v_h - 2.0 * cross + quad).clamp_min(0.0).sum()

    # ----- test RMSE -----
    def test_rmse(self, theta: torch.Tensor) -> float:
        """Test RMSE: each rank sums the squared error of its entries
        (its X rows streamed from the host shard, or read on the card),
        then the sums are added over the ranks."""
        if self._test is None:
            return float("nan")
        rows, cols, vals, total = self._test
        f = self.cfg.f
        se = torch.zeros(1, dtype=torch.float64, device=self.device)
        for lo in range(0, rows.shape[0], TEST_CHUNK):
            hi = min(lo + TEST_CHUNK, rows.shape[0])
            if self.x_on_device:
                xg = self._x_dev.index_select(0, rows[lo:hi])
            else:
                stage = self._test_stage[:hi - lo]
                torch.index_select(self.x_store, 0, rows[lo:hi], out=stage)
                xg = stage.to(self.device)   # synchronous: stage is reused
            pred = (xg[:, :f].float() *
                    theta.index_select(0, cols[lo:hi])[:, :f]).sum(-1)
            e = vals[lo:hi] - pred
            se += (e * e).sum(dtype=torch.float64)
        return float(torch.sqrt(self.mesh.all_reduce_sum(se) / total))

    # ----- the training loop -----
    def run(self, x0: Optional[np.ndarray], theta0: np.ndarray,
            start_iter: int = 0, x_host0=None, keep_sharded: bool = False,
            on_theta: Optional[Callable[[torch.Tensor], None]] = None
            ) -> ALSResult:
        """Train from (x0, theta0), every rank given the same factors;
        returns the (m, f) X and theta on every rank. The device placement
        ignores x0 and x_host0: its X starts at zero on the card.
        `x_host0` resumes from a sharded host store, (n_dev, m_loc,
        f_pad) in the JAX package's layout, whose row r is rank r's
        shard (`x_host` of a finished run at one rank is that row).
        `keep_sharded` leaves X in the shards (`x_host`, or `fetch_x()`
        on the device placement) and returns x None. `on_theta`, when
        given, is called with the device theta (f_pad lanes) at the end
        of each iteration."""
        cfg, rcfg = self.cfg, self._rank_cfg
        theta0 = np.asarray(theta0, np.float32) * (
            self.theta_nnz > 0)[:, None]
        if self.x_on_device:
            self._x_dev = torch.zeros((self.m_loc_pad, cfg.f_pad),
                                      dtype=self.store_dtype,
                                      device=self.device)
        elif x_host0 is not None:
            self.x_store.copy_(torch.as_tensor(x_host0[self.rank]))
        elif x0 is None:
            self.x_store.zero_()
        else:
            self._shard_into_store(x0)
        self.x_host = self.x_store
        theta = torch.zeros((self.train_csc.num_rows, cfg.f_pad),
                            dtype=torch.float32)
        theta[:, :cfg.f] = torch.from_numpy(theta0)
        theta = theta.to(self.device)
        history: List[IterationMetrics] = []
        if rcfg.verbose:
            print(f"*******parameters: m: {cfg.m}, n:  {cfg.n}, "
                  f"f: {cfg.f}, nnz: {self.train_csr.nnz} ")
            place = "HBM-resident" if self.x_on_device else "host-resident"
            print(f"*******mesh: {self.n_dev} devices; X {place} "
                  f"({self.row_plan.m_loc} rows/device), {self.n_panels} "
                  f"local X panels "
                  f"{'sliced' if self.x_on_device else 'streamed'} per "
                  f"theta update.")
            print("*******start iterations...", flush=True)
        for it in range(start_iter, cfg.iters):
            t0 = seconds()
            if self.x_on_device:
                self._x_phase_device(theta)
            else:
                self._x_phase(theta)
            if cfg.debug_timing:
                sync(self.device)
            tx = seconds() - t0
            if rcfg.debug_timing:
                print(f"update X run {tx:f} seconds, gridSize: {cfg.m}, "
                      f"blockSize {cfg.f}.", flush=True)
            t0 = seconds()
            if self._theta_direct:
                theta, se = self._theta_phase_direct(theta)
            else:
                theta, se = self._theta_phase(theta)
            sync(self.device)
            tth = seconds() - t0
            if rcfg.debug_timing:
                print(f"update theta run {tth:f} seconds, gridSize: "
                      f"{cfg.n}, blockSize {cfg.f}.", flush=True)
            train_rmse = float(np.sqrt(max(se, 0.0) / self.train_csr.nnz))
            test_rmse = self.test_rmse(theta)
            # a due checkpoint gathers X on every rank; rank 0 writes it
            factors = None
            if cfg.checkpoint_every and cfg.checkpoint_dir and \
                    (it + 1) % cfg.checkpoint_every == 0:
                factors = (self._x_out(), self._unpad(theta))
            end_iteration(rcfg, history, IterationMetrics(
                it, train_rmse, test_rmse, tx, tth, 0.0), lambda: factors)
            if on_theta is not None:
                on_theta(theta)
        return ALSResult(x=None if keep_sharded else self._x_out(),
                         theta=self._unpad(theta), history=history)

    def _x_out(self) -> np.ndarray:
        return self.fetch_x() if self.x_on_device else self.unshard_x_host()

    def _unpad(self, t: torch.Tensor) -> np.ndarray:
        return t[:, :self.cfg.f].float().cpu().numpy()


def run_rank(mesh: Mesh, cfg: ALSConfig, data, x0: np.ndarray,
             theta0: np.ndarray,
             lazy_nnz_threshold: Optional[int] = None) -> dict:
    """One rank of a spawned run (`parallel.mesh.spawn(n, run_rank,
    ...)`): ShardedOutOfCoreALS on the rank's mesh for cfg.iters
    iterations. `data` is (train CSR, test COO) or a function that
    returns them (the bench's loader, so that a large data set is read,
    not pickled). `lazy_nnz_threshold` goes to the model (a test hook).

    Returns the history; X and theta on rank 0 (None elsewhere); a
    SHA-256 of theta's bytes after each iteration and of the final X on
    every rank; the rank's global ids and whether the final X holds its
    shard's rows; the kernel launches of the run; the peak device memory
    (None on the CPU); the bytes the rank all-reduced an iteration (the
    mesh's count, `Mesh.reduced_bytes`, over the run); and
    the plan's counts: X chunks, theta steps, hot-segment chunks."""
    train, test = data() if callable(data) else data
    model = ShardedOutOfCoreALS(cfg, train, None, test, mesh=mesh,
                                lazy_nnz_threshold=lazy_nnz_threshold)
    cuda = model.device.type == "cuda"
    cuda_solve.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(model.device)
    digests = []
    reduced = mesh.reduced_bytes
    res = model.run(x0, theta0, on_theta=lambda t: digests.append(
        hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()))
    launches = dict(cuda_solve.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(model.device) if cuda else None
    rp = model.row_plan
    ids = rp.global_ids[mesh.rank]
    valid = ids < rp.m
    shard = model._x_dev if model.x_on_device else model.x_store
    own = shard[:rp.m_loc][torch.from_numpy(valid).to(shard.device)]
    return dict(history=res.history,
                x=res.x if mesh.rank == 0 else None,
                theta=res.theta if mesh.rank == 0 else None,
                theta_sha256=digests,
                x_sha256=hashlib.sha256(res.x.tobytes()).hexdigest(),
                own_ids=ids[valid],
                own_rows_match=bool(np.array_equal(
                    res.x[ids[valid]],
                    own[:, :cfg.f].float().cpu().numpy())),
                launches=launches, peak_bytes=peak,
                allreduce_bytes=(mesh.reduced_bytes - reduced) //
                len(res.history),
                x_chunks=len(rp.chunks), theta_steps=len(model.theta_steps),
                hot_chunks=len(model._hot_chunks), lazy=model.lazy)
