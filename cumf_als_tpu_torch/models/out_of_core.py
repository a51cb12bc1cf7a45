"""Out-of-core ALS: X in host memory, streamed through the card (the JAX
package's models/out_of_core.py in PyTorch).

The reference's hugewiki program keeps the tall factor in pinned host
memory and streams row batches through the GPUs. Here:

  - X lives in a pinned host tensor (`x_store`; numpy reads it through
    `x_np`). The X phase takes the direct route's plan: for each chunk,
    the warm-start rows are gathered on the host into pinned staging,
    and they and the chunk's plan arrays (kept packed in pinned host
    memory, `_HostChunks`) go to the card on a copy stream; the chunk is
    solved by K1 (K6 with the augmented lane), and the solved rows come
    back on a second stream into pinned staging. They are scattered into
    X only once that copy's event has completed. At most two chunks are
    in flight, as in the JAX package's double buffer.
  - theta lives on the card. The theta phase takes the panel route over
    X: each panel of X rows goes to the card one panel ahead, into one
    of two table buffers, and the panel's chunks are accumulated by K2
    (`accumulate_panel`, the in-core panel route's Gram step) into
    split (A, b) accumulators, which are then solved slice by slice by
    K3. A table buffer is refilled only after an event recorded behind
    the last K2 launch that reads it.
  - train RMSE comes from the accumulators (the fused identity); test
    RMSE streams the X rows it needs from the host.

`call_with_vmem_backoff` of the JAX package is a TPU workaround and has
no counterpart. As the JAX package's, this model writes no save_model
dumps.
"""

from __future__ import annotations

import collections
import contextlib
import sys
from typing import List, Optional

import numpy as np
import torch

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.models.als import (BF16_ACCUM_MAX_DEPTH,
                                           ALSResult, IterationMetrics,
                                           _compact_vals, _se_terms,
                                           _solve_slice, accum_dtype,
                                           accumulate_panel, end_iteration,
                                           resolve_device, sum_r2)
from cumf_als_tpu_torch.ops import cuda_solve
from cumf_als_tpu_torch.ops.gram import extend_table, gram_rhs
from cumf_als_tpu_torch.ops.solve import solve
from cumf_als_tpu_torch.ops.tiling import build_panel_plan, build_update_plan
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix
from cumf_als_tpu_torch.utils.plan_cache import (_pack_chunks, cached_build,
                                                 cached_transpose)
from cumf_als_tpu_torch.utils.timing import seconds, sync

# rows of test entries whose X rows go to the card at once
TEST_CHUNK = 1 << 18


class _Chunk:
    """One plan chunk's arrays on the device (views into one upload)."""

    __slots__ = ("width", "panel", "n_real", "rows", "nnz", "cols", "vals")

    def __init__(self, width, panel, n_real, rows, nnz, cols, vals):
        self.width, self.panel, self.n_real = width, panel, n_real
        self.rows, self.nnz, self.cols, self.vals = rows, nnz, cols, vals


class _HostChunks:
    """A plan's chunks packed into flat host tensors (the plan cache's
    packing), pinned for a run on a card, so that one chunk, or the run
    of chunks of one panel, goes to the device in one copy per array.
    Rating values are compacted as the in-core plans' are, or rounded to
    float16 with `f16`; `id_rows` at most 2^16 (the rows of the table the
    ids name) sends the ids as 16 bits. Either is widened on the card
    after the copy: the kernels see int32 ids and f32 or bf16 values."""

    def __init__(self, plan, pin: bool, id_rows: Optional[int] = None,
                 f16: bool = False):
        packed = _pack_chunks(plan.chunks)
        meta = packed["chunk_meta"]   # (panel, width, rows) per chunk
        self.panel = meta[:, 0].tolist()
        self.width = meta[:, 1].tolist()
        self.n_real = [int(np.count_nonzero(c.rows < plan.num_rows))
                       for c in plan.chunks]
        self.row_off = np.concatenate([[0], np.cumsum(meta[:, 2])])
        self.slot_off = np.concatenate([[0], np.cumsum(meta[:, 2] *
                                                       meta[:, 1])])
        self.max_rows = int(meta[:, 2].max()) if len(meta) else 0
        cols = packed["cols"]
        if id_rows is not None and id_rows <= 1 << 16:
            cols = cols.astype(np.uint16).view(np.int16)
        arrays = (torch.from_numpy(packed["rows"].astype(np.int64)),
                  torch.from_numpy(packed["nnz"]), torch.from_numpy(cols),
                  torch.from_numpy(packed["vals"].astype(np.float16))
                  if f16 else _compact_vals(packed["vals"]))
        if pin:
            arrays = tuple(a.pin_memory() for a in arrays)
        self.rows, self.nnz, self.cols, self.vals = arrays

    def __len__(self) -> int:
        return len(self.width)

    def upload(self, i: int, j: int, device: torch.device):
        """Chunks [i, j) on `device` (asynchronous from pinned memory on
        the current stream): the chunks, and the flat tensors they view,
        which a consumer on another stream must `record_stream`."""
        r0, r1 = int(self.row_off[i]), int(self.row_off[j])
        s0, s1 = int(self.slot_off[i]), int(self.slot_off[j])
        bases = [t[lo:hi].to(device, non_blocking=True)
                 for t, lo, hi in ((self.rows, r0, r1), (self.nnz, r0, r1),
                                   (self.cols, s0, s1), (self.vals, s0, s1))]
        bases[2], bases[3] = widen_ids(bases[2]), widen_vals(bases[3])
        rows, nnz, cols, vals = bases
        out = []
        for k in range(i, j):
            a, b = int(self.row_off[k]) - r0, int(self.row_off[k + 1]) - r0
            c, d = int(self.slot_off[k]) - s0, int(self.slot_off[k + 1]) - s0
            w = self.width[k]
            out.append(_Chunk(w, self.panel[k], self.n_real[k], rows[a:b],
                              nnz[a:b], cols[c:d].view(b - a, w),
                              vals[c:d].view(b - a, w)))
        return out, bases


def widen_ids(t: torch.Tensor) -> torch.Tensor:
    """Ids as the kernels take them: int32, from the 16-bit transport
    form (uint16 bits held as int16) where they came in it."""
    if t.dtype == torch.int16:
        return t.to(torch.int32).bitwise_and_(0xFFFF)
    return t.to(torch.int32) if t.dtype != torch.int32 else t


def widen_vals(t: torch.Tensor) -> torch.Tensor:
    """Values as the kernels take them: float16 transport widened to
    f32; f32 and bf16 as they are."""
    return t.float() if t.dtype == torch.float16 else t


def _panel_runs(host: _HostChunks):
    """[(panel, i, j), ...]: the runs of consecutive chunks [i, j) of one
    panel, in plan order (build_panel_plan orders its chunks by panel,
    so each panel is one run; a panel in two runs would be streamed
    twice, with the same result)."""
    runs, i = [], 0
    while i < len(host):
        j = i
        while j < len(host) and host.panel[j] == host.panel[i]:
            j += 1
        runs.append((host.panel[i], i, j))
        i = j
    return runs


class Streams:
    """Two side streams of a card (`_copy` for uploads, `_back` for
    downloads; None on the CPU, where every copy is synchronous), and the
    event helpers that order work across them."""

    _copy = _back = None

    def _open_streams(self, device: torch.device) -> None:
        cuda = device.type == "cuda"
        self._copy = torch.cuda.Stream(device) if cuda else None
        self._back = torch.cuda.Stream(device) if cuda else None

    @staticmethod
    def _on(stream):
        return torch.cuda.stream(stream) if stream is not None else \
            contextlib.nullcontext()

    def _record(self):
        """An event recorded on the current stream (None on the CPU)."""
        if self._copy is None:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def _wait(event) -> None:
        """The current stream waits for `event`."""
        if event is not None:
            torch.cuda.current_stream().wait_event(event)

    def _keep(self, tensors, stream=None) -> None:
        """Tensors allocated on one stream and used on `stream` (the
        current one by default) stay allocated until that use is done."""
        if self._copy is not None:
            stream = stream or torch.cuda.current_stream()
            for t in tensors:
                t.record_stream(stream)


class OutOfCoreALS(Streams):
    """Single-device out-of-core ALS: X on the host, theta on the device
    (CUDA unless `device="cpu"`, where every copy is synchronous)."""

    def __init__(self, cfg: ALSConfig, train_csr: CSRMatrix,
                 train_csc: Optional[CSRMatrix] = None,
                 test_coo: Optional[COOMatrix] = None, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.train_csr = train_csr
        self.train_csc = train_csc or cached_transpose(cfg.plan_cache_dir,
                                                       train_csr)
        self.test_coo = test_coo
        t0 = seconds()
        # the JAX package's plans under its cache kinds and parameters
        x_params = dict(min_width=cfg.min_bucket_width,
                        max_width=cfg.max_bucket_width,
                        chunk_nnz=cfg.chunk_nnz,
                        chunk_rows=cfg.chunk_rows,
                        octave_points=cfg.octave_points)
        self.plan_x = cached_build(
            cfg.plan_cache_dir, "update", train_csr, x_params,
            lambda: build_update_plan(train_csr, **x_params))
        th_params = dict(panel_size=cfg.panel_size,
                         min_width=cfg.min_bucket_width,
                         chunk_nnz=cfg.chunk_nnz,
                         chunk_rows=cfg.chunk_rows,
                         split_width=cfg.split_width,
                         octave_points=cfg.octave_points)
        self.plan_theta = cached_build(
            cfg.plan_cache_dir, "panel", self.train_csc, th_params,
            lambda: build_panel_plan(self.train_csc, **th_params))
        cuda = self.device.type == "cuda"
        self._host_x = _HostChunks(self.plan_x, pin=cuda)
        self._host_th = _HostChunks(self.plan_theta, pin=cuda)
        self._panels = _panel_runs(self._host_th)

        f_pad, m = cfg.f_pad, train_csr.num_rows
        n = self.plan_theta.num_rows
        # solve slices of equal size, a multiple of 8 rows, with room for
        # the dummy rows' id n
        self.n_slices = -(-(n + 1) // cfg.chunk_rows)
        self.solve_batch = -(-(-(-(n + 1) // self.n_slices)) // 8) * 8
        self.n_pad = self.n_slices * self.solve_batch
        nnz_pad = np.zeros(self.n_pad, np.int32)
        nnz_pad[:n] = self.plan_theta.row_nnz
        self._theta_nnz_pad = torch.from_numpy(nnz_pad).to(self.device)
        depth = (sum(c.rows.shape[0] for c in self.plan_theta.chunks)
                 / max(1, n))
        self.accum_dtype = accum_dtype(cfg.gram_dtype, depth)
        print(f"[ooc] theta accumulators {self.accum_dtype} (~{depth:.1f} "
              f"partial adds per row, gram_dtype {cfg.gram_dtype}, bf16 up "
              f"to {BF16_ACCUM_MAX_DEPTH})", file=sys.stderr,
              flush=True)

        def host(shape):
            return torch.zeros(shape, dtype=torch.float32, pin_memory=cuda)

        # X in host memory, and numpy's view of it
        self.x_store = host((m, f_pad))
        self.x_np = self.x_store.numpy()
        # per chunk in flight: warm-start and solved-row staging
        r = self._host_x.max_rows
        self._x_slots = [(host((r, f_pad)), host((r, f_pad)))
                         for _ in range(2)]
        self._test_stage = host((TEST_CHUNK, f_pad))
        # two table buffers of a panel of X (its rows, then one zero
        # row) in the factor dtype; f32 landing buffers when that is bf16
        s = self.plan_theta.panel_size
        t_dtype = torch.bfloat16 if cfg.factor_dtype == "bf16" else \
            torch.float32
        self._tables = [torch.zeros((s + 1, f_pad), dtype=t_dtype,
                                    device=self.device) for _ in range(2)]
        self._landing = self._tables if t_dtype == torch.float32 else [
            torch.empty((s, f_pad), dtype=torch.float32, device=self.device)
            for _ in range(2)]
        self._open_streams(self.device)
        sync(self.device)   # the buffers' zeros land before a side stream
        self.plan_seconds = seconds() - t0

    # ----- phases -----
    def _x_phase(self, theta: torch.Tensor) -> None:
        cfg = self.cfg
        if cfg.factor_dtype == "bf16":   # cast the table before the gather
            theta = theta.to(torch.bfloat16)
        table_ext = extend_table(theta)
        use_kernel = cfg.backend == "pallas" and cfg.solver == "cg"
        use_aug = use_kernel and cuda_solve.aug_enabled(cfg)
        hx = self._host_x
        pending = collections.deque()
        for i in range(len(hx)):
            x0_h, out_h = self._x_slots[i % 2]
            r = int(hx.row_off[i + 1] - hx.row_off[i])
            k = hx.n_real[i]
            rows_h = hx.rows[hx.row_off[i]:hx.row_off[i + 1]]
            # the warm start: the chunk's rows of X, dummy rows at zero
            torch.index_select(self.x_store, 0, rows_h[:k], out=x0_h[:k])
            x0_h[k:r].zero_()
            with self._on(self._copy):
                (ch,), bases = hx.upload(i, i + 1, self.device)
                x0 = x0_h[:r].to(self.device, non_blocking=True)
                ready = self._record()
            self._wait(ready)
            self._keep(bases + [x0])
            if use_kernel:
                solved, _se = cuda_solve.gather_gram_cg(
                    table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam,
                    cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol, aug=use_aug)
            else:
                a, b = gram_rhs(table_ext, ch.cols, ch.vals, ch.nnz,
                                cfg.lam, gram_dtype=cfg.gram_dtype)
                solved = solve(a, b, x0, solver=cfg.solver,
                               cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
                               backend=cfg.backend)
                solved = solved * (ch.nnz > 0).float()[:, None]
            solved_ev = self._record()
            with self._on(self._back):
                self._wait(solved_ev)
                out_h[:r].copy_(solved, non_blocking=True)
                self._keep([solved])
                done = self._record()
            pending.append((rows_h[:k], out_h[:k], done))
            if len(pending) >= 2:   # at most two chunks in flight
                self._drain_one(pending)
        while pending:
            self._drain_one(pending)

    def _drain_one(self, pending) -> None:
        """Scatter the oldest chunk's solved rows into X, once their copy
        has landed. Only the real rows are written (the plan's rows all
        have ratings; its dummy tail rows are left out)."""
        rows, out, done = pending.popleft()
        if done is not None:
            done.synchronize()
        self.x_store.index_copy_(0, rows, out)

    def _issue_panel(self, k: int, free):
        """On the copy stream: the X panel of run k into its table buffer,
        and the run's chunks of the theta plan, once `free[slot]` says K2
        is done with the buffer."""
        p, i, j = self._panels[k]
        slot = k % 2
        s = self.plan_theta.panel_size
        lo = p * s
        hi = min(lo + s, self.plan_theta.num_cols)
        table, landing = self._tables[slot], self._landing[slot]
        with self._on(self._copy):
            self._wait(free[slot])
            landing[:hi - lo].copy_(self.x_store[lo:hi], non_blocking=True)
            if landing is not table:
                table[:hi - lo].copy_(landing[:hi - lo])
            table[hi - lo:].zero_()
            chunks, bases = self._host_th.upload(i, j, self.device)
            ready = self._record()
        return slot, chunks, bases, ready

    def theta_accumulators(self):
        """The theta phase's Gram step over X as it stands in `x_store`:
        split accumulators a_buf (n_pad, f, f) in `accum_dtype` and b_buf
        (n_pad, f) float32, the X panels streamed one ahead."""
        f = self.cfg.f_pad
        a_buf = torch.zeros((self.n_pad, f, f), dtype=self.accum_dtype,
                            device=self.device)
        b_buf = torch.zeros((self.n_pad, f), dtype=torch.float32,
                            device=self.device)
        pallas = self.cfg.backend == "pallas"
        free = [None, None]
        nxt = self._issue_panel(0, free) if self._panels else None
        for k in range(len(self._panels)):
            slot, chunks, bases, ready = nxt
            self._wait(ready)
            self._keep(bases)
            if k + 1 < len(self._panels):   # the next panel, one ahead
                nxt = self._issue_panel(k + 1, free)
            # dummy rows carry id n, which lies inside a_buf (n_pad > n)
            accumulate_panel(a_buf, b_buf, self._tables[slot], chunks,
                             pallas)
            free[slot] = self._record()
        return a_buf, b_buf

    def _theta_phase(self, theta: torch.Tensor):
        cfg = self.cfg
        n = self.plan_theta.num_rows
        a_buf, b_buf = self.theta_accumulators()
        theta_pad = torch.nn.functional.pad(theta, (0, 0, 0, self.n_pad - n))
        batch = self.solve_batch
        outs = [_solve_slice(a_buf, b_buf, theta_pad, self._theta_nnz_pad,
                             lo, cfg.lam, batch, cfg.solver, cfg.cg_iters,
                             cfg.cg_tol, cfg.backend)
                for lo in range(0, self.n_pad, batch)]
        new = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
        # train squared error from the raw accumulators (the fused
        # identity, full f32); sum r^2 is computed once on the host
        se = _se_terms(a_buf, b_buf, new, batch) + self._sum_r2()
        return new[:n].contiguous(), se

    def _sum_r2(self) -> float:
        if not hasattr(self, "_r2"):
            self._r2 = sum_r2(self.train_csr)
        return self._r2

    def _test_rmse(self, theta: torch.Tensor) -> float:
        """Test RMSE with the X rows streamed from the host, in row
        order, TEST_CHUNK entries at a time."""
        coo = self.test_coo
        if coo is None or not coo.nnz:
            return float("nan")
        if not hasattr(self, "_test"):
            order = np.argsort(coo.row, kind="stable")
            self._test = (
                torch.from_numpy(np.asarray(coo.row)[order].astype(np.int64)),
                torch.from_numpy(np.asarray(coo.col)[order].astype(
                    np.int64)).to(self.device),
                torch.from_numpy(np.asarray(coo.data, np.float32)[order]
                                 ).to(self.device))
        rows, cols, vals = self._test
        f = self.cfg.f
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for lo in range(0, rows.shape[0], TEST_CHUNK):
            hi = min(lo + TEST_CHUNK, rows.shape[0])
            stage = self._test_stage[:hi - lo]
            torch.index_select(self.x_store, 0, rows[lo:hi], out=stage)
            xg = stage.to(self.device)   # synchronous: the stage is reused
            pred = (xg[:, :f] * theta.index_select(0, cols[lo:hi])[:, :f]
                    ).sum(-1)
            e = vals[lo:hi] - pred
            total += (e * e).sum(dtype=torch.float64)
        return float(torch.sqrt(total / rows.shape[0]))

    # ----- the training loop -----
    def run(self, x0: np.ndarray, theta0: np.ndarray,
            start_iter: int = 0) -> ALSResult:
        cfg = self.cfg
        m, n = self.train_csr.num_rows, self.train_csr.num_cols
        xs = self.x_store
        xs.zero_()
        xs[:, :cfg.f] = torch.as_tensor(x0, dtype=torch.float32)
        xs *= torch.from_numpy(
            np.diff(self.train_csr.indptr) > 0).float()[:, None]
        th = torch.zeros((n, cfg.f_pad), dtype=torch.float32)
        th[:, :cfg.f] = torch.as_tensor(theta0, dtype=torch.float32)
        th *= torch.from_numpy(self.plan_theta.row_nnz > 0).float()[:, None]
        theta = th.to(self.device)
        history: List[IterationMetrics] = []
        if cfg.verbose:
            print(f"*******parameters: m: {m}, n:  {n}, f: {cfg.f}, "
                  f"nnz: {self.train_csr.nnz} ")
            print("*******out-of-core: X host-resident, theta on device, "
                  f"{self.plan_theta.n_panels} X panels streamed.")
            print("*******start iterations...")
        for it in range(start_iter, cfg.iters):
            t0 = seconds()
            self._x_phase(theta)
            tx = seconds() - t0
            if cfg.debug_timing:
                print(f"update X run {tx:f} seconds, gridSize: {m}, "
                      f"blockSize {cfg.f}.")
            t0 = seconds()
            theta, se = self._theta_phase(theta)
            sync(self.device)
            tth = seconds() - t0
            if cfg.debug_timing:
                print(f"update theta run {tth:f} seconds, gridSize: {n}, "
                      f"blockSize {cfg.f}.")
            t0 = seconds()
            train_rmse = float(np.sqrt(max(float(se), 0.0) /
                                       self.train_csr.nnz))
            test_rmse = self._test_rmse(theta)
            end_iteration(cfg, history, IterationMetrics(
                it, train_rmse, test_rmse, tx, tth, seconds() - t0),
                lambda: (self.x_np[:, :cfg.f].copy(),
                         theta[:, :cfg.f].cpu().numpy()))
        return ALSResult(x=self.x_np[:, :cfg.f].copy(),
                         theta=theta[:, :cfg.f].cpu().numpy(),
                         history=history)
