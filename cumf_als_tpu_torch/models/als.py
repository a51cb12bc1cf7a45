"""The ALS training loop on one device (the JAX package's models/als.py
in PyTorch).

Per iteration: update X from theta over the CSR ratings, update theta
from X over the CSC ratings, then report train and test RMSE with the
reference's stdout contract. Each phase takes one of two routes, chosen
as in the JAX package:

  - direct: every row's Gram is formed whole and solved at once, chunk
    by chunk (kernel K1, ``gather_gram_cg``, on the "pallas" backend;
    its augmented-lane form K6 with ``aug_gram="force"``; for factor
    widths 128 < F <= 256 K1 at 256 lanes or, with
    ``wide_kernel="on"``, the live-lanes kernel K7
    ``gather_gram_cg_wide``);
  - split: the direct route over a popularity-permuted gather table cut
    into fixed-size parts, for phases whose gather table and
    accumulators are both large (the X phase of the Netflix shape at
    F > 128); same kernels as the direct route;
  - panel: when the gather table is large and the updated factor's full
    accumulators fit ``panel_budget_bytes``, partial Grams per table
    panel are scatter-added into the accumulators, which are then solved
    slice by slice. With split buffers (bf16 accumulators, or
    ``aug_gram="off"``) these are kernels K2 ``gather_gram_out`` and K3
    ``solve_cg_reg`` over (A, b); with f32 accumulators and CG (the
    default configuration) the route keeps ONE augmented accumulator A'
    that carries b in row f-1 and sum v^2 in its corner (kernels K5a
    ``gather_gram_aug_out`` and K5b ``solve_cg_aug``; see
    ``ops/cuda_solve.panel_aug_enabled`` for the gates);
  - batched panel: when both sides are big (the gather table passes the
    panel size, the full accumulators pass the budget) and the phase
    does not go direct or split, rows are taken in batches of
    ``batch_rows`` in descending nnz order, each batch through the panel
    route's Gram step into one reusable (B, f, f) accumulator, then
    solved and written back by global row id. Cholesky and LU reach it
    on either backend, CG on "xla" (on "pallas" CG goes direct).
"""

from __future__ import annotations

import dataclasses
import json
import sys
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.ops import cuda_solve
from cumf_als_tpu_torch.ops.gram import extend_table, gram_rhs
from cumf_als_tpu_torch.ops.precision import full_f32
from cumf_als_tpu_torch.ops.rmse import fused_sq_err, rmse_direct
from cumf_als_tpu_torch.ops.solve import solve
from cumf_als_tpu_torch.ops.tiling import (BatchedPanelPlan, PanelPlan,
                                           SplitPlan,
                                           build_batched_panel_plan,
                                           build_panel_plan,
                                           build_split_plan,
                                           build_update_plan,
                                           flatten_split_chunk)
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix
from cumf_als_tpu_torch.utils.plan_cache import cached_build, cached_transpose
from cumf_als_tpu_torch.utils.timing import seconds, sync


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """torch.from_numpy, copying a read-only array (a plan loaded
    memory-mapped from the plan cache) rather than sharing its pages."""
    if not arr.flags.writeable:
        arr = np.array(arr)
    return torch.from_numpy(arr)


# bf16 partial-Gram accumulators swamp under deep scatter-add chains:
# past ~16 partials per accumulator row the accumulators are f32 (the JAX
# package's BF16_ACCUM_MAX_DEPTH, in ALS and the sharded models)
BF16_ACCUM_MAX_DEPTH = 16


def accum_dtype(gram_dtype: str, depth: float) -> torch.dtype:
    """The Gram accumulators' dtype at `depth` partial adds a row: bf16
    with gram_dtype "bf16" up to BF16_ACCUM_MAX_DEPTH, else f32."""
    if gram_dtype == "bf16" and depth <= BF16_ACCUM_MAX_DEPTH:
        return torch.bfloat16
    return torch.float32


def resolve_device(device=None) -> torch.device:
    """The device a run uses: CUDA unless the caller asks for the CPU.
    Raises when CUDA is asked for (or defaulted to) and no card is
    present; the port never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' (CLI: --device cpu) to run on the "
                           "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@dataclasses.dataclass
class IterationMetrics:
    iteration: int
    train_rmse: float
    test_rmse: float
    x_seconds: float
    theta_seconds: float
    rmse_seconds: float


def end_iteration(cfg: ALSConfig, history: List[IterationMetrics],
                  metrics: IterationMetrics, factors) -> None:
    """The end of one iteration of a training loop (ALS.run and
    OutOfCoreALS.run): the RMSE lines, the history, the metrics JSONL
    line, the checkpoint (`factors()` gives the unpadded x and theta as
    numpy), then the non-finite check."""
    it = metrics.iteration
    if cfg.verbose:
        print(f"--------- Train RMSE in iter {it}: {metrics.train_rmse:f}")
        if np.isfinite(metrics.test_rmse):
            print(f"--------- Test RMSE in iter {it}: "
                  f"{metrics.test_rmse:f}")
    history.append(metrics)
    if cfg.metrics_jsonl:
        with open(cfg.metrics_jsonl, "a") as fh:
            fh.write(json.dumps(dataclasses.asdict(metrics)) + "\n")
    if cfg.checkpoint_every and cfg.checkpoint_dir and \
            (it + 1) % cfg.checkpoint_every == 0:
        from cumf_als_tpu_torch.utils.checkpoint import save_checkpoint
        save_checkpoint(cfg.checkpoint_dir, it, *factors(), cfg)
    if not np.isfinite(metrics.train_rmse):
        raise FloatingPointError(f"non-finite train RMSE at iteration {it}")


@dataclasses.dataclass
class ALSResult:
    x: np.ndarray        # (m, f) un-padded factors
    theta: np.ndarray    # (n, f)
    history: List[IterationMetrics]

    @property
    def final_test_rmse(self) -> float:
        return self.history[-1].test_rmse if self.history else float("nan")

    def predict(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Predicted ratings for (row, col) pairs."""
        return np.einsum("ij,ij->i", self.x[rows], self.theta[cols])


def sum_r2(csr: CSRMatrix) -> float:
    """Sum of squared ratings in float64 (natively when the data plane's
    library is built)."""
    from cumf_als_tpu_torch import native
    if native.available():
        return native.sum_squares(csr.data)
    return float(np.sum(csr.data.astype(np.float64) ** 2))


def _compact_vals(vals: np.ndarray) -> torch.Tensor:
    """Rating values as bf16 when the round trip is exact (star halves
    and integer grids are), else f32, as the JAX package stores them.
    Every consumer widens to f32 before use."""
    v = host_tensor(vals)
    if v.dtype == torch.float32 and v.numel():
        v16 = v.to(torch.bfloat16)
        if torch.equal(v16.float(), v):
            return v16
    return v


class DeviceChunk:
    """A plan chunk's arrays on the device. Dummy tail rows
    (rows == num_rows) follow the `n_real` real rows."""

    __slots__ = ("width", "panel", "n_real", "rows", "rows_real", "nnz",
                 "cols", "vals")

    def __init__(self, chunk, num_rows: int, device: torch.device):
        self.width = chunk.width
        self.panel = getattr(chunk, "panel", 0)
        self.n_real = int(np.count_nonzero(chunk.rows < num_rows))
        self.rows = torch.from_numpy(chunk.rows.astype(np.int64)).to(device)
        self.rows_real = self.rows[:self.n_real]
        self.nnz = torch.from_numpy(chunk.nnz.astype(np.int32)).to(device)
        self.cols = host_tensor(
            np.ascontiguousarray(chunk.cols, np.int32)).to(device)
        self.vals = _compact_vals(
            np.ascontiguousarray(chunk.vals)).to(device)


def accumulate_panel(a_buf, b_buf, tp, chunks, pallas: bool) -> None:
    """One panel's part of the Gram step: each chunk's partial, from the
    panel's table `tp` (its rows, then one zero row that the pad slots
    name), scatter-added at the chunk's rows. Split buffers (b_buf
    given): partial (A, b), kernel K2 when `pallas`; augmented (b_buf
    None): partial A', kernel K5a when `pallas`."""
    for ch in chunks:
        if b_buf is None:
            gram = cuda_solve.gather_gram_aug_out if pallas else \
                cuda_solve.gather_gram_aug_out_plain
            a_part = gram(tp, ch.cols, ch.vals, out_dtype=a_buf.dtype)
        else:
            gram = cuda_solve.gather_gram_out if pallas else \
                cuda_solve.gather_gram_out_plain
            a_part, b_part = gram(tp, ch.cols, ch.vals,
                                  out_dtype=a_buf.dtype)
            b_buf.index_add_(0, ch.rows, b_part)
        a_buf.index_add_(0, ch.rows, a_part)
        del a_part   # up to 1 GiB: free it before the next chunk


def accumulate_into(a_buf, b_buf, table_pad, chunks, panel_size: int,
                    pallas: bool) -> None:
    """The Gram step of the panel and batched-panel routes (and of the
    sharded X phase): the per-panel partial of every chunk, scatter-added
    at the chunk's rows. Split buffers (b_buf given): partial (A, b)
    (kernel K2 when `pallas`). Augmented (b_buf None): partial A' (kernel
    K5a when `pallas`, augment_g + f32 einsum otherwise). Every row id of
    the chunks, dummy rows included, must lie inside a_buf.

    On a card index_add_ adds with atomics in an order that changes from
    run to run, so f32 accumulators repeat to rounding only."""
    s = panel_size
    zero_row = table_pad.new_zeros((1, table_pad.shape[1]))
    by_panel = {}
    for ch in chunks:
        by_panel.setdefault(ch.panel, []).append(ch)
    for p, group in sorted(by_panel.items()):
        tp = torch.cat([table_pad[p * s:(p + 1) * s], zero_row], dim=0)
        accumulate_panel(a_buf, b_buf, tp, group, pallas)


def _solve_slice(a_buf, b_buf, x0_full, row_nnz, lo: int, lam: float,
                 batch: int, solver: str, cg_iters: int, cg_tol: float,
                 backend: str):
    """Solve systems [lo, lo + batch) of the panel accumulators. A is the
    raw (possibly bf16) Gram; the Tikhonov diagonal is applied at solve
    time (in the kernel on the "pallas" backend). b_buf None means a_buf
    is the augmented accumulator (the JAX package's _solve_slice_aug): b
    then unpacks from row f-1 inside the solve. Rows with no ratings get
    diag 1 and are zeroed after the solve."""
    aug = b_buf is None
    nnzf = row_nnz[lo:lo + batch].float()
    diag = nnzf * lam + (nnzf == 0).float()
    out = solve(a_buf[lo:lo + batch], None if aug else b_buf[lo:lo + batch],
                x0_full[lo:lo + batch], solver=solver, cg_iters=cg_iters,
                cg_tol=cg_tol, backend=backend, diag=diag, aug=aug)
    return out * (nnzf > 0).float()[:, None]


def _se_terms(a_buf, b_buf, x_new, batch: int) -> torch.Tensor:
    """-2 sum x.b + sum x^T A x over all rows, A the raw Gram
    accumulators; adding sum r^2 completes the train squared error.
    Summed in slices of `batch` rows to bound the f32 copy of A.

    b_buf None means a_buf is the augmented accumulator (the JAX
    package's _se_terms_aug): b is row f-1 of A'. Lane f-1 of x_new is
    identically zero, so the sum v^2 corner and the value row/column of
    A' add nothing to either term and A' needs no mask here. The
    products are full float32 whatever TF32 setting the caller chose, as
    the JAX package sums them at Precision.HIGHEST."""
    f = a_buf.shape[-1]
    total = torch.zeros((), dtype=torch.float32, device=x_new.device)
    for lo in range(0, x_new.shape[0], batch):
        x = x_new[lo:lo + batch].float()
        a = a_buf[lo:lo + batch].float()
        b = a[:, f - 1, :] if b_buf is None else b_buf[lo:lo + batch]
        with full_f32():
            aq = torch.einsum("rfg,rg->rf", a, x)
        total = total + (x * aq).sum() - 2.0 * (x * b).sum()
    return total


class ALS:
    """ALS over row-compressed ratings on one device.

    Parameters: the training CSR, its transpose (the CSC view; computed
    when None), the test COO, an ALSConfig, and the device (CUDA unless
    `device="cpu"`)."""

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
        self.plan_x = self._build_phase_plan(self.train_csr, cfg.x_batch)
        self.plan_theta = self._build_phase_plan(self.train_csc,
                                                 cfg.theta_batch)
        self.plan_seconds = seconds() - t0

    # ----- strategy choice (as in the JAX package) -----
    def _split_enabled(self, csr: CSRMatrix) -> bool:
        """Whether the split-table direct route applies to this phase. In
        "auto" mode the JAX package also asks whether its fused kernel
        compiles; the port's kernels always exist (a kernel either builds
        or the run fails), so that gate is backend "pallas" with CG."""
        cfg = self.cfg
        if cfg.split_gather == "off" or \
                csr.num_cols <= cfg.split_part_rows():
            return False
        if cfg.split_gather == "force":
            return True
        item = 2 if cfg.factor_dtype == "bf16" else 4
        if csr.num_cols * cfg.f_pad * item <= cfg.split_min_table_bytes:
            return False
        return cfg.backend == "pallas" and cfg.solver == "cg"

    def _phase_strategy(self, csr: CSRMatrix) -> str:
        """"direct", "panel", "split" or "batched_panel" for one phase."""
        cfg = self.cfg
        if cfg.split_gather == "force" and self._split_enabled(csr):
            return "split"
        if cfg.use_panels == "never":
            return "direct"
        a_bytes = (csr.num_rows + 1) * cfg.f_pad * cfg.f_pad * 4
        margin = max(1, cfg.panel_size // 8)
        if csr.num_cols > cfg.panel_size + margin:
            if a_bytes <= cfg.panel_budget_bytes:
                return "panel"
            if self._split_enabled(csr):
                return "split"
            if cfg.backend == "pallas" and cfg.solver == "cg":
                return "direct"
            return "batched_panel"
        return "direct"

    def _accum_dtype(self, total_row_slots: int, num_rows: int):
        depth = total_row_slots / max(1, num_rows)
        dtype = accum_dtype(self.cfg.gram_dtype, depth)
        if self.cfg.gram_dtype == "bf16" and dtype == torch.float32 and \
                not getattr(self, "_warned_promote", False):
            self._warned_promote = True
            print(f"[als] ~{depth:.0f} partial adds per accumulator "
                  f"row > {BF16_ACCUM_MAX_DEPTH}: promoting Gram "
                  f"accumulators bf16 -> f32 (swamping guard)",
                  file=sys.stderr, flush=True)
        return dtype

    def _batch_rows(self) -> int:
        """Row-batch size of the batched-panel route: cfg.batch_rows, else
        2^17 rows with bf16 accumulators and 2^16 with float32."""
        cfg = self.cfg
        if cfg.batch_rows:
            return cfg.batch_rows
        return 1 << 17 if cfg.gram_dtype == "bf16" else 1 << 16

    def _chunk_nnz(self, csr: CSRMatrix, batch: int) -> int:
        """Per-phase chunk budget: x_batch / theta_batch act as a minimum
        number of chunks, capping padded slots per chunk at nnz/batch."""
        budget = self.cfg.chunk_nnz
        if batch and batch > 1:
            budget = min(budget, max(1 << 14, -(-csr.nnz // batch)))
        return budget

    def _build_phase_plan(self, csr: CSRMatrix, batch: int = 1):
        """The phase's plan, built (or loaded from `plan_cache_dir`) under
        the JAX package's cache kind and parameters, so that a cache
        entry either package writes is the other's too."""
        cfg = self.cfg
        strategy = self._phase_strategy(csr)
        chunk_nnz = self._chunk_nnz(csr, batch)
        if strategy == "panel":
            kind, build = "panel", build_panel_plan
            params = dict(panel_size=cfg.panel_size,
                          min_width=cfg.min_bucket_width,
                          chunk_nnz=chunk_nnz, chunk_rows=cfg.chunk_rows,
                          split_width=cfg.split_width,
                          octave_points=cfg.octave_points)
        elif strategy == "direct":
            kind, build = "update", build_update_plan
            params = dict(min_width=cfg.min_bucket_width,
                          max_width=cfg.max_bucket_width,
                          chunk_nnz=chunk_nnz, chunk_rows=cfg.chunk_rows,
                          octave_points=cfg.octave_points)
        elif strategy == "split":
            kind, build = "split", build_split_plan
            params = dict(part_size=cfg.split_part_rows(),
                          min_width=cfg.min_bucket_width,
                          max_width=cfg.max_bucket_width,
                          chunk_nnz=chunk_nnz, chunk_rows=cfg.chunk_rows,
                          octave_points=cfg.octave_points,
                          max_groups=cfg.split_max_groups)
        else:
            # sparse-bucket promotion keeps each batch's sub-plan from
            # scattering its work over many tiny chunks. The JAX key
            # also names its ragged-tail rule, the mantissa grid, which
            # is the port's only one.
            kind = "batched_panel"
            params = dict(panel_size=cfg.panel_size,
                          batch_rows=self._batch_rows(),
                          min_width=cfg.min_bucket_width,
                          chunk_nnz=chunk_nnz, chunk_rows=cfg.chunk_rows,
                          split_width=cfg.split_width,
                          octave_points=cfg.octave_points,
                          ragged="mantissa", min_bucket_rows=16)

            def build(csr, ragged, **kw):
                return build_batched_panel_plan(csr, **kw)
        plan = cached_build(cfg.plan_cache_dir, kind, csr, params,
                            lambda: build(csr, **params))
        return self._device_plan(plan)

    def _device_plan(self, plan):
        aux = {}
        if isinstance(plan, SplitPlan):
            aux["perm"] = torch.from_numpy(
                plan.perm.astype(np.int64)).to(self.device)
            # one id space over the permuted table, live slots first
            return plan, [DeviceChunk(flatten_split_chunk(c, plan),
                                      plan.num_rows, self.device)
                          for c in plan.chunks], aux
        if isinstance(plan, BatchedPanelPlan):
            # per batch: the live global ids (a prefix: padding ids, equal
            # to num_rows, fill the tail), row_nnz and the device chunks
            aux["batches"] = [
                (torch.from_numpy(
                    b.global_ids[:b.plan.num_rows].astype(np.int64)).to(
                        self.device),
                 host_tensor(b.row_nnz).to(self.device),
                 [DeviceChunk(c, b.plan.num_rows, self.device)
                  for c in b.plan.chunks])
                for b in plan.batches]
            return plan, [], aux
        if isinstance(plan, PanelPlan):
            # the solve batch hugs the row count (a multiple of 8)
            batch = min(self.cfg.chunk_rows,
                        -(-(plan.num_rows + 1) // 8) * 8)
            m_pad = -(-(plan.num_rows + 1) // batch) * batch
            nnz_pad = np.zeros(m_pad, np.int32)
            nnz_pad[:plan.num_rows] = plan.row_nnz
            aux["row_nnz_pad"] = torch.from_numpy(nnz_pad).to(self.device)
            aux["m_pad"] = m_pad
            aux["solve_batch"] = batch
        chunks = [DeviceChunk(c, plan.num_rows, self.device)
                  for c in plan.chunks]
        return plan, chunks, aux

    # ----- factor padding helpers -----
    def _pad_f(self, arr: np.ndarray) -> torch.Tensor:
        f_pad = self.cfg.f_pad
        t = torch.as_tensor(arr, dtype=torch.float32)
        if t.shape[1] != f_pad:
            t = F.pad(t, (0, f_pad - t.shape[1]))
        return t.contiguous().to(self.device)

    def _unpad_f(self, arr: torch.Tensor) -> np.ndarray:
        return arr[:, :self.cfg.f].float().cpu().numpy()

    def _sum_r2(self) -> float:
        """Sum of squared training ratings (the r^2 term of the fused
        train RMSE), computed once."""
        if not hasattr(self, "_r2"):
            self._r2 = sum_r2(self.train_csr)
        return self._r2

    # ----- the save_model dumps -----
    def _dump_gram(self, a, b, what: str) -> None:
        """The first 1024 rows of a Gram and of its RHS as raw float32
        files (the JAX package's _dump_gram; the reference's
        CUMF_SAVE_MODEL dumps, als.cu:33, 49-57, 800-807). `what` names
        the phase and iteration: "tt_iter003" is theta's Gram, which
        updates X, "xx_iter003" X's; b goes under "ytheta_iter003" and
        "yTX_iter003"."""
        from cumf_als_tpu_torch.utils.checkpoint import save_debug_array
        k = min(int(a.shape[0]), 1024)
        save_debug_array(self.cfg.save_model_dir, what,
                         a[:k].float().cpu().numpy())
        save_debug_array(self.cfg.save_model_dir,
                         what.replace("tt", "ytheta").replace("xx", "yTX"),
                         b[:k].float().cpu().numpy())

    def _dump_due(self) -> Optional[str]:
        """The tag to dump the current phase's Gram under, if any."""
        return getattr(self, "_save_tag", None) if self.cfg.save_model \
            else None

    # ----- one phase -----
    def _update_phase(self, table, current, plan_pair,
                      collect_rmse_terms: bool):
        if isinstance(plan_pair[0], SplitPlan):
            return self._update_phase_split(table, current, plan_pair,
                                            collect_rmse_terms)
        if isinstance(plan_pair[0], PanelPlan):
            return self._update_phase_panelized(table, current, plan_pair,
                                                collect_rmse_terms)
        if isinstance(plan_pair[0], BatchedPanelPlan):
            return self._update_phase_batched_panel(
                table, current, plan_pair, collect_rmse_terms)
        return self._update_phase_direct(table, current, plan_pair,
                                         collect_rmse_terms)

    def _use_panel_aug(self) -> bool:
        """Augmented-lane panel phase: one combined A' accumulator, b
        rides row f-1 through accumulation and into the solve."""
        return cuda_solve.panel_aug_enabled(self.cfg)

    def _panel_table(self, table, n_panels: int, panel_size: int):
        """The gather table in the factor dtype, padded to whole panels."""
        if self.cfg.factor_dtype == "bf16":
            table = table.to(torch.bfloat16)
        return F.pad(table, (0, 0, 0, n_panels * panel_size - table.shape[0]))

    def accumulate_panels(self, table, plan_pair):
        """The panel route's Gram step over the whole phase: full
        accumulators a_buf (m_pad, f, f) and, with split buffers, b_buf
        (m_pad, f) (None when augmented), filled by `accumulate_into`."""
        plan, chunks, aux = plan_pair
        a_dtype = self._accum_dtype(sum(c.rows.shape[0] for c in chunks),
                                    plan.num_rows)
        a_buf, b_buf = self._accumulators(aux["m_pad"], a_dtype)
        # dummy rows carry id m, which lies inside a_buf (m_pad > m)
        accumulate_into(
            a_buf, b_buf,
            self._panel_table(table, plan.n_panels, plan.panel_size),
            chunks, plan.panel_size, self.cfg.backend == "pallas")
        return a_buf, b_buf

    def _accumulators(self, rows: int, a_dtype):
        f = self.cfg.f_pad
        a_buf = torch.zeros((rows, f, f), dtype=a_dtype, device=self.device)
        b_buf = None if self._use_panel_aug() else torch.zeros(
            (rows, f), dtype=torch.float32, device=self.device)
        return a_buf, b_buf

    def _update_phase_batched_panel(self, table, current, plan_pair,
                                    collect_rmse_terms: bool = False):
        """Row batch by row batch: the batch's panel Grams into one
        reusable (B + 1, f, f) accumulator (row B takes the dummy rows of
        a full batch, whose id is B), x0 gathered by global id, solves in
        slices of min(B, chunk_rows), then the solved rows written back
        by global id. Padding ids are not in the live prefix, so they are
        neither read nor written."""
        cfg = self.cfg
        plan, _chunks, aux = plan_pair
        bsz = plan.batch_rows
        table_pad = self._panel_table(
            table, -(-plan.num_cols // plan.panel_size), plan.panel_size)
        a_dtype = self._accum_dtype(
            sum(c.rows.shape[0] for _, _, chunks in aux["batches"]
                for c in chunks), plan.num_rows)
        sb = min(bsz, cfg.chunk_rows)
        se = torch.zeros((), dtype=torch.float32, device=self.device)
        a_full, b_full = self._accumulators(bsz + 1, a_dtype)
        a_buf = a_full[:bsz]
        b_buf = None if b_full is None else b_full[:bsz]
        tag = self._dump_due()
        for gids, row_nnz, chunks in aux["batches"]:
            a_full.zero_()
            if b_full is not None:
                b_full.zero_()
            accumulate_into(a_full, b_full, table_pad, chunks,
                            plan.panel_size, cfg.backend == "pallas")
            if tag:   # the first batch's accumulators
                self._dump_gram(a_buf, b_buf, tag)
                tag = None
            x0 = F.pad(current.index_select(0, gids),
                       (0, 0, 0, bsz - gids.shape[0]))
            outs = [_solve_slice(a_buf, b_buf, x0, row_nnz, lo, cfg.lam,
                                 sb, cfg.solver, cfg.cg_iters, cfg.cg_tol,
                                 cfg.backend)
                    for lo in range(0, bsz, sb)]
            solved = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
            if collect_rmse_terms:
                se = se + _se_terms(a_buf, b_buf, solved, sb)
            current.index_copy_(0, gids,
                                solved[:gids.shape[0]].to(current.dtype))
        if collect_rmse_terms:
            se = se + self._sum_r2()
        return current, se

    def _update_phase_panelized(self, table, current, plan_pair,
                                collect_rmse_terms: bool = False):
        """Panel Grams into full accumulators, then batched solves of the
        accumulators, slice by slice (on the "pallas" backend kernel K3,
        or K5b over an augmented accumulator)."""
        cfg = self.cfg
        plan, _chunks, aux = plan_pair
        m, m_pad = plan.num_rows, aux["m_pad"]
        a_buf, b_buf = self.accumulate_panels(table, plan_pair)
        if self._dump_due():
            self._dump_gram(a_buf, b_buf, self._dump_due())
        x0_full = F.pad(current, (0, 0, 0, m_pad - m))
        batch = aux["solve_batch"]
        outs = [_solve_slice(a_buf, b_buf, x0_full, aux["row_nnz_pad"], lo,
                             cfg.lam, batch, cfg.solver, cfg.cg_iters,
                             cfg.cg_tol, cfg.backend)
                for lo in range(0, m_pad, batch)]
        new_pad = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
        se = 0.0
        if collect_rmse_terms:
            se = _se_terms(a_buf, b_buf, new_pad, batch) + self._sum_r2()
        return new_pad[:m].contiguous(), se

    def _update_phase_split(self, table, current, plan_pair,
                            collect_rmse_terms: bool):
        """Direct solves over the popularity-permuted gather table of a
        SplitPlan: every row is still seen whole by one fused
        gather + Gram + CG instance, so no partial-Gram accumulators
        exist. The device chunks address the permuted table in one id
        space (ops/tiling.flatten_split_chunk), so once the table is
        permuted the chunk loop is the direct route's, with the same
        four ways to solve a chunk."""
        _plan, chunks, aux = plan_pair
        return self._solve_chunks(table.index_select(0, aux["perm"]),
                                  current, chunks, collect_rmse_terms)

    def _update_phase_direct(self, table, current, plan_pair,
                             collect_rmse_terms: bool):
        """Solve every row of `current` against the fixed `table`, chunk
        by chunk. Returns the factor and, when requested, the summed
        train squared error (a device scalar)."""
        chunks = plan_pair[1]
        if chunks and self._dump_due():
            # the first chunk's Gram in plain torch, regularized, from the
            # table before its bf16 cast, as the JAX package dumps it
            ch = chunks[0]
            self._dump_gram(*gram_rhs(extend_table(table), ch.cols, ch.vals,
                                      ch.nnz, self.cfg.lam), self._dump_due())
        return self._solve_chunks(table, current, chunks, collect_rmse_terms)

    def _solve_chunks(self, table, current, chunks,
                      collect_rmse_terms: bool):
        """The chunk loop of the direct and split routes, writing solved
        rows back in place. A chunk is solved, on the "pallas" backend
        with CG, by one fused kernel: K7 over the live lanes when
        `wide_enabled` (which wins over aug), else K6 when `aug_enabled`,
        else K1; otherwise by gather + einsum + `solve` + the train-error
        identity in plain torch."""
        cfg = self.cfg
        use_kernel = cfg.backend == "pallas" and cfg.solver == "cg"
        use_wide = use_kernel and cuda_solve.wide_enabled(cfg)
        use_aug = use_kernel and not use_wide and cuda_solve.aug_enabled(cfg)
        if cfg.factor_dtype == "bf16":   # cast the table before the gather
            table = table.to(torch.bfloat16)
        table_ext = extend_table(table)
        kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
        se_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        for ch in chunks:
            k = ch.n_real
            x0 = current.index_select(0, ch.rows_real)
            if k < ch.rows.shape[0]:   # dummy tail rows start from zero
                x0 = F.pad(x0, (0, 0, 0, ch.rows.shape[0] - k))
            if use_wide:
                solved, se = cuda_solve.gather_gram_cg_wide(
                    table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam,
                    cuda_solve.wide_f2(cfg.f), **kw)
                se = se.sum()
            elif use_kernel:
                solved, se = cuda_solve.gather_gram_cg(
                    table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam,
                    aug=use_aug, **kw)
                se = se.sum()
            else:
                a, b = gram_rhs(table_ext, ch.cols, ch.vals, ch.nnz,
                                cfg.lam, gram_dtype=cfg.gram_dtype)
                solved = solve(a, b, x0, solver=cfg.solver,
                               backend=cfg.backend, **kw)
                solved = solved * (ch.nnz > 0).float()[:, None]
                se = fused_sq_err(a, b, ch.vals, ch.nnz, cfg.lam, solved) \
                    if collect_rmse_terms else 0.0
                del a, b
            if collect_rmse_terms:
                se_acc = se_acc + se
            current.index_copy_(0, ch.rows_real,
                                solved[:k].to(current.dtype))
        return current, se_acc

    # ----- the training loop -----
    def run(self, x0: np.ndarray, theta0: np.ndarray,
            start_iter: int = 0) -> ALSResult:
        cfg = self.cfg
        if cfg.factor_store == "bf16":
            # as in the JAX package: the initial factors round to bf16,
            # and the resident factors stay f32
            x0 = torch.as_tensor(x0).to(torch.bfloat16)
            theta0 = torch.as_tensor(theta0).to(torch.bfloat16)
        x = self._pad_f(x0)
        theta = self._pad_f(theta0)
        # Zero the factors of empty rows/cols up front: the plans leave
        # them out, so their initial values would otherwise persist.
        x *= torch.from_numpy(
            np.diff(self.train_csr.indptr) > 0).to(self.device)[:, None]
        theta *= torch.from_numpy(
            np.diff(self.train_csc.indptr) > 0).to(self.device)[:, None]

        history: List[IterationMetrics] = []
        if cfg.verbose:
            print(f"*******parameters: m: {cfg.m}, n:  {cfg.n}, "
                  f"f: {cfg.f}, nnz: {self.train_csr.nnz} ")
            print("*******start iterations...")
        for it in range(start_iter, cfg.iters):
            if cfg.verbose:
                print(f"---------------------------ALS iteration {it}, "
                      f"update X.----------------------------------")
            t0 = seconds()
            # tt: theta's Gram, which updates X (the reference's names)
            self._save_tag = f"tt_iter{it:03d}"
            x, _ = self._update_phase(theta, x, self.plan_x, False)
            if cfg.debug_timing:
                # an exact per-phase split costs a sync at the boundary
                sync(self.device)
            tx = seconds() - t0
            if cfg.debug_timing:
                print(f"update X run {tx:f} seconds, gridSize: {cfg.m}, "
                      f"blockSize {cfg.f}.")

            if cfg.verbose:
                print(f"---------------------------------- ALS iteration "
                      f"{it}, update theta ----------------------------------")
            t0 = seconds()
            self._save_tag = f"xx_iter{it:03d}"
            want_fused = cfg.train_rmse_method == "fused"
            theta, se_acc = self._update_phase(x, theta, self.plan_theta,
                                               want_fused)
            sync(self.device)
            tth = seconds() - t0
            if cfg.debug_timing:
                print(f"update theta run {tth:f} seconds, gridSize: "
                      f"{cfg.n}, blockSize {cfg.f}.")
            if cfg.save_model:   # the factors of each iteration
                from cumf_als_tpu_torch.utils.checkpoint import \
                    save_debug_array
                save_debug_array(cfg.save_model_dir, f"XT_iter{it:03d}",
                                 self._unpad_f(x))
                save_debug_array(cfg.save_model_dir, f"thetaT_iter{it:03d}",
                                 self._unpad_f(theta))

            t0 = seconds()
            if want_fused:
                train_rmse = float(np.sqrt(max(float(se_acc), 0.0) /
                                           self.train_csr.nnz))
            else:
                train_rmse = rmse_direct(
                    x, theta, self.train_csr.to_coo_rows(),
                    self.train_csr.indices, self.train_csr.data)
            test_rmse = float("nan")
            if self.test_coo is not None and self.test_coo.nnz:
                test_rmse = rmse_direct(x, theta, self.test_coo.row,
                                        self.test_coo.col,
                                        self.test_coo.data)
            end_iteration(cfg, history, IterationMetrics(
                it, train_rmse, test_rmse, tx, tth, seconds() - t0),
                lambda: (self._unpad_f(x), self._unpad_f(theta)))
        return ALSResult(x=self._unpad_f(x), theta=self._unpad_f(theta),
                         history=history)


def do_als(csr: CSRMatrix, csc: Optional[CSRMatrix],
           test: Optional[COOMatrix], theta0: np.ndarray, x0: np.ndarray,
           cfg: ALSConfig, device=None) -> ALSResult:
    """Functional doALS: the sparse views and initial factors in, the
    final factors and the RMSE trajectory out. Runs on CUDA unless
    `device="cpu"`."""
    model = ALS(cfg, csr, csc, test, device=device)
    return model.run(x0, theta0)
