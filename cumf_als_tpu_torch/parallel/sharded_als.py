"""Sharded ALS on torch.distributed (the JAX package's
parallel/sharded_als.py in PyTorch): the hugewiki app's multi-GPU
topology (reference hugewiki/hugewiki.cu:2248-2888) over ranks, one
process and one device each.

  - X, the large factor, is row-sharded over the ranks, balanced by
    nonzero count (parallel/plan.py): rank r holds rows
    `row_plan.global_ids[r]`, padded to m_loc;
  - theta, the small factor, is replicated: every rank holds all of it
    and ends each theta phase with the same bits;
  - X phase, no collective: each rank solves its own rows, by direct
    chunks (kernel K1 `gather_gram_cg` on the "pallas" backend with CG,
    K6 with aug_gram="force"; else the plain Gram and `ops.solve`) or,
    when theta passes panel_size rows and the accumulators fit
    panel_budget_bytes, by the panel steps: K2 (K5a augmented) into the
    rank's accumulators, then solve slices with the diagonal (K3, K5b);
  - theta phase: at one rank K1 solves each reduce block directly; at
    more, each rank forms the partial (A, b, sum v^2) of its own ratings
    (K2, or K5a), `all_reduce_sum` adds them up (the reference's
    anchor-GPU gather and cublasSaxpy, hugewiki.cu:2703-2730), and every
    rank solves the same block with the diagonal (K3, or K5b) and takes
    its train squared error from the summed raw A.

Rank r computes shard d = r of what the JAX program computes on mesh
device d: the plans are the JAX package's, array for array, and a rank
takes index r of their leading axis. A rank skips no step, so every rank
launches the same kernels and meets the same collectives. Dummy ids are
masked before every write: a chunk's rows beyond its real prefix (m_loc
on X, n on theta), whose id the JAX package drops with mode="drop".

Not ported, XLA dispatch and TPU-memory workarounds: `fused_iteration`,
`fused_phases`, `_grouped_iteration` and the group functions,
`_maybe_throttle`, `call_with_vmem_backoff`. `cfg.fused_step` is accepted
with no effect. As the JAX model, this one writes no save_model dumps.

At F > 128 (f_pad 256) the partials of two or more ranks go through K2
and K3, which take f <= 128 and raise at 256 with their names (ROADMAP
queue C); their plain versions, on the CPU, take f_pad 256.
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.models.als import (ALSResult, DeviceChunk,
                                           IterationMetrics, _solve_slice,
                                           accum_dtype, accumulate_into,
                                           end_iteration)
from cumf_als_tpu_torch.models.out_of_core import TEST_CHUNK
from cumf_als_tpu_torch.ops import cuda_solve
from cumf_als_tpu_torch.ops.gram import extend_table, gram_rhs
from cumf_als_tpu_torch.ops.precision import full_f32
from cumf_als_tpu_torch.ops.solve import solve
from cumf_als_tpu_torch.parallel.mesh import DATA_AXIS, Mesh, current_mesh
from cumf_als_tpu_torch.parallel.plan import (AlignedSteps,
                                              build_reduce_plan,
                                              build_sharded_row_plan,
                                              build_sharded_x_panel_steps)
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix
from cumf_als_tpu_torch.utils.plan_cache import cached_build, cached_transpose
from cumf_als_tpu_torch.utils.timing import seconds, sync

# rows of a block whose f32 copy of A the train error takes at once
SE_ROWS = 4096


def _rank_chunk(chunk, rank: int, rows, nnz, num_rows: int,
                device: torch.device) -> DeviceChunk:
    """Rank `rank`'s part of a plan chunk on the device (rows and nnz
    given when they carry no rank axis)."""
    return DeviceChunk(SimpleNamespace(
        width=chunk.width, panel=getattr(chunk, "panel", 0), rows=rows,
        nnz=nnz, cols=chunk.cols[rank], vals=chunk.vals[rank]),
        num_rows, device)


class ShardedALS:
    """ALS over the ranks of a 1-D mesh (the hugewiki-capability path).

    `mesh` defaults to `parallel.mesh.current_mesh(device)`: the process
    group when one exists, the torchrun world, or one rank on `device`
    (CUDA unless "cpu"). `n_devices`, when given, must equal its world
    size."""

    def __init__(self, cfg: ALSConfig, train_csr: CSRMatrix,
                 train_csc: Optional[CSRMatrix] = None,
                 test_coo: Optional[COOMatrix] = None,
                 n_devices: Optional[int] = None,
                 block_rows: int = 1 << 14, device=None,
                 mesh: Optional[Mesh] = None):
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
        self._build_plans(train_csr, train_csc, block_rows)
        if cfg.plan_cache_dir and self.rank == 0:
            self.mesh.barrier()
        self._device_plans()
        self._test = self._test_entries(test_coo)
        # every rank but 0 prints nothing and writes no file
        self._rank_cfg = cfg if self.rank == 0 else cfg.replace(
            verbose=False, debug_timing=False, metrics_jsonl=None,
            checkpoint_dir=None)
        self.plan_seconds = seconds() - t0

    # ----- plans -----
    def _build_plans(self, train_csr, train_csc, block_rows: int) -> None:
        """The JAX package's plans under its cache kinds and parameters
        (sharded_als.py:61-144), so either package loads the other's."""
        cfg, n_dev = self.cfg, self.n_dev
        cache = cfg.plan_cache_dir
        self.train_csc = train_csc or cached_transpose(cache, train_csr)
        row_params = dict(n_dev=n_dev, min_w=cfg.min_bucket_width,
                          max_w=cfg.max_bucket_width,
                          chunk_nnz=cfg.chunk_nnz,
                          chunk_rows=cfg.chunk_rows,
                          octave=cfg.octave_points)
        self.row_plan = cached_build(
            cache, "sh_row", train_csr, row_params,
            lambda: build_sharded_row_plan(
                train_csr, n_dev, cfg.min_bucket_width,
                cfg.max_bucket_width, cfg.chunk_nnz, cfg.chunk_rows,
                octave_points=cfg.octave_points))
        self.reduce_plan = cached_build(
            cache, "sh_reduce", train_csr,
            dict(row_params, block_rows=block_rows),
            lambda: build_reduce_plan(self.train_csc, self.row_plan,
                                      block_rows=block_rows))
        # Panel X phase when the replicated theta passes the panel size
        # and the rank's full accumulators fit the budget (the JAX gate,
        # sharded_als.py:99-139; A's bytes at the configured gram_dtype).
        self.x_steps = None
        f = cfg.f_pad
        ps = min(cfg.panel_size, 1 << 16)
        a_el = 2 if cfg.gram_dtype == "bf16" else 4
        m_loc = self.row_plan.m_loc
        batch = min(cfg.chunk_rows, -(-(m_loc + 1) // 8) * 8)
        m_pad = -(-(m_loc + 1) // batch) * batch
        if (cfg.use_panels != "never"
                and train_csr.num_cols > ps + max(1, ps // 8)
                and m_pad * f * f * a_el <= cfg.panel_budget_bytes):
            self.x_panel_size, self._x_solve_batch = ps, batch
            self._x_m_pad = m_pad
            xp_params = dict(row_params, panel=ps, split_w=cfg.split_width,
                             octave=cfg.octave_points)
            aligned = cached_build(
                cache, "sh_xpanel", train_csr, xp_params,
                lambda: AlignedSteps(*build_sharded_x_panel_steps(
                    train_csr, self.row_plan, ps, cfg.min_bucket_width,
                    cfg.chunk_nnz, cfg.chunk_rows, cfg.split_width,
                    cfg.octave_points)))
            self.x_steps, self.x_n_panels = aligned.steps, aligned.n_panels

    def _device_plans(self) -> None:
        """This rank's part of every plan on its device."""
        r, dev = self.rank, self.device
        rp = self.row_plan
        if self.x_steps is not None:
            # dummy rows carry id m_loc, inside the accumulators
            self._x_chunks = [_rank_chunk(st, r, st.rows[r], st.nnz[r],
                                          rp.m_loc, dev)
                              for st in self.x_steps]
            ids = rp.global_ids[r]
            valid = ids < rp.m
            nnz = np.zeros(self._x_m_pad, np.int32)
            nnz[:rp.m_loc][valid] = np.diff(self.train_csr.indptr)[
                ids[valid]]
            self._x_nnz_loc = torch.from_numpy(nnz).to(dev)
        else:
            self._x_chunks = [_rank_chunk(ch, r, ch.rows[r], ch.nnz[r],
                                          rp.m_loc, dev)
                              for ch in rp.chunks]
        # theta rows are global ids (dummies n); cols index the rank's X
        self._blocks = [_rank_chunk(bl, r, bl.rows, bl.nnz_total,
                                    self.reduce_plan.n, dev)
                        for bl in self.reduce_plan.blocks]

    def _test_entries(self, coo: Optional[COOMatrix]):
        """This rank's test entries (those of its X rows): local row ids,
        theta ids, values, and the count over every rank."""
        if coo is None or not coo.nnz:
            return None
        rp = self.row_plan
        ids = rp.global_ids[self.rank]
        valid = ids < rp.m
        local = np.full(rp.m, -1, np.int64)
        local[ids[valid]] = np.arange(rp.m_loc)[valid]
        lr = local[np.asarray(coo.row)]
        mine = lr >= 0
        dev = self.device
        return (torch.from_numpy(lr[mine]).to(dev),
                torch.from_numpy(np.asarray(coo.col)[mine].astype(
                    np.int64)).to(dev),
                torch.from_numpy(np.asarray(coo.data, np.float32)[mine]
                                 ).to(dev), coo.nnz)

    # ----- factor layout -----
    def shard_x(self, x: np.ndarray) -> torch.Tensor:
        """(m, f) host factors -> this rank's rows, (m_loc, f_pad) f32 on
        its device (padding rows zero)."""
        rp = self.row_plan
        ids = rp.global_ids[self.rank]
        valid = ids < rp.m
        out = torch.zeros((rp.m_loc, self.cfg.f_pad), dtype=torch.float32)
        out[torch.from_numpy(valid), :x.shape[1]] = torch.as_tensor(
            np.asarray(x, np.float32)[ids[valid]])
        return out.to(self.device)

    def unshard_x(self, x_loc: torch.Tensor) -> np.ndarray:
        """Every rank's rows gathered into the (m, f) host factors (a
        collective: every rank calls it)."""
        rp = self.row_plan
        xs = self.mesh.all_gather(x_loc).cpu().numpy()
        out = np.zeros((rp.m, self.cfg.f), np.float32)
        for d in range(self.n_dev):
            ids = rp.global_ids[d]
            valid = ids < rp.m
            out[ids[valid]] = xs[d, valid, :self.cfg.f]
        return out

    def replicate_theta(self, theta: np.ndarray) -> torch.Tensor:
        out = torch.zeros((theta.shape[0], self.cfg.f_pad),
                          dtype=torch.float32)
        out[:, :theta.shape[1]] = torch.as_tensor(
            np.asarray(theta, np.float32))
        return out.to(self.device)

    def _table(self, t: torch.Tensor) -> torch.Tensor:
        """A gather table in the factor dtype (cast before the gather)."""
        return t.to(torch.bfloat16) if self.cfg.factor_dtype == "bf16" \
            else t

    # ----- the X phase: no collective -----
    def x_phase(self, theta: torch.Tensor,
                x_loc: torch.Tensor) -> torch.Tensor:
        if self.x_steps is not None:
            return self._x_panel_phase(theta, x_loc)
        cfg = self.cfg
        use_kernel = cfg.backend == "pallas" and cfg.solver == "cg"
        use_aug = use_kernel and cuda_solve.aug_enabled(cfg)
        table_ext = extend_table(self._table(theta))
        for ch in self._x_chunks:
            k = ch.n_real
            x0 = F.pad(x_loc.index_select(0, ch.rows_real),
                       (0, 0, 0, ch.rows.shape[0] - k))
            if use_kernel:
                solved, _ = cuda_solve.gather_gram_cg(
                    table_ext, ch.cols, ch.vals, ch.nnz, x0, cfg.lam,
                    cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol, aug=use_aug)
            else:
                a, b = gram_rhs(table_ext, ch.cols, ch.vals, ch.nnz, cfg.lam)
                solved = solve(a, b, x0, solver=cfg.solver,
                               cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol,
                               backend=cfg.backend)
                solved = solved * (ch.nnz > 0).float()[:, None]
            x_loc.index_copy_(0, ch.rows_real, solved[:k])
        return x_loc

    def x_accumulators(self, theta: torch.Tensor):
        """The panel X phase's Gram step: the rank's accumulators a_buf
        (m_pad, f, f) and b_buf (m_pad, f) (None when augmented), filled
        by `accumulate_into` (K2 or K5a on "pallas")."""
        cfg = self.cfg
        s, f = self.x_panel_size, cfg.f_pad
        depth = sum(ch.rows.shape[0] for ch in self._x_chunks) / \
            max(1, self.row_plan.m_loc)
        a_buf = torch.zeros((self._x_m_pad, f, f),
                            dtype=accum_dtype(cfg.gram_dtype, depth),
                            device=self.device)
        b_buf = None if cuda_solve.panel_aug_enabled(cfg) else torch.zeros(
            (self._x_m_pad, f), dtype=torch.float32, device=self.device)
        table = F.pad(self._table(theta),
                      (0, 0, 0, self.x_n_panels * s - theta.shape[0]))
        accumulate_into(a_buf, b_buf, table, self._x_chunks, s,
                        cfg.backend == "pallas")
        return a_buf, b_buf

    def _x_panel_phase(self, theta, x_loc):
        cfg = self.cfg
        a_buf, b_buf = self.x_accumulators(theta)
        m_loc, m_pad = self.row_plan.m_loc, self._x_m_pad
        x0_full = F.pad(x_loc, (0, 0, 0, m_pad - m_loc))
        batch = self._x_solve_batch
        outs = [_solve_slice(a_buf, b_buf, x0_full, self._x_nnz_loc, lo,
                             cfg.lam, batch, cfg.solver, cfg.cg_iters,
                             cfg.cg_tol, cfg.backend)
                for lo in range(0, m_pad, batch)]
        new = torch.cat(outs, dim=0) if len(outs) > 1 else outs[0]
        return new[:m_loc].contiguous()

    # ----- the theta phase: partials summed over the ranks -----
    def single_fused(self) -> bool:
        """At one rank every rating is local: K1 solves each block
        directly (pallas with CG), with no partial Gram."""
        cfg = self.cfg
        return self.n_dev == 1 and cfg.backend == "pallas" and \
            cfg.solver == "cg"

    def block_partials(self, xs_ext: torch.Tensor, bl: DeviceChunk):
        """One reduce block's (A, b, sum v^2) summed over the ranks, from
        each rank's own ratings: A raw (no regularizer) in bf16 when
        gram_dtype is "bf16" (the JAX package's bf16 partials), b and
        sum v^2 f32. Augmented, A is A' (b in row f-1, sum v^2 in its
        corner) and b is None."""
        cfg = self.cfg
        a_dt = torch.bfloat16 if cfg.gram_dtype == "bf16" else torch.float32
        pallas = cfg.backend == "pallas"
        if cuda_solve.panel_aug_enabled(cfg):
            gram = cuda_solve.gather_gram_aug_out if pallas else \
                cuda_solve.gather_gram_aug_out_plain
            a = gram(xs_ext, bl.cols, bl.vals, out_dtype=a_dt)
            self.mesh.all_reduce_sum(a)
            return a, None, a[:, -1, -1].float()
        gram = cuda_solve.gather_gram_out if pallas else \
            cuda_solve.gather_gram_out_plain
        a, b = gram(xs_ext, bl.cols, bl.vals, out_dtype=a_dt)
        v = bl.vals.float()
        bv = torch.cat([b, (v * v).sum(-1, keepdim=True)], dim=1)
        self.mesh.all_reduce_sum(a)
        self.mesh.all_reduce_sum(bv)
        return a, bv[:, :-1].contiguous(), bv[:, -1]

    @staticmethod
    def _block_se(a, b, vsq, x) -> torch.Tensor:
        """sum over rows of max(sum v^2 - 2 x.b + x^T A x, 0), A the raw
        summed Gram, in full f32 (an augmented A' adds nothing through
        x's zero lane f-1; b None reads it from A')."""
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for lo in range(0, x.shape[0], SE_ROWS):
            xs = x[lo:lo + SE_ROWS]
            af = a[lo:lo + SE_ROWS].float()
            bs = af[:, -1, :] if b is None else b[lo:lo + SE_ROWS]
            with full_f32():
                aq = torch.einsum("rfg,rg->rf", af, xs)
            per_row = vsq[lo:lo + SE_ROWS] - 2.0 * (xs * bs).sum(-1) + \
                (xs * aq).sum(-1)
            total = total + per_row.clamp_min(0.0).sum()
        return total

    def theta_phase(self, x_loc: torch.Tensor, theta: torch.Tensor):
        """Every reduce block, in plan order, on every rank; returns
        theta (updated in place) and the train squared error (a device
        scalar, the same on every rank)."""
        cfg = self.cfg
        single = self.single_fused()
        aug = cuda_solve.panel_aug_enabled(cfg)
        xs_ext = extend_table(self._table(x_loc))
        kw = dict(cg_iters=cfg.cg_iters, cg_tol=cfg.cg_tol)
        se = torch.zeros((), dtype=torch.float32, device=self.device)
        for bl in self._blocks:
            k = bl.n_real
            th0 = F.pad(theta.index_select(0, bl.rows_real),
                        (0, 0, 0, bl.rows.shape[0] - k))
            if single:
                solved, se_rows = cuda_solve.gather_gram_cg(
                    xs_ext, bl.cols, bl.vals, bl.nnz, th0, cfg.lam,
                    aug=cuda_solve.aug_enabled(cfg), **kw)
                se = se + se_rows.sum()
            else:
                a, b, vsq = self.block_partials(xs_ext, bl)
                nnzf = bl.nnz.float()
                diag = nnzf * cfg.lam + (nnzf == 0).float()
                solved = solve(a, b, th0, solver=cfg.solver,
                               backend=cfg.backend, diag=diag, aug=aug, **kw)
                solved = solved * (nnzf > 0).float()[:, None]
                se = se + self._block_se(a, b, vsq, solved)
                del a, b
            theta.index_copy_(0, bl.rows_real, solved[:k])
        return theta, se

    def test_rmse(self, x_loc: torch.Tensor, theta: torch.Tensor) -> float:
        """Test RMSE: each rank sums the squared error of its entries,
        then the sums are added over the ranks."""
        if self._test is None:
            return float("nan")
        rows, cols, vals, total_n = self._test
        se = torch.zeros(1, dtype=torch.float64, device=self.device)
        for lo in range(0, rows.shape[0], TEST_CHUNK):
            pred = (x_loc.index_select(0, rows[lo:lo + TEST_CHUNK]) *
                    theta.index_select(0, cols[lo:lo + TEST_CHUNK])).sum(-1)
            e = vals[lo:lo + TEST_CHUNK] - pred
            se += (e * e).sum(dtype=torch.float64)
        return float(torch.sqrt(self.mesh.all_reduce_sum(se) / total_n))

    # ----- the training loop -----
    def run(self, x0: np.ndarray, theta0: np.ndarray, start_iter: int = 0,
            on_theta: Optional[Callable[[torch.Tensor], None]] = None
            ) -> ALSResult:
        """Train from (x0, theta0) on every rank (each passes the same
        factors); returns the full X and theta on every rank. Only rank 0
        prints the reference's lines and writes checkpoints and the
        metrics JSONL. `on_theta`, when given, is called with the device
        theta (f_pad lanes) at the end of each iteration. `x_shard` keeps
        the rank's own rows of X."""
        cfg, rcfg = self.cfg, self._rank_cfg
        # zero the empty rows and columns: no plan names them, so their
        # initial values would otherwise persist
        theta0 = np.asarray(theta0, np.float32) * (
            np.diff(self.train_csc.indptr) > 0)[:, None]
        x0 = np.asarray(x0, np.float32) * (
            np.diff(self.train_csr.indptr) > 0)[:, None]
        x_loc = self.shard_x(x0)
        theta = self.replicate_theta(theta0)
        history: List[IterationMetrics] = []
        if rcfg.verbose:
            print(f"*******parameters: m: {cfg.m}, n:  {cfg.n}, "
                  f"f: {cfg.f}, nnz: {self.train_csr.nnz} ")
            print(f"*******mesh: {self.n_dev} devices over axis "
                  f"'{DATA_AXIS}'.")
            print("*******start iterations...")
        for it in range(start_iter, cfg.iters):
            t0 = seconds()
            x_loc = self.x_phase(theta, x_loc)
            if cfg.debug_timing:
                sync(self.device)
            tx = seconds() - t0
            t0 = seconds()
            theta, se = self.theta_phase(x_loc, theta)
            sync(self.device)
            tth = seconds() - t0
            if rcfg.verbose:
                print(f"update X+theta run {tx + tth:f} seconds (sharded, "
                      f"{self.n_dev} devices).")
            t0 = seconds()
            train_rmse = float(np.sqrt(max(float(se), 0.0) /
                                       self.train_csr.nnz))
            test_rmse = self.test_rmse(x_loc, theta)
            # a due checkpoint gathers X on every rank; rank 0 writes it
            factors = None
            if cfg.checkpoint_every and cfg.checkpoint_dir and \
                    (it + 1) % cfg.checkpoint_every == 0:
                factors = (self.unshard_x(x_loc), self._unpad(theta))
            end_iteration(rcfg, history, IterationMetrics(
                it, train_rmse, test_rmse, tx, tth, seconds() - t0),
                lambda: factors)
            if on_theta is not None:
                on_theta(theta)
        self.x_shard = x_loc
        return ALSResult(x=self.unshard_x(x_loc), theta=self._unpad(theta),
                         history=history)

    def _unpad(self, t: torch.Tensor) -> np.ndarray:
        return t[:, :self.cfg.f].float().cpu().numpy()


def run_rank(mesh: Mesh, cfg: ALSConfig, data, x0: np.ndarray,
             theta0: np.ndarray, block_rows: int = 1 << 14) -> dict:
    """One rank of a spawned run (`parallel.mesh.spawn(n, run_rank,
    ...)`): ShardedALS on the rank's mesh for cfg.iters iterations.
    `data` is (train CSR, test COO) or a function that returns them (the
    bench's loader, so that a large data set is read, not pickled).

    Returns the history; X; theta on rank 0 (None elsewhere) and a
    SHA-256 of theta's bytes after each iteration on every rank; the
    rank's own rows of X with their global ids; the kernel launches of
    the run; the peak device memory (None on the CPU); and the plan's
    counts: X panel steps (0 on the direct route), X solve slices,
    reduce blocks."""
    train, test = data() if callable(data) else data
    model = ShardedALS(cfg, train, None, test, block_rows=block_rows,
                       mesh=mesh)
    cuda = model.device.type == "cuda"
    cuda_solve.reset_launch_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats(model.device)
    digests = []
    res = model.run(x0, theta0, on_theta=lambda t: digests.append(
        hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()))
    rp = model.row_plan
    ids = rp.global_ids[mesh.rank]
    valid = ids < rp.m
    panel = model.x_steps is not None
    return dict(history=res.history, x=res.x,
                theta=res.theta if mesh.rank == 0 else None,
                theta_sha256=digests, own_ids=ids[valid],
                own_x=model.x_shard[torch.from_numpy(valid).to(
                    model.device)][:, :cfg.f].cpu().numpy(),
                launches=dict(cuda_solve.LAUNCHES),
                peak_bytes=torch.cuda.max_memory_allocated(model.device)
                if cuda else None,
                x_steps=len(model.x_steps) if panel else 0,
                x_slices=model._x_m_pad // model._x_solve_batch
                if panel else 0,
                n_blocks=len(model.reduce_plan.blocks))
