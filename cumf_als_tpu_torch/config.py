"""Configuration of the PyTorch/CUDA ALS port.

`ALSConfig` has the same field names and defaults as the JAX package's
(cumf_als_tpu/config.py), so a configuration carries across unchanged
(see interop.py). Fields that steer the TPU toolchain only are accepted
and have no effect here:

- ``gram_precision``: the port's Gram sums are full f32 on every path;
- ``fuse_phase``, ``fuse_max_chunks``, ``fused_step``: PyTorch runs
  eagerly, chunk by chunk.

``plan_cache_dir`` caches the built plans on disk in the JAX package's
format (utils/plan_cache.py); ``host_offload_x`` selects the out-of-core
model (models/factory.py).

``split_gather``, ``gather_part_bytes``, ``split_min_table_bytes`` and
``split_max_groups`` steer the strategy choice and the split plan
exactly as in the JAX package; on the device the split route addresses
the permuted table in one id space (ops/tiling.flatten_split_chunk).

``wide_kernel`` has the JAX package's effect: "on" sends factor widths
128 < F <= 256 (f_pad 256) on the fused routes through the kernel that
computes the 128 + wide_f2(F) live lanes only
(``ops/cuda_solve.wide_enabled``); "off", the default, runs them through
the monolithic fused kernel at 256 lanes. The route is opt-in as in the
JAX package.

``aug_gram`` selects the augmented-lane form as in the JAX package
(``ops/cuda_solve.aug_enabled`` and ``panel_aug_enabled``): the rating
value rides the free lane f_pad-1 of the gathered rows, so one Gram
carries A, b and sum v^2. "auto" turns it on for the panel route when
the solver is CG, ``gram_dtype`` is "f32" and F < f_pad (one accumulator
instead of split (A, b) buffers); "force" also turns it on with bf16
accumulators and on the direct route's fused kernel; "off" keeps split
buffers everywhere.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ALSConfig:
    """Full configuration of one ALS run (field for field the JAX
    package's ALSConfig)."""

    # --- problem shape (the CLI's positional arguments) ---
    m: int
    n: int
    f: int
    nnz: int = 0
    nnz_test: int = 0
    lam: float = 0.048
    x_batch: int = 1
    theta_batch: int = 1
    data_dir: str = ""

    # --- training loop ---
    iters: int = 10
    seed: int = 0
    init_scale: float = 0.2  # theta = init_scale * U(0, 1)

    # --- solver ---
    solver: str = "cg"  # one of: "cg", "cholesky", "lu"
    cg_iters: int = 6
    cg_tol: float = 1e-4

    # --- precision ---
    # factor_dtype: dtype of the gathered factor the Grams are formed
    # from ("f32" or "bf16"); the table is cast before the gather.
    factor_dtype: str = "f32"
    # factor_store: as in the JAX package, "bf16" rounds the initial
    # factors to bf16 and the factors then stay f32 between phases.
    factor_store: str = "f32"
    gram_precision: str = "highest"  # no effect: Gram sums are f32
    # gram_dtype: dtype of the Gram matrices fed to the solver, and of
    # the panel route's accumulators ("f32" or "bf16").
    gram_dtype: str = "f32"

    # --- RMSE ---
    # Rows/cols with no training ratings get zero factors (prediction 0).
    surpass_nan: bool = True
    # "fused": train RMSE from the theta-phase Gram/RHS identity
    # (ops/rmse.py); "direct": per-nonzero gather and dot.
    train_rmse_method: str = "fused"

    # --- bucketing / memory batching (ops/tiling.py) ---
    min_bucket_width: int = 8
    max_bucket_width: int = 1 << 18
    # padded slots per chunk: bounds the transient gather / Gram work
    chunk_nnz: int = 1 << 22
    # rows per chunk: bounds the per-chunk (R, f, f) Gram partials
    chunk_rows: int = 1 << 14
    batch_rows: int = 0            # batched-panel route (0: by gram_dtype)
    octave_points: int = 8
    # panel subrows longer than this split into exact segments
    split_width: int = 4096

    # --- kernels ---
    # "xla": plain-torch gather + einsum + solve (the JAX XLA route);
    # "pallas": the hand-written CUDA kernels (their plain versions on
    # the CPU).
    backend: str = "xla"
    # Panel route: when the gather table exceeds panel_size rows and the
    # updated factor's full (A, b) accumulators fit panel_budget_bytes,
    # partial Grams per table panel are scatter-added into them.
    use_panels: str = "auto"       # auto | never
    aug_gram: str = "auto"         # auto | off | force (see above)
    panel_size: int = 1 << 16
    panel_budget_bytes: int = 2 << 30
    split_gather: str = "auto"     # auto | off | force
    gather_part_bytes: int = 64 << 20
    split_min_table_bytes: int = 128 << 20
    split_max_groups: int = 96
    wide_kernel: str = "off"       # off | on (see above)
    fuse_phase: bool = True        # no effect
    fuse_max_chunks: int = 256     # no effect

    # --- plan cache (utils/plan_cache.py; None: plans are built) ---
    plan_cache_dir: Optional[str] = None

    # --- checkpoint / resume ---
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # iterations; 0 = disabled
    resume: bool = False

    # --- observability ---
    verbose: bool = True       # reference-style stdout contract lines
    debug_timing: bool = True  # per-phase timing lines
    save_model: bool = False   # Gram and factor dumps (ALS only)
    save_model_dir: str = "./log"
    profile_dir: Optional[str] = None  # torch.profiler trace (the CLI)
    metrics_jsonl: Optional[str] = None  # append per-iteration JSON lines

    # --- parallelism and out-of-core ---
    # mesh_shape: ShardedALS over prod(mesh_shape) ranks (the world
    # size); with host_offload_x it is not ported yet
    mesh_shape: Optional[Tuple[int, ...]] = None
    fused_step: str = "auto"       # no effect
    mesh_axis_names: Tuple[str, ...] = ("data",)
    host_offload_x: bool = False
    x_placement: str = "host"
    x_warm_start: bool = True
    stream_val_dtype: str = "f32"

    def __post_init__(self):
        if self.f <= 0:
            raise ValueError(f"F must be positive, got {self.f}")
        choices = {
            "solver": ("cg", "cholesky", "lu"),
            "factor_dtype": ("f32", "bf16"),
            "gram_dtype": ("f32", "bf16"),
            "gram_precision": ("highest", "high", "default"),
            "train_rmse_method": ("direct", "fused"),
            "backend": ("xla", "pallas"),
            "use_panels": ("auto", "never"),
            "aug_gram": ("auto", "off", "force"),
            "stream_val_dtype": ("f32", "f16"),
            "x_placement": ("host", "device"),
            "fused_step": ("auto", "on", "off"),
            "split_gather": ("auto", "off", "force"),
            "wide_kernel": ("off", "on"),
        }
        for name, allowed in choices.items():
            if getattr(self, name) not in allowed:
                raise ValueError(f"unknown {name} {getattr(self, name)!r}")

    def split_part_rows(self) -> int:
        """Rows per gather-table part of the split route: the largest
        multiple of 8 whose f_pad-wide slab stays under gather_part_bytes
        in the factor dtype."""
        item = 2 if self.factor_dtype == "bf16" else 4
        s = self.gather_part_bytes // (self.f_pad * item)
        return max(8, (s // 8) * 8)

    @property
    def f_pad(self) -> int:
        """F padded to a multiple of 128, as in the JAX package, so plans,
        strategy choices and accumulator shapes match it one to one. The
        padded lanes solve to zero."""
        return max(128, ((self.f + 127) // 128) * 128)

    def replace(self, **kw) -> "ALSConfig":
        return dataclasses.replace(self, **kw)


# The reference workloads (cumf_als README; shapes as in the JAX package).
NETFLIX = ALSConfig(m=17770, n=480189, f=100, nnz=99_072_112,
                    nnz_test=1_408_395, lam=0.048, x_batch=1, theta_batch=3)
ML10M = ALSConfig(m=71567, n=65133, f=100, nnz=9_000_048,
                  nnz_test=1_000_006, lam=0.05, x_batch=1, theta_batch=1)
