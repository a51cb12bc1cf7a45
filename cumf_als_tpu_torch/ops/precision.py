"""Full float32 for the port's float32 matrix products.

The JAX package sums its Grams and train-error terms at
`Precision.HIGHEST`. A PyTorch float32 matrix product follows the
caller's global switch instead (`torch.backends.cuda.matmul.allow_tf32`,
`torch.set_float32_matmul_precision`, and in newer PyTorch the
per-backend `fp32_precision`), which can let TF32 (10 mantissa bits) or
bf16 into it. `full_f32()` pins full float32 for the products inside it
and gives the caller's setting back after, as it found it.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Float32 matrix products inside run in full float32 on the card
    (cuBLAS) and on the CPU (oneDNN); the caller's settings are restored
    on exit, an exception included."""
    cuda = torch.backends.cuda.matmul
    if not hasattr(cuda, "fp32_precision"):   # one legacy switch only
        saved = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            yield
        finally:
            torch.set_float32_matmul_precision(saved)
        return
    # Newer PyTorch keeps the legacy switch and the per-backend settings
    # side by side, and its legacy getter raises where a caller set them
    # apart: pin both, and restore each from what it read.
    mkldnn = torch.backends.mkldnn.matmul
    saved_new = (cuda.fp32_precision, mkldnn.fp32_precision)
    try:
        saved_legacy = torch.get_float32_matmul_precision()
    except RuntimeError:
        saved_legacy = None
    torch.set_float32_matmul_precision("highest")
    cuda.fp32_precision = mkldnn.fp32_precision = "ieee"
    try:
        yield
    finally:
        if saved_legacy is not None:
            torch.set_float32_matmul_precision(saved_legacy)
        cuda.fp32_precision, mkldnn.fp32_precision = saved_new
