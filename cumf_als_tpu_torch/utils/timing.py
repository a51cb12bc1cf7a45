"""Wall-clock timing for the per-phase stdout lines and the metrics."""

from __future__ import annotations

import time

import torch


def seconds() -> float:
    """Monotonic wall-clock seconds."""
    return time.monotonic()


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (the JAX package's
    block_until_ready at the end of a timed phase). A no-op on the CPU,
    where PyTorch runs synchronously."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
