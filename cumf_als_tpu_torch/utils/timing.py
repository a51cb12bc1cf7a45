"""Wall-clock timing for the per-phase stdout lines and the metrics, and
a phase timer that sums named phases (the reference's getRuntime.sh
aggregation)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict

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


_sync_device = sync   # PhaseTimer.phase's `sync` argument shadows it


class PhaseTimer:
    """Accumulates named phase durations and their call counts."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        """Times the block under `name`. `sync`, a torch.device or a
        tensor (its device), is synced before the clock stops, so the
        phase holds the device work it queued (the JAX package's
        block_until_ready)."""
        t0 = seconds()
        try:
            yield
        finally:
            if sync is not None:
                _sync_device(sync.device if isinstance(sync, torch.Tensor)
                             else torch.device(sync))
            dt = seconds() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(f"{name}: {self.totals[name]:.6f} s over "
                         f"{self.counts[name]} calls")
        return "\n".join(lines)
