"""On-disk cache of the compacted arrays of streamed plan chunks (the JAX
package's utils/stream_cache.py, in numpy alone).

Sharded out-of-core training at hugewiki scale keeps its plans lazy and
makes every chunk's padded arrays when it is streamed, each iteration
(the reference re-uploads CSR slices per batch the same way, reference
hugewiki/hugewiki.cu:2508-2516). The arrays do not change from one
iteration to the next, so the first pass appends each step's compacted
arrays to one flat file with a JSON index, finished atomically, and every
later pass reads them back memory-mapped: after the first iteration a
streamed phase's host work is slicing file-backed pages.

Layout: <cache_dir>/streams/<key>.bin + <key>.idx.json, the JAX
package's, so a store written by either package is read by the other.
An entry names each array's dtype by numpy's name; "bfloat16" (a JAX
store's name for the ml_dtypes type) is read as its uint16 bits, which
`bf16_tensor` makes a torch.bfloat16 tensor, and a torch.bfloat16
tensor given to `put` is written under that name.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(np.uint16 if name == "bfloat16" else name)


def _bytes_and_name(arr):
    """The array's bytes as a contiguous numpy array, and its dtype name."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    arr = np.ascontiguousarray(arr)
    return arr, str(arr.dtype)


def bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    """A "bfloat16" entry's uint16 bits as a torch.bfloat16 tensor (a
    copy: the entry is a read-only page of the store)."""
    return torch.from_numpy(np.array(bits).view(np.int16)).view(
        torch.bfloat16)


class StreamCache:
    """Append-once, memory-map-after store of per-step array bundles."""

    def __init__(self, cache_dir: str, key: str):
        self.dir = os.path.join(cache_dir, "streams")
        self._bin = os.path.join(self.dir, key + ".bin")
        self._idx = os.path.join(self.dir, key + ".idx.json")
        self._entries: Dict[str, list] = {}
        self._fh = None
        self._mm: Optional[np.memmap] = None
        self.building = False
        self.ready = False
        self.refresh()

    def refresh(self) -> bool:
        """Read the index when a finished store is on disk (another
        process may have finished it since); returns `ready`."""
        if self.ready or self.building:
            return self.ready
        if os.path.exists(self._idx) and os.path.exists(self._bin):
            try:
                with open(self._idx) as fh:
                    self._entries = json.load(fh)
                self.ready = True
            except (OSError, ValueError):
                self._entries = {}
        return self.ready

    def begin(self) -> None:
        """Start the building pass (nothing when the store is finished)."""
        if self.ready or self.building:
            return
        os.makedirs(self.dir, exist_ok=True)
        self._fh = open(self._bin + ".tmp", "wb")
        self._entries = {}
        self.building = True

    def put(self, step: int, arrays: Dict[str, np.ndarray]) -> None:
        if not self.building:
            return
        entry = []
        for name, arr in arrays.items():
            arr, dtype = _bytes_and_name(arr)
            off = self._fh.tell()
            arr.tofile(self._fh)
            entry.append([name, dtype, list(arr.shape), off])
        self._entries[str(step)] = entry

    def finish(self) -> None:
        """Finish atomically: a process that stops while building leaves
        no index, so the next one builds again."""
        if not self.building:
            return
        self._fh.close()
        self._fh = None
        os.replace(self._bin + ".tmp", self._bin)
        with open(self._idx + ".tmp", "w") as fh:
            json.dump(self._entries, fh)
        os.replace(self._idx + ".tmp", self._idx)
        self.building = False
        self.ready = True
        self._mm = None

    def get(self, step: int) -> Optional[Dict[str, np.ndarray]]:
        """The step's arrays as views of the memory-mapped store (a
        "bfloat16" array as its uint16 bits), or None while the store is
        not finished."""
        if not self.ready:
            return None
        entry = self._entries.get(str(step))
        if entry is None:
            return None
        if self._mm is None:
            self._mm = np.memmap(self._bin, dtype=np.uint8, mode="r")
        out = {}
        for name, dtype, shape, off in entry:
            dt = _np_dtype(dtype)
            count = int(np.prod(shape)) if shape else 1
            out[name] = np.frombuffer(self._mm, dtype=dt, count=count,
                                      offset=int(off)).reshape(shape)
        return out
