"""The communication layer of the port: torch.distributed in place of the
JAX package's jax.sharding.Mesh (its parallel/mesh.py).

The reference's multi-GPU backend (CUDA P2P enablement, the anchor-GPU
gather and cublasSaxpy reduction, D2D broadcast, one OpenMP thread per
GPU; reference hugewiki/common.h:19-36, hugewiki.cu:2703-2745) becomes
one process per rank, each holding one `Mesh`: its rank, the world size,
its device and the process group. The collectives the sharded model
needs are `Mesh.all_reduce_sum` (the partial Grams of the theta phase,
the test error) and `Mesh.all_gather` (the rows of X, `unshard_x`).

A world of one rank needs no process group: its collectives are the
identity. Under `torchrun` the world is read from the environment
(`current_mesh`). The backend is the caller's, or "nccl" for a card and
"gloo" for the CPU; it is never switched after a failure. Gloo takes a
card tensor through host memory.

`spawn` starts N ranks on a free local port for the tests and for
chip_smoke.py; a rank runs a function of this package (a function of a
test module would make every rank import the test module, and with it
JAX).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass
class Mesh:
    """One rank's view of the 1-D mesh over axis DATA_AXIS."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[Any] = None   # None: a world of one, no process group

    @property
    def backend(self) -> Optional[str]:
        return None if self.group is None else dist.get_backend(self.group)

    def _via_host(self, t: torch.Tensor) -> bool:
        return self.backend == "gloo" and t.device.type == "cuda"

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks, in place; returns t. Every rank gets
        the same bits."""
        if self.group is None:
            return t
        if self._via_host(t):
            h = t.cpu()
            dist.all_reduce(h, group=self.group)
            t.copy_(h)
        else:
            dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(world_size, *t.shape): every rank's t, in rank order."""
        if self.group is None:
            return t[None]
        src = t.contiguous().cpu() if self._via_host(t) else t.contiguous()
        outs = [torch.empty_like(src) for _ in range(self.world_size)]
        dist.all_gather(outs, src, group=self.group)
        return torch.stack(outs).to(t.device)

    def require_world(self, n: int) -> "Mesh":
        """self, when the world has n ranks; raises otherwise."""
        if n != self.world_size:
            raise ValueError(f"{n} rank(s) asked for, but the world has "
                             f"{self.world_size} rank(s): run one process "
                             f"a rank (torchrun --nproc-per-node {n})")
        return self

    def barrier(self) -> None:
        """Returns on each rank once every rank has called it."""
        if self.group is not None:
            one = torch.ones(1, device=self.device)
            self.all_reduce_sum(one)
            one.item()   # waits for the collective, on a card too


def _rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: `device` as named, "cuda" (or None) meaning
    cuda:{LOCAL_RANK}. Raises when it is a card and none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' (CLI: --device cpu) to run on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None) -> Mesh:
    """Join (or start) the process group and return this rank's Mesh.
    Without arguments it reads the torchrun environment (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT). The default backend is
    "nccl" for a card and "gloo" for the CPU."""
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None \
        else world_size
    rank = _env_int("RANK", 0) if rank is None else rank
    dev = _rank_device(device, _env_int("LOCAL_RANK", rank))
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://",
                                world_size=world_size, rank=rank)
    if (dist.get_world_size(), dist.get_rank()) != (world_size, rank):
        raise RuntimeError(
            f"the process group has rank {dist.get_rank()} of "
            f"{dist.get_world_size()}, asked for {rank} of {world_size}")
    return Mesh(rank=rank, world_size=world_size, device=dev,
                group=dist.group.WORLD)


def current_mesh(device=None) -> Mesh:
    """This process's Mesh: over the process group when one exists, or
    the torchrun world when the environment names more than one rank,
    else a world of one on `device` (CUDA unless "cpu")."""
    if dist.is_initialized():
        dev = _rank_device(device, _env_int("LOCAL_RANK",
                                            dist.get_rank()))
        return Mesh(rank=dist.get_rank(), world_size=dist.get_world_size(),
                    device=dev, group=dist.group.WORLD)
    if _env_int("WORLD_SIZE", 1) > 1:
        return init_distributed(device=device)
    return Mesh(rank=0, world_size=1, device=_rank_device(device, 0))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world_size, port, backend, device, fn, args, out):
    """A spawned rank: the torchrun environment, the group, fn(mesh,
    *args); its result (or its traceback) goes to `out`."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    if torch.device(device or "cuda").type == "cpu":
        # the ranks share the host's cores: oversubscribed, the CPU
        # kernels of two ranks run tens of times slower
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    try:
        mesh = init_distributed(backend, f"tcp://localhost:{port}",
                                world_size, rank, device)
        try:
            result = fn(mesh, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except Exception:
        out.put((rank, False, traceback.format_exc()))
        raise


def spawn(world_size: int, fn: Callable, *args, backend: Optional[str] = None,
          device=None, timeout: float = 600.0) -> List[Any]:
    """Run fn(mesh, *args) on `world_size` new processes (the "spawn"
    start method), one rank each, joined on a free local port; returns
    the ranks' results in rank order. `fn` and `args` are pickled, so
    `fn` is a module-level function of this package. Rank r runs on
    cuda:r unless `device` names one for every rank ("cpu", or one card);
    without a card it raises unless given device="cpu". Raises when a
    rank fails or the ranks pass `timeout` seconds; no rank outlives the
    call."""
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, port, backend, device, fn,
                               args, out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world_size:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks passed {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    return [results[r] for r in range(world_size)]
