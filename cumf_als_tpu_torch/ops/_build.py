"""Build and load the hand-written CUDA kernels.

Each source under ``cumf_als_tpu_torch/csrc/`` compiles on its own into
a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o _build/lib<name>.so csrc/<name>.cu

and is loaded with ``ctypes``. Nothing builds or loads at import: the
first launch on a CUDA tensor calls ``load``, which builds what is
missing or older than its sources. ``build`` compiles every kernel at
once, one ``nvcc`` process per source, all started together.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> the C entry point and its argument types
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "gather_gram_cg": ("cumf_gather_gram_cg",
                       [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP,
                        _I, _I, _I, _F, _I, _F, _VP]),
    "gather_gram_out": ("cumf_gather_gram_out",
                        [_VP, _I, _VP, _VP, _I, _VP, _I, _VP,
                         _I, _I, _I, _VP]),
    "solve_cg_reg": ("cumf_solve_cg_reg",
                     [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _VP]),
    "solve_cg": ("cumf_solve_cg",
                 [_VP, _I, _VP, _VP, _VP, _I, _I, _I, _F, _VP]),
    "gather_gram_aug_out": ("cumf_gather_gram_aug_out",
                            [_VP, _I, _VP, _VP, _I, _VP, _I,
                             _I, _I, _I, _VP]),
    "solve_cg_aug": ("cumf_solve_cg_aug",
                     [_VP, _I, _VP, _VP, _VP, _I, _I, _I, _F, _VP]),
    "gather_gram_cg_aug": ("cumf_gather_gram_cg_aug",
                           [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP,
                            _I, _I, _I, _F, _I, _F, _VP]),
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return path


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not os.path.exists(lib):
        return True
    newest = max(os.path.getmtime(os.path.join(CSRC, s))
                 for s in (f"{name}.cu", "common.cuh"))
    return os.path.getmtime(lib) < newest


def build(names: Optional[Iterable[str]] = None,
          force: bool = False) -> float:
    """Compile the named kernels (default: all) in parallel; returns the
    wall seconds."""
    names = list(KERNELS if names is None else names)
    todo = [n for n in names if force or _stale(n)]
    t0 = time.monotonic()
    if not todo:
        return 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        tmp = _lib_path(name) + f".{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str):
    """The C entry point of kernel `name`, built first if needed."""
    fn = _loaded.get(name)
    if fn is None:
        build([name])
        symbol, argtypes = KERNELS[name]
        fn = getattr(ctypes.CDLL(_lib_path(name)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
