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
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# kernel name -> the C entry point and its argument types (the entry
# points of K1 and K6 also run pass 1 of their cut on a chunk of few
# rows when given a record buffer; frag_span_solve is its pass 2)
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
KERNELS = {
    "gather_gram_cg": ("cumf_gather_gram_cg",
                       [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP,
                        _I, _I, _I, _F, _I, _F, _VP, _I, _VP]),
    "gather_gram_out": ("cumf_gather_gram_out",
                        [_VP, _I, _VP, _VP, _I, _VP, _I, _VP,
                         _I, _I, _I, _VP]),
    "solve_cg_reg": ("cumf_solve_cg_reg",
                     [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _I,
                      _VP]),
    "solve_cg": ("cumf_solve_cg",
                 [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _I, _VP]),
    "gather_gram_aug_out": ("cumf_gather_gram_aug_out",
                            [_VP, _I, _VP, _VP, _I, _VP, _I,
                             _I, _I, _I, _VP]),
    "solve_cg_aug": ("cumf_solve_cg_aug",
                     [_VP, _I, _VP, _VP, _VP, _VP, _I, _I, _I, _F, _I,
                      _VP]),
    "gather_gram_cg_aug": ("cumf_gather_gram_cg_aug",
                           [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP,
                            _I, _I, _I, _F, _I, _F, _VP, _I, _VP]),
    "gather_gram_cg_wide": ("cumf_gather_gram_cg_wide",
                            [_VP, _I, _VP, _VP, _I, _VP, _VP, _VP, _VP,
                             _I, _I, _I, _F, _I, _F, _VP]),
    "fused_gram_cg_cat": ("cumf_fused_gram_cg_cat",
                          [_VP, _VP, _I, _VP, _I, _VP, _VP, _VP, _VP,
                           _I, _I, _I, _F, _I, _F, _VP]),
    "wide_span_gram": ("cumf_wide_span_gram",
                       [_VP, _I, _VP, _VP, _I, _VP, _VP,
                        _I, _I, _I, _I, _I, _I, _VP]),
    "wide_span_gram_mma": ("cumf_wide_span_gram_mma",
                           [_VP, _VP, _VP, _VP, _I, _VP, _VP,
                            _I, _I, _I, _I, _I, _I, _I, _VP]),
    "wide_span_solve": ("cumf_wide_span_solve",
                        [_VP, _VP, _VP, _VP, _VP,
                         _I, _I, _I, _I, _I, _I, _I, _F, _I, _F, _VP]),
    "gram_span_sum": ("cumf_gram_span_sum",
                      [_VP, _VP, _VP, _I, _VP, _I, _I, _I, _VP]),
    "frag_span_solve": ("cumf_frag_span_solve",
                        [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _F, _I,
                         _F, _VP]),
    # factor widths f = 128 T, T >= 3: the tiled Gram (K2, K5a; pass 1 of
    # K1, K6) and the CG on A in device memory (K3, K4, K5b; pass 2)
    "tile_gram": ("cumf_tile_gram",
                  [_VP, _I, _VP, _VP, _I, _VP, _VP, _I, _VP, _VP,
                   _I, _I, _I, _I, _VP, _I, _VP, _I, _VP]),
    "global_cg": ("cumf_global_cg",
                  [_VP, _I, _VP, _VP, _VP, _VP, _VP, _VP, _VP,
                   _I, _I, _I, _I, _F, _I, _F, _VP]),
}
# query name -> the kernel whose library holds it, its C entry point and
# its argument types (a query launches nothing and counts no launch)
QUERIES = {
    f"{name}_blocks_per_sm": (name, f"cumf_{name}_blocks_per_sm",
                              [_I, _I, _VP])
    for name in ("solve_cg_reg", "solve_cg", "solve_cg_aug")}
HEADERS = ("common.cuh", "wide.cuh", "gram_mma.cuh", "frag_cg.cuh",
           "bulk_cg.cuh", "wide_gram_mma.cuh", "split_gram_mma.cuh",
           "wide_split_mma.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_loaded: Dict[str, ctypes._CFuncPtr] = {}
# kernel name -> what nvcc printed at its last build in this process
BUILD_LOG: Dict[str, str] = {}
# (time.monotonic() when it finished, kernel name) of each library built
# in this process, in order (with a warm _build/ it stays empty)
BUILT: List[Tuple[float, str]] = []


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
                 for s in (f"{name}.cu", *HEADERS))
    return os.path.getmtime(lib) < newest


def build(names: Optional[Iterable[str]] = None, force: bool = False,
          ptxas_info: bool = False) -> float:
    """Compile the named kernels (default: all) in parallel; returns the
    wall seconds. With `ptxas_info`, nvcc runs with ``-Xptxas -v`` and
    BUILD_LOG[name] holds each entry function's registers, spills and
    shared memory."""
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
        cmd = [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if ptxas_info else []),
               "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, tmp, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, _lib_path(name))
        BUILT.append((time.monotonic(), name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.monotonic() - t0


def load(name: str):
    """The C entry point of kernel `name`, or of query `name` in its
    kernel's library, built first if needed."""
    fn = _loaded.get(name)
    if fn is None:
        lib, symbol, argtypes = (name, *KERNELS[name]) if name in KERNELS \
            else QUERIES[name]
        build([lib])
        fn = getattr(ctypes.CDLL(_lib_path(lib)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
