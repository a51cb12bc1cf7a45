"""On-disk cache of built plans (the JAX package's utils/plan_cache.py).

A plan is stored under a key made from a fingerprint of the data set,
the builder's kind and its parameters; a later process loads it
memory-mapped instead of building it again. The on-disk format and the
keys are the JAX package's, so a cache directory written by either
package is read by the other.

Layout per entry:  <cache_dir>/<key>/meta.json + <name>.npy

Stored and loaded: the update, panel, batched-panel and split plans,
the CSC view (`cached_transpose`), the eager sharded plans of ShardedALS
and ShardedOutOfCoreALS (a ShardedRowPlan, a ReducePlan, AlignedSteps),
and the lazy ones of ShardedOutOfCoreALS: a lazy ShardedRowPlan keeps
each chunk's global row lists, lazy AlignedSteps at one rank each step's
subrow descriptors, and on load both re-bind to the caller's matrix
(`csr_for_lazy`). Lazy AlignedSteps over two or more ranks are not
stored: each process builds them, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import List, Optional

import numpy as np

from cumf_als_tpu_torch.ops.tiling import (BatchedPanelPlan,
                                           LazyPanelChunk, PanelChunk,
                                           PanelPlan, PlanChunk, RowBatch,
                                           SplitChunk, SplitPlan,
                                           UpdatePlan)
from cumf_als_tpu_torch.parallel.plan import (AlignedPanelChunk,
                                              AlignedSteps,
                                              LazyAlignedPanelChunk,
                                              LazyShardedChunk, ReduceBlock,
                                              ReducePlan, ShardedChunk,
                                              ShardedRowPlan)
from cumf_als_tpu_torch.utils.io import CSRMatrix, transpose_csr

_VERSION = 4  # the JAX package's layout version: keys must equal its own

def dataset_fingerprint(csr: CSRMatrix) -> str:
    """Content fingerprint: the shape and nnz, strided samples and the
    head and tail of each array. The strides skip most pages, so a
    memory-mapped data set stays cheap to fingerprint."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.asarray(
        [csr.num_rows, csr.num_cols, csr.nnz], np.int64).tobytes())

    def _sample(arr: np.ndarray, k: int = 4096) -> None:
        n = arr.shape[0]
        if n == 0:
            return
        step = max(1, n // k)
        h.update(np.ascontiguousarray(arr[::step][:k]).tobytes())
        h.update(np.ascontiguousarray(arr[:1024]).tobytes())
        h.update(np.ascontiguousarray(arr[-1024:]).tobytes())

    _sample(np.asarray(csr.indptr))
    _sample(csr.indices)
    _sample(csr.data)
    return h.hexdigest()


def plan_key(kind: str, fingerprint: str, params: dict) -> str:
    blob = json.dumps({"v": _VERSION, "kind": kind, "fp": fingerprint,
                       "params": params}, sort_keys=True)
    return kind + "-" + hashlib.blake2b(
        blob.encode(), digest_size=12).hexdigest()


def _cat(parts, dtype) -> np.ndarray:
    return np.concatenate(parts).astype(dtype, copy=False) if parts \
        else np.zeros(0, dtype)


def _pack_chunks(chunks) -> dict:
    """All chunks' arrays in flat buffers, with a manifest of (panel,
    width, rows) per chunk (panel -1 for a PlanChunk)."""
    meta = np.asarray(
        [(getattr(c, "panel", -1), c.width, c.rows.shape[0])
         for c in chunks], np.int64).reshape(len(chunks), 3)
    return {
        "chunk_meta": meta,
        "rows": _cat([c.rows for c in chunks], np.int32),
        "nnz": _cat([c.nnz for c in chunks], np.int32),
        "cols": _cat([c.cols.reshape(-1) for c in chunks], np.int32),
        "vals": _cat([c.vals.reshape(-1) for c in chunks], np.float32),
    }


def _unpack_chunks(arrays: dict, cls) -> List:
    meta = np.asarray(arrays["chunk_meta"])
    rows, nnz = arrays["rows"], arrays["nnz"]
    cols, vals = arrays["cols"], arrays["vals"]
    out, ro, co = [], 0, 0
    for panel, width, r in meta:
        panel, width, r = int(panel), int(width), int(r)
        kw = dict(width=width,
                  rows=rows[ro:ro + r], nnz=nnz[ro:ro + r],
                  cols=cols[co:co + r * width].reshape(r, width),
                  vals=vals[co:co + r * width].reshape(r, width))
        if cls is PanelChunk:
            kw["panel"] = panel
        out.append(cls(**kw))
        ro += r
        co += r * width
    return out


def _pack_dev_chunks(chunks) -> dict:
    """Chunks whose arrays carry a leading rank axis (rows, nnz (n_dev,
    R); cols, vals (n_dev, R, P)) in flat buffers, with a manifest of
    (panel, width, n_dev, R) per chunk (panel -1 for a ShardedChunk)."""
    meta = np.asarray(
        [(getattr(c, "panel", -1), c.width, c.rows.shape[0],
          c.rows.shape[1]) for c in chunks], np.int64).reshape(len(chunks), 4)
    return {
        "chunk_meta": meta,
        "rows": _cat([c.rows.reshape(-1) for c in chunks], np.int32),
        "nnz": _cat([c.nnz.reshape(-1) for c in chunks], np.int32),
        "cols": _cat([c.cols.reshape(-1) for c in chunks], np.int32),
        "vals": _cat([c.vals.reshape(-1) for c in chunks], np.float32),
    }


def _unpack_dev_chunks(arrays: dict, make) -> List:
    """make(panel, width, rows, nnz, cols, vals) -> one chunk."""
    meta = np.asarray(arrays["chunk_meta"])
    rows, nnz = arrays["rows"], arrays["nnz"]
    cols, vals = arrays["cols"], arrays["vals"]
    out, ro, co = [], 0, 0
    for panel, width, n_dev, r in meta:
        panel, width, n_dev, r = int(panel), int(width), int(n_dev), int(r)
        out.append(make(
            panel, width,
            np.asarray(rows[ro:ro + n_dev * r]).reshape(n_dev, r),
            np.asarray(nnz[ro:ro + n_dev * r]).reshape(n_dev, r),
            cols[co:co + n_dev * r * width].reshape(n_dev, r, width),
            vals[co:co + n_dev * r * width].reshape(n_dev, r, width)))
        ro += n_dev * r
        co += n_dev * r * width
    return out


def _write_entry(path: str, meta: dict, arrays: dict) -> None:
    """Atomic write: stage into a temporary directory, rename into
    place."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent)
    try:
        for name, arr in arrays.items():
            np.save(os.path.join(tmp, name + ".npy"),
                    np.ascontiguousarray(arr))
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        os.rename(tmp, path)
    except OSError:
        shutil.rmtree(tmp, ignore_errors=True)


def _read_entry(path: str):
    meta_path = os.path.join(path, "meta.json")
    if not os.path.isdir(path) or not os.path.exists(meta_path):
        return None, None
    with open(meta_path) as fh:
        meta = json.load(fh)
    arrays = {}
    for fn in os.listdir(path):
        if fn.endswith(".npy"):
            arrays[fn[:-4]] = np.load(os.path.join(path, fn),
                                      mmap_mode="r")
    return meta, arrays


def _save_lazy_sharded_row(path: str, plan: ShardedRowPlan) -> None:
    """A lazy row plan: each chunk's per-rank global row lists, flat."""
    chunks = plan.chunks
    meta = {"type": "sharded_row_lazy", "n_dev": int(plan.n_dev),
            "m": int(plan.m), "m_loc": int(plan.m_loc),
            "num_cols": int(plan.num_cols),
            "chunk_meta": [[int(c.width), int(c._r)] +
                           [int(g.size) for g in c._grows] for c in chunks]}
    _write_entry(path, meta, {
        "global_ids": plan.global_ids,
        "grows": _cat([g for c in chunks for g in c._grows], np.int64),
        "rows": _cat([c.rows.reshape(-1) for c in chunks], np.int32),
        "nnz": _cat([c.nnz.reshape(-1) for c in chunks], np.int32)})


def _load_lazy_sharded_row(meta: dict, arrays: dict,
                           csr: CSRMatrix) -> ShardedRowPlan:
    n_dev = meta["n_dev"]
    chunks, go, ro = [], 0, 0
    for cm in meta["chunk_meta"]:
        width, r = int(cm[0]), int(cm[1])
        ch = object.__new__(LazyShardedChunk)
        ch.width, ch._csr, ch._r = width, csr, r
        ch._grows = []
        for d in range(n_dev):
            k = int(cm[2 + d])
            ch._grows.append(np.asarray(arrays["grows"][go:go + k]))
            go += k
        ch.rows = np.asarray(arrays["rows"][ro:ro + n_dev * r]).reshape(
            n_dev, r)
        ch.nnz = np.asarray(arrays["nnz"][ro:ro + n_dev * r]).reshape(
            n_dev, r)
        ro += n_dev * r
        chunks.append(ch)
    return ShardedRowPlan(
        n_dev=n_dev, m=meta["m"], m_loc=meta["m_loc"],
        global_ids=np.asarray(arrays["global_ids"]),
        num_cols=meta["num_cols"], chunks=chunks)


def _save_lazy_aligned_steps(path: str, plan: AlignedSteps) -> None:
    """Lazy steps whose one member each views one shared matrix (one
    rank: the CSC itself), as subrow descriptors; the loader re-binds
    them to the caller's matrix. Anything else is not stored."""
    steps = plan.steps
    if any(not hasattr(st, "_per_dev") for st in steps):
        return   # eager and lazy steps mixed
    mats = {id(ch._csr) for st in steps for ch in st._per_dev
            if ch is not None}
    if len({len(st._per_dev) for st in steps} | {1}) != 1 or len(mats) > 1:
        return   # lazy steps over two or more ranks
    mem = [st._per_dev[0] for st in steps]
    meta = {"type": "aligned_steps_lazy", "n_panels": int(plan.n_panels),
            "sentinel": int(steps[0]._sentinel) if steps else 0,
            "panel_size": int(steps[0]._panel_size) if steps else 0,
            "chunk_meta": [[int(st.panel), int(st.width), int(st._r),
                            int(c._sub_off.shape[0]), int(c._base)]
                           for st, c in zip(steps, mem)]}
    _write_entry(path, meta, {
        "sub_off": _cat([c._sub_off for c in mem], np.int64),
        "sub_len": _cat([c._sub_len for c in mem], np.int32),
        "sub_rows": _cat([c._sub_rows for c in mem], np.int32)})


def _load_lazy_aligned_steps(meta: dict, arrays: dict,
                             csr: CSRMatrix) -> AlignedSteps:
    sent, psize = meta["sentinel"], meta["panel_size"]
    steps, so = [], 0
    for panel, width, r, k, base in meta["chunk_meta"]:
        panel, width, r, k, base = (int(panel), int(width), int(r), int(k),
                                    int(base))
        ch = LazyPanelChunk(
            csr, panel, width, np.asarray(arrays["sub_off"][so:so + k]),
            np.asarray(arrays["sub_len"][so:so + k]),
            np.asarray(arrays["sub_rows"][so:so + k]), r, base, psize)
        so += k
        steps.append(LazyAlignedPanelChunk(panel, width, [ch], r, sent,
                                           psize))
    return AlignedSteps(steps=steps, n_panels=meta["n_panels"])


def _save_sharded(path: str, plan) -> None:
    """The sharded kinds, eager and lazy, in the JAX package's layout."""
    if isinstance(plan, ShardedRowPlan):
        if any(not hasattr(c, "cols") for c in plan.chunks):
            _save_lazy_sharded_row(path, plan)
            return
        arrays = _pack_dev_chunks(plan.chunks)
        arrays["global_ids"] = plan.global_ids
        _write_entry(path, {"type": "sharded_row", "n_dev": plan.n_dev,
                            "m": plan.m, "m_loc": plan.m_loc,
                            "num_cols": plan.num_cols}, arrays)
    elif isinstance(plan, ReducePlan):
        blocks = plan.blocks
        meta = {"type": "reduce", "n_dev": plan.n_dev, "n": plan.n,
                "m_loc": plan.m_loc,
                "block_meta": [(b.width, int(b.rows.shape[0]),
                                int(b.cols.shape[0])) for b in blocks]}
        _write_entry(path, meta, {
            "rows": _cat([b.rows for b in blocks], np.int32),
            "nnz_total": _cat([b.nnz_total for b in blocks], np.int32),
            "nnz_local": _cat([b.nnz_local.reshape(-1) for b in blocks],
                              np.int32),
            "cols": _cat([b.cols.reshape(-1) for b in blocks], np.int32),
            "vals": _cat([b.vals.reshape(-1) for b in blocks],
                         np.float32)})
    elif any(not hasattr(c, "cols") for c in plan.steps):
        _save_lazy_aligned_steps(path, plan)
    else:
        _write_entry(path, {"type": "aligned_steps",
                            "n_panels": plan.n_panels},
                     _pack_dev_chunks(plan.steps))


def _load_sharded(meta: dict, arrays: dict):
    kind = meta["type"]
    if kind == "sharded_row":
        chunks = _unpack_dev_chunks(
            arrays, lambda panel, width, rows, nnz, cols, vals:
            ShardedChunk(width=width, rows=rows, nnz=nnz, cols=cols,
                         vals=vals))
        return ShardedRowPlan(
            n_dev=meta["n_dev"], m=meta["m"], m_loc=meta["m_loc"],
            global_ids=np.asarray(arrays["global_ids"]),
            num_cols=meta["num_cols"], chunks=chunks)
    if kind == "reduce":
        n_dev = meta["n_dev"]
        blocks, ro, fo = [], 0, 0
        for width, c, nd in meta["block_meta"]:
            width, c, nd = int(width), int(c), int(nd)
            blocks.append(ReduceBlock(
                width=width, rows=np.asarray(arrays["rows"][ro:ro + c]),
                nnz_local=np.asarray(arrays["nnz_local"][
                    ro * n_dev:(ro + c) * n_dev]).reshape(nd, c),
                nnz_total=np.asarray(arrays["nnz_total"][ro:ro + c]),
                cols=arrays["cols"][fo:fo + nd * c * width].reshape(
                    nd, c, width),
                vals=arrays["vals"][fo:fo + nd * c * width].reshape(
                    nd, c, width)))
            ro += c
            fo += nd * c * width
        return ReducePlan(n_dev=n_dev, n=meta["n"], m_loc=meta["m_loc"],
                          blocks=blocks)
    steps = _unpack_dev_chunks(
        arrays, lambda panel, width, rows, nnz, cols, vals:
        AlignedPanelChunk(panel, width, rows, nnz, cols, vals))
    return AlignedSteps(steps=steps, n_panels=meta["n_panels"])


def save_plan(cache_dir: str, key: str, plan) -> None:
    path = os.path.join(cache_dir, key)
    if isinstance(plan, (ShardedRowPlan, ReducePlan, AlignedSteps)):
        _save_sharded(path, plan)
    elif isinstance(plan, SplitPlan):
        meta = {"type": "split", "num_rows": plan.num_rows,
                "num_cols": plan.num_cols, "part_size": plan.part_size,
                "n_parts": plan.n_parts, "true_nnz": plan.true_nnz,
                "padded_nnz": plan.padded_nnz,
                "chunk_meta": [
                    [int(c.rows.shape[0]), list(c.parts),
                     list(c.widths)] for c in plan.chunks]}
        _write_entry(path, meta, {
            "perm": plan.perm,
            "rows": _cat([c.rows for c in plan.chunks], np.int32),
            "nnz": _cat([c.nnz for c in plan.chunks], np.int32),
            "cols": _cat([b.reshape(-1) for c in plan.chunks
                          for b in c.cols], np.int32),
            "vals": _cat([c.vals.reshape(-1) for c in plan.chunks],
                         np.float32)})
    elif isinstance(plan, UpdatePlan):
        meta = {"type": "update", "num_rows": plan.num_rows,
                "num_cols": plan.num_cols, "true_nnz": plan.true_nnz,
                "padded_nnz": plan.padded_nnz}
        _write_entry(path, meta, _pack_chunks(plan.chunks))
    elif isinstance(plan, PanelPlan):
        meta = {"type": "panel", "num_rows": plan.num_rows,
                "num_cols": plan.num_cols, "panel_size": plan.panel_size,
                "n_panels": plan.n_panels, "true_nnz": plan.true_nnz,
                "padded_nnz": plan.padded_nnz}
        arrays = _pack_chunks(plan.chunks)
        arrays["row_nnz"] = plan.row_nnz
        _write_entry(path, meta, arrays)
    elif isinstance(plan, BatchedPanelPlan):
        meta = {"type": "batched_panel", "num_rows": plan.num_rows,
                "num_cols": plan.num_cols, "panel_size": plan.panel_size,
                "batch_rows": plan.batch_rows, "true_nnz": plan.true_nnz,
                "padded_nnz": plan.padded_nnz,
                "batches": [
                    {"n_chunks": len(b.plan.chunks),
                     "num_rows": b.plan.num_rows,
                     "true_nnz": b.plan.true_nnz,
                     "padded_nnz": b.plan.padded_nnz,
                     "n_panels": b.plan.n_panels}
                    for b in plan.batches]}
        arrays = _pack_chunks([c for b in plan.batches
                               for c in b.plan.chunks])
        arrays["global_ids"] = _cat([b.global_ids for b in plan.batches],
                                    np.int32)
        arrays["batch_row_nnz"] = _cat([b.row_nnz for b in plan.batches],
                                       np.int32)
        arrays["batch_plan_row_nnz"] = _cat(
            [b.plan.row_nnz for b in plan.batches], np.int32)
        _write_entry(path, meta, arrays)
    else:
        raise TypeError(f"unknown plan type {type(plan)!r}")


def load_plan(cache_dir: str, key: str, csr: Optional[CSRMatrix] = None):
    """The plan stored under `key`, or None when there is none. A lazy
    entry re-binds to `csr` (the matrix its chunks read: the CSR of a
    row plan, the CSC of theta steps), and is None without it."""
    meta, arrays = _read_entry(os.path.join(cache_dir, key))
    if meta is None:
        return None
    kind = meta["type"]
    if kind == "sharded_row_lazy":
        return None if csr is None else \
            _load_lazy_sharded_row(meta, arrays, csr)
    if kind == "aligned_steps_lazy":
        return None if csr is None else \
            _load_lazy_aligned_steps(meta, arrays, csr)
    if kind in ("sharded_row", "reduce", "aligned_steps"):
        return _load_sharded(meta, arrays)
    if kind == "split":
        chunks, ro, co, vo = [], 0, 0, 0
        for r, parts, widths in meta["chunk_meta"]:
            r = int(r)
            cols = []
            for w in widths:
                w = int(w)
                cols.append(arrays["cols"][co:co + r * w].reshape(r, w))
                co += r * w
            wsum = int(sum(widths))
            chunks.append(SplitChunk(
                parts=tuple(int(p) for p in parts),
                widths=tuple(int(w) for w in widths),
                rows=np.asarray(arrays["rows"][ro:ro + r]),
                nnz=np.asarray(arrays["nnz"][ro:ro + r]),
                cols=tuple(cols),
                vals=arrays["vals"][vo:vo + r * wsum].reshape(r, wsum)))
            ro += r
            vo += r * wsum
        return SplitPlan(num_rows=meta["num_rows"],
                         num_cols=meta["num_cols"],
                         part_size=meta["part_size"],
                         n_parts=meta["n_parts"],
                         perm=np.asarray(arrays["perm"]),
                         chunks=chunks, true_nnz=meta["true_nnz"],
                         padded_nnz=meta["padded_nnz"])
    if kind == "update":
        return UpdatePlan(num_rows=meta["num_rows"],
                          num_cols=meta["num_cols"],
                          chunks=_unpack_chunks(arrays, PlanChunk),
                          true_nnz=meta["true_nnz"],
                          padded_nnz=meta["padded_nnz"])
    if kind == "panel":
        return PanelPlan(num_rows=meta["num_rows"],
                         num_cols=meta["num_cols"],
                         panel_size=meta["panel_size"],
                         n_panels=meta["n_panels"],
                         chunks=_unpack_chunks(arrays, PanelChunk),
                         row_nnz=np.asarray(arrays["row_nnz"]),
                         true_nnz=meta["true_nnz"],
                         padded_nnz=meta["padded_nnz"])
    if kind == "batched_panel":
        chunks = _unpack_chunks(arrays, PanelChunk)
        batches, ci, off, nr_off = [], 0, 0, 0
        batch_rows = meta["batch_rows"]
        for b in meta["batches"]:
            sub = PanelPlan(
                num_rows=b["num_rows"], num_cols=meta["num_cols"],
                panel_size=meta["panel_size"], n_panels=b["n_panels"],
                chunks=chunks[ci:ci + b["n_chunks"]],
                row_nnz=np.asarray(
                    arrays["batch_plan_row_nnz"]
                    [nr_off:nr_off + b["num_rows"]]),
                true_nnz=b["true_nnz"], padded_nnz=b["padded_nnz"])
            batches.append(RowBatch(
                global_ids=np.asarray(
                    arrays["global_ids"][off:off + batch_rows]),
                row_nnz=np.asarray(
                    arrays["batch_row_nnz"][off:off + batch_rows]),
                plan=sub))
            ci += b["n_chunks"]
            off += batch_rows
            nr_off += b["num_rows"]
        return BatchedPanelPlan(
            num_rows=meta["num_rows"], num_cols=meta["num_cols"],
            panel_size=meta["panel_size"], batch_rows=batch_rows,
            batches=batches, true_nnz=meta["true_nnz"],
            padded_nnz=meta["padded_nnz"])
    raise ValueError(f"unknown plan entry type {kind!r}")


def cached_transpose(cache_dir: Optional[str], csr: CSRMatrix) -> CSRMatrix:
    """transpose_csr memoized on disk (the CSC view is a function of the
    data set alone and costs a counting sort over every rating). The
    result is memory-mapped from the cache."""
    if not cache_dir:
        return transpose_csr(csr)
    path = os.path.join(cache_dir,
                        plan_key("csc", dataset_fingerprint(csr), {}))
    meta, arrays = _read_entry(path)
    if meta is None:
        csc = transpose_csr(csr)
        try:
            _write_entry(path, {"type": "csc", "num_rows": csc.num_rows,
                                "num_cols": csc.num_cols},
                         {"indptr": np.asarray(csc.indptr),
                          "indices": csc.indices, "data": csc.data})
        except Exception:   # caching is best-effort
            return csc
        # reopened memory-mapped: the pages stay file-backed
        meta, arrays = _read_entry(path)
        if meta is None:
            return csc
    return CSRMatrix(indptr=np.asarray(arrays["indptr"]),
                     indices=arrays["indices"], data=arrays["data"],
                     num_rows=meta["num_rows"], num_cols=meta["num_cols"])


def cached_build(cache_dir: Optional[str], kind: str, csr: CSRMatrix,
                 params: dict, build_fn,
                 csr_for_lazy: Optional[CSRMatrix] = None):
    """build_fn() memoized on disk under (kind, the data set of `csr`,
    params); cache_dir None builds every time. A corrupt or unreadable
    entry is rebuilt. `csr_for_lazy`: the matrix a lazy entry's chunks
    re-bind to (the CSR for a row plan, the CSC for theta steps)."""
    if not cache_dir:
        return build_fn()
    key = plan_key(kind, dataset_fingerprint(csr), params)
    try:
        plan = load_plan(cache_dir, key, csr=csr_for_lazy)
    except Exception:
        plan = None   # corrupt or stale entry: rebuild
    if plan is not None:
        return plan
    plan = build_fn()
    try:
        save_plan(cache_dir, key, plan)
    except Exception:
        pass   # caching is best-effort
    return plan
