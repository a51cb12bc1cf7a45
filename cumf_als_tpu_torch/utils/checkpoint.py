"""Checkpoint / resume: a per-iteration .npz of (X, theta, iteration)
plus a meta.json with the config fingerprint. The format is the JAX
package's, so each package reads the other's checkpoints."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np


def _fingerprint(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    return {k: d[k] for k in ("m", "n", "f", "lam", "solver", "cg_iters")}


def save_checkpoint(ckpt_dir: str, iteration: int, x: np.ndarray,
                    theta: np.ndarray, cfg) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"ckpt_{iteration:06d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, x=x, theta=theta, iteration=np.int64(iteration))
    os.replace(tmp, path)
    with open(os.path.join(ckpt_dir, "meta.json"), "w") as fh:
        json.dump({"latest": iteration, "config": _fingerprint(cfg)}, fh)
    return path


def latest_checkpoint(ckpt_dir: str) -> Optional[int]:
    meta = os.path.join(ckpt_dir, "meta.json")
    if not os.path.exists(meta):
        return None
    with open(meta) as fh:
        return int(json.load(fh)["latest"])


def load_checkpoint(ckpt_dir: str, iteration: Optional[int] = None,
                    cfg=None) -> Tuple[np.ndarray, np.ndarray, int]:
    if iteration is None:
        iteration = latest_checkpoint(ckpt_dir)
        if iteration is None:
            raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    if cfg is not None:
        with open(os.path.join(ckpt_dir, "meta.json")) as fh:
            stored = json.load(fh)["config"]
        if stored != _fingerprint(cfg):
            raise ValueError(
                f"checkpoint config mismatch: {stored} vs "
                f"{_fingerprint(cfg)}")
    with np.load(os.path.join(ckpt_dir, f"ckpt_{iteration:06d}.npz")) as data:
        return data["x"], data["theta"], int(data["iteration"])
