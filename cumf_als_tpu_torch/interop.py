"""Carry ALS state between the JAX package and this port.

The two packages share config field names and the factor layout (rows
of F floats, padded with zero lanes to f_pad), so a run of one resumes
exactly where a run of the other stands. The JAX side is passed as
plain data (a dict of config fields, numpy factors): this module, like
the rest of the port, imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.models.als import resolve_device


def _pad(arr: np.ndarray, f: int, f_pad: int) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 2 or arr.shape[1] not in (f, f_pad):
        raise ValueError(f"factor of shape {arr.shape}: expected width "
                         f"{f} or {f_pad}")
    if arr.shape[1] == f_pad:
        return arr
    out = np.zeros((arr.shape[0], f_pad), np.float32)
    out[:, :f] = arr
    return out


def from_reference(cfg_fields: dict, x: np.ndarray, theta: np.ndarray,
                   device=None) -> Tuple[ALSConfig, torch.Tensor,
                                         torch.Tensor]:
    """(the port's ALSConfig, padded x, padded theta) from the JAX
    package's state: its ALSConfig as a dict (dataclasses.asdict) and its
    factors as numpy arrays, padded to f_pad or not. Unknown fields
    raise, so a config never loses a setting silently. The factors land
    on `device`, CUDA unless the caller asks for the CPU, as for every
    other entry point (models.als.resolve_device)."""
    names = {f.name for f in dataclasses.fields(ALSConfig)}
    unknown = sorted(set(cfg_fields) - names)
    if unknown:
        raise ValueError(f"fields the port's ALSConfig lacks: {unknown}")
    fields = dict(cfg_fields)
    for k in ("mesh_shape", "mesh_axis_names"):
        if isinstance(fields.get(k), list):
            fields[k] = tuple(fields[k])
    cfg = ALSConfig(**fields)
    dev = resolve_device(device)
    xt = torch.from_numpy(_pad(x, cfg.f, cfg.f_pad)).to(dev)
    tt = torch.from_numpy(_pad(theta, cfg.f, cfg.f_pad)).to(dev)
    return cfg, xt, tt


def to_reference(cfg: ALSConfig, x: torch.Tensor, theta: torch.Tensor
                 ) -> Tuple[dict, np.ndarray, np.ndarray]:
    """The inverse: (config fields as a dict, x, theta as un-padded numpy
    arrays), ready for the JAX package's ALSConfig(**fields) and
    ALS.run(x, theta)."""
    def unpad(t):
        return torch.as_tensor(t)[:, :cfg.f].float().cpu().numpy()
    return dataclasses.asdict(cfg), unpad(x), unpad(theta)
