"""Model factory: the training strategy from the config (the
single-device half of the JAX package's models/factory.py).

  - host_offload_x -> OutOfCoreALS (X in host memory, streamed through
                      the card: the hugewiki out-of-core path)
  - otherwise      -> ALS (single device, in memory)

A `mesh_shape` (sharded training, with or without host offload) raises:
it is not ported yet (ROADMAP A12).
"""

from __future__ import annotations

from typing import Optional

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix


def make_model(cfg: ALSConfig, train_csr: CSRMatrix,
               train_csc: Optional[CSRMatrix] = None,
               test_coo: Optional[COOMatrix] = None, device=None):
    if cfg.mesh_shape:
        raise NotImplementedError(
            "sharded training is not ported yet (ROADMAP A12)")
    if cfg.host_offload_x:
        from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
        return OutOfCoreALS(cfg, train_csr, train_csc, test_coo,
                            device=device)
    from cumf_als_tpu_torch.models.als import ALS
    return ALS(cfg, train_csr, train_csc, test_coo, device=device)
