"""Model factory: the training strategy from the config (the JAX
package's models/factory.py).

  - mesh_shape     -> ShardedALS over prod(mesh_shape) ranks, which must
                      be the world size: one process without torchrun,
                      or the torchrun world (parallel/sharded_als.py)
  - host_offload_x -> OutOfCoreALS (X in host memory, streamed through
                      the card: the hugewiki out-of-core path)
  - otherwise      -> ALS (single device, in memory)

`mesh_shape` with `host_offload_x` (sharded out-of-core training) raises:
it is not ported yet (ROADMAP A12, sharded out-of-core).
"""

from __future__ import annotations

import math
from typing import Optional

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix

SHARDED_OOC = ("sharded out-of-core training (mesh_shape with "
               "host_offload_x, --out-of-core with --mesh, --x-placement) "
               "is not ported yet (ROADMAP A12, sharded out-of-core)")


def make_model(cfg: ALSConfig, train_csr: CSRMatrix,
               train_csc: Optional[CSRMatrix] = None,
               test_coo: Optional[COOMatrix] = None, device=None):
    if cfg.mesh_shape:
        if cfg.host_offload_x:
            raise NotImplementedError(SHARDED_OOC)
        from cumf_als_tpu_torch.parallel.sharded_als import ShardedALS
        return ShardedALS(cfg, train_csr, train_csc, test_coo,
                          n_devices=math.prod(cfg.mesh_shape), device=device)
    if cfg.host_offload_x:
        from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
        return OutOfCoreALS(cfg, train_csr, train_csc, test_coo,
                            device=device)
    from cumf_als_tpu_torch.models.als import ALS
    return ALS(cfg, train_csr, train_csc, test_coo, device=device)
