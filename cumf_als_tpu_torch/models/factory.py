"""Model factory: the training strategy from the config (the JAX
package's models/factory.py).

  - mesh_shape + host_offload_x -> ShardedOutOfCoreALS (the full
                      hugewiki program: sharded ratings, each rank's X
                      shard in host memory, or on its card with
                      x_placement="device"; parallel/sharded_ooc.py)
  - mesh_shape     -> ShardedALS over prod(mesh_shape) ranks, which must
                      be the world size: one process without torchrun,
                      or the torchrun world (parallel/sharded_als.py)
  - host_offload_x -> OutOfCoreALS (X in host memory, streamed through
                      the card: the hugewiki out-of-core path)
  - otherwise      -> ALS (single device, in memory)
"""

from __future__ import annotations

import math
from typing import Optional

from cumf_als_tpu_torch.config import ALSConfig
from cumf_als_tpu_torch.utils.io import COOMatrix, CSRMatrix


def make_model(cfg: ALSConfig, train_csr: CSRMatrix,
               train_csc: Optional[CSRMatrix] = None,
               test_coo: Optional[COOMatrix] = None, device=None):
    if cfg.mesh_shape:
        n_dev = math.prod(cfg.mesh_shape)
        if cfg.host_offload_x:
            from cumf_als_tpu_torch.parallel.sharded_ooc import \
                ShardedOutOfCoreALS
            return ShardedOutOfCoreALS(cfg, train_csr, train_csc, test_coo,
                                       n_devices=n_dev, device=device)
        from cumf_als_tpu_torch.parallel.sharded_als import ShardedALS
        return ShardedALS(cfg, train_csr, train_csc, test_coo,
                          n_devices=n_dev, device=device)
    if cfg.host_offload_x:
        from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
        return OutOfCoreALS(cfg, train_csr, train_csc, test_coo,
                            device=device)
    from cumf_als_tpu_torch.models.als import ALS
    return ALS(cfg, train_csr, train_csc, test_coo, device=device)
