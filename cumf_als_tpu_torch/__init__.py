"""cumf_als_tpu_torch: ALS matrix factorization on PyTorch and CUDA.

The port of the JAX package `cumf_als_tpu` to one NVIDIA H100. The host
code is plain PyTorch and numpy; the kernels of the main path are CUDA
C++ written for Hopper (csrc/), built at first use. The package imports
nothing of JAX and nothing of `cumf_als_tpu`.
"""

from cumf_als_tpu_torch.config import ALSConfig, ML10M, NETFLIX
from cumf_als_tpu_torch.models.als import ALS, ALSResult, do_als
from cumf_als_tpu_torch.models.factory import make_model
from cumf_als_tpu_torch.models.out_of_core import OutOfCoreALS
from cumf_als_tpu_torch.utils.io import (COOMatrix, CSRMatrix, coo_to_csr,
                                         load_csc_as_csr, load_csr,
                                         load_test_coo, transpose_csr,
                                         write_dataset)

__version__ = "0.1.0"

__all__ = [
    "ALS", "ALSConfig", "ALSResult", "COOMatrix", "CSRMatrix", "ML10M",
    "NETFLIX", "OutOfCoreALS", "coo_to_csr", "do_als", "load_csc_as_csr",
    "load_csr", "load_test_coo", "make_model", "transpose_csr",
    "write_dataset",
]
