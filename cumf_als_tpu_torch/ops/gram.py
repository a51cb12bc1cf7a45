"""Gram-matrix + RHS formation in plain torch (the XLA route's
ops/gram.py of the JAX package):

    G = table[cols]                       (R, P, f)   gather
    A = einsum('rpf,rpg->rfg', G, G)      (R, f, f)   in f32
    b = einsum('rp,rpf->rf', vals, G)     (R, f)      in f32
"""

from __future__ import annotations

import torch

from cumf_als_tpu_torch.ops.precision import full_f32


def extend_table(table: torch.Tensor) -> torch.Tensor:
    """Append one zero row, so padded gather ids (== num_rows) read zeros
    and add nothing to A or b."""
    return torch.cat([table, table.new_zeros((1, table.shape[1]))], dim=0)


def gram_rhs(table_ext: torch.Tensor, cols: torch.Tensor,
             vals: torch.Tensor, nnz: torch.Tensor, lam: float,
             factor_dtype: str = "f32", gram_dtype: str = "f32"):
    """(A, b) for one chunk: A_r = sum_p g g^T + (nnz_r*lam + [nnz_r == 0]) I,
    b_r = sum_p v g. The bf16 cast of the table (factor_dtype) comes
    before the gather, the bf16 cast of A (gram_dtype) after the
    diagonal is added, as in the JAX package. The sums are full float32
    whatever TF32 setting the caller chose (`full_f32`)."""
    r, p = cols.shape
    f = table_ext.shape[1]
    if factor_dtype == "bf16":
        table_ext = table_ext.to(torch.bfloat16)
    g = table_ext.index_select(0, cols.reshape(-1).long()).reshape(r, p, f)
    g = g.float()
    with full_f32():
        a = torch.einsum("rpf,rpg->rfg", g, g)
        b = torch.einsum("rp,rpf->rf", vals.float(), g)
    nnzf = nnz.float()
    diag = nnzf * lam + (nnzf == 0).float()
    a = a + diag[:, None, None] * torch.eye(f, dtype=torch.float32,
                                            device=a.device)
    if gram_dtype == "bf16":
        a = a.to(torch.bfloat16)
    return a, b
