"""Unrolled small-block linear algebra (plain PyTorch).

Port of the plain parts of :mod:`score_tpu.solver.smallblocks`. These are
the plain versions of the per-block device functions inside the band
kernels (``ops/csrc/band.cu``: ``chol``, ``tri_lower``, ``tri_upper``):
the CUDA code runs the same left-looking column Cholesky and the same
substitution order, one block per thread.
"""

from __future__ import annotations

import torch

__all__ = ["chol_small", "tri_lower_solve", "tri_upper_solve", "inv_small_spd"]


def chol_small(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of (..., m, m) SPD matrices, unrolled over the static m
    (left-looking column algorithm; every step is a batched vector op)."""
    m = A.shape[-1]
    cols = []
    for j in range(m):
        c = A[..., :, j]
        for k in range(j):
            c = c - cols[k] * cols[k][..., j : j + 1]
        col = c / torch.sqrt(c[..., j : j + 1])
        # zero the strictly-upper part of this column
        col = col * (torch.arange(m, device=A.device) >= j).to(A.dtype)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def tri_lower_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L Y = B with L (..., m, m) lower-triangular and B (..., m, K)."""
    m = L.shape[-1]
    rows = []
    for i in range(m):
        r = B[..., i, :]
        for k in range(i):
            r = r - L[..., i, k : k + 1] * rows[k]
        rows.append(r / L[..., i, i : i + 1])
    return torch.stack(rows, dim=-2)


def tri_upper_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T Y = B (L lower-triangular) by back substitution."""
    m = L.shape[-1]
    rows = [None] * m
    for i in reversed(range(m)):
        r = B[..., i, :]
        for k in range(i + 1, m):
            r = r - L[..., k, i : i + 1] * rows[k]
        rows[i] = r / L[..., i, i : i + 1]
    return torch.stack(rows, dim=-2)


def inv_small_spd(A: torch.Tensor) -> torch.Tensor:
    """Inverse of small SPD matrices via the unrolled Cholesky."""
    m = A.shape[-1]
    L = chol_small(A)
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(A.shape)
    return tri_upper_solve(L, tri_lower_solve(L, eye))
