"""Small-block linear algebra over arbitrary leading batch dimensions.

Port of :mod:`score_tpu.solver.smallblocks` (the unrolled block routines).
A float32 batch on the card (ndim >= 3) goes through the hand-written
block kernels of :mod:`score_tpu_torch.ops.blocks`, as the JAX package
routes f32 batches into its Pallas kernels; everything else (CPU tensors,
float64 anywhere) takes the plain unrolled versions, which are those
kernels' twins. float64 on the card stays on the plain path, as the JAX
package keeps f64 on its unrolled jnp path. :func:`chol_solve` (forward
then back substitution, L L^T X = B) is one fused kernel launch on that
route: ``inv_small_spd`` and the f32 band's ``_dinv`` go through it. The f64 band kernels
(``ops/csrc/band.cu``: ``chol``, ``tri_lower``, ``tri_upper``) run the
same left-looking column Cholesky and substitution order inside their
threads.
"""

from __future__ import annotations

import torch

from score_tpu_torch.ops import blocks

__all__ = ["chol_small", "tri_lower_solve", "tri_upper_solve", "chol_solve", "inv_small_spd"]


def _use_kernel(a: torch.Tensor) -> bool:
    return a.device.type == "cuda" and a.dtype == torch.float32 and a.dim() >= 3


def chol_small(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of (..., m, m) SPD matrices (left-looking column order,
    zero strictly-upper triangle). The kernel reads a view such as the f32
    band's odd rows ``D[:, 1::2]`` where it lies; other layouts are copied
    first."""
    if _use_kernel(A):
        m = A.shape[-1]
        A2 = A.reshape(-1, m, m)
        if not blocks.block_chol_reads(A2):
            A2 = A2.contiguous()
        return blocks.block_chol(A2).reshape(A.shape)
    return blocks.block_chol_plain(A)


def _blocks(L: torch.Tensor, B: torch.Tensor):
    """L as contiguous (M, m, m) and B as (M, m, K), a view where B's
    strides allow: the substitution kernels read B through its strides."""
    m, K = L.shape[-1], B.shape[-1]
    return L.reshape(-1, m, m).contiguous(), B.reshape(-1, m, K)


def tri_lower_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L Y = B with L (..., m, m) lower-triangular and B (..., m, K)."""
    if _use_kernel(L):
        return blocks.block_tri_lower_solve(*_blocks(L, B)).reshape(B.shape)
    return blocks.block_tri_lower_solve_plain(L, B)


def tri_upper_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T Y = B (L lower-triangular) by back substitution."""
    return blocks.block_tri_upper_solve_plain(L, B)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L L^T X = B for the Cholesky factor L (..., m, m) and B
    (..., m, K): one kernel launch for a float32 batch on the card, the
    two plain substitutions everywhere else."""
    if _use_kernel(L):
        return blocks.block_chol_solve(*_blocks(L, B)).reshape(B.shape)
    return tri_upper_solve(L, tri_lower_solve(L, B))


def inv_small_spd(A: torch.Tensor) -> torch.Tensor:
    """Inverse of small SPD matrices via the Cholesky factor."""
    m = A.shape[-1]
    eye = torch.eye(m, dtype=A.dtype, device=A.device).expand(A.shape)
    return chol_solve(chol_small(A), eye)
