"""Batched projection of relaxed rotation blocks onto SO(d).

Port of :mod:`score_tpu.ops.rounding`: per pose, SVD-project the d x d
rotation block (U @ Vh, with the last singular direction flipped when
det < 0), keep the translation and re-homogenize; one batched f64
``torch.linalg.svd`` over all poses on the solve's device.
"""

from __future__ import annotations

import torch

__all__ = ["round_rotations_batched", "extract_pose_matrices", "homogenize_batched"]


def round_rotations_batched(R: torch.Tensor) -> torch.Tensor:
    """Project a batch (..., d, d) of matrices onto SO(d)."""
    U, _, Vh = torch.linalg.svd(R, full_matrices=False)
    det = torch.linalg.det(U @ Vh)
    # scale the last column of U by sign(det) to force det = +1
    signs = torch.where(det < 0, -1.0, 1.0).to(R.dtype)
    U = torch.cat([U[..., :, :-1], U[..., :, -1:] * signs[..., None, None]], dim=-1)
    return U @ Vh


def extract_pose_matrices(x: torch.Tensor, num_poses: int, dim: int) -> torch.Tensor:
    """Per-pose [R | t] blocks (column-major pose layout of
    assembly.conic.VariableIndex) from the flat solution: (num_poses, d, d+1)."""
    D = dim * (dim + 1)
    blocks = x[: num_poses * D].reshape(num_poses, dim + 1, dim)
    return blocks.transpose(-1, -2)


def homogenize_batched(Rt: torch.Tensor) -> torch.Tensor:
    """(N, d, d+1) [R|t] -> (N, d+1, d+1) homogeneous transforms with the
    rotation block rounded to SO(d)."""
    N, d, _ = Rt.shape
    T = Rt.new_zeros((N, d + 1, d + 1))
    T[:, :d, :d] = round_rotations_batched(Rt[:, :, :d])
    T[:, :d, d] = Rt[:, :, d]
    T[:, d, d] = 1.0
    return T
