"""Host-side SE(d) helpers (numpy) used by the trajectory export.

Port of the subset of ``score_tpu.utils.matrix`` that the factor-graph
modules and the 3D simulator call; the device-side batched rounding lives in
:mod:`score_tpu_torch.ops.rounding`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "round_to_special_orthogonal",
    "get_quat_from_rotation_matrix",
    "get_rotation_matrix_from_quat",
    "get_rotation_from_transformation_matrix",
    "get_translation_from_transformation_matrix",
]


def _check_square(mat: np.ndarray) -> None:
    assert mat.ndim == 2 and mat.shape[0] == mat.shape[1], f"not square: {mat.shape}"


def _check_rotation_matrix(R: np.ndarray) -> None:
    """Raise unless R is orthogonal with det +1 (to 1e-3)."""
    d = R.shape[0]
    if not np.allclose(R @ R.T, np.eye(d), rtol=1e-3, atol=1e-3):
        raise ValueError(f"R is not orthogonal: R@R.T=\n{R @ R.T}")
    if abs(np.linalg.det(R) - 1.0) >= 1e-3:
        raise ValueError(f"det(R) != 1: {np.linalg.det(R)}")


def round_to_special_orthogonal(mat: np.ndarray) -> np.ndarray:
    """Project a (near-)rotation matrix onto SO(d): U @ Vh from the SVD,
    with the last singular direction flipped if the determinant is
    negative (the host twin of :mod:`score_tpu_torch.ops.rounding`)."""
    mat = np.asarray(mat, dtype=np.float64)
    _check_square(mat)
    d = mat.shape[0]
    U, _, Vh = np.linalg.svd(mat)
    R = U @ Vh
    if np.linalg.det(R) < 0:
        flip = np.ones(d)
        flip[-1] = -1.0
        R = (U * flip) @ Vh
    _check_rotation_matrix(R)
    return R


def get_quat_from_rotation_matrix(mat: np.ndarray) -> np.ndarray:
    """Rotation matrix (2x2 embedded into 3D, or 3x3) -> quaternion
    (qx, qy, qz, qw), scalar-last like scipy."""
    mat = np.asarray(mat, dtype=np.float64)
    if mat.shape == (2, 2):
        R = np.eye(3)
        R[:2, :2] = mat
    else:
        R = mat
    assert R.shape == (3, 3)
    # Shepperd's method (numerically stable branch selection).
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        qw = 0.25 * s
        qx = (R[2, 1] - R[1, 2]) / s
        qy = (R[0, 2] - R[2, 0]) / s
        qz = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2.0
        qw = (R[2, 1] - R[1, 2]) / s
        qx = 0.25 * s
        qy = (R[0, 1] + R[1, 0]) / s
        qz = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2.0
        qw = (R[0, 2] - R[2, 0]) / s
        qx = (R[0, 1] + R[1, 0]) / s
        qy = 0.25 * s
        qz = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2.0
        qw = (R[1, 0] - R[0, 1]) / s
        qx = (R[0, 2] + R[2, 0]) / s
        qy = (R[1, 2] + R[2, 1]) / s
        qz = 0.25 * s
    q = np.array([qx, qy, qz, qw])
    return q / np.linalg.norm(q)


def get_rotation_matrix_from_quat(quat: np.ndarray) -> np.ndarray:
    """Quaternion (qx, qy, qz, qw) -> 3x3 rotation matrix."""
    qx, qy, qz, qw = np.asarray(quat, dtype=np.float64) / np.linalg.norm(quat)
    return np.array(
        [
            [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx**2 + qz**2), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx**2 + qy**2)],
        ]
    )


def get_rotation_from_transformation_matrix(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T)
    _check_square(T)
    d = T.shape[0] - 1
    return T[:d, :d]


def get_translation_from_transformation_matrix(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T)
    _check_square(T)
    d = T.shape[0] - 1
    return T[:d, d]
