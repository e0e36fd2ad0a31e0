"""Host-side matrix / SE(d) geometry utilities (numpy).

A copy of :mod:`score_tpu.utils.matrix`: SVD rounding to SO(d) with the
determinant fix, theta and quaternion conversions, random transforms and
perturbations, and the ``_check_*`` validators. The device-side batched
rounding lives in :mod:`score_tpu_torch.ops.rounding`.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

__all__ = [
    "round_to_special_orthogonal",
    "get_theta_from_rotation_matrix",
    "get_theta_from_rotation_matrix_so_projection",
    "get_quat_from_rotation_matrix",
    "get_rotation_matrix_from_theta",
    "get_rotation_matrix_from_quat",
    "get_rotation_from_transformation_matrix",
    "get_theta_from_transformation_matrix",
    "get_quat_from_transformation_matrix",
    "get_translation_from_transformation_matrix",
    "get_random_vector",
    "get_random_rotation_matrix",
    "get_random_transformation_matrix",
    "make_transformation_matrix",
    "make_transformation_matrix_from_theta",
    "apply_transformation_matrix_perturbation",
    "get_matrix_determinant",
    "print_eigvals",
    "print_matrix_blocked",
]


# --------------------------------------------------------------------- #
# Rounding / conversions
# --------------------------------------------------------------------- #


def round_to_special_orthogonal(mat: np.ndarray) -> np.ndarray:
    """Project a (near-)rotation matrix onto SO(d): U @ Vh from the SVD, with
    the last singular direction flipped if the determinant is negative
    (semantics parity: matrix_utils.py:59-79 — this rounding defines the
    relaxed-to-feasible bridge and must match for downstream GTSAM parity).
    """
    mat = np.asarray(mat, dtype=np.float64)
    _check_square(mat)
    d = mat.shape[0]
    U, _, Vh = np.linalg.svd(mat)
    R = U @ Vh
    if np.linalg.det(R) < 0:
        flip = np.ones(d)
        flip[-1] = -1.0
        R = (U * flip) @ Vh
    _check_rotation_matrix(R, assert_test=True)
    return R


def get_theta_from_rotation_matrix(mat: np.ndarray) -> float:
    mat = np.asarray(mat)
    assert mat.shape == (2, 2), f"expected 2x2 rotation, got {mat.shape}"
    return float(np.arctan2(mat[1, 0], mat[0, 0]))


def get_theta_from_rotation_matrix_so_projection(mat: np.ndarray) -> float:
    return get_theta_from_rotation_matrix(round_to_special_orthogonal(mat))


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


def get_rotation_matrix_from_theta(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def get_rotation_from_transformation_matrix(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T)
    _check_square(T)
    d = T.shape[0] - 1
    return T[:d, :d]


def get_theta_from_transformation_matrix(T: np.ndarray) -> float:
    assert np.asarray(T).shape == (3, 3), "theta extraction requires SE(2)"
    return get_theta_from_rotation_matrix(get_rotation_from_transformation_matrix(T))


def get_quat_from_transformation_matrix(T: np.ndarray) -> np.ndarray:
    return get_quat_from_rotation_matrix(get_rotation_from_transformation_matrix(T))


def get_translation_from_transformation_matrix(T: np.ndarray) -> np.ndarray:
    T = np.asarray(T)
    _check_square(T)
    d = T.shape[0] - 1
    return T[:d, d]


def get_matrix_determinant(mat: np.ndarray) -> float:
    _check_square(np.asarray(mat))
    return float(np.linalg.det(mat))


# --------------------------------------------------------------------- #
# Random sampling / construction
# --------------------------------------------------------------------- #


def get_random_vector(
    dim: int,
    bounds: Optional[List[float]] = None,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    if bounds is None:
        return rng.random(dim)
    assert len(bounds) == 2 * dim, "bounds must be (min, max) per coordinate"
    lo = np.array(bounds[0::2], dtype=np.float64)
    hi = np.array(bounds[1::2], dtype=np.float64)
    return rng.uniform(lo, hi)


def get_random_rotation_matrix(
    dim: int = 2, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    if dim == 2:
        return get_rotation_matrix_from_theta(rng.uniform(0.0, 2 * np.pi))
    # Uniform (Haar) random rotation via QR of a Gaussian matrix.
    A = rng.standard_normal((dim, dim))
    Q, R = np.linalg.qr(A)
    Q = Q * np.sign(np.diag(R))
    if np.linalg.det(Q) < 0:
        Q[:, -1] *= -1.0
    return Q


def get_random_transformation_matrix(
    dim: int = 2, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    R = get_random_rotation_matrix(dim, rng)
    t = get_random_vector(dim, rng=rng)
    return make_transformation_matrix(R, t)


def make_transformation_matrix(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    R = np.asarray(R, dtype=np.float64)
    t = np.asarray(t, dtype=np.float64).reshape(-1)
    _check_rotation_matrix(R, assert_test=True)
    d = R.shape[0]
    assert t.shape == (d,), f"translation must have dim {d}"
    T = np.eye(d + 1)
    T[:d, :d] = R
    T[:d, d] = t
    return T


def make_transformation_matrix_from_theta(
    theta: float, translation: np.ndarray
) -> np.ndarray:
    return make_transformation_matrix(get_rotation_matrix_from_theta(theta), translation)


def apply_transformation_matrix_perturbation(
    T: np.ndarray,
    perturb_magnitude: float,
    perturb_rotation: float,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Right-multiply T by a random SE(2) perturbation with translation of
    norm ``perturb_magnitude`` in a uniform direction and rotation of
    ``±perturb_rotation`` (semantics parity: matrix_utils.py:11-43)."""
    rng = rng or np.random.default_rng()
    _check_transformation_matrix(T)
    direction = rng.uniform(0.0, 2 * np.pi)
    dt = perturb_magnitude * np.array([np.cos(direction), np.sin(direction)])
    dtheta = float(rng.choice([-1.0, 1.0])) * perturb_rotation
    P = make_transformation_matrix_from_theta(dtheta, dt)
    return np.asarray(T) @ P


# --------------------------------------------------------------------- #
# Validators (inline contracts, parity: matrix_utils.py:293-389)
# --------------------------------------------------------------------- #


def _check_square(mat: np.ndarray) -> None:
    assert mat.shape[0] == mat.shape[1], f"matrix must be square, got {mat.shape}"


def _check_symmetric(mat: np.ndarray, tol: float = 1e-8) -> None:
    assert np.allclose(mat, mat.T, atol=tol), "matrix must be symmetric"


def _check_psd(mat: np.ndarray, tol: float = 1e-8) -> None:
    eigs = np.linalg.eigvalsh(np.asarray(mat))
    assert eigs.min() >= -tol, f"matrix not PSD: min eigenvalue {eigs.min()}"


def _check_is_laplacian(L: np.ndarray) -> None:
    L = np.asarray(L)
    _check_symmetric(L)
    _check_psd(L)
    ones = np.ones(L.shape[0])
    assert np.allclose(L @ ones, 0.0), "Laplacian must annihilate the ones vector"


def _check_rotation_matrix(R: np.ndarray, assert_test: bool = False) -> None:
    R = np.asarray(R)
    d = R.shape[0]
    orthogonal = np.allclose(R @ R.T, np.eye(d), rtol=1e-3, atol=1e-3)
    det_ok = abs(np.linalg.det(R) - 1.0) < 1e-3
    if not orthogonal:
        if assert_test:
            raise ValueError(f"R is not orthogonal: R@R.T=\n{R @ R.T}")
        logger.warning("R is not orthogonal: %s", R @ R.T)
    if not det_ok:
        if assert_test:
            raise ValueError(f"det(R) != 1: {np.linalg.det(R)}")
        logger.warning("det(R) != 1: %s", np.linalg.det(R))


def _check_transformation_matrix(
    T: np.ndarray, assert_test: bool = True, dim: Optional[int] = None
) -> None:
    T = np.asarray(T)
    _check_square(T)
    md = T.shape[0]
    if dim is not None:
        assert md == dim + 1, f"matrix dim {md} != dim+1 {dim + 1}"
    assert md in (3, 4), f"transformation matrix must be 3x3 or 4x4, got {T.shape}"
    _check_rotation_matrix(T[:-1, :-1], assert_test=assert_test)
    bottom_expected = np.zeros(md)
    bottom_expected[-1] = 1.0
    assert np.allclose(T[-1, :], bottom_expected), (
        f"bottom row is {T[-1, :]}, expected {bottom_expected}"
    )


# --------------------------------------------------------------------- #
# Debug printers (parity: matrix_utils.py:395-444 — ad-hoc spectrum and
# pose-block inspection helpers used while developing relaxations)
# --------------------------------------------------------------------- #


def print_eigvals(
    M: np.ndarray,
    name: Optional[str] = None,
    print_eigvec: bool = False,
    symmetric: bool = True,
) -> np.ndarray:
    """Print (and return, sorted ascending) the eigenvalues of ``M``;
    optionally the eigenvectors too."""
    M = np.asarray(M)
    if symmetric:
        eigvals, eigvecs = np.linalg.eigh(M)
    else:
        eigvals, eigvecs = np.linalg.eig(M)
    order = np.argsort(eigvals)
    eigvals, eigvecs = eigvals[order], eigvecs[:, order]
    if name is not None:
        print(name)
    print(f"eigenvalues\n{eigvals}")
    if print_eigvec:
        print(f"eigenvectors\n{eigvecs}")
    return eigvals


def print_matrix_blocked(mat: np.ndarray, block: int = 2, fmt: str = "g") -> None:
    """Pretty-print a matrix with separators every ``block`` rows/columns
    (pose blocks are d-periodic; the reference used a fixed 2)."""
    mat = np.asarray(mat)
    widths = [
        max(len(("{:" + fmt + "}").format(x)) for x in col) for col in mat.T
    ]
    rule = "-" * (sum(widths) + 3 * len(widths))
    for j, row in enumerate(mat):
        if j % block == 0:
            print(rule)
        cells = [
            ("{:" + str(widths[i]) + fmt + "}").format(y)
            + (" |" if (i + 1) % block == 0 else "  ")
            for i, y in enumerate(row)
        ]
        print(" ".join(cells))
    print(rule)
