"""Trajectory evaluation metrics: absolute trajectory error (ATE) and
relative pose error (RPE).

A copy of :mod:`score_tpu.utils.metrics` (numpy) over the port's
factor-graph types: the standard definitions, reported against the ground
truth a factor graph stores.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.solver_utils import SolverResults

__all__ = ["umeyama_alignment", "compute_ate", "ate_against_ground_truth", "compute_rpe"]


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = False
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares rigid alignment: find (R, t, s) minimizing
    ||dst - (s R src + t)||^2. Returns (R, t, s)."""
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    assert src.shape == dst.shape
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / src.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(cov.shape[0])
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[-1, -1] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var = (xs**2).sum() / src.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def compute_ate(
    est: np.ndarray, gt: np.ndarray, align: bool = True
) -> Dict[str, float]:
    """RMSE/mean/median/max of translation error after optional rigid
    alignment (SE(d) Umeyama, no scale)."""
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    assert est.shape == gt.shape, f"{est.shape} vs {gt.shape}"
    if align:
        R, t, _ = umeyama_alignment(est, gt)
        est = est @ R.T + t
    err = np.linalg.norm(est - gt, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "median": float(np.median(err)),
        "max": float(err.max()),
    }


def ate_against_ground_truth(
    results: SolverResults,
    data: FactorGraphData,
    align: bool = True,
) -> Dict[str, Dict[str, float]]:
    """Per-chain ATE of the solved trajectory against the factor graph's
    stored ground truth."""
    out = {}
    poses_dict = data.pose_variables_dict
    d = data.dimension
    for chain in results.pose_chain_names or []:
        if not chain:
            continue
        est = np.array(
            [np.asarray(results.poses[n])[:d, d] for n in chain]
        )
        gt = np.array([poses_dict[n].true_position[:d] for n in chain])
        out[chain[0][0]] = compute_ate(est, gt, align=align)
    return out


def compute_rpe(
    est: np.ndarray, gt: np.ndarray, delta: int = 1
) -> Dict[str, float]:
    """Relative pose (translation) error over index gaps of ``delta``."""
    est = np.asarray(est, dtype=np.float64)
    gt = np.asarray(gt, dtype=np.float64)
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "max": float(err.max()),
    }
