"""Initial-value construction for warm-started solves.

Port of :mod:`score_tpu.assembly.initialization` (host-side numpy, the
same arithmetic in the same order: for the same ``rng`` it gives the same
x0 bit for bit). The RANDOM/ZERO/ODOM/GT techniques produce an x0 used to
warm-start the interior-point method. Only the gauge pin is read from the
problem's tensors, copied to the host once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from score_tpu_torch.assembly.conic import (
    ConicProblem,
    SOCP_RELAXATION,
    VariableIndex,
)
from score_tpu_torch.fg.factor_graph import FactorGraphData

RANDOM_INIT = "random"
ZERO_INIT = "zero"
ODOM_INIT = "odom"
GT_INIT = "gt"
ACCEPTABLE_INIT = (RANDOM_INIT, ZERO_INIT, ODOM_INIT, GT_INIT)

__all__ = [
    "build_initial_x",
    "RANDOM_INIT",
    "ZERO_INIT",
    "ODOM_INIT",
    "GT_INIT",
    "ACCEPTABLE_INIT",
]


def _set_pose(x, idx: VariableIndex, p: int, R: np.ndarray, t: np.ndarray):
    d = idx.dim
    base = p * idx.pose_block
    for c in range(d):
        x[base + c * d : base + (c + 1) * d] = R[:, c]
    x[base + d * d : base + d * d + d] = t


def build_initial_x(
    fg: FactorGraphData,
    problem: ConicProblem,
    idx: VariableIndex,
    technique: str,
    rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """Construct a full solution-vector initialization.

    - "odom": dead-reckon each chain from the identity by composing the
      odometry measurements; landmarks at the centroid of the connected
      (dead-reckoned) pose translations; distances consistent with x.
    - "gt": ground-truth poses/landmarks from the factor graph.
    - "random": uniform translations within the world bounds, random
      rotations.
    - "zero": all zeros except the pinned pose.

    The gauge pin is enforced afterwards regardless of technique.
    """
    if technique not in ACCEPTABLE_INIT:
        raise ValueError(
            f"init technique {technique!r} not in {ACCEPTABLE_INIT}"
        )
    rng = rng or np.random.default_rng(0)
    d = idx.dim
    n = problem.n
    x = np.zeros(n)

    pose_index = {nm: i for i, nm in enumerate(idx.pose_names)}

    if technique == ZERO_INIT:
        pass
    elif technique == RANDOM_INIT:
        x_min, x_max, y_min, y_max = fg.bounds
        for p in range(idx.num_poses):
            theta = rng.uniform(0, 2 * np.pi)
            c, s = np.cos(theta), np.sin(theta)
            R = np.array([[c, -s], [s, c]]) if d == 2 else np.eye(3)
            t = np.array(
                [rng.uniform(x_min, x_max), rng.uniform(y_min, y_max)]
            )[:d]
            if d == 3:
                t = np.concatenate([t, [0.0]])[:3]
            _set_pose(x, idx, p, R, t)
        for l in range(idx.num_landmarks):
            t = np.array(
                [rng.uniform(x_min, x_max), rng.uniform(y_min, y_max)]
            )[:d]
            x[idx.landmark_cols(l)] = t
    elif technique == GT_INIT:
        for chain in fg.pose_variables:
            for p_var in chain:
                p = pose_index[p_var.name]
                _set_pose(
                    x, idx, p,
                    np.asarray(p_var.rotation_matrix),
                    np.asarray(p_var.true_position[:d]),
                )
        for l, lm in enumerate(fg.landmark_variables):
            x[idx.landmark_cols(l)] = np.asarray(lm.true_position[:d])
    elif technique == ODOM_INIT:
        # dead-reckon each chain from identity
        translations = {}
        for c_i, chain in enumerate(fg.pose_variables):
            if not chain:
                continue
            T = np.eye(d + 1)
            meas_by_base = {
                m.base_pose: m for m in (fg.odom_measurements[c_i]
                                         if c_i < len(fg.odom_measurements)
                                         else [])
            }
            for k, p_var in enumerate(chain):
                p = pose_index[p_var.name]
                _set_pose(x, idx, p, T[:d, :d], T[:d, d])
                translations[p_var.name] = T[:d, d].copy()
                m = meas_by_base.get(p_var.name)
                if m is not None and k + 1 < len(chain):
                    T = T @ np.asarray(m.transformation_matrix)
        # landmarks: centroid of connected pose translations
        lm_accum = {nm: [] for nm in idx.landmark_names}
        for r in fg.range_measurements:
            for a, b in ((r.first_key, r.second_key),
                         (r.second_key, r.first_key)):
                if b in lm_accum and a in translations:
                    lm_accum[b].append(translations[a])
        for l, nm in enumerate(idx.landmark_names):
            pts = lm_accum.get(nm)
            x[idx.landmark_cols(l)] = (
                np.mean(pts, axis=0) if pts else np.zeros(d)
            )

    # distances consistent with the (initial) translations
    xpad = np.concatenate([x, [0.0]])
    for m, meas in enumerate(fg.range_measurements):
        ta = xpad[np.asarray(idx.translation_cols(meas.first_key))]
        tb = xpad[np.asarray(idx.translation_cols(meas.second_key))]
        diff = ta - tb
        nrm = float(np.linalg.norm(diff))
        cols = idx.dist_cols(m)
        if idx.relaxation == SOCP_RELAXATION:
            x[cols[0]] = max(nrm, float(meas.dist))
        else:
            x[cols] = diff / nrm if nrm > 1e-9 else np.zeros(d)

    # gauge pin always wins
    x[problem.pin_idx.cpu().numpy()] = problem.pin_val.cpu().numpy()
    return x
