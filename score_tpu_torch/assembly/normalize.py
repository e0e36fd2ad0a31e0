"""Problem normalization: solve in scaled translation units.

GOATS-grade problems mix O(100) translations/distances with O(1) rotation
entries and O(1e5) precisions, spreading the KKT spectrum over ~5 orders
of magnitude before the interior-point scaling even starts. Substituting
t' = t / s (one global translation scale s) is an exact, cone-pattern-
preserving reparameterization:

  odometry:  k ||t_j - t_i - R_i tm||^2      -> (k s^2) ||t'_j - t'_i - R_i (tm/s)||^2
  range SOCP: p (d - dist)^2, ||t_i-t_j||<=d -> (p s^2)(d' - dist/s)^2, SOC unchanged
  range QCQP: p ||t_i - t_j - dist u||^2     -> (p s^2) ||t'_i - t'_j - (dist/s) u||^2
  landmark prior: p ||l - v||^2              -> (p s^2) ||l' - v/s||^2

Objective values are EXACTLY preserved (weights absorb s^2), both KKT
backends work unchanged (coefficient patterns intact), and only the
recovered translations/distances need multiplying back by s.
"""

from __future__ import annotations

import copy
from typing import Tuple

import numpy as np

from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.measurements import FGRangeMeasurement, PoseMeasurement2D, PoseMeasurement3D
from score_tpu_torch.fg.priors import LandmarkPrior2D, LandmarkPrior3D
from score_tpu_torch.fg.solver_utils import SolverResults

__all__ = ["translation_scale", "normalize_factor_graph", "unscale_results"]


def translation_scale(fg: FactorGraphData) -> float:
    """A representative translation magnitude: the mean range distance
    (ranges dominate the translation geometry), floored at 1."""
    if fg.range_measurements:
        s = float(np.mean([abs(m.dist) for m in fg.range_measurements]))
    else:
        pts = [
            np.asarray(p.true_position[: fg.dimension])
            for c in fg.pose_variables
            for p in c
        ]
        s = float(np.ptp(np.asarray(pts))) if pts else 1.0
    return max(s, 1.0)


def normalize_factor_graph(fg: FactorGraphData) -> Tuple[FactorGraphData, float]:
    """Return (scaled copy, scale s). Ground-truth fields are left
    untouched (they never enter the cost)."""
    s = translation_scale(fg)
    if s == 1.0:
        return fg, 1.0
    out = copy.copy(fg)
    s2 = s * s

    def scale_pose_meas(m):
        if isinstance(m, PoseMeasurement2D):
            return PoseMeasurement2D(
                m.base_pose, m.to_pose, m.x / s, m.y / s, m.theta,
                m.translation_precision * s2, m.rotation_precision,
                m.timestamp,
            )
        return PoseMeasurement3D(
            m.base_pose, m.to_pose,
            np.asarray(m.translation) / s, m.rotation,
            m.translation_precision * s2, m.rotation_precision, m.timestamp,
        )

    out.odom_measurements = [
        [scale_pose_meas(m) for m in chain] for chain in fg.odom_measurements
    ]
    out.loop_closure_measurements = [
        scale_pose_meas(m) for m in fg.loop_closure_measurements
    ]
    out.range_measurements = [
        FGRangeMeasurement(
            tuple(m.association), m.dist / s, m.stddev / s, m.timestamp
        )
        for m in fg.range_measurements
    ]

    def scale_lm_prior(p):
        cls = LandmarkPrior2D if len(p.position) == 2 else LandmarkPrior3D
        return cls(
            p.name,
            tuple(np.asarray(p.position) / s),
            p.translation_precision * s2,
            p.timestamp,
        )

    out.landmark_priors = [scale_lm_prior(p) for p in fg.landmark_priors]
    # world bounds follow the translation scale (used by random init)
    for attr in ("x_min", "x_max", "y_min", "y_max", "z_min", "z_max"):
        v = getattr(fg, attr)
        if v is not None:
            setattr(out, attr, float(v) / s)
    return out, s


def unscale_results(results: SolverResults, s: float) -> SolverResults:
    """Multiply recovered translations/landmarks (and SOCP distance
    variables) back by the scale, in place; rotations (and QCQP unit
    directions) are scale-free."""
    if s == 1.0:
        return results
    d = results.variables.dim
    for name, T in results.variables.poses.items():
        T = np.array(T)  # writable copy
        T[:d, d] *= s
        results.variables.poses[name] = T
    for name, p in results.variables.landmarks.items():
        results.variables.landmarks[name] = np.asarray(p) * s
    for key, v in results.variables.distances.items():
        v = np.asarray(v)
        if v.shape == (1,):  # SOCP scalar distance
            results.variables.distances[key] = v * s
    return results
