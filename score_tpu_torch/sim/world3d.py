"""Synthetic 3D (SE(3)) range-SLAM world generator.

Port of :mod:`score_tpu.sim.world3d` (numpy only, no jax): smooth 3D
trajectories (random-walk rotations around a nominal forward motion) with
landmark range measurements and noisy SE(3) odometry. The same parameters
and seed give the reference's factor graph, record for record. It builds
the 3D instances of ``chip_smoke.py`` (12 x 12 band blocks) on a machine
without jax.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.measurements import FGRangeMeasurement, PoseMeasurement3D
from score_tpu_torch.fg.variables import LandmarkVariable3D, PoseVariable3D
from score_tpu_torch.utils.matrix import round_to_special_orthogonal

__all__ = ["World3DParams", "simulate_3d_world"]


@dataclasses.dataclass(frozen=True)
class World3DParams:
    num_robots: int = 1
    num_poses_per_robot: int = 100
    num_landmarks: int = 4
    world_size: float = 30.0  # landmarks sampled in [0, world_size]^3
    step_length: float = 1.0
    turn_scale: float = 0.25  # random-walk rotation magnitude per step
    odom_translation_stddev: float = 0.02
    odom_rotation_stddev: float = 0.005
    range_stddev: float = 0.3
    range_measure_prob: float = 0.3
    range_sensing_radius: Optional[float] = None  # None = unlimited
    seed: int = 0


def _random_small_rotation(rng: np.random.Generator, scale: float) -> np.ndarray:
    """A rotation near the identity: project I + scale * skew-ish noise."""
    A = rng.standard_normal((3, 3))
    return round_to_special_orthogonal(np.eye(3) + scale * (A - A.T) / 2.0)


def simulate_3d_world(params: World3DParams) -> FactorGraphData:
    rng = np.random.default_rng(params.seed)
    fg = FactorGraphData(dimension=3)

    landmarks = params.world_size * rng.random((params.num_landmarks, 3))
    for li in range(params.num_landmarks):
        fg.add_landmark_variable(
            LandmarkVariable3D(f"L{li}", tuple(landmarks[li]))
        )

    tp = 1.0 / max(params.odom_translation_stddev**2, 1e-12)
    rp = 1.0 / max(params.odom_rotation_stddev**2, 1e-12)
    rprec = 1.0 / max(params.range_stddev**2, 1e-12)

    for r in range(params.num_robots):
        letter = chr(ord("A") + r)
        R = round_to_special_orthogonal(
            np.eye(3) + 0.5 * rng.standard_normal((3, 3))
        )
        t = params.world_size * rng.random(3)
        poses = []
        for i in range(params.num_poses_per_robot):
            fg.add_pose_variable(
                PoseVariable3D(f"{letter}{i}", tuple(t), R.copy(), float(i)),
                chain_idx=r,
            )
            poses.append((R.copy(), t.copy()))
            if i < params.num_poses_per_robot - 1:
                dR = _random_small_rotation(rng, params.turn_scale)
                t = t + R @ np.array([params.step_length, 0.0, 0.0])
                R = R @ dR

        for i in range(params.num_poses_per_robot - 1):
            Ri, ti = poses[i]
            Rj, tj = poses[i + 1]
            rel_t = Ri.T @ (tj - ti) + params.odom_translation_stddev * (
                rng.standard_normal(3)
            )
            rel_R = round_to_special_orthogonal(
                Ri.T @ Rj
                + params.odom_rotation_stddev * rng.standard_normal((3, 3))
            )
            fg.add_odom_measurement(
                PoseMeasurement3D(
                    f"{letter}{i}", f"{letter}{i+1}", rel_t, rel_R,
                    tp, rp, float(i),
                ),
                chain_idx=r,
            )

        for i in range(params.num_poses_per_robot):
            _, ti = poses[i]
            for li in range(params.num_landmarks):
                dist = float(np.linalg.norm(landmarks[li] - ti))
                if (
                    params.range_sensing_radius is not None
                    and dist > params.range_sensing_radius
                ):
                    continue
                if rng.random() < params.range_measure_prob:
                    noisy = max(dist + params.range_stddev * rng.standard_normal(), 0.1)
                    fg.add_range_measurement(
                        FGRangeMeasurement(
                            (f"{letter}{i}", f"L{li}"),
                            noisy,
                            params.range_stddev,
                            float(i),
                        )
                    )
    return fg
