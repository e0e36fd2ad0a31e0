"""Manhattan-world multi-robot range-SLAM simulator.

The reference repo ships a 4-robot Manhattan dataset and shows a 20-robot
animation but contains no generator (README.md:10;
SURVEY.md §6 — "must be regenerated by a Manhattan-world simulator"). This
module is that generator: robots random-walk on a grid, collecting noisy
odometry and range measurements to landmarks and to each other.

Measurement noise model mirrors the shipped data: odometry as noisy relative
SE(2) transforms with translation/rotation precisions, ranges as noisy
distances with a fixed stddev.
"""

from __future__ import annotations

import dataclasses
import string
from typing import List, Optional, Tuple

import numpy as np

from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.measurements import FGRangeMeasurement, PoseMeasurement2D
from score_tpu_torch.fg.variables import LandmarkVariable2D, PoseVariable2D

__all__ = [
    "ManhattanWorldParams",
    "simulate_manhattan_world",
    "resample_measurements",
]

# 'L' is reserved for landmark names (L0, L1, ...) — a robot letter 'L'
# would collide with them (the data model rejects such collisions, matching
# the reference's cross-registry duplicate guard, gurobi_utils.py:62-80).
_ROBOT_LETTERS = string.ascii_uppercase.replace("L", "")


def _robot_name(r: int) -> str:
    """Robot name prefix: single letters A..Z (skipping L, the landmark
    prefix) for the first 25 robots, then bijective base-25 multi-letter
    prefixes (AA, AB, ...). Chains are structural in FactorGraphData
    (one list per robot), so nothing downstream parses the prefix —
    names only need to be unique, and a multi-letter prefix cannot
    collide with letter+digits pose names."""
    n = len(_ROBOT_LETTERS)
    s = _ROBOT_LETTERS[r % n]
    r //= n
    while r:
        r -= 1
        s = _ROBOT_LETTERS[r % n] + s
        r //= n
    return s


@dataclasses.dataclass(frozen=True)
class ManhattanWorldParams:
    """Simulation configuration (defaults approximate the shipped 4-robot
    dataset: 20x20 world, 400 poses/robot, trans precision 1e4, rot
    precision 2.5e5, range stddev 1.0)."""

    num_robots: int = 4
    num_poses_per_robot: int = 400
    num_landmarks: int = 6
    grid_size: int = 20
    cell_size: float = 1.0
    # odometry noise
    odom_trans_stddev: float = 0.01
    odom_rot_stddev: float = 0.002
    # range sensing
    range_stddev: float = 1.0
    range_sensing_radius: float = 15.0
    range_measure_prob: float = 0.3
    inter_robot_ranges: bool = True
    inter_robot_sensing_radius: float = 8.0
    inter_robot_measure_prob: float = 0.1
    turn_prob: float = 0.3
    seed: int = 0

    @property
    def odom_translation_precision(self) -> float:
        return 1.0 / (self.odom_trans_stddev**2)

    @property
    def odom_rotation_precision(self) -> float:
        return 1.0 / (self.odom_rot_stddev**2)


_HEADINGS = np.array([0.0, np.pi / 2, np.pi, 3 * np.pi / 2])
_DIRS = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]])


def _walk(rng: np.random.Generator, p: ManhattanWorldParams) -> np.ndarray:
    """One robot's grid random walk: returns (T, 3) array of (x, y, theta)."""
    T = p.num_poses_per_robot
    g = p.grid_size
    pos = np.array(
        [rng.integers(0, g + 1), rng.integers(0, g + 1)], dtype=np.int64
    )
    heading = int(rng.integers(0, 4))
    out = np.zeros((T, 3))
    for t in range(T):
        out[t, :2] = pos * p.cell_size
        out[t, 2] = _HEADINGS[heading]
        # choose next heading: keep straight with prob 1 - turn_prob, else
        # turn; never leave the grid.
        choices = []
        for h in range(4):
            nxt = pos + _DIRS[h]
            if 0 <= nxt[0] <= g and 0 <= nxt[1] <= g and h != (heading + 2) % 4:
                choices.append(h)
        if not choices:  # dead end: turn around
            choices = [(heading + 2) % 4]
        if heading in choices and rng.random() > p.turn_prob:
            new_heading = heading
        else:
            new_heading = int(choices[rng.integers(0, len(choices))])
        heading = new_heading
        pos = pos + _DIRS[heading]
    return out


def _rel_pose(a: np.ndarray, b: np.ndarray) -> Tuple[float, float, float]:
    """Relative pose of b in a's frame: (dx, dy, dtheta)."""
    dtheta = b[2] - a[2]
    c, s = np.cos(a[2]), np.sin(a[2])
    R_a_T = np.array([[c, s], [-s, c]])
    dt = R_a_T @ (b[:2] - a[:2])
    return float(dt[0]), float(dt[1]), float(np.arctan2(np.sin(dtheta), np.cos(dtheta)))


def simulate_manhattan_world(
    params: Optional[ManhattanWorldParams] = None,
) -> FactorGraphData:
    """Generate a multi-robot Manhattan-world factor graph with ground truth."""
    p = params or ManhattanWorldParams()
    rng = np.random.default_rng(p.seed)
    fg = FactorGraphData(dimension=2)

    trajs: List[np.ndarray] = []
    for r in range(p.num_robots):
        letter = _robot_name(r)
        traj = _walk(rng, p)
        trajs.append(traj)
        for t in range(p.num_poses_per_robot):
            fg.add_pose_variable(
                PoseVariable2D(
                    f"{letter}{t}",
                    (float(traj[t, 0]), float(traj[t, 1])),
                    float(traj[t, 2]),
                    timestamp=float(t),
                ),
                chain_idx=r,
            )

    world = p.grid_size * p.cell_size
    for j in range(p.num_landmarks):
        pos = rng.uniform(0.0, world, size=2)
        fg.add_landmark_variable(
            LandmarkVariable2D(f"L{j}", (float(pos[0]), float(pos[1])))
        )

    # odometry
    for r in range(p.num_robots):
        letter = _robot_name(r)
        traj = trajs[r]
        for t in range(p.num_poses_per_robot - 1):
            dx, dy, dth = _rel_pose(traj[t], traj[t + 1])
            fg.add_odom_measurement(
                PoseMeasurement2D(
                    f"{letter}{t}",
                    f"{letter}{t+1}",
                    dx + rng.normal(0.0, p.odom_trans_stddev),
                    dy + rng.normal(0.0, p.odom_trans_stddev),
                    dth + rng.normal(0.0, p.odom_rot_stddev),
                    translation_precision=p.odom_translation_precision,
                    rotation_precision=p.odom_rotation_precision,
                    timestamp=float(t),
                ),
                chain_idx=r,
            )

    # robot-landmark ranges
    landmarks = np.array([l.true_position for l in fg.landmark_variables])
    for r in range(p.num_robots):
        letter = _robot_name(r)
        traj = trajs[r]
        for t in range(p.num_poses_per_robot):
            d = np.linalg.norm(landmarks - traj[t, :2], axis=1)
            for j in range(p.num_landmarks):
                if d[j] <= p.range_sensing_radius and rng.random() < p.range_measure_prob:
                    noisy = max(d[j] + rng.normal(0.0, p.range_stddev), 1e-3)
                    fg.add_range_measurement(
                        FGRangeMeasurement(
                            (f"{letter}{t}", f"L{j}"),
                            float(noisy),
                            p.range_stddev,
                            timestamp=float(t),
                        )
                    )

    # inter-robot ranges (same timestep, distinct robots)
    if p.inter_robot_ranges and p.num_robots > 1:
        for t in range(p.num_poses_per_robot):
            for r1 in range(p.num_robots):
                for r2 in range(r1 + 1, p.num_robots):
                    d = np.linalg.norm(trajs[r1][t, :2] - trajs[r2][t, :2])
                    if (
                        d <= p.inter_robot_sensing_radius
                        and rng.random() < p.inter_robot_measure_prob
                    ):
                        noisy = max(d + rng.normal(0.0, p.range_stddev), 1e-3)
                        fg.add_range_measurement(
                            FGRangeMeasurement(
                                (
                                    f"{_robot_name(r1)}{t}",
                                    f"{_robot_name(r2)}{t}",
                                ),
                                float(noisy),
                                p.range_stddev,
                                timestamp=float(t),
                            )
                        )

    fg.x_min, fg.x_max = 0.0, world
    fg.y_min, fg.y_max = 0.0, world
    return fg


def resample_measurements(
    fg: FactorGraphData,
    seed: int,
    odom_trans_stddev: float = None,
    odom_rot_stddev: float = None,
) -> FactorGraphData:
    """Redraw measurement noise around the graph's ground truth, keeping the
    measurement STRUCTURE (variables, associations, chain layout) identical.

    This is the Monte-Carlo trial generator: a batch of resampled graphs
    shares one ConicProblem structure, so the trials stack
    (:func:`score_tpu_torch.parallel.stack_problems`) and solve as one
    batch (:func:`score_tpu_torch.parallel.solve_conic_batch`). Draws the
    numpy ``default_rng(seed)`` sequence of
    ``score_tpu.sim.manhattan.resample_measurements`` in its order
    (odometry per chain, loop closures, ranges), so the same graph and
    seed give the same measurements to the last bit.
    """
    rng = np.random.default_rng(seed)
    out = FactorGraphData(dimension=fg.dimension)
    out.pose_variables = fg.pose_variables
    out.landmark_variables = fg.landmark_variables
    out.existing_pose_variables = set(fg.existing_pose_variables)
    out.existing_landmark_variables = set(fg.existing_landmark_variables)
    out.pose_priors = fg.pose_priors
    out.landmark_priors = fg.landmark_priors
    out.x_min, out.x_max = fg.x_min, fg.x_max
    out.y_min, out.y_max = fg.y_min, fg.y_max

    poses = fg.pose_variables_dict
    translations = {
        **{n: np.asarray(p.true_position, dtype=np.float64) for n, p in poses.items()},
        **{
            l.name: np.asarray(l.true_position, dtype=np.float64)
            for l in fg.landmark_variables
        },
    }

    def true_state(name):
        p = poses[name]
        return np.array([p.true_position[0], p.true_position[1], p.true_theta])

    for r, chain in enumerate(fg.odom_measurements):
        for m in chain:
            dx, dy, dth = _rel_pose(true_state(m.base_pose), true_state(m.to_pose))
            ts = (
                odom_trans_stddev
                if odom_trans_stddev is not None
                else 1.0 / np.sqrt(m.translation_precision)
            )
            rs = (
                odom_rot_stddev
                if odom_rot_stddev is not None
                else 1.0 / np.sqrt(m.rotation_precision)
            )
            out.add_odom_measurement(
                PoseMeasurement2D(
                    m.base_pose,
                    m.to_pose,
                    dx + rng.normal(0.0, ts),
                    dy + rng.normal(0.0, ts),
                    dth + rng.normal(0.0, rs),
                    translation_precision=m.translation_precision,
                    rotation_precision=m.rotation_precision,
                    timestamp=m.timestamp,
                ),
                chain_idx=r,
            )
    for m in fg.loop_closure_measurements:
        dx, dy, dth = _rel_pose(true_state(m.base_pose), true_state(m.to_pose))
        ts = 1.0 / np.sqrt(m.translation_precision)
        rs = 1.0 / np.sqrt(m.rotation_precision)
        out.loop_closure_measurements.append(
            PoseMeasurement2D(
                m.base_pose,
                m.to_pose,
                dx + rng.normal(0.0, ts),
                dy + rng.normal(0.0, ts),
                dth + rng.normal(0.0, rs),
                translation_precision=m.translation_precision,
                rotation_precision=m.rotation_precision,
                timestamp=m.timestamp,
            )
        )
    for m in fg.range_measurements:
        d_true = np.linalg.norm(
            translations[m.first_key] - translations[m.second_key]
        )
        noisy = max(d_true + rng.normal(0.0, m.stddev), 1e-3)
        out.add_range_measurement(
            FGRangeMeasurement(
                tuple(m.association), float(noisy), m.stddev, m.timestamp
            )
        )
    return out
