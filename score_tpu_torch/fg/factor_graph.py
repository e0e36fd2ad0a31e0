"""The factor-graph container: :class:`FactorGraphData`.

Schema parity with ``py_factor_graph.factor_graph.FactorGraphData`` as
consumed by the reference (field list verified against the pickled state of
both shipped datasets; accessor parity with
score/solve_score.py:29, gurobi_utils.py:196,237,253,281,
plot_utils.py:54-76,191-192).

New implementation: a plain dataclass holding host-side Python/numpy data.
Device-side problem structures are produced by :mod:`score_tpu_torch.assembly`.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Dict, List, Optional, Set, Tuple, Union

import numpy as np

from score_tpu_torch.fg.measurements import (
    AmbiguousFGRangeMeasurement,
    AmbiguousPoseMeasurement2D,
    FGRangeMeasurement,
    PoseMeasurement2D,
    PoseMeasurement3D,
)
from score_tpu_torch.fg.priors import (
    LandmarkPrior2D,
    LandmarkPrior3D,
    PosePrior2D,
    PosePrior3D,
)
from score_tpu_torch.fg.variables import (
    LandmarkVariable2D,
    LandmarkVariable3D,
    PoseVariable2D,
    PoseVariable3D,
    _PickleStateMixin,
)

POSE_VARIABLE = Union[PoseVariable2D, PoseVariable3D]
LANDMARK_VARIABLE = Union[LandmarkVariable2D, LandmarkVariable3D]
POSE_MEASUREMENT = Union[PoseMeasurement2D, PoseMeasurement3D]
POSE_PRIOR = Union[PosePrior2D, PosePrior3D]
LANDMARK_PRIOR = Union[LandmarkPrior2D, LandmarkPrior3D]

__all__ = ["FactorGraphData"]


@dataclass(eq=False)
class FactorGraphData(_PickleStateMixin):
    """A range-aided SLAM factor graph.

    Pose variables are stored as chains (one list per robot); odometry
    measurements mirror that chain structure. Range measurements associate
    pose/landmark names.
    """

    dimension: int = 2
    pose_variables: List[List[POSE_VARIABLE]] = dfield(default_factory=list)
    landmark_variables: List[LANDMARK_VARIABLE] = dfield(default_factory=list)
    existing_pose_variables: Set[str] = dfield(default_factory=set)
    existing_landmark_variables: Set[str] = dfield(default_factory=set)
    odom_measurements: List[List[POSE_MEASUREMENT]] = dfield(default_factory=list)
    loop_closure_measurements: List[POSE_MEASUREMENT] = dfield(default_factory=list)
    ambiguous_loop_closure_measurements: List[AmbiguousPoseMeasurement2D] = dfield(
        default_factory=list
    )
    range_measurements: List[FGRangeMeasurement] = dfield(default_factory=list)
    ambiguous_range_measurements: List[AmbiguousFGRangeMeasurement] = dfield(
        default_factory=list
    )
    pose_priors: List[POSE_PRIOR] = dfield(default_factory=list)
    landmark_priors: List[LANDMARK_PRIOR] = dfield(default_factory=list)
    x_min: Optional[float] = None
    x_max: Optional[float] = None
    y_min: Optional[float] = None
    y_max: Optional[float] = None
    z_min: Optional[float] = None
    z_max: Optional[float] = None
    max_measure_weight: Optional[float] = None
    min_measure_weight: Optional[float] = None

    # ------------------------------------------------------------------ #
    # Registration helpers (used by the simulator and parsers)
    # ------------------------------------------------------------------ #

    def add_pose_variable(self, pose: POSE_VARIABLE, chain_idx: int = 0) -> None:
        while len(self.pose_variables) <= chain_idx:
            self.pose_variables.append([])
        if pose.name in self.existing_pose_variables:
            raise ValueError(f"Duplicate pose variable {pose.name}")
        if pose.name in self.existing_landmark_variables:
            raise ValueError(
                f"Pose name {pose.name} collides with a landmark name "
                "(cross-registry guard, parity: gurobi_utils.py:62-80)"
            )
        self.pose_variables[chain_idx].append(pose)
        self.existing_pose_variables.add(pose.name)

    def add_landmark_variable(self, landmark: LANDMARK_VARIABLE) -> None:
        if landmark.name in self.existing_landmark_variables:
            raise ValueError(f"Duplicate landmark variable {landmark.name}")
        if landmark.name in self.existing_pose_variables:
            raise ValueError(
                f"Landmark name {landmark.name} collides with a pose name "
                "(cross-registry guard, parity: gurobi_utils.py:62-80)"
            )
        self.landmark_variables.append(landmark)
        self.existing_landmark_variables.add(landmark.name)

    def add_odom_measurement(self, meas: POSE_MEASUREMENT, chain_idx: int = 0) -> None:
        while len(self.odom_measurements) <= chain_idx:
            self.odom_measurements.append([])
        self.odom_measurements[chain_idx].append(meas)

    def add_range_measurement(self, meas: FGRangeMeasurement) -> None:
        self.range_measurements.append(meas)

    # ------------------------------------------------------------------ #
    # Counts
    # ------------------------------------------------------------------ #

    @property
    def num_poses(self) -> int:
        return sum(len(chain) for chain in self.pose_variables)

    @property
    def num_landmarks(self) -> int:
        return len(self.landmark_variables)

    @property
    def num_odom_measurements(self) -> int:
        return sum(len(chain) for chain in self.odom_measurements)

    @property
    def num_loop_closures(self) -> int:
        return len(self.loop_closure_measurements)

    @property
    def num_range_measurements(self) -> int:
        return len(self.range_measurements)

    @property
    def num_robots(self) -> int:
        return len([c for c in self.pose_variables if len(c) > 0])

    # ------------------------------------------------------------------ #
    # Lookups
    # ------------------------------------------------------------------ #

    @property
    def pose_variables_dict(self) -> Dict[str, POSE_VARIABLE]:
        return {p.name: p for chain in self.pose_variables for p in chain}

    @property
    def landmark_variables_dict(self) -> Dict[str, LANDMARK_VARIABLE]:
        return {l.name: l for l in self.landmark_variables}

    @property
    def all_variable_names(self) -> List[str]:
        names = [p.name for chain in self.pose_variables for p in chain]
        names.extend(l.name for l in self.landmark_variables)
        return names

    def get_pose_chain_names(self) -> List[List[str]]:
        """Names of poses, chain by chain (parity: gurobi_utils.py:196)."""
        return [[p.name for p in chain] for chain in self.pose_variables]

    @property
    def unconnected_variable_names(self) -> Set[str]:
        """Variables not touched by any measurement or prior
        (parity: solve_score.py:28-32 connectivity precondition)."""
        connected: Set[str] = set()
        for chain in self.odom_measurements:
            for m in chain:
                connected.add(m.base_pose)
                connected.add(m.to_pose)
        for m in self.loop_closure_measurements:
            connected.add(m.base_pose)
            connected.add(m.to_pose)
        for r in self.range_measurements:
            connected.add(r.first_key)
            connected.add(r.second_key)
        for p in self.pose_priors:
            connected.add(p.name)
        for lp in self.landmark_priors:
            connected.add(lp.name)
        return set(self.all_variable_names) - connected

    @property
    def pose_to_range_measures_dict(self) -> Dict[str, List[FGRangeMeasurement]]:
        """Map from pose name to the range measurements anchored at it
        (parity: plot_utils.py:54-76 usage)."""
        out: Dict[str, List[FGRangeMeasurement]] = {}
        pose_names = self.existing_pose_variables
        for r in self.range_measurements:
            for key in (r.first_key, r.second_key):
                if key in pose_names:
                    out.setdefault(key, []).append(r)
        return out

    @property
    def association_to_range_measures_dict(
        self,
    ) -> Dict[Tuple[str, str], List[FGRangeMeasurement]]:
        out: Dict[Tuple[str, str], List[FGRangeMeasurement]] = {}
        for r in self.range_measurements:
            out.setdefault(tuple(r.association), []).append(r)
        return out

    # ------------------------------------------------------------------ #
    # Geometry / summaries
    # ------------------------------------------------------------------ #

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        """(x_min, x_max, y_min, y_max); computed from ground truth when not
        stored."""
        if self.x_min is not None and self.x_max is not None:
            return (
                float(self.x_min),
                float(self.x_max),
                float(self.y_min),
                float(self.y_max),
            )
        pts = np.array(
            [p.true_position[:2] for chain in self.pose_variables for p in chain]
            + [l.true_position[:2] for l in self.landmark_variables]
        )
        return (
            float(pts[:, 0].min()),
            float(pts[:, 0].max()),
            float(pts[:, 1].min()),
            float(pts[:, 1].max()),
        )

    def true_trajectories(self) -> List[np.ndarray]:
        """Ground-truth translations per chain, each (chain_len, dim)."""
        return [
            np.array([p.true_position[: self.dimension] for p in chain])
            for chain in self.pose_variables
            if chain
        ]

    def summary(self) -> str:
        return (
            f"FactorGraphData(dim={self.dimension}, robots={self.num_robots}, "
            f"poses={self.num_poses}, landmarks={self.num_landmarks}, "
            f"odom={self.num_odom_measurements}, "
            f"loop_closures={self.num_loop_closures}, "
            f"ranges={self.num_range_measurements}, "
            f"pose_priors={len(self.pose_priors)}, "
            f"landmark_priors={len(self.landmark_priors)})"
        )
