"""Measurement types for the factor-graph data layer.

Schema parity with ``py_factor_graph.measurements`` as used by the reference
(score/utils/gurobi_utils.py:7-12,288,500,515,522) and as
pickled in the shipped datasets. New implementation (dataclasses + numpy).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from score_tpu_torch.fg.variables import _PickleStateMixin

__all__ = [
    "PoseMeasurement2D",
    "PoseMeasurement3D",
    "FGRangeMeasurement",
    "AmbiguousPoseMeasurement2D",
    "AmbiguousFGRangeMeasurement",
    "POSE_MEASUREMENT_TYPES",
]


@dataclass(eq=True)
class PoseMeasurement2D(_PickleStateMixin):
    """A relative SE(2) measurement between two poses (odometry or loop
    closure).

    Parity: fields/properties consumed at gurobi_utils.py:514-522
    (``translation_precision``, ``rotation_precision``, ``translation_vector``,
    ``rotation_matrix``).
    """

    base_pose: str
    to_pose: str
    x: float = 0.0
    y: float = 0.0
    theta: float = 0.0
    translation_precision: float = 1.0
    rotation_precision: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = (
        "base_pose",
        "to_pose",
        "x",
        "y",
        "theta",
        "translation_precision",
        "rotation_precision",
        "timestamp",
    )

    @property
    def translation_vector(self) -> np.ndarray:
        return np.array([self.x, self.y], dtype=np.float64)

    @property
    def rotation_matrix(self) -> np.ndarray:
        c, s = math.cos(self.theta), math.sin(self.theta)
        return np.array([[c, -s], [s, c]], dtype=np.float64)

    @property
    def transformation_matrix(self) -> np.ndarray:
        T = np.eye(3)
        T[:2, :2] = self.rotation_matrix
        T[:2, 2] = (self.x, self.y)
        return T


@dataclass(eq=False)
class PoseMeasurement3D(_PickleStateMixin):
    """A relative SE(3) measurement between two poses."""

    base_pose: str
    to_pose: str
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    rotation: np.ndarray = field(default_factory=lambda: np.eye(3))
    translation_precision: float = 1.0
    rotation_precision: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = (
        "base_pose",
        "to_pose",
        "translation",
        "rotation",
        "translation_precision",
        "rotation_precision",
        "timestamp",
    )

    @property
    def translation_vector(self) -> np.ndarray:
        return np.asarray(self.translation, dtype=np.float64)

    @property
    def rotation_matrix(self) -> np.ndarray:
        return np.asarray(self.rotation, dtype=np.float64)

    @property
    def transformation_matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.rotation_matrix
        T[:3, 3] = self.translation_vector
        return T


@dataclass(eq=True)
class FGRangeMeasurement(_PickleStateMixin):
    """A range (distance) measurement between two variables.

    Parity: ``association``/``first_key``/``second_key``/``dist``/``precision``
    consumed at gurobi_utils.py:288,454,487,500. ``precision`` is the standard
    1/sigma^2 weight derived from ``stddev``.
    """

    association: Tuple[str, str] = ("", "")
    dist: float = 0.0
    stddev: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = ("association", "dist", "stddev", "timestamp")

    @property
    def first_key(self) -> str:
        return self.association[0]

    @property
    def second_key(self) -> str:
        return self.association[1]

    @property
    def weight(self) -> float:
        return 1.0 / (self.stddev**2)

    @property
    def precision(self) -> float:
        return 1.0 / (self.stddev**2)


@dataclass(eq=True)
class AmbiguousPoseMeasurement2D(_PickleStateMixin):
    """A loop-closure measurement with data-association ambiguity (carried by
    the data model; the solver, like the reference, ignores these)."""

    base_pose: str
    measured_to_pose: str
    true_to_pose: str
    x: float = 0.0
    y: float = 0.0
    theta: float = 0.0
    translation_precision: float = 1.0
    rotation_precision: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = (
        "base_pose",
        "measured_to_pose",
        "true_to_pose",
        "x",
        "y",
        "theta",
        "translation_precision",
        "rotation_precision",
        "timestamp",
    )


@dataclass(eq=True)
class AmbiguousFGRangeMeasurement(_PickleStateMixin):
    """A range measurement with ambiguous data association (data-model only)."""

    true_association: Tuple[str, str] = ("", "")
    measured_association: Tuple[str, str] = ("", "")
    dist: float = 0.0
    stddev: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = (
        "true_association",
        "measured_association",
        "dist",
        "stddev",
        "timestamp",
    )


POSE_MEASUREMENT_TYPES = (PoseMeasurement2D, PoseMeasurement3D)
