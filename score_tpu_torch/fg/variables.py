"""Variable types for the factor-graph data layer.

These mirror the attribute schema of ``py_factor_graph.variables`` as consumed
by the reference (see score/utils/plot_utils.py:9,264-282 and
the pickled datasets under examples/), so that the shipped
pickles of the JAX package (``score_tpu.fg.io``) have a one-to-one counterpart here
(see :mod:`score_tpu_torch.convert`).

Implementation is new: plain dataclasses with a pickle-state shim
(``__setstate__`` accepts both attrs dict-states and attrs slots
tuple-states).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "PoseVariable2D",
    "PoseVariable3D",
    "LandmarkVariable2D",
    "LandmarkVariable3D",
    "POSE_VARIABLE_TYPES",
    "LANDMARK_VARIABLE_TYPES",
]


class _PickleStateMixin:
    """Accept attrs-style pickle states (dict for normal classes, tuple for
    slots classes) so the reference datasets unpickle into these types."""

    _PICKLE_FIELDS: Tuple[str, ...] = ()

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, (tuple, list)):
            names = type(self)._PICKLE_FIELDS
            if len(state) != len(names):
                raise ValueError(
                    f"Cannot restore {type(self).__name__}: got {len(state)} "
                    f"values for fields {names}"
                )
            for name, value in zip(names, state):
                setattr(self, name, value)
        else:  # pragma: no cover
            raise TypeError(f"Unsupported pickle state: {type(state)}")


@dataclass(eq=True)
class PoseVariable2D(_PickleStateMixin):
    """A 2D pose variable with ground-truth values.

    Schema parity: py_factor_graph.variables.PoseVariable2D as pickled in
    examples/manhattan/factor_graph.pickle (fields: name,
    true_position, true_theta, timestamp).
    """

    name: str
    true_position: Tuple[float, float] = (0.0, 0.0)
    true_theta: float = 0.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = ("name", "true_position", "true_theta", "timestamp")

    @property
    def true_x(self) -> float:
        return float(self.true_position[0])

    @property
    def true_y(self) -> float:
        return float(self.true_position[1])

    @property
    def position_vector(self) -> np.ndarray:
        return np.asarray(self.true_position, dtype=np.float64)

    @property
    def rotation_matrix(self) -> np.ndarray:
        c, s = math.cos(self.true_theta), math.sin(self.true_theta)
        return np.array([[c, -s], [s, c]], dtype=np.float64)

    @property
    def transformation_matrix(self) -> np.ndarray:
        T = np.eye(3)
        T[:2, :2] = self.rotation_matrix
        T[:2, 2] = self.true_position
        return T


@dataclass(eq=False)
class PoseVariable3D(_PickleStateMixin):
    """A 3D pose variable (rotation stored as a 3x3 matrix)."""

    name: str
    true_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    true_rotation: np.ndarray = field(default_factory=lambda: np.eye(3))
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = ("name", "true_position", "true_rotation", "timestamp")

    @property
    def true_x(self) -> float:
        return float(self.true_position[0])

    @property
    def true_y(self) -> float:
        return float(self.true_position[1])

    @property
    def true_z(self) -> float:
        return float(self.true_position[2])

    @property
    def position_vector(self) -> np.ndarray:
        return np.asarray(self.true_position, dtype=np.float64)

    @property
    def rotation_matrix(self) -> np.ndarray:
        return np.asarray(self.true_rotation, dtype=np.float64)

    @property
    def transformation_matrix(self) -> np.ndarray:
        T = np.eye(4)
        T[:3, :3] = self.rotation_matrix
        T[:3, 3] = self.true_position
        return T


@dataclass(eq=True)
class LandmarkVariable2D(_PickleStateMixin):
    """A 2D landmark variable."""

    name: str
    true_position: Tuple[float, float] = (0.0, 0.0)

    _PICKLE_FIELDS = ("name", "true_position")

    @property
    def true_x(self) -> float:
        return float(self.true_position[0])

    @property
    def true_y(self) -> float:
        return float(self.true_position[1])

    @property
    def position_vector(self) -> np.ndarray:
        return np.asarray(self.true_position, dtype=np.float64)


@dataclass(eq=True)
class LandmarkVariable3D(_PickleStateMixin):
    """A 3D landmark variable."""

    name: str
    true_position: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    _PICKLE_FIELDS = ("name", "true_position")

    @property
    def true_x(self) -> float:
        return float(self.true_position[0])

    @property
    def true_y(self) -> float:
        return float(self.true_position[1])

    @property
    def true_z(self) -> float:
        return float(self.true_position[2])

    @property
    def position_vector(self) -> np.ndarray:
        return np.asarray(self.true_position, dtype=np.float64)


POSE_VARIABLE_TYPES = (PoseVariable2D, PoseVariable3D)
LANDMARK_VARIABLE_TYPES = (LandmarkVariable2D, LandmarkVariable3D)
