"""Prior factor types.

Schema parity with ``py_factor_graph.priors`` (consumed at
score/utils/gurobi_utils.py:13,441-444). Note the slots-style
tuple pickle state observed in the Manhattan dataset:
``PosePrior2D = (name, position, theta, translation_precision,
rotation_precision, timestamp)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from score_tpu_torch.fg.variables import _PickleStateMixin

__all__ = [
    "PosePrior2D",
    "PosePrior3D",
    "LandmarkPrior2D",
    "LandmarkPrior3D",
]


@dataclass(eq=True)
class PosePrior2D(_PickleStateMixin):
    """Prior on a 2D pose. Carried by the data model; per reference semantics
    pose priors are NEVER added to the relaxation cost (only the gauge pin
    constrains poses — gurobi_utils.py:358-377 omits them)."""

    name: str
    position: Tuple[float, float] = (0.0, 0.0)
    theta: float = 0.0
    translation_precision: float = 1.0
    rotation_precision: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = (
        "name",
        "position",
        "theta",
        "translation_precision",
        "rotation_precision",
        "timestamp",
    )

    @property
    def translation_vector(self) -> np.ndarray:
        return np.asarray(self.position, dtype=np.float64)


@dataclass(eq=False)
class PosePrior3D(_PickleStateMixin):
    """Prior on a 3D pose (data-model only, see PosePrior2D)."""

    name: str
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    rotation: np.ndarray = field(default_factory=lambda: np.eye(3))
    translation_precision: float = 1.0
    rotation_precision: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = (
        "name",
        "position",
        "rotation",
        "translation_precision",
        "rotation_precision",
        "timestamp",
    )

    @property
    def translation_vector(self) -> np.ndarray:
        return np.asarray(self.position, dtype=np.float64)


@dataclass(eq=True)
class LandmarkPrior2D(_PickleStateMixin):
    """Prior on a 2D landmark. These DO enter the cost:
    ``translation_precision * ||l - translation_vector||^2``
    (gurobi_utils.py:433-446)."""

    name: str
    position: Tuple[float, float] = (0.0, 0.0)
    translation_precision: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = ("name", "position", "translation_precision", "timestamp")

    @property
    def translation_vector(self) -> np.ndarray:
        return np.asarray(self.position, dtype=np.float64)


@dataclass(eq=True)
class LandmarkPrior3D(_PickleStateMixin):
    """Prior on a 3D landmark."""

    name: str
    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    translation_precision: float = 1.0
    timestamp: Optional[float] = None

    _PICKLE_FIELDS = ("name", "position", "translation_precision", "timestamp")

    @property
    def translation_vector(self) -> np.ndarray:
        return np.asarray(self.position, dtype=np.float64)
