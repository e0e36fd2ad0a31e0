"""Solution containers and export utilities.

Parity with ``py_factor_graph.utils.solver_utils`` as consumed by the
reference (gurobi_utils.py:14-18,114-136,190-203; plot_utils.py:104-136):
``VariableValues(dim, poses, landmarks, distances)`` and
``SolverResults(variables=..., total_time=..., solved=...,
pose_chain_names=...)`` with ``.poses/.landmarks/.translations`` accessors,
plus ``save_to_tum`` trajectory export.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from score_tpu_torch.utils.matrix import (
    get_quat_from_rotation_matrix,
    get_rotation_from_transformation_matrix,
    get_translation_from_transformation_matrix,
)

__all__ = ["VariableValues", "SolverResults", "save_to_tum", "save_results_to_file"]


@dataclass
class VariableValues:
    """Solved values for all variables.

    - ``poses``: name -> homogeneous (d+1)x(d+1) transformation matrix with
      the rotation block already rounded to SO(d).
    - ``landmarks``: name -> (d,) position.
    - ``distances``: (first, second) association -> (1,) scalar (SOCP) or
      (d,) unit-direction vector (QCQP).
    """

    dim: int
    poses: Dict[str, np.ndarray]
    landmarks: Dict[str, np.ndarray]
    distances: Dict[Tuple[str, str], np.ndarray] = field(default_factory=dict)

    @property
    def translations(self) -> Dict[str, np.ndarray]:
        """Translations of every pose and landmark, keyed by name."""
        out = {
            name: np.asarray(T)[: self.dim, -1] for name, T in self.poses.items()
        }
        out.update({name: np.asarray(p) for name, p in self.landmarks.items()})
        return out

    @property
    def rotations(self) -> Dict[str, np.ndarray]:
        return {
            name: np.asarray(T)[: self.dim, : self.dim]
            for name, T in self.poses.items()
        }


@dataclass
class SolverResults:
    """The result of one relaxation solve (parity: gurobi_utils.py:197-202)."""

    variables: VariableValues
    total_time: float
    solved: bool
    pose_chain_names: Optional[List[List[str]]] = None
    # --- extensions beyond the reference (solver telemetry) ---
    iterations: int = 0
    primal_objective: float = float("nan")
    dual_objective: float = float("nan")
    gap: float = float("nan")
    primal_residual: float = float("nan")
    dual_residual: float = float("nan")
    relaxation: str = ""

    @property
    def poses(self) -> Dict[str, np.ndarray]:
        return self.variables.poses

    @property
    def landmarks(self) -> Dict[str, np.ndarray]:
        return self.variables.landmarks

    @property
    def distances(self) -> Dict[Tuple[str, str], np.ndarray]:
        return self.variables.distances

    @property
    def translations(self) -> Dict[str, np.ndarray]:
        return self.variables.translations


def _tum_line(idx: int, T: np.ndarray, timestamp: Optional[float]) -> str:
    dim = T.shape[0] - 1
    t = get_translation_from_transformation_matrix(T)
    R = get_rotation_from_transformation_matrix(T)
    quat = get_quat_from_rotation_matrix(R)  # (qx, qy, qz, qw)
    if dim == 2:
        x, y, z = float(t[0]), float(t[1]), 0.0
    else:
        x, y, z = (float(v) for v in t)
    ts = float(timestamp) if timestamp is not None else float(idx)
    return (
        f"{ts} {x} {y} {z} {quat[0]} {quat[1]} {quat[2]} {quat[3]}"
    )


def save_to_tum(
    solver_results: SolverResults,
    filepath: str,
    strip_extension: bool = False,
    timestamps: Optional[Dict[str, float]] = None,
) -> List[str]:
    """Write the solved trajectories in TUM format
    (``timestamp x y z qx qy qz qw`` per line), one file per robot chain.

    For multi-robot problems the chain letter is inserted before the file
    extension. Returns the list of files written.
    """
    chains = solver_results.pose_chain_names
    if not chains:
        chains = [sorted(solver_results.poses.keys())]
    base, ext = os.path.splitext(filepath)
    if not ext or strip_extension:
        ext = ".tum"
    written = []
    multi = len([c for c in chains if c]) > 1
    for chain in chains:
        if not chain:
            continue
        letter = chain[0][0] if multi else ""
        path = f"{base}{('_' + letter) if letter else ''}{ext}"
        lines = []
        for idx, name in enumerate(chain):
            T = solver_results.poses[name]
            ts = timestamps.get(name) if timestamps else None
            lines.append(_tum_line(idx, np.asarray(T), ts))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        written.append(path)
    return written


def save_results_to_file(solver_results: SolverResults, filepath: str) -> None:
    """Persist a SolverResults as a pickle (host-side convenience)."""
    import pickle

    os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
    with open(filepath, "wb") as f:
        pickle.dump(solver_results, f)
