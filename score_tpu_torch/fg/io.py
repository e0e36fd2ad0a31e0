"""Parsers and exporters for factor-graph data.

Port of :mod:`score_tpu.fg.io` (host-side, no torch):

- :func:`parse_pickle_file` loads py_factor_graph-produced pickles (the
  two datasets shipped with the reference), pickles written by the JAX
  package (``score_tpu``) and pickles produced by this package, via a
  module-remapping unpickler. The JAX package's class names map to this
  package's classes by string: nothing of ``score_tpu`` (or jax) is
  imported.
- :func:`parse_tum_file` reads TUM trajectories (e.g. the shipped
  ``gt_traj_A.tum`` ground truth).
- :func:`parse_g2o_file` / :func:`save_to_g2o_file` read/write the g2o
  SLAM graph format (2D and 3D, incl. EDGE_RANGE) — parity with the
  formats the reference's data layer advertises.

Unpickling can run arbitrary code: read only files this program or a
trusted writer produced.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Tuple

import numpy as np

from score_tpu_torch.fg import measurements as _meas
from score_tpu_torch.fg import priors as _priors
from score_tpu_torch.fg import variables as _vars
from score_tpu_torch.fg.factor_graph import FactorGraphData

__all__ = [
    "parse_pickle_file",
    "save_to_pickle_file",
    "parse_tum_file",
    "parse_g2o_file",
    "save_to_g2o_file",
]


# Map py_factor_graph global names -> our classes. Anything not listed here
# that lives under py_factor_graph.* raises (surfacing schema gaps loudly).
_CLASS_MAP = {
    ("py_factor_graph.factor_graph", "FactorGraphData"): FactorGraphData,
    ("py_factor_graph.variables", "PoseVariable2D"): _vars.PoseVariable2D,
    ("py_factor_graph.variables", "PoseVariable3D"): _vars.PoseVariable3D,
    ("py_factor_graph.variables", "LandmarkVariable2D"): _vars.LandmarkVariable2D,
    ("py_factor_graph.variables", "LandmarkVariable3D"): _vars.LandmarkVariable3D,
    ("py_factor_graph.measurements", "PoseMeasurement2D"): _meas.PoseMeasurement2D,
    ("py_factor_graph.measurements", "PoseMeasurement3D"): _meas.PoseMeasurement3D,
    ("py_factor_graph.measurements", "FGRangeMeasurement"): _meas.FGRangeMeasurement,
    (
        "py_factor_graph.measurements",
        "AmbiguousPoseMeasurement2D",
    ): _meas.AmbiguousPoseMeasurement2D,
    (
        "py_factor_graph.measurements",
        "AmbiguousFGRangeMeasurement",
    ): _meas.AmbiguousFGRangeMeasurement,
    ("py_factor_graph.priors", "PosePrior2D"): _priors.PosePrior2D,
    ("py_factor_graph.priors", "PosePrior3D"): _priors.PosePrior3D,
    ("py_factor_graph.priors", "LandmarkPrior2D"): _priors.LandmarkPrior2D,
    ("py_factor_graph.priors", "LandmarkPrior3D"): _priors.LandmarkPrior3D,
}
# The JAX package's classes (score_tpu.fg.<module>.<name>) -> the port's
# class of the same name in the same module. Any other score_tpu.* name
# raises: the default lookup would import score_tpu, and with it jax.
_CLASS_MAP.update({
    ("score_tpu" + cls.__module__[len("score_tpu_torch"):], cls.__name__): cls
    for cls in set(_CLASS_MAP.values())
})


def _remapped_package(module: str) -> bool:
    return module.startswith("py_factor_graph") or (
        module == "score_tpu" or module.startswith("score_tpu.")
    )


class _RemappingUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if _remapped_package(module):
            key = (module, name)
            if key in _CLASS_MAP:
                return _CLASS_MAP[key]
            raise pickle.UnpicklingError(
                f"Unsupported class in pickle: {module}.{name}"
            )
        return super().find_class(module, name)


def parse_pickle_file(filepath: str) -> FactorGraphData:
    """Load a pickled factor graph (py_factor_graph schema, the JAX
    package's or ours)."""
    with open(filepath, "rb") as f:
        fg = _RemappingUnpickler(f).load()
    if not isinstance(fg, FactorGraphData):
        raise TypeError(f"{filepath} did not contain a FactorGraphData: {type(fg)}")
    _normalize(fg)
    return fg


def _normalize(fg: FactorGraphData) -> None:
    """Fill derived/bookkeeping fields that old pickles may lack."""
    if not fg.existing_pose_variables:
        fg.existing_pose_variables = {
            p.name for chain in fg.pose_variables for p in chain
        }
    if not fg.existing_landmark_variables:
        fg.existing_landmark_variables = {l.name for l in fg.landmark_variables}


def save_to_pickle_file(fg: FactorGraphData, filepath: str) -> None:
    with open(filepath, "wb") as f:
        pickle.dump(fg, f)


def parse_tum_file(filepath: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read a TUM trajectory file.

    Returns ``(timestamps (N,), translations (N,3), quaternions (N,4))`` with
    quaternions in (qx, qy, qz, qw) order.
    """
    rows: List[List[float]] = []
    with open(filepath) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.replace(",", " ").split()]
            if len(vals) != 8:
                raise ValueError(f"Malformed TUM line in {filepath}: {line!r}")
            rows.append(vals)
    arr = np.asarray(rows, dtype=np.float64).reshape(-1, 8)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


# ------------------------------------------------------------------ #
# g2o (SLAM graph-file) format
# ------------------------------------------------------------------ #
#
# Parity: the reference's data layer advertises parsing "g2o and other
# SLAM formats" (its README, via py_factor_graph).
# Supported tags (2D and 3D):
#   VERTEX_SE2 id x y theta            -> PoseVariable2D "A{id}"
#   VERTEX_XY id x y                   -> LandmarkVariable2D "L{id}"
#   EDGE_SE2 i j dx dy dth I11 I12 I13 I22 I23 I33
#       consecutive pose ids -> odometry, otherwise loop closure;
#       translation_precision = mean(I11, I22), rotation_precision = I33
#   VERTEX_SE3:QUAT id x y z qx qy qz qw -> PoseVariable3D
#   VERTEX_TRACKXYZ id x y z           -> LandmarkVariable3D
#   EDGE_SE3:QUAT i j dx dy dz qx qy qz qw I(21 upper-tri entries)
#   EDGE_RANGE i j dist I              -> FGRangeMeasurement
#       (i a pose id, j a pose or landmark id; stddev = 1/sqrt(I))
#   LANDMARK_PRIOR2 id x y I / LANDMARK_PRIOR3 id x y z I
#       -> LandmarkPrior2D/3D (extension tag: vanilla g2o has no
#       landmark-prior record; needed for lossless round-trips)


def _g2o_pose_name(i: int) -> str:
    return f"A{int(i)}"


def _g2o_lm_name(i: int) -> str:
    return f"L{int(i)}"


def parse_g2o_file(filepath: str) -> FactorGraphData:
    """Parse a g2o graph file into a :class:`FactorGraphData`."""
    from score_tpu_torch.utils.matrix import get_rotation_matrix_from_quat

    poses: Dict[int, object] = {}
    landmarks: Dict[int, object] = {}
    pose_edges = []
    range_edges = []
    lm_priors = []
    dim = None

    def parse_line(tag, v):
        nonlocal dim
        if tag == "VERTEX_SE2":
            dim = dim or 2
            i = int(v[0])
            poses[i] = _vars.PoseVariable2D(
                _g2o_pose_name(i), (v[1], v[2]), v[3]
            )
        elif tag == "VERTEX_XY":
            i = int(v[0])
            landmarks[i] = _vars.LandmarkVariable2D(
                _g2o_lm_name(i), (v[1], v[2])
            )
        elif tag == "VERTEX_SE3:QUAT":
            dim = dim or 3
            i = int(v[0])
            R = get_rotation_matrix_from_quat(np.asarray(v[4:8]))
            poses[i] = _vars.PoseVariable3D(
                _g2o_pose_name(i), tuple(v[1:4]), R
            )
        elif tag == "VERTEX_TRACKXYZ":
            i = int(v[0])
            landmarks[i] = _vars.LandmarkVariable3D(
                _g2o_lm_name(i), tuple(v[1:4])
            )
        elif tag == "EDGE_SE2":
            i, j = int(v[0]), int(v[1])
            dx, dy, dth = v[2], v[3], v[4]
            info = v[5:11]
            if len(info) != 6:
                raise IndexError("EDGE_SE2 needs 6 information entries")
            tprec = 0.5 * (info[0] + info[3])  # I11, I22
            rprec = info[5]  # I33
            pose_edges.append(
                (i, j, _meas.PoseMeasurement2D(
                    _g2o_pose_name(i), _g2o_pose_name(j),
                    dx, dy, dth, tprec, rprec,
                ))
            )
        elif tag == "EDGE_SE3:QUAT":
            i, j = int(v[0]), int(v[1])
            t = np.asarray(v[2:5])
            R = get_rotation_matrix_from_quat(np.asarray(v[5:9]))
            info = v[9:30]  # 21 upper-triangular entries of 6x6
            if len(info) != 21:
                raise IndexError("EDGE_SE3:QUAT needs 21 information entries")
            # diagonal entries sit at the heads of the upper-tri rows
            diag = [info[0], info[6], info[11], info[15], info[18], info[20]]
            tprec = float(np.mean(diag[:3]))
            rprec = float(np.mean(diag[3:]))
            pose_edges.append(
                (i, j, _meas.PoseMeasurement3D(
                    _g2o_pose_name(i), _g2o_pose_name(j),
                    t, R, tprec, rprec,
                ))
            )
        elif tag == "EDGE_RANGE":
            range_edges.append((int(v[0]), int(v[1]), v[2], v[3]))
        elif tag == "LANDMARK_PRIOR2":
            lm_priors.append((int(v[0]), (v[1], v[2]), v[3]))
        elif tag == "LANDMARK_PRIOR3":
            lm_priors.append((int(v[0]), (v[1], v[2], v[3]), v[4]))
        else:
            raise ValueError(f"Unsupported g2o tag {tag!r}")

    with open(filepath) as f:
        for ln, line in enumerate(f, 1):
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            try:
                parse_line(parts[0], [float(x) for x in parts[1:]])
            except Exception as e:
                raise ValueError(
                    f"Malformed g2o line at {filepath}:{ln}: "
                    f"{line.strip()!r} ({e})"
                ) from e
    if dim is None:
        raise ValueError(f"{filepath} contains no pose vertices")

    fg = FactorGraphData(dimension=dim)
    for i in sorted(poses):
        fg.add_pose_variable(poses[i])
    for i in sorted(landmarks):
        fg.add_landmark_variable(landmarks[i])
    pose_ids = sorted(poses)
    consecutive = {
        (pose_ids[k], pose_ids[k + 1]) for k in range(len(pose_ids) - 1)
    }
    for i, j, m in pose_edges:
        if (i, j) in consecutive:
            fg.add_odom_measurement(m)
        else:
            fg.loop_closure_measurements.append(m)
    for i, j, dist, info in range_edges:
        a = _g2o_pose_name(i) if i in poses else _g2o_lm_name(i)
        b = _g2o_pose_name(j) if j in poses else _g2o_lm_name(j)
        stddev = 1.0 / float(np.sqrt(info)) if info > 0 else 1.0
        fg.add_range_measurement(
            _meas.FGRangeMeasurement((a, b), float(dist), stddev)
        )
    for i, pos, info in lm_priors:
        cls = _priors.LandmarkPrior2D if len(pos) == 2 else _priors.LandmarkPrior3D
        fg.landmark_priors.append(
            cls(_g2o_lm_name(i), tuple(pos), float(info))
        )
    return fg


def save_to_g2o_file(fg: FactorGraphData, filepath: str) -> None:
    """Write a :class:`FactorGraphData` as a g2o graph file (the inverse
    of :func:`parse_g2o_file`; pose/landmark ids follow insertion order)."""
    from score_tpu_torch.utils.matrix import get_quat_from_rotation_matrix

    pose_id = {
        p.name: i
        for i, p in enumerate(pp for chain in fg.pose_variables for pp in chain)
    }
    lm_id = {
        l.name: len(pose_id) + i for i, l in enumerate(fg.landmark_variables)
    }
    lines: List[str] = []
    if fg.dimension == 2:
        for p in (pp for chain in fg.pose_variables for pp in chain):
            lines.append(
                f"VERTEX_SE2 {pose_id[p.name]} {p.true_x:.12g} "
                f"{p.true_y:.12g} {p.true_theta:.12g}"
            )
        for l in fg.landmark_variables:
            lines.append(
                f"VERTEX_XY {lm_id[l.name]} {l.true_x:.12g} {l.true_y:.12g}"
            )
        for m in [x for c in fg.odom_measurements for x in c] + list(
            fg.loop_closure_measurements
        ):
            lines.append(
                f"EDGE_SE2 {pose_id[m.base_pose]} {pose_id[m.to_pose]} "
                f"{m.x:.12g} {m.y:.12g} {m.theta:.12g} "
                f"{m.translation_precision:.12g} 0 0 "
                f"{m.translation_precision:.12g} 0 "
                f"{m.rotation_precision:.12g}"
            )
    else:
        for p in (pp for chain in fg.pose_variables for pp in chain):
            q = get_quat_from_rotation_matrix(np.asarray(p.true_rotation))
            x, y, z = p.true_position
            lines.append(
                f"VERTEX_SE3:QUAT {pose_id[p.name]} {x:.12g} {y:.12g} "
                f"{z:.12g} {q[0]:.12g} {q[1]:.12g} {q[2]:.12g} {q[3]:.12g}"
            )
        for l in fg.landmark_variables:
            x, y, z = l.true_position
            lines.append(
                f"VERTEX_TRACKXYZ {lm_id[l.name]} {x:.12g} {y:.12g} {z:.12g}"
            )
        for m in [x for c in fg.odom_measurements for x in c] + list(
            fg.loop_closure_measurements
        ):
            q = get_quat_from_rotation_matrix(np.asarray(m.rotation))
            t = np.asarray(m.translation)
            info = [0.0] * 21
            info[0] = info[6] = info[11] = m.translation_precision
            info[15] = info[18] = info[20] = m.rotation_precision
            lines.append(
                f"EDGE_SE3:QUAT {pose_id[m.base_pose]} {pose_id[m.to_pose]} "
                f"{t[0]:.12g} {t[1]:.12g} {t[2]:.12g} "
                f"{q[0]:.12g} {q[1]:.12g} {q[2]:.12g} {q[3]:.12g} "
                + " ".join(f"{x:.12g}" for x in info)
            )
    for pr in fg.landmark_priors:
        pos = np.asarray(pr.position, dtype=float)
        tag = "LANDMARK_PRIOR2" if len(pos) == 2 else "LANDMARK_PRIOR3"
        lines.append(
            f"{tag} {lm_id[pr.name]} "
            + " ".join(f"{x:.12g}" for x in pos)
            + f" {pr.translation_precision:.12g}"
        )
    all_ids = {**pose_id, **lm_id}
    for m in fg.range_measurements:
        info = m.precision
        lines.append(
            f"EDGE_RANGE {all_ids[m.first_key]} {all_ids[m.second_key]} "
            f"{m.dist:.12g} {info:.12g}"
        )
    with open(filepath, "w") as f:
        f.write("\n".join(lines) + "\n")
