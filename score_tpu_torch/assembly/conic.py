"""Compile a :class:`FactorGraphData` into a standard-form conic program.

Port of :mod:`score_tpu.assembly.conic`. The relaxations (semantics parity
with the reference's score/utils/gurobi_utils.py):

    minimize    0.5 x^T P x + q^T x + c0
    subject to  G x + s = h,   s in K = SOC(k) x ... x SOC(k)

with x = [poses | landmarks | distances] and per-pose blocks the free
d x (d+1) matrix [R | t]. The first pose of the first chain is pinned to
[I | 0] by freezing its coordinates in the KKT system.

Cost terms, each a weighted least-squares row  w * (a^T x - b)^2 :

  * odometry / loop closure:  k_ij ||t_j - t_i - R_i t_ij||^2
                            + tau_ij ||R_j - R_i R_ij||_F^2
  * range SOCP:  precision * (d_ij - dist)^2
  * range QCQP:  precision * ||t_i - t_j - dist * d_ij||^2
  * landmark priors: precision * ||l - prior||^2

Cones, all of width k = d + 1:

  * SOCP:  s = (d_ij, t_i - t_j) in SOC  <=>  ||t_i - t_j|| <= d_ij
  * QCQP:  s = (1, d_ij) in SOC          <=>  ||d_ij|| <= 1

The rows are emitted host-side in numpy (the Python emission path of the
JAX package, identical row order) and moved once to the target device as
torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from score_tpu_torch.fg.factor_graph import FactorGraphData

SOCP_RELAXATION = "SOCP"
QCQP_RELAXATION = "QCQP"
ACCEPTABLE_RELAXATIONS = (SOCP_RELAXATION, QCQP_RELAXATION)

__all__ = [
    "ConicProblem",
    "VariableIndex",
    "build_conic_problem",
    "evaluate_objective",
    "SOCP_RELAXATION",
    "QCQP_RELAXATION",
]


def _check_valid_relaxation(relaxation: str) -> None:
    if relaxation not in ACCEPTABLE_RELAXATIONS:
        raise ValueError(
            f"Relaxation {relaxation} is not supported. "
            f"Acceptable relaxations are {list(ACCEPTABLE_RELAXATIONS)}"
        )


@dataclasses.dataclass(frozen=True)
class VariableIndex:
    """Host-side name <-> column-range bookkeeping.

    Column layout (all 0-based, dense, no gaps):
      pose p (global chain order):  [p*D, (p+1)*D) with D = d*(d+1),
          column-major within the pose block: R[r, c] -> p*D + c*d + r,
          t[r] -> p*D + d*d + r.
      landmark l: L0 + l*d + r
      distance m: D0 + m (SOCP scalar) or D0 + m*d + r (QCQP vector)
    """

    dim: int
    relaxation: str
    pose_names: Tuple[str, ...]
    landmark_names: Tuple[str, ...]
    dist_keys: Tuple[Tuple[str, str], ...]
    chain_lengths: Tuple[int, ...]
    # (base_pose, to_pose) name pairs of loop-closure measurements, in
    # cost-row emission order
    loop_pairs: Tuple[Tuple[str, str], ...] = ()

    @property
    def num_poses(self) -> int:
        return len(self.pose_names)

    @property
    def num_landmarks(self) -> int:
        return len(self.landmark_names)

    @property
    def num_ranges(self) -> int:
        return len(self.dist_keys)

    @property
    def pose_block(self) -> int:
        return self.dim * (self.dim + 1)

    @property
    def landmark_offset(self) -> int:
        return self.num_poses * self.pose_block

    @property
    def distance_offset(self) -> int:
        return self.landmark_offset + self.num_landmarks * self.dim

    @property
    def dist_size(self) -> int:
        return 1 if self.relaxation == SOCP_RELAXATION else self.dim

    @property
    def num_cols(self) -> int:
        return self.distance_offset + self.num_ranges * self.dist_size

    def pose_index(self, name: str) -> int:
        return self._pose_lookup[name]

    def landmark_index(self, name: str) -> int:
        return self._landmark_lookup[name]

    def __post_init__(self):
        object.__setattr__(
            self, "_pose_lookup", {n: i for i, n in enumerate(self.pose_names)}
        )
        object.__setattr__(
            self,
            "_landmark_lookup",
            {n: i for i, n in enumerate(self.landmark_names)},
        )

    def rot_col(self, pose_idx: int, r: int, c: int) -> int:
        return pose_idx * self.pose_block + c * self.dim + r

    def trans_cols(self, pose_idx: int) -> np.ndarray:
        base = pose_idx * self.pose_block + self.dim * self.dim
        return np.arange(base, base + self.dim)

    def landmark_cols(self, lm_idx: int) -> np.ndarray:
        base = self.landmark_offset + lm_idx * self.dim
        return np.arange(base, base + self.dim)

    def translation_cols(self, name: str) -> np.ndarray:
        """Columns of the translation of a pose OR landmark (pose first)."""
        if name in self._pose_lookup:
            return self.trans_cols(self._pose_lookup[name])
        if name in self._landmark_lookup:
            return self.landmark_cols(self._landmark_lookup[name])
        raise ValueError(f"Variable name {name} not found")

    def dist_cols(self, m: int) -> np.ndarray:
        base = self.distance_offset + m * self.dist_size
        return np.arange(base, base + self.dist_size)

    def pose_slice(self, name: str) -> slice:
        p = self._pose_lookup[name]
        return slice(p * self.pose_block, (p + 1) * self.pose_block)


# fields of ConicProblem holding integer column indices / float values
_INT_FIELDS = ("cost_cols", "cone_cols", "pin_idx")
_FLOAT_FIELDS = ("cost_coefs", "cost_b", "cost_w", "cone_coefs", "cone_h",
                 "pin_val", "c0")


@dataclasses.dataclass(frozen=True)
class ConicProblem:
    """A conic program held as torch tensors on one device.

    Cost:  sum_r cost_w[r] * (sum_j cost_coefs[r, j] * x[cost_cols[r, j]]
           - cost_b[r])^2 + c0,
    Cones: s = cone_h - (G x) with
           (G x)[m, i] = sum_j cone_coefs[m, i, j] * x[cone_cols[m, i, j]],
           and every s[m] in SOC(k).

    Column index ``n`` is a padding slot (reads as 0, writes discarded).
    Index tensors are int64; value tensors float64, or float32 after
    :meth:`cast` (the f32 fast mode).
    """

    cost_cols: torch.Tensor  # (R, NNZ) int64, padded with n
    cost_coefs: torch.Tensor  # (R, NNZ)
    cost_b: torch.Tensor  # (R,)
    cost_w: torch.Tensor  # (R,)
    cone_cols: torch.Tensor  # (N, k, 2) int64, padded with n
    cone_coefs: torch.Tensor  # (N, k, 2)
    cone_h: torch.Tensor  # (N, k)
    pin_idx: torch.Tensor  # (npin,) int64
    pin_val: torch.Tensor  # (npin,)
    c0: torch.Tensor  # scalar
    n: int
    k: int
    dim: int
    relaxation: str

    @property
    def num_cones(self) -> int:
        return self.cone_h.shape[0]

    @property
    def num_cost_rows(self) -> int:
        return self.cost_b.shape[0]

    @property
    def device(self) -> torch.device:
        return self.cost_coefs.device

    @property
    def dtype(self) -> torch.dtype:
        return self.cost_coefs.dtype

    @classmethod
    def from_arrays(cls, arrays, n: int, k: int, dim: int, relaxation: str,
                    device) -> "ConicProblem":
        """Build from host arrays: ``arrays`` maps every field name to
        anything ``np.asarray`` accepts. Value arrays keep a float32 or
        float64 dtype; anything else becomes float64."""
        vals = {}
        for name in _INT_FIELDS:
            vals[name] = torch.as_tensor(
                np.asarray(arrays[name], dtype=np.int64), device=device
            )
        for name in _FLOAT_FIELDS:
            a = np.array(arrays[name])  # a writable copy
            if a.dtype not in (np.float32, np.float64):
                a = a.astype(np.float64)
            vals[name] = torch.as_tensor(a, device=device)
        return cls(n=int(n), k=int(k), dim=int(dim), relaxation=relaxation,
                   **vals)

    def cast(self, dtype: torch.dtype) -> "ConicProblem":
        """The same problem with every value tensor in ``dtype`` (the
        counterpart of ``score_tpu.api._cast_problem``)."""
        return dataclasses.replace(
            self, **{name: getattr(self, name).to(dtype) for name in _FLOAT_FIELDS}
        )


def _flatten_pose_measurements(fg: FactorGraphData):
    """All relative-pose measurements: odometry chains flattened, then loop
    closures (the cost treats them identically)."""
    out = []
    for chain in fg.odom_measurements:
        out.extend(chain)
    out.extend(fg.loop_closure_measurements)
    return out


def build_conic_problem(
    fg: FactorGraphData,
    relaxation: str = SOCP_RELAXATION,
    device="cuda",
) -> Tuple[ConicProblem, VariableIndex]:
    """Host-side compilation of a factor graph into a float64 ConicProblem
    whose tensors live on ``device`` (the card unless the caller names
    another)."""
    _check_valid_relaxation(relaxation)
    dtype = np.float64
    d = fg.dimension
    keys = [(r.first_key, r.second_key) for r in fg.range_measurements]
    if len(keys) != len(set(keys)):
        raise ValueError("Duplicate range-measurement associations found")
    idx = VariableIndex(
        dim=d,
        relaxation=relaxation,
        pose_names=tuple(p.name for chain in fg.pose_variables for p in chain),
        landmark_names=tuple(l.name for l in fg.landmark_variables),
        dist_keys=tuple(
            (r.first_key, r.second_key) for r in fg.range_measurements
        ),
        chain_lengths=tuple(len(c) for c in fg.pose_variables),
        loop_pairs=tuple(
            (m.base_pose, m.to_pose) for m in fg.loop_closure_measurements
        ),
    )
    n = idx.num_cols
    nnz = d + 2  # widest row: 3D translation term (t_j, t_i, 3x R_i entries)

    rows_cols: List[np.ndarray] = []
    rows_coefs: List[np.ndarray] = []
    rows_b: List[np.ndarray] = []
    rows_w: List[np.ndarray] = []

    def add_row(cols, coefs, b, w):
        pc = np.full(nnz, n, dtype=np.int64)
        pv = np.zeros(nnz, dtype=dtype)
        pc[: len(cols)] = cols
        pv[: len(coefs)] = coefs
        rows_cols.append(pc)
        rows_coefs.append(pv)
        rows_b.append(np.asarray(b, dtype=dtype))
        rows_w.append(np.asarray(w, dtype=dtype))

    # ---- relative-pose costs (odometry + loop closures) -------------- #
    for meas in _flatten_pose_measurements(fg):
        pi = idx.pose_index(meas.base_pose)
        pj = idx.pose_index(meas.to_pose)
        Rm = np.asarray(meas.rotation_matrix, dtype=dtype)
        tm = np.asarray(meas.translation_vector, dtype=dtype)
        tau = float(meas.rotation_precision)
        kij = float(meas.translation_precision)
        # rotation rows: (R_j - R_i Rm)[r, c]
        for c in range(d):
            for r in range(d):
                cols = [idx.rot_col(pj, r, c)] + [
                    idx.rot_col(pi, r, kk) for kk in range(d)
                ]
                coefs = [1.0] + [-Rm[kk, c] for kk in range(d)]
                add_row(cols, coefs, 0.0, tau)
        # translation rows: (t_j - t_i - R_i tm)[r]
        ti = idx.trans_cols(pi)
        tj = idx.trans_cols(pj)
        for r in range(d):
            cols = [tj[r], ti[r]] + [idx.rot_col(pi, r, kk) for kk in range(d)]
            coefs = [1.0, -1.0] + [-tm[kk] for kk in range(d)]
            add_row(cols, coefs, 0.0, kij)

    # ---- range costs (vectorized: ranges are the largest row family) -- #
    M_r = len(fg.range_measurements)
    if M_r:
        prec_v = np.array(
            [float(m.precision) for m in fg.range_measurements], dtype=dtype
        )
        dist_v = np.array(
            [float(m.dist) for m in fg.range_measurements], dtype=dtype
        )
        ta_v = np.stack(
            [idx.translation_cols(m.first_key) for m in fg.range_measurements]
        )
        tb_v = np.stack(
            [idx.translation_cols(m.second_key) for m in fg.range_measurements]
        )
        dcols_v = idx.distance_offset + np.arange(
            M_r * idx.dist_size, dtype=np.int64
        ).reshape(M_r, idx.dist_size)
        if relaxation == SOCP_RELAXATION:
            pc = np.full((M_r, nnz), n, dtype=np.int64)
            pv = np.zeros((M_r, nnz), dtype=dtype)
            pc[:, 0] = dcols_v[:, 0]
            pv[:, 0] = 1.0
            rows_cols.extend(pc)
            rows_coefs.extend(pv)
            rows_b.extend(dist_v)
            rows_w.extend(prec_v)
        else:
            pc = np.full((M_r, d, nnz), n, dtype=np.int64)
            pv = np.zeros((M_r, d, nnz), dtype=dtype)
            pc[:, :, 0] = ta_v
            pc[:, :, 1] = tb_v
            pc[:, :, 2] = dcols_v
            pv[:, :, 0] = 1.0
            pv[:, :, 1] = -1.0
            pv[:, :, 2] = -dist_v[:, None]
            rows_cols.extend(pc.reshape(M_r * d, nnz))
            rows_coefs.extend(pv.reshape(M_r * d, nnz))
            rows_b.extend(np.zeros(M_r * d, dtype=dtype))
            rows_w.extend(np.repeat(prec_v, d))

    # ---- landmark priors ---------------------------------------------- #
    for prior in fg.landmark_priors:
        lcols = idx.translation_cols(prior.name)
        pv = np.asarray(prior.translation_vector, dtype=dtype)
        prec = float(prior.translation_precision)
        for r in range(d):
            add_row([lcols[r]], [1.0], pv[r], prec)

    # ---- cones (vectorized over the M ranges) -------------------------- #
    k = d + 1
    N = idx.num_ranges
    cone_cols = np.full((N, k, 2), n, dtype=np.int64)
    cone_coefs = np.zeros((N, k, 2), dtype=dtype)
    cone_h = np.zeros((N, k), dtype=dtype)
    if N:
        if relaxation == SOCP_RELAXATION:
            # s = (d_m, t_a - t_b) in SOC
            cone_cols[:, 0, 0] = dcols_v[:, 0]
            cone_coefs[:, 0, 0] = -1.0
            cone_cols[:, 1:, 0] = ta_v
            cone_coefs[:, 1:, 0] = -1.0
            cone_cols[:, 1:, 1] = tb_v
            cone_coefs[:, 1:, 1] = 1.0
        else:
            # s = (1, d_m) in SOC  <=>  ||d_m|| <= 1
            cone_h[:, 0] = 1.0
            cone_cols[:, 1:, 0] = dcols_v
            cone_coefs[:, 1:, 0] = -1.0

    # ---- gauge pin: first pose of the first nonempty chain ------------- #
    first_chain = next(c for c in fg.pose_variables if c)
    pin_slice = idx.pose_slice(first_chain[0].name)
    pin_idx = np.arange(pin_slice.start, pin_slice.stop, dtype=np.int64)
    # [I | 0] in the column-major pose layout: R[r, c] = (r == c), t = 0.
    pin_val = np.zeros(idx.pose_block, dtype=dtype)
    for c in range(d):
        pin_val[c * d + c] = 1.0

    if rows_cols:
        arrays = dict(
            cost_cols=np.stack(rows_cols),
            cost_coefs=np.stack(rows_coefs),
            cost_b=np.stack(rows_b),
            cost_w=np.stack(rows_w),
        )
    else:  # pathological empty graph
        arrays = dict(
            cost_cols=np.zeros((0, nnz), dtype=np.int64),
            cost_coefs=np.zeros((0, nnz), dtype=dtype),
            cost_b=np.zeros((0,), dtype=dtype),
            cost_w=np.zeros((0,), dtype=dtype),
        )
    arrays.update(
        cone_cols=cone_cols, cone_coefs=cone_coefs, cone_h=cone_h,
        pin_idx=pin_idx, pin_val=pin_val, c0=np.asarray(0.0, dtype=dtype),
    )
    problem = ConicProblem.from_arrays(
        arrays, n=n, k=k, dim=d, relaxation=relaxation, device=device
    )
    return problem, idx


def evaluate_objective(problem: ConicProblem, x) -> float:
    """Host evaluation of the cost at x (a numpy array or a tensor on any
    device), in float64: the ground truth the parity tests hold the
    solver's objective to."""
    x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    host = {name: getattr(problem, name).detach().cpu().numpy()
            for name in ("cost_cols", "cost_coefs", "cost_b", "cost_w", "c0")}
    xpad = np.concatenate([x, [0.0]])
    ax = (host["cost_coefs"] * xpad[host["cost_cols"]]).sum(axis=1)
    r = ax - host["cost_b"]
    return float((host["cost_w"] * r * r).sum() + host["c0"])
