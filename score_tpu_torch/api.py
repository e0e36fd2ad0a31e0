"""Top-level solve API.

Port of :mod:`score_tpu.api`: ``solve_score(data, relaxation_type,
params)`` normalizes the factor graph, assembles the conic program on
``params.device`` (the card by default), runs the interior-point solver
through the chain+arrow backend, rounds every rotation block onto SO(d)
and returns a :class:`SolverResults` in the caller's units. With
``precision="f32"`` the conic problem is cast to float32 after assembly
and the whole solve runs in f32.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from score_tpu_torch.assembly.conic import (
    QCQP_RELAXATION,
    ConicProblem,
    VariableIndex,
    build_conic_problem,
)
from score_tpu_torch.assembly.normalize import normalize_factor_graph, unscale_results
from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.solver_utils import SolverResults, VariableValues, save_results_to_file
from score_tpu_torch.ops.rounding import extract_pose_matrices, homogenize_batched
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
from score_tpu_torch.solver.ipm import SOLVED_STATUSES, IPMResult, solve_conic
from score_tpu_torch.solver.params import ScoreSolverParams

logger = logging.getLogger(__name__)

__all__ = [
    "solve_score",
    "ScoreSolverParams",
    "extract_solver_results",
    "variable_values_from_x",
]


def _device(params: ScoreSolverParams) -> torch.device:
    dev = torch.device(params.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {params.device!r} requested but torch.cuda.is_available() is False"
        )
    return dev


def _select_backend(problem: ConicProblem, idx: VariableIndex):
    """The chain+arrow backend for any graph with a pose chain; the dense
    backend (pose-free graphs) is not ported yet."""
    if idx.num_poses == 0:
        raise NotImplementedError(
            "the dense KKT backend (pose-free graphs) is not ported yet"
        )
    return ChainArrowBackend, build_chain_arrow(problem, idx)


def _check_factor_graph(data: FactorGraphData) -> None:
    """Connectivity precondition: every variable touches a measurement."""
    unconnected = data.unconnected_variable_names
    if unconnected:
        raise ValueError(f"Found {unconnected} unconnected variables. ")


def _values_from_host(xnp: np.ndarray, T: np.ndarray, idx: VariableIndex) -> VariableValues:
    """Named VariableValues from host arrays (flat solution and the
    rounded homogeneous pose matrices)."""
    poses = {name: T[i] for i, name in enumerate(idx.pose_names)}
    landmarks = {
        name: xnp[idx.landmark_cols(i)] for i, name in enumerate(idx.landmark_names)
    }
    distances: Dict[Tuple[str, str], np.ndarray] = {}
    if idx.dist_keys:
        nr = len(idx.dist_keys)
        dvals = (
            xnp[idx.distance_offset: idx.distance_offset + nr * idx.dist_size]
            .reshape(nr, idx.dist_size)
            .copy()
        )
        distances = {tuple(key): dvals[m] for m, key in enumerate(idx.dist_keys)}
    return VariableValues(dim=idx.dim, poses=poses, landmarks=landmarks,
                          distances=distances)


def _round_and_fetch(x: torch.Tensor, idx: VariableIndex):
    """SVD rounding on the solve's device and in its dtype, then ONE
    transfer of the flat solution and the rounded poses to the host, as
    float64."""
    T = homogenize_batched(extract_pose_matrices(x, idx.num_poses, idx.dim))
    buf = torch.cat([x, T.reshape(-1)]).to(torch.float64).cpu().numpy()
    n = x.shape[0]
    return buf[:n], buf[n:].reshape(idx.num_poses, idx.dim + 1, idx.dim + 1)


def variable_values_from_x(x, idx: VariableIndex, device=None) -> VariableValues:
    """Named variable values from a flat solution vector: batched SVD
    rounding of every rotation block, landmark and distance extraction.
    The rounding runs on ``device``; by default on the device of a tensor
    ``x``, and on the card for a host array."""
    if device is None:
        device = x.device if torch.is_tensor(x) else "cuda"
    xt = torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                         dtype=torch.float64, device=device)
    xnp, T = _round_and_fetch(xt, idx)
    return _values_from_host(xnp, T, idx)


def extract_solver_results(result: IPMResult, idx: VariableIndex,
                           data: FactorGraphData, total_time: float,
                           relaxation: str) -> SolverResults:
    """Package an IPM result (rounded poses, named values, telemetry)."""
    xnp, T = _round_and_fetch(result.x, idx)
    return SolverResults(
        variables=_values_from_host(xnp, T, idx),
        total_time=total_time,
        solved=result.status in SOLVED_STATUSES,
        pose_chain_names=data.get_pose_chain_names(),
        iterations=result.iterations,
        primal_objective=result.pobj,
        dual_objective=result.pobj - result.gap,
        gap=result.gap,
        primal_residual=result.pres,
        dual_residual=result.dres,
        relaxation=relaxation,
    )


def solve_score(
    data: FactorGraphData,
    relaxation_type: str = QCQP_RELAXATION,
    params: Optional[ScoreSolverParams] = None,
) -> SolverResults:
    """Solve the SOCP/QCQP relaxation of a range-aided SLAM problem on
    ``params.device`` and return the rounded initialization (default
    relaxation QCQP like the reference)."""
    params = params or ScoreSolverParams()
    _check_factor_graph(data)
    device = _device(params)
    ipm_params = params.ipm_params()

    t0 = time.perf_counter()
    scaled_data, scale = (
        normalize_factor_graph(data) if params.normalize else (data, 1.0)
    )
    problem, idx = build_conic_problem(scaled_data, relaxation_type, device=device)
    if params.precision == "f32":
        problem = problem.cast(torch.float32)
    backend, aux = _select_backend(problem, idx)
    result = solve_conic(problem, ipm_params, backend=backend, backend_aux=aux)
    # the rounding's device-to-host copy is the sync point of the solve
    results = extract_solver_results(result, idx, data, 0.0, relaxation_type)
    results.total_time = time.perf_counter() - t0
    if params.verbose:
        logger.info(
            "solve_score(%s): solved=%s iters=%d pobj=%.6e gap=%.3e "
            "pres=%.3e dres=%.3e time=%.3fs",
            relaxation_type, results.solved, results.iterations,
            results.primal_objective, results.gap, results.primal_residual,
            results.dual_residual, results.total_time,
        )
    results = unscale_results(results, scale)
    if params.save_results and params.results_filepath:
        save_results_to_file(results, params.results_filepath)
    return results
