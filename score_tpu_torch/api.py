"""Top-level solve API.

Port of :mod:`score_tpu.api`: ``solve_score(data, relaxation_type,
params)`` normalizes the factor graph, assembles the conic program on
``params.device`` (the card by default), runs the interior-point solver
through the chain+arrow backend (or the dense one on request), rounds
every rotation block onto SO(d) and returns a :class:`SolverResults` in
the caller's units; with ``params.refine`` the rounded solution is then
refined on the same device (:mod:`score_tpu_torch.refine`).
``solve_problem_with_intermediate_iterates`` returns one result per
interior-point iteration. With ``precision="f32"`` the
conic problem is cast to float32 after assembly and the whole solve runs
in f32.

Normalization, assembly and the backend's ``prepare`` are memoized per
factor graph (:func:`_prepare_assembly`), so a repeated solve of the same
graph pays solver time only.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from score_tpu_torch.assembly.conic import (
    QCQP_RELAXATION,
    ConicProblem,
    VariableIndex,
    build_conic_problem,
)
from score_tpu_torch.assembly.initialization import build_initial_x
from score_tpu_torch.assembly.normalize import normalize_factor_graph, unscale_results
from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.solver_utils import SolverResults, VariableValues, save_results_to_file
from score_tpu_torch.ops.rounding import extract_pose_matrices, homogenize_batched
from score_tpu_torch.solver import cones
from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
from score_tpu_torch.solver.ipm import (
    SOLVED_STATUSES,
    IPMResult,
    solve_conic,
    solve_conic_with_iterates,
)
from score_tpu_torch.solver.linops import G_apply
from score_tpu_torch.solver.params import ScoreSolverParams

logger = logging.getLogger(__name__)

__all__ = [
    "solve_score",
    "solve_problem_with_intermediate_iterates",
    "ScoreSolverParams",
    "extract_solver_results",
    "variable_values_from_x",
]


def _device(device) -> torch.device:
    """The device a solve or a refinement runs on: "cuda" resolved to the
    current card's index; without a card "cuda" raises, and nothing falls
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _select_backend(data: FactorGraphData, problem: ConicProblem, idx: VariableIndex,
                    params: ScoreSolverParams):
    """Resolve the KKT backend: the chain+arrow structured factorization
    (2D and 3D, loop closures handled as arrow blocks), dense Cholesky on
    explicit request or for pose-free graphs. "auto", "mixed" and "f64"
    precision all take the f64 chain+arrow backend (the card has native
    f64; "f32" casts the problem before this point)."""
    choice = params.backend  # validated by ScoreSolverParams
    supported = idx.num_poses > 0
    if choice == "dense" or (choice == "auto" and not supported):
        return DenseBackend, None
    if not supported:
        raise ValueError(
            "chain_arrow backend requires at least one pose chain; "
            "use backend='dense'"
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


def _build_warm_start(scaled_data, problem: ConicProblem, idx: VariableIndex,
                      params: ScoreSolverParams, scale: float = 1.0):
    """Realize init_technique / custom_init_file: construct x0 on the
    problem's device and in its dtype, take s0 = h - G x0 and z0 = e
    (shifted to the interior by the solver)."""
    technique = params.init_technique
    if technique == "default" and not params.custom_init_file:
        return None
    if params.custom_init_file:
        with np.load(params.custom_init_file) as f:
            x0 = np.asarray(f["x"], dtype=np.float64)
    else:
        x0 = build_initial_x(scaled_data, problem, idx, technique)
        if scale != 1.0 and technique in ("gt", "random"):
            # ground-truth / world-bounds values live in ORIGINAL units;
            # the problem is solved in normalized units (odometry
            # dead-reckoning already composes scaled measurements)
            for pidx in range(idx.num_poses):
                x0[np.asarray(idx.trans_cols(pidx))] /= scale
            for l in range(idx.num_landmarks):
                x0[np.asarray(idx.landmark_cols(l))] /= scale
            if idx.relaxation == "SOCP":
                for m in range(idx.num_ranges):
                    x0[np.asarray(idx.dist_cols(m))] /= scale
    x0 = torch.as_tensor(x0, dtype=problem.dtype, device=problem.device)
    s0 = problem.cone_h - G_apply(problem, x0)
    z0 = cones.soc_identity(problem.num_cones, problem.k, x0.dtype, x0.device)
    return (x0, s0, z0)


def _data_fingerprint(data: FactorGraphData) -> tuple:
    """Content-complete memo key: one digest over every measurement's
    endpoints and numeric values (odometry, loop closures, ranges, and the
    cost-carrying landmark priors), so in-place mutation of ANY
    measurement (a middle range or an odometry value, with unchanged
    counts) invalidates the entry. One pass over the host measurement
    lists per call."""
    h = hashlib.blake2b(digest_size=16)

    def upd(v) -> None:
        h.update(v if isinstance(v, bytes) else repr(v).encode())

    def upd_pose_meas(ms) -> None:
        for m in ms:
            upd(m.base_pose)
            upd(m.to_pose)
            if hasattr(m, "x"):  # 2D
                upd((m.x, m.y, m.theta, m.translation_precision,
                     m.rotation_precision))
            else:  # 3D
                upd(np.asarray(m.translation, np.float64).tobytes())
                upd(np.asarray(m.rotation, np.float64).tobytes())
                upd((m.translation_precision, m.rotation_precision))

    upd((data.dimension, data.num_poses, data.num_landmarks))
    for chain in data.odom_measurements:
        upd_pose_meas(chain)
    upd_pose_meas(data.loop_closure_measurements)
    for r in data.range_measurements:
        upd(r.association)
        upd((r.dist, r.stddev))
    for p in data.landmark_priors:
        upd(p.name)
        upd(np.asarray(p.translation_vector, np.float64).tobytes())
        upd(p.translation_precision)
    return (
        data.num_poses,
        data.num_landmarks,
        data.num_odom_measurements,
        len(data.range_measurements),
        len(data.loop_closure_measurements),
        h.hexdigest(),
    )


# Assembly memo: repeated solves of one FactorGraphData (Monte-Carlo
# re-solves, parameter sweeps, warm starts) skip normalizing, assembling,
# uploading and preparing the conic problem; the entry's tensors stay on
# their device. Keyed on id(data), checked against the content
# fingerprint (object reuse at the same address, in-place mutation), and
# within a graph on (relaxation, normalize, precision, backend, device).
# At most _ASSEMBLY_CACHE_MAX graphs, least recently used evicted first.
# Entries are never written after insertion (no backend writes its
# prepared state or the problem in place), so the lock guards only the
# dict operations.
_ASSEMBLY_CACHE: Dict[int, Tuple[tuple, dict]] = {}
_ASSEMBLY_CACHE_MAX = 8
_ASSEMBLY_CACHE_LOCK = threading.Lock()


def _prepare_assembly(data: FactorGraphData, relaxation_type: str,
                      params: ScoreSolverParams):
    """Normalize + assemble + structure-build + backend prepare, memoized
    per factor graph. Returns (scaled_data, scale, problem, idx, backend,
    backend_aux, prepared)."""
    device = _device(params.device)
    key = (relaxation_type, params.normalize, params.precision, params.backend, device)
    fp = _data_fingerprint(data)
    with _ASSEMBLY_CACHE_LOCK:
        hit = _ASSEMBLY_CACHE.get(id(data))
        if hit is not None and hit[0] == fp and key in hit[1]:
            # LRU touch: reinsert so eviction pops the stalest graph
            _ASSEMBLY_CACHE[id(data)] = _ASSEMBLY_CACHE.pop(id(data))
            return hit[1][key]

    scaled_data, scale = (
        normalize_factor_graph(data) if params.normalize else (data, 1.0)
    )
    problem, idx = build_conic_problem(scaled_data, relaxation_type, device=device)
    if params.precision == "f32":
        problem = problem.cast(torch.float32)
    backend, backend_aux = _select_backend(data, problem, idx, params)
    prepared = backend.prepare(problem, backend_aux)
    entry = (scaled_data, scale, problem, idx, backend, backend_aux, prepared)
    with _ASSEMBLY_CACHE_LOCK:
        hit = _ASSEMBLY_CACHE.pop(id(data), None)
        if hit is None or hit[0] != fp:
            while len(_ASSEMBLY_CACHE) >= _ASSEMBLY_CACHE_MAX:
                _ASSEMBLY_CACHE.pop(next(iter(_ASSEMBLY_CACHE)))
            hit = (fp, {})
        hit[1][key] = entry
        _ASSEMBLY_CACHE[id(data)] = hit
    return entry


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
    ipm_params = params.ipm_params()

    t0 = time.perf_counter()
    scaled_data, scale, problem, idx, backend, aux, prepared = _prepare_assembly(
        data, relaxation_type, params)
    warm_start = _build_warm_start(scaled_data, problem, idx, params, scale)
    result = solve_conic(problem, ipm_params, backend=backend, backend_aux=aux,
                         warm_start=warm_start, prepared=prepared)
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
    if params.refine:
        # downstream nonlinear refinement of the rounded initialization, in
        # the caller's units and on the solve's device
        from score_tpu_torch.refine import RefineParams, refine_solution

        refined = refine_solution(data, results.variables,
                                  params.refine_params or RefineParams(),
                                  device=params.device)
        results = dataclasses.replace(results, variables=refined.values,
                                      total_time=time.perf_counter() - t0)
    if params.save_results and params.results_filepath:
        save_results_to_file(results, params.results_filepath)
    return results


def solve_problem_with_intermediate_iterates(
    data: FactorGraphData,
    relaxation_type: str = QCQP_RELAXATION,
    params: Optional[ScoreSolverParams] = None,
) -> List[SolverResults]:
    """Return a SolverResults snapshot per interior-point iteration: the
    solver's iterates recorded in one solve (the starting point first),
    through the same normalization, precision and warm start as
    :func:`solve_score`, so the last snapshot IS its result."""
    logger.warning(
        "Solving with intermediate iterates - this is for debugging or "
        "visualization; use solve_score() otherwise"
    )
    params = params or ScoreSolverParams()
    _check_factor_graph(data)
    ipm_params = params.ipm_params()
    t0 = time.perf_counter()
    scaled_data, scale, problem, idx, backend, aux, prepared = _prepare_assembly(
        data, relaxation_type, params)
    warm_start = _build_warm_start(scaled_data, problem, idx, params, scale)
    result, xs, ms = solve_conic_with_iterates(
        problem, ipm_params, num_iters=params.max_iter, backend=backend,
        backend_aux=aux, warm_start=warm_start, prepared=prepared,
    )
    n_iters = result.iterations
    # one host copy of the metrics; the last snapshot is the result's
    # (best) iterate, the same vector solve_score extracts
    ms = ms[:n_iters].to(torch.float64).cpu().numpy()
    total_time = time.perf_counter() - t0

    out: List[SolverResults] = []
    chains = data.get_pose_chain_names()
    for it in range(n_iters + 1):
        if it == n_iters:
            x_it = result.x
            pres, dres, gap, pobj, status = (result.pres, result.dres, result.gap,
                                             result.pobj, result.status)
        else:
            x_it = xs[it]
            pres, dres, gap, pobj = (float(v) for v in ms[it, :4])
            status = int(ms[it, 4])
        xnp, T = _round_and_fetch(x_it, idx)
        out.append(
            unscale_results(
                SolverResults(
                    variables=_values_from_host(xnp, T, idx),
                    total_time=total_time,
                    solved=status in SOLVED_STATUSES,
                    pose_chain_names=chains,
                    iterations=it,
                    primal_objective=pobj,
                    dual_objective=pobj - gap,
                    gap=gap,
                    primal_residual=pres,
                    dual_residual=dres,
                    relaxation=relaxation_type,
                ),
                scale,
            )
        )
    return out
