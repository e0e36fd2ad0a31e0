"""Interior-point solver package: SOC cone algebra, the Mehrotra IPM, and
the dense and chain+arrow KKT backends (the exports of
:mod:`score_tpu.solver`)."""

from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.ipm import (
    OPTIMAL,
    OPTIMAL_INACCURATE,
    SOLVED_STATUSES,
    IPMParams,
    IPMResult,
    solve_conic,
    solve_conic_fixed,
    solve_conic_traced,
    solve_conic_with_iterates,
)
from score_tpu_torch.solver.params import ScoreSolverParams

__all__ = [
    "DenseBackend",
    "IPMParams",
    "IPMResult",
    "OPTIMAL",
    "OPTIMAL_INACCURATE",
    "SOLVED_STATUSES",
    "solve_conic",
    "solve_conic_fixed",
    "solve_conic_traced",
    "solve_conic_with_iterates",
    "ScoreSolverParams",
]
