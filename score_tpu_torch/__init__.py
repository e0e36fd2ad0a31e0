"""score_tpu_torch — the PyTorch/CUDA port of score_tpu.

Range-aided SLAM initialization: a factor graph is compiled into the SOCP
(or ball-constrained QCQP) relaxation and solved by a primal-dual
interior-point method whose chain band runs through hand-written CUDA
kernels on an NVIDIA GPU (plain PyTorch on the CPU). The package mirrors
the module tree and names of ``score_tpu``, which stays the reference;
it imports torch and never jax.

    from score_tpu_torch import ScoreSolverParams, solve_score
    results = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda"))
"""

from score_tpu_torch.api import ScoreSolverParams, solve_score
from score_tpu_torch.fg import (
    FactorGraphData,
    FGRangeMeasurement,
    LandmarkVariable2D,
    PoseMeasurement2D,
    PoseVariable2D,
    SolverResults,
    VariableValues,
)

__version__ = "0.1.0"

SOCP_RELAXATION = "SOCP"
QCQP_RELAXATION = "QCQP"

__all__ = [
    "FactorGraphData",
    "FGRangeMeasurement",
    "PoseMeasurement2D",
    "PoseVariable2D",
    "LandmarkVariable2D",
    "SolverResults",
    "VariableValues",
    "solve_score",
    "ScoreSolverParams",
    "SOCP_RELAXATION",
    "QCQP_RELAXATION",
]
