"""score_tpu_torch — the PyTorch/CUDA port of score_tpu.

Range-aided SLAM initialization: a factor graph is compiled into the SOCP
(or ball-constrained QCQP) relaxation and solved by a primal-dual
interior-point method whose chain band runs through hand-written CUDA
kernels on an NVIDIA GPU (plain PyTorch on the CPU). The package mirrors
the module tree and names of ``score_tpu``, which stays the reference;
it imports torch and never jax.

    from score_tpu_torch import ScoreSolverParams, parse_pickle_file, solve_score
    fg = parse_pickle_file("factor_graph.pickle")
    results = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda"))
    refined = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda", refine=True))
"""

from score_tpu_torch.api import (
    ScoreSolverParams,
    solve_problem_with_intermediate_iterates,
    solve_score,
)
from score_tpu_torch.assembly.conic import (
    ACCEPTABLE_RELAXATIONS,
    QCQP_RELAXATION,
    SOCP_RELAXATION,
)
from score_tpu_torch.assembly.initialization import (
    ACCEPTABLE_INIT,
    GT_INIT,
    ODOM_INIT,
    RANDOM_INIT,
    ZERO_INIT,
)
from score_tpu_torch.fg import (
    FactorGraphData,
    FGRangeMeasurement,
    LandmarkVariable2D,
    LandmarkVariable3D,
    PoseMeasurement2D,
    PoseMeasurement3D,
    PoseVariable2D,
    PoseVariable3D,
    SolverResults,
    VariableValues,
    parse_pickle_file,
    save_to_tum,
)
from score_tpu_torch.refine import RefineParams, RefineResult, refine_solution

__version__ = "0.1.0"


__all__ = [
    "FactorGraphData",
    "FGRangeMeasurement",
    "PoseMeasurement2D",
    "PoseMeasurement3D",
    "PoseVariable2D",
    "PoseVariable3D",
    "LandmarkVariable2D",
    "LandmarkVariable3D",
    "SolverResults",
    "VariableValues",
    "parse_pickle_file",
    "save_to_tum",
    "solve_score",
    "solve_problem_with_intermediate_iterates",
    "ScoreSolverParams",
    "refine_solution",
    "RefineParams",
    "RefineResult",
    "SOCP_RELAXATION",
    "QCQP_RELAXATION",
    "ACCEPTABLE_RELAXATIONS",
    "RANDOM_INIT",
    "ZERO_INIT",
    "ODOM_INIT",
    "GT_INIT",
    "ACCEPTABLE_INIT",
]
