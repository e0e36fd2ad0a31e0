"""Factor-graph data layer: variables, measurements, priors, the
FactorGraphData container, IO (pickle, g2o, TUM) and solution containers
(host-side numpy, port of :mod:`score_tpu.fg`)."""

from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.io import (
    parse_g2o_file,
    parse_pickle_file,
    parse_tum_file,
    save_to_g2o_file,
    save_to_pickle_file,
)
from score_tpu_torch.fg.measurements import (
    AmbiguousFGRangeMeasurement,
    AmbiguousPoseMeasurement2D,
    FGRangeMeasurement,
    POSE_MEASUREMENT_TYPES,
    PoseMeasurement2D,
    PoseMeasurement3D,
)
from score_tpu_torch.fg.priors import (
    LandmarkPrior2D,
    LandmarkPrior3D,
    PosePrior2D,
    PosePrior3D,
)
from score_tpu_torch.fg.solver_utils import (
    SolverResults,
    VariableValues,
    save_results_to_file,
    save_to_tum,
)
from score_tpu_torch.fg.variables import (
    LANDMARK_VARIABLE_TYPES,
    LandmarkVariable2D,
    LandmarkVariable3D,
    POSE_VARIABLE_TYPES,
    PoseVariable2D,
    PoseVariable3D,
)

__all__ = [
    "FactorGraphData",
    "parse_g2o_file",
    "parse_pickle_file",
    "parse_tum_file",
    "save_to_g2o_file",
    "save_to_pickle_file",
    "FGRangeMeasurement",
    "PoseMeasurement2D",
    "PoseMeasurement3D",
    "AmbiguousPoseMeasurement2D",
    "AmbiguousFGRangeMeasurement",
    "POSE_MEASUREMENT_TYPES",
    "PosePrior2D",
    "PosePrior3D",
    "LandmarkPrior2D",
    "LandmarkPrior3D",
    "SolverResults",
    "VariableValues",
    "save_to_tum",
    "save_results_to_file",
    "PoseVariable2D",
    "PoseVariable3D",
    "LandmarkVariable2D",
    "LandmarkVariable3D",
    "POSE_VARIABLE_TYPES",
    "LANDMARK_VARIABLE_TYPES",
]
