"""User-facing solver configuration.

Port of :class:`score_tpu.solver.params.ScoreSolverParams`, with the
device the solve runs on as a field of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from score_tpu_torch.solver.ipm import IPMParams

__all__ = ["ScoreSolverParams"]


@dataclasses.dataclass(frozen=True)
class ScoreSolverParams:
    """Configuration for :func:`score_tpu_torch.api.solve_score`."""

    # device every tensor of the solve is created on ("cpu", "cuda",
    # "cuda:1", ...). "cuda" without a card raises; nothing falls back.
    device: str = "cpu"

    verbose: bool = False
    save_results: bool = False
    results_filepath: str = ""

    # interior-point controls
    max_iter: int = 60
    tol_feas: float = 1e-8
    tol_gap_abs: float = 1e-8
    tol_gap_rel: float = 1e-6
    # reduced ("solved to lower accuracy") acceptance; None keeps the
    # IPMParams defaults
    tol_feas_reduced: Optional[float] = None
    tol_gap_reduced: Optional[float] = None
    step_fraction: float = 0.99

    # "auto", "mixed" and "f64" all run in f64 here: the card has native
    # IEEE f64, so the JAX package's two-float band has no counterpart.
    # "f32" is not ported.
    precision: str = "auto"
    kkt_refine_steps: int = 0
    dir_refine_steps: int = 1
    gondzio_correctors: int = 2

    # solve in normalized translation units (exact reparameterization)
    normalize: bool = True

    def ipm_params(self) -> IPMParams:
        if self.precision == "f32":
            raise NotImplementedError(
                'precision="f32" is not ported; "auto", "mixed" and "f64" run in f64'
            )
        if self.precision not in ("auto", "mixed", "f64"):
            raise ValueError(f"Unknown precision {self.precision!r}")
        extra = {}
        if self.tol_feas_reduced is not None:
            extra["tol_feas_reduced"] = self.tol_feas_reduced
        if self.tol_gap_reduced is not None:
            extra["tol_gap_reduced"] = self.tol_gap_reduced
        return IPMParams(
            max_iter=self.max_iter,
            tol_feas=self.tol_feas,
            tol_gap_abs=self.tol_gap_abs,
            tol_gap_rel=self.tol_gap_rel,
            step_fraction=self.step_fraction,
            kkt_refine_steps=self.kkt_refine_steps,
            dir_refine_steps=self.dir_refine_steps,
            gondzio_correctors=self.gondzio_correctors,
            **extra,
        )
