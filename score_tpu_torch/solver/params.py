"""User-facing solver configuration.

Port of :class:`score_tpu.solver.params.ScoreSolverParams`, with the
device the solve runs on as a field of its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from score_tpu_torch.assembly.initialization import ACCEPTABLE_INIT
from score_tpu_torch.solver.ipm import IPMParams

__all__ = ["ScoreSolverParams", "ACCEPTABLE_BACKENDS"]

ACCEPTABLE_BACKENDS = ("auto", "chain_arrow", "dense")


@dataclasses.dataclass(frozen=True)
class ScoreSolverParams:
    """Configuration for :func:`score_tpu_torch.api.solve_score`."""

    # device every tensor of the solve is created on ("cuda", "cuda:1",
    # "cpu", ...). The card by default: "cuda" without a card raises, and
    # nothing falls back to the CPU.
    device: str = "cuda"

    verbose: bool = False
    save_results: bool = False
    results_filepath: str = ""
    # warm start: "default" is the solver's cold start; random | zero |
    # odom | gt build an x0 (assembly/initialization.py); a custom file is
    # an .npz whose "x" is the flat x0 in normalized units
    init_technique: str = "default"
    custom_init_file: Optional[str] = None

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
    # "f32" is the initializer-grade fast mode: the whole solve in f32,
    # the chain band by cyclic reduction (solver/pcr.py) over the batched
    # block kernels of ops/blocks.py, at reduced tolerances.
    precision: str = "auto"
    kkt_refine_steps: int = 0
    dir_refine_steps: int = 1
    gondzio_correctors: int = 2

    # solve in normalized translation units (exact reparameterization)
    normalize: bool = True

    # run the downstream nonlinear refinement (matrix-free LM on the true
    # MLE objective, score_tpu_torch.refine) on the rounded solution, on
    # the same device
    refine: bool = False
    # optional score_tpu_torch.refine.RefineParams for that stage (robust
    # range kernels etc.); None uses the RefineParams defaults
    refine_params: Optional[object] = None

    # KKT backend: "auto" takes the chain+arrow factorization (every graph
    # the assembly accepts has a pose chain); "dense" the dense Cholesky
    # of K = P + G'W^{-2}G (solver/backend.py), the correctness reference
    backend: str = "auto"

    def __post_init__(self):
        if self.backend not in ACCEPTABLE_BACKENDS:
            raise ValueError(
                f"Unknown backend {self.backend!r}; acceptable: {ACCEPTABLE_BACKENDS}"
            )
        if self.init_technique not in ("default",) + ACCEPTABLE_INIT:
            raise ValueError(
                f"Unknown init technique {self.init_technique!r}; acceptable: "
                f"{('default',) + ACCEPTABLE_INIT}"
            )

    def ipm_params(self) -> IPMParams:
        if self.precision == "f32":
            # f32 reaches ~1e-3..1e-4 relative accuracy: tolerances no
            # tighter than 1e-5, one KKT refinement pass, 1e-2 reduced
            # acceptance and a larger static regularization
            return IPMParams(
                max_iter=self.max_iter,
                tol_feas=max(self.tol_feas, 1e-5),
                tol_gap_abs=max(self.tol_gap_abs, 1e-5),
                tol_gap_rel=max(self.tol_gap_rel, 1e-5),
                step_fraction=self.step_fraction,
                kkt_refine_steps=max(self.kkt_refine_steps, 1),
                dir_refine_steps=self.dir_refine_steps,
                gondzio_correctors=self.gondzio_correctors,
                tol_feas_reduced=(
                    1e-2 if self.tol_feas_reduced is None else self.tol_feas_reduced
                ),
                tol_gap_reduced=(
                    1e-2 if self.tol_gap_reduced is None else self.tol_gap_reduced
                ),
                static_reg=1e-7,
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
