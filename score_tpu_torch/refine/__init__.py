"""Downstream nonlinear refinement.

Port of :mod:`score_tpu.refine`: a matrix-free Levenberg-Marquardt
pose-graph/range optimizer (``torch.func`` Jacobian products, conjugate
gradients on the damped normal equations) that consumes the
:class:`~score_tpu_torch.fg.solver_utils.VariableValues` produced by
``solve_score`` and returns the refined maximum-likelihood estimate.
"""

from score_tpu_torch.refine.lm import RefineParams, RefineResult, refine_solution

__all__ = ["RefineParams", "RefineResult", "refine_solution"]
