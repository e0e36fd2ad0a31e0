"""Dense KKT backend for the interior-point solver.

Port of :class:`score_tpu.solver.backend.DenseBackend`: the materialized
dense P and dense K = P + G'W^{-2}G, factored by Cholesky. O(n^3) per
iteration; the correctness reference for the chain+arrow backend
(``solver/chain_arrow.py``), reached through
``ScoreSolverParams(backend="dense")``. No Pallas kernel sits behind the
JAX dense path (it is ``jnp.linalg.cholesky``), so the factor and the
triangular solves are PyTorch's library calls on either device.

A backend is a class of static methods; ``prepare`` returns its state,
which the solver reads for q, const, mask, xpin, hnorm and qnorm.

A stacked problem (``score_tpu_torch.parallel``) gives K a leading trial
axis, (B, n, n), factored by one batched ``cholesky_ex``; a lane whose
factor breaks down takes the escalated one by a select on the device
(:func:`score_tpu_torch.solver.chain_arrow.lane_cholesky`), with no host
read, as the JAX package's ``lax.cond`` does under ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from score_tpu_torch.assembly.conic import ConicProblem
from score_tpu_torch.solver.chain_arrow import checked_cholesky, lane_cholesky
from score_tpu_torch.solver.linops import (
    G_apply,
    GT_apply,
    ProblemOperators,
    batch_shape,
    gtwg_dense,
    pin_fix_matrix,
    prepare_operators,
)

__all__ = ["DenseBackend", "chol_solve"]


def chol_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """x with L L^T x = rhs for a vector rhs (a batch of them against a
    batch of factors)."""
    y = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M v, trial by trial where both carry a leading trial axis."""
    return M @ v if v.dim() == 1 else (M @ v[..., None])[..., 0]


def _shifted(K: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """K + shift * I (a copy; the same digits as adding shift * eye), one
    shift a trial over a leading trial axis."""
    A = K.clone()
    A.diagonal(dim1=-2, dim2=-1).add_(shift[..., None] if shift.dim() else shift)
    return A


class _DenseFactors(NamedTuple):
    L: torch.Tensor
    K: torch.Tensor  # true (unregularized) pin-fixed K, for refinement


class DenseBackend:
    """Dense-KKT backend."""

    @staticmethod
    def prepare(problem: ConicProblem, aux=None) -> ProblemOperators:
        return prepare_operators(problem)

    @staticmethod
    def P_matvec(state: ProblemOperators, v):
        return _matvec(state.P, v)

    @staticmethod
    def G(problem: ConicProblem, state, x):
        return G_apply(problem, x)

    @staticmethod
    def GT(problem: ConicProblem, state, z):
        return GT_apply(problem, z)

    @staticmethod
    def factor(problem: ConicProblem, state: ProblemOperators, Winv2, params) -> _DenseFactors:
        K = pin_fix_matrix(state.P + gtwg_dense(problem, Winv2), state.mask)
        if batch_shape(problem):
            delta = params.static_reg * torch.amax(
                torch.abs(torch.diagonal(K, dim1=-2, dim2=-1)), dim=-1)
            L = lane_cholesky(_shifted(K, delta), _shifted(K, params.reg_escalation * delta))
            return _DenseFactors(L=L, K=K)
        delta = params.static_reg * torch.max(torch.abs(torch.diagonal(K)))
        L = checked_cholesky(_shifted(K, delta))
        if L is None:
            # escalated regularization; a second breakdown gives a NaN
            # factor (the JAX backend's NaN-returning cholesky), so the
            # step turns non-finite and the solver reports it
            L = checked_cholesky(_shifted(K, params.reg_escalation * delta))
            if L is None:
                L = torch.full_like(K, float("nan"))
        return _DenseFactors(L=L, K=K)

    @staticmethod
    def solve(problem: ConicProblem, state: ProblemOperators,
              factors: _DenseFactors, rhs, params):
        dx = chol_solve(factors.L, rhs)
        for _ in range(params.kkt_refine_steps):
            resid = rhs - state.mask * _matvec(factors.K, dx)
            dx = dx + chol_solve(factors.L, resid)
        return dx
