"""Linear operators derived from a :class:`ConicProblem`.

Port of :mod:`score_tpu.solver.linops`. The sparse row encodings are
applied with gathers and scatter-adds; column index ``n`` is the padding
slot (gathers read a zero-extended vector, scatter-adds land in a
discarded slot). The dense P and G'W^{-2}G of the dense backend are
batched outer products scatter-added (``index_put_(accumulate=True)``)
into a fresh (n + 1, n + 1) tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from score_tpu_torch.assembly.conic import ConicProblem

__all__ = [
    "ProblemOperators",
    "prepare_operators",
    "G_apply",
    "GT_apply",
    "cost_matvec_dense_P",
    "cost_q",
    "cost_constant",
    "gtwg_dense",
    "pin_fix_matrix",
    "pin_vector",
    "free_mask",
]


def _pad(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1,))])


def G_apply(problem: ConicProblem, x: torch.Tensor) -> torch.Tensor:
    """(G x) of shape (N, k)."""
    xp = _pad(x)
    return torch.sum(problem.cone_coefs * xp[problem.cone_cols], dim=-1)


def GT_apply(problem: ConicProblem, z: torch.Tensor) -> torch.Tensor:
    """(G^T z) of shape (n,) for z of shape (N, k)."""
    out = z.new_zeros((problem.n + 1,))
    out.index_put_(
        (problem.cone_cols.reshape(-1),),
        (problem.cone_coefs * z[..., None]).reshape(-1),
        accumulate=True,
    )
    return out[: problem.n]


def _scatter_dense(problem: ConicProblem, rows, cols, vals) -> torch.Tensor:
    """The (n, n) sum of vals at (rows, cols), broadcast together; entries
    on the padding row or column n are dropped."""
    n = problem.n
    out = torch.zeros((n + 1, n + 1), dtype=vals.dtype, device=vals.device)
    out.index_put_((rows.expand(vals.shape), cols.expand(vals.shape)), vals,
                   accumulate=True)
    return out[:n, :n]


def cost_matvec_dense_P(problem: ConicProblem) -> torch.Tensor:
    """Dense P = 2 sum_r w_r a_r a_r^T, shape (n, n)."""
    coefs, cols = problem.cost_coefs, problem.cost_cols
    vals = 2.0 * problem.cost_w[:, None, None] * coefs[:, :, None] * coefs[:, None, :]
    return _scatter_dense(problem, cols[:, :, None], cols[:, None, :], vals)


def cost_q(problem: ConicProblem) -> torch.Tensor:
    """q = -2 sum_r w_r b_r a_r."""
    contrib = -2.0 * (problem.cost_w * problem.cost_b)[:, None] * problem.cost_coefs
    q = torch.zeros(problem.n + 1, dtype=problem.dtype, device=problem.device)
    q.index_put_((problem.cost_cols,), contrib, accumulate=True)
    return q[: problem.n]


def cost_constant(problem: ConicProblem) -> torch.Tensor:
    """c0 + sum_r w_r b_r^2 so that 0.5 x'Px + q'x + const == true cost."""
    return problem.c0 + torch.sum(problem.cost_w * problem.cost_b ** 2)


def gtwg_dense(problem: ConicProblem, Winv2: torch.Tensor) -> torch.Tensor:
    """Dense G^T W^{-2} G from per-cone (N, k, k) middle matrices."""
    coefs, cols = problem.cone_coefs, problem.cone_cols  # (N, k, 2)
    # vals[m, i, a, j, b] = coefs[m,i,a] * Winv2[m,i,j] * coefs[m,j,b]
    vals = torch.einsum("mia,mij,mjb->miajb", coefs, Winv2, coefs)
    return _scatter_dense(problem, cols[:, :, :, None, None], cols[:, None, None, :, :],
                          vals)


def pin_fix_matrix(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero pinned rows/cols of K and put 1 on pinned diagonal entries, so
    that solving K d = (mask * rhs) yields d_pinned = 0: the free-subspace
    Newton step with the gauge pin enforced exactly."""
    Km = K * mask[:, None] * mask[None, :]
    return Km + torch.diag(1.0 - mask)


def free_mask(problem: ConicProblem) -> torch.Tensor:
    """(n,) mask: 1 on free coordinates, 0 on pinned ones."""
    mask = torch.ones(problem.n, dtype=problem.dtype, device=problem.device)
    mask[problem.pin_idx] = 0.0
    return mask


def pin_vector(problem: ConicProblem) -> torch.Tensor:
    """(n,) vector with the pinned values at pinned slots, 0 elsewhere."""
    x = torch.zeros(problem.n, dtype=problem.dtype, device=problem.device)
    x[problem.pin_idx] = problem.pin_val
    return x


class ProblemOperators(NamedTuple):
    """The dense backend's prepared state: the dense objective Hessian and
    the quantities every backend state carries for the solver (q, const,
    mask, xpin, hnorm, qnorm)."""

    P: torch.Tensor  # (n, n) dense Hessian of the objective
    q: torch.Tensor  # (n,)
    const: torch.Tensor  # scalar objective constant
    mask: torch.Tensor  # (n,) free-coordinate mask
    xpin: torch.Tensor  # (n,) pinned values
    hnorm: torch.Tensor  # scalar, max(1, ||h||)
    qnorm: torch.Tensor  # scalar, max(1, ||q||)


def prepare_operators(problem: ConicProblem) -> ProblemOperators:
    q = cost_q(problem)
    one = torch.ones((), dtype=problem.dtype, device=problem.device)
    return ProblemOperators(
        P=cost_matvec_dense_P(problem),
        q=q,
        const=cost_constant(problem),
        mask=free_mask(problem),
        xpin=pin_vector(problem),
        hnorm=torch.maximum(one, torch.linalg.vector_norm(problem.cone_h)),
        qnorm=torch.maximum(one, torch.linalg.vector_norm(q)),
    )
