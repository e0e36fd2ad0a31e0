"""Linear operators derived from a :class:`ConicProblem`.

Port of :mod:`score_tpu.solver.linops`. The sparse row encodings are
applied with gathers and scatter-adds; column index ``n`` is the padding
slot (gathers read a zero-extended vector, scatter-adds land in a
discarded slot). The dense P and G'W^{-2}G of the dense backend are
batched outer products scatter-added (``index_put_(accumulate=True)``)
into a fresh (n + 1, n + 1) tensor.

A stacked problem (``score_tpu_torch.parallel.stack_problems``: every
field with a leading trial axis) gives every operator and quantity one
leading trial axis too; :func:`batch_shape` tells the two apart. On an
unstacked problem each function runs the ops it always did.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from score_tpu_torch.assembly.conic import ConicProblem

__all__ = [
    "batch_shape",
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


def batch_shape(problem: ConicProblem) -> tuple:
    """() for a problem, (B,) for B stacked trials."""
    return tuple(problem.cone_h.shape[:-2])


def _trials(problem: ConicProblem, ndim: int) -> torch.Tensor:
    """The trial index of a stacked problem, (B,) + (1,) * ndim, to index
    a per-trial tensor beside ``ndim`` more index dimensions."""
    B = problem.cone_h.shape[0]
    return torch.arange(B, device=problem.device).reshape((B,) + (1,) * ndim)


def _pad(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (1,))], dim=-1)


def G_apply(problem: ConicProblem, x: torch.Tensor) -> torch.Tensor:
    """(G x) of shape (N, k), or (B, N, k) for x (B, n)."""
    xp = _pad(x)
    if batch_shape(problem):
        cols = problem.cone_cols
        gx = torch.gather(xp, -1, cols.reshape(cols.shape[0], -1)).reshape(cols.shape)
        return torch.sum(problem.cone_coefs * gx, dim=-1)
    return torch.sum(problem.cone_coefs * xp[problem.cone_cols], dim=-1)


def GT_apply(problem: ConicProblem, z: torch.Tensor) -> torch.Tensor:
    """(G^T z) of shape (n,) for z of shape (N, k); (B, n) for (B, N, k)."""
    lead = batch_shape(problem)
    out = z.new_zeros(lead + (problem.n + 1,))
    vals = problem.cone_coefs * z[..., None]
    if lead:
        out.index_put_((_trials(problem, 3), problem.cone_cols), vals, accumulate=True)
    else:
        out.index_put_((problem.cone_cols.reshape(-1),), vals.reshape(-1), accumulate=True)
    return out[..., : problem.n]


def _scatter_dense(problem: ConicProblem, rows, cols, vals) -> torch.Tensor:
    """The (n, n) sum of vals at (rows, cols), broadcast together ((B, n,
    n) with a leading trial axis on all three); entries on the padding row
    or column n are dropped."""
    n = problem.n
    lead = batch_shape(problem)
    out = torch.zeros(lead + (n + 1, n + 1), dtype=vals.dtype, device=vals.device)
    index = (rows.expand(vals.shape), cols.expand(vals.shape))
    if lead:
        index = (_trials(problem, vals.dim() - 1).expand(vals.shape),) + index
    out.index_put_(index, vals, accumulate=True)
    return out[..., :n, :n]


def cost_matvec_dense_P(problem: ConicProblem) -> torch.Tensor:
    """Dense P = 2 sum_r w_r a_r a_r^T, shape (n, n)."""
    coefs, cols = problem.cost_coefs, problem.cost_cols
    vals = (2.0 * problem.cost_w[..., :, None, None] * coefs[..., :, :, None]
            * coefs[..., :, None, :])
    return _scatter_dense(problem, cols[..., :, :, None], cols[..., :, None, :], vals)


def cost_q(problem: ConicProblem) -> torch.Tensor:
    """q = -2 sum_r w_r b_r a_r."""
    lead = batch_shape(problem)
    contrib = -2.0 * (problem.cost_w * problem.cost_b)[..., None] * problem.cost_coefs
    q = torch.zeros(lead + (problem.n + 1,), dtype=problem.dtype, device=problem.device)
    index = (problem.cost_cols,)
    if lead:
        index = (_trials(problem, 2),) + index
    q.index_put_(index, contrib, accumulate=True)
    return q[..., : problem.n]


def cost_constant(problem: ConicProblem) -> torch.Tensor:
    """c0 + sum_r w_r b_r^2 so that 0.5 x'Px + q'x + const == true cost."""
    return problem.c0 + torch.sum(problem.cost_w * problem.cost_b ** 2, dim=-1)


def gtwg_dense(problem: ConicProblem, Winv2: torch.Tensor) -> torch.Tensor:
    """Dense G^T W^{-2} G from per-cone (N, k, k) middle matrices."""
    coefs, cols = problem.cone_coefs, problem.cone_cols  # (N, k, 2)
    # vals[m, i, a, j, b] = coefs[m,i,a] * Winv2[m,i,j] * coefs[m,j,b]
    vals = torch.einsum("...mia,...mij,...mjb->...miajb", coefs, Winv2, coefs)
    return _scatter_dense(problem, cols[..., :, :, :, None, None],
                          cols[..., :, None, None, :, :], vals)


def pin_fix_matrix(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero pinned rows/cols of K and put 1 on pinned diagonal entries, so
    that solving K d = (mask * rhs) yields d_pinned = 0: the free-subspace
    Newton step with the gauge pin enforced exactly."""
    Km = K * mask[..., :, None] * mask[..., None, :]
    return Km + torch.diag_embed(1.0 - mask)


def free_mask(problem: ConicProblem) -> torch.Tensor:
    """(n,) mask: 1 on free coordinates, 0 on pinned ones."""
    lead = batch_shape(problem)
    mask = torch.ones(lead + (problem.n,), dtype=problem.dtype, device=problem.device)
    if lead:
        return mask.scatter_(-1, problem.pin_idx, 0.0)
    mask[problem.pin_idx] = 0.0
    return mask


def pin_vector(problem: ConicProblem) -> torch.Tensor:
    """(n,) vector with the pinned values at pinned slots, 0 elsewhere."""
    lead = batch_shape(problem)
    x = torch.zeros(lead + (problem.n,), dtype=problem.dtype, device=problem.device)
    if lead:
        return x.scatter_(-1, problem.pin_idx, problem.pin_val)
    x[problem.pin_idx] = problem.pin_val
    return x


def trial_norm(v: torch.Tensor, lead: tuple) -> torch.Tensor:
    """||v|| over everything but the ``lead`` trial axes (all of v when
    there are none)."""
    if lead:
        return torch.linalg.vector_norm(v.reshape(lead + (-1,)), dim=-1)
    return torch.linalg.vector_norm(v)


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
    lead = batch_shape(problem)
    q = cost_q(problem)
    one = torch.ones((), dtype=problem.dtype, device=problem.device)
    return ProblemOperators(
        P=cost_matvec_dense_P(problem),
        q=q,
        const=cost_constant(problem),
        mask=free_mask(problem),
        xpin=pin_vector(problem),
        hnorm=torch.maximum(one, trial_norm(problem.cone_h, lead)),
        qnorm=torch.maximum(one, trial_norm(q, lead)),
    )
