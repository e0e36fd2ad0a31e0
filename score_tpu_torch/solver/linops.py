"""Linear operators derived from a :class:`ConicProblem`.

Port of the operators of :mod:`score_tpu.solver.linops` that the chain+arrow
path uses. The sparse row encodings are applied with gathers and
scatter-adds; column index ``n`` is the padding slot (gathers read a
zero-extended vector, scatter-adds land in a discarded slot).
"""

from __future__ import annotations

import torch

from score_tpu_torch.assembly.conic import ConicProblem

__all__ = ["G_apply", "GT_apply", "pin_vector", "free_mask"]


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
