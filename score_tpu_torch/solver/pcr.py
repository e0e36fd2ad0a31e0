"""Cyclic reduction for SPD block-tridiagonal chains (the f32 band).

Port of :mod:`score_tpu.solver.pcr`, batched over a leading chain axis in
place of ``jax.vmap``. For a system with diagonal blocks D_t and
super-diagonal blocks U_t (coupling t -> t+1), one level with the even/odd
split computes

    W2_j = Dodd_j^{-1} Ueven_j^T          W1_j = Dodd_j^{-1} Uodd_j
    D'_i = Deven_i - Ueven_i W2_i - [Uodd^T W1]_{i-1}
    U'_i = -W2_i^T Uodd_i

and halves the chain; a solve folds the odd right-hand sides into the even
system on the way down and back-substitutes the odd blocks on the way up.

Each level's block Cholesky and Cholesky solves go through
:mod:`score_tpu_torch.solver.smallblocks`, which launches the batched block
kernels of :mod:`score_tpu_torch.ops.blocks` for float32 tensors on the
card (a solve is one launch, forward and back substitution fused; a
level's W2 and W1 share their factor and one launch). The 6x6 block
products stay ``torch.matmul``.

Level loop and shapes: the JAX version runs the levels as a ``lax.scan``
over a fixed-shape state, refilling the dropped half with decoupled
identity blocks so that every level is one static program. Here the loop
runs on the host and the state is compacted instead: level l holds
Tp / 2^(l+1) blocks per chain. The valid blocks go through the same
arithmetic either way; the compacted state skips the identity padding's
work.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from score_tpu_torch.solver.smallblocks import chol_small, chol_solve

__all__ = ["PCRFactors", "pcr_pad_length", "pcr_factor", "pcr_solve"]


class PCRFactors(NamedTuple):
    # one entry per level, fine -> coarse; level l's blocks are
    # (C, Tp / 2^(l+1), Db, Db)
    L_odd: tuple
    W1: tuple
    W2: tuple
    U_even: tuple
    U_odd: tuple
    L_root: torch.Tensor  # (C, Db, Db) Cholesky factor of the last block


def pcr_pad_length(T: int) -> int:
    p = 1
    while p < T:
        p *= 2
    return p


def _dinv(L, M, M2=None):
    """(L L^T)^-1 M, and with M2 also (L L^T)^-1 M2: one fused kernel
    launch for float32 on the card."""
    return chol_solve(L, M, M2)


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """x_{j-1} along the chain axis (dim 1), zero at j = 0."""
    out = torch.zeros_like(x)
    out[:, 1:] = x[:, :-1]
    return out


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """x_{j+1} along the chain axis (dim 1), zero at the last block."""
    out = torch.zeros_like(x)
    out[:, :-1] = x[:, 1:]
    return out


def pcr_factor(D: torch.Tensor, U: torch.Tensor) -> PCRFactors:
    """Factor C block-tridiagonal SPD systems.

    D: (C, T, Db, Db) diagonal blocks (T a power of two; pad with identity).
    U: (C, T, Db, Db) super-diagonal blocks, U[:, t] couples (t, t+1);
       U[:, T-1] must be zero.
    """
    T = D.shape[1]
    if T != pcr_pad_length(T):
        raise ValueError(f"pcr_factor: chain length {T} is not a power of two")
    levels = ([], [], [], [], [])
    while D.shape[1] > 1:
        D_even, D_odd = D[:, 0::2], D[:, 1::2]
        U_even, U_odd = U[:, 0::2], U[:, 1::2]
        L_odd = chol_small(D_odd)
        W2, W1 = _dinv(L_odd, U_even.transpose(-1, -2), U_odd)
        term_right = U_even @ W2
        term_left = _shift_down(U_odd.transpose(-1, -2) @ W1)
        D = D_even - term_right - term_left
        U = -W2.transpose(-1, -2) @ U_odd
        for store, blk in zip(levels, (L_odd, W1, W2, U_even, U_odd)):
            store.append(blk)
    return PCRFactors(*(tuple(s) for s in levels), L_root=chol_small(D[:, 0]))


def pcr_solve(factors: PCRFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the factored systems for rhs of shape (C, T, Db, K)."""
    r = rhs
    ros = []
    # down pass: fold the odd right-hand sides into the even system
    for L_odd, U_even, U_odd in zip(factors.L_odd, factors.U_even, factors.U_odd):
        r_even, r_odd = r[:, 0::2], r[:, 1::2]
        ro = _dinv(L_odd, r_odd)
        fold = _shift_down(U_odd.transpose(-1, -2) @ ro)
        r = r_even - fold - U_even @ ro
        ros.append(ro)
    x = _dinv(factors.L_root, r[:, 0])[:, None]
    # up pass: back-substitute the odd blocks and interleave
    for W1, W2, ro in zip(reversed(factors.W1), reversed(factors.W2), reversed(ros)):
        x_odd = ro - W2 @ x - W1 @ _shift_up(x)
        x = torch.stack([x, x_odd], dim=2).reshape(
            x.shape[0], 2 * x.shape[1], *x.shape[2:]
        )
    return x
