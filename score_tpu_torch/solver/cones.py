"""Batched second-order-cone (SOC) algebra for the interior-point solver.

Port of :mod:`score_tpu.solver.cones`. Every problem has a product cone
K = SOC(k)^N with one static width k (= dim + 1), so all operations are
dense batched tensor ops of shape (N, k) / (N, k, k).

Every function also takes a leading trial axis, (B, N, k) / (B, N, k, k)
(the Monte-Carlo batch, ``score_tpu_torch.parallel``): the reductions over
the cones (:func:`inner`, :func:`max_step`, :func:`shift_to_interior`)
then give one value a trial, and on (N, k) they run the ops they always
did.

Conventions: a cone vector u = (u0, u1) with u0 scalar and u1 in R^{k-1};
u in int(SOC) iff u0 > ||u1||. The Jordan product is
u o v = (u.v, u0 v1 + v0 u1) with identity e = (1, 0). The Nesterov-Todd
scaling point for (s, z) is (eta, wbar) with wbar^T J wbar = 1
(J = diag(1, -I)), W = eta * [wbar0, wbar1^T; wbar1, I + wbar1 wbar1^T /
(1 + wbar0)], satisfying W^2 z = s and lambda = W z = W^{-1} s.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from score_tpu_torch.solver import dd

__all__ = [
    "NTScaling",
    "soc_identity",
    "soc_residual",
    "min_eig",
    "jordan_mul",
    "jordan_solve",
    "nt_scaling",
    "apply_W",
    "apply_Winv",
    "apply_Winv2",
    "winv2_matrices",
    "max_step",
    "shift_to_interior",
    "inner",
]


class NTScaling(NamedTuple):
    """Per-cone NT scaling: W = eta * H(wbar)."""

    eta: torch.Tensor  # (N,)
    wbar: torch.Tensor  # (N, k), wbar^T J wbar = 1


def soc_identity(N: int, k: int, dtype, device) -> torch.Tensor:
    """The Jordan identity e = (1, 0, ..., 0) per cone."""
    e = torch.zeros((N, k), dtype=dtype, device=device)
    e[:, 0] = 1.0
    return e


def inner(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Total inner product over the cone product, per-cone compensated
    (one a trial over a leading trial axis)."""
    return torch.sum(dd.dot(u, v), dim=-1)


def percone_inner(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Compensated <u_m, v_m> per cone, shape (..., N)."""
    return dd.dot(u, v)


def soc_residual(u: torch.Tensor) -> torch.Tensor:
    """u0^2 - ||u1||^2 per cone, compensated (see :mod:`.dd`)."""
    return dd.signed_sumsq(u)


def min_eig(u: torch.Tensor) -> torch.Tensor:
    """Smallest Jordan eigenvalue u0 - ||u1|| per cone."""
    return u[..., 0] - torch.linalg.vector_norm(u[..., 1:], dim=-1)


def jordan_mul(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """u o v = (u.v, u0 v1 + v0 u1)."""
    head = torch.sum(u * v, dim=-1, keepdim=True)
    tail = u[..., :1] * v[..., 1:] + v[..., :1] * u[..., 1:]
    return torch.cat([head, tail], dim=-1)


def jordan_solve(lmbda: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Solve lambda o u = d for u: with a = lambda0, b = lambda1,
    sigma = a^2 - ||b||^2,  u0 = (a d0 - b.d1) / sigma,  u1 = (d1 - u0 b) / a.
    sigma and the u0 numerator are evaluated compensated (both cancel for
    near-boundary lambda)."""
    a = lmbda[..., :1]
    b = lmbda[..., 1:]
    sigma = dd.signed_sumsq(lmbda)[..., None]
    u0 = dd.jdot(lmbda, d)[..., None] / sigma
    u1 = (d[..., 1:] - u0 * b) / a
    return torch.cat([u0, u1], dim=-1)


def _negate_tail(u: torch.Tensor) -> torch.Tensor:
    return torch.cat([u[..., :1], -u[..., 1:]], dim=-1)


def nt_scaling(s: torch.Tensor, z: torch.Tensor) -> NTScaling:
    """Nesterov-Todd scaling for each cone:
    rho_s = sqrt(s0^2 - ||s1||^2), rho_z likewise, sbar = s / rho_s,
    zbar = z / rho_z, gamma = sqrt((1 + sbar.zbar) / 2),
    wbar = (sbar + J zbar) / (2 gamma), eta = sqrt(rho_s / rho_z)."""
    # floor the cancellation-prone residuals at the smallest normal so a
    # boundary-grazing iterate degrades the scaling instead of making NaNs
    tiny = torch.finfo(s.dtype).smallest_normal
    rho_s = torch.sqrt(torch.clamp(soc_residual(s), min=tiny))
    rho_z = torch.sqrt(torch.clamp(soc_residual(z), min=tiny))
    sbar = s / rho_s[..., None]
    zbar = z / rho_z[..., None]
    sz = percone_inner(s, z) / (rho_s * rho_z)
    gamma = torch.sqrt((1.0 + sz) / 2.0)
    wbar = (sbar + _negate_tail(zbar)) / (2.0 * gamma[..., None])
    eta = torch.sqrt(rho_s / rho_z)
    return NTScaling(eta=eta, wbar=wbar)


def _apply_H(wbar: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """H(wbar) u with H = [w0, w1^T; w1, I + w1 w1^T/(1+w0)]."""
    w0 = wbar[..., :1]
    w1 = wbar[..., 1:]
    dot = torch.sum(w1 * u[..., 1:], dim=-1, keepdim=True)
    head = w0 * u[..., :1] + dot
    tail = u[..., 1:] + (u[..., :1] + dot / (1.0 + w0)) * w1
    return torch.cat([head, tail], dim=-1)


def apply_W(nt: NTScaling, u: torch.Tensor) -> torch.Tensor:
    """W u (W is symmetric)."""
    return nt.eta[..., None] * _apply_H(nt.wbar, u)


def apply_Winv(nt: NTScaling, u: torch.Tensor) -> torch.Tensor:
    """W^{-1} u = (1/eta) H(J wbar) u."""
    return _apply_H(_negate_tail(nt.wbar), u) / nt.eta[..., None]


def apply_Winv2(nt: NTScaling, u: torch.Tensor) -> torch.Tensor:
    """W^{-2} u via two structured applications, never forming the dense
    matrix: its small eigenvalue drowns in eps * ||W||^2 roundoff once a
    cone goes degenerate, the operator form keeps eps * kappa(W)."""
    return apply_Winv(nt, apply_Winv(nt, u))


def winv2_matrices(nt: NTScaling) -> torch.Tensor:
    """Dense per-cone W^{-2} = eta^{-2} (2 (J wbar)(J wbar)^T - J), shape
    (..., N, k, k), consumed by the KKT assembly G^T W^{-2} G."""
    k = nt.wbar.shape[-1]
    Jwbar = _negate_tail(nt.wbar)
    J = torch.eye(k, dtype=nt.wbar.dtype, device=nt.wbar.device)
    J[1:, 1:] *= -1.0
    M = 2.0 * Jwbar[..., :, None] * Jwbar[..., None, :] - J[None]
    return M / (nt.eta ** 2)[..., None, None]


def max_step(u: torch.Tensor, du: torch.Tensor, cap: float = 10.0) -> torch.Tensor:
    """Largest alpha in (0, cap] with u + alpha du in SOC for EVERY cone,
    given u strictly interior: the smallest positive root of the per-cone
    quadratic (u0+a du0)^2 - ||u1 + a du1||^2. Returns a 0-d tensor, or
    one value a trial over a leading trial axis."""
    if u.shape[-2] == 0:
        return torch.full(u.shape[:-2], cap, dtype=u.dtype, device=u.device)
    a = dd.signed_sumsq(du)
    b = 2.0 * dd.jdot(u, du)
    c = soc_residual(u)  # > 0 strictly inside
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    eps = torch.finfo(u.dtype).tiny
    # stable roots; sign(0) taken as +1 so b == 0 still yields a root pair
    sgn = torch.where(b >= 0.0, 1.0, -1.0)
    qq = -0.5 * (b + sgn * sq)
    qq_safe = torch.where(qq == 0.0, eps, qq)
    a_safe = torch.where(a == 0.0, eps, a)
    r1 = qq_safe / a_safe
    r2 = c / qq_safe
    # linear fallback when a ~ 0: root = -c / b (only limits if b < 0)
    lin = torch.where(b < 0.0, -c / torch.where(b == 0.0, -eps, b), cap)

    def pos_min(x, y):
        x = torch.where(x > 0.0, x, cap)
        y = torch.where(y > 0.0, y, cap)
        return torch.minimum(x, y)

    quad = torch.where(disc >= 0.0, pos_min(r1, r2), cap)
    per_cone = torch.where(a == 0.0, lin, quad)
    per_cone = torch.where(
        b >= 0.0, torch.where(a >= 0.0, cap, per_cone), per_cone
    )
    return torch.clamp(torch.amin(per_cone, dim=-1), max=cap)


def shift_to_interior(u: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    """Shift u along the global identity so every cone is strictly
    interior: u0 += (1 + |t|) when t = min_m min_eig(u_m) <= margin (t and
    the shift one a trial over a leading trial axis)."""
    if u.shape[-2] == 0:
        return u
    t = torch.amin(min_eig(u), dim=-1)
    shift = torch.where(t <= margin, 1.0 + torch.abs(t), 0.0)
    out = u.clone()
    out[..., 0] += shift[..., None]
    return out
