"""Compensated (double-word) reductions for the cone algebra.

Port of :mod:`score_tpu.solver.dd`. The SOC residual ``u0^2 - ||u1||^2``
of a near-boundary vector and the per-cone product ``<s, z>`` of a
near-complementary pair shrink like mu while their terms stay O(1), so a
naive f64 evaluation carries a relative error of eps/mu, which floors the
interior-point endgame near sqrt(eps). Error-free transformations (Knuth
two-sum, Dekker two-product) remove that floor; this is IEEE f64
cancellation, present on every device, not an emulation artefact.

Eager PyTorch rounds every operation to the working type (no cross-op
multiply-add contraction), which is what the transformations need.
"""

from __future__ import annotations

import math

import torch

__all__ = ["two_sum", "two_prod", "signed_sumsq", "jdot", "dot"]


def _split_factor(dtype) -> float:
    """Veltkamp splitting constant 2^((p + 2) // 2) + 1 for p explicit
    mantissa bits: 2^27 + 1 for f64, 2^12 + 1 for f32."""
    p = round(-math.log2(torch.finfo(dtype).eps))
    return float(2 ** ((p + 2) // 2) + 1)


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a + b), s + e = a + b."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _split_factor(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Error-free product: returns (p, e) with p = fl(a * b), p + e = a*b."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _fold_terms(ps, es):
    """Compensated sum over the last axis (cascaded two_sum)."""
    s = ps[..., 0]
    err = es[..., 0]
    for i in range(1, ps.shape[-1]):
        s, e = two_sum(s, ps[..., i])
        err = err + e + es[..., i]
    return s + err


def _jsign(u):
    sign = torch.ones(u.shape[-1], dtype=u.dtype, device=u.device)
    sign[1:] = -1.0
    return sign


def signed_sumsq(u):
    """Compensated u0^2 - sum_i u_i^2 (i >= 1) over the last axis."""
    p, e = two_prod(u, u)
    sign = _jsign(u)
    return _fold_terms(p * sign, e * sign)


def jdot(u, v):
    """Compensated u0*v0 - <u1, v1> over the last axis."""
    p, e = two_prod(u, v)
    sign = _jsign(u)
    return _fold_terms(p * sign, e * sign)


def dot(u, v):
    """Compensated <u, v> over the last axis."""
    p, e = two_prod(u, v)
    return _fold_terms(p, e)
