"""Matrix-free Levenberg-Marquardt refinement of range-aided SLAM.

Port of :mod:`score_tpu.refine.lm`. Given a factor graph and the rounded
initialization from ``solve_score``, it minimizes the true nonlinear
maximum-likelihood objective

    sum_e  tau_e ||R_j - R_i R_e||_F^2 + k_e ||t_j - t_i - R_i t_e||^2
  + sum_m  p_m (||t_a - t_b|| - d_m)^2
  + sum_q  p_q ||l_q - v_q||^2

over poses on SE(d) (rotations updated multiplicatively through the
exponential map) and landmark positions, in f64 on one device.

Each outer iteration linearizes the residual stack at the current manifold
point with ``torch.func.vjp``: J'·u is the vjp of the closure of the
tangent step, and J·v the vjp of u -> J'·u (:func:`_linearize`), so no
Jacobian is ever materialized. The damped normal equations
(J'J + lambda I) dx = -J'r are solved by fixed-trip conjugate gradients,
and the retracted trial point is accepted or rejected with the reference's
lambda adaptation, stall rule and robust (Huber, GNC Geman-McClure) IRLS
weights, in its order of operations. The outer loop runs on the host; its
only read of a device value is the stall counter, once an iteration.
Nothing inside the conjugate-gradient loop waits for the device.

Two deliberate departures:

- ``_exp_so3`` takes the closed-form branch's denominator from a safe copy
  of theta^2 (1 where the series branch is taken). Its values are the
  reference's at every point, but its transpose at the zero tangent is
  finite, where the reference's is NaN (0 * inf in the branch that is not
  taken), which leaves every 3D step's right-hand side NaN and the
  reference's 3D refinement a no-op.
- The stall counter starts at the first accepted step. The reference
  counts rejected steps as stalls from the start, so a start whose first
  three trials raise the cost (lambda 1e-4 to 1.6e-3) is returned
  unchanged. Once a step has been accepted the two rules are the same.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch.func import vjp

from score_tpu_torch.api import _device
from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.solver_utils import VariableValues

__all__ = ["RefineParams", "RefineResult", "refine_solution"]


@dataclasses.dataclass(frozen=True)
class RefineParams:
    max_iter: int = 60
    cg_iters: int = 60
    lm_lambda0: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 3.0
    # stop when an accepted step improves the cost by less than this
    # relative amount this many times in a row
    tol_rel_decrease: float = 1e-9
    stall_limit: int = 3
    # gauge: freeze the first pose (parity with the relaxation's pin)
    pin_first_pose: bool = True
    # Robust loss on RANGE residuals:
    #   "none"  — plain least squares
    #   "huber" — linear tail beyond robust_delta (whitened sigmas)
    #   "gm"    — Geman-McClure with GNC continuation (gross outliers get
    #             asymptotically zero influence; mu halves from
    #             gnc_init_factor toward 1)
    # Implemented as iteratively-reweighted LM: sqrt(rho'(r)) weights
    # frozen through each linearization, accept/reject on the cost under
    # the same weights.
    robust: str = "none"
    robust_delta: float = 3.0  # kernel width in whitened-residual units
    gnc_init_factor: float = 64.0  # gm: mu0 = this (quadratic-ish start)
    # Plain least-squares iterations before the robust weights switch on
    # (at a poor initialization the residuals are dominated by trajectory
    # error, and immediate robustification locks it in). Ignored when
    # robust="none".
    robust_warmup_iters: int = 0


class RefineResult(NamedTuple):
    values: VariableValues
    initial_cost: float
    cost: float
    iterations: int


def _exp_so2(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def _exp_so3(w):
    """Rodrigues with a series branch for small angles; w (..., 3).

    The values are the reference's. The closed-form branch divides by
    ``th2_safe`` (1 where the series branch is taken), so the branch that
    is not taken has a finite derivative and the transpose at w = 0 is
    finite."""
    th2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    small = th2 < 1e-12
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_safe + 1e-32)
    zero = torch.zeros_like(w[..., 0])
    wx = torch.stack(
        [
            torch.stack([zero, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], zero, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], zero], -1),
        ],
        -2,
    )
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_safe)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(wx.shape)
    return eye + A * wx + B * (wx @ wx)


class _Graph(NamedTuple):
    """Index tensors and measurement numerics on the refinement's device."""

    d: int
    P: int
    L: int
    rdim: int
    edge_i: torch.Tensor  # (E,)
    edge_j: torch.Tensor
    edge_R: torch.Tensor  # (E, d, d)
    edge_t: torch.Tensor  # (E, d)
    edge_sqrt_tau: torch.Tensor  # (E,)
    edge_sqrt_k: torch.Tensor
    rng_a: torch.Tensor  # (M,) index into [pose translations | landmarks]
    rng_b: torch.Tensor
    rng_d: torch.Tensor
    rng_sqrt_p: torch.Tensor
    prior_l: torch.Tensor  # (Q,)
    prior_v: torch.Tensor  # (Q, d)
    prior_sqrt_p: torch.Tensor


def _compile_graph(fg: FactorGraphData, device) -> Tuple[_Graph, Tuple[str, ...], Tuple[str, ...]]:
    d = fg.dimension
    pose_names = tuple(p.name for chain in fg.pose_variables for p in chain)
    lm_names = tuple(l.name for l in fg.landmark_variables)
    pidx = {n: i for i, n in enumerate(pose_names)}
    lidx = {n: i for i, n in enumerate(lm_names)}
    P, L = len(pose_names), len(lm_names)

    meas = [m for chain in fg.odom_measurements for m in chain]
    meas += list(fg.loop_closure_measurements)
    E = len(meas)
    edge_i = np.zeros(E, np.int64)
    edge_j = np.zeros(E, np.int64)
    edge_R = np.zeros((E, d, d))
    edge_t = np.zeros((E, d))
    st = np.zeros(E)
    sk = np.zeros(E)
    for e, m in enumerate(meas):
        edge_i[e] = pidx[m.base_pose]
        edge_j[e] = pidx[m.to_pose]
        edge_R[e] = np.asarray(m.rotation_matrix)
        edge_t[e] = np.asarray(m.translation_vector)
        st[e] = np.sqrt(m.rotation_precision)
        sk[e] = np.sqrt(m.translation_precision)

    M = len(fg.range_measurements)
    ra = np.zeros(M, np.int64)
    rb = np.zeros(M, np.int64)
    rd = np.zeros(M)
    rp = np.zeros(M)

    def tr_index(name):
        return pidx[name] if name in pidx else P + lidx[name]

    for m_, r in enumerate(fg.range_measurements):
        ra[m_] = tr_index(r.first_key)
        rb[m_] = tr_index(r.second_key)
        rd[m_] = r.dist
        rp[m_] = np.sqrt(r.precision)

    Q = len(fg.landmark_priors)
    pl_ = np.zeros(Q, np.int64)
    pv = np.zeros((Q, d))
    pp = np.zeros(Q)
    for q, pr in enumerate(fg.landmark_priors):
        pl_[q] = lidx[pr.name]
        pv[q] = np.asarray(pr.position, dtype=float)[:d]
        pp[q] = np.sqrt(pr.translation_precision)

    def dev(a):
        return torch.as_tensor(a, device=device)

    g = _Graph(
        d=d, P=P, L=L, rdim=1 if d == 2 else 3,
        edge_i=dev(edge_i), edge_j=dev(edge_j), edge_R=dev(edge_R), edge_t=dev(edge_t),
        edge_sqrt_tau=dev(st), edge_sqrt_k=dev(sk),
        rng_a=dev(ra), rng_b=dev(rb), rng_d=dev(rd), rng_sqrt_p=dev(rp),
        prior_l=dev(pl_), prior_v=dev(pv), prior_sqrt_p=dev(pp),
    )
    return g, pose_names, lm_names


def _residuals(g: _Graph, R, t, l, rng_w=None):
    """Weighted residual stack at explicit (R (P,d,d), t (P,d), l (L,d)).

    ``rng_w`` (M,) multiplies the whitened range residuals: the sqrt
    robust weights of the IRLS scheme (None = plain least squares). The
    gathers are ``index_select``, whose transpose is ``index_add_``: no
    step of the Jacobian products waits for the device."""
    Ri = R.index_select(0, g.edge_i)
    Rj = R.index_select(0, g.edge_j)
    rot = (Rj - Ri @ g.edge_R) * g.edge_sqrt_tau[:, None, None]
    tr = (t.index_select(0, g.edge_j) - t.index_select(0, g.edge_i)
          - torch.einsum("eij,ej->ei", Ri, g.edge_t)) * g.edge_sqrt_k[:, None]
    out = [rot.reshape(-1), tr.reshape(-1)]
    if g.rng_a.shape[0]:
        rr = _range_residuals(g, t, l)
        if rng_w is not None:
            rr = rr * rng_w
        out.append(rr)
    if g.prior_l.shape[0]:
        out.append(((l.index_select(0, g.prior_l) - g.prior_v)
                    * g.prior_sqrt_p[:, None]).reshape(-1))
    return torch.cat(out)


def _range_residuals(g: _Graph, t, l):
    """Whitened (unrobustified) range residuals, shape (M,)."""
    tall = torch.cat([t, l], dim=0) if g.L else t
    diff = tall.index_select(0, g.rng_a) - tall.index_select(0, g.rng_b)
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-18)
    return (dist - g.rng_d) * g.rng_sqrt_p


def _robust_sqrt_weights(kind: str, r, delta: float, mu):
    """sqrt(rho'(r^2)) IRLS weights for the supported kernels."""
    r2 = r * r
    if kind == "huber":
        return torch.sqrt(torch.clamp(delta / torch.clamp(torch.abs(r), min=1e-12), max=1.0))
    if kind == "gm":  # GNC Geman-McClure (Yang et al. 2020 form)
        c2 = delta * delta
        return (mu * c2) / (r2 + mu * c2)
    raise ValueError(f"unknown robust kernel {kind!r}")


def _retract(g: _Graph, base, delta, mask):
    """Apply a masked tangent step to (R, t, l)."""
    R, t, l = base
    P, L, d, rdim = g.P, g.L, g.d, g.rdim
    delta = delta * mask
    dth = delta[: P * rdim].reshape(P, rdim)
    dt = delta[P * rdim: P * rdim + P * d].reshape(P, d)
    dl = delta[P * rdim + P * d:].reshape(L, d)
    dR = _exp_so2(dth[:, 0]) if d == 2 else _exp_so3(dth)
    return (R @ dR, t + dt, l + dl)


def _solve_normal_cg(jvp_fn, vjp_fn, rhs, lam, iters):
    """CG on (J'J + lam I) x = rhs, a fixed number of trips. Every scalar
    stays a device tensor: no trip waits for the device."""
    x = torch.zeros_like(rhs)
    r = rhs
    p = r
    rs = r @ r
    zero = torch.zeros_like(rs)
    for _ in range(iters):
        Ap = vjp_fn(jvp_fn(p)) + lam * p
        denom = p @ Ap
        alpha = torch.where(denom > 0.0, rs / torch.clamp(denom, min=1e-300), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        beta = rs_new / torch.clamp(rs, min=1e-300)
        p = r + beta * p
        rs = rs_new
    return x


def _linearize(fn, x0):
    """``fn(x0)`` and the products J·v and J'·u of its Jacobian at ``x0``,
    both from ``torch.func.vjp``: J'·u is the vjp of ``fn``, and J·v the
    vjp of the linear map u -> J'·u (the transpose of the transpose).
    Both replay a recorded autograd graph, built once here; neither
    recomputes ``fn``. (``torch.func.linearize`` gives the same J·v, but
    traces ``fn`` through ``make_fx`` on every call: ~1 s on the CPU for a
    10-pose graph, against ~2 ms for both graphs here.)"""
    r0, vjp_fn = vjp(fn, x0)

    def transpose(u):
        (out,) = vjp_fn(u)
        return out

    _, jvp_vjp = vjp(transpose, torch.zeros_like(r0))

    def jvp_fn(v):
        (out,) = jvp_vjp(v)
        return out

    return r0, jvp_fn, transpose


def refine_solution(
    fg: FactorGraphData,
    values: VariableValues,
    params: RefineParams = RefineParams(),
    device="cuda",
) -> RefineResult:
    """Refine a SCORE initialization to the nonlinear MLE on ``device``
    (the card by default; without one this raises, and nothing falls back
    to the CPU)."""
    dev = _device(device)
    g, pose_names, lm_names = _compile_graph(fg, dev)
    d = g.d
    f64 = torch.float64

    def stack(arrays, shape):
        if not arrays:
            return torch.zeros(shape, dtype=f64, device=dev)
        return torch.as_tensor(np.stack(arrays), dtype=f64, device=dev)

    poses = [np.asarray(values.poses[n], dtype=np.float64) for n in pose_names]
    R0 = stack([T[:d, :d] for T in poses], (0, d, d))
    t0 = stack([T[:d, d] for T in poses], (0, d))
    l0 = stack([np.asarray(values.landmarks[n], dtype=np.float64) for n in lm_names], (0, d))

    n_delta = g.P * g.rdim + g.P * d + g.L * d
    mask = torch.ones((n_delta,), dtype=f64, device=dev)
    if params.pin_first_pose and g.P:
        mask[: g.rdim] = 0.0
        mask[g.P * g.rdim: g.P * g.rdim + d] = 0.0

    robust = params.robust
    use_robust = robust != "none" and g.rng_a.shape[0] > 0
    warmup = int(params.robust_warmup_iters)

    # mu and the iteration count follow the host loop alone (mu halves
    # once the warm-up is over), so both stay host numbers
    def weights_at(base, mu, it):
        if not use_robust:
            return None
        if it < warmup:
            return torch.ones_like(g.rng_d)
        r = _range_residuals(g, base[1], base[2])
        return _robust_sqrt_weights(robust, r, params.robust_delta, mu).detach()

    def cost_of(base, w):
        r = _residuals(g, *base, rng_w=w)
        return r @ r

    base = (R0, t0, l0)
    mu = float(params.gnc_init_factor) if robust == "gm" else 1.0
    c0 = cost_of(base, weights_at(base, mu, warmup))
    lam = torch.tensor(params.lm_lambda0, dtype=f64, device=dev)
    stall = torch.zeros((), dtype=torch.int64, device=dev)
    accepted = torch.zeros((), dtype=torch.bool, device=dev)
    zero = torch.zeros((n_delta,), dtype=f64, device=dev)
    it = 0
    # the loop's one read of the device: the stall counter
    while it < params.max_iter and int(stall) < params.stall_limit:
        w = weights_at(base, mu, it)
        # reference cost under THIS iteration's weights (IRLS: the carried
        # cost was measured under stale weights)
        cost_w = cost_of(base, w)

        def r_of_delta(delta, base=base, w=w):
            return _residuals(g, *_retract(g, base, delta, mask), rng_w=w)

        r0_, jvp_fn, vjp_fn = _linearize(r_of_delta, zero)
        rhs = -vjp_fn(r0_)
        step = _solve_normal_cg(jvp_fn, vjp_fn, rhs, lam, params.cg_iters)
        trial = _retract(g, base, step, mask)
        new_cost = cost_of(trial, w)
        accept = new_cost < cost_w
        rel_impr = (cost_w - new_cost) / torch.clamp(cost_w, min=1e-300)
        base = tuple(torch.where(accept, b, a) for a, b in zip(base, trial))
        lam = torch.where(accept, lam / params.lambda_down, lam * params.lambda_up)
        lam = torch.clamp(lam, 1e-12, 1e12)
        # GNC continuation: halve mu toward 1 (quadratic -> GM) once the
        # warm-up is over; stalling only counts after the warm-up AND once
        # the continuation has landed, and (unlike the reference) only once
        # a step has been accepted: the reference stops after three
        # rejected first steps with the start unchanged (3D 4x250 from its
        # SOCP rounding: the first trial raises the cost at every lambda up
        # to ~1)
        mu_next = max(1.0, mu * 0.5) if robust == "gm" and it >= warmup else mu
        settled = mu <= 1.0 + 1e-9 and it >= warmup
        accepted = accepted | accept
        if settled:
            improved = (accept & (rel_impr > params.tol_rel_decrease)) | ~accepted
            stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        else:
            stall = torch.zeros_like(stall)
        it += 1
        mu = mu_next

    final_cost = cost_of(base, weights_at(base, mu, it))
    Rf, tf_, lf = base
    host = torch.cat([Rf.reshape(-1), tf_.reshape(-1), lf.reshape(-1),
                      torch.stack([c0, final_cost])]).cpu().numpy()
    nR, nt = g.P * d * d, g.P * d
    Rf_np = host[:nR].reshape(g.P, d, d)
    tf_np = host[nR: nR + nt].reshape(g.P, d)
    lf_np = host[nR + nt: nR + nt + g.L * d].reshape(g.L, d)
    out_poses = {}
    for i, n in enumerate(pose_names):
        T = np.eye(d + 1)
        T[:d, :d] = Rf_np[i]
        T[:d, d] = tf_np[i]
        out_poses[n] = T
    landmarks = {n: lf_np[i] for i, n in enumerate(lm_names)}
    out = VariableValues(dim=d, poses=out_poses, landmarks=landmarks,
                         distances=dict(values.distances))
    return RefineResult(values=out, initial_cost=float(host[-2]), cost=float(host[-1]),
                        iterations=it)
