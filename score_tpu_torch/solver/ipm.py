"""Primal-dual interior-point solver for conic QPs.

Port of :mod:`score_tpu.solver.ipm`. Solves

    minimize    0.5 x^T P x + q^T x
    subject to  G x + s = h,   s in K = SOC(k)^N

with a Mehrotra predictor-corrector method under Nesterov-Todd scaling,
Gondzio centrality correctors, gated residual-guarded direction
refinement, a wide-neighbourhood step safeguard with centering recovery,
best-iterate tracking and stall detection. Each direction is one reduced
SPD solve (P + G^T W^{-2} G) dx = ... through the KKT backend.

The JAX version is one jit-compiled `lax.while_loop`; here the loop runs
on the host and every branch that was a `lax.cond` (or the loop
condition) is decided from one synchronised scalar. Selections that were
`jnp.where` stay `torch.where` on the device.

The batched IPM below the single-solve one (:func:`solve_batch`, behind
``score_tpu_torch.parallel.solve_conic_batch``) advances B trials of one
structure in lockstep, as the JAX package's branchless batch does: every
per-lane decision is a `torch.where`, and the host reads, once a trip, only
whether any lane runs and the two gates shared by the batch (a lane near
convergence; a lane near convergence or stalled), which decide whether
the direction-refinement and centering-recovery solves run at all.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from score_tpu_torch.assembly.conic import ConicProblem
from score_tpu_torch.solver import cones
from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend
from score_tpu_torch.solver.collective import all_reduce
from score_tpu_torch.solver.linops import trial_norm

__all__ = [
    "IPMParams",
    "IPMResult",
    "solve_conic",
    "solve_conic_fixed",
    "solve_conic_traced",
    "solve_conic_with_iterates",
]

# Status codes (same values as the JAX package).
RUNNING = 0
OPTIMAL = 1
MAX_ITER = 2
NUMERICAL_ERROR = 3
OPTIMAL_INACCURATE = 4  # stopped early but meets the reduced tolerances
PRIMAL_INFEASIBLE = 5  # certificate z: z in K*, G'z ~ 0, h'z < 0
DUAL_INFEASIBLE = 6  # certificate x: P x ~ 0, q'x < 0, -G x in K
SOLVED_STATUSES = (OPTIMAL, OPTIMAL_INACCURATE)
INFEASIBLE_STATUSES = (PRIMAL_INFEASIBLE, DUAL_INFEASIBLE)


@dataclasses.dataclass(frozen=True)
class IPMParams:
    """Interior-point controls (meanings and defaults as in
    :class:`score_tpu.solver.ipm.IPMParams`)."""

    max_iter: int = 50
    tol_feas: float = 1e-8
    tol_gap_abs: float = 1e-8
    tol_gap_rel: float = 1e-6
    step_fraction: float = 0.99
    kkt_refine_steps: int = 0  # iterative-refinement passes per K solve
    # refinement passes of each search direction against the full Newton
    # system (removes the W^{-2} roundoff floor of the condensed solve)
    dir_refine_steps: int = 1
    # refine only once the best-iterate metric is below this (0: always)
    dir_refine_gate: float = 1e-3
    # static diagonal regularization of K, relative to max|diag(K)|
    static_reg: float = 1e-11
    # escalation factor of the retry factorization after a breakdown
    reg_escalation: float = 1e5
    # reduced tolerances applied when the iteration stops early
    tol_feas_reduced: float = 1e-6
    tol_gap_reduced: float = 1e-5
    # stop after this many iterations without improving the best iterate
    stall_limit: int = 5
    gondzio_correctors: int = 2
    gondzio_beta_min: float = 0.1
    gondzio_beta_max: float = 10.0
    # Farkas certificates, tested once the iterate diverges
    tol_infeas: float = 1e-8
    infeas_norm_gate: float = 100.0
    # wide-neighbourhood safeguard: every cone keeps rho_s rho_z >= gamma^4 mu^2
    nbhd_gamma: float = 0.1
    # refine the affine (predictor) direction too
    refine_affine: bool = False
    # fill _State.diag with the step's diagnostics (a full Newton-system
    # residual, three operator applications, a step): off on the solve
    # path, on in solve_conic_traced
    record_diag: bool = False


class IPMResult(NamedTuple):
    """A solve's result; from :func:`solve_batch` every field has a leading
    trial axis (``iterations`` and ``status`` int64 tensors)."""

    x: torch.Tensor
    s: torch.Tensor
    z: torch.Tensor
    iterations: int
    status: int
    pobj: float  # 0.5 x'Px + q'x + const (true relaxation objective)
    gap: float  # s'z
    pres: float
    dres: float


@dataclasses.dataclass
class _State:
    x: torch.Tensor
    s: torch.Tensor
    z: torch.Tensor
    it: int
    status: int
    # best-iterate tracking (by max of scaled residuals and relative gap)
    best_x: torch.Tensor
    best_s: torch.Tensor
    best_z: torch.Tensor
    best_metric: float
    stall: int
    # the last step's 8 diagnostics (IPMParams.record_diag), on the device
    diag: Optional[torch.Tensor] = None


def _convergence_full(backend, problem, ops, params: IPMParams, x, s, z):
    # residuals scaled by the magnitude of their constituent terms
    Px = backend.P_matvec(ops, x)
    Gtz = backend.GT(problem, ops, z)
    Gx = backend.G(problem, ops, x)
    rx = ops.mask * (Px + ops.q + Gtz)
    rz = Gx + s - problem.cone_h
    norm = torch.linalg.vector_norm
    one = torch.ones((), dtype=x.dtype, device=x.device)
    dscale = torch.maximum(one, torch.maximum(norm(Px), torch.maximum(norm(Gtz), ops.qnorm)))
    pscale = torch.maximum(one, torch.maximum(norm(Gx), torch.maximum(norm(s), ops.hnorm)))
    pres = norm(rz) / pscale
    dres = norm(rx) / dscale
    gap = cones.inner(s, z)
    pq = 0.5 * x @ Px + ops.q @ x
    # gap relative to the TRUE objective value (pq + const)
    relgap = gap / torch.maximum(one, torch.abs(pq + ops.const))
    ok = (pres < params.tol_feas) & (dres < params.tol_feas) & (
        (gap < params.tol_gap_abs) | (relgap < params.tol_gap_rel)
    )
    bad = ~(torch.isfinite(pres) & torch.isfinite(dres) & torch.isfinite(gap))
    return ok, bad, pres, dres, gap, pq, rx, rz, Px, Gtz, Gx


def _metric(pres, dres, gap, pobj):
    one = torch.ones_like(gap)
    relgap = torch.abs(gap) / torch.maximum(one, torch.abs(pobj))
    m = torch.maximum(torch.maximum(pres, dres), relgap)
    return torch.where(torch.isfinite(m), m, torch.full_like(m, float("inf")))


def _advance(backend, problem, ops, params, st: _State) -> None:
    """One loop trip: convergence bookkeeping (best iterate, stall,
    infeasibility certificates, status), then a step unless terminal.
    The residuals of the convergence test are reused by the step."""
    ok, bad, pres, dres, gap, pq, rx, rz, Px, Gtz, Gx = _convergence_full(
        backend, problem, ops, params, st.x, st.s, st.z
    )
    m = _metric(pres, dres, gap, pq + ops.const)

    tol_i = params.tol_infeas
    norm = torch.linalg.vector_norm
    znorm = norm(st.z)
    # Farkas: on the free subspace the effective rhs is h - G xpin
    hz = torch.sum(problem.cone_h * st.z) - ops.xpin @ Gtz
    pinf = (znorm > params.infeas_norm_gate) & (hz < -tol_i * znorm) & (
        norm(ops.mask * Gtz) < tol_i * znorm
    )
    xnorm = norm(st.x)
    ray_in_cone = torch.min(cones.min_eig(-Gx)) > -tol_i * xnorm
    dinf = (
        (xnorm > params.infeas_norm_gate)
        & (ops.q @ st.x < -tol_i * xnorm)
        & (norm(ops.mask * Px) < tol_i * xnorm)
        & ray_in_cone
    )
    # one synchronisation for every decision of the bookkeeping
    m_f, ok_f, bad_f, pinf_f, dinf_f = torch.stack(
        [m, ok.to(m.dtype), bad.to(m.dtype), pinf.to(m.dtype), dinf.to(m.dtype)]
    ).tolist()

    if m_f < st.best_metric:
        st.best_x, st.best_s, st.best_z = st.x, st.s, st.z
        st.best_metric = m_f
        st.stall = 0
    else:
        st.stall += 1
    stalled = st.stall >= params.stall_limit
    if ok_f:
        st.status = OPTIMAL
    elif pinf_f:
        st.status = PRIMAL_INFEASIBLE
    elif dinf_f:
        st.status = DUAL_INFEASIBLE
    elif bad_f:
        st.status = NUMERICAL_ERROR
    elif stalled:
        st.status = MAX_ITER
    if st.status == RUNNING:
        _step(backend, problem, ops, params, st, rx, rz)


def _step(backend, problem: ConicProblem, ops, params: IPMParams, st: _State,
          rx, rz) -> None:
    x, s, z = st.x, st.s, st.z
    N = problem.num_cones
    dtype, dev = x.dtype, x.device
    norm = torch.linalg.vector_norm

    nt = cones.nt_scaling(s, z)
    lam = cones.apply_W(nt, z)
    Winv2 = cones.winv2_matrices(nt)
    factors = backend.factor(problem, ops, Winv2, params)

    gap = cones.inner(s, z)
    mu = gap / N

    def _condensed(rx_, rz_, d):
        """One condensed Newton solve: P dx + G' dz = -rx_,
        G dx + ds = -rz_, lambda o (W^{-1} ds + W dz) = d, with W^{-2}
        applied in operator form."""
        v = cones.apply_W(nt, cones.jordan_solve(lam, d))  # W (lambda \ d)
        rzv = rz_ + v
        wrz = cones.apply_Winv2(nt, rzv)
        rhs = ops.mask * (-rx_ - backend.GT(problem, ops, wrz))
        dx = backend.solve(problem, ops, factors, rhs, params)
        Gdx = backend.G(problem, ops, dx)
        dz = cones.apply_Winv2(nt, Gdx + rzv)
        ds = -rz_ - Gdx
        return dx, ds, dz

    def _newton_resid(rx_, rz_, d, dx, ds, dz):
        f1 = ops.mask * (-rx_ - backend.P_matvec(ops, dx) - backend.GT(problem, ops, dz))
        f2 = -rz_ - backend.G(problem, ops, dx) - ds
        f3 = d - cones.jordan_mul(lam, cones.apply_Winv(nt, ds) + cones.apply_W(nt, dz))
        return f1, f2, f3

    def refine_dirs(rx_, rz_, d, dirs):
        """Full-system iterative refinement of computed directions; a
        correction is accepted only when it reduces the full residual."""
        if params.dir_refine_steps == 0:
            return dirs
        # refinement only matters near convergence (IPMParams.dir_refine_gate)
        if params.dir_refine_gate > 0.0 and not st.best_metric < params.dir_refine_gate:
            return dirs
        dx, ds, dz = dirs
        for _ in range(params.dir_refine_steps):
            f1, f2, f3 = _newton_resid(rx_, rz_, d, dx, ds, dz)
            r0 = norm(f1) + norm(f2) + norm(f3)
            cx, cs, cz = _condensed(-f1, -f2, f3)
            nx, ns, nz = dx + cx, ds + cs, dz + cz
            g1, g2, g3 = _newton_resid(rx_, rz_, d, nx, ns, nz)
            better = (norm(g1) + norm(g2) + norm(g3)) < r0
            dx = torch.where(better, nx, dx)
            ds = torch.where(better, ns, ds)
            dz = torch.where(better, nz, dz)
        return dx, ds, dz

    def kkt_dirs(d):
        return refine_dirs(rx, rz, d, _condensed(rx, rz, d))

    def kkt_dirs_correction(d):
        # pure-centrality correction: zero primal/dual residual rows, no
        # refinement (correctors are accepted only when alpha improves)
        return _condensed(torch.zeros_like(rx), torch.zeros_like(rz), d)

    def step_len(ds_, dz_):
        return torch.clamp(
            params.step_fraction
            * torch.minimum(cones.max_step(s, ds_), cones.max_step(z, dz_)),
            max=1.0,
        )

    # --- affine (predictor) direction ---
    d_aff = -cones.jordan_mul(lam, lam)
    if params.refine_affine:
        dx_a, ds_a, dz_a = kkt_dirs(d_aff)
    else:
        dx_a, ds_a, dz_a = _condensed(rx, rz, d_aff)
    alpha_a = torch.clamp(
        torch.minimum(cones.max_step(s, ds_a), cones.max_step(z, dz_a)), max=1.0
    )
    gap_a = cones.inner(s + alpha_a * ds_a, z + alpha_a * dz_a)
    sigma = torch.clamp((torch.clamp(gap_a, min=0.0) / gap) ** 3, 0.0, 1.0)

    # --- combined (corrector) direction ---
    e = cones.soc_identity(N, problem.k, dtype, dev)
    correction = cones.jordan_mul(cones.apply_Winv(nt, ds_a), cones.apply_W(nt, dz_a))
    d_comb = d_aff - correction + sigma * mu * e
    dx, ds, dz = kkt_dirs(d_comb)
    alpha = step_len(ds, dz)

    # --- Gondzio multiple centrality correctors ---
    mu_t = sigma * mu
    lo = params.gondzio_beta_min * mu_t
    hi = params.gondzio_beta_max * mu_t
    for _ in range(params.gondzio_correctors):
        a_trial = torch.clamp(1.1 * alpha + 0.1, max=1.0)
        prod = cones.jordan_mul(
            cones.apply_Winv(nt, s + a_trial * ds), cones.apply_W(nt, z + a_trial * dz)
        )
        head = prod[:, :1]
        d_extra = torch.cat([torch.clamp(head, lo, hi) - head, -prod[:, 1:]], dim=1)
        # only correct meaningfully off-center cones
        off = (head < lo) | (head > hi)
        d_extra = torch.where(off, d_extra, torch.zeros_like(d_extra))
        dx_c, ds_c, dz_c = kkt_dirs_correction(d_extra)
        dx_n, ds_n, dz_n = dx + dx_c, ds + ds_c, dz + dz_c
        alpha_n = step_len(ds_n, dz_n)
        accept = alpha_n > alpha * 1.01
        dx = torch.where(accept, dx_n, dx)
        ds = torch.where(accept, ds_n, ds)
        dz = torch.where(accept, dz_n, dz)
        alpha = torch.where(accept, alpha_n, alpha)

    # --- wide-neighbourhood safeguard ---
    g4 = params.nbhd_gamma ** 4
    fracs = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.05, 0.02, 0.01], dtype=dtype, device=dev)

    def largest_ok_frac(dsx, dzx, a0, gap_cap):
        """Largest fraction f of step a0 that keeps every cone in the
        neighbourhood and the gap <= gap_cap; 0 if none does."""
        oks = []
        for f in fracs:
            a = a0 * f
            s_t = s + a * dsx
            z_t = z + a * dzx
            gap_t = cones.inner(s_t, z_t)
            mu_t_ = gap_t / N
            det = cones.soc_residual(s_t) * cones.soc_residual(z_t)
            oks.append((gap_t > 0.0) & (gap_t <= gap_cap) & torch.all(det >= g4 * mu_t_ ** 2))
        ok = torch.stack(oks)
        return torch.max(torch.where(ok, fracs, torch.zeros_like(fracs)))

    # a gap increase means the direction is roundoff-dominated: reject
    frac = largest_ok_frac(ds, dz, alpha, gap)

    # --- centering recovery ---
    # frac == 0: take a safeguarded pure-centering step (sigma = 1) that
    # keeps the gap but restores centrality
    alpha_pre = alpha
    if float(frac.item()) == 0.0:
        d_c = mu * e - cones.jordan_mul(lam, lam)
        dx, ds, dz = kkt_dirs_correction(d_c)
        a_c = step_len(ds, dz)
        alpha = a_c * largest_ok_frac(ds, dz, a_c, gap * 1.01)
    else:
        alpha = alpha * frac

    if params.record_diag:
        # the JAX package's order and definitions (score_tpu/solver/ipm.py:715)
        detprod = cones.soc_residual(s) * cones.soc_residual(z)
        f1, f2, f3 = _newton_resid(rx, rz, d_comb, dx, ds, dz)
        tiny = torch.finfo(dtype).tiny
        st.diag = torch.stack([
            alpha,
            frac,
            sigma,
            torch.clamp(gap_a, min=0.0) / gap,
            torch.min(detprod) / torch.clamp(mu ** 2, min=tiny),
            (frac == 0.0).to(dtype),
            alpha_pre,
            norm(f1) + norm(f2) + norm(f3),
        ]).to(dtype)

    x_new = x + alpha * dx
    s_new = s + alpha * ds
    z_new = z + alpha * dz
    finite = (
        torch.isfinite(x_new).all() & torch.isfinite(s_new).all() & torch.isfinite(z_new).all()
    )
    if bool(finite.item()):
        st.x, st.s, st.z = x_new, s_new, z_new
    else:
        st.status = NUMERICAL_ERROR
    st.it += 1


def _initial_point(backend, problem: ConicProblem, ops, params: IPMParams):
    """CVXOPT-coneqp-style start: solve the W = I KKT system, then shift
    s, z to the cone interior."""
    k = problem.k
    # (N, k, k), or (B, N, k, k) for stacked trials
    eyes = torch.eye(k, dtype=ops.q.dtype, device=ops.q.device).expand(
        problem.cone_h.shape[:-1] + (k, k))
    factors0 = backend.factor(problem, ops, eyes, params)
    rhs0 = -ops.q + backend.GT(problem, ops, problem.cone_h)
    pin_contrib = backend.P_matvec(ops, ops.xpin) + backend.GT(
        problem, ops, backend.G(problem, ops, ops.xpin)
    )
    dx0 = backend.solve(problem, ops, factors0, ops.mask * (rhs0 - pin_contrib), params)
    x0 = ops.xpin + dx0
    z_raw = backend.G(problem, ops, x0) - problem.cone_h
    return x0, cones.shift_to_interior(-z_raw), cones.shift_to_interior(z_raw)


def _degenerate_no_cones(backend, problem, ops, params) -> IPMResult:
    """No cones: an equality-pinned unconstrained QP, one factor+solve."""
    N, k = problem.num_cones, problem.k
    eyes = torch.zeros((N, k, k), dtype=ops.q.dtype, device=ops.q.device)
    factors = backend.factor(problem, ops, eyes, params)
    x = ops.xpin + backend.solve(
        problem, ops, factors,
        ops.mask * (-ops.q - backend.P_matvec(ops, ops.xpin)), params,
    )
    zero = x.new_zeros((0, k))
    pobj = 0.5 * x @ backend.P_matvec(ops, x) + ops.q @ x + ops.const
    return IPMResult(x=x, s=zero, z=zero, iterations=0, status=OPTIMAL,
                     pobj=float(pobj.item()), gap=0.0, pres=0.0, dres=0.0)


def _finalize(backend, problem, ops, params, st: _State) -> IPMResult:
    """Evaluate the best iterate seen (folding in the final iterate in
    case the loop exited before bookkeeping saw it) and set the status."""
    conv = _convergence_full(backend, problem, ops, params, st.x, st.s, st.z)
    mf = _metric(conv[2], conv[3], conv[4], conv[5] + ops.const)
    if float(mf.item()) < st.best_metric:
        x, s, z = st.x, st.s, st.z
    else:
        x, s, z = st.best_x, st.best_s, st.best_z
        conv = _convergence_full(backend, problem, ops, params, x, s, z)
    ok, bad, pres, dres, gap, pq = conv[:6]
    one = torch.ones_like(gap)
    relgap = gap / torch.maximum(one, torch.abs(pq + ops.const))
    ok_reduced = (
        (pres < params.tol_feas_reduced)
        & (dres < params.tol_feas_reduced)
        & ((gap < params.tol_gap_reduced) | (relgap < params.tol_gap_reduced))
        & torch.isfinite(gap)
    )
    vals = torch.stack([
        ok.to(gap.dtype), ok_reduced.to(gap.dtype), bad.to(gap.dtype),
        pq + ops.const, gap, pres, dres,
    ]).tolist()
    ok_f, okr_f, bad_f, pobj, gap_f, pres_f, dres_f = vals
    if st.status in INFEASIBLE_STATUSES:
        status = st.status
    elif ok_f:
        status = OPTIMAL
    elif okr_f:
        status = OPTIMAL_INACCURATE
    elif st.status == NUMERICAL_ERROR or bad_f:
        status = NUMERICAL_ERROR
    else:
        status = MAX_ITER
    return IPMResult(x=x, s=s, z=z, iterations=st.it, status=status,
                     pobj=pobj, gap=gap_f, pres=pres_f, dres=dres_f)


def _initial_state(backend, problem, ops, params, warm_start) -> _State:
    if warm_start is not None:
        x0, s0, z0 = warm_start
        s0 = cones.shift_to_interior(s0)
        z0 = cones.shift_to_interior(z0)
    else:
        x0, s0, z0 = _initial_point(backend, problem, ops, params)
    return _State(x=x0, s=s0, z=z0, it=0, status=RUNNING, best_x=x0, best_s=s0,
                  best_z=z0, best_metric=float("inf"), stall=0)


def solve_conic(
    problem: ConicProblem,
    params: IPMParams = IPMParams(),
    backend=ChainArrowBackend,
    backend_aux=None,
    warm_start: Optional[tuple] = None,
    prepared=None,
) -> IPMResult:
    """Solve a ConicProblem on its device. ``backend_aux`` carries the
    backend's static structure (the chain-arrow layout); ``warm_start``
    may be an (x, s, z) triple used instead of the cold start (s, z are
    shifted to the cone interior); ``prepared`` may carry a precomputed
    ``backend.prepare(problem, backend_aux)``."""
    ops = prepared if prepared is not None else backend.prepare(problem, backend_aux)
    if problem.num_cones == 0:
        return _degenerate_no_cones(backend, problem, ops, params)
    st = _initial_state(backend, problem, ops, params, warm_start)
    while st.status == RUNNING and st.it < params.max_iter:
        _advance(backend, problem, ops, params, st)
    return _finalize(backend, problem, ops, params, st)


def _metrics5(backend, problem, ops, params, st: _State) -> torch.Tensor:
    """[pres, dres, gap, pobj, status] of the state's iterate, on its
    device (no synchronisation)."""
    _, _, pres, dres, gap, pq = _convergence_full(
        backend, problem, ops, params, st.x, st.s, st.z)[:6]
    return torch.stack([pres, dres, gap, pq + ops.const,
                        torch.full_like(gap, float(st.status))])


def _fixed_trips(backend, problem, ops, params, num_iters, warm_start, record=None):
    """Exactly ``num_iters`` loop trips; a terminal state is frozen (the
    JAX package's ``lax.scan`` with a ``lax.cond`` on the status).
    Returns (result, xs, metrics), the last two on the device, stacked
    once: with ``record="iterates"`` the iterate and its [pres, dres, gap,
    pobj, status] before the first trip and after each one; with
    ``record="trace"`` (``params.record_diag`` on) those metrics and the
    step's 8 diagnostics after each trip, xs None; else None, None."""
    st = _initial_state(backend, problem, ops, params, warm_start)
    xs, ms = [], []
    if record == "trace":
        st.diag = torch.zeros(8, dtype=st.x.dtype, device=st.x.device)
    elif record == "iterates":
        xs.append(st.x)
        ms.append(_metrics5(backend, problem, ops, params, st))
    for _ in range(num_iters):
        frozen = st.status != RUNNING
        if not frozen:
            _advance(backend, problem, ops, params, st)
        if not record:
            continue
        if record == "iterates":
            xs.append(st.x)
        if frozen:  # a frozen state repeats its last row
            ms.append(ms[-1])
        elif record == "trace":
            ms.append(torch.cat([_metrics5(backend, problem, ops, params, st), st.diag]))
        else:
            ms.append(_metrics5(backend, problem, ops, params, st))
    result = _finalize(backend, problem, ops, params, st)
    if not record:
        return result, None, None
    return result, torch.stack(xs) if xs else None, torch.stack(ms)


def solve_conic_fixed(
    problem: ConicProblem,
    params: IPMParams = IPMParams(),
    num_iters: int = 50,
    backend=ChainArrowBackend,
    backend_aux=None,
) -> IPMResult:
    """Fixed-trip-count variant: exactly ``num_iters`` trips, a terminal
    state frozen. The same result as :func:`solve_conic` with
    ``max_iter = num_iters``."""
    ops = backend.prepare(problem, backend_aux)
    if problem.num_cones == 0:
        return _degenerate_no_cones(backend, problem, ops, params)
    return _fixed_trips(backend, problem, ops, params, num_iters, None)[0]


def solve_conic_traced(
    problem: ConicProblem,
    params: IPMParams = IPMParams(),
    num_iters: int = 50,
    backend=DenseBackend,
    backend_aux=None,
) -> Tuple[IPMResult, torch.Tensor]:
    """Solve while recording per-iteration telemetry: exactly ``num_iters``
    trips, a terminal state frozen. Returns (result, metrics), metrics of
    shape (num_iters, 13) on the problem's device: [pres, dres, gap, pobj,
    status] after each trip, then the step diagnostics [alpha, nbhd_frac,
    sigma, gap_affine / gap, min_detprod / mu^2, centering_flag,
    alpha_pre_nbhd, newton_resid] of the trip's step (a frozen state
    repeats its last row). The rows stay on the device and are stacked
    once: no host read beyond the loop's own. ``backend`` defaults to the
    dense one, as in the JAX package."""
    params = dataclasses.replace(params, record_diag=True)
    ops = backend.prepare(problem, backend_aux)
    result, _, metrics = _fixed_trips(backend, problem, ops, params, num_iters, None,
                                      record="trace")
    return result, metrics


def solve_conic_with_iterates(
    problem: ConicProblem,
    params: IPMParams = IPMParams(),
    num_iters: int = 50,
    backend=ChainArrowBackend,
    backend_aux=None,
    warm_start: Optional[tuple] = None,
    prepared=None,
) -> Tuple[IPMResult, torch.Tensor, torch.Tensor]:
    """Like :func:`solve_conic` but records x after every trip.

    Returns (result, xs, metrics): xs of shape (num_iters + 1, n), the
    starting point first (trips after convergence repeat the converged
    x), and metrics of shape (num_iters + 1, 5) holding [pres, dres, gap,
    pobj, status] at each snapshot. ``warm_start`` and ``prepared`` as in
    :func:`solve_conic`."""
    ops = prepared if prepared is not None else backend.prepare(problem, backend_aux)
    return _fixed_trips(backend, problem, ops, params, num_iters, warm_start,
                        record="iterates")


# ------------------------------------------------------------------ #
# The batched IPM: B trials of one structure in lockstep
# ------------------------------------------------------------------ #


@dataclasses.dataclass
class _BatchState:
    """:class:`_State` of B trials: every field has a leading trial axis,
    the scalars are (B,) tensors (``it``, ``status``, ``stall`` int64)."""

    x: torch.Tensor
    s: torch.Tensor
    z: torch.Tensor
    it: torch.Tensor
    status: torch.Tensor
    best_x: torch.Tensor
    best_s: torch.Tensor
    best_z: torch.Tensor
    best_metric: torch.Tensor
    stall: torch.Tensor


def _lane(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (B,) tensor shaped to broadcast against ``like`` (B, ...)."""
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def _pick(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lane by lane: a where cond, else b."""
    return torch.where(_lane(cond, a), a, b)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _convergence_batch(backend, problem, ops, params: IPMParams, x, s, z):
    """:func:`_convergence_full`, one value a trial."""
    Px = backend.P_matvec(ops, x)
    Gtz = backend.GT(problem, ops, z)
    Gx = backend.G(problem, ops, x)
    rx = ops.mask * (Px + ops.q + Gtz)
    rz = Gx + s - problem.cone_h
    lead = x.shape[:-1]

    def norm(v):
        return trial_norm(v, lead)

    one = torch.ones((), dtype=x.dtype, device=x.device)
    dscale = torch.maximum(one, torch.maximum(norm(Px), torch.maximum(norm(Gtz), ops.qnorm)))
    pscale = torch.maximum(one, torch.maximum(norm(Gx), torch.maximum(norm(s), ops.hnorm)))
    pres = norm(rz) / pscale
    dres = norm(rx) / dscale
    gap = cones.inner(s, z)
    pq = 0.5 * _dot(x, Px) + _dot(ops.q, x)
    relgap = gap / torch.maximum(one, torch.abs(pq + ops.const))
    ok = (pres < params.tol_feas) & (dres < params.tol_feas) & (
        (gap < params.tol_gap_abs) | (relgap < params.tol_gap_rel)
    )
    bad = ~(torch.isfinite(pres) & torch.isfinite(dres) & torch.isfinite(gap))
    return ok, bad, pres, dres, gap, pq, rx, rz, Px, Gtz, Gx


def _advance_book_batch(backend, problem, ops, params, st: _BatchState):
    """Bookkeeping half of a trip, every lane (``score_tpu.solver.ipm.
    _advance_book`` under vmap): best iterate, stall, infeasibility
    certificates and status, as selects. Returns (terminal, rx, rz)."""
    ok, bad, pres, dres, gap, pq, rx, rz, Px, Gtz, Gx = _convergence_batch(
        backend, problem, ops, params, st.x, st.s, st.z
    )
    m = _metric(pres, dres, gap, pq + ops.const)
    improved = m < st.best_metric
    st.best_x = _pick(improved, st.x, st.best_x)
    st.best_s = _pick(improved, st.s, st.best_s)
    st.best_z = _pick(improved, st.z, st.best_z)
    st.best_metric = torch.minimum(m, st.best_metric)
    st.stall = torch.where(improved, 0, st.stall + 1)

    lead = st.x.shape[:-1]
    tol_i = params.tol_infeas
    znorm = trial_norm(st.z, lead)
    # Farkas: on the free subspace the effective rhs is h - G xpin
    hz = torch.sum((problem.cone_h * st.z).flatten(-2), dim=-1) - _dot(ops.xpin, Gtz)
    pinf = (znorm > params.infeas_norm_gate) & (hz < -tol_i * znorm) & (
        trial_norm(ops.mask * Gtz, lead) < tol_i * znorm
    )
    xnorm = trial_norm(st.x, lead)
    if problem.cone_h.shape[-2]:
        ray_in_cone = torch.amin(cones.min_eig(-Gx), dim=-1) > -tol_i * xnorm
    else:
        ray_in_cone = torch.ones_like(xnorm, dtype=torch.bool)
    dinf = (
        (xnorm > params.infeas_norm_gate)
        & (_dot(ops.q, st.x) < -tol_i * xnorm)
        & (trial_norm(ops.mask * Px, lead) < tol_i * xnorm)
        & ray_in_cone
    )
    stalled = st.stall >= params.stall_limit
    running = st.status == RUNNING
    terminal = ok | bad | stalled | pinf | dinf | ~running
    code = torch.full_like(st.status, RUNNING)
    for flag, value in ((stalled, MAX_ITER), (bad, NUMERICAL_ERROR), (dinf, DUAL_INFEASIBLE),
                        (pinf, PRIMAL_INFEASIBLE), (ok, OPTIMAL)):
        code = torch.where(flag, value, code)  # the first that holds, in this order
    st.status = torch.where(running, code, st.status)
    return terminal, rx, rz


def _step_batch(backend, problem, ops, params: IPMParams, st: _BatchState, rx, rz,
                shared_refine: Optional[bool], shared_center: bool, fracs: torch.Tensor):
    """The Mehrotra step of every lane (``score_tpu.solver.ipm._step``,
    branchless, under vmap): returns the stepped (x, s, z, status).

    ``shared_refine`` (None when the refinement gate is off) and
    ``shared_center`` are the batch's gates: while one is False no lane
    runs that solve. A lane refines its combined direction iff its own
    gate is open; a lane whose step fraction hits 0 takes the centering
    step if the batch's gate is open, else a frozen step (alpha = 0),
    whose stall counter opens the gate on the next trip."""
    x, s, z = st.x, st.s, st.z
    N = problem.cone_h.shape[-2]
    dtype = x.dtype
    lead = x.shape[:-1]

    def norm(v):
        return trial_norm(v, lead)

    def lane(t):  # (B,) against (B, N, k)
        return t[..., None, None]

    nt = cones.nt_scaling(s, z)
    lam = cones.apply_W(nt, z)
    Winv2 = cones.winv2_matrices(nt)
    factors = backend.factor(problem, ops, Winv2, params)

    gap = cones.inner(s, z)
    mu = gap / N

    def _condensed(rx_, rz_, d):
        v = cones.apply_W(nt, cones.jordan_solve(lam, d))  # W (lambda \ d)
        rzv = rz_ + v
        wrz = cones.apply_Winv2(nt, rzv)
        rhs = ops.mask * (-rx_ - backend.GT(problem, ops, wrz))
        dx = backend.solve(problem, ops, factors, rhs, params)
        Gdx = backend.G(problem, ops, dx)
        dz = cones.apply_Winv2(nt, Gdx + rzv)
        ds = -rz_ - Gdx
        return dx, ds, dz

    def _newton_resid(rx_, rz_, d, dx, ds, dz):
        f1 = ops.mask * (-rx_ - backend.P_matvec(ops, dx) - backend.GT(problem, ops, dz))
        f2 = -rz_ - backend.G(problem, ops, dx) - ds
        f3 = d - cones.jordan_mul(lam, cones.apply_Winv(nt, ds) + cones.apply_W(nt, dz))
        return f1, f2, f3

    def refined(rx_, rz_, d, dirs):
        dx, ds, dz = dirs
        for _ in range(params.dir_refine_steps):
            f1, f2, f3 = _newton_resid(rx_, rz_, d, dx, ds, dz)
            r0 = norm(f1) + norm(f2) + norm(f3)
            cx, cs, cz = _condensed(-f1, -f2, f3)
            nx, ns, nz = dx + cx, ds + cs, dz + cz
            g1, g2, g3 = _newton_resid(rx_, rz_, d, nx, ns, nz)
            better = (norm(g1) + norm(g2) + norm(g3)) < r0
            dx, ds, dz = _pick(better, nx, dx), _pick(better, ns, ds), _pick(better, nz, dz)
        return dx, ds, dz

    def refine_dirs(rx_, rz_, d, dirs):
        if params.dir_refine_steps == 0:
            return dirs
        if params.dir_refine_gate <= 0.0:
            return refined(rx_, rz_, d, dirs)
        if not shared_refine:  # no lane near convergence: no lane refines
            return dirs
        near = st.best_metric < params.dir_refine_gate
        new = refined(rx_, rz_, d, dirs)
        return tuple(_pick(near, a, b) for a, b in zip(new, dirs))

    def kkt_dirs(d):
        return refine_dirs(rx, rz, d, _condensed(rx, rz, d))

    def kkt_dirs_correction(d):
        return _condensed(torch.zeros_like(rx), torch.zeros_like(rz), d)

    def step_len(ds_, dz_):
        return torch.clamp(
            params.step_fraction
            * torch.minimum(cones.max_step(s, ds_), cones.max_step(z, dz_)),
            max=1.0,
        )

    # --- affine (predictor) direction ---
    d_aff = -cones.jordan_mul(lam, lam)
    if params.refine_affine:
        dx_a, ds_a, dz_a = kkt_dirs(d_aff)
    else:
        dx_a, ds_a, dz_a = _condensed(rx, rz, d_aff)
    alpha_a = torch.clamp(
        torch.minimum(cones.max_step(s, ds_a), cones.max_step(z, dz_a)), max=1.0
    )
    gap_a = cones.inner(s + lane(alpha_a) * ds_a, z + lane(alpha_a) * dz_a)
    sigma = torch.clamp((torch.clamp(gap_a, min=0.0) / gap) ** 3, 0.0, 1.0)

    # --- combined (corrector) direction ---
    e = cones.soc_identity(N, problem.k, dtype, x.device)
    correction = cones.jordan_mul(cones.apply_Winv(nt, ds_a), cones.apply_W(nt, dz_a))
    d_comb = d_aff - correction + lane(sigma * mu) * e
    dx, ds, dz = kkt_dirs(d_comb)
    alpha = step_len(ds, dz)

    # --- Gondzio multiple centrality correctors ---
    mu_t = sigma * mu
    lo = lane(params.gondzio_beta_min * mu_t)
    hi = lane(params.gondzio_beta_max * mu_t)
    for _ in range(params.gondzio_correctors):
        a_trial = lane(torch.clamp(1.1 * alpha + 0.1, max=1.0))
        prod = cones.jordan_mul(
            cones.apply_Winv(nt, s + a_trial * ds), cones.apply_W(nt, z + a_trial * dz)
        )
        head = prod[..., :1]
        d_extra = torch.cat([torch.minimum(torch.maximum(head, lo), hi) - head,
                             -prod[..., 1:]], dim=-1)
        # only correct meaningfully off-center cones
        off = (head < lo) | (head > hi)
        d_extra = torch.where(off, d_extra, torch.zeros_like(d_extra))
        dx_c, ds_c, dz_c = kkt_dirs_correction(d_extra)
        dx_n, ds_n, dz_n = dx + dx_c, ds + ds_c, dz + dz_c
        alpha_n = step_len(ds_n, dz_n)
        accept = alpha_n > alpha * 1.01
        dx, ds, dz = _pick(accept, dx_n, dx), _pick(accept, ds_n, ds), _pick(accept, dz_n, dz)
        alpha = torch.where(accept, alpha_n, alpha)

    # --- wide-neighbourhood safeguard ---
    g4 = params.nbhd_gamma ** 4

    def largest_ok_frac(dsx, dzx, a0, gap_cap):
        """Each lane's largest fraction f of its step a0 that keeps every
        cone in the neighbourhood and the gap <= gap_cap; 0 if none does."""
        best = torch.zeros_like(a0)
        for f in fracs:
            a = lane(a0 * f)
            s_t = s + a * dsx
            z_t = z + a * dzx
            gap_t = cones.inner(s_t, z_t)
            mu_t_ = gap_t / N
            det = cones.soc_residual(s_t) * cones.soc_residual(z_t)
            ok = (gap_t > 0.0) & (gap_t <= gap_cap) & torch.all(
                det >= g4 * mu_t_[..., None] ** 2, dim=-1)
            best = torch.maximum(best, torch.where(ok, f, 0.0))
        return best

    # a gap increase means the direction is roundoff-dominated: reject
    frac = largest_ok_frac(ds, dz, alpha, gap)

    # --- centering recovery, lane by lane behind the batch's gate ---
    use_c = frac == 0.0
    if shared_center:
        d_c = lane(mu) * e - cones.jordan_mul(lam, lam)
        dxc, dsc, dzc = kkt_dirs_correction(d_c)
        a_c = step_len(dsc, dzc)
        calpha = a_c * largest_ok_frac(dsc, dzc, a_c, gap * 1.01)
        dx, ds, dz = _pick(use_c, dxc, dx), _pick(use_c, dsc, ds), _pick(use_c, dzc, dz)
    else:  # the frozen step
        calpha = torch.zeros_like(alpha)
        dx, ds, dz = (_pick(use_c, torch.zeros_like(t), t) for t in (dx, ds, dz))
    alpha = torch.where(use_c, calpha, alpha * frac)

    x_new = x + alpha[..., None] * dx
    s_new = s + lane(alpha) * ds
    z_new = z + lane(alpha) * dz
    finite = (torch.isfinite(x_new).all(-1) & torch.isfinite(s_new).flatten(-2).all(-1)
              & torch.isfinite(z_new).flatten(-2).all(-1))
    return (_pick(finite, x_new, x), _pick(finite, s_new, s), _pick(finite, z_new, z),
            torch.where(finite, st.status, NUMERICAL_ERROR))


def _advance_apply_batch(backend, problem, ops, params, st: _BatchState, terminal, rx, rz,
                         shared_refine, shared_center, fracs) -> None:
    """Step half of a trip: every lane stepped, the terminal ones kept."""
    x, s, z, status = _step_batch(backend, problem, ops, params, st, rx, rz,
                                  shared_refine, shared_center, fracs)
    st.x = _pick(terminal, st.x, x)
    st.s = _pick(terminal, st.s, s)
    st.z = _pick(terminal, st.z, z)
    st.it = torch.where(terminal, st.it, st.it + 1)
    st.status = torch.where(terminal, st.status, status)


def _finalize_batch(backend, problem, ops, params, st: _BatchState) -> IPMResult:
    """:func:`_finalize`, lane by lane."""
    conv = _convergence_batch(backend, problem, ops, params, st.x, st.s, st.z)
    better = _metric(conv[2], conv[3], conv[4], conv[5] + ops.const) < st.best_metric
    x = _pick(better, st.x, st.best_x)
    s = _pick(better, st.s, st.best_s)
    z = _pick(better, st.z, st.best_z)
    ok, bad, pres, dres, gap, pq = _convergence_batch(backend, problem, ops, params, x, s, z)[:6]
    one = torch.ones_like(gap)
    relgap = gap / torch.maximum(one, torch.abs(pq + ops.const))
    ok_reduced = (
        (pres < params.tol_feas_reduced)
        & (dres < params.tol_feas_reduced)
        & ((gap < params.tol_gap_reduced) | (relgap < params.tol_gap_reduced))
        & torch.isfinite(gap)
    )
    status = torch.where(bad | (st.status == NUMERICAL_ERROR), NUMERICAL_ERROR, MAX_ITER)
    status = torch.where(ok_reduced, OPTIMAL_INACCURATE, status)
    status = torch.where(ok, OPTIMAL, status)
    infeasible = (st.status == PRIMAL_INFEASIBLE) | (st.status == DUAL_INFEASIBLE)
    status = torch.where(infeasible, st.status, status)
    return IPMResult(x=x, s=s, z=z, iterations=st.it, status=status,
                     pobj=pq + ops.const, gap=gap, pres=pres, dres=dres)


def solve_batch(problem: ConicProblem, params: IPMParams, backend, ops,
                reduce_over=None) -> Tuple[IPMResult, int]:
    """Solve B stacked trials (every field of ``problem`` with a leading
    trial axis; ``ops`` = ``backend.prepare(problem, aux)``) in lockstep:
    the loop stops once no lane runs or after ``params.max_iter`` trips.
    Returns (result, trips). One host read a trip.

    ``reduce_over``: None, no collective; else the resolved
    ``torch.distributed`` group of a trial-sharded batch (each rank holds
    its own trials; ``collective.process_group(...)[0]``), over which the
    trip's four flags (a lane ran, a lane lives, the two shared gates) are
    reduced by one ``all_reduce`` (max) before that read: the gates and the loop condition are
    the whole batch's, so every rank runs the same trips and each lane the
    path it takes in the unsharded batch."""
    x0, s0, z0 = _initial_point(backend, problem, ops, params)
    lead = x0.shape[:-1]
    dev = x0.device
    zero = torch.zeros(lead, dtype=torch.int64, device=dev)
    st = _BatchState(x=x0, s=s0, z=z0, it=zero, status=zero + RUNNING, best_x=x0,
                     best_s=s0, best_z=z0, stall=zero,
                     best_metric=torch.full(lead, float("inf"), dtype=x0.dtype, device=dev))
    fracs = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.05, 0.02, 0.01], dtype=x0.dtype,
                         device=dev).unbind()
    gate_refine = params.dir_refine_gate > 0.0 and params.dir_refine_steps > 0
    trips = 0
    while trips < params.max_iter:
        ran = (st.status == RUNNING).any()
        terminal, rx, rz = _advance_book_batch(backend, problem, ops, params, st)
        live = ~terminal
        near = ((st.best_metric < params.dir_refine_gate) & live).any()
        center = near | ((st.stall > 0) & live).any()
        flags = torch.stack([ran, live.any(), near, center])
        if reduce_over is not None:  # the whole batch's flags
            flags = all_reduce(flags.to(torch.int32), reduce_over, op="max")
        # the one host read of the trip
        ran, any_live, near, center = (bool(f) for f in flags.tolist())
        if not ran:  # every lane ended in the last step: no trip
            break
        trips += 1
        if not any_live:
            break
        _advance_apply_batch(backend, problem, ops, params, st, terminal, rx, rz,
                             near if gate_refine else None, center, fracs)
    return _finalize_batch(backend, problem, ops, params, st), trips
