"""The port's refinement stage (``score_tpu_torch/refine/lm.py``) against the
JAX package's (``score_tpu/refine/lm.py``) on the CPU, and the utilities
ported with it (trajectory metrics, matrix helpers, circles, checkpoints,
telemetry).

Both packages refine from the same start: the port's SOCP solve of the
same graph (the JAX package's ``refine_solution`` reads any object with
``poses``, ``landmarks`` and ``distances``), so a difference is the
refinement's own.

Tolerances, and why:

- the Jacobian products J·v and J'·u (and the residual) within 1e-12 of the
  larger entry: the same linear algebra, rounded in another order;
- ``_exp_so3`` within 1e-15 (entries of order one; one rounding of the
  sine and cosine);
- whole 2D refinements: equal iterations, ``initial_cost`` and ``cost``
  within 1e-9 relative, poses and landmarks within 1e-7, over the full
  iteration count (4-60). The conjugate gradients run a fixed number of
  trips; where they outrun the tangent space (31 directions on the 1 x 10
  worlds) or the Krylov space that the damping leaves well conditioned,
  the later trips amplify roundoff by up to 1 / lambda, in both packages:
  on the two outlier worlds at the default 60 trips the JAX package's own
  final cost moves by 2e-6 to 5e-3 relative (and its iteration count by
  one) under a 1e-15 relative move of its start. Those worlds run 8 and 15
  trips here, below where that noise enters (the two packages then agree
  to 7e-12 and 1e-13: ``python tests/torch_reference_data.py
  --refine-roundoff``), and the default parameters are held to the
  property the JAX package's own test checks on them;
- 3D: the port lowers the true cost, and keeps every rotation in SO(3) to
  1e-9. The JAX package's 3D refinement is a no-op (its ``_exp_so3`` has a
  NaN transpose at zero), which a test here records, so that a repair of
  the reference shows up; so is the port's other departure, a stall
  counter that starts at the first accepted step;
- the metrics, matrix and circle helpers are numpy in both packages:
  equal bit for bit.
"""

import dataclasses
import functools
import logging
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from score_tpu.fg.measurements import FGRangeMeasurement as RefRange
from score_tpu.refine import RefineParams as RefRefineParams
from score_tpu.refine import lm as ref_lm
from score_tpu.refine import refine_solution as ref_refine_solution
from score_tpu.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world
from score_tpu.utils import circles as ref_circles
from score_tpu.utils import matrix as ref_matrix
from score_tpu.utils import metrics as ref_metrics
from tests import torch_reference_data

from score_tpu_torch import RefineParams, ScoreSolverParams, refine_solution, solve_score
from score_tpu_torch.convert import factor_graph_from_reference
from score_tpu_torch.refine import lm
from score_tpu_torch.utils import checkpoint, circles, matrix, metrics, telemetry

torch.set_num_threads(1)


def _true_cost(fg, values):
    """The nonlinear MLE objective evaluated at named values (host; a copy
    of ``tests/test_refine.py:_true_cost``)."""
    d = fg.dimension
    c = 0.0
    meas = [m for chain in fg.odom_measurements for m in chain]
    meas += list(fg.loop_closure_measurements)
    for m in meas:
        Ti = np.asarray(values.poses[m.base_pose])
        Tj = np.asarray(values.poses[m.to_pose])
        Ri, ti = Ti[:d, :d], Ti[:d, d]
        Rj, tj = Tj[:d, :d], Tj[:d, d]
        c += m.rotation_precision * np.sum((Rj - Ri @ np.asarray(m.rotation_matrix)) ** 2)
        c += m.translation_precision * np.sum(
            (tj - ti - Ri @ np.asarray(m.translation_vector)) ** 2)
    for r in fg.range_measurements:
        def pos(name):
            if name in values.poses:
                return np.asarray(values.poses[name])[:d, d]
            return np.asarray(values.landmarks[name])
        dist = np.linalg.norm(pos(r.first_key) - pos(r.second_key))
        c += r.precision * (dist - r.dist) ** 2
    for p in fg.landmark_priors:
        c += p.translation_precision * np.sum(
            (np.asarray(values.landmarks[p.name]) - np.asarray(p.position)[:d]) ** 2)
    return float(c)


def _outlier_world():
    """The 2 x 20 world of ``tests/test_refine.py::test_robust_refine_rejects_outliers``:
    a tenth of its ranges 60 m too long."""
    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=20, num_landmarks=3, grid_size=8,
        range_measure_prob=0.5, seed=4))
    rng = np.random.default_rng(0)
    ms = list(fg.range_measurements)
    for i in rng.choice(len(ms), size=max(2, len(ms) // 10), replace=False):
        m = ms[i]
        ms[i] = RefRange(tuple(m.association), m.dist + 60.0, m.stddev, m.timestamp)
    fg.range_measurements = ms
    return fg, dict(tol_gap_reduced=1e-3)


def _sim(seed):
    """A world of ``tests/test_refine.py:_sim``; seed 9 with the gross range
    outlier its ``test_refine_params_passthrough_solve_score`` adds."""
    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=1, num_poses_per_robot=10, num_landmarks=2, grid_size=4,
        range_measure_prob=0.5, seed=seed))
    if seed == 9:
        fg.range_measurements[0].dist += 25.0
    return fg, {}


WORLDS = {
    "sim3": lambda: _sim(3),
    "sim7": lambda: _sim(7),
    "sim9_outlier": lambda: _sim(9),
    "outliers_2x20": _outlier_world,
    "3d_2x30": lambda: (torch_reference_data.world_3d(), {}),
}


@functools.lru_cache(maxsize=None)
def _world(name):
    """(JAX package's graph, the port's graph, the port's SOCP solve of it on
    the CPU, 40 iterations at most): the refinements' common start."""
    ref_fg, extra = WORLDS[name]()
    fg = factor_graph_from_reference(ref_fg)
    start = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", max_iter=40, **extra))
    assert start.solved
    return ref_fg, fg, start


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# ----------------------------------------------------------------------------
# the exponential map and the Jacobian products
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.0, 1e-7, 3e-7, 1e-5, 0.3, 2.5])
def test_exp_so3_matches_reference(scale):
    """At zero, below the series branch's threshold (theta^2 < 1e-12) and
    above it: the reference's values within 1e-15."""
    w = np.random.default_rng(11).standard_normal((16, 3))
    w *= scale / np.linalg.norm(w, axis=1, keepdims=True)
    ours = lm._exp_so3(torch.tensor(w)).numpy()
    ref = np.asarray(ref_lm._exp_so3(jnp.asarray(w)))
    assert np.max(np.abs(ours - ref)) <= 1e-15
    assert np.allclose(np.swapaxes(ours, -1, -2) @ ours, np.eye(3), atol=1e-14)


def _closures(name, seed):
    """The residual of a tangent step, in both packages, at the world's
    start with random robust weights on the ranges."""
    ref_fg, fg, start = _world(name)
    rg, pose_names, lm_names = ref_lm._compile_graph(ref_fg)
    g, _, _ = lm._compile_graph(fg, "cpu")
    d = fg.dimension
    T = np.stack([start.poses[n] for n in pose_names])
    lms = np.stack([start.landmarks[n] for n in lm_names])
    n = g.P * g.rdim + g.P * d + g.L * d
    mask = np.ones(n)
    mask[: g.rdim] = 0.0
    mask[g.P * g.rdim: g.P * g.rdim + d] = 0.0
    rng = np.random.default_rng(seed)
    w = 0.5 + rng.random(g.rng_d.shape[0])
    ref_base = (jnp.asarray(T[:, :d, :d]), jnp.asarray(T[:, :d, d]), jnp.asarray(lms))
    base = tuple(torch.tensor(a) for a in (T[:, :d, :d], T[:, :d, d], lms))
    jmask, tmask = jnp.asarray(mask), torch.tensor(mask)

    def ref_f(delta):
        return ref_lm._residuals(rg, *ref_lm._retract(rg, ref_base, delta, jmask),
                                 rng_w=jnp.asarray(w))

    def f(delta):
        return lm._residuals(g, *lm._retract(g, base, delta, tmask), rng_w=torch.tensor(w))

    return ref_f, f, n, rng


@pytest.mark.parametrize("name", ["sim3", "3d_2x30"])
def test_jacobian_products_match_reference(name):
    """At a random non-zero tangent and at the zero tangent (where every
    outer iteration linearizes): the residual and J·v of the port
    (torch.func) within 1e-12 of the JAX package's (jax.linearize), the
    port's J'·u finite, within 1e-12 of the JAX package's
    (jax.linear_transpose) wherever that is finite, and the adjoint of the
    JAX package's J (<u, J v> = <J'u, v>). In 2D the JAX package's J'·u is
    finite everywhere; in 3D it is NaN in the pinned first rotation (its
    tangent is always zero) and, at the zero tangent, everywhere a rotation
    enters: ``_exp_so3``'s transpose at zero."""
    ref_f, f, n, rng = _closures(name, seed=5)

    @jax.jit
    def ref_products(delta, v, u):
        r, jvp = jax.linearize(ref_f, delta)
        (jtu,) = jax.linear_transpose(jvp, delta)(u)
        return r, jvp(v), jtu

    for delta in (0.05 * rng.standard_normal(n), np.zeros(n)):
        r, jvp_fn, vjp_fn = lm._linearize(f, torch.tensor(delta))
        for _ in range(3):
            v, u = rng.standard_normal(n), rng.standard_normal(r.shape[0])
            r_ref, jv_ref, jtu_ref = (np.asarray(a) for a in ref_products(
                jnp.asarray(delta), jnp.asarray(v), jnp.asarray(u)))
            jv = jvp_fn(torch.tensor(v)).numpy()
            jtu = vjp_fn(torch.tensor(u)).numpy()
            assert _rel(r.numpy(), r_ref) <= 1e-12
            assert _rel(jv, jv_ref) <= 1e-12
            assert np.isfinite(jtu).all()
            assert abs(u @ jv_ref - jtu @ v) <= 1e-12 * np.abs(u).max() * np.abs(jv_ref).sum()
            finite = np.isfinite(jtu_ref)
            assert _rel(jtu[finite], jtu_ref[finite]) <= 1e-12
            if name == "sim3":
                assert finite.all()
            else:
                assert not finite[:3].any()
                assert finite[3:].all() == bool(delta.any())


# ----------------------------------------------------------------------------
# whole refinements
# ----------------------------------------------------------------------------


# (world, cg_iters): the defaults' 60 trips where CG does not outrun its
# tangent space; fewer on the outlier worlds (see the module docstring)
PARITY_2D = [("sim3", 60), ("sim7", 60), ("sim9_outlier", 8), ("outliers_2x20", 15)]


@pytest.mark.parametrize("robust", ["none", "huber", "gm"])
@pytest.mark.parametrize("name, cg_iters", PARITY_2D)
def test_refinement_matches_reference_2d(name, cg_iters, robust):
    ref_fg, fg, start = _world(name)
    ours = refine_solution(fg, start.variables, RefineParams(robust=robust, cg_iters=cg_iters),
                           device="cpu")
    ref = ref_refine_solution(ref_fg, start.variables,
                              RefRefineParams(robust=robust, cg_iters=cg_iters))
    assert ours.iterations == ref.iterations
    assert abs(ours.initial_cost - ref.initial_cost) <= 1e-9 * abs(ref.initial_cost)
    assert abs(ours.cost - ref.cost) <= 1e-9 * abs(ref.cost)
    assert ours.cost < ours.initial_cost
    for key, T in ref.values.poses.items():
        assert np.max(np.abs(ours.values.poses[key] - np.asarray(T))) <= 1e-7
    for key, p in ref.values.landmarks.items():
        assert np.max(np.abs(ours.values.landmarks[key] - np.asarray(p))) <= 1e-7
    assert ours.values.distances.keys() == start.variables.distances.keys()


def test_robust_refinement_rejects_outliers():
    """The property ``tests/test_refine.py::test_robust_refine_rejects_outliers``
    holds the JAX package to, at the default parameters: on the 2 x 20 world
    with a tenth of its ranges 60 m too long, GNC Geman-McClure beats plain
    least squares on ATE, and comes within 0.5 m of the ground truth."""
    _, fg, start = _world("outliers_2x20")

    def ate_of(values):
        r = dataclasses.replace(start, variables=values)
        return max(v["rmse"] for v in metrics.ate_against_ground_truth(r, fg).values())

    r_ls = refine_solution(fg, start.variables, RefineParams(robust="none"), device="cpu")
    r_gm = refine_solution(fg, start.variables, RefineParams(robust="gm", robust_delta=3.0),
                           device="cpu")
    ate_ls, ate_gm = ate_of(r_ls.values), ate_of(r_gm.values)
    assert ate_gm < ate_ls
    assert ate_gm < 0.5


def test_refinement_lowers_true_cost_3d():
    """The 2 x 30 3D world from its SOCP solve (10 iterations: the cost
    falls from 9.8e5 to 8.6e3; 60 reach 1.0e3)."""
    _, fg, start = _world("3d_2x30")
    out = refine_solution(fg, start.variables, RefineParams(max_iter=10), device="cpu")
    c_init, c_ref = _true_cost(fg, start.variables), _true_cost(fg, out.values)
    assert out.iterations == 10
    assert abs(out.initial_cost - c_init) <= 1e-9 * c_init
    assert abs(out.cost - c_ref) <= 1e-9 * c_ref
    assert c_ref < 0.1 * c_init
    for T in out.values.poses.values():
        R = T[:3, :3]
        assert np.max(np.abs(R.T @ R - np.eye(3))) <= 1e-9
        assert abs(np.linalg.det(R) - 1.0) <= 1e-9


def test_reference_refinement_3d_is_a_no_op():
    """The JAX package's 3D refinement: every right-hand side -J'r is NaN
    (``_exp_so3``'s transpose at zero), every trial rejected, and the stall
    rule stops it after 3 iterations with the start returned. This fails
    once the reference is repaired; the port's departure is then void."""
    ref_fg, _, start = _world("3d_2x30")
    ref = ref_refine_solution(ref_fg, start.variables, RefRefineParams())
    assert ref.iterations == RefRefineParams().stall_limit
    assert ref.cost == ref.initial_cost
    for key, T in start.poses.items():
        np.testing.assert_array_equal(np.asarray(ref.values.poses[key]), T)


def test_refinement_continues_past_rejected_first_steps():
    """The port's one departure from the reference's stall rule: stalls
    count from the first accepted step. On the 6-pose graph of
    ``tests/test_cli.py`` the first three trials (lambda 1e-4 to 1.6e-3)
    raise the cost; the JAX package counts them as stalls and returns the
    start after 3 iterations, the port goes on raising lambda until a step
    is accepted (38.05 -> 0.97)."""
    ref_fg = torch_reference_data.cli_graph(loop=False)
    fg = factor_graph_from_reference(ref_fg)
    start = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", max_iter=30))
    ref = ref_refine_solution(ref_fg, start.variables, RefRefineParams())
    ours = refine_solution(fg, start.variables, RefineParams(), device="cpu")
    assert ref.iterations == RefRefineParams().stall_limit and ref.cost == ref.initial_cost
    assert abs(ours.initial_cost - ref.initial_cost) <= 1e-9 * ref.initial_cost
    assert ours.iterations > ref.iterations
    assert ours.cost < 0.1 * ours.initial_cost
    assert abs(ours.cost - _true_cost(fg, ours.values)) <= 1e-9 * ours.cost


# ----------------------------------------------------------------------------
# the solve API
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("robust", [None, "huber"])
def test_solve_score_refine_is_refine_solution(robust):
    """solve_score(refine=True) is refine_solution of the unrefined result,
    on the solve's device, with ``refine_params`` passed through; the
    solve's digits and the memo's entry are left as they were."""
    _, fg, start = _world("sim9_outlier")
    rp = None if robust is None else RefineParams(robust=robust, robust_delta=3.0)
    params = ScoreSolverParams(device="cpu", max_iter=40, refine=True, refine_params=rp)
    refined = solve_score(fg, "SOCP", params)
    direct = refine_solution(fg, start.variables, rp or RefineParams(), device="cpu")
    for key in ("solved", "iterations", "primal_objective", "gap", "dual_residual"):
        assert getattr(refined, key) == getattr(start, key)
    for key, T in direct.values.poses.items():
        np.testing.assert_array_equal(refined.poses[key], T)
    for key, p in direct.values.landmarks.items():
        np.testing.assert_array_equal(refined.landmarks[key], p)
    again = solve_score(fg, "SOCP", dataclasses.replace(params, refine=False))
    for key, T in start.poses.items():
        np.testing.assert_array_equal(again.poses[key], T)


def test_refine_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    _, fg, start = _world("sim3")
    with pytest.raises(RuntimeError, match="cuda"):
        refine_solution(fg, start.variables)


# ----------------------------------------------------------------------------
# metrics, matrix helpers, circles, checkpoints, telemetry
# ----------------------------------------------------------------------------


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _points(seed, n=40, d=3):
    rng = np.random.default_rng(seed)
    est = rng.standard_normal((n, d))
    R = ref_matrix.get_random_rotation_matrix(d, np.random.default_rng(seed + 1))
    return est, est @ R.T + 0.01 * rng.standard_normal((n, d)) + 2.0


METRIC_CASES = {
    "umeyama": lambda m: m.umeyama_alignment(*_points(1)),
    "umeyama_scale": lambda m: m.umeyama_alignment(*_points(2, d=2), with_scale=True),
    "ate": lambda m: m.compute_ate(*_points(3)),
    "ate_unaligned": lambda m: m.compute_ate(*_points(4, d=2), align=False),
    "rpe": lambda m: m.compute_rpe(*_points(5)),
    "rpe_delta3": lambda m: m.compute_rpe(*_points(6, d=2), delta=3),
}


@pytest.mark.parametrize("case", list(METRIC_CASES))
def test_metrics_match_reference(case):
    _same(METRIC_CASES[case](metrics), METRIC_CASES[case](ref_metrics))


@pytest.mark.parametrize("name", ["outliers_2x20", "3d_2x30"])
def test_ate_against_ground_truth_matches_reference(name):
    ref_fg, fg, start = _world(name)
    _same(metrics.ate_against_ground_truth(start, fg),
          ref_metrics.ate_against_ground_truth(start, ref_fg))


def _rng():
    return np.random.default_rng(7)


MATRIX_CASES = {
    "theta": lambda m: m.get_theta_from_rotation_matrix(m.get_rotation_matrix_from_theta(2.1)),
    "theta_projection": lambda m: m.get_theta_from_rotation_matrix_so_projection(
        np.array([[0.9, -0.5], [0.4, 1.1]])),
    "quat_2d": lambda m: m.get_quat_from_rotation_matrix(m.get_rotation_matrix_from_theta(-0.7)),
    "quat_3d": lambda m: m.get_quat_from_rotation_matrix(m.get_random_rotation_matrix(3, _rng())),
    "from_quat": lambda m: m.get_rotation_matrix_from_quat([0.1, -0.3, 0.5, 0.8]),
    "random_vector": lambda m: m.get_random_vector(3, [0, 1, -2, 2, 5, 6], _rng()),
    "random_rotation_2d": lambda m: m.get_random_rotation_matrix(2, _rng()),
    "random_transform_3d": lambda m: m.get_random_transformation_matrix(3, _rng()),
    "from_theta": lambda m: m.make_transformation_matrix_from_theta(0.4, [1.0, -2.0]),
    "perturbation": lambda m: m.apply_transformation_matrix_perturbation(
        m.make_transformation_matrix_from_theta(0.4, [1.0, -2.0]), 0.3, 0.1, _rng()),
    "round_3d": lambda m: m.round_to_special_orthogonal(
        m.get_random_rotation_matrix(3, _rng()) + 0.05 * _rng().standard_normal((3, 3))),
    "round_reflection": lambda m: m.round_to_special_orthogonal(np.diag([1.0, -1.0])),
    "transform_parts": lambda m: (
        m.get_rotation_from_transformation_matrix(m.get_random_transformation_matrix(3, _rng())),
        m.get_translation_from_transformation_matrix(
            m.get_random_transformation_matrix(2, _rng())),
        m.get_theta_from_transformation_matrix(
            m.make_transformation_matrix_from_theta(1.3, [0.0, 1.0])),
        m.get_quat_from_transformation_matrix(m.get_random_transformation_matrix(3, _rng())),
        m.get_matrix_determinant(np.array([[2.0, 1.0], [1.0, 3.0]]))),
    "eigvals": lambda m: m.print_eigvals(np.array([[2.0, 1.0], [1.0, 3.0]]), name="M"),
}


@pytest.mark.parametrize("case", list(MATRIX_CASES))
def test_matrix_helpers_match_reference(case, capsys):
    ours = MATRIX_CASES[case](matrix)
    ours_out = capsys.readouterr().out
    ref = MATRIX_CASES[case](ref_matrix)
    _same(ours, ref)
    assert ours_out == capsys.readouterr().out


@pytest.mark.parametrize("check, arg", [
    ("_check_rotation_matrix", np.array([[1.0, 0.2], [0.0, 1.0]])),
    ("_check_transformation_matrix", np.array([[1.0, 0.0, 1.0], [0.0, 1.0, 2.0], [0.0, 0.5, 1.0]])),
    ("_check_is_laplacian", np.array([[1.0, -1.0], [-1.0, 2.0]])),
    ("_check_psd", np.array([[1.0, 2.0], [2.0, 1.0]])),
])
def test_matrix_validators_match_reference(check, arg):
    """Each validator refuses what the reference's refuses, with the same
    exception type, and passes its valid counterpart."""
    kwargs = {"assert_test": True} if check == "_check_rotation_matrix" else {}
    with pytest.raises(Exception) as ref_err:
        getattr(ref_matrix, check)(arg, **kwargs)
    with pytest.raises(type(ref_err.value)):
        getattr(matrix, check)(arg, **kwargs)
    good = {"_check_transformation_matrix": np.eye(3), "_check_is_laplacian":
            np.array([[1.0, -1.0], [-1.0, 1.0]])}.get(check, np.eye(2))
    getattr(matrix, check)(good)


def test_circles_match_reference():
    def run(c):
        inter = c.CircleIntersection()
        for (x, y), r in (((0.0, 0.0), 2.0), ((1.5, 0.2), 1.6), ((0.5, 1.2), 1.4)):
            inter.add_circle(c.Circle(c.Point(x, y), r))
        arcs = [(a.center.x, a.center.y, a.radius, a.thetas) for a in inter.boundary_arcs()]
        arcs.append(inter.boundary_polygon(resolution=8).tolist())
        pair = c.disk_interval_on_circle(c.Circle(c.Point(0, 0), 1.0),
                                         c.Circle(c.Point(1, 0), 1.0))
        ivs = c.intersect_angular_intervals([(0.0, 2.0), (1.0, 3.0), (5.5, 2 * math.pi + 1.5)])
        far = c.circles_have_no_overlap([c.Circle(c.Point(0, 0), 1.0),
                                         c.Circle(c.Point(5, 0), 1.0)])
        return arcs, pair, ivs, far

    _same(tuple(map(repr, run(circles))), tuple(map(repr, run(ref_circles))))


def test_checkpoint_round_trip(tmp_path):
    """A result's iterate (tensors) saved and loaded back; the JAX package's
    loader reads the same file."""
    rng = np.random.default_rng(0)
    x, s, z = (torch.tensor(rng.standard_normal(n)) for n in (5, 7, 7))
    result = type("Result", (), dict(x=x, s=s, z=z, iterations=12, status=1, pobj=3.5,
                                     gap=1e-7))
    path = str(tmp_path / "sub" / "state.npz")
    checkpoint.save_solver_state(path, result)
    from score_tpu.utils.checkpoint import load_solver_state as ref_load

    for loaded in (checkpoint.load_solver_state(path), ref_load(path)):
        for a, b in zip(loaded, (x, s, z)):
            np.testing.assert_array_equal(a, b.numpy())


def test_telemetry(tmp_path, capsys):
    timer = telemetry.PhaseTimer()
    with timer.phase("solve"):
        pass
    with timer.phase("solve"):
        pass
    assert list(timer.phases) == ["solve"] and timer.summary().startswith("total=")
    telemetry.setup_logging(logging.INFO, color=False)
    try:
        logging.getLogger("score_tpu_torch.test").info("hello")
        assert "score_tpu_torch.test INFO - hello" in capsys.readouterr().err
    finally:
        telemetry.setup_logging(logging.WARNING, color=False)
    with telemetry.profiler_trace(str(tmp_path / "trace")) as log_dir:
        torch.ones(4).sum()
    assert any(p.name.endswith(".json") for p in (tmp_path / "trace").iterdir())
    assert log_dir == str(tmp_path / "trace")
