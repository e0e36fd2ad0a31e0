"""The 3D (SE(3)) slice on the CPU against the JAX package: the 3D
simulator, the conic assembly of both relaxations, and whole solves on a
2 x 30 world (12 x 12 band blocks, 3 x 3 QCQP distance pivots).

Objectives of 3D worlds from this simulator sit at ~1e-10: its graphs have
no loop closures, so the relaxation fits every range (so did every denser
world tried: 2 x 30 with 480 ranges, 2 x 40 with 368), and the optimum is
flat enough that rounded rotations of two solvers differ by ~3e-5 there.
The whole-solve checks therefore run on the same world with one loop
closure added (A3 -> A25, off by a few metres), whose objective is ~5e3 and
whose optimum is sharp: objective to 1e-9 relative, rounded poses to 1e-5.
The plain world holds the QCQP fault below, with its objective held to the
reference's final gap in absolute terms.

The module runs the JAX package's ``solve_conic`` live once per
relaxation (the fault test's QCQP on the plain world, SOCP on the loop
world), shared through a module fixture, and reads the loop world's QCQP
reference from ``tests/data/torch_reference.npz``, which
``tests/torch_reference_data.py`` writes with the JAX package.

The f32 mode (``precision="f32"``) is held to the JAX package's f32
solves of the loop world and the plain world, read from the npz.

``test_qcqp_3d_matches_reference`` holds the fault that 3D QCQP had: with
all-positions PCR over the whole 32-block chains, the band's explicit
inverses of fully reduced 12 x 12 blocks left the dual residual 20-100x
the reference's, so the solve ended OPTIMAL_INACCURATE after 12 iterations
where the reference is OPTIMAL after 5. A 3D band solve now takes one step
of iterative refinement (``band.REFINE_STEPS_3D``). The band now compacts
to one block by default, and then needs no refinement step on this world
(``test_qcqp_3d_needs_no_refinement_at_the_default_schedule``); the step
stays, and ``test_qcqp_3d_without_refinement_stalls`` holds the fault at a
parallel cyclic reduction remainder.
"""

import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

from score_tpu.api import variable_values_from_x as ref_values_from_x
from score_tpu.assembly.conic import build_conic_problem as ref_build
from score_tpu.assembly.normalize import normalize_factor_graph as ref_normalize
from score_tpu.solver.chain_arrow import ChainArrowBackend as RefBackend
from score_tpu.solver.chain_arrow import build_chain_arrow as ref_build_ca
from score_tpu.solver.ipm import solve_conic as ref_solve_conic
from score_tpu.solver.params import ScoreSolverParams as RefParams
from tests import torch_reference_data
from tests.torch_reference_data import WORLD_3D as WORLD

from score_tpu_torch import ScoreSolverParams, solve_score
from score_tpu_torch.assembly.conic import build_conic_problem
from score_tpu_torch.assembly.normalize import normalize_factor_graph
from score_tpu_torch.convert import factor_graph_from_reference, problem_from_reference
from score_tpu_torch.ops import band
from score_tpu_torch.sim.world3d import World3DParams, simulate_3d_world
from score_tpu_torch.solver.chain_arrow import build_chain_arrow
from score_tpu_torch.solver.ipm import OPTIMAL, OPTIMAL_INACCURATE, solve_conic

torch.set_num_threads(1)

FIELDS = ("cost_cols", "cost_coefs", "cost_b", "cost_w", "cone_cols", "cone_coefs",
          "cone_h", "pin_idx", "pin_val", "c0")


@pytest.fixture(scope="module")
def ref_graph():
    return torch_reference_data.world_3d()


@pytest.fixture(scope="module")
def loop_graph():
    """The same world with a loop closure A3 -> A25 that its odometry does
    not agree with: a sharp optimum, objective ~5e3."""
    return torch_reference_data.world_3d(loop=True)


class _Stored(NamedTuple):
    """A reference IPM result read from the committed npz."""
    status: int
    iterations: int
    pobj: float
    gap: float
    x: np.ndarray


@pytest.fixture(scope="module")
def reference():
    """reference(graph, relaxation) -> (problem, index, IPM result): the
    JAX package's normalized problem and its f64 ``solve_conic``, run once
    (the loop world's QCQP read from the npz)."""
    done = {}

    def get(graph, relaxation):
        key = (id(graph), relaxation)
        if key not in done:
            rp, ridx = ref_build(ref_normalize(graph)[0], relaxation)
            if graph.loop_closure_measurements and relaxation == "QCQP":
                data = torch_reference_data.load()
                res = _Stored(*(data[f"loop3d_qcqp_{f}"] for f in _Stored._fields))
                assert res.x.shape == (rp.n,)
            else:
                res = ref_solve_conic(rp, RefParams(precision="f64").ipm_params(),
                                      backend=RefBackend, backend_aux=ref_build_ca(rp, ridx))
            done[key] = rp, ridx, res
        return done[key]

    return get


def _same(a, b):
    """Field-by-field equality of two records (arrays compared exactly)."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


def test_world3d_matches_reference(ref_graph):
    port = simulate_3d_world(World3DParams(**WORLD))
    ref = ref_graph
    assert port.dimension == ref.dimension == 3
    assert port.summary() == ref.summary()
    assert port.get_pose_chain_names() == ref.get_pose_chain_names()
    records = lambda g: ([p for c in g.pose_variables for p in c] + g.landmark_variables
                         + [m for c in g.odom_measurements for m in c] + g.range_measurements)
    assert len(records(port)) == len(records(ref))
    for a, b in zip(records(port), records(ref)):
        _same(a, b)


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_conic_problem_matches_reference(ref_graph, relaxation):
    rp, ridx = ref_build(ref_normalize(ref_graph)[0], relaxation)
    scaled, _ = normalize_factor_graph(simulate_3d_world(World3DParams(**WORLD)))
    pp, idx = build_conic_problem(scaled, relaxation, device="cpu")
    assert (pp.n, pp.k, pp.dim, pp.relaxation) == (rp.n, rp.k, rp.dim, rp.relaxation)
    for name in FIELDS:
        a = getattr(pp, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        np.testing.assert_array_equal(a, np.asarray(getattr(rp, name)), err_msg=name)
    assert idx.pose_names == ridx.pose_names
    assert idx.landmark_names == ridx.landmark_names
    assert idx.dist_keys == ridx.dist_keys


def _objective_ok(port_obj, ref):
    """The objective within 1e-9 relative or, near 0, within the
    reference's final gap."""
    ref_obj, gap = float(ref.pobj), float(ref.gap)
    tol = 1e-9 * abs(ref_obj) if abs(ref_obj) >= 1e-3 else gap
    return abs(port_obj - ref_obj) <= tol


def test_qcqp_3d_matches_reference(ref_graph, reference):
    rp, ridx, ref = reference(ref_graph, "QCQP")
    assert int(ref.status) == OPTIMAL
    pp = problem_from_reference(rp, device="cpu")
    port = solve_conic(pp, ScoreSolverParams().ipm_params(),
                       backend_aux=build_chain_arrow(pp, ridx))
    assert port.status == OPTIMAL, (port.status, port.iterations, float(port.dres))
    assert abs(port.iterations - int(ref.iterations)) <= 1
    assert _objective_ok(float(port.pobj), ref)


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_solve_score_3d_matches_reference(loop_graph, reference, relaxation):
    """solve_score on the loop world: solved, iterations within 1 of the
    reference, objective within 1e-9 relative, rounded poses and landmarks
    within 1e-5 (translations in the caller's units: 1e-5 times the
    normalization scale), det(R) = +1."""
    rp, ridx, ref = reference(loop_graph, relaxation)
    assert int(ref.status) == OPTIMAL and abs(float(ref.pobj)) > 1.0
    _, scale = ref_normalize(loop_graph)
    port = solve_score(factor_graph_from_reference(loop_graph), relaxation,
                       ScoreSolverParams(device="cpu"))
    assert port.solved
    assert abs(port.iterations - int(ref.iterations)) <= 1
    assert _objective_ok(port.primal_objective, ref)
    ref_vals = ref_values_from_x(np.asarray(ref.x), ridx)  # normalized units
    assert port.pose_chain_names == loop_graph.get_pose_chain_names()
    for name, T in ref_vals.poses.items():
        P = port.poses[name]
        assert P.shape == (4, 4)
        np.testing.assert_allclose(P[:3, :3], T[:3, :3], atol=1e-5, rtol=0)
        np.testing.assert_allclose(P[:3, 3], scale * T[:3, 3], atol=1e-5 * scale, rtol=0)
        assert abs(np.linalg.det(P[:3, :3]) - 1.0) < 1e-12
    for name, p in ref_vals.landmarks.items():
        np.testing.assert_allclose(port.landmarks[name], scale * p, atol=1e-5 * scale, rtol=0)


def test_qcqp_3d_without_refinement_stalls(ref_graph, monkeypatch):
    """The fault test's world still shows the fault where the band runs a
    parallel cyclic reduction remainder (the chains of 32 padded poses
    whole, the schedule before the band compacted to one block): without
    the 3D band's refinement step the port's QCQP ends
    OPTIMAL_INACCURATE, many iterations past the reference's 5 (dual
    residual above 1e-8)."""
    monkeypatch.setattr(band, "REFINE_STEPS_3D", 0)
    monkeypatch.setattr(band, "CR_BASE_LENGTH", 256)
    rp, ridx = ref_build(ref_normalize(ref_graph)[0], "QCQP")
    pp = problem_from_reference(rp, device="cpu")
    port = solve_conic(pp, ScoreSolverParams().ipm_params(),
                       backend_aux=build_chain_arrow(pp, ridx))
    assert port.status != OPTIMAL and port.iterations >= 8


def test_qcqp_3d_needs_no_refinement_at_the_default_schedule(ref_graph, reference,
                                                           monkeypatch):
    """Compacted to one block, the 3D band holds the fault test's QCQP to
    the reference without its refinement step: OPTIMAL, iterations within
    1, objective within 1e-9 relative (the step stays on: it is part of
    the 3D path's digits, PERF.md)."""
    monkeypatch.setattr(band, "REFINE_STEPS_3D", 0)
    rp, ridx, ref = reference(ref_graph, "QCQP")
    pp = problem_from_reference(rp, device="cpu")
    port = solve_conic(pp, ScoreSolverParams().ipm_params(),
                       backend_aux=build_chain_arrow(pp, ridx))
    assert port.status == OPTIMAL, (port.status, port.iterations, float(port.dres))
    assert abs(port.iterations - int(ref.iterations)) <= 1
    assert _objective_ok(float(port.pobj), ref)


def _f32_reference(key):
    """The JAX package's f32 ``solve_score`` of a 3D world, from the npz:
    (solved, iterations, objective, gap)."""
    data = torch_reference_data.load()
    return tuple(data[f"{key}_{f}"].item() for f in ("solved", "iterations", "pobj", "gap"))


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_solve_score_3d_f32_matches_reference(loop_graph, relaxation):
    """precision="f32" on the loop world, on the CPU (the plain versions of
    the f32 block kernels at D = 12 and, for QCQP, D = 3) against the JAX
    package's f32 solve of the same graph: the same solved status,
    iterations within 3, objectives within 2e-2 relative (the 2D f32
    checks' limits; measured: 2 against 2 and 11 against 13 iterations,
    objectives 2.5e-5 and 2.6e-6 apart)."""
    solved, iterations, pobj, _ = _f32_reference(f"loop3d_f32_{relaxation.lower()}")
    port = solve_score(factor_graph_from_reference(loop_graph), relaxation,
                       ScoreSolverParams(device="cpu", precision="f32"))
    assert port.solved == solved is True
    assert abs(port.iterations - iterations) <= 3
    assert abs(port.primal_objective - pobj) <= 2e-2 * abs(pobj)
    for P in port.poses.values():
        assert abs(np.linalg.det(P[:3, :3]) - 1.0) < 1e-5


def test_solve_score_3d_f32_socp_plain_world(ref_graph):
    """precision="f32" SOCP on the plain 3D world: solved in both packages,
    iterations within 3 of the JAX package's, relative gap <= 1e-2 (the
    mode's reduced tolerance). Its objective sits at ~1e-10 in f64 and is
    off by 0.1-0.3 in f32 in both packages, so it is not compared."""
    solved, iterations, _, _ = _f32_reference("plain3d_f32_socp")
    port = solve_score(factor_graph_from_reference(ref_graph), "SOCP",
                       ScoreSolverParams(device="cpu", precision="f32"))
    assert port.solved and solved
    assert abs(port.iterations - iterations) <= 3
    assert port.gap / max(1.0, abs(port.primal_objective)) <= 1e-2


def test_stalled_qcqp_3d_matches_what_the_reference_shares():
    """The 4 x 100 world's 3D QCQP in f64, where both packages stop on a
    dual-residual floor (~2.2-2.4e-8) by the stall detector. Its iteration
    count is roundoff: 13-29 in the JAX package under 1e-12 perturbations
    of its initial point, 15-32 in the port with the torch thread count
    and 13-20 under the same perturbations (ROADMAP, known departures).
    What both share is held: OPTIMAL_INACCURATE as the reference (read
    from the npz), the dual residual under the reduced tolerance and
    within 1.5x the reference's floor, and the objective within 2e-8 of
    the reference's: twice the spread of the reference's own objectives
    under those perturbations (1.07e-8; its final gap, 2.8e-12, is far
    below what the residual floor fixes)."""
    data = torch_reference_data.load()
    ref = {f: data[f"qcqp3d_4x100_{f}"].item()
           for f in ("status", "iterations", "pobj", "gap", "dres")}
    params = ScoreSolverParams(device="cpu").ipm_params()
    scaled, _ = normalize_factor_graph(simulate_3d_world(World3DParams(
        **torch_reference_data.WORLD_3D_4X100)))
    pp, idx = build_conic_problem(scaled, "QCQP", device="cpu")
    port = solve_conic(pp, params, backend_aux=build_chain_arrow(pp, idx))
    assert ref["status"] == port.status == OPTIMAL_INACCURATE
    assert port.dres < params.tol_feas_reduced
    assert port.dres <= 1.5 * ref["dres"]
    assert abs(port.pobj - ref["pobj"]) <= 2e-8
