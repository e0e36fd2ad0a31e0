"""The port's host layers against the JAX package: the Manhattan simulator,
the factor-graph conversion, normalization and the conic assembly of both
relaxations (same inputs, built from a seed)."""

import dataclasses

import numpy as np
import pytest

from score_tpu.assembly.conic import build_conic_problem as ref_build
from score_tpu.assembly.normalize import normalize_factor_graph as ref_normalize
from score_tpu.fg.measurements import PoseMeasurement2D as RefPoseMeasurement2D
from score_tpu.fg.priors import LandmarkPrior2D as RefLandmarkPrior2D
from score_tpu.sim.manhattan import ManhattanWorldParams as RefParams
from score_tpu.sim.manhattan import simulate_manhattan_world as ref_simulate

from score_tpu_torch.assembly.conic import build_conic_problem
from score_tpu_torch.assembly.normalize import normalize_factor_graph
from score_tpu_torch.convert import factor_graph_from_reference, problem_from_reference
from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

SIM = dict(num_robots=2, num_poses_per_robot=20, num_landmarks=3, grid_size=8,
           range_measure_prob=0.4, inter_robot_sensing_radius=10.0,
           inter_robot_measure_prob=0.5, seed=3)
INT_FIELDS = ("cost_cols", "cone_cols", "pin_idx")
FLOAT_FIELDS = ("cost_coefs", "cost_b", "cost_w", "cone_coefs", "cone_h",
                "pin_val", "c0")


def _ref_graph():
    """A 2-robot world with a loop closure and a landmark prior added (the
    simulator emits neither), so every row family is exercised."""
    fg = ref_simulate(RefParams(**SIM))
    fg.loop_closure_measurements.append(
        RefPoseMeasurement2D("A2", "A15", 1.0, -2.0, 0.3, 100.0, 1000.0)
    )
    fg.landmark_priors.append(RefLandmarkPrior2D("L1", (3.0, 4.0), 10.0))
    return fg


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def test_simulator_matches_reference():
    ref = ref_simulate(RefParams(**SIM))
    port = simulate_manhattan_world(ManhattanWorldParams(**SIM))
    assert port.summary() == ref.summary()
    assert port.get_pose_chain_names() == ref.get_pose_chain_names()
    for a, b in zip(
        [p for c in port.pose_variables for p in c] + port.landmark_variables
        + [m for c in port.odom_measurements for m in c] + port.range_measurements,
        [p for c in ref.pose_variables for p in c] + ref.landmark_variables
        + [m for c in ref.odom_measurements for m in c] + ref.range_measurements,
    ):
        assert type(a).__name__ == type(b).__name__
        assert _fields(a) == _fields(b)


def test_convert_factor_graph_roundtrip():
    ref = _ref_graph()
    port = factor_graph_from_reference(ref)
    assert type(port).__module__.startswith("score_tpu_torch")
    assert port.summary() == ref.summary()
    assert port.unconnected_variable_names == ref.unconnected_variable_names
    for a, b in zip(port.loop_closure_measurements + port.landmark_priors
                    + port.range_measurements,
                    ref.loop_closure_measurements + ref.landmark_priors
                    + ref.range_measurements):
        assert type(a).__module__.startswith("score_tpu_torch")
        assert _fields(a) == _fields(b)


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_conic_problem_matches_reference(relaxation):
    ref_fg = _ref_graph()
    sref, scale_ref = ref_normalize(ref_fg)
    sport, scale = normalize_factor_graph(factor_graph_from_reference(ref_fg))
    assert scale == scale_ref
    rp, ridx = ref_build(sref, relaxation)
    pp, pidx = build_conic_problem(sport, relaxation, device="cpu")
    assert (pp.n, pp.k, pp.dim, pp.relaxation) == (rp.n, rp.k, rp.dim, rp.relaxation)
    assert dataclasses.asdict(pidx) == dataclasses.asdict(ridx)
    for name in INT_FIELDS:
        np.testing.assert_array_equal(getattr(pp, name).numpy(), np.asarray(getattr(rp, name)))
    for name in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(pp, name).numpy(), np.asarray(getattr(rp, name)),
                                   rtol=1e-14, atol=0)
    # the conversion path used by the solver parity tests carries the
    # reference problem across unchanged
    cp = problem_from_reference(rp, device="cpu")
    for name in INT_FIELDS + FLOAT_FIELDS:
        np.testing.assert_array_equal(getattr(cp, name).numpy(), np.asarray(getattr(rp, name)))
