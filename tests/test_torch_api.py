"""The whole slice: the port's solve_score on the CPU against the JAX
package's solve_score on the CPU, same factor graph (built by the JAX
package's simulator, carried across by score_tpu_torch.convert).

The two chain bands round differently: the reference's f64 backend runs
compacting cyclic reduction all the way down with a Cholesky per block,
the port runs a few compacting levels and then all-positions PCR, with
explicit block inverses (the configuration of the GPU kernels). The
interior-point trajectories therefore agree to roundoff-driven
tolerances: the same status, iterations within one, objective within 1e-9
relative, x within 1e-6 relative, rounded poses within 1e-5.

At this size (chains padded to 32) the port's default schedule runs PCR
only; ``test_solve_score_matches_reference`` lowers the compaction floor
so its band compacts two levels first, as the full-size instances do.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from score_tpu import solve_score as ref_solve_score
from score_tpu.api import variable_values_from_x as ref_values_from_x
from score_tpu.assembly.conic import build_conic_problem as ref_build
from score_tpu.assembly.normalize import normalize_factor_graph as ref_normalize
from score_tpu.solver.chain_arrow import ChainArrowBackend as RefBackend
from score_tpu.solver.chain_arrow import build_chain_arrow as ref_build_ca
from score_tpu.solver.ipm import solve_conic as ref_solve_conic
from score_tpu.solver.params import ScoreSolverParams as RefParams
from score_tpu.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

from score_tpu_torch import ScoreSolverParams, solve_score
from score_tpu_torch.api import _select_backend, variable_values_from_x
from score_tpu_torch.convert import factor_graph_from_reference, problem_from_reference
from score_tpu_torch.ops import band
from score_tpu_torch.solver.chain_arrow import build_chain_arrow
from score_tpu_torch.solver.ipm import solve_conic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ref_graph():
    return simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1,
    ))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_solve_score_matches_reference(ref_graph, relaxation, monkeypatch):
    monkeypatch.setattr(band, "CR_BASE_LENGTH", 8)  # 32 -> 16 -> 8, then PCR
    ref = ref_solve_score(ref_graph, relaxation, RefParams(precision="f64"))
    port = solve_score(factor_graph_from_reference(ref_graph), relaxation,
                       ScoreSolverParams(device="cpu"))
    assert port.solved and ref.solved
    assert abs(port.iterations - ref.iterations) <= 1
    assert abs(port.primal_objective - ref.primal_objective) <= 1e-9 * abs(ref.primal_objective)
    assert port.gap / abs(port.primal_objective) <= 1e-6
    assert port.pose_chain_names == ref.pose_chain_names
    for name, T in ref.poses.items():
        np.testing.assert_allclose(port.poses[name], T, atol=1e-5, rtol=0)
        assert abs(np.linalg.det(port.poses[name][:2, :2]) - 1.0) < 1e-12
    for name, p in ref.landmarks.items():
        np.testing.assert_allclose(port.landmarks[name], p, atol=1e-5, rtol=0)
    assert set(port.distances) == set(ref.distances)


def test_solve_conic_iterate_matches_reference(ref_graph):
    """The raw solution vector of the conic solve (before rounding)."""
    rp, ridx = ref_build(ref_normalize(ref_graph)[0], "SOCP")
    ref = ref_solve_conic(rp, RefParams().ipm_params(), backend=RefBackend,
                          backend_aux=ref_build_ca(rp, ridx))
    pp = problem_from_reference(rp)
    port = solve_conic(pp, ScoreSolverParams().ipm_params(),
                       backend_aux=build_chain_arrow(pp, ridx))
    assert port.status == int(ref.status)
    assert abs(port.iterations - int(ref.iterations)) <= 1
    assert abs(port.pobj - float(ref.pobj)) <= 1e-9 * abs(float(ref.pobj))
    assert _rel(port.x.numpy(), np.asarray(ref.x)) <= 1e-6
    # rounding and named extraction of the same flat vector
    ref_vals = ref_values_from_x(np.asarray(port.x.numpy()), ridx)
    vals = variable_values_from_x(port.x, ridx)
    for name, T in ref_vals.poses.items():
        np.testing.assert_allclose(vals.poses[name], T, atol=1e-12, rtol=0)
    for key, v in ref_vals.distances.items():
        np.testing.assert_array_equal(vals.distances[key], v)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import score_tpu_torch, score_tpu_torch.api, score_tpu_torch.convert\n"
        "import score_tpu_torch.ops.band, score_tpu_torch.ops.build\n"
        "import score_tpu_torch.sim.manhattan\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'score_tpu' or m.startswith('score_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unported_options_raise(ref_graph):
    fg = factor_graph_from_reference(ref_graph)
    with pytest.raises(NotImplementedError):
        solve_score(fg, "SOCP", ScoreSolverParams(precision="f32"))
    with pytest.raises(ValueError):
        solve_score(fg, "SOCP", ScoreSolverParams(precision="f16"))
    # a pose-free graph needs the dense backend
    with pytest.raises(NotImplementedError):
        _select_backend(None, SimpleNamespace(num_poses=0))


def test_cuda_device_without_a_card_raises(ref_graph):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_score(factor_graph_from_reference(ref_graph), "SOCP",
                    ScoreSolverParams(device="cuda"))
