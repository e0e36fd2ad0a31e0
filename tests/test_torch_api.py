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

The f32 fast mode (``precision="f32"``) is sensitive to rounding: turning
on only the JAX package's Pallas block kernels moves its own f32
objective by up to 5 % on a 2 x 25 world. Its checks are therefore one KKT
factor and solve at 1e-3, and the whole solve on a 4 x 50 world at the
spread measured there (2e-2 on the objective, 3 iterations).
"""

import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from score_tpu import solve_score as ref_solve_score
from score_tpu.api import _cast_problem as ref_cast
from score_tpu.api import variable_values_from_x as ref_values_from_x
from score_tpu.assembly.conic import build_conic_problem as ref_build
from score_tpu.assembly.normalize import normalize_factor_graph as ref_normalize
from score_tpu.fg.factor_graph import FactorGraphData as RefFactorGraphData
from score_tpu.fg.measurements import FGRangeMeasurement as RefFGRangeMeasurement
from score_tpu.fg.variables import LandmarkVariable2D as RefLandmarkVariable2D
from score_tpu.solver.chain_arrow import ChainArrowBackend as RefBackend
from score_tpu.solver.chain_arrow import build_chain_arrow as ref_build_ca
from score_tpu.solver.ipm import solve_conic as ref_solve_conic
from score_tpu.solver.params import ScoreSolverParams as RefParams
from score_tpu.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world
from tests import torch_reference_data

from score_tpu_torch import ScoreSolverParams, solve_score
from score_tpu_torch.api import _select_backend, variable_values_from_x
from score_tpu_torch.assembly.conic import build_conic_problem
from score_tpu_torch.convert import factor_graph_from_reference, problem_from_reference
from score_tpu_torch.ops import band
from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
from score_tpu_torch.solver.ipm import IPMParams, solve_conic
from score_tpu_torch.solver.pcr import PCRFactors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ref_graph():
    return simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1,
    ))


@pytest.fixture(scope="module")
def graph_4x50():
    """The f32 checks' world: 4 robots x 50 poses, 4 landmarks."""
    return torch_reference_data.graph_4x50()


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _max_rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


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
    pp = problem_from_reference(rp, device="cpu")
    port = solve_conic(pp, ScoreSolverParams().ipm_params(),
                       backend_aux=build_chain_arrow(pp, ridx))
    assert port.status == int(ref.status)
    assert abs(port.iterations - int(ref.iterations)) <= 1
    assert abs(port.pobj - float(ref.pobj)) <= 1e-9 * abs(float(ref.pobj))
    assert _rel(port.x.numpy(), np.asarray(ref.x)) <= 1e-6
    # rounding and named extraction of the same flat vector
    ref_vals = ref_values_from_x(np.asarray(port.x.numpy()), ridx)
    vals = variable_values_from_x(port.x, ridx, device="cpu")
    for name, T in ref_vals.poses.items():
        np.testing.assert_allclose(vals.poses[name], T, atol=1e-12, rtol=0)
    for key, v in ref_vals.distances.items():
        np.testing.assert_array_equal(vals.distances[key], v)


def test_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import score_tpu_torch, score_tpu_torch.api, score_tpu_torch.convert\n"
        "import score_tpu_torch.ops.band, score_tpu_torch.ops.blocks, score_tpu_torch.ops.build\n"
        "import score_tpu_torch.solver.pcr, score_tpu_torch.solver.backend\n"
        "import score_tpu_torch.fg.io, score_tpu_torch.datasets\n"
        "import score_tpu_torch.assembly.initialization\n"
        "import score_tpu_torch.sim.manhattan, score_tpu_torch.sim.world3d\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'score_tpu' or m.startswith('score_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_unported_options_raise(ref_graph):
    fg = factor_graph_from_reference(ref_graph)
    with pytest.raises(ValueError):
        solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", precision="f16"))
    # the JAX package's backend selection for a pose-free index: "auto" and
    # "dense" take the dense backend, "chain_arrow" raises
    pose_free = SimpleNamespace(num_poses=0)
    for backend in ("auto", "dense"):
        assert _select_backend(None, None, pose_free, ScoreSolverParams(
            device="cpu", backend=backend)) == (DenseBackend, None)
    with pytest.raises(ValueError, match="pose chain"):
        _select_backend(None, None, pose_free, ScoreSolverParams(device="cpu",
                                                                 backend="chain_arrow"))
    # ... but both packages refuse a pose-free graph at assembly, at the
    # gauge pin, before any backend is selected
    ref_pose_free = RefFactorGraphData(dimension=2)
    for name, xy in (("L0", (0.0, 0.0)), ("L1", (3.0, 4.0))):
        ref_pose_free.add_landmark_variable(RefLandmarkVariable2D(name, xy))
    ref_pose_free.add_range_measurement(RefFGRangeMeasurement(("L0", "L1"), 5.0, 0.1))
    with pytest.raises(StopIteration):
        ref_build(ref_pose_free, "SOCP")
    with pytest.raises(StopIteration):
        build_conic_problem(factor_graph_from_reference(ref_pose_free), "SOCP", device="cpu")
    # f32 is ported: the JAX package's f32 interior-point controls
    assert ScoreSolverParams(precision="f32").ipm_params() == IPMParams(
        **{f: getattr(RefParams(precision="f32").ipm_params(), f)
           for f in IPMParams.__dataclass_fields__})


@pytest.mark.parametrize("params", [ScoreSolverParams(device="cuda"), ScoreSolverParams()],
                         ids=["cuda", "default"])
def test_cuda_device_without_a_card_raises(ref_graph, params):
    """The card is the default device; without one the solve raises and
    nothing falls back to the CPU."""
    assert ScoreSolverParams().device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the no-card path")
    with pytest.raises(RuntimeError, match="cuda"):
        solve_score(factor_graph_from_reference(ref_graph), "SOCP", params)


def test_problem_from_reference_keeps_float32(graph_4x50):
    rp, _ = ref_build(ref_normalize(graph_4x50)[0], "QCQP")
    rp32 = ref_cast(rp, jnp.float32)
    pp32 = problem_from_reference(rp32, device="cpu")
    pp = problem_from_reference(rp, device="cpu")
    assert pp.dtype == torch.float64 and pp32.dtype == torch.float32
    cast = pp.cast(torch.float32)
    for name in ("cost_coefs", "cost_b", "cost_w", "cone_coefs", "cone_h", "pin_val", "c0"):
        assert getattr(pp32, name).dtype == torch.float32
        assert torch.equal(getattr(pp32, name), getattr(cast, name)), name
    assert torch.equal(pp32.cost_cols, pp.cost_cols)


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_f32_kkt_solve_matches_reference(graph_4x50, relaxation):
    """One f32 factor and solve of the reduced KKT system at the initial
    point's scaling (W = I), each package on its own f32 cast of the same
    problem.

    The factors are the tight check: the arrow panel Z = T^{-1}B (the
    port's cyclic reduction against the JAX package's) and the arrow
    Cholesky LS agree to 1e-3 relative (measured 5e-4 / 3e-4 SOCP, 7e-4 /
    7e-5 QCQP), and QCQP's f32 pivot inverses and eliminated blocks to
    1e-6 (measured 2e-10 / 4e-8). The direction is not: this system is
    ill-conditioned enough in f32 that both packages' f32 directions lie
    1-2 % from an f64 solve of the same f32 system, and 0.5-0.8 % from each
    other. So the direction must lie within 2e-2 of the JAX one, and no
    farther than twice the JAX direction's distance from the f64 solve."""
    rp, ridx = ref_build(ref_normalize(graph_4x50)[0], relaxation)
    rp32 = ref_cast(rp, jnp.float32)
    ref_params = RefParams(precision="f32").ipm_params()
    N, k = rp.num_cones, rp.k
    rhs = np.random.default_rng(4).standard_normal(rp.n).astype(np.float32)
    ref_st = RefBackend.prepare(rp32, ref_build_ca(rp32, ridx))

    @jax.jit  # the JAX package's factor and solve, compiled whole
    def reference(rhs):
        eye = jnp.broadcast_to(jnp.eye(k, dtype=jnp.float32), (N, k, k))
        f = RefBackend.factor(rp32, ref_st, eye, ref_params)
        dx = RefBackend.solve(rp32, ref_st, f, ref_st.mask * rhs, ref_params)
        return f.Z, f.LS, f.Hhat, f.kdd, dx

    ref_Z, ref_LS, ref_Hhat, ref_kdd, ref_dx = reference(jnp.asarray(rhs))

    params = ScoreSolverParams(device="cpu", precision="f32").ipm_params()
    dxs = {}
    for dtype in (torch.float32, torch.float64):
        # the f64 solve runs on the f32-rounded data
        pp = problem_from_reference(rp, device="cpu").cast(torch.float32).cast(dtype)
        st = ChainArrowBackend.prepare(pp, build_chain_arrow(pp, ridx))
        f = ChainArrowBackend.factor(pp, st, torch.eye(k, dtype=dtype).expand(N, k, k), params)
        dxs[dtype] = ChainArrowBackend.solve(pp, st, f, st.mask * torch.tensor(rhs, dtype=dtype),
                                             params).numpy()
        if dtype == torch.float32:
            assert isinstance(f.band, PCRFactors) and f.LS.dtype == torch.float32
            assert _max_rel(f.Z.numpy(), ref_Z) <= 1e-3
            assert _max_rel(f.LS.numpy(), ref_LS) <= 1e-3
            assert _max_rel(f.Hhat.numpy(), ref_Hhat) <= 1e-6
            assert _max_rel(f.kdd.numpy(), ref_kdd) <= 1e-6
    dx, dx64 = dxs[torch.float32], dxs[torch.float64]
    assert dx.dtype == np.float32
    assert _rel(dx, np.asarray(ref_dx)) <= 2e-2
    assert _rel(dx, dx64) <= 2 * _rel(np.asarray(ref_dx), dx64)


def test_f32_solve_matches_reference(graph_4x50):
    """The whole f32 SOCP solve on the CPU against the JAX package's. On
    this world the port gives 13 iterations and objective 28.2676 (relgap
    2.8e-4); the JAX package 14 iterations and 27.9707 in f32, 28.2864 in
    f64: the two f32 objectives are 1.1 % apart, the port's is 0.07 % from
    f64 (its edge-block products accumulate in f64, see
    ``ChainArrowBackend.P_matvec``). Pass: both solved, iterations within
    3, objectives within 2e-2 of each other and of the JAX f64 objective.
    The f32 reference solves live; the f64 objective is read from
    ``tests/data/torch_reference.npz`` (``tests/torch_reference_data.py``)."""
    ref = ref_solve_score(graph_4x50, "SOCP", RefParams(precision="f32"))
    ref64_objective = float(torch_reference_data.load()["f32_4x50_socp_f64_objective"])
    port = solve_score(factor_graph_from_reference(graph_4x50), "SOCP",
                       ScoreSolverParams(device="cpu", precision="f32"))
    assert port.solved and ref.solved
    assert abs(port.iterations - ref.iterations) <= 3
    assert abs(port.primal_objective - ref.primal_objective) <= 2e-2 * abs(ref.primal_objective)
    assert abs(port.primal_objective - ref64_objective) <= 2e-2 * abs(ref64_objective)
    for name, T in port.poses.items():
        assert T.dtype == np.float64
        assert abs(np.linalg.det(T[:2, :2]) - 1.0) < 1e-5
