"""The port's cone algebra, small-block routines, operators and one
chain+arrow KKT factor/solve against the JAX package (f64 on the CPU,
same inputs made from a seed with numpy).

Tolerance 1e-13 relative (to the largest entry of the reference) for the
elementwise cone algebra: the same f64 formulas, summed in another order.

The reference's KKT factor and solve run as one ``jax.jit`` of the JAX
package's own functions: op by op, JAX's dispatch of each small operation
cost several times the compiled run.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from score_tpu.assembly.conic import build_conic_problem as ref_build
from score_tpu.solver import cones as rc
from score_tpu.solver import smallblocks as rsb
from score_tpu.solver.chain_arrow import ChainArrowBackend as RefBackend
from score_tpu.solver.chain_arrow import build_chain_arrow as ref_build_ca
from score_tpu.solver.ipm import IPMParams as RefIPMParams
from score_tpu.solver.linops import G_apply as ref_G, GT_apply as ref_GT
from score_tpu.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

from score_tpu_torch.convert import problem_from_reference
from score_tpu_torch.solver import cones as pc
from score_tpu_torch.solver import smallblocks as psb
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
from score_tpu_torch.solver.ipm import IPMParams
from score_tpu_torch.solver.linops import G_apply, GT_apply

torch.set_num_threads(1)

TOL = 1e-13


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _interior(rng, N, k, margin):
    u = rng.standard_normal((N, k))
    u[:, 0] = np.linalg.norm(u[:, 1:], axis=1) + margin
    return u


@pytest.fixture(scope="module")
def cone_data():
    rng = np.random.default_rng(0)
    N, k = 64, 3
    # margins from well inside to a hair off the boundary: the compensated
    # residuals must agree in the cancellation regime too
    margin = np.logspace(0, -7, N)
    s = _interior(rng, N, k, margin)
    z = _interior(rng, N, k, margin[::-1])
    du = rng.standard_normal((N, k))
    return s, z, du


def _both(fn_ref, fn_port, *arrays):
    ref = fn_ref(*(jnp.asarray(a) for a in arrays))
    port = fn_port(*(torch.tensor(a) for a in arrays))
    return ref, port


@pytest.mark.parametrize("name", [
    "soc_residual", "min_eig", "jordan_mul", "jordan_solve", "inner",
    "apply_W", "apply_Winv", "apply_Winv2", "winv2_matrices", "nt_scaling",
    "max_step", "shift_to_interior",
])
def test_cone_ops_match_reference(cone_data, name):
    s, z, du = cone_data
    if name in ("soc_residual", "min_eig"):
        ref, port = _both(getattr(rc, name), getattr(pc, name), s)
    elif name in ("jordan_mul", "jordan_solve", "inner"):
        ref, port = _both(getattr(rc, name), getattr(pc, name), s, z)
    elif name == "max_step":
        ref, port = _both(rc.max_step, pc.max_step, s, du)
    elif name == "shift_to_interior":
        ref, port = _both(rc.shift_to_interior, pc.shift_to_interior, du)
    else:
        ntr = rc.nt_scaling(jnp.asarray(s), jnp.asarray(z))
        ntp = pc.nt_scaling(torch.tensor(s), torch.tensor(z))
        if name == "nt_scaling":
            assert _rel(ntp.eta, ntr.eta) <= TOL and _rel(ntp.wbar, ntr.wbar) <= TOL
            return
        if name == "winv2_matrices":
            ref, port = rc.winv2_matrices(ntr), pc.winv2_matrices(ntp)
        else:
            ref = getattr(rc, name)(ntr, jnp.asarray(du))
            port = getattr(pc, name)(ntp, torch.tensor(du))
    assert _rel(port, ref) <= TOL


def test_small_blocks_match_reference():
    rng = np.random.default_rng(1)
    M = rng.standard_normal((10, 6, 6))
    A = M @ np.swapaxes(M, -1, -2) + 6 * np.eye(6)
    B = rng.standard_normal((10, 6, 4))
    L_ref = rsb.chol_small(jnp.asarray(A))
    L = psb.chol_small(torch.tensor(A))
    assert _rel(L, L_ref) <= TOL
    assert _rel(psb.tri_lower_solve(L, torch.tensor(B)),
                rsb.tri_lower_solve(L_ref, jnp.asarray(B))) <= 1e-12
    assert _rel(psb.tri_upper_solve(L, torch.tensor(B)),
                rsb.tri_upper_solve(L_ref, jnp.asarray(B))) <= 1e-12
    assert _rel(psb.inv_small_spd(torch.tensor(A)),
                rsb.inv_small_spd(jnp.asarray(A))) <= 1e-12


@pytest.fixture(scope="module", params=["SOCP", "QCQP"])
def small_problem(request):
    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=10, num_landmarks=2, grid_size=5,
        range_measure_prob=0.5, inter_robot_sensing_radius=8.0,
        inter_robot_measure_prob=0.5, seed=7,
    ))
    rp, ridx = ref_build(fg, request.param)
    return rp, ridx, problem_from_reference(rp, device="cpu")


def test_operators_match_reference(small_problem):
    rp, _, pp = small_problem
    rng = np.random.default_rng(2)
    x = rng.standard_normal(rp.n)
    z = rng.standard_normal((rp.num_cones, rp.k))
    assert _rel(G_apply(pp, torch.tensor(x)), ref_G(rp, jnp.asarray(x))) <= TOL
    assert _rel(GT_apply(pp, torch.tensor(z)), ref_GT(rp, jnp.asarray(z))) <= TOL


def test_chain_arrow_kkt_solve_matches_reference(small_problem):
    """One W-dependent factorization and solve of the reduced KKT system:
    the port's band (explicit block inverses) against the reference's
    compacting cyclic reduction (Cholesky per block) round differently,
    hence 1e-9 on the direction."""
    rp, ridx, pp = small_problem
    rng = np.random.default_rng(3)
    s = _interior(rng, rp.num_cones, rp.k, 0.5)
    z = _interior(rng, rp.num_cones, rp.k, 0.5)
    rhs = rng.standard_normal(rp.n)

    x = rng.standard_normal(rp.n)
    ref_st = RefBackend.prepare(rp, ref_build_ca(rp, ridx))

    @jax.jit
    def reference(s, z, rhs, x):
        W_ref = rc.winv2_matrices(rc.nt_scaling(s, z))
        ref_f = RefBackend.factor(rp, ref_st, W_ref, RefIPMParams())
        dx = RefBackend.solve(rp, ref_st, ref_f, ref_st.mask * rhs, RefIPMParams())
        return ref_st.q, dx, RefBackend.P_matvec(ref_st, x)

    ref_q, ref_dx, ref_Px = reference(*(jnp.asarray(a) for a in (s, z, rhs, x)))

    st = ChainArrowBackend.prepare(pp, build_chain_arrow(pp, ridx))
    assert _rel(st.q, ref_q) <= TOL
    W = pc.winv2_matrices(pc.nt_scaling(torch.tensor(s), torch.tensor(z)))
    f = ChainArrowBackend.factor(pp, st, W, IPMParams())
    dx = ChainArrowBackend.solve(pp, st, f, st.mask * torch.tensor(rhs), IPMParams())
    assert _rel(dx, ref_dx) <= 1e-9
    assert _rel(ChainArrowBackend.P_matvec(st, torch.tensor(x)), ref_Px) <= 1e-12


def test_loop_closure_blocks_match_reference():
    """A 2D world with two loop closures: the chain+arrow backend's
    prepared blocks (where a loop closure's D x D blocks are scattered onto
    a chain slot) and P x against the reference, 1e-12. The port's scatter
    once broadcast a slot index against a whole block, adding each loop
    block D^2 times (D0 off by ~1e5 and P x by ~2.5e4 on such a world)."""
    from score_tpu.fg.measurements import PoseMeasurement2D

    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1,
    ))
    fg.loop_closure_measurements += [
        PoseMeasurement2D("A2", "A15", 1.0, -2.0, 0.3, 100.0, 1000.0),
        PoseMeasurement2D("B4", "B20", -0.5, 1.5, -0.2, 50.0, 500.0),
    ]
    rp, ridx = ref_build(fg, "SOCP")
    pp = problem_from_reference(rp, device="cpu")
    ref_st = RefBackend.prepare(rp, ref_build_ca(rp, ridx))
    st = ChainArrowBackend.prepare(pp, build_chain_arrow(pp, ridx))
    assert st.structure.NLC == 2
    for name in ("D0", "U0", "B0", "S0", "loop_ii", "loop_ij", "loop_jj"):
        assert _rel(getattr(st, name), getattr(ref_st, name)) <= 1e-12, name
    x = np.random.default_rng(5).standard_normal(rp.n)
    assert _rel(ChainArrowBackend.P_matvec(st, torch.tensor(x)),
                RefBackend.P_matvec(ref_st, jnp.asarray(x))) <= 1e-12
