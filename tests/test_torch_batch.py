"""The port's Monte-Carlo batch (``score_tpu_torch.parallel``) against the
JAX package's own batch, lane by lane, on the CPU in f64.

The JAX package's ``solve_conic_batch`` outputs are read from
``tests/data/torch_reference.npz`` (``batch_*``, written by
``JAX_PLATFORMS=cpu python tests/torch_reference_data.py --batch``); its
numpy-only simulator runs live. The reference is the JAX *batch*, not its
single solves: the batch runs the IPM branchless with two gates shared by
the trials, and a lane may step otherwise than that trial's single solve.

Tolerances. A lane against the JAX lane: the same status, iterations within
1, pobj within 1e-9 relative or within the lane's final gap, whichever is
larger, and the batch's trips within 1. The gap is the larger on the 2 x 10
fixture, whose optima (|pobj| < 1) end at absolute gaps of 1.7e-8 to
9.1e-7: there the objective moves by up to ~1e-10 with roundoff (lane 6:
the port's own single solve and batch lane differ by 4.3e-11, the port's
lane and the JAX lane by 8.6e-11; x by 1e-6, the optimum being nearly
degenerate). On the Monte-Carlo world 1e-9 relative is the larger. A lane against the port's single solve of its trial: pobj
within 1e-6 relative (1e-8 absolute), as ``tests/test_parallel.py`` holds
the JAX package's.

The band runs its default schedule everywhere: cyclic reduction to one
block, the JAX package's CPU band's order. The 2 x 10 fixture's bands (not
normalized, condition up to 1.9e11 near the optimum) are where a parallel
cyclic reduction remainder lost backward stability (ROADMAP, settled
faults): ``test_default_band_residual_at_the_reference_order`` holds the
band's residual along that fixture's iterates to the JAX band's, and the
two default-schedule tests its lanes to the JAX lanes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from score_tpu.sim.manhattan import ManhattanWorldParams as RefWorldParams
from score_tpu.sim.manhattan import resample_measurements as ref_resample
from score_tpu.sim.manhattan import simulate_manhattan_world as ref_simulate
from tests import torch_reference_data as refdata

from score_tpu_torch.assembly.conic import build_conic_problem
from score_tpu_torch.convert import factor_graph_from_reference
from score_tpu_torch.ops import band
from score_tpu_torch.parallel import solve_conic_batch, stack_problems
from score_tpu_torch.parallel.batch import _solve_batch_trips
from score_tpu_torch.sim.manhattan import (
    ManhattanWorldParams,
    resample_measurements,
    simulate_manhattan_world,
)
from score_tpu_torch.solver import chain_arrow as chain_arrow_module
from score_tpu_torch.solver import cones, ipm
from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.chain_arrow import (
    ChainArrowBackend,
    build_chain_arrow,
    lane_cholesky,
)
from score_tpu_torch.solver.ipm import IPMParams, solve_conic
from score_tpu_torch.solver.params import ScoreSolverParams

torch.set_num_threads(1)

REF = refdata.load()
# the lane-by-lane cases in f64 (2D, and the 3D loop world's: Db = 12, the
# QCQP's 3 x 3 pivots); the no-cone batch has its own test
CASES = ("fixture_socp_dense", "fixture_socp_chain_arrow", "fixture_qcqp_chain_arrow",
         "mc8_socp_chain_arrow", "loop3d_socp_chain_arrow", "loop3d_qcqp_chain_arrow")
# the f32 batch's cases
F32_CASES = ("fixture_socp_chain_arrow_f32", "mc4_socp_chain_arrow_f32",
             "loop3d_socp_chain_arrow_f32")
# the fixture's chain+arrow cases, whose bands are the worst conditioned
FULL_CR = ("fixture_socp_chain_arrow", "fixture_qcqp_chain_arrow")


def _world(w):
    return simulate_manhattan_world(ManhattanWorldParams(**w))


def _problems(case):
    """The case's trials assembled by the port (cast to float32 for an f32
    case), their chain+arrow structure, its backend and params."""
    world, _, relaxation, backend, _, precision = refdata.BATCH_CASES[case]
    trials = refdata.batch_trials(case, _world, resample_measurements)
    if world == refdata.BATCH_LOOP_3D:  # the JAX package's graphs
        trials = [factor_graph_from_reference(t) for t in trials]
    problems = [build_conic_problem(t, relaxation, device="cpu")[0] for t in trials]
    if precision == "f32":
        problems = [p.cast(torch.float32) for p in problems]
    aux = None
    if backend == "chain_arrow":
        idx = build_conic_problem(trials[0], relaxation, device="cpu")[1]
        aux = build_chain_arrow(problems[0], idx)
    be = DenseBackend if backend == "dense" else ChainArrowBackend
    return problems, be, aux, refdata.batch_params(case, ScoreSolverParams)


@pytest.fixture(scope="module")
def solved():
    """case -> (problems, backend, aux, params, batch result, trips), each
    case solved once at the default band schedule."""
    done = {}

    def get(case):
        if case not in done:
            problems, be, aux, params = _problems(case)
            res, trips = _solve_batch_trips(stack_problems(problems), params, be, aux)
            done[case] = (problems, be, aux, params, res, trips)
        return done[case]

    return get


def _measurements(fg):
    """Every measurement of a graph as plain values, in order."""
    odom = [(m.base_pose, m.to_pose, m.x, m.y, m.theta, m.translation_precision,
             m.rotation_precision, m.timestamp) for chain in fg.odom_measurements for m in chain]
    loops = [(m.base_pose, m.to_pose, m.x, m.y, m.theta, m.translation_precision,
              m.rotation_precision, m.timestamp) for m in fg.loop_closure_measurements]
    ranges = [(tuple(m.association), m.dist, m.stddev, m.timestamp)
              for m in fg.range_measurements]
    return odom, loops, ranges


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_resample_matches_reference(seed):
    """Bit-equal measurements (both packages draw the same numpy stream),
    on the Monte-Carlo world, whose base graph has inter-robot ranges and
    odometry on every chain."""
    w = refdata.BATCH_MC_WORLD
    ref = ref_resample(ref_simulate(RefWorldParams(**w)), seed=seed)
    port = resample_measurements(_world(w), seed=seed)
    ref_m, port_m = _measurements(ref), _measurements(port)
    assert [len(x) for x in port_m] == [len(x) for x in ref_m]
    assert port_m == ref_m
    assert len(port.odom_measurements) == len(ref.odom_measurements) == w["num_robots"]
    # the variables and priors are the base graph's
    assert port.pose_variables is not None and port.num_poses == ref.num_poses


def test_stack_rejects_mismatched_structure():
    """(n, k, dim, relaxation) differ: as ``tests/test_parallel.py`` sets it up."""
    problems = _problems("fixture_socp_dense")[0]
    other = build_conic_problem(_world(dict(num_robots=1, num_poses_per_robot=5,
                                            num_landmarks=1, grid_size=4, seed=3)),
                                "SOCP", device="cpu")[0]
    with pytest.raises(ValueError):
        stack_problems([problems[0], other])


def test_stack_rejects_mismatched_field_shape():
    """The same (n, k, dim, relaxation) but a data field of another shape."""
    problems = _problems("fixture_socp_dense")[0]
    p1 = dataclasses.replace(problems[1], cost_b=problems[1].cost_b[:-1])
    with pytest.raises(ValueError, match="cost_b"):
        stack_problems([problems[0], p1])


def test_stack_layout():
    """Every data field on a new leading trial axis; the static fields and
    ``num_cones`` (the trial count, as in the JAX package) as the first's."""
    problems = _problems("fixture_socp_dense")[0]
    b = stack_problems(problems)
    assert b.cone_h.shape == (8,) + problems[0].cone_h.shape
    assert torch.equal(b.cost_coefs[3], problems[3].cost_coefs)
    assert (b.n, b.k, b.dim, b.relaxation) == (problems[0].n, problems[0].k, problems[0].dim,
                                               problems[0].relaxation)
    assert b.num_cones == 8  # the quirk both packages share; batch paths read shape[-2]


@pytest.mark.parametrize("case", CASES)
def test_batch_matches_reference_lane_by_lane(solved, case):
    _, _, _, params, res, trips = solved(case)
    ref = {name: REF[f"batch_{case}_{name}"] for name in refdata.BATCH_FIELDS + ("trips",)}
    B = ref["status"].shape[0]
    assert res.status.dtype == res.iterations.dtype == torch.int64
    assert res.x.shape == (B,) + ref["x"].shape[1:]
    assert res.status.tolist() == ref["status"].tolist()
    assert np.all(np.abs(res.iterations.numpy() - ref["iterations"]) <= 1)
    assert abs(trips - int(ref["trips"])) <= 1
    assert trips <= params.max_iter
    pobj, ref_pobj = res.pobj.numpy(), ref["pobj"]
    for lane in range(B):
        tol = max(1e-9 * abs(ref_pobj[lane]), abs(ref["gap"][lane]))
        assert abs(pobj[lane] - ref_pobj[lane]) <= tol, (lane, pobj[lane], ref_pobj[lane])


@pytest.mark.parametrize("case", FULL_CR)
def test_default_schedule_lanes_stay_solved(solved, case):
    """The fixture's chain+arrow cases at the port's default band schedule
    (compacted to one block at Tp = 16): every lane ends solved (OPTIMAL or
    OPTIMAL_INACCURATE) with a finite x, and its objective within the
    solver's own relative-gap scale, 1e-6 * max(1, |pobj|), of the JAX
    lane's."""
    _, _, _, params, res, trips = solved(case)
    ref_pobj = REF[f"batch_{case}_pobj"]
    assert all(s in ipm.SOLVED_STATUSES for s in res.status.tolist())
    assert torch.isfinite(res.x).all()
    assert trips <= params.max_iter
    tol = 1e-6 * np.maximum(1.0, np.abs(ref_pobj))
    assert np.all(np.abs(res.pobj.numpy() - ref_pobj) <= tol)


@pytest.mark.parametrize("case", FULL_CR)
def test_default_schedule_matches_reference(solved, case):
    """At the default band schedule the fixture's chain+arrow lanes end as
    the JAX lanes do (OPTIMAL after 6-9 iterations). With a parallel
    cyclic reduction remainder of 16 blocks they ended OPTIMAL_INACCURATE
    after 10-20 (the fault that set the schedule)."""
    _, _, _, _, res, trips = solved(case)
    assert res.status.tolist() == REF[f"batch_{case}_status"].tolist()
    assert np.all(np.abs(res.iterations.numpy() - REF[f"batch_{case}_iterations"]) <= 1)
    assert abs(trips - int(REF[f"batch_{case}_trips"])) <= 1


@pytest.mark.parametrize("case", CASES)
def test_lanes_match_single_solves(solved, case):
    """Each lane's objective within 1e-6 of the port's single solve of its
    trial, as the JAX package's test holds its own (on its first three)."""
    problems, be, aux, params, res, _ = solved(case)
    for lane, pb in enumerate(problems):
        single = solve_conic(pb, params, backend=be, backend_aux=aux)
        assert single.pobj == pytest.approx(float(res.pobj[lane]), rel=1e-6, abs=1e-8)


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_batch_matches_reference_lane_by_lane(solved, case):
    """The f32 batch (float32 stacks, the f32 mode's tolerances, the f32
    band over the block kernels' plain twins) against the JAX package's
    f32 batch of the same stacks: the same status lane by lane; where the
    objectives are of order one or more (the Monte-Carlo and 3D worlds)
    within 2e-2 relative (PERF.md section 2's f32 parity bound), and on
    the 3D world iterations within 3. The fixture's f32 objectives (< 1,
    the f64 optima 1e-10 to 0.76) are roundoff-bound in both packages: its
    lanes and the Monte-Carlo world's end OPTIMAL_INACCURATE on a
    dual-residual floor (2e-3 to 4e-3) at trips that follow the roundoff
    (the JAX package's own f32 batch lanes and single solves differ by up
    to 0.16 in the fixture's objectives and by 3 iterations); there each
    lane's objective is held within 0.1 of the f64 optimum (measured: port
    up to 0.048, JAX package up to 0.076)."""
    problems, _, _, params, res, trips = solved(case)
    ref = {name: REF[f"batch_{case}_{name}"] for name in refdata.BATCH_FIELDS + ("trips",)}
    assert res.x.dtype == torch.float32 and torch.isfinite(res.x).all()
    assert res.status.tolist() == ref["status"].tolist()
    assert all(s in ipm.SOLVED_STATUSES for s in res.status.tolist())
    assert trips <= params.max_iter
    pobj, ref_pobj = res.pobj.double().numpy(), ref["pobj"]
    if case.startswith("fixture"):
        f64 = REF["batch_fixture_socp_chain_arrow_pobj"]
        assert np.all(np.abs(pobj - f64) <= 0.1 * np.maximum(1.0, np.abs(f64)))
        assert np.all(np.abs(ref_pobj - f64) <= 0.1 * np.maximum(1.0, np.abs(f64)))
    else:
        assert np.all(np.abs(pobj - ref_pobj) <= 2e-2 * np.maximum(1.0, np.abs(ref_pobj)))
    if case.startswith("loop3d"):
        assert np.all(np.abs(res.iterations.numpy() - ref["iterations"]) <= 3)


@pytest.mark.parametrize("case", F32_CASES)
def test_f32_lanes_match_single_solves(solved, case):
    """Each f32 lane against the port's f32 single solve of its trial: the
    same status, iterations within 3, objective within 2e-2 * max(1,
    |objective|) (PERF.md section 2's f32 bounds)."""
    problems, be, aux, params, res, _ = solved(case)
    for lane, pb in enumerate(problems):
        single = solve_conic(pb, params, backend=be, backend_aux=aux)
        assert single.status == int(res.status[lane]), lane
        assert abs(single.iterations - int(res.iterations[lane])) <= 3, lane
        assert abs(single.pobj - float(res.pobj[lane])) <= 2e-2 * max(1.0, abs(single.pobj))


def test_default_band_residual_at_the_reference_order():
    """The f64 band at its default schedule along the iterates of the
    fixture's trial 0 (its bands' condition grows to 1.9e11): the backward
    error max |T x - b| / max |b| within 10x of the larger of the JAX
    package's CPU band's and a dense Cholesky's on every iterate (measured:
    at most 2x; a parallel cyclic reduction remainder of 16 blocks reached
    7.8e4)."""
    import jax
    import jax.numpy as jnp
    from score_tpu.solver.pcr import pcr_factor, pcr_solve

    problems, _, ca, _ = _problems("fixture_socp_chain_arrow")
    _, bands = refdata.recorded_bands(problems[0], ca, IPMParams(max_iter=30))
    assert len(bands) >= 6
    rng = np.random.default_rng(0)
    jax_solve = jax.jit(jax.vmap(lambda d, u, r: pcr_solve(pcr_factor(d, u), r)))
    for D, U in bands:
        C, Tp, Db = D.shape[:3]
        b = torch.tensor(rng.standard_normal((C, Tp, Db, 3)))

        def resid(x):
            return ((band.band_matvec(D, U, x) - b).abs().max() / b.abs().max()).item()

        port = resid(band.band_solve(band.band_factor(D, U), b))
        ref = resid(torch.tensor(np.asarray(jax_solve(
            jnp.asarray(D.numpy()), jnp.asarray(U.numpy()), jnp.asarray(b.numpy())))))
        dense = []
        for c in range(C):
            Tm = torch.block_diag(*[D[c, i] for i in range(Tp)])
            for i in range(Tp - 1):
                Tm[i * Db:(i + 1) * Db, (i + 1) * Db:(i + 2) * Db] = U[c, i]
                Tm[(i + 1) * Db:(i + 2) * Db, i * Db:(i + 1) * Db] = U[c, i].mT
            dense.append(torch.cholesky_solve(b[c].reshape(Tp * Db, 3),
                                              torch.linalg.cholesky(Tm)).reshape(Tp, Db, 3))
        assert port <= 10.0 * max(ref, resid(torch.stack(dense))), (port, ref)


def test_nocone_batch_does_what_the_reference_does():
    """Trials without a cone: the JAX package's batch runs its IPM on them
    (a stacked problem's ``num_cones`` is the trial count) and ends each
    lane by the stall detector; the port's batch does the same."""
    case = "nocones_socp_dense"
    problems, be, aux, params = _problems(case)
    assert problems[0].cone_h.shape[0] == 0
    res, trips = _solve_batch_trips(stack_problems(problems), params, be, aux)
    assert res.status.tolist() == REF[f"batch_{case}_status"].tolist()
    assert res.iterations.tolist() == REF[f"batch_{case}_iterations"].tolist()
    assert abs(trips - int(REF[f"batch_{case}_trips"])) <= 1
    np.testing.assert_allclose(res.pobj.numpy(), REF[f"batch_{case}_pobj"], rtol=0, atol=1e-9)
    assert torch.isfinite(res.x).all()


def test_one_structure_serves_the_batch(monkeypatch):
    """``prepare`` keeps the structure passed in, no per-trial tensor is B
    copies of a structure tensor, and the band gets the trials folded into
    its chain axis: one ``band_factor`` a factor, (B * C, Tp, D, D)."""
    problems, _, ca, _ = _problems("fixture_socp_chain_arrow")
    B = len(problems)
    batch = stack_problems(problems)
    ops = ChainArrowBackend.prepare(batch, ca)
    assert ops.structure is ca
    shapes = []
    factor = chain_arrow_module.band_factor

    def recording(D, U, *a, **k):
        shapes.append(tuple(D.shape))
        return factor(D, U, *a, **k)

    monkeypatch.setattr(chain_arrow_module, "band_factor", recording)
    N, k = problems[0].cone_h.shape
    eyes = torch.eye(k, dtype=torch.float64).expand(B, N, k, k).clone()
    factors = ChainArrowBackend.factor(batch, ops, eyes, IPMParams())
    assert shapes == [(B * ca.C, band.pad_length(ca.T), ca.D, ca.D)]
    structure = {f.name: getattr(ca, f.name) for f in dataclasses.fields(ca)
                 if isinstance(getattr(ca, f.name), torch.Tensor)}
    per_trial = [getattr(ops, f.name) for f in dataclasses.fields(ops) if f.name != "structure"]
    per_trial += [t for t in factors if isinstance(t, torch.Tensor)]
    for t in per_trial:
        assert t.shape[0] == B
        assert t.stride(0) != 0 or t.numel() == 0  # not a broadcast view
        for s in structure.values():
            if t.shape[1:] == s.shape and s.numel() > 1:
                assert not all(torch.equal(t[i], s.to(t.dtype)) for i in range(B))


def test_backends_lane_by_lane_equal_single(monkeypatch):
    """Each backend's prepare, operators, factor and solve on the stack,
    lane by lane, against the same on each trial alone (1e-14 relative:
    the batched matmuls may sum in another order)."""
    for case in ("fixture_socp_dense", "fixture_qcqp_chain_arrow"):
        problems, be, aux, params = _problems(case)
        problems = problems[:3]
        batch = stack_problems(problems)
        ops = be.prepare(batch, aux)
        singles = [be.prepare(p, aux) for p in problems]
        rng = np.random.default_rng(4)
        n, (N, k) = problems[0].n, problems[0].cone_h.shape
        x = torch.tensor(rng.standard_normal((3, n)))
        s = torch.tensor(rng.standard_normal((3, N, k)))
        z = torch.tensor(rng.standard_normal((3, N, k)))
        s[..., 0] = torch.linalg.vector_norm(s[..., 1:], dim=-1) + 0.5  # interior
        z[..., 0] = torch.linalg.vector_norm(z[..., 1:], dim=-1) + 0.5
        W = cones.winv2_matrices(cones.nt_scaling(s, z))
        f = be.factor(batch, ops, W, params)
        rhs = torch.tensor(rng.standard_normal((3, n))) * ops.mask
        got = (be.P_matvec(ops, x), be.G(batch, ops, x), be.GT(batch, ops, z),
               be.solve(batch, ops, f, rhs, params))
        for i, (p, o) in enumerate(zip(problems, singles)):
            fi = be.factor(p, o, W[i], params)
            want = (be.P_matvec(o, x[i]), be.G(p, o, x[i]), be.GT(p, o, z[i]),
                    be.solve(p, o, fi, rhs[i], params))
            for g, w in zip(got, want):
                assert ((g[i] - w).abs().max() / w.abs().max()).item() <= 1e-14, case


def test_lane_cholesky_retries_lane_by_lane():
    """Lane 0 factors, lane 1 breaks down and takes the retry, lane 2
    breaks down twice and turns NaN: the checked single Cholesky's rule,
    with no host read."""
    A = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    bad = torch.tensor([[1.0, 2.0], [2.0, 1.0]], dtype=torch.float64)  # indefinite
    first = torch.stack([A, bad, bad])
    retry = torch.stack([A + 1.0, bad + 5.0 * torch.eye(2, dtype=torch.float64), bad])
    L = lane_cholesky(first, retry)
    assert torch.equal(L[0], torch.linalg.cholesky(A))
    assert torch.equal(L[1], torch.linalg.cholesky(retry[1]))
    assert torch.isnan(L[2]).all()


def test_cone_reductions_one_value_a_trial():
    """inner, max_step, shift_to_interior over a trial axis: each trial's
    value as the unbatched call gives it (1e-15 relative: the sums may run
    in another order)."""
    rng = np.random.default_rng(9)
    u = torch.tensor(rng.standard_normal((4, 30, 3)))
    v = torch.tensor(rng.standard_normal((4, 30, 3)))
    u[..., 0] += 3.0
    got_inner, got_step = cones.inner(u, v), cones.max_step(u, v)
    got_shift = cones.shift_to_interior(v)
    assert got_inner.shape == got_step.shape == (4,)
    for i in range(4):
        assert got_inner[i].item() == pytest.approx(cones.inner(u[i], v[i]).item(), rel=1e-15)
        assert got_step[i].item() == cones.max_step(u[i], v[i]).item()
        assert torch.equal(got_shift[i], cones.shift_to_interior(v[i]))
    empty = torch.zeros((4, 0, 3), dtype=torch.float64)
    assert cones.max_step(empty, empty).tolist() == [10.0] * 4
    assert cones.shift_to_interior(empty) is empty


def test_gates_skip_refinement_and_centering(monkeypatch):
    """While both shared gates are closed a trip runs exactly the
    predictor's, the corrector's and the Gondzio correctors' solves (no
    refinement and no centering solve); once they open it runs more."""
    problems, _, _, params = _problems("fixture_socp_dense")
    solves = [["start", "start", 0]]  # the initial point's solve

    class Counting(DenseBackend):
        @staticmethod
        def solve(*a, **k):
            solves[-1][2] += 1
            return DenseBackend.solve(*a, **k)

    step = ipm._step_batch

    def recording(backend, problem, ops, params, st, rx, rz, shared_refine, shared_center,
                  fracs):
        solves.append([shared_refine, shared_center, 0])
        return step(backend, problem, ops, params, st, rx, rz, shared_refine, shared_center,
                    fracs)

    monkeypatch.setattr(ipm, "_step_batch", recording)
    res = solve_conic_batch(stack_problems(problems), params, backend=Counting)
    assert res.status.tolist() == REF["batch_fixture_socp_dense_status"].tolist()
    assert solves[0][2] == 1
    closed = [n for refine, center, n in solves[1:] if not refine and not center]
    opened = [n for refine, center, n in solves[1:] if refine or center]
    assert closed and opened
    assert set(closed) == {2 + params.gondzio_correctors}
    assert min(opened) > 2 + params.gondzio_correctors


def test_single_solve_unchanged_by_a_batch():
    """The single-solve path keeps its digits: a trial's solve_conic
    before and after a batch solve in the same process, bit for bit."""
    problems, be, aux, params = _problems("mc8_socp_chain_arrow")
    before = solve_conic(problems[0], params, backend=be, backend_aux=aux)
    solve_conic_batch(stack_problems(problems[:2]), params, backend=be, backend_aux=aux)
    after = solve_conic(problems[0], params, backend=be, backend_aux=aux)
    assert (after.status, after.iterations, after.pobj, after.gap, after.pres, after.dres) == (
        before.status, before.iterations, before.pobj, before.gap, before.pres, before.dres)
    assert torch.equal(after.x, before.x)


def test_batch_refuses_what_it_does_not_run():
    """An unstacked problem raises; a float32 stack runs (in f32, on the
    dense backend by default)."""
    problems = _problems("fixture_socp_dense")[0][:2]
    res = solve_conic_batch(stack_problems([p.cast(torch.float32) for p in problems]),
                            ScoreSolverParams(precision="f32", max_iter=3).ipm_params())
    assert res.x.dtype == torch.float32 and res.x.shape == (2, problems[0].n)
    with pytest.raises(ValueError, match="stack"):
        solve_conic_batch(problems[0])
