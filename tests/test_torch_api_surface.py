"""The port's solve API beyond the plain solve, against the JAX package on
the 2 x 25 Manhattan world (and the 3D 2 x 30 world for the warm-start
vectors): the assembly memo, warm starts (``init_technique``,
``custom_init_file``) and ``build_initial_x``, the intermediate iterates,
the dense KKT backend, ``evaluate_objective`` and the top-level exports.

The JAX package's solves are read from ``tests/data/torch_reference.npz``
(``tests/torch_reference_data.py``); its numpy-only functions run live.

Tolerances. Solves: the same status, iterations within 1, objective
within 1e-9 relative (the chain bands of the two packages round
differently, see ``tests/test_torch_api.py``). Snapshots of the iterates,
while both solves are running: pres and dres, which are already scaled by
the magnitudes of their terms, within 1e-8 absolute; the gap within 1e-8
of max(1, |pobj|) (the solver's relative gap); pobj within 1e-8
relative. On the chain+arrow backend dres is held to 1e-7: before the
refinement gate opens the directions are raw condensed solves, and the
port's PCR band with explicit block inverses rounds them differently from
the JAX package's CR with block Cholesky (3.2e-8 at snapshot 5 of this
SOCP; 2e-10 between the two packages' dense backends).
"""

import copy

import numpy as np
import pytest
import torch

import score_tpu
import score_tpu.fg
from score_tpu.assembly.conic import build_conic_problem as ref_build
from score_tpu.assembly.conic import evaluate_objective as ref_evaluate_objective
from score_tpu.assembly.initialization import build_initial_x as ref_build_initial_x
from score_tpu.assembly.normalize import normalize_factor_graph as ref_normalize
from tests import torch_reference_data

import score_tpu_torch
import score_tpu_torch.fg
from score_tpu_torch import ScoreSolverParams, solve_problem_with_intermediate_iterates, solve_score
from score_tpu_torch import api
from score_tpu_torch.assembly.conic import build_conic_problem, evaluate_objective
from score_tpu_torch.assembly.initialization import ACCEPTABLE_INIT, build_initial_x
from score_tpu_torch.assembly.normalize import normalize_factor_graph
from score_tpu_torch.convert import factor_graph_from_reference
from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
from score_tpu_torch.solver.ipm import RUNNING, solve_conic, solve_conic_fixed

torch.set_num_threads(1)

CPU = ScoreSolverParams(device="cpu")


@pytest.fixture(scope="module")
def ref_graph():
    return torch_reference_data.graph_2x25()


@pytest.fixture(scope="module")
def reference():
    return torch_reference_data.load()


@pytest.fixture
def fg(ref_graph):
    return factor_graph_from_reference(ref_graph)


@pytest.fixture
def memo(monkeypatch):
    """An empty memo, and counts of the assemblies and prepares it runs."""
    monkeypatch.setattr(api, "_ASSEMBLY_CACHE", {})
    counts = {"build": 0, "prepare": 0}
    build, prepare = api.build_conic_problem, ChainArrowBackend.prepare

    def counting_build(*a, **k):
        counts["build"] += 1
        return build(*a, **k)

    def counting_prepare(*a, **k):
        counts["prepare"] += 1
        return prepare(*a, **k)

    monkeypatch.setattr(api, "build_conic_problem", counting_build)
    monkeypatch.setattr(ChainArrowBackend, "prepare", staticmethod(counting_prepare))
    return counts


def _digits(r):
    return (r.solved, r.iterations, r.primal_objective, r.dual_objective, r.gap,
            r.primal_residual, r.dual_residual)


def _assert_same_result(a, b):
    assert _digits(a) == _digits(b)
    for name, T in a.poses.items():
        np.testing.assert_array_equal(b.poses[name], T)
    for name, p in a.landmarks.items():
        np.testing.assert_array_equal(b.landmarks[name], p)
    for key, v in a.distances.items():
        np.testing.assert_array_equal(b.distances[key], v)


def _assert_matches_reference(port, reference, key):
    assert port.solved == bool(reference[f"{key}_solved"])
    assert abs(port.iterations - int(reference[f"{key}_iterations"])) <= 1
    pobj = float(reference[f"{key}_pobj"])
    assert abs(port.primal_objective - pobj) <= 1e-9 * abs(pobj)


def test_memo_assembles_once_and_repeats_digits(fg, memo):
    first = solve_score(fg, "SOCP", CPU)
    second = solve_score(fg, "SOCP", CPU)
    assert memo == {"build": 1, "prepare": 1}
    assert first.solved
    _assert_same_result(first, second)
    # the key holds the resolved device, and the entry's tensors lie on it
    (fp, entries), = api._ASSEMBLY_CACHE.values()
    (key, entry), = entries.items()
    assert key == ("SOCP", True, "auto", "auto", torch.device("cpu"))
    assert entry[2].device == torch.device("cpu") and entry[6].q.device == torch.device("cpu")
    # another relaxation of the same graph is a second entry of the graph
    solve_score(fg, "QCQP", CPU)
    assert memo == {"build": 2, "prepare": 2} and len(api._ASSEMBLY_CACHE) == 1


@pytest.mark.parametrize("mutate", ["middle_range", "odometry_value"])
def test_memo_sees_an_in_place_mutation(fg, memo, mutate):
    before = solve_score(fg, "SOCP", CPU)
    if mutate == "middle_range":
        fg.range_measurements[len(fg.range_measurements) // 2].dist *= 1.05
    else:
        fg.odom_measurements[0][10].x += 0.5
    after = solve_score(fg, "SOCP", CPU)
    assert memo == {"build": 2, "prepare": 2}
    assert after.primal_objective != before.primal_objective
    # a fresh graph with the same mutation gives the same digits
    _assert_same_result(after, solve_score(copy.deepcopy(fg), "SOCP", CPU))


def test_memo_evicts_the_least_recently_used_graph(fg, memo):
    graphs = [copy.deepcopy(fg) for _ in range(api._ASSEMBLY_CACHE_MAX + 1)]
    for g in graphs[:-1]:
        api._prepare_assembly(g, "SOCP", CPU)
    api._prepare_assembly(graphs[0], "SOCP", CPU)  # touch: graphs[1] is now the stalest
    assert memo["build"] == api._ASSEMBLY_CACHE_MAX
    api._prepare_assembly(graphs[-1], "SOCP", CPU)
    assert len(api._ASSEMBLY_CACHE) == api._ASSEMBLY_CACHE_MAX
    assert id(graphs[1]) not in api._ASSEMBLY_CACHE and id(graphs[0]) in api._ASSEMBLY_CACHE
    api._prepare_assembly(graphs[0], "SOCP", CPU)
    assert memo["build"] == api._ASSEMBLY_CACHE_MAX + 1


def test_memo_under_concurrent_callers(fg, memo):
    """More threads than cores share the memo across more graphs than it
    holds: every call gets its own graph's entry, and the memo never holds
    more than its cap."""
    import sys
    import threading

    graphs = [copy.deepcopy(fg) for _ in range(api._ASSEMBLY_CACHE_MAX + 2)]
    for i, g in enumerate(graphs):  # tell the graphs apart by content
        g.range_measurements[0].dist += 0.01 * i
    errors, sizes = [], []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for i in rng.integers(0, len(graphs), 4):
            scaled, scale = api._prepare_assembly(graphs[i], "SOCP", CPU)[:2]
            if scaled.range_measurements[0].dist != graphs[i].range_measurements[0].dist / scale:
                errors.append(i)
            sizes.append(len(api._ASSEMBLY_CACHE))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(sizes) == 48
    assert max(sizes) <= api._ASSEMBLY_CACHE_MAX


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_build_initial_x_bit_equal(ref_graph, dim, relaxation):
    g = ref_graph if dim == 2 else torch_reference_data.world_3d(loop=True)
    ref_scaled = ref_normalize(g)[0]
    rp, ridx = ref_build(ref_scaled, relaxation)
    scaled = normalize_factor_graph(factor_graph_from_reference(g))[0]
    pp, pidx = build_conic_problem(scaled, relaxation, device="cpu")
    for technique in ACCEPTABLE_INIT:
        if dim == 3 and technique == "random":
            # both packages draw 2D landmark positions for a 3D graph
            for build, args in ((ref_build_initial_x, (ref_scaled, rp, ridx)),
                                (build_initial_x, (scaled, pp, pidx))):
                with pytest.raises(ValueError, match="broadcast"):
                    build(*args, technique, rng=np.random.default_rng(5))
            continue
        ref_x = ref_build_initial_x(ref_scaled, rp, ridx, technique,
                                    rng=np.random.default_rng(5))
        x = build_initial_x(scaled, pp, pidx, technique, rng=np.random.default_rng(5))
        assert x.dtype == np.float64
        np.testing.assert_array_equal(x, ref_x, err_msg=technique)
    with pytest.raises(ValueError):
        build_initial_x(scaled, pp, pidx, "default")


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_warm_start_matches_reference(fg, reference, relaxation):
    port = solve_score(fg, relaxation, ScoreSolverParams(device="cpu", init_technique="odom"))
    _assert_matches_reference(port, reference, f"api_odom_{relaxation.lower()}")
    assert port.solved and port.gap / abs(port.primal_objective) <= 1e-6


def test_warm_start_stall_matches_reference(reference):
    """On the 3 x 40 world the odometry warm start ends, in both packages,
    by the stall detector after 5 iterations, unsolved: the objective
    falls from the dead-reckoned start much faster than the gap, so the
    relative gap in the best-iterate metric grows for the first trips and
    the iterate never beats the start (the JAX package's behaviour,
    kept)."""
    fg = factor_graph_from_reference(torch_reference_data.graph_3x40())
    port = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", init_technique="odom"))
    assert not bool(reference["api_odom_3x40_socp_solved"])
    _assert_matches_reference(port, reference, "api_odom_3x40_socp")
    assert port.iterations == int(reference["api_odom_3x40_socp_iterations"]) == 5


def test_custom_init_file(fg, tmp_path):
    """A custom x0 file holding the odometry x0 gives the odom solve."""
    scaled = normalize_factor_graph(fg)[0]
    pp, pidx = build_conic_problem(scaled, "SOCP", device="cpu")
    path = tmp_path / "x0.npz"
    np.savez(path, x=build_initial_x(scaled, pp, pidx, "odom"))
    custom = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", custom_init_file=str(path)))
    odom = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", init_technique="odom"))
    assert custom.solved
    _assert_same_result(custom, odom)


@pytest.mark.parametrize("backend", ["dense", "chain_arrow"])
def test_iterates_match_reference(fg, reference, backend):
    params = ScoreSolverParams(device="cpu", backend=backend)
    snaps = solve_problem_with_intermediate_iterates(fg, "SOCP", params)
    final = solve_score(fg, "SOCP", params)
    assert len(snaps) == final.iterations + 1
    assert [s.iterations for s in snaps] == list(range(len(snaps)))
    _assert_same_result(snaps[-1], final)
    assert not any(s.solved for s in snaps[:-1])
    ref = reference[f"api_iterates_{backend}_socp"]
    assert abs(len(ref) - len(snaps)) <= 1
    dres_tol = 1e-8 if backend == "dense" else 1e-7
    # snapshots before each solve's last are taken while it is running
    for i in range(min(len(ref), len(snaps)) - 1):
        pres, dres, gap, pobj = ref[i]
        s = snaps[i]
        assert abs(s.primal_residual - pres) <= 1e-8, i
        assert abs(s.dual_residual - dres) <= dres_tol, i
        assert abs(s.gap - gap) <= 1e-8 * max(1.0, abs(pobj)), i
        assert abs(s.primal_objective - pobj) <= 1e-8 * abs(pobj), i


def test_fixed_trips_equal_the_while_loop(fg):
    """solve_conic_fixed freezes a terminal state: the same result as
    solve_conic with max_iter = num_iters, also with trips to spare."""
    problem, idx = build_conic_problem(normalize_factor_graph(fg)[0], "SOCP", device="cpu")
    aux = build_chain_arrow(problem, idx)
    ipm = CPU.ipm_params()
    loop = solve_conic(problem, ipm, backend_aux=aux)
    fixed = solve_conic_fixed(problem, ipm, num_iters=ipm.max_iter, backend_aux=aux)
    assert (fixed.status, fixed.iterations, fixed.pobj, fixed.gap) == (
        loop.status, loop.iterations, loop.pobj, loop.gap)
    assert torch.equal(fixed.x, loop.x) and loop.status != RUNNING
    assert loop.iterations < ipm.max_iter


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_dense_backend_matches_reference_and_chain_arrow(fg, reference, relaxation):
    dense = solve_score(fg, relaxation, ScoreSolverParams(device="cpu", backend="dense"))
    _assert_matches_reference(dense, reference, f"api_dense_{relaxation.lower()}")
    chain = solve_score(fg, relaxation, ScoreSolverParams(device="cpu", backend="chain_arrow"))
    assert dense.solved and chain.solved
    assert abs(dense.primal_objective - chain.primal_objective) <= dense.gap + chain.gap


def test_dense_backend_selected(fg):
    problem, idx = build_conic_problem(fg, "SOCP", device="cpu")
    backend, aux = api._select_backend(fg, problem, idx, ScoreSolverParams(device="cpu",
                                                                            backend="dense"))
    assert backend is DenseBackend and aux is None
    ops = DenseBackend.prepare(problem)
    assert ops.P.shape == (problem.n, problem.n)
    # symmetric up to the order the scatter-add sums each entry's terms in
    torch.testing.assert_close(ops.P, ops.P.T, rtol=0, atol=1e-15 * float(ops.P.abs().max()))
    v = torch.randn(problem.n, dtype=torch.float64)
    st = ChainArrowBackend.prepare(problem, build_chain_arrow(problem, idx))
    torch.testing.assert_close(DenseBackend.P_matvec(ops, v), ChainArrowBackend.P_matvec(st, v),
                               rtol=1e-12, atol=1e-12 * float(v.abs().max() * ops.P.abs().max()))
    for name in ("q", "const", "mask", "xpin", "hnorm", "qnorm"):
        assert torch.equal(getattr(ops, name), getattr(st, name)), name


def test_evaluate_objective_matches_reference(ref_graph, fg):
    rp, _ = ref_build(ref_normalize(ref_graph)[0], "SOCP")
    scaled = normalize_factor_graph(fg)[0]
    pp, pidx = build_conic_problem(scaled, "SOCP", device="cpu")
    rng = np.random.default_rng(3)
    for x in (build_initial_x(scaled, pp, pidx, "odom"), rng.standard_normal(pp.n)):
        ref = ref_evaluate_objective(rp, x)
        assert abs(evaluate_objective(pp, torch.as_tensor(x)) - ref) <= 1e-12 * abs(ref)
        assert abs(evaluate_objective(pp, x) - ref) <= 1e-12 * abs(ref)
    res = solve_conic(pp, CPU.ipm_params(), backend_aux=build_chain_arrow(pp, pidx))
    assert abs(evaluate_objective(pp, res.x) - res.pobj) <= 1e-9 * abs(res.pobj)


def test_top_level_exports():
    assert set(score_tpu.__all__) <= set(score_tpu_torch.__all__)
    for name in score_tpu_torch.__all__:
        assert getattr(score_tpu_torch, name) is not None, name
    for name in ("SOCP_RELAXATION", "QCQP_RELAXATION", "ACCEPTABLE_RELAXATIONS", "RANDOM_INIT",
                 "ZERO_INIT", "ODOM_INIT", "GT_INIT", "ACCEPTABLE_INIT"):
        assert getattr(score_tpu_torch, name) == getattr(score_tpu, name), name
    assert score_tpu_torch.solve_problem_with_intermediate_iterates is (
        api.solve_problem_with_intermediate_iterates)
    assert sorted(score_tpu_torch.fg.__all__) == sorted(score_tpu.fg.__all__)
    # the JAX package's lazy exports of its refinement stage
    from score_tpu_torch import refine as port_refine

    for name in ("refine_solution", "RefineParams", "RefineResult"):
        assert getattr(score_tpu, name) is not None, name
        assert getattr(score_tpu_torch, name) is getattr(port_refine, name), name


def test_params_validate_options():
    p = ScoreSolverParams()
    assert (p.device, p.backend, p.init_technique, p.custom_init_file) == (
        "cuda", "auto", "default", None)
    with pytest.raises(ValueError, match="backend"):
        ScoreSolverParams(backend="sparse")
    with pytest.raises(ValueError, match="init technique"):
        ScoreSolverParams(init_technique="lidar")
