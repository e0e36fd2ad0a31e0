"""The port's sharded solves (``score_tpu_torch.parallel``:
``solve_conic_chain_sharded``, ``solve_conic_sharded``) on two gloo CPU
ranks, against the port's unsharded solves and the JAX package's sharded
runs, and the chain padding they rest on.

One world of two ranks is spawned for the file (``run_ranks``, a 120 s
timeout of its own: a rank that took a host decision from a value of its
own would hang the collectives, not return a wrong number), and runs every
sharded case: the 20 x 12 world of ``tests/test_parallel.py:93-134`` (seed
3, C = 20, 10 chains a rank) and the 3 x 8 world of ``:346-387`` (C = 3
padded to 4) chain-sharded, ``max_iter=40``; the 20 x 12 world in f32
(the f32 band over the block kernels' plain twins) and the 2 x 30 3D
world of ``tests/test_torch_3d.py`` as SOCP and QCQP (Db = 12, one chain a
rank), chain-sharded at the default parameters; the 8 trials of its
``trial_problems`` fixture trial-sharded over ``DenseBackend`` and over
``ChainArrowBackend``, ``max_iter=30``; and a batch of 5 trials, which
two ranks do not divide. The JAX package's sharded runs (8-device CPU
mesh) are read from ``tests/data/torch_reference.npz`` (``sharded_*``,
written by ``JAX_PLATFORMS=cpu python tests/torch_reference_data.py
--sharded``). The file imports no jax: the ranks import it.

Tolerances. Against the port's unsharded solve of the same problem: the
same status and iterations (and trips); pobj within 1e-9 relative, or,
where |pobj| < 1e-3, within the unsharded solve's final gap if that is
larger (PERF.md section 2's parity rule; chain sharding moves the chain
axis's sums: B'Z and B'w become two partial sums; the f64 worlds' optima
sit near 0, where the solve stops at an absolute gap of ~1e-8 and pobj
moves with roundoff by up to that gap: 1.6e-10 on the 20 x 12 world); x
within 1e-4, the JAX package's own padding bound. A trial-sharded lane
runs the unsharded lane's arithmetic on fewer lanes: pobj within 1e-12
relative. Against the JAX package's chain-sharded runs the same parity
rule with iterations within 1. Against its trial-sharded runs, the bounds
``tests/test_torch_batch.py`` holds the unsharded batch to against the
JAX batch: iterations within 1, pobj within 1e-9 relative or the
reference's final gap, whichever is larger, at any |pobj| (the fixture's
lane 1 ends at |pobj| = 0.099 and gap 1.7e-7 and differs from the JAX
lane by 2.8e-10). The f32 case: the f32 mode's parity (PERF.md section
2), pobj within 2e-2 relative (or the final gap where |pobj| < 1e-3);
its x unchecked (f32 roundoff moves a near-degenerate optimum).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tests import torch_reference_data as refdata

from score_tpu_torch.assembly.conic import build_conic_problem
from score_tpu_torch.assembly.normalize import normalize_factor_graph
from score_tpu_torch.parallel import (
    run_ranks,
    solve_conic_batch,
    solve_conic_chain_sharded,
    solve_conic_sharded,
    stack_problems,
)
from score_tpu_torch.parallel.batch import _solve_batch_trips, _solve_sharded_trips
from score_tpu_torch.sim.manhattan import (
    ManhattanWorldParams,
    resample_measurements,
    simulate_manhattan_world,
)
from score_tpu_torch.solver import collective
from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
from score_tpu_torch.solver.ipm import IPMParams, IPMResult, solve_conic
from score_tpu_torch.solver.params import ScoreSolverParams
from score_tpu_torch.sim.world3d import World3DParams, simulate_3d_world

torch.set_num_threads(1)

REF = refdata.load()
CHAIN_CASES = tuple(refdata.SHARDED_CHAIN_WORLDS)
# chain-sharded cases held to the port's unsharded solve only
PORT_CHAIN_CASES = ("chain20_f32", "world3d_socp", "world3d_qcqp")
BACKENDS = ("dense", "chain_arrow")
CHAIN_PARAMS = IPMParams(max_iter=refdata.SHARDED_CHAIN_ITERS)
BATCH_PARAMS = IPMParams(max_iter=refdata.SHARDED_BATCH_ITERS)
# the structure's fields with a leading chain axis
CHAIN_FIELDS = ("cm", "av", "arrow_col", "x_to_chain", "odom_row_base", "odom_valid")


def _chain_problem(case):
    fg = simulate_manhattan_world(ManhattanWorldParams(**refdata.SHARDED_CHAIN_WORLDS[case]))
    return build_conic_problem(fg, "SOCP", device="cpu")


def _chain_case(case):
    """(problem, idx, params) of a chain-sharded case."""
    if case in CHAIN_CASES:
        return _chain_problem(case) + (CHAIN_PARAMS,)
    if case == "chain20_f32":
        problem, idx = _chain_problem("chain20")
        return (problem.cast(torch.float32), idx,
                ScoreSolverParams(precision="f32").ipm_params())
    fg = normalize_factor_graph(simulate_3d_world(World3DParams(**refdata.WORLD_3D)))[0]
    problem, idx = build_conic_problem(fg, case.split("_")[1].upper(), device="cpu")
    return problem, idx, ScoreSolverParams(precision="f64").ipm_params()


def _fixture_trials(n=8):
    """The first ``n`` trials of ``tests/test_parallel.py``'s fixture as
    SOCP problems, and their chain+arrow structure."""
    base = simulate_manhattan_world(ManhattanWorldParams(**refdata.BATCH_FIXTURE))
    trials = [resample_measurements(base, seed=s) for s in range(n)]
    problems = [build_conic_problem(t, "SOCP", device="cpu")[0] for t in trials]
    idx = build_conic_problem(trials[0], "SOCP", device="cpu")[1]
    return problems, build_chain_arrow(problems[0], idx)


def _backend(name, aux):
    return (DenseBackend, None) if name == "dense" else (ChainArrowBackend, aux)


def _sharded_cases(device):
    """Every sharded case of the file, on each rank; rank 0's results
    come back: {case: IPMResult}, {backend: (IPMResult, trips, all_reduce
    calls)}, and the indivisible batch's error."""
    torch.set_num_threads(1)
    out = {}
    for case in CHAIN_CASES + PORT_CHAIN_CASES:
        problem, idx, params = _chain_case(case)
        out[case] = solve_conic_chain_sharded(problem, idx, params)
    problems, aux = _fixture_trials()
    batch = stack_problems(problems)
    for name in BACKENDS:
        be, be_aux = _backend(name, aux)
        before = collective.all_reduce.calls
        res, trips = _solve_sharded_trips(batch, BATCH_PARAMS, be, be_aux)
        out[name] = (res, trips, collective.all_reduce.calls - before)
    try:
        solve_conic_sharded(stack_problems(problems[:5]), BATCH_PARAMS)
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


@pytest.fixture(scope="module")
def sharded():
    return run_ranks(_sharded_cases, world=2, device="cpu", timeout=120)


@pytest.fixture(scope="module")
def unsharded():
    """The port's unsharded CPU solves of the same problems: {case:
    IPMResult}, {backend: (IPMResult, trips)}."""
    out = {}
    for case in CHAIN_CASES + PORT_CHAIN_CASES:
        problem, idx, params = _chain_case(case)
        out[case] = solve_conic(problem, params, backend=ChainArrowBackend,
                                backend_aux=build_chain_arrow(problem, idx))
    problems, aux = _fixture_trials()
    for name in BACKENDS:
        out[name] = _solve_batch_trips(stack_problems(problems), BATCH_PARAMS,
                                       *_backend(name, aux))
    return out


def _objective_tol(pobj, gap, rel, near_zero=1e-3):
    """``rel`` relative; where |pobj| < ``near_zero``, the final ``gap`` if
    that is larger."""
    pobj = np.abs(pobj)
    return np.where(pobj < near_zero, np.maximum(rel * pobj, gap), rel * pobj)


@pytest.mark.parametrize("case", CHAIN_CASES + PORT_CHAIN_CASES)
def test_chain_sharded_matches_unsharded(sharded, unsharded, case):
    got, want = sharded[case], unsharded[case]
    f32 = got.x.dtype == torch.float32
    assert (got.status, got.iterations) == (want.status, want.iterations)
    assert abs(got.pobj - want.pobj) <= _objective_tol(want.pobj, want.gap, 2e-2 if f32 else 1e-9)
    assert f32 or (got.x - want.x).abs().max().item() <= 1e-4


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_chain_sharded_matches_reference(sharded, case):
    got = sharded[case]
    key = f"sharded_chain_{case}"
    assert got.status == int(REF[f"{key}_status"])
    assert abs(got.iterations - int(REF[f"{key}_iterations"])) <= 1
    ref_pobj = float(REF[f"{key}_pobj"])
    assert abs(got.pobj - ref_pobj) <= _objective_tol(ref_pobj, float(REF[f"{key}_gap"]), 1e-9)


@pytest.mark.parametrize("backend", BACKENDS)
def test_trial_sharded_matches_unsharded(sharded, unsharded, backend):
    got, trips, _ = sharded[backend]
    want, want_trips = unsharded[backend]
    assert trips == want_trips
    assert torch.equal(got.status, want.status)
    assert torch.equal(got.iterations, want.iterations)
    assert ((got.pobj - want.pobj).abs() <= 1e-12 * want.pobj.abs()).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_trial_sharded_matches_reference(sharded, backend):
    got = sharded[backend][0]
    key = f"sharded_batch_{backend}"
    assert got.status.tolist() == REF[f"{key}_status"].tolist()
    assert np.abs(got.iterations.numpy() - REF[f"{key}_iterations"]).max() <= 1
    ref_pobj = REF[f"{key}_pobj"]
    tol = _objective_tol(ref_pobj, REF[f"{key}_gap"], 1e-9, near_zero=np.inf)
    assert (np.abs(got.pobj.numpy() - ref_pobj) <= tol).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_trial_sharded_gates_reduce_once_a_trip(sharded, backend):
    """One all_reduce (max) of the trip's flags a trip, then one a result
    field to gather the lanes: nothing else crosses the ranks."""
    _, trips, calls = sharded[backend]
    assert calls == trips + len(IPMResult._fields)


def test_indivisible_batch_raises(sharded):
    assert "not divisible by the world size 2" in sharded["indivisible"]


def test_unsharded_batch_makes_no_collective():
    problems, aux = _fixture_trials(2)
    before = collective.all_reduce.calls
    res = solve_conic_batch(stack_problems(problems), IPMParams(max_iter=3))
    assert collective.all_reduce.calls == before
    assert res.status.shape == (2,)


def test_sharded_solves_need_a_process_group():
    """Without a process group a sharded solve raises; it never runs as one
    process instead."""
    assert not dist.is_initialized()
    problem, idx = _chain_problem("chain3")
    with pytest.raises(RuntimeError, match="process group"):
        solve_conic_chain_sharded(problem, idx, IPMParams(max_iter=2))
    problems, _ = _fixture_trials(2)
    with pytest.raises(RuntimeError, match="process group"):
        solve_conic_sharded(stack_problems(problems), IPMParams(max_iter=2))
    assert not dist.is_initialized()


def test_run_ranks_on_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CPU-only refusal cannot show")
    with pytest.raises(RuntimeError, match="cuda"):
        run_ranks(_sharded_cases, world=2, device="cuda")


def _fail_on_rank_1(device):
    """Rank 1 raises; rank 0 waits at a barrier that rank 1 never reaches."""
    if dist.get_rank() == 1:
        raise ArithmeticError("rank 1 gives up")
    dist.barrier()


def test_a_failing_rank_fails_the_call():
    """The failure reaches the caller with the rank's traceback, and the
    waiting rank is terminated rather than left in its collective."""
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*rank 1 gives up"):
        run_ranks(_fail_on_rank_1, world=2, device="cpu", timeout=60)


@pytest.mark.parametrize("pad", [0, 2, 3])
def test_padding_to_no_more_chains_changes_nothing(pad):
    """``num_chains_pad`` at or below the chain count builds every array
    of the structure bit for bit as without it."""
    problem, idx = _chain_problem("chain3")
    plain = build_chain_arrow(problem, idx)
    padded = build_chain_arrow(problem, idx, num_chains_pad=pad)
    for f in dataclasses.fields(plain):
        a, b = getattr(plain, f.name), getattr(padded, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b, f.name


def test_padded_chains_are_inactive():
    """Padded chains carry no column (cm = av = 0, no arrow column, the pad
    x column) and no odometry; the real chains' entries are unchanged."""
    problem, idx = _chain_problem("chain3")
    plain = build_chain_arrow(problem, idx)
    padded = build_chain_arrow(problem, idx, num_chains_pad=8)
    C = plain.C
    assert padded.C == 8
    for name in CHAIN_FIELDS:
        a, b = getattr(plain, name), getattr(padded, name)
        assert torch.equal(b[:C], a), name
    assert not padded.cm[C:].any() and not padded.av[C:].any()
    assert (padded.arrow_col[C:] == padded.A).all()
    assert (padded.x_to_chain[C:] == problem.n).all()
    assert not padded.odom_valid[C:].any()


def test_chain_padding_is_neutral():
    """The JAX package's padding test (``tests/test_parallel.py:346-387``)
    at its bounds: padding moves the chain axis's sums, so the iterates
    differ at roundoff."""
    problem, idx = _chain_problem("chain3")
    r0 = solve_conic(problem, CHAIN_PARAMS, backend=ChainArrowBackend,
                     backend_aux=build_chain_arrow(problem, idx))
    r8 = solve_conic(problem, CHAIN_PARAMS, backend=ChainArrowBackend,
                     backend_aux=build_chain_arrow(problem, idx, num_chains_pad=8))
    assert math.isclose(r8.pobj, r0.pobj, rel_tol=1e-6, abs_tol=1e-9)
    assert (r8.x - r0.x).abs().max().item() <= 1e-4
