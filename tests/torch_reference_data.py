"""Outputs of the JAX package that the port's CPU tests are held to where a
live JAX run would be the test's only cost: ``tests/data/torch_reference.npz``.

    JAX_PLATFORMS=cpu python tests/torch_reference_data.py

rebuilds the graphs below with the JAX package's simulators, solves them
with the JAX package in f64 on the CPU, and rewrites the file. The tests
build the same graphs through the functions here.

    JAX_PLATFORMS=cpu python tests/torch_reference_data.py --qcqp3d-sizes

writes nothing: it solves the 3D QCQP of 4-robot worlds of 30, 60 and 100
poses a robot (6 landmarks, the 3D bench's settings) with the JAX package
and with the port on the CPU, and prints each one's status, iterations and
dual residual: where the JAX package's own solve ends OPTIMAL_INACCURATE
as the worlds grow toward 3D 4x250. Entries of the file:

- ``loop3d_qcqp_*``: ``solve_conic`` of the QCQP relaxation of the 3D loop
  world (status, iterations, primal objective, gap, x), read by
  ``tests/test_torch_3d.py::test_solve_score_3d_matches_reference[QCQP]``
  (its SOCP case and the QCQP fault test solve live);
- ``f32_4x50_socp_f64_objective``: ``solve_score`` of the f32 checks' 4 x 50
  world as SOCP in f64, read by
  ``tests/test_torch_api.py::test_f32_solve_matches_reference`` (its f32
  reference solves live);
- ``loop3d_f32_socp_*``, ``loop3d_f32_qcqp_*``, ``plain3d_f32_socp_*``:
  ``solve_score`` with ``precision="f32"`` (the JAX package's unrolled f32
  path) of the 3D loop world as SOCP and QCQP and of the plain 3D world as
  SOCP (solved, iterations, primal objective, gap), read by the f32 cases
  of ``tests/test_torch_3d.py``;
- ``qcqp3d_4x100_*``: ``solve_conic`` of the QCQP relaxation of the 4 x 100
  3D world (``WORLD_3D_4X100``) in f64 (status, iterations, primal
  objective, gap, dual residual), read by
  ``tests/test_torch_3d.py::test_stalled_qcqp_3d_matches_what_the_reference_shares``;
- ``api_dense_{socp,qcqp}_*``, ``api_odom_{socp,qcqp}_*``: ``solve_score``
  of the 2 x 25 world (``WORLD_2X25``) in f64 with ``backend="dense"`` and
  with ``init_technique="odom"`` (solved, iterations, primal objective,
  gap), ``api_odom_3x40_socp_*``: the same odometry warm start of the 3 x
  40 world (``WORLD_3X40``), and ``api_iterates_{dense,chain_arrow}_socp``: the (iterations + 1,
  4) [pres, dres, gap, pobj] of every snapshot of
  ``solve_problem_with_intermediate_iterates`` of its SOCP on each
  backend, read by ``tests/test_torch_api_surface.py``;
- ``cli_{full,g2o,unsolved}_{rc,summary}``: the exit code and the
  JSON summary line of ``python -m score_tpu`` (``score_tpu.__main__.main``)
  on the CLI checks' graphs (``cli_graph``) with the flags of
  ``CLI_CASES``, read by ``tests/test_torch_cli.py``.

    JAX_PLATFORMS=cpu python tests/torch_reference_data.py --cli

rewrites only the ``cli_*`` entries of the file.

    JAX_PLATFORMS=cpu python tests/torch_reference_data.py --batch

rewrites only the ``batch_*`` entries: ``score_tpu.parallel.
solve_conic_batch`` on the CPU in f64 (``BATCH_CASES``), each lane's
status, iterations, pobj, gap, pres, dres and x, and the batch's loop
trips (``batch_<case>_trips``: the slowest lane's iterations + 1, capped
at max_iter, which is the JAX loop's trip count unless its last lane ends
on a non-finite step), read by ``tests/test_torch_batch.py``:

- ``batch_fixture_socp_{dense,chain_arrow}_*``: ``tests/test_parallel.py``'s
  fixture (``BATCH_FIXTURE``: 2 x 10 poses, seed 11, trials of seeds 0-7)
  as SOCP, ``IPMParams(max_iter=30)``, ``DenseBackend`` and
  ``ChainArrowBackend``;
- ``batch_fixture_qcqp_chain_arrow_*``: the same trials as QCQP,
  ``ChainArrowBackend``;
- ``batch_mc8_socp_chain_arrow_*``: trials of seeds 0-7 of the Monte-Carlo
  bench world (``BATCH_MC_WORLD``, ``bench.py:330-394``: 4 x 50 poses),
  SOCP, ``max_iter=20``, no Gondzio correctors, ``ChainArrowBackend``;
- ``batch_nocones_socp_dense_*``: three trials of a world with no range
  (``BATCH_NOCONES``: no cone), SOCP, ``max_iter=10``, ``DenseBackend``
  (the JAX package's batch runs its IPM on them: a stacked problem's
  ``num_cones`` is the trial count).

    JAX_PLATFORMS=cpu python tests/torch_reference_data.py --sharded

rewrites only the ``sharded_*`` entries: the JAX package's sharded solves on
an 8-device CPU mesh (the mode sets ``--xla_force_host_platform_device_count
=8`` before jax starts), f64, read by ``tests/test_torch_parallel.py``:

- ``sharded_chain_{chain20,chain3}_*``: ``score_tpu.parallel.intra.
  solve_conic_chain_sharded`` of the SOCP relaxation of the worlds of
  ``SHARDED_CHAIN_WORLDS`` (``tests/test_parallel.py:93-134``, 20 x 12
  poses, seed 3, C = 20 padded to 24; and ``:346-387``, 3 x 8 poses, seed
  9, C = 3 padded to 8), ``IPMParams(max_iter=40)``: status, iterations,
  pobj, gap, x;
- ``sharded_batch_{dense,chain_arrow}_*``: ``score_tpu.parallel.batch.
  solve_conic_sharded`` of ``BATCH_FIXTURE``'s 8 trials (seeds 0-7) as
  SOCP over the mesh, ``IPMParams(max_iter=30)``, ``DenseBackend`` and
  ``ChainArrowBackend``: each lane's status, iterations, pobj and gap.

    JAX_PLATFORMS=cpu python tests/torch_reference_data.py --band-stability

writes nothing: the f64 band's backward error along the iterates of five
worlds (the 2 x 10 fixture's trial 0 as it is and normalized, the
Monte-Carlo world's trial 0, Manhattan-4 and robot20) at each remainder
length of ``STABILITY_FLOORS``, beside the JAX package's CPU band and a
dense Cholesky, then the fixture's trials solved by both packages at each
remainder: why the port's band compacts to one block
(``band.CR_BASE_LENGTH`` = 1).

    JAX_PLATFORMS=cpu python tests/torch_reference_data.py --refine-roundoff

writes nothing: on the two outlier worlds of ``tests/test_torch_refine.py``
and each robust kernel it prints how far the JAX package's own refinement
moves under a 1e-15 relative move of its start (at the default 60 CG
trips), and how far the port's is from the JAX package's at 8, 15 and 60
trips: why the parity test bounds ``cg_iters`` there.
"""

from pathlib import Path

import numpy as np

PATH = Path(__file__).resolve().parent / "data" / "torch_reference.npz"

# the 3D world of tests/test_torch_3d.py, and the loop closure A3 -> A25
# (translation, translation and rotation precisions) its loop world adds
WORLD_3D = dict(num_robots=2, num_poses_per_robot=30, num_landmarks=4,
                range_measure_prob=0.4, seed=3)
LOOP_3D = ("A3", "A25", (1.0, -2.0, 0.5), 100.0, 1000.0)
# the 4-robot 3D world of 100 poses a robot (the 3D bench's settings) whose
# QCQP both packages end OPTIMAL_INACCURATE, on a dual-residual floor
WORLD_3D_4X100 = dict(num_robots=4, num_poses_per_robot=100, num_landmarks=6,
                      range_measure_prob=0.4, seed=3)
# the 2D parity world of tests/test_torch_api.py and tests/test_torch_api_surface.py
WORLD_2X25 = dict(num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
                  range_measure_prob=0.4, seed=1)
# a 3 x 40 Manhattan world whose odometry warm start both packages end by
# the stall detector (tests/test_torch_api_surface.py)
WORLD_3X40 = dict(num_robots=3, num_poses_per_robot=40, num_landmarks=4, seed=0)
# the f32 checks' world of tests/test_torch_api.py
WORLD_4X50 = dict(num_robots=4, num_poses_per_robot=50, num_landmarks=4, grid_size=12,
                  range_measure_prob=0.4, seed=3)


# the CLI checks' cases: the input graph (``cli_graph``), its format, and
# the flags after it; each case also writes every export it names
CLI_CASES = {
    # the Huber refinement moves this graph in both packages (the plain one
    # stops after three rejected first steps in the JAX package)
    "full": (dict(loop=False), ".pickle",
             ["--relaxation", "SOCP", "--max-iter", "30", "--refine", "--robust", "huber",
              "--robust-delta", "2.0", "--ate", "--tum", "{out}/out.tum",
              "--save", "{out}/res.pkl", "--g2o-out", "{out}/g.g2o"]),
    "g2o": (dict(loop=True, prior=False), ".g2o",
            ["--relaxation", "QCQP", "--max-iter", "30", "--ate"]),
    "unsolved": (dict(loop=False), ".pickle", ["--relaxation", "SOCP", "--max-iter", "1"]),
}


# the Monte-Carlo batch's checks: tests/test_parallel.py's fixture world,
# the Monte-Carlo bench world (bench.py:330-394), a world with no range,
# and the 3D loop world (WORLD_3D with LOOP_3D: 2 x 30 poses, seed 3),
# whose trials redraw only the ranges (resample_ranges)
BATCH_FIXTURE = dict(num_robots=2, num_poses_per_robot=10, num_landmarks=2, grid_size=6,
                     range_measure_prob=0.5, seed=11)
BATCH_MC_WORLD = dict(num_robots=4, num_poses_per_robot=50, num_landmarks=4, grid_size=10,
                      range_measure_prob=0.4, seed=0)
BATCH_NOCONES = dict(num_robots=2, num_poses_per_robot=6, num_landmarks=1, grid_size=6,
                     range_measure_prob=0.0, inter_robot_ranges=False, seed=11)
BATCH_LOOP_3D = "loop3d"
# case: (world, trial seeds, relaxation, backend, ScoreSolverParams fields
# of its IPMParams (``batch_params``), precision of the stacked problems)
BATCH_CASES = {
    "fixture_socp_dense": (BATCH_FIXTURE, range(8), "SOCP", "dense", dict(max_iter=30), "f64"),
    "fixture_socp_chain_arrow": (BATCH_FIXTURE, range(8), "SOCP", "chain_arrow",
                                 dict(max_iter=30), "f64"),
    "fixture_qcqp_chain_arrow": (BATCH_FIXTURE, range(8), "QCQP", "chain_arrow",
                                 dict(max_iter=30), "f64"),
    "mc8_socp_chain_arrow": (BATCH_MC_WORLD, range(8), "SOCP", "chain_arrow",
                             dict(max_iter=20, gondzio_correctors=0), "f64"),
    "nocones_socp_dense": (BATCH_NOCONES, range(3), "SOCP", "dense", dict(max_iter=10), "f64"),
    "loop3d_socp_chain_arrow": (BATCH_LOOP_3D, range(4), "SOCP", "chain_arrow",
                                dict(max_iter=30), "f64"),
    "loop3d_qcqp_chain_arrow": (BATCH_LOOP_3D, range(4), "QCQP", "chain_arrow",
                                dict(max_iter=30), "f64"),
    # the f32 batch: the problems cast to float32 after assembly and the
    # f32 mode's tolerances (precision="f32"), as solve_score's f32 solves
    "fixture_socp_chain_arrow_f32": (BATCH_FIXTURE, range(8), "SOCP", "chain_arrow",
                                     dict(max_iter=30), "f32"),
    "mc4_socp_chain_arrow_f32": (BATCH_MC_WORLD, range(4), "SOCP", "chain_arrow",
                                 dict(max_iter=20, gondzio_correctors=0), "f32"),
    "loop3d_socp_chain_arrow_f32": (BATCH_LOOP_3D, range(4), "SOCP", "chain_arrow",
                                    dict(max_iter=30), "f32"),
}
BATCH_FIELDS = ("status", "iterations", "pobj", "gap", "pres", "dres", "x")

# the chain-sharded solves' worlds (tests/test_parallel.py:93-134 and
# :346-387), SOCP, IPMParams(max_iter=40)
SHARDED_CHAIN_WORLDS = {
    "chain20": dict(num_robots=20, num_poses_per_robot=12, num_landmarks=4, grid_size=10,
                    range_measure_prob=0.35, inter_robot_measure_prob=0.1,
                    inter_robot_sensing_radius=10.0, seed=3),
    "chain3": dict(num_robots=3, num_poses_per_robot=8, num_landmarks=2, grid_size=6,
                   range_measure_prob=0.5, seed=9),
}
SHARDED_CHAIN_ITERS = 40
SHARDED_CHAIN_FIELDS = ("status", "iterations", "pobj", "gap", "x")
# the trial-sharded batch: BATCH_FIXTURE's 8 trials, SOCP, max_iter=30
SHARDED_BATCH_ITERS = 30
SHARDED_BATCH_FIELDS = ("status", "iterations", "pobj", "gap")


def batch_trials(case: str, simulate, resample):
    """The trials of a batch case (the JAX package's FactorGraphData for a
    3D case; the 2D cases from a package's Manhattan simulator and
    ``resample_measurements``, either package's: both draw the same)."""
    world, seeds = BATCH_CASES[case][:2]
    if world == BATCH_LOOP_3D:
        base = world_3d(loop=True)
        return [resample_ranges(base, seed=s) for s in seeds]
    base = simulate(world)
    return [resample(base, seed=s) for s in seeds]


def batch_params(case: str, solver_params):
    """A case's IPMParams from a package's ScoreSolverParams class."""
    _, _, _, _, fields, precision = BATCH_CASES[case]
    return solver_params(precision=precision, **fields).ipm_params()


def resample_ranges(fg, seed: int):
    """A trial of a graph's structure for a batch: a copy whose range
    measurements are redrawn around the ground truth (the true distance
    plus a normal of the range's stddev, at least 1e-3, from a numpy
    generator of ``seed``, in the graph's order), every association,
    odometry measurement, loop closure and prior kept. Either package's
    FactorGraphData (the JAX package has no 3D resampler; its 2D one draws
    the ranges this way after the odometry)."""
    import copy

    out = copy.deepcopy(fg)
    rng = np.random.default_rng(seed)
    where = {v.name: np.asarray(v.true_position, dtype=np.float64)
             for chain in out.pose_variables for v in chain}
    where.update({v.name: np.asarray(v.true_position, dtype=np.float64)
                  for v in out.landmark_variables})
    for m in out.range_measurements:
        a, b = m.association
        d_true = np.linalg.norm(where[a] - where[b])
        m.dist = float(max(d_true + rng.normal(0.0, m.stddev), 1e-3))
    return out


def cli_graph(**kw):
    """The small 2D graph of ``tests/test_cli.py`` (6 poses, 2 landmarks,
    13 ranges), as the JAX package's FactorGraphData."""
    from tests.test_assembly import small_graph

    return small_graph(np.random.default_rng(3), **kw)


def cli_argv(case: str, graph_path: str, out_dir: str):
    """The command line of a CLI case, exports written under ``out_dir``."""
    flags = CLI_CASES[case][2]
    return [graph_path] + [f.format(out=out_dir) for f in flags]


def write_cli_graph(case: str, out_dir: str) -> str:
    """Write a case's input graph with the JAX package's writers (a pickle
    or a g2o file) and return its path."""
    import os

    from score_tpu.fg.io import save_to_g2o_file, save_to_pickle_file

    kw, suffix, _ = CLI_CASES[case]
    path = os.path.join(out_dir, "graph" + suffix)
    (save_to_g2o_file if suffix == ".g2o" else save_to_pickle_file)(cli_graph(**kw), path)
    return path


def world_3d(loop: bool = False):
    """The 3D world as the JAX package's FactorGraphData; with ``loop``,
    plus the loop closure, which its odometry does not agree with."""
    from score_tpu.fg.measurements import PoseMeasurement3D
    from score_tpu.sim.world3d import World3DParams, simulate_3d_world

    fg = simulate_3d_world(World3DParams(**WORLD_3D))
    if loop:
        a, b, t, tp, rp = LOOP_3D
        fg.loop_closure_measurements.append(
            PoseMeasurement3D(a, b, np.array(t), np.eye(3), tp, rp, 0.0))
    return fg


def graph_2x25():
    from score_tpu.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

    return simulate_manhattan_world(ManhattanWorldParams(**WORLD_2X25))


def graph_3x40():
    from score_tpu.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

    return simulate_manhattan_world(ManhattanWorldParams(**WORLD_3X40))


def graph_4x50():
    from score_tpu.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

    return simulate_manhattan_world(ManhattanWorldParams(**WORLD_4X50))


def load() -> dict:
    with np.load(PATH) as data:
        return {k: data[k] for k in data.files}


def main() -> None:
    from score_tpu import solve_score
    from score_tpu.assembly.conic import build_conic_problem
    from score_tpu.assembly.normalize import normalize_factor_graph
    from score_tpu.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu.solver.ipm import solve_conic
    from score_tpu.solver.params import ScoreSolverParams

    out = {}
    rp, ridx = build_conic_problem(normalize_factor_graph(world_3d(loop=True))[0], "QCQP")
    res = solve_conic(rp, ScoreSolverParams(precision="f64").ipm_params(),
                      backend=ChainArrowBackend, backend_aux=build_chain_arrow(rp, ridx))
    for name in ("status", "iterations", "pobj", "gap", "x"):
        out[f"loop3d_qcqp_{name}"] = np.asarray(getattr(res, name))
    ref64 = solve_score(graph_4x50(), "SOCP", ScoreSolverParams(precision="f64"))
    out["f32_4x50_socp_f64_objective"] = np.asarray(ref64.primal_objective)
    for key, graph, relaxation in (("loop3d_f32_socp", world_3d(loop=True), "SOCP"),
                                   ("loop3d_f32_qcqp", world_3d(loop=True), "QCQP"),
                                   ("plain3d_f32_socp", world_3d(), "SOCP")):
        r = solve_score(graph, relaxation, ScoreSolverParams(precision="f32"))
        for name, value in (("solved", r.solved), ("iterations", r.iterations),
                            ("pobj", r.primal_objective), ("gap", r.gap)):
            out[f"{key}_{name}"] = np.asarray(value)
    from score_tpu.sim.world3d import World3DParams, simulate_3d_world

    fg = simulate_3d_world(World3DParams(**WORLD_3D_4X100))
    rp, ridx = build_conic_problem(normalize_factor_graph(fg)[0], "QCQP")
    res = solve_conic(rp, ScoreSolverParams(precision="f64").ipm_params(),
                      backend=ChainArrowBackend, backend_aux=build_chain_arrow(rp, ridx))
    for name in ("status", "iterations", "pobj", "gap", "dres"):
        out[f"qcqp3d_4x100_{name}"] = np.asarray(getattr(res, name))
    out.update(api_entries())
    out.update(cli_entries())
    out.update(batch_entries())
    out.update(trace_entries())
    out.update(sharded_entries())
    PATH.parent.mkdir(exist_ok=True)
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: " + ", ".join(f"{k} {v.shape}" for k, v in out.items()))


def api_entries() -> dict:
    from score_tpu import solve_score
    from score_tpu.api import solve_problem_with_intermediate_iterates
    from score_tpu.solver.params import ScoreSolverParams

    out = {}
    g = graph_2x25()
    for relaxation in ("SOCP", "QCQP"):
        for key, extra in (("dense", dict(backend="dense")), ("odom", dict(init_technique="odom"))):
            r = solve_score(g, relaxation, ScoreSolverParams(precision="f64", **extra))
            for name, value in (("solved", r.solved), ("iterations", r.iterations),
                                ("pobj", r.primal_objective), ("gap", r.gap)):
                out[f"api_{key}_{relaxation.lower()}_{name}"] = np.asarray(value)
    r = solve_score(graph_3x40(), "SOCP", ScoreSolverParams(precision="f64",
                                                             init_technique="odom"))
    for name, value in (("solved", r.solved), ("iterations", r.iterations),
                        ("pobj", r.primal_objective), ("gap", r.gap)):
        out[f"api_odom_3x40_socp_{name}"] = np.asarray(value)
    for backend in ("dense", "chain_arrow"):
        snaps = solve_problem_with_intermediate_iterates(
            g, "SOCP", ScoreSolverParams(precision="f64", backend=backend))
        out[f"api_iterates_{backend}_socp"] = np.array(
            [[s.primal_residual, s.dual_residual, s.gap, s.primal_objective] for s in snaps])
    return out


def cli_entries() -> dict:
    import contextlib
    import io
    import tempfile

    from score_tpu.__main__ import main as cli_main

    out = {}
    for case in CLI_CASES:
        with tempfile.TemporaryDirectory() as tmp:
            argv = cli_argv(case, write_cli_graph(case, tmp), tmp)
            stdout = io.StringIO()
            with contextlib.redirect_stdout(stdout):
                rc = cli_main(argv)
        out[f"cli_{case}_rc"] = np.asarray(rc)
        # the export paths as the flags name them, with no temporary directory
        line = stdout.getvalue().strip().splitlines()[-1].replace(tmp, "{out}")
        out[f"cli_{case}_summary"] = np.asarray(line)
    return out


def batch_entries() -> dict:
    import jax.numpy as jnp

    from score_tpu.api import _cast_problem
    from score_tpu.assembly.conic import build_conic_problem
    from score_tpu.parallel.batch import solve_conic_batch, stack_problems
    from score_tpu.sim.manhattan import (
        ManhattanWorldParams,
        resample_measurements,
        simulate_manhattan_world,
    )
    from score_tpu.solver.backend import DenseBackend
    from score_tpu.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu.solver.params import ScoreSolverParams

    out = {}
    for case, (_, _, relaxation, backend, _, precision) in BATCH_CASES.items():
        trials = batch_trials(case, lambda w: simulate_manhattan_world(ManhattanWorldParams(**w)),
                              resample_measurements)
        problems = [build_conic_problem(t, relaxation)[0] for t in trials]
        if precision == "f32":
            problems = [_cast_problem(p, jnp.float32) for p in problems]
        if backend == "dense":
            be, aux = DenseBackend, None
        else:
            be = ChainArrowBackend
            aux = build_chain_arrow(problems[0], build_conic_problem(trials[0], relaxation)[1])
        params = batch_params(case, ScoreSolverParams)
        res = solve_conic_batch(stack_problems(problems), params, backend=be, backend_aux=aux)
        for name in BATCH_FIELDS:
            out[f"batch_{case}_{name}"] = np.asarray(getattr(res, name))
        out[f"batch_{case}_trips"] = np.asarray(
            min(params.max_iter, int(np.max(np.asarray(res.iterations))) + 1))
        print(case, out[f"batch_{case}_status"].tolist(),
              out[f"batch_{case}_iterations"].tolist(), flush=True)
    return out


# the solve trace's checks (tests/test_torch_trace.py): case -> (graph,
# relaxation, backend, trips); every graph normalized, f64, the default
# IPMParams
TRACE_CASES = {
    "2x25_socp_dense": ("2x25", "SOCP", "dense", 16),
    "2x25_socp_chain_arrow": ("2x25", "SOCP", "chain_arrow", 16),
    "loop3d_qcqp_dense": ("loop3d", "QCQP", "dense", 8),
    "loop3d_qcqp_chain_arrow": ("loop3d", "QCQP", "chain_arrow", 8),
}
TRACE_FIELDS = ("metrics", "status", "iterations", "pobj")


def trace_graph(name: str):
    """A trace case's graph, as the JAX package's FactorGraphData."""
    return graph_2x25() if name == "2x25" else world_3d(loop=True)


def trace_entries() -> dict:
    from score_tpu.assembly.conic import build_conic_problem
    from score_tpu.assembly.normalize import normalize_factor_graph
    from score_tpu.solver.backend import DenseBackend
    from score_tpu.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu.solver.ipm import solve_conic_traced
    from score_tpu.solver.params import ScoreSolverParams

    out = {}
    for case, (graph, relaxation, backend, trips) in TRACE_CASES.items():
        rp, ridx = build_conic_problem(normalize_factor_graph(trace_graph(graph))[0], relaxation)
        be, aux = ((DenseBackend, None) if backend == "dense"
                   else (ChainArrowBackend, build_chain_arrow(rp, ridx)))
        res, metrics = solve_conic_traced(rp, ScoreSolverParams(precision="f64").ipm_params(),
                                          num_iters=trips, backend=be, backend_aux=aux)
        out[f"trace_{case}_metrics"] = np.asarray(metrics)
        for name in TRACE_FIELDS[1:]:
            out[f"trace_{case}_{name}"] = np.asarray(getattr(res, name))
        print(case, int(res.status), int(res.iterations), flush=True)
    return out


def eight_cpu_devices() -> None:
    """Give jax, before it starts, the 8-device CPU mesh of the tests
    (``tests/conftest.py``), which the sharded entries run on."""
    import os

    os.environ["XLA_FLAGS"] = " ".join(
        [f for f in os.environ.get("XLA_FLAGS", "").split()
         if "xla_force_host_platform_device_count" not in f]
        + ["--xla_force_host_platform_device_count=8"])


def sharded_entries() -> dict:
    import jax

    from score_tpu.assembly.conic import build_conic_problem
    from score_tpu.parallel.batch import default_mesh, solve_conic_sharded, stack_problems
    from score_tpu.parallel.intra import solve_conic_chain_sharded
    from score_tpu.sim.manhattan import (
        ManhattanWorldParams,
        resample_measurements,
        simulate_manhattan_world,
    )
    from score_tpu.solver.backend import DenseBackend
    from score_tpu.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu.solver.ipm import IPMParams

    assert len(jax.devices()) == 8, "the sharded entries need the 8-device CPU mesh"
    out = {}
    for case, world in SHARDED_CHAIN_WORLDS.items():
        fg = simulate_manhattan_world(ManhattanWorldParams(**world))
        problem, idx = build_conic_problem(fg, "SOCP")
        res = solve_conic_chain_sharded(problem, idx, params=IPMParams(
            max_iter=SHARDED_CHAIN_ITERS))
        for name in SHARDED_CHAIN_FIELDS:
            out[f"sharded_chain_{case}_{name}"] = np.asarray(getattr(res, name))
        print(case, int(res.status), int(res.iterations), float(res.pobj), flush=True)
    base = simulate_manhattan_world(ManhattanWorldParams(**BATCH_FIXTURE))
    trials = [resample_measurements(base, seed=s) for s in range(8)]
    problems = [build_conic_problem(t, "SOCP")[0] for t in trials]
    aux = build_chain_arrow(problems[0], build_conic_problem(trials[0], "SOCP")[1])
    for backend, be, be_aux in (("dense", DenseBackend, None),
                                ("chain_arrow", ChainArrowBackend, aux)):
        res = solve_conic_sharded(stack_problems(problems), default_mesh(),
                                  IPMParams(max_iter=SHARDED_BATCH_ITERS), backend=be,
                                  backend_aux=be_aux)
        for name in SHARDED_BATCH_FIELDS:
            out[f"sharded_batch_{backend}_{name}"] = np.asarray(getattr(res, name))
        print(backend, np.asarray(res.status).tolist(), np.asarray(res.iterations).tolist(),
              flush=True)
    return out


def update_entries(prefix: str, entries) -> None:
    """Rewrite the file with fresh ``<prefix>*`` entries and the others
    kept."""
    out = {k: v for k, v in load().items() if not k.startswith(prefix)}
    out.update(entries())
    np.savez_compressed(PATH, **out)
    print(f"wrote {PATH}: " + ", ".join(
        f"{k} {out[k].tolist() if out[k].size <= 8 else out[k].shape}"
        for k in out if k.startswith(prefix)))


def refine_roundoff() -> None:
    import copy

    import torch

    from score_tpu.refine import RefineParams, refine_solution
    from score_tpu_torch import RefineParams as PortParams
    from score_tpu_torch import refine_solution as port_refine_solution
    from tests.test_torch_refine import _world

    torch.set_num_threads(1)
    for name in ("sim9_outlier", "outliers_2x20"):
        ref_fg, fg, start = _world(name)
        moved = copy.deepcopy(start.variables)
        for T in moved.poses.values():
            T[:, -1] *= 1.0 + 1e-15
        for kind in ("none", "huber", "gm"):
            a = refine_solution(ref_fg, start.variables, RefineParams(robust=kind))
            b = refine_solution(ref_fg, moved, RefineParams(robust=kind))
            line = (f"{name} {kind}: JAX package, start moved by 1e-15: iterations "
                    f"{a.iterations} -> {b.iterations}, cost {abs(b.cost - a.cost) / a.cost:.1e}")
            for trips in (8, 15, 60):
                ref = refine_solution(ref_fg, start.variables,
                                      RefineParams(robust=kind, cg_iters=trips))
                port = port_refine_solution(fg, start.variables,
                                            PortParams(robust=kind, cg_iters=trips), device="cpu")
                line += (f"; port vs JAX at {trips} trips: iterations {port.iterations} / "
                         f"{ref.iterations}, cost {abs(port.cost - ref.cost) / ref.cost:.1e}")
            print(line, flush=True)


# the remainder lengths --band-stability prices: the band compacts while a
# chain is longer than this, then runs parallel cyclic reduction
STABILITY_FLOORS = (1, 2, 4, 8, 16, 64, 256)


def _stability_worlds():
    """(label, JAX FactorGraphData, normalize, IPMParams fields, iterates
    backend) of each world ``--band-stability`` reads."""
    from score_tpu.sim.manhattan import (
        ManhattanWorldParams,
        resample_measurements,
        simulate_manhattan_world,
    )

    def sim(w):
        return simulate_manhattan_world(ManhattanWorldParams(**w))

    fixture = batch_trials("fixture_socp_chain_arrow", sim, resample_measurements)[0]
    mc = batch_trials("mc8_socp_chain_arrow", sim, resample_measurements)[0]
    robot20 = dict(num_robots=20, num_poses_per_robot=100, num_landmarks=10, grid_size=30,
                   range_measure_prob=0.25, inter_robot_measure_prob=0.05, seed=20)
    return [
        ("fixture 2x10 trial 0", fixture, False, dict(max_iter=30), "dense"),
        ("fixture 2x10 trial 0, normalized", fixture, True, dict(max_iter=30), "dense"),
        ("MC 4x50 trial 0", mc, False, dict(max_iter=20, gondzio_correctors=0), "dense"),
        ("Manhattan-4", sim({}), True, {}, "chain_arrow"),
        ("robot20", sim(robot20), True, {}, "chain_arrow"),
    ]


def recorded_bands(pp, st, params, iterates="dense"):
    """(result, bands): the port's SOCP solve of the problem ``pp`` (a CPU
    ConicProblem of the port, ``st`` its chain+arrow structure) on its
    dense backend, or with ``iterates="chain_arrow"`` on its chain+arrow
    backend with the band compacted to one block, and the f64 chain band
    (D, U), each (C, Tp, Db, Db) in the band convention, that the
    chain+arrow backend assembles at every factor of that solve's
    iterates."""
    import torch

    from score_tpu_torch.ops import band
    from score_tpu_torch.solver import chain_arrow as port_ca
    from score_tpu_torch.solver.backend import DenseBackend
    from score_tpu_torch.solver.ipm import solve_conic

    backend = DenseBackend if iterates == "dense" else port_ca.ChainArrowBackend
    seen = []
    factor = backend.factor

    def recording(problem, state, Winv2, p):
        seen.append(Winv2)
        return factor(problem, state, Winv2, p)

    backend.factor = staticmethod(recording)
    default, band.CR_BASE_LENGTH = band.CR_BASE_LENGTH, 1
    try:
        res = solve_conic(pp, params, backend=backend,
                          backend_aux=None if iterates == "dense" else st)
    finally:
        backend.factor = staticmethod(factor)
        band.CR_BASE_LENGTH = default
    ops = port_ca.ChainArrowBackend.prepare(pp, st)
    C, T, D = st.C, st.T, st.D
    Tp = band.pad_length(T)
    bands = []
    for W in seen:
        Dg, Ug = port_ca.ChainArrowBackend._assemble(pp, ops, W, params)[:2]
        Dp = torch.eye(D, dtype=torch.float64).expand(C, Tp, D, D).clone()
        Dp[:, :T] = Dg
        Up = torch.zeros((C, Tp, D, D), dtype=torch.float64)
        Up[:, : T - 1] = Ug
        bands.append((Dp, Up))
    return res, bands


def band_stability() -> None:
    """Why the band compacts to one block: the f64 band's backward error,
    max |T x - b| / max |b| of one random rhs of 3 columns, along the
    iterates of an SOCP solve of each world of :func:`_stability_worlds`,
    for each remainder length of ``STABILITY_FLOORS`` (``band.CR_BASE_LENGTH``:
    cyclic reduction while a chain is longer, then parallel cyclic
    reduction with explicit block inverses), beside the JAX package's CPU
    band (``score_tpu.solver.pcr``: cyclic reduction to one block, a
    Cholesky a block) and a dense Cholesky solve of each chain. The iterates
    are the port's: its dense backend's on the small worlds, its chain+arrow
    backend's compacted to one block on Manhattan-4 and robot20 (a dense
    KKT of either is too large for a CPU run). Then the 2 x 10 fixture's
    trials solved by the JAX package and by the port at the default
    schedule and at every remainder length. Writes nothing."""
    import jax
    import jax.numpy as jnp
    import torch

    from score_tpu.assembly.conic import build_conic_problem
    from score_tpu.assembly.normalize import normalize_factor_graph
    from score_tpu.sim.manhattan import (
        ManhattanWorldParams,
        resample_measurements,
        simulate_manhattan_world,
    )
    from score_tpu.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu.solver.ipm import IPMParams, solve_conic
    from score_tpu.solver.pcr import pcr_factor, pcr_solve
    from score_tpu_torch.convert import problem_from_reference
    from score_tpu_torch.ops import band
    from score_tpu_torch.solver import chain_arrow as port_ca
    from score_tpu_torch.solver.ipm import IPMParams as PortParams
    from score_tpu_torch.solver.ipm import solve_conic as port_solve

    torch.set_num_threads(1)
    default = band.CR_BASE_LENGTH
    jax_factor, jax_solve = jax.jit(jax.vmap(pcr_factor)), jax.jit(jax.vmap(pcr_solve))
    names = [f"{f}" for f in STABILITY_FLOORS] + ["JAX", "dense"]
    for label, fg, normalize, fields, iterates in _stability_worlds():
        if normalize:
            fg = normalize_factor_graph(fg)[0]
        rp, ridx = build_conic_problem(fg, "SOCP")
        pp = problem_from_reference(rp, device="cpu")
        params = PortParams(**fields)
        st = port_ca.build_chain_arrow(pp, ridx)
        res, bands = recorded_bands(pp, st, params, iterates)
        C, Tp, D = bands[0][0].shape[:3]
        print(f"{label}: C = {C}, T = {st.T}, Tp = {Tp}, {len(bands)} factors of a "
              f"{iterates} solve (status {res.status} after {res.iterations})", flush=True)
        rng = np.random.default_rng(0)
        worst = dict.fromkeys(names, 0.0)
        for it, (Dp, Up) in enumerate(bands):
            b = torch.tensor(rng.standard_normal((C, Tp, D, 3)))

            def resid(x):
                return ((band.band_matvec(Dp, Up, x) - b).abs().max() / b.abs().max()).item()

            out = {}
            for floor in STABILITY_FLOORS:
                band.CR_BASE_LENGTH = floor
                out[f"{floor}"] = resid(band.band_solve(band.band_factor(Dp, Up), b))
            band.CR_BASE_LENGTH = default
            f = jax_factor(jnp.asarray(Dp.numpy()), jnp.asarray(Up.numpy()))
            out["JAX"] = resid(torch.tensor(np.asarray(jax_solve(f, jnp.asarray(b.numpy())))))
            Tm = torch.zeros((C, Tp * D, Tp * D), dtype=torch.float64)
            for k in range(Tp):
                Tm[:, k * D:(k + 1) * D, k * D:(k + 1) * D] = Dp[:, k]
                if k + 1 < Tp:
                    Tm[:, k * D:(k + 1) * D, (k + 1) * D:(k + 2) * D] = Up[:, k]
                    Tm[:, (k + 1) * D:(k + 2) * D, k * D:(k + 1) * D] = Up[:, k].mT
            out["dense"] = resid(torch.cholesky_solve(
                b.reshape(C, Tp * D, 3), torch.linalg.cholesky(Tm)).reshape(b.shape))
            cond = "-"  # an eigensolve of Manhattan-4's chains takes minutes
            if Tp * D <= 1024:
                ev = torch.linalg.eigvalsh(Tm)
                cond = f"{(ev[:, -1] / ev[:, 0]).max().item():.1e}"
            for k in names:
                worst[k] = max(worst[k], out[k])
            print(f"  iterate {it}: band condition {cond}; residual by remainder "
                  + ", ".join(f"{k} {out[k]:.1e}" for k in names), flush=True)
        print(f"{label}, max over iterates: "
              + ", ".join(f"{k} {worst[k]:.1e}" for k in names), flush=True)

    case = "fixture_socp_chain_arrow"
    trials = batch_trials(case, lambda w: simulate_manhattan_world(ManhattanWorldParams(**w)),
                          resample_measurements)
    for i, t in enumerate(trials):
        rp, ridx = build_conic_problem(t, "SOCP")
        ref = solve_conic(rp, IPMParams(max_iter=30), backend=ChainArrowBackend,
                          backend_aux=build_chain_arrow(rp, ridx))
        pp = problem_from_reference(rp, device="cpu")
        line = (f"fixture trial {i}: JAX package status {int(ref.status)} after "
                f"{int(ref.iterations)}; port by remainder")
        for floor in STABILITY_FLOORS:
            band.CR_BASE_LENGTH = floor
            r = port_solve(pp, PortParams(max_iter=30),
                           backend_aux=port_ca.build_chain_arrow(pp, ridx))
            line += f" {floor}: {r.status} after {r.iterations},"
        band.CR_BASE_LENGTH = default
        print(line.rstrip(","), flush=True)


def qcqp3d_sizes(poses=(30, 60, 100)) -> None:
    import torch

    from score_tpu.assembly.conic import build_conic_problem
    from score_tpu.assembly.normalize import normalize_factor_graph
    from score_tpu.sim.world3d import World3DParams, simulate_3d_world
    from score_tpu.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu.solver.ipm import solve_conic
    from score_tpu.solver.params import ScoreSolverParams
    from score_tpu_torch import ScoreSolverParams as PortParams
    from score_tpu_torch.convert import problem_from_reference
    from score_tpu_torch.solver.chain_arrow import build_chain_arrow as port_build_chain_arrow
    from score_tpu_torch.solver.ipm import solve_conic as port_solve_conic

    torch.set_num_threads(1)
    for P in poses:
        fg = simulate_3d_world(World3DParams(num_robots=4, num_poses_per_robot=P,
                                             num_landmarks=6, range_measure_prob=0.4, seed=3))
        rp, ridx = build_conic_problem(normalize_factor_graph(fg)[0], "QCQP")
        ref = solve_conic(rp, ScoreSolverParams(precision="f64").ipm_params(),
                          backend=ChainArrowBackend, backend_aux=build_chain_arrow(rp, ridx))
        pp = problem_from_reference(rp, device="cpu")
        port = port_solve_conic(pp, PortParams().ipm_params(),
                                backend_aux=port_build_chain_arrow(pp, ridx))
        print(f"3D 4x{P} QCQP, {fg.num_range_measurements} ranges: JAX package status "
              f"{int(ref.status)} after {int(ref.iterations)} iterations, dres "
              f"{float(ref.dres):.3e}; port status {port.status} after {port.iterations}, "
              f"dres {float(port.dres):.3e}", flush=True)


if __name__ == "__main__":
    import sys

    if "--qcqp3d-sizes" in sys.argv[1:]:
        qcqp3d_sizes()
    elif "--cli" in sys.argv[1:]:
        update_entries("cli_", cli_entries)
    elif "--batch" in sys.argv[1:]:
        update_entries("batch_", batch_entries)
    elif "--trace" in sys.argv[1:]:
        update_entries("trace_", trace_entries)
    elif "--sharded" in sys.argv[1:]:
        eight_cpu_devices()
        update_entries("sharded_", sharded_entries)
    elif "--band-stability" in sys.argv[1:]:
        band_stability()
    elif "--refine-roundoff" in sys.argv[1:]:
        refine_roundoff()
    else:
        eight_cpu_devices()
        main()
