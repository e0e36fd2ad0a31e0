#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``score_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result line:

1. require a CUDA device; print the card's name and power limit;
2. build both kernel libraries (``score_tpu_torch/ops/csrc/band.cu``, the
   f64 band kernels, and ``csrc/blocks.cu``, the f32 block kernels) with
   one nvcc each, started together; print the build times, ptxas'
   register and spill lines, and one line each with the registers and
   spill bytes of every band kernel at each block size (Db = 6 and 12;
   the fused CR kernels ``cr_reduce_levels_kernel``,
   ``cr_backsub_levels_kernel`` and, at Db = 12, ``cr_backsub_element_kernel``,
   and a one-level solve's ``cr_backsub_narrow_kernel`` and, at Db = 6,
   ``cr_backsub_wide_kernel``, for runs that end at more than one position
   a chain, and the chain kernels ``cr_reduce_tree_kernel`` and
   ``cr_backsub_chain_kernel`` (``cr_backsub_lanes_kernel`` for K <= 4) for
   runs that end at one; ``block_inv_kernel`` and
   ``cr_level_kernel`` at Db = 6, and at Db = 12 the element kernels
   ``block_inv_element_kernel``, ``cr_level_element_kernel`` and
   ``pcr_level_element_kernel``, a thread per block element),
   of ``block_chol`` and of both block kernels at the 3D sizes D = 12
   (``chol_lanes_kernel``, a lane group a block; ``tri_solve_tile_kernel``
   and ``tri_solve_lanes_kernel``, the solve's two layouts) and D = 3 (a
   spill fails the run);
3. every band kernel of the default schedule (the band compacts to one
   block a chain: ``band_init_a``, the factor's levels, in
   ``band_cr_factor``'s runs at Db = 6 (``band._factor_runs``; rows
   ``band_cr_factor`` and, for the last of two, ``band_cr_factor[tail]``;
   built for Db = 6 only) and a ``band_cr_level`` launch a level (3
   positions a thread block on levels of 1,024 positions and more:
   ``band._cr_level_tile``) and ``band_block_inv`` at Db = 12,
   ``band_cr_reduce``, ``band_pcr_solve`` on the remainder's one block,
   ``band_cr_backsub``; ``band_cr_level`` and ``band_block_inv`` are
   checked at both block sizes, and each cell prints a ``<cell> factor:``
   line: the factor as ``band_factor`` runs it and in the parent's design
   (a ``band_cr_level`` launch a level, at Db = 12 a position a thread
   block), device us of each, launches of each counted by the wrappers
   over one eager call (the path's held to ``band.factor_launches``), and
   the bound; ``factor_*`` and ``parent_*`` keys of the row of the kernel
   that takes the levels) against its plain PyTorch version on the card, at
   the band shapes of the four instances below (Manhattan-4: C = 4 chains
   padded to Tp = 512, 9 compacting levels; robot20: C = 20, Tp = 128, 7;
   Db = 6; 3D 4x250: C = 4, Tp = 256, 8, and 3D 1x1000: C = 1, Tp = 1024,
   10, Db = 12; rhs K = 1 and K = the instance's arrow width), of the
   Monte-Carlo batches' folds (``mc``: C = 400, Tp = 64, Db = 6, K = 56;
   ``mc3d``: C = 64, Tp = 256, Db = 12, K = 18) and, for
   ``band_pcr_level``, which no solve launches since, at the shapes of the
   earlier remainder of 256 blocks (``EARLIER_BASE``: Manhattan-4, 3D
   1x1000 and the ``mc`` fold), at every level of a factor and two solves,
   each call fed the previous
   level's kernel outputs: the max relative difference
   (max |kernel - plain| / max |plain|) must be <= 1e-12 and the band
   residual <= 1e-10; median times of both at each kernel's first call
   (CUDA events around the wrapper, after warm-up) and the kernel's
   device time (a CUDA graph of 20 launches replayed between events), for
   the three solve kernels (``band_cr_reduce``, ``band_pcr_solve``,
   ``band_cr_backsub``) at K = 1 beside the panel; ``band_cr_reduce`` and
   ``band_cr_backsub`` run a solve's compacting levels in runs of at most
   10 (``band._cr_runs``), so every cell's pass is one run, one launch each
   way; then a band-solve pass at every cell (``phase_pass``), K = 1 and
   the panel: both kernels against their twins, device us, bound and
   launches a pass (one each way), beside the same pass in runs of at most
   8 levels under the old routing (this package's kernels), the ``pass_*``
   keys of the two kernels' rows; the f32 block kernels at the f32 batch's fold
   (``mc-f32``: M = 12,800 blocks of 6 x 6, K = 56, 6, 1); then every band kernel
   at edge shapes of both block sizes: ``band_pcr_level`` and
   ``band_pcr_solve`` at one and two blocks per chain, one chain and rhs
   widths off the column tiles (3D: Tp = 1, 2, 4, 32, 256 and 512 at C = 1
   and 4, K = 1, 2, 12, 17, 18, 19 and 138, which takes several column
   chunks of the cluster kernel), ``band_cr_level`` at chain lengths that
   put a thread block's edge inside a chain, on a chain's first position
   and past the last (3D: coarse lengths 1, 2, 3, 5, 15, 256, 512 and
   1024 at C = 1, 4, 20), ``band_block_inv`` at block counts off its
   thread blocks (3D: 1, 2, 3 and the 256, 512 and 1024 blocks of the 3D
   remainders), ``band_init_a``; the two fused CR kernels at 1 to 4 levels,
   C = 1, 4, 20, coarsest lengths 1, 2, 64, 256 and K = 1, 2, 4, 5, 17,
   18, 19, 138 (and 258 at Db = 6), one launch each a call, and band
   solves of a Db = 6 chain with two and three compacting levels, then PCR
   (C = 1, Tp = 1024 and 2048); a chain of 2,048 compacted 11 times (the
   compaction floor at 1; a fused CR launch takes 10 levels) at both block
   sizes, against a dense solve (<= 1e-11), in two runs, the launches
   ``band.cr_solve_launches`` counts; then each block kernel against its plain version in f32 at
   the shapes of the f32 path (max relative difference <= 1e-5, and
   reconstruction residuals ||L L^T - A|| / ||A||, ||L Y - B|| / ||B||,
   ||L L^T X - B|| / ||B|| <= 1e-5), with its time, its plain version's and
   a library call's (events around the call, and its device time as the
   kernel's: in a replayed graph, or back to back between events where the
   call cannot be captured), at the 2D shapes and, in rows of their own, at the
   3D ones (D = 12: M = 512 at K = 18, 12, 1 and the roots; D = 3: the
   2348 and 2363 pivots), ``block_chol`` also at D = 2, 3, 6, 12 and M = 1
   to 2363 on contiguous and strided blocks, and its device time at every
   Cholesky of a Manhattan-4 and a 3D 4x250 f32 factor; the D = 12 kernels
   at M = 1, 2, 3, 4, 31, 32, 33, 511, 512, 513 and 2363, on the same three
   layouts, ``block_chol_solve`` at K = 1, 2, 12, 17, 18, 19 and 24 on each
   factor (both sides of the edge between its two D = 12 layouts); one
   launch for two right-hand sides (a transposed view and a stepped one,
   as a factor level's W2 and W1) bit-equal to the two single-rhs launches
   at D = 6 and 12, and a level's two solves timed as that one launch and
   as two, at Manhattan-4's and 3D 4x250's first level; the launch floor
   (``launch_floor_us``: a one-element ``add_`` in the same graph
   harness); the f32 band
   (cyclic reduction over the block kernels) against the f64 band at
   Manhattan-4's and 3D 4x250's band shapes (<= 1e-4), the factor taking
   one ``block_chol_solve`` launch a level, for both of its solves; then a
   small 2D
   instance and a small 3D instance (2 x 30 poses, SOCP and QCQP) solved
   on the card against the port's plain CPU path, and the f32 mode on the
   3D one with a loop closure, SOCP and QCQP, on the card against the
   port's f32 CPU path (solved, iterations within 3, objectives within
   2e-2) and within 1e-2 of the f64 objective, through the block kernels
   at D = 12 and, for QCQP, D = 3;
4. Manhattan-4 (4 robots x 400 poses, 6 landmarks, inter-robot ranges,
   seed 0) solved as SOCP on the card: solved status, relative gap <=
   1e-6, det(R) = +1 for every rounded pose, and every band kernel of its
   path (all but ``band_pcr_level``, ``band_cr_level`` and
   ``band_block_inv``; at Db = 12 all but ``band_pcr_level`` and
   ``band_cr_factor``) launched during the solve;
5. the same for the 20-robot world (20 x 100 poses, 10 landmarks, seed 20),
   whose arrow panel runs K in the hundreds;
6. Manhattan-4 as QCQP in f64: the same checks; then the 3D instances of
   the JAX package's bench (``bench.py:296``, ``:311``): 3D 4x250 (4 robots
   x 250 poses, 6 landmarks, seed 3) as SOCP and QCQP and 3D 1x1000 (one
   chain of 1000 poses) as SOCP, in f64: solved, relative gap <= 1e-6,
   det(R) = +1 on the 3 x 3 rotations, and every band kernel of the path
   launched at Db = 12 (the 1x1000 QCQP is left out for time); every f64
   solve launches ``band_cr_reduce`` and ``band_cr_backsub`` as many times
   as its band solves' passes take (``band.cr_solve_launches`` of each
   pass, recorded by ``_BandSolves``) and ``band_pcr_solve`` once a pass;
7. the f32 fast mode (``precision="f32"``) on Manhattan-4, SOCP and QCQP,
   cold and warm: solved, relative gap <= 1e-2 (the mode's reduced
   tolerance), objective within 1e-2 relative of the f64 solve of the same
   relaxation, det(R) = +1 within 1e-5, ``block_chol`` and the fused
   ``block_chol_solve`` launched (for QCQP also at D = 2, the distance
   pivots), the factors' level solves as two-rhs launches, and neither the
   forward-only ``block_tri_lower_solve`` nor a
   plain back substitution on f32 tensors of the card; then the f32 mode
   on the 3D bench worlds, 3D 4x250 as SOCP and QCQP and 3D 1x1000 as
   SOCP, each beside the port's f32 CPU runs of the same world at 1, 2, 4
   and 8 torch threads (their objectives are f32 roundoff around a ~0
   optimum, and the relative gap's max(1, |objective|) makes their
   iteration counts follow it): the same solved status, iterations within
   3 of the CPU runs' range (or more, where the card escaped a stall the
   CPU runs stopped in, at a relative gap below all of theirs), det(R) =
   +1 within 1e-5, the block kernels launched at D = 12 (and D = 3 for
   QCQP) and neither the forward-only kernel nor a plain back
   substitution; the SOCPs solved with relgap <= 1e-2 (the 4x250 QCQP
   ends unsolved in both packages); their objectives sit near 0 and are
   printed beside the f64 ones;
8. a 4 x 50 world in f32 on the card against the port's f32 CPU path:
   both solved, iterations within 3, objectives within 2e-2;
9. the solve API around the kernels (``api``), on the card: (a) the
   assembly memo: Manhattan-4 and 3D 1x1000 as f64 SOCP solved twice each
   with one graph object (a copy, so that the first solve assembles): the
   first runs one ``build_conic_problem`` and one ``backend.prepare``, the
   second neither (counted by wrappers in this script), both repeat the
   earlier phase's digits exactly; both walls and the hand-written
   kernels' launches of each call are printed; (b) Manhattan-4 through
   ``save_to_pickle_file`` and ``parse_pickle_file`` in a temporary
   directory solves to (a)'s digits; (c) ``backend="dense"`` on
   Manhattan-4 f64 SOCP (a dense K of n x n): solved, relgap <= 1e-6,
   iterations within 1 of the chain+arrow solve, objectives within the two
   final gaps plus 1e-9 relative; its wall and
   ``torch.cuda.max_memory_allocated``; (d) ``init_technique="odom"`` on
   Manhattan-4 and 3D 4x250 f64 SOCP, iterations beside the cold start's,
   held to the port's CPU run of the same start (the same solved status,
   iterations within 1; solved at relgap <= 1e-6 where solved: the JAX
   package's stall detector ends a 2D odometry start of 3 x 40 poses and
   more unsolved after 5 iterations, and the port keeps that); (e)
   ``solve_problem_with_intermediate_iterates`` on the 2 x 25 world: one
   snapshot per iteration and a last one equal to ``solve_score``'s result;
   then the solve trace (``trace``, :func:`phase_trace`): Manhattan-4 f64
   SOCP on ``ChainArrowBackend`` and the 2 x 25 world on ``DenseBackend``
   through ``solve_conic_traced``: 13 finite columns, the converged row the
   result's metrics, the untraced solve's digits, host synchronizations
   <= the untraced solve's + 1, the card's trace against the CPU's;
10. the refinement stage (``refine``) on Manhattan-4 and 3D 4x250 in f64:
   ``solve_score(fg, "SOCP", ScoreSolverParams(refine=True))`` with the
   kernel counts set to 0 just before it (every band kernel of the solve's
   path launched; the solve's digits those of the plain solve and of the
   earlier phase), then ``refine_solution`` of the plain solve's rounded
   values: initial and final cost (the final one also evaluated on the
   host), iterations, the refinement's wall, host synchronizations counted
   through ``torch.cuda.set_sync_debug_mode``, launches per refinement
   (profiled refinements of 1, 2 and 3 outer iterations in 2D, 1 and 2
   in 3D, each the largest count of profiled runs until two agree,
   extrapolated),
   rotations in SO(d) to 1e-9, the 3D final cost below the initial one,
   and the card against the port's CPU refinement of the same start at
   ``max_iter=10`` (equal iterations, costs within 1e-8 relative);
11. the Monte-Carlo batch (``mc_batch``, ``score_tpu_torch.parallel``):
   16 resamples of the JAX package's bench world (``bench.py:330-394``: 4
   x 50 poses, SOCP, ``max_iter=20``, no Gondzio correctors,
   ``ChainArrowBackend``) on the card against the port's CPU batch of the
   same trials (the same status, iterations within 1, pobj within 1e-9
   relative, trips within 1); the 100-trial batch with the band kernels'
   counts set to 0 just before it (its band folded to C = 400 chains of
   Tp = 64, compacted to one block: every band kernel but
   ``band_pcr_level`` launched), every lane solved at relgap <=
   1e-6, lanes 0-2 within 1e-6 of the card's single solves, the trips, the
   cold wall and five warm walls with ms per trial, each band kernel's
   launches per trip at each state of the batch's two shared gates equal
   to a 1-trial batch's, host synchronizations of one batch solve <= trips
   + ``MC_SYNC_CONSTANT``; then 8 trials on ``DenseBackend``, card against
   CPU as above, with the card's peak memory; and in phase 3 the band
   kernels at the fold's shape (C = 400, Tp = 64, K = 56 and 1) against
   their plain twins; then the f32 batch (``mc_batch f32``: the 100 trials
   cast to float32 at the f32 mode's tolerances, the f32 band's block
   kernels folded likewise) and the 3D batch (``mc_batch 3d``: 16 trials
   of 3D 4x250 with redrawn ranges, each normalized, f64, the fold C = 64,
   Tp = 256, Db = 12) (:func:`phase_mc_batch`): a small batch card
   against CPU, every lane solved (relgap <= 1e-2 in f32, 1e-6 in 3D),
   lanes 0-2 held to the card's single solves, walls, launches per trip
   equal to a 1-trial batch's, host synchronizations <= trips + 1;
12. the sharded solves (``sharded``, :func:`phase_sharded`,
   ``score_tpu_torch.parallel``): robot20 SOCP f64 (normalized; C = 20)
   chain-sharded (``solve_conic_chain_sharded``) and the 100-trial
   Monte-Carlo batch (``ChainArrowBackend``) trial-sharded
   (``solve_conic_sharded``), over gloo at world 2 with both ranks on the
   one card (10 chains, 50 trials a rank) and over NCCL at world = the
   card count (``run_ranks``), each beside the unsharded solve on the
   card: robot20 with the same status and iterations, relgap <= 1e-6 and
   pobj within 1e-9 relative, the batch with every lane's status and
   iterations, pobj within 1e-9 relative (``SHARDED_LANE_TOL``) and the
   same trips, and rank 0's lanes against the same trials solved unsharded
   as a batch of the rank's size, pobj within 1e-12 relative
   (``SHARDED_RANK_LANE_TOL``); every band
   kernel of the path launched on every rank (counts set to 0 just before
   the timed call); ``all_reduce`` calls and bytes of one factor (the
   Schur complement), one KKT solve (the arrow rhs and the chain
   solution) and one trip (the four flags) as counted; the walls;
13. the launch floor again, and one JSON line describing the kernels
   (event time, device time, plain time, the bound from bytes and
   operations, and a PyTorch call computing the same function where one
   exists, by events and in device time, ``library_us``): a row per kernel at
   the 2D shapes; for the band kernels but ``band_cr_factor`` a row
   ``<name>[Db=12]`` at 3D 1x1000's shapes with its launches per 3D 1x1000
   SOCP solve; ``band_cr_factor[tail]`` at the last run of Manhattan-4's
   factor, with that run's launches per solve (``launches_by_run``; the CR
   rhs kernels take a pass in one run on every cell); for the block kernels rows ``<name>[D=12]`` and
   ``<name>[D=3]`` at 3D 4x250's shapes with their launches per 3D 4x250
   f32 QCQP solve; rows ``<name>[mc]`` at the Monte-Carlo fold's
   shapes with their launches per 100-trial batch solve, ``<name>[mc3d]``
   at the 3D batch's fold with their launches per 16-trial 3D batch solve
   and ``<name>[mc-f32]`` at the f32 batch's first level with their
   launches per 100-trial f32 batch solve; the ``band_pcr_level`` rows
   (2D, ``[Db=12]``, ``[mc]``) are timed at the earlier remainder's shapes,
   with 0 launches and a ``note`` saying why; then the result line.

``python3 chip_smoke.py --kernels`` stops after the band and block
kernels' checks of phase 3 (a short first run after a kernel changed) and
prints no result line; ``--refine`` builds the kernels and runs phase 10
alone, ``--mc`` the three folds' kernel checks and phase 11 alone,
``--sharded`` phase 12 alone, and none of them prints a result line. Imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np

REL_TOL = 1e-12  # band kernels vs plain PyTorch, both f64 on the card
# block kernels vs plain PyTorch in f32: nvcc contracts multiply-adds into
# FMAs, the plain versions round every PyTorch op separately
REL_TOL_F32 = 1e-5
BAND_SOURCE = "score_tpu_torch/ops/csrc/band.cu"
BLOCKS_SOURCE = "score_tpu_torch/ops/csrc/blocks.cu"
REPLACES = {
    "band_init_a": "score_tpu/ops/pallas_pcr.py:428",
    "band_pcr_level": "score_tpu/ops/pallas_pcr.py:312",
    "band_block_inv": "score_tpu/ops/pallas_pcr.py:423",
    "band_pcr_solve": "score_tpu/ops/pallas_pcr.py:433",
    "band_cr_level": "score_tpu/ops/pallas_pcr.py:362",
    "band_cr_factor": "score_tpu/ops/pallas_pcr.py:362",
    "band_cr_reduce": "score_tpu/ops/pallas_pcr.py:385",
    "band_cr_backsub": "score_tpu/ops/pallas_pcr.py:405",
    "block_chol": "score_tpu/ops/pallas_blocks.py:36",
    "block_tri_lower_solve": "score_tpu/ops/pallas_blocks.py:79",
    "block_chol_solve": "score_tpu/ops/pallas_blocks.py:79",
}
# torch thread counts of the CPU runs an f32 3D card solve is held to
CPU_THREADS = (1, 2, 4, 8)
# H100 SXM data sheet: HBM3 bandwidth, and the FP64 and FP32 peaks outside
# the tensor cores (the band kernels run f64, the block kernels f32)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}


def _log(*a):
    print(*a, flush=True)


def _time_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_us(fn, launches=20, replays=5):
    """Device time of one call of ``fn`` in microseconds, without the
    wrapper's host time: ``launches`` calls are captured into one CUDA
    graph, the graph is replayed between two events, and the median replay
    is divided by ``launches``. Kernels inside a graph run back to back,
    so the time holds a launch's device-side latency but no Python."""
    import torch

    fn()  # builds, and sets function attributes, outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) * 1e3 / launches


def _library_us(fn, launches=20, replays=5):
    """(device us of one call, how it was timed) for a PyTorch library
    call: "graph" as :func:`_device_us`; "back to back" where the call
    cannot be captured into a CUDA graph, ``launches`` calls enqueued back
    to back between two events (the host's enqueue time can then show)."""
    import torch

    try:
        return _device_us(fn, launches, replays), "graph"
    except RuntimeError:
        torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times) * 1e3 / launches, "back to back"


def _launch_floor_us(device):
    """Device time of a one-element PyTorch op in :func:`_device_us`'s
    harness: what a launch costs inside a replayed graph, whatever it does."""
    import torch

    one = torch.zeros(1, dtype=torch.float64, device=device)
    return _device_us(lambda: one.add_(1))


def _random_band(C, Tp, Db, seed, device):
    """Random SPD block-tridiagonal band (D, U) in the band convention."""
    import torch

    rng = np.random.default_rng(seed)
    M = rng.standard_normal((C, Tp, Db, Db))
    D = M @ np.swapaxes(M, -1, -2) + (2.0 + 4.0 * Db) * np.eye(Db)
    U = 0.3 * rng.standard_normal((C, Tp, Db, Db))
    U[:, -1] = 0.0
    f = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    return f(D), f(U)


def _compare(name, kernel_out, plain_out, tol=REL_TOL):
    """(max abs err, max relative err) over paired outputs; raises above
    ``tol``."""
    import torch

    if isinstance(kernel_out, torch.Tensor):
        kernel_out, plain_out = (kernel_out,), (plain_out,)
    abs_err, rel_err = 0.0, 0.0
    for k, p in zip(kernel_out, plain_out):
        if k.shape != p.shape or not torch.isfinite(k).all():
            raise AssertionError(f"{name}: bad kernel output {tuple(k.shape)}")
        e = (k - p).abs().max().item()
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / max(p.abs().max().item(), 1e-300))
    if not rel_err <= tol:
        raise AssertionError(f"{name}: max relative difference {rel_err:.3e} > {tol}")
    return abs_err, rel_err


def _cells():
    """The two solve instances: (label, factor graph)."""
    from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

    return [
        ("manhattan4", simulate_manhattan_world(ManhattanWorldParams())),
        ("robot20", simulate_manhattan_world(ManhattanWorldParams(
            num_robots=20, num_poses_per_robot=100, num_landmarks=10, grid_size=30,
            range_measure_prob=0.25, inter_robot_measure_prob=0.05, seed=20,
        ))),
    ]


def _cells_3d():
    """The 3D instances of the JAX package's bench (``bench.py:296`` and
    ``:311``): (label, factor graph)."""
    from score_tpu_torch.sim.world3d import World3DParams, simulate_3d_world

    return [
        ("3d-4x250", simulate_3d_world(World3DParams(
            num_robots=4, num_poses_per_robot=250, num_landmarks=6,
            range_measure_prob=0.4, seed=3))),
        ("3d-1x1000", simulate_3d_world(World3DParams(
            num_robots=1, num_poses_per_robot=1000, num_landmarks=6,
            range_measure_prob=0.4, seed=3))),
    ]


def _band_shape(fg):
    """(chains, padded chain length, arrow width, block size) of the
    instance's band."""
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.assembly.normalize import normalize_factor_graph
    from score_tpu_torch.ops.band import pad_length
    from score_tpu_torch.solver.chain_arrow import build_chain_arrow

    problem, idx = build_conic_problem(normalize_factor_graph(fg)[0], "SOCP", device="cpu")
    st = build_chain_arrow(problem, idx)
    return st.C, pad_length(st.T), st.A, st.D


# ------------------------------------------------------------------ #
# Work of one kernel call: bytes it must move (each input read once, each
# output written once) and the floating-point operations its inputs need.
# n is the block size, K the rhs columns.
# ------------------------------------------------------------------ #


def _chol_flops(n):
    """Left-looking Cholesky of one n x n block: the multiply-subtracts,
    divisions and square roots."""
    return sum(2 * j * (n - j) + (n - j) + 1 for j in range(n))


def _inv_flops(n):
    """SPD inverse: Cholesky, then two triangular solves with n columns."""
    return _chol_flops(n) + 2 * n ** 3


def _band_cost(name, *args):
    """(bytes, flops) of one f64 band kernel call on these arguments."""
    f8 = 8
    if name == "band_init_a":
        (U,) = args
        return 2 * U.numel() * f8, 0
    if name == "band_block_inv":
        (D,) = args
        n = D.shape[-1]
        return 2 * D.numel() * f8, D.numel() // n ** 2 * _inv_flops(n)
    if name == "band_pcr_level":
        D = args[0]
        n = D.shape[-1]
        # reads D, A, C, invD; writes E, F, D', A', C', invD'. One inverse per
        # position, E, F, two products into D', A', C', two adds
        return 10 * D.numel() * f8, D.numel() // n ** 2 * (_inv_flops(n) + 12 * n ** 3 + 2 * n * n)
    if name == "band_cr_level":
        D = args[0]
        n = D.shape[-1]
        rows = D.numel() // n ** 2 // 2  # kept rows; one odd-row inverse each
        return (3 * D.numel() + 4 * D.numel()) * f8, rows * (_inv_flops(n) + 12 * n ** 3 + 2 * n * n)
    if name == "band_cr_factor":
        # one launch for n levels: D, A, C read once; every level's E, F,
        # invD, A, C written once, then the last level's band or, where it
        # has one block a chain, that block's inverse; an inverse and the
        # products of every kept row (and the last inverse)
        D, _, _, levels, last = args
        n, pos = D.shape[-1], D.numel() // D.shape[-1] ** 2
        kept = sum(pos >> lev for lev in range(1, levels + 1))
        tail = pos >> levels
        return ((3 * pos + 5 * kept + (1 if last else 3) * tail) * n * n * f8,
                kept * (_inv_flops(n) + 12 * n ** 3 + 2 * n * n) + (tail * _inv_flops(n) if last
                                                                     else 0))
    if name == "band_cr_reduce":
        # one launch for every level: each level's E and F read once, the
        # fine rhs read once, each level's reduced rhs written once
        levels, b = args
        n, K = b.shape[-2], b.shape[-1]
        blocks = sum(lv.E.numel() + lv.F.numel() for lv in levels)
        rows = sum(lv.E.numel() // n ** 2 for lv in levels)
        return ((blocks + b.numel() + rows * n * K) * f8, rows * (4 * n * n * K + 2 * n * K))
    if name == "band_pcr_solve":
        E, F, invD, b = args
        n, K = b.shape[-2], b.shape[-1]
        pos = invD.numel() // n ** 2
        L = E.shape[0]
        return ((E.numel() + F.numel() + invD.numel() + 2 * b.numel()) * f8,
                L * pos * (4 * n * n * K + 2 * n * K) + pos * 2 * n * n * K)
    if name == "band_cr_backsub":
        # one launch for every level: each level's invD, A and C read once,
        # the odd rows of each level's fine rhs, the coarsest solution, and
        # the finest solution written once
        levels, fine, xe = args
        n, K = xe.shape[-2], xe.shape[-1]
        blocks = sum(3 * lv.invD.numel() for lv in levels)
        rows = sum(lv.invD.numel() // n ** 2 for lv in levels)
        return ((blocks + rows * n * K + xe.numel() + fine[0].numel()) * f8,
                rows * (6 * n * n * K + 2 * n * K))
    raise KeyError(name)


def _blocks_cost(name, *args):
    """(bytes, flops) of one f32 block kernel call on these arguments."""
    f4 = 4
    if name == "block_chol":
        (A,) = args
        n = A.shape[-1]
        return 2 * A.numel() * f4, A.shape[0] * _chol_flops(n)
    L, B = args
    n, K = B.shape[-2], B.shape[-1]
    # a rhs broadcast over the blocks (the pivots' identity) is read once
    b_in = B[0].numel() if B.stride(0) == 0 else B.numel()
    if name == "block_tri_lower_solve":
        return (L.numel() + b_in + B.numel()) * f4, B.shape[0] * K * n * n
    if name == "block_chol_solve":  # forward, then back substitution
        return (L.numel() + b_in + B.numel()) * f4, B.shape[0] * K * 2 * n * n
    raise KeyError(name)


def _bound(nbytes, flops, precision):
    """(bound ms, what bounds it): the larger of bytes over the HBM rate and
    operations over the peak rate of the precision."""
    t_mem = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[precision]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


class _KernelCheck:
    """Running max error of each kernel against its plain twin, and, at the
    first call of each kernel, the kernel, plain and library times by
    events around the call (wrapper included), the kernel's device time
    (:func:`_device_us`) and the bound from the call's bytes and
    operations."""

    def __init__(self, tol=REL_TOL, precision="f64"):
        self.rows = {}
        self.tol = tol
        self.precision = precision

    def __call__(self, name, kern, plain, cost, library=None):
        out = kern()
        abs_err, rel_err = _compare(name, out, plain(), self.tol)
        row = self.rows.get(name)
        if row is None:
            ms, plain_ms, device_us = _time_ms(kern), _time_ms(plain), _device_us(kern)
            library_ms = library_us = library_timing = None
            if library is not None:
                library_ms = _time_ms(library)
                library_us, library_timing = _library_us(library)
            bound_ms, bound_by = _bound(*cost, self.precision)
            row = self.rows[name] = dict(max_abs_err=0.0, max_rel=0.0, calls=0,
                                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                         library_us=library_us,
                                         library_timing=library_timing,
                                         device_us=device_us,
                                         bound_ms=bound_ms, bound_by=bound_by,
                                         bytes=cost[0], flops=cost[1])
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        row["max_rel"] = max(row["max_rel"], rel_err)
        row["calls"] += 1
        return out


def _band_residual(D, U, x, b):
    """max |T x - b| / max |b| for the block-tridiagonal T of (D, U)."""
    from score_tpu_torch.ops.band import band_matvec

    return ((band_matvec(D, U, x) - b).abs().max() / b.abs().max()).item()


def phase_kernels(label, C, Tp, K, Db, device, n_cr=None):
    """Phase 3 for one cell's band shape: every kernel of its band at the
    default schedule (or ``n_cr`` compacting levels) against its plain
    version, at every level of a factor and of two solves (K = 1 and the
    cell's arrow width K), each call fed the kernels' outputs of the level
    before, as the main path feeds them; the fused CR kernels in a solve's
    runs of levels (``band._cr_runs``)."""
    import torch
    from score_tpu_torch.ops import band

    D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
    chk = _KernelCheck()
    n_cr = band.cr_depth(Tp) if n_cr is None else n_cr
    A = chk("band_init_a", lambda: band.band_init_a(U), lambda: band.band_init_a_plain(U),
            _band_cost("band_init_a", U))
    # a band_cr_level launch a level and band_block_inv (the 3D factor's
    # path; at Db = 6 the parent's design, kept for band_cr_level's callers
    # and for levels that stop above one block a chain): held to their twins
    # at the cell's shapes
    Dl, Al, Cl, by_level = D, A, U, []
    for _ in range(n_cr):
        args = (Dl, Al, Cl)
        out = chk("band_cr_level", lambda: band.band_cr_level(*args),
                  lambda: band.band_cr_level_plain(*args), _band_cost("band_cr_level", *args))
        by_level.append(band.CRLevel(*out[:5]))
        Dl, Al, Cl = out[5:]
    Dn = Dl
    inv_n = chk("band_block_inv", lambda: band.band_block_inv(Dn),
                lambda: band.band_block_inv_plain(Dn), _band_cost("band_block_inv", Dn),
                library=lambda: torch.linalg.inv_ex(Dn))
    # the factor's runs where band_cr_factor takes it (Db = 6), a launch
    # each (band._factor_runs), each fed the kernel's outputs of the run
    # before; at Db = 12 the band_cr_level levels above are the factor's
    fruns = band._factor_runs(Tp, Db, n_cr) if band._factor_takes(Db) else []
    levels, invD = by_level, inv_n
    if fruns:
        Dl, Al, Cl, T, levels, invD = D, A, U, Tp, [], None
    for i, n in enumerate(fruns):
        args = (Dl, Al, Cl, n, T >> n == 1)
        name = "band_cr_factor[tail]" if i and i == len(fruns) - 1 else "band_cr_factor"
        out = chk(name, lambda: _run_tensors(band.band_cr_factor(*args)),
                  lambda: _run_tensors(band.band_cr_factor_plain(*args)),
                  _band_cost("band_cr_factor", *args))
        levels += [band.CRLevel(*out[5 * lev:5 * lev + 5]) for lev in range(n)]
        T >>= n
        if T == 1:
            invD = out[-1]
        else:
            Dl, Al, Cl = out[-3:]
    factor_row = _factor_row(label, D, A, U, n_cr, chk.rows) if n_cr else {}
    Es, Fs = [], []
    if invD is None:  # band_cr_factor's levels stop above one block a chain
        invD = chk("band_block_inv", lambda: band.band_block_inv(Dl),
                   lambda: band.band_block_inv_plain(Dl), _band_cost("band_block_inv", Dl),
                   library=lambda: torch.linalg.inv_ex(Dl))
    for lev in range(band.num_levels(Tp >> n_cr)):
        args = (Dl, Al, Cl, invD, 1 << lev)
        E, F, Dl, Al, Cl, invD = chk("band_pcr_level", lambda: band.band_pcr_level(*args),
                                     lambda: band.band_pcr_level_plain(*args),
                                     _band_cost("band_pcr_level", *args))
        Es.append(E)
        Fs.append(F)
    if Es:
        E, F = torch.stack(Es), torch.stack(Fs)
    else:  # compacted to one block: the remainder's solve is x = invD b
        E = F = invD.new_zeros((0,) + tuple(invD.shape))
    runs = band._cr_runs(n_cr) if n_cr else []
    rng = np.random.default_rng(Tp)
    resid = {}

    def tail(name, end):
        """The row of a CR kernel's run: ``<name>[tail]`` for the last run of
        a solve of two or more, which ends at one position a chain."""
        return f"{name}[tail]" if len(runs) > 1 and end == n_cr else name

    def solve_chk(name, kern, plain, cost, library=None):
        """chk for the solve kernels; at K = 1, a direction's times beside
        the panel's on the kernel's row, at the kernel's first such call."""
        out = chk(name, kern, plain, cost, library)
        row = chk.rows[name]
        if k == 1 and "k1_ms" not in row:
            bound_ms, bound_by = _bound(*cost, "f64")
            row.update(k1_ms=_time_ms(kern), k1_device_us=_device_us(kern),
                       k1_plain_ms=_time_ms(plain), k1_bound_ms=bound_ms, k1_bound_by=bound_by)
        return out

    for k in (K, 1):  # the panel first: its times are the ones reported
        b0 = torch.tensor(rng.standard_normal((C, Tp, Db, k)), device=device)
        fine, first = (b0,), 0  # each level's fine rhs, then the remainder's
        for d in runs:  # the compacting levels in runs, one launch each way a run
            group, src = levels[first:first + d], fine[-1]
            fine += solve_chk(tail("band_cr_reduce", first + d),
                              lambda: band.band_cr_reduce(group, src),
                              lambda: band.band_cr_reduce_plain(group, src),
                              _band_cost("band_cr_reduce", group, src))
            first += d
        bb = fine[-1]
        # compacted to one block (no PCR level) the kernel computes x =
        # invD b, which one torch.matmul computes too
        x = solve_chk("band_pcr_solve", lambda: band.band_pcr_solve(E, F, invD, bb),
                      lambda: band.band_pcr_solve_plain(E, F, invD, bb),
                      _band_cost("band_pcr_solve", E, F, invD, bb),
                      library=None if Es else lambda: torch.matmul(invD, bb))
        for d in reversed(runs):
            first -= d
            group, rhs, xe = levels[first:first + d], fine[first:first + d], x
            x = solve_chk(tail("band_cr_backsub", first + d),
                          lambda: band.band_cr_backsub(group, rhs, xe),
                          lambda: band.band_cr_backsub_plain(group, rhs, xe),
                          _band_cost("band_cr_backsub", group, rhs, xe))
        resid[k] = _band_residual(D, U, x, b0)
        if not resid[k] <= 1e-10:
            raise AssertionError(f"{label}: band residual {resid[k]:.3e} at K={k}")
    _log(f"{label} band: C={C} Tp={Tp} Db={Db} CR levels={n_cr} (runs {runs}) panel K={K} "
         f"residual K={K} {resid[K]:.3e} K=1 {resid[1]:.3e}")
    _log_rows(label, chk.rows)
    for name in ("band_cr_reduce", "band_pcr_solve", "band_cr_backsub", "band_cr_reduce[tail]",
                 "band_cr_backsub[tail]"):
        if name not in chk.rows:
            continue
        r = chk.rows[name]
        _log(f"{label} kernel {name} at K=1: kernel_ms={r['k1_ms']:.4f} "
             f"device_us={r['k1_device_us']:.2f} plain_ms={r['k1_plain_ms']:.4f} "
             f"bound_ms={r['k1_bound_ms']:.6f} ({r['k1_bound_by']}); at the panel K={K}: "
             f"kernel_ms={r['ms']:.4f} device_us={r['device_us']:.2f}")
    missing = [k for k in _path_kernels(Tp, Db, n_cr) if k not in chk.rows]
    if missing:
        raise AssertionError(f"{label}: kernels not checked: {missing}")
    if n_cr:
        chk.rows["band_cr_factor" if fruns else "band_cr_level"].update(factor_row)
    return chk.rows


def _run_tensors(run):
    """A band_cr_factor run's tensors: every level's E, F, invD, A, C, then
    the band it leaves (D, A, C) or the last block's inverse."""
    tail = (run.invD,) if run.invD is not None else (run.D, run.A, run.C)
    return tuple(t for lv in run.levels for t in lv) + tail


def _factor_row(label, D, A, U, n_cr, rows):
    """A cell's factor (``band_init_a`` aside) on the same inputs two ways:
    the path's, as band_factor runs it (band._factor_takes: band_cr_factor's
    runs at Db = 6, whose last inverts the one block a chain; a
    band_cr_level launch a level at the planner's tiles and band_block_inv
    at Db = 12), and the parent's design (a band_cr_level launch a level and
    band_block_inv; at Db = 12 one coarse position a thread block). Each
    ends with band_block_inv where it leaves more than one block a chain.
    Device us of each (a replayed CUDA graph); launches of each, counted by
    the wrappers over one eager call with the band counters at 0 (the
    path's held to band.factor_launches); the bound (D, A, C read once,
    every level's E, F, invD, A, C and the last invD written once, over the
    HBM rate; the remainder's band too where the levels stop above one
    block). Logged, and returned as keys of the row of the kernel that
    takes the factor's levels."""
    import torch
    from score_tpu_torch.ops import band

    C, Tp, Db, _ = D.shape
    fused = band._factor_takes(Db)
    runs = band._factor_runs(Tp, Db, n_cr) if fused else []

    def by_runs():
        Dl, Al, Cl, T = D, A, U, Tp
        for n in runs:
            run = band.band_cr_factor(Dl, Al, Cl, n, T >> n == 1)
            Dl, Al, Cl, T = run.D, run.A, run.C, T >> n
        if T > 1:
            band.band_block_inv(Dl)

    def by_levels():
        Dl, Al, Cl = D, A, U
        for _ in range(n_cr):
            Dl, Al, Cl = band.band_cr_level(Dl, Al, Cl)[5:]
        band.band_block_inv(Dl)

    def one_position():  # band_cr_level as the parent tiled it at Db = 12
        plan = band._cr_level_tile
        band._cr_level_tile = lambda nC, Th, Db: 1
        try:
            by_levels()
        finally:
            band._cr_level_tile = plan

    def launched(fn):
        band.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return sum(k.launches for k in (band.band_cr_factor, band.band_cr_level,
                                        band.band_block_inv))

    path, parent = (by_runs, by_levels) if fused else (by_levels, one_position)
    kept = sum(C * (Tp >> lev) for lev in range(1, n_cr + 1))
    tail = C * (Tp >> n_cr)
    nbytes = (3 * C * Tp + 5 * kept + (tail if tail == C else 4 * tail)) * Db * Db * 8
    row = dict(factor_route="band_cr_factor" if fused else "band_cr_level",
               factor_runs=runs, factor_bound_us=nbytes / HBM_BYTES_PER_S * 1e6,
               factor_launches=launched(path), factor_device_us=_device_us(path),
               parent_launches=launched(parent), parent_device_us=_device_us(parent))
    want = band.factor_launches(Tp, Db, n_cr) - band.num_levels(Tp >> n_cr)
    if row["factor_launches"] != want or row["parent_launches"] != n_cr + 1:
        raise AssertionError(f"{label}: factor launches {row['factor_launches']} (planner: "
                             f"{want}), parent design {row['parent_launches']} (want "
                             f"{n_cr + 1})")
    err = max(r["max_rel"] for k, r in rows.items()
              if k.startswith("band_cr_factor" if fused else "band_cr_level"))
    _log(f"{label} factor: band_factor takes {row['factor_route']}"
         + (f" runs {runs}" if fused else " at the planner's tiles")
         + f": device_us={row['factor_device_us']:.2f} launches={row['factor_launches']}; "
         f"the parent's design (a band_cr_level launch a level"
         + ("" if fused else ", a position a thread block")
         + f"): device_us={row['parent_device_us']:.2f} launches={row['parent_launches']}; "
         f"bound_us={row['factor_bound_us']:.3f}; max_rel_diff={err:.3e}")
    return row


def _tail_run(Tp, Db, kernel="band_cr_reduce"):
    """``Db,T,levels`` of the last run of a band solve of chains of Tp
    (the launches_by_run key of its CR kernels), or of its factor for
    ``band_cr_factor``."""
    from score_tpu_torch.ops import band

    runs = (band._factor_runs(Tp, Db) if kernel == "band_cr_factor"
            else band._cr_runs(band.cr_depth(Tp)))
    return f"{Db},{Tp >> sum(runs[:-1])},{runs[-1]}"


def _log_rows(label, rows):
    for name, r in rows.items():
        lib = ("none" if r["library_ms"] is None else
               f"{r['library_ms']:.4f} library_us={r['library_us']:.2f} "
               f"({r['library_timing']})")
        _log(f"{label} kernel {name}: calls={r['calls']} max_rel_diff={r['max_rel']:.3e} "
             f"max_abs_err={r['max_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
             f"device_us={r['device_us']:.2f} "
             f"plain_ms={r['plain_ms']:.4f} library_ms={lib} bound_ms={r['bound_ms']:.6f} "
             f"({r['bound_by']}: {r['bytes']} bytes, {r['flops']} flops)")


# Edge shapes of phase_edge_shapes, per block size. PCR: (chains, length,
# rhs widths) with one and two blocks per chain, one chain, widths off the
# column tiles (K = 3, 139) and that meet their edges (4, 5, 8), and chains
# longer than the wide solve kernel takes; 3D: chains of 1, 2 and 4 (fewer
# positions than a cluster's 16 blocks) up to 512 at C = 1 and 4, widths
# 1, 2, 12, 17-19 (the panel 18) and 138 (two or more column chunks at
# Tp = 256 and 512: band._solve_cluster_plan).
# band_cr_level: (chains, fine length); a thread block holds 15 coarse
# positions at Db = 6, so fine lengths 2 and 4 start chains inside a
# thread block, 30 on its first position, 512 and 2048 cut chains at its
# edge; at Db = 12 it holds P positions (csrc/band.cu's kCrLevelPositions,
# 1 to 4 in the measurement builds): coarse lengths 1, 2 and 3, 5 and 15
# (no multiple of 2 to 4), chains that start inside a thread block (C = 4,
# 20) and 3D 1x1000's two levels (Th = 512, 256). band_block_inv: block
# counts off the thread blocks' 16 at Db = 6; at Db = 12 (a block a thread
# block) 1, 2, 3 and the 3D remainders' 256, 512 and 1024 blocks.
_EDGE = {
    6: dict(
        pcr=[(3, 1, (1, 3)), (2, 2, (1, 3, 139)), (1, 256, (1, 2, 4, 5, 139)),
             (4, 256, (3, 8, 139)), (20, 128, (3, 139)), (5, 32, (7,)), (2, 512, (1, 3, 9))],
        cr=[(1, 2), (4, 2), (20, 4), (4, 30), (1, 512), (4, 512), (20, 512), (1, 2048)],
        inv=(1, 7, 17, 1024, 2560),
    ),
    12: dict(
        pcr=[(C, Tp, (1, 2, 12, 17, 18, 19, 138)) for Tp in (1, 2, 4, 32, 256, 512)
             for C in (1, 4)] + [(3, 1, (3,)), (2, 2, (3,)), (4, 8, (3, 4, 5, 6, 7, 8, 9))],
        cr=[(1, 2), (4, 2), (20, 2), (1, 4), (20, 4), (1, 6), (4, 6), (20, 6), (1, 8),
            (4, 10), (4, 30), (20, 30), (1, 512), (4, 512), (1, 1024), (1, 2048)],
        inv=(1, 2, 3, 7, 9, 256, 512, 1000, 1024),
    ),
}


def phase_edge_shapes(Db, device):
    """Every band kernel against its plain version at the edge shapes of
    ``_EDGE[Db]``: ``band_pcr_level`` at every level and ``band_pcr_solve``,
    ``band_cr_level``, ``band_block_inv`` and ``band_init_a``."""
    import torch
    from score_tpu_torch.ops import band

    edge = _EDGE[Db]
    worst = 0.0
    rng = np.random.default_rng(5)
    for C, Tp, Ks in edge["pcr"]:
        D, U = _random_band(C, Tp, Db, seed=7 * Tp + C, device=device)
        A = band.band_init_a(U)
        worst = max(worst, _compare(f"band_init_a Db={Db} C={C} Tp={Tp}", A,
                                    band.band_init_a_plain(U))[1])
        Cl, invD = U, band.band_block_inv(D)
        Es, Fs = [], []
        for lev in range(band.num_levels(Tp)):
            args = (D, A, Cl, invD, 1 << lev)
            out = band.band_pcr_level(*args)
            worst = max(worst, _compare(f"band_pcr_level Db={Db} C={C} Tp={Tp} s={1 << lev}",
                                        out, band.band_pcr_level_plain(*args))[1])
            E, F, D, A, Cl, invD = out
            Es.append(E)
            Fs.append(F)
        E = torch.stack(Es) if Es else D.new_zeros((0, C, Tp, Db, Db))
        F = torch.stack(Fs) if Fs else E
        for K in Ks:
            b = torch.tensor(rng.standard_normal((C, Tp, Db, K)), device=device)
            worst = max(worst, _compare(f"band_pcr_solve Db={Db} C={C} Tp={Tp} K={K}",
                                        band.band_pcr_solve(E, F, invD, b),
                                        band.band_pcr_solve_plain(E, F, invD, b))[1])
    worst_cr = 0.0
    for C, T in edge["cr"]:
        D, U = _random_band(C, T, Db, seed=11 * T + C, device=device)
        args = (D, band.band_init_a(U), U)
        worst_cr = max(worst_cr, _compare(f"band_cr_level Db={Db} C={C} T={T}",
                                          band.band_cr_level(*args),
                                          band.band_cr_level_plain(*args))[1])
    worst_inv = 0.0
    for M in edge["inv"]:
        D, _ = _random_band(1, M, Db, seed=17 * M, device=device)
        worst_inv = max(worst_inv, _compare(f"band_block_inv Db={Db} M={M}",
                                            band.band_block_inv(D),
                                            band.band_block_inv_plain(D))[1])
    torch.cuda.synchronize()
    _log(f"edge shapes Db={Db}: band_init_a, band_pcr_level and band_pcr_solve "
         f"max_rel_diff={worst:.3e}, band_cr_level max_rel_diff={worst_cr:.3e}, band_block_inv "
         f"max_rel_diff={worst_inv:.3e} (bound {REL_TOL})")


# The fused CR kernels' edge shapes, both block sizes: 1 to 4 levels, C = 1,
# 4, 20 chains, coarsest lengths 1, 2, 64 and 256 (tiles that start on a
# chain's first position, fall inside it and end on its last; one position
# a chain), rhs widths on both sides of each step's edge (narrow K <= 4),
# odd and even (column pairs, 8-byte and 16-byte copies), 3D 1x1000's
# panel (18) and Manhattan-4's (138), and robot20's (258) at Db = 6.
_CR_EDGE = dict(levels=(1, 2, 3, 4), chains=(1, 4, 20), coarse=(1, 2, 64, 256),
                widths=(1, 2, 4, 5, 17, 18, 19, 138), widths6=(258,))


def _cr_levels(C, T, Db, n, gen, device):
    """n random compacting levels (fine -> coarse) of C chains of T, blocks
    of 0.2 N(0, 1) / sqrt(Db): the rhs stays of order one level to level."""
    import torch
    from score_tpu_torch.ops import band

    return tuple(band.CRLevel(*(0.2 / Db ** 0.5 * torch.randn(
        C, T >> (lev + 1), Db, Db, generator=gen, dtype=torch.float64, device=device)
        for _ in range(5))) for lev in range(n))


def phase_cr_levels(Db, device):
    """``band_cr_reduce`` and ``band_cr_backsub`` (every level in one
    launch) against their plain twins at ``_CR_EDGE``'s shapes (<= 1e-12,
    one launch each a call); a chain of 512 compacted 9 times, one level
    more than a launch takes (:func:`phase_past_a_launch`); then, at Db =
    6, solves of chains with two and three compacting levels (C = 1, Tp =
    1024 and 2048) through the whole band: residual <= 1e-10 and one launch
    of each CR kernel a solve."""
    import torch
    from score_tpu_torch.ops import band

    gen = torch.Generator(device=device).manual_seed(19 + Db)
    worst_r = worst_b = 0.0
    shapes = 0
    widths = _CR_EDGE["widths"] + (_CR_EDGE["widths6"] if Db == 6 else ())
    for n in _CR_EDGE["levels"]:
        for C in _CR_EDGE["chains"]:
            for Tn in _CR_EDGE["coarse"]:
                T = Tn << n
                levels = _cr_levels(C, T, Db, n, gen, device)
                for K in widths:
                    b = torch.randn(C, T, Db, K, generator=gen, dtype=torch.float64, device=device)
                    x = torch.randn(C, Tn, Db, K, generator=gen, dtype=torch.float64,
                                    device=device)
                    band.reset_launch_counts()
                    label = f"Db={Db} levels={n} C={C} coarse={Tn} K={K}"
                    want = band.band_cr_reduce_plain(levels, b)
                    worst_r = max(worst_r, _compare(f"band_cr_reduce {label}",
                                                    band.band_cr_reduce(levels, b), want)[1])
                    fine = (b,) + want[:-1]
                    worst_b = max(worst_b, _compare(
                        f"band_cr_backsub {label}", band.band_cr_backsub(levels, fine, x),
                        band.band_cr_backsub_plain(levels, fine, x))[1])
                    if not band.band_cr_reduce.launches == band.band_cr_backsub.launches == 1:
                        raise AssertionError(f"{label}: not one launch each")
                    shapes += 1
    torch.cuda.synchronize()
    _log(f"fused CR kernels Db={Db}: {shapes} shapes (levels 1-4, C = 1, 4, 20, coarse 1, 2, "
         f"64, 256, K = {widths}): band_cr_reduce max_rel_diff={worst_r:.3e}, band_cr_backsub "
         f"max_rel_diff={worst_b:.3e} (bound {REL_TOL}), one launch each a call")
    phase_past_a_launch(Db, device, gen)
    if Db != 6:
        return
    for Tp, n_cr in ((1024, 2), (2048, 3)):  # two and three compacting levels, then PCR
        D, U = _random_band(1, Tp, Db, seed=Tp + 3, device=device)
        f = band.band_factor(D, U, n_cr=n_cr)
        for K in (1, 138):
            b = torch.randn(1, Tp, Db, K, generator=gen, dtype=torch.float64, device=device)
            band.reset_launch_counts()
            x = band.band_solve(f, b)
            resid = _band_residual(D, U, x, b)
            launches = (band.band_cr_reduce.launches, band.band_cr_backsub.launches,
                        band.band_pcr_solve.launches)
            _log(f"Db=6 chain C=1 Tp={Tp} ({len(f.levels)} CR levels) K={K}: residual "
                 f"{resid:.3e}, launches reduce/backsub/pcr_solve {launches}")
            if not (resid <= 1e-10 and launches == (1, 1, 1)):
                raise AssertionError(f"Db=6 Tp={Tp} K={K}: residual {resid:.3e}, launches "
                                     f"{launches}")


def phase_past_a_launch(Db, device, gen):
    """A chain of 2,048 with the compaction floor at 1: 11 compacting
    levels, one more than a fused CR launch takes (10). The factor keeps
    all 11; a solve runs ``band_cr_reduce`` and ``band_cr_backsub`` in two
    runs (6 and 5 levels, ``band._cr_runs``: the first on the tile kernels,
    in the launches their shared memory allows, the second one launch each
    way), as ``band.cr_solve_launches`` counts them (again for a 3D
    refinement step), and matches a dense solve on the card (<= 1e-11, the
    compacted band tests' bound) at K = 1 and 18."""
    import torch
    from score_tpu_torch.ops import band

    Tp, floor = 2048, band.CR_BASE_LENGTH
    D, U = _random_band(1, Tp, Db, seed=Tp + 9, device=device)
    band.CR_BASE_LENGTH = 1
    try:
        f = band.band_factor(D, U)
    finally:
        band.CR_BASE_LENGTH = floor
    M = torch.zeros(Tp * Db, Tp * Db, dtype=torch.float64, device=device)
    for i in range(Tp):
        M[Db * i:Db * (i + 1), Db * i:Db * (i + 1)] = D[0, i]
        if i + 1 < Tp:
            M[Db * i:Db * (i + 1), Db * (i + 1):Db * (i + 2)] = U[0, i]
            M[Db * (i + 1):Db * (i + 2), Db * i:Db * (i + 1)] = U[0, i].T
    solves = 1 + band.refine_steps(Db)
    for K in (1, 18):
        b = torch.randn(1, Tp, Db, K, generator=gen, dtype=torch.float64, device=device)
        band.reset_launch_counts()
        x = band.band_solve(f, b)
        xref = torch.linalg.solve(M, b[0].reshape(Tp * Db, K))
        rel = ((x[0].reshape(Tp * Db, K) - xref).abs().max() / xref.abs().max()).item()
        launches = (band.band_cr_reduce.launches, band.band_cr_backsub.launches)
        want = tuple(solves * w for w in band.cr_solve_launches(
            len(f.levels), Db, K, 1, 1, band._sm_count(device)))
        _log(f"Db={Db} chain C=1 Tp={Tp} ({len(f.levels)} CR levels, runs "
             f"{band._cr_runs(len(f.levels))}) K={K}: max_rel_diff to a dense solve {rel:.3e}, "
             f"launches reduce/backsub {launches}")
        if not (len(f.levels) == 11 and rel <= 1e-11 and launches == want
                and len(band._cr_runs(11)) == 2):
            raise AssertionError(f"Db={Db} Tp={Tp} 11 levels K={K}: {len(f.levels)} levels, "
                                 f"max_rel_diff {rel:.3e}, launches {launches}, want {want}")
    del M


def _two_run_chain_takes(step, n, Db, K, C, n_sm):
    """The routing of runs of at most 8 levels, before one launch took a
    pass: the chain kernels where the parent's measured faster, the tile
    kernels elsewhere. With it and ``band._CR_MAX_LEVELS`` = 8 this
    package's kernels run a pass as two runs on Manhattan-4 and 3D 1x1000;
    the parent's own chain kernels are not in this package (its times come
    from ``profile_port.py --cr --pass --root``)."""
    from score_tpu_torch.ops import band

    T, wide = 1 << n, K >= band._REGISTER_ROWS_K
    if step == "reduce":
        return C >= n_sm or T >= 64 or (Db > band._WIDE_MAX_BLOCK and wide)
    if Db <= band._WIDE_MAX_BLOCK:
        return C >= n_sm and wide
    return T <= 32 and wide


def phase_pass(label, C, Tp, Db, K, device):
    """One band-solve pass (``band._cr_runs``, as a solve makes it) at the
    cell's band shape, K = 1 and the panel: its band_cr_reduce launches and
    its band_cr_backsub launches against their plain twins (<= 1e-12),
    each way's device us (a replayed CUDA graph), bound and launches a pass
    (held to ``band.cr_solve_launches``: one each way on chains of up to
    1,024), beside the same pass cut into runs of at most 8 levels under
    the old routing (this package's kernels: :func:`_two_run_chain_takes`),
    also held to the twins. Returns the keys for the two kernels' rows
    (``pass_*``)."""
    import torch
    from score_tpu_torch.ops import band

    D, U = _random_band(C, Tp, Db, seed=Tp + C + 1, device=device)
    f = band.band_factor(D, U)
    n = len(f.levels)
    rng = np.random.default_rng(Tp + 5)
    out = {"band_cr_reduce": {}, "band_cr_backsub": {}}

    def spans():
        first, got = 0, []
        for d in band._cr_runs(n):
            got.append((first, d))
            first += d
        return got

    for k in (1, K):
        b = torch.tensor(rng.standard_normal((C, Tp, Db, k)), device=device)
        x = torch.tensor(rng.standard_normal((C, 1, Db, k)), device=device)
        want = band.band_cr_reduce_plain(f.levels, b)
        fine_all = (b,) + want[:-1]
        want_x = band.band_cr_backsub_plain(f.levels, fine_all, x)
        cost_r = _band_cost("band_cr_reduce", f.levels, b)
        cost_b = _band_cost("band_cr_backsub", f.levels, fine_all, x)
        row = {}
        for design in ("", "two_run_"):
            saved = band._CR_MAX_LEVELS, band._chain_takes
            if design:
                band._CR_MAX_LEVELS, band._chain_takes = 8, _two_run_chain_takes
            try:
                runs = spans()
                fine = (b,)
                band.reset_launch_counts()
                for first, d in runs:
                    fine += band.band_cr_reduce(f.levels[first:first + d], fine[-1])
                xs = x
                for first, d in reversed(runs):
                    xs = band.band_cr_backsub(f.levels[first:first + d], fine[first:first + d], xs)
                launches = (band.band_cr_reduce.launches, band.band_cr_backsub.launches)
                _compare(f"{label} {design}pass band_cr_reduce K={k}", fine[1:], want)
                _compare(f"{label} {design}pass band_cr_backsub K={k}", xs, want_x)

                def red():
                    src = b
                    for first, d in runs:
                        src = band.band_cr_reduce(f.levels[first:first + d], src)[-1]

                def back():
                    xx = x
                    for first, d in reversed(runs):
                        xx = band.band_cr_backsub(f.levels[first:first + d],
                                                  fine[first:first + d], xx)

                row[design] = (_device_us(red), _device_us(back), launches)
            finally:
                band._CR_MAX_LEVELS, band._chain_takes = saved
        (r_us, b_us, launches), (pr_us, pb_us, plaunches) = row[""], row["two_run_"]
        expect = band.cr_solve_launches(n, Db, k, 1, C, band._sm_count(device))
        if launches != expect or (Tp <= 1024 and launches != (1, 1)):
            raise AssertionError(f"{label} pass K={k}: launches {launches}, expected {expect}")
        bounds = [_bound(*c, "f64")[0] * 1e3 for c in (cost_r, cost_b)]
        tag = "k1" if k == 1 else "panel"
        for name, us, pus, bound, i in (("band_cr_reduce", r_us, pr_us, bounds[0], 0),
                                        ("band_cr_backsub", b_us, pb_us, bounds[1], 1)):
            out[name].update({f"pass_{tag}_K": k, f"pass_{tag}_device_us": us,
                              f"pass_{tag}_bound_us": bound,
                              f"pass_{tag}_launches": launches[i],
                              f"pass_{tag}_two_run_us": pus,
                              f"pass_{tag}_two_run_launches": plaunches[i]})
        _log(f"{label} pass K={k}: band_cr_reduce device_us={r_us:.2f} (bound {bounds[0]:.2f}, "
             f"{launches[0]} launch; in runs of <= 8 levels {pr_us:.2f} in {plaunches[0]}) "
             f"band_cr_backsub device_us={b_us:.2f} (bound {bounds[1]:.2f}, {launches[1]} launch; "
             f"in runs of <= 8 levels {pb_us:.2f} in {plaunches[1]}), all held to their twins")
    return out


def _ptxas_report(log, kernel, Db=None):
    """(registers, spill store bytes, spill load bytes), the worst over the
    instantiations of ``kernel`` in nvcc's ptxas output (with ``Db``, over
    those whose first template argument is Db: ``<kernel>ILi<Db>E`` in the
    mangled name). The name is matched with its length prefix, so that
    ``cr_level_kernel`` does not match ``pcr_level_kernel``."""
    import re

    regs = stores = loads = 0
    found = False
    key = f"{len(kernel)}{kernel}" + ("" if Db is None else f"ILi{Db}E")
    lines = log.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and key in line:
            found = True
            for nxt in lines[n + 1:n + 4]:
                if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt):
                    stores, loads = max(stores, int(m[1])), max(loads, int(m[2]))
                if m := re.search(r"Used (\d+) registers", nxt):
                    regs = max(regs, int(m[1]))
    if not found:
        raise AssertionError(f"ptxas output names no kernel {key}")
    return regs, stores, loads


def _random_blocks(M, n, seed, device):
    """M random SPD f32 blocks made as _random_band makes its diagonal."""
    import torch

    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, n, n))
    A = A @ np.swapaxes(A, -1, -2) + (2.0 + 4.0 * n) * np.eye(n)
    return torch.tensor(A, dtype=torch.float32, device=device)


def _resid(a, b):
    """||a - b|| / ||b|| over the whole tensor."""
    return ((a - b).norm() / b.norm()).item()


def phase_blocks(device):
    """Each block kernel against its plain version in f32, at the shapes of
    the f32 path: the Cholesky of every cyclic-reduction level's odd
    blocks (D = 6: M = 1024 at Manhattan-4's first level, 1280 at
    robot20's) and of QCQP's distance pivots (D = 2, M = 2070); forward
    substitution, and the fused forward and back substitution, of the
    arrow panel (K = 138), of a level's couplings (K = 6), of a direction
    (K = 1), and of the pivots' identity (D = 2, K = 2). Then the 3D
    shapes, in rows of their own (``<name>[D=n]``): D = 12 at 3D 4x250's
    first level (M = 512; the panel K = 18, the couplings K = 12, a
    direction K = 1) and its roots (M = 4; 3D 1x1000's, M = 1), and the
    3 x 3 pivots (M = 2348 and 2363, K = 3, the identity read through a
    block stride of 0 as ``inv_small_spd`` hands it), and the f32
    Monte-Carlo batch's fold (``[mc-f32]``: M = 12,800 at K = 56, 6, 1,
    the first level of the 100-trial batch's band). Times, bound and
    library call at each row's first shape; the fused kernel's device
    time at every shape. Then ``block_chol`` at every size and layout the
    f32 path hands it, the D = 12 kernels at the edge shapes, the two-rhs
    launch against two single-rhs launches (bits and device time), and
    ``block_chol``'s device time at every Cholesky of two f32 factors."""
    import torch
    from score_tpu_torch.ops import blocks

    chk = _KernelCheck(tol=REL_TOL_F32, precision="f32")
    rng = np.random.default_rng(7)
    # (row suffix, D, M, rhs widths, identity rhs)
    shapes = [("", 6, 1024, (138, 6, 1), False), ("", 6, 1280, (), False),
              ("", 2, 2070, (2,), False),
              ("[D=12]", 12, 512, (18, 12, 1), False), ("[D=12]", 12, 4, (18, 12, 1), False),
              ("[D=12]", 12, 1, (18, 1), False),
              ("[D=3]", 3, 2348, (3,), True), ("[D=3]", 3, 2363, (3,), True),
              # the f32 batch's fold: the first level's odd blocks, its panel
              ("[mc-f32]", 6, MC_BAND[0] * MC_BAND[1] // 2, (MC_BAND[2], 6, 1), False)]
    for tag, n, M, Ks, identity in shapes:
        A = _random_blocks(M, n, seed=M + n, device=device)
        L = chk("block_chol" + tag, lambda: blocks.block_chol(A),
                lambda: blocks.block_chol_plain(A),
                _blocks_cost("block_chol", A),
                library=lambda: torch.linalg.cholesky_ex(A, check_errors=False))
        r = _resid(L @ L.transpose(-1, -2), A)
        _log(f"block_chol D={n} M={M}: ||L L^T - A||/||A|| = {r:.3e}")
        if not r <= 1e-5:
            raise AssertionError(f"block_chol D={n} M={M}: residual {r:.3e}")
        for K in Ks:
            B = (torch.eye(n, device=device).expand(M, n, n) if identity else
                 torch.tensor(rng.standard_normal((M, n, K)), dtype=torch.float32,
                              device=device))
            if tag:
                Y = blocks.block_tri_lower_solve(L, B)
                _compare(f"block_tri_lower_solve D={n} M={M} K={K}", Y,
                         blocks.block_tri_lower_solve_plain(L, B), REL_TOL_F32)
            else:
                Y = chk("block_tri_lower_solve", lambda: blocks.block_tri_lower_solve(L, B),
                        lambda: blocks.block_tri_lower_solve_plain(L, B),
                        _blocks_cost("block_tri_lower_solve", L, B),
                        library=lambda: torch.linalg.solve_triangular(L, B, upper=False))
            r = _resid(L @ Y, B)
            _log(f"block_tri_lower_solve D={n} M={M} K={K}: ||L Y - B||/||B|| = {r:.3e}")
            if not r <= 1e-5:
                raise AssertionError(f"block_tri_lower_solve D={n} M={M} K={K}: residual {r:.3e}")
            first = "block_chol_solve" + tag not in chk.rows
            X = chk("block_chol_solve" + tag, lambda: blocks.block_chol_solve(L, B),
                    lambda: blocks.block_chol_solve_plain(L, B),
                    _blocks_cost("block_chol_solve", L, B),
                    library=lambda: torch.cholesky_solve(B, L))
            if first and tag == "[mc-f32]":
                # the fold's 36 MB fit the 50 MB L2, where the replayed graph
                # finds them: also from HBM, four copies taking turns
                copies = [(L.clone(), B.clone()) for _ in range(4)]
                turn = iter(range(1 << 30))
                cold = _device_us(lambda: blocks.block_chol_solve(*copies[next(turn) % 4]))
                row = chk.rows["block_chol_solve" + tag]
                row["cold_device_us"] = cold
                _log(f"block_chol_solve D={n} M={M} K={K}: device_us={row['device_us']:.2f} "
                     f"in L2, {cold:.2f} from HBM (four copies of L, B in turns)")
                del copies
            r = _resid(L @ (L.transpose(-1, -2) @ X), B)
            us = _device_us(lambda: blocks.block_chol_solve(L, B))
            _log(f"block_chol_solve D={n} M={M} K={K}: ||L L^T X - B||/||B|| = {r:.3e} "
                 f"device_us={us:.2f}")
            if not r <= 1e-5:
                raise AssertionError(f"block_chol_solve D={n} M={M} K={K}: residual {r:.3e}")
    # block_chol at every batch size and layout the f32 path can hand it:
    # contiguous, every second block of a batch (the band's odd rows) and the
    # first block of each of 3 (a chain's root), each against its plain
    # version and by reconstruction
    worst = 0.0
    for n in blocks.CUDA_BLOCK_SIZES:
        for M in (1, 3, 4, 128, 512, 1024, 2070, 2363):
            for what, A in (
                    ("contiguous", _random_blocks(M, n, seed=5 * M + n, device=device)),
                    ("odd blocks", _random_blocks(2 * M, n, seed=6 * M + n, device=device)[1::2]),
                    ("first of 3", _random_blocks(3 * M, n, seed=7 * M + n,
                                                  device=device).reshape(M, 3, n, n)[:, 0])):
                label = f"block_chol D={n} M={M} {what}"
                L = blocks.block_chol(A)
                worst = max(worst, _compare(label, L, blocks.block_chol_plain(A), REL_TOL_F32)[1])
                r = _resid(L @ L.transpose(-1, -2), A)
                if not (r <= 1e-5 and torch.equal(torch.triu(L, 1), torch.zeros_like(L))):
                    raise AssertionError(f"{label}: residual {r:.3e} or a non-zero upper triangle")
    torch.cuda.synchronize()
    _log(f"block_chol at D = {blocks.CUDA_BLOCK_SIZES}, M = 1..2363, three layouts: "
         f"max_rel_diff={worst:.3e} (bound {REL_TOL_F32}), residuals <= 1e-5")
    # the D = 12 kernels at batch sizes off and on their thread blocks and
    # warps (two lane groups a warp), the same three layouts, and
    # block_chol_solve on each factor at rhs widths on both sides of the
    # edge between its two layouts (lane groups below K = 4)
    worst_c = worst_s = worst_r = 0.0
    for M in (1, 2, 3, 4, 31, 32, 33, 511, 512, 513, 2363):
        for what, A in (
                ("contiguous", _random_blocks(M, 12, seed=11 * M, device=device)),
                ("odd blocks", _random_blocks(2 * M, 12, seed=11 * M + 1, device=device)[1::2]),
                ("first of 3", _random_blocks(3 * M, 12, seed=11 * M + 2,
                                              device=device).reshape(M, 3, 12, 12)[:, 0])):
            label = f"D=12 M={M} {what}"
            L = blocks.block_chol(A)
            worst_c = max(worst_c, _compare(f"block_chol {label}", L, blocks.block_chol_plain(A),
                                            REL_TOL_F32)[1])
            r = _resid(L @ L.transpose(-1, -2), A)
            if not (r <= 1e-5 and torch.equal(torch.triu(L, 1), torch.zeros_like(L))):
                raise AssertionError(f"block_chol {label}: residual {r:.3e} or a non-zero "
                                     "upper triangle")
            for K in (1, 2, 12, 17, 18, 19, 24):
                B = torch.tensor(rng.standard_normal((M, 12, K)), dtype=torch.float32,
                                 device=device)
                X = blocks.block_chol_solve(L, B)
                worst_s = max(worst_s, _compare(f"block_chol_solve {label} K={K}", X,
                                                blocks.block_chol_solve_plain(L, B),
                                                REL_TOL_F32)[1])
                r = _resid(L @ (L.transpose(-1, -2) @ X), B)
                worst_r = max(worst_r, r)
                if not r <= 1e-5:
                    raise AssertionError(f"block_chol_solve {label} K={K}: residual {r:.3e}")
    torch.cuda.synchronize()
    _log(f"D = 12 at M = 1..2363, three layouts, K = 1..24: block_chol max_rel_diff="
         f"{worst_c:.3e}, block_chol_solve max_rel_diff={worst_s:.3e} (bound {REL_TOL_F32}), "
         f"residuals <= {worst_r:.3e}")
    # one launch for two rhs against one factor (the f32 band's W2 and W1 of
    # a level: a transposed view and a stepped one) gives the bits of the
    # two single-rhs launches, at D = 6 and at both D = 12 layouts
    for n in (6, 12):
        for M in (1, 33, 512):
            L = blocks.block_chol(_random_blocks(M, n, seed=13 * M + n, device=device))
            for K in (1, n, 18):
                B = torch.randn(M, K, n, device=device).transpose(-1, -2)
                B2 = torch.randn(2 * M, n, K, device=device)[1::2]
                X, X2 = blocks.block_chol_solve(L, B, B2)
                if not (torch.equal(X, blocks.block_chol_solve(L, B)) and
                        torch.equal(X2, blocks.block_chol_solve(L, B2))):
                    raise AssertionError(f"block_chol_solve D={n} M={M} K={K}: the two-rhs "
                                         "launch differs from two single launches")
    # a factor level's two solves, one launch against two, at the first
    # level of Manhattan-4's f32 factor (C = 4 chains of 512, D = 6) and of
    # 3D 4x250's (C = 4 chains of 256, D = 12)
    for n, C, T in ((6, 4, 512), (12, 4, 256)):
        M = C * T // 2
        L = blocks.block_chol(_random_blocks(M, n, seed=T, device=device))
        U = torch.randn(C, T, n, n, device=device)
        Bt, Bs = (U[:, 0::2].transpose(-1, -2).reshape(M, n, n), U[:, 1::2].reshape(M, n, n))
        one = _device_us(lambda: blocks.block_chol_solve(L, Bt, Bs))
        two = _device_us(lambda: (blocks.block_chol_solve(L, Bt), blocks.block_chol_solve(L, Bs)))
        _log(f"block_chol_solve D={n} M={M} K={n}, a level's W2 and W1: two-rhs launch "
             f"device_us={one:.2f}, two launches device_us={two:.2f}; bit-equal at D = 6, 12, "
             "M = 1, 33, 512")
    # its device time at every Cholesky of a Manhattan-4 f32 factor (C = 4
    # chains of 512, D = 6) and of a 3D 4x250 one (C = 4 chains of 256,
    # D = 12): the odd blocks of each level, then the root, on contiguous
    # blocks and on the odd-row view the factor passes
    for n, C, T in ((6, 4, 512), (12, 4, 256)):
        while T >= 1:
            M = C * max(T // 2, 1)
            Dfull = _random_blocks(C * T, n, seed=T, device=device).reshape(C, T, n, n)
            view = (Dfull[:, 1::2] if T > 1 else Dfull[:, 0]).reshape(M, n, n)
            contig = view.contiguous()
            us = _device_us(lambda: blocks.block_chol(contig))
            us_view = _device_us(lambda: blocks.block_chol(view))
            _log(f"block_chol D={n} M={M} ({'level' if T > 1 else 'root'}): device_us={us:.2f} "
                 f"contiguous, {us_view:.2f} on the view (block stride {view.stride(0)})")
            T //= 2
    _log_rows("f32", chk.rows)
    return chk.rows


def phase_f32_band(device, C, Tp, Db, K):
    """Cyclic reduction in f32 over the block kernels (the f32 fast mode's
    band) against the f64 band kernels, same well-conditioned input at one
    instance's band shape (Manhattan-4: C = 4, Tp = 512, Db = 6, K = 138;
    3D 4x250: C = 4, Tp = 256, Db = 12, K = 18): relative difference of the
    solutions <= 1e-4 for a direction (K = 1) and the arrow panel. The
    block kernels run at D = Db."""
    import torch
    from score_tpu_torch.ops import band, blocks
    from score_tpu_torch.solver.pcr import pcr_factor, pcr_solve

    D, U = _random_band(C, Tp, Db, seed=Tp + C + 1, device=device)
    blocks.reset_launch_counts()
    f32 = pcr_factor(D.float(), U.float())
    # a level's two solves (W2, W1) in one launch
    levels = len(f32.L_odd)
    solves, pairs = blocks.block_chol_solve.launches, blocks.block_chol_solve.two_rhs_launches
    if not solves == pairs == levels:
        raise AssertionError(f"f32 band Db={Db}: {solves} solve launches, {pairs} with two rhs, "
                             f"for {levels} levels")
    f64 = band.band_factor(D, U)
    rng = np.random.default_rng(11)
    for k in (1, K):
        b = torch.tensor(rng.standard_normal((C, Tp, Db, k)), device=device)
        x32 = pcr_solve(f32, b.float()).double()
        x64 = band.band_solve(f64, b)
        rel = ((x32 - x64).abs().max() / x64.abs().max()).item()
        _log(f"f32 band C={C} Tp={Tp} Db={Db} K={k}: max relative difference to the f64 "
             f"band {rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"f32 band Db={Db} K={k}: relative difference {rel:.3e} > 1e-4")
    if not (blocks.block_chol.launches_by_size[Db] and
            blocks.block_chol_solve.launches_by_size[Db]):
        raise AssertionError(f"f32 band Db={Db}: the block kernels were not launched at D={Db}")


def _depth_to(Tp, base):
    """Compacting levels that leave a chain of Tp no longer than ``base``."""
    n = 0
    while (Tp >> n) > base:
        n += 1
    return n


def _path_kernels(Tp, Db, n_cr=None):
    """Names of the band kernels a solve with chains padded to Tp of
    Db-blocks runs at the default schedule (or ``n_cr`` compacting levels):
    the compacting-CR kernels where its band compacts (its factor's levels
    in band_cr_factor launches at Db = 6, whose last run inverts the one
    block a chain where the levels end there; a band_cr_level launch a
    level and band_block_inv at Db = 12: band._factor_takes),
    ``band_pcr_level`` where a remainder longer than one block is left (at
    the default schedule, none)."""
    from score_tpu_torch.ops import band

    n = band.cr_depth(Tp) if n_cr is None else n_cr
    fused = band._factor_takes(Db)
    off = {band.band_cr_level} if fused else {band.band_cr_factor}
    if not n:
        off |= {band.band_cr_factor, band.band_cr_level, band.band_cr_reduce,
                band.band_cr_backsub}
    elif fused and Tp >> n == 1:
        off.add(band.band_block_inv)
    if not band.num_levels(Tp >> n):
        off.add(band.band_pcr_level)
    return [k.__name__ for k in band.KERNELS if k not in off]


def _check_result(label, res, num_poses, d=2, relgap_tol=1e-6, det_tol=1e-9):
    """Solved status, relative gap, finite rounded poses (d + 1) x (d + 1)
    with det(R) = +1."""
    relgap = res.gap / max(1.0, abs(res.primal_objective))
    if not res.solved:
        raise AssertionError(f"{label}: not solved (iterations {res.iterations})")
    if not relgap <= relgap_tol:
        raise AssertionError(f"{label}: relgap {relgap:.3e} > {relgap_tol}")
    _check_poses(label, res, num_poses, d, det_tol)
    return relgap


def _check_poses(label, res, num_poses, d, det_tol):
    """Finite rounded poses (d + 1) x (d + 1) with det(R) = +1."""
    T = np.stack(list(res.poses.values()))
    if T.shape != (num_poses, d + 1, d + 1) or not np.isfinite(T).all():
        raise AssertionError(f"{label}: bad pose array {T.shape}")
    dets = np.linalg.det(T[:, :d, :d])
    if not np.all(np.abs(dets - 1.0) < det_tol):
        raise AssertionError(f"{label}: det(R) off +1 by {np.abs(dets - 1).max():.3e}")


def phase_small_reference():
    """A small instance on the card against the port's plain CPU path."""
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1,
    ))
    gpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda"))
    cpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu"))
    _check_result("small[cuda]", gpu, fg.num_poses)
    dobj = abs(gpu.primal_objective - cpu.primal_objective) / abs(cpu.primal_objective)
    dpose = max(np.abs(gpu.poses[k] - cpu.poses[k]).max() for k in cpu.poses)
    _log(f"small 2x25: cuda iters={gpu.iterations} cpu iters={cpu.iterations} "
         f"rel_obj_diff={dobj:.3e} max_pose_diff={dpose:.3e}")
    if gpu.solved != cpu.solved or abs(gpu.iterations - cpu.iterations) > 1:
        raise AssertionError("small: cuda and cpu disagree on status/iterations")
    if not (dobj <= 1e-7 and dpose <= 1e-4):
        raise AssertionError("small: cuda and cpu solutions disagree")


def _loop_world_3d():
    """The small 3D world (2 x 30 poses) with a loop closure A3 -> A25 that
    its odometry does not agree with: a sharp optimum, objective ~5e3."""
    from score_tpu_torch.fg.measurements import PoseMeasurement3D
    from score_tpu_torch.sim.world3d import World3DParams, simulate_3d_world

    fg = simulate_3d_world(World3DParams(num_robots=2, num_poses_per_robot=30,
                                         num_landmarks=4, range_measure_prob=0.4, seed=3))
    fg.loop_closure_measurements.append(PoseMeasurement3D(
        "A3", "A25", np.array([1.0, -2.0, 0.5]), np.eye(3), 100.0, 1000.0, 0.0))
    return fg


def phase_small_reference_3d():
    """A small 3D world (2 x 30 poses, 12 x 12 band blocks) as SOCP and
    QCQP on the card against the port's plain CPU path: both solved,
    iterations within 1, objectives within the larger final gap (these
    relaxations fit their ranges to ~1e-10, so a relative difference would
    compare roundoff), rounded poses within 1e-4; then the f32 mode on the
    same world with a loop closure (objective ~5e3; the plain world's f32
    objective is off by 0.1-1 from its ~0 optimum in both packages), SOCP
    and QCQP: on the card against the port's f32 CPU path (both solved,
    iterations within 3, objectives within 2e-2 relative), against the f64
    solve of the same relaxation (objective within 1e-2 relative), and
    through the block kernels at D = 12 and, for QCQP, D = 3."""
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.sim.world3d import World3DParams, simulate_3d_world

    fg = simulate_3d_world(World3DParams(num_robots=2, num_poses_per_robot=30,
                                         num_landmarks=4, range_measure_prob=0.4, seed=3))
    for relaxation in ("SOCP", "QCQP"):
        gpu = solve_score(fg, relaxation, ScoreSolverParams(device="cuda"))
        cpu = solve_score(fg, relaxation, ScoreSolverParams(device="cpu"))
        _check_result(f"small3d-{relaxation}[cuda]", gpu, fg.num_poses, d=3)
        dobj = abs(gpu.primal_objective - cpu.primal_objective)
        dpose = max(np.abs(gpu.poses[k] - cpu.poses[k]).max() for k in cpu.poses)
        _log(f"small 3D 2x30 {relaxation}: cuda iters={gpu.iterations} cpu "
             f"iters={cpu.iterations} objectives {gpu.primal_objective:.3e} / "
             f"{cpu.primal_objective:.3e} (gaps {gpu.gap:.3e} / {cpu.gap:.3e}) "
             f"max_pose_diff={dpose:.3e}")
        if not cpu.solved or abs(gpu.iterations - cpu.iterations) > 1:
            raise AssertionError(f"small3d {relaxation}: cuda and cpu disagree on "
                                 "status/iterations")
        if not (dobj <= max(gpu.gap, cpu.gap) and dpose <= 1e-4):
            raise AssertionError(f"small3d {relaxation}: cuda and cpu solutions disagree")
    loop = _loop_world_3d()
    for relaxation in ("SOCP", "QCQP"):
        f64 = solve_score(loop, relaxation, ScoreSolverParams(device="cuda"))
        _reset_counts()
        with _PlainBackSubstitutions() as plain_back:
            gpu = solve_score(loop, relaxation, ScoreSolverParams(device="cuda", precision="f32"))
        launches, by_size = _counts()
        cpu = solve_score(loop, relaxation, ScoreSolverParams(device="cpu", precision="f32"))
        _check_result(f"small3d-loop-{relaxation}-f32[cuda]", gpu, loop.num_poses, d=3,
                      relgap_tol=1e-2, det_tol=1e-5)
        dobj = abs(gpu.primal_objective - cpu.primal_objective) / abs(cpu.primal_objective)
        d64 = abs(gpu.primal_objective - f64.primal_objective) / abs(f64.primal_objective)
        _log(f"small 3D 2x30 loop {relaxation} f32: cuda solved={gpu.solved} "
             f"iters={gpu.iterations} obj={gpu.primal_objective:.6f}; cpu solved={cpu.solved} "
             f"iters={cpu.iterations} obj={cpu.primal_objective:.6f}; f64 obj "
             f"{f64.primal_objective:.6f}; rel_obj_diff cuda/cpu {dobj:.3e}, to f64 {d64:.3e}; "
             f"launches_by_size={by_size}")
        if not (cpu.solved and abs(gpu.iterations - cpu.iterations) <= 3 and dobj <= 2e-2):
            raise AssertionError(f"small3d loop {relaxation} f32: cuda and cpu disagree")
        if not d64 <= 1e-2:
            raise AssertionError(f"small3d loop {relaxation} f32: objective {d64:.3e} from f64")
        _check_f32_launches(f"small3d loop {relaxation} f32", launches, by_size, plain_back,
                            3, relaxation)


def _check_f32_launches(label, launches, by_size, plain_back, d, relaxation):
    """An f32 solve on a d-dimensional graph launched ``block_chol`` and the
    fused ``block_chol_solve`` at the band's block size d (d + 1) and, for
    QCQP, at the pivots' d, the factors' level solves as two-rhs launches
    (at least one a Cholesky of the band's odd blocks: every level but the
    root's); and neither the forward-only kernel nor a plain back
    substitution on the card's f32 tensors."""
    if launches["block_tri_lower_solve"] or plain_back.calls:
        raise AssertionError(
            f"{label}: {launches['block_tri_lower_solve']} forward-only launches and "
            f"{plain_back.calls} plain back substitutions on the f32 path")
    pairs, chols = launches["block_chol_solve.two_rhs"], by_size[f"block_chol[D={d * (d + 1)}]"]
    if not 0 < pairs < chols:
        raise AssertionError(f"{label}: {pairs} two-rhs solve launches beside {chols} "
                             "Cholesky launches of the band")
    sizes = (d * (d + 1), d) if relaxation == "QCQP" else (d * (d + 1),)
    expected = [f"{k}[D={n}]" for n in sizes for k in ("block_chol", "block_chol_solve")]
    missing = [k for k in expected if by_size[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched by the solve: {missing}")


def phase_small_f32_reference():
    """The f32 fast mode on a 4 x 50 world, on the card against the port's
    f32 CPU path: both solved, iterations within 3, objectives within 2e-2
    (the spread of f32 rounding measured on the CPU)."""
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=4, num_poses_per_robot=50, num_landmarks=4, grid_size=12,
        range_measure_prob=0.4, seed=3,
    ))
    gpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda", precision="f32"))
    cpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", precision="f32"))
    dobj = abs(gpu.primal_objective - cpu.primal_objective) / abs(cpu.primal_objective)
    _log(f"small f32 4x50: cuda solved={gpu.solved} iters={gpu.iterations} "
         f"obj={gpu.primal_objective:.6f}; cpu solved={cpu.solved} iters={cpu.iterations} "
         f"obj={cpu.primal_objective:.6f}; rel_obj_diff={dobj:.3e}")
    if not (gpu.solved and cpu.solved):
        raise AssertionError("small f32: not solved")
    if abs(gpu.iterations - cpu.iterations) > 3 or not dobj <= 2e-2:
        raise AssertionError("small f32: cuda and cpu disagree")


def _reset_counts():
    from score_tpu_torch.ops import band, blocks

    band.reset_launch_counts()
    blocks.reset_launch_counts()


class _PlainBackSubstitutions:
    """Counts, while active, the plain back substitutions that run on f32
    tensors of the card (the fused ``block_chol_solve`` replaces them)."""

    def __enter__(self):
        import torch
        from score_tpu_torch.ops import blocks

        self.calls = 0
        self._plain = blocks.block_tri_upper_solve_plain

        def counting(L, B):
            self.calls += L.is_cuda and L.dtype == torch.float32
            return self._plain(L, B)

        blocks.block_tri_upper_solve_plain = counting
        return self

    def __exit__(self, *exc):
        from score_tpu_torch.ops import blocks

        blocks.block_tri_upper_solve_plain = self._plain


class _BandSolves:
    """Records, while active, every pass of a band solve through its
    levels (``band._band_solve_once``): (compacting levels, Db, rhs
    width K, remainder length) each, from which ``band.cr_solve_launches``
    gives the fused CR kernels' launches."""

    def __enter__(self):
        from score_tpu_torch.ops import band

        self.calls = []
        self._once = band._band_solve_once

        def recording(factors, b):
            n = len(factors.levels)
            self.calls.append((n, b.shape[-2], b.shape[-1], b.shape[1] >> n, b.shape[0],
                               band._sm_count(b.device)))
            return self._once(factors, b)

        band._band_solve_once = recording
        return self

    def __exit__(self, *exc):
        from score_tpu_torch.ops import band

        band._band_solve_once = self._once

    def cr_launches(self):
        """(band_cr_reduce, band_cr_backsub) launches the recorded passes
        take."""
        from score_tpu_torch.ops import band

        per = [band.cr_solve_launches(*c) for c in self.calls]
        return sum(p[0] for p in per), sum(p[1] for p in per)


def _counts():
    """Launches of every kernel since the last reset, and each kernel's
    launches per block size: ``<name>[Db=n]`` for the band kernels,
    ``<name>[D=n]`` for the block kernels; the CR kernels' by run,
    ``<name>[run=Db,T,levels]``."""
    from score_tpu_torch.ops import band, blocks

    launches = {k.__name__: k.launches for k in band.KERNELS + blocks.KERNELS}
    launches.update({f"{k.__name__}[run={','.join(map(str, run))}]": c
                     for k in (band.band_cr_factor, band.band_cr_reduce, band.band_cr_backsub)
                     for run, c in k.launches_by_run.items()})
    launches["block_chol_solve.two_rhs"] = blocks.block_chol_solve.two_rhs_launches
    by_size = {f"{k.__name__}[{key}={n}]": c
               for key, kernels in (("Db", band.KERNELS), ("D", blocks.KERNELS))
               for k in kernels for n, c in k.launches_by_size.items()}
    return launches, by_size


def phase_solve(label, fg, Tp, Db=6, relaxation="SOCP", precision="f64", reference=None,
                cpu_reference=False, must_solve=True):
    """Cold and warm solves on the card with launch counting. f64 runs the
    band kernels of its path at the graph's block size Db; f32
    ``block_chol`` and the fused ``block_chol_solve`` at the band's block
    size (and the pivots' for QCQP) and neither the forward-only kernel nor
    a plain back substitution on the card's f32 tensors
    (:func:`_check_f32_launches`), held to the f32 mode's reduced tolerance
    and, with ``reference`` (the f64 result of the same relaxation), to its
    objective within 1e-2. With ``cpu_reference``, the port's CPU runs of
    the same world in the same precision beside it, one at each of
    ``CPU_THREADS``: the same solved status, and iterations within 3 of
    their range, or more with a relative gap below all of theirs. Without
    ``must_solve`` (a solve that ends unsolved
    in both packages) only that agreement and the rounded poses (finite,
    det(R) = +1) are required."""
    import torch
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.ops import band

    params = ScoreSolverParams(device="cuda", precision=precision)
    f32 = precision == "f32"
    d = fg.dimension
    _reset_counts()
    t0 = time.perf_counter()
    with _PlainBackSubstitutions() as plain_back, _BandSolves() as passes:
        res = solve_score(fg, relaxation, params)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches, by_size = _counts()
    if f32:
        _check_f32_launches(label, launches, by_size, plain_back, d, relaxation)
    else:
        expected = [f"{k}[Db={Db}]" for k in _path_kernels(Tp, Db)]
        missing = [k for k in expected if by_size[k] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels not launched by the solve: {missing}")
        # the compacting levels of a band solve in the fused CR kernels'
        # runs (band._cr_runs: a pass in one run on chains of up to 1,024,
        # one launch each way), one band_pcr_solve launch a pass
        cr = (launches["band_cr_reduce"], launches["band_cr_backsub"])
        want = passes.cr_launches()
        one = all(c[0] <= band._CR_MAX_LEVELS and c[3] == 1 for c in passes.calls)
        if (cr != want or launches["band_pcr_solve"] != len(passes.calls)
                or (one and want != (len(passes.calls),) * 2)):
            raise AssertionError(f"{label}: band_cr_reduce / band_cr_backsub / band_pcr_solve "
                                 f"launches {cr} / {launches['band_pcr_solve']}, expected "
                                 f"{want} / {len(passes.calls)} for the solve's passes")
    tols = dict(relgap_tol=1e-2, det_tol=1e-5) if f32 else {}

    def check(tag, r):
        if must_solve:
            return _check_result(tag, r, fg.num_poses, d, **tols)
        _check_poses(tag, r, fg.num_poses, d, tols.get("det_tol", 1e-9))
        return r.gap / max(1.0, abs(r.primal_objective))

    relgap = check(label, res)
    t0 = time.perf_counter()
    warm_res = solve_score(fg, relaxation, params)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    check(label + "[warm]", warm_res)
    line = (f"{label}: solved={res.solved} iterations={res.iterations} relgap={relgap:.3e} "
            f"pres={res.primal_residual:.3e} dres={res.dual_residual:.3e} "
            f"objective={res.primal_objective:.6f} cold_s={cold:.3f} warm_s={warm:.3f}")
    if reference is not None:
        dobj = abs(res.primal_objective - reference.primal_objective) / abs(
            reference.primal_objective)
        line += f" rel_obj_diff_to_f64={dobj:.3e}"
        if not dobj <= 1e-2:
            raise AssertionError(f"{label}: objective {dobj:.3e} from f64 > 1e-2")
    _log(f"{label}: {fg.summary()}")
    _log(f"{line} launches={launches} launches_by_size={by_size}")
    if cpu_reference:
        # the CPU run at several torch thread counts: where the f64 objective
        # is ~0 the f32 one is roundoff (3D 4x250 SOCP: 32, 16, -16, 0.0),
        # and the stopping test's max(1, |objective|) makes the iteration
        # count follow it (10-16 over thread counts on one CPU). A solve
        # that ends by the stall detector can also escape a stall and stop
        # later at a better gap (3D 1x1000 SOCP on the CPU: 12 iterations at
        # relgap 2.4e-3, or 27 at 1.6e-4 after a 1e-6 move of its start):
        # more iterations than the CPU runs are accepted only with a
        # relative gap below all of theirs
        threads = torch.get_num_threads()
        its, relgaps = [], []
        for n in CPU_THREADS:
            torch.set_num_threads(n)
            t0 = time.perf_counter()
            # a copy of the graph: each run assembles at its own thread count
            cpu = solve_score(copy.deepcopy(fg), relaxation,
                              ScoreSolverParams(device="cpu", precision=precision))
            _log(f"{label}[cpu, {n} threads]: solved={cpu.solved} iterations={cpu.iterations} "
                 f"relgap={cpu.gap / max(1.0, abs(cpu.primal_objective)):.3e} "
                 f"pres={cpu.primal_residual:.3e} dres={cpu.dual_residual:.3e} "
                 f"objective={cpu.primal_objective:.6f} wall_s={time.perf_counter() - t0:.3f}")
            if cpu.solved != res.solved:
                raise AssertionError(f"{label}: the card (solved={res.solved}) and the CPU "
                                     f"at {n} threads (solved={cpu.solved}) disagree")
            its.append(cpu.iterations)
            relgaps.append(cpu.gap / max(1.0, abs(cpu.primal_objective)))
        torch.set_num_threads(threads)
        longer_and_better = res.iterations > max(its) and relgap < min(relgaps)
        if not (min(its) - 3 <= res.iterations <= max(its) + 3 or longer_and_better):
            raise AssertionError(f"{label}: {res.iterations} iterations on the card at relgap "
                                 f"{relgap:.3e}, more than 3 from the CPU runs' {its} "
                                 f"(relgaps {relgaps})")
    return {**launches, **by_size}, res


class _AssemblyCounts:
    """Counts, while active, the conic assemblies (``build_conic_problem``
    as the solve API calls it) and the backends' ``prepare`` calls: a
    solve served by the assembly memo runs neither."""

    def __enter__(self):
        from score_tpu_torch import api
        from score_tpu_torch.solver.backend import DenseBackend
        from score_tpu_torch.solver.chain_arrow import ChainArrowBackend

        self.builds = self.prepares = 0
        self._saved = [(api, "build_conic_problem", api.build_conic_problem)] + [
            (cls, "prepare", cls.__dict__["prepare"]) for cls in (ChainArrowBackend, DenseBackend)]
        build = api.build_conic_problem

        def counting_build(*a, **k):
            self.builds += 1
            return build(*a, **k)

        api.build_conic_problem = counting_build
        for cls, _, method in self._saved[1:]:
            def counting_prepare(*a, _prepare=method.__func__, **k):
                self.prepares += 1
                return _prepare(*a, **k)

            cls.prepare = staticmethod(counting_prepare)
        return self

    def __exit__(self, *exc):
        for owner, name, value in self._saved:
            setattr(owner, name, value)


def _digits(r):
    """What a solve line prints, unrounded: status, iterations, relgap,
    residuals, objective."""
    return (r.solved, r.iterations, r.gap / max(1.0, abs(r.primal_objective)),
            r.primal_residual, r.dual_residual, r.primal_objective)


def _timed_solve(fg, relaxation, params):
    """One solve_score on the card with the hand-written kernels' launches
    counted from zero: (result, wall s, launches of the kernels launched)."""
    import torch
    from score_tpu_torch import solve_score

    _reset_counts()
    t0 = time.perf_counter()
    res = solve_score(fg, relaxation, params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = _counts()
    return res, wall, {k: v for k, v in launches.items() if v}


def phase_api(m4, g4x250, g1000, results):
    """The solve API around the kernels, on the card: (a) the assembly memo
    (a second solve of one graph runs no assembly and no prepare and
    repeats the first's digits), (b) a pickle round trip, (c) the dense
    KKT backend at Manhattan-4's full size, (d) odometry warm starts, (e)
    the intermediate iterates. ``results`` holds the earlier phases' f64
    solves of the same graphs."""
    import os
    import tempfile

    import torch
    from score_tpu_torch import (ScoreSolverParams, solve_problem_with_intermediate_iterates,
                                 solve_score)
    from score_tpu_torch.fg import parse_pickle_file, save_to_pickle_file

    params = ScoreSolverParams(device="cuda")
    # (a) the memo: two solves of one graph object, the first one cold
    # (a copy, so no earlier phase's entry serves it)
    first = {}
    for label, fg, earlier in (("manhattan4", m4, results["manhattan4"]),
                               ("3d-1x1000", g1000, results["3d-1x1000"])):
        fg = copy.deepcopy(fg)
        calls = []
        for call in ("first", "second"):
            with _AssemblyCounts() as counts:
                res, wall, launches = _timed_solve(fg, "SOCP", params)
            calls.append((res, counts.builds, counts.prepares))
            _log(f"api memo {label} {call}: solved={res.solved} iterations={res.iterations} "
                 f"relgap={_digits(res)[2]:.3e} objective={res.primal_objective!r} "
                 f"wall_s={wall:.3f} assemblies={counts.builds} prepares={counts.prepares} "
                 f"launches={launches}")
        (a, a_builds, a_prep), (b, b_builds, b_prep) = calls
        if (a_builds, a_prep, b_builds, b_prep) != (1, 1, 0, 0):
            raise AssertionError(f"api memo {label}: assemblies/prepares {a_builds}, {a_prep} "
                                 f"then {b_builds}, {b_prep}; expected 1, 1 then 0, 0")
        _check_result(f"api memo {label}", a, fg.num_poses, fg.dimension)
        if _digits(a) != _digits(b) or _digits(a) != _digits(earlier):
            raise AssertionError(f"api memo {label}: digits {_digits(a)}, {_digits(b)}, "
                                 f"earlier phase {_digits(earlier)}")
        first[label] = a
    # (b) pickle round trip of Manhattan-4
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "manhattan4.pkl")
        save_to_pickle_file(m4, path)
        parsed = parse_pickle_file(path)
    res, wall, _ = _timed_solve(parsed, "SOCP", params)
    _log(f"api pickle manhattan4: solved={res.solved} iterations={res.iterations} "
         f"relgap={_digits(res)[2]:.3e} objective={res.primal_objective!r} wall_s={wall:.3f}")
    if _digits(res) != _digits(first["manhattan4"]):
        raise AssertionError(f"api pickle: digits {_digits(res)} != memo's "
                             f"{_digits(first['manhattan4'])}")
    # (c) the dense KKT backend at full size (a dense K of n x n in f64)
    chain = first["manhattan4"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dense, wall, launches = _timed_solve(m4, "SOCP", ScoreSolverParams(device="cuda",
                                                                        backend="dense"))
    peak = torch.cuda.max_memory_allocated()
    relgap = _check_result("api dense manhattan4", dense, m4.num_poses)
    dobj = abs(dense.primal_objective - chain.primal_objective)
    bound = dense.gap + chain.gap + 1e-9 * abs(chain.primal_objective)
    _log(f"api dense manhattan4: solved={dense.solved} iterations={dense.iterations} "
         f"(chain+arrow {chain.iterations}) relgap={relgap:.3e} "
         f"objective={dense.primal_objective!r} |dobj|={dobj:.3e} (bound {bound:.3e}) "
         f"wall_s={wall:.3f} max_memory_allocated_GB={peak / 1e9:.3f} launches={launches}")
    if abs(dense.iterations - chain.iterations) > 1 or not dobj <= bound:
        raise AssertionError("api dense: disagrees with the chain+arrow solve")
    # (d) odometry warm starts, beside the cold starts of the earlier phases
    # and the port's CPU run of the same warm start. Where the JAX package's
    # algorithm ends such a start by its stall detector (2D worlds from 3 x
    # 40 poses up: the objective falls from the dead-reckoned start faster
    # than the gap, so the relative gap in the best-iterate metric grows and
    # the start is never beaten), the card must end it the same way
    for label, fg in (("manhattan4", m4), ("3d-4x250", g4x250)):
        res, wall, _ = _timed_solve(fg, "SOCP", ScoreSolverParams(device="cuda",
                                                                   init_technique="odom"))
        cpu = solve_score(copy.deepcopy(fg), "SOCP", ScoreSolverParams(device="cpu",
                                                                        init_technique="odom"))
        relgap = res.gap / max(1.0, abs(res.primal_objective))
        _log(f"api odom {label}: solved={res.solved} iterations={res.iterations} "
             f"(cold start {results[label].iterations}) relgap={relgap:.3e} "
             f"objective={res.primal_objective!r} wall_s={wall:.3f}; cpu solved={cpu.solved} "
             f"iterations={cpu.iterations} objective={cpu.primal_objective!r}")
        if res.solved != cpu.solved or abs(res.iterations - cpu.iterations) > 1:
            raise AssertionError(f"api odom {label}: the card and the CPU disagree")
        if res.solved:
            _check_result(f"api odom {label}", res, fg.num_poses, fg.dimension)
        else:
            _check_poses(f"api odom {label}", res, fg.num_poses, fg.dimension, 1e-9)
    # (e) the intermediate iterates of the small parity world
    from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

    small = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1,
    ))
    snaps = solve_problem_with_intermediate_iterates(small, "SOCP", params)
    final = solve_score(small, "SOCP", params)
    same = _digits(snaps[-1]) == _digits(final) and all(
        np.array_equal(snaps[-1].poses[k], T) for k, T in final.poses.items())
    _log(f"api iterates 2x25: {len(snaps)} snapshots, solve_score iterations="
         f"{final.iterations}, last snapshot equals solve_score: {same}; objectives "
         + " ".join(f"{s.primal_objective:.6f}" for s in snaps))
    if len(snaps) != final.iterations + 1 or not same:
        raise AssertionError("api iterates: the last snapshot is not solve_score's result")


def _refine_cells(cells, cells_3d):
    """The refinement's cells: Manhattan-4 and 3D 4x250, as (label, graph,
    Tp, Db)."""
    return [(label, fg, shape[1], shape[3]) for label, fg, shape in (cells[0], cells_3d[0])]


def _true_cost(fg, values):
    """The nonlinear MLE objective the refinement minimizes, evaluated on
    the host from the named values, measurement by measurement."""
    d = fg.dimension
    c = 0.0
    meas = [m for chain in fg.odom_measurements for m in chain]
    meas += list(fg.loop_closure_measurements)
    for m in meas:
        Ti, Tj = np.asarray(values.poses[m.base_pose]), np.asarray(values.poses[m.to_pose])
        Ri, ti, Rj, tj = Ti[:d, :d], Ti[:d, d], Tj[:d, :d], Tj[:d, d]
        c += m.rotation_precision * np.sum((Rj - Ri @ np.asarray(m.rotation_matrix)) ** 2)
        c += m.translation_precision * np.sum(
            (tj - ti - Ri @ np.asarray(m.translation_vector)) ** 2)

    def pos(name):
        if name in values.poses:
            return np.asarray(values.poses[name])[:d, d]
        return np.asarray(values.landmarks[name])

    for r in fg.range_measurements:
        c += r.precision * (np.linalg.norm(pos(r.first_key) - pos(r.second_key)) - r.dist) ** 2
    for p in fg.landmark_priors:
        c += p.translation_precision * np.sum(
            (np.asarray(values.landmarks[p.name]) - np.asarray(p.position)[:d]) ** 2)
    return float(c)


def _so_error(values, d):
    """max |R'R - I| and max |det R - 1| over the poses."""
    R = np.stack([np.asarray(T)[:d, :d] for T in values.poses.values()])
    orth = np.abs(np.swapaxes(R, -1, -2) @ R - np.eye(d)).max()
    return float(orth), float(np.abs(np.linalg.det(R) - 1.0).max())


def _refine_launches(fg, start, iterations, most=6):
    """Kernel launches and device busy ms of one refinement on the card of
    exactly ``iterations`` outer iterations (torch.profiler, the device's
    activity alone: a refinement makes ~8-15 thousand launches an
    iteration), and the launches each profiled run counted. The profiler
    loses activity records of some such runs (3D 4x250: 14,547 of 14,688
    launches and 41,011 of 43,926, 2 of 9 runs in one call), and a
    refinement launches the same kernels whatever its data, so runs are
    profiled until two agree with the largest count to 0.1 % (at most
    ``most`` runs); the count is the largest and the busy time that
    run's. The device's records are counted as the profiler returns them
    (``kineto_results``), not through ``key_averages()``, whose
    aggregation in Python costs seconds a run at these counts."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from score_tpu_torch import RefineParams, refine_solution

    runs = []
    while len(runs) < most:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = refine_solution(fg, start, RefineParams(max_iter=iterations), device="cuda")
            torch.cuda.synchronize()
        if out.iterations != iterations:
            raise AssertionError(f"refine: {out.iterations} iterations profiled, asked {iterations}")
        kernels = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA]
        runs.append((len(kernels), sum(kernels) / 1e6))
        top = max(n for n, _ in runs)
        if sum(top - n <= 1e-3 * top for n, _ in runs) >= 2:
            break
    launches, busy = max(runs)
    return launches, busy, [n for n, _ in runs]


def phase_refine(cells, results=None):
    """The refinement stage on the card: for each (label, graph, Tp, Db),
    (a) the main path ``solve_score(fg, "SOCP", ScoreSolverParams(refine=True))``
    with the kernel counts set to 0 before it: every band kernel of the
    solve's path launched, the solve's digits those of a plain solve (and of
    the earlier phase's, ``results``); (b) ``refine_solution`` of the plain
    solve's rounded values, timed, with every host synchronization counted
    (``torch.cuda.set_sync_debug_mode``): initial and final cost (the final
    one also on the host, ``_true_cost``), iterations, wall, rotations in
    SO(d) to 1e-9, and in 3D a final cost below the initial one; (c)
    launches per refinement: profiled refinements of 1, 2 and 3 outer
    iterations (each the largest count of profiled runs until two agree,
    ``_refine_launches``), extrapolated to (b)'s count (the same launches every
    iteration, within 1 %) and the device busy time of one; (d) the card
    against the port's CPU refinement of the same start at ``max_iter=10``:
    equal iterations, costs within 1e-8 relative."""
    import warnings

    import torch
    from score_tpu_torch import RefineParams, ScoreSolverParams, refine_solution, solve_score

    for label, fg, Tp, Db in cells:
        t_cell = time.perf_counter()
        d = fg.dimension
        plain = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda"))
        _reset_counts()
        t0 = time.perf_counter()
        res = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda", refine=True))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _, by_size = _counts()
        missing = [k for k in _path_kernels(Tp, Db) if by_size[f"{k}[Db={Db}]"] == 0]
        if missing:
            raise AssertionError(f"refine {label}: kernels not launched by the solve: {missing}")
        earlier = [plain] + ([results[label]] if results and label in results else [])
        if any(_digits(res) != _digits(r) for r in earlier):
            raise AssertionError(f"refine {label}: solve digits {_digits(res)} != "
                                 f"{[_digits(r) for r in earlier]}")
        _log(f"refine {label} solve_score(refine=True): solved={res.solved} "
             f"iterations={res.iterations} objective={res.primal_objective!r} "
             f"total_time_s={res.total_time:.3f} wall_s={wall:.3f} "
             f"launches_by_size={ {k: v for k, v in by_size.items() if v} }")

        start = plain.variables
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                ref = refine_solution(fg, start, device="cuda")
                torch.cuda.synchronize()
                refine_wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode("default")
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        c_start, c_end = _true_cost(fg, start), _true_cost(fg, ref.values)
        orth, det = _so_error(ref.values, d)
        _log(f"refine {label}: iterations={ref.iterations} initial_cost={ref.initial_cost!r} "
             f"cost={ref.cost!r} (host: {c_start!r} -> {c_end!r}, ratio "
             f"{c_end / c_start:.3e}) refine_wall_s={refine_wall:.3f} host_syncs={syncs} "
             f"so_orth_err={orth:.2e} so_det_err={det:.2e}")
        if not (np.isfinite(ref.cost) and orth <= 1e-9 and det <= 1e-9):
            raise AssertionError(f"refine {label}: cost {ref.cost}, SO(d) errors {orth}, {det}")
        if abs(c_end - ref.cost) > 1e-9 * c_end or abs(c_start - ref.initial_cost) > 1e-9 * c_start:
            raise AssertionError(f"refine {label}: costs disagree with the host's")
        if d == 3 and not ref.cost < ref.initial_cost:
            raise AssertionError(f"refine {label}: 3D cost {ref.cost} not below {ref.initial_cost}")
        if not ref.cost <= ref.initial_cost:
            raise AssertionError(f"refine {label}: cost rose")

        # every outer iteration runs the same operations: launches of a
        # refinement grow by one iteration's count each iteration (within
        # a few launches: 7843 then 7841 on Manhattan-4)
        profiled = [_refine_launches(fg, start, n) for n in (1, 2, 3)]
        per = [n for n, _, _ in profiled]
        counted = [c for _, _, c in profiled]
        busy = profiled[2][1] - profiled[1][1]
        step = per[2] - per[1]
        if not step > 0 or abs((per[1] - per[0]) - step) > 0.01 * step:
            raise AssertionError(f"refine {label}: launches of 1, 2, 3 iterations {per} "
                                 f"(each profiled run: {counted})")
        launches = per[0] + (ref.iterations - 1) * step
        _log(f"refine {label}: launches per outer iteration={step} (1, 2, 3 iterations: {per}; "
             f"each profiled run: {counted}) "
             f"launches per refinement={launches} ({ref.iterations} iterations) "
             f"host_syncs_per_iteration={syncs / max(ref.iterations, 1):.2f} "
             f"device_busy_ms_per_iteration={busy:.3f} (wall per iteration "
             f"{1e3 * refine_wall / max(ref.iterations, 1):.1f} ms)")

        gpu = refine_solution(fg, start, RefineParams(max_iter=10), device="cuda")
        t0 = time.perf_counter()
        cpu = refine_solution(fg, start, RefineParams(max_iter=10), device="cpu")
        cpu_wall = time.perf_counter() - t0
        dcost = abs(gpu.cost - cpu.cost) / abs(cpu.cost)
        dpose = max(np.abs(gpu.values.poses[k] - T).max() for k, T in cpu.values.poses.items())
        _log(f"refine {label} max_iter=10: cuda iterations={gpu.iterations} cost={gpu.cost!r}; "
             f"cpu iterations={cpu.iterations} cost={cpu.cost!r} wall_s={cpu_wall:.3f}; "
             f"rel_cost_diff={dcost:.3e} max_pose_diff={dpose:.3e}")
        if gpu.iterations != cpu.iterations or not dcost <= 1e-8:
            raise AssertionError(f"refine {label}: the card and the CPU disagree")
        _log(f"refine {label}: phase wall_s={time.perf_counter() - t_cell:.1f}")


# ------------------------------------------------------------------ #
# The Monte-Carlo batch (score_tpu_torch.parallel)
# ------------------------------------------------------------------ #

# the JAX package's Monte-Carlo bench row (bench.py:330-394): resamples of a
# 4 x 50 Manhattan world, SOCP, IPMParams(max_iter=20) without Gondzio
# correctors, ChainArrowBackend; 100 trials fold to C = 400 chains of Tp = 64
MC_WORLD = dict(num_robots=4, num_poses_per_robot=50, num_landmarks=4, grid_size=10,
                range_measure_prob=0.4, seed=0)
MC_TRIALS = 100
# the band's compaction floor before it compacted to one block: the shapes
# at which band_pcr_level, on no solve path since, is held to its twin
EARLIER_BASE = 256
PCR_LEVEL_NOTE = (f"on no solve path: the band compacts to one block (band.CR_BASE_LENGTH = 1); "
                  f"held to its twin and timed at the shapes of the earlier remainder of "
                  f"{EARLIER_BASE} blocks")
# host synchronizations a batch solve may make besides its one a trip (the
# measured count: one, logged with its source line by phase mc_batch)
MC_SYNC_CONSTANT = 1
# the fold's band shape: chains, padded length, arrow width (the panel)
MC_BAND = (4 * MC_TRIALS, 64, 56)


def _mc_params():
    import dataclasses

    from score_tpu_torch.solver.ipm import IPMParams

    return dataclasses.replace(IPMParams(max_iter=20), gondzio_correctors=0)


# the 3D batch: trials of 3D 4x250 (``bench.py:296``) with redrawn ranges,
# each normalized as ``solve_score`` normalizes; the f32 batch: the
# 100-trial batch's stacks cast to float32, the f32 mode's tolerances
MC3D_TRIALS = 16
MC_F32_RELGAP = 1e-2  # the f32 mode's reduced tolerance


def _mc_f32_params():
    from score_tpu_torch.solver.params import ScoreSolverParams

    return ScoreSolverParams(precision="f32", max_iter=20, gondzio_correctors=0).ipm_params()


def _resample_ranges(fg, seed):
    """A trial of a graph's structure: a copy whose range measurements are
    redrawn around the ground truth (the true distance plus a normal of
    the range's stddev, at least 1e-3, from a numpy generator of ``seed``,
    in the graph's order), every association and every other measurement
    kept (the tests' ``torch_reference_data.resample_ranges``; the JAX
    package has no 3D resampler)."""
    out = copy.deepcopy(fg)
    rng = np.random.default_rng(seed)
    where = {v.name: np.asarray(v.true_position, dtype=np.float64)
             for chain in out.pose_variables for v in chain}
    where.update({v.name: np.asarray(v.true_position, dtype=np.float64)
                  for v in out.landmark_variables})
    for m in out.range_measurements:
        a, b = m.association
        m.dist = float(max(np.linalg.norm(where[a] - where[b]) + rng.normal(0.0, m.stddev),
                           1e-3))
    return out


def _mc_batch(seeds, device, relaxation="SOCP", world="mc", precision="f64"):
    """Trials ``seeds`` of a batch world, assembled on the host, stacked
    and moved to ``device``: (batch, the first three single problems on
    the device, chain+arrow structure on the device). ``world`` "mc": the
    Monte-Carlo world with ``resample_measurements``; "3d": 3D 4x250 with
    :func:`_resample_ranges`, each trial normalized. ``precision`` "f32"
    casts the problems to float32 after assembly."""
    import dataclasses

    import torch
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.assembly.normalize import normalize_factor_graph
    from score_tpu_torch.parallel import stack_problems
    from score_tpu_torch.sim.manhattan import (
        ManhattanWorldParams,
        resample_measurements,
        simulate_manhattan_world,
    )
    from score_tpu_torch.solver.chain_arrow import build_chain_arrow

    def to(pb):
        return dataclasses.replace(pb, **{f.name: getattr(pb, f.name).to(device)
                                         for f in dataclasses.fields(pb)
                                         if not isinstance(getattr(pb, f.name), (int, str))})

    if world == "3d":
        base = _cells_3d()[0][1]
        trials = [normalize_factor_graph(_resample_ranges(base, s))[0] for s in seeds]
    else:
        base = simulate_manhattan_world(ManhattanWorldParams(**MC_WORLD))
        trials = [resample_measurements(base, seed=s) for s in seeds]
    problems = [build_conic_problem(t, relaxation, device="cpu")[0] for t in trials]
    if precision == "f32":
        problems = [p.cast(torch.float32) for p in problems]
    idx = build_conic_problem(trials[0], relaxation, device="cpu")[1]
    first = to(problems[0])
    return to(stack_problems(problems)), [first] + [to(p) for p in problems[1:3]], \
        build_chain_arrow(first, idx)


def _batch_lines_agree(label, card, cpu, trips, f32=False, flat=False):
    """The card's batch against the port's CPU batch of the same trials,
    lane by lane: the same status, iterations within 1, pobj within 1e-9
    relative (with ``flat``, a world whose objective is ~0, as the 3D
    worlds without a loop closure, at the roundoff of its constant term:
    within the solver's relative-gap scale, 1e-6 * max(1, |pobj|)); the
    trips (card, CPU) within 1. With ``f32`` the f32 bounds (PERF.md
    section 2): pobj within 2e-2 * max(1, |pobj|), iterations within 3 on
    the lanes that end OPTIMAL, the trips within 3 where every lane does."""
    from score_tpu_torch.solver.ipm import OPTIMAL

    st_c, st_h = card.status.cpu(), cpu.status
    it_c, it_h = card.iterations.cpu(), cpu.iterations
    pc, ph = card.pobj.cpu().double(), cpu.pobj.double()
    dobj = ((pc - ph).abs() / ph.abs().clamp_min(1e-300)).max().item()
    dit = (it_c - it_h).abs().max().item()
    dtrips = abs(trips[0] - trips[1])
    if f32:
        # a lane that ends OPTIMAL_INACCURATE stops on the f32 dual-residual
        # floor by the stall counter, at a trip that follows the roundoff
        # (the Monte-Carlo world's fourth trial: 19 iterations on the card
        # and in the JAX package's CPU batch, 15 in the port's): iterations
        # held only on OPTIMAL lanes, the trips where every lane is
        its, tol = 3, 2e-2 * ph.abs().clamp_min(1.0)
        held = st_h == OPTIMAL
        dit = (it_c - it_h).abs()[held].max().item() if held.any() else 0
        dtrips = dtrips if held.all() else 0
    else:
        its, tol = 1, (1e-6 * ph.abs().clamp_min(1.0) if flat else 1e-9 * ph.abs())
    ok_obj = bool(((pc - ph).abs() <= tol).all())
    _log(f"mc_batch {label}: card statuses {st_c.tolist()} iterations {it_c.tolist()}; "
         f"cpu iterations {it_h.tolist()}; max_rel_pobj_diff={dobj:.3e} "
         f"max_abs_pobj_diff={(pc - ph).abs().max().item():.3e} "
         f"max_iteration_diff={dit} trips card/cpu={trips}")
    if not _same(st_c, st_h) or dit > its or not ok_obj or dtrips > its:
        raise AssertionError(f"mc_batch {label}: the card and the CPU disagree")


def _same(a, b):
    """Equal shapes and equal entries (one host read)."""
    return a.shape == b.shape and bool((a == b).all())


def _trip_launches(run):
    """Run ``run()`` with every trip's band- and block-kernel launches
    recorded by the batch's gate state: ({(refine gate, centering gate):
    [launches of each trip]}, result of run)."""
    from score_tpu_torch.ops import band, blocks
    from score_tpu_torch.solver import ipm

    step = ipm._step_batch
    trips = {}
    kernels = band.KERNELS + blocks.KERNELS

    def recording(*a):
        before = {k.__name__: k.launches for k in kernels}
        out = step(*a)
        now = {k.__name__: k.launches for k in kernels}
        trips.setdefault((bool(a[7]), bool(a[8])), []).append(
            tuple(sorted((k, now[k] - v) for k, v in before.items() if now[k] > v)))
        return out

    ipm._step_batch = recording
    try:
        return trips, run()
    finally:
        ipm._step_batch = step


def phase_mc_batch(dev, kind="f64"):
    """The Monte-Carlo batch on the card. ``kind`` "f64" (``mc_batch``):
    the JAX package's bench row, 100 trials of the 4 x 50 world; "f32"
    (``mc_batch f32``): its stacks cast to float32 at the f32 mode's
    tolerances (the f32 band over the block kernels, the trials folded into
    its chain axis); "3d" (``mc_batch 3d``): 16 trials of 3D 4x250, each
    normalized, f64 (the band folded to C = 64 chains of Tp = 256, Db =
    12). (a) A small batch (16 trials; f32 8; 3d 2) against the port's CPU
    batch (:func:`_batch_lines_agree`); (b) the full batch, its kernel
    counts from zero: every lane solved (relgap <= 1e-6; f32 <= 1e-2),
    lanes 0-2 held to the card's single solves (the same status; pobj
    within 1e-6 relative plus 1e-8; 3d, whose objective is ~0, within 1e-6
    * max(1, |pobj|); f32 within 2e-2 * max(1, |pobj|) and, on a lane that
    ends OPTIMAL, iterations within 3), trips, the cold wall and five warm
    walls, ms per trial, each band and block kernel's launches per trip at
    each state of the two shared gates equal to a 1-trial batch's, host
    synchronizations of one batch solve <= trips + ``MC_SYNC_CONSTANT``;
    (c) for "f64", an 8-trial ``DenseBackend`` batch against the CPU's,
    and its peak memory. Returns the full batch's launches of every band
    and block kernel."""
    import torch
    from score_tpu_torch.ops import band, blocks
    from score_tpu_torch.parallel.batch import _solve_batch_trips
    from score_tpu_torch.solver.backend import DenseBackend
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend
    from score_tpu_torch.solver.ipm import OPTIMAL, SOLVED_STATUSES, solve_conic
    from score_tpu_torch.solver.params import ScoreSolverParams

    t_phase = time.perf_counter()
    f32 = kind == "f32"
    world, B, small = {"f64": ("mc", MC_TRIALS, 16), "f32": ("mc", MC_TRIALS, 8),
                       "3d": ("3d", MC3D_TRIALS, 2)}[kind]
    precision = "f32" if f32 else "f64"
    params = {"f64": _mc_params, "f32": _mc_f32_params,
              "3d": lambda: ScoreSolverParams().ipm_params()}[kind]()
    tag = "mc_batch" if kind == "f64" else f"mc_batch {kind}"
    cpu = torch.device("cpu")

    def make(seeds, device):
        return _mc_batch(seeds, device, world=world, precision=precision)

    def run(batch, ca, backend=ChainArrowBackend):
        return _solve_batch_trips(batch, params, backend, ca)

    # (a) a small batch, card against CPU
    batch, _, ca = make(range(small), dev)
    card, trips_c = run(batch, ca)
    hbatch, _, hca = make(range(small), cpu)
    t0 = time.perf_counter()
    host, trips_h = run(hbatch, hca)
    _log(f"{tag} {small} trials: cpu batch wall_s={time.perf_counter() - t0:.3f}")
    _batch_lines_agree(f"{small} trials" if kind == "f64" else f"{kind} {small} trials",
                       card, host, (trips_c, trips_h), f32=f32, flat=kind == "3d")

    # (b) the full batch: the main path, its counts from zero
    batch, singles, ca = make(range(B), dev)
    _reset_counts()
    t0 = time.perf_counter()
    res, trips = run(batch, ca)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches, by_size = _counts()
    kernels = {k.__name__: launches[k.__name__] for k in band.KERNELS + blocks.KERNELS}
    if f32:
        want = [f"block_chol[D={ca.D}]", f"block_chol_solve[D={ca.D}]"]
    else:
        want = [f"{k}[Db={ca.D}]" for k in _path_kernels(band.pad_length(ca.T), ca.D)]
    missing = [k for k in want if by_size[k] == 0]
    if missing:
        raise AssertionError(f"{tag}: kernels not launched by the batch: {missing}")
    status = res.status.cpu()
    relgap = (res.gap.double() / res.pobj.double().abs().clamp_min(1.0)).cpu()
    solved = sum(int(s) in SOLVED_STATUSES for s in status.tolist())
    _log(f"{tag} {B} trials: trips={trips} solved={solved}/{B} "
         f"statuses={sorted(set(status.tolist()))} max_relgap={relgap.max().item():.3e} "
         f"iterations min/max={res.iterations.min().item()}/{res.iterations.max().item()} "
         f"band C={B * ca.C} Tp={band.pad_length(ca.T)} D={ca.D} "
         f"launches={ {k: n for k, n in kernels.items() if n} }")
    if solved != B or not relgap.max().item() <= (MC_F32_RELGAP if f32 else 1e-6):
        raise AssertionError(f"{tag}: {solved} of {B} lanes solved, max relgap "
                             f"{relgap.max().item():.3e}")
    if not torch.isfinite(res.x).all() or res.x.shape != (B, singles[0].n):
        raise AssertionError(f"{tag}: bad x {tuple(res.x.shape)}")
    for lane, pb in enumerate(singles):
        one = solve_conic(pb, params, backend_aux=ca)
        lane_pobj, lane_its = res.pobj[lane].item(), res.iterations[lane].item()
        d = abs(one.pobj - lane_pobj)
        _log(f"{tag} lane {lane}: batch status/pobj={res.status[lane].item()}/{lane_pobj!r} "
             f"single {one.status}/{one.pobj!r} iterations batch/single={lane_its}/"
             f"{one.iterations} abs_diff={d:.3e} rel_diff={d / max(abs(one.pobj), 1.0):.3e}")
        if f32:  # iterations held where the lane ends OPTIMAL (see _batch_lines_agree)
            ok = ((one.status != OPTIMAL or abs(one.iterations - lane_its) <= 3)
                  and d <= 2e-2 * max(1.0, abs(one.pobj)))
        elif kind == "3d":  # an objective of ~0, at the roundoff of its constant
            ok = d <= 1e-6 * max(1.0, abs(one.pobj))
        else:
            ok = d <= 1e-6 * abs(one.pobj) + 1e-8
        if not (ok and one.status == res.status[lane].item()):
            raise AssertionError(f"{tag} lane {lane}: the batch and the single solve differ")
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        again, _ = run(batch, ca)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    if not _same(again.pobj, res.pobj):
        raise AssertionError(f"{tag}: a warm batch solve changed the digits")
    med = statistics.median(warm)
    _log(f"{tag} {B} trials: cold_s={cold:.3f} warm_s={[round(w, 3) for w in warm]} "
         f"median_warm_s={med:.3f} ms_per_trial={1e3 * med / B:.2f} "
         f"(cold {1e3 * cold / B:.2f})")

    # launches per trip, by the batch's gates, against a 1-trial batch
    one_batch, _, one_ca = make(range(1), dev)
    per_b, _ = _trip_launches(lambda: run(batch, ca))
    per1, (_, trips1) = _trip_launches(lambda: run(one_batch, one_ca))
    for gates in sorted(set(per_b) | set(per1)):
        _log(f"{tag} launches per trip at gates (refine, center)={gates}: "
             f"B={B} {sorted(set(per_b.get(gates, [])))} ({len(per_b.get(gates, []))} trips); "
             f"B=1 {sorted(set(per1.get(gates, [])))} ({len(per1.get(gates, []))} trips)")
    shared = set(per_b) & set(per1)
    if (False, False) not in shared or any(
            len(set(per_b[g]) | set(per1[g])) != 1 for g in shared):
        raise AssertionError(f"{tag}: launches per trip depend on the trial count")

    # host synchronizations of one warm batch solve
    out = {}
    syncs, sites = _sync_count(lambda: out.update(trips=run(batch, ca)[1]))
    _log(f"{tag} {B} trials: host_syncs={syncs} trips={out['trips']} "
         f"(limit trips + {MC_SYNC_CONSTANT}); 1-trial batch trips={trips1}; "
         f"sync sites {sites}")
    if syncs > out["trips"] + MC_SYNC_CONSTANT:
        raise AssertionError(f"{tag}: {syncs} host syncs for {out['trips']} trips")

    if kind == "f64":  # (c) the dense backend, 8 trials, card against CPU
        batch, _, _ = make(range(8), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        card, trips_c = run(batch, None, DenseBackend)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        hbatch, _, _ = make(range(8), cpu)
        t0 = time.perf_counter()
        host, trips_h = run(hbatch, None, DenseBackend)
        _log(f"{tag} dense 8 trials: card wall_s={wall:.3f} max_memory_allocated_GB={peak:.3f}; "
             f"cpu wall_s={time.perf_counter() - t0:.3f}")
        _batch_lines_agree("dense 8 trials", card, host, (trips_c, trips_h))
    _log(f"{tag}: phase wall_s={time.perf_counter() - t_phase:.1f}")
    return kernels


def _sync_count(fn):
    """Host synchronizations of ``fn()`` (``torch.cuda.set_sync_debug_mode``
    warnings): (count, {file:line: count})."""
    import collections
    import os
    import warnings

    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    synced = [w for w in caught if "synchroniz" in str(w.message)]
    return len(synced), dict(collections.Counter(
        f"{os.path.basename(w.filename)}:{w.lineno}" for w in synced))


def phase_trace(m4_fg, device="cuda"):
    """The solve trace on the card (``trace``): Manhattan-4 f64 SOCP on
    ``ChainArrowBackend`` (full width) and the 2 x 25 world on
    ``DenseBackend``, each through ``solve_conic_traced`` with two trips
    more than its solve needs: (num_iters, 13) finite metrics on the card,
    the converged row (the first with a terminal status) equal to the
    result's [pres, dres, gap, pobj] and repeated to the end; the traced
    result bit-equal to the untraced ``solve_conic`` and
    ``solve_conic_fixed`` of the same problem (x, pobj, status,
    iterations); host synchronizations of the traced solve <= the untraced
    fixed-trip solve's + 1; the 2 x 25 trace (and ``trace_solve``'s
    SolveTrace) against the port's CPU trace of the same world: the same
    status, iterations within 1, pobj within 1e-9 relative, pres and dres within
    1e-6 relative plus 1e-10, the gap within 1e-6 relative plus 1e-9 *
    max(1, |pobj|), the diagnostics within 1e-6 * max(1, |value|) (the CPU
    tests' bounds against the JAX package; where the iterations differ by
    one, the rows before the first converged); Manhattan-4's card trace
    against the CPU's in the same bounds. ``device`` "cpu" rehearses the
    phase without a card."""
    import torch
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.assembly.normalize import normalize_factor_graph
    from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world
    from score_tpu_torch.solver import solve_conic_traced
    from score_tpu_torch.solver.backend import DenseBackend
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu_torch.solver.ipm import solve_conic, solve_conic_fixed
    from score_tpu_torch.solver.params import ScoreSolverParams
    from score_tpu_torch.utils.telemetry import trace_solve

    t_phase = time.perf_counter()
    params = ScoreSolverParams().ipm_params()
    w2x25 = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1))

    def problem(fg, backend, device):
        pp, idx = build_conic_problem(normalize_factor_graph(fg)[0], "SOCP", device=device)
        return pp, (build_chain_arrow(pp, idx) if backend is ChainArrowBackend else None)

    def agree(label, m, ref, rows):
        """The first ``rows`` rows of two traces within the bounds above."""
        m, ref = m.cpu().numpy()[:rows], ref.cpu().numpy()[:rows]
        gap_tol = 1e-6 * np.abs(ref[:, 2]) + 1e-9 * np.maximum(1.0, np.abs(ref[:, 3]))
        diffs = dict(
            status=bool(np.array_equal(m[:, 4], ref[:, 4])),
            pobj=float(np.max(np.abs(m[:, 3] - ref[:, 3]) / np.abs(ref[:, 3]))),
            resid=float(np.max(np.abs(m[:, :2] - ref[:, :2]) / (1e-6 * np.abs(ref[:, :2])
                                                                + 1e-10))),
            gap=float(np.max(np.abs(m[:, 2] - ref[:, 2]) / gap_tol)),
            diag=float(np.max(np.abs(m[:, 5:] - ref[:, 5:])
                              / (1e-6 * np.maximum(1.0, np.abs(ref[:, 5:]))))))
        _log(f"trace {label} card vs cpu: statuses equal={diffs['status']} "
             f"pobj max_rel_diff={diffs['pobj']:.3e}; pres/dres, gap, diagnostics at "
             f"{diffs['resid']:.3f}, {diffs['gap']:.3f}, {diffs['diag']:.3f} of their bounds")
        if not (diffs["status"] and diffs["pobj"] <= 1e-9 and diffs["resid"] <= 1
                and diffs["gap"] <= 1 and diffs["diag"] <= 1):
            raise AssertionError(f"trace {label}: the card and the CPU traces disagree")

    for label, fg, backend in (("manhattan4", m4_fg, ChainArrowBackend),
                               ("2x25-dense", w2x25, DenseBackend)):
        pp, aux = problem(fg, backend, device)
        plain = solve_conic(pp, params, backend=backend, backend_aux=aux)
        trips = plain.iterations + 2
        t0 = time.perf_counter()
        res, metrics = solve_conic_traced(pp, params, num_iters=trips, backend=backend,
                                          backend_aux=aux)
        if metrics.is_cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        fixed = solve_conic_fixed(pp, params, num_iters=trips, backend=backend, backend_aux=aux)
        m = metrics.cpu().numpy()
        live = res.iterations
        ok = (metrics.device.type == device and m.shape == (trips, 13) and bool(np.isfinite(m).all())
              and m[live, :4].tolist() == [res.pres, res.dres, res.gap, res.pobj]
              and bool(np.all(m[live:] == m[live])) and bool(np.all(m[:live, 4] == 0)))
        same = all((a.status, a.iterations, a.pobj, a.gap) == (res.status, res.iterations,
                                                              res.pobj, res.gap)
                   and torch.equal(a.x, res.x) for a in (plain, fixed))
        syncs_t, sites_t = _sync_count(lambda: solve_conic_traced(
            pp, params, num_iters=trips, backend=backend, backend_aux=aux))
        syncs_u, sites_u = _sync_count(lambda: solve_conic_fixed(
            pp, params, num_iters=trips, backend=backend, backend_aux=aux))
        _log(f"trace {label}: trips={trips} status={res.status} iterations={res.iterations} "
             f"pobj={res.pobj!r} wall_s={wall:.3f} rows ok={ok} untraced digits equal={same} "
             f"host_syncs traced/untraced={syncs_t}/{syncs_u} sites {sites_t} / {sites_u}")
        _log(f"trace {label} rows [alpha, nbhd_frac, sigma, gap_aff/gap, min_detprod/mu^2, "
             f"centering, alpha_pre, newton_resid]: "
             + "; ".join(", ".join(f"{v:.3g}" for v in row[5:]) for row in m[:live]))
        if not (ok and same and syncs_t <= syncs_u + 1):
            raise AssertionError(f"trace {label}: rows ok={ok}, untraced digits equal={same}, "
                                 f"host syncs {syncs_t} traced against {syncs_u}")
        hp, haux = problem(fg, backend, "cpu")
        t0 = time.perf_counter()
        hres, hmetrics = solve_conic_traced(hp, params, num_iters=trips, backend=backend,
                                            backend_aux=haux)
        _log(f"trace {label} cpu: iterations={hres.iterations} wall_s="
             f"{time.perf_counter() - t0:.3f}")
        if hres.status != res.status or abs(hres.iterations - res.iterations) > 1:
            raise AssertionError(f"trace {label}: card {res.status}/{res.iterations}, cpu "
                                 f"{hres.status}/{hres.iterations}")
        # every row where the two converge together, else the rows before
        # the first of them converged
        agree(label, metrics, hmetrics,
              trips if hres.iterations == res.iterations else min(live, hres.iterations))
        if backend is DenseBackend:  # trace_solve: the dense backend by default
            _, trace = trace_solve(pp, params, num_iters=trips)
            if not (np.array_equal(trace.pobj, m[:, 3]) and trace.iterations == res.iterations
                    and len(trace.as_dict()["gap"]) == res.iterations + 1):
                raise AssertionError("trace: trace_solve's SolveTrace is not the traced solve's")
    _log(f"trace: phase wall_s={time.perf_counter() - t_phase:.1f}")


# ------------------------------------------------------------------ #
# The sharded solves (phase ``sharded``)
# ------------------------------------------------------------------ #


# a trial-sharded lane against the same lane of the unsharded batch on the
# card: the lane's arithmetic is the same, but the card's reductions over a
# batch (torch's reduction kernels, cuBLAS's batched products) choose their
# summation order by the batch's size, so a lane of a 50-trial rank differs
# from it in the last bits, which the IPM's 15 trips amplify (9.7e-11 on
# an NVIDIA H100 80GB HBM3 at 700 W); the bound is the one the card's batch
# is held to against the port's CPU batch (``_batch_lines_agree``)
SHARDED_LANE_TOL = 1e-9
# rank 0's lanes against the same trials solved unsharded as a batch of the
# rank's size: the same batch size, so the same summation order
SHARDED_RANK_LANE_TOL = 1e-12


def _sync(device):
    """Wait for ``device``'s work (nothing to wait for on the CPU)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(obj, device):
    """A copy of a dataclass (a ConicProblem, a ChainArrowStructure) with
    every tensor field on ``device``."""
    import dataclasses

    import torch

    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).to(device)
                                       for f in dataclasses.fields(obj)
                                       if isinstance(getattr(obj, f.name), torch.Tensor)})


def _counting_backend():
    """``ChainArrowBackend`` counting its factorizations and KKT solves."""
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend

    class Counting(ChainArrowBackend):
        factors = solves = 0

        @staticmethod
        def factor(*a):
            Counting.factors += 1
            return ChainArrowBackend.factor(*a)

        @staticmethod
        def solve(*a):
            Counting.solves += 1
            return ChainArrowBackend.solve(*a)

    return Counting


def _sharded_run(solve, device, backend_counts):
    """A warm-up call of ``solve`` on this rank, then a timed one with the
    kernel launches, the all_reduce calls and bytes and the KKT counts set
    to 0 just before it: {result, wall, calls, bytes, factors, solves,
    launches of every rank}."""
    import torch
    import torch.distributed as dist
    from score_tpu_torch.solver import collective

    solve()
    _sync(device)
    _reset_counts()
    collective.reset_counts()
    backend_counts.factors = backend_counts.solves = 0
    dist.barrier()
    t0 = time.perf_counter()
    res = solve()
    _sync(device)
    wall = time.perf_counter() - t0
    calls, nbytes = collective.all_reduce.calls, collective.all_reduce.bytes
    launches = {k: v for k, v in _counts()[0].items() if v}
    ranks = [None] * dist.get_world_size()
    dist.all_gather_object(ranks, launches)
    return dict(result=res, wall=wall, calls=calls, bytes=nbytes,
                factors=backend_counts.factors, solves=backend_counts.solves, launches=ranks)


def _warm_wall(solve, device):
    """(result, seconds) of a second call of ``solve``, after a first."""
    solve()
    _sync(device)
    t0 = time.perf_counter()
    res = solve()
    _sync(device)
    return res, time.perf_counter() - t0


def _sharded_rank(device, robot20, mc):
    """A rank of phase ``sharded``: robot20 chain-sharded and the
    Monte-Carlo batch trial-sharded, on ``device`` (run_ranks); then rank 0
    alone times both unsharded, in the same process (a fresh process's
    walls differ from the smoke's own after its earlier phases)."""
    import torch.distributed as dist
    from score_tpu_torch.parallel import solve_conic_chain_sharded
    from score_tpu_torch.parallel.batch import _solve_batch_trips, _solve_sharded_trips
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu_torch.solver.ipm import solve_conic
    from score_tpu_torch.solver.params import ScoreSolverParams

    problem, idx = _to_device(robot20[0], device), robot20[1]
    batch, ca = (_to_device(t, device) for t in mc)
    counting = _counting_backend()
    params = ScoreSolverParams().ipm_params()
    out = {
        "robot20": _sharded_run(lambda: solve_conic_chain_sharded(
            problem, idx, params, backend=counting), device, counting),
        "mc": _sharded_run(lambda: _solve_sharded_trips(
            batch, _mc_params(), counting, ca), device, counting),
    }
    if dist.get_rank() == 0:
        out["robot20"]["unsharded_wall"] = _warm_wall(lambda: solve_conic(
            problem, params, backend=ChainArrowBackend,
            backend_aux=build_chain_arrow(problem, idx)), device)[1]
        out["mc"]["unsharded_wall"] = _warm_wall(lambda: _solve_batch_trips(
            batch, _mc_params(), ChainArrowBackend, ca), device)[1]
    dist.barrier()
    return out


def phase_sharded(dev, robot20_fg):
    """The sharded solves (``score_tpu_torch.parallel``), each beside the
    unsharded solve of the same problem on the card: robot20 SOCP f64
    (normalized, as ``solve_score`` solves it; C = 20) chain-sharded with
    ``solve_conic_chain_sharded``, and the 100-trial Monte-Carlo batch
    (``ChainArrowBackend``) trial-sharded with ``solve_conic_sharded``,
    (a) over gloo at world 2, both ranks on the one card (10 chains, 50
    trials a rank), (b) over NCCL at world = the card count. robot20: the
    same status and iterations as the unsharded solve, relgap <= 1e-6,
    pobj within 1e-9 relative; the batch: every lane's status and
    iterations, pobj within ``SHARDED_LANE_TOL`` relative, the same trips;
    and rank 0's lanes against the same trials solved unsharded as a batch
    of the rank's size (at world 2 the first half of the trials, also
    printed against the same lanes of the 100-trial batch): every lane's
    status and iterations, pobj within ``SHARDED_RANK_LANE_TOL``. Every band
    kernel of the path launched on every rank; all_reduce calls = factors
    + 2 x KKT solves (the Schur complement a factor, the arrow rhs and the
    chain solution a solve) and, in the batch, trips + 9 (the trip's flags,
    then the result's fields). Prints the walls (a warm call, after one on
    the rank; the unsharded solves also in rank 0's process, which is as
    fresh as the sharded ones'), the all_reduce calls and bytes per
    factor, KKT solve and trip, and every rank's launches."""
    import dataclasses

    import torch
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.assembly.normalize import normalize_factor_graph
    from score_tpu_torch.ops.band import pad_length
    from score_tpu_torch.parallel import run_ranks
    from score_tpu_torch.parallel.batch import _DATA_FIELDS, _solve_batch_trips
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu_torch.solver.ipm import solve_conic
    from score_tpu_torch.solver.params import ScoreSolverParams

    problem, idx = build_conic_problem(normalize_factor_graph(robot20_fg)[0], "SOCP",
                                       device="cpu")
    batch, _, ca = _mc_batch(range(MC_TRIALS), "cpu")
    params = ScoreSolverParams().ipm_params()
    st = build_chain_arrow(problem, idx)
    band_shape = {"robot20": (st.C, pad_length(st.T), st.A, st.D),
                  "mc": (ca.C, pad_length(ca.T), ca.A, ca.D)}

    p_dev, b_dev, ca_dev = (_to_device(t, dev) for t in (problem, batch, ca))
    want = {"robot20": _warm_wall(lambda: solve_conic(
        p_dev, params, backend=ChainArrowBackend, backend_aux=build_chain_arrow(p_dev, idx)),
        dev),
        "mc": _warm_wall(lambda: _solve_batch_trips(b_dev, _mc_params(), ChainArrowBackend,
                                                    ca_dev), dev)}
    # rank 0's trials solved unsharded as a batch of a rank's size; at world
    # 2, what the batch size alone does to a lane
    worlds = (("gloo", 2), ("nccl", torch.cuda.device_count()))
    rank0 = {MC_TRIALS: want["mc"][0]}
    for n in {MC_TRIALS // w for _, w in worlds} - set(rank0):
        rank0[n] = _warm_wall(lambda: _solve_batch_trips(
            dataclasses.replace(b_dev, **{f: getattr(b_dev, f)[:n] for f in _DATA_FIELDS}),
            _mc_params(), ChainArrowBackend, ca_dev), dev)[0]
    half = MC_TRIALS // 2
    (h, htrips), (u, utrips) = rank0[half], want["mc"][0]
    _log(f"unsharded mc: trials 0-{half - 1} as a batch of {half} against the same lanes of "
         f"the {MC_TRIALS}-trial batch: statuses and iterations equal: "
         f"{_same(h.status, u.status[:half]) and _same(h.iterations, u.iterations[:half])}; "
         f"max_rel_pobj_diff={((h.pobj - u.pobj[:half]).abs() / u.pobj[:half].abs()).max():.3e}"
         f"; trips {htrips} / {utrips}")
    for backend, world in worlds:
        t0 = time.perf_counter()
        got = run_ranks(_sharded_rank, world, device="cuda", backend=backend,
                        args=((problem, idx), (batch, ca)), timeout=600)
        call_s = time.perf_counter() - t0
        tag = f"sharded {backend} world={world}"
        for case in ("robot20", "mc"):
            g, (w, wall) = got[case], want[case]
            C, Tp, A, Db = band_shape[case]
            idle = [(r, k) for r, la in enumerate(g["launches"]) for k in _path_kernels(Tp, Db)
                    if not la.get(k)]
            if idle:
                raise AssertionError(f"{tag} {case}: kernels not launched on (rank, kernel) "
                                     f"{idle}")
            if case == "robot20":
                r, u = g["result"], w
                relgap = r.gap / max(1.0, abs(r.pobj))
                dobj = abs(r.pobj - u.pobj) / abs(u.pobj)
                # the Schur complement's B'Z a factor; B'w and the chain
                # solution (C, T, D) a KKT solve
                per_factor, per_solve = A * A * 8, (A + C * st.T * Db) * 8
                want_calls = g["factors"] + 2 * g["solves"]
                want_bytes = g["factors"] * per_factor + g["solves"] * per_solve
                per = f"per factor 1 call {per_factor} B, per KKT solve 2 calls {per_solve} B"
                _log(f"{tag} robot20: status={r.status} iterations={r.iterations} "
                     f"relgap={relgap:.3e} pobj={r.pobj:.12e} unsharded status={u.status} "
                     f"iterations={u.iterations} pobj={u.pobj:.12e} rel_pobj_diff={dobj:.3e} "
                     f"wall_s sharded={g['wall']:.3f} unsharded={g['unsharded_wall']:.3f} "
                     f"(rank 0's process; in this one {wall:.3f})")
                _log(f"{tag} robot20: all_reduce calls={g['calls']} bytes={g['bytes']} for "
                     f"{g['factors']} factors and {g['solves']} KKT solves ({per})")
                if (r.status, r.iterations) != (u.status, u.iterations) or not (
                        relgap <= 1e-6 and dobj <= 1e-9) or (g["calls"], g["bytes"]) != (
                        want_calls, want_bytes):
                    raise AssertionError(f"{tag} robot20: the sharded solve disagrees")
            else:
                (r, trips), (u, utrips) = g["result"], w
                dobj = ((r.pobj - u.pobj.cpu()).abs() / u.pobj.cpu().abs()).max().item()
                same = (torch.equal(r.status, u.status.cpu())
                        and torch.equal(r.iterations, u.iterations.cpu()))
                _log(f"{tag} mc: {MC_TRIALS} trials, {MC_TRIALS // world} a rank, trips "
                     f"sharded={trips} unsharded={utrips}; statuses and iterations equal: "
                     f"{same}; max_rel_pobj_diff={dobj:.3e}; wall_s sharded={g['wall']:.3f} "
                     f"unsharded={g['unsharded_wall']:.3f} (rank 0's process; in this one "
                     f"{wall:.3f}; {g['wall'] / MC_TRIALS * 1e3:.2f} / "
                     f"{g['unsharded_wall'] / MC_TRIALS * 1e3:.2f} ms a trial)")
                _log(f"{tag} mc: all_reduce calls={g['calls']} bytes={g['bytes']} "
                     f"(per trip 1 call of 4 int32 flags, 16 B; then "
                     f"{g['calls'] - trips} gathers of the result)")
                n = MC_TRIALS // world
                h, htrips = rank0[n]
                hp = h.pobj.cpu()
                d0 = ((r.pobj[:n] - hp).abs() / hp.abs()).max().item()
                same0 = (torch.equal(r.status[:n], h.status.cpu())
                         and torch.equal(r.iterations[:n], h.iterations.cpu()))
                _log(f"{tag} mc: rank 0's {n} lanes against the same trials as an unsharded "
                     f"batch of {n}: statuses and iterations equal: {same0}; "
                     f"max_rel_pobj_diff={d0:.3e}; pobj bit-equal: "
                     f"{torch.equal(r.pobj[:n], hp)}; trips {trips} / {htrips}")
                if not same or not dobj <= SHARDED_LANE_TOL or trips != utrips or \
                        g["calls"] != trips + 9 or not same0 or not d0 <= SHARDED_RANK_LANE_TOL:
                    raise AssertionError(f"{tag} mc: the sharded batch disagrees")
            for rank, la in enumerate(g["launches"]):
                _log(f"{tag} {case}: rank {rank} launches {la}")
        _log(f"{tag}: run_ranks call {call_s:.1f} s (spawn, import, both cases twice)")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(smi)
    _log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
         f"{torch.cuda.get_device_name(0)}")

    from score_tpu_torch.ops import band, build

    t_start = time.perf_counter()

    def elapsed(after):
        _log(f"elapsed_s={time.perf_counter() - t_start:.1f} after {after}")

    t0 = time.perf_counter()
    built = build.compile_all(force=True)
    _log(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} libraries, in parallel")
    for name, (path, seconds, log) in built.items():
        _log(f"build {name}: {seconds:.2f} s -> {path.name}")
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                _log("  ptxas:", line.strip())

    # registers and spills of every band kernel at each block size (the
    # wide and narrow band_pcr_solve and the lane-group band_block_inv,
    # band_pcr_level and band_cr_level at Db = 6, the cluster
    # band_pcr_solve and the element band_block_inv, band_pcr_level and
    # band_cr_level at Db = 12), of block_chol, and of both block kernels
    # at the 3D sizes (D = 12: block_chol's chol_lanes_kernel, block_chol_solve's
    # tri_solve_tile_kernel<12, BACK, U> and tri_solve_lanes_kernel<12,
    # BACK>; D = 3: chol_kernel, tri_solve_kernel<3, V, BACK>; the worst over
    # the other template arguments)
    only = {"pcr_solve_wide_kernel": 6, "pcr_solve_narrow_kernel": 6, "pcr_level_kernel": 6,
            "block_inv_kernel": 6, "cr_level_kernel": 6, "cr_factor_kernel": 6,
            "pcr_solve_cluster_kernel": 12, "pcr_level_element_kernel": 12,
            "block_inv_element_kernel": 12, "cr_level_element_kernel": 12,
            "cr_backsub_element_kernel": 12, "cr_backsub_wide_kernel": 6}
    checks = [("band", wrapper, kern, Db) for Db in (6, 12)
              for wrapper, kern in (("band_init_a", "init_a_kernel"),
                                    ("band_block_inv", "block_inv_kernel"),
                                    ("band_block_inv", "block_inv_element_kernel"),
                                    ("band_pcr_level", "pcr_level_kernel"),
                                    ("band_pcr_level", "pcr_level_element_kernel"),
                                    ("band_cr_level", "cr_level_kernel"),
                                    ("band_cr_level", "cr_level_element_kernel"),
                                    ("band_cr_factor", "cr_factor_kernel"),
                                    ("band_cr_reduce", "cr_reduce_levels_kernel"),
                                    ("band_cr_reduce", "cr_reduce_tree_kernel"),
                                    ("band_pcr_solve", "pcr_solve_wide_kernel"),
                                    ("band_pcr_solve", "pcr_solve_narrow_kernel"),
                                    ("band_pcr_solve", "pcr_solve_cluster_kernel"),
                                    ("band_cr_backsub", "cr_backsub_narrow_kernel"),
                                    ("band_cr_backsub", "cr_backsub_wide_kernel"),
                                    ("band_cr_backsub", "cr_backsub_levels_kernel"),
                                    ("band_cr_backsub", "cr_backsub_element_kernel"),
                                    ("band_cr_backsub", "cr_backsub_chain_kernel"),
                                    ("band_cr_backsub", "cr_backsub_lanes_kernel"))
              if only.get(kern, Db) == Db]
    checks += [("blocks", "block_chol", "chol_kernel", None)]
    checks += [("blocks", wrapper, kern, 12)
               for wrapper, kern in (("block_chol", "chol_lanes_kernel"),
                                     ("block_chol_solve", "tri_solve_tile_kernel"),
                                     ("block_chol_solve", "tri_solve_lanes_kernel"))]
    checks += [("blocks", wrapper, kern, 3)
               for wrapper, kern in (("block_chol", "chol_kernel"),
                                     ("block_chol_solve", "tri_solve_kernel"))]
    for lib, wrapper, kern, Db in checks:
        regs, stores, loads = _ptxas_report(built[lib][2], kern, Db)
        at = "" if Db is None else f", {'Db' if lib == 'band' else 'D'}={Db}"
        _log(f"ptxas {wrapper} ({kern}{at}): registers={regs} spill_store_bytes={stores} "
             f"spill_load_bytes={loads}")
        if stores or loads:
            raise AssertionError(f"{kern}{at}: ptxas reports spills")

    dev = torch.device("cuda")
    cells = [(label, fg, _band_shape(fg)) for label, fg in _cells()]
    cells_3d = [(label, fg, _band_shape(fg)) for label, fg in _cells_3d()]
    if "--refine" in sys.argv[1:]:  # the refinement stage alone
        phase_refine(_refine_cells(cells, cells_3d))
        return 0
    if "--sharded" in sys.argv[1:]:  # the sharded solves alone
        phase_sharded(dev, cells[1][1])
        return 0
    c4, tp4, a4, _ = cells_3d[0][2]
    mc3d_band = (c4 * MC3D_TRIALS, tp4, a4, 12)  # the 3D batch's fold
    if "--mc" in sys.argv[1:]:  # the Monte-Carlo batches alone
        phase_kernels("mc", *MC_BAND, 6, dev)
        phase_kernels("mc3d", *mc3d_band, dev)
        phase_blocks(dev)
        phase_mc_batch(dev)
        phase_mc_batch(dev, "f32")
        phase_mc_batch(dev, "3d")
        return 0
    rows = {}
    for label, fg, shape in cells + cells_3d:
        rows[label] = phase_kernels(label, *shape, dev)
    rows["mc"] = phase_kernels("mc", *MC_BAND, 6, dev)  # the batch's fold
    rows["mc3d"] = phase_kernels("mc3d", *mc3d_band, dev)
    # a band-solve pass at every cell, K = 1 and the panel, beside the
    # parent's design
    for label, shape in [(lb, sh) for lb, _, sh in cells + cells_3d] + [
            ("mc", MC_BAND + (6,)), ("mc3d", mc3d_band)]:
        C, Tp, K, Db = shape
        for name, keys in phase_pass(label, C, Tp, Db, K, dev).items():
            rows[label][name].update(keys)
    # band_pcr_level, on no solve path at the default schedule: held to its
    # twin and timed at the shapes of the earlier remainder (EARLIER_BASE)
    earlier = {label: phase_kernels(f"{label} remainder {EARLIER_BASE}", *shape, dev,
                                    n_cr=_depth_to(shape[1], EARLIER_BASE))
               for label, shape in (("manhattan4", cells[0][2]), ("3d-1x1000", cells_3d[1][2]),
                                    ("mc", MC_BAND + (6,)))}
    for Db in (6, 12):
        phase_edge_shapes(Db, dev)
        phase_cr_levels(Db, dev)
    block_rows = phase_blocks(dev)
    launch_floor_us = _launch_floor_us(dev)
    _log(f"launch_floor_us={launch_floor_us:.2f} (a one-element add_ in the device-time "
         f"harness: 20 launches in a replayed CUDA graph)")
    elapsed("the build and the kernel checks")
    if "--kernels" in sys.argv[1:]:  # stop after the kernels' checks
        return 0
    phase_f32_band(dev, 4, 512, 6, 138)  # Manhattan-4's band
    phase_f32_band(dev, 4, 256, 12, 18)  # 3D 4x250's band
    phase_small_reference()
    phase_small_reference_3d()

    launches, results = {}, {}
    for label, fg, shape in cells:
        launches[label], results[label] = phase_solve(label, fg, shape[1])
    m4_fg, m4_Tp = cells[0][1], cells[0][2][1]
    _, results["manhattan4-qcqp"] = phase_solve("manhattan4-qcqp", m4_fg, m4_Tp,
                                                relaxation="QCQP")
    # 3D in f64: 4x250 as SOCP and QCQP, 1x1000 as SOCP (its QCQP is left
    # out for time)
    for (label, fg, shape), relaxations in zip(cells_3d, (("SOCP", "QCQP"), ("SOCP",))):
        for relaxation in relaxations:
            name = label if relaxation == "SOCP" else f"{label}-qcqp"
            launches[name], results[name] = phase_solve(name, fg, shape[1], shape[3],
                                                        relaxation=relaxation)
    launches["manhattan4-f32"], _ = phase_solve(
        "manhattan4-f32", m4_fg, m4_Tp, relaxation="SOCP", precision="f32",
        reference=results["manhattan4"])
    phase_solve("manhattan4-qcqp-f32", m4_fg, m4_Tp, relaxation="QCQP", precision="f32",
                reference=results["manhattan4-qcqp"])
    # 3D in f32: 4x250 as SOCP and QCQP (which ends unsolved in both
    # packages), 1x1000 as SOCP, each beside the port's CPU f32 run; the
    # objectives of these worlds sit near 0, so the f64 one is printed
    # beside and not compared
    for (label, fg, shape), relaxations in zip(cells_3d, (("SOCP", "QCQP"), ("SOCP",))):
        for relaxation in relaxations:
            name = (label if relaxation == "SOCP" else f"{label}-qcqp") + "-f32"
            launches[name], res = phase_solve(
                name, fg, shape[1], relaxation=relaxation, precision="f32",
                cpu_reference=True, must_solve=relaxation == "SOCP")
            f64 = results[name[:-len("-f32")]]
            _log(f"{name}: f32 objective {res.primal_objective:.6f} beside f64 "
                 f"{f64.primal_objective:.6f}")
    phase_small_f32_reference()
    elapsed("the solves")
    phase_api(m4_fg, cells_3d[0][1], cells_3d[1][1], results)
    phase_trace(m4_fg)
    elapsed("api and trace")
    phase_refine(_refine_cells(cells, cells_3d), results)
    elapsed("refine")
    mc_launches = phase_mc_batch(dev)
    f32_launches = phase_mc_batch(dev, "f32")
    mc3d_launches = phase_mc_batch(dev, "3d")
    elapsed("mc_batch")
    phase_sharded(dev, cells[1][1])
    elapsed("sharded")

    # band kernels: launches from the f64 Manhattan-4 SOCP solve, times at
    # its band shape, and at Db = 12 launches from the 3D 1x1000 SOCP solve,
    # times at its band shape; block kernels: launches from the f32
    # Manhattan-4 SOCP solve (none of the forward-only block_tri_lower_solve,
    # whose callers all run the fused block_chol_solve), times at its first
    # level's shapes, and at D = 12 and D = 3 launches from the f32 3D 4x250
    # QCQP solve, times at its first level's and its pivots' shapes
    timed = {**rows["manhattan4"], **block_rows}
    timed.update({name.replace("[tail]", "[Db=12 tail]") if name.endswith("[tail]")
                  else f"{name}[Db=12]": r for name, r in rows["3d-1x1000"].items()})
    fold = lambda name, tag: (name.replace("[tail]", f"[{tag} tail]") if name.endswith("[tail]")
                              else f"{name}[{tag}]")
    for tag in ("mc", "mc3d"):
        timed.update({fold(name, tag): r for name, r in rows[tag].items()})
    for key, suffix in (("manhattan4", ""), ("3d-1x1000", "[Db=12]"), ("mc", "[mc]")):
        timed[f"band_pcr_level{suffix}"] = dict(earlier[key]["band_pcr_level"],
                                                note=PCR_LEVEL_NOTE)
    # band_cr_factor is built for Db = 6 only: no Db = 12 or mc3d row
    # a run's own row where a solve takes two: the Manhattan-4 factor's last
    # (band_cr_reduce and band_cr_backsub take a pass in one run on every cell)
    tails = [name for name in ("band_cr_factor[tail]", "band_cr_reduce[tail]",
                               "band_cr_backsub[tail]", "band_cr_reduce[Db=12 tail]",
                               "band_cr_backsub[Db=12 tail]") if name in timed]
    names = (list(REPLACES) + [f"{k.__name__}[Db=12]" for k in band.KERNELS
                               if k is not band.band_cr_factor] + tails
             + [f"{k}[D={D}]" for k in ("block_chol", "block_chol_solve") for D in (12, 3)]
             + [f"{k.__name__}[mc]" for k in band.KERNELS
                if k.__name__ in rows["mc"] or k is band.band_pcr_level]
             + [fold(k, "mc3d") for k in rows["mc3d"]]
             + [f"{k}[mc-f32]" for k in ("block_chol", "block_chol_solve")])
    kernels = []
    for name in names:
        base = name.split("[")[0]
        row = timed[name]
        if name.endswith("tail]"):  # launches of the last run per Manhattan-4 / 3D 1x1000 solve
            key, (_, fg, shape) = (("3d-1x1000", cells_3d[1]) if "Db=12" in name
                                   else ("manhattan4", cells[0]))
            source, launched = BAND_SOURCE, launches[key].get(
                f"{base}[run={_tail_run(shape[1], shape[3], base)}]", 0)
        elif name.endswith("[mc-f32]"):  # launches per 100-trial f32 batch solve
            source, launched = BLOCKS_SOURCE, f32_launches[base]
        elif name.endswith("[mc3d]"):  # launches per 16-trial 3D 4x250 batch solve
            source, launched = BAND_SOURCE, mc3d_launches[base]
        elif name.endswith("[mc]"):  # launches per 100-trial batch solve
            source, launched = BAND_SOURCE, mc_launches[base]
        elif base.startswith("block_"):
            source = BLOCKS_SOURCE
            launched = (launches["manhattan4-f32"][base] if name == base
                        else launches["3d-4x250-qcqp-f32"][name])
        elif name == base:
            source, launched = BAND_SOURCE, launches["manhattan4"][f"{base}[Db=6]"]
        else:
            source, launched = BAND_SOURCE, launches["3d-1x1000"][name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=REPLACES[base],
            launches=launched, max_abs_err=row["max_abs_err"], ms=row["ms"],
            device_us=row["device_us"], plain_ms=row["plain_ms"],
            bound_ms=row["bound_ms"], bound_by=row["bound_by"],
            library_ms=row["library_ms"], library_us=row["library_us"],
            **{k: v for k, v in row.items()
               if k.startswith(("k1_", "factor_", "parent_", "pass_", "cold_")) or k == "note"}))
    _log(f"launch_floor_us={launch_floor_us:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
