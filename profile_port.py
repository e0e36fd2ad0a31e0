#!/usr/bin/env python3
"""Where the port's SOCP solve spends its time on one GPU, and what the
band's compaction depth costs.

    python3 profile_port.py [--out report.json]

For each instance of ``chip_smoke.py`` (Manhattan-4, robot20):

1. host assembly times (``build_conic_problem``, ``build_chain_arrow``);
2. three unprofiled warm solves (host clock around ``solve_score`` and a
   device sync), then one warm solve under ``torch.profiler``: device busy
   time (self device time of all kernels), kernel launches, the ops with
   the most device time, and the band kernels' device time and launches;
3. the band alone at the instance's band shape, for every compaction
   depth from 0 to log2(Tp): median ms of a factor, a panel solve
   (K = arrow width) and a direction solve (K = 1) by CUDA events, and
   the kernel launches each takes;
4. warm solves with the band forced to depth 0, depth 1, the default
   depth and the deepest depth, taking turns.

Then the f32 fast mode (``precision="f32"``) on Manhattan-4, SOCP: three
unprofiled warm solves and one profiled warm solve, with the block
kernels' device time and launches.

Prints a summary, and with ``--out`` writes everything as JSON. Needs a
CUDA card; imports nothing of jax or of the JAX package.

    python3 profile_port.py --kernels [--root DIR]

times only the redesigned kernels: of the f64 band ``band_block_inv``,
``band_pcr_level`` (first and last level) and ``band_pcr_solve`` (a
direction, K = 1, and the arrow panel) at the PCR remainder's shape of
both instances,
``band_cr_level`` at Manhattan-4's first level and at the deeper levels'
and robot20's shapes of the depth sweep, at Db = 12 ``band_cr_level`` at
3D 1x1000's two levels and the 3D fold's first (also at each tiling it is
built for, ``band._cr_level_tile`` forced to 1 and 3 coarse positions a
thread block, held bit for bit to the planner's) and ``band_block_inv`` at the
3D remainders (C = 1 and 4 chains of 256), both also from a build without
their shared element inversion (``-DBAND_LEVEL_NO_INVERSE``), ``band_cr_reduce`` and
``band_cr_backsub`` (one solve's launches: one each with the fused
kernels, one a level in a checkout from before them, also each level
alone) at Manhattan-4's direction and panel, at a forced level of robot20
and of a long chain, on a Db = 6 chain with two levels and at 3D 1x1000's
two levels, with the fused kernels also from builds of ``band.cu`` that
take one layout (``_CR_BUILDS``: the reduce's two, the element backsub's
row a thread) and one that records each phase's clock; of the f32 band its Cholesky solve
``solver.pcr._dinv`` (one launch of ``block_chol_solve``; in a checkout
from before that kernel, the forward kernel and the plain back
substitution) at the first level's shapes, and ``block_chol`` at every
Cholesky of a Manhattan-4 factor (on contiguous blocks, and through
``smallblocks.chol_small`` on the odd-row view the factor passes) and at
QCQP's D = 2 pivots; then the block kernels at D = 12 at 3D 4x250's
factor shapes (``_blocks12_times``: ``block_chol`` at every Cholesky,
``block_chol_solve`` at K = 18, 12, 1, a level's two solves, and each of
the solve's two D = 12 layouts alone, from builds of ``blocks.cu`` with
``-DBLOCKS_WIDE_COLUMNS``). Device time per launch from a
replayed CUDA graph (``chip_smoke._device_us``) and event time around the
call. ``--root DIR`` imports ``score_tpu_torch`` from another checkout, so
that two commits are timed on one card in one call.

    python3 profile_port.py --cr [--root DIR] [--out FILE]

times ``band_cr_reduce`` and ``band_cr_backsub`` alone at every run of the
cells' solves (``_CR_SOLVE_SHAPES``: the Monte-Carlo folds, Manhattan-4's
and 3D 1x1000's two runs, robot20, 3D 4x250; a direction and the panel):
device us, event ms and launches a call; the reduce's layouts and the
chain back substitution's rows a thread from measurement builds of
``band.cu``; the clock build's phases (``_cr_clocks``). With ``--root``
in turns against another checkout (parent, change, change, parent).

    python3 profile_port.py --cr --pass [--sweep] [--tally] [--clocks] [--root DIR] [--out FILE]

times one band-solve pass at the default schedule (``band._cr_runs``, as
``band._band_solve_once`` makes it) at ``_PASS_CELLS`` (Manhattan-4,
robot20, 3D 4x250, 3D 1x1000, the 2D and 3D folds) at K = 1, 2 and the
panel width: device us of the pass's ``band_cr_reduce`` launches
together, its ``band_pcr_solve``, its ``band_cr_backsub`` launches, and
each launch alone; launches a pass by kernel; the pass's bound (each
kernel's bytes over 3.35 TB/s). With ``--sweep`` also the chain kernels'
plans of ``_PASS_SWEEP`` (tree reduces, back-substitution segments)
beside the planner's, and the reduce from the builds of ``_PASS_BUILDS``,
each held to the twins. With ``--tally`` also the band-solve
passes of a Manhattan-4, robot20, 3D 4x250 and 3D 1x1000 f64 SOCP solve
by rhs width, and the CR kernels' launches a solve. With ``--clocks``
also the clock build's phases (``-DBAND_CR_CLOCKS``) of each launch of the
passes of ``_PASS_CLOCKS``. With ``--root`` in turns against another
checkout (parent, change, change, parent: one process each).

    python3 profile_port.py --factor [--builds] [--root DIR] [--out FILE]

times the band factor alone (``band_factor`` at the default schedule,
``band_init_a`` excluded: it is replaced by the A it gave) at
``_FACTOR_CELLS``, the cells' factors (Manhattan-4, robot20, 3D 4x250, 3D
1x1000, the 2D and 3D folds): device us of the whole factor, its launches
and its bound (D, A, C read once, every level's E, F, invD, A, C and the
last invD written once), then each of its launches alone as the factor
feeds it (where ``band._factor_takes`` gives the factor to
``band_cr_factor``, Db = 6: each run of ``band._factor_runs``; at Db = 12
and before it: each ``band_cr_level`` level and ``band_block_inv``), and
at the 3D fold the factor and its levels at each tiling of
``band_cr_level`` (``_forced_tile``: P = 1, the parent's, and 3). With
``--builds`` also the measurement builds of ``_FACTOR_BUILDS`` (the
inversions compiled out; the clock build, whose phases, SM cycles of
thread block 0, print for each run) and the plans of ``_FACTOR_SWEEP``
(the most levels of the last run). With ``--root`` in turns against
another checkout (parent, change, change, parent).

    python3 profile_port.py --schedule [--out FILE]

prices the band's compaction floor: Manhattan-4, robot20, 3D 4x250 and
3D 1x1000 (f64 SOCP) and the 100-trial Monte-Carlo batch at the earlier
floor of 256 blocks and at one block (the default), warm walls taking
turns and a profiled solve at each (``_schedule_report``).

    python3 profile_port.py --walls [--root DIR]

three warm 3D 1x1000 f64 SOCP solves, the assembly memo's miss path three
times (host clock of ``api._prepare_assembly`` on a fresh copy of the
graph; skipped for a checkout without the memo) and a profiled solve
(launches, device
busy, the hand-written kernels per instantiation, and ``band_cr_reduce``,
``band_cr_backsub``, ``band_cr_level`` and ``band_block_inv`` device ms
and launches at Db = 12); five warm
Manhattan-4 SOCP solves in f32 and in f64 (host clock), the memo's miss
path in f64 as above, then one
profiled solve in each: kernel launches, device busy time and the
hand-written kernels' device time and launches (also per template
instantiation, ``chol_lanes_kernel<12>``), and ``block_chol`` and
``block_chol_solve`` at D = 6 in the f32 solve; then the same in f32 for
3D 4x250 (``chip_smoke._cells_3d``) as SOCP and as QCQP and for 3D 1x1000
as SOCP (three warm walls), with both block kernels' device ms and
launches at D = 12. With ``--root`` for two
commits in turns in one call (a checkout from before the f32 3D path
raises at the 3D step).

    python3 profile_port.py --sweep3d [--out report.json]

the 3D instances (12 x 12 blocks; ``chip_smoke._cells_3d``): the band
alone at both 3D band shapes for every compaction floor from 1 to 256
whose remainder the solve kernel takes (factor, panel and direction ms,
launches, residual), ``band_pcr_solve``'s panel and a direction at each
remainder with clusters of 4, 8 and 16 thread blocks; the two Db = 12 PCR
kernels' parts (``band_pcr_level`` built without its inverse, the cluster
``band_pcr_solve``'s clocks at each level's barrier, stage and products); warm 3D 4x250 QCQP and SOCP solves with the floor
at 4, 16, 64 and 256, each with and without the band's refinement step, in
turns (walls, iterations, relative gap, dual residual), and the QCQP at
four of them by the port's CPU path; three warm solves and a profiled solve of each 3D instance; and
3D 1x1000 SOCP solved by the port's plain path on the CPU.

    python3 profile_port.py --refine [--out report.json]

the refinement stage (``refine/lm.py``) on Manhattan-4 and 3D 4x250 from
their f64 SOCP rounding: the cost of the first trial step at lambda =
1e-4 to 1e4 (one linearization at the start, one CG solve each), then a
refinement with the default parameters and one with the stall rule lifted
(``stall_limit`` above ``max_iter``: 60 iterations), each with its
iterations, costs and wall, and one profiled outer iteration (the device's
activity: launches, device busy ms, and the kernels with the most
launches).

    python3 profile_port.py --batch [--out report.json]

the Monte-Carlo batch (``score_tpu_torch.parallel.solve_conic_batch``,
``chip_smoke.py``'s ``mc_batch`` world and settings: trials of a 4 x 50
Manhattan world, ChainArrowBackend) at 1, 16 and 100 trials: trips, three
warm walls and ms per trial, and one profiled batch solve (device busy,
launches, top ops, the band kernels' device ms and launches).

    python3 profile_port.py --ablate

prices the parts of ``band_pcr_solve`` at the same shapes: it builds
``csrc/band.cu`` again with the level loop's reads of E, F compiled out
(``-DBAND_NO_STAGING``), with the wide kernel's products compiled out
(``-DBAND_NO_PRODUCT``) and with both, and times each build with all levels
and with none (what a launch costs before and after its levels).
"""

from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np


def _log(*a):
    print(*a, flush=True)


def _event_ms(fn, reps=20, warmup=3):
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


def _launches(fn):
    """Band kernel launches made by one call of fn."""
    from score_tpu_torch.ops import band

    band.reset_launch_counts()
    fn()
    return sum(k.launches for k in band.KERNELS)


def _assembly_walls(fg, n=3, relaxation="SOCP"):
    """Host clock of the assembly memo's miss path (normalize, assemble,
    upload, build the chain+arrow structure, prepare), each on a fresh
    copy of the graph; None for a checkout without the memo."""
    import copy

    import torch
    from score_tpu_torch import ScoreSolverParams, api

    if not hasattr(api, "_prepare_assembly"):
        return None
    walls = []
    for _ in range(n):
        g = copy.deepcopy(fg)
        t0 = time.perf_counter()
        api._prepare_assembly(g, relaxation, ScoreSolverParams(device="cuda"))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls


def _warm_walls(fg, n=3, precision="f64", relaxation="SOCP"):
    import torch
    from score_tpu_torch import ScoreSolverParams, solve_score

    params = ScoreSolverParams(device="cuda", precision=precision)
    solve_score(fg, relaxation, params)  # warm-up
    walls, res = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        res = solve_score(fg, relaxation, params)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    relgap = res.gap / max(1.0, abs(res.primal_objective))
    return dict(walls_s=walls, iterations=res.iterations, solved=res.solved,
                relgap=relgap, dres=res.dual_residual)


# device-side names of the port's hand-written kernels (band.cu, blocks.cu);
# tri_lower_kernel, cr_backsub_kernel, cr_reduce_kernel and the narrow and
# wide cr_backsub kernels are kernels of --root checkouts from before
# tri_solve_kernel and the fused CR kernels
_KERNEL_NAMES = ("init_a_kernel", "cr_level_kernel", "cr_level_element_kernel", "cr_factor_kernel",
                 "block_inv_element_kernel", "cr_reduce_kernel", "cr_backsub_kernel",
                 "cr_backsub_narrow_kernel", "cr_backsub_wide_kernel",
                 "cr_reduce_levels_kernel", "cr_backsub_levels_kernel",
                 "cr_backsub_element_kernel", "cr_reduce_tree_kernel",
                 "cr_backsub_chain_kernel", "cr_backsub_lanes_kernel",
                 "pcr_level_kernel", "block_inv_kernel", "pcr_solve_wide_kernel",
                 "pcr_solve_narrow_kernel", "pcr_level_element_kernel",
                 "pcr_solve_cluster_kernel", "chol_kernel", "chol_lanes_kernel",
                 "tri_solve_kernel", "tri_solve_tile_kernel", "tri_solve_lanes_kernel",
                 "tri_lower_kernel")
# the device-side kernels of block_chol and block_chol_solve (of this
# package and of a checkout from before the D = 12 lane-group kernels), and
# of band_cr_reduce and band_cr_backsub (of this package and of one from
# before the fused CR kernels)
_BLOCK_WRAPPERS = {"block_chol": ("chol_kernel", "chol_lanes_kernel"),
                   "block_chol_solve": ("tri_solve_kernel", "tri_solve_tile_kernel",
                                        "tri_solve_lanes_kernel")}
_CR_WRAPPERS = {"band_cr_reduce": ("cr_reduce_kernel", "cr_reduce_levels_kernel",
                                   "cr_reduce_tree_kernel"),
                "band_cr_backsub": ("cr_backsub_narrow_kernel", "cr_backsub_wide_kernel",
                                    "cr_backsub_levels_kernel", "cr_backsub_element_kernel",
                                    "cr_backsub_chain_kernel", "cr_backsub_lanes_kernel")}
# band_cr_level and band_block_inv: the lane-group kernels (Db = 6, and
# Db = 12 in a checkout from before the element kernels) and the element
# kernels at Db = 12
_LEVEL_WRAPPERS = {"band_cr_level": ("cr_level_kernel", "cr_level_element_kernel"),
                   "band_block_inv": ("block_inv_kernel", "block_inv_element_kernel")}


def _block_kernels_at(profile, D, wrappers=None, key="D"):
    """{wrapper[D=n]: (device ms, launches)} of block_chol and
    block_chol_solve (or ``wrappers``, labelled ``[<key>=n]``) at block
    size D, summed over their kernels' instantiations in a profile of
    :func:`_profile_solve`."""
    out = {}
    for wrapper, names in (wrappers or _BLOCK_WRAPPERS).items():
        ms = n = 0
        for inst, row in profile["hand_kernels_by_instance"].items():
            if any(inst.startswith(f"{name}<{D},") or inst == f"{name}<{D}>" for name in names):
                ms += row["device_ms"]
                n += row["launches"]
        out[f"{wrapper}[{key}={D}]"] = (ms, n)
    return out


def _profile_solve(fg, top=12, precision="f64", relaxation="SOCP"):
    from score_tpu_torch import ScoreSolverParams, solve_score

    params = ScoreSolverParams(device="cuda", precision=precision)
    return _profile(lambda: solve_score(fg, relaxation, params), top)


def _profile(run, top=12):
    """One call of ``run()`` under torch.profiler: device busy time (self
    device time of all kernels), kernel launches, the ops with the most
    device time, and the hand-written kernels' device time and launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:top]
    band, by_instance = {}, {}
    for e in kernels:  # one entry per template instantiation: summed by name
        for name in _KERNEL_NAMES:
            if "::" + name in e.key:
                # and kept apart by template arguments (name<D, ...>)
                args = e.key.split("::" + name, 1)[1].split(">", 1)[0]
                inst = name + (args + ">" if args.startswith("<") else "")
                for table, key in ((band, name), (by_instance, inst)):
                    row = table.setdefault(key, dict(device_ms=0.0, launches=0))
                    row["device_ms"] += e.self_device_time_total / 1e3
                    row["launches"] += e.count
    return dict(
        device_busy_ms=busy_us / 1e3,
        kernel_launches=n_launch,
        top_ops=[dict(op=e.key, device_ms=e.self_device_time_total / 1e3,
                      calls=e.count) for e in ops],
        hand_kernels=band,
        hand_kernels_by_instance=by_instance,
    )


def _batch_report(sizes=(1, 16, 100)):
    """The Monte-Carlo batch (``chip_smoke.py``'s ``mc_batch`` world and
    settings) at each trial count: the trips, three warm walls (host clock
    around ``solve_conic_batch`` and a device sync, ``prepare`` included)
    and ms per trial, and one profiled batch solve: device busy, kernel
    launches, the top ops and the band kernels' device ms and launches."""
    import torch
    from chip_smoke import _mc_batch, _mc_params
    from score_tpu_torch.parallel.batch import _solve_batch_trips
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend

    params, dev, out = _mc_params(), torch.device("cuda"), {}
    for B in sizes:
        batch, _, ca = _mc_batch(range(B), dev)

        def run():
            return _solve_batch_trips(batch, params, ChainArrowBackend, ca)

        _, trips = run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        p = _profile(run)
        row = out[f"B={B}"] = dict(trips=trips, warm_s=walls,
                                   ms_per_trial=1e3 * statistics.median(walls) / B, profile=p)
        busy = p["device_busy_ms"] / 1e3 / statistics.median(walls)
        _log(f"mc batch B={B}: trips={trips} warm_s={[round(w, 3) for w in walls]} "
             f"ms_per_trial={row['ms_per_trial']:.2f}; profiled: device busy "
             f"{p['device_busy_ms']:.3f} ms ({100 * busy:.1f} % of the median wall), "
             f"{p['kernel_launches']} kernel launches")
        for o in p["top_ops"][:8]:
            _log(f"  {o['op']:<40} {o['device_ms']:9.3f} ms {o['calls']:7d} calls")
        for name, b in p["hand_kernels"].items():
            _log(f"  band {name:<22} {b['device_ms']:9.3f} ms {b['launches']:5d} launches")
    return out


def _schedule_report(rounds=3):
    """The band's schedule priced on the card: Manhattan-4, robot20, 3D
    4x250 and 3D 1x1000 (f64 SOCP, ``chip_smoke``'s cells) and the
    100-trial Monte-Carlo batch, each at the earlier compaction floor
    (``chip_smoke.EARLIER_BASE``: a parallel cyclic reduction remainder of
    up to 256 blocks) and at one block (the default): warm walls taking
    turns (iterations, relative gap), then one profiled solve at each
    floor: device busy, kernel launches, the hand-written kernels' device
    ms and launches."""
    import torch
    from chip_smoke import EARLIER_BASE, _band_shape, _cells, _cells_3d, _mc_batch, _mc_params
    from score_tpu_torch.ops import band
    from score_tpu_torch.parallel.batch import _solve_batch_trips
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend

    default = band.CR_BASE_LENGTH
    bases = (EARLIER_BASE, default)
    out = {}
    try:
        for label, fg in _cells() + _cells_3d():
            Tp = _band_shape(fg)[1]
            cell = out[label] = dict(Tp=Tp, walls=_forced_depth_walls(fg, Tp, rounds, bases))
            for n, w in cell["walls"].items():
                _log(f"{label} (Tp={Tp}) at {n} compacting levels: {w}")
            for base in bases:
                band.CR_BASE_LENGTH = base
                p = cell[f"profile_floor_{base}"] = _profile_solve(fg)
                _log(f"{label} floor {base}: device busy {p['device_busy_ms']:.3f} ms, "
                     f"{p['kernel_launches']} kernel launches")
                for name, b in p["hand_kernels"].items():
                    _log(f"  kernel {name:<26} {b['device_ms']:9.3f} ms {b['launches']:6d} "
                         "launches")
            band.CR_BASE_LENGTH = default
        params, dev = _mc_params(), torch.device("cuda")
        batch, _, ca = _mc_batch(range(100), dev)

        def run():
            return _solve_batch_trips(batch, params, ChainArrowBackend, ca)

        mc = out["mc100"] = {}
        for r in range(rounds + 1):  # round 0 warms up
            for base in bases:
                band.CR_BASE_LENGTH = base
                t0 = time.perf_counter()
                res, trips = run()
                torch.cuda.synchronize()
                row = mc.setdefault(f"floor {base}", dict(
                    walls_s=[], trips=trips, max_relgap=(res.gap / res.pobj.abs().clamp_min(
                        1.0)).max().item(), solved=int((res.status == 1).sum().item())))
                if r:
                    row["walls_s"].append(time.perf_counter() - t0)
        for base in bases:
            band.CR_BASE_LENGTH = base
            row = mc[f"floor {base}"]
            row["median_s"] = statistics.median(row["walls_s"])
            p = row["profile"] = _profile(run)
            _log(f"mc100 floor {base}: trips={row['trips']} optimal={row['solved']}/100 "
                 f"max_relgap={row['max_relgap']:.3e} warm_s={row['walls_s']} device busy "
                 f"{p['device_busy_ms']:.3f} ms, {p['kernel_launches']} kernel launches")
            for name, b in p["hand_kernels"].items():
                _log(f"  kernel {name:<26} {b['device_ms']:9.3f} ms {b['launches']:6d} launches")
    finally:
        band.CR_BASE_LENGTH = default
    return out


def _random_band(C, Tp, Db, seed, device):
    import torch

    rng = np.random.default_rng(seed)
    M = rng.standard_normal((C, Tp, Db, Db))
    D = M @ np.swapaxes(M, -1, -2) + (2.0 + 4.0 * Db) * np.eye(Db)
    U = 0.3 * rng.standard_normal((C, Tp, Db, Db))
    U[:, -1] = 0.0
    f = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
    return f(D), f(U)


def _depth_sweep(C, Tp, K, device):
    import torch
    from score_tpu_torch.ops import band

    D, U = _random_band(C, Tp, 6, seed=Tp, device=device)
    rng = np.random.default_rng(0)
    bK = torch.tensor(rng.standard_normal((C, Tp, 6, K)), device=device)
    b1 = torch.tensor(rng.standard_normal((C, Tp, 6, 1)), device=device)
    rows = []
    for n in range(band.num_levels(Tp) + 1):
        f = band.band_factor(D, U, n_cr=n)
        rows.append(dict(
            n_cr=n,
            factor_ms=_event_ms(lambda: band.band_factor(D, U, n_cr=n)),
            panel_ms=_event_ms(lambda: band.band_solve(f, bK)),
            direction_ms=_event_ms(lambda: band.band_solve(f, b1)),
            factor_launches=_launches(lambda: band.band_factor(D, U, n_cr=n)),
            solve_launches=_launches(lambda: band.band_solve(f, b1)),
        ))
    return rows


def _forced_depth_walls(fg, Tp, rounds=4, bases=None):
    """Warm solves at depth 0, 1, the default depth and the deepest depth
    (or at the compaction floors ``bases``), by moving
    ``band.CR_BASE_LENGTH``; the depths take turns, one solve each per
    round, so a drift of the host clock hits all of them."""
    import torch
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.ops import band

    default = band.CR_BASE_LENGTH
    bases = sorted(set(bases or (Tp, Tp // 2, default, 1)), reverse=True)
    params = ScoreSolverParams(device="cuda")
    out = {}
    try:
        for r in range(rounds + 1):  # round 0 warms up
            for base in bases:
                band.CR_BASE_LENGTH = base
                t0 = time.perf_counter()
                res = solve_score(fg, "SOCP", params)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                row = out.setdefault(band.cr_depth(Tp), dict(
                    walls_s=[], iterations=res.iterations, solved=res.solved,
                    relgap=res.gap / max(1.0, abs(res.primal_objective))))
                if r:
                    row["walls_s"].append(wall)
    finally:
        band.CR_BASE_LENGTH = default
    for row in out.values():
        row["median_s"] = statistics.median(row["walls_s"])
    return out


# PCR remainder of each instance's band: chains, length after the default
# compaction, arrow width (chip_smoke.py prints them)
_REMAINDERS = {"manhattan4": (4, 256, 138), "robot20": (20, 128, 258)}


# band_cr_level: (chains, fine chain length) of Manhattan-4's first level,
# of its second and third at one chain's worth of positions, and of a
# forced level on robot20; the f32 band's _dinv: (blocks, rhs columns) of a
# direction, a level's couplings and the arrow panel at Manhattan-4's first
# level, and robot20's panel
_CR_LEVEL_SHAPES = ((4, 512), (1, 1024), (1, 2048), (20, 128))
# at Db = 12: band_cr_level at 3D 1x1000's two levels and the 3D fold's
# first (C, fine length), band_block_inv at 3D 1x1000's and 3D 4x250's PCR
# remainders (C, Tp), and the coarse positions of a band_cr_level thread
# block that band.cu is built for (band._cr_level_tile forced to each)
_CR_LEVEL_SHAPES_3D = ((1, 1024), (1, 512), (64, 256))
_BLOCK_INV_SHAPES_3D = ((1, 256), (4, 256))
_CR_LEVEL_TILINGS = (1, 3)
_DINV_SHAPES = ((1024, 1), (1024, 6), (1024, 138), (1280, 258))
# band_cr_reduce and band_cr_backsub at the runs of the cells' solves as
# they ran in runs of at most eight levels (before a pass took one launch
# each way; --cr --pass times the default schedule's passes): (label,
# chains, fine length of the run, block size, levels of the run, rhs
# widths): the Monte-Carlo folds (100 trials of a 4 x 50 world; 16 trials
# of 3D 4x250), Manhattan-4's two runs (the second, its tail, ends at one
# position a chain), 3D 1x1000's two runs, robot20 and 3D 4x250 in one run
# each.
_CR_SOLVE_SHAPES = (("mc", 400, 64, 6, 6, (56, 1)), ("mc3d", 64, 256, 12, 8, (18, 1)),
                    ("manhattan4 run 1", 4, 512, 6, 5, (138, 1)),
                    ("manhattan4 tail", 4, 16, 6, 4, (138, 1)),
                    ("3d-1x1000 run 1", 1, 1024, 12, 5, (18, 1)),
                    ("3d-1x1000 tail", 1, 32, 12, 5, (18, 1)),
                    ("robot20", 20, 128, 6, 7, (258, 1)),
                    ("3d-4x250", 4, 256, 12, 8, (18, 1)))
# measurement builds of csrc/band.cu for the fused CR kernels: each of the
# reduce's layouts alone (a thread per output row and column; a thread per
# position and column holding the Db rows), the element backsub with a
# thread per row and column, and the phases' clocks
_CR_BUILDS = {"reduce (a) a row a thread": "-DBAND_CR_REGISTER_ROWS_K=1073741824",
              "reduce (b) Db rows a thread": "-DBAND_CR_REGISTER_ROWS_K=0",
              "element backsub, a row a thread": "-DBAND_CR_ELEMENT_ROWS=1",
              "chain backsub, Db rows a thread": "-DBAND_CR_CHAIN_BACKSUB_ROWS=0",
              "chain backsub, a row a thread": "-DBAND_CR_CHAIN_BACKSUB_ROWS=1",
              "clocks": "-DBAND_CR_CLOCKS"}
# block_chol: the f32 factor of Manhattan-4 (C = 4 chains of 512) takes the
# Cholesky of the odd blocks of chains of 512, 256, ..., 2 (M = 1024 ... 4)
# and of the root (C = 4 blocks); QCQP's distance pivots are 2070 blocks of 2
_CHOL_CHAINS = (4, 512)
_CHOL_PIVOTS = 2070


def _through(lib, fn):
    """fn() with the band wrappers launching from another build of band.cu."""
    from score_tpu_torch.ops import band

    package = band._lib
    band._lib = lambda: lib
    try:
        return fn()
    finally:
        band._lib = package


def _band_builds(flags, prefix):
    """{flag: library} of band.cu built once for each nvcc flag, all nvcc
    processes started together."""
    import ctypes

    from score_tpu_torch.ops import build

    vp, i32 = ctypes.c_void_p, ctypes.c_int
    procs, libs = {}, {}
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for flag in flags:
        so = build.BUILD_DIR / (prefix + flag.replace("=", "_").replace(" ", "")[2:] + ".so")
        procs[flag] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, *flag.split(), "-o", str(so),
             str(build.SOURCES["band"])],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    for flag, (so, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc band.cu {flag} failed")
        lib = libs[flag] = ctypes.CDLL(str(so))
        lib.band_error_string.argtypes = [i32]
        lib.band_error_string.restype = ctypes.c_char_p
        lib.error_string = lib.band_error_string
        if hasattr(build, "band_signatures"):
            build.band_signatures(lib)
            continue
        lib.band_block_inv.argtypes = [vp, vp, ctypes.c_longlong, i32, vp]
        lib.band_pcr_level.argtypes = [vp] * 10 + [i32] * 4 + [vp]
        lib.band_pcr_solve.argtypes = [vp] * 5 + [i32] * 7 + [vp]
        lib.band_cr_level.argtypes = [vp] * 11 + [i32, i32, i32, vp]
        lib.band_cr_reduce.argtypes = [build.CrReduceLevels, vp] + [i32] * 7 + [vp]
        lib.band_cr_backsub.argtypes = [build.CrBacksubLevels, vp, vp] + [i32] * 7 + [vp]
        for fn in (lib.band_block_inv, lib.band_pcr_level, lib.band_pcr_solve,
                   lib.band_cr_level, lib.band_cr_reduce, lib.band_cr_backsub):
            fn.restype = i32
    return libs


def _forced_tile(P):
    """A context in which band_cr_level takes P coarse positions a thread
    block at Db = 12, whatever its planner (band._cr_level_tile) says."""
    import contextlib

    from score_tpu_torch.ops import band

    @contextlib.contextmanager
    def forced():
        plan = band._cr_level_tile
        band._cr_level_tile = lambda nC, Th, Db: P if Db == 12 else plan(nC, Th, Db)
        try:
            yield
        finally:
            band._cr_level_tile = plan

    return forced()


def _element_times(device):
    """The Db = 12 element kernels: band_cr_level at ``_CR_LEVEL_SHAPES_3D``
    and band_block_inv at ``_BLOCK_INV_SHAPES_3D``, device us and event ms;
    where the package plans band_cr_level's tile (band._cr_level_tile),
    also band_cr_level at each tiling of ``_CR_LEVEL_TILINGS`` (P coarse
    positions a thread block), whose eight outputs must equal the planner's
    bit for bit, and both kernels from a build with -DBAND_LEVEL_NO_INVERSE
    (the shared element inversion compiled out: what the rest of a launch
    costs)."""
    import torch
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band

    ablation = _band_builds(["-DBAND_LEVEL_NO_INVERSE"], "element")["-DBAND_LEVEL_NO_INVERSE"]
    tilings = _CR_LEVEL_TILINGS if hasattr(band, "_cr_level_tile") else ()
    rows = []

    def timed(kernel, shape, fn):
        rows.append(dict(cell="3D band", kernel=kernel, shape=shape,
                         device_us=_device_us(fn), event_ms=_event_ms(fn)))
        rows.append(dict(cell="3D band", kernel=f"{kernel}, no inverse", shape=shape,
                         device_us=_through(ablation, lambda: _device_us(fn)),
                         event_ms=_through(ablation, lambda: _event_ms(fn))))

    for C, T in _CR_LEVEL_SHAPES_3D:
        D, U = _random_band(C, T, 12, seed=T + C, device=device)
        A = band.band_init_a(U)
        fn = lambda: band.band_cr_level(D, A, U)
        timed("band_cr_level[Db=12]", f"C={C} T={T}", fn)
        want = fn()
        for P in tilings:
            with _forced_tile(P):
                got = fn()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"band_cr_level P={P} C={C} T={T}: not the planner's bits")
                rows.append(dict(cell="3D band", kernel=f"band_cr_level[Db=12], P={P}",
                                 shape=f"C={C} T={T}", device_us=_device_us(fn),
                                 event_ms=_event_ms(fn)))
    for C, Tp in _BLOCK_INV_SHAPES_3D:
        D, _ = _random_band(C, Tp, 12, seed=Tp + C, device=device)
        timed("band_block_inv[Db=12]", f"C={C} Tp={Tp}", lambda: band.band_block_inv(D))
    return rows


def _chol_times(device):
    """block_chol at every Cholesky of a Manhattan-4 f32 factor: the kernel
    on contiguous blocks, and ``smallblocks.chol_small`` on the odd-row view
    the factor hands it (in a checkout that copies the view first, the copy
    and the kernel); the D = 2 pivots."""
    from chip_smoke import _device_us, _random_blocks
    from score_tpu_torch.ops import blocks
    from score_tpu_torch.solver import smallblocks

    rows = []
    C, T = _CHOL_CHAINS
    while T >= 1:
        M = C * max(T // 2, 1)
        Dfull = _random_blocks(C * T, 6, seed=T, device=device).reshape(C, T, 6, 6)
        view = Dfull[:, 1::2] if T > 1 else Dfull[:, 0]
        what = "odd rows" if T > 1 else "root"
        A = view.reshape(M, 6, 6).contiguous()
        for name, fn in ((f"M={M} D=6 contiguous", lambda: blocks.block_chol(A)),
                         (f"M={M} D=6 chol_small({what})", lambda: smallblocks.chol_small(view))):
            rows.append(dict(cell="f32 band", kernel="block_chol", shape=name,
                             device_us=_device_us(fn), event_ms=_event_ms(fn)))
        T //= 2
    A = _random_blocks(_CHOL_PIVOTS, 2, seed=2, device=device)
    fn = lambda: blocks.block_chol(A)
    rows.append(dict(cell="f32 QCQP", kernel="block_chol", shape=f"M={_CHOL_PIVOTS} D=2",
                     device_us=_device_us(fn), event_ms=_event_ms(fn)))
    return rows


def _cr_clocks(band, lib, kernel, fn, n, T, Db, K, C, device):
    """The clock build's phases of one call of ``fn`` (SM cycles from the
    start of the recording thread block), or None where the build records
    none at this shape. A package with ``band._cr_chain_plan`` runs the
    chain kernels on runs that end at one position a chain where that plans
    one: the block that
    finishes chain 0 (the reduce) or segment 0 of chain 0 (the back
    substitution) writes 64 clocks over the output (csrc/band.cu,
    CR_CHAIN_CLOCKS_OUT). Otherwise the tile kernels: thread block 0 writes
    16 over its launch's output, the reduce's copies issued, staged,
    barrier, then each level's end and barrier (levels a launch <= 6: the
    array has 16 slots), the element back substitution's copies issued,
    staged, barrier, then each level's rv, barrier and product (<= 4
    levels); the lane-group steps record none. A list of each launch's
    clocks (the tile reduce's launches each write over their last level's
    output)."""
    step = "reduce" if kernel == "band_cr_reduce" else band._backsub_step(Db, K)
    chain = getattr(band, "_cr_chain_plan", None)
    if chain is not None and T == 1 << n and chain(
            "reduce" if step == "reduce" else "backsub", n, Db, K, C, band._sm_count(device)):
        # the tree reduce writes them over level 1's output (there are 64
        # values at every shape), the chain reduce before it over the last
        tree = "top" in band.ReducePlan._fields
        count, ends = 64, [1 if step == "reduce" and tree else n]
    else:
        depths = band._cr_launch_depths(step, n, Db, K)
        if step == "reduce" and max(depths) <= 6:
            count = 16
        elif step == "element" and max(depths) <= 4:
            count = 16
        else:
            return None
        # each tile launch writes its clocks over its last level's output
        ends = list(itertools.accumulate(depths)) if step == "reduce" else [n]
    out = _through(lib, lambda: [fn() for _ in range(3)][-1])
    outs = [out[e - 1] for e in ends] if isinstance(out, tuple) else [out]
    if any(o.numel() < count for o in outs):
        return None
    return [[int(v) for v in o.flatten()[:count].tolist()] for o in outs]


def _cr_solve_times(device, layouts=True):
    """band_cr_reduce and band_cr_backsub at ``_CR_SOLVE_SHAPES``, on the
    levels of a random band's factor: one call as a solve's run makes it
    (its launches counted), device us and event ms; with ``layouts`` also
    each layout of ``_CR_BUILDS`` (its own build of band.cu); and the clock
    build's phases at the panel (:func:`_cr_clocks`). A package from before
    the fused kernels launches once a level (timed together in one graph
    and each level alone)."""
    import inspect

    import torch
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band

    fused = list(inspect.signature(band.band_cr_reduce).parameters) == ["levels", "b"]
    libs = {}
    if fused:
        builds = _CR_BUILDS if layouts else {
            what: flag for what, flag in _CR_BUILDS.items()
            if what == "clocks" or what.startswith(("reduce", "chain"))}
        built = _band_builds(list(builds.values()), "cr")
        libs = {what: built[flag] for what, flag in builds.items()}

    rows = []
    rng = np.random.default_rng(1)
    for label, C, T, Db, n, Ks in _CR_SOLVE_SHAPES:
        D, U = _random_band(C, T, Db, seed=T + C, device=device)
        levels = band.band_factor(D, U, n_cr=n).levels
        for K in Ks:
            b = torch.tensor(rng.standard_normal((C, T, Db, K)), device=device)
            shape = f"C={C} T={T} Db={Db} levels={n} K={K}"
            if fused:
                red = band.band_cr_reduce(levels, b)
                fine, x = (b,) + red[:-1], torch.tensor(rng.standard_normal(red[-1].shape),
                                                        device=device)
                kernels = {"band_cr_reduce": lambda: band.band_cr_reduce(levels, b),
                           "band_cr_backsub": lambda: band.band_cr_backsub(levels, fine, x)}
                for kernel, fn in kernels.items():
                    band.reset_launch_counts()
                    fn()
                    launches = getattr(band, kernel).launches
                    rows.append(dict(cell=label, kernel=kernel, shape=shape,
                                     launches=launches, device_us=_device_us(fn),
                                     event_ms=_event_ms(fn)))
                for what, lib in libs.items():
                    kernel = what.split()[0]
                    kernel = "band_cr_" + ("backsub" if kernel in ("element", "chain") else kernel)
                    if what == "clocks" or (what.startswith("element") and (Db != 12 or K <= 4)):
                        continue
                    if what.startswith("chain") and T != 1 << n:
                        continue
                    fn = kernels[kernel]
                    rows.append(dict(cell=label, kernel=f"{kernel}, {what}", shape=shape,
                                     device_us=_through(lib, lambda: _device_us(fn)),
                                     event_ms=_through(lib, lambda: _event_ms(fn))))
                if "clocks" in libs and K > 1:
                    for kernel, fn in kernels.items():
                        clk = _cr_clocks(band, libs["clocks"], kernel, fn, n, T, Db, K, C,
                                         device)
                        if clk is not None:
                            rows.append(dict(cell=label, kernel=f"{kernel}, clocks", shape=shape,
                                             device_us=0.0, event_ms=0.0, clocks=clk))
                continue
            # a package from before the fused kernels: one launch a level
            outs, cur = [], b
            for lv in levels:
                outs.append(band.band_cr_reduce(lv.E, lv.F, cur))
                cur = outs[-1]
            fine = [b] + outs[:-1]
            x = torch.tensor(rng.standard_normal(cur.shape), device=device)

            def reduce_all():
                cur = b
                for lv in levels:
                    cur = band.band_cr_reduce(lv.E, lv.F, cur)

            def backsub_all():
                xx = x
                for lv, bf in zip(reversed(levels), reversed(fine)):
                    xx = band.band_cr_backsub(lv.invD, lv.A, lv.C, bf, xx)

            for kernel, fn in (("band_cr_reduce", reduce_all), ("band_cr_backsub", backsub_all)):
                rows.append(dict(cell=label, kernel=kernel, shape=shape + f" ({n} launches)",
                                 device_us=_device_us(fn), event_ms=_event_ms(fn)))
    return rows


# a band-solve pass at the cells (profile_port.py --cr --pass): (label,
# chains, chain length, block size, panel width)
_PASS_CELLS = (("manhattan4", 4, 512, 6, 138), ("robot20", 20, 128, 6, 258),
               ("3d-4x250", 4, 256, 12, 18), ("3d-1x1000", 1, 1024, 12, 18),
               ("mc", 400, 64, 6, 56), ("mc3d", 64, 256, 12, 18))
_HBM_BYTES_PER_US = 3.35e6  # H100 SXM, 3.35 TB/s


def _pass_bytes(levels, C, T, Db, K):
    """(reduce, backsub) bytes of a band-solve pass through ``levels``: every
    level's E, F (reduce) or invD, A, C (backsub) read once, the fine rhs
    read once and each level's reduced rhs written once (reduce), the odd
    rows of each level's fine rhs and the coarsest x read once and the finest
    x written once (backsub)."""
    rows = sum(lv.E.shape[0] * lv.E.shape[1] for lv in levels)
    red = 8 * (2 * rows * Db * Db + C * T * Db * K + rows * Db * K)
    back = 8 * (3 * rows * Db * Db + rows * Db * K + C * (T >> len(levels)) * Db * K
                + C * T * Db * K)
    return red, back


def _pass_times(device):
    """One band-solve pass at ``_PASS_CELLS`` at K = 1, 2 and the panel: the
    runs of ``band._cr_runs`` as ``band._band_solve_once`` calls the
    wrappers, timed as a whole (reduce launches, band_pcr_solve, backsub
    launches: device us from a replayed CUDA graph) and launch by launch,
    with launches a pass and the bound."""
    import torch
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band

    rows = []
    rng = np.random.default_rng(3)
    for label, C, Tp, Db, panel in _PASS_CELLS:
        D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
        f = band.band_factor(D, U)
        levels, runs = f.levels, band._cr_runs(len(f.levels))
        for K in (1, 2, panel):
            b = torch.tensor(rng.standard_normal((C, Tp, Db, K)), device=device)
            spans, first = [], 0
            for d in runs:
                spans.append((first, d))
                first += d
            fine = (b,)
            for first, d in spans:
                fine += band.band_cr_reduce(levels[first:first + d], fine[-1])
            xc = band.band_pcr_solve(f.E, f.F, f.invD, fine[-1])
            xs = [xc]
            for first, d in reversed(spans):
                xs.append(band.band_cr_backsub(levels[first:first + d], fine[first:first + d],
                                               xs[-1]))

            def reduce_pass():
                src = b
                for first, d in spans:
                    src = band.band_cr_reduce(levels[first:first + d], src)[-1]

            def backsub_pass():
                x = xc
                for first, d in reversed(spans):
                    x = band.band_cr_backsub(levels[first:first + d], fine[first:first + d], x)

            solve = lambda: band.band_pcr_solve(f.E, f.F, f.invD, fine[-1])
            band.reset_launch_counts()
            reduce_pass()
            solve()
            backsub_pass()
            counts = {k.__name__: k.launches for k in band.KERNELS if k.launches}
            red_b, back_b = _pass_bytes(levels, C, Tp, Db, K)
            row = dict(cell=label, K=K, C=C, Tp=Tp, Db=Db, runs=list(runs), launches=counts,
                       reduce_us=_device_us(reduce_pass), pcr_solve_us=_device_us(solve),
                       backsub_us=_device_us(backsub_pass),
                       reduce_bound_us=red_b / _HBM_BYTES_PER_US,
                       backsub_bound_us=back_b / _HBM_BYTES_PER_US, each=[])
            for i, (first, d) in enumerate(spans):
                group, src = levels[first:first + d], fine[first]
                row["each"].append(dict(kernel="band_cr_reduce", levels=[first, first + d],
                                        device_us=_device_us(
                                            lambda: band.band_cr_reduce(group, src))))
            for i, (first, d) in enumerate(reversed(spans)):
                group, rhs, x = levels[first:first + d], fine[first:first + d], xs[i]
                row["each"].append(dict(kernel="band_cr_backsub", levels=[first, first + d],
                                        device_us=_device_us(
                                            lambda: band.band_cr_backsub(group, rhs, x))))
            rows.append(row)
    return rows


# plans of the chain kernels timed beside the planner's own at a pass
# (profile_port.py --cr --pass --sweep): (cell of _PASS_CELLS, K, tree
# reduces as (levels, positions[, columns]) of their tile stage (0 levels:
# none), back substitutions' segments S)
_PASS_SWEEP = (
    ("manhattan4", 1, [(3, 1), (4, 1), (5, 1)], [16, 32, 64]),
    ("manhattan4", 138, [(4, 1), (5, 1), (5, 1, 36), (5, 1, 70)], [16, 32, 64]),
    ("robot20", 1, [(0, 1)], [2, 4, 8]),
    ("robot20", 258, [(3, 1), (4, 1), (4, 1, 86), (5, 1)], [16, 32]),
    ("3d-4x250", 1, [(3, 1), (4, 1)], [16, 32, 64]),
    ("3d-4x250", 18, [(3, 1), (4, 1), (5, 1), (5, 1, 6)], [16, 32, 64]),
    ("3d-1x1000", 1, [(4, 1), (5, 1)], [32, 64, 128, 256]),
    ("3d-1x1000", 18, [(3, 1), (4, 1), (5, 1), (5, 1, 6)], [64, 128]),
    ("mc", 1, [(0, 1)], [1, 2, 4]),
    ("mc", 56, [(0, 1)], [2, 4]),
    ("mc3d", 1, [(3, 4), (3, 8), (4, 4)], [4, 8, 16]),
    ("mc3d", 18, [(3, 4), (3, 2), (4, 1), (5, 1)], [8, 16]),
)


def _sweep_plan(band, n, Db, K, m, P, Kf=None):
    """A ReducePlan with this tile stage (m levels, P positions a tile, Kf
    columns a chunk, by default the widest the shared memory takes; m = 0:
    none) and the widest whole-chain stage the shared memory takes, or
    None."""
    if m:
        if Kf is None:
            Kf = band._chunks(K, lambda kf: band._cr_smem_bytes("reduce", m, Db, P, kf)
                              <= band._SMEM_MAX, K % 2 == 0)
        if Kf is None or band._cr_smem_bytes("reduce", m, Db, P, Kf) > band._SMEM_MAX:
            return None
    else:
        Kf = K
    whole = band._whole_chain(n, Db, K, m, band._SMEM_MAX, Kf)
    if whole is None:
        return None
    plan = band.ReducePlan(m, P, Kf, *whole)
    return plan if band._tree_reduce_smem(n, Db, K, plan) <= band._SMEM_MAX else None


def _pass_sweep(device):
    """Device us of a pass's band_cr_reduce and band_cr_backsub under each
    plan of ``_PASS_SWEEP`` beside the planner's (the tile kernels where
    band._chain_takes keeps them), the planner replaced for the call and
    the chain kernels taking the run; each held to the plain twins
    (1e-12)."""
    import torch
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band

    cells = {c[0]: c for c in _PASS_CELLS}
    rows = []
    rng = np.random.default_rng(4)
    planner, takes = band._chain_plan, band._chain_takes
    for label, K, reduces, segments in _PASS_SWEEP:
        _, C, Tp, Db, _ = cells[label]
        D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
        f = band.band_factor(D, U)
        levels, n = f.levels, len(f.levels)
        b = torch.tensor(rng.standard_normal((C, Tp, Db, K)), device=device)
        want = band.band_cr_reduce_plain(levels, b)
        fine = (b,) + want[:-1]
        x = torch.tensor(rng.standard_normal(want[-1].shape), device=device)
        want_x = band.band_cr_backsub_plain(levels, fine, x)
        plans = ([("reduce", "planner")] + [("reduce", r) for r in reduces]
                 + [("backsub", "planner")] + [("backsub", S) for S in segments])
        for step, spec in plans:
            if spec == "planner":
                plan = planner(step, n, Db, K, C, band._sm_count(device))
            elif step == "reduce":
                plan = _sweep_plan(band, n, Db, K, *spec)
            elif band._backsub_narrow(K):
                plan = band.BacksubPlan(spec, K) if spec <= 1 << n else None
            else:
                Kc = band._chunks(K, lambda kc: band._chain_backsub_shape(n, Db, spec, kc)[0]
                                  <= band._SMEM_MAX, False)
                plan = band.BacksubPlan(spec, Kc) if Kc and spec <= 1 << n else None
            if plan is None:
                rows.append(dict(cell=label, K=K, step=step, plan=str(spec), device_us="no fit"))
                continue
            band._chain_plan = lambda *a, plan=plan: plan
            if spec != "planner":  # the chain kernels, where the routing keeps the tiles too
                band._chain_takes = lambda *a: True
            try:
                if step == "reduce":
                    fn = lambda: band.band_cr_reduce(levels, b)
                    got = fn()
                    err = max(((g - w).abs().max() / w.abs().max()).item()
                              for g, w in zip(got, want))
                else:
                    fn = lambda: band.band_cr_backsub(levels, fine, x)
                    err = ((fn() - want_x).abs().max() / want_x.abs().max()).item()
                us = _device_us(fn) if err <= 1e-12 else f"wrong: {err:.3e}"
            except RuntimeError as e:
                torch.cuda.synchronize()
                us = f"refused: {e}"
            finally:
                band._chain_plan, band._chain_takes = planner, takes
            rows.append(dict(cell=label, K=K, step=step, plan=str(plan),
                             planner=spec == "planner", device_us=us))
    return rows


# a band-solve pass's clock-build phases (profile_port.py --cr --pass
# --clocks): (cell of _PASS_CELLS, K)
_PASS_CLOCKS = (("manhattan4", 1), ("manhattan4", 138), ("robot20", 258), ("3d-1x1000", 1),
                ("3d-1x1000", 18))


def _pass_clocks(device):
    """The clock build's phases (:func:`_cr_clocks`: SM cycles from the
    start of the recording thread block) of each band_cr_reduce and
    band_cr_backsub launch of one band-solve pass at ``_PASS_CLOCKS``, run
    by run; None where the build records none (the tile kernels' lane-group
    and wide steps)."""
    import torch
    from score_tpu_torch.ops import band

    lib = _band_builds(["-DBAND_CR_CLOCKS"], "crclk")["-DBAND_CR_CLOCKS"]
    cells = {c[0]: c for c in _PASS_CELLS}
    rows = []
    rng = np.random.default_rng(5)
    for label, K in _PASS_CLOCKS:
        _, C, Tp, Db, _ = cells[label]
        D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
        f = band.band_factor(D, U)
        src, first = torch.tensor(rng.standard_normal((C, Tp, Db, K)), device=device), 0
        for d in band._cr_runs(len(f.levels)):
            lv, T = f.levels[first:first + d], Tp >> first
            red = band.band_cr_reduce(lv, src)
            fine = (src,) + red[:-1]
            x = torch.tensor(rng.standard_normal(red[-1].shape), device=device)
            for kernel, fn in (("band_cr_reduce", lambda: band.band_cr_reduce(lv, src)),
                               ("band_cr_backsub", lambda: band.band_cr_backsub(lv, fine, x))):
                rows.append(dict(cell=label, K=K, kernel=kernel, levels=[first, first + d],
                                 clocks=_cr_clocks(band, lib, kernel, fn, d, T, Db, K, C,
                                                   device)))
            src, first = red[-1], first + d
    return rows


# measurement builds of band.cu timed at a pass's band_cr_reduce (profile_port.py
# --cr --pass --sweep): the tree kernel's thread blocks an SM, and the
# (cell of _PASS_CELLS, K) it is timed at
_PASS_BUILDS = ("-DBAND_CR_TREE_MIN_BLOCKS=1", "-DBAND_CR_TREE_MIN_BLOCKS=2",
                "-DBAND_CR_TREE_MIN_BLOCKS=4")
_PASS_BUILD_CELLS = (("mc", 1), ("manhattan4", 1), ("3d-1x1000", 1), ("mc", 56))


def _pass_builds(device):
    """Device us of a pass's band_cr_reduce at ``_PASS_BUILD_CELLS`` from
    each build of ``_PASS_BUILDS`` beside the package's own, each held to
    the plain twin (1e-12)."""
    import torch
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band

    libs = _band_builds(list(_PASS_BUILDS), "crmin")
    cells = {c[0]: c for c in _PASS_CELLS}
    rows = []
    rng = np.random.default_rng(6)
    for label, K in _PASS_BUILD_CELLS:
        _, C, Tp, Db, _ = cells[label]
        D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
        levels = band.band_factor(D, U).levels
        b = torch.tensor(rng.standard_normal((C, Tp, Db, K)), device=device)
        want = band.band_cr_reduce_plain(levels, b)
        fn = lambda: band.band_cr_reduce(levels, b)
        for flag, lib in [("package", None)] + list(libs.items()):
            run = (lambda f: f()) if lib is None else (lambda f, lib=lib: _through(lib, f))
            err = max(((g - w).abs().max() / w.abs().max()).item()
                      for g, w in zip(run(fn), want))
            us = run(lambda: _device_us(fn)) if err <= 1e-12 else f"wrong: {err:.3e}"
            rows.append(dict(cell=label, K=K, build=flag, device_us=us))
    return rows


def _pass_tally():
    """The band-solve passes of a Manhattan-4, robot20, 3D 4x250 and 3D
    1x1000 f64 SOCP solve (``chip_smoke._cells``, ``_cells_3d``) by rhs
    width K, and the CR kernels' launches a solve."""
    import collections

    import torch
    from chip_smoke import _cells, _cells_3d
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.ops import band

    out = {}
    once = band._band_solve_once
    for label, fg in list(_cells()) + list(_cells_3d()):
        tally = collections.Counter()

        def recording(factors, b):
            tally[b.shape[-1]] += 1
            return once(factors, b)

        band._band_solve_once = recording
        band.reset_launch_counts()
        try:
            res = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda"))
            torch.cuda.synchronize()
        finally:
            band._band_solve_once = once
        out[label] = dict(iterations=res.iterations, passes_by_K=dict(sorted(tally.items())),
                          launches={k.__name__: k.launches for k in band.KERNELS})
    return out


def _kernel_times(device):
    """Device us and event ms of band_block_inv, band_pcr_level and
    band_pcr_solve at the shapes of ``_REMAINDERS``, of band_cr_level at ``_CR_LEVEL_SHAPES``,
    of band_cr_reduce and band_cr_backsub at ``_CR_SOLVE_SHAPES``, of the
    f32 band's ``_dinv`` at ``_DINV_SHAPES`` and of block_chol at the f32
    factor's shapes (:func:`_chol_times`). Serves both signatures of
    band_pcr_level: with the carried inverse (D, A, C, invD, s) and
    without (D, A, C, s)."""
    import inspect

    import torch
    from chip_smoke import _device_us, _random_blocks
    from score_tpu_torch.ops import band
    from score_tpu_torch.solver import pcr, smallblocks

    carried = len(inspect.signature(band.band_pcr_level).parameters) == 5
    rows = []
    for label, (C, Tp, K) in _REMAINDERS.items():
        D, U = _random_band(C, Tp, 6, seed=Tp + C, device=device)
        A = band.band_init_a(U)
        f = band.band_factor(D, U, n_cr=0)
        invD = band.band_block_inv(D)
        fn = lambda: band.band_block_inv(D)
        rows.append(dict(cell=label, kernel="band_block_inv", shape=f"C={C} Tp={Tp}",
                         device_us=_device_us(fn), event_ms=_event_ms(fn)))
        rng = np.random.default_rng(Tp)
        for s in (1, Tp // 2):
            args = (D, A, U, invD, s) if carried else (D, A, U, s)
            fn = lambda: band.band_pcr_level(*args)
            rows.append(dict(cell=label, kernel="band_pcr_level", shape=f"C={C} Tp={Tp} s={s}",
                             device_us=_device_us(fn), event_ms=_event_ms(fn)))
        for k in (1, K):
            b = torch.tensor(rng.standard_normal((C, Tp, 6, k)), device=device)
            fn = lambda: band.band_pcr_solve(f.E, f.F, f.invD, b)
            rows.append(dict(cell=label, kernel="band_pcr_solve", shape=f"C={C} Tp={Tp} K={k}",
                             device_us=_device_us(fn), event_ms=_event_ms(fn)))
    for C, T in _CR_LEVEL_SHAPES:
        D, U = _random_band(C, T, 6, seed=T + C, device=device)
        A = band.band_init_a(U)
        fn = lambda: band.band_cr_level(D, A, U)
        rows.append(dict(cell="f64 band", kernel="band_cr_level", shape=f"C={C} T={T}",
                         device_us=_device_us(fn), event_ms=_event_ms(fn)))
    for M, K in _DINV_SHAPES:
        L = smallblocks.chol_small(_random_blocks(M, 6, seed=M, device=device))
        B = torch.randn(M, 6, K, device=device)
        fn = lambda: pcr._dinv(L, B)
        rows.append(dict(cell="f32 band", kernel="pcr._dinv", shape=f"M={M} D=6 K={K}",
                         device_us=_device_us(fn), event_ms=_event_ms(fn)))
    return (rows + _element_times(device) + _cr_solve_times(device) + _chol_times(device)
            + _blocks12_times(device))


# 3D 4x250's f32 factor: C = 4 chains of 256 blocks of 12 x 12
_CHAINS_3D = (4, 256)
# the widths at which block_chol_solve[D=12] is timed: the arrow panel, a
# level's couplings, a direction
_SOLVE12_WIDTHS = (18, 12, 1)
# builds of csrc/blocks.cu that time each D = 12 solve layout alone: the
# width from which the tile layout takes over (tri_solve_tile_kernel at
# every width; tri_solve_lanes_kernel at every width)
_SOLVE12_DESIGNS = {"tile (a)": 0, "lane groups (b)": 1 << 30}


def _blocks12_times(device):
    """The f32 block kernels at D = 12, at 3D 4x250's factor shapes:
    block_chol at every Cholesky of the factor (contiguous blocks),
    block_chol_solve at M = 512 and ``_SOLVE12_WIDTHS``, and a level's two
    solves (W2 from the transposed even couplings, W1 from the odd ones)
    as the package's factor makes them: one two-rhs launch where the
    package has it, else two launches. With the two-rhs entry point, also
    block_chol_solve at the same shapes from two builds of blocks.cu that
    take one D = 12 layout at every width (``_SOLVE12_DESIGNS``)."""
    import ctypes
    import inspect

    import torch
    from chip_smoke import _device_us, _random_blocks
    from score_tpu_torch.ops import blocks, build

    rows = []
    C, T = _CHAINS_3D
    while T >= 1:
        M = C * max(T // 2, 1)
        A = _random_blocks(M, 12, seed=T, device=device)
        fn = lambda: blocks.block_chol(A)
        rows.append(dict(cell="3D f32 band", kernel="block_chol", shape=f"M={M} D=12",
                         device_us=_device_us(fn), event_ms=_event_ms(fn)))
        T //= 2
    M = C * _CHAINS_3D[1] // 2
    L = blocks.block_chol(_random_blocks(M, 12, seed=1, device=device))
    rhs = {K: torch.randn(M, 12, K, device=device) for K in _SOLVE12_WIDTHS}
    for K, B in rhs.items():
        fn = lambda: blocks.block_chol_solve(L, B)
        rows.append(dict(cell="3D f32 band", kernel="block_chol_solve", shape=f"M={M} D=12 K={K}",
                         device_us=_device_us(fn), event_ms=_event_ms(fn)))
    U = torch.randn(C, _CHAINS_3D[1], 12, 12, device=device)
    Bt, Bs = U[:, 0::2].transpose(-1, -2).reshape(M, 12, 12), U[:, 1::2].reshape(M, 12, 12)
    two_rhs = "B2" in inspect.signature(blocks.block_chol_solve).parameters
    if two_rhs:
        fn, what = lambda: blocks.block_chol_solve(L, Bt, Bs), "one two-rhs launch"
    else:
        fn = lambda: (blocks.block_chol_solve(L, Bt), blocks.block_chol_solve(L, Bs))
        what = "two launches"
    rows.append(dict(cell="3D f32 band", kernel="block_chol_solve",
                     shape=f"M={M} D=12 K=12 W2+W1 ({what})",
                     device_us=_device_us(fn), event_ms=_event_ms(fn)))
    if not two_rhs:
        return rows
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    procs = {}
    for design, width in _SOLVE12_DESIGNS.items():
        so = build.BUILD_DIR / f"solve12_{width}.so"
        procs[design] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, f"-DBLOCKS_WIDE_COLUMNS={width}", "-o", str(so),
             str(build.SOURCES["blocks"])], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
    for design, (so, proc) in procs.items():
        if proc.wait():
            raise RuntimeError(f"nvcc blocks.cu for {design} failed")
        lib = ctypes.CDLL(str(so))
        lib.block_chol_solve.argtypes = [vp, vp, vp, i64, i32, i32, i64, i64, i64,
                                         vp, vp, i64, i64, i64, vp]
        lib.block_chol_solve.restype = i32
        for K, B in rhs.items():
            X = torch.empty_like(B)
            want = blocks.block_chol_solve(L, B)

            def fn(B=B, X=X):
                build.raise_on(blocks._lib(), "block_chol_solve", lib.block_chol_solve(
                    L.data_ptr(), B.data_ptr(), X.data_ptr(), M, 12, K, *B.stride(),
                    None, None, 0, 0, 0, torch.cuda.current_stream().cuda_stream))
            fn()
            err = ((X - want).abs().max() / want.abs().max()).item()
            if not err <= 1e-5:
                raise AssertionError(f"block_chol_solve {design} K={K}: {err:.3e} from the package's")
            rows.append(dict(cell="3D f32 band", kernel=f"block_chol_solve, {design} only",
                             shape=f"M={M} D=12 K={K}", device_us=_device_us(fn),
                             event_ms=_event_ms(fn)))
    return rows


# the 3D instances' bands (chip_smoke._cells_3d): chains, padded chain
# length, arrow width; 12 x 12 blocks. Compaction floors of the sweep.
_BANDS_3D = {"3d-4x250": (4, 256, 18), "3d-1x1000": (1, 1024, 18)}
_FLOORS_3D = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def _depth_sweep_3d(device):
    """The Db = 12 band alone at both 3D shapes, for every compaction
    floor whose PCR remainder the cluster solve kernel takes: event ms of
    a factor, a panel solve (K = 18) and a direction (K = 1), launches, and
    the panel solve's band residual; and, at each remainder, band_pcr_solve
    at the panel and a direction with its cluster size forced to P = 4, 8
    and 16 (device us; P at most the remainder; the route takes
    ``band._SOLVE_CLUSTER``)."""
    import torch
    from chip_smoke import _band_residual, _device_us
    from score_tpu_torch.ops import band, build

    sweep, clusters = [], []
    for label, (C, Tp, K) in _BANDS_3D.items():
        D, U = _random_band(C, Tp, 12, seed=Tp + C, device=device)
        rng = np.random.default_rng(0)
        bK = torch.tensor(rng.standard_normal((C, Tp, 12, K)), device=device)
        b1 = torch.tensor(rng.standard_normal((C, Tp, 12, 1)), device=device)
        for floor in _FLOORS_3D:
            n = band.num_levels(Tp) - band.num_levels(floor)
            if n < 0:
                continue
            try:
                band._solve_cluster_plan(floor, 12, K)
            except ValueError:  # the remainder does not fit the solve kernel
                continue
            f = band.band_factor(D, U, n_cr=n)
            sweep.append(dict(
                cell=label, floor=floor, n_cr=n,
                factor_ms=_event_ms(lambda: band.band_factor(D, U, n_cr=n)),
                panel_ms=_event_ms(lambda: band.band_solve(f, bK)),
                direction_ms=_event_ms(lambda: band.band_solve(f, b1)),
                factor_launches=_launches(lambda: band.band_factor(D, U, n_cr=n)),
                solve_launches=_launches(lambda: band.band_solve(f, b1)),
                panel_residual=_band_residual(D, U, band.band_solve(f, bK), bK)))
            # the solve at this remainder, each cluster size forced
            Db, L = 12, f.E.shape[0]
            for k in (K, 1):
                b = torch.tensor(rng.standard_normal((C, floor, Db, k)), device=device)
                x = torch.empty_like(b)
                for P in (4, 8, 16):
                    if P > floor:
                        continue
                    try:
                        _, Kc = band._solve_cluster_plan(floor, Db, k, C, P=P)
                    except ValueError:  # fewer positions than P, or past the shared memory
                        continue

                    def fn(P=P, Kc=Kc):
                        build.raise_on(band._lib(), "band_pcr_solve", band._lib().band_pcr_solve(
                            f.E.data_ptr(), f.F.data_ptr(), f.invD.data_ptr(), b.data_ptr(),
                            x.data_ptr(), C, floor, Db, L, k, P, Kc,
                            torch.cuda.current_stream().cuda_stream))
                    fn()
                    err = ((x - band.band_pcr_solve_plain(f.E, f.F, f.invD, b)).abs().max()
                           / x.abs().max()).item()
                    clusters.append(dict(cell=label, floor=floor, K=k, P=P, Kc=Kc,
                                         chosen=(P, Kc) == band._solve_cluster_plan(floor, Db, k, C),
                                         device_us=_device_us(fn), max_rel_diff=err))
    return sweep, clusters
def _pcr3d_ablation(device):
    """What bounds the two Db = 12 PCR kernels at 3D 1x1000's remainder
    (C = 1, Tp = 256): band_pcr_level's device us built whole and built
    with -DBAND_LEVEL_NO_INVERSE (no inverse of D'), at the first and last
    level; and, from a build with -DBAND_CLUSTER_CLOCKS, the cluster
    band_pcr_solve's first worker's clock at each level's barrier, after
    its stage wait and after its products, in three blocks of the cluster,
    at K = 1 and at the panel's plan (K = 18)."""
    import torch
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band, build

    libs = _band_builds(["-DBAND_LEVEL_NO_INVERSE", "-DBAND_CLUSTER_CLOCKS"], "sweep3d")
    C, Tp, Db = 1, 256, 12
    D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
    f = band.band_factor(D, U, n_cr=0)
    A, invD = band.band_init_a(U), band.band_block_inv(D)
    outs = [torch.empty_like(D) for _ in range(6)]
    rows = []
    for s in (1, Tp // 2):
        def level(lib=None):
            if lib is None:
                return band.band_pcr_level(D, A, U, invD, s)
            build.raise_on(band._lib(), "band_pcr_level", lib.band_pcr_level(
                D.data_ptr(), A.data_ptr(), U.data_ptr(), invD.data_ptr(),
                *[o.data_ptr() for o in outs], C, Tp, Db, s,
                torch.cuda.current_stream().cuda_stream))
        rows.append(dict(kernel="band_pcr_level", s=s, whole_us=_device_us(level),
                         no_inverse_us=_device_us(
                             lambda: level(libs["-DBAND_LEVEL_NO_INVERSE"]))))
    lib = libs["-DBAND_CLUSTER_CLOCKS"]
    L = band.num_levels(Tp)
    clocks = []
    for K in (1, 18):
        P, Kc = band._solve_cluster_plan(Tp, Db, K, C)
        b = torch.randn(C, Tp, Db, K, dtype=torch.float64, device=device)
        x = torch.zeros_like(b)
        for _ in range(3):
            build.raise_on(band._lib(), "band_pcr_solve", lib.band_pcr_solve(
                f.E.data_ptr(), f.F.data_ptr(), f.invD.data_ptr(), b.data_ptr(), x.data_ptr(),
                C, Tp, Db, L, K, P, Kc, torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        t = x.flatten().cpu()
        for blk in (0, P // 2 - 1, P - 1):
            T = [t[blk * 32 + m].item() for m in range(1 + 3 * L)]
            levels, prev = [], 0.0
            for lev in range(L):
                levels.append(dict(barrier=T[1 + 3 * lev] - prev, stage=T[2 + 3 * lev] - T[1 + 3 * lev],
                                   products=T[3 + 3 * lev] - T[2 + 3 * lev]))
                prev = T[3 + 3 * lev]
            clocks.append(dict(K=K, P=P, Kc=Kc, block=blk, levels=levels))
    return rows, clocks


def _floor_walls_3d(fg, relaxation, configs, device="cuda", rounds=2):
    """Warm solves of a 3D graph for each (compaction floor, refinement
    steps) of ``configs`` (``band.CR_BASE_LENGTH``,
    ``band.REFINE_STEPS_3D``), taking turns: walls, iterations, relative gap
    and dual residual, which both move (the band's explicit inverses of
    12 x 12 blocks cost the dual residual digits)."""
    import torch
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.ops import band

    default = band.CR_BASE_LENGTH, band.REFINE_STEPS_3D
    params = ScoreSolverParams(device=device)
    out = {}
    try:
        for r in range(rounds + 1):  # round 0 warms up
            for floor, refine in configs:
                band.CR_BASE_LENGTH, band.REFINE_STEPS_3D = floor, refine
                t0 = time.perf_counter()
                res = solve_score(fg, relaxation, params)
                if device == "cuda":
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                row = out.setdefault(f"floor {floor} refine {refine}", dict(
                    walls_s=[], iterations=res.iterations, solved=res.solved,
                    relgap=res.gap / max(1.0, abs(res.primal_objective)),
                    dres=res.dual_residual))
                if r:
                    row["walls_s"].append(wall)
    finally:
        band.CR_BASE_LENGTH, band.REFINE_STEPS_3D = default
    return out


def _sweep_3d(smi):
    """--sweep3d: the Db = 12 depth and tile sweep, the floor's walls and
    accuracy on 3D 4x250 QCQP and SOCP, warm walls and a profiled solve of
    each 3D instance, and 3D 1x1000 SOCP on the CPU (the port's plain
    path, against the JAX package's CPU run of the same graph)."""
    import torch
    from chip_smoke import _cells_3d
    from score_tpu_torch import ScoreSolverParams, solve_score

    dev = torch.device("cuda")
    report = dict(card=smi)
    sweep, clusters = _depth_sweep_3d(dev)
    report.update(depth_sweep=sweep, clusters=clusters)
    smi_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    level_rows, clocks = _pcr3d_ablation(dev)
    report.update(pcr3d_ablation=level_rows, cluster_clocks=clocks, sm_clock=smi_clock)
    for r in level_rows:
        _log(f"  band_pcr_level[Db=12] C=1 Tp=256 s={r['s']}: whole {r['whole_us']:.2f} us, "
             f"without the inverse of D' {r['no_inverse_us']:.2f} us")
    _log(f"  cluster band_pcr_solve clocks (SM clock {smi_clock}), barrier/stage/products "
         f"cycles a level:")
    for r in clocks:
        _log(f"    K={r['K']} P={r['P']} Kc={r['Kc']} block {r['block']}: " + " ".join(
            f"{v['barrier']:.0f}/{v['stage']:.0f}/{v['products']:.0f}" for v in r["levels"]))
    for r in sweep:
        _log(f"  {r['cell']} floor {r['floor']:4d} (CR depth {r['n_cr']}): factor "
             f"{r['factor_ms']:.4f} ms ({r['factor_launches']} launches), panel "
             f"{r['panel_ms']:.4f} ms, direction {r['direction_ms']:.4f} ms "
             f"({r['solve_launches']} launches), panel residual {r['panel_residual']:.2e}")
    for r in clusters:
        _log(f"  {r['cell']} remainder {r['floor']:4d} K={r['K']} P={r['P']} Kc={r['Kc']}"
             f"{' (route)' if r['chosen'] else ''}: band_pcr_solve {r['device_us']:.2f} us "
             f"(max_rel_diff {r['max_rel_diff']:.2e})")
    cells = dict(_cells_3d())
    report["floors"] = {}
    configs = [(f, r) for f in (4, 16, 64, 256) for r in (0, 1)]
    for relaxation in ("QCQP", "SOCP"):
        rows = report["floors"][relaxation] = _floor_walls_3d(
            cells["3d-4x250"], relaxation, configs)
        for key, w in rows.items():
            _log(f"  3d-4x250 {relaxation} {key}: {w}")
    # the same QCQP by the port's plain path on the CPU, and with the chain
    # band factored by solver/pcr.py in f64 instead (cyclic reduction with a
    # Cholesky solve per block, the JAX package's f64 band algorithm): does
    # the band's arithmetic set the QCQP's dual residual?
    rows = report["floors"]["QCQP-cpu"] = _floor_walls_3d(
        cells["3d-4x250"], "QCQP", [(4, 0), (4, 1), (256, 0), (256, 1)], "cpu", rounds=1)
    from score_tpu_torch.solver import chain_arrow, pcr

    saved = chain_arrow.band_factor, chain_arrow.band_solve
    chain_arrow.band_factor, chain_arrow.band_solve = pcr.pcr_factor, pcr.pcr_solve
    try:
        rows["pcr.py band"] = _floor_walls_3d(
            cells["3d-4x250"], "QCQP", [(4, 0)], "cpu", rounds=1)["floor 4 refine 0"]
    finally:
        chain_arrow.band_factor, chain_arrow.band_solve = saved
    for key, w in rows.items():
        _log(f"  3d-4x250 QCQP on the CPU {key}: {w}")
    for label, fg in cells.items():
        cell = report[label] = dict(warm=_warm_walls(fg), profile=_profile_solve(fg))
        p = cell["profile"]
        _log(f"{label}: warm {cell['warm']}")
        _log(f"{label}: profiled solve: device busy {p['device_busy_ms']:.3f} ms, "
             f"{p['kernel_launches']} kernel launches")
        for o in p["top_ops"]:
            _log(f"  {o['op']:<40} {o['device_ms']:9.3f} ms {o['calls']:7d} calls")
        for name, b in p["hand_kernels"].items():
            _log(f"  band {name:<22} {b['device_ms']:9.3f} ms {b['launches']:5d} launches")
    t0 = time.perf_counter()
    res = solve_score(cells["3d-1x1000"], "SOCP", ScoreSolverParams(device="cpu"))
    report["cpu_3d_1x1000"] = dict(
        solved=res.solved, iterations=res.iterations, wall_s=time.perf_counter() - t0,
        relgap=res.gap / max(1.0, abs(res.primal_objective)),
        ranges=cells["3d-1x1000"].num_range_measurements)
    _log(f"3d-1x1000 SOCP on the CPU: {report['cpu_3d_1x1000']}")
    return report


def _solve_ablation(device):
    """Device us of band_pcr_solve built whole and with parts of its level
    loop compiled out, with all levels and with no level, at the shapes of
    ``_REMAINDERS`` (a direction and the panel)."""
    import ctypes

    import torch
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band, build

    vp, i32 = ctypes.c_void_p, ctypes.c_int
    rows = []
    for flags in ((), ("-DBAND_NO_STAGING",), ("-DBAND_NO_PRODUCT",),
                  ("-DBAND_NO_STAGING", "-DBAND_NO_PRODUCT")):
        so = build.BUILD_DIR / ("ablate" + "".join(f[2:] for f in flags) + ".so")
        build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *flags, "-o", str(so),
                        str(build.SOURCES["band"])], check=True, capture_output=True)
        lib = ctypes.CDLL(str(so))
        lib.band_pcr_solve.argtypes = [vp] * 5 + [i32] * 7 + [vp]
        lib.band_pcr_solve.restype = i32
        for label, (C, Tp, K) in _REMAINDERS.items():
            D, U = _random_band(C, Tp, 6, seed=Tp + C, device=device)
            f = band.band_factor(D, U, n_cr=0)
            for k in (1, K):
                b = torch.randn(C, Tp, 6, k, dtype=torch.float64, device=device)
                x = torch.empty_like(b)
                ct = band._solve_tile_columns(Tp, 6, k)
                groups = band._solve_groups(Tp, 6, k, C) if ct == 8 else 1
                for L in (band.num_levels(Tp), 0):
                    def fn():
                        err = lib.band_pcr_solve(
                            f.E.data_ptr(), f.F.data_ptr(), f.invD.data_ptr(), b.data_ptr(),
                            x.data_ptr(), C, Tp, 6, L, k, ct, groups,
                            torch.cuda.current_stream().cuda_stream)
                        if err:
                            raise RuntimeError(f"band_pcr_solve: CUDA error {err}")
                    rows.append(dict(cell=label, build=" ".join(flags) or "whole",
                                     shape=f"C={C} Tp={Tp} K={k}", levels=L,
                                     device_us=_device_us(fn)))
    return rows


def _refine_report(top=8):
    """--refine: the refinement stage's first trials, walls and one
    profiled outer iteration on Manhattan-4 and 3D 4x250."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from chip_smoke import _cells, _cells_3d
    from score_tpu_torch import RefineParams, ScoreSolverParams, refine_solution, solve_score
    from score_tpu_torch.refine import lm

    report = {}
    for label, fg in (_cells()[0], _cells_3d()[0]):
        start = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda")).variables
        g, pose_names, lm_names = lm._compile_graph(fg, "cuda")
        d = fg.dimension
        base = tuple(torch.tensor(np.stack(a), device="cuda") for a in (
            [start.poses[n][:d, :d] for n in pose_names],
            [start.poses[n][:d, d] for n in pose_names],
            [start.landmarks[n] for n in lm_names]))
        n = g.P * g.rdim + g.P * d + g.L * d
        mask = torch.ones(n, dtype=torch.float64, device="cuda")
        mask[: g.rdim] = 0.0
        mask[g.P * g.rdim: g.P * g.rdim + d] = 0.0

        def residual(delta):
            return lm._residuals(g, *lm._retract(g, base, delta, mask))

        r0, jvp_fn, vjp_fn = lm._linearize(residual, torch.zeros(n, dtype=torch.float64,
                                                                 device="cuda"))
        rhs = -vjp_fn(r0)
        trials = []
        for lam in (1e-4, 4e-4, 1.6e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0, 1e3, 1e4):
            step = lm._solve_normal_cg(jvp_fn, vjp_fn, rhs,
                                       torch.tensor(lam, dtype=torch.float64, device="cuda"), 60)
            r = residual(step)
            trials.append(dict(lam=lam, step_norm=step.norm().item(), cost=(r @ r).item()))
        row = dict(initial_cost=(r0 @ r0).item(), first_trials=trials)
        _log(f"{label}: initial cost {row['initial_cost']:.6e}; first trial cost by lambda: "
             + ", ".join(f"{t['lam']:g}: {t['cost']:.4e}" for t in trials))
        for name, params in (("default", RefineParams()),
                             ("no_stall", RefineParams(stall_limit=10 ** 6))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = refine_solution(fg, start, params, device="cuda")
            torch.cuda.synchronize()
            row[name] = dict(iterations=out.iterations, initial_cost=out.initial_cost,
                             cost=out.cost, wall_s=time.perf_counter() - t0)
            _log(f"{label} refine {name}: {row[name]}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            refine_solution(fg, start, RefineParams(max_iter=1), device="cuda")
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        row["one_iteration"] = dict(
            launches=sum(e.count for e in kernels),
            device_busy_ms=sum(e.self_device_time_total for e in kernels) / 1e3,
            top=[dict(kernel=e.key[:90], launches=e.count,
                      device_ms=e.self_device_time_total / 1e3)
                 for e in sorted(kernels, key=lambda e: -e.count)[:top]])
        _log(f"{label} one outer iteration: {row['one_iteration']['launches']} launches, "
             f"{row['one_iteration']['device_busy_ms']:.3f} device ms")
        for k in row["one_iteration"]["top"]:
            _log(f"    {k['launches']:6d}  {k['device_ms']:8.3f} ms  {k['kernel']}")
        report[label] = row
    return report


# the band factors of the cells: (label, chains, chain length, block size).
# Manhattan-4, robot20, 3D 4x250 and 3D 1x1000 (chip_smoke.py's solves),
# the 100-trial 2D fold and the 16-trial 3D fold (a Monte-Carlo batch's).
_FACTOR_CELLS = (("manhattan4", 4, 512, 6), ("robot20", 20, 128, 6), ("3d-4x250", 4, 256, 12),
                 ("3d-1x1000", 1, 1024, 12), ("mc", 400, 64, 6), ("mc3d", 64, 256, 12))
# measurement builds of csrc/band.cu for --factor: the element and group
# inversions compiled out (what the rest of a factor costs), and
# band_cr_factor's clocks; a flag the source does not know is not built
_FACTOR_BUILDS = {"no inverse": "-DBAND_LEVEL_NO_INVERSE",
                  "clocks": "-DBAND_FACTOR_CLOCKS"}


def _factor_bound_us(C, Tp, Db):
    """The least time of a whole factor (band_init_a excluded) on the card,
    us: D, A and C read once, every level's E, F, invD, A and C written
    once and the last invD once, over the HBM rate; the intermediate levels'
    D', A' and C' never reach HBM."""
    from chip_smoke import HBM_BYTES_PER_S

    blocks = 3 * C * Tp + 5 * sum(C * (Tp >> lev) for lev in range(1, Tp.bit_length())) + C
    return blocks * Db * Db * 8 / HBM_BYTES_PER_S * 1e6


def _factor_times(device, builds=True):
    """The band factor (``band_factor`` at the default schedule, its
    ``band_init_a`` replaced by the A it gave) at ``_FACTOR_CELLS``: device
    us of the whole factor (a replayed CUDA graph), event ms, its launches
    and the fused bound; each of its launches alone, fed as the factor feeds
    it (where ``band_cr_factor`` takes the factor: each run; else each
    ``band_cr_level`` level and ``band_block_inv``); where the package plans
    band_cr_level's tile, the 3D fold's factor and its levels at each tiling
    of ``_CR_LEVEL_TILINGS`` forced; with ``builds``, the whole factor from
    each build of ``_FACTOR_BUILDS`` that the source takes."""
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band, build

    source = build.SOURCES["band"].read_text()
    flags = {what: f for what, f in _FACTOR_BUILDS.items()
             if builds and all(m[2:].split("=")[0] in source for m in f.split())}
    libs = _band_builds(list(flags.values()), "factor") if flags else {}
    rows = []
    tilings = _CR_LEVEL_TILINGS if hasattr(band, "_cr_level_tile") else ()
    init_a = band.band_init_a
    for label, C, Tp, Db in _FACTOR_CELLS:
        runs = hasattr(band, "band_cr_factor") and band._factor_takes(Db)
        D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
        A = init_a(U)
        band.band_init_a = lambda _U: A
        try:
            fn = lambda: band.band_factor(D, U)
            band.reset_launch_counts()
            fn()
            launches = sum(k.launches for k in band.KERNELS)
            shape = f"C={C} Tp={Tp} Db={Db}"
            rows.append(dict(cell=label, kernel="factor", shape=shape, launches=launches,
                             bound_us=_factor_bound_us(C, Tp, Db), device_us=_device_us(fn),
                             event_ms=_event_ms(fn)))
            for P in tilings if label == "mc3d" else ():
                with _forced_tile(P):
                    rows.append(dict(cell=label, kernel=f"factor, level P={P}", shape=shape,
                                     device_us=_device_us(fn), event_ms=_event_ms(fn)))
            for what, flag in flags.items():
                rows.append(dict(cell=label, kernel=f"factor, {what}", shape=shape,
                                 device_us=_through(libs[flag], lambda: _device_us(fn)),
                                 event_ms=_through(libs[flag], lambda: _event_ms(fn))))
        finally:
            band.band_init_a = init_a
        parts = []
        if runs:
            Dl, Al, Cl, T = D, A, U, Tp
            for n in band._factor_runs(Tp, Db):
                last = T == 1 << n
                parts.append((f"band_cr_factor {T} -> {T >> n}",
                              lambda a=(Dl, Al, Cl, n, last): band.band_cr_factor(*a)))
                if not last:
                    out = band.band_cr_factor(Dl, Al, Cl, n)
                    Dl, Al, Cl, T = out.D, out.A, out.C, T >> n
        else:
            Dl, Al, Cl = D, A, U
            for lev in range(band.cr_depth(Tp)):
                parts.append((f"band_cr_level {Tp >> lev} -> {Tp >> lev + 1}",
                              lambda a=(Dl, Al, Cl): band.band_cr_level(*a)))
                Dl, Al, Cl = band.band_cr_level(Dl, Al, Cl)[5:]
            parts.append(("band_block_inv", lambda Dl=Dl: band.band_block_inv(Dl)))
        for what, part in parts:
            rows.append(dict(cell=label, kernel=what, shape=f"C={C} Db={Db}",
                             device_us=_device_us(part), event_ms=_event_ms(part)))
            if "clocks" in flags and runs:
                clk = _through(libs[flags["clocks"]], part).levels[0].E.flatten()[:32]
                rows.append(dict(cell=label, kernel=f"{what}, clocks", shape=f"C={C} Db={Db}",
                                 clocks=[int(v) for v in clk.tolist()]))
            if "no inverse" in flags and (Db > 8 or runs):
                rows.append(dict(cell=label, kernel=f"{what}, no inverse", shape=f"C={C} Db={Db}",
                                 device_us=_through(libs[flags["no inverse"]],
                                                    lambda: _device_us(part)),
                                 event_ms=0.0))
            for P in tilings if label == "mc3d" and what.startswith("band_cr_level") else ():
                with _forced_tile(P):
                    rows.append(dict(cell=label, kernel=f"{what}, level P={P}",
                                     shape=f"C={C} Db={Db}", device_us=_device_us(part),
                                     event_ms=0.0))
    return rows


# band_cr_factor's plans timed beside the planner's (profile_port.py
# --factor --builds): the most levels of the last run (a chain a thread
# block), at Db = 6, the size it is built for
_FACTOR_SWEEP = {6: (4, 5, 6, 7)}


def _factor_sweep(device):
    """Device us of each cell's factor by band_cr_factor's runs under each
    last-run length of ``_FACTOR_SWEEP`` (the planner's constants replaced
    for the call)."""
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band

    rows = []
    keep = band._FACTOR_WHOLE_LEVELS, band._FACTOR_CHAIN_LEVELS
    init_a = band.band_init_a
    for label, C, Tp, Db in _FACTOR_CELLS:
        if Db not in _FACTOR_SWEEP:
            continue
        D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
        A = init_a(U)
        for levels in _FACTOR_SWEEP[Db]:
            band._FACTOR_WHOLE_LEVELS = band._FACTOR_CHAIN_LEVELS = levels
            band.band_init_a = lambda _U: A
            try:
                band.reset_launch_counts()
                band.band_factor(D, U)
                rows.append(dict(cell=label, runs=str(band._factor_runs(Tp, Db)),
                                 launches=band.band_cr_factor.launches,
                                 device_us=_device_us(lambda: band.band_factor(D, U))))
            except (RuntimeError, ValueError) as e:
                rows.append(dict(cell=label, runs=f"last {levels}", launches=0,
                                 device_us=f"refused: {e}"))
            finally:
                band._FACTOR_WHOLE_LEVELS, band._FACTOR_CHAIN_LEVELS = keep
                band.band_init_a = init_a
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the full report as JSON to this file")
    ap.add_argument("--kernels", action="store_true",
                    help="time only the redesigned kernels")
    ap.add_argument("--walls", action="store_true",
                    help="warm Manhattan-4 walls in f32 and f64, and the f32 launch count")
    ap.add_argument("--ablate", action="store_true",
                    help="time band_pcr_solve with parts of its level loop compiled out")
    ap.add_argument("--sweep3d", action="store_true",
                    help="3D: Db = 12 depth and tile sweep, floors, walls, CPU 1x1000")
    ap.add_argument("--refine", action="store_true",
                    help="the refinement stage: first trials, walls, one profiled iteration")
    ap.add_argument("--batch", action="store_true",
                    help="the Monte-Carlo batch at 1, 16 and 100 trials: walls, trips, profile")
    ap.add_argument("--schedule", action="store_true",
                    help="the band's compaction floor, 256 against 1: walls and profiles")
    ap.add_argument("--cr", action="store_true",
                    help="band_cr_reduce and band_cr_backsub alone at the cells' runs, "
                         "with the clock build's phases")
    ap.add_argument("--pass", dest="one_pass", action="store_true",
                    help="with --cr: one band-solve pass at the cells, K = 1, 2, panel")
    ap.add_argument("--sweep", action="store_true",
                    help="with --cr --pass: the chain kernels' plans of _PASS_SWEEP")
    ap.add_argument("--tally", action="store_true",
                    help="with --cr --pass: the passes of four solves by rhs width")
    ap.add_argument("--clocks", action="store_true",
                    help="with --cr --pass: the clock build's phases of the passes of "
                         "_PASS_CLOCKS")
    ap.add_argument("--factor", action="store_true",
                    help="the band factor alone at the cells: whole and launch by launch")
    ap.add_argument("--builds", action="store_true",
                    help="with --factor: also from the measurement builds of band.cu")
    ap.add_argument("--root", help="import score_tpu_torch from this checkout")
    args = ap.parse_args()
    if args.root:
        sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("profile_port: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    _log(smi)

    if args.factor:
        import score_tpu_torch

        _log(f"package: {Path(score_tpu_torch.__file__).parent}")
        rows = _factor_times(torch.device("cuda"), builds=args.builds)
        for r in rows:
            if "clocks" in r:
                _log(f"  {r['cell']:<10} {r['kernel']:<34} {r['shape']:<22} clocks {r['clocks']}")
                continue
            extra = (f"   launches {r['launches']}   bound {r['bound_us']:.2f} us"
                     if "launches" in r else "")
            _log(f"  {r['cell']:<10} {r['kernel']:<34} {r['shape']:<22} "
                 f"device {r['device_us']:9.2f} us   events {r['event_ms']:.4f} ms{extra}")
        from score_tpu_torch.ops import band

        if args.builds and hasattr(band, "band_cr_factor"):
            sweep = _factor_sweep(torch.device("cuda"))
            rows += sweep
            for r in sweep:
                _log(f"  {r['cell']:<10} sweep runs {r['runs']:<10} "
                     f"launches {r['launches']}  device {r['device_us']}")
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(dict(card=smi, factor=rows), indent=1))
        return 0
    if args.schedule:
        report = dict(card=smi, **_schedule_report())
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1))
        return 0
    if args.batch:
        report = dict(card=smi, **_batch_report())
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1))
        return 0
    if args.refine:
        report = dict(card=smi, **_refine_report())
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1))
        return 0
    if args.sweep3d:
        report = _sweep_3d(smi)
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1))
        return 0
    if args.ablate:
        rows = _solve_ablation(torch.device("cuda"))
        for r in rows:
            _log(f"  {r['cell']:<11} {r['shape']:<20} {r['build']:<38} "
                 f"levels={r['levels']}  device {r['device_us']:9.2f} us")
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(dict(card=smi, ablation=rows), indent=1))
        return 0
    if args.cr and args.one_pass:
        import score_tpu_torch

        _log(f"package: {Path(score_tpu_torch.__file__).parent}")
        report = dict(card=smi, passes=_pass_times(torch.device("cuda")))
        for r in report["passes"]:
            each = ", ".join(f"{e['kernel'][8:]}{e['levels']} {e['device_us']:.2f}"
                             for e in r["each"])
            _log(f"  pass {r['cell']:<10} K={r['K']:<4} reduce {r['reduce_us']:8.2f} us "
                 f"(bound {r['reduce_bound_us']:.2f})  pcr_solve {r['pcr_solve_us']:6.2f}  "
                 f"backsub {r['backsub_us']:8.2f} us (bound {r['backsub_bound_us']:.2f})  "
                 f"launches {r['launches']}  each: {each}")
        if args.sweep:
            report["sweep"] = _pass_sweep(torch.device("cuda"))
            for r in report["sweep"]:
                _log(f"  sweep {r['cell']:<10} K={r['K']:<4} {r['step']:<8} {r['plan']:<70} "
                     f"{'(planner) ' if r.get('planner') else ''}device {r['device_us']}")
            report["builds"] = _pass_builds(torch.device("cuda"))
            for r in report["builds"]:
                _log(f"  build {r['cell']:<10} K={r['K']:<4} reduce {r['build']:<32} "
                     f"device {r['device_us']}")
        if args.clocks:
            clocks = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip()
            _log(f"SM clocks (current, max): {clocks}")
            report["clocks"] = _pass_clocks(torch.device("cuda"))
            for r in report["clocks"]:
                _log(f"  clocks {r['cell']:<10} K={r['K']:<4} {r['kernel']:<16} levels "
                     f"{r['levels']}: {r['clocks']}")
        if args.tally:
            report["tally"] = _pass_tally()
            for label, t in report["tally"].items():
                _log(f"  tally {label}: {t}")
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1))
        return 0
    if args.kernels or args.cr:
        import score_tpu_torch

        if args.cr:
            clocks = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip()
            _log(f"SM clocks (current, max): {clocks}")
        rows = (_cr_solve_times(torch.device("cuda"), layouts=False) if args.cr
                else _kernel_times(torch.device("cuda")))
        from score_tpu_torch.ops import band

        _log(f"package: {Path(score_tpu_torch.__file__).parent}")
        for r in rows:
            if "clocks" in r:
                _log(f"  {r['cell']:<11} {r['kernel']:<15} {r['shape']:<36} clocks {r['clocks']}")
                continue
            launches = f"   launches {r['launches']}" if "launches" in r else ""
            _log(f"  {r['cell']:<11} {r['kernel']:<15} {r['shape']:<36} "
                 f"device {r['device_us']:9.2f} us   events {r['event_ms']:.4f} ms{launches}")
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(dict(card=smi, kernels=rows), indent=1))
        return 0

    from chip_smoke import _cells, _cells_3d

    if args.walls:
        import score_tpu_torch

        _log(f"package: {Path(score_tpu_torch.__file__).parent}")
        report = dict(card=smi)
        # 3D 1x1000 f64 SOCP: band_cr_reduce and band_cr_backsub at Db = 12
        label, fg = _cells_3d()[1]
        key = f"{label}-socp-f64"
        report[key] = _warm_walls(fg, n=3)
        _log(f"{key}: warm {report[key]}")
        report[key + "_assembly_s"] = _assembly_walls(fg)
        _log(f"{key}: assembly (memo miss) {report[key + '_assembly_s']}")
        p = report[key + "_profile"] = _profile_solve(fg)
        _log(f"{key}: profiled solve: device busy {p['device_busy_ms']:.3f} ms, "
             f"{p['kernel_launches']} kernel launches")
        for name, b in p["hand_kernels_by_instance"].items():
            _log(f"  kernel {name:<24} {b['device_ms']:9.3f} ms {b['launches']:5d} launches")
        cr = p["cr_kernels_db12"] = _block_kernels_at(p, 12, _CR_WRAPPERS, "Db")
        _log(f"{key}: " + ", ".join(f"{k} {ms:.3f} ms, {n} launches" for k, (ms, n) in cr.items()))
        lv = p["level_kernels_db12"] = _block_kernels_at(p, 12, _LEVEL_WRAPPERS, "Db")
        _log(f"{key}: " + ", ".join(f"{k} {ms:.3f} ms, {n} launches" for k, (ms, n) in lv.items()))
        label, fg = _cells()[0]
        for precision in ("f32", "f64"):
            report[precision] = _warm_walls(fg, n=5, precision=precision)
            _log(f"{label}-{precision}: warm {report[precision]}")
        report["f64_assembly_s"] = _assembly_walls(fg)
        _log(f"{label}-f64: assembly (memo miss) {report['f64_assembly_s']}")
        for precision in ("f32", "f64"):
            p = report[f"{precision}_profile"] = _profile_solve(fg, precision=precision)
            _log(f"{label}-{precision}: profiled solve: device busy {p['device_busy_ms']:.3f} "
                 f"ms, {p['kernel_launches']} kernel launches")
            for name, b in p["hand_kernels"].items():
                _log(f"  kernel {name:<24} {b['device_ms']:9.3f} ms {b['launches']:5d} launches")
        m4 = _block_kernels_at(report["f32_profile"], 6)
        _log(f"{label}-f32: " + ", ".join(f"{k} {ms:.3f} ms, {n} launches"
                                          for k, (ms, n) in m4.items()))
        (l4, fg4), (l1, fg1) = _cells_3d()
        for label, fg, relaxation, n in ((l4, fg4, "SOCP", 5), (l4, fg4, "QCQP", 5),
                                         (l1, fg1, "SOCP", 3)):
            key = f"{label}-{relaxation.lower()}-f32"
            report[key] = _warm_walls(fg, n=n, precision="f32", relaxation=relaxation)
            _log(f"{key}: warm {report[key]}")
            p = report[key + "_profile"] = _profile_solve(fg, precision="f32",
                                                          relaxation=relaxation)
            _log(f"{key}: profiled solve: device busy {p['device_busy_ms']:.3f} ms, "
                 f"{p['kernel_launches']} kernel launches")
            for name, b in p["hand_kernels_by_instance"].items():
                _log(f"  kernel {name:<24} {b['device_ms']:9.3f} ms {b['launches']:5d} launches")
            d12 = p["block_kernels_d12"] = _block_kernels_at(p, 12)
            _log(f"{key}: " + ", ".join(f"{k} {ms:.3f} ms, {n} launches"
                                        for k, (ms, n) in d12.items()))
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1))
        return 0

    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.assembly.normalize import normalize_factor_graph
    from score_tpu_torch.ops import band
    from score_tpu_torch.solver.chain_arrow import build_chain_arrow

    report = dict(card=smi, torch=torch.__version__, cells={})
    dev = torch.device("cuda")
    for label, fg in _cells():
        t0 = time.perf_counter()
        problem, idx = build_conic_problem(normalize_factor_graph(fg)[0], "SOCP",
                                           device=dev)
        t1 = time.perf_counter()
        st = build_chain_arrow(problem, idx)
        t2 = time.perf_counter()
        C, Tp, K = st.C, band.pad_length(st.T), st.A
        cell = dict(C=C, Tp=Tp, arrow_width=K, cr_depth=band.cr_depth(Tp),
                    build_conic_s=t1 - t0, build_chain_arrow_s=t2 - t1)
        cell["warm"] = _warm_walls(fg)
        cell["profile"] = _profile_solve(fg)
        cell["depth_sweep"] = _depth_sweep(C, Tp, K, dev)
        cell["forced_depth_warm"] = _forced_depth_walls(fg, Tp)
        report["cells"][label] = cell

        p = cell["profile"]
        _log(f"{label}: C={C} Tp={Tp} A={K} default CR depth {cell['cr_depth']}; "
             f"build_conic {cell['build_conic_s']:.4f} s, build_chain_arrow "
             f"{cell['build_chain_arrow_s']:.4f} s")
        _log(f"{label}: warm {cell['warm']}")
        _log(f"{label}: profiled solve: device busy {p['device_busy_ms']:.3f} ms, "
             f"{p['kernel_launches']} kernel launches")
        for o in p["top_ops"]:
            _log(f"  {o['op']:<40} {o['device_ms']:9.3f} ms {o['calls']:7d} calls")
        for name, b in p["hand_kernels"].items():
            _log(f"  band {name:<22} {b['device_ms']:9.3f} ms {b['launches']:5d} launches")
        for r in cell["depth_sweep"]:
            _log(f"  depth {r['n_cr']}: factor {r['factor_ms']:.4f} ms "
                 f"({r['factor_launches']} launches), panel {r['panel_ms']:.4f} ms, "
                 f"direction {r['direction_ms']:.4f} ms ({r['solve_launches']} launches)")
        for n, w in cell["forced_depth_warm"].items():
            _log(f"  solve at depth {n}: {w}")

    # the f32 fast mode on Manhattan-4
    label, fg = _cells()[0]
    cell = dict(precision="f32", warm=_warm_walls(fg, precision="f32"),
                profile=_profile_solve(fg, precision="f32"))
    report["cells"][label + "-f32"] = cell
    p = cell["profile"]
    _log(f"{label}-f32: warm {cell['warm']}")
    _log(f"{label}-f32: profiled solve: device busy {p['device_busy_ms']:.3f} ms, "
         f"{p['kernel_launches']} kernel launches")
    for o in p["top_ops"]:
        _log(f"  {o['op']:<40} {o['device_ms']:9.3f} ms {o['calls']:7d} calls")
    for name, b in p["hand_kernels"].items():
        _log(f"  kernel {name:<20} {b['device_ms']:9.3f} ms {b['launches']:5d} launches")

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report, indent=1))
        _log(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
