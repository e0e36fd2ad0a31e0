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
   spill bytes of the redesigned kernels (``band_pcr_level``,
   ``band_cr_level``, ``band_pcr_solve``, ``band_cr_backsub``,
   ``block_chol``; a spill fails the run);
3. every band kernel against its plain PyTorch version on the card, at
   the band shapes of both instances below (Manhattan-4: C = 4 chains
   padded to Tp = 512, one compacting level; robot20: C = 20, Tp = 128,
   PCR only; Db = 6; rhs K = 1 and K = the instance's arrow width), at
   every level of a factor and two solves, each call fed the previous
   level's kernel outputs: the max relative difference
   (max |kernel - plain| / max |plain|) must be <= 1e-12 and the band
   residual <= 1e-10; median times of both at each kernel's first call
   (CUDA events around the wrapper, after warm-up) and the kernel's
   device time (a CUDA graph of 20 launches replayed between events), for
   the three solve kernels (``band_cr_reduce``, ``band_pcr_solve``,
   ``band_cr_backsub``) at K = 1 beside the panel; ``band_pcr_level`` and
   ``band_pcr_solve`` again at edge shapes (one and two blocks per chain,
   one chain, rhs widths off the column tiles), ``band_cr_level`` at chain
   lengths that put a thread block's edge inside a chain, on a chain's
   first position and past the last, ``band_cr_backsub`` at C = 1, 4, 20,
   coarse lengths 1, 2, 256, 1024 and K = 1, 2, 4, 5, 138, 258 (both of its
   kernels); then each block kernel against its plain version in f32 at
   the shapes of the f32 path (max relative difference <= 1e-5, and
   reconstruction residuals ||L L^T - A|| / ||A||, ||L Y - B|| / ||B||,
   ||L L^T X - B|| / ||B|| <= 1e-5), with its time, its plain version's and
   a library call's, ``block_chol`` also at D = 2, 6 and M = 1 to 2070 on
   contiguous and strided blocks, and its device time at every Cholesky of
   a Manhattan-4 f32 factor; the f32 band (cyclic reduction over the block kernels)
   against the f64 band at Manhattan-4's band shape (<= 1e-4); then a
   small instance solved on the card against the port's plain CPU path;
4. Manhattan-4 (4 robots x 400 poses, 6 landmarks, inter-robot ranges,
   seed 0) solved as SOCP on the card: solved status, relative gap <=
   1e-6, det(R) = +1 for every rounded pose, and every band kernel of its
   path (all seven) launched during the solve;
5. the same for the 20-robot world (20 x 100 poses, 10 landmarks, seed 20),
   whose arrow panel runs K in the hundreds and whose band runs the four
   PCR kernels only;
6. Manhattan-4 as QCQP in f64: the same checks;
7. the f32 fast mode (``precision="f32"``) on Manhattan-4, SOCP and QCQP,
   cold and warm: solved, relative gap <= 1e-2 (the mode's reduced
   tolerance), objective within 1e-2 relative of the f64 solve of the same
   relaxation, det(R) = +1 within 1e-5, ``block_chol`` and the fused
   ``block_chol_solve`` launched (for QCQP also at D = 2, the distance
   pivots), and neither the forward-only ``block_tri_lower_solve`` nor a
   plain back substitution on f32 tensors of the card;
8. a 4 x 50 world in f32 on the card against the port's f32 CPU path:
   both solved, iterations within 3, objectives within 2e-2;
9. one JSON line describing the kernels (event time, device time, plain
   time, the bound from bytes and operations, and a PyTorch call
   computing the same function where one exists), then the result line.

``python3 chip_smoke.py --kernels`` stops after the band and block
kernels' checks of phase 3 (a short first run after a kernel changed) and
prints no result line. Imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

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
    "band_cr_reduce": "score_tpu/ops/pallas_pcr.py:385",
    "band_cr_backsub": "score_tpu/ops/pallas_pcr.py:405",
    "block_chol": "score_tpu/ops/pallas_blocks.py:36",
    "block_tri_lower_solve": "score_tpu/ops/pallas_blocks.py:79",
    "block_chol_solve": "score_tpu/ops/pallas_blocks.py:79",
}
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


def _band_shape(fg):
    """(chains, padded chain length, arrow width) of the instance's band."""
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.assembly.normalize import normalize_factor_graph
    from score_tpu_torch.ops.band import pad_length
    from score_tpu_torch.solver.chain_arrow import build_chain_arrow

    problem, idx = build_conic_problem(normalize_factor_graph(fg)[0], "SOCP", device="cpu")
    st = build_chain_arrow(problem, idx)
    return st.C, pad_length(st.T), st.A


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
    if name == "band_cr_reduce":
        E, F, b = args
        n, K = b.shape[-2], b.shape[-1]
        rows = E.numel() // n ** 2
        return (E.numel() + F.numel() + b.numel() + b.numel() // 2) * f8, rows * (4 * n * n * K + 2 * n * K)
    if name == "band_pcr_solve":
        E, F, invD, b = args
        n, K = b.shape[-2], b.shape[-1]
        pos = invD.numel() // n ** 2
        L = E.shape[0]
        return ((E.numel() + F.numel() + invD.numel() + 2 * b.numel()) * f8,
                L * pos * (4 * n * n * K + 2 * n * K) + pos * 2 * n * n * K)
    if name == "band_cr_backsub":
        invD, A, C, b, xe = args
        n, K = b.shape[-2], b.shape[-1]
        rows = invD.numel() // n ** 2
        # the odd rows of b, the kept rows' solution, the fine solution out
        return ((3 * invD.numel() + b.numel() // 2 + xe.numel() + b.numel()) * f8,
                rows * (6 * n * n * K + 2 * n * K))
    raise KeyError(name)


def _blocks_cost(name, *args):
    """(bytes, flops) of one f32 block kernel call on these arguments."""
    f4 = 4
    if name == "block_chol":
        (A,) = args
        n = A.shape[-1]
        return 2 * A.numel() * f4, A.shape[0] * _chol_flops(n)
    if name == "block_tri_lower_solve":
        L, B = args
        n, K = B.shape[-2], B.shape[-1]
        return (L.numel() + 2 * B.numel()) * f4, B.shape[0] * K * n * n
    if name == "block_chol_solve":  # forward, then back substitution
        L, B = args
        n, K = B.shape[-2], B.shape[-1]
        return (L.numel() + 2 * B.numel()) * f4, B.shape[0] * K * 2 * n * n
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
            library_ms = _time_ms(library) if library is not None else None
            bound_ms, bound_by = _bound(*cost, self.precision)
            row = self.rows[name] = dict(max_abs_err=0.0, max_rel=0.0, calls=0,
                                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                                         device_us=device_us,
                                         bound_ms=bound_ms, bound_by=bound_by,
                                         bytes=cost[0], flops=cost[1])
        row["max_abs_err"] = max(row["max_abs_err"], abs_err)
        row["max_rel"] = max(row["max_rel"], rel_err)
        row["calls"] += 1
        return out


def _band_residual(D, U, x, b):
    """max |T x - b| / max |b| for the block-tridiagonal T of (D, U)."""
    Tx = D @ x
    Tx[:, 1:] += U[:, :-1].transpose(-1, -2) @ x[:, :-1]
    Tx[:, :-1] += U[:, :-1] @ x[:, 1:]
    return ((Tx - b).abs().max() / b.abs().max()).item()


def phase_kernels(label, C, Tp, K, device):
    """Phase 3 for one cell's band shape: every kernel against its plain
    version, at every level of a factor and of two solves (K = 1 and the
    cell's arrow width K), each call fed the kernels' outputs of the
    level before, as the main path feeds them."""
    import torch
    from score_tpu_torch.ops import band

    Db = 6
    D, U = _random_band(C, Tp, Db, seed=Tp + C, device=device)
    chk = _KernelCheck()
    n_cr = band.cr_depth(Tp)
    A = chk("band_init_a", lambda: band.band_init_a(U), lambda: band.band_init_a_plain(U),
            _band_cost("band_init_a", U))
    Dl, Al, Cl = D, A, U
    levels = []
    for _ in range(n_cr):
        args = (Dl, Al, Cl)
        out = chk("band_cr_level", lambda: band.band_cr_level(*args),
                  lambda: band.band_cr_level_plain(*args), _band_cost("band_cr_level", *args))
        levels.append(out[:5])
        Dl, Al, Cl = out[5:]
    Es, Fs = [], []
    invD = chk("band_block_inv", lambda: band.band_block_inv(Dl),
               lambda: band.band_block_inv_plain(Dl), _band_cost("band_block_inv", Dl),
               library=lambda: torch.linalg.inv(Dl))
    for lev in range(band.num_levels(Tp >> n_cr)):
        args = (Dl, Al, Cl, invD, 1 << lev)
        E, F, Dl, Al, Cl, invD = chk("band_pcr_level", lambda: band.band_pcr_level(*args),
                                     lambda: band.band_pcr_level_plain(*args),
                                     _band_cost("band_pcr_level", *args))
        Es.append(E)
        Fs.append(F)
    E, F = torch.stack(Es), torch.stack(Fs)
    rng = np.random.default_rng(Tp)
    resid = {}

    def solve_chk(name, kern, plain, cost):
        """chk for the solve kernels; at K = 1, a direction's times beside
        the panel's on the kernel's row, at the kernel's first such call."""
        out = chk(name, kern, plain, cost)
        row = chk.rows[name]
        if k == 1 and "k1_ms" not in row:
            bound_ms, bound_by = _bound(*cost, "f64")
            row.update(k1_ms=_time_ms(kern), k1_device_us=_device_us(kern),
                       k1_plain_ms=_time_ms(plain), k1_bound_ms=bound_ms, k1_bound_by=bound_by)
        return out

    for k in (K, 1):  # the panel first: its times are the ones reported
        b0 = torch.tensor(rng.standard_normal((C, Tp, Db, k)), device=device)
        b, fine = b0, []
        for lE, lF, *_ in levels:
            fine.append(b)
            bb = b
            b = solve_chk("band_cr_reduce", lambda: band.band_cr_reduce(lE, lF, bb),
                          lambda: band.band_cr_reduce_plain(lE, lF, bb),
                          _band_cost("band_cr_reduce", lE, lF, bb))
        bb = b
        x = solve_chk("band_pcr_solve", lambda: band.band_pcr_solve(E, F, invD, bb),
                      lambda: band.band_pcr_solve_plain(E, F, invD, bb),
                      _band_cost("band_pcr_solve", E, F, invD, bb))
        for (_, _, iv, Ao, Co), bf in zip(reversed(levels), reversed(fine)):
            xe = x
            x = solve_chk("band_cr_backsub", lambda: band.band_cr_backsub(iv, Ao, Co, bf, xe),
                          lambda: band.band_cr_backsub_plain(iv, Ao, Co, bf, xe),
                          _band_cost("band_cr_backsub", iv, Ao, Co, bf, xe))
        resid[k] = _band_residual(D, U, x, b0)
        if not resid[k] <= 1e-10:
            raise AssertionError(f"{label}: band residual {resid[k]:.3e} at K={k}")
    _log(f"{label} band: C={C} Tp={Tp} Db={Db} CR levels={n_cr} panel K={K} "
         f"residual K={K} {resid[K]:.3e} K=1 {resid[1]:.3e}")
    _log_rows(label, chk.rows)
    for name in ("band_cr_reduce", "band_pcr_solve", "band_cr_backsub"):
        if name not in chk.rows:
            continue
        r = chk.rows[name]
        _log(f"{label} kernel {name} at K=1: kernel_ms={r['k1_ms']:.4f} "
             f"device_us={r['k1_device_us']:.2f} plain_ms={r['k1_plain_ms']:.4f} "
             f"bound_ms={r['k1_bound_ms']:.6f} ({r['k1_bound_by']}); at the panel K={K}: "
             f"kernel_ms={r['ms']:.4f} device_us={r['device_us']:.2f}")
    missing = [k for k in _path_kernels(Tp) if k not in chk.rows]
    if missing:
        raise AssertionError(f"{label}: kernels not checked: {missing}")
    return chk.rows


def _log_rows(label, rows):
    for name, r in rows.items():
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        _log(f"{label} kernel {name}: calls={r['calls']} max_rel_diff={r['max_rel']:.3e} "
             f"max_abs_err={r['max_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
             f"device_us={r['device_us']:.2f} "
             f"plain_ms={r['plain_ms']:.4f} library_ms={lib} bound_ms={r['bound_ms']:.6f} "
             f"({r['bound_by']}: {r['bytes']} bytes, {r['flops']} flops)")


def phase_edge_shapes(device):
    """The two redesigned kernels, ``band_pcr_level`` at every level and
    ``band_pcr_solve``, against their plain versions at shapes off the two
    cells' that the main path can reach: a single block per chain (no
    level), two blocks, one chain, rhs widths that are no multiple of a
    column tile (K = 3, 139) and that meet the tiles' edges (4, 5, 8), and
    a chain longer than the wide solve kernel takes (Tp = 512)."""
    import torch
    from score_tpu_torch.ops import band

    Db, worst = 6, 0.0
    rng = np.random.default_rng(5)
    for C, Tp, Ks in [(3, 1, (1, 3)), (2, 2, (1, 3, 139)), (1, 256, (1, 2, 4, 5, 139)),
                      (4, 256, (3, 8, 139)), (20, 128, (3, 139)), (5, 32, (7,)),
                      (2, 512, (1, 3, 9))]:
        D, U = _random_band(C, Tp, Db, seed=7 * Tp + C, device=device)
        A = band.band_init_a(U)
        Cl, invD = U, band.band_block_inv(D)
        Es, Fs = [], []
        for lev in range(band.num_levels(Tp)):
            args = (D, A, Cl, invD, 1 << lev)
            out = band.band_pcr_level(*args)
            worst = max(worst, _compare(f"band_pcr_level C={C} Tp={Tp} s={1 << lev}", out,
                                        band.band_pcr_level_plain(*args))[1])
            E, F, D, A, Cl, invD = out
            Es.append(E)
            Fs.append(F)
        E = torch.stack(Es) if Es else D.new_zeros((0, C, Tp, Db, Db))
        F = torch.stack(Fs) if Fs else E
        for K in Ks:
            b = torch.tensor(rng.standard_normal((C, Tp, Db, K)), device=device)
            worst = max(worst, _compare(f"band_pcr_solve C={C} Tp={Tp} K={K}",
                                        band.band_pcr_solve(E, F, invD, b),
                                        band.band_pcr_solve_plain(E, F, invD, b))[1])
    # band_cr_level: a thread block holds 15 coarse positions. Fine lengths
    # 2 and 4 start chains inside a thread block, 30 on its first position,
    # 512 and 2048 cut chains at its edge
    worst_cr = 0.0
    for C, T in [(1, 2), (4, 2), (20, 4), (4, 30), (1, 512), (4, 512), (20, 512), (1, 2048)]:
        D, U = _random_band(C, T, Db, seed=11 * T + C, device=device)
        args = (D, band.band_init_a(U), U)
        worst_cr = max(worst_cr, _compare(f"band_cr_level C={C} T={T}",
                                          band.band_cr_level(*args),
                                          band.band_cr_level_plain(*args))[1])
    # band_cr_backsub: both kernels (narrow K <= 4, wide K >= 5; odd and
    # even K for the wide one's column pairs), a chain of one coarse position
    # (no upper neighbour anywhere), thread blocks that cut chains, and
    # robot20's panel width
    worst_bs = 0.0
    gen = torch.Generator(device=device).manual_seed(13)
    for C in (1, 4, 20):
        for Th in (1, 2, 256, 1024):
            D, U = _random_band(C, 2 * Th, Db, seed=13 * Th + C, device=device)
            _, _, iv, Ao, Co, *_ = band.band_cr_level(D, band.band_init_a(U), U)
            for K in (1, 2, 4, 5, 138, 258):
                b = torch.randn((C, 2 * Th, Db, K), generator=gen, dtype=torch.float64,
                                device=device)
                xe = torch.randn((C, Th, Db, K), generator=gen, dtype=torch.float64,
                                 device=device)
                worst_bs = max(worst_bs, _compare(
                    f"band_cr_backsub C={C} Th={Th} K={K}",
                    band.band_cr_backsub(iv, Ao, Co, b, xe),
                    band.band_cr_backsub_plain(iv, Ao, Co, b, xe))[1])
    torch.cuda.synchronize()
    _log(f"edge shapes: band_pcr_level and band_pcr_solve max_rel_diff={worst:.3e}, "
         f"band_cr_level max_rel_diff={worst_cr:.3e}, band_cr_backsub "
         f"max_rel_diff={worst_bs:.3e} (bound {REL_TOL})")


def _ptxas_report(log, kernel):
    """(registers, spill store bytes, spill load bytes), the worst over the
    instantiations of ``kernel`` in nvcc's ptxas output."""
    import re

    regs = stores = loads = 0
    found = False
    lines = log.splitlines()
    for n, line in enumerate(lines):
        if "Compiling entry function" in line and kernel in line:
            found = True
            for nxt in lines[n + 1:n + 4]:
                if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", nxt):
                    stores, loads = max(stores, int(m[1])), max(loads, int(m[2]))
                if m := re.search(r"Used (\d+) registers", nxt):
                    regs = max(regs, int(m[1]))
    if not found:
        raise AssertionError(f"ptxas output names no kernel {kernel}")
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
    (K = 1), and of the pivots' identity (D = 2, K = 2). Times, bound and
    library call at each kernel's first shape; the fused kernel's device
    time at every shape."""
    import torch
    from score_tpu_torch.ops import blocks

    chk = _KernelCheck(tol=REL_TOL_F32, precision="f32")
    rng = np.random.default_rng(7)
    shapes = [(6, 1024, (138, 6, 1)), (6, 1280, ()), (2, 2070, (2,))]
    for n, M, Ks in shapes:
        A = _random_blocks(M, n, seed=M + n, device=device)
        L = chk("block_chol", lambda: blocks.block_chol(A), lambda: blocks.block_chol_plain(A),
                _blocks_cost("block_chol", A), library=lambda: torch.linalg.cholesky_ex(A))
        r = _resid(L @ L.transpose(-1, -2), A)
        _log(f"block_chol D={n} M={M}: ||L L^T - A||/||A|| = {r:.3e}")
        if not r <= 1e-5:
            raise AssertionError(f"block_chol D={n} M={M}: residual {r:.3e}")
        for K in Ks:
            B = torch.tensor(rng.standard_normal((M, n, K)), dtype=torch.float32, device=device)
            Y = chk("block_tri_lower_solve", lambda: blocks.block_tri_lower_solve(L, B),
                    lambda: blocks.block_tri_lower_solve_plain(L, B),
                    _blocks_cost("block_tri_lower_solve", L, B),
                    library=lambda: torch.linalg.solve_triangular(L, B, upper=False))
            r = _resid(L @ Y, B)
            _log(f"block_tri_lower_solve D={n} M={M} K={K}: ||L Y - B||/||B|| = {r:.3e}")
            if not r <= 1e-5:
                raise AssertionError(f"block_tri_lower_solve D={n} M={M} K={K}: residual {r:.3e}")
            X = chk("block_chol_solve", lambda: blocks.block_chol_solve(L, B),
                    lambda: blocks.block_chol_solve_plain(L, B),
                    _blocks_cost("block_chol_solve", L, B),
                    library=lambda: torch.cholesky_solve(B, L))
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
    for n in (2, 6):
        for M in (1, 3, 4, 128, 1024, 2070):
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
    _log(f"block_chol at D = 2, 6, M = 1..2070, three layouts: max_rel_diff={worst:.3e} "
         f"(bound {REL_TOL_F32}), residuals <= 1e-5")
    # its device time at every Cholesky of a Manhattan-4 f32 factor (C = 4
    # chains of 512: the odd blocks of each level, then the root), on
    # contiguous blocks and on the odd-row view the factor passes
    C, T = 4, 512
    while T >= 1:
        M = C * max(T // 2, 1)
        Dfull = _random_blocks(C * T, 6, seed=T, device=device).reshape(C, T, 6, 6)
        view = (Dfull[:, 1::2] if T > 1 else Dfull[:, 0]).reshape(M, 6, 6)
        contig = view.contiguous()
        us = _device_us(lambda: blocks.block_chol(contig))
        us_view = _device_us(lambda: blocks.block_chol(view))
        _log(f"block_chol D=6 M={M} ({'level' if T > 1 else 'root'}): device_us={us:.2f} "
             f"contiguous, {us_view:.2f} on the view (block stride {view.stride(0)})")
        T //= 2
    _log_rows("f32", chk.rows)
    return chk.rows


def phase_f32_band(device, C=4, Tp=512, K=138):
    """Cyclic reduction in f32 over the block kernels (the f32 fast mode's
    band) against the f64 band kernels, same well-conditioned input at
    Manhattan-4's band shape: relative difference of the solutions <= 1e-4
    for a direction (K = 1) and the arrow panel."""
    import torch
    from score_tpu_torch.ops import band
    from score_tpu_torch.solver.pcr import pcr_factor, pcr_solve

    D, U = _random_band(C, Tp, 6, seed=Tp + C + 1, device=device)
    f32 = pcr_factor(D.float(), U.float())
    f64 = band.band_factor(D, U)
    rng = np.random.default_rng(11)
    for k in (1, K):
        b = torch.tensor(rng.standard_normal((C, Tp, 6, k)), device=device)
        x32 = pcr_solve(f32, b.float()).double()
        x64 = band.band_solve(f64, b)
        rel = ((x32 - x64).abs().max() / x64.abs().max()).item()
        _log(f"f32 band C={C} Tp={Tp} K={k}: max relative difference to the f64 band {rel:.3e}")
        if not rel <= 1e-4:
            raise AssertionError(f"f32 band K={k}: relative difference {rel:.3e} > 1e-4")


def _path_kernels(Tp):
    """Names of the band kernels a solve with chains padded to Tp runs:
    the compacting-CR kernels only when its band compacts."""
    from score_tpu_torch.ops import band

    cr = (band.band_cr_level, band.band_cr_reduce, band.band_cr_backsub)
    return [k.__name__ for k in band.KERNELS if band.cr_depth(Tp) or k not in cr]


def _check_result(label, res, num_poses, relgap_tol=1e-6, det_tol=1e-9):
    """Solved status, relative gap, finite rounded poses with det(R) = +1."""
    relgap = res.gap / max(1.0, abs(res.primal_objective))
    if not res.solved:
        raise AssertionError(f"{label}: not solved (iterations {res.iterations})")
    if not relgap <= relgap_tol:
        raise AssertionError(f"{label}: relgap {relgap:.3e} > {relgap_tol}")
    T = np.stack(list(res.poses.values()))
    if T.shape != (num_poses, 3, 3) or not np.isfinite(T).all():
        raise AssertionError(f"{label}: bad pose array {T.shape}")
    dets = np.linalg.det(T[:, :2, :2])
    if not np.all(np.abs(dets - 1.0) < det_tol):
        raise AssertionError(f"{label}: det(R) off +1 by {np.abs(dets - 1).max():.3e}")
    return relgap


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


def _counts():
    """Launches of every kernel since the last reset, and the block kernels'
    launches per block size."""
    from score_tpu_torch.ops import band, blocks

    launches = {k.__name__: k.launches for k in band.KERNELS + blocks.KERNELS}
    by_size = {f"{k.__name__}[D={n}]": c for k in blocks.KERNELS
               for n, c in k.launches_by_size.items()}
    return launches, by_size


def phase_solve(label, fg, Tp, relaxation="SOCP", precision="f64", reference=None):
    """Cold and warm solves on the card with launch counting. f64 runs the
    band kernels of its path; f32 ``block_chol`` and the fused
    ``block_chol_solve`` (at D = 2 too for QCQP) and neither the
    forward-only kernel nor a plain back substitution on the card's f32
    tensors, held to the f32 mode's reduced tolerance and, with
    ``reference`` (the f64 result of the same relaxation), to its
    objective within 1e-2."""
    import torch
    from score_tpu_torch import ScoreSolverParams, solve_score

    params = ScoreSolverParams(device="cuda", precision=precision)
    f32 = precision == "f32"
    _reset_counts()
    t0 = time.perf_counter()
    with _PlainBackSubstitutions() as plain_back:
        res = solve_score(fg, relaxation, params)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches, by_size = _counts()
    if f32:
        expected = ["block_chol", "block_chol_solve"]
        if relaxation == "QCQP":
            expected += [f"{k}[D=2]" for k in expected]
        if launches["block_tri_lower_solve"] or plain_back.calls:
            raise AssertionError(
                f"{label}: {launches['block_tri_lower_solve']} forward-only launches and "
                f"{plain_back.calls} plain back substitutions on the f32 path")
    else:
        expected = _path_kernels(Tp)
    got = {**launches, **by_size}
    missing = [k for k in expected if got[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched by the solve: {missing}")
    tols = dict(relgap_tol=1e-2, det_tol=1e-5) if f32 else {}
    relgap = _check_result(label, res, fg.num_poses, **tols)
    t0 = time.perf_counter()
    warm_res = solve_score(fg, relaxation, params)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    _check_result(label + "[warm]", warm_res, fg.num_poses, **tols)
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
    _log(f"{line} launches={launches} block_launches_by_size={by_size}")
    return launches, res


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

    from score_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.compile_all(force=True)
    _log(f"build: {time.perf_counter() - t0:.2f} s for {len(built)} libraries, in parallel")
    for name, (path, seconds, log) in built.items():
        _log(f"build {name}: {seconds:.2f} s -> {path.name}")
        for line in log.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                _log("  ptxas:", line.strip())

    # registers and spills of the redesigned kernels
    for lib, wrapper, kern in (("band", "band_pcr_level", "pcr_level_kernel"),
                               ("band", "band_cr_level", "cr_level_kernel"),
                               ("band", "band_pcr_solve", "pcr_solve_wide_kernel"),
                               ("band", "band_pcr_solve", "pcr_solve_narrow_kernel"),
                               ("band", "band_cr_backsub", "cr_backsub_narrow_kernel"),
                               ("band", "band_cr_backsub", "cr_backsub_wide_kernel"),
                               ("blocks", "block_chol", "chol_kernel")):
        regs, stores, loads = _ptxas_report(built[lib][2], kern)
        _log(f"ptxas {wrapper} ({kern}): registers={regs} spill_store_bytes={stores} "
             f"spill_load_bytes={loads}")
        if stores or loads:
            raise AssertionError(f"{kern}: ptxas reports spills")

    dev = torch.device("cuda")
    cells = [(label, fg, _band_shape(fg)) for label, fg in _cells()]
    rows = {}
    for label, fg, shape in cells:
        rows[label] = phase_kernels(label, *shape, dev)
    phase_edge_shapes(dev)
    block_rows = phase_blocks(dev)
    if "--kernels" in sys.argv[1:]:  # stop after the kernels' checks
        return 0
    phase_f32_band(dev)
    phase_small_reference()

    launches, results = {}, {}
    for label, fg, shape in cells:
        launches[label], results[label] = phase_solve(label, fg, shape[1])
    m4_fg, m4_Tp = cells[0][1], cells[0][2][1]
    _, results["manhattan4-qcqp"] = phase_solve("manhattan4-qcqp", m4_fg, m4_Tp, "QCQP")
    launches["manhattan4-f32"], _ = phase_solve(
        "manhattan4-f32", m4_fg, m4_Tp, "SOCP", "f32", reference=results["manhattan4"])
    phase_solve("manhattan4-qcqp-f32", m4_fg, m4_Tp, "QCQP", "f32",
                reference=results["manhattan4-qcqp"])
    phase_small_f32_reference()

    # band kernels: launches from the f64 Manhattan-4 SOCP solve, times at
    # its band shape; block kernels: launches from the f32 Manhattan-4 SOCP
    # solve (none of the forward-only block_tri_lower_solve, whose callers
    # all run the fused block_chol_solve), times at its first level's shapes
    timed = {**rows["manhattan4"], **block_rows}
    kernels = [
        dict(name=name, route="cuda",
             source=BLOCKS_SOURCE if name.startswith("block_") else BAND_SOURCE,
             replaces=REPLACES[name],
             launches=launches["manhattan4-f32" if name.startswith("block_") else
                               "manhattan4"][name],
             max_abs_err=timed[name]["max_abs_err"], ms=timed[name]["ms"],
             device_us=timed[name]["device_us"],
             plain_ms=timed[name]["plain_ms"], bound_ms=timed[name]["bound_ms"],
             bound_by=timed[name]["bound_by"], library_ms=timed[name]["library_ms"],
             **{k: v for k, v in timed[name].items() if k.startswith("k1_")})
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
