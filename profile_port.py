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

times only the redesigned kernels: of the f64 band ``band_pcr_level``
(first and last level) and ``band_pcr_solve`` (a direction, K = 1, and the
arrow panel) at the PCR remainder's shape of both instances,
``band_cr_level`` at Manhattan-4's first level and at the deeper levels'
and robot20's shapes of the depth sweep, ``band_cr_reduce`` and
``band_cr_backsub`` at Manhattan-4's direction and panel and at a forced
level of robot20 and of a long chain; of the f32 band its Cholesky solve
``solver.pcr._dinv`` (one launch of ``block_chol_solve``; in a checkout
from before that kernel, the forward kernel and the plain back
substitution) at the first level's shapes, and ``block_chol`` at every
Cholesky of a Manhattan-4 factor (on contiguous blocks, and through
``smallblocks.chol_small`` on the odd-row view the factor passes) and at
QCQP's D = 2 pivots. Device time per launch from a
replayed CUDA graph (``chip_smoke._device_us``) and event time around the
call. ``--root DIR`` imports ``score_tpu_torch`` from another checkout, so
that two commits are timed on one card in one call.

    python3 profile_port.py --walls [--root DIR]

five warm Manhattan-4 SOCP solves in f32 and in f64 (host clock), then one
profiled solve in each: kernel launches, device busy time and the
hand-written kernels' device time and launches. With ``--root`` for two
commits in turns in one call.

    python3 profile_port.py --ablate

prices the parts of ``band_pcr_solve`` at the same shapes: it builds
``csrc/band.cu`` again with the level loop's reads of E, F compiled out
(``-DBAND_NO_STAGING``), with the wide kernel's products compiled out
(``-DBAND_NO_PRODUCT``) and with both, and times each build with all levels
and with none (what a launch costs before and after its levels).
"""

from __future__ import annotations

import argparse
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


def _warm_walls(fg, n=3, precision="f64"):
    import torch
    from score_tpu_torch import ScoreSolverParams, solve_score

    params = ScoreSolverParams(device="cuda", precision=precision)
    solve_score(fg, "SOCP", params)  # warm-up
    walls, res = [], None
    for _ in range(n):
        t0 = time.perf_counter()
        res = solve_score(fg, "SOCP", params)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    relgap = res.gap / max(1.0, abs(res.primal_objective))
    return dict(walls_s=walls, iterations=res.iterations, solved=res.solved,
                relgap=relgap)


# device-side names of the port's hand-written kernels (band.cu, blocks.cu);
# tri_lower_kernel and cr_backsub_kernel are kernels of a --root checkout
# from before tri_solve_kernel and the two cr_backsub kernels
_KERNEL_NAMES = ("init_a_kernel", "cr_level_kernel", "cr_reduce_kernel", "cr_backsub_kernel",
                 "cr_backsub_narrow_kernel", "cr_backsub_wide_kernel",
                 "pcr_level_kernel", "block_inv_kernel", "pcr_solve_wide_kernel",
                 "pcr_solve_narrow_kernel", "chol_kernel", "tri_solve_kernel",
                 "tri_lower_kernel")


def _profile_solve(fg, top=12, precision="f64"):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from score_tpu_torch import ScoreSolverParams, solve_score

    params = ScoreSolverParams(device="cuda", precision=precision)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve_score(fg, "SOCP", params)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    n_launch = sum(e.count for e in kernels)
    ops = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_device_time_total)[:top]
    band = {}
    for e in kernels:  # one entry per template instantiation: summed by name
        for name in _KERNEL_NAMES:
            if "::" + name in e.key:
                row = band.setdefault(name, dict(device_ms=0.0, launches=0))
                row["device_ms"] += e.self_device_time_total / 1e3
                row["launches"] += e.count
    return dict(
        device_busy_ms=busy_us / 1e3,
        kernel_launches=n_launch,
        top_ops=[dict(op=e.key, device_ms=e.self_device_time_total / 1e3,
                      calls=e.count) for e in ops],
        hand_kernels=band,
    )


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


def _forced_depth_walls(fg, Tp, rounds=4):
    """Warm solves at depth 0, 1, the default depth and the deepest depth,
    by moving ``band.CR_BASE_LENGTH``; the depths take turns, one solve
    each per round, so a drift of the host clock hits all of them."""
    import torch
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.ops import band

    default = band.CR_BASE_LENGTH
    bases = sorted({Tp, Tp // 2, default, 1}, reverse=True)
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
_DINV_SHAPES = ((1024, 1), (1024, 6), (1024, 138), (1280, 258))
# band_cr_reduce and band_cr_backsub: (chains, coarse length, rhs columns) of
# Manhattan-4's direction and panel, of one forced level on robot20, of a
# long chain and of the narrow kernel's widest rhs
_CR_SOLVE_SHAPES = ((4, 256, 1), (4, 256, 138), (4, 256, 4), (20, 64, 1), (20, 64, 258),
                    (1, 1024, 1), (1, 1024, 5))
# block_chol: the f32 factor of Manhattan-4 (C = 4 chains of 512) takes the
# Cholesky of the odd blocks of chains of 512, 256, ..., 2 (M = 1024 ... 4)
# and of the root (C = 4 blocks); QCQP's distance pivots are 2070 blocks of 2
_CHOL_CHAINS = (4, 512)
_CHOL_PIVOTS = 2070


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


def _cr_solve_times(device):
    """band_cr_reduce and band_cr_backsub at ``_CR_SOLVE_SHAPES``, on the
    blocks of a compacting level of a random band."""
    import torch
    from chip_smoke import _device_us
    from score_tpu_torch.ops import band

    rows = []
    rng = np.random.default_rng(1)
    for C, Th, K in _CR_SOLVE_SHAPES:
        D, U = _random_band(C, 2 * Th, 6, seed=Th + C, device=device)
        E, F, iv, Ao, Co, *_ = band.band_cr_level(D, band.band_init_a(U), U)
        b = torch.tensor(rng.standard_normal((C, 2 * Th, 6, K)), device=device)
        xe = torch.tensor(rng.standard_normal((C, Th, 6, K)), device=device)
        for kernel, fn in (("band_cr_reduce", lambda: band.band_cr_reduce(E, F, b)),
                           ("band_cr_backsub", lambda: band.band_cr_backsub(iv, Ao, Co, b, xe))):
            rows.append(dict(cell="f64 band", kernel=kernel, shape=f"C={C} Th={Th} K={K}",
                             device_us=_device_us(fn), event_ms=_event_ms(fn)))
    return rows


def _kernel_times(device):
    """Device us and event ms of band_pcr_level and band_pcr_solve at the
    shapes of ``_REMAINDERS``, of band_cr_level at ``_CR_LEVEL_SHAPES``,
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
    return rows + _cr_solve_times(device) + _chol_times(device)


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the full report as JSON to this file")
    ap.add_argument("--kernels", action="store_true",
                    help="time only the redesigned kernels")
    ap.add_argument("--walls", action="store_true",
                    help="warm Manhattan-4 walls in f32 and f64, and the f32 launch count")
    ap.add_argument("--ablate", action="store_true",
                    help="time band_pcr_solve with parts of its level loop compiled out")
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
    if args.kernels:
        import score_tpu_torch

        rows = _kernel_times(torch.device("cuda"))
        _log(f"package: {Path(score_tpu_torch.__file__).parent}")
        for r in rows:
            _log(f"  {r['cell']:<11} {r['kernel']:<15} {r['shape']:<36} "
                 f"device {r['device_us']:9.2f} us   events {r['event_ms']:.4f} ms")
        if args.out:
            out = Path(args.out)
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(dict(card=smi, kernels=rows), indent=1))
        return 0

    from chip_smoke import _cells

    if args.walls:
        import score_tpu_torch

        _log(f"package: {Path(score_tpu_torch.__file__).parent}")
        label, fg = _cells()[0]
        report = dict(card=smi)
        for precision in ("f32", "f64"):
            report[precision] = _warm_walls(fg, n=5, precision=precision)
            _log(f"{label}-{precision}: warm {report[precision]}")
        for precision in ("f32", "f64"):
            p = report[f"{precision}_profile"] = _profile_solve(fg, precision=precision)
            _log(f"{label}-{precision}: profiled solve: device busy {p['device_busy_ms']:.3f} "
                 f"ms, {p['kernel_launches']} kernel launches")
            for name, b in p["hand_kernels"].items():
                _log(f"  kernel {name:<24} {b['device_ms']:9.3f} ms {b['launches']:5d} launches")
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
