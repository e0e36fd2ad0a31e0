#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``score_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero
without printing a result line:

1. require a CUDA device; print the card's name and power limit;
2. build the band kernels from ``score_tpu_torch/ops/csrc/band.cu`` with
   nvcc and print the build time;
3. every band kernel against its plain PyTorch version on the card, at
   the band shapes of both instances below (Manhattan-4: C = 4 chains
   padded to Tp = 512, one compacting level; robot20: C = 20, Tp = 128,
   PCR only; Db = 6; rhs K = 1 and K = the instance's arrow width), at
   every level of a factor and two solves, each call fed the previous
   level's kernel outputs: the max relative difference
   (max |kernel - plain| / max |plain|) must be <= 1e-12 and the band
   residual <= 1e-10; median times of both at each kernel's first call
   (CUDA events, after warm-up); then a small instance solved on the card
   against the port's plain CPU path;
4. Manhattan-4 (4 robots x 400 poses, 6 landmarks, inter-robot ranges,
   seed 0) solved as SOCP on the card: solved status, relative gap <=
   1e-6, det(R) = +1 for every rounded pose, and every band kernel of its
   path (all seven) launched during the solve;
5. the same for the 20-robot world (20 x 100 poses, 10 landmarks, seed 20),
   whose arrow panel runs K in the hundreds and whose band runs the four
   PCR kernels only;
6. one JSON line describing the kernels, then the result line.

Imports nothing of jax or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

REL_TOL = 1e-12  # kernel vs plain PyTorch, both f64 on the card
SOURCE = "score_tpu_torch/ops/csrc/band.cu"
REPLACES = {
    "band_init_a": "score_tpu/ops/pallas_pcr.py:428",
    "band_pcr_level": "score_tpu/ops/pallas_pcr.py:312",
    "band_block_inv": "score_tpu/ops/pallas_pcr.py:423",
    "band_pcr_solve": "score_tpu/ops/pallas_pcr.py:433",
    "band_cr_level": "score_tpu/ops/pallas_pcr.py:362",
    "band_cr_reduce": "score_tpu/ops/pallas_pcr.py:385",
    "band_cr_backsub": "score_tpu/ops/pallas_pcr.py:405",
}


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


def _compare(name, kernel_out, plain_out):
    """(max abs err, max relative err) over paired outputs; raises above
    REL_TOL."""
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
    if not rel_err <= REL_TOL:
        raise AssertionError(f"{name}: max relative difference {rel_err:.3e} > {REL_TOL}")
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

    problem, idx = build_conic_problem(normalize_factor_graph(fg)[0], "SOCP")
    st = build_chain_arrow(problem, idx)
    return st.C, pad_length(st.T), st.A


class _KernelCheck:
    """Running max error of each kernel against its plain twin, and the
    kernel and plain times of the first call of each kernel."""

    def __init__(self):
        self.rows = {}

    def __call__(self, name, kern, plain):
        out = kern()
        abs_err, rel_err = _compare(name, out, plain())
        row = self.rows.get(name)
        if row is None:
            ms, plain_ms = _time_ms(kern), _time_ms(plain)
            row = self.rows[name] = dict(max_abs_err=0.0, max_rel=0.0, calls=0,
                                         ms=ms, plain_ms=plain_ms)
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
    A = chk("band_init_a", lambda: band.band_init_a(U), lambda: band.band_init_a_plain(U))
    Dl, Al, Cl = D, A, U
    levels = []
    for _ in range(n_cr):
        args = (Dl, Al, Cl)
        out = chk("band_cr_level", lambda: band.band_cr_level(*args),
                  lambda: band.band_cr_level_plain(*args))
        levels.append(out[:5])
        Dl, Al, Cl = out[5:]
    Es, Fs = [], []
    for lev in range(band.num_levels(Tp >> n_cr)):
        args = (Dl, Al, Cl, 1 << lev)
        E, F, Dl, Al, Cl = chk("band_pcr_level", lambda: band.band_pcr_level(*args),
                               lambda: band.band_pcr_level_plain(*args))
        Es.append(E)
        Fs.append(F)
    invD = chk("band_block_inv", lambda: band.band_block_inv(Dl),
               lambda: band.band_block_inv_plain(Dl))
    E, F = torch.stack(Es), torch.stack(Fs)
    rng = np.random.default_rng(Tp)
    resid = {}
    for k in (K, 1):  # the panel first: its times are the ones reported
        b0 = torch.tensor(rng.standard_normal((C, Tp, Db, k)), device=device)
        b, fine = b0, []
        for lE, lF, *_ in levels:
            fine.append(b)
            bb = b
            b = chk("band_cr_reduce", lambda: band.band_cr_reduce(lE, lF, bb),
                    lambda: band.band_cr_reduce_plain(lE, lF, bb))
        bb = b
        x = chk("band_pcr_solve", lambda: band.band_pcr_solve(E, F, invD, bb),
                lambda: band.band_pcr_solve_plain(E, F, invD, bb))
        for (_, _, iv, Ao, Co), bf in zip(reversed(levels), reversed(fine)):
            xe = x
            x = chk("band_cr_backsub", lambda: band.band_cr_backsub(iv, Ao, Co, bf, xe),
                    lambda: band.band_cr_backsub_plain(iv, Ao, Co, bf, xe))
        resid[k] = _band_residual(D, U, x, b0)
        if not resid[k] <= 1e-10:
            raise AssertionError(f"{label}: band residual {resid[k]:.3e} at K={k}")
    _log(f"{label} band: C={C} Tp={Tp} Db={Db} CR levels={n_cr} panel K={K} "
         f"residual K={K} {resid[K]:.3e} K=1 {resid[1]:.3e}")
    for name, r in chk.rows.items():
        _log(f"{label} kernel {name}: calls={r['calls']} max_rel_diff={r['max_rel']:.3e} "
             f"max_abs_err={r['max_abs_err']:.3e} kernel_ms={r['ms']:.4f} "
             f"plain_ms={r['plain_ms']:.4f}")
    missing = [k for k in _path_kernels(Tp) if k not in chk.rows]
    if missing:
        raise AssertionError(f"{label}: kernels not checked: {missing}")
    return chk.rows


def _path_kernels(Tp):
    """Names of the band kernels a solve with chains padded to Tp runs:
    the compacting-CR kernels only when its band compacts."""
    from score_tpu_torch.ops import band

    cr = (band.band_cr_level, band.band_cr_reduce, band.band_cr_backsub)
    return [k.__name__ for k in band.KERNELS if band.cr_depth(Tp) or k not in cr]


def _check_result(label, res, num_poses):
    """Solved status, relative gap, finite rounded poses with det(R) = +1."""
    relgap = res.gap / max(1.0, abs(res.primal_objective))
    if not res.solved:
        raise AssertionError(f"{label}: not solved (iterations {res.iterations})")
    if not relgap <= 1e-6:
        raise AssertionError(f"{label}: relgap {relgap:.3e} > 1e-6")
    T = np.stack(list(res.poses.values()))
    if T.shape != (num_poses, 3, 3) or not np.isfinite(T).all():
        raise AssertionError(f"{label}: bad pose array {T.shape}")
    dets = np.linalg.det(T[:, :2, :2])
    if not np.all(np.abs(dets - 1.0) < 1e-9):
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


def phase_solve(label, fg, Tp):
    """Cold and warm SOCP solves on the card with launch counting."""
    import torch
    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.ops import band

    params = ScoreSolverParams(device="cuda")
    band.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve_score(fg, "SOCP", params)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in band.KERNELS}
    missing = [k for k in _path_kernels(Tp) if launches[k] == 0]
    if missing:
        raise AssertionError(f"{label}: kernels not launched by the solve: {missing}")
    relgap = _check_result(label, res, fg.num_poses)
    t0 = time.perf_counter()
    warm_res = solve_score(fg, "SOCP", params)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    _check_result(label + "[warm]", warm_res, fg.num_poses)
    _log(f"{label}: {fg.summary()}")
    _log(f"{label}: solved={res.solved} iterations={res.iterations} relgap={relgap:.3e} "
         f"cold_s={cold:.3f} warm_s={warm:.3f} launches={launches}")
    return launches


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
    path, log = build.compile_band(force=True)
    _log(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    for line in log.splitlines():
        if "Used" in line or "spill" in line:
            _log("  ptxas:", line.strip())

    cells = [(label, fg, _band_shape(fg)) for label, fg in _cells()]
    rows = {}
    for label, fg, shape in cells:
        rows[label] = phase_kernels(label, *shape, torch.device("cuda"))
    phase_small_reference()

    launches = {label: phase_solve(label, fg, shape[1]) for label, fg, shape in cells}

    # launches from the Manhattan-4 solve; times at its band shape
    m4 = rows["manhattan4"]
    kernels = [
        dict(name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
             launches=launches["manhattan4"][name], max_abs_err=m4[name]["max_abs_err"],
             ms=m4[name]["ms"], plain_ms=m4[name]["plain_ms"])
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
