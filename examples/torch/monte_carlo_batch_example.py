#!/usr/bin/env python
"""Batched Monte-Carlo solving with the PyTorch port: N measurement-noise
resamples of one Manhattan world stacked and solved as one lockstep
interior-point batch on one device, the chain+arrow backend's band
kernels launched once for all trials.

Usage: python examples/torch/monte_carlo_batch_example.py [num_trials]
           [--device cuda|cpu] [--no-plot]

(The script draws no plot; ``--no-plot`` is accepted as by the other
examples.)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import torch

from score_tpu_torch.assembly.conic import SOCP_RELAXATION, build_conic_problem
from score_tpu_torch.parallel import solve_conic_batch, stack_problems
from score_tpu_torch.sim.manhattan import (
    ManhattanWorldParams,
    resample_measurements,
    simulate_manhattan_world,
)
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
from score_tpu_torch.solver.ipm import SOLVED_STATUSES, IPMParams


def _timed(fn, device):
    t0 = time.time()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.time() - t0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_trials", nargs="?", type=int, default=16)
    parser.add_argument("--device", default="cuda", help="device of the batch (default cuda)")
    parser.add_argument("--no-plot", action="store_true", help="draw no plot (none is drawn)")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but no CUDA card is available")
    sim = ManhattanWorldParams(
        num_robots=4,
        num_poses_per_robot=50,
        num_landmarks=4,
        grid_size=10,
        range_measure_prob=0.4,
        seed=0,
    )
    base = simulate_manhattan_world(sim)
    print("base world:", base.summary())

    t0 = time.time()
    trials = [resample_measurements(base, seed=s) for s in range(args.num_trials)]
    problems = [build_conic_problem(t, SOCP_RELAXATION, device=device)[0] for t in trials]
    batch = stack_problems(problems)
    print(f"assembled {args.num_trials} trials in {time.time() - t0:.2f}s "
          f"(n={problems[0].n}, cones={problems[0].num_cones})")

    _, idx = build_conic_problem(trials[0], SOCP_RELAXATION, device=device)
    ca = build_chain_arrow(problems[0], idx)
    print("backend:", ChainArrowBackend.__name__)
    params = IPMParams(max_iter=20)

    def solve():
        return solve_conic_batch(batch, params, backend=ChainArrowBackend, backend_aux=ca)

    res, t_cold = _timed(solve, device)
    res, t_warm = _timed(solve, device)
    statuses = res.status.cpu().numpy()
    print(f"cold batch solve {t_cold:.2f}s (on the card: the kernels' build and load), "
          f"warm batch solve {t_warm:.2f}s ({t_warm / args.num_trials * 1e3:.1f} ms/trial)")
    solved = int(sum(int(s) in SOLVED_STATUSES for s in statuses))
    print(f"converged: {solved}/{args.num_trials}")
    print("objectives:", [round(float(v), 3) for v in res.pobj.cpu()])
    return res


if __name__ == "__main__":
    main()
