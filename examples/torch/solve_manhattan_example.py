#!/usr/bin/env python
"""Solve the 4-robot Manhattan-world dataset shipped with the reference
(1600 poses, 6 landmarks, 1160 ranges incl. inter-robot) with the PyTorch
port, on the card by default.

Usage: python examples/torch/solve_manhattan_example.py [SOCP|QCQP] [--gif]
           [--device cuda|cpu] [--no-plot]

The pickle is read from ``SCORE_TPU_DATA_DIR`` (``manhattan/
factor_graph.pickle``, the reference's ``examples/`` layout); where it is
missing the script raises ``score_tpu_torch.datasets.DatasetNotFoundError``
and fetches nothing. ``--gif`` also renders the animated error plot to
examples/out/torch/manhattan4_<relaxation>.gif (headless, minutes at 1600
poses); ``--no-plot`` draws nothing (matplotlib is imported only to plot).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from score_tpu_torch import ScoreSolverParams, parse_pickle_file, solve_score
from score_tpu_torch.datasets import manhattan_pickle_path, require
from score_tpu_torch.utils.metrics import ate_against_ground_truth

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "out", "torch")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("relaxation", nargs="?", default="SOCP", choices=("SOCP", "QCQP"))
    parser.add_argument("--gif", action="store_true", help="also render the error animation")
    parser.add_argument("--device", default="cuda", help="device of the solve (default cuda)")
    parser.add_argument("--no-plot", action="store_true", help="draw no plot")
    args = parser.parse_args(argv)
    fg = parse_pickle_file(require(manhattan_pickle_path()))
    print(fg.summary())
    result = solve_score(fg, args.relaxation, ScoreSolverParams(device=args.device, verbose=True))
    print(
        f"solved={result.solved} iters={result.iterations} "
        f"time={result.total_time:.2f}s objective={result.primal_objective:.6f}"
    )
    for chain, m in ate_against_ground_truth(result, fg).items():
        print(f"robot {chain}: ATE rmse={m['rmse']:.3f} m")
    if not args.no_plot:
        from score_tpu_torch.utils.plot import plot_error, plot_trajectories

        os.makedirs(OUT_DIR, exist_ok=True)
        plot_trajectories(
            fg,
            result,
            save_path=os.path.join(OUT_DIR, f"manhattan4_{args.relaxation}.png"),
            title=f"Manhattan 4-robot {args.relaxation} initialization",
        )
        if args.gif:
            gif = os.path.join(OUT_DIR, f"manhattan4_{args.relaxation}.gif")
            plot_error(fg, result, show=False, save_animation_path=gif, num_frames_skip=10)
            print(f"wrote {gif}")
    return result


if __name__ == "__main__":
    main()
