#!/usr/bin/env python
"""Solve the GOATS-14 real AUV dataset with the PyTorch port and
visualize and export the result: load the pickle, solve the relaxation
(on the card by default), report the ATE against the shipped TUM ground
truth, write the TUM trajectories and the plots to examples/out/torch/.

Usage: python examples/torch/solve_goats_example.py [SOCP|QCQP] [--device cuda|cpu]
           [--no-plot]

The pickle is read from ``SCORE_TPU_DATA_DIR`` (``goats_14_data/``, the
reference's ``examples/`` layout); where it is missing the script raises
``score_tpu_torch.datasets.DatasetNotFoundError`` and fetches nothing.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from score_tpu_torch import ScoreSolverParams, parse_pickle_file, save_to_tum, solve_score
from score_tpu_torch.datasets import goats_pickle_path, require
from score_tpu_torch.utils.metrics import ate_against_ground_truth

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "out", "torch")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("relaxation", nargs="?", default="QCQP", choices=("SOCP", "QCQP"))
    parser.add_argument("--device", default="cuda", help="device of the solve (default cuda)")
    parser.add_argument("--no-plot", action="store_true", help="draw no plot")
    args = parser.parse_args(argv)
    goats_pyfg = parse_pickle_file(require(goats_pickle_path()))
    print(goats_pyfg.summary())

    os.makedirs(OUT_DIR, exist_ok=True)
    solver_params = ScoreSolverParams(
        device=args.device,
        verbose=True,
        save_results=True,
        results_filepath=os.path.join(OUT_DIR, f"goats_result_{args.relaxation}.pkl"),
    )
    result = solve_score(goats_pyfg, args.relaxation, solver_params)
    print(
        f"solved={result.solved} iters={result.iterations} "
        f"time={result.total_time:.2f}s objective={result.primal_objective:.6f} "
        f"gap={result.gap:.3e}"
    )
    for chain, metrics in ate_against_ground_truth(result, goats_pyfg).items():
        print(
            f"chain {chain}: ATE rmse={metrics['rmse']:.3f} "
            f"mean={metrics['mean']:.3f} max={metrics['max']:.3f} (m)"
        )

    tum_files = save_to_tum(result, os.path.join(OUT_DIR, f"goats_traj_{args.relaxation}.tum"))
    print("TUM trajectories:", tum_files)
    if not args.no_plot:
        from score_tpu_torch.utils.plot import plot_trajectories, visualize_solution

        visualize_solution(
            result,
            goats_pyfg,
            save_path=os.path.join(OUT_DIR, f"goats_solution_{args.relaxation}.png"),
        )
        plot_trajectories(
            goats_pyfg,
            result,
            save_path=os.path.join(OUT_DIR, f"goats_trajs_{args.relaxation}.png"),
            title=f"GOATS-14 {args.relaxation} initialization",
        )
        print(f"plots saved under {OUT_DIR}")
    return result


if __name__ == "__main__":
    main()
