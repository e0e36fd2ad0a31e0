#!/usr/bin/env python
"""SCORE + refine with the PyTorch port: the full pipeline on the GOATS-14
AUV dataset. Convex relaxation -> rounded initialization -> matrix-free
Levenberg-Marquardt refinement of the true nonlinear MLE objective
(``score_tpu_torch.refine``), then a Huber-robust refinement, each with
its ATE against the TUM ground truth; on the card by default.

Usage: python examples/torch/refine_goats_example.py [SOCP|QCQP] [--device cuda|cpu]
           [--no-plot]

The pickle is read from ``SCORE_TPU_DATA_DIR`` (``goats_14_data/``, the
reference's ``examples/`` layout); where it is missing the script raises
``score_tpu_torch.datasets.DatasetNotFoundError`` and fetches nothing.
(The script draws no plot; ``--no-plot`` is accepted as by the other
examples.)
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from score_tpu_torch import (
    RefineParams,
    ScoreSolverParams,
    parse_pickle_file,
    refine_solution,
    solve_score,
)
from score_tpu_torch.datasets import goats_pickle_path, require
from score_tpu_torch.utils.metrics import ate_against_ground_truth


def _print_ate(tag, results, fg):
    for chain, metrics in ate_against_ground_truth(results, fg).items():
        print(
            f"ATE ({tag}) chain {chain}: rmse={metrics['rmse']:.3f} "
            f"mean={metrics['mean']:.3f} max={metrics['max']:.3f} (m)"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("relaxation", nargs="?", default="SOCP", choices=("SOCP", "QCQP"))
    parser.add_argument("--device", default="cuda", help="device of the solve (default cuda)")
    parser.add_argument("--no-plot", action="store_true", help="draw no plot (none is drawn)")
    args = parser.parse_args(argv)
    fg = parse_pickle_file(require(goats_pickle_path()))

    res = solve_score(fg, args.relaxation, ScoreSolverParams(device=args.device, max_iter=60))
    print(
        f"relaxation solved={res.solved} iters={res.iterations} "
        f"pobj={res.primal_objective:.4f} gap={res.gap:.2e}"
    )
    _print_ate("SCORE init", res, fg)

    out = refine_solution(fg, res.variables, RefineParams(max_iter=60), device=args.device)
    print(f"refined: iters={out.iterations} cost {out.initial_cost:.4e} -> {out.cost:.4e}")
    _print_ate("refined MLE", dataclasses.replace(res, variables=out.values), fg)

    # the GOATS data carries gross range outliers: a Huber loss after the
    # least-squares warm-up (so that inlier residuals mean something first)
    rob = refine_solution(
        fg,
        out.values,
        RefineParams(max_iter=60, robust="huber", robust_delta=30.0),
        device=args.device,
    )
    print(f"robust-refined: iters={rob.iterations} "
          f"cost {rob.initial_cost:.4e} -> {rob.cost:.4e}")
    _print_ate("robust refined", dataclasses.replace(res, variables=rob.values), fg)
    return rob


if __name__ == "__main__":
    main()
