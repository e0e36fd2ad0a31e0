"""Command-line interface: ``python -m score_tpu_torch <graph> [options]``.

Port of ``python -m score_tpu``: load -> solve -> refine -> export over the
port's own API, with every flag of the JAX package's CLI and one more,
``--device`` (default ``cuda``; ``cpu`` runs the same path on the host):

    python -m score_tpu_torch factor_graph.pickle --relaxation SOCP \\
        --tum out.tum --plot traj.png --refine --ate

Accepts py_factor_graph pickles and g2o files (2D/3D, EDGE_RANGE).
Prints one JSON summary line on stdout, with the same keys as the JAX
package's CLI; everything else goes to stderr. The exit code is 0 when
the relaxation solved and 1 when it did not.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m score_tpu_torch",
        description=(
            "Solve the SOCP/QCQP relaxation of a range-aided SLAM factor "
            "graph with the interior-point solver on a CUDA card (or the "
            "CPU) and export the rounded initialization."
        ),
    )
    p.add_argument(
        "graph",
        help="input factor graph: .pickle/.pkl (py_factor_graph) or .g2o",
    )
    p.add_argument(
        "--relaxation",
        choices=("SOCP", "QCQP"),
        default="QCQP",
        help="convex relaxation (default QCQP, as solve_score's default)",
    )
    p.add_argument(
        "--backend",
        choices=("auto", "dense", "chain_arrow"),
        default="auto",
        help="KKT backend (default auto: chain+arrow when pose chains "
        "exist, dense otherwise)",
    )
    p.add_argument(
        "--precision",
        choices=("auto", "f64", "mixed", "f32"),
        default="auto",
        help="numeric policy (default auto: f64; mixed also runs f64; f32 "
        "is the initializer-grade fast mode)",
    )
    p.add_argument("--max-iter", type=int, default=60,
                   help="interior-point iteration budget (default 60)")
    p.add_argument(
        "--init",
        choices=("default", "random", "zero", "odom", "gt"),
        default="default",
        help="warm-start technique",
    )
    p.add_argument(
        "--refine",
        action="store_true",
        help="run the downstream nonlinear refinement (Levenberg-Marquardt "
        "on the maximum-likelihood objective) on the rounded initialization",
    )
    p.add_argument(
        "--robust",
        choices=("none", "huber", "gm"),
        default="none",
        help="robust loss on range residuals during refinement",
    )
    p.add_argument("--robust-delta", type=float, default=3.0,
                   help="robust kernel width in whitened-residual units")
    p.add_argument("--tum", metavar="PATH",
                   help="write the solved trajectories in TUM format "
                   "(one file per robot chain)")
    p.add_argument("--save", metavar="PATH",
                   help="pickle the full SolverResults to PATH")
    p.add_argument("--g2o-out", metavar="PATH",
                   help="re-export the (input) factor graph as g2o")
    p.add_argument("--plot", metavar="PATH",
                   help="save a trajectory comparison plot (PNG/PDF; needs "
                   "matplotlib)")
    p.add_argument("--ate", action="store_true",
                   help="report per-chain ATE against the graph's stored "
                   "ground truth")
    p.add_argument("--verbose", action="store_true",
                   help="INFO-level solver logging")
    p.add_argument("--device", default="cuda",
                   help="device the solve and the refinement run on (default "
                   "cuda; cpu, cuda:1, ...)")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    import logging

    from score_tpu_torch.api import ScoreSolverParams, solve_score
    from score_tpu_torch.fg.io import parse_g2o_file, parse_pickle_file
    from score_tpu_torch.utils.telemetry import setup_logging

    setup_logging(logging.INFO if args.verbose else logging.WARNING)

    if args.graph.endswith(".g2o"):
        fg = parse_g2o_file(args.graph)
    else:
        fg = parse_pickle_file(args.graph)
    print(
        f"loaded {args.graph}: {fg.num_poses} poses, "
        f"{fg.num_landmarks} landmarks, "
        f"{len(fg.range_measurements)} ranges, dim {fg.dimension}",
        file=sys.stderr,
    )

    refine_params = None
    if args.refine and args.robust != "none":
        from score_tpu_torch.refine import RefineParams

        refine_params = RefineParams(
            robust=args.robust, robust_delta=args.robust_delta
        )
    params = ScoreSolverParams(
        device=args.device,
        max_iter=args.max_iter,
        backend=args.backend,
        precision=args.precision,
        init_technique=args.init,
        refine=args.refine,
        refine_params=refine_params,
        verbose=args.verbose,
    )
    results = solve_score(fg, args.relaxation, params)

    summary = {
        "solved": bool(results.solved),
        "relaxation": args.relaxation,
        "iterations": int(results.iterations),
        "primal_objective": float(results.primal_objective),
        "relgap": float(
            results.gap / max(1.0, abs(results.primal_objective))
        ),
        "total_time_s": round(float(results.total_time), 4),
    }

    if args.ate:
        from score_tpu_torch.utils.metrics import ate_against_ground_truth

        summary["ate"] = ate_against_ground_truth(results, fg)

    if args.tum:
        from score_tpu_torch.fg.solver_utils import save_to_tum

        summary["tum_files"] = save_to_tum(results, args.tum)
    if args.save:
        from score_tpu_torch.fg.solver_utils import save_results_to_file

        save_results_to_file(results, args.save)
        summary["results_file"] = args.save
    if args.g2o_out:
        from score_tpu_torch.fg.io import save_to_g2o_file

        save_to_g2o_file(fg, args.g2o_out)
        summary["g2o_file"] = args.g2o_out
    if args.plot:
        from score_tpu_torch.utils.plot import plot_trajectories

        plot_trajectories(fg, results, save_path=args.plot, show=False)
        summary["plot_file"] = args.plot

    print(json.dumps(summary))
    return 0 if results.solved else 1


if __name__ == "__main__":
    sys.exit(main())
