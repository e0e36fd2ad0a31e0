#!/usr/bin/env python
"""20-robot Manhattan-world SOCP with the PyTorch port: the reference's
largest demonstrated configuration (shown there only as an animation; no
data file shipped), regenerated by the simulator and solved on the card
by default.

Usage: python examples/torch/large_scale_20robot_example.py [poses_per_robot] [--gif]
           [--device cuda|cpu] [--no-plot]

``--gif`` also renders the animated error plot to
examples/out/torch/manhattan20.gif (headless, minutes at 2000 poses);
``--no-plot`` draws nothing (matplotlib is imported only to plot).
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from score_tpu_torch import ScoreSolverParams, solve_score
from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world
from score_tpu_torch.utils.metrics import ate_against_ground_truth

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "out", "torch")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("poses_per_robot", nargs="?", type=int, default=100)
    parser.add_argument("--gif", action="store_true", help="also render the error animation")
    parser.add_argument("--device", default="cuda", help="device of the solve (default cuda)")
    parser.add_argument("--no-plot", action="store_true", help="draw no plot")
    args = parser.parse_args(argv)
    sim = ManhattanWorldParams(
        num_robots=20,
        num_poses_per_robot=args.poses_per_robot,
        num_landmarks=10,
        grid_size=30,
        range_measure_prob=0.25,
        inter_robot_measure_prob=0.05,
        seed=20,
    )
    t0 = time.time()
    fg = simulate_manhattan_world(sim)
    print(f"simulated in {time.time() - t0:.1f}s:", fg.summary())

    result = solve_score(fg, "SOCP", ScoreSolverParams(device=args.device, verbose=True))
    print(
        f"solved={result.solved} iters={result.iterations} "
        f"time={result.total_time:.2f}s objective={result.primal_objective:.4f}"
    )
    rmses = [m["rmse"] for m in ate_against_ground_truth(result, fg).values()]
    print(f"ATE rmse over {len(rmses)} robots: "
          f"mean={sum(rmses) / len(rmses):.3f} max={max(rmses):.3f} (m)")
    if not args.no_plot:
        from score_tpu_torch.utils.plot import plot_error, plot_trajectories

        os.makedirs(OUT_DIR, exist_ok=True)
        plot_trajectories(
            fg, result,
            save_path=os.path.join(OUT_DIR, "manhattan20.png"),
            title="20-robot Manhattan SOCP initialization",
        )
        if args.gif:
            gif = os.path.join(OUT_DIR, "manhattan20.gif")
            plot_error(fg, result, show=False, save_animation_path=gif, num_frames_skip=10)
            print(f"wrote {gif}")
    return result


if __name__ == "__main__":
    main()
