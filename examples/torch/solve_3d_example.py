#!/usr/bin/env python
"""3D (SE(3)) end to end with the PyTorch port: simulate a 3D range-SLAM
world, round-trip it through the g2o format, solve the SOCP relaxation (on
the card by default: the Db = 12 band kernels) and export the trajectory
as TUM to examples/out/torch/.

Usage: python examples/torch/solve_3d_example.py [num_poses] [--device cuda|cpu]
           [--no-plot]

(The script draws no plot; ``--no-plot`` is accepted as by the other
examples.)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

from score_tpu_torch import ScoreSolverParams, save_to_tum, solve_score
from score_tpu_torch.fg import parse_g2o_file, save_to_g2o_file
from score_tpu_torch.sim.world3d import World3DParams, simulate_3d_world
from score_tpu_torch.utils.metrics import ate_against_ground_truth

OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "out", "torch")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("num_poses", nargs="?", type=int, default=300)
    parser.add_argument("--device", default="cuda", help="device of the solve (default cuda)")
    parser.add_argument("--no-plot", action="store_true", help="draw no plot (none is drawn)")
    args = parser.parse_args(argv)
    fg = simulate_3d_world(
        World3DParams(
            num_poses_per_robot=args.num_poses,
            num_landmarks=5,
            world_size=40.0,
            range_measure_prob=0.35,
            seed=7,
        )
    )
    print("simulated:", fg.summary())

    os.makedirs(OUT_DIR, exist_ok=True)
    g2o_path = os.path.join(OUT_DIR, "world3d.g2o")
    save_to_g2o_file(fg, g2o_path)
    fg2 = parse_g2o_file(g2o_path)
    print("g2o round-trip:", fg2.summary())

    t0 = time.time()
    result = solve_score(fg2, "SOCP", ScoreSolverParams(device=args.device, verbose=True))
    print(
        f"solved={result.solved} iters={result.iterations} "
        f"time={time.time() - t0:.2f}s relgap="
        f"{result.gap / max(1.0, abs(result.primal_objective)):.2e}"
    )

    tum_path = os.path.join(OUT_DIR, "world3d_traj.tum")
    save_to_tum(result, tum_path)
    print("TUM trajectory written to", tum_path)

    for chain, m in ate_against_ground_truth(result, fg).items():
        print(f"ATE[{chain}]: rmse={m['rmse']:.3f} m max={m['max']:.3f} m")
    return result


if __name__ == "__main__":
    main()
