"""Plotting / animation of ground truth vs. solved trajectories.

A copy of :mod:`score_tpu.utils.plot` over the port's factor-graph types: an
animated walk along the pose chains drawing ground-truth poses (blue),
solved poses (red), optional initial values (green), red range-measurement
lines, and per-landmark range-circle intersection regions. Headless-friendly
(Agg): every entry point can save frames/figures to disk instead of (or in
addition to) interactive display.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from score_tpu_torch.fg.factor_graph import FactorGraphData
from score_tpu_torch.fg.solver_utils import SolverResults, VariableValues
from score_tpu_torch.utils.circles import Circle, CircleIntersection, Point
from score_tpu_torch.utils.matrix import (
    get_theta_from_rotation_matrix,
    get_translation_from_transformation_matrix,
)

logger = logging.getLogger(__name__)

COLORS = ["red", "green", "blue", "orange", "purple", "black", "cyan"]

__all__ = [
    "plot_error",
    "visualize_solution",
    "plot_trajectories",
    "draw_arrow",
    "draw_line",
    "draw_pose_variable",
    "draw_pose_solution",
    "draw_landmark_variable",
    "draw_landmark_solution",
    "draw_loop_closure_measurement",
    "draw_arc_patch",
    "check_solution_quality",
]


def _axes_bounds(data: FactorGraphData):
    x_min, x_max, y_min, y_max = data.bounds
    return x_min - 1, x_max + 1, y_min - 1, y_max + 1


def draw_arrow(ax, x: float, y: float, theta: float, color="black"):
    """An oriented arrow scaled to ~1/20 of the plot span."""
    span_x = ax.get_xlim()[1] - ax.get_xlim()[0]
    span_y = ax.get_ylim()[1] - ax.get_ylim()[0]
    length = max(span_x, span_y) / 20.0
    width = max(span_x, span_y) / 100.0
    return ax.arrow(
        x,
        y,
        length * math.cos(theta),
        length * math.sin(theta),
        head_width=length,
        head_length=length,
        width=width,
        color=color,
    )


def draw_line(ax, x0, y0, x1, y1, color="black"):
    import matplotlib.lines as mlines

    line = mlines.Line2D([x0, x1], [y0, y1], color=color)
    ax.add_line(line)
    return line


def draw_pose_variable(ax, pose):
    return draw_arrow(ax, pose.true_x, pose.true_y, pose.true_theta, color="blue")


def draw_pose_solution(ax, T: np.ndarray, color="red", alpha=1.0):
    from matplotlib.colors import to_rgba

    T = np.asarray(T)
    t = get_translation_from_transformation_matrix(T)
    theta = get_theta_from_rotation_matrix(T[:2, :2])
    return draw_arrow(ax, t[0], t[1], theta, color=to_rgba(color, alpha))


def draw_landmark_variable(ax, landmark):
    ax.scatter(landmark.true_x, landmark.true_y, color="green", marker=(5, 2))


def draw_landmark_solution(ax, translation: np.ndarray):
    ax.scatter(translation[0], translation[1], color="red", marker=(4, 2))


def draw_loop_closure_measurement(ax, base_loc: np.ndarray, to_pose):
    line = draw_line(
        ax, base_loc[0], base_loc[1], to_pose.true_x, to_pose.true_y, color="green"
    )
    arrow = draw_pose_variable(ax, to_pose)
    return line, arrow


def draw_arc_patch(arc, ax, resolution: int = 50, color="black"):
    import matplotlib.patches as mpatches

    pts = arc.sample(resolution)
    poly = mpatches.Polygon(pts, closed=True, color=color)
    ax.add_patch(poly)
    return poly


def plot_error(
    data: FactorGraphData,
    solved_results: SolverResults,
    initial_values: Optional[VariableValues] = None,
    color_dist_circles: bool = False,
    show: bool = True,
    save_path: Optional[str] = None,
    save_animation_path: Optional[str] = None,
    num_frames_skip: int = 2,
    pause: float = 0.001,
) -> None:
    """Animated walk along the pose chains comparing ground truth (blue
    arrows) against the solution (red) and optional initial values (green),
    with red range-measurement lines and optional per-landmark range-circle
    intersection regions (parity: plot_utils.py:21-195).

    With ``show=False`` the animation is skipped and only the final frame is
    drawn (and saved to ``save_path`` when given) — the headless mode.

    ``save_animation_path`` (a ``.gif`` path) renders every frame headlessly
    and writes the animation via Pillow (the upstream SCORE plotting loop,
    plot_utils.py:83-187, could only display live).
    """
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if save_animation_path and not save_animation_path.endswith(".gif"):
        raise ValueError(
            "save_animation_path must end in .gif (Pillow writer); got "
            f"{save_animation_path!r}"
        )
    capturing = save_animation_path is not None

    fig, ax = plt.subplots(figsize=(10, 10))
    x0, x1, y0, y1 = _axes_bounds(data)
    ax.set_xlim(x0, x1)
    ax.set_ylim(y0, y1)

    chains = [c for c in data.pose_variables if c]
    max_len = max(len(c) for c in chains)
    pose_to_ranges = data.pose_to_range_measures_dict
    assoc_to_ranges = data.association_to_range_measures_dict
    translations = solved_results.translations
    landmarks_sol = solved_results.landmarks
    true_poses = data.pose_variables_dict
    loop_dict = {
        m.base_pose: true_poses[m.to_pose]
        for m in data.loop_closure_measurements
    }
    range_circles = [CircleIntersection() for _ in data.landmark_variables]

    for lm in data.landmark_variables:
        draw_landmark_variable(ax, lm)
        draw_landmark_solution(ax, landmarks_sol[lm.name])

    frame_indices = (
        range(0, max_len, num_frames_skip)
        if (show or capturing)
        else [max_len - 1]
    )
    frames: List[np.ndarray] = []
    for pose_idx in frame_indices:
        frame_lines = []
        for chain in chains:
            pose = chain[min(pose_idx, len(chain) - 1)]
            draw_pose_solution(ax, solved_results.poses[pose.name])
            if initial_values is not None:
                draw_pose_solution(
                    ax, initial_values.poses[pose.name], color="green", alpha=0.5
                )
            # range measurement lines from this pose
            for rm in pose_to_ranges.get(pose.name, []):
                a, b = rm.association
                xa, ya = translations[a][:2]
                xb, yb = (
                    landmarks_sol[b][:2] if b in landmarks_sol else translations[b][:2]
                )
                frame_lines.append(draw_line(ax, xa, ya, xb, yb, color="red"))
            # range-circle intersection regions per landmark
            if color_dist_circles:
                for li, lm in enumerate(data.landmark_variables):
                    key = (pose.name, lm.name)
                    if key in assoc_to_ranges:
                        center = translations[pose.name]
                        for rm in assoc_to_ranges[key]:
                            range_circles[li].add_circle(
                                Circle(Point(center[0], center[1]), rm.dist)
                            )
                        range_circles[li].draw_intersection(
                            ax, color=COLORS[li % len(COLORS)]
                        )
            draw_pose_variable(ax, pose)
            if pose.name in loop_dict:
                draw_loop_closure_measurement(
                    ax, translations[pose.name][:2], loop_dict[pose.name]
                )
        if show:
            plt.pause(pause)
        if capturing:
            fig.canvas.draw()
            frames.append(np.asarray(fig.canvas.buffer_rgba()).copy())
        if (show or capturing) and pose_idx != frame_indices[-1]:
            for patch in list(ax.patches):
                patch.remove()
            for line in frame_lines:
                line.remove()

    if capturing and frames:
        from PIL import Image

        imgs = [Image.fromarray(f[..., :3]) for f in frames]
        imgs[0].save(
            save_animation_path,
            save_all=True,
            append_images=imgs[1:],
            duration=max(int(pause * 1000), 50),
            loop=0,
        )
        logger.info(
            "saved %d-frame animation to %s", len(frames), save_animation_path
        )
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        logger.info("saved plot to %s", save_path)
    if show:
        plt.close(fig)


def plot_trajectories(
    data: FactorGraphData,
    solved_results: SolverResults,
    save_path: Optional[str] = None,
    show: bool = False,
    title: Optional[str] = None,
):
    """Static figure: ground-truth trajectories (dashed) vs solved
    trajectories (solid) per robot, landmarks as markers."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    chains = solved_results.pose_chain_names or [
        [p.name for c in data.pose_variables for p in c]
    ]
    for ci, chain in enumerate(chains):
        color = COLORS[ci % len(COLORS)]
        gt = np.array(
            [data.pose_variables_dict[n].true_position[:2] for n in chain]
        )
        sol = np.array(
            [
                get_translation_from_transformation_matrix(
                    np.asarray(solved_results.poses[n])
                )
                for n in chain
            ]
        )
        ax.plot(gt[:, 0], gt[:, 1], "--", color=color, alpha=0.5,
                label=f"{chain[0][0]} ground truth")
        ax.plot(sol[:, 0], sol[:, 1], "-", color=color,
                label=f"{chain[0][0]} solution")
    for lm in data.landmark_variables:
        ax.scatter(*lm.true_position[:2], color="green", marker=(5, 2), s=80)
        if lm.name in solved_results.landmarks:
            ax.scatter(
                *np.asarray(solved_results.landmarks[lm.name])[:2],
                color="red",
                marker=(4, 2),
                s=80,
            )
    ax.legend(loc="best", fontsize=8)
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    if show:
        plt.show(block=True)
    plt.close(fig)
    return fig


def visualize_solution(
    solved_results: SolverResults,
    data: Optional[FactorGraphData] = None,
    save_path: Optional[str] = None,
    show: bool = False,
):
    """Quick look at a solution (parity with the py_factor_graph
    ``visualize_solution`` used by the reference example,
    examples/solve_goats_example_score.py:45)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    chains = solved_results.pose_chain_names or [
        sorted(solved_results.poses.keys())
    ]
    for ci, chain in enumerate(chains):
        sol = np.array(
            [
                get_translation_from_transformation_matrix(
                    np.asarray(solved_results.poses[n])
                )
                for n in chain
            ]
        )
        ax.plot(sol[:, 0], sol[:, 1], "-", color=COLORS[ci % len(COLORS)],
                label=f"chain {chain[0][0]}")
    for name, pos in solved_results.landmarks.items():
        ax.scatter(pos[0], pos[1], color="red", marker=(4, 2), s=80)
        ax.annotate(name, (pos[0], pos[1]))
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    if data is not None:
        for lm in data.landmark_variables:
            ax.scatter(*lm.true_position[:2], color="green", marker=(5, 2), s=80)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    if show:
        plt.show(block=True)
    plt.close(fig)
    return fig


def check_solution_quality(
    results,
    save_path: Optional[str] = None,
    show: bool = False,
):
    """Plot the determinants of the (un/rounded) rotation blocks — the
    diagnostic the reference sketched in solve_score.py:35-51 (its version
    was dead code calling a nonexistent Drake-style API). Determinants far
    from 1 before rounding indicate a loose relaxation. Returns the dict of
    determinants."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    dets = {
        name: float(np.linalg.det(np.asarray(T)[:-1, :-1]))
        for name, T in results.poses.items()
    }
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot(list(range(len(dets))), list(dets.values()))
    ax.set_ylim([-0.1, 1.1])
    ax.set_title("Determinants of rotation matrices")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    if show:
        plt.show(block=True)
    plt.close(fig)
    return dets
