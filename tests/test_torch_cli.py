"""The port's command line (``python -m score_tpu_torch``) against the JAX
package's (``python -m score_tpu``), and the import hygiene of the port.

``main`` runs in-process on the CPU (``--device cpu``) on the small graphs
of ``tests/test_cli.py``, written by the JAX package's own writers (a pickle
and a g2o file). The JAX package's exit codes and summary lines for the same
command lines are read from ``tests/data/torch_reference.npz``
(``tests/torch_reference_data.py``, ``CLI_CASES``).

Tolerances. The summary has the reference's keys, exit code, solved flag
and relaxation; the iterations within 1 and the primal objective within
1e-9 relative (the two packages' chain bands round differently, see
``tests/test_torch_api.py``); the relative gap under the solver's 1e-6
where solved. After ``--refine`` the ATE of each chain within 1e-6
relative: the refinements start from solutions that differ at the solver's
roundoff.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests import torch_reference_data

from score_tpu_torch.__main__ import _build_parser, main

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def reference():
    return torch_reference_data.load()


def _run(argv, capsys):
    rc = main(argv)
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(torch_reference_data.CLI_CASES))
def test_cli_matches_reference(case, reference, tmp_path, capsys):
    graph = torch_reference_data.write_cli_graph(case, str(tmp_path))
    argv = torch_reference_data.cli_argv(case, graph, str(tmp_path)) + ["--device", "cpu"]
    rc, summary = _run(argv, capsys)
    ref = json.loads(str(reference[f"cli_{case}_summary"]))
    assert rc == int(reference[f"cli_{case}_rc"])
    assert summary.keys() == ref.keys()
    assert (summary["solved"], summary["relaxation"]) == (ref["solved"], ref["relaxation"])
    assert abs(summary["iterations"] - ref["iterations"]) <= 1
    pobj = ref["primal_objective"]
    assert abs(summary["primal_objective"] - pobj) <= 1e-9 * abs(pobj)
    if summary["solved"]:
        assert summary["relgap"] <= 1e-6
    for chain, ate in ref.get("ate", {}).items():
        for k, v in ate.items():
            assert abs(summary["ate"][chain][k] - v) <= 1e-6 * abs(v), (chain, k)
    # every export the flags name exists, at the path the summary gives
    for key in ("tum_files", "results_file", "g2o_file"):
        if key in ref:
            got = summary[key]
            assert got == json.loads(json.dumps(ref[key]).replace("{out}", str(tmp_path)))
            assert all(os.path.exists(p) for p in (got if isinstance(got, list) else [got]))
    if "tum_files" in summary:
        # TUM lines: timestamp x y z qx qy qz qw, one per pose
        lines = open(summary["tum_files"][0]).read().splitlines()
        assert len(lines) == 6 and all(len(line.split()) == 8 for line in lines)
    if "g2o_file" in summary:
        from score_tpu_torch.fg.io import parse_g2o_file

        back = parse_g2o_file(summary["g2o_file"])
        assert (back.num_poses, back.num_landmarks, len(back.range_measurements)) == (6, 2, 13)


def test_cli_refine_is_the_api_refinement(tmp_path, capsys):
    """--refine hands the solve's rounded initialization to the refinement:
    the saved poses are solve_score(refine=True)'s, bit for bit, and differ
    from the unrefined ones. (On the CLI cases' 6-pose graph the refinement
    of both packages stops after 3 rejected steps with the poses unchanged,
    so a 1 x 10 Manhattan world, where it moves them.)"""
    import pickle

    from score_tpu_torch import ScoreSolverParams, solve_score
    from score_tpu_torch.fg.io import save_to_pickle_file
    from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=1, num_poses_per_robot=10, num_landmarks=2, grid_size=4,
        range_measure_prob=0.5, seed=3))
    graph, res_file = str(tmp_path / "g.pickle"), str(tmp_path / "res.pkl")
    save_to_pickle_file(fg, graph)
    rc, summary = _run([graph, "--relaxation", "SOCP", "--max-iter", "40", "--refine",
                        "--save", res_file, "--device", "cpu"], capsys)
    assert rc == 0 and summary["results_file"] == res_file
    with open(res_file, "rb") as f:
        saved = pickle.load(f)
    params = dict(device="cpu", max_iter=40)
    api = solve_score(fg, "SOCP", ScoreSolverParams(refine=True, **params))
    plain = solve_score(fg, "SOCP", ScoreSolverParams(**params))
    for name, T in api.poses.items():
        np.testing.assert_array_equal(saved.poses[name], T)
    # the refinement takes the cost from 7.37 to 4.35 and moves the poses by ~6e-4
    assert max(np.abs(api.poses[n] - T).max() for n, T in plain.poses.items()) > 1e-5


def test_cli_plot(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    graph = torch_reference_data.write_cli_graph("full", str(tmp_path))
    png = str(tmp_path / "traj.png")
    rc, summary = _run([graph, "--relaxation", "SOCP", "--max-iter", "30", "--plot", png,
                        "--device", "cpu"], capsys)
    assert rc == 0 and summary["plot_file"] == png
    assert os.path.getsize(png) > 0


def test_cli_flags_are_the_reference_flags_and_device():
    from score_tpu.__main__ import _build_parser as ref_parser

    def flags(parser):
        return {(a.dest, tuple(a.option_strings), a.default, tuple(a.choices or ()))
                for a in parser._actions if a.dest != "help"}

    ours, ref = flags(_build_parser()), flags(ref_parser())
    assert ours - ref == {("device", ("--device",), "cuda", ())}
    assert ref <= ours


def test_cli_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    graph = torch_reference_data.write_cli_graph("unsolved", str(tmp_path))
    with pytest.raises(RuntimeError, match="cuda"):
        main([graph, "--relaxation", "SOCP", "--max-iter", "1"])


def test_imports_leave_out_jax_and_matplotlib():
    code = ("import sys, score_tpu_torch, score_tpu_torch.refine, score_tpu_torch.__main__, "
            "score_tpu_torch.utils.plot, score_tpu_torch.utils.metrics, "
            "score_tpu_torch.utils.telemetry, score_tpu_torch.utils.checkpoint; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'matplotlib', 'score_tpu')); print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stdout + out.stderr
