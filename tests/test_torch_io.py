"""The port's factor-graph IO (``score_tpu_torch.fg.io``) against the JAX
package's (``score_tpu.fg.io``): pickles written by the JAX package, pickles
in the py_factor_graph schema, g2o files written by either package and TUM
trajectories read the same in both; a parsed pickle solves to the
in-memory graph's digits; parsing leaves jax and ``score_tpu`` unimported.
Graphs: the 2 x 25 Manhattan world (``tests/torch_reference_data.py``)
with a loop closure and a landmark prior added, and the 3D 2 x 30 world
with its loop closure."""

import dataclasses
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from score_tpu.fg import io as ref_io
from score_tpu.fg.measurements import PoseMeasurement2D as RefPoseMeasurement2D
from score_tpu.fg.priors import LandmarkPrior2D as RefLandmarkPrior2D
from score_tpu import datasets as ref_datasets
from tests import torch_reference_data

from score_tpu_torch import ScoreSolverParams, datasets, solve_score
from score_tpu_torch.convert import factor_graph_from_reference
from score_tpu_torch.fg import (
    FactorGraphData,
    parse_g2o_file,
    parse_pickle_file,
    parse_tum_file,
    save_to_g2o_file,
    save_to_pickle_file,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _graph_2d():
    fg = torch_reference_data.graph_2x25()
    fg.loop_closure_measurements.append(
        RefPoseMeasurement2D("A2", "A15", 1.0, -2.0, 0.3, 100.0, 1000.0))
    fg.landmark_priors.append(RefLandmarkPrior2D("L1", (3.0, 4.0), 10.0))
    return fg


GRAPHS = {"2d": _graph_2d, "3d": lambda: torch_reference_data.world_3d(loop=True)}


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def ref_graph(request):
    return GRAPHS[request.param]()


def assert_same(a, b, where="graph"):
    """a (the port's) equals b field by field: the same class names, the
    same values, arrays bit for bit."""
    if dataclasses.is_dataclass(b):
        assert type(a).__name__ == type(b).__name__, where
        assert type(a).__module__.startswith("score_tpu_torch."), where
        for f in dataclasses.fields(b):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert type(a) is type(b) and a == b, where


def _py_factor_graph_pickle(fg) -> bytes:
    """fg pickled as py_factor_graph would name its classes: protocol 0
    spells every class as text, "c<module>\\n<name>\\n"."""
    data = pickle.dumps(fg, protocol=0)
    assert b"cscore_tpu.fg." in data
    return data.replace(b"cscore_tpu.fg.", b"cpy_factor_graph.")


def test_jax_pickle_reads_as_converted(ref_graph, tmp_path):
    path = tmp_path / "graph.pkl"
    ref_io.save_to_pickle_file(ref_graph, str(path))
    port = parse_pickle_file(str(path))
    assert isinstance(port, FactorGraphData)
    assert_same(port, factor_graph_from_reference(ref_graph))


def test_parsing_a_jax_pickle_leaves_jax_out(ref_graph, tmp_path):
    path = tmp_path / "graph.pkl"
    ref_io.save_to_pickle_file(ref_graph, str(path))
    # a score_tpu name the port does not map
    foreign = tmp_path / "foreign.pkl"
    foreign.write_bytes(pickle.dumps(ref_graph, protocol=0).replace(
        b"cscore_tpu.fg.factor_graph\nFactorGraphData\n", b"cscore_tpu.api\nsolve_score\n"))
    code = (
        "import pickle, sys\n"
        "import score_tpu_torch\n"
        "from score_tpu_torch.fg import parse_pickle_file\n"
        f"fg = parse_pickle_file({str(path)!r})\n"
        "assert type(fg).__module__ == 'score_tpu_torch.fg.factor_graph'\n"
        "assert fg.num_poses > 0 and fg.num_range_measurements > 0\n"
        "try:\n"
        f"    parse_pickle_file({str(foreign)!r})\n"
        "    raise SystemExit('a foreign score_tpu class was accepted')\n"
        "except pickle.UnpicklingError:\n"
        "    pass\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'score_tpu' or m.startswith('score_tpu.'))\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_py_factor_graph_pickle_reads_equal_in_both(ref_graph, tmp_path):
    path = tmp_path / "pfg.pkl"
    path.write_bytes(_py_factor_graph_pickle(ref_graph))
    ref = ref_io.parse_pickle_file(str(path))
    assert type(ref).__module__ == "score_tpu.fg.factor_graph"
    assert_same(parse_pickle_file(str(path)), factor_graph_from_reference(ref))
    # an unknown py_factor_graph class raises in both packages
    name = b"PoseVariable%dD" % ref_graph.dimension
    unknown = tmp_path / "unknown.pkl"
    unknown.write_bytes(_py_factor_graph_pickle(ref_graph).replace(
        b"cpy_factor_graph.variables\n" + name + b"\n",
        b"cpy_factor_graph.variables\nPoseVariable9D\n"))
    for parse in (ref_io.parse_pickle_file, parse_pickle_file):
        with pytest.raises(pickle.UnpicklingError, match="PoseVariable9D"):
            parse(str(unknown))


def test_g2o_reads_equal_across_packages(ref_graph, tmp_path):
    """Each package's g2o writer read by both parsers: the same graph (the
    two writers also write the same text)."""
    ref_path, port_path = tmp_path / "ref.g2o", tmp_path / "port.g2o"
    ref_io.save_to_g2o_file(ref_graph, str(ref_path))
    save_to_g2o_file(factor_graph_from_reference(ref_graph), str(port_path))
    assert port_path.read_text() == ref_path.read_text()
    for path in (ref_path, port_path):
        expected = factor_graph_from_reference(ref_io.parse_g2o_file(str(path)))
        port = parse_g2o_file(str(path))
        assert_same(port, expected)
        assert port.num_poses == ref_graph.num_poses
        assert port.num_range_measurements == ref_graph.num_range_measurements


def test_g2o_unknown_tag_raises(tmp_path):
    path = tmp_path / "bad.g2o"
    path.write_text("VERTEX_SE2 0 0 0 0\nVERTEX_SE2 1 1 0 0\nEDGE_FOO 0 1 1.0\n")
    for parse in (ref_io.parse_g2o_file, parse_g2o_file):
        with pytest.raises(ValueError, match="EDGE_FOO"):
            parse(str(path))


def test_tum_matches_reference(tmp_path):
    rng = np.random.default_rng(7)
    rows = np.column_stack([np.arange(6) * 0.1, rng.standard_normal((6, 7))])
    lines = ["# timestamp tx ty tz qx qy qz qw", ""]
    lines += [" ".join(f"{v:.17g}" for v in r) for r in rows[:3]]
    lines += [", ".join(f"{v:.17g}" for v in r) for r in rows[3:]]
    path = tmp_path / "traj.tum"
    path.write_text("\n".join(lines) + "\n")
    port, ref = parse_tum_file(str(path)), ref_io.parse_tum_file(str(path))
    for a, b in zip(port, ref):
        assert a.dtype == np.float64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port[1], rows[:, 1:4])
    path.write_text("0.0 1 2 3\n")
    for parse in (ref_io.parse_tum_file, parse_tum_file):
        with pytest.raises(ValueError, match="Malformed"):
            parse(str(path))


def test_pickled_graph_solves_to_in_memory_digits(tmp_path):
    fg = factor_graph_from_reference(torch_reference_data.graph_2x25())
    path = tmp_path / "port.pkl"
    save_to_pickle_file(fg, str(path))
    parsed = parse_pickle_file(str(path))
    params = ScoreSolverParams(device="cpu")
    a, b = solve_score(fg, "SOCP", params), solve_score(parsed, "SOCP", params)
    assert a.solved and b.solved
    assert (a.iterations, a.primal_objective, a.gap, a.primal_residual, a.dual_residual) == (
        b.iterations, b.primal_objective, b.gap, b.primal_residual, b.dual_residual)
    for name, T in a.poses.items():
        np.testing.assert_array_equal(b.poses[name], T)


def test_datasets_follow_the_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("SCORE_TPU_DATA_DIR", str(tmp_path))
    for name in ("data_dir", "goats_pickle_path", "goats_gt_tum_path", "manhattan_pickle_path"):
        assert getattr(datasets, name)() == getattr(ref_datasets, name)(), name
