"""The port's example scripts (``examples/torch/``) on the CPU.

The three that simulate their worlds run in-process at small sizes with
``--device cpu --no-plot`` and end solved (the batch: every trial solved).
The three that read a dataset pickle raise the datasets module's
``DatasetNotFoundError`` while ``SCORE_TPU_DATA_DIR`` does not hold it,
and fetch nothing.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from score_tpu_torch.datasets import DatasetNotFoundError
from score_tpu_torch.solver.ipm import SOLVED_STATUSES

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parent.parent / "examples" / "torch"


def _example(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_six_examples():
    assert sorted(p.name for p in EXAMPLES.glob("*.py")) == sorted(
        p.name for p in (EXAMPLES.parent).glob("*.py"))


@pytest.mark.parametrize("name, size", [("solve_3d_example", "20"),
                                        ("large_scale_20robot_example", "5")])
def test_simulated_example_solves(name, size, tmp_path):
    module = _example(name)
    module.OUT_DIR = str(tmp_path)
    result = module.main([size, "--device", "cpu", "--no-plot"])
    assert result.solved


def test_monte_carlo_example_solves_every_trial():
    result = _example("monte_carlo_batch_example").main(["2", "--device", "cpu", "--no-plot"])
    assert [int(s) in SOLVED_STATUSES for s in result.status] == [True, True]


@pytest.mark.parametrize("name", ["solve_manhattan_example", "solve_goats_example",
                                  "refine_goats_example"])
def test_pickle_example_raises_without_the_dataset(name, tmp_path, monkeypatch):
    monkeypatch.setenv("SCORE_TPU_DATA_DIR", str(tmp_path))
    with pytest.raises(DatasetNotFoundError, match="SCORE_TPU_DATA_DIR"):
        _example(name).main(["--device", "cpu", "--no-plot"])
