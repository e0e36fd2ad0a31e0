"""Locations of the example datasets.

Port of :mod:`score_tpu.datasets`: the reference ships its two datasets
in its ``examples/`` directory (``goats_14_data/``, ``manhattan/``); both
packages read them from ``SCORE_TPU_DATA_DIR`` (an ``examples/``-layout
directory). The default is a reference checkout's ``examples/`` in the
user's home directory. Nothing is fetched.
"""

from __future__ import annotations

import os

__all__ = [
    "DatasetNotFoundError",
    "require",
    "data_dir",
    "goats_pickle_path",
    "goats_gt_tum_path",
    "manhattan_pickle_path",
]

_DEFAULT_DATA_DIR = os.path.join(os.path.expanduser("~"), "reference", "examples")


def data_dir() -> str:
    """Root directory of the example datasets (``SCORE_TPU_DATA_DIR``)."""
    return os.environ.get("SCORE_TPU_DATA_DIR", _DEFAULT_DATA_DIR)


def goats_pickle_path() -> str:
    """GOATS-14 AUV dataset (679 poses, 4 landmarks, 1,558 ranges)."""
    return os.path.join(
        data_dir(), "goats_14_data", "goats_14_6_2002_15_20.pkl"
    )


def goats_gt_tum_path() -> str:
    """GOATS-14 ground-truth trajectory (TUM format)."""
    return os.path.join(data_dir(), "goats_14_data", "gt_traj_A.tum")


def manhattan_pickle_path() -> str:
    """Simulated 4-robot Manhattan world (1,600 poses, 1,160 ranges)."""
    return os.path.join(data_dir(), "manhattan", "factor_graph.pickle")


class DatasetNotFoundError(FileNotFoundError):
    """An example dataset is missing from the data directory."""


def require(path: str) -> str:
    """``path`` where the dataset file is there; else
    :class:`DatasetNotFoundError` naming ``SCORE_TPU_DATA_DIR``. Nothing is
    fetched."""
    if not os.path.isfile(path):
        raise DatasetNotFoundError(
            f"{path}: dataset not found; point SCORE_TPU_DATA_DIR at a directory "
            "in the reference's examples/ layout that holds it")
    return path
