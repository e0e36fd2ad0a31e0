"""Checkpoint / resume for solver state.

A copy of :mod:`score_tpu.utils.checkpoint`. The interior-point state is a
few flat tensors, so checkpointing is a save/load of named arrays.
Combined with ``solve_conic(..., warm_start=(x, s, z))`` (tensors on the
problem's device) this gives warm restart across processes.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

__all__ = ["save_solver_state", "load_solver_state"]


def _host(a) -> np.ndarray:
    """A host array of a tensor on any device (or of an array)."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def save_solver_state(path: str, result) -> None:
    """Persist an IPMResult's iterate (x, s, z) and telemetry to .npz."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path,
        x=_host(result.x),
        s=_host(result.s),
        z=_host(result.z),
        iterations=np.asarray(result.iterations),
        status=np.asarray(result.status),
        pobj=np.asarray(result.pobj),
        gap=np.asarray(result.gap),
    )


def load_solver_state(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a checkpoint as a (x, s, z) warm-start triple."""
    data = np.load(path)
    return data["x"], data["s"], data["z"]
