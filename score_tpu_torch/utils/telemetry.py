"""Observability: structured logging, per-phase timers and a profiler hook.

Port of :mod:`score_tpu.utils.telemetry`:

- :func:`setup_logging` — the `[file:line] name level - message` format,
  with per-level colors on a TTY, without external dependencies;
- :class:`PhaseTimer` — wall-clock per named phase (assembly, solve,
  refinement, ...);
- :class:`SolveTrace` and :func:`trace_solve` — per-iteration
  interior-point telemetry over
  :func:`score_tpu_torch.solver.ipm.solve_conic_traced`, whose rows stay
  on the device until one host copy at the end;
- :func:`profiler_trace` — a context manager around ``torch.profiler``
  that writes a TensorBoard-compatible trace of the host and, where a
  card is present, the device.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

__all__ = ["setup_logging", "PhaseTimer", "SolveTrace", "trace_solve", "profiler_trace"]

_FORMAT = "[%(filename)s:%(lineno)d] %(name)s %(levelname)s - %(message)s"

# coloredlogs-style per-level ANSI colors
_LEVEL_COLORS = {
    logging.DEBUG: "\x1b[32m",  # green
    logging.INFO: "\x1b[0m",  # default
    logging.WARNING: "\x1b[33m",  # yellow
    logging.ERROR: "\x1b[31m",  # red
    logging.CRITICAL: "\x1b[1;31m",  # bold red
}
_RESET = "\x1b[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _LEVEL_COLORS.get(record.levelno, "")
        return f"{color}{msg}{_RESET}" if color else msg


def setup_logging(level: int = logging.INFO, color: Optional[bool] = None) -> None:
    """Configure the log format with per-level ANSI coloring on the root
    logger (its earlier handlers are replaced). ``color=None`` colors when
    stderr is a TTY."""
    if color is None:
        color = sys.stderr.isatty()
    handler = logging.StreamHandler()
    handler.setFormatter(
        _ColorFormatter(_FORMAT) if color else logging.Formatter(_FORMAT)
    )
    root = logging.getLogger()
    for h in list(root.handlers):
        root.removeHandler(h)
    root.addHandler(handler)
    root.setLevel(level)


@dataclass
class PhaseTimer:
    """Accumulates wall-clock per named phase."""

    phases: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def summary(self) -> str:
        total = sum(self.phases.values())
        parts = [f"{k}={v:.3f}s" for k, v in self.phases.items()]
        return f"total={total:.3f}s ({', '.join(parts)})"


@dataclass
class SolveTrace:
    """Per-iteration interior-point telemetry (host arrays, one entry a
    trip)."""

    pres: np.ndarray
    dres: np.ndarray
    gap: np.ndarray
    pobj: np.ndarray
    iterations: int
    status: int

    def log(self, logger: Optional[logging.Logger] = None) -> None:
        logger = logger or logging.getLogger("score_tpu_torch.solver")
        for i in range(self.iterations + 1):
            logger.info(
                "iter %3d: pres=%.3e dres=%.3e gap=%.3e pobj=%.8e",
                i, self.pres[i], self.dres[i], self.gap[i], self.pobj[i],
            )

    def as_dict(self) -> Dict[str, List[float]]:
        k = self.iterations + 1
        return {
            "pres": self.pres[:k].tolist(),
            "dres": self.dres[:k].tolist(),
            "gap": self.gap[:k].tolist(),
            "pobj": self.pobj[:k].tolist(),
        }


def trace_solve(problem, params=None, backend=None, backend_aux=None,
                num_iters: int = 50) -> "tuple":
    """Solve with per-iteration telemetry (on the problem's device). Returns
    (IPMResult, SolveTrace); ``backend`` defaults to the dense one."""
    from score_tpu_torch.solver.backend import DenseBackend
    from score_tpu_torch.solver.ipm import IPMParams, solve_conic_traced

    params = params or IPMParams()
    backend = backend or DenseBackend
    result, metrics = solve_conic_traced(
        problem, params, num_iters=num_iters, backend=backend,
        backend_aux=backend_aux,
    )
    m = metrics.cpu().numpy()  # the one host copy
    trace = SolveTrace(
        pres=m[:, 0],
        dres=m[:, 1],
        gap=m[:, 2],
        pobj=m[:, 3],
        iterations=int(result.iterations),
        status=int(result.status),
    )
    return result, trace


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block (host activity, and
    the card's where one is present) into ``log_dir`` as a TensorBoard
    trace file; by default a new directory under the temporary directory.
    Yields the directory."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    log_dir = log_dir or tempfile.mkdtemp(prefix="score_tpu_torch_trace_")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
