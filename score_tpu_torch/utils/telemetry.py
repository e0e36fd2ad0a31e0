"""Observability: structured logging, per-phase timers and a profiler hook.

Port of :mod:`score_tpu.utils.telemetry`:

- :func:`setup_logging` — the `[file:line] name level - message` format,
  with per-level colors on a TTY, without external dependencies;
- :class:`PhaseTimer` — wall-clock per named phase (assembly, solve,
  refinement, ...);
- :func:`profiler_trace` — a context manager around ``torch.profiler``
  that writes a TensorBoard-compatible trace of the host and, where a
  card is present, the device.

The reference's per-iteration solve trace (``SolveTrace``, ``trace_solve``
over ``solve_conic_traced``) is not ported yet: it needs step diagnostics
that the port's interior-point step does not return.
"""

from __future__ import annotations

import contextlib
import logging
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["setup_logging", "PhaseTimer", "profiler_trace"]

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
