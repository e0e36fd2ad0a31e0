"""The collectives of the sharded solves (``score_tpu_torch.parallel``).

Every cross-rank reduction of the port goes through :func:`all_reduce`, an
in-place ``torch.distributed.all_reduce`` that NCCL and gloo both take for
CUDA and CPU tensors alike. It counts its calls and bytes, so that a run
can say what the sharding costs in traffic (reset with
:func:`reset_counts`).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["all_reduce", "process_group", "reset_counts"]


def all_reduce(t: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (None: the default group) with
    ``op`` ("sum" or "max") and return it: every rank ends with the same
    values, bit for bit."""
    import torch.distributed as dist

    reduce_op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    all_reduce.calls += 1
    all_reduce.bytes += t.numel() * t.element_size()
    dist.all_reduce(t, op=reduce_op, group=group)
    return t


def process_group(group=None) -> Tuple[object, int, int]:
    """(group, rank, world size) of a sharded solve's ``torch.distributed``
    group; None names the default group, returned as ``group.WORLD``, so
    the group it returns is never None (``solve_batch``'s ``reduce_over``
    of None means no collective at all). Raises
    ``RuntimeError`` where no process group is initialized: a sharded
    solve never falls back to one process."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "a sharded solve needs an initialized torch.distributed process group "
            "(run_ranks, torchrun, or init_process_group)")
    group = dist.group.WORLD if group is None else group
    return group, dist.get_rank(group), dist.get_world_size(group)


def reset_counts() -> None:
    all_reduce.calls = 0
    all_reduce.bytes = 0


reset_counts()
