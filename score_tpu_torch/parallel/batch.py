"""The Monte-Carlo batch: same-structure problems on a leading trial axis.

Port of :mod:`score_tpu.parallel.batch` (``stack_problems``,
``solve_conic_batch``, ``solve_conic_sharded``). The JAX package vmaps its
IPM over the trials inside one compiled ``lax.while_loop``; here the
batched IPM of
:mod:`score_tpu_torch.solver.ipm` (:func:`~score_tpu_torch.solver.ipm.
solve_batch`) runs every trial's arithmetic as one tensor op with a
leading trial axis, and the backends take that axis: the chain+arrow
backend folds the trials into its band's chain axis, so that one launch
of each hand-written band kernel serves the whole batch, and keeps one
``ChainArrowStructure`` for every trial.

Like the JAX package's batch, the IPM is branchless lane by lane, with two
gates shared by the batch (``score_tpu/parallel/batch.py:136-147``): the
direction-refinement solves run only while some live lane is near
convergence, the centering-recovery solve only while some live lane is
near convergence or stalled. So a lane may take another path than that
trial's single solve (a frozen step where the single solve centres); the
JAX package holds the two to 1e-6 in the objective.

A stacked problem's ``num_cones`` and ``num_cost_rows`` read the trial
count, as in the JAX package; the batched paths read the per-trial cone
count from ``cone_h.shape[-2]``.

:func:`solve_conic_sharded` splits the trials over the ranks of a
``torch.distributed`` group (one process a rank, as
:func:`score_tpu_torch.parallel.launch.run_ranks` or ``torchrun`` starts
them), where the JAX package lays the trial axis over a device mesh
(``default_mesh``; a process group takes its place here). As under the
JAX package's GSPMD, where ``jnp.any`` over the sharded trial axis is a
global reduction (``score_tpu/parallel/batch.py:142-152``), the batch's
gates and its loop condition are the whole batch's: one ``all_reduce`` a
trip.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from score_tpu_torch.assembly.conic import ConicProblem
from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.collective import all_reduce, process_group
from score_tpu_torch.solver.ipm import IPMParams, IPMResult, solve_batch

__all__ = ["stack_problems", "solve_conic_batch", "solve_conic_sharded"]

_DATA_FIELDS = (
    "cost_cols",
    "cost_coefs",
    "cost_b",
    "cost_w",
    "cone_cols",
    "cone_coefs",
    "cone_h",
    "pin_idx",
    "pin_val",
    "c0",
)


def stack_problems(problems: Sequence[ConicProblem]) -> ConicProblem:
    """Stack same-structure problems along a new leading trial axis (on
    the first problem's device). Raises ``ValueError`` when their (n, k,
    dim, relaxation) or the shape of a data field differ."""
    first = problems[0]
    for pb in problems[1:]:
        if (pb.n, pb.k, pb.dim, pb.relaxation) != (
            first.n,
            first.k,
            first.dim,
            first.relaxation,
        ):
            raise ValueError("All problems in a batch must share static structure")
        for f in _DATA_FIELDS:
            if getattr(pb, f).shape != getattr(first, f).shape:
                raise ValueError(f"Array shape mismatch in field {f}")
    stacked = {
        f: torch.stack([getattr(pb, f).to(first.device) for pb in problems])
        for f in _DATA_FIELDS
    }
    return dataclasses.replace(first, **stacked)


def _solve_batch_trips(
    batched_problem: ConicProblem,
    params: IPMParams = IPMParams(),
    backend=None,
    backend_aux=None,
    reduce_over=None,
) -> Tuple[IPMResult, int]:
    """:func:`solve_conic_batch`, and the number of loop trips the batch
    took (the trips of its slowest lane), which the card checks and the
    profiler read; with ``reduce_over`` (a resolved process group), this
    rank's share of a trial-sharded batch (:func:`solve_batch`)."""
    backend = backend or DenseBackend
    if batched_problem.cone_h.dim() != 3:
        raise ValueError("solve_conic_batch takes a stacked problem (stack_problems): "
                         f"cone_h of shape {tuple(batched_problem.cone_h.shape)}")
    ops = backend.prepare(batched_problem, backend_aux)
    return solve_batch(batched_problem, params, backend, ops, reduce_over)


def solve_conic_batch(
    batched_problem: ConicProblem,
    params: IPMParams = IPMParams(),
    backend=None,
    backend_aux=None,
) -> IPMResult:
    """Solve a batch (a leading trial axis on every data field) in
    lockstep on its device: the loop stops once no trial runs, or after
    ``params.max_iter`` trips; finished trials are frozen. ``backend``
    defaults to :class:`~score_tpu_torch.solver.backend.DenseBackend`, as
    in the JAX package; ``ChainArrowBackend`` takes the one
    ``ChainArrowStructure`` of the batch as ``backend_aux``. Every field
    of the result has a leading trial axis (``iterations`` and ``status``
    int64)."""
    return _solve_batch_trips(batched_problem, params, backend, backend_aux)[0]


def _solve_sharded_trips(
    batched_problem: ConicProblem,
    params: IPMParams = IPMParams(),
    backend=None,
    backend_aux=None,
    group=None,
) -> Tuple[IPMResult, int]:
    """:func:`solve_conic_sharded`, and the batch's loop trips (the same on
    every rank)."""
    group, rank, world = process_group(group)
    batch = batched_problem.c0.shape[0]
    if batch % world:
        raise ValueError(
            f"Batch size {batch} not divisible by the world size {world}; pad the "
            "batch (duplicate trials) to a multiple of the rank count")
    per = batch // world
    rows = slice(rank * per, (rank + 1) * per)
    mine = dataclasses.replace(
        batched_problem, **{f: getattr(batched_problem, f)[rows] for f in _DATA_FIELDS})
    res, trips = _solve_batch_trips(mine, params, backend, backend_aux, reduce_over=group)

    def gather(t):  # every rank's rows, as the sum of zero-filled shards
        full = t.new_zeros((batch,) + tuple(t.shape[1:]))
        full[rows] = t
        return all_reduce(full, group)

    return IPMResult(*(gather(t) for t in res)), trips


def solve_conic_sharded(
    batched_problem: ConicProblem,
    params: IPMParams = IPMParams(),
    backend=None,
    backend_aux=None,
    group=None,
) -> IPMResult:
    """Data-parallel batched solve over the ranks of a ``torch.distributed``
    ``group`` (None: the default group). Every rank calls it with the same
    stacked problem; rank r solves trials [r B / w, (r + 1) B / w) on its
    own device with :func:`solve_conic_batch`'s batched IPM, the batch's
    gates and loop condition reduced over the group, and every rank gets
    the whole result. ``backend`` defaults to ``DenseBackend``, as in the
    JAX package. A batch size the world size does not divide raises
    ``ValueError`` before any collective."""
    return _solve_sharded_trips(batched_problem, params, backend, backend_aux, group)[0]
