"""Batched solves: Monte-Carlo trials of one structure stacked on a
leading trial axis (:func:`stack_problems`) and solved in lockstep on one
device (:func:`solve_conic_batch`). Port of :mod:`score_tpu.parallel`
without its sharded entry points (``solve_conic_sharded``,
``parallel/intra.py``), which wait for more than one card."""

from score_tpu_torch.parallel.batch import solve_conic_batch, stack_problems

__all__ = ["stack_problems", "solve_conic_batch"]
