"""Batched and sharded solves. Port of :mod:`score_tpu.parallel`:

- :func:`stack_problems` / :func:`solve_conic_batch`: Monte-Carlo trials of
  one structure stacked on a leading trial axis and solved in lockstep on
  one device;
- :func:`solve_conic_sharded`: that batch with its trials split over the
  ranks of a ``torch.distributed`` process group (data-parallel; the
  batch's gates stay global);
- :func:`solve_conic_chain_sharded` (``parallel/intra.py``): ONE problem
  with its robot chains split over the ranks, the arrow replicated;
- :func:`run_ranks` (``parallel/launch.py``): one process a rank, on the
  CPU (gloo) or one card a rank (NCCL; gloo where ranks share a card).

The JAX package's ``default_mesh`` has no counterpart: a process group
takes the place of a device mesh (the default group, or ``group=``).
"""

from score_tpu_torch.parallel.batch import solve_conic_batch, solve_conic_sharded, stack_problems
from score_tpu_torch.parallel.intra import shard_chain_structure, solve_conic_chain_sharded
from score_tpu_torch.parallel.launch import run_ranks

__all__ = [
    "stack_problems",
    "solve_conic_batch",
    "solve_conic_sharded",
    "solve_conic_chain_sharded",
    "shard_chain_structure",
    "run_ranks",
]
