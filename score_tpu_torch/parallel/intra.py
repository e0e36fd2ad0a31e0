"""Intra-problem sharding: ONE multi-robot problem split over the ranks of a
``torch.distributed`` group.

Port of :mod:`score_tpu.parallel.intra`. The chain+arrow KKT structure is
parallel over robots: the per-robot chains (the block-tridiagonal band,
its factor, and the band solves of the rhs and of the arrow panel) are
independent, coupled only through the dense arrow block. The JAX package
lays the chain axis over a device mesh and GSPMD inserts the two ``psum``s
of the arrow Schur complement and of the arrow rhs. Here every rank of the
group (one process a rank: :func:`score_tpu_torch.parallel.launch.
run_ranks` or ``torchrun``) calls :func:`solve_conic_chain_sharded` with
the same problem and holds the problem, the IPM state, the operators and
the arrow; it factors and solves only its own chains, with the band
kernels (f64) or the block kernels (f32) at C / world chains, and the
backend completes three sums over the group per KKT solve, each an
``all_reduce``: the Schur complement's B'Z (once a factor), the arrow
rhs's B'w and the chain solution, gathered as the sum of zero-filled
shards (the JAX package's sharded outputs stay sharded; the port's
replicated state needs the third).

Every host decision of the solve (the Cholesky's escalated retry on the
reduced Schur complement, the stall detector, the status, the centering
gate) reads values that every rank holds bit for bit alike, so the ranks
take the same branches and make the same collectives.
"""

from __future__ import annotations

import dataclasses
import math

from score_tpu_torch.assembly.conic import ConicProblem, VariableIndex
from score_tpu_torch.solver.chain_arrow import (
    ChainArrowBackend,
    ChainArrowStructure,
    ChainShard,
    build_chain_arrow,
)
from score_tpu_torch.solver.collective import process_group
from score_tpu_torch.solver.ipm import IPMParams, IPMResult, solve_conic

__all__ = ["shard_chain_structure", "solve_conic_chain_sharded"]


def shard_chain_structure(aux: ChainArrowStructure, group=None) -> ChainArrowStructure:
    """The structure with this rank's share of the chain axis over
    ``group`` (None: the default group); its chain count must split over
    the world size (``build_chain_arrow(..., num_chains_pad=)``)."""
    group, rank, world = process_group(group)
    shard = ChainShard(group, rank, world)
    shard.chains(aux.C)  # raises where the chains do not split
    return dataclasses.replace(aux, shard=shard)


def solve_conic_chain_sharded(
    problem: ConicProblem,
    idx: VariableIndex,
    params: IPMParams = IPMParams(),
    backend=ChainArrowBackend,
    group=None,
) -> IPMResult:
    """Solve one conic problem with the chain+arrow backend, its chains
    split over the ranks of ``group`` (None: the default group): the chain
    axis is padded up to a multiple of the world size with inactive
    identity chains and rank r factors and solves chains [r C / w,
    (r + 1) C / w). Every rank calls it with the same problem and gets the
    whole result. Raises ``RuntimeError`` where no process group is
    initialized."""
    _, _, world = process_group(group)
    C = len(idx.chain_lengths)
    pad = int(math.ceil(max(C, 1) / world)) * world
    aux = shard_chain_structure(build_chain_arrow(problem, idx, num_chains_pad=pad), group)
    return solve_conic(problem, params, backend=backend, backend_aux=aux)
