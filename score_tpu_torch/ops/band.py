"""Block-tridiagonal band factor/solve: compacting cyclic reduction (CR)
levels, then parallel cyclic reduction (PCR) of the remainder.

Port of :mod:`score_tpu.ops.pallas_pcr`. For the system

    A_i x_{i-s} + D_i x_i + C_i x_{i+s} = b_i      (s = 2^level)

a PCR level computes, for every position i of every chain at once,

    E_i = -A_i invD_{i-s}          F_i = -C_i invD_{i+s}
    D'_i = D_i + E_i C_{i-s} + F_i A_{i+s}
    A'_i = E_i A_{i-s}             C'_i = F_i C_{i+s}

(neighbours outside [0, Tp) read as zero). A level takes invD = D^-1 of
its input and returns invD' = D'^-1 of its output, so each block is
inverted once: one block inversion opens the PCR levels and the last
level's invD' is the factor's. A solve replays
b'_i = b_i + E_i b_{i-s} + F_i b_{i+s} through the stored (E, F) and
finishes with x_i = invD_i b_i on the decoupled final system.

A CR level makes the same elimination at s = 1 for the even rows only and
drops the odd ones, halving the chain: the next level's neighbours are
adjacent again. The solve reduces the rhs onto the even rows on the way
down, and on the way up back-substitutes each dropped row from its two
kept neighbours, x_{2j+1} = invD_{2j+1} (b_{2j+1} - A_{2j+1} x_{2j} -
C_{2j+1} x_{2j+2}). The first :func:`cr_depth` levels compact; PCR
finishes the remainder. By default (``CR_BASE_LENGTH`` = 1) every level
compacts: the remainder is one block a chain, with no PCR level, and its
solve is x = invD b.

Public convention (the JAX package's band convention): ``D``, ``U`` are
(C, Tp, Db, Db) with Tp a power of two, identity diagonal blocks and zero
couplings in the padding, ``U[:, i]`` coupling i -> i+1 and
``U[:, Tp-1] = 0``; right-hand sides are (C, Tp, Db, K). Factors keep a
layout natural for the GPU: each CR level's blocks as (C, Th, Db, Db) at
its coarse length Th, the PCR remainder's E, F as (L, C, Tb, Db, Db) and
invD as (C, Tb, Db, Db), all contiguous f64.

Eight kernels, written by hand in CUDA C++ (``csrc/band.cu``, built for
sm_90a by :mod:`score_tpu_torch.ops.build`), do the work on the card, at
the block sizes of :data:`CUDA_BLOCK_SIZES`: Db = 6 (2D poses) and Db = 12
(3D), ``band_cr_factor`` at Db = 6 only. Each has a plain PyTorch twin here (``*_plain``) computing the same
function. A wrapper runs the plain twin only for tensors on the CPU; for
a CUDA tensor it launches its kernel or raises. Each wrapper counts its
launches in its ``launches`` attribute, and per block size Db in
``launches_by_size``.

Mapping of the TPU kernels (``score_tpu/ops/pallas_pcr.py``):

    _init_A_kernel          :428  -> band_init_a
    _factor_level_kernel    :312  -> band_pcr_level
    _factor_level2_kernel   :338  -> band_pcr_level, launched twice
                                     (two levels per launch only saved
                                     TPU launch overhead); invD is
                                     carried from level to level
    _block_inv_kernel       :423  -> band_block_inv (at Db = 6 a factor
                                     compacted to one block a chain emits
                                     the last inverse from band_cr_factor)
    _solve_kernel           :433  -> band_pcr_solve
    _cr_level_kernel        :362  -> band_cr_factor at Db = 6, a run of
                                     levels a launch (one or two a factor),
                                     band_cr_level at Db = 12, a launch a
                                     level, 3 positions a thread block on
                                     levels of 1,024 positions and more
                                     (both also do the TPU caller's
                                     even/odd lane slicing)
    _cr_reduce_kernel       :385  -> band_cr_reduce: a band-solve pass's
                                     every level in ONE launch on chains of
                                     up to 1,024 blocks (the TPU caller
                                     launched one a level), a tile stage
                                     then the whole chain by the block
                                     that takes its last ticket
                                     (cr_reduce_tree_kernel); tile kernels
                                     for runs that stop above one block
    _cr_backsub_kernel      :405  -> band_cr_backsub: every level in ONE
                                     launch, a thread block a segment of a
                                     chain: for K <= 4 a lane group a
                                     position, block rows from L2
                                     (cr_backsub_lanes_kernel), else the
                                     levels' blocks through a ring
                                     (cr_backsub_chain_kernel); also
                                     interleaves the odd rows back, as the
                                     TPU caller does between launches
"""

from __future__ import annotations

import collections
import functools
import itertools
from typing import NamedTuple

import torch

from score_tpu_torch.ops.build import CR_MAX_LEVELS as _CR_MAX_LEVELS
from score_tpu_torch.ops.build import launch as _launch
from score_tpu_torch.solver.smallblocks import inv_small_spd

__all__ = [
    "BandFactors",
    "CRLevel",
    "cr_depth",
    "num_levels",
    "pad_length",
    "band_init_a",
    "band_pcr_level",
    "band_block_inv",
    "band_pcr_solve",
    "band_cr_level",
    "band_cr_factor",
    "band_cr_reduce",
    "band_cr_backsub",
    "band_factor",
    "factor_launches",
    "band_solve",
    "band_matvec",
    "KERNELS",
    "reset_launch_counts",
]

# Block sizes the CUDA kernels are instantiated for: 2D and 3D pose
# blocks, Db = d (d + 1).
CUDA_BLOCK_SIZES = (6, 12)
# Dynamic shared memory a thread block may use on sm_90 (227 KB).
_SMEM_MAX = 232448
# band_pcr_solve at Db = 6: the wide kernel (a thread holds all Db rows by
# _WIDE_COLUMNS rhs columns of a position in registers; at most
# _WIDE_MAX_LENGTH threads, 1 to _WIDE_MAX_GROUPS per position) serves
# chains up to _WIDE_MAX_LENGTH of blocks up to _WIDE_MAX_BLOCK (its 6 x 8
# tile took 198 registers; a 12 x 8 tile would spill); the narrow kernel
# (one thread per position and row, 1, 2 or 4 columns) holds
# _NARROW_ACCUMULATORS outputs per thread in at most _NARROW_THREADS
# threads. At Db = 12 the cluster kernel: _SOLVE_CLUSTER thread blocks per
# chain (at most _CLUSTER_MAX, a power of two; fewer on shorter chains).
# The same constants stand in csrc/band.cu.
_WIDE_COLUMNS = 8
_WIDE_MAX_BLOCK = 6
_WIDE_MAX_LENGTH = 256
_WIDE_MAX_GROUPS = 8
_WIDE_RING = 3  # half-block tiles of E, F in flight or in use
_SM_COUNT = 132  # H100 SXM; the wrapper asks the device
_NARROW_THREADS = 512
_NARROW_ACCUMULATORS = 24
_CLUSTER_MAX = 16
# dynamic shared memory of a cluster kernel's block: the card's 227 KB less
# its ring's 2 mbarriers (static shared memory)
_CLUSTER_SMEM_MAX = _SMEM_MAX - 16
# cluster size of the 3D route: the fastest of P = 4, 8, 16 at both 3D
# bands' remainders on an H100 (profile_port.py --sweep3d, PERF.md)
_SOLVE_CLUSTER = 16


# band_cr_reduce and band_cr_backsub (every compacting level of a solve in
# one launch): the narrow step of band_cr_backsub (a lane group per
# position) takes up to _BACKSUB_NARROW_MAX_K rhs columns; a launch takes up
# to _CR_MAX_LEVELS levels; thread blocks of _CR_THREADS threads (the
# reduce and the backsub's narrow and wide steps); a plan keeps a thread
# block's shared memory under _CR_SMEM_TARGET where it can, so that several
# blocks share an SM. The same constants stand in csrc/band.cu.
_BACKSUB_NARROW_MAX_K = 4
# the rhs width from which band_cr_reduce's kernels hold several rows a
# thread (csrc/band.cu: kReduceRegisterRowsK); the chain kernels' routing
# reads it as the edge between directions and panels
_REGISTER_ROWS_K = 8
_CR_THREADS = 256
_CR_SMEM_TARGET = 64 * 1024
# work items of a tile's finest level for band_cr_backsub's register steps:
# a thread block of 64 for the narrow step (8 positions at Db = 6, as the
# per-level kernel before), four passes of 256 threads for the wide one
_CR_STEP_ITEMS = {"narrow": 64, "wide": 4 * _CR_THREADS}
# CR compacts while the chain is longer than this; PCR factors the rest.
# At 1 a band is cyclic reduction to one block, the JAX package's CPU
# band's order: parallel cyclic reduction applies its explicit inverses to
# every position at every level, and on ill-conditioned bands (IPM
# iterates near the optimum, condition 1e8-1e11) its backward error grows
# past 1e-3 (remainders of 64 and 256 blocks) and up to 1e4-1e5 (16),
# where cyclic reduction to one block stays at the JAX band's and a
# dense Cholesky's 1e-11-1e-5 (tests/torch_reference_data.py
# --band-stability; PERF.md has the table). Tests that need PCR levels set
# it higher or pass ``n_cr``.
CR_BASE_LENGTH = 1
# Steps of iterative refinement that every 3D band solve (Db = 12) takes.
# The band's explicit inverses of ill-conditioned 12 x 12 blocks (the
# rotation rows weigh ~1e4 times the translation rows) leave a 3D solve's
# residual large enough that the dual residual of a 3D QCQP stalls above
# the interior-point method's 1e-8 tolerance, the longer the PCR remainder
# the worse (PERF.md). One step (a band product and a second solve) brings
# it back at any compaction depth.
REFINE_STEPS_3D = 1


class CRLevel(NamedTuple):
    """One compacting level's blocks, all (C, Th, Db, Db) at the coarse
    length Th: E, F reduce the rhs onto the kept (even) rows; invD, A, C
    are the dropped (odd) rows' inverses and input couplings, for the
    back-substitution."""

    E: torch.Tensor
    F: torch.Tensor
    invD: torch.Tensor
    A: torch.Tensor
    C: torch.Tensor


class CRRun(NamedTuple):
    """A run of compacting levels (:func:`band_cr_factor`): its levels
    (:class:`CRLevel`, fine -> coarse); the band it leaves, (C, T >> n, Db,
    Db) each, for the next run, or, after a run that ends at one position a
    chain, None and ``invD``, that block's inverse (C, 1, Db, Db)."""

    levels: tuple
    D: torch.Tensor | None
    A: torch.Tensor | None
    C: torch.Tensor | None
    invD: torch.Tensor | None


class BandFactors(NamedTuple):
    levels: tuple  # of CRLevel, fine -> coarse
    E: torch.Tensor  # (L, C, Tb, Db, Db) PCR elimination blocks of the remainder
    F: torch.Tensor  # (L, C, Tb, Db, Db)
    invD: torch.Tensor  # (C, Tb, Db, Db) inverses of the decoupled system
    D: torch.Tensor  # (C, Tp, Db, Db) the band factored: refinement residuals
    U: torch.Tensor  # (C, Tp, Db, Db)


def pad_length(T: int) -> int:
    p = 1
    while p < T:
        p *= 2
    return p


def num_levels(Tp: int) -> int:
    L = 0
    while (1 << L) < Tp:
        L += 1
    return L


def refine_steps(Db: int) -> int:
    """Iterative-refinement steps of a band solve with Db-blocks: none up
    to 2D blocks, ``REFINE_STEPS_3D`` above."""
    return 0 if Db <= 6 else REFINE_STEPS_3D


def cr_depth(Tp: int) -> int:
    """Compacting levels for chains of length Tp: halve while the chain
    is longer than ``CR_BASE_LENGTH`` (by default all log2(Tp) levels,
    leaving one block a chain)."""
    n = 0
    while (Tp >> n) > CR_BASE_LENGTH:
        n += 1
    return n


# ------------------------------------------------------------------ #
# Plain PyTorch versions
# ------------------------------------------------------------------ #


def _shift_down(x: torch.Tensor, s: int) -> torch.Tensor:
    """x_{i-s} along the chain axis (dim 1), zero for i < s."""
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if s < x.shape[1]:
        out[:, s:] = x[:, : x.shape[1] - s]
    return out


def _shift_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """x_{i+s} along the chain axis (dim 1), zero for i >= Tp - s."""
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    if s < x.shape[1]:
        out[:, : x.shape[1] - s] = x[:, s:]
    return out


def band_init_a_plain(U: torch.Tensor) -> torch.Tensor:
    """A_i = U_{i-1}^T, zero at each chain's start."""
    return _shift_down(U.transpose(-1, -2), 1)


def band_block_inv_plain(D: torch.Tensor) -> torch.Tensor:
    """Inverse of every SPD block (unrolled Cholesky + substitutions)."""
    return inv_small_spd(D)


def band_pcr_level_plain(D, A, C, invD, s: int):
    """One PCR level at shift s on the band (D, A, C) with invD = D^-1:
    returns (E, F, D', A', C', invD') with invD' = D'^-1."""
    E = -(A @ _shift_down(invD, s))
    F = -(C @ _shift_up(invD, s))
    D2 = D + (E @ _shift_down(C, s) + F @ _shift_up(A, s))
    A2 = E @ _shift_down(A, s)
    C2 = F @ _shift_up(C, s)
    return E, F, D2, A2, C2, band_block_inv_plain(D2)


def band_pcr_solve_plain(E, F, invD, b):
    """Replay the stored levels on b (C, Tp, Db, K), then x = invD b."""
    for lev in range(E.shape[0]):
        s = 1 << lev
        b = b + (E[lev] @ _shift_down(b, s) + F[lev] @ _shift_up(b, s))
    return invD @ b


def band_cr_level_plain(D, A, C):
    """One compacting level on (C, T, Db, Db) inputs: returns
    (E, F, invD_odd, A_odd, C_odd, D', A', C'), each (C, T/2, Db, Db).
    Row j of the outputs is fine row 2j (E, F, D', A', C') or 2j+1 (the
    odd rows' inverse and input couplings)."""
    Dod, Aod, Cod = D[:, 1::2], A[:, 1::2], C[:, 1::2]
    invD = band_block_inv_plain(Dod)
    E = -(A[:, 0::2] @ _shift_down(invD, 1))
    F = -(C[:, 0::2] @ invD)
    D2 = D[:, 0::2] + (E @ _shift_down(Cod, 1) + F @ Aod)
    A2 = E @ _shift_down(Aod, 1)
    C2 = F @ Cod
    return tuple(t.contiguous() for t in (E, F, invD, Aod, Cod, D2, A2, C2))


def band_cr_factor_plain(D, A, C, n: int, last: bool = False) -> CRRun:
    """n compacting levels (:func:`band_cr_level_plain` n times) from the
    band (D, A, C), (C, T, Db, Db); with ``last`` (the run ends at one
    position a chain) the inverse of that block (:func:`band_block_inv_plain`)
    in place of the band it leaves."""
    levels = []
    for _ in range(n):
        E, F, invD, Ao, Co, D, A, C = band_cr_level_plain(D, A, C)
        levels.append(CRLevel(E=E, F=F, invD=invD, A=Ao, C=Co))
    if last:
        return CRRun(tuple(levels), None, None, None, band_block_inv_plain(D))
    return CRRun(tuple(levels), D, A, C, None)


def _cr_reduce_level(E, F, b):
    """One compacting level's rhs reduction: the fine rhs b (C, T, Db, K)
    onto the kept rows, b[2j] + (E_j b[2j-1] + F_j b[2j+1]), shape
    (C, T/2, Db, K)."""
    bod = b[:, 1::2]
    return b[:, 0::2] + (E @ _shift_down(bod, 1) + F @ bod)


def _cr_backsub_level(invD, A, C, b, xe):
    """One compacting level's back substitution: the fine solution (C, T,
    Db, K) from the kept rows' solution xe (C, T/2, Db, K), x[2j] = xe[j]
    and x[2j+1] = invD_j ((b[2j+1] - A_j xe[j]) - C_j xe[j+1])."""
    xo = invD @ ((b[:, 1::2] - A @ xe) - C @ _shift_up(xe, 1))
    return torch.stack([xe, xo], dim=2).reshape(b.shape)


def band_cr_reduce_plain(levels, b):
    """The rhs b (C, T, Db, K) reduced through every level of ``levels``
    (:class:`CRLevel`, fine -> coarse): a tuple of each level's reduced rhs,
    the last one the PCR remainder's."""
    out = []
    for lv in levels:
        b = _cr_reduce_level(lv.E, lv.F, b)
        out.append(b)
    return tuple(out)


def band_cr_backsub_plain(levels, fine, x):
    """The finest solution from the coarsest level's x, back-substituting
    through ``levels`` from the coarsest up; ``fine[l]`` is level l's fine
    rhs (the rhs of the solve, then what :func:`band_cr_reduce_plain`
    returned for the levels before l)."""
    for lv, b in zip(reversed(levels), reversed(fine)):
        x = _cr_backsub_level(lv.invD, lv.A, lv.C, b, x)
    return x


# ------------------------------------------------------------------ #
# Kernel wrappers
# ------------------------------------------------------------------ #


def _lib():
    from score_tpu_torch.ops.build import band_library

    return band_library()


def _check(name, t, shape=None):
    if t.dtype != torch.float64:
        raise TypeError(f"{name}: expected float64, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _route(name: str, *ts) -> bool:
    """True to launch the CUDA kernel, False to run the plain version.
    The plain version serves CPU tensors only."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")
    Db = ts[0].shape[-1]
    if Db not in CUDA_BLOCK_SIZES:
        raise ValueError(
            f"{name}: CUDA kernels are built for block sizes "
            f"{CUDA_BLOCK_SIZES}, got {Db}"
        )
    return True


def _check_aligned(name: str, *ts) -> None:
    """The kernels move blocks as 16-byte vectors."""
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: a block array is not 16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _count(wrapper, Db: int, run: tuple = ()) -> None:
    """One launch of ``wrapper``'s kernel at block size Db; a CR wrapper's
    also by its run, (Db, fine length, levels): ``launches_by_run``."""
    wrapper.launches += 1
    wrapper.launches_by_size[Db] += 1
    if run:
        wrapper.launches_by_run[(Db,) + run] += 1


def band_init_a(U: torch.Tensor) -> torch.Tensor:
    """Sub-diagonal blocks A_i = U_{i-1}^T of the band (C, Tp, Db, Db).

    Replaces ``score_tpu/ops/pallas_pcr.py:_init_A_kernel``. Pure data
    movement (one read and one write of the band); at the main path's
    sizes (~0.6 MB) launch latency bounds it, not bandwidth. One thread
    per output element: writes are contiguous, and the transposed read
    stays inside the same Db x Db block of the neighbour."""
    _check("band_init_a", U)
    if U.dim() != 4 or U.shape[-1] != U.shape[-2]:
        raise ValueError(f"band_init_a: expected (C, Tp, Db, Db), got {tuple(U.shape)}")
    if not _route("band_init_a", U):
        return band_init_a_plain(U)
    C, Tp, Db, _ = U.shape
    A = torch.empty_like(U)
    _launch(_lib(), "band_init_a", U, U.data_ptr(), A.data_ptr(), C, Tp, Db)
    _count(band_init_a, Db)
    return A


def band_block_inv(D: torch.Tensor) -> torch.Tensor:
    """Inverse of every SPD block of D (C, Tp, Db, Db).

    Replaces ``score_tpu/ops/pallas_pcr.py:_block_inv_kernel`` (body
    ``_block_inv``). Bound on the card by latency: a launch, and the
    dependent f64 chains of a Cholesky and two substitutions (two blocks
    of traffic, ~0.2 us of HBM time at 1,024 blocks). At Db = 6 the
    lane-group layout of the level kernels: a group of 8 lanes owns a
    block, lane r loads row r (16-byte loads, the group's rows
    contiguous), the Cholesky runs across the group by shuffles and lane c
    solves column c of the inverse (``group_inv_spd``, shared with the
    Db = 6 level kernels), which leaves through shared memory as 16-byte
    stores. At Db = 12 a thread per block element: a thread block of 144
    threads a block (256 thread blocks at 3D 1x1000's remainder, over
    every SM), thread (r, c) reads elements (r, c) and (c, c), the
    Cholesky runs a column per block barrier and thread c solves column c
    with correctly rounded quotients by two corrections of a reciprocal
    (``element_inv_spd``, shared with ``band_pcr_level`` and
    ``band_cr_level`` at Db = 12, so the three agree bit for bit); thread
    (r, c) writes element (r, c). Both make the plain version's Cholesky
    and substitutions in its order; only nvcc's contraction to FMAs
    differs."""
    _check("band_block_inv", D)
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"band_block_inv: expected (C, Tp, Db, Db), got {tuple(D.shape)}")
    if not _route("band_block_inv", D):
        return band_block_inv_plain(D)
    C, Tp, Db, _ = D.shape
    out = torch.empty_like(D)
    _check_aligned("band_block_inv", D)
    _launch(_lib(), "band_block_inv", D, D.data_ptr(), out.data_ptr(), C * Tp, Db)
    _count(band_block_inv, Db)
    return out


def band_pcr_level(D, A, C, invD, s: int):
    """One PCR elimination level at shift s over all chains, from the band
    (D, A, C) and invD = D^-1: returns (E, F, D', A', C', invD'), each
    (C, Tp, Db, Db), with invD' = D'^-1 for the next level (or, after the
    last level, the factor's invD).

    Replaces ``score_tpu/ops/pallas_pcr.py:_factor_level_kernel`` and, by
    two launches at s and 2s, ``_factor_level2_kernel``. The TPU reached
    the neighbours i-s, i+s with masked lane rolls; here position (c, i)
    reads blocks i-s and i+s of chain c directly (zero outside the chain).

    What bounds it on the card: the traffic is 10 blocks per position
    (2.9 MB at Manhattan-4's remainder, under a microsecond of HBM time),
    so a launch is bound by latency, of the launch itself and of the
    dependent f64 chain of the products, a Cholesky and two
    substitutions. In both designs the nine input blocks of a position
    are staged in shared memory by 16-byte cp.async copies on
    neighbouring addresses and the six outputs leave by 16-byte stores;
    each block is inverted once per level. At Db = 6 a group of 8 lanes
    owns a position and lanes 0..5 each hold one row of every block in
    registers (C*Tp*8 threads in flight, 8192 at Manhattan-4's
    remainder); products read the other block's rows as shared-memory
    broadcasts, the Cholesky of D' runs across the group by shuffles, and
    lane c then solves column c of the inverse. At Db = 12, where a lane
    holding a row ran six products of 144 multiply-adds and a Cholesky of
    66 dependent shuffles with 2 warps an SM, a thread owns one element
    (r, c) of a position's 12 x 12 outputs (a thread block of 144
    threads a position): each product element is one 12-term chain,
    and the Cholesky runs a column per block barrier, each thread of the
    column forming its pivot by the same operations as the diagonal's;
    thread c then solves column c of the inverse. The sums run in the
    plain version's order (products k ascending from 0.0; the Cholesky
    left-looking, k ascending); only nvcc's contraction to FMAs differs."""
    for name, t in (("D", D), ("A", A), ("C", C), ("invD", invD)):
        _check(f"band_pcr_level.{name}", t, D.shape)
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"band_pcr_level: expected (C, Tp, Db, Db), got {tuple(D.shape)}")
    if not _route("band_pcr_level", D, A, C, invD):
        return band_pcr_level_plain(D, A, C, invD, s)
    nC, Tp, Db, _ = D.shape
    outs = [torch.empty_like(D) for _ in range(6)]
    _check_aligned("band_pcr_level", D, A, C, invD)
    _launch(_lib(), "band_pcr_level", D,
            D.data_ptr(), A.data_ptr(), C.data_ptr(), invD.data_ptr(),
            *[o.data_ptr() for o in outs], nC, Tp, Db, int(s))
    _count(band_pcr_level, Db)
    return tuple(outs)


def _solve_tile_columns(Tp: int, Db: int, K: int) -> int:
    """Columns of the register tile of band_pcr_solve at Db = 6, which
    names the kernel: ``_WIDE_COLUMNS`` is the wide kernel, 1, 2 or 4 the
    narrow one. The rule is on the shape alone: the wide kernel takes
    chains up to ``_WIDE_MAX_LENGTH`` blocks with more than 4 rhs columns;
    the narrow kernel takes the rest with the widest tile that K fills and
    that its threads' accumulators and the shared memory hold. Raises when
    not even one column fits, and for 3D blocks (Db = 12), which take the
    cluster kernel (:func:`_solve_cluster_plan`)."""
    if Db > _WIDE_MAX_BLOCK:
        raise ValueError(f"band_pcr_solve: {Db}-blocks take the cluster kernel, not a tile")
    if Tp <= _WIDE_MAX_LENGTH and K > 4:
        return _WIDE_COLUMNS
    for ct in (4, 2, 1):
        if (ct < 2 * K and Tp * Db * ct <= _NARROW_ACCUMULATORS * _NARROW_THREADS
                and _solve_smem_bytes(Tp, Db, ct) <= _SMEM_MAX):
            return ct
    raise ValueError(
        f"band_pcr_solve: chain length {Tp} with {Db}-blocks does not fit a "
        f"thread block: one rhs column needs {Tp * Db} outputs in registers "
        f"(max {_NARROW_ACCUMULATORS * _NARROW_THREADS}) and "
        f"{_solve_smem_bytes(Tp, Db, 1)} bytes of shared memory (max {_SMEM_MAX})"
    )


def _cluster_smem_bytes(Tp: int, Db: int, P: int, Kc: int) -> int:
    """Shared memory the plan leaves one thread block of the cluster
    kernel: its Tp / P positions' rhs rows in two (n, Db, Kc) f64 buffers
    (one per level parity) and a two-stage ring of their E and F blocks
    (the kernel deepens the ring into what is left, csrc/band.cu)."""
    n = Tp // P
    return (2 * n * Db * Kc + 2 * 2 * n * Db * Db) * 8


def _solve_cluster_plan(Tp: int, Db: int, K: int, C: int = 1, n_sm: int = _SM_COUNT,
                        P: int | None = None) -> tuple:
    """(P, Kc) of band_pcr_solve's cluster kernel (Db = 12) on C chains of
    Tp blocks and K rhs columns, on a card of n_sm SMs: P thread blocks per
    chain (``P``, default ``_SOLVE_CLUSTER``, cut to Tp), each holding
    Tp / P positions, and Kc columns per cluster, evened out over the
    chunks on the grid's second axis: as many chunks as the shared memory
    needs (two rhs buffers and a ring of two E, F stages), or, where that
    leaves SMs idle, as many as the card runs at once over the C chains (a
    chain's clusters then share its E, F from L2 and each does 1 / chunks
    of the products).
    Raises when not even one column fits."""
    P = min(_SOLVE_CLUSTER if P is None else P, Tp)
    if P < 1 or P > _CLUSTER_MAX or P & (P - 1) or Tp % P:
        raise ValueError(f"band_pcr_solve: cluster size {P} for chain length {Tp}")
    per_column = _cluster_smem_bytes(Tp, Db, P, 1) - _cluster_smem_bytes(Tp, Db, P, 0)
    most = (_CLUSTER_SMEM_MAX - _cluster_smem_bytes(Tp, Db, P, 0)) // per_column
    if most < 1:
        raise ValueError(
            f"band_pcr_solve: chain length {Tp} with {Db}-blocks does not fit a "
            f"cluster of {P}: one rhs column needs {_cluster_smem_bytes(Tp, Db, P, 1)} "
            f"bytes of shared memory a thread block (max {_CLUSTER_SMEM_MAX})")
    # clusters the columns are spread over: one fewer than n_sm / P, since
    # clusters past what the card holds at once run in a second wave
    budget = max(1, n_sm // P - 1)
    K = max(K, 1)
    chunks = max(-(-K // most), min(K, budget // C))
    return P, -(-K // chunks)


def _solve_groups(Tp: int, Db: int, K: int, C: int = 1, n_sm: int = _SM_COUNT) -> int:
    """Threads per position of the wide kernel (each holds 8 columns, so a
    block holds 8 * groups columns and re-reads of E, F fall by that
    factor): the largest power of two that the block's threads and K
    allow, halved while the grid would leave SMs without a block."""
    g = 1
    while (2 * g <= _WIDE_MAX_GROUPS and 2 * g * Tp <= _WIDE_MAX_LENGTH
           and g * _WIDE_COLUMNS < K):
        g *= 2
    while g > 1 and C * -(-K // (g * _WIDE_COLUMNS)) < n_sm:
        g //= 2
    return g


def _solve_smem_bytes(Tp: int, Db: int, ct: int, groups: int = 1) -> int:
    """Shared memory of one band_pcr_solve block: one (Tp, Db, columns)
    f64 rhs buffer, updated in place. The wide kernel (ct = 8, columns =
    8 * groups) pads each position by two doubles against bank conflicts
    and adds its ring of ``_WIDE_RING`` tiles of (Tp, Db / 2, Db) half
    blocks of E, F."""
    if ct == _WIDE_COLUMNS:
        return (_WIDE_RING * Tp * (Db // 2) * Db + Tp * (Db * ct * groups + 2)) * 8
    return Tp * Db * ct * 8


def _solve_chunk_columns(Tp: int, Db: int, K: int, C: int = 1,
                         n_sm: int = _SM_COUNT) -> int:
    """rhs columns that one band_pcr_solve block (a cluster at Db = 12)
    holds for C chains on a card of n_sm SMs: its threads' tiles
    (:func:`_solve_tile_columns`, times :func:`_solve_groups` for the wide
    kernel), or all K where K is less; the cluster plan's Kc at Db = 12."""
    if Db > _WIDE_MAX_BLOCK:
        return _solve_cluster_plan(Tp, Db, K, C, n_sm)[1]
    ct = _solve_tile_columns(Tp, Db, K)
    if ct == _WIDE_COLUMNS:
        ct *= _solve_groups(Tp, Db, K, C, n_sm)
    return min(K, ct)


def band_pcr_solve(E, F, invD, b):
    """Solve through stored factors for b (C, Tp, Db, K); returns x of
    the same shape.

    Replaces ``score_tpu/ops/pallas_pcr.py:_solve_kernel``. All levels
    run in ONE launch: at Db = 6 one thread block per (chain, chunk of rhs
    columns) keeps its rhs slice in shared memory in a single buffer
    updated in place (a thread holds a level's outputs in registers
    across the barrier that ends the level's reads); at Db = 12 one
    thread-block cluster per (chain, chunk). This replaces the TPU's VMEM
    chunking over chains and columns by a launch grid.

    What bounds it on the card (measured, PERF.md). At Db = 6, the reads
    of E and F, which every block of a chain repeats from L2, for the
    panel (K = arrow width) together with its products' shared-memory
    reads; a direction (K = 1) runs one block per chain, whose SM pulls
    each level's 147 KB (Tp = 256) in ~1.2 us. The design: for the panel
    a thread owns a position and a register tile of all Db rows by 8
    columns, so an element of E, F is read once for 8 columns and an
    element of b once for 6 rows. A level's E and F pass through shared
    memory as four tiles of half blocks in a ring of three, filled by
    16-byte cp.async copies on neighbouring addresses while the tile
    before is used. One in-place buffer and the card's 227 KB leave room
    for 8 columns at Manhattan-4's remainder and, with two threads per
    position sharing the staged E, F, 16 at robot20's. For K <= 4 the
    narrow kernel spreads the Db rows of a position over neighbouring
    lanes, whose loads of E, F rows are contiguous across the warp, all
    of a level's loads in flight at once.

    At Db = 12 one SM per (chain, column) pulled all levels of E and F
    (4.7 MB at a chain of 256) at ~67 GB/s: 70 us against a bound of 1.5.
    The cluster kernel spreads a chain over a thread-block cluster of P
    blocks (:func:`_solve_cluster_plan`), each owning Tp / P positions and
    their rhs rows for a chunk of columns in two shared-memory buffers
    (one per level parity); a position's neighbours at i -+ s are read
    from their owner's shared memory across the cluster, one cluster
    barrier a level, and a producer thread streams the block's E, F of the
    next level into a two-stage ring by bulk copies while a level is
    computed. Each block reads E, F and invD once per solve, whatever K
    is; the cluster barrier and the dependent chain of a level's 24
    multiply-adds are what bound it (PERF.md). A refused launch (a cluster
    the card cannot place, or too much shared memory) raises.

    Shared-memory attributes are set once per kernel. The sums of a level
    run over E's terms then F's in one accumulator, an order that differs
    from the plain version's (E b + F b)."""
    if E.dim() != 5 or invD.dim() != 4 or b.dim() != 4:
        raise ValueError("band_pcr_solve: expected E, F (L, C, Tp, Db, Db), "
                         "invD (C, Tp, Db, Db), b (C, Tp, Db, K)")
    nC, Tp, Db, K = b.shape
    L = num_levels(Tp)
    _check("band_pcr_solve.E", E, (L, nC, Tp, Db, Db))
    _check("band_pcr_solve.F", F, (L, nC, Tp, Db, Db))
    _check("band_pcr_solve.invD", invD, (nC, Tp, Db, Db))
    _check("band_pcr_solve.b", b)
    if not _route("band_pcr_solve", invD, E, F, b):
        return band_pcr_solve_plain(E, F, invD, b)
    x = torch.empty_like(b)
    if K == 0:
        return x
    if Db > _WIDE_MAX_BLOCK:
        ct, groups = _solve_cluster_plan(Tp, Db, K, nC, _sm_count(b.device))  # P, Kc
    else:
        ct = _solve_tile_columns(Tp, Db, K)
        groups = 1
        if ct == _WIDE_COLUMNS:
            groups = _solve_groups(Tp, Db, K, nC, _sm_count(b.device))
    _check_aligned("band_pcr_solve", E, F, invD)
    _launch(_lib(), "band_pcr_solve", b,
            E.data_ptr(), F.data_ptr(), invD.data_ptr(), b.data_ptr(), x.data_ptr(),
            nC, Tp, Db, L, K, ct, groups)
    _count(band_pcr_solve, Db)
    return x


def _check_fine_band(name, D, A, C):
    for n, t in (("D", D), ("A", A), ("C", C)):
        _check(f"{name}.{n}", t, D.shape)
    if D.dim() != 4 or D.shape[-1] != D.shape[-2] or D.shape[1] % 2:
        raise ValueError(f"{name}: expected (C, T, Db, Db) with T even, got {tuple(D.shape)}")


# band_cr_level at Db = 12: coarse positions a thread block
# (csrc/band.cu: cr_level_element_kernel<12, P>, built for P = 1 and 3):
# _CR_LEVEL_TILE from _CR_LEVEL_TILE_FROM positions a level, else 1. P = 3
# holds six positions an SM where P = 1 holds four (two thread blocks of
# 576 threads against four of 288) and inverts one odd block in four twice
# where P = 1 inverts every one twice: faster where a level takes several
# waves of the card (the 3D fold's first four levels), slower below.
_CR_LEVEL_TILE = 3
_CR_LEVEL_TILE_FROM = 1024


def _cr_level_tile(nC: int, Th: int, Db: int) -> int:
    """P, the coarse positions a band_cr_level thread block owns on nC
    chains of Th coarse positions: at Db = 12 ``_CR_LEVEL_TILE`` where the
    level has ``_CR_LEVEL_TILE_FROM`` positions or more (at the 3D fold,
    C = 64, P = 3 took 112.4, 61.5, 32.5, 18.9 us against P = 1's 131.4,
    68.8, 35.9, 19.6 from 8,192 down to 1,024 positions, and 12.6 against
    11.3 at 512; NVIDIA H100 80GB HBM3, 700 W, profile_port.py --factor),
    else 1; 1 at Db = 6, whose kernel has its own tile. The grid changes
    with P, the launches do not, so a batch's launches stay a 1-trial
    batch's."""
    if Db > _FACTOR_MAX_BLOCK and nC * Th >= _CR_LEVEL_TILE_FROM:
        return _CR_LEVEL_TILE
    return 1


def band_cr_level(D, A, C):
    """One compacting CR level over all chains: from the fine band
    (C, T, Db, Db) returns (E, F, invD_odd, A_odd, C_odd, D', A', C'),
    each (C, T/2, Db, Db) (see :func:`band_cr_level_plain`). The 3D factor
    (Db = 12) runs it a level; the 2D factor takes its levels in
    :func:`band_cr_factor` launches (:func:`_factor_takes`).

    Replaces ``score_tpu/ops/pallas_pcr.py:_cr_level_kernel`` together
    with its caller's even/odd lane slices (:606-620): the group of coarse
    position (c, j) reads fine rows 2j and 2j +- 1 by index and writes the
    coarse row j, so no gather runs between levels. It computes only the
    kept rows, where the TPU kernel computed every row and the caller
    dropped half.

    What bounds it on the card: 7 blocks of traffic per pair of fine rows
    (1.6 MB at Manhattan-4's first level, half a microsecond of HBM
    time), so a launch is bound by latency, of the launch and of the
    dependent f64 chain of a Cholesky, two substitutions and two
    row-times-block products. Every group of a thread block inverts the
    ONE odd block 2j + 1 of the position it owns and leaves it in shared
    memory; after a block barrier F_j takes it and E_{j+1} of the next
    group takes it too, and one more group inverts the odd block before
    the first position, all side by side.

    At Db = 6 the design is ``band_pcr_level``'s: a group of 8 lanes per
    coarse position, lanes 0..Db-1 one row of every block each, inputs
    staged in shared memory by 16-byte cp.async, products against
    shared-memory broadcasts, outputs by 16-byte stores, and the group
    inversion (Cholesky by shuffles, lane c solves column c) is the device
    function that ``band_pcr_level`` calls; a thread block is 15 positions
    and the halo group (1 inversion in 16 is repeated). At Db = 12 a
    thread per block element, as ``band_pcr_level`` at Db = 12: a group
    is 144 threads, thread (r, c) owning element (r, c) of every block the
    group touches; a thread block is P coarse positions and P + 1 groups
    (:func:`_cr_level_tile`: 3 on levels of 1,024 positions or more, else
    1; the same bits at every P), the odd blocks inverted by the
    element inversion the Db = 12 ``band_pcr_level`` and
    ``band_block_inv`` call (a Cholesky column per block barrier,
    correctly rounded quotients from reciprocals), while the A and C rows
    the products read arrive in shared memory by 16-byte cp.async; then E
    and F, a barrier, and A', C' and the two terms of D', each element a
    12-term chain, and every output leaves from the register holding it.
    Sums run in the plain version's order; only nvcc's contraction to FMAs
    differs."""
    _check_fine_band("band_cr_level", D, A, C)
    if not _route("band_cr_level", D, A, C):
        return band_cr_level_plain(D, A, C)
    nC, T, Db, _ = D.shape
    outs = [D.new_empty((nC, T // 2, Db, Db)) for _ in range(8)]
    _check_aligned("band_cr_level", D, A, C)
    _launch(_lib(), "band_cr_level", D,
            D.data_ptr(), A.data_ptr(), C.data_ptr(), *[o.data_ptr() for o in outs],
            nC, T // 2, Db, _cr_level_tile(nC, T // 2, Db))
    _count(band_cr_level, Db)
    return tuple(outs)


# band_cr_factor: the block size it is built for and the threads of a
# thread block (csrc/band.cu: kFactorBlock, kFactorThreads); the most
# levels of a factor's last run where it ends at
# one position a chain, a chain a thread block (the chain's 2^n rows of D,
# A, C in shared memory): chains of up to 2^_FACTOR_WHOLE_LEVELS take the
# factor in that one launch, longer ones end with a run of
# _FACTOR_CHAIN_LEVELS (the fastest split on the cells' 2D bands, NVIDIA
# H100 80GB HBM3: profile_port.py --factor --builds, PERF.md §6), after the
# fewest runs of halo tiles that fit the shared memory.
_FACTOR_MAX_BLOCK = 6
_FACTOR_THREADS = 288
_FACTOR_WHOLE_LEVELS = 6
_FACTOR_CHAIN_LEVELS = 5


def _factor_takes(Db: int) -> bool:
    """Whether band_factor runs its compacting levels in band_cr_factor
    launches at block size Db (the size it is built for), or keeps a
    band_cr_level launch a level and band_block_inv. A Db = 12 build
    measured slower than the per-level kernels at every cell (3D 4x250, 3D
    1x1000 and the 16-trial 3D fold; NVIDIA H100 80GB HBM3, PERF.md §6): in
    one SM a level's row inversions and product passes cost more than a
    launch a level over the card. The route is by block size alone, so that
    a batch's launches a trip equal a 1-trial batch's."""
    return Db <= _FACTOR_MAX_BLOCK


def _factor_rows(n: int, T: int, P: int) -> int:
    """Fine rows a band_cr_factor thread block stages for a tile of P
    positions of level n: the tile's and the left halo's (csrc/band.cu:
    cr_factor_rows), the whole chain of T where the tile is the chain."""
    return T if P == T >> n else (P << n) + (1 << n) - 1


def _factor_smem(n: int, T: int, P: int, Db: int, last: bool) -> int:
    """Shared memory of a band_cr_factor thread block (csrc/band.cu:
    cr_factor_smem): the rows' D, A, C, and for a run that ends at one
    position a chain the final group inversion's L and inverse."""
    return 8 * (3 * _factor_rows(n, T, P) + 2 * last) * Db * Db


def _factor_most_levels(Db: int) -> int:
    """The deepest run of band_cr_factor whose tile of one position with
    the halo (2^(n + 1) - 1 rows) fits the card's shared memory."""
    n = 1
    while n < _CR_MAX_LEVELS and _factor_smem(n + 1, 4 << n, 1, Db, False) <= _SMEM_MAX:
        n += 1
    return n


def _factor_runs(Tp: int, Db: int, n_cr: int | None = None) -> list:
    """The levels of each band_cr_factor launch of a factor of chains of Tp
    through n_cr compacting levels (default :func:`cr_depth`), fine ->
    coarse. Where the levels end at one block a chain, a chain of up to
    2^``_FACTOR_WHOLE_LEVELS`` blocks is one run, a longer one ends with a
    run of ``_FACTOR_CHAIN_LEVELS`` levels, a chain a thread block; the
    levels before take the fewest runs of halo tiles that fit the shared
    memory, as even as they come. The count depends on (Tp, Db, n_cr)
    alone, never on the chains: a Monte-Carlo batch folds its trials into
    them."""
    n_cr = cr_depth(Tp) if n_cr is None else n_cr
    runs, rest = [], n_cr
    if n_cr and n_cr == num_levels(Tp):
        runs.append(n_cr if n_cr <= _FACTOR_WHOLE_LEVELS else _FACTOR_CHAIN_LEVELS)
        rest -= runs[0]
    if rest:
        k = -(-rest // _factor_most_levels(Db))
        runs = [rest // k + (i < rest % k) for i in range(k)] + runs
    return runs


def _factor_tile(n: int, T: int, Db: int, C: int = 1, n_sm: int = _SM_COUNT) -> int:
    """P, the positions of level n a band_cr_factor thread block owns on C
    chains of T: 1 where the run ends at one position a chain (the tile is
    the chain), else the largest power of two that leaves a thread block
    for every SM and keeps its shared memory within two thread blocks an SM
    (fewer tiles, less halo recomputed). Raises where one position does not
    fit."""
    Tn, P = T >> n, 1
    while (2 * P <= Tn and C * (Tn // (2 * P)) >= n_sm
           and _factor_smem(n, T, 2 * P, Db, False) <= _CHAIN_SMEM_TARGET):
        P *= 2
    smem = _factor_smem(n, T, P, Db, Tn == 1)
    if smem > _SMEM_MAX:
        raise ValueError(f"band_cr_factor: {n} levels of {Db}-blocks on chains of {T} do not "
                         f"fit a thread block: {smem} bytes of shared memory (max {_SMEM_MAX})")
    return P


def band_cr_factor(D, A, C, n: int, last: bool = False) -> CRRun:
    """n compacting CR levels over all chains in ONE launch, from the band
    (D, A, C), (C, T, Db, Db): a :class:`CRRun` of the n levels' blocks and
    the band they leave (C, T >> n, Db, Db), or, with ``last`` (T = 2^n: the
    run ends at one position a chain), that block's inverse in its place
    (see :func:`band_cr_factor_plain`, ``band_cr_level_plain`` n times then
    ``band_block_inv_plain``).

    Replaces ``score_tpu/ops/pallas_pcr.py:_cr_level_kernel`` and its
    caller's launch a level (:606-620) with ONE launch a run, and on the
    factor's path ``_block_inv_kernel`` (the last level's inverse). Built
    for Db = 6 (``_FACTOR_MAX_BLOCK``); a CUDA tensor of another block size
    raises. What bounds it: a factor's bytes take 1.4-1.75 us of HBM time
    on the 2D solves' bands (17.5 at the 2D fold), its time is the
    dependent chain of its levels, an inversion of the odd blocks and
    products a level, which the earlier kernel paid with a launch and an
    HBM round trip of D', A', C' a level. A thread block owns a tile of P
    positions of the run's last level (:func:`_factor_tile`) and stages the
    fine rows they depend on, with the left halo of 2^n - 1 rows, in shared
    memory; every level runs there in place, its odd blocks inverted side
    by side (a group of Db threads a block, a row a thread, the group
    inversion's operations in its order), then E, F and A', C', D' a thread
    per row and 2 columns. Only the tile's own positions leave; a run that
    ends at one position a chain is a chain a thread block, which inverts
    the last D' with band_block_inv's function (csrc/band.cu). Sums run in
    the plain version's order; only nvcc's contraction to FMAs differs.
    band_factor takes it at Db = 6 (:func:`_factor_takes`): 0.52-0.54x the
    per-level kernels' factor on Manhattan-4 and robot20 and 0.93x at the
    2D fold (NVIDIA H100 80GB HBM3, profile_port.py --factor; PERF.md
    §6)."""
    _check_fine_band("band_cr_factor", D, A, C)
    nC, T, Db, _ = D.shape
    if not 1 <= n <= _CR_MAX_LEVELS or T % (1 << n):
        raise ValueError(f"band_cr_factor: {n} levels on chains of {T} (1 to {_CR_MAX_LEVELS} "
                         "levels that halve it)")
    if last and T >> n != 1:
        raise ValueError(f"band_cr_factor: {n} levels on chains of {T} end at {T >> n} "
                         "positions, not one (last)")
    if not _route("band_cr_factor", D, A, C):
        return band_cr_factor_plain(D, A, C, n, last)
    if Db > _FACTOR_MAX_BLOCK:
        raise ValueError(f"band_cr_factor: the CUDA kernel is built for block size "
                         f"{_FACTOR_MAX_BLOCK}, got {Db}")
    from score_tpu_torch.ops.build import CrFactorLevels

    levels = tuple(CRLevel(*[D.new_empty((nC, T >> (lev + 1), Db, Db)) for _ in range(5)])
                   for lev in range(n))
    Tn = T >> n
    band_out = [None] * 3 if last else [D.new_empty((nC, Tn, Db, Db)) for _ in range(3)]
    invD = D.new_empty((nC, 1, Db, Db)) if last else None
    if nC == 0:
        return CRRun(levels, *band_out, invD)
    ptrs = CrFactorLevels()
    for lev, lv in enumerate(levels):
        ptrs.E[lev], ptrs.F[lev], ptrs.invD[lev], ptrs.A[lev], ptrs.C[lev] = (
            t.data_ptr() for t in lv)
    _check_aligned("band_cr_factor", D, A, C)
    P = _factor_tile(n, T, Db, nC, _sm_count(D.device))
    _launch(_lib(), "band_cr_factor", D, D.data_ptr(), A.data_ptr(), C.data_ptr(), ptrs,
            *[None if t is None else t.data_ptr() for t in (*band_out, invD)],
            n, nC, T, Db, P)
    _count(band_cr_factor, Db, (T, n))
    return CRRun(levels, *band_out, invD)


def _backsub_narrow(K: int) -> bool:
    """True where band_cr_backsub's narrow step (a lane group per position)
    serves the rhs width K: directions (K = 1) and any K up to
    ``_BACKSUB_NARROW_MAX_K``; the arrow panel (K = arrow width) takes a
    step that gives threads columns."""
    return K <= _BACKSUB_NARROW_MAX_K


def _backsub_step(Db: int, K: int) -> str:
    """band_cr_backsub's per-level step, by the rhs width and block size:
    "narrow" (a lane group per position, lane r a row) for K <= 4; above,
    "wide" at Db = 6 (a thread per position and column pair) and "element"
    at Db = 12 (a thread per three rows of a column, the levels' blocks
    staged in shared memory). csrc/band.cu chooses by the same rule."""
    if _backsub_narrow(K):
        return "narrow"
    return "wide" if Db <= _WIDE_MAX_BLOCK else "element"


def _cr_smem_bytes(step: str, n: int, Db: int, P: int, Kc: int) -> int:
    """Shared memory of one thread block of a fused CR launch over n levels
    with a tile of P coarsest positions and Kc columns: for "reduce" every
    level's E and F at its own and halo positions, the fine rows with the
    left halo of 2^n - 1, and level 1's output; for band_cr_backsub's
    steps the solution buffer ((P << n) + 1 rows; none for one level of the
    narrow and wide steps, which read and write x in HBM) and for "element"
    every level's invD, A, C and odd rows of b (csrc/band.cu:
    cr_reduce_smem, cr_backsub_smem)."""
    BS, RS = Db * Db, Db * Kc
    if step == "reduce":
        d = sum(2 * (((P + 1) << (n - lev)) - 1) * BS for lev in range(1, n + 1))
        d += (((P + 1) << n) - 1) * RS
        if n > 1:
            d += (((P + 1) << (n - 1)) - 1) * RS
        return 8 * d
    rows = ((P << n) + 1) * RS
    if step != "element":
        return 8 * rows if n > 1 else 0
    return 8 * (rows + sum((P << (n - lev)) * (3 * BS + RS) for lev in range(1, n + 1)))


def _even_chunk(K: int, chunks: int) -> int:
    """Columns of a chunk when K is cut into ``chunks``: even where K is,
    so that every chunk moves by 16-byte units."""
    Kc = -(-K // chunks)
    return Kc + (K % 2 == 0 and Kc % 2)


def _cr_plan(step: str, n: int, Tn: int, Db: int, K: int, C: int = 1,
             n_sm: int = _SM_COUNT, P: int | None = None) -> tuple:
    """(P, Kc) of a tile kernel's launch ("reduce", or band_cr_backsub's
    :func:`_backsub_step`) of n levels over C chains whose coarsest level
    has Tn positions, with K rhs columns, on a card of n_sm SMs. The
    wrappers take the tile kernels for runs that end at more than one
    position a chain (Tn > 1: a solve's first runs), and the reduce's tile
    with P = 1 is the chain reduce's fine phase; a run that ends at one
    position a chain takes the chain kernels (:func:`_cr_chain_plan`),
    where a tile of P = Tn = 1 would be the whole chain with a halo.

    P, the coarsest positions of a thread block's tile (``P`` where given),
    a power of two up to Tn: for the reduce and the element step the
    largest that still leaves a thread block for every SM (C ceil(Tn / P)
    >= n_sm), so that the grid covers the card wherever the chain allows;
    for the narrow and wide steps the largest whose finest level has at
    most ``_CR_STEP_ITEMS`` work items (lane groups' lanes, or column
    pairs) and that leaves a thread block for every second SM: fewer,
    fuller tiles measured faster there, down to that grid (PERF.md); a
    solve of one level takes no tile there (P = 1, all K: csrc/band.cu
    runs the per-level kernels' grids). Kc, the columns of a thread block: all K, or the
    fewest even chunks that bring the block's shared memory under
    ``_CR_SMEM_TARGET`` (several thread blocks an SM) once P is down to 1,
    down to chunks of 16 columns, and at worst under the card's 227 KB at
    any width. Raises when one column of one position does not fit."""
    if step in _CR_STEP_ITEMS and n == 1:  # no tile: a thread a work item, HBM to HBM
        return 1, K
    if P is None:
        P = 1
        if step in _CR_STEP_ITEMS:  # threads a finest position, and their most a tile
            per = (8 if Db <= 8 else 16) if step == "narrow" else (K // 2 if K % 2 == 0 else K)
            while (2 * P <= Tn and (2 * P << (n - 1)) * per <= _CR_STEP_ITEMS[step]
                   and 2 * C * -(-Tn // (2 * P)) >= n_sm):
                P *= 2
        else:
            while 2 * P <= Tn and C * -(-Tn // (2 * P)) >= n_sm:
                P *= 2
    if not 1 <= P <= Tn:
        raise ValueError(f"fused CR launch: a tile of {P} positions on chains of {Tn}")
    chunks, Kc = 1, K
    fits = lambda limit: _cr_smem_bytes(step, n, Db, P, Kc) <= limit

    def fewer_columns(least):
        """The next smaller even chunk of at least ``least`` columns, or
        False where there is none."""
        nonlocal chunks, Kc
        for more in range(chunks + 1, K + 1):
            if _even_chunk(K, more) < Kc:
                if _even_chunk(K, more) < least:
                    return False
                chunks, Kc = more, _even_chunk(K, more)
                return True
        return False

    if step != "narrow":
        while not fits(_CR_SMEM_TARGET):
            if P > 1:
                P //= 2
            elif not fewer_columns(16):
                break
        while not fits(_SMEM_MAX) and fewer_columns(1):
            pass
    if not fits(_SMEM_MAX):
        raise ValueError(
            f"fused CR launch ({step}): {n} levels of {Db}-blocks with {K} rhs columns do "
            f"not fit a thread block: {_cr_smem_bytes(step, n, Db, P, Kc)} bytes of shared "
            f"memory (max {_SMEM_MAX})")
    return P, Kc


def _cr_launch_depths(step: str, n: int, Db: int, K: int) -> list:
    """The levels of each launch of a fused CR kernel over n levels: all n
    in one launch wherever a tile of one position and one column fits the
    shared memory (up to ``_CR_MAX_LEVELS``; at Db = 12 the reduce's halo
    blocks and the element step's blocks allow 5, so chains of 16,384 and
    more take a second launch), else the deepest runs that fit, fine ->
    coarse."""
    depths = []
    while n:
        d = min(n, _CR_MAX_LEVELS)
        # the narrowest chunk a plan can take: all K for the narrow step,
        # else one column, two where K is even (16-byte copies)
        least = K if step == "narrow" else min(K, 1 + (K % 2 == 0))
        while d > 1 and _cr_smem_bytes(step, d, Db, 1, least) > _SMEM_MAX:
            d -= 1
        depths.append(d)
        n -= d
    return depths


# The chain kernels (runs that end at one position a chain): a plan keeps a
# thread block's shared memory within _CHAIN_SMEM_TARGET where it can, two
# thread blocks an SM (228 KB an SM, 1 KB of it reserved a thread block).
_CHAIN_SMEM_TARGET = 115712
# the chain reduce (csrc/band.cu: cr_reduce_tree_kernel): a tile stage of
# _STAGE_LEVELS[(K >= _REGISTER_ROWS_K, Db)] levels at most before the
# whole chain's, which takes the last levels from a chain of
# _chain_tail(n, Db, K) positions and stages their E, F (the fastest of the
# plans profile_port.py --cr --pass --sweep timed at the cells, NVIDIA H100
# 80GB HBM3, 700 W; PERF.md §6)
_STAGE_LEVELS = {(False, 6): 4, (False, 12): 3, (True, 6): 5, (True, 12): 3}
# bytes of the tree reduce's shared memory before its stages' (csrc/band.cu:
# kTreeHeader): the flag of a chain's last ticket, an mbarrier a level
_TREE_HEADER = 8 * (2 + _CR_MAX_LEVELS)
# the directions' chain back substitution (csrc/band.cu:
# cr_backsub_lanes_kernel, lanes_max_k): a lane group a position of a
# segment's widest level, at most _LANES_THREADS threads a thread block, up
# to _LANES_MAX_K[Db] rhs columns (three levels' rows in registers); the
# tile kernels keep the directions (in one launch) from _MANY_CHAINS chains
# (PERF.md §6)
_LANE_GROUP = {6: 8, 12: 16}
_LANES_THREADS = 256
_LANES_MAX_K = {6: 4, 12: 2}
_MANY_CHAINS = 32


def _chain_tail(n: int, Db: int, K: int) -> int:
    """Positions of the chain the tree reduce's whole-chain stage starts
    from: for a direction 2^(n - 4) (the tile stage four levels deep:
    Manhattan-4 10.9 us against 11.3-11.7 at 3 and 5; at Db = 12 three,
    the 3D fold 30.1 against 31.2, 3D 4x250 12.0 against 11.8, and 3D
    1x1000 four where three levels leave more E, F than a thread block
    holds), for a 2D panel 2^max(n - 5, 3) (robot20 8: 83.2 against 95-104;
    Manhattan-4 16: 51.0 against 56-61), for a 3D panel 8 (the tile stage
    then as deep as ``_STAGE_LEVELS`` allows); profile_port.py --cr --pass
    --sweep, NVIDIA H100 80GB HBM3, 700 W."""
    if K < _REGISTER_ROWS_K:
        return 1 << max(n - 4, 1)
    if Db <= _WIDE_MAX_BLOCK:
        return 1 << max(n - 5, 3)
    return 8


class ReducePlan(NamedTuple):
    """band_cr_reduce on a run that ends at one position a chain
    (csrc/band.cu: cr_reduce_tree_kernel, CrReducePlan): a tile stage of
    levels 1 .. ``top`` (0: none, a chain a thread block; then Kf = K) with
    tiles of ``P`` positions of level top, in chunks of ``Kf`` columns; then
    the whole chain from level top, a thread block each chunk of Kf columns,
    in chunks of ``Kc`` columns, its E, F staged in shared memory where
    ``stage``."""

    top: int
    P: int
    Kf: int
    Kc: int
    stage: bool


class BacksubPlan(NamedTuple):
    """band_cr_backsub on a run that ends at one position a chain: ``S``
    segments a chain, a thread block each, in chunks of ``Kc`` columns (all
    K for the directions' lane groups)."""

    S: int
    Kc: int


def _tree_reduce_smem(n: int, Db: int, K: int, plan: ReducePlan) -> int:
    """Shared memory of one thread block of the tree reduce (csrc/band.cu:
    cr_tree_reduce_smem): the more of its stages' (the tile's,
    :func:`_cr_smem_bytes`; the whole chain's: its E, F where staged and one
    or two chunks of Kc columns of its rows), and ``_TREE_HEADER`` bytes
    for the flag of the chain's last ticket and the whole chain's
    mbarriers."""
    Tc = (1 << n) >> plan.top
    chunks = -(-plan.Kf // plan.Kc)
    d = 8 * ((2 if chunks > 1 else 1) * Tc * Db * plan.Kc
             + (2 * (Tc - 1) * Db * Db if plan.stage else 0))
    if plan.top:
        d = max(d, _cr_smem_bytes("reduce", plan.top, Db, plan.P, plan.Kf))
    return d + _TREE_HEADER


def _chain_intervals(n: int, S: int, s: int) -> list:
    """(lo, hi) of x_l for l = 0 .. n that segment s of S of a chain of 2^n
    needs (csrc/band.cu: chain_intervals): its own rows at l = 0, then
    x_{l-1}[2p] = x_l[p] and x_{l-1}[2p + 1] from x_l[p], x_l[p + 1]."""
    T = 1 << n
    lo = s * (T // S)
    hi = lo + T // S - 1
    out = [(lo, hi)]
    for lev in range(1, n + 1):
        lo, hi = lo >> 1, min((hi + 1) >> 1, (T >> lev) - 1)
        out.append((lo, hi))
    return out


# the chain back substitution's ring of level slots (csrc/band.cu:
# kBacksubRing): level l's blocks in slot (l - 1) % 3, issued two levels
# ahead of the level computed
_BACKSUB_RING = 3


@functools.lru_cache(maxsize=None)
def _chain_backsub_shape(n: int, Db: int, S: int, Kc: int) -> tuple:
    """(shared memory bytes, x buffer rows, most positions of a level) of
    the chain back substitution over S segments (csrc/band.cu:
    cr_chain_backsub_shape): the most over the segments of its ring of
    ``_BACKSUB_RING`` level slots (fewer where the run has fewer levels),
    each the widest of the levels it takes (their invD, A, C and b at the
    odd rows; level l in slot (l - 1) % 3), and two buffers of the longest
    interval of x_l (l >= 1)."""
    D = min(n, _BACKSUB_RING)
    blocks, rows, items = 0, 1, 1
    for s in range(S):
        iv = _chain_intervals(n, S, s)
        widest = [0] * D
        for lev in range(1, n + 1):
            lo, hi = iv[lev - 1]
            np_ = max((((hi - 1) >> 1) - (lo >> 1) + 1) if hi >= 1 else 0, 0)
            j = (lev - 1) % D
            widest[j] = max(widest[j], np_ * (3 * Db * Db + Db * Kc))
            rows = max(rows, iv[lev][1] - iv[lev][0] + 1)
            items = max(items, (hi >> 1) - (lo >> 1) + 1)
        blocks = max(blocks, sum(widest))
    return 8 * (blocks + 2 * rows * Db * Kc), rows, items


def _chunks(K: int, fits, even: bool) -> int | None:
    """The widest chunk of K columns (the fewest chunks; even where
    ``even``) for which fits(Kc) holds, or None."""
    for chunks in range(1, K + 1):
        Kc = _even_chunk(K, chunks) if even else -(-K // chunks)
        if Kc <= K and fits(Kc):
            return Kc
    return None


def _chain_takes(step: str, n: int, Db: int, K: int, C: int, n_sm: int) -> bool:
    """Whether a chain kernel takes a run of n levels that ends at one
    position a chain (one launch each way: at the default schedule a whole
    band-solve pass), or the tile kernels keep it, where they take it in one
    launch too and measured faster: the 2D panel's back substitution on
    chains of up to 128 (robot20: 69.8 us against 126) but on chains that
    fill the card (the 2D fold: 117.5-128.6 against 128.2), and the
    directions' (K <= 4) on ``_MANY_CHAINS`` chains and more (the folds:
    the lane groups 15.6 us at one segment a chain and 11.4 at two against
    11.9 at the 2D fold, 34.6-38.5 against 30.3 at the 3D fold); NVIDIA
    H100 80GB HBM3, 700 W, profile_port.py --cr --pass --sweep, PERF.md
    §6. The reduce always."""
    if step == "reduce":
        return True
    if _backsub_narrow(K):
        tiles = C >= _MANY_CHAINS
    else:
        tiles = Db <= _WIDE_MAX_BLOCK and n <= 7 and C < n_sm
    return not (tiles and len(_cr_launch_depths(_backsub_step(Db, K), n, Db, K)) == 1)


def _cr_chain_plan(step: str, n: int, Db: int, K: int, C: int = 1,
                   n_sm: int = _SM_COUNT):
    """The plan of a chain kernel for a run of n levels that ends at one
    position a chain (:func:`_chain_plan`), or None where the tile kernels
    keep the run (:func:`_chain_takes`)."""
    return _chain_plan(step, n, Db, K, C, n_sm) if _chain_takes(step, n, Db, K, C, n_sm) else None


def _whole_chain(n: int, Db: int, K: int, m: int, limit: int, W: int | None = None):
    """(Kc, stage) of the whole-chain stage from level m (a chain of 2^(n -
    m)) over W of the K columns (all by default; a tile stage's chunk),
    within ``limit`` bytes of shared memory: all W at once before chunks,
    its E, F staged before all W in chunks of two or more; None where not
    one column fits. Rows written by the tile stage are read in 16-byte
    units: for m > 0 a chunk is every column, or K and Kc even."""
    W = K if W is None else W
    plain = ReducePlan(0, 1, W, W, False)
    for stage, chunked in ((True, False), (False, False), (True, True), (False, True)):
        fits = lambda kc: (_tree_reduce_smem(n - m, Db, W, plain._replace(Kc=kc, stage=stage))
                           - _TREE_HEADER <= limit)
        if not chunked:
            Kc = W if fits(W) and (not m or W == K or K % 2 == 0) else None
        elif not m or K % 2 == 0:
            Kc = _chunks(W, fits, K % 2 == 0)
        else:
            Kc = None
        if Kc is not None:
            return Kc, stage
    return None


def _lanes_segments(n: int, Db: int, S: int) -> int:
    """The fewest segments from S (a power of two) whose widest level has a
    lane group for each of its positions within ``_LANES_THREADS`` threads
    (csrc/band.cu: cr_backsub_lanes_kernel)."""
    while (S < 1 << n and _chain_backsub_shape(n, Db, S, 1)[2] * _LANE_GROUP[Db]
           > _LANES_THREADS):
        S *= 2
    return S


@functools.lru_cache(maxsize=None)
def _chain_plan(step: str, n: int, Db: int, K: int, C: int = 1, n_sm: int = _SM_COUNT):
    """The plan of a chain kernel for a run of n levels (1 to
    ``_CR_MAX_LEVELS``) that ends at one position a chain, C chains, K
    columns, n_sm SMs ("reduce" or a back-substitution step; every such run
    takes ONE launch).

    Reduce (:class:`ReducePlan`): where the chains alone give every SM a
    thread block (the folds), and for a direction whose chain's E, F and rhs
    fit a thread block, no tile stage: a chain a thread block, its E, F
    staged once and the rhs whole or through a ring of two chunks.
    Otherwise a tile stage of m levels (:func:`_tile_stage`) and the whole
    chain from level m, a thread block a chain and chunk of columns: m
    leaves the whole chain :func:`_chain_tail` positions, within
    ``_STAGE_LEVELS``, the deepest below that where a level does not fit,
    deeper where the whole chain's E, F do not fit with its rows (3D
    1x1000's panel: five levels; the whole chain's E, F read through L1
    from 64 or 128 positions took 39.3 and 52.9 us against 30.7).
    Back substitution (:class:`BacksubPlan`): S, the
    fewest segments a chain (a power of two) that give every second SM a
    thread block; for the directions (K <= ``_LANES_MAX_K``) more where
    the lane groups of a segment's widest level pass ``_LANES_THREADS``;
    for the wider widths, where the chains alone fill the card, more until
    two thread blocks fit an SM (the 2D fold's panel 117.7-118.1 us at S =
    4 against 127.8-128.5 at 2), then more where that takes all K columns
    in one chunk within the card's shared memory (the 3D fold's 117.3 at 8
    against 117.8 at 16; Manhattan-4's 32.3 at 32 against 66.8 at 16 and
    47.2 at 64; NVIDIA H100 80GB HBM3, 700 W, profile_port.py --cr --pass
    --sweep), else the fewest chunks."""
    if not 1 <= n <= _CR_MAX_LEVELS:
        raise ValueError(f"chain CR launch: {n} levels (1 to {_CR_MAX_LEVELS})")
    T, target = 1 << n, _CHAIN_SMEM_TARGET
    if step != "reduce":
        S = 1
        while S < T and 2 * C * S < n_sm:
            S *= 2
        if K <= _LANES_MAX_K[Db]:
            return BacksubPlan(_lanes_segments(n, Db, S), K)
        if C >= n_sm:  # the chains fill the card: two thread blocks an SM
            while S < T and _chain_backsub_shape(n, Db, S, K)[0] > target:
                S *= 2
        # the fewest segments from there that take all K columns at once
        for S_all in (S << i for i in range(n + 1 - num_levels(S))):
            if _chain_backsub_shape(n, Db, S_all, K)[0] <= _SMEM_MAX:
                return BacksubPlan(S_all, K)
        best = None
        for limit in (target, _SMEM_MAX):
            while True:
                Kc = _chunks(K, lambda kc: _chain_backsub_shape(n, Db, S, kc)[0] <= limit, False)
                if Kc is not None and (best is None or -(-K // Kc) < -(-K // best.Kc)):
                    best = BacksubPlan(S, Kc)
                if (best is not None and best.Kc == K) or S == T:
                    break
                S *= 2
            if best is not None:
                return best
        raise ValueError(f"chain CR back substitution: {n} levels of {Db}-blocks do not fit "
                         "a thread block")
    whole = _whole_chain(n, Db, K, 0, _SMEM_MAX)
    if whole is not None and (C >= n_sm or (K < _REGISTER_ROWS_K and whole[1] and whole[0] == K)):
        return ReducePlan(0, 1, K, *whole)
    deepest = _STAGE_LEVELS[(K >= _REGISTER_ROWS_K, Db)]
    mc = min(n - num_levels(_chain_tail(n, Db, K)), n - 1, deepest)
    for m in list(range(mc, 0, -1)) + list(range(max(mc, 0) + 1, n)):
        plan = _tile_stage(n, m, Db, K, C, n_sm)
        if plan is not None:
            return plan
    if whole is None:
        raise ValueError(f"chain CR reduce: {n} levels of {Db}-blocks with {K} rhs columns "
                         "do not fit a thread block")
    return ReducePlan(0, 1, K, *whole)


def _tile_stage(n: int, m: int, Db: int, K: int, C: int, n_sm: int):
    """The tree reduce with a tile stage over levels 1 .. m and the whole
    chain above (:func:`_chain_plan`), or None where either does not fit
    the card or the whole chain's E, F do not fit with its rows. Tiles of
    the most positions that leave a thread block an SM, all K columns
    before a wider tile; the columns in the fewest chunks the card holds
    (even chunks where K is even, one where it is odd: the whole chain's
    thread block of a chunk reads its rows in 16-byte units). Fewer, wider
    chunks measured faster: Manhattan-4's panel 40.0 us at 36 columns
    against 50.4 at 18, robot20's 76.5 at 86 against 88.8 at 44."""
    T = 1 << n
    if _cr_smem_bytes("reduce", m, Db, 1, 1) > _SMEM_MAX:
        return None
    P = 1
    while 2 * P <= T >> m and C * ((T >> m) // (2 * P)) >= n_sm:
        P *= 2
    while True:
        fits = lambda kf: _cr_smem_bytes("reduce", m, Db, P, kf) <= _SMEM_MAX
        Kf = _chunks(K, fits, True) if K % 2 == 0 else (K if fits(K) else None)
        if Kf == K or P == 1:
            break
        P //= 2
    if Kf is None:
        return None
    whole = _whole_chain(n, Db, K, m, _SMEM_MAX, Kf)
    if whole is None or not whole[1]:
        return None
    plan = ReducePlan(m, P, Kf, *whole)
    return plan if _tree_reduce_smem(n, Db, K, plan) <= _SMEM_MAX else None


_TICKETS = {}


def _tickets(t: torch.Tensor, count: int) -> torch.Tensor:
    """The tree reduce's counters on t's device and current stream (at
    least ``count``): zero, and zero again after every launch (the thread
    block that takes a counter's last ticket resets it), so allocated once
    a stream. Under CUDA graph capture a fresh buffer whose zeroing the
    graph replays (never kept)."""
    with torch.cuda.device(t.device):
        if torch.cuda.is_current_stream_capturing():
            return torch.zeros(count, dtype=torch.int32, device=t.device)
        key = (t.device, torch.cuda.current_stream().cuda_stream)
    have = _TICKETS.get(key)
    if have is None or have.numel() < count:
        have = _TICKETS[key] = torch.zeros(max(count, 1024), dtype=torch.int32, device=t.device)
    return have


def _check_cr(name: str, levels, rhs, fields, coarse: bool = False):
    """(C, T, Db, K, n) of a fused CR call; raises on a level list that is
    empty, deeper than ``_CR_MAX_LEVELS`` or whose blocks do not halve the
    chain level by level. ``rhs`` is the finest rhs, or with ``coarse`` the
    coarsest solution."""
    n = len(levels)
    if not 1 <= n <= _CR_MAX_LEVELS:
        raise ValueError(f"{name}: {n} levels (1 to {_CR_MAX_LEVELS} a launch)")
    if rhs.dim() != 4:
        raise ValueError(f"{name}: expected a rhs (C, T, Db, K), got {tuple(rhs.shape)}")
    nC, T, Db, K = rhs.shape
    if coarse:
        T <<= n
    if T % (1 << n):
        raise ValueError(f"{name}: chain length {T} does not halve {n} times")
    for lev, lv in enumerate(levels):
        for f in fields:
            _check(f"{name}.levels[{lev}].{f}", getattr(lv, f), (nC, T >> (lev + 1), Db, Db))
    return nC, T, Db, K, n


def band_cr_reduce(levels, b):
    """Reduce the fine rhs b (C, T, Db, K) through every compacting level of
    a solve (``levels``: :class:`CRLevel` fine -> coarse, level l's E, F
    (C, T >> (l + 1), Db, Db)); returns each level's reduced rhs (C, T >>
    (l + 1), Db, K), the last one the PCR remainder's rhs, the others the
    fine rhs of the back substitution (see :func:`band_cr_reduce_plain`).

    Replaces ``score_tpu/ops/pallas_pcr.py:_cr_reduce_kernel`` with the
    caller's even/odd slices of the rhs (:789-790), and its launch a level
    by ONE launch for all levels: at the default schedule a band-solve
    pass's whole descent on chains of up to 2^``_CR_MAX_LEVELS`` = 1,024
    blocks, at every rhs width. A run that ends at one position a chain
    takes the tree kernel (:func:`_chain_plan`, :class:`ReducePlan`): a
    tile stage over the card (a tile of a few positions of its last level
    with the left halo, levels in shared memory), then the last levels over
    the whole chain, with no halo, by the thread block that takes the last
    of the chain's tickets (``_tickets``, one counter a chain; E, F staged
    once, the columns through a ring of two chunks, each level in place);
    where the chains alone fill the card, a chain a thread block. No
    thread block waits for another. A run that ends at more than one position (a schedule that
    stops above one block, the first run of a longer chain): a thread
    block owns a tile of coarsest positions of one chain and a chunk of
    columns (:func:`_cr_plan`), stages its E, F of every level and its fine
    rows with the left halo of 2^n - 1 rows in shared memory by 16-byte
    cp.async, and computes the levels there, recomputing the halo
    positions of the tile before; each level's own rows leave once. A
    thread owns one output row and column (directions) or several rows of
    a position and column (the panel), chosen by K in csrc/band.cu. What
    bounds it: bytes for a wide 2D panel and the folds (each element of b
    read once from HBM, written once), a launch and the levels' dependent
    chains otherwise (PERF.md §6 has each cell's pass). Sums run in the
    plain version's order; only nvcc's contraction to FMAs differs."""
    nC, T, Db, K, n = _check_cr("band_cr_reduce", levels, b, ("E", "F"))
    _check("band_cr_reduce.b", b)
    if not _route("band_cr_reduce", levels[0].E,
                  *[t for lv in levels for t in (lv.E, lv.F)], b):
        return band_cr_reduce_plain(levels, b)
    out = tuple(b.new_empty((nC, T >> (lev + 1), Db, K)) for lev in range(n))
    if K == 0 or nC == 0:
        return out
    _check_aligned("band_cr_reduce", b, *[t for lv in levels for t in (lv.E, lv.F)])
    from score_tpu_torch.ops.build import CrReduceLevels

    plan = _cr_chain_plan("reduce", n, Db, K, nC, _sm_count(b.device)) if T == 1 << n else None
    if plan is not None:  # the run ends at one position a chain: the tree kernel
        from score_tpu_torch.ops.build import CrReducePlan

        ptrs = CrReduceLevels()
        for lev, lv in enumerate(levels):
            ptrs.E[lev], ptrs.F[lev] = lv.E.data_ptr(), lv.F.data_ptr()
            ptrs.out[lev] = out[lev].data_ptr()
        tickets = _tickets(b, nC * -(-K // plan.Kf)).data_ptr() if plan.top else None
        cplan = CrReducePlan(plan.top, plan.P, plan.Kf, plan.Kc, int(plan.stage))
        _launch(_lib(), "band_cr_reduce_chain", b, ptrs, b.data_ptr(), tickets, n, nC, Db, K,
                cplan)
        _count(band_cr_reduce, Db, (T, n))
        return out
    first, src = 0, b
    for d in _cr_launch_depths("reduce", n, Db, K):
        group, outs = levels[first:first + d], out[first:first + d]
        P, Kc = _cr_plan("reduce", d, (T >> first) >> d, Db, K, nC, _sm_count(b.device))
        ptrs = CrReduceLevels()
        for lev, lv in enumerate(group):
            ptrs.E[lev], ptrs.F[lev] = lv.E.data_ptr(), lv.F.data_ptr()
            ptrs.out[lev] = outs[lev].data_ptr()
        _launch(_lib(), "band_cr_reduce", b, ptrs, src.data_ptr(), d, nC, T >> first, Db, K, P, Kc)
        _count(band_cr_reduce, Db, (T, n))
        first, src = first + d, outs[-1]
    return out


def band_cr_backsub(levels, fine, x):
    """The finest solution (C, T, Db, K) from the coarsest level's solution
    x (C, T >> n, Db, K) through every compacting level of a solve
    (``levels``: :class:`CRLevel` fine -> coarse, the odd rows' invD, A, C);
    ``fine[l]`` is level l's fine rhs (C, T >> l, Db, K): the solve's rhs,
    then :func:`band_cr_reduce`'s outputs (see
    :func:`band_cr_backsub_plain`).

    Replaces ``score_tpu/ops/pallas_pcr.py:_cr_backsub_kernel`` with the
    caller's re-interleaving of even and odd rows (:809-810), and its launch
    a level by ONE launch for all levels: at the default schedule a
    band-solve pass's whole ascent on chains of up to 1,024 blocks, at every
    rhs width. A run that ends at one position a chain takes the chain
    kernel (:func:`_chain_plan`, :class:`BacksubPlan`): a thread block a
    segment of the chain's fine rows, recomputing the one or two positions
    of each coarse level its segment needs (no ticket, no wait). For K <=
    4 a lane group a position of the segment's widest level (lane r a row,
    the narrow step's layout), its rows of each level's A, C, invD and b
    read from L2 into registers a level ahead, x_l through two shared
    buffers, one barrier a level. For the panels the levels' invD, A, C and
    odd rows of b stream through a ring of three level slots by cp.async (a
    group a level, coarsest first, two levels ahead of the level computed:
    the shared memory of the widest levels, not their sum), the columns in
    chunks, a thread all Db rows (Db = 6) or three (Db = 12) of a column.
    Runs that end
    at more than one position: a thread block owns a tile of coarsest
    positions and a chunk of columns, reads the coarsest solution of its
    tile and of the position after it, and fills each finer level's odd
    rows in one shared buffer in the finest layout; only the finest x
    leaves. Steps (:func:`_backsub_step`): a lane group per position for K
    <= 4 (lane r a row, rows of x and of the intermediate by shuffles); for
    the panel at Db = 6 a thread per position and column pair, block rows
    as broadcasts (both the layouts of the per-level kernels before, block
    rows and b from HBM); at Db = 12 a thread per three rows of a column,
    the levels' A, C, invD and odd rows of b staged in shared memory by
    cp.async, one block barrier between (b - A x) - C x and the invD
    product. A run of one level at K <= 4 or Db = 6 runs the per-level
    kernels' steps unchanged; a run deeper than the shared memory holds in
    one launch (:func:`_cr_launch_depths`) takes one launch a run of
    levels. What bounds it: bytes for the 2D panel and the folds, a launch
    and the levels' dependent chains otherwise. Sums run in the plain
    version's order; only nvcc's contraction to FMAs differs."""
    nC, T, Db, K, n = _check_cr("band_cr_backsub", levels, x, ("invD", "A", "C"), coarse=True)
    if len(fine) != n:
        raise ValueError(f"band_cr_backsub: {len(fine)} fine rhs for {n} levels")
    for lev, b in enumerate(fine):
        _check(f"band_cr_backsub.fine[{lev}]", b, (nC, T >> lev, Db, K))
    _check("band_cr_backsub.x", x)
    blocks = [t for lv in levels for t in (lv.invD, lv.A, lv.C)]
    if not _route("band_cr_backsub", levels[0].invD, *blocks, *fine, x):
        return band_cr_backsub_plain(levels, fine, x)
    if K == 0 or nC == 0:
        return torch.empty_like(fine[0])
    _check_aligned("band_cr_backsub", x, *fine, *blocks)
    from score_tpu_torch.ops.build import CrBacksubLevels

    plan = _cr_chain_plan("backsub", n, Db, K, nC, _sm_count(x.device)) if T == 1 << n else None
    if plan is not None:  # the run ends at one position a chain: the chain kernel
        ptrs = CrBacksubLevels()
        for lev, lv in enumerate(levels):
            ptrs.invD[lev], ptrs.A[lev], ptrs.C[lev] = (
                lv.invD.data_ptr(), lv.A.data_ptr(), lv.C.data_ptr())
            ptrs.b[lev] = fine[lev].data_ptr()
        out = torch.empty_like(fine[0])
        _launch(_lib(), "band_cr_backsub_chain", x, ptrs, x.data_ptr(), out.data_ptr(), n, nC,
                Db, K, plan.S, plan.Kc)
        _count(band_cr_backsub, Db, (T, n))
        return out
    step = _backsub_step(Db, K)
    depths = _cr_launch_depths(step, n, Db, K)
    last = n
    for d in reversed(depths):
        first = last - d
        out = torch.empty_like(fine[first])
        P, Kc = _cr_plan(step, d, (T >> first) >> d, Db, K, nC, _sm_count(x.device))
        ptrs = CrBacksubLevels()
        for lev in range(d):
            lv = levels[first + lev]
            ptrs.invD[lev], ptrs.A[lev], ptrs.C[lev] = (
                lv.invD.data_ptr(), lv.A.data_ptr(), lv.C.data_ptr())
            ptrs.b[lev] = fine[first + lev].data_ptr()
        _launch(_lib(), "band_cr_backsub", x, ptrs, x.data_ptr(), out.data_ptr(), d, nC, T >> first,
                Db, K, P, Kc)
        _count(band_cr_backsub, Db, (T, n))
        last, x = first, out
    return x


KERNELS = (band_init_a, band_pcr_level, band_block_inv, band_pcr_solve,
           band_cr_level, band_cr_factor, band_cr_reduce, band_cr_backsub)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.launches_by_size = dict.fromkeys(CUDA_BLOCK_SIZES, 0)
        k.launches_by_run = collections.Counter()


reset_launch_counts()


# ------------------------------------------------------------------ #
# Factor / solve
# ------------------------------------------------------------------ #


def band_factor(D: torch.Tensor, U: torch.Tensor,
                n_cr: int | None = None) -> BandFactors:
    """Factor C independent block-tridiagonal SPD systems (JAX band
    convention, see module docstring): ``n_cr`` compacting levels
    (default :func:`cr_depth`), then PCR on the remainder.

    At Db = 6 the compacting levels run in :func:`band_cr_factor`
    launches, a launch a run of :func:`_factor_runs` (one or two on the
    cells); where they end at one block a chain (the default) the last run
    inverts it and no ``band_block_inv`` runs, else ``band_block_inv``
    opens the PCR levels. At Db = 12 (:func:`_factor_takes`) a
    :func:`band_cr_level` launch a level, then ``band_block_inv``.
    :func:`factor_launches` counts a factor's launches."""
    nC, Tp, Db, _ = D.shape
    if Tp != pad_length(Tp):
        raise ValueError(f"band_factor: chain length {Tp} is not a power of two")
    if n_cr is None:
        n_cr = cr_depth(Tp)
    if not 0 <= n_cr <= num_levels(Tp):
        raise ValueError(f"band_factor: {n_cr} compacting levels for chain length {Tp} "
                         f"(at most log2 of it, {num_levels(Tp)})")
    D0 = D
    A = band_init_a(U)
    Cc = U
    levels, invD, T = [], None, Tp
    if _factor_takes(Db):  # a band_cr_factor launch a run
        for n in _factor_runs(Tp, Db, n_cr):
            run = band_cr_factor(D, A, Cc, n, last=T >> n == 1)
            levels += run.levels
            T >>= n
            if run.invD is not None:
                invD = run.invD
            else:
                D, A, Cc = run.D, run.A, run.C
    else:  # a band_cr_level launch a level
        for _ in range(n_cr):
            E, F, invDo, Ao, Co, D, A, Cc = band_cr_level(D, A, Cc)
            levels.append(CRLevel(E=E, F=F, invD=invDo, A=Ao, C=Co))
    Tb = Tp >> n_cr
    Es, Fs = [], []
    if invD is None:
        invD = band_block_inv(D)
    for lev in range(num_levels(Tb)):
        E, F, D, A, Cc, invD = band_pcr_level(D, A, Cc, invD, 1 << lev)
        Es.append(E)
        Fs.append(F)
    if Es:
        E, F = torch.stack(Es), torch.stack(Fs)
    else:
        E = F = D.new_zeros((0, nC, Tb, Db, Db))
    return BandFactors(levels=tuple(levels), E=E, F=F, invD=invD, D=D0, U=U)


def factor_launches(Tp: int, Db: int, n_cr: int | None = None) -> int:
    """Kernel launches of :func:`band_factor` on chains of Tp with n_cr
    compacting levels (default :func:`cr_depth`) at block size Db,
    ``band_init_a`` aside: a ``band_cr_factor`` launch a run
    (:func:`_factor_runs`; a ``band_cr_level`` launch a level where
    :func:`_factor_takes` keeps them), one ``band_block_inv`` where the
    levels stop above one block a chain (or there are none, or they ran
    one a launch), and a ``band_pcr_level`` launch a PCR level."""
    n_cr = cr_depth(Tp) if n_cr is None else n_cr
    Tb = Tp >> n_cr
    if not _factor_takes(Db):
        return n_cr + 1 + num_levels(Tb)
    runs = _factor_runs(Tp, Db, n_cr)
    return len(runs) + (Tb > 1 or not runs) + num_levels(Tb)


def band_matvec(D: torch.Tensor, U: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """T x for the band (D, U) (module convention) and x (C, Tp, Db, K)."""
    Tx = D @ x
    Tx[:, 1:] += U[:, :-1].transpose(-1, -2) @ x[:, :-1]
    Tx[:, :-1] += U[:, :-1] @ x[:, 1:]
    return Tx


def band_solve(factors: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the factored systems for rhs (C, Tp, Db, K): reduce through
    the CR levels, PCR-solve the remainder, back-substitute upwards; then
    :func:`refine_steps` steps of iterative refinement (3D blocks), each
    solving for the residual of the band product."""
    b = rhs.contiguous()
    x = _band_solve_once(factors, b)
    for _ in range(refine_steps(b.shape[-2])):
        x = x + _band_solve_once(factors, b - band_matvec(factors.D, factors.U, x))
    return x


def _cr_runs(n: int) -> list:
    """The levels of each call of the fused CR wrappers in a solve of n
    compacting levels, fine -> coarse: all n in one call up to
    ``_CR_MAX_LEVELS`` (a launch's depth: chains of up to 1,024 blocks, a
    band-solve pass in one launch each way), else the fewest runs of at
    most that many, as even as they come (11 levels: 6 and 5)."""
    runs = -(-n // _CR_MAX_LEVELS)
    return [n // runs + (r < n % runs) for r in range(runs)]


def cr_solve_launches(n: int, Db: int, K: int, Tn: int = 1, C: int = 1,
                      n_sm: int = _SM_COUNT) -> tuple:
    """(band_cr_reduce, band_cr_backsub) launches of one pass of a band
    solve of C chains through n compacting levels at rhs width K down to a
    remainder of Tn positions a chain: the runs of :func:`_cr_runs`, each
    in the launches of :func:`_cr_launch_depths`, but a last run that ends
    at one position a chain (Tn = 1, the default schedule) in one launch
    where a chain kernel takes it (:func:`_cr_chain_plan`). A 3D band solve
    makes :func:`refine_steps` more passes."""
    runs = _cr_runs(n) if n else []
    out = []
    for step in ("reduce", _backsub_step(Db, K)):
        chain = Tn == 1 and runs and _cr_chain_plan(
            "reduce" if step == "reduce" else "backsub", runs[-1], Db, K, C, n_sm) is not None
        tiles = runs[:-1] if chain else runs
        out.append(int(chain) + sum(len(_cr_launch_depths(step, d, Db, K)) for d in tiles))
    return tuple(out)


def _band_solve_once(factors: BandFactors, b: torch.Tensor) -> torch.Tensor:
    levels = factors.levels
    if not levels:
        return band_pcr_solve(factors.E, factors.F, factors.invD, b)
    runs = _cr_runs(len(levels))
    fine, first = (b,), 0  # each level's fine rhs, then the remainder's
    for d in runs:
        fine += band_cr_reduce(levels[first:first + d], fine[-1])
        first += d
    x = band_pcr_solve(factors.E, factors.F, factors.invD, fine[-1])
    for d in reversed(runs):
        first -= d
        x = band_cr_backsub(levels[first:first + d], fine[first:first + d], x)
    return x
