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
finishes the remainder.

Public convention (the JAX package's band convention): ``D``, ``U`` are
(C, Tp, Db, Db) with Tp a power of two, identity diagonal blocks and zero
couplings in the padding, ``U[:, i]`` coupling i -> i+1 and
``U[:, Tp-1] = 0``; right-hand sides are (C, Tp, Db, K). Factors keep a
layout natural for the GPU: each CR level's blocks as (C, Th, Db, Db) at
its coarse length Th, the PCR remainder's E, F as (L, C, Tb, Db, Db) and
invD as (C, Tb, Db, Db), all contiguous f64.

Seven kernels, written by hand in CUDA C++ (``csrc/band.cu``, built for
sm_90a by :mod:`score_tpu_torch.ops.build`), do the work on the card. Each
has a plain PyTorch twin here (``*_plain``) computing the same function.
A wrapper runs the plain twin only for tensors on the CPU; for a CUDA
tensor it launches its kernel or raises. Each wrapper counts its launches
in its ``launches`` attribute.

Mapping of the TPU kernels (``score_tpu/ops/pallas_pcr.py``):

    _init_A_kernel          :428  -> band_init_a
    _factor_level_kernel    :312  -> band_pcr_level
    _factor_level2_kernel   :338  -> band_pcr_level, launched twice
                                     (two levels per launch only saved
                                     TPU launch overhead); invD is
                                     carried from level to level
    _block_inv_kernel       :423  -> band_block_inv
    _solve_kernel           :433  -> band_pcr_solve
    _cr_level_kernel        :362  -> band_cr_level (also does the TPU
                                     caller's even/odd lane slicing)
    _cr_reduce_kernel       :385  -> band_cr_reduce
    _cr_backsub_kernel      :405  -> band_cr_backsub (also interleaves
                                     the odd rows back, as the TPU caller
                                     does between launches)
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

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
    "band_cr_reduce",
    "band_cr_backsub",
    "band_factor",
    "band_solve",
    "KERNELS",
    "reset_launch_counts",
]

# Block sizes the CUDA kernels are instantiated for (2D pose blocks).
CUDA_BLOCK_SIZES = (6,)
# Dynamic shared memory a thread block may use on sm_90 (227 KB).
_SMEM_MAX = 232448
# band_pcr_solve: the wide kernel (a thread holds all Db rows by
# _WIDE_COLUMNS rhs columns of a position in registers; at most
# _WIDE_MAX_LENGTH threads, 1 to _WIDE_MAX_GROUPS per position) serves
# chains up to _WIDE_MAX_LENGTH; the narrow kernel (one thread per position
# and row, 1, 2 or 4 columns) holds _NARROW_ACCUMULATORS outputs per thread
# in at most _NARROW_THREADS threads. The same constants stand in
# csrc/band.cu.
_WIDE_COLUMNS = 8
_WIDE_MAX_LENGTH = 256
_WIDE_MAX_GROUPS = 8
_WIDE_RING = 3  # half-block tiles of E, F in flight or in use
_SM_COUNT = 132  # H100 SXM; the wrapper asks the device
_NARROW_THREADS = 512
_NARROW_ACCUMULATORS = 24
# band_cr_backsub: the narrow kernel (a lane group per position) takes up
# to this many rhs columns, the wide one (a thread per column) the rest.
# The same constant stands in csrc/band.cu.
_BACKSUB_NARROW_MAX_K = 4
# CR compacts while the chain is longer than this; PCR factors the rest.
# Chosen from depth sweeps on an H100 (profile_port.py; PERF.md has them).
CR_BASE_LENGTH = 256


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


class BandFactors(NamedTuple):
    levels: tuple  # of CRLevel, fine -> coarse
    E: torch.Tensor  # (L, C, Tb, Db, Db) PCR elimination blocks of the remainder
    F: torch.Tensor  # (L, C, Tb, Db, Db)
    invD: torch.Tensor  # (C, Tb, Db, Db) inverses of the decoupled system


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


def cr_depth(Tp: int) -> int:
    """Compacting levels for chains of length Tp: halve while the chain
    is longer than ``CR_BASE_LENGTH``."""
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


def band_cr_reduce_plain(E, F, b):
    """Reduce the fine rhs b (C, T, Db, K) onto the kept rows:
    b[2j] + (E_j b[2j-1] + F_j b[2j+1]), shape (C, T/2, Db, K)."""
    bod = b[:, 1::2]
    return b[:, 0::2] + (E @ _shift_down(bod, 1) + F @ bod)


def band_cr_backsub_plain(invD, A, C, b, xe):
    """Fine solution (C, T, Db, K) from the kept rows' solution xe
    (C, T/2, Db, K): x[2j] = xe[j] and
    x[2j+1] = invD_j ((b[2j+1] - A_j xe[j]) - C_j xe[j+1])."""
    xo = invD @ ((b[:, 1::2] - A @ xe) - C @ _shift_up(xe, 1))
    return torch.stack([xe, xo], dim=2).reshape(b.shape)


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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        msg = _lib().band_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")


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
    err = _lib().band_init_a(U.data_ptr(), A.data_ptr(), C, Tp, Db, _stream())
    _raise_on("band_init_a", err)
    band_init_a.launches += 1
    return A


def band_block_inv(D: torch.Tensor) -> torch.Tensor:
    """Inverse of every SPD block of D (C, Tp, Db, Db).

    Replaces ``score_tpu/ops/pallas_pcr.py:_block_inv_kernel`` (body
    ``_block_inv``). Bound on the card by f64 arithmetic latency per
    thread (Cholesky plus 2 Db triangular solves, ~Db^3 dependent
    operations); one thread per block with the block in registers and
    local memory, so there is no cross-thread traffic at all and every
    block of every chain is independent."""
    _check("band_block_inv", D)
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"band_block_inv: expected (C, Tp, Db, Db), got {tuple(D.shape)}")
    if not _route("band_block_inv", D):
        return band_block_inv_plain(D)
    C, Tp, Db, _ = D.shape
    out = torch.empty_like(D)
    err = _lib().band_block_inv(D.data_ptr(), out.data_ptr(), C * Tp, Db, _stream())
    _raise_on("band_block_inv", err)
    band_block_inv.launches += 1
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
    dependent f64 chain of six 6x6 products, a Cholesky and two
    substitutions. The design keeps that chain short and the accesses
    wide: a group of 8 lanes owns a position and lanes 0..5 each hold one
    row of every block in registers (C*Tp*8 threads in flight, 8192 at
    Manhattan-4's remainder; no local-memory arrays, no spill); the nine
    input blocks of a position are staged in shared memory by 16-byte
    cp.async copies on neighbouring addresses, the six outputs leave by
    16-byte stores; products read the other block's rows as shared-memory
    broadcasts; the Cholesky of D' runs across the group by shuffles, and
    lane c then solves column c of the inverse. Each block is inverted
    once per level (the level before this design inverted both neighbours
    of every position, twice the work). The sums run in the plain
    version's order; only nvcc's contraction to FMAs differs."""
    for name, t in (("D", D), ("A", A), ("C", C), ("invD", invD)):
        _check(f"band_pcr_level.{name}", t, D.shape)
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"band_pcr_level: expected (C, Tp, Db, Db), got {tuple(D.shape)}")
    if not _route("band_pcr_level", D, A, C, invD):
        return band_pcr_level_plain(D, A, C, invD, s)
    nC, Tp, Db, _ = D.shape
    outs = [torch.empty_like(D) for _ in range(6)]
    _check_aligned("band_pcr_level", D, A, C, invD)
    err = _lib().band_pcr_level(
        D.data_ptr(), A.data_ptr(), C.data_ptr(), invD.data_ptr(),
        *[o.data_ptr() for o in outs], nC, Tp, Db, int(s), _stream(),
    )
    _raise_on("band_pcr_level", err)
    band_pcr_level.launches += 1
    return tuple(outs)


def _solve_tile_columns(Tp: int, Db: int, K: int) -> int:
    """Columns of the register tile of band_pcr_solve, which names the
    kernel: ``_WIDE_COLUMNS`` is the wide kernel, 1, 2 or 4 the narrow
    one. The rule is on the shape alone: the wide kernel takes chains up
    to ``_WIDE_MAX_LENGTH`` blocks with more than 4 rhs columns; the narrow
    kernel takes the rest with the widest tile that K fills and that its
    threads' accumulators and the shared memory hold. Raises when not
    even one column fits."""
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
    """rhs columns that one band_pcr_solve block holds for C chains on a
    card of n_sm SMs: its threads' tiles (:func:`_solve_tile_columns`,
    times :func:`_solve_groups` for the wide kernel), or all K where K is
    less."""
    ct = _solve_tile_columns(Tp, Db, K)
    if ct == _WIDE_COLUMNS:
        ct *= _solve_groups(Tp, Db, K, C, n_sm)
    return min(K, ct)


def band_pcr_solve(E, F, invD, b):
    """Solve through stored factors for b (C, Tp, Db, K); returns x of
    the same shape.

    Replaces ``score_tpu/ops/pallas_pcr.py:_solve_kernel``. All levels
    run in ONE launch: one thread block per (chain, chunk of rhs columns)
    keeps its rhs slice in shared memory in a single buffer updated in
    place (a thread holds a level's outputs in registers across the
    barrier that ends the level's reads), which replaces the TPU's VMEM
    chunking over chains and columns by a launch grid.

    What bounds it on the card (measured, PERF.md): the reads of E and F,
    which every block of a chain repeats from L2, for the panel (K =
    arrow width) together with its products' shared-memory reads; a
    direction (K = 1) runs one block per chain, whose SM pulls each
    level's 147 KB (Tp = 256) in ~1.2 us. The design: for the panel a thread owns a position and a
    register tile of all Db rows by 8 columns, so an element of E, F is
    read once for 8 columns and an element of b once for 6 rows, where
    the kernel before it loaded one element per multiply-add. A level's
    E and F pass through shared memory as four tiles of half blocks in a
    ring of three, filled by 16-byte cp.async copies on neighbouring
    addresses while the tile before is used. One in-place buffer and the
    card's 227 KB leave room for 8 columns at Manhattan-4's remainder
    (4 fitted two buffers) and, with two threads per position sharing
    the staged E, F, 16 at robot20's: the re-reads of E, F fall by those
    factors. For K <= 4 the narrow kernel spreads the Db rows of a
    position over neighbouring lanes, whose loads of E, F rows are
    contiguous across the warp, all of a level's loads in flight at
    once. The shared-memory attribute is set once per kernel. The
    sums of a level run over E's terms then F's in one accumulator, an
    order that differs from the plain version's (E b + F b)."""
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
    ct = _solve_tile_columns(Tp, Db, K)
    groups = 1
    if ct == _WIDE_COLUMNS:
        groups = _solve_groups(Tp, Db, K, nC, _sm_count(b.device))
    _check_aligned("band_pcr_solve", E, F, invD)
    err = _lib().band_pcr_solve(
        E.data_ptr(), F.data_ptr(), invD.data_ptr(), b.data_ptr(), x.data_ptr(),
        nC, Tp, Db, L, K, ct, groups, _stream(),
    )
    _raise_on("band_pcr_solve", err)
    band_pcr_solve.launches += 1
    return x


def _check_fine_band(name, D, A, C):
    for n, t in (("D", D), ("A", A), ("C", C)):
        _check(f"{name}.{n}", t, D.shape)
    if D.dim() != 4 or D.shape[-1] != D.shape[-2] or D.shape[1] % 2:
        raise ValueError(f"{name}: expected (C, T, Db, Db) with T even, got {tuple(D.shape)}")


def band_cr_level(D, A, C):
    """One compacting CR level over all chains: from the fine band
    (C, T, Db, Db) returns (E, F, invD_odd, A_odd, C_odd, D', A', C'),
    each (C, T/2, Db, Db) (see :func:`band_cr_level_plain`).

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
    row-times-block products. The design is ``band_pcr_level``'s: a group
    of 8 lanes per coarse position, lanes 0..5 one row of every block
    each, inputs staged in shared memory by 16-byte cp.async, products
    against shared-memory broadcasts, outputs by 16-byte stores, and the
    group inversion (Cholesky by shuffles, lane c solves column c) is the
    device function that ``band_pcr_level`` calls. Every group inverts
    the ONE odd block 2j + 1 it owns and leaves it in shared memory; after
    a block barrier F_j takes it and E_{j+1} of the next group takes it
    too, so an odd block is inverted once where a thread of the kernel
    before this design inverted both its neighbours one after the other.
    A thread block is 15 positions and one more group that inverts the
    odd block before the first position (1 inversion in 16 is repeated;
    all 16 run side by side). Sums run in the plain version's order;
    only nvcc's contraction to FMAs differs."""
    _check_fine_band("band_cr_level", D, A, C)
    if not _route("band_cr_level", D, A, C):
        return band_cr_level_plain(D, A, C)
    nC, T, Db, _ = D.shape
    outs = [D.new_empty((nC, T // 2, Db, Db)) for _ in range(8)]
    _check_aligned("band_cr_level", D, A, C)
    err = _lib().band_cr_level(
        D.data_ptr(), A.data_ptr(), C.data_ptr(), *[o.data_ptr() for o in outs],
        nC, T // 2, Db, _stream(),
    )
    _raise_on("band_cr_level", err)
    band_cr_level.launches += 1
    return tuple(outs)


def band_cr_reduce(E, F, b):
    """Reduce the fine rhs b (C, T, Db, K) onto the kept rows through a
    CR level's (E, F) (C, T/2, Db, Db); returns (C, T/2, Db, K).

    Replaces ``score_tpu/ops/pallas_pcr.py:_cr_reduce_kernel`` with the
    caller's even/odd slices of the rhs (:789-790). One thread per output
    element, consecutive threads along the rhs columns: the reads of b and
    the writes are contiguous, and E, F rows are shared by a warp. Bound
    by memory traffic for a wide panel (each b element is read about
    three times, from L1/L2) and by launch latency for one column."""
    if E.dim() != 4 or b.dim() != 4:
        raise ValueError("band_cr_reduce: expected E, F (C, T/2, Db, Db), b (C, T, Db, K)")
    nC, T, Db, K = b.shape
    _check("band_cr_reduce.E", E, (nC, T // 2, Db, Db))
    _check("band_cr_reduce.F", F, (nC, T // 2, Db, Db))
    _check("band_cr_reduce.b", b)
    if T % 2:
        raise ValueError(f"band_cr_reduce: chain length {T} is odd")
    if not _route("band_cr_reduce", E, F, b):
        return band_cr_reduce_plain(E, F, b)
    out = b.new_empty((nC, T // 2, Db, K))
    err = _lib().band_cr_reduce(E.data_ptr(), F.data_ptr(), b.data_ptr(),
                                out.data_ptr(), nC, T // 2, Db, K, _stream())
    _raise_on("band_cr_reduce", err)
    band_cr_reduce.launches += 1
    return out


def _backsub_narrow(K: int) -> bool:
    """True for band_cr_backsub's narrow kernel, False for the wide one:
    the rule is on the rhs width alone. Directions (K = 1) and any K up
    to ``_BACKSUB_NARROW_MAX_K`` spread a position's rows over a lane
    group; the arrow panel (K = arrow width) gives each thread columns."""
    return K <= _BACKSUB_NARROW_MAX_K


def band_cr_backsub(invD, A, C, b, xe):
    """Fine solution x (C, T, Db, K) of one CR level from the kept rows'
    solution xe (C, T/2, Db, K), the fine rhs b before this level's
    reduction, and the level's odd-row blocks (invD, A, C)
    (see :func:`band_cr_backsub_plain`).

    Replaces ``score_tpu/ops/pallas_pcr.py:_cr_backsub_kernel`` together
    with the caller's re-interleaving of even and odd rows (:809-810): the
    work of coarse position (c, j) writes both fine rows 2j and 2j+1.

    What bounds it on the card: bytes (the panel's rhs in and out, 28 MB
    at Manhattan-4, 8.4 us of HBM time); a direction (K = 1, 1.1 MB) is
    bound by a launch and one round trip to memory. Two kernels, chosen by
    :func:`_backsub_narrow`: for K <= 4 a group of 8 lanes owns a position
    and lane r one row, loads its rows of A, C, invD (16-byte loads,
    coalesced across the group), b and xe before the first product, and
    gathers the other rows of xe and of the intermediate by width-8
    shuffles (8 threads per position in blocks of 64, where a thread per
    position and column left 1024 threads on 4 SMs); for the panel a
    thread owns one or two neighbouring columns of a position (double2
    where K is even and the rhs is 16-byte aligned), the block rows are
    broadcasts across a warp and the rhs rows coalesce along the columns.
    Sums run in the plain version's order; only nvcc's contraction to FMAs
    differs."""
    if invD.dim() != 4 or b.dim() != 4 or xe.dim() != 4:
        raise ValueError("band_cr_backsub: expected invD, A, C (C, T/2, Db, Db), "
                         "b (C, T, Db, K), xe (C, T/2, Db, K)")
    nC, T, Db, K = b.shape
    for name, t in (("invD", invD), ("A", A), ("C", C)):
        _check(f"band_cr_backsub.{name}", t, (nC, T // 2, Db, Db))
    _check("band_cr_backsub.b", b)
    _check("band_cr_backsub.xe", xe, (nC, T // 2, Db, K))
    if T % 2:
        raise ValueError(f"band_cr_backsub: chain length {T} is odd")
    if not _route("band_cr_backsub", invD, A, C, b, xe):
        return band_cr_backsub_plain(invD, A, C, b, xe)
    x = torch.empty_like(b)
    _check_aligned("band_cr_backsub", invD, A, C)
    err = _lib().band_cr_backsub(
        invD.data_ptr(), A.data_ptr(), C.data_ptr(), b.data_ptr(), xe.data_ptr(),
        x.data_ptr(), nC, T // 2, Db, K, int(_backsub_narrow(K)), _stream(),
    )
    _raise_on("band_cr_backsub", err)
    band_cr_backsub.launches += 1
    return x


KERNELS = (band_init_a, band_pcr_level, band_block_inv, band_pcr_solve,
           band_cr_level, band_cr_reduce, band_cr_backsub)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


reset_launch_counts()


# ------------------------------------------------------------------ #
# Factor / solve
# ------------------------------------------------------------------ #


def band_factor(D: torch.Tensor, U: torch.Tensor,
                n_cr: int | None = None) -> BandFactors:
    """Factor C independent block-tridiagonal SPD systems (JAX band
    convention, see module docstring): ``n_cr`` compacting levels
    (default :func:`cr_depth`), then PCR on the remainder."""
    nC, Tp, Db, _ = D.shape
    if Tp != pad_length(Tp):
        raise ValueError(f"band_factor: chain length {Tp} is not a power of two")
    if n_cr is None:
        n_cr = cr_depth(Tp)
    if not 0 <= n_cr <= num_levels(Tp):
        raise ValueError(f"band_factor: {n_cr} compacting levels for chain length {Tp}")
    A = band_init_a(U)
    Cc = U
    levels = []
    for _ in range(n_cr):
        E, F, invD, Ao, Co, D, A, Cc = band_cr_level(D, A, Cc)
        levels.append(CRLevel(E=E, F=F, invD=invD, A=Ao, C=Co))
    Tb = Tp >> n_cr
    Es, Fs = [], []
    invD = band_block_inv(D)
    for lev in range(num_levels(Tb)):
        E, F, D, A, Cc, invD = band_pcr_level(D, A, Cc, invD, 1 << lev)
        Es.append(E)
        Fs.append(F)
    if Es:
        E, F = torch.stack(Es), torch.stack(Fs)
    else:
        E = F = D.new_zeros((0, nC, Tb, Db, Db))
    return BandFactors(levels=tuple(levels), E=E, F=F, invD=invD)


def band_solve(factors: BandFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Solve the factored systems for rhs (C, Tp, Db, K): reduce through
    the CR levels, PCR-solve the remainder, back-substitute upwards."""
    b = rhs.contiguous()
    fine = []
    for lv in factors.levels:
        fine.append(b)
        b = band_cr_reduce(lv.E, lv.F, b)
    x = band_pcr_solve(factors.E, factors.F, factors.invD, b)
    for lv, bf in zip(reversed(factors.levels), reversed(fine)):
        x = band_cr_backsub(lv.invD, lv.A, lv.C, bf, x)
    return x
