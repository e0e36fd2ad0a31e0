"""Batched small-block Cholesky and triangular substitutions in float32.

Port of :mod:`score_tpu.ops.pallas_blocks`. The f32 band (cyclic reduction,
:mod:`score_tpu_torch.solver.pcr`) and the QCQP range elimination spend
their block work on thousands of tiny (D = 6, or D = 2) Cholesky
factorizations and triangular solves per level. Two kernels, written by
hand in CUDA C++ (``csrc/blocks.cu``, built for sm_90a by
:mod:`score_tpu_torch.ops.build`), do that work on the card:

    _chol_kernel       pallas_blocks.py:36  -> block_chol
    _tri_solve_kernel  pallas_blocks.py:79  -> block_chol_solve, the
                                               forward substitution fused
                                               with the back substitution
                                               that follows it in every
                                               caller (L L^T X = B in one
                                               launch), and
                                               block_tri_lower_solve, the
                                               same kernel without the
                                               back substitution

The TPU kernels put the batch on the 128 lanes, (D, D, M); here blocks
keep the port's (M, D, D) row-major layout. Each kernel has a plain
PyTorch twin here (``*_plain``) with the same order of operations: the
unrolled routines that :mod:`score_tpu_torch.solver.smallblocks` runs off
the card. A wrapper runs the plain twin only for tensors on the CPU;
for a CUDA tensor it launches its kernel or raises. Each wrapper counts
its launches in its ``launches`` attribute, and per block size D in
``launches_by_size``.
"""

from __future__ import annotations

import torch

__all__ = [
    "CUDA_BLOCK_SIZES",
    "block_chol",
    "block_chol_plain",
    "block_tri_lower_solve",
    "block_tri_lower_solve_plain",
    "block_tri_upper_solve_plain",
    "block_chol_solve",
    "block_chol_solve_plain",
    "KERNELS",
    "reset_launch_counts",
]

# Block sizes the CUDA kernels are instantiated for: 2D pose blocks and
# the 2D QCQP distance pivots. The 3D sizes (3, 12) come with 3D.
CUDA_BLOCK_SIZES = (2, 6)


# ------------------------------------------------------------------ #
# Plain PyTorch versions (any float dtype, any leading batch shape)
# ------------------------------------------------------------------ #


def block_chol_plain(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of (..., m, m) SPD matrices, unrolled over the static m
    (left-looking column algorithm; every step is a batched vector op).
    The strictly-upper triangle is zero; a non-positive pivot gives NaN."""
    m = A.shape[-1]
    cols = []
    for j in range(m):
        c = A[..., :, j]
        for k in range(j):
            c = c - cols[k] * cols[k][..., j : j + 1]
        col = c / torch.sqrt(c[..., j : j + 1])
        # zero the strictly-upper part of this column
        col = col * (torch.arange(m, device=A.device) >= j).to(A.dtype)
        cols.append(col)
    return torch.stack(cols, dim=-1)


def block_tri_lower_solve_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L Y = B with L (..., m, m) lower-triangular and B (..., m, K)
    by forward substitution, row by row, dividing by the diagonal."""
    m = L.shape[-1]
    rows = []
    for i in range(m):
        r = B[..., i, :]
        for k in range(i):
            r = r - L[..., i, k : k + 1] * rows[k]
        rows.append(r / L[..., i, i : i + 1])
    return torch.stack(rows, dim=-2)


def block_tri_upper_solve_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L^T X = B (L lower-triangular) by back substitution, from
    the last row up, dividing by the diagonal."""
    m = L.shape[-1]
    rows = [None] * m
    for i in reversed(range(m)):
        r = B[..., i, :]
        for k in range(i + 1, m):
            r = r - L[..., k, i : i + 1] * rows[k]
        rows[i] = r / L[..., i, i : i + 1]
    return torch.stack(rows, dim=-2)


def block_chol_solve_plain(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L L^T X = B for the Cholesky factor L (..., m, m) and B
    (..., m, K): forward, then back substitution."""
    return block_tri_upper_solve_plain(L, block_tri_lower_solve_plain(L, B))


# ------------------------------------------------------------------ #
# Kernel wrappers
# ------------------------------------------------------------------ #


def _lib():
    from score_tpu_torch.ops.build import blocks_library

    return blocks_library()


def _check(name: str, t: torch.Tensor, shape, contiguous: bool = True) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _route(name: str, D: int, *ts) -> bool:
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
    if D not in CUDA_BLOCK_SIZES:
        raise ValueError(
            f"{name}: CUDA kernels are built for block sizes {CUDA_BLOCK_SIZES}, got {D}"
        )
    return True


def _raise_on(name: str, err: int) -> None:
    if err != 0:
        msg = _lib().blocks_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA launch failed: error {err} ({msg})")


def block_chol(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factors L (M, D, D) of M SPD blocks A (M, D, D), float32,
    with the strictly-upper triangle zero.

    Replaces ``score_tpu/ops/pallas_blocks.py:_chol_kernel``. One thread
    per block with the block's lower triangle in registers, left-looking
    column order. At the f32 path's sizes (M ~ 10^3 blocks, at most
    0.3 MB in and out) an H100's launch latency bounds it, not memory or
    arithmetic."""
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"block_chol: expected (M, D, D), got {tuple(A.shape)}")
    M, D, _ = A.shape
    _check("block_chol", A, (M, D, D))
    if not _route("block_chol", D, A):
        return block_chol_plain(A)
    L = torch.empty_like(A)
    if M == 0:
        return L
    err = _lib().block_chol(A.data_ptr(), L.data_ptr(), M, D,
                            torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on("block_chol", err)
    block_chol.launches += 1
    block_chol.launches_by_size[D] += 1
    return L


def _solve(wrapper, plain, L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Checks, routing, launch and launch count shared by the two
    substitution wrappers; the C entry point carries the wrapper's name.
    B may have any strides (the kernel reads it through them)."""
    name = wrapper.__name__
    if L.dim() != 3 or B.dim() != 3 or L.shape[-1] != L.shape[-2]:
        raise ValueError(f"{name}: expected L (M, D, D), B (M, D, K), "
                         f"got {tuple(L.shape)}, {tuple(B.shape)}")
    M, D, _ = L.shape
    K = B.shape[-1]
    _check(f"{name}.L", L, (M, D, D))
    _check(f"{name}.B", B, (M, D, K), contiguous=False)
    if not _route(name, D, L, B):
        return plain(L, B)
    X = torch.empty((M, D, K), dtype=B.dtype, device=B.device)
    if X.numel() == 0:
        return X
    if L.data_ptr() % 16:
        raise ValueError(f"{name}: L is not 16-byte aligned")
    err = getattr(_lib(), name)(L.data_ptr(), B.data_ptr(), X.data_ptr(), M, D, K,
                                *B.stride(),
                                torch.cuda.current_stream(L.device).cuda_stream)
    _raise_on(name, err)
    wrapper.launches += 1
    wrapper.launches_by_size[D] += 1
    return X


def block_tri_lower_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Y (M, D, K) with L_m Y_m = B_m for lower-triangular L (M, D, D)
    and B (M, D, K), float32: the kernel of :func:`block_chol_solve`
    with the back substitution compiled out."""
    return _solve(block_tri_lower_solve, block_tri_lower_solve_plain, L, B)


def block_chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """X (M, D, K) with L_m L_m^T X_m = B_m for Cholesky factors L
    (M, D, D), contiguous, and B (M, D, K) of any strides, float32.

    Replaces ``score_tpu/ops/pallas_blocks.py:_tri_solve_kernel`` and the
    ~37 elementwise launches of the back substitution that followed it in
    every caller (``pcr._dinv``, ``inv_small_spd``). A thread owns 4, 2 or
    1 neighbouring rhs columns of one block (the widest vector that K,
    B's strides and the addresses keep aligned), loads them once,
    substitutes forward and back in registers in the plain version's
    order, and stores X once: B in and X out is all the traffic. The
    thread block is (column vectors, blocks) and the grid (block ranges,
    column tiles), so no thread divides by K; the L blocks of a thread
    block are staged once in shared memory with the reciprocals of their
    diagonals. Memory bounds the arrow panel (K = 138..258; blocks of 256
    threads), launch latency the K = 1 and K = 6 solves (blocks of 64
    threads, to spread 1024 to 3072 threads of work over the SMs). A
    transposed or stepped B costs no copy."""
    return _solve(block_chol_solve, block_chol_solve_plain, L, B)


KERNELS = (block_chol, block_tri_lower_solve, block_chol_solve)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.launches_by_size = dict.fromkeys(CUDA_BLOCK_SIZES, 0)


reset_launch_counts()
