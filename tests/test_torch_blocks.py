"""The port's batched block kernels' plain twins (ops/blocks.py) and the
small-block routing (solver/smallblocks.py) against the JAX package.

On CPU tensors ``block_chol``, ``block_tri_lower_solve`` and
``block_chol_solve`` compute their plain twins; the JAX side runs its
Pallas kernels in interpret mode.
Tolerances: 1e-5 relative (to the largest reference entry) in f32 against
the Pallas kernels, which multiply by a reciprocal of the pivot where the
twins divide and which XLA contracts into FMAs; 1e-12 in f64 against the
JAX package's unrolled routines (same formulas, same order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from score_tpu.ops.pallas_blocks import chol_blocks_pallas, tri_lower_solve_blocks_pallas
from score_tpu.solver import smallblocks as rsb
from score_tpu.solver.pcr import _dinv as ref_dinv

from score_tpu_torch.ops import blocks
from score_tpu_torch.solver import smallblocks as psb


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _spd(M, D, seed, dtype=np.float32):
    """SPD blocks made as the band's are: M M^T + (2 + 4 D) I."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, D, D))
    return (A @ np.swapaxes(A, -1, -2) + (2.0 + 4.0 * D) * np.eye(D)).astype(dtype)


@pytest.mark.parametrize("D", [2, 6])
def test_block_chol_matches_pallas_interpret(D):
    A = _spd(40, D, 10 + D)
    L = blocks.block_chol(torch.tensor(A))
    assert L.dtype == torch.float32
    assert _rel(L, chol_blocks_pallas(jnp.asarray(A), interpret=True)) <= 1e-5
    assert torch.equal(torch.triu(L, diagonal=1), torch.zeros_like(L))


@pytest.mark.parametrize("D,K", [(2, 1), (2, 40), (6, 1), (6, 6)])
def test_block_tri_lower_solve_matches_pallas_interpret(D, K):
    A = _spd(24, D, 20 + D)
    L = np.linalg.cholesky(A.astype(np.float64)).astype(np.float32)
    B = np.random.default_rng(K).standard_normal((24, D, K)).astype(np.float32)
    Y = blocks.block_tri_lower_solve(torch.tensor(L), torch.tensor(B))
    want = tri_lower_solve_blocks_pallas(jnp.asarray(L), jnp.asarray(B), interpret=True)
    assert _rel(Y, want) <= 1e-5


@pytest.mark.parametrize("D,K", [(2, 2), (6, 1), (6, 40)])
def test_twins_match_jax_unrolled_f64(D, K):
    A = _spd(16, D, 30 + D, np.float64)
    B = np.random.default_rng(K).standard_normal((16, D, K))
    L = blocks.block_chol_plain(torch.tensor(A))
    L_ref = rsb.chol_small(jnp.asarray(A))
    assert _rel(L, L_ref) <= 1e-12
    assert _rel(blocks.block_tri_lower_solve_plain(L, torch.tensor(B)),
                rsb.tri_lower_solve(L_ref, jnp.asarray(B))) <= 1e-12
    # reconstruction: L L^T = A
    assert _rel(L @ L.transpose(-1, -2), A) <= 1e-13


def test_non_positive_pivot_gives_nan():
    A = _spd(3, 6, 40)
    A[1, 2, 2] = -1.0
    L = blocks.block_chol(torch.tensor(A))
    assert torch.isnan(L[1]).any() and torch.isfinite(L[[0, 2]]).all()


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers and the smallblocks routines return the
    plain twins' results and launch nothing, in f32 and f64."""
    blocks.reset_launch_counts()
    A = torch.tensor(_spd(8, 6, 50))
    B = torch.randn(8, 6, 3)
    L = blocks.block_chol(A)
    assert torch.equal(L, blocks.block_chol_plain(A))
    assert torch.equal(blocks.block_tri_lower_solve(L, B),
                       blocks.block_tri_lower_solve_plain(L, B))
    A4 = A.reshape(2, 4, 6, 6)
    assert torch.equal(psb.chol_small(A4), blocks.block_chol_plain(A4))
    assert torch.equal(psb.tri_lower_solve(L, B), blocks.block_tri_lower_solve_plain(L, B))
    assert torch.equal(psb.chol_small(A.double()), blocks.block_chol_plain(A.double()))
    X = blocks.block_chol_solve_plain(L, B)
    assert torch.equal(blocks.block_chol_solve(L, B), X)
    assert torch.equal(psb.chol_solve(L, B), X)
    assert torch.equal(psb.inv_small_spd(A4), blocks.block_chol_solve_plain(
        blocks.block_chol_plain(A4), torch.eye(6).expand(2, 4, 6, 6)))
    assert [k.__name__ for k in blocks.KERNELS] == [
        "block_chol", "block_tri_lower_solve", "block_chol_solve"]
    assert [k.launches for k in blocks.KERNELS] == [0, 0, 0]
    assert all(not any(k.launches_by_size.values()) for k in blocks.KERNELS)


def test_wrappers_reject_bad_inputs():
    A = torch.tensor(_spd(4, 6, 60))
    L = blocks.block_chol(A)
    with pytest.raises(TypeError):
        blocks.block_chol(A.double())
    with pytest.raises(ValueError):
        blocks.block_chol(A.transpose(-1, -2))  # not contiguous
    with pytest.raises(ValueError):
        blocks.block_chol(A[:, :, :5])  # not square
    with pytest.raises(ValueError):
        blocks.block_tri_lower_solve(L, torch.zeros(3, 6, 2))  # batch mismatch
    with pytest.raises(RuntimeError):
        blocks.block_chol(A.to("meta"))  # neither CPU nor CUDA: no kernel


SOLVE_CASES = [(2, 2), (6, 1), (6, 6), (6, 40)]


def _factor_and_rhs(D, K, seed, dtype):
    A = _spd(16, D, seed, np.float64)
    L = np.linalg.cholesky(A).astype(dtype)
    B = np.random.default_rng(seed + K).standard_normal((16, D, K)).astype(dtype)
    return A, L, B


@pytest.mark.parametrize("D,K", SOLVE_CASES)
def test_chol_solve_matches_jax_dinv_f64(D, K):
    """Forward then back substitution against the JAX band's ``_dinv``:
    1e-12 (same formulas, same order), and L L^T X = B to 1e-12."""
    A, L, B = _factor_and_rhs(D, K, 70 + D, np.float64)
    want = ref_dinv(jnp.asarray(L), jnp.asarray(B))
    Lt, Bt = torch.tensor(L), torch.tensor(B)
    X = blocks.block_chol_solve_plain(Lt, Bt)
    assert X.dtype == torch.float64 and X.shape == B.shape
    assert _rel(X, want) <= 1e-12
    assert _rel(A @ X.numpy(), B) <= 1e-12
    # the routing, on a batch with two leading dimensions: the same bits
    X4 = psb.chol_solve(Lt.reshape(4, 4, D, D), Bt.reshape(4, 4, D, K))
    assert torch.equal(X4.reshape(X.shape), X)
    assert torch.equal(X, psb.tri_upper_solve(Lt, psb.tri_lower_solve(Lt, Bt)))


@pytest.mark.parametrize("D,K", SOLVE_CASES)
def test_chol_solve_matches_jax_dinv_f32(D, K):
    """f32: 1e-5 relative against the JAX ``_dinv`` with its forward
    substitution through the Pallas kernel in interpret mode (a reciprocal
    multiply where the twin divides) and against its unrolled route; the
    residual of L L^T X = B to 1e-5."""
    A, L, B = _factor_and_rhs(D, K, 80 + D, np.float32)
    Lj, Bj = jnp.asarray(L), jnp.asarray(B)
    pallas = rsb.tri_upper_solve(Lj, tri_lower_solve_blocks_pallas(Lj, Bj, interpret=True))
    Lt, Bt = torch.tensor(L), torch.tensor(B)
    for X in (blocks.block_chol_solve(Lt, Bt), psb.chol_solve(Lt, Bt)):
        assert X.dtype == torch.float32
        assert _rel(X, pallas) <= 1e-5
        assert _rel(X, ref_dinv(Lj, Bj)) <= 1e-5
        assert _rel(A @ X.double().numpy(), B) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_solve_takes_strided_rhs(dtype):
    """The rhs views the f32 band hands over (every second block of a
    chain, transposed; a broadcast identity) give the bits of their
    contiguous copies."""
    A = torch.tensor(_spd(8, 6, 90, np.float64)).to(dtype)
    L = blocks.block_chol_plain(A)
    U = torch.randn(2, 8, 6, 6, dtype=dtype)
    view = U[:, 0::2].transpose(-1, -2)
    assert not view.is_contiguous()
    L4 = L.reshape(2, 4, 6, 6)
    assert torch.equal(psb.chol_solve(L4, view), psb.chol_solve(L4, view.contiguous()))
    eye = torch.eye(6, dtype=dtype).expand(8, 6, 6)
    if dtype == torch.float32:
        assert torch.equal(blocks.block_chol_solve(L, eye),
                           blocks.block_chol_solve(L, eye.contiguous()))
        assert torch.equal(blocks.block_tri_lower_solve(L, view.reshape(8, 6, 6)),
                           blocks.block_tri_lower_solve_plain(L, view.reshape(8, 6, 6)))
    assert _rel(A @ psb.chol_solve(L, eye), torch.eye(6, dtype=dtype).expand(8, 6, 6)) <= (
        1e-5 if dtype == torch.float32 else 1e-12)


def test_chol_solve_rejects_bad_inputs():
    L = blocks.block_chol(torch.tensor(_spd(4, 6, 61)))
    B = torch.zeros(4, 6, 3)
    with pytest.raises(TypeError):
        blocks.block_chol_solve(L.double(), B.double())  # the kernel is f32 only
    with pytest.raises(TypeError):
        blocks.block_chol_solve(L, B.double())
    with pytest.raises(ValueError):
        blocks.block_chol_solve(L, torch.zeros(3, 6, 3))  # batch mismatch
    with pytest.raises(ValueError):
        blocks.block_chol_solve(L, torch.zeros(4, 5, 3))  # row mismatch
    with pytest.raises(ValueError):
        blocks.block_chol_solve(L.transpose(-1, -2), B)  # L not contiguous
    with pytest.raises(ValueError):
        blocks.block_chol_solve(L[0], B[0])  # not batched
    with pytest.raises(RuntimeError):
        blocks.block_chol_solve(L.to("meta"), B.to("meta"))  # no kernel there
    with pytest.raises(ValueError):
        blocks.block_chol_solve(L, B.to("meta"))  # two devices


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chol_small_takes_the_band_views(dtype):
    """The views the f32 band hands ``chol_small`` (the odd rows ``D[:,
    1::2]`` of a level, the root ``D[:, 0]``) give the bits of their
    contiguous copies."""
    D = torch.tensor(_spd(3 * 8, 6, 91, np.float64)).to(dtype).reshape(3, 8, 6, 6)
    for view in (D[:, 1::2], D[:, 0]):
        L = psb.chol_small(view)
        assert L.shape == view.shape
        assert torch.equal(L, psb.chol_small(view.contiguous()))


def test_block_chol_reads_strided_blocks():
    """The wrapper takes blocks through their block stride where each block
    is contiguous and on a 16-byte boundary (the band's views, with the
    plain version's bits), and rejects a non-unit column stride, a block
    stride off 16 bytes and a misaligned address."""
    D = torch.tensor(_spd(4 * 8, 6, 92)).reshape(4, 8, 6, 6)
    for view in (D[:, 1::2].reshape(-1, 6, 6), D[:, 0]):
        assert not view.is_contiguous() and blocks.block_chol_reads(view)
        assert torch.equal(blocks.block_chol(view), blocks.block_chol_plain(view.contiguous()))
    A = D.reshape(-1, 6, 6)
    assert blocks.block_chol_reads(A)
    padded = torch.zeros(32, 37)
    padded[:, :36] = A.reshape(32, 36)
    bad = {
        "column stride": A.transpose(-1, -2),
        "row stride": torch.zeros(32, 6, 8)[:, :, :6],
        "block stride": padded[:, :36].reshape(32, 6, 6),
        "address": torch.zeros(32 * 36 + 1)[1:].reshape(32, 6, 6),
    }
    for what, t in bad.items():
        assert not blocks.block_chol_reads(t), what
        with pytest.raises(ValueError):
            blocks.block_chol(t)
    # D = 2 pivots: a block is one 16-byte unit
    P = torch.tensor(_spd(6, 2, 93))
    assert blocks.block_chol_reads(P) and blocks.block_chol_reads(P[::2])
    assert not blocks.block_chol_reads(torch.zeros(6 * 4 + 1)[1:].reshape(6, 2, 2))
