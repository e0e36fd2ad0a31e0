"""The port's batched block kernels' plain twins (ops/blocks.py) and the
small-block routing (solver/smallblocks.py) against the JAX package.

On CPU tensors ``block_chol`` and ``block_tri_lower_solve`` compute their
plain twins; the JAX side runs its Pallas kernels in interpret mode.
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
    assert [k.launches for k in blocks.KERNELS] == [0, 0]


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
