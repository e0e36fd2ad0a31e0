"""The port's CUDA path on the card: each band kernel and each block
kernel against its plain PyTorch version, and f64 and f32 solves on the
card against the port's CPU path.

Every test here carries the ``gpu`` marker and skips without a card. The
file imports neither jax nor the JAX package, so on a machine with a card
and no jax it runs on its own:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from score_tpu_torch import ScoreSolverParams, solve_score
from score_tpu_torch.ops import band, blocks
from score_tpu_torch.solver.pcr import pcr_factor, pcr_solve
from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the band kernels only run there")
    return torch.device("cuda")


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


def _band(C, T, Db, seed, active, device):
    """Random SPD block-tridiagonal chains, chain c padded with decoupled
    identity blocks after its first active[c] blocks."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((C, T, Db, Db))
    D = M @ np.swapaxes(M, -1, -2) + (2.0 + 4.0 * Db) * np.eye(Db)
    U = 0.3 * rng.standard_normal((C, T, Db, Db))
    for c, n in enumerate(active):
        D[c, n:] = np.eye(Db)
        U[c, max(n - 1, 0):] = 0.0
    return (torch.tensor(a, device=device) for a in (D, U))


@pytest.mark.parametrize("K", [1, 40])
def test_kernels_match_plain(cuda, K):
    """Max relative difference 1e-12 (f64 on both sides; the kernels sum
    the block products in another order and contract to FMAs)."""
    D, U = _band(3, 64, 6, 60, (64, 40, 7), cuda)
    band.reset_launch_counts()
    A = band.band_init_a(U)
    assert _rel(A, band.band_init_a_plain(U)) == 0.0
    assert _rel(band.band_block_inv(D), band.band_block_inv_plain(D)) <= 1e-12
    for s in (1, 8, 32):
        for got, want in zip(band.band_pcr_level(D, A, U, s),
                             band.band_pcr_level_plain(D, A, U, s)):
            assert _rel(got, want) <= 1e-12
    f = band.band_factor(D, U, n_cr=0)
    b = torch.randn(3, 64, 6, K, dtype=torch.float64, device=cuda)
    x = band.band_pcr_solve(f.E, f.F, f.invD, b)
    assert _rel(x, band.band_pcr_solve_plain(f.E, f.F, f.invD, b)) <= 1e-12
    # two compacting levels, each fed the previous level's kernel outputs
    Dl, Al, Cl, bl = D, A, U, b
    for _ in range(2):
        lv = band.band_cr_level(Dl, Al, Cl)
        for got, want in zip(lv, band.band_cr_level_plain(Dl, Al, Cl)):
            assert _rel(got, want) <= 1e-12
        E, F, iv, Ao, Co, Dl, Al, Cl = lv
        red = band.band_cr_reduce(E, F, bl)
        assert _rel(red, band.band_cr_reduce_plain(E, F, bl)) <= 1e-12
        xe = torch.randn_like(red)
        xb = band.band_cr_backsub(iv, Ao, Co, bl, xe)
        assert _rel(xb, band.band_cr_backsub_plain(iv, Ao, Co, bl, xe)) <= 1e-12
        bl = red
    torch.cuda.synchronize()
    assert all(k.launches > 0 for k in band.KERNELS)


def test_compacted_band_solves(cuda):
    """Factor and solve through CR levels and PCR on the card against a
    dense solve of each chain."""
    D, U = _band(2, 64, 6, 61, (64, 30), cuda)
    b = torch.randn(2, 64, 6, 3, dtype=torch.float64, device=cuda)
    x = band.band_solve(band.band_factor(D, U, n_cr=3), b)
    for c in range(2):
        K = torch.zeros(64 * 6, 64 * 6, dtype=torch.float64, device=cuda)
        for i in range(64):
            K[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[c, i]
            if i + 1 < 64:
                K[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = U[c, i]
                K[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = U[c, i].T
        xref = torch.linalg.solve(K, b[c].reshape(64 * 6, 3))
        assert _rel(x[c].reshape(64 * 6, 3), xref) <= 1e-11


def test_cuda_solve_matches_cpu(cuda, monkeypatch):
    monkeypatch.setattr(band, "CR_BASE_LENGTH", 8)  # chains of 32: two CR levels
    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1,
    ))
    band.reset_launch_counts()
    gpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda"))
    assert all(k.launches > 0 for k in band.KERNELS)
    cpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu"))
    assert gpu.solved and abs(gpu.iterations - cpu.iterations) <= 1
    assert abs(gpu.primal_objective - cpu.primal_objective) <= 1e-9 * abs(cpu.primal_objective)
    for name, T in cpu.poses.items():
        np.testing.assert_allclose(gpu.poses[name], T, atol=1e-5, rtol=0)


def _spd32(M, D, seed, device):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, D, D))
    A = A @ np.swapaxes(A, -1, -2) + (2.0 + 4.0 * D) * np.eye(D)
    return torch.tensor(A, dtype=torch.float32, device=device)


@pytest.mark.parametrize("D,M,K", [(6, 1024, 1), (6, 1024, 6), (6, 1024, 138), (2, 2070, 2)])
def test_block_kernels_match_plain(cuda, D, M, K):
    """Max relative difference 1e-5 (f32; the kernels contract to FMAs,
    the plain versions round each PyTorch op) and reconstruction
    residuals ||L L^T - A|| / ||A|| and ||L Y - B|| / ||B|| <= 1e-5."""
    blocks.reset_launch_counts()
    A = _spd32(M, D, M + D, cuda)
    L = blocks.block_chol(A)
    assert _rel(L, blocks.block_chol_plain(A)) <= 1e-5
    assert torch.equal(torch.triu(L, diagonal=1), torch.zeros_like(L))
    assert _rel(L @ L.transpose(-1, -2), A) <= 1e-5
    B = torch.randn(M, D, K, device=cuda)
    Y = blocks.block_tri_lower_solve(L, B)
    assert _rel(Y, blocks.block_tri_lower_solve_plain(L, B)) <= 1e-5
    assert _rel(L @ Y, B) <= 1e-5
    torch.cuda.synchronize()
    assert [k.launches for k in blocks.KERNELS] == [1, 1]
    with pytest.raises(TypeError):
        blocks.block_chol(A.double())  # the kernels are f32 only


def test_f32_band_matches_f64_band(cuda):
    """Cyclic reduction in f32 over the block kernels against the f64
    band kernels on the same well-conditioned chains: 1e-4 relative."""
    D, U = _band(3, 64, 6, 62, (64, 40, 7), cuda)
    b = torch.randn(3, 64, 6, 5, dtype=torch.float64, device=cuda)
    blocks.reset_launch_counts()
    x32 = pcr_solve(pcr_factor(D.float(), U.float()), b.float())
    assert all(k.launches > 0 for k in blocks.KERNELS)
    x64 = band.band_solve(band.band_factor(D, U), b)
    assert _rel(x32.double(), x64) <= 1e-4


def test_f32_cuda_solve_matches_cpu(cuda):
    """The f32 fast mode on the card against the port's f32 CPU path: both
    solved, iterations within 3, objectives within 2e-2."""
    fg = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=4, num_poses_per_robot=50, num_landmarks=4, grid_size=12,
        range_measure_prob=0.4, seed=3,
    ))
    blocks.reset_launch_counts()
    gpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda", precision="f32"))
    assert all(k.launches > 0 for k in blocks.KERNELS)
    cpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", precision="f32"))
    assert gpu.solved and cpu.solved
    assert abs(gpu.iterations - cpu.iterations) <= 3
    assert abs(gpu.primal_objective - cpu.primal_objective) <= 2e-2 * abs(cpu.primal_objective)
