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
from score_tpu_torch.solver import smallblocks
from score_tpu_torch.solver.pcr import pcr_factor, pcr_solve
from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the band kernels only run there")
    return torch.device("cuda")


def _rel(a, b):
    """max |a - b| / max |b|; the absolute difference where b is all zero
    (the couplings A', C' after a chain's last PCR level)."""
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-300)).item()


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
    invD = band.band_block_inv(D)
    assert _rel(invD, band.band_block_inv_plain(D)) <= 1e-12
    for s in (1, 8, 32):
        for got, want in zip(band.band_pcr_level(D, A, U, invD, s),
                             band.band_pcr_level_plain(D, A, U, invD, s)):
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


@pytest.mark.parametrize(
    "C,Tp,Ks",
    [
        (4, 256, (1, 138)),  # Manhattan-4's PCR remainder, a direction and the panel
        (20, 128, (1, 258)),  # robot20's band
        (3, 1, (1, 3)),  # a single block per chain: no level
        (2, 2, (1, 3, 139)),
        (1, 256, (1, 2, 4, 5, 139)),  # one chain; widths at the tiles' edges
        (5, 32, (3, 7, 8, 139)),
        (2, 512, (1, 3, 9)),  # longer than the wide solve kernel takes
    ],
)
def test_pcr_kernels_match_plain_at_every_level(cuda, C, Tp, Ks):
    """band_pcr_level at every level of a factor, each fed the kernel's
    outputs of the level before, and band_pcr_solve for every width, at
    the main path's shapes and at the edges of what it can reach: 1e-12
    relative (another summation order inside the products, and FMAs)."""
    D, U = _band(C, Tp, 6, 63, (Tp,) * C, cuda)
    A, Cl, invD = band.band_init_a(U), U, band.band_block_inv(D)
    Es, Fs = [], []
    for lev in range(band.num_levels(Tp)):
        out = band.band_pcr_level(D, A, Cl, invD, 1 << lev)
        for got, want in zip(out, band.band_pcr_level_plain(D, A, Cl, invD, 1 << lev)):
            assert _rel(got, want) <= 1e-12
        E, F, D, A, Cl, invD = out
        Es.append(E)
        Fs.append(F)
    E = torch.stack(Es) if Es else D.new_zeros((0, C, Tp, 6, 6))
    F = torch.stack(Fs) if Fs else E
    for K in Ks:
        b = torch.randn(C, Tp, 6, K, dtype=torch.float64, device=cuda)
        x = band.band_pcr_solve(E, F, invD, b)
        assert _rel(x, band.band_pcr_solve_plain(E, F, invD, b)) <= 1e-12
    torch.cuda.synchronize()


def test_robot20_band_shape_launches_the_pcr_kernels(cuda):
    """A factor and two solves at robot20's band shape (20 chains of 128,
    panel width 258) run PCR only: both redesigned kernels launch, no
    compacting kernel does, and the solution satisfies the band."""
    C, Tp, K = 20, 128, 258
    D, U = _band(C, Tp, 6, 64, (100,) * C, cuda)
    band.reset_launch_counts()
    f = band.band_factor(D, U)
    assert band.band_pcr_level.launches == band.num_levels(Tp)
    for k in (1, K):
        b = torch.randn(C, Tp, 6, k, dtype=torch.float64, device=cuda)
        x = band.band_solve(f, b)
        Tx = D @ x
        Tx[:, 1:] += U[:, :-1].transpose(-1, -2) @ x[:, :-1]
        Tx[:, :-1] += U[:, :-1] @ x[:, 1:]
        assert (Tx - b).abs().max() <= 1e-10 * b.abs().max()
    assert band.band_pcr_solve.launches == 2
    assert band.band_block_inv.launches == 1
    assert band.band_cr_level.launches == band.band_cr_reduce.launches == 0


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
    X = blocks.block_chol_solve(L, B)
    assert _rel(X, blocks.block_chol_solve_plain(L, B)) <= 1e-5
    assert _rel(A @ X, B) <= 1e-5
    torch.cuda.synchronize()
    assert [k.launches for k in blocks.KERNELS] == [1, 1, 1]
    with pytest.raises(TypeError):
        blocks.block_chol(A.double())  # the kernels are f32 only


@pytest.mark.parametrize("K", [1, 2, 5, 6, 138, 139, 258])
@pytest.mark.parametrize("D,M", [(6, 1), (6, 3), (6, 1024), (6, 1280), (2, 2070)])
def test_substitution_kernels_match_plain(cuda, D, M, K):
    """block_chol_solve and the forward-only block_tri_lower_solve against
    their plain versions, 1e-5 (f32; FMAs, and a reciprocal multiply where
    the plain version divides): rhs widths that take the 16-byte (K = 2 at
    D = 2, where whole blocks stay aligned), the 8-byte and the scalar
    route, a last thread block that is not full, and rhs views read
    through their strides (transposed; every second block; a broadcast
    identity)."""
    L = blocks.block_chol(_spd32(M, D, M + D + K, cuda))
    B = torch.randn(M, D, K, device=cuda)
    views = [B, torch.randn(M, K, D, device=cuda).transpose(-1, -2),
             torch.randn(2 * M, D, K, device=cuda)[1::2]]
    if K == D:
        views.append(torch.eye(D, device=cuda).expand(M, D, D))
    blocks.reset_launch_counts()
    for rhs in views:
        assert _rel(blocks.block_chol_solve(L, rhs),
                    blocks.block_chol_solve_plain(L, rhs)) <= 1e-5
        assert _rel(blocks.block_tri_lower_solve(L, rhs),
                    blocks.block_tri_lower_solve_plain(L, rhs)) <= 1e-5
    torch.cuda.synchronize()
    assert blocks.block_chol_solve.launches == len(views)
    assert blocks.block_chol_solve.launches_by_size[D] == len(views)


@pytest.mark.parametrize("C", [1, 4, 20])
@pytest.mark.parametrize("T", [2, 4, 30, 512, 2048])
def test_cr_level_matches_plain(cuda, C, T):
    """band_cr_level against its plain version, 1e-12, where a thread block
    (15 coarse positions and the lane group that inverts the odd block
    before them) meets the chains every way: chains that start inside a
    thread block (T = 2, 4: no lower neighbour beside a neighbour group),
    on its first position (T = 30: no halo inverse), and chains cut by its
    edge (T = 512, 2048); the last thread block is not full."""
    D, U = _band(C, T, 6, 65 + T, (T,) * C, cuda)
    A = band.band_init_a(U)
    band.reset_launch_counts()
    for got, want in zip(band.band_cr_level(D, A, U), band.band_cr_level_plain(D, A, U)):
        assert got.shape == (C, T // 2, 6, 6)
        assert _rel(got, want) <= 1e-12
    torch.cuda.synchronize()
    assert band.band_cr_level.launches == 1


@pytest.mark.parametrize("C", [1, 4, 20])
@pytest.mark.parametrize("Th", [1, 2, 256, 1024])
def test_cr_backsub_matches_plain(cuda, C, Th):
    """band_cr_backsub against its plain version, 1e-12, through both of
    its kernels (narrow for K <= 4, wide above; odd and even K for the
    wide one's column pairs), on chains of one coarse position (no upper
    neighbour), two, and lengths whose chains thread blocks cut."""
    D, U = _band(C, 2 * Th, 6, 66 + Th, (2 * Th,) * C, cuda)
    _, _, iv, Ao, Co, *_ = band.band_cr_level(D, band.band_init_a(U), U)
    band.reset_launch_counts()
    Ks = (1, 2, 4, 5, 138, 258)
    for K in Ks:
        b = torch.randn(C, 2 * Th, 6, K, dtype=torch.float64, device=cuda)
        xe = torch.randn(C, Th, 6, K, dtype=torch.float64, device=cuda)
        x = band.band_cr_backsub(iv, Ao, Co, b, xe)
        assert x.shape == b.shape
        assert _rel(x, band.band_cr_backsub_plain(iv, Ao, Co, b, xe)) <= 1e-12
    torch.cuda.synchronize()
    assert band.band_cr_backsub.launches == len(Ks)


@pytest.mark.parametrize("D", [2, 6])
@pytest.mark.parametrize("M", [1, 3, 4, 128, 1024, 2070])
def test_block_chol_matches_plain_in_every_layout(cuda, D, M):
    """block_chol against its plain version, 1e-5 (f32; FMAs and an rsqrt
    where the plain version divides by a square root), and ||L L^T - A||
    / ||A|| <= 1e-5, on contiguous blocks and on blocks read through their
    block stride: every second block (the f32 band's odd rows) and the
    first of every three (a chain's root)."""
    views = [_spd32(M, D, M + D, cuda), _spd32(2 * M, D, M + D + 1, cuda)[1::2],
             _spd32(3 * M, D, M + D + 2, cuda).reshape(M, 3, D, D)[:, 0]]
    blocks.reset_launch_counts()
    for A in views:
        L = blocks.block_chol(A)
        assert L.is_contiguous() and L.shape == A.shape
        assert _rel(L, blocks.block_chol_plain(A)) <= 1e-5
        assert torch.equal(torch.triu(L, diagonal=1), torch.zeros_like(L))
        assert _rel(L @ L.transpose(-1, -2), A) <= 1e-5
    torch.cuda.synchronize()
    assert blocks.block_chol.launches_by_size[D] == len(views)


def test_chol_small_reads_the_odd_rows_in_place(cuda):
    """The f32 band's odd-row view reaches the kernel without a copy: the
    result equals the kernel's on the contiguous copy, bit for bit."""
    A = _spd32(4 * 512, 6, 9, cuda).reshape(4, 512, 6, 6)
    view = A[:, 1::2]
    assert blocks.block_chol_reads(view.reshape(-1, 6, 6))
    L = smallblocks.chol_small(view)
    assert torch.equal(L, smallblocks.chol_small(view.contiguous()))
    assert torch.equal(smallblocks.chol_small(A[:, 0]), blocks.block_chol(A[:, 0].contiguous()))


def _assert_fused_path():
    """The f32 band launched the Cholesky and the fused solve, and never
    the forward-only kernel."""
    assert blocks.block_chol.launches > 0 and blocks.block_chol_solve.launches > 0
    assert blocks.block_tri_lower_solve.launches == 0


def test_f32_band_matches_f64_band(cuda):
    """Cyclic reduction in f32 over the block kernels against the f64
    band kernels on the same well-conditioned chains: 1e-4 relative."""
    D, U = _band(3, 64, 6, 62, (64, 40, 7), cuda)
    b = torch.randn(3, 64, 6, 5, dtype=torch.float64, device=cuda)
    blocks.reset_launch_counts()
    x32 = pcr_solve(pcr_factor(D.float(), U.float()), b.float())
    _assert_fused_path()
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
    _assert_fused_path()
    cpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", precision="f32"))
    assert gpu.solved and cpu.solved
    assert abs(gpu.iterations - cpu.iterations) <= 3
    assert abs(gpu.primal_objective - cpu.primal_objective) <= 2e-2 * abs(cpu.primal_objective)
