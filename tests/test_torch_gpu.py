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
from score_tpu_torch.fg.measurements import PoseMeasurement3D
from score_tpu_torch.ops import band, blocks
from score_tpu_torch.solver import smallblocks
from score_tpu_torch.solver.pcr import pcr_factor, pcr_solve
from score_tpu_torch.sim.manhattan import ManhattanWorldParams, simulate_manhattan_world
from score_tpu_torch.sim.world3d import World3DParams, simulate_3d_world

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the band kernels only run there")
    return torch.device("cuda")


def _reference_data():
    """``tests/torch_reference_data.py`` (numpy only at import), loaded
    from its file: on a machine whose site-packages hold a ``tests``
    package, ``tests.torch_reference_data`` does not resolve."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "torch_reference_data", Path(__file__).resolve().parent / "torch_reference_data.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _off_the_default_path(Db):
    """Names of the band kernels a band compacted to one block a chain does
    not launch at block size Db: band_pcr_level (no PCR level), and
    band_cr_level and band_block_inv where band_cr_factor takes the factor
    (Db = 6: its last run inverts the one block a chain), band_cr_factor
    where a band_cr_level launch a level does (Db = 12:
    band._factor_takes)."""
    if band._factor_takes(Db):
        return {"band_pcr_level", "band_cr_level", "band_block_inv"}
    return {"band_pcr_level", "band_cr_factor"}


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
    # two compacting levels, each fed the previous level's kernel outputs,
    # and the rhs reduction and back substitution through both in one launch
    Dl, Al, Cl, levels = D, A, U, []
    for _ in range(2):
        lv = band.band_cr_level(Dl, Al, Cl)
        for got, want in zip(lv, band.band_cr_level_plain(Dl, Al, Cl)):
            assert _rel(got, want) <= 1e-12
        levels.append(band.CRLevel(*lv[:5]))
        Dl, Al, Cl = lv[5:]
    _check_fused_cr(levels, b)
    _check_factor_run(D, A, U, 2)
    torch.cuda.synchronize()
    assert all(k.launches > 0 for k in band.KERNELS)


def _check_factor_run(D, A, C, n, last=False):
    """band_cr_factor over n levels against its plain twin, 1e-12 on every
    output, in one launch; returns the run."""
    k0 = band.band_cr_factor.launches
    run = band.band_cr_factor(D, A, C, n, last)
    want = band.band_cr_factor_plain(D, A, C, n, last)
    assert band.band_cr_factor.launches - k0 == 1 and len(run.levels) == n
    for got, w in zip(run.levels, want.levels):
        for g, x in zip(got, w):
            assert g.shape == x.shape and _rel(g, x) <= 1e-12
    for f in ("invD",) if last else ("D", "A", "C"):
        assert _rel(getattr(run, f), getattr(want, f)) <= 1e-12
    return run


def _check_fused_cr(levels, b):
    """band_cr_reduce and band_cr_backsub over ``levels`` against their
    plain twins, 1e-12, one launch each."""
    r0, b0 = band.band_cr_reduce.launches, band.band_cr_backsub.launches
    red = band.band_cr_reduce(levels, b)
    want = band.band_cr_reduce_plain(levels, b)
    assert len(red) == len(levels)
    for got, w in zip(red, want):
        assert got.shape == w.shape and _rel(got, w) <= 1e-12
    fine = (b,) + want[:-1]
    x = torch.randn_like(want[-1])
    got = band.band_cr_backsub(levels, fine, x)
    assert got.shape == b.shape
    assert _rel(got, band.band_cr_backsub_plain(levels, fine, x)) <= 1e-12
    assert (band.band_cr_reduce.launches - r0, band.band_cr_backsub.launches - b0) == (1, 1)


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
    panel width 258) with no compacting level (the schedule before the band
    compacted to one block) run PCR only: both redesigned kernels launch,
    no compacting kernel does, and the solution satisfies the band."""
    C, Tp, K = 20, 128, 258
    D, U = _band(C, Tp, 6, 64, (100,) * C, cuda)
    band.reset_launch_counts()
    f = band.band_factor(D, U, n_cr=0)
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
    # the factor's levels run in band_cr_factor launches, not band_cr_level's
    assert band.band_cr_level.launches == 0
    assert all(k.launches > 0 for k in band.KERNELS if k is not band.band_cr_level)
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


@pytest.mark.parametrize("D,M,K", [(6, 1024, 1), (6, 1024, 6), (6, 1024, 138), (2, 2070, 2),
                                   (12, 512, 1), (12, 512, 12), (12, 512, 18), (3, 2348, 3)])
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


# 2D: the panel widths and the 16-, 8-byte and scalar routes; 3D: D = 12
# band blocks (the 3D bench's panel K = 18, couplings K = 12, a direction
# K = 1) and D = 3 pivots, at batch sizes off and on the thread blocks
SUBSTITUTION_CASES = (
    [(D, M, K) for D, M in [(6, 1), (6, 3), (6, 1024), (6, 1280), (2, 2070)]
     for K in (1, 2, 5, 6, 138, 139, 258)]
    + [(D, M, K) for D, M in [(12, 1), (12, 3), (12, 7), (12, 512), (3, 1), (3, 7), (3, 2348)]
       for K in (1, 2, 3, 12, 18)])


@pytest.mark.parametrize("D,M,K", SUBSTITUTION_CASES)
def test_substitution_kernels_match_plain(cuda, D, M, K):
    """block_chol_solve and the forward-only block_tri_lower_solve against
    their plain versions, 1e-5 (f32; FMAs, and a reciprocal multiply where
    the plain version divides): rhs widths that take the 16-byte (K = 2 at
    D = 2, where whole blocks stay aligned), the 8-byte and the scalar
    route, a last thread block that is not full, and rhs views read
    through their strides (transposed; every second block; a broadcast
    identity, block stride 0 as the pivots' inverse hands it)."""
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
    """band_cr_backsub (and band_cr_reduce) at one level of a factor against
    their plain versions, 1e-12, through both per-level steps (narrow for
    K <= 4, wide above; odd and even K for the wide one's column pairs), on
    chains of one coarse position (no upper neighbour), two, and lengths
    that tiles cut: one launch each a call."""
    D, U = _band(C, 2 * Th, 6, 66 + Th, (2 * Th,) * C, cuda)
    levels = (band.CRLevel(*band.band_cr_level(D, band.band_init_a(U), U)[:5]),)
    band.reset_launch_counts()
    Ks = (1, 2, 4, 5, 138, 258)
    for K in Ks:
        _check_fused_cr(levels, torch.randn(C, 2 * Th, 6, K, dtype=torch.float64, device=cuda))
    torch.cuda.synchronize()
    assert band.band_cr_backsub.launches == len(Ks)


@pytest.mark.parametrize("D", [2, 3, 6, 12])
@pytest.mark.parametrize("M", [1, 3, 4, 7, 128, 512, 1024, 2070, 2348, 2363])
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


@pytest.mark.parametrize("M", [1, 2, 3, 4, 31, 32, 33, 511, 512, 513, 2363])
def test_block_kernels_match_plain_at_d12(cuda, M):
    """The D = 12 kernels (block_chol: a lane group a block; block_chol_solve:
    lane groups below K = 4, a thread a column above) against their plain
    versions, 1e-5, with ||L L^T - A|| / ||A|| and ||A X - B|| / ||B|| <=
    1e-5: batch sizes off and on the thread blocks and the warps' two
    groups, A contiguous, the odd rows of a batch and the first of each
    three, and rhs widths on both sides of the layouts' edge."""
    views = [_spd32(M, 12, M, cuda), _spd32(2 * M, 12, M + 1, cuda)[1::2],
             _spd32(3 * M, 12, M + 2, cuda).reshape(M, 3, 12, 12)[:, 0]]
    blocks.reset_launch_counts()
    for A in views:
        L = blocks.block_chol(A)
        assert _rel(L, blocks.block_chol_plain(A)) <= 1e-5
        assert torch.equal(torch.triu(L, diagonal=1), torch.zeros_like(L))
        assert _rel(L @ L.transpose(-1, -2), A) <= 1e-5
        for K in (1, 2, 12, 17, 18, 19, 24):
            B = torch.randn(M, 12, K, device=cuda)
            X = blocks.block_chol_solve(L, B)
            assert _rel(X, blocks.block_chol_solve_plain(L, B)) <= 1e-5
            assert _rel(A @ X, B) <= 1e-5
    torch.cuda.synchronize()
    assert blocks.block_chol.launches_by_size[12] == len(views)
    assert blocks.block_chol_solve.launches_by_size[12] == 7 * len(views)


@pytest.mark.parametrize("D", [6, 12])
@pytest.mark.parametrize("M", [1, 33, 512])
def test_two_rhs_launch_is_two_single_launches(cuda, D, M):
    """block_chol_solve(L, B, B2), one launch, gives bit for bit the two
    single-rhs launches, with B a transposed view and B2 a stepped one (a
    factor level's U_even^T and U_odd), at widths of both D = 12 layouts."""
    L = blocks.block_chol(_spd32(M, D, M + D, cuda))
    for K in (1, D, 18):
        B = torch.randn(M, K, D, device=cuda).transpose(-1, -2)
        B2 = torch.randn(2 * M, D, K, device=cuda)[1::2]
        blocks.reset_launch_counts()
        X, X2 = blocks.block_chol_solve(L, B, B2)
        assert blocks.block_chol_solve.launches == 1
        assert torch.equal(X, blocks.block_chol_solve(L, B))
        assert torch.equal(X2, blocks.block_chol_solve(L, B2))
        assert _rel(X2, blocks.block_chol_solve_plain(L, B2)) <= 1e-5
    torch.cuda.synchronize()


def test_block_kernels_raise_on_other_sizes(cuda):
    """A CUDA tensor of a block size the kernels are not built for raises;
    nothing falls back to the plain version on the card."""
    A = _spd32(4, 5, 1, cuda)
    with pytest.raises(ValueError, match="block sizes"):
        blocks.block_chol(A)
    with pytest.raises(ValueError, match="block sizes"):
        blocks.block_chol_solve(A, torch.zeros(4, 5, 2, device=cuda))


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


@pytest.mark.parametrize("Db", [6, 12])
def test_f32_band_matches_f64_band(cuda, Db):
    """Cyclic reduction in f32 over the block kernels against the f64
    band kernels on the same well-conditioned chains: 1e-4 relative."""
    D, U = _band(3, 64, Db, 62, (64, 40, 7), cuda)
    b = torch.randn(3, 64, Db, 5, dtype=torch.float64, device=cuda)
    blocks.reset_launch_counts()
    f32 = pcr_factor(D.float(), U.float())
    # a level: one Cholesky and one launch for both of its solves (W2, W1)
    levels = len(f32.L_odd)
    assert blocks.block_chol.launches_by_size[Db] == levels + 1
    assert blocks.block_chol_solve.launches_by_size[Db] == levels
    assert blocks.block_chol_solve.two_rhs_launches == levels
    x32 = pcr_solve(f32, b.float())
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


# ------------------------------------------------------------------ #
# 3D blocks (Db = 12): the same kernels' other instantiation
# ------------------------------------------------------------------ #


@pytest.mark.parametrize("K", [1, 2, 12, 17, 18, 19, 138])
def test_kernels_match_plain_3d(cuda, K):
    """Every band kernel at Db = 12 against its plain version, 1e-12, on
    padded chains: the levels of a PCR factor, a PCR solve, and two
    compacting levels with their rhs reduction and back substitution (K = 1,
    a direction; K = 18, the 3D bench's panel; widths around it and a wide
    one). Launches count at Db = 12. band_cr_factor, built for Db = 6,
    raises on a Db = 12 band and launches nothing."""
    D, U = _band(3, 32, 12, 70, (32, 20, 5), cuda)
    band.reset_launch_counts()
    A = band.band_init_a(U)
    assert _rel(A, band.band_init_a_plain(U)) == 0.0
    invD = band.band_block_inv(D)
    assert _rel(invD, band.band_block_inv_plain(D)) <= 1e-12
    for s in (1, 4, 16):
        for got, want in zip(band.band_pcr_level(D, A, U, invD, s),
                             band.band_pcr_level_plain(D, A, U, invD, s)):
            assert _rel(got, want) <= 1e-12
    f = band.band_factor(D, U, n_cr=0)
    b = torch.randn(3, 32, 12, K, dtype=torch.float64, device=cuda)
    x = band.band_pcr_solve(f.E, f.F, f.invD, b)
    assert _rel(x, band.band_pcr_solve_plain(f.E, f.F, f.invD, b)) <= 1e-12
    Dl, Al, Cl, levels = D, A, U, []
    for _ in range(2):
        lv = band.band_cr_level(Dl, Al, Cl)
        for got, want in zip(lv, band.band_cr_level_plain(Dl, Al, Cl)):
            assert _rel(got, want) <= 1e-12
        levels.append(band.CRLevel(*lv[:5]))
        Dl, Al, Cl = lv[5:]
    _check_fused_cr(levels, b)
    with pytest.raises(ValueError, match="band_cr_factor: the CUDA kernel is built for block"):
        band.band_cr_factor(D, A, U, 2)
    torch.cuda.synchronize()
    assert band.band_cr_factor.launches == 0
    assert all(k.launches_by_size[12] == k.launches > 0 for k in band.KERNELS
               if k is not band.band_cr_factor)


@pytest.mark.parametrize(
    "C,Tp,Ks",
    [(C, Tp, (1, 2, 12, 17, 18, 19, 138)) for Tp in (1, 2, 4, 32, 256, 512) for C in (1, 4)]
    + [
        (3, 1, (1, 3)),  # a single block per chain: no level
        (2, 2, (1, 3, 18)),
        (1, 256, (4, 5, 9)),  # one chain
        (2, 512, (1, 3)),
    ],
)
def test_pcr_kernels_match_plain_at_every_level_3d(cuda, C, Tp, Ks):
    """band_pcr_level at every level (a thread per block element) and
    band_pcr_solve (a cluster of thread blocks per chain; K = 138 takes
    several column chunks at Tp = 256 and 512) at Db = 12, 1e-12; chains
    of 1, 2 and 4 blocks run clusters of fewer blocks than the route's 16."""
    D, U = _band(C, Tp, 12, 71, (Tp,) * C, cuda)
    A, Cl, invD = band.band_init_a(U), U, band.band_block_inv(D)
    Es, Fs = [], []
    for lev in range(band.num_levels(Tp)):
        out = band.band_pcr_level(D, A, Cl, invD, 1 << lev)
        for got, want in zip(out, band.band_pcr_level_plain(D, A, Cl, invD, 1 << lev)):
            assert _rel(got, want) <= 1e-12
        E, F, D, A, Cl, invD = out
        Es.append(E)
        Fs.append(F)
    E = torch.stack(Es) if Es else D.new_zeros((0, C, Tp, 12, 12))
    F = torch.stack(Fs) if Fs else E
    for K in Ks:
        P, Kc = band._solve_cluster_plan(Tp, 12, K, C, torch.cuda.get_device_properties(
            cuda).multi_processor_count)
        assert P == min(16, Tp) and 1 <= Kc <= K
        b = torch.randn(C, Tp, 12, K, dtype=torch.float64, device=cuda)
        x = band.band_pcr_solve(E, F, invD, b)
        assert _rel(x, band.band_pcr_solve_plain(E, F, invD, b)) <= 1e-12
    torch.cuda.synchronize()


@pytest.mark.parametrize("plan", [(16, 400), (32, 1)])
def test_pcr_solve_3d_refused_launch_raises(cuda, plan, monkeypatch):
    """A cluster plan the card or the C entry point refuses (shared memory
    past 227 KB a thread block; a cluster of 32) raises from the wrapper,
    with no fallback."""
    D, U = _band(1, 256, 12, 74, (256,), cuda)
    f = band.band_factor(D, U, n_cr=0)
    b = torch.randn(1, 256, 12, 18, dtype=torch.float64, device=cuda)
    monkeypatch.setattr(band, "_solve_cluster_plan", lambda *args: plan)
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        band.band_pcr_solve(f.E, f.F, f.invD, b)
    monkeypatch.undo()
    x = band.band_pcr_solve(f.E, f.F, f.invD, b)  # the next launch runs
    assert _rel(x, band.band_pcr_solve_plain(f.E, f.F, f.invD, b)) <= 1e-12


@pytest.mark.parametrize("C,T", [(1, 2), (4, 2), (20, 2), (1, 4), (20, 4), (1, 6), (4, 6),
                                 (20, 6), (1, 8), (4, 10), (4, 30), (20, 30), (1, 512),
                                 (4, 512), (1, 1024), (1, 2048)])
def test_cr_level_matches_plain_3d(cuda, C, T):
    """band_cr_level at Db = 12 (a thread per block element: P coarse
    positions and P + 1 odd blocks a thread block) against its plain
    version, 1e-12: coarse lengths 1, 2 and 3, lengths that are no multiple
    of P = 2 to 4 (3, 5, 15), chains that start inside a thread block
    (C = 4, 20), and 3D 1x1000's two levels (Th = 512, 256)."""
    D, U = _band(C, T, 12, 72 + T, (T,) * C, cuda)
    A = band.band_init_a(U)
    for got, want in zip(band.band_cr_level(D, A, U), band.band_cr_level_plain(D, A, U)):
        assert got.shape == (C, T // 2, 12, 12)
        assert _rel(got, want) <= 1e-12
    torch.cuda.synchronize()


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("Th", [1, 2, 128, 512])
def test_cr_backsub_matches_plain_3d(cuda, C, Th):
    """band_cr_backsub at Db = 12 through both steps (narrow, a group of 16
    lanes per position, for K <= 4; element, a thread per rows of a
    column, above), and band_cr_reduce at the same widths, at one level of
    a factor against their plain versions."""
    D, U = _band(C, 2 * Th, 12, 73 + Th, (2 * Th,) * C, cuda)
    levels = (band.CRLevel(*band.band_cr_level(D, band.band_init_a(U), U)[:5]),)
    for K in (1, 2, 4, 5, 18):
        _check_fused_cr(levels, torch.randn(C, 2 * Th, 12, K, dtype=torch.float64, device=cuda))
    torch.cuda.synchronize()


def _random_levels(C, T, Db, n, gen, device):
    """n random compacting levels (fine -> coarse): blocks of 0.2 N(0, 1) /
    sqrt(Db), which keep the rhs of order one from level to level."""
    return tuple(band.CRLevel(*(0.2 / Db ** 0.5 * torch.randn(
        C, T >> (lev + 1), Db, Db, generator=gen, dtype=torch.float64, device=device)
        for _ in range(5))) for lev in range(n))


@pytest.mark.parametrize("C", [1, 4, 20])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("Db", [6, 12])
def test_fused_cr_kernels_match_plain(cuda, Db, n, C):
    """band_cr_reduce and band_cr_backsub, every level in one launch,
    against their plain twins (1e-12) at 1 to 4 levels, coarsest lengths
    1, 2, 64 and 256 (tiles on a chain's start, inside it and at its end)
    and rhs widths on both sides of each step's edge, odd and even, 3D
    1x1000's panel (18), Manhattan-4's (138) and at Db = 6 robot20's (258)."""
    gen = torch.Generator(device=cuda).manual_seed(100 * Db + 10 * n + C)
    Ks = (1, 2, 4, 5, 17, 18, 19, 138) + ((258,) if Db == 6 else ())
    for Tn in (1, 2, 64, 256):
        levels = _random_levels(C, Tn << n, Db, n, gen, cuda)
        for K in Ks:
            b = torch.randn(C, Tn << n, Db, K, generator=gen, dtype=torch.float64, device=cuda)
            _check_fused_cr(levels, b)
    torch.cuda.synchronize()


# Every run of the cells' solves: (chains, fine length, levels, block
# size, panel width): the Monte-Carlo folds (100 trials of 4 x 50; 16
# trials of 3D 4x250), Manhattan-4's two runs, 3D 1x1000's two, robot20,
# 3D 4x250; then an odd width and a chain of two positions
_CELL_RUNS = [(400, 64, 6, 6, 56), (64, 256, 8, 12, 18), (4, 512, 5, 6, 138),
              (4, 16, 4, 6, 138), (1, 1024, 5, 12, 18), (1, 32, 5, 12, 18),
              (20, 128, 7, 6, 258), (4, 256, 8, 12, 18), (4, 16, 4, 6, 19),
              (64, 256, 8, 12, 19), (3, 2, 1, 6, 5), (2, 2, 1, 12, 19)]


@pytest.mark.parametrize("C,T,n,Db,K", _CELL_RUNS)
def test_cr_kernels_at_the_cells_runs(cuda, C, T, n, Db, K):
    """band_cr_reduce and band_cr_backsub at every run a cell's solve
    launches (the chain kernels where they take a run that ends at one
    position a chain, the tile kernels elsewhere), at a direction and the
    panel, against their plain twins (1e-12), in the launches
    band.cr_solve_launches counts (one a chain kernel's run), counted
    under the run; then the chain kernels' plans wherever the routing could
    take the run (band._cr_chain_plan at 1 and 400 chains, forced)."""
    gen = torch.Generator(device=cuda).manual_seed(C + T + n + Db + K)
    levels = _random_levels(C, T, Db, n, gen, cuda)
    sm = band._sm_count(cuda)
    for k in (1, K):
        b = torch.randn(C, T, Db, k, generator=gen, dtype=torch.float64, device=cuda)
        band.reset_launch_counts()
        red = band.band_cr_reduce(levels, b)
        want = band.band_cr_reduce_plain(levels, b)
        assert all(_rel(g, w) <= 1e-12 for g, w in zip(red, want))
        fine, x = (b,) + want[:-1], torch.randn_like(want[-1])
        got = band.band_cr_backsub(levels, fine, x)
        assert _rel(got, band.band_cr_backsub_plain(levels, fine, x)) <= 1e-12
        launches = band.cr_solve_launches(n, Db, k, T >> n, C, sm)
        for kernel, count in zip((band.band_cr_reduce, band.band_cr_backsub), launches):
            assert kernel.launches_by_run == {(Db, T, n): count}
        if T >> n == 1:
            planner = band._cr_chain_plan
            for C_ in (1, 400):
                plans = {step: band._chain_plan(step, n, Db, k, C_, sm)
                         for step in ("reduce", "backsub")}
                try:
                    band._cr_chain_plan = lambda step, *a: plans["reduce" if step == "reduce"
                                                                 else "backsub"]
                    for g, w in zip(band.band_cr_reduce(levels, b), want):
                        assert _rel(g, w) <= 1e-12
                    got = band.band_cr_backsub(levels, fine, x)
                    assert _rel(got, band.band_cr_backsub_plain(levels, fine, x)) <= 1e-12
                finally:
                    band._cr_chain_plan = planner
    torch.cuda.synchronize()


# A band-solve pass of each cell (chains, chain length, block size, panel
# width), then the edges: chains of 2 and 4, one and an odd count of
# chains, and a chain of 2,048 (two runs: the tile kernels, then the chain
# kernels)
_PASS_CELLS = [(4, 512, 6, 138), (20, 128, 6, 258), (4, 256, 12, 18), (1, 1024, 12, 18),
               (400, 64, 6, 56), (64, 256, 12, 18)]
_PASS_EDGES = [(1, 2, 6, 5), (3, 2, 12, 19), (1, 4, 12, 18), (5, 4, 6, 7), (3, 2048, 6, 138),
               (1, 2048, 12, 18), (7, 1024, 6, 19), (3, 32, 12, 17)]


@pytest.mark.parametrize("C,Tp,Db,panel", _PASS_CELLS + _PASS_EDGES)
def test_cr_pass_matches_plain(cuda, C, Tp, Db, panel):
    """One band-solve pass through every level (band._cr_runs: one run on
    chains of up to 1,024) at K = 1, 2, 4, an odd width and the panel:
    band_cr_reduce and band_cr_backsub against their plain twins (1e-12),
    in the launches band.cr_solve_launches counts (one each way where a
    run takes the whole pass), and a second pass on the same stream gives
    the same bits (the tree reduce's counters are zero again after each
    launch)."""
    D, U = _band(C, Tp, Db, 57 + Tp + C, (Tp,) * C, cuda)
    f = band.band_factor(D, U)
    n = len(f.levels)
    runs = band._cr_runs(n)
    gen = torch.Generator(device=cuda).manual_seed(C + Tp + Db)

    def one_pass(b, x):
        fine, first = (b,), 0
        for d in runs:
            fine += band.band_cr_reduce(f.levels[first:first + d], fine[-1])
            first += d
        out = x
        for d in reversed(runs):
            first -= d
            out = band.band_cr_backsub(f.levels[first:first + d], fine[first:first + d], out)
        return fine[1:], out

    for K in sorted({1, 2, 4, 3, panel}):
        b = torch.randn(C, Tp, Db, K, generator=gen, dtype=torch.float64, device=cuda)
        x = torch.randn(C, 1, Db, K, generator=gen, dtype=torch.float64, device=cuda)
        band.reset_launch_counts()
        red, got = one_pass(b, x)
        assert (band.band_cr_reduce.launches, band.band_cr_backsub.launches) == (
            band.cr_solve_launches(n, Db, K, 1, C, band._sm_count(cuda)))
        if Tp <= 1024:
            assert (band.band_cr_reduce.launches, band.band_cr_backsub.launches) == (1, 1)
        want = band.band_cr_reduce_plain(f.levels, b)
        assert all(_rel(g, w) <= 1e-12 for g, w in zip(red, want))
        fine = (b,) + want[:-1]
        assert _rel(got, band.band_cr_backsub_plain(f.levels, fine, x)) <= 1e-12
        red2, got2 = one_pass(b, x)
        assert all(torch.equal(g, w) for g, w in zip(red2, red)) and torch.equal(got2, got)
        assert all(int(t.abs().sum()) == 0 for t in band._TICKETS.values())
    torch.cuda.synchronize()


@pytest.mark.parametrize("C,Tp,Db,K", [(400, 64, 6, 56), (64, 256, 12, 18), (4, 512, 6, 138),
                                       (1, 1024, 12, 18), (20, 128, 6, 258), (4, 256, 12, 18)])
def test_band_solve_launches_as_counted(cuda, C, Tp, Db, K):
    """A band solve at each cell's band shape launches the CR kernels as
    band.cr_solve_launches counts them (a pass, and a second for a 3D
    refinement step), and matches the CPU's solve (1e-12)."""
    D, U = _band(C, Tp, Db, 91 + Tp, (Tp,) * C, cuda)
    f = band.band_factor(D, U)
    fc = band.band_factor(D.cpu(), U.cpu())
    for k in (1, K):
        b = torch.randn(C, Tp, Db, k, dtype=torch.float64, device=cuda)
        band.reset_launch_counts()
        x = band.band_solve(f, b)
        passes = 1 + band.refine_steps(Db)
        want = band.cr_solve_launches(len(f.levels), Db, k, 1, C, band._sm_count(cuda))
        assert (band.band_cr_reduce.launches, band.band_cr_backsub.launches) == (
            want[0] * passes, want[1] * passes)
        assert _rel(x.cpu(), band.band_solve(fc, b.cpu())) <= 1e-12
    torch.cuda.synchronize()


def _dense_chain(D, U, c):
    """Chain c of the band (D, U) as a dense matrix on D's device."""
    Tp, Db = D.shape[1], D.shape[-1]
    M = torch.zeros(Tp * Db, Tp * Db, dtype=torch.float64, device=D.device)
    for i in range(Tp):
        M[Db * i:Db * (i + 1), Db * i:Db * (i + 1)] = D[c, i]
        if i + 1 < Tp:
            M[Db * i:Db * (i + 1), Db * (i + 1):Db * (i + 2)] = U[c, i]
            M[Db * (i + 1):Db * (i + 2), Db * i:Db * (i + 1)] = U[c, i].T
    return M


@pytest.mark.parametrize("Db,C,Tp,n_cr", [(6, 1, 1024, 2), (6, 1, 2048, 3), (6, 4, 512, 2),
                                          (12, 1, 1024, 2), (12, 2, 256, 3)])
def test_band_solve_at_two_and_three_levels(cuda, Db, C, Tp, n_cr):
    """band_solve with two and three compacting levels against a dense
    solve of each chain (1e-11), one launch of each CR kernel a solve (two
    for 3D blocks: a refinement step solves again)."""
    D, U = _band(C, Tp, Db, 75 + Tp, (Tp,) * C, cuda)
    f = band.band_factor(D, U, n_cr=n_cr)
    assert len(f.levels) == n_cr
    for K in (1, 18):
        b = torch.randn(C, Tp, Db, K, dtype=torch.float64, device=cuda)
        band.reset_launch_counts()
        x = band.band_solve(f, b)
        solves = 1 + band.refine_steps(Db)
        assert band.band_cr_reduce.launches == band.band_cr_backsub.launches == solves
        assert band.band_pcr_solve.launches == solves
        for c in range(C):
            xref = torch.linalg.solve(_dense_chain(D, U, c), b[c].reshape(Tp * Db, K))
            assert _rel(x[c].reshape(Tp * Db, K), xref) <= 1e-11


@pytest.mark.parametrize("Db", [6, 12])
def test_band_solve_past_a_launch_of_levels(cuda, Db, monkeypatch):
    """With the compaction floor at 1 and a launch cut to 8 levels (it takes
    10), a chain of 512 compacts 9 times, one level more than a launch
    takes: the solve runs the reduce and the back substitution twice each
    (5 and 4 levels, the first on the tile kernels; again for a 3D
    refinement step) and matches a dense solve (1e-11) at a direction and
    the 3D panel's width."""
    monkeypatch.setattr(band, "CR_BASE_LENGTH", 1)
    monkeypatch.setattr(band, "_CR_MAX_LEVELS", 8)
    Tp = 512
    D, U = _band(1, Tp, Db, 77, (Tp,), cuda)
    f = band.band_factor(D, U)
    assert len(f.levels) == 9 > band._CR_MAX_LEVELS
    M = _dense_chain(D, U, 0)
    for K in (1, 18):
        b = torch.randn(1, Tp, Db, K, dtype=torch.float64, device=cuda)
        band.reset_launch_counts()
        x = band.band_solve(f, b)
        solves = 1 + band.refine_steps(Db)
        assert band.band_cr_reduce.launches == band.band_cr_backsub.launches == 2 * solves
        assert band.band_pcr_solve.launches == solves
        xref = torch.linalg.solve(M, b[0].reshape(Tp * Db, K))
        assert _rel(x[0].reshape(Tp * Db, K), xref) <= 1e-11


@pytest.mark.parametrize("Db", [6, 12])
@pytest.mark.parametrize("M", [1, 2, 3, 7, 17, 256, 512, 1024, 2560])
def test_block_inv_matches_plain(cuda, Db, M):
    """band_block_inv (at Db = 6 a lane group per block, 16 blocks a thread
    block, the last one not full for most M; at Db = 12 a thread block of
    144 threads a block) against its plain version, 1e-12, and as an
    inverse; M = 256 and 1024 are 3D 1x1000's and 3D 4x250's PCR
    remainders (C = 1 and 4 chains of 256)."""
    D, _ = _band(1, M, Db, 74 + M, (M,), cuda)
    inv = band.band_block_inv(D)
    assert _rel(inv, band.band_block_inv_plain(D)) <= 1e-12
    eye = torch.eye(Db, dtype=torch.float64, device=cuda).expand_as(D)
    assert _rel(inv @ D, eye) <= 1e-12
    torch.cuda.synchronize()


def test_element_inverse_agrees_bit_for_bit_3d(cuda):
    """The three kernels that share csrc/band.cu's element inverse at
    Db = 12 agree bit for bit: band_block_inv of a PCR level's D' is the
    level's invD', and band_cr_level's inverses of the odd rows are
    band_block_inv of the odd rows."""
    D, U = _band(2, 64, 12, 76, (64, 50), cuda)
    A, invD = band.band_init_a(U), band.band_block_inv(D)
    for s in (1, 8):
        out = band.band_pcr_level(D, A, U, invD, s)
        assert torch.equal(band.band_block_inv(out[2]), out[5])
    lv = band.band_cr_level(D, A, U)
    assert torch.equal(lv[2], band.band_block_inv(D[:, 1::2].contiguous()))
    torch.cuda.synchronize()


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_cuda_solve_3d_matches_cpu(cuda, relaxation, monkeypatch):
    """A 2 x 30 3D world with a loop closure its odometry does not agree
    with (a sharp optimum, objective ~5e3; without it the relaxation fits
    every range and the rounded poses of two solves differ by ~3e-5), on
    the card against the CPU path: the 3D band (chains of 32 compacted
    twice, then PCR) launches every kernel of its path at Db = 12 (a
    band_cr_level launch a level: band_cr_factor takes no 3D factor); same
    iterations
    within 1, objectives within 1e-9 relative, rounded poses within 1e-5."""
    monkeypatch.setattr(band, "CR_BASE_LENGTH", 8)
    fg = simulate_3d_world(World3DParams(num_robots=2, num_poses_per_robot=30,
                                         num_landmarks=4, range_measure_prob=0.4, seed=3))
    fg.loop_closure_measurements.append(PoseMeasurement3D(
        "A3", "A25", np.array([1.0, -2.0, 0.5]), np.eye(3), 100.0, 1000.0, 0.0))
    band.reset_launch_counts()
    gpu = solve_score(fg, relaxation, ScoreSolverParams(device="cuda"))
    assert band.band_cr_factor.launches == 0
    assert all(k.launches_by_size[12] > 0 for k in band.KERNELS if k is not band.band_cr_factor)
    cpu = solve_score(fg, relaxation, ScoreSolverParams(device="cpu"))
    assert gpu.solved and cpu.solved and abs(gpu.iterations - cpu.iterations) <= 1
    assert abs(gpu.primal_objective - cpu.primal_objective) <= 1e-9 * abs(cpu.primal_objective)
    for name, T in cpu.poses.items():
        assert gpu.poses[name].shape == (4, 4)
        np.testing.assert_allclose(gpu.poses[name], T, atol=1e-5, rtol=0)


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_f32_cuda_solve_3d_matches_cpu(cuda, relaxation):
    """precision="f32" on the 2 x 30 3D world with a loop closure, on the
    card against the port's f32 CPU path: both solved, iterations within
    3, objectives within 2e-2 relative; the block kernels launched at
    D = 12 (the band) and, for QCQP, D = 3 (the distance pivots), and the
    forward-only kernel never."""
    fg = simulate_3d_world(World3DParams(num_robots=2, num_poses_per_robot=30,
                                         num_landmarks=4, range_measure_prob=0.4, seed=3))
    fg.loop_closure_measurements.append(PoseMeasurement3D(
        "A3", "A25", np.array([1.0, -2.0, 0.5]), np.eye(3), 100.0, 1000.0, 0.0))
    blocks.reset_launch_counts()
    gpu = solve_score(fg, relaxation, ScoreSolverParams(device="cuda", precision="f32"))
    _assert_fused_path()
    sizes = (12, 3) if relaxation == "QCQP" else (12,)
    for k in (blocks.block_chol, blocks.block_chol_solve):
        assert all(k.launches_by_size[D] > 0 for D in sizes)
    cpu = solve_score(fg, relaxation, ScoreSolverParams(device="cpu", precision="f32"))
    assert gpu.solved and cpu.solved
    assert abs(gpu.iterations - cpu.iterations) <= 3
    assert abs(gpu.primal_objective - cpu.primal_objective) <= 2e-2 * abs(cpu.primal_objective)
    for P in gpu.poses.values():
        assert abs(np.linalg.det(P[:3, :3]) - 1.0) < 1e-5


@pytest.mark.parametrize("Db,n,depths", [(12, 6, [5, 1]), (6, 8, [7, 1])])
def test_fused_cr_kernels_past_one_launch(cuda, Db, n, depths):
    """A reduce deeper than a thread block's shared memory holds in one
    launch (the halo blocks of 6 levels at Db = 12, of 8 at Db = 6) runs
    the levels in runs of band._cr_launch_depths, one launch a run, and
    still matches the plain twins (1e-12)."""
    assert band._cr_launch_depths("reduce", n, Db, 18) == depths
    gen = torch.Generator(device=cuda).manual_seed(7 * n + Db)
    levels = _random_levels(2, 4 << n, Db, n, gen, cuda)
    for K in (1, 18):
        b = torch.randn(2, 4 << n, Db, K, generator=gen, dtype=torch.float64, device=cuda)
        band.reset_launch_counts()
        red = band.band_cr_reduce(levels, b)
        want = band.band_cr_reduce_plain(levels, b)
        assert all(_rel(g, w) <= 1e-12 for g, w in zip(red, want))
        assert band.band_cr_reduce.launches == len(depths)
        fine = (b,) + want[:-1]
        x = torch.randn_like(want[-1])
        got = band.band_cr_backsub(levels, fine, x)
        assert _rel(got, band.band_cr_backsub_plain(levels, fine, x)) <= 1e-12
        step = band._backsub_step(Db, K)
        assert band.band_cr_backsub.launches == len(band._cr_launch_depths(step, n, Db, K))
    torch.cuda.synchronize()


def _graph_2x25():
    return simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1))


def _same_digits(a, b):
    assert (a.solved, a.iterations, a.primal_objective, a.gap, a.primal_residual,
            a.dual_residual) == (b.solved, b.iterations, b.primal_objective, b.gap,
                                 b.primal_residual, b.dual_residual)
    for name, T in a.poses.items():
        np.testing.assert_array_equal(b.poses[name], T)


def test_memo_hit_on_cuda_repeats_digits(cuda, monkeypatch):
    """The second solve of a graph on the card assembles nothing and
    repeats the first solve's digits (no backend writes the memoized
    prepared state in place)."""
    from score_tpu_torch import api

    monkeypatch.setattr(api, "_ASSEMBLY_CACHE", {})
    builds = []
    build = api.build_conic_problem
    monkeypatch.setattr(api, "build_conic_problem",
                        lambda *a, **k: builds.append(1) or build(*a, **k))
    fg = _graph_2x25()
    for relaxation in ("SOCP", "QCQP"):
        first = solve_score(fg, relaxation, ScoreSolverParams(device="cuda"))
        second = solve_score(fg, relaxation, ScoreSolverParams(device="cuda"))
        assert first.solved
        _same_digits(first, second)
    assert len(builds) == 2


def test_memo_keeps_cpu_and_cuda_entries_apart(cuda, monkeypatch):
    from score_tpu_torch import api

    monkeypatch.setattr(api, "_ASSEMBLY_CACHE", {})
    fg = _graph_2x25()
    on_card = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda"))
    on_cpu = solve_score(fg, "SOCP", ScoreSolverParams(device="cpu"))
    (_, entries), = api._ASSEMBLY_CACHE.values()
    devices = {key[-1].type: entry[2].device.type for key, entry in entries.items()}
    assert devices == {"cuda": "cuda", "cpu": "cpu"}
    assert on_card.solved and on_cpu.solved
    assert abs(on_card.iterations - on_cpu.iterations) <= 1
    assert abs(on_card.primal_objective - on_cpu.primal_objective) <= 1e-9 * abs(
        on_cpu.primal_objective)
    _same_digits(on_card, solve_score(fg, "SOCP", ScoreSolverParams(device="cuda")))


@pytest.mark.parametrize("relaxation", ["SOCP", "QCQP"])
def test_dense_backend_on_cuda_matches_chain_arrow(cuda, relaxation):
    fg = _graph_2x25()
    dense = solve_score(fg, relaxation, ScoreSolverParams(device="cuda", backend="dense"))
    chain = solve_score(fg, relaxation, ScoreSolverParams(device="cuda"))
    cpu = solve_score(fg, relaxation, ScoreSolverParams(device="cpu", backend="dense"))
    assert dense.solved and chain.solved
    assert abs(dense.primal_objective - chain.primal_objective) <= dense.gap + chain.gap
    assert abs(dense.iterations - cpu.iterations) <= 1
    assert abs(dense.primal_objective - cpu.primal_objective) <= 1e-9 * abs(cpu.primal_objective)


def test_pickle_round_trip_solves_on_cuda(cuda, tmp_path):
    from score_tpu_torch.fg import parse_pickle_file, save_to_pickle_file

    fg = _graph_2x25()
    path = tmp_path / "graph.pkl"
    save_to_pickle_file(fg, str(path))
    parsed = parse_pickle_file(str(path))
    assert parsed.summary() == fg.summary()
    params = ScoreSolverParams(device="cuda")
    _same_digits(solve_score(fg, "SOCP", params), solve_score(parsed, "SOCP", params))


def _refine_world(dim):
    """A 1 x 10 Manhattan world (the JAX package's refinement tests' seed
    3) or a 2 x 15 3D world, and its rounded SOCP solution on the CPU."""
    if dim == 2:
        fg = simulate_manhattan_world(ManhattanWorldParams(
            num_robots=1, num_poses_per_robot=10, num_landmarks=2, grid_size=4,
            range_measure_prob=0.5, seed=3))
    else:
        fg = simulate_3d_world(World3DParams(num_robots=2, num_poses_per_robot=15,
                                             num_landmarks=3, seed=3))
    return fg, solve_score(fg, "SOCP", ScoreSolverParams(device="cpu", max_iter=40)).variables


@pytest.mark.parametrize("dim, robust, max_iter", [(2, "none", 60), (2, "gm", 60), (3, "none", 10)])
def test_refine_on_cuda_matches_cpu(cuda, dim, robust, max_iter):
    """The refinement on the card against the port's CPU refinement of the
    same start: equal iterations, costs within 1e-8 relative, poses within
    1e-6, rotations in SO(d) to 1e-9; one host synchronization an outer
    iteration (the stall counter), plus the start's upload and the result's
    copy back, counted through ``torch.cuda.set_sync_debug_mode``."""
    import warnings

    from score_tpu_torch import RefineParams, refine_solution

    fg, start = _refine_world(dim)
    params = RefineParams(robust=robust, max_iter=max_iter)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            gpu = refine_solution(fg, start, params, device="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    cpu = refine_solution(fg, start, params, device="cpu")
    assert gpu.iterations == cpu.iterations
    assert abs(gpu.initial_cost - cpu.initial_cost) <= 1e-8 * cpu.initial_cost
    assert abs(gpu.cost - cpu.cost) <= 1e-8 * cpu.cost
    assert gpu.cost < gpu.initial_cost
    for name, T in cpu.values.poses.items():
        assert np.abs(gpu.values.poses[name] - T).max() <= 1e-6
        R = gpu.values.poses[name][:dim, :dim]
        assert np.abs(R.T @ R - np.eye(dim)).max() <= 1e-9
        assert abs(np.linalg.det(R) - 1.0) <= 1e-9
    assert gpu.iterations <= syncs <= gpu.iterations + 16


def test_solve_score_refine_on_cuda(cuda):
    """solve_score(refine=True) on the card: the solve's digits those of the
    plain solve, the refined poses those of refine_solution on the card
    within roundoff (index_add_ sums in the order its atomics land)."""
    from score_tpu_torch import RefineParams, refine_solution

    fg, _ = _refine_world(2)
    params = ScoreSolverParams(device="cuda", max_iter=40)
    plain = solve_score(fg, "SOCP", params)
    refined = solve_score(fg, "SOCP", ScoreSolverParams(device="cuda", max_iter=40, refine=True))
    assert (plain.solved, plain.iterations, plain.primal_objective, plain.gap) == (
        refined.solved, refined.iterations, refined.primal_objective, refined.gap)
    direct = refine_solution(fg, plain.variables, RefineParams(), device="cuda")
    for name, T in direct.values.poses.items():
        assert np.abs(refined.poses[name] - T).max() <= 1e-6


def test_band_kernels_at_the_mc_fold(cuda):
    """The four PCR kernels at the shape the 100-trial Monte-Carlo batch
    folds its band into (C = 400 chains of Tp = 64, Db = 6), each call
    against its plain twin (1e-12 relative, as at the other shapes), the
    solve at a direction and at the arrow panel (K = 56), one launch a
    call."""
    C, Tp, K = 400, 64, 56
    D, U = _band(C, Tp, 6, 64, (50,) * C, cuda)
    band.reset_launch_counts()
    A = band.band_init_a(U)
    assert _rel(A, band.band_init_a_plain(U)) == 0.0
    invD = band.band_block_inv(D)
    assert _rel(invD, band.band_block_inv_plain(D)) <= 1e-12
    Cl, Es, Fs = U, [], []
    for lev in range(band.num_levels(Tp)):
        out = band.band_pcr_level(D, A, Cl, invD, 1 << lev)
        for got, want in zip(out, band.band_pcr_level_plain(D, A, Cl, invD, 1 << lev)):
            assert _rel(got, want) <= 1e-12
        E, F, D, A, Cl, invD = out
        Es.append(E)
        Fs.append(F)
    E, F = torch.stack(Es), torch.stack(Fs)
    for k in (1, K):
        b = torch.randn(C, Tp, 6, k, dtype=torch.float64, device=cuda)
        assert _rel(band.band_pcr_solve(E, F, invD, b),
                    band.band_pcr_solve_plain(E, F, invD, b)) <= 1e-12
    torch.cuda.synchronize()
    assert (band.band_init_a.launches, band.band_block_inv.launches,
            band.band_pcr_level.launches, band.band_pcr_solve.launches) == (
        1, 1, band.num_levels(Tp), 2)


def _mc_batch(seeds, device, dtype=torch.float64):
    """Trials of the Monte-Carlo bench world (4 x 50 poses) on ``device``,
    cast to ``dtype`` after assembly: the stacked problem and the
    chain+arrow structure."""
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.parallel import stack_problems
    from score_tpu_torch.sim.manhattan import resample_measurements
    from score_tpu_torch.solver.chain_arrow import build_chain_arrow

    base = simulate_manhattan_world(ManhattanWorldParams(
        num_robots=4, num_poses_per_robot=50, num_landmarks=4, grid_size=10,
        range_measure_prob=0.4, seed=0))
    trials = [resample_measurements(base, seed=s) for s in seeds]
    problems = [build_conic_problem(t, "SOCP", device=device)[0].cast(dtype) for t in trials]
    idx = build_conic_problem(trials[0], "SOCP", device=device)[1]
    return stack_problems(problems), build_chain_arrow(problems[0], idx)


def test_cuda_batch_matches_cpu(cuda):
    """An 8-trial batch on the card against the port's CPU batch, lane by
    lane: the same status, iterations within 1, pobj within 1e-9 relative,
    the trips within 1; the fold's band kernels launched (compacted to one
    block: every kernel of that path, :func:`_off_the_default_path`)."""
    import dataclasses

    from score_tpu_torch.parallel.batch import _solve_batch_trips
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend
    from score_tpu_torch.solver.ipm import IPMParams

    params = dataclasses.replace(IPMParams(max_iter=20), gondzio_correctors=0)
    batch, ca = _mc_batch(range(8), cuda)
    band.reset_launch_counts()
    gpu, trips_g = _solve_batch_trips(batch, params, ChainArrowBackend, ca)
    launched = {k.__name__: k.launches for k in band.KERNELS if k.launches}
    batch, ca = _mc_batch(range(8), "cpu")
    cpu, trips_c = _solve_batch_trips(batch, params, ChainArrowBackend, ca)
    assert gpu.status.cpu().tolist() == cpu.status.tolist()
    assert (gpu.iterations.cpu() - cpu.iterations).abs().max().item() <= 1
    assert abs(trips_g - trips_c) <= 1
    assert ((gpu.pobj.cpu() - cpu.pobj).abs() / cpu.pobj.abs()).max().item() <= 1e-9
    assert set(launched) == {k.__name__ for k in band.KERNELS} - _off_the_default_path(6)


@pytest.mark.parametrize("C,Tp,Db,K", [(400, 64, 6, 56), (64, 256, 12, 18)])
def test_default_schedule_at_the_batch_folds(cuda, C, Tp, Db, K):
    """The band at its default schedule (compacted to one block) at the
    folds of the 100-trial Monte-Carlo batch (C = 400 chains of 64, Db = 6,
    panel 56) and of the 16-trial 3D 4x250 batch (C = 64 chains of 256,
    Db = 12, panel 18): factor and solve on the card against the plain
    twins on the CPU (1e-12 relative), every kernel of the path launched
    (:func:`_off_the_default_path`), and the band satisfied (1e-10)."""
    D, U = _band(C, Tp, Db, 66, (Tp - 7,) * C, cuda)
    band.reset_launch_counts()
    f = band.band_factor(D, U)
    for k in (1, K):
        b = torch.randn(C, Tp, Db, k, dtype=torch.float64, device=cuda)
        x = band.band_solve(f, b)
        want = band.band_solve(band.band_factor(D.cpu(), U.cpu()), b.cpu())
        assert _rel(x.cpu(), want) <= 1e-12
        assert ((band.band_matvec(D, U, x) - b).abs().max() / b.abs().max()).item() <= 1e-10
    torch.cuda.synchronize()
    assert len(f.levels) == band.num_levels(Tp) and f.E.shape[0] == 0
    assert {k.__name__ for k in band.KERNELS if k.launches_by_size[Db]} == (
        {k.__name__ for k in band.KERNELS} - _off_the_default_path(Db))


def _f32_lanes_agree(gpu, cpu, trips, max_iter):
    """An f32 batch on the card against the CPU's: the same status, pobj
    within 2e-2 * max(1, |pobj|) (the f32 bounds); lanes that end OPTIMAL
    within 3 iterations and the trips within 3 where every lane does. A
    lane that ends OPTIMAL_INACCURATE stops on the f32 dual-residual floor
    by the stall counter, at a trip that follows the roundoff (the
    Monte-Carlo world's fourth trial: 19 iterations on the card and in the
    JAX package's CPU batch, 15 in the port's CPU batch): at most
    ``max_iter``."""
    status = cpu.status.tolist()
    assert gpu.status.cpu().tolist() == status
    assert all(s in (1, 4) for s in status)
    diff = (gpu.iterations.cpu() - cpu.iterations).abs()
    assert all(d <= 3 for d, s in zip(diff.tolist(), status) if s == 1)
    assert gpu.iterations.max().item() <= max_iter and max(trips) <= max_iter
    if all(s == 1 for s in status):
        assert abs(trips[0] - trips[1]) <= 3
    assert ((gpu.pobj.cpu() - cpu.pobj).abs() <= 2e-2 * cpu.pobj.abs().clamp_min(1.0)).all()


def test_cuda_f32_batch_matches_cpu(cuda):
    """Four trials of the Monte-Carlo world cast to float32 at the f32
    mode's tolerances, on the card against the port's CPU batch
    (:func:`_f32_lanes_agree`); the f32 band's block kernels launched at
    D = 6, no f64 band kernel."""
    from score_tpu_torch.parallel.batch import _solve_batch_trips
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend

    params = ScoreSolverParams(precision="f32", max_iter=20, gondzio_correctors=0).ipm_params()
    out = {}
    for dev in (cuda, "cpu"):
        batch, ca = _mc_batch(range(4), dev, torch.float32)
        band.reset_launch_counts()
        blocks.reset_launch_counts()
        out[str(dev)] = _solve_batch_trips(batch, params, ChainArrowBackend, ca)
        if dev is cuda:
            torch.cuda.synchronize()
            assert all(k.launches == 0 for k in band.KERNELS)
            _assert_fused_path()
            assert blocks.block_chol_solve.launches_by_size[6] > 0
    (gpu, trips_g), (cpu, trips_c) = out[str(cuda)], out["cpu"]
    assert gpu.x.dtype == torch.float32 and torch.isfinite(gpu.x).all()
    _f32_lanes_agree(gpu, cpu, (trips_g, trips_c), params.max_iter)


@pytest.mark.parametrize("precision", ["f64", "f32"])
def test_cuda_3d_batch_matches_cpu(cuda, precision):
    """Four trials of the 2 x 30 3D world with its loop closure (ranges
    redrawn, ``tests/torch_reference_data.resample_ranges``; objective
    ~5e3), SOCP, on the card against the port's CPU batch: f64 through the
    band kernels at Db = 12 (the same status, iterations within 1, pobj
    within 1e-9 relative), f32 through the block kernels at D = 12
    (:func:`_f32_lanes_agree`)."""
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.parallel import stack_problems
    from score_tpu_torch.parallel.batch import _solve_batch_trips
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow

    fg = simulate_3d_world(World3DParams(num_robots=2, num_poses_per_robot=30,
                                         num_landmarks=4, range_measure_prob=0.4, seed=3))
    fg.loop_closure_measurements.append(PoseMeasurement3D(
        "A3", "A25", np.array([1.0, -2.0, 0.5]), np.eye(3), 100.0, 1000.0, 0.0))
    trials = [_reference_data().resample_ranges(fg, s) for s in range(4)]
    dtype = torch.float32 if precision == "f32" else torch.float64
    params = ScoreSolverParams(precision=precision).ipm_params()
    out = {}
    for dev in (cuda, "cpu"):
        problems = [build_conic_problem(t, "SOCP", device=dev)[0].cast(dtype) for t in trials]
        idx = build_conic_problem(trials[0], "SOCP", device=dev)[1]
        band.reset_launch_counts()
        blocks.reset_launch_counts()
        out[str(dev)] = _solve_batch_trips(stack_problems(problems), params, ChainArrowBackend,
                                           build_chain_arrow(problems[0], idx))
        if dev is cuda:
            torch.cuda.synchronize()
            if precision == "f64":
                assert {k.__name__ for k in band.KERNELS if k.launches_by_size[12]} == (
                    {k.__name__ for k in band.KERNELS} - _off_the_default_path(12))
            else:
                assert all(k.launches == 0 for k in band.KERNELS)
                _assert_fused_path()
                assert blocks.block_chol_solve.launches_by_size[12] > 0
    (gpu, trips_g), (cpu, trips_c) = out[str(cuda)], out["cpu"]
    if precision == "f32":
        _f32_lanes_agree(gpu, cpu, (trips_g, trips_c), params.max_iter)
        return
    assert gpu.status.cpu().tolist() == cpu.status.tolist()
    assert all(s in (1, 4) for s in cpu.status.tolist())
    assert (gpu.iterations.cpu() - cpu.iterations).abs().max().item() <= 1
    assert abs(trips_g - trips_c) <= 1
    assert ((gpu.pobj.cpu() - cpu.pobj).abs() <= 1e-9 * cpu.pobj.abs()).all()


@pytest.mark.parametrize("backend", ["dense", "chain_arrow"])
def test_cuda_trace_matches_cpu(cuda, backend):
    """``solve_conic_traced`` of the 2 x 25 world (SOCP, normalized) on the
    card against the port's CPU trace: (16, 13) metrics on the card, the
    same status, iterations within 1, pobj within 1e-9 relative on every
    row, pres and dres within 1e-6 relative plus 1e-10, the gap within
    1e-6 relative plus 1e-9 * max(1, |pobj|), the diagnostics within 1e-6 *
    max(1, |value|) (the CPU tests' bounds against the JAX package); the
    traced result bit-equal to the card's untraced fixed-trip solve."""
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.assembly.normalize import normalize_factor_graph
    from score_tpu_torch.solver import solve_conic_traced
    from score_tpu_torch.solver.backend import DenseBackend
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu_torch.solver.ipm import solve_conic_fixed

    fg = normalize_factor_graph(simulate_manhattan_world(ManhattanWorldParams(
        num_robots=2, num_poses_per_robot=25, num_landmarks=3, grid_size=8,
        range_measure_prob=0.4, seed=1)))[0]
    params = ScoreSolverParams().ipm_params()
    be = DenseBackend if backend == "dense" else ChainArrowBackend
    out = {}
    for dev in (cuda, "cpu"):
        pp, idx = build_conic_problem(fg, "SOCP", device=dev)
        aux = None if backend == "dense" else build_chain_arrow(pp, idx)
        out[str(dev)] = solve_conic_traced(pp, params, num_iters=16, backend=be, backend_aux=aux)
        if dev is cuda:
            fixed = solve_conic_fixed(pp, params, num_iters=16, backend=be, backend_aux=aux)
    (gpu, gm), (cpu, cm) = out[str(cuda)], out["cpu"]
    assert gm.is_cuda and gm.shape == (16, 13)
    assert (fixed.status, fixed.iterations, fixed.pobj) == (gpu.status, gpu.iterations, gpu.pobj)
    assert torch.equal(fixed.x, gpu.x)
    assert gpu.status == cpu.status and abs(gpu.iterations - cpu.iterations) <= 1
    m, ref = gm.cpu().numpy(), cm.numpy()
    rows = 16 if gpu.iterations == cpu.iterations else min(gpu.iterations, cpu.iterations)
    m, ref = m[:rows], ref[:rows]
    np.testing.assert_allclose(m[:, 3], ref[:, 3], rtol=1e-9, atol=0)
    np.testing.assert_allclose(m[:, :2], ref[:, :2], rtol=1e-6, atol=1e-10)
    gap_tol = 1e-6 * np.abs(ref[:, 2]) + 1e-9 * np.maximum(1.0, np.abs(ref[:, 3]))
    assert np.all(np.abs(m[:, 2] - ref[:, 2]) <= gap_tol)
    assert np.all(np.abs(m[:, 5:] - ref[:, 5:]) <= 1e-6 * np.maximum(1.0, np.abs(ref[:, 5:])))


# the 20 x 12 world of the chain-sharded checks (tests/test_torch_parallel.py)
SHARDED_WORLD = dict(num_robots=20, num_poses_per_robot=12, num_landmarks=4, grid_size=10,
                     range_measure_prob=0.35, inter_robot_measure_prob=0.1,
                     inter_robot_sensing_radius=10.0, seed=3)


def _chain_sharded_on(device):
    """A rank's chain-sharded SOCP solve of ``SHARDED_WORLD`` (run_ranks)
    and the band kernels' launches on the rank."""
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.parallel import solve_conic_chain_sharded
    from score_tpu_torch.solver.ipm import IPMParams

    problem, idx = build_conic_problem(
        simulate_manhattan_world(ManhattanWorldParams(**SHARDED_WORLD)), "SOCP", device=device)
    band.reset_launch_counts()
    res = solve_conic_chain_sharded(problem, idx, IPMParams(max_iter=40))
    return res, {k.__name__: k.launches for k in band.KERNELS}


def test_world2_gloo_chain_sharded_solve_on_one_card(cuda):
    """Two ranks over gloo, both on the one card (10 chains a rank), held
    to the unsharded card solve: the same status and iterations, pobj
    within 1e-9 relative, or, where |pobj| < 1e-3, within the unsharded
    final gap if that is larger (PERF.md section 2's parity rule; the
    world's optimum sits near 0), x within 1e-4; each rank ran the band
    kernels."""
    from score_tpu_torch.assembly.conic import build_conic_problem
    from score_tpu_torch.parallel import run_ranks
    from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
    from score_tpu_torch.solver.ipm import IPMParams, solve_conic

    got, launches = run_ranks(_chain_sharded_on, world=2, device="cuda", backend="gloo",
                              timeout=300)
    problem, idx = build_conic_problem(
        simulate_manhattan_world(ManhattanWorldParams(**SHARDED_WORLD)), "SOCP", device=cuda)
    want = solve_conic(problem, IPMParams(max_iter=40), backend=ChainArrowBackend,
                       backend_aux=build_chain_arrow(problem, idx))
    assert (got.status, got.iterations) == (want.status, want.iterations)
    tol = 1e-9 * abs(want.pobj)
    assert abs(got.pobj - want.pobj) <= (max(tol, want.gap) if abs(want.pobj) < 1e-3 else tol)
    assert (got.x - want.x.cpu()).abs().max().item() <= 1e-4
    # robot20's 2D factor runs in band_cr_factor launches
    assert launches["band_cr_factor"] > 0 and launches["band_cr_reduce"] > 0
    assert launches["band_cr_level"] == 0


def test_kernels_launch_on_the_current_stream(cuda):
    """A band kernel and a block kernel launched under a side stream that
    is still busy (a sleep, then the copy of the inputs into zeroed
    buffers): only a launch on that stream waits for the copy, so the
    outputs agree with the plain versions after the side stream's own
    synchronize (a launch on the default stream would read the zeros)."""
    D, _ = _band(4, 64, 6, 61, (64, 64, 30, 5), cuda)
    A = D.reshape(-1, 6, 6).float().contiguous()
    want = band.band_block_inv_plain(D)
    torch.cuda.synchronize(cuda)
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        Dz, Az = torch.zeros_like(D), torch.zeros_like(A)
        torch.cuda._sleep(100_000_000)
        Dz.copy_(D)
        Az.copy_(A)
        invD = band.band_block_inv(Dz)
        L = blocks.block_chol(Az)
    side.synchronize()
    assert _rel(invD, want) <= 1e-12
    assert _rel(L @ L.transpose(-1, -2), A) <= 1e-5


def test_kernels_launch_on_their_tensors_device(cuda):
    """A band kernel and a block kernel on cuda:1 while cuda:0 is current:
    each launches on its tensors' device and stream and agrees with its
    plain version."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: tensors on cuda:1 while cuda:0 is current")
    other = torch.device("cuda", 1)
    torch.cuda.set_device(0)
    D, U = _band(4, 64, 6, 61, (64, 64, 30, 5), other)
    launches = band.band_block_inv.launches
    invD = band.band_block_inv(D)
    assert invD.device == other and band.band_block_inv.launches == launches + 1
    assert _rel(invD, band.band_block_inv_plain(D)) <= 1e-12
    A = D.reshape(-1, 6, 6).float().contiguous()
    L = blocks.block_chol(A)
    assert L.device == other
    assert _rel(L @ L.transpose(-1, -2), A) <= 1e-5
    assert torch.cuda.current_device() == 0


# ------------------------------------------------------------------ #
# band_cr_factor: a factor's compacting levels in one or two launches
# ------------------------------------------------------------------ #

# (chains, chain length, block size): the cells' factors (Manhattan-4,
# robot20, 3D 4x250, 3D 1x1000, the 2D and 3D folds), then the edges:
# chains of 2 and 4 (one run, no halo), one chain and an odd chain count,
# chains of 2048 (two runs at Db = 6; at Db = 12 a level a launch, the
# first ones 3 positions a thread block)
_FACTOR_SHAPES = [(4, 512, 6), (20, 128, 6), (4, 256, 12), (1, 1024, 12), (400, 64, 6),
                  (64, 256, 12), (3, 2, 6), (3, 2, 12), (1, 4, 6), (5, 4, 12), (7, 64, 12),
                  (1, 2048, 6), (3, 2048, 12)]


@pytest.mark.parametrize("C,Tp,Db", _FACTOR_SHAPES)
def test_cr_factor_matches_plain(cuda, C, Tp, Db):
    """Every run of band_cr_factor's plan of a factor (band._factor_runs:
    at most two) against its plain twin on the same inputs, each fed the
    kernel's outputs of the run before, 1e-12 on every output (each level's
    E, F, invD, A, C, the band it leaves or the last invD); band_factor
    against the CPU's, in the launches band.factor_launches counts: the
    runs alone at Db = 6, a band_cr_level launch a level and band_block_inv
    at Db = 12 (band._factor_takes)."""
    D, U = _band(C, Tp, Db, 80 + Tp + Db, (Tp,) * C, cuda)
    A = band.band_init_a(U)
    runs = band._factor_runs(Tp, Db) if band._factor_takes(Db) else []
    Dl, Al, Cl, T = D, A, U, Tp
    for n in runs:
        run = _check_factor_run(Dl, Al, Cl, n, last=T >> n == 1)
        T >>= n
        if T > 1:
            Dl, Al, Cl = run.D, run.A, run.C
    band.reset_launch_counts()
    f = band.band_factor(D, U)
    torch.cuda.synchronize()
    counted = (band.band_cr_factor.launches_by_size[Db] + band.band_cr_level.launches_by_size[Db]
               + band.band_block_inv.launches_by_size[Db])
    assert counted == band.factor_launches(Tp, Db)
    if band._factor_takes(Db):
        assert band.band_cr_factor.launches == len(runs)
        assert band.band_cr_level.launches == band.band_block_inv.launches == 0
    else:
        assert band.band_cr_factor.launches == 0
        assert band.band_cr_level.launches == band.num_levels(Tp)
    fc = band.band_factor(D.cpu(), U.cpu())
    for got, want in zip(f.levels, fc.levels):
        for g, w in zip(got, want):
            assert _rel(g.cpu(), w) <= 1e-12
    assert _rel(f.invD.cpu(), fc.invD) <= 1e-12


@pytest.mark.parametrize("C,Tp,Db,n_cr", [(3, 64, 6, 3), (2, 128, 12, 4), (4, 512, 6, 8),
                                          (1, 1024, 12, 9)])
def test_cr_factor_short_of_one_block(cuda, C, Tp, Db, n_cr):
    """Levels that stop above one block a chain: band_cr_factor's runs (a
    band_cr_level launch a level at Db = 12) leave the band (1e-12 against
    the CPU's factor), band_block_inv and the PCR levels take it, in the
    launches band.factor_launches counts."""
    D, U = _band(C, Tp, Db, 81 + Tp, (Tp,) * C, cuda)
    band.reset_launch_counts()
    f = band.band_factor(D, U, n_cr=n_cr)
    torch.cuda.synchronize()
    fc = band.band_factor(D.cpu(), U.cpu(), n_cr=n_cr)
    for got, want in zip(f.levels, fc.levels):
        assert all(_rel(g.cpu(), w) <= 1e-12 for g, w in zip(got, want))
    for got, want in ((f.invD, fc.invD), (f.E, fc.E), (f.F, fc.F)):
        assert _rel(got.cpu(), want) <= 1e-12
    assert band.band_block_inv.launches == 1
    assert band.band_cr_level.launches == (0 if band._factor_takes(Db) else n_cr)
    assert (band.band_cr_factor.launches + band.band_cr_level.launches
            + band.band_block_inv.launches + band.band_pcr_level.launches) == (
        band.factor_launches(Tp, Db, n_cr))


@pytest.mark.parametrize("C,Tp,Db", [(4, 512, 6), (400, 64, 6), (1, 2048, 6), (3, 4, 6),
                                     (3, 2, 6)])
def test_cr_factor_emits_band_block_inv(cuda, C, Tp, Db):
    """The invD a run that ends at one block a chain emits is band_block_inv
    of that run's last D', bit for bit (the same inversion function), and
    the odd rows' inverses of its first level are band_block_inv of the odd
    rows, bit for bit (the row inversion makes the element and group
    inversions' operations in their order). Two factors in a row on one
    stream give the same bits."""
    D, U = _band(C, Tp, Db, 82 + Tp, (Tp,) * C, cuda)
    A = band.band_init_a(U)
    runs = band._factor_runs(Tp, Db)
    Dl, Al, Cl = D, A, U
    for n in runs[:-1]:
        run = band.band_cr_factor(Dl, Al, Cl, n)
        Dl, Al, Cl = run.D, run.A, run.C
    n = runs[-1]
    last = band.band_cr_factor(Dl, Al, Cl, n, last=True)
    if n > 1:
        # the same levels stopped one short, then the level before the last
        # position in a launch of its own: the D' that run inverts
        mid = band.band_cr_factor(Dl, Al, Cl, n - 1)
        Dn = band.band_cr_factor(mid.D, mid.A, mid.C, 1).D
    else:
        Dn = band.band_cr_level(Dl, Al, Cl)[5]
    assert torch.equal(last.invD, band.band_block_inv(Dn))
    first = band.band_cr_factor(D, A, U, 1, last=Tp == 2)
    assert torch.equal(first.levels[0].invD, band.band_block_inv(D[:, 1::2].contiguous()))
    f1, f2 = band.band_factor(D, U), band.band_factor(D, U)
    for a, b in zip(f1.levels, f2.levels):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(f1.invD, f2.invD)
    torch.cuda.synchronize()


@pytest.mark.parametrize("C,T", [(64, 512), (64, 256), (3, 2048), (7, 10), (5, 8), (1, 2)])
def test_cr_level_tiles_match(cuda, C, T, monkeypatch):
    """band_cr_level at Db = 12 at the tile its planner gives
    (band._cr_level_tile: 3 positions a thread block from 1,024 positions)
    and at P = 1 and P = 3 forced, on the 3D fold's first levels, a chain
    of 2048, tiles that cross a chain's end and run past the last position:
    the same bits at every P, and the plain twin's outputs, 1e-12; one
    launch each."""
    D, U = _band(C, T, 12, 90 + T, (T,) * C, cuda)
    A = band.band_init_a(U)
    want = band.band_cr_level_plain(D, A, U)
    got = {}
    for P in (None, 1, 3):
        if P is not None:
            monkeypatch.setattr(band, "_cr_level_tile", lambda nC, Th, Db, P=P: P)
        k0 = band.band_cr_level.launches
        got[P] = band.band_cr_level(D, A, U)
        assert band.band_cr_level.launches - k0 == 1
    torch.cuda.synchronize()
    for P in (None, 3):
        assert all(torch.equal(a, b) for a, b in zip(got[P], got[1]))
    for g, w in zip(got[1], want):
        assert _rel(g, w) <= 1e-12
