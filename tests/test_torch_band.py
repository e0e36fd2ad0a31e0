"""The port's band (ops/band.py: compacting CR levels, then PCR) against
dense solves, the JAX package's f64 cyclic reduction (solver/pcr.py) and
its Pallas kernels run in interpret mode, plus the kernel wrappers'
routing.

Tolerances: 1e-11 against dense and f64 references (f64 elimination,
well-conditioned bands). 1e-6 against the Pallas kernels: in interpret
mode on the CPU, XLA contracts their two-float arithmetic into FMAs and
they are only good to about f32 precision (the bound the Pallas tests
use themselves).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from score_tpu.ops import twofloat as tfm
from score_tpu.ops.pallas_pcr import ppcr_factor_pallas, ppcr_solve_pallas
from score_tpu.solver.pcr import pcr_factor, pcr_solve
from tests.test_pcr_tf import _block_tridiag, _dense

from score_tpu_torch.ops import band

torch.set_num_threads(1)


def _rel(a, b):
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / np.max(np.abs(np.asarray(b)))


def _chains(C, T, Db, seed, active=None):
    """C random chains; ``active[c]`` < T pads chain c with decoupled
    identity blocks after its active prefix (the backend's padding)."""
    Ds, Us = [], []
    for c in range(C):
        D, U = _block_tridiag(T, Db, seed + c)
        n = T if active is None else active[c]
        D[n:] = np.eye(Db)
        U[max(n - 1, 0):] = 0.0
        Ds.append(D)
        Us.append(U)
    return np.stack(Ds), np.stack(Us)


def _port_solve(D, U, rhs, n_cr=None):
    f = band.band_factor(torch.tensor(D), torch.tensor(U), n_cr=n_cr)
    return f, band.band_solve(f, torch.tensor(rhs)).numpy()


@pytest.mark.parametrize(
    "C,T,Db,K,active",
    [
        (2, 16, 6, 2, None),
        (1, 32, 4, 1, None),
        (3, 8, 6, 1, (8, 5, 1)),  # padded multi-chain
        (2, 1, 6, 3, None),  # single block per chain: no levels
        (2, 16, 6, 40, None),  # arrow-width panel
    ],
)
def test_band_matches_dense(C, T, Db, K, active):
    D, U = _chains(C, T, Db, 10, active)
    rhs = np.random.default_rng(1).standard_normal((C, T, Db, K))
    _, x = _port_solve(D, U, rhs)
    for c in range(C):
        xref = np.linalg.solve(_dense(D[c], U[c]), rhs[c].reshape(T * Db, K))
        assert _rel(x[c].reshape(T * Db, K), xref) <= 1e-11


@pytest.mark.parametrize(
    "C,T,Db,K,active,n_cr",
    [
        (2, 16, 6, 2, None, 1),
        (1, 32, 4, 1, None, 3),
        (3, 8, 6, 1, (8, 5, 1), 3),  # padded multi-chain, compacted to T = 1
        (2, 2, 6, 3, None, 1),
        (2, 16, 6, 40, None, 2),  # arrow-width panel
    ],
)
def test_compacted_band_matches_dense(C, T, Db, K, active, n_cr):
    D, U = _chains(C, T, Db, 10, active)
    rhs = np.random.default_rng(1).standard_normal((C, T, Db, K))
    f, x = _port_solve(D, U, rhs, n_cr)
    assert len(f.levels) == n_cr and f.invD.shape[1] == T >> n_cr
    for c in range(C):
        xref = np.linalg.solve(_dense(D[c], U[c]), rhs[c].reshape(T * Db, K))
        assert _rel(x[c].reshape(T * Db, K), xref) <= 1e-11


@pytest.mark.parametrize("Db,K", [(6, 1), (6, 138), (12, 1), (12, 18)])
def test_band_past_a_launch_of_compacting_levels(Db, K, monkeypatch):
    """A launch takes 10 levels (chains of up to 1,024), so a chain of
    2,048 solves in two runs (6 and 5 levels); with a launch cut to 8
    levels a chain of 512, which compacts 9 times, does the same (5 and 4):
    the factor keeps every level, the solve runs the fused wrappers in two
    runs and matches a dense solve (1e-11) at a direction and a panel
    width."""
    assert band._CR_MAX_LEVELS == 10
    assert band._cr_runs(10) == [10] and band._cr_runs(11) == [6, 5]
    monkeypatch.setattr(band, "CR_BASE_LENGTH", 1)
    monkeypatch.setattr(band, "_CR_MAX_LEVELS", 8)
    T = 512
    D, U = _chains(1, T, Db, 95)
    rhs = np.random.default_rng(6).standard_normal((1, T, Db, K))
    f, x = _port_solve(D, U, rhs)
    assert len(f.levels) == 9 > band._CR_MAX_LEVELS and f.invD.shape[1] == 1
    assert band._cr_runs(9) == [5, 4]
    xref = np.linalg.solve(_dense(D[0], U[0]), rhs[0].reshape(T * Db, K))
    assert _rel(x[0].reshape(T * Db, K), xref) <= 1e-11


def test_cr_depth_of_the_main_path():
    """Every chain compacts to one block: Manhattan-4's chains pad to 512
    and compact 9 times, robot20's pad to 128 and compact 7 times."""
    assert [band.cr_depth(t) for t in (1, 128, 256, 512, 2048)] == [0, 7, 8, 9, 11]


@pytest.mark.parametrize("C,T,Db,n_cr", [
    pytest.param(2, 16, 6, None, id="2-16-6"),
    pytest.param(1, 32, 4, None, id="1-32-4"),
    # the default schedule above (compacted to one block); below, compacting
    # levels (the fused rhs reduction and back substitution), then PCR
    (2, 64, 6, 2), (2, 64, 6, 3), (1, 64, 12, 2), (1, 64, 12, 3),
])
def test_band_matches_jax_f64_cyclic_reduction(C, T, Db, n_cr):
    D, U = _chains(C, T, Db, 20)
    rhs = np.random.default_rng(2).standard_normal((C, T, Db, 3))
    f, x = _port_solve(D, U, rhs, n_cr)
    assert len(f.levels) == (band.cr_depth(T) if n_cr is None else n_cr)
    xref = jax.vmap(lambda d, u, r: pcr_solve(pcr_factor(d, u), r))(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(rhs))
    assert _rel(x, xref) <= 1e-11


def _lanes_to_chains(tf, C, T, Db, L=None):
    """Pallas lane-major TF (L*Db, Db, lanes) -> f64 (L, C, T, Db, Db), or
    (Db, Db, lanes) -> (C, T, Db, Db) when L is None (chunk padding cut)."""
    a = np.asarray(tfm.to_f64(tf))[..., : C * T]
    if L is None:
        return a.reshape(Db, Db, C, T).transpose(2, 3, 0, 1)
    return a.reshape(L, Db, Db, C, T).transpose(0, 3, 4, 1, 2)


def test_band_matches_pallas_interpret(monkeypatch):
    """Every stored factor and the solution against the Pallas kernels.
    The lane floor is lowered so the Pallas factor compacts two levels
    (T = 32 -> 8) and then runs one two-level and one one-level PCR launch:
    one shape reaches all eight Pallas kernels. Db = 2 keeps the
    interpreter's trace of the unrolled two-float blocks short."""
    from score_tpu.ops import pallas_pcr as pp

    monkeypatch.setattr(pp, "_CR_MIN_LANES", 32)
    C, T, Db, n_cr = 2, 32, 2, 2
    D, U = _chains(C, T, Db, 30)
    rhs = np.random.default_rng(3).standard_normal((C, T, Db, 2))
    f = band.band_factor(torch.tensor(D), torch.tensor(U), n_cr=n_cr)
    x = band.band_solve(f, torch.tensor(rhs)).numpy()
    pf = ppcr_factor_pallas(tfm.from_f64(jnp.asarray(D)), tfm.from_f64(jnp.asarray(U)),
                            interpret=True)
    assert len(pf.levels) == n_cr
    for lv, plv, l in zip(f.levels, pf.levels, range(n_cr)):
        Th = T >> (l + 1)
        for name in ("E", "F", "invD", "A", "C"):
            want = _lanes_to_chains(getattr(plv, name), C, Th, Db)
            assert _rel(getattr(lv, name).numpy(), want) <= 1e-6, (l, name)
    Tb, L = T >> n_cr, band.num_levels(T >> n_cr)
    assert _rel(f.E.numpy(), _lanes_to_chains(pf.base.E, C, Tb, Db, L)) <= 1e-6
    assert _rel(f.F.numpy(), _lanes_to_chains(pf.base.F, C, Tb, Db, L)) <= 1e-6
    assert _rel(f.invD.numpy(), _lanes_to_chains(pf.base.invD, C, Tb, Db)) <= 1e-6
    xp = ppcr_solve_pallas(pf, tfm.from_f64(jnp.asarray(rhs)), interpret=True)
    assert _rel(x, tfm.to_f64(xp)) <= 1e-6


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU every wrapper returns its plain twin's result and
    launches nothing."""
    D, U = (torch.tensor(a) for a in _chains(2, 8, 6, 40))
    band.reset_launch_counts()
    A = band.band_init_a(U)
    assert torch.equal(A, band.band_init_a_plain(U))
    assert torch.equal(band.band_block_inv(D), band.band_block_inv_plain(D))
    invD = band.band_block_inv(D)
    for got, want in zip(band.band_pcr_level(D, A, U, invD, 2),
                         band.band_pcr_level_plain(D, A, U, invD, 2)):
        assert torch.equal(got, want)
    f = band.band_factor(D, U, n_cr=0)  # parallel cyclic reduction only
    b = torch.randn(2, 8, 6, 3, dtype=torch.float64)
    assert torch.equal(band.band_pcr_solve(f.E, f.F, f.invD, b),
                       band.band_pcr_solve_plain(f.E, f.F, f.invD, b))
    lv = band.band_cr_level(D, A, U)
    for got, want in zip(lv, band.band_cr_level_plain(D, A, U)):
        assert torch.equal(got, want)
    # the fused CR kernels at one and two levels
    for n in (1, 2):
        levels = band.band_factor(D, U, n_cr=n).levels
        red = band.band_cr_reduce(levels, b)
        want = band.band_cr_reduce_plain(levels, b)
        assert len(red) == n and all(torch.equal(g, w) for g, w in zip(red, want))
        fine = (b,) + red[:-1]
        assert torch.equal(band.band_cr_backsub(levels, fine, red[-1]),
                           band.band_cr_backsub_plain(levels, fine, red[-1]))
    # a factor's run of levels, ending at one block a chain and short of it
    for n, last in ((3, True), (2, False)):
        got = band.band_cr_factor(D, A, U, n, last)
        want = band.band_cr_factor_plain(D, A, U, n, last)
        assert all(torch.equal(g, w) for lg, lw in zip(got.levels, want.levels)
                   for g, w in zip(lg, lw))
        assert all(g is w is None or torch.equal(g, w) for g, w in zip(got[1:], want[1:]))
    assert [k.launches for k in band.KERNELS] == [0] * 8


def test_wrappers_reject_bad_inputs():
    D, U = (torch.tensor(a) for a in _chains(1, 4, 6, 50))
    with pytest.raises(TypeError):
        band.band_block_inv(D.float())
    with pytest.raises(ValueError):
        band.band_init_a(U.transpose(-1, -2))  # not contiguous
    with pytest.raises(RuntimeError):
        band.band_block_inv(D.to("meta"))  # neither CPU nor CUDA: no kernel
    f = band.band_factor(D, U)
    with pytest.raises(ValueError):
        band.band_pcr_solve(f.E, f.F, f.invD, torch.zeros(1, 8, 6, 1, dtype=torch.float64))
    A = band.band_init_a(U)
    with pytest.raises(ValueError):
        band.band_cr_level(D[:, :3], A[:, :3], U[:, :3])  # odd chain length
    with pytest.raises(ValueError):
        band.band_factor(D, U, n_cr=3)  # deeper than log2(T) = 2
    # the fused CR kernels: level lists whose lengths do not halve the chain,
    # a fine rhs too few, and a depth past a launch's maximum (which the
    # factor takes and the solve cuts into runs)
    levels = band.band_factor(D, U, n_cr=2).levels
    b = torch.zeros(1, 4, 6, 2, dtype=torch.float64)
    with pytest.raises(ValueError):
        band.band_cr_reduce(levels[::-1], b)  # coarse -> fine
    with pytest.raises(ValueError):
        band.band_cr_reduce(levels, torch.zeros(1, 8, 6, 2, dtype=torch.float64))
    with pytest.raises(ValueError):
        band.band_cr_reduce((), b)
    x = torch.zeros(1, 1, 6, 2, dtype=torch.float64)
    with pytest.raises(ValueError):
        band.band_cr_backsub(levels, (b,), x)
    with pytest.raises(ValueError):
        band.band_cr_backsub(levels[:1], (b,), x)  # x is not the level's coarse length
    n = band._CR_MAX_LEVELS + 1
    Dd, Ud = (torch.tensor(a) for a in _chains(1, 1 << n, 2, 51))
    with pytest.raises(ValueError):
        band.band_factor(Dd, Ud, n_cr=n + 1)  # deeper than log2(T) = n
    deep = band.band_factor(Dd, Ud, n_cr=n).levels
    bd = torch.zeros(1, 1 << n, 2, 1, dtype=torch.float64)
    with pytest.raises(ValueError, match="levels"):
        band.band_cr_reduce(deep, bd)
    with pytest.raises(ValueError, match="levels"):
        band.band_cr_backsub(deep, (bd,) * n, bd[:, :1])
    # a factor's run: 1 to 8 levels that halve the chain, ``last`` only where
    # it ends at one block
    Af = band.band_init_a(Ud)
    for levels, last in ((0, False), (n, False), (n - 1, True)):
        with pytest.raises(ValueError, match="band_cr_factor"):
            band.band_cr_factor(Dd, Af, Ud, levels, last)


# ------------------------------------------------------------------ #
# The PCR level with the carried inverse (invD in, invD' out), level by
# level on a Tp = 16 chain
# ------------------------------------------------------------------ #

_LEVEL_SHAPE = (2, 16, 2)  # C, T, Db: small blocks keep the interpreter short


def _level_inputs():
    C, T, Db = _LEVEL_SHAPE
    return _chains(C, T, Db, 70)


def _port_levels():
    """Every level's inputs and outputs of the port's PCR factor:
    [(D, A, C, invD, s, outputs)], each level fed the one before."""
    D, U = (torch.tensor(a) for a in _level_inputs())
    A, Cc, invD = band.band_init_a(U), U, band.band_block_inv(D)
    levels = []
    for lev in range(band.num_levels(D.shape[1])):
        out = band.band_pcr_level(D, A, Cc, invD, 1 << lev)
        levels.append((D, A, Cc, invD, 1 << lev, out))
        _, _, D, A, Cc, invD = out
    return levels


@pytest.fixture(scope="module")
def pallas_pcr_only():
    """The Pallas factor of the same chains without compaction, in
    interpret mode: base.E, base.F hold every PCR level."""
    from score_tpu.ops.pallas_pcr import _ppcr_factor_impl

    D, U = _level_inputs()
    return _ppcr_factor_impl(tfm.from_f64(jnp.asarray(D)), tfm.from_f64(jnp.asarray(U)),
                             interpret=True, compact=False)


def _jnp_shift(x, s, down):
    z = jnp.zeros_like(x)
    T = x.shape[1]
    if s >= T:
        return z
    return z.at[:, s:].set(x[:, : T - s]) if down else z.at[:, : T - s].set(x[:, s:])


@pytest.mark.parametrize("lev", range(4))
def test_pcr_level_carries_the_inverse(lev, pallas_pcr_only):
    """Level s = 2^lev of a Tp = 16 chain: the plain level that takes invD
    and returns invD' against the formulas it replaced (which inverted D
    inside the level: bit-identical E, F, D', A', C'), against the same
    level written in jnp f64 (1e-12) and against the Pallas kernels'
    stored E, F of that level and, at the last level, invD (1e-6)."""
    C, T, Db = _LEVEL_SHAPE
    D, A, Cc, invD, s, out = _port_levels()[lev]
    E, F, D2, A2, C2, invD2 = out
    assert s == 1 << lev
    # the formulas before the inverse was carried
    iv = band.band_block_inv_plain(D)
    assert torch.equal(iv, invD)
    Eo = -(A @ band._shift_down(iv, s))
    Fo = -(Cc @ band._shift_up(iv, s))
    old = (Eo, Fo, D + (Eo @ band._shift_down(Cc, s) + Fo @ band._shift_up(A, s)),
           Eo @ band._shift_down(A, s), Fo @ band._shift_up(Cc, s))
    for got, want in zip(out, old):
        assert torch.equal(got, want)
    eye = torch.eye(Db, dtype=torch.float64).expand(C, T, Db, Db)
    assert _rel(invD2 @ D2, eye) <= 1e-12
    # the same level in jnp f64
    Dj, Aj, Cj = (jnp.asarray(t.numpy()) for t in (D, A, Cc))
    ivj = jnp.linalg.inv(Dj)
    Ej = -(Aj @ _jnp_shift(ivj, s, True))
    Fj = -(Cj @ _jnp_shift(ivj, s, False))
    ref = (Ej, Fj, Dj + Ej @ _jnp_shift(Cj, s, True) + Fj @ _jnp_shift(Aj, s, False),
           Ej @ _jnp_shift(Aj, s, True), Fj @ _jnp_shift(Cj, s, False))
    ref += (jnp.linalg.inv(ref[2]),)
    for got, want in zip(out, ref):
        assert np.max(np.abs(got.numpy() - np.asarray(want))) <= 1e-12 * max(
            1.0, float(jnp.max(jnp.abs(want))))
    # the Pallas kernels, interpret mode
    L = band.num_levels(T)
    pE = _lanes_to_chains(pallas_pcr_only.E, C, T, Db, L)[lev]
    pF = _lanes_to_chains(pallas_pcr_only.F, C, T, Db, L)[lev]
    scale = max(np.max(np.abs(pE)), np.max(np.abs(pF)), 1e-300)
    assert np.max(np.abs(E.numpy() - pE)) <= 1e-6 * scale
    assert np.max(np.abs(F.numpy() - pF)) <= 1e-6 * scale
    if lev == L - 1:
        assert _rel(invD2.numpy(), _lanes_to_chains(pallas_pcr_only.invD, C, T, Db)) <= 1e-6


@pytest.mark.parametrize(
    "T,n_cr",
    [(1, 0), (2, 0), (2, 1), (4, 0), (4, 2), (16, 0), (16, 4)],
)
def test_band_at_the_ends_of_the_schedule(T, n_cr):
    """band_factor + band_solve against a dense solve on the shortest
    chains and with no compacting level or only compacting levels."""
    C, Db, K = 2, 6, 3
    D, U = _chains(C, T, Db, 80)
    rhs = np.random.default_rng(4).standard_normal((C, T, Db, K))
    f, x = _port_solve(D, U, rhs, n_cr)
    assert len(f.levels) == n_cr and f.E.shape[0] == band.num_levels(T >> n_cr)
    assert f.invD.shape == (C, T >> n_cr, Db, Db)
    for c in range(C):
        xref = np.linalg.solve(_dense(D[c], U[c]), rhs[c].reshape(T * Db, K))
        assert _rel(x[c].reshape(T * Db, K), xref) <= 1e-11


@pytest.mark.parametrize("K", [1, 3, 138, 258])
@pytest.mark.parametrize("Tp", [1, 2, 128, 256, 1024])
def test_solve_chunk_columns(Tp, K):
    """The rhs columns of one band_pcr_solve block: between 1 and K, its
    tile one the kernels are built for, and its single in-place buffer
    within the card's 232,448 bytes of shared memory per block."""
    ct = band._solve_tile_columns(Tp, 6, K)
    assert ct in (1, 2, 4, 8)
    assert (ct == 8) == (Tp <= 256 and K > 4)
    for C in (1, 4, 20, 400):
        Kc = band._solve_chunk_columns(Tp, 6, K, C)
        groups = band._solve_groups(Tp, 6, K, C) if ct == 8 else 1
        assert 1 <= Kc <= K and Kc <= ct * groups
        assert groups * max(Tp, 1) <= 256 or groups == 1
        assert band._solve_smem_bytes(Tp, 6, ct, groups) <= 232448
    # robot20's panel: two threads per position; Manhattan-4's: one
    assert band._solve_groups(128, 6, 258, 20) == 2
    assert band._solve_groups(256, 6, 138, 4) == 1
    if ct != 8:  # the narrow kernel's accumulators: 24 per thread, 512 threads
        assert Tp * 6 * ct <= 24 * 512


@pytest.mark.parametrize("K,narrow", [(1, True), (2, True), (3, True), (4, True),
                                      (5, False), (6, False), (138, False), (258, False)])
def test_backsub_kernel_rule(K, narrow):
    """band_cr_backsub's kernel: narrow (a lane group per position) up to
    4 rhs columns, wide (a thread per column) above. On the main path a
    direction (K = 1) runs narrow, Manhattan-4's panel (138) and robot20's
    (258) wide."""
    assert band._backsub_narrow(K) is narrow


@pytest.mark.parametrize("Tp", [4096, 8192])
def test_solve_chunk_columns_raises_when_a_column_does_not_fit(Tp):
    assert band._solve_chunk_columns(2048, 6, 7) == 1  # the longest chain that fits
    with pytest.raises(ValueError):
        band._solve_chunk_columns(Tp, 6, 1)


# ------------------------------------------------------------------ #
# 3D blocks (Db = 12)
# ------------------------------------------------------------------ #


@pytest.mark.parametrize(
    "C,T,K,active,n_cr",
    [
        (2, 16, 18, None, 2),  # 16 -> 8 -> 4, then PCR
        (1, 32, 1, None, 0),  # PCR only
        (3, 8, 3, (8, 5, 1), 3),  # padded chains, compacted to one block
        (2, 4, 18, None, 1),
        (2, 1, 2, None, None),  # one block per chain
    ],
)
def test_band_3d_matches_dense(C, T, K, active, n_cr, monkeypatch):
    """The band at 3D blocks against a dense solve, 1e-11, with each plain
    twin seen to run: factor and solve reach all seven (the schedules with
    both compacting and PCR levels)."""
    calls = {}
    for name in ("band_init_a", "band_block_inv", "band_pcr_level", "band_pcr_solve",
                 "band_cr_level", "band_cr_reduce", "band_cr_backsub"):
        plain = getattr(band, name + "_plain")

        def spy(*a, _plain=plain, _name=name):
            calls[_name] = calls.get(_name, 0) + 1
            return _plain(*a)

        monkeypatch.setattr(band, name + "_plain", spy)
    D, U = _chains(C, T, 12, 90, active)
    rhs = np.random.default_rng(5).standard_normal((C, T, 12, K))
    f, x = _port_solve(D, U, rhs, n_cr)
    n = band.cr_depth(T) if n_cr is None else n_cr
    assert len(f.levels) == n and f.invD.shape == (C, T >> n, 12, 12)
    for c in range(C):
        xref = np.linalg.solve(_dense(D[c], U[c]), rhs[c].reshape(T * 12, K))
        assert _rel(x[c].reshape(T * 12, K), xref) <= 1e-11
    if 0 < n < band.num_levels(T):
        assert len(calls) == 7, calls


def test_block_inv_plain_3d_is_the_inverse():
    D, _ = _chains(2, 8, 12, 91)
    inv = band.band_block_inv_plain(torch.tensor(D)).numpy()
    assert _rel(inv, np.linalg.inv(D)) <= 1e-12


def _odometry_band(C, T, Db, spread=4.0, delta=1e-3, seed=1):
    """An odometry chain's band: D_i = 2 W + delta I, couplings -W, with W
    SPD and its eigenvalues spread over ``spread`` decades (the rotation
    rows of 3D pose blocks weigh ~1e4 times the translation rows)."""
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((Db, Db)))[0]
    W = Q @ np.diag(np.logspace(0, spread, Db)) @ Q.T
    D = np.broadcast_to(2 * W + delta * np.eye(Db), (C, T, Db, Db)).copy()
    U = np.broadcast_to(-W, (C, T, Db, Db)).copy()
    U[:, -1] = 0.0
    return torch.tensor(D), torch.tensor(U)


@pytest.mark.parametrize("T,n_cr", [(16, 0), (16, 4), (32, 0), (32, 2), (32, 5), (64, 3)])
def test_band_3d_refinement(T, n_cr, monkeypatch):
    """A 3D band solve takes one step of iterative refinement: on an
    odometry chain's ill-conditioned 12 x 12 band the residual of the
    solve falls from ~1e-9 to ~1e-11 relative (by 50 or more) at every
    compaction depth; 2D solves take none."""
    assert band.refine_steps(6) == 0 and band.refine_steps(12) == band.REFINE_STEPS_3D == 1
    D, U = _odometry_band(2, T, 12)
    b = torch.tensor(np.random.default_rng(2).standard_normal((2, T, 12, 3)))
    f = band.band_factor(D, U, n_cr=n_cr)
    resid = lambda x: ((band.band_matvec(D, U, x) - b).abs().max() / b.abs().max()).item()
    refined = resid(band.band_solve(f, b))
    monkeypatch.setattr(band, "REFINE_STEPS_3D", 0)
    once = resid(band.band_solve(f, b))
    assert once >= 1e-10  # what the explicit inverses lose
    assert refined <= 1e-10 and refined <= once / 50


@pytest.mark.parametrize("K", [1, 2, 3, 12, 17, 18, 19, 138])
@pytest.mark.parametrize("Tp", [1, 2, 4, 8, 32, 64, 128, 256, 512])
def test_solve_tile_columns_3d(Tp, K):
    """band_pcr_solve at Db = 12 takes the cluster kernel (the 2D tile
    rule refuses it): P thread blocks a chain, P a power of two up to 16
    that divides the chain (so the grid's C * P blocks fall into whole
    clusters), Kc columns a cluster whose ceil(K / Kc) chunks cover every
    column with none empty, no more chunks than the shared memory needs
    or than one cluster fewer than the card's 132 SMs hold, and a thread
    block's two rhs buffers and two-stage E, F ring within 232,448 bytes
    of shared memory."""
    for C in (1, 4):
        P, Kc = band._solve_cluster_plan(Tp, 12, K, C)
        assert P == min(band._SOLVE_CLUSTER, Tp) and Tp % P == 0
        assert 1 <= P <= 16 and P & (P - 1) == 0
        chunks = -(-K // Kc)
        assert 1 <= Kc <= K and chunks * Kc >= K and (chunks - 1) * Kc < K
        assert band._cluster_smem_bytes(Tp, 12, P, Kc) <= band._CLUSTER_SMEM_MAX
        per_column = band._cluster_smem_bytes(Tp, 12, P, 1) - band._cluster_smem_bytes(
            Tp, 12, P, 0)
        needed = -(-K // ((band._CLUSTER_SMEM_MAX - band._cluster_smem_bytes(Tp, 12, P, 0))
                          // per_column))
        assert needed <= chunks <= max(needed, max(1, 132 // P - 1) // C)
        assert band._solve_chunk_columns(Tp, 12, K, C) == Kc
    with pytest.raises(ValueError):
        band._solve_tile_columns(Tp, 12, K)


@pytest.mark.parametrize("Tp", [1024, 2048])
def test_solve_tile_columns_3d_raises_past_a_column(Tp):
    # the longest chain that fits: 13 columns a cluster at most
    P, Kc = band._solve_cluster_plan(512, 12, 18)
    assert P == 16 and Kc <= 13
    with pytest.raises(ValueError):
        band._solve_cluster_plan(Tp, 12, 1)


def _pcr_solve_partitioned(E, F, invD, b):
    """band_pcr_solve replayed as the cluster kernel cuts it: the columns
    in the plan's chunks of Kc, a chain's positions over P owners of n =
    Tp / P each, every owner with its own two (C, n, Db, Kc) buffers; at
    level l an owner reads buffer l % 2, its own rows and the rows at
    i -+ s from the owner of that position, and writes the other."""
    L, nC, Tp, Db, _ = E.shape
    K = b.shape[-1]
    P, Kc = band._solve_cluster_plan(Tp, Db, K)
    n = Tp // P
    x = torch.empty_like(b)
    for k0 in range(0, K, Kc):
        kc = min(Kc, K - k0)
        buf = [[b[:, p * n:(p + 1) * n, :, k0:k0 + kc].clone(), None] for p in range(P)]
        for lev in range(L):
            s, cur = 1 << lev, lev % 2
            held = torch.stack([buf[q][cur] for q in range(P)])  # (P, C, n, Db, kc)
            for p in range(P):
                i = torch.arange(p * n, (p + 1) * n)
                acc = torch.zeros_like(buf[p][cur])
                for M, nb in ((E, i - s), (F, i + s)):
                    inside = (nb >= 0) & (nb < Tp)
                    q, j = nb.clamp(0, Tp - 1) // n, nb.clamp(0, Tp - 1) % n
                    rows = held[q, :, j].transpose(0, 1) * inside.view(1, n, 1, 1)
                    acc = acc + M[lev, :, p * n:(p + 1) * n] @ rows
                buf[p][1 - cur] = buf[p][cur] + acc
        for p in range(P):
            x[:, p * n:(p + 1) * n, :, k0:k0 + kc] = invD[:, p * n:(p + 1) * n] @ buf[p][L % 2]
    return x


@pytest.mark.parametrize("Tp,Ks", [(1, (1, 18)), (2, (1, 18)), (32, (1, 18)),
                                   (256, (1, 18, 138))])
def test_pcr_solve_partitioned_as_the_cluster_plan(Tp, Ks):
    """The cluster kernel's owner and halo indexing, replayed in PyTorch on
    the plan's partition, against band_pcr_solve_plain (1e-15 relative: the
    same products in the same grouping)."""
    rng = np.random.default_rng(Tp)
    C, Db, L = 2, 12, band.num_levels(Tp)
    t = lambda *shape: torch.tensor(0.2 * rng.standard_normal(shape))
    E, F, invD = t(L, C, Tp, Db, Db), t(L, C, Tp, Db, Db), t(C, Tp, Db, Db)
    for K in Ks:
        b = t(C, Tp, Db, K)
        want = band.band_pcr_solve_plain(E, F, invD, b)
        got = _pcr_solve_partitioned(E, F, invD, b)
        assert _rel(got, want) <= 1e-15


# ------------------------------------------------------------------ #
# The fused CR kernels: every compacting level of a solve in one launch
# ------------------------------------------------------------------ #


def _cr_levels(C, T, Db, n, seed):
    """n random compacting levels (CRLevel, fine -> coarse) of C chains of
    T: blocks of 0.2 N(0, 1) / sqrt(Db), so that repeated reductions keep
    the rhs of order one."""
    rng = np.random.default_rng(seed)
    t = lambda *shape: torch.tensor(0.2 / np.sqrt(Db) * rng.standard_normal(shape))
    return tuple(band.CRLevel(*(t(C, T >> (lev + 1), Db, Db) for _ in range(5)))
                 for lev in range(n))


@pytest.mark.parametrize("K", [1, 18])
@pytest.mark.parametrize("Db", [6, 12])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_fused_cr_plain_twins_are_the_per_level_composition(n, Db, K):
    """band_cr_reduce_plain and band_cr_backsub_plain over n levels equal,
    bit for bit, the per-level formulas applied level by level (what the
    solve ran before the levels went into one launch each)."""
    C, T = 2, 16 << n
    levels = _cr_levels(C, T, Db, n, seed=n + Db + K)
    b = torch.tensor(np.random.default_rng(K).standard_normal((C, T, Db, K)))
    fine, cur = [], b
    for lv in levels:
        fine.append(cur)
        bod = cur[:, 1::2]
        cur = cur[:, 0::2] + (lv.E @ band._shift_down(bod, 1) + lv.F @ bod)
    red = band.band_cr_reduce_plain(levels, b)
    assert len(red) == n and all(torch.equal(r, f) for r, f in zip(red, fine[1:] + [cur]))
    x = torch.tensor(np.random.default_rng(K + 1).standard_normal(cur.shape))
    want = x
    for lv, bf in zip(reversed(levels), reversed(fine)):
        xo = lv.invD @ ((bf[:, 1::2] - lv.A @ want) - lv.C @ band._shift_up(want, 1))
        want = torch.stack([want, xo], dim=2).reshape(bf.shape)
    assert torch.equal(band.band_cr_backsub_plain(levels, (b,) + red[:-1], x), want)


def _cr_reduce_tiled(levels, b, P, Kc):
    """band_cr_reduce replayed as its kernel cuts it: per chain, tile of P
    coarsest positions j0 .. j0 + P - 1 and chunk of Kc columns, the fine
    rows 2^n j0 - (2^n - 1) .. 2^n (j0 + P) - 1 (the left halo; none before
    a chain's start), every level computed over the tile's own positions
    and the 2^(n - l) - 1 before them (no E term at a chain's first
    position, none past its end), only the own positions written."""
    n = len(levels)
    C, T, Db, K = b.shape
    Tn = T >> n
    outs = [torch.full((C, T >> (lev + 1), Db, K), float("nan"), dtype=b.dtype)
            for lev in range(n)]
    for j0 in range(0, Tn, P):
        for k0 in range(0, K, Kc):
            kc = min(Kc, K - k0)
            base = (j0 << n) - ((1 << n) - 1)
            rows = torch.zeros(C, ((P + 1) << n) - 1, Db, kc, dtype=b.dtype)
            lo, hi = max(base, 0), min((j0 + P) << n, T)
            rows[:, lo - base:hi - base] = b[:, lo:hi, :, k0:k0 + kc]
            for lev in range(1, n + 1):
                h, Th = (1 << (n - lev)) - 1, T >> lev
                cnt = ((P + 1) << (n - lev)) - 1
                j = (j0 << (n - lev)) - h + torch.arange(cnt)
                inside = (j >= 0) & (j < Th)
                E = torch.zeros(C, cnt, Db, Db, dtype=b.dtype)
                F = torch.zeros_like(E)
                E[:, inside] = levels[lev - 1].E[:, j[inside]]
                F[:, inside] = levels[lev - 1].F[:, j[inside]]
                E = E * (j > 0).view(1, cnt, 1, 1).to(b.dtype)
                new = rows[:, 1:2 * cnt:2] + (E @ rows[:, 0:2 * cnt:2] + F @ rows[:, 2:2 * cnt + 1:2])
                own = inside & (torch.arange(cnt) >= h)
                outs[lev - 1][:, j[own], :, k0:k0 + kc] = new[:, own]
                rows = new
    return tuple(outs)


def _cr_backsub_tiled(levels, fine, x, P, Kc):
    """band_cr_backsub replayed as its kernels cut it: per tile of P
    coarsest positions and chunk of Kc columns, the tile's coarsest rows and
    the one after it (the right halo; none past a chain's end), each finer
    level's odd rows computed between them (no C term at a chain's last
    position), the tile's 2^n P finest rows written."""
    n = len(levels)
    C, Tn, Db, K = x.shape
    T = Tn << n
    out = torch.full((C, T, Db, K), float("nan"), dtype=x.dtype)
    for j0 in range(0, Tn, P):
        for k0 in range(0, K, Kc):
            kc = min(Kc, K - k0)
            m = j0 + torch.arange(P + 1)
            cur = torch.zeros(C, P + 1, Db, kc, dtype=x.dtype)
            cur[:, m < Tn] = x[:, m[m < Tn], :, k0:k0 + kc]
            for lev in range(n, 0, -1):
                Th, Pl = T >> lev, P << (n - lev)
                m = (j0 << (n - lev)) + torch.arange(Pl)
                inside, up = m < Th, (m + 1 < Th).view(1, Pl, 1, 1).to(x.dtype)
                lv = levels[lev - 1]
                blk = {f: torch.zeros(C, Pl, Db, Db, dtype=x.dtype) for f in ("invD", "A", "C")}
                for f, t in blk.items():
                    t[:, inside] = getattr(lv, f)[:, m[inside]]
                bo = torch.zeros(C, Pl, Db, kc, dtype=x.dtype)
                bo[:, inside] = fine[lev - 1][:, 2 * m[inside] + 1, :, k0:k0 + kc]
                xo = blk["invD"] @ ((bo - blk["A"] @ cur[:, :Pl]) - (blk["C"] * up) @ cur[:, 1:])
                nxt = torch.zeros(C, 2 * Pl + 1, Db, kc, dtype=x.dtype)
                nxt[:, 0::2], nxt[:, 1::2] = cur, xo
                cur = nxt
            rows = (j0 << n) + torch.arange(P << n)
            out[:, rows[rows < T], :, k0:k0 + kc] = cur[:, :P << n][:, rows < T]
    return out


@pytest.mark.parametrize("C", [1, 4])
@pytest.mark.parametrize("Db,n,Tn,K,P", [
    (12, 2, 256, 18, None),  # 3D 1x1000's levels, the panel: the plan's tiles
    (12, 2, 256, 1, None),
    (6, 1, 256, 138, None),  # Manhattan-4's level
    (6, 3, 8, 5, None),
    (6, 2, 7, 19, 2),  # a tile past the chain's end (7 coarsest positions)
    (12, 3, 5, 4, 3),
    (6, 1, 6, 2, 4),
    (12, 4, 3, 17, 2),
])
def test_cr_partitioned_as_the_tile_plan(C, Db, n, Tn, K, P):
    """The fused CR kernels' tiles, halos and column chunks, replayed in
    PyTorch over the wrapper's own plan (band._cr_plan: tiles start at a
    chain's start, fall inside it and run past its end), against the plain
    twins: 1e-15 relative (the same products in the same grouping). Chunks
    of fewer columns where the plan takes all K: the replay of chunked
    columns."""
    T = Tn << n
    levels = _cr_levels(C, T, Db, n, seed=C + n + K)
    rng = np.random.default_rng(Tn + K)
    b = torch.tensor(rng.standard_normal((C, T, Db, K)))
    x = torch.tensor(rng.standard_normal((C, Tn, Db, K)))
    step = band._backsub_step(Db, K)
    for kind in ("reduce", step):
        Pk, Kc = band._cr_plan(kind, n, Tn, Db, K, C, P=P)
        assert 1 <= Pk <= Tn and 1 <= Kc <= K
        assert band._cr_smem_bytes(kind, n, Db, Pk, Kc) <= band._SMEM_MAX
        for kc in {Kc, max(1, K // 3)} if kind != "narrow" else {K}:
            if kind == "reduce":
                got = _cr_reduce_tiled(levels, b, Pk, kc)
                for g, w in zip(got, band.band_cr_reduce_plain(levels, b)):
                    assert _rel(g, w) <= 1e-15
            else:
                fine = (b,) + band.band_cr_reduce_plain(levels, b)[:-1]
                got = _cr_backsub_tiled(levels, fine, x, Pk, kc)
                assert _rel(got, band.band_cr_backsub_plain(levels, fine, x)) <= 1e-15


@pytest.mark.parametrize("Db", [6, 12])
@pytest.mark.parametrize("K", [1, 2, 4, 5, 17, 18, 19, 138, 258])
@pytest.mark.parametrize("n,Tn", [(1, 1), (1, 256), (2, 2), (2, 256), (3, 64), (4, 256)])
def test_cr_plan(n, Tn, K, Db):
    """The fused CR launches' plans at the main paths' and the card tests'
    shapes: a tile of 1 to Tn positions (a power of two), all K columns or
    even chunks of them (16-byte copies), every SM given a thread block
    where the chain allows, a thread block's shared memory within the
    card's 227 KB, and one launch for every level (n <= 4). Manhattan-4's
    and 3D 1x1000's plans as measured."""
    for C in (1, 4, 20):
        for kind in ("reduce", band._backsub_step(Db, K)):
            P, Kc = band._cr_plan(kind, n, Tn, Db, K, C)
            assert 1 <= P <= Tn and P & (P - 1) == 0
            assert (Kc == K) or (1 <= Kc < K and (K % 2 or Kc % 2 == 0))
            assert kind != "narrow" or Kc == K
            assert band._cr_smem_bytes(kind, n, Db, P, Kc) <= band._SMEM_MAX
            if kind in ("reduce", "element"):
                blocks = C * -(-Tn // P) * -(-K // Kc)
                assert blocks >= min(132, C * Tn) or P == 1
            else:  # the register steps: a tile's finest level within its items
                per = (8 if Db == 6 else 16) if kind == "narrow" else (K // 2 if K % 2 == 0 else K)
                assert (P << (n - 1)) * per <= band._CR_STEP_ITEMS[kind] or P == 1
                assert 2 * C * -(-Tn // P) >= 132 or P == 1
            assert band._cr_launch_depths(kind, n, Db, K) == [n]
    # a solve deeper than a thread block holds takes runs of levels, each of
    # which the plan fits
    assert band._cr_launch_depths("reduce", 6, 12, 18) == [5, 1]
    assert band._cr_launch_depths("reduce", 8, 6, 18) == [7, 1]
    assert band._cr_launch_depths("element", 6, 12, 18) == [5, 1]
    for kind, Db_, K_ in (("reduce", 12, 18), ("reduce", 6, 258), ("element", 12, 138),
                          ("element", 12, 19), ("narrow", 12, 4), ("wide", 6, 258)):
        for depth in band._cr_launch_depths(kind, 8, Db_, K_):
            band._cr_plan(kind, depth, 2, Db_, K_, 2)
    # Manhattan-4's and 3D 1x1000's plans, as measured
    assert band._cr_plan("reduce", 1, 256, 6, 138, 4) == (4, 138)
    assert band._cr_plan("wide", 1, 256, 6, 138, 4) == (1, 138)  # one level: no tile
    assert band._cr_plan("narrow", 1, 256, 6, 1, 4) == (1, 1)
    assert band._cr_plan("wide", 2, 256, 6, 138, 1) == (2, 138)
    assert band._cr_plan("reduce", 2, 256, 12, 18, 1) == (1, 18)
    assert band._cr_plan("element", 2, 256, 12, 18, 1) == (1, 18)
    assert band._cr_plan("narrow", 2, 256, 12, 1, 1) == (2, 1)


# ------------------------------------------------------------------ #
# The chain kernels: runs that end at one position a chain
# ------------------------------------------------------------------ #


def _cr_reduce_chain_replay(levels, b, plan):
    """band_cr_reduce's tree kernel replayed (band.ReducePlan): the tile
    stage as the tile kernel cuts it (tiles of P positions of level top with
    their halo, chunks of Kf columns) from b, then the levels top + 1 .. n
    over each whole chain from the level-top rows, a chunk of Kf columns at
    a time in chunks of Kc columns,
    each level computed in place in the finest layout (level d's position j
    at row j << d, its input's rows 2j -+ 1 at (2j -+ 1) << (d - 1))."""
    n = len(levels)
    C, T, Db, K = b.shape
    outs = [torch.full((C, T >> (lev + 1), Db, K), float("nan"), dtype=b.dtype)
            for lev in range(n)]
    src, m = b, plan.top
    if m:
        for lev, o in enumerate(_cr_reduce_tiled(levels[:m], b, plan.P, plan.Kf)):
            outs[lev] = o
        src = outs[m - 1]
    # a whole chain a chunk of Kf columns (all K without a tile stage), in
    # chunks of Kc within it
    spans = [(j, k0) for j in range(0, K, plan.Kf)
             for k0 in range(j, min(j + plan.Kf, K), plan.Kc)]
    Tc = T >> m
    for j, k0 in spans:
        k1 = min(k0 + plan.Kc, j + plan.Kf, K)
        buf = src[..., k0:k1].clone()
        for d in range(1, n - m + 1):
            lv, sh, Th = levels[m + d - 1], d - 1, Tc >> d
            s = torch.arange(Th)
            own, up = s << d, ((2 * s + 1) << sh)
            down = ((2 * s - 1).clamp_min(0)) << sh
            E = lv.E * (s > 0).view(1, Th, 1, 1).to(b.dtype)
            new = buf[:, own] + (E @ buf[:, down] + lv.F @ buf[:, up])
            buf[:, own] = new
            outs[m + d - 1][..., k0:k1] = new
    return tuple(outs)


def _tree_tickets_replayed(plan, n, C, chunks, order):
    """The tree reduce's tickets (csrc/band.cu: cr_reduce_tree_kernel) with
    the tile stage's thread blocks arriving in ``order``: each block runs
    its tile and chunk of columns, then takes a ticket of the counter of
    its chain and chunk; the one that takes the last runs the whole chain
    for that chunk and zeroes the counter. Returns the (chain, chunk)
    whole chains run, in the order they ran, with the tiles of that chain
    and chunk that had run by then, and the counters after the launch."""
    tiles = ((1 << n) >> plan.top) // plan.P
    counters = [[0] * chunks for _ in range(C)]
    done = [[set() for _ in range(chunks)] for _ in range(C)]
    ran = []
    for blk in order:
        c, r = divmod(blk, tiles * chunks)
        u, q = divmod(r, chunks)
        done[c][q].add(u)
        counters[c][q] += 1
        if counters[c][q] == tiles:
            counters[c][q] = 0
            ran.append((c, q, set(done[c][q])))
    return ran, counters


def _cr_backsub_chain_replay(levels, fine, x, plan):
    """band_cr_backsub's chain kernel replayed (band.BacksubPlan): each of
    the S segments of a chain makes x_{l-1} over its interval
    (band._chain_intervals) from x_l over the level above's, from the
    coarsest position down, in chunks of Kc columns; only its own finest
    rows are written."""
    n = len(levels)
    C, _, Db, K = x.shape
    T = 1 << n
    out = torch.full((C, T, Db, K), float("nan"), dtype=x.dtype)
    for s in range(plan.S):
        iv = band._chain_intervals(n, plan.S, s)
        for k0 in range(0, K, plan.Kc):
            cur = x[..., k0:k0 + plan.Kc]  # x_n over [0, 0]
            for lev in range(n, 0, -1):
                (ilo, ihi), (xlo, _) = iv[lev - 1], iv[lev]
                lv, Tl = levels[lev - 1], T >> lev
                nxt = torch.empty((C, ihi - ilo + 1, Db, cur.shape[-1]), dtype=x.dtype)
                for i in range(ilo, ihi + 1):
                    p = i >> 1
                    xv = cur[:, p - xlo]
                    if i % 2 == 0:
                        nxt[:, i - ilo] = xv
                        continue
                    rv = fine[lev - 1][:, i, :, k0:k0 + plan.Kc] - lv.A[:, p] @ xv
                    if p + 1 < Tl:
                        rv = rv - lv.C[:, p] @ cur[:, p + 1 - xlo]
                    nxt[:, i - ilo] = lv.invD[:, p] @ rv
                cur = nxt
            out[:, iv[0][0]:iv[0][1] + 1, :, k0:k0 + plan.Kc] = cur
    return out


# A band-solve pass of the cells, one run that ends at one position a
# chain: (chains of the cell, levels, block size, rhs widths): the
# Monte-Carlo folds (100 trials of 4 x 50; 16 trials of 3D 4x250),
# Manhattan-4, 3D 1x1000, robot20, 3D 4x250, chains of two and four
# positions
_CHAIN_RUNS = [(400, 6, 6, (56, 1)), (64, 8, 12, (18, 1, 2)), (4, 9, 6, (138, 1, 2)),
               (1, 10, 12, (18, 1, 2)), (20, 7, 6, (258, 1)), (4, 8, 12, (18, 1)),
               (3, 1, 6, (5, 1)), (1, 1, 12, (19,)), (3, 2, 12, (3, 4))]
# the cells' band-solve passes: (chains, chain length, block size, panel width)
_PASS_CELLS = [(4, 512, 6, 138), (20, 128, 6, 258), (4, 256, 12, 18), (1, 1024, 12, 18),
               (400, 64, 6, 56), (64, 256, 12, 18)]


def _cr_run_replayed(levels, b, x, C, n_sm=132):
    """A run's reduce and back substitution replayed as the wrappers cut
    it at C chains: the chain kernels' plans where they take the run, the
    tile kernels' launches (band._cr_launch_depths, band._cr_plan)
    otherwise. Returns (reduced rhs of every level, finest x)."""
    n = len(levels)
    C_, T, Db, K = b.shape
    red, first, src = [], 0, b
    plan = band._cr_chain_plan("reduce", n, Db, K, C, n_sm)
    if plan is not None:
        red = list(_cr_reduce_chain_replay(levels, b, plan))
    else:
        for d in band._cr_launch_depths("reduce", n, Db, K):
            P, Kc = band._cr_plan("reduce", d, (T >> first) >> d, Db, K, C, n_sm)
            red += _cr_reduce_tiled(levels[first:first + d], src, P, Kc)
            first, src = first + d, red[-1]
    fine = (b,) + tuple(red[:-1])
    plan = band._cr_chain_plan("backsub", n, Db, K, C, n_sm)
    if plan is not None:
        return red, _cr_backsub_chain_replay(levels, fine, x, plan)
    step = band._backsub_step(Db, K)
    depths = band._cr_launch_depths(step, n, Db, K)
    last = n
    for d in reversed(depths):
        first = last - d
        P, Kc = band._cr_plan(step, d, (T >> first) >> d, Db, K, C, n_sm)
        x = _cr_backsub_tiled(levels[first:last], fine[first:last], x,
                              P, K if step == "narrow" else Kc)
        last = first
    return red, x


@pytest.mark.parametrize("cell_C,n,Db,Ks", _CHAIN_RUNS)
def test_cr_cells_runs_replayed(cell_C, n, Db, Ks):
    """Every cell's band-solve pass (one run to one position a chain),
    replayed in PyTorch as the wrappers cut it at the cell's chain count
    (the tree reduce's tile stage and chunks; the back
    substitution's segments and chunks), on 2 chains, against the plain
    twins: 1e-15 relative (the same products in the same grouping)."""
    C, T = 2, 1 << n
    levels = _cr_levels(C, T, Db, n, seed=n + Db)
    rng = np.random.default_rng(n + Db)
    for K in Ks:
        b = torch.tensor(rng.standard_normal((C, T, Db, K)))
        x = torch.tensor(rng.standard_normal((C, 1, Db, K)))
        want = band.band_cr_reduce_plain(levels, b)
        red, got = _cr_run_replayed(levels, b, x, cell_C)
        for g, w in zip(red, want):
            assert _rel(g, w) <= 1e-15
        fine = (b,) + want[:-1]
        assert _rel(got, band.band_cr_backsub_plain(levels, fine, x)) <= 1e-15
        # and the plans at 1 and 400 chains
        for C_ in (1, 400):
            plan = band._chain_plan("reduce", n, Db, K, C_)
            for g, w in zip(_cr_reduce_chain_replay(levels, b, plan), want):
                assert _rel(g, w) <= 1e-15
            plan = band._chain_plan("backsub", n, Db, K, C_)
            got = _cr_backsub_chain_replay(levels, fine, x, plan)
            assert _rel(got, band.band_cr_backsub_plain(levels, fine, x)) <= 1e-15


@pytest.mark.parametrize("C,Tp,Db,panel", _PASS_CELLS)
def test_cr_tree_tickets_take_every_tile_once(C, Tp, Db, panel):
    """The tree reduce's tickets at every cell's plans (K = 1, 2, the
    panel), its tile stage's thread blocks arriving in order, in reverse and
    in two random orders on 3 chains: the whole-chain stage of every chain
    and chunk of columns runs exactly once, after every tile of that chain
    and chunk, and every counter is zero after the launch."""
    n = band.num_levels(Tp)
    for K in (1, 2, panel):
        plan = band._chain_plan("reduce", n, Db, K, C)
        if not plan.top:
            continue
        chunks, C3 = -(-K // plan.Kf), 3
        tiles = (Tp >> plan.top) // plan.P
        blocks = C3 * tiles * chunks
        rng = np.random.default_rng(K)
        for order in (range(blocks), range(blocks - 1, -1, -1), rng.permutation(blocks),
                      rng.permutation(blocks)):
            ran, counters = _tree_tickets_replayed(plan, n, C3, chunks, list(order))
            assert sorted((c, q) for c, q, _ in ran) == [
                (c, q) for c in range(C3) for q in range(chunks)]
            for c, q, had in ran:
                assert had == set(range(tiles))
            assert counters == [[0] * chunks for _ in range(C3)]


@pytest.mark.parametrize("Db", [6, 12])
@pytest.mark.parametrize("n", range(1, 11))
def test_cr_chain_plan(n, Db):
    """The chain kernels' plans at every run length a launch takes, at the
    widths of directions, 3D and 2D panels and robot20: the reduce's plan
    takes every run, the back substitution's all but those the tile kernels
    keep in one launch (band._chain_takes), every direction's (K <= 4);
    within the card's 227 KB (the tree reduce's flag and mbarriers included); a tile
    stage below n levels; a whole-chain stage (no tile stage) holds no
    halo: its shared memory is exactly its E, F and its rhs chunks; the
    tile stage only where the chains do not fill the card or the whole
    chain does not fit a thread block; a back substitution's thread blocks
    give every second SM one where the chain allows, the directions' a lane
    group for each position of a segment's widest level within
    band._LANES_THREADS."""
    T, BS = 1 << n, Db * Db
    for C in (1, 4, 20, 64, 400):
        for K in (1, 2, 5, 18, 19, 56, 138, 258):
            assert band._chain_takes("reduce", n, Db, K, C, 132)
            r = band._chain_plan("reduce", n, Db, K, C)
            smem = band._tree_reduce_smem(n, Db, K, r)
            assert smem <= band._SMEM_MAX and 1 <= r.Kc <= K and 1 <= r.Kf <= K
            assert 0 <= r.top < n and r.P >= 1 and T >> r.top >= r.P
            assert not r.top or r.Kc == K or (K % 2 == 0 and r.Kc % 2 == 0)
            # a whole chain a chunk of the tile stage, read in 16-byte units
            assert not r.top or (r.Kc <= r.Kf and (r.Kf == K or r.Kf % 2 == 0))
            if not r.top:
                ring = (2 if r.Kc < K else 1) * T * Db * r.Kc
                assert smem == 8 * (ring + (2 * (T - 1) * BS if r.stage else 0)) + band._TREE_HEADER
            assert not r.top or C < 132 or band._whole_chain(n, Db, K, 0, band._SMEM_MAX) is None
            # the tile kernels keep a back substitution only where they take
            # it in one launch
            assert band._chain_takes("backsub", n, Db, K, C, 132) or (
                len(band._cr_launch_depths(band._backsub_step(Db, K), n, Db, K)) == 1)
            assert band._chain_takes("backsub", n, Db, K, C, 132) or K > 4 or (
                C >= band._MANY_CHAINS)
            bk = band._chain_plan("backsub", n, Db, K, C)
            smem, rows, items = band._chain_backsub_shape(n, Db, bk.S, bk.Kc)
            if K <= band._LANES_MAX_K[Db]:  # a lane group a position: two x buffers of K
                most = band._LANES_THREADS
                assert bk.Kc == K and items * band._LANE_GROUP[Db] <= most
                assert 16 * rows * Db * K <= band._SMEM_MAX
                assert bk.S in (1, T) or band._chain_backsub_shape(
                    n, Db, bk.S // 2, K)[2] * band._LANE_GROUP[Db] > most or 2 * C * bk.S < 264
                assert 2 * C * bk.S >= min(132, 2 * C * T)
                continue
            assert smem <= band._SMEM_MAX and 1 <= bk.Kc <= K and T % bk.S == 0
            if bk.S == 1:  # the ring's slots: the three widest levels
                widest = [(T >> (lev + 1)) * (3 * BS + Db * bk.Kc) for lev in range(min(n, 3))]
                assert smem == 8 * (sum(widest) + 2 * (T // 2) * Db * bk.Kc)
            assert 2 * C * bk.S >= min(132, 2 * C * T)


def test_cr_chain_plans_of_the_cells():
    """The thread blocks of the cells' passes: the 100-trial fold's reduce a
    chain a thread block (400, its E, F staged once, all 56 columns) and its
    back substitution 4 segments a chain (1,600, two thread blocks an SM); 3D 1x1000's reduce a tile
    stage of 64 positions at K = 1 and of 32 positions by two chunks of
    columns at the panel, which leaves 32 positions to the whole-chain
    stage, a thread block a chunk; its back substitution 128 segments. One
    launch each way a
    pass on every cell and width, at any trial count (the launches a trip
    of a Monte-Carlo batch equal a 1-trial batch's)."""
    blocks = lambda r, C, n, K: (C * ((1 << n) >> r.top) // r.P * -(-K // r.Kf)
                                 if r.top else C)
    for C, n, Db, K, want in ((400, 6, 6, 56, (400, 1600)), (1, 10, 12, 18, (64, 128)),
                              (1, 10, 12, 1, (64, 128))):
        r = band._cr_chain_plan("reduce", n, Db, K, C)
        bk = band._cr_chain_plan("backsub", n, Db, K, C)
        assert (blocks(r, C, n, K), C * bk.S) == want
    assert band._cr_chain_plan("reduce", 6, 6, 56, 400).stage
    assert band._cr_chain_plan("reduce", 10, 12, 18, 1)[:3] == (5, 1, 10)
    # (reduce, back substitution) launches a pass: (2, 2) on Manhattan-4 and
    # 3D 1x1000 before (runs of 5 + 4 and 5 + 5), (1, 2) at the 3D fold's
    # panel
    for C, Tp, Db, panel in _PASS_CELLS:
        n = band.num_levels(Tp)
        for K in (1, 2, 4, panel):
            assert band.cr_solve_launches(n, Db, K, 1, C) == (1, 1)
            for C_ in (1, 3, 4, 16, 100, 400, 1600):
                assert band.cr_solve_launches(n, Db, K, 1, C_) == (1, 1)
    assert band.cr_solve_launches(8, 12, 18, Tn=4) == (2, 2)
    assert band.cr_solve_launches(11, 12, 18, 1, 1) == (3, 3)


def test_band_solve_bits_of_the_per_level_composition():
    """band_solve on the CPU (the plain twins, one run of every level to
    one block a chain) gives the bits of the per-level composition that a
    solve cut into runs of at most 8 levels gave: each level's reduction,
    x = invD b on the one block, each level's back substitution, and the
    3D refinement step."""
    for C, T, Db, K in ((2, 512, 6, 3), (1, 1024, 12, 2)):
        D, U = (torch.tensor(a) for a in _chains(C, T, Db, T + Db))
        rhs = torch.tensor(np.random.default_rng(T).standard_normal((C, T, Db, K)))
        f = band.band_factor(D, U)

        def once(b):
            fine = [b]
            for lv in f.levels:
                fine.append(band._cr_reduce_level(lv.E, lv.F, fine[-1]))
            x = f.invD @ fine[-1]
            for lv, bf in zip(reversed(f.levels), reversed(fine[:-1])):
                x = band._cr_backsub_level(lv.invD, lv.A, lv.C, bf, x)
            return x

        want = once(rhs)
        for _ in range(band.refine_steps(Db)):
            want = want + once(rhs - band.band_matvec(D, U, want))
        assert torch.equal(band.band_solve(f, rhs), want)


# ------------------------------------------------------------------ #
# band_cr_factor: a run of compacting levels in one launch
# ------------------------------------------------------------------ #

# The band factors of the cells: (chains, chain length, block size) of
# Manhattan-4, robot20, 3D 4x250, 3D 1x1000, the 2D and the 3D fold; the
# first are those band_cr_factor takes (Db = 6, the size it is built for).
_FACTOR_CELLS = [(4, 512, 6), (20, 128, 6), (4, 256, 12), (1, 1024, 12), (400, 64, 6),
                 (64, 256, 12)]
_FACTOR_CELLS_2D = [cell for cell in _FACTOR_CELLS if cell[2] == 6]


def _rel0(a, b):
    """_rel where b may be all zero (a chain's first E, the last level's A
    and C): then the largest difference itself."""
    return np.max(np.abs(np.asarray(a) - np.asarray(b))) / max(np.max(np.abs(np.asarray(b))),
                                                             1e-300)


def _random_band(C, Tp, Db, seed):
    """A random SPD band (D, U) and A = band_init_a(U), in the band
    convention."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((C, Tp, Db, Db))
    D = torch.tensor(M @ np.swapaxes(M, -1, -2) + (2.0 + 4.0 * Db) * np.eye(Db))
    U = 0.3 * rng.standard_normal((C, Tp, Db, Db))
    U[:, -1] = 0.0
    U = torch.tensor(U)
    return D, band.band_init_a(U), U


@pytest.mark.parametrize("Db", [6, 12])
@pytest.mark.parametrize("T,n", [(2, 1), (8, 2), (16, 4), (64, 3)])
def test_cr_factor_plain_is_the_per_level_composition(T, n, Db):
    """band_cr_factor_plain is band_cr_level_plain n times, bit for bit,
    and, where the run ends at one position a chain, band_block_inv_plain
    of the last D' in place of the band it leaves."""
    D, A, U = _random_band(3, T, Db, seed=T + n + Db)
    Dl, Al, Cl, want = D, A, U, []
    for _ in range(n):
        out = band.band_cr_level_plain(Dl, Al, Cl)
        want.append(out[:5])
        Dl, Al, Cl = out[5:]
    last = T >> n == 1
    run = band.band_cr_factor_plain(D, A, U, n, last)
    assert len(run.levels) == n
    for got, w in zip(run.levels, want):
        assert all(torch.equal(g, x) for g, x in zip(got, w))
    if last:
        assert run.D is None and torch.equal(run.invD, band.band_block_inv_plain(Dl))
    else:
        assert run.invD is None
        assert all(torch.equal(g, x) for g, x in zip((run.D, run.A, run.C), (Dl, Al, Cl)))
    # the wrapper on CPU tensors is the plain twin
    got = band.band_cr_factor(D, A, U, n, last)
    assert all(torch.equal(g, x) for g, x in zip(got.levels[-1], run.levels[-1]))


def _cr_factor_replay(D, A, C, n, P, last):
    """band_cr_factor replayed as csrc/band.cu cuts it: a thread block a tile
    of P positions j0 .. j0 + P - 1 of level n of one chain, the fine rows
    2^n j0 - (2^n - 1) .. 2^n (j0 + P) - 1 staged (the left halo; none
    before the chain's start), every level in place (level l's position p in
    the slot of fine row p << l): the odd rows (2q + 1) << (l - 1) inverted
    over their D, then E, F, and A', C', D' over the even row's A, C, D, for
    the tile's positions and the halo's; only the tile's own positions
    written, then its level-n band or the last block's inverse."""
    nC, T, Db, _ = D.shape
    Tn, span = T >> n, 1 << n
    nan = lambda *shape: torch.full(shape, float("nan"), dtype=D.dtype)
    levels = [band.CRLevel(*(nan(nC, T >> (lev + 1), Db, Db) for _ in range(5)))
              for lev in range(n)]
    band_out = [nan(nC, Tn, Db, Db) for _ in range(3)]
    invD = nan(nC, 1, Db, Db)
    for c in range(nC):
        for j0 in range(0, Tn, P):
            lo, hi = max(0, span * j0 - (span - 1)), span * (j0 + P) - 1
            Ds, As, Cs = (t[c, lo:hi + 1].clone() for t in (D, A, C))
            for lev in range(1, n + 1):
                w, step = n - lev, 1 << (lev - 1)
                plo, phi = max(0, (j0 << w) - ((1 << w) - 1)), ((j0 + P) << w) - 1
                odd = (2 * torch.arange(max(plo - 1, 0), phi + 1) + 1) * step - lo
                Ds[odd] = band.band_block_inv_plain(Ds[odd])
                p = torch.arange(plo, phi + 1)
                ie, iu = 2 * p * step - lo, (2 * p + 1) * step - lo
                dn = (p > 0).view(-1, 1, 1)
                idn = torch.where(p > 0, ie - step, iu)
                E = torch.where(dn, -(As[ie] @ Ds[idn]), torch.zeros_like(As[ie]))
                F = -(Cs[ie] @ Ds[iu])
                mine = p >= j0 << w
                for lv, blk in zip(levels[lev - 1], (E, F, Ds[iu], As[iu], Cs[iu])):
                    lv[c, p[mine]] = blk[mine]
                D2 = Ds[ie] + (E @ Cs[idn] + F @ As[iu])
                A2, C2 = E @ As[idn], F @ Cs[iu]
                Ds[ie], As[ie], Cs[ie] = D2, A2, C2
            if last:
                invD[c] = band.band_block_inv_plain(Ds[:1])
            else:
                rows = (torch.arange(j0, j0 + P) << n) - lo
                for o, t in zip(band_out, (Ds, As, Cs)):
                    o[c, j0:j0 + P] = t[rows]
    if last:
        return band.CRRun(tuple(levels), None, None, None, invD)
    return band.CRRun(tuple(levels), *band_out, None)


def _factor_replayed(D, A, U, cell_C, n_sm=132):
    """A factor's runs (band._factor_runs) replayed at the tiles the planner
    gives the cell's chain count (band._factor_tile): (levels, last
    invD)."""
    nC, Tp, Db, _ = D.shape
    levels, T = [], Tp
    for n in band._factor_runs(Tp, Db):
        last = T >> n == 1
        run = _cr_factor_replay(D, A, U, n, band._factor_tile(n, T, Db, cell_C, n_sm), last)
        levels += run.levels
        T >>= n
        if last:
            return levels, run.invD
        D, A, U = run.D, run.A, run.C
    raise AssertionError("the runs do not end at one block a chain")


@pytest.mark.parametrize("cell", _FACTOR_CELLS_2D)
def test_cr_factor_partitioned_as_the_plan(cell):
    """Every cell's factor replayed in PyTorch as band_cr_factor's launches
    cut it at the cell's chain count (the runs, each run's tiles with their
    halo, the levels in place), on 2 chains of the cell's length (3 for a
    single chain), against the plain twins: 1e-15 relative."""
    cell_C, Tp, Db = cell
    D, A, U = _random_band(2 if cell_C > 1 else 3, Tp, Db, seed=Tp + Db)
    levels, invD = _factor_replayed(D, A, U, cell_C)
    want = band.band_factor(D, U)
    assert len(levels) == len(want.levels) == band.num_levels(Tp)
    for got, w in zip(levels, want.levels):
        for g, x in zip(got, w):
            assert _rel0(g, x) <= 1e-15
    assert _rel0(invD, want.invD) <= 1e-15


@pytest.mark.parametrize("n,T,P,last", [(1, 2, 1, True), (2, 4, 1, True), (1, 8, 2, False),
                                        (3, 64, 2, False), (2, 64, 4, False), (3, 16, 1, False)])
def test_cr_factor_partitioned_at_the_edges(n, T, P, last):
    """The replayed tiles at the edges: chains of 2 and 4 (one launch, no
    halo), tiles of several positions, a tile at every chain's start and
    one after it, an odd chain count."""
    D, A, U = _random_band(3, T, 6, seed=T + n + P)
    got = _cr_factor_replay(D, A, U, n, P, last)
    want = band.band_cr_factor_plain(D, A, U, n, last)
    for g, w in zip(got.levels, want.levels):
        assert all(_rel0(a, b) <= 1e-15 for a, b in zip(g, w))
    tail = ("invD",) if last else ("D", "A", "C")
    assert all(_rel0(getattr(got, f), getattr(want, f)) <= 1e-15 for f in tail)


def test_cr_factor_plans_of_the_cells():
    """The planner on the cells: at Db = 6, where band_factor takes
    band_cr_factor, at most two launches a factor and no band_block_inv
    (against log2(Tp) + 1 before); at Db = 12 a band_cr_level launch a
    level and band_block_inv; the runs, the tiles and the launch count
    depend on (Tp, Db) alone, whatever the chain count; every launch's
    shared memory fits the card's 227 KB; the last run is a chain a thread
    block."""
    for C, Tp, Db in _FACTOR_CELLS:
        assert band._factor_takes(Db) == (Db == band._FACTOR_MAX_BLOCK == 6)
        if Db != 6:
            assert band.factor_launches(Tp, Db) == band.num_levels(Tp) + 1
            continue
        runs = band._factor_runs(Tp, Db)
        assert sum(runs) == band.num_levels(Tp) and len(runs) <= 2
        assert band.factor_launches(Tp, Db) == len(runs)
        T = Tp
        for n in runs:
            for chains in (1, 2, 3, 4, 64, 400, C):
                P = band._factor_tile(n, T, Db, chains)
                assert (T >> n) % P == 0
                assert band._factor_smem(n, T, P, Db, T >> n == 1) <= band._SMEM_MAX
            T >>= n
        assert T == 1
    # every chain length up to 2^16: a plan that fits, the chain count out
    # of the count
    for L in range(0, 17):
        Tp = 1 << L
        runs = band._factor_runs(Tp, 6)
        assert sum(runs) == L and all(1 <= n <= 8 for n in runs)
        assert band.factor_launches(Tp, 6) == max(len(runs), 1)
        for n_cr in range(L + 1):
            assert sum(band._factor_runs(Tp, 6, n_cr)) == n_cr
        T = Tp
        for n in runs:
            for C in (1, 7, 400):
                P = band._factor_tile(n, T, 6, C)
                assert band._factor_smem(n, T, P, 6, T >> n == 1) <= band._SMEM_MAX
            T >>= n


def test_cr_level_tiles_of_the_cells():
    """band_cr_level's positions a thread block at Db = 12: 3 on the 3D
    fold's first four levels (8,192 down to 1,024 positions), 1 below and
    on every level of the 3D solves (at most 512 positions); 1 at Db = 6;
    the tile moves the grid only, so a factor's launches stay one a level."""
    tiles = lambda C, Tp, Db: [band._cr_level_tile(C, Tp >> lev, Db)
                               for lev in range(1, band.num_levels(Tp) + 1)]
    assert tiles(64, 256, 12) == [3, 3, 3, 3, 1, 1, 1, 1]
    assert tiles(4, 256, 12) == [1] * 8 and tiles(1, 1024, 12) == [1] * 10
    assert tiles(400, 64, 6) == [1] * 6 and tiles(4, 512, 6) == [1] * 9
    assert band._cr_level_tile(1, 1023, 12) == 1 and band._cr_level_tile(1, 1024, 12) == 3


def _cr_level_replay(D, A, C, P):
    """band_cr_level at Db = 12 replayed as csrc/band.cu's
    cr_level_element_kernel cuts it: the coarse positions of all chains end
    to end, a thread block P of them and P + 1 odd rows, the first the row
    before its first position where that position has one below in its
    chain (a tile may cross a chain's end); each odd block inverted where a
    thread block wants it, the identity where not; then E, F, A', C', D' of
    the tile's positions from the thread block's own inverses."""
    nC, T, Db, _ = D.shape
    Th, n = T // 2, nC * (T // 2)
    flat = lambda t: t.reshape(n, 2, Db, Db)
    Df, Af, Cf = flat(D), flat(A), flat(C)
    eye = torch.eye(Db, dtype=D.dtype)
    outs = [torch.full((n, Db, Db), float("nan"), dtype=D.dtype) for _ in range(8)]
    for t0 in range(0, n, P):
        inv = []
        for g in range(P + 1):
            t = t0 + g - 1
            want = t < n and (g > 0 or (t >= 0 and (t + 1) % Th != 0))
            inv.append(band.band_block_inv_plain(Df[t, 1]) if want else eye)
        for g in range(1, P + 1):
            t = t0 + g - 1
            if t >= n:
                break
            dn = t % Th != 0
            E = -(Af[t, 0] @ inv[g - 1]) if dn else torch.zeros_like(eye)
            F = -(Cf[t, 0] @ inv[g])
            Ad = Af[t - 1, 1] if dn else eye
            Cd = Cf[t - 1, 1] if dn else eye
            A2 = E @ Ad if dn else torch.zeros_like(eye)
            d1 = E @ Cd if dn else torch.zeros_like(eye)
            vals = (E, F, inv[g], Af[t, 1], Cf[t, 1], Df[t, 0] + (d1 + F @ Af[t, 1]), A2,
                    F @ Cf[t, 1])
            for o, v in zip(outs, vals):
                o[t] = v
    return tuple(o.reshape(nC, Th, Db, Db) for o in outs)


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("nC,T", [(3, 10), (5, 8), (2, 64), (7, 2)])
def test_cr_level_partitioned_as_the_tiles(nC, T, P):
    """band_cr_level replayed at P = 1 and 3 positions a thread block, with
    tiles that end inside a chain, cross a chain's end and run past the
    last position: the plain twin's outputs, 1e-15 relative."""
    D, A, U = _random_band(nC, T, 12, seed=nC * T + P)
    got = _cr_level_replay(D, A, U, P)
    want = band.band_cr_level_plain(D, A, U)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel0(g, w) <= 1e-15


@pytest.mark.parametrize("C", [1, 2, 3])
def test_band_factor_launches_a_run_at_a_time(C, monkeypatch):
    """band_factor calls band_cr_factor once a run of band._factor_runs at
    Db = 6 (band_cr_level once a level at Db = 12: band._factor_takes), the
    same calls at every chain count, and band_block_inv only where the
    levels stop above one block a chain or ran one a launch
    (band.factor_launches)."""
    calls = []
    run, inv = band.band_cr_factor, band.band_block_inv
    monkeypatch.setattr(band, "band_cr_factor",
                        lambda *a, **k: calls.append(("run", a[3], k.get("last"))) or run(*a, **k))
    monkeypatch.setattr(band, "band_block_inv", lambda D: calls.append(("inv",)) or inv(D))
    level = band.band_cr_level
    monkeypatch.setattr(band, "band_cr_level",
                        lambda *a: calls.append(("level",)) or level(*a))
    for Tp, Db, n_cr in ((512, 6, None), (256, 12, None), (64, 6, 4), (1, 6, None),
                         (128, 6, None), (64, 12, 3)):
        calls.clear()
        D, _, U = _random_band(C, Tp, Db, seed=Tp)
        band.band_factor(D, U, n_cr=n_cr)
        n_cr = band.cr_depth(Tp) if n_cr is None else n_cr
        runs = band._factor_runs(Tp, Db, n_cr) if band._factor_takes(Db) else []
        Tb = Tp >> n_cr
        want = [("run", n, Tp >> sum(runs[:i + 1]) == 1) for i, n in enumerate(runs)]
        if not band._factor_takes(Db):
            want = [("level",)] * n_cr
        want += [("inv",)] if Tb > 1 or not runs else []
        assert calls == want
        assert len(calls) + band.num_levels(Tb) == band.factor_launches(Tp, Db, n_cr)
