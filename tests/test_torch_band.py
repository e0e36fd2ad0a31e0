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


def test_cr_depth_of_the_main_path():
    """Manhattan-4 chains pad to 512 and compact once; robot20's pad to
    128 and run PCR only."""
    assert [band.cr_depth(t) for t in (1, 128, 256, 512, 2048)] == [0, 0, 0, 1, 3]


@pytest.mark.parametrize("C,T,Db", [(2, 16, 6), (1, 32, 4)])
def test_band_matches_jax_f64_cyclic_reduction(C, T, Db):
    D, U = _chains(C, T, Db, 20)
    rhs = np.random.default_rng(2).standard_normal((C, T, Db, 3))
    _, x = _port_solve(D, U, rhs)
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
    f = band.band_factor(D, U)
    b = torch.randn(2, 8, 6, 3, dtype=torch.float64)
    assert torch.equal(band.band_pcr_solve(f.E, f.F, f.invD, b),
                       band.band_pcr_solve_plain(f.E, f.F, f.invD, b))
    lv = band.band_cr_level(D, A, U)
    for got, want in zip(lv, band.band_cr_level_plain(D, A, U)):
        assert torch.equal(got, want)
    E, F, iv, Ao, Co = lv[:5]
    xe = band.band_cr_reduce(E, F, b)
    assert torch.equal(xe, band.band_cr_reduce_plain(E, F, b))
    assert torch.equal(band.band_cr_backsub(iv, Ao, Co, b, xe),
                       band.band_cr_backsub_plain(iv, Ao, Co, b, xe))
    assert [k.launches for k in band.KERNELS] == [0] * 7


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
