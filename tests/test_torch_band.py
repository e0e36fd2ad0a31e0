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
    for got, want in zip(band.band_pcr_level(D, A, U, 2),
                         band.band_pcr_level_plain(D, A, U, 2)):
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
