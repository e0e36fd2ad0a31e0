"""The port's cyclic reduction (solver/pcr.py, the f32 band) against the
JAX package's ``jax.vmap(pcr_factor / pcr_solve)`` and dense solves.

Chains are padded with decoupled identity blocks after their active
prefixes, as the chain+arrow backend pads them. Tolerances: 1e-12
relative in f64 (same formulas and order; the port keeps compacted level
shapes where the JAX scan refills with identity padding, which leaves the
valid blocks' arithmetic unchanged); 1e-4 in f32 (the two packages' batched
6x6 products sum in different orders); 1e-10 against a dense f64 solve.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from score_tpu.solver.pcr import pcr_factor as ref_factor, pcr_solve as ref_solve
from tests.test_pcr_tf import _block_tridiag, _dense

from score_tpu_torch.solver import pcr as port_pcr
from score_tpu_torch.solver import smallblocks as psb
from score_tpu_torch.solver.pcr import pcr_factor, pcr_pad_length, pcr_solve

torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300)


def _chains(C, T, Db, seed, active):
    Ds, Us = [], []
    for c in range(C):
        D, U = _block_tridiag(T, Db, seed + c)
        D[active[c]:] = np.eye(Db)
        U[max(active[c] - 1, 0):] = 0.0
        Ds.append(D)
        Us.append(U)
    return np.stack(Ds), np.stack(Us)


CASES = [
    (3, 16, 6, (16, 11, 3)),
    (2, 32, 6, (32, 20)),
    (2, 1, 6, (1, 1)),  # one block per chain: no levels
    (2, 8, 12, (8, 5)),  # 3D poses: 12 x 12 blocks
]


@pytest.mark.parametrize("C,T,Db,active", CASES)
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-4)])
def test_pcr_matches_jax(C, T, Db, active, dtype, tol):
    D, U = _chains(C, T, Db, 7 * T + Db, active)
    D, U = D.astype(dtype), U.astype(dtype)
    f = pcr_factor(torch.tensor(D), torch.tensor(U))
    rf = jax.jit(jax.vmap(ref_factor))(jnp.asarray(D), jnp.asarray(U))
    for K in (1, 6):
        rhs = np.random.default_rng(K).standard_normal((C, T, Db, K)).astype(dtype)
        x = pcr_solve(f, torch.tensor(rhs))
        assert x.dtype == f.L_root.dtype and x.shape == rhs.shape
        assert _rel(x, jax.jit(jax.vmap(ref_solve))(rf, jnp.asarray(rhs))) <= tol
    # every level's stored blocks: the JAX level state keeps the valid
    # blocks in its first T / 2^(l+1) entries
    assert len(f.L_odd) == int(np.log2(T))
    for lev in range(len(f.L_odd)):
        n = T >> (lev + 1)
        for name in ("L_odd", "W1", "W2"):
            got = getattr(f, name)[lev]
            assert got.shape == (C, n, Db, Db)
            assert _rel(got, np.asarray(getattr(rf, name))[:, lev, :n]) <= tol
    assert _rel(f.L_root, rf.L_root) <= tol


@pytest.mark.parametrize("C,T,Db,active", CASES[:3])
def test_pcr_matches_dense(C, T, Db, active):
    D, U = _chains(C, T, Db, 3 * T, active)
    rhs = np.random.default_rng(5).standard_normal((C, T, Db, 3))
    x = pcr_solve(pcr_factor(torch.tensor(D), torch.tensor(U)), torch.tensor(rhs)).numpy()
    for c in range(C):
        xref = np.linalg.solve(_dense(D[c], U[c]), rhs[c].reshape(T * Db, 3))
        assert _rel(x[c].reshape(T * Db, 3), xref) <= 1e-10


def test_pcr_rejects_unpadded_chains():
    D, U = _chains(1, 8, 6, 1, (8,))
    assert [pcr_pad_length(t) for t in (1, 5, 8, 400)] == [1, 8, 8, 512]
    with pytest.raises(ValueError):
        pcr_factor(torch.tensor(D[:, :6]), torch.tensor(U[:, :6]))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("K,transposed", [(1, False), (6, False), (6, True)])
def test_dinv_is_the_two_substitutions_bit_for_bit(dtype, K, transposed):
    """Off the card ``_dinv`` is forward then back substitution exactly as
    before the fused kernel took its place on the card: the same bits, for
    the rhs views a factor and a solve hand it (every second block of a
    chain, transposed for W2)."""
    D, _ = _chains(2, 16, 6, 11, (16, 9))
    L = psb.chol_small(torch.tensor(D).to(dtype)[:, 1::2])
    rhs = torch.tensor(np.random.default_rng(K).standard_normal((2, 16, 6, K))).to(dtype)
    M = rhs[:, 0::2].transpose(-1, -2) if transposed else rhs[:, 1::2]
    want = psb.tri_upper_solve(L, psb.tri_lower_solve(L, M))
    assert torch.equal(port_pcr._dinv(L, M), want)
    assert torch.equal(psb.chol_solve(L, M), want)
