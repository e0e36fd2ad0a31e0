"""The port's solve trace (``score_tpu_torch.solver.solve_conic_traced``,
``score_tpu_torch.utils.telemetry.trace_solve``) against the JAX package's
``solve_conic_traced`` on the CPU in f64.

The JAX package's traces are read from ``tests/data/torch_reference.npz``
(``trace_*``, written by ``JAX_PLATFORMS=cpu python
tests/torch_reference_data.py --trace``): the 2 x 25 world as SOCP and the
3D loop world (2 x 30 poses, one loop closure) as QCQP, both normalized, on
``DenseBackend`` and ``ChainArrowBackend`` (``TRACE_CASES``).

Tolerances. A metrics row is [pres, dres, gap, pobj, status] after a trip,
then the step's diagnostics [alpha, nbhd_frac, sigma, gap_aff / gap,
min_detprod / mu^2, centering_flag, alpha_pre_nbhd, newton_resid]. Columns
0-4 to PERF.md section 2's parity bounds: the same final status, the
converged row (iterations) within 1, pobj within 1e-9 relative on every
row; pres and dres within 1e-6 relative plus 1e-10 absolute (100x below
the 1e-8 feasibility tolerance; measured: at most 2.3e-13 absolute, at
roundoff once converged), the gap within 1e-6 relative plus 1e-9 *
max(1, |pobj|), the objective's own bound (the gap is a difference of
objectives; measured: 3.5e-7 relative, and 1.3e-9 absolute at the 3D
world's converged gap of 1.2e-4 beside an objective of 5e3). Columns 5-12
within 1e-6 * max(1, |value|) (measured: at most 1.1e-7, on the 3D loop
world).
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

from tests import torch_reference_data as refdata

from score_tpu_torch.assembly.conic import build_conic_problem
from score_tpu_torch.assembly.normalize import normalize_factor_graph
from score_tpu_torch.convert import factor_graph_from_reference
from score_tpu_torch.solver import solve_conic_traced
from score_tpu_torch.solver.backend import DenseBackend
from score_tpu_torch.solver.chain_arrow import ChainArrowBackend, build_chain_arrow
from score_tpu_torch.solver.ipm import solve_conic, solve_conic_fixed
from score_tpu_torch.solver.params import ScoreSolverParams
from score_tpu_torch.utils.telemetry import SolveTrace, trace_solve

torch.set_num_threads(1)

REF = refdata.load()
CASES = tuple(refdata.TRACE_CASES)


def _case(case):
    """(problem, backend, aux, params, trips) of a trace case."""
    graph, relaxation, backend, trips = refdata.TRACE_CASES[case]
    fg = normalize_factor_graph(factor_graph_from_reference(refdata.trace_graph(graph)))[0]
    pp, idx = build_conic_problem(fg, relaxation, device="cpu")
    be, aux = ((DenseBackend, None) if backend == "dense"
               else (ChainArrowBackend, build_chain_arrow(pp, idx)))
    return pp, be, aux, ScoreSolverParams().ipm_params(), trips


@pytest.fixture(scope="module")
def traced():
    done = {}

    def get(case):
        if case not in done:
            pp, be, aux, params, trips = _case(case)
            res, metrics = solve_conic_traced(pp, params, num_iters=trips, backend=be,
                                              backend_aux=aux)
            done[case] = (pp, be, aux, params, trips, res, metrics)
        return done[case]

    return get


@pytest.mark.parametrize("case", CASES)
def test_trace_matches_reference(traced, case):
    _, _, _, _, trips, res, metrics = traced(case)
    ref = REF[f"trace_{case}_metrics"]
    m = metrics.numpy()
    assert metrics.dtype == torch.float64 and m.shape == ref.shape == (trips, 13)
    assert res.status == int(REF[f"trace_{case}_status"])
    assert abs(res.iterations - int(REF[f"trace_{case}_iterations"])) <= 1
    assert m[-1, 4] == ref[-1, 4] == res.status
    # the converged row: the first whose status is terminal
    assert abs(int(np.argmax(m[:, 4] != 0)) - int(np.argmax(ref[:, 4] != 0))) <= 1
    np.testing.assert_allclose(m[:, 3], ref[:, 3], rtol=1e-9, atol=0)
    np.testing.assert_allclose(m[:, :2], ref[:, :2], rtol=1e-6, atol=1e-10)
    gap_tol = 1e-6 * np.abs(ref[:, 2]) + 1e-9 * np.maximum(1.0, np.abs(ref[:, 3]))
    assert np.all(np.abs(m[:, 2] - ref[:, 2]) <= gap_tol)
    diag, ref_diag = m[:, 5:], ref[:, 5:]
    assert np.all(np.abs(diag - ref_diag) <= 1e-6 * np.maximum(1.0, np.abs(ref_diag)))


@pytest.mark.parametrize("case", CASES)
def test_trace_rows_are_the_solve(traced, case):
    """The last live row (the first with a terminal status) is the result's
    [pres, dres, gap, pobj] exactly, and every later row repeats it."""
    _, _, _, _, _, res, metrics = traced(case)
    m = metrics.numpy()
    live = res.iterations  # rows after trips 1..iterations step; the next one stops
    assert m[live, 4] == res.status and np.all(m[:live, 4] == 0)
    assert m[live, :4].tolist() == [res.pres, res.dres, res.gap, res.pobj]
    assert np.array_equal(m[live:], np.broadcast_to(m[live], m[live:].shape))


@pytest.mark.parametrize("case", CASES)
def test_untraced_solve_unchanged_by_the_trace(traced, case):
    """The step's diagnostics change no digit of the solve: the traced
    result, and ``solve_conic`` with ``record_diag`` on, bit-equal to the
    untraced solves."""
    pp, be, aux, params, trips, res, _ = traced(case)
    plain = solve_conic_fixed(pp, params, num_iters=trips, backend=be, backend_aux=aux)
    with_diag = solve_conic(pp, dataclasses.replace(params, record_diag=True), backend=be,
                            backend_aux=aux)
    untraced = solve_conic(pp, params, backend=be, backend_aux=aux)
    for a, b in ((res, plain), (with_diag, untraced)):
        assert (a.status, a.iterations, a.pobj, a.gap, a.pres, a.dres) == (
            b.status, b.iterations, b.pobj, b.gap, b.pres, b.dres)
        assert torch.equal(a.x, b.x) and torch.equal(a.z, b.z)
    assert not params.record_diag


def test_trace_solve(traced, caplog):
    """``trace_solve`` on the dense backend by default: a SolveTrace of the
    traced metrics' columns, ``as_dict`` and ``log`` up to the converged
    row, the result the traced solve's."""
    case = "2x25_socp_dense"
    pp, _, _, params, trips, res, metrics = traced(case)
    result, trace = trace_solve(pp, params, num_iters=trips)
    assert isinstance(trace, SolveTrace)
    assert (trace.iterations, trace.status) == (res.iterations, res.status)
    assert result.pobj == res.pobj and torch.equal(result.x, res.x)
    m = metrics.numpy()
    for k, name in enumerate(("pres", "dres", "gap", "pobj")):
        assert isinstance(getattr(trace, name), np.ndarray)
        assert np.array_equal(getattr(trace, name), m[:, k])
    d = trace.as_dict()
    assert set(d) == {"pres", "dres", "gap", "pobj"}
    assert all(len(v) == res.iterations + 1 for v in d.values())
    assert d["pobj"] == m[: res.iterations + 1, 3].tolist()
    with caplog.at_level(logging.INFO, logger="score_tpu_torch.solver"):
        trace.log()
    lines = [r.getMessage() for r in caplog.records if r.name == "score_tpu_torch.solver"]
    assert len(lines) == res.iterations + 1 and lines[0].startswith("iter   0: pres=")
