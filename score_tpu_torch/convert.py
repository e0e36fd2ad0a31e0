"""Carry the reference's state across to the port.

The tests feed both packages exactly the same problem: a factor graph or a
conic program built by the JAX package (``score_tpu``) is walked by
attribute access only, so this module never imports ``score_tpu`` (or
jax), and rebuilt from numpy arrays and plain Python values as the port's
own types on a chosen device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from score_tpu_torch.assembly.conic import ConicProblem
from score_tpu_torch.fg import factor_graph, measurements, priors, variables

__all__ = ["problem_from_reference", "factor_graph_from_reference"]

_PROBLEM_FIELDS = ("cost_cols", "cost_coefs", "cost_b", "cost_w", "cone_cols",
                   "cone_coefs", "cone_h", "pin_idx", "pin_val", "c0")

# the port's factor-graph classes by name (the reference uses the same names)
_CLASSES = {
    cls.__name__: cls
    for mod in (variables, measurements, priors, factor_graph)
    for cls in vars(mod).values()
    if isinstance(cls, type) and dataclasses.is_dataclass(cls)
    and cls.__module__ == mod.__name__
}


def problem_from_reference(ref, device="cuda") -> ConicProblem:
    """The port's ConicProblem on ``device`` from a reference ConicProblem
    (any object with the same array attributes and ``n``, ``k``, ``dim``,
    ``relaxation``). Float arrays keep their dtype, so a float32 reference
    problem gives a float32 port problem."""
    arrays = {name: np.asarray(getattr(ref, name)) for name in _PROBLEM_FIELDS}
    return ConicProblem.from_arrays(arrays, n=ref.n, k=ref.k, dim=ref.dim,
                                    relaxation=ref.relaxation, device=device)


def _convert(value):
    name = type(value).__name__
    if name in _CLASSES:
        cls = _CLASSES[name]
        return cls(**{f.name: _convert(getattr(value, f.name))
                      for f in dataclasses.fields(cls)})
    if isinstance(value, list):
        return [_convert(v) for v in value]
    if isinstance(value, tuple):
        return tuple(_convert(v) for v in value)
    if isinstance(value, (set, frozenset)):
        return {_convert(v) for v in value}
    if isinstance(value, np.ndarray):
        return np.array(value)
    return value


def factor_graph_from_reference(ref) -> factor_graph.FactorGraphData:
    """The port's FactorGraphData from a reference FactorGraphData: every
    variable, measurement and prior is rebuilt as the port class of the
    same name, field by field."""
    if type(ref).__name__ != "FactorGraphData":
        raise TypeError(f"expected a FactorGraphData, got {type(ref).__name__}")
    return _convert(ref)
