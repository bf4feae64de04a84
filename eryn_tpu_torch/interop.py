"""Carry an ensemble and a ladder between packages as numpy arrays.

A state travels as a dict ``{"coords": {branch: array}, "inds": {branch:
array}, "log_like": array, "log_prior": array, "betas": array}`` (missing
fields are None); a tempering control as ``{"betas", "time",
"swaps_accepted", "swaps_proposed"}``; priors as ``{key: (constructor
name, params)}``.  Any package whose arrays convert with ``np.asarray`` can
build these dicts, so two samplers can start from the same ensemble,
ladder and priors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prior as _prior
from .state import State, resolve_device

__all__ = [
    "priors_from_spec",
    "state_from_numpy",
    "state_to_numpy",
    "tempering_from_numpy",
    "tempering_to_numpy",
]

_FIELDS = ("log_like", "log_prior", "betas")

#: the constructors a prior spec may name (the names of eryn_tpu.prior's)
PRIOR_KINDS = ("uniform_dist", "log_uniform", "normal_dist", "mvn_dist",
               "MappedUniformDistribution")


def _host(x):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def priors_from_spec(spec, device=None):
    """A :class:`~eryn_tpu_torch.prior.ProbDistContainer` from ``{key:
    (kind, params)}``: ``kind`` one of :data:`PRIOR_KINDS`, ``params`` its
    positional arguments (numbers or numpy arrays).  A multivariate
    normal's mean and covariance are placed on ``device`` (default: the
    card, see :func:`~eryn_tpu_torch.state.resolve_device`)."""
    device = resolve_device(device)
    dists = {}
    for key, (kind, params) in spec.items():
        if kind not in PRIOR_KINDS:
            raise ValueError(f"Unknown prior kind {kind!r}; one of "
                             f"{PRIOR_KINDS}.")
        extra = {"device": device} if kind == "mvn_dist" else {}
        dists[key] = getattr(_prior, kind)(*params, **extra)
    return _prior.ProbDistContainer(dists)


def state_from_numpy(d, device=None, dtype=torch.float32):
    """Build a :class:`State` on ``device`` (default: the card, see
    :func:`~eryn_tpu_torch.state.resolve_device`) from a numpy dict."""
    device = resolve_device(device)

    def put(x, dt=dtype):
        # a copy: arrays of other packages may be read-only
        return None if x is None else torch.tensor(
            np.array(x), dtype=dt, device=device
        )

    inds = d.get("inds")
    return State(
        {n: put(c) for n, c in d["coords"].items()},
        inds=None if inds is None else {
            n: put(m, torch.bool) for n, m in inds.items()
        },
        **{f: put(d.get(f)) for f in _FIELDS},
    )


def state_to_numpy(state):
    """Numpy dict of a :class:`State` (from this package or any state with
    the same attribute names)."""
    return {
        "coords": {n: _host(b.coords) for n, b in state.branches.items()},
        "inds": {n: _host(b.inds) for n, b in state.branches.items()},
        **{f: _host(getattr(state, f)) for f in _FIELDS},
    }


def tempering_from_numpy(tc, d):
    """Set ``betas``, ``time`` and the swap counters of a
    :class:`~eryn_tpu_torch.moves.tempering.TemperatureControl` from a numpy
    dict; returns ``tc``."""
    tc.betas = np.asarray(d["betas"], dtype=np.float64)
    tc.ntemps = len(tc.betas)
    tc.time = int(d.get("time", 0))
    for key in ("swaps_accepted", "swaps_proposed"):
        if d.get(key) is not None:
            setattr(tc, key, np.asarray(d[key]))
    return tc


def tempering_to_numpy(tc):
    """Numpy dict of a tempering control's ladder, clock and counters."""
    return {
        "betas": np.asarray(_host(tc.betas), dtype=np.float64),
        "time": int(np.asarray(_host(tc.time))),
        "swaps_accepted": _host(tc.swaps_accepted),
        "swaps_proposed": _host(tc.swaps_proposed),
    }
