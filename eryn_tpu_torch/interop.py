"""Carry an ensemble and a ladder between packages as numpy arrays.

A state travels as a dict ``{"coords": {branch: array}, "inds": {branch:
array}, "log_like": array, "log_prior": array, "betas": array, "blobs":
array, "supplemental": {name: array}, "branch_supplemental": {branch:
{name: array}}}`` (missing fields are None; the supplementals hold their
numeric entries); a tempering control as ``{"betas", "time",
"swaps_accepted", "swaps_proposed"}``; priors as ``{key: (constructor
name, params)}``; a move's kernel state as its tree of arrays (dicts walked
in sorted key order, as both packages store them).  Any package whose
arrays convert with ``np.asarray`` can build these, so two samplers can
start from the same ensemble, ladder, priors and kernel states.  A
:class:`~eryn_tpu_torch.state.ParaState` travels as the same dict, folded
(``(ngroups * ntemps, ...)``) or group-batched, with ``"ngroups"`` and
``"groups_running"``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prior as _prior
from .state import BranchSupplemental, ParaState, State, resolve_device
from .utils.pytree import tree_flatten, tree_unflatten

__all__ = [
    "kernel_state_from_numpy",
    "kernel_state_to_numpy",
    "para_state_from_numpy",
    "para_state_to_numpy",
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
    :func:`~eryn_tpu_torch.state.resolve_device`) from a numpy dict.  Blobs
    and supplemental entries keep their own dtypes."""
    device = resolve_device(device)

    def put(x, dt=dtype):
        # a copy: arrays of other packages may be read-only
        return None if x is None else torch.tensor(
            np.array(x), dtype=dt, device=device
        )

    def supp(h):
        if h is None:
            return None
        return BranchSupplemental(
            {k: torch.as_tensor(np.array(v), device=device)
             for k, v in h.items()})

    inds = d.get("inds")
    blobs = d.get("blobs")
    bsupps = d.get("branch_supplemental") or {}
    return State(
        {n: put(c) for n, c in d["coords"].items()},
        inds=None if inds is None else {
            n: put(m, torch.bool) for n, m in inds.items()
        },
        blobs=None if blobs is None else torch.as_tensor(
            np.array(blobs), device=device),
        supplemental=supp(d.get("supplemental")),
        branch_supplemental={n: supp(h) for n, h in bsupps.items()},
        **{f: put(d.get(f)) for f in _FIELDS},
    )


def state_to_numpy(state):
    """Numpy dict of a :class:`State` (from this package or any state with
    the same attribute names; a supplemental's numeric entries are its
    ``holder``)."""
    def supp(s):
        return None if s is None else {k: _host(v)
                                       for k, v in s.holder.items()}

    return {
        "coords": {n: _host(b.coords) for n, b in state.branches.items()},
        "inds": {n: _host(b.inds) for n, b in state.branches.items()},
        "blobs": _host(state.blobs),
        "supplemental": supp(state.supplemental),
        "branch_supplemental": {
            n: supp(b.branch_supplemental) for n, b in state.branches.items()
            if b.branch_supplemental is not None},
        **{f: _host(getattr(state, f)) for f in _FIELDS},
    }


def para_state_from_numpy(d, device=None, dtype=torch.float32):
    """A :class:`ParaState` on ``device`` (default: the card) from a numpy
    dict of :func:`state_from_numpy`'s fields, group-batched
    (``(ngroups, ntemps, ...)``) or folded, with optional ``"ngroups"``
    (needed for folded input) and ``"groups_running"``: the state of
    :class:`eryn_tpu.state.ParaState` carried over."""
    device = resolve_device(device)

    def put(x, dt=dtype):
        return None if x is None else torch.tensor(
            np.array(x), dtype=dt, device=device)

    inds = d.get("inds")
    running = d.get("groups_running")
    return ParaState(
        {n: put(c) for n, c in d["coords"].items()},
        groups_running=None if running is None else put(running, torch.bool),
        ngroups=d.get("ngroups"),
        inds=None if inds is None else {
            n: put(m, torch.bool) for n, m in inds.items()},
        **{f: put(d.get(f)) for f in _FIELDS},
    )


def para_state_to_numpy(state):
    """Numpy dict of a :class:`ParaState` (of this package or of
    ``eryn_tpu``), folded, with ``"ngroups"`` and ``"groups_running"``."""
    out = state_to_numpy(state)
    out["ngroups"] = state.ngroups
    out["groups_running"] = _host(state.groups_running)
    return out


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


def kernel_state_to_numpy(tree):
    """The leaves of a kernel state (this package's or any nested dicts and
    tuples of arrays), as a list of numpy arrays in sorted-key order."""
    return [_host(x) for x in tree_flatten(tree)[0]]


def restore_kernel_state(fresh, leaves):
    """The kernel state ``fresh`` with its tensor leaves replaced by
    ``leaves`` (numpy arrays in sorted-key order; a None keeps the fresh
    leaf), each copied into the fresh leaf's dtype and device.  Raises a
    ``ValueError`` when the structure or a shape differs."""
    f_leaves, spec = tree_flatten(fresh)
    if len(leaves) != len(f_leaves):
        raise ValueError("kernel-state structure changed")
    out = []
    for a, b in zip(f_leaves, leaves):
        if b is None or not isinstance(a, torch.Tensor):
            out.append(a)
            continue
        if tuple(np.shape(b)) != tuple(a.shape):
            raise ValueError("kernel-state shape changed")
        out.append(torch.tensor(np.array(b), device=a.device).to(a.dtype))
    return tree_unflatten(spec, out)


def kernel_state_from_numpy(move, tree, state):
    """The kernel state of ``move`` for ``state`` (a :class:`State` of this
    package) holding the arrays of ``tree``: a kernel state of the same
    move in either package, as arrays or as the list
    :func:`kernel_state_to_numpy` gives.  Dtypes and the device are those
    of ``move.init_kernel_state(state)``."""
    leaves = tree if isinstance(tree, list) else kernel_state_to_numpy(tree)
    return restore_kernel_state(move.init_kernel_state(state), leaves)
