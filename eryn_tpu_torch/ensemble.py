"""EnsembleSampler: the user-facing orchestrator.

Port of :mod:`eryn_tpu.ensemble`.  A run is a sequence of segments; a
segment is a loop over sampler steps (in-model proposal, swap cascade,
ladder adaptation) whose stored snapshots are packed into buffers
preallocated on the device.  On a CUDA device each move's step is captured
once as a CUDA graph and replayed (:mod:`eryn_tpu_torch.graphs`, the
counterpart of ``eryn_tpu``'s compiled ``lax.scan``); ``cuda_graph=False``,
and any CPU run, launch every op of every step from Python.  Nothing inside
a segment waits for the device: no ``.item()``, no ``bool(tensor)``, no
copy to the host; the adaptation clock is a device tensor.  The host
touches the chain only when a segment is handed to the backend: a host or
file backend gets segment k's copy while the device runs segment k+1, with
the checkpoint a resumed run needs (both generators' states, the clock and
the moves' kernel states as of the segment's last step).  A sampler given a
backend that holds a chain continues it.

Likelihood contract: ``log_like_fn`` is written in torch for one walker and
vectorized with :func:`torch.func.vmap` over the flattened
``(ntemps * nwalkers)`` ensemble, or, with ``vectorize=True``, called once on
the whole batch; or it is a NumPy function, which runs on the host as Eryn
calls it (per walker, through ``pool.map`` when a pool is given, or once per
batch under ``vectorize=True``).  A step that visits the host (a host
likelihood or prior, or a move written for Eryn's host protocol) runs
eagerly in its slot of the schedule; the other moves keep their graphs.
"""

from __future__ import annotations

import itertools
import math
import os
import warnings

import numpy as np
import torch

from .backends import Backend, DeviceBackend, HDFBackend
from .backends.backend import host_leaves
from .graphs import HostPhases, StepGraphs, fixed_phases
from .interop import restore_kernel_state
from .model import Model
from .moves import DistributionGenerateRJ, StretchMove
from .moves.legacy import host_propose
from .moves.move import EvalContext, Move
from .moves.tempering import TemperatureControl
from .pbar import get_progress_bar
from .prior import ProbDistContainer
from .state import BranchSupplemental, State, resolve_device
from .utils.periodic import PeriodicContainer
from .utils.plot import PlotContainer
from .utils.profiling import SegmentTimer
from .utils.pytree import tree_flatten, tree_unflatten

__all__ = ["EnsembleSampler"]

_NUMPY_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def _numpy_state_bytes(random):
    """The state of a ``numpy.random.RandomState`` as uint8 bytes: its 624
    key words, position, Gaussian flag and cached Gaussian."""
    _, keys, pos, has_gauss, cached = random.get_state()
    return np.concatenate([
        np.asarray(keys, dtype=np.uint32).view(np.uint8),
        np.asarray([pos, has_gauss], dtype=np.int64).view(np.uint8),
        np.asarray([cached], dtype=np.float64).view(np.uint8),
    ])


def _restore_numpy_state(random, stored):
    """Set ``random`` to the state :func:`_numpy_state_bytes` stored."""
    stored = np.ascontiguousarray(np.asarray(stored, dtype=np.uint8))
    keys = stored[:624 * 4].view(np.uint32)
    pos, has_gauss = stored[624 * 4:624 * 4 + 16].view(np.int64)
    cached = stored[624 * 4 + 16:].view(np.float64)[0]
    random.set_state(("MT19937", keys, int(pos), int(has_gauss),
                      float(cached)))


def _several_ranks():
    """Whether this process is one rank of a ``torch.distributed`` program
    of several."""
    import torch.distributed as dist

    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _axes_of(move, kernel_state):
    """``move``'s :meth:`~eryn_tpu_torch.moves.Move.kernel_state_axes`;
    none for a host move, whose kernel state is empty."""
    return [] if move.host_move else move.kernel_state_axes(kernel_state)


def _crossed(prev, now, interval):
    """Whether a count moved past a multiple of ``interval`` between
    ``prev`` (excluded) and ``now`` (included): a hook whose interval the
    segments do not divide fires at the first boundary at or past each
    multiple."""
    return now // interval > prev // interval


def _walk_moves(moves):
    """The moves and, depth first, the children of each composite."""
    for m in moves:
        yield m
        yield from _walk_moves(getattr(m, "moves", None) or [])


def _normalize_key_order(key_order):
    """Per-branch key orders as lists of str and int, so that the priors'
    lists compare equal to the arrays a file's attributes give back."""

    def norm(v):
        out = []
        for x in np.atleast_1d(np.asarray(v)).tolist():
            out.append(x.decode() if isinstance(x, bytes) else x)
        return out

    return {name: norm(v) for name, v in dict(key_order).items()}


def _to_host(x):
    """A host copy of ``x``: from a CUDA device queued without waiting (into
    pinned memory; read it after the stream has passed this point)."""
    if x.device.type == "cuda":
        return x.to("cpu", non_blocking=True)
    return x.clone()


def _segment_plan(nsteps, seg, taper=False, min_seg=64):
    """Segment sizes: full segments of ``seg`` plus the remainder decomposed
    into powers of two.  ``taper=True`` replaces the last large power-of-two
    segment with a halving cascade down to ``min_seg`` (same total), so the
    final flush to a host backend is short."""
    plan = [seg] * (nsteps // seg)
    rem = nsteps % seg
    while rem:
        b = 1 << (rem.bit_length() - 1)
        plan.append(b)
        rem -= b
    if taper and any(v > min_seg and (v & (v - 1)) == 0 for v in plan):
        i = max(
            i for i, v in enumerate(plan) if v > min_seg and (v & (v - 1)) == 0
        )
        cascade = []
        b = plan[i] // 2
        while b > min_seg:
            cascade.append(b)
            b //= 2
        cascade += [b, b]
        plan[i:i + 1] = cascade
    return plan


def check_segments(moves):
    """Call ``check_segment`` of each move (composites' children included)
    that has one: a device flag a segment raised is read at its end."""
    for move in _walk_moves(moves):
        check = getattr(move, "check_segment", None)
        if check is not None:
            check()


def walkers_independent(coords):
    """Whether the walkers ``coords`` ``(nwalkers, ...)`` span the parameter
    space: finite, and their centred, scaled matrix conditioned to at most
    1e8 (as ``eryn_tpu.ensemble.walkers_independent``; NumPy)."""
    flat = np.asarray(coords)
    flat = flat.reshape(flat.shape[0], -1)
    if not np.all(np.isfinite(flat)):
        return False
    c = flat - np.mean(flat, axis=0)[None, :]
    scale = np.max(np.abs(c), axis=0)
    scale[scale == 0.0] = 1.0
    return bool(np.linalg.cond((c / scale).astype(float)) <= 1e8)


class PriorEvaluator:
    """Summed log prior over active leaves.  ``host`` says whether a
    container evaluates a distribution on the host."""

    def __init__(self, containers: dict, dtype):
        self.containers = containers
        self.dtype = dtype
        self.host = any(getattr(c, "host", False) for c in containers.values())

    def __call__(self, coords: dict, inds: dict):
        """coords ``{name: (..., nleaves_max, ndim)}``, inds ``{name: (...,
        nleaves_max)}``; returns the log prior with the leading shape."""
        total = None
        for name, container in self.containers.items():
            lp_leaf = container.logpdf(coords[name])
            lp = torch.where(inds[name], lp_leaf, 0.0).sum(dim=-1)
            total = lp if total is None else total + lp
        return total.to(self.dtype)


class _CallbackWorker:
    """One walker's call of a host likelihood, ``(argument, keywords) ->
    result``: picklable, so that ``pool.map`` can send it to other
    processes (the function pickles by its module path)."""

    def __init__(self, fn, args, kwargs):
        self.fn = fn
        self.args = tuple(args) if args else ()
        self.kwargs = dict(kwargs) if kwargs else {}

    def __call__(self, item):
        arg, kwargs_i = item
        return self.fn(arg, *self.args, **{**self.kwargs, **kwargs_i})


def _is_host_value(x):
    """A NumPy value or a Python number, or a list or tuple of them."""
    if isinstance(x, (list, tuple)):
        return all(_is_host_value(v) for v in x)
    return isinstance(x, (np.ndarray, np.generic, float, int))


class LikelihoodEvaluator:
    """Batched likelihood evaluation, in one of three modes (``mode``, set
    by :meth:`check`):

    * ``"vmap"``: a torch function written for one walker, vectorized with
      ``torch.func.vmap``;
    * ``"vectorize"``: with ``vectorize=True``, a torch function called once
      on the flattened batch;
    * ``"host"``: a NumPy function, called as Eryn calls it (see
      :meth:`_host_eval`) on a host copy of the batch.

    In the torch modes one walker's arguments are its coordinates
    ``(ndim,)`` for a single branch with one leaf and no reversible jump
    (``rj``); ``(coords (nleaves_max, ndim), inds (nleaves_max,))`` for one
    branch otherwise; and the per-branch dicts for several branches.  With
    ``provide_supplemental`` one more argument follows: the walker's branch
    supplemental ``{name: tensor}`` for one branch, ``{branch: {name:
    tensor}}`` for several.  The function returns the log-likelihood, or
    ``(log_like, blobs)``: :meth:`check` finds which on a probe batch and
    sets ``returns_blobs`` and ``blob_shape`` (one walker's blob shape).
    """

    def __init__(self, fn, *, branch_names, ndims, nleaves_max, args, kwargs,
                 vectorize, fill_zero_leaves_val, dtype, rj=False,
                 provide_supplemental=False, provide_groups=False, pool=None):
        self.fn = fn
        self.branch_names = list(branch_names)
        self.ndims = ndims
        self.nleaves_max = nleaves_max
        self.args = tuple(args) if args is not None else ()
        self.kwargs = dict(kwargs) if kwargs is not None else {}
        self.vectorize = vectorize
        self.provide_supplemental = bool(provide_supplemental)
        self.provide_groups = bool(provide_groups)
        self.pool = pool
        self.rj = rj
        self.dtype = dtype
        self.fill_zero_leaves_val = max(
            float(fill_zero_leaves_val), float(torch.finfo(dtype).min / 2)
        )
        # under reversible jump the one leaf can be off: the function
        # takes the mask as well
        self._simple = (
            len(self.branch_names) == 1
            and self.nleaves_max[self.branch_names[0]] == 1
            and not rj
        )
        self.mode = None
        self.returns_blobs = False
        self.blob_shape = self.blob_dtype = None

    @property
    def host(self):
        """Whether an evaluation visits the host."""
        return self.mode == "host"

    def __getstate__(self):
        # a pool holds processes: a pickled evaluator maps without one
        return {**self.__dict__, "pool": None}

    def _supp_args(self, sdict):
        """The supplemental argument under ``provide_supplemental``: the
        bare ``{name: tensor}`` of a single branch, ``{branch: {name:
        tensor}}`` for several (a branch without one gets ``{}``)."""
        if not self.provide_supplemental:
            return ()
        sdict = sdict or {}
        if len(self.branch_names) == 1:
            return (sdict.get(self.branch_names[0]) or {},)
        return ({n: sdict.get(n) or {} for n in self.branch_names},)

    def _call(self, cdict, idict, sdict, batched):
        name = self.branch_names[0]
        supp = self._supp_args(sdict)
        if self._simple:
            x = cdict[name][:, 0] if batched else cdict[name][0]
            return self.fn(x, *supp, *self.args, **self.kwargs)
        if len(self.branch_names) == 1:
            return self.fn(cdict[name], idict[name], *supp, *self.args,
                           **self.kwargs)
        return self.fn(cdict, idict, *supp, *self.args, **self.kwargs)

    def _raw(self, cdict, idict, sdict):
        """What the function returns for a flat batch."""
        if self.vectorize:
            return self._call(cdict, idict, sdict, batched=True)
        return torch.func.vmap(
            lambda c, i, s: self._call(c, i, s, batched=False)
        )(cdict, idict, sdict)

    def _evaluate(self, cdict, idict, sdict=None):
        """``(log_like, blobs or None)`` of a flat batch."""
        out = self._raw(cdict, idict, sdict or {})
        if isinstance(out, (tuple, list)):
            return out[0], out[1]
        return out, None

    def check(self, device, branch_supps=None, coords=None, inds=None):
        """Choose the mode on a probe batch (two walkers at zeros for torch;
        on the host the first three walkers of ``coords`` and ``inds``
        (``{name: (ntemps, nwalkers, ...)}``) where given, else zeros; their
        supplementals the first of ``branch_supps``) and find whether the
        function returns blobs.  A function that cannot be batched in
        torch, or returns anything but torch tensors, is called as a NumPy
        likelihood, and runs on the host (with a warning) when that returns
        NumPy values or Python numbers; else a ``TypeError`` gives both
        failures."""
        c, i = self._probe(device, 2)
        s = self._probe_supps(branch_supps, 2)
        try:
            out = self._raw(c, i, s)
            parts = list(out) if isinstance(out, (tuple, list)) else [out]
            if len(parts) not in (1, 2) or not all(
                    isinstance(p, torch.Tensor) for p in parts):
                kinds = ", ".join(type(p).__name__ for p in parts)
                raise TypeError(
                    f"log_like_fn returned {type(out).__name__} ({kinds}); "
                    "it must return a torch.Tensor of log-likelihoods, or a "
                    "pair (log_like, blobs) of tensors")
        except Exception as err:
            torch_err = err
        else:
            self._check_torch(parts)
            return
        if self.vectorize:
            torch_msg = f"log_like_fn failed on a batch of walkers ({torch_err})"
        else:
            torch_msg = (
                "log_like_fn could not be vectorized over walkers with "
                f"torch.func.vmap ({torch_err}); a torch function written for "
                "a batch of walkers takes vectorize=True")
        try:
            self._check_host(device, branch_supps, coords, inds)
        except Exception as err:
            raise TypeError(
                f"{torch_msg}. Called as a NumPy likelihood on host arrays, "
                f"it failed too ({type(err).__name__}: {err})."
            ) from err
        warnings.warn(
            f"{torch_msg}. It runs as a NumPy likelihood on the host: every "
            "evaluation copies the batch to the host and back, and a step "
            "that evaluates it runs eagerly, never as a CUDA graph "
            "(graph_replays stays 0). Write it in torch to keep the steps "
            "on the device.",
            stacklevel=4,
        )

    def _check_torch(self, parts):
        if tuple(parts[0].shape) != (2,):
            raise TypeError(
                f"log_like_fn returned shape {tuple(parts[0].shape)} for 2 "
                "walkers."
            )
        self.mode = "vectorize" if self.vectorize else "vmap"
        self.returns_blobs = len(parts) == 2
        if self.returns_blobs:
            if parts[1].ndim < 1 or parts[1].shape[0] != 2:
                raise TypeError(
                    f"log_like_fn returned blobs of shape "
                    f"{tuple(parts[1].shape)} for 2 walkers."
                )
            self.blob_shape = tuple(parts[1].shape[1:])
            self.blob_dtype = parts[1].dtype

    def _check_host(self, device, branch_supps, coords=None, inds=None):
        """Call the function the host way on a probe batch of three
        walkers (floating-point warnings off: the probe's values are not
        kept); raises unless every return is a NumPy value or a Python
        number, of the shape the walkers need.  Sets the mode and the
        blobs."""
        if coords is None:
            c, i = self._probe(device, 3)
        else:
            c = {n: x.reshape((-1,) + tuple(x.shape[2:]))[:3]
                 for n, x in coords.items()}
            i = {n: m.reshape((-1,) + tuple(m.shape[2:]))[:3]
                 for n, m in inds.items()}
        n = next(iter(c.values())).shape[0]
        s = self._probe_supps(branch_supps, n)
        returned = []

        def spy(*args, **kwargs):
            out = self.fn(*args, **kwargs)
            returned.append(out)
            return out

        probe = LikelihoodEvaluator(
            spy, branch_names=self.branch_names, ndims=self.ndims,
            nleaves_max=self.nleaves_max, args=self.args, kwargs=self.kwargs,
            vectorize=self.vectorize, fill_zero_leaves_val=-1e300,
            dtype=self.dtype, rj=self.rj,
            provide_supplemental=self.provide_supplemental,
            provide_groups=self.provide_groups)
        probe.mode = "host"
        probe._discover = True
        with np.errstate(all="ignore"):
            probe._host_call(c, i, torch.zeros((n,), dtype=self.dtype,
                                               device=device), s)
        bad = [type(r).__name__ for r in returned if not _is_host_value(r)]
        if bad:
            raise TypeError(
                f"it returned {bad[0]}, not NumPy values or Python floats")
        self.mode = "host"
        self.returns_blobs = probe.returns_blobs
        if self.returns_blobs:
            self.blob_shape = probe.blob_shape
            self.blob_dtype = self.dtype

    def check_grad(self, device, branch_supps=None):
        """Differentiate the sum over a probe batch of two walkers with
        ``torch.func.grad``, as the gradient moves do; raise a
        ``TypeError`` that names the fix when that fails, and warn when the
        value does not depend on the coordinates through differentiable
        torch operations (its gradient would be zero)."""
        c, i = self._probe(device, 2)
        s = self._probe_supps(branch_supps, 2)
        try:
            if self.host:
                raise TypeError("it is a NumPy likelihood, run on the host")
            torch.func.grad(lambda c: self._evaluate(c, i, s)[0].sum())(c)
        except Exception as err:
            raise TypeError(
                "log_like_fn could not be differentiated with torch.func.grad "
                f"({err}). The gradient moves (MALAMove, HMCMove, "
                "ChEESHMCMove) need a likelihood written in differentiable "
                "torch operations: no .item(), numpy or host copies, no "
                "in-place writes to its inputs; or choose a move without "
                "gradients."
            ) from err
        with torch.enable_grad():
            c = {n: x.clone().requires_grad_(True) for n, x in c.items()}
            out = self._evaluate(c, i, s)[0]
        if not out.requires_grad:
            warnings.warn(
                "log_like_fn does not depend on the coordinates through "
                "differentiable torch operations (detached, or computed "
                "outside torch): the gradient moves see a zero gradient.",
                stacklevel=4,
            )

    def _probe(self, device, n):
        c = {
            name: torch.zeros((n, self.nleaves_max[name], self.ndims[name]),
                              dtype=self.dtype, device=device)
            for name in self.branch_names
        }
        i = {
            name: torch.ones((n, self.nleaves_max[name]), dtype=torch.bool,
                             device=device)
            for name in self.branch_names
        }
        return c, i

    @staticmethod
    def _probe_supps(branch_supps, n):
        """The first ``n`` walkers of each entry of ``branch_supps``
        (``{branch: {name: (ntemps, nwalkers, ...)}}``), flat."""
        if not branch_supps:
            return {}
        return {name: {k: v.reshape((-1,) + tuple(v.shape[2:]))[:n]
                       for k, v in h.items()}
                for name, h in branch_supps.items()}

    def __call__(self, coords: dict, inds: dict, logp, branch_supps=None):
        """coords ``{name: (ntemps, n, nleaves_max, ndim)}``, logp ``(ntemps,
        n)``, ``branch_supps`` ``{name: {key: (ntemps, n, ...)}}`` or None;
        returns ``(log_like (ntemps, n), blobs (ntemps, n, ...) or None)``.
        Walkers outside the prior's support get ``-inf``: in the torch
        modes they are evaluated at zeros (their blobs are what the
        function returned there), on the host they are not evaluated (their
        blobs are NaN)."""
        batch_shape = logp.shape
        N = logp.numel()
        cf = {n: c.reshape((N,) + c.shape[2:]) for n, c in coords.items()}
        inf = {n: m.reshape((N,) + m.shape[2:]) for n, m in inds.items()}
        sf = None
        if self.provide_supplemental and branch_supps:
            sf = {n: {k: v.reshape((N,) + v.shape[2:]) for k, v in h.items()}
                  for n, h in branch_supps.items() if h is not None}
        if self.host:
            ll, blobs = self._host_call(cf, inf, logp.reshape(N), sf)
            if blobs is not None:
                blobs = blobs.reshape(batch_shape + blobs.shape[1:])
            return ll.reshape(batch_shape), blobs
        finite = torch.isfinite(logp.reshape(N))
        # out-of-support walkers are evaluated at zeros and rejected below
        cf_safe = {n: torch.where(finite[:, None, None], c, 0.0)
                   for n, c in cf.items()}
        ll, blobs = self._evaluate(cf_safe, inf, sf)
        ll = torch.where(finite, ll.to(self.dtype), -torch.inf)
        nleaves = sum(m.sum(dim=-1) for m in inf.values())
        ll = torch.where((nleaves == 0) & finite, self.fill_zero_leaves_val, ll)
        if blobs is not None:
            blobs = blobs.reshape(batch_shape + blobs.shape[1:])
        return ll.reshape(batch_shape), blobs

    # ------------------------------------------------------------------
    # the host mode
    # ------------------------------------------------------------------
    _discover = False  # True on the probe: the blobs' width is being found

    def _host_call(self, cf, inf, logp, sf):
        """Evaluate a flat batch on the host: one copy of the coordinates,
        masks and log-priors to the host, :meth:`_host_eval`, and one copy
        of the log-likelihoods (and blobs) back."""
        device = logp.device
        names = self.branch_names
        parts = ([cf[n].reshape(-1) for n in names]
                 + [inf[n].reshape(-1).to(self.dtype) for n in names]
                 + [logp.reshape(-1).to(self.dtype)])
        flat = torch.cat(parts).cpu().numpy()
        cf_h, inf_h, off = {}, {}, 0
        for n in names:
            size = cf[n].numel()
            cf_h[n] = flat[off:off + size].reshape(tuple(cf[n].shape))
            off += size
        for n in names:
            size = inf[n].numel()
            inf_h[n] = flat[off:off + size].reshape(tuple(inf[n].shape)) != 0
            off += size
        lp_h = flat[off:]
        sf_h = None if sf is None else {
            n: {k: v.detach().cpu().numpy() for k, v in h.items()}
            for n, h in sf.items()}
        ll, blobs = self._host_eval(cf_h, inf_h, lp_h, sf_h)
        N = ll.shape[0]
        if blobs is None and self.returns_blobs:
            blobs = np.full((N,) + tuple(self.blob_shape), np.nan)
        if blobs is None:
            return torch.from_numpy(ll).to(device=device, dtype=self.dtype), None
        both = torch.from_numpy(
            np.concatenate([ll[:, None], blobs.reshape(N, -1)], axis=1)
        ).to(device=device, dtype=self.dtype)
        return both[:, 0], both[:, 1:].reshape((N,) + blobs.shape[1:])

    def _blob_buffer(self, N, nblobs):
        """The host blobs of ``N`` walkers, NaN: ``nblobs`` per walker as
        the function returned them, checked against (or, on the probe,
        setting) ``blob_shape``; None for a return without blobs."""
        if nblobs is None:
            return None
        shape = (int(nblobs),)
        if self._discover and not self.returns_blobs:
            self.returns_blobs, self.blob_shape = True, shape
        if not self.returns_blobs or tuple(self.blob_shape) != shape:
            raise ValueError(
                f"log_like_fn returned {nblobs} blob value(s) per walker, "
                f"but {self.blob_shape[0] if self.returns_blobs else 0} at "
                "set-up.")
        return np.full((N,) + shape, np.nan)

    def _host_eval_vectorized(self, coords_flat, inds_flat, logp_flat,
                              supps_flat=None):
        """Eryn's ``vectorize=True`` call: the active leaves of every
        walker that reaches the function, flattened per branch, with the
        walker of each leaf (``groups``) under ``provide_groups`` and the
        active leaves' branch supplementals as the keyword
        ``branch_supps``; one call for the batch.  A ``(n, 1)`` return is
        the log-likelihood, ``(n, 1 + k)`` carries ``k`` blobs."""
        names = self.branch_names
        N = logp_flat.shape[0]
        out = np.full(N, -np.inf, dtype=np.float64)
        finite = np.isfinite(logp_flat)
        # walkers without leaves never reach the function
        nleaves_tot = sum(inds_flat[n].sum(axis=-1) for n in names)
        out[(nleaves_tot == 0) & finite] = self.fill_zero_leaves_val
        keep = np.where(finite & (nleaves_tot > 0))[0]
        if keep.size == 0:
            return out, None
        x_in, groups_in, supps_in = [], [], []
        for n in names:
            m = inds_flat[n][keep]
            walker_ids = np.broadcast_to(np.arange(keep.size)[:, None],
                                         m.shape)
            x_in.append(coords_flat[n][keep][m])
            groups_in.append(walker_ids[m])
            if self.provide_supplemental and supps_flat and n in supps_flat:
                supps_in.append({
                    k: v[keep][m] if v.shape[1:2] == m.shape[1:2] else v[keep]
                    for k, v in supps_flat[n].items()})
            else:
                supps_in.append(None)
        if len(names) == 1:
            args = (x_in[0], groups_in[0]) if self.provide_groups \
                else (x_in[0],)
        else:
            args = (x_in, groups_in) if self.provide_groups else (x_in,)
        kwargs_in = {}
        if self.provide_supplemental and supps_flat:
            kwargs_in["branch_supps"] = (supps_in[0] if len(names) == 1
                                         else supps_in)
        res = np.asarray(self.fn(*args, *self.args,
                                 **{**self.kwargs, **kwargs_in}))
        if res.ndim == 2 and res.shape[1] == 1:
            # a keepdims return is the log-likelihood, not blobs
            res = res[:, 0]
        if res.shape[:1] != (keep.size,) or res.ndim > 2:
            raise TypeError(
                f"log_like_fn returned shape {res.shape} for {keep.size} "
                "walkers; a vectorized likelihood returns (n,) values, or "
                "(n, 1 + k) with k blobs.")
        if res.ndim == 2:
            out_blobs = self._blob_buffer(N, res.shape[1] - 1)
            out[keep] = res[:, 0]
            out_blobs[keep] = res[:, 1:]
            return out, out_blobs
        out[keep] = res
        return out, None

    def _host_eval(self, coords_flat, inds_flat, logp_flat, supps_flat=None):
        """Eryn's call of a host likelihood on flat host arrays: per walker
        that reaches the function (inside the prior, with a leaf), its
        active leaves ``(n, ndim)`` per branch (a list over branches, None
        for a branch without one; the bare ``(ndim,)`` row for one branch of
        one leaf without reversible jump), its active leaves' branch
        supplementals as the keyword ``branch_supps``, all fanned out
        through ``pool.map`` when there is a pool.  A return ``[log_like,
        *blobs]`` carries blobs.  ``vectorize=True`` goes to
        :meth:`_host_eval_vectorized`.  Returns ``(log_like, blobs or
        None)``, float64 host arrays."""
        if self.vectorize:
            return self._host_eval_vectorized(coords_flat, inds_flat,
                                              logp_flat, supps_flat)
        names = self.branch_names
        N = logp_flat.shape[0]
        out = np.full(N, -np.inf, dtype=np.float64)
        items, keep = [], []
        for i in range(N):
            if not np.isfinite(logp_flat[i]):
                continue
            per_branch, total = [], 0
            for n in names:
                active = coords_flat[n][i][inds_flat[n][i]]
                total += active.shape[0]
                per_branch.append(active if active.shape[0] > 0 else None)
            if total == 0:
                out[i] = self.fill_zero_leaves_val
                continue
            kwargs_i = {}
            if self.provide_supplemental and supps_flat:
                kwargs_i["branch_supps"] = {
                    n: ({k: (v[i][inds_flat[n][i]]
                             if v[i].shape[:1] == inds_flat[n][i].shape[:1]
                             else v[i])
                         for k, v in supps_flat[n].items()}
                        if n in supps_flat else None)
                    for n in names}
            if len(names) > 1:
                arg = per_branch
            else:
                arg = per_branch[0]
                if self.nleaves_max[names[0]] == 1 and not self.rj:
                    arg = arg[0]
            items.append((arg, kwargs_i))
            keep.append(i)
        out_blobs = None
        if items:
            worker = _CallbackWorker(self.fn, self.args, self.kwargs)
            map_fn = self.pool.map if self.pool is not None else map
            for i, res in zip(keep, map_fn(worker, items)):
                res = np.asarray(res, dtype=np.float64).reshape(-1)
                if res.size > 1:
                    if out_blobs is None:
                        out_blobs = self._blob_buffer(N, res.size - 1)
                    out_blobs[i] = res[1:]
                elif out_blobs is not None or self.returns_blobs:
                    raise ValueError(
                        "log_like_fn returned blobs for some walkers and "
                        "not for others.")
                out[i] = res[0]
        return out, out_blobs


class EnsembleSampler:
    """Ensemble sampler with parallel tempering on torch tensors.

    Args mirror :class:`eryn_tpu.EnsembleSampler` for the ported subset;
    ``device`` is where the ensemble lives (default: the card; without CUDA
    the default raises, and CPU runs pass ``device="cpu"``; an initial state
    elsewhere is moved here), ``dtype`` the state
    dtype (default float32), and ``seed`` seeds the sampler's
    ``torch.Generator``.  ``periodic`` is a
    :class:`~eryn_tpu_torch.utils.PeriodicContainer` or the ``{branch:
    {parameter index or prior key: period}}`` dict of one; every move that
    has none of its own receives it.  The default backend is a
    :class:`DeviceBackend` on a CUDA device and a :class:`Backend` on the
    CPU; a string names an HDF5 file (:class:`HDFBackend`).  A backend that
    already holds a chain is continued: the sampler checks that its moves,
    prior key order and shape match, and restores the last state, both
    generators, the adaptation clock and the moves' kernel states from it.

    ``update_fn(iteration, last_sample, sampler)`` runs every
    ``update_iterations`` sampler steps, and ``stopping_fn(iteration,
    last_sample, sampler)`` every ``stopping_iterations`` stored
    iterations, ending the run when it returns True (``utils.updates``,
    ``utils.stopping``).  ``plot_generator.generate_plot_info(burn=0,
    thin=1)`` runs every ``plot_iterations`` stored iterations; with
    ``plot_iterations > 0`` and no generator, a
    :class:`~eryn_tpu_torch.utils.PlotContainer` on the sampler's backend
    writes ``output_*.png`` into ``plot_folder`` (default ``"."``): the
    base plots, and the tempering and RJ ones where there are temperatures.

    A NumPy ``log_like_fn`` runs on the host (``likelihood_mode ==
    "host"``, :class:`LikelihoodEvaluator`): per walker, fanned out through
    ``pool.map`` when ``pool`` is given (the function must then pickle), or
    with ``vectorize=True`` once per batch on the active leaves, with the
    walker of each leaf as a second argument under ``provide_groups``.
    A move written for Eryn's host protocol (``host_move``,
    :mod:`~eryn_tpu_torch.moves.legacy`) runs eagerly in its slots of the
    schedule with ``random``, the sampler's ``numpy.random.RandomState``
    (seeded from ``seed``); the native moves keep their graphs.

    ``provide_supplemental=True`` passes each walker's branch supplemental
    to the likelihood as one more argument (see
    :class:`LikelihoodEvaluator`; a host likelihood takes it as the keyword
    ``branch_supps``).  A likelihood that returns ``(log_like,
    blobs)`` has its blobs stored with the chain (``get_blobs``), in
    ``blobs_dtype`` (a NumPy dtype; default the blobs' own).  Blobs, the
    state supplemental and the branch supplementals of the initial state
    ride every step and the swaps; their object-dtype entries follow their
    walkers on the host, reordered at the end of each segment.

    ``cuda_graph`` (default True): on a CUDA device, each move's step is
    captured as a CUDA graph the second time it is due and replayed from
    then on (``graph_replays`` counts the replays).  Everything a step runs,
    the likelihood included, must then stay on the device; a capture that
    fails raises a ``RuntimeError``.  A host likelihood or prior makes every
    step visit the host: the segments run the eager loop, and nothing is
    captured.  ``cuda_graph=False`` runs the eager
    loop, which launches every op of every step from Python, as the CPU
    always does.
    """

    def __init__(
        self,
        nwalkers,
        ndims,
        log_like_fn,
        priors,
        tempering_kwargs={},
        branch_names=None,
        nbranches=1,
        nleaves_max=1,
        nleaves_min=0,
        moves=None,
        rj_moves=None,
        periodic=None,
        args=None,
        kwargs=None,
        backend=None,
        vectorize=False,
        provide_groups=False,
        pool=None,
        provide_supplemental=False,
        blobs_dtype=None,
        fill_zero_leaves_val=-1e300,
        num_repeats_in_model=1,
        num_repeats_rj=1,
        track_moves=True,
        info={},
        seed=None,
        dtype=None,
        device=None,
        cuda_graph=True,
        update_fn=None,
        update_iterations=-1,
        stopping_fn=None,
        stopping_iterations=-1,
        plot_iterations=-1,
        plot_generator=None,
        plot_folder=None,
        dr_moves=None,
        dr_max_iter=5,
    ):
        self.dtype = dtype if dtype is not None else torch.float32
        if self.dtype not in _NUMPY_DTYPE:
            raise TypeError("dtype must be torch.float32 or torch.float64.")
        self.device = resolve_device(device)
        self.num_repeats_in_model = int(num_repeats_in_model)
        self.num_repeats_rj = int(num_repeats_rj)
        self.track_moves = track_moves
        self.info = info
        self.provide_supplemental = bool(provide_supplemental)
        self.blobs_dtype = None if blobs_dtype is None else np.dtype(blobs_dtype)
        # Eryn's cap on delayed-rejection stages inside reversible jump:
        # accepted, so that code written for eryn_tpu runs, and ignored, since
        # no move runs delayed rejection (dr_moves is refused below)
        self.dr_max_iter = int(dr_max_iter)
        #: ``(nsteps, seconds)`` of every segment run (utils.profiling)
        self.timing = SegmentTimer()

        if branch_names is None:
            branch_names = [f"model_{i}" for i in range(nbranches)]
        elif isinstance(branch_names, str):
            branch_names = [branch_names]
        self.branch_names = list(branch_names)
        self.nbranches = len(self.branch_names)
        self.ndims = self._per_branch(ndims, "ndims")
        self.nleaves_max = self._per_branch(nleaves_max, "nleaves_max")
        self.nleaves_min = self._per_branch(nleaves_min, "nleaves_min")
        self.nwalkers = int(nwalkers)

        if tempering_kwargs == {}:
            self.ntemps = 1
            self.temperature_control = None
        else:
            total_ndim = sum(
                self.nleaves_max[n] * self.ndims[n] for n in self.branch_names
            )
            self.temperature_control = TemperatureControl(
                total_ndim, nwalkers, **tempering_kwargs
            )
            self.ntemps = self.temperature_control.ntemps

        self.priors = self._normalize_priors(priors)
        # after the priors: string parameter keys resolve through their
        # key_order
        self.periodic = PeriodicContainer.coerce(
            periodic, ndims=self.ndims,
            key_orders={n: p.key_order for n, p in self.priors.items()},
        )

        if moves is None:
            self.moves, self.weights = [StretchMove()], [1.0]
        else:
            self.moves, self.weights = self._parse_moves(moves)
        self.rj_moves, self.rj_weights = self._parse_rj_moves(rj_moves)
        self.has_reversible_jump = len(self.rj_moves) > 0
        if self.has_reversible_jump:
            self._check_fixed_dimension()
        if self.has_reversible_jump and any(
            type(m) is StretchMove for m in self.moves
        ):
            warnings.warn(
                "Using the plain StretchMove for in-model proposals under "
                "reversible jump is not advised: the stretch ray targets the "
                "complement walker's same leaf slot, which may be inactive. "
                "Use RedBlueGroupStretchMove instead, which stretches each "
                "active leaf toward an active complement leaf.",
                stacklevel=2,
            )
        if dr_moves:
            raise NotImplementedError(
                "dr_moves (delayed rejection nested inside reversible jump) "
                "is not implemented: retrying only rejected births biases "
                "the leaf-count posterior, and eryn_tpu raises here too. Use "
                "MTDistGenMoveRJ (multiple-try reversible jump) for unbiased "
                "birth retries, or the standalone DelayedRejection move for "
                "in-model proposals."
            )
        # in-model moves first, then the RJ moves: one index space for the
        # kernel states and accept counters
        self._all_move_list = self.moves + self.rj_moves
        # leaf masks change only where an RJ move runs; otherwise they are
        # stored once per segment instead of per step
        self._inds_change = any(m.is_rj for m in self._all_move_list)
        for move in self._all_move_list:
            move.temperature_control = self.temperature_control
            if move.periodic is None:
                move.periodic = self.periodic
            # a move whose candidate set defaults to the sampler's branches
            # (ModelSwapRJMove), and composites handing the wiring on
            if hasattr(move, "wire_sampler_priors"):
                move.wire_sampler_priors(self.priors)
            if hasattr(move, "propagate_wiring"):
                move.propagate_wiring()
        self.all_moves = {}
        counts = {}
        for move in self._all_move_list:
            base = type(move).__name__
            self.all_moves[f"{base}_{counts.get(base, 0)}"] = move
            counts[base] = counts.get(base, 0) + 1
        self._host_moves = [bool(m.host_move) for m in self._all_move_list]
        nested = [type(m).__name__ for m in _walk_moves(self._all_move_list)
                  if m.host_move and m not in self._all_move_list]
        if nested:
            # a composite runs its children's kernels: the hooks would be
            # skipped without a word
            raise ValueError(
                f"{nested} implement the reference's host extension protocol "
                "inside a composite move (CombineMove), which runs its "
                "children's kernels; pass a host move to the sampler as a "
                "move of its own.")
        if any(self._host_moves):
            if all(self._host_moves):
                how = ("the sampler will run step-by-step on the host: no "
                       "step is captured as a CUDA graph")
            else:
                how = ("the sampler runs HYBRID: the native moves keep their "
                       "CUDA graphs, and each slot of the schedule that "
                       "draws a host move runs it eagerly")
            warnings.warn(
                "One or more moves implement the reference's host extension "
                f"protocol (get_proposal, the friends or special_* hooks, or "
                f"propose); {how}. Port the hook to its *_kernel form to "
                "keep every step on the device.",
                stacklevel=2,
            )

        self.log_like_fn = log_like_fn
        self._prior_eval = PriorEvaluator(self.priors, self.dtype)
        self._like_eval = LikelihoodEvaluator(
            log_like_fn,
            branch_names=self.branch_names,
            ndims=self.ndims,
            nleaves_max=self.nleaves_max,
            args=args,
            kwargs=kwargs,
            vectorize=vectorize,
            fill_zero_leaves_val=fill_zero_leaves_val,
            dtype=self.dtype,
            rj=self.has_reversible_jump,
            provide_supplemental=self.provide_supplemental,
            provide_groups=provide_groups,
            pool=pool,
        )
        self.pool = pool
        self._like_checked = False
        # host (object-dtype) supplemental entries by owner ("__state__" or
        # a branch), reordered by the swaps at each segment end
        self._host_supps = {}
        self._blob_layout = None  # (shape, torch dtype) of a state's blobs

        self._seed = (
            int(seed) if seed is not None
            else int.from_bytes(os.urandom(4), "little")
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self._seed)
        # move-schedule draws stay on the host: picking a move by a device
        # draw would make every step wait for the device
        self._host_gen = torch.Generator()
        self._host_gen.manual_seed(self._seed)
        # the host hooks' generator: NumPy's API, seeded as np.random.seed
        # seeds the global one
        self._np_random = np.random.RandomState(self._seed)
        if self.temperature_control is not None:
            self.temperature_control.generator = self._gen

        self.cuda_graph = bool(cuda_graph)
        self._graphs = None
        self.graph_replays = 0
        self.graph_captures = 0

        self.update_fn = update_fn
        self.update_iterations = update_iterations
        self.stopping_fn = stopping_fn
        self.stopping_iterations = stopping_iterations
        self.plot_iterations = plot_iterations
        self.plot_generator = plot_generator

        self._previous_state = None
        # the rank's MeshLayout while the state is sharded over a device
        # mesh (parallel.mesh), else None
        self._mesh_layout = None
        # a MeshLayout of a one-rank mesh on which to run the sharded step,
        # collectives and all (shard_state runs the one-rank step there, as
        # eryn_tpu does): how chip_smoke.py captures the sharded route over
        # NCCL on one card
        self._one_rank_layout = None
        self._kernel_states = None
        # under a mesh, the host's shadow of the moves' phase clocks
        self._phases = HostPhases()
        self._m_acc = None
        self._m_nprop = np.zeros(len(self._all_move_list))
        self._static_inds = self._static_inds_host = None

        if backend is None:
            np_dtype = _NUMPY_DTYPE[self.dtype]
            backend = (
                DeviceBackend(dtype=np_dtype, max_device_bytes=4 << 30)
                if self.device.type == "cuda" else Backend(dtype=np_dtype)
            )
        elif isinstance(backend, str):
            backend = HDFBackend(backend)
        self._backend = backend
        if not backend.initialized:
            # in a program of several ranks a file is laid out at the first
            # run, when the state's placement says which rank writes it
            if not (isinstance(backend, HDFBackend) and _several_ranks()):
                self._reset_backend(backend)
        else:
            self._check_backend(backend)
            if backend.iteration > 0:
                self._resume(backend)

        if self.plot_iterations > 0 and self.plot_generator is None:
            # under a mesh it runs on every rank, and the writer rank's
            # writes the files (_use_mesh)
            self._own_plots = True
            self.plot_generator = PlotContainer(
                fp="output", backend=self.backend,
                plot_dir=plot_folder or ".",
                which_plots=(("base", "tempering", "rj") if self.ntemps > 1
                             else ("base",)),
            )

    # ------------------------------------------------------------------
    def _per_branch(self, value, label):
        if isinstance(value, (int, np.integer)):
            return {bn: int(value) for bn in self.branch_names}
        if isinstance(value, (list, tuple, np.ndarray)):
            if len(value) != len(self.branch_names):
                raise ValueError(
                    f"{label} list has {len(value)} entries for "
                    f"{len(self.branch_names)} branches."
                )
            return {bn: int(v) for bn, v in zip(self.branch_names, value)}
        if isinstance(value, dict):
            unknown = set(value) - set(self.branch_names)
            if unknown:
                raise ValueError(
                    f"{sorted(unknown)} in {label} but not in branch_names."
                )
            return {k: int(v) for k, v in value.items()}
        raise ValueError(f"{label} must be a scalar int, list or dict.")

    @staticmethod
    def _parse_moves(moves):
        """``(moves, normalized weights)`` from a move, a list of moves, or
        a list of ``(move, weight)`` pairs."""
        entries = moves if isinstance(moves, (list, tuple)) else [moves]
        pairs = [e if isinstance(e, tuple) else (e, 1.0) for e in entries]
        total = sum(float(w) for _, w in pairs)
        return [m for m, _ in pairs], [float(w) / total for _, w in pairs]

    def _parse_rj_moves(self, rj_moves):
        """RJ moves from ``rj_moves``: None or False (none), True or
        ``"together"`` (one birth/death move over every branch from the
        priors), ``"iterate_branches"`` or ``"separate_branches"`` (one
        such move per branch, equally weighted), or moves as for
        ``moves``."""
        if rj_moves is None or rj_moves is False:
            return [], []
        if rj_moves is True or rj_moves == "together":
            return [DistributionGenerateRJ(
                self.priors, nleaves_max=self.nleaves_max,
                nleaves_min=self.nleaves_min,
            )], [1.0]
        if rj_moves in ("iterate_branches", "separate_branches"):
            out = [
                DistributionGenerateRJ(
                    {name: self.priors[name]},
                    nleaves_max={name: self.nleaves_max[name]},
                    nleaves_min={name: self.nleaves_min[name]},
                    proposal_branch_names=[name],
                )
                for name in self.branch_names
            ]
            return out, [1.0 / len(out)] * len(out)
        if isinstance(rj_moves, str):
            raise ValueError(f"Unknown rj_moves mode: {rj_moves}")
        return self._parse_moves(rj_moves)

    def _check_fixed_dimension(self):
        """Refuse a move that sets ``requires_fixed_dimension`` on a branch
        whose leaf count reversible jump varies (a ``CombineMove``'s
        children included): the leaf masks would change the meaning of its
        flattened parameter vector."""
        variable = {n for n in self.branch_names
                    if self.nleaves_min.get(n, self.nleaves_max[n])
                    != self.nleaves_max[n]}

        for m in _walk_moves(self.moves + self.rj_moves):
            if not getattr(m, "requires_fixed_dimension", False):
                continue
            run = m.proposal_branch_names
            if run is None:
                run = list(self.branch_names)
            elif isinstance(run, str):
                run = [run]
            clash = sorted(variable.intersection(run))
            if clash:
                raise ValueError(
                    f"{type(m).__name__} requires fixed-dimension models and "
                    "cannot propose on reversible-jump branches "
                    f"{clash} (leaf masks change the meaning of the "
                    "flattened parameter vector). Restrict the move with "
                    "proposal_branch_names."
                )

    def _needs_gradient(self):
        """Whether a move (a ``CombineMove``'s children included)
        differentiates the likelihood."""
        return any(getattr(m, "needs_gradient", False)
                   for m in _walk_moves(self._all_move_list))

    def _normalize_priors(self, priors):
        if isinstance(priors, ProbDistContainer):
            return {self.branch_names[0]: priors}
        if isinstance(priors, dict):
            out = {
                name: val if isinstance(val, ProbDistContainer)
                else ProbDistContainer(val)
                for name, val in priors.items()
            }
            if set(out) - set(self.branch_names):
                raise ValueError(
                    f"priors keys {list(out)} do not match branch_names "
                    f"{self.branch_names}."
                )
            return out
        raise ValueError("priors must be a ProbDistContainer or dict.")

    @property
    def backend(self):
        return self._backend

    @backend.setter
    def backend(self, value):
        self._backend = value
        if not value.initialized:
            self._reset_backend(value)

    @property
    def key_order(self):
        return {n: p.key_order for n, p in self.priors.items()}

    def _reset_backend(self, backend):
        kwargs = dict(
            nleaves_max=self.nleaves_max,
            ntemps=self.ntemps,
            branch_names=self.branch_names,
            rj=self.has_reversible_jump,
            moves=list(self.all_moves) if self.track_moves else None,
            info=self.info,
            key_order=self.key_order,
        )
        if self._mesh_layout is None:
            backend.reset(self.nwalkers, self.ndims, **kwargs)
        else:
            backend.reset_sharded(self._mesh_layout, self.nwalkers,
                                  self.ndims, **kwargs)

    @property
    def _local_dims(self):
        """``(ntemps, nwalkers)`` of the state this process holds: this
        rank's shard under a device mesh, else the ensemble's."""
        lay = self._mesh_layout
        return (self.ntemps, self.nwalkers) if lay is None else (lay.nt, lay.nw)

    def _use_mesh(self, state):
        """Find the device mesh of ``state`` (``eryn_tpu``'s
        ``_detect_sharding``) and hand its layout to the moves, the
        temperature control and the backend.  A backend that already holds
        a chain continues it on the new placement (sharded, or whole in
        every process): its stored rows, the move counters and the kernel
        states are gathered from the old placement and cut to the new one
        (:meth:`~eryn_tpu_torch.backends.Backend.reshard`)."""
        from .parallel.mesh import mesh_of_state, same_placement

        mesh = mesh_of_state(state)
        layout = None if mesh is None else state.sharding.layout
        if layout is None:
            layout = self._one_rank_layout
        backend = self.backend
        if layout is self._mesh_layout and backend.initialized:
            return
        if layout is not None and (layout.ntemps, layout.nwalkers) != (
                self.ntemps, self.nwalkers):
            raise ValueError(
                f"The state is sharded from a {layout.ntemps} x "
                f"{layout.nwalkers} ensemble; the sampler's is "
                f"{self.ntemps} x {self.nwalkers}.")
        old = self._mesh_layout
        self._mesh_layout = layout
        for move in self._all_move_list:
            move.wire_mesh(layout)
        if self.temperature_control is not None:
            self.temperature_control.mesh_layout = layout
        self._graphs = None
        if self._own_plots:
            self.plot_generator.save_files = layout is None or layout.writer
        if not backend.initialized or backend.iteration == 0:
            self._m_acc = None
            self._reset_backend(backend)
            return
        backend.reshard(layout)
        if not same_placement(old, layout):
            from .parallel.mesh import convert_rows

            if self._m_acc is not None:
                self._m_acc = convert_rows(self._m_acc, 1, 2, old, layout)
            if self._kernel_states is not None:
                # converted at the set-up, against fresh ones on the new
                # placement
                self._kernel_states_from = old

    #: whether the sampler made the plot generator (a PlotContainer)
    _own_plots = False

    #: the placement the kernel states were made on, where it differs from
    #: the state's (None: they are the state's)
    _kernel_states_from = False

    def _check_backend(self, backend):
        """A backend that holds a chain must match the moves (when they are
        tracked), the priors' key order and the shape."""
        if self.track_moves and backend.move_keys is not None:
            ours, theirs = list(self.all_moves), list(backend.move_keys)
            if len(ours) != len(theirs) or any(k not in theirs for k in ours):
                raise ValueError(
                    "Configuration of moves has changed. Cannot use the same "
                    "backend. Declare a new backend and start from the "
                    "previous state. If you would prefer not to track move "
                    "acceptance fraction, set track_moves to False in the "
                    "EnsembleSampler."
                )
        theirs = backend.key_order
        if theirs:
            ours = {n: v for n, v in self.key_order.items() if n in theirs}
            if _normalize_key_order(ours) != _normalize_key_order(theirs):
                raise ValueError(
                    "Input key order from priors does not match backend."
                )
        if backend.shape != self.shape:
            raise ValueError(
                f"Backend shape {backend.shape} incompatible with sampler "
                f"shape {self.shape}."
            )

    def _resume(self, backend):
        """Continue the backend's chain: its last state (log-likelihoods,
        log-priors and ladder as stored, not recomputed), the generators'
        states and the adaptation clock.  The kernel states follow at the
        first run (:meth:`_init_kernel_states`); the moves' accept counters
        restart."""
        self._previous_state = backend.get_last_sample()
        blobs = self._previous_state.blobs
        if (blobs is not None and self.blobs_dtype is not None
                and np.dtype(blobs.numpy().dtype) != self.blobs_dtype):
            raise ValueError(
                f"blobs_dtype {self.blobs_dtype} does not match the backend's "
                f"stored blobs ({blobs.numpy().dtype})."
            )
        if self.provide_supplemental:
            warnings.warn(
                "provide_supplemental=True on a resumed backend: a backend "
                "stores no supplementals, so run_mcmc(None, ...) continues "
                "without them; pass a state that carries them instead.",
                stacklevel=3,
            )
        for gen, stored in ((self._gen, backend.random_state),
                            (self._host_gen, backend.host_random_state)):
            if stored is None:  # e.g. a file eryn_tpu wrote: seed= holds
                continue
            stored = torch.as_tensor(np.asarray(stored, dtype=np.uint8))
            if stored.numel() != gen.get_state().numel():
                warnings.warn(
                    f"The stored state of the {gen.device.type} generator "
                    "is of another kind (written by a run on another "
                    "device); this run draws from seed= instead.",
                    stacklevel=3,
                )
                continue
            gen.set_state(stored)
        stored = backend.numpy_random_state
        if stored is not None:
            _restore_numpy_state(self._np_random, stored)
        clock = backend.get_sampler_clock()
        if clock is not None and self.temperature_control is not None:
            self.temperature_control.time = torch.full(
                (), clock, dtype=torch.int64, device=self.device
            )

    def reset(self, **info):
        """Clear the stored chain.  ``info`` (Eryn's keyword arguments) is
        accepted as ``eryn_tpu`` accepts it, and not used: the backend is
        laid out again with the sampler's own ``info``."""
        self._reset_backend(self.backend)

    @property
    def shape(self):
        return {
            n: (self.ntemps, self.nwalkers, self.nleaves_max[n], self.ndims[n])
            for n in self.branch_names
        }

    @property
    def iteration(self):
        return self.backend.iteration

    @property
    def random_state(self):
        """State of the sampler's ``torch.Generator``."""
        return self._gen.get_state()

    def __getstate__(self):
        """Pickle without the pool and the captured graphs (they hold
        processes and device memory that cannot cross a process; the graphs
        are captured anew at the next segment); the generators travel as
        their states, with the clock, the kernel states and the backend,
        so an unpickled sampler continues the chain digit for digit."""
        d = self.__dict__.copy()
        d["pool"] = None
        d["_graphs"] = None
        d["timing"] = None
        for key in ("_gen", "_host_gen"):
            gen = d[key]
            d[key] = (str(gen.device), gen.get_state())
        return d

    def __setstate__(self, d):
        for key in ("_gen", "_host_gen"):
            device, rng = d[key]
            gen = torch.Generator(device=device)
            gen.set_state(rng)
            d[key] = gen
        d["timing"] = SegmentTimer()
        self.__dict__.update(d)
        if self.temperature_control is not None:
            self.temperature_control.generator = self._gen

    def drop_step_graphs(self):
        """Release the captured step graphs; the next step of each move
        runs eagerly once and is captured anew.  Call it after changing a
        move's configuration (a graph keeps the values it was captured
        with), as ``AdjustStretchProposalScale`` does."""
        if self._graphs is None:
            return
        # the queued replays finish before their graphs and memory pool go
        torch.cuda.synchronize(self.device)
        self._graphs.graphs.clear()
        self._graphs = None

    @property
    def _max_segment(self):
        """Stored steps per segment: 2048 for a host backend; for a device
        backend, enough to fill a ~256 MB snapshot buffer (a power of two in
        [1024, 8192])."""
        if not self.backend.device_resident:
            return 2048
        itemsize = np.dtype(_NUMPY_DTYPE[self.dtype]).itemsize
        per_step = sum(
            int(np.prod(s)) for _, _, s in self._snap_layout()
        ) * itemsize + sum(int(np.prod(s)) for _, _, s in self._u8_layout())
        if self._blob_layout is not None:
            shape, dtype = self._blob_layout
            per_step += int(np.prod(shape)) * dtype.itemsize
        cap = max(1, (256 << 20) // per_step)
        return min(8192, max(1024, 1 << (cap.bit_length() - 1)))

    @property
    def likelihood_mode(self):
        """How the likelihood is evaluated: ``"vmap"``, ``"vectorize"`` or
        ``"host"`` (see :class:`LikelihoodEvaluator`); None before the first
        run checks it.  In ``"host"`` mode no step is captured as a CUDA
        graph."""
        return self._like_eval.mode

    @property
    def _visits_host(self):
        """Whether every evaluation visits the host (a host likelihood or
        prior)."""
        return self._like_eval.host or self._prior_eval.host

    def get_eval_context(self):
        return EvalContext(
            compute_log_prior=self._prior_eval,
            compute_log_like=self._like_eval,
            tempering=self.temperature_control,
            prior_containers=self.priors,
        )

    def get_model(self):
        """Eryn's model carrier for host moves: the likelihood and prior
        take and return host arrays, ``random`` is the sampler's
        ``numpy.random.RandomState``, ``generator`` its torch generator."""
        def log_prior(coords, inds=None):
            return self.compute_log_prior(coords, inds).cpu().numpy()

        def log_like(coords, inds=None, logp=None, supps=None,
                     branch_supps=None):
            ll, blobs = self.compute_log_like(coords, inds, logp, supps,
                                              branch_supps)
            return (ll.cpu().numpy(),
                    None if blobs is None else blobs.cpu().numpy())

        return Model(
            self.log_like_fn, log_like, log_prior, self.temperature_control,
            self.pool.map if self.pool is not None else map,
            self._np_random, eval_context=self.get_eval_context(),
            generator=self._gen,
        )

    # ------------------------------------------------------------------
    # state set-up
    # ------------------------------------------------------------------
    def _setup_state(self, initial_state, skip_initial_state_check=False):
        if initial_state is None:
            if self._previous_state is None:
                raise ValueError(
                    "Cannot have initial_state=None if run_mcmc has never "
                    "been called."
                )
            initial_state = self._previous_state
        state = (
            initial_state if isinstance(initial_state, State)
            else State(initial_state)
        )
        self._use_mesh(state)
        ntemps, nwalkers = self._local_dims

        def put(x, dtype=None):
            return x.to(device=self.device, dtype=dtype or self.dtype)

        def put_supp(supp):
            # numeric entries to the device in their own dtypes; host
            # entries stay where they are
            if supp is None:
                return None
            return supp.map_tensors(
                lambda x: x.to(device=self.device).contiguous())

        coords, inds, branch_supps = {}, {}, {}
        for name in self.branch_names:
            b = state.branches[name]
            c = put(b.coords)
            m = b.inds.to(device=self.device)
            if c.shape[0] == 1 and ntemps > 1:
                c = c.repeat(ntemps, 1, 1, 1)
                m = m.repeat(ntemps, 1, 1)
            want = (ntemps, nwalkers) + self.shape[name][2:]
            if tuple(c.shape) != want:
                raise ValueError(
                    f"Branch {name} coords shape {tuple(c.shape)} does not "
                    f"match expected {want}."
                )
            coords[name], inds[name] = c.contiguous(), m.contiguous()
            branch_supps[name] = put_supp(b.branch_supplemental)
        supplemental = put_supp(state.supplemental)
        # the likelihood's supplemental argument, as the moves pass it
        supp_args = {n: s.holder for n, s in branch_supps.items()
                     if s is not None} or None
        if not self._like_checked:
            self._like_eval.check(self.device, supp_args, coords, inds)
            if self._needs_gradient():
                self._like_eval.check_grad(self.device, supp_args)
            # the priors' first evaluation builds their device constants (a
            # copy from the host): here, not in the first segment, also when
            # the state brings its log-prior (a resumed chain)
            self._prior_eval(coords, inds)
            self._like_checked = True

        tc = self.temperature_control
        if tc is None:
            betas = torch.ones(1, dtype=self.dtype, device=self.device)
        elif state.betas is None:
            betas = put(torch.as_tensor(tc.betas))
        else:
            betas = put(state.betas)
            tc.betas = betas

        nt_nw = (ntemps, nwalkers)
        if state.log_prior is not None:
            log_prior = put(state.log_prior).reshape(nt_nw)
        else:
            log_prior = self._prior_eval(coords, inds)
        blobs = state.blobs
        if blobs is not None:
            # in the likelihood's dtype, which every step merges in
            blobs = blobs.to(device=self.device,
                             dtype=self._like_eval.blob_dtype or blobs.dtype)
        if state.log_like is not None:
            log_like = put(state.log_like).reshape(nt_nw)
        if state.log_like is None or (blobs is None
                                      and self._like_eval.returns_blobs):
            ll_new, blobs_new = self._like_eval(coords, inds, log_prior,
                                                supp_args)
            if state.log_like is None:
                log_like = ll_new
            if blobs is None:
                blobs = blobs_new

        if not skip_initial_state_check:
            # over the whole ensemble: under a mesh every rank decides alike
            flags = torch.stack([torch.isnan(log_like).any(),
                                 torch.isnan(log_prior).any(),
                                 (~torch.isinf(log_prior)).any()]).double()
            if self._mesh_layout is not None:
                flags = flags.to(self._mesh_layout.device)
                self._mesh_layout.sum(flags)
            nan_ll, nan_lp, finite_lp = (bool(f > 0) for f in flags.cpu())
            if nan_ll:
                raise ValueError("The initial log_like was NaN.")
            if nan_lp or not finite_lp:
                raise ValueError("The initial log_prior was NaN or all -inf.")
        # masks are constant without reversible jump: they are stored once
        # per segment (a host copy for the host backend)
        self._static_inds = inds
        self._static_inds_host = {n: m.cpu().numpy() for n, m in inds.items()}
        if blobs is not None:
            blobs = blobs.contiguous()
            dtype = (blobs.dtype if self.blobs_dtype is None
                     else torch.from_numpy(np.empty(0, self.blobs_dtype)).dtype)
            self._blob_layout = (tuple(blobs.shape), dtype)
        else:
            self._blob_layout = None
        # the registry of host entries is rebuilt here, so that a later run
        # on a state without them inherits nothing
        self._host_supps = {}
        if supplemental is not None and supplemental.host_holder:
            self._host_supps["__state__"] = supplemental.host_holder
        for name, supp in branch_supps.items():
            if supp is not None and supp.host_holder:
                self._host_supps[name] = supp.host_holder
        out = State(
            coords, inds=inds, log_like=log_like.contiguous(),
            log_prior=log_prior.contiguous(), betas=betas.contiguous(),
            blobs=blobs, supplemental=supplemental,
            branch_supplemental=branch_supps,
        )
        if self._mesh_layout is not None:
            out.sharding = state.sharding
        return out

    def _blobs_example(self):
        """One step's blobs as an empty host array in the stored dtype (what
        a host or file backend allocates from), or None without blobs."""
        if self._blob_layout is None:
            return None
        shape, dtype = self._blob_layout
        return torch.empty(shape, dtype=dtype).numpy()

    def _inject_prov(self, state):
        """The state with an int64 identity index ``__prov__`` in its
        supplemental: the swaps move it with everything else, so at the end
        of a segment it holds, for every slot, the flat slot its walker came
        from, by which :meth:`_apply_prov` reorders the host entries.  Under
        a mesh each rank holds its slots' rows of it (the host entries are
        the whole ensemble's on every rank)."""
        nt, nw = self.ntemps, self.nwalkers
        prov = torch.arange(nt * nw, dtype=torch.int64,
                            device=self.device).reshape(nt, nw)
        if self._mesh_layout is not None:
            prov = self._mesh_layout.local(prov).contiguous()
            nt, nw = self._local_dims
        supp = state.supplemental
        if supp is None:
            supp = BranchSupplemental({}, base_shape=(nt, nw))
        return state.replace(
            supplemental=supp.with_holder({**supp.holder, "__prov__": prov}))

    def _apply_prov(self, state):
        """Reorder the registered host entries by the segment's ``__prov__``
        (a host read), drop it, and attach the host entries to ``state``'s
        supplementals."""
        nt, nw = self.ntemps, self.nwalkers
        supp = state.supplemental
        if supp is not None and "__prov__" in supp.holder:
            holder = dict(supp.holder)
            prov = holder.pop("__prov__")
            if self._mesh_layout is not None:  # every rank's slots
                prov = self._mesh_layout.gather(prov)
            prov = prov.cpu().numpy().ravel()
            supp = supp.with_holder(holder)
            if not np.array_equal(prov, np.arange(nt * nw)):
                for host in self._host_supps.values():
                    for key, arr in list(host.items()):
                        flat = arr.reshape((nt * nw,) + arr.shape[2:])
                        host[key] = flat[prov].reshape(arr.shape)
        host_state = self._host_supps.get("__state__")
        if host_state is not None:
            if supp is None:
                supp = BranchSupplemental({}, base_shape=(nt, nw))
            supp.host_holder = host_state
        elif supp is not None and not supp.holder and not supp.host_holder:
            supp = None
        branch_supps = {}
        for name, host in self._host_supps.items():
            if name == "__state__":
                continue
            bsupp = state.branches[name].branch_supplemental
            if bsupp is None:
                bsupp = BranchSupplemental({}, base_shape=(nt, nw))
            bsupp.host_holder = host
            branch_supps[name] = bsupp
        return state.replace(supplemental=supp,
                             branch_supplemental=branch_supps)

    # ------------------------------------------------------------------
    # the segment loop
    # ------------------------------------------------------------------
    def _draw_indices(self, weights, nsteps, repeats):
        shape = (nsteps, repeats)
        if len(weights) == 1:
            return np.zeros(shape, dtype=np.int64)
        w = torch.as_tensor(weights, dtype=torch.float64)
        draws = torch.multinomial(
            w, shape[0] * shape[1], replacement=True, generator=self._host_gen
        )
        return draws.reshape(shape).numpy()

    def _draw_schedule(self, nsteps):
        """Move indices into ``_all_move_list`` per step, drawn on the host:
        ``num_repeats_in_model`` in-model moves, then, under reversible
        jump, ``num_repeats_rj`` RJ moves."""
        parts = [self._draw_indices(
            self.weights, nsteps, self.num_repeats_in_model
        )]
        if self.has_reversible_jump:
            parts.append(len(self.moves) + self._draw_indices(
                self.rj_weights, nsteps, self.num_repeats_rj
            ))
        return np.concatenate(parts, axis=1)

    def _step(self, state, time, move_idx, ctx):
        """One sampler step of the eager loop (the counterpart of
        eryn_tpu's ``_make_one_step``): the in-model repeats, then the RJ
        repeats, each with its tempering epilogue.  Returns ``(state, time,
        accepted, rj_accepted, swaps)``; ``rj_accepted`` is None without
        reversible jump, and ``swaps`` are the in-model moves' swaps."""
        accepted = rj_accepted = swaps = None
        for j in move_idx:
            move = self._all_move_list[j]
            if self._host_moves[j]:
                state, acc, sw, time = self._host_step(move, state, time)
            else:
                clocks = self._phase_clocks(j)
                with fixed_phases(clocks, self._phases.phase(j, clocks)):
                    state, acc, sw, time, self._kernel_states[j] = (
                        move.step_kernel(self._gen, state, time, ctx,
                                         self._kernel_states[j])
                    )
                if clocks:
                    self._phases.advance(j, self._phase_clocks(j))
            self._m_acc[j] += acc
            self._m_nprop[j] += 1
            if j < len(self.moves):
                accepted = acc if accepted is None else accepted + acc
                swaps = sw
            else:
                rj_accepted = acc if rj_accepted is None else rj_accepted + acc
        if accepted is None:  # a schedule without in-model moves
            accepted = state.log_like.new_zeros(state.log_like.shape)
            swaps = state.log_like.new_zeros((max(self.ntemps - 1, 0),))
        return state, time, accepted, rj_accepted, swaps

    def _phase_clocks(self, j):
        """Move ``j``'s clocks with a host phase under a mesh (:meth:`~
        eryn_tpu_torch.moves.Move.mesh_clocks`), none off it."""
        if self._mesh_layout is None:
            return []
        return self._all_move_list[j].mesh_clocks(self._kernel_states[j])

    def _host_step(self, move, state, time):
        """One proposal of a host move (:func:`~eryn_tpu_torch.moves.
        legacy.host_propose`) at the clock ``time``: the control holds the
        state's ladder and the clock while it runs, and its swap phase, if
        it ran one, advances them as a native step's epilogue does.
        Returns ``(state, accepted, swaps, time)`` as :meth:`_step`'s
        moves do.

        Under a mesh every rank runs the protocol on the whole ensemble,
        gathered, as one process does: the same NumPy and torch generator
        states and every draw at its global shape, the swap phase unsharded
        (every rank makes the same decisions); then each rank keeps its
        rows."""
        tc = self.temperature_control
        lay = self._mesh_layout
        if lay is not None:
            sharding = state.sharding
            state = lay.gather_state(state)
        if tc is not None:
            tc.time, tc.betas, tc.swaps_accepted = time, state.betas, None
        with move.unwired(tc):
            state, accepted = host_propose(move, self.get_model(), state)
        acc = torch.as_tensor(accepted).to(device=self.device,
                                           dtype=self.dtype)
        if lay is not None:
            state = lay.local_state(state)
            state.sharding = sharding
            acc = lay.local(acc).contiguous()
        swaps = None if tc is None else tc.swaps_accepted
        if swaps is None:
            swaps = acc.new_zeros((max(self.ntemps - 1, 0),))
        if tc is not None:
            time = torch.as_tensor(tc.time, device=self.device).to(
                torch.int64)
        return state, acc, swaps, time

    def _u8_layout(self):
        """Per-step u8 snapshot: the accept counts and, when leaf masks can
        change, the RJ accept counts and every branch's masks."""
        nt, nw = self._local_dims
        out = [("accepted", None, (nt, nw))]
        if self.has_reversible_jump:
            out.append(("rj_accepted", None, (nt, nw)))
        if self._inds_change:
            out += [("inds", n, (nt, nw, self.nleaves_max[n]))
                    for n in self.branch_names]
        return out

    def _snap_layout(self):
        nt, nw = self._local_dims
        return [
            ("coords", n, (nt, nw, self.nleaves_max[n], self.ndims[n]))
            for n in self.branch_names
        ] + [
            ("log_like", None, (nt, nw)),
            ("log_prior", None, (nt, nw)),
            ("betas", None, (self.ntemps,)),
            ("swaps", None, (max(self.ntemps - 1, 0),)),
        ]

    @property
    def _graphed(self):
        """Whether segments replay the moves' CUDA graphs: not where every
        step visits the host, nor under a mesh whose collectives a graph
        cannot capture (gloo's).  Under an NCCL mesh the moves whose sharded
        step is planned on the device (:meth:`~eryn_tpu_torch.moves.Move.
        mesh_device_planned`: every native move and users' subclasses) are
        captured with their collectives, a graph per host phase; a host move
        runs eagerly in its slots."""
        lay = self._mesh_layout
        return (self.cuda_graph and self.device.type == "cuda"
                and not self._visits_host and (lay is None or lay.nccl))

    def _start_clock(self, tc):
        """The adaptation clock at the start of a segment, a 0-d int64
        tensor on the device: ``tc.time`` as a run left it, or filled from
        the host int a new or loaded control holds."""
        time = 0 if tc is None else tc.time
        if isinstance(time, torch.Tensor):
            return time.to(device=self.device, dtype=torch.int64)
        return torch.full((), int(time), dtype=torch.int64, device=self.device)

    def _run_bulk(self, state, nstored, thin_by=1, store=True):
        """Run ``nstored * thin_by`` steps; with ``store``, snapshot every
        ``thin_by``-th step into device buffers.  On a CUDA device with
        ``cuda_graph`` every step is replays of the moves' graphs on the
        static buffers (:class:`~eryn_tpu_torch.graphs.StepGraphs`); else
        :meth:`_step` runs it eagerly.

        Returns ``(state, snaps)``: ``snaps`` holds the packed ``fp`` buffer
        ``(nstored, F)`` (coords, log_like, log_prior, betas, swaps), the
        packed ``u8`` buffer (:meth:`_u8_layout`: accept flags, and under
        reversible jump the RJ accept flags and the leaf masks) and, where
        the state has blobs, ``blobs`` ``(nstored, ntemps, nwalkers, ...)``
        in the blob dtype, all on the device, or is None without
        ``store``."""
        self._ensure_kernel_states(state)
        if self._host_supps and self.ntemps > 1:
            state = self._inject_prov(state)
        if self._m_acc is None:
            self._m_acc = torch.zeros(
                (len(self._all_move_list),) + self._local_dims,
                dtype=self.dtype, device=self.device,
            )
        ctx = self.get_eval_context()
        tc = self.temperature_control
        mark = self.timing.start(self.device)
        time = self._start_clock(tc)
        graphs = None
        if self._graphed:
            if self._graphs is not None and not self._graphs.fits(state):
                # another layout of the state (blobs or supplementals added
                # or gone): new buffers and graphs
                self.drop_step_graphs()
            if self._graphs is None:
                self._graphs = StepGraphs(self)
            graphs = self._graphs
            state = graphs.load(state, time)
        schedule = self._draw_schedule(nstored * thin_by)
        snaps = None
        if store:
            width = sum(int(np.prod(s)) for _, _, s in self._snap_layout())
            width_u8 = sum(int(np.prod(s)) for _, _, s in self._u8_layout())
            snaps = {
                "fp": torch.empty((nstored, width), dtype=self.dtype,
                                  device=self.device),
                "u8": torch.empty((nstored, width_u8), dtype=torch.uint8,
                                  device=self.device),
            }
            if self._blob_layout is not None:
                shape, dtype = self._blob_layout
                snaps["blobs"] = torch.empty((nstored,) + shape, dtype=dtype,
                                             device=self.device)
        k = 0
        for s in range(nstored):
            for _ in range(thin_by):
                if graphs is None:
                    state, time, accepted, rj_accepted, swaps = self._step(
                        state, time, schedule[k], ctx
                    )
                else:
                    graphs.step(schedule[k], ctx)
                k += 1
            if graphs is not None:
                accepted, rj_accepted, swaps = (
                    graphs.accepted, graphs.rj_accepted, graphs.swaps)
            if store:
                torch.cat(
                    [state.branches[n].coords.reshape(-1)
                     for n in self.branch_names]
                    + [state.log_like.reshape(-1), state.log_prior.reshape(-1),
                       state.betas.reshape(-1), swaps.reshape(-1)],
                    out=snaps["fp"][s],
                )
                u8 = {"accepted": accepted, "rj_accepted": rj_accepted}
                torch.cat(
                    [(u8[kind] if name is None
                      else state.branches[name].inds).reshape(-1).to(torch.uint8)
                     for kind, name, _ in self._u8_layout()],
                    out=snaps["u8"][s],
                )
                if "blobs" in snaps:
                    snaps["blobs"][s].copy_(state.blobs)
        if graphs is not None:
            # copies: the buffers change with the next replay
            state, time, swaps = graphs.export()
        if tc is not None:
            # device tensors: reading them on the host is the caller's sync
            tc.time = time
            tc.betas = state.betas
            tc.swaps_accepted = swaps
        if self._host_supps:
            state = self._apply_prov(state)
        self._previous_state = state
        self.timing.stop(mark, nstored * thin_by)
        check_segments(self._all_move_list)
        return state, snaps

    @staticmethod
    def _split(buf, layout):
        """Named views of a packed buffer (leading step axis kept)."""
        out, off = {}, 0
        for kind, name, shape in layout:
            size = int(np.prod(shape))
            arr = buf[:, off:off + size].reshape((buf.shape[0],) + shape)
            off += size
            if name is None:
                out[kind] = arr
            else:
                out.setdefault(kind, {})[name] = arr
        return out

    def _split_fp(self, fp):
        return self._split(fp, self._snap_layout())

    def _split_u8(self, u8):
        return self._split(u8, self._u8_layout())

    def _move_fractions(self):
        if not self.track_moves:
            return None
        return {
            key: self._m_acc[i] / max(self._m_nprop[i], 1.0)
            for i, key in enumerate(self.all_moves)
        }

    def _save_snaps(self, snaps):
        """Hand one stored segment to the backend: a device backend keeps
        the packed buffers; a host or file backend gets the segment and its
        checkpoint, waiting for the copy."""
        if not self.backend.device_resident:
            self._flush(self._stage(snaps))
            return
        nt = self.ntemps
        n = snaps["fp"].shape[0]
        flags = self._split_u8(snaps["u8"])
        swaps_sum = snaps["fp"][:, snaps["fp"].shape[1] - (nt - 1):].sum(0)
        rj_sum = flags.get("rj_accepted")
        self.backend.save_segment_packed(
            n, snaps, self._make_seg_unpacker(),
            accepted_sum=flags["accepted"].to(self.dtype).sum(dim=0),
            rj_accepted_sum=(None if rj_sum is None
                             else rj_sum.to(self.dtype).sum(dim=0)),
            swaps_accepted_sum=swaps_sum if nt > 1 else None,
            moves_accepted_fraction=self._move_fractions(),
            random_state=self.random_state,
            host_random_state=self._host_gen.get_state(),
            numpy_random_state=_numpy_state_bytes(self._np_random),
        )

    def _stage(self, snaps):
        """Queue the host copy of a stored segment just run, with the
        checkpoint as of its last step: the move accept fractions, the
        clock and the kernel states are copied behind the segment's work,
        the generators' states read on the host (they advance as work is
        queued).  Nothing waits; :meth:`_flush` does."""
        tc = self.temperature_control
        fractions = self._move_fractions()
        staged = dict(
            fp=_to_host(snaps["fp"]), u8=_to_host(snaps["u8"]),
            blobs=_to_host(snaps["blobs"]) if "blobs" in snaps else None,
            fractions=None if fractions is None else {
                k: _to_host(v) for k, v in fractions.items()},
            clock=(None if tc is None or not isinstance(tc.time, torch.Tensor)
                   else _to_host(tc.time)),
            kernel_leaves=[
                [_to_host(x) if isinstance(x, torch.Tensor) else x
                 for x in tree_flatten(ks)[0]]
                for ks in self._kernel_states
            ],
            random_state=self.random_state,
            host_random_state=self._host_gen.get_state(),
            numpy_random_state=_numpy_state_bytes(self._np_random),
            copied=None,
        )
        if self.device.type == "cuda":
            staged["copied"] = torch.cuda.Event()
            staged["copied"].record()
        return staged

    def _flush(self, staged):
        """Write a staged segment and its checkpoint to the host or file
        backend, once its copies are done."""
        if staged["copied"] is not None:
            staged["copied"].synchronize()
        nt = self.ntemps
        fields = self._split_fp(staged["fp"].numpy())
        flags = self._split_u8(staged["u8"])
        rj = flags.get("rj_accepted")
        clock = staged["clock"]
        self.backend.save_segment(
            coords=fields["coords"],
            inds=({n: m.numpy().astype(bool) for n, m in flags["inds"].items()}
                  if "inds" in flags else self._static_inds_host),
            log_like=fields["log_like"],
            log_prior=fields["log_prior"],
            betas=fields["betas"],
            blobs=None if staged["blobs"] is None else staged["blobs"].numpy(),
            accepted=flags["accepted"].numpy(),
            rj_accepted=None if rj is None else rj.numpy(),
            swaps_accepted=fields["swaps"] if nt > 1 else None,
            moves_accepted_fraction=None if staged["fractions"] is None else {
                k: v.numpy() for k, v in staged["fractions"].items()
            },
            random_state=staged["random_state"],
            host_random_state=staged["host_random_state"],
            numpy_random_state=staged["numpy_random_state"],
            sampler_clock=None if clock is None else int(clock),
            kernel_states=(list(self.all_moves), self._whole_kernel_leaves(
                [host_leaves(x) for x in staged["kernel_leaves"]])),
        )

    def _make_seg_unpacker(self):
        """Closure expanding one packed segment into the device backend's
        fields: the chain NaN-masked on dead leaves, and the masks per step
        when they can change, else the static masks without a step axis."""
        static_inds = None if self._inds_change else dict(self._static_inds)
        missing = self.backend.store_missing_leaves

        def unpack(packed):
            fields = self._split_fp(packed["fp"])
            if static_inds is None:
                inds = {n: m.bool()
                        for n, m in self._split_u8(packed["u8"])["inds"].items()}
                live = inds
            else:
                inds = static_inds
                live = {n: m[None] for n, m in inds.items()}
            chain = {
                n: torch.where(live[n][..., None], c, missing)
                for n, c in fields["coords"].items()
            }
            return {
                "chain": chain,
                "inds": inds,
                "log_like": fields["log_like"],
                "log_prior": fields["log_prior"],
                "betas": fields["betas"],
                "blobs": packed.get("blobs"),
            }

        return unpack

    def _sync_move_counters(self):
        """Copy the device accept counters into the move objects."""
        if self._m_acc is None:
            return
        m_acc = self._m_acc.cpu().numpy()
        for i, move in enumerate(self._all_move_list):
            move.accepted = m_acc[i]
            move.num_proposals = int(self._m_nprop[i])
            move.kernel_state = self._kernel_states[i]

    # ------------------------------------------------------------------
    # kernel states across a checkpoint
    # ------------------------------------------------------------------
    def _ensure_kernel_states(self, state):
        if self._kernel_states is None:
            self._kernel_states = self._init_kernel_states(state)
        elif self._kernel_states_from is not False:
            # the state moved to another placement since they were made
            from .parallel.mesh import place_leaves

            src, self._kernel_states_from = self._kernel_states_from, False
            placed = []
            for m, tree in zip(self._all_move_list, self._kernel_states):
                leaves, spec = tree_flatten(tree)
                placed.append(tree_unflatten(spec, place_leaves(
                    leaves, _axes_of(m, tree), src,
                    self._mesh_layout)))
            self._kernel_states = placed

    def _whole_kernel_leaves(self, per_move):
        """``per_move``, each move's kernel-state leaves in
        :func:`tree_flatten`'s order, as a backend stores them: the whole
        ensemble's, so that a stored chain continues on any placement.
        Under a device mesh they are gathered along the axes each move
        declares (:meth:`~eryn_tpu_torch.moves.Move.kernel_state_axes`;
        every rank calls this together)."""
        from .parallel.mesh import place_leaves

        return [place_leaves(leaves, _axes_of(m, ks), self._mesh_layout,
                             None)
                for m, ks, leaves in zip(self._all_move_list,
                                         self._kernel_states, per_move)]

    def _fresh_kernel_states(self, state):
        return [() if m.host_move else m.mesh_init_kernel_state(state)
                for m in self._all_move_list]

    def _init_kernel_states(self, state):
        """The moves' fresh kernel states, or on a resumed backend the
        stored ones, validated leaf by leaf against the fresh structure:
        a mismatch (the moves changed) warns and starts fresh.  The stored
        leaves are the whole ensemble's (:meth:`_whole_kernel_leaves`),
        laid out here as the state is."""
        fresh = self._fresh_kernel_states(state)
        stored = self.backend.get_kernel_states()
        if stored is None or self.backend.iteration == 0:
            return fresh
        from .parallel.mesh import place_leaves

        keys, stored_leaves = stored
        try:
            if keys is not None and keys != list(self.all_moves):
                raise ValueError("move keys changed")
            if len(stored_leaves) != len(fresh):
                raise ValueError("move count changed")
            return [restore_kernel_state(f, place_leaves(
                        leaves, _axes_of(m, f), None,
                        self._mesh_layout))
                    for m, f, leaves in zip(self._all_move_list, fresh,
                                            stored_leaves)]
        except ValueError as err:
            warnings.warn(
                "Stored move kernel states are incompatible with the current "
                f"move configuration ({err}); proposal tuning state restarts "
                "fresh on this resume.",
                stacklevel=3,
            )
            return fresh

    def _finalize_kernel_states(self, store):
        """At the end of a stored run, save the clock and the kernel states
        to every backend (a host or file backend has them with each
        segment already; a device backend only here)."""
        if not store:
            return
        tc = self.temperature_control
        if tc is not None:
            self.backend.save_sampler_clock(int(tc.time))
        if self._kernel_states is not None:
            self.backend.save_kernel_states(
                self._whole_kernel_leaves([tree_flatten(ks)[0]
                                           for ks in self._kernel_states]),
                move_keys=list(self.all_moves))

    def _tuned_moves(self, tune):
        return [m for m in self._all_move_list
                if type(m).tune is not Move.tune] if tune else []

    # ------------------------------------------------------------------
    # public run API
    # ------------------------------------------------------------------
    def sample(self, initial_state, iterations=1, tune=False,
               skip_initial_state_check=True, thin_by=1, store=True,
               progress=False):
        """Generator yielding the state after every ``thin_by`` steps,
        ``iterations`` times (without end for ``iterations=None`` and
        ``store=False``); each yield's step is stored.  ``tune`` calls
        ``tune(state, accepted)`` of the moves that override it at each
        yield, and ``update_fn`` fires when the steps cross a multiple of
        ``update_iterations``.  However the generator ends (exhausted,
        broken out of or dropped), the clock and kernel states are saved."""
        if iterations is None and store:
            raise ValueError("Cannot have iterations be None if store == True.")
        thin_by = int(thin_by)
        if thin_by <= 0:
            raise ValueError("thin_by must be a positive integer.")
        state = self._setup_state(initial_state, skip_initial_state_check)
        self._ensure_kernel_states(state)
        if store:
            self.backend.grow(iterations, self._blobs_example())
        tuned = self._tuned_moves(tune)
        total = None if iterations is None else iterations * thin_by
        try:
            with get_progress_bar(progress, total) as pbar:
                steps = (itertools.count(1) if iterations is None
                         else range(1, iterations + 1))
                for i in steps:
                    state, snaps = self._run_bulk(state, 1, thin_by,
                                                  store=store)
                    if store:
                        self._save_snaps(snaps)
                    # code between yields may read the counters
                    self._sync_move_counters()
                    for m in tuned:
                        m.tune(state, m.accepted)
                    if (self.update_fn is not None
                            and self.update_iterations > 0
                            and _crossed((i - 1) * thin_by, i * thin_by,
                                         self.update_iterations)):
                        self.update_fn(i, state, self)
                    pbar.update(thin_by)
                    yield state
        finally:
            self._finalize_kernel_states(store)

    def run_mcmc(self, initial_state, nsteps, burn=None,
                 post_burn_update=False, tune=False,
                 skip_initial_state_check=False, thin_by=1, store=True,
                 progress=False, segment_size=None):
        """Run the chain: ``burn`` steps without storing, then ``nsteps``
        stored iterations of ``thin_by`` steps each, in segments of at most
        ``segment_size`` stored iterations (by default the greatest common
        divisor of the hook intervals, else as many as a segment holds).
        Returns the final state.

        ``post_burn_update`` calls ``update_fn`` once after the burn;
        ``tune`` calls ``tune(state, accepted)`` of the moves that override
        it after each segment; ``progress`` shows a ``tqdm`` bar.  The hooks
        fire at the first segment boundary at or past each multiple of
        their interval (``update_iterations`` counts steps, so it fires as
        often under ``thin_by``; ``plot_iterations`` and
        ``stopping_iterations`` count stored iterations); there the backend
        holds every segment run, and the order is: the move counters, the
        tuning, the plots, the stopping check, the update.  Between hooks a
        host or file backend writes each segment while the device runs the
        next."""
        state = self._setup_state(initial_state, skip_initial_state_check)
        thin_by = int(thin_by)
        if thin_by <= 0:
            raise ValueError("thin_by must be a positive integer.")
        self._ensure_kernel_states(state)
        tuned = self._tuned_moves(tune)
        if burn:
            for n in _segment_plan(int(burn), 4 * self._max_segment):
                state, _ = self._run_bulk(state, 1, n, store=False)
                if tuned:
                    self._sync_move_counters()
                for m in tuned:
                    m.tune(state, m.accepted)
            if post_burn_update and self.update_fn is not None:
                self.update_fn(0, state, self)

        def plot_fires(i0, i):
            return (self.plot_generator is not None
                    and self.plot_iterations > 0
                    and _crossed(i0, i, self.plot_iterations))

        def stop_fires(i0, i):
            return (self.stopping_fn is not None
                    and self.stopping_iterations > 0
                    and _crossed(i0, i, self.stopping_iterations))

        def update_fires(i0, i):
            return (self.update_fn is not None
                    and self.update_iterations > 0
                    and _crossed(i0 * thin_by, i * thin_by,
                                 self.update_iterations))

        intervals = [n for fn, n in ((self.stopping_fn, self.stopping_iterations),
                                     (self.update_fn, self.update_iterations),
                                     (self.plot_generator, self.plot_iterations))
                     if fn is not None and n > 0]
        if segment_size is not None:
            seg = int(segment_size)
        elif intervals:
            seg = math.gcd(*intervals)
        else:
            seg = max(1, min(int(nsteps), self._max_segment))
        pipelined = store and not self.backend.device_resident
        pending = None  # a staged segment not yet written
        i = 0
        with get_progress_bar(progress, nsteps * thin_by) as pbar:
            for n in _segment_plan(int(nsteps), seg, taper=pipelined):
                state, snaps = self._run_bulk(state, n, thin_by, store=store)
                if store and i == 0:
                    # a host backend allocates while the device runs the
                    # first segment
                    self.backend.grow(nsteps, self._blobs_example())
                i0, i = i, i + n
                hook_now = (bool(tuned) or plot_fires(i0, i)
                            or stop_fires(i0, i) or update_fires(i0, i))
                if pipelined:
                    staged = self._stage(snaps)
                    # the previous segment is written while this one runs
                    if pending is not None:
                        self._flush(pending)
                    pending = staged
                    if hook_now:  # hooks read the backend
                        self._flush(pending)
                        pending = None
                elif store:
                    self._save_snaps(snaps)
                pbar.update(n * thin_by)
                if hook_now:
                    self._sync_move_counters()
                for m in tuned:
                    m.tune(state, m.accepted)
                if plot_fires(i0, i):
                    self.plot_generator.generate_plot_info(burn=0, thin=1)
                if stop_fires(i0, i) and self._stop(i, state):
                    break
                if update_fires(i0, i):
                    self.update_fn(i, state, self)
        if pending is not None:
            self._flush(pending)
        self._sync_move_counters()
        self._finalize_kernel_states(store)
        return state

    def _stop(self, i, state):
        """``stopping_fn``'s decision; under a mesh, where it runs on every
        rank on the gathered getters, the writer rank's, on every rank."""
        stop = bool(self.stopping_fn(i, state, self))
        if self._mesh_layout is not None:
            stop = self._mesh_layout.writer_says(stop)
        return stop

    def _coerce_eval_inputs(self, coords, inds):
        if not isinstance(coords, dict):
            coords = {self.branch_names[0]: coords}
        out = {}
        for n, c in coords.items():
            c = torch.as_tensor(c, dtype=self.dtype, device=self.device)
            if c.ndim == 2:
                c = c[None, :, None, :]
            elif c.ndim == 3:
                c = c[:, :, None, :]
            out[n] = c
        if inds is None:
            inds = {n: torch.ones(c.shape[:-1], dtype=torch.bool,
                                  device=self.device) for n, c in out.items()}
        else:
            if not isinstance(inds, dict):
                inds = {self.branch_names[0]: inds}
            inds = {n: torch.as_tensor(v, device=self.device).bool()
                    for n, v in inds.items()}
        return out, inds

    def compute_log_prior(self, coords, inds=None, supps=None,
                          branch_supps=None):
        """Log prior of ``coords`` (``(nwalkers, ndim)``, ``(ntemps,
        nwalkers, ndim)`` or the 4-D layout, or a dict of them per branch)
        over the active leaves, a tensor on the sampler's device.
        ``supps`` and ``branch_supps`` are accepted as ``eryn_tpu`` accepts
        them, and not used: a prior reads no supplemental."""
        return self._prior_eval(*self._coerce_eval_inputs(coords, inds))

    def compute_log_like(self, coords, inds=None, logp=None, supps=None,
                         branch_supps=None):
        """``(log_like, blobs or None)`` of ``coords`` (as for
        :meth:`compute_log_prior`); walkers where ``logp`` is not finite
        get ``-inf`` (their blobs are the function's at zeros).
        ``branch_supps`` (``{branch: {name: tensor}}``, leading dims those
        of the coordinates) go to the likelihood under
        ``provide_supplemental``; ``supps`` is accepted as ``eryn_tpu``
        accepts it and not used."""
        coords, inds = self._coerce_eval_inputs(coords, inds)
        if logp is None:
            logp = self._prior_eval(coords, inds)
        else:
            logp = torch.as_tensor(logp, dtype=self.dtype, device=self.device)
        if branch_supps is not None:
            branch_supps = {
                n: {k: torch.as_tensor(v, device=self.device)
                    for k, v in (h.holder if isinstance(h, BranchSupplemental)
                                 else h).items()}
                for n, h in branch_supps.items() if h is not None}
        return self._like_eval(coords, inds, logp, branch_supps)

    @property
    def acceptance_fraction(self):
        # under a mesh the backend's counters are the whole ensemble's
        return self.backend.accepted / float(self.backend.iteration)

    @property
    def rj_acceptance_fraction(self):
        if not self.has_reversible_jump:
            return None
        return self.backend.rj_accepted / float(self.backend.iteration)

    @property
    def swap_acceptance_fraction(self):
        if self.ntemps == 1:
            return None
        return self.backend.swaps_accepted / float(
            self.backend.iteration * self.nwalkers
        )

    def get_chain(self, **kwargs):
        return self.backend.get_chain(**kwargs)

    def get_log_like(self, **kwargs):
        return self.backend.get_log_like(**kwargs)

    def get_blobs(self, **kwargs):
        """The stored blobs ``(nsteps, ntemps, nwalkers, ...)`` (the getter
        keywords as for :meth:`get_chain`), or None without blobs."""
        return self.backend.get_blobs(**kwargs)

    def get_log_prior(self, **kwargs):
        return self.backend.get_log_prior(**kwargs)

    def get_log_posterior(self, **kwargs):
        return self.backend.get_log_posterior(**kwargs)

    def get_inds(self, **kwargs):
        return self.backend.get_inds(**kwargs)

    def get_nleaves(self, **kwargs):
        return self.backend.get_nleaves(**kwargs)

    def get_betas(self, **kwargs):
        return self.backend.get_betas(**kwargs)

    def get_value(self, name, **kwargs):
        return self.backend.get_value(name, **kwargs)

    def get_autocorr_time(self, **kwargs):
        return self.backend.get_autocorr_time(**kwargs)

    def get_last_sample(self):
        return self.backend.get_last_sample()
