"""Batched independent ensembles: ``ngroups`` ensembles in one step.

Port of :mod:`eryn_tpu.parallel.para`.  Users run hundreds of independent
parallel-tempering ensembles at once (one per data segment, or one per
initialisation); here, as in ``eryn_tpu``, one sampler step is mapped over a
leading ``ngroups`` axis, so every group advances in the same launches.

Each move's functional step (:meth:`~eryn_tpu_torch.moves.move.Move.
propose_kernel`) runs under ``torch.func.vmap(..., randomness="different")``
over the group-batched state, clock and kernel states.  The kernels see the
group axis through the custom ops of :mod:`~eryn_tpu_torch.ops._grouped`,
whose vmap rules launch each kernel once for every group (the stretch
kernels over ``G * ntemps`` rows, the cascade with ``blockIdx.y`` the
group).  On a CUDA device the mapped step of each move is captured as one
CUDA graph on group-batched buffers and replayed, as
:class:`~eryn_tpu_torch.graphs.StepGraphs` captures one ensemble's.

Every group has its own draws (``randomness="different"``: each draw of a
step is drawn for all groups at once from the sampler's generator), its own
adapting ladder, its own clock (``(ngroups,)``) and its own kernel states;
the move schedule is drawn on the host once per step for all groups.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ensemble import EnsembleSampler, _walk_moves, check_segments
from ..graphs import StepGraphs, _assign
from ..state import ParaState, State
from ..utils.pytree import tree_flatten, tree_unflatten

__all__ = ["ParaEnsembleSampler"]

_FIELDS = ("log_like", "log_prior", "betas")


def _state_dict(state):
    """The tensors of a :class:`State` the para runner carries."""
    return {"coords": dict(state.branches_coords),
            "inds": dict(state.branches_inds),
            **{f: getattr(state, f) for f in _FIELDS}}


def _dict_state(st):
    return State(st["coords"], inds=st["inds"],
                 **{f: st[f] for f in _FIELDS})


def _map(fn, *trees):
    """``fn`` over the tensors of state dicts of one layout."""
    first = trees[0]
    return {"coords": {n: fn(*(t["coords"][n] for t in trees))
                       for n in first["coords"]},
            "inds": {n: fn(*(t["inds"][n] for t in trees))
                     for n in first["inds"]},
            **{f: fn(*(t[f] for t in trees)) for f in _FIELDS}}


def _device_counters(move):
    """``(object, attribute)`` of each device counter a move (or a child of
    a composite) adds to inside its step: these are kept per group under
    the map and summed outside it."""
    return [(m, a) for m in _walk_moves([move])
            for a in getattr(m, "device_counters", ())
            if getattr(m, a, None) is not None]


def _inner(name):
    """A read-only attribute forwarded to the inner ``EnsembleSampler``."""
    return property(lambda self: getattr(self.sampler, name))


class _ParaGraphs(StepGraphs):
    """:class:`StepGraphs` on group-batched buffers: the state dict, the
    clock ``(ngroups,)``, and per group the accept flags and swaps."""

    def load(self, st, time):
        if self.state is None:
            self.state = _map(lambda x: x.clone(
                memory_format=torch.contiguous_format), st)
            self.clock = time.clone()
            logl = self.state["log_like"]
            self.accepted = torch.zeros_like(logl)
            if self.sampler.has_reversible_jump:
                self.rj_accepted = torch.zeros_like(logl)
            self.swaps = logl.new_zeros(
                (logl.shape[0], max(logl.shape[1] - 1, 0)))
            return self.state
        _map(_assign, self.state, st)
        _assign(self.clock, time)
        return self.state

    def export(self):
        return (_map(torch.clone, self.state), self.clock.clone(),
                self.swaps.clone())

    def _body(self, key, ctx):
        j, first = key
        smp = self.sampler
        st, acc, swaps, time, ks = smp._mapped_step(j, self.state,
                                                    self.clock, ctx)
        for dst, src in zip(smp._ks_tensors(j), ks):
            _assign(dst, src)
        smp._m_acc[j] += acc
        self._record(j, first, acc, swaps)
        _assign(self.clock, time)
        _map(_assign, self.state, st)


class ParaEnsembleSampler:
    """Run ``ngroups`` independent ensembles batched over a group axis.

    Takes the configuration of :class:`~eryn_tpu_torch.EnsembleSampler`
    (``device``, ``dtype``, ``cuda_graph`` included); every group gets its
    own draws, temperature ladder (adapting independently), clock, kernel
    states and chain.  The batched chain stays in memory (``(nsteps,
    ngroups, ntemps, nwalkers, ...)``, on the sampler's device; the getters
    return host arrays) and a ``backend`` is refused: export a group
    through an ordinary sampler's backend.
    ``mesh`` (groups spread over devices) is not ported: anything but None
    raises.  Moves that run on the host, and host likelihoods, are refused.
    """

    def __init__(self, ngroups, nwalkers, ndims, log_like_fn, priors,
                 seed=None, mesh=None, **kwargs):
        if mesh is not None:
            raise NotImplementedError(
                "ParaEnsembleSampler(mesh=...) spreads the groups over a "
                "device mesh in eryn_tpu; eryn_tpu_torch runs every group on "
                "one card (parallel/mesh.py is not ported): pass mesh=None.")
        if "backend" in kwargs:
            # silently dropping a backend would lose the user's chain file
            raise ValueError(
                "ParaEnsembleSampler keeps its batched chain in memory and "
                "does not accept a backend; export per group through "
                "ordinary single-group backends instead.")
        self.ngroups = int(ngroups)
        self.sampler = s = EnsembleSampler(
            nwalkers, ndims, log_like_fn, priors, seed=seed, **kwargs)
        if any(s._host_moves):
            raise ValueError(
                "ParaEnsembleSampler maps the moves' device steps over the "
                "groups; a move written for the host protocol cannot be "
                "mapped.")
        self.device = s.device
        self._graphs = None
        self.graph_replays = self.graph_captures = 0
        self._kernel_states = None
        self._m_acc = None
        self._m_nprop = np.zeros(len(s._all_move_list))
        self._state = None  # (state dict, clock)
        self._segments = []  # stored segments, on the device
        self._host = {}  # the getters' host copies
        self._acc_sum = self._swaps_sum = None
        self._nstored = 0

    # what StepGraphs reads of its sampler besides the counters and kernel
    # states this runner keeps per group: the inner sampler's
    moves = _inner("moves")
    _all_move_list = _inner("_all_move_list")
    _host_moves = _inner("_host_moves")
    _gen = _inner("_gen")
    has_reversible_jump = _inner("has_reversible_jump")
    log_like_fn = _inner("log_like_fn")

    # ------------------------------------------------------------------
    def _setup_states(self, coords, inds=None):
        """The group-batched state dict from ``coords`` ``{name: (ngroups,
        ntemps, nwalkers, nleaves_max, ndim)}`` (or a bare array for one
        branch; 3-D and 4-D forms as in ``eryn_tpu``) and ``inds``."""
        s = self.sampler
        if not isinstance(coords, dict):
            coords = {s.branch_names[0]: coords}
        coords = {n: _coerce5(torch.as_tensor(np.asarray(c) if not isinstance(
            c, torch.Tensor) else c)) for n, c in coords.items()}
        if inds is not None and not isinstance(inds, dict):
            inds = {s.branch_names[0]: inds}
        states = []
        for g in range(self.ngroups):
            state = s._setup_state(State(
                {n: c[g] for n, c in coords.items()},
                inds=None if inds is None else {
                    n: torch.as_tensor(np.asarray(v)[g] if not isinstance(
                        v, torch.Tensor) else v[g]).bool()
                    for n, v in inds.items()}),
                skip_initial_state_check=True)
            if state.blobs is not None or any(
                    b.branch_supplemental is not None
                    for b in state.branches.values()):
                raise NotImplementedError(
                    "ParaEnsembleSampler carries coordinates, masks, "
                    "log-likelihoods, log-priors and the ladder; blobs and "
                    "supplementals take EnsembleSampler.")
            states.append(_state_dict(state))
        if s._like_eval.host or s._prior_eval.host:
            raise ValueError(
                "ParaEnsembleSampler maps the step over the groups on the "
                "device; a NumPy likelihood or prior runs on the host and "
                "cannot be mapped.")
        return _map(lambda *xs: torch.stack(xs).contiguous(), *states), \
            State(states[0]["coords"], inds=states[0]["inds"],
                  **{f: states[0][f] for f in _FIELDS})

    def _ks_tensors(self, j):
        return [x for x in tree_flatten(self._kernel_states[j])[0]
                if isinstance(x, torch.Tensor)]

    def _mapped_step(self, j, st, time, ctx):
        """Move ``j`` on every group at once: ``torch.func.vmap`` of its
        ``propose_kernel`` over the state dict, the clock, the kernel
        state's tensors and the move's device counters.  Returns ``(state
        dict, accepted, swaps, clock, kernel-state tensors)``, each with a
        leading group axis; the counters are summed into the move's."""
        s = self.sampler
        move = s._all_move_list[j]
        leaves, spec = tree_flatten(self._kernel_states[j])
        where = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        counters = _device_counters(move)
        zeros = [torch.zeros((self.ngroups,) + tuple(getattr(o, a).shape),
                             dtype=getattr(o, a).dtype, device=self.device)
                 for o, a in counters]

        def one(st, time, ks_t, cnt):
            full = list(leaves)
            for i, x in zip(where, ks_t):
                full[i] = x
            held = [getattr(o, a) for o, a in counters]
            try:
                for (o, a), c in zip(counters, cnt):
                    setattr(o, a, c.clone())
                new, acc, swaps, time, ks = move.propose_kernel(
                    s._gen, _dict_state(st), time, ctx,
                    tree_unflatten(spec, full))
                cnt = [getattr(o, a) for o, a in counters]
            finally:
                for (o, a), h in zip(counters, held):
                    setattr(o, a, h)
            ks_t = [x for x in tree_flatten(ks)[0] if isinstance(x, torch.Tensor)]
            return _state_dict(new), acc, swaps, time, ks_t, cnt

        out = torch.func.vmap(one, randomness="different")(
            st, time, [leaves[i] for i in where], zeros)
        for (o, a), c in zip(counters, out[5]):
            getattr(o, a).add_(c.sum(dim=0))
        return out[:5]

    def _step(self, st, time, row, ctx):
        """One eager step of every group (see ``EnsembleSampler._step``)."""
        s = self.sampler
        accepted = rj_accepted = swaps = None
        for j in row:
            st, acc, sw, time, ks_t = self._mapped_step(j, st, time, ctx)
            leaves, spec = tree_flatten(self._kernel_states[j])
            it = iter(ks_t)
            # contiguous: a groups_running blend writes into them
            self._kernel_states[j] = tree_unflatten(spec, [
                next(it).contiguous() if isinstance(x, torch.Tensor) else x
                for x in leaves])
            self._m_acc[j] += acc
            self._m_nprop[j] += 1
            if j < len(s.moves):
                accepted = acc if accepted is None else accepted + acc
                swaps = sw
            else:
                rj_accepted = acc if rj_accepted is None else rj_accepted + acc
        if accepted is None:
            accepted = torch.zeros_like(st["log_like"])
            swaps = st["log_like"].new_zeros(
                (self.ngroups, max(s.ntemps - 1, 0)))
        return st, time, accepted, rj_accepted, swaps

    def _run_segment(self, st, time, nstored, thin_by, store):
        """``nstored * thin_by`` steps of every group; with ``store`` the
        state after every ``thin_by``-th step in device buffers ``(nstored,
        ngroups, ...)``."""
        s = self.sampler
        ctx = s.get_eval_context()
        graphs = None
        if s._graphed:
            if self._graphs is None:
                self._graphs = _ParaGraphs(self)
            graphs = self._graphs
            st = graphs.load(st, time)
        schedule = s._draw_schedule(nstored * thin_by)
        bufs = None
        if store:
            keep = dict(st) if s._inds_change else {
                k: v for k, v in st.items() if k != "inds"}
            bufs = {k: ({n: x.new_empty((nstored,) + tuple(x.shape))
                         for n, x in v.items()} if isinstance(v, dict)
                        else v.new_empty((nstored,) + tuple(v.shape)))
                    for k, v in keep.items()}
        k = 0
        for i in range(nstored):
            for _ in range(thin_by):
                if graphs is None:
                    st, time, acc, _, swaps = self._step(st, time,
                                                         schedule[k], ctx)
                else:
                    graphs.step(schedule[k], ctx)
                k += 1
            if not store:
                continue
            if graphs is not None:
                acc, swaps = graphs.accepted, graphs.swaps
            self._acc_sum += acc
            self._swaps_sum += swaps
            for key, buf in bufs.items():
                if isinstance(buf, dict):
                    for n, b in buf.items():
                        b[i].copy_(st[key][n])
                else:
                    buf[i].copy_(st[key])
        if graphs is not None:
            st, time, _ = graphs.export()
        check_segments(s._all_move_list)
        return st, time, bufs

    # ------------------------------------------------------------------
    def run_mcmc(self, coords, nsteps, burn=None, thin_by=1, inds=None,
                 store=True, groups_running=None):
        """Advance every group; returns the final :class:`ParaState`.

        ``burn`` runs that many raw steps first, unstored (``thin_by`` does
        not apply to it); then ``nsteps`` stored steps, each after
        ``thin_by`` steps.  ``coords`` None continues from the last state.
        ``groups_running``, a ``(ngroups,)`` bool mask, applies to this
        call only: the stopped groups are computed in lockstep but frozen
        by a ``where`` blend (state, clock and kernel states), and their
        stored chain repeats the frozen snapshot.
        """
        s = self.sampler
        running = None
        if groups_running is not None:
            running = torch.as_tensor(np.asarray(groups_running),
                                      device=self.device).bool()
            if tuple(running.shape) != (self.ngroups,):
                raise ValueError(
                    f"groups_running must have shape ({self.ngroups},).")
        if self._state is None or coords is not None:
            st, state0 = self._setup_states(coords, inds)
            time = torch.zeros((self.ngroups,), dtype=torch.int64,
                               device=self.device)
            proto = [m.init_kernel_state(state0) for m in s._all_move_list]
            self._kernel_states = [_broadcast(ks, self.ngroups)
                                   for ks in proto]
            self._state = (st, time)
            self._graphs = None
        if self._m_acc is None:
            nt, nw = s.ntemps, s.nwalkers
            self._m_acc = torch.zeros(
                (len(s._all_move_list), self.ngroups, nt, nw),
                dtype=s.dtype, device=self.device)
            self._acc_sum = torch.zeros((self.ngroups, nt, nw), dtype=s.dtype,
                                        device=self.device)
            self._swaps_sum = torch.zeros((self.ngroups, max(nt - 1, 0)),
                                          dtype=s.dtype, device=self.device)
        st, time = self._state
        gate = running is not None and not bool(running.all())
        old = (st, time, [[x.clone() for x in self._ks_tensors(j)]
                          for j in range(len(self._kernel_states))]
               ) if gate else None

        if burn:
            st, time, _ = self._run_segment(st, time, 1, int(burn), False)
            if gate:  # the stored segment starts from the frozen snapshot
                st, time = self._freeze(running, (st, time), old)
        if nsteps:
            prev = st
            st, time, bufs = self._run_segment(st, time, int(nsteps),
                                               int(thin_by), store)
            if store:
                self._save(bufs, prev if gate else None, running)
        if gate:
            st, time = self._freeze(running, (st, time), old)
        self._state = (st, time)
        return ParaState(
            st["coords"], inds=st["inds"],
            **{f: st[f] for f in _FIELDS},
            groups_running=(torch.ones(self.ngroups, dtype=torch.bool,
                                       device=self.device)
                            if running is None else running))

    def _freeze(self, running, new, old):
        """Stopped groups keep ``old``'s state, clock and kernel states."""
        def blend(n, o):
            mask = running.reshape((-1,) + (1,) * (n.ndim - 1))
            return torch.where(mask, n, o)

        st, time = new
        st = _map(blend, st, old[0])
        time = blend(time, old[1])
        for j, saved in enumerate(old[2]):
            for x, o in zip(self._ks_tensors(j), saved):
                x.copy_(blend(x, o))
        return st, time

    def _save(self, bufs, frozen, running):
        """Keep a stored segment, ``(nstored, ngroups, ...)`` on the
        sampler's device, the stopped groups repeating ``frozen``; the
        getters copy the chain to the host when they are called."""
        stop = None if frozen is None else ~running

        def keep(x, f=None):
            if stop is not None and f is not None:
                x[:, stop] = f[stop]
            return x

        f = frozen or {"coords": {}, "inds": {}}
        nstored = bufs["log_like"].shape[0]
        seg = {"coords": {n: keep(c, f["coords"].get(n))
                          for n, c in bufs["coords"].items()}}
        if "inds" in bufs:
            seg["inds"] = {n: keep(m, f["inds"].get(n))
                           for n, m in bufs["inds"].items()}
        else:  # the masks do not change: one copy for every step
            seg["inds"] = {n: m[None].expand((nstored,) + tuple(m.shape))
                           for n, m in self._state[0]["inds"].items()}
        for name in _FIELDS:
            seg[name] = keep(bufs[name], None if frozen is None
                             else frozen[name])
        self._segments.append(seg)
        self._host = {}
        self._nstored += nstored

    def _get(self, key):
        """The stored field ``key`` over every segment, as host arrays
        (copied from the device once, until the next stored segment)."""
        if key not in self._host:
            first = self._segments[0][key]
            if isinstance(first, dict):
                self._host[key] = {
                    n: torch.cat([seg[key][n] for seg in self._segments]
                                 ).cpu().numpy() for n in first}
            else:
                self._host[key] = torch.cat(
                    [seg[key] for seg in self._segments]).cpu().numpy()
        return self._host[key]

    # ------------------------------------------------------------------
    @property
    def acceptance_fraction(self):
        """Per group, temperature and walker, the accepted share of the
        stored steps' in-model proposals, ``(ngroups, ntemps, nwalkers)``."""
        return (self._acc_sum / max(self._nstored, 1)).cpu().numpy()

    @property
    def swap_acceptance_fraction(self):
        """Per group and boundary, the accepted swaps per walker of the
        stored steps, ``(ngroups, ntemps - 1)``."""
        nw = self.sampler.nwalkers
        return (self._swaps_sum / max(self._nstored, 1) / nw).cpu().numpy()

    def get_chain(self):
        return self._get("coords")

    def get_inds(self):
        return self._get("inds")

    def get_log_like(self):
        return self._get("log_like")

    def get_log_prior(self):
        return self._get("log_prior")

    def get_betas(self):
        return self._get("betas")

def _coerce5(c):
    """``(ngroups, [ntemps,] nwalkers, [nleaves_max,] ndim)`` -> 5-D."""
    if c.ndim == 3:
        return c[:, None, :, None, :]
    if c.ndim == 4:
        return c[:, :, :, None, :]
    if c.ndim != 5:
        raise ValueError(f"coords must be 3-5D, got {tuple(c.shape)}")
    return c


def _broadcast(tree, ngroups):
    """A kernel state with each tensor leaf repeated over a leading group
    axis (contiguous: the graphs write into it)."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [
        x.expand((ngroups,) + tuple(x.shape)).contiguous()
        if isinstance(x, torch.Tensor) else x for x in leaves])
