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
adapting ladder, its own clock (``(ngroups,)``) and its own kernel states.
Where a family of moves (in-model, reversible jump) has one move, every
group runs it.  Where it has two or more, each group draws its own move on
the device at every slot of a step, as ``eryn_tpu``'s per-group
``lax.switch`` does: every move of the family runs on every group, and each
group keeps the result of its own draw.

Over a group mesh (:func:`~eryn_tpu_torch.parallel.mesh.make_group_mesh`,
one process per device) rank ``r`` of ``n`` runs the groups ``r, r + n, r +
2n, ...``.  The step makes no collective.  Each of its draws is drawn at the
shape of all the groups and the rank keeps its own rows, so every group's
chain is the one a single process runs; the getters gather the groups back
into their global order.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..ensemble import EnsembleSampler, _walk_moves, check_segments
from ..graphs import StepGraphs, _assign
from ..state import ParaState, State
from ..utils.pytree import tree_flatten, tree_unflatten
from . import _comm

__all__ = ["ParaEnsembleSampler"]

_FIELDS = ("log_like", "log_prior", "betas")

#: schedule entries of a slot whose move each group draws on the device:
#: the in-model family's and the reversible-jump family's
_IN_SLOT, _RJ_SLOT = -1, -2


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


def _blend(keep, new, old):
    """``new`` for the groups where ``keep`` ``(ngroups,)`` holds, else
    ``old``."""
    return torch.where(keep.reshape((-1,) + (1,) * (new.ndim - 1)), new, old)


def _device_counters(move):
    """``(object, attribute)`` of each device counter a move (or a child of
    a composite) adds to inside its step: these are kept per group under
    the map and summed outside it."""
    return [(m, a) for m in _walk_moves([move])
            for a in getattr(m, "device_counters", ())
            if getattr(m, a, None) is not None]


class _RankRows(TorchFunctionMode):
    """Inside rank ``r`` of ``n``'s mapped step: each ``torch.rand``,
    ``torch.randn`` and ``torch.randint`` draws ``n`` rows where it drew one,
    and the rank keeps row ``r``.  Under ``vmap(randomness="different")``
    over ``G / n`` groups that is one draw of the elements one process draws
    for all ``G`` groups, and group ``b`` of the rank gets the numbers of
    group ``b * n + r``."""

    def __init__(self, n, r):
        super().__init__()
        self.n, self.r = n, r

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if func in (torch.rand, torch.randn):
            size = kwargs.pop("size", None)
            if size is None:
                size = (args[0] if len(args) == 1
                        and not isinstance(args[0], int) else args)
            return func((self.n,) + tuple(size), **kwargs)[self.r]
        if func is torch.randint:
            size = kwargs.pop("size", None)
            if size is None:
                *bounds, size = args
            else:
                bounds = list(args)
            return func(*bounds, (self.n,) + tuple(size), **kwargs)[self.r]
        return func(*args, **kwargs)


def _inner(name):
    """A read-only attribute forwarded to the inner ``EnsembleSampler``."""
    return property(lambda self: getattr(self.sampler, name))


def _rank_groups(x, n, r):
    """Rank ``r`` of ``n``'s groups ``r, r + n, ...`` of a leading group
    axis."""
    return x if n == 1 else x[r::n]


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

    def step(self, row, ctx):
        """One step of every group: per entry of ``row`` (a move index, or
        a slot whose move each group draws), the replay of its graph, its
        capture, or its first run eagerly."""
        smp = self.sampler
        kinds = set()
        for j in row:
            j = int(j)
            kind = smp._in_model(j)
            key = (j, kind not in kinds)
            kinds.add(kind)
            if j >= 0:
                smp._m_nprop[j] += 1
            entry = self.graphs.get(key)
            if entry is None:
                if key not in self.warm:
                    self._body(key, ctx)
                    self.warm.add(key)
                    continue
                entry = self.graphs[key] = self._capture(key, ctx)
            graph, counts = entry
            graph.replay()
            for kernel, n in counts:
                kernel.launches += n
            smp.graph_replays += 1

    def _record(self, j, first, acc, swaps):
        out = self.accepted if self.sampler._in_model(j) else self.rj_accepted
        if first:
            out.copy_(acc)
        else:
            out.add_(acc)
        if self.sampler._in_model(j):
            self.swaps.copy_(swaps)

    def _body(self, key, ctx):
        j, first = key
        smp = self.sampler
        st, acc, swaps, time, kstates = smp._run_entry(j, self.state,
                                                       self.clock, ctx)
        for m, ks in kstates:
            for dst, src in zip(smp._ks_tensors(m), ks):
                _assign(dst, src)
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
    through an ordinary sampler's backend.  Moves that run on the host, and
    host likelihoods, are refused.  A likelihood that returns ``(log_like,
    blobs)`` runs on its log-likelihood: the blobs are dropped, with a
    warning at the first set-up, as ``eryn_tpu``'s runner drops them.

    ``mesh``, a 1-D group mesh (:func:`~eryn_tpu_torch.parallel.mesh.
    make_group_mesh`, one rank per device), spreads the groups over the
    ranks: every rank builds the sampler alike and passes the same global
    inputs, runs its groups ``r, r + n, ...`` (see the module), and the
    getters return every group in global order; :meth:`run_mcmc` returns
    the rank's groups.  ``ngroups`` must divide by the mesh's size.
    """

    def __init__(self, ngroups, nwalkers, ndims, log_like_fn, priors,
                 seed=None, mesh=None, **kwargs):
        self.ngroups = int(ngroups)
        self.mesh = mesh
        self._n, self._r = 1, 0  # the group mesh's size, this rank
        if mesh is not None:
            if (getattr(mesh, "ndim", None) != 1
                    or not hasattr(mesh, "get_local_rank")):
                raise ValueError(
                    "ParaEnsembleSampler expects a 1-D group mesh "
                    f"(parallel.make_group_mesh); got {mesh!r}.")
            self._n, self._r = int(mesh.size()), int(mesh.get_local_rank())
            if self.ngroups % self._n != 0:
                raise ValueError(
                    f"ngroups ({self.ngroups}) must be divisible by the "
                    f"group-mesh size ({self._n}).")
        #: the groups this process runs
        self._g = self.ngroups // self._n
        if "backend" in kwargs:
            # silently dropping a backend would lose the user's chain file
            raise ValueError(
                "ParaEnsembleSampler keeps its batched chain in memory and "
                "does not accept a backend; export per group through "
                "ordinary single-group backends instead.")
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
        # per group, the proposals of the moves each group draws itself
        self._m_nprop_g = None
        self._warned_blobs = False
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
        coords = {n: _rank_groups(c, self._n, self._r)
                  for n, c in coords.items()}
        if inds is not None:
            inds = {n: _rank_groups(v, self._n, self._r)
                    for n, v in inds.items()}
        states = []
        for g in range(self._g):
            state = s._setup_state(State(
                {n: c[g] for n, c in coords.items()},
                inds=None if inds is None else {
                    n: torch.as_tensor(np.asarray(v)[g] if not isinstance(
                        v, torch.Tensor) else v[g]).bool()
                    for n, v in inds.items()}),
                skip_initial_state_check=True)
            if any(b.branch_supplemental is not None
                   for b in state.branches.values()):
                raise NotImplementedError(
                    "ParaEnsembleSampler carries coordinates, masks, "
                    "log-likelihoods, log-priors and the ladder; blobs and "
                    "supplementals take EnsembleSampler.")
            if state.blobs is not None and not self._warned_blobs:
                self._warned_blobs = True
                warnings.warn(
                    "ParaEnsembleSampler runs a likelihood that returns "
                    "(log_like, blobs) on its log-likelihood and drops the "
                    "blobs, as eryn_tpu's runner does; EnsembleSampler "
                    "stores them.", stacklevel=3)
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

    def _mapped_step(self, j, st, time, ctx, keep=None):
        """Move ``j`` on every group at once: ``torch.func.vmap`` of its
        ``propose_kernel`` over the state dict, the clock, the kernel
        state's tensors and the move's device counters.  Returns ``(state
        dict, accepted, swaps, clock, kernel-state tensors)``, each with a
        leading group axis; the counters of the groups ``keep`` (a
        ``(ngroups,)`` bool, default all) are summed into the move's."""
        s = self.sampler
        move = s._all_move_list[j]
        leaves, spec = tree_flatten(self._kernel_states[j])
        where = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
        counters = _device_counters(move)
        zeros = [torch.zeros((self._g,) + tuple(getattr(o, a).shape),
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

        mapped = torch.func.vmap(one, randomness="different")
        if self._n == 1:
            out = mapped(st, time, [leaves[i] for i in where], zeros)
        else:
            with _RankRows(self._n, self._r):
                out = mapped(st, time, [leaves[i] for i in where], zeros)
        for (o, a), c in zip(counters, out[5]):
            if keep is not None:
                c = _blend(keep, c, torch.zeros_like(c))
            getattr(o, a).add_(c.sum(dim=0))
        return out[:5]

    def _in_model(self, j):
        """Whether schedule entry ``j`` (a move index or a slot marker) is
        an in-model move."""
        return j == _IN_SLOT or 0 <= j < len(self.sampler.moves)

    def _schedule(self, nsteps):
        """The step's entries: as ``EnsembleSampler._draw_schedule``'s rows
        where a family has one move (every group runs it), a slot marker
        (:data:`_IN_SLOT`, :data:`_RJ_SLOT`) where it has more, whose move
        each group draws on the device."""
        s = self.sampler
        cols = [np.full((nsteps, s.num_repeats_in_model),
                        0 if len(s.moves) == 1 else _IN_SLOT)]
        if s.has_reversible_jump:
            cols.append(np.full(
                (nsteps, s.num_repeats_rj),
                len(s.moves) if len(s.rj_moves) == 1 else _RJ_SLOT))
        return np.concatenate(cols, axis=1)

    def _family(self, marker):
        """The move indices of a slot marker's family and its cumulative
        weights (float64, on the device)."""
        s = self.sampler
        if marker == _IN_SLOT:
            idx, w = range(len(s.moves)), s.weights
        else:
            idx, w = range(len(s.moves), len(s._all_move_list)), s.rj_weights
        w = np.asarray(w, dtype=np.float64)
        cum = torch.as_tensor(np.cumsum(w / w.sum()), device=self.device)
        return list(idx), cum

    def _run_entry(self, j, st, time, ctx):
        """One entry of a step on every group: move ``j``, or for a slot
        marker the move each group draws (:meth:`_group_slot`).  Adds the
        accept flags into the move counters; returns ``(state dict,
        accepted, swaps, clock, [(move index, kernel-state tensors)])``."""
        if j < 0:
            return self._group_slot(j, st, time, ctx)
        st, acc, swaps, time, ks = self._mapped_step(j, st, time, ctx)
        self._m_acc[j] += acc
        return st, acc, swaps, time, [(j, ks)]

    def _group_slot(self, marker, st, time, ctx):
        """A slot whose move each group draws: one uniform per group (drawn
        for all ``ngroups`` groups; a rank of a group mesh keeps its own)
        picks a move of the family by its weight, every move of the family
        runs on every group from the slot's state, and each group keeps the
        state, clock, flags, swaps, kernel state and counters of its own
        draw."""
        moves, cum = self._family(marker)
        u = torch.rand((self.ngroups,), generator=self._gen,
                       dtype=torch.float64, device=self.device)
        pick = torch.searchsorted(
            cum, _rank_groups(u, self._n, self._r).contiguous(), right=True
        ).clamp_(max=len(moves) - 1)
        out_st, out_time, accepted, swaps, kstates = st, time, None, None, []
        for pos, j in enumerate(moves):
            keep = pick == pos
            new, acc, sw, t, ks = self._mapped_step(j, st, time, ctx, keep)
            out_st = _map(lambda n, o: _blend(keep, n, o), new, out_st)
            out_time = _blend(keep, t, out_time)
            acc = _blend(keep, acc, torch.zeros_like(acc))
            accepted = acc if accepted is None else accepted + acc
            swaps = sw if swaps is None else _blend(keep, sw, swaps)
            kstates.append((j, [_blend(keep, x, o) for x, o in zip(
                ks, self._ks_tensors(j))]))
            self._m_acc[j] += acc
            self._m_nprop_g[j] += keep
        return out_st, accepted, swaps, out_time, kstates

    def _step(self, st, time, row, ctx):
        """One eager step of every group (see ``EnsembleSampler._step``)."""
        s = self.sampler
        accepted = rj_accepted = swaps = None
        for j in row:
            st, acc, sw, time, kstates = self._run_entry(j, st, time, ctx)
            for m, ks_t in kstates:
                leaves, spec = tree_flatten(self._kernel_states[m])
                it = iter(ks_t)
                # contiguous: a groups_running blend writes into them
                self._kernel_states[m] = tree_unflatten(spec, [
                    next(it).contiguous() if isinstance(x, torch.Tensor) else x
                    for x in leaves])
            if j >= 0:
                self._m_nprop[j] += 1
            if self._in_model(j):
                accepted = acc if accepted is None else accepted + acc
                swaps = sw
            else:
                rj_accepted = acc if rj_accepted is None else rj_accepted + acc
        if accepted is None:
            accepted = torch.zeros_like(st["log_like"])
            swaps = st["log_like"].new_zeros(
                (self._g, max(s.ntemps - 1, 0)))
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
        schedule = self._schedule(nstored * thin_by)
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
            running = _rank_groups(running, self._n, self._r)
        if self._state is None or coords is not None:
            st, state0 = self._setup_states(coords, inds)
            time = torch.zeros((self._g,), dtype=torch.int64,
                               device=self.device)
            proto = [m.init_kernel_state(state0) for m in s._all_move_list]
            self._kernel_states = [_broadcast(ks, self._g)
                                   for ks in proto]
            self._state = (st, time)
            self._graphs = None
        if self._m_acc is None:
            nt, nw = s.ntemps, s.nwalkers
            self._m_acc = torch.zeros(
                (len(s._all_move_list), self._g, nt, nw),
                dtype=s.dtype, device=self.device)
            self._m_nprop_g = torch.zeros(
                (len(s._all_move_list), self._g), dtype=torch.int64,
                device=self.device)
            self._acc_sum = torch.zeros((self._g, nt, nw), dtype=s.dtype,
                                        device=self.device)
            self._swaps_sum = torch.zeros((self._g, max(nt - 1, 0)),
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
            groups_running=(torch.ones(self._g, dtype=torch.bool,
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
        (copied from the device once, until the next stored segment); over a
        group mesh every rank's groups, in global order."""
        if key not in self._host:
            first = self._segments[0][key]

            def whole(parts):
                return self._all_groups(torch.cat(parts), axis=1)

            if isinstance(first, dict):
                self._host[key] = {
                    n: whole([seg[key][n] for seg in self._segments])
                    for n in first}
            else:
                self._host[key] = whole([seg[key] for seg in self._segments])
        return self._host[key]

    def _all_groups(self, x, axis=0):
        """``x``, this rank's groups along ``axis``, as a host array of every
        group in global order (one gather over the group mesh)."""
        if self._n == 1:
            return x.cpu().numpy()
        group = self.mesh.get_group()
        if torch.distributed.get_backend(group) != "nccl":
            x = x.cpu()
        send = x.movedim(axis, 0).contiguous()
        as_bytes = send.dtype == torch.bool
        if as_bytes:
            send = send.view(torch.uint8)
        out = send.new_empty((self._n * send.shape[0],) + send.shape[1:])
        _comm.all_gather_into_tensor(out, send, group=group)
        # rank r's group b is group b * n + r
        out = out.view((self._n, self._g) + send.shape[1:]).transpose(0, 1)
        out = out.reshape((self.ngroups,) + send.shape[1:])
        if as_bytes:
            out = out.view(torch.bool)
        return out.movedim(0, axis).cpu().numpy()

    @property
    def move_proposals(self):
        """Per move and group, the proposals each group made with each
        move, ``(nmoves, ngroups)``: every group runs a move that is the
        only one of its family, and draws its own among two or more."""
        if self._m_nprop_g is None:
            return np.zeros((len(self._m_nprop), self.ngroups), dtype=np.int64)
        drawn = self._all_groups(self._m_nprop_g, axis=1)
        return drawn + self._m_nprop.astype(np.int64)[:, None]

    # ------------------------------------------------------------------
    @property
    def acceptance_fraction(self):
        """Per group, temperature and walker, the accepted share of the
        stored steps' in-model proposals, ``(ngroups, ntemps, nwalkers)``."""
        return self._all_groups(self._acc_sum / max(self._nstored, 1))

    @property
    def swap_acceptance_fraction(self):
        """Per group and boundary, the accepted swaps per walker of the
        stored steps, ``(ngroups, ntemps - 1)``."""
        nw = self.sampler.nwalkers
        return self._all_groups(self._swaps_sum / max(self._nstored, 1) / nw)

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
