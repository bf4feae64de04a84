"""Move base class and the proposal evaluation context.

Port of :mod:`eryn_tpu.moves.move`.  A move is a configuration shell whose
:meth:`Move.propose_kernel` advances the ensemble by one proposal,

    ``(generator, state, time, ctx) -> (state, accepted, swaps_accepted, time)``,

drawing its randomness from the sampler's ``torch.Generator``.  Eryn's host
protocol is here too: :meth:`Move.propose` ``(model, state)``, and the
NumPy hooks of a subclass written for Eryn (``get_proposal``, the friends
and the multiple-try hooks, or ``propose`` itself), which flag the move
``host_move`` and run through :mod:`eryn_tpu_torch.moves.legacy` on host
copies of the state.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.periodic import PeriodicContainer
from ..utils.pytree import tree_flatten
from .tempering import _host

__all__ = [
    "Move",
    "EvalContext",
    "mh_accept",
    "mh_decide",
    "active_ndim",
    "leaf_axes",
    "merge_blobs",
    "overrides_host_api",
    "state_branch_supps",
    "stock_host_api",
]


class EvalContext(NamedTuple):
    """Capability bundle handed to every move.

    Attributes:
        compute_log_prior: ``(coords_dict, inds_dict) -> (ntemps, n)``.
        compute_log_like: ``(coords_dict, inds_dict, logp, branch_supps=None)
            -> (logl, blobs)``; ``logp`` guards evaluation outside the prior
            support, ``branch_supps`` (:func:`state_branch_supps`) are the
            walkers' branch supplementals, and ``blobs`` is None unless the
            likelihood returns some.
        tempering: :class:`~eryn_tpu_torch.moves.tempering.TemperatureControl`
            or None.
        prior_containers: ``{branch: ProbDistContainer}``.
    """

    compute_log_prior: Callable
    compute_log_like: Callable
    tempering: Optional[object]
    prior_containers: Optional[dict] = None


def mh_decide(u, factors, logP_new, logP_old):
    """Metropolis-Hastings decisions from the uniforms ``u``: accept where
    ``factors + logP_new - logP_old > log u``.  A NaN difference (e.g.
    ``-inf - -inf``) never accepts."""
    lnpdiff = factors + logP_new - logP_old
    return lnpdiff > torch.log(u)


def mh_accept(generator, factors, logP_new, logP_old):
    """:func:`mh_decide` on uniforms drawn from ``generator``."""
    u = torch.rand(
        logP_new.shape, generator=generator, dtype=logP_new.dtype,
        device=logP_new.device,
    )
    return mh_decide(u, factors, logP_new, logP_old)


def stock_host_api(fn):
    """Mark the package's own implementation of a host-protocol method
    (``get_proposal`` and the like): only a subclass's override of one
    makes a move a host move."""
    fn._stock_host_api = True
    return fn


def overrides_host_api(obj, name):
    """Whether the class of ``obj`` provides ``name`` other than through a
    :func:`stock_host_api` implementation."""
    fn = getattr(type(obj), name, None)
    return fn is not None and not getattr(fn, "_stock_host_api", False)


def state_branch_supps(state, perm=None, block=None):
    """The numeric entries of each branch supplemental, ``{branch: {name:
    tensor}}``, for the likelihood: walker-permuted by ``perm`` and cut to
    the block ``(off, ns)`` of the walker axis when given.  None when no
    branch carries a supplemental."""
    out = {}
    for name, supp in state.branches_supplemental.items():
        if supp is None:
            continue
        holder = supp.holder
        if perm is not None:
            holder = {k: v[:, perm] for k, v in holder.items()}
        if block is not None:
            off, ns = block
            holder = {k: v[:, off:off + ns] for k, v in holder.items()}
        out[name] = holder
    return out or None


def leaf_axes(tree, axes):
    """``axes`` once for every leaf of ``tree`` (for
    :meth:`Move.kernel_state_axes`)."""
    return [axes] * len(tree_flatten(tree)[0])


def merge_blobs(acc, new, old):
    """``old`` blobs with the walkers where ``acc`` (leading dims of the
    blobs) holds taking ``new``; None stays None."""
    if old is None or new is None:
        return old
    return torch.where(acc.reshape(acc.shape + (1,) * (old.ndim - acc.ndim)),
                       new, old)


def active_ndim(state, names=None):
    """Per-walker active dimensionality ``sum_b nleaves_b * ndim_b`` from the
    leaf masks: the dimension count of the detailed-balance factors."""
    names = names or list(state.branches)
    total = 0
    for name in names:
        b = state.branches[name]
        total = total + b.inds.sum(dim=-1) * b.ndim
    return total


class Move:
    """Base class for proposals.

    Subclasses implement ``_propose_impl(generator, state, ctx,
    kernel_state) -> (state, accepted, kernel_state)``; :meth:`propose_kernel`
    appends the tempering epilogue (swap cascade and ladder adaptation).
    ``periodic`` is a :class:`~eryn_tpu_torch.utils.PeriodicContainer` (or
    the dict one is built from) for the moves that honour periodic
    parameters; the sampler hands its own to a move that has none.
    """

    #: reversible-jump moves skip ladder adaptation
    adapt_temps = True
    is_rj = False
    #: a move written for Eryn's host protocol (see the module); its family
    #: (``_legacy_family``) picks the protocol
    host_move = False
    #: attributes holding device tensors the step adds to in place (what the
    #: data needed); the batched runner keeps them per group and sums them
    device_counters = ()
    #: the rank's :class:`~eryn_tpu_torch.parallel.mesh.MeshLayout` while
    #: the sampler runs a state sharded over a device mesh (the sampler sets
    #: it), else None: the state's tensors are then this rank's shard
    mesh_layout = None

    def mesh_ready(self):
        """None if this move runs on a state sharded over a device mesh,
        else what does not (the sampler raises at set-up).  A class runs
        sharded where it sets ``_mesh_sharded = True`` itself (every draw of
        its a :meth:`rank_draw`): a subclass, whose draws the package cannot
        vouch for, does not inherit it.  A host move runs sharded too: the
        sampler runs its protocol on the gathered state in every rank, from
        the same NumPy generator, and each rank keeps its rows."""
        if self.host_move or type(self).__dict__.get("_mesh_sharded"):
            return None
        return type(self).__name__

    def __init__(
        self,
        temperature_control=None,
        periodic=None,
        gibbs_sampling_setup=None,
        prevent_swaps=False,
        skip_supp_names_update=(),
        proposal_branch_names=None,
    ):
        self.temperature_control = temperature_control
        self.periodic = PeriodicContainer.coerce(periodic)
        self.prevent_swaps = prevent_swaps
        self.skip_supp_names_update = list(skip_supp_names_update)
        self.proposal_branch_names = proposal_branch_names
        self._initialize_branch_setup(gibbs_sampling_setup, is_rj=self.is_rj)
        if overrides_host_api(self, "propose"):
            # a propose of its own runs on the host, as the user wrote it
            self.host_move = True
            self._legacy_family = "custom-propose"
        # host counters and the kernel state, synced by the sampler after
        # each run
        self.accepted = None
        self.num_proposals = 0
        self.kernel_state = None

    @property
    def acceptance_fraction(self):
        if self.accepted is None or self.num_proposals == 0:
            return None
        return np.asarray(self.accepted) / self.num_proposals

    def run_branches(self, state):
        """Branch names this move proposes on (all by default)."""
        if self.proposal_branch_names is not None:
            names = self.proposal_branch_names
            if isinstance(names, str):
                names = [names]
            return [n for n in state.branches if n in names]
        return list(state.branches)

    def _initialize_branch_setup(self, gibbs_sampling_setup, is_rj=False):
        """Parse ``gibbs_sampling_setup`` into a list of Gibbs iterations,
        each ``[(branch_name, (nleaves_max, ndim) bool mask or None), ...]``.

        Accepted forms: a branch-name string, a ``(branch_name, mask)``
        tuple, a ``{branch_name: mask}`` dict (one iteration), or a list of
        those (sequential iterations)."""
        self._gibbs_masks = {}  # device: gibbs_iterations with masks there
        if gibbs_sampling_setup is None:
            self.gibbs_iterations = [None]
            return
        if type(gibbs_sampling_setup) not in (str, tuple, list, dict):
            raise ValueError(
                "gibbs_sampling_setup must be string, dict, tuple, or list."
            )
        if not isinstance(gibbs_sampling_setup, list):
            gibbs_sampling_setup = [gibbs_sampling_setup]

        def check_mask(mask):
            if mask is None:
                return None
            if is_rj:
                raise ValueError(
                    "inputting gibbs indexing at the leaf/parameter level is "
                    "not allowed with an RJ proposal. Only branch names."
                )
            mask = np.asarray(mask)
            if mask.ndim != 2:
                raise ValueError(
                    "When inputing gibbs indexing and using a 2-tuple, second "
                    "item must be None or 2D np.ndarray of shape "
                    "(nleaves_max, ndim)."
                )
            return torch.as_tensor(mask.astype(bool))

        iterations = []
        for item in gibbs_sampling_setup:
            if isinstance(item, str):
                iterations.append([(item, None)])
            elif isinstance(item, tuple):
                if len(item) != 2:
                    raise ValueError("Gibbs tuple must be (branch_name, mask).")
                iterations.append([(item[0], check_mask(item[1]))])
            elif isinstance(item, dict):
                iterations.append([(k, check_mask(v)) for k, v in item.items()])
            else:
                raise ValueError(
                    "If providing a list for gibbs_sampling_setup, each item "
                    "needs to be a string, tuple, or dict."
                )
        self.gibbs_iterations = iterations

    def gibbs_iterations_for(self, state):
        """Yield ``(branch_names, {name: mask_or_None})`` per Gibbs split,
        the masks on the state's device.  They are copied there once: a
        copy from the host in every step would make a captured step replay
        the mask it was captured with, or fail to capture."""
        all_names = self.run_branches(state)
        device = next(iter(state.branches.values())).coords.device
        on_device = self._gibbs_masks.get(device)
        if on_device is None:
            on_device = self._gibbs_masks[device] = [
                None if split is None else
                [(n, None if m is None else m.to(device)) for n, m in split]
                for split in self.gibbs_iterations
            ]
        for split in on_device:
            if split is None:
                yield all_names, {n: None for n in all_names}
            else:
                names = [n for n, _ in split if n in state.branches]
                yield names, {n: m for n, m in split}

    def init_kernel_state(self, state):
        """Per-move carry (e.g. tuned scales); empty for the stretch move."""
        return ()

    def kernel_state_axes(self, kernel_state):
        """Each leaf's ``(rung axis, walker axis)`` on a state sharded over
        a device mesh, in :func:`~eryn_tpu_torch.utils.pytree.tree_flatten`'s
        order: the axes along which the rank holds its block of the leaf,
        either None where every rank holds it whole along that mesh axis.
        A backend that stores the whole ensemble, or a chain continued on
        another placement, gathers and cuts the leaves along them.  Default:
        every leaf whole (a tuned scale, a step count)."""
        return leaf_axes(kernel_state, (None, None))

    def prepare_constants(self, state):
        """Build on the state's device the constants a step reads (the Gibbs
        masks, the periodic vectors), so that no step copies them from the
        host: such a copy waits for the device, and a captured step cannot
        hold it.  Moves call it from :meth:`init_kernel_state`."""
        for _ in self.gibbs_iterations_for(state):
            pass
        if self.periodic is not None:
            self.periodic.wrap(state.branches_coords)

    @staticmethod
    def draw_perm(generator, nwalkers, device):
        """A uniformly random permutation of the walker axis (the red/blue
        split), an int64 ``(nwalkers,)`` tensor."""
        return torch.argsort(
            torch.rand(nwalkers, generator=generator, device=device))

    #: under a mesh, while a red/blue block runs on this rank's walkers of
    #: it: ``(ns, at)``, the block's size and the positions of those walkers
    #: in it (:meth:`block_walkers`); None: the walkers are the shard's
    _walker_cols = None

    def wire_mesh(self, layout):
        """Hand the rank's :class:`~eryn_tpu_torch.parallel.mesh.MeshLayout`
        (None off a mesh) to this move; a composite hands it on to the moves
        it runs."""
        self.mesh_layout = layout

    @contextlib.contextmanager
    def block_walkers(self, ns, at):
        """Within it a ``per_walker`` :meth:`rank_draw` is one per walker of
        a red/blue block of ``ns`` walkers, of which this rank keeps those at
        the positions ``at`` (an int tensor): the draw a block's proposal
        makes on one process, kept for the rank's walkers of the block."""
        self._walker_cols = (ns, at)
        try:
            yield
        finally:
            self._walker_cols = None

    #: under a mesh, ``(t, t's version, t's value)`` of the last tuning
    #: clock :meth:`mesh_tuning` read or :meth:`advance_clock` made
    _host_clock = None

    def mesh_tuning(self, kernel_state):
        """Whether a proposal at ``kernel_state``'s clock ``t`` still tunes
        (``t < tune_steps``).  Under a mesh the sharded step plans on the
        host already, so the answer is a host bool, and past its tuning a
        move skips the exchanges of the statistics whose updates the device
        clock would discard.  The clock's value follows the tensor
        :meth:`advance_clock` made; a clock from elsewhere (the first
        proposal, a restored kernel state) is read once.  Without a mesh
        True: the step's ``torch.where`` on the device clock decides."""
        if self.mesh_layout is None:
            return True
        t = kernel_state["t"]
        seen = self._host_clock
        if seen is None or seen[0] is not t or seen[1] != t._version:
            seen = self._host_clock = (t, t._version, int(t))
        return seen[2] < self.tune_steps

    def advance_clock(self, kernel_state):
        """``kernel_state["t"] + 1``, its value noted for
        :meth:`mesh_tuning`."""
        t = kernel_state["t"]
        nxt = t + 1
        seen = self._host_clock
        if seen is not None and seen[0] is t and seen[1] == t._version:
            self._host_clock = (nxt, nxt._version, seen[2] + 1)
        return nxt

    def rank_draw(self, draw, shape, per_walker=False):
        """``draw(shape)``: a random array whose leading axis is the
        temperatures and, with ``per_walker``, whose second is the walkers
        of the state.  On a state sharded over a device mesh
        (:attr:`mesh_layout`) it is drawn at its global shape, every
        temperature (and with ``per_walker`` every walker), from the same
        generator as one process, and this rank's rows are kept: the sharded
        chain draws what one process draws.  Every draw of a move that runs
        sharded goes through here, but the walker permutation, which is
        whole already.  Without ``per_walker`` the second axis is taken as
        it is given (a red/blue block's walkers, the whole ensemble's under
        a mesh); with it inside :meth:`block_walkers` it is the block's."""
        shape = tuple(shape)
        lay = self.mesh_layout
        if lay is None:
            return draw(shape)
        rows = slice(lay.t0, lay.t0 + lay.nt)
        if not per_walker:
            return draw((lay.ntemps,) + shape[1:])[rows]
        if self._walker_cols is not None:
            ns, at = self._walker_cols
            return draw((lay.ntemps, ns) + shape[2:])[rows][:, at]
        x = draw((lay.ntemps, lay.nwalkers) + shape[2:])
        return x[rows, lay.w0:lay.w0 + lay.nw].contiguous()

    def rank_draw_rounds(self, draw, rounds, shape):
        """A per-walker :meth:`rank_draw` with a leading axis of ``rounds``
        (the iterations of a loop drawn up front): ``draw((rounds,) +
        shape)`` on one process, ``(rounds,) + shape`` here."""
        def moved(sh):  # (temps, walkers, rounds, ...)
            return torch.movedim(draw((sh[2],) + sh[:2] + sh[3:]), 0, 2)

        x = self.rank_draw(moved, tuple(shape[:2]) + (rounds,)
                           + tuple(shape[2:]), per_walker=True)
        return torch.movedim(x, 2, 0).contiguous()

    def rank_betas(self, state):
        """The inverse temperatures of the state's rows (ones without a
        ladder); under a device mesh, where the ladder is whole on every
        rank, this rank's temperatures' only."""
        logl = state.log_like
        if state.betas is None:
            return torch.ones(logl.shape[0], dtype=logl.dtype,
                              device=logl.device)
        lay = self.mesh_layout
        if lay is None:
            return state.betas
        return state.betas[lay.t0:lay.t0 + lay.nt]

    def all_walkers(self, x):
        """``x`` ``(nt, nw, ...)`` of the state's walkers over the whole
        ensemble: under a device mesh gathered from every rank, so that a
        set-up check on it decides alike on every rank."""
        lay = self.mesh_layout
        return x if lay is None else lay.gather(x)

    def draw_accept(self, generator, like, per_walker=False):
        """The uniforms of one Metropolis-Hastings decision, shaped like
        ``like`` (see :meth:`rank_draw` for ``per_walker``)."""
        return self.rank_draw(
            lambda shape: torch.rand(shape, generator=generator,
                                     dtype=like.dtype, device=like.device),
            like.shape, per_walker)

    def tune(self, state, accepted):
        """Adjust the move from its cumulative ``accepted`` counts; the
        sampler calls it under ``tune=True`` on the moves that override
        it.  On a CUDA device a change of the move's configuration also
        needs ``sampler.drop_step_graphs()``."""

    def setup(self, branches):
        """Per-proposal hook of the host protocol: a host move's family
        calls it with the host branches (or coordinates) first."""

    def _propose_impl(self, generator, state, ctx, kernel_state):
        raise NotImplementedError

    def update(self, old_state, new_state, accepted, subset=None):
        """``old_state`` with the accepted walkers of ``new_state`` merged
        in: coordinates, masks, log-likelihood, log-prior, blobs and the
        numeric supplemental entries (but ``skip_supp_names_update``), on
        the device and without a host read.

        ``accepted`` is ``(ntemps, nwalkers)``; ``subset``, when
        ``new_state`` covers only part of the walkers, is its ``(ntemps,
        ns)`` int walker indices into ``old_state``; either may be a NumPy
        array.  Returns a new state.
        """
        device = old_state.log_like.device
        accepted = torch.as_tensor(accepted, device=device).to(torch.bool)
        if subset is not None:
            subset = torch.as_tensor(subset, device=device).to(torch.int64)
            accepted = torch.gather(accepted, 1, subset)

        def merge(old, new):
            if old is None or new is None:
                return old
            if subset is None:
                return merge_blobs(accepted, new, old)
            idx = subset.reshape(subset.shape + (1,) * (old.ndim - 2))
            idx = idx.expand(subset.shape + old.shape[2:])
            cur = torch.gather(old, 1, idx)
            return old.scatter(1, idx, merge_blobs(accepted, new, cur))

        def merge_supp(old, new):
            if old is None or new is None:
                return old
            holder = dict(old.holder)
            for key, value in new.holder.items():
                if key in self.skip_supp_names_update or key not in holder:
                    continue
                holder[key] = merge(holder[key], value)
            return old.with_holder(holder)

        return old_state.replace(
            coords={n: merge(b.coords, new_state.branches[n].coords)
                    for n, b in old_state.branches.items()},
            inds={n: merge(b.inds, new_state.branches[n].inds)
                  for n, b in old_state.branches.items()},
            branch_supplemental={
                n: merge_supp(b.branch_supplemental,
                              new_state.branches[n].branch_supplemental)
                for n, b in old_state.branches.items()},
            log_like=merge(old_state.log_like, new_state.log_like),
            log_prior=merge(old_state.log_prior, new_state.log_prior),
            blobs=merge(old_state.blobs, new_state.blobs),
            supplemental=merge_supp(old_state.supplemental,
                                    new_state.supplemental),
        )

    def propose_kernel(self, generator, state, time, ctx, kernel_state=()):
        """Proposal plus tempering epilogue.

        Returns ``(state, accepted, swaps_accepted, time, kernel_state)``
        with ``accepted`` the ``(ntemps, nwalkers)`` accept flags in the state
        dtype and ``swaps_accepted`` shaped ``(ntemps - 1,)``.  ``time`` is
        the ladder adaptation clock, a 0-d int tensor on the state's device.
        """
        state, accepted, kernel_state = self._propose_impl(
            generator, state, ctx, kernel_state
        )
        logl = state.log_like
        ntemps = (logl.shape[0] if self.mesh_layout is None
                  else self.mesh_layout.ntemps)
        if ctx.tempering is not None and ntemps > 1 and not self.prevent_swaps:
            state, swaps_accepted, time = ctx.tempering.temper_kernel(
                generator, state, time, adapt=self.adapt_temps
            )
        else:
            swaps_accepted = logl.new_zeros((max(ntemps - 1, 0),))
        return state, accepted.to(logl.dtype), swaps_accepted, time, kernel_state

    # ------------------------------------------------------------------
    # Eryn's host protocol
    # ------------------------------------------------------------------
    @stock_host_api
    def propose(self, model, state):
        """One proposal with Eryn's entry point: ``model`` is the sampler's
        :class:`~eryn_tpu_torch.model.Model`.  A host move runs its
        family's host protocol (:func:`~eryn_tpu_torch.moves.legacy.
        host_propose`); any other move runs :meth:`propose_kernel` once,
        eagerly, on the model's generator at the control's clock (which it
        advances, with the ladder and the swap counts).  Counts the
        proposal on the move; returns ``(state, accepted)``, the flags a
        NumPy bool array."""
        if self.host_move:
            from .legacy import host_propose

            return host_propose(self, model, state)
        tc = model.temperature_control
        device = state.log_like.device
        time = torch.as_tensor(0 if tc is None else tc.time,
                               device=device).to(torch.int64)
        if self.kernel_state is None:
            self.kernel_state = self.init_kernel_state(state)
        state, accepted, swaps, time, self.kernel_state = self.propose_kernel(
            model.generator, state, time, model.get_eval_context(),
            self.kernel_state)
        if tc is not None:
            tc.time, tc.swaps_accepted = time, swaps
            if state.betas is not None:
                tc.betas = state.betas
        accepted = _host(accepted).astype(bool)
        self.accepted = (accepted.astype(float) if self.accepted is None
                         else np.asarray(self.accepted) + accepted)
        self.num_proposals += 1
        return state, accepted

    def gibbs_sampling_setup_iterator(self, all_branch_names):
        """Eryn's Gibbs splits: ``(branch_names_run, inds_run)`` per split,
        the masks NumPy arrays or None."""
        from .legacy import gibbs_iterator

        yield from gibbs_iterator(self, all_branch_names)

    def setup_proposals(self, branch_names_run, inds_run, branches_coords,
                        branches_inds):
        """Gibbs-aware proposal inputs on host arrays: ``(coords, inds,
        at_least_one_proposal)``."""
        from .legacy import setup_proposals

        return setup_proposals(branch_names_run, inds_run, branches_coords,
                               branches_inds)

    def cleanup_proposals_gibbs(self, branch_names_run, inds_run, q,
                                branches_coords, new_inds=None,
                                branches_inds=None, new_branch_supps=None,
                                branches_supplemental=None):
        """Restore the parameters this Gibbs split holds fixed and fill in
        the branches not proposed, in ``q``, ``new_inds`` and
        ``new_branch_supps`` (in place, on host arrays)."""
        import copy

        from .legacy import cleanup_proposals_gibbs

        cleanup_proposals_gibbs(branch_names_run, inds_run, q,
                                branches_coords)
        for key in branches_coords:
            if new_inds is not None and key not in new_inds:
                if branches_inds is None:
                    raise ValueError(
                        "new_inds given without branches_inds to fill in "
                        f"branch {key!r}.")
                new_inds[key] = np.array(_host(branches_inds[key]))
            if new_branch_supps is not None and key not in new_branch_supps:
                if branches_supplemental is None:
                    raise ValueError(
                        "new_branch_supps given without "
                        f"branches_supplemental to fill in branch {key!r}.")
                new_branch_supps[key] = copy.deepcopy(
                    branches_supplemental[key])

    def ensure_ordering(self, correct_key_order, q, new_inds,
                        new_branch_supps):
        """``q``, ``new_inds`` and ``new_branch_supps`` in the branch order
        ``correct_key_order`` (a missing branch supplemental is None)."""
        order = list(correct_key_order)
        q = {key: q[key] for key in order}
        new_inds = {key: new_inds[key] for key in order}
        if new_branch_supps is not None:
            new_branch_supps = {key: new_branch_supps.get(key)
                                for key in order}
        return q, new_inds, new_branch_supps

    def fix_logp_gibbs(self, branch_names_run, inds_run, logp, inds):
        """In place on a host ``logp``: a walker with no leaf in this split
        but leaves elsewhere gets ``-inf``, one without leaves anywhere 0."""
        from .legacy import fix_logp_gibbs

        fix_logp_gibbs(branch_names_run, inds_run, logp, inds)

    def compute_log_posterior_basic(self, logl, logp):
        """The untempered ``logl + logp``."""
        return logl + logp
