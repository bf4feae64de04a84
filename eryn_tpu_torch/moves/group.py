"""Group proposals: ensemble moves against a stationary complement.

Port of :mod:`eryn_tpu.moves.group`.  The stationary "friends" group is
refreshed every ``n_iter_update`` proposals from the pre-proposal state;
it lives in the move's kernel state with the proposal counter and the
window's snapshot of the ensemble, and the refresh is a ``where`` blend on
the counter, so a captured step refreshes at the replays where it is due.
All walkers update at once, which makes the move usable under reversible
jump.

On a state sharded over a device mesh the table is built from every walker
of the rank's temperatures, gathered over the walker axis at each refresh
(a host phase, "refresh due" or not, decides which steps gather, and the
device counter, blended as above, what a refresh keeps), and the proposal
runs on the rank's walkers with every draw at its global shape.
"""

from __future__ import annotations

import torch

from ..utils.pytree import tree_flatten, tree_unflatten
from .move import (
    Move,
    leaf_axes,
    merge_blobs,
    mh_decide,
    state_branch_supps,
    stock_host_api,
)
from .tempering import tempered_log_likelihood

__all__ = ["GroupMove"]


def _blend(refresh, fresh, old):
    """``fresh`` where ``refresh`` (a 0-d bool tensor), else ``old``, leaf
    by leaf over two trees of one structure."""
    new_leaves, spec = tree_flatten(fresh)
    old_leaves, _ = tree_flatten(old)
    return tree_unflatten(spec, [torch.where(refresh, a, b)
                                 for a, b in zip(new_leaves, old_leaves)])


def _clone(tree):
    leaves, spec = tree_flatten(tree)
    return tree_unflatten(spec, [x.clone() for x in leaves])


class GroupMove(Move):
    """Base class for stationary-complement moves.

    Subclasses implement:

    * ``setup_friends_kernel(branches_coords, branches_inds) -> tree`` of
      tensors: the stationary friends table;
    * ``find_friends_kernel(generator, name, s_coords, s_inds, friends) ->
      c_coords``: each walker's complement point from the table;
    * ``group_proposal_kernel(generator, s_coords, s_inds, friends,
      param_masks) -> (q, factors)``.

    Args:
        nfriends: friends kept per walker (default: every walker).
        n_iter_update: refresh period of the stationary group (at least 2
            unless ``live_dangerously``).

    A subclass that writes Eryn's host hooks ``setup_friends(branches)``
    or ``find_friends(name, s, s_inds=None, branch_supps=None)`` (and
    optionally ``fix_friends``) on NumPy arrays is a host move
    (:mod:`~eryn_tpu_torch.moves.legacy`).
    """

    def __init__(self, nfriends=None, n_iter_update=100,
                 live_dangerously=False, **kwargs):
        super().__init__(**kwargs)
        cls = type(self)
        if (cls.setup_friends is not GroupMove.setup_friends
                or cls.find_friends is not GroupMove.find_friends):
            self.host_move = True
            self._legacy_family = "group"
            self.iter = 0
        self.nfriends = nfriends
        self.n_iter_update = int(n_iter_update)
        if self.n_iter_update <= 1 and not live_dangerously:
            raise ValueError("n_iter_update must be greater than or equal to 2.")

    # -- Eryn's host hooks ------------------------------------------------
    def setup_friends(self, branches):
        """Host hook: the friends bookkeeping from the host branches."""
        raise NotImplementedError

    def find_friends(self, name, s, s_inds=None, branch_supps=None):
        """Host hook: the complement point of each point of ``s``."""
        raise NotImplementedError

    def fix_friends(self, branches):
        """Host hook: repair the friends of leaves born through reversible
        jump (optional)."""

    def choose_c_vals(self, name, s, s_inds=None, branch_supps=None):
        """Eryn's complement of the points ``s``: :meth:`find_friends`'s."""
        return self.find_friends(name, s, s_inds=s_inds,
                                 branch_supps=branch_supps)

    @stock_host_api
    def get_proposal(self, s_all, random, gibbs_ndim=None, s_inds_all=None,
                     **kwargs):
        """Eryn's host hook, abstract (``GroupStretchMove`` has one)."""
        raise NotImplementedError(
            "GroupMove subclasses implement get_proposal (host protocol) or "
            "group_proposal_kernel.")

    # -- the traced protocol ----------------------------------------------
    def setup_friends_kernel(self, branches_coords, branches_inds):
        raise NotImplementedError

    def find_friends_kernel(self, generator, name, s_coords, s_inds, friends):
        raise NotImplementedError

    def fix_friends_kernel(self, friends, branches_coords, branches_inds):
        """Repair friends for leaves born through reversible jump; the
        default keeps them.  ``branches_coords`` and ``branches_inds`` are
        the window's snapshot (the ensemble at the last refresh), not the
        live state: a repair from walkers that move in the same step would
        bring back the dependence the stationary table removes."""
        return friends

    def group_proposal_kernel(self, generator, s_coords, s_inds, friends,
                              param_masks):
        raise NotImplementedError

    def _walker_views(self, coords, inds):
        """``coords`` and ``inds`` over every walker of the state's
        temperatures: on a state sharded over a device mesh each walker
        shard's rows gathered within the temperature shard (one exchange,
        :meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.gather_walkers`),
        else the trees as they are."""
        lay = self.mesh_layout
        if lay is None:
            return coords, inds
        names = list(coords)
        views = lay.gather_walkers([coords[n] for n in names]
                                   + [inds[n] for n in names])
        k = len(names)
        return dict(zip(names, views[:k])), dict(zip(names, views[k:]))

    #: the proposal counter, whose host phase is whether a refresh is due
    clock_key = "iter"

    def phase_of(self, clock):
        """Under a mesh: whether the stationary group is refreshed at a
        step at the counter's value (a due refresh gathers)."""
        return clock % self.n_iter_update == 0

    def init_kernel_state(self, state):
        self.prepare_constants(state)
        coords, inds = self._walker_views(state.branches_coords,
                                          state.branches_inds)
        # copies: a captured step writes the kernel state in place
        return {
            "iter": torch.zeros((), dtype=torch.int32,
                                device=state.log_like.device),
            "friends": _clone(self.setup_friends_kernel(coords, inds)),
            "snap_coords": _clone(coords),
            "snap_inds": _clone(inds),
        }

    def kernel_state_axes(self, kernel_state):
        # the friends and the snapshot: the rank's rungs, all their walkers
        return [ax for k in sorted(kernel_state) for ax in leaf_axes(
            kernel_state[k], (None, None) if k == "iter" else (0, None))]

    def _propose_impl(self, generator, state, ctx, kernel_state):
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        supps = state_branch_supps(state)
        ntemps, nwalkers = logl.shape
        betas = self.rank_betas(state)
        accepted = torch.zeros((ntemps, nwalkers), dtype=torch.bool,
                               device=logl.device)

        it = kernel_state["iter"]
        # the stationary group and its snapshot are refreshed from the
        # pre-proposal state at window boundaries, decided on the device
        # clock; under a mesh only a step whose host phase says a refresh
        # is due gathers the temperatures' walkers for it
        if self.mesh_layout is None or self.mesh_phase(kernel_state):
            refresh = (it % self.n_iter_update) == 0
            views = self._walker_views(coords, inds)
            friends = _blend(refresh, self.setup_friends_kernel(*views),
                             kernel_state["friends"])
            snap_coords = _blend(refresh, views[0],
                                 kernel_state["snap_coords"])
            snap_inds = _blend(refresh, views[1], kernel_state["snap_inds"])
        else:
            friends = kernel_state["friends"]
            snap_coords = kernel_state["snap_coords"]
            snap_inds = kernel_state["snap_inds"]
        friends = self.fix_friends_kernel(friends, snap_coords, snap_inds)

        for names, param_masks in self.gibbs_iterations_for(state):
            q, factors = self.group_proposal_kernel(
                generator, {n: coords[n] for n in names},
                {n: inds[n] for n in names}, friends, param_masks,
            )
            for n in names:
                mask = param_masks.get(n)
                if mask is not None:
                    q[n] = torch.where(mask, q[n], coords[n])

            q_full = {**coords, **q}
            logp_new = ctx.compute_log_prior(q_full, inds)
            logl_new, blobs_new = ctx.compute_log_like(q_full, inds, logp_new,
                                                       supps)

            logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
            logP_old = tempered_log_likelihood(logl, betas) + logp
            acc = mh_decide(
                self.draw_accept(generator, logP_new, per_walker=True),
                factors, logP_new, logP_old)

            acc4 = acc[:, :, None, None]
            for n in names:
                coords[n] = torch.where(acc4, q_full[n], coords[n])
            logl = torch.where(acc, logl_new, logl)
            logp = torch.where(acc, logp_new, logp)
            blobs = merge_blobs(acc, blobs_new, blobs)
            accepted = accepted | acc

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp,
            blobs=blobs,
        )
        new_kernel_state = {
            "iter": it + 1,
            "friends": friends,
            "snap_coords": snap_coords,
            "snap_inds": snap_inds,
        }
        return new_state, accepted, new_kernel_state
