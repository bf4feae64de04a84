"""Whole-ensemble Metropolis-Hastings skeleton.

Port of :mod:`eryn_tpu.moves.mh`: the proposal, prior, likelihood and
accept/merge act on the full ``(ntemps, nwalkers)`` block at once, one
Gibbs split after another.

Every walker's decision is its own: on a state sharded over a device mesh
a move that declares itself sharded runs on this rank's walkers as they
are, each draw at its global shape
(:meth:`~eryn_tpu_torch.moves.move.Move.rank_draw` with ``per_walker``),
and exchanges nothing.  A subclass that writes only the proposal (Eryn's
extension point) runs the proposal on the gathered coordinates in every
rank, keeps its rows, and evaluates the prior and the likelihood on them
alone (:meth:`~eryn_tpu_torch.moves.move.Move.mesh_route`).
"""

from __future__ import annotations

import torch

from .move import (
    Move,
    merge_blobs,
    mh_decide,
    overrides_host_api,
    state_branch_supps,
    stock_host_api,
)
from .tempering import tempered_log_likelihood

__all__ = ["MHMove"]


class MHMove(Move):
    """Base for moves proposing updates for all walkers at once.

    Subclasses implement ``get_proposal_kernel(generator, branch_coords,
    branch_inds, kernel_state, param_masks=None) -> (q_dict, factors,
    kernel_state)`` with ``factors`` shaped ``(ntemps, nwalkers)``;
    ``param_masks`` (``{name: (nleaves_max, ndim) bool or None}``) is the
    Gibbs parameter selection, which an asymmetric proposal must apply
    before it computes its factors.  The base class applies the mask once
    more afterwards (exact only for symmetric proposals).  A subclass that
    writes Eryn's host hook ``get_proposal(branches_coords, random,
    branches_inds=None, **kwargs) -> (q, factors)`` on NumPy arrays is a
    host move (:mod:`~eryn_tpu_torch.moves.legacy`).

    On a state sharded over a device mesh a subclass that writes only
    ``get_proposal_kernel`` (and perhaps ``init_kernel_state``) takes the
    ``"gathered proposal"`` route: in every rank ``get_proposal_kernel``
    runs on the gathered coordinates and masks of each Gibbs split with the
    shared generator, as one process runs it, and the rank keeps its rows
    of ``q`` and ``factors``; the prior, the likelihood and the accept draw
    are the rank's rows only.  A subclass that also sets ``_mesh_sharded =
    True`` and draws through ``rank_draw(..., per_walker=True)`` runs its
    proposal on the shard and exchanges nothing; one that overrides
    ``_propose_impl`` or ``propose_kernel`` runs whole in every rank
    (``"gathered"``).
    """

    _mesh_sharded = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if overrides_host_api(self, "get_proposal"):
            self.host_move = True
            self._legacy_family = "mh"

    @stock_host_api
    def get_proposal(self, branches_coords, random, branches_inds=None,
                     **kwargs):
        """Eryn's host hook, abstract: a subclass that writes it runs on
        the host."""
        raise NotImplementedError(
            "MHMove subclasses implement get_proposal (host protocol) or "
            "get_proposal_kernel.")

    def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                            kernel_state, param_masks=None):
        raise NotImplementedError

    def mesh_route(self):
        route = super().mesh_route()
        if (route == "gathered"
                and type(self)._propose_impl is MHMove._propose_impl
                and type(self).propose_kernel is Move.propose_kernel):
            return "gathered proposal"
        return route

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        lay = self.mesh_layout
        if lay is not None and self.mesh_route() == "gathered proposal":
            whole_inds = {}
            kernel_state = self.place_kernel_state(kernel_state, lay, None)
        else:
            lay = None
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

        for names, param_masks in self.gibbs_iterations_for(state):
            if lay is None:
                q, factors, kernel_state = self.get_proposal_kernel(
                    generator, {n: coords[n] for n in names},
                    {n: inds[n] for n in names}, kernel_state,
                    param_masks=param_masks,
                )
            else:
                # the whole ensemble's proposal, as one process draws it
                for n in names:
                    if n not in whole_inds:
                        whole_inds[n] = lay.gather(inds[n])
                whole = {n: lay.gather(coords[n]) for n in names}
                with self.unwired():
                    q, factors, kernel_state = self.get_proposal_kernel(
                        generator, whole, {n: whole_inds[n] for n in names},
                        kernel_state, param_masks=param_masks)
                q = {n: lay.local(x).contiguous() for n, x in q.items()}
                factors = lay.local(factors).contiguous()
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
        if lay is not None:
            kernel_state = self.place_kernel_state(kernel_state, None, lay)
        return new_state, accepted, kernel_state
