"""Reversible-jump (trans-dimensional) moves.

Port of :mod:`eryn_tpu.moves.rj`, the traced protocol only: births and
deaths flip the static-shape leaf masks, the affected slot is a masked
argmax over random keys, and the detailed-balance corrections at the edges
of the leaf-count range are ``where`` masks.  A subclass that writes Eryn's
host protocol (``get_proposal`` / ``get_model_change_proposal`` on NumPy
arrays) is a host move (:mod:`~eryn_tpu_torch.moves.legacy`).

Births and deaths are per walker: on a state sharded over a device mesh the
move runs on this rank's walkers as they are, with every draw at its global
shape (:meth:`~eryn_tpu_torch.moves.move.Move.rank_draw`), and exchanges
nothing.
"""

from __future__ import annotations

import math

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

__all__ = ["ReversibleJumpMove", "rj_change_kernel"]


def rj_change_kernel(u_change, slot_keys, inds, nleaves_min, nleaves_max,
                     fix_change=None):
    """Propose a +-1 leaf-count change per walker and pick its slot.

    Args:
        u_change: ``(nt, nw)`` uniforms; below 0.5 proposes a birth.
        slot_keys: ``(nt, nw, nleaves_max)`` i.i.d. continuous keys; the
            slot is the argmax over the inactive leaves (birth) or the
            active ones (death), a uniform choice.  The JAX package's
            Gumbel keys are a monotone map of uniforms, so both pick the
            same slot from the same uniforms.
        inds: ``(nt, nw, nleaves_max)`` bool leaf masks.
        nleaves_min, nleaves_max: the leaf-count range; a walker at an edge
            always moves inward, and a fixed range proposes no change.
        fix_change: +1 or -1 forces births or deaths.

    Returns:
        ``(change (nt, nw) int in {-1, 0, 1}, slot (nt, nw) int64,
        new_inds)``.
    """
    nleaves = inds.sum(dim=-1)
    if fix_change is None:
        change = torch.where(u_change < 0.5, 1, -1)
    else:
        change = torch.full_like(nleaves, int(fix_change))
    change = torch.where(nleaves == nleaves_min, 1, change)
    change = torch.where(nleaves == nleaves_max, -1, change)
    if nleaves_min == nleaves_max:
        change = torch.zeros_like(change)

    birth_slot = torch.argmax(torch.where(inds, -math.inf, slot_keys), dim=-1)
    death_slot = torch.argmax(torch.where(inds, slot_keys, -math.inf), dim=-1)
    slot = torch.where(change == 1, birth_slot, death_slot)

    slot_mask = (
        torch.arange(inds.shape[-1], device=inds.device) == slot[..., None]
    )
    new_inds = torch.where(
        (change == 1)[..., None],
        inds | slot_mask,
        torch.where((change == -1)[..., None], inds & ~slot_mask, inds),
    )
    return change, slot, new_inds


class ReversibleJumpMove(Move):
    """Base for trans-dimensional moves.

    Subclasses implement ``get_proposal_kernel(generator, name, coords,
    inds) -> (q_coords, new_inds, factors)`` for one branch.  Branches are
    updated one after another within a proposal; the swap cascade runs
    afterwards without ladder adaptation.
    """

    adapt_temps = False
    is_rj = True

    def __init__(self, nleaves_max=None, nleaves_min=None, fix_change=None,
                 dr_max_iter=5, **kwargs):
        super().__init__(**kwargs)
        # Eryn's cap on delayed-rejection stages: accepted, as eryn_tpu's
        # move takes it, and ignored (no move runs delayed rejection)
        self.dr_max_iter = int(dr_max_iter)
        if (overrides_host_api(self, "get_proposal")
                or overrides_host_api(self, "get_model_change_proposal")):
            self.host_move = True
            self._legacy_family = "rj"
        self.nleaves_max = dict(nleaves_max) if nleaves_max else {}
        self.nleaves_min = dict(nleaves_min) if nleaves_min else {}
        if fix_change not in (None, 1, -1):
            raise ValueError("fix_change must be None, +1, or -1.")
        self.fix_change = fix_change

    @stock_host_api
    def get_proposal(self, all_coords, all_inds, nleaves_min_all,
                     nleaves_max_all, random, **kwargs):
        """Eryn's host hook, abstract: ``(q, new_inds, factors)``."""
        raise NotImplementedError(
            "ReversibleJumpMove subclasses implement get_proposal (host "
            "protocol) or get_proposal_kernel.")

    @stock_host_api
    def get_model_change_proposal(self, inds, random, nleaves_min,
                                  nleaves_max):
        """Eryn's host hook, abstract: the birth and death slots."""
        raise NotImplementedError

    def get_proposal_kernel(self, generator, name, coords, inds):
        raise NotImplementedError

    def _edge_factors(self, name, old_nleaves, new_nleaves, dtype):
        """Proposal-asymmetry corrections at the edges of the leaf-count
        range: a walker at an edge proposes its one possible change with
        probability 1 instead of 1/2."""
        nmin = self.nleaves_min[name]
        nmax = self.nleaves_max[name]
        if nmin > nmax:
            raise ValueError("nleaves_min cannot be greater than nleaves_max.")
        zero = torch.zeros(old_nleaves.shape, dtype=dtype,
                           device=old_nleaves.device)
        if nmin == nmax or nmin + 1 == nmax:
            return zero
        def at(nleaves, edge):
            return torch.where(nleaves == edge, math.log(0.5), zero)

        return (at(old_nleaves, nmin) + at(old_nleaves, nmax)
                - at(new_nleaves, nmin) - at(new_nleaves, nmax))

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        # branch-level Gibbs splits only
        names = []
        for split_names, _masks in self.gibbs_iterations_for(state):
            names.extend(n for n in split_names if n not in names)
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        supps = state_branch_supps(state)
        ntemps, nwalkers = logl.shape
        betas = self.rank_betas(state)
        accepted = torch.zeros((ntemps, nwalkers), dtype=logl.dtype,
                               device=logl.device)

        for name in names:
            q_branch, new_inds_branch, factors = self.get_proposal_kernel(
                generator, name, coords[name], inds[name]
            )
            old_nleaves = inds[name].sum(dim=-1)
            new_nleaves = new_inds_branch.sum(dim=-1)
            factors = factors + self._edge_factors(
                name, old_nleaves, new_nleaves, logl.dtype
            )

            q_full = {**coords, name: q_branch}
            inds_full = {**inds, name: new_inds_branch}
            logp_new = ctx.compute_log_prior(q_full, inds_full)
            logl_new, blobs_new = ctx.compute_log_like(q_full, inds_full,
                                                       logp_new, supps)

            logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
            logP_old = tempered_log_likelihood(logl, betas) + logp
            acc = mh_decide(
                self.draw_accept(generator, logP_new, per_walker=True),
                factors, logP_new, logP_old)
            # an identity proposal (no change of leaf count or coordinates)
            # is not counted as accepted; NaN dormant slots equal themselves
            entry_changed = (q_branch != coords[name]) & ~(
                torch.isnan(q_branch) & torch.isnan(coords[name])
            )
            coords_changed = entry_changed.any(dim=-1).any(dim=-1)
            acc = acc & ((new_nleaves != old_nleaves) | coords_changed)

            coords[name] = torch.where(acc[:, :, None, None], q_branch,
                                       coords[name])
            inds[name] = torch.where(acc[:, :, None], new_inds_branch,
                                     inds[name])
            logl = torch.where(acc, logl_new, logl)
            logp = torch.where(acc, logp_new, logp)
            blobs = merge_blobs(acc, blobs_new, blobs)
            accepted = accepted + acc

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp,
            blobs=blobs,
        )
        return new_state, accepted, kernel_state
