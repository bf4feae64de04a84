"""Red/blue half-ensemble proposal machinery.

Port of :mod:`eryn_tpu.moves.red_blue` (the general path).  One random
permutation splits the walker axis into ``nsplits`` contiguous blocks; each
block is proposed from its complement, evaluated and accepted in turn, and
each later block sees the earlier blocks' updated positions.

On a state sharded over a device mesh (:mod:`~eryn_tpu_torch.parallel.
mesh`) the stock red/blue moves (the group stretch, DE, DE-snooker, walk and
KDE: :meth:`~eryn_tpu_torch.moves.move.Move.mesh_ready`) take the sharded
form (:meth:`RedBlueMove._propose_impl_sharded`): the same draws at
their global shape, each block's complement gathered within the temperature
shard, and the likelihood on this rank's walkers.
"""

from __future__ import annotations

import numpy as np
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

__all__ = ["RedBlueMove"]


def _inverse_permutation(perm):
    # a sort, not a scatter: it never waits for the device
    return torch.argsort(perm, dim=-1)


class RedBlueMove(Move):
    """Base for ensemble proposals that move one subset using the complement.

    Subclasses implement ``get_proposal_kernel(generator, s_coords, c_coords,
    s_inds, param_masks) -> (q_dict, factors)`` with ``factors`` shaped
    ``(ntemps, Ns)``.  A subclass that sets ``_needs_c_inds`` also receives
    the complement's leaf masks as ``c_inds``.  A subclass that writes
    Eryn's host hook ``get_proposal(s_all, c_all, random, gibbs_ndim=None)
    -> (q, factors)`` on NumPy arrays is a host move
    (:mod:`~eryn_tpu_torch.moves.legacy`).
    """

    _needs_c_inds = False

    def __init__(self, nsplits=2, randomize_split=True, live_dangerously=False,
                 **kwargs):
        super().__init__(**kwargs)
        self.nsplits = int(nsplits)
        self.randomize_split = randomize_split
        self.live_dangerously = live_dangerously
        # a group move's get_proposal is of its own protocol: GroupMove
        # classifies it
        from .group import GroupMove

        if (overrides_host_api(self, "get_proposal")
                and not isinstance(self, GroupMove)):
            self.host_move = True
            self._legacy_family = "redblue"

    def setup(self, branches):
        """Per-proposal setup hook."""

    @stock_host_api
    def get_proposal(self, s_all, c_all, random, gibbs_ndim=None):
        """Eryn's host hook, abstract: a subclass that writes it runs on
        the host."""
        raise NotImplementedError(
            "RedBlueMove subclasses implement get_proposal (host protocol) "
            "or get_proposal_kernel.")

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None):
        raise NotImplementedError

    def get_proposal_block(self, generator, coords_p, inds_p, off, ns, names,
                           param_masks):
        """The proposal of block ``[off, off + ns)`` of the permuted ensemble
        (``coords_p``, ``inds_p``: every branch, ``(ntemps, nwalkers, ...)``)
        for the branches ``names``: gathers the complement, the rows before
        and after the block, and calls :meth:`get_proposal_kernel`.  A move
        that can read the complement where it lies overrides this."""
        blk = slice(off, off + ns)

        def comp(x):
            return torch.cat([x[:, :off], x[:, off + ns:]], dim=1)

        kwargs = {}
        if self._needs_c_inds:
            kwargs["c_inds"] = {n: comp(inds_p[n]) for n in names}
        return self.get_proposal_kernel(
            generator, {n: coords_p[n][:, blk] for n in names},
            {n: comp(coords_p[n]) for n in names},
            {n: inds_p[n][:, blk] for n in names}, param_masks, **kwargs
        )

    def _splits(self, nwalkers):
        """The blocks' sizes and offsets along the permuted walker axis."""
        sizes = [
            nwalkers // self.nsplits + (1 if i < nwalkers % self.nsplits else 0)
            for i in range(self.nsplits)
        ]
        return sizes, [sum(sizes[:i]) for i in range(self.nsplits)]

    def _check_walkers(self, state, names):
        nwalkers = (state.log_like.shape[1] if self.mesh_layout is None
                    else self.mesh_layout.nwalkers)
        total_ndim = sum(
            state.branches[n].nleaves_max * state.branches[n].ndim
            for n in names
        )
        if nwalkers < 2 * total_ndim and not self.live_dangerously:
            raise RuntimeError(
                "It is unadvisable to use a red-blue move with fewer walkers "
                "than twice the number of dimensions. (set live_dangerously "
                "to override)"
            )

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        if self.mesh_layout is not None:
            new_state, accepted = self._propose_impl_sharded(generator, state,
                                                             ctx)
            return new_state, accepted, kernel_state
        ntemps, nwalkers = state.log_like.shape
        device = state.log_like.device
        self._check_walkers(state, self.run_branches(state))
        self.setup(state.branches)

        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        betas = state.betas
        if betas is None:
            betas = torch.ones(ntemps, dtype=logl.dtype, device=device)
        accepted = torch.zeros((ntemps, nwalkers), dtype=torch.bool,
                               device=device)

        sizes, offsets = self._splits(nwalkers)

        all_names = list(coords)
        for names, param_masks in self.gibbs_iterations_for(state):
            if self.randomize_split:
                perm = self.draw_perm(generator, nwalkers, device)
                inv_perm = _inverse_permutation(perm)
            else:
                perm = inv_perm = torch.arange(nwalkers, device=device)

            coords_p = {n: coords[n][:, perm] for n in all_names}
            inds_p = {n: inds[n][:, perm] for n in all_names}
            logl_p = logl[:, perm]
            logp_p = logp[:, perm]
            blobs_p = None if blobs is None else blobs[:, perm]
            acc_p = accepted[:, perm]

            for off, ns in zip(offsets, sizes):
                blk = slice(off, off + ns)
                s_coords = {n: coords_p[n][:, blk] for n in names}
                q, factors = self.get_proposal_block(
                    generator, coords_p, inds_p, off, ns, names, param_masks
                )
                # Gibbs parameter masking: non-selected entries keep old values
                for n in names:
                    mask = param_masks.get(n)
                    if mask is not None:
                        q[n] = torch.where(mask, q[n], s_coords[n])

                q_eval = {
                    n: q[n] if n in q else coords_p[n][:, blk] for n in all_names
                }
                inds_eval = {n: inds_p[n][:, blk] for n in all_names}
                logp_new = ctx.compute_log_prior(q_eval, inds_eval)
                # the block's walkers' supplementals, which the move leaves
                # as they are
                logl_new, blobs_new = ctx.compute_log_like(
                    q_eval, inds_eval, logp_new,
                    state_branch_supps(state, perm=perm, block=(off, ns)))

                prev_logl = logl_p[:, blk]
                prev_logp = logp_p[:, blk]
                logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
                logP_old = (tempered_log_likelihood(prev_logl, betas)
                            + prev_logp)
                acc = mh_decide(self.draw_accept(generator, logP_new), factors,
                                logP_new, logP_old)

                acc4 = acc[:, :, None, None]
                for n in names:
                    coords_p[n][:, blk] = torch.where(acc4, q[n], s_coords[n])
                logl_p[:, blk] = torch.where(acc, logl_new, prev_logl)
                logp_p[:, blk] = torch.where(acc, logp_new, prev_logp)
                if blobs_p is not None:
                    blobs_p[:, blk] = merge_blobs(acc, blobs_new,
                                                  blobs_p[:, blk])
                # a walker accepted in any Gibbs iteration counts as accepted
                acc_p[:, blk] = acc | acc_p[:, blk]

            coords = {n: coords_p[n][:, inv_perm] for n in all_names}
            logl = logl_p[:, inv_perm]
            logp = logp_p[:, inv_perm]
            if blobs_p is not None:
                blobs = blobs_p[:, inv_perm]
            accepted = acc_p[:, inv_perm]

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp,
            blobs=blobs,
        )
        return new_state, accepted, kernel_state

    def _propose_impl_sharded(self, generator, state, ctx):
        """One proposal on this rank's shard of a state sharded over a
        ``(temp, walker)`` mesh (``self.mesh_layout``), equal to one
        process's proposal on the whole ensemble.

        The proposal runs on walker-order views ``(nt, nwalkers, ...)`` of
        the rank's temperatures: its own walkers in place, and before each
        block the rows the block's complement needs from the other walker
        shards (:meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.fill_rows`,
        every branch's coordinates and masks in one exchange): before the
        first block of a split every other block's rows, before a later
        block the rows that the block before it merged.
        :meth:`get_proposal_block` proposes the whole block on the permuted
        view as one process does (its draws at every temperature, each
        kept for the rank's), the prior and the likelihood run on the
        rank's walkers of the block only (zeros for the other ranks'), and
        the decision takes the block's draw.  The other ranks' rows of the
        view are discarded.  Returns ``(state, accepted)`` for the
        shard."""
        lay = self.mesh_layout
        nt, nw, w0, NW = lay.nt, lay.nw, lay.w0, lay.nwalkers
        device = state.log_like.device
        self._check_walkers(state, self.run_branches(state))
        self.setup(state.branches)
        all_names = list(state.branches)

        view, own = lay.walker_view, lay.own
        coords = {n: view(c) for n, c in state.branches_coords.items()}
        inds = {n: view(m) for n, m in state.branches_inds.items()}
        logl, logp = view(state.log_like), view(state.log_prior)
        betas = self.rank_betas(state)
        accepted = torch.zeros((nt, NW), dtype=torch.bool, device=device)
        # the exchanged leaves, written in place below
        leaves = [coords[n] for n in all_names] + [inds[n] for n in all_names]
        sizes, offsets = self._splits(NW)

        for names, param_masks in self.gibbs_iterations_for(state):
            if self.randomize_split:
                perm = self.draw_perm(generator, NW, device)
            else:
                perm = torch.arange(NW, device=device)
            # the exchange plans are the permutation's: one host read
            order = perm.cpu().numpy()
            blocks = [order[off:off + ns] for off, ns in zip(offsets, sizes)]
            for k, (off, ns) in enumerate(zip(offsets, sizes)):
                fill = np.concatenate(blocks[1:]) if k == 0 else blocks[k - 1]
                lay.fill_rows(leaves, [own(x) for x in leaves], fill)
                coords_p = {n: coords[n][:, perm] for n in all_names}
                inds_p = {n: inds[n][:, perm] for n in all_names}
                blk = slice(off, off + ns)
                s_coords = {n: coords_p[n][:, blk] for n in names}
                q, factors = self.get_proposal_block(
                    generator, coords_p, inds_p, off, ns, names, param_masks
                )
                for n in names:
                    mask = param_masks.get(n)
                    if mask is not None:
                        q[n] = torch.where(mask, q[n], s_coords[n])

                w = blocks[k]
                idx = torch.as_tensor(w, device=device)
                prev_logl, prev_logp = logl[:, idx], logp[:, idx]
                logl_new = torch.zeros_like(prev_logl)
                logp_new = torch.zeros_like(prev_logp)
                mine = np.flatnonzero((w >= w0) & (w < w0 + nw))
                if mine.size:
                    at = torch.as_tensor(mine, device=device)
                    q_eval = {
                        n: (q[n] if n in q else coords_p[n][:, blk])[:, at]
                        for n in all_names
                    }
                    inds_eval = {n: inds_p[n][:, blk][:, at]
                                 for n in all_names}
                    lp = ctx.compute_log_prior(q_eval, inds_eval)
                    # blobs and supplementals do not run sharded
                    ll, _ = ctx.compute_log_like(q_eval, inds_eval, lp)
                    logl_new[:, at] = ll
                    logp_new[:, at] = lp

                logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
                logP_old = (tempered_log_likelihood(prev_logl, betas)
                            + prev_logp)
                acc = mh_decide(self.draw_accept(generator, logP_new), factors,
                                logP_new, logP_old)
                acc4 = acc[:, :, None, None]
                for n in names:
                    coords[n][:, idx] = torch.where(acc4, q[n], s_coords[n])
                logl[:, idx] = torch.where(acc, logl_new, prev_logl)
                logp[:, idx] = torch.where(acc, logp_new, prev_logp)
                accepted[:, idx] = acc | accepted[:, idx]

        new_state = state.replace(
            coords={n: own(c) for n, c in coords.items()},
            inds=state.branches_inds, log_like=own(logl), log_prior=own(logp),
        )
        return new_state, own(accepted)
