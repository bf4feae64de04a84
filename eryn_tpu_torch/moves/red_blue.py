"""Red/blue half-ensemble proposal machinery.

Port of :mod:`eryn_tpu.moves.red_blue` (the general path).  One random
permutation splits the walker axis into ``nsplits`` contiguous blocks; each
block is proposed from its complement, evaluated and accepted in turn, and
each later block sees the earlier blocks' updated positions.

On a state sharded over a device mesh (:mod:`~eryn_tpu_torch.parallel.
mesh`) the stock red/blue moves (the stretch's general path, the group
stretch, DE, DE-snooker, walk and KDE:
:meth:`~eryn_tpu_torch.moves.move.Move.mesh_ready`) take the sharded form
(:meth:`RedBlueMove._propose_impl_sharded`): the same draws at their global
shape, each block's complement gathered within the temperature shard, and
the likelihood on this rank's walkers, with their branch supplementals,
their blobs merged where they lie.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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

__all__ = ["RedBlueMove", "WalkerBlocks"]


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

        The proposal runs on the walker-order views of :class:`WalkerBlocks`
        (the rank's temperatures, every walker's rows that a block's
        complement needs filled in before the block).
        :meth:`get_proposal_block` proposes the whole block on the permuted
        view as one process does (its draws at every temperature, each
        kept for the rank's), the prior and the likelihood run on the
        rank's walkers of the block only (zeros for the other ranks'), and
        the decision takes the block's draw.  The other ranks' rows of the
        view are discarded.  Returns ``(state, accepted)`` for the
        shard."""
        self._check_walkers(state, self.run_branches(state))
        self.setup(state.branches)
        all_names = list(state.branches)
        view = WalkerBlocks(self.mesh_layout, state)
        coords, logl, logp = view.coords, view.log_like, view.log_prior
        betas = self.rank_betas(state)
        NW = self.mesh_layout.nwalkers
        device = state.log_like.device
        sizes, offsets = self._splits(NW)

        for names, param_masks in self.gibbs_iterations_for(state):
            perm = (self.draw_perm(generator, NW, device)
                    if self.randomize_split
                    else torch.arange(NW, device=device))
            for blk in view.blocks(perm, sizes, offsets):
                coords_p, inds_p = blk.coords_p, blk.inds_p
                block = slice(blk.off, blk.off + blk.ns)
                s_coords = {n: coords_p[n][:, block] for n in names}
                q, factors = self.get_proposal_block(
                    generator, coords_p, inds_p, blk.off, blk.ns, names,
                    param_masks)
                for n in names:
                    mask = param_masks.get(n)
                    if mask is not None:
                        q[n] = torch.where(mask, q[n], s_coords[n])

                idx = blk.idx
                prev_logl, prev_logp = logl[:, idx], logp[:, idx]
                logl_new = torch.zeros_like(prev_logl)
                logp_new = torch.zeros_like(prev_logp)
                blobs_new = None
                if blk.at is not None:
                    at = blk.at
                    q_eval = {
                        n: (q[n] if n in q else coords_p[n][:, block])[:, at]
                        for n in all_names
                    }
                    inds_eval = {n: inds_p[n][:, block][:, at]
                                 for n in all_names}
                    lp = ctx.compute_log_prior(q_eval, inds_eval)
                    # the rank's walkers of the block with their branch
                    # supplementals, which the move leaves as they are
                    own = blk.own_idx - self.mesh_layout.w0
                    ll, blobs_new = ctx.compute_log_like(
                        q_eval, inds_eval, lp,
                        state_branch_supps(state, perm=own))
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
                if blobs_new is not None and view.blobs is not None:
                    # only the rank's walkers carry blobs
                    own_idx = blk.own_idx
                    view.blobs[:, own_idx] = merge_blobs(
                        acc[:, blk.at], blobs_new, view.blobs[:, own_idx])
                view.accepted[:, idx] = acc | view.accepted[:, idx]
        return view.result(state)


class _Block(NamedTuple):
    """One red/blue block of :meth:`WalkerBlocks.blocks`: its offset ``off``
    and size ``ns`` on the permuted walker axis, its walkers ``idx`` (global
    indices, in block order), ``at`` the positions in the block of this
    rank's walkers (None where the rank holds none of them), and the
    permuted views ``coords_p``/``inds_p`` of every branch, the complement's
    rows filled in."""

    off: int
    ns: int
    idx: torch.Tensor
    at: Optional[torch.Tensor]
    coords_p: dict
    inds_p: dict

    @property
    def own_idx(self):
        """The global walker indices of this rank's walkers of the block,
        on the device, in block order."""
        return self.idx[self.at]


class WalkerBlocks:
    """The sharded form of the red/blue blocks: walker-order views ``(nt,
    nwalkers, ...)`` of this rank's temperatures of a state sharded over a
    ``(temp, walker)`` mesh (``layout``), and before each block the rows the
    block's complement needs from the other walker shards.

    ``coords``, ``inds``, ``log_like``, ``log_prior`` and ``accepted`` hold
    the rank's own walkers in place; a move writes the block's walkers into
    them by global index.  :meth:`blocks` fills, before the first block of
    a split, every other block's rows and, before a later block, the rows
    that the block before it merged
    (:meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.fill_rows`, every
    branch's coordinates and masks in one exchange).  :meth:`result` is the
    rank's shard of the proposal's state."""

    def __init__(self, layout, state):
        self.layout = layout
        view = layout.walker_view
        self.coords = {n: view(c) for n, c in state.branches_coords.items()}
        self.inds = {n: view(m) for n, m in state.branches_inds.items()}
        self.log_like = view(state.log_like)
        self.log_prior = view(state.log_prior)
        # blobs: the rank's walkers only, never exchanged
        self.blobs = None if state.blobs is None else view(state.blobs)
        self.accepted = torch.zeros((layout.nt, layout.nwalkers),
                                    dtype=torch.bool,
                                    device=state.log_like.device)
        # the exchanged leaves, written in place by the move
        names = list(self.coords)
        self._leaves = ([self.coords[n] for n in names]
                        + [self.inds[n] for n in names])

    def blocks(self, perm, sizes, offsets):
        """Yield a :class:`_Block` per block of the permutation ``perm``
        (blocks of ``sizes`` at ``offsets``), after its exchange.  The
        exchange plans are the permutation's: one host read."""
        lay = self.layout
        order = perm.cpu().numpy()
        device = perm.device
        parts = [order[off:off + ns] for off, ns in zip(offsets, sizes)]
        for k, (off, ns) in enumerate(zip(offsets, sizes)):
            fill = np.concatenate(parts[1:]) if k == 0 else parts[k - 1]
            lay.fill_rows(self._leaves, [lay.own(x) for x in self._leaves],
                          fill)
            w = parts[k]
            mine = np.flatnonzero((w >= lay.w0) & (w < lay.w0 + lay.nw))
            yield _Block(
                off, ns, torch.as_tensor(w, device=device),
                torch.as_tensor(mine, device=device) if mine.size else None,
                {n: c[:, perm] for n, c in self.coords.items()},
                {n: m[:, perm] for n, m in self.inds.items()})

    def result(self, state):
        """``(state, accepted)``: the rank's shard of the coordinates,
        log-likelihood, log-prior and blobs the blocks wrote, with
        ``state``'s leaf masks, and of the accept flags."""
        own = self.layout.own
        return state.replace(
            coords={n: own(c) for n, c in self.coords.items()},
            inds=state.branches_inds, log_like=own(self.log_like),
            log_prior=own(self.log_prior),
            blobs=None if self.blobs is None else own(self.blobs),
        ), own(self.accepted)
