"""Reversible-jump birth and death from a generating distribution.

Port of :mod:`eryn_tpu.moves.distgenrj` (the traced protocol): a birth draws
the new leaf's coordinates from the branch's distribution (usually the
prior), a death flips the mask, and the detailed-balance factors are
``-logpdf(born)`` and ``+logpdf(removed)``, all as masked tensor ops over the
whole ensemble.
"""

from __future__ import annotations

import numpy as np
import torch

from ..prior import ProbDistContainer
from .move import stock_host_api
from .rj import ReversibleJumpMove, rj_change_kernel

__all__ = ["DistributionGenerateRJ"]


class DistributionGenerateRJ(ReversibleJumpMove):
    """Birth/death move.

    Args:
        generate_dist: ``{branch_name: ProbDistContainer}`` to draw births
            from (typically the priors).
        nleaves_max / nleaves_min: per-branch leaf-count bounds.
        fix_change: force +1 (birth-only) or -1 (death-only) proposals.
    """

    _mesh_sharded = True

    def __init__(self, generate_dist, *args, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist = generate_dist
        super().__init__(*args, **kwargs)

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.generate_dist]

    # ------------------------------------------------------------------
    # Eryn's host protocol, for subclasses written against it
    # ------------------------------------------------------------------
    @stock_host_api
    def get_model_change_proposal(self, inds, random, nleaves_min,
                                  nleaves_max):
        """The birth and death slots on host masks ``(ntemps, nwalkers,
        nleaves_max)``: ``{"+1": (n, 3), "-1": (n, 3)}`` index rows
        ``(temperature, walker, leaf)``.  A walker at an end of the range
        moves inward; the slot is uniform among the inactive (birth) or
        active (death) leaves."""
        inds = np.asarray(inds, dtype=bool)
        ntemps, nwalkers, nlmax = inds.shape
        nleaves = inds.sum(axis=-1)
        if self.fix_change is None:
            change = random.choice([-1, +1], size=nleaves.shape)
        else:
            change = np.full(nleaves.shape, self.fix_change)
        change = (change * ((nleaves != nleaves_min)
                            & (nleaves != nleaves_max))
                  + (nleaves == nleaves_min).astype(int)
                  - (nleaves == nleaves_max).astype(int))
        # a stable argsort of the mask lists the inactive slots first, in
        # index order: the j-th inactive slot is order[..., j], the j-th
        # active one order[..., n_inactive + j]
        order = np.argsort(inds, axis=-1, kind="stable")
        n_inactive = nlmax - nleaves
        u = random.rand(ntemps, nwalkers)
        j_add = np.minimum((u * np.maximum(n_inactive, 1)).astype(int),
                           nlmax - 1)
        j_rem = np.minimum((u * np.maximum(nleaves, 1)).astype(int),
                           nlmax - 1)
        slot_add = np.take_along_axis(order, j_add[..., None], -1)[..., 0]
        slot_rem = np.take_along_axis(
            order, np.minimum(n_inactive + j_rem, nlmax - 1)[..., None],
            -1)[..., 0]
        out = {}
        t, w = np.nonzero(change == +1)
        out["+1"] = np.stack([t, w, slot_add[t, w]], axis=-1).astype(int)
        t, w = np.nonzero(change == -1)
        out["-1"] = np.stack([t, w, slot_rem[t, w]], axis=-1).astype(int)
        return out

    @stock_host_api
    def get_proposal(self, all_coords, all_inds, nleaves_min_all,
                     nleaves_max_all, random, **kwargs):
        """The host birth/death proposal: masks flipped at the slots of
        :meth:`get_model_change_proposal`, births drawn from the branch's
        distribution; returns ``(q, new_inds, factors)`` with the factors
        ``-logpdf(born)`` and ``+logpdf(removed)``."""
        from .legacy import host_logpdf, host_rvs

        q, new_inds, changes = {}, {}, {}
        for name, inds in all_inds.items():
            nmin, nmax = nleaves_min_all[name], nleaves_max_all[name]
            if nmin == nmax:
                continue
            if nmin > nmax:
                raise ValueError(
                    "nleaves_min is greater than nleaves_max. Not allowed.")
            changes[name] = self.get_model_change_proposal(inds, random,
                                                           nmin, nmax)
        factors = None
        for name in all_coords:
            coords = np.asarray(all_coords[name])
            q[name] = coords.copy()
            new_inds[name] = np.asarray(all_inds[name], dtype=bool).copy()
            if factors is None:
                factors = np.zeros(coords.shape[:2])
            if name not in changes:
                continue
            dist = self.generate_dist[name]
            rem = tuple(changes[name]["-1"].T)
            new_inds[name][rem] = False
            if rem[0].size:
                factors[rem[:2]] += host_logpdf(dist, q[name][rem])
            add = tuple(changes[name]["+1"].T)
            new_inds[name][add] = True
            if add[0].size:
                q[name][add] = host_rvs(dist, random, add[0].size)
                factors[add[:2]] -= host_logpdf(dist, q[name][add])
        return q, new_inds, factors

    def draw_rj(self, generator, name, coords):
        """Randomness of one branch's proposal: the change uniforms ``(nt,
        nw)``, the slot keys ``(nt, nw, nleaves_max)`` and the birth
        coordinates ``(nt, nw, ndim)`` drawn from the branch's
        distribution."""
        ntemps, nwalkers, nleaves_max, _ = coords.shape
        kw = dict(generator=generator, dtype=coords.dtype, device=coords.device)

        def rand(shape):
            return torch.rand(shape, **kw)

        def birth(shape):
            return self.generate_dist[name].sample(generator, shape,
                                                   dtype=coords.dtype)

        u_change = self.rank_draw(rand, (ntemps, nwalkers), per_walker=True)
        slot_keys = self.rank_draw(rand, (ntemps, nwalkers, nleaves_max),
                                   per_walker=True)
        draw = self.rank_draw(birth, (ntemps, nwalkers), per_walker=True)
        return u_change, slot_keys, draw

    def get_proposal_kernel(self, generator, name, coords, inds):
        dist = self.generate_dist[name]
        u_change, slot_keys, draw = self.draw_rj(generator, name, coords)
        change, slot, new_inds = rj_change_kernel(
            u_change, slot_keys, inds, self.nleaves_min[name],
            self.nleaves_max[name], self.fix_change,
        )
        slot_mask = (
            torch.arange(inds.shape[-1], device=inds.device) == slot[..., None]
        )
        born = (change == 1)[..., None] & slot_mask
        q = torch.where(born[..., None], draw[:, :, None, :], coords)
        # the coordinates at the slot: the removed leaf for a death
        at_slot = torch.gather(
            coords, 2, slot[:, :, None, None].expand(-1, -1, 1, coords.shape[-1])
        )[:, :, 0]
        factors = torch.where(
            change == 1,
            -dist.logpdf(draw),
            torch.where(change == -1, dist.logpdf(at_slot), 0.0),
        ).to(coords.dtype)
        return q, new_inds, factors
