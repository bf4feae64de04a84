"""Reversible-jump birth and death from a generating distribution.

Port of :mod:`eryn_tpu.moves.distgenrj` (the traced protocol): a birth draws
the new leaf's coordinates from the branch's distribution (usually the
prior), a death flips the mask, and the detailed-balance factors are
``-logpdf(born)`` and ``+logpdf(removed)``, all as masked tensor ops over the
whole ensemble.
"""

from __future__ import annotations

import torch

from ..prior import ProbDistContainer
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

    def __init__(self, generate_dist, *args, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist = generate_dist
        super().__init__(*args, **kwargs)

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.generate_dist]

    def draw_rj(self, generator, name, coords):
        """Randomness of one branch's proposal: the change uniforms ``(nt,
        nw)``, the slot keys ``(nt, nw, nleaves_max)`` and the birth
        coordinates ``(nt, nw, ndim)`` drawn from the branch's
        distribution."""
        ntemps, nwalkers, nleaves_max, _ = coords.shape
        kw = dict(generator=generator, dtype=coords.dtype, device=coords.device)
        u_change = torch.rand((ntemps, nwalkers), **kw)
        slot_keys = torch.rand((ntemps, nwalkers, nleaves_max), **kw)
        draw = self.generate_dist[name].sample(
            generator, (ntemps, nwalkers), dtype=coords.dtype
        )
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
