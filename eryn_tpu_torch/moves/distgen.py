"""Independent distribution-draw Metropolis-Hastings move.

Port of :mod:`eryn_tpu.moves.distgen`: each leaf's new coordinates are a
draw from a per-branch distribution, and the detailed-balance factors are
``logq(old) - logq(new)`` over the active leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..prior import ProbDistContainer
from .mh import MHMove

__all__ = ["DistributionGenerate"]


class DistributionGenerate(MHMove):
    """MH move drawing independently from ``generate_dist``.

    Args:
        generate_dist: ``{branch_name: ProbDistContainer}`` to draw from
            (a container alone is the branch ``model_0``'s).
    """

    _mesh_sharded = True

    def __init__(self, generate_dist, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist = generate_dist
        super().__init__(**kwargs)

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.generate_dist]

    def init_kernel_state(self, state):
        self.prepare_constants(state)
        for name, dist in self.generate_dist.items():
            if name in state.branches:
                dist.logpdf(state.branches[name].coords)
        return ()

    @staticmethod
    def _check_mask_against_groups(name, dist, mask):
        """Refuse a Gibbs mask that selects part of a multivariate prior
        group: the joint-logpdf ratio would be the conditional density of
        the selected dimensions, not their marginal proposal density."""
        rows = np.atleast_2d(np.asarray(mask.cpu(), dtype=bool))
        for inds_g, _d in dist.priors:
            if len(inds_g) <= 1:
                continue
            counts = rows[:, np.asarray(inds_g)].sum(axis=-1)
            if np.any((counts > 0) & (counts < len(inds_g))):
                raise ValueError(
                    f"Gibbs mask for branch '{name}' splits the "
                    f"multivariate prior group {tuple(int(i) for i in inds_g)}"
                    "; DistributionGenerate cannot compute marginal "
                    "proposal factors for a partial update of a correlated "
                    "group. Update the whole group in one Gibbs iteration."
                )

    def _initialize_branch_setup(self, gibbs_sampling_setup, is_rj=False):
        super()._initialize_branch_setup(gibbs_sampling_setup, is_rj=is_rj)
        for split in self.gibbs_iterations:
            for name, mask in split or ():
                if mask is not None and name in self.generate_dist:
                    self._check_mask_against_groups(
                        name, self.generate_dist[name], mask)

    def draw_generate(self, generator, name, coords):
        """Randomness of one branch's proposal: a draw of the branch's
        distribution per leaf, ``coords.shape``, per walker."""
        return self.rank_draw(
            lambda sh: self.generate_dist[name].sample(generator, sh,
                                                       dtype=coords.dtype),
            coords.shape[:-1], per_walker=True)

    def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                            kernel_state, param_masks=None):
        q = {}
        factors = None
        for name, coords in branch_coords.items():
            inds = branch_inds[name]
            dist = self.generate_dist[name]
            new = self.draw_generate(generator, name, coords)
            xnew = torch.where(inds[..., None], new, coords)
            mask = None if param_masks is None else param_masks.get(name)
            if mask is not None:
                # the update is restricted before the factors: the Hastings
                # ratio describes the masked proposal
                xnew = torch.where(mask, xnew, coords)
            if self.periodic is not None:
                xnew = self.periodic.wrap({name: xnew})[name]
            q[name] = xnew

            # +logq(old) - logq(new) over the active leaves
            lq_old = torch.where(inds, dist.logpdf(coords), 0.0).sum(dim=-1)
            lq_new = torch.where(inds, dist.logpdf(xnew), 0.0).sum(dim=-1)
            f = lq_old - lq_new
            factors = f if factors is None else factors + f
        return q, factors, kernel_state
