"""Goodman & Weare "walk" move.

Port of :mod:`eryn_tpu.moves.walk` (Goodman & Weare 2010, sec. 3): a walker
steps by a random combination of the complement's deviations from their
mean, ``q = s + sum_j z_j (c_j - c_mean)``, ``z_j ~ N(0, 1)``: symmetric
(the factors are zero) and affine-invariant, and for a red/blue half one
batched matrix product ``(ntemps, ns, nc) @ (ntemps, nc, D)``.
"""

from __future__ import annotations

import torch

from .red_blue import RedBlueMove

__all__ = ["WalkMove"]


class WalkMove(RedBlueMove):
    """Goodman-Weare walk proposal.

    Args:
        s0: expected number of complement walkers in each walker's
            combination (a Bernoulli subset; None: all of them).
        scale: step scale (default ``1 / sqrt(nc_eff)``, which keeps the
            proposal's covariance the complement's).
    """

    _mesh_sharded = True

    def __init__(self, s0=None, scale=None, **kwargs):
        super().__init__(**kwargs)
        self.s0 = s0
        self.scale = scale

    def draw_walk(self, generator, names, ntemps, ns, nc, like):
        """Per branch the normals ``(ntemps, ns, nc)`` of the combination
        and, with ``s0``, the uniforms of its subset (else None)."""
        kw = dict(generator=generator, dtype=like.dtype, device=like.device)
        shape = (ntemps, ns, nc)
        return {n: (self.rank_draw(lambda sh: torch.randn(sh, **kw), shape),
                    self.rank_draw(lambda sh: torch.rand(sh, **kw), shape)
                    if self.s0 is not None else None)
                for n in names}

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None):
        names = list(s_coords)
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        nc = c_coords[names[0]].shape[1]
        draws = self.draw_walk(generator, names, ntemps, ns, nc, first)

        newpos = {}
        for name in names:
            s, c = s_coords[name], c_coords[name]
            nt, nc, nl, nd = c.shape
            z, u = draws[name]
            if self.s0 is not None:
                p = min(max(float(self.s0) / nc, 0.0), 1.0)
                z = z * (u < p).to(z.dtype)
                nc_eff = max(float(self.s0), 1.0)
            else:
                nc_eff = float(nc)
            scale = float(self.scale) if self.scale is not None else nc_eff ** -0.5

            if self.periodic is not None:
                # nearest-image deviations: a raw difference across a seam
                # would inflate the spread
                mean = c.mean(dim=1, keepdim=True)
                dev = self.periodic.distance(
                    {name: mean.expand(c.shape)}, {name: c})[name]
                dev = dev.reshape(nt, nc, nl * nd)
            else:
                flat = c.reshape(nt, nc, nl * nd)
                dev = flat - flat.mean(dim=1, keepdim=True)
            step = torch.einsum("tsc,tcd->tsd", z, dev) * scale
            q = s + step.reshape(ntemps, ns, nl, nd)
            if self.periodic is not None:
                q = self.periodic.wrap({name: q})[name]
            newpos[name] = q
        return newpos, first.new_zeros((ntemps, ns))
