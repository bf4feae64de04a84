"""Group stretch: the affine-invariant stretch against a stationary
complement.

Port of :mod:`eryn_tpu.moves.groupstretch`.  The stretch is
:class:`~eryn_tpu_torch.moves.stretch.StretchMove`'s; the complement point
comes from the stationary friends table of the kernel state, not from the
live ensemble, which makes the move usable under reversible jump.  The
default table is a snapshot of the ensemble, and each walker draws a
uniformly random friend other than its own column.  The move runs
:class:`~eryn_tpu_torch.moves.group.GroupMove`'s proposal, as tensor ops:
no stretch kernel.
"""

from __future__ import annotations

import torch

from .group import GroupMove
from .move import stock_host_api
from .stretch import StretchMove

__all__ = ["GroupStretchMove"]


def pick_friends(u, table, first=0):
    """Each walker's friend from the uniforms ``u`` ``(ntemps, ns)``: walker
    ``w`` below the table's width ``nfr`` draws one of the other ``nfr - 1``
    columns (skipping its own), the rest one of all ``nfr``; returns the
    rows ``(ntemps, ns, nleaves_max, ndim)`` of ``table``.  ``first`` is the
    ensemble index of ``u``'s first walker (a shard's offset under a device
    mesh)."""
    ntemps, ns = u.shape
    nfr = table.shape[1]
    if nfr > 1:
        widx = torch.arange(first, first + ns, device=u.device)[None, :]
        r_excl = torch.floor(u * (nfr - 1)).to(torch.int64)
        r_excl = r_excl + (r_excl >= widx).to(torch.int64)
        r_full = torch.floor(u * nfr).to(torch.int64)
        rint = torch.where(widx < nfr, r_excl, r_full)
    else:
        rint = torch.zeros((ntemps, ns), dtype=torch.int64, device=u.device)
    idx = rint[:, :, None, None].expand(ntemps, ns, *table.shape[2:])
    return torch.gather(table, 1, idx)


class GroupStretchMove(GroupMove, StretchMove):
    """Stretch proposal over a stationary friends group.

    ``a`` is the stretch scale; the other arguments are
    :class:`~eryn_tpu_torch.moves.group.GroupMove`'s.  A subclass may
    override ``setup_friends_kernel`` and ``find_friends_kernel`` (e.g. for
    nearest-neighbour friends), or Eryn's host hooks ``setup_friends`` and
    ``find_friends``, which make it a host move.
    """

    _mesh_sharded = True

    def __init__(self, a=2.0, **kwargs):
        GroupMove.__init__(self, **kwargs)
        self.a = float(a)

    @stock_host_api
    def get_proposal(self, s_all, random, gibbs_ndim=None, s_inds_all=None,
                     branch_supps=None, **kwargs):
        """The host protocol's stretch against the complement of
        ``find_friends``; returns ``(q, factors)``."""
        from .legacy import groupstretch_get_proposal

        return groupstretch_get_proposal(
            self, s_all, random, gibbs_ndim=gibbs_ndim,
            s_inds_all=s_inds_all, branch_supps=branch_supps)

    def setup_friends_kernel(self, branches_coords, branches_inds):
        """Default: the ensemble (its first ``nfriends`` walkers) as the
        stationary group."""
        nf = self.nfriends
        return {
            name: c[:, :nf] if nf is not None and nf < c.shape[1] else c
            for name, c in branches_coords.items()
        }

    def draw_friends(self, generator, like):
        """The uniforms of one branch's friend pick, shaped and typed like
        ``like`` ``(ntemps, ns)``, one per walker of the state."""
        return self.rank_draw(
            lambda shape: torch.rand(shape, generator=generator,
                                     dtype=like.dtype, device=like.device),
            like.shape, per_walker=True)

    def find_friends_kernel(self, generator, name, s_coords, s_inds, friends):
        u = self.draw_friends(generator, s_coords[:, :, 0, 0])
        lay = self.mesh_layout
        return pick_friends(u, friends[name], 0 if lay is None else lay.w0)

    def draw_stretch(self, generator, ntemps, ns, dtype, device):
        """The uniforms of the stretch factor ``z``, ``(ntemps, ns)``, one
        per walker of the state."""
        return self.rank_draw(
            lambda shape: torch.rand(shape, generator=generator, dtype=dtype,
                                     device=device),
            (ntemps, ns), per_walker=True)

    def group_proposal_kernel(self, generator, s_coords, s_inds, friends,
                              param_masks):
        names = list(s_coords)
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype = first.dtype
        u = self.draw_stretch(generator, ntemps, ns, dtype, first.device)
        b = (self.a - 1.0) * u + 1.0
        zz = b * b / self.a

        newpos = {}
        ndim_active = torch.zeros((ntemps, ns), dtype=dtype,
                                  device=first.device)
        for name in names:
            s = s_coords[name]
            c_temp = self.find_friends_kernel(generator, name, s,
                                              s_inds[name], friends)
            if self.periodic is not None:
                diff = self.periodic.distance({name: s}, {name: c_temp})[name]
            else:
                diff = c_temp - s
            temp = c_temp - diff * zz[:, :, None, None]
            if self.periodic is not None:
                temp = self.periodic.wrap({name: temp})[name]
            newpos[name] = temp

            mask = None if param_masks is None else param_masks.get(name)
            if mask is None:
                ndim_active = ndim_active + s_inds[name].sum(dim=-1) * s.shape[-1]
            else:
                per_leaf = mask.sum(dim=-1).to(dtype)
                ndim_active = ndim_active + (s_inds[name] * per_leaf).sum(dim=-1)

        factors = (ndim_active - 1.0) * torch.log(zz)
        return newpos, factors
