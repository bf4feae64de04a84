"""Red/blue group stretch: the stretch move for reversible-jump ensembles.

Port of :mod:`eryn_tpu.moves.rbgroupstretch`.  Each active leaf of a moving
walker stretches toward a uniformly chosen *active* leaf of the same branch
anywhere in the complement half, so proposals target the support the
posterior occupies, and detailed balance holds exactly (the complement is
the other half's current coordinates).  The choice is an inverse CDF over
the flattened ``(complement walker, leaf)`` axis: one ``cumsum`` of the
complement's masks, then the ``(k + 1)``-th active entry per query, which on
a CUDA device is one launch of
:func:`~eryn_tpu_torch.ops.select_kernels.onehot_select` per branch and half.

Not carried over: the JAX package's choice between an XLA one-hot, its VMEM
kernel and ``searchsorted`` by an HBM budget, which answers TPU constraints.
Periodic wrapping is not ported yet.
"""

from __future__ import annotations

import math

import torch

from ..ops.select_kernels import onehot_select
from .stretch import StretchMove

__all__ = ["RedBlueGroupStretchMove"]


class RedBlueGroupStretchMove(StretchMove):
    """Stretch move whose complement is the other red/blue half's active
    leaves.  Takes the :class:`StretchMove` arguments; inactive leaves of
    the moving walker stay as they are.  The complement leaf is always
    selected by :func:`~eryn_tpu_torch.ops.select_kernels.onehot_select`:
    its kernel on a CUDA device, its plain version on the CPU.
    """

    _needs_c_inds = True

    def __init__(self, *args, periodic=None, **kwargs):
        if periodic is not None:
            raise NotImplementedError(
                "periodic parameters are not supported by eryn_tpu_torch yet."
            )
        super().__init__(*args, **kwargs)

    @staticmethod
    def draw_group(generator, ntemps, ns, leaves, dtype, device):
        """Randomness of one half: ``u`` ``(ntemps, ns)`` for the stretch
        factor, and per branch ``uu`` ``(ntemps, ns, nleaves)`` for the
        complement leaf, ``leaves`` mapping branch names to leaf counts."""
        u = torch.rand((ntemps, ns), generator=generator, dtype=dtype,
                       device=device)
        uu = {
            name: torch.rand((ntemps, ns, nl), generator=generator,
                             dtype=dtype, device=device)
            for name, nl in leaves.items()
        }
        return u, uu

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None, c_inds=None):
        names = list(s_coords)
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype, device = first.dtype, first.device
        u, uu = self.draw_group(
            generator, ntemps, ns, {n: s_coords[n].shape[2] for n in names},
            dtype, device,
        )
        # one z per walker, shared across branches
        if self.use_log_proposal:
            zz = torch.exp((2.0 * u - 1.0) * math.log(self.a))
        else:
            b = (self.a - 1.0) * u + 1.0
            zz = b * b / self.a

        newpos = {}
        ndim_active = torch.zeros((ntemps, ns), dtype=dtype, device=device)
        for name in names:
            s = s_coords[name]  # (nt, ns, nls, nd)
            c = c_coords[name]  # (nt, nc, nl, nd)
            nt, nc, nl, nd = c.shape
            nls = s.shape[2]
            ci = (c_inds[name] if c_inds is not None
                  else torch.ones(c.shape[:3], dtype=torch.bool, device=device))
            M = nc * nl
            m = ci.reshape(nt, M).to(dtype)
            cnt = m.sum(dim=-1)  # active complement leaves per temperature
            cs = torch.cumsum(m, dim=-1)
            # the k-th active entry; k is an exact integer in the float dtype
            kq = torch.floor(
                uu[name] * torch.clamp(cnt, min=1.0)[:, None, None]
            ).reshape(nt, ns * nls)
            # dormant slots may hold NaN: the selection reads zeros there
            c_clean = torch.where(ci[..., None], c, 0.0).reshape(nt, M, nd)
            c_sel = onehot_select(cs, kq, c_clean).reshape(nt, ns, nls, nd)
            temp = c_sel - (c_sel - s) * zz[:, :, None, None]

            # only active leaves move, and only where the complement has an
            # active leaf: a temperature whose complement has none proposes
            # the identity for this branch, and its dims leave the factors
            has_c = cnt > 0
            move_mask = s_inds[name][..., None] & has_c[:, None, None, None]
            newpos[name] = torch.where(move_mask, temp, s)

            mask = None if param_masks is None else param_masks.get(name)
            has_c2 = has_c[:, None].to(dtype)
            if mask is None:
                ndim_active = ndim_active + s_inds[name].sum(dim=-1) * nd * has_c2
            else:
                per_leaf = mask.sum(dim=-1).to(device=device, dtype=dtype)
                ndim_active = ndim_active + (
                    s_inds[name] * per_leaf
                ).sum(dim=-1) * has_c2

        if self.use_log_proposal:
            factors = ndim_active * torch.log(zz)
        else:
            factors = (ndim_active - 1.0) * torch.log(zz)
        return newpos, factors
