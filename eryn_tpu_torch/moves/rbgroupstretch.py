"""Red/blue group stretch: the stretch move for reversible-jump ensembles.

Port of :mod:`eryn_tpu.moves.rbgroupstretch`.  Each active leaf of a moving
walker stretches toward a uniformly chosen *active* leaf of the same branch
anywhere in the complement half, so proposals target the support the
posterior occupies, and detailed balance holds exactly (the complement is
the other half's current coordinates).  The choice is an inverse CDF over
the flattened ``(complement walker, leaf)`` axis: the ``(k + 1)``-th active
entry per query.  The whole proposal of a red/blue block (the scan of the
complement's masks, the picks, the stretch with its periodic wrap, the move
mask and the factors, every branch) is one call of
:func:`~eryn_tpu_torch.ops.select_kernels.group_stretch_propose`: one kernel
launch on a CUDA device, which reads the complement where it lies in the
permuted ensemble, and the plain version on the CPU.

Not carried over: the JAX package's choice between an XLA one-hot, its VMEM
kernel and ``searchsorted`` by an HBM budget, which answers TPU constraints.
"""

from __future__ import annotations

import torch

from ..ops.select_kernels import group_stretch_propose
from .stretch import StretchMove

__all__ = ["RedBlueGroupStretchMove"]


class RedBlueGroupStretchMove(StretchMove):
    """Stretch move whose complement is the other red/blue half's active
    leaves.  Takes the :class:`StretchMove` arguments, ``periodic`` included
    (periodic parameters stretch along the minimal signed distance and are
    wrapped into ``[0, P)``); inactive leaves of the moving walker stay as
    they are.
    """

    _needs_c_inds = True
    _mesh_sharded = True

    def draw_group(self, generator, ntemps, ns, leaves, dtype, device):
        """Randomness of one half: ``u`` ``(ntemps, ns)`` for the stretch
        factor, and per branch ``uu`` ``(ntemps, ns, nleaves)`` for the
        complement leaf, ``leaves`` mapping branch names to leaf counts
        (each drawn at every temperature under a device mesh,
        :meth:`~eryn_tpu_torch.moves.move.Move.rank_draw`)."""
        def rand(shape):
            return torch.rand(shape, generator=generator, dtype=dtype,
                              device=device)

        u = self.rank_draw(rand, (ntemps, ns))
        uu = {name: self.rank_draw(rand, (ntemps, ns, nl))
              for name, nl in leaves.items()}
        return u, uu

    def _propose(self, generator, s, s_inds, c, c_inds, param_masks, skip):
        """Draw and propose: the moving rows ``s`` from the complement, the
        rows of ``c`` outside ``skip``."""
        names = list(s)
        first = s[names[0]]
        ntemps, ns = first.shape[:2]
        dtype, device = first.dtype, first.device
        u, uu = self.draw_group(
            generator, ntemps, ns, {n: s[n].shape[2] for n in names},
            dtype, device,
        )
        per_leaf = periods = None
        if param_masks is not None and any(
                param_masks.get(n) is not None for n in names):
            # a Gibbs mask counts only its selected parameters
            per_leaf = {
                n: None if param_masks.get(n) is None else
                param_masks[n].sum(dim=-1).to(dtype)
                for n in names
            }
        if self.periodic is not None:
            periods = {
                n: self.periodic.period_vector(n, s[n].shape[-1], dtype, device)
                for n in names
            }
        return group_stretch_propose(
            s, s_inds, c, c_inds, u, uu, skip=skip, a=self.a,
            log_proposal=self.use_log_proposal, per_leaf=per_leaf,
            periods=periods,
        )

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None, c_inds=None):
        if c_inds is None:
            c_inds = {
                n: torch.ones(c.shape[:3], dtype=torch.bool, device=c.device)
                for n, c in c_coords.items()
            }
        return self._propose(generator, s_coords, s_inds, c_coords, c_inds,
                             param_masks, (0, 0))

    def get_proposal_block(self, generator, coords_p, inds_p, off, ns, names,
                           param_masks):
        """The proposal of block ``[off, off + ns)`` of the permuted
        ensemble from the rows around it, with no copy of the complement.  A
        subclass that overrides :meth:`get_proposal_kernel` is called
        through it, with the complement gathered."""
        if (type(self).get_proposal_kernel
                is not RedBlueGroupStretchMove.get_proposal_kernel):
            return super().get_proposal_block(
                generator, coords_p, inds_p, off, ns, names, param_masks)
        blk = slice(off, off + ns)
        return self._propose(
            generator, {n: coords_p[n][:, blk] for n in names},
            {n: inds_p[n][:, blk] for n in names},
            {n: coords_p[n] for n in names}, {n: inds_p[n] for n in names},
            param_masks, (off, ns),
        )
