"""Goodman-Weare affine-invariant stretch move.

Port of :mod:`eryn_tpu.moves.stretch`.  Two paths:

* the general path (:meth:`StretchMove.get_proposal_kernel` under
  :class:`~eryn_tpu_torch.moves.red_blue.RedBlueMove`), which handles Gibbs
  masks and any branch subset, and is the path on the CPU;
* the fused path (:meth:`StretchMove._propose_impl_fused`), two kernel
  launches per red/blue half (propose, then accept and merge) around the
  likelihood, taken on a CUDA device whenever the structure allows it.
"""

from __future__ import annotations

import math

import torch

from ..ops.stretch_kernels import stretch_accept, stretch_propose
from .move import active_ndim
from .red_blue import RedBlueMove, _inverse_permutation

__all__ = ["StretchMove"]


class StretchMove(RedBlueMove):
    """Affine-invariant "stretch" proposal (Goodman & Weare 2010).

    ``z ~ ((a-1)u + 1)^2 / a``; proposal ``q = c + z (s - c)``; factors
    ``(ndim_active - 1) log z``.  ``use_log_proposal=True`` draws ``ln z``
    uniform on ``[-ln a, ln a]`` (ptemcee), with factors
    ``ndim_active log z``.

    ``use_kernels``: None (default) takes the fused CUDA kernels when the
    state lies on a CUDA device and the structure allows it; True takes the
    fused path on any device (on the CPU its plain PyTorch versions); False
    always takes the general path.
    """

    def __init__(self, a=2.0, use_kernels=None, use_log_proposal=False, **kwargs):
        super().__init__(**kwargs)
        self.a = float(a)
        self.use_kernels = use_kernels
        self.use_log_proposal = bool(use_log_proposal)

    # ------------------------------------------------------------------
    # fused path
    # ------------------------------------------------------------------
    def _can_fuse(self, state):
        if self.use_kernels is False:
            return False
        if self.use_kernels is None and state.log_like.device.type != "cuda":
            return False
        return (
            self.gibbs_iterations == [None]
            and state.blobs is None
            and all(s is None for s in state.branches_supplemental.values())
            and self.nsplits == 2
            and self.randomize_split
            and type(self).get_proposal_kernel is StretchMove.get_proposal_kernel
            and type(self).choose_c_vals is StretchMove.choose_c_vals
            # the fused path never calls setup(); a subclass overriding it
            # takes the general path so the hook fires
            and type(self).setup is RedBlueMove.setup
            and self.run_branches(state) == list(state.branches)
        )

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        if self._can_fuse(state):
            ntemps, nwalkers = state.log_like.shape
            perm, u_all = self.draw_fused(
                generator, ntemps, nwalkers, state.log_like.dtype,
                state.log_like.device,
            )
            new_state, accepted = self._propose_impl_fused(
                state, ctx, perm, u_all
            )
            return new_state, accepted, kernel_state
        return super()._propose_impl(generator, state, ctx, kernel_state)

    @staticmethod
    def draw_fused(generator, ntemps, nwalkers, dtype, device):
        """All randomness of one fused step: the walker permutation that
        splits the halves, and ``u_all`` shaped ``(2, 3, ntemps, nwalkers)``
        (per half: z draw, complement pick, accept)."""
        perm = torch.argsort(
            torch.rand(nwalkers, generator=generator, device=device)
        )
        u_all = torch.rand(
            (2, 3, ntemps, nwalkers), generator=generator, dtype=dtype,
            device=device,
        )
        return perm, u_all

    def _propose_impl_fused(self, state, ctx, perm, u_all):
        """One fused stretch step from the given draws (see
        :meth:`draw_fused`).  Branch blocks are concatenated along the last
        axis, so one launch covers all branches.  Each half is kept in its
        own contiguous block in the permuted walker order; one gather
        restores the walker order at the end.

        Returns ``(state, accepted)`` with ``accepted`` in the state dtype.
        """
        names = list(state.branches)
        logl = state.log_like
        ntemps, nwalkers = logl.shape
        dtype = logl.dtype
        self._check_walkers(state, names)

        shapes = [
            (n, state.branches[n].nleaves_max, state.branches[n].ndim)
            for n in names
        ]
        parts = [state.branches[n].coords.reshape(ntemps, nwalkers, -1)
                 for n in names]
        X = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        inds = state.branches_inds
        ndim_act = active_ndim(state, names).to(dtype)
        betas = state.betas
        if betas is None:
            betas = torch.ones(ntemps, dtype=dtype, device=logl.device)

        def q_to_branches(q, ns):
            out, off = {}, 0
            for n, nl, nd in shapes:
                out[n] = q[..., off:off + nl * nd].reshape(ntemps, ns, nl, nd)
                off += nl * nd
            return out

        n0 = nwalkers - nwalkers // 2
        halves = (perm[:n0], perm[n0:])
        X_h = [X[:, p] for p in halves]
        # (logl, logp, ndim_act) of each half as one (3, nt, ns) block
        L = torch.stack([logl, state.log_prior, ndim_act])
        L_h = [L[:, :, p] for p in halves]
        out = []
        for half, p in enumerate(halves):
            s_blk, c_blk = X_h[half], X_h[1 - half]
            ns = s_blk.shape[1]
            ll_old, lp_old, nd_blk = L_h[half]
            q, factors = stretch_propose(
                s_blk, c_blk, nd_blk, u_all[half, :2, :, :ns].contiguous(),
                a=self.a, log_proposal=self.use_log_proposal,
            )
            q_branches = q_to_branches(q, ns)
            inds_blk = {n: inds[n][:, p] for n in names}
            logp_new = ctx.compute_log_prior(q_branches, inds_blk)
            logl_new, _ = ctx.compute_log_like(q_branches, inds_blk, logp_new)
            coords_blk, logl_blk, logp_blk, acc = stretch_accept(
                q, s_blk, logl_new.contiguous(), logp_new.contiguous(),
                ll_old, lp_old, factors, betas,
                u_all[half, 2, :, :ns].contiguous(),
            )
            # the second half's complement is the first half, as updated
            X_h[half] = coords_blk
            out.append(torch.stack([logl_blk, logp_blk, acc]))

        inv_perm = _inverse_permutation(perm)
        X = torch.cat(X_h, dim=1)[:, inv_perm]
        logl, logp, accepted = torch.cat(out, dim=2)[:, :, inv_perm]
        new_state = state.replace(
            coords=q_to_branches(X, nwalkers), inds=inds, log_like=logl,
            log_prior=logp,
        )
        return new_state, accepted

    # ------------------------------------------------------------------
    # general path
    # ------------------------------------------------------------------
    def choose_c_vals(self, generator, c, ns):
        """Uniform random complement walker per proposed walker."""
        ntemps, nc = c.shape[:2]
        rint = torch.randint(
            0, nc, (ntemps, ns), generator=generator, device=c.device
        )
        idx = rint[:, :, None, None].expand(ntemps, ns, *c.shape[2:])
        return torch.gather(c, 1, idx)

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None):
        names = list(s_coords)
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype, device = first.dtype, first.device

        # one z per walker, shared across branches
        u = torch.rand((ntemps, ns), generator=generator, dtype=dtype,
                       device=device)
        if self.use_log_proposal:
            zz = torch.exp((2.0 * u - 1.0) * math.log(self.a))
        else:
            b = (self.a - 1.0) * u + 1.0
            zz = b * b / self.a

        newpos = {}
        ndim_active = torch.zeros((ntemps, ns), dtype=dtype, device=device)
        for name in names:
            s = s_coords[name]
            c_temp = self.choose_c_vals(generator, c_coords[name], ns)
            newpos[name] = c_temp - (c_temp - s) * zz[:, :, None, None]
            # RJ/Gibbs-aware dimension count: active leaves x selected params
            mask = None if param_masks is None else param_masks.get(name)
            if mask is None:
                ndim_active = ndim_active + s_inds[name].sum(dim=-1) * s.shape[-1]
            else:
                per_leaf = mask.sum(dim=-1).to(device=device, dtype=dtype)
                ndim_active = ndim_active + (s_inds[name] * per_leaf).sum(dim=-1)

        if self.use_log_proposal:
            factors = ndim_active * torch.log(zz)
        else:
            factors = (ndim_active - 1.0) * torch.log(zz)
        return newpos, factors
