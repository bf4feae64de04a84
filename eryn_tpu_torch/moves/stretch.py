"""Goodman-Weare affine-invariant stretch move.

Port of :mod:`eryn_tpu.moves.stretch`.  Two paths:

* the general path (:meth:`StretchMove.get_proposal_kernel` under
  :class:`~eryn_tpu_torch.moves.red_blue.RedBlueMove`), which handles Gibbs
  masks and any branch subset, and is the path on the CPU;
* the fused path (:meth:`StretchMove._propose_impl_fused`), three kernel
  launches per step around the two halves' likelihood calls (propose half
  0; accept half 0 and propose half 1; accept half 1), taken on a CUDA
  device whenever the structure allows it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.stretch_kernels import (
    stretch_accept,
    stretch_accept_propose,
    stretch_propose,
)
from .move import active_ndim, stock_host_api
from .red_blue import RedBlueMove

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
    always takes the general path.  With ``periodic`` set the move takes the
    general path, which stretches along the minimal signed distance and
    wraps the proposal.
    """

    def __init__(self, a=2.0, use_kernels=None, use_log_proposal=False, **kwargs):
        super().__init__(**kwargs)
        self.a = float(a)
        self.use_kernels = use_kernels
        self.use_log_proposal = bool(use_log_proposal)

    # ------------------------------------------------------------------
    # Eryn's host protocol, for subclasses written against it
    # ------------------------------------------------------------------
    @stock_host_api
    def get_proposal(self, s_all, c_all, random, gibbs_ndim=None, **kwargs):
        """The stretch proposal of a red/blue split on NumPy arrays with
        the host ``random``; returns ``(q, factors)``."""
        from .legacy import stretch_get_proposal

        return stretch_get_proposal(self, s_all, c_all, random,
                                    gibbs_ndim=gibbs_ndim)

    def get_new_points(self, name, s, c_temp, Ns, branch_shape, branch_i,
                       random_number_generator):
        """One branch stretched along the ray to its complement on NumPy
        arrays; ``self.zz`` is drawn at the first branch and shared."""
        from .legacy import _periodic_np

        ntemps = branch_shape[0]
        s, c_temp = np.asarray(s), np.asarray(c_temp)
        if branch_i == 0:
            u = random_number_generator.rand(ntemps, Ns)
            if self.use_log_proposal:
                self.zz = np.exp((2.0 * u - 1.0) * np.log(self.a))
            else:
                self.zz = ((self.a - 1.0) * u + 1.0) ** 2 / self.a
        diff = (c_temp - s if self.periodic is None
                else _periodic_np(self.periodic, "distance", name, s, c_temp))
        temp = c_temp - diff * self.zz[:, :, None, None]
        if self.periodic is not None:
            temp = _periodic_np(self.periodic, "wrap", name, temp)
        return temp

    # ------------------------------------------------------------------
    # fused path
    # ------------------------------------------------------------------
    def _can_fuse(self, state):
        if self.use_kernels is False:
            return False
        if self.use_kernels is None and state.log_like.device.type != "cuda":
            return False
        return (
            self.periodic is None
            and self.gibbs_iterations == [None]
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
        axis, so one launch covers all branches.  The kernels read the
        walker-order state through ``perm`` and merge each half in place
        into walker-order outputs, allocated once here: three launches
        around the two likelihood calls, ``stretch_propose`` (half 0),
        ``stretch_accept_propose`` (accept half 0, propose half 1) and
        ``stretch_accept`` (half 1).

        Returns ``(state, accepted)`` with ``accepted`` in the state dtype.
        """
        names = list(state.branches)
        logl = state.log_like.contiguous()
        logp = state.log_prior.contiguous()
        ntemps, nwalkers = logl.shape
        dtype = logl.dtype
        self._check_walkers(state, names)

        shapes = [
            (n, state.branches[n].nleaves_max, state.branches[n].ndim)
            for n in names
        ]
        parts = [state.branches[n].coords.reshape(ntemps, nwalkers, -1)
                 for n in names]
        X = (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
             ).contiguous()
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

        def evaluate(q, half):
            q_branches = q_to_branches(q, q.shape[1])
            inds_blk = {n: inds[n][:, halves[half]] for n in names}
            logp_new = ctx.compute_log_prior(q_branches, inds_blk)
            # blobs and supplementals take the general path (_can_fuse)
            logl_new, _ = ctx.compute_log_like(q_branches, inds_blk, logp_new)
            return logl_new.contiguous(), logp_new.contiguous()

        outs = (torch.empty_like(X), torch.empty_like(logl),
                torch.empty_like(logl), torch.empty_like(logl))
        kw = dict(a=self.a, log_proposal=self.use_log_proposal)
        q, factors = stretch_propose(X, X, ndim_act, perm, u_all, 0, **kw)
        q, factors = stretch_accept_propose(
            q, X, *evaluate(q, 0), logl, logp, factors, betas, ndim_act,
            perm, u_all, *outs, **kw,
        )
        stretch_accept(q, X, *evaluate(q, 1), logl, logp, factors, betas,
                       perm, u_all, 1, *outs)
        X_out, logl_out, logp_out, accepted = outs
        new_state = state.replace(
            coords=q_to_branches(X_out, nwalkers), inds=inds,
            log_like=logl_out, log_prior=logp_out,
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
            if self.periodic is not None:
                diff = self.periodic.distance({name: s}, {name: c_temp})[name]
            else:
                diff = c_temp - s
            temp = c_temp - diff * zz[:, :, None, None]
            if self.periodic is not None:
                temp = self.periodic.wrap({name: temp})[name]
            newpos[name] = temp
            # RJ/Gibbs-aware dimension count: active leaves x selected params
            mask = None if param_masks is None else param_masks.get(name)
            if mask is None:
                ndim_active = ndim_active + s_inds[name].sum(dim=-1) * s.shape[-1]
            else:
                per_leaf = mask.sum(dim=-1).to(dtype)
                ndim_active = ndim_active + (s_inds[name] * per_leaf).sum(dim=-1)

        if self.use_log_proposal:
            factors = ndim_active * torch.log(zz)
        else:
            factors = (ndim_active - 1.0) * torch.log(zz)
        return newpos, factors
