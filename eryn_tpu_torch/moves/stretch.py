"""Goodman-Weare affine-invariant stretch move.

Port of :mod:`eryn_tpu.moves.stretch`.  Two paths:

* the general path (:meth:`StretchMove.get_proposal_kernel` under
  :class:`~eryn_tpu_torch.moves.red_blue.RedBlueMove`), which handles Gibbs
  masks and any branch subset, and is the path on the CPU;
* the fused path (:meth:`StretchMove._propose_impl_fused`), three kernel
  launches per step around the two halves' likelihood calls (propose half
  0; accept half 0 and propose half 1; accept half 1), taken on a CUDA
  device whenever the structure allows it.

On a state sharded over a device mesh (:mod:`~eryn_tpu_torch.parallel.
mesh`) the move takes the path one process would take, in its sharded
form: the fused path's
(:meth:`StretchMove._propose_impl_fused_sharded`: the same draws at their
global shape, each half's complement gathered within the temperature
shard, and kernels 1 and 2 on this rank's walkers), or the general path
through :class:`~eryn_tpu_torch.moves.red_blue.RedBlueMove`'s sharded form
(its draws through :meth:`~eryn_tpu_torch.moves.move.Move.rank_draw`),
which its subclasses that run sharded take too.
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

    _mesh_sharded = True

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
            if self.mesh_layout is not None:
                new_state, accepted = self._propose_impl_fused_sharded(
                    generator, state, ctx)
                return new_state, accepted, kernel_state
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

    def _propose_impl_fused_sharded(self, generator, state, ctx):
        """One fused stretch step on this rank's shard of a state sharded
        over a ``(temp, walker)`` mesh (``self.mesh_layout``).

        Every rank draws the step's permutation and uniforms at their
        global shape (:meth:`draw_fused`) from the same generator and keeps
        its temperatures' rows.  The kernels then run on walker-order views
        ``(nt, nwalkers, D)`` of the rank's temperatures: the rank's own
        walkers in place, and before each half the half's complement (the
        other half's walkers, the first half's merged) gathered from the
        walker shard that holds each (:meth:`~eryn_tpu_torch.parallel.mesh.
        MeshLayout.fill_rows`).  Kernel 1 proposes the whole half, the
        likelihood and prior run on the rank's walkers of it only, and
        kernel 2 accepts the half (with zeros for the other ranks'
        walkers, whose rows are discarded).  Kernels 1 and 2 run unfused:
        the complement of the second half is gathered between them.
        Returns ``(state, accepted)`` for the rank's shard."""
        lay = self.mesh_layout
        names = list(state.branches)
        self._check_walkers(state, names)
        logl = state.log_like.contiguous()
        logp = state.log_prior.contiguous()
        nt, nw, w0 = lay.nt, lay.nw, lay.w0
        NW = lay.nwalkers
        dtype, device = logl.dtype, logl.device
        perm, u_all = self.draw_fused(generator, lay.ntemps, NW, dtype, device)
        u_all = u_all[:, :, lay.t0:lay.t0 + nt].contiguous()
        betas = state.betas[lay.t0:lay.t0 + nt].contiguous()

        shapes = [(n, state.branches[n].nleaves_max, state.branches[n].ndim)
                  for n in names]
        parts = [state.branches[n].coords.reshape(nt, nw, -1) for n in names]
        X_loc = parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
        inds = state.branches_inds

        view, own = lay.walker_view, lay.own
        X = view(X_loc)
        ndim_act = view(active_ndim(state, names).to(dtype))
        L, P = view(logl), view(logp)

        def q_to_branches(q, ns):
            out, off = {}, 0
            for n, nl, nd in shapes:
                out[n] = q[..., off:off + nl * nd].reshape(nt, ns, nl, nd)
                off += nl * nd
            return out

        # the exchange plans are the permutation's: one host read a step
        order = perm.cpu().numpy()
        n0 = NW - NW // 2
        walkers = (order[:n0], order[n0:])

        def evaluate(q, half):
            """The half's new log-likelihood and log-prior, ``(nt, ns)``:
            evaluated on this rank's walkers, zeros elsewhere."""
            w = walkers[half]
            mine = np.flatnonzero((w >= w0) & (w < w0 + nw))
            ll = q.new_zeros(q.shape[:2])
            lp = q.new_zeros(q.shape[:2])
            if mine.size:
                pos = torch.as_tensor(mine, device=device)
                at = torch.as_tensor(w[mine] - w0, device=device)
                q_branches = q_to_branches(q[:, pos], mine.size)
                inds_blk = {n: inds[n][:, at] for n in names}
                lp_new = ctx.compute_log_prior(q_branches, inds_blk)
                ll_new, _ = ctx.compute_log_like(q_branches, inds_blk, lp_new)
                ll[:, pos] = ll_new
                lp[:, pos] = lp_new
            return ll, lp

        kw = dict(a=self.a, log_proposal=self.use_log_proposal)
        outs = (torch.empty_like(X), torch.empty_like(L),
                torch.empty_like(L), torch.empty_like(L))
        lay.fill_rows(X, X_loc, walkers[1])
        q, factors = stretch_propose(X, X, ndim_act, perm, u_all, 0, **kw)
        stretch_accept(q, X, *evaluate(q, 0), L, P, factors, betas, perm,
                       u_all, 0, *outs)
        X_out, logl_out, logp_out, accepted = outs
        lay.fill_rows(X_out, X_out[:, w0:w0 + nw], walkers[0])
        q, factors = stretch_propose(X, X_out, ndim_act, perm, u_all, 1, **kw)
        stretch_accept(q, X, *evaluate(q, 1), L, P, factors, betas, perm,
                       u_all, 1, *outs)

        new_state = state.replace(
            coords=q_to_branches(own(X_out), nw), inds=inds,
            log_like=own(logl_out), log_prior=own(logp_out),
        )
        return new_state, own(accepted)

    # ------------------------------------------------------------------
    # general path
    # ------------------------------------------------------------------
    def choose_c_vals(self, generator, c, ns):
        """Uniform random complement walker per proposed walker."""
        ntemps, nc = c.shape[:2]
        rint = self.rank_draw(
            lambda sh: torch.randint(0, nc, sh, generator=generator,
                                     device=c.device), (ntemps, ns))
        idx = rint[:, :, None, None].expand(ntemps, ns, *c.shape[2:])
        return torch.gather(c, 1, idx)

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None):
        names = list(s_coords)
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype, device = first.dtype, first.device

        # one z per walker, shared across branches
        u = self.rank_draw(
            lambda sh: torch.rand(sh, generator=generator, dtype=dtype,
                                  device=device), (ntemps, ns))
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
