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
global shape, the rank's temperatures' walkers exchanged within the
temperature shard, and the three launches of one process on them), or the
general path
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
        axis, so one launch covers all branches (:meth:`_fused_kernels`).

        Returns ``(state, accepted)`` with ``accepted`` in the state dtype.
        """
        names = list(state.branches)
        logl = state.log_like.contiguous()
        ntemps, nwalkers = logl.shape
        self._check_walkers(state, names)
        q_to_branches = self._unpacker(state, names, ntemps)
        inds = state.branches_inds
        betas = state.betas
        if betas is None:
            betas = torch.ones(ntemps, dtype=logl.dtype, device=logl.device)
        n0 = nwalkers - nwalkers // 2
        halves = (perm[:n0], perm[n0:])

        def evaluate(q, half):
            q_branches = q_to_branches(q, q.shape[1])
            inds_blk = {n: inds[n][:, halves[half]] for n in names}
            logp_new = ctx.compute_log_prior(q_branches, inds_blk)
            # blobs and supplementals take the general path (_can_fuse)
            logl_new, _ = ctx.compute_log_like(q_branches, inds_blk, logp_new)
            return logl_new.contiguous(), logp_new.contiguous()

        X_out, logl_out, logp_out, accepted = self._fused_kernels(
            self._packed(state, names, ntemps, nwalkers), logl,
            state.log_prior.contiguous(),
            active_ndim(state, names).to(logl.dtype), betas, perm, u_all,
            evaluate)
        new_state = state.replace(
            coords=q_to_branches(X_out, nwalkers), inds=inds,
            log_like=logl_out, log_prior=logp_out,
        )
        return new_state, accepted

    @staticmethod
    def _packed(state, names, nt, nw):
        """The branches' coordinates concatenated along the last axis,
        ``(nt, nw, D)``."""
        parts = [state.branches[n].coords.reshape(nt, nw, -1) for n in names]
        return (parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)
                ).contiguous()

    @staticmethod
    def _unpacker(state, names, nt):
        """The inverse of :meth:`_packed`: ``(q, ns)`` -> per-branch
        ``(nt, ns, nleaves_max, ndim)``."""
        shapes = [(n, state.branches[n].nleaves_max, state.branches[n].ndim)
                  for n in names]

        def q_to_branches(q, ns):
            out, off = {}, 0
            for n, nl, nd in shapes:
                out[n] = q[..., off:off + nl * nd].reshape(nt, ns, nl, nd)
                off += nl * nd
            return out

        return q_to_branches

    def _fused_kernels(self, X, logl, logp, ndim_act, betas, perm, u_all,
                       evaluate):
        """The fused step's three launches around the two halves'
        likelihood calls, on walker-order ``X`` ``(nt, nw, D)``, ``logl``,
        ``logp`` and ``ndim_act`` ``(nt, nw)``: ``stretch_propose`` (half
        0), ``stretch_accept_propose`` (accept half 0, propose half 1) and
        ``stretch_accept`` (half 1).  The kernels read the state through
        ``perm`` and merge each half in place into walker-order outputs,
        allocated once here; ``evaluate(q, half)`` gives the half's new
        ``(log-likelihood, log-prior)`` in half order.  Returns ``(X,
        logl, logp, accepted)``."""
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
        return outs

    def _propose_impl_fused_sharded(self, generator, state, ctx):
        """One fused stretch step on this rank's shard of a state sharded
        over a ``(temp, walker)`` mesh (``self.mesh_layout``).

        Every rank draws the step's permutation and uniforms at their
        global shape (:meth:`draw_fused`) from the same generator and keeps
        its temperatures' rows.  The three launches of one process
        (:meth:`_fused_kernels`) then run on every walker of the rank's
        temperatures, which one exchange within the temperature shard
        brings in (:meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.
        gather_walkers`: coordinates, log-likelihood, log-prior and leaf
        masks).  The likelihood and prior of a half run on the rank's
        walkers of it, ``min(nw, half)`` rows (:meth:`~eryn_tpu_torch.
        parallel.mesh.MeshLayout.own_positions`: a count of the mesh); the
        first half's results are exchanged (:meth:`~eryn_tpu_torch.
        parallel.mesh.MeshLayout.share_rows`), so every rank merges the
        whole first half as one process does and proposes the second from
        it; of the second only the rank's walkers are kept.  The
        permutation never leaves the device.  Returns ``(state,
        accepted)`` for the rank's shard."""
        lay = self.mesh_layout
        names = list(state.branches)
        self._check_walkers(state, names)
        nt, nw, NW = lay.nt, lay.nw, lay.nwalkers
        logl = state.log_like
        dtype, device = logl.dtype, logl.device
        perm, u_all = self.draw_fused(generator, lay.ntemps, NW, dtype, device)
        u_all = u_all[:, :, lay.t0:lay.t0 + nt].contiguous()
        betas = state.betas[lay.t0:lay.t0 + nt].contiguous()
        q_to_branches = self._unpacker(state, names, nt)
        X, L, P, *masks = lay.gather_walkers(
            [self._packed(state, names, nt, nw), logl, state.log_prior]
            + [state.branches_inds[n] for n in names])
        inds = dict(zip(names, masks))
        ndim_act = sum(inds[n].sum(dim=-1) * state.branches[n].ndim
                       for n in names).to(dtype)
        n0 = NW - NW // 2
        halves = (perm[:n0], perm[n0:])

        def evaluate(q, half):
            """The half's new log-likelihood and log-prior ``(nt, ns)``:
            every walker's after the first half, the rank's walkers' (zeros
            elsewhere) after the second."""
            walkers = halves[half]
            pos, valid = lay.own_positions(walkers)
            at = walkers[pos]
            q_branches = q_to_branches(q[:, pos], pos.shape[0])
            inds_blk = {n: inds[n][:, at] for n in names}
            lp = ctx.compute_log_prior(q_branches, inds_blk)
            ll, _ = ctx.compute_log_like(q_branches, inds_blk, lp)
            if lay.wp == 1:
                return ll.contiguous(), lp.contiguous()
            if half == 0:
                ll, lp = lay.share_rows([ll, lp], walkers, pos, valid)
                return ll.contiguous(), lp.contiguous()
            out = []
            for v in (ll, lp):
                full = v.new_zeros(q.shape[:2])
                full[:, pos] = torch.where(valid, v, 0.0)
                out.append(full)
            return out

        X_out, logl_out, logp_out, accepted = self._fused_kernels(
            X, L, P, ndim_act, betas, perm, u_all, evaluate)
        own = lay.own
        new_state = state.replace(
            coords=q_to_branches(own(X_out), nw),
            inds=state.branches_inds, log_like=own(logl_out),
            log_prior=own(logp_out),
        )
        return new_state, own(accepted)

    def adjust_factors(self, factors, ndims_old, ndims_new):
        """Eryn's Gibbs dimension correction: ``log z`` factors rescaled
        from ``ndims_old - 1`` to ``ndims_new - 1`` dimensions.  For code
        written against Eryn: the package's proposals already count the
        active dimensions of the masks, so it is never applied to them."""
        logzz = factors / (ndims_old - 1.0)
        return logzz * (ndims_new - 1.0)

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
