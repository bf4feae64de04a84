"""Delayed-rejection Metropolis-Hastings.

Port of :mod:`eryn_tpu.moves.delayedrejection` (the traced path).  Each
stage proposes from the previous stage's candidate with the wrapped
symmetric proposal; the stage-k acceptance is Mira's (2001) recursion over
the contiguous sub-paths of the candidate chain,

    alpha(z_0..z_m) = min(1, pi(z_m)/pi(z_0)
        * prod_j (1 - alpha(z_m..z_{m-j})) / prod_j (1 - alpha(z_0..z_j))),

memoised per sub-path.  Shapes are static: all ``max_iter + 1``
candidates are evaluated every step, and a walker accepts at its first
accepting stage.  ``eryn_tpu``'s host-protocol shims (``get_new_state``,
``dr_scheme``, ``DelayedRejectionContainer``) are not ported (ROADMAP.md,
queue 1, item 9).
"""

from __future__ import annotations

import torch

from .move import Move, merge_blobs, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["DelayedRejection"]


class DelayedRejection(Move):
    """Delayed-rejection wrapper around a symmetric MH proposal.

    Args:
        proposal: a move with ``get_proposal_kernel(generator, coords,
            inds, kernel_state)`` whose proposal is symmetric per stage and
            that says so with ``symmetric_proposal = True`` (e.g.
            :class:`~eryn_tpu_torch.moves.gaussian.GaussianMove`): the
            recursion drops every proposal density.
        max_iter: stages after the first rejection.  Every step evaluates
            all ``max_iter + 1`` candidates.
    """

    def __init__(self, proposal, max_iter=3, **kwargs):
        super().__init__(**kwargs)
        if not getattr(proposal, "symmetric_proposal", False):
            raise ValueError(
                "DelayedRejection requires a symmetric wrapped proposal "
                "(its recursive acceptance drops all proposal densities). "
                f"{type(proposal).__name__} does not declare "
                "symmetric_proposal = True; use GaussianMove, or set the "
                "attribute on a custom move whose kernel is symmetric."
            )
        self.proposal = proposal
        self.max_iter = int(max_iter)

    def propagate_wiring(self):
        if self.proposal.periodic is None:
            self.proposal.periodic = self.periodic
        if self.proposal.temperature_control is None:
            self.proposal.temperature_control = self.temperature_control

    def init_kernel_state(self, state):
        self.propagate_wiring()
        return self.proposal.init_kernel_state(state)

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        ntemps = logl.shape[0]
        betas = state.betas
        if betas is None:
            betas = torch.ones(ntemps, dtype=logl.dtype, device=logl.device)
        names = self.proposal.run_branches(state)
        blobs = state.blobs
        supps = state_branch_supps(state)
        logP_x = tempered_log_likelihood(logl, betas) + logp

        # the candidate chain x -> y1 -> ... -> yK, each evaluated once
        chain_logP = [logP_x]
        chain_vals = []  # (q_full, log-likelihood, log-prior, blobs) each
        prev_q = coords
        for _stage in range(self.max_iter + 1):
            q, _factors, kernel_state = self.proposal.get_proposal_kernel(
                generator, {n: prev_q[n] for n in names},
                {n: inds[n] for n in names}, kernel_state,
            )
            q_full = {**prev_q, **q}
            lp_c = ctx.compute_log_prior(q_full, inds)
            ll_c, bl_c = ctx.compute_log_like(q_full, inds, lp_c, supps)
            chain_logP.append(tempered_log_likelihood(ll_c, betas) + lp_c)
            chain_vals.append((q_full, ll_c, lp_c, bl_c))
            prev_q = q_full

        # alpha[(s, e)]: acceptance of the sub-path z_s -> z_e
        alpha_cache = {}

        def alpha(s, e):
            if (s, e) in alpha_cache:
                return alpha_cache[(s, e)]
            m = abs(e - s)
            ld = chain_logP[e] - chain_logP[s]
            if m == 1:
                out = torch.exp(torch.clamp(ld, max=0.0))
            else:
                step = 1 if e > s else -1
                log_num = torch.zeros_like(ld)
                log_den = torch.zeros_like(ld)
                for j in range(1, m):
                    log_num = log_num + torch.log1p(-alpha(e, e - step * j))
                    log_den = log_den + torch.log1p(-alpha(s, s + step * j))
                out = torch.exp(torch.clamp(ld + log_num - log_den, max=0.0))
            out = torch.nan_to_num(out)  # NaN rejects
            alpha_cache[(s, e)] = out
            return out

        accepted = torch.zeros(logP_x.shape, dtype=torch.bool,
                               device=logl.device)
        for stage in range(1, self.max_iter + 2):
            a = alpha(0, stage)
            u = self.draw_accept(generator, a)
            q_full, ll_c, lp_c, bl_c = chain_vals[stage - 1]
            # only a walker's first accepting stage counts
            acc_now = ~accepted & (u < a)
            for n in names:
                coords[n] = torch.where(acc_now[:, :, None, None], q_full[n],
                                        coords[n])
            logl = torch.where(acc_now, ll_c, logl)
            logp = torch.where(acc_now, lp_c, logp)
            # a stage's blobs where that stage accepts
            blobs = merge_blobs(acc_now, bl_c, blobs)
            accepted = accepted | acc_now

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp,
            blobs=blobs,
        )
        return new_state, accepted, kernel_state
