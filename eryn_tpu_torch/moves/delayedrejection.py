"""Delayed-rejection Metropolis-Hastings.

Port of :mod:`eryn_tpu.moves.delayedrejection` (the traced path).  Each
stage proposes from the previous stage's candidate with the wrapped
symmetric proposal; the stage-k acceptance is Mira's (2001) recursion over
the contiguous sub-paths of the candidate chain,

    alpha(z_0..z_m) = min(1, pi(z_m)/pi(z_0)
        * prod_j (1 - alpha(z_m..z_{m-j})) / prod_j (1 - alpha(z_0..z_j))),

memoised per sub-path.  Shapes are static: all ``max_iter + 1``
candidates are evaluated every step, and a walker accepts at its first
accepting stage.  Eryn's host protocol is here too: one stage on host
arrays (:meth:`DelayedRejection.dr_scheme`, :meth:`~DelayedRejection.
get_new_state`) and :class:`DelayedRejectionContainer`.

Every stage is per walker: on a state sharded over a device mesh the device
path runs on this rank's walkers, its draws and the wrapped proposal's at
their global shape, and exchanges nothing (where the wrapped proposal runs
sharded itself).
"""

from __future__ import annotations

import numpy as np
import torch

from .move import Move, merge_blobs, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["DelayedRejection", "DelayedRejectionContainer"]


class DelayedRejectionContainer:
    """Eryn's record of a delayed-rejection run: configuration attributes
    from the keywords, and the ``coords``, ``log_prob``, ``log_prior`` and
    ``alpha`` of each stage that :meth:`append` records."""

    def __init__(self, proposal=None, max_iter=10, **kwargs):
        self.proposal = proposal
        self.max_iter = max_iter
        for key, item in kwargs.items():
            setattr(self, key, item)
        self.coords = []
        self.log_prob = []
        self.log_prior = []
        self.alpha = []

    def append(self, new_coords, new_log_prob, new_log_prior, new_alpha):
        """Record one stage."""
        self.coords.append(new_coords)
        self.log_prob.append(new_log_prob)
        self.log_prior.append(new_log_prior)
        self.alpha.append(new_alpha)


def _host_log_posterior(move, state):
    """The tempered posterior of ``state`` on the host (untempered without
    a control)."""
    logl = np.asarray(state.log_like)
    logp = np.asarray(state.log_prior)
    tc = move.temperature_control
    if tc is None:
        return logl + logp
    return tc.compute_log_posterior_tempered(logl, logp)


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

    _mesh_sharded = True

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

    def mesh_ready(self):
        """None where this move and the wrapped proposal run sharded, else
        the first refusal."""
        return super().mesh_ready() or self.proposal.mesh_ready()

    def wire_mesh(self, layout):
        super().wire_mesh(layout)
        self.proposal.wire_mesh(layout)

    def propagate_wiring(self):
        if self.proposal.periodic is None:
            self.proposal.periodic = self.periodic
        if self.proposal.temperature_control is None:
            self.proposal.temperature_control = self.temperature_control

    # ------------------------------------------------------------------
    # Eryn's host protocol: one stage on host arrays
    # ------------------------------------------------------------------
    def get_new_state(self, model, state, keep):
        """A new candidate for every walker from the wrapped proposal (its
        host ``get_proposal``, or its kernel on a generator seeded from
        ``model.random``), the priors set to ``-inf`` off ``keep`` so that
        only those walkers' likelihoods are evaluated.  Returns
        ``(new_state, factors)`` on the host."""
        from ..state import State

        try:
            qn, factors = self.proposal.get_proposal(
                state.branches_coords, model.random,
                branches_inds=state.branches_inds)
        except NotImplementedError:
            coords = {n: torch.as_tensor(np.asarray(v))
                      for n, v in state.branches_coords.items()}
            inds = {n: torch.as_tensor(np.asarray(v)).bool()
                    for n, v in state.branches_inds.items()}
            gen = torch.Generator().manual_seed(
                int(model.random.randint(0, 2**31 - 1)))
            qn, factors, _ = self.proposal.get_proposal_kernel(
                gen, coords, inds, self.proposal.init_kernel_state(state))
        qn = {n: np.asarray(q) for n, q in qn.items()}
        logp = np.array(model.compute_log_prior_fn(
            qn, inds=state.branches_inds))
        keep = np.asarray(keep, dtype=bool)
        logp[~keep] = -np.inf
        logl, new_blobs = model.compute_log_like_fn(
            qn, inds=state.branches_inds, logp=logp)
        new_state = State(qn, log_like=np.asarray(logl), log_prior=logp,
                          blobs=new_blobs, inds=state.branches_inds,
                          supplemental=state.supplemental)
        return new_state, np.asarray(factors)

    def dr_scheme(self, state, new_state, keep_rejected, model, ntemps,
                  nwalkers, inds_for_change, inds=None, dr_iter=0):
        """One delayed-rejection stage on the host: new candidates from the
        rejected ones, the one-stage-back acceptance against the
        ``past_alpha`` entry of ``new_state``'s supplemental, and the
        freshly accepted walkers merged into ``state``.  Returns ``(state,
        new_accepted, new_state)``; ``new_state`` records ``alpha`` and
        ``past_alpha``."""
        from ..state import State

        randU = model.random.rand(ntemps, nwalkers)
        old_new_state = State(new_state, copy=True)
        new_state, log_proposal_ratio = self.get_new_state(
            model, new_state, np.asarray(keep_rejected, dtype=bool))
        logP = _host_log_posterior(self, new_state)
        prev_logP = _host_log_posterior(self, old_new_state)
        past_alpha = np.asarray(old_new_state.supplemental[:]["past_alpha"])
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            # -inf - -inf is NaN off the keep set: those walkers reject
            lndiff = logP - prev_logP + np.asarray(log_proposal_ratio)
            alpha_1 = np.minimum(np.exp(lndiff), 1.0)
            dr_alpha = np.exp(lndiff + np.log(1.0 - alpha_1)
                              - np.log(1.0 - past_alpha))
        dr_alpha = np.nan_to_num(np.minimum(dr_alpha, 1.0))
        new_state.supplemental["alpha"] = dr_alpha
        new_state.supplemental["past_alpha"] = dr_alpha
        new_accepted = np.logical_or(dr_alpha >= 1.0, randU < dr_alpha)
        state = self.update(state, new_state, new_accepted)
        return state, new_accepted, new_state

    def init_kernel_state(self, state):
        self.propagate_wiring()
        return self.proposal.init_kernel_state(state)

    def kernel_state_axes(self, kernel_state):
        return self.proposal.kernel_state_axes(kernel_state)

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        betas = self.rank_betas(state)
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
            u = self.draw_accept(generator, a, per_walker=True)
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
