"""Multiple-try Metropolis-Hastings from a generating distribution.

Port of :mod:`eryn_tpu.moves.mtdistgen`: ``num_try`` candidate vectors per
walker are drawn from the distribution, evaluated in one batched
likelihood call of ``ntemps x (nwalkers * num_try)`` walkers, picked by
their importance weights and accepted against the auxiliary set.  The
move targets one branch with ``nleaves_max == 1``.
"""

from __future__ import annotations

import torch

from ..prior import ProbDistContainer
from .move import merge_blobs, mh_decide, refuse_host_hooks, state_branch_supps
from .multipletry import MultipleTryMove, repeat_supps, repeat_walkers
from .tempering import tempered_log_likelihood

__all__ = ["MTDistGenMove"]


class MTDistGenMove(MultipleTryMove):
    """Multiple-try draw from ``generate_dist`` (``{branch:
    ProbDistContainer}``, its first branch the target; a container alone
    is the branch ``model_0``'s).  A subclass that defines ``eryn_tpu``'s
    host hooks (``special_like_func``, ``special_prior_func``,
    ``special_generate_func``, ``special_generate_logpdf``,
    ``get_proposal``) raises."""

    def __init__(self, generate_dist, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist_all = generate_dist
        self.key_in = list(generate_dist)[0]
        self.generate_dist = generate_dist[self.key_in]
        super().__init__(**kwargs)
        refuse_host_hooks(
            self,
            ("special_like_func", "special_prior_func",
             "special_generate_func", "special_generate_logpdf",
             "get_proposal"),
            "special_generate_kernel, special_generate_logpdf_kernel and "
            "mt_eval_kernel",
        )

    def init_kernel_state(self, state):
        self.prepare_constants(state)
        self.generate_dist.logpdf(self._current_target_coords(state))
        return ()

    def draw_tries(self, generator, state, num_try):
        """The tries ``(ntemps, nwalkers, num_try, ndim)`` drawn from the
        distribution."""
        ntemps, nwalkers = state.log_like.shape
        return self.generate_dist.sample(
            generator, (ntemps, nwalkers, num_try),
            dtype=state.branches[self.key_in].coords.dtype)

    def special_generate_kernel(self, generator, state, num_try):
        tries = self.draw_tries(generator, state, num_try)
        return tries, self.generate_dist.logpdf(tries)

    def special_generate_logpdf_kernel(self, state, coords=None):
        if coords is None:
            coords = self._current_target_coords(state)
        return self.generate_dist.logpdf(coords)

    def _current_target_coords(self, state):
        return state.branches[self.key_in].coords[:, :, 0]

    def _with_target_coords(self, state, coords):
        # the distribution ignores the current point, so the anchor is a
        # change of coordinates only
        new_coords = dict(state.branches_coords)
        new_coords[self.key_in] = coords[:, :, None, :]
        return state.replace(coords=new_coords, inds=dict(state.branches_inds))

    def mt_eval_kernel(self, ctx, state, tries):
        ntemps, nwalkers, num_try, ndim = tries.shape
        coords = {
            self.key_in: tries.reshape(ntemps, nwalkers * num_try, 1, ndim)
        }
        inds = {
            self.key_in: repeat_walkers(state.branches[self.key_in].inds, num_try)
        }
        for name, b in state.branches.items():
            if name == self.key_in:
                continue
            coords[name] = repeat_walkers(b.coords, num_try)
            inds[name] = repeat_walkers(b.inds, num_try)
        lp = ctx.compute_log_prior(coords, inds)
        ll, blobs = ctx.compute_log_like(
            coords, inds, lp, repeat_supps(state_branch_supps(state), num_try))
        if blobs is not None:
            blobs = blobs.reshape((ntemps, nwalkers, num_try)
                                  + blobs.shape[2:])
        return (ll.reshape(ntemps, nwalkers, num_try),
                lp.reshape(ntemps, nwalkers, num_try), blobs)

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        ntemps = state.log_like.shape[0]
        betas = state.betas
        if betas is None:
            betas = torch.ones(ntemps, dtype=state.log_like.dtype,
                               device=state.log_like.device)
        coords_out, ll_out, lp_out, factors, blobs_out = self.mt_select_kernel(
            generator, state, ctx)

        logP_new = tempered_log_likelihood(ll_out, betas) + lp_out
        logP_old = (tempered_log_likelihood(state.log_like, betas)
                    + state.log_prior)
        acc = mh_decide(self.draw_accept(generator, logP_new), factors,
                        logP_new, logP_old)

        coords = dict(state.branches_coords)
        coords[self.key_in] = torch.where(
            acc[:, :, None, None], coords_out[:, :, None, :],
            coords[self.key_in])
        new_state = state.replace(
            coords=coords, inds=dict(state.branches_inds),
            log_like=torch.where(acc, ll_out, state.log_like),
            log_prior=torch.where(acc, lp_out, state.log_prior),
            blobs=merge_blobs(acc, blobs_out, state.blobs),
        )
        return new_state, acc, kernel_state
