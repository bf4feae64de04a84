"""Multiple-try Metropolis-Hastings from a generating distribution.

Port of :mod:`eryn_tpu.moves.mtdistgen`: ``num_try`` candidate vectors per
walker are drawn from the distribution, evaluated in one batched
likelihood call of ``ntemps x (nwalkers * num_try)`` walkers, picked by
their importance weights and accepted against the auxiliary set.  The
move targets one branch with ``nleaves_max == 1``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..prior import ProbDistContainer
from .move import (
    merge_blobs,
    mh_decide,
    overrides_host_api,
    state_branch_supps,
    stock_host_api,
)
from .multipletry import MultipleTryMove, repeat_supps, repeat_walkers
from .tempering import tempered_log_likelihood

__all__ = ["MTDistGenMove"]


class MTDistGenMove(MultipleTryMove):
    """Multiple-try draw from ``generate_dist`` (``{branch:
    ProbDistContainer}``, its first branch the target; a container alone
    is the branch ``model_0``'s).  A subclass that writes Eryn's host hooks
    (``special_like_func``, ``special_prior_func``,
    ``special_generate_func``, ``special_generate_logpdf``,
    ``get_proposal``) is a host move of the whole-ensemble family: the
    stock hooks below fill in the ones it leaves."""

    _mesh_sharded = True

    def __init__(self, generate_dist, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist_all = generate_dist
        self.key_in = list(generate_dist)[0]
        self.generate_dist = generate_dist[self.key_in]
        super().__init__(**kwargs)
        if any(overrides_host_api(self, hook) for hook in (
                "special_like_func", "special_prior_func",
                "special_generate_func", "special_generate_logpdf",
                "get_proposal")):
            self.host_move = True
            self._legacy_family = "mh"

    # ------------------------------------------------------------------
    # the stock hooks of Eryn's host protocol
    # ------------------------------------------------------------------
    @stock_host_api
    def special_generate_logpdf(self, generated_coords):
        """The proposal log-density of host points under the
        distribution."""
        from .legacy import host_logpdf

        return host_logpdf(self.generate_dist, generated_coords)

    @stock_host_api
    def special_generate_func(self, coords, random, size=1, fill_tuple=None,
                              fill_values=None, **kwargs):
        """``size`` tries per point drawn from the distribution (with the
        host ``random``) and their log-density."""
        from .legacy import host_rvs

        nwalkers = coords.shape[0]
        if not isinstance(size, int):
            raise ValueError("size must be an int.")
        generated = host_rvs(self.generate_dist, random, (nwalkers, size))
        if fill_values is not None:
            generated[fill_tuple] = fill_values
        logpdf = self.special_generate_logpdf(
            generated.reshape(nwalkers * size, -1)).reshape(nwalkers, size)
        return generated, logpdf

    @stock_host_api
    def set_coords_and_inds(self, generated_coords):
        """The coordinates that evaluate the flattened tries: the target
        branch holds the tries, every other branch its walkers' leaves
        repeated per try."""
        ndim = self.current_state.branches[self.key_in].shape[-1]
        n_all = generated_coords.reshape(-1, ndim).shape[0]
        coords_in = {
            self.key_in: generated_coords.reshape(-1, 1, ndim)[None]}
        for key, branch in self.current_state.branches.items():
            if key == self.key_in:
                continue
            flat = np.asarray(branch.coords).reshape(
                (-1,) + tuple(branch.shape[-2:]))
            coords_in[key] = np.repeat(flat, n_all // flat.shape[0],
                                       axis=0)[None]
        return coords_in

    @stock_host_api
    def special_like_func(self, generated_coords, **kwargs):
        """The likelihood of each try through the sampler's."""
        coords_in = self.set_coords_and_inds(generated_coords)
        ll = self.current_model.compute_log_like_fn(coords_in)[0]
        return np.asarray(ll)[0].reshape(-1, self.num_try)

    @stock_host_api
    def special_prior_func(self, generated_coords, **kwargs):
        """The prior of each try through the sampler's."""
        coords_in = self.set_coords_and_inds(generated_coords)
        lp = self.current_model.compute_log_prior_fn(coords_in)
        return np.asarray(lp).reshape(-1, self.num_try)

    def init_kernel_state(self, state):
        self.prepare_constants(state)
        self.generate_dist.logpdf(self._current_target_coords(state))
        return ()

    def draw_tries(self, generator, state, num_try):
        """The tries ``(ntemps, nwalkers, num_try, ndim)`` drawn from the
        distribution, per walker."""
        ntemps, nwalkers = state.log_like.shape
        dtype = state.branches[self.key_in].coords.dtype
        return self.rank_draw(
            lambda sh: self.generate_dist.sample(generator, sh, dtype=dtype),
            (ntemps, nwalkers, num_try), per_walker=True)

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
        betas = self.rank_betas(state)
        coords_out, ll_out, lp_out, factors, blobs_out = self.mt_select_kernel(
            generator, state, ctx)

        logP_new = tempered_log_likelihood(ll_out, betas) + lp_out
        logP_old = (tempered_log_likelihood(state.log_like, betas)
                    + state.log_prior)
        acc = mh_decide(self.draw_accept(generator, logP_new, per_walker=True),
                        factors, logP_new, logP_old)

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
