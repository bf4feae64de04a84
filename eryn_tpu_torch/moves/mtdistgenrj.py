"""Multiple-try reversible jump from a generating distribution.

Port of :mod:`eryn_tpu.moves.mtdistgenrj`.  For every walker one batch
evaluates the "one leaf less" base state and ``num_try`` candidate leaves at
the proposed slot; a birth picks among the candidates by their importance
weights, a death takes the removed leaf as try 0 and inverts the factors.
The acceptance reduces to the multiple-try ratio ``logsumexp(w) -
(beta * ll_base + log num_try)`` of a birth (inverted for a death), plus
the edge factors of the leaf-count range.  Leaves are read at the slot by a
one-hot reduce over the leaf axis.

Every walker's change is its own: on a state sharded over a device mesh the
move runs on this rank's walkers, every draw per walker at its global
shape, and exchanges nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..prior import ProbDistContainer
from .distgenrj import DistributionGenerateRJ
from .move import (
    merge_blobs,
    mh_decide,
    overrides_host_api,
    state_branch_supps,
    stock_host_api,
)
from .multipletry import (
    MultipleTryMove,
    MultipleTryMoveRJ,
    categorical_pick,
    gumbel_from_uniform,
    logsumexp,
    pick_try,
    pick_try_blobs,
    repeat_supps,
    repeat_walkers,
)
from .rj import ReversibleJumpMove, rj_change_kernel
from .tempering import tempered_log_likelihood

__all__ = ["MTDistGenMoveRJ"]


class MTDistGenMoveRJ(ReversibleJumpMove):
    """Multiple-try birth/death move.

    Args:
        generate_dist: ``{branch_name: ProbDistContainer}`` to draw the
            tries from (a container alone is the branch ``model_0``'s).
        num_try: tries per walker.
        Remaining keywords as
        :class:`~eryn_tpu_torch.moves.rj.ReversibleJumpMove`.
    """

    _mesh_sharded = True

    def __init__(self, generate_dist, *args, num_try=1, rj=True, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            generate_dist = {"model_0": generate_dist}
        self.generate_dist = generate_dist
        self.num_try = int(num_try)
        # the multiple-try flags: reversible jump forbids the symmetric and
        # independent forms
        self.independent = False
        self.symmetric = False
        self.mt_rj = True
        super().__init__(*args, **kwargs)
        if any(overrides_host_api(self, hook) for hook in (
                "special_like_func", "special_prior_func",
                "special_generate_func", "special_generate_logpdf")):
            self.host_move = True
            self._legacy_family = "rj"

    # ------------------------------------------------------------------
    # Eryn's host protocol: the multiple-try machinery of MultipleTryMove and
    # MultipleTryMoveRJ (the same functions), the slots of
    # DistributionGenerateRJ, and the stock hooks below
    # ------------------------------------------------------------------
    get_mt_log_posterior = MultipleTryMove.get_mt_log_posterior
    readout_adjustment = MultipleTryMove.readout_adjustment
    get_mt_proposal = MultipleTryMove.get_mt_proposal
    get_proposal = MultipleTryMoveRJ.get_proposal
    get_model_change_proposal = DistributionGenerateRJ.get_model_change_proposal

    @stock_host_api
    def special_generate_logpdf(self, generated_coords):
        """The proposal log-density under the branch's distribution."""
        from .legacy import host_logpdf

        return host_logpdf(self.generate_dist[self.key_in], generated_coords)

    @stock_host_api
    def special_generate_func(self, coords, random, size=1, fill_tuple=None,
                              fill_values=None, **kwargs):
        """``size`` tries per walker from the branch's distribution; a
        remover's removed leaf fills its try slot 0 (``fill_tuple``)."""
        from .legacy import host_rvs

        nwalkers = coords.shape[0]
        if not isinstance(size, int):
            raise ValueError("size must be an int.")
        generated = host_rvs(self.generate_dist[self.key_in], random,
                             (nwalkers, size))
        if fill_values is not None:
            generated[fill_tuple] = fill_values
        logpdf = self.special_generate_logpdf(
            generated.reshape(nwalkers * size, -1)).reshape(nwalkers, size)
        return generated, logpdf

    @stock_host_api
    def set_coords_and_inds(self, generated_coords, inds_leaves_rj=None):
        """The coordinates and masks that evaluate the flattened tries:
        each walker repeated ``num_try`` times with its changing leaf set to
        the try and switched on."""
        st = self.current_state
        bc = np.asarray(st.branches[self.key_in].coords)
        bi = np.asarray(st.branches[self.key_in].inds)
        nl, nd = bc.shape[-2:]
        n_all = bc.shape[0] * bc.shape[1]
        coords_in = np.repeat(bc.reshape(-1, nl, nd), self.num_try, axis=0)
        inds_in = np.repeat(bi.reshape(-1, nl), self.num_try, axis=0)
        rows = np.arange(n_all * self.num_try)
        leaves = np.repeat(np.asarray(inds_leaves_rj, dtype=int),
                           self.num_try)
        coords_in[rows, leaves] = np.asarray(generated_coords).reshape(-1, nd)
        inds_in[rows, leaves] = True
        coords_dict = {self.key_in: coords_in[None]}
        inds_dict = {self.key_in: inds_in[None]}
        for key, branch in st.branches.items():
            if key == self.key_in:
                continue
            okc = np.asarray(branch.coords).reshape(
                (-1,) + tuple(branch.shape[-2:]))
            oki = np.asarray(branch.inds).reshape(-1, branch.shape[-2])
            coords_dict[key] = np.repeat(okc, self.num_try, axis=0)[None]
            inds_dict[key] = np.repeat(oki, self.num_try, axis=0)[None]
        return coords_dict, inds_dict

    @stock_host_api
    def special_like_func(self, generated_coords, inds_leaves_rj=None,
                          **kwargs):
        """The likelihood of each try with the changing leaf set to it."""
        coords_in, inds_in = self.set_coords_and_inds(
            generated_coords, inds_leaves_rj=inds_leaves_rj)
        ll = self.current_model.compute_log_like_fn(coords_in,
                                                    inds=inds_in)[0]
        return np.asarray(ll)[0].reshape(-1, self.num_try)

    @stock_host_api
    def special_prior_func(self, generated_coords, inds_leaves_rj=None,
                           **kwargs):
        """The prior of each try with the changing leaf set to it."""
        coords_in, inds_in = self.set_coords_and_inds(
            generated_coords, inds_leaves_rj=inds_leaves_rj)
        lp = self.current_model.compute_log_prior_fn(coords_in, inds=inds_in)
        return np.asarray(lp).reshape(-1, self.num_try)

    def run_branches(self, state):
        names = super().run_branches(state)
        return [n for n in names if n in self.generate_dist]

    def init_kernel_state(self, state):
        self.prepare_constants(state)
        for name, dist in self.generate_dist.items():
            if name in state.branches:
                dist.logpdf(state.branches[name].coords)
        return ()

    def draw_mtrj(self, generator, name, coords):
        """Randomness of one branch's proposal: the change uniforms ``(nt,
        nw)``, the slot keys ``(nt, nw, nleaves_max)``, the tries ``(nt, nw,
        num_try, ndim)`` and the pick's Gumbel noise ``(nt, nw,
        num_try)``, every one per walker."""
        nt, nw, nl, _ = coords.shape
        kw = dict(generator=generator, dtype=coords.dtype,
                  device=coords.device)

        def rand(shape):
            return self.rank_draw(lambda sh: torch.rand(sh, **kw), shape,
                                  per_walker=True)

        u_change = rand((nt, nw))
        slot_keys = rand((nt, nw, nl))
        tries = self.rank_draw(
            lambda sh: self.generate_dist[name].sample(generator, sh,
                                                       dtype=coords.dtype),
            (nt, nw, self.num_try), per_walker=True)
        gumbel = gumbel_from_uniform(rand((nt, nw, self.num_try)))
        return u_change, slot_keys, tries, gumbel

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        names = []
        for split_names, _masks in self.gibbs_iterations_for(state):
            names.extend(n for n in split_names if n not in names)
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        blobs = state.blobs
        supps = state_branch_supps(state)
        ntemps, nwalkers = logl.shape
        betas = self.rank_betas(state)
        T = self.num_try
        accepted = torch.zeros((ntemps, nwalkers), dtype=logl.dtype,
                               device=logl.device)

        for name in names:
            dist = self.generate_dist[name]
            c = coords[name]
            m = inds[name]
            nt, nw, nl, nd = c.shape

            u_change, slot_keys, tries, gumbel = self.draw_mtrj(
                generator, name, c)
            change, slot, _ = rj_change_kernel(
                u_change, slot_keys, m, self.nleaves_min[name],
                self.nleaves_max[name], self.fix_change,
            )
            leaf = torch.arange(nl, device=c.device)
            slot_onehot = leaf == slot[:, :, None]
            inds_without = m & ~slot_onehot
            inds_with = inds_without | slot_onehot

            # the base ("one leaf less") state
            base_inds = {**inds, name: inds_without}
            lp_without = ctx.compute_log_prior(coords, base_inds)
            ll_without, blobs_without = ctx.compute_log_like(
                coords, base_inds, lp_without, supps)

            # deaths take the removed leaf as try 0
            at_slot = torch.where(slot_onehot[..., None], c, 0.0).sum(dim=2)
            is_death = (change == -1)[:, :, None, None]
            try0 = (torch.arange(T, device=c.device) == 0)[None, None, :, None]
            tries = torch.where(is_death & try0, at_slot[:, :, None, :], tries)

            # every try at the slot, the base leaves active
            coords_rep = {n2: repeat_walkers(coords[n2], T)
                          for n2 in coords}
            inds_rep = {n2: repeat_walkers(base_inds[n2], T)
                        for n2 in inds}
            slot_rep = repeat_walkers(slot, T)
            slot_mask_rep = leaf == slot_rep[:, :, None]
            tries_rep = tries.reshape(nt, nw * T, nd)[:, :, None, :]
            coords_rep[name] = torch.where(slot_mask_rep[..., None],
                                           tries_rep, coords_rep[name])
            inds_rep[name] = inds_rep[name] | slot_mask_rep
            lp_try = ctx.compute_log_prior(coords_rep, inds_rep)
            ll_try, blobs_try = ctx.compute_log_like(
                coords_rep, inds_rep, lp_try, repeat_supps(supps, T))
            lp_try = lp_try.reshape(nt, nw, T)
            ll_try = ll_try.reshape(nt, nw, T)
            if blobs_try is not None:
                blobs_try = blobs_try.reshape((nt, nw, T) + blobs_try.shape[2:])

            # importance weights; the base prior in the proposal density
            # cancels the existing leaves' priors
            logq = dist.logpdf(tries) + lp_without[:, :, None]
            logP_try = (tempered_log_likelihood(ll_try, betas[:, None, None])
                        + lp_try)
            logw = logP_try - logq
            log_sum_w = logsumexp(logw, axis=-1)

            j, _ = categorical_pick(logw, gumbel)
            j = torch.where(change == -1, 0, j)  # deaths keep the removed leaf
            one_hot = torch.arange(T, device=c.device) == j[:, :, None]
            ll_chosen = pick_try(one_hot, ll_try)
            lp_chosen = pick_try(one_hot, lp_try)
            logP_chosen = pick_try(one_hot, logP_try)
            try_chosen = torch.where(one_hot[..., None], tries, 0.0).sum(dim=2)

            # the auxiliary set: num_try copies of the base state
            base_logP = tempered_log_likelihood(ll_without, betas) + lp_without
            aux_log_sum_w = (tempered_log_likelihood(ll_without, betas)
                             + math.log(T))
            factors_birth = ((base_logP - aux_log_sum_w)
                             - (logP_chosen - log_sum_w))
            birth = change == 1
            death = change == -1
            factors = torch.where(birth, factors_birth,
                                  torch.where(death, -factors_birth, 0.0))
            nleaves = m.sum(dim=-1)
            factors = factors + self._edge_factors(
                name, nleaves,
                torch.where(birth, inds_with.sum(dim=-1),
                            torch.where(death, inds_without.sum(dim=-1),
                                        nleaves)),
                logl.dtype,
            )

            new_inds_branch = torch.where(
                birth[:, :, None], inds_with,
                torch.where(death[:, :, None], inds_without, m))
            new_coords_branch = torch.where(
                (birth[:, :, None] & slot_onehot)[..., None],
                try_chosen[:, :, None, :], c)
            ll_new = torch.where(birth, ll_chosen,
                                 torch.where(death, ll_without, logl))
            lp_new = torch.where(birth, lp_chosen,
                                 torch.where(death, lp_without, logp))
            # a birth takes the chosen try's blobs, a death the base state's
            blobs_new = merge_blobs(
                birth, pick_try_blobs(j, blobs_try),
                merge_blobs(death, blobs_without, blobs))

            logP_new = tempered_log_likelihood(ll_new, betas) + lp_new
            logP_old = tempered_log_likelihood(logl, betas) + logp
            acc = mh_decide(
                self.draw_accept(generator, logP_new, per_walker=True),
                factors, logP_new, logP_old)
            acc = acc & (change != 0)

            coords[name] = torch.where(acc[:, :, None, None],
                                       new_coords_branch, c)
            inds[name] = torch.where(acc[:, :, None], new_inds_branch, m)
            logl = torch.where(acc, ll_new, logl)
            logp = torch.where(acc, lp_new, logp)
            blobs = merge_blobs(acc, blobs_new, blobs)
            accepted = accepted + acc

        new_state = state.replace(
            coords=coords, inds=inds, log_like=logl, log_prior=logp,
            blobs=blobs,
        )
        return new_state, accepted, kernel_state
