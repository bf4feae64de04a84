"""Multiple-try Metropolis machinery.

Port of :mod:`eryn_tpu.moves.multipletry` (the traced path).  The
``num_try`` axis is one more batch dimension: the tries, their importance
weights ``logP - logq``, the pick and the auxiliary set that keeps detailed
balance are vector ops over ``(ntemps, nwalkers, num_try)``, and the tries'
likelihoods are one batched evaluation with the tries folded into the
walker axis.  The pick is ``jax.random.categorical``'s: the argmax of the
weights plus Gumbel noise, which the port makes from uniform draws of the
sampler's generator.

With the factors below, ``factors + logP_new - logP_old`` reduces to
``logsumexp(w) - logsumexp(w_aux)``.

Every walker's tries, pick and auxiliary set are its own: on a state
sharded over a device mesh the machinery runs on this rank's walkers, the
tries and the pick's noise drawn per walker at their global shape
(:meth:`~eryn_tpu_torch.moves.move.Move.rank_draw`), and exchanges nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from .move import Move, stock_host_api
from .tempering import tempered_log_likelihood

__all__ = [
    "MultipleTryMove",
    "MultipleTryMoveRJ",
    "categorical_pick",
    "get_mt_computations",
    "gumbel_from_uniform",
    "logsumexp",
    "repeat_walkers",
]


def logsumexp(a, axis=None):
    """Stable ``log(sum(exp(a)))`` over ``axis`` (all entries when None);
    ``-inf`` where every term is ``-inf``."""
    if axis is None:
        return torch.logsumexp(a.reshape(-1), dim=0)
    return torch.logsumexp(a, dim=axis)


def get_mt_computations(logP, log_proposal_pdf, symmetric=False, xp=None,
                        random=None):
    """Importance weights and the try picked per batch row, on host arrays:
    ``eryn_tpu``'s public helper with its signature, drawing the pick's
    uniforms from ``random`` (a ``numpy.random.RandomState``; by default
    NumPy's global generator, as ``eryn_tpu`` does).

    ``logP`` and ``log_proposal_pdf`` are ``(nbatch, num_try)``.  Returns
    ``(log_importance_weights, log_sum_weights, inds_keep)``.
    """
    if xp is None:
        xp = np
    logP = xp.asarray(logP)
    if symmetric:
        log_importance_weights = logP
    else:
        log_importance_weights = logP - xp.asarray(log_proposal_pdf)
    max_w = xp.max(log_importance_weights, axis=-1)
    log_sum_weights = max_w + xp.log(
        xp.exp(log_importance_weights - max_w[:, None]).sum(axis=-1)
    )
    probs = xp.exp(log_importance_weights - log_sum_weights[:, None])
    u = xp.asarray((np.random if random is None else random).rand(
        probs.shape[0]))
    inds_keep = (probs.cumsum(1) > u[:, None]).argmax(1)
    return log_importance_weights, log_sum_weights, inds_keep


def gumbel_from_uniform(u):
    """Standard Gumbel noise from uniforms on ``[0, 1)``, as
    ``jax.random.gumbel`` makes it: ``-log(-log(u))`` with ``u`` held at
    or above the dtype's smallest normal number."""
    tiny = torch.finfo(u.dtype).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def categorical_pick(logw, gumbel):
    """The categorical draw over the last axis of ``logw``, as
    ``jax.random.categorical`` takes it: the argmax of ``logw + gumbel``,
    the first of equal maxima; a row that is ``-inf`` throughout picks 0.
    Returns ``(index, one_hot)``."""
    scores = logw + gumbel
    best = scores.max(dim=-1, keepdim=True).values
    is_best = scores == best
    first = is_best & (torch.cumsum(is_best.to(torch.int32), dim=-1) == 1)
    iota = torch.arange(logw.shape[-1], device=logw.device)
    j = torch.where(first, iota, 0).sum(dim=-1)
    return j, iota == j[..., None]


def repeat_walkers(x, num_try):
    """Each walker of ``x`` ``(ntemps, nwalkers, ...)`` repeated
    ``num_try`` times in place, ``(ntemps, nwalkers * num_try, ...)``: the
    layout of the tries folded into the walker axis."""
    nt, nw = x.shape[:2]
    return x.unsqueeze(2).expand(nt, nw, num_try, *x.shape[2:]).reshape(
        nt, nw * num_try, *x.shape[2:])


def repeat_supps(supps, num_try):
    """:func:`~eryn_tpu_torch.moves.move.state_branch_supps` output with
    each walker repeated ``num_try`` times, as :func:`repeat_walkers`."""
    if supps is None:
        return None
    return {n: {k: repeat_walkers(v, num_try) for k, v in h.items()}
            for n, h in supps.items()}


def pick_try(one_hot, x):
    """The entry of ``x`` ``(..., num_try)`` at the picked try."""
    return torch.where(one_hot, x, 0.0).sum(dim=-1)


def pick_try_blobs(j, blobs):
    """The blobs ``(ntemps, nwalkers, num_try, ...)`` of the tries ``j``
    ``(ntemps, nwalkers)``, as they are; None stays None."""
    if blobs is None:
        return None
    idx = j.reshape(j.shape + (1,) * (blobs.ndim - 2))
    idx = idx.expand(j.shape + (1,) + blobs.shape[3:])
    return torch.gather(blobs, 2, idx).squeeze(2)


def unpack_eval(out):
    """``(ll, lp, blobs)`` of an ``mt_eval_kernel`` result, which may
    leave the blobs out."""
    return tuple(out) if len(out) == 3 else (*out, None)


class MultipleTryMove(Move):
    """Multiple-try base.

    Subclasses provide:

    * ``special_generate_kernel(generator, state, num_try) -> (tries,
      logq)``: ``tries`` ``(ntemps, nwalkers, num_try, ndim)`` and their
      proposal log-density ``(ntemps, nwalkers, num_try)``, the proposal
      anchored on ``state``'s current coordinates;
    * ``special_generate_logpdf_kernel(state, coords=None) -> (ntemps,
      nwalkers)``: the proposal log-density of ``coords`` (default: the
      current target coordinates) under the proposal anchored on ``state``;
    * ``mt_eval_kernel(ctx, state, tries) -> (ll, lp, blobs)`` per try
      (``blobs`` ``(ntemps, nwalkers, num_try, ...)`` or None; ``(ll,
      lp)`` is taken too);
    * ``_current_target_coords(state)`` and, for a state-dependent
      proposal with ``independent=False``, ``_with_target_coords(state,
      coords)``.

    Args:
        num_try: tries per walker.
        independent: the proposal does not depend on the current point.
        symmetric: symmetric proposal (the weights are ``logP`` alone).
    """

    def __init__(self, num_try=1, independent=False, symmetric=False,
                 rj=False, **kwargs):
        super().__init__(**kwargs)
        self.num_try = int(num_try)
        self.independent = independent
        self.symmetric = symmetric
        self.mt_rj = rj
        if rj and (symmetric or independent):
            raise ValueError(
                "If rj==True, symmetric and independent must both be False."
            )

    # ------------------------------------------------------------------
    # Eryn's host protocol: a subclass writes the special_* hooks on NumPy
    # arrays, and the stock get_mt_proposal drives them
    # ------------------------------------------------------------------
    @stock_host_api
    def special_like_func(self, generated_coords, *args, inds_leaves_rj=None,
                          **kwargs):
        """Host hook: the likelihood of each try, ``(nbatch, num_try)``."""
        raise NotImplementedError

    @stock_host_api
    def special_prior_func(self, generated_coords, *args, **kwargs):
        """Host hook: the prior of each try, ``(nbatch, num_try)``."""
        raise NotImplementedError

    @stock_host_api
    def special_generate_func(self, coords, random, size=1, *args,
                              fill_tuple=None, fill_values=None, **kwargs):
        """Host hook: ``size`` tries per point of ``coords`` and their
        proposal log-density."""
        raise NotImplementedError

    @stock_host_api
    def special_generate_logpdf(self, coords):
        """Host hook: the proposal log-density of ``coords``."""
        raise NotImplementedError

    def get_mt_log_posterior(self, ll, lp, betas=None):
        """The tempered posterior of the tries (``betas`` per batch row)."""
        ll = np.asarray(ll)
        if betas is not None:
            betas = np.asarray(betas)
            ll = betas[..., None] * ll if ll.ndim > betas.ndim else betas * ll
        return ll + np.asarray(lp)

    def readout_adjustment(self, out_vals, all_vals_prop, aux_all_vals):
        """Hook reading the proposal's internals; nothing by default."""

    def get_mt_proposal(self, coords, random, args_generate=(),
                        kwargs_generate={}, args_like=(), kwargs_like={},
                        args_prior=(), kwargs_prior={}, betas=None,
                        ll_in=None, lp_in=None, inds_leaves_rj=None,
                        inds_reverse_rj=None):
        """The multiple-try proposal of flat independent points ``coords``
        ``(nbatch, ndim)`` on the host: ``num_try`` tries each through the
        ``special_*`` hooks, one picked by its importance weight with
        ``random``, and the auxiliary set (the tries themselves with the
        current point in the picked slot when ``independent``; the one leaf
        less model under reversible jump; tries drawn anew from the picked
        point with the current point in its slot otherwise, the standard
        multiple-try construction, where ``eryn_tpu``'s reference names an
        undefined variable).  Sets ``mt_ll``, ``mt_lp`` and the readouts;
        returns ``(chosen points, factors)``."""
        import warnings

        rj = getattr(self, "mt_rj", False)
        if rj:
            if (ll_in is None or lp_in is None or inds_leaves_rj is None
                    or inds_reverse_rj is None):
                raise ValueError(
                    "If using rj, must provide ll_in, lp_in, "
                    "inds_leaves_rj, and inds_reverse_rj.")
            fill_tuple = (inds_reverse_rj, np.zeros_like(inds_reverse_rj))
            fill_values = coords[inds_reverse_rj]
        else:
            fill_tuple = fill_values = None

        generated_points, log_proposal_pdf = self.special_generate_func(
            coords, random, *args_generate, size=self.num_try,
            fill_values=fill_values, fill_tuple=fill_tuple, **kwargs_generate)
        generated_points = np.asarray(generated_points)
        log_proposal_pdf = np.asarray(log_proposal_pdf, dtype=np.float64)
        ll = np.asarray(self.special_like_func(
            generated_points, *args_like, inds_leaves_rj=inds_leaves_rj,
            **kwargs_like), dtype=np.float64)
        if np.any(np.isnan(ll)):
            warnings.warn("Getting nans for ll in multiple try.")
            ll[np.isnan(ll)] = -1e300
        lp = np.asarray(self.special_prior_func(
            generated_points, *args_prior, inds_leaves_rj=inds_leaves_rj,
            **kwargs_prior), dtype=np.float64)
        if rj:
            # the proposal density of a leaf that exists is its prior
            log_proposal_pdf = log_proposal_pdf + lp_in[:, None]
        logP = self.get_mt_log_posterior(ll, lp, betas=betas)

        _, log_sum_weights, inds_keep = get_mt_computations(
            logP, log_proposal_pdf, symmetric=self.symmetric, random=random)
        inds_keep = np.asarray(inds_keep)
        if rj:
            inds_keep[np.asarray(inds_reverse_rj)] = 0
        inds_tuple = (np.arange(len(inds_keep)), inds_keep)
        lp_out, ll_out, logP_out = lp[inds_tuple], ll[inds_tuple], \
            logP[inds_tuple]
        self.mt_lp, self.mt_ll = lp_out, ll_out
        generated_points_out = generated_points[inds_tuple].copy()
        log_proposal_pdf_out = log_proposal_pdf[inds_tuple]

        if self.independent:
            aux_ll, aux_lp = ll.copy(), lp.copy()
            aux_log_proposal_pdf_sub = np.asarray(
                self.special_generate_logpdf(coords))
            if ll_in is None:
                if not hasattr(self, "special_generate_like"):
                    raise ValueError(
                        "independent=True requires ll_in (or a "
                        "special_generate_like hook) for the current "
                        "points' likelihood.")
                ll_in = np.asarray(self.special_generate_like(coords))
            if lp_in is None:
                if not hasattr(self, "special_generate_prior"):
                    raise ValueError(
                        "independent=True requires lp_in (or a "
                        "special_generate_prior hook) for the current "
                        "points' prior.")
                lp_in = np.asarray(self.special_generate_prior(coords))
            aux_ll[inds_tuple] = np.asarray(ll_in)
            aux_lp[inds_tuple] = np.asarray(lp_in)
            aux_logP = self.get_mt_log_posterior(aux_ll, aux_lp, betas=betas)
            aux_log_proposal_pdf = log_proposal_pdf.copy()
            aux_log_proposal_pdf[inds_tuple] = aux_log_proposal_pdf_sub
            aux_log_importance_weights = aux_logP - aux_log_proposal_pdf
        elif rj:
            # the auxiliary set repeats the one leaf less model
            aux_ll = np.repeat(np.asarray(ll_in)[:, None], self.num_try, -1)
            aux_lp = np.repeat(np.asarray(lp_in)[:, None], self.num_try, -1)
            aux_log_proposal_pdf = aux_lp.copy()
            aux_logP = self.get_mt_log_posterior(aux_ll, aux_lp, betas=betas)
            aux_log_importance_weights = aux_logP - aux_log_proposal_pdf
        else:
            aux_generated_points, aux_log_proposal_pdf = \
                self.special_generate_func(
                    generated_points_out, random, *args_generate,
                    size=self.num_try, fill_tuple=inds_tuple,
                    fill_values=coords, **kwargs_generate)
            aux_ll = np.asarray(self.special_like_func(
                np.asarray(aux_generated_points), *args_like, **kwargs_like),
                dtype=np.float64)
            aux_lp = np.asarray(self.special_prior_func(
                np.asarray(aux_generated_points)), dtype=np.float64)
            aux_log_proposal_pdf = np.asarray(aux_log_proposal_pdf,
                                              dtype=np.float64)
            aux_logP = self.get_mt_log_posterior(aux_ll, aux_lp, betas=betas)
            aux_log_importance_weights = (
                aux_logP if self.symmetric else aux_logP - aux_log_proposal_pdf)

        aux_logP_out = aux_logP[inds_tuple]
        max_aux = np.max(aux_log_importance_weights, axis=-1)
        aux_log_sum_weights = max_aux + np.log(np.exp(
            aux_log_importance_weights - max_aux[:, None]).sum(-1))
        aux_log_proposal_pdf_out = aux_log_proposal_pdf[inds_tuple]
        # factors + logP_out - aux_logP_out is the ratio of the weight sums
        factors = ((aux_logP_out - aux_log_sum_weights)
                   - (logP_out - log_sum_weights))
        if rj:
            inds_reverse_rj = np.asarray(inds_reverse_rj)
            factors[inds_reverse_rj] *= -1
            self.mt_ll[inds_reverse_rj] = np.asarray(ll_in)[inds_reverse_rj]
            self.mt_lp[inds_reverse_rj] = np.asarray(lp_in)[inds_reverse_rj]
            self.inds_reverse_rj = inds_reverse_rj
            self.inds_forward_rj = np.delete(np.arange(coords.shape[0]),
                                             inds_reverse_rj)
        self.aux_logP_out, self.logP_out = aux_logP_out, logP_out
        self.aux_ll, self.aux_lp = aux_ll, aux_lp
        self.log_sum_weights = log_sum_weights
        self.aux_log_sum_weights = aux_log_sum_weights
        self.readout_adjustment(
            [logP_out, ll_out, lp_out, log_proposal_pdf_out, log_sum_weights],
            [logP, ll, lp, log_proposal_pdf, log_sum_weights],
            [aux_logP, aux_ll, aux_lp, aux_log_proposal_pdf,
             aux_log_sum_weights])
        return generated_points_out, factors

    @stock_host_api
    def get_proposal(self, branches_coords, random, branches_inds=None,
                     **kwargs):
        """The host multiple-try proposal with the whole-ensemble
        protocol's signature: one branch, one active leaf per walker,
        flattened through :meth:`get_mt_proposal`; sets ``mt_ll`` and
        ``mt_lp`` for the protocol to take."""
        if len(branches_coords) > 1:
            raise ValueError(
                "Can only propose change to one model at a time with MT.")
        key_in = list(branches_coords)[0]
        self.key_in = key_in
        coords = np.asarray(branches_coords[key_in])
        m = (np.ones(coords.shape[:-1], dtype=bool) if branches_inds is None
             else np.asarray(branches_inds[key_in], dtype=bool))
        if np.any(m.sum(axis=-1) > 1):
            raise ValueError(
                "MT base proposals require exactly one active leaf.")
        ntemps, nwalkers, nl = coords.shape[:3]
        betas_here = None
        if self.temperature_control is not None:
            betas_here = np.repeat(
                np.asarray(self.current_state.betas)[:, None],
                nwalkers * nl).reshape(m.shape)[m]
        ll_here = np.repeat(np.asarray(self.current_state.log_like)[:, :, None],
                            nl, axis=-1)[m]
        lp_here = np.repeat(
            np.asarray(self.current_state.log_prior)[:, :, None], nl,
            axis=-1)[m]
        points, factors = self.get_mt_proposal(
            coords[m], random, betas=betas_here, ll_in=ll_here,
            lp_in=lp_here)
        self.mt_ll = self.mt_ll.reshape(ntemps, nwalkers)
        self.mt_lp = self.mt_lp.reshape(ntemps, nwalkers)
        return ({key_in: points.reshape(ntemps, nwalkers, 1, -1)},
                factors.reshape(ntemps, nwalkers))

    def special_generate_kernel(self, generator, state, num_try):
        raise NotImplementedError

    def special_generate_logpdf_kernel(self, state, coords=None):
        raise NotImplementedError

    def mt_eval_kernel(self, ctx, state, tries):
        raise NotImplementedError

    def _current_target_coords(self, state):
        raise NotImplementedError

    def _with_target_coords(self, state, coords):
        """``state`` with the target branch's coordinates replaced by
        ``coords`` ``(ntemps, nwalkers, ndim)``: the auxiliary set of a
        state-dependent proposal is anchored on the chosen point."""
        raise NotImplementedError(
            "Non-independent multiple-try with a state-dependent generator "
            "requires _with_target_coords(state, coords) so the auxiliary "
            "set can be anchored on the chosen point."
        )

    def draw_gumbel(self, generator, like):
        """The Gumbel noise of one pick, shaped and typed like ``like``
        ``(ntemps, nwalkers, num_try)``, per walker."""
        return gumbel_from_uniform(self.rank_draw(
            lambda sh: torch.rand(sh, generator=generator, dtype=like.dtype,
                                  device=like.device),
            like.shape, per_walker=True))

    def mt_select_kernel(self, generator, state, ctx):
        """The multiple-try machinery of an in-model step.

        Returns ``(chosen coords (ntemps, nwalkers, ndim), ll, lp,
        factors, blobs)`` such that ``factors + logP_new - logP_old`` is the
        ratio of the weight sums; ``blobs`` are the chosen try's, or None.
        """
        betas = self.rank_betas(state)

        tries, logq = self.special_generate_kernel(generator, state,
                                                   self.num_try)
        ll, lp, blobs = unpack_eval(self.mt_eval_kernel(ctx, state, tries))
        logP = tempered_log_likelihood(ll, betas[:, None, None]) + lp
        logw = logP if self.symmetric else logP - logq
        log_sum_w = logsumexp(logw, axis=-1)

        j, one_hot = categorical_pick(logw, self.draw_gumbel(generator, logw))
        coords_out = torch.where(one_hot[..., None], tries, 0.0).sum(dim=2)
        ll_out = pick_try(one_hot, ll)
        lp_out = pick_try(one_hot, lp)
        logP_out = pick_try(one_hot, logP)
        cur_logP = (tempered_log_likelihood(state.log_like, betas)
                    + state.log_prior)

        if self.independent:
            # the chosen slot holds the current point
            if self.symmetric:
                aux_sub = cur_logP
            else:
                aux_sub = cur_logP - self.special_generate_logpdf_kernel(state)
            aux_logw = torch.where(one_hot, aux_sub[:, :, None], logw)
        else:
            # a new auxiliary set drawn from the chosen point, its chosen
            # slot holding the current point (Liu, Liang & Wong 2000)
            state_y = self._with_target_coords(state, coords_out)
            aux_tries, aux_logq = self.special_generate_kernel(
                generator, state_y, self.num_try)
            cur = self._current_target_coords(state)
            aux_tries = torch.where(one_hot[..., None], cur[:, :, None, :],
                                    aux_tries)
            if not self.symmetric:
                # that slot's weight takes T(y -> x)
                cur_logq = self.special_generate_logpdf_kernel(state_y,
                                                               coords=cur)
                aux_logq = torch.where(one_hot, cur_logq[:, :, None], aux_logq)
            aux_ll, aux_lp, _ = unpack_eval(
                self.mt_eval_kernel(ctx, state, aux_tries))
            aux_logP = (tempered_log_likelihood(aux_ll, betas[:, None, None])
                        + aux_lp)
            aux_logw = aux_logP if self.symmetric else aux_logP - aux_logq

        aux_log_sum_w = logsumexp(aux_logw, axis=-1)
        factors = (cur_logP - aux_log_sum_w) - (logP_out - log_sum_w)
        return coords_out, ll_out, lp_out, factors, pick_try_blobs(j, blobs)


class MultipleTryMoveRJ(MultipleTryMove):
    """Multiple-try base for reversible jump.  Its trans-dimensional
    bookkeeping lives in
    :class:`~eryn_tpu_torch.moves.mtdistgenrj.MTDistGenMoveRJ`; the in-model
    :meth:`mt_select_kernel` raises here."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("rj", True)
        super().__init__(*args, **kwargs)

    @stock_host_api
    def get_proposal(self, branches_coords, branches_inds, nleaves_min_all,
                     nleaves_max_all, random, **kwargs):
        """The host multiple-try birth/death with the reversible-jump
        protocol's signature: one branch, +1/-1 changes from
        ``get_model_change_proposal``, a death taken as an inverted birth
        (the removed leaf in try slot 0) and the one leaf less model as the
        auxiliary base.  Returns ``(q, new_inds, factors)``; sets ``mt_ll``
        and ``mt_lp``.  The removers' one leaf less likelihood takes their
        own priors (``eryn_tpu``'s reference passes the whole ensemble's,
        of another shape)."""
        if len(branches_coords) > 1:
            raise ValueError(
                "Can only propose change to one model at a time with MT.")
        key_in = list(branches_coords)[0]
        self.key_in = key_in
        if branches_inds is None:
            raise ValueError("In MT RJ proposal, branches_inds cannot be None.")
        coords_b = np.asarray(branches_coords[key_in])
        inds_b = np.asarray(branches_inds[key_in], dtype=bool)
        ntemps, nwalkers, _, ndim = coords_b.shape
        st = self.current_state
        betas_here = None
        if self.temperature_control is not None:
            betas_here = np.repeat(np.asarray(st.betas)[:, None], nwalkers,
                                   axis=-1).flatten()
        ll_here = np.array(st.log_like, dtype=float).flatten()
        lp_here = np.array(st.log_prior, dtype=float).flatten()
        nmin, nmax = nleaves_min_all[key_in], nleaves_max_all[key_in]
        if nmin == nmax:
            raise ValueError(
                "MT RJ proposal requires that nleaves_min != nleaves_max.")
        if nmin > nmax:
            raise ValueError(
                "nleaves_min is greater than nleaves_max. Not allowed.")
        changes = self.get_model_change_proposal(inds_b, random, nmin, nmax)

        inds_leaves_rj = np.zeros(ntemps * nwalkers, dtype=int)
        coords_in = np.zeros((ntemps * nwalkers, ndim))
        inds_reverse_rj = None
        new_inds = {n: np.array(v) for n, v in branches_inds.items()}
        q = {n: np.array(v) for n, v in branches_coords.items()}
        for change, idx in changes.items():
            if change not in ("+1", "-1"):
                raise ValueError("MT RJ is only implemented for +1/-1 moves.")
            t_i, w_i, l_i = idx[:, 0], idx[:, 1], idx[:, 2]
            inds_leaves_rj[t_i * nwalkers + w_i] = l_i
            coords_in[t_i * nwalkers + w_i] = coords_b[(t_i, w_i, l_i)]
            new_inds[key_in][(t_i, w_i, l_i)] = change == "+1"
            if change == "-1":
                inds_reverse_rj = t_i * nwalkers + w_i

        if inds_reverse_rj is not None and inds_reverse_rj.size:
            # the removers' one leaf less model (the leaf is off in
            # new_inds already)
            rev_coords, rev_inds = {}, {}
            for key, branch in st.branches.items():
                bc = np.asarray(branch.coords)
                nl_k, nd_k = bc.shape[-2:]
                rev_coords[key] = bc.reshape(-1, nl_k, nd_k)[
                    inds_reverse_rj][None]
                im = new_inds[key] if key == key_in else np.asarray(branch.inds)
                rev_inds[key] = im.reshape(-1, nl_k)[inds_reverse_rj][None]
            model = self.current_model
            lp_rev = np.asarray(model.compute_log_prior_fn(
                rev_coords, inds=rev_inds))[0]
            ll_rev = np.asarray(model.compute_log_like_fn(
                rev_coords, inds=rev_inds, logp=lp_rev[None])[0])[0]
            ll_here[inds_reverse_rj] = ll_rev
            lp_here[inds_reverse_rj] = lp_rev
        elif inds_reverse_rj is None:
            inds_reverse_rj = np.array([], dtype=int)

        points, factors = self.get_mt_proposal(
            coords_in, random, betas=betas_here, ll_in=ll_here,
            lp_in=lp_here, inds_leaves_rj=inds_leaves_rj,
            inds_reverse_rj=inds_reverse_rj)
        self.mt_ll = self.mt_ll.reshape(ntemps, nwalkers)
        self.mt_lp = self.mt_lp.reshape(ntemps, nwalkers)
        forward = np.delete(np.arange(coords_in.shape[0]), inds_reverse_rj)
        add = changes.get("+1")
        if add is not None and add.size:
            q[key_in][(add[:, 0], add[:, 1], add[:, 2])] = points[forward]
        return q, new_inds, np.asarray(factors).reshape(ntemps, nwalkers)

    def mt_select_kernel(self, generator, state, ctx):
        raise NotImplementedError(
            "MultipleTryMoveRJ's trans-dimensional factor bookkeeping lives "
            "in MTDistGenMoveRJ (death-try inversion + RJ auxiliary sets); "
            "subclass MTDistGenMoveRJ or adapt its _propose_impl rather "
            "than calling the in-model mt_select_kernel."
        )
