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
"""

from __future__ import annotations

import numpy as np
import torch

from .move import Move
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


def get_mt_computations(logP, log_proposal_pdf, symmetric=False, xp=None):
    """Importance weights and the try picked per batch row, on host arrays:
    ``eryn_tpu``'s public helper with its signature, drawing the pick's
    uniforms from NumPy's global generator as it does.

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
    u = xp.asarray(np.random.rand(probs.shape[0]))
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

    @staticmethod
    def draw_gumbel(generator, like):
        """The Gumbel noise of one pick, shaped and typed like ``like``."""
        return gumbel_from_uniform(torch.rand(
            like.shape, generator=generator, dtype=like.dtype,
            device=like.device))

    def mt_select_kernel(self, generator, state, ctx):
        """The multiple-try machinery of an in-model step.

        Returns ``(chosen coords (ntemps, nwalkers, ndim), ll, lp,
        factors, blobs)`` such that ``factors + logP_new - logP_old`` is the
        ratio of the weight sums; ``blobs`` are the chosen try's, or None.
        """
        ntemps = state.log_like.shape[0]
        betas = state.betas
        if betas is None:
            betas = torch.ones(ntemps, dtype=state.log_like.dtype,
                               device=state.log_like.device)

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

    def mt_select_kernel(self, generator, state, ctx):
        raise NotImplementedError(
            "MultipleTryMoveRJ's trans-dimensional factor bookkeeping lives "
            "in MTDistGenMoveRJ (death-try inversion + RJ auxiliary sets); "
            "subclass MTDistGenMoveRJ or adapt its _propose_impl rather "
            "than calling the in-model mt_select_kernel."
        )
