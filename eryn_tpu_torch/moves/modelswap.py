"""Product-space model comparison: switch which candidate model is active.

Port of :mod:`eryn_tpu.moves.modelswap`.  Each candidate model is a branch
with ``nleaves_max == 1``, and exactly one candidate is active per walker:
the model indicator is the leaf masks.  The move proposes another model
uniformly (a shift of the current index by ``1..K-1``), kills the current
model's leaf, births the new one's from its generating distribution
(usually its prior), and accepts with the factors ``log q_cur(theta_cur) -
log q_new(theta_new)``.  With equal model priors the cold chain's model
indicator estimates ``P(model k | data) = Z_k / sum_j Z_j``.

Every walker's swap is its own: on a state sharded over a device mesh the
move runs on this rank's walkers, its draws per walker at their global
shape, and exchanges nothing; the set-up check reads the whole ensemble's
masks, so that every rank decides alike.
"""

from __future__ import annotations

import numpy as np
import torch

from ..prior import ProbDistContainer
from .move import merge_blobs, mh_decide, state_branch_supps
from .rj import ReversibleJumpMove
from .tempering import tempered_log_likelihood

__all__ = ["ModelSwapRJMove", "BasicSymmetricModelSwapRJMove"]


class ModelSwapRJMove(ReversibleJumpMove):
    """Switch which of several single-leaf branches is active per walker.

    Args:
        generate_dist: ``{branch_name: ProbDistContainer}``, the candidate
            models and the distributions their coordinates are born from;
            None resolves both from the sampler's priors
            (:meth:`wire_sampler_priors`).
        Remaining keywords as
        :class:`~eryn_tpu_torch.moves.rj.ReversibleJumpMove`.

    The candidates need ``nleaves_max = 1`` and ``nleaves_min = 0``, and the
    initial state exactly one active candidate per walker: checked once,
    on the host, when the sampler sets the move up.
    """

    _mesh_sharded = True

    def __init__(self, generate_dist=None, **kwargs):
        if isinstance(generate_dist, ProbDistContainer):
            raise ValueError(
                "ModelSwapRJMove needs at least two candidate branches: "
                "pass {branch_name: ProbDistContainer, ...}."
            )
        for kw in ("gibbs_sampling_setup", "proposal_branch_names"):
            if kwargs.get(kw) is not None:
                raise ValueError(
                    f"ModelSwapRJMove does not support {kw}: the model "
                    "switch always updates all candidate branches jointly."
                )
        if generate_dist is None:
            self.generate_dist = None
            self.model_names = None
            super().__init__(**kwargs)
            return
        self.generate_dist = dict(generate_dist)
        self.model_names = list(self.generate_dist)
        if len(self.model_names) < 2:
            raise ValueError(
                "ModelSwapRJMove needs at least two candidate branches."
            )
        kwargs.setdefault("nleaves_max", {n: 1 for n in self.model_names})
        kwargs.setdefault("nleaves_min", {n: 0 for n in self.model_names})
        super().__init__(**kwargs)

    def wire_sampler_priors(self, priors):
        """Resolve a deferred candidate set from the sampler's priors
        (``{branch: ProbDistContainer}``); a no-op when ``generate_dist``
        was given."""
        if self.generate_dist is not None:
            return
        if len(priors) < 2:
            raise ValueError(
                "ModelSwapRJMove with generate_dist=None needs a sampler "
                f"with >= 2 branches; got {list(priors)}."
            )
        self.generate_dist = dict(priors)
        self.model_names = list(priors)
        if not self.nleaves_max:
            self.nleaves_max = {n: 1 for n in self.model_names}
        if not self.nleaves_min:
            self.nleaves_min = {n: 0 for n in self.model_names}

    def init_kernel_state(self, state):
        if self.model_names is None:
            raise RuntimeError(
                "ModelSwapRJMove was constructed with generate_dist=None "
                "but never wired to a sampler; pass it via rj_moves= or "
                "provide {branch: ProbDistContainer} explicitly."
            )
        for n in self.model_names:
            if n not in state.branches:
                raise ValueError(
                    f"Candidate '{n}' is not a branch of the state "
                    f"({list(state.branches)})."
                )
            if state.branches[n].nleaves_max != 1:
                raise ValueError(
                    f"Candidate branch '{n}' must have nleaves_max == 1."
                )
        # once, at set-up, on the host: never inside a segment
        # every rank decides on the whole ensemble's masks
        active = np.stack(
            [self.all_walkers(state.branches[n].inds).sum(dim=-1).cpu()
             .numpy() for n in self.model_names], axis=-1)
        if not (np.all(active.sum(axis=-1) == 1) and active.max() <= 1):
            raise ValueError(
                "ModelSwapRJMove requires exactly one active leaf across "
                f"the candidate branches {self.model_names} per walker "
                "(nleaves_max=1 each); got active counts "
                f"{np.unique(active.sum(axis=-1))}."
            )
        self.prepare_constants(state)
        for n in self.model_names:
            self.generate_dist[n].logpdf(state.branches[n].coords)
        return ()

    def draw_swap(self, generator, ntemps, nwalkers, dtype, device):
        """Randomness of one proposal: the shift of the model index per
        walker, int64 in ``1..K-1``, and a draw of every candidate's
        distribution ``{name: (ntemps, nwalkers, ndim)}``, every one per
        walker."""
        shift = self.rank_draw(
            lambda sh: torch.randint(1, len(self.model_names), sh,
                                     generator=generator, device=device),
            (ntemps, nwalkers), per_walker=True)
        draws = {
            n: self.rank_draw(
                lambda sh, n=n: self.generate_dist[n].sample(generator, sh,
                                                             dtype=dtype),
                (ntemps, nwalkers), per_walker=True)
            for n in self.model_names
        }
        return shift, draws

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        names = self.model_names
        K = len(names)
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logl = state.log_like
        logp = state.log_prior
        ntemps, nwalkers = logl.shape
        betas = self.rank_betas(state)

        # the current model from the masks: (nt, nw, K) one-hot
        active = torch.stack([inds[n][..., 0] for n in names], dim=-1)
        models = torch.arange(K, device=logl.device)
        cur_idx = torch.where(active, models, 0).sum(dim=-1)
        shift, draws = self.draw_swap(generator, ntemps, nwalkers,
                                      logl.dtype, logl.device)
        new_onehot = models == ((cur_idx + shift) % K)[..., None]

        lq_new = logl.new_zeros((ntemps, nwalkers))
        lq_old = logl.new_zeros((ntemps, nwalkers))
        q_coords, new_inds = {}, {}
        for j, n in enumerate(names):
            dist = self.generate_dist[n]
            born = new_onehot[..., j]
            dying = active[..., j]
            draw = draws[n]
            q_coords[n] = torch.where(born[..., None, None],
                                      draw[:, :, None, :], coords[n])
            new_inds[n] = born[..., None]
            lq_new = lq_new + torch.where(born, dist.logpdf(draw), 0.0)
            lq_old = lq_old + torch.where(
                dying, dist.logpdf(coords[n][:, :, 0]), 0.0)

        # branches outside the candidates ride along unchanged
        q_full = {**coords, **q_coords}
        inds_full = {**inds, **new_inds}
        logp_new = ctx.compute_log_prior(q_full, inds_full)
        logl_new, blobs_new = ctx.compute_log_like(
            q_full, inds_full, logp_new, state_branch_supps(state))

        factors = lq_old - lq_new
        logP_new = tempered_log_likelihood(logl_new, betas) + logp_new
        logP_old = tempered_log_likelihood(logl, betas) + logp
        acc = mh_decide(self.draw_accept(generator, logP_new, per_walker=True),
                        factors, logP_new, logP_old)

        for n in names:
            coords[n] = torch.where(acc[:, :, None, None], q_coords[n],
                                    coords[n])
            inds[n] = torch.where(acc[:, :, None], new_inds[n], inds[n])
        new_state = state.replace(
            coords=coords, inds=inds,
            log_like=torch.where(acc, logl_new, logl),
            log_prior=torch.where(acc, logp_new, logp),
            blobs=merge_blobs(acc, blobs_new, state.blobs),
        )
        return new_state, acc.to(logl.dtype), kernel_state


class BasicSymmetricModelSwapRJMove(ModelSwapRJMove):
    """The name Eryn's model-swap example imports.  Takes the primary
    ``{branch: ProbDistContainer}`` signature (positional or as
    ``generate_dist=``) and the example's positional ``(nleaves_max,
    nleaves_min)`` per-branch lists, where the candidates and their
    distributions come from the sampler's priors."""

    _mesh_sharded = True

    def __init__(self, *args, **kwargs):
        if args and isinstance(args[0], dict):
            super().__init__(*args, **kwargs)
            return
        if not args and isinstance(kwargs.get("generate_dist"), dict):
            super().__init__(**kwargs)
            return
        kwargs.pop("generate_dist", None)
        nlmax = args[0] if len(args) > 0 else kwargs.pop("nleaves_max", None)
        nlmin = args[1] if len(args) > 1 else kwargs.pop("nleaves_min", None)
        for label, vals, ok in (("nleaves_max", nlmax, 1),
                                ("nleaves_min", nlmin, 0)):
            if vals is not None and any(
                    int(v) != ok for v in np.atleast_1d(vals)):
                raise ValueError(
                    f"BasicSymmetricModelSwapRJMove requires {label} == "
                    f"{ok} for every candidate branch; got {vals}."
                )
        super().__init__(None, **kwargs)
