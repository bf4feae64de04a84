"""Adaptive independence Metropolis-Hastings, the adaptive half of DIME.

Port of :mod:`eryn_tpu.moves.aimh` (Boehl 2022): a multivariate Student-t
independence proposal per temperature, fitted to an exponentially
discounted history of the ensemble, adapting for ``tune_steps`` of this
move's proposals and then fixed.  DIME is ``moves=[(DEMove(), 1 - p),
(AIMHMove(), p)]``.  The moments' update is computed every step and kept
by a ``torch.where`` on the tuning flag (``eryn_tpu``'s ``lax.cond``); the
Cholesky factor is ``torch.linalg.cholesky_ex``, NaN where it fails, as
``jnp.linalg.cholesky`` gives; the chi-square of an integer ``df`` up to
512 is ``-2 sum log U (+ Z^2)`` on the sampler's generator, and of any
other ``df`` twice a Marsaglia-Tsang gamma draw of shape ``df / 2``, in
:data:`GAMMA_ROUNDS` masked rounds (a fixed number, so the step stays one
capturable graph).  A draw whose rounds all reject is NaN, which no
proposal accepts, and counts in ``gamma_misses``, a device counter that
the sampler reads at the end of each segment and raises on.

On a state sharded over a device mesh every draw is per walker, and the
moments are fitted per rung from the rows of every walker of the rank's
temperatures, gathered within its temperature shard
(:meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.gather_walkers`), with the
same calls on the same shapes as one process: the kernel state holds the
rank's rungs.  Past its tuning the update is not made and nothing is
gathered: a host phase, tuning or tuned, says which
(:meth:`~eryn_tpu_torch.moves.move.Move.mesh_tuning`), and a graphed mesh
captures a graph for each.
"""

from __future__ import annotations

import numpy as np
import torch

from .kde import cholesky_or_nan, periodic_refused
from .move import (
    Move,
    leaf_axes,
    merge_blobs,
    mh_decide,
    state_branch_supps,
)
from .tempering import tempered_log_likelihood

__all__ = ["AIMHMove", "GAMMA_ROUNDS"]

#: rounds of the Marsaglia-Tsang gamma sampler: each accepts with
#: probability above 0.95 for a shape above 1, so all of them reject with
#: probability below 1e-10
GAMMA_ROUNDS = 8


class AIMHMove(Move):
    """Adaptive Student-t independence proposal, per temperature.

    Args:
        df: Student-t degrees of freedom, above 2 (an integer up to 512
            draws the chi-square from uniforms and a normal, any other a
            gamma by Marsaglia and Tsang).
        rho: per-proposal discount of the accumulated moments.
        tune_steps: adapting proposals of this move (0: the initial fit
            for ever).
        jitter: diagonal floor of the fitted covariance, relative to the
            mean per-rung variance.

    Needs fixed-dimension models (``requires_fixed_dimension``; the sampler
    refuses it on a reversible-jump branch, and the kernel state on inactive
    leaves); periodic parameters and Gibbs splits are refused.
    """

    requires_fixed_dimension = True
    _mesh_sharded = True

    def __init__(self, df=10.0, rho=0.999, tune_steps=500, jitter=1e-6,
                 **kwargs):
        super().__init__(**kwargs)
        if df <= 2.0:
            raise ValueError("df must exceed 2 (finite proposal covariance).")
        #: the chi-square is a gamma draw (not an integer df up to 512)
        self.gamma = not float(df).is_integer() or df > 512
        self.device_counters = ("gamma_misses",) if self.gamma else ()
        self.gamma_misses = None
        self._misses_sharded = False
        if self.gibbs_iterations != [None]:
            raise ValueError(
                "gibbs_sampling_setup is not supported by AIMHMove (the "
                "fitted proposal is joint over the flattened parameters); "
                "use proposal_branch_names to restrict branches.")
        self.df = float(df)
        self.rho = float(rho)
        self.tune_steps = int(tune_steps)
        self.jitter = float(jitter)

    def _flatten(self, state, names):
        nt, nw = state.log_like.shape
        return torch.cat([state.branches_coords[n].reshape(nt, nw, -1)
                          for n in names], dim=-1)

    def _unflatten(self, state, names, flat):
        out, off = {}, 0
        for n in names:
            shape = state.branches_coords[n].shape
            k = int(np.prod(shape[2:]))
            out[n] = flat[..., off:off + k].reshape(shape)
            off += k
        return out

    def _batch_moments(self, x):
        """Per-rung mean and centred covariance of ``x`` ``(nt, nw, D)``,
        over every walker of the rank's rungs under a mesh."""
        if self.mesh_layout is not None:
            x = self.mesh_layout.gather_walkers([x])[0]
        nw = x.shape[1]
        mean = x.mean(dim=1)
        d = x - mean[:, None, :]
        return mean, torch.einsum("twi,twj->tij", d, d) / nw

    def _refuse(self, state, names):
        periodic_refused(self, names, {n: state.branches[n].ndim
                                       for n in names}, "AIMHMove")

    def init_kernel_state(self, state):
        names = self.run_branches(state)
        self._refuse(state, names)
        for n in names:
            # every rank decides on the whole ensemble's masks
            if not bool(self.all_walkers(state.branches_inds[n]).all()):
                raise ValueError(
                    "AIMHMove requires fixed-dimension models (all leaves "
                    "active): reversible-jump masks change the meaning of "
                    "the flattened parameter vector. Use KDEMove/DEMove for "
                    "trans-dimensional targets.")
        x = self._flatten(state, names)
        if self.gamma and self.gamma_misses is None:
            self.gamma_misses = torch.zeros((), dtype=torch.int64,
                                            device=x.device)
        mean, cov = self._batch_moments(x)
        return {"w": x.new_full((x.shape[0],), float(self._nwalkers(x))),
                "mean": mean, "cov": cov,
                "t": torch.zeros((), dtype=torch.int32, device=x.device)}

    def kernel_state_axes(self, kernel_state):
        # the weights and moments of the rank's rungs, over all their walkers
        return [ax for k in sorted(kernel_state) for ax in leaf_axes(
            kernel_state[k], (None, None) if k == "t" else (0, None))]

    def _nwalkers(self, x):
        """The ensemble's walker count (the shard's ``x`` has its own)."""
        lay = self.mesh_layout
        return x.shape[1] if lay is None else lay.nwalkers

    def _proposal_params(self, ks, D):
        """``(mean, lower Cholesky factor)`` per rung, with the relative
        diagonal floor."""
        mean, cov = ks["mean"], ks["cov"]
        var_scale = torch.diagonal(cov, dim1=-2, dim2=-1).sum(dim=-1) / D
        eye = torch.eye(D, dtype=cov.dtype, device=cov.device)
        cov = cov + (self.jitter * torch.clamp(var_scale, min=1e-30)
                     )[:, None, None] * eye
        return mean, cholesky_or_nan(cov)

    def _t_logpdf(self, x, mean, chol):
        """The Student-t log kernel per (rung, walker); the normalization
        cancels in the Hastings ratio."""
        D = x.shape[-1]
        d = x - mean[:, None, :]
        y = torch.linalg.solve_triangular(chol, d.transpose(1, 2),
                                          upper=False).transpose(1, 2)
        q = torch.sum(y ** 2, dim=-1)
        return -0.5 * (self.df + D) * torch.log1p(q / self.df)

    def draw_aimh(self, generator, nt, nw, D, like):
        """Randomness of one proposal: the normals ``(nt, nw, D)``, the
        chi-square's uniforms ``(nt, nw, df // 2)`` in ``[tiny, 1)`` (None
        for df < 2) and, for an odd df, its normal ``(nt, nw)`` (else
        None).  For a gamma draw the second is the rounds' normals and
        uniforms, ``(2, GAMMA_ROUNDS, nt, nw)``, and the third None.  Every
        draw is per walker."""
        kw = dict(generator=generator, dtype=like.dtype, device=like.device)

        def randn(sh):
            return torch.randn(sh, **kw)

        def rand(sh):
            return torch.rand(sh, **kw)

        z = self.rank_draw(randn, (nt, nw, D), per_walker=True)
        if self.gamma:
            normals = self.rank_draw_rounds(randn, GAMMA_ROUNDS, (nt, nw))
            return z, torch.stack(
                [normals, self.rank_draw_rounds(rand, GAMMA_ROUNDS, (nt, nw))]
            ), None
        k = int(self.df)
        uu = zz = None
        if k // 2:
            tiny = torch.finfo(like.dtype).tiny
            uu = torch.clamp(
                self.rank_draw(rand, (nt, nw, k // 2), per_walker=True)
                * (1.0 - tiny) + tiny, min=tiny)
        if k % 2:
            zz = self.rank_draw(randn, (nt, nw), per_walker=True)
        return z, uu, zz

    def _chisquare(self, uu, zz, like):
        if self.gamma:
            return self._chisquare_gamma(uu)
        u = like.new_zeros(like.shape)
        if uu is not None:
            u = -2.0 * torch.sum(torch.log(uu), dim=-1)
        if zz is not None:
            u = u + zz * zz
        return u

    def _chisquare_gamma(self, draws):
        """``2 Gamma(df / 2)`` by Marsaglia and Tsang (2000) from the
        rounds' normals and uniforms: the first round that accepts gives
        ``d v``; a draw with none is NaN and counts in ``gamma_misses``."""
        x, u = draws[0], draws[1]
        d = self.df / 2.0 - 1.0 / 3.0
        c = 1.0 / np.sqrt(9.0 * d)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        first = torch.argmax(ok.to(torch.int8), dim=0, keepdim=True)
        value = torch.gather(d * v, 0, first)[0]
        found = ok.any(dim=0)
        if self.gamma_misses is not None:
            self.gamma_misses.add_((~found).sum())
            # under a mesh: the rank's walkers' misses, else the ensemble's
            self._misses_sharded = self.mesh_layout is not None
        return torch.where(found, 2.0 * value, torch.nan)

    def check_segment(self):
        """Raise if a gamma draw of the segments run so far exhausted its
        rounds (reads the device counter: the segment's end waits).  Under a
        mesh the counter of a move that ran sharded holds the rank's
        walkers' misses, and every rank reads the mesh's sum, so that all
        of them raise or none; one that ran on the gathered ensemble in
        every rank (a subclass, :meth:`~eryn_tpu_torch.moves.move.Move.
        mesh_route`) holds the ensemble's already."""
        if self.gamma_misses is None:
            return
        misses = self.gamma_misses
        if self.mesh_layout is not None and self._misses_sharded:
            misses = self.mesh_layout.sum(misses.clone())
        if int(misses):
            raise RuntimeError(
                f"AIMHMove(df={self.df}): {int(misses)} chi-square "
                f"draws rejected in all {GAMMA_ROUNDS} rounds of the gamma "
                "sampler; their proposals were refused.")

    def phase_of(self, clock):
        """Under a mesh: whether a step at the clock's value still tunes
        (:meth:`~eryn_tpu_torch.moves.move.Move.mesh_tuning`)."""
        return clock < self.tune_steps if self.tune_steps > 0 else None

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        names = self.run_branches(state)
        self._refuse(state, names)
        logl0 = state.log_like
        nt, nw = logl0.shape
        x = self._flatten(state, names)
        D = x.shape[-1]
        ks = kernel_state if isinstance(kernel_state, dict) else None
        if ks is None:
            # bare call: the fit to the current ensemble
            mean0, cov0 = self._batch_moments(x)
            ks = {"w": x.new_full((nt,), float(self._nwalkers(x))),
                  "mean": mean0,
                  "cov": cov0,
                  "t": torch.zeros((), dtype=torch.int32, device=x.device)}

        mean, chol = self._proposal_params(ks, D)
        z, uu, zz = self.draw_aimh(generator, nt, nw, D, logl0)
        u = self._chisquare(uu, zz, logl0)
        step = torch.einsum("tij,twj->twi", chol, z)
        q_flat = mean[:, None, :] + step * torch.sqrt(
            self.df / torch.clamp(u, min=1e-12))[..., None]
        q_branches = self._unflatten(state, names, q_flat)

        # independence factor: log q(x_old) - log q(x_new)
        factors = self._t_logpdf(x, mean, chol) - self._t_logpdf(q_flat, mean,
                                                                 chol)
        betas = self.rank_betas(state)
        inds = dict(state.branches_inds)
        full = {**state.branches_coords, **q_branches}
        lp1 = ctx.compute_log_prior(full, inds)
        ll1, bl1 = ctx.compute_log_like(full, inds, lp1,
                                        state_branch_supps(state))
        logP_new = tempered_log_likelihood(ll1, betas) + lp1
        logP_old = tempered_log_likelihood(logl0, betas) + state.log_prior
        acc = mh_decide(self.draw_accept(generator, logP_new, per_walker=True),
                        factors, logP_new, logP_old)

        new_coords = dict(state.branches_coords)
        for n in names:
            new_coords[n] = torch.where(acc[:, :, None, None], q_branches[n],
                                        state.branches_coords[n])
        logl = torch.where(acc, ll1, logl0)
        logp = torch.where(acc, lp1, state.log_prior)

        if self.tune_steps > 0 and not self.mesh_tuning(ks):
            # under a mesh past the tuning: the clock, and no exchange
            ks = {**ks, "t": ks["t"] + 1}
        elif self.tune_steps > 0:
            # the discounted weighted merge of the post-accept ensemble into
            # the running centred moments, kept while tuning
            x_new = torch.where(acc[..., None], q_flat, x)
            w, m, C = ks["w"], ks["mean"], ks["cov"]
            mb, Cb = self._batch_moments(x_new)
            nw = self._nwalkers(x)
            w_old = self.rho * w
            w_new = w_old + nw
            delta = mb - m
            m_new = m + (nw / w_new)[:, None] * delta
            cross = torch.einsum("ti,tj->tij", delta, delta)
            C_new = (w_old[:, None, None] * C + nw * Cb
                     + (w_old * nw / w_new)[:, None, None] * cross
                     ) / w_new[:, None, None]
            tuning = ks["t"] < self.tune_steps
            ks = {"w": torch.where(tuning, w_new, w),
                  "mean": torch.where(tuning, m_new, m),
                  "cov": torch.where(tuning, C_new, C),
                  "t": ks["t"] + 1}

        new_state = state.replace(coords=new_coords, inds=inds, log_like=logl,
                                  log_prior=logp,
                                  blobs=merge_blobs(acc, bl1, state.blobs))
        return new_state, acc, ks
