"""Metropolis-adjusted Langevin (MALA) move, and the gradient of the tempered
posterior that the gradient moves share.

Port of :mod:`eryn_tpu.moves.mala`.  The gradient of ``beta * logl + logp``
is :func:`torch.func.grad_and_value` through the sampler's prior and
likelihood evaluators (the likelihood vectorized with ``torch.func.vmap``,
or called on the batch under ``vectorize=True``), so the drift, the
proposal and the decision stay inside the step's CUDA graph.  The proposal
(per walker, per active leaf)

    q = x + (eps^2 / 2) * grad logP(x) + eps * xi,  xi ~ N(0, I)

takes the exact Hastings factor from the reverse drift at ``q``.  The step
size adapts by dual averaging on a clock of the kernel state, frozen after
``tune_steps`` proposals.  The likelihood must be written in
differentiable torch operations: the sampler checks that at wiring.

On a state sharded over a device mesh the proposal is per walker (its
draws at their global shape, :meth:`~eryn_tpu_torch.moves.move.Move.
rank_draw`), and what reads the ensemble reads the rows one process reads:
the cold rung's rows of every walker for the eps=None base and the dual
averaging (:meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.gather_rung`;
past the tuning, a host phase, nothing is gathered:
:meth:`~eryn_tpu_torch.moves.move.Move.mesh_tuning`), and in the
preconditioned form the
red/blue blocks of :class:`~eryn_tpu_torch.moves.red_blue.WalkerBlocks`.
A proposal's draws are made before it (:meth:`MALAMove.draw_block`), so a
rank that holds none of a block's walkers draws what the others draw.
"""

from __future__ import annotations

import numpy as np
import torch

from .move import Move, merge_blobs, mh_decide, state_branch_supps
from .red_blue import WalkerBlocks
from .tempering import tempered_log_likelihood

__all__ = ["MALAMove", "grad_context"]


def grad_context(ctx, fixed, inds, betas, supps=None):
    """The gradient of the tempered log posterior of a block of walkers.

    ``fixed`` holds the coordinates of the branches that do not move,
    ``inds`` every branch's leaf masks, ``betas`` the ``(ntemps,)``
    ladder and ``supps`` the block's branch supplementals
    (:func:`~eryn_tpu_torch.moves.move.state_branch_supps`).  Returns
    ``grad_fn(active) -> (aux, grad)`` with ``active`` and ``grad`` dicts
    over the moving branches and ``aux`` ``(log_like, log_prior)``, or
    ``(log_like, log_prior, blobs)`` where the likelihood returns blobs
    (:func:`unpack_aux` reads either).  The sum
    runs over finite ``logP`` only and a non-finite gradient is set to
    zero, so a walker at ``-inf`` (outside the prior, where the likelihood
    is evaluated at zeros) takes a pure noise step instead of freezing.
    Separable over walkers: the gradient of the sum is each walker's."""

    def logP_sum(active):
        full = {**fixed, **active}
        lp = ctx.compute_log_prior(full, inds)
        ll, bl = ctx.compute_log_like(full, inds, lp, supps)
        logP = tempered_log_likelihood(ll, betas) + lp
        aux = (ll, lp) if bl is None else (ll, lp, bl)
        return torch.where(torch.isfinite(logP), logP, 0.0).sum(), aux

    raw = torch.func.grad_and_value(logP_sum, has_aux=True)

    def grad_fn(active):
        g, (_, aux) = raw(active)
        return aux, {n: torch.where(torch.isfinite(v), v, 0.0)
                     for n, v in g.items()}

    return grad_fn


def unpack_aux(aux):
    """``(log_like, log_prior, blobs or None)`` of a :func:`grad_context`
    aux."""
    return tuple(aux) if len(aux) == 3 else (*aux, None)


class MALAMove(Move):
    """Langevin proposal with exact MH correction.

    Args:
        eps: step size, a scalar (all branches) or ``{branch: scalar or
            (ndim,) array}``; None takes ``1.65 d^(-1/6)`` times the spread
            of the initial cold ensemble per parameter.
        target_acceptance: the cold chain's mean acceptance probability
            that dual averaging steers a global log step multiplier to, for
            the first ``tune_steps`` proposals (0 disables it).
        ensemble_precondition: walkers move in two permuted halves, each
            with the other half's per-parameter spread as its diagonal mass
            matrix (exact detailed balance, as the stretch move's).

    Gibbs splits are refused (``proposal_branch_names`` restricts the
    branches); periodic parameters wrap, and the Hastings factor takes the
    nearest-image displacement.
    """

    #: the sampler checks that the likelihood can be differentiated
    needs_gradient = True
    _mesh_sharded = True

    #: dual-averaging constants (Hoffman & Gelman 2014, NUTS sec. 3.2)
    _DA_GAMMA = 0.05
    _DA_T0 = 10.0
    _DA_KAPPA = 0.75
    #: the eps=None heuristic, CONST * sigma * d^(-EXP)
    _EPS_DIM_EXP = 1.0 / 6.0
    _EPS_DIM_CONST = 1.65

    def __init__(self, eps=None, target_acceptance=0.574, tune_steps=500,
                 ensemble_precondition=False, **kwargs):
        super().__init__(**kwargs)
        if self.gibbs_iterations != [None]:
            raise ValueError(
                "gibbs_sampling_setup is not supported by gradient moves "
                "(MALA/HMC update all selected branches jointly); use "
                "proposal_branch_names to restrict branches."
            )
        self.eps = eps
        self.ensemble_precondition = bool(ensemble_precondition)
        self.target_acceptance = float(target_acceptance)
        self.tune_steps = int(tune_steps)
        self._eps_on = {}  # (device, dtype): {branch: (ndim,) tensor}

    # -- step sizes ---------------------------------------------------------
    def _eps_base(self, state):
        """The eps=None step sizes: per-parameter spread of the initial cold
        ensemble over active leaves, times the dimension factor."""
        names = self.run_branches(state)
        d_total = max(sum(state.branches[n].nleaves_max * state.branches[n].ndim
                          for n in names), 1)
        dim_factor = float(d_total) ** (-self._EPS_DIM_EXP)
        out = {}
        for n in names:
            c, m = self._cold_rows(state.branches_coords[n],
                                   state.branches_inds[n])
            m = m[..., None].to(c.dtype)
            cnt = m.sum(dim=(0, 1))
            mean = (c * m).sum(dim=(0, 1)) / torch.clamp(cnt, min=1.0)
            var = (((c - mean) ** 2) * m).sum(dim=(0, 1)) / torch.clamp(
                cnt - 1.0, min=1.0)
            sig = torch.sqrt(var)
            sig = torch.where((cnt > 1.0) & (sig > 0.0), sig, 1.0)
            out[n] = self._EPS_DIM_CONST * dim_factor * sig
        return out

    def _eps_for(self, name, ndim, like, kernel_state=None):
        """The ``(ndim,)`` step sizes of branch ``name`` in the dtype and on
        the device of ``like``; a given eps is copied there once (in
        :meth:`init_kernel_state`), so a step never copies from the host."""
        if self.eps is None:
            if isinstance(kernel_state, dict) and "eps_base" in kernel_state:
                return kernel_state["eps_base"][name]
            return like.new_full((ndim,), 0.1)  # bare call, no kernel state
        key = (like.device, like.dtype)
        on = self._eps_on.setdefault(key, {})
        if name not in on:
            eps = self.eps[name] if isinstance(self.eps, dict) else self.eps
            on[name] = torch.as_tensor(
                np.broadcast_to(np.asarray(eps, dtype=np.float64), (ndim,)).copy(),
            ).to(device=like.device, dtype=like.dtype)
        return on[name]

    def init_kernel_state(self, state):
        self.prepare_constants(state)
        logl = state.log_like
        for n in self.run_branches(state):
            self._eps_for(n, state.branches[n].ndim, logl)
        ks = {
            "log_scale": logl.new_zeros(()),
            "log_scale_avg": logl.new_zeros(()),
            "h_avg": logl.new_zeros(()),
            "t": torch.zeros((), dtype=torch.int32, device=logl.device),
        }
        if self.eps is None:
            ks["eps_base"] = {n: v.to(logl.dtype).clone()
                              for n, v in self._eps_base(state).items()}
        return ks

    def _cold_rows(self, *tensors):
        """Rung 0 of every walker, ``(nwalkers, ...)``, of each ``(ntemps,
        nwalkers, ...)`` tensor: under a mesh gathered from the ranks that
        hold it, on every rank."""
        lay = self.mesh_layout
        if lay is None:
            return [x[0] for x in tensors]
        return lay.gather_rung(tensors, 0)

    # -- dual averaging -------------------------------------------------------
    def _adapt_scale(self, kernel_state, cold_acc):
        """One dual-averaging update from the cold chain's mean acceptance
        ``cold_acc`` (0-d); the identity once ``t >= tune_steps``."""
        ks = kernel_state
        tuning = ks["t"] < self.tune_steps
        t = ks["t"] + 1
        tf = t.to(cold_acc.dtype)
        err = self.target_acceptance - cold_acc
        h_avg = torch.where(
            tuning,
            (1.0 - 1.0 / (tf + self._DA_T0)) * ks["h_avg"]
            + err / (tf + self._DA_T0),
            ks["h_avg"],
        )
        log_scale = torch.where(
            tuning, -torch.sqrt(tf) / self._DA_GAMMA * h_avg, ks["log_scale"])
        w = tf ** (-self._DA_KAPPA)
        log_scale_avg = torch.where(
            tuning, w * log_scale + (1.0 - w) * ks["log_scale_avg"],
            ks["log_scale_avg"])
        return {**ks, "log_scale": log_scale, "log_scale_avg": log_scale_avg,
                "h_avg": h_avg, "t": t}

    def phase_of(self, clock):
        """Under a mesh: whether a step at the clock's value still tunes
        (:meth:`~eryn_tpu_torch.moves.move.Move.mesh_tuning`)."""
        return clock < self.tune_steps if self.tune_steps > 0 else None

    def _tune_scale(self, kernel_state, cold_acc):
        """:meth:`_adapt_scale` from ``cold_acc()``, the cold chain's mean
        acceptance; under a mesh past the tuning only the clock advances,
        and ``cold_acc``'s exchange is not made."""
        if not self.mesh_tuning(kernel_state):
            return {**kernel_state, "t": kernel_state["t"] + 1}
        return self._adapt_scale(kernel_state, cold_acc())

    def _current_scale(self, kernel_state, like):
        if self.tune_steps <= 0 or not kernel_state:
            return like.new_ones(())
        tuning = kernel_state["t"] < self.tune_steps
        return torch.exp(torch.where(tuning, kernel_state["log_scale"],
                                     kernel_state["log_scale_avg"]))

    # -- draws ----------------------------------------------------------------
    def draw_noise(self, generator, coords):
        """The standard normals of one Langevin proposal, shaped like each
        branch of ``coords``, per walker."""
        return {n: self.rank_draw(
                    lambda sh, c=c: torch.randn(sh, generator=generator,
                                                dtype=c.dtype,
                                                device=c.device),
                    c.shape, per_walker=True)
                for n, c in coords.items()}

    def draw_block(self, generator, x):
        """The draws of one proposal from the walkers ``x`` (a dict over the
        moving branches), made before it (:meth:`propose_block` takes them):
        the Langevin step's normals.  A rank of a mesh that holds none of a
        preconditioned half's walkers makes them too, so that every rank
        draws what one process draws."""
        return self.draw_noise(generator, x)

    # -- shared pieces of the gradient moves ------------------------------------
    def _grad_setup(self, state, ctx):
        names = self.run_branches(state)
        coords = {n: state.branches_coords[n] for n in names}
        inds = dict(state.branches_inds)
        fixed = {n: c for n, c in state.branches_coords.items()
                 if n not in names}
        betas = self.rank_betas(state)
        return names, coords, inds, betas, grad_context(
            ctx, fixed, inds, betas, state_branch_supps(state))

    def _wrap_periodic(self, name, q):
        if self.periodic is not None:
            return self.periodic.wrap({name: q})[name]
        return q

    def _displacement(self, name, a, b):
        """``b - a``, the nearest periodic image where periodic."""
        if self.periodic is not None:
            return self.periodic.distance({name: a}, {name: b})[name]
        return b - a

    @staticmethod
    def _acceptance_probability(state, betas, factors, ll1, lp1):
        """Per-walker ``min(1, exp(lnpdiff))``, NaN as 0: what dual
        averaging and the ChEES gradient weight by."""
        logP_new = tempered_log_likelihood(ll1, betas) + lp1
        logP_old = (tempered_log_likelihood(state.log_like, betas)
                    + state.log_prior)
        lnpdiff = factors + logP_new - logP_old
        return torch.nan_to_num(torch.exp(torch.clamp(lnpdiff, max=0.0)))

    def _accept_and_merge(self, generator, state, names, coords, q, factors,
                          ll1, lp1, betas, kernel_state, bl1=None):
        logP_new = tempered_log_likelihood(ll1, betas) + lp1
        logP_old = (tempered_log_likelihood(state.log_like, betas)
                    + state.log_prior)
        acc = mh_decide(self.draw_accept(generator, logP_new, per_walker=True),
                        factors, logP_new, logP_old)
        new_coords = dict(state.branches_coords)
        for n in names:
            new_coords[n] = torch.where(acc[:, :, None, None], q[n], coords[n])
        logl = torch.where(acc, ll1, state.log_like)
        logp = torch.where(acc, lp1, state.log_prior)
        if self.tune_steps > 0 and kernel_state:
            kernel_state = self._tune_scale(
                kernel_state, lambda: self._cold_rows(
                    self._acceptance_probability(state, betas, factors, ll1,
                                                 lp1))[0].mean())
        new_state = state.replace(coords=new_coords,
                                  inds=dict(state.branches_inds),
                                  log_like=logl, log_prior=logp,
                                  blobs=merge_blobs(acc, bl1, state.blobs))
        return new_state, acc, kernel_state

    # -- the red/blue preconditioned form -------------------------------------
    @staticmethod
    def _complement_sigma(coords_c, inds_c):
        """Per-parameter spread of the complement over active leaves,
        ``(ntemps, 1, nleaves_max, ndim)`` (1 where fewer than two)."""
        mm = inds_c[..., None].to(coords_c.dtype)
        cnt = mm.sum(dim=1, keepdim=True)
        mean = (coords_c * mm).sum(dim=1, keepdim=True) / torch.clamp(
            cnt, min=1.0)
        var = ((coords_c - mean) ** 2 * mm).sum(
            dim=1, keepdim=True) / torch.clamp(cnt - 1.0, min=1.0)
        sig = torch.sqrt(var)
        return torch.where((cnt > 1.0) & (sig > 0.0), sig, 1.0)

    def _eps_for_precond(self, name, ndim, like, kernel_state):
        """With eps=None the heuristic base collapsed to its geometric mean
        (the complement's spread supplies the anisotropy); a given eps as
        it is."""
        vec = self._eps_for(name, ndim, like, kernel_state)
        if self.eps is None:
            return torch.exp(torch.log(torch.clamp(torch.abs(vec),
                                                   min=1e-12)).mean())
        return vec

    def _propose_impl_precond(self, generator, state, ctx, kernel_state=()):
        """Two permuted halves in turn, each with the other half's spread
        as its mass matrix (:meth:`_precond_half`)."""
        if self.mesh_layout is not None:
            return self._propose_impl_precond_sharded(generator, state, ctx,
                                                      kernel_state)
        names = self.run_branches(state)
        all_names = list(state.branches_coords)
        logl0 = state.log_like
        ntemps, nwalkers = logl0.shape
        betas = self.rank_betas(state)
        scale = self._current_scale(kernel_state, logl0)

        perm = self.draw_perm(generator, nwalkers, logl0.device)
        inv_perm = torch.argsort(perm)
        coords_p = {n: state.branches_coords[n][:, perm] for n in all_names}
        inds_p = {n: state.branches_inds[n][:, perm] for n in all_names}
        logl_p = logl0[:, perm]
        logp_p = state.log_prior[:, perm]
        blobs_p = None if state.blobs is None else state.blobs[:, perm]
        acc_p = torch.zeros((ntemps, nwalkers), dtype=torch.bool,
                            device=logl0.device)

        n0 = nwalkers - nwalkers // 2
        alpha_sum = logl0.new_zeros(())
        for off, ns in ((0, n0), (n0, nwalkers - n0)):
            blk = slice(off, off + ns)

            def comp(x, off=off, ns=ns):
                return torch.cat([x[:, :off], x[:, off + ns:]], dim=1)

            eps_tree = self._precond_eps(names, coords_p, inds_p, comp, scale,
                                         logl0, kernel_state)
            x = {n: coords_p[n][:, blk] for n in names}
            prev = (logl_p[:, blk], logp_p[:, blk])
            q, ll1, lp1, bl1, acc, alpha = self._precond_half(
                generator, ctx, names, x,
                {n: inds_p[n][:, blk] for n in all_names},
                {n: coords_p[n][:, blk] for n in all_names if n not in names},
                state_branch_supps(state, perm=perm, block=(off, ns)), prev,
                eps_tree, betas)
            alpha_sum = alpha_sum + alpha[0].mean()

            for n in names:
                coords_p[n][:, blk] = torch.where(acc[:, :, None, None], q[n],
                                                  x[n])
            logl_p[:, blk] = torch.where(acc, ll1, prev[0])
            logp_p[:, blk] = torch.where(acc, lp1, prev[1])
            if blobs_p is not None:
                blobs_p[:, blk] = merge_blobs(acc, bl1, blobs_p[:, blk])
            acc_p[:, blk] = acc

        if self.tune_steps > 0 and kernel_state:
            kernel_state = self._adapt_scale(kernel_state, 0.5 * alpha_sum)

        new_state = state.replace(
            coords={n: coords_p[n][:, inv_perm] for n in all_names},
            inds=dict(state.branches_inds),
            log_like=logl_p[:, inv_perm], log_prior=logp_p[:, inv_perm],
            blobs=None if blobs_p is None else blobs_p[:, inv_perm],
        )
        return new_state, acc_p[:, inv_perm], kernel_state

    def _precond_eps(self, names, coords_p, inds_p, comp, scale, like,
                     kernel_state):
        """A half's step sizes: the complement's spread (``comp`` of the
        permuted ``coords_p`` and ``inds_p``) times the base and the
        scale."""
        eps = {}
        for n in names:
            sigma = self._complement_sigma(comp(coords_p[n]), comp(inds_p[n]))
            base = self._eps_for_precond(n, coords_p[n].shape[-1], like,
                                         kernel_state)
            eps[n] = scale * base * sigma
        return eps

    def _precond_half(self, generator, ctx, names, x, inds, fixed, supps,
                      prev, eps, betas):
        """One half of the preconditioned form on its walkers ``x`` (the
        moving branches; ``inds`` every branch's masks, ``fixed`` the other
        branches, ``supps`` the half's supplementals): the proposal with the
        step sizes ``eps`` from :meth:`draw_block`'s draws, and the MH
        decision against ``prev``, ``(log_like, log_prior)``.  Returns
        ``(q, ll1, lp1, blobs1, accepted, alpha)``, ``alpha`` each walker's
        ``min(1, exp(lnpdiff))`` (NaN as 0)."""
        draws = self.draw_block(generator, x)
        grad_fn = grad_context(ctx, fixed, inds, betas, supps)
        masks = {n: inds[n][..., None] for n in names}
        q, ll1, lp1, factors, bl1 = self.propose_block(draws, names, x, masks,
                                                       eps, grad_fn)
        logP_new = tempered_log_likelihood(ll1, betas) + lp1
        logP_old = tempered_log_likelihood(prev[0], betas) + prev[1]
        acc = mh_decide(self.draw_accept(generator, logP_new, per_walker=True),
                        factors, logP_new, logP_old)
        alpha = torch.nan_to_num(torch.exp(torch.clamp(
            factors + logP_new - logP_old, max=0.0)))
        return q, ll1, lp1, bl1, acc, alpha

    def _propose_impl_precond_sharded(self, generator, state, ctx,
                                      kernel_state):
        """:meth:`_propose_impl_precond` on this rank's shard of a state
        sharded over a ``(temp, walker)`` mesh, equal to one process's: each
        half's complement filled in by
        :class:`~eryn_tpu_torch.moves.red_blue.WalkerBlocks`, its spread
        computed on the whole complement, :meth:`_precond_half` on the
        rank's walkers of the half (the half's draws, kept for them:
        :meth:`~eryn_tpu_torch.moves.move.Move.block_walkers`), and while
        tuning the cold acceptance of every walker gathered once for the
        dual averaging."""
        lay = self.mesh_layout
        names = self.run_branches(state)
        all_names = list(state.branches_coords)
        logl0 = state.log_like
        NW, device = lay.nwalkers, logl0.device
        betas = self.rank_betas(state)
        scale = self._current_scale(kernel_state, logl0)
        perm = self.draw_perm(generator, NW, device)
        view = WalkerBlocks(lay, state)
        alpha = logl0.new_zeros((lay.nt, NW))
        n0 = NW - NW // 2
        halves = []
        for blk in view.blocks(perm, (n0, NW - n0), (0, n0)):
            halves.append(blk.idx)
            at, idx = blk.pos, blk.own_idx

            def comp(x, off=blk.off, ns=blk.ns):
                return torch.cat([x[:, :off], x[:, off + ns:]], dim=1)

            def mine(x, block=slice(blk.off, blk.off + blk.ns), at=at):
                return x[:, block][:, at]

            eps_tree = self._precond_eps(names, blk.coords_p, blk.inds_p,
                                         comp, scale, logl0, kernel_state)
            x = {n: mine(blk.coords_p[n]) for n in names}
            with self.block_walkers(blk.ns, at):
                prev = (view.log_like[:, idx], view.log_prior[:, idx])
                # supplementals do not run sharded
                q, ll1, lp1, _, acc, alpha_half = self._precond_half(
                    generator, ctx, names, x,
                    {n: mine(blk.inds_p[n]) for n in all_names},
                    {n: mine(blk.coords_p[n]) for n in all_names
                     if n not in names}, None, prev, eps_tree, betas)
            alpha[:, idx] = alpha_half
            for n in names:
                view.coords[n][:, idx] = torch.where(acc[:, :, None, None],
                                                     q[n], x[n])
            view.log_like[:, idx] = torch.where(acc, ll1, prev[0])
            view.log_prior[:, idx] = torch.where(acc, lp1, prev[1])
            view.accepted[:, idx] = acc

        if self.tune_steps > 0 and kernel_state:
            def cold_acc():
                # each half's cold acceptance in its walkers' order, as one
                # process takes its mean
                cold = self._cold_rows(lay.own(alpha))[0]
                alpha_sum = logl0.new_zeros(())
                for idx in halves:
                    alpha_sum = alpha_sum + cold[idx].mean()
                return 0.5 * alpha_sum

            kernel_state = self._tune_scale(kernel_state, cold_acc)
        new_state, accepted = view.result(state)
        return new_state, accepted, kernel_state

    def _mala_factors(self, names, x, q, grad_x, grad_q, masks, eps, like):
        """``log q(q -> x) - log q(x -> q)`` over active coordinates, with
        ``log q(a -> b) = -|d(a, b) - (eps^2/2) grad(a)|^2 / (2 eps^2)``."""
        factors = like.new_zeros(like.shape)
        for n in names:
            e2 = eps[n] ** 2
            fwd = self._displacement(n, x[n], q[n]) - 0.5 * e2 * grad_x[n]
            rev = self._displacement(n, q[n], x[n]) - 0.5 * e2 * grad_q[n]
            contrib = (rev ** 2 - fwd ** 2) / (2.0 * e2)
            factors = factors - torch.where(masks[n], contrib, 0.0).sum(
                dim=(-2, -1))
        return factors

    def propose_block(self, draws, names, x, masks, eps, grad_fn):
        """The Langevin proposal from ``x`` with :meth:`draw_block`'s
        ``draws``: ``(q, ll1, lp1, factors, blobs1)``."""
        _, grad_x = grad_fn(x)
        q = {}
        for n in names:
            step = 0.5 * eps[n] ** 2 * grad_x[n] + eps[n] * draws[n]
            q[n] = self._wrap_periodic(
                n, x[n] + torch.where(masks[n], step, 0.0))
        aux, grad_q = grad_fn(q)
        ll1, lp1, bl1 = unpack_aux(aux)
        factors = self._mala_factors(names, x, q, grad_x, grad_q, masks, eps,
                                     ll1)
        return q, ll1, lp1, factors, bl1

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        if self.ensemble_precondition:
            return self._propose_impl_precond(generator, state, ctx,
                                              kernel_state)
        names, coords, inds, betas, grad_fn = self._grad_setup(state, ctx)
        scale = self._current_scale(kernel_state, state.log_like)
        eps = {n: scale * self._eps_for(n, coords[n].shape[-1],
                                        state.log_like, kernel_state)
               for n in names}
        masks = {n: inds[n][..., None] for n in names}
        q, ll1, lp1, factors, bl1 = self.propose_block(
            self.draw_block(generator, coords), names, coords, masks, eps,
            grad_fn)
        return self._accept_and_merge(generator, state, names, coords, q,
                                      factors, ll1, lp1, betas, kernel_state,
                                      bl1)
