"""Ensemble slice sampling (zeus, Karamanis & Beutler 2021).

Port of :mod:`eryn_tpu.moves.slice`: each walker slice-samples the tempered
posterior along ``eta = mu (c_l - c_m)``, two distinct walkers of the other
red/blue block; it accepts by construction, and ``mu`` tunes itself from
the ratio of expansions to contractions for ``tune_steps`` proposals.

Stepping out (Neal 2003, the expansion budget ``max_expand - 1`` split at
random between the two ends) and shrinkage are loops whose trip count is
data: ``eryn_tpu`` runs them as ``lax.while_loop``\\ s that stop when every
walker is resolved.  Here both run to their caps inside the step's CUDA
graph (``max_expand - 1`` and ``max_shrink`` iterations): a resolved
walker's interval, point, likelihood and counters do not change in a later
iteration, so the result is the early-exit loop's, and no step reads a
device value on the host.  Each iteration's numbers are drawn up front,
``(cap, ntemps, ns)``, iteration ``i`` using draw ``i``.
:attr:`SliceMove.loop_iterations` counts on the device the iterations each
loop needed.
"""

from __future__ import annotations

import torch

from .move import Move, merge_blobs, state_branch_supps
from .tempering import tempered_log_likelihood

__all__ = ["SliceMove"]


class SliceMove(Move):
    """Differential ensemble slice proposal.

    Args:
        mu: initial direction scale.
        max_expand: ``max_expand - 1`` interval expansions per walker, split
            at random between the ends (1 allows none).
        max_shrink: shrinkage iterations; a walker still unresolved after
            them keeps its point.
        tune_steps: proposals that adapt ``mu`` (0 disables it).
        nsplits: walker blocks updated in turn; randomize_split: permute
            walkers into blocks every proposal.
    """

    device_counters = ("loop_iterations",)

    def __init__(self, mu=1.0, max_expand=6, max_shrink=16, tune_steps=500,
                 nsplits=2, randomize_split=True, **kwargs):
        super().__init__(**kwargs)
        self.mu0 = float(mu)
        self.max_expand = int(max_expand)
        self.max_shrink = int(max_shrink)
        self.tune_steps = int(tune_steps)
        self.nsplits = int(nsplits)
        self.randomize_split = bool(randomize_split)
        if self.max_expand < 1 or self.max_shrink < 1:
            raise ValueError("max_expand and max_shrink must be >= 1.")
        #: int64 device counters ``[stepping-out iterations needed,
        #: shrinkage iterations needed, loops run]`` over every block of
        #: every proposal (from the first kernel state on); the caps are
        #: ``max_expand - 1`` and ``max_shrink`` a loop
        self.loop_iterations = None

    def init_kernel_state(self, state):
        self.prepare_constants(state)
        logl = state.log_like
        if self.loop_iterations is None:
            self.loop_iterations = torch.zeros(3, dtype=torch.int64,
                                               device=logl.device)
        return {"mu": torch.full((), self.mu0, dtype=logl.dtype,
                                 device=logl.device),
                "t": torch.zeros((), dtype=torch.int32, device=logl.device)}

    def _displacement(self, name, a, b):
        if self.periodic is not None:
            return self.periodic.distance({name: a}, {name: b})[name]
        return b - a

    def _wrap(self, name, q):
        if self.periodic is not None:
            return self.periodic.wrap({name: q})[name]
        return q

    def draw_slice(self, generator, ntemps, ns, nc, like):
        """Randomness of one block: the direction's two index draws in
        ``[0, nc)`` and ``[0, nc - 1)``, the slice level's uniform, the
        expansion budget ``J`` in ``[0, max_expand)``, the interval's
        offset uniform, and the shrinkage uniforms ``(max_shrink, ntemps,
        ns)``."""
        kw = dict(generator=generator, device=like.device)
        shape = (ntemps, ns)
        l_idx = torch.randint(0, nc, shape, **kw)
        m_idx = torch.randint(0, nc - 1, shape, **kw)
        y = torch.rand(shape, dtype=like.dtype, **kw)
        J = torch.randint(0, self.max_expand, shape, **kw)
        u0 = torch.rand(shape, dtype=like.dtype, **kw)
        u_shrink = torch.rand((self.max_shrink,) + shape, dtype=like.dtype,
                              **kw)
        return l_idx, m_idx, y, J, u0, u_shrink

    def _propose_impl(self, generator, state, ctx, kernel_state):
        logl = state.log_like
        ntemps, nwalkers = logl.shape
        dtype, device = logl.dtype, logl.device
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logp = state.log_prior
        blobs = state.blobs
        betas = state.betas
        if betas is None:
            betas = logl.new_ones((ntemps,))
        accepted = torch.zeros((ntemps, nwalkers), dtype=torch.bool,
                               device=device)
        mu = kernel_state["mu"]
        ne_total = logl.new_zeros(())
        nc_total = logl.new_zeros(())
        # out of place: under the batched runner's map the counts are per
        # group
        needed = [torch.zeros((), dtype=torch.int64, device=device)
                  for _ in range(3)]

        sizes = [nwalkers // self.nsplits
                 + (1 if i < nwalkers % self.nsplits else 0)
                 for i in range(self.nsplits)]
        offsets = [sum(sizes[:i]) for i in range(self.nsplits)]
        if nwalkers - max(sizes) < 2:
            raise RuntimeError(
                "SliceMove needs at least two complement walkers per block "
                f"(nwalkers={nwalkers}, nsplits={self.nsplits} leaves a "
                f"complement of {nwalkers - max(sizes)}).")
        all_names = list(coords)

        for names, param_masks in self.gibbs_iterations_for(state):
            if self.randomize_split:
                perm = self.draw_perm(generator, nwalkers, device)
                inv_perm = torch.argsort(perm)
            else:
                perm = inv_perm = torch.arange(nwalkers, device=device)
            coords_p = {n: coords[n][:, perm] for n in all_names}
            inds_p = {n: inds[n][:, perm] for n in all_names}
            logl_p = logl[:, perm]
            logp_p = logp[:, perm]
            blobs_p = None if blobs is None else blobs[:, perm]
            acc_p = accepted[:, perm]

            for off, ns in zip(offsets, sizes):
                blk = slice(off, off + ns)
                nc = nwalkers - ns

                def comp(x, off=off, ns=ns):
                    return torch.cat([x[:, :off], x[:, off + ns:]], dim=1)

                s_coords = {n: coords_p[n][:, blk] for n in names}
                s_inds = {n: inds_p[n][:, blk] for n in names}
                l_idx, m_idx, y_u, J, u0, u_shrink = self.draw_slice(
                    generator, ntemps, ns, nc, logl)
                m_idx = m_idx + (m_idx >= l_idx).to(m_idx.dtype)
                eta = {}
                for n in names:
                    c_all = comp(coords_p[n])
                    idx_shape = (-1, -1) + tuple(c_all.shape[2:])
                    c_l = torch.gather(c_all, 1,
                                       l_idx[:, :, None, None].expand(idx_shape))
                    c_m = torch.gather(c_all, 1,
                                       m_idx[:, :, None, None].expand(idx_shape))
                    e = mu * self._displacement(n, c_m, c_l)
                    e = e * s_inds[n][..., None]  # dormant leaves stay put
                    mask = param_masks.get(n) if param_masks else None
                    if mask is not None:
                        e = e * mask
                    eta[n] = e.to(dtype)

                # a walker with an identically zero direction has nothing to
                # sample and sits the block out
                act = torch.zeros((ntemps, ns), dtype=torch.bool,
                                  device=device)
                for n in names:
                    act = act | (eta[n] != 0).any(dim=3).any(dim=2)

                fixed = {n: coords_p[n][:, blk] for n in all_names
                         if n not in names}
                inds_eval = {n: inds_p[n][:, blk] for n in all_names}
                supps_blk = state_branch_supps(state, perm=perm,
                                               block=(off, ns))

                def eval_at(lam, s_coords=s_coords, eta=eta, fixed=fixed,
                            inds_eval=inds_eval, supps_blk=supps_blk):
                    """Tempered log posterior, log-likelihood, log prior and
                    blobs at ``x + lam * eta``."""
                    q = {n: self._wrap(n, s_coords[n]
                                       + lam[:, :, None, None] * eta[n])
                         for n in names}
                    lp = ctx.compute_log_prior({**fixed, **q}, inds_eval)
                    ll, bl = ctx.compute_log_like({**fixed, **q}, inds_eval,
                                                  lp, supps_blk)
                    return tempered_log_likelihood(ll, betas) + lp, ll, lp, bl

                prev_logl = logl_p[:, blk]
                prev_logp = logp_p[:, blk]
                logP0 = tempered_log_likelihood(prev_logl, betas) + prev_logp
                # log1p(-u): u == 0 must not give y = -inf
                y = logP0 + torch.log1p(-y_u)

                # stepping out: a walker whose ends are bound (J = K = 0)
                # no longer changes, so the loop runs to its cap
                K = (self.max_expand - 1) - J
                J = torch.where(act, J, 0)
                K = torch.where(act, K, 0)
                L = -u0
                R = L + 1.0
                ne = logl.new_zeros(())
                for _ in range(self.max_expand - 1):
                    needed[0] = needed[0] + ((J > 0) | (K > 0)).any()
                    logP_L = eval_at(L)[0]
                    logP_R = eval_at(R)[0]
                    growL = (J > 0) & (logP_L > y)
                    growR = (K > 0) & (logP_R > y)
                    L = torch.where(growL, L - 1.0, L)
                    R = torch.where(growR, R + 1.0, R)
                    J = torch.where(growL, J - 1, 0)
                    K = torch.where(growR, K - 1, 0)
                    ne = ne + growL.sum().to(dtype) + growR.sum().to(dtype)

                # shrinkage: a resolved walker no longer changes
                lam_sel = logl.new_zeros((ntemps, ns))
                done = ~act
                ll_sel, lp_sel = prev_logl, prev_logp
                bl_sel = None if blobs_p is None else blobs_p[:, blk]
                ncnt = logl.new_zeros(())
                for it in range(self.max_shrink):
                    needed[1] = needed[1] + (~done).any()
                    lam = L + u_shrink[it] * (R - L)
                    logP, ll, lp, bl = eval_at(lam)
                    in_slice = logP > y
                    newly = in_slice & ~done
                    lam_sel = torch.where(newly, lam, lam_sel)
                    ll_sel = torch.where(newly, ll, ll_sel)
                    lp_sel = torch.where(newly, lp, lp_sel)
                    bl_sel = merge_blobs(newly, bl, bl_sel)
                    shrinkL = ~in_slice & ~done & (lam < 0)
                    shrinkR = ~in_slice & ~done & (lam >= 0)
                    L = torch.where(shrinkL, lam, L)
                    R = torch.where(shrinkR, lam, R)
                    ncnt = ncnt + (shrinkL | shrinkR).sum().to(dtype)
                    done = done | in_slice
                needed[2] = needed[2] + 1
                ne_total = ne_total + ne
                nc_total = nc_total + ncnt

                # resolved walkers take the slice point; truncated ones keep
                # theirs
                lam_fin = torch.where(done, lam_sel, 0.0)
                for n in names:
                    qn = self._wrap(n, s_coords[n]
                                    + lam_fin[:, :, None, None] * eta[n])
                    coords_p[n][:, blk] = torch.where(done[:, :, None, None],
                                                      qn, s_coords[n])
                logl_p[:, blk] = torch.where(done, ll_sel, prev_logl)
                logp_p[:, blk] = torch.where(done, lp_sel, prev_logp)
                if blobs_p is not None:
                    blobs_p[:, blk] = merge_blobs(done, bl_sel,
                                                  blobs_p[:, blk])
                acc_p[:, blk] = (done & act) | acc_p[:, blk]

            coords = {n: coords_p[n][:, inv_perm] for n in all_names}
            logl = logl_p[:, inv_perm]
            logp = logp_p[:, inv_perm]
            if blobs_p is not None:
                blobs = blobs_p[:, inv_perm]
            accepted = acc_p[:, inv_perm]

        # zeus eq. 16, frozen after tune_steps
        t = kernel_state["t"]
        if self.tune_steps > 0:
            tuning = t < self.tune_steps
            total = ne_total + nc_total
            factor = torch.where(
                total > 0, 2.0 * ne_total / torch.clamp(total, min=1.0), 1.0)
            # an all-contraction round must shrink mu, not zero it
            factor = torch.clamp(factor, 0.5, 2.0)
            mu_new = torch.where(tuning, mu * factor, mu)
        else:
            mu_new = mu
        if self.loop_iterations is not None:
            self.loop_iterations.add_(torch.stack(needed))

        new_state = state.replace(coords=coords, inds=inds, log_like=logl,
                                  log_prior=logp, blobs=blobs)
        return new_state, accepted, {"mu": mu_new, "t": t + 1}
