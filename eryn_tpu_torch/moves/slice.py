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

On a state sharded over a device mesh each block runs on this rank's
walkers of it (``min(nw, ns)`` rows, the padding sitting the block out),
the complement filled in by the red/blue family's
:class:`~eryn_tpu_torch.moves.red_blue.WalkerBlocks`; the loops' exit is
not global, so the loops need no collective, and one all-reduce a block
gathers what the counters and ``mu`` read.
"""

from __future__ import annotations

import torch

from .move import Move, merge_blobs, state_branch_supps
from .red_blue import WalkerBlocks
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
    _mesh_sharded = True

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
        ns)``; one per walker of the block."""
        kw = dict(generator=generator, device=like.device)
        shape = (ntemps, ns)

        def randint(lo, hi):
            return self.rank_draw(lambda sh: torch.randint(lo, hi, sh, **kw),
                                  shape, per_walker=True)

        def rand(sh):
            return torch.rand(sh, dtype=like.dtype, **kw)

        l_idx = randint(0, nc)
        m_idx = randint(0, nc - 1)
        y = self.rank_draw(rand, shape, per_walker=True)
        J = randint(0, self.max_expand)
        u0 = self.rank_draw(rand, shape, per_walker=True)
        u_shrink = self.rank_draw_rounds(rand, self.max_shrink, shape)
        return l_idx, m_idx, y, J, u0, u_shrink

    def _splits(self, nwalkers):
        sizes = [nwalkers // self.nsplits
                 + (1 if i < nwalkers % self.nsplits else 0)
                 for i in range(self.nsplits)]
        if nwalkers - max(sizes) < 2:
            raise RuntimeError(
                "SliceMove needs at least two complement walkers per block "
                f"(nwalkers={nwalkers}, nsplits={self.nsplits} leaves a "
                f"complement of {nwalkers - max(sizes)}).")
        return sizes, [sum(sizes[:i]) for i in range(self.nsplits)]

    def _slice_block(self, ctx, names, param_masks, mu, draws, comp_coords,
                     s_coords, fixed, inds_eval, supps, prev, betas,
                     rows=None):
        """Slice-sample one block's walkers ``s_coords`` (``(nt, m, ...)``
        per moving branch) along directions from the complement
        ``comp_coords`` (every branch, ``(nt, nc, ...)``), ``draws`` being
        :meth:`draw_slice`'s for these walkers and ``prev`` their
        ``(log_like, log_prior, blobs)``; ``rows`` (``(m,)`` bool), where
        given, marks the walkers that sample: the others (a mesh rank's
        padding) sit the block out and count nothing.

        Returns ``(coords, log_like, log_prior, blobs, accepted, flags, ne,
        ncnt)``: the walkers' new values, whether each moved, each loop
        iteration's flag that a walker still needed it (stepping out's,
        then shrinkage's, ``(max_expand - 1 + max_shrink,)`` bool), and the
        expansions and contractions made."""
        l_idx, m_idx, y_u, J, u0, u_shrink = draws
        prev_logl, prev_logp, prev_bl = prev
        ntemps, m = prev_logl.shape
        dtype, device = prev_logl.dtype, prev_logl.device
        m_idx = m_idx + (m_idx >= l_idx).to(m_idx.dtype)
        eta = {}
        for n in names:
            c_all = comp_coords[n]
            idx_shape = (-1, -1) + tuple(c_all.shape[2:])
            c_l = torch.gather(c_all, 1,
                               l_idx[:, :, None, None].expand(idx_shape))
            c_m = torch.gather(c_all, 1,
                               m_idx[:, :, None, None].expand(idx_shape))
            e = mu * self._displacement(n, c_m, c_l)
            e = e * inds_eval[n][..., None]  # dormant leaves stay put
            mask = param_masks.get(n) if param_masks else None
            if mask is not None:
                e = e * mask
            eta[n] = e.to(dtype)

        # a walker with an identically zero direction has nothing to
        # sample and sits the block out
        act = torch.zeros((ntemps, m), dtype=torch.bool, device=device)
        for n in names:
            act = act | (eta[n] != 0).any(dim=3).any(dim=2)
        if rows is not None:
            act = act & rows

        def eval_at(lam):
            """Tempered log posterior, log-likelihood, log prior and blobs
            at ``x + lam * eta``."""
            q = {n: self._wrap(n, s_coords[n] + lam[:, :, None, None] * eta[n])
                 for n in names}
            lp = ctx.compute_log_prior({**fixed, **q}, inds_eval)
            ll, bl = ctx.compute_log_like({**fixed, **q}, inds_eval, lp,
                                          supps)
            return tempered_log_likelihood(ll, betas) + lp, ll, lp, bl

        logP0 = tempered_log_likelihood(prev_logl, betas) + prev_logp
        # log1p(-u): u == 0 must not give y = -inf
        y = logP0 + torch.log1p(-y_u)

        # stepping out: a walker whose ends are bound (J = K = 0) no longer
        # changes, so the loop runs to its cap
        K = (self.max_expand - 1) - J
        J = torch.where(act, J, 0)
        K = torch.where(act, K, 0)
        L = -u0
        R = L + 1.0
        ne = prev_logl.new_zeros(())
        flags = []
        for _ in range(self.max_expand - 1):
            flags.append(((J > 0) | (K > 0)).any())
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
        lam_sel = prev_logl.new_zeros((ntemps, m))
        done = ~act
        ll_sel, lp_sel, bl_sel = prev_logl, prev_logp, prev_bl
        ncnt = prev_logl.new_zeros(())
        for it in range(self.max_shrink):
            flags.append((~done).any())
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

        # resolved walkers take the slice point; truncated ones keep theirs
        lam_fin = torch.where(done, lam_sel, 0.0)
        coords = {}
        for n in names:
            qn = self._wrap(n, s_coords[n] + lam_fin[:, :, None, None] * eta[n])
            coords[n] = torch.where(done[:, :, None, None], qn, s_coords[n])
        return (coords, torch.where(done, ll_sel, prev_logl),
                torch.where(done, lp_sel, prev_logp),
                None if prev_bl is None else merge_blobs(done, bl_sel, prev_bl),
                done & act, torch.stack(flags), ne, ncnt)

    def _tuned(self, kernel_state, ne_total, nc_total):
        """The kernel state after a proposal: ``mu`` by zeus eq. 16 from the
        proposal's expansions and contractions, frozen after
        ``tune_steps``."""
        mu, t = kernel_state["mu"], kernel_state["t"]
        if self.tune_steps > 0:
            tuning = t < self.tune_steps
            total = ne_total + nc_total
            factor = torch.where(
                total > 0, 2.0 * ne_total / torch.clamp(total, min=1.0), 1.0)
            # an all-contraction round must shrink mu, not zero it
            factor = torch.clamp(factor, 0.5, 2.0)
            mu = torch.where(tuning, mu * factor, mu)
        return {"mu": mu, "t": t + 1}

    def _propose_impl(self, generator, state, ctx, kernel_state):
        if self.mesh_layout is not None:
            return self._propose_impl_sharded(generator, state, ctx,
                                              kernel_state)
        logl = state.log_like
        ntemps, nwalkers = logl.shape
        device = logl.device
        coords = dict(state.branches_coords)
        inds = dict(state.branches_inds)
        logp = state.log_prior
        blobs = state.blobs
        betas = self.rank_betas(state)
        accepted = torch.zeros((ntemps, nwalkers), dtype=torch.bool,
                               device=device)
        mu = kernel_state["mu"]
        ne_total = logl.new_zeros(())
        nc_total = logl.new_zeros(())
        # out of place: under the batched runner's map the counts are per
        # group
        needed = [torch.zeros((), dtype=torch.int64, device=device)
                  for _ in range(3)]
        E = self.max_expand - 1
        sizes, offsets = self._splits(nwalkers)
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

                def comp(x, off=off, ns=ns):
                    return torch.cat([x[:, :off], x[:, off + ns:]], dim=1)

                draws = self.draw_slice(generator, ntemps, ns, nwalkers - ns,
                                        logl)
                q, ll, lp, bl, acc, flags, ne, ncnt = self._slice_block(
                    ctx, names, param_masks, mu, draws,
                    {n: comp(coords_p[n]) for n in names},
                    {n: coords_p[n][:, blk] for n in names},
                    {n: coords_p[n][:, blk] for n in all_names
                     if n not in names},
                    {n: inds_p[n][:, blk] for n in all_names},
                    state_branch_supps(state, perm=perm, block=(off, ns)),
                    (logl_p[:, blk], logp_p[:, blk],
                     None if blobs_p is None else blobs_p[:, blk]), betas)
                needed[0] = needed[0] + flags[:E].sum()
                needed[1] = needed[1] + flags[E:].sum()
                needed[2] = needed[2] + 1
                ne_total = ne_total + ne
                nc_total = nc_total + ncnt
                for n in names:
                    coords_p[n][:, blk] = q[n]
                logl_p[:, blk] = ll
                logp_p[:, blk] = lp
                if blobs_p is not None:
                    blobs_p[:, blk] = bl
                acc_p[:, blk] = acc | acc_p[:, blk]

            coords = {n: coords_p[n][:, inv_perm] for n in all_names}
            logl = logl_p[:, inv_perm]
            logp = logp_p[:, inv_perm]
            if blobs_p is not None:
                blobs = blobs_p[:, inv_perm]
            accepted = acc_p[:, inv_perm]

        if self.loop_iterations is not None:
            self.loop_iterations.add_(torch.stack(needed))
        new_state = state.replace(coords=coords, inds=inds, log_like=logl,
                                  log_prior=logp, blobs=blobs)
        return new_state, accepted, self._tuned(kernel_state, ne_total,
                                                nc_total)

    def _propose_impl_sharded(self, generator, state, ctx, kernel_state):
        """One proposal on this rank's shard of a state sharded over a
        ``(temp, walker)`` mesh, equal to one process's: each block's
        complement filled in by
        :class:`~eryn_tpu_torch.moves.red_blue.WalkerBlocks`, the block's
        draws made whole and kept for the rank's walkers of it
        (:meth:`~eryn_tpu_torch.moves.move.Move.block_walkers`), the loops
        on those walkers, and one all-reduce a block of its loops'
        per-iteration flags (an OR across the ranks) and its expansions and
        contractions (integer counts, exact as floats)."""
        lay = self.mesh_layout
        logl = state.log_like
        NW, device, dtype = lay.nwalkers, logl.device, logl.dtype
        betas = self.rank_betas(state)
        mu = kernel_state["mu"]
        ne_total = logl.new_zeros(())
        nc_total = logl.new_zeros(())
        needed = torch.zeros(3, dtype=torch.int64, device=device)
        E = self.max_expand - 1
        sizes, offsets = self._splits(NW)
        all_names = list(state.branches)
        view = WalkerBlocks(lay, state)

        for names, param_masks in self.gibbs_iterations_for(state):
            perm = (self.draw_perm(generator, NW, device)
                    if self.randomize_split
                    else torch.arange(NW, device=device))
            for blk in view.blocks(perm, sizes, offsets):
                block = slice(blk.off, blk.off + blk.ns)
                at, idx = blk.pos, blk.own_idx
                with self.block_walkers(blk.ns, at):
                    draws = self.draw_slice(generator, lay.nt, blk.ns,
                                            NW - blk.ns, logl)

                def comp(x, off=blk.off, ns=blk.ns):
                    return torch.cat([x[:, :off], x[:, off + ns:]], dim=1)

                def mine(x, block=block):
                    return x[:, block][:, at]

                q, ll, lp, _, acc, flags, ne, ncnt = self._slice_block(
                    ctx, names, param_masks, mu, draws,
                    {n: comp(blk.coords_p[n]) for n in names},
                    {n: mine(blk.coords_p[n]) for n in names},
                    {n: mine(blk.coords_p[n]) for n in all_names
                     if n not in names},
                    {n: mine(blk.inds_p[n]) for n in all_names},
                    None, (view.log_like[:, idx], view.log_prior[:, idx],
                           None), betas, rows=blk.valid)
                for n in names:
                    view.coords[n][:, idx] = q[n]
                view.log_like[:, idx] = ll
                view.log_prior[:, idx] = lp
                view.accepted[:, idx] = acc | view.accepted[:, idx]
                totals = torch.cat([flags.to(dtype), ne[None], ncnt[None]])
                lay.sum(totals)
                flags = totals[:-2] > 0
                needed += torch.stack([flags[:E].sum(), flags[E:].sum(),
                                       torch.ones((), dtype=torch.int64,
                                                  device=device)])
                ne_total = ne_total + totals[-2]
                nc_total = nc_total + totals[-1]

        if self.loop_iterations is not None:
            self.loop_iterations.add_(needed)
        new_state, accepted = view.result(state)
        return new_state, accepted, self._tuned(kernel_state, ne_total,
                                                nc_total)
