"""ChEES-HMC: HMC whose trajectory length adapts.

Port of :mod:`eryn_tpu.moves.chees` (Hoffman, Radul & Sountsov 2021).  All
walkers share one jittered trajectory of ``L = clip(ceil(u T / eps), 1,
max_leapfrog)`` leapfrog steps per proposal, ``u`` from the base-2 Halton
sequence of the proposal counter, and ``log T`` ascends the ChEES criterion
by Adam while the step size adapts by dual averaging; both freeze after
``tune_steps`` proposals.

``L`` is a device value that changes every proposal.  The step's CUDA graph
runs ``max_leapfrog`` leapfrog iterations, and iteration ``i`` updates the
carry only where ``i < L``: the result is that of ``eryn_tpu``'s
``lax.while_loop`` of ``L`` iterations, at up to ``max_leapfrog / L`` times
its gradient evaluations, and no step reads ``L`` on the host.
:attr:`ChEESHMCMove.leapfrog_total` sums ``L`` on the device.

On a state sharded over a device mesh ``L`` is whole on every rank (the
kernel state is), the momenta are per walker, and the ChEES criterion
centres the cold rung's rows of every walker, gathered
(:meth:`~eryn_tpu_torch.parallel.mesh.MeshLayout.gather_rung`), as one
process does, while it tunes.
"""

from __future__ import annotations

import torch

from .hmc import HMCMove
from .mala import unpack_aux
from .move import merge_blobs

__all__ = ["ChEESHMCMove"]

_MASK32 = 0xFFFFFFFF


def _halton2(t, dtype):
    """The ``t``-th element of the base-2 Halton (van der Corput) sequence
    in (0, 1): the 32 bits of ``t + 1`` reversed, in int64 ops on ``t``'s
    device."""
    i = (t.to(torch.int64) + 1) & _MASK32
    i = ((i & 0x55555555) << 1) | ((i >> 1) & 0x55555555)
    i = ((i & 0x33333333) << 2) | ((i >> 2) & 0x33333333)
    i = ((i & 0x0F0F0F0F) << 4) | ((i >> 4) & 0x0F0F0F0F)
    i = ((i & 0x00FF00FF) << 8) | ((i >> 8) & 0x00FF00FF)
    i = ((i << 16) & _MASK32) | (i >> 16)
    return i.to(dtype) * 2.0 ** -32


class ChEESHMCMove(HMCMove):
    """HMC with ChEES-adapted jittered trajectory lengths.

    Args:
        eps: leapfrog step size, as :class:`HMCMove`'s.
        max_leapfrog: the cap on ``L``, and the leapfrog iterations every
            step runs in its graph.
        init_num_leapfrog: the initial trajectory length in steps.
        adam_lr: Adam's learning rate for ``log T`` (the paper's 0.025).
        target_acceptance / tune_steps: dual averaging, inherited (0.651 is
            the paper's target).

    Periodic parameters enter the criterion unwrapped (a tuning heuristic:
    exactness is unaffected); inactive leaves carry zero momentum and zero
    centred coordinates.
    """

    device_counters = ("leapfrog_total",)
    _mesh_sharded = True

    def __init__(self, eps=None, max_leapfrog=32, init_num_leapfrog=5,
                 adam_lr=0.025, target_acceptance=0.651, tune_steps=500,
                 **kwargs):
        super().__init__(eps=eps, num_leapfrog=int(max_leapfrog),
                         target_acceptance=target_acceptance,
                         tune_steps=tune_steps, **kwargs)
        if self.ensemble_precondition:
            raise NotImplementedError(
                "ensemble_precondition is not implemented for ChEESHMCMove "
                "(the ChEES criterion needs the full cold-chain ensemble, "
                "not red/blue halves); use HMCMove(ensemble_precondition="
                "True) or a per-parameter eps array.")
        self.max_leapfrog = int(max_leapfrog)
        self.init_num_leapfrog = int(init_num_leapfrog)
        self.adam_lr = float(adam_lr)
        if not 1 <= self.init_num_leapfrog <= self.max_leapfrog:
            raise ValueError(
                f"init_num_leapfrog must lie in [1, max_leapfrog], got "
                f"{init_num_leapfrog} with max_leapfrog={max_leapfrog}.")
        #: sum of ``L`` over the proposals made (a 0-d int64 device tensor
        #: from the first kernel state on); with ``num_proposals`` it gives
        #: the mean trajectory length beside ``max_leapfrog``
        self.leapfrog_total = None

    def init_kernel_state(self, state):
        ks = super().init_kernel_state(state)
        logl = state.log_like
        logs = [torch.log(torch.clamp(torch.abs(
            self._eps_for(n, state.branches[n].ndim, logl, ks)), min=1e-12)
        ).reshape(-1) for n in self.run_branches(state)]
        eps_time = torch.exp(torch.cat(logs).mean()).to(logl.dtype)
        ks["eps_time_base"] = eps_time
        ks["log_T"] = torch.log(self.init_num_leapfrog * eps_time)
        ks["adam_m"] = logl.new_zeros(())
        ks["adam_v"] = logl.new_zeros(())
        if self.leapfrog_total is None:
            self.leapfrog_total = torch.zeros((), dtype=torch.int64,
                                              device=logl.device)
        return ks

    def _propose_impl(self, generator, state, ctx, kernel_state=()):
        names, coords, inds, betas, grad_fn = self._grad_setup(state, ctx)
        ks = kernel_state if isinstance(kernel_state, dict) else {}
        logl0 = state.log_like
        scale = self._current_scale(ks, logl0)
        eps = {n: scale * self._eps_for(n, coords[n].shape[-1], logl0, ks)
               for n in names}
        masks = {n: inds[n][..., None] for n in names}

        if ks:
            u = _halton2(ks["t"], logl0.dtype)
            eps_time = scale * ks["eps_time_base"]
            T = torch.exp(ks["log_T"])
            L = torch.clamp(torch.ceil(u * T / eps_time), 1,
                            self.max_leapfrog).to(torch.int32)
            if self.tune_steps <= 0:
                # the counter drives the jitter; dual averaging does not
                # advance it without tuning
                ks = {**ks, "t": ks["t"] + 1}
        else:
            # bare call without a kernel state: a fixed length
            u = eps_time = T = None
            L = torch.full((), self.init_num_leapfrog, dtype=torch.int32,
                           device=logl0.device)

        p0 = self._momenta(self.draw_momenta(generator, coords), names,
                           masks)
        kinetic, half_kick, drift = self._leapfrog_fns(names, masks, eps)
        aux, g = grad_fn(coords)
        ll1, lp1, bl1 = unpack_aux(aux)
        x1, p1 = coords, p0
        for i in range(self.max_leapfrog):
            act = i < L
            p = half_kick(p1, g)
            x = drift(x1, p)
            aux, g_new = grad_fn(x)
            ll, lp, bl = unpack_aux(aux)
            p = half_kick(p, g_new)
            x1 = {n: torch.where(act, x[n], x1[n]) for n in names}
            p1 = {n: torch.where(act, p[n], p1[n]) for n in names}
            g = {n: torch.where(act, g_new[n], g[n]) for n in names}
            ll1 = torch.where(act, ll, ll1)
            lp1 = torch.where(act, lp, lp1)
            bl1 = merge_blobs(act, bl, bl1)
        factors = kinetic(p0) - kinetic(p1)
        if self.leapfrog_total is not None:
            self.leapfrog_total.add_(L)

        if self.tune_steps > 0 and ks and self.mesh_tuning(ks):
            ks = self._adapt_traj_length(ks, state, names, masks, coords, x1,
                                         p1, factors, ll1, lp1, betas, u, T,
                                         eps_time, eps)
        return self._accept_and_merge(generator, state, names, coords, x1,
                                      factors, ll1, lp1, betas, ks, bl1)

    def _adapt_traj_length(self, ks, state, names, masks, coords, x1, p1,
                           factors, ll1, lp1, betas, u, T, eps_time, eps):
        """One Adam step on ``log T`` from the cold chain's ChEES gradient
        estimate; the identity once ``t >= tune_steps``."""
        alpha = self._acceptance_probability(state, betas, factors, ll1,
                                             lp1)
        # the cold rung of every walker: alpha, the masks, the start, the
        # end point and its momenta
        k = len(names)
        cold = self._cold_rows(
            alpha, *[masks[n].expand(coords[n].shape) for n in names],
            *[coords[n] for n in names], *[x1[n] for n in names],
            *[p1[n] for n in names])
        alpha = cold[0]
        nwalkers = alpha.shape[0]

        def flat(rows):
            return torch.cat([r.reshape(nwalkers, -1) for r in rows], dim=-1)

        # centring over active slots only; inactive ones contribute zero
        m_flat = flat(cold[1:1 + k]).to(alpha.dtype)
        cnt = torch.clamp(m_flat.sum(dim=0, keepdim=True), min=1.0)

        def centred(x_flat):
            mean = (x_flat * m_flat).sum(dim=0, keepdim=True) / cnt
            return torch.where(m_flat > 0, x_flat - mean, 0.0)

        xc_o = centred(flat(cold[1 + k:1 + 2 * k]))
        xc_n = centred(flat(cold[1 + 2 * k:1 + 3 * k]))
        # the endpoint's velocity per dimension, the trajectory timed in
        # units of eps_time
        eps_flat = flat([eps[n].expand(coords[n].shape[2:]).reshape(1, -1)
                         .expand(nwalkers, -1) for n in names])
        p_new = flat(cold[1 + 3 * k:]) * (eps_flat / eps_time)
        d_old = (xc_o ** 2).sum(dim=-1)
        d_new = (xc_n ** 2).sum(dim=-1)
        g_per = (d_new - d_old) * (xc_n * p_new).sum(dim=-1)
        w_sum = torch.clamp(alpha.sum(), min=1e-12)
        g_logT = torch.nan_to_num((alpha * g_per).sum() / w_sum * u * T)

        tuning = ks["t"] < self.tune_steps
        tf = (ks["t"] + 1).to(alpha.dtype)
        b1, b2 = 0.9, 0.999
        m = b1 * ks["adam_m"] + (1.0 - b1) * g_logT
        v = b2 * ks["adam_v"] + (1.0 - b2) * g_logT ** 2
        m_hat = m / (1.0 - b1 ** tf)
        v_hat = v / (1.0 - b2 ** tf)
        step = self.adam_lr * m_hat / (torch.sqrt(v_hat) + 1e-8)
        log_T_new = torch.clamp(ks["log_T"] + step, torch.log(eps_time),
                                torch.log(self.max_leapfrog * eps_time))
        return {**ks,
                "log_T": torch.where(tuning, log_T_new, ks["log_T"]),
                "adam_m": torch.where(tuning, m, ks["adam_m"]),
                "adam_v": torch.where(tuning, v, ks["adam_v"])}
