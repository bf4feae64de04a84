"""Hamiltonian Monte Carlo move.

Port of :mod:`eryn_tpu.moves.hmc`.  The leapfrog trajectory differentiates
the tempered log posterior through the user's likelihood
(:func:`~eryn_tpu_torch.moves.mala.grad_context`); its ``num_leapfrog``
steps are a loop of that static length inside the step's CUDA graph.
Momenta live on active leaves only, so the move runs under reversible
jump.  The Metropolis correction on the Hamiltonian error maps onto the
sampler's ``factors + logP_new - logP_old`` with ``factors = K(p0) -
K(p1)``, ``K(p) = |p|^2 / 2``.  On a state sharded over a device mesh the
momenta and the trajectory lengths are drawn per walker, and the rest is
:class:`~eryn_tpu_torch.moves.mala.MALAMove`'s.
"""

from __future__ import annotations

import torch

from .mala import MALAMove, unpack_aux
from .move import merge_blobs

__all__ = ["HMCMove"]


class HMCMove(MALAMove):
    """Leapfrog HMC proposal.

    Args:
        eps: leapfrog step size, as :class:`MALAMove`'s.
        num_leapfrog: leapfrog steps per proposal; a tuple ``(lo, hi)``
            draws each walker's length uniformly from ``[lo, hi]`` every
            proposal (the batch runs ``hi`` steps and a walker past its
            length stays where it is).
        target_acceptance / tune_steps: dual averaging, as
            :class:`MALAMove`'s (0.65 is the HMC-optimal acceptance).
        ensemble_precondition: the red/blue preconditioned form of
            :class:`MALAMove`, each half integrating its own trajectory.
    """

    _EPS_DIM_EXP = 0.25
    _EPS_DIM_CONST = 1.2
    _mesh_sharded = True

    def __init__(self, eps=None, num_leapfrog=5, target_acceptance=0.65,
                 tune_steps=500, **kwargs):
        super().__init__(eps=eps, target_acceptance=target_acceptance,
                         tune_steps=tune_steps, **kwargs)
        if isinstance(num_leapfrog, (tuple, list)):
            lo, hi = int(num_leapfrog[0]), int(num_leapfrog[1])
            if not 1 <= lo <= hi:
                raise ValueError(
                    f"num_leapfrog range must satisfy 1 <= lo <= hi, got "
                    f"({lo}, {hi}).")
            self.num_leapfrog = hi
            self.num_leapfrog_min = lo
        else:
            self.num_leapfrog = int(num_leapfrog)
            self.num_leapfrog_min = None

    # -- draws --------------------------------------------------------------
    def draw_momenta(self, generator, coords):
        """Standard normal momenta shaped like each branch of ``coords``
        (masked to the active leaves by the move), per walker."""
        return {n: self.rank_draw(
                    lambda sh, c=c: torch.randn(sh, generator=generator,
                                                dtype=c.dtype,
                                                device=c.device),
                    c.shape, per_walker=True)
                for n, c in coords.items()}

    def draw_lengths(self, generator, shape, device):
        """Each walker's trajectory length in ``[lo, hi]``, ``shape`` int64;
        None for a fixed length."""
        if self.num_leapfrog_min is None:
            return None
        return self.rank_draw(
            lambda sh: torch.randint(self.num_leapfrog_min,
                                     self.num_leapfrog + 1, sh,
                                     generator=generator, device=device),
            shape, per_walker=True)

    def draw_block(self, generator, x):
        """The draws of one trajectory from the walkers ``x``, as
        :class:`MALAMove`'s: the momenta and the lengths (None for a fixed
        length)."""
        first = next(iter(x.values()))
        return (self.draw_momenta(generator, x),
                self.draw_lengths(generator, first.shape[:2], first.device))

    # -- the leapfrog plumbing (ChEESHMCMove's too) ---------------------------
    def _leapfrog_fns(self, names, masks, eps):
        """``(kinetic, half_kick, drift)`` over the step sizes and masks."""

        def kinetic(p):
            total = 0.0
            for n in names:
                total = total + 0.5 * torch.where(masks[n], p[n] ** 2, 0.0).sum(
                    dim=(-2, -1))
            return total

        def half_kick(p, g):
            return {n: p[n] + 0.5 * eps[n] * torch.where(masks[n], g[n], 0.0)
                    for n in names}

        def drift(x, p):
            # the wrap keeps the trajectory on the torus, where the gradient
            # field is periodic: leapfrog stays reversible
            return {n: self._wrap_periodic(
                n, x[n] + eps[n] * torch.where(masks[n], p[n], 0.0))
                for n in names}

        return kinetic, half_kick, drift

    @staticmethod
    def _momenta(momenta, names, masks):
        """:meth:`draw_momenta`'s ``momenta`` on the active leaves."""
        return {n: torch.where(masks[n], momenta[n], 0.0) for n in names}

    def propose_block(self, draws, names, coords, masks, eps, grad_fn):
        """The (optionally length-jittered) trajectory from ``coords`` with
        :meth:`draw_block`'s ``draws``: ``(x1, ll1, lp1, factors,
        blobs1)`` with ``factors = K(p0) - K(p1)``."""
        momenta, lengths = draws
        p0 = self._momenta(momenta, names, masks)
        kinetic, half_kick, drift = self._leapfrog_fns(names, masks, eps)
        aux, g = grad_fn(coords)
        ll, lp, bl = unpack_aux(aux)

        x, p = coords, p0
        for i in range(self.num_leapfrog):
            p_new = half_kick(p, g)
            x_new = drift(x, p_new)
            aux, g_new = grad_fn(x_new)
            ll_new, lp_new, bl_new = unpack_aux(aux)
            p_new = half_kick(p_new, g_new)
            if lengths is None:
                x, p, g, ll, lp, bl = x_new, p_new, g_new, ll_new, lp_new, bl_new
                continue
            act = i < lengths
            a4 = act[:, :, None, None]
            x = {n: torch.where(a4, x_new[n], x[n]) for n in names}
            p = {n: torch.where(a4, p_new[n], p[n]) for n in names}
            g = {n: torch.where(a4, g_new[n], g[n]) for n in names}
            ll = torch.where(act, ll_new, ll)
            lp = torch.where(act, lp_new, lp)
            bl = merge_blobs(act, bl_new, bl)
        return x, ll, lp, kinetic(p0) - kinetic(p), bl
