"""Differential-evolution ensemble proposals.

Port of :mod:`eryn_tpu.moves.de` (ter Braak 2006; ter Braak & Vrugt 2008),
on the red/blue half-ensemble machinery of
:class:`~eryn_tpu_torch.moves.red_blue.RedBlueMove`, so the moves compose
with parallel tempering, Gibbs splits, periodic parameters and
reversible-jump leaf masks.  Distinct complement picks are shifted
``randint`` draws (no rejection loop), and the active-parameter counts in
``gamma0`` and the snooker Jacobian come from the leaf masks.
"""

from __future__ import annotations

import torch

from .red_blue import RedBlueMove

__all__ = ["DEMove", "DESnookerMove"]


def _distinct2(i, j):
    """Two distinct indices from draws ``i`` in ``[0, n)`` and ``j`` in
    ``[0, n - 1)``."""
    return i, j + (j >= i).to(j.dtype)


def _distinct3(i, j, k):
    """Three distinct indices from draws in ``[0, n)``, ``[0, n - 1)`` and
    ``[0, n - 2)``."""
    i, j = _distinct2(i, j)
    lo = torch.minimum(i, j)
    hi = torch.maximum(i, j)
    k = k + (k >= lo).to(k.dtype)
    k = k + (k >= hi).to(k.dtype)
    return i, j, k


def _pick(c, idx):
    """The complement walkers ``(ntemps, ns, nleaves_max, ndim)`` at the
    per-(temperature, walker) index ``idx``."""
    return torch.gather(
        c, 1, idx[:, :, None, None].expand(-1, -1, *c.shape[2:]))


def _active_ndim(s_coords, s_inds, param_masks, names, like):
    """Per-walker count of proposed parameters: active leaves times
    selected parameters."""
    ndim_active = like.new_zeros(like.shape[:2])
    for name in names:
        s = s_coords[name]
        mask = None if param_masks is None else param_masks.get(name)
        if mask is None:
            ndim_active = ndim_active + s_inds[name].sum(dim=-1) * s.shape[-1]
        else:
            per_leaf = mask.sum(dim=-1).to(like.dtype)
            ndim_active = ndim_active + (s_inds[name] * per_leaf).sum(dim=-1)
    return ndim_active


def _randint(move, generator, high, shape, device):
    """``randint`` draws in ``[0, high)`` (the move's
    :meth:`~eryn_tpu_torch.moves.move.Move.rank_draw`)."""
    return move.rank_draw(
        lambda sh: torch.randint(0, high, sh, generator=generator,
                                 device=device), shape)


class DEMove(RedBlueMove):
    """Differential-evolution proposal ``q = s + gamma (c_a - c_b)``, with
    ``c_a != c_b`` from the complement half and ``gamma = gamma0 (1 + sigma
    N(0, 1))``; ``gamma0`` defaults to ``2.38 / sqrt(2 d)``, ``d`` the
    walker's count of active proposed parameters.  With probability
    ``hop_prob`` a walker proposes with ``gamma = 1`` (a mode hop).
    Symmetric: the factors are zero.
    """

    _mesh_sharded = True

    def __init__(self, sigma=1e-5, gamma0=None, hop_prob=0.1, **kwargs):
        super().__init__(**kwargs)
        self.sigma = float(sigma)
        self.gamma0 = gamma0
        self.hop_prob = float(hop_prob)

    def draw_de(self, generator, names, ntemps, ns, nc, like):
        """Randomness of one block: the jitter's normals and the hop's
        uniforms ``(ntemps, ns)`` (None without hops), and per branch the
        two index draws in ``[0, nc)`` and ``[0, nc - 1)``."""
        kw = dict(generator=generator, dtype=like.dtype, device=like.device)
        gauss = self.rank_draw(lambda sh: torch.randn(sh, **kw), (ntemps, ns))
        hop = (self.rank_draw(lambda sh: torch.rand(sh, **kw), (ntemps, ns))
               if self.hop_prob > 0.0 else None)
        picks = {n: (_randint(self, generator, nc, (ntemps, ns), like.device),
                     _randint(self, generator, nc - 1, (ntemps, ns),
                              like.device))
                 for n in names}
        return gauss, hop, picks

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None):
        names = list(s_coords)
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        nc = c_coords[names[0]].shape[1]
        if nc < 2:
            raise ValueError(
                "DEMove needs at least 2 complement walkers per half "
                f"(got {nc}); increase nwalkers.")
        gauss, hop, picks = self.draw_de(generator, names, ntemps, ns, nc,
                                         first)

        if self.gamma0 is None:
            d = torch.clamp(_active_ndim(s_coords, s_inds, param_masks, names,
                                         first), min=1.0)
            g0 = 2.38 / torch.sqrt(2.0 * d)
        else:
            g0 = first.new_full((ntemps, ns), float(self.gamma0))
        gamma = g0 * (1.0 + self.sigma * gauss)
        if hop is not None:
            gamma = torch.where(hop < self.hop_prob, 1.0, gamma)

        newpos = {}
        for name in names:
            s, c = s_coords[name], c_coords[name]
            ia, ib = _distinct2(*picks[name])
            ca, cb = _pick(c, ia), _pick(c, ib)
            if self.periodic is not None:
                diff = self.periodic.distance({name: cb}, {name: ca})[name]
            else:
                diff = ca - cb
            q = s + gamma[:, :, None, None] * diff
            if self.periodic is not None:
                q = self.periodic.wrap({name: q})[name]
            newpos[name] = q
        return newpos, first.new_zeros((ntemps, ns))


class DESnookerMove(RedBlueMove):
    """Snooker differential evolution (ter Braak & Vrugt 2008): with three
    distinct complement walkers ``z, z1, z2``, step along ``e = (s - z) /
    |s - z|`` by ``gammas ((z1 - z2) . e)``; the factors are the Jacobian
    ``(d - 1) log(|q - z| / |s - z|)`` over the active proposed
    parameters, summed over branches.
    """

    _mesh_sharded = True

    def __init__(self, gammas=1.7, **kwargs):
        super().__init__(**kwargs)
        self.gammas = float(gammas)

    def draw_snooker(self, generator, names, ntemps, ns, nc, device):
        """Per branch the three index draws in ``[0, nc)``, ``[0, nc - 1)``
        and ``[0, nc - 2)``, each ``(ntemps, ns)``."""
        return {n: tuple(_randint(self, generator, nc - k, (ntemps, ns),
                                  device)
                         for k in range(3))
                for n in names}

    def get_proposal_kernel(self, generator, s_coords, c_coords, s_inds,
                            param_masks=None):
        names = list(s_coords)
        first = s_coords[names[0]]
        ntemps, ns = first.shape[:2]
        dtype = first.dtype
        nc = c_coords[names[0]].shape[1]
        if nc < 3:
            raise ValueError(
                "DESnookerMove needs at least 3 complement walkers per half "
                f"(got {nc}); increase nwalkers.")
        tiny = 1e-300 if dtype == torch.float64 else 1e-30
        picks = self.draw_snooker(generator, names, ntemps, ns, nc,
                                  first.device)

        newpos = {}
        factors = first.new_zeros((ntemps, ns))
        for name in names:
            s, c = s_coords[name], c_coords[name]
            iz, i1, i2 = _distinct3(*picks[name])
            z, z1, z2 = _pick(c, iz), _pick(c, i1), _pick(c, i2)

            # only active leaves and selected parameters enter the geometry
            mask = s_inds[name][:, :, :, None].to(dtype)
            pm = None if param_masks is None else param_masks.get(name)
            if pm is not None:
                mask = mask * pm.to(dtype)
            d_active = _active_ndim({name: s}, {name: s_inds[name]},
                                    param_masks, [name], first)

            if self.periodic is not None:
                s_minus_z = -self.periodic.distance({name: s}, {name: z})[name]
                z1_minus_z2 = self.periodic.distance({name: z2},
                                                     {name: z1})[name]
            else:
                s_minus_z = s - z
                z1_minus_z2 = z1 - z2

            delta = s_minus_z * mask
            norm = torch.sqrt(torch.sum(delta ** 2, dim=(2, 3)))
            e = delta / torch.clamp(norm, min=tiny)[:, :, None, None]
            proj = torch.sum(z1_minus_z2 * mask * e, dim=(2, 3))
            step = self.gammas * proj[:, :, None, None] * e
            q = torch.where(mask > 0, s + step, s)
            if self.periodic is not None:
                q = self.periodic.wrap({name: q})[name]
            newpos[name] = q

            if self.periodic is not None:
                q_minus_z = -self.periodic.distance({name: q}, {name: z})[name]
            else:
                q_minus_z = q - z
            norm_new = torch.sqrt(torch.sum((q_minus_z * mask) ** 2,
                                            dim=(2, 3)))
            ok = (norm > 0) & (norm_new > 0)
            factors = factors + torch.where(
                ok,
                (torch.clamp(d_active, min=1.0) - 1.0)
                * (torch.log(torch.clamp(norm_new, min=tiny))
                   - torch.log(torch.clamp(norm, min=tiny))),
                0.0)
        return newpos, factors
