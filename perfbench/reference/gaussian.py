"""Plain reference of the unit Gaussian: its log-likelihood, and the
moments of its tempered posteriors under the uniform priors."""

import math

import torch


def log_like(coords, inds, inputs):
    """``coords`` ``(..., nleaves, ndim)`` float64 (one leaf); returns
    ``(...)``: ``-x.x / 2``."""
    x = coords[..., 0, :].to(torch.float64)
    return -0.5 * (x * x).sum(dim=-1)


def moment_deviations(chain, betas, cfg, inputs, bounds, seed, device):
    """Per stored step, the walkers' mean of each coordinate and of its
    square at every rung, less the target's: at inverse temperature
    ``beta`` the unit Gaussian under the uniform priors on ``[-a, a]`` is
    ``N(0, 1 / beta)`` truncated there, coordinate by coordinate.
    ``chain(r)``: rung ``r``'s stored ``(coords (T, nwalkers, 1, ndim),
    inds)``; ``betas`` ``(T, ntemps)``, the stored ladder.  Returns ``(dev
    (T, 2 ntemps ndim), None)``: the reference integrates exactly."""
    b = bounds.to(torch.float64)
    if not torch.equal(b[:, 0], -b[:, 1]):
        raise ValueError("the reference knows priors symmetric about 0 only")
    betas = betas.to(device=device, dtype=torch.float64)
    half = b[:, 1].to(device)
    cols = []
    for r in range(betas.shape[1]):
        x = chain(r)[0].to(device=device, dtype=torch.float64)[:, :, 0, :]
        var = truncated_normal_var(
            betas[:, r:r + 1].rsqrt(), half[None, :])
        cols += [x.mean(dim=1), (x * x).mean(dim=1) - var]
        del x
    return torch.cat(cols, dim=1), None


def truncated_normal_var(sd, a):
    """The variance of ``N(0, sd^2)`` truncated to ``[-a, a]`` (float64,
    broadcast): ``sd^2 (1 - 2 al phi(al) / (2 Phi(al) - 1))``, ``al = a /
    sd``."""
    sd = torch.as_tensor(sd, dtype=torch.float64)
    al = torch.as_tensor(a, dtype=torch.float64, device=sd.device) / sd
    phi = torch.exp(-0.5 * al * al) / math.sqrt(2.0 * math.pi)
    mass = 2.0 * torch.special.ndtr(al) - 1.0
    return sd * sd * (1.0 - 2.0 * al * phi / mass)
