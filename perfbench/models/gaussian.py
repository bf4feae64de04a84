"""The Gaussian family: the user's side of a sampler of a Gaussian target
under uniform priors, as an Eryn user writes it (a torch likelihood of one
walker's ``(ndim,)`` coordinates).  ``control=True`` computes the same
likelihood in bfloat16, the nearest precision below the configuration's
float32 (no matrix product runs, so TF32 does not apply)."""

from __future__ import annotations

from types import SimpleNamespace

import torch


def problem(cfg, traffic, gens, device, control=False):
    """The likelihood, priors, start state and the inputs handed to the
    reference.  ``gens``: ``{"data", "start"}`` torch generators on
    ``device``."""
    if cfg.get("cov") != "identity" or float(cfg.get("mean", 0.0)) != 0.0:
        raise ValueError("the gaussian family runs the unit Gaussian only")
    ndim, nt, nw = int(cfg["ndim"]), int(cfg["ntemps"]), int(cfg["nwalkers"])
    bounds = torch.tensor(cfg["prior_bounds"], dtype=torch.float64)

    if control:
        def log_like(x):
            xb = x.to(torch.bfloat16)
            return (-0.5 * torch.sum(xb * xb)).to(x.dtype)
    else:
        def log_like(x):
            return -0.5 * torch.sum(x * x)

    lo, hi = bounds[:, 0].to(device), bounds[:, 1].to(device)
    u = torch.rand((nt, nw, 1, ndim), generator=gens["start"], device=device,
                   dtype=torch.float64)
    coords = (lo + (hi - lo) * u).to(torch.float32)
    return SimpleNamespace(
        log_like=log_like, bounds=bounds, ndim=ndim, coords=coords, inds=None,
        sampler_kwargs={}, inputs={})


def cold_series(sampler):
    """The cold chain's series whose autocorrelation and mixing the
    benchmark reads: every coordinate, ``(nsteps, nwalkers, ndim)``."""
    chain = sampler.get_chain(temp_index=0)["model_0"]
    return {"coords": torch.from_numpy(chain[:, :, 0, :])}


def rhat_series(series):
    return series["coords"]

