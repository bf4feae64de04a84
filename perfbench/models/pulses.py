"""The pulses family: Gaussian pulses in white noise under reversible jump,
the user's side as in Eryn's tutorial (a torch likelihood of one walker's
``(nleaves_max, 3)`` leaves and its ``(nleaves_max,)`` active mask).
``control=True`` computes the template and the residual in bfloat16, the
nearest precision below the configuration's float32."""

from __future__ import annotations

from types import SimpleNamespace

import torch


def data_series(cfg, traffic, gen, device):
    """``t`` and the data: the configuration's pulses over ``npts`` samples
    of its span, plus white noise of its ``sigma`` drawn from ``gen``; both
    float32, as the likelihood reads them."""
    npts = int(traffic["npts"])
    t0, t1 = cfg["t_span"]
    t = torch.linspace(t0, t1, npts, dtype=torch.float64, device=device)
    clean = torch.zeros_like(t)
    for a, b, c in cfg["truth"]:
        clean += a * torch.exp(-((t - b) ** 2) / (2 * c**2))
    noise = torch.randn(npts, generator=gen, device=device,
                        dtype=torch.float64)
    data = clean + float(cfg["sigma"]) * noise
    return t.to(torch.float32), data.to(torch.float32)


def problem(cfg, traffic, gens, device, control=False):
    nt, nw = int(cfg["ntemps"]), int(cfg["nwalkers"])
    nl, ndim = int(cfg["nleaves_max"]), int(cfg["ndim"])
    sigma = float(cfg["sigma"])
    t, data = data_series(cfg, traffic, gens["data"], device)
    bounds = torch.tensor(cfg["prior_bounds"], dtype=torch.float64)

    if control:
        tb, db = t.to(torch.bfloat16), data.to(torch.bfloat16)

        def log_like(coords, inds):
            c = coords.to(torch.bfloat16)
            a, b, w = c[:, 0], c[:, 1], c[:, 2]
            p = a[:, None] * torch.exp(-((tb[None] - b[:, None]) ** 2)
                                       / (2 * w[:, None] ** 2))
            tmpl = torch.sum(torch.where(inds[:, None], p, 0.0), dim=0)
            return (-0.5 * torch.sum(((tmpl - db) / sigma) ** 2)).to(
                coords.dtype)
    else:
        def log_like(coords, inds):
            a, b, w = coords[:, 0], coords[:, 1], coords[:, 2]
            p = a[:, None] * torch.exp(-((t[None] - b[:, None]) ** 2)
                                       / (2 * w[:, None] ** 2))
            tmpl = torch.sum(torch.where(inds[:, None], p, 0.0), dim=0)
            return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    lo, hi = bounds[:, 0].to(device), bounds[:, 1].to(device)
    u = torch.rand((nt, nw, nl, ndim), generator=gens["start"],
                   device=device, dtype=torch.float64)
    coords = (lo + (hi - lo) * u).to(torch.float32)
    inds = torch.rand((nt, nw, nl), generator=gens["start"], device=device,
                      dtype=torch.float64) < float(cfg["start_active_share"])
    # the likelihood of no pulse at all, for walkers with no active leaf
    fill = float(-0.5 * torch.sum((data.double() / sigma) ** 2))
    return SimpleNamespace(
        log_like=log_like, bounds=bounds, ndim=ndim, coords=coords,
        inds=inds,
        sampler_kwargs=dict(nleaves_max=nl, nleaves_min=int(cfg["nleaves_min"]),
                            rj_moves=bool(cfg["rj_moves"]),
                            fill_zero_leaves_val=fill),
        inputs={"t": t, "data": data, "sigma": sigma})


def cold_series(sampler):
    """The cold chain's log-likelihood and active-leaf count, each
    ``(nsteps, nwalkers, 1)``."""
    ll = sampler.get_log_like(temp_index=0)
    nleaves = sampler.get_nleaves(temp_index=0)["model_0"]
    return {"log_like": torch.from_numpy(ll)[..., None],
            "nleaves": torch.from_numpy(nleaves.astype("float64"))[..., None]}


def rhat_series(series):
    return series["log_like"]


def likelihood_cost(cfg, traffic, nwalkers_total):
    """Operations and bytes of one whole-ensemble evaluation of the
    template likelihood at ``npts`` samples and ``nleaves_max`` leaves.
    Per leaf and sample: the difference, its square, the division, the
    exponential, the amplitude's product and the sum over leaves (6; the
    sign folds into the division, the mask selects); per sample: the
    residual, its scale, its square and the sum (4); per leaf, ``2 c^2``
    (2).  Bytes: the leaves, the masks, ``t`` and the data read once, the
    values written once, float32."""
    n, nl = int(traffic["npts"]), int(cfg["nleaves_max"])
    d = int(cfg["ndim"])
    ops = nwalkers_total * (nl * n * 6 + n * 4 + nl * 2)
    nbytes = (nwalkers_total * (nl * d * 4 + nl + 4)) + 2 * n * 4
    return ops, nbytes
