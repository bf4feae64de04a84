"""Plain reference of the pulses under reversible jump: the log-likelihood,
and the moments of the cold chain's one-pulse posterior."""

import math

import torch


def log_like(coords, inds, inputs, block=256):
    """``coords`` ``(..., nleaves, 3)``, ``inds`` ``(..., nleaves)``; the
    sum of the active pulses against the data, in blocks of ``block``
    walkers so that the ``(walkers, nleaves, npts)`` template fits.  A
    walker with no active pulse gets the likelihood of the data alone."""
    t = inputs["t"].to(torch.float64)
    data = inputs["data"].to(torch.float64)
    sigma = float(inputs["sigma"])
    lead = coords.shape[:-2]
    c = coords.reshape(-1, *coords.shape[-2:]).to(torch.float64)
    m = inds.reshape(-1, inds.shape[-1])
    out = torch.empty(c.shape[0], dtype=torch.float64, device=c.device)
    for i in range(0, c.shape[0], block):
        cb, mb = c[i:i + block], m[i:i + block]
        a, b, w = cb[..., 0:1], cb[..., 1:2], cb[..., 2:3]
        p = a * torch.exp(-((t - b) ** 2) / (2 * w**2))
        tmpl = torch.where(mb[..., None], p, 0.0).sum(dim=1)
        out[i:i + block] = -0.5 * (((tmpl - data) / sigma) ** 2).sum(dim=-1)
    return out.reshape(lead)


def _pulse(theta, t):
    """``theta`` ``(..., 3)`` one pulse each; the template and its
    derivatives by amplitude, centre and width, ``(..., npts)`` each."""
    a, b, w = theta[..., 0:1], theta[..., 1:2], theta[..., 2:3]
    e = torch.exp(-((t - b) ** 2) / (2 * w**2))
    p = a * e
    return p, (e, p * (t - b) / w**2, p * (t - b) ** 2 / w**3)


def one_pulse_posterior(cfg, inputs, bounds, seed, device, draws=1 << 16,
                        block=2048, scale=1.25):
    """Mean and variance of each parameter under the one-pulse posterior at
    inverse temperature 1 (the likelihood times the uniform priors), with
    the variances of those estimates, all ``(3,)`` float64: by importance
    sampling ``draws`` points from ``scale`` times the Laplace Gaussian
    about the maximum (Gauss-Newton in float64 from the configuration's
    pulse), the weights self-normalised."""
    if len(cfg["truth"]) != 1:
        raise ValueError("the reference knows the posterior of one pulse")
    t = inputs["t"].to(device=device, dtype=torch.float64)
    data = inputs["data"].to(device=device, dtype=torch.float64)
    sigma = float(inputs["sigma"])
    b = bounds.to(device=device, dtype=torch.float64)
    theta = torch.tensor(cfg["truth"][0], dtype=torch.float64, device=device)
    for _ in range(50):
        p, grads = _pulse(theta, t)
        jac = torch.stack(grads, dim=-1)  # (npts, 3)
        step = torch.linalg.solve(jac.T @ jac, jac.T @ (data - p))
        theta = theta + step
        if float(step.abs().max()) < 1e-13:
            break
    jac = torch.stack(_pulse(theta, t)[1], dim=-1)
    chol = torch.linalg.cholesky(sigma**2 * torch.linalg.inv(jac.T @ jac))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn((draws, 3), generator=gen, dtype=torch.float64,
                    device=device)
    x = theta + scale * z @ chol.T
    logw = torch.empty(draws, dtype=torch.float64, device=device)
    for i in range(0, draws, block):
        p, _ = _pulse(x[i:i + block], t)
        logw[i:i + block] = -0.5 * (((p - data) / sigma) ** 2).sum(dim=-1)
    inside = ((x >= b[:, 0]) & (x <= b[:, 1])).all(dim=-1)
    logw = torch.where(inside, logw + 0.5 * (z * z).sum(dim=-1), -math.inf)
    w = torch.softmax(logw, dim=0)[:, None]
    mean = (w * x).sum(dim=0)
    d2 = (x - mean) ** 2
    var = (w * d2).sum(dim=0)
    return (mean, var, (w**2 * d2).sum(dim=0),
            (w**2 * (d2 - var) ** 2).sum(dim=0))


def moment_deviations(chain, betas, cfg, inputs, bounds, seed, device):
    """Per stored step, over the cold chain's walkers that hold one pulse,
    the mean of each parameter and of its square about the reference's
    mean, less the reference's one-pulse posterior (the cold rung's
    inverse temperature is 1 whatever the ladder does; the hotter rungs'
    targets have no closed form).  ``chain(r)``: rung ``r``'s stored
    ``(coords (T, nwalkers, nleaves, 3), inds (T, nwalkers, nleaves))``.
    Returns ``(dev (T, 6), the reference's variances (6,))``; a step with
    no one-pulse walker is a row of NaN."""
    mean, var, mean_v, var_v = one_pulse_posterior(cfg, inputs, bounds, seed,
                                                   device)
    coords, inds = chain(0)
    inds = inds.to(device)
    # the active pulse of each walker (an inactive leaf may hold NaN)
    x = torch.where(inds[..., None],
                    coords.to(device=device, dtype=torch.float64),
                    0.0).sum(dim=2)
    one = (inds.sum(dim=-1) == 1).to(torch.float64)
    w = one / one.sum(dim=1, keepdim=True)  # NaN where none holds one
    m1 = (w[..., None] * x).sum(dim=1) - mean
    m2 = (w[..., None] * (x - mean) ** 2).sum(dim=1) - var
    return torch.cat([m1, m2], dim=1), torch.cat([mean_v, var_v])
