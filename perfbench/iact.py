"""Integrated autocorrelation time, frozen here so that the yardstick of
``cold_ess_per_s`` cannot move with the program.

A copy of the arithmetic of ``eryn_tpu_torch.utils.utility.
get_integrated_act_torch`` (Eryn's fixed-window estimator: ``tau = 1 + 2
sum_{k=1}^{window-1} rho_k`` from the FFT autocorrelation of each walker's
series, then the mean over walkers), with the walker axis explicit.
"""

from __future__ import annotations

import torch


def integrated_time(x, window=50):
    """``x`` ``(nsteps, nwalkers, k)``: the taus ``(k,)``, each the mean
    over walkers of the walker's tau (NaN where a walker's series is
    constant: it has no autocorrelation to read; NaN where every walker's
    is).  Non-finite entries are replaced by their column's mean."""
    nsteps, nwalkers, k = x.shape
    flat = x.to(torch.float64).reshape(nsteps, -1)
    finite = torch.isfinite(flat)
    count = finite.sum(dim=0)
    col_mean = torch.where(finite, flat, 0.0).sum(dim=0) / count.clamp(min=1)
    filled = torch.where(finite, flat, col_mean[None, :])
    filled = torch.where((count == 0)[None, :], 0.0, filled)
    f = torch.fft.rfft(filled - filled.mean(dim=0, keepdim=True),
                       n=2 * nsteps, dim=0)
    acf = torch.fft.irfft(f * torch.conj(f), n=2 * nsteps, dim=0)[:nsteps]
    acf = acf / acf[0:1]
    tau = 1.0 + 2.0 * torch.sum(acf[1:window], dim=0)
    tau = torch.where(count == 0, torch.nan, tau).reshape(nwalkers, k)
    return torch.nanmean(tau, dim=0)


def tau_max(series, window=50):
    """The largest tau over every column of every series in ``series``
    (``{name: (nsteps, nwalkers, k)}``), ignoring the NaN of constant
    columns; NaN when there is none."""
    taus = torch.cat([integrated_time(x, window) for x in series.values()])
    taus = taus[~taus.isnan()]
    return float(taus.max()) if taus.numel() else float("nan")
