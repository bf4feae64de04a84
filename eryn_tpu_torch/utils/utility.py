"""Chain diagnostics: the integrated autocorrelation time.

Port of the IACT part of :mod:`eryn_tpu.utils.utility`: the host estimator
:func:`get_integrated_act` (NumPy, float64) and its device counterpart
:func:`get_integrated_act_torch` (``torch.fft``), which lets a
device-resident chain stay on the device while only the taus cross to the
host.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

__all__ = ["get_acf", "get_integrated_act", "get_integrated_act_torch"]


def get_acf(x, axis=0):
    """FFT autocorrelation function along ``axis`` (real-input transform)."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = x.shape[axis]
    f = np.fft.rfft(x - np.mean(x, axis=axis, keepdims=True), n=2 * n, axis=axis)
    acf = np.fft.irfft(f * np.conjugate(f), n=2 * n, axis=axis)
    acf = np.take(acf, np.arange(n), axis=axis)
    return acf / np.take(acf, [0], axis=axis)


def _fill_nonfinite_columns(x):
    """Replace each column's non-finite entries (dead RJ leaves) with the
    column mean; all-NaN columns become zeros, hence tau = NaN."""
    bad = ~np.isfinite(x)
    if not bad.any():
        return x
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        col_mean = np.nanmean(np.where(bad, np.nan, x), axis=0, keepdims=True)
    x = np.where(bad, np.broadcast_to(col_mean, x.shape), x)
    return np.nan_to_num(x)


def _check_tol(tau, nsteps, tol, quiet):
    """emcee ``integrated_time`` chain-length guard."""
    if tol <= 0:
        return
    tau_max = np.nanmax(np.atleast_1d(tau))
    if np.isfinite(tau_max) and tau_max * tol > nsteps:
        msg = (
            f"The chain is shorter than {tol} times the integrated "
            f"autocorrelation time ({tau_max:.1f})."
        )
        if not quiet:
            raise RuntimeError(msg)
        warnings.warn(msg, stacklevel=3)


def get_integrated_act(x, window=50, average=True, tol=0, quiet=True):
    """Integrated autocorrelation time per parameter (fixed-window
    estimator, as Eryn's).

    Args:
        x: a dict of per-branch chains shaped
           ``(nsteps, ntemps, nwalkers, nleaves_max, ndim)``, or an array
           with the step axis first.
        window: summation window of the ACF.
        average: average the per-walker estimates over axis 1.
        tol: if > 0, require ``nsteps > tol * tau``; raises when ``quiet`` is
           False, warns otherwise.

    Returns:
        dict input: ``{name: tau}`` with tau ``(ntemps, nleaves_max, ndim)``
        (``average=True``) or ``(ntemps, nwalkers, nleaves_max, ndim)``;
        array input: the step axis summed out, axis 1 averaged.
    """
    is_dict = isinstance(x, dict)
    if is_dict:
        shapes, parts, breaks, total = {}, [], [], 0
        for name, values in x.items():
            values = np.asarray(values, dtype=np.float64)
            nsteps, ntemps, nwalkers, nleaves_max, ndim = values.shape
            shapes[name] = (ntemps, nwalkers, nleaves_max, ndim)
            total += nleaves_max * ndim
            breaks.append(total)
            parts.append(values.reshape(nsteps, ntemps, nwalkers, -1))
        x_in = np.concatenate(parts, axis=-1)
    else:
        x_in = np.asarray(x, dtype=np.float64)

    nsteps = x_in.shape[0]
    x_in = _fill_nonfinite_columns(x_in.reshape(nsteps, -1)).reshape(x_in.shape)
    with np.errstate(invalid="ignore", divide="ignore"):
        f = get_acf(x_in, axis=0)
    tau = 1.0 + 2.0 * np.sum(f[1:window], axis=0)
    if average and tau.ndim >= 2:
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            tau = np.nanmean(tau, axis=1)
    _check_tol(tau, nsteps, tol, quiet)

    if not is_dict:
        return tau
    out = {}
    for (name, shape), split in zip(
        shapes.items(), np.split(tau, breaks[:-1], axis=-1)
    ):
        ntemps, nwalkers, nleaves_max, ndim = shape
        lead = (ntemps,) if average else (ntemps, nwalkers)
        out[name] = split.reshape(lead + (nleaves_max, ndim))
    return out


def get_integrated_act_torch(x, window=50, average=True):
    """Device-side integrated autocorrelation time: the estimator of
    :func:`get_integrated_act` on a tensor with the step axis first (e.g.
    ``(nsteps, ntemps, nwalkers, nleaves_max, ndim)``), computed where the
    tensor lies.  Non-finite entries are replaced per column by the column
    mean; all-NaN columns give NaN.  Returns a tensor of taus with the step
    axis removed (and axis 1 averaged when ``average``)."""
    nsteps = x.shape[0]
    flat = x.reshape(nsteps, -1)
    finite = torch.isfinite(flat)
    count = finite.sum(dim=0)
    col_sum = torch.where(finite, flat, 0.0).sum(dim=0)
    col_mean = col_sum / count.clamp(min=1)
    all_nan = count == 0
    filled = torch.where(finite, flat, col_mean[None, :])
    filled = torch.where(all_nan[None, :], 0.0, filled)

    f = torch.fft.rfft(filled - filled.mean(dim=0, keepdim=True), n=2 * nsteps,
                       dim=0)
    acf = torch.fft.irfft(f * torch.conj(f), n=2 * nsteps, dim=0)[:nsteps]
    acf = acf / acf[0:1]
    tau = 1.0 + 2.0 * torch.sum(acf[1:window], dim=0)
    tau = torch.where(all_nan, torch.nan, tau).reshape(x.shape[1:])
    if average and tau.ndim >= 2:
        tau = torch.nanmean(tau, dim=1)
    return tau
