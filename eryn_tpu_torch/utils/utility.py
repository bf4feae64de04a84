"""Chain diagnostics and ensemble utilities.

Port of :mod:`eryn_tpu.utils.utility`.  The host estimators run in NumPy
and SciPy in float64 and are the yardstick: the integrated autocorrelation
time, thermodynamic-integration and stepping-stone evidence, the
Gelman-Rubin R-hat (``psrf``), the rank-normalised split R-hat and the
bulk and tail effective sample size (Vehtari et al. 2021), and replica
round trips.  The device estimators (:func:`get_integrated_act_torch`,
:func:`rank_normalized_rhat_torch`, :func:`effective_sample_size_torch`)
compute the same on a tensor where it lies, so that a device-resident
chain stays there and only the per-parameter results cross to the host.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy.special import logsumexp  # noqa: F401  (eryn_tpu re-exports it)

__all__ = [
    "logsumexp",
    "groups_from_inds",
    "groups_from_inds_torch",
    "get_acf",
    "get_integrated_act",
    "get_integrated_act_torch",
    "thermodynamic_integration_log_evidence",
    "stepping_stone_log_evidence",
    "psrf",
    "rank_normalized_rhat",
    "effective_sample_size",
    "replica_round_trips",
    "rank_normalized_rhat_torch",
    "effective_sample_size_torch",
]


def _host(x, dtype=None):
    """``x`` as a NumPy array (a tensor from wherever it lies)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def groups_from_inds(inds: dict) -> dict:
    """For every active leaf, the flat ``temp * nwalkers + walker`` index
    of the walker it belongs to: ``{name: bool (ntemps, nwalkers,
    nleaves_max)}`` in, ``{name: int (num_active_leaves,)}`` out."""
    groups = {}
    for name, m in inds.items():
        m = _host(m, bool)
        ntemps, nwalkers, _ = m.shape
        walker_ids = np.arange(ntemps * nwalkers).reshape(ntemps, nwalkers)
        groups[name] = np.broadcast_to(walker_ids[:, :, None], m.shape)[m]
    return groups


def groups_from_inds_torch(inds_flat):
    """The static-shape form of :func:`groups_from_inds` for a flattened
    mask ``(N, nleaves_max)``: the walker index of every leaf slot, dense
    ``(N, nleaves_max)`` on the mask's device; pair it with the mask."""
    n, nleaves_max = inds_flat.shape
    return torch.arange(n, device=inds_flat.device)[:, None].expand(
        n, nleaves_max)


def get_acf(x, axis=0, fast=False):
    """FFT autocorrelation function along ``axis`` (real-input transform);
    ``fast`` first cuts the series to its largest power-of-two length."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = x.shape[axis]
    if fast:
        n = int(2 ** np.floor(np.log2(n)))
        x = np.take(x, np.arange(n), axis=axis)
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


def get_integrated_act(x, axis=0, window=50, fast=False, average=True,
                       tol=0, quiet=True):
    """Integrated autocorrelation time per parameter (fixed-window
    estimator, as Eryn's).

    Args:
        x: a dict of per-branch chains shaped
           ``(nsteps, ntemps, nwalkers, nleaves_max, ndim)``, or an array
           with the step axis first.
        axis: the step axis; only 0 is supported (as in ``eryn_tpu``).
        window: summation window of the ACF.
        fast: estimate on the largest power-of-two number of steps
           (:func:`get_acf`).
        average: average the per-walker estimates over axis 1.
        tol: if > 0, require ``nsteps > tol * tau``; raises when ``quiet`` is
           False, warns otherwise.

    Returns:
        dict input: ``{name: tau}`` with tau ``(ntemps, nleaves_max, ndim)``
        (``average=True``) or ``(ntemps, nwalkers, nleaves_max, ndim)``;
        array input: the step axis summed out, axis 1 averaged.
    """
    if axis != 0:
        raise NotImplementedError("get_integrated_act requires axis=0.")
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
        f = get_acf(x_in, axis=0, fast=fast)
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


# ----------------------------------------------------------------------
# evidence
# ----------------------------------------------------------------------
def thermodynamic_integration_log_evidence(betas, logls):
    """Thermodynamic-integration log evidence from the mean log-likelihood
    per rung, with the difference from the integral over every other rung
    as its error.  A ladder without a beta = 0 rung is closed with the
    hottest rung's value.  Returns ``(logZ, error)``."""
    betas = _host(betas, np.float64)
    logls = _host(logls, np.float64)
    if len(betas) != len(logls):
        raise ValueError("betas and logls must have the same length.")
    order = np.argsort(betas)[::-1]
    betas, logls = betas[order], logls[order]
    betas0 = np.copy(betas)
    if betas[-1] != 0.0:
        betas = np.concatenate((betas0, [0.0]))
        betas2 = np.concatenate((betas0[::2], [0.0]))
        logls2 = np.concatenate((logls[::2], [logls[-1]]))
        logls = np.concatenate((logls, [logls[-1]]))
    else:
        betas2 = np.concatenate((betas0[:-1:2], [0.0]))
        logls2 = np.concatenate((logls[:-1:2], [logls[-1]]))
    logZ = -np.trapezoid(logls, betas)
    logZ2 = -np.trapezoid(logls2, betas2)
    return logZ, np.abs(logZ - logZ2)


def stepping_stone_log_evidence(betas, logls, block_len=50, repeats=100,
                                seed=None):
    """Stepping-stone log evidence from ``logls`` ``(nsteps, ntemps,
    nwalkers)`` with a block-bootstrap error: ``repeats`` resamplings of
    time blocks of ``block_len`` steps drawn from
    ``numpy.random.default_rng(seed)``, as :mod:`eryn_tpu` draws them (one
    seed, one error in both packages).  Returns ``(logZ, error)``."""
    betas = _host(betas, np.float64)
    logls = _host(logls, np.float64)
    order = np.argsort(betas)
    betas_sorted = betas[order]
    logls_sorted = logls[:, order, :]
    dbetas = np.diff(betas_sorted)

    def estimate(ll):  # (nsamples, ntemps)
        out = 0.0
        for i, db in enumerate(dbetas):
            x = db * ll[:, i]
            m = np.max(x)
            out += m + np.log(np.mean(np.exp(x - m)))
        return out

    def pooled(ll):  # (nsteps, ntemps, nwalkers) -> (samples, ntemps)
        return np.moveaxis(ll.reshape(ll.shape[0], ll.shape[1], -1), 1,
                           2).reshape(-1, len(betas_sorted))

    logZ = estimate(pooled(logls_sorted))
    rng = np.random.default_rng(seed)
    nsteps = logls_sorted.shape[0]
    block_len = min(block_len, max(nsteps // 2, 1))
    nblocks = max(nsteps // block_len, 1)
    estimates = np.zeros(repeats)
    for r in range(repeats):
        starts = rng.integers(0, nsteps - block_len + 1, size=nblocks)
        sel = np.concatenate([np.arange(s, s + block_len) for s in starts])
        estimates[r] = estimate(pooled(logls_sorted[sel]))
    return logZ, np.std(estimates)


# ----------------------------------------------------------------------
# convergence and mixing, on the host
# ----------------------------------------------------------------------
def psrf(chains, ndim=None, per_walker=True):
    """Gelman-Rubin potential scale reduction factor per parameter of
    ``chains`` ``(nsteps, nwalkers, ndim)`` (NaNs ignored).  Every walker
    is a chain (``per_walker``, :mod:`eryn_tpu`'s default), or, with
    ``per_walker=False`` (Eryn's), the first and last thirds of the pooled
    trace are."""
    chains = _host(chains, np.float64)
    nsteps, nwalkers, nd = chains.shape
    if ndim is not None and int(ndim) != nd:
        raise ValueError(
            f"ndim={ndim} does not match the chains' parameter count {nd}."
        )
    if not per_walker:
        flat = chains.reshape(-1, nd)
        n = flat.shape[0] // 3
        chains = np.stack([flat[:n], flat[-n:]], axis=1)
        nsteps = n
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        means = np.nanmean(chains, axis=0)
        variances = np.nanvar(chains, axis=0, ddof=1)
        W = np.nanmean(variances, axis=0)
        B = nsteps * np.nanvar(means, axis=0, ddof=1)
        var_est = (1.0 - 1.0 / nsteps) * W + B / nsteps
        return np.sqrt(var_est / W)


def _split_chains(chains):
    """Each chain of ``(nsteps, nchains, ndim)`` split in half along the
    steps (a leading odd step dropped): twice the chains."""
    nsteps = chains.shape[0]
    half = nsteps // 2
    if half < 2:
        raise ValueError(
            f"rank-normalized R-hat needs >= 4 steps, got {nsteps}."
        )
    trimmed = chains[nsteps - 2 * half:]
    return np.concatenate([trimmed[:half], trimmed[half:]], axis=1)


def _rank_normalize(x):
    """Normal scores of the pooled draws' average ranks, ``(r - 3/8) / (S +
    1/4)`` (Vehtari et al. 2021, eq. 14); NaNs stay NaN."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    flat = x.reshape(-1)
    finite = np.isfinite(flat)
    out = np.full(flat.shape, np.nan)
    s = int(finite.sum())
    if s:
        r = rankdata(flat[finite], method="average")
        out[finite] = ndtri((r - 0.375) / (s + 0.25))
    return out.reshape(x.shape)


def _basic_rhat(z):
    """Split R-hat of transformed draws ``z`` ``(nsteps, nchains)``."""
    n = z.shape[0]
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        means = np.nanmean(z, axis=0)
        variances = np.nanvar(z, axis=0, ddof=1)
        W = np.nanmean(variances)
        B = n * np.nanvar(means, ddof=1)
        return float(np.sqrt(((n - 1.0) / n * W + B / n) / W))


def _modern_input(chains, ndim):
    chains = _host(chains, np.float64)
    if chains.ndim == 2:
        chains = chains[..., None]
    if ndim is not None and int(ndim) != chains.shape[-1]:
        raise ValueError(
            f"ndim={ndim} does not match the chains' parameter count "
            f"{chains.shape[-1]}."
        )
    return _split_chains(chains)


def rank_normalized_rhat(chains, ndim=None, return_parts=False):
    """Rank-normalised split R-hat per parameter of ``chains`` ``(nsteps,
    nwalkers, ndim)``, every walker a chain, NaNs ignored: the larger of
    the bulk R-hat (ranks of the draws) and the tail R-hat (ranks of the
    distances from the median).  Converged below about 1.01.  With
    ``return_parts``, ``(rhat, bulk, tail)``."""
    split = _modern_input(chains, ndim)
    nd = split.shape[-1]
    bulk, tail = np.empty(nd), np.empty(nd)
    for d in range(nd):
        x = split[..., d]
        bulk[d] = _basic_rhat(_rank_normalize(x))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            folded = np.abs(x - np.nanmedian(x))
        tail[d] = _basic_rhat(_rank_normalize(folded))
    rhat = np.maximum(bulk, tail)
    return (rhat, bulk, tail) if return_parts else rhat


def _ess_of(z):
    """Multi-chain effective sample size of transformed draws ``z``
    ``(nsteps, nchains)`` (the Stan estimator, Vehtari et al. 2021 §3.2):
    combined autocorrelations, Geyer's initial positive pair sums with the
    monotone adjustment.  Non-finite entries take their chain's mean;
    all-NaN chains are dropped."""
    z = np.asarray(z, dtype=np.float64)
    n, _ = z.shape
    finite = np.isfinite(z)
    keep = finite.any(axis=0)
    z, finite = z[:, keep], finite[:, keep]
    m = z.shape[1]
    if n < 4 or m < 2:
        return np.nan
    means = np.where(finite, z, 0.0).sum(axis=0) / finite.sum(axis=0)
    z = np.where(finite, z, means[None, :])
    W = z.var(axis=0, ddof=1).mean()
    var_plus = W * (n - 1.0) / n + means.var(ddof=1)
    if not np.isfinite(var_plus) or var_plus <= 0.0 or W <= 0.0:
        return np.nan
    f = np.fft.rfft(z - z.mean(axis=0, keepdims=True), n=2 * n, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=2 * n, axis=0)[:n] / n
    rho = 1.0 - (W - acov.mean(axis=1)) / var_plus
    L = (n - 1) // 2
    pairs = rho[0:2 * L:2] + rho[1:2 * L:2]
    nonpos = np.nonzero(pairs <= 0.0)[0]
    trunc = nonpos[0] if nonpos.size else L
    if trunc == 0:
        tau = 1.0
    else:
        tau = -1.0 + 2.0 * np.minimum.accumulate(pairs[:trunc]).sum()
    tau = max(tau, 1.0 / np.log10(max(n * m, 10)))
    return n * m / tau


def effective_sample_size(chains, ndim=None, return_parts=False):
    """Effective sample size per parameter of ``chains`` ``(nsteps,
    nwalkers, ndim)``, every walker a chain, NaNs ignored: the smaller of
    the bulk ESS (of the rank-normalised split draws) and the tail ESS
    (the smaller of the 5 % and 95 % quantile indicators').  With
    ``return_parts``, ``(ess, bulk, tail)``."""
    split = _modern_input(chains, ndim)
    nd = split.shape[-1]
    bulk, tail = np.empty(nd), np.empty(nd)
    for d in range(nd):
        x = split[..., d]
        if not np.isfinite(x).any():
            bulk[d] = tail[d] = np.nan
            continue
        bulk[d] = _ess_of(_rank_normalize(x))
        with np.errstate(invalid="ignore"):
            qs = np.nanquantile(x, [0.05, 0.95])
        tails = [_ess_of(np.where(np.isfinite(x), (x <= q).astype(np.float64),
                                  np.nan)) for q in qs]
        tail[d] = np.nan if np.all(np.isnan(tails)) else np.nanmin(tails)
    ess = np.fmin(bulk, tail)
    return (ess, bulk, tail) if return_parts else ess


def replica_round_trips(rungs, ntemps, return_counts=False):
    """Round trips of tempering replicas, cold rung to hottest and back:
    ``rungs`` ``(nsteps, nreplicas)`` is the rung of each replica at each
    step (0 the cold one).  Counting starts at a replica's first visit to
    the cold rung.  Returns the total, with ``return_counts`` also the
    count per replica."""
    rungs = _host(rungs)
    if rungs.ndim != 2:
        raise ValueError(
            f"rungs must be (nsteps, nreplicas), got shape {rungs.shape}."
        )
    counts = np.zeros(rungs.shape[1], dtype=np.int64)
    # only visits to the two end rungs matter: -1 cold, +1 hottest
    ev = np.where(rungs == 0, -1, np.where(rungs == ntemps - 1, 1, 0))
    for k in range(rungs.shape[1]):
        e = ev[:, k]
        e = e[e != 0]
        if e.size == 0:
            continue
        e = e[np.concatenate(([True], e[1:] != e[:-1]))]
        if not (e == -1).any():
            continue
        e = e[np.argmax(e == -1):]
        counts[k] = (e[1:] == -1).sum() if e.size > 1 else 0
    total = int(counts.sum())
    return (total, counts) if return_counts else total


# ----------------------------------------------------------------------
# convergence and mixing, on the device
# ----------------------------------------------------------------------
# The estimators above with static shapes, batched over parameters (a
# leading axis of C columns): ties ranked by two searchsorted passes over
# the sorted pooled draws, Geyer's truncation a cumulative positivity mask,
# all-NaN chains weighted zero.

def _nanvar(x, dim, ddof=1):
    """NumPy's ``nanvar``: NaN where fewer than ``ddof + 1`` values."""
    ok = ~torch.isnan(x)
    dof = ok.sum(dim=dim) - ddof
    mean = torch.nanmean(x, dim=dim, keepdim=True)
    ss = torch.where(ok, (x - mean) ** 2, 0.0).sum(dim=dim)
    return torch.where(dof > 0, ss / dof.clamp(min=1).to(x.dtype), torch.nan)


def _nanquantile(flat, qs):
    """NumPy's ``nanquantile`` (linear) of each row of ``flat`` ``(C, N)``
    at the quantiles ``qs``: ``(len(qs), C)``; NaN for an all-NaN row."""
    srt = torch.sort(flat, dim=1).values  # NaN last
    k = (~torch.isnan(flat)).sum(dim=1)
    out = []
    for q in qs:
        idx = q * (k - 1).clamp(min=0).to(flat.dtype)
        lo = torch.floor(idx)
        t = idx - lo
        lo = lo.long()
        hi = torch.minimum(lo + 1, (k - 1).clamp(min=0))
        a = srt.gather(1, lo[:, None])[:, 0]
        b = srt.gather(1, hi[:, None])[:, 0]
        diff = b - a
        v = torch.where(t >= 0.5, b - diff * (1.0 - t), a + diff * t)
        out.append(torch.where(k > 0, v, torch.nan))
    return torch.stack(out)


def _rank_z(x):
    """:func:`_rank_normalize` of each column of ``x`` ``(C, n, m)``."""
    flat = x.reshape(x.shape[0], -1)
    finite = torch.isfinite(flat)
    big = torch.where(finite, flat, torch.inf).contiguous()
    srt = torch.sort(big, dim=1).values
    left = torch.searchsorted(srt, big, right=False)
    right = torch.searchsorted(srt, big, right=True)
    r = 0.5 * (left + right + 1).to(x.dtype)
    s = finite.sum(dim=1, keepdim=True).to(x.dtype)
    z = torch.special.ndtri((r - 0.375) / (s + 0.25))
    return torch.where(finite, z, torch.nan).reshape(x.shape)


def _basic_rhat_t(z):
    """:func:`_basic_rhat` of each column of ``z`` ``(C, n, m)``."""
    n = z.shape[1]
    means = torch.nanmean(z, dim=1)
    W = torch.nanmean(_nanvar(z, 1), dim=1)
    B = n * _nanvar(means, 1)
    return torch.sqrt(((n - 1.0) / n * W + B / n) / W)


def _ess_of_t(z):
    """:func:`_ess_of` of each column of ``z`` ``(C, n, m)``."""
    C, n, _ = z.shape
    dtype = z.dtype
    if n < 4:
        return z.new_full((C,), torch.nan)
    finite = torch.isfinite(z)
    keep = finite.any(dim=1)  # (C, m)
    kf = keep.to(dtype)
    mk = kf.sum(dim=1)
    counts = finite.sum(dim=1).clamp(min=1).to(dtype)
    means = torch.where(finite, z, 0.0).sum(dim=1) / counts
    zf = torch.where(finite, z, means[:, None, :])
    zf = torch.where(keep[:, None, :], zf, 0.0)
    W = (zf.var(dim=1, correction=1) * kf).sum(dim=1) / mk
    mbar = (means * kf).sum(dim=1) / mk
    B_over_n = (kf * (means - mbar[:, None]) ** 2).sum(dim=1) / (
        mk - 1.0).clamp(min=1.0)
    var_plus = W * (n - 1.0) / n + B_over_n
    f = torch.fft.rfft(zf - zf.mean(dim=1, keepdim=True), n=2 * n, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), n=2 * n, dim=1)[:, :n] / n
    acov_mean = (acov * kf[:, None, :]).sum(dim=2) / mk[:, None]
    rho = 1.0 - (W[:, None] - acov_mean) / var_plus[:, None]
    L = (n - 1) // 2
    pairs = rho[:, 0:2 * L:2] + rho[:, 1:2 * L:2]
    ok = torch.cumprod((pairs > 0.0).to(dtype), dim=1)
    tau_sum = (torch.cummin(pairs, dim=1).values * ok).sum(dim=1)
    tau = torch.where(pairs[:, 0] > 0.0, -1.0 + 2.0 * tau_sum, 1.0)
    tau = torch.maximum(tau, 1.0 / torch.log10((n * mk).clamp(min=10.0)))
    bad = (mk < 2.0) | ~torch.isfinite(var_plus) | (var_plus <= 0.0) | (
        W <= 0.0)
    return torch.where(bad, torch.nan, n * mk / tau)


def _split_columns(chains):
    """``(nsteps, nwalkers, ncols)`` to the split chains as ``(ncols,
    nsteps // 2, 2 * nwalkers)`` in float64."""
    if chains.ndim == 2:
        chains = chains[..., None]
    nsteps = chains.shape[0]
    half = nsteps // 2
    if half < 2:
        raise ValueError(
            f"rank-normalized R-hat needs >= 4 steps, got {nsteps}."
        )
    trimmed = chains[nsteps - 2 * half:].to(torch.float64)
    split = torch.cat([trimmed[:half], trimmed[half:]], dim=1)
    return split.permute(2, 0, 1).contiguous()


def rank_normalized_rhat_torch(chains, return_parts=False):
    """:func:`rank_normalized_rhat` of a tensor ``(nsteps, nwalkers,
    ncols)`` (NaNs for dead leaves), computed where it lies; returns
    tensors ``(ncols,)`` there (with ``return_parts``, ``(rhat, bulk,
    tail)``)."""
    x = _split_columns(chains)
    bulk = _basic_rhat_t(_rank_z(x))
    median = _nanquantile(x.reshape(x.shape[0], -1), (0.5,))[0]
    tail = _basic_rhat_t(_rank_z(torch.abs(x - median[:, None, None])))
    rhat = torch.maximum(bulk, tail)
    return (rhat, bulk, tail) if return_parts else rhat


def effective_sample_size_torch(chains, return_parts=False):
    """:func:`effective_sample_size` of a tensor ``(nsteps, nwalkers,
    ncols)`` (NaNs for dead leaves), computed where it lies; returns
    tensors ``(ncols,)`` there (with ``return_parts``, ``(ess, bulk,
    tail)``)."""
    x = _split_columns(chains)
    finite = torch.isfinite(x)
    any_f = finite.flatten(1).any(dim=1)
    bulk = _ess_of_t(_rank_z(x))
    qs = _nanquantile(x.reshape(x.shape[0], -1), (0.05, 0.95))
    tails = [_ess_of_t(torch.where(finite, (x <= q[:, None, None]).to(x.dtype),
                                   torch.nan)) for q in qs]
    tail = torch.fmin(tails[0], tails[1])
    bulk = torch.where(any_f, bulk, torch.nan)
    tail = torch.where(any_f, tail, torch.nan)
    ess = torch.fmin(bulk, tail)
    return (ess, bulk, tail) if return_parts else ess
