"""The numbers that decide ``correct``, computed from the benchmark's inputs
and the program's stored outputs, in float64.

- ``logpost_gap``: over a sample of stored steps drawn from the seed (every
  temperature and walker of each), the widest relative gap between a stored
  log-likelihood or log-prior and the reference's at the stored coordinates
  and leaf masks.  It sees a likelihood computed in a lower precision, an
  answer altered where it is produced, a sample stored apart from its
  log-posterior and a coordinate outside its prior (the reference's
  log-prior is then -inf).
- ``rhat``: the largest split R-hat (Gelman and Rubin, each walker's cold
  series split in two halves) of the cold chain's mixing series.  A step
  that returns its state unchanged leaves every within-chain variance at 0
  (R-hat infinite); walkers left out of the update keep their start and
  lift it well above 1.
- ``moment_z``: the largest gap, in standard errors, between a moment of
  the stored chain and the reference's value of it, per step the walkers'
  mean of each coordinate and of its square (the family's reference says
  which rungs and which samples it knows the target of).  The standard
  error is the chain's, from batch means, and the reference's own where it
  integrates by sampling.  It sees an accept that leaves out the
  proposal's factor, swaps decided with the wrong sign and a ladder that
  stores other temperatures than the chain was sampled at: a chain that
  samples another distribution than the one it stores.
"""

from __future__ import annotations

import math

import torch


def uniform_log_prior(coords, inds, bounds):
    """Log-prior of uniform priors ``bounds`` ``(ndim, 2)`` over the active
    leaves: ``-sum log(high - low)`` a leaf, -inf outside, 0 without
    leaves.  ``coords`` ``(..., nleaves, ndim)``, ``inds`` ``(..., nleaves)``
    or None (every leaf active)."""
    x = coords.to(torch.float64)
    b = bounds.to(device=x.device, dtype=torch.float64)
    lo, hi = b[:, 0], b[:, 1]
    inside = ((x >= lo) & (x <= hi)).all(dim=-1)
    per_leaf = torch.where(inside, -torch.log(hi - lo).sum(),
                           torch.tensor(-math.inf, dtype=torch.float64,
                                        device=x.device))
    if inds is None:
        return per_leaf.sum(dim=-1)
    return torch.where(inds, per_leaf, 0.0).sum(dim=-1)


def relative_gap(stored, ref):
    """``|stored - ref| / |ref|`` per entry (0 where both are 0); a NaN, an
    infinite stored value or an infinite reference reads +inf."""
    s, r = stored.to(torch.float64), ref.to(torch.float64)
    diff = (s - r).abs()
    gap = torch.where(diff == 0, 0.0, diff / r.abs().clamp(min=1e-300))
    return torch.where(torch.isfinite(s) & torch.isfinite(r) & ~gap.isnan(),
                       gap, math.inf)


def logpost_gaps(sample, inputs, bounds, log_like):
    """Per stored sample the larger of its log-likelihood's and
    log-prior's relative gaps.  ``sample``: ``coords`` ``(K, ntemps,
    nwalkers, nleaves, ndim)``, ``inds`` (or None), ``log_like`` and
    ``log_prior`` ``(K, ntemps, nwalkers)``; ``log_like``: the family's
    reference."""
    coords, inds = sample["coords"], sample["inds"]
    ll_ref = log_like(coords, inds, inputs)
    lp_ref = uniform_log_prior(coords, inds, bounds)
    return torch.maximum(relative_gap(sample["log_like"], ll_ref),
                         relative_gap(sample["log_prior"], lp_ref))


def split_rhat(series):
    """Largest split R-hat over the columns of ``series`` ``(nsteps,
    nwalkers, k)``: each walker's series cut into two halves, chains of
    ``n = nsteps // 2``; ``sqrt(((n - 1) / n W + B / n) / W)`` with ``W``
    the mean within-chain variance and ``B / n`` the variance of the chain
    means.  No within-chain variance reads +inf."""
    x = series.to(torch.float64)
    n = x.shape[0] // 2
    if n < 2:
        return math.inf
    chains = torch.cat([x[:n], x[n:2 * n]], dim=1)  # (n, 2 nwalkers, k)
    w = chains.var(dim=0, unbiased=True).mean(dim=0)
    b_over_n = chains.mean(dim=0).var(dim=0, unbiased=True)
    var_plus = (n - 1) / n * w + b_over_n
    r = torch.where(w > 0, torch.sqrt(var_plus / w.clamp(min=1e-300)),
                    math.inf)
    r = torch.where(r.isnan(), math.inf, r)
    return float(r.max())


def batch_z(dev, ref_var=None, batches=50, min_len=20):
    """The largest ``|mean| / SE`` over the columns of ``dev`` ``(T, k)``:
    per stored step a statistic's deviation from the reference's value.
    Rows holding a NaN (a step with nothing to read) are left out; the rest
    are cut into ``batches`` batches of consecutive steps (fewer where a
    batch would hold under ``min_len`` steps, so that a batch outlasts the
    chain's memory), and the chain's standard error is the batch means'
    spread over the square root of their number, to which ``ref_var``
    ``(k,)``, the reference's own variance, adds.  Fewer than two batches,
    or a non-finite result, reads +inf."""
    x = dev.to(torch.float64)
    x = x[~x.isnan().any(dim=1)]
    nb = min(batches, x.shape[0] // min_len)
    if nb < 2:
        return math.inf
    n = x.shape[0] // nb
    x = x[:n * nb]
    means = x.reshape(nb, n, -1).mean(dim=1)
    se2 = means.var(dim=0, unbiased=True) / nb
    if ref_var is not None:
        se2 = se2 + ref_var.to(se2)
    z = x.mean(dim=0).abs() / se2.sqrt()
    z = torch.where(torch.isfinite(z), z, math.inf)
    return float(z.max())
