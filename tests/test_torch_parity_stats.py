"""Configs A and B at their full shape, the port against eryn_tpu on the CPU.

``tests/test_parity_reference.py:34-124``'s shapes: a 5-D unit Gaussian in
``U(-5, 5)^5``, 100 walkers, 1 temperature (A) or an adaptive ladder of 10
(B), 600 stored steps after 200 of burn-in, from one numpy start.  torch's
generator cannot replay JAX's keys, so the chains are compared by their
statistics, within bounds of several standard errors of the difference at
this length (60,000 cold samples, an IACT near 40):

* mean acceptance within 0.03 (A), per rung within 0.05 (B);
* cold mean within 0.15 of each other, standard deviation within 0.1;
* B: adapted betas within 0.3 in log (interior rungs), swap fractions within
  0.08 per boundary;
* bulk-and-tail ESS of each parameter within a factor 1.5 of each other;
  rank-normalised R-hat within 0.05 of each other, and below 1.2 for A
  (each walker a chain of 300 split steps with an IACT near 40: about
  1.1 in both packages) and 1.02 for B.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch as et

torch.set_num_threads(1)

NDIM, NWALKERS, LIMS, NSTEPS, BURN = 5, 100, 5.0, 600, 200


def _summary(s, ntemps):
    b = s.backend
    flat = s.get_chain()["model_0"][:, 0].reshape(-1, NDIM)
    return dict(
        acc=np.mean(np.asarray(s.acceptance_fraction), axis=-1),
        mean=flat.mean(0), std=flat.std(0),
        betas=np.asarray(s.get_betas()[-1]),
        swaps=(np.asarray(b.swaps_accepted) / (b.iteration * NWALKERS)
               if ntemps > 1 else None),
        ess=b.get_effective_sample_size()["model_0"],
        rhat=b.get_rank_normalized_rhat()["model_0"],
    )


@pytest.fixture(scope="module", params=[1, 10], ids=["A", "B"])
def runs(request):
    ntemps = request.param
    size = (ntemps, NWALKERS) if ntemps > 1 else (NWALKERS,)
    start = np.random.default_rng(42).uniform(-LIMS, LIMS, size + (NDIM,))
    kw = dict(tempering_kwargs=dict(ntemps=ntemps)) if ntemps > 1 else {}
    jp = eryn_tpu.ProbDistContainer(
        {i: eryn_tpu.uniform_dist(-LIMS, LIMS) for i in range(NDIM)})
    jax_s = eryn_tpu.EnsembleSampler(
        NWALKERS, NDIM, lambda x: -0.5 * jnp.sum(x * x), jp, seed=1234, **kw)
    jax_s.run_mcmc(start, NSTEPS, burn=BURN)
    tp = et.ProbDistContainer(
        {i: et.uniform_dist(-LIMS, LIMS) for i in range(NDIM)})
    port = et.EnsembleSampler(
        NWALKERS, NDIM, lambda x: -0.5 * torch.sum(x * x), tp, seed=1234,
        device="cpu", **kw)
    port.run_mcmc(torch.as_tensor(start), NSTEPS, burn=BURN)
    return ntemps, _summary(jax_s, ntemps), _summary(port, ntemps)


def test_acceptance_and_cold_moments(runs):
    ntemps, ref, ours = runs
    bound = 0.03 if ntemps == 1 else 0.05
    assert np.abs(ref["acc"] - ours["acc"]).max() < bound, (ref["acc"],
                                                            ours["acc"])
    assert np.abs(ref["mean"] - ours["mean"]).max() < 0.15
    assert np.abs(ref["std"] - ours["std"]).max() < 0.1
    assert np.abs(ours["mean"]).max() < 0.15
    assert np.abs(ours["std"] - 1.0).max() < 0.1


def test_ladder_and_swaps(runs):
    ntemps, ref, ours = runs
    if ntemps == 1:
        assert ours["swaps"] is None and len(ours["betas"]) == 1
        return
    log_ratio = np.log(ref["betas"][1:-1]) - np.log(ours["betas"][1:-1])
    assert np.abs(log_ratio).max() < 0.3, (ref["betas"], ours["betas"])
    assert np.abs(ref["swaps"] - ours["swaps"]).max() < 0.08, (ref["swaps"],
                                                               ours["swaps"])


def test_ess_and_rhat(runs):
    ntemps, ref, ours = runs
    ratio = ours["ess"] / ref["ess"]
    assert np.all((ratio > 1 / 1.5) & (ratio < 1.5)), (ref["ess"], ours["ess"])
    assert np.abs(ref["rhat"] - ours["rhat"]).max() < 0.05, (ref["rhat"],
                                                             ours["rhat"])
    bound = 1.2 if ntemps == 1 else 1.02
    assert ours["rhat"].max() < bound and ref["rhat"].max() < bound
