"""The port's sampler on the CPU against eryn_tpu's, statistically.

Both samplers start from the same numpy ensemble and ladder (carried through
:mod:`eryn_tpu_torch.interop`) on a 3-D unit Gaussian with 4 temperatures,
and run 2000 stored steps after 200 of burn-in.  torch's generator cannot
replay JAX's keys, so the chains differ draw by draw and are compared by
their statistics.  Tolerances, each several standard errors of the
difference at this chain length (about 2000 x 32 cold samples with an IACT
near 2.5):

* cold-chain mean within 0.06 of eryn_tpu's and of 0, variance within 0.1;
* cold-rung acceptance fraction within 0.02;
* per-rung swap acceptance within 0.03;
* adapted betas within 3 % (relative);
* integrated autocorrelation times within 25 % (relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import eryn_tpu
import eryn_tpu_torch
from eryn_tpu_torch.interop import (
    state_from_numpy,
    state_to_numpy,
    tempering_from_numpy,
    tempering_to_numpy,
)

torch.set_num_threads(1)

NT, NDIM, NSTEPS, BURN = 4, 3, 2000, 200


def _summary(sampler):
    cold = np.asarray(sampler.get_chain(temp_index=0)["model_0"]).reshape(-1, NDIM)
    return dict(
        mean=cold.mean(axis=0),
        var=cold.var(axis=0),
        acc=float(np.mean(sampler.acceptance_fraction[0])),
        swaps=np.asarray(sampler.swap_acceptance_fraction),
        betas=np.asarray(sampler.get_betas()[-1]),
        tau=np.asarray(sampler.get_autocorr_time()["model_0"]).ravel(),
    )


@pytest.fixture(scope="module")
def reference():
    """eryn_tpu's run per walker count, with the numpy ensemble and ladder
    it started from."""
    cache = {}

    def run(nw):
        if nw not in cache:
            priors = eryn_tpu.ProbDistContainer(
                {i: eryn_tpu.uniform_dist(-5.0, 5.0) for i in range(NDIM)}
            )
            sampler = eryn_tpu.EnsembleSampler(
                nw, NDIM, lambda x: -0.5 * jnp.sum(x * x), priors,
                tempering_kwargs=dict(ntemps=NT), seed=11,
            )
            rng = np.random.default_rng(nw)
            start = eryn_tpu.State(
                {"model_0": rng.uniform(-3, 3, (NT, nw, 1, NDIM)).astype(np.float32)}
            )
            start_np = state_to_numpy(start)
            ladder_np = tempering_to_numpy(sampler.temperature_control)
            sampler.run_mcmc(start, NSTEPS, burn=BURN)
            cache[nw] = (_summary(sampler), start_np, ladder_np)
        return cache[nw]

    return run


@pytest.mark.parametrize(
    "nw,backend,use_kernels",
    [
        (32, "Backend", None),        # the CPU default: general paths
        (33, "DeviceBackend", None),  # odd halves, chain kept as tensors
        (32, "Backend", True),        # the kernel path's plain versions
        (33, "DeviceBackend", True),
    ],
)
def test_port_sampler_matches_eryn_tpu(reference, nw, backend, use_kernels):
    ref, start_np, ladder_np = reference(nw)
    priors = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(-5.0, 5.0) for i in range(NDIM)}
    )
    sampler = eryn_tpu_torch.EnsembleSampler(
        nw, NDIM, lambda x: -0.5 * torch.sum(x * x), priors,
        tempering_kwargs=dict(ntemps=NT, use_kernels=use_kernels),
        moves=[eryn_tpu_torch.StretchMove(use_kernels=use_kernels)],
        backend=getattr(eryn_tpu_torch, backend)(), seed=5, device="cpu",
    )
    tempering_from_numpy(sampler.temperature_control, ladder_np)
    sampler.run_mcmc(state_from_numpy(start_np, device="cpu"), NSTEPS,
                     burn=BURN)
    out = _summary(sampler)

    assert np.all(np.abs(out["mean"]) < 0.06), out["mean"]
    np.testing.assert_allclose(out["mean"], ref["mean"], atol=0.06)
    np.testing.assert_allclose(out["var"], ref["var"], atol=0.1)
    assert abs(out["acc"] - ref["acc"]) < 0.02, (out["acc"], ref["acc"])
    np.testing.assert_allclose(out["swaps"], ref["swaps"], atol=0.03)
    np.testing.assert_allclose(out["betas"], ref["betas"], rtol=0.03)
    assert not np.allclose(out["betas"], ladder_np["betas"])  # it adapted
    assert np.all(np.isfinite(out["tau"]))
    np.testing.assert_allclose(out["tau"], ref["tau"], rtol=0.25)
