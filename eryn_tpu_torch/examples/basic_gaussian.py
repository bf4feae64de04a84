"""Fit a multivariate Gaussian: the minimal eryn_tpu_torch workflow.

Run: python -m eryn_tpu_torch.examples.basic_gaussian
"""

import numpy as np
import torch

from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu_torch.examples._common import device_and_generator, example_steps


def main(device=None, scale=1.0):
    device, gen = device_and_generator(device, 42)
    ndim, nwalkers = 5, 100

    means = torch.zeros(ndim, device=device)
    invcov = torch.eye(ndim, device=device)

    def log_like(x):
        diff = x - means
        return -0.5 * torch.sum(diff * (invcov @ diff))

    priors = ProbDistContainer(
        {i: uniform_dist(-5.0, 5.0) for i in range(ndim)}
    )

    ensemble = EnsembleSampler(nwalkers, ndim, log_like, priors, seed=42,
                               device=device)
    coords = priors.rvs(size=(nwalkers,), generator=gen)
    ensemble.run_mcmc(coords, example_steps(2000, scale),
                      burn=example_steps(500, scale), progress=True)

    chain = ensemble.get_chain()["model_0"].reshape(-1, ndim)
    out = dict(
        mean=chain.mean(axis=0), std=chain.std(axis=0),
        acceptance=float(ensemble.acceptance_fraction.mean()),
        timing=ensemble.timing.summary(),
    )
    print("posterior mean:", np.round(out["mean"], 3))
    print("posterior std:", np.round(out["std"], 3))
    print("acceptance fraction:", out["acceptance"])
    print("throughput:", out["timing"])
    return out


if __name__ == "__main__":
    main()
