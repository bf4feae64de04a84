"""Parallel tempering and the model evidence by stepping-stone integration.

Run: python -m eryn_tpu_torch.examples.pt_evidence
"""

import numpy as np
import torch

from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu_torch.examples._common import device_and_generator, example_steps


def main(device=None, scale=1.0):
    device, gen = device_and_generator(device, 3)
    ndim, nwalkers, ntemps = 3, 64, 14

    def log_like(x):
        return -0.5 * torch.sum(x**2)

    lim = 8.0
    priors = ProbDistContainer(
        {i: uniform_dist(-lim, lim) for i in range(ndim)}
    )

    ensemble = EnsembleSampler(
        nwalkers,
        ndim,
        log_like,
        priors,
        # freeze the ladder so the evidence integral is well defined
        tempering_kwargs=dict(ntemps=ntemps, adaptive=False),
        seed=3,
        device=device,
    )
    coords = priors.rvs(size=(ntemps, nwalkers), generator=gen)
    burn = example_steps(500, scale)
    ensemble.run_mcmc(coords, example_steps(2000, scale), burn=burn,
                      progress=True)

    logz_ss, dlogz_ss = ensemble.backend.get_evidence_estimate(
        discard=burn, method="stepping_stone"
    )
    logz_ti, dlogz_ti = ensemble.backend.get_evidence_estimate(discard=burn)
    analytic = 0.5 * ndim * np.log(2 * np.pi) - ndim * np.log(2 * lim)
    swaps = np.asarray(ensemble.swap_acceptance_fraction)
    print(f"stepping-stone logZ = {logz_ss:.3f} +- {dlogz_ss:.3f}")
    print(f"thermodynamic  logZ = {logz_ti:.3f} +- {dlogz_ti:.3f}")
    print(f"analytic       logZ = {analytic:.3f}")
    print("swap acceptance per rung:", np.round(swaps, 3))
    return dict(logz_ss=float(logz_ss), dlogz_ss=float(dlogz_ss),
                logz_ti=float(logz_ti), dlogz_ti=float(dlogz_ti),
                analytic=float(analytic), swap_acceptance=swaps)


if __name__ == "__main__":
    main()
