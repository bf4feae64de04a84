"""Gradient-guided sampling: MALA and HMC through a torch likelihood.

These moves have no counterpart in Eryn: they differentiate the tempered
log-posterior through the user's own torch likelihood
(``torch.func.grad_and_value``), inside the step's CUDA graph.  The stretch
move's mixing degrades roughly linearly with dimension while HMC's cost
grows only as d^(1/4): on the 24-D correlated target below, HMC
decorrelates several times faster per stored step.

Run: python -m eryn_tpu_torch.examples.gradient_moves
"""

import numpy as np
import torch

from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu_torch.examples._common import device_and_generator, example_steps
from eryn_tpu_torch.moves import ChEESHMCMove, HMCMove, MALAMove, StretchMove

NDIM = 24
NWALKERS = 96
RHO = 0.5


def main(device=None, scale=1.0):
    device, _ = device_and_generator(device, 0)
    cov = RHO * np.ones((NDIM, NDIM)) + (1 - RHO) * np.eye(NDIM)
    invcov = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32,
                             device=device)

    def log_like(x):
        return -0.5 * x @ (invcov @ x)

    priors = ProbDistContainer({i: uniform_dist(-10, 10) for i in range(NDIM)})
    start = np.random.default_rng(0).standard_normal((NWALKERS, NDIM)) @ (
        np.linalg.cholesky(cov).T
    )

    out = {}
    for label, move in [
        ("stretch", StretchMove()),
        ("MALA", MALAMove(eps=0.35)),
        ("HMC", HMCMove(eps=0.25, num_leapfrog=12)),
        # hands-off: the step size and the trajectory length both tune
        # themselves (ChEES-HMC, the batched alternative to NUTS); the
        # tuning must end inside the burn-in, so tune_steps = its length
        ("ChEES", ChEESHMCMove(tune_steps=example_steps(200, scale))),
    ]:
        ens = EnsembleSampler(NWALKERS, NDIM, log_like, priors, moves=[move],
                              seed=3, device=device)
        ens.run_mcmc(start, example_steps(600, scale),
                     burn=example_steps(200, scale))
        tau = float(np.nanmax(ens.get_autocorr_time()["model_0"]))
        acc = float(ens.acceptance_fraction.mean())
        chain = ens.get_chain()["model_0"].reshape(-1, NDIM)
        err = float(np.abs(np.cov(chain.T) - cov).max())
        print(
            f"{label:8s} acceptance {acc:5.2f}  max tau {tau:7.1f}  "
            f"max |cov err| {err:.2f}"
        )
        out[label] = dict(acceptance=acc, tau_max=tau, cov_err=err)
    return out


if __name__ == "__main__":
    main()
