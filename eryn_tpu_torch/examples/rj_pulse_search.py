"""Reversible-jump MCMC: how many Gaussian pulses are in the data?

Run: python -m eryn_tpu_torch.examples.rj_pulse_search
"""

import numpy as np
import torch

from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu_torch.examples._common import device_and_generator, example_steps
from eryn_tpu_torch.moves import RedBlueGroupStretchMove


def main(device=None, scale=1.0):
    device, gen = device_and_generator(device, 4)
    rng = np.random.default_rng(0)
    t_np = np.linspace(0.0, 10.0, 200)
    sigma = 0.3
    # truth: two pulses
    data_np = (
        2.5 * np.exp(-((t_np - 2.5) ** 2) / (2 * 0.5**2))
        + 3.0 * np.exp(-((t_np - 7.0) ** 2) / (2 * 0.7**2))
        + sigma * rng.standard_normal(len(t_np))
    )
    t = torch.as_tensor(t_np, dtype=torch.float32, device=device)
    data = torch.as_tensor(data_np, dtype=torch.float32, device=device)

    def log_like(coords, inds):
        # coords: (nleaves_max, 3) padded; inds: (nleaves_max,) active mask
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        pulses = a[:, None] * torch.exp(
            -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
        )
        template = torch.sum(torch.where(inds[:, None], pulses, 0.0), dim=0)
        return -0.5 * torch.sum(((template - data) / sigma) ** 2)

    priors = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),   # amplitude
            1: uniform_dist(0.0, 10.0),  # center
            2: uniform_dist(0.2, 2.0),   # width
        }
    )

    nwalkers, ntemps, nleaves_max = 64, 8, 4
    ensemble = EnsembleSampler(
        nwalkers,
        3,
        log_like,
        priors,
        nleaves_max=nleaves_max,
        nleaves_min=0,
        # the RJ-correct in-model stretch: each active leaf stretches toward
        # an active complement leaf (the plain StretchMove would target the
        # same leaf slot, which may be dormant; the sampler warns)
        moves=RedBlueGroupStretchMove(),
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps),
        fill_zero_leaves_val=float(-0.5 * np.sum((data_np / sigma) ** 2)),
        seed=4,
        device=device,
    )

    coords = priors.rvs(size=(ntemps, nwalkers, nleaves_max), generator=gen)
    inds = torch.rand((ntemps, nwalkers, nleaves_max), generator=gen,
                      device=device) < 0.5
    state = State({"model_0": coords}, inds={"model_0": inds})
    ensemble.run_mcmc(state, example_steps(1000, scale),
                      burn=example_steps(1000, scale), progress=True)

    nleaves = ensemble.get_nleaves()["model_0"][:, 0]  # cold chain
    vals, counts = np.unique(nleaves, return_counts=True)
    posterior = {int(v): float(c / counts.sum()) for v, c in zip(vals, counts)}
    print("posterior over pulse count:")
    for v, p in posterior.items():
        print(f"  k={v}: {p:.3f}")

    chain = ensemble.get_chain()["model_0"][:, 0]
    mask = ensemble.get_inds()["model_0"][:, 0]
    centers = np.percentile(chain[..., 1][mask], [25, 75])
    print("recovered pulse centers (quartiles):", centers)
    return dict(posterior=posterior, centers=centers)


if __name__ == "__main__":
    main()
