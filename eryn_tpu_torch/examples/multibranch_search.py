"""Two model families with unknown counts: Gaussian pulses and sinusoids.

Eryn's multi-branch reversible-jump test in one script: each branch has its
own dimensionality and leaf-count range, ``rj_moves="iterate_branches"``
proposes births and deaths in each, and the sampler recovers how many of
each signal the data holds.

Run: python -m eryn_tpu_torch.examples.multibranch_search
"""

import numpy as np
import torch

from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu_torch.examples._common import device_and_generator, example_steps
from eryn_tpu_torch.moves import RedBlueGroupStretchMove

NT, NW = 6, 100
NLMAX = {"gauss": 4, "sine": 2}


def main(device=None, scale=1.0):
    device, gen = device_and_generator(device, 7)
    rng = np.random.default_rng(1)
    num = 256
    t_np = np.linspace(0.0, 10.0, num)
    sigma = 0.5

    # truth: 2 gaussian pulses + 1 sinusoid
    injection = (
        3.0 * np.exp(-((t_np - 2.5) ** 2) / (2 * 0.4**2))
        + 2.6 * np.exp(-((t_np - 7.0) ** 2) / (2 * 0.5**2))
        + 1.2 * np.sin(2 * np.pi * 0.7 * t_np)
    )
    y = injection + sigma * rng.standard_normal(num)
    t = torch.as_tensor(t_np, dtype=torch.float32, device=device)
    data = torch.as_tensor(y, dtype=torch.float32, device=device)

    def log_like(coords, inds):
        a, b, c = (coords["gauss"][:, i] for i in range(3))
        pulses = a[:, None] * torch.exp(
            -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
        )
        amp, f, ph = (coords["sine"][:, i] for i in range(3))
        sines = amp[:, None] * torch.sin(
            2 * np.pi * f[:, None] * t[None] + ph[:, None]
        )
        tmpl = torch.sum(torch.where(inds["gauss"][:, None], pulses, 0.0), dim=0)
        tmpl = tmpl + torch.sum(torch.where(inds["sine"][:, None], sines, 0.0),
                                dim=0)
        return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    priors = {
        "gauss": ProbDistContainer({0: uniform_dist(0.5, 5.0),
                                    1: uniform_dist(0.0, 10.0),
                                    2: uniform_dist(0.1, 1.0)}),
        "sine": ProbDistContainer({0: uniform_dist(0.2, 3.0),
                                   1: uniform_dist(0.1, 2.0),
                                   2: uniform_dist(0.0, 2 * np.pi)}),
    }

    ens = EnsembleSampler(
        NW,
        {"gauss": 3, "sine": 3},
        log_like,
        priors,
        branch_names=["gauss", "sine"],
        nleaves_max=NLMAX,
        nleaves_min={"gauss": 0, "sine": 0},
        moves=RedBlueGroupStretchMove(),  # the RJ-correct in-model stretch
        rj_moves="iterate_branches",
        tempering_kwargs=dict(ntemps=NT),
        fill_zero_leaves_val=float(-0.5 * np.sum((y / sigma) ** 2)),
        periodic={"sine": {2: 2 * np.pi}},
        seed=7,
        device=device,
    )

    coords = {n: priors[n].rvs(size=(NT, NW, NLMAX[n]), generator=gen)
              for n in NLMAX}
    inds = {n: torch.rand((NT, NW, NLMAX[n]), generator=gen,
                          device=device) < 0.5 for n in NLMAX}
    ens.run_mcmc(State(coords, inds=inds), example_steps(1500, scale),
                 burn=example_steps(1500, scale), progress=False)

    out = {}
    for name in ("gauss", "sine"):
        k = ens.get_nleaves()[name][:, 0]
        out[name] = {int(v): round(float((k == v).mean()), 3)
                     for v in np.unique(k)}
        print(f"{name}: leaf-count posterior {out[name]}")
    chain, live = ens.get_chain(), ens.get_inds()
    centers = chain["gauss"][:, 0][..., 1][live["gauss"][:, 0]]
    out["centers"] = np.round(np.percentile(centers, [25, 75]), 2)
    print("pulse centers (quartiles):", out["centers"])
    freqs = chain["sine"][:, 0][..., 1][live["sine"][:, 0]]
    out["frequency"] = round(float(np.median(freqs)), 3)
    print("sine frequency (median):", out["frequency"])
    return out


if __name__ == "__main__":
    main()
