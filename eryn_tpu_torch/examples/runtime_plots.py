"""Runtime diagnostic plotting: Eryn's ``plotting_example.py`` and
``plotting_rj_example.py`` workflow on the port, a tempered run and an RJ
pulse search with ``PlotContainer``'s plot groups written to ``outdir``
(default ``./plots_out``).  Needs matplotlib.

Run: python -m eryn_tpu_torch.examples.runtime_plots
"""

import os

import numpy as np
import torch

from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, State, uniform_dist
from eryn_tpu_torch.examples._common import device_and_generator, example_steps
from eryn_tpu_torch.moves import RedBlueGroupStretchMove
from eryn_tpu_torch.utils.plot import PlotContainer


def pt_gaussian(device, scale, outdir):
    """A tempered run on a 5-D Gaussian: the base, tempering and advanced
    plots."""
    device, gen = device_and_generator(device, 0)
    ndim, nwalkers, ntemps = 5, 64, 10
    invcov = torch.eye(ndim, device=device)

    def log_like(x):
        return -0.5 * torch.sum(x * (invcov @ x))

    priors = ProbDistContainer({i: uniform_dist(-10, 10) for i in range(ndim)})
    ens = EnsembleSampler(
        nwalkers,
        ndim,
        log_like,
        priors,
        tempering_kwargs=dict(ntemps=ntemps),
        seed=0,
        device=device,
    )
    coords = priors.rvs(size=(ntemps, nwalkers), generator=gen)
    ens.run_mcmc(coords, example_steps(1000, scale),
                 burn=example_steps(300, scale))

    plots = PlotContainer(
        fp="pt_gaussian",
        backend=ens.backend,
        plot_dir=outdir,
        which_plots=["base", "tempering", "advanced"],
    )
    plots.produce_plots(burn=min(100, ens.backend.iteration // 2))
    written = sorted(os.listdir(outdir))
    print("PT plots written:", written)
    return written


def rj_pulses(device, scale, outdir):
    """An RJ pulse search: the leaf-count histograms and their evolution."""
    device, gen = device_and_generator(device, 1)
    rng = np.random.default_rng(7)
    t_np = np.linspace(0, 10, 96)
    sigma = 0.4
    data_np = 3.0 * np.exp(-((t_np - 3.0) ** 2) / (2 * 0.5**2))
    data_np = data_np + 2.0 * np.exp(-((t_np - 7.0) ** 2) / (2 * 0.4**2))
    data_np = data_np + sigma * rng.standard_normal(len(t_np))
    t = torch.as_tensor(t_np, dtype=torch.float32, device=device)
    data = torch.as_tensor(data_np, dtype=torch.float32, device=device)

    def log_like(coords, inds):
        a, b, c = coords[:, 0], coords[:, 1], coords[:, 2]
        p = a[:, None] * torch.exp(
            -((t[None] - b[:, None]) ** 2) / (2 * c[:, None] ** 2)
        )
        tmpl = torch.sum(torch.where(inds[:, None], p, 0.0), dim=0)
        return -0.5 * torch.sum(((tmpl - data) / sigma) ** 2)

    priors = ProbDistContainer(
        {
            0: uniform_dist(0.5, 5.0),
            1: uniform_dist(0.0, 10.0),
            2: uniform_dist(0.1, 2.0),
        }
    )
    ntemps, nwalkers, nmax = 8, 64, 4
    ens = EnsembleSampler(
        nwalkers,
        3,
        log_like,
        priors,
        nleaves_max=nmax,
        nleaves_min=0,
        moves=RedBlueGroupStretchMove(),  # the RJ-correct in-model stretch
        rj_moves=True,
        tempering_kwargs=dict(ntemps=ntemps),
        fill_zero_leaves_val=float(-0.5 * np.sum((data_np / sigma) ** 2)),
        seed=1,
        device=device,
    )
    coords = priors.rvs(size=(ntemps, nwalkers, nmax), generator=gen)
    inds = torch.rand((ntemps, nwalkers, nmax), generator=gen,
                      device=device) < 0.3
    ens.run_mcmc(State({"model_0": coords}, inds={"model_0": inds}),
                 example_steps(800, scale), burn=example_steps(300, scale))

    plots = PlotContainer(
        fp="rj_pulses",
        backend=ens.backend,
        plot_dir=outdir,
        which_plots=["base", "rj"],
    )
    plots.produce_plots(burn=min(100, ens.backend.iteration // 2))
    mean_leaves = float(ens.get_nleaves()["model_0"][:, 0].mean())
    print("RJ plots written; mean leaf count (cold chain):", mean_leaves)
    return mean_leaves


def main(device=None, scale=1.0, outdir=None):
    outdir = outdir or os.path.join(os.getcwd(), "plots_out")
    os.makedirs(outdir, exist_ok=True)
    written = pt_gaussian(device, scale, outdir)
    mean_leaves = rj_pulses(device, scale, outdir)
    return dict(files=sorted(os.listdir(outdir)), pt_files=written,
                mean_leaves=mean_leaves)


if __name__ == "__main__":
    main()
