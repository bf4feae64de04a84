"""Porting a custom move: the host route against the in-graph route.

eryn_tpu_torch runs Eryn-style custom moves unchanged: subclass ``MHMove``
and write the host-NumPy ``get_proposal`` (Eryn's protocol), and the
sampler runs that move's steps eagerly on the host, with the sampler's
``numpy.random.RandomState``.  Writing the same proposal as
``get_proposal_kernel`` (torch tensors, randomness from the ``generator``
argument) keeps the step on the device, where it is captured once as a CUDA
graph and replayed.

This example writes one proposal both ways, a per-walker isotropic jump,
and times them.

Run: python -m eryn_tpu_torch.examples.custom_moves
"""

import time
import warnings

import numpy as np
import torch

from eryn_tpu_torch import EnsembleSampler, ProbDistContainer, uniform_dist
from eryn_tpu_torch.examples._common import device_and_generator, example_steps
from eryn_tpu_torch.moves import MHMove

NDIM, NWALKERS = 4, 64
SCALE = 0.6 / np.sqrt(NDIM)


class HostJumpMove(MHMove):
    """Eryn's protocol: a host NumPy ``get_proposal``.  Writing it makes the
    move a host move, which runs eagerly in its steps."""

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self.calls = 0

    def get_proposal(self, branches_coords, random, branches_inds=None,
                     **kwargs):
        self.calls += 1
        q = {}
        for name, c in branches_coords.items():
            c = np.asarray(c)
            q[name] = c + SCALE * random.randn(*c.shape)
        factors = np.zeros(next(iter(q.values())).shape[:2])
        return q, factors


class KernelJumpMove(MHMove):
    """The same proposal on tensors with static shapes, its randomness from
    the ``generator`` argument: it runs inside the step's CUDA graph."""

    def get_proposal_kernel(self, generator, branch_coords, branch_inds,
                            kernel_state, param_masks=None):
        q = {}
        for name, c in branch_coords.items():
            q[name] = c + SCALE * torch.randn(
                c.shape, generator=generator, dtype=c.dtype, device=c.device)
        c = next(iter(q.values()))
        factors = torch.zeros(c.shape[:2], dtype=c.dtype, device=c.device)
        return q, factors, kernel_state


def log_like(x):
    return -0.5 * torch.sum(x**2)


def run(move, nsteps, label, device, gen):
    priors = ProbDistContainer({i: uniform_dist(-5, 5) for i in range(NDIM)})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the host move's warning
        ens = EnsembleSampler(NWALKERS, NDIM, log_like, priors, moves=move,
                              seed=10, device=device)
    # start near the target mode so the short demonstration chain is
    # converged
    coords = 0.5 * torch.randn((1, NWALKERS, NDIM), generator=gen,
                               device=device, dtype=torch.float64)
    # warm pass: the graphed route captures its step here (the host route
    # has nothing to capture); the timed run compares steady rates
    ens.run_mcmc(coords, max(nsteps // 4, 4))
    ens.reset()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    ens.run_mcmc(None, nsteps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    elapsed = time.perf_counter() - t0
    ch = ens.get_chain()["model_0"].reshape(-1, NDIM)
    acc = float(np.mean(ens.acceptance_fraction))
    print(
        f"{label:>13}: {nsteps / elapsed:9.1f} steps/s | "
        f"mean {ch.mean():+.3f} std {ch.std():.3f} acc {acc:.2f}"
    )
    return ens, elapsed


def main(device=None, scale=1.0):
    device, gen = device_and_generator(device, 0)
    n = example_steps(400, scale)
    host_move = HostJumpMove()
    host, t_host = run(host_move, n, "host route", device, gen)
    kernel, t_kernel = run(KernelJumpMove(), n, "in-graph route", device, gen)
    print(f"the in-graph route is {t_host / t_kernel:.1f}x faster at {n} "
          "steps (warm): the host route pays Python and a copy each way "
          "every step, the in-graph route replays one CUDA graph a step on "
          "the GPU")
    return dict(
        steps=n, host_steps_per_s=n / t_host, kernel_steps_per_s=n / t_kernel,
        host_proposals=host_move.calls,
        host_graph_captures=host.graph_captures,
        kernel_graph_captures=kernel.graph_captures,
        kernel_graph_replays=kernel.graph_replays,
    )


if __name__ == "__main__":
    main()
