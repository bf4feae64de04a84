"""Non-reversible (DEO) parallel tempering and replica-flow diagnostics.

``swap_scheme="deo"`` (Syed et al. 2021) replaces the sequential swap
cascade with deterministic even-odd phases of disjoint rung pairs: an
exchange of constant depth, fully parallel, the scheme of choice for wide
ladders or cheap likelihoods.  An integer tag in the state supplemental is
exchanged by the swap phase alongside the chain, which makes the replicas'
trajectories, and their round trips over the ladder (the unit of tempering
work), observable through
``eryn_tpu_torch.utils.replica_round_trips``.

Run: python -m eryn_tpu_torch.examples.nonreversible_pt
"""

import numpy as np
import torch

from eryn_tpu_torch import (
    BranchSupplemental,
    EnsembleSampler,
    ProbDistContainer,
    State,
    uniform_dist,
)
from eryn_tpu_torch.examples._common import device_and_generator, example_steps
from eryn_tpu_torch.utils import replica_round_trips

NDIM = 3
NWALKERS = 24
NTEMPS = 8


def log_like(x):
    # two well-separated modes: tempering is what moves walkers between them
    return torch.logaddexp(
        -0.5 * torch.sum((x - 3.0) ** 2) / 0.3,
        -0.5 * torch.sum((x + 3.0) ** 2) / 0.3,
    )


def main(device=None, scale=1.0):
    device, gen = device_and_generator(device, 11)
    priors = ProbDistContainer({i: uniform_dist(-8, 8) for i in range(NDIM)})
    nsteps = example_steps(800, scale)
    # the rung each tag sits on, when the tags are in walker order
    rung_of_slot = torch.arange(NTEMPS, dtype=torch.int8,
                                device=device).repeat_interleave(NWALKERS)

    out = {}
    for scheme in ("cascade", "deo"):
        ens = EnsembleSampler(
            NWALKERS, NDIM, log_like, priors,
            tempering_kwargs=dict(ntemps=NTEMPS, swap_scheme=scheme),
            seed=11, device=device,
        )
        # replica tags ride the supplemental through the swap phases
        flat = np.arange(NTEMPS * NWALKERS).reshape(NTEMPS, NWALKERS)
        start = State(
            {"model_0": priors.rvs(size=(NTEMPS, NWALKERS), generator=gen)},
            supplemental=BranchSupplemental(
                {"rid": flat.copy()}, base_shape=(NTEMPS, NWALKERS)
            ),
        )
        # each step's rungs are gathered on the device and read once
        rungs = []
        for s in ens.sample(start, iterations=nsteps, store=True):
            tag = s.supplemental["rid"].reshape(-1)
            pos = torch.empty_like(rung_of_slot)
            pos[tag] = rung_of_slot
            rungs.append(pos)
        rungs = torch.stack(rungs).cpu().numpy()

        trips = replica_round_trips(rungs, NTEMPS)
        swap_frac = np.asarray(ens.backend.swaps_accepted, dtype=float) / (
            nsteps * NWALKERS
        )
        chain = ens.get_chain(discard=nsteps // 4)["model_0"][:, 0]
        frac_upper = float((chain[..., 0] > 0).mean())
        print(
            f"{scheme:8s} round trips {trips:5d}  "
            f"swap acc (cold rung, per attempt) {swap_frac[0]:.2f}  "
            f"upper-mode fraction {frac_upper:.2f}"
        )
        if nsteps >= 800:  # statistical assertions only at full scale
            # both modes populated (tempering works) and replicas flow
            assert 0.25 < frac_upper < 0.75, frac_upper
            assert trips > 0
        out[scheme] = dict(round_trips=int(trips), cold_swap=swap_frac[0],
                           upper_fraction=frac_upper)
    return out


if __name__ == "__main__":
    main()
