"""Update hooks for ``run_mcmc``'s ``update_fn``.

Port of :mod:`eryn_tpu.utils.updates`.  An update is called as
``update_fn(iteration, last_sample, sampler)``.  On a CUDA device each
move's step is a captured graph, which keeps the move's configuration as it
was at capture: an update that changes it (:class:`AdjustStretchProposalScale`
changes the stretch scale ``a``) calls ``sampler.drop_step_graphs()``, and
the next step captures anew.
"""

from __future__ import annotations

import dataclasses
from abc import ABC

import numpy as np

__all__ = [
    "Update",
    "CompositeUpdate",
    "UpdateStep",
    "AdjustStretchProposalScale",
]


class Update(ABC):
    """Base class of update hooks; ``a + b`` runs ``a`` then ``b``."""

    def __call__(self, iter, last_sample, sampler):
        raise NotImplementedError

    def __add__(self, other):
        if isinstance(other, CompositeUpdate):
            return CompositeUpdate([self] + other._updates)
        if isinstance(other, Update):
            return CompositeUpdate([self, other])
        return NotImplemented

    def __radd__(self, other):
        if isinstance(other, CompositeUpdate):
            return CompositeUpdate(other._updates + [self])
        if isinstance(other, Update):
            return CompositeUpdate([other, self])
        return NotImplemented


class CompositeUpdate(Update):
    """Updates applied in order."""

    def __init__(self, updates: list):
        self._updates = list(updates)

    def __call__(self, iter, last_sample, sampler):
        for update in self._updates:
            update(iter, last_sample, sampler)

    def __add__(self, other):
        if isinstance(other, CompositeUpdate):
            return CompositeUpdate(self._updates + other._updates)
        if isinstance(other, Update):
            return CompositeUpdate(self._updates + [other])
        return NotImplemented

    def __repr__(self):
        return f"CompositeUpdate({self._updates!r})"


@dataclasses.dataclass
class UpdateStep(Update):
    """An update on a schedule that backs off geometrically: every
    ``nsteps * increment ** (iteration // increment_every)`` iterations,
    until ``stop``.  Subclasses implement :meth:`update`."""

    nsteps: int = 100
    increment: int = 1
    increment_every: int = 500
    stop: int = None

    def check_step(self, iteration):
        if iteration == 0:
            return False
        exponent = iteration // self.increment_every
        interval = self.nsteps * (self.increment**exponent)
        if self.stop is not None and iteration >= self.stop:
            return False
        return (iteration % interval) == 0

    def update(self, iteration, last_sample, sampler):
        raise NotImplementedError("Subclasses must implement update() method.")

    def __call__(self, iteration, last_sample, sampler):
        if self.check_step(iteration):
            self.update(iteration, last_sample, sampler)


class AdjustStretchProposalScale(Update):
    """Tune the stretch scale ``a`` of ``sampler.moves[0]`` toward a target
    cold-chain acceptance, from the acceptance since the previous call."""

    def __init__(self, target_acceptance=0.22, supression_factor=0.1,
                 max_change=0.5, verbose=False):
        self.target_acceptance = target_acceptance
        self.verbose = verbose
        self.max_change = max_change
        self.supression_factor = supression_factor
        self.time = 0

    def __call__(self, iter, last_sample, sampler):
        mean_af = 0.0
        change = 1.0
        if self.time > 0:
            # cold-chain acceptance since the previous update
            accepted_now = np.asarray(sampler.backend.accepted)[0]
            mean_af = np.mean(
                (accepted_now - self.previously_accepted)
                / max(sampler.backend.iteration - self.previous_iter, 1)
            )
            if mean_af > self.target_acceptance:
                factor = min(
                    self.supression_factor * (mean_af / self.target_acceptance),
                    self.max_change,
                )
                change = 1 + self.supression_factor * factor
            else:
                # no acceptance at all means the scale ran away: shrink by
                # the most allowed rather than divide by zero
                ratio = (self.target_acceptance / mean_af if mean_af > 0
                         else np.inf)
                factor = min(self.supression_factor * ratio, self.max_change)
                change = 1 - factor

            if change != 1.0:
                sampler.moves[0].a *= change
                # the captured steps hold the old scale
                sampler.drop_step_graphs()
            if self.verbose:
                print(mean_af, change, sampler.moves[0].a)

        self.previously_accepted = np.asarray(sampler.backend.accepted)[0].copy()
        self.previous_iter = sampler.backend.iteration
        self.time += 1
