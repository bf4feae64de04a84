"""Stopping criteria for ``run_mcmc``'s ``stopping_fn``.

Port of :mod:`eryn_tpu.utils.stopping`.  A criterion is called as
``stopping_fn(iteration, last_sample, sampler)`` every
``stopping_iterations`` stored iterations and returns True to end the run.
"""

from __future__ import annotations

from abc import ABC

import numpy as np

__all__ = ["Stopping", "SearchConvergeStopping", "AutoCorrelationStop"]


class Stopping(ABC):
    """Base class of stopping criteria."""

    def __call__(self, iter, last_sample, sampler):
        raise NotImplementedError


class SearchConvergeStopping(Stopping):
    """Stop when the best log-likelihood has stayed within ``diff`` for
    ``n_iters`` consecutive checks.

    Args:
        n_iters: consecutive checks within ``diff`` needed to stop.
        diff: the plateau's tolerance on the best log-likelihood.
        start_iteration: iterations before this one are not checked, and
            not read.
        verbose: print each check.
    """

    def __init__(self, n_iters=30, diff=0.1, start_iteration=0, verbose=False):
        self.n_iters = n_iters
        self.diff = diff
        self.verbose = verbose
        self.start_iteration = start_iteration
        self.iters_consecutive = 0
        self.past_like_best = -np.inf

    def __call__(self, iter, sample, sampler):
        if iter < self.start_iteration:
            return False

        like_best = sampler.get_log_like(discard=self.start_iteration).max()

        if np.abs(like_best - self.past_like_best) < self.diff:
            self.iters_consecutive += 1
        else:
            self.iters_consecutive = 0
            self.past_like_best = like_best

        if self.verbose:
            print(
                f"\nITERS CONSECUTIVE: {self.iters_consecutive}",
                f"Previous best LL: {self.past_like_best}",
                f"Current best LL: {like_best}\n",
            )

        if self.iters_consecutive >= self.n_iters:
            self.iters_consecutive = 0
            return True
        return False


class AutoCorrelationStop(Stopping):
    """Stop when the chain is longer than ``autocorr_multiplier`` integrated
    autocorrelation times and the estimate changed by less than ``rel_tol``
    since the previous check."""

    def __init__(self, autocorr_multiplier=50, rel_tol=0.01, verbose=False):
        self.autocorr_multiplier = autocorr_multiplier
        self.rel_tol = rel_tol
        self.verbose = verbose
        self.time = 0
        self.old_tau = None

    def __call__(self, iter, last_sample, sampler):
        tau = sampler.backend.get_autocorr_time(multiply_thin=False)
        stop = False
        if self.time > 0:
            iteration = sampler.backend.iteration
            finish = []
            for name in tau:
                t = np.atleast_1d(tau[name]).astype(float).ravel()
                old = np.atleast_1d(self.old_tau[name]).astype(float).ravel()
                # a NaN tau (a leaf slot never active) carries no
                # information: judge on the finite entries
                good = np.isfinite(t) & np.isfinite(old)
                if not np.any(good):
                    finish.append(False)
                    continue
                t, old = t[good], old[good]
                converged = np.all(t * self.autocorr_multiplier < iteration)
                with np.errstate(invalid="ignore", divide="ignore"):
                    converged &= np.all(np.abs(old - t) / t < self.rel_tol)
                finish.append(bool(converged))
            stop = all(finish)
            if self.verbose:
                print(
                    "\ntau:", tau, "\nIteration:", iteration,
                    "\nAutocorrelation multiplier:", self.autocorr_multiplier,
                    "\nStopping:", stop, "\n",
                )
        self.old_tau = tau
        self.time += 1
        return stop
