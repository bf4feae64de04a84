"""Prior distributions and the :class:`ProbDistContainer`.

Port of :mod:`eryn_tpu.prior`, as far as the uniform distribution: its
``logpdf`` is batch-shaped torch, so the prior of the whole
``(ntemps, nwalkers, nleaves_max)`` ensemble is a few fused tensor ops, and
``rvs`` draws from the ``torch.Generator`` it is given.
"""

from __future__ import annotations

import math

import torch

__all__ = ["UniformDistribution", "uniform_dist", "ProbDistContainer"]


class UniformDistribution:
    """Uniform distribution on ``[min_val, max_val]``."""

    def __init__(self, min_val, max_val):
        if min_val > max_val:
            min_val, max_val = max_val, min_val
        elif min_val == max_val:
            raise ValueError("Min and max values are the same.")
        self.min_val = float(min_val)
        self.max_val = float(max_val)
        self.diff = self.max_val - self.min_val
        self.pdf_val = 1.0 / self.diff
        self.logpdf_val = math.log(self.pdf_val)

    def logpdf(self, x):
        in_range = (x >= self.min_val) & (x <= self.max_val)
        return torch.where(in_range, self.logpdf_val, -math.inf).to(x.dtype)

    def rvs(self, size=1, *, generator, dtype=torch.float64):
        """Draw ``size`` samples from ``generator`` (on its device)."""
        if isinstance(size, int):
            size = (size,)
        u = torch.rand(
            size, generator=generator, dtype=dtype, device=generator.device
        )
        return self.min_val + u * self.diff


def uniform_dist(min, max):
    """Build a :class:`UniformDistribution`."""
    return UniformDistribution(min, max)


class ProbDistContainer:
    """Maps parameter indices (int or named string keys) to scalar
    distributions.

    ``logpdf`` takes any leading batch shape ``(..., ndim)``.  When every
    parameter has a uniform prior (the common case, and the main path) the
    bounds are applied as one vector comparison.
    """

    def __init__(self, priors_in: dict):
        self.priors_in = dict(priors_in)
        self.priors = []
        key_order = []
        has_strings = has_ints = False
        for i, (key, dist) in enumerate(priors_in.items()):
            if isinstance(key, bool) or not isinstance(key, (int, str)):
                raise ValueError(
                    "Keys for the prior dictionary must be integers or "
                    "strings (tuple keys are not ported yet)."
                )
            if isinstance(key, str):
                if has_ints:
                    raise ValueError("Prior keys must all be ints or all strings.")
                has_strings = True
                key_order.append(key)
                index = i
            else:
                if has_strings:
                    raise ValueError("Prior keys must all be ints or all strings.")
                has_ints = True
                index = key
            self.priors.append((index, dist))
        indices = sorted(index for index, _ in self.priors)
        if indices != list(range(len(indices))):
            raise ValueError(
                "Please ensure all sampled parameters are included in priors, "
                "each exactly once."
            )
        self.ndim = len(indices)
        self.key_order = key_order if has_strings else list(range(self.ndim))
        self._uniform = all(
            isinstance(d, UniformDistribution) for _, d in self.priors
        )
        # bounds tensors per (device, dtype): building them from Python lists
        # in the hot path would be a host-to-device copy per evaluation
        self._bounds = {}

    def _uniform_bounds(self, like):
        key = (like.device, like.dtype)
        if key not in self._bounds:
            order = sorted(self.priors, key=lambda p: p[0])
            vals = [
                [d.min_val for _, d in order],
                [d.max_val for _, d in order],
                [d.logpdf_val for _, d in order],
            ]
            self._bounds[key] = torch.tensor(
                vals, dtype=like.dtype, device=like.device
            )
        return self._bounds[key]

    def logpdf(self, x):
        """Summed log prior over the last axis of ``x`` (``(..., ndim)``)."""
        if self._uniform:
            mins, maxs, logvals = self._uniform_bounds(x)
            in_range = (x >= mins) & (x <= maxs)
            return torch.where(in_range, logvals, -math.inf).sum(dim=-1)
        total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for index, dist in self.priors:
            total = total + dist.logpdf(x[..., index])
        return total

    def sample(self, generator, shape=(), dtype=torch.float32):
        """Draw ``shape + (ndim,)`` samples on the device of ``generator``,
        the counterpart of the JAX package's ``sample(key, shape)``.  For
        uniform priors it is one draw and one affine map, with no copy
        from the host."""
        if not self._uniform:
            return self.rvs(shape, generator=generator, dtype=dtype)
        u = torch.rand(tuple(shape) + (self.ndim,), generator=generator,
                       dtype=dtype, device=generator.device)
        mins, maxs, _ = self._uniform_bounds(u)
        return mins + u * (maxs - mins)

    def rvs(self, size=1, *, generator, dtype=torch.float64):
        """Draw ``size + (ndim,)`` samples from ``generator``."""
        if isinstance(size, int):
            size = (size,)
        out = torch.empty(
            tuple(size) + (self.ndim,), dtype=dtype, device=generator.device
        )
        for index, dist in self.priors:
            out[..., index] = dist.rvs(size, generator=generator, dtype=dtype)
        return out
