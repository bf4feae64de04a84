"""Prior distributions and the :class:`ProbDistContainer`.

Port of :mod:`eryn_tpu.prior`.  Every distribution's ``logpdf`` is
batch-shaped torch, so the prior of the whole ``(ntemps, nwalkers,
nleaves_max)`` ensemble is a few tensor ops; ``sample(generator, shape,
dtype)`` draws from the ``torch.Generator`` it is given, on that
generator's device (the counterpart of the JAX package's keyed
``sample(key, shape)``), and ``rvs`` is the same draw under Eryn's name.
``ppf`` takes host arrays (NumPy, float64) and tensors alike.

A distribution with a NumPy ``logpdf`` and no torch ``sample``, such as a
SciPy frozen distribution, is a host distribution: the container evaluates
it on a host copy of its columns and draws from it with a NumPy generator
seeded from the torch one, and reports ``host = True`` (a step that
evaluates it is never captured as a CUDA graph).
"""

from __future__ import annotations

import copy as _copy
import math

import numpy as np
import torch

__all__ = [
    "UniformDistribution",
    "MappedUniformDistribution",
    "LogUniformDistribution",
    "NormalDistribution",
    "MultivariateNormalDistribution",
    "uniform_dist",
    "log_uniform",
    "normal_dist",
    "mvn_dist",
    "ProbDistContainer",
]

_LOG_2PI = math.log(2.0 * math.pi)


def _rand(generator, shape, dtype):
    return torch.rand(tuple(shape), generator=generator, dtype=dtype,
                      device=generator.device)


def _shape(size):
    if isinstance(size, (int, np.integer)):
        return (int(size),)
    if not isinstance(size, tuple):
        raise ValueError("size must be an integer or tuple of ints.")
    return size


def _columns(x, inds):
    """``x[..., inds]`` (one index: the column without its axis) through
    views or a stack: an index tensor would be a copy from the host, which
    a captured step cannot hold."""
    if len(inds) == 1:
        return x[..., int(inds[0])]
    first = int(inds[0])
    if np.array_equal(inds, np.arange(first, first + len(inds))):
        return x[..., first:first + len(inds)]
    return torch.stack([x[..., int(i)] for i in inds], dim=-1)


def _is_host(dist):
    """A distribution without a torch ``sample``: its ``logpdf`` takes and
    returns NumPy arrays (a SciPy frozen distribution)."""
    return not hasattr(dist, "sample")


def _host_rvs(dist, generator, size, width, dtype):
    """``size`` draws (of ``width`` columns) of a host distribution from a
    ``numpy.random.RandomState`` seeded by one draw of ``generator``, as a
    tensor on the generator's device."""
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                             device=generator.device).item())
    vals = np.asarray(dist.rvs(size=size,
                               random_state=np.random.RandomState(seed)))
    shape = size if width == 1 else size + (width,)
    return torch.as_tensor(vals.reshape(shape), dtype=dtype,
                           device=generator.device)


class Distribution:
    """Base of the port's distributions: ``pdf``, ``rvs`` and ``copy`` from
    a subclass's ``logpdf`` and ``sample``."""

    #: number of parameters the distribution covers
    ndim = 1

    def pdf(self, x):
        return torch.exp(self.logpdf(x))

    def rvs(self, size=1, *, generator, dtype=torch.float64):
        """Draw ``size`` samples from ``generator`` (on its device)."""
        return self.sample(generator, _shape(size), dtype)

    def copy(self):
        return _copy.deepcopy(self)


class UniformDistribution(Distribution):
    """Uniform distribution on ``[min_val, max_val]``."""

    def __init__(self, min_val, max_val, use_cupy=False, return_gpu=False):
        # use_cupy and return_gpu are Eryn's; accepted and not used (a
        # tensor lies where it is made)
        if min_val > max_val:
            min_val, max_val = max_val, min_val
        elif min_val == max_val:
            raise ValueError("Min and max values are the same.")
        self.min_val = float(min_val)
        self.max_val = float(max_val)
        self.diff = self.max_val - self.min_val
        self.pdf_val = 1.0 / self.diff
        self.logpdf_val = math.log(self.pdf_val)

    def _in_range(self, x):
        return (x >= self.min_val) & (x <= self.max_val)

    # the values as tensors of x's dtype: a Python float in torch.where
    # would round them to float32
    def logpdf(self, x):
        return torch.where(self._in_range(x),
                           torch.full_like(x, self.logpdf_val), -math.inf)

    def pdf(self, x):
        return torch.where(self._in_range(x), torch.full_like(x, self.pdf_val),
                           0.0)

    def ppf(self, q):
        return self.min_val + q * self.diff

    def sample(self, generator, shape=(), dtype=torch.float32):
        return self.min_val + _rand(generator, shape, dtype) * self.diff


class MappedUniformDistribution(Distribution):
    """Uniform distribution whose log density is 0 inside ``[min, max]``."""

    def __init__(self, min, max, use_cupy=False, return_gpu=False):
        # use_cupy and return_gpu are Eryn's; accepted and not used
        if min > max:
            raise ValueError("min must be less than max.")
        self.min, self.max = float(min), float(max)
        self.diff = self.max - self.min

    def logpdf(self, x):
        temp = 1.0 - (self.max - x) / self.diff
        in_range = (temp >= 0.0) & (temp <= 1.0)
        return torch.where(in_range, 0.0, -math.inf).to(x.dtype)

    def sample(self, generator, shape=(), dtype=torch.float32):
        return self.max + (_rand(generator, shape, dtype) - 1.0) * self.diff


class LogUniformDistribution(Distribution):
    """Reciprocal (log-uniform) distribution on ``[min_val, max_val]``:
    ``pdf(x) = 1 / (x log(max / min))``.  The stated support, as
    :mod:`eryn_tpu` has it (Eryn's SciPy form shrinks it)."""

    def __init__(self, min_val, max_val):
        if min_val > max_val:
            min_val, max_val = max_val, min_val
        if min_val <= 0:
            raise ValueError("log-uniform requires positive support.")
        self.min_val = float(min_val)
        self.max_val = float(max_val)
        self._log_ratio = math.log(self.max_val / self.min_val)
        # the normalisation in float64 on the host, a constant of the op
        self._log_norm = math.log(self._log_ratio)

    def logpdf(self, x):
        in_range = (x >= self.min_val) & (x <= self.max_val)
        return torch.where(in_range, -torch.log(x) - self._log_norm,
                           -math.inf).to(x.dtype)

    def ppf(self, q):
        if isinstance(q, torch.Tensor):
            return self.min_val * torch.exp(q * self._log_ratio)
        return self.min_val * np.exp(np.asarray(q) * self._log_ratio)

    def sample(self, generator, shape=(), dtype=torch.float32):
        return self.ppf(_rand(generator, shape, dtype))


class NormalDistribution(Distribution):
    """Scalar normal distribution."""

    def __init__(self, loc=0.0, scale=1.0):
        self.loc = float(loc)
        self.scale = float(scale)
        self._log_scale = math.log(self.scale)

    def logpdf(self, x):
        z = (x - self.loc) / self.scale
        return -0.5 * z * z - self._log_scale - 0.5 * _LOG_2PI

    def ppf(self, q):
        if isinstance(q, torch.Tensor):
            return self.loc + self.scale * torch.special.ndtri(q)
        from scipy.special import ndtri

        return self.loc + self.scale * ndtri(q)

    def sample(self, generator, shape=(), dtype=torch.float32):
        z = torch.randn(tuple(shape), generator=generator, dtype=dtype,
                        device=generator.device)
        return self.loc + self.scale * z


class MultivariateNormalDistribution(Distribution):
    """Multivariate normal over a tuple prior key.  ``cov`` may be a
    matrix, a vector (its diagonal) or a scalar (times the identity).  The
    log density solves with the Cholesky factor and takes the log
    determinant from its diagonal."""

    def __init__(self, mean, cov, device="cpu"):
        mean = torch.as_tensor(np.asarray(mean, dtype=np.float64),
                               device=device)
        cov = torch.as_tensor(np.asarray(cov, dtype=np.float64), device=device)
        if cov.ndim == 0:
            cov = torch.eye(mean.shape[0], dtype=mean.dtype,
                            device=device) * cov
        elif cov.ndim == 1:
            cov = torch.diag(cov)
        self.mean, self.cov = mean, cov
        self.ndim = int(mean.shape[0])
        self._chol = torch.linalg.cholesky(cov)
        self._logdet = 2.0 * torch.log(torch.diagonal(self._chol)).sum()
        # (mean, factor, log determinant) per (device, dtype) of the input:
        # a copy from another device inside a captured step would fail
        self._consts = {}

    def _on(self, like):
        key = (like.device, like.dtype)
        if key not in self._consts:
            self._consts[key] = tuple(
                t.to(device=like.device, dtype=like.dtype)
                for t in (self.mean, self._chol, self._logdet))
        return self._consts[key]

    def logpdf(self, x):
        mean, chol, logdet = self._on(x)
        diff = (x - mean).unsqueeze(-1)
        y = torch.linalg.solve_triangular(chol, diff, upper=False)
        maha = (y.squeeze(-1) ** 2).sum(dim=-1)
        return -0.5 * (maha + self.ndim * _LOG_2PI + logdet)

    def sample(self, generator, shape=(), dtype=torch.float32):
        z = torch.randn(tuple(shape) + (self.ndim,), generator=generator,
                        dtype=dtype, device=generator.device)
        mean, chol, _ = self._on(z)
        return mean + z @ chol.T


def uniform_dist(min, max, use_cupy=False, return_gpu=False):
    """Build a :class:`UniformDistribution` (``use_cupy`` and
    ``return_gpu``, Eryn's, are accepted and not used)."""
    return UniformDistribution(min, max)


def log_uniform(min, max):
    """Build a :class:`LogUniformDistribution`."""
    return LogUniformDistribution(min, max)


def normal_dist(loc=0.0, scale=1.0):
    return NormalDistribution(loc, scale)


def mvn_dist(mean, cov, device="cpu"):
    return MultivariateNormalDistribution(mean, cov, device=device)


class ProbDistContainer:
    """Maps parameter indices to distributions: int keys, string keys
    (parameter names, in ``key_order``) or tuples of either (a joint
    distribution over several parameters).  Every parameter must be
    covered by exactly one key.

    ``logpdf`` takes any leading batch shape ``(..., ndim)``.  When every
    parameter has its own uniform prior (the common case, and the
    sampler's path) the bounds are applied as one vector comparison.
    ``host`` says whether a distribution is evaluated on the host (see
    the module).
    """

    def __init__(self, priors_in: dict, use_cupy=False, return_gpu=False):
        # use_cupy and return_gpu are Eryn's; accepted and not used
        self.priors_in = dict(priors_in)
        self.priors = []
        has_strings = has_ints = False
        current_ind = 0
        key_order = []

        def index_of(key):
            nonlocal has_strings, has_ints, current_ind
            if isinstance(key, str):
                if has_ints:
                    raise ValueError(
                        "Prior keys must all be ints or all strings.")
                has_strings = True
                key_order.append(key)
                index = current_ind
            elif isinstance(key, (int, np.integer)) and not isinstance(
                    key, (bool, np.bool_)):
                if has_strings:
                    raise ValueError(
                        "Prior keys must all be ints or all strings.")
                has_ints = True
                index = int(key)
            else:
                return None
            current_ind += 1
            return index

        for key, dist in priors_in.items():
            subkeys = key if isinstance(key, tuple) else (key,)
            inds = [index_of(k) for k in subkeys]
            if not subkeys or None in inds:
                raise ValueError(
                    "Keys for the prior dictionary must be an integer, a "
                    "string, or a tuple of either, all of one type.")
            if not hasattr(dist, "logpdf") or not (
                    hasattr(dist, "sample") or hasattr(dist, "rvs")):
                raise TypeError(
                    f"The distribution for {key!r} ({type(dist).__name__}) "
                    "has no logpdf, or neither sample nor rvs.")
            self.priors.append((np.asarray(inds), dist))

        all_inds = np.concatenate([inds for inds, _ in self.priors])
        uni_inds = np.unique(all_inds)
        if len(uni_inds) != uni_inds.max() + 1 or uni_inds.min() < 0:
            raise ValueError(
                "Please ensure all sampled parameters are included in priors."
            )
        if len(all_inds) != len(uni_inds):
            # an overlap would count the shared parameter twice
            raise ValueError(
                "Parameter indices overlap between priors; each sampled "
                "dimension must appear in exactly one prior."
            )
        self.ndim = int(uni_inds.max() + 1)
        self.has_strings, self.has_ints = has_strings, has_ints
        self.key_order = key_order if has_strings else list(range(self.ndim))
        self._uniform = len(self.priors) == self.ndim and all(
            isinstance(d, UniformDistribution) for _, d in self.priors)
        self.host = any(_is_host(d) for _, d in self.priors)
        # bounds tensors per (device, dtype): building them from Python lists
        # in the hot path would be a host-to-device copy per evaluation
        self._bounds = {}

    def _uniform_bounds(self, like):
        key = (like.device, like.dtype)
        if key not in self._bounds:
            vals = np.zeros((3, self.ndim))
            for inds, d in self.priors:
                vals[:, inds[0]] = d.min_val, d.max_val, d.logpdf_val
            self._bounds[key] = torch.tensor(
                vals, dtype=like.dtype, device=like.device
            )
        return self._bounds[key]

    @staticmethod
    def _selected(inds, keys):
        if keys is None:
            return True
        if len(inds) > 1:
            return tuple(int(i) for i in inds) in keys
        return int(inds[0]) in keys

    def logpdf(self, x, keys=None):
        """Summed log prior over the last axis of ``x`` (``(..., ndim)``);
        ``keys`` (parameter indices, tuples for joint blocks) restricts the
        sum to those priors."""
        x = torch.as_tensor(x)
        if self._uniform and keys is None:
            mins, maxs, logvals = self._uniform_bounds(x)
            in_range = (x >= mins) & (x <= maxs)
            return torch.where(in_range, logvals, -math.inf).sum(dim=-1)
        total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        x_host = None
        for inds, dist in self.priors:
            if not self._selected(inds, keys):
                continue
            if not _is_host(dist):
                total = total + dist.logpdf(_columns(x, inds))
                continue
            if x_host is None:  # one copy to the host for every host prior
                x_host = x.detach().cpu().numpy()
            cols = x_host[..., inds[0]] if len(inds) == 1 else x_host[..., inds]
            lp = np.asarray(dist.logpdf(cols), dtype=np.float64)
            total = total + torch.as_tensor(
                lp.reshape(x.shape[:-1]), dtype=x.dtype, device=x.device)
        return total

    def ppf(self, x, keys=None):
        """Per-parameter quantile function on host arrays: ``x`` of shape
        ``(..., ndim)`` (or ``(...)`` with one key selected) in [0, 1],
        each selected column mapped through its distribution's ``ppf``;
        float64 NumPy out.  A joint (tuple-key) block has no coordinate-wise
        quantile function and raises."""
        x = np.asarray(x)
        if keys is not None:
            keys = list(keys)
        single = x.ndim == 0 or (
            keys is not None and len(keys) == 1
            and x.shape[-1:] != (self.ndim,)
        )
        vals = np.array(x, dtype=np.float64, ndmin=1)
        out = np.array(vals, copy=True)
        for inds, dist in self.priors:
            if not self._selected(inds, keys):
                continue
            if len(inds) > 1:
                raise ValueError(
                    "ppf is per-parameter; the multivariate distribution "
                    f"over indices {tuple(inds)} has no coordinate-wise "
                    "quantile function."
                )
            if not hasattr(dist, "ppf"):
                raise TypeError(f"Distribution for index {inds[0]} has no ppf.")
            res = np.asarray(dist.ppf(vals if single else vals[..., inds[0]]))
            if single:
                out = res
            else:
                out[..., inds[0]] = res
        return out

    def rvs_stratified(self, size=1, seed=None):
        """Latin-hypercube prior draw: each parameter's N samples fill its
        N equal-probability quantile strata once each (one uniform jitter
        per stratum, strata permuted independently per parameter), drawn
        from ``numpy.random.default_rng(seed)`` as :mod:`eryn_tpu` draws
        them, so one seed gives both packages the same strata.  A joint
        block, or a distribution without ``ppf``, takes iid draws from a
        CPU generator seeded from the same stream.  Returns a float64 NumPy
        array ``size + (ndim,)``."""
        size = _shape(size)
        n = int(np.prod(size))
        rng = np.random.default_rng(
            seed if seed is not None else np.random.randint(0, 2**31 - 1)
        )
        out = np.empty((n, self.ndim), dtype=np.float64)
        for inds, dist in self.priors:
            if len(inds) > 1 or not hasattr(dist, "ppf"):
                gen = torch.Generator().manual_seed(
                    int(rng.integers(0, 2**31 - 1)))
                draws = (_host_rvs(dist, gen, (n,), len(inds), torch.float64)
                         if _is_host(dist)
                         else dist.sample(gen, (n,), torch.float64))
                out[:, list(inds)] = draws.cpu().numpy().reshape(n, len(inds))
                continue
            strata = (rng.permutation(n) + rng.uniform(size=n)) / n
            out[:, inds[0]] = np.asarray(dist.ppf(strata))
        return out.reshape(size + (self.ndim,))

    def rvs(self, size=1, keys=None, *, generator=None, dtype=torch.float64):
        """Draw ``size + (ndim,)`` samples from ``generator`` (on its
        device); with ``keys``, only those priors' columns (the rest are
        zero).  Without a generator (Eryn's call) the draw is on the CPU,
        from a generator seeded from NumPy's global one, as
        :meth:`rvs_stratified` seeds itself."""
        if generator is None:
            generator = torch.Generator().manual_seed(
                int(np.random.randint(0, 2**31 - 1)))
        size = _shape(size)
        out = torch.zeros(
            size + (self.ndim,), dtype=dtype, device=generator.device
        )
        for inds, dist in self.priors:
            if not self._selected(inds, keys):
                continue
            if _is_host(dist):
                vals = _host_rvs(dist, generator, size, len(inds), dtype)
            else:
                vals = dist.sample(generator, size, dtype)
            if len(inds) == 1:
                out[..., int(inds[0])] = vals
            else:
                for j, i in enumerate(inds):
                    out[..., int(i)] = vals[..., j]
        return out

    def sample(self, generator, shape=(), dtype=torch.float32):
        """Draw ``shape + (ndim,)`` samples on the device of ``generator``,
        the counterpart of the JAX package's ``sample(key, shape)``.  For
        uniform priors it is one draw and one affine map, with no copy
        from the host."""
        if not self._uniform:
            return self.rvs(tuple(shape), generator=generator, dtype=dtype)
        u = _rand(generator, tuple(shape) + (self.ndim,), dtype)
        mins, maxs, _ = self._uniform_bounds(u)
        return mins + u * (maxs - mins)
