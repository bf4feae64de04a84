"""The likelihood's arguments under reversible jump with one leaf, against
eryn_tpu.

With one branch and ``nleaves_max=1`` the leaf can still be switched off
when reversible jump is on, so the function takes ``(coords (1, ndim),
inds (1,))`` per walker, as ``eryn_tpu.ensemble.LikelihoodEvaluator`` hands
it (``eryn_tpu/ensemble.py:245-250``); without reversible jump it takes the
coordinates ``(ndim,)`` alone.  The configuration is the one-pulse search of
``tests/test_parity_reference.py::test_rj_matches_quadrature_truth``, cut to
16 walkers.

Tolerance: the log-likelihoods of one float64 batch agree within rtol 1e-6
(the two libraries sum the 64-point template in another order).
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import eryn_tpu.ensemble
import eryn_tpu_torch
from eryn_tpu_torch.ensemble import LikelihoodEvaluator

torch.set_num_threads(1)

SIGMA = 0.5
BOUNDS = [(0.2, 3.0), (0.0, 10.0), (0.3, 1.5)]


def _data():
    rng = np.random.default_rng(3)
    t = np.linspace(0, 10, 64)
    data = 0.32 * np.exp(-((t - 5.0) ** 2) / (2 * 0.7**2))
    data = data + SIGMA * rng.standard_normal(len(t))
    return t, data, float(-0.5 * np.sum((data / SIGMA) ** 2))


def _pulse_ll(xp, t, data, seen=None):
    """The pulse likelihood of one walker, ``(coords (1, 3), inds (1,))``,
    in ``xp`` (torch or jax.numpy); ``seen`` collects the argument shapes."""
    def ll(c, m):
        if seen is not None:
            seen.append((tuple(c.shape), tuple(m.shape)))
        a, b, w = c[:, 0], c[:, 1], c[:, 2]
        p = a[:, None] * xp.exp(-((t[None] - b[:, None]) ** 2)
                                / (2 * w[:, None] ** 2))
        tm = xp.sum(xp.where(m[:, None], p, 0.0), axis=0)
        return -0.5 * xp.sum(((tm - data) / SIGMA) ** 2)
    return ll


def _batch(nt=2, nw=16, seed=0):
    rng = np.random.default_rng(seed)
    lo, hi = np.array(BOUNDS).T
    coords = lo + (hi - lo) * rng.random((nt, nw, 1, 3))
    inds = rng.random((nt, nw, 1)) < 0.5
    logp = np.zeros((nt, nw))
    logp[0, 3] = -np.inf  # outside the prior support: never evaluated
    return coords, inds, logp


def test_one_leaf_rj_likelihood_takes_coords_and_inds():
    t, data, noise_ll = _data()
    seen = []
    ev = LikelihoodEvaluator(
        _pulse_ll(torch, torch.from_numpy(t), torch.from_numpy(data), seen),
        branch_names=["model_0"], ndims={"model_0": 3},
        nleaves_max={"model_0": 1}, args=None, kwargs=None, vectorize=False,
        fill_zero_leaves_val=noise_ll, dtype=torch.float64, rj=True,
    )
    ev.check(torch.device("cpu"))
    assert seen and set(seen) == {((1, 3), (1,))}


def test_one_leaf_rj_likelihood_matches_jax():
    t, data, noise_ll = _data()
    coords, inds, logp = _batch()
    port = LikelihoodEvaluator(
        _pulse_ll(torch, torch.from_numpy(t), torch.from_numpy(data)),
        branch_names=["model_0"], ndims={"model_0": 3},
        nleaves_max={"model_0": 1}, args=None, kwargs=None, vectorize=False,
        fill_zero_leaves_val=noise_ll, dtype=torch.float64, rj=True,
    )
    got, _ = port({"model_0": torch.from_numpy(coords)},
                  {"model_0": torch.from_numpy(inds)}, torch.from_numpy(logp))
    with jax.enable_x64(True):
        ref = eryn_tpu.ensemble.LikelihoodEvaluator(
            _pulse_ll(jnp, jnp.asarray(t), jnp.asarray(data)),
            branch_names=["model_0"], ndims={"model_0": 3},
            nleaves_max={"model_0": 1}, nleaves_min={"model_0": 0},
            args=None, kwargs=None, vectorize=False, provide_groups=False,
            provide_supplemental=False, fill_zero_leaves_val=noise_ll,
            rj=True, dtype=jnp.float64,
        )
        want, _ = ref({"model_0": jnp.asarray(coords)},
                      {"model_0": jnp.asarray(inds)}, jnp.asarray(logp))
        want = np.asarray(want)
    assert got.dtype == torch.float64 and want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # walkers with the leaf off read the noise likelihood, with it on the
    # pulse; the one outside the support -inf
    assert got[0, 3] == -np.inf
    off = ~inds[..., 0] & np.isfinite(logp)
    assert off.any() and np.all(got.numpy()[off] == noise_ll)
    assert np.all(got.numpy()[inds[..., 0] & np.isfinite(logp)] != noise_ll)


def test_one_leaf_rj_sampler_runs():
    t, data, noise_ll = _data()
    priors = eryn_tpu_torch.ProbDistContainer(
        {i: eryn_tpu_torch.uniform_dist(*BOUNDS[i]) for i in range(3)})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # the plain stretch
        ens = eryn_tpu_torch.EnsembleSampler(
            16, 3, _pulse_ll(torch, torch.from_numpy(t).float(),
                             torch.from_numpy(data).float()),
            priors, nleaves_max=1, nleaves_min=0, rj_moves=True,
            fill_zero_leaves_val=noise_ll, seed=123, device="cpu",
        )
    coords, inds, _ = _batch(nt=1)
    ens.run_mcmc(eryn_tpu_torch.State({"model_0": coords},
                                      inds={"model_0": inds}), 40)
    k = ens.get_nleaves()["model_0"]
    assert k.shape == (40, 1, 16)
    assert set(np.unique(k)) == {0, 1}
    assert np.all(np.isfinite(ens.get_log_like()))
    assert 0 < ens.rj_acceptance_fraction.mean() < 1
