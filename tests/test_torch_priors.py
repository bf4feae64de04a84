"""The port's prior family against eryn_tpu's on the CPU.

Every distribution's ``logpdf``, ``pdf`` and ``ppf``, and containers with
int, string and tuple keys (``logpdf`` with and without ``keys``, ``ppf``),
within 1e-12 in float64 of eryn_tpu's on the same numpy inputs (eryn_tpu
under ``jax.enable_x64``); float32 containers within 1e-6 relative, ``-inf``
in the same places.  ``rvs_stratified`` draws the same strata as eryn_tpu
for one seed (1e-12; the tuple-key blocks come from each package's own
generator).  The constructors' ``ValueError``s; a SciPy object's logpdf,
evaluated on the host, equals SciPy's; ``groups_from_inds`` exactly.
"""

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import jax.numpy as jnp

import eryn_tpu.prior as jp
import eryn_tpu_torch.prior as tp
from eryn_tpu.utils.utility import groups_from_inds as jax_groups
from eryn_tpu.utils.utility import groups_from_inds_jax
from eryn_tpu_torch.interop import priors_from_spec
from eryn_tpu_torch.utils.utility import (
    groups_from_inds,
    groups_from_inds_torch,
)

torch.set_num_threads(1)

MEAN = np.array([0.5, -1.0])
COV = np.array([[2.0, 0.3], [0.3, 0.5]])

# name: (constructor name, params, points)
DISTS = {
    "uniform": ("uniform_dist", (-2.0, 3.0), [-3.0, -2.0, 0.0, 2.9, 3.0, 3.1]),
    "mapped": ("MappedUniformDistribution", (2.0, 6.0),
               [1.0, 2.0, 2.5, 6.0, 7.0]),
    "log_uniform": ("log_uniform", (0.1, 10.0),
                    [-1.0, 0.0, 0.05, 0.1, 0.5, 5.0, 10.0, 20.0]),
    "normal": ("normal_dist", (0.7, 2.5), [-40.0, -1.0, 0.0, 0.7, 3.0, 12.0]),
}


def _both(kind, params):
    # eryn_tpu's constants take the dtype of their construction
    with jax.enable_x64(True):
        return getattr(jp, kind)(*params), getattr(tp, kind)(*params)


@pytest.mark.parametrize("name", sorted(DISTS))
def test_distribution_matches_jax_in_float64(name):
    kind, params, points = DISTS[name]
    jd, td = _both(kind, params)
    x = np.asarray(points, dtype=np.float64)
    with jax.enable_x64(True):
        want_lp = np.asarray(jd.logpdf(jnp.asarray(x)))
        want_pdf = np.asarray(jd.pdf(jnp.asarray(x)))
    got_lp = td.logpdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got_lp, want_lp, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.isneginf(got_lp), np.isneginf(want_lp))
    np.testing.assert_allclose(td.pdf(torch.from_numpy(x)).numpy(), want_pdf,
                               rtol=0, atol=1e-12)
    if hasattr(jd, "ppf"):
        q = np.array([1e-9, 0.01, 0.25, 0.5, 0.9, 1.0 - 1e-9])
        want = np.asarray(jd.ppf(q))
        np.testing.assert_allclose(td.ppf(q), want, rtol=1e-12, atol=1e-12)
        # a tensor takes the tensor path (torch.special.ndtri for the normal)
        np.testing.assert_allclose(td.ppf(torch.from_numpy(q)).numpy(), want,
                                   rtol=1e-12, atol=1e-12)
    else:
        assert not hasattr(td, "ppf")
    # the draws lie in the support and are the generator's
    g = torch.Generator().manual_seed(0)
    draws = td.rvs(size=(500,), generator=g)
    assert draws.shape == (500,) and draws.dtype == torch.float64
    assert torch.isfinite(td.logpdf(draws)).all()
    assert torch.equal(draws, td.rvs(500, generator=torch.Generator()
                                     .manual_seed(0)))
    assert td.copy() is not td and type(td.copy()) is type(td)


def test_log_uniform_keeps_the_stated_support():
    d = tp.log_uniform(0.1, 10.0)
    x = torch.tensor([0.1, 5.0, 9.99, 10.0], dtype=torch.float64)
    np.testing.assert_allclose(
        d.logpdf(x).numpy(), scipy.stats.loguniform(0.1, 10.0).logpdf(x.numpy()),
        rtol=1e-12)
    with pytest.raises(ValueError):
        tp.log_uniform(0.0, 1.0)


def test_multivariate_normal_matches_jax_and_scipy():
    jd, td = _both("mvn_dist", (MEAN, COV))
    x = np.random.default_rng(1).standard_normal((4, 7, 2)) * 2.0
    with jax.enable_x64(True):
        want = np.asarray(jd.logpdf(jnp.asarray(x)))
    got = td.logpdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        got, scipy.stats.multivariate_normal(MEAN, COV).logpdf(x), atol=1e-12)
    # a scalar or a vector covariance
    for cov in (1.7, np.array([0.5, 2.0])):
        with jax.enable_x64(True):
            want = np.asarray(jp.mvn_dist(MEAN, cov).logpdf(jnp.asarray(x)))
        np.testing.assert_allclose(
            tp.mvn_dist(MEAN, cov).logpdf(torch.from_numpy(x)).numpy(), want,
            rtol=0, atol=1e-12)
    draws = td.rvs(size=(20000,), generator=torch.Generator().manual_seed(2))
    assert draws.shape == (20000, 2)
    np.testing.assert_allclose(draws.mean(0).numpy(), MEAN, atol=0.05)
    np.testing.assert_allclose(np.cov(draws.numpy().T), COV, atol=0.08)


# the containers of the tests, as specs both packages build from
SPECS = {
    "ints": {0: ("uniform_dist", (-1.0, 1.0)), 1: ("log_uniform", (0.1, 10.0)),
             2: ("normal_dist", (0.0, 2.0))},
    "strings": {"a": ("normal_dist", (1.0, 0.5)),
                "b": ("uniform_dist", (0.0, 4.0)),
                "c": ("MappedUniformDistribution", (-3.0, 3.0))},
    "tuple": {(0, 2): ("mvn_dist", (MEAN, COV)),
              1: ("log_uniform", (0.5, 50.0)),
              3: ("uniform_dist", (-2.0, 2.0))},
    "string tuple": {("x", "y"): ("mvn_dist", (MEAN, COV)),
                     "z": ("normal_dist", (0.0, 1.0))},
    "all uniform": {i: ("uniform_dist", (-1.0 - i, 2.0 + i)) for i in range(4)},
}


def _jax_container(spec, x64=True):
    with jax.enable_x64(x64):
        return jp.ProbDistContainer({k: getattr(jp, kind)(*params)
                                     for k, (kind, params) in spec.items()})


def _points(ndim, shape=(3, 5), seed=0):
    return np.random.default_rng(seed).uniform(-4, 6, shape + (ndim,))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_container_logpdf_matches_jax(name):
    spec = SPECS[name]
    jc, tc = _jax_container(spec), priors_from_spec(spec, device="cpu")
    assert tc.ndim == jc.ndim and list(tc.key_order) == list(jc.key_order)
    x = _points(tc.ndim)
    with jax.enable_x64(True):
        want = np.asarray(jc.logpdf(jnp.asarray(x)))
    got = tc.logpdf(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    # keys restrict the sum: every key alone (eryn_tpu's container cannot
    # select a tuple key, so a joint block is held to its distribution)
    for inds, dist in jc.priors:
        with jax.enable_x64(True):
            if len(inds) > 1:
                key = [tuple(int(i) for i in inds)]
                want = np.asarray(dist.logpdf(jnp.asarray(x[..., inds])))
            else:
                key = [int(inds[0])]
                want = np.asarray(jc.logpdf(jnp.asarray(x), keys=key))
        np.testing.assert_allclose(
            tc.logpdf(torch.from_numpy(x), keys=key).numpy(), want, rtol=0,
            atol=1e-12)


@pytest.mark.parametrize("name", ["ints", "all uniform"])
def test_float32_container_matches_jax(name):
    spec = SPECS[name]
    jc = _jax_container(spec, x64=False)
    tc = priors_from_spec(spec, device="cpu")
    x = _points(tc.ndim, (4, 7, 2)).astype(np.float32)
    want = np.asarray(jc.logpdf(jnp.asarray(x)))
    got = tc.logpdf(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.isneginf(got.numpy()), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got.numpy()[fin], want[fin], rtol=1e-6)
    # the fused uniform path is the all-uniform container's
    assert tc._uniform == (name == "all uniform")


@pytest.mark.parametrize("name", ["ints", "strings", "all uniform"])
def test_container_ppf_matches_jax(name):
    spec = SPECS[name]
    jc, tc = _jax_container(spec), priors_from_spec(spec, device="cpu")
    q = np.random.default_rng(4).random((6, tc.ndim))
    if name == "strings":  # the mapped uniform has no ppf, in both
        with pytest.raises(TypeError):
            tc.ppf(q)
        with pytest.raises(TypeError):
            jc.ppf(q)
        keys = [0, 1]
    else:
        keys = None
    np.testing.assert_allclose(tc.ppf(q, keys=keys), jc.ppf(q, keys=keys),
                               rtol=1e-12, atol=1e-12)
    # one key on its own column
    np.testing.assert_allclose(tc.ppf(q[:, 1], keys=[1]),
                               jc.ppf(q[:, 1], keys=[1]), rtol=1e-12)


def test_container_ppf_refuses_a_joint_block():
    tc = priors_from_spec(SPECS["tuple"], device="cpu")
    with pytest.raises(ValueError, match="multivariate"):
        tc.ppf(np.full((2, 4), 0.5))


@pytest.mark.parametrize("name", sorted(SPECS))
def test_rvs_stratified_draws_jax_strata(name):
    spec = SPECS[name]
    jc, tc = _jax_container(spec), priors_from_spec(spec, device="cpu")
    with jax.enable_x64(True):
        want = jc.rvs_stratified((40, 3), seed=123)
    got = tc.rvs_stratified((40, 3), seed=123)
    assert got.shape == want.shape == (40, 3, tc.ndim)
    for inds, dist in tc.priors:
        cols = list(inds)
        if len(inds) == 1 and hasattr(dist, "ppf"):
            np.testing.assert_allclose(got[..., cols], want[..., cols],
                                       rtol=1e-12, atol=1e-12)
            # one draw in each of the 120 strata
            strata = np.sort(np.floor(
                _cdf(dist, got[..., cols[0]].ravel()) * 120).astype(int))
            np.testing.assert_array_equal(strata, np.arange(120))
    assert np.all(np.isfinite(tc.logpdf(torch.from_numpy(got)).numpy()))


def _cdf(dist, x):
    if isinstance(dist, tp.UniformDistribution):
        return (x - dist.min_val) / dist.diff
    if isinstance(dist, tp.LogUniformDistribution):
        return np.log(x / dist.min_val) / dist._log_ratio
    return scipy.stats.norm(dist.loc, dist.scale).cdf(x)


def test_container_rvs_fills_the_keys_it_is_given():
    tc = priors_from_spec(SPECS["tuple"], device="cpu")
    g = torch.Generator().manual_seed(3)
    x = tc.rvs(size=(50, 2), generator=g)
    assert x.shape == (50, 2, 4) and x.dtype == torch.float64
    assert torch.isfinite(tc.logpdf(x)).all()
    y = tc.rvs(size=8, keys=[1], generator=g, dtype=torch.float32)
    assert y.dtype == torch.float32
    assert (y[:, [0, 2, 3]] == 0).all() and (y[:, 1] >= 0.5).all()
    z = tc.sample(torch.Generator().manual_seed(3), (50, 2),
                  dtype=torch.float64)
    assert torch.equal(z, x)


def test_constructor_errors():
    u = tp.uniform_dist(0.0, 1.0)
    with pytest.raises(ValueError, match="all sampled parameters"):
        tp.ProbDistContainer({0: u, 2: u})
    with pytest.raises(ValueError, match="overlap"):
        tp.ProbDistContainer({(0, 1): tp.mvn_dist(MEAN, COV), 1: u})
    with pytest.raises(ValueError):
        tp.ProbDistContainer({0.5: u})
    with pytest.raises(ValueError):
        tp.ProbDistContainer({0: u, "a": u})
    with pytest.raises(ValueError):
        tp.ProbDistContainer({(0, "a"): tp.mvn_dist(MEAN, COV)})
    with pytest.raises(ValueError):
        tp.uniform_dist(1.0, 1.0)
    with pytest.raises(ValueError):
        tp.MappedUniformDistribution(2.0, 1.0)
    with pytest.raises(ValueError, match="Unknown prior kind"):
        priors_from_spec({0: ("beta", (1, 2))}, device="cpu")
    # eryn_tpu raises the same ValueErrors
    with pytest.raises(ValueError, match="all sampled parameters"):
        jp.ProbDistContainer({0: jp.uniform_dist(0, 1),
                              2: jp.uniform_dist(0, 1)})
    with pytest.raises(ValueError, match="overlap"):
        jp.ProbDistContainer({(0, 1): jp.mvn_dist(MEAN, COV),
                              1: jp.uniform_dist(0, 1)})


def test_a_scipy_distribution_is_evaluated_on_the_host():
    """A SciPy frozen distribution is a host distribution: the container's
    logpdf of its column is SciPy's, beside a torch one."""
    c = tp.ProbDistContainer({0: scipy.stats.norm(0.5, 2.0),
                              1: tp.uniform_dist(-1.0, 1.0)})
    assert c.host
    x = np.random.default_rng(1).uniform(-2, 2, (4, 5, 2))
    want = scipy.stats.norm(0.5, 2.0).logpdf(x[..., 0]) + np.where(
        np.abs(x[..., 1]) <= 1.0, np.log(0.5), -np.inf)
    np.testing.assert_allclose(c.logpdf(torch.as_tensor(x)).numpy(), want,
                               rtol=1e-12)


def test_groups_from_inds_matches_jax():
    inds = {"a": np.random.default_rng(0).random((3, 5, 4)) < 0.4,
            "b": np.ones((3, 5, 1), bool)}
    got, want = groups_from_inds(inds), jax_groups(inds)
    for k in inds:
        np.testing.assert_array_equal(got[k], want[k])
    got = groups_from_inds({k: torch.from_numpy(v) for k, v in inds.items()})
    np.testing.assert_array_equal(got["a"], want["a"])
    flat = inds["a"].reshape(-1, 4)
    np.testing.assert_array_equal(
        groups_from_inds_torch(torch.from_numpy(flat)).numpy(),
        np.asarray(groups_from_inds_jax(jnp.asarray(flat))))


def test_sampler_draws_a_non_uniform_prior():
    """A flat likelihood under ``{(0, 1): mvn, 2: normal}`` priors: the cold
    chain samples the prior (mean within 0.15, covariance within 0.3 over
    400 x 32 draws with an IACT near 10); the start comes from
    ``rvs_stratified``."""
    import eryn_tpu_torch as et

    priors = priors_from_spec({(0, 1): ("mvn_dist", (MEAN, COV)),
                               2: ("normal_dist", (1.0, 0.5))}, device="cpu")
    s = et.EnsembleSampler(32, 3, lambda x: torch.zeros((), dtype=x.dtype),
                           priors, tempering_kwargs=dict(ntemps=2), seed=1,
                           device="cpu", dtype=torch.float64)
    s.run_mcmc(priors.rvs_stratified((2, 32), seed=0), 400, burn=100)
    x = s.get_chain()["model_0"][:, 0].reshape(-1, 3)
    np.testing.assert_allclose(x.mean(0), [*MEAN, 1.0], atol=0.15)
    want = np.zeros((3, 3))
    want[:2, :2], want[2, 2] = COV, 0.25
    np.testing.assert_allclose(np.cov(x.T), want, atol=0.3)
