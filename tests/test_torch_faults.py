"""Calls that run in ``eryn_tpu`` and ran wrongly or not at all in the port,
each made the same way in both packages on the same arrays (made with
numpy).

1. ``get_acf(x, axis=0, fast=False)`` and ``get_integrated_act(x, axis=0,
   window=50, fast=False, ...)``: a positional call, ``fast=True``, a
   refused ``axis``, and ``get_autocorr_time(fast=True)`` on ``Backend``,
   ``DeviceBackend`` and ``HDFBackend``.
2. ``compute_log_prior(coords, inds, supps=, branch_supps=)``,
   ``sampler.reset(**info)``, ``backend.reset(..., nbranches=)`` and the
   ``reset_args`` / ``reset_kwargs`` properties.
3. ``ProbDistContainer.rvs(size)`` without a generator, and the README's
   batched snippet at a small size.
4. ``StretchMove.adjust_factors``, ``GroupMove.choose_c_vals``,
   ``Move.compute_log_posterior_tempered``, ``Move.accepted_hist``,
   ``legacy.is_legacy_move``, ``hdfbackend.does_hdf5_support_longdouble``,
   the priors' ``use_cupy`` / ``return_gpu`` and ``PeriodicContainer``'s
   ``xp``.

Tolerances: the host IACT is the same NumPy arithmetic in both packages
(``rtol=1e-12``); the port's device IACT runs torch's float64 FFT
(``rtol=1e-9``, as the backends' agreement elsewhere).  Where
``eryn_tpu`` computes with ``jax.numpy`` (the tempered posterior, the
priors, the periodic maps) it does so in JAX's default float32
(``rtol=1e-6``); the port's float64 values are compared to those.
"""

import numpy as np
import pytest
import torch

import eryn_tpu_torch as et
import eryn_tpu_torch.utils.utility as tu


def _ar_chain(shape, seed=0, rho=0.9):
    """An AR(1) series along axis 0 of ``shape``: a known, long IACT."""
    rng = np.random.default_rng(seed)
    e = rng.standard_normal(shape)
    x = np.empty(shape)
    x[0] = e[0]
    for t in range(1, shape[0]):
        x[t] = rho * x[t - 1] + e[t]
    return x


# ----------------------------------------------------------------------
# 1. the IACT's signatures
# ----------------------------------------------------------------------
def test_integrated_act_takes_eryns_signature():
    """``{"m": x}`` with ``x`` ``(2000, 3, 8, 1, 2)``: the positional call
    ``get_integrated_act(d, 0, 50)`` (axis, window) gives ``eryn_tpu``'s
    taus, as the keyword call does; ``fast=True`` and ``get_acf(x,
    fast=True)`` equal ``eryn_tpu``'s and differ from the full length's;
    ``axis=1`` is refused in both."""
    import eryn_tpu.utils.utility as ju

    x = _ar_chain((2000, 3, 8, 1, 2))
    d = {"m": x}
    got = tu.get_integrated_act(d, 0, 50)["m"]
    ref = ju.get_integrated_act(d, 0, 50)["m"]
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(got, tu.get_integrated_act(d, window=50)["m"],
                               rtol=1e-12)
    assert np.all(got > 5.0)  # rho = 0.9: tau near 19, not the 1.0 of old
    fast = tu.get_integrated_act(d, fast=True)["m"]
    np.testing.assert_allclose(fast, ju.get_integrated_act(d, fast=True)["m"],
                               rtol=1e-12)
    assert not np.allclose(fast, got)
    np.testing.assert_allclose(tu.get_acf(x[:, 0, 0, 0, 0], fast=True),
                               ju.get_acf(x[:, 0, 0, 0, 0], fast=True),
                               rtol=1e-12, atol=1e-15)
    assert tu.get_acf(x[:, 0, 0, 0, 0], fast=True).shape == (1024,)
    for mod in (tu, ju):
        with pytest.raises(NotImplementedError):
            mod.get_integrated_act(d, axis=1)


def _gaussian_sampler(pkg, nsteps, backend, **kw):
    """2 x 16 on a 3-D unit Gaussian, ``nsteps`` stored steps."""
    if pkg is et:
        like = (lambda x: -0.5 * torch.sum(x * x))
        kw.setdefault("device", "cpu")
    else:
        import jax.numpy as jnp

        like = (lambda x: -0.5 * jnp.sum(x * x))
    priors = pkg.ProbDistContainer({i: pkg.uniform_dist(-5.0, 5.0)
                                    for i in range(3)})
    s = pkg.EnsembleSampler(16, 3, like, priors,
                            tempering_kwargs=dict(ntemps=2), backend=backend,
                            seed=3, **kw)
    start = np.random.default_rng(1).uniform(-1, 1, (2, 16, 3))
    s.run_mcmc(start, nsteps, progress=False)
    return s


def _backend(pkg, kind, path):
    if kind == "hdf":
        return pkg.backends.HDFBackend(str(path / f"{pkg.__name__}.h5"))
    return {"host": pkg.backends.Backend,
            "device": pkg.backends.DeviceBackend}[kind]()


@pytest.mark.parametrize("kind", ["host", "device", "hdf"])
def test_autocorr_time_fast_on_every_backend(kind, tmp_path):
    """``get_autocorr_time(fast=True)`` runs on each backend of both
    packages; the port's taus are ``eryn_tpu``'s function on the same
    stored chain (the first 64 of 100 steps, a window of 10), and differ
    from the full length's."""
    import eryn_tpu
    import eryn_tpu.utils.utility as ju

    s = _gaussian_sampler(et, 100, _backend(et, kind, tmp_path))
    got = s.get_autocorr_time(fast=True, window=10)["model_0"]
    cold = s.get_chain(temp_index=0)["model_0"]
    ref = ju.get_integrated_act({"m": cold[:, None]}, fast=True,
                                window=10)["m"]
    rtol = 1e-9 if kind == "device" else 1e-12
    np.testing.assert_allclose(got, ref, rtol=rtol)
    assert np.all(got > 0.5)
    assert not np.allclose(got, s.get_autocorr_time(window=10)["model_0"])
    js = _gaussian_sampler(eryn_tpu, 100, _backend(eryn_tpu, kind, tmp_path))
    assert js.get_autocorr_time(fast=True,
                                window=10)["model_0"].shape == got.shape


# ----------------------------------------------------------------------
# 2. the sampler's and backends' Eryn signatures
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["host", "device", "hdf"])
def test_eryn_signatures_of_sampler_and_backend(kind, tmp_path):
    """On the same 30-step run in both packages: ``compute_log_prior`` with
    ``supps`` and ``branch_supps`` gives the same values, ``reset(**info)``
    clears the chain, ``backend.reset(..., nbranches=2)`` names two
    branches, and ``reset_args`` / ``reset_kwargs`` agree (the same keys,
    the same values but the package's own move keys)."""
    import eryn_tpu

    runs = {pkg: _gaussian_sampler(pkg, 30, _backend(pkg, kind, tmp_path))
            for pkg in (et, eryn_tpu)}
    c = np.random.default_rng(2).uniform(-6, 6, (2, 16, 1, 3))
    lp = {pkg: np.asarray(torch.as_tensor(s.compute_log_prior(
              {"model_0": c}, supps=None, branch_supps=None)).cpu()
              if pkg is et else s.compute_log_prior(
              {"model_0": c}, supps=None, branch_supps=None))
          for pkg, s in runs.items()}
    np.testing.assert_allclose(lp[et], lp[eryn_tpu], rtol=1e-12)
    assert np.isinf(lp[et]).any() and np.isfinite(lp[et]).any()
    args, kwargs = {}, {}
    for pkg, s in runs.items():
        b = s.backend
        args[pkg], kwargs[pkg] = b.reset_args, b.reset_kwargs
        assert b.iteration == 30
        s.reset(note="Eryn's info")
        assert s.backend.iteration == 0
        b.reset(*b.reset_args, **b.reset_kwargs)
        assert b.iteration == 0
        b.reset(16, 3, nbranches=2)
        assert list(b.branch_names) == ["model_0", "model_1"]
    assert set(kwargs[et]) == set(kwargs[eryn_tpu])
    assert args[et] == args[eryn_tpu]
    for key in ("nleaves_max", "ntemps", "branch_names", "rj", "key_order"):
        assert kwargs[et][key] == kwargs[eryn_tpu][key], key


# ----------------------------------------------------------------------
# 3. rvs without a generator
# ----------------------------------------------------------------------
def test_rvs_without_a_generator():
    """``priors.rvs(size=(2, 16))`` draws in both packages: the same shape,
    inside the support, seeded from NumPy's global generator (the same
    seed gives the same draw)."""
    import eryn_tpu

    for pkg in (et, eryn_tpu):
        priors = pkg.ProbDistContainer({0: pkg.uniform_dist(0.0, 1.0),
                                        1: pkg.uniform_dist(-2.0, -1.0)})
        np.random.seed(4)
        a = np.asarray(priors.rvs(size=(2, 16)))
        np.random.seed(4)
        b = np.asarray(priors.rvs(size=(2, 16)))
        assert a.shape == (2, 16, 2)
        assert (a[..., 0] >= 0).all() and (a[..., 0] <= 1).all()
        assert (a[..., 1] >= -2).all() and (a[..., 1] <= -1).all()
        np.testing.assert_array_equal(a, b)


def test_readme_batched_snippet_runs():
    """The README's ``ParaEnsembleSampler`` snippet, at 4 groups of 2 x 16
    on the CPU: ``run_mcmc(priors.rvs(size=...), ...)`` takes the draw."""
    from eryn_tpu_torch.parallel import ParaEnsembleSampler

    priors = et.ProbDistContainer({i: et.uniform_dist(-5.0, 5.0)
                                   for i in range(3)})

    def log_like(x):
        return -0.5 * torch.sum(x * x)

    para = ParaEnsembleSampler(4, 16, 3, log_like, priors,
                               tempering_kwargs=dict(ntemps=2), seed=0,
                               device="cpu")
    para.run_mcmc(priors.rvs(size=(4, 2, 16)), 6, burn=2)
    chain = para.get_chain()["model_0"]
    assert chain.shape == (6, 4, 2, 16, 1, 3)
    assert np.isfinite(chain).all()


# ----------------------------------------------------------------------
# 4. the reference names and keywords
# ----------------------------------------------------------------------
def test_stretch_adjust_factors_and_tempered_posterior():
    """``StretchMove.adjust_factors`` and
    ``Move.compute_log_posterior_tempered`` (with and without a
    temperature control) give ``eryn_tpu``'s values."""
    import eryn_tpu

    f = np.random.default_rng(0).standard_normal((2, 8))
    logl = np.random.default_rng(1).standard_normal((3, 8))
    logp = np.random.default_rng(2).standard_normal((3, 8))
    betas = np.array([1.0, 0.5, 0.25])
    vals = {}
    for pkg in (et, eryn_tpu):
        m = pkg.moves.StretchMove()
        tc = pkg.moves.TemperatureControl(3, 8, betas=betas)
        tm = pkg.moves.StretchMove(temperature_control=tc)
        as_t = torch.as_tensor if pkg is et else np.asarray
        vals[pkg] = [np.asarray(v) for v in (
            m.adjust_factors(as_t(f), 5.0, 3.0),
            m.compute_log_posterior_tempered(as_t(logl), as_t(logp)),
            tm.compute_log_posterior_tempered(as_t(logl), as_t(logp),
                                              betas=as_t(betas)))]
    for a, b in zip(vals[et], vals[eryn_tpu]):
        np.testing.assert_allclose(a, b, rtol=1e-6)


def test_group_choose_c_vals_and_is_legacy_move():
    """``GroupMove.choose_c_vals`` is the user's ``find_friends`` in both
    packages, which makes the move a host move there: ``is_legacy_move``
    says so, and not of a native move."""
    import eryn_tpu
    from eryn_tpu.moves import legacy as jl

    from eryn_tpu_torch.moves import legacy as tl

    s = np.arange(6.0).reshape(1, 2, 1, 3)
    for pkg, legacy in ((et, tl), (eryn_tpu, jl)):
        class Friends(pkg.moves.GroupMove):
            def setup_friends(self, branches):
                pass

            def find_friends(self, name, s, s_inds=None, branch_supps=None):
                return np.asarray(s) + 1.0

        m = Friends()
        np.testing.assert_array_equal(m.choose_c_vals("model_0", s), s + 1.0)
        assert legacy.is_legacy_move(m)
        assert not legacy.is_legacy_move(pkg.moves.StretchMove())


def test_accepted_hist_is_the_accept_counts():
    """``Move.accepted_hist`` is the cumulative accept counts
    (``accepted``) after a run, in both packages."""
    import eryn_tpu

    for pkg in (et, eryn_tpu):
        s = _gaussian_sampler(pkg, 10, pkg.backends.Backend())
        move = s.moves[0]
        assert move.accepted_hist is not None
        np.testing.assert_array_equal(np.asarray(move.accepted_hist),
                                      np.asarray(move.accepted))


def test_hdf5_longdouble_probe_agrees():
    """``does_hdf5_support_longdouble`` answers alike in both packages."""
    from eryn_tpu.backends.hdfbackend import does_hdf5_support_longdouble as j

    from eryn_tpu_torch.backends.hdfbackend import (
        does_hdf5_support_longdouble as t,
    )

    assert t() == j()


def test_cupy_keywords_and_periodic_xp():
    """The priors take ``use_cupy`` and ``return_gpu`` and give
    ``eryn_tpu``'s log densities; ``PeriodicContainer.distance`` and
    ``.wrap`` take ``xp`` and give its values."""
    import eryn_tpu
    from eryn_tpu.prior import MappedUniformDistribution as JM
    from eryn_tpu.prior import UniformDistribution as JU
    from eryn_tpu.utils import PeriodicContainer as JP

    from eryn_tpu_torch.prior import MappedUniformDistribution as TM
    from eryn_tpu_torch.prior import UniformDistribution as TU
    from eryn_tpu_torch.utils import PeriodicContainer as TP

    x = np.linspace(-1.5, 2.5, 9)
    kw = dict(use_cupy=False, return_gpu=False)
    for t, j in ((TU(0.0, 1.0, **kw), JU(0.0, 1.0, **kw)),
                 (TM(0.0, 1.0, **kw), JM(0.0, 1.0, **kw)),
                 (et.uniform_dist(-1.0, 2.0, **kw),
                  eryn_tpu.uniform_dist(-1.0, 2.0, **kw))):
        np.testing.assert_allclose(np.asarray(t.logpdf(torch.as_tensor(x))),
                                   np.asarray(j.logpdf(x)), rtol=1e-6)
    pts = np.stack([x, x[::-1]], axis=-1)
    t = et.ProbDistContainer({0: et.uniform_dist(0.0, 1.0),
                              1: et.uniform_dist(0.0, 2.0)}, **kw)
    j = eryn_tpu.ProbDistContainer({0: eryn_tpu.uniform_dist(0.0, 1.0),
                                    1: eryn_tpu.uniform_dist(0.0, 2.0)},
                                   **kw)
    np.testing.assert_allclose(np.asarray(t.logpdf(torch.as_tensor(pts))),
                               np.asarray(j.logpdf(pts)), rtol=1e-6)
    periodic = {"model_0": {0: 1.0}}
    a = np.array([[0.1, 0.3], [0.9, 0.2]])
    b = np.array([[0.8, 0.1], [0.05, 0.6]])
    tp, jp = TP(periodic), JP(periodic)
    got = tp.distance({"model_0": torch.as_tensor(a)},
                      {"model_0": torch.as_tensor(b)}, xp=np)["model_0"]
    ref = jp.distance({"model_0": a}, {"model_0": b}, xp=np)["model_0"]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)
    got = tp.wrap({"model_0": torch.as_tensor(a + 1.25)}, xp=np)["model_0"]
    ref = jp.wrap({"model_0": a + 1.25}, xp=np)["model_0"]
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6)
